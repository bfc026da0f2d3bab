"""Remat of the port's UNet (``UNetConfig.remat``, ``MVD_REMAT_POLICY``)
against its own non-remat step and the JAX package's remat step.

The TINY train step (depth-cut, joint attention over 2 views) with remat
gives the loss and gradients of the step without it, bitwise, and meets
the joint train step's bar (>= 60 dB on the loss and gradient norms)
against the JAX package's step with remat on. The policies keep what the
JAX package's keep: the flash forward's (out, lse) under every policy but
``none``, so its plain version runs as often with remat as without; the
GroupNorm forward runs again in the recompute. Without grad no checkpoint
is entered.
"""

import dataclasses

import pytest
import torch

import mvd_tpu.config as jconfig
import mvd_tpu_torch.config as tconfig
import mvd_tpu_torch.nn.unet as tunet
from mvd_tpu_torch import remat
from _torch_port_util import cut_config, jax_joint_train_run, snr_db
from mvd_tpu_torch.checkpoint import load_jax_params
from mvd_tpu_torch.config import TINY_MODEL, TINY_UNET, TrainConfig, UNetConfig
from mvd_tpu_torch.kernels import KERNELS
from mvd_tpu_torch.nn.layers import BasicTransformerBlock, GroupNorm, ResnetBlock, Transformer2D
from mvd_tpu_torch.parallel import for_view_sharding
from mvd_tpu_torch.pipeline import MVDPipeline, build_schedule
from mvd_tpu_torch.pipeline.pipeline import build_model
from mvd_tpu_torch.train import TrainState, make_train_step

BAR_DB = 60.0
T_CFG = for_view_sharding(cut_config(TINY_MODEL), 2, 1)


def _with_remat(cfg, remat):
    return dataclasses.replace(cfg, unet=dataclasses.replace(cfg.unet, remat=remat))


def _plain_calls():
    return {name: fn.plain_calls for name, fn in KERNELS.items()}


def _step(run, remat):
    """One port train step on the JAX run's weights, batch and draws:
    (metrics, trainable gradients, the step's plain calls)."""
    cfg = _with_remat(T_CFG, remat)
    model = build_model(cfg)
    load_jax_params(model, run["params"])
    tcfg = TrainConfig(model=cfg)
    state = TrainState.create(model, tcfg, 4)
    step = make_train_step(build_schedule(cfg), tcfg)
    batch = {k: torch.from_numpy(v) for k, v in run["batch"].items()}
    before = _plain_calls()
    metrics = step(state, batch, draws=run["draws"])
    calls = {k: v - before[k] for k, v in _plain_calls().items()}
    return metrics, {n: p.grad.clone() for n, p in state.trainable.items()}, calls


@pytest.fixture(scope="module")
def steps():
    run = jax_joint_train_run()
    return run, _step(run, remat=False), _step(run, remat=True)


def test_remat_step_is_bitwise_the_step_without_it(steps):
    _, (m0, g0, _), (m1, g1, _) = steps
    for k in m0:
        assert torch.equal(m0[k], m1[k]), k
    assert g0.keys() == g1.keys() and all(torch.equal(g0[n], g1[n]) for n in g0)


def test_remat_step_matches_jax_remat_step(steps):
    run, _, (tm, _, _) = steps
    jm = run["metrics"]
    for k in ["noise_loss"] + [k for k in jm if k.startswith("grad_norm/")]:
        assert snr_db(jm[k], tm[k].numpy()) >= BAR_DB, k


def test_remat_keeps_the_kernel_launches_but_the_groupnorm_recompute(steps):
    """The whole step with remat: the flash forward and backward as often
    as without it, and the GroupNorm forward once more for each GroupNorm
    in a remat'd block (two a ResnetBlock, one a Transformer2D)."""
    run, (_, _, c0), (_, _, c1) = steps
    unet = build_model(T_CFG)["mvd"].unet
    in_blocks = sum(isinstance(m, GroupNorm) for b in unet.modules()
                    if isinstance(b, (ResnetBlock, Transformer2D)) for m in b.modules())
    assert in_blocks == 2 * sum(isinstance(m, ResnetBlock) for m in unet.modules()) + sum(
        isinstance(m, Transformer2D) for m in unet.modules())
    assert c1 == {**c0, "groupnorm_silu": c0["groupnorm_silu"] + in_blocks}


def _unet_grad_counts(mode, remat, monkeypatch):
    """Plain calls of one UNet forward + backward (adapters trainable) under
    ``MVD_REMAT_POLICY=mode``."""
    monkeypatch.setenv("MVD_REMAT_POLICY", mode)
    torch.manual_seed(0)
    unet = tunet.UNet2DCondition(dataclasses.replace(TINY_UNET, remat=remat))
    for n, p in unet.named_parameters():
        p.requires_grad_("adapter" in n)
    g = torch.Generator().manual_seed(1)
    x = torch.randn(2, 8, 8, 4, generator=g, requires_grad=True)
    ctx = torch.randn(2, 77, TINY_UNET.cross_attention_dim, generator=g)
    with torch.no_grad():
        feats = unet(x, torch.zeros(2), ctx)[1]
    refs = {k: torch.randn(2, v.shape[1] * v.shape[2], v.shape[3], generator=g) for k, v in feats.items()}
    before = _plain_calls()
    out, _ = unet(x, torch.tensor([10, 500]), ctx, ref_features=refs)
    out.square().mean().backward()
    return {k: v - before[k] for k, v in _plain_calls().items()}, unet


@pytest.mark.parametrize("mode", tunet.REMAT_POLICIES)
def test_policy_saves_the_flash_forward(mode, monkeypatch):
    """Under each policy the plain flash forward runs as often with remat as
    without (its (out, lse) are saved), except ``none``, which re-runs it
    once at every attention site of a remat'd block; the GroupNorm forward
    runs again in the recompute under every policy."""
    without, _ = _unet_grad_counts(mode, False, monkeypatch)
    with_remat, unet = _unet_grad_counts(mode, True, monkeypatch)
    sites = 4 * sum(isinstance(m, BasicTransformerBlock) for m in unet.modules())
    gn = sum(isinstance(m, GroupNorm) for m in unet.modules()) - 1  # conv_norm_out is outside
    extra = sites if mode == "none" else 0
    assert with_remat == {**without, "flash_attn_fwd": without["flash_attn_fwd"] + extra,
                          "groupnorm_silu": without["groupnorm_silu"] + gn}


def test_policy_saves_what_its_name_says(monkeypatch):
    """The outputs each policy keeps in one forward: the flash forward's,
    the ResnetBlocks' 3x3 conv outputs and, with ``dots``, the matmuls'
    (``flash`` and ``flash_conv`` on the block's tape, ``flash_conv_dots``
    through PyTorch's selective checkpointing)."""
    saved = {}

    def count(name):
        saved[name] = saved.get(name, 0) + 1

    keep = remat.Tape.keep
    monkeypatch.setattr(remat.Tape, "keep", lambda tape, out: count(
        "flash_fwd" if isinstance(out, tuple) else "convolution") or keep(tape, out))
    sac = tunet.create_selective_checkpoint_contexts

    def counted_sac(policy):
        def counted(ctx, op, *args, **kwargs):
            decision = policy(ctx, op, *args, **kwargs)
            if decision == tunet.CheckpointPolicy.MUST_SAVE and not ctx.is_recompute:
                count(str(op).split(".")[1])
            return decision
        return sac(counted)

    monkeypatch.setattr(tunet, "create_selective_checkpoint_contexts", counted_sac)
    for mode in ("flash", "flash_conv", "flash_conv_dots"):
        saved.clear()
        _, unet = _unet_grad_counts(mode, True, monkeypatch)
        resnets = sum(isinstance(m, ResnetBlock) for m in unet.modules())
        sites = 4 * sum(isinstance(m, BasicTransformerBlock) for m in unet.modules())
        want = {"flash_fwd": sites}
        if mode != "flash":
            want["convolution"] = 2 * resnets
        if mode == "flash_conv_dots":
            assert saved.pop("mm") > 0 and saved.pop("addmm") > 0
        assert saved == want, mode
    with pytest.raises(ValueError, match="MVD_REMAT_POLICY"):
        tunet.remat_context("flash_only")


def test_kept_conv_gradients_are_the_convs():
    """A ResnetBlock with every parameter trained, under a checkpoint whose
    tape keeps the conv outputs: the recompute takes them back instead of
    running the convs, and the input and parameter gradients are bitwise
    those without the checkpoint, also from a second backward over the
    same graph (the recompute runs again)."""
    torch.manual_seed(0)
    block = ResnetBlock(32, 64, norm_num_groups=8, temb_dim=16)
    x = torch.randn(2, 32, 6, 6, requires_grad=True)
    temb = torch.randn(2, 16)
    g = torch.randn(2, 64, 6, 6)

    def grads(run, backwards=1):
        out = run()
        got = []
        for _ in range(backwards):
            got.append(torch.autograd.grad(out, [x, *block.parameters()], g, retain_graph=True))
        return got

    plain = grads(lambda: block(x, temb))[0]
    convs = []
    real = torch.nn.functional.conv2d
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(torch.nn.functional, "conv2d", lambda *a, **k: convs.append(1) or real(*a, **k))
        kept = grads(lambda: tunet._remat(block, tunet.remat_context("flash_conv"), x, temb), backwards=2)
    assert len(convs) == 3 + 2  # conv1, conv2, the 1x1 shortcut; each recompute the shortcut only
    for got in kept:
        assert all(torch.equal(a, b) for a, b in zip(plain, got))


def test_no_checkpoint_without_grad(monkeypatch):
    """Generation and the frozen feature pass never enter a checkpoint:
    with remat on, a pipeline call runs every plain version as often as
    with it off."""
    def refuse(*args, **kwargs):
        raise AssertionError("checkpoint entered without grad")

    counts = []
    for remat in (False, True):
        cfg = dataclasses.replace(TINY_MODEL, unet=dataclasses.replace(TINY_UNET, remat=remat))
        pipe = MVDPipeline.create(cfg, seed=0, device="cpu")
        monkeypatch.setattr(tunet, "checkpoint", refuse)
        before = _plain_calls()
        pipe(["a chair"] * 2, num_inference_steps=2, guidance_scale=1.0,
             source_images=torch.zeros(1, 64, 64, 3).numpy())
        counts.append({k: v - before[k] for k, v in _plain_calls().items()})
        monkeypatch.undo()
    assert counts[0] == counts[1] and counts[0]["flash_attn_fwd"] > 0


def test_yaml_reads_enable_gradient_checkpointing(tmp_path):
    assert UNetConfig().remat and not TINY_UNET.remat
    assert jconfig.UNetConfig().remat and not jconfig.TINY_UNET.remat
    for text, want in (("", True), ("enable_gradient_checkpointing: false\n", False),
                       ("enable_gradient_checkpointing: true\n", True)):
        path = tmp_path / "c.yaml"
        path.write_text(text + "batch_size: 2\n")
        got = tconfig.train_config_from_yaml(str(path)).model.unet.remat
        assert got == jconfig.train_config_from_yaml(str(path)).model.unet.remat == want
