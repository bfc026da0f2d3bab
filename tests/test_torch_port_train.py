"""The port's train step against ``mvd_tpu.train`` at the depth-cut TINY_MODEL.

The same numpy inputs go through the JAX function and its counterpart in
the port; weights cross with ``load_jax_params``; the train step's random
numbers are the JAX step's own draws (its key splits replayed and handed to
the port). Bars, in dB of signal over error: >= 60 for the K3 backward's
plain version, the GroupNorm VJP, the schedule and loss functions and a
step's loss and gradient norms; >= 40 for the parameter updates over two
steps and after carrying a JAX ``TrainState`` across (Adam divides by the
root of the second moment, which amplifies rounding in near-zero gradients).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.traverse_util import flatten_dict

from _torch_port_util import cut_config, random_params, snr_db
from mvd_tpu.config import TINY_MODEL as J_TINY
from mvd_tpu.config import LossConfig as JLossConfig
from mvd_tpu.config import OptimizerConfig as JOptimizerConfig
from mvd_tpu.config import TrainConfig as JTrainConfig
from mvd_tpu.diffusion import add_noise as j_add_noise
from mvd_tpu.diffusion import compute_snr as j_compute_snr
from mvd_tpu.diffusion import get_velocity as j_get_velocity
from mvd_tpu.diffusion import min_snr_weight as j_min_snr_weight
from mvd_tpu.diffusion import pred_original_sample as j_pred_original_sample
from mvd_tpu.kernels.flash_attention import flash_attention_packed
from mvd_tpu.kernels.groupnorm_silu import xla_groupnorm_silu
from mvd_tpu.nn import AutoencoderKL as JVAE
from mvd_tpu.nn import CLIPTextEncoder as JCLIP
from mvd_tpu.nn import MultiViewUNet as JMVD
from mvd_tpu.pipeline import MVDPipeline as JPipeline
from mvd_tpu.pipeline import build_schedule as j_build_schedule
from mvd_tpu.train import TrainState as JTrainState
from mvd_tpu.train import count_params as j_count_params
from mvd_tpu.train import make_optimizer as j_make_optimizer
from mvd_tpu.train import make_train_step as j_make_train_step
from mvd_tpu.train import trainable_mask as j_trainable_mask
from mvd_tpu.train.losses import noise_loss as j_noise_loss
from mvd_tpu.train.state import make_lr_schedule as j_make_lr_schedule
from mvd_tpu_torch.checkpoint import load_jax_params, load_jax_train_state
from mvd_tpu_torch.config import TINY_MODEL, LossConfig, OptimizerConfig, TrainConfig
from mvd_tpu_torch.diffusion import (
    add_noise,
    compute_snr,
    get_velocity,
    min_snr_weight,
    pred_original_sample,
)
from mvd_tpu_torch.kernels import (
    attention_packed,
    attention_packed_bwd_plain,
    attention_packed_plain,
    flash_attention_packed_bwd_dq,
    groupnorm_silu,
    groupnorm_silu_diff,
)
from mvd_tpu_torch.pipeline import build_schedule
from mvd_tpu_torch.pipeline.pipeline import build_model
from mvd_tpu_torch.train import (
    TrainState,
    count_params,
    make_eval_fn,
    make_lr_schedule,
    feature_matching_loss,
    make_train_step,
    noise_loss,
    trainable_mask,
)

BAR_DB, UPDATE_BAR_DB = 60.0, 40.0
J_CFG, T_CFG = cut_config(J_TINY), cut_config(TINY_MODEL)
B, V = 1, 2  # V > 1: the unique-source encode path
LAT = J_CFG.unet.sample_size
HW = LAT * 8
TOTAL = 4  # warmup 1 step: lr 0 at step 1, the peak at step 2, then cosine
LR = 1e-3


def _t(x):
    return torch.from_numpy(np.array(x))


# ---------------------------------------------------------------- kernels


@pytest.mark.parametrize("B_,Sq,Sk,heads,D", [(1, 150, 77, 2, 32)])
def test_attention_bwd_plain_matches_jax(B_, Sq, Sk, heads, D):
    """K3's plain version against ``jax.vjp`` of the Pallas packed flash
    attention in interpret mode (ragged Sq and Sk), and against torch
    autograd through K1's plain version."""
    rng = np.random.default_rng(Sq + Sk)
    q, do = (rng.normal(size=(B_, Sq, heads * D)).astype(np.float32) for _ in range(2))
    k, v = (rng.normal(size=(B_, Sk, heads * D)).astype(np.float32) for _ in range(2))
    f = lambda q, k, v: flash_attention_packed(q, k, v, heads, interpret=True)
    want = jax.jit(lambda *a: jax.vjp(f, *a[:3])[1](a[3]))(*map(jnp.asarray, (q, k, v, do)))

    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    out, lse = attention_packed_plain(tq, tk, tv, heads)
    got = attention_packed_bwd_plain(tq, tk, tv, out, lse, torch.from_numpy(do), heads)
    auto = torch.autograd.grad(out, (tq, tk, tv), torch.from_numpy(do))
    calls = flash_attention_packed_bwd_dq.plain_calls
    through_fn = torch.autograd.grad(attention_packed(tq, tk, tv, heads), (tq, tk, tv),
                                     torch.from_numpy(do))
    assert flash_attention_packed_bwd_dq.plain_calls == calls + 1
    for name, w, g, a, fn in zip("dq dk dv".split(), want, got, auto, through_fn):
        assert snr_db(w, g.detach().numpy()) >= BAR_DB, name
        assert snr_db(a.numpy(), g.detach().numpy()) >= BAR_DB, name
        assert snr_db(w, fn.numpy()) >= BAR_DB, name


@pytest.mark.parametrize("eps", [1e-5, 1e-6])
@pytest.mark.parametrize("silu", [True, False])
def test_groupnorm_vjp_matches_jax(eps, silu):
    rng = np.random.default_rng(7)
    x = (rng.normal(size=(2, 6, 5, 64)) * 2 + 0.5).astype(np.float32)
    w = (1 + 0.1 * rng.normal(size=64)).astype(np.float32)
    b = (0.1 * rng.normal(size=64)).astype(np.float32)
    dy = rng.normal(size=x.shape).astype(np.float32)
    g = lambda *a: xla_groupnorm_silu(*a, 8, eps, silu)
    want = jax.jit(lambda *a: jax.vjp(g, *a[:3])[1](a[3]))(*map(jnp.asarray, (x, w, b, dy)))
    leaves = [torch.from_numpy(a).requires_grad_() for a in (x, w, b)]
    calls = groupnorm_silu.plain_calls
    got = torch.autograd.grad(groupnorm_silu_diff(*leaves, 8, eps, silu), leaves, torch.from_numpy(dy))
    assert groupnorm_silu.plain_calls == calls + 1  # the forward; the VJP ticks nothing
    for name, w_, g in zip(("dx", "dscale", "dbias"), want, got):
        assert snr_db(w_, g.numpy()) >= BAR_DB, name


# ------------------------------------------------- schedule, loss, optimizer


def test_schedule_and_loss_functions_match_jax():
    js, ts = j_build_schedule(J_TINY), build_schedule(TINY_MODEL)
    rng = np.random.default_rng(3)
    x0, eps, pred = (rng.normal(size=(4, 3, 3, 4)).astype(np.float32) for _ in range(3))
    t = np.array([0, 17, 500, 999], np.int32)
    jt, tt = jnp.asarray(t), torch.from_numpy(t)
    pairs = [
        (j_add_noise(js, jnp.asarray(x0), jnp.asarray(eps), jt), add_noise(ts, _t(x0), _t(eps), tt)),
        (j_get_velocity(js, jnp.asarray(x0), jnp.asarray(eps), jt), get_velocity(ts, _t(x0), _t(eps), tt)),
        (j_compute_snr(js, jt), compute_snr(ts, tt)),
        (j_pred_original_sample(js, jnp.asarray(pred), jnp.asarray(x0), jt),
         pred_original_sample(ts, _t(pred), _t(x0), tt)),
    ]
    for gamma in (1.0, 5.0):
        pairs.append((j_min_snr_weight(js, jt, gamma), min_snr_weight(ts, tt, gamma)))
    for weighting in ("per_sample", "faithful"):
        for use_snr in (True, False):
            want = j_noise_loss(js, jnp.asarray(pred), jnp.asarray(eps), jnp.asarray(x0), jt,
                                use_snr=use_snr, weighting=weighting)
            got = noise_loss(ts, _t(pred), _t(eps), _t(x0), tt, use_snr=use_snr, weighting=weighting)
            assert set(want) == set(got)
            pairs += [(want[k], got[k]) for k in sorted(want)]
    for i, (want, got) in enumerate(pairs):
        assert snr_db(want, got.numpy()) >= BAR_DB, i


@pytest.mark.parametrize("kind", ["cosine", "constant"])
def test_lr_schedule_matches_optax(kind):
    for total in (4, 100, 1000):
        cfg = OptimizerConfig(learning_rate=3e-4, schedule=kind)
        jcfg = JOptimizerConfig(learning_rate=3e-4, schedule=kind)
        want, got = j_make_lr_schedule(jcfg, total), make_lr_schedule(cfg, total)
        warmup = max(1, int(0.05 * total))
        steps = [0, 1, warmup - 1, warmup, warmup + 1, total // 2, total - 1, total, total + 5]
        w = np.array([float(want(s)) for s in steps])
        g = np.array([got(s) for s in steps])
        assert got(0) == 0.0
        assert snr_db(w, g) >= BAR_DB, (kind, total)


class _ToyMVD(torch.nn.Module):
    """Two parameters under a trainable marker, one frozen."""

    def __init__(self):
        super().__init__()
        self.camera_encoder = torch.nn.Linear(3, 2)
        self.unet = torch.nn.Linear(2, 2, bias=False)


def test_optimizer_matches_optax():
    """Clip (on and off), AdamW with decay, lr 0 at step 1, over 4 steps."""
    rng = np.random.default_rng(0)
    w0 = {"kernel": rng.normal(size=(3, 2)).astype(np.float32),
          "bias": rng.normal(size=2).astype(np.float32)}
    u0 = rng.normal(size=(2, 2)).astype(np.float32)
    jparams = {"params": {"camera_encoder": dict(w0), "unet": {"kernel": u0}}}
    jcfg = JOptimizerConfig(learning_rate=0.1, weight_decay=0.3, max_grad_norm=1.0)
    tx = j_make_optimizer(jcfg, jparams, total_steps=10)
    jstate = JTrainState.create(jparams, tx)
    japply = jax.jit(lambda s, g: s.apply_gradients(g))

    toy = _ToyMVD()
    load_jax_params(toy, jparams)
    cfg = TrainConfig(model=TINY_MODEL, optimizer=OptimizerConfig(
        learning_rate=0.1, weight_decay=0.3, max_grad_norm=1.0))
    state = TrainState.create(torch.nn.ModuleDict({"mvd": toy}), cfg, 10)
    assert set(state.trainable) == {"camera_encoder.weight", "camera_encoder.bias"}
    assert not toy.unet.weight.requires_grad
    for scale in (5.0, 5.0, 0.1, 3.0):  # clipped, clipped, not clipped, clipped
        gk = (scale * rng.normal(size=(3, 2))).astype(np.float32)
        gb = (scale * rng.normal(size=2)).astype(np.float32)
        jgrads = {"params": {"camera_encoder": {"kernel": gk, "bias": gb},
                             "unet": {"kernel": np.zeros_like(u0)}}}
        jstate = japply(jstate, jax.tree.map(jnp.asarray, jgrads))
        toy.camera_encoder.weight.grad = torch.from_numpy(gk.T.copy())
        toy.camera_encoder.bias.grad = torch.from_numpy(gb)
        norm = torch.sqrt(toy.camera_encoder.weight.grad.square().sum()
                          + toy.camera_encoder.bias.grad.square().sum())
        before = toy.camera_encoder.weight.detach().clone()
        state.apply_gradients(norm)
        if state.step == 1:
            assert torch.equal(toy.camera_encoder.weight, before)  # lr 0
        jp = jstate.params["params"]
        np.testing.assert_allclose(toy.camera_encoder.weight.detach().numpy(),
                                   np.asarray(jp["camera_encoder"]["kernel"]).T, rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(toy.camera_encoder.bias.detach().numpy(),
                                   np.asarray(jp["camera_encoder"]["bias"]), rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(toy.unet.weight.detach().numpy(), u0.T)


# ------------------------------------------------------- the train step


def _train_configs(fm_weight=0.0):
    opt = dict(learning_rate=LR)
    jcfg = JTrainConfig(model=J_CFG, loss=JLossConfig(feature_matching_weight=fm_weight),
                        optimizer=JOptimizerConfig(**opt), batch_size=B, image_size=HW, num_views=V)
    tcfg = TrainConfig(model=T_CFG, loss=LossConfig(feature_matching_weight=fm_weight),
                       optimizer=OptimizerConfig(**opt))
    return jcfg, tcfg


def _params():
    z = jnp.zeros((1, LAT, LAT, 4))
    ctx = jnp.zeros((1, 77, J_CFG.unet.cross_attention_dim))
    cam = jnp.eye(4)[None]
    return {
        "mvd": random_params(
            JMVD(J_CFG).init, z, jnp.zeros((), jnp.int32), ctx,
            source_camera=cam, target_camera=cam, source_image_latents=z, seed=1,
        ),
        "vae": random_params(JVAE(J_CFG.vae).init, jnp.zeros((1, 16, 16, 3)), seed=2),
        "text_encoder": random_params(
            JCLIP(J_CFG.text_encoder).init, jnp.zeros((1, 77), jnp.int32), seed=3
        ),
    }


def _batch(seed):
    from mvd_tpu.camera import orbit_cameras

    rng = np.random.default_rng(seed)
    cams = orbit_cameras(V).astype(np.float32)
    src = rng.uniform(-1, 1, (B, 1, HW, HW, 3)).astype(np.float32)
    return {  # one source view per group, as the group loader gives it
        "source_image": np.repeat(src, V, axis=1),
        "target_image": rng.uniform(-1, 1, (B, V, HW, HW, 3)).astype(np.float32),
        "source_camera": np.tile(cams[:1], (B, V, 1, 1)),
        "target_camera": np.tile(cams[None], (B, 1, 1, 1)),
        "input_ids": rng.integers(0, J_CFG.text_encoder.vocab_size, (B, V, 77)).astype(np.int32),
    }


def _jax_draws(key, schedule):
    """The JAX step's draws (mvd_tpu/train/step.py: r_noise, r_t, r_vs, r_vt)."""
    N = B * V
    shape = (N, LAT, LAT, 4)
    r_noise, r_t, r_vs, r_vt = jax.random.split(key, 4)
    return {
        "noise": np.array(jax.random.normal(r_noise, shape, jnp.float32)),
        "timesteps": np.array(jax.random.randint(r_t, (N,), 0, schedule.num_train_timesteps)),
        "source_vae_noise": np.array(jax.random.normal(r_vs, shape, jnp.float32)),
        "target_vae_noise": np.array(jax.random.normal(r_vt, shape, jnp.float32)),
    }


def _port_model(params):
    model = build_model(T_CFG)
    load_jax_params(model, params)
    return model


def _trainable(model, mask=None):
    return {n: p.detach().clone() for n, p in model["mvd"].named_parameters()
            if mask is None or mask[n]}


def _updates_db(before, after_want, after_got):
    """dB of the port's parameter updates against the JAX package's, over
    all trainable parameters at once."""
    want = np.concatenate([(after_want[n] - before[n]).ravel() for n in sorted(before)])
    got = np.concatenate([(after_got[n] - before[n]).ravel() for n in sorted(before)])
    return snr_db(want, got)


def _jax_trainable(jparams, names):
    from mvd_tpu_torch.checkpoint.from_jax import convert_jax_params

    conv = convert_jax_params(jax.tree.map(np.asarray, jparams))
    return {n: conv[n] for n in names}


@pytest.fixture(scope="module")
def runs():
    """Three JAX steps and the port's steps on the same weights and draws."""
    params = _params()
    jcfg, tcfg = _train_configs()
    jpipe = JPipeline(J_CFG, jax.tree.map(jnp.asarray, params))
    jstep = j_make_train_step(jpipe, jpipe.schedule, jcfg)
    tx = j_make_optimizer(jcfg.optimizer, jpipe.params["mvd"], total_steps=TOTAL)
    jstate = JTrainState.create(jax.tree.map(jnp.array, params["mvd"]), tx)
    frozen = {"vae": jpipe.params["vae"], "text_encoder": jpipe.params["text_encoder"]}
    batch = _batch(0)
    keys = [jax.random.PRNGKey(s) for s in (11, 12, 13)]
    jmetrics, jparams, jstates = [], [], []
    for key in keys:
        jstate, m = jstep(jstate, frozen, jax.tree.map(jnp.asarray, batch), key)
        jmetrics.append({k: np.asarray(v) for k, v in m.items()})
        jstates.append(jax.tree.map(np.asarray, jstate))  # before donation
        jparams.append(jstates[-1].params)
    draws = [_jax_draws(k, jpipe.schedule) for k in keys]

    model = _port_model(params)
    state = TrainState.create(model, tcfg, TOTAL)
    step = make_train_step(build_schedule(T_CFG), tcfg)
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    p0 = _trainable(model)
    tmetrics, tparams = [], []
    for d in draws[:2]:
        tmetrics.append(step(state, tbatch, draws=d))
        tparams.append(_trainable(model))
    return dict(params=params, jmetrics=jmetrics, jparams=jparams, jstates=jstates,
                draws=draws, tmetrics=tmetrics, tparams=tparams, p0=p0, state=state,
                tcfg=tcfg, tbatch=tbatch, step=step)


def test_trainable_mask_matches_jax(runs):
    jmask = flatten_dict(j_trainable_mask(runs["params"]["mvd"]))
    want = set()
    for path, label in jmask.items():
        *mods, leaf = [p for p in path if p != "params"]
        leaf = "weight" if leaf in ("kernel", "scale", "embedding") else leaf
        if label == "trainable":
            want.add(".".join(mods + [leaf]))
    got = trainable_mask(runs["state"].model["mvd"])
    assert {n for n, t in got.items() if t} == want
    jm = j_trainable_mask(runs["params"]["mvd"])
    for side in (True, False):
        assert count_params(runs["state"].model["mvd"], got, side) == j_count_params(
            runs["params"]["mvd"], jm, "trainable" if side else "frozen")
    assert set(got) == set(runs["p0"])
    assert set(runs["state"].trainable) == want


def test_train_step_loss_and_grad_norms_match_jax(runs):
    for jm, tm in zip(runs["jmetrics"][:2], runs["tmetrics"]):
        keys = [k for k in jm if not k.startswith("hist/")]
        assert set(keys) == {k for k in tm if not k.startswith("hist/")}
        assert {k for k in jm if k.startswith("hist/")} == {k for k in tm if k.startswith("hist/")}
        for k in ["noise_loss"] + [k for k in keys if k.startswith("grad_norm/")]:
            assert snr_db(jm[k], tm[k].numpy()) >= BAR_DB, k
        for k in keys:  # the remaining metrics (SNR, FiLM statistics, max |g|)
            assert snr_db(jm[k], tm[k].numpy()) >= BAR_DB, k


def test_train_step_updates_match_jax(runs):
    p0 = runs["p0"]
    names = set(runs["state"].trainable)
    before = {n: p0[n].numpy() for n in names}
    # step 1 runs at lr 0: nothing moves on either side
    after1 = runs["tparams"][0]
    assert all(torch.equal(after1[n], p0[n]) for n in p0)
    want1 = _jax_trainable(runs["jparams"][0], names)
    assert all(np.array_equal(want1[n], before[n]) for n in names)
    # step 2 moves the trainable parameters, and only those
    after2 = runs["tparams"][1]
    assert all(torch.equal(after2[n], p0[n]) for n in p0 if n not in names)
    assert any(not torch.equal(after2[n], p0[n]) for n in names)
    want2 = _jax_trainable(runs["jparams"][1], names)
    got2 = {n: after2[n].numpy() for n in names}
    assert _updates_db(before, want2, got2) >= UPDATE_BAR_DB


def test_jax_train_state_carries_across(runs):
    """After two JAX steps, the JAX TrainState goes into a fresh port model;
    one more step on each side from there."""
    _, tcfg = _train_configs()
    model = _port_model(runs["params"])  # vae and text; mvd comes from the state
    state = load_jax_train_state(model, runs["jstates"][1], tcfg, TOTAL)
    assert state.step == 2
    names = set(state.trainable)
    before = {n: p.detach().numpy().copy() for n, p in state.trainable.items()}
    runs["step"](state, runs["tbatch"], draws=runs["draws"][2])
    assert state.step == 3
    want = _jax_trainable(runs["jparams"][2], names)
    got = {n: p.detach().numpy() for n, p in state.trainable.items()}
    assert _updates_db(before, want, got) >= UPDATE_BAR_DB


def test_carry_rejects_unmatched_moments(runs):
    """A moment leaf that matches no trainable parameter raises."""
    _, tcfg = _train_configs()
    jstate = runs["jstates"][1]
    adam = jstate.opt_state.inner_states["trainable"].inner_state[1][0]
    mu = {"params": {**adam.mu["params"], "stray": np.zeros(3, np.float32)}}
    bad = jstate.replace(opt_state=jstate.opt_state._replace(inner_states={
        **jstate.opt_state.inner_states,
        "trainable": jstate.opt_state.inner_states["trainable"]._replace(inner_state=(
            jstate.opt_state.inner_states["trainable"].inner_state[0],
            (adam._replace(mu=mu),) + tuple(jstate.opt_state.inner_states["trainable"].inner_state[1][1:]),
        )),
    }))
    with pytest.raises(KeyError, match="stray"):
        load_jax_train_state(_port_model(runs["params"]), bad, tcfg, TOTAL)


def test_feature_matching_loss_matches_jax():
    from mvd_tpu.train.losses import feature_matching_loss as j_feature_matching_loss

    rng = np.random.default_rng(5)
    shapes = {"down_block_0_attn_0": (2, 8, 8, 32), "mid_block_attn_0": (2, 4, 4, 64)}
    pred = {k: rng.normal(size=s).astype(np.float32) for k, s in shapes.items()}
    tgt = {k: (3 * rng.normal(size=s)).astype(np.float32) for k, s in shapes.items()}
    want = j_feature_matching_loss(jax.tree.map(jnp.asarray, pred), jax.tree.map(jnp.asarray, tgt))
    got = feature_matching_loss({k: _t(v) for k, v in pred.items()}, {k: _t(v) for k, v in tgt.items()})
    assert snr_db(want, got.numpy()) >= BAR_DB


def test_feature_matching_branch(runs):
    """One step with feature matching on, on the first step's draws: the
    optimizer sees noise_loss + w * feature_matching_loss, noise_loss is the
    JAX step's, and the feature term's gradient reaches the trainable
    parameters through x0-hat and the frozen feature tower."""
    w = 0.5
    _, tcfg = _train_configs(fm_weight=w)
    state = TrainState.create(_port_model(runs["params"]), tcfg, TOTAL)
    tm = make_train_step(build_schedule(T_CFG), tcfg)(state, runs["tbatch"], draws=runs["draws"][0])
    assert snr_db(runs["jmetrics"][0]["noise_loss"], tm["noise_loss"].numpy()) >= BAR_DB
    fm = tm["feature_matching_loss"]
    assert torch.isfinite(fm) and fm > 0
    torch.testing.assert_close(tm["total_loss"], tm["noise_loss"] + w * fm)
    off = runs["tmetrics"][0]["grad_norm/total"]
    assert abs(float(tm["grad_norm/total"]) - float(off)) > 1e-3 * float(off)


def test_eval_fn_matches_train_loss(runs):
    """The grad-free eval on the same draws gives the train step's loss."""
    _, tcfg = _train_configs()
    model = _port_model(runs["params"])
    TrainState.create(model, tcfg, TOTAL)
    loss, metrics = make_eval_fn(build_schedule(T_CFG), tcfg)(
        model, runs["tbatch"], draws=runs["draws"][0])
    assert not loss.requires_grad
    assert snr_db(runs["jmetrics"][0]["noise_loss"], loss.numpy()) >= BAR_DB
