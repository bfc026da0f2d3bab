"""Joint multi-view attention, the separate image-encoder UNet and the
``--num-views`` train entry of the port against the JAX package.

The same numpy-seeded inputs and weights (a flax tree carried across by
``checkpoint/from_jax.py``) go through the JAX function and its counterpart
in the port. Flat rows are ``b * V + v``: with ``num_views`` V the
self-attention of every V consecutive rows runs over their V*S tokens.
Bars, in dB of signal over error: >= 60 for the joint ``Attention``, a joint
denoise with adapters, the separate image encoder's denoise and the joint
train step's loss and gradient norms; >= 50 for the images of a 4-view
pipeline after 3 DDPM steps (error compounds across steps). The model is
TINY_MODEL cut in depth (``cut_config``), as in the other port tests.
"""

import dataclasses
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.traverse_util import flatten_dict

from _torch_port_util import cut_config, jax_joint_train_run, random_params, snr_db
from mvd_tpu.camera import orbit_cameras
from mvd_tpu.checkpoint import torch_convert as jconv
from mvd_tpu.config import TINY_MODEL as J_TINY
from mvd_tpu.nn import AutoencoderKL as JVAE
from mvd_tpu.nn import CLIPTextEncoder as JCLIP
from mvd_tpu.nn import MultiViewUNet as JMVD
from mvd_tpu.nn.layers import Attention as JAttention
from mvd_tpu.pipeline import MVDPipeline as JPipeline
from mvd_tpu.train import trainable_mask as j_trainable_mask
from mvd_tpu_torch.checkpoint import (
    convert_lightning_checkpoint,
    export_jax_params,
    export_lightning_state_dict,
    export_unet_state_dict,
    load_checkpoint,
    load_jax_params,
)
from mvd_tpu_torch.config import TINY_MODEL, TINY_UNET, TrainConfig
from mvd_tpu_torch.nn import MultiViewUNet, UNet2DCondition
from mvd_tpu_torch.nn.layers import Attention
from mvd_tpu_torch.parallel import for_view_sharding
from mvd_tpu_torch.pipeline import MVDPipeline, build_schedule
from mvd_tpu_torch.pipeline.pipeline import build_model
from mvd_tpu_torch.train import TrainState, make_train_step, trainable_mask

jfa = importlib.import_module("mvd_tpu.kernels.flash_attention")
tfa = importlib.import_module("mvd_tpu_torch.kernels.flash_attention")
BAR_DB, PIPE_BAR_DB = 60.0, 50.0
V = 2
J_CUT, T_CUT = cut_config(J_TINY), cut_config(TINY_MODEL)


def _views(cfg, v):
    return dataclasses.replace(cfg, unet=dataclasses.replace(cfg.unet, num_views=v))


J_CFG, T_CFG = _views(J_CUT, V), _views(T_CUT, V)
LAT = J_CFG.unet.sample_size


@pytest.fixture(scope="module")
def params():
    """The JAX trees of every network; ``mvd_separate`` adds a separate
    image-encoder UNet (the tree of ``MultiViewUNet(share_image_encoder=
    False)``: the denoising UNet's structure, other values)."""
    z = jnp.zeros((V, LAT, LAT, 4))
    cam = jnp.tile(jnp.eye(4)[None], (V, 1, 1))
    mvd = random_params(JMVD(J_CFG).init, z, jnp.zeros((), jnp.int32),
                        jnp.zeros((V, 77, J_CFG.unet.cross_attention_dim)),
                        source_camera=cam, target_camera=cam, source_image_latents=z, seed=1)
    rng = np.random.default_rng(4)
    encoder = jax.tree.map(lambda a: (a + 0.1 * rng.normal(size=a.shape)).astype(a.dtype),
                           mvd["params"]["unet"])
    return {
        "mvd": mvd,
        "mvd_separate": {"params": {**mvd["params"], "image_encoder_unet": encoder}},
        "vae": random_params(JVAE(J_CFG.vae).init, jnp.zeros((1, 16, 16, 3)), seed=2),
        "text_encoder": random_params(JCLIP(J_CFG.text_encoder).init, jnp.zeros((1, 77), jnp.int32),
                                      seed=3),
    }


def _t(x):
    return torch.from_numpy(np.array(x))


# ------------------------------------------------------------- attention


def test_joint_attention_matches_jax():
    """Self-attention over each group's V*S tokens, cross-attention per row."""
    heads, hd, dim, S = 2, 16, 32, 20
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2 * V, S, dim)).astype(np.float32)
    ctx = rng.normal(size=(2 * V, 7, 24)).astype(np.float32)
    jmod = JAttention(heads=heads, head_dim=hd, num_views=V)
    p = random_params(jmod.init, jnp.asarray(x), seed=5)
    want = jmod.apply(p, jnp.asarray(x))
    tmod = Attention(dim, heads, hd, num_views=V)
    load_jax_params(tmod, p)
    with torch.no_grad():
        got = tmod(_t(x))
    assert snr_db(want, got.numpy()) >= BAR_DB
    assert snr_db(want, _per_view(tmod, x)) < 40.0  # the joint function is not the per-view one

    jx = JAttention(heads=heads, head_dim=hd, num_views=V)
    px = random_params(jx.init, jnp.asarray(x), jnp.asarray(ctx), seed=6)
    tx = Attention(dim, heads, hd, context_dim=24, num_views=V)
    load_jax_params(tx, px)
    with torch.no_grad():
        got = tx(_t(x), _t(ctx))
    assert snr_db(jx.apply(px, jnp.asarray(x), jnp.asarray(ctx)), got.numpy()) >= BAR_DB


def _per_view(tmod, x):
    """``tmod``'s weights as per-view attention (num_views 1) on ``x``."""
    single = Attention(tmod.to_q.in_features, tmod.heads, tmod.to_q.out_features // tmod.heads)
    single.load_state_dict(tmod.state_dict())
    with torch.no_grad():
        return single(_t(x)).numpy()


def test_joint_attention_rejects_a_partial_view_group():
    mod = Attention(32, 2, 16, num_views=V)
    with pytest.raises(ValueError, match="2 views .* got 3 rows"):
        mod(torch.zeros(3, 5, 32))
    # views sharded over a mesh: the config names the axis; outside a
    # sharded call the module attends over whole groups, and the ring
    # refuses to run with no mesh bound
    assert for_view_sharding(T_CUT, V, 2).unet.view_axis == "view"
    sharded = Attention(32, 2, 16, num_views=V, view_axis="view")
    sharded.load_state_dict(mod.state_dict())
    x = torch.randn(2 * V, 5, 32)
    with torch.no_grad():
        assert torch.equal(sharded(x), mod(x))
    from mvd_tpu_torch.kernels import ring_attention_packed

    with pytest.raises(RuntimeError, match="no mesh"):
        ring_attention_packed(x, x, x, 2, "view")


def test_joint_vs_single_view_differs():
    """The port's counterpart of ``tests/test_joint_attention.py``: the
    same weights give another output with joint attention; and each view
    group is its own: group 0's rows do not change with group 1's."""
    torch.manual_seed(0)
    cfg = dataclasses.replace(TINY_UNET, with_adapters=False)
    single, joint = UNet2DCondition(cfg), UNet2DCondition(dataclasses.replace(cfg, num_views=V))
    joint.load_state_dict(single.state_dict())
    rng = np.random.default_rng(1)
    sample = _t(rng.normal(size=(2 * V, 8, 8, 4)).astype(np.float32))
    ctx = _t(rng.normal(size=(2 * V, 77, cfg.cross_attention_dim)).astype(np.float32))
    t = torch.tensor(10)
    with torch.no_grad():
        out_single = single(sample, t, ctx)[0]
        out_joint = joint(sample, t, ctx)[0]
        other = sample.clone()
        other[V:] = 0.0
        out_other = joint(other, t, ctx)[0]
    assert out_single.shape == out_joint.shape
    assert not np.allclose(out_single.numpy(), out_joint.numpy())
    assert torch.equal(out_other[:V], out_joint[:V])
    assert not torch.equal(out_other[V:], out_joint[V:])


# --------------------------------------------------------------- denoise


def _conditioning_inputs(seed, n):
    rng = np.random.default_rng(seed)
    text = rng.normal(size=(n, 77, J_CFG.unet.cross_attention_dim)).astype(np.float32)
    src_lat, lat = (rng.normal(size=(n, LAT, LAT, 4)).astype(np.float32) for _ in range(2))
    cams = orbit_cameras(n).astype(np.float32)
    return text, src_lat, lat, [np.tile(cams[:1], (n, 1, 1)), cams]


_JM = JMVD(J_CFG, share_image_encoder=False)


@jax.jit
def _j_denoise(p, text, src_cam, tgt_cam, src_lat, lat):
    """The JAX joint denoise with a separate image encoder, compiled once:
    given the denoising UNet's own weights as the encoder's, it is the
    shared model's function."""
    n = text.shape[0]
    film, refs = _JM.apply(p, text, src_cam, tgt_cam, src_lat, cfg_batch=n, precompute_kv=True,
                           method=_JM.prepare_conditioning)
    return _JM.apply(p, lat, jnp.int32(600), text, film, refs, jnp.float32(0.7), method=_JM.denoise)


def _denoise_pair(tree, share_image_encoder=True):
    """Conditioning and a joint denoise of 2 view groups with adapters and
    FiLM through the JAX package and the port: (JAX pred, port pred, the
    port's model, its features, (text, source latents))."""
    n = 2 * V
    text, src_lat, lat, cams = _conditioning_inputs(7, n)
    p = tree["params"]
    j_tree = {"params": {**p, "image_encoder_unet": p["unet"]}} if share_image_encoder else tree
    pred = _j_denoise(j_tree, *map(jnp.asarray, [text, *cams, src_lat, lat]))
    tm = MultiViewUNet(T_CFG, share_image_encoder=share_image_encoder)
    load_jax_params(tm, tree)
    with torch.no_grad():
        tfilm, trefs = tm.prepare_conditioning(_t(text), *map(_t, cams), _t(src_lat), cfg_batch=n,
                                               precompute_kv=True)
        tpred = tm.denoise(_t(lat), torch.tensor(600), _t(text), tfilm, trefs, 0.7)
        tfeats = tm.extract_features(_t(src_lat), _t(text))
    return pred, tpred.numpy(), tm, tfeats, (text, src_lat)


def test_joint_denoise_matches_jax(params):
    """Conditioning (FiLM, the feature pass, adapter K/V) and one joint
    denoise. The feature pass keeps the joint attention over the source
    rows, as the JAX package's does: per view it gives other features."""
    pred, tpred, tm, tfeats, (text, src_lat) = _denoise_pair(params["mvd"])
    assert snr_db(pred, tpred) >= BAR_DB
    per_view = MultiViewUNet(T_CUT)
    per_view.load_state_dict(tm.state_dict())
    with torch.no_grad():
        pv = per_view.extract_features(_t(src_lat), _t(text))
    assert all(snr_db(tfeats[n].numpy(), pv[n].numpy()) < 40.0 for n in tfeats)


def test_separate_image_encoder_matches_jax(params):
    """``share_image_encoder=False``: ``from_jax`` carries the
    ``image_encoder_unet`` tree 1:1 and the feature pass runs it."""
    tree = params["mvd_separate"]
    pred, tpred, tm, tfeats, (text, src_lat) = _denoise_pair(tree, share_image_encoder=False)
    assert snr_db(pred, tpred) >= BAR_DB
    with torch.no_grad():
        shared = tm.unet(_t(src_lat), torch.zeros(2 * V, dtype=torch.int32), _t(text))[1]
    assert all(snr_db(tfeats[n].numpy(), shared[n].numpy()) < 40.0 for n in tfeats)
    # a tree without the encoder's leaves does not load 1:1
    with pytest.raises(KeyError, match="image_encoder_unet"):
        load_jax_params(MultiViewUNet(T_CFG, share_image_encoder=False), params["mvd"])


def test_load_checkpoint_routes_the_image_encoder(params, tmp_path):
    """A Lightning checkpoint with an ``image_encoder`` group: converted as
    the JAX converter converts it, and placed into the separate encoder of
    a model that holds one; a model that shares its UNet does not read the
    group, and a separate encoder with no group to load raises."""
    tree = params["mvd_separate"]["params"]
    sd = export_lightning_state_dict(export_jax_params(_loaded(tree)))
    sd.update({f"unet.image_encoder.unet.{k}": v
               for k, v in export_unet_state_dict(tree["image_encoder_unet"]).items()})
    path = str(tmp_path / "sep.ckpt")
    torch.save({"state_dict": {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in sd.items()}}, path)
    want, _ = jconv.convert_lightning_checkpoint(path, share_image_encoder=False)
    got, _ = convert_lightning_checkpoint(path, share_image_encoder=False)
    wf, gf = flatten_dict(want), flatten_dict(got)
    assert set(wf) == set(gf) and all(np.array_equal(wf[k], gf[k]) for k in wf)
    assert "image_encoder_unet" in want["params"]

    with torch.device("cpu"):
        pipe = MVDPipeline(T_CFG, build_model(T_CFG, share_image_encoder=False), "cpu")
    kept, _ = load_checkpoint(pipe, path)
    assert kept == ["mvd.camera_encoder.translation_projection"]
    ref = _loaded(tree)
    mine = dict(pipe.model["mvd"].named_parameters())
    for name, p in ref.named_parameters():
        if not name.endswith("translation_projection"):
            assert torch.equal(mine[name], p), name
    shared = MVDPipeline.create(T_CFG, seed=0, device="cpu")
    load_checkpoint(shared, path)
    assert not hasattr(shared.model["mvd"], "image_encoder_unet")
    no_group = str(tmp_path / "shared.ckpt")
    torch.save({"state_dict": {k: torch.from_numpy(np.ascontiguousarray(v))
                               for k, v in sd.items() if ".image_encoder." not in k}}, no_group)
    with pytest.raises(ValueError, match="no image_encoder group"):
        load_checkpoint(pipe, no_group)


def _loaded(tree):
    m = MultiViewUNet(T_CFG, share_image_encoder=False)
    load_jax_params(m, {"params": tree})
    return m


@pytest.mark.parametrize("train_unet", [False, True])
def test_trainable_mask_with_a_separate_encoder_matches_jax(params, train_unet):
    """The JAX mask over a tree with ``image_encoder_unet``: its base
    weights stay frozen (also when the denoising UNet trains); its
    adapters, which the feature pass never runs, carry the adapter label in
    both packages."""
    jmask = flatten_dict(j_trainable_mask(params["mvd_separate"], train_unet))
    want = set()
    for path, label in jmask.items():
        *mods, leaf = [p for p in path if p != "params"]
        leaf = "weight" if leaf in ("kernel", "scale", "embedding") else leaf
        if label == "trainable":
            want.add(".".join(mods + [leaf]))
    got = trainable_mask(_loaded(params["mvd_separate"]["params"]), train_unet)
    assert {n for n, t in got.items() if t} == want
    enc = [n for n in got if n.startswith("image_encoder_unet.")]
    assert enc and not any(got[n] for n in enc if "adapter_" not in n)


# -------------------------------------------------------------- pipeline


@pytest.fixture(scope="module")
def pipes(params):
    """4-view pipelines with joint attention over all 4, same weights."""
    jcfg, tcfg = _views(J_CUT, 4), _views(T_CUT, 4)
    tree = {"mvd": params["mvd"], "vae": params["vae"], "text_encoder": params["text_encoder"]}
    jpipe = JPipeline(jcfg, jax.tree.map(jnp.asarray, tree))
    tpipe = MVDPipeline.create(tcfg, seed=0, device="cpu")
    tpipe.load_jax_params(tree)
    return jpipe, tpipe


def _jax_draws(seed, steps, n):
    """The JAX pipeline's draws (initial latents, source encode, one per
    step), from its own key splits."""
    shape = (n, LAT, LAT, 4)
    rng, lat_rng = jax.random.split(jax.random.PRNGKey(seed))
    latents = jax.random.normal(lat_rng, shape, jnp.float32)
    rng, enc_rng = jax.random.split(rng)
    vae_noise = jax.random.normal(enc_rng, shape, jnp.float32)
    step_noises = []
    for _ in range(steps):
        rng, step_rng = jax.random.split(rng)
        step_noises.append(jax.random.normal(step_rng, shape, jnp.float32))
    return np.array(latents), np.array(vae_noise), np.stack(step_noises)


@pytest.mark.parametrize("guidance", [1.0, 3.0])
def test_joint_pipeline_matches_jax(pipes, guidance):
    """4 views with joint attention over the 4, 3 DDPM steps, the same
    noise on both sides; under CFG the unconditional half is a whole view
    group of its own. The JAX side runs one compiled CFG program for both
    cases (its guidance is a traced argument): for guidance 1.0 at the
    next float32 above 1, which gives the conditional half's prediction to
    about 1e-7 relative, held against the port's guidance-1.0 path, which
    runs no unconditional half."""
    jpipe, tpipe = pipes
    n, steps, seed = 4, 3, 5
    cams = orbit_cameras(n)
    src = np.random.default_rng(0).uniform(0, 1, (1, LAT * 8, LAT * 8, 3)).astype(np.float32)
    kw = dict(num_inference_steps=steps, source_images=src, ref_scale=1.0,
              source_camera=np.tile(cams[:1], (n, 1, 1)), target_camera=cams)
    j_guidance = float(np.nextafter(np.float32(1.0), np.float32(2.0))) if guidance == 1.0 else guidance
    want = jpipe(["a chair"] * n, seed=seed, guidance_scale=j_guidance, **kw)["images"]
    latents, vae_noise, step_noises = _jax_draws(seed, steps, n)
    got = tpipe(["a chair"] * n, seed=seed, latents=latents, vae_noise=vae_noise,
                step_noises=step_noises, guidance_scale=guidance, **kw)["images"]
    assert got.shape == (n, LAT * 8, LAT * 8, 3) and np.isfinite(got).all()
    assert snr_db(want, got) >= PIPE_BAR_DB


def test_pipeline_rejects_a_partial_view_group(pipes):
    _, tpipe = pipes
    with pytest.raises(ValueError, match="4 views .* got 2 images"):
        tpipe(["a chair"] * 2, num_inference_steps=1, guidance_scale=1.0)
    with pytest.raises(ValueError, match="4 views .* got 2 images"):
        tpipe.invert(np.zeros((2, LAT * 8, LAT * 8, 3), np.float32), "a chair", num_inference_steps=1)


# ------------------------------------------------------------ train step


def _port_step(run, remat):
    cfg = dataclasses.replace(T_CFG, unet=dataclasses.replace(T_CFG.unet, remat=remat))
    model = build_model(cfg)
    load_jax_params(model, run["params"])
    tcfg = TrainConfig(model=cfg)
    state = TrainState.create(model, tcfg, 4)
    step = make_train_step(build_schedule(cfg), tcfg)
    metrics = step(state, {k: _t(v) for k, v in run["batch"].items()}, draws=run["draws"])
    grads = {n: p.grad.clone() for n, p in state.trainable.items()}
    return metrics, grads


def test_joint_train_step_matches_jax():
    """One joint step (V = 2, remat on, as the JAX default): loss and
    gradient norms against the JAX package's step on the same draws."""
    run = jax_joint_train_run()
    tm, _ = _port_step(run, remat=True)
    jm = run["metrics"]
    for k in ["noise_loss"] + [k for k in jm if k.startswith("grad_norm/")]:
        assert snr_db(jm[k], tm[k].numpy()) >= BAR_DB, k


# ---------------------------------------------------------- int8 routing


@pytest.mark.parametrize("views,side", [(4, 64), (4, 32), (4, 16), (4, 8), (2, 96), (2, 48), (2, 24)])
def test_int8_routing_at_joint_sites_follows_jax(monkeypatch, views, side):
    """With ``attention_impl="int8"`` a joint self site routes by its merged
    length V*S in both packages (the JAX package's on-TPU dispatch traced
    with the kernels spied on); the text site stays per view."""
    seen = {"jax": [], "port": []}

    def spy(pkg, label):
        return lambda q, *a, **k: seen[pkg].append(label) or q

    monkeypatch.setattr(jfa.jax, "default_backend", lambda: "tpu")
    monkeypatch.setattr(jfa, "_flash_attention_packed_int8", spy("jax", "int8"))
    monkeypatch.setattr(jfa, "flash_attention_packed", spy("jax", "exact"))
    monkeypatch.setattr(tfa, "flash_attention_packed_int8", spy("port", "int8"))
    monkeypatch.setattr(tfa, "_attention_exact", spy("port", "exact"))
    S, dim = side * side, 64
    x = jax.ShapeDtypeStruct((views, S, dim), jnp.float32)
    ctx = jax.ShapeDtypeStruct((views, 77, dim), jnp.float32)
    jmod = JAttention(heads=1, head_dim=64, attention_impl="int8", num_views=views)
    tmod = Attention(dim, 1, 64, attention_impl="int8", num_views=views)
    tctx = Attention(dim, 1, 64, context_dim=dim, attention_impl="int8", num_views=views)
    routed = {}
    for site, args, port in (("self", (x,), lambda: tmod(torch.zeros(views, S, dim))),
                             ("text", (x, ctx), lambda: tctx(torch.zeros(views, S, dim),
                                                            torch.zeros(views, 77, dim)))):
        p = jax.eval_shape(jmod.init, jax.random.PRNGKey(0), *args)
        seen["jax"].clear()
        seen["port"].clear()
        jax.eval_shape(jmod.apply, p, *args)
        with torch.no_grad():
            port()
        routed[site] = ("int8" in seen["jax"], "int8" in seen["port"])
    quantized = tfa.int8_site(views * S, views * S)
    assert routed == {"self": (quantized, quantized), "text": (False, False)}


# ------------------------------------------------------------------ CLI


def test_train_cli_num_views(tmp_path):
    """``--num-views 2``: joint attention over the loader's 2 views a
    sample, 2 steps on the CPU; views sharded over a mesh of 2 need 2
    processes."""
    from tests.test_data import make_zip

    from mvd_tpu_torch.cli import train

    root = tmp_path / "data"
    (root / "renders_final").mkdir(parents=True)
    rng = np.random.default_rng(3)
    for i in range(4):
        make_zip(root / "renders_final" / f"obj_{i}.zip", num_views=3, size=64, rng=rng)
    tr = train.main(["--tiny", "--device", "cpu", "--dataset-path", str(root), "--batch-size", "1",
                     "--num-views", "2", "--max-steps", "2", "--output-dir", str(tmp_path / "out")])
    assert tr.state.step == 2 and tr.cfg.model.unet.num_views == 2
    assert next(iter(tr.train_loader))["target_image"].shape[:2] == (1, 2)
    with pytest.raises(SystemExit, match="needs as many"):
        train.main(["--num-views", "2", "--mesh-view", "2", "--device", "cpu", "--dataset-path", str(root)])


def test_plain_backward_head_by_head_is_the_whole_one():
    """``measure.plain_bwd_by_row(by_head=True)``, which holds K3a/K3b at
    the joint train length on the card, gives the whole plain backward's
    gradients on the packed layout, and refuses another layout."""
    from mvd_tpu_torch.kernels import attention_packed_plain
    from mvd_tpu_torch.kernels.measure import plain_bwd_by_row

    g = torch.Generator().manual_seed(0)
    q, k, v, do = (torch.randn((2, 37, 3 * 16), generator=g) for _ in range(4))
    out, lse = attention_packed_plain(q, k, v, 3)
    whole = plain_bwd_by_row(q, k, v, out, lse, do, 3)
    by_head = plain_bwd_by_row(q, k, v, out, lse, do, 3, by_head=True)
    for a, b in zip(whole, by_head):
        torch.testing.assert_close(b, a, rtol=1e-6, atol=1e-6)
    with pytest.raises(ValueError, match="packed"):
        plain_bwd_by_row(q, k, v, out, lse, do, 3, layout="bhsd", by_head=True)
