"""The port's ``model`` axis (tensor parallelism, ``mvd_tpu_torch/tensor_parallel.py``
and ``parallel.py:shard_params_model_parallel``) against the JAX package's
``model_parallel_shardings`` on virtual CPU devices.

The port's plan must mark exactly the leaves the JAX rule marks (under the
converter's names), list the partner layers it cuts beyond them apart, and
hold at most JAX's parameter bytes per rank. One spawned ``gloo`` world of
2 CPU processes (``_torch_port_world.py``, ``make_mesh(model=2)``) runs every
multi-process check in one launch while this process computes the JAX
side: the ``UNet2DCondition`` forward (over the gloo ranks and over 2
and 4 virtual ranks, against JAX's replicated forward and its forward with
``shard_params_model_parallel`` on ``make_mesh(model=2)``), a multi-view
denoise with FiLM and precomputed adapter K/V, a CLIP encode, 3 DDPM steps
of the model-sharded pipeline, the collectives' gradients, and what must
raise. ``min_dim`` is 64 so that the TINY widths shard. TINY_MODEL is cut in
depth (``cut_config``, widths kept: a 32-wide level whose GEGLU alone is
marked, a 64-wide one where every product is) so the JAX compiles stay
short; the JAX sharded pipeline's compile (about 15 s) is most of the
file's time.

Bars, in dB of signal over error: >= 60 for the forwards, >= 50 for the
pipeline's images (error compounds across steps); the virtual ranks
bitwise the gloo ranks.
"""

import copy
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from _torch_port_util import cut_config, random_params, snr_db
from _torch_port_world import World
from mvd_tpu.camera import orbit_cameras
from mvd_tpu.config import TINY_MODEL as J_TINY
from mvd_tpu.mesh import make_mesh as j_make_mesh
from mvd_tpu.nn import AutoencoderKL as JVAE
from mvd_tpu.nn import CLIPTextEncoder as JCLIP
from mvd_tpu.nn import MultiViewUNet as JMVD
from mvd_tpu.nn import UNet2DCondition as JUNet
from mvd_tpu.nn.camera_encoder import CameraEncoder as JCameraEncoder
from mvd_tpu.nn.camera_encoder import modulation_dims as j_modulation_dims
from mvd_tpu.parallel import model_parallel_shardings as j_model_parallel_shardings
from mvd_tpu.parallel import shard_params_model_parallel as j_shard_params_model_parallel
from mvd_tpu.pipeline import MVDPipeline as JPipeline
from mvd_tpu_torch.checkpoint import convert_jax_params, load_jax_params
from mvd_tpu_torch.config import TINY_MODEL, TrainConfig
from mvd_tpu_torch.nn import CameraEncoder, modulation_dims
from mvd_tpu_torch.parallel import model_parallel_shardings, shard_params_model_parallel
from mvd_tpu_torch.pipeline import MVDPipeline
from mvd_tpu_torch.pipeline.pipeline import build_model
from mvd_tpu_torch.tensor_parallel import rank_param_bytes, virtual_model_axis
from mvd_tpu_torch.train import TrainState

BAR_DB, PIPE_BAR_DB, MIN_DIM = 60.0, 50.0, 64
STEPS, SEED, B = 3, 5, 2
J_CFG, T_CFG = cut_config(J_TINY), cut_config(TINY_MODEL)
LAT = J_CFG.unet.sample_size


def _mvd_params(cfg, seed):
    z = jnp.zeros((1, LAT, LAT, 4))
    cam = jnp.eye(4)[None]
    return random_params(JMVD(cfg).init, z, jnp.zeros((), jnp.int32),
                         jnp.zeros((1, 77, cfg.unet.cross_attention_dim)),
                         source_camera=cam, target_camera=cam, source_image_latents=z, seed=seed)


def _pipeline_params(cfg):
    return {
        "mvd": _mvd_params(cfg, 1),
        "vae": random_params(JVAE(cfg.vae).init, jnp.zeros((1, 16, 16, 3)), seed=2),
        "text_encoder": random_params(JCLIP(cfg.text_encoder).init, jnp.zeros((1, 77), jnp.int32),
                                      seed=3),
    }


def _unet_inputs():
    rng = np.random.default_rng(0)
    return dict(sample=rng.normal(size=(1, LAT, LAT, 4)).astype(np.float32), t=np.int32(100),
                ctx=rng.normal(size=(1, 77, J_CFG.unet.cross_attention_dim)).astype(np.float32))


def _denoise_inputs():
    n = 2
    rng = np.random.default_rng(7)
    text = rng.normal(size=(n, 77, J_CFG.unet.cross_attention_dim)).astype(np.float32)
    src_lat, lat = (rng.normal(size=(n, LAT, LAT, 4)).astype(np.float32) for _ in range(2))
    cams = orbit_cameras(n).astype(np.float32)
    ids = rng.integers(0, J_CFG.text_encoder.vocab_size, (n, 77)).astype(np.int32)
    return dict(text=text, src_cam=np.tile(cams[:1], (n, 1, 1)), tgt_cam=cams, src_lat=src_lat,
                lat=lat, ids=ids)


def _jax_draws(seed, steps):
    """The JAX pipeline's draws, from its own key splits (latents, source
    encode, one per step)."""
    shape = (B, LAT, LAT, 4)
    rng, lat_rng = jax.random.split(jax.random.PRNGKey(seed))
    latents = jax.random.normal(lat_rng, shape, jnp.float32)
    rng, enc_rng = jax.random.split(rng)
    vae_noise = jax.random.normal(enc_rng, shape, jnp.float32)
    step_noises = []
    for _ in range(steps):
        rng, step_rng = jax.random.split(rng)
        step_noises.append(jax.random.normal(step_rng, shape, jnp.float32))
    return dict(latents=np.array(latents), vae_noise=np.array(vae_noise),
                step_noises=np.stack(step_noises))


def _pipeline_kwargs():
    cams = orbit_cameras(B)
    src = np.random.default_rng(0).uniform(0, 1, (1, LAT * 8, LAT * 8, 3)).astype(np.float32)
    return dict(num_inference_steps=STEPS, guidance_scale=1.0, source_camera=np.tile(cams[:1], (B, 1, 1)),
                target_camera=cams, source_images=src, ref_scale=1.0, seed=SEED)


@pytest.fixture(scope="module")
def tree():
    """The pipeline's flax params, made once."""
    return _pipeline_params(J_CFG)


@pytest.fixture(scope="module")
def started(tmp_path_factory, tree):
    """The inputs on disk and the world started, so that it runs while this
    process computes the JAX side. The UNet forward takes the multi-view
    UNet's own UNet params."""
    workdir = tmp_path_factory.mktemp("model_parallel")
    unet_tree = {"params": tree["mvd"]["params"]["unet"]}
    prompts, kw = ["a chair"] * B, _pipeline_kwargs()
    torch.save(dict(cfg=T_CFG, tree=tree, min_dim=MIN_DIM, unet_tree=unet_tree, unet_in=_unet_inputs(),
                    denoise=_denoise_inputs(), pipeline=(prompts, dict(kw, **_jax_draws(SEED, STEPS)))),
               workdir / "mp_in.pt")
    world = World(2, "model_parallel", str(workdir))
    yield workdir, world, unet_tree, tree
    world.kill()


@pytest.fixture(scope="module")
def jax_side(started):
    """The JAX results: the UNet forward replicated and model-sharded, the
    denoise and the CLIP encode replicated, the pipeline with its params
    model-sharded on ``make_mesh(model=2)``."""
    _, _, unet_tree, tree = started
    mesh = j_make_mesh(model=2)
    want = {}
    unet = JUNet(J_CFG.unet)
    u = _unet_inputs()
    fwd = jax.jit(lambda p, s, t, c: unet.apply(p, s, t, c)[0])
    args = (jnp.asarray(u["sample"]), jnp.asarray(u["t"]), jnp.asarray(u["ctx"]))
    want["unet"] = np.asarray(fwd(jax.tree.map(jnp.asarray, unet_tree), *args))
    with mesh:
        sharded = j_shard_params_model_parallel(jax.tree.map(jnp.asarray, unet_tree), mesh, min_dim=MIN_DIM)
        want["unet sharded"] = np.asarray(fwd(sharded, *args))

    d = _denoise_inputs()
    jm, p = JMVD(J_CFG), jax.tree.map(jnp.asarray, tree)

    @jax.jit
    def denoise(p, text, src_cam, tgt_cam, src_lat, lat):
        film, refs = jm.apply(p, text, src_cam, tgt_cam, src_lat, cfg_batch=text.shape[0],
                              precompute_kv=True, method=jm.prepare_conditioning)
        return jm.apply(p, lat, jnp.asarray(600), text, film, refs, jnp.float32(0.7), method=jm.denoise)

    want["denoise"] = np.asarray(denoise(p["mvd"], *map(jnp.asarray, (
        d["text"], d["src_cam"], d["tgt_cam"], d["src_lat"], d["lat"]))))
    clip = JCLIP(J_CFG.text_encoder)
    want["clip"] = np.asarray(jax.jit(clip.apply)(p["text_encoder"], jnp.asarray(d["ids"])))

    with mesh:
        jpipe = JPipeline(J_CFG, j_shard_params_model_parallel(p, mesh, min_dim=MIN_DIM))
        want["images"] = np.asarray(jpipe(["a chair"] * B, **_pipeline_kwargs())["images"])
    return want


@pytest.fixture(scope="module")
def world(started, jax_side):
    """Each rank's results, and the JAX side's."""
    workdir, w, _, _ = started
    w.wait()
    return [torch.load(workdir / f"mp_out{r}.pt", weights_only=False) for r in range(2)], jax_side


def _jax_marked(tree, n, min_dim):
    """The port names of the leaves JAX's rule marks on ``make_mesh(model=n)``,
    and JAX's parameter bytes per rank."""
    shardings = j_model_parallel_shardings(tree, j_make_mesh(model=n), min_dim=min_dim)
    marked = jax.tree.map(lambda x, s: np.full(x.shape, s.spec != P()), tree, shardings)
    nbytes = jax.tree.map(lambda x, s: x.nbytes / n if s.spec != P() else x.nbytes, tree, shardings)
    names = {name for name, m in convert_jax_params(marked).items() if m.all()}
    return names, sum(jax.tree.leaves(nbytes))


@pytest.mark.parametrize("n", [2, 4])
def test_plan_marks_what_jax_marks(tree, n):
    """The plan of the whole pipeline (the UNet, the camera encoder, CLIP,
    the VAE) marks exactly the leaves JAX's rule marks; the partners it cuts
    beyond them are listed apart (every one a leaf the rule leaves whole); a
    rank holds at most JAX's bytes."""
    want, jax_bytes = _jax_marked(tree, n, MIN_DIM)
    model = build_model(T_CFG)
    load_jax_params(model, tree)
    plan = model_parallel_shardings(model, virtual_model_axis(n), min_dim=MIN_DIM)
    assert set(plan.marked) == want and len(plan.marked) == len(want)
    assert plan.partners and not set(plan.partners) & want
    assert set(plan.cut) == want | set(plan.partners)
    sharded = shard_params_model_parallel(copy.deepcopy(model), virtual_model_axis(n), min_dim=MIN_DIM)
    got_bytes = rank_param_bytes(sharded)
    assert got_bytes <= jax_bytes < rank_param_bytes(model)


@pytest.mark.parametrize("n", [2, 4])
def test_camera_encoder_cuts_its_final_denses_and_projection(n):
    """At ``min_dim`` 32 the TINY camera encoder's translation projection
    (a raw parameter), its final denses and its branches' output denses are
    marked too: the sharded encoder's FiLM params against the JAX encoder's."""
    dims = j_modulation_dims(J_TINY.unet.block_out_channels, num_down=4, num_up=4)
    jenc = JCameraEncoder(J_TINY.camera_encoder, modulation_hidden_dims=tuple(sorted(dims.items())))
    cams = orbit_cameras(3).astype(np.float32)
    src, tgt = np.tile(cams[:1], (3, 1, 1)), cams
    tree = random_params(jenc.init, jnp.asarray(src), jnp.asarray(tgt), seed=6)
    _, jfilm = jax.jit(jenc.apply)(tree, jnp.asarray(src), jnp.asarray(tgt))
    enc = CameraEncoder(TINY_MODEL.camera_encoder, tuple(sorted(modulation_dims(
        TINY_MODEL.unet.block_out_channels, 4, 4).items())))
    load_jax_params(enc, tree)
    plan = model_parallel_shardings(enc, virtual_model_axis(n), min_dim=32)
    assert {"translation_projection", "final_dense_0.weight", "final_dense_1.weight"} <= set(plan.marked)
    assert plan.marked and set(plan.marked) == _jax_marked(tree, n, 32)[0]
    shard_params_model_parallel(enc, virtual_model_axis(n), min_dim=32)
    with torch.no_grad():
        _, film = enc(torch.from_numpy(src), torch.from_numpy(tgt))
    for name, (scale, shift) in jfilm.items():
        assert snr_db(scale, film[name][0].numpy()) >= BAR_DB, name
        assert snr_db(shift, film[name][1].numpy()) >= BAR_DB, name


@pytest.mark.parametrize("ranks", ["gloo 2", "virtual 2", "virtual 4"])
def test_unet_forward_over_the_model_axis_matches_jax(world, ranks):
    """The UNet2DCondition forward, model-sharded, against JAX's
    replicated forward and its model-sharded one (GSPMD on
    ``make_mesh(model=2)``); both gloo ranks return the same output."""
    outs, want = world
    got = outs[0]["unet"][ranks].numpy()
    assert snr_db(want["unet"], got) >= BAR_DB
    assert snr_db(want["unet sharded"], got) >= BAR_DB
    assert torch.equal(outs[1]["unet"]["gloo 2"], outs[0]["unet"]["gloo 2"])


@pytest.mark.parametrize("part", ["unet", "denoise", "clip"])
def test_virtual_ranks_are_bitwise_the_gloo_ranks(world, part):
    outs, _ = world
    assert torch.equal(outs[0][part]["virtual 2"], outs[0][part]["gloo 2"])


@pytest.mark.parametrize("part", ["denoise", "clip"])
@pytest.mark.parametrize("ranks", ["gloo 2", "virtual 4"])
def test_denoise_and_text_encode_over_the_model_axis_match_jax(world, part, ranks):
    """``MultiViewUNet.denoise`` with FiLM and the adapter K/V computed
    ahead on each shard's heads, and the CLIP text encode."""
    outs, want = world
    assert snr_db(want[part], outs[0][part][ranks].numpy()) >= BAR_DB
    assert torch.equal(outs[1][part]["gloo 2"], outs[0][part]["gloo 2"])


def test_sharded_pipeline_matches_jax_sharded_pipeline(world):
    """3 DDPM steps of ``MVDPipeline(mesh=make_mesh(model=2))`` after
    ``shard_params_model_parallel``, at the JAX pipeline's draws: the same
    whole images on both ranks, against the JAX pipeline with model-sharded
    params."""
    outs, want = world
    got = outs[0]["images"].numpy()
    assert got.shape == (B, LAT * 8, LAT * 8, 3) and np.isfinite(got).all()
    assert snr_db(want["images"], got) >= PIPE_BAR_DB
    assert torch.equal(outs[1]["images"], outs[0]["images"])


def test_collectives_backward(world):
    """All-reduce forward / identity backward, identity forward /
    all-reduce backward and all-gather forward / own part backward: the
    input's gradient and each rank's part of the weights' gradients of a
    column -> row pair and a gathered column layer equal the whole layers'."""
    outs, _ = world
    for out in outs:
        assert all(err < 1e-5 for err in out["grads"].values()), out["grads"]


def test_what_the_model_axis_refuses(world):
    """A train step on a model axis, a view-sharded call of a model-sharded
    network and a pipeline whose mesh has a model axis but whose networks
    are whole raise, each naming why."""
    outs, _ = world
    for out in outs:
        assert out["train_step_raises"].startswith("NotImplementedError")
        assert "the model axis in training" in out["train_step_raises"]
        assert out["view_x_model_raises"].startswith("NotImplementedError")
        assert "view axis and a model axis" in out["view_x_model_raises"]
        assert "shard_params_model_parallel" in out["unsharded_pipeline_raises"]


def test_loading_into_a_sharded_pipeline_raises(tree):
    pipe = MVDPipeline.create(T_CFG, seed=0, device="cpu")
    shard_params_model_parallel(pipe.model, virtual_model_axis(2), min_dim=MIN_DIM)
    with pytest.raises(ValueError, match="load the weights first, then"):
        pipe.load_jax_params(tree)
    with pytest.raises(ValueError, match="already model-sharded"):
        shard_params_model_parallel(pipe.model, virtual_model_axis(2), min_dim=MIN_DIM)


def test_view_and_model_axes_together_and_training_a_sharded_network_raise():
    mesh = type("Mesh", (), {"shape": {"data": 1, "view": 2, "model": 2}})()
    with pytest.raises(ValueError, match="view axis and a model axis"):
        MVDPipeline(T_CFG, build_model(T_CFG), "cpu", mesh=mesh)
    model = shard_params_model_parallel(build_model(T_CFG), virtual_model_axis(2), min_dim=MIN_DIM)
    with pytest.raises(NotImplementedError, match="the model axis in training"):
        TrainState.create(model, TrainConfig(model=T_CFG), 4)


def test_sharded_networks_copy_and_cast_with_their_axis():
    """``cast_for_compute`` deep-copies the sharded masters: the copy keeps
    the axis object (a process group is not copied) and computes the same."""
    from mvd_tpu_torch.pipeline.pipeline import cast_for_compute
    from mvd_tpu_torch.tensor_parallel import ColumnParallelLinear

    model = shard_params_model_parallel(build_model(T_CFG), virtual_model_axis(2), min_dim=MIN_DIM)
    copy_ = cast_for_compute(model, torch.float32)
    layers = [m for m in copy_.modules() if isinstance(m, ColumnParallelLinear)]
    originals = [m for m in model.modules() if isinstance(m, ColumnParallelLinear)]
    assert layers and all(a.axis is b.axis for a, b in zip(layers, originals))


@pytest.mark.parametrize("case", ["ddim", "dpmpp_2m", "encoder_reuse", "invert", "int8"])
def test_samplers_and_int8_over_a_virtual_model_axis(tree, case):
    """DDIM, DPM-Solver++, encoder reuse, DDIM inversion and int8 attention
    take the sharded networks unchanged: a pipeline cut over 2 virtual
    ranks against the same pipeline whole. The int8 case runs at 256²,
    where the 32-wide level's self sites (S 1024) quantize; its products
    are whole but its GEGLU, as on the card at 320 and 640."""
    cfg = T_CFG
    if case == "int8":
        cfg = dataclasses.replace(T_CFG, unet=dataclasses.replace(T_CFG.unet, attention_impl="int8"))
    whole = MVDPipeline(cfg, build_model(cfg), "cpu")
    whole.load_jax_params(tree)
    sharded = MVDPipeline(cfg, shard_params_model_parallel(copy.deepcopy(whole.model),
                                                           virtual_model_axis(2), min_dim=MIN_DIM), "cpu")
    kw = dict(_pipeline_kwargs(), **_jax_draws(SEED, STEPS))
    if case == "int8":
        from mvd_tpu_torch.kernels import flash_attention_packed_int8_fwd as int8_fwd

        src = np.random.default_rng(2).uniform(0, 1, (1, 256, 256, 3)).astype(np.float32)
        kw = dict(_pipeline_kwargs(), source_images=src, height=256, width=256)
        quantized = int8_fwd.plain_calls
    if case == "invert":
        images = np.random.default_rng(1).uniform(0, 1, (B, LAT * 8, LAT * 8, 3)).astype(np.float32)
        run = lambda p: p.invert(images, "a chair", num_inference_steps=STEPS,
                                 **{k: kw[k] for k in ("source_camera", "target_camera", "source_images")})["latents"]
    else:
        extra = {"encoder_reuse": {"encoder_reuse": 2}, "int8": {}}.get(case, {"sampler": case})
        run = lambda p: p(["a chair"] * B, **kw, **extra)["images"]
    assert snr_db(run(whole), run(sharded)) >= BAR_DB
    if case == "int8":
        assert int8_fwd.plain_calls > quantized
