"""The port's multi-process path against the JAX package's ``shard_map``
versions on virtual CPU devices.

One spawned ``gloo`` world of 4 CPU processes (``_torch_port_world.py``,
mesh data 2 x view 2) runs every check of the sharded model: the sharded
denoise, 4 sampler steps of the view-sharded pipeline with ``encoder_reuse=2``
(its steps with the encoder cache and its cached ones), with and without CFG, the data-parallel
train step (mesh data 2, ranks 0 and 1) and the view-sharded train step. A
second world of 2 processes runs ``cli.train`` with ``--mesh-data 2`` and
the process flags, then resumes it. Both worlds start first and run while
this process computes the JAX side once (``jax_side``), on
``make_mesh(data=2, view=2)`` and ``make_mesh(data=2)`` of the 8 virtual
devices.

Bars, in dB of signal over error: >= 60 for the sharded denoise and the
train steps' loss and gradient norms, >= 50 for the pipeline's images
(error compounds across steps). The JAX data-parallel step compiles in a
process of its own meanwhile. The JAX view-sharded step draws each
shard's noise from a key folded with its data and view indices
(``mvd_tpu/train/step.py:436-437``), which no explicit draw can replay
across packages; the port's view-sharded step is therefore held to the
port's unsharded joint step at the same explicit draws, and that step is
held to the JAX package's in ``test_torch_port_joint.py``.
"""

import dataclasses
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port_util import cut_config, jax_train_draws, random_params, snr_db
from _torch_port_world import World
from mvd_tpu.camera import orbit_cameras
from mvd_tpu.config import TINY_MODEL as J_TINY
from mvd_tpu.config import TrainConfig as JTrainConfig
from mvd_tpu.mesh import make_mesh as j_make_mesh
from mvd_tpu.nn import AutoencoderKL as JVAE
from mvd_tpu.nn import CLIPTextEncoder as JCLIP
from mvd_tpu.nn import MultiViewUNet as JMVD
from mvd_tpu.parallel import for_view_sharding as j_for_view_sharding
from mvd_tpu.parallel import sharded_denoise_fn as j_sharded_denoise_fn
from mvd_tpu.pipeline import MVDPipeline as JPipeline
from mvd_tpu.train import TrainState as JTrainState
from mvd_tpu.train import make_optimizer as j_make_optimizer
from mvd_tpu.train import make_train_step as j_make_train_step
from mvd_tpu_torch.config import TINY_MODEL

BAR_DB, PIPE_BAR_DB = 60.0, 50.0
V, STEPS = 2, 4
J_CFG = dataclasses.replace(cut_config(J_TINY), unet=dataclasses.replace(
    cut_config(J_TINY).unet, num_views=V))
T_CFG = dataclasses.replace(cut_config(TINY_MODEL), unet=dataclasses.replace(
    cut_config(TINY_MODEL).unet, num_views=V))
LAT = J_CFG.unet.sample_size
NEXT_ABOVE_1 = float(np.nextafter(np.float32(1.0), np.float32(2.0)))
TRAIN_KEY = jax.random.PRNGKey(11)


def _params():
    z = jnp.zeros((V, LAT, LAT, 4))
    cam = jnp.tile(jnp.eye(4)[None], (V, 1, 1))
    return {
        "mvd": random_params(JMVD(J_CFG).init, z, jnp.zeros((), jnp.int32),
                             jnp.zeros((V, 77, J_CFG.unet.cross_attention_dim)),
                             source_camera=cam, target_camera=cam, source_image_latents=z, seed=1),
        "vae": random_params(JVAE(J_CFG.vae).init, jnp.zeros((1, 16, 16, 3)), seed=2),
        "text_encoder": random_params(JCLIP(J_CFG.text_encoder).init, jnp.zeros((1, 77), jnp.int32),
                                      seed=3),
    }


def _no_remat(cfg):
    """The data-parallel step's config: remat off, which shortens the JAX
    compile (the view-sharded step keeps remat on)."""
    return dataclasses.replace(cfg, unet=dataclasses.replace(cfg.unet, remat=False))


def _pipeline_draws(seed, n):
    """The JAX pipeline's draws (initial latents, source encode, one per
    step), from its own key splits."""
    shape = (n, LAT, LAT, 4)
    rng, lat_rng = jax.random.split(jax.random.PRNGKey(seed))
    latents = jax.random.normal(lat_rng, shape, jnp.float32)
    rng, enc_rng = jax.random.split(rng)
    vae_noise = jax.random.normal(enc_rng, shape, jnp.float32)
    steps = []
    for _ in range(STEPS):
        rng, step_rng = jax.random.split(rng)
        steps.append(jax.random.normal(step_rng, shape, jnp.float32))
    return dict(latents=np.array(latents), vae_noise=np.array(vae_noise), step_noises=np.stack(steps))


def _train_batch(B, seed=0):
    rng = np.random.default_rng(seed)
    cams = orbit_cameras(V).astype(np.float32)
    src = rng.uniform(-1, 1, (B, 1, LAT * 8, LAT * 8, 3)).astype(np.float32)
    return {
        "source_image": np.repeat(src, V, axis=1),
        "target_image": rng.uniform(-1, 1, (B, V, LAT * 8, LAT * 8, 3)).astype(np.float32),
        "source_camera": np.tile(cams[:1], (B, V, 1, 1)),
        "target_camera": np.tile(cams[None], (B, 1, 1, 1)),
        "input_ids": rng.integers(0, J_CFG.text_encoder.vocab_size, (B, V, 77)).astype(np.int32),
    }


def _denoise_inputs():
    n = 2 * V
    rng = np.random.default_rng(7)
    text = rng.normal(size=(n, 77, J_CFG.unet.cross_attention_dim)).astype(np.float32)
    src_lat, lat = (rng.normal(size=(n, LAT, LAT, 4)).astype(np.float32) for _ in range(2))
    cams = orbit_cameras(n).astype(np.float32)
    step_noises = rng.normal(size=(2, n, LAT, LAT, 4)).astype(np.float32)
    return dict(text=text, src_cam=np.tile(cams[:1], (n, 1, 1)), tgt_cam=cams, src_lat=src_lat, lat=lat,
                step_noises=step_noises)


def _pipeline_inputs():
    """4 images = 2 groups of 2 views, 4 DDPM steps with ``encoder_reuse=2``
    (steps with the encoder cache and cached steps); the JAX pipeline's
    draws for the port."""
    m, seed = 4, 5
    pc = orbit_cameras(m)
    src = np.random.default_rng(0).uniform(0, 1, (1, LAT * 8, LAT * 8, 3)).astype(np.float32)
    kw = dict(num_inference_steps=STEPS, source_images=src, ref_scale=1.0, encoder_reuse=2,
              source_camera=np.tile(pc[:1], (m, 1, 1)), target_camera=pc, seed=seed)
    return ["a chair"] * m, kw, _pipeline_draws(seed, m)


@pytest.fixture(scope="module")
def started(tmp_path_factory):
    """The inputs on disk and both worlds started, so that they run while
    this process computes the JAX side."""
    from tests.test_data import make_zip

    workdir = tmp_path_factory.mktemp("sharded")
    params = _params()
    prompts, kw, draws = _pipeline_inputs()
    pipeline_in = {f"guidance {g}": (prompts, dict(kw, guidance_scale=g, **draws)) for g in (1, 3)}
    jp = JPipeline(J_CFG, jax.tree.map(jnp.asarray, params))
    train_in = dict(batch=_train_batch(2), draws=jax_train_draws(TRAIN_KEY, jp.schedule, 2 * V, LAT))
    torch.save(dict(cfg=T_CFG, cfg_dp=_no_remat(T_CFG), tree=params, denoise=_denoise_inputs(),
                    pipeline=pipeline_in, train=train_in), workdir / "sharded_in.pt")
    corpus = workdir / "corpus" / "renders_final"
    corpus.mkdir(parents=True)
    rng = np.random.default_rng(3)
    for i in range(12):
        make_zip(corpus / f"obj_{i}.zip", num_views=3, size=64, rng=rng)
    worlds = {"sharded": World(4, "sharded", str(workdir)), "trainer": World(2, "trainer", str(workdir))}
    dp_proc = _jax_process(workdir)
    yield workdir, params, worlds, dp_proc
    for w in worlds.values():
        w.kill()
    if dp_proc.poll() is None:
        dp_proc.kill()
        dp_proc.wait()


@pytest.fixture(scope="module")
def jax_side(started):
    """The JAX results: the sharded denoise and pipeline on
    ``make_mesh(data=2, view=2)`` here, the data-parallel step on
    ``make_mesh(data=2)`` from its own process."""
    workdir, params, _, dp_proc = started
    tree = jax.tree.map(jnp.asarray, params)
    mesh = j_make_mesh(data=2, view=2)
    cfg_s = j_for_view_sharding(J_CFG, V, 2)
    want = {}

    d = _denoise_inputs()
    n = d["text"].shape[0]
    ju, js = JMVD(J_CFG), JMVD(cfg_s)
    bv = lambda t: jax.tree.map(lambda x: x.reshape((n // V, V) + x.shape[1:]), t)
    den = j_sharded_denoise_fn(js, mesh)

    @jax.jit
    def sharded_denoise(p, text, src_cam, tgt_cam, src_lat, lat):
        film, refs = ju.apply(p, text, src_cam, tgt_cam, src_lat, cfg_batch=n, precompute_kv=True,
                              method=ju.prepare_conditioning)
        return den(p, bv(lat), jnp.asarray(600), bv(text), bv(film), bv(refs), jnp.float32(0.7))

    want["denoise"] = np.asarray(sharded_denoise(
        tree["mvd"], *map(jnp.asarray, (d["text"], d["src_cam"], d["tgt_cam"], d["src_lat"], d["lat"]))))

    # one JAX program with CFG serves guidance 3 and, just above 1, the
    # port's guidance 1.0, which runs no unconditional half
    jpipe = JPipeline(cfg_s, tree, mesh=mesh)
    prompts, kw, _ = _pipeline_inputs()
    for g in (1, 3):
        jg = NEXT_ABOVE_1 if g == 1 else float(g)
        want[f"images/guidance {g}"] = np.asarray(jpipe(prompts, guidance_scale=jg, **kw)["images"])

    dp_proc.wait(timeout=600)
    assert dp_proc.returncode == 0, dp_proc.stdout.read()[-4000:]
    with np.load(workdir / "jax_dp.npz") as f:
        want["dp"] = dict(f)
    return want


def jax_data_parallel_step(out_path):
    """The JAX data-parallel step (``make_train_step`` on ``make_mesh(data=2)``,
    2 samples of 2 views) from ``_params``: its metrics to ``out_path``.
    Run in a JAX process of its own (``_jax_process``), so that its compile
    overlaps the pipeline's in the test process."""
    params = _params()
    tree = jax.tree.map(jnp.asarray, params)
    B = 2
    jcfg = JTrainConfig(model=_no_remat(J_CFG), batch_size=B, image_size=LAT * 8, num_views=V)
    jp = JPipeline(jcfg.model, tree)
    jstep = j_make_train_step(jp, jp.schedule, jcfg, mesh=j_make_mesh(data=2))
    tx = j_make_optimizer(jcfg.optimizer, jp.params["mvd"], total_steps=4)
    jstate = JTrainState.create(jax.tree.map(jnp.array, params["mvd"]), tx)
    frozen = {"vae": jp.params["vae"], "text_encoder": jp.params["text_encoder"]}
    _, jm = jstep(jstate, frozen, jax.tree.map(jnp.asarray, _train_batch(B)), TRAIN_KEY)
    np.savez(out_path, **{k: np.asarray(v) for k, v in jm.items() if not k.startswith("hist/")})


def _jax_process(workdir):
    """A process with the tests' 8 virtual CPU devices (``conftest.py``)
    running ``jax_data_parallel_step``."""
    tests = os.path.dirname(os.path.abspath(__file__))
    code = ("import sys; sys.path[:0] = [{0!r}, {1!r}]; import conftest; "
            "import test_torch_port_sharded as t; t.jax_data_parallel_step({2!r})").format(
                tests, os.path.dirname(tests), str(workdir / "jax_dp.npz"))
    return subprocess.Popen([sys.executable, "-c", code], stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)


@pytest.fixture(scope="module")
def world(started, jax_side):
    """The port's results, each rank's, and the JAX side's."""
    workdir, _, worlds, _ = started
    worlds["sharded"].wait()
    return [torch.load(workdir / f"sharded_out{r}.pt", weights_only=False) for r in range(4)], jax_side


def test_sharded_denoise_matches_jax(world):
    """Each rank's (data, view) block of the view-sharded denoise (ring
    attention across the view pair) against the JAX ``sharded_denoise_fn``."""
    outs, want = world
    for r, out in enumerate(outs):
        d, w = divmod(r, 2)
        assert snr_db(want["denoise"][d:d + 1, w:w + 1], out["denoise"].numpy()) >= BAR_DB, r


def test_sharded_sampler_matches_unsharded(world):
    """``make_sharded_sampler``, 2 DDPM steps at given noise: every rank
    ends with the whole batch's latents, those of the unsharded loop
    (``mvd_tpu/parallel.py:153``'s counterpart; the JAX test
    ``test_sharded_sampling_loop_matches_unsharded`` holds the same)."""
    outs, _ = world
    want = outs[0]["sampler_ref"].numpy()
    got = outs[0]["sampler"]
    assert snr_db(want, got.flatten(0, 1).numpy()) >= BAR_DB
    assert all(torch.equal(o["sampler"], got) for o in outs)


@pytest.mark.parametrize("case", ["guidance 1", "guidance 3"])
def test_sharded_pipeline_matches_jax(world, case):
    """4 DDPM steps of ``MVDPipeline(mesh=...)`` with ``encoder_reuse=2``
    and the JAX pipeline's draws, without CFG and with it (whole view groups
    per half, 2 groups per data index): the same images on every rank,
    against the JAX sharded pipeline."""
    outs, want = world
    got = outs[0][f"images/{case}"].numpy()
    assert got.shape == (4, LAT * 8, LAT * 8, 3) and np.isfinite(got).all()
    assert snr_db(want[f"images/{case}"], got) >= PIPE_BAR_DB
    assert all(torch.equal(o[f"images/{case}"], outs[0][f"images/{case}"]) for o in outs)


def test_data_parallel_step_matches_jax(world):
    """The data-parallel step on a mesh of data 2 (one sample a rank, one
    all-reduce of loss, metrics and gradients) against the JAX step on
    ``make_mesh(data=2)`` at the JAX step's draws."""
    outs, want = world
    got, jm = outs[0]["dp"], want["dp"]
    for k in ["noise_loss"] + [k for k in jm if k.startswith("grad_norm/")]:
        assert snr_db(jm[k], got[k].numpy()) >= BAR_DB, k
    assert all(torch.equal(outs[1]["dp"][k], got[k]) for k in got)
    assert "dp" not in outs[2] and "dp" not in outs[3]


def test_view_sharded_step_matches_unsharded(world):
    """The view-sharded step (ring attention forward and backward, remat on)
    against the port's unsharded joint step at the same explicit draws (see
    the module docstring for why not the JAX sharded step)."""
    outs, _ = world
    got, ref = outs[0]["vs"], outs[0]["vs_ref"]
    for k in ["noise_loss"] + [k for k in ref if k.startswith("grad_norm/")]:
        assert snr_db(ref[k].numpy(), got[k].numpy()) >= BAR_DB, k
    assert all(torch.equal(o["vs"][k], got[k]) for o in outs for k in got)


def test_two_process_trainer_writes_once_and_resumes(started):
    """``cli.train --mesh-data 2`` with the process flags in a 2-process
    world: one run dir for both ranks, 2 steps and a validation, one
    checkpoint written by the primary; ``--resume`` continues to step 3.
    Then ``--mesh-view 2 --num-views 2``: a view-sharded step and a
    validation through the same CLI."""
    workdir, _, worlds, _ = started
    worlds["trainer"].wait()
    outs = [torch.load(workdir / f"trainer_out{r}.pt", weights_only=False) for r in range(2)]
    root = outs[0]["first"]["root"]
    assert all(o["first"]["root"] == root == o["resumed_root"] for o in outs)
    assert all(o["first"]["step"] == 2 and o["resumed_step"] == 3 for o in outs)
    assert outs[0]["first"]["loader_rows"] == 2  # the global batch: 1 per data index
    assert sorted(p.name for p in (workdir / "run").glob("*/checkpoints/*")) == ["2", "3"]
    logs = (workdir / "run" / "logs" / "metrics.jsonl").read_text().splitlines()
    assert sum('"train/noise_loss"' in line for line in logs) == 3  # the primary alone logs
    assert sum('"val/noise_loss"' in line for line in logs) == 2
    assert all(o["view"] == dict(step=1, sharded=True, mesh={"data": 1, "view": 2, "model": 1},
                                 axis="view") for o in outs)
    assert sorted(p.name for p in (workdir / "run_view").glob("*/checkpoints/*")) == ["1"]
