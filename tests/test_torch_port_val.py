"""The port's validation entry point (``cli/val.py``, and
``metrics/harness.py:run_validation`` with the metric towers) against the
JAX package's.

Both harnesses get the same batches and towers loaded from the same random
weight files (perceptual, LPIPS-alex, CLIP-L at small width, FID-VGG):
(a) from a stub pipeline that returns fixed images, every CSV column and
its order equal and every value within relative 1e-4; (b) from the TINY
pipeline with the JAX weights carried across (3 DDPM steps, the JAX draws
replayed), the images >= 50 dB and each column within the tolerance that
bar implies (see ``TINY_TOL``); the Trainer's metric hook with the
perceptual and LPIPS towers on the TINY VAE >= 60 dB. The CLI runs with ``--tiny --device cpu``
on a synthetic corpus: a run dir of the port's Trainer restored bitwise,
the ``.ckpt`` and ``save_params`` forms, ``_is_run_dir``'s verdicts equal
to the JAX CLI's, and no GPU without ``--device cpu``.
"""

import csv
import io
import os
import zipfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port_util import cut_config, snr_db, write_tower_files
from mvd_tpu.cli import val as jval
from mvd_tpu.config import TINY_MODEL as J_TINY
from mvd_tpu.metrics.harness import run_validation as j_run_validation
from mvd_tpu.metrics import fid as jfid
from mvd_tpu.metrics import towers as jtowers
from mvd_tpu.metrics.load_towers import load_towers as j_load_towers
from mvd_tpu.nn import AutoencoderKL as JVAE
from mvd_tpu.pipeline import MVDPipeline as JPipeline
from mvd_tpu.pipeline import build_schedule as j_build_schedule
from mvd_tpu.train.losses import reconstruction_metrics as j_reconstruction_metrics
from mvd_tpu_torch.camera import orbit_cameras
from mvd_tpu_torch.checkpoint import export_jax_params, export_lightning_state_dict, save_params
from mvd_tpu_torch.cli import train as train_cli
from mvd_tpu_torch.cli import val
from mvd_tpu_torch.config import TINY_MODEL
from mvd_tpu_torch.data.objaverse import ObjaverseDataModule
from mvd_tpu_torch.data.tokenizer import load_tokenizer
from mvd_tpu_torch.metrics.harness import run_validation
from mvd_tpu_torch.metrics.load_towers import load_towers
from mvd_tpu_torch.nn.vae import AutoencoderKL
from mvd_tpu_torch.pipeline import MVDPipeline, build_schedule
from mvd_tpu_torch.pipeline.pipeline import init_weights
from mvd_tpu_torch.train.losses import reconstruction_metrics
from mvd_tpu_torch.train.loop import Trainer
from mvd_tpu_torch.utils.images import encode_png

TIMING = ("inference_time_s", "batch_time_mean_s", "batch_time_std_s", "batch_time_min_s",
          "batch_time_max_s", "total_inference_s", "img_per_sec")
HW = TINY_MODEL.unet.sample_size * 8
J_CFG, T_CFG = cut_config(J_TINY), cut_config(TINY_MODEL)


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    return write_tower_files(tmp_path_factory.mktemp("towers"))


def _tower_kwargs(files):
    return dict(vgg_weights=files["vgg"], lpips_weights=files["lpips_alex"],
                clip_vision_weights=files["clip_l"], with_fid=True)


@pytest.fixture(scope="module")
def j_towers(files):
    """Makes the JAX package's towers from ``files`` (a fresh FID each
    time), the pairwise ones through one jitted function of their
    parameters each: the same functions, compiled once for the module
    instead of op by op."""
    base = j_load_towers(**_tower_kwargs(files))
    lp = base["lpips"]
    arch = jtowers.clip_arch_from_sd({k: v.numpy() for k, v in torch.load(files["clip_l"]).items()})
    fns = {"perceptual": (jtowers.PerceptualLoss, base["perceptual"].params),
           "lpips": (lambda p: jtowers.LPIPS("alex", p, lp.lin_weights), lp.backbone_params),
           "clip": (lambda p: jtowers.CLIPImageScore(p, **arch), base["clip"].params)}
    jitted = {k: jax.jit(lambda p, a, b, make=make: make(p)(a, b)) for k, (make, _) in fns.items()}

    def make():
        towers = {k: (lambda a, b, k=k: jitted[k](fns[k][1], a, b)) for k in fns}
        for t in towers.values():
            t.available = True
        towers["fid"] = jfid.FID(base["fid"].extractor)
        return towers

    return make


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """10 objects x 4 views of random 64² RGBA PNGs: one object each in the
    val and the test split (6 view pairs each)."""
    root = tmp_path_factory.mktemp("corpus")
    os.makedirs(root / "renders_final")
    rng = np.random.default_rng(0)
    cams = orbit_cameras(4)
    for i in range(10):
        with zipfile.ZipFile(root / "renders_final" / f"obj_{i}.zip", "w") as z:
            for v in range(4):
                z.writestr(f"{v:03d}.png", encode_png(rng.integers(0, 255, (HW, HW, 4), dtype=np.uint8)))
                buf = io.BytesIO()
                np.save(buf, cams[v].astype(np.float32))
                z.writestr(f"{v:03d}.npy", buf.getvalue())
            z.writestr("prompt.txt", f"object {i}")
    return str(root)


def _read_csvs(out_dir):
    with open(os.path.join(out_dir, "validation_results.csv")) as f:
        rows = list(csv.reader(f))
    with open(os.path.join(out_dir, "overall_metrics.csv")) as f:
        overall = list(csv.reader(f))
    return rows, overall


def _compare_csvs(got_dir, want_dir, tol):
    """Columns and their order equal; each value within ``tol(name)``:
    (rtol, atol); the timing columns are compared by name only."""
    (rows, overall), (j_rows, j_overall) = _read_csvs(got_dir), _read_csvs(want_dir)
    assert rows[0] == j_rows[0] and len(rows) == len(j_rows)
    assert [r[0] for r in overall] == [r[0] for r in j_overall]
    pairs = [(name, g, w) for row, j_row in zip(rows[1:], j_rows[1:])
             for name, g, w in zip(rows[0], row, j_row)]
    pairs += [(g[0], g[1], w[1]) for g, w in zip(overall[1:], j_overall[1:])]
    for name, g, w in pairs:
        if name in TIMING:
            continue
        rtol, atol = tol(name)
        assert abs(float(g) - float(w)) <= atol + rtol * abs(float(w)), (name, g, w)
    return rows[0], [r[0] for r in overall[1:]]


class _Stub:
    """A pipeline that returns fixed images drawn from the call's seed."""

    def __init__(self, to):
        self.to = to

    def __call__(self, prompts, seed, height, width, **kw):
        rng = np.random.default_rng(seed)
        return {"images": self.to(rng.uniform(0, 1, (len(prompts), height, width, 3)).astype(np.float32))}


def _batches(n_batches, n, seed=1):
    rng = np.random.default_rng(seed)
    cams = orbit_cameras(n)[:, None]
    return [{"source_image": rng.uniform(-1, 1, (n, 1, HW, HW, 3)).astype(np.float32),
             "target_image": rng.uniform(-1, 1, (n, 1, HW, HW, 3)).astype(np.float32),
             "source_camera": np.roll(cams, 1, axis=0), "target_camera": cams}
            for _ in range(n_batches)]


def test_harness_with_towers_matches_jax_on_fixed_images(files, j_towers, tmp_path):
    batches = _batches(2, 2)
    kw = dict(num_inference_steps=2, save_images=False)
    j_overall = j_run_validation(_Stub(jnp.asarray), batches, str(tmp_path / "j"),
                                 towers=j_towers(), **kw)
    overall = run_validation(_Stub(torch.from_numpy), batches, str(tmp_path / "t"),
                             towers=load_towers(**_tower_kwargs(files)), **kw)
    header, names = _compare_csvs(str(tmp_path / "t"), str(tmp_path / "j"), lambda name: (1e-4, 0.0))
    assert header[6:] == ["perceptual", "lpips", "clip_score"]
    assert names[:5] == ["num_samples", "fid", "perceptual_mean", "lpips_mean", "clip_score_mean"]
    assert list(overall) == list(j_overall)


def _jax_draws(seed, n, steps):
    """The JAX pipeline's draws for ``seed`` (its key splits: latents, the
    source encode, one per DDPM step)."""
    shape = (n, J_CFG.unet.sample_size, J_CFG.unet.sample_size, 4)
    rng, lat_rng = jax.random.split(jax.random.PRNGKey(seed))
    latents = jax.random.normal(lat_rng, shape, jnp.float32)
    rng, enc_rng = jax.random.split(rng)
    vae_noise = jax.random.normal(enc_rng, shape, jnp.float32)
    step_noises = []
    for _ in range(steps):
        rng, step_rng = jax.random.split(rng)
        step_noises.append(jax.random.normal(step_rng, shape, jnp.float32))
    return dict(latents=np.array(latents), vae_noise=np.array(vae_noise), step_noises=np.stack(step_noises))


class _Recorded:
    """Calls ``pipe`` (with the JAX draws of the call's seed handed to the
    port's) and keeps the images it returns."""

    def __init__(self, pipe, steps=None):
        self.pipe, self.steps, self.images = pipe, steps, []

    def __call__(self, prompts, seed, **kw):
        if self.steps is not None:
            kw.update(_jax_draws(seed, len(prompts), self.steps))
        out = self.pipe(prompts, seed=seed, **kw)
        self.images.append(np.asarray(out["images"]))
        return out


# ~ 50 dB on the images is a relative RMS error of 10^(-50/20) = 3.2e-3 of
# their RMS (about 0.55). Every metric is a smooth function of the images
# against fixed targets, whose difference from the images is of the same
# order as the images themselves, so a metric moves by at most a few times
# that relative error: 1e-2 relative on the squared errors, the tower
# scores and FID, and PSNR, 10 log10 of an MSE, within 10 log10(1 + 1e-2)
# = 0.043 dB, taken as 0.05 absolute. SSIM near 0 gets the same 1e-2 as
# an absolute tolerance.
def TINY_TOL(name):
    if name.startswith("psnr"):
        return 0.0, 0.05
    if name.startswith("ssim"):
        return 0.0, 1e-2
    return 1e-2, 0.0


def test_harness_with_towers_matches_jax_on_the_tiny_pipeline(files, j_towers, corpus, tmp_path):
    steps = 3
    tpipe = MVDPipeline.create(T_CFG, seed=5, device="cpu")
    # the port's random weights carried to the JAX pipeline (tracing the
    # JAX init for a param tree would cost more than the test's own work)
    params = {k: {"params": export_jax_params(m)} for k, m in tpipe.model.items()}
    jpipe = _Recorded(JPipeline(J_CFG, jax.tree.map(jnp.asarray, params)))
    tpipe = _Recorded(tpipe, steps)
    dm = ObjaverseDataModule(corpus, load_tokenizer(), image_size=HW, batch_size=2, num_workers=1)
    batches = [b for _, b in zip(range(2), dm.loader("test"))]
    assert len(batches) == 2
    kw = dict(num_inference_steps=steps, save_images=False)
    j_run_validation(jpipe, batches, str(tmp_path / "j"), towers=j_towers(), **kw)
    run_validation(tpipe, batches, str(tmp_path / "t"), towers=load_towers(**_tower_kwargs(files)), **kw)
    assert len(jpipe.images) == len(tpipe.images) == 2
    for want, got in zip(jpipe.images, tpipe.images):
        assert snr_db(want, got) >= 50
    _compare_csvs(str(tmp_path / "t"), str(tmp_path / "j"), TINY_TOL)


def test_trainer_metric_hook_with_the_towers_matches_jax(files, j_towers):
    """The Trainer's metric hook (``train/losses.py:reconstruction_metrics``
    with ``image_metric_fns``) on the TINY VAE, the perceptual and LPIPS
    towers of both packages from the same files: every metric >= 60 dB."""
    vae = AutoencoderKL(T_CFG.vae).eval()
    init_weights(vae, torch.Generator().manual_seed(2))
    tree = {"params": export_jax_params(vae)}
    jvae = JVAE(J_CFG.vae)
    sf = T_CFG.vae.scaling_factor
    decode = jax.jit(lambda z: jvae.apply(tree, z / sf, method=jvae.decode))
    jt, tt = j_towers(), load_towers(**_tower_kwargs(files))
    rng = np.random.default_rng(4)
    lat = J_CFG.unet.sample_size  # decoded to 64², the shape the jitted JAX towers took above
    pred, noisy, tgt = (rng.normal(size=(2, lat, lat, 4)).astype(np.float32) for _ in range(3))
    t = np.array([10, 700], np.int32)
    names = ("perceptual", "lpips")
    want = j_reconstruction_metrics(j_build_schedule(J_CFG), *map(jnp.asarray, (pred, noisy, tgt, t)),
                                    vae_decode=decode, image_metric_fns={k: jt[k] for k in names})
    got = reconstruction_metrics(build_schedule(T_CFG), *map(torch.from_numpy, (pred, noisy, tgt, t)),
                                 vae_decode=lambda z: vae.decode(z / sf),
                                 image_metric_fns={k: tt[k] for k in names})
    assert set(got) == set(want) >= {"perceptual", "lpips", "ssim_value"}
    for k in want:
        assert snr_db(np.asarray(want[k]), got[k].numpy()) >= 60, k


# ------------------------------------------------------------------ the CLI


@pytest.fixture(scope="module")
def run_root(corpus, tmp_path_factory):
    """A run dir of the port's Trainer: 2 TINY steps, checkpoint at step 2
    (its end-of-run validation, which the run dir does not need, left out)."""
    out = tmp_path_factory.mktemp("train")
    with pytest.MonkeyPatch.context() as m:
        m.setattr(Trainer, "validate", lambda self, *a, **k: {})
        tr = train_cli.main(["--tiny", "--device", "cpu", "--dataset-path", corpus, "--batch-size", "2",
                             "--max-steps", "2", "--output-dir", str(out)])
    assert tr.ckpt.all_steps() == [2]
    return tr.dirs["root"]


def _val_argv(corpus, out, *extra):
    return ["--tiny", "--device", "cpu", "--dataset-path", corpus, "--num-samples", "2",
            "--batch-size", "2", "--num-steps", "2", "--output-dir", str(out), *extra]


def test_val_cli_restores_a_run_dir_bitwise_and_scores_with_every_tower(run_root, corpus, files, tmp_path,
                                                                       capsys):
    pipe, overall = val.main(_val_argv(
        corpus, tmp_path / "out", "--checkpoint", run_root, "--vgg-weights", files["vgg"],
        "--lpips-weights", files["lpips_alex"], "--clip-vision-weights", files["clip_l"], "--fid"))
    assert "restored run checkpoint at step 2" in capsys.readouterr().out
    saved = torch.load(os.path.join(run_root, "checkpoints", "2", "state.pt"), weights_only=True)["params"]
    now = pipe.model["mvd"].state_dict()
    assert now.keys() == saved.keys()
    for k, v in saved.items():
        assert now[k].dtype == v.dtype and torch.equal(now[k], v), k
    assert overall["num_samples"] == 2
    for k in ("fid", "perceptual_mean", "lpips_mean", "clip_score_mean", "psnr_mean", "ssim_mean"):
        assert np.isfinite(overall[k]), k
    rows, _ = _read_csvs(str(tmp_path / "out"))
    assert rows[0] == ["batch", "sample", "psnr", "ssim", "mse", "inference_time_s", "perceptual",
                       "lpips", "clip_score"]


@pytest.mark.parametrize("form", ["ckpt", "save_params"])
def test_val_cli_loads_a_lightning_ckpt_and_a_save_params_dir(corpus, tmp_path, form):
    src = MVDPipeline.create(TINY_MODEL, seed=7, device="cpu")
    want = src.model["mvd"].state_dict()
    if form == "ckpt":
        path = str(tmp_path / "last.ckpt")
        sd = export_lightning_state_dict(export_jax_params(src.model["mvd"]))
        torch.save({"state_dict": {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in sd.items()}}, path)
        extra = ["--checkpoint", path]
    else:
        path = str(tmp_path / "params")
        save_params(path, {"mvd": want})
        save_params(str(tmp_path / "vae"), {"vae": src.model["vae"].state_dict()})
        extra = ["--checkpoint", path, "--vae-params", str(tmp_path / "vae")]
    pipe, _ = val.main(_val_argv(corpus, tmp_path / "out", *extra, "--num-samples", "1",
                                 "--batch-size", "1", "--num-steps", "1"))
    got = pipe.model["mvd"].state_dict()
    # the Lightning checkpoint lacks the camera encoder's translation
    # projection, which keeps its init value
    differ = [k for k in want if not torch.equal(got[k], want[k])]
    assert differ == ([] if form == "save_params" else [k for k in want if "translation_projection" in k])
    if form == "save_params":
        for k, v in src.model["vae"].state_dict().items():
            assert torch.equal(pipe.model["vae"].state_dict()[k], v), k


def test_val_cli_refuses_an_orbax_directory(corpus, tmp_path):
    orbax = tmp_path / "orbax_params"
    (orbax / "d").mkdir(parents=True)
    (orbax / "manifest.ocdbt").write_bytes(b"")
    with pytest.raises(ValueError, match="save_params"):
        val.main(_val_argv(corpus, tmp_path / "out", "--checkpoint", str(orbax)))


def test_is_run_dir_gives_the_jax_verdict(run_root, tmp_path):
    params = tmp_path / "params"
    save_params(str(params), {"mvd": {}})
    ckpt = tmp_path / "last.ckpt"
    ckpt.write_bytes(b"")
    ckpts = os.path.join(run_root, "checkpoints")
    forms = {run_root: True, ckpts: True, os.path.join(ckpts, "2"): True, str(params): False,
             str(ckpt): False, str(tmp_path / "missing"): False}
    for path, want in forms.items():
        assert val._is_run_dir(path) is jval._is_run_dir(path) is want, path


def test_val_cli_needs_a_gpu_unless_told_cpu(corpus, tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    argv = ["--dataset-path", corpus, "--output-dir", str(tmp_path / "out")]
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        val.main(argv)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        val.main(argv + ["--tiny"])
