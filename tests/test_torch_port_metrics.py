"""The port's metrics, config loaders and logging against the JAX package.

Bars: ``psnr``, ``psnr_per_image`` and ``ssim`` to rtol 1e-5 (both data
ranges, per image and over the batch); ``reconstruction_metrics`` on the
TINY VAE with the JAX weights carried across >= 60 dB; the YAML loaders
field by field equal; the JSONL records and histograms of ``MetricLogger``
equal.
"""

import dataclasses
import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port_util import random_params, snr_db
from mvd_tpu import config as jconfig
from mvd_tpu.metrics import image as jimage
from mvd_tpu.nn import AutoencoderKL as JVAE
from mvd_tpu.pipeline import build_schedule as j_build_schedule
from mvd_tpu.train.losses import reconstruction_metrics as j_reconstruction_metrics
from mvd_tpu.utils.logging import MetricLogger as JMetricLogger
from mvd_tpu_torch import config as tconfig
from mvd_tpu_torch.checkpoint import load_jax_params
from mvd_tpu_torch.metrics import image as timage
from mvd_tpu_torch.nn.vae import AutoencoderKL
from mvd_tpu_torch.pipeline import build_schedule
from mvd_tpu_torch.train.losses import reconstruction_metrics
from mvd_tpu_torch.utils import profiling
from mvd_tpu_torch.utils.logging import MetricLogger, check_finite, create_output_dirs, log_debug

RTOL, BAR_DB = 1e-5, 60.0
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _images(seed, data_range, shape=(3, 32, 24, 3)):
    rng = np.random.default_rng(seed)
    a = rng.uniform(0, 1, shape).astype(np.float32)
    b = np.clip(a + 0.15 * rng.normal(size=shape), 0, 1).astype(np.float32)
    return (a, b) if data_range == 1.0 else (2 * a - 1, 2 * b - 1)


@pytest.mark.parametrize("data_range", [1.0, 2.0])
def test_psnr_and_ssim_match_jax(data_range):
    a, b = _images(int(data_range), data_range)
    ja, jb, ta, tb = jnp.asarray(a), jnp.asarray(b), torch.from_numpy(a), torch.from_numpy(b)
    for name in ("psnr", "psnr_per_image"):
        want = np.asarray(getattr(jimage, name)(ja, jb, data_range=data_range))
        got = getattr(timage, name)(ta, tb, data_range=data_range).numpy()
        np.testing.assert_allclose(got, want, rtol=RTOL, err_msg=name)
    for per_image in (False, True):
        want = np.asarray(jimage.ssim(ja, jb, data_range=data_range, per_image=per_image))
        got = timage.ssim(ta, tb, data_range=data_range, per_image=per_image).numpy()
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, rtol=RTOL, err_msg=f"ssim per_image={per_image}")
    # identical images: PSNR at its 1e-12 floor, SSIM 1
    np.testing.assert_allclose(timage.ssim(ta, ta, data_range=data_range).numpy(), 1.0, rtol=RTOL)
    np.testing.assert_allclose(timage.psnr(ta, ta, data_range=data_range).numpy(),
                               np.asarray(jimage.psnr(ja, ja, data_range=data_range)), rtol=RTOL)


def test_ssim_filter_turns_tf32_off_for_its_own_convolution_only(monkeypatch):
    """cuDNN's TF32 switch is off inside SSIM's filter and back to what it
    was after it (on and off alike)."""
    seen = []
    conv2d = torch.nn.functional.conv2d

    def spy(*args, **kwargs):
        seen.append(torch.backends.cudnn.allow_tf32)
        return conv2d(*args, **kwargs)

    monkeypatch.setattr(timage.F, "conv2d", spy)
    a, b = _images(0, 1.0)
    for before in (True, False):
        torch.backends.cudnn.allow_tf32 = before
        timage.ssim(torch.from_numpy(a), torch.from_numpy(b), data_range=1.0)
        assert torch.backends.cudnn.allow_tf32 is before
    torch.backends.cudnn.allow_tf32 = True
    assert seen == [False] * 10


def test_reconstruction_metrics_match_jax():
    """x0-hat, the VAE decode of it and of the target, pixel MSE and SSIM,
    and the image-metric hook, on the TINY VAE with the JAX weights."""
    cfg_j, cfg_t = jconfig.TINY_MODEL, tconfig.TINY_MODEL
    params = random_params(JVAE(cfg_j.vae).init, jnp.zeros((1, 16, 16, 3)), seed=2)
    jvae = JVAE(cfg_j.vae)
    vae = AutoencoderKL(cfg_t.vae).eval()
    load_jax_params(vae, params)
    js, ts = j_build_schedule(cfg_j), build_schedule(cfg_t)
    rng = np.random.default_rng(4)
    pred, noisy, tgt = (rng.normal(size=(2, 4, 4, 4)).astype(np.float32) for _ in range(3))
    t = np.array([10, 700], np.int32)
    sf = cfg_t.vae.scaling_factor
    fns = {"mean_abs": lambda x, y: (x - y).abs().mean()}
    jfns = {"mean_abs": lambda x, y: jnp.abs(x - y).mean()}
    decode = jax.jit(lambda z: jvae.apply(params, z / sf, method=jvae.decode))
    want = j_reconstruction_metrics(js, *map(jnp.asarray, (pred, noisy, tgt, t)),
                                    vae_decode=decode, image_metric_fns=jfns)
    got = reconstruction_metrics(
        ts, *map(torch.from_numpy, (pred, noisy, tgt, t)),
        vae_decode=lambda z: vae.decode(z / sf), image_metric_fns=fns)
    assert set(got) == set(want) == {"latent_recon_loss", "pixel_recon_loss", "ssim_value",
                                     "ssim_loss", "mean_abs"}
    for k in want:
        assert snr_db(np.asarray(want[k]), got[k].numpy()) >= BAR_DB, k
    only_latent = reconstruction_metrics(ts, *map(torch.from_numpy, (pred, noisy, tgt, t)))
    assert set(only_latent) == {"latent_recon_loss"}


# ------------------------------------------------------------------ config


def _fields_equal(t_obj, j_obj, path="cfg"):
    """Every field of the port's dataclass equals the JAX one's field of the
    same name; returns the JAX fields the port does not have."""
    skipped = set()
    j_fields = {f.name for f in dataclasses.fields(j_obj)}
    for f in dataclasses.fields(t_obj):
        assert f.name in j_fields, f"{path}.{f.name} is not a JAX field"
        tv, jv = getattr(t_obj, f.name), getattr(j_obj, f.name)
        if dataclasses.is_dataclass(tv):
            skipped |= _fields_equal(tv, jv, f"{path}.{f.name}")
        else:
            assert tv == jv, f"{path}.{f.name}: {tv!r} != {jv!r}"
    return skipped | {f"{path}.{n}" for n in j_fields - {f.name for f in dataclasses.fields(t_obj)}}


# JAX fields of paths the port does not run yet (the mesh)
NOT_PORTED = {"cfg.mesh_shape"}


@pytest.mark.parametrize("name", ["train_config.yaml", "train_config_all.yaml", "evidence_256.yaml",
                                  "evidence_256_nocam.yaml", "evidence_768.yaml"])
def test_yaml_loaders_match_jax(name):
    path = os.path.join(REPO, "config", name)
    skipped = _fields_equal(tconfig.train_config_from_yaml(path), jconfig.train_config_from_yaml(path))
    assert skipped == NOT_PORTED
    _fields_equal(tconfig.data_config_from_yaml(path), jconfig.data_config_from_yaml(path))


def test_defaults_match_jax():
    assert _fields_equal(tconfig.TrainConfig(), jconfig.TrainConfig()) == NOT_PORTED
    assert not _fields_equal(tconfig.DataConfig(), jconfig.DataConfig())


def test_yaml_overrides_and_refusals(tmp_path):
    p = tmp_path / "c.yaml"
    p.write_text("unet_config:\n  block_out_channels: [64, 128]\n  typo_channels: 3\n")
    with pytest.raises(ValueError, match="typo_channels"):
        tconfig.train_config_from_yaml(str(p))
    p.write_text("text_encoder_config:\n  hidden_size: 256\n")
    with pytest.raises(ValueError, match="cross_attention_dim"):
        tconfig.train_config_from_yaml(str(p))


@pytest.mark.parametrize("value", ["true", "false"])
def test_use_linear_projection_loads_in_both_packages(tmp_path, value):
    """One two-line YAML through both loaders: ``true`` loads in both;
    ``false`` raises in the port, naming the linear projection, while the
    JAX package (which never reads the field) builds the linear model."""
    p = tmp_path / "c.yaml"
    p.write_text(f"unet_config:\n  use_linear_projection: {value}\n")
    jcfg = jconfig.train_config_from_yaml(str(p))
    assert jcfg.model.unet.use_linear_projection is (value == "true")
    if value == "true":
        tcfg = tconfig.train_config_from_yaml(str(p))
        assert tcfg.model.unet.use_linear_projection is True
        assert _fields_equal(tcfg, jcfg) == NOT_PORTED
        return
    with pytest.raises(ValueError, match="only the linear projection \\(SD2.1's\\)"):
        tconfig.train_config_from_yaml(str(p))
    # the JAX UNet built from that config has linear (2-D) projections
    from mvd_tpu.nn.unet import UNet2DCondition as JUNet

    cfg = dataclasses.replace(jconfig.TINY_UNET, use_linear_projection=False)
    n = cfg.sample_size
    shapes = jax.eval_shape(JUNet(cfg).init, jax.random.PRNGKey(0), jnp.zeros((1, n, n, 4)),
                            jnp.zeros(()), jnp.zeros((1, 77, cfg.cross_attention_dim)))
    flat = jax.tree_util.tree_flatten_with_path(shapes)[0]
    proj = [leaf.shape for path, leaf in flat
            if any(getattr(k, "key", None) in ("proj_in", "proj_out") for k in path)
            and getattr(path[-1], "key", None) == "kernel"]
    assert proj and all(len(s) == 2 for s in proj), proj


def test_yaml_loaders_without_pyyaml_raise(monkeypatch):
    monkeypatch.setitem(sys.modules, "yaml", None)
    path = os.path.join(REPO, "config", "train_config.yaml")
    for loader in (tconfig.train_config_from_yaml, tconfig.data_config_from_yaml):
        with pytest.raises(SystemExit, match="PyYAML"):
            loader(path)


# ----------------------------------------------------------------- logging


def test_metric_logger_matches_jax(tmp_path):
    rng = np.random.default_rng(0)
    hist = rng.normal(size=500).astype(np.float32)
    hist[3] = np.nan
    j = JMetricLogger(str(tmp_path / "jax"), use_wandb=False)
    t = MetricLogger(str(tmp_path / "port"))
    assert t.wandb is None and t.run_id is None
    for logger, conv in ((j, jnp.asarray), (t, torch.from_numpy)):
        logger.log({"a": conv(np.array(1.5, np.float32)), "b": 2, "epoch": 0}, step=3)
        logger.log_histograms({"grad/x": conv(hist)}, step=3)
        logger.finish()
    recs = []
    for logger in (j, t):
        with open(logger.jsonl_path) as f:
            recs.append([{k: v for k, v in json.loads(line).items() if k != "time"} for line in f])
    assert recs[0] == recs[1] and len(recs[0]) == 2


def test_run_dirs_debug_log_and_check_finite(tmp_path):
    dirs = create_output_dirs(str(tmp_path / "out"))
    assert set(dirs) == {"root", "checkpoints", "comparisons", "samples", "logs"}
    assert all(os.path.isdir(d) for d in dirs.values())
    log_debug(str(tmp_path / "d.log"), "hello")
    log_debug(None, "ignored")
    assert (tmp_path / "d.log").read_text().endswith("hello\n")
    assert check_finite({"a": torch.ones(3), "b": [torch.zeros(2), np.ones(2)]})
    assert not check_finite({"a": torch.tensor([1.0, float("nan")])})
    assert check_finite(torch.nn.Linear(2, 2))


def test_profiling_helpers_on_the_cpu(tmp_path):
    calls = []
    out = profiling.time_fn(lambda x: calls.append(x), 1, warmup=2, iters=3)
    assert len(calls) == 5 and out["iters"] == 3 and out["mean_s"] >= 0
    with profiling.trace(str(tmp_path / "tr")):
        with profiling.annotate("region"):
            torch.ones(8) @ torch.ones(8)
    with open(tmp_path / "tr" / "trace.json") as f:
        assert "region" in f.read()
    assert profiling.device_memory_stats() == {}
