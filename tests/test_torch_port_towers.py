"""The port's metric towers against the JAX package's (``mvd_tpu/metrics``).

One random state dict per tower is written in its public layout
(torchvision ``vgg16``, an lpips file with its AlexNet trunk under ``net.``,
transformers ``CLIPVisionModelWithProjection``, pytorch-fid InceptionV3)
and loaded through both ``load_towers``; the same seeded numpy images go
through both sides. Bars: feature maps >= 60 dB, metric scalars within
relative 1e-4, the antialiased resize within 2e-5 of
``jax.image.resize(..., "bilinear")``, the FID statistics bitwise or within
relative 1e-12.
"""

import math
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port_util import CLIP_ARCHS, snr_db, write_tower_files
from mvd_tpu.metrics import fid as jfid
from mvd_tpu.metrics import inception as jinc
from mvd_tpu.metrics import towers as jtowers
from mvd_tpu.metrics.load_towers import load_towers as j_load_towers
from mvd_tpu_torch.metrics import fid as tfid
from mvd_tpu_torch.metrics import inception as tinc
from mvd_tpu_torch.metrics import towers as ttowers
from mvd_tpu_torch.metrics.load_towers import load_towers

SCALAR_RTOL = 1e-4


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    return write_tower_files(tmp_path_factory.mktemp("towers"))


def _images(seed, shape=(2, 64, 64, 3), lo=-1.0):
    rng = np.random.default_rng(seed)
    return rng.uniform(lo, 1.0, shape).astype(np.float32)


def _rel(got, want):
    return abs(float(got) - float(want)) / max(abs(float(want)), 1e-12)


@pytest.mark.parametrize("src,dst", [(768, 224), (768, 299), (512, 224), (64, 224), (64, 299)])
def test_resize_matches_jax_bilinear(src, dst):
    """``jax.image.resize(..., "bilinear")`` antialiases when it shrinks;
    the port's resize must too."""
    x = _images(src, (2, src, src, 3), lo=0.0)
    want = np.asarray(jax.image.resize(jnp.asarray(x), (2, dst, dst, 3), "bilinear"))
    got = ttowers.resize_bilinear(torch.from_numpy(x).permute(0, 3, 1, 2), dst).permute(0, 2, 3, 1).numpy()
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= 2e-5


def test_vgg_perceptual_matches_jax(files):
    jp = j_load_towers(vgg_weights=files["vgg"])["perceptual"]
    tp = load_towers(vgg_weights=files["vgg"])["perceptual"]
    a, b = _images(0), _images(1)
    # one jitted call of the JAX tower: one compile, not one per eager op
    score, want = jax.jit(lambda p, a, b: (jtowers.PerceptualLoss(p)(a, b), jp.model.apply(
        p, jtowers._imagenet_norm(a))))(jp.params, a, b)
    got = tp.model(ttowers._imagenet_norm(torch.from_numpy(a).permute(0, 3, 1, 2)))
    assert set(got) == set(want) and len(got) == 26
    for k in want:
        assert snr_db(np.asarray(want[k]), got[k].permute(0, 2, 3, 1).numpy()) >= 60, k
    assert _rel(tp(a, b), score) <= SCALAR_RTOL


@pytest.mark.parametrize("net", ["alex", "vgg"])
def test_lpips_matches_jax(files, net):
    kw = dict(lpips_weights=files[f"lpips_{net}"], lpips_net=net)
    if net == "vgg":
        kw["vgg_weights"] = files["vgg"]
    jl, tl = j_load_towers(**kw)["lpips"], load_towers(**kw)["lpips"]
    assert jl.available and tl.available
    a = _images(2)
    b = np.clip(a + 0.2 * _images(3), -1, 1)
    score, want = jax.jit(lambda p, a, b: (
        jtowers.LPIPS(net, p, jl.lin_weights)(a, b),
        jl.model.apply(p, (a - jtowers.LPIPS_SHIFT) / jtowers.LPIPS_SCALE)))(jl.backbone_params, a, b)
    got = tl._feats(torch.from_numpy(a).permute(0, 3, 1, 2))
    for k in tl.layers:
        assert snr_db(np.asarray(want[k]), got[k].permute(0, 2, 3, 1).numpy()) >= 60, k
    assert _rel(tl(a, b), score) <= SCALAR_RTOL
    assert float(tl(a, a)) < 1e-6


@pytest.mark.parametrize("family", sorted(CLIP_ARCHS))
def test_clip_score_matches_jax(files, family):
    path = files[f"clip_{family}"]
    sd = torch.load(path, weights_only=True)
    arch = ttowers.clip_arch_from_sd(sd)
    assert arch == jtowers.clip_arch_from_sd({k: v.numpy() for k, v in sd.items()})
    assert arch["hidden_act"] == ("gelu" if family == "h" else "quick_gelu")
    assert arch["hidden_size"] // arch["num_heads"] == (80 if family == "h" else 64)
    jc = j_load_towers(clip_vision_weights=path)["clip"]
    tc = load_towers(clip_vision_weights=path)["clip"]
    a, b = _images(4, lo=0.0), _images(5, lo=0.0)  # 64² resized to 224²
    score, want = jax.jit(lambda p, a, b: (
        jtowers.CLIPImageScore(p, **arch)(a, b), jtowers.CLIPImageScore(p, **arch).embed(a)))(jc.params, a, b)
    assert snr_db(np.asarray(want), tc.embed(a).numpy()) >= 60
    assert _rel(tc(a, b), score) <= SCALAR_RTOL


def test_inception_features_match_jax(files):
    jx = j_load_towers(inception_weights=files["inception"])["fid"].extractor
    tx = load_towers(inception_weights=files["inception"])["fid"].extractor
    x = _images(6, lo=0.0)
    want, got = jx(x), tx(x)
    assert got.shape == (2, 2048) and np.isfinite(got).all()
    assert snr_db(want, got) >= 60


def test_avg_pool_and_batch_norm_match_jax():
    x = _images(7, (2, 9, 7, 5))
    xt = torch.from_numpy(x).permute(0, 3, 1, 2)
    want = np.asarray(jinc.avg_pool_nopad(jnp.asarray(x)))
    got = tinc.avg_pool_nopad(xt).permute(0, 2, 3, 1).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)
    # BasicConv2d: conv without bias, batch norm with eps 1e-3, relu
    rng = np.random.default_rng(8)
    w = rng.normal(size=(4, 5, 3, 3)).astype(np.float32)
    bn = {k: rng.uniform(0.5, 1.5, 4).astype(np.float32) for k in ("scale", "bias", "mean", "var")}
    bn["var"] = np.full(4, 1e-3, np.float32)  # where eps 1e-3 against 1e-5 shows
    jm = jinc.BasicConv2d(4, (3, 3), padding=1)
    params = {"params": {"conv": {"kernel": w.transpose(2, 3, 1, 0)},
                         **{f"bn_{k}": v for k, v in bn.items()}}}
    want = np.asarray(jm.apply(params, jnp.asarray(x)))
    tm = tinc.BasicConv2d(5, 4, 3, padding=1)
    tm.load_state_dict({"conv.weight": torch.from_numpy(w), "bn.weight": torch.from_numpy(bn["scale"]),
                        "bn.bias": torch.from_numpy(bn["bias"]), "bn.running_mean": torch.from_numpy(bn["mean"]),
                        "bn.running_var": torch.from_numpy(bn["var"])})
    with torch.no_grad():
        got = tm(xt).permute(0, 2, 3, 1).numpy()
    assert snr_db(want, got) >= 60


def test_fid_statistics_match_jax():
    rng = np.random.default_rng(9)
    feats = [rng.normal(size=(n, 16)).astype(np.float32) for n in (5, 7, 3)]
    jm, tm = jfid.RunningMoments(16), tfid.RunningMoments(16)
    for f in feats:
        jm.update(f)
        tm.update(f)
    for attr in ("n", "sum", "outer", "mean", "cov"):
        np.testing.assert_array_equal(getattr(tm, attr), getattr(jm, attr), err_msg=attr)
    mu2, cov2 = feats[0].mean(0) + 0.5, np.cov(feats[1].T) * 2
    want = jfid.frechet_distance(jm.mean, jm.cov, mu2, cov2)
    got = tfid.frechet_distance(tm.mean, tm.cov, mu2, cov2)
    assert abs(got - want) <= 1e-12 * abs(want)
    a = np.cov(feats[0].T)
    assert tfid._sqrtm_trace(a, cov2) == jfid._sqrtm_trace(a, cov2)


def test_fid_vgg_matches_jax(files):
    jf = j_load_towers(vgg_weights=files["vgg"], with_fid=True)["fid"]
    tf = load_towers(vgg_weights=files["vgg"], with_fid=True)["fid"]
    for seed in (10, 11):
        real, fake = _images(seed, (3, 32, 32, 3), lo=0.0), _images(seed + 10, (3, 32, 32, 3), lo=0.0)
        for f, cast in ((jf, np.asarray), (tf, torch.from_numpy)):
            f.update(cast(real), real=True)
            f.update(cast(fake), real=False)
    for real in (True, False):
        assert snr_db(jf._moments(real).mean, tf._moments(real).mean) >= 60
    got, want = tf.compute(), jf.compute()
    assert math.isfinite(got) and _rel(got, want) <= SCALAR_RTOL


def test_missing_flags_leave_towers_unavailable(files):
    towers = load_towers()
    assert sorted(towers) == ["clip", "fid", "lpips", "perceptual"]
    assert not any(t.available for t in towers.values())
    only_clip = load_towers(clip_vision_weights=files["clip_l"])
    assert only_clip["clip"].available
    assert not any(only_clip[k].available for k in ("perceptual", "lpips", "fid"))


@pytest.mark.parametrize("flag,kw", [
    ("--vgg-weights", "vgg_weights"), ("--lpips-weights", "lpips_weights"),
    ("--clip-vision-weights", "clip_vision_weights"), ("--inception-weights", "inception_weights"),
])
def test_a_named_file_that_cannot_load_raises(tmp_path, files, flag, kw):
    """Where the JAX loader logs a warning and drops the metric, the port
    raises naming the flag and the file: a missing file, bytes that are no
    state dict, and a state dict of another tower."""
    missing = str(tmp_path / "missing.pth")
    garbage = tmp_path / "garbage.pth"
    garbage.write_bytes(b"not a state dict")
    other = files["clip_l"] if kw != "clip_vision_weights" else files["vgg"]
    for path in (missing, str(garbage), other):
        with pytest.raises(ValueError, match=re.escape(f"{flag} '{path}'")):
            load_towers(**{kw: path})


def test_fid_without_usable_weights_raises(files):
    with pytest.raises(ValueError, match="--fid needs"):
        load_towers(with_fid=True)
    with pytest.raises(ValueError, match="--fid needs"):
        load_towers(clip_vision_weights=files["clip_l"], with_fid=True)
    # the JAX loader gives a silent FID without an extractor here
    assert not j_load_towers(with_fid=True)["fid"].available


def test_lpips_vgg_without_vgg_weights_raises(files):
    with pytest.raises(ValueError, match="--lpips-weights.*--vgg-weights"):
        load_towers(lpips_weights=files["lpips_vgg"], lpips_net="vgg")


def test_each_tower_turns_tf32_off_for_its_own_forward_only(files, monkeypatch):
    """cuDNN's and cuBLAS's TF32 switches are off in every convolution and
    linear layer of every tower, and back to what they were after it."""
    seen = []
    conv2d, linear = torch.nn.functional.conv2d, torch.nn.functional.linear

    def spy(fn):
        def run(*args, **kwargs):
            seen.append((torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32))
            return fn(*args, **kwargs)
        return run

    monkeypatch.setattr(torch.nn.functional, "conv2d", spy(conv2d))
    monkeypatch.setattr(torch.nn.functional, "linear", spy(linear))
    towers = load_towers(vgg_weights=files["vgg"], lpips_weights=files["lpips_alex"],
                         clip_vision_weights=files["clip_l"], inception_weights=files["inception"])
    a, b = _images(12, (1, 32, 32, 3), lo=0.0), _images(13, (1, 32, 32, 3), lo=0.0)
    calls = [lambda: towers["perceptual"](a, b), lambda: towers["lpips"](a, b),
             lambda: towers["clip"](a, b), lambda: towers["fid"].update(a, real=True),
             lambda: tfid.vgg_pool_extractor(towers["perceptual"].model)(a)]
    saved = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    try:
        for before in (True, False):
            for call in calls:
                torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = before
                n = len(seen)
                call()
                assert len(seen) > n
                assert torch.backends.cudnn.allow_tf32 is before
                assert torch.backends.cuda.matmul.allow_tf32 is before
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved
    assert set(seen) == {(False, False)}

