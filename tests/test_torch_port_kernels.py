"""The port's kernel modules against the JAX package's Pallas kernels.

On the CPU each wrapper runs its plain PyTorch version; here that version is
held against the Pallas kernel in interpret mode (and, for GroupNorm, the XLA
formulation) on the same numpy inputs, in f32, at ragged shapes. The CUDA
kernels themselves are held against the plain versions on the card by
``chip_smoke.py``. Bar: >= 60 dB.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port_util import snr_db
from mvd_tpu.kernels.flash_attention import _flash_fwd_packed, _round_up
from mvd_tpu.kernels.groupnorm_silu import _pallas_gn_silu, xla_groupnorm_silu
from mvd_tpu_torch.kernels import _build
from mvd_tpu_torch.kernels.flash_attention import (
    BWD_ROWS,
    _check_cuda_inputs,
    attention_packed,
    bwd_stats,
    flash_attention_packed_fwd,
)
from mvd_tpu_torch.kernels.groupnorm_silu import (
    FUSED,
    MAX_THREADS,
    SMEM_MAX,
    TWO_PASS,
    _smem_bytes,
    groupnorm_silu,
    launch_plan,
)
from mvd_tpu_torch.kernels.measure import attn_bounds, bwd_bounds, check_attention, check_grad

BAR_DB = 60.0


def _pallas_packed(q, k, v, heads, scale, block=128):
    """Pallas packed forward in interpret mode, padded to whole blocks as
    ``flash_attention_packed`` pads, with the tail masked in-kernel."""
    Sq, Sk = q.shape[1], k.shape[1]
    sq_pad, sk_pad = _round_up(Sq, block), _round_up(Sk, block)
    pad = lambda t, s: jnp.pad(jnp.asarray(t), ((0, 0), (0, s - t.shape[1]), (0, 0)))
    out, lse = _flash_fwd_packed(
        pad(q, sq_pad), pad(k, sk_pad), pad(v, sk_pad), heads, scale,
        block, block, Sk, True,
    )
    return np.asarray(out)[:, :Sq], np.asarray(lse)[:, :Sq]


@pytest.mark.parametrize(
    "B,Sq,Sk,heads,D",
    [(2, 200, 77, 2, 64), (1, 130, 300, 3, 32), (2, 64, 64, 2, 64)],
)
def test_attention_plain_matches_pallas(B, Sq, Sk, heads, D):
    rng = np.random.default_rng(Sq + Sk)
    q = rng.normal(size=(B, Sq, heads * D)).astype(np.float32)
    k = rng.normal(size=(B, Sk, heads * D)).astype(np.float32)
    v = rng.normal(size=(B, Sk, heads * D)).astype(np.float32)
    scale = D**-0.5
    want_out, want_lse = _pallas_packed(q, k, v, heads, scale)
    before = flash_attention_packed_fwd.launches
    out, lse = flash_attention_packed_fwd(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), heads
    )
    assert out.shape == (B, Sq, heads * D) and lse.shape == (B, Sq, heads)
    assert snr_db(want_out, out.numpy()) >= BAR_DB
    assert snr_db(want_lse, lse.numpy()) >= BAR_DB
    assert flash_attention_packed_fwd.launches == before  # CPU: no kernel


@pytest.mark.parametrize(
    "shape,groups,eps,silu",
    [((2, 8, 8, 64), 8, 1e-5, True), ((1, 6, 10, 96), 32, 1e-6, False),
     ((2, 4, 4, 128), 32, 1e-6, True)],
)
def test_groupnorm_plain_matches_pallas_and_xla(shape, groups, eps, silu):
    rng = np.random.default_rng(shape[-1])
    x = (rng.normal(size=shape) * 2 + 0.5).astype(np.float32)
    scale = (1 + 0.1 * rng.normal(size=shape[-1])).astype(np.float32)
    bias = (0.1 * rng.normal(size=shape[-1])).astype(np.float32)
    pallas = np.asarray(_pallas_gn_silu(
        jnp.asarray(x), jnp.asarray(scale), jnp.asarray(bias), groups, eps, silu, True
    ))
    xla = np.asarray(xla_groupnorm_silu(
        jnp.asarray(x), jnp.asarray(scale), jnp.asarray(bias), groups, eps, silu
    ))
    before = groupnorm_silu.launches
    got = groupnorm_silu(
        torch.from_numpy(x), torch.from_numpy(scale), torch.from_numpy(bias), groups, eps, silu
    ).numpy()
    assert snr_db(pallas, got) >= BAR_DB
    assert snr_db(xla, got) >= BAR_DB
    assert groupnorm_silu.launches == before


def test_wrappers_count_plain_calls_on_cpu():
    q = torch.randn(1, 8, 64)
    calls = flash_attention_packed_fwd.plain_calls
    attention_packed(q, q, q, 1)
    assert flash_attention_packed_fwd.plain_calls == calls + 1
    x = torch.randn(1, 2, 2, 8)
    calls = groupnorm_silu.plain_calls
    groupnorm_silu(x, torch.ones(8), torch.zeros(8), 2)
    assert groupnorm_silu.plain_calls == calls + 1


def test_wrappers_raise_off_cpu_without_kernel():
    """A tensor that is not on the CPU never takes the plain version."""
    q = torch.empty(1, 8, 64, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        attention_packed(q, q, q, 1)
    x = torch.empty(1, 2, 2, 8, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        groupnorm_silu(x, torch.ones(8), torch.zeros(8), 2)


@pytest.mark.parametrize(
    "dtype,heads,hd,err",
    [(torch.float32, 1, 64, TypeError), (torch.bfloat16, 2, 64, ValueError),
     (torch.bfloat16, 1, 64, None)],
)
def test_flash_kernel_input_checks(dtype, heads, hd, err):
    q = torch.zeros(1, 8, hd, dtype=dtype)
    if err is None:
        _check_cuda_inputs(q, q, q, heads)
    else:
        with pytest.raises(err):
            _check_cuda_inputs(q, q, q, heads)


def test_build_raises_without_nvcc(monkeypatch):
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setattr(_build, "_stale", lambda name: True)
    real_exists = _build.os.path.exists
    monkeypatch.setattr(
        _build.os.path, "exists", lambda p: False if p.endswith("nvcc") else real_exists(p)
    )
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build_all(["flash_attn_fwd"])


@pytest.mark.parametrize(
    "newer,stale", [(None, False), ("common.cuh", True), ("k.cu", True), ("libk.so", False)]
)
def test_build_is_stale_when_a_source_or_header_is_newer(monkeypatch, tmp_path, newer, stale):
    """A library is rebuilt when its .cu or any header under csrc/ is newer."""
    csrc, build = tmp_path / "csrc", tmp_path / "_build"
    csrc.mkdir()
    build.mkdir()
    for f in (csrc / "k.cu", csrc / "common.cuh", csrc / "other.cu", build / "libk.so"):
        f.write_text("")
    mtimes = {"k.cu": 100.0, "common.cuh": 100.0, "other.cu": 900.0, "libk.so": 200.0}
    if newer:
        mtimes[newer] = 300.0
    monkeypatch.setattr(_build, "CSRC", str(csrc))
    monkeypatch.setattr(_build, "BUILD_DIR", str(build))
    monkeypatch.setattr(_build.os.path, "getmtime", lambda p: mtimes[os.path.basename(p)])
    assert _build._stale("k") is stale


@pytest.mark.parametrize(
    "fault,passes",
    [("none", True), ("spread", False), ("one", False), ("lse", False), ("nan", False)],
)
def test_check_attention_bounds(fault, passes):
    """The on-card check of K1/K5: a 1.5% error on every element stays under
    the elementwise bound (2%) and is caught by the relative RMS bound; one
    element 10% off, lse off by 1e-2 and a NaN are caught elementwise."""
    gen = torch.Generator().manual_seed(0)
    ref_out, ref_lse = torch.randn(2, 64, 128, generator=gen), 5 + torch.rand(2, 64, 2, generator=gen)
    out, lse = ref_out.clone(), ref_lse.clone()
    if fault == "spread":
        out *= 1.015
    elif fault == "one":
        out[1, 7, 3] = ref_out[1, 7, 3] * 1.1 + 0.01
    elif fault == "lse":
        lse[0, 3, 1] += 1e-2
    elif fault == "nan":
        out[0, 0, 0] = float("nan")
    if passes:
        assert check_attention(out, lse, ref_out, ref_lse, "k") == (0.0, 0.0)
    else:
        with pytest.raises(AssertionError):
            check_attention(out, lse, ref_out, ref_lse, "k")


def test_attn_bounds_at_the_hot_site():
    """B4 S4096² H5 on the H100 at 1980 MHz: 8.59e10 bf16 FLOP over 989
    TFLOP/s and 3.36e8 exponentials at 16 per clock on 132 SMs."""
    b = attn_bounds(4, 4096, 4096, 5, 1.98e9)
    assert b["ops_ms"] == pytest.approx(0.086856, rel=1e-4)
    assert b["exp_ms"] == pytest.approx(0.080236, rel=1e-4)
    assert b["bytes_ms"] == pytest.approx(2 * 4 * 4 * 4096 * 320 / 3.35e9 + 4 * 4 * 4096 * 5 / 3.35e9, rel=1e-6)


@pytest.mark.parametrize("fault,passes", [("none", True), ("spread", False), ("one", False), ("nan", False)])
def test_check_grad_bounds(fault, passes):
    """The on-card check of K3a/K3b: a 1.5% error on every element stays
    under the elementwise bound (rtol 2%) and is caught by the relative RMS
    bound (1%); one element 10% + 0.1 off and a NaN are caught elementwise."""
    want = torch.randn(2, 64, 128, generator=torch.Generator().manual_seed(0))
    got = want.clone()
    if fault == "spread":
        got *= 1.015
    elif fault == "one":
        got[1, 7, 3] = want[1, 7, 3] * 1.1 + 0.1
    elif fault == "nan":
        got[0, 0, 0] = float("nan")
    if passes:
        err, rms, rel_rms = check_grad(got, want, "g")
        assert (err, rel_rms) == (0.0, 0.0) and rms == pytest.approx(1.0, rel=0.05)
    else:
        with pytest.raises(AssertionError):
            check_grad(got, want, "g")


def test_bwd_bounds_at_the_hot_site():
    """B6 S9216² H5 on the H100: K3a's 3 and K3b's 4 products of 2 Sq Sk D
    FLOP per head over 989 TFLOP/s bound both; the bytes are q, k, v, dO
    (bf16), lse and delta (f32) once and the gradients once."""
    b = bwd_bounds(6, 9216, 9216, 5)
    assert b["dq"]["ops_ms"] == pytest.approx(0.9893, rel=1e-4)
    assert b["dkv"]["ops_ms"] == pytest.approx(1.3191, rel=1e-4)
    io = 2 * 4 * 6 * 9216 * 320 + 2 * 4 * 6 * 9216 * 5
    assert b["dq"]["bytes_ms"] == pytest.approx((io + 2 * 6 * 9216 * 320) / 3.35e9, rel=1e-9)
    assert b["dkv"]["bytes_ms"] == pytest.approx((io + 4 * 6 * 9216 * 320) / 3.35e9, rel=1e-9)
    for part in ("dq", "dkv"):
        assert (b[part]["bound_ms"], b[part]["bound_by"]) == (b[part]["ops_ms"], "operations")


@pytest.mark.parametrize("layout,B,Sq,heads", [("packed", 2, 130, 3), ("packed", 1, 128, 2), ("bhsd", 2, 1, 3)])
def test_bwd_stats_match_the_jax_reordering(layout, B, Sq, heads):
    """The statistics the K3a/K3b kernels take, (B, H, Sq_pad) f32, against
    the JAX package's own reordering, written out in numpy:
    ``_flash_attention_packed_bwd`` hands ``_flash_bwd`` lse.transpose(0, 2,
    1) and the heads of out and dO as (B, H, S, D)
    (``mvd_tpu/kernels/flash_attention.py:289-304``), and ``_flash_bwd``
    takes delta = sum(dO * out, -1) in f32 (:649). Rows past Sq up to the
    next multiple of 128 hold lse +inf and delta 0."""
    rng = np.random.default_rng(7)
    D = 64
    shape = (B, heads, Sq, D) if layout == "bhsd" else (B, Sq, heads * D)
    out, do = (rng.standard_normal(shape).astype(np.float32) for _ in range(2))
    lse = rng.standard_normal((B, heads, Sq) if layout == "bhsd" else (B, Sq, heads)).astype(np.float32)
    if layout == "packed":
        tr = lambda t: t.reshape(B, Sq, heads, D).transpose(0, 2, 1, 3)
        want_lse, out_h, do_h = lse.transpose(0, 2, 1), tr(out), tr(do)
    else:
        want_lse, out_h, do_h = lse, out, do
    # out and dO reach the kernels in bf16: the reference takes the same values
    as_bf16 = lambda a: torch.from_numpy(np.ascontiguousarray(a)).bfloat16()
    bf = lambda a: as_bf16(a).float().numpy()
    want_delta = np.sum(bf(do_h).astype(np.float32) * bf(out_h).astype(np.float32), axis=-1)

    got_lse, got_delta = bwd_stats(as_bf16(out), as_bf16(do), torch.from_numpy(lse), heads, layout)
    sq_pad = -(-Sq // BWD_ROWS) * BWD_ROWS
    assert got_lse.shape == got_delta.shape == (B, heads, sq_pad)
    assert got_lse.dtype == got_delta.dtype == torch.float32
    assert got_lse.is_contiguous() and got_delta.is_contiguous()
    np.testing.assert_array_equal(got_lse[..., :Sq].numpy(), want_lse)
    np.testing.assert_allclose(got_delta[..., :Sq].numpy(), want_delta, rtol=1e-5, atol=1e-5)
    assert torch.isinf(got_lse[..., Sq:]).all() and (got_lse[..., Sq:] > 0).all()
    assert (got_delta[..., Sq:] == 0).all()


def _unet_gn_shapes(B, s, ch=(320, 640, 1280, 1280), layers=2, attn=(True, True, True, False)):
    """(B, HW, C, silu) of every GroupNorm of one SD2.1 UNet pass at latent
    side s: resnet norm1/norm2 (SiLU), transformer norms (none), the skip
    concatenations of the up path, conv_norm_out."""
    out, skips, c_prev = [], [ch[0]], ch[0]
    for i, c in enumerate(ch):
        hw = (s >> i) ** 2
        for _ in range(layers):
            out += [(B, hw, c_prev, True), (B, hw, c, True)] + [(B, hw, c, False)] * attn[i]
            c_prev = c
            skips.append(c)
        if i < len(ch) - 1:
            skips.append(c)
    hw = (s >> (len(ch) - 1)) ** 2
    out += [(B, hw, c_prev, True)] * 4 + [(B, hw, c_prev, False)]
    for u, c in enumerate(reversed(ch)):
        level = len(ch) - 1 - u
        hw = (s >> level) ** 2
        for _ in range(layers + 1):
            out += [(B, hw, c_prev + skips.pop(), True), (B, hw, c, True)] + [(B, hw, c, False)] * attn[level]
            c_prev = c
    return out + [(B, s * s, ch[0], True)]


def _vae_gn_shapes(B, res, ch=(128, 256, 512, 512), layers=2, decoder=False):
    """(B, HW, C, silu) of every GroupNorm of the SD VAE encoder at image
    side res, or of its decoder at latent side res."""
    if decoder:
        out, c_prev = [(B, res * res, ch[-1], True)] * 4 + [(B, res * res, ch[-1], False)], ch[-1]
        for i, c in enumerate(reversed(ch)):
            hw = (res << i) ** 2
            for _ in range(layers + 1):
                out += [(B, hw, c_prev, True), (B, hw, c, True)]
                c_prev = c
        return out + [(B, (res << len(ch) - 1) ** 2, ch[0], True)]
    out, c_prev = [], ch[0]
    for i, c in enumerate(ch):
        for _ in range(layers):
            out += [(B, (res >> i) ** 2, c_prev, True), (B, (res >> i) ** 2, c, True)]
            c_prev = c
    hw = (res >> len(ch) - 1) ** 2
    return out + [(B, hw, c_prev, True)] * 4 + [(B, hw, c_prev, False), (B, hw, c_prev, True)]


def test_groupnorm_shape_lists_match_the_model_structure():
    """The enumerations above count what chip_smoke.py's expected launches
    count: 61 GroupNorms per UNet pass, 22 in the VAE encoder, 30 in its
    decoder."""
    assert len(_unet_gn_shapes(4, 64)) == 61
    assert len(_vae_gn_shapes(1, 512)) == 22 and len(_vae_gn_shapes(4, 64, decoder=True)) == 30
    assert {(hw, c) for _, hw, c, _ in _unet_gn_shapes(4, 64)} >= {(4096, 960), (64, 2560), (256, 1920)}


# every GroupNorm shape of 512² generation (UNet at B 4, the source encode
# at B 1, the decode at B 4) and of the 768² train step (UNet and both
# encodes at B 6), then ragged ones, as (B, HW, C, G)
_GN_PLAN_SHAPES = sorted(
    {(B, hw, c, 32) for B, hw, c, _ in _unet_gn_shapes(4, 64) + _vae_gn_shapes(1, 512)
     + _vae_gn_shapes(4, 64, decoder=True) + _unet_gn_shapes(6, 96) + _vae_gn_shapes(6, 768)}
) + [(2, 35, 96, 32), (1, 1, 64, 32), (3, 81, 2560, 32), (1, 9, 8, 1)]


@pytest.mark.parametrize("B,HW,C,G", _GN_PLAN_SHAPES)
def test_groupnorm_launch_plan_covers_every_row_and_channel_once(B, HW, C, G):
    plan = launch_plan(B, HW, C, G)
    cpg, vpr = C // G, plan.set // 8
    # group sets: whole groups, 16-byte row segments, tiling the channels
    assert plan.set % 8 == 0 and plan.set % cpg == 0 and C % plan.set == 0
    # threads: warps, every vector lane of a row segment taken
    assert plan.threads % 32 == 0 and vpr <= plan.threads <= MAX_THREADS
    assert plan.smem == _smem_bytes(plan.path, plan.rows, plan.set, plan.threads, cpg) <= SMEM_MAX
    chunks = -(-HW // plan.rows)
    # row ranges [i * rows, min((i + 1) * rows, HW)) tile [0, HW), none empty
    starts = [i * plan.rows for i in range(chunks)]
    assert starts[-1] < HW <= chunks * plan.rows
    if plan.path == FUSED:
        assert plan.grid == ((C // plan.set) * plan.cluster, B, 1) and plan.scratch == 0
        assert plan.cluster == chunks and 1 <= plan.cluster <= 16
        # the cluster's partials fit where the fold's terms were
        assert plan.cluster * (plan.set // cpg) <= plan.threads // vpr * plan.set
    else:
        assert plan.path == TWO_PASS and plan.cluster == 1
        assert plan.grid == (chunks, C // plan.set, B) and plan.scratch == B * G * chunks * 2
