"""The port's CUDA kernels against their plain PyTorch versions on the card.

These tests need an NVIDIA Hopper GPU and ``nvcc``; elsewhere they skip.
They import nothing of JAX, so they run on a machine that has only torch:

    python -m pytest --noconftest tests/test_torch_port_cuda.py -m gpu -q

(``--noconftest``: ``tests/conftest.py`` imports JAX.)

``chip_smoke.py`` holds the kernels to the main path's shapes; these cases
add the ragged edges the main path never reaches (Sq and Sk that are not
multiples of the tiles, K1/K5 at every pair of 1, 127, 129 and 4097 and with
NaN in the other batch, C with 3 channels per group, tiny rows).
Tolerances are those of ``chip_smoke.py``: for K1 a bf16 rounding step of
the output either way (rtol 2e-2, atol 2e-3) and a relative RMS error of at
most 1e-2 over the whole output; one bf16 rounding of y for K2. K3a/K3b
round P and dS to bf16 before their products, where the plain version keeps
f32: rtol 2e-2 with an atol of 5e-2 times the case's RMS gradient, and a
relative RMS error of at most 1e-2 for each of dq, dk and dv. K6 (int8)
is held to its plain version, which repeats its quantization, at K1's
tolerance through its wrapper, and to its plain core on identical operands
at ``INT8_TOL`` / ``INT8_REL_RMS`` (``chip_smoke.py``'s); K6q to the plain
quantizers with ``check_quantize`` (bitwise but for the order of K's mean);
its straight-through gradients and K5's backward at K3's.
"""

import pytest
import torch

from mvd_tpu_torch.kernels import (
    attention,
    attention_packed,
    attention_packed_bwd_plain,
    attention_packed_int8_plain,
    attention_packed_plain,
    attention_plain,
    flash_attention,
    flash_attention_fwd,
    flash_attention_packed_bwd,
    flash_attention_packed_bwd_dkv,
    flash_attention_packed_bwd_dq,
    flash_attention_packed_fwd,
    flash_attention_packed_int8,
    flash_attention_packed_int8_fwd,
    groupnorm_silu,
    groupnorm_silu_diff,
    groupnorm_silu_plain,
)
from mvd_tpu_torch.kernels import _build, quantize_int8, quantize_int8_plain
from mvd_tpu_torch.kernels.flash_attention import attention_int8_core_plain, launch_int8
from mvd_tpu_torch.kernels.groupnorm_silu import FUSED, TWO_PASS, launch_plan
from mvd_tpu_torch.kernels.measure import INT8_REL_RMS, INT8_TOL, check_attention, check_quantize

pytestmark = pytest.mark.gpu

# K1/K5 tile edges (128 query rows and 128 keys per tile): one row or key,
# one short of and one past a tile, one past 32 tiles; B 2 and 2 heads
EDGE_SIZES = (1, 127, 129, 4097)
EDGES = [(Sq, Sk) for Sq in EDGE_SIZES for Sk in EDGE_SIZES]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.Generator("cuda").manual_seed(0)


@pytest.mark.parametrize(
    "B,Sq,Sk,heads",
    [(2, 200, 77, 2), (1, 130, 300, 3), (3, 1, 1, 1), (1, 65, 129, 4), (4, 4096, 77, 5)]
    + [(2, Sq, Sk, 2) for Sq, Sk in EDGES],
)
def test_flash_kernel_matches_plain(cuda, B, Sq, Sk, heads):
    randn = lambda s: torch.randn(s, generator=cuda, device="cuda").bfloat16()
    q, k, v = randn((B, Sq, heads * 64)), randn((B, Sk, heads * 64)), randn((B, Sk, heads * 64))
    launches, plain = flash_attention_packed_fwd.launches, flash_attention_packed_fwd.plain_calls
    out, lse = flash_attention_packed_fwd(q, k, v, heads)
    torch.cuda.synchronize()
    assert flash_attention_packed_fwd.launches == launches + 1
    assert flash_attention_packed_fwd.plain_calls == plain
    want_out, want_lse = attention_packed_plain(q, k, v, heads)
    assert out.dtype == torch.bfloat16 and lse.dtype == torch.float32
    torch.testing.assert_close(out.float(), want_out.float(), atol=2e-3, rtol=2e-2)
    err_rms = (out.float() - want_out.float()).pow(2).mean().sqrt()
    assert err_rms <= 1e-2 * want_out.float().pow(2).mean().sqrt()
    torch.testing.assert_close(lse, want_lse, atol=2e-3, rtol=1e-4)


# K2 shapes: ragged and tiny ones, then both sides of the switch between the
# fused path (one cluster launch) and the two-pass path (launch_plan)
GN_SHAPES = [((2, 5, 7, 96), 32, True), ((1, 1, 1, 64), 32, False), ((3, 9, 9, 2560), 32, True),
             ((1, 3, 3, 8), 1, True), ((4, 64, 64, 320), 32, True), ((6, 96, 96, 320), 32, True),
             ((6, 96, 96, 960), 32, True), ((2, 256, 256, 128), 32, True)]
GN_PATHS = {(4, 64, 64, 320): FUSED, (6, 96, 96, 320): FUSED, (6, 96, 96, 960): TWO_PASS,
            (2, 256, 256, 128): TWO_PASS}


def _gn_inputs(cuda, shape):
    x = (torch.randn(shape, generator=cuda, device="cuda") * 2 + 0.5).bfloat16()
    C = shape[-1]
    w = 1 + 0.1 * torch.randn(C, generator=cuda, device="cuda")
    b = 0.1 * torch.randn(C, generator=cuda, device="cuda")
    return x, w, b


@pytest.mark.parametrize("shape,groups,silu", GN_SHAPES)
def test_groupnorm_kernel_matches_plain(cuda, shape, groups, silu):
    x, w, b = _gn_inputs(cuda, shape)
    B, H, W, C = shape
    if shape in GN_PATHS:
        assert launch_plan(B, H * W, C, groups).path == GN_PATHS[shape]
    launches = groupnorm_silu.launches
    y = groupnorm_silu(x, w, b, groups, 1e-6, silu)
    torch.cuda.synchronize()
    assert groupnorm_silu.launches == launches + 1
    want = groupnorm_silu_plain(x, w, b, groups, 1e-6, silu)
    torch.testing.assert_close(y.float(), want.float(), atol=1e-2, rtol=1e-2)


@pytest.mark.parametrize("shape", list(GN_PATHS))
def test_groupnorm_kernel_is_repeatable_and_reads_only_its_batch(cuda, shape):
    """On both paths: two calls are bitwise equal (no atomics), and batch
    0's output stays bitwise the same when batch 1 turns to NaN."""
    x, w, b = _gn_inputs(cuda, shape)
    y = groupnorm_silu(x, w, b, 32, 1e-6, True)
    again = groupnorm_silu(x, w, b, 32, 1e-6, True)
    x[1] = float("nan")
    poisoned = groupnorm_silu(x, w, b, 32, 1e-6, True)
    torch.cuda.synchronize()
    assert torch.equal(y, again)
    assert torch.equal(y[0], poisoned[0])
    assert poisoned[1].float().isnan().all()


def test_kernels_reject_what_they_do_not_take(cuda):
    q = torch.zeros(1, 8, 64, device="cuda")
    with pytest.raises(TypeError):
        flash_attention_packed_fwd(q, q, q, 1)  # f32
    with pytest.raises(ValueError):
        flash_attention_packed_fwd(q.bfloat16(), q.bfloat16(), q.bfloat16(), 2)  # head_dim 32
    x = torch.zeros(1, 2, 2, 12, device="cuda", dtype=torch.bfloat16)
    with pytest.raises(ValueError):
        groupnorm_silu(x, torch.ones(12, device="cuda"), torch.zeros(12, device="cuda"), 4)


def _assert_grad_close(got, want, what, rms=None):
    """K3's tolerance: rtol 2e-2, atol 5e-2 x RMS(want), relative RMS error
    at most 1e-2. ``rms`` replaces RMS(want) where the exact gradient is 0
    and ``want`` holds only rounding noise."""
    got, want = got.float(), want.float()
    rms = want.pow(2).mean().sqrt() if rms is None else torch.as_tensor(rms)
    torch.testing.assert_close(got, want, atol=5e-2 * rms.item(), rtol=2e-2, msg=what)
    assert (got - want).pow(2).mean().sqrt() <= 1e-2 * rms, what


@pytest.mark.parametrize(
    "B,Sq,Sk,heads",
    [(2, 200, 77, 2), (1, 130, 300, 3), (1, 144, 144, 4), (3, 1, 1, 1), (1, 65, 129, 4)],
)
def test_flash_bwd_kernels_match_plain(cuda, B, Sq, Sk, heads):
    randn = lambda s: torch.randn(s, generator=cuda, device="cuda").bfloat16()
    q, k, v = randn((B, Sq, heads * 64)), randn((B, Sk, heads * 64)), randn((B, Sk, heads * 64))
    do = randn((B, Sq, heads * 64))
    out, lse = flash_attention_packed_fwd(q, k, v, heads)
    n_dq, n_dkv = flash_attention_packed_bwd_dq.launches, flash_attention_packed_bwd_dkv.launches
    dq, dk, dv = flash_attention_packed_bwd(q, k, v, out, lse, do, heads)
    torch.cuda.synchronize()
    assert flash_attention_packed_bwd_dq.launches == n_dq + 1
    assert flash_attention_packed_bwd_dkv.launches == n_dkv + 1
    want = attention_packed_bwd_plain(q, k, v, out, lse, do, heads)
    for name, g, w, like in zip("dq dk dv".split(), (dq, dk, dv), want, (q, k, v)):
        assert g.dtype == torch.bfloat16 and g.shape == like.shape
        _assert_grad_close(g, w, f"{name} at {(B, Sq, Sk, heads)}")


@pytest.mark.parametrize("B,Sq,Sk,heads", [(2, 200, 77, 3), (2, 4097, 129, 2)])
def test_flash_autograd_matches_plain_autograd(cuda, B, Sq, Sk, heads):
    """K3a/K3b consume K1's (out, lse), also at a ragged Sq."""
    randn = lambda s: torch.randn(s, generator=cuda, device="cuda").bfloat16()
    q, k, v, do = (randn(s) for s in ((B, Sq, heads * 64), (B, Sk, heads * 64),
                                       (B, Sk, heads * 64), (B, Sq, heads * 64)))
    want = torch.autograd.grad(
        attention_packed_plain(*(t.requires_grad_() for t in (q, k, v)), heads)[0], (q, k, v), do
    )
    n_dq, n_dkv = flash_attention_packed_bwd_dq.launches, flash_attention_packed_bwd_dkv.launches
    got = torch.autograd.grad(attention_packed(q, k, v, heads), (q, k, v), do)
    torch.cuda.synchronize()
    assert (flash_attention_packed_bwd_dq.launches, flash_attention_packed_bwd_dkv.launches) == (
        n_dq + 1, n_dkv + 1)
    for name, g, w in zip("dq dk dv".split(), got, want):
        _assert_grad_close(g, w, name)
    # frozen k/v (the text cross-attention): K3a only
    k, v = k.detach(), v.detach()
    (dq,) = torch.autograd.grad(attention_packed(q, k, v, heads), (q,), do)
    torch.cuda.synchronize()
    assert flash_attention_packed_bwd_dkv.launches == n_dkv + 1
    assert flash_attention_packed_bwd_dq.launches == n_dq + 2
    _assert_grad_close(dq, want[0], "dq with frozen k/v")
    # no gradient wanted: the forward kernel alone
    with torch.inference_mode():
        attention_packed(q, k, v, heads)
    assert flash_attention_packed_bwd_dq.launches == n_dq + 2


def test_groupnorm_autograd_matches_plain_autograd(cuda):
    x = (torch.randn((2, 9, 9, 320), generator=cuda, device="cuda") * 2 + 0.5).bfloat16()
    w = 1 + 0.1 * torch.randn(320, generator=cuda, device="cuda")
    b = 0.1 * torch.randn(320, generator=cuda, device="cuda")
    dy = torch.randn(x.shape, generator=cuda, device="cuda").bfloat16()
    args = (32, 1e-6, True)
    launches, plain = groupnorm_silu.launches, groupnorm_silu.plain_calls
    leaves = [t.clone().requires_grad_() for t in (x, w, b)]
    got = torch.autograd.grad(groupnorm_silu_diff(*leaves, *args), leaves, dy)
    torch.cuda.synchronize()
    assert (groupnorm_silu.launches, groupnorm_silu.plain_calls) == (launches + 1, plain)
    leaves = [t.clone().requires_grad_() for t in (x, w, b)]
    want = torch.autograd.grad(groupnorm_silu_plain(*leaves, *args), leaves, dy)
    for g, w_ in zip(got, want):  # the backward recomputes the plain version
        torch.testing.assert_close(g, w_)


def test_bwd_kernels_reject_what_they_do_not_take(cuda):
    q = torch.zeros(1, 8, 128, device="cuda", dtype=torch.bfloat16)
    lse = torch.zeros(1, 8, 2, device="cuda")
    with pytest.raises(TypeError):
        flash_attention_packed_bwd_dq(q.float(), q, q, q, lse, lse, 2)  # f32
    with pytest.raises(ValueError):
        flash_attention_packed_bwd_dkv(q, q, q, q, lse, lse, 4)  # head_dim 32
    wide = torch.zeros(1, 8, 256, device="cuda", dtype=torch.bfloat16)[..., ::2]
    with pytest.raises(ValueError):
        flash_attention_packed_bwd_dq(wide, q, q, q, lse, lse, 2)  # not contiguous
    with pytest.raises(ValueError):
        flash_attention_packed_bwd_dkv(q, q, q, wide, lse, lse, 2)  # dO not contiguous
    with pytest.raises(ValueError):
        flash_attention_packed_bwd_dq(q, q, q, q, lse[..., :1], lse, 2)  # lse shape


def _assert_out_close(out, want, lse, want_lse, what):
    """K1's tolerance: out atol 2e-3 + rtol 2e-2 and relative RMS error at
    most 1e-2; lse atol 2e-3 + rtol 1e-4."""
    torch.testing.assert_close(out.float(), want.float(), atol=2e-3, rtol=2e-2, msg=what)
    err_rms = (out.float() - want.float()).pow(2).mean().sqrt()
    assert err_rms <= 1e-2 * want.float().pow(2).mean().sqrt(), what
    torch.testing.assert_close(lse, want_lse, atol=2e-3, rtol=1e-4, msg=what)


@pytest.mark.parametrize(
    "B,Sq,Sk,heads,block_k,k_mean",
    [(4, 4096, 4096, 5, 1024, 0.0), (4, 1024, 1024, 10, 1024, 0.0), (1, 256, 384, 2, 128, 0.7),
     (2, 128, 2048, 1, 1024, 0.7), (1, 256, 384, 2, 64, 0.7)],
)
def test_int8_kernel_matches_plain(cuda, B, Sq, Sk, heads, block_k, k_mean):
    randn = lambda s: torch.randn(s, generator=cuda, device="cuda")
    q, v = randn((B, Sq, heads * 64)).bfloat16(), randn((B, Sk, heads * 64)).bfloat16()
    k = (randn((B, Sk, heads * 64)) + k_mean).bfloat16()
    launches, plain = flash_attention_packed_int8_fwd.launches, flash_attention_packed_int8_fwd.plain_calls
    out, lse = flash_attention_packed_int8_fwd(q, k, v, heads, block_k=block_k)
    torch.cuda.synchronize()
    assert flash_attention_packed_int8_fwd.launches == launches + 1
    assert flash_attention_packed_int8_fwd.plain_calls == plain
    assert out.dtype == torch.bfloat16 and lse.shape == (B, Sq, heads)
    want_out, want_lse = attention_packed_int8_plain(q, k, v, heads, block_k=block_k)
    _assert_out_close(out, want_out, lse, want_lse, f"K6 at {(B, Sq, Sk, heads, block_k)}")
    exact = attention_packed_plain(q, k, v, heads)[0].float()
    snr = 10 * torch.log10(exact.pow(2).mean() / (out.float() - exact).pow(2).mean())
    assert snr >= 30, f"int8 vs exact {snr.item():.1f} dB"


def _int8_inputs(gen, B, Sq, Sk, heads, k_mean=0.0):
    randn = lambda s: torch.randn(s, generator=gen, device="cuda")
    q, v = randn((B, Sq, heads * 64)).bfloat16(), randn((B, Sk, heads * 64)).bfloat16()
    return q, (randn((B, Sk, heads * 64)) + k_mean).bfloat16(), v


@pytest.mark.parametrize(
    "B,Sq,Sk,heads,block_k",
    [(4, 4096, 4096, 5, 1024), (4, 1024, 1024, 10, 1024), (1, 128, 128, 2, 1024),
     (2, 256, 384, 2, 128), (2, 128, 2048, 1, 1024), (2, 256, 384, 2, 64), (1, 128, 768, 2, 192)],
)
def test_int8_kernel_matches_plain_core(cuda, B, Sq, Sk, heads, block_k):
    """K6 alone against its plain core on identical operands (K6q's), at the
    two int8 sites, one group (Sk 128), groups of 128 with Sq != Sk and B 2,
    two groups with Sq != Sk, and groups of 64 and 192 keys (each ending in
    a half tile)."""
    ops = quantize_int8(*_int8_inputs(cuda, B, Sq, Sk, heads, 0.7), heads)
    out, lse = launch_int8(ops, heads, block_k=block_k)
    torch.cuda.synchronize()
    want_out, want_lse = attention_int8_core_plain(ops, heads, block_k=block_k)
    check_attention(out, lse, want_out, want_lse, f"K6 at {(B, Sq, Sk, heads, block_k)}",
                    INT8_TOL, INT8_REL_RMS)


@pytest.mark.parametrize(
    "B,Sq,Sk,heads,k_mean",
    [(4, 4096, 4096, 5, 0.0), (4, 1024, 1024, 10, 0.7), (2, 256, 640, 2, 0.7), (1, 128, 128, 1, -3.0)],
)
def test_quantize_kernel_matches_plain(cuda, B, Sq, Sk, heads, k_mean):
    """K6q against the plain quantizers: q8, sq, v8t and sv bitwise; sk and
    k8 within what the order of K's mean allows (``check_quantize``). Ties
    and zero rows, heads and channels included."""
    q, k, v = _int8_inputs(cuda, B, Sq, Sk, heads, k_mean)
    q[0, 3] = 0  # a zero token: its scales at the 1e-6 floor
    q[0, 4, :64] = torch.arange(64, device="cuda") % 8 + 0.5  # ...
    q[0, 4, 0] = 127  # ... under a scale of 1: halves, ties to even
    k[-1, :, :64] = 0.25  # a constant head: k - mean = 0
    v[:, :, 7] = 0  # a zero channel
    v[0, :, 9] = torch.where(torch.arange(Sk, device="cuda") % 2 == 1, 127.0, 0.5)  # ties
    launches = quantize_int8.launches
    got = quantize_int8(q, k, v, heads)
    torch.cuda.synchronize()
    assert quantize_int8.launches == launches + 1
    want = quantize_int8_plain(q, k, v, heads)
    assert [t.dtype for t in got] == [t.dtype for t in want]
    check_quantize(got, want, f"K6q at {(B, Sq, Sk, heads)}")


def test_int8_kernels_are_repeatable_and_read_only_their_batch(cuda):
    """K6q and K6: two launches bitwise equal, and batch 0's results bitwise
    unchanged when batch 1's inputs turn to NaN."""
    B, Sq, Sk, heads = 2, 256, 1024, 2
    q, k, v = _int8_inputs(cuda, B, Sq, Sk, heads, 0.7)
    ops, again = quantize_int8(q, k, v, heads), quantize_int8(q, k, v, heads)
    out, lse = launch_int8(ops, heads)
    out2, lse2 = launch_int8(again, heads)
    q[1], k[1], v[1] = float("nan"), float("nan"), float("nan")
    poisoned = quantize_int8(q, k, v, heads)
    out3, lse3 = launch_int8(poisoned, heads)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(ops, again))
    assert torch.equal(out, out2) and torch.equal(lse, lse2)
    assert all(torch.equal(a[0], b[0]) for a, b in zip(ops, poisoned))
    assert torch.equal(out[0], out3[0]) and torch.equal(lse[0], lse3[0])
    assert poisoned[3][1].isnan().all() and out3[1].float().isnan().any()  # batch 1 read its NaN


def test_int8_autograd_matches_plain(cuda):
    """The straight-through gradient: K3a/K3b at K6's (out, lse)."""
    B, S, heads = 2, 1024, 2
    randn = lambda s: torch.randn(s, generator=cuda, device="cuda").bfloat16()
    q, k, v, do = (randn((B, S, heads * 64)) for _ in range(4))
    out8, lse8 = attention_packed_int8_plain(q, k, v, heads)
    want = attention_packed_bwd_plain(q, k, v, out8, lse8, do, heads)
    n = (flash_attention_packed_int8_fwd.launches, flash_attention_packed_bwd_dq.launches,
         flash_attention_packed_bwd_dkv.launches)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    got = torch.autograd.grad(flash_attention_packed_int8(*leaves, heads), leaves, do)
    torch.cuda.synchronize()
    assert (flash_attention_packed_int8_fwd.launches, flash_attention_packed_bwd_dq.launches,
            flash_attention_packed_bwd_dkv.launches) == (n[0] + 1, n[1] + 1, n[2] + 1)
    for name, g, w in zip("dq dk dv".split(), got, want):
        _assert_grad_close(g, w, f"int8 straight-through {name}")


def test_int8_routing_on_the_card(cuda):
    """impl="int8" runs K6 only where the JAX package quantizes; text sites
    (Sk = 77) and short sequences run K1."""
    randn = lambda s: torch.randn(s, generator=cuda, device="cuda").bfloat16()
    q, kv, text = randn((1, 1024, 128)), randn((1, 1024, 128)), randn((1, 77, 128))
    n8, n1 = flash_attention_packed_int8_fwd.launches, flash_attention_packed_fwd.launches
    attention_packed(q, kv, kv, 2, impl="int8")
    attention_packed(q, text, text, 2, impl="int8")
    attention_packed(q[:, :256], kv[:, :256], kv[:, :256], 2, impl="int8")
    assert (flash_attention_packed_int8_fwd.launches, flash_attention_packed_fwd.launches) == (
        n8 + 1, n1 + 2)


@pytest.mark.parametrize(
    "B,heads,Sq,Sk", [(2, 3, 200, 77), (1, 2, 130, 300), (3, 1, 1, 1), (4, 5, 4096, 77)]
    + [(2, 2, Sq, Sk) for Sq, Sk in EDGES],
)
def test_k5_matches_plain(cuda, B, heads, Sq, Sk):
    randn = lambda s: torch.randn(s, generator=cuda, device="cuda").bfloat16()
    q, k, v, do = randn((B, heads, Sq, 64)), randn((B, heads, Sk, 64)), randn((B, heads, Sk, 64)), randn((B, heads, Sq, 64))
    n5, n1 = flash_attention_fwd.launches, flash_attention_packed_fwd.launches
    out, lse = flash_attention_fwd(q, k, v)
    torch.cuda.synchronize()
    assert (flash_attention_fwd.launches, flash_attention_packed_fwd.launches) == (n5 + 1, n1)
    assert lse.shape == (B, heads, Sq)
    want_out, want_lse = attention_plain(q, k, v)
    _assert_out_close(out, want_out, lse, want_lse, f"K5 at {(B, heads, Sq, Sk)}")
    want = attention_packed_bwd_plain(q, k, v, out, lse, do, heads, layout="bhsd")
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    n_dq, n_dkv = flash_attention_packed_bwd_dq.launches, flash_attention_packed_bwd_dkv.launches
    got = torch.autograd.grad(flash_attention(*leaves), leaves, do)
    torch.cuda.synchronize()
    assert (flash_attention_packed_bwd_dq.launches, flash_attention_packed_bwd_dkv.launches) == (
        n_dq + 1, n_dkv + 1)
    # With one key, O = V and dS = P (dO V^T - rowsum(dO O)) is exactly 0, so
    # dq and dk are rounding noise in both versions: hold them to the size
    # of their terms instead, RMS(dO V^T) RMS(K or Q) / sqrt(D), times
    # sqrt(Sq) for dk's sum over the rows.
    scale = {}
    if Sk == 1:
        dp = (do.float() * v.float()).sum(-1).pow(2).mean().sqrt() / 8
        scale = {"dq": dp * k.float().pow(2).mean().sqrt(),
                 "dk": dp * q.float().pow(2).mean().sqrt() * Sq**0.5}
    for name, g, w, like in zip("dq dk dv".split(), got, want, (q, k, v)):
        assert g.dtype == torch.bfloat16 and g.shape == like.shape
        _assert_grad_close(g, w, f"K5 backward {name} at {(B, heads, Sq, Sk)}", rms=scale.get(name))
    for impl in ("auto", "pallas", "xla"):  # every impl runs K5 on the card
        torch.testing.assert_close(attention(q, k, v, impl), out, atol=0, rtol=0)


@pytest.mark.parametrize("layout", ["packed", "bhsd"])
def test_flash_kernel_reads_only_its_batch(cuda, layout):
    """Batch 0's out and lse stay bitwise the same when batch 1's K and V
    turn to NaN: the ragged tail tiles (Sq 4097, Sk 129) read no row of
    the next batch."""
    B, heads, Sq, Sk = 2, 2, 4097, 129
    shape = (lambda S: (B, heads, S, 64)) if layout == "bhsd" else (lambda S: (B, S, heads * 64))
    q, k, v = (torch.randn(shape(S), generator=cuda, device="cuda").bfloat16() for S in (Sq, Sk, Sk))
    fwd = flash_attention_fwd if layout == "bhsd" else (lambda q, k, v: flash_attention_packed_fwd(q, k, v, heads))
    out, lse = fwd(q, k, v)
    k[1], v[1] = float("nan"), float("nan")
    out2, lse2 = fwd(q, k, v)
    torch.cuda.synchronize()
    assert torch.equal(out[0], out2[0]) and torch.equal(lse[0], lse2[0])
    assert out2[1].float().isnan().any()  # batch 1 did read its own NaN


def test_k6_and_k5_reject_what_they_do_not_take(cuda):
    q = torch.zeros(1, 1024, 128, device="cuda", dtype=torch.bfloat16)
    with pytest.raises(ValueError):
        flash_attention_packed_int8_fwd(q[:, :200], q, q, 2)  # Sq does not tile
    with pytest.raises(ValueError):
        flash_attention_packed_int8_fwd(q, q[:, :77], q[:, :77], 2)  # Sk does not tile
    with pytest.raises(ValueError):
        flash_attention_packed_int8_fwd(q, q, q, 4)  # head_dim 32
    with pytest.raises(TypeError):
        flash_attention_packed_int8_fwd(q.float(), q.float(), q.float(), 2)  # f32
    with pytest.raises(ValueError):
        flash_attention_packed_int8_fwd(q, q, q, 2, block_k=32)  # key groups of 32
    with pytest.raises(ValueError):
        quantize_int8(q[:, :200], q, q, 2)  # Sq not whole 128-row tiles
    x = torch.zeros(1, 2, 8, 64, device="cuda", dtype=torch.bfloat16)
    with pytest.raises(TypeError):
        flash_attention_fwd(x.float(), x.float(), x.float())
    with pytest.raises(ValueError):
        flash_attention_fwd(x[..., :32].contiguous(), x[..., :32].contiguous(), x[..., :32].contiguous())
    with pytest.raises(ValueError):
        attention(x, x, x, "pallas_interpret")


def _pipeline_64(**changes):
    """TINY_MODEL with 64-wide heads (what the kernels take) in bf16, on the
    card, random weights from seed 0."""
    import dataclasses

    from mvd_tpu_torch.config import TINY_MODEL, TINY_UNET
    from mvd_tpu_torch.pipeline import MVDPipeline

    unet = dataclasses.replace(TINY_UNET, block_out_channels=(64, 128, 128, 128),
                               num_attention_heads=(1, 2, 2, 2))
    cfg = dataclasses.replace(TINY_MODEL, unet=unet, dtype="bfloat16", **changes)
    return MVDPipeline.create(cfg, seed=0, device="cuda")


@pytest.mark.parametrize("sampler,encoder_reuse", [("ddpm", 1), ("ddim", 1), ("dpmpp_2m", 1), ("ddpm", 2)])
def test_denoise_loop_never_waits_for_the_device(cuda, sampler, encoder_reuse):
    """The sampler loop (3 denoise + sampler-step iterations of a 20-step
    schedule, after prepare_conditioning) at tiny width with 64-wide heads
    in bf16 makes no call that synchronizes with the device, for every
    sampler and with encoder reuse (a key step, a cached step, a step past
    the last group): the timesteps and the step noise reach the device
    before the loop, and the steps index the schedule with Python ints."""
    from mvd_tpu_torch.camera import orbit_cameras

    pipe = _pipeline_64()
    model = pipe.compute_model
    B, s = 2, pipe.config.unet.sample_size
    with torch.inference_mode():
        embeds = model["text_encoder"](pipe._ids(["a 3d object"] * B, 1))
        cams = torch.as_tensor(orbit_cameras(B), device="cuda")
        src = torch.randn((B, s, s, 4), generator=cuda, device="cuda")
        film, refs = model["mvd"].prepare_conditioning(embeds, cams[:1].expand(B, 4, 4), cams, src,
                                                       cfg_batch=B, precompute_kv=True)
        lat = torch.randn((B, s, s, 4), generator=cuda, device="cuda")
        noises = torch.randn((3, B, s, s, 4), generator=cuda, device="cuda")
        steps = pipe.timesteps(20)[:3]
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            out = pipe.denoise_loop(model, lat, steps, embeds, film, refs, 1.0, 1.0, 20, noises,
                                    sampler=sampler, encoder_reuse=encoder_reuse)
        finally:
            torch.cuda.set_sync_debug_mode(0)
    assert out.shape == lat.shape and torch.isfinite(out).all()


def test_checkpoint_loader_puts_every_parameter_on_the_device(cuda, tmp_path):
    """A Lightning checkpoint of one pipeline's multi-view UNet, loaded by
    ``load_checkpoint`` into another pipeline on the card, leaves every
    parameter there, in f32 and equal to the first pipeline's, but the
    translation projection the reference does not store."""
    import numpy as np

    from mvd_tpu_torch.checkpoint import export_jax_params, export_lightning_state_dict, load_checkpoint

    src, dst = _pipeline_64(), _pipeline_64()
    with torch.no_grad():
        for p in src.model["mvd"].parameters():
            p.add_(1.0)
    sd = export_lightning_state_dict(export_jax_params(src.model["mvd"]))
    path = tmp_path / "last.ckpt"
    torch.save({"state_dict": {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in sd.items()}}, path)
    kept, _ = load_checkpoint(dst, str(path))
    assert kept == ["mvd.camera_encoder.translation_projection"]
    want = dict(src.model.named_parameters())
    for name, p in dst.model.named_parameters():
        assert p.device.type == "cuda" and p.dtype == torch.float32, name
        if not name.endswith("translation_projection") and name.startswith("mvd."):
            assert torch.equal(p, want[name]), name
    assert dst.compute_model["mvd"].unet.conv_in.weight.device.type == "cuda"


def test_every_launch_runs_on_the_tensors_device(cuda, monkeypatch):
    """Each kernel wrapper enters _build.on_device with the device of the
    tensors it launches on, around its C call."""
    seen = []
    real = _build.on_device

    def record(t):
        seen.append(t.device)
        return real(t)

    monkeypatch.setattr(_build, "on_device", record)
    randn = lambda *s: torch.randn(s, generator=cuda, device="cuda").bfloat16()
    q, k, v, do = randn(1, 1024, 128), randn(1, 1024, 128), randn(1, 1024, 128), randn(1, 1024, 128)
    out, lse = flash_attention_packed_fwd(q, k, v, 2)  # K1
    flash_attention_fwd(randn(1, 2, 64, 64), randn(1, 2, 64, 64), randn(1, 2, 64, 64))  # K5
    flash_attention_packed_bwd(q, k, v, out, lse, do, 2)  # K3a, K3b
    flash_attention_packed_int8_fwd(q, k, v, 2)  # K6q, K6
    x = randn(2, 8, 8, 64)
    groupnorm_silu(x, torch.ones(64, device="cuda"), torch.zeros(64, device="cuda"), 32)  # K2
    torch.cuda.synchronize()
    assert seen == [q.device] * 7


def test_ssim_stays_f32_under_global_tf32(cuda):
    """With TF32 on for the whole process, SSIM on the card still equals the
    CPU's f32 value: its filter turns TF32 off for its own convolution. The
    images sit near 0.8 with a spread of 0.01, where E[x²] - μ² cancels to
    1e-4 and a TF32 convolution's error (about 5e-4 of 0.64) would swamp it."""
    from mvd_tpu_torch.metrics.image import ssim

    a = 0.8 + 0.01 * torch.randn((2, 64, 64, 3), generator=cuda, device="cuda")
    b = a + 0.003 * torch.randn((2, 64, 64, 3), generator=cuda, device="cuda")
    saved = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = True
    try:
        got = ssim(a, b, data_range=1.0, per_image=True)
        assert torch.backends.cudnn.allow_tf32
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved
    want = ssim(a.cpu(), b.cpu(), data_range=1.0, per_image=True)
    torch.testing.assert_close(got.cpu(), want, rtol=1e-4, atol=0)


def test_metric_towers_stay_f32_under_global_tf32(cuda):
    """With TF32 on for the whole process, the VGG16 perceptual loss and the
    CLIP image score on the card equal their f32 values on the CPU to
    relative 1e-4: each tower turns TF32 off for its own convolutions and
    matmuls (a TF32 product's error, about 1e-3 relative, would show)."""
    from mvd_tpu_torch.metrics.towers import (CLIPImageScore, CLIPVisionEncoder, PerceptualLoss,
                                              VGG16Features)

    torch.manual_seed(0)
    vgg = VGG16Features()
    for m in vgg.modules():
        if isinstance(m, torch.nn.Conv2d):
            torch.nn.init.kaiming_normal_(m.weight)
    clip = CLIPVisionEncoder(hidden_size=128, num_layers=2, num_heads=2, intermediate_size=256,
                             projection_dim=96)
    with torch.no_grad():
        clip.class_embedding.normal_()
        clip.position_embedding.normal_(std=0.1)
    towers = PerceptualLoss(vgg.eval().cuda()), CLIPImageScore(clip.eval().cuda())
    a, b = (torch.rand((2, 64, 64, 3), generator=cuda, device="cuda") for _ in range(2))
    saved = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = True
    try:
        got = [towers[0](a * 2 - 1, b * 2 - 1), towers[1](a, b)]
        assert torch.backends.cudnn.allow_tf32 and torch.backends.cuda.matmul.allow_tf32
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved
    a, b = a.cpu(), b.cpu()  # the towers follow their images to the CPU
    want = [towers[0](a * 2 - 1, b * 2 - 1), towers[1](a, b)]
    for g, w in zip(got, want):
        assert g.device.type == "cuda"
        torch.testing.assert_close(g.cpu(), w, rtol=1e-4, atol=0)


# ------------------------------------------------- joint multi-view lengths

JOINT_GEN, JOINT_TRAIN = 4 * 64 * 64, 2 * 96 * 96  # merged self-attention lengths


def test_flash_kernel_at_the_joint_generation_length(cuda):
    """K1 at the 4-view 512² self site (one group of 16,384 tokens, 5
    heads) against its plain version; batch 0 bitwise unchanged when batch
    1's K/V turn to NaN at that length."""
    randn = lambda s: torch.randn(s, generator=cuda, device="cuda").bfloat16()
    q, k, v = (randn((1, JOINT_GEN, 320)) for _ in range(3))
    out, lse = flash_attention_packed_fwd(q, k, v, 5)
    torch.cuda.synchronize()
    want, want_lse = attention_packed_plain(q, k, v, 5)
    _assert_out_close(out, want, lse, want_lse, f"K1 at S {JOINT_GEN}")
    del want, want_lse
    q2, k2, v2 = (torch.cat([t, randn(t.shape)]) for t in (q, k, v))
    out2, lse2 = flash_attention_packed_fwd(q2, k2, v2, 5)
    k2[1], v2[1] = float("nan"), float("nan")
    out3, lse3 = flash_attention_packed_fwd(q2, k2, v2, 5)
    torch.cuda.synchronize()
    assert torch.equal(out2[0], out3[0]) and torch.equal(lse2[0], lse3[0])
    assert torch.equal(out2[0], out[0]) and torch.equal(lse2[0], lse[0])


def test_flash_bwd_kernels_at_the_joint_train_length(cuda):
    """K3a/K3b at the 2-view 768² self length (18,432 tokens, 2 heads, one
    row) against the plain backward, head by head."""
    from mvd_tpu_torch.kernels.measure import plain_bwd_by_row

    randn = lambda s: torch.randn(s, generator=cuda, device="cuda").bfloat16()
    q, k, v, do = (randn((1, JOINT_TRAIN, 128)) for _ in range(4))
    out, lse = flash_attention_packed_fwd(q, k, v, 2)
    got = flash_attention_packed_bwd(q, k, v, out, lse, do, 2)
    torch.cuda.synchronize()
    want = plain_bwd_by_row(q, k, v, out, lse, do, 2, by_head=True)
    for name, g, w in zip("dq dk dv".split(), got, want):
        _assert_grad_close(g, w, f"{name} at S {JOINT_TRAIN}")


def test_remat_train_step_launches_the_flash_kernels_as_without(cuda):
    """A full-width joint train step (2 views, 256²) with remat launches K1,
    K3a and K3b exactly as often as without it, and K2 once more for every
    GroupNorm of a remat'd block; its loss is bitwise the same."""
    import dataclasses

    import numpy as np

    from mvd_tpu_torch.camera import orbit_cameras
    from mvd_tpu_torch.config import ModelConfig, TrainConfig, UNetConfig
    from mvd_tpu_torch.kernels import KERNELS
    from mvd_tpu_torch.nn.layers import GroupNorm, ResnetBlock, Transformer2D
    from mvd_tpu_torch.pipeline.pipeline import build_model, build_schedule, init_weights
    from mvd_tpu_torch.train import TrainState, make_train_step

    mcfg = ModelConfig(unet=UNetConfig(sample_size=32, num_views=2), dtype="bfloat16")
    with torch.device("cuda"):
        model = build_model(mcfg)
    init_weights(model, torch.Generator("cuda").manual_seed(0))
    cfg = TrainConfig(model=mcfg)
    state = TrainState.create(model, cfg, 10)
    step = make_train_step(build_schedule(mcfg).to("cuda"), cfg)
    img = lambda: torch.rand((1, 2, 256, 256, 3), generator=cuda, device="cuda") * 2 - 1
    cams = torch.as_tensor(orbit_cameras(2), device="cuda")
    batch = {"source_image": img(), "target_image": img(),
             "source_camera": cams[:1].expand(2, 4, 4).reshape(1, 2, 4, 4).contiguous(),
             "target_camera": cams.reshape(1, 2, 4, 4),
             "input_ids": torch.as_tensor(np.zeros((1, 2, 77), np.int64), device="cuda")}
    unet = model["mvd"].unet
    runs = []
    for remat in (True, False):
        unet.cfg = dataclasses.replace(unet.cfg, remat=remat)
        before = {k: f.launches for k, f in KERNELS.items()}
        m = step(state, batch, generator=torch.Generator("cuda").manual_seed(1))
        torch.cuda.synchronize()
        runs.append(({k: f.launches - before[k] for k, f in KERNELS.items()}, m["noise_loss"]))
    (on, loss_on), (off, loss_off) = runs
    gn = sum(isinstance(g, GroupNorm) for b in unet.modules()
             if isinstance(b, (ResnetBlock, Transformer2D)) for g in b.modules())
    assert on == {**off, "groupnorm_silu": off["groupnorm_silu"] + gn} and off["flash_attn_fwd"] > 0
    assert torch.equal(loss_on, loss_off)


def test_kept_conv_gradients_are_the_convs_on_the_card(cuda):
    """A ResnetBlock computing in bf16 on the card (f32 parameters, every
    one trained), under a checkpoint whose tape keeps its conv outputs:
    input and parameter gradients bitwise those without the checkpoint (the
    kept conv's backward is cuDNN's as autograd calls it)."""
    from mvd_tpu_torch.nn import unet as tunet
    from mvd_tpu_torch.nn.layers import ResnetBlock, set_compute_dtype

    torch.manual_seed(0)
    block = set_compute_dtype(ResnetBlock(64, 128, norm_num_groups=32, temb_dim=32).cuda(), torch.bfloat16)
    x = torch.randn((2, 64, 24, 24), generator=cuda, device="cuda").bfloat16()
    x = x.contiguous(memory_format=torch.channels_last).requires_grad_()
    temb = torch.randn((2, 32), generator=cuda, device="cuda").bfloat16()
    g = torch.randn((2, 128, 24, 24), generator=cuda, device="cuda").bfloat16()
    wrt = [x, *block.parameters()]
    plain = torch.autograd.grad(block(x, temb), wrt, g)
    kept = torch.autograd.grad(tunet._remat(block, tunet.remat_context("flash_conv"), x, temb), wrt, g)
    assert all(torch.equal(a, b) for a, b in zip(plain, kept))


# ------------------------------------------------------- ring attention (K4)


@pytest.mark.parametrize("B,S,heads,D", [(2, 300, 3, 64), (1, 1, 1, 64), (3, 17, 2, 128), (1, 5, 4, 4)])
def test_ring_merge_kernel_matches_plain(cuda, B, S, heads, D):
    """K4m against ``ring_merge_plain`` within MERGE_ULPS ulp of the terms'
    magnitude, at ragged sizes and the head widths it takes; batch 0
    bitwise unchanged by NaN in batch 1; two launches bitwise equal."""
    from mvd_tpu_torch.kernels import ring_merge, ring_merge_plain
    from mvd_tpu_torch.kernels.measure import MERGE_ULPS

    o = torch.randn(B, S, heads * D, generator=cuda, device="cuda")
    o_i = torch.randn(B, S, heads * D, generator=cuda, device="cuda").bfloat16()
    lse, lse_i = (torch.randn(B, S, heads, generator=cuda, device="cuda") * 3 for _ in range(2))
    got_o, got_l = o.clone(), lse.clone()
    ring_merge(got_o, got_l, o_i, lse_i, heads)
    want_o, want_l = o.clone(), lse.clone()
    ring_merge_plain(want_o, want_l, o_i, lse_i, heads)
    m = torch.maximum(lse, lse_i)
    w, w_i = torch.exp(lse - m), torch.exp(lse_i - m)
    split = lambda t: t.view(B, S, heads, D)
    scale = (split(o).abs() * w[..., None] + split(o_i.float()).abs() * w_i[..., None]) / (w + w_i)[..., None]
    ulp = MERGE_ULPS * 2.0 ** -24
    assert ((split(got_o) - split(want_o)).abs() <= ulp * scale).all()
    assert ((got_l - want_l).abs() <= ulp * (m.abs() + torch.log(w + w_i).abs())).all()
    again_o, again_l = o.clone(), lse.clone()
    ring_merge(again_o, again_l, o_i, lse_i, heads)
    assert torch.equal(again_o, got_o) and torch.equal(again_l, got_l)
    if B > 1:
        o[1], lse[1] = float("nan"), float("nan")
        ring_merge(o, lse, o_i, lse_i, heads)
        assert torch.equal(o[0], got_o[0]) and torch.equal(lse[0], got_l[0])


def test_ring_merge_rejects_what_it_does_not_take(cuda):
    from mvd_tpu_torch.kernels import ring_merge

    o, lse = torch.zeros(1, 4, 128, device="cuda"), torch.zeros(1, 4, 2, device="cuda")
    o_i = torch.zeros(1, 4, 128, device="cuda", dtype=torch.bfloat16)
    for bad in (dict(o_i=o_i.float()), dict(o=o.bfloat16()), dict(lse=lse[:, :3]),
                dict(o=o[:, :, :96].contiguous(), o_i=o_i[:, :, :96].contiguous(), heads=2)):
        args = {**dict(o=o, lse=lse, o_i=o_i, lse_i=lse, heads=2), **bad}
        with pytest.raises(ValueError):
            ring_merge(args["o"], args["lse"], args["o_i"], args["lse_i"], args["heads"])


@pytest.mark.parametrize("n,B,S,heads", [(2, 2, 256, 2), (4, 1, 200, 3), (8, 1, 129, 1)])
def test_virtual_ring_matches_the_unsharded_kernels(cuda, n, B, S, heads):
    """The ring of n virtual ranks (K1 and K4m forward, K3a/K3b backward)
    against the unsharded K1 and K3a/K3b at the whole length n*S, with the
    launches of a ring: K1 n², K4m n(n - 1), K3a and K3b n² each."""
    from mvd_tpu_torch.kernels import ring_attention_virtual_bwd, ring_attention_virtual_fwd, ring_merge

    randn = lambda s: torch.randn(s, generator=cuda, device="cuda").bfloat16()
    q, k, v, do = (randn((B, n * S, heads * 64)) for _ in range(4))
    split = lambda t: [c.contiguous() for c in t.split(S, dim=1)]
    counts = lambda: (flash_attention_packed_fwd.launches, ring_merge.launches,
                      flash_attention_packed_bwd_dq.launches, flash_attention_packed_bwd_dkv.launches)
    before = counts()
    outs, lses = ring_attention_virtual_fwd(*map(split, (q, k, v)), heads)
    grads = ring_attention_virtual_bwd(*map(split, (q, k, v)), outs, lses, split(do), heads)
    torch.cuda.synchronize()
    assert [a - b for a, b in zip(counts(), before)] == [n * n, n * (n - 1), n * n, n * n]
    out, lse = flash_attention_packed_fwd(q, k, v, heads)
    check_attention(torch.cat(outs, 1), torch.cat(lses, 1), out, lse, f"ring of {n}")
    want = flash_attention_packed_bwd(q, k, v, out, lse, do, heads)
    for name, g, w in zip("dq dk dv".split(), grads, want):
        _assert_grad_close(torch.cat(g, 1), w, f"ring of {n} {name}")


@pytest.mark.parametrize("n", [2, 4])
def test_model_sharded_attention_launches_k1_per_shard(cuda, n):
    """An ``Attention`` cut over n virtual model ranks
    (``shard_params_model_parallel``) on CUDA tensors: K1 once per shard on
    the shard's heads, no plain call, the output within a relative RMS
    error of 1e-2 of the whole layer's (the row-parallel sum rounds its
    partial products to bf16)."""
    import copy

    from mvd_tpu_torch.nn.layers import Attention
    from mvd_tpu_torch.parallel import shard_params_model_parallel
    from mvd_tpu_torch.tensor_parallel import virtual_model_axis

    torch.manual_seed(0)
    attn = Attention(256, 4, 64, context_dim=128).cuda().bfloat16()
    x = torch.randn((2, 300, 256), generator=cuda, device="cuda").bfloat16()
    ctx = torch.randn((2, 77, 128), generator=cuda, device="cuda").bfloat16()
    with torch.no_grad():
        want = attn(x, ctx).float()
        sharded = shard_params_model_parallel(copy.deepcopy(attn), virtual_model_axis(n), min_dim=256)
        launches, plain = flash_attention_packed_fwd.launches, flash_attention_packed_fwd.plain_calls
        got = sharded(x, ctx).float()
        torch.cuda.synchronize()
    assert flash_attention_packed_fwd.launches == launches + n
    assert flash_attention_packed_fwd.plain_calls == plain
    assert (got - want).pow(2).mean().sqrt() <= 1e-2 * want.pow(2).mean().sqrt()
