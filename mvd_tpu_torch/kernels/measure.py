"""The H100's peak rates, the least times they give a kernel, and the cases,
checks and timer that ``chip_smoke.py`` and ``python -m
mvd_tpu_torch.cli.bench_flash_fwd`` / ``bench_flash_bwd`` /
``bench_groupnorm`` / ``bench_flash_int8`` share.

Nothing here runs at import; ``torch`` and ``nvidia-smi`` are reached only
inside the functions.
"""

from __future__ import annotations

import subprocess

# H100 SXM peak rates
HBM_BYTES_PER_S = 3.35e12
BF16_TENSOR_FLOPS = 989e12
F32_FLOPS = 67e12
INT8_TENSOR_OPS = 1979e12
SMS, EX2_PER_CLOCK_PER_SM = 132, 16  # MUFU.EX2 results per clock per SM
D = 64  # head width of every attention site

# (label, B, Sq, Sk, heads): every K1 site of the 512² main path, D = 64
ATTN_CASES = [
    ("self 64x64", 4, 4096, 4096, 5),
    ("text 64x64", 4, 4096, 77, 5),
    ("self 32x32", 4, 1024, 1024, 10),
    ("text 32x32", 4, 1024, 77, 10),
    ("self 16x16", 4, 256, 256, 20),
    ("self 8x8 (mid)", 4, 64, 64, 20),
    ("text 8x8 (mid)", 4, 64, 77, 20),
]

# K1 out: one bf16 ulp is at most 2^-7 = 0.0078 of |out|, so rtol 2e-2 covers a
# rounding step either way; atol 2e-3 is below a tenth of the smallest typical
# |out| (about 0.026 at Sk = 4096). The relative RMS error over the whole
# output catches a small error spread over every element (P rounded too
# coarsely, a wrong rescale) that stays under the elementwise bound.
ATTN_TOL = dict(atol=2e-3, rtol=2e-2)
ATTN_REL_RMS = 1e-2
LSE_TOL = dict(atol=2e-3, rtol=1e-4)

# (label, B, Sq, Sk, heads): every attention shape of the 768² train step,
# D = 64. Self-attention and both adapters share the self shapes; the text
# cross-attention (Sk = 77) needs no dk/dv on the path but is held here too.
TRAIN_ATTN_CASES = [
    ("self 96x96", 6, 9216, 9216, 5),
    ("text 96x96", 6, 9216, 77, 5),
    ("self 48x48", 6, 2304, 2304, 10),
    ("text 48x48", 6, 2304, 77, 10),
    ("self 24x24", 6, 576, 576, 20),
    ("text 24x24", 6, 576, 77, 20),
    ("self 12x12 (mid)", 6, 144, 144, 20),
    ("text 12x12 (mid)", 6, 144, 77, 20),
]
# (label, B, Sq, Sk, heads): the self sites of joint multi-view attention at
# the largest latent level, where the views merge into one sequence: 4-view
# 512² generation (guidance 1.0: one group) and 2-view 768² training
# (batch 6); their plain versions run at B 1 (the forward's f32 scores take
# 5.4 GB there, the backward's 6.8 GB per tensor and per row, so it runs
# head by head)
JOINT_ATTN_CASES = [
    ("joint self 4x64x64", 1, 16384, 16384, 5),
    ("joint self 2x96x96", 6, 18432, 18432, 5),
]
# (label, B, S per rank, heads, ranks n): ring attention (K4) at the joint
# self lengths of JOINT_ATTN_CASES split over n view ranks (4 ranks of one
# 512² view each; 2 ranks of one 768² view each, the JAX north-star local
# sequence of tests/test_ring_attention.py), and its merge K4m at a rank's
# shape
RING_CASES = [
    ("ring 4x4096", 1, 4096, 5, 4),
    ("ring 2x9216", 6, 9216, 5, 2),
]
# K4m computes the formula of its plain version, each product, sum and
# quotient rounded alike; only expf and logf may differ from torch's by an
# ulp or two, which the merge carries on: held to MERGE_ULPS units in the
# last place of f32 (2^-24 relative) of the terms' magnitude
MERGE_ULPS = 8


def merge_bounds(B: int, S: int, H: int) -> dict:
    """Least time (ms) of one K4m call at head width D: the running o read
    and written (f32) and the hop's o_i read (bf16), the running lse read
    and written and the hop's lse_i read (f32), at HBM_BYTES_PER_S; its few
    operations per element are far below their bound."""
    nbytes = B * S * H * D * (4 + 4 + 2) + B * S * H * (4 + 4 + 4)
    return dict(bytes=nbytes, bound_ms=nbytes / HBM_BYTES_PER_S * 1e3, bound_by="bytes")


# K3a/K3b round P and dS to bf16 before their products, where the plain
# version keeps f32, and round dq/dk/dv to bf16: each term carries a relative
# error of about 2^-9, and the sums over Sk (or Sq) terms average it, so the
# relative RMS error stays near 3e-3. Elementwise: rtol 2e-2 (a bf16 rounding
# step of the result either way) plus an atol of 5e-2 times the case's RMS
# gradient for elements near zero; the relative RMS bound catches an error
# spread over every element.
GRAD_RTOL, GRAD_ATOL_RMS, GRAD_REL_RMS = 2e-2, 5e-2, 1e-2


# (label, B, H, W, C, silu): GroupNorm shapes of the 512² main path (UNet
# and VAE decode, B 4), every one at G = 32
GN_CASES = [
    ("unet 64x64x320 silu", 4, 64, 64, 320, True),
    ("unet 64x64x320 transformer", 4, 64, 64, 320, False),
    ("unet 32x32x960 silu", 4, 32, 32, 960, True),
    ("unet 16x16x2560 silu", 4, 16, 16, 2560, True),
    ("unet 8x8x1280 silu", 4, 8, 8, 1280, True),
    ("vae 512x512x256 silu", 4, 512, 512, 256, True),
    ("vae 512x512x128 silu", 4, 512, 512, 128, True),
    ("vae 256x256x256 silu", 4, 256, 256, 256, True),
    ("vae 128x128x512 silu", 4, 128, 128, 512, True),
    ("vae 64x64x512 attn", 4, 64, 64, 512, False),
]
# and of the 768² train step (B 6): UNet at 96², VAE encoder at 768²
TRAIN_GN_CASES = [
    ("train unet 96x96x320 silu", 6, 96, 96, 320, True),
    ("train unet 96x96x960 silu", 6, 96, 96, 960, True),
    ("train vae 768x768x128 silu", 6, 768, 768, 128, True),
    ("train vae 768x768x256 silu", 6, 768, 768, 256, True),
]
GN_TOL = dict(atol=1e-2, rtol=1e-2)  # one bf16 rounding of y (|y| up to ~5)


def gn_bounds(B: int, HW: int, C: int, silu: bool) -> dict:
    """Least time (ms) of one GroupNorm(+SiLU): x read and y written once in
    bf16 plus gamma and beta in f32 at HBM_BYTES_PER_S, or 5 f32 operations
    per element (10 with the SiLU) at F32_FLOPS, whichever is larger."""
    n = float(B) * HW * C
    t_bytes = (2 * 2 * n + 2 * 4.0 * C) / HBM_BYTES_PER_S * 1e3
    t_ops = (10.0 if silu else 5.0) * n / F32_FLOPS * 1e3
    return dict(bound_ms=max(t_ops, t_bytes), bound_by="operations" if t_ops >= t_bytes else "bytes")


# (label, B, Sq, Sk, heads): the int8 sites of 512² generation (K6 and K6q,
# D = 64): the self and adapter sites of the 64² and 32² levels
INT8_CASES = [("self 64x64", 4, 4096, 4096, 5), ("self 32x32", 4, 1024, 1024, 10)]
INT8_MIN_DB = 30.0  # int8 against exact attention: the JAX package's own bar
# K6 against its plain core on identical operands: both quantize P against
# the same group max and differ only by f32 rounding before the bf16 output
# (measured on the H100 with the first K6: max abs err 2.4e-4, relative RMS
# error 1e-5), so K6 is held tighter than K1: rtol 1e-2 still covers one bf16
# rounding step, and the relative RMS error may reach only 1e-3.
INT8_TOL, INT8_REL_RMS = dict(atol=1e-3, rtol=1e-2), 1e-3
# K6q against the plain quantizers: q8, sq, v8t and sv bitwise. K's mean is
# a sum over the sequence taken in another order, so it may differ in its
# last bit; sk (a max of |k - mean| / 127) then moves by about one f32 ulp
# (relative 1e-6 allows eight), and an element of k8 moves by one only when
# (k - mean) / sk lies within that ulp of a rounding boundary (at most 1e-4
# of the elements).
K6Q_SK_RTOL, K6Q_K8_OFF_SHARE = 1e-6, 1e-4


def int8_bounds(B: int, Sq: int, Sk: int, H: int, clock_hz: float) -> dict:
    """Least times (ms) of one K6 call at head width D: its int8 tensor
    operations (4 B H Sq Sk D) at INT8_TENSOR_OPS, its B H Sq Sk
    exponentials at EX2_PER_CLOCK_PER_SM per clock on SMS SMs, and its bytes
    (int8 q, k, v and the f32 scales read once, bf16 out and f32 lse
    written once) at HBM_BYTES_PER_S. ``bound_ms`` is the largest;
    ``bound_by`` is "operations" (tensor or exponentials) or "bytes"."""
    HD = H * D
    nbytes = (B * Sq * HD + 2.0 * B * Sk * HD + 4.0 * (B * Sq * H + B * H + B * HD)
              + 2.0 * B * Sq * HD + 4.0 * B * Sq * H)
    ops_ms = 4.0 * B * H * Sq * Sk * D / INT8_TENSOR_OPS * 1e3
    exp_ms = float(B) * H * Sq * Sk / (SMS * EX2_PER_CLOCK_PER_SM * clock_hz) * 1e3
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    bound = max(ops_ms, exp_ms, bytes_ms)
    return dict(ops_ms=ops_ms, exp_ms=exp_ms, bytes_ms=bytes_ms, bound_ms=bound,
                bound_by="bytes" if bound == bytes_ms else "operations")


def k6q_bounds(B: int, Sq: int, Sk: int, H: int) -> dict:
    """Least time (ms) of one K6q call: its bytes (bf16 q, k, v read once;
    int8 q8, k8, v8t and f32 sq, sk, sv written once) at HBM_BYTES_PER_S;
    beside it, ``two_read_ms``, the same with k and v read twice, as its two
    passes do."""
    HD = H * D
    inputs = 2.0 * (B * Sq * HD + 2 * B * Sk * HD)
    outputs = B * Sq * HD + 2.0 * B * Sk * HD + 4.0 * (B * Sq * H + B * H + B * HD)
    bytes_ms = (inputs + outputs) / HBM_BYTES_PER_S * 1e3
    two_read_ms = (inputs + 4.0 * B * Sk * HD + outputs) / HBM_BYTES_PER_S * 1e3
    return dict(bytes_ms=bytes_ms, two_read_ms=two_read_ms, bound_ms=bytes_ms, bound_by="bytes")


def check_quantize(got, want, what) -> dict:
    """K6q's operands ``got`` (q8, k8, v8t, sq, sk, sv) against the plain
    quantizers' ``want``: q8, v8t, sq and sv bitwise; sk within K6Q_SK_RTOL
    and k8 off by at most 1 in at most K6Q_K8_OFF_SHARE of its elements.
    Returns the largest sk relative error and the share of k8 elements off;
    raises AssertionError when a bound is broken."""
    import torch

    for name, i in (("q8", 0), ("v8t", 2), ("sq", 3), ("sv", 5)):
        if got[i].shape != want[i].shape or not torch.equal(got[i], want[i]):
            raise AssertionError(f"{what} {name}: not bitwise equal to the plain quantizers")
    sk_rel = ((got[4] - want[4]).abs() / want[4].abs()).max().item()
    diff = (got[1].int() - want[1].int()).abs()
    off = (diff > 0).float().mean().item()
    if not sk_rel <= K6Q_SK_RTOL or diff.max().item() > 1 or off > K6Q_K8_OFF_SHARE:
        raise AssertionError(f"{what}: sk relative error {sk_rel:.3g} (at most {K6Q_SK_RTOL}), k8 "
                             f"off by up to {diff.max().item()} in a share {off:.3g} of its elements "
                             f"(at most 1 in {K6Q_K8_OFF_SHARE})")
    return dict(sk_rel_err=sk_rel, k8_off_share=off)


def card_line() -> str:
    """The card's name and power limit as ``nvidia-smi
    --query-gpu=name,power.limit --format=csv,noheader`` gives them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30, check=True,
        ).stdout.strip().splitlines()
        return out[0] if out else "unknown, unknown"
    except (OSError, subprocess.SubprocessError):
        return "unknown, unknown"


def sm_clock_hz() -> float:
    """The SM clock's maximum as ``nvidia-smi`` reports it."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, timeout=30, check=True,
    ).stdout.split()
    return float(out[0]) * 1e6


def attn_bounds(B: int, Sq: int, Sk: int, H: int, clock_hz: float) -> dict:
    """Least times (ms) of one attention forward at head width D: its bf16
    tensor operations at BF16_TENSOR_FLOPS, its bytes (q, k, v, out once,
    lse) at HBM_BYTES_PER_S and its B·H·Sq·Sk exponentials at
    EX2_PER_CLOCK_PER_SM per clock on SMS SMs."""
    flops = 4.0 * B * H * Sq * Sk * D
    nbytes = 2.0 * (2 * B * Sq * H * D + 2 * B * Sk * H * D) + 4.0 * B * Sq * H
    exps = float(B) * H * Sq * Sk
    return dict(ops_ms=flops / BF16_TENSOR_FLOPS * 1e3, bytes_ms=nbytes / HBM_BYTES_PER_S * 1e3,
                exp_ms=exps / (SMS * EX2_PER_CLOCK_PER_SM * clock_hz) * 1e3)


def bwd_bounds(B: int, Sq: int, Sk: int, H: int) -> dict:
    """Least times (ms) of K3a (``"dq"``) and K3b (``"dkv"``) at head width
    D: their bf16 tensor operations (K3a S, dP and dq, K3b S^T, dP^T, dv and
    dk, each 2 Sq Sk D per head) at BF16_TENSOR_FLOPS, and their bytes (q,
    k, v, dO in bf16 and lse, delta (B, Sq, H) in f32 read once, dq or dk and
    dv written once) at HBM_BYTES_PER_S; ``bound_ms`` is the larger,
    ``bound_by`` says which."""
    io_in = 2.0 * (2 * B * Sq * H * D + 2 * B * Sk * H * D) + 2 * 4.0 * B * Sq * H
    bounds = {}
    for key, products, out_bytes in (("dq", 3, 2.0 * B * Sq * H * D), ("dkv", 4, 2 * 2.0 * B * Sk * H * D)):
        t_ops = 2.0 * products * B * H * Sq * Sk * D / BF16_TENSOR_FLOPS * 1e3
        t_bytes = (io_in + out_bytes) / HBM_BYTES_PER_S * 1e3
        bounds[key] = dict(ops_ms=t_ops, bytes_ms=t_bytes, bound_ms=max(t_ops, t_bytes),
                           bound_by="operations" if t_ops >= t_bytes else "bytes")
    return bounds


def turns(labels, rounds: int) -> list:
    """The order in which a bench times its builds: in order, then in
    reverse, ``rounds`` times, so that drift over the run falls on each
    alike."""
    labels = list(labels)
    return (labels + labels[::-1]) * rounds


def time_ms(fn, iters: int, warmup: int = 3) -> float:
    """Mean ms per call of ``fn`` over ``iters`` calls, by CUDA events."""
    import torch

    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def time_graph_ms(fn, iters: int = 20, calls: int = 10) -> float:
    """Device ms per call of ``fn``: ``calls`` calls captured in one CUDA
    graph, replayed ``iters`` times between CUDA events, so that the host's
    cost per call (Python, ctypes) hides behind the device's. ``fn`` must
    launch on the current stream and allocate nothing."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # warm up outside the capture
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    ms = time_ms(graph.replay, iters) / calls
    del graph
    return ms


def max_err(got, want, tol, what) -> float:
    """The largest absolute error; raises when ``got`` is not finite or an
    element is off by more than ``tol["atol"] + tol["rtol"] * |want|``."""
    import torch

    got, want = got.float(), want.float()
    err = (got - want).abs()
    bad = err > tol["atol"] + tol["rtol"] * want.abs()
    if not torch.isfinite(got).all() or bad.any():
        raise AssertionError(f"{what}: {int(bad.sum())} elements off, max abs err {err.max().item():.3g}")
    return err.max().item()


def check_attention(out, lse, ref_out, ref_lse, what, tol=ATTN_TOL, rel_rms_max=ATTN_REL_RMS):
    """K1's tolerance (or the one given) on out, LSE_TOL on lse, and the
    bound on the relative RMS error of out; returns (max abs err, relative
    RMS error) and raises AssertionError when a bound is broken."""
    err = max(max_err(out, ref_out, tol, f"{what} out"), max_err(lse, ref_lse, LSE_TOL, f"{what} lse"))
    ref_rms = ref_out.float().pow(2).mean().sqrt().item()
    rel_rms = (out.float() - ref_out.float()).pow(2).mean().sqrt().item() / ref_rms
    if not rel_rms <= rel_rms_max:
        raise AssertionError(f"{what} out: relative RMS error {rel_rms:.3g} > {rel_rms_max}")
    return err, rel_rms


def check_grad(got, want, what, rms=None):
    """K3a/K3b's check of one gradient: (max abs err, typical |grad| (RMS),
    relative RMS error); raises AssertionError when ``got`` is not finite,
    an element is off by more than GRAD_ATOL_RMS * RMS + GRAD_RTOL * |want|,
    or the relative RMS error exceeds GRAD_REL_RMS. ``rms`` replaces
    RMS(want) as the typical size where the exact gradient is 0 and ``want``
    holds only rounding noise."""
    import torch

    got, want = got.float(), want.float()
    if rms is None:
        rms = want.pow(2).mean().sqrt().item()
    err = (got - want).abs()
    bad = err > GRAD_ATOL_RMS * rms + GRAD_RTOL * want.abs()
    rel_rms = (got - want).pow(2).mean().sqrt().item() / rms
    if not torch.isfinite(got).all() or bad.any() or not rel_rms <= GRAD_REL_RMS:
        raise AssertionError(f"{what}: {int(bad.sum())} elements off, max abs err "
                             f"{err.max().item():.3g}, relative RMS error {rel_rms:.3g}")
    return err.max().item(), rms, rel_rms


def plain_bwd_by_row(q, k, v, out, lse, do, heads, layout="packed", by_head=False):
    """The plain backward (``attention_packed_bwd_plain``) one batch row at a
    time: the f32 score matrices of a whole 96² batch would not fit beside
    the model. ``by_head`` (packed layout): one head of one row at a time,
    for the joint lengths, where one row's (H, Sq, Sk) f32 scores take
    several GB (6.8 GB at H 5, S 18432)."""
    import torch

    from mvd_tpu_torch.kernels import attention_packed_bwd_plain

    if by_head and layout != "packed":
        raise ValueError(f"by_head takes the packed layout, not {layout!r}")
    if by_head:
        D = q.shape[-1] // heads
        cols = lambda t, h: t[..., h * D:(h + 1) * D]
        rows = [[attention_packed_bwd_plain(cols(q[b:b + 1], h), cols(k[b:b + 1], h), cols(v[b:b + 1], h),
                                            cols(out[b:b + 1], h), lse[b:b + 1, :, h:h + 1].contiguous(),
                                            cols(do[b:b + 1], h), 1)
                 for h in range(heads)] for b in range(q.shape[0])]
        rows = [tuple(torch.cat(parts, dim=-1) for parts in zip(*row)) for row in rows]
    else:
        rows = [attention_packed_bwd_plain(q[b:b + 1], k[b:b + 1], v[b:b + 1], out[b:b + 1],
                                           lse[b:b + 1], do[b:b + 1], heads, layout=layout)
                for b in range(q.shape[0])]
    return tuple(torch.cat(parts) for parts in zip(*rows))
