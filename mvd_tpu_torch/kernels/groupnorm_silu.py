"""K2: GroupNorm(+SiLU) forward on NHWC (``csrc/groupnorm_silu.cu``).

Replaces the TPU kernel ``mvd_tpu/kernels/groupnorm_silu.py:_gn_silu_kernel``
(through ``_pallas_gn_silu`` / ``groupnorm_silu``): per-group f32 sum and sum
of squares, ``(x - mean) * rstd * gamma + beta``, an optional SiLU.

On the H100 it is bound by bytes (x read, y written). ``launch_plan`` picks
one of the kernel's two paths for each shape and the C entry takes the plan
as it is: where a batch row's slab of a group set fits in the shared memory
of one thread-block cluster, one launch reads x once into shared memory,
reduces across the cluster through distributed shared memory and applies
from there (``FUSED``); larger slabs take two launches, per-CTA partials
summed in a fixed order by the apply pass (``TWO_PASS``). Neither uses a
memset or atomics, so a call is bitwise repeatable. The source's header
says more.

The JAX package gates its kernel off by default (``MVD_FUSED_GN``) because
it lost to XLA's own fusion on the TPU. Eager PyTorch has no such fusion, so
here every GroupNorm on a CUDA tensor launches the kernel. A CPU tensor takes
``groupnorm_silu_plain``, the plain version the tests and ``chip_smoke.py``
compare the kernel with.

``groupnorm_silu_diff`` is the differentiable entry: an ``autograd.Function``
whose forward is K2 and whose backward (``groupnorm_silu_vjp``) recomputes
through the f32 plain formulation with PyTorch autograd, as the JAX custom
VJP recomputes through its XLA formulation. The JAX package has no Pallas
backward for GroupNorm, so this backward is PyTorch ops by design.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import math
from typing import List, Optional, Tuple

import torch

from . import _build

_P = ctypes.c_void_p


def groupnorm_silu_plain(
    x: torch.Tensor,
    scale: torch.Tensor,
    bias: torch.Tensor,
    num_groups: int = 32,
    eps: float = 1e-5,
    apply_silu: bool = True,
) -> torch.Tensor:
    """Plain PyTorch version of K2 on NHWC ``x``; statistics and affine in
    f32, the result in x's dtype."""
    B, H, W, C = x.shape
    cpg = C // num_groups
    xf = x.float().reshape(B, H * W, num_groups, cpg)
    n = H * W * cpg
    mean = xf.sum(dim=(1, 3)) / n  # (B, G)
    var = torch.clamp((xf * xf).sum(dim=(1, 3)) / n - mean * mean, min=0.0)
    rstd = torch.rsqrt(var + eps)
    a = rstd[:, :, None] * scale.float().reshape(num_groups, cpg)  # (B, G, cpg)
    b = bias.float().reshape(num_groups, cpg) - mean[:, :, None] * a
    y = xf * a[:, None] + b[:, None]
    if apply_silu:
        y = y * torch.sigmoid(y)
    return y.reshape(B, H, W, C).to(x.dtype)


FUSED, TWO_PASS = 0, 1  # the kernel's two paths
SMEM_MAX = 232448  # dynamic shared memory one CTA may take (227 KB)
MAX_THREADS = 512  # the two-pass kernels' block; fused CTAs take 256 (bench_groupnorm --sweep)
CLUSTERS = (1, 2, 4, 8, 16)  # cluster sizes; 16 is past the portable 8
FILL = 256  # CTAs that fill the card: two on each of its 132 SMs
# The fused path reads strided row segments of set * 2 bytes: below
# MIN_SEGMENT_BYTES a shape takes the two-pass path, below WIDE_SEGMENT_BYTES
# a plan is taken only where no wider one fits. A CTA holds at most
# SLAB_MAX_BYTES of x: past that, one CTA per SM serialises its loads and
# stores and the two-pass path wins (bench_groupnorm, PERF.md).
MIN_SEGMENT_BYTES, WIDE_SEGMENT_BYTES = 64, 160
SLAB_MAX_BYTES = 128 * 1024
TWO_PASS_CTAS = 264  # two resident CTAs of 512 threads on each of the 132 SMs


@dataclasses.dataclass(frozen=True)
class GNPlan:
    """One K2 launch: ``path`` (FUSED or TWO_PASS), the CTAs of a cluster
    (``cluster``, 1 on the two-pass path), the channels of a group set
    (``set``), the rows of x per CTA, the threads per CTA and the dynamic
    shared memory per CTA in bytes. ``grid`` is (x, y, z) of the launch, and
    ``scratch`` the f32 elements of the two-pass partials."""

    path: int
    cluster: int
    set: int
    rows: int
    threads: int
    smem: int
    grid: Tuple[int, int, int]
    scratch: int

    def c_args(self) -> Tuple[int, ...]:
        return (self.path, self.cluster, self.set, self.rows, self.threads, self.smem)


def _smem_bytes(path: int, rows: int, set_: int, threads: int, cpg: int) -> int:
    """``smem_bytes`` of ``csrc/groupnorm_silu.cu``: the fused path's slab
    (rows x set bf16, rounded up to 16 bytes), the fold's 2 x rows_par x set
    floats, 4 floats per group of the set and 2 x max(groups, warps) warp
    sums."""
    slab = -(-rows * set_ * 2 // 16) * 16 if path == FUSED else 0
    gs = set_ // cpg
    return slab + 2 * (threads // (set_ // 8)) * set_ * 4 + 4 * gs * 4 + 2 * max(gs, threads // 32) * 4


def _set_widths(C: int, G: int):
    """Group-set widths, narrowest first: multiples of 8 channels and of
    C/G that divide C, at most 8 * MAX_THREADS channels."""
    base = math.lcm(8, C // G)
    return [w for w in range(base, min(C, 8 * MAX_THREADS) + 1, base) if C % w == 0]


def fused_plans(B: int, HW: int, C: int, G: int) -> List[Tuple[tuple, GNPlan]]:
    """Every one-launch plan whose slab share fits one CTA's shared memory,
    each with its preference key (smaller is better): row segments of at
    least WIDE_SEGMENT_BYTES, then up to FILL CTAs, smaller clusters (less
    to synchronise), wider sets."""
    plans = []
    for set_ in _set_widths(C, G):
        vpr = set_ // 8
        for cs in CLUSTERS:
            rows = -(-HW // cs)
            if -(-HW // rows) != cs:  # a CTA of the cluster would hold no row
                continue
            threads = max(min(256, -(-rows * vpr // 32) * 32), -(-vpr // 32) * 32)
            smem = _smem_bytes(FUSED, rows, set_, threads, C // G)
            # the cluster's partials are gathered into the fold's terms
            if smem > SMEM_MAX or cs * (set_ // (C // G)) > threads // vpr * set_:
                continue
            ctas = B * (C // set_) * cs
            key = (set_ * 2 < WIDE_SEGMENT_BYTES, -min(ctas, FILL), cs, -set_)
            plans.append((key, GNPlan(FUSED, cs, set_, rows, threads, smem, ((C // set_) * cs, B, 1), 0)))
    return plans


def plan_fused(B: int, HW: int, C: int, G: int) -> Optional[GNPlan]:
    """The preferred one-launch plan with row segments of at least
    MIN_SEGMENT_BYTES (or whole rows) and at most SLAB_MAX_BYTES of x per
    CTA, or None where there is none."""
    plans = [(k, p) for k, p in fused_plans(B, HW, C, G)
             if (p.set * 2 >= MIN_SEGMENT_BYTES or p.set == C) and p.rows * p.set * 2 <= SLAB_MAX_BYTES]
    return min(plans, key=lambda kp: kp[0])[1] if plans else None


def plan_two_pass(B: int, HW: int, C: int, G: int) -> GNPlan:
    """The two-launch plan: the widest group set, 512 threads, and rows per
    CTA such that about TWO_PASS_CTAS CTAs cover the tensor."""
    set_ = _set_widths(C, G)[-1]
    sets = C // set_
    threads = MAX_THREADS
    rows = -(-HW // max(1, -(-TWO_PASS_CTAS // (B * sets))))
    chunks = -(-HW // rows)
    return GNPlan(TWO_PASS, 1, set_, rows, threads,
                  _smem_bytes(TWO_PASS, rows, set_, threads, C // G), (chunks, sets, B),
                  B * G * chunks * 2)


@functools.lru_cache(maxsize=512)
def launch_plan(B: int, HW: int, C: int, G: int) -> GNPlan:
    """The plan of one K2 call on (B, HW, C) with G groups: fused where a
    cluster holds the slab, else two passes."""
    return plan_fused(B, HW, C, G) or plan_two_pass(B, HW, C, G)


@functools.cache
def _entry():
    """The C entry, built and loaded on first call, its signature set once."""
    fn = _build.load("groupnorm_silu").groupnorm_silu_bf16
    fn.argtypes = [_P] * 5 + [ctypes.c_int] * 4 + [ctypes.c_float] + [ctypes.c_int] * 7 + [_P]
    fn.restype = ctypes.c_int
    return fn


def launch(entry, x, scale, bias, y, scratch, num_groups, eps, apply_silu, plan: GNPlan) -> None:
    """One call of a K2 C entry (``entry``: this build's or another's) on
    checked CUDA tensors, into ``y`` and ``scratch`` (None on the fused
    path). Counts nothing: ``groupnorm_silu`` counts its launches."""
    B, H, W, C = x.shape
    with _build.on_device(x):
        err = entry(
            x.data_ptr(), scale.data_ptr(), bias.data_ptr(), y.data_ptr(),
            None if scratch is None else scratch.data_ptr(), B, H * W, C, num_groups,
            float(eps), int(apply_silu), *plan.c_args(),
            torch.cuda.current_stream(x.device).cuda_stream,
        )
    _build.check(err, "groupnorm_silu_bf16")


def groupnorm_silu(
    x: torch.Tensor,
    scale: torch.Tensor,
    bias: torch.Tensor,
    num_groups: int = 32,
    eps: float = 1e-5,
    apply_silu: bool = True,
) -> torch.Tensor:
    """GroupNorm(+SiLU) on NHWC ``(B, H, W, C)``.

    CUDA tensors go to the kernel (bf16 contiguous x, f32 scale/bias,
    C % 8 == 0 and C % num_groups == 0; anything else raises); CPU tensors to
    the plain version."""
    if x.device.type == "cpu":
        groupnorm_silu.plain_calls += 1
        return groupnorm_silu_plain(x, scale, bias, num_groups, eps, apply_silu)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    if x.dtype != torch.bfloat16 or x.dim() != 4:
        raise TypeError(f"groupnorm kernel takes bf16 NHWC, got {x.dtype} {tuple(x.shape)}")
    if not x.is_contiguous() or x.data_ptr() % 16:
        raise ValueError("groupnorm kernel takes a contiguous, 16-byte aligned NHWC tensor")
    B, H, W, C = x.shape
    if C % 8 or C % num_groups:
        raise ValueError(f"groupnorm kernel needs C % 8 == 0 and C % G == 0, got C={C} G={num_groups}")
    for name, p in (("scale", scale), ("bias", bias)):
        if p.dtype != torch.float32 or p.shape != (C,) or not p.is_contiguous() or p.device != x.device:
            raise ValueError(f"groupnorm {name} must be a contiguous f32 ({C},) tensor on {x.device}")
    plan = launch_plan(B, H * W, C, num_groups)
    y = torch.empty_like(x)
    scratch = torch.empty(plan.scratch, dtype=torch.float32, device=x.device) if plan.scratch else None
    launch(_entry(), x, scale, bias, y, scratch, num_groups, eps, apply_silu, plan)
    groupnorm_silu.launches += 1
    return y


groupnorm_silu.launches = 0
groupnorm_silu.plain_calls = 0


def groupnorm_silu_vjp(
    x: torch.Tensor,
    scale: torch.Tensor,
    bias: torch.Tensor,
    dy: torch.Tensor,
    num_groups: int = 32,
    eps: float = 1e-5,
    apply_silu: bool = True,
    needs: Tuple[bool, bool, bool] = (True, True, True),
) -> Tuple[Optional[torch.Tensor], Optional[torch.Tensor], Optional[torch.Tensor]]:
    """(dx, dscale, dbias) of GroupNorm(+SiLU) by recomputing the f32 plain
    formulation under autograd; None where ``needs`` says no."""
    with torch.enable_grad():
        inputs = [t.detach().requires_grad_(n) for t, n in zip((x, scale, bias), needs)]
        y = groupnorm_silu_plain(*inputs, num_groups, eps, apply_silu)
        wanted = [t for t, n in zip(inputs, needs) if n]
        grads = iter(torch.autograd.grad(y, wanted, dy))
    return tuple(next(grads) if n else None for n in needs)


class GroupNormSiLU(torch.autograd.Function):
    """K2 forward, recompute backward. Saves (x, scale, bias)."""

    @staticmethod
    def forward(ctx, x, scale, bias, num_groups, eps, apply_silu):
        ctx.save_for_backward(x, scale, bias)
        ctx.args = (num_groups, eps, apply_silu)
        return groupnorm_silu(x, scale, bias, num_groups, eps, apply_silu)

    @staticmethod
    def backward(ctx, dy):
        x, scale, bias = ctx.saved_tensors
        grads = groupnorm_silu_vjp(x, scale, bias, dy, *ctx.args, needs=ctx.needs_input_grad[:3])
        return (*grads, None, None, None)


def groupnorm_silu_diff(
    x: torch.Tensor,
    scale: torch.Tensor,
    bias: torch.Tensor,
    num_groups: int = 32,
    eps: float = 1e-5,
    apply_silu: bool = True,
) -> torch.Tensor:
    """``groupnorm_silu``, differentiable in x, scale and bias."""
    if torch.is_grad_enabled() and (x.requires_grad or scale.requires_grad or bias.requires_grad):
        return GroupNormSiLU.apply(x, scale, bias, num_groups, eps, apply_silu)
    return groupnorm_silu(x, scale, bias, num_groups, eps, apply_silu)
