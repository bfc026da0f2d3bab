"""K2: GroupNorm(+SiLU) forward on NHWC (``csrc/groupnorm_silu.cu``).

Replaces the TPU kernel ``mvd_tpu/kernels/groupnorm_silu.py:_gn_silu_kernel``
(through ``_pallas_gn_silu`` / ``groupnorm_silu``): per-channel f32 sum and
sum of squares folded to G groups, ``(x - mean) * rstd * gamma + beta``, an
optional SiLU, in one more pass.

On the H100 it is bound by bytes (x read, y written). The TPU kernel ran one
program per batch row; the CUDA version splits the statistics over (row
chunk, batch) blocks with per-group atomics, so every SM has work at every
shape of the main path, and applies the affine (+SiLU) with 16-byte loads
and stores; the source's header says more.

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
import functools
from typing import Optional, Tuple

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


@functools.cache
def _entry():
    """The C entry, built and loaded on first call, its signature set once."""
    fn = _build.load("groupnorm_silu").groupnorm_silu_bf16
    fn.argtypes = [_P] * 5 + [ctypes.c_int] * 4 + [ctypes.c_float, ctypes.c_int, _P]
    fn.restype = ctypes.c_int
    return fn


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
    y = torch.empty_like(x)
    stats = torch.empty(B * num_groups * 2, dtype=torch.float32, device=x.device)
    err = _entry()(
        x.data_ptr(), scale.data_ptr(), bias.data_ptr(), y.data_ptr(),
        stats.data_ptr(), B, H * W, C, num_groups, float(eps),
        int(apply_silu), torch.cuda.current_stream(x.device).cuda_stream,
    )
    _build.check(err, "groupnorm_silu_bf16")
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
