"""K1: packed flash-attention forward (``csrc/flash_attn_fwd.cu``), and
K3a/K3b: its backward (``csrc/flash_attn_bwd.cu``).

Replaces the TPU kernel ``mvd_tpu/kernels/flash_attention.py:_fwd_kernel_packed``
(through ``_flash_fwd_packed`` / ``attention_packed``): non-causal multi-head
attention on the packed ``(B, S, H*D)`` layout, f32 online softmax, returning
the output ``(B, Sq, H*D)`` and the log-sum-exp ``(B, Sq, H)`` in f32.

On the H100 the self-attention sites (Sq = Sk = 4096 at 512², D = 64) are
bound by tensor-core operations and the Sk = 77 text sites by the bytes of
Q and O. The kernel keeps Q in registers, stages K/V tiles in shared memory,
runs both products on the tensor cores (``mma.sync``) and never writes the
score matrix to device memory; the source's header says more.

Every call on a CUDA tensor launches the kernel, whatever the sequence
lengths: the JAX package's ``Sq >= 1024`` threshold is a TPU tuning. A CPU
tensor takes ``attention_packed_plain``, the plain PyTorch version the tests
and ``chip_smoke.py`` compare the kernel with.

K3a (dq) and K3b (dk, dv) replace ``_bwd_dq_kernel`` / ``_bwd_dkv_kernel``
(through ``_flash_bwd``). ``attention_packed`` is differentiable through
``FlashAttention``, an ``autograd.Function`` that saves K1's (q, k, v, out,
lse) as the JAX custom VJP does, so the backward never re-runs K1, and that
launches K3b only when k or v needs a gradient. delta = rowsum(dO * O) is a
PyTorch reduction, as it is XLA outside the kernel in the JAX package.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Optional, Tuple

import torch

from . import _build

_P = ctypes.c_void_p


def attention_packed_plain(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    heads: int,
    scale: Optional[float] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of K1, in f32: (out in q's dtype, lse f32)."""
    B, Sq, HD = q.shape
    Sk = k.shape[1]
    D = HD // heads
    if scale is None:
        scale = 1.0 / math.sqrt(D)
    split = lambda t, s: t.float().reshape(B, s, heads, D).transpose(1, 2)
    logits = split(q, Sq) @ split(k, Sk).transpose(-1, -2) * scale  # (B, H, Sq, Sk)
    lse = torch.logsumexp(logits, dim=-1)
    out = torch.exp(logits - lse[..., None]) @ split(v, Sk)
    out = out.transpose(1, 2).reshape(B, Sq, HD).to(q.dtype)
    return out, lse.transpose(1, 2).contiguous()


@functools.cache
def _entry():
    """The C entry, built and loaded on first call, its signature set once."""
    fn = _build.load("flash_attn_fwd").flash_attn_fwd_packed_bf16
    fn.argtypes = [_P, _P, _P, _P, _P] + [ctypes.c_int] * 5 + [ctypes.c_float, _P]
    fn.restype = ctypes.c_int
    return fn


def _check_cuda_inputs(q, k, v, heads):
    if not (q.device == k.device == v.device):
        raise ValueError(f"q, k, v on different devices: {q.device}, {k.device}, {v.device}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.dtype != torch.bfloat16:
            raise TypeError(f"flash attention kernel takes bf16, got {name} {t.dtype}")
        if t.dim() != 3 or not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name} must be a contiguous, 16-byte aligned (B, S, H*D) tensor")
    B, Sq, HD = q.shape
    if k.shape != v.shape or k.shape[0] != B or k.shape[2] != HD:
        raise ValueError(f"shape mismatch: q {tuple(q.shape)}, k {tuple(k.shape)}, v {tuple(v.shape)}")
    if HD % heads or HD // heads != 64:
        raise ValueError(f"flash attention kernel takes head_dim 64, got {HD}/{heads}")


def flash_attention_packed_fwd(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    heads: int,
    scale: Optional[float] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Packed attention forward: ``(out (B, Sq, H*D), lse (B, Sq, H) f32)``.

    CUDA tensors go to the kernel (bf16, head_dim 64, contiguous; anything
    else raises); CPU tensors to the plain version."""
    if q.device.type == "cpu":
        flash_attention_packed_fwd.plain_calls += 1
        return attention_packed_plain(q, k, v, heads, scale)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    _check_cuda_inputs(q, k, v, heads)
    B, Sq, HD = q.shape
    Sk = k.shape[1]
    D = HD // heads
    if scale is None:
        scale = 1.0 / math.sqrt(D)
    out = torch.empty_like(q)
    lse = torch.empty((B, Sq, heads), dtype=torch.float32, device=q.device)
    err = _entry()(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), lse.data_ptr(),
        B, Sq, Sk, heads, D, float(scale),
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    _build.check(err, "flash_attn_fwd_packed_bf16")
    flash_attention_packed_fwd.launches += 1
    return out, lse


flash_attention_packed_fwd.launches = 0
flash_attention_packed_fwd.plain_calls = 0


def _bwd_plain_parts(q, k, v, do, lse, delta, heads, scale, want_dq, want_dkv):
    """The backward math in f32 from lse and delta: (dq, dk, dv), each in
    its input's dtype or None where not wanted."""
    B, Sq, HD = q.shape
    Sk = k.shape[1]
    D = HD // heads
    split = lambda t, s: t.float().reshape(B, s, heads, D).transpose(1, 2)
    merge = lambda t, s, like: t.transpose(1, 2).reshape(B, s, HD).to(like.dtype)
    qh, kh, vh, doh = split(q, Sq), split(k, Sk), split(v, Sk), split(do, Sq)
    logits = qh @ kh.transpose(-1, -2) * scale  # (B, H, Sq, Sk)
    p = torch.exp(logits - lse.float().transpose(1, 2)[..., None])
    ds = p * (doh @ vh.transpose(-1, -2) - delta.float().transpose(1, 2)[..., None])
    dq = merge(ds @ kh * scale, Sq, q) if want_dq else None
    dk = merge(ds.transpose(-1, -2) @ qh * scale, Sk, k) if want_dkv else None
    dv = merge(p.transpose(-1, -2) @ doh, Sk, v) if want_dkv else None
    return dq, dk, dv


def _delta(out: torch.Tensor, do: torch.Tensor, heads: int) -> torch.Tensor:
    """delta = rowsum(dO * O) per head: (B, Sq, H) f32."""
    B, Sq, HD = out.shape
    return (do.float() * out.float()).reshape(B, Sq, heads, HD // heads).sum(-1)


def attention_packed_bwd_plain(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    out: torch.Tensor,
    lse: torch.Tensor,
    do: torch.Tensor,
    heads: int,
    scale: Optional[float] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of K3a and K3b, in f32, as the JAX backward:
    delta = rowsum(dO O), P = exp(q k^T scale - lse), dS = P (dO V^T - delta),
    dq = dS K scale, dk = dS^T Q scale, dv = P^T dO; outputs in the inputs'
    dtypes."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1] // heads)
    return _bwd_plain_parts(q, k, v, do, lse, _delta(out, do, heads), heads, scale, True, True)


@functools.cache
def _bwd_entries():
    """The two C entries of K3a and K3b, built and loaded on first call."""
    lib = _build.load("flash_attn_bwd")
    dq_fn, dkv_fn = lib.flash_attn_bwd_dq_bf16, lib.flash_attn_bwd_dkv_bf16
    dq_fn.argtypes = [_P] * 7 + [ctypes.c_int] * 5 + [ctypes.c_float, _P]
    dkv_fn.argtypes = [_P] * 8 + [ctypes.c_int] * 5 + [ctypes.c_float, _P]
    dq_fn.restype = dkv_fn.restype = ctypes.c_int
    return dq_fn, dkv_fn


def _check_bwd_inputs(q, k, v, do, lse, delta, heads):
    _check_cuda_inputs(q, k, v, heads)
    B, Sq, HD = q.shape
    if do.dtype != torch.bfloat16 or do.shape != q.shape or not do.is_contiguous() or do.data_ptr() % 16:
        raise ValueError(f"dO must be a contiguous, 16-byte aligned bf16 tensor shaped like q {tuple(q.shape)}")
    for name, t in (("lse", lse), ("delta", delta)):
        if t.dtype != torch.float32 or t.shape != (B, Sq, heads) or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous f32 ({B}, {Sq}, {heads}) tensor")
    if not (q.device == do.device == lse.device == delta.device):
        raise ValueError("backward inputs on different devices")


def flash_attention_packed_bwd_dq(q, k, v, do, lse, delta, heads, scale=None) -> torch.Tensor:
    """K3a: dq ``(B, Sq, H*D)`` from q, k, v, dO, lse and delta ``(B, Sq, H)``.
    CUDA tensors go to the kernel (anything it does not take raises); CPU
    tensors to the plain version."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1] // heads)
    if q.device.type == "cpu":
        flash_attention_packed_bwd_dq.plain_calls += 1
        return _bwd_plain_parts(q, k, v, do, lse, delta, heads, scale, True, False)[0]
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    _check_bwd_inputs(q, k, v, do, lse, delta, heads)
    B, Sq, HD = q.shape
    dq = torch.empty_like(q)
    err = _bwd_entries()[0](
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
        delta.data_ptr(), dq.data_ptr(), B, Sq, k.shape[1], heads, HD // heads,
        float(scale), torch.cuda.current_stream(q.device).cuda_stream,
    )
    _build.check(err, "flash_attn_bwd_dq_bf16")
    flash_attention_packed_bwd_dq.launches += 1
    return dq


def flash_attention_packed_bwd_dkv(q, k, v, do, lse, delta, heads, scale=None):
    """K3b: (dk, dv), each ``(B, Sk, H*D)``, from the same inputs as K3a."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1] // heads)
    if q.device.type == "cpu":
        flash_attention_packed_bwd_dkv.plain_calls += 1
        return _bwd_plain_parts(q, k, v, do, lse, delta, heads, scale, False, True)[1:]
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    _check_bwd_inputs(q, k, v, do, lse, delta, heads)
    B, Sq, HD = q.shape
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    err = _bwd_entries()[1](
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
        delta.data_ptr(), dk.data_ptr(), dv.data_ptr(), B, Sq, k.shape[1], heads,
        HD // heads, float(scale), torch.cuda.current_stream(q.device).cuda_stream,
    )
    _build.check(err, "flash_attn_bwd_dkv_bf16")
    flash_attention_packed_bwd_dkv.launches += 1
    return dk, dv


for _fn in (flash_attention_packed_bwd_dq, flash_attention_packed_bwd_dkv):
    _fn.launches = 0
    _fn.plain_calls = 0


def flash_attention_packed_bwd(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    out: torch.Tensor,
    lse: torch.Tensor,
    do: torch.Tensor,
    heads: int,
    scale: Optional[float] = None,
    need_dq: bool = True,
    need_dkv: bool = True,
):
    """Packed attention backward: (dq, dk, dv), None where not needed.
    delta is a PyTorch reduction; K3a runs when dq is needed, K3b when dk
    and dv are."""
    delta = _delta(out, do, heads)
    dq = flash_attention_packed_bwd_dq(q, k, v, do, lse, delta, heads, scale) if need_dq else None
    dk = dv = None
    if need_dkv:
        dk, dv = flash_attention_packed_bwd_dkv(q, k, v, do, lse, delta, heads, scale)
    return dq, dk, dv


class FlashAttention(torch.autograd.Function):
    """K1 forward, K3a/K3b backward. Saves (q, k, v, out, lse)."""

    @staticmethod
    def forward(ctx, q, k, v, heads, scale):
        out, lse = flash_attention_packed_fwd(q, k, v, heads, scale)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.heads, ctx.scale = heads, scale
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        need_q, need_k, need_v = ctx.needs_input_grad[:3]
        dq, dk, dv = flash_attention_packed_bwd(
            q, k, v, out, lse, do.contiguous(), ctx.heads, ctx.scale,
            need_dq=need_q, need_dkv=need_k or need_v,
        )
        return dq, dk if need_k else None, dv if need_v else None, None, None


def attention_packed(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    heads: int,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Multi-head attention on the packed (B, S, H*D) layout (the output of
    the q/k/v projections, no head transposes); differentiable in q, k, v."""
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        return FlashAttention.apply(q, k, v, heads, scale)
    return flash_attention_packed_fwd(q, k, v, heads, scale)[0]
