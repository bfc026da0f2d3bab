"""K1: packed flash-attention forward (``csrc/flash_attn_fwd.cu``).

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


def attention_packed(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    heads: int,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Multi-head attention on the packed (B, S, H*D) layout (the output of
    the q/k/v projections, no head transposes)."""
    return flash_attention_packed_fwd(q, k, v, heads, scale)[0]
