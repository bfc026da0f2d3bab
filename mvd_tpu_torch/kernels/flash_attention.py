"""Flash attention of the port: K1 and K5 (forward, ``csrc/flash_attn_fwd.cu``),
K3a/K3b (backward, ``csrc/flash_attn_bwd.cu``), K6 (int8 forward,
``csrc/flash_attn_int8.cu``) and K6q (K6's quantizers,
``csrc/quantize_int8.cu``).

K1 replaces the TPU kernel ``mvd_tpu/kernels/flash_attention.py:_fwd_kernel_packed``
(through ``_flash_fwd_packed`` / ``attention_packed``): non-causal multi-head
attention on the packed ``(B, S, H*D)`` layout, f32 online softmax, returning
the output ``(B, Sq, H*D)`` and the log-sum-exp ``(B, Sq, H)`` in f32.
K5 replaces ``_fwd_kernel_grid`` (through ``_flash_fwd``, the kernels
package's public ``flash_attention``/``attention``): the same function on
``(B, H, S, D)``, lse ``(B, H, Sq)``. K5 is K1's kernel given the other
layout's tensor maps, one source with two layouts; its launches count apart.

On the H100 the self-attention sites (Sq = Sk = 4096 at 512², D = 64) are
bound by tensor-core operations and exponentials about equally, and the
Sk = 77 text sites by the bytes of Q and O. The kernel is warp-specialised:
a producer loads Q and a ring of K/V tiles with TMA, consumer warpgroups run
both products with ``wgmma`` and never write the score matrix to device
memory; the source's header says more.

Every call on a CUDA tensor launches the kernel, whatever the sequence
lengths: the JAX package's ``Sq >= 1024`` threshold is a TPU tuning. A CPU
tensor takes the plain PyTorch version (``attention_packed_plain``,
``attention_plain``) that the tests and ``chip_smoke.py`` compare the kernel
with.

K3a (dq) and K3b (dk, dv) replace ``_bwd_dq_kernel`` / ``_bwd_dkv_kernel``
(through ``_flash_bwd``), in either layout. ``attention_packed`` and
``flash_attention`` are differentiable through the custom operator
``mvd_tpu_torch::flash_fwd`` (``flash_fwd_op``), which saves the forward's
(q, k, v, out, lse) as the JAX custom VJP does, so the backward never re-runs
the forward, and which launches K3b only when k or v needs a gradient; a
remat policy keeps its (out, lse) across a checkpoint boundary. delta = rowsum(dO * O) is a PyTorch reduction, as it is XLA
outside the kernel in the JAX package. Both
kernels are built like K1 (TMA ring, warp-specialised ``wgmma``, the second
product's P or dS from registers) and take lse and delta as f32 (B, H,
Sq_pad), padded to whole 128-row tiles (``bwd_stats``): TMA cannot cut one
head's column out of the packed (B, Sq, H) statistics.

K6 replaces ``_fwd_kernel_packed_int8`` (through ``_flash_fwd_packed_int8``):
SageAttention-style int8 attention, chosen with
``UNetConfig.attention_impl="int8"``. Built like K1, with ``wgmma`` on s8
operands, and with no per-score conversion on the pipe its exponentials use.
K smoothing and the Q, K and V quantizers, XLA ops outside the Pallas kernel
in the JAX package, are K6q on the card: one fused pass in two launches
(``quantize_int8``) that writes K6's operands, V8 transposed in K6's key
order (``K6_KEY_ORDER``). The same operator gives K6 the JAX package's
straight-through gradient: the exact K3a/K3b backward at K6's (out, lse).
"""

from __future__ import annotations

import contextlib
import ctypes
import functools
import math
from typing import Optional, Tuple

import torch

from .. import remat
from . import _build

_P = ctypes.c_void_p
PACKED, BHSD = "packed", "bhsd"  # (B, S, H*D) of K1; (B, H, S, D) of K5


# ---------------------------------------------------------------------------
# layouts
# ---------------------------------------------------------------------------


def _seq(t: torch.Tensor, layout: str) -> int:
    return t.shape[2] if layout == BHSD else t.shape[1]


def _head_dim(t: torch.Tensor, heads: int, layout: str) -> int:
    return t.shape[-1] if layout == BHSD else t.shape[-1] // heads


def _to_heads(t: torch.Tensor, heads: int, layout: str) -> torch.Tensor:
    """(B, H, S, D) f32 view of a tensor in ``layout``."""
    if layout == BHSD:
        return t.float()
    B, S, HD = t.shape
    return t.float().reshape(B, S, heads, HD // heads).transpose(1, 2)


def _from_heads(t: torch.Tensor, like: torch.Tensor, layout: str) -> torch.Tensor:
    """(B, H, S, D) back to ``layout``, in ``like``'s dtype."""
    if layout == BHSD:
        return t.to(like.dtype)
    B, H, S, D = t.shape
    return t.transpose(1, 2).reshape(B, S, H * D).to(like.dtype)


def _stat_from_heads(x: torch.Tensor, layout: str) -> torch.Tensor:
    """A per-row statistic (B, H, S) in ``layout``'s order: (B, S, H) packed."""
    return x if layout == BHSD else x.transpose(1, 2).contiguous()


def _stat_to_heads(x: torch.Tensor, layout: str) -> torch.Tensor:
    return x.float() if layout == BHSD else x.float().transpose(1, 2)


# ---------------------------------------------------------------------------
# K1 / K5: forward
# ---------------------------------------------------------------------------


def _plain_fwd(q, k, v, heads, scale, layout):
    if scale is None:
        scale = 1.0 / math.sqrt(_head_dim(q, heads, layout))
    qh, kh, vh = (_to_heads(t, heads, layout) for t in (q, k, v))
    logits = qh @ kh.transpose(-1, -2) * scale  # (B, H, Sq, Sk)
    lse = torch.logsumexp(logits, dim=-1)
    out = torch.exp(logits - lse[..., None]) @ vh
    return _from_heads(out, q, layout), _stat_from_heads(lse, layout)


def attention_packed_plain(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    heads: int,
    scale: Optional[float] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of K1, in f32: (out in q's dtype, lse f32)."""
    return _plain_fwd(q, k, v, heads, scale, PACKED)


def attention_plain(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    scale: Optional[float] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of K5 on (B, H, S, D), in f32: (out in q's
    dtype, lse (B, H, Sq) f32)."""
    return _plain_fwd(q, k, v, q.shape[1], scale, BHSD)


def xla_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: Optional[float] = None
) -> torch.Tensor:
    """The JAX package's ``xla_attention`` on (B, H, S, D): f32 logits and
    softmax, the probabilities cast to v's dtype before the second product,
    the output in q's dtype. ``attention(impl="xla")`` on CPU tensors."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    logits = q.float() @ k.float().transpose(-1, -2)
    probs = torch.softmax(logits * scale, dim=-1)
    return (probs.to(v.dtype).float() @ v.float()).to(q.dtype)


@functools.cache
def _fwd_entries():
    """The C entries of K1 and K5 by layout, built and loaded on first call,
    their signatures set once."""
    lib = _build.load("flash_attn_fwd")
    entries = {PACKED: lib.flash_attn_fwd_packed_bf16, BHSD: lib.flash_attn_fwd_bhsd_bf16}
    for fn in entries.values():
        fn.argtypes = [_P, _P, _P, _P, _P] + [ctypes.c_int] * 5 + [ctypes.c_float, _P]
        fn.restype = ctypes.c_int
    return entries


def _check_cuda_inputs(q, k, v, heads, layout=PACKED):
    if not (q.device == k.device == v.device):
        raise ValueError(f"q, k, v on different devices: {q.device}, {k.device}, {v.device}")
    ndim = 4 if layout == BHSD else 3
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.dtype != torch.bfloat16:
            raise TypeError(f"flash attention kernel takes bf16, got {name} {t.dtype}")
        if t.dim() != ndim or not t.is_contiguous() or t.data_ptr() % 16:
            form = "(B, H, S, D)" if layout == BHSD else "(B, S, H*D)"
            raise ValueError(f"{name} must be a contiguous, 16-byte aligned {form} tensor")
    if k.shape != v.shape or k.shape[0] != q.shape[0] or k.shape[-1] != q.shape[-1] or (
        layout == BHSD and k.shape[1] != q.shape[1]
    ):
        raise ValueError(f"shape mismatch: q {tuple(q.shape)}, k {tuple(k.shape)}, v {tuple(v.shape)}")
    if layout == BHSD:
        if q.shape[1] != heads or q.shape[-1] != 64:
            raise ValueError(f"flash attention kernel takes head_dim 64, got {q.shape[-1]}")
    elif q.shape[-1] % heads or q.shape[-1] // heads != 64:
        raise ValueError(f"flash attention kernel takes head_dim 64, got {q.shape[-1]}/{heads}")


def _fwd(wrapper, layout, q, k, v, heads, scale):
    """One forward in ``layout`` through ``wrapper``'s counts: the plain
    version for CPU tensors, the kernel for CUDA tensors."""
    if q.device.type == "cpu":
        wrapper.plain_calls += 1
        return _plain_fwd(q, k, v, heads, scale, layout)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    _check_cuda_inputs(q, k, v, heads, layout)
    B, Sq, Sk = q.shape[0], _seq(q, layout), _seq(k, layout)
    D = _head_dim(q, heads, layout)
    if scale is None:
        scale = 1.0 / math.sqrt(D)
    out = torch.empty_like(q)
    lse_shape = (B, heads, Sq) if layout == BHSD else (B, Sq, heads)
    lse = torch.empty(lse_shape, dtype=torch.float32, device=q.device)
    entry = _fwd_entries()[layout]
    with _build.on_device(q):
        err = entry(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), lse.data_ptr(),
            B, Sq, Sk, heads, D, float(scale), torch.cuda.current_stream(q.device).cuda_stream,
        )
    _build.check(err, entry.__name__)
    wrapper.launches += 1
    return out, lse


def flash_attention_packed_fwd(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    heads: int,
    scale: Optional[float] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """K1, packed attention forward: ``(out (B, Sq, H*D), lse (B, Sq, H) f32)``.

    CUDA tensors go to the kernel (bf16, head_dim 64, contiguous; anything
    else raises); CPU tensors to the plain version."""
    return _fwd(flash_attention_packed_fwd, PACKED, q, k, v, heads, scale)


def flash_attention_fwd(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    scale: Optional[float] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """K5, attention forward on (B, H, S, D): ``(out like q, lse (B, H, Sq)
    f32)``. CUDA tensors go to the kernel, CPU tensors to the plain version."""
    return _fwd(flash_attention_fwd, BHSD, q, k, v, q.shape[1], scale)


for _fn in (flash_attention_packed_fwd, flash_attention_fwd):
    _fn.launches = 0
    _fn.plain_calls = 0


# ---------------------------------------------------------------------------
# K3a / K3b: backward
# ---------------------------------------------------------------------------


def _bwd_plain_parts(q, k, v, do, lse, delta, heads, scale, want_dq, want_dkv, layout=PACKED):
    """The backward math in f32 from lse and delta: (dq, dk, dv), each in
    its input's dtype or None where not wanted."""
    qh, kh, vh, doh = (_to_heads(t, heads, layout) for t in (q, k, v, do))
    logits = qh @ kh.transpose(-1, -2) * scale  # (B, H, Sq, Sk)
    p = torch.exp(logits - _stat_to_heads(lse, layout)[..., None])
    ds = p * (doh @ vh.transpose(-1, -2) - _stat_to_heads(delta, layout)[..., None])
    dq = _from_heads(ds @ kh * scale, q, layout) if want_dq else None
    dk = _from_heads(ds.transpose(-1, -2) @ qh * scale, k, layout) if want_dkv else None
    dv = _from_heads(p.transpose(-1, -2) @ doh, v, layout) if want_dkv else None
    return dq, dk, dv


def _delta(out: torch.Tensor, do: torch.Tensor, heads: int, layout: str = PACKED) -> torch.Tensor:
    """delta = rowsum(dO * O) per head: (B, Sq, H) packed, (B, H, Sq) in
    (B, H, S, D); f32."""
    prod = do.float() * out.float()
    if layout == BHSD:
        return prod.sum(-1)
    B, Sq, HD = out.shape
    return prod.reshape(B, Sq, heads, HD // heads).sum(-1)


def attention_packed_bwd_plain(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    out: torch.Tensor,
    lse: torch.Tensor,
    do: torch.Tensor,
    heads: int,
    scale: Optional[float] = None,
    layout: str = PACKED,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of K3a and K3b, in f32, as the JAX backward:
    delta = rowsum(dO O), P = exp(q k^T scale - lse), dS = P (dO V^T - delta),
    dq = dS K scale, dk = dS^T Q scale, dv = P^T dO; outputs in the inputs'
    dtypes. ``layout`` "bhsd" takes K5's (B, H, S, D) tensors."""
    if scale is None:
        scale = 1.0 / math.sqrt(_head_dim(q, heads, layout))
    delta = _delta(out, do, heads, layout)
    return _bwd_plain_parts(q, k, v, do, lse, delta, heads, scale, True, True, layout)


# query rows per K3a/K3b tile: the kernels take lse and delta as f32 (B, H,
# Sq_pad), Sq_pad = Sq rounded up to this (the C entry flash_attn_bwd_rows)
BWD_ROWS = 128


@functools.cache
def _bwd_entries():
    """The C entries of K3a and K3b by layout, built and loaded on first call."""
    lib = _build.load("flash_attn_bwd")
    if lib.flash_attn_bwd_rows() != BWD_ROWS:
        raise RuntimeError(f"flash_attn_bwd.cu pads to {lib.flash_attn_bwd_rows()} rows, not {BWD_ROWS}")
    entries = {
        PACKED: (lib.flash_attn_bwd_dq_bf16, lib.flash_attn_bwd_dkv_bf16),
        BHSD: (lib.flash_attn_bwd_dq_bhsd_bf16, lib.flash_attn_bwd_dkv_bhsd_bf16),
    }
    for dq_fn, dkv_fn in entries.values():
        dq_fn.argtypes = [_P] * 7 + [ctypes.c_int] * 5 + [ctypes.c_float, _P]
        dkv_fn.argtypes = [_P] * 8 + [ctypes.c_int] * 5 + [ctypes.c_float, _P]
        dq_fn.restype = dkv_fn.restype = ctypes.c_int
    return entries


def _check_bwd_inputs(q, k, v, do, lse, delta, heads, layout):
    _check_cuda_inputs(q, k, v, heads, layout)
    if do.dtype != torch.bfloat16 or do.shape != q.shape or not do.is_contiguous() or do.data_ptr() % 16:
        raise ValueError(f"dO must be a contiguous, 16-byte aligned bf16 tensor shaped like q {tuple(q.shape)}")
    B, Sq = q.shape[0], _seq(q, layout)
    want = (B, heads, Sq) if layout == BHSD else (B, Sq, heads)
    for name, t in (("lse", lse), ("delta", delta)):
        if t is not None and (t.dtype != torch.float32 or t.shape != want or not t.is_contiguous()):
            raise ValueError(f"{name} must be a contiguous f32 {want} tensor")
    if not (q.device == do.device == lse.device) or (delta is not None and delta.device != q.device):
        raise ValueError("backward inputs on different devices")


def _padded_stat(x: torch.Tensor, value: float) -> torch.Tensor:
    """A per-row statistic (B, H, Sq) as the kernels take it: f32 (B, H,
    Sq_pad), the rows past Sq set to ``value``."""
    B, H, Sq = x.shape
    out = torch.full((B, H, -(-Sq // BWD_ROWS) * BWD_ROWS), value, dtype=torch.float32, device=x.device)
    out[..., :Sq] = x
    return out


def _padded_stats(lse: torch.Tensor, delta: torch.Tensor, layout: str) -> Tuple[torch.Tensor, torch.Tensor]:
    """The wrappers' lse and delta in ``layout``'s order as the kernels take
    them: lse padded with +inf, delta with 0."""
    return _padded_stat(_stat_to_heads(lse, layout), math.inf), _padded_stat(_stat_to_heads(delta, layout), 0.0)


def bwd_stats(out: torch.Tensor, do: torch.Tensor, lse: torch.Tensor, heads: int,
              layout: str = PACKED) -> Tuple[torch.Tensor, torch.Tensor]:
    """K3a/K3b's statistics from the forward's out and lse and the incoming
    dO: lse (transposed from (B, Sq, H) when packed) and delta = rowsum(dO *
    O), computed straight into the same layout, as f32 (B, H, Sq_pad), Sq_pad
    = Sq rounded up to BWD_ROWS. Padded rows hold lse +inf, so P = 0 there,
    and delta 0."""
    lse_p = _padded_stat(_stat_to_heads(lse, layout), math.inf)
    delta_p = torch.zeros_like(lse_p)
    prod = _to_heads(do, heads, layout) * _to_heads(out, heads, layout)
    torch.sum(prod, dim=-1, out=delta_p[..., :prod.shape[2]])
    return lse_p, delta_p


def _bwd_args(q, k, heads, scale, layout):
    """The heads, scale and trailing C arguments of one backward launch."""
    if layout == BHSD:
        heads = q.shape[1]
    D = _head_dim(q, heads, layout)
    if scale is None:
        scale = 1.0 / math.sqrt(D)
    dims = (q.shape[0], _seq(q, layout), _seq(k, layout), heads, D, float(scale),
            torch.cuda.current_stream(q.device).cuda_stream) if q.device.type == "cuda" else ()
    return heads, scale, dims


def _launch_bwd(want_dq, q, k, v, do, lse_p, delta_p, dims, layout):
    """One K3a (``want_dq``: returns (dq,)) or K3b (returns (dk, dv)) launch
    on checked CUDA inputs and ``bwd_stats``-shaped statistics, counted on
    its wrapper."""
    dq_fn, dkv_fn = _bwd_entries()[layout]
    entry, wrapper = (dq_fn, flash_attention_packed_bwd_dq) if want_dq else (dkv_fn, flash_attention_packed_bwd_dkv)
    outs = (torch.empty_like(q),) if want_dq else (torch.empty_like(k), torch.empty_like(v))
    with _build.on_device(q):
        err = entry(q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse_p.data_ptr(),
                    delta_p.data_ptr(), *(t.data_ptr() for t in outs), *dims)
    _build.check(err, entry.__name__)
    wrapper.launches += 1
    return outs


def flash_attention_packed_bwd_dq(q, k, v, do, lse, delta, heads, scale=None, layout=PACKED) -> torch.Tensor:
    """K3a: dq, like q, from q, k, v, dO, lse and delta (packed: (B, Sq, H);
    ``layout`` "bhsd": (B, H, Sq), heads read from q). CUDA tensors go to the
    kernel (anything it does not take raises), lse and delta padded as
    ``bwd_stats`` lays them out; CPU tensors to the plain version."""
    heads, scale, dims = _bwd_args(q, k, heads, scale, layout)
    if q.device.type == "cpu":
        flash_attention_packed_bwd_dq.plain_calls += 1
        return _bwd_plain_parts(q, k, v, do, lse, delta, heads, scale, True, False, layout)[0]
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    _check_bwd_inputs(q, k, v, do, lse, delta, heads, layout)
    return _launch_bwd(True, q, k, v, do, *_padded_stats(lse, delta, layout), dims, layout)[0]


def flash_attention_packed_bwd_dkv(q, k, v, do, lse, delta, heads, scale=None, layout=PACKED):
    """K3b: (dk, dv), each like k, from the same inputs as K3a."""
    heads, scale, dims = _bwd_args(q, k, heads, scale, layout)
    if q.device.type == "cpu":
        flash_attention_packed_bwd_dkv.plain_calls += 1
        return _bwd_plain_parts(q, k, v, do, lse, delta, heads, scale, False, True, layout)[1:]
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    _check_bwd_inputs(q, k, v, do, lse, delta, heads, layout)
    return _launch_bwd(False, q, k, v, do, *_padded_stats(lse, delta, layout), dims, layout)


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
    layout: str = PACKED,
):
    """Attention backward: (dq, dk, dv), None where not needed. delta is a
    PyTorch reduction (on the card straight into the kernels' padded layout,
    ``bwd_stats``); K3a runs when dq is needed, K3b when dk and dv are.
    ``layout`` "bhsd" takes K5's (B, H, S, D) tensors."""
    if q.device.type != "cuda":
        delta = _delta(out, do, heads, layout)
        args = (q, k, v, do, lse, delta, heads, scale)
        dq = flash_attention_packed_bwd_dq(*args, layout=layout) if need_dq else None
        dk = dv = None
        if need_dkv:
            dk, dv = flash_attention_packed_bwd_dkv(*args, layout=layout)
        return dq, dk, dv
    heads, scale, dims = _bwd_args(q, k, heads, scale, layout)
    _check_bwd_inputs(q, k, v, do, lse, None, heads, layout)
    stats = bwd_stats(out, do, lse, heads, layout)
    dq = _launch_bwd(True, q, k, v, do, *stats, dims, layout)[0] if need_dq else None
    dk, dv = _launch_bwd(False, q, k, v, do, *stats, dims, layout) if need_dkv else (None, None)
    return dq, dk, dv


# The differentiable forward is one custom operator, ``mvd_tpu_torch::flash_fwd``,
# returning (out, lse): K1 (kind "packed"), K5 ("bhsd") or K6 ("int8"). A
# remat policy keeps its (out, lse), as the JAX package names them
# "flash_out" / "flash_lse" in its custom-VJP forward rules, so that the
# recompute never launches it again (``nn/unet.py``): through the block's
# tape (``mvd_tpu_torch/remat.py``), consulted below autograd, so that the
# recompute still builds the operator's autograd node; and, as an operator
# rather than a Python autograd.Function, through PyTorch's selective
# checkpointing under ``flash_conv_dots``. Its backward is the exact K3a/K3b
# at the saved (out, lse) in the forward's layout; for K6 that is the JAX
# package's straight-through gradient.
FLASH_KINDS = (PACKED, BHSD, "int8")


@torch.library.custom_op("mvd_tpu_torch::flash_fwd", mutates_args=())
def flash_fwd_op(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    heads: int,
    scale: Optional[float],
    kind: str,
    block_k: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(out, lse) of K1, K5 or K6 through their counted wrappers; inside a
    remat'd block, the forward's (out, lse) kept on its tape
    (``mvd_tpu_torch/remat.py``), which the recompute takes back."""
    tape = remat.active()
    if tape is not None and tape.replaying:
        return tuple(t.detach() for t in tape.take())
    if kind == "int8":
        out = flash_attention_packed_int8_fwd(q, k, v, heads, scale, block_k)
    elif kind == BHSD:
        out = flash_attention_fwd(q, k, v, scale)
    else:
        out = flash_attention_packed_fwd(q, k, v, heads, scale)
    if tape is not None:
        tape.keep(tuple(t.detach() for t in out))
    return out


def _flash_fwd_setup(ctx, inputs, output):
    q, k, v, heads, scale, kind, _ = inputs
    out, lse = output
    ctx.save_for_backward(q, k, v, out, lse)
    ctx.heads, ctx.scale, ctx.kind = heads, scale, kind
    ctx.mark_non_differentiable(lse)


def _flash_fwd_backward(ctx, do, _dlse):
    q, k, v, out, lse = ctx.saved_tensors
    heads, layout = (q.shape[1], BHSD) if ctx.kind == BHSD else (ctx.heads, PACKED)
    need_q, need_k, need_v = ctx.needs_input_grad[:3]
    dq, dk, dv = flash_attention_packed_bwd(
        q, k, v, out, lse, do.contiguous(), heads, ctx.scale,
        need_dq=need_q, need_dkv=need_k or need_v, layout=layout,
    )
    return dq, dk if need_k else None, dv if need_v else None, None, None, None, None


flash_fwd_op.register_autograd(_flash_fwd_backward, setup_context=_flash_fwd_setup)


def _flash_diff(q, k, v, heads, scale, kind, block_k=0):
    return torch.ops.mvd_tpu_torch.flash_fwd(q, k, v, heads, scale, kind, block_k)[0]


def _wants_grad(*ts: torch.Tensor) -> bool:
    return torch.is_grad_enabled() and any(t.requires_grad for t in ts)


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Flash attention on (B, H, S, D), any lengths, non-causal;
    differentiable in q, k, v (K5 forward, K3a/K3b backward)."""
    if _wants_grad(q, k, v):
        return _flash_diff(q, k, v, q.shape[1], scale, BHSD)
    return flash_attention_fwd(q, k, v, scale)[0]


# ---------------------------------------------------------------------------
# K6: int8 forward (SageAttention-style) and its quantizers
# ---------------------------------------------------------------------------

_LOG127 = float(math.log(127.0))
_INV127 = 1.0 / 127.0  # a multiply by this constant, as the JAX package does, not / 127
# the JAX package's blocks: block_q tiles the rows only, block_k also groups
# the keys P is quantized over
INT8_BLOCK_Q, INT8_BLOCK_K = 512, 1024


def smooth_k(k: torch.Tensor, heads: int) -> torch.Tensor:
    """K minus its per-head mean over the sequence, f32 (B, Sk, H*D): a
    row-constant score offset that softmax does not see."""
    B, Sk, HD = k.shape
    k4 = k.float().reshape(B, Sk, heads, HD // heads)
    return (k4 - k4.mean(dim=1, keepdim=True)).reshape(B, Sk, HD)


def quantize_rows(x: torch.Tensor, heads: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(B, S, H*D) -> int8 with per-(batch, token, head) scales (B, S, H)."""
    B, S, HD = x.shape
    xb = x.float().reshape(B, S, heads, HD // heads)
    scale = torch.clamp(xb.abs().amax(dim=3), min=1e-6) * _INV127
    q8 = torch.round(xb / scale[..., None]).to(torch.int8)
    return q8.reshape(B, S, HD), scale


def quantize_heads(x: torch.Tensor, heads: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(B, S, H*D) -> int8 with per-(batch, head) scales over the whole
    sequence, (B, 1, H)."""
    B, S, HD = x.shape
    xb = x.float().reshape(B, S, heads, HD // heads)
    scale = torch.clamp(xb.abs().amax(dim=(1, 3), keepdim=True), min=1e-6) * _INV127
    q8 = torch.round(xb / scale).to(torch.int8)
    return q8.reshape(B, S, HD), scale[:, :, :, 0]


def quantize_channels(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(B, S, H*D) -> int8 with per-(batch, channel) scales (B, 1, H*D)."""
    xf = x.float()
    scale = torch.clamp(xf.abs().amax(dim=1, keepdim=True), min=1e-6) * _INV127
    return torch.round(xf / scale).to(torch.int8), scale


def _quantize_int8(q, k, v, heads):
    """K6's operands as the JAX package makes them: (q8, sq), (k8, sk) of
    the smoothed K, (v8, sv)."""
    return quantize_rows(q, heads), quantize_heads(smooth_k(k, heads), heads), quantize_channels(v)


# K6's key order (csrc/flash_attn_int8.cu): within every 16-key block of
# V8^T, position 4t + i holds key 8 (i // 2) + 2t + i % 2, the order in which
# the score accumulator's keys pack into P8's register fragments
K6_KEY_ORDER = tuple(8 * (i // 2) + 2 * t + i % 2 for t in range(4) for i in range(4))


def _key_order_index(Sk: int, device) -> torch.Tensor:
    """Position -> key over Sk keys (a multiple of 16) in K6's key order."""
    if Sk % 16:
        raise ValueError(f"K6's key order takes whole 16-key blocks; got Sk {Sk}")
    order = torch.tensor(K6_KEY_ORDER, device=device)
    return (torch.arange(0, Sk, 16, device=device)[:, None] + order).reshape(-1)


def v8_to_key_order(v8: torch.Tensor) -> torch.Tensor:
    """(B, Sk, H*D) int8 -> K6's V8^T: (B, H*D, Sk), keys in K6's order."""
    return v8.transpose(1, 2)[..., _key_order_index(v8.shape[1], v8.device)].contiguous()


def v8_from_key_order(v8t: torch.Tensor) -> torch.Tensor:
    """K6's V8^T back to (B, Sk, H*D) in the keys' own order."""
    v8 = torch.empty_like(v8t)
    v8[..., _key_order_index(v8t.shape[-1], v8t.device)] = v8t
    return v8.transpose(1, 2)


def quantize_int8_plain(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, heads: int
) -> Tuple[torch.Tensor, ...]:
    """Plain PyTorch version of K6q: K6's operands (q8, k8, v8t, sq, sk, sv)
    from q, k, v (B, S, H*D), the JAX package's quantizers
    (``_quantize_int8``) in K6's layout: V8 as ``v8_to_key_order`` gives
    it, sk (B, H), sv (B, H*D)."""
    B, _, HD = k.shape
    (q8, sq), (k8, sk), (v8, sv) = _quantize_int8(q, k, v, heads)
    return q8, k8, v8_to_key_order(v8), sq, sk.reshape(B, heads), sv.reshape(B, HD)


@functools.cache
def _quantize_entry():
    """The C entry of K6q, built and loaded on first call, and the keys per
    stats CTA it takes (its scratch is B * ceil(Sk / that) * 4 * H*D f32)."""
    lib = _build.load("quantize_int8")
    fn = lib.quantize_int8
    fn.argtypes = [_P] * 10 + [ctypes.c_int] * 5 + [_P]
    fn.restype = ctypes.c_int
    return fn, lib.quantize_int8_stat_rows()


def quantize_scratch(B: int, Sk: int, hd: int, device) -> torch.Tensor:
    """K6q's scratch for its per-split channel statistics."""
    return torch.empty(B * -(-Sk // _quantize_entry()[1]) * 4 * hd, dtype=torch.float32, device=device)


def quantize_int8(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, heads: int) -> Tuple[torch.Tensor, ...]:
    """K6q, K6's quantizers as one fused pass (two launches): (q8, k8, v8t,
    sq, sk, sv) from bf16 q (B, Sq, H*D) and k, v (B, Sk, H*D), in K6's
    layout (``quantize_int8_plain`` says what each is). CUDA tensors go to
    the kernel (bf16, head_dim 64, contiguous, Sq and Sk multiples of 128;
    anything else raises); CPU tensors to the plain version."""
    if q.device.type == "cpu":
        quantize_int8.plain_calls += 1
        return quantize_int8_plain(q, k, v, heads)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    _check_cuda_inputs(q, k, v, heads)
    B, Sq, HD = q.shape
    Sk = k.shape[1]
    if Sq % 128 or Sk % 128:
        raise ValueError(f"K6q takes whole 128-row tiles; got Sq {Sq}, Sk {Sk}")
    dev = q.device
    ops = (torch.empty((B, Sq, HD), dtype=torch.int8, device=dev),
           torch.empty((B, Sk, HD), dtype=torch.int8, device=dev),
           torch.empty((B, HD, Sk), dtype=torch.int8, device=dev),
           torch.empty((B, Sq, heads), dtype=torch.float32, device=dev),
           torch.empty((B, heads), dtype=torch.float32, device=dev),
           torch.empty((B, HD), dtype=torch.float32, device=dev))
    q8, k8, v8t, sq, sk, sv = ops
    scratch = quantize_scratch(B, Sk, HD, dev)
    with _build.on_device(q):
        err = _quantize_entry()[0](
            q.data_ptr(), k.data_ptr(), v.data_ptr(), q8.data_ptr(), sq.data_ptr(), k8.data_ptr(),
            sk.data_ptr(), v8t.data_ptr(), sv.data_ptr(), scratch.data_ptr(), B, Sq, Sk, heads,
            HD // heads, torch.cuda.current_stream(dev).cuda_stream,
        )
    _build.check(err, "quantize_int8")
    quantize_int8.launches += 1
    return ops


quantize_int8.launches = 0
quantize_int8.plain_calls = 0


def int8_tiles(Sq: int, Sk: int, block_k: int = INT8_BLOCK_K) -> bool:
    """Whether (Sq, Sk) tile into the int8 kernel's whole blocks (the JAX
    ``flash_attention_packed_int8`` condition)."""
    bq, bk = min(INT8_BLOCK_Q, Sq), min(block_k, Sk)
    return Sq > 0 and Sk > 0 and not (Sq % bq or Sk % bk or Sq % 128 or Sk % 128)


def int8_site(Sq: int, Sk: int) -> bool:
    """Whether ``attention_packed(impl="int8")`` quantizes a site: the JAX
    package's routing on the TPU (``Sq >= 1024`` and ``Sk >= 128``, then
    whole tiles); every other site runs exact attention."""
    return Sq >= 1024 and Sk >= 128 and int8_tiles(Sq, Sk)


@contextlib.contextmanager
def _exact_f32_matmul():
    """f32 matmuls without TF32, so products of integer-valued f32 tensors
    stay exact on the card."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def _int8_core(q8, k8, v8, sq, sk, sv, heads, scale, block_k, out_dtype):
    """The int8 attention on quantized operands, V8 (B, Sk, H*D) in the keys'
    own order: (out in ``out_dtype``, lse (B, Sq, H) f32)."""
    B, Sq, HD = q8.shape
    Sk = k8.shape[1]
    D = HD // heads
    group = min(block_k, Sk)
    if Sk % group:
        raise ValueError(f"Sk {Sk} is not a whole number of {group}-key groups")
    qh, kh, vh = (_to_heads(t, heads, PACKED) for t in (q8, k8, v8))
    sqv = sq.transpose(1, 2)[..., None] * (sk[:, :, None, None] * scale)  # (B, H, Sq, 1)
    svh = sv.reshape(B, heads, 1, D)
    m = torch.full((B, heads, Sq, 1), -math.inf, device=q8.device)
    l = torch.zeros((B, heads, Sq, 1), device=q8.device)
    acc = torch.zeros((B, heads, Sq, D), device=q8.device)
    with _exact_f32_matmul():
        for g0 in range(0, Sk, group):
            s = (qh @ kh[:, :, g0:g0 + group].transpose(-1, -2)) * sqv
            m_loc = s.amax(dim=-1, keepdim=True)
            m_new = torch.maximum(m, m_loc)
            p8 = torch.trunc(torch.exp(s - m_loc + _LOG127) + 0.5)  # the int8 cast truncates
            pv = p8 @ vh[:, :, g0:g0 + group]
            alpha = torch.exp(m - m_new)
            gamma = torch.exp(m_loc - m_new) * _INV127
            l = alpha * l + p8.sum(dim=-1, keepdim=True) * gamma
            acc = acc * alpha + (pv * gamma) * svh
            m = m_new
    out = (acc / l).transpose(1, 2).reshape(B, Sq, HD).to(out_dtype)
    return out, _stat_from_heads((m + torch.log(l))[..., 0], PACKED)


def attention_int8_core_plain(
    ops: Tuple[torch.Tensor, ...],
    heads: int,
    scale: Optional[float] = None,
    block_k: int = INT8_BLOCK_K,
    out_dtype: torch.dtype = torch.bfloat16,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of K6 on its operands (q8, k8, v8t, sq, sk, sv)
    in the kernel's layout (``quantize_int8``), as ``_fwd_kernel_packed_int8``
    computes it: (out in ``out_dtype``, the kernel's bf16 by default; lse
    (B, Sq, H) f32).

    P is quantized against the row max of each ``min(block_k, Sk)``-key
    group, the TPU kernel's k-block. The integer products run as f32
    matmuls of integer-valued tensors, exact: Q8 K8^T sums stay below
    127² · D and the group's P8 V8 sums below 127² · 1024 < 2^24, so the
    key order of V8^T changes nothing."""
    q8, k8, v8t, sq, sk, sv = ops
    if scale is None:
        scale = 1.0 / math.sqrt(q8.shape[-1] // heads)
    return _int8_core(q8, k8, v8_from_key_order(v8t), sq, sk, sv, heads, scale, block_k, out_dtype)


def attention_packed_int8_plain(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    heads: int,
    scale: Optional[float] = None,
    block_k: int = INT8_BLOCK_K,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of K6 with its quantizers, as
    ``_flash_fwd_packed_int8`` computes it: (out in q's dtype, lse (B, Sq, H)
    f32), from the JAX package's quantizers (``_quantize_int8``) and the
    plain core (``attention_int8_core_plain``'s arithmetic)."""
    B, Sq, HD = q.shape
    if scale is None:
        scale = 1.0 / math.sqrt(HD // heads)
    (q8, sq), (k8, sk), (v8, sv) = _quantize_int8(q, k, v, heads)
    return _int8_core(q8, k8, v8, sq, sk.reshape(B, heads), sv.reshape(B, HD), heads, scale,
                      block_k, q.dtype)


@functools.cache
def _int8_entry():
    """The C entry of K6, built and loaded on first call."""
    fn = _build.load("flash_attn_int8").flash_attn_fwd_int8
    fn.argtypes = [_P] * 8 + [ctypes.c_int] * 6 + [ctypes.c_float, _P]
    fn.restype = ctypes.c_int
    return fn


def launch_int8(ops, heads: int, scale: Optional[float] = None, block_k: int = INT8_BLOCK_K):
    """One K6 launch on ``quantize_int8``'s output: (out bf16 (B, Sq, H*D),
    lse (B, Sq, H) f32). Counts nothing: ``flash_attention_packed_int8_fwd``
    counts its launches."""
    q8, k8, v8t, sq, sk, sv = ops
    B, Sq, HD = q8.shape
    Sk, D = k8.shape[1], HD // heads
    if scale is None:
        scale = 1.0 / math.sqrt(D)
    out = torch.empty((B, Sq, HD), dtype=torch.bfloat16, device=q8.device)
    lse = torch.empty((B, Sq, heads), dtype=torch.float32, device=q8.device)
    with _build.on_device(q8):
        err = _int8_entry()(
            q8.data_ptr(), k8.data_ptr(), v8t.data_ptr(), sq.data_ptr(), sk.data_ptr(),
            sv.data_ptr(), out.data_ptr(), lse.data_ptr(), B, Sq, Sk, heads, D,
            min(block_k, Sk), float(scale), torch.cuda.current_stream(q8.device).cuda_stream,
        )
    _build.check(err, "flash_attn_fwd_int8")
    return out, lse


def flash_attention_packed_int8_fwd(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    heads: int,
    scale: Optional[float] = None,
    block_k: int = INT8_BLOCK_K,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """K6, int8 packed attention forward: ``(out (B, Sq, H*D), lse (B, Sq, H)
    f32)``, its operands made by K6q (``quantize_int8``). Raises on lengths
    that do not tile (``int8_tiles``). CUDA tensors go to the kernels (bf16,
    head_dim 64, contiguous, key groups of a multiple of 64; anything else
    raises); CPU tensors to the plain version (``attention_packed_int8_plain``)."""
    Sq, Sk = q.shape[1], k.shape[1]
    if not int8_tiles(Sq, Sk, block_k):
        raise ValueError(f"int8 attention takes whole tiles; got Sq {Sq}, Sk {Sk}, block_k {block_k}")
    if q.device.type == "cpu":
        flash_attention_packed_int8_fwd.plain_calls += 1
        return attention_packed_int8_plain(q, k, v, heads, scale, block_k)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    _check_cuda_inputs(q, k, v, heads)
    if min(block_k, Sk) % 64:
        raise ValueError(f"the int8 kernel takes key groups of a multiple of 64; got {min(block_k, Sk)}")
    out, lse = launch_int8(quantize_int8(q, k, v, heads), heads, scale, block_k)
    flash_attention_packed_int8_fwd.launches += 1
    return out, lse


flash_attention_packed_int8_fwd.launches = 0
flash_attention_packed_int8_fwd.plain_calls = 0


def flash_attention_packed_int8(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    heads: int,
    scale: Optional[float] = None,
    block_k: int = INT8_BLOCK_K,
) -> torch.Tensor:
    """int8 attention on the packed layout, differentiable (straight
    through). Lengths that do not tile run the exact packed attention (K1),
    as the JAX ``flash_attention_packed_int8`` does."""
    if not int8_tiles(q.shape[1], k.shape[1], block_k):
        return _attention_exact(q, k, v, heads, scale)
    if _wants_grad(q, k, v):
        return _flash_diff(q, k, v, heads, scale, "int8", block_k)
    return flash_attention_packed_int8_fwd(q, k, v, heads, scale, block_k)[0]


# ---------------------------------------------------------------------------
# public entries
# ---------------------------------------------------------------------------

ATTENTION_IMPLS = ("auto", "pallas", "xla", "int8")
_INTERPRET = ("pallas_interpret", "int8_interpret")


def check_impl(impl: str) -> str:
    """``impl`` if the port runs it; the JAX package's CPU-interpret choices
    have no counterpart on the card."""
    if impl in _INTERPRET:
        raise ValueError(f"attention impl {impl!r} is a CPU-interpret mode of the JAX package; "
                         f"the port takes one of {ATTENTION_IMPLS}")
    if impl not in ATTENTION_IMPLS:
        raise ValueError(f"unknown attention impl {impl!r}; the port takes one of {ATTENTION_IMPLS}")
    return impl


def _attention_exact(q, k, v, heads, scale):
    if _wants_grad(q, k, v):
        return _flash_diff(q, k, v, heads, scale, PACKED)
    return flash_attention_packed_fwd(q, k, v, heads, scale)[0]


def attention_packed(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    heads: int,
    scale: Optional[float] = None,
    impl: str = "auto",
) -> torch.Tensor:
    """Multi-head attention on the packed (B, S, H*D) layout (the output of
    the q/k/v projections, no head transposes); differentiable in q, k, v.

    ``impl`` "auto", "pallas" and "xla" are exact attention (K1); "int8"
    quantizes the sites the JAX package quantizes on the TPU
    (``int8_site``: K6, straight-through gradient) and runs K1 at the
    others."""
    if check_impl(impl) == "int8" and int8_site(q.shape[1], k.shape[1]):
        return flash_attention_packed_int8(q, k, v, heads, scale)
    return _attention_exact(q, k, v, heads, scale)


def attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    impl: str = "auto",
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Attention on (B, H, S, D), the JAX kernels package's entry point.
    CUDA tensors run K5 for "auto", "pallas" and "xla" alike; CPU tensors
    take ``xla_attention`` for "xla" and K5's plain version otherwise."""
    if impl not in ("auto", "pallas", "xla"):
        raise ValueError(f"attention impl {impl!r}: (B, H, S, D) attention takes auto, pallas or xla")
    if impl == "xla" and q.device.type == "cpu":
        return xla_attention(q, k, v, scale)
    return flash_attention(q, k, v, scale)
