"""Ring attention over a sharded view axis (K4), and its merge kernel K4m
(``csrc/ring_merge.cu``).

Counterpart of ``mvd_tpu/kernels/ring_attention.py``: exact (non-causal)
attention of each rank's queries over the keys and values of every rank of
a process group, in the packed (B, S_local, H*D) layout, with no head
transposes:

  * forward (``_ring_fwd`` there): hop 0 is K1 (``flash_attention_packed_fwd``:
    out, lse) on the local K/V; then n - 1 times the K/V shard goes from
    rank r to r + 1 and comes from r - 1 (``dist.batch_isend_irecv`` in the
    group; the next hop's exchange is posted before this hop's K1, so the
    two overlap), K1 runs on it and K4m merges its (out, lse) into the f32
    running pair; at the end out is cast to q's dtype;
  * backward (``_ring_bwd_impl``): delta = rowsum(dO * O) once, from the
    global out; n hops of K3a/K3b at the global lse, so that each hop's
    P = exp(S - lse) is the global softmax restricted to its keys; dq adds
    up in f32, and the f32 dk/dv accumulators travel the ring with their
    K/V, home after n rotations. These adds are PyTorch, as they are XLA in
    JAX.

The differentiable entry is one custom operator, ``mvd_tpu_torch::ring_fwd``
(the JAX package's custom VJP over the whole ring): its forward keeps the
global (out, lse) on a remat'd block's tape, as K1's operator does, so a
recompute never runs the ring again; under ``flash_conv_dots`` PyTorch's
selective checkpointing saves its outputs. ``ring_attention_virtual_fwd`` /
``_bwd`` run n virtual ranks in one process on lists of shards, with the
same calls per hop: ``chip_smoke.py`` and the tests hold them against
unsharded attention and the process-group ring; nothing on the model path
calls them.

K4m (``ring_merge``) replaces ``_merge`` (:104-117): the online-softmax merge
of one hop's (o_i bf16, lse_i) into the running (o f32, lse), in place;
bound by its bytes (the source's header says more). ``ring_merge_plain`` is
the same f32 formula in PyTorch, which CPU tensors take.

As in JAX, the ring never takes the int8 path: every hop is exact
attention, whatever the model's ``attention_impl`` (the JAX ring's
``_use_flash_hop`` sends every impl but "xla" to the exact flash kernel).
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from .. import remat
from . import _build
from .flash_attention import (
    PACKED,
    _bwd_args,
    _check_bwd_inputs,
    _delta,
    _launch_bwd,
    bwd_stats,
    flash_attention_packed_bwd_dkv,
    flash_attention_packed_bwd_dq,
    flash_attention_packed_fwd,
)

_P = ctypes.c_void_p


# ---------------------------------------------------------------------------
# K4m: the merge
# ---------------------------------------------------------------------------


@torch.no_grad()
def ring_merge_plain(o: torch.Tensor, lse: torch.Tensor, o_i: torch.Tensor, lse_i: torch.Tensor,
                     heads: int) -> None:
    """K4m's function in PyTorch, in place on the f32 (o (B, S, H*D), lse
    (B, S, H)): m = max(lse, lse_i), w = exp(lse - m), w_i = exp(lse_i - m),
    o = (o w + o_i w_i) / (w + w_i) per head, lse = m + log(w + w_i)."""
    B, S, HD = o.shape
    m = torch.maximum(lse, lse_i)
    w, w_i = torch.exp(lse - m), torch.exp(lse_i - m)
    den = w + w_i
    heads_of = lambda t: t.view(B, S, heads, HD // heads)
    mixed = heads_of(o) * w[..., None] + heads_of(o_i.float()) * w_i[..., None]
    heads_of(o).copy_(mixed / den[..., None])
    lse.copy_(m + torch.log(den))


@functools.cache
def _merge_entry():
    fn = _build.load("ring_merge").ring_merge
    fn.argtypes = [_P, _P, _P, _P, ctypes.c_longlong, ctypes.c_int, _P]
    fn.restype = ctypes.c_int
    return fn


def _check_merge_inputs(o, lse, o_i, lse_i, heads):
    B, S, HD = o.shape
    if HD % heads or (HD // heads) % 4 or (HD // heads) // 4 not in (1, 2, 4, 8, 16, 32):
        raise ValueError(f"K4m takes head widths of 4 to 128 in powers of two, got {HD}/{heads}")
    for name, t, dtype, shape in (("o", o, torch.float32, (B, S, HD)),
                                  ("lse", lse, torch.float32, (B, S, heads)),
                                  ("o_i", o_i, torch.bfloat16, (B, S, HD)),
                                  ("lse_i", lse_i, torch.float32, (B, S, heads))):
        if t.dtype != dtype or tuple(t.shape) != shape or not t.is_contiguous():
            raise ValueError(f"K4m: {name} must be a contiguous {dtype} {shape} tensor, got "
                             f"{t.dtype} {tuple(t.shape)}")
        if t.device != o.device:
            raise ValueError(f"K4m: {name} on {t.device}, o on {o.device}")
    if o.data_ptr() % 16 or o_i.data_ptr() % 8:
        raise ValueError("K4m: o must be 16-byte and o_i 8-byte aligned")


def ring_merge(o: torch.Tensor, lse: torch.Tensor, o_i: torch.Tensor, lse_i: torch.Tensor,
               heads: int) -> None:
    """K4m: merge one hop's (o_i, lse_i) into the running (o, lse), in
    place. CUDA tensors go to the kernel (o and lse f32, o_i bf16 as K1
    writes it, lse_i f32; anything else raises); CPU tensors to
    ``ring_merge_plain``."""
    if o.device.type == "cpu":
        ring_merge.plain_calls += 1
        ring_merge_plain(o, lse, o_i, lse_i, heads)
        return
    if o.device.type != "cuda":
        raise ValueError(f"unsupported device {o.device}")
    _check_merge_inputs(o, lse, o_i, lse_i, heads)
    entry = _merge_entry()
    B, S, HD = o.shape
    with _build.on_device(o):
        err = entry(o.data_ptr(), lse.data_ptr(), o_i.data_ptr(), lse_i.data_ptr(), B * S * heads,
                    HD // heads, torch.cuda.current_stream(o.device).cuda_stream)
    _build.check(err, "ring_merge")
    ring_merge.launches += 1


ring_merge.launches = 0
ring_merge.plain_calls = 0


# ---------------------------------------------------------------------------
# the calls of one hop, shared by the process-group ring and the virtual one
# ---------------------------------------------------------------------------


def _scale(q: torch.Tensor, heads: int, scale: Optional[float]) -> float:
    return 1.0 / math.sqrt(q.shape[-1] // heads) if scale is None else float(scale)


def _start(q, k, v, heads, scale):
    """Hop 0: K1 on the local K/V; the f32 running (out, lse)."""
    out, lse = flash_attention_packed_fwd(q, k, v, heads, scale)
    return out.float(), lse


def _hop_fwd(o, lse, q, k, v, heads, scale) -> None:
    """One later hop: K1 on (k, v), merged into (o, lse) by K4m."""
    o_i, lse_i = flash_attention_packed_fwd(q, k, v, heads, scale)
    ring_merge(o, lse, o_i, lse_i, heads)


def _bwd_stats(q, k, v, out, do, lse, heads):
    """The statistics every hop of a rank's backward shares: lse and delta
    = rowsum(dO * O), padded for K3a/K3b on the card, where the inputs are
    checked once (every K/V shard of a ring has k's shape)."""
    if q.device.type == "cuda":
        _check_bwd_inputs(q, k, v, do, lse, None, heads, PACKED)
        return bwd_stats(out, do, lse, heads)
    return lse, _delta(out, do, heads)


def _hop_bwd(q, k, v, do, stats, heads, scale):
    """K3a and K3b of one hop: (dq, dk, dv) of this hop's keys, each in its
    input's dtype."""
    if q.device.type == "cuda":
        _, _, dims = _bwd_args(q, k, heads, scale, PACKED)
        dq = _launch_bwd(True, q, k, v, do, *stats, dims, PACKED)[0]
        dk, dv = _launch_bwd(False, q, k, v, do, *stats, dims, PACKED)
        return dq, dk, dv
    dq = flash_attention_packed_bwd_dq(q, k, v, do, *stats, heads, scale)
    dk, dv = flash_attention_packed_bwd_dkv(q, k, v, do, *stats, heads, scale)
    return dq, dk, dv


# ---------------------------------------------------------------------------
# the ring over a process group
# ---------------------------------------------------------------------------


def _post(tensors: Sequence[torch.Tensor], axis):
    """Send ``tensors`` to the next rank of ``axis`` and receive the previous
    rank's into new buffers: (the pending works, the buffers)."""
    n, i = axis.size, axis.index
    nxt, prv = axis.ranks[(i + 1) % n], axis.ranks[(i - 1) % n]
    bufs = [torch.empty_like(t) for t in tensors]
    ops = [dist.P2POp(dist.isend, t.contiguous(), nxt, axis.group) for t in tensors]
    ops += [dist.P2POp(dist.irecv, b, prv, axis.group) for b in bufs]
    return dist.batch_isend_irecv(ops), bufs


def _wait(pending):
    works, bufs = pending
    for w in works:
        w.wait()
    return bufs


def ring_fwd(q, k, v, heads: int, axis, scale: Optional[float] = None):
    """The ring forward on this rank: (out like q, lse (B, S, H) f32)."""
    scale = _scale(q, heads, scale)
    n = axis.size
    pending = _post((k, v), axis) if n > 1 else None
    o, lse = _start(q, k, v, heads, scale)
    for hop in range(1, n):
        kc, vc = _wait(pending)
        pending = _post((kc, vc), axis) if hop < n - 1 else None
        _hop_fwd(o, lse, q, kc, vc, heads, scale)
    return o.to(q.dtype), lse


def ring_bwd(q, k, v, out, lse, do, heads: int, axis, scale: Optional[float] = None):
    """The ring backward on this rank: (dq, dk, dv) of its own shards."""
    scale = _scale(q, heads, scale)
    n = axis.size
    stats = _bwd_stats(q, k, v, out, do, lse, heads)
    dq = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
    dk = torch.zeros(k.shape, dtype=torch.float32, device=k.device)
    dv = torch.zeros_like(dk)
    kc, vc = k, v
    for hop in range(n):
        pending = _post((kc, vc), axis) if hop < n - 1 else None
        dq_i, dk_i, dv_i = _hop_bwd(q, kc, vc, do, stats, heads, scale)
        dq += dq_i.float()
        dk += dk_i.float()
        dv += dv_i.float()
        if n > 1:  # the accumulators go with their block; after n rotations they are home
            dk, dv = _wait(_post((dk, dv), axis))
        if pending is not None:
            kc, vc = _wait(pending)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


@torch.library.custom_op("mvd_tpu_torch::ring_fwd", mutates_args=())
def ring_fwd_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, heads: int, scale: float,
                axis_name: str) -> Tuple[torch.Tensor, torch.Tensor]:
    """(out, lse) of the ring over the bound mesh axis ``axis_name``; inside
    a remat'd block, the forward's pair kept on its tape."""
    tape = remat.active()
    if tape is not None and tape.replaying:
        return tuple(t.detach() for t in tape.take())
    out = ring_fwd(q, k, v, heads, _axis(axis_name), scale)
    if tape is not None:
        tape.keep(tuple(t.detach() for t in out))
    return out


def _ring_setup(ctx, inputs, output):
    q, k, v, heads, scale, axis_name = inputs
    out, lse = output
    ctx.save_for_backward(q, k, v, out, lse)
    ctx.heads, ctx.scale, ctx.axis = heads, scale, _axis(axis_name)
    ctx.mark_non_differentiable(lse)


def _ring_backward(ctx, do, _dlse):
    q, k, v, out, lse = ctx.saved_tensors
    dq, dk, dv = ring_bwd(q, k, v, out, lse, do.contiguous(), ctx.heads, ctx.axis, ctx.scale)
    return dq, dk, dv, None, None, None


ring_fwd_op.register_autograd(_ring_backward, setup_context=_ring_setup)


def _axis(axis_name: str):
    from ..mesh import bound_axis

    axis = bound_axis(axis_name)
    if axis is None:
        raise RuntimeError(f"ring attention over {axis_name!r} outside a sharded call: no mesh "
                           "binds that axis (mesh.Mesh.bind)")
    return axis


def ring_attention_packed(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, heads: int,
                          axis_name: str, scale: Optional[float] = None) -> torch.Tensor:
    """Attention with K/V sharded over the bound mesh axis ``axis_name``,
    packed (B, S_local, H*D) layout: (B, S_local, H*D) equal to attention
    over the global K/V. Differentiable in q, k and v (the ring backward)."""
    scale = _scale(q, heads, scale)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return torch.ops.mvd_tpu_torch.ring_fwd(q, k, v, heads, scale, axis_name)[0]
    return ring_fwd(q, k, v, heads, _axis(axis_name), scale)[0]


# ---------------------------------------------------------------------------
# n virtual ranks in one process
# ---------------------------------------------------------------------------


def ring_attention_virtual_fwd(qs: Sequence[torch.Tensor], ks: Sequence[torch.Tensor],
                               vs: Sequence[torch.Tensor], heads: int,
                               scale: Optional[float] = None):
    """The ring forward of n virtual ranks, rank r holding (qs[r], ks[r],
    vs[r]): at hop h it runs on the K/V of rank r - h, as the process-group
    ring does. Returns ([out], [lse]): K1 n², K4m n(n - 1) launches."""
    n = len(qs)
    scale = _scale(qs[0], heads, scale)
    outs, lses = [], []
    for r in range(n):
        o, lse = _start(qs[r], ks[r], vs[r], heads, scale)
        for hop in range(1, n):
            src = (r - hop) % n
            _hop_fwd(o, lse, qs[r], ks[src], vs[src], heads, scale)
        outs.append(o.to(qs[r].dtype))
        lses.append(lse)
    return outs, lses


def ring_attention_virtual_bwd(qs, ks, vs, outs, lses, dos, heads: int,
                               scale: Optional[float] = None) -> Tuple[List, List, List]:
    """The ring backward of n virtual ranks: ([dq], [dk], [dv]), each
    block's dk/dv summed in the order the process-group ring adds them
    (its own rank first, then r + 1, ...). K3a and K3b n² launches each."""
    n = len(qs)
    scale = _scale(qs[0], heads, scale)
    stats = [_bwd_stats(qs[r], ks[r], vs[r], outs[r], dos[r], lses[r], heads) for r in range(n)]
    dq = [torch.zeros(q.shape, dtype=torch.float32, device=q.device) for q in qs]
    dk = [torch.zeros(k.shape, dtype=torch.float32, device=k.device) for k in ks]
    dv = [torch.zeros_like(t) for t in dk]
    for hop in range(n):
        for r in range(n):
            src = (r - hop) % n
            dq_i, dk_i, dv_i = _hop_bwd(qs[r], ks[src], vs[src], dos[r], stats[r], heads, scale)
            dq[r] += dq_i.float()
            dk[src] += dk_i.float()
            dv[src] += dv_i.float()
    return ([g.to(t.dtype) for g, t in zip(dq, qs)], [g.to(t.dtype) for g, t in zip(dk, ks)],
            [g.to(t.dtype) for g, t in zip(dv, vs)])
