"""Tensor-parallel layers over the mesh's ``model`` axis.

The JAX package has no counterpart module: it marks the widest 2-D params
``P(None, "model")`` (``mvd_tpu/parallel.py:model_parallel_shardings``) and
GSPMD partitions the products. Here the layers are explicit, Megatron's
pairing:

  * :class:`ColumnParallelLinear` holds 1/n of the output features. Its
    output is either gathered (the whole features on every rank) or left
    as :class:`Shards`, one tensor per shard held, for the layers that
    consume them shard by shard: attention on the shard's heads, GEGLU on
    the shard's matching parts of ``a`` and ``gate``;
  * :class:`RowParallelLinear` holds 1/n of the input features and takes
    those shards; one all-reduce sums the partial products, then the
    (whole) bias is added;
  * :class:`ParallelEmbedding` and :class:`ParallelParam` (a raw 2-D
    parameter) hold 1/n of the feature columns and gather their output.

The collectives are ``torch.autograd.Function``s: all-reduce forward and
identity backward (after a row-parallel product), identity forward and
all-reduce backward (before a column-parallel one), all-gather forward and
this rank's part of the gradient backward. A layer carries its
:class:`ModelAxis`: a process group and this rank's index over
``torch.distributed``, or the **virtual** axis of ``virtual_model_axis(n)``,
which holds all n shards in one process and runs them one after another,
each collective a sum in rank order or a concatenation (the counterpart of
``ring_attention_virtual_fwd``). NCCL refuses two ranks on one card, so the
virtual axis is how one card runs the sharded path; ``chip_smoke.py`` and
the tests use it.

``parallel.py:shard_params_model_parallel`` swaps a network's layers for
these forms in place; a sharded layer's ``weight`` is (shards held, ...),
shard ``i`` the parameters of the axis's ``held[i]``.
"""

from __future__ import annotations

from typing import List, Optional

import torch
import torch.distributed as dist
import torch.nn as nn
import torch.nn.functional as F


class ModelAxis:
    """The ``model`` axis as a sharded layer holds it: ``size`` shards, of
    which this process holds the one of ``index`` and meets the others
    through ``group``; or, with ``index`` None, the virtual axis that holds
    all of them. Copied as itself (a process group is not copied):
    ``copy.deepcopy`` of a sharded network keeps its axis."""

    def __init__(self, size: int, index: Optional[int] = None, group=None):
        if size < 2:
            raise ValueError(f"a model axis of {size} shards nothing")
        self.size, self.index, self.group = size, index, group

    @property
    def virtual(self) -> bool:
        return self.index is None

    @property
    def held(self) -> List[int]:
        """The shards this process holds, in rank order."""
        return list(range(self.size)) if self.virtual else [self.index]

    def __deepcopy__(self, memo) -> "ModelAxis":
        return self

    def __repr__(self) -> str:
        if self.virtual:
            return f"ModelAxis({self.size}, virtual)"
        return f"ModelAxis({self.size}, index {self.index})"


def virtual_model_axis(n: int) -> ModelAxis:
    """A model axis of ``n`` virtual ranks in this process."""
    return ModelAxis(n)


def model_axis(mesh) -> ModelAxis:
    """The model axis of ``mesh``: a ``Mesh`` (this rank's index and the
    axis's process group) or a ``ModelAxis`` as it is."""
    if isinstance(mesh, ModelAxis):
        return mesh
    axis = mesh.axis("model")
    return ModelAxis(mesh.shape["model"], axis.index, axis.group)


class Shards(list):
    """A column-parallel layer's output left ungathered: one tensor per
    shard this process holds, in rank order."""


def each(fn, *args):
    """``fn`` on each shard of the :class:`Shards` among ``args`` (the other
    arguments passed whole), as Shards; ``fn(*args)`` where none is."""
    n = next((len(a) for a in args if isinstance(a, Shards)), None)
    if n is None:
        return fn(*args)
    return Shards(fn(*(a[i] if isinstance(a, Shards) else a for a in args)) for i in range(n))


def is_sharded(module: nn.Module) -> bool:
    """Whether ``module`` holds a tensor-parallel layer."""
    return any(isinstance(m, _Parallel) for m in module.modules())


def refuse_sharded(module: nn.Module, what: str) -> None:
    """Raises where ``module`` is model-sharded: weights load into the
    whole layers, before ``shard_params_model_parallel``."""
    if is_sharded(module):
        raise ValueError(f"{what}: the networks are already model-sharded; load the weights first, "
                         "then call shard_params_model_parallel once")


# ---------------------------------------------------------------------------
# collectives over a process group's model axis
# ---------------------------------------------------------------------------


class _Reduce(torch.autograd.Function):
    """All-reduce forward, identity backward."""

    @staticmethod
    def forward(ctx, x, group):
        x = x.clone()
        dist.all_reduce(x, group=group)
        return x

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class _Copy(torch.autograd.Function):
    """Identity forward, all-reduce backward: the whole input of a
    column-parallel product, whose gradient each rank holds a part of."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        grad = grad.clone()
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


class _Gather(torch.autograd.Function):
    """All-gather along the last dimension forward, this rank's part of the
    gradient backward (every rank runs the same code after a gather, so the
    gradients agree)."""

    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis = axis
        parts = [torch.empty_like(x) for _ in range(axis.size)]
        dist.all_gather(parts, x.contiguous(), group=axis.group)
        return torch.cat(parts, dim=-1)

    @staticmethod
    def backward(ctx, grad):
        return grad.chunk(ctx.axis.size, dim=-1)[ctx.axis.index], None


def reduce_shards(parts: List[torch.Tensor], axis: ModelAxis) -> torch.Tensor:
    """The sum over the model axis of each shard's partial product: in rank
    order on the virtual axis, one all-reduce over a process group."""
    if axis.virtual:
        out = parts[0]
        for p in parts[1:]:
            out = out + p
        return out
    return _Reduce.apply(parts[0], axis.group)


def gather_shards(parts: List[torch.Tensor], axis: ModelAxis) -> torch.Tensor:
    """The shards' features side by side in rank order, on every rank."""
    if axis.virtual:
        return torch.cat(parts, dim=-1)
    return _Gather.apply(parts[0], axis)


def _copy_in(x: torch.Tensor, axis: ModelAxis) -> torch.Tensor:
    if axis.virtual or not (torch.is_grad_enabled() and x.requires_grad):
        return x
    return _Copy.apply(x, axis.group)


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------


def cut(t: torch.Tensor, dim: int, n: int, chunks: int = 1) -> List[torch.Tensor]:
    """``t`` cut into ``n`` equal parts along ``dim``; with ``chunks`` > 1,
    ``dim`` is that many equal blocks (GEGLU's ``a`` and ``gate``) and part
    r holds the r-th n-th of every block, side by side."""
    size = t.shape[dim]
    if size % (n * chunks):
        raise ValueError(f"{size} features do not cut into {n} parts of {chunks} equal blocks")
    blocks = t.chunk(chunks, dim=dim)
    return [torch.cat([b.chunk(n, dim=dim)[r] for b in blocks], dim=dim) for r in range(n)]


def _stacked(parts: List[torch.Tensor], axis: ModelAxis, like: nn.Parameter) -> nn.Parameter:
    data = torch.stack([parts[r].detach() for r in axis.held]).contiguous()
    return nn.Parameter(data, requires_grad=like.requires_grad)


class _Parallel(nn.Module):
    """A layer whose ``CUT`` parameters hold the axis's held shards
    stacked on their first dimension."""

    CUT = ("weight",)

    def __init__(self, axis: ModelAxis):
        super().__init__()
        self.axis = axis

    @property
    def dtype(self) -> torch.dtype:
        return self.weight.dtype

    def rank_bytes(self) -> int:
        """The bytes of this layer's parameters on one rank."""
        held = len(self.axis.held)
        return sum(p.nbytes // held if name in self.CUT else p.nbytes
                   for name, p in self.named_parameters(recurse=False))


class ColumnParallelLinear(_Parallel):
    """``linear`` with its output features (weight rows, bias) cut into the
    axis's n parts (``cut``, with ``chunks``). Returns the gathered output
    where ``gather``, else :class:`Shards`."""

    CUT = ("weight", "bias")

    def __init__(self, linear: nn.Linear, axis: ModelAxis, gather: bool, chunks: int = 1):
        super().__init__(axis)
        self.gather, self.chunks = gather, chunks
        self.in_features, self.out_features = linear.in_features, linear.out_features
        self.weight = _stacked(cut(linear.weight, 0, axis.size, chunks), axis, linear.weight)
        self.bias = (None if linear.bias is None
                     else _stacked(cut(linear.bias, 0, axis.size, chunks), axis, linear.bias))

    def forward(self, x: torch.Tensor):
        x = _copy_in(x, self.axis)
        x = x.to(self.weight.dtype)
        outs = [F.linear(x, self.weight[i], None if self.bias is None else self.bias[i])
                for i in range(self.weight.shape[0])]
        return gather_shards(outs, self.axis) if self.gather else Shards(outs)


class RowParallelLinear(_Parallel):
    """``linear`` with its input features (weight columns) cut into the
    axis's n parts; takes the :class:`Shards` of the column-parallel layer
    before it, sums the partial products over the axis and adds the whole
    bias."""

    def __init__(self, linear: nn.Linear, axis: ModelAxis):
        super().__init__(axis)
        self.in_features, self.out_features = linear.in_features, linear.out_features
        self.weight = _stacked(cut(linear.weight, 1, axis.size), axis, linear.weight)
        self.bias = None
        if linear.bias is not None:
            self.bias = nn.Parameter(linear.bias.detach().clone(), requires_grad=linear.bias.requires_grad)

    def forward(self, x: Shards) -> torch.Tensor:
        if not isinstance(x, Shards) or len(x) != self.weight.shape[0]:
            raise TypeError("a row-parallel layer takes the shards of its column-parallel partner")
        parts = [F.linear(xi.to(self.weight.dtype), self.weight[i]) for i, xi in enumerate(x)]
        y = reduce_shards(parts, self.axis)
        return y if self.bias is None else y + self.bias


class ParallelEmbedding(_Parallel):
    """``embedding`` with its feature columns cut into the axis's n parts;
    the lookups are gathered."""

    def __init__(self, embedding: nn.Embedding, axis: ModelAxis):
        super().__init__(axis)
        self.weight = _stacked(cut(embedding.weight, 1, axis.size), axis, embedding.weight)

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        return gather_shards([F.embedding(ids, w) for w in self.weight], self.axis)


class ParallelParam(_Parallel):
    """A raw 2-D parameter (the camera encoder's ``translation_projection``,
    CLIP's ``position_embedding``) with its last dimension cut into the
    axis's n parts. ``forward()`` gathers the whole parameter;
    ``forward(x)`` is ``x @ param``, gathered."""

    def __init__(self, param: nn.Parameter, axis: ModelAxis):
        super().__init__(axis)
        self.weight = _stacked(cut(param, -1, axis.size), axis, param)

    def forward(self, x: Optional[torch.Tensor] = None) -> torch.Tensor:
        if x is None:
            return gather_shards(list(self.weight), self.axis)
        return gather_shards([x @ w.to(x.dtype) for w in self.weight], self.axis)


def rank_param_bytes(module: nn.Module) -> int:
    """The bytes of ``module``'s parameters that one rank of the model axis
    holds (each sharded layer's held shards counted once)."""
    total = 0
    for m in module.modules():
        if isinstance(m, _Parallel):
            total += m.rank_bytes()
        else:
            total += sum(p.nbytes for p in m.parameters(recurse=False))
    return total
