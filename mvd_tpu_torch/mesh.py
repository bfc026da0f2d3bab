"""The ("data", "view", "model") mesh over the processes of a
``torch.distributed`` run.

Counterpart of ``mvd_tpu/mesh.py``. The reference trains with DDP over 4
GPUs, data parallelism only (reference train.py:175-186); the JAX package
names its parallelism once, as a mesh:

  * ``data``: the batch axis; the gradients are averaged over the mesh;
  * ``view``: the multi-view axis; joint self-attention over a sharded view
    axis runs as a ring (``kernels/ring_attention.py``);
  * ``model``: the tensor-parallel axis, which the port does not run yet.

Here every process drives one device, so a mesh of ``data * view``
processes is the first that many ranks of the default process group laid
out as in JAX, process-major: rank ``r = d * view + w`` holds data index
``d`` and view index ``w``. Each axis is one process group per line of the
grid (``dist.new_group``, created by every rank in the same order, as
torch.distributed asks); ``group`` spans the whole mesh and carries the
gradient all-reduce. Without a process group the mesh is the single
process, of shape 1 x 1 x 1.

JAX binds axis names inside ``shard_map``; here ``Mesh.bind`` binds them
for the code of a sharded call (its backward included: a remat'd block
runs its forward again there), and ``bound_axis`` finds them. The binding
is a module global, not a thread-local, since autograd runs a backward on
a thread of its own and no two sharded calls run at once.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Any, Dict, Iterator, List, Optional

import torch
import torch.distributed as dist

AXES = ("data", "view", "model")


@dataclasses.dataclass(frozen=True)
class Axis:
    """One axis as this rank sees it: its process group (None when the
    axis has one member), the global ranks along it in order, and this
    rank's index among them."""

    group: Any
    ranks: List[int]
    index: int

    @property
    def size(self) -> int:
        return len(self.ranks)


class Mesh:
    """The mesh over the first ``data * view * model`` ranks."""

    def __init__(self, data: int = 1, view: int = 1, model: int = 1):
        if model > 1:
            raise NotImplementedError(
                f"a model axis of {model} is tensor parallelism, ROADMAP item 16: not ported yet")
        if data < 1 or view < 1:
            raise ValueError(f"mesh {data}x{view}x{model}: every axis needs at least one process")
        self.shape = {"data": data, "view": view, "model": model}
        self.group_size = data * view * model
        world = dist.get_world_size() if dist.is_initialized() else 1
        if self.group_size > world:
            raise ValueError(f"mesh {data}x{view}x{model} needs {self.group_size} processes, "
                             f"have {world}")
        self.rank = dist.get_rank() if dist.is_initialized() else 0
        self.ranks = list(range(self.group_size))
        self.member = self.rank < self.group_size
        grid = torch.arange(self.group_size).reshape(data, view)
        lines = {"data": [grid[:, w].tolist() for w in range(view)],
                 "view": [grid[d].tolist() for d in range(data)]}
        self.axes: Dict[str, Axis] = {"model": Axis(None, [self.rank], 0)}
        for axis, members in lines.items():
            for ranks in members:
                group = dist.new_group(ranks) if len(ranks) > 1 else None
                if self.rank in ranks:
                    self.axes[axis] = Axis(group, ranks, ranks.index(self.rank))
        if not dist.is_initialized() or self.group_size == world:
            self.group = None  # the default group, or no group at all
        else:
            self.group = dist.new_group(self.ranks)
        self.coords = {a: self.axes[a].index for a in AXES} if self.member else None

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, rank {self.rank})"

    def axis(self, name: str) -> Axis:
        if not self.member:
            raise RuntimeError(f"rank {self.rank} is not in {self!r}")
        if name not in self.axes:
            raise KeyError(f"unknown mesh axis {name!r}; the mesh has {AXES}")
        return self.axes[name]

    @contextlib.contextmanager
    def bind(self) -> Iterator["Mesh"]:
        """Bind this mesh's axis names for the code run inside."""
        global _bound
        prev, _bound = _bound, self
        try:
            yield self
        finally:
            _bound = prev

    def _block(self, x: torch.Tensor, axis: int, name: str) -> torch.Tensor:
        n, i = self.shape[name], self.axis(name).index
        if x.shape[axis] % n:
            raise ValueError(f"axis {axis} of size {x.shape[axis]} does not divide over the "
                             f"{n} processes of the mesh's {name!r} axis")
        size = x.shape[axis] // n
        return x.narrow(axis, i * size, size)

    def view_slice(self, x, axis: int = 1):
        """This rank's views of ``x`` (its block of ``axis`` over ``view``)."""
        x = torch.as_tensor(x)
        return self._block(x, axis, "view")

    def block(self, x):
        """This rank's block of a (B, V, ...) tensor: B over ``data``, V over
        ``view`` (JAX's ``P("data", "view")``)."""
        x = torch.as_tensor(x)
        return self._block(self._block(x, 0, "data"), 1, "view")

    def gather_blocks(self, local: torch.Tensor) -> torch.Tensor:
        """The whole (B, V, ...) tensor from every rank's ``block``, on every
        rank of the mesh."""
        if self.group_size == 1:
            return local
        parts = [torch.empty_like(local) for _ in range(self.group_size)]
        dist.all_gather(parts, local.contiguous(), group=self.group)
        data, view = self.shape["data"], self.shape["view"]
        rows = [torch.cat(parts[d * view:(d + 1) * view], dim=1) for d in range(data)]
        return torch.cat(rows, dim=0)


_bound: Optional[Mesh] = None


def bound_mesh() -> Optional[Mesh]:
    """The mesh bound by ``Mesh.bind``, or None outside a sharded call."""
    return _bound


def bound_axis(name: str) -> Optional[Axis]:
    """The axis ``name`` of the mesh bound by ``Mesh.bind``, or None outside
    a sharded call."""
    return None if _bound is None else _bound.axis(name)


def make_mesh(data: int = 1, view: int = 1, model: int = 1, num_slices: int = 1) -> Mesh:
    """Build the ("data", "view", "model") mesh. ``num_slices`` > 1 (a data
    axis over several TPU slices, whose outer factor is the slice) raises:
    ROADMAP item 16."""
    if num_slices > 1:
        raise NotImplementedError(
            f"a mesh over {num_slices} slices is ROADMAP item 16: not ported yet")
    return Mesh(data, view, model)


def mesh_from_shape(shape: Dict[str, int]) -> Mesh:
    return make_mesh(data=shape.get("data", 1), view=shape.get("view", 1),
                     model=shape.get("model", 1), num_slices=shape.get("num_slices", 1))


def auto_mesh_shape(n_devices: int, num_views: int = 1) -> Dict[str, int]:
    """Default policy: give the view axis as many devices as divide both the
    device count and the view count; the rest goes to data."""
    view = 1
    for v in range(min(n_devices, num_views), 0, -1):
        if n_devices % v == 0 and num_views % v == 0:
            view = v
            break
    return {"data": n_devices // view, "view": view, "model": 1}


def shard_batch(mesh: Mesh, tree):
    """This rank's contiguous block of the rows of every (B*V, ...) tensor of
    ``tree`` (a dict or a tensor): the rows split over ``data`` and ``view``
    together, as JAX's batch sharding ``P(("data", "view"))`` lays them out."""
    if isinstance(tree, dict):
        return {k: shard_batch(mesh, v) for k, v in tree.items()}
    x = torch.as_tensor(tree)
    n = mesh.shape["data"] * mesh.shape["view"]
    if x.shape[0] % n:
        raise ValueError(f"{x.shape[0]} rows do not divide over {n} processes")
    i = mesh.axis("data").index * mesh.shape["view"] + mesh.axis("view").index
    size = x.shape[0] // n
    return x[i * size:(i + 1) * size]
