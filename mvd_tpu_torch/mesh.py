"""The ("data", "view", "model") mesh over the processes of a
``torch.distributed`` run.

Counterpart of ``mvd_tpu/mesh.py``. The reference trains with DDP over 4
GPUs, data parallelism only (reference train.py:175-186); the JAX package
names its parallelism once, as a mesh:

  * ``data``: the batch axis; the gradients are averaged over the mesh;
  * ``view``: the multi-view axis; joint self-attention over a sharded view
    axis runs as a ring (``kernels/ring_attention.py``);
  * ``model``: the tensor-parallel axis; ``parallel.py:
    shard_params_model_parallel`` cuts the widest products over it
    (``tensor_parallel.py``).

Here every process drives one device, so a mesh of ``data * view * model``
processes is that many ranks of the default process group laid out as JAX
reshapes its devices, the model index fastest: by default rank
``r = (d * view + w) * model + m`` holds data index ``d``, view index ``w``
and model index ``m``. ``Mesh.table`` is the rank at each (d, w, m). Each
axis is one process group per line of the table (``dist.new_group``,
created by every rank in the same order, as torch.distributed asks);
``group`` spans the whole mesh and carries the gradient all-reduce (over
several nodes, NCCL splits that one all-reduce between NVLink and the
network itself). Without a process group the mesh is the single process,
of shape 1 x 1 x 1.

A multi-slice mesh (``make_mesh(num_slices=k)``) is JAX's DCN mesh: on
GPUs a slice is a node. The ranks are grouped into slices by host (each
rank's ``socket.gethostname()``, gathered once over the default group: the
counterpart of a TPU device's ``slice_index``), or split into contiguous
groups where every rank reports one host; the slice is the outermost
factor of the data axis, so the view and model lines never leave a slice.

JAX binds axis names inside ``shard_map``; here ``Mesh.bind`` binds them
for the code of a sharded call (its backward included: a remat'd block
runs its forward again there), and ``bound_axis`` finds them. The binding
is a module global, not a thread-local, since autograd runs a backward on
a thread of its own and no two sharded calls run at once.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Any, Dict, Iterator, List, Optional, Sequence

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
    """The mesh over the ranks of ``table`` (data, view, model), by default
    the first ``data * view * model`` ranks in JAX's order."""

    def __init__(self, data: int = 1, view: int = 1, model: int = 1,
                 table: Optional[torch.Tensor] = None):
        if data < 1 or view < 1 or model < 1:
            raise ValueError(f"mesh {data}x{view}x{model}: every axis needs at least one process")
        self.shape = {"data": data, "view": view, "model": model}
        self.group_size = data * view * model
        world = dist.get_world_size() if dist.is_initialized() else 1
        if self.group_size > world:
            raise ValueError(f"mesh {data}x{view}x{model} needs {self.group_size} processes, "
                             f"have {world}")
        if table is None:
            table = torch.arange(self.group_size).reshape(data, view, model)
        if tuple(table.shape) != (data, view, model):
            raise ValueError(f"a rank table of shape {tuple(table.shape)} for mesh {data}x{view}x{model}")
        self.table = table
        self.rank = dist.get_rank() if dist.is_initialized() else 0
        self.ranks = sorted(table.flatten().tolist())  # a process group's order
        if len(set(self.ranks)) != self.group_size or not 0 <= self.ranks[0] <= self.ranks[-1] < world:
            raise ValueError(f"the rank table {table.tolist()} does not name {self.group_size} "
                             f"distinct ranks of {world}")
        self.member = self.rank in self.ranks
        lines = {
            "data": [table[:, w, m].tolist() for w in range(view) for m in range(model)],
            "view": [table[d, :, m].tolist() for d in range(data) for m in range(model)],
            "model": [table[d, w].tolist() for d in range(data) for w in range(view)],
        }
        self.axes: Dict[str, Axis] = {}
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
        ``view`` (JAX's ``P("data", "view")``); the model ranks of a line
        hold the same block."""
        x = torch.as_tensor(x)
        return self._block(self._block(x, 0, "data"), 1, "view")

    def gather_blocks(self, local: torch.Tensor) -> torch.Tensor:
        """The whole (B, V, ...) tensor from every rank's ``block``, on every
        rank of the mesh."""
        if self.group_size == 1:
            return local
        parts = [torch.empty_like(local) for _ in range(self.group_size)]
        dist.all_gather(parts, local.contiguous(), group=self.group)
        at = {r: i for i, r in enumerate(self.ranks)}
        data, view = self.shape["data"], self.shape["view"]
        part = lambda d, w: parts[at[int(self.table[d, w, 0])]]
        rows = [torch.cat([part(d, w) for w in range(view)], dim=1) for d in range(data)]
        return torch.cat(rows, dim=0)


_bound: Optional[Mesh] = None


def bound_mesh() -> Optional[Mesh]:
    """The mesh bound by ``Mesh.bind``, or None outside a sharded call."""
    return _bound


def bound_axis(name: str) -> Optional[Axis]:
    """The axis ``name`` of the mesh bound by ``Mesh.bind``, or None outside
    a sharded call."""
    return None if _bound is None else _bound.axis(name)


def slice_groups(hosts: Sequence[str], num_slices: int, per_slice: int) -> List[List[int]]:
    """The ranks of each of ``num_slices`` slices of ``per_slice`` ranks,
    from each rank's host: ranks grouped by host, hosts in the order of
    their first rank; where every rank reports one host, contiguous groups
    of ranks (JAX's split of a device list without ``slice_index``)."""
    if len(set(hosts)) == 1:
        return [list(range(i * per_slice, (i + 1) * per_slice)) for i in range(num_slices)]
    groups: Dict[str, List[int]] = {}
    for rank, host in enumerate(hosts):
        groups.setdefault(host, []).append(rank)
    slices = list(groups.values())
    if len(slices) < num_slices or any(len(s) < per_slice for s in slices[:num_slices]):
        raise ValueError(f"need {num_slices} slices x {per_slice} devices, have "
                         f"{[len(s) for s in slices]}")
    return [s[:per_slice] for s in slices[:num_slices]]


def make_mesh(data: int = 1, view: int = 1, model: int = 1, num_slices: int = 1,
              hosts: Optional[Sequence[str]] = None) -> Mesh:
    """Build the ("data", "view", "model") mesh.

    ``num_slices`` > 1 builds a multi-slice mesh: the data axis spans
    slices, its outermost factor the slice index, while the view and model
    lines stay inside a slice. The ranks are grouped by ``hosts`` (each
    rank's host name, in rank order; by default every rank's
    ``socket.gethostname()``, gathered over the default group), as JAX
    groups devices by ``slice_index``; where every rank reports one host,
    they split into contiguous groups."""
    if num_slices > 1:
        if data % num_slices:
            raise ValueError(f"data axis ({data}) must be divisible by num_slices ({num_slices})")
        if hosts is None:
            from .distributed import gather_hosts

            hosts = gather_hosts()
        need = data * view * model
        if need > len(hosts):
            raise ValueError(f"mesh {data}x{view}x{model} needs {need} processes, have {len(hosts)}")
        per_slice = need // num_slices
        groups = slice_groups(hosts, num_slices, per_slice)
        # (slice, data in slice, view, model) -> (data, view, model)
        table = torch.tensor(groups).reshape(num_slices, data // num_slices, view, model)
        return Mesh(data, view, model, table.reshape(data, view, model))
    return Mesh(data, view, model)


def mesh_from_shape(shape: Dict[str, int], hosts: Optional[Sequence[str]] = None) -> Mesh:
    return make_mesh(data=shape.get("data", 1), view=shape.get("view", 1),
                     model=shape.get("model", 1), num_slices=shape.get("num_slices", 1), hosts=hosts)


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
