"""Multi-process runtime of the port: one process per GPU over
``torch.distributed``.

Counterpart of ``mvd_tpu/distributed.py``. The reference trains with
Lightning DDP, one process per GPU with NCCL, ranks wired by SLURM
(reference train.py:175-186); JAX joins one process per host into one
runtime. Here every process drives one card (``cuda:LOCAL_RANK``) and the
processes form one default process group:

  * :func:`initialize`: rank, world size, local rank and the coordinator
    address come from explicit arguments, then the ``MVD_*`` variables
    (``MVD_COORDINATOR`` host:port, ``MVD_NUM_PROCESSES``,
    ``MVD_PROCESS_ID``, ``MVD_LOCAL_RANK``), then torchrun's (``RANK``,
    ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``/``MASTER_PORT``), then
    SLURM's (``SLURM_PROCID``, ``SLURM_NTASKS``, ``SLURM_LOCALID``, the
    address still from ``MASTER_ADDR``/``MASTER_PORT``). Without any of
    them it does nothing: a single-process run needs no process group, as
    in JAX. A launcher's variables start the group even at world size 1,
    so that ``torchrun --nproc-per-node 1`` takes the path that N takes;
  * :func:`is_primary`: rank 0 logs, writes PNGs and mints the run dir;
  * :func:`broadcast_str`: the run dir agreed by every process;
  * :func:`gather_hosts`: every rank's host name, which groups the ranks
    of a multi-slice mesh into slices (``mesh.make_mesh``);
  * :func:`replicate_to_mesh`: every process's tensors made the primary's;
  * :func:`global_batch`: a process's loader batch cut to the block of the
    mesh that the process holds.

The collectives' timeout (``COLLECTIVE_TIMEOUT``) is long because the
other processes wait at their next collective while the primary alone
generates the validation images (``train/loop.py``).
"""

from __future__ import annotations

import datetime
import logging
import os
import socket
from typing import Any, Dict, List, Optional

import torch
import torch.distributed as dist

logger = logging.getLogger(__name__)

COLLECTIVE_TIMEOUT = datetime.timedelta(hours=2)


def _env_int(*names: str) -> Optional[int]:
    for name in names:
        if os.environ.get(name):
            return int(os.environ[name])
    return None


def _coordinator_from_env() -> Optional[str]:
    if os.environ.get("MVD_COORDINATOR"):
        return os.environ["MVD_COORDINATOR"]
    if os.environ.get("MASTER_ADDR"):
        return f"{os.environ['MASTER_ADDR']}:{os.environ.get('MASTER_PORT', '29500')}"
    return None


def initialize(
    coordinator: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    local_rank: Optional[int] = None,
    backend: Optional[str] = None,
    device: Optional[str] = None,
) -> bool:
    """Join the default process group; returns whether one is up.

    ``coordinator`` is ``host:port`` of rank 0's store. ``backend``
    defaults to "nccl", which makes ``cuda:local_rank`` the current device
    and raises without CUDA; "gloo" with ``device="cpu"`` runs the
    processes on the CPU (the tests). Calling it again is a no-op."""
    if dist.is_initialized():
        return True
    coordinator = coordinator or _coordinator_from_env()
    if num_processes is None:
        num_processes = _env_int("MVD_NUM_PROCESSES", "WORLD_SIZE", "SLURM_NTASKS")
    if process_id is None:
        process_id = _env_int("MVD_PROCESS_ID", "RANK", "SLURM_PROCID")
    if local_rank is None:
        local_rank = _env_int("MVD_LOCAL_RANK", "LOCAL_RANK", "SLURM_LOCALID")
    launched = coordinator is not None or (num_processes or 1) > 1
    if not launched:
        return False
    if coordinator is None:
        raise ValueError(f"{num_processes} processes need a coordinator address: pass "
                         "--coordinator host:port or set MVD_COORDINATOR or MASTER_ADDR/MASTER_PORT")
    if num_processes is None or process_id is None:
        raise ValueError("a process group needs the process count and this process's rank: pass "
                         "--num-processes and --process-id or launch under torchrun or SLURM")
    if not 0 <= process_id < num_processes:
        raise ValueError(f"process id {process_id} outside a world of {num_processes}")
    backend = backend or "nccl"
    if (device or "cuda") == "cpu":
        if backend != "gloo":
            raise ValueError(f"processes on the CPU take the gloo backend, not {backend!r}")
    else:
        if not torch.cuda.is_available():
            raise RuntimeError("CUDA is not available: the port runs one process per GPU; pass "
                               "backend='gloo' and device='cpu' explicitly to run on the CPU")
        local_rank = process_id if local_rank is None else local_rank
        torch.cuda.set_device(local_rank)
    dist.init_process_group(backend, init_method=f"tcp://{coordinator}", world_size=num_processes,
                            rank=process_id, timeout=COLLECTIVE_TIMEOUT)
    logger.info("process group up: rank %d of %d (%s), local rank %s", process_id, num_processes,
                backend, local_rank)
    return True


def shutdown() -> None:
    """Leave the process group, where one is up."""
    if dist.is_initialized():
        dist.destroy_process_group()


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def is_primary() -> bool:
    """True on the logging/IO process (rank 0)."""
    return process_index() == 0


def device() -> torch.device:
    """This process's device: ``cuda:LOCAL_RANK`` under NCCL, the CPU under
    gloo, the current CUDA device (else the CPU) without a group."""
    if dist.is_initialized() and dist.get_backend() == "gloo":
        return torch.device("cpu")
    if torch.cuda.is_available():
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def _comm_device(group=None) -> torch.device:
    """Where a collective's tensors live: NCCL takes CUDA tensors only."""
    return device() if dist.get_backend(group) == "nccl" else torch.device("cpu")


def broadcast_str(s: Optional[str], max_len: int = 512, group=None) -> Optional[str]:
    """``s`` of the group's first rank (the primary for the default group)
    on every process of ``group``; the identity in a single process."""
    if not dist.is_initialized():
        return s
    data = (s or "").encode("utf-8")
    if len(data) > max_len:
        raise ValueError(f"string too long to broadcast ({len(data)} > {max_len})")
    buf = torch.zeros(max_len, dtype=torch.uint8)
    if data:
        buf[: len(data)] = torch.frombuffer(bytearray(data), dtype=torch.uint8)
    buf = buf.to(_comm_device(group))
    src = dist.get_global_rank(group, 0) if group is not None else 0
    dist.broadcast(buf, src=src, group=group)
    buf = buf.cpu()
    text = bytes(buf[buf != 0].tolist()).decode("utf-8")
    return text or None


def gather_hosts() -> List[str]:
    """Every rank's ``socket.gethostname()``, in rank order, on every rank:
    one gather over the default group (gloo or NCCL, whichever is up);
    this process's alone without a group."""
    host = socket.gethostname()
    if not dist.is_initialized():
        return [host]
    hosts: List[Optional[str]] = [None] * dist.get_world_size()
    dist.all_gather_object(hosts, host)
    return hosts


@torch.no_grad()
def replicate_to_mesh(mesh, tensors) -> None:
    """Overwrite ``tensors`` (a module's parameters and buffers, or an
    iterable of tensors), in place, with the mesh's first rank's values,
    so that every rank starts from the same state; nothing in a single
    process. Counterpart of the JAX function of this name, which stitches
    per-process copies into replicated arrays."""
    if mesh is None or mesh.group_size == 1:
        return
    if isinstance(tensors, torch.nn.Module):
        from .tensor_parallel import refuse_sharded

        refuse_sharded(tensors, "replicate_to_mesh")  # each rank holds its own shards
        tensors = list(tensors.parameters()) + list(tensors.buffers())
    src = mesh.ranks[0]
    for t in tensors:
        # collectives take dense tensors; a channels_last weight goes through a copy
        buf = t.data if t.data.is_contiguous() else t.data.contiguous()
        dist.broadcast(buf, src=src, group=mesh.group)
        if buf is not t.data:
            t.data.copy_(buf)


def global_batch(mesh, batch: Dict[str, Any]) -> Dict[str, Any]:
    """A process's loader batch (B_local, V, ...), which holds the rows of
    its ``data`` index, cut to the views of its ``view`` index: the
    (B_local, V_local, ...) block this process runs. The identity without a
    mesh or with a whole view axis."""
    if mesh is None or mesh.shape["view"] == 1:
        return batch
    return {k: mesh.view_slice(v, axis=1) for k, v in batch.items()}
