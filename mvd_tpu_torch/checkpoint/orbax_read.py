"""The read side of ``mvd_tpu/checkpoint/orbax_io.py``: the checkpoints
the JAX package writes with orbax, read on the host with the port's own
OCDBT, zarr and zstd readers (no orbax, tensorstore or zstd library).

Two forms:

* a PyTree directory (``save_params``, or a Trainer step's ``state/``):
  ``_METADATA`` (JSON: each leaf's key path, ``key_type`` 1 for a sequence
  index and 2 for a dict key, its ``value_type`` and ``skip_deserialize``;
  ``use_ocdbt`` true and ``use_zarr3`` false) beside an OCDBT store holding
  each array as zarr v2 under its dotted key path;
* a Trainer step dir ``<step>/``: ``_CHECKPOINT_METADATA``, ``state/`` (the
  PyTree ``{"step", "params", "opt_state"}``), ``meta/metadata`` (JSON:
  ``dataset_state``, ``wandb_run_id``) and ``metrics/metrics`` (JSON).

A leaf stored as ``None`` or ``skip_deserialize`` (optax's masked nodes and
empty states) stays ``None``; named tuples come back as dicts of their
fields, tuples and lists as lists. ``read_tree(..., lazy=True)`` gives
``ArrayRef`` leaves that read their array only on ``load()``, so a caller
decodes array by array into its destination and never holds the whole
tree; ``prefetch`` loads them a bounded number of bytes ahead on threads.
"""

from __future__ import annotations

import collections
import json
import os
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Dict, Iterable, Iterator, List, Optional, Tuple

from .ocdbt import MANIFEST_FILE, OcdbtStore
from .zarr import ZarrArray

METADATA_FILE = "_METADATA"
STEP_METADATA_FILE = "_CHECKPOINT_METADATA"
_ARRAY_TYPES = ("jax.Array", "np.ndarray", "scalar")


def is_orbax_dir(path: str) -> bool:
    """A PyTree directory orbax wrote (``_METADATA`` or an OCDBT manifest
    in it)."""
    return os.path.isdir(path) and (os.path.isfile(os.path.join(path, METADATA_FILE))
                                    or os.path.isfile(os.path.join(path, MANIFEST_FILE)))


def is_orbax_step(step_dir: str) -> bool:
    """A step dir of the JAX package's ``CheckpointManager``."""
    return os.path.isdir(step_dir) and (os.path.isfile(os.path.join(step_dir, STEP_METADATA_FILE))
                                        or is_orbax_dir(os.path.join(step_dir, "state")))


def orbax_steps(ckpt_dir: str) -> List[int]:
    """The steps of the JAX package's ``CheckpointManager`` under
    ``ckpt_dir``, ascending (orbax's unfinished ``*.orbax-checkpoint-tmp-*``
    dirs are not steps)."""
    if not os.path.isdir(ckpt_dir):
        return []
    return sorted(int(e) for e in os.listdir(ckpt_dir)
                  if e.isdigit() and is_orbax_step(os.path.join(ckpt_dir, e)))


class ArrayRef:
    """A leaf not read yet: ``shape``, ``dtype`` (zarr's string) and
    ``nbytes`` from its ``.zarray``; ``load()`` reads it (numpy, or a
    ``torch.bfloat16`` tensor)."""

    def __init__(self, array: ZarrArray):
        self._array = array
        self.name, self.shape, self.dtype = array.name, array.shape, array.dtype

    @property
    def nbytes(self) -> int:
        return self._array.nbytes

    def load(self):
        return self._array.load()

    def __repr__(self):
        return f"ArrayRef({self.name!r}, {self.shape}, {self.dtype})"


def read_metadata(path: str) -> Dict[str, Any]:
    """``_METADATA`` of a PyTree directory, its storage flags checked."""
    f = os.path.join(path, METADATA_FILE)
    if not os.path.isfile(f):
        raise ValueError(f"{path}: no {METADATA_FILE}, so not a complete orbax checkpoint of the JAX "
                         "package (its save_params or a Trainer step's state)")
    with open(f) as fh:
        meta = json.load(fh)
    if not meta.get("use_ocdbt", False):
        raise ValueError(f"{path}: saved without OCDBT (use_ocdbt false); only OCDBT checkpoints are read")
    if meta.get("use_zarr3", False):
        raise ValueError(f"{path}: saved as zarr v3 (use_zarr3 true); only zarr v2 is read")
    if "tree_metadata" not in meta:
        raise ValueError(f"{path}: {METADATA_FILE} has no tree_metadata")
    return meta


def _build(entries: List[Tuple[List[Tuple[str, int]], Any]], where: str):
    """Nested dicts and lists from (key path, leaf) pairs; key_type 1 makes
    a list level, 2 a dict level."""
    root: Dict = {}
    kinds: Dict[int, int] = {}
    for keys, leaf in entries:
        node = root
        for depth, (key, kind) in enumerate(keys):
            prev = kinds.setdefault(id(node), kind)
            if prev != kind:
                raise ValueError(f"{where}: key {key!r} mixes sequence and dict keys at one level")
            if depth == len(keys) - 1:
                if key in node:
                    raise ValueError(f"{where}: leaf {'/'.join(k for k, _ in keys)} appears twice")
                node[key] = leaf
            else:
                node = node.setdefault(key, {})

    def finish(node):
        if not isinstance(node, dict):
            return node
        out = {k: finish(v) for k, v in node.items()}
        if kinds.get(id(node)) == 1:
            idx = sorted(int(k) for k in out)
            if idx != list(range(len(idx))):
                raise ValueError(f"{where}: sequence indices {idx[:10]} are not 0..n-1")
            return [out[str(i)] for i in idx]
        return out

    return finish(root)


def read_tree(path: str, lazy: bool = False):
    """The PyTree saved at ``path`` as nested dicts and lists. Leaves are
    numpy arrays (bf16 as ``torch.bfloat16`` tensors), ``ArrayRef`` when
    ``lazy``, and ``None`` where orbax stored no value."""
    meta = read_metadata(path)
    store = OcdbtStore(path)
    entries = []
    for text, item in meta["tree_metadata"].items():
        keys = [(str(k["key"]), int(k["key_type"])) for k in item["key_metadata"]]
        if any(kind not in (1, 2) for _, kind in keys):
            raise ValueError(f"{path}: leaf {text} has a key type other than 1 (sequence) or 2 (dict)")
        value = item["value_metadata"]
        vtype = value.get("value_type")
        if value.get("skip_deserialize") or vtype == "None":
            leaf = None
        elif vtype in _ARRAY_TYPES:
            leaf = ArrayRef(ZarrArray(store, ".".join(k for k, _ in keys)))
        else:
            raise ValueError(f"{path}: leaf {text} has value_type {vtype!r}; arrays and None are read")
        entries.append((keys, leaf))
    tree = _build(entries, path)
    return tree if lazy else materialize(tree)


def _leaves(tree, out: List) -> List:
    if isinstance(tree, dict):
        for v in tree.values():
            _leaves(v, out)
    elif isinstance(tree, list):
        for v in tree:
            _leaves(v, out)
    elif isinstance(tree, ArrayRef):
        out.append(tree)
    return out


def materialize(tree):
    """``tree`` with every ``ArrayRef`` loaded (on threads)."""
    loaded = dict(prefetch((id(r), r) for r in _leaves(tree, [])))

    def walk(node):
        if isinstance(node, dict):
            return {k: walk(v) for k, v in node.items()}
        if isinstance(node, list):
            return [walk(v) for v in node]
        return loaded[id(node)] if isinstance(node, ArrayRef) else node

    return walk(tree)


def prefetch(items: Iterable[Tuple[Any, Any]], workers: int = 8,
             ahead_bytes: int = 1 << 30) -> Iterator[Tuple[Any, Any]]:
    """(key, leaf) pairs -> (key, loaded leaf), in order. ``ArrayRef``
    leaves load on ``workers`` threads (the zstd decoder releases the
    interpreter lock), at most ``ahead_bytes`` of decoded arrays beyond the
    one being yielded; other leaves pass through."""
    items = list(items)
    if not any(isinstance(leaf, ArrayRef) for _, leaf in items):
        yield from items
        return
    pending: collections.deque = collections.deque()
    with ThreadPoolExecutor(workers) as pool:
        inflight = 0
        for key, leaf in items:
            if isinstance(leaf, ArrayRef):
                while pending and inflight + leaf.nbytes > ahead_bytes:
                    k, fut, nb = pending.popleft()
                    inflight -= nb
                    yield k, fut.result() if nb >= 0 else fut
                pending.append((key, pool.submit(leaf.load), leaf.nbytes))
                inflight += leaf.nbytes
            else:
                pending.append((key, leaf, -1))
        while pending:
            k, fut, nb = pending.popleft()
            yield k, fut.result() if nb >= 0 else fut


def read_json_item(step_dir: str, item: str) -> Optional[Dict[str, Any]]:
    """A JSON item of a Trainer step (``meta`` or ``metrics``), or None
    when the step has none."""
    f = os.path.join(step_dir, item, item if item == "metrics" else "metadata")
    if not os.path.isfile(f):
        return None
    with open(f) as fh:
        return json.load(fh)


def read_step(step_dir: str, lazy: bool = False):
    """A Trainer step of the JAX package: (state tree ``{"step", "params",
    "opt_state"}``, meta dict, metrics dict)."""
    if not is_orbax_step(step_dir):
        raise ValueError(f"{step_dir} is not a step of the JAX package's CheckpointManager")
    state = read_tree(os.path.join(step_dir, "state"), lazy=lazy)
    missing = {"step", "params", "opt_state"} - set(state)
    if missing:
        raise ValueError(f"{step_dir}: the state item lacks {sorted(missing)}")
    return state, read_json_item(step_dir, "meta") or {}, read_json_item(step_dir, "metrics") or {}
