"""A writer of the JAX package's orbax checkpoint layout, without JAX,
orbax, tensorstore or a zstd library (torch, numpy and the port only), so
that ``chip_smoke.py`` can make full-width JAX checkpoints on a machine
that has none of them. The tests hold it to orbax: orbax's own
``StandardCheckpointer`` restore and the JAX package's
``CheckpointManager.restore`` read what it writes bitwise.

What it writes is what orbax 0.11 writes for ``save_params`` and for a
Trainer step, in the simplest legal form: every zstd frame holds raw
blocks; one data file ``d/<hex>`` holds the indirect values (over 1024
bytes) and the B+tree nodes (leaves of up to ``LEAF_ENTRIES`` keys, interior
nodes above them, keys prefix-compressed under each subtree's common
prefix); one manifest, one version; every array one zarr v2 chunk.

    write_pytree(path, tree)             # a PyTree dir (save_params)
    write_train_step(ckpt_dir, step, jax_train_state_tree(state), meta, metrics)
"""

from __future__ import annotations

import json
import os
import struct
import time
from typing import Dict, List, Tuple

import numpy as np
import torch

from mvd_tpu_torch.checkpoint.from_jax import export_jax_params, jax_param_path
from mvd_tpu_torch.checkpoint.zstd import crc32c

BLOCK = 128 * 1024
LEAF_ENTRIES = 256
MAX_INLINE = 1024


class Leaf:
    """A placeholder leaf orbax stores no value for: ``value_type`` "None"
    (optax's masked nodes and empty states) or "Tuple" (an empty tuple)."""

    def __init__(self, value_type: str):
        self.value_type = value_type


NONE, EMPTY_TUPLE = Leaf("None"), Leaf("Tuple")
_DTYPES = {np.dtype(np.float32): "<f4", np.dtype(np.float16): "<f2", np.dtype(np.float64): "<f8",
           np.dtype(np.int32): "<i4", np.dtype(np.int64): "<i8", np.dtype(np.uint8): "|u1",
           np.dtype(np.bool_): "|b1"}


# ---------------------------------------------------------------- encoding

def varint(n: int) -> bytes:
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        out.append(b | (0x80 if n else 0))
        if not n:
            return bytes(out)


def varints(values) -> bytes:
    return b"".join(varint(v) for v in values)


def write_raw_frame(f, data) -> int:
    """One zstd frame of ``data`` in raw blocks, its content size in the
    header (single segment, no checksum), written to ``f``; returns its
    length."""
    mv = memoryview(data).cast("B")
    n = len(mv)
    f.write(struct.pack("<IB", 0xFD2FB528, 0xE0) + struct.pack("<Q", n))
    written, pos = 13, 0
    while True:
        size = min(BLOCK, n - pos)
        last = pos + size >= n
        f.write(struct.pack("<I", (size << 3) | int(last))[:3])
        f.write(mv[pos:pos + size])
        written += 3 + size
        pos += size
        if last:
            return written


def raw_frame(data) -> bytes:
    import io

    buf = io.BytesIO()
    write_raw_frame(buf, data)
    return buf.getvalue()


def container(magic: int, body: bytes) -> bytes:
    """An OCDBT manifest or node: header, zstd body, CRC-32C."""
    payload = varint(0) + varint(1) + raw_frame(body)
    head = struct.pack(">I", magic) + struct.pack("<Q", 12 + len(payload) + 4)
    blob = head + payload
    return blob + struct.pack("<I", crc32c(blob))


def data_file_table(paths: List[str]) -> bytes:
    enc = [p.encode() for p in paths]
    prefix = [len(os.path.commonprefix([a, b])) for a, b in zip(enc, enc[1:])]
    return (varint(len(enc)) + varints(prefix) + varints(len(e) - p for e, p in zip(enc, [0] + prefix))
            + varints(0 for _ in enc) + b"".join(e[p:] for e, p in zip(enc, [0] + prefix)))


def _lcp(keys: List[bytes]) -> bytes:
    return os.path.commonprefix(keys) if keys else b""


def _key_columns(keys: List[bytes]) -> Tuple[bytes, bytes, bytes]:
    prefix = [len(os.path.commonprefix([a, b])) for a, b in zip(keys, keys[1:])]
    starts = [0] + prefix
    return varints(prefix), varints(len(k) - s for k, s in zip(keys, starts)), \
        b"".join(k[s:] for k, s in zip(keys, starts))


# ---------------------------------------------------------------- OCDBT

class OcdbtWriter:
    """Values put under keys, then ``finish()``: an OCDBT store at
    ``root`` (``manifest.ocdbt`` and one data file)."""

    def __init__(self, root: str, seed: int = 0):
        self.root = root
        rng = np.random.default_rng(seed)
        self.uuid = rng.bytes(16)
        self.name = "d/" + rng.bytes(16).hex()
        os.makedirs(os.path.join(root, "d"), exist_ok=True)
        self.f = open(os.path.join(root, self.name), "wb")
        self.pos = 0
        self.entries: Dict[bytes, Tuple[str, object]] = {}

    def put(self, key: bytes, value: bytes) -> None:
        if len(value) <= MAX_INLINE:
            self.entries[key] = ("inline", bytes(value))
        else:
            self.entries[key] = ("indirect", (self.pos, len(value)))
            self.f.write(value)
            self.pos += len(value)

    def put_frame(self, key: bytes, data) -> None:
        """``data`` as a raw-block zstd frame, written straight to the data
        file when it is indirect."""
        if memoryview(data).nbytes + 13 + 3 <= MAX_INLINE:
            self.put(key, raw_frame(data))
            return
        n = write_raw_frame(self.f, data)
        self.entries[key] = ("indirect", (self.pos, n))
        self.pos += n

    def _node(self, body: bytes) -> Tuple[int, int]:
        blob = container(0x0CDB20DE, body)
        off = self.pos
        self.f.write(blob)
        self.pos += len(blob)
        return off, len(blob)

    def _write(self, node, prefix: bytes) -> dict:
        """Write ``node`` (a list of keys for a leaf, of child nodes above)
        with its keys stored after ``prefix``; returns its location and
        statistics."""
        if isinstance(node[0], bytes):
            keys = node
            kp, ks, kb = _key_columns([k[len(prefix):] for k in keys])
            vals = [self.entries[k] for k in keys]
            lengths = [len(v) if kind == "inline" else v[1] for kind, v in vals]
            indirect = [v for kind, v in vals if kind == "indirect"]
            body = (bytes([0]) + data_file_table([self.name]) + varint(len(keys)) + kp + ks + kb
                    + varints(lengths) + varints(int(kind == "indirect") for kind, _ in vals)
                    + varints(0 for _ in indirect) + varints(o for o, _ in indirect)
                    + b"".join(v for kind, v in vals if kind == "inline"))
            off, ln = self._node(body)
            return dict(offset=off, length=ln, first=keys[0], num_keys=len(keys), tree_bytes=ln,
                        indirect=sum(n for _, n in indirect), height=0)
        children = []
        for child in node:
            cp = _lcp(_keys(child))
            children.append((cp, self._write(child, cp)))
        kp, ks, kb = _key_columns([c["first"][len(prefix):] for _, c in children])
        body = (bytes([children[0][1]["height"] + 1]) + data_file_table([self.name])
                + varint(len(children)) + kp + ks + varints(len(cp) - len(prefix) for cp, _ in children)
                + kb + varints(0 for _ in children) + varints(c["offset"] for _, c in children)
                + varints(c["length"] for _, c in children) + varints(c["num_keys"] for _, c in children)
                + varints(c["tree_bytes"] for _, c in children)
                + varints(c["indirect"] for _, c in children))
        off, ln = self._node(body)
        return dict(offset=off, length=ln, first=children[0][1]["first"],
                    num_keys=sum(c["num_keys"] for _, c in children),
                    tree_bytes=ln + sum(c["tree_bytes"] for _, c in children),
                    indirect=sum(c["indirect"] for _, c in children), height=children[0][1]["height"] + 1)

    def finish(self) -> None:
        keys = sorted(self.entries)
        level = [keys[i:i + LEAF_ENTRIES] for i in range(0, len(keys), LEAF_ENTRIES)]
        while len(level) > 1:
            level = [level[i:i + LEAF_ENTRIES] for i in range(0, len(level), LEAF_ENTRIES)]
        root = self._write(level[0], b"")
        self.f.close()
        body = (self.uuid + varint(0) + varint(MAX_INLINE) + varint(100_000_000) + bytes([4]) + varint(1)
                + struct.pack("<i", 0) + data_file_table([self.name])
                + varint(1) + varint(1) + bytes([root["height"]]) + varint(0) + varint(root["offset"])
                + varint(root["length"]) + varint(root["num_keys"]) + varint(root["tree_bytes"])
                + varint(root["indirect"]) + struct.pack("<Q", time.time_ns()) + varint(0))
        with open(os.path.join(self.root, "manifest.ocdbt"), "wb") as f:
            f.write(container(0x0CDB3A2A, body))


def _keys(node) -> List[bytes]:
    if isinstance(node[0], bytes):
        return node
    return _keys(node[0]) + _keys(node[-1])


# ---------------------------------------------------------------- PyTrees

def _array(leaf) -> Tuple[np.ndarray, str]:
    """(C-contiguous bytes-holding array, zarr dtype) of a leaf."""
    if torch.is_tensor(leaf):
        if leaf.dtype == torch.bfloat16:
            return leaf.detach().cpu().contiguous().view(torch.int16).numpy().view(np.uint16), "bfloat16"
        leaf = leaf.detach().cpu().numpy()
    arr = np.asarray(leaf)
    if not arr.flags.c_contiguous:  # (np.ascontiguousarray would make a 0-d array 1-d)
        arr = arr.copy(order="C")
    return arr, _DTYPES[arr.dtype]


def _flat(tree, prefix=()) -> List[Tuple[Tuple[Tuple[str, int], ...], object]]:
    if isinstance(tree, dict):
        items = [((str(k), 2), v) for k, v in tree.items()]
    elif isinstance(tree, (list, tuple)):
        items = [((str(i), 1), v) for i, v in enumerate(tree)]
    else:
        return [(prefix, tree)]
    out = []
    for key, v in items:
        out += _flat(v, prefix + (key,))
    return out


_STANDARD = "orbax.checkpoint._src.handlers.standard_checkpoint_handler.StandardCheckpointHandler"
_JSON = "orbax.checkpoint._src.handlers.json_checkpoint_handler.JsonCheckpointHandler"


def _checkpoint_metadata(handlers, metrics=None) -> dict:
    now = time.time_ns()
    return {"item_handlers": handlers, "metrics": metrics or {}, "performance_metrics": {},
            "init_timestamp_nsecs": now, "commit_timestamp_nsecs": now, "custom_metadata": {}}


def write_pytree(path: str, tree, seed: int = 0, checkpoint_metadata: bool = True) -> int:
    """``tree`` (nested dicts and lists of numpy arrays, torch tensors or
    ``Leaf`` placeholders) as orbax's PyTree directory at ``path``; returns
    the bytes written."""
    os.makedirs(path, exist_ok=True)
    w = OcdbtWriter(path, seed)
    meta = {}
    for keys, leaf in _flat(tree):
        entry = {"key_metadata": [{"key": k, "key_type": t} for k, t in keys]}
        if isinstance(leaf, Leaf):
            entry["value_metadata"] = {"value_type": leaf.value_type, "skip_deserialize": True}
        else:
            arr, dtype = _array(leaf)
            name = ".".join(k for k, _ in keys)
            zarray = {"chunks": list(arr.shape), "compressor": {"id": "zstd", "level": 1},
                      "dimension_separator": ".", "dtype": dtype, "fill_value": None, "filters": None,
                      "order": "C", "shape": list(arr.shape), "zarr_format": 2}
            w.put(f"{name}/.zarray".encode(), json.dumps(zarray, sort_keys=True, separators=(",", ":")).encode())
            w.put_frame(f"{name}/{'.'.join('0' for _ in arr.shape) or '0'}".encode(), arr.reshape(-1).view(np.uint8))
            entry["value_metadata"] = {"value_type": "jax.Array", "skip_deserialize": False,
                                       "write_shape": list(arr.shape)}
        meta[str(tuple(k for k, _ in keys))] = entry
    w.finish()
    with open(os.path.join(path, "_METADATA"), "w") as f:
        json.dump({"tree_metadata": meta, "use_ocdbt": True, "use_zarr3": False,
                   "store_array_data_equal_to_fill_value": True, "custom_metadata": None}, f)
    if checkpoint_metadata:
        with open(os.path.join(path, "_CHECKPOINT_METADATA"), "w") as f:
            json.dump(_checkpoint_metadata(_STANDARD), f)
    return sum(os.path.getsize(os.path.join(d, n)) for d, _, fs in os.walk(path) for n in fs)


# ---------------------------------------------------------------- the JAX trees

def jax_pipeline_tree(model) -> dict:
    """A port pipeline's networks as the JAX pipeline's ``params``
    (``{"mvd": {"params": ...}, "vae": ..., "text_encoder": ...}``, f32)."""
    return {net: {"params": export_jax_params(m, dtype=torch.float32)} for net, m in model.items()}


def _masked(module, tensors: Dict[str, torch.Tensor]) -> dict:
    """A tree over all of ``module``'s parameters in the JAX layout:
    ``tensors`` (f32) at the parameters they name, ``NONE`` (optax's
    masked node) at the rest."""
    tree = export_jax_params(module, tensors, dtype=torch.float32)
    owners = dict(module.named_modules())
    for name, p in module.named_parameters():
        if name not in tensors:
            path, _ = jax_param_path(owners, name, p.dim())
            node = tree
            for k in path[:-1]:
                node = node.setdefault(k, {})
            node[path[-1]] = NONE
    return {"params": tree}


def jax_train_state_tree(state) -> dict:
    """A port ``TrainState`` as the JAX Trainer saves its ``TrainState``:
    ``{"step", "params": {"params": ...}, "opt_state": ...}`` with optax's
    ``multi_transform`` over {trainable: chain(clip, adamw) (inside
    ``MultiSteps`` when ``grad_accum_steps`` > 1), frozen: set_to_zero},
    named tuples as dicts of their fields, every parameter f32."""
    mvd = state.model["mvd"]
    count = np.int32(state.updates)
    mu = {n: state.optimizer.state[p]["exp_avg"] for n, p in state.trainable.items()}
    nu = {n: state.optimizer.state[p]["exp_avg_sq"] for n, p in state.trainable.items()}
    chain = [NONE, [{"count": count, "mu": _masked(mvd, mu), "nu": _masked(mvd, nu)}, NONE,
                    {"count": count}]]
    if state.grad_accum_steps > 1:
        acc = state.acc or {n: torch.zeros_like(p) for n, p in state.trainable.items()}
        inner = {"mini_step": np.int32(state.mini_step), "gradient_step": count, "inner_opt_state": chain,
                 "acc_grads": _masked(mvd, acc), "skip_state": EMPTY_TUPLE}
    else:
        inner = chain
    opt_state = {"inner_states": {"frozen": {"inner_state": NONE}, "trainable": {"inner_state": inner}}}
    return {"step": np.int32(state.step), "params": {"params": export_jax_params(mvd, dtype=torch.float32)},
            "opt_state": opt_state}


def write_train_step(ckpt_dir: str, step: int, state_tree: dict, meta: dict, metrics: dict,
                     seed: int = 0) -> str:
    """A step of the JAX package's ``CheckpointManager``: ``<ckpt_dir>/<step>/``
    with ``state/``, ``meta/metadata``, ``metrics/metrics`` and
    ``_CHECKPOINT_METADATA``; returns the step dir."""
    step_dir = os.path.join(ckpt_dir, str(step))
    write_pytree(os.path.join(step_dir, "state"), state_tree, seed=seed, checkpoint_metadata=False)
    for item, name, payload in (("meta", "metadata", meta), ("metrics", "metrics", metrics)):
        os.makedirs(os.path.join(step_dir, item), exist_ok=True)
        with open(os.path.join(step_dir, item, name), "w") as f:
            json.dump(payload, f)
    with open(os.path.join(step_dir, "_CHECKPOINT_METADATA"), "w") as f:
        json.dump(_checkpoint_metadata({"meta": _JSON, "metrics": _JSON, "state": _STANDARD}), f)
    return step_dir
