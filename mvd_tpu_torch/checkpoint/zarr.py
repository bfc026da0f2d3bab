"""Zarr v2 arrays in an OCDBT store, as orbax writes each array of the JAX
package's checkpoints: ``<name>/.zarray`` (JSON) beside one value per
chunk, ``<name>/<i>.<j>...`` (``<name>/0`` for a 0-d array), each chunk the
whole chunk's bytes in C order, zstd-compressed.

Read: the dtypes orbax writes (``<f4``, ``<f2``, ``<f8``, ``bfloat16``,
``<i4``, ``<i8``, ``|u1``, ``|b1`` and the other plain integers), order
"C", the chunk grid with either separator, edge chunks, 0-d arrays, and a
missing chunk filled with ``fill_value``. A bf16 array arrives as a
``torch.bfloat16`` tensor (its uint16 bits viewed as bf16); every other one
as a numpy array. Order "F", filters, a compressor other than zstd or none,
and zarr v3 raise, naming what they are.
"""

from __future__ import annotations

import itertools
import json
import math

import numpy as np
import torch

from .ocdbt import OcdbtStore
from .zstd import decompress

DTYPES = {
    "<f2": np.float16, "<f4": np.float32, "<f8": np.float64,
    "|i1": np.int8, "<i2": np.int16, "<i4": np.int32, "<i8": np.int64,
    "|u1": np.uint8, "<u2": np.uint16, "<u4": np.uint32, "<u8": np.uint64,
    "|b1": np.bool_, "bfloat16": np.uint16,
}
_FLOAT_FILLS = {"NaN": math.nan, "Infinity": math.inf, "-Infinity": -math.inf}


class ZarrArray:
    """The array ``name`` of ``store``: ``shape``, ``dtype`` (the zarr
    string), ``nbytes``; ``load()`` reads it."""

    def __init__(self, store: OcdbtStore, name: str):
        self.store, self.name = store, name
        try:
            meta = json.loads(store.read(f"{name}/.zarray"))
        except KeyError:
            if store.has(f"{name}/zarr.json"):
                raise ValueError(f"{name}: a zarr v3 array (zarr.json); only zarr v2 is read") from None
            raise KeyError(f"{store.root}: no array {name!r} (no {name}/.zarray)") from None
        where = f"{store.root}: array {name}"
        if meta.get("zarr_format") != 2:
            raise ValueError(f"{where}: zarr_format {meta.get('zarr_format')!r}, only 2 is read")
        if meta.get("order", "C") != "C":
            raise ValueError(f"{where}: order {meta.get('order')!r}, only 'C' is read")
        if meta.get("filters"):
            raise ValueError(f"{where}: filters {meta['filters']!r} are not read")
        comp = meta.get("compressor")
        if comp is not None and comp.get("id") != "zstd":
            raise ValueError(f"{where}: compressor {comp.get('id')!r}, only zstd or none is read")
        self.compressed = comp is not None
        self.dtype = meta["dtype"]
        if not isinstance(self.dtype, str) or self.dtype not in DTYPES:
            raise ValueError(f"{where}: dtype {self.dtype!r} is not read (read: {sorted(DTYPES)})")
        self.np_dtype = np.dtype(DTYPES[self.dtype])
        self.shape = tuple(int(s) for s in meta["shape"])
        self.chunks = tuple(int(c) for c in meta["chunks"])
        if len(self.chunks) != len(self.shape) or any(c < 1 for c in self.chunks):
            raise ValueError(f"{where}: chunks {self.chunks} do not fit shape {self.shape}")
        self.sep = meta.get("dimension_separator", ".")
        if self.sep not in (".", "/"):
            raise ValueError(f"{where}: dimension_separator {self.sep!r}")
        self.fill = meta.get("fill_value")

    @property
    def nbytes(self) -> int:
        return int(np.prod(self.shape, dtype=np.int64)) * self.np_dtype.itemsize

    def _fill_value(self):
        v = self.fill
        if v is None:
            return 0
        if isinstance(v, str):
            v = _FLOAT_FILLS.get(v, v)
        if self.dtype == "bfloat16":
            return int(torch.tensor(float(v), dtype=torch.bfloat16).view(torch.int16)) & 0xFFFF
        return v

    def _decode(self, data: bytes, out: np.ndarray) -> None:
        """One chunk's stored bytes into ``out`` (C-contiguous, the
        chunk's shape)."""
        if self.compressed:
            decompress(data, out.reshape(-1).view(np.uint8))
        elif len(data) != out.nbytes:
            raise ValueError(f"{self.store.root}: array {self.name}: an uncompressed chunk of "
                             f"{len(data)} bytes, {out.nbytes} expected")
        else:
            out.reshape(-1).view(np.uint8)[:] = np.frombuffer(data, np.uint8)

    def read(self) -> np.ndarray:
        """The array in its storage dtype (uint16 for bf16)."""
        out = np.empty(self.shape, self.np_dtype)
        if not self.shape:
            key = f"{self.name}/0"
            if self.store.has(key):
                self._decode(self.store.read(key), out)
            else:
                out[()] = self._fill_value()
            return out
        grid = [range(-(-s // c)) for s, c in zip(self.shape, self.chunks)]
        whole = self.shape == self.chunks
        for idx in itertools.product(*grid):
            key = f"{self.name}/{self.sep.join(str(i) for i in idx)}"
            region = tuple(slice(i * c, min((i + 1) * c, s)) for i, c, s in zip(idx, self.chunks, self.shape))
            if not self.store.has(key):
                out[region] = self._fill_value()
            elif whole:
                self._decode(self.store.read(key), out)
            else:
                chunk = np.empty(self.chunks, self.np_dtype)
                self._decode(self.store.read(key), chunk)
                out[region] = chunk[tuple(slice(0, r.stop - r.start) for r in region)]
        return out

    def load(self):
        """The array: numpy, or a ``torch.bfloat16`` tensor for bf16."""
        arr = self.read()
        if self.dtype == "bfloat16":
            return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
        return arr

