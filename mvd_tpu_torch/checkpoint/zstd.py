"""zstd frames and CRC-32C on the host: the port's own decoder
(``csrc/zstd_decode.cpp``, the C++ standard library only), built on first
use by ``kernels/_build.py:build_host`` and called through ctypes, which
releases the interpreter lock, so chunks decode in parallel on threads.

Nothing falls back to another zstd: a frame the decoder cannot read raises
``ValueError`` naming the fault, and a decoder that cannot be built raises
``RuntimeError`` quoting the compiler.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import numpy as np

_ERR = 256


def _bind(lib: ctypes.CDLL) -> None:
    lib.mvd_zstd_decode.restype = ctypes.c_longlong
    lib.mvd_zstd_decode.argtypes = [ctypes.c_void_p, ctypes.c_size_t, ctypes.c_void_p, ctypes.c_size_t,
                                    ctypes.c_char_p, ctypes.c_int]
    lib.mvd_zstd_decode_alloc.restype = ctypes.c_void_p
    lib.mvd_zstd_decode_alloc.argtypes = [ctypes.c_void_p, ctypes.c_size_t, ctypes.c_size_t,
                                          ctypes.POINTER(ctypes.c_size_t), ctypes.c_char_p, ctypes.c_int]
    lib.mvd_zstd_take.restype = None
    lib.mvd_zstd_take.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
    lib.mvd_crc32c.restype = ctypes.c_uint32
    lib.mvd_crc32c.argtypes = [ctypes.c_void_p, ctypes.c_size_t]


def _lib() -> ctypes.CDLL:
    from ..kernels._build import load_host

    return load_host("zstd_decode", _bind)


def _src(data) -> tuple:
    """(keep-alive object, address, length) of a bytes-like object."""
    arr = np.frombuffer(data, np.uint8)
    return arr, arr.ctypes.data, arr.size


def decompress(data, out: Optional[np.ndarray] = None, limit: Optional[int] = None) -> bytes | np.ndarray:
    """Every zstd frame of ``data`` (skippable frames skipped), decoded.

    Without ``out``, returns the bytes. With ``out`` (a C-contiguous,
    writable numpy array), decodes into its memory and returns it; the
    frames must decode to exactly ``out.nbytes`` bytes, or it raises.
    With ``limit``, decoding stops after the block that brings the output
    to ``limit`` bytes, and nothing past that block is read (the bytes are
    returned whole, ``limit`` or more, or fewer where the frames end)."""
    keep, addr, n = _src(data)
    err = ctypes.create_string_buffer(_ERR)
    lib = _lib()
    if out is not None:
        if not (out.flags.c_contiguous and out.flags.writeable):
            raise ValueError("decompress: out must be a writable C-contiguous array")
        got = lib.mvd_zstd_decode(addr, n, out.ctypes.data, out.nbytes, err, _ERR)
        if got < 0:
            raise ValueError(f"zstd: {err.value.decode()}")
        if got != out.nbytes:
            raise ValueError(f"zstd: the frames decode to {got} bytes, {out.nbytes} expected")
        return out
    size = ctypes.c_size_t()
    cap = ctypes.c_size_t(-1).value if limit is None else limit
    handle = lib.mvd_zstd_decode_alloc(addr, n, cap, ctypes.byref(size), err, _ERR)
    if not handle:
        raise ValueError(f"zstd: {err.value.decode()}")
    buf = bytearray(size.value)
    dst = (ctypes.c_char * len(buf)).from_buffer(buf) if buf else None
    lib.mvd_zstd_take(handle, ctypes.addressof(dst) if dst is not None else None)
    del keep, dst
    return bytes(buf)


def crc32c(data) -> int:
    """CRC-32C (Castagnoli) of a bytes-like object."""
    keep, addr, n = _src(data)
    return int(_lib().mvd_crc32c(addr, n))
