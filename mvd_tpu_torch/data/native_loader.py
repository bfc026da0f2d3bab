"""The native Objaverse view reader (``csrc/native_reader.cpp``) and its
plain numpy version.

Counterpart of ``mvd_tpu/data/native_loader.py`` and its C++
(``native/mvd_native.cpp``), with the same names and function: a zip
member found by the JAX reader's suffix match on a path boundary
(``mvd_native.cpp:79-81``; the PIL path's ``_entry`` takes a bare
``endswith``), the PNG expanded to 8-bit RGBA as libpng is set up there,
every tap composited over white in float, a centre-aligned bilinear resize
to (size, size) and [-1, 1]. It is another function than the PIL path's
(7-bit composite, Lanczos), which stays ``ObjaverseDataset``'s default;
``use_native=True`` takes this one.

The split differs from the JAX reader's, which links zlib and libpng: here
``zipfile`` reads the member and ``zlib`` inflates IDAT (both release the
interpreter lock), and the C++, which needs only the C++ standard library,
unfilters, expands, composites and resizes. It is built with the host's
``c++`` on first use (``kernels/_build.py:build_host``).

Deliberate differences from the JAX reader: where the build fails, and
where a read fails, this module raises (naming the zip and the entry); the
JAX ``build_native`` logs a warning and returns None, and its dataset falls
back to the PIL path, so one batch can mix two functions.

``load_view_plain`` is the same function in numpy, bitwise the C++ (float32
throughout, no contraction); the tests and ``chip_smoke.py`` hold the build
to it. No main path calls it.
"""

from __future__ import annotations

import ctypes
import struct
import zipfile
import zlib
from typing import List, Sequence, Tuple

import numpy as np

from ..utils.images import _CHANNELS, _unfilter, png_chunks, png_passes


def _bind(lib: ctypes.CDLL) -> None:
    p = ctypes.c_void_p
    lib.mvd_png_rgba.argtypes = [p, ctypes.c_size_t, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                                 ctypes.c_int, ctypes.c_int, p, ctypes.c_int, p, ctypes.c_int, p,
                                 ctypes.c_char_p, ctypes.c_int]
    lib.mvd_png_rgba.restype = ctypes.c_int
    lib.mvd_composite_resize_normalize.argtypes = [p, ctypes.c_int, ctypes.c_int, ctypes.c_int, p]
    lib.mvd_composite_resize_normalize.restype = None


def get_lib() -> ctypes.CDLL:
    """The built library; raises when it cannot be built."""
    from ..kernels._build import load_host

    return load_host("native_reader", _bind)


def _member(z: zipfile.ZipFile, entry: str) -> str:
    """The first member, in central-directory order, whose name is
    ``entry`` or ends in ``/entry`` (mvd_native.cpp:79-81)."""
    for name in z.namelist():
        if name == entry or name.endswith("/" + entry):
            return name
    raise KeyError(f"no member {entry!r}")


class _Png:
    """A PNG's header, palette, tRNS bytes and inflated image data
    (``utils/images.py:png_chunks``). Critical chunks with a bad CRC raise;
    an ancillary one is dropped, as libpng does by default."""

    def __init__(self, data: bytes):
        chunks = png_chunks(data, drop_bad_ancillary=True)
        self.w, self.h, self.depth, self.colour, _, _, self.interlace = chunks.header
        self.plte, self.trns = chunks.plte, chunks.trns
        self.raw = zlib.decompress(b"".join(chunks.idat))

    def passes(self) -> List[Tuple[int, int, int, int, int, int]]:
        """(x0, dx, y0, dy, width, height) of each non-empty pass: the whole
        image, or Adam7's seven."""
        return png_passes(self.w, self.h, self.interlace)


def _png_rgba(png: _Png) -> np.ndarray:
    rgba = np.empty((png.h, png.w, 4), np.uint8)
    err = ctypes.create_string_buffer(256)
    plte = np.frombuffer(png.plte, np.uint8) if png.plte else np.zeros(3, np.uint8)
    trns = np.frombuffer(png.trns, np.uint8) if png.trns else np.zeros(1, np.uint8)
    raw = png.raw
    if get_lib().mvd_png_rgba(raw, len(raw), png.w, png.h, png.depth, png.colour, png.interlace,
                              plte.ctypes.data, len(png.plte) // 3, trns.ctypes.data, len(png.trns),
                              rgba.ctypes.data, err, len(err)):
        raise ValueError(err.value.decode())
    return rgba


def _decode(data: bytes, size: int) -> np.ndarray:
    rgba = _png_rgba(_Png(data))
    out = np.empty((size, size, 3), np.float32)
    get_lib().mvd_composite_resize_normalize(rgba.ctypes.data, rgba.shape[1], rgba.shape[0], size,
                                             out.ctypes.data)
    return out


def _read(z: zipfile.ZipFile, zip_path: str, entry: str) -> bytes:
    try:
        return z.read(_member(z, entry))
    except (KeyError, zipfile.BadZipFile, zlib.error, NotImplementedError) as e:
        raise RuntimeError(f"native reader: {zip_path}: {entry}: {e}") from e


def _open(zip_path: str) -> zipfile.ZipFile:
    try:
        return zipfile.ZipFile(zip_path)
    except zipfile.BadZipFile as e:
        raise zipfile.BadZipFile(f"native reader: {zip_path}: {e}") from e


def _view(z: zipfile.ZipFile, zip_path: str, entry: str, size: int) -> np.ndarray:
    data = _read(z, zip_path, entry)
    try:
        return _decode(data, size)
    except (ValueError, zlib.error) as e:
        raise RuntimeError(f"native reader: {zip_path}: {entry}: {e}") from e


def load_view(zip_path: str, entry: str, size: int) -> np.ndarray:
    """(size, size, 3) float32 in [-1, 1]; raises on failure, naming the zip
    and the entry."""
    with _open(zip_path) as z:
        return _view(z, zip_path, entry, size)


def read_entry(zip_path: str, entry: str) -> bytes:
    """A member's bytes (``NNN.npy``, ``prompt.txt``), found by the suffix
    match."""
    with _open(zip_path) as z:
        return _read(z, zip_path, entry)


def load_views_batch(zip_path: str, entries: Sequence[str], size: int) -> np.ndarray:
    """(len(entries), size, size, 3) float32 from one zip; raises at the
    first view that fails, naming it."""
    with _open(zip_path) as z:
        return np.stack([_view(z, zip_path, e, size) for e in entries])


# --------------------------------------------------------------------------
# the plain numpy version


def _samples(rows: np.ndarray, count: int, depth: int) -> np.ndarray:
    """(rows, row bytes) uint8 -> (rows, count) int64 samples."""
    if depth == 8:
        return rows[:, :count].astype(np.int64)
    if depth == 16:
        r = rows[:, :2 * count].astype(np.int64)
        return (r[:, 0::2] << 8) | r[:, 1::2]
    bits = np.unpackbits(rows, axis=1)[:, :count * depth].reshape(rows.shape[0], count, depth)
    return (bits.astype(np.int64) << np.arange(depth - 1, -1, -1)).sum(-1)


def png_rgba_plain(data: bytes) -> np.ndarray:
    """PNG bytes -> (H, W, 4) uint8 as ``mvd_png_rgba`` expands it, in numpy."""
    png = _Png(data)
    ch = _CHANNELS[png.colour]
    depth, colour = png.depth, png.colour
    bits = ch * depth
    bpp = max(1, bits // 8)
    out = np.empty((png.h, png.w, 4), np.uint8)
    pos = 0
    for x0, dx, y0, dy, pw, ph in png.passes():
        row_bytes = (pw * bits + 7) // 8
        rows = _unfilter(png.raw[pos:], ph, row_bytes, bpp)
        pos += ph * (row_bytes + 1)
        s = _samples(rows, pw * ch, depth).reshape(ph, pw, ch)
        if colour == 3:
            pal = np.zeros((256, 3), np.uint8)
            plte = np.frombuffer(png.plte, np.uint8).reshape(-1, 3)[:256]
            pal[:len(plte)] = plte
            alpha = np.full(256, 255, np.uint8)
            if 0 < len(png.trns) <= len(plte):
                alpha[:len(png.trns)] = np.frombuffer(png.trns, np.uint8)
            idx = s[..., 0]
            px = np.concatenate([pal[idx], alpha[idx][..., None]], -1)
        else:
            hi = s >> 8 if depth == 16 else s if depth == 8 else s * (255 // ((1 << depth) - 1))
            rgb = np.repeat(hi[..., :1], 3, -1) if colour in (0, 4) else hi[..., :3]
            if colour in (4, 6):
                a = hi[..., -1]
            elif colour == 0 and len(png.trns) == 2:
                t = struct.unpack(">H", png.trns)[0]
                if depth < 8:
                    match = hi[..., 0] == (t & ((1 << depth) - 1)) * (255 // ((1 << depth) - 1))
                else:
                    match = s[..., 0] == (t & 0xFF if depth == 8 else t)
                a = np.where(match, 0, 255)
            elif colour == 2 and len(png.trns) == 6:
                t = np.array(struct.unpack(">3H", png.trns), np.int64)
                match = (s == (t & 0xFF if depth == 8 else t)).all(-1)
                a = np.where(match, 0, 255)
            else:
                a = np.full(s.shape[:2], 255)
            px = np.concatenate([rgb, a[..., None]], -1).astype(np.uint8)
        out[y0::dy, x0::dx] = px
    return out


def composite_resize_normalize_plain(rgba: np.ndarray, size: int) -> np.ndarray:
    """(H, W, 4) uint8 -> (size, size, 3) float32 in [-1, 1], the C++
    ``mvd_composite_resize_normalize`` operation for operation in float32."""
    f32 = np.float32
    h, w = rgba.shape[:2]
    inv255 = f32(1.0) / f32(255.0)
    a = rgba[..., 3:].astype(f32) * inv255
    comp = (rgba[..., :3].astype(f32) * inv255) * a + (f32(1.0) - a)

    def taps(n: int):
        f = (np.arange(size, dtype=f32) + f32(0.5)) * f32(n) / f32(size) - f32(0.5)
        i0 = np.where(f < 0, 0, f.astype(np.int64))  # the cast truncates toward zero
        i1 = np.where(i0 + 1 < n, i0 + 1, n - 1)
        wgt = f - i0.astype(f32)
        return i0, i1, np.where(wgt < 0, f32(0), wgt).astype(f32)

    y0, y1, wy = taps(h)
    x0, x1, wx = taps(w)
    wx, wy = wx[None, :, None], wy[:, None, None]
    one = f32(1.0)
    top = comp[y0][:, x0] * (one - wx) + comp[y0][:, x1] * wx
    bot = comp[y1][:, x0] * (one - wx) + comp[y1][:, x1] * wx
    v = top * (one - wy) + bot * wy
    return v * f32(2.0) - f32(1.0)


def load_view_plain(zip_path: str, entry: str, size: int) -> np.ndarray:
    """``load_view`` in numpy: the same member, the same expansion and the
    same float32 arithmetic."""
    with zipfile.ZipFile(zip_path) as z:
        data = z.read(_member(z, entry))
    return composite_resize_normalize_plain(png_rgba_plain(data), size)
