"""PIL's small image formats and the order ``Image.open`` tries its plugins
(host-side: numpy, the standard library and the port's host C++).

``PLUGINS`` is PIL 12.1.0's plugin order as ``Image.open`` walks it: first
the plugins ``Image.preinit`` imports (BMP, DIB, GIF, JPEG, PPM, PNG), then
the rest of ``Image.ID`` after ``Image.init``. Each entry has PIL's
``_accept`` of the first 16 bytes (None where the plugin has none, so that
it is tried on every file that gets that far: IM, IMT, IPTC, PCD, SPIDER,
TGA) and an ``open`` that reads the header as the plugin's ``_open`` reads
it. Where ``_open`` raises ``SyntaxError``, ``IndexError``, ``TypeError``,
``KeyError``, ``EOFError`` or ``struct.error`` (the errors ``Image.open``
and ``ImageFile`` pass over) the port's ``open`` raises ``GiveWay`` or the
same error, and ``identify`` tries the next plugin; any other error ends
the search, as it ends ``Image.open``. A format the port does not read
keeps its place and raises ``ValueError`` naming it and ROADMAP item 13c.

The formats read here, each into the image PIL holds (``PilImage``) in
PIL's mode: PPM, PGM, PBM and PFM (P1-P6, Pf and PIL's P0CMYK/Py forms;
plain tokens as ``PpmPlainDecoder`` reads them, a maxval other than 255
and 65535 rescaled as ``PpmDecoder`` rescales it), TGA (image types 1, 2,
3, 9, 10, 11; colour maps; orientation; RLE as ``TgaRleDecode.c``), ICO
and CUR (the frame ``Image.open`` loads: PNG through ``decode_png``, BMP
through ``decode_bmp`` with PIL's halved height and its AND mask or
32-bit alpha), QOI, PCX, SGI (verbatim and RLE, 8 and 16 bits a sample),
PSD (the merged image, raw or PackBits channels) and DDS (uncompressed by
masks, L, LA, P, BC1-BC7 through ``csrc/bcn_decode.cpp``). The
sequential loops (RLE, PackBits, QOI) are ``csrc/small_decode.cpp``.
``from_path``: the image ``Image.open(path)`` gives where PIL memory-maps a
raw tile (``pil_mapped``: PPM's L, P, RGBA and CMYK, TGA's L and P, SGI's
L, PSD's L and P, CUR's L and P).
"""
from __future__ import annotations

import ctypes
import io
import math
import re
import struct
from typing import Callable, NamedTuple, Optional, Tuple, Union

import numpy as np

from .images import (GIF_SIGNATURES, JPEG_SIGNATURE, MAPMODES, MAX_PIXELS, PNG_SIGNATURE, TIFF_PREFIXES, PilImage,
                     _bind_bmp, decode_bmp, decode_gif, decode_jpeg, decode_png, decode_webp, is_dib, is_webp,
                     over_white, pil_mapped, pil_rgb)
from . import tiff

ROADMAP = "ROADMAP item 13c"


class GiveWay(Exception):
    """A plugin's ``_open`` declined the file with an error ``Image.open``
    passes over (PIL's ``SyntaxError`` and its kin): try the next one."""


# the errors Image.open and ImageFile.__init__ pass over
GIVE_WAY = (GiveWay, IndexError, KeyError, TypeError, EOFError, struct.error)


class Opened(NamedTuple):
    """What a plugin's ``open`` found: PIL's ``size`` (checked by
    ``identify`` as ``ImageFile`` and ``Image.open`` check it; None where
    the decoder checks it itself) and ``load(from_path)``, which gives the
    image: a ``PilImage``, or RGB pixels (PNG, JPEG, WebP read as before)."""
    size: Optional[Tuple[int, int]]
    load: Callable[[bool], Union[PilImage, Callable]]


def _u(fmt: str, data: bytes, offset: int = 0) -> int:
    return struct.unpack_from(fmt, data, offset)[0]


def not_read(fmt: str) -> ValueError:
    return ValueError(f"{fmt}: PIL opens this file as {fmt} and the port does not read it ({ROADMAP})")


def truncated(fmt: str, what: str = "") -> ValueError:
    return ValueError(f"{fmt}: image file is truncated{what}")


# ------------------------------------------------------------ host C++


def _bind_small(lib: ctypes.CDLL) -> None:
    p, s, i, i64, e = ctypes.c_void_p, ctypes.c_size_t, ctypes.c_int, ctypes.c_int64, ctypes.c_char_p
    lib.mvd_tga_rle.argtypes = [ctypes.c_char_p, s, i, i64, i, p, e, i]
    lib.mvd_pcx_rle.argtypes = [ctypes.c_char_p, s, i64, i, i64, i, p, e, i]
    lib.mvd_sgi_rle.argtypes = [ctypes.c_char_p, s, i64, i64, i, i, p, ctypes.POINTER(i64), e, i]
    lib.mvd_packbits.argtypes = [ctypes.c_char_p, s, i64, i64, p, e, i]
    lib.mvd_qoi.argtypes = [ctypes.c_char_p, s, i64, i, p, e, i]
    for fn in (lib.mvd_tga_rle, lib.mvd_pcx_rle, lib.mvd_sgi_rle, lib.mvd_packbits, lib.mvd_qoi):
        fn.restype = i


def _bind_bcn(lib: ctypes.CDLL) -> None:
    lib.mvd_bcn_decode.argtypes = [ctypes.c_char_p, ctypes.c_size_t, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                                   ctypes.c_int, ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int]
    lib.mvd_bcn_decode.restype = ctypes.c_int


def _call(name: str, bind, fn: str, *args) -> None:
    """``csrc/<name>.cpp``'s ``fn`` with an error buffer last; raises
    ``ValueError`` with its message."""
    from ..kernels._build import load_host

    err = ctypes.create_string_buffer(256)
    if getattr(load_host(name, bind), fn)(*args, err, len(err)):
        raise ValueError(err.value.decode())


def _rows(data: bytes, offset: int, row_bytes: int, rows: int, fmt: str, stride: int = 0) -> np.ndarray:
    """PIL's raw decoder's input: ``rows`` rows of ``row_bytes`` from
    ``offset``, ``stride`` apart (0: packed); raises where the data end
    before the last row."""
    stride = stride or row_bytes
    need = offset + (rows - 1) * stride + row_bytes if rows else offset
    if offset < 0 or len(data) < need:
        raise truncated(fmt, " (the pixel data end before the last row)")
    if stride == row_bytes:
        return np.frombuffer(data, np.uint8, rows * row_bytes, offset).reshape(rows, row_bytes)
    buf = np.frombuffer(data, np.uint8)
    starts = offset + np.arange(rows, dtype=np.int64) * stride
    return buf[starts[:, None] + np.arange(row_bytes)]


def unpack(rows: np.ndarray, width: int, mode: str, rawmode: str) -> np.ndarray:
    """PIL's unpacker of ``rawmode`` into ``mode`` over (rows, bytes) uint8
    (``tiff.unpack``: the C++ unpackers the BMP and TIFF readers share):
    the (rows, width[, 4]) pixels as ``PilImage`` holds them."""
    h = rows.shape[0]
    px = tiff.unpack(mode, rawmode, rows, width, h)
    return px.reshape((h, width) if mode in ("1", "L", "P") else (h, width, 4))


def _raw_or_mapped(data: bytes, offset: int, size: Tuple[int, int], mode: str, rawmode: str, bits: int,
                   ystep: int, from_path: bool, fmt: str) -> np.ndarray:
    """One raw tile of packed rows: memory-mapped as ``Image.open(path)``
    maps it where its rawmode is its mode and in ``MAPMODES``, else
    decoded (``ystep`` -1: the last row first)."""
    w, h = size
    if from_path and rawmode == mode and mode in MAPMODES:
        mapped = pil_mapped(data, offset, size, mode, 0, ystep)
        if mapped is not None:
            return mapped.reshape((h, w) if mode in ("L", "P") else (h, w, 4))
    rows = _rows(data, offset, (w * bits + 7) // 8, h, fmt)
    px = unpack(rows, w, mode, rawmode)
    return px[::-1].copy() if ystep < 0 else px


def _putpalette(mode: str, entries: np.ndarray, fmt: str) -> Tuple[str, np.ndarray]:
    """``Image.load``'s ``putpalette``: only an L, LA, P or PA image takes a
    palette (L becoming P, LA PA), of at most 256 entries."""
    if mode not in ("L", "LA", "P", "PA"):
        raise ValueError(f"{fmt}: a palette on a mode {mode} image (PIL: illegal image mode)")
    if len(entries) > 256:
        raise ValueError(f"{fmt}: a palette of {len(entries)} entries (PIL: invalid palette size)")
    return ("PA" if len(mode) == 2 else "P"), entries


def _with_palette(pixels: np.ndarray, mode: str, palette: Optional[np.ndarray], fmt: str) -> PilImage:
    if palette is None:
        return PilImage(pixels, mode)
    mode, palette = _putpalette(mode, palette, fmt)
    if mode == "PA":  # LA's (L, L, L, A) layout -> PA's (P, 0, 0, A)
        pixels = pixels.copy()
        pixels[..., 1:3] = 0
    return PilImage(pixels, mode, palette)


# ------------------------------------------------------------ PPM family

_WS = b" \t\n\x0b\x0c\r"
PPM_MODES = {b"P1": "1", b"P2": "L", b"P3": "RGB", b"P4": "1", b"P5": "L", b"P6": "RGB", b"P0CMYK": "CMYK",
             b"Pf": "F", b"PyP": "P", b"PyRGBA": "RGBA", b"PyCMYK": "CMYK"}
SAFEBLOCK = 1024 * 1024  # ImageFile.SAFEBLOCK: the plain decoder's block


def _ppm_token(f: io.BytesIO) -> bytes:
    token = b""
    while len(token) <= 10:
        c = f.read(1)
        if not c:
            break
        if c in _WS:
            if not token:
                continue
            break
        if c == b"#":
            while f.read(1) not in b"\r\n":
                pass
            continue
        token += c
    if not token:
        raise ValueError("PPM: Reached EOF while reading header")
    if len(token) > 10:
        raise ValueError(f"PPM: Token too long in file header: {token!r}")
    return token


def _ppm_open(data: bytes) -> Opened:
    f = io.BytesIO(data)
    magic = b""
    for _ in range(6):
        c = f.read(1)
        if not c or c in _WS:
            break
        magic += c
    if magic not in PPM_MODES:
        raise GiveWay("not a PPM file")
    mode = image_mode = PPM_MODES[magic]
    size = int(_ppm_token(f)), int(_ppm_token(f))
    decoder = "ppm_plain" if magic in (b"P1", b"P2", b"P3") else "raw"
    maxval = 255
    if mode == "1":
        rawmode = "1;I"
    elif mode == "F":
        scale = float(_ppm_token(f))
        if scale == 0.0 or not math.isfinite(scale):
            raise ValueError("PPM: scale must be finite and non-zero")
        rawmode = "F;32F" if scale < 0 else "F;32BF"
    else:
        maxval = int(_ppm_token(f))
        if not 0 < maxval < 65536:
            raise ValueError("PPM: maxval must be greater than 0 and less than 65536")
        if maxval > 255 and mode == "L":
            image_mode = "I"
        rawmode = mode
        if decoder != "ppm_plain":
            if maxval == 65535 and mode == "L":
                rawmode = "I;16B"
            elif maxval != 255:
                decoder = "ppm"
    offset = f.tell()
    return Opened(size, lambda from_path: _ppm_load(data, offset, size, image_mode, rawmode, decoder, maxval,
                                                    from_path))


def _ppm_blocks(data: bytes, offset: int):
    for at in range(offset, len(data), SAFEBLOCK):
        yield data[at:at + SAFEBLOCK]


def _comment_end(block: bytes, start: int = 0) -> int:
    a, b = block.find(b"\n", start), block.find(b"\r", start)
    return min(a, b) if a * b > 0 else max(a, b)


def _ppm_plain(data: bytes, offset: int, size: Tuple[int, int], mode: str, maxval: int) -> np.ndarray:
    """``PpmPlainDecoder`` over SAFEBLOCK blocks: comments dropped (one may
    span blocks), a token split by a block's end stitched, each value
    ``round(value / maxval * out_max)`` (round half to even)."""
    blocks = _ppm_blocks(data, offset)
    spans = False

    def next_block() -> bytes:
        return next(blocks, b"")

    def strip_comments(block: bytes) -> bytes:
        nonlocal spans
        if spans:
            while block:
                end = _comment_end(block)
                if end != -1:
                    block = block[end + 1:]
                    break
                block = next_block()
        spans = False
        while True:
            start = block.find(b"#")
            if start == -1:
                break
            end = _comment_end(block, start)
            if end != -1:
                block = block[:start] + block[end + 1:]
            else:
                block = block[:start]
                spans = True
                break
        return block

    w, h = size
    if mode == "1":
        total = w * h
        out = bytearray()
        while len(out) != total:
            block = next_block()
            if not block:
                break
            tokens = b"".join(strip_comments(block).split())
            for t in tokens:
                if t not in (48, 49):
                    raise ValueError(f"PPM: Invalid token for this mode: {bytes([t])!r}")
            out = (out + tokens)[:total]
        if len(out) < total:
            raise ValueError("PPM: not enough image data")
        return np.where(np.frombuffer(bytes(out), np.uint8) == 48, 255, 0).astype(np.uint8).reshape(h, w)
    bands = {"L": 1, "I": 1, "RGB": 3, "RGBA": 4, "CMYK": 4, "P": 1}[mode]
    out_max = 65535 if mode == "I" else 255
    total = w * h * bands
    values = []
    half = b""
    while len(values) != total:
        block = next_block()
        if not block:
            if half:
                block = b" "
            else:
                break
        block = strip_comments(block)
        if half:
            block, half = half + block, b""
        tokens = block.split()
        if block and not block[-1:].isspace():
            half = tokens.pop()
            if len(half) > 10:
                raise ValueError(f"PPM: Token too long found in data: {half[:11]!r}")
        for token in tokens:
            if len(token) > 10:
                raise ValueError(f"PPM: Token too long found in data: {token[:11]!r}")
            value = int(token)
            if value < 0:
                raise ValueError(f"PPM: Channel value is negative: {value}")
            if value > maxval:
                raise ValueError(f"PPM: Channel value too large for this mode: {value}")
            values.append(round(value / maxval * out_max))
            if len(values) == total:
                break
    if len(values) < total:
        raise ValueError("PPM: not enough image data")
    return _ppm_pixels(np.array(values, np.int64), h, w, mode)


def _ppm_pixels(values: np.ndarray, h: int, w: int, mode: str) -> np.ndarray:
    if mode == "I":
        return values.astype(np.int32).reshape(h, w)
    if mode in ("L", "P"):
        return values.astype(np.uint8).reshape(h, w)
    px = values.astype(np.uint8).reshape(h, w, -1)
    if px.shape[2] == 3:
        px = np.concatenate([px, np.full((h, w, 1), 255, np.uint8)], axis=2)
    return px


def _ppm_load(data: bytes, offset: int, size: Tuple[int, int], mode: str, rawmode: str, decoder: str, maxval: int,
              from_path: bool) -> PilImage:
    w, h = size
    if decoder == "ppm_plain":
        return PilImage(_ppm_plain(data, offset, size, mode, maxval), mode)
    if decoder == "ppm":  # PpmDecoder: samples rescaled, clipped at the mode's maximum
        bands = 1 if mode in ("L", "I", "P") else len(mode)
        width = 1 if maxval < 256 else 2
        n = w * h * bands
        if len(data) - offset < n * width:
            raise ValueError("PPM: not enough image data")
        raw = np.frombuffer(data, np.uint8 if width == 1 else ">u2", n, offset).astype(np.float64)
        out_max = 65535 if mode == "I" else 255
        values = np.minimum(out_max, np.round(raw / maxval * out_max)).astype(np.int64)
        return PilImage(_ppm_pixels(values, h, w, mode), mode)
    if mode == "F":
        rows = _rows(data, offset, 4 * w, h, "PPM")
        px = rows.view("<f4" if rawmode == "F;32F" else ">f4").reshape(h, w).astype(np.float32)
        return PilImage(px[::-1].copy(), "F")
    if rawmode == "I;16B":
        rows = _rows(data, offset, 2 * w, h, "PPM")
        return PilImage(rows.view(">u2").reshape(h, w).astype(np.int32), "I")
    bits = {"1": 1, "L": 8, "P": 8, "RGB": 24, "RGBA": 32, "CMYK": 32}[mode]
    return PilImage(_raw_or_mapped(data, offset, size, mode, rawmode, bits, 1, from_path, "PPM"), mode)


# ------------------------------------------------------------ TGA

TGA_RAWMODES = {(1, 8): "P", (3, 1): "1", (3, 8): "L", (3, 16): "LA", (2, 16): "BGRA;15Z", (2, 24): "BGR",
                (2, 32): "BGRA"}
TGA_BITS = {"P": 8, "1": 1, "L": 8, "LA": 16, "BGRA;15Z": 16, "BGR": 24, "BGRA": 32}


def _tga_open(data: bytes) -> Opened:
    f = io.BytesIO(data)
    s = f.read(18)
    id_len, colormaptype, imagetype, depth, flags = s[0], s[1], s[2], s[16], s[17]
    size = _u("<H", s, 12), _u("<H", s, 14)
    if colormaptype not in (0, 1) or size[0] <= 0 or size[1] <= 0 or depth not in (1, 8, 16, 24, 32):
        raise GiveWay("not a TGA file")
    if imagetype in (3, 11):
        mode = {1: "1", 16: "LA"}.get(depth, "L")
    elif imagetype in (1, 9):
        mode = "P" if colormaptype else "L"
    elif imagetype in (2, 10):
        mode = "RGB" if depth == 24 else "RGBA"
    else:
        raise GiveWay("unknown TGA mode")
    orientation = flags & 0x30
    flip = orientation in (0x10, 0x30)
    ystep = 1 if orientation in (0x20, 0x30) else -1
    if id_len:
        f.read(id_len)
    palette = None
    if colormaptype:
        start, count, mapdepth = _u("<H", s, 3), _u("<H", s, 5), s[7]
        if mapdepth not in (16, 24, 32):
            raise GiveWay("unknown TGA map depth")
        k = mapdepth // 8
        raw = bytes(k * start) + f.read(k * count)
        n = len(raw) // k
        entries = np.frombuffer(raw, np.uint8, n * k).reshape(1, n, k)
        if mapdepth == 32:  # ImagePalette.raw("BGRA") keeps mode RGB, which has no BGRA unpacker
            palette = ValueError("TGA: a 32-bit colour map (PIL: unrecognized raw mode)")
        else:
            palmode, rawpal = {16: ("RGBA", "BGRA;15Z"), 24: ("RGB", "BGR")}[mapdepth]
            palette = unpack(entries.reshape(1, n * k), n, palmode, rawpal)[0, :, :3].copy()
    rawmode = TGA_RAWMODES.get((imagetype & 7, depth))
    offset = f.tell()

    def load(from_path: bool) -> PilImage:
        if rawmode is None:
            raise ValueError(f"TGA: image type {imagetype} at depth {depth} has no decoder "
                             "(PIL: cannot load this image)")
        if (mode, rawmode) not in (("P", "P"), ("1", "1"), ("L", "L"), ("LA", "LA"), ("RGBA", "BGRA;15Z"),
                                   ("RGB", "BGR"), ("RGBA", "BGRA")):
            raise ValueError(f"TGA: rawmode {rawmode} into mode {mode} (PIL: unknown raw mode for given image mode)")
        if isinstance(palette, ValueError):
            raise palette
        w, h = size
        bits = TGA_BITS[rawmode]
        if imagetype & 8:
            row_bytes = (w * bits + 7) // 8
            rows = np.zeros((h, row_bytes), np.uint8)
            tail = data[offset:]
            _call("small_decode", _bind_small, "mvd_tga_rle", tail, len(tail), depth // 8, row_bytes, h,
                  rows.ctypes.data)
            px = unpack(rows, w, mode, rawmode)
            if ystep < 0:
                px = px[::-1]
        else:
            px = _raw_or_mapped(data, offset, size, mode, rawmode, bits, ystep, from_path, "TGA")
        if flip:
            px = px[:, ::-1]
        return _with_palette(np.ascontiguousarray(px), mode, palette, "TGA")

    return Opened(size, load)


# ------------------------------------------------------------ ICO and CUR


def _dib_halved(data: bytes, at: int, fmt: str, from_path: bool, cur_alpha: bool = False):
    """The DIB at ``at`` as PIL's ``_bitmap`` opens it with the height then
    halved (ICO and CUR keep the XOR image, the bitmap's first half of
    rows): (PilImage, tile offset, stride, direction, PIL's full size).
    ``cur_alpha``: a 32-bit uncompressed bitmap at offset 22 of a CUR
    file, which PIL reads as BGRA (``header == 22``)."""
    from ..kernels._build import load_host

    head = data[at:at + 4]
    if len(head) < 4:
        raise GiveWay(f"{fmt}: the bitmap header is cut")
    header_size = _u("<I", head)
    if header_size not in (12, 40, 52, 56, 64, 108, 124):
        raise ValueError(f"{fmt}: Unsupported BMP header type ({header_size})")
    if len(data) - at < header_size:
        raise ValueError(f"{fmt}: Truncated File Read (the bitmap header)")
    dib = bytearray(data[at:])
    if header_size == 12:
        w, full_h = _u("<H", dib, 4), _u("<H", dib, 6)
        bits, compression = _u("<H", dib, 10), 0
    else:
        flip = dib[11] == 0xFF
        w, raw_h = _u("<I", dib, 4), _u("<I", dib, 8)
        full_h = 2 ** 32 - raw_h if flip else raw_h
        bits, compression = _u("<H", dib, 14), _u("<I", dib, 16)
        if compression == 3 and header_size == 40 and len(dib) < header_size + 12:
            raise GiveWay(f"{fmt}: the bit fields are cut")
    h = full_h // 2
    lib = load_host("bmp_decode", _bind_bmp)
    err = ctypes.create_string_buffer(256)
    mode = ctypes.create_string_buffer(8)
    cw, ch, entries = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
    whole = bytes(dib)
    if lib.mvd_bmp_info(whole, len(whole), ctypes.byref(cw), ctypes.byref(ch), mode, ctypes.byref(entries), err,
                        len(err)):
        msg = err.value.decode()
        if "zero width or height" in msg or "bit fields are cut" in msg:
            raise GiveWay(msg)
        raise ValueError(msg)
    if h <= 0:
        raise GiveWay(f"{fmt}: not identified by this driver (a bitmap of height {full_h} halved to 0)")
    if header_size == 12:
        struct.pack_into("<H", dib, 6, h)
    else:
        struct.pack_into("<I", dib, 8, 2 ** 32 - h if flip else h)
    half = bytes(dib)
    raw_is_mode, offset, stride, direction = ctypes.c_int(), ctypes.c_int64(), ctypes.c_int64(), ctypes.c_int()
    palette = np.zeros((max(entries.value, 1), 3), np.uint8)
    if lib.mvd_bmp_layout(half, len(half), ctypes.byref(raw_is_mode), ctypes.byref(offset), ctypes.byref(stride),
                          ctypes.byref(direction), palette.ctypes.data, err, len(err)):
        raise ValueError(err.value.decode())
    if cur_alpha and bits == 32 and compression == 0:
        rows = _rows(half, offset.value, 4 * w, h, fmt, stride.value)
        px = unpack(rows, w, "RGBA", "BGRA")
        img = PilImage(px[::-1].copy() if direction.value < 0 else px, "RGBA")
    elif from_path and raw_is_mode.value and mode.value.decode() in MAPMODES:
        m = mode.value.decode()
        mapped = pil_mapped(data, at + offset.value, (w, h), m, stride.value, direction.value)
        img = decode_bmp(half) if mapped is None else PilImage(
            mapped.reshape(h, w), m, palette[:entries.value] if m == "P" else None)
    else:
        img = decode_bmp(half)
    return img, at + offset.value, (w, full_h)


def _cur_open(data: bytes) -> Opened:
    f = io.BytesIO(data)
    s = f.read(6)
    if not s.startswith(b"\0\0\2\0"):
        raise GiveWay("not a CUR file")
    m = b""
    for _ in range(_u("<H", s, 4)):
        s = f.read(16)
        if not m:
            m = s
        elif s[0] > m[0] and s[1] > m[1]:
            m = s
    if not m:
        raise GiveWay("No cursors were found")
    at = _u("<I", m, 12)
    img, _, _ = _dib_halved(data, at, "CUR", False, cur_alpha=at == 22)
    size = img.pixels.shape[1], img.pixels.shape[0]

    def load(from_path: bool) -> PilImage:
        return _dib_halved(data, at, "CUR", from_path, cur_alpha=at == 22)[0] if from_path else img

    return Opened(size, load)


def _ico_entries(data: bytes):
    f = io.BytesIO(data)
    s = f.read(6)
    if not s.startswith(b"\0\0\1\0"):
        raise GiveWay("not an ICO file")
    entries = []
    for _ in range(_u("<H", s, 4)):
        s = f.read(16)
        width, height = s[0] or 256, s[1] or 256
        nb_color, bpp = s[2], _u("<H", s, 6)
        depth = bpp or (nb_color != 0 and math.ceil(math.log(nb_color, 2))) or 256
        entries.append(dict(dim=(width, height), bpp=bpp, size=_u("<I", s, 8), offset=_u("<I", s, 12),
                            square=width * height, depth=depth))
    entries.sort(key=lambda e: e["depth"])
    entries.sort(key=lambda e: e["square"], reverse=True)
    return entries


def _ico_open(data: bytes) -> Opened:
    entry = _ico_entries(data)[0]
    at = entry["offset"]
    if data[at:at + 8] == PNG_SIGNATURE:
        frame = data[at:]
        return Opened(entry["dim"], lambda from_path: (lambda comp: decode_png(frame, composite_alpha=comp)))
    img, tile, (w, full_h) = _dib_halved(data, at, "ICO", False)
    h = full_h // 2
    if entry["bpp"] == 32:  # the alpha bytes of 32-bit rows, the last row first
        alpha = data[tile:tile + w * h * 4][3::4]
        if len(alpha) < w * h:
            raise ValueError("ICO: not enough image data (the 32-bit alpha is cut)")
        mask = np.frombuffer(alpha, np.uint8).reshape(h, w)[::-1]
    else:  # the AND mask: 1-bit rows padded to 32 bits, the last row first, a set bit transparent
        w32 = w + (32 - w % 32) % 32
        total = int(w32 * h / 8)
        start = entry["offset"] + entry["size"] - total
        if start < 0:
            raise ValueError(f"ICO: the AND mask would start at {start} (PIL: negative seek value)")
        mask_data = data[start:start + total]
        try:
            rows = _rows(mask_data, 0, (w + 7) // 8, h, "ICO", w32 // 8)
        except ValueError:
            raise ValueError("ICO: not enough image data (the AND mask is cut)") from None
        mask = unpack(rows, w, "1", "1;I")[::-1]
    rgba = np.concatenate([pil_rgb(img), np.ascontiguousarray(mask)[..., None]], axis=2)
    image = PilImage(rgba, "RGBA")
    return Opened(entry["dim"], lambda from_path: image)


# ------------------------------------------------------------ QOI


def _qoi_open(data: bytes) -> Opened:
    f = io.BytesIO(data)
    if not f.read(4).startswith(b"qoif"):
        raise GiveWay("not a QOI file")
    size = _u(">I", f.read(4)), _u(">I", f.read(4))
    channels = f.read(1)[0]
    mode = "RGB" if channels == 3 else "RGBA"

    def load(from_path: bool) -> PilImage:
        w, h = size
        out = np.zeros((h, w, len(mode)), np.uint8)
        tail = data[14:]
        _call("small_decode", _bind_small, "mvd_qoi", tail, len(tail), w * h, len(mode), out.ctypes.data)
        return PilImage(out, mode)

    return Opened(size, load)


# ------------------------------------------------------------ PCX

PCX_BITS = {"1": 1, "P;2L": 2, "P;4L": 4, "L": 8, "P": 8, "RGB;L": 24}


def _pcx_open(data: bytes) -> Opened:
    f = io.BytesIO(data)
    s = f.read(68)
    if not (len(s) >= 2 and s[0] == 10 and s[1] in (0, 2, 3, 5)):
        raise GiveWay("not a PCX file")
    bbox = _u("<H", s, 4), _u("<H", s, 6), _u("<H", s, 8) + 1, _u("<H", s, 10) + 1
    if bbox[2] <= bbox[0] or bbox[3] <= bbox[1]:
        raise GiveWay("bad PCX image size")
    offset = f.tell() + 60
    version, bits, planes, provided_stride = s[1], s[3], s[65], _u("<H", s, 66)
    palette = None
    if bits == 1 and planes == 1:
        mode = rawmode = "1"
    elif bits == 1 and planes in (2, 4):
        mode, rawmode = "P", f"P;{planes}L"
        palette = np.frombuffer(s[16:64], np.uint8).reshape(-1, 3)
    elif version == 5 and bits == 8 and planes == 1:
        mode = rawmode = "L"
        # BytesIO's seek stops at 0; a file opened by path raises (``load``)
        f.seek(-769, io.SEEK_END)
        tail = f.read(769)
        if len(tail) == 769 and tail[0] == 12:
            table = np.frombuffer(tail, np.uint8, 768, 1).reshape(256, 3)
            if not (table == np.arange(256, dtype=np.uint8)[:, None]).all():
                mode = rawmode = "P"
                palette = table
    elif version == 5 and bits == 8 and planes == 3:
        mode, rawmode = "RGB", "RGB;L"
    else:
        raise ValueError(f"PCX: unknown PCX mode (version {version}, {bits} bits, {planes} planes)")
    size = bbox[2] - bbox[0], bbox[3] - bbox[1]
    stride = (size[0] * bits + 7) // 8
    if provided_stride != stride:
        stride += stride % 2

    def load(from_path: bool) -> PilImage:
        if from_path and version == 5 and bits == 8 and planes == 1 and len(data) < 769:
            raise ValueError(f"PCX: a file of {len(data)} bytes, opened by path, cannot seek 769 bytes before its "
                             "end for the palette (PIL: Invalid argument)")
        w, h = size
        row = planes * stride
        rows = np.zeros((h, row), np.uint8)
        tail = data[offset:]
        _call("small_decode", _bind_small, "mvd_pcx_rle", tail, len(tail), w, PCX_BITS[rawmode], row, h,
              rows.ctypes.data)
        return PilImage(unpack(rows, w, mode, rawmode), mode, palette)

    return Opened(size, load)


# ------------------------------------------------------------ SGI

SGI_MODES = {(1, 1, 1): "L", (1, 2, 1): "L", (2, 1, 1): "L;16B", (2, 2, 1): "L;16B", (1, 3, 3): "RGB",
             (2, 3, 3): "RGB;16B", (1, 3, 4): "RGBA", (2, 3, 4): "RGBA;16B"}


def _sgi_open(data: bytes) -> Opened:
    s = data[:512]
    compression, bpc = s[2], s[3]
    dimension, xsize, ysize, zsize = (_u(">H", s, k) for k in (4, 6, 8, 10))
    rawmode = SGI_MODES.get((bpc, dimension, zsize))
    if rawmode is None:
        raise ValueError(f"SGI: Unsupported SGI image mode ({bpc} bytes a sample, dimension {dimension}, "
                         f"{zsize} channels)")
    mode = rawmode.split(";")[0]
    size = xsize, ysize

    def load(from_path: bool) -> PilImage:
        w, h = size
        bands = len(mode)
        if compression == 0 and bpc == 1 and mode == "L":
            return PilImage(_raw_or_mapped(data, 512, size, "L", "L", 8, -1, from_path, "SGI"), "L")
        if compression == 0:  # planar bands, the last row first; 16-bit samples' high byte
            planes = []
            for k in range(bands):
                rows = _rows(data, 512 + k * w * h * bpc, w * bpc, h, "SGI")
                planes.append(rows[::-1, ::bpc])
            if bands == 1:
                return PilImage(np.ascontiguousarray(planes[0]), mode)
            out = np.full((h, w, 4), 255, np.uint8)
            for k in range(bands):
                out[..., k] = planes[k]
            return PilImage(out, mode)
        if compression != 1:
            raise ValueError(f"SGI: compression {compression} has no decoder (PIL: cannot load this image)")
        rows = np.zeros((h, w * bands * bpc), np.uint8)
        done = ctypes.c_int64()
        _call("small_decode", _bind_small, "mvd_sgi_rle", data, len(data), w, h, bands, bpc, rows.ctypes.data,
              ctypes.byref(done))
        rows[done.value:] = 0
        px = unpack(rows, w, mode, rawmode)
        return PilImage(np.ascontiguousarray(px[::-1]), mode)

    return Opened(size, load)


# ------------------------------------------------------------ PSD

PSD_MODES = {(0, 1): ("1", 1), (0, 8): ("L", 1), (1, 8): ("L", 1), (2, 8): ("P", 1), (3, 8): ("RGB", 3),
             (4, 8): ("CMYK", 4), (7, 8): ("L", 1), (8, 8): ("L", 1), (9, 8): ("LAB", 3)}


def _psd_open(data: bytes) -> Opened:
    f = io.BytesIO(data)
    s = f.read(26)
    if not s.startswith(b"8BPS") or _u(">H", s, 4) != 1:
        raise GiveWay("not a PSD file")
    bits, channels_in_file, psd_mode = _u(">H", s, 22), _u(">H", s, 12), _u(">H", s, 24)
    mode, channels = PSD_MODES[(psd_mode, bits)]
    if channels > channels_in_file:
        raise ValueError("PSD: not enough channels")
    if mode == "RGB" and channels_in_file == 4:
        mode, channels = "RGBA", 4
    size = _u(">I", s, 18), _u(">I", s, 14)
    palette = None
    n = _u(">I", f.read(4))
    if n:
        block = f.read(n)
        if mode == "P" and n == 768:
            palette = np.frombuffer(block, np.uint8).reshape(3, 256).T.copy()
    n = _u(">I", f.read(4))
    if n:  # image resources
        end = f.tell() + n
        while f.tell() < end:
            f.read(4)
            _u(">H", f.read(2))
            name = f.read(f.read(1)[0])
            if not len(name) & 1:
                f.read(1)
            block = f.read(_u(">I", f.read(4)))
            if len(block) & 1:
                f.read(1)
    n = _u(">I", f.read(4))
    if n:  # layers and masks: skipped (the merged image follows)
        end = f.tell() + n
        _u(">I", f.read(4))
        f.seek(end)
    compression = _u(">H", f.read(2))
    w, h = size
    offsets = []
    offset = f.tell()
    if compression == 0:
        for _ in range(channels):
            offsets.append(offset)
            offset += w * h
    elif compression == 1:
        counts = f.read(channels * h * 2)
        offset = f.tell()
        i = 0
        for _ in range(channels):
            offsets.append(offset)
            for _ in range(h):
                offset += _u(">H", counts, i)
                i += 2

    def load(from_path: bool) -> PilImage:
        if not offsets:
            raise ValueError(f"PSD: compression {compression} has no decoder (PIL: cannot load this image)")
        bands = []
        row = (w + 7) // 8 if mode == "1" else w
        for k, at in enumerate(offsets):
            if compression == 0:
                if channels == 1:
                    px = _raw_or_mapped(data, at, size, mode, mode, 1 if mode == "1" else 8, 1, from_path, "PSD")
                    return PilImage(px, mode, palette)
                rows = _rows(data, at, row, h, "PSD")
            else:
                rows = np.zeros((h, row), np.uint8)
                tail = data[at:]
                _call("small_decode", _bind_small, "mvd_packbits", tail, len(tail), row, h, rows.ctypes.data)
            if mode == "1":
                return PilImage(unpack(rows, w, "1", "1"), "1")
            bands.append(255 - rows if mode == "CMYK" else rows)
        if len(bands) == 1:
            return PilImage(np.ascontiguousarray(bands[0]), mode, palette)
        out = np.full((h, w, 4), 255, np.uint8)
        for k, band in enumerate(bands):
            out[..., k] = band
        return PilImage(out, mode)

    return Opened(size, load)


# ------------------------------------------------------------ DDS

DXT_FOURCC = {b"DXT1": (1, False, "RGBA"), b"DXT3": (2, False, "RGBA"), b"DXT5": (3, False, "RGBA"),
              b"BC4U": (4, False, "L"), b"ATI1": (4, False, "L"), b"BC5S": (5, True, "RGB"),
              b"BC5U": (5, False, "RGB"), b"ATI2": (5, False, "RGB")}
# DXGI formats PIL reads: n of its bcn decoder (0: raw RGBA), signed, mode
DXGI = {70: (1, False, "RGBA"), 71: (1, False, "RGBA"), 73: (2, False, "RGBA"), 74: (2, False, "RGBA"),
        76: (3, False, "RGBA"), 77: (3, False, "RGBA"), 79: (4, False, "L"), 80: (4, False, "L"),
        82: (5, False, "RGB"), 83: (5, False, "RGB"), 84: (5, True, "RGB"), 95: (6, False, "RGB"),
        96: (6, True, "RGB"), 97: (7, False, "RGBA"), 98: (7, False, "RGBA"), 99: (7, False, "RGBA"),
        27: (0, False, "RGBA"), 28: (0, False, "RGBA"), 29: (0, False, "RGBA")}
DDPF_ALPHAPIXELS, DDPF_FOURCC, DDPF_PALETTEINDEXED8, DDPF_RGB, DDPF_LUMINANCE = 0x1, 0x4, 0x20, 0x40, 0x20000


def _dds_rgb(data: bytes, offset: int, size: Tuple[int, int], bitcount: int, masks: Tuple[int, ...]) -> np.ndarray:
    """``DdsRgbDecoder``: ``bitcount // 8`` little-endian bytes a pixel (a
    read past the end gives the bytes there, then 0), each mask's bits
    scaled as int(value / max * 255)."""
    w, h = size
    k = bitcount // 8
    n = w * h
    value = np.zeros(n, np.uint64)
    buf = np.frombuffer(data, np.uint8)
    at = offset + np.arange(n, dtype=np.int64) * k
    for b in range(min(k, 4)):  # the masks are 32-bit: higher bytes never count
        idx = at + b
        got = buf[np.minimum(idx, len(buf) - 1)] if len(buf) else np.zeros(n, np.uint8)
        value |= np.where(idx < len(buf), got, 0).astype(np.uint64) << np.uint64(8 * b)
    out = np.full((h, w, 4), 255, np.uint8)
    for c, mask in enumerate(masks):
        shift = 0
        if mask:
            while mask >> (shift + 1) << (shift + 1) == mask:
                shift += 1
        total = mask >> shift
        if total:
            v = ((value & np.uint64(mask)) >> np.uint64(shift)).astype(np.float64)
            out[..., c] = np.trunc(v / total * 255).astype(np.uint8).reshape(h, w)
        else:
            out[..., c] = 0
    return out


def _dds_open(data: bytes) -> Opened:
    f = io.BytesIO(data)
    if not f.read(4).startswith(b"DDS "):
        raise GiveWay("not a DDS file")
    header_size = _u("<I", f.read(4))
    if header_size != 124:
        raise ValueError(f"DDS: Unsupported header size {header_size!r}")
    header = f.read(120)
    if len(header) != 120:
        raise ValueError(f"DDS: Incomplete header: {len(header)} bytes")
    height, width = _u("<I", header, 4), _u("<I", header, 8)
    size = width, height
    pfflags, fourcc, bitcount = _u("<I", header, 72), header[76:80], _u("<I", header, 80)
    palette = None
    bcn, signed = 0, False
    if pfflags & DDPF_RGB:
        mode = "RGBA" if pfflags & DDPF_ALPHAPIXELS else "RGB"
        masks = struct.unpack_from(f"<{len(mode)}I", header, 84)
        offset = f.tell()
        return Opened(size, lambda from_path: PilImage(_dds_rgb(data, offset, size, bitcount, masks), mode))
    if pfflags & DDPF_LUMINANCE:
        if bitcount == 8:
            mode = "L"
        elif bitcount == 16 and pfflags & DDPF_ALPHAPIXELS:
            mode = "LA"
        else:
            raise ValueError(f"DDS: Unsupported bitcount {bitcount} for {pfflags}")
    elif pfflags & DDPF_PALETTEINDEXED8:
        mode = "P"
        raw = f.read(1024)
        palette = np.frombuffer(raw, np.uint8, len(raw) // 4 * 4).reshape(-1, 4)[:, :3].copy()
    elif pfflags & DDPF_FOURCC:
        if fourcc == b"DX10":
            dxgi = _u("<I", f.read(4))
            f.read(16)
            if dxgi not in DXGI:
                raise ValueError(f"DDS: Unimplemented DXGI format {dxgi} (PIL: NotImplementedError)")
            bcn, signed, mode = DXGI[dxgi]
        elif fourcc in DXT_FOURCC:
            bcn, signed, mode = DXT_FOURCC[fourcc]
        else:
            raise ValueError(f"DDS: Unimplemented pixel format {fourcc!r} (PIL: NotImplementedError)")
    else:
        raise ValueError(f"DDS: Unknown pixel format flags {pfflags} (PIL: NotImplementedError)")
    offset = f.tell()

    def load(from_path: bool) -> PilImage:
        w, h = size
        if bcn:
            out = np.zeros((h, w, {4: 1, 5: 3, 6: 3}.get(bcn, 4)), np.uint8)
            tail = data[offset:]
            _call("bcn_decode", _bind_bcn, "mvd_bcn_decode", tail, len(tail), bcn, int(signed), w, h,
                  out.ctypes.data)
            if bcn == 4:
                return PilImage(out[..., 0].copy(), "L")
            return PilImage(out, mode)
        bits = {"L": 8, "P": 8, "LA": 16, "RGBA": 32}[mode]
        rows = _rows(data, offset, w * bits // 8, h, "DDS")
        img = unpack(rows, w, mode, mode)
        return PilImage(img, mode, palette)

    return Opened(size, load)


# ------------------------------------------------------------ accept-less plugins the port does not read

_IM_SPLIT = re.compile(rb"^([A-Za-z][^:]*):[ \t]*(.*)[ \t]*$")
_IM_TAGS = {"Comment", "Date", "Digitalization equipment", "File size (no of images)", "Lut", "Name",
            "Scale (x,y)", "Image size (x*y)", "Image type"}


def _im_open(data: bytes) -> Opened:
    """ImImagePlugin's header: lines ``key: value`` until a 0, 0x1A or the
    end; a file with one of PIL's tags and the 0x1A after them is IM."""
    f = io.BytesIO(data)
    if b"\n" not in f.read(100):
        raise GiveWay("not an IM file")
    f.seek(0)
    n, info = 0, {"Image size (x*y)": (512, 512)}
    s = b""
    while True:
        s = f.read(1)
        if s == b"\r":
            continue
        if not s or s in (b"\0", b"\x1a"):
            break
        s = s + f.readline()
        if len(s) > 100:
            raise GiveWay("not an IM file")
        s = s[:-2] if s.endswith(b"\r\n") else s[:-1] if s.endswith(b"\n") else s
        m = _IM_SPLIT.match(s)
        if not m:
            raise GiveWay("Syntax error in IM header")
        k = m.group(1).decode("latin-1", "replace")
        v = m.group(2).decode("latin-1", "replace")
        if k in ("File size (no of images)", "Scale (x,y)", "Image size (x*y)"):
            parts = tuple(map(_im_number, v.replace("*", ",").split(",")))
            info[k] = parts[0] if len(parts) == 1 else parts
        else:
            info[k] = v
        if k in _IM_TAGS:
            n += 1
    if not n:
        raise GiveWay("Not an IM file")
    while s and not s.startswith(b"\x1a"):
        s = f.read(1)
    if not s:
        raise GiveWay("File truncated")
    if "Lut" in info and len(data) - f.tell() < 768:
        raise GiveWay("IM: the lookup table is cut")
    size = info["Image size (x*y)"]
    if not info.get("Image type", "L") or size[0] <= 0 or size[1] <= 0:
        raise GiveWay("not identified by this driver")
    raise not_read("IM")


def _im_number(s: str):
    try:
        return int(s)
    except ValueError:
        return float(s)


_IMT_FIELD = re.compile(rb"([a-z]*) ([^ \r\n]*)")


def _imt_open(data: bytes) -> Opened:
    """ImtImagePlugin's header: ``key value`` lines until 0x0C; a width,
    a height and ``pixel n8`` make it IMT."""
    f = io.BytesIO(data)
    buffer = f.read(100)
    if b"\n" not in buffer:
        raise GiveWay("not an IM file")
    xsize = ysize = 0
    mode = ""
    while True:
        if buffer:
            s, buffer = buffer[:1], buffer[1:]
        else:
            s = f.read(1)
        if not s or s == b"\x0c":
            break
        if b"\n" not in buffer:
            buffer += f.read(100)
        lines = buffer.split(b"\n")
        s += lines.pop(0)
        buffer = b"\n".join(lines)
        if len(s) == 1 or len(s) > 100:
            break
        if s[0] == ord(b"*"):
            continue
        m = _IMT_FIELD.match(s)
        if not m:
            break
        k, v = m.group(1, 2)
        if k == b"width":
            xsize = int(v)
        elif k == b"height":
            ysize = int(v)
        elif k == b"pixel" and v == b"n8":
            mode = "L"
    if not mode or xsize <= 0 or ysize <= 0:
        raise GiveWay("not identified by this driver")
    raise not_read("IMT")


def _iptc_open(data: bytes) -> Opened:
    """IptcImagePlugin's fields: 0x1C, a record and tag, a size; a file of
    such fields with the image record (3, 60), a size and a known
    compression is IPTC."""
    f = io.BytesIO(data)
    info = {}
    while True:
        s = f.read(5)
        if not s.strip(b"\x00"):
            tag, size = None, 0
        else:
            tag = s[1], s[2]
            if s[0] != 0x1C or tag[0] not in (1, 2, 3, 4, 5, 6, 7, 8, 9, 240):
                raise GiveWay("invalid IPTC/NAA file")
            size = s[3]
            if size > 132:
                raise ValueError("IPTC: illegal field length in IPTC/NAA file")
            if size == 128:
                size = 0
            elif size > 128:
                size = _u(">I", (b"\0\0\0\0" + f.read(size - 128))[-4:])
            else:
                size = _u(">H", s, 3)
        if not tag or tag == (8, 10):
            break
        value = f.read(size) if size else None
        if tag in info:
            info[tag] = (info[tag] + [value]) if isinstance(info[tag], list) else [info[tag], value]
        else:
            info[tag] = value
    layers, component = info[(3, 60)][0], info[(3, 60)][1]
    mode = "L" if layers == 1 and not component else "RGB" if layers == 3 and component else \
        "CMYK" if layers == 4 and component else ""
    if mode != "L" and (3, 65) in info:
        info[(3, 65)][0] - 1

    def getint(key) -> int:
        return _u(">I", (b"\0\0\0\0" + info[key])[-4:])

    size = getint((3, 20)), getint((3, 30))
    if getint((3, 120)) not in (1, 5):
        raise ValueError("IPTC: Unknown IPTC image compression")
    if not mode or size[0] <= 0 or size[1] <= 0:
        raise GiveWay("not identified by this driver")
    raise not_read("IPTC")


def _gbr_open(data: bytes) -> Opened:
    """GbrImagePlugin's header (its ``_accept`` takes any file whose second
    big-endian word is 1 or 2, such as a QOI of width 1 or 2): a header of
    20 bytes or more, a version, a size and a depth of 1 or 4, the GIMP
    magic of version 2, or it gives way."""
    f = io.BytesIO(data)
    header_size, version = _u(">I", f.read(4)), _u(">I", f.read(4))
    if header_size < 20 or version not in (1, 2):
        raise GiveWay("not a GIMP brush")
    width, height, depth = (_u(">I", f.read(4)) for _ in range(3))
    if width == 0 or height == 0 or depth not in (1, 4):
        raise GiveWay("not a GIMP brush")
    if version == 2 and f.read(4) != b"GIMP":
        raise GiveWay("not a GIMP brush, bad magic number")
    raise not_read("GBR")


def _pcd_open(data: bytes) -> Opened:
    if not data[2048:2052] == b"PCD_":
        raise GiveWay("not a PCD file")
    if len(data) < 2048 + 1539:
        raise IndexError("PCD: the header is cut")
    raise not_read("PCD")


def _spider_header(t) -> int:
    h = (99,) + t

    def is_int(x) -> bool:
        try:
            return x - int(x) == 0
        except (ValueError, OverflowError):
            return False

    for i in (1, 2, 5, 12, 13, 22, 23):
        if not is_int(h[i]):
            return 0
    if int(h[5]) not in (1, 3, -11, -12, -21, -22):
        return 0
    labrec, labbyt, lenbyt = int(h[13]), int(h[22]), int(h[23])
    return labbyt if labbyt == labrec * lenbyt else 0


def _spider_open(data: bytes) -> Opened:
    f = data[:108]
    if len(f) < 108:
        raise GiveWay("not a valid Spider file")
    t = struct.unpack(">27f", f)
    hdrlen = _spider_header(t)
    if hdrlen == 0:
        t = struct.unpack("<27f", f)
        hdrlen = _spider_header(t)
    if hdrlen == 0:
        raise GiveWay("not a valid Spider file")
    h = (99,) + t
    if int(h[5]) != 1:
        raise GiveWay("not a Spider 2D image")
    try:
        istack, imgnumber = int(h[24]), int(h[27])
    except OverflowError as exc:
        raise ValueError(f"SPIDER: {exc}") from None
    if not ((istack == 0 and imgnumber == 0) or (istack > 0 and imgnumber == 0) or (istack == 0 and imgnumber > 0)):
        raise GiveWay("inconsistent stack header values")
    if int(h[12]) <= 0 or int(h[2]) <= 0:
        raise GiveWay("not identified by this driver")
    raise not_read("SPIDER")


# ------------------------------------------------------------ the plugin order


def _unread(fmt: str) -> Callable[[bytes], Opened]:
    def open_(data: bytes) -> Opened:
        raise not_read(fmt)
    return open_


def _rgb_reader(decode: Callable[[bytes, bool], np.ndarray]) -> Callable[[bytes], Opened]:
    """A format whose decoder checks everything itself and gives RGB (with
    ``composite_alpha``): PNG, JPEG, WebP."""
    return lambda data: Opened(None, lambda from_path: (lambda comp: decode(data, comp)))


def _pil_reader(decode: Callable[[bytes, bool], PilImage]) -> Callable[[bytes], Opened]:
    return lambda data: Opened(None, lambda from_path: decode(data, from_path))


def _webp(data: bytes, comp: bool) -> np.ndarray:
    pixels, mode = decode_webp(data)
    if mode == "RGBA":
        return over_white(pixels) if comp else np.ascontiguousarray(pixels[..., :3])
    return pixels


def _tiff(data: bytes, from_path: bool) -> PilImage:
    return tiff.decode_tiff(data, from_path)


class Plugin(NamedTuple):
    name: str
    accept: Optional[Callable[[bytes], bool]]
    open: Callable[[bytes], Opened]


_AVIF_BRANDS = (b"avif", b"avis", b"mif1", b"msf1")
PLUGINS: Tuple[Plugin, ...] = (
    # Image.preinit's plugins
    Plugin("BMP", lambda p: p.startswith(b"BM"), _pil_reader(decode_bmp)),
    Plugin("DIB", is_dib, _pil_reader(decode_bmp)),
    Plugin("GIF", lambda p: p.startswith(GIF_SIGNATURES), _pil_reader(lambda d, fp: decode_gif(d))),
    Plugin("JPEG", lambda p: p.startswith(JPEG_SIGNATURE), _rgb_reader(lambda d, comp: decode_jpeg(d))),
    Plugin("PPM", lambda p: len(p) >= 2 and p.startswith(b"P") and p[1] in b"0123456fy", _ppm_open),
    Plugin("PNG", lambda p: p.startswith(PNG_SIGNATURE), _rgb_reader(lambda d, comp: decode_png(
        d, composite_alpha=comp))),
    # then Image.init's, in Image.ID's order
    Plugin("AVIF", lambda p: p[4:8] == b"ftyp" and p[8:12] in _AVIF_BRANDS, _unread("AVIF")),
    Plugin("BLP", lambda p: p.startswith((b"BLP1", b"BLP2")), _unread("BLP")),
    Plugin("BUFR", lambda p: p.startswith((b"BUFR", b"ZCZC")), _unread("BUFR")),
    Plugin("CUR", lambda p: p.startswith(b"\0\0\2\0"), _cur_open),
    Plugin("PCX", lambda p: len(p) >= 2 and p[0] == 10 and p[1] in (0, 2, 3, 5), _pcx_open),
    Plugin("DCX", lambda p: len(p) >= 4 and _u("<I", p) == 0x3ADE68B1, _unread("DCX")),
    Plugin("DDS", lambda p: p.startswith(b"DDS "), _dds_open),
    Plugin("EPS", lambda p: p.startswith(b"%!PS") or (len(p) >= 4 and _u("<I", p) == 0xC6D3D0C5), _unread("EPS")),
    Plugin("FITS", lambda p: p.startswith(b"SIMPLE"), _unread("FITS")),
    Plugin("FLI", lambda p: len(p) >= 16 and _u("<H", p, 4) in (0xAF11, 0xAF12) and _u("<H", p, 14) in (0, 3),
           _unread("FLI")),
    Plugin("FTEX", lambda p: p.startswith(b"FTEX"), _unread("FTEX")),
    Plugin("GBR", lambda p: len(p) >= 8 and _u(">I", p) >= 20 and _u(">I", p, 4) in (1, 2), _gbr_open),
    Plugin("GRIB", lambda p: len(p) >= 8 and p.startswith(b"GRIB") and p[7] == 1, _unread("GRIB")),
    Plugin("HDF5", lambda p: p.startswith(b"\x89HDF\r\n\x1a\n"), _unread("HDF5")),
    Plugin("JPEG2000", lambda p: p.startswith((b"\xff\x4f\xff\x51", b"\x00\x00\x00\x0cjP  \x0d\x0a\x87\x0a")),
           _unread("JPEG2000")),
    Plugin("ICNS", lambda p: p.startswith(b"icns"), _unread("ICNS")),
    Plugin("ICO", lambda p: p.startswith(b"\0\0\1\0"), _ico_open),
    Plugin("IM", None, _im_open),
    Plugin("IMT", None, _imt_open),
    Plugin("IPTC", None, _iptc_open),
    Plugin("MCIDAS", lambda p: p.startswith(b"\x00\x00\x00\x00\x00\x00\x00\x04"), _unread("MCIDAS")),
    Plugin("MPEG", lambda p: p.startswith(b"\x00\x00\x01\xb3"), _unread("MPEG")),
    Plugin("TIFF", lambda p: p.startswith(TIFF_PREFIXES), _pil_reader(_tiff)),
    Plugin("MSP", lambda p: p.startswith((b"DanM", b"LinS")), _unread("MSP")),
    Plugin("PCD", None, _pcd_open),
    Plugin("PIXAR", lambda p: p.startswith(b"\200\350\000\000"), _unread("PIXAR")),
    Plugin("PSD", lambda p: p.startswith(b"8BPS"), _psd_open),
    Plugin("QOI", lambda p: p.startswith(b"qoif"), _qoi_open),
    Plugin("SGI", lambda p: len(p) >= 2 and _u(">H", p) == 474, _sgi_open),
    Plugin("SPIDER", None, _spider_open),
    Plugin("SUN", lambda p: len(p) >= 4 and _u(">I", p) == 0x59A66A95, _unread("SUN")),
    Plugin("TGA", None, _tga_open),
    Plugin("WEBP", is_webp, _rgb_reader(_webp)),
    Plugin("WMF", lambda p: p.startswith((b"\xd7\xcd\xc6\x9a\x00\x00", b"\x01\x00\x00\x00")), _unread("WMF")),
    Plugin("XBM", lambda p: p.lstrip().startswith(b"#define"), _unread("XBM")),
    Plugin("XPM", lambda p: p.startswith(b"/* XPM */"), _unread("XPM")),
    Plugin("XVTHUMB", lambda p: p.startswith(b"P7 332"), _unread("XVTHUMB")),
)


def identify(data: bytes) -> Tuple[str, Opened]:
    """The plugin ``Image.open`` opens ``data`` with and what its ``open``
    found, walking ``PLUGINS`` as ``Image.open`` walks its plugins; raises
    ``ValueError`` where PIL raises and, where every plugin gives way,
    PIL's "cannot identify image file" with the reasons they gave."""
    prefix = data[:16]
    passed = []
    for plugin in PLUGINS:
        if plugin.accept is not None and not plugin.accept(prefix):
            continue
        try:
            opened = plugin.open(data)
            if opened.size is not None and (opened.size[0] <= 0 or opened.size[1] <= 0):
                raise GiveWay("not identified by this driver (a size of 0)")
        except GIVE_WAY as exc:
            passed.append(f"{plugin.name}: {exc or type(exc).__name__}")
            continue
        if opened.size is not None and max(1, opened.size[0]) * max(1, opened.size[1]) > MAX_PIXELS:
            raise ValueError(f"{plugin.name}: image of {opened.size[0]}x{opened.size[1]} pixels is over the limit "
                             f"of {MAX_PIXELS} pixels (PIL's decompression-bomb limit)")
        return plugin.name, opened
    tried = "; ".join(passed) if passed else "no plugin accepts its first bytes"
    raise ValueError(f"cannot identify image file (it starts {bytes(data[:16])!r}): PIL identifies none of its "
                     f"formats in it ({tried})")
