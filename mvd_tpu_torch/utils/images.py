"""Image IO helpers (host-side: numpy, the standard library and the port's
host C++).

Counterpart of ``mvd_tpu/utils/images.py`` without PIL: the machine that
holds the GPU may not have it. PNG is written by a small encoder on
``zlib`` (8-bit RGB or RGBA) and read by ``decode_png`` (``zlib``, then
``csrc/png_decode.cpp`` for the scanline filters: every colour type at
every bit depth PNG allows, 1 to 16, interlaced or not, converted as PIL's
``convert("RGB")`` converts PIL's mode; an image PIL opens as RGBA
optionally composited over white as PIL's ``Image.alpha_composite`` does).
JPEG is read by ``csrc/jpeg_decode.cpp`` (``decode_jpeg``: baseline,
extended and progressive Huffman, progressive files libjpeg block-smooths,
arithmetic-coded sequential and progressive, lossless; 8-bit, gray, three
components or four (CMYK, YCCK), bitwise PIL's ``convert("RGB")``). WebP is
read by ``csrc/webp_decode.cpp`` (``decode_webp``: lossless VP8L, lossy VP8
with or without its ALPH chunk, the VP8X container and an animation's first
frame, bitwise PIL's libwebp, with PIL's mode). An APNG is read as PNG: its
default image, which PIL's ``Image.open`` gives. GIF
(``csrc/gif_decode.cpp``), BMP and DIB (``csrc/bmp_decode.cpp``), TIFF
(``utils/tiff.py``: uncompressed, PackBits, LZW, deflate, LZMA, zstd, JPEG,
old-style JPEG, YCbCr through libtiff's RGBA path, LAB) and PIL's small
formats (``utils/small_formats.py``: the PPM family, TGA, ICO/CUR, QOI,
PCX, SGI, PSD, DDS) decode into the image PIL holds, in PIL's mode, and
``pil_rgb`` converts it as ``convert("RGB")`` does. Each is built with the
host's ``c++`` on first use. ``decode_image`` takes any of them, choosing
the format as ``Image.open`` does. ``resize`` stands in
for PIL's ``Image.resize(..., Image.LANCZOS)``: a separable Lanczos-3 whose
support widens with the downscale factor, with PIL's 8-bit fixed-point
coefficients and its uint8 rounding between the horizontal and the vertical
pass.
"""
from __future__ import annotations

import math
import os
import ctypes
import itertools
import re
import struct
import zlib
from typing import NamedTuple, Optional, Sequence, Tuple

import numpy as np

PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
JPEG_SIGNATURE = b"\xff\xd8\xff"
# the first chunks of a file PIL opens as WebP
WEBP_CHUNKS = (b"VP8 ", b"VP8L", b"VP8X")
GIF_SIGNATURES = (b"GIF87a", b"GIF89a")
# the bitmap header sizes PIL's DIB plugin accepts as a file's first int32
DIB_HEADERS = (12, 40, 52, 56, 64, 108, 124)
# TiffImagePlugin.PREFIXES: classic TIFF, the two "invalid" byte orders PIL
# still opens, BigTIFF
TIFF_PREFIXES = (b"MM\x00\x2a", b"II\x2a\x00", b"MM\x2a\x00", b"II\x00\x2a", b"MM\x00\x2b", b"II\x2b\x00")
# PIL's Image.open refuses an image of more pixels than twice
# Image.MAX_IMAGE_PIXELS (a DecompressionBombError); so do the decoders here
# (csrc/jpeg_decode.cpp holds the same number)
MAX_PIXELS = 2 * 89478485
# ImageFile.MAXBLOCK: the most PIL's load() reads from a chunk at a time
PIL_BLOCK = 65536
# PngImagePlugin.is_cid: after the image data PIL stops at another chunk type
_CID = re.compile(rb"\w{4}")
# colour type -> channels of a decoded pixel before conversion to RGB
_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}
# colour type -> the bit depths PNG allows it
_DEPTHS = {0: (1, 2, 4, 8, 16), 2: (8, 16), 3: (1, 2, 4, 8), 4: (8, 16), 6: (8, 16)}
# Adam7: (x start, x step, y start, y step) of each pass
ADAM7 = ((0, 8, 0, 8), (4, 8, 0, 8), (0, 4, 4, 8), (2, 4, 0, 4), (0, 2, 2, 4), (1, 2, 0, 2),
         (0, 1, 1, 2))


def to_uint8(img: np.ndarray) -> np.ndarray:
    """[0,1] (or [-1,1]) float NHWC/HWC -> uint8; uint8 passes through.

    The pass-through matters: ``side_by_side`` returns a uint8 canvas, and
    re-normalizing it as if it were [0,1] floats clips every pixel > 1 to
    white (the bug that blanked the training comparison PNGs)."""
    img = np.asarray(img)
    if img.dtype == np.uint8:
        return img
    img = img.astype(np.float32)
    if img.min() < -0.01:  # [-1,1] -> [0,1]
        img = img / 2 + 0.5
    return (np.clip(img, 0, 1) * 255).round().astype(np.uint8)


def _chunk(kind: bytes, data: bytes) -> bytes:
    return struct.pack(">I", len(data)) + kind + data + struct.pack(">I", zlib.crc32(kind + data))


def encode_png(img: np.ndarray) -> bytes:
    """(H, W, 3) or (H, W, 4) uint8 -> PNG bytes (8-bit RGB or RGBA, filter 0
    on every row)."""
    img = np.asarray(img)
    if img.dtype != np.uint8 or img.ndim != 3 or img.shape[2] not in (3, 4):
        raise ValueError(f"encode_png takes (H, W, 3 or 4) uint8, got {img.shape} {img.dtype}")
    h, w, ch = img.shape
    rows = np.concatenate([np.zeros((h, 1), np.uint8), img.reshape(h, w * ch)], axis=1)
    header = struct.pack(">IIBBBBB", w, h, 8, 2 if ch == 3 else 6, 0, 0, 0)
    return (PNG_SIGNATURE + _chunk(b"IHDR", header)
            + _chunk(b"IDAT", zlib.compress(rows.tobytes(), 6)) + _chunk(b"IEND", b""))


def _unfilter(raw: bytes, h: int, row_bytes: int, bpp: int) -> np.ndarray:
    """Undo the per-row filters (None, Sub, Up, Average, Paeth) of ``raw``,
    h rows of a filter byte and ``row_bytes`` bytes; ``bpp`` bytes a pixel."""
    if len(raw) < h * (row_bytes + 1):
        raise ValueError("PNG image data is truncated")
    data = np.frombuffer(raw, np.uint8, h * (row_bytes + 1)).reshape(h, row_bytes + 1)
    out = np.zeros((h, row_bytes), np.uint8)
    prev = np.zeros(row_bytes, np.uint8)
    for y in range(h):
        kind, row = int(data[y, 0]), data[y, 1:]
        if kind == 0:
            cur = row.copy()
        elif kind == 1:  # Sub: a running sum per byte of the pixel, mod 256
            cur = (np.cumsum(row.reshape(-1, bpp).astype(np.int64), axis=0) % 256)
            cur = cur.astype(np.uint8).reshape(-1)
        elif kind == 2:  # Up
            cur = row + prev
        elif kind in (3, 4):  # Average and Paeth depend on the byte to their left
            cur = bytearray(row.tobytes())
            up = prev.tobytes()
            for i in range(row_bytes):
                a = cur[i - bpp] if i >= bpp else 0
                b = up[i]
                if kind == 3:
                    cur[i] = (cur[i] + ((a + b) >> 1)) & 255
                    continue
                c = up[i - bpp] if i >= bpp else 0
                pa, pb, pc = abs(b - c), abs(a - c), abs(a + b - 2 * c)
                pred = a if pa <= pb and pa <= pc else b if pb <= pc else c
                cur[i] = (cur[i] + pred) & 255
            cur = np.frombuffer(bytes(cur), np.uint8)
        else:
            raise ValueError(f"PNG row {y} has unknown filter type {kind}")
        out[y] = cur
        prev = out[y]
    return out


def over_white(rgba: np.ndarray) -> np.ndarray:
    """(H, W, 4) uint8 -> (H, W, 3) uint8: the image composited over opaque
    white in the integer arithmetic of PIL's ``Image.alpha_composite`` (7
    fraction bits, division by 255 as two shifts), alpha then dropped."""
    a = rgba[..., 3:].astype(np.int64)
    dst_a = 255
    outa255 = a * 255 + dst_a * (255 - a)
    coef1 = a * 255 * 255 * (1 << 7) // outa255
    coef2 = 255 * (1 << 7) - coef1
    tmp = rgba[..., :3].astype(np.int64) * coef1 + 255 * coef2 + (0x80 << 7)
    out = (((tmp >> 8) + tmp) >> 8) >> 7
    return np.where(a == 0, 255, out).astype(np.uint8)


class PngChunks(NamedTuple):
    """What a PNG decoder reads of the file: IHDR unpacked (width, height,
    bit depth, colour type, compression, filter method, interlace), the
    PLTE and tRNS bodies (``b""`` where absent), the IDAT bodies, one a
    chunk, still deflated, and whether the file ends inside the last."""
    header: tuple
    plte: bytes
    trns: bytes
    idat: Tuple[bytes, ...]
    cut: bool


def png_chunks(data: bytes, drop_bad_ancillary: bool = False) -> PngChunks:
    """Walk a PNG's chunks up to IEND (``decode_png`` and the native reader
    both read through this). Raises ``ValueError`` on a missing signature,
    a truncated chunk, a chunk before the image data that fails its CRC, no
    IHDR or no image data, an unknown colour type, compression or filter
    method. As PIL's ``PngImageFile`` reads them, the IDAT chunks' CRCs are
    not checked and the image data is the first run of IDAT chunks; after
    it, a chunk's CRC is not checked either and a cut chunk header, IEND
    or a type PIL does not take for a chunk's (``is_cid``) ends the walk (a
    cut body still raises, PIL's "Truncated File Read"), as does an APNG's
    next frame (fcTL); a file may end inside the IDAT run (``pil_inflate``
    decides whether PIL reads it). With ``drop_bad_ancillary`` (libpng, the
    native reader) every chunk's CRC is checked up to IEND, an ancillary
    chunk (lower-case first letter) that fails it skipped and any other
    refused."""
    if not data.startswith(PNG_SIGNATURE):
        raise ValueError("not a PNG file (only PNG images are read)")
    pos, header, plte, trns, idat = len(PNG_SIGNATURE), None, b"", b"", []
    after = cut = False  # past PIL's first run of IDAT chunks; the file ends inside it
    frames = 1  # acTL's, before the image data
    while pos + 8 <= len(data):
        length, kind = struct.unpack(">I4s", data[pos:pos + 8])
        lenient = not drop_bad_ancillary and (kind == b"IDAT" or bool(idat))
        after = after or (lenient and kind != b"IDAT")
        if after and (kind == b"IEND" or not _CID.fullmatch(kind) or (kind == b"fcTL" and frames > 1)):
            break
        body = data[pos + 8:pos + 8 + length]
        crc = data[pos + 8 + length:pos + 12 + length]
        if lenient and not after:  # PIL's IDAT run: the file may end in it (``pil_inflate`` decides)
            idat.append(body)
            cut = len(body) != length
            if cut:
                break
        elif len(body) != length or (len(crc) != 4 and not lenient):
            raise ValueError(f"PNG chunk {kind!r} is truncated")
        pos += 12 + length
        if lenient:
            continue
        if struct.unpack(">I", crc)[0] != zlib.crc32(kind + body):
            if drop_bad_ancillary and kind[0] & 0x20:
                continue
            raise ValueError(f"PNG chunk {kind!r} fails its CRC")
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"PLTE":
            plte = body
        elif kind == b"tRNS":
            trns = body
        elif kind == b"acTL" and len(body) >= 4:
            frames = struct.unpack(">I", body[:4])[0]
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    if header is None or not idat:
        raise ValueError("PNG has no IHDR or no image data")
    _, _, _, colour, compression, filtering, _ = header
    if colour not in _CHANNELS:
        raise ValueError(f"PNG colour type {colour} is not a valid type")
    if compression != 0 or filtering != 0:
        raise ValueError(f"PNG compression {compression} / filter method {filtering} unknown")
    return PngChunks(header, plte, trns, tuple(idat), cut)


def png_passes(w: int, h: int, interlace: int) -> list:
    """(x0, dx, y0, dy, width, height) of each non-empty pass of a w x h
    image: the whole image, or Adam7's seven."""
    if interlace == 0:
        return [(0, 1, 0, 1, w, h)]
    out = []
    for x0, dx, y0, dy in ADAM7:
        pw = (w - x0 + dx - 1) // dx if w > x0 else 0
        ph = (h - y0 + dy - 1) // dy if h > y0 else 0
        if pw and ph:
            out.append((x0, dx, y0, dy, pw, ph))
    return out


def _bind_png(lib: ctypes.CDLL) -> None:
    p = ctypes.c_void_p
    lib.mvd_png_samples.argtypes = [p, ctypes.c_size_t, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                                    ctypes.c_int, ctypes.c_int, p, ctypes.c_char_p, ctypes.c_int]
    lib.mvd_png_samples.restype = ctypes.c_int


def png_mode(depth: int, colour: int) -> str:
    """The mode PIL opens a PNG of this bit depth and colour type in
    (``PngImagePlugin._MODES``): 16-bit gray is ``I;16``, 1-bit gray ``1``,
    and 16-bit gray+alpha ``RGBA``."""
    if colour == 0:
        return {1: "1", 16: "I;16"}.get(depth, "L")
    if colour == 4:
        return "RGBA" if depth == 16 else "LA"
    return {2: "RGB", 3: "P", 6: "RGBA"}[colour]


def pil_inflate(idat: Sequence[bytes], rows: Sequence[int], cut: bool = False) -> bytes:
    """The filtered rows (``rows``: each one's bytes, filter byte included)
    PIL's ZipDecode inflates from the IDAT chunks' bodies. PIL feeds the
    stream a chunk at a time in pieces of at most ``PIL_BLOCK`` bytes and
    inflates row by row: a row that needs more than there is, or whose
    last bytes zlib holds back once the input is spent, is PIL's "image
    file is truncated"; a stream whose end zlib meets in the call that
    completes a row leaves the rest zero (PIL returns the image), but one
    whose end lies in a later piece is truncated. Each piece is inflated
    in one call here, and the rows' ends tell the two cases apart, so no
    input is copied twice. Once the rows are in, PIL's ``load_end`` reads
    the chunks after the one it stopped in: where the last body is ``cut``
    (the file ends inside it) and not reached, that is its "Truncated File
    Read". Raises ``ValueError`` where PIL raises."""
    total = sum(rows)
    ends = set(itertools.accumulate(rows))
    truncated = "PNG image data is truncated (PIL: image file is truncated)"
    d = zlib.decompressobj()
    out = bytearray()
    try:
        for i, body in enumerate(idat):
            for at in range(0, len(body), PIL_BLOCK):
                start = len(out)
                out += d.decompress(body[at:at + PIL_BLOCK], total - start)
                if d.eof and start < len(out) < total and len(out) in ends:
                    out += bytes(total - len(out))  # a row completed in the call that met the end
                if len(out) == total:
                    if cut and i < len(idat) - 1:
                        raise ValueError("PNG chunk b'IDAT' is truncated (PIL: Truncated File Read)")
                    return bytes(out)
                if d.eof:
                    raise ValueError(truncated)
    except zlib.error as exc:
        raise ValueError(f"PNG image data is broken ({exc})") from None
    raise ValueError(truncated)


def png_samples(data: bytes) -> Tuple[np.ndarray, PngChunks]:
    """The samples of a PNG as the file stores them, (H, W, channels)
    uint16 (palette indices not looked up, sub-byte and 16-bit samples not
    scaled), and its chunks. Raises as ``decode_png`` does."""
    from ..kernels._build import load_host

    chunks = png_chunks(data)
    w, h, depth, colour, _, _, interlace = chunks.header
    if w * h > MAX_PIXELS:
        raise ValueError(f"PNG of {w}x{h} pixels is over the limit of {MAX_PIXELS} pixels (PIL's "
                         "decompression-bomb limit)")
    if depth not in _DEPTHS[colour]:
        raise ValueError(f"PNG bit depth {depth} is invalid for colour type {colour}")
    if interlace not in (0, 1):
        raise ValueError(f"PNG interlace method {interlace} is unknown")
    if w == 0 or h == 0:
        raise ValueError("PNG has no pixels")
    ch = _CHANNELS[colour]
    rows = [(pw * ch * depth + 7) // 8 + 1 for _, _, _, _, pw, ph in png_passes(w, h, interlace) for _ in range(ph)]
    raw = pil_inflate(chunks.idat, rows, chunks.cut)
    samples = np.empty((h, w, ch), np.uint16)
    err = ctypes.create_string_buffer(256)
    lib = load_host("png_decode", _bind_png)
    if lib.mvd_png_samples(raw, len(raw), w, h, depth, ch, interlace, samples.ctypes.data, err, len(err)):
        raise ValueError(err.value.decode())
    return samples, chunks


def decode_png(data: bytes, composite_alpha: bool = False) -> np.ndarray:
    """PNG bytes -> (H, W, 3) uint8 RGB, as PIL's ``convert("RGB")`` gives
    it from the mode PIL opens the file in (``png_mode``): gray replicated,
    alpha dropped, palette indices looked up, sub-byte gray scaled to 0-255
    (1-bit to 0 and 255), 16-bit samples cut to their high byte except
    16-bit gray, which ``I;16`` clips (a value over 255 gives 255). With
    ``composite_alpha`` an image PIL opens as RGBA (8- or 16-bit RGBA,
    16-bit gray+alpha) is first composited over white (``over_white``), as
    the data loaders do before the conversion. Takes every colour type at
    every bit depth PNG allows, interlaced (Adam7) or not; tRNS changes no
    pixel, as in ``convert("RGB")``. Raises ``ValueError`` on a damaged
    file, a palette index past the PLTE chunk and a header of more than
    ``MAX_PIXELS`` pixels. Inflates the rows as PIL does (``pil_inflate``).
    Raises ``RuntimeError`` when the scanline decoder cannot be built."""
    samples, chunks = png_samples(data)
    _, _, depth, colour, _, _, _ = chunks.header
    ch = _CHANNELS[colour]
    if colour == 3:
        if not chunks.plte:
            raise ValueError("palette PNG has no PLTE chunk")
        palette = np.frombuffer(chunks.plte, np.uint8).reshape(-1, 3)
        if samples.max(initial=0) >= len(palette):
            raise ValueError("palette PNG indexes past its PLTE chunk")
        return palette[samples[..., 0]]
    mode = png_mode(depth, colour)
    if mode == "I;16":
        pixels = np.minimum(samples, 255)
    elif depth == 16:
        pixels = samples >> 8
    elif depth < 8:
        pixels = samples * (255 // ((1 << depth) - 1))
    else:
        pixels = samples
    pixels = pixels.astype(np.uint8)
    if ch <= 2:  # gray (+ alpha)
        gray = np.repeat(pixels[..., :1], 3, axis=-1)
        if mode == "RGBA" and composite_alpha:
            return over_white(np.concatenate([gray, pixels[..., 1:]], axis=-1))
        return gray
    if mode == "RGBA" and composite_alpha:
        return over_white(pixels)
    return np.ascontiguousarray(pixels[..., :3])


def _bind_jpeg(lib: ctypes.CDLL) -> None:
    out_int = ctypes.POINTER(ctypes.c_int)
    lib.mvd_jpeg_info.argtypes = [ctypes.c_char_p, ctypes.c_size_t, out_int, out_int,
                                  ctypes.c_char_p, ctypes.c_int]
    lib.mvd_jpeg_info.restype = ctypes.c_int
    lib.mvd_jpeg_decode.argtypes = [ctypes.c_char_p, ctypes.c_size_t, ctypes.c_void_p, ctypes.c_int,
                                    ctypes.c_int, ctypes.c_char_p, ctypes.c_int]
    lib.mvd_jpeg_decode.restype = ctypes.c_int
    lib.mvd_jpeg_frame.argtypes = [ctypes.c_char_p, ctypes.c_size_t, ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int]
    lib.mvd_jpeg_frame.restype = ctypes.c_int
    lib.mvd_jpeg_decode_whole.argtypes = [ctypes.c_char_p, ctypes.c_size_t, ctypes.c_int, ctypes.c_void_p,
                                          ctypes.c_size_t, ctypes.c_char_p, ctypes.c_int]
    lib.mvd_jpeg_decode_whole.restype = ctypes.c_int


def decode_jpeg(data: bytes) -> np.ndarray:
    """JPEG bytes -> (H, W, 3) uint8 RGB, bitwise what PIL gives for
    ``Image.open(...).convert("RGB")`` (libjpeg's islow IDCT, fancy
    upsampling and fixed-point YCbCr tables; gray replicated; CMYK and
    YCCK through PIL's inverted CMYK and its ``convert("RGB")``; EXIF
    orientation not applied). Takes 8-bit JPEGs with 1, 3 or 4 components,
    any integral sampling and restart intervals: baseline, extended and
    progressive Huffman (a progressive file whose scans leave one of AC
    coefficients 1-9 unrefined block-smoothed as libjpeg smooths it),
    arithmetic-coded sequential and progressive (SOF9, SOF10, DAC
    conditioning), and lossless (SOF3: predictors 1-7, point transforms;
    gray, RGB or CMYK, the colour spaces libjpeg leaves unconverted in
    lossless mode). Raises ``ValueError`` naming what PIL refuses too
    (hierarchical SOF5-7 and SOF13-15, lossless arithmetic SOF11, 12-bit,
    a height of 0, lossless YCbCr or YCCK, an arithmetic scan that reads
    past the 65536-byte block of the file PIL has handed libjpeg), on a
    damaged file, and on a header of more pixels than PIL's
    decompression-bomb limit (twice ``Image.MAX_IMAGE_PIXELS``), before
    anything is allocated. Raises ``RuntimeError`` when the decoder cannot
    be built."""
    from ..kernels._build import load_host

    lib = load_host("jpeg_decode", _bind_jpeg)
    data = bytes(data)
    err = ctypes.create_string_buffer(256)
    w, h = ctypes.c_int(), ctypes.c_int()
    if lib.mvd_jpeg_info(data, len(data), ctypes.byref(w), ctypes.byref(h), err, len(err)):
        raise ValueError(err.value.decode())
    out = np.empty((h.value, w.value, 3), np.uint8)
    if lib.mvd_jpeg_decode(data, len(data), out.ctypes.data, w, h, err, len(err)):
        raise ValueError(err.value.decode())
    return out


def _bind_webp(lib: ctypes.CDLL) -> None:
    out_int = ctypes.POINTER(ctypes.c_int)
    lib.mvd_webp_info.argtypes = [ctypes.c_char_p, ctypes.c_size_t, out_int, out_int, out_int,
                                  ctypes.c_char_p, ctypes.c_int]
    lib.mvd_webp_info.restype = ctypes.c_int
    lib.mvd_webp_decode.argtypes = [ctypes.c_char_p, ctypes.c_size_t, ctypes.c_void_p, ctypes.c_int,
                                    ctypes.c_int, ctypes.c_char_p, ctypes.c_int]
    lib.mvd_webp_decode.restype = ctypes.c_int


def is_webp(data: bytes) -> bool:
    """Whether ``Image.open`` takes ``data`` for WebP
    (``WebPImagePlugin._accept``): ``RIFF``, ``WEBP`` at byte 8 and a
    first chunk of ``VP8 ``, ``VP8L`` or ``VP8X``."""
    return data[:4] == b"RIFF" and data[8:12] == b"WEBP" and data[12:16] in WEBP_CHUNKS


def decode_webp(data: bytes) -> Tuple[np.ndarray, str]:
    """WebP bytes -> (pixels, mode), what PIL 12.1.0 gives for
    ``np.asarray(Image.open(...))`` and its ``mode``: (H, W, 3) uint8 and
    ``"RGB"``, or (H, W, 4) and ``"RGBA"`` (not premultiplied) where libwebp
    reports alpha (a VP8L alpha bit, an ALPH chunk, the VP8X alpha flag).
    Takes simple lossy (VP8) and lossless (VP8L) files and the extended
    container (VP8X: ALPH, ICCP/EXIF/XMP skipped); of an animation, the
    first frame on a canvas of zeros, as PIL's first frame. Bitwise
    libwebp 1.6.0 (``csrc/webp_decode.cpp``). Raises ``ValueError`` where
    PIL raises: a container libwebp's demuxer refuses, a non-key or hidden
    VP8 frame, a bad VP8 start code or VP8L signature or version, truncated
    chunks or partitions, invalid prefix codes; and on a canvas of more
    pixels than PIL's decompression-bomb limit, before anything is
    allocated. Raises ``RuntimeError`` when the decoder cannot be built."""
    from ..kernels._build import load_host

    lib = load_host("webp_decode", _bind_webp)
    data = bytes(data)
    err = ctypes.create_string_buffer(256)
    w, h, alpha = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
    if lib.mvd_webp_info(data, len(data), ctypes.byref(w), ctypes.byref(h), ctypes.byref(alpha), err, len(err)):
        raise ValueError(err.value.decode())
    rgba = np.empty((h.value, w.value, 4), np.uint8)
    if lib.mvd_webp_decode(data, len(data), rgba.ctypes.data, w, h, err, len(err)):
        raise ValueError(err.value.decode())
    if alpha.value:
        return rgba, "RGBA"
    return np.ascontiguousarray(rgba[..., :3]), "RGB"


class PilImage(NamedTuple):
    """An image as PIL holds it after ``Image.open(...).load()``, whatever
    the format (GIF, BMP, TIFF, the PPM family, TGA, ICO/CUR, QOI, PCX,
    SGI, PSD, DDS): ``pixels`` (H, W) uint8 for modes 1 (0 or 255), L and
    P; (H, W) uint16 for I;16 and I;16B; (H, W) int32 for I and float32 for
    F; (H, W, 4) uint8 for RGB (also (H, W, 3)), RGBA, CMYK, LAB (L, a +
    128, b + 128, 255), LA (L, L, L, A) and PA (P, 0, 0, A); ``mode``; and
    ``palette`` (entries x 3 uint8) for P and PA, else None (black)."""
    pixels: np.ndarray
    mode: str
    palette: Optional[np.ndarray] = None


# Image._MAPMODES: the modes ImageFile.load memory-maps a file opened by
# path in, where the tile's rawmode is the mode itself
MAPMODES = ("L", "P", "RGBX", "RGBA", "CMYK", "I;16", "I;16L", "I;16B")
PAGE = 4096  # mmap's page: the bytes past a file's end to its last page's end read as zeros


def pil_mapped(data: bytes, offset: int, size: Tuple[int, int], mode: str, stride: int,
               ystep: int) -> Optional[np.ndarray]:
    """What ``ImageFile.load`` gives for a file PIL opened by path whose one
    raw tile it memory-maps (``Image.core.map_buffer``): (ysize, xsize,
    pixel bytes) uint8, row y of the image (the last row first where
    ``ystep`` < 0) ``stride`` bytes after row y - 1 from ``offset`` on,
    ``size`` (xsize, ysize) PIL's size of the image before its EXIF
    transpose (the size already turned where the orientation is 5-8). A
    stride of 0 is the mode's row (a byte, two or four a pixel). Returns
    None where PIL's own check that ``offset + ysize * stride`` fits the
    file fails and it decodes the tile instead; raises ``ValueError`` where
    ``map_buffer`` refuses the size (PIL raises it) or a row reaches past
    the last page of the file (PIL's read there faults)."""
    xs, ys = size
    if offset < 0:
        raise ValueError("Tile offset cannot be negative")
    if offset + ys * stride > len(data):
        return None
    pixel = 1 if mode in ("L", "P") else 2 if mode.startswith("I;16") else 4
    if stride <= 0:
        stride = xs * pixel
    if offset + ys * stride > len(data):
        raise ValueError(f"the {xs}x{ys} image PIL maps from the file at offset {offset} does not fit in it "
                         "(PIL: buffer is not large enough)")
    row = xs * pixel
    end = offset + (ys - 1) * stride + row
    if end > -(-len(data) // PAGE) * PAGE:
        raise ValueError("the image PIL maps from the file reads past the file's last page (PIL's read faults)")
    buf = np.zeros(max(end, len(data)), np.uint8)
    buf[:len(data)] = np.frombuffer(data, np.uint8)
    starts = offset + np.arange(ys, dtype=np.int64) * stride
    rows = buf[starts[:, None] + np.arange(row)]
    if ystep < 0:
        rows = rows[::-1]
    return np.ascontiguousarray(rows.reshape(ys, xs, pixel))


def _muldiv255(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    t = a * b + 128
    return ((t >> 8) + t) >> 8


def pil_rgb(img: PilImage, composite_alpha: bool = False) -> np.ndarray:
    """``convert("RGB")`` of an image in any mode PIL opens GIF, BMP, TIFF and
    the small formats in (LAB through ``utils/lcms.py``, as PIL converts it
    with LittleCMS):
    gray replicated (1, L, LA), palette indices looked up in a table whose
    missing entries are black (P, PA), 16-bit gray clipped at 255 (I;16,
    I;16B: 256 and 65535 give 255), I clipped to 0-255, F truncated toward
    zero then clipped (NaN gives 0), CMYK as PIL's ``cmyk2rgb`` (K' -
    MULDIV255(C, K'), K' = 255 - K), RGB and RGBA's first three bands. With
    ``composite_alpha`` an image whose mode is exactly RGBA is first
    composited over white (``over_white``), as the data loaders do; LA and
    PA are not."""
    px, mode = img.pixels, img.mode
    if mode in ("1", "L"):
        return np.repeat(px[..., None], 3, axis=-1)
    if mode in ("P", "PA"):
        table = np.zeros((256, 3), np.uint8)
        if img.palette is not None:
            table[:len(img.palette)] = img.palette[:256]
        return table[px if mode == "P" else px[..., 0]]
    if mode == "LA":
        return np.repeat(px[..., :1], 3, axis=-1)
    if mode in ("I;16", "I;16B"):
        gray = np.minimum(px, 255).astype(np.uint8)
    elif mode == "I":
        gray = np.clip(px, 0, 255).astype(np.uint8)
    elif mode == "F":
        with np.errstate(invalid="ignore"):
            gray = np.where(np.isnan(px), 0, np.clip(np.trunc(px), 0, 255)).astype(np.uint8)
    elif mode == "CMYK":
        cmy, k = px[..., :3].astype(np.int64), px[..., 3:].astype(np.int64)
        nk = 255 - k
        return np.clip(nk - _muldiv255(cmy, nk), 0, 255).astype(np.uint8)
    elif mode == "LAB":  # ImageCms: LittleCMS's Lab -> sRGB transform
        from .lcms import lab_to_rgb

        return lab_to_rgb(px)
    elif mode == "RGBA" and composite_alpha:
        return over_white(px)
    elif mode in ("RGB", "RGBA"):
        return np.ascontiguousarray(px[..., :3])
    else:
        raise ValueError(f"no conversion of PIL mode {mode!r} to RGB")
    return np.repeat(gray[..., None], 3, axis=-1)


def _bind_gif(lib: ctypes.CDLL) -> None:
    out_int = ctypes.POINTER(ctypes.c_int)
    lib.mvd_gif_info.argtypes = [ctypes.c_char_p, ctypes.c_size_t, out_int, out_int, out_int, out_int, out_int,
                                 ctypes.c_char_p, ctypes.c_int]
    lib.mvd_gif_info.restype = ctypes.c_int
    lib.mvd_gif_decode.argtypes = [ctypes.c_char_p, ctypes.c_size_t, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                                   ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int]
    lib.mvd_gif_decode.restype = ctypes.c_int


def decode_gif(data: bytes) -> PilImage:
    """GIF bytes -> the first frame as PIL 12.1.0 holds it: mode P with its
    colour table (local, else global) or, where that table is the identity
    gray ramp PIL drops, mode L; the image grown to hold a frame that
    reaches past the logical screen, filled outside the frame with the
    graphic control extension's transparency index, else 0; LZW with clear
    and end codes, interlaced rows (``csrc/gif_decode.cpp``). A transparent
    GIF stays mode P. Raises ``ValueError`` where PIL raises (no image, a
    broken LZW stream, data ending before the frame's last pixel, more
    pixels than PIL's decompression-bomb limit) and ``RuntimeError`` when
    the decoder cannot be built."""
    from ..kernels._build import load_host

    lib = load_host("gif_decode", _bind_gif)
    data = bytes(data)
    err = ctypes.create_string_buffer(256)
    w, h, pmode, entries, trns = (ctypes.c_int() for _ in range(5))
    if lib.mvd_gif_info(data, len(data), ctypes.byref(w), ctypes.byref(h), ctypes.byref(pmode),
                        ctypes.byref(entries), ctypes.byref(trns), err, len(err)):
        raise ValueError(err.value.decode())
    pixels = np.full((h.value, w.value), max(trns.value, 0), np.uint8)
    palette = np.zeros((entries.value, 3), np.uint8)
    if lib.mvd_gif_decode(data, len(data), pixels.ctypes.data, w, h, palette.ctypes.data, err, len(err)):
        raise ValueError(err.value.decode())
    return PilImage(pixels, "P", palette) if pmode.value else PilImage(pixels, "L")


def _bind_bmp(lib: ctypes.CDLL) -> None:
    out_int = ctypes.POINTER(ctypes.c_int)
    lib.mvd_bmp_info.argtypes = [ctypes.c_char_p, ctypes.c_size_t, out_int, out_int, ctypes.c_char_p, out_int,
                                 ctypes.c_char_p, ctypes.c_int]
    lib.mvd_bmp_info.restype = ctypes.c_int
    lib.mvd_bmp_decode.argtypes = [ctypes.c_char_p, ctypes.c_size_t, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                                   ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int]
    lib.mvd_bmp_decode.restype = ctypes.c_int
    lib.mvd_bmp_layout.argtypes = [ctypes.c_char_p, ctypes.c_size_t, out_int, ctypes.POINTER(ctypes.c_int64),
                                   ctypes.POINTER(ctypes.c_int64), out_int, ctypes.c_void_p, ctypes.c_char_p,
                                   ctypes.c_int]
    lib.mvd_bmp_layout.restype = ctypes.c_int


def is_dib(data: bytes) -> bool:
    """Whether ``Image.open`` takes ``data`` for a DIB
    (``BmpImagePlugin._dib_accept``): its first little-endian int32 is a
    bitmap header size PIL knows."""
    return len(data) >= 4 and struct.unpack("<I", data[:4])[0] in DIB_HEADERS


def decode_bmp(data: bytes, from_path: bool = False) -> PilImage:
    """BMP bytes (or a DIB: the same without the 14-byte file header) ->
    the image as PIL 12.1.0's BmpImagePlugin holds it: 1-, 4- and 8-bit
    pixels in mode P, or 1 or L where the palette is black and white or
    the identity gray ramp; 16-, 24- and 32-bit BI_RGB in mode RGB (a
    32-bit pixel's fourth byte dropped); BI_BITFIELDS by PIL's table of
    masks (RGBA only with an alpha mask); RLE8 and RLE4 as PIL's
    ``BmpRleDecoder`` decodes them; headers of 12 (OS/2 1), 40, 52, 56, 64,
    108 and 124 bytes; bottom-up or top-down (``csrc/bmp_decode.cpp``).
    ``from_path``: the file as PIL reads it opened by path, which maps the
    pixels of a raw tile whose rawmode is its mode (L, P, RGBA) from the
    file (``pil_mapped``), rows of a gray-ramp L image at its palette
    depth's stride included (ROADMAP Queue 3, fault 13's BMP class).
    Raises ``ValueError`` where PIL raises and ``RuntimeError`` when the
    decoder cannot be built."""
    from ..kernels._build import load_host

    lib = load_host("bmp_decode", _bind_bmp)
    data = bytes(data)
    err = ctypes.create_string_buffer(256)
    mode = ctypes.create_string_buffer(8)
    w, h, entries = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
    if lib.mvd_bmp_info(data, len(data), ctypes.byref(w), ctypes.byref(h), mode, ctypes.byref(entries), err,
                        len(err)):
        raise ValueError(err.value.decode())
    mode = mode.value.decode()
    shape = (h.value, w.value) if mode in ("1", "L", "P") else (h.value, w.value, 4)
    pixels = np.zeros(shape, np.uint8)
    palette = np.zeros((entries.value, 3), np.uint8)
    mapped = None
    if from_path and mode in MAPMODES:
        raw_is_mode, offset, stride, direction = ctypes.c_int(), ctypes.c_int64(), ctypes.c_int64(), ctypes.c_int()
        if lib.mvd_bmp_layout(data, len(data), ctypes.byref(raw_is_mode), ctypes.byref(offset), ctypes.byref(stride),
                              ctypes.byref(direction), palette.ctypes.data, err, len(err)):
            raise ValueError(err.value.decode())
        if raw_is_mode.value:
            mapped = pil_mapped(data, offset.value, (w.value, h.value), mode, stride.value, direction.value)
    if mapped is not None:
        pixels = mapped.reshape(shape)
    elif lib.mvd_bmp_decode(data, len(data), pixels.ctypes.data, w, h, palette.ctypes.data, err, len(err)):
        raise ValueError(err.value.decode())
    return PilImage(pixels, mode, palette if mode == "P" else None)


def decode_image(data: bytes, composite_alpha: bool = False, from_path: bool = False) -> np.ndarray:
    """Image bytes -> (H, W, 3) uint8 RGB, the format chosen as
    ``Image.open`` chooses it: PIL 12.1.0's plugins in its order
    (``utils/small_formats.py:PLUGINS``: BMP, DIB, GIF, JPEG, PPM, PNG,
    then ``Image.ID``'s, among them CUR, PCX, DDS, ICO, TIFF, PSD, QOI,
    SGI, TGA, which has no signature and is tried on what reaches it, and
    WebP), each plugin's ``_accept`` on the first 16 bytes, a plugin whose
    ``_open`` gives way passing the file on. ``decode_bmp``,
    ``decode_gif``, ``decode_tiff`` and the small formats (PPM, PGM, PBM,
    PFM, TGA, ICO, CUR, QOI, PCX, SGI, PSD, DDS with BC1-BC7) give PIL's
    image in PIL's mode and ``pil_rgb`` converts it; ``decode_png`` (an
    APNG's default image, PIL's first frame), ``decode_jpeg`` and
    ``decode_webp`` give RGB. What PIL reads and the port does not (among
    TIFFs: CCITT, ThunderScan, SGILog, old-style JPEG with its tables in
    tags, planar YCbCr; PIL's other formats: AVIF, JPEG 2000, SUN, ICNS and
    the rest) raises ``ValueError`` naming the format and ROADMAP item 13c.
    With ``composite_alpha`` an image PIL opens as RGBA is first
    composited over white (``over_white``), as the data loaders do; other
    modes are converted as ``convert("RGB")`` converts them.
    ``from_path``: the image PIL gives for the file opened by its path
    (``Image.open(path)``, the JAX ``load_image``), which differs from the
    bytes' only where PIL memory-maps a raw tile (``pil_mapped``). A file
    no plugin opens raises ``ValueError`` in PIL's words, "cannot identify
    image file", with each plugin's reason for passing it on."""
    from .small_formats import identify

    _, opened = identify(bytes(data))
    img = opened.load(from_path)
    if isinstance(img, PilImage):
        return pil_rgb(img, composite_alpha)
    return img(composite_alpha)


def _lanczos3(x: np.ndarray) -> np.ndarray:
    out = np.sinc(x) * np.sinc(x / 3.0)
    return np.where((x >= -3.0) & (x < 3.0), out, 0.0)


_PRECISION_BITS = 22  # PIL's fixed point for 8-bit images (32 - 8 - 2)


def _resize_axis(img: np.ndarray, out_size: int, axis: int) -> np.ndarray:
    """One Lanczos-3 pass over ``axis`` of a uint8 array, as PIL computes
    it: support 3 times the scale where it shrinks, taps clamped to the
    image and renormalized, coefficients in 22-bit fixed point, the sum
    rounded and clipped to uint8."""
    in_size = img.shape[axis]
    scale = in_size / out_size
    filterscale = max(scale, 1.0)
    support = 3.0 * filterscale
    ksize = int(math.ceil(support)) * 2 + 1
    centers = (np.arange(out_size) + 0.5) * scale
    xmin = np.maximum(np.trunc(centers - support + 0.5).astype(np.int64), 0)
    xmax = np.minimum(np.trunc(centers + support + 0.5).astype(np.int64), in_size) - xmin
    taps = np.arange(ksize)
    weights = _lanczos3((taps[None] + xmin[:, None] - centers[:, None] + 0.5) / filterscale)
    weights = np.where(taps[None] < xmax[:, None], weights, 0.0)
    total = weights.sum(axis=1, keepdims=True)
    weights = np.where(total != 0.0, weights / np.where(total != 0.0, total, 1.0), weights)
    one = float(1 << _PRECISION_BITS)
    fixed = np.where(weights < 0, np.trunc(-0.5 + weights * one), np.trunc(0.5 + weights * one))
    fixed = fixed.astype(np.int64)
    index = np.minimum(xmin[:, None] + taps[None], in_size - 1)
    src = np.moveaxis(img, axis, 0).astype(np.int64)
    acc = np.full((out_size,) + src.shape[1:], 1 << (_PRECISION_BITS - 1), np.int64)
    bcast = (slice(None),) + (None,) * (src.ndim - 1)
    for k in range(ksize):
        acc += src[index[:, k]] * fixed[:, k][bcast]
    out = np.clip(acc >> _PRECISION_BITS, 0, 255).astype(np.uint8)
    return np.moveaxis(out, 0, axis)


def resize(img: np.ndarray, height: int, width: int) -> np.ndarray:
    """(H, W, C) uint8 -> (height, width, C) uint8 by Lanczos-3, standing in
    for PIL's ``resize((width, height), Image.LANCZOS)``: the horizontal
    pass first, rounded to uint8, then the vertical one."""
    img = np.asarray(img)
    if img.dtype != np.uint8 or img.ndim != 3:
        raise ValueError(f"resize takes (H, W, C) uint8, got {img.shape} {img.dtype}")
    if img.shape[1] != width:
        img = _resize_axis(img, width, 1)
    if img.shape[0] != height:
        img = _resize_axis(img, height, 0)
    return img


def save_image(img: np.ndarray, path: str):
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "wb") as f:
        f.write(encode_png(to_uint8(img)))


def load_image(path: str, size: Optional[int] = None) -> np.ndarray:
    """An image ``decode_image`` reads -> (H, W, 3) float32 in [-1, 1] (reference utils.py:36-48,
    NHWC; alpha dropped as ``convert("RGB")`` drops it), resized to
    (size, size) where it differs. Read as ``Image.open(path)`` reads the
    file (``from_path``)."""
    with open(path, "rb") as f:
        img = decode_image(f.read(), from_path=True)
    if size is not None and img.shape[:2] != (size, size):
        img = resize(img, size, size)
    arr = img.astype(np.float32) / 255.0
    return arr * 2.0 - 1.0


def side_by_side(images: Sequence[np.ndarray], pad: int = 4) -> np.ndarray:
    """Horizontal comparison sheet (reference infer.py:140-155,
    training.py:365-389 comparison panels)."""
    imgs = [to_uint8(i) for i in images]
    h = max(i.shape[0] for i in imgs)
    total_w = sum(i.shape[1] for i in imgs) + pad * (len(imgs) - 1)
    canvas = np.full((h, total_w, 3), 255, np.uint8)
    x = 0
    for i in imgs:
        canvas[: i.shape[0], x : x + i.shape[1]] = i
        x += i.shape[1] + pad
    return canvas
