"""Write the PPM/PGM/PBM/PFM, TGA, ICO/CUR, QOI, PCX, SGI, PSD and DDS
fixtures of ``tests/test_torch_port_small_formats.py`` and ``chip_smoke.py``
phase 9, and ``small_formats_sha256.json``: for each file PIL's mode and the
sha256 and shape of ``Image.open(...).convert("RGB")`` (and, for a file PIL
opens as RGBA, of the data loaders' white composite), or PIL's refusal;
under "frames", PIL's digests of phase 9d's sources (``frame_small_forms``
of CO3D's frame ``frame_a.jpg``).

    python tests/fixtures/torch_port_images/make_small_formats.py

PIL writes what it can: PPM (P4, P5, P6, Pf), TGA raw and RLE, ICO with PNG
or BMP frames, QOI, PCX, SGI uncompressed and DDS uncompressed, DXT1, DXT3,
DXT5 and BC5. The writers below write every form byte by byte, PIL's
included: ``ppm_file`` (P1-P6, Pf, P0CMYK and PIL's Py forms, any maxval,
plain tokens with comments and any whitespace), ``tga_file`` (image types 1,
2, 3, 9, 10, 11, colour maps of 16, 24 and 32 bits with a first index, an
ID field, the four orientations) over ``tga_rle`` (runs within a row,
literals that may cross rows), ``icon_file`` (ICO or CUR, PNG or BMP frames
with an AND mask or 32-bit alpha), ``qoi_file`` (the reference encoder's
index, diff, luma and run ops), ``pcx_file`` (1 bit, 2 and 4 EGA planes,
8-bit gray or VGA palette, 24-bit planes, a padded stride), ``sgi_file``
(verbatim or RLE, 8 or 16 bits, 1 to 4 channels), ``psd_file`` (the merged
image of every mode PIL reads, raw or PackBits, with resources and a layer
section) and ``dds_file`` (masks, L, LA, P, DXT/BCn four-character codes
and the DX10 header) with the block encoders ``bc1_blocks`` and
``bc7_blocks`` (mode 6). The writers import no PIL: ``chip_smoke.py`` loads
this file on a host without PIL to write phase 9d's sources. Every file
comes from a fixed seed, so the script writes the same bytes on every run.
"""

from __future__ import annotations

import importlib.util
import json
import os
import struct
import sys
import zlib

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
JPEG_DIR = os.path.join(os.path.dirname(HERE), "torch_port_jpeg")
DIGESTS = "small_formats_sha256.json"


def _sibling(name: str):
    spec = importlib.util.spec_from_file_location(f"torch_port_images_{name}", os.path.join(HERE, f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


FORMATS = _sibling("make_formats")  # bmp_file, bmp_rows, pil_digest, _photo, _pil

# ------------------------------------------------------------------ runs


def runs(row: np.ndarray) -> tuple:
    """(starts, lengths, values) of the runs of equal items along a 1-D
    array (items may be rows of bytes: pixels)."""
    row = np.asarray(row)
    n = len(row)
    if n == 0:
        return np.zeros(0, np.int64), np.zeros(0, np.int64), row[:0]
    flat = row.reshape(n, -1)
    change = np.any(flat[1:] != flat[:-1], axis=1)
    starts = np.concatenate([[0], np.nonzero(change)[0] + 1])
    lengths = np.diff(np.concatenate([starts, [n]]))
    return starts, lengths, row[starts]


def _segments(row: np.ndarray, min_run: int, max_len: int):
    """Runs of at least ``min_run`` equal items as ("run", value, n) and
    the rest as ("lit", items), each at most ``max_len`` long."""
    starts, lengths, _ = runs(row)
    lit_from = None
    for s, n in zip(starts.tolist(), lengths.tolist()):
        if n >= min_run:
            if lit_from is not None:
                for a in range(lit_from, s, max_len):
                    yield "lit", row[a:min(s, a + max_len)]
                lit_from = None
            for a in range(s, s + n, max_len):
                yield "run", row[a], min(max_len, s + n - a)
        elif lit_from is None:
            lit_from = s
    if lit_from is not None:
        for a in range(lit_from, len(row), max_len):
            yield "lit", row[a:min(len(row), a + max_len)]


def packbits_row(row: np.ndarray) -> bytes:
    """PackBits of one row: runs of 3 to 128 as repeats, literals of at
    most 128."""
    out = bytearray()
    for seg in _segments(np.asarray(row, np.uint8), 3, 128):
        if seg[0] == "run":
            out += bytes([257 - seg[2], int(seg[1])])
        else:
            out += bytes([len(seg[1]) - 1]) + seg[1].tobytes()
    return bytes(out)


# ------------------------------------------------------------------ PPM


def ppm_file(pixels: np.ndarray, magic: bytes, maxval: int = 255, *, comments: bool = False, seps=(b"\n",),
             scale: float = -1.0, line: int = 70) -> bytes:
    """A Netpbm file of ``magic``: P1/P4 (H, W) bits, 1 black; P2/P5 (H, W)
    and P3/P6 (H, W, 3) samples up to ``maxval`` (16-bit big-endian past
    255); P0CMYK, PyP, PyRGBA, PyCMYK raw bytes; Pf (H, W) float32, rows
    bottom-up, little-endian where ``scale`` < 0. ``comments``: a comment
    between header tokens and, in the plain forms, between samples;
    ``seps``: the whitespace between tokens, cycled."""
    pixels = np.asarray(pixels)
    h, w = pixels.shape[:2]
    k = [0]

    def sep() -> bytes:
        k[0] += 1
        return seps[k[0] % len(seps)]

    head = [magic, str(w).encode(), str(h).encode()]
    if magic == b"Pf":
        head.append(repr(float(scale)).encode())
    elif magic not in (b"P1", b"P4"):
        head.append(str(maxval).encode())
    out = bytearray(head[0])
    for token in head[1:]:
        out += sep() + (b"# a comment\n" if comments else b"") + token
    out += b"\n"
    if magic in (b"P1", b"P2", b"P3"):
        flat = pixels.reshape(-1)
        words = [b"1" if v else b"0" for v in flat] if magic == b"P1" else [str(int(v)).encode() for v in flat]
        body, col = bytearray(), 0
        for i, word in enumerate(words):
            body += word
            col += len(word) + 1
            if comments and i % 37 == 5:
                body += b" #x 12 34\n"
                col = 0
            elif col > line:
                body += b"\n"
                col = 0
            else:
                body += b"" if magic == b"P1" and i % 3 else sep() if magic != b"P1" else b" "
        return bytes(out + body)
    if magic == b"P4":
        return bytes(out) + np.packbits(pixels.astype(np.uint8), axis=1).tobytes()
    if magic == b"Pf":
        rows = pixels.astype("<f4" if scale < 0 else ">f4")[::-1]
        return bytes(out) + rows.tobytes()
    dtype = np.uint8 if maxval < 256 else ">u2"
    return bytes(out) + pixels.astype(dtype).tobytes()


# ------------------------------------------------------------------ TGA


def tga_rle(rows: np.ndarray, depth: int, cross: bool = False) -> bytes:
    """TGA RLE of (H, row bytes) rows of ``depth``-byte pixels: runs of 2
    to 128 equal pixels as repeats, the rest literals of at most 128; a
    run never crosses a row's end (PIL refuses it), a literal does where
    ``cross``."""
    h = rows.shape[0]
    px = rows.reshape(h, -1, depth)
    w = px.shape[1]
    out = bytearray()
    if not cross:
        for row in px:
            for seg in _segments(row, 2, 128):
                if seg[0] == "run":
                    out += bytes([0x80 | (seg[2] - 1)]) + seg[1].tobytes()
                else:
                    out += bytes([len(seg[1]) - 1]) + seg[1].tobytes()
        return bytes(out)
    flat = px.reshape(-1, depth)
    same = np.concatenate([np.all(flat[1:] == flat[:-1], axis=1), [False]])  # pixel i equals pixel i + 1
    same &= (np.arange(len(flat)) + 1) % w != 0  # ... in the same row
    i, n = 0, len(flat)
    while i < n:
        if same[i]:
            j = i + 1
            while j < n and j - i < 128 and same[j - 1]:
                j += 1
            out += bytes([0x80 | (j - i - 1)]) + flat[i].tobytes()
            i = j
            continue
        k = i + 1
        while k < n and k - i < 128 and not same[k]:
            k += 1
        out += bytes([k - i - 1]) + flat[i:k].tobytes()
        i = k
    return bytes(out)


def tga_file(rows: np.ndarray, width: int, height: int, imagetype: int, depth: int, *, cmap=None,
             top: bool = True, right: bool = False, id_field: bytes = b"", cross: bool = False,
             attr_bits: int = 0) -> bytes:
    """A TGA: (height, row bytes) pixel rows top to bottom, left to right,
    stored in the file's order (``top``: top-down, else bottom-up;
    ``right``: each row right to left); RLE for types 9-11; ``cmap``
    (first index, entry depth, entry bytes)."""
    px = np.asarray(rows, np.uint8)
    k = max(depth // 8, 1)
    if right and depth >= 8:
        px = px.reshape(height, width, k)[:, ::-1].reshape(height, -1)
    if not top:
        px = px[::-1]
    start, mapdepth, entries = cmap if cmap else (0, 0, b"")
    count = len(entries) // max(mapdepth // 8, 1) if cmap else 0
    flags = (0x20 if top else 0) | (0x10 if right else 0) | attr_bits
    head = struct.pack("<BBBHHBHHHHBB", len(id_field), 1 if cmap else 0, imagetype, start, count, mapdepth, 0, 0,
                       width, height, depth, flags)
    body = tga_rle(px, k, cross) if imagetype & 8 else px.tobytes()
    return head + id_field + entries + body


def tga_image(img: np.ndarray, mode: str, **kw) -> bytes:
    """(H, W[, C]) pixels in PIL's ``mode`` (1, L, LA, P, RGB, RGBA) as the
    TGA PIL writes for that mode (RLE with ``rle``), in any orientation."""
    rle = kw.pop("rle", False)
    img = np.asarray(img)
    h, w = img.shape[:2]
    if mode == "1":
        rows, imagetype, depth = np.packbits(img.astype(bool), axis=1), 3, 1
    elif mode in ("L", "P"):
        rows, imagetype, depth = img.astype(np.uint8), 3 if mode == "L" else 1, 8
    elif mode == "LA":
        rows, imagetype, depth = img.reshape(h, -1), 3, 16
    elif mode == "RGB":
        rows, imagetype, depth = img[..., ::-1].reshape(h, -1), 2, 24
    else:
        rows, imagetype, depth = img[..., [2, 1, 0, 3]].reshape(h, -1), 2, 32
    return tga_file(rows, w, h, imagetype + (8 if rle else 0), depth, **kw)


def bgr15(rgb: np.ndarray, alpha_bit=None) -> np.ndarray:
    """(…, 3) 5-bit channels as little-endian 16-bit BGRA;15 words."""
    v = (rgb[..., 0].astype(np.uint16) << 10) | (rgb[..., 1].astype(np.uint16) << 5) | rgb[..., 2]
    if alpha_bit is not None:
        v |= np.asarray(alpha_bit, np.uint16) << 15
    return v.astype("<u2").view(np.uint8).reshape(*v.shape, 2)


# ------------------------------------------------------------------ ICO / CUR


def png_rgba(rgba: np.ndarray) -> bytes:
    """An 8-bit RGBA PNG, filter 0 (imports no PIL)."""
    h, w, ch = rgba.shape

    def chunk(kind: bytes, body: bytes) -> bytes:
        return struct.pack(">I", len(body)) + kind + body + struct.pack(">I", zlib.crc32(kind + body))

    raw = np.concatenate([np.zeros((h, 1), np.uint8), rgba.reshape(h, -1)], axis=1).tobytes()
    colour = {1: 0, 3: 2, 4: 6}[ch]
    return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, colour, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(raw)) + chunk(b"IEND", b""))


def icon_bmp(pixels: np.ndarray, bits: int, *, palette=None, mask=None, header: int = 40) -> bytes:
    """An icon's BMP frame: a DIB of twice the height, the XOR rows (1-8
    bit indices with ``palette``, 24-bit RGB or 32-bit BGRA; bottom-up)
    then the AND mask (``mask`` (H, W) bools, True transparent; 1-bit rows
    padded to 32 bits)."""
    h, w = pixels.shape[:2]
    if bits == 24:
        xor = FORMATS.bmp_rows(pixels[..., ::-1], 24)
    elif bits == 32:
        xor = FORMATS.bmp_rows(pixels[..., [2, 1, 0, 3]], 32)
    else:
        xor = FORMATS.bmp_rows(pixels, bits)
    m = np.zeros((h, w), bool) if mask is None else mask
    body = xor + FORMATS.bmp_rows(m.astype(np.uint8), 1)
    dib = FORMATS.bmp_file(body, w, 2 * h, bits, header=header, palette=palette, dib=True)
    if header == 40:  # the DIB's image size field: the XOR rows only, as icon writers set it
        dib = dib[:20] + struct.pack("<I", len(xor)) + dib[24:]
    return dib


def icon_file(frames: list, cur: bool = False) -> bytes:
    """An ICO (or CUR) of ``frames``: (width, height, colours, bpp or hotspot
    y, frame bytes); the directory's sizes as given (256 written as 0)."""
    out = struct.pack("<HHH", 0, 2 if cur else 1, len(frames))
    offset = 6 + 16 * len(frames)
    table, body = b"", b""
    for w, h, colours, bpp, data in frames:
        table += struct.pack("<BBBBHHII", w % 256, h % 256, colours, 0, 1 if not cur else 3, bpp, len(data),
                             offset + len(body))
        body += data
    return out + table + body


# ------------------------------------------------------------------ QOI


def qoi_file(img: np.ndarray, channels: int = None, *, colorspace: int = 0) -> bytes:
    """The QOI reference encoder: runs, index hits, small diffs, luma,
    RGB and RGBA ops; the 8-byte end marker."""
    img = np.asarray(img, np.uint8)
    h, w, ch = img.shape
    channels = channels or ch
    px = np.concatenate([img.reshape(-1, ch), np.full((h * w, 1), 255, np.uint8)], axis=1)[:, :4] if ch == 3 \
        else img.reshape(-1, 4)
    out = bytearray(b"qoif" + struct.pack(">IIBB", w, h, channels, colorspace))
    seen = [None] * 64
    prev = (0, 0, 0, 255)
    run = 0
    pixels = [tuple(p) for p in px.tolist()]
    n = len(pixels)
    for i, p in enumerate(pixels):
        if p == prev:
            run += 1
            if run == 62 or i == n - 1:
                out.append(0xC0 | (run - 1))
                run = 0
            continue
        if run:
            out.append(0xC0 | (run - 1))
            run = 0
        h_ = (p[0] * 3 + p[1] * 5 + p[2] * 7 + p[3] * 11) % 64
        if seen[h_] == p:
            out.append(h_)
        else:
            seen[h_] = p
            if p[3] == prev[3]:
                dr, dg, db = ((p[k] - prev[k] + 128) % 256 - 128 for k in range(3))
                if -2 <= dr <= 1 and -2 <= dg <= 1 and -2 <= db <= 1:
                    out.append(0x40 | (dr + 2) << 4 | (dg + 2) << 2 | (db + 2))
                elif -32 <= dg <= 31 and -8 <= dr - dg <= 7 and -8 <= db - dg <= 7:
                    out += bytes([0x80 | (dg + 32), (dr - dg + 8) << 4 | (db - dg + 8)])
                else:
                    out += bytes([0xFE, p[0], p[1], p[2]])
            else:
                out += bytes([0xFF, *p])
        prev = p
    return bytes(out + b"\0" * 7 + b"\1")


# ------------------------------------------------------------------ PCX


def pcx_rle(row: np.ndarray) -> bytes:
    """PCX RLE of a row of bytes: runs of up to 63, a lone byte below
    0xC0 as itself."""
    _, lengths, values = runs(np.asarray(row, np.uint8))
    chunks = -(-lengths // 63)  # each run cut into pieces of at most 63
    value = np.repeat(values, chunks)
    count = np.full(int(chunks.sum()), 63, np.int64)
    count[np.cumsum(chunks) - 1] = lengths - 63 * (chunks - 1)
    single = (count == 1) & (value < 0xC0)
    out = np.zeros((len(value), 2), np.int64)
    out[:, 0] = np.where(single, value, 0xC0 | count)
    out[:, 1] = value
    keep = np.ones((len(value), 2), bool)
    keep[:, 1] = ~single
    return out[keep].astype(np.uint8).tobytes()


def pcx_file(planes_rows: np.ndarray, width: int, height: int, bits: int, planes: int, *, version: int = 5,
             ega=None, vga=None, stride: int = None, header_stride: int = None) -> bytes:
    """A PCX: (height, planes, stride) bytes, each plane's row RLE-coded
    (every scanline's planes one after the other); ``ega`` 16 x 3 header
    palette, ``vga`` 256 x 3 palette after the 0x0C byte at the end;
    ``header_stride``: the bytes-per-line field (default ``stride``)."""
    rows = np.asarray(planes_rows, np.uint8)
    stride = stride or rows.shape[2]
    head = bytearray(128)
    head[0:4] = bytes([10, version, 1, bits])
    struct.pack_into("<HHHHHH", head, 4, 0, 0, width - 1, height - 1, 72, 72)
    if ega is not None:
        head[16:64] = np.asarray(ega, np.uint8).reshape(-1)[:48].tobytes().ljust(48, b"\0")
    head[65] = planes
    struct.pack_into("<HH", head, 66, stride if header_stride is None else header_stride, 1)
    body = bytearray()
    for y in range(height):
        body += pcx_rle(rows[y].reshape(-1))
    tail = b"\x0c" + np.asarray(vga, np.uint8).tobytes() if vga is not None else b""
    return bytes(head) + bytes(body) + tail


def pcx_image(img: np.ndarray, mode: str, palette=None, **kw) -> bytes:
    """(H, W[, 3]) pixels in ``mode`` (1, P;2, P;4, L, P, RGB) as a PCX,
    rows padded to an even stride."""
    img = np.asarray(img)
    h, w = img.shape[:2]
    if mode == "1":
        bits, planes, rows = 1, 1, np.packbits(img.astype(bool), axis=1)[:, None]
    elif mode in ("P;2", "P;4"):
        bits, planes = 1, int(mode[2])
        rows = np.stack([np.packbits((img >> k) & 1, axis=1) for k in range(planes)], axis=1)
    elif mode in ("L", "P"):
        bits, planes, rows = 8, 1, img.astype(np.uint8)[:, None]
    else:
        bits, planes, rows = 8, 3, np.moveaxis(img.astype(np.uint8), 2, 1)
    stride = kw.pop("stride", None) or rows.shape[2] + rows.shape[2] % 2
    rows = np.concatenate([rows, np.zeros((h, planes, stride - rows.shape[2]), np.uint8)], axis=2)
    ega = palette if mode in ("P;2", "P;4") else None
    vga = palette if mode == "P" else kw.pop("vga", None)
    return pcx_file(rows, w, h, bits, planes, ega=ega, vga=vga, stride=stride, **kw)


# ------------------------------------------------------------------ SGI


def sgi_rle_row(row: np.ndarray, bpc: int) -> bytes:
    """SGI RLE of one channel's row: repeats of 3 to 127, literals of at
    most 127, a 0 (16-bit: 0x0000) at the end."""
    dtype = np.uint8 if bpc == 1 else ">u2"
    out = bytearray()
    for seg in _segments(np.asarray(row), 3, 127):
        if seg[0] == "run":
            out += np.array([seg[2], seg[1]], dtype).tobytes()
        else:
            out += np.array([0x80 | len(seg[1])], dtype).tobytes() + seg[1].astype(dtype).tobytes()
    return bytes(out + bytes(bpc))


def sgi_file(img: np.ndarray, *, bpc: int = 1, rle: bool = False, dimension: int = None) -> bytes:
    """An SGI image of (H, W, Z) samples (16-bit for ``bpc`` 2), rows
    bottom-up, channels planar; RLE with start and length tables."""
    img = np.asarray(img)
    if img.ndim == 2:
        img = img[..., None]
    h, w, z = img.shape
    dim = dimension or (3 if z > 1 else 2)
    head = bytearray(512)
    struct.pack_into(">hBBHHHHii", head, 0, 474, int(rle), bpc, dim, w, h, z, 0, 255 if bpc == 1 else 65535)
    head[24:28] = b"\0\0\0\0"
    head[28:36] = b"fixture\0"
    planes = [img[::-1, :, c] for c in range(z)]
    if not rle:
        dtype = np.uint8 if bpc == 1 else ">u2"
        return bytes(head) + b"".join(p.astype(dtype).tobytes() for p in planes)
    rows = [sgi_rle_row(p[y], bpc) for p in planes for y in range(h)]
    table = 512 + 8 * h * z
    starts, pos = [], table
    for r in rows:
        starts.append(pos)
        pos += len(r)
    return (bytes(head) + struct.pack(f">{h * z}I", *starts) + struct.pack(f">{h * z}I", *map(len, rows))
            + b"".join(rows))


# ------------------------------------------------------------------ PSD

PSD_MODE = {"1": (0, 1), "L": (1, 8), "P": (2, 8), "RGB": (3, 8), "CMYK": (4, 8), "multichannel": (7, 8),
            "duotone": (8, 8), "LAB": (9, 8)}


def psd_file(channels: list, width: int, height: int, mode: str, *, rle: bool = False, palette=None,
             resources: bool = False, layers: bool = False, bits: int = None) -> bytes:
    """A PSD's merged image: ``channels`` (H, row bytes) uint8 planes in
    the file's order (CMYK stored inverted, as Photoshop stores it: pass
    them so), raw or PackBits with the per-row byte counts; ``palette``
    256 x 3 for P (stored planar); an image resource block and a layer
    section PIL skips."""
    psd_mode, depth = PSD_MODE[mode]
    head = b"8BPS" + struct.pack(">H6xHIIHH", 1, len(channels), height, width, bits or depth, psd_mode)
    colour = b""
    if palette is not None:
        colour = np.asarray(palette, np.uint8).T.tobytes()
    out = head + struct.pack(">I", len(colour)) + colour
    res = b""
    if resources:
        for rid, name, data in ((1005, b"", b"\0" * 16), (1039, b"icc", b"\1\2\3"), (1036, b"ab", b"")):
            n = bytes([len(name)]) + name
            n += b"\0" if len(n) % 2 else b""
            res += b"8BIM" + struct.pack(">H", rid) + n + struct.pack(">I", len(data)) + data
            res += b"\0" if len(data) % 2 else b""
    out += struct.pack(">I", len(res)) + res
    lay = struct.pack(">I", 8) + b"\0" * 8 if layers else b""
    out += struct.pack(">I", len(lay)) + lay
    planes = [np.asarray(c, np.uint8) for c in channels]
    if not rle:
        return out + struct.pack(">H", 0) + b"".join(p.tobytes() for p in planes)
    rows = [packbits_row(p[y]) for p in planes for y in range(height)]
    return out + struct.pack(">H", 1) + struct.pack(f">{len(rows)}H", *map(len, rows)) + b"".join(rows)


# ------------------------------------------------------------------ DDS

DXGI = {"BC1": 71, "BC2": 74, "BC3": 77, "BC4": 80, "BC5": 83, "BC5S": 84, "BC6H": 95, "BC6HS": 96, "BC7": 98,
        "BC7_SRGB": 99, "BC1_TYPELESS": 70, "BC7_TYPELESS": 97, "RGBA": 28, "RGBA_SRGB": 29}


def dds_file(width: int, height: int, data: bytes, *, fourcc: bytes = None, dxgi: int = None, rgb_masks=None,
             bitcount: int = 0, luminance: bool = False, alpha: bool = False, palette=None) -> bytes:
    """A DDS: 124-byte header (DDSD flags for caps, size, pixel format),
    a pixel format of RGB masks, luminance, an 8-bit palette (256 x 4 RGBA
    after the header), a four-character code, or DX10 with ``dxgi``."""
    pf = bytearray(32)
    flags = 0
    if rgb_masks is not None:
        flags = 0x40 | (0x1 if alpha else 0)
        struct.pack_into(f"<I{len(rgb_masks)}I", pf, 12, bitcount, *rgb_masks)
    elif luminance:
        flags = 0x20000 | (0x1 if alpha else 0)
        struct.pack_into("<I", pf, 12, bitcount)
    elif palette is not None:
        flags = 0x20
        struct.pack_into("<I", pf, 12, 8)
    else:
        flags = 0x4
        pf[8:12] = fourcc or b"DX10"
    struct.pack_into("<II", pf, 0, 32, flags)
    head = struct.pack("<7I", 124, 0x1007, height, width, 0, 0, 1) + bytes(44) + bytes(pf) + struct.pack(
        "<5I", 0x1000, 0, 0, 0, 0)
    out = b"DDS " + head
    if fourcc is None and rgb_masks is None and not luminance and palette is None:
        out += struct.pack("<5I", dxgi, 3, 0, 1, 0)
    if palette is not None:
        out += np.asarray(palette, np.uint8).reshape(256, 4).tobytes()
    return out + data


def _blocks(img: np.ndarray) -> np.ndarray:
    """(H, W, C) -> (blocks, 16, C) of 4x4 blocks in row order, the edge
    replicated to a multiple of 4."""
    h, w, c = img.shape
    ph, pw = -h % 4, -w % 4
    img = np.pad(img, ((0, ph), (0, pw), (0, 0)), mode="edge")
    bh, bw = img.shape[0] // 4, img.shape[1] // 4
    return img.reshape(bh, 4, bw, 4, c).transpose(0, 2, 1, 3, 4).reshape(bh * bw, 16, c)


def _pack_bits(fields: list, n: int) -> np.ndarray:
    """(value arrays, bit counts) least significant first into (n, 16)
    bytes."""
    lo = np.zeros(n, np.uint64)
    hi = np.zeros(n, np.uint64)
    pos = 0
    for value, bits in fields:
        value = np.asarray(value, np.uint64) & np.uint64((1 << bits) - 1)
        for b in range(bits):
            bit = (value >> np.uint64(b)) & np.uint64(1)
            p = pos + b
            if p < 64:
                lo |= bit << np.uint64(p)
            else:
                hi |= bit << np.uint64(p - 64)
        pos += bits
    assert pos == 128, pos
    return np.concatenate([lo.astype("<u8").view(np.uint8).reshape(n, 8), hi.astype("<u8").view(np.uint8).reshape(
        n, 8)], axis=1)


def bc1_blocks(rgb: np.ndarray) -> bytes:
    """A BC1 (DXT1) encoding of (H, W, 3): per block the channel maxima and
    minima as RGB565 endpoints (four colours: the first endpoint greater),
    each pixel the nearest of the four."""
    px = _blocks(rgb[..., :3]).astype(np.int64)
    hi, lo = px.max(axis=1), px.min(axis=1)

    def to565(c):
        return (c[:, 0] >> 3) << 11 | (c[:, 1] >> 2) << 5 | (c[:, 2] >> 3)

    c0, c1 = to565(hi), to565(lo)
    swap = c0 < c1
    c0, c1 = np.where(swap, c1, c0), np.where(swap, c0, c1)
    flat = c0 == c1

    def expand(c):
        r, g, b = (c >> 11) & 31, (c >> 5) & 63, c & 31
        return np.stack([r << 3 | r >> 2, g << 2 | g >> 4, b << 3 | b >> 2], -1)

    e0, e1 = expand(c0), expand(c1)
    pal = np.stack([e0, e1, (2 * e0 + e1) // 3, (e0 + 2 * e1) // 3], 1)
    d = ((px[:, :, None, :] - pal[:, None, :, :]) ** 2).sum(-1)
    idx = np.where(flat[:, None], 0, d.argmin(-1))
    lut = (idx << (2 * np.arange(16))).sum(1)
    out = np.zeros((len(px), 8), np.uint8)
    out[:, 0:2] = c0.astype("<u2").view(np.uint8).reshape(-1, 2)
    out[:, 2:4] = c1.astype("<u2").view(np.uint8).reshape(-1, 2)
    out[:, 4:8] = lut.astype("<u4").view(np.uint8).reshape(-1, 4)
    return out.tobytes()


BC7_W4 = np.array([0, 4, 9, 13, 17, 21, 26, 30, 34, 38, 43, 47, 51, 55, 60, 64])


def bc7_blocks(rgba: np.ndarray) -> bytes:
    """A BC7 mode-6 encoding of (H, W, 4): per block the channel minima and
    maxima as the two 7-bit endpoints with p-bits 0 and 1, each pixel's
    4-bit index the weight nearest its projection on the endpoints' line
    (the endpoints swapped where pixel 0's index would need a fifth bit)."""
    px = _blocks(rgba).astype(np.int64)
    n = len(px)
    lo, hi = px.min(axis=1), px.max(axis=1)
    c0, c1 = lo >> 1, hi >> 1
    e0, e1 = c0 << 1, (c1 << 1) | 1
    d = (e1 - e0).astype(np.float64)
    t = ((px - e0[:, None]) * d[:, None]).sum(-1) / np.maximum((d * d).sum(-1), 1)[:, None]
    idx = np.abs(t[..., None] * 64 - BC7_W4).argmin(-1)
    swap = idx[:, 0] >= 8
    c0, c1 = np.where(swap[:, None], c1, c0), np.where(swap[:, None], c0, c1)
    p0, p1 = np.where(swap, 1, 0), np.where(swap, 0, 1)
    idx = np.where(swap[:, None], 15 - idx, idx)
    fields = [(np.full(n, 1 << 6), 7)]
    for ch in range(4):
        fields += [(c0[:, ch], 7), (c1[:, ch], 7)]
    fields += [(p0, 1), (p1, 1), (idx[:, 0], 3)] + [(idx[:, k], 4) for k in range(1, 16)]
    return _pack_bits(fields, n).tobytes()


# ------------------------------------------------------------------ phase 9d's sources


def frame_small_forms(frame: np.ndarray) -> dict:
    """Phase 9d's sources from CO3D's 1067x800 frame, written without PIL:
    form -> file bytes (PIL's digest of each is in
    ``small_formats_sha256.json`` under "frames")."""
    h, w, _ = frame.shape
    gray = (frame.astype(np.float32) @ np.array([0.299, 0.587, 0.114], np.float32))
    rgba = np.dstack([frame, np.full((h, w), 255, np.uint8)])
    return {
        "PPM P6": ppm_file(frame, b"P6"),
        "PFM (little-endian)": ppm_file(gray + 0.25, b"Pf", scale=-1.0),
        "TGA RLE (bottom-up)": tga_image(frame, "RGB", rle=True, top=False),
        "QOI": qoi_file(frame),
        "PCX (24-bit planes)": pcx_image(frame, "RGB"),
        "SGI RLE": sgi_file(frame, rle=True),
        "PSD PackBits": psd_file([frame[..., k] for k in range(3)], w, h, "RGB", rle=True),
        "DDS BC1": dds_file(w, h, bc1_blocks(frame), fourcc=b"DXT1"),
        "DDS BC7": dds_file(w, h, bc7_blocks(rgba), dxgi=DXGI["BC7"]),
    }


# ------------------------------------------------------------------ fixtures


def _photo(rng, h: int, w: int, ch: int = 3) -> np.ndarray:
    return FORMATS._photo(rng, h, w, ch)


def _pil(img, fmt: str, mode: str = None, **options) -> bytes:
    return FORMATS._pil(img, fmt, mode, **options)


def ppm_fixtures(rng) -> dict:
    rgb = _photo(rng, 13, 19)
    gray = rgb[..., 1]
    bits = rng.integers(0, 2, (11, 21)).astype(bool)
    f = {
        "ppm_pil_rgb.ppm": _pil(rgb, "PPM"), "ppm_pil_l.pgm": _pil(gray, "PPM"),
        "ppm_pil_1.pbm": _pil(rgb, "PPM", "1"), "ppm_pil_i16.pgm": _pil(rng.integers(0, 65536, (9, 7)).astype(np.uint16),
                                                                      "PPM"),
        "ppm_pil_f.pfm": _pil(rng.normal(80, 90, (9, 11)).astype(np.float32), "PPM"),
        "ppm_p1_plain.pbm": ppm_file(bits, b"P1", comments=True),
        "ppm_p2_plain.pgm": ppm_file(gray % 16, b"P2", 15, comments=True, seps=(b" ", b"\t", b"\r\n")),
        "ppm_p2_plain_i.pgm": ppm_file(rng.integers(0, 1001, (7, 9)), b"P2", 1000),
        "ppm_p3_plain.ppm": ppm_file(rgb * 100 // 255, b"P3", 100, comments=True),
        "ppm_p3_plain_16.ppm": ppm_file(rng.integers(0, 4096, (5, 6, 3)), b"P3", 4095),
        "ppm_p4.pbm": ppm_file(bits, b"P4", comments=True),
        "ppm_p5.pgm": ppm_file(gray, b"P5", seps=(b" ", b"\n\n\t")),
        "ppm_p5_maxval7.pgm": ppm_file(gray % 8, b"P5", 7),
        "ppm_p5_maxval1000.pgm": ppm_file(rng.integers(0, 1001, (7, 9)), b"P5", 1000),
        "ppm_p5_65535.pgm": ppm_file(rng.integers(0, 65536, (7, 9)), b"P5", 65535),
        "ppm_p6.ppm": ppm_file(rgb, b"P6", comments=True),
        "ppm_p6_maxval4095.ppm": ppm_file(rng.integers(0, 4096, (5, 6, 3)), b"P6", 4095),
        "ppm_p6_maxval100.ppm": ppm_file(rgb * 100 // 255, b"P6", 100),
        "ppm_pf_big_endian.pfm": ppm_file(rng.normal(100, 120, (6, 8)).astype(np.float32), b"Pf", scale=2.5),
        "ppm_p0cmyk.ppm": ppm_file(_photo(rng, 5, 7, 4), b"P0CMYK"),
        "ppm_pyrgba.ppm": ppm_file(_photo(rng, 5, 7, 4), b"PyRGBA"),
        "ppm_pyp.ppm": ppm_file(gray[:5, :7], b"PyP"),
        "bad_ppm_truncated.ppm": ppm_file(rgb, b"P6")[:-7],
        "bad_ppm_value_over_maxval.pgm": b"P2 2 1 10 3 11\n",
        "bad_ppm_maxval0.pgm": b"P5 2 2 0\n\0\0\0\0",
        "bad_ppm_token_too_long.ppm": b"P6 123456789012 2 255\n",
        "bad_ppm_pfm_scale0.pfm": b"Pf 1 1 0.0\n\0\0\0\0",
        "bad_ppm_p1_token.pbm": b"P1 2 2 0 1 2 0\n",
    }
    return f


def tga_fixtures(rng) -> dict:
    rgb = _photo(rng, 11, 14)
    rgba = _photo(rng, 11, 14, 4)
    gray = rgb[..., 0]
    pal = rng.integers(0, 256, (40, 3)).astype(np.uint8)
    idx = rng.integers(0, 40, (11, 14)).astype(np.uint8)
    idx[:, 3:9] = 5
    rgb[:, :6] = rgb[:, :1]
    pal16 = bgr15(rng.integers(0, 32, (40, 3)), rng.integers(0, 2, 40)).reshape(-1).tobytes()
    pal32 = rng.integers(0, 256, (40, 4)).astype(np.uint8).tobytes()
    f = {}
    for mode, img in (("RGB", rgb), ("RGBA", rgba), ("L", gray), ("LA", rgba[..., :2]), ("1", gray > 120)):
        f[f"tga_pil_{mode.lower()}.tga"] = _pil(img if mode != "1" else (img * 255).astype(np.uint8), "TGA",
                                                mode if mode in ("1", "LA") else None)
        f[f"{'bad_' if mode == '1' else ''}tga_pil_{mode.lower()}_rle.tga"] = _pil(img if mode != "1" else (img * 255).astype(np.uint8), "TGA",
                                                    mode if mode in ("1", "LA") else None, rle=True)
    from PIL import Image

    p_img = Image.fromarray(idx, "P")
    p_img.putpalette(pal.reshape(-1).tolist())
    f["tga_pil_p.tga"] = _pil(p_img, "TGA")
    f["tga_pil_p_rle.tga"] = _pil(p_img, "TGA", rle=True)
    for top, right in ((False, False), (True, True), (False, True)):
        tag = ("top" if top else "bottom") + ("_right" if right else "_left")
        f[f"tga_rgb_{tag}.tga"] = tga_image(rgb, "RGB", top=top, right=right)
        f[f"tga_rgba_rle_{tag}.tga"] = tga_image(rgba, "RGBA", top=top, right=right, rle=True)
    f["tga_l_rle_cross_rows.tga"] = tga_image(gray, "L", rle=True, cross=True)
    f["tga_rgb_rle_cross_rows.tga"] = tga_image(rgb, "RGB", rle=True, cross=True, top=False)
    f["tga_id_field.tga"] = tga_image(rgb, "RGB", id_field=b"an ID field of 23 bytes")
    f["tga_p_cmap16_start.tga"] = tga_file(idx + 3, 14, 11, 1, 8, cmap=(3, 16, pal16))
    f["bad_tga_p_cmap32_rle.tga"] = tga_file(idx, 14, 11, 9, 8, cmap=(0, 32, pal32), top=False)
    f["tga_p_cmap24_short.tga"] = tga_file(idx % 30, 14, 11, 1, 8, cmap=(0, 24, pal[:30].tobytes()))
    f["tga_rgb16_alpha_bit.tga"] = tga_file(bgr15(rng.integers(0, 32, (11, 14, 3)), rng.integers(0, 2, (11, 14)))
                                            .reshape(11, -1), 14, 11, 2, 16)
    f["tga_rgb16_rle.tga"] = tga_file(bgr15(rng.integers(0, 4, (11, 14, 3)), 0).reshape(11, -1), 14, 11, 10, 16)
    f["tga_l_with_cmap.tga"] = tga_file(gray, 14, 11, 3, 8, cmap=(0, 24, pal.tobytes()))
    f["tga_la_rle.tga"] = tga_image(rgba[..., :2], "LA", rle=True, top=False)
    f["tga_1_bottom.tga"] = tga_image(gray > 100, "1", top=False)
    f["bad_tga_run_across_rows.tga"] = tga_file(np.zeros((2, 3), np.uint8), 3, 2, 11, 8)[:18] + bytes([0x85, 7])
    f["bad_tga_truncated.tga"] = tga_image(rgb, "RGB")[:-5]
    f["bad_tga_rle_truncated.tga"] = tga_image(rgb, "RGB", rle=True)[:-5]
    f["bad_tga_cmap_no_tile.tga"] = tga_file(np.zeros((2, 4), np.uint8), 2, 2, 1, 16, cmap=(0, 24, pal.tobytes()))
    f["bad_tga_type1_no_cmap.tga"] = tga_file(idx, 14, 11, 1, 8)
    f["bad_tga_1bit_rle.tga"] = tga_file(np.packbits(gray > 9, axis=1), 14, 11, 11, 1)
    f["bad_tga_rgb_with_cmap.tga"] = tga_file(rgb[..., ::-1].reshape(11, -1), 14, 11, 2, 24,
                                              cmap=(0, 24, pal.tobytes()))
    return f


def icon_fixtures(rng) -> dict:
    from PIL import Image

    rgba = _photo(rng, 32, 32, 4)
    rgba[..., 3] = rng.integers(0, 256, (32, 32))
    f = {
        "ico_pil_png.ico": _pil(Image.fromarray(rgba), "ICO", sizes=[(16, 16), (32, 32), (24, 24)]),
        "ico_pil_bmp.ico": _pil(Image.fromarray(rgba), "ICO", bitmap_format="bmp", sizes=[(16, 16), (32, 32)]),
        "ico_pil_bmp_p.ico": _pil(Image.fromarray(rgba).convert("P"), "ICO", bitmap_format="bmp", sizes=[(32, 32)]),
    }
    pal = rng.integers(0, 256, (16, 3)).astype(np.uint8)
    mask = rng.integers(0, 2, (16, 16)).astype(bool)
    idx4 = rng.integers(0, 16, (16, 16)).astype(np.uint8)
    idx1 = rng.integers(0, 2, (16, 16)).astype(np.uint8)
    rgb = _photo(rng, 16, 16)
    small = _photo(rng, 16, 16, 4)
    f["ico_bmp_4bit_mask.ico"] = icon_file([(16, 16, 16, 4, icon_bmp(idx4, 4, palette=pal, mask=mask))])
    f["ico_bmp_1bit_mask.ico"] = icon_file([(16, 16, 2, 1, icon_bmp(idx1, 1, palette=pal[:2], mask=mask))])
    f["ico_bmp_8bit.ico"] = icon_file([(16, 16, 0, 8, icon_bmp(idx4, 8, palette=np.concatenate([pal] * 16),
                                                              mask=mask))])
    f["ico_bmp_24bit_mask.ico"] = icon_file([(16, 16, 0, 24, icon_bmp(rgb, 24, mask=mask))])
    f["ico_bmp_32bit_alpha.ico"] = icon_file([(16, 16, 0, 32, icon_bmp(small, 32, mask=mask))])
    f["ico_largest_of_three.ico"] = icon_file([(16, 16, 0, 32, icon_bmp(small, 32)),
                                               (32, 32, 0, 32, png_rgba(rgba)),
                                               (24, 24, 16, 4, icon_bmp(np.resize(idx4, (24, 24)), 4, palette=pal))])
    f["ico_png_rgb.ico"] = icon_file([(16, 16, 0, 32, png_rgba(rgb))])
    f["ico_256_png.ico"] = icon_file([(256, 256, 0, 32, png_rgba(np.resize(small, (256, 256, 4))))])
    f["cur_32bit_bgra.cur"] = icon_file([(16, 16, 0, 5, icon_bmp(small, 32))], cur=True)
    f["cur_8bit.cur"] = icon_file([(16, 16, 0, 3, icon_bmp(idx4, 8, palette=pal, mask=mask))], cur=True)
    f["cur_24bit.cur"] = icon_file([(16, 16, 0, 3, icon_bmp(rgb, 24))], cur=True)
    f["cur_two_sizes.cur"] = icon_file([(16, 16, 0, 1, icon_bmp(idx4, 4, palette=pal)),
                                        (32, 32, 0, 2, icon_bmp(rgba, 32))], cur=True)
    f["cur_gray_ramp.cur"] = icon_file([(16, 16, 0, 1, icon_bmp(idx4 * 16, 8, palette=np.repeat(
        np.arange(256, dtype=np.uint8)[:, None], 3, 1)))], cur=True)
    f["ico_and_mask_cut.ico"] = icon_file([(16, 16, 0, 24, icon_bmp(rgb, 24)[:-40])])
    f["bad_ico_png_cut.ico"] = icon_file([(16, 16, 0, 32, png_rgba(rgb)[:-30])])
    f["bad_cur_header_type.cur"] = icon_file([(16, 16, 0, 1, b"\x20\0\0\0" + bytes(60))], cur=True)
    return f


def qoi_fixtures(rng) -> dict:
    rgb = _photo(rng, 12, 17)
    rgb[3:6] = rgb[3:4]
    rgba = _photo(rng, 12, 17, 4)
    rgba[..., 3] = np.where(rng.random((12, 17)) < 0.3, 255, rgba[..., 3])
    flat = np.zeros((9, 20, 3), np.uint8)
    flat[:, 10:] = (1, 2, 3)
    pal = rng.integers(0, 256, (6, 3))
    few = pal[rng.integers(0, 6, (10, 13))].astype(np.uint8)
    return {
        "qoi_pil_rgb.qoi": _pil(rgb, "QOI"), "qoi_pil_rgba.qoi": _pil(rgba, "QOI"),
        "qoi_index_hits.qoi": qoi_file(few), "qoi_runs.qoi": qoi_file(flat),
        "qoi_rgb_as_rgba.qoi": qoi_file(rgb, 4), "qoi_rgba_ops.qoi": qoi_file(rgba),
        # an index op naming a slot never written: PIL gives (0, 0, 0, 0)
        "qoi_unset_index.qoi": b"qoif" + struct.pack(">IIBB", 3, 1, 4, 0) + bytes([0x05, 0xFE, 9, 8, 7, 0x05])
        + b"\0" * 7 + b"\1",
        "bad_qoi_truncated.qoi": qoi_file(rgb)[:-40],
    }


def pcx_fixtures(rng) -> dict:
    rgb = _photo(rng, 10, 13)
    gray = rgb[..., 0]
    idx = rng.integers(0, 16, (10, 13)).astype(np.uint8)
    pal = rng.integers(0, 256, (256, 3)).astype(np.uint8)
    ramp = np.repeat(np.arange(256, dtype=np.uint8)[:, None], 3, 1)
    return {
        "pcx_pil_rgb.pcx": _pil(rgb, "PCX"), "pcx_pil_l.pcx": _pil(gray, "PCX"),
        "pcx_pil_p.pcx": _pil(rgb, "PCX", "P"), "pcx_pil_1.pcx": _pil(rgb, "PCX", "1"),
        "pcx_ega_4planes.pcx": pcx_image(idx, "P;4", pal[:16]),
        "pcx_ega_2planes.pcx": pcx_image(idx % 4, "P;2", pal[:16]),
        "pcx_vga_palette.pcx": pcx_image(idx * 7, "P", pal),
        "pcx_gray_ramp.pcx": pcx_image(gray, "L", vga=ramp),
        "pcx_no_palette.pcx": pcx_image(gray, "L"),
        "pcx_rgb_odd_stride.pcx": pcx_image(rgb, "RGB", header_stride=13),
        "pcx_rgb_wide_stride.pcx": pcx_image(rgb, "RGB", stride=18),
        "pcx_1bit_stride.pcx": pcx_image(gray > 99, "1", stride=4),
        "bad_pcx_version3_8bit.pcx": pcx_image(gray, "L", version=3),
        "bad_pcx_truncated.pcx": pcx_image(rgb, "RGB")[:-30],
        "bad_pcx_run_over.pcx": pcx_file(np.zeros((2, 1, 4), np.uint8), 3, 2, 8, 1)[:128] + bytes([0xC5, 1, 0xC5, 1]),
    }


def sgi_fixtures(rng) -> dict:
    rgb = _photo(rng, 9, 14)
    rgb[2:5, :] = rgb[2:3, :1]
    rgba = _photo(rng, 9, 14, 4)
    gray = rgb[..., 1]
    deep = rng.integers(0, 65536, (6, 7, 3))
    f = {
        "sgi_pil_rgb.sgi": _pil(rgb, "SGI"), "sgi_pil_rgba.sgi": _pil(rgba, "SGI"), "sgi_pil_l.sgi": _pil(gray, "SGI"),
        "sgi_pil_rgb16.sgi": _pil(rgb, "SGI", bpc=2), "sgi_pil_l16.sgi": _pil(gray, "SGI", bpc=2),
        "sgi_rle_rgb.sgi": sgi_file(rgb, rle=True), "sgi_rle_rgba.sgi": sgi_file(rgba, rle=True),
        "sgi_rle_l.sgi": sgi_file(gray, rle=True), "sgi_rle_rgb16.sgi": sgi_file(deep, bpc=2, rle=True),
        "sgi_rle_l16.sgi": sgi_file(deep[..., 0], bpc=2, rle=True),
        "sgi_dimension1.sgi": sgi_file(gray[:1], dimension=1), "sgi_raw_rgba16.sgi": sgi_file(
            rng.integers(0, 65536, (5, 6, 4)), bpc=2),
    }
    # a row of length 1 whose byte is not 0: PIL ends the image there, later rows black
    data = bytearray(sgi_file(rgb, rle=True))
    struct.pack_into(">I", data, 512 + 4 * (3 * 9) + 4 * 3, 1)
    f["sgi_rle_row_ends_early.sgi"] = bytes(data)
    # a row without its 0 at the end: the ops run on into the next row's (an overrun)
    data = bytearray(sgi_file(gray, rle=True))
    h = gray.shape[0]
    start, length = struct.unpack_from(">I", data, 512 + 4 * 3)[0], struct.unpack_from(">I", data, 512 + 4 * h + 12)[0]
    data[start + length - 1] = 0x81
    f["bad_sgi_rle_no_terminator.sgi"] = bytes(data)
    f["bad_sgi_mode.sgi"] = sgi_file(rgb)[:10] + struct.pack(">H", 2) + sgi_file(rgb)[12:]
    f["bad_sgi_truncated.sgi"] = sgi_file(rgb)[:-20]
    f["bad_sgi_rle_tables_cut.sgi"] = sgi_file(rgb, rle=True)[:600]
    return f


def psd_fixtures(rng) -> dict:
    h, w = 9, 11
    rgb = _photo(rng, h, w)
    rgb[4:7] = rgb[4:5]
    alpha = rng.integers(0, 256, (h, w)).astype(np.uint8)
    gray = rgb[..., 0]
    bits = np.packbits(rng.integers(0, 2, (h, w)).astype(np.uint8), axis=1)
    pal = rng.integers(0, 256, (256, 3)).astype(np.uint8)
    f = {}
    for rle in (False, True):
        t = "rle" if rle else "raw"
        ch = [rgb[..., k] for k in range(3)]
        f[f"psd_rgb_{t}.psd"] = psd_file(ch, w, h, "RGB", rle=rle, resources=True, layers=True)
        f[f"psd_rgba_{t}.psd"] = psd_file(ch + [alpha], w, h, "RGB", rle=rle)
        f[f"psd_cmyk_{t}.psd"] = psd_file([255 - rgb[..., 0], 255 - rgb[..., 1], 255 - rgb[..., 2], alpha], w, h,
                                          "CMYK", rle=rle)
        f[f"psd_l_{t}.psd"] = psd_file([gray], w, h, "L", rle=rle)
        f[f"psd_p_{t}.psd"] = psd_file([gray], w, h, "P", rle=rle, palette=pal)
        f[f"psd_1_{t}.psd"] = psd_file([bits], w, h, "1", rle=rle)
        f[f"psd_lab_{t}.psd"] = psd_file([gray, rgb[..., 1], rgb[..., 2]], w, h, "LAB", rle=rle)
    f["psd_rgb_five_channels.psd"] = psd_file([rgb[..., k] for k in range(3)] + [alpha, gray], w, h, "RGB", rle=True)
    f["psd_duotone.psd"] = psd_file([gray], w, h, "duotone")
    f["psd_multichannel.psd"] = psd_file([gray, alpha], w, h, "multichannel")
    f["psd_l_two_channels.psd"] = psd_file([gray, alpha], w, h, "L", rle=True)
    f["psd_p_short_palette.psd"] = psd_file([gray], w, h, "P", palette=None)
    f["bad_psd_16bit.psd"] = psd_file([np.repeat(gray, 2, axis=1)], w, h, "L", bits=16)
    f["bad_psd_too_few_channels.psd"] = psd_file([gray, gray], w, h, "RGB")
    f["bad_psd_truncated.psd"] = psd_file([rgb[..., k] for k in range(3)], w, h, "RGB", rle=True)[:-9]
    f["bad_psd_zip.psd"] = psd_file([gray], w, h, "L")[:-(h * w) - 2] + struct.pack(">H", 2) + bytes(h * w)
    return f


def dds_fixtures(rng) -> dict:
    rgb = _photo(rng, 13, 10)
    rgba = _photo(rng, 13, 10, 4)
    f = {
        "dds_pil_rgb.dds": _pil(rgb, "DDS"), "dds_pil_rgba.dds": _pil(rgba, "DDS"),
        "dds_pil_l.dds": _pil(rgb, "DDS", "L"), "dds_pil_la.dds": _pil(rgba, "DDS", "LA"),
        "dds_pil_dxt1.dds": _pil(rgba, "DDS", pixel_format="DXT1"),
        "dds_pil_dxt3.dds": _pil(rgba, "DDS", pixel_format="DXT3"),
        "dds_pil_dxt5.dds": _pil(rgba, "DDS", pixel_format="DXT5"),
        "dds_pil_bc5.dds": _pil(rgb, "DDS", pixel_format="BC5"),
    }
    w, h = 10, 13  # edge blocks on both axes
    nb = ((w + 3) // 4) * ((h + 3) // 4)

    def blocks(size: int) -> bytes:
        return rng.integers(0, 256, nb * size).astype(np.uint8).tobytes()

    for code in (b"DXT1", b"DXT3", b"DXT5", b"BC4U", b"ATI1", b"BC5U", b"ATI2", b"BC5S"):
        size = 8 if code in (b"DXT1", b"BC4U", b"ATI1") else 16
        f[f"dds_fourcc_{code.decode().lower()}.dds"] = dds_file(w, h, blocks(size), fourcc=code)
    for name in ("BC1", "BC2", "BC3", "BC4", "BC5", "BC5S", "BC6H", "BC6HS", "BC7", "BC7_SRGB", "BC1_TYPELESS",
                 "BC7_TYPELESS"):
        size = 8 if name.startswith(("BC1", "BC4")) else 16
        data = bytearray(blocks(size))
        if name.startswith("BC7"):
            for b in range(nb):  # every mode, and the mode-less block
                m = b % 9
                data[16 * b] = ((data[16 * b] & (0xFF << (m + 1)) & 0xFF) | (1 << m)) if m < 8 else 0
        if name.startswith("BC6H"):
            codes = [0, 1, 2, 6, 10, 14, 18, 22, 26, 30, 3, 7, 11, 15, 19]
            for b in range(nb):
                c = codes[b % len(codes)]
                data[16 * b] = (data[16 * b] & ~(3 if c & 3 < 2 else 31) & 0xFF) | c
        f[f"dds_dx10_{name.lower()}.dds"] = dds_file(w, h, bytes(data), dxgi=DXGI[name])
    f["dds_bc7_encoded.dds"] = dds_file(w, h, bc7_blocks(rgba), dxgi=DXGI["BC7"])
    f["dds_bc1_encoded.dds"] = dds_file(w, h, bc1_blocks(rgb), fourcc=b"DXT1")
    f["dds_dx10_rgba.dds"] = dds_file(w, h, rgba.tobytes(), dxgi=DXGI["RGBA"])
    f["dds_rgb565.dds"] = dds_file(w, h, rng.integers(0, 65536, w * h).astype("<u2").tobytes(), rgb_masks=(
        0xF800, 0x7E0, 0x1F), bitcount=16)
    f["dds_argb4444.dds"] = dds_file(w, h, rng.integers(0, 65536, w * h).astype("<u2").tobytes(), rgb_masks=(
        0xF00, 0xF0, 0xF, 0xF000), bitcount=16, alpha=True)
    f["dds_rgb_short.dds"] = dds_file(w, h, rgb.tobytes()[:-17], rgb_masks=(0xFF0000, 0xFF00, 0xFF), bitcount=24)
    f["dds_palette.dds"] = dds_file(w, h, rng.integers(0, 256, w * h).astype(np.uint8).tobytes(),
                                    palette=rng.integers(0, 256, (256, 4)))
    f["dds_luminance8.dds"] = dds_file(w, h, rgb[..., 0].tobytes(), luminance=True, bitcount=8)
    f["bad_dds_bc7_truncated.dds"] = dds_file(w, h, blocks(16)[:-1], dxgi=DXGI["BC7"])
    f["bad_dds_header_size.dds"] = b"DDS " + struct.pack("<I", 100) + bytes(120)
    f["bad_dds_unknown_fourcc.dds"] = dds_file(w, h, blocks(16), fourcc=b"ABCD")
    f["bad_dds_dxgi_r32.dds"] = dds_file(w, h, blocks(16), dxgi=2)
    f["bad_dds_raw_truncated.dds"] = dds_file(w, h, rgb[..., 0].tobytes()[:-3], luminance=True, bitcount=8)
    return f


def not_read_fixtures(rng) -> dict:
    """Formats PIL reads and the port does not: each names ROADMAP item
    13c (SUN written by hand; IM, SPIDER, MSP, XBM and BLP by PIL)."""
    gray = _photo(rng, 6, 8)[..., 0]
    sun = struct.pack(">8I", 0x59A66A95, 8, 6, 8, 48, 1, 0, 0) + gray.tobytes()
    return {
        "notread_sun.ras": sun,
        "notread_im.im": _pil(gray, "IM"),
        "notread_spider.spi": _pil(gray.astype(np.float32), "SPIDER"),
        "notread_msp.msp": _pil((gray > 100).astype(np.uint8) * 255, "MSP", "1"),
        "notread_xbm.xbm": _pil((gray > 100).astype(np.uint8) * 255, "XBM", "1"),
        "notread_blp.blp": _pil(_photo(rng, 8, 8), "BLP", "P"),
    }


def main(out_dir: str = HERE) -> int:
    from PIL import Image

    files = {}
    for k, make in enumerate((ppm_fixtures, tga_fixtures, icon_fixtures, qoi_fixtures, pcx_fixtures, sgi_fixtures,
                              psd_fixtures, dds_fixtures, not_read_fixtures)):
        files.update(make(np.random.default_rng(30 + k)))
    digests = {}
    for name, data in sorted(files.items()):
        with open(os.path.join(out_dir, name), "wb") as fh:
            fh.write(data)
        digests[name] = FORMATS.pil_digest(data)
    frame = np.asarray(Image.open(os.path.join(JPEG_DIR, "frame_a.jpg")).convert("RGB"))
    out = {"files": digests, "frames": {form: FORMATS.pil_digest(data)
                                        for form, data in frame_small_forms(frame).items()}}
    with open(os.path.join(out_dir, DIGESTS), "w") as fh:
        json.dump(out, fh, indent=1, sort_keys=True)
        fh.write("\n")
    return 0


if __name__ == "__main__":
    sys.exit(main(*sys.argv[1:]))
