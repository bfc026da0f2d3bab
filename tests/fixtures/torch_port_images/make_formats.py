"""Write the GIF, BMP/DIB and TIFF fixtures of
``tests/test_torch_port_formats.py`` and ``chip_smoke.py`` phase 9, and
``formats_sha256.json``: for each file PIL's mode and the sha256 and shape
of ``Image.open(...).convert("RGB")`` (and, for a file PIL opens as RGBA,
of the data loaders' white composite), or, for a file PIL refuses, the
refusal.

    python tests/fixtures/torch_port_images/make_formats.py

PIL writes what it can: GIF (global palette, transparency, interlace),
BMP at 1, 4, 8 and 24 bits, and TIFF uncompressed, PackBits, LZW and
deflate with and without predictor 2, striped or tiled. The writers below
write the rest, byte by byte: ``gif_file`` (a frame at an offset inside
the logical screen, with or without a transparency index, local colour
tables, interlace, any extension blocks) over ``gif_lzw`` (clear codes
where the table fills, or none); ``bmp_file`` (headers of 12, 40, 52, 56,
64, 108 and 124 bytes, a DIB without the file header, bottom-up or
top-down, BI_BITFIELDS with any masks) over ``rle_encode`` (RLE8 and RLE4
with encoded and absolute runs, end of line, deltas); ``tiff_file`` (II or
MM, classic or BigTIFF, either of PIL's invalid byte-order marks, any
tags) under ``tiff_image`` (strips or tiles, planar configuration 1 or 2,
any depth PIL reads, PackBits, LZW new-style or old-style, deflate,
predictor 2 or 3, FillOrder 2). The writers import no PIL: ``chip_smoke.py``
loads this file on a host without PIL to write phase 9d's sources from
CO3D's frame and the 512² render (``frame_formats``). Every file comes
from a fixed seed, so the script writes the same bytes on every run with
the same PIL.
"""

from __future__ import annotations

import hashlib
import io
import json
import os
import struct
import sys
import zlib

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
JPEG_DIR = os.path.join(os.path.dirname(HERE), "torch_port_jpeg")
DIGESTS = "formats_sha256.json"
# the APNG fixtures' digests and phase 9d's TIFF-codec and APNG sources'
CODEC_DIGESTS = "codecs_sha256.json"
BITFLIP = bytes(int(f"{b:08b}"[::-1], 2) for b in range(256))

# ------------------------------------------------------------------ GIF


class _Bits:
    """Codes packed least significant bit first (GIF, old-style TIFF LZW)
    or most significant first (TIFF LZW)."""

    def __init__(self, msb: bool = False):
        self.msb, self.acc, self.n, self.out = msb, 0, 0, bytearray()

    def put(self, code: int, size: int) -> None:
        if self.msb:
            self.acc = (self.acc << size) | code
            self.n += size
            while self.n >= 8:
                self.n -= 8
                self.out.append((self.acc >> self.n) & 255)
            self.acc &= (1 << self.n) - 1
        else:
            self.acc |= code << self.n
            self.n += size
            while self.n >= 8:
                self.out.append(self.acc & 255)
                self.acc >>= 8
                self.n -= 8

    def flush(self) -> bytes:
        if self.n:
            self.out.append(((self.acc << (8 - self.n)) if self.msb else self.acc) & 255)
            self.acc = self.n = 0
        return bytes(self.out)


def gif_lzw(indices, min_size: int, clear_when_full: bool = True, start_clear: bool = True) -> bytes:
    """GIF's LZW of ``indices`` (bytes or uint8), codes sized as PIL's
    decoder sizes them (one bit more after the entry 2^size - 1 is made,
    12 at most): a clear code first (unless not ``start_clear``), a clear
    where the 4096-entry table fills (else the full table kept), an end
    code; the code stream, not yet in sub-blocks."""
    data = bytes(np.asarray(indices, np.uint8).ravel())
    clear, end = 1 << min_size, (1 << min_size) + 1
    bits = _Bits()
    size, table, enc_next = min_size + 1, {}, clear + 2
    dec_next, first = clear + 2, True

    def emit(code):
        nonlocal size, dec_next, first
        bits.put(code, size)
        if code == clear:
            size, dec_next, first = min_size + 1, clear + 2, True
            return
        if first:
            first = False
            return
        if dec_next < 4096:
            if dec_next == (1 << size) - 1 and size < 12:
                size += 1
            dec_next += 1

    if start_clear:
        emit(clear)
    if data:
        prefix = data[0]
        for b in data[1:]:
            key = (prefix << 8) | b
            if key in table:
                prefix = table[key]
                continue
            emit(prefix)
            if enc_next < 4096:
                table[key] = enc_next
                enc_next += 1
            elif clear_when_full:
                emit(clear)
                table, enc_next = {}, clear + 2
            prefix = b
        emit(prefix)
    bits.put(end, size)
    return bits.flush()


def sub_blocks(data: bytes, size: int = 255) -> bytes:
    """``data`` as GIF sub-blocks of at most ``size`` bytes, then the
    terminator."""
    return b"".join(bytes([len(data[i:i + size])]) + data[i:i + size] for i in range(0, len(data), size)) + b"\0"


def interlace_rows(h: int) -> list:
    """GIF's interlaced row order: every 8th from 0, every 8th from 4,
    every 4th from 2, every 2nd from 1."""
    return list(range(0, h, 8)) + list(range(4, h, 8)) + list(range(2, h, 4)) + list(range(1, h, 2))


def _table_bits(n: int) -> int:
    return max(1, int(np.ceil(np.log2(max(n, 2))))) - 1


def gif_file(frame: np.ndarray, palette=None, *, screen=None, offset=(0, 0), local=None, transparency=None,
             interlace: bool = False, min_size: int = None, version: bytes = b"GIF89a", pre: bytes = b"",
             lzw: bytes = None, background: int = 0) -> bytes:
    """A one-frame GIF: ``frame`` (H, W) indices at ``offset`` of a
    ``screen`` (W, H; default the frame's size), ``palette`` (n x 3) as
    the global colour table and ``local`` as the frame's own, a graphic
    control extension with ``transparency`` when given, ``pre`` bytes
    (extensions) before the image, the rows interlaced, the LZW code
    stream ``lzw`` (default ``gif_lzw`` of the rows at ``min_size``)."""
    frame = np.asarray(frame, np.uint8)
    h, w = frame.shape
    sw, sh = screen or (w + offset[0], h + offset[1])
    flags = 0
    gct = b""
    if palette is not None:
        palette = np.asarray(palette, np.uint8)
        b = _table_bits(len(palette))
        table = np.zeros((2 << b, 3), np.uint8)
        table[:len(palette)] = palette
        flags, gct = 0x80 | 0x70 | b, table.tobytes()
    out = bytearray(version + struct.pack("<HHBBB", sw, sh, flags, background, 0) + gct + pre)
    if transparency is not None:
        out += b"!\xf9\x04" + struct.pack("<BHB", 1, 0, transparency) + b"\0"
    iflags, lct = 0, b""
    if local is not None:
        local = np.asarray(local, np.uint8)
        b = _table_bits(len(local))
        table = np.zeros((2 << b, 3), np.uint8)
        table[:len(local)] = local
        iflags, lct = 0x80 | b, table.tobytes()
    if interlace:
        iflags |= 0x40
    out += b"," + struct.pack("<HHHHB", offset[0], offset[1], w, h, iflags) + lct
    rows = frame[interlace_rows(h)] if interlace else frame
    if min_size is None:
        min_size = max(2, int(frame.max(initial=0)).bit_length())
    out += bytes([min_size]) + sub_blocks(lzw if lzw is not None else gif_lzw(rows, min_size))
    return bytes(out + b";")


def quantize(rgb: np.ndarray, levels=(8, 8, 4)) -> tuple:
    """An (H, W, 3) uint8 image as indices into a palette of at most 256
    colours (each channel cut to ``levels``): (indices, palette)."""
    r, g, b = (rgb[..., k].astype(np.int64) * n // 256 for k, n in enumerate(levels))
    idx = (r * levels[1] + g) * levels[2] + b
    used, inverse = np.unique(idx, return_inverse=True)
    ur, ug, ub = used // (levels[1] * levels[2]), (used // levels[2]) % levels[1], used % levels[2]
    palette = np.stack([(c * 255 + (n - 1) // 2) // (n - 1) for c, n in zip((ur, ug, ub), levels)], -1)
    return inverse.reshape(rgb.shape[:2]).astype(np.uint8), palette.astype(np.uint8)


# ------------------------------------------------------------------ BMP


def rle_encode(indices: np.ndarray, four: bool = False, top_down: bool = False, absolute: bool = True,
               end: bool = True) -> bytes:
    """RLE8 (or, with ``four``, RLE4) of (H, W) indices, rows bottom-up
    unless ``top_down``: runs of 2 or more as encoded runs, the rest as
    absolute runs of 3 to 255 (or encoded runs of one, without
    ``absolute``), an end of line after each row and an end of bitmap."""
    out = bytearray()
    rows = indices if top_down else indices[::-1]
    for row in np.asarray(rows, np.uint8):
        row = [int(v) for v in row]
        i, n = 0, len(row)
        while i < n:
            j = i + 1
            if four:  # a run alternates two nibbles: here only repeats of one value
                while j < n and j - i < 255 and row[j] == row[i]:
                    j += 1
            else:
                while j < n and j - i < 255 and row[j] == row[i]:
                    j += 1
            if j - i >= 2 or not absolute:
                out += bytes([j - i, (row[i] << 4 | row[i]) if four else row[i]])
                i = j
                continue
            k = i + 1  # a literal stretch, until the next repeat
            while k < n and k - i < 255 and not (k + 1 < n and row[k] == row[k + 1]):
                k += 1
            lit = row[i:k]
            if len(lit) < 3:
                for v in lit:
                    out += bytes([1, (v << 4 | v) if four else v])
            else:
                if four:
                    packed = bytes((lit[m] << 4) | (lit[m + 1] if m + 1 < len(lit) else 0)
                                   for m in range(0, len(lit), 2))
                else:
                    packed = bytes(lit)
                out += bytes([0, len(lit)]) + packed + (b"\0" if len(packed) % 2 else b"")
            i = k
        out += b"\0\0"
    if end:
        out += b"\0\1"
    return bytes(out)


def bmp_file(pixels: bytes, width: int, height: int, bits: int, *, header: int = 40, palette=None,
             compression: int = 0, masks=None, top_down: bool = False, dib: bool = False, colors: int = None,
             offset: int = None, pad_palette: int = None) -> bytes:
    """A BMP (or, with ``dib``, a DIB without the 14-byte file header):
    the pixel bytes as given (rows already padded and ordered, or RLE
    data), a header of ``header`` bytes (12: OS/2 1, 16-bit sizes and
    3-byte palette entries), ``palette`` (n x 3 RGB) stored BGR(X), bit
    field ``masks`` after a 40-byte header or inside a longer one; the
    height negative for ``top_down``; ``offset`` the file header's pixel
    offset (default the pixels' position)."""
    if header == 12:
        info = struct.pack("<IHHHH", 12, width, height, 1, bits)
        entry = 3
    else:
        h = -height if top_down else height
        info = struct.pack("<IiiHHIIiiII", header, width, h, 1, bits, compression, len(pixels), 2835, 2835,
                           colors if colors is not None else (len(palette) if palette is not None else 0), 0)
        rest = bytearray(header - 40)
        if masks is not None and header >= 52:
            m = struct.pack("<4I", *(list(masks) + [0] * (4 - len(masks))))
            rest[:min(len(rest), 16)] = m[:min(len(rest), 16)]
        if header >= 108:
            rest[16:20] = b"BGRs"
        info += bytes(rest)
        if masks is not None and header == 40:
            info += struct.pack("<3I", *masks[:3])
        entry = 4
    pal = b""
    if palette is not None:
        pal = b"".join(bytes([c[2], c[1], c[0]]) + (b"\0" if entry == 4 else b"")
                       for c in np.asarray(palette, np.uint8))
        if pad_palette:
            pal += bytes(pad_palette)
    body = info + pal
    if dib:
        return body + pixels
    start = 14 + len(body)
    return b"BM" + struct.pack("<IHHI", start + len(pixels), 0, 0, start if offset is None else offset) + body + pixels


def bmp_rows(samples: np.ndarray, bits: int, top_down: bool = False) -> bytes:
    """(H, W) indices at 1, 4 or 8 bits, or (H, W, k) bytes a pixel
    (already in the file's byte order), as BMP rows padded to 4 bytes,
    bottom-up unless ``top_down``."""
    samples = np.asarray(samples)
    h, w = samples.shape[:2]
    stride = ((w * bits + 31) >> 3) & ~3
    rows = samples if top_down else samples[::-1]
    out = bytearray()
    for row in rows:
        if bits < 8:
            packed = np.packbits(np.unpackbits(row.astype(np.uint8)[:, None], axis=1)[:, 8 - bits:].ravel())
            raw = packed.tobytes()
        else:
            raw = row.astype(np.uint8).tobytes()
        out += raw + bytes(stride - len(raw))
    return bytes(out)


def bmp_24(rgb: np.ndarray) -> bytes:
    """An (H, W, 3) uint8 image as a 24-bit BI_RGB BMP (BGR rows, bottom-up)."""
    return bmp_file(bmp_rows(rgb[..., ::-1], 24), rgb.shape[1], rgb.shape[0], 24)


def bmp_rle8(indices: np.ndarray, palette: np.ndarray) -> bytes:
    """(H, W) indices and their palette as an RLE8 BMP."""
    return bmp_file(rle_encode(indices), indices.shape[1], indices.shape[0], 8, palette=palette, compression=1)


# ------------------------------------------------------------------ TIFF


def packbits(data: bytes) -> bytes:
    """PackBits: runs of 3 to 128 equal bytes as a repeat, the rest as
    literals of at most 128."""
    out, i, n = bytearray(), 0, len(data)
    while i < n:
        j = i + 1
        while j < n and j - i < 128 and data[j] == data[i]:
            j += 1
        if j - i >= 3:
            out += bytes([257 - (j - i), data[i]])
            i = j
            continue
        k = i
        while k < n and k - i < 128 and not (k + 2 < n and data[k] == data[k + 1] == data[k + 2]):
            k += 1
        out += bytes([k - i - 1]) + data[i:k]
        i = k
    return bytes(out)


def tiff_lzw(data: bytes, old_style: bool = False, start_clear: bool = True) -> bytes:
    """TIFF's LZW: codes of 9 to 12 bits, most significant bit first, one
    bit more once the decoder's next entry reaches 2^size - 1 (the early
    change), or, ``old_style``, least significant first and a change one
    entry later (libtiff's compat codes); a clear code first and where the
    table fills, an end code last."""
    clear, eoi = 256, 257
    bits = _Bits(msb=not old_style)
    size, table, enc_next = 9, {}, 258
    free, first = 258, True

    def emit(code):
        nonlocal size, free, first
        bits.put(code, size)
        if code == clear:
            size, free, first = 9, 258, True
            return
        if first:
            first = False
            return
        free += 1
        if free > ((1 << size) - 1 if old_style else (1 << size) - 2) and size < 12:
            size += 1

    if start_clear:
        emit(clear)
    if data:
        prefix = data[0]
        for b in data[1:]:
            key = (prefix << 8) | b
            if key in table:
                prefix = table[key]
                continue
            emit(prefix)
            table[key] = enc_next
            enc_next += 1
            if enc_next >= 4094:
                emit(clear)
                table, enc_next = {}, 258
            prefix = b
        emit(prefix)
    bits.put(eoi, size)
    return bits.flush()


def predict(rows: np.ndarray, spp: int) -> np.ndarray:
    """The horizontal predictor: (rows, samples) unsigned values, each
    less the one ``spp`` samples before it in its row, wrapped."""
    out = rows.copy()
    out[:, spp:] = rows[:, spp:] - rows[:, :-spp]
    return out


def predict_float(rows: np.ndarray, spp: int) -> bytes:
    """The floating-point predictor: each row's float32 samples as byte
    planes, most significant first, then each byte less the one ``spp``
    bytes before it."""
    out = bytearray()
    for row in rows:
        planes = row.astype(">f4").view(np.uint8).reshape(-1, 4).T.ravel().astype(np.int64)
        diff = planes.copy()
        diff[spp:] = planes[spp:] - planes[:-spp]
        out += (diff & 255).astype(np.uint8).tobytes()
    return bytes(out)


# struct codes of the field types the writer takes (a RATIONAL or
# SRATIONAL given as numerator, denominator, ...)
_FMT = {1: "B", 3: "H", 4: "L", 5: "L", 6: "b", 7: "B", 8: "h", 9: "l", 10: "l", 16: "Q"}


def tiff_file(tags: dict, segments: list, *, order: str = "<", big: bool = False, prefix: bytes = None,
              tiled: bool = False, ifd_first: bool = False, counts: bool = True) -> bytes:
    """A TIFF of one IFD: ``tags`` {tag: (integer field type, values)} and
    the image's ``segments`` (strips, or tiles with ``tiled``) after the
    header, their offsets and byte counts added (LONG, or LONG8 in a
    BigTIFF; no byte counts without ``counts``); II (``order`` "<") or MM,
    classic or BigTIFF, or a ``prefix`` written in place of the byte-order
    mark. With ``ifd_first`` the IFD and its values come before the
    segments, so that cutting the file's tail cuts the image data."""
    head = 16 if big else 8
    tags = dict(tags)
    kind = 16 if big else 4
    entry, inline = (20, 8) if big else (12, 4)
    n = len(tags) + 1 + counts
    ifd_size = (8 if big else 2) + n * entry + (8 if big else 4)

    def values_size(tags_now: dict) -> int:
        size = 0
        for typ, values in tags_now.values():
            raw = len(values) * struct.calcsize("<" + _FMT[typ])
            size += 0 if raw <= inline else raw + raw % 2
        return size

    lengths = [len(s) for s in segments]
    if ifd_first:
        # the offsets' and counts' arrays are sized by their count only
        seg_tags = {324 if tiled else 273: (kind, [0] * len(segments))}
        if counts:
            seg_tags[325 if tiled else 279] = (kind, lengths)
        start = head + ifd_size + values_size({**tags, **seg_tags})
    else:
        start = head
    data = bytearray()
    seg_offsets = []
    for s in segments:
        seg_offsets.append(start + len(data))
        data += s
        if len(data) % 2:
            data += b"\0"
    tags[324 if tiled else 273] = (kind, seg_offsets)
    if counts:
        tags[325 if tiled else 279] = (kind, lengths)
    ifd_at = head if ifd_first else head + len(data)
    extra_at = ifd_at + ifd_size
    entries, extra = bytearray(), bytearray()
    for tag in sorted(tags):
        typ, values = tags[tag]
        raw = struct.pack(order + _FMT[typ] * len(values), *values)
        if len(raw) <= inline:
            value = raw + bytes(inline - len(raw))
        else:
            value = struct.pack(order + ("Q" if big else "L"), extra_at + len(extra))
            extra += raw + (b"\0" if len(raw) % 2 else b"")
        count = len(values) // 2 if typ in (5, 10) else len(values)
        entries += struct.pack(order + ("HHQ" if big else "HHL"), tag, typ, count) + value
    mark = b"II" if order == "<" else b"MM"
    if big:
        header = mark + struct.pack(order + "HHHQ", 43, 8, 0, ifd_at)
    else:
        header = mark + struct.pack(order + "HL", 42, ifd_at)
    if prefix is not None:
        header = prefix + header[4:]
    ifd = (struct.pack(order + ("Q" if big else "H"), len(tags)) + entries
           + struct.pack(order + ("Q" if big else "L"), 0))
    if ifd_first:
        return bytes(header + ifd + extra + data)
    return bytes(header + data + ifd + extra)


def _pack_rows(samples: np.ndarray, bits: int, order: str, sample_format: int) -> np.ndarray:
    """(H, W*S) samples -> (H, row bytes) uint8 in the file's layout."""
    h = samples.shape[0]
    if bits < 8:
        rows = []
        for row in samples.astype(np.uint8):
            rows.append(np.packbits(np.unpackbits(row[:, None], axis=1)[:, 8 - bits:].ravel()))
        return np.stack(rows)
    if bits == 12:
        rows = []
        for row in samples.astype(np.int64):
            acc = bytearray()
            for i in range(0, len(row), 2):
                a = int(row[i])
                b = int(row[i + 1]) if i + 1 < len(row) else None
                if b is None:
                    acc += bytes([a >> 4, (a & 15) << 4])
                else:
                    acc += bytes([a >> 4, ((a & 15) << 4) | (b >> 8), b & 255])
            rows.append(np.frombuffer(bytes(acc), np.uint8))
        return np.stack(rows)
    kind = {1: "u", 2: "i", 3: "f"}[sample_format]
    dt = np.dtype(f"{order}{kind}{bits // 8}")
    return samples.astype(dt).view(np.uint8).reshape(h, -1)


def tiff_image(samples: np.ndarray, *, photometric: int, bits: int, sample_format: int = 1, compression: int = 1,
               predictor: int = 1, rows_per_strip: int = None, tile=None, planar: int = 1, order: str = "<",
               big: bool = False, fill_order: int = 1, extra=(), colormap=None, orientation: int = None,
               old_lzw: bool = False, prefix: bytes = None, extra_tags: dict = None, bits_tag=None,
               samples_tag: int = None, lzw_clear: bool = True, ifd_first: bool = False, counts: bool = True) -> bytes:
    """A TIFF of (H, W, S) integer (or float) ``samples``: strips of
    ``rows_per_strip`` rows (default all) or ``tile`` (w, h) tiles padded
    with zeros, planar configuration 1 (samples interleaved) or 2 (one
    plane of segments per sample), ``compression`` 1, 5 (LZW, ``old_lzw``
    for libtiff's old codes), 8 or 32946 (deflate) or 32773 (PackBits),
    ``predictor`` 2 or 3 applied before it, every coded byte bit-reversed
    for ``fill_order`` 2 (the uncompressed samples too)."""
    samples = np.asarray(samples)
    if samples.ndim == 2:
        samples = samples[..., None]
    h, w, spp = samples.shape

    def encode(block: np.ndarray, spp_here: int) -> bytes:
        rows = _pack_rows(block.reshape(block.shape[0], -1), bits, order, sample_format)
        if predictor == 2:
            vals = block.reshape(block.shape[0], -1)
            if bits == 8:
                rows = predict(vals.astype(np.uint8), spp_here).astype(np.uint8)
            else:
                dt = np.dtype(f"{order}u{bits // 8}")
                wrapped = vals.astype(np.int64) & ((1 << bits) - 1)
                rows = predict(wrapped.astype(dt.newbyteorder("=")), spp_here).astype(dt).view(np.uint8)
                rows = rows.reshape(block.shape[0], -1)
            raw = rows.tobytes()
        elif predictor == 3:
            raw = predict_float(block.reshape(block.shape[0], -1).astype(np.float32), spp_here)
        else:
            raw = rows.tobytes()
        if compression == 5:
            coded = tiff_lzw(raw, old_style=old_lzw, start_clear=lzw_clear)
        else:
            coded = _compress(raw, compression)
        return coded.translate(BITFLIP) if fill_order == 2 else coded

    planes = [samples] if planar == 1 else [samples[..., k:k + 1] for k in range(spp)]
    segments = []
    if tile is None:
        rps = rows_per_strip or h
        for plane in planes:
            for y in range(0, h, rps):
                segments.append(encode(plane[y:y + rps], plane.shape[2]))
    else:
        tw, th = tile
        for plane in planes:
            for y in range(0, h, th):
                for x in range(0, w, tw):
                    block = np.zeros((th, tw, plane.shape[2]), samples.dtype)
                    part = plane[y:y + th, x:x + tw]
                    block[:part.shape[0], :part.shape[1]] = part
                    segments.append(encode(block, plane.shape[2]))
    short = 3
    tags = {256: (4, [w]), 257: (4, [h]), 258: (short, bits_tag or [bits] * spp), 259: (short, [compression]),
            262: (short, [photometric]), 277: (short, [samples_tag or spp]), 284: (short, [planar])}
    if tile is None:
        tags[278] = (4, [rows_per_strip or h])
    else:
        tags[322], tags[323] = (4, [tile[0]]), (4, [tile[1]])
    if predictor != 1:
        tags[317] = (short, [predictor])
    if sample_format != 1:
        tags[339] = (short, [sample_format] * spp)
    if fill_order != 1:
        tags[266] = (short, [fill_order])
    if extra:
        tags[338] = (short, list(extra))
    if colormap is not None:
        tags[320] = (short, [int(v) for v in np.asarray(colormap, np.int64).T.ravel()])
    if orientation is not None:
        tags[274] = (short, [orientation])
    tags.update(extra_tags or {})
    return tiff_file(tags, segments, order=order, big=big, prefix=prefix, tiled=tile is not None, ifd_first=ifd_first,
                     counts=counts)


# ------------------------------------------------------- TIFF: JPEG, YCbCr


def jpeg_segments(stream: bytes) -> list:
    """(marker, whole segment bytes) of a JPEG stream's marker segments
    from SOI up to SOS, then (0xDA, the rest: SOS, entropy data, EOI)."""
    out, pos = [], 2
    while True:
        marker = stream[pos + 1]
        if marker == 0xDA:
            out.append((marker, stream[pos:]))
            return out
        length = struct.unpack(">H", stream[pos + 2:pos + 4])[0]
        out.append((marker, stream[pos:pos + 2 + length]))
        pos += 2 + length


def abbreviate(streams: list) -> tuple:
    """(JPEGTables, streams): the DQT and DHT segments of the first stream
    as a tables-only stream (SOI, tables, EOI), and each stream without its
    DQT and DHT segments (an abbreviated stream), as libtiff's JPEG encoder
    writes them; every stream must hold the same tables."""
    tables = [seg for m, seg in jpeg_segments(streams[0]) if m in (0xDB, 0xC4)]
    out = []
    for stream in streams:
        segs = jpeg_segments(stream)
        if [seg for m, seg in segs if m in (0xDB, 0xC4)] != tables:
            raise ValueError("the streams' tables differ")
        out.append(b"\xff\xd8" + b"".join(seg for m, seg in segs if m not in (0xDB, 0xC4)))
    return b"\xff\xd8" + b"".join(tables) + b"\xff\xd9", out


def tiles_of(pixels: np.ndarray, tile=None, rows_per_strip: int = None, full_last: bool = False) -> list:
    """The strips (``rows_per_strip`` rows, the last one the rest, or
    padded to a whole strip by repeating its last row with ``full_last``)
    or ``tile`` (w, h) tiles (padded by repeating the edge) of ``pixels``,
    in file order, each the array a JPEG stream of it encodes."""
    h, w = pixels.shape[:2]
    pad = [(0, 0)] * (pixels.ndim - 2)
    if tile is None:
        rps = rows_per_strip or h
        out = []
        for y in range(0, h, rps):
            part = pixels[y:y + rps]
            if full_last and len(part) < rps:
                part = np.pad(part, [(0, rps - len(part)), (0, 0)] + pad, mode="edge")
            out.append(part)
        return out
    tw, th = tile
    return [np.pad(pixels[y:y + th, x:x + tw], [(0, th - len(pixels[y:y + th])),
                                                 (0, tw - pixels[y:y + th, x:x + tw].shape[1])] + pad, mode="edge")
            for y in range(0, h, th) for x in range(0, w, tw)]


def jpeg_tiff(streams: list, width: int, height: int, *, photometric: int, spp: int, rows_per_strip: int = None,
              tile=None, tables: bytes = None, subsampling=None, extra_tags: dict = None, order: str = "<",
              compression: int = 7, counts: bool = True, ifd_first: bool = False) -> bytes:
    """A JPEG-in-TIFF (compression 7) of one JPEG stream a strip or tile:
    ``JPEGTables`` (347, UNDEFINED) where ``tables`` is given, the
    ``YCbCrSubsampling`` tag where ``subsampling`` is (h, v), 8 bits a
    sample."""
    tags = {256: (4, [width]), 257: (4, [height]), 258: (3, [8] * spp), 259: (3, [compression]),
            262: (3, [photometric]), 277: (3, [spp]), 284: (3, [1])}
    if tile is None:
        tags[278] = (4, [rows_per_strip or height])
    else:
        tags[322], tags[323] = (4, [tile[0]]), (4, [tile[1]])
    if tables is not None:
        tags[347] = (7, list(tables))
    if subsampling is not None:
        tags[530] = (3, list(subsampling))
    tags.update(extra_tags or {})
    return tiff_file(tags, streams, order=order, tiled=tile is not None, counts=counts, ifd_first=ifd_first)


def ycbcr_units(ycc: np.ndarray, sub=(2, 2)) -> np.ndarray:
    """(H, W, 3) Y, Cb, Cr samples as a TIFF stores subsampled YCbCr
    (section 21): rows of data units, each ``sub`` (h, v) luma samples
    row by row then one Cb and one Cr (the block's first pixel's), the
    image padded to whole units by repeating its edge; as (unit rows,
    bytes) uint8."""
    sh, sv = sub
    h, w = ycc.shape[:2]
    ph, pw = -(-h // sv) * sv, -(-w // sh) * sh
    p = np.pad(ycc, ((0, ph - h), (0, pw - w), (0, 0)), mode="edge").astype(np.uint8)
    luma = p[..., 0].reshape(ph // sv, sv, pw // sh, sh).transpose(0, 2, 1, 3).reshape(ph // sv, pw // sh, sv * sh)
    chroma = p[::sv, ::sh, 1:]
    return np.concatenate([luma, chroma], -1).reshape(ph // sv, -1)


def ycbcr_tiff(ycc: np.ndarray, *, sub=(2, 2), compression: int = 5, rows_per_strip: int = None, tile=None,
               tags: dict = None, order: str = "<", predictor: int = 1) -> bytes:
    """A YCbCr TIFF (photometric 6) of (H, W, 3) samples in subsampled data
    units (``ycbcr_units``), strips of ``rows_per_strip`` rows (a multiple
    of the vertical subsampling) or ``tile`` (w, h) tiles, LZW, deflate,
    PackBits, LZMA or zstd; the ``YCbCrSubsampling`` tag written, and
    ``tags`` ({tag: (type, values)}: YCbCrCoefficients and
    ReferenceBlackWhite as RATIONAL are written by ``rational_tag``)."""
    sh, sv = sub
    h, w = ycc.shape[:2]
    blocks = []
    if tile is None:
        rps = rows_per_strip or h
        blocks = [ycbcr_units(ycc[y:y + rps], sub) for y in range(0, h, rps)]
    else:
        for part in tiles_of(ycc, tile):
            blocks.append(ycbcr_units(part, sub))
    segments = [_compress(b.tobytes(), compression) for b in blocks]
    all_tags = {256: (4, [w]), 257: (4, [h]), 258: (3, [8, 8, 8]), 259: (3, [compression]), 262: (3, [6]),
                277: (3, [3]), 284: (3, [1]), 530: (3, [sh, sv])}
    if tile is None:
        all_tags[278] = (4, [rows_per_strip or h])
    else:
        all_tags[322], all_tags[323] = (4, [tile[0]]), (4, [tile[1]])
    all_tags.update(tags or {})
    return tiff_file(all_tags, segments, order=order, tiled=tile is not None)


def _compress(raw: bytes, compression: int) -> bytes:
    if compression == 5:
        return tiff_lzw(raw)
    if compression in (8, 32946):
        return zlib.compress(raw, 6)
    if compression == 32773:
        return packbits(raw)
    if compression == 34925:
        import lzma

        return lzma.compress(raw, lzma.FORMAT_XZ, check=lzma.CHECK_NONE)
    if compression == 50000:
        return zstd_frame(raw)
    return raw


def zstd_frame(raw: bytes) -> bytes:
    """A zstd frame of ``raw``: the ``zstandard`` module's (level 3) where
    it is installed, else raw blocks of at most 128 KiB (RFC 8878
    3.1.1.2), which every decoder reads."""
    try:
        import zstandard
    except ImportError:
        return zstd_raw_blocks(raw)
    return zstandard.ZstdCompressor(level=3).compress(raw)


def ojpeg_tiff(jpeg: bytes, width: int, height: int, *, strip_at_jif: bool = False, photometric: int = 6,
               jif_length: bool = True, tags: dict = None) -> bytes:
    """An old-style JPEG TIFF (compression 6) in its JPEGInterchangeFormat
    form, as PIL cannot write one: the whole JPEG stream (SOI to EOI) at
    ``JPEGInterchangeFormat`` (513) with its length in 514 (unless not
    ``jif_length``), one strip whose offset is the stream's entropy data
    after its SOS (or the stream's start, ``strip_at_jif``), photometric
    ``photometric`` (None: no tag)."""
    segs = jpeg_segments(jpeg)
    sos = segs[-1][1]
    entropy = len(jpeg) - len(sos) + 2 + struct.unpack(">H", sos[2:4])[0]
    head = 8
    strip_at = 0 if strip_at_jif else entropy
    all_tags = {256: (4, [width]), 257: (4, [height]), 258: (3, [8, 8, 8]), 259: (3, [6]), 277: (3, [3]),
                278: (4, [height]), 273: (4, [head + strip_at]), 279: (4, [len(jpeg) - strip_at]), 513: (4, [head])}
    if photometric is not None:
        all_tags[262] = (3, [photometric])
    if jif_length:
        all_tags[514] = (4, [len(jpeg)])
    all_tags.update(tags or {})
    body = jpeg + b"\0" * (len(jpeg) % 2)
    # the stream is the one "segment" the writer places after the header;
    # the strip's offset and count name a part of it
    out = tiff_file({k: v for k, v in all_tags.items() if k not in (273, 279)}, [body])
    ifd_at = struct.unpack("<L", out[4:8])[0]
    n = struct.unpack("<H", out[ifd_at:ifd_at + 2])[0]
    out = bytearray(out)
    for i in range(n):
        at = ifd_at + 2 + 12 * i
        tag = struct.unpack("<H", out[at:at + 2])[0]
        if tag in (273, 279):
            out[at + 8:at + 12] = struct.pack("<L", all_tags[tag][1][0])
    return bytes(out)


def _png_chunk(kind: bytes, body: bytes) -> bytes:
    return struct.pack(">I", len(body)) + kind + body + struct.pack(">I", zlib.crc32(kind + body))


def apng_file(frames: list, default_in_animation: bool = True, default=None) -> bytes:
    """An APNG of (H, W, 4) uint8 frames (8-bit RGBA, filter 0 rows): the
    default image (IDAT) is the first frame with an fcTL before it, or, not
    ``default_in_animation``, ``default`` alone with the frames after it
    (no fcTL before IDAT); each other frame an fcTL and fdAT chunks."""
    h, w = frames[0].shape[:2]

    def rows(img):
        img = np.asarray(img, np.uint8)
        return zlib.compress(np.concatenate([np.zeros((h, 1), np.uint8), img.reshape(h, -1)], 1).tobytes(), 6)

    def fctl(seq: int) -> bytes:
        return _png_chunk(b"fcTL", struct.pack(">IIIIIHHBB", seq, w, h, 0, 0, 1, 10, 0, 0))

    out = b"\x89PNG\r\n\x1a\n" + _png_chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 6, 0, 0, 0))
    out += _png_chunk(b"acTL", struct.pack(">II", len(frames), 0))
    seq = 0
    if default_in_animation:
        out += fctl(seq) + _png_chunk(b"IDAT", rows(frames[0]))
        seq, rest = 1, frames[1:]
    else:
        out += _png_chunk(b"IDAT", rows(default))
        rest = frames
    for frame in rest:
        out += fctl(seq) + _png_chunk(b"fdAT", struct.pack(">I", seq + 1) + rows(frame))
        seq += 2
    return out + _png_chunk(b"IEND", b"")


def _jpeg_script():
    """The sequential-JPEG fixture script beside this one (its PIL-free
    baseline encoder)."""
    import importlib.util

    spec = importlib.util.spec_from_file_location("torch_port_jpeg_fixtures",
                                                  os.path.join(JPEG_DIR, "make_fixtures.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def baseline_420(pixels: np.ndarray, quality_table=None) -> bytes:
    """A baseline 4:2:0 YCbCr JPEG (JFIF) of (H, W, 3) uint8 pixels by the
    sequential fixture script's PIL-free encoder."""
    seq = _jpeg_script()
    y, cb, cr = seq._ycc(pixels)
    return seq.encode_baseline([y, seq._down(cb, 2, 2), seq._down(cr, 2, 2)], [(2, 2), (1, 1), (1, 1)],
                               quality_table=quality_table)


ZSTD_FORM = "zstd TIFF with predictor 2"
ZSTD_FRAME = "frame_a_zstd.tif"  # its compressed-block file, for the card's host


def frame_codec_forms(frame: np.ndarray, render: np.ndarray) -> dict:
    """Phase 9d's TIFF-codec and APNG sources, written without PIL: form ->
    file bytes (their pixels are PIL's, whose digests ``main`` stores in
    ``frame_digests.json``). From CO3D's 1067x800 frame: JPEG-in-TIFF of
    4:2:0 YCbCr in strips of 16 rows (abbreviated streams, JPEGTables) and
    in 128x128 tiles, LZMA, YCbCr 4:2:0 data units
    under LZW (libtiff's RGBA path), LAB under deflate (the frame's bytes
    read as L, a, b), old-style JPEG (one 4:2:0 stream at
    JPEGInterchangeFormat), and an uncompressed RGBA strip with EXIF
    orientation 6 (fault 13: ``Image.open(path)`` maps it); from the 512²
    render: an APNG whose default image is its first frame. 9d's zstd
    source is the committed ``ZSTD_FRAME`` (``zstd_frame_tiff``)."""
    seq = _jpeg_script()
    h, w = frame.shape[:2]
    strips = [baseline_420(part) for part in tiles_of(frame, None, 16)]
    tables, abbreviated = abbreviate(strips)
    tiles = [baseline_420(part) for part in tiles_of(frame, (128, 128))]
    ycc = np.stack(seq._ycc(frame), -1)
    rgba = np.dstack([frame, np.full((h, w), 255, np.uint8)])
    second = render.copy()
    second[..., :3] = 255 - second[..., :3]
    return {
        "JPEG-in-TIFF (YCbCr 4:2:0, strips)": jpeg_tiff(abbreviated, w, h, photometric=6, spp=3, rows_per_strip=16,
                                                        tables=tables, subsampling=(2, 2)),
        "JPEG-in-TIFF (YCbCr 4:2:0, tiles)": jpeg_tiff(tiles, w, h, photometric=6, spp=3, tile=(128, 128),
                                                       subsampling=(2, 2)),
        "LZMA TIFF": tiff_image(frame, photometric=2, bits=8, compression=34925, rows_per_strip=64),
        "YCbCr 4:2:0 LZW TIFF (libtiff's RGBA path)": ycbcr_tiff(ycc, sub=(2, 2), compression=5, rows_per_strip=16),
        "LAB TIFF with deflate": tiff_image(frame, photometric=8, bits=8, compression=8, rows_per_strip=64),
        "old-style JPEG TIFF": ojpeg_tiff(baseline_420(frame), w, h),
        "APNG (512² render)": apng_file([render, second]),
        "fault-13 TIFF (raw RGBA, orientation 6)": tiff_image(rgba, photometric=2, bits=8, extra=(2,), orientation=6),
    }


# ----------------------------------------------------- chip_smoke's sources


def frame_formats(frame: np.ndarray, render: np.ndarray) -> dict:
    """Phase 9d's sources, written without PIL: form -> (file bytes, the
    RGB pixels its decode must be). From CO3D's 1067x800 frame: a GIF (the
    frame quantized in numpy, its palette expanded), a 24-bit BMP, a TIFF
    with LZW and predictor 2 in strips of 16 rows, a TIFF with deflate in
    128x128 tiles, a 16-bit TIFF (the frame in the high bytes, seeded noise
    in the low ones); from the 512² render: an RLE8 BMP (its RGB quantized,
    the palette expanded)."""
    rng = np.random.default_rng(20)
    idx, pal = quantize(frame)
    ridx, rpal = quantize(render[..., :3])
    deep = (frame.astype(np.int64) << 8) | rng.integers(0, 256, frame.shape)
    return {
        "GIF": (gif_file(idx, pal), pal[idx]),
        "24-bit BMP": (bmp_24(frame), frame),
        "RLE8 BMP (512² render)": (bmp_rle8(ridx, rpal), rpal[ridx]),
        "LZW TIFF with predictor 2": (tiff_image(frame, photometric=2, bits=8, compression=5, predictor=2,
                                                 rows_per_strip=16), frame),
        "tiled deflate TIFF": (tiff_image(frame, photometric=2, bits=8, compression=8, tile=(128, 128)), frame),
        "16-bit TIFF": (tiff_image(deep, photometric=2, bits=16), frame),
    }


# ------------------------------------------------------------- fixtures


def _photo(rng, h: int, w: int, ch: int = 3) -> np.ndarray:
    """Smooth gradients with noise: a small stand-in for a photograph."""
    y, x = np.mgrid[:h, :w]
    base = np.stack([(x * 255 // max(w - 1, 1)), (y * 255 // max(h - 1, 1)), ((x + y) * 127 // max(h + w - 2, 1)),
                     (x * y) % 256][:ch], -1)
    return np.clip(base + rng.integers(-20, 21, base.shape), 0, 255).astype(np.uint8)


def _pil(img, fmt: str, mode: str = None, **options) -> bytes:
    from PIL import Image

    im = Image.fromarray(img) if not hasattr(img, "save") else img
    if mode:
        im = im.convert(mode)
    buf = io.BytesIO()
    im.save(buf, fmt, **options)
    return buf.getvalue()


def gif_fixtures(rng) -> dict:
    from PIL import Image

    files = {}
    photo = _photo(rng, 23, 31)
    idx, pal = quantize(photo, (4, 4, 4))
    p_img = Image.fromarray(idx, "P")
    p_img.putpalette(pal.tobytes())
    files["gif_pil_p.gif"] = _pil(p_img, "GIF")
    files["gif_pil_l.gif"] = _pil(photo, "GIF", "L")
    files["gif_pil_1.gif"] = _pil(photo, "GIF", "1")
    files["gif_pil_trns.gif"] = _pil(p_img, "GIF", transparency=3)
    files["gif_pil_interlace.gif"] = _pil(p_img.resize((31, 40), Image.NEAREST), "GIF", interlace=True)
    frame = idx[:11, :13]
    files["gif_offset.gif"] = gif_file(frame, pal, screen=(24, 17), offset=(5, 3))
    files["gif_offset_trns.gif"] = gif_file(frame, pal, screen=(24, 17), offset=(5, 3), transparency=9)
    files["gif_grow.gif"] = gif_file(frame, pal, screen=(10, 8), offset=(4, 2))
    local = pal[::-1].copy()
    files["gif_local_table.gif"] = gif_file(idx, pal, local=local)
    files["gif_local_only.gif"] = gif_file(idx, None, local=pal)
    gray = np.repeat(np.arange(len(pal), dtype=np.uint8)[:, None], 3, 1)
    files["gif_local_gray_ramp.gif"] = gif_file(idx, pal, local=gray)
    files["gif_no_palette.gif"] = gif_file(idx, None)
    files["gif_interlace.gif"] = gif_file(idx[:21], pal, interlace=True)
    files["gif_interlace_offset_trns.gif"] = gif_file(idx[:19, :20], pal, screen=(27, 25), offset=(2, 5),
                                                      interlace=True, transparency=0)
    files["gif87a.gif"] = gif_file(idx, pal, version=b"GIF87a")
    comment = b"!\xfe\x05hello\x03 gi\x00"
    netscape = b"!\xff\x0bNETSCAPE2.0\x03\x01\x00\x00\x00"
    plain_text = b"!\x01\x0c" + bytes(12) + b"\x00"
    files["gif_extensions.gif"] = gif_file(idx, pal, pre=comment + netscape + plain_text)
    two = (rng.random((17, 19)) < 0.3).astype(np.uint8)
    files["gif_2colour_min2.gif"] = gif_file(two, [[10, 20, 30], [200, 100, 50]])
    files["gif_min_size_8.gif"] = gif_file(two, [[10, 20, 30], [200, 100, 50]], min_size=8)
    noise = rng.integers(0, 256, (64, 96)).astype(np.uint8)
    big_pal = rng.integers(0, 256, (256, 3)).astype(np.uint8)
    files["gif_table_full_clear.gif"] = gif_file(noise, big_pal)
    files["gif_table_full_kept.gif"] = gif_file(noise, big_pal, lzw=gif_lzw(noise, 8, clear_when_full=False))
    files["gif_index_past_table.gif"] = gif_file(np.minimum(idx, 7) + (idx > 20) * 9, pal[:8])
    # refused by PIL: the data cut before the last pixel; a first code
    # above the clear code; a code past the next free entry
    good = files["gif_pil_p.gif"]
    files["bad_gif_truncated.gif"] = good[:len(good) * 2 // 3]
    files["bad_gif_early_end.gif"] = gif_file(idx, pal, lzw=gif_lzw(idx[:5], 5))
    b = _Bits()
    for c in (32, 40, 33):
        b.put(c, 6)
    files["bad_gif_first_code.gif"] = gif_file(idx, pal, min_size=5, lzw=b.flush())
    b = _Bits()
    for c in (32, 3, 60, 33):
        b.put(c, 6)
    files["bad_gif_future_code.gif"] = gif_file(idx, pal, min_size=5, lzw=b.flush())
    files["bad_gif_no_image.gif"] = good[:13 + 3 * 64] + b";"
    return files


def bmp_fixtures(rng) -> dict:
    files = {}
    photo = _photo(rng, 13, 19)
    files["bmp_pil_rgb.bmp"] = _pil(photo, "BMP")
    files["bmp_pil_l.bmp"] = _pil(photo, "BMP", "L")
    files["bmp_pil_1.bmp"] = _pil(photo, "BMP", "1")
    files["bmp_pil_p.bmp"] = _pil(photo, "BMP", "P")
    rgba = _photo(rng, 13, 19, 4)
    files["bmp_pil_rgba.bmp"] = _pil(rgba, "BMP")
    h, w = 11, 17
    bgr = _photo(rng, h, w)[..., ::-1]
    idx16 = rng.integers(0, 16, (h, w)).astype(np.uint8)
    pal16 = rng.integers(0, 256, (16, 3)).astype(np.uint8)
    idx256 = rng.integers(0, 200, (h, w)).astype(np.uint8)
    pal200 = rng.integers(0, 256, (200, 3)).astype(np.uint8)
    files["bmp_4bit.bmp"] = bmp_file(bmp_rows(idx16, 4), w, h, 4, palette=pal16)
    # a gray-ramp palette makes the 4-bit image mode L, read a byte a pixel:
    # at 3 pixels a 4-byte row holds it, at 17 PIL refuses the stride
    ramp = np.repeat(np.arange(16, dtype=np.uint8)[:, None], 3, 1)
    files["bmp_4bit_gray_ramp.bmp"] = bmp_file(bmp_rows(idx16[:, :3], 4), 3, h, 4, palette=ramp)
    files["bad_bmp_4bit_gray_ramp_wide.bmp"] = bmp_file(bmp_rows(idx16, 4), w, h, 4, palette=ramp)
    files["bmp_1bit_p.bmp"] = bmp_file(bmp_rows(idx16 & 1, 1), w, h, 1, palette=[[200, 30, 40], [10, 220, 90]])
    files["bmp_8bit_bw.bmp"] = bmp_file(bmp_rows(idx16 & 1, 8), w, h, 8, palette=[[0, 0, 0], [255, 255, 255]])
    files["bmp_8bit_short_palette.bmp"] = bmp_file(bmp_rows(idx256, 8), w, h, 8, palette=pal200[:50])
    files["bmp_8bit_topdown.bmp"] = bmp_file(bmp_rows(idx256, 8, top_down=True), w, h, 8, palette=pal200,
                                             top_down=True)
    files["bmp_os2_8bit.bmp"] = bmp_file(bmp_rows(idx256, 8), w, h, 8, header=12,
                                         palette=np.vstack([pal200, np.zeros((56, 3), np.uint8)]))
    files["bmp_os2_24bit.bmp"] = bmp_file(bmp_rows(bgr, 24), w, h, 24, header=12)
    files["bmp_os2v2_64_24bit.bmp"] = bmp_file(bmp_rows(bgr, 24), w, h, 24, header=64)
    for hs in (52, 56, 108, 124):
        files[f"bmp_v{hs}_24bit.bmp"] = bmp_file(bmp_rows(bgr, 24), w, h, 24, header=hs)
    files["bmp_offset_counts_no_palette.bmp"] = bmp_file(bmp_rows(idx16, 4), w, h, 4, palette=pal16, offset=54)
    files["bmp_16bit_rgb.bmp"] = bmp_file(bmp_rows(rng.integers(0, 256, (h, w, 2)), 16), w, h, 16)
    for name, masks in (("565", (0xF800, 0x7E0, 0x1F)), ("555", (0x7C00, 0x3E0, 0x1F))):
        files[f"bmp_bitfields_{name}.bmp"] = bmp_file(bmp_rows(rng.integers(0, 256, (h, w, 2)), 16), w, h, 16,
                                                      compression=3, masks=masks)
    px32 = rng.integers(0, 256, (h, w, 4))
    for name, masks, hs in (("bgrx", (0xFF0000, 0xFF00, 0xFF, 0), 40), ("xbgr", (0xFF000000, 0xFF0000, 0xFF00, 0), 40),
                            ("bgxr", (0xFF000000, 0xFF00, 0xFF, 0), 56),
                            ("abgr", (0xFF000000, 0xFF0000, 0xFF00, 0xFF), 56),
                            ("rgba", (0xFF, 0xFF00, 0xFF0000, 0xFF000000), 108),
                            ("bgra", (0xFF0000, 0xFF00, 0xFF, 0xFF000000), 124),
                            ("bgar", (0xFF000000, 0xFF00, 0xFF, 0xFF0000), 124), ("zero", (0, 0, 0, 0), 124)):
        files[f"bmp_bitfields_{name}.bmp"] = bmp_file(bmp_rows(px32, 32), w, h, 32, header=hs, compression=3,
                                                      masks=masks)
    files["bmp_bitfields_24.bmp"] = bmp_file(bmp_rows(bgr, 24), w, h, 24, compression=3, masks=(0xFF0000, 0xFF00, 0xFF))
    runs = np.repeat(np.repeat(idx256[:, ::3], 3, 1)[:, :w], 1, 0)
    runs[3, 2:9] = idx256[3, 2:9]  # a literal stretch (an absolute run)
    files["bmp_rle8.bmp"] = bmp_rle8(runs, pal200)
    files["bmp_rle8_gray.bmp"] = bmp_file(rle_encode(runs), w, h, 8, compression=1,
                                          palette=np.repeat(np.arange(256, dtype=np.uint8)[:, None], 3, 1))
    odd = runs.copy()
    odd[5, 1:6] = [1, 2, 3, 4, 5]  # an absolute run of odd length: a pad byte after it
    files["bmp_rle8_odd_absolute.bmp"] = bmp_rle8(odd, pal200)
    runs4 = np.repeat(idx16[:, ::2], 2, 1)[:, :w]
    runs4[2, 3:10] = idx16[2, 3:10]
    files["bmp_rle4.bmp"] = bmp_file(rle_encode(runs4, four=True), w, h, 4, compression=2, palette=pal16)
    # a delta (skipping pixels, which stay index 0) and an end of line
    # before the row is full; PIL reads four bytes for a delta and moves by
    # the last two
    delta = bytearray()
    for r in range(h):
        if r == 4:
            delta += bytes([3, 7, 0, 2, 9, 9, 2, 1, 4, 5]) + b"\0\0"
        else:
            delta += bytes([w, (r * 7) % 200]) + b"\0\0"
    files["bmp_rle8_delta.bmp"] = bmp_file(bytes(delta) + b"\0\1", w, h, 8, compression=1, palette=pal200)
    files["dib_24bit.dib"] = bmp_file(bmp_rows(bgr, 24), w, h, 24, dib=True)
    files["dib_8bit.dib"] = bmp_file(bmp_rows(idx256, 8), w, h, 8, palette=pal200, dib=True)
    files["dib_os2_4bit.dib"] = bmp_file(bmp_rows(idx16, 4), w, h, 4, header=12, palette=pal16, dib=True)
    files["dib_rle8.dib"] = bmp_file(rle_encode(runs), w, h, 8, compression=1, palette=pal200, dib=True)
    # refused by PIL: pixel data cut short, an RLE image whose runs end
    # before its last row, an unknown depth, header and compression, bit
    # fields outside PIL's table, RLE in mode RGB
    files["bad_bmp_truncated.bmp"] = files["bmp_pil_rgb.bmp"][:-40]
    files["bad_bmp_rle_short.bmp"] = bmp_file(rle_encode(runs[:6], end=True), w, h, 8, compression=1, palette=pal200)
    files["bad_bmp_depth2.bmp"] = bmp_file(bmp_rows(idx16 & 3, 2), w, h, 2, palette=pal16[:4])
    rgb_bmp = files["bmp_pil_rgb.bmp"]
    files["bad_bmp_header_20.bmp"] = rgb_bmp[:14] + struct.pack("<I", 20) + rgb_bmp[18:]
    files["bad_bmp_compression_jpeg.bmp"] = bmp_file(bmp_rows(bgr, 24), w, h, 24, compression=4)
    files["bad_bmp_bitfields.bmp"] = bmp_file(bmp_rows(px32, 32), w, h, 32, compression=3,
                                              masks=(0xFF, 0xFF00, 0xFF0000))
    files["bad_bmp_rle24.bmp"] = bmp_file(rle_encode(runs), w, h, 24, compression=1)
    return files


def tiff_fixtures(rng) -> dict:
    files = {}
    h, w = 21, 27
    rgb = _photo(rng, h, w)
    rgba = _photo(rng, h, w, 4)
    rgba[..., 3] = np.where(rgba[..., 3] < 60, 0, rgba[..., 3])
    for comp, tag in ((None, "raw"), ("packbits", "packbits"), ("tiff_lzw", "lzw"), ("tiff_adobe_deflate", "deflate"),
                      ("tiff_deflate", "zip")):
        files[f"tif_pil_{tag}_rgb.tif"] = _pil(rgb, "TIFF", compression=comp)
    files["tif_pil_lzw_pred2_strips.tif"] = _pil(rgb, "TIFF", compression="tiff_lzw", predictor=2, rowsperstrip=4)
    files["tif_pil_deflate_pred2_tiled.tif"] = _pil(rgb, "TIFF", compression="tiff_adobe_deflate", predictor=2,
                                                    tile=(16, 16))
    files["tif_pil_rgba.tif"] = _pil(rgba, "TIFF")
    files["tif_pil_rgba_lzw.tif"] = _pil(rgba, "TIFF", compression="tiff_lzw")
    for mode in ("L", "1", "P", "LA", "PA", "CMYK"):
        files[f"tif_pil_{mode.lower()}.tif"] = _pil(rgb if mode != "LA" else rgba, "TIFF", mode)
        files[f"tif_pil_{mode.lower()}_lzw.tif"] = _pil(rgb if mode != "LA" else rgba, "TIFF", mode,
                                                         compression="tiff_lzw")
    deep = rng.integers(0, 65536, (h, w)).astype(np.uint16)
    deep[:4] = rng.integers(0, 300, (4, w))
    files["tif_pil_i16.tif"] = _pil(deep, "TIFF")
    files["tif_pil_i16_deflate.tif"] = _pil(deep, "TIFF", compression="tiff_adobe_deflate")
    ints = rng.integers(-400, 700, (h, w)).astype(np.int32)
    files["tif_pil_i32.tif"] = _pil(ints, "TIFF")
    floats = (rng.normal(120, 150, (h, w))).astype(np.float32)
    floats[0, :6] = [-1, 0.4, 100.6, 300, 255.9, -0.9]
    files["tif_pil_f.tif"] = _pil(floats, "TIFF")
    files["tif_pil_f_lzw.tif"] = _pil(floats, "TIFF", compression="tiff_lzw")
    files["tif_pil_ycbcr_raw.tif"] = _pil(rgb, "TIFF", "YCbCr")
    # hand-written: strips, tiles, planes, byte orders, containers
    s16 = (rgb.astype(np.int64) << 8) | rng.integers(0, 256, rgb.shape)
    files["tif_raw_tiles_edge.tif"] = tiff_image(rgb, photometric=2, bits=8, tile=(16, 16))
    files["tif_raw_planar.tif"] = tiff_image(rgb, photometric=2, bits=8, planar=2, rows_per_strip=5)
    files["tif_raw_planar_cmyk.tif"] = tiff_image(rgba, photometric=5, bits=8, planar=2, rows_per_strip=8)
    files["tif_lzw_planar_rgba16.tif"] = tiff_image(np.dstack([s16, (rgba[..., 3:].astype(np.int64) << 8)]),
                                                    photometric=2, bits=16, planar=2, extra=(2,), compression=5,
                                                    rows_per_strip=6)
    files["tif_deflate_planar_tiled.tif"] = tiff_image(rgb, photometric=2, bits=8, planar=2, compression=8,
                                                       tile=(16, 16))
    files["tif_packbits_tiled.tif"] = tiff_image(rgba, photometric=2, bits=8, extra=(2,), compression=32773,
                                                 tile=(16, 32))
    files["tif_lzw_old_style.tif"] = tiff_image(rgb, photometric=2, bits=8, compression=5, old_lzw=True,
                                                rows_per_strip=7)
    noise = rng.integers(0, 256, (90, 120, 3))
    files["tif_lzw_table_clears.tif"] = tiff_image(noise, photometric=2, bits=8, compression=5)
    files["tif_lzw_pred2_16bit_mm.tif"] = tiff_image(s16, photometric=2, bits=16, compression=5, predictor=2,
                                                     order=">", rows_per_strip=8)
    files["tif_deflate_pred2_16bit.tif"] = tiff_image(s16, photometric=2, bits=16, compression=32946, predictor=2)
    files["tif_deflate_pred3_float.tif"] = tiff_image(floats, photometric=1, bits=32, sample_format=3,
                                                      compression=8, predictor=3)
    files["tif_deflate_pred3_float_mm.tif"] = tiff_image(floats, photometric=1, bits=32, sample_format=3,
                                                         compression=8, predictor=3, order=">")
    files["tif_lzw_pred2_i32.tif"] = tiff_image(ints, photometric=1, bits=32, sample_format=2, compression=5,
                                                predictor=2)
    files["tif_raw_mm_i16.tif"] = tiff_image(deep, photometric=1, bits=16, order=">")
    files["tif_lzw_mm_i16.tif"] = tiff_image(deep, photometric=1, bits=16, order=">", compression=5)
    files["tif_raw_mm_f32.tif"] = tiff_image(floats, photometric=1, bits=32, sample_format=3, order=">")
    files["tif_lzw_mm_f32.tif"] = tiff_image(floats, photometric=1, bits=32, sample_format=3, order=">",
                                             compression=5)
    files["tif_raw_i16_signed.tif"] = tiff_image(ints.astype(np.int16), photometric=1, bits=16, sample_format=2)
    files["tif_raw_i16_signed_mm.tif"] = tiff_image(ints.astype(np.int16), photometric=1, bits=16, sample_format=2,
                                                    order=">")
    files["tif_raw_12bit.tif"] = tiff_image(rng.integers(0, 4096, (h, w)), photometric=1, bits=12)
    for bits in (2, 4):
        g = rng.integers(0, 1 << bits, (h, w))
        files[f"tif_raw_gray{bits}.tif"] = tiff_image(g, photometric=1, bits=bits)
        files[f"tif_raw_gray{bits}_white_is_zero.tif"] = tiff_image(g, photometric=0, bits=bits)
        files[f"tif_lzw_p{bits}.tif"] = tiff_image(g, photometric=3, bits=bits, compression=5,
                                                   colormap=rng.integers(0, 65536, (1 << bits, 3)))
    bits1 = rng.integers(0, 2, (h, w))
    files["tif_raw_1bit_fill2.tif"] = tiff_image(bits1, photometric=1, bits=1, fill_order=2)
    files["tif_raw_1bit_white_is_zero_fill2.tif"] = tiff_image(bits1, photometric=0, bits=1, fill_order=2)
    files["tif_lzw_1bit_fill2.tif"] = tiff_image(bits1, photometric=1, bits=1, fill_order=2, compression=5)
    files["tif_raw_rgb_fill2.tif"] = tiff_image(rgb, photometric=2, bits=8, fill_order=2)
    files["tif_deflate_rgb_fill2.tif"] = tiff_image(rgb, photometric=2, bits=8, fill_order=2, compression=8)
    files["tif_packbits_l_fill2.tif"] = tiff_image(rgb[..., 0], photometric=1, bits=8, fill_order=2,
                                                   compression=32773)
    files["tif_raw_i16_fill2.tif"] = tiff_image(deep, photometric=1, bits=16, fill_order=2)
    files["tif_raw_rgba_assoc.tif"] = tiff_image(rgba, photometric=2, bits=8, extra=(1,))
    files["tif_lzw_rgba16_assoc.tif"] = tiff_image(np.dstack([s16, rgba[..., 3:].astype(np.int64) << 8]),
                                                   photometric=2, bits=16, extra=(1,), compression=5)
    files["tif_raw_rgbx.tif"] = tiff_image(rgba, photometric=2, bits=8, extra=(0,))
    files["tif_raw_rgbaxx.tif"] = tiff_image(np.dstack([rgba, rgb[..., :2]]), photometric=2, bits=8,
                                             extra=(2, 0, 0))
    files["tif_raw_rgba_no_extra.tif"] = tiff_image(rgba, photometric=2, bits=8)
    files["tif_raw_cmyk16_mm.tif"] = tiff_image(np.dstack([s16, s16[..., :1]]), photometric=5, bits=16, order=">")
    files["tif_raw_px.tif"] = tiff_image(np.dstack([rgb[..., 0], rgb[..., 1]]), photometric=3, bits=8, extra=(0,),
                                         colormap=rng.integers(0, 65536, (256, 3)))
    files["tif_bigtiff_lzw.tif"] = tiff_image(rgb, photometric=2, bits=8, compression=5, big=True,
                                              rows_per_strip=8)
    files["tif_bigtiff_raw.tif"] = tiff_image(rgba, photometric=2, bits=8, extra=(2,), big=True)
    files["tif_mm_deflate_tiled.tif"] = tiff_image(rgb, photometric=2, bits=8, compression=8, order=">",
                                                   tile=(16, 16))
    files["tif_invalid_mark_mm_raw.tif"] = tiff_image(rgb, photometric=2, bits=8, order=">", prefix=b"MM\x2a\x00")
    files["tif_invalid_mark_ii_raw.tif"] = tiff_image(rgb, photometric=2, bits=8, prefix=b"II\x00\x2a")
    for o in (3, 6, 8):
        files[f"tif_orientation{o}.tif"] = tiff_image(rgb, photometric=2, bits=8, compression=5, orientation=o)
    files["tif_orientation5_raw.tif"] = tiff_image(rgb, photometric=2, bits=8, orientation=5, rows_per_strip=4)
    files["tif_pil_ycbcr_lzw.tif"] = _pil(rgb, "TIFF", "YCbCr", compression="tiff_lzw")
    files["tif_pil_jpeg_rgb.tif"] = _pil(rgb, "TIFF", compression="jpeg")
    # what PIL reads and the port does not (ROADMAP item 13c)
    files["notread_tif_group4.tif"] = _pil(rgb, "TIFF", "1", compression="group4")
    files["tif_lab_raw.tif"] = tiff_image(rgb, photometric=8, bits=8)
    # refused by PIL or libtiff
    files["bad_tif_lzw_cut.tif"] = _cut_segment(rgb, 5)
    files["bad_tif_lzw_no_clear.tif"] = tiff_image(rgb, photometric=2, bits=8, compression=5, lzw_clear=False)
    files["bad_tif_raw_truncated.tif"] = files["tif_raw_tiles_edge.tif"][:300]
    files["bad_tif_packbits_short.tif"] = _cut_segment(rgb, 32773)
    files["bad_tif_deflate_short.tif"] = _cut_segment(rgb, 8)
    files["bad_tif_mm_bigtiff.tif"] = tiff_image(rgb, photometric=2, bits=8, big=True, order=">")
    files["bad_tif_invalid_mark_lzw.tif"] = tiff_image(rgb, photometric=2, bits=8, order=">", compression=5,
                                                       prefix=b"MM\x2a\x00")
    files["bad_tif_pred2_4bit.tif"] = tiff_image(rng.integers(0, 16, (h, w)), photometric=1, bits=4, compression=5,
                                                 extra_tags={317: (3, [2])})
    files["bad_tif_unknown_mode.tif"] = tiff_image(rgb[..., :2], photometric=2, bits=8)
    files["bad_tif_ycbcr_raw.tif"] = files.pop("tif_pil_ycbcr_raw.tif")
    return files


def codec_fixtures(rng) -> dict:
    """The TIFF forms libtiff reads through decoders the port has: JPEG
    (7) in each photometric, subsampling and layout, old-style JPEG (6),
    YCbCr through libtiff's RGBA path, zstd, LZMA, files without byte
    counts; APNG; what PIL refuses among them; and the fault-13 class (a
    raw TIFF ``Image.open(path)`` maps)."""
    files = {}
    h, w = 37, 45
    y, x = np.mgrid[:h, :w]
    rgb = np.clip(np.stack([x * 5, y * 6, (x + y) * 3], -1) + rng.integers(-20, 21, (h, w, 3)), 0, 255)
    rgb = rgb.astype(np.uint8)

    def jpeg(part, mode=None, **options):
        return _pil(part if mode is None else part, "JPEG", mode, quality=80, **options)

    def strips(pixels, tile=None, rps=None, full_last=False, **options):
        return [jpeg(part, **options) for part in tiles_of(pixels, tile, rps, full_last)]

    # JPEG (7): PIL's writer (libtiff's encoder, JPEGTables, 4:4:4 YCbCr)
    for mode in ("L", "CMYK", "RGBA"):
        files[f"tif_pil_jpeg_{mode.lower()}.tif"] = _pil(rgb, "TIFF", mode, compression="jpeg")
    files["tif_pil_jpeg_ycbcr.tif"] = _pil(rgb, "TIFF", "YCbCr", compression="jpeg")
    files["tif_pil_jpeg_ycbcr_tiled.tif"] = _pil(rgb, "TIFF", "YCbCr", compression="jpeg", tile=(16, 16))
    # by hand: each subsampling, strips and tiles, abbreviated streams
    for ss, sub in ((0, (1, 1)), (1, (2, 1)), (2, (2, 2))):
        name = f"{sub[0]}{sub[1]}"
        parts = strips(rgb, rps=16, subsampling=ss)
        files[f"tif_jpeg_ycbcr{name}_strips.tif"] = jpeg_tiff(parts, w, h, photometric=6, spp=3, rows_per_strip=16,
                                                              subsampling=sub)
        tables, short = abbreviate(parts)
        files[f"tif_jpeg_ycbcr{name}_tables.tif"] = jpeg_tiff(short, w, h, photometric=6, spp=3, rows_per_strip=16,
                                                              tables=tables, subsampling=sub)
        tiles = strips(rgb, tile=(16, 16), subsampling=ss)
        tables, short = abbreviate(tiles)
        files[f"tif_jpeg_ycbcr{name}_tiled.tif"] = jpeg_tiff(short, w, h, photometric=6, spp=3, tile=(16, 16),
                                                             tables=tables, subsampling=sub)
    files["tif_jpeg_ycbcr22_full_last.tif"] = jpeg_tiff(strips(rgb, rps=16, full_last=True, subsampling=2), w, h,
                                                        photometric=6, spp=3, rows_per_strip=16, subsampling=(2, 2))
    files["tif_jpeg_ycbcr22_no_tag.tif"] = jpeg_tiff(strips(rgb, rps=8, subsampling=2), w, h, photometric=6, spp=3,
                                                     rows_per_strip=8)
    files["tif_jpeg_ycbcr21_tiles_32x16_mm.tif"] = jpeg_tiff(strips(rgb, tile=(32, 16), subsampling=1), w, h,
                                                             photometric=6, spp=3, tile=(32, 16), subsampling=(2, 1),
                                                             order=">")
    files["tif_jpeg_gray_strips.tif"] = jpeg_tiff(strips(rgb[..., 1], rps=8), w, h, photometric=1, spp=1,
                                                  rows_per_strip=8)
    # RGB photometric over a 4:4:4 YCbCr stream: libtiff converts nothing
    files["tif_jpeg_rgb_ycc_stream.tif"] = jpeg_tiff(strips(rgb, rps=16, subsampling=0), w, h, photometric=2, spp=3,
                                                     rows_per_strip=16)
    cmyk = np.dstack([rgb, rgb[..., :1] // 2])
    inverted = [_pil(Image_cmyk(part), "JPEG", quality=80) for part in tiles_of(cmyk, None, 16)]
    files["tif_jpeg_cmyk_inverted.tif"] = jpeg_tiff(inverted, w, h, photometric=5, spp=4, rows_per_strip=16)
    # refused by libtiff: the tag's subsampling against the stream's; a
    # subsampled stream under RGB; a non-last strip taller than RowsPerStrip
    parts22 = strips(rgb, rps=16, subsampling=2)
    files["bad_tif_jpeg_wrong_sampling.tif"] = jpeg_tiff(parts22, w, h, photometric=6, spp=3, rows_per_strip=16,
                                                         subsampling=(2, 1))
    files["bad_tif_jpeg_rgb_subsampled.tif"] = jpeg_tiff(parts22, w, h, photometric=2, spp=3, rows_per_strip=16)
    files["bad_tif_jpeg_tall_strip.tif"] = jpeg_tiff(strips(rgb, rps=24, subsampling=2), w, h, photometric=6, spp=3,
                                                     rows_per_strip=16, subsampling=(2, 2))
    files["bad_tif_jpeg_tables_with_frame.tif"] = jpeg_tiff(parts22, w, h, photometric=6, spp=3, rows_per_strip=16,
                                                            subsampling=(2, 2), tables=parts22[0])
    # read by PIL with rows libtiff leaves unwritten: a JPEG shorter than its strip
    files["notread_tif_jpeg_short_strip.tif"] = jpeg_tiff(strips(rgb, rps=8, subsampling=2), w, h, photometric=6,
                                                          spp=3, rows_per_strip=16, subsampling=(2, 2))
    # old-style JPEG (6), JPEGInterchangeFormat
    for ss, name in ((2, "420"), (1, "422"), (0, "444")):
        files[f"tif_ojpeg_{name}.tif"] = ojpeg_tiff(jpeg(rgb, subsampling=ss), w, h)
    files["tif_ojpeg_strip_at_stream.tif"] = ojpeg_tiff(jpeg(rgb, subsampling=2), w, h, strip_at_jif=True)
    files["tif_ojpeg_no_photometric_no_length.tif"] = ojpeg_tiff(jpeg(rgb, subsampling=2), w, h, photometric=None,
                                                                 jif_length=False)
    files["tif_ojpeg_rgb_ref_black_white.tif"] = ojpeg_tiff(jpeg(rgb, subsampling=1), w, h, photometric=2,
                                                            tags={532: (5, [16, 1, 235, 1, 128, 1, 240, 1, 128, 1,
                                                                            240, 1])})
    files["bad_tif_ojpeg_progressive.tif"] = ojpeg_tiff(jpeg(rgb, subsampling=2, progressive=True), w, h)
    # YCbCr through libtiff's RGBA path
    ycc = rng.integers(0, 256, (h, w, 3))
    coeffs = {529: (5, [2126, 10000, 7152, 10000, 722, 10000]),
              532: (5, [16, 1, 235, 1, 128, 1, 240, 1, 128, 1, 240, 1])}
    for sub, comp, lay in (((2, 2), 5, {}), ((2, 1), 8, {"rows_per_strip": 6}), ((4, 2), 32773, {}),
                           ((4, 4), 5, {"tile": (16, 16)}), ((1, 2), 50000, {"rows_per_strip": 4}),
                           ((4, 1), 34925, {}), ((1, 1), 32946, {"tile": (32, 16)})):
        name = f"tif_ycbcr{sub[0]}{sub[1]}_{COMPRESSION_NAMES[comp]}{'_tiled' if 'tile' in lay else ''}.tif"
        files[name] = ycbcr_tiff(ycc, sub=sub, compression=comp, **lay)
    files["tif_ycbcr22_coefficients.tif"] = ycbcr_tiff(ycc, sub=(2, 2), compression=5, tags=coeffs)
    files["tif_ycbcr44_short_rows.tif"] = ycbcr_tiff(ycc[:, :41], sub=(4, 4), compression=5, rows_per_strip=8)
    files["tif_ycbcr11_pred2.tif"] = ycbcr_tiff(ycc, sub=(1, 1), compression=5, predictor=2,
                                                tags={317: (3, [2])})
    files["tif_ycbcr22_orientation6.tif"] = ycbcr_tiff(ycc, sub=(2, 2), compression=5, tags={274: (3, [6])})
    files["bad_tif_ycbcr24.tif"] = ycbcr_tiff(ycc, sub=(2, 4), compression=5)
    files["notread_tif_ycbcr_planar.tif"] = tiff_image(ycc, photometric=6, bits=8, compression=5, planar=2,
                                                       extra_tags={530: (3, [1, 1])})
    # LAB (PIL's LittleCMS conversion to RGB): contiguous and planar, coded
    lab = rng.integers(0, 256, (h, w, 3))
    files["tif_pil_lab_lzw.tif"] = _pil(Image_lab(lab), "TIFF", compression="tiff_lzw")
    files["tif_pil_lab_jpeg.tif"] = _pil(Image_lab(lab), "TIFF", compression="jpeg")
    files["tif_lab_planar_raw.tif"] = tiff_image(lab, photometric=8, bits=8, planar=2, rows_per_strip=9)
    files["tif_lab_planar_zstd_tiled.tif"] = tiff_image(lab, photometric=8, bits=8, planar=2, compression=50000,
                                                        tile=(16, 16))
    # old-style JPEG with its tables in tags 519-521 (queued)
    files["notread_tif_ojpeg_tables_in_tags.tif"] = ojpeg_tables_in_tags(jpeg(rgb[:32, :32], subsampling=2), 32, 32)
    # zstd and LZMA
    for comp in (50000, 34925):
        name = COMPRESSION_NAMES[comp]
        files[f"tif_pil_{name}_rgb.tif"] = _pil(rgb, "TIFF", compression=name)
        files[f"tif_{name}_pred2_tiled.tif"] = tiff_image(rgb, photometric=2, bits=8, compression=comp, predictor=2,
                                                          tile=(16, 32))
        files[f"tif_{name}_planar_16bit_mm.tif"] = tiff_image((rgb.astype(np.int64) << 8) | 7, photometric=2,
                                                              bits=16, compression=comp, planar=2, order=">",
                                                              rows_per_strip=10)
    files["tif_zstd_raw_blocks.tif"] = tiff_file(
        {256: (4, [w]), 257: (4, [h]), 258: (3, [8, 8, 8]), 259: (3, [50000]), 262: (3, [2]), 277: (3, [3]),
         278: (4, [h]), 284: (3, [1])}, [zstd_raw_blocks(rgb.tobytes()) + b"trailing bytes"])
    files["bad_tif_zstd_cut.tif"] = _cut_segment(rgb, 50000)
    files["bad_tif_lzma_cut.tif"] = _cut_segment(rgb, 34925)
    # without byte counts (libtiff estimates them)
    files["tif_lzw_no_counts.tif"] = tiff_image(rgb, photometric=2, bits=8, compression=5, counts=False)
    files["tif_deflate_no_counts_planar.tif"] = tiff_image(rgb, photometric=2, bits=8, compression=8, planar=2,
                                                           counts=False, ifd_first=True)
    files["tif_zstd_no_counts_bigtiff.tif"] = tiff_image(rgb, photometric=2, bits=8, compression=50000, big=True,
                                                         counts=False, tile=(48, 48))
    files["tif_jpeg_no_counts.tif"] = jpeg_tiff([jpeg(rgb, subsampling=2)], w, h, photometric=6, spp=3,
                                                counts=False, ifd_first=True, subsampling=(2, 2))
    files["bad_tif_no_counts_two_strips.tif"] = tiff_image(rgb, photometric=2, bits=8, compression=5,
                                                           rows_per_strip=20, counts=False)
    # WebP (50001): PIL's libtiff has no WebP codec
    files["bad_tif_webp.tif"] = tiff_file({256: (4, [w]), 257: (4, [h]), 258: (3, [8, 8, 8]), 259: (3, [50001]),
                                           262: (3, [2]), 277: (3, [3]), 278: (4, [h]), 284: (3, [1])},
                                          [_pil(rgb, "WEBP", lossless=True)])
    # fault 13's class, read by bytes here (the path read is the test's)
    files["tif_orientation6_raw_l.tif"] = tiff_image(rgb[..., 0], photometric=1, bits=8, orientation=6)
    files["tif_orientation8_raw_rgba.tif"] = tiff_image(np.dstack([rgb, rgb[..., :1]]), photometric=2, bits=8,
                                                        extra=(2,), orientation=8)
    return files


def Image_lab(samples: np.ndarray):
    """A PIL LAB image whose file bytes (L, signed a, signed b) are
    ``samples``."""
    from PIL import Image

    return Image.frombytes("LAB", samples.shape[1::-1], np.asarray(samples, np.uint8).tobytes())


def ojpeg_tables_in_tags(jpeg: bytes, width: int, height: int) -> bytes:
    """An old-style JPEG TIFF without JPEGInterchangeFormat: JPEGProc 1,
    the quantization and Huffman tables of a baseline 4:2:0 stream in tags
    519-521 (offsets to 64 bytes of a table, to 16 counts and the symbols;
    one a component, luma then chroma twice) and the stream's entropy data
    as the one strip."""
    segs = dict()
    for marker, seg in jpeg_segments(jpeg):
        segs.setdefault(marker, []).append(seg)
    qt, dc, ac = {}, {}, {}
    for seg in segs[0xDB]:
        body, p = seg[4:], 0
        while p < len(body):
            qt[body[p] & 15] = body[p + 1:p + 65]
            p += 65
    for seg in segs[0xC4]:
        body, p = seg[4:], 0
        while p < len(body):
            n = sum(body[p + 1:p + 17])
            (ac if body[p] >> 4 else dc)[body[p] & 15] = body[p + 1:p + 17 + n]
            p += 17 + n
    sos = segs[0xDA][0]
    entropy = sos[2 + struct.unpack(">H", sos[2:4])[0]:]
    blobs = [qt[0], qt[1], qt[1], dc[0], dc[1], dc[1], ac[0], ac[1], ac[1]]
    tags = {256: (4, [width]), 257: (4, [height]), 258: (3, [8, 8, 8]), 259: (3, [6]), 262: (3, [6]),
            277: (3, [3]), 278: (4, [height]), 512: (3, [1]), 530: (3, [2, 2])}
    # the blobs as segments after the strip, their offsets in the tags
    out = tiff_file(tags, [entropy] + blobs)
    ifd_at = struct.unpack("<L", out[4:8])[0]
    n = struct.unpack("<H", out[ifd_at:ifd_at + 2])[0]
    at_of, count_of = None, None
    for i in range(n):
        at = ifd_at + 2 + 12 * i
        tag, typ, count = struct.unpack("<HHL", out[at:at + 8])
        if tag == 273:
            at_of = struct.unpack("<L", out[at + 8:at + 12])[0]
        if tag == 279:
            count_of = struct.unpack("<L", out[at + 8:at + 12])[0]
    offsets = list(struct.unpack(f"<{10}L", out[at_of:at_of + 40]))
    counts = list(struct.unpack(f"<{10}L", out[count_of:count_of + 40]))
    tags.update({273: (4, [offsets[0]]), 279: (4, [counts[0]]), 519: (4, offsets[1:4]), 520: (4, offsets[4:7]),
                 521: (4, offsets[7:10])})
    # rewrite with the same layout: the segments' offsets do not move
    body = out[8:offsets[-1] + counts[-1] + (counts[-1] % 2)]
    return _with_body(tags, body)


def _with_body(tags: dict, body: bytes) -> bytes:
    """A classic II TIFF: ``body`` after the header, then one IFD of
    ``tags`` and its values."""
    ifd_at = 8 + len(body) + len(body) % 2
    entries, extra = bytearray(), bytearray()
    n = len(tags)
    extra_at = ifd_at + 2 + 12 * n + 4
    for tag in sorted(tags):
        typ, values = tags[tag]
        raw = struct.pack("<" + _FMT[typ] * len(values), *values)
        value = raw + bytes(4 - len(raw)) if len(raw) <= 4 else struct.pack("<L", extra_at + len(extra))
        if len(raw) > 4:
            extra += raw + b"\0" * (len(raw) % 2)
        entries += struct.pack("<HHL", tag, typ, len(values)) + value
    return (b"II*\0" + struct.pack("<L", ifd_at) + body + b"\0" * (len(body) % 2) + struct.pack("<H", n) + entries
            + b"\0\0\0\0" + extra)


def Image_cmyk(pixels: np.ndarray):
    from PIL import Image

    return Image.fromarray(pixels, "CMYK")


def zstd_raw_blocks(raw: bytes) -> bytes:
    """A zstd frame of raw blocks (at most 128 KiB each), which every
    decoder reads, written without a zstd library."""
    out = bytearray(b"\x28\xb5\x2f\xfd") + bytes([0xA0]) + struct.pack("<L", len(raw))
    for i in range(0, max(len(raw), 1), 1 << 17):
        chunk = raw[i:i + (1 << 17)]
        out += struct.pack("<L", (len(chunk) << 3) | int(i + (1 << 17) >= len(raw)))[:3] + chunk
    return bytes(out)


COMPRESSION_NAMES = {5: "lzw", 8: "deflate", 32773: "packbits", 32946: "zip", 34925: "lzma", 50000: "zstd"}


def apng_fixtures(rng) -> dict:
    """APNGs (PIL reads their default image): the default image the first
    frame, and one outside the animation (no fcTL before IDAT), RGBA."""
    frames = [rng.integers(0, 256, (13, 17, 4)).astype(np.uint8) for _ in range(3)]
    for f in frames:
        f[..., 3] = np.where(f[..., 3] < 80, 0, f[..., 3])
    default = rng.integers(0, 256, (13, 17, 4)).astype(np.uint8)
    return {"apng_default_in_animation.png": apng_file(frames),
            "apng_default_not_in_animation.png": apng_file(frames, default_in_animation=False, default=default)}


def _cut_segment(rgb: np.ndarray, compression: int) -> bytes:
    """A one-strip TIFF whose coded strip holds a third of its bytes (the
    byte count says so): the decoder runs out before the last row."""
    h, w, _ = rgb.shape
    raw = rgb.astype(np.uint8).tobytes()
    coded = _compress(raw[:len(raw) // 3], compression)
    if compression in (8, 34925, 50000):
        coded = coded[:-4]
    tags = {256: (4, [w]), 257: (4, [h]), 258: (3, [8, 8, 8]), 259: (3, [compression]), 262: (3, [2]),
            277: (3, [3]), 278: (4, [h]), 284: (3, [1])}
    return tiff_file(tags, [coded])


def pil_digest(data: bytes) -> dict:
    """PIL's mode, and the sha256 and shape of ``convert("RGB")`` and, for
    an RGBA image, of the data loaders' white composite; or PIL's
    refusal."""
    import warnings

    from PIL import Image

    try:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            im = Image.open(io.BytesIO(data))
            rgb = np.asarray(im.convert("RGB"))
    except Exception as exc:  # noqa: BLE001 - the refusal is the digest
        return {"refused": type(exc).__name__, "bytes": len(data)}
    out = {"mode": im.mode, "shape": list(rgb.shape), "sha256": hashlib.sha256(rgb.tobytes()).hexdigest(),
           "bytes": len(data)}
    if im.mode == "RGBA":
        bg = Image.new("RGBA", im.size, (255, 255, 255, 255))
        comp = np.asarray(Image.alpha_composite(bg, im).convert("RGB"))
        out["composite_sha256"] = hashlib.sha256(comp.tobytes()).hexdigest()
    return out


def main(out_dir: str = HERE) -> int:
    rng = np.random.default_rng(20)
    files = {}
    files.update(gif_fixtures(rng))
    files.update(bmp_fixtures(rng))
    files.update(tiff_fixtures(rng))
    files.update(codec_fixtures(np.random.default_rng(21)))
    apngs = apng_fixtures(np.random.default_rng(22))
    digests = {}
    for name, data in sorted(files.items()):
        with open(os.path.join(out_dir, name), "wb") as fh:
            fh.write(data)
        digests[name] = pil_digest(data)
    with open(os.path.join(out_dir, DIGESTS), "w") as fh:
        json.dump(digests, fh, indent=1, sort_keys=True)
        fh.write("\n")
    for name, data in apngs.items():
        with open(os.path.join(out_dir, name), "wb") as fh:
            fh.write(data)
    zstd = zstd_frame_tiff()
    codecs = {"apng": {name: pil_digest(data) for name, data in sorted(apngs.items())},
              "frames": frame_digests(out_dir, zstd)}
    with open(os.path.join(out_dir, ZSTD_FRAME), "wb") as fh:
        fh.write(zstd)
    with open(os.path.join(out_dir, CODEC_DIGESTS), "w") as fh:
        json.dump(codecs, fh, indent=1, sort_keys=True)
        fh.write("\n")
    return 0


def zstd_frame_tiff() -> bytes:
    """CO3D's frame as 9d's zstd TIFF (predictor 2, strips of 64 rows) with
    compressed blocks (Huffman literals, FSE sequences) by the
    ``zstandard`` module, which the card's host lacks: it reads this
    committed file."""
    import zstandard  # noqa: F401 - the blocks must be compressed ones
    from PIL import Image

    frame = np.asarray(Image.open(os.path.join(JPEG_DIR, "frame_a.jpg")).convert("RGB"))
    return tiff_image(frame, photometric=2, bits=8, compression=50000, predictor=2, rows_per_strip=64)


def frame_digests(out_dir: str, zstd: bytes) -> dict:
    """PIL's digest of each of phase 9d's ``frame_codec_forms`` (from CO3D's
    frame ``frame_a.jpg`` and the lossless WebP render as PIL decodes
    them) and of its zstd source ``zstd``, read from bytes; of the
    fault-13 TIFF also PIL's read of it by path (``path_sha256``)."""
    import tempfile

    from PIL import Image

    frame = np.asarray(Image.open(os.path.join(JPEG_DIR, "frame_a.jpg")).convert("RGB"))
    render = np.asarray(Image.open(os.path.join(out_dir, "webp_render_lossless.webp")).convert("RGBA"))
    out = {ZSTD_FORM: pil_digest(zstd)}
    for form, data in frame_codec_forms(frame, render).items():
        out[form] = pil_digest(data)
        if form.startswith("fault-13"):
            with tempfile.TemporaryDirectory() as tmp:
                path = os.path.join(tmp, "fault13.tif")
                with open(path, "wb") as fh:
                    fh.write(data)
                out[form]["path_sha256"] = hashlib.sha256(np.asarray(Image.open(path).convert("RGB")).tobytes()
                                                          ).hexdigest()
    return out


if __name__ == "__main__":
    sys.exit(main(*sys.argv[1:]))
