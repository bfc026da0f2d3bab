"""The libtiff codecs and colour paths PIL 12.1.0 reaches through libtiff
4.7.1, on the port's own decoders (host: the standard library, numpy and
``csrc/jpeg_decode.cpp``).

* JPEG (compression 7) as ``tif_jpeg.c`` hands each strip or tile to
  libjpeg: the ``JPEGTables`` stream's tables read first (only DQT and DHT
  outlive the strip's SOI), the strip's stream decoded whole, YCbCr
  converted to RGB where PIL asks for ``JPEGCOLORMODE_RGB`` (libjpeg's
  fixed-point tables and fancy upsampling), every other photometric left
  unconverted (``JCS_UNKNOWN``); the strip's size held to libtiff's
  checks; the subsampling libtiff expects taken from ``YCbCrSubsampling``,
  or from the first strip's frame where the tag is absent
  (``JPEGFixupTagsSubsampling``).
* old-style JPEG (compression 6) in its ``JPEGInterchangeFormat`` form,
  one strip, as ``tif_ojpeg.c`` reads it (``ojpeg_units``): the stream's
  markers checked as ``OJPEGReadHeaderInfoSec`` checks them, libjpeg's raw
  output (each component's IDCT plane, no upsampling) packed into YCbCr
  data units as ``OJPEGDecodeRaw`` packs them;
* YCbCr through ``tif_getimage.c``'s RGBA path (``ycbcr_to_rgb``):
  ``TIFFYCbCrToRGBInit``'s integer tables from ``YCbCrCoefficients`` and
  ``ReferenceBlackWhite``, each subsampling unit's chroma replicated over
  its luma (``putcontig8bitYCbCr{11,12,21,22,41,42,44}tile``).
"""
from __future__ import annotations

import ctypes
import struct
from typing import Optional, Tuple

import numpy as np

def not_read(form: str) -> ValueError:
    """The refusal of a TIFF form PIL reads and the port does not."""
    return ValueError(f"TIFF: {form} is not read by this port (PIL reads it through libtiff; ROADMAP item 13c)")


# Decoder::output's spaces (csrc/jpeg_decode.cpp)
YCC, NONE, PLANES = 1, 2, 3
_SOF = (0xC0, 0xC1, 0xC2, 0xC9, 0xCA)


def _lib() -> ctypes.CDLL:
    from ..kernels._build import load_host
    from .images import _bind_jpeg

    return load_host("jpeg_decode", _bind_jpeg)


def jpeg_frame(stream: bytes) -> Tuple[int, int, list]:
    """(width, height, [(h, v, blocks across, blocks down) a component]) of
    a JPEG stream libtiff hands libjpeg whole."""
    info = np.zeros(3 + 16, np.int32)
    err = ctypes.create_string_buffer(256)
    if _lib().mvd_jpeg_frame(stream, len(stream), info.ctypes.data, err, len(err)):
        raise ValueError(f"JPEG: {err.value.decode()}")
    nc = int(info[2])
    return int(info[0]), int(info[1]), [tuple(int(v) for v in info[3 + 4 * k:7 + 4 * k]) for k in range(nc)]


def jpeg_decode(stream: bytes, space: int, shape: tuple) -> np.ndarray:
    """The stream decoded by ``space`` (YCC: height x width x 3 RGB; NONE:
    height x width x components; PLANES: the components' IDCT planes one
    after another, ``shape`` their total) as uint8 of ``shape``."""
    out = np.empty(shape, np.uint8)
    err = ctypes.create_string_buffer(256)
    if _lib().mvd_jpeg_decode_whole(stream, len(stream), space, out.ctypes.data, out.nbytes, err, len(err)):
        raise ValueError(err.value.decode())
    return out


def _segments(stream: bytes):
    """(marker, body start, body end) of a JPEG stream's marker segments
    from SOI on, up to (not into) SOS or EOI, bytes between segments
    skipped as libjpeg's ``next_marker`` skips them; raises on a cut
    one."""
    if stream[:2] != b"\xff\xd8":
        raise ValueError("JPEG: no SOI")
    pos = 2
    while pos + 2 <= len(stream):
        if stream[pos] != 0xFF:
            pos += 1
            continue
        marker = stream[pos + 1]
        if marker == 0xFF:
            pos += 1
            continue
        if marker in (0xD9, 0xDA):
            yield marker, pos + 2, pos + 2
            return
        length = struct.unpack(">H", stream[pos + 2:pos + 4])[0] if pos + 4 <= len(stream) else 0
        if length < 2 or pos + 2 + length > len(stream):
            raise ValueError("JPEG: a marker segment is cut")
        yield marker, pos + 4, pos + 2 + length
        pos += 2 + length
    raise ValueError("JPEG: the stream ends before SOS or EOI")


def tables_body(tables: bytes) -> bytes:
    """The DQT and DHT segments of a ``JPEGTables`` stream, which libjpeg
    keeps for the strips' streams (their SOI resets DRI, DAC and the JFIF
    and Adobe markers); raises as ``JPEGSetupDecode`` refuses a stream
    that is not tables only ("Bogus JPEGTables field")."""
    body = bytearray()
    try:
        for marker, start, end in _segments(tables):
            if marker == 0xD9:
                return bytes(body)
            if marker == 0xDA or 0xC0 <= marker <= 0xCF and marker not in (0xC4, 0xC8, 0xCC):
                break
            if marker in (0xC4, 0xDB):
                body += tables[start - 4:end]
    except ValueError as exc:
        if "ends before" in str(exc):
            return bytes(body)  # libtiff's source inserts an EOI where the stream ends
        raise not_read(f"a JPEGTables stream libjpeg reads on past the end of ({exc})") from None
    raise ValueError("TIFF: libtiff refuses the JPEGTables stream (Bogus JPEGTables field)")


def sof_sampling(stream: bytes) -> Optional[Tuple[int, int]]:
    """``JPEGFixupTagsSubsampling``: the first component's sampling factors
    in the first strip's frame header, where they are 1, 2 or 4 and the
    other components' are 1; else None (libtiff keeps its default)."""
    try:
        for marker, start, end in _segments(stream):
            if marker in _SOF:
                body = stream[start:end]
                nc = body[5] if len(body) > 5 else 0
                if nc != 3 or len(body) < 6 + 3 * nc:
                    return None
                h, v = body[7] >> 4, body[7] & 15
                if h not in (1, 2, 4) or v not in (1, 2, 4) or any(body[7 + 3 * k] != 0x11 for k in (1, 2)):
                    return None
                return h, v
            if marker in (0xD9, 0xDA) or 0xC0 <= marker <= 0xCF and marker not in (0xC4, 0xCC):
                return None
    except (ValueError, IndexError):
        return None
    return None


def jpeg_segment(stream: bytes, tables: Optional[bytes], space: int, components: int, sampling: Tuple[int, int],
                 seg_w: int, seg_h: int, rows: int, row_size: int, last_strip: bool, where: str) -> bytes:
    """The first ``rows`` rows (``row_size`` bytes each) libtiff's
    ``JPEGPreDecode`` and ``JPEGDecode`` give from one strip or tile's JPEG
    stream: ``components`` and ``sampling`` (the first component's; the
    others 1 x 1) held as libtiff holds them, a frame wider or taller than
    the segment (``seg_w`` x ``seg_h``) refused but for a last strip of the
    segment's width, a smaller one refused naming ROADMAP item 13c (libtiff
    leaves the rest of PIL's buffer as it was)."""
    if tables is not None and stream[:2] == b"\xff\xd8":
        stream = stream[:2] + tables + stream[2:]
    w, h, comps = jpeg_frame(stream)
    if len(comps) != components:
        raise ValueError(f"TIFF: {where}: a JPEG of {len(comps)} components for {components} samples (libtiff: "
                         "Improper JPEG component count)")
    if comps[0][:2] != sampling or any(c[:2] != (1, 1) for c in comps[1:]):
        raise ValueError(f"TIFF: {where}: JPEG sampling factors {[c[:2] for c in comps]}, libtiff expects "
                         f"{sampling} then 1 x 1 (Improper JPEG sampling factors)")
    if w > seg_w or h > seg_h:
        if not (w == seg_w and last_strip):
            raise ValueError(f"TIFF: {where}: a {w}x{h} JPEG in a {seg_w}x{seg_h} segment (libtiff: JPEG "
                             "strip/tile size exceeds expected dimensions)")
    elif w < seg_w or h < seg_h:
        raise not_read(f"a {w}x{h} JPEG in a {seg_w}x{seg_h} strip or tile")
    depth = 3 if space == YCC else len(comps)
    if w * depth != row_size:
        raise not_read(f"a JPEG row of {w * depth} bytes in libtiff's {row_size}-byte rows")
    try:
        pixels = jpeg_decode(stream, space, (h, w, depth))
    except ValueError as exc:
        raise ValueError(f"TIFF: {where}: {exc} (libjpeg goes on past some such damage with a warning, and PIL "
                         "then reads the image; the port refuses it: ROADMAP item 13c)") from None
    return pixels[:rows].tobytes()


# tif_getimage.c's YCbCr data units: (h, v) subsampling -> its put routine
PUT_CASES = {(4, 4), (4, 2), (4, 1), (2, 2), (2, 1), (1, 2), (1, 1)}
DEFAULT_LUMA = (0.299, 0.587, 0.114)
DEFAULT_REF_BLACK_WHITE = (0.0, 255.0, 128.0, 255.0, 128.0, 255.0)


def ycbcr_tables(luma, ref_bw) -> tuple:
    """``TIFFYCbCrToRGBInit``'s tables (Y, Cr->R, Cb->B, Cr->G, Cb->G),
    indexed by the 8-bit sample, from the float ``YCbCrCoefficients`` and
    ``ReferenceBlackWhite``: float arithmetic as libtiff's C does it, the
    fixed-point factors at 16 bits; raises as ``initYCbCrConversion``
    refuses a NaN or zero green coefficient or a reference out of range."""
    f32 = np.float32
    luma = [f32(v) for v in luma]
    ref = [f32(v) for v in ref_bw]
    if any(np.isnan(v) for v in luma) or luma[1] == 0:
        raise ValueError("TIFF: libtiff refuses the YCbCrCoefficients (Invalid values for YCbCrCoefficients tag)")
    if not all(f32(-0x7FFFFFFF + 128) < v < f32(0x7FFFFFFF) for v in ref):
        raise ValueError("TIFF: libtiff refuses the ReferenceBlackWhite (Invalid values for ReferenceBlackWhite tag)")

    def fix(x: np.float32) -> int:  # FIX(CLAMP(x, 0, 2)): float * 65536, + 0.5 in double, truncated
        x = min(max(x, f32(0)), f32(2))
        return int(float(f32(x * f32(65536))) + 0.5)

    lr, lg, lb = luma
    f1 = f32(f32(2) - f32(f32(2) * lr))
    f3 = f32(f32(2) - f32(f32(2) * lb))
    d1, d2 = fix(f1), -fix(f32(f32(lr * f1) / lg))
    d3, d4 = fix(f3), -fix(f32(f32(lb * f3) / lg))

    def code2v(c: np.ndarray, rb: np.float32, rw: np.float32, cr: int) -> np.ndarray:
        den = f32(rw - rb)
        den = den if den != 0 else f32(1)
        v = f32(1) * (c - int(np.trunc(rb))).astype(f32) * f32(cr) / den
        v = np.where(~(v >= f32(-4096)), f32(-4096), np.where(v > f32(4096), f32(4096), v))
        return np.trunc(v).astype(np.int64)

    x = np.arange(-128, 128, dtype=np.int64)
    cr = code2v(x, f32(ref[4] - f32(128)), f32(ref[5] - f32(128)), 127)
    cb = code2v(x, f32(ref[2] - f32(128)), f32(ref[3] - f32(128)), 127)
    y = code2v(x + 128, ref[0], ref[1], 255)
    i32 = np.int64
    return (y, (d1 * cr + (1 << 15)) >> 16, (d3 * cb + (1 << 15)) >> 16, (d2 * cr).astype(i32),
            (d4 * cb + (1 << 15)).astype(i32))


def ycbcr_to_rgb(units: np.ndarray, width: int, rows: int, sub: Tuple[int, int], tables: tuple,
                 row_bytes: Optional[int] = None) -> np.ndarray:
    """A segment's YCbCr data units (its decoded bytes: rows of units, each
    h x v luma samples then Cb and Cr, ``row_bytes`` apart, by default a
    row of whole units) -> (rows, width, 3) uint8 RGB as
    ``putcontig8bitYCbCr*tile`` and ``TIFFYCbCrtoRGB`` give it: each
    pixel's luma with its unit's chroma, clamped to 0-255."""
    sh, sv = sub
    unit = sh * sv + 2
    row_bytes = -(-width // sh) * unit if row_bytes is None else row_bytes
    yy, xx = np.mgrid[:rows, :width]
    at = (yy // sv) * row_bytes + (xx // sh) * unit
    luma = units[at + (yy % sv) * sh + xx % sh]
    cb, cr = units[at + sh * sv], units[at + sh * sv + 1]
    y_tab, cr_r, cb_b, cr_g, cb_g = tables
    yv = y_tab[luma]
    rgb = np.stack([yv + cr_r[cr], yv + ((cb_g[cb] + cr_g[cr]) >> 16), yv + cb_b[cb]], -1)
    return np.clip(rgb, 0, 255).astype(np.uint8)


def unit_row_bytes(tile_w: int, cols: int, sub: Tuple[int, int]) -> int:
    """The bytes a put routine moves on per row of data units in a tile of
    ``tile_w`` whose first ``cols`` columns it draws: the units it draws,
    then the right ``fromskew`` pixels' units skipped at the size the
    routine computes for them (``putcontig8bitYCbCr44tile`` counts 10
    bytes a 4 x 4 unit, not 18)."""
    sh, sv = sub
    unit = sh * sv + 2
    skip = 10 if sub == (4, 4) else unit
    return -(-cols // sh) * unit + ((tile_w - cols) // sh) * skip


def rational(ifd_entry, endian: str, default) -> tuple:
    """A RATIONAL (or SRATIONAL) tag as libtiff reads it into floats
    (numerator over denominator in float, 0 where the denominator is 0)."""
    if ifd_entry is None or ifd_entry[2] is None or ifd_entry[0] not in (5, 10):
        return default
    typ, n, raw = ifd_entry
    vals = struct.unpack(endian + ("L" if typ == 5 else "l") * (2 * n), raw)
    f32 = np.float32
    return tuple(f32(0) if b == 0 else f32(f32(a) / f32(b)) for a, b in zip(vals[::2], vals[1::2]))


def ojpeg_units(data: bytes, jif: int, jif_len: int, strip: bytes, width: int, height: int) -> tuple:
    """An old-style JPEG strip as ``tif_ojpeg.c`` gives it to the RGBA path:
    the stream at ``jif`` (``JPEGInterchangeFormat``, its length clipped to
    the file as libtiff clips it) read up to its SOS as
    ``OJPEGReadHeaderInfoSec`` reads it (SOI, APPn and COM skipped; DRI,
    DQT, DHT; a baseline or extended frame of three 8-bit components whose
    size covers the image; one scan of the three), its entropy data
    followed by the strip's bytes, decoded by libjpeg into raw planes and
    packed into ``height`` rows of YCbCr data units (the image is one
    strip) as ``OJPEGDecodeRaw`` packs them: (units, (h, v) subsampling of
    the frame)."""
    if jif >= len(data):
        raise not_read("old-style JPEG whose JPEGInterchangeFormat lies past the file (its tables in tags 519-521)")
    if not jif_len or jif + jif_len > len(data):
        jif_len = len(data) - jif
    stream = data[jif:jif + jif_len]
    sof, pos, scan = None, 0, False
    # OJPEGReadHeaderInfoSec: a marker where a byte other than 0xFF stands
    # ends the header (no skipping, unlike libjpeg)
    while pos < len(stream) and stream[pos] == 0xFF:
        while pos < len(stream) and stream[pos] == 0xFF:
            pos += 1
        if pos >= len(stream):
            break
        marker, pos = stream[pos], pos + 1
        if marker == 0xD8:
            continue
        if marker == 0xC3:
            raise not_read("lossless old-style JPEG")
        if not (0xE0 <= marker <= 0xEF or marker in (0xFE, 0xDD, 0xDB, 0xC4, 0xC0, 0xC1, 0xDA)):
            raise ValueError(f"TIFF: libtiff's old-style JPEG reader refuses marker 0xFF{marker:02X} (Unknown "
                             "marker type in JPEG data)")
        if pos + 2 > len(stream):
            break
        length = struct.unpack(">H", stream[pos:pos + 2])[0]
        if length < 2 or pos + length > len(stream):
            raise ValueError("TIFF: old-style JPEG: a marker segment is cut (libtiff: Corrupt JPEG data)")
        if marker in (0xC0, 0xC1):
            sof = stream[pos + 2:pos + length]
        pos += length
        if marker == 0xDA:
            scan = True
            break
    if sof is None or not scan:
        raise ValueError("TIFF: old-style JPEG without a frame and a scan header before its data (libtiff: Missing "
                         "JPEG tables)")
    if sof is None or len(sof) < 15 or sof[0] != 8 or sof[5] != 3:
        raise ValueError("TIFF: old-style JPEG without a frame of three 8-bit components before its scan (libtiff "
                         "refuses it)")
    sof_h, sof_w = struct.unpack(">HH", sof[1:5])
    if sof_h < height or sof_w != width:
        raise ValueError(f"TIFF: an old-style JPEG frame of {sof_w}x{sof_h} for a {width}x{height} image (libtiff: "
                         "JPEG compressed data indicates unexpected width or height)")
    sub = (sof[7] >> 4, sof[7] & 15)
    if sub[0] not in (1, 2, 4) or sub[1] not in (1, 2, 4) or sof[10] != 0x11 or sof[13] != 0x11:
        raise not_read(f"old-style JPEG of sampling factors {[hex(b) for b in sof[7:15:3]]}, which libtiff "
                       "desubsamples inside libjpeg")
    whole = stream + strip + b"\xff\xd9"
    w, h, comps = jpeg_frame(whole)
    sizes = [c[2] * 8 * c[3] * 8 for c in comps]
    try:
        flat = jpeg_decode(whole, PLANES, (sum(sizes),))
    except ValueError as exc:
        raise not_read(f"an old-style JPEG strip libjpeg may read on past with a warning ({exc})") from None
    planes, at = [], 0
    for (_, _, bw, bh), size in zip(comps, sizes):
        planes.append(flat[at:at + size].reshape(bh * 8, bw * 8))
        at += size
    sh, sv = sub
    across, down = -(-width // sh), -(-height // sv)
    luma = planes[0][:down * sv, :across * sh].reshape(down, sv, across, sh).transpose(0, 2, 1, 3)
    units = np.concatenate([luma.reshape(down, across, sh * sv), planes[1][:down, :across, None],
                            planes[2][:down, :across, None]], -1)
    return units.reshape(-1), sub
