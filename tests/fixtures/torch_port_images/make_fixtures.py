"""Write the image fixtures of ``tests/test_torch_port_images.py`` and
``chip_smoke.py`` phase 9 beyond the sequential JPEGs beside them
(``../torch_port_jpeg``): progressive, CMYK and YCCK JPEGs, PNGs at every
(colour type, bit depth) pair PNG allows, interlaced or not, and
``pil_sha256.json``: for each file PIL's mode and the sha256 and shape of
``Image.open(...).convert("RGB")``; for a file PIL opens as RGBA also those
of the data loaders' white composite (``Image.alpha_composite`` over
opaque white, then ``convert("RGB")``); for a file the port refuses, the
word its error names beside PIL's digest.

    python tests/fixtures/torch_port_images/make_fixtures.py

PIL's encoder writes what it can: progressive JPEGs (4:4:4, 4:2:0, gray,
odd sizes, ``optimize=True``, restart markers), CMYK (baseline and
progressive) and PNGs of modes 1, L, I;16, LA, RGB, RGBA and P at 1, 2, 4
and 8 bits. The encoders below write the rest: ``encode_progressive``
(any scan script: DC scans interleaved or of one component, spectral
selection, successive approximation with libjpeg's jcphuff.c end-of-band
runs and correction bits, a restart interval, Huffman tables redefined
before every scan, an Adobe marker for YCCK) and ``encode_png`` (every
depth and colour type, Adam7, a filter type per row). The block-smoothing
files leave some of the first nine AC coefficients unrefined, so libjpeg
block-smooths them and the port refuses them. Every file comes from a
fixed seed, so the script writes the same bytes on every run with the same
PIL. ``encode_png`` imports no PIL: ``chip_smoke.py`` loads this file to
write 16-bit and interlaced PNGs on a host without PIL.
"""

from __future__ import annotations

import hashlib
import importlib.util
import io
import json
import math
import os
import struct
import sys
import zlib

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
JPEG_DIR = os.path.join(os.path.dirname(HERE), "torch_port_jpeg")
ADAM7 = ((0, 8, 0, 8), (4, 8, 0, 8), (0, 4, 4, 8), (2, 4, 0, 4), (0, 2, 2, 4), (1, 2, 0, 2),
         (0, 1, 1, 2))
# (colour type, bit depth) pairs PNG allows
PNG_FORMATS = [(0, 1), (0, 2), (0, 4), (0, 8), (0, 16), (2, 8), (2, 16), (3, 1), (3, 2), (3, 4),
               (3, 8), (4, 8), (4, 16), (6, 8), (6, 16)]
PNG_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}
SMOOTHING = "block smoothing"  # the word the port's refusal names


def _jpeg_fixtures():
    """The sequential-JPEG fixture script beside this one (its image makers,
    bit writer and segments; PIL only where it writes files)."""
    spec = importlib.util.spec_from_file_location("torch_port_jpeg_fixtures",
                                                  os.path.join(JPEG_DIR, "make_fixtures.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


seq = _jpeg_fixtures()  # the sequential-JPEG fixture script
_Bits, _segment, ZIGZAG = seq._Bits, seq._segment, seq._ZIGZAG


# --------------------------------------------------------------- JPEG


def _code(syms, rng):
    """Fixed-length codes over ``syms`` in a shuffled order (never all
    ones): symbol -> (code, length), and the DHT body after its class byte."""
    syms = [int(s) for s in rng.permutation(syms)]
    length = max(1, math.ceil(math.log2(len(syms) + 1)))
    bits = [0] * 16
    bits[length - 1] = len(syms)
    return {s: (i, length) for i, s in enumerate(syms)}, bytes(bits) + bytes(syms)


DC_SYMS = list(range(12))
AC_SYMS = [r << 4 for r in range(15)] + [0xF0] + [(r << 4) | s for r in range(16) for s in range(1, 11)]


def quantized_blocks(planes, sampling, q) -> list:
    """Per component, (blocks high, blocks wide, 64) quantized coefficients
    in zigzag order over the MCU grid (several components) or the
    component's own blocks (one); ``q`` per component, natural order, a 0
    quantizes to 0."""
    hmax = max(h for h, _ in sampling)
    vmax = max(v for _, v in sampling)
    H, W = planes[0].shape
    mcux, mcuy = -(-W // (8 * hmax)), -(-H // (8 * vmax))
    n = np.arange(8)
    basis = np.cos((2 * n[:, None] + 1) * n[None, :] * np.pi / 16)
    cu = np.where(n == 0, 1 / math.sqrt(2), 1.0)
    out = []
    for ci, p in enumerate(planes):
        h, v = sampling[ci]
        p = p.astype(np.float64) - 128
        bw = mcux * h if len(planes) > 1 else -(-p.shape[1] // 8)
        bh = mcuy * v if len(planes) > 1 else -(-p.shape[0] // 8)
        padded = np.pad(p, ((0, bh * 8 - p.shape[0]), (0, bw * 8 - p.shape[1])), mode="edge")
        blk = padded.reshape(bh, 8, bw, 8).transpose(0, 2, 1, 3)
        coef = (np.einsum("abyx,yi,xj->abij", blk, basis, basis) * (cu[:, None] * cu[None, :]) / 4)
        qc = np.asarray(q[ci], np.float64)
        natural = np.where(qc > 0, np.round(coef.reshape(bh, bw, 64) / np.where(qc > 0, qc, 1)), 0)
        out.append(natural.astype(np.int64)[..., ZIGZAG])
    return out


def encode_progressive(planes, sampling, scans, q=None, ids=None, restart=0, adobe=None, jfif=True,
                       seed=0, ac_limit=None) -> bytes:
    """A progressive (SOF2) JPEG of ``planes`` (uint8, each at its sampled
    size) with (h, v) ``sampling`` per component and the scan script
    ``scans``: (component indices, Ss, Se, Ah, Al) each, encoded as
    libjpeg's jcphuff.c encodes them. ``q``: a natural-order table per
    component (two DQT tables: the first component's and the rest's);
    ``restart``: MCUs per restart interval (0: none); ``adobe``: the APP14
    transform flag (None: no APP14). Every scan is preceded by its own DHT
    (fixed-length codes in a seeded order, DC and AC tables 0 and 1 in
    turns). ``ac_limit`` clips every AC coefficient to +-it."""
    nc = len(planes)
    ids = ids or list(range(1, nc + 1))
    q = q or [np.full(64, 3)] + [np.full(64, 5)] * (nc - 1)
    tq = [0] + [1] * (nc - 1)
    coefs = quantized_blocks(planes, sampling, q)
    if ac_limit is not None:
        for c in coefs:
            c[..., 1:] = np.clip(c[..., 1:], -ac_limit, ac_limit)
    hmax = max(h for h, _ in sampling)
    vmax = max(v for _, v in sampling)
    H, W = planes[0].shape
    mcux, mcuy = -(-W // (8 * hmax)), -(-H // (8 * vmax))
    rng = np.random.default_rng(seed)
    out = bytearray(b"\xff\xd8")
    if jfif:
        out += _segment(0xE0, b"JFIF\x00\x01\x01\x00\x00\x01\x00\x01\x00\x00")
    if adobe is not None:
        out += _segment(0xEE, b"Adobe" + struct.pack(">HHHB", 100, 0, 0, adobe))
    for t in sorted(set(tq)):
        table = q[tq.index(t)]
        out += _segment(0xDB, bytes([t]) + bytes(int(x) for x in np.asarray(table)[ZIGZAG]))
    sof = struct.pack(">BHHB", 8, H, W, nc)
    for ci, (h, v) in enumerate(sampling):
        sof += bytes([ids[ci], (h << 4) | v, tq[ci]])
    out += _segment(0xC2, sof)
    if restart:
        out += _segment(0xDD, struct.pack(">H", restart))

    def units(comps):
        if len(comps) > 1:
            for my in range(mcuy):
                for mx in range(mcux):
                    yield [(ci, my * sampling[ci][1] + vv, mx * sampling[ci][0] + hh)
                           for ci in comps for vv in range(sampling[ci][1]) for hh in range(sampling[ci][0])]
        else:
            ci = comps[0]
            for by in range(-(-planes[ci].shape[0] // 8)):
                for bx in range(-(-planes[ci].shape[1] // 8)):
                    yield [(ci, by, bx)]

    for si, (comps, Ss, Se, Ah, Al) in enumerate(scans):
        th = si % 2
        dc_code, dc_body = _code(DC_SYMS, rng)
        ac_code, ac_body = _code(AC_SYMS, rng)
        out += _segment(0xC4, bytes([th]) + dc_body + bytes([0x10 | th]) + ac_body)
        sos = bytes([len(comps)]) + b"".join(bytes([ids[ci], (th << 4) | th]) for ci in comps)
        out += _segment(0xDA, sos + bytes([Ss, Se, (Ah << 4) | Al]))
        bits = _Bits()
        state = dict(eobrun=0, be=[])
        pred = {ci: 0 for ci in comps}

        def emit_eobrun():
            if state["eobrun"] > 0:
                nbits = state["eobrun"].bit_length() - 1
                bits.put(*ac_code[nbits << 4])
                if nbits:
                    bits.put(state["eobrun"], nbits)
                state["eobrun"] = 0
                for b in state["be"]:
                    bits.put(b, 1)
                state["be"] = []

        for m, unit in enumerate(units(comps)):
            if restart and m and m % restart == 0:
                emit_eobrun()
                bits.flush()
                bits.out += bytes([0xFF, 0xD0 + ((m // restart - 1) & 7)])
                pred = {ci: 0 for ci in comps}
                state["eobrun"], state["be"] = 0, []
            for ci, by, bx in unit:
                blk = coefs[ci][by, bx]
                if Ss == 0 and Ah == 0:  # DC first
                    v = int(blk[0]) >> Al
                    diff, pred[ci] = v - pred[ci], v
                    s = abs(diff).bit_length()
                    bits.put(*dc_code[s])
                    if s:
                        bits.put(diff if diff >= 0 else diff - 1, s)
                elif Ss == 0:  # DC refine
                    bits.put((int(blk[0]) >> Al) & 1, 1)
                elif Ah == 0:  # AC first
                    r = 0
                    for k in range(Ss, Se + 1):
                        temp = abs(int(blk[k])) >> Al
                        if temp == 0:
                            r += 1
                            continue
                        temp2 = temp if blk[k] > 0 else ~temp
                        emit_eobrun()
                        while r > 15:
                            bits.put(*ac_code[0xF0])
                            r -= 16
                        nbits = temp.bit_length()
                        bits.put(*ac_code[(r << 4) + nbits])
                        bits.put(temp2, nbits)
                        r = 0
                    if r > 0:
                        state["eobrun"] += 1
                        if state["eobrun"] == 0x7FFF:
                            emit_eobrun()
                else:  # AC refine
                    absv = {k: abs(int(blk[k])) >> Al for k in range(Ss, Se + 1)}
                    eob = max([k for k, a in absv.items() if a == 1], default=0)
                    r, br = 0, []
                    for k in range(Ss, Se + 1):
                        temp = absv[k]
                        if temp == 0:
                            r += 1
                            continue
                        while r > 15 and k <= eob:
                            emit_eobrun()
                            bits.put(*ac_code[0xF0])
                            r -= 16
                            for b in br:
                                bits.put(b, 1)
                            br = []
                        if temp > 1:
                            br.append(temp & 1)
                            continue
                        emit_eobrun()
                        bits.put(*ac_code[(r << 4) + 1])
                        bits.put(0 if blk[k] < 0 else 1, 1)
                        for b in br:
                            bits.put(b, 1)
                        br, r = [], 0
                    if r > 0 or br:
                        state["eobrun"] += 1
                        state["be"] += br
                        if state["eobrun"] == 0x7FFF or len(state["be"]) > 1000 - 64 + 1:
                            emit_eobrun()
        emit_eobrun()
        bits.flush()
        out += bits.out
    out += b"\xff\xd9"
    return bytes(out)


def full_script(nc: int, dc_interleaved: bool = True):
    """libjpeg's jpeg_simple_progression-like script for nc components with
    successive approximation down to Al 0 on every coefficient."""
    comps = list(range(nc))
    dc = [(comps, 0, 0, 0, 1)] if dc_interleaved else [([c], 0, 0, 0, 1) for c in comps]
    s = dc + [([0], 1, 5, 0, 2)] + [([c], 1, 63, 0, 1) for c in comps[1:]] + [([0], 6, 63, 0, 2),
                                                                               ([0], 1, 63, 2, 1)]
    s += [(comps, 0, 0, 1, 0)] if dc_interleaved else [([c], 0, 0, 1, 0) for c in comps]
    s += [([c], 1, 63, 1, 0) for c in comps[1:]] + [([0], 1, 63, 1, 0)]
    return s


def _pil_jpeg(arr, mode=None, **options) -> bytes:
    from PIL import Image

    buf = io.BytesIO()
    im = Image.fromarray(arr) if mode is None else Image.frombytes(mode, arr.shape[1::-1], arr.tobytes())
    im.save(buf, "JPEG", **options)
    return buf.getvalue()


def _strip_app14(data: bytes) -> bytes:
    at = data.index(b"\xff\xee")
    n = struct.unpack(">H", data[at + 2:at + 4])[0]
    return data[:at] + data[at + 2 + n:]


def _ycck(cmyk: np.ndarray) -> list:
    """Adobe-convention CMYK samples (the inverted ones a file stores) as
    YCCK planes: the YCbCr of (255 - C, 255 - M, 255 - Y), K kept."""
    y, cb, cr = seq._ycc(255 - cmyk[..., :3])
    return [y, cb, cr, cmyk[..., 3]]


def jpeg_fixtures() -> dict:
    """name -> (bytes, the word of the port's refusal or None)."""
    a = seq.photo(37, 53, 3, seed=21)
    y, cb, cr = seq._ycc(a)
    g = seq.photo(29, 43, 1, seed=22)[..., 0]
    cmyk = seq.photo(27, 35, 4, seed=23)
    yk = _ycck(cmyk)
    s420 = [(2, 2), (1, 1), (1, 1)]
    p420 = [y, seq._down(cb, 2, 2), seq._down(cr, 2, 2)]
    q_zero = np.full(64, 4)
    q_zero[1] = 0  # zigzag 1: libjpeg skips smoothing on a zero quantizer there
    f = {
        "prog_444.jpg": _pil_jpeg(a, quality=90, subsampling=0, progressive=True),
        "prog_420.jpg": _pil_jpeg(a, quality=75, subsampling=2, progressive=True),
        "prog_420_opt.jpg": _pil_jpeg(seq.photo(45, 67, 3, seed=24), quality=85, subsampling=2,
                                      progressive=True, optimize=True),
        "prog_gray.jpg": _pil_jpeg(g, quality=80, progressive=True),
        "prog_odd_3x5.jpg": _pil_jpeg(seq.photo(5, 3, 3, seed=25), quality=90, progressive=True),
        "prog_1x1.jpg": _pil_jpeg(seq.photo(1, 1, 3, seed=26), quality=90, progressive=True),
        "prog_rst.jpg": _pil_jpeg(seq.photo(41, 59, 3, seed=27), quality=80, subsampling=2,
                                  progressive=True, restart_marker_blocks=2),
        "prog_rst_rows.jpg": _pil_jpeg(seq.photo(33, 70, 3, seed=28), quality=70, subsampling=1,
                                       progressive=True, restart_marker_rows=1),
        "prog_q100.jpg": _pil_jpeg(seq.photo(24, 24, 3, seed=29), quality=100, progressive=True),
        "cmyk_prog.jpg": _pil_jpeg(cmyk, "CMYK", quality=85, progressive=True),
        "cmyk_no_adobe.jpg": _strip_app14(_pil_jpeg(cmyk, "CMYK", quality=85)),
        # the encoders below: scan scripts PIL does not write
        "prog_dc_single.jpg": encode_progressive(p420, s420, full_script(3, dc_interleaved=False),
                                                 restart=3, seed=1),
        "prog_dc_single_444.jpg": encode_progressive([y, cb, cr], [(1, 1)] * 3, full_script(3, False), seed=2),
        "prog_gray_script.jpg": encode_progressive([g], [(1, 1)], [
            ([0], 0, 0, 0, 2), ([0], 1, 2, 0, 3), ([0], 3, 63, 0, 1), ([0], 1, 2, 3, 2), ([0], 0, 0, 2, 1),
            ([0], 1, 2, 2, 1), ([0], 0, 0, 1, 0), ([0], 1, 63, 1, 0)], restart=5, seed=3),
        "prog_spectral_1to9.jpg": encode_progressive([g], [(1, 1)], [([0], 0, 0, 0, 0), ([0], 1, 9, 0, 0)],
                                                     seed=4),
        # AC refined from Ah 1 with no AC first scan: libjpeg warns and reads
        # every coefficient as newly nonzero (so they are clipped to +-1)
        "prog_refine_unstarted.jpg": encode_progressive([g], [(1, 1)], [
            ([0], 0, 0, 0, 0), ([0], 1, 63, 1, 0)], ac_limit=1, seed=5),
        "prog_zero_quant.jpg": encode_progressive([g], [(1, 1)], [([0], 0, 0, 0, 0), ([0], 2, 63, 0, 0)],
                                                  q=[q_zero], seed=6),
        "ycck.jpg": encode_progressive(yk, [(1, 1)] * 4, [
            ([0, 1, 2, 3], 0, 0, 0, 0)] + [([c], 1, 63, 0, 0) for c in range(4)], adobe=2, jfif=False, seed=7),
        "ycck_22.jpg": encode_progressive([yk[0], seq._down(yk[1], 2, 2), seq._down(yk[2], 2, 2), yk[3]],
                                          [(2, 2), (1, 1), (1, 1), (2, 2)], full_script(4), adobe=2,
                                          jfif=False, restart=2, seed=8),
        "ycck_adobe1.jpg": encode_progressive(yk, [(1, 1)] * 4, full_script(4), adobe=1,
                                              jfif=False, seed=9),
        "cmyk_script.jpg": encode_progressive([255 - cmyk[..., k] for k in range(4)], [(1, 1)] * 4,
                                              full_script(4, dc_interleaved=False), adobe=0, jfif=False,
                                              seed=10),
        # the frame CO3D's size, progressive: phase 9's generation source
        "frame_a_prog.jpg": _pil_jpeg(seq.frame(800, 1067, seed=10), quality=85, subsampling=2,
                                      progressive=True),
        # libjpeg block-smooths these (coefficients 1-9 not all refined to 0)
        "smooth_dc_only.jpg": encode_progressive(p420, s420, [([0, 1, 2], 0, 0, 0, 0)], seed=11),
        "smooth_ac_al1.jpg": encode_progressive([g], [(1, 1)], [([0], 0, 0, 0, 0), ([0], 1, 63, 0, 1)],
                                                seed=12),
        "smooth_ac6_unsent.jpg": encode_progressive([g], [(1, 1)], [([0], 0, 0, 0, 0), ([0], 1, 5, 0, 0)],
                                                    seed=13),
        "smooth_chroma.jpg": encode_progressive([y, cb, cr], [(1, 1)] * 3, [
            ([0, 1, 2], 0, 0, 0, 0), ([0], 1, 63, 0, 0), ([1], 1, 63, 0, 0)], seed=14),
    }
    refused = {n: SMOOTHING for n in f if n.startswith("smooth_")}
    return {n: (d, refused.get(n)) for n, d in f.items()}


# ---------------------------------------------------------------- PNG


def _chunk(kind: bytes, body: bytes) -> bytes:
    return struct.pack(">I", len(body)) + kind + body + struct.pack(">I", zlib.crc32(kind + body))


def _paeth(a, b, c):
    pa, pb, pc = np.abs(b - c), np.abs(a - c), np.abs(a + b - 2 * c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def _filtered(rows: np.ndarray, bpp: int, kinds: np.ndarray) -> bytes:
    """(h, row bytes) uint8 -> the filtered scanlines, row y with filter
    type kinds[y], each behind its type byte."""
    x = rows.astype(np.int32)
    a = np.zeros_like(x)
    a[:, bpp:] = x[:, :-bpp]
    b = np.zeros_like(x)
    b[1:] = x[:-1]
    c = np.zeros_like(x)
    c[:, bpp:] = b[:, :-bpp]
    preds = np.stack([np.zeros_like(x), a, b, (a + b) >> 1, _paeth(a, b, c)])
    pred = np.take_along_axis(preds, kinds[None, :, None].astype(np.int64), 0)[0]
    res = ((x - pred) & 255).astype(np.uint8)
    return np.concatenate([kinds[:, None].astype(np.uint8), res], 1).tobytes()


def encode_png(samples: np.ndarray, depth: int, colour: int, interlace: int = 0, plte: bytes = b"",
               trns: bytes = b"", filters=None, level: int = 6) -> bytes:
    """A PNG of (h, w, channels) integer samples at ``depth`` and
    ``colour`` type, Adam7 where ``interlace``; ``filters``: one filter
    type for every row, or a numpy Generator that picks one for each row
    (None: type 0). Imports no PIL."""
    h, w, ch = samples.shape
    bpp = max(1, ch * depth // 8)
    passes = ADAM7 if interlace else ((0, 1, 0, 1),)
    raw = bytearray()
    for x0, dx, y0, dy in passes:
        sub = np.asarray(samples[y0::dy, x0::dx], np.int64)
        ph, pw = sub.shape[:2]
        if ph == 0 or pw == 0:
            continue
        if depth == 16:
            rows = sub.astype(">u2").reshape(ph, pw * ch).view(np.uint8).reshape(ph, pw * ch * 2)
        elif depth == 8:
            rows = sub.reshape(ph, pw * ch).astype(np.uint8)
        else:
            bits = (sub.reshape(ph, pw * ch)[..., None] >> np.arange(depth - 1, -1, -1)) & 1
            rows = np.packbits(bits.reshape(ph, -1).astype(np.uint8), axis=1)
        if filters is None or isinstance(filters, int):
            kinds = np.full(ph, filters or 0)
        else:
            kinds = filters.integers(0, 5, ph)
        raw += _filtered(rows, bpp, kinds)
    body = _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, colour, 0, 0, interlace))
    body += _chunk(b"PLTE", plte) if plte else b""
    body += _chunk(b"tRNS", trns) if trns else b""
    return (b"\x89PNG\r\n\x1a\n" + body + _chunk(b"IDAT", zlib.compress(bytes(raw), level))
            + _chunk(b"IEND", b""))


def _png_samples(rng, h, w, colour, depth):
    """Random samples of a (colour, depth) image; 16-bit gray keeps a third
    of its samples under 256 (PIL's I;16 clip passes those through)."""
    ch = PNG_CHANNELS[colour]
    top = (1 << depth) - 1 if colour != 3 else min(255, (1 << depth) - 1)
    s = rng.integers(0, top + 1, (h, w, ch))
    if depth == 16 and colour == 0:
        s[rng.random((h, w)) < 1 / 3] %= 256
    return s


def _pil_png(arr, **options) -> bytes:
    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray(arr).save(buf, "PNG", **options)
    return buf.getvalue()


def png_fixtures() -> dict:
    """name -> PNG bytes."""
    from PIL import Image

    rng = np.random.default_rng(31)
    f = {}
    for colour, depth in PNG_FORMATS:
        for interlace in (0, 1):
            s = _png_samples(rng, 23, 19, colour, depth)
            plte = rng.integers(0, 256, 3 * min(256, 1 << depth), dtype=np.uint8).tobytes() if colour == 3 else b""
            name = f"c{colour}_d{depth}{'_adam7' if interlace else ''}.png"
            f[name] = encode_png(s, depth, colour, interlace, plte=plte, filters=rng)
    # Adam7 with empty passes, and tRNS, which changes no pixel of convert("RGB")
    for h, w in ((1, 1), (3, 5), (7, 9)):
        f[f"adam7_{h}x{w}_rgba16.png"] = encode_png(_png_samples(rng, h, w, 6, 16), 16, 6, 1, filters=rng)
        f[f"adam7_{h}x{w}_gray2.png"] = encode_png(_png_samples(rng, h, w, 0, 2), 2, 0, 1, filters=rng)
        f[f"adam7_{h}x{w}_p4.png"] = encode_png(_png_samples(rng, h, w, 3, 4), 4, 3, 1, filters=rng,
                                                plte=rng.integers(0, 256, 48, dtype=np.uint8).tobytes())
    f["c0_d8_trns.png"] = encode_png(_png_samples(rng, 11, 13, 0, 8), 8, 0, trns=struct.pack(">H", 7),
                                     filters=rng)
    f["c0_d16_trns_adam7.png"] = encode_png(_png_samples(rng, 11, 13, 0, 16), 16, 0, 1,
                                            trns=struct.pack(">H", 300), filters=rng)
    f["c2_d16_trns.png"] = encode_png(_png_samples(rng, 11, 13, 2, 16), 16, 2,
                                      trns=struct.pack(">3H", 1000, 2000, 3000), filters=rng)
    f["c3_d2_trns_adam7.png"] = encode_png(_png_samples(rng, 11, 13, 3, 2), 2, 3, 1, filters=rng,
                                           plte=bytes(range(12)), trns=bytes([0, 128]))
    # PIL's own encoder (its filter choice and deflate)
    a = seq.photo(23, 19, 3, seed=32)
    alpha = rng.integers(0, 256, (23, 19), dtype=np.uint8)
    f["pil_1.png"] = _pil_png(a[..., 0] > 100)
    f["pil_l.png"] = _pil_png(a[..., 0])
    f["pil_i16.png"] = _pil_png(rng.integers(0, 65536, (23, 19)).astype(np.uint16))
    f["pil_la.png"] = _pil_png(np.dstack([a[..., 0], alpha]))
    f["pil_rgb.png"] = _pil_png(a)
    f["pil_rgba.png"] = _pil_png(np.dstack([a, alpha]))
    for bits in (1, 2, 4, 8):
        p = Image.fromarray(a).convert("P", palette=Image.ADAPTIVE, colors=1 << bits)
        buf = io.BytesIO()
        p.save(buf, "PNG", bits=bits)
        f[f"pil_p{bits}.png"] = buf.getvalue()
    return f


# -------------------------------------------------------------- digests


def pil_digest(data: bytes) -> dict:
    """PIL's mode, and the sha256 and shape of ``convert("RGB")`` and, for
    an RGBA image, of the data loaders' white composite."""
    import warnings

    from PIL import Image

    im = Image.open(io.BytesIO(data))
    with warnings.catch_warnings():  # a palette tRNS of bytes: convert("RGB") drops it, as it warns
        warnings.simplefilter("ignore", UserWarning)
        rgb = np.asarray(im.convert("RGB"))
    out = {"mode": im.mode, "shape": list(rgb.shape), "sha256": hashlib.sha256(rgb.tobytes()).hexdigest(),
           "bytes": len(data)}
    if im.mode == "RGBA":
        bg = Image.new("RGBA", im.size, (255, 255, 255, 255))
        comp = np.asarray(Image.alpha_composite(bg, im).convert("RGB"))
        out["composite_sha256"] = hashlib.sha256(comp.tobytes()).hexdigest()
    return out


def main(out_dir: str = HERE) -> int:
    digests = {}
    files = {n: (d, None) for n, d in png_fixtures().items()}
    files.update(jpeg_fixtures())
    for name, (data, refused) in sorted(files.items()):
        with open(os.path.join(out_dir, name), "wb") as fh:
            fh.write(data)
        digests[name] = pil_digest(data)
        if refused:
            digests[name]["refused"] = refused
    with open(os.path.join(out_dir, "pil_sha256.json"), "w") as fh:
        json.dump(digests, fh, indent=1, sort_keys=True)
        fh.write("\n")
    return 0


if __name__ == "__main__":
    sys.exit(main(*sys.argv[1:]))
