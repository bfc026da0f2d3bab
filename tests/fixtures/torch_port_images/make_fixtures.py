"""Write the image fixtures of ``tests/test_torch_port_images.py`` and
``chip_smoke.py`` phase 9 beyond the sequential JPEGs beside them
(``../torch_port_jpeg``): progressive, block-smoothed, arithmetic-coded,
lossless, CMYK and YCCK JPEGs, PNGs at every (colour type, bit depth) pair
PNG allows, interlaced or not, WebP files (lossless, lossy, lossy with an
ALPH chunk of each filter, the VP8X container, animations, the loop filter
and partition forms PIL's save cannot select), and ``pil_sha256.json``: for each file PIL's
mode and the sha256 and shape of ``Image.open(...).convert("RGB")``; for a
file PIL opens as RGBA also those of the data loaders' white composite
(``Image.alpha_composite`` over opaque white, then ``convert("RGB")``);
for an arithmetic-coded file the name of its Huffman twin (the same
coefficients and scan script); for a lossless one the sha256 of the RGB
its source samples give (not for CMYK); for a lossless WebP saved with
``exact`` the sha256 of the RGBA it was made from.

    python tests/fixtures/torch_port_images/make_fixtures.py

PIL's encoder writes what it can: progressive JPEGs (4:4:4, 4:2:0, gray,
odd sizes, ``optimize=True``, restart markers), CMYK (baseline and
progressive) and PNGs of modes 1, L, I;16, LA, RGB, RGBA and P at 1, 2, 4
and 8 bits. The encoders below write the rest: ``encode_progressive``
(any scan script: DC scans interleaved or of one component, spectral
selection, successive approximation with libjpeg's jcphuff.c end-of-band
runs and correction bits, a restart interval, Huffman tables redefined
before every scan, an Adobe marker for YCCK), ``encode_arithmetic``
(jcarith.c's coder: SOF9 or SOF10 of any scan script, DAC conditioning,
restarts), ``encode_lossless`` (SOF3: any predictor and point transform,
restarts, sampling factors, interleaved or one scan a component) and
``encode_png`` (every depth and colour type, Adam7, a filter type per
row). The block-smoothing files leave some of the first nine AC
coefficients unrefined, so libjpeg block-smooths them. Every file comes
from a fixed seed, so the script writes the same bytes on every run with
the same PIL. The encoders import no PIL: ``chip_smoke.py`` loads this
file on a host without PIL to write 16-bit and interlaced PNGs and
(``frame_forms``) phase 9d's arithmetic-coded and lossless frames.
"""

from __future__ import annotations

import ctypes
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
# IJG's (libjpeg's jcparam.c) luminance and chrominance tables, natural order
IJG_LUMA = np.array([16, 11, 10, 16, 24, 40, 51, 61, 12, 12, 14, 19, 26, 58, 60, 55, 14, 13, 16, 24, 40, 57, 69, 56,
                     14, 17, 22, 29, 51, 87, 80, 62, 18, 22, 37, 56, 68, 109, 103, 77, 24, 35, 55, 64, 81, 104,
                     113, 92, 49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103, 99])
IJG_CHROMA = np.array([17, 18, 24, 47] + [99] * 4 + [18, 21, 26, 66] + [99] * 4 + [24, 26, 56] + [99] * 5
                      + [47, 66] + [99] * 38)
# phase 9d's smoothed frame: DC at Al 1 then refined, luma AC at Al 1 only,
# chroma DC only (so luma smooths AC 1-9 and chroma takes the DC term too)
SMOOTH_SCRIPT = [([0, 1, 2], 0, 0, 0, 1), ([0], 1, 63, 0, 1), ([0, 1, 2], 0, 0, 1, 0)]


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


def _mcu_grid(planes, sampling):
    hmax = max(h for h, _ in sampling)
    vmax = max(v for _, v in sampling)
    H, W = planes[0].shape
    return -(-W // (8 * hmax)), -(-H // (8 * vmax))


def _units(planes, sampling, comps):
    """The blocks of each MCU of a scan of ``comps``, in coding order:
    (component, block row, block column) lists."""
    if len(comps) > 1:
        mcux, mcuy = _mcu_grid(planes, sampling)
        for my in range(mcuy):
            for mx in range(mcux):
                yield [(ci, my * sampling[ci][1] + vv, mx * sampling[ci][0] + hh)
                       for ci in comps for vv in range(sampling[ci][1]) for hh in range(sampling[ci][0])]
    else:
        ci = comps[0]
        for by in range(-(-planes[ci].shape[0] // 8)):
            for bx in range(-(-planes[ci].shape[1] // 8)):
                yield [(ci, by, bx)]


def _soi(jfif: bool, adobe) -> bytearray:
    """SOI, then a JFIF marker and an Adobe one with transform ``adobe``
    where asked for."""
    out = bytearray(b"\xff\xd8")
    if jfif:
        out += _segment(0xE0, b"JFIF\x00\x01\x01\x00\x00\x01\x00\x01\x00\x00")
    if adobe is not None:
        out += _segment(0xEE, b"Adobe" + struct.pack(">HHHB", 100, 0, 0, adobe))
    return out


def _dct_header(planes, sampling, q, ids, tq, sof, restart, adobe, jfif) -> bytearray:
    """SOI, JFIF / Adobe markers, the DQT tables, the frame header ``sof``
    and a DRI."""
    nc = len(planes)
    out = _soi(jfif, adobe)
    for t in sorted(set(tq)):
        table = q[tq.index(t)]
        out += _segment(0xDB, bytes([t]) + bytes(int(x) for x in np.asarray(table)[ZIGZAG]))
    H, W = planes[0].shape
    body = struct.pack(">BHHB", 8, H, W, nc)
    for ci, (h, v) in enumerate(sampling):
        body += bytes([ids[ci], (h << 4) | v, tq[ci]])
    out += _segment(sof, body)
    if restart:
        out += _segment(0xDD, struct.pack(">H", restart))
    return out


def encode_progressive(planes, sampling, scans, q=None, ids=None, restart=0, adobe=None, jfif=True,
                       seed=0, ac_limit=None, coefs=None) -> bytes:
    """A progressive (SOF2) JPEG of ``planes`` (uint8, each at its sampled
    size) with (h, v) ``sampling`` per component and the scan script
    ``scans``: (component indices, Ss, Se, Ah, Al) each, encoded as
    libjpeg's jcphuff.c encodes them. ``q``: a natural-order table per
    component (two DQT tables: the first component's and the rest's);
    ``restart``: MCUs per restart interval (0: none); ``adobe``: the APP14
    transform flag (None: no APP14). Every scan is preceded by its own DHT
    (fixed-length codes in a seeded order, DC and AC tables 0 and 1 in
    turns). ``ac_limit`` clips every AC coefficient to +-it; ``coefs``:
    the planes' ``quantized_blocks`` where the caller has them."""
    nc = len(planes)
    ids = ids or list(range(1, nc + 1))
    q = q or [np.full(64, 3)] + [np.full(64, 5)] * (nc - 1)
    tq = [0] + [1] * (nc - 1)
    coefs = coefs if coefs is not None else quantized_blocks(planes, sampling, q)
    if ac_limit is not None:
        for c in coefs:
            c[..., 1:] = np.clip(c[..., 1:], -ac_limit, ac_limit)
    rng = np.random.default_rng(seed)
    out = _dct_header(planes, sampling, q, ids, tq, 0xC2, restart, adobe, jfif)
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

        for m, unit in enumerate(_units(planes, sampling, comps)):
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


# T.81 Table D.2 (libjpeg's jaricom.c): (Qe, Next_Index_LPS, Next_Index_MPS,
# Switch_MPS) of each state; state 113 is the fixed 0.5 estimate
QE_TABLE = [
    (0x5a1d, 1, 1, 1), (0x2586, 14, 2, 0), (0x1114, 16, 3, 0), (0x080b, 18, 4, 0), (0x03d8, 20, 5, 0),
    (0x01da, 23, 6, 0), (0x00e5, 25, 7, 0), (0x006f, 28, 8, 0), (0x0036, 30, 9, 0), (0x001a, 33, 10, 0),
    (0x000d, 35, 11, 0), (0x0006, 9, 12, 0), (0x0003, 10, 13, 0), (0x0001, 12, 13, 0), (0x5a7f, 15, 15, 1),
    (0x3f25, 36, 16, 0), (0x2cf2, 38, 17, 0), (0x207c, 39, 18, 0), (0x17b9, 40, 19, 0), (0x1182, 42, 20, 0),
    (0x0cef, 43, 21, 0), (0x09a1, 45, 22, 0), (0x072f, 46, 23, 0), (0x055c, 48, 24, 0), (0x0406, 49, 25, 0),
    (0x0303, 51, 26, 0), (0x0240, 52, 27, 0), (0x01b1, 54, 28, 0), (0x0144, 56, 29, 0), (0x00f5, 57, 30, 0),
    (0x00b7, 59, 31, 0), (0x008a, 60, 32, 0), (0x0068, 62, 33, 0), (0x004e, 63, 34, 0), (0x003b, 32, 35, 0),
    (0x002c, 33, 9, 0), (0x5ae1, 37, 37, 1), (0x484c, 64, 38, 0), (0x3a0d, 65, 39, 0), (0x2ef1, 67, 40, 0),
    (0x261f, 68, 41, 0), (0x1f33, 69, 42, 0), (0x19a8, 70, 43, 0), (0x1518, 72, 44, 0), (0x1177, 73, 45, 0),
    (0x0e74, 74, 46, 0), (0x0bfb, 75, 47, 0), (0x09f8, 77, 48, 0), (0x0861, 78, 49, 0), (0x0706, 79, 50, 0),
    (0x05cd, 48, 51, 0), (0x04de, 50, 52, 0), (0x040f, 50, 53, 0), (0x0363, 51, 54, 0), (0x02d4, 52, 55, 0),
    (0x025c, 53, 56, 0), (0x01f8, 54, 57, 0), (0x01a4, 55, 58, 0), (0x0160, 56, 59, 0), (0x0125, 57, 60, 0),
    (0x00f6, 58, 61, 0), (0x00cb, 59, 62, 0), (0x00ab, 61, 63, 0), (0x008f, 61, 32, 0), (0x5b12, 65, 65, 1),
    (0x4d04, 80, 66, 0), (0x412c, 81, 67, 0), (0x37d8, 82, 68, 0), (0x2fe8, 83, 69, 0), (0x293c, 84, 70, 0),
    (0x2379, 86, 71, 0), (0x1edf, 87, 72, 0), (0x1aa9, 87, 73, 0), (0x174e, 72, 74, 0), (0x1424, 72, 75, 0),
    (0x119c, 74, 76, 0), (0x0f6b, 74, 77, 0), (0x0d51, 75, 78, 0), (0x0bb6, 77, 79, 0), (0x0a40, 77, 48, 0),
    (0x5832, 80, 81, 1), (0x4d1c, 88, 82, 0), (0x438e, 89, 83, 0), (0x3bdd, 90, 84, 0), (0x34ee, 91, 85, 0),
    (0x2eae, 92, 86, 0), (0x299a, 93, 87, 0), (0x2516, 86, 71, 0), (0x5570, 88, 89, 1), (0x4ca9, 95, 90, 0),
    (0x44d9, 96, 91, 0), (0x3e22, 97, 92, 0), (0x3824, 99, 93, 0), (0x32b4, 99, 94, 0), (0x2e17, 93, 86, 0),
    (0x56a8, 95, 96, 1), (0x4f46, 101, 97, 0), (0x47e5, 102, 98, 0), (0x41cf, 103, 99, 0), (0x3c3d, 104, 100, 0),
    (0x375e, 99, 93, 0), (0x5231, 105, 102, 0), (0x4c0f, 106, 103, 0), (0x4639, 107, 104, 0), (0x415e, 103, 99, 0),
    (0x5627, 105, 106, 1), (0x50e7, 108, 107, 0), (0x4b85, 109, 103, 0), (0x5597, 110, 109, 0), (0x504f, 111, 107, 0),
    (0x5a10, 110, 111, 1), (0x5522, 112, 109, 0), (0x59eb, 112, 111, 1), (0x5a1d, 113, 113, 0)]


class _ArithEncoder:
    """libjpeg's jcarith.c coder: the C and A registers, carries through
    stacked 0xFF bytes, byte stuffing, and ``finish`` (T.81 D.1.8)."""

    def __init__(self):
        self.out = bytearray()
        self.reset()

    def reset(self):
        self.c, self.a, self.sc, self.zc, self.ct, self.buffer = 0, 0x10000, 0, 0, 11, -1

    def _zeros(self):
        self.out += bytes(self.zc)
        self.zc = 0

    def _byte(self, b):
        self._zeros()
        self.out.append(b)
        if b == 0xFF:
            self.out.append(0)

    def encode(self, st, i: int, val: int):
        """Code ``val`` in bin ``st[i]`` and update its estimate."""
        sv = st[i]
        qe, lps, mps, switch = QE_TABLE[sv & 0x7F]
        self.a -= qe
        if val != sv >> 7:  # the less probable symbol
            if self.a >= qe:
                self.c += self.a
                self.a = qe
            st[i] = (sv & 0x80) ^ (lps | (switch << 7))
        else:
            if self.a >= 0x8000:
                return
            if self.a < qe:
                self.c += self.a
                self.a = qe
            st[i] = (sv & 0x80) ^ mps
        while True:  # renormalization and output, D.1.6
            self.a <<= 1
            self.c <<= 1
            self.ct -= 1
            if self.ct == 0:
                temp = self.c >> 19
                if temp > 0xFF:  # a carry into the stacked 0xFF bytes
                    if self.buffer >= 0:
                        self._byte(self.buffer + 1)
                    self.zc += self.sc
                    self.sc = 0
                    self.buffer = temp & 0xFF
                elif temp == 0xFF:
                    self.sc += 1
                else:
                    if self.buffer == 0:
                        self.zc += 1
                    elif self.buffer >= 0:
                        self._byte(self.buffer)
                    if self.sc:
                        self._zeros()
                        self.out += b"\xff\x00" * self.sc
                        self.sc = 0
                    self.buffer = temp & 0xFF
                self.c &= 0x7FFFF
                self.ct += 8
            if self.a >= 0x8000:
                return

    def finish(self):
        temp = (self.a - 1 + self.c) & 0xFFFF0000
        self.c = temp + 0x8000 if temp < self.c else temp
        self.c <<= self.ct
        if self.c & 0xF8000000:
            if self.buffer >= 0:
                self._byte(self.buffer + 1)
            self.zc += self.sc
            self.sc = 0
        else:
            if self.buffer == 0:
                self.zc += 1
            elif self.buffer >= 0:
                self._byte(self.buffer)
            if self.sc:
                self._zeros()
                self.out += b"\xff\x00" * self.sc
                self.sc = 0
        if self.c & 0x7FFF800:  # the final bytes, only where they are not 0
            self._byte((self.c >> 19) & 0xFF)
            if self.c & 0x7F800:
                self._byte((self.c >> 11) & 0xFF)


def _arith_dc(e, st, v, ctx, L, U):
    """A DC difference ``v`` (F.1.4.1, Figures F.4-F.9) in context ``ctx``
    of the statistics ``st``; returns the next context."""
    if v == 0:
        e.encode(st, ctx, 0)
        return 0
    e.encode(st, ctx, 1)
    sign = int(v < 0)
    v = abs(v)
    e.encode(st, ctx + 1, sign)
    s, nxt = ctx + 2 + sign, 4 + 4 * sign
    m = 0
    v -= 1
    if v:
        e.encode(st, s, 1)
        m, v2, s = 1, v >> 1, 20
        while v2:
            e.encode(st, s, 1)
            m, s, v2 = m << 1, s + 1, v2 >> 1
    e.encode(st, s, 0)
    if m < (1 << L) >> 1:
        nxt = 0
    elif m > (1 << U) >> 1:
        nxt += 8
    s += 14
    m >>= 1
    while m:
        e.encode(st, s, int(bool(m & v)))
        m >>= 1
    return nxt


def _arith_ac_value(e, st, s, k, v, K, fixed):
    """The sign and magnitude of a nonzero AC value ``v`` at ``k``, its
    nonzero decision taken in bin ``s`` - 1 (F.1.4.2)."""
    e.encode(fixed, 0, int(v < 0))
    v = abs(v)
    s += 2
    m = 0
    v -= 1
    if v:
        e.encode(st, s, 1)
        m, v2 = 1, v >> 1
        if v2:
            e.encode(st, s, 1)
            m, s, v2 = 2, (189 if k <= K else 217), v2 >> 1
            while v2:
                e.encode(st, s, 1)
                m, s, v2 = m << 1, s + 1, v2 >> 1
    e.encode(st, s, 0)
    s += 14
    m >>= 1
    while m:
        e.encode(st, s, int(bool(m & v)))
        m >>= 1


def _arith_ac(e, st, blk, Ss, Se, Al, K, fixed):
    """An AC band (sequential: Ss 1, Se 63, Al 0; or a progressive first
    scan), jcarith.c's encode_mcu / encode_mcu_AC_first."""
    mag = [abs(int(x)) >> Al for x in blk]
    ke = Se
    while ke > 0 and mag[ke] == 0:
        ke -= 1
    k = Ss
    while k <= ke:
        s = 3 * (k - 1)
        e.encode(st, s, 0)
        while mag[k] == 0:
            e.encode(st, s + 1, 0)
            s, k = s + 3, k + 1
        e.encode(st, s + 1, 1)
        _arith_ac_value(e, st, s, k, mag[k] if blk[k] > 0 else -mag[k], K, fixed)
        k += 1
    if k <= Se:
        e.encode(st, 3 * (k - 1), 1)


def _arith_ac_refine(e, st, blk, Ss, Se, Ah, Al, fixed):
    """jcarith.c:encode_mcu_AC_refine (Figure G.10)."""
    mag = [abs(int(x)) >> Al for x in blk]
    ke = Se
    while ke > 0 and mag[ke] == 0:
        ke -= 1
    kex = ke
    while kex > 0 and abs(int(blk[kex])) >> Ah == 0:
        kex -= 1
    k = Ss
    while k <= ke:
        s = 3 * (k - 1)
        if k > kex:
            e.encode(st, s, 0)
        while mag[k] == 0:
            e.encode(st, s + 1, 0)
            s, k = s + 3, k + 1
        if mag[k] >> 1:  # already nonzero: its next bit
            e.encode(st, s + 2, mag[k] & 1)
        else:  # newly nonzero
            e.encode(st, s + 1, 1)
            e.encode(fixed, 0, int(blk[k] < 0))
        k += 1
    if k <= Se:
        e.encode(st, 3 * (k - 1), 1)


def encode_arithmetic(planes, sampling, scans=None, q=None, ids=None, restart=0, adobe=None, jfif=True,
                      dac=None, slots=None, coefs=None, overflow_at=None) -> bytes:
    """An arithmetic-coded JPEG of ``planes`` (as ``encode_progressive``
    takes them, or their ``quantized_blocks`` in ``coefs``), coded as
    libjpeg's jcarith.c codes: sequential (SOF9) where ``scans`` is None
    (one interleaved scan) or every scan is (components, 0, 63, 0, 0), else
    progressive (SOF10) with the scan script ``scans`` ((component indices,
    Ss, Se, Ah, Al) each). ``dac``: {(class, slot): value} for a DAC
    segment (class 0: the DC (U << 4) | L; 1: the AC Kx); ``slots``: the
    conditioning table of each component (default libjpeg's: 0 for the
    first, 1 for the rest); ``restart``: MCUs a restart interval;
    ``overflow_at``: (component, block row, block column) of a sequential
    block whose AC codes run past coefficient 63, a bad code on which
    libjpeg's decoder gives up until the next restart."""
    nc = len(planes)
    ids = ids or list(range(1, nc + 1))
    q = q or [np.full(64, 3)] + [np.full(64, 5)] * (nc - 1)
    tq = [0] + [1] * (nc - 1)
    slots = slots or [0] + [1] * (nc - 1)
    scans = scans or [(list(range(nc)), 0, 63, 0, 0)]
    coefs = coefs if coefs is not None else quantized_blocks(planes, sampling, q)
    sequential = all(Ss == 0 and Se == 63 and Ah == 0 and Al == 0 for _, Ss, Se, Ah, Al in scans)
    dac = dac or {}
    L = {t: dac.get((0, t), 0x10) & 15 for t in range(16)}
    U = {t: dac.get((0, t), 0x10) >> 4 for t in range(16)}
    K = {t: dac.get((1, t), 5) for t in range(16)}
    out = _dct_header(planes, sampling, q, ids, tq, 0xC9 if sequential else 0xCA, restart, adobe, jfif)
    if dac:
        out += _segment(0xCC, b"".join(bytes([(tc << 4) | t, v]) for (tc, t), v in sorted(dac.items())))
    for comps, Ss, Se, Ah, Al in scans:
        sos = bytes([len(comps)]) + b"".join(bytes([ids[ci], (slots[ci] << 4) | slots[ci]]) for ci in comps)
        out += _segment(0xDA, sos + bytes([Ss, Se, (Ah << 4) | Al]))
        e, fixed = _ArithEncoder(), bytearray([113])

        def reset():
            e.reset()
            state = {}
            for ci in comps:  # the bins the scan codes with, zeroed
                if sequential or (Ss == 0 and Ah == 0):
                    state[("dc", slots[ci])] = bytearray(64)
                if sequential or Ss:
                    state[("ac", slots[ci])] = bytearray(256)
            return state, {ci: 0 for ci in comps}, {ci: 0 for ci in comps}

        stats, last, ctx = reset()
        for m, unit in enumerate(_units(planes, sampling, comps)):
            if restart and m and m % restart == 0:
                e.finish()
                e.out += bytes([0xFF, 0xD0 + ((m // restart - 1) & 7)])
                stats, last, ctx = reset()
            for ci, by, bx in unit:
                blk, t = coefs[ci][by, bx], slots[ci]
                if sequential or (Ss == 0 and Ah == 0):
                    dcv = int(blk[0]) >> Al
                    ctx[ci] = _arith_dc(e, stats[("dc", t)], dcv - last[ci], ctx[ci], L[t], U[t])
                    last[ci] = dcv
                    if sequential and (ci, by, bx) == overflow_at:  # not EOB, then 63 zeros
                        e.encode(stats[("ac", t)], 0, 0)
                        for k in range(1, 64):
                            e.encode(stats[("ac", t)], 3 * (k - 1) + 1, 0)
                    elif sequential:
                        _arith_ac(e, stats[("ac", t)], blk, 1, 63, 0, K[t], fixed)
                elif Ss == 0:
                    e.encode(fixed, 0, (int(blk[0]) >> Al) & 1)
                elif Ah == 0:
                    _arith_ac(e, stats[("ac", t)], blk, Ss, Se, Al, K[t], fixed)
                else:
                    _arith_ac_refine(e, stats[("ac", t)], blk, Ss, Se, Ah, Al, fixed)
        e.finish()
        out += e.out
    out += b"\xff\xd9"
    return bytes(out)


def _pack_bits(values: np.ndarray, lengths: np.ndarray) -> bytes:
    """Codes of ``lengths`` bits (up to 32) MSB first, padded with 1 bits
    to a byte and 0xFF-stuffed."""
    bits = (values[:, None].astype(np.uint64) >> np.arange(31, -1, -1, dtype=np.uint64)) & 1
    keep = np.arange(32)[None, :] >= 32 - lengths[:, None]
    flat = bits[keep].astype(np.uint8)
    flat = np.concatenate([flat, np.ones(-len(flat) % 8, np.uint8)])
    return np.packbits(flat).tobytes().replace(b"\xff", b"\xff\x00")


def _lossless_predict(rows, y: int, first: bool, psv: int, pt: int):
    """jdlossls.c's prediction of row ``y`` of ``rows`` (int samples,
    modulo 2^16): the first-row form (2^(7 - pt), then the left sample), or
    predictor ``psv`` with the sample above at column 0."""
    cur = rows[y].astype(np.int64)
    pred = np.empty_like(cur)
    if first:
        pred[0] = 1 << (8 - pt - 1)
        pred[1:] = cur[:-1]
        return pred
    up = rows[y - 1].astype(np.int64)
    ra, rb, rc = cur[:-1], up[1:], up[:-1]
    pred[0] = up[0]
    pred[1:] = {1: ra, 2: rb, 3: rc, 4: ra + rb - rc, 5: ra + ((rb - rc) >> 1), 6: rb + ((ra - rc) >> 1),
                7: (ra + rb) >> 1}[psv]
    return pred


def _lossless_differences(samples, sampling, comps, psv, pt, restart_rows, T):
    """The difference of every sample of ``comps`` (modulo 2^16, in
    -32767..32768) and the MCU rows a restart precedes, walked as
    jddiffct.c walks them: the MCU rows of an iMCU row are decoded, then its
    rows undifferenced; the first-row form at the scan's start and on the
    first row undifferenced after a restart."""
    inter = len(comps) > 1
    diffs = {c: np.zeros(samples[c].shape, np.int64) for c in comps}
    first, togo, mcu_row, restarts_at = {c: True for c in comps}, restart_rows, 0, []
    for r in range(T):
        c0 = comps[0]
        v0, rows0 = sampling[c0][1], samples[c0].shape[0]
        for _ in range(1 if inter else (v0 if r < T - 1 else rows0 % v0 or v0)):
            if restart_rows and togo == 0:
                restarts_at.append(mcu_row)
                first = {c: True for c in comps}
                togo = restart_rows
            mcu_row += 1
            togo -= 1
        for c in comps:
            v, rows = sampling[c][1], samples[c].shape[0]
            for row in range(v if r < T - 1 else rows % v or v):
                y = r * v + row
                d = samples[c][y].astype(np.int64) - _lossless_predict(samples[c], y, first[c], psv, pt[c])
                diffs[c][y] = ((d + 32767) & 0xFFFF) - 32767
                first[c] = False
    return diffs, restarts_at


def _huffman_differences(d: np.ndarray, code: dict) -> bytes:
    """Lossless differences as jdlhuff.c reads them: a category (16: 32768,
    no extra bits) and its extra bits."""
    mag = np.abs(d)
    cat = np.where(d == 32768, 16, np.ceil(np.log2(mag + 1)).astype(np.int64))
    nbits = np.where(cat == 16, 0, cat)
    extra = np.where(d >= 0, d, d - 1) & ((1 << nbits) - 1)
    cval = np.array([code[k][0] for k in range(17)], np.int64)[cat]
    clen = np.array([code[k][1] for k in range(17)], np.int64)[cat]
    return _pack_bits((cval << nbits) | extra, clen + nbits)


def encode_lossless(samples, sampling, psv: int, pt=0, restart_rows: int = 0, ids=None, adobe=None,
                    jfif=False, interleaved=True, seed=0) -> bytes:
    """A lossless Huffman JPEG (SOF3) of ``samples`` (one int array a
    component at its sampled size: the values libjpeg keeps, modulo 2^16,
    whose decoded sample is the low byte of value << ``pt``) with predictor
    ``psv`` and point transform ``pt`` (one for every component, or one a
    component where each has its own scan): one interleaved scan (the MCU
    grid's padding coded as differences of 0), or one scan a component; a
    restart every ``restart_rows`` MCU rows (the interval a multiple of
    the MCUs of a row, as libjpeg requires); a seeded fixed-length code of
    the difference categories 0-16 a scan. Imports no PIL."""
    nc = len(samples)
    ids = ids or list(range(1, nc + 1))
    hmax = max(h for h, _ in sampling)
    vmax = max(v for _, v in sampling)
    H, W = samples[0].shape
    rng = np.random.default_rng(seed)
    out = _soi(jfif, adobe)
    body = struct.pack(">BHHB", 8, H, W, nc)
    for ci, (h, v) in enumerate(sampling):
        body += bytes([ids[ci], (h << 4) | v, 0])
    out += _segment(0xC3, body)
    T, mcux = -(-H // vmax), -(-W // hmax)
    pt = [pt] * nc if isinstance(pt, int) else list(pt)
    for si, comps in enumerate([list(range(nc))] if interleaved and nc > 1 else [[c] for c in range(nc)]):
        inter = len(comps) > 1
        per_row = mcux if inter else samples[comps[0]].shape[1]
        code, dht = _code(list(range(17)), rng)
        out += _segment(0xC4, bytes([si % 2]) + dht)
        out += _segment(0xDD, struct.pack(">H", restart_rows * per_row))
        out += _segment(0xDA, bytes([len(comps)]) + b"".join(bytes([ids[c], (si % 2) << 4]) for c in comps)
                        + bytes([psv, 0, pt[comps[0]]]))
        diffs, restarts_at = _lossless_differences(samples, sampling, comps, psv, pt, restart_rows, T)
        if inter:  # MCU rows: (MCU columns, components, v rows, h columns)
            parts = []
            for c in comps:
                h, v = sampling[c]
                d = diffs[c]
                padded = np.zeros((T * v, mcux * h), np.int64)
                padded[:d.shape[0], :d.shape[1]] = d
                parts.append(padded.reshape(T, v, mcux, h).transpose(0, 2, 1, 3).reshape(T, mcux, v * h))
            rows = list(np.concatenate(parts, axis=2).reshape(T, -1))
        else:
            rows = list(diffs[comps[0]])
        bounds = [0] + restarts_at + [len(rows)]
        for k in range(len(bounds) - 1):
            if k:
                out += bytes([0xFF, 0xD0 + ((k - 1) & 7)])
            out += _huffman_differences(np.concatenate(rows[bounds[k]:bounds[k + 1]]), code)
    out += b"\xff\xd9"
    return bytes(out)


def ijg_tables(quality: int, nc: int = 3) -> list:
    """jcparam.c:jpeg_quality_scaling of IJG's tables, one a component."""
    scale = 5000 // quality if quality < 50 else 200 - 2 * quality
    luma, chroma = (np.clip((t * scale + 50) // 100, 1, 255) for t in (IJG_LUMA, IJG_CHROMA))
    return [luma] + [chroma] * (nc - 1)


def _420(rgb):
    y, cb, cr = seq._ycc(rgb)
    return [y, seq._down(cb, 2, 2), seq._down(cr, 2, 2)], [(2, 2), (1, 1), (1, 1)]


def frame_forms(pixels: np.ndarray, quality: int = 85) -> dict:
    """A frame's (H, W, 3 uint8) forms that ``chip_smoke.py`` phase 9d
    generates from CO3D's 1067x800 frame on a host without PIL: "arithmetic"
    (SOF9, 4:2:0, IJG's tables at ``quality``), "huffman" (SOF2 of the same
    coefficients, every one refined: the same pixels by construction) and
    "lossless" (SOF3, RGB by its component ids, predictor 1: the frame's
    pixels exactly)."""
    planes, sampling = _420(pixels)
    q = ijg_tables(quality)
    coefs = quantized_blocks(planes, sampling, q)
    full = [([0, 1, 2], 0, 0, 0, 0)] + [([c], 1, 63, 0, 0) for c in range(3)]
    return {"arithmetic": encode_arithmetic(planes, sampling, q=q, coefs=coefs),
            "huffman": encode_progressive(planes, sampling, full, q=q, coefs=coefs),
            "lossless": encode_lossless([pixels[..., k].astype(np.int64) for k in range(3)], [(1, 1)] * 3, 1,
                                        ids=[82, 71, 66])}


def smoothed_frame(pixels: np.ndarray, quality: int = 85) -> bytes:
    """The frame as a progressive JPEG of ``SMOOTH_SCRIPT``, which libjpeg
    block-smooths (phase 9d's smoothed source; PIL's digest is stored)."""
    planes, sampling = _420(pixels)
    return encode_progressive(planes, sampling, SMOOTH_SCRIPT, q=ijg_tables(quality))


def _upsampled(planes, sampling, shape) -> list:
    """Each plane replicated to the image's size (libjpeg's upsampling of a
    lossless frame)."""
    hmax = max(h for h, _ in sampling)
    vmax = max(v for _, v in sampling)
    return [np.repeat(np.repeat(p, vmax // v, 0), hmax // h, 1)[:shape[0], :shape[1]]
            for p, (h, v) in zip(planes, sampling)]


def lossless_fixtures() -> dict:
    """name -> (SOF3 bytes, the RGB pixels its samples give, or None for
    CMYK): every predictor, point transforms, restarts, sampling factors
    interleaved or one scan a component, the colour spaces libjpeg leaves
    unconverted, and a difference of category 16."""
    g = seq.photo(29, 43, 1, seed=41)[..., 0].astype(np.int64)
    a = seq.photo(37, 53, 3, seed=42).astype(np.int64)
    rgb = [a[..., k] for k in range(3)]
    odd = seq.photo(13, 11, 3, seed=43)
    cmyk = [seq.photo(15, 17, 4, seed=44)[..., k].astype(np.int64) for k in range(4)]
    sub = [rgb[0], seq._down(a[..., 1], 2, 2).astype(np.int64), seq._down(a[..., 2], 2, 1).astype(np.int64)]
    s_sub = [(2, 2), (1, 1), (2, 1)]
    o420 = [odd[..., 0].astype(np.int64), seq._down(odd[..., 1], 2, 2).astype(np.int64),
            seq._down(odd[..., 2], 2, 2).astype(np.int64)]
    s420 = [(2, 2), (1, 1), (1, 1)]
    flat = np.full((9, 12), 77, np.int64)
    flat[3, 5:7] += 32768  # differences of exactly 32768 (category 16), and of -32768
    flat[6, 2] += 32768
    gray = {f"lossless_gray_p{p}{tag}.jpg": (p, pt, rr)
            for p, pt, rr, tag in ((1, 0, 0, ""), (2, 2, 0, "_pt2"), (3, 0, 4, "_rst"), (4, 0, 0, ""),
                                   (5, 1, 1, "_pt1_rst"), (6, 0, 0, ""), (7, 7, 0, "_pt7"))}
    out = {}
    for i, (name, (psv, pt, rr)) in enumerate(sorted(gray.items())):
        out[name] = (encode_lossless([g >> pt], [(1, 1)], psv, pt, rr, seed=i),
                     np.repeat(((g >> pt) << pt).astype(np.uint8)[..., None], 3, 2))
    px = np.dstack(rgb).astype(np.uint8)
    out.update({
        "lossless_rgb_ids.jpg": (encode_lossless(rgb, [(1, 1)] * 3, 4, ids=[82, 71, 66], seed=10), px),
        "lossless_rgb_123.jpg": (encode_lossless(rgb, [(1, 1)] * 3, 7, seed=11), px),
        "lossless_rgb_adobe0.jpg": (encode_lossless(rgb, [(1, 1)] * 3, 6, adobe=0, seed=12), px),
        "lossless_rgb_sub_rst.jpg": (encode_lossless(sub, s_sub, 7, restart_rows=2, ids=[82, 71, 66], seed=13),
                                     np.dstack(_upsampled(sub, s_sub, (37, 53))).astype(np.uint8)),
        # one scan a component, a restart every MCU row: libjpeg's first-row
        # form lands on the first row of each two-row iMCU row of luma
        "lossless_420_scans_rst.jpg": (encode_lossless(o420, s420, 1, restart_rows=1, interleaved=False,
                                                       ids=[82, 71, 66], seed=14),
                                       np.dstack(_upsampled(o420, s420, (13, 11))).astype(np.uint8)),
        # one scan a component, each its own point transform
        "lossless_rgb_scans_pt.jpg": (encode_lossless([x >> p for x, p in zip(rgb, (0, 2, 5))], [(1, 1)] * 3, 5,
                                                      (0, 2, 5), interleaved=False, ids=[82, 71, 66], seed=18),
                                      np.dstack([(x >> p) << p for x, p in zip(rgb, (0, 2, 5))]).astype(np.uint8)),
        "lossless_cmyk.jpg": (encode_lossless(cmyk, [(1, 1)] * 4, 2, seed=15), None),
        "lossless_cmyk_adobe0.jpg": (encode_lossless(cmyk, [(1, 1)] * 4, 3, adobe=0, restart_rows=3, seed=16),
                                     None),
        "lossless_cat16.jpg": (encode_lossless([flat], [(1, 1)], 1, seed=17),
                               np.repeat((flat & 255).astype(np.uint8)[..., None], 3, 2)),
    })
    return out


def arithmetic_fixtures() -> dict:
    """name -> (SOF9/SOF10 bytes, the SOF2 bytes of the same coefficients
    and scan script: its Huffman twin, whose pixels PIL must give alike)."""
    a = seq.photo(37, 53, 3, seed=51)
    y, cb, cr = seq._ycc(a)
    g = seq.photo(29, 43, 1, seed=52)[..., 0]
    cmyk = seq.photo(27, 35, 4, seed=53)
    yk = _ycck(cmyk)
    p420, s420 = _420(a)
    gray_script = [([0], 0, 0, 0, 2), ([0], 1, 2, 0, 3), ([0], 3, 63, 0, 1), ([0], 1, 2, 3, 2), ([0], 0, 0, 2, 1),
                   ([0], 1, 2, 2, 1), ([0], 0, 0, 1, 0), ([0], 1, 63, 1, 0)]
    specs = {  # name -> (planes, sampling, scan script or None (sequential), keywords)
        "arith_seq_gray.jpg": ([g], [(1, 1)], None, {}),
        "arith_seq_420_rst.jpg": (p420, s420, None, dict(restart=3, dac={(0, 0): 0x52, (0, 1): 0x31,
                                                                         (1, 0): 2, (1, 1): 20})),
        # one scan a component, conditioning tables 2 and 5 (L 0 U 15, Kx 0)
        "arith_seq_scans.jpg": ([y, cb, cr], [(1, 1)] * 3, [([c], 0, 63, 0, 0) for c in range(3)],
                                dict(slots=[2, 5, 5], dac={(0, 2): 0xF0, (1, 5): 0, (1, 2): 63})),
        "arith_rgb_ids.jpg": (list(np.moveaxis(a, 2, 0)), [(1, 1)] * 3, None, dict(ids=[82, 71, 66], jfif=False)),
        "arith_cmyk.jpg": ([255 - cmyk[..., k] for k in range(4)], [(1, 1)] * 4, None, dict(adobe=0, jfif=False)),
        "arith_prog_420.jpg": (p420, s420, full_script(3), {}),
        "arith_prog_rst.jpg": (p420, s420, full_script(3, dc_interleaved=False),
                               dict(restart=2, dac={(0, 0): 0x11, (0, 1): 0x00, (1, 0): 63})),
        "arith_prog_gray_script.jpg": ([g], [(1, 1)], gray_script, dict(restart=5)),
        "arith_prog_ycck.jpg": (yk, [(1, 1)] * 4, full_script(4), dict(adobe=2, jfif=False)),
        # libjpeg block-smooths these: luma AC at Al 1, chroma DC only
        "arith_smooth.jpg": (p420, s420, SMOOTH_SCRIPT, dict(restart=4)),
        "arith_smooth_dc_only.jpg": ([g], [(1, 1)], [([0], 0, 0, 0, 0)], {}),
    }
    out = {}
    # a bad code in MCU 1 of the first restart interval: libjpeg gives up
    # there and resumes at the next interval (no twin: the pixels differ)
    out["arith_gives_up.jpg"] = (encode_arithmetic(p420, s420, restart=3, overflow_at=(0, 1, 2)), None)
    for name, (planes, sampling, scans, kw) in specs.items():
        nc = len(planes)
        sequential = scans is None or all(sc[1:] == (0, 63, 0, 0) for sc in scans)
        twin_scans = [(list(range(nc)), 0, 0, 0, 0)] + [([c], 1, 63, 0, 0) for c in range(nc)] if sequential else scans
        twin_kw = {k: v for k, v in kw.items() if k in ("restart", "ids", "adobe", "jfif")}
        out[name] = (encode_arithmetic(planes, sampling, scans, **kw),
                     encode_progressive(planes, sampling, twin_scans, **twin_kw))
    return out


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
    """name -> bytes of the progressive, CMYK/YCCK and block-smoothed
    JPEGs."""
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
        # the neighbourhood's edges: luma two blocks wide, chroma one, five
        # luma block rows in three iMCU rows (the last one short)
        "smooth_420_2cols.jpg": encode_progressive(*_420(seq.photo(40, 16, 3, seed=15)), [
            ([0, 1, 2], 0, 0, 0, 0), ([0], 1, 2, 0, 0)], seed=15),
        # 4:4:0 in two iMCU rows, the last of one block row: libjpeg clamps
        # its rows by block_rows x iMCU rows
        "smooth_440_rows.jpg": encode_progressive(
            [y[:24, :40], seq._down(cb[:24, :40], 2, 1), seq._down(cr[:24, :40], 2, 1)], [(1, 2), (1, 1), (1, 1)],
            [([0, 1, 2], 0, 0, 0, 0), ([0], 1, 9, 0, 1), ([1], 1, 5, 0, 0)], seed=16),
        # DC never refined below Al 2, AC at Al 1: estimates clamped below 2
        "smooth_gray_al2.jpg": encode_progressive([g], [(1, 1)], [
            ([0], 0, 0, 0, 2), ([0], 1, 63, 0, 2), ([0], 1, 63, 2, 1)], seed=17),
        "smooth_cmyk.jpg": encode_progressive([255 - cmyk[..., k] for k in range(4)], [(1, 1)] * 4,
                                              [([0, 1, 2, 3], 0, 0, 0, 0)] + [([c], 1, 5, 0, 0) for c in range(4)],
                                              adobe=0, jfif=False, seed=18),
        "smooth_1x1.jpg": encode_progressive(*_420(seq.photo(1, 1, 3, seed=19)), [([0, 1, 2], 0, 0, 0, 0)],
                                             seed=19),
    }
    return f


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


# ------------------------------------------------------------------ WebP
#
# PIL's save writes lossless VP8L (method 0-6, any quality, ``exact``),
# lossy VP8 with and without an ALPH chunk and animations. The features it
# cannot select (the simple loop filter, 2-8 token partitions, 1-4
# segments, filter sharpness, raw alpha) come from libwebp's own encoder
# through ctypes (``webp_encode``); the ALPH filters, from ``alpha_chunk``,
# which writes an ALPH chunk of any filter and method by hand; an animation
# whose first frame sits at an offset of a larger canvas, from
# ``animation``.


class _WebPConfig(ctypes.Structure):
    """libwebp's ``WebPConfig`` at encoder ABI 0x020f (``webp/encode.h``)."""
    _fields_ = [(n, ctypes.c_float if n in ("quality", "target_PSNR") else ctypes.c_int)
                for n in ("lossless", "quality", "method", "image_hint", "target_size", "target_PSNR", "segments",
                          "sns_strength", "filter_strength", "filter_sharpness", "filter_type", "autofilter",
                          "alpha_compression", "alpha_filtering", "alpha_quality", "pass", "show_compressed",
                          "preprocessing", "partitions", "partition_limit", "emulate_jpeg_size", "thread_level",
                          "low_memory", "near_lossless", "exact", "use_delta_palette", "use_sharp_yuv", "qmin",
                          "qmax")]


_P, _I, _U32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint32


class _WebPPicture(ctypes.Structure):
    """libwebp's ``WebPPicture`` at encoder ABI 0x020f."""
    _fields_ = [("use_argb", _I), ("colorspace", _I), ("width", _I), ("height", _I), ("y", _P), ("u", _P),
                ("v", _P), ("y_stride", _I), ("uv_stride", _I), ("a", _P), ("a_stride", _I), ("pad1", _U32 * 2),
                ("argb", _P), ("argb_stride", _I), ("pad2", _U32 * 3), ("writer", _P), ("custom_ptr", _P),
                ("extra_info_type", _I), ("extra_info", _P), ("stats", _P), ("error_code", _I),
                ("progress_hook", _P), ("user_data", _P), ("pad3", _U32 * 3), ("pad4", _P), ("pad5", _P),
                ("pad6", _U32 * 8), ("memory_", _P), ("memory_argb_", _P), ("pad7", _P * 2)]


class _WebPMemoryWriter(ctypes.Structure):
    _fields_ = [("mem", _P), ("size", ctypes.c_size_t), ("max_size", ctypes.c_size_t), ("pad", _U32 * 1)]


WEBP_ENCODER_ABI = 0x020F


def webp_encode(img: np.ndarray, **config) -> bytes:
    """(H, W, 3 or 4) uint8 -> a WebP file from the system libwebp's encoder
    (``libwebp.so.7``, 1.2.x, whose ``webp/encode.h`` is ABI 0x020f): the
    default config at quality 75, then ``config``'s ``WebPConfig`` fields
    (``filter_type=0`` the simple filter, ``partitions`` log2 of the token
    partitions, ``segments``, ``filter_sharpness``, ``alpha_compression=0``
    raw alpha, ...). An opaque image has no ALPH chunk."""
    import ctypes.util

    lib = ctypes.CDLL(ctypes.util.find_library("webp"))
    if lib.WebPGetEncoderVersion() >> 8 != 0x0102:
        raise RuntimeError(f"webp_encode needs libwebp 1.2.x, found {lib.WebPGetEncoderVersion():#x}")
    cfg = _WebPConfig()
    if not lib.WebPConfigInitInternal(ctypes.byref(cfg), 0, ctypes.c_float(75.0), WEBP_ENCODER_ABI):
        raise RuntimeError("WebPConfigInit failed")
    for k, v in config.items():
        setattr(cfg, k, v)
    if not lib.WebPValidateConfig(ctypes.byref(cfg)):
        raise ValueError(f"libwebp refuses the config {config}")
    pic = _WebPPicture()
    if not lib.WebPPictureInitInternal(ctypes.byref(pic), WEBP_ENCODER_ABI):
        raise RuntimeError("WebPPictureInit failed")
    img = np.ascontiguousarray(img, np.uint8)
    if img.ndim != 3 or img.shape[2] not in (3, 4):
        raise ValueError(f"webp_encode takes (H, W, 3 or 4) uint8, got {img.shape}")
    h, w, ch = img.shape
    pic.width, pic.height = w, h
    pic.use_argb = int(cfg.lossless)
    writer = _WebPMemoryWriter()
    lib.WebPMemoryWriterInit(ctypes.byref(writer))
    try:
        importer = lib.WebPPictureImportRGBA if ch == 4 else lib.WebPPictureImportRGB
        if not importer(ctypes.byref(pic), img.ctypes.data_as(ctypes.c_void_p), w * ch):
            raise RuntimeError("WebPPictureImport failed")
        pic.writer = ctypes.cast(lib.WebPMemoryWrite, ctypes.c_void_p)
        pic.custom_ptr = ctypes.cast(ctypes.pointer(writer), ctypes.c_void_p)
        if not lib.WebPEncode(ctypes.byref(cfg), ctypes.byref(pic)):
            raise RuntimeError(f"WebPEncode failed, error {pic.error_code}")
        return ctypes.string_at(writer.mem, writer.size)
    finally:
        lib.WebPPictureFree(ctypes.byref(pic))
        lib.WebPMemoryWriterClear(ctypes.byref(writer))


def _riff_chunk(kind: bytes, body: bytes) -> bytes:
    return kind + struct.pack("<I", len(body)) + body + b"\0" * (len(body) & 1)


def riff_chunks(data: bytes) -> list:
    """(fourcc, body) of each chunk of a RIFF/WEBP file."""
    out, pos = [], 12
    while pos + 8 <= len(data):
        kind, size = data[pos:pos + 4], struct.unpack("<I", data[pos + 4:pos + 8])[0]
        out.append((kind, data[pos + 8:pos + 8 + size]))
        pos += 8 + size + (size & 1)
    return out


def webp_file(chunks) -> bytes:
    """A RIFF/WEBP file of (fourcc, body) chunks."""
    body = b"WEBP" + b"".join(_riff_chunk(k, b) for k, b in chunks)
    return b"RIFF" + struct.pack("<I", len(body)) + body


def vp8x(w: int, h: int, flags: int) -> tuple:
    """A VP8X chunk: the flags byte, 3 reserved bytes, the canvas size."""
    return (b"VP8X", bytes([flags]) + b"\0\0\0" + struct.pack("<I", w - 1)[:3] + struct.pack("<I", h - 1)[:3])


def _alpha_predict(rows: np.ndarray, filt: int) -> np.ndarray:
    """libwebp's alpha filter predictions of each sample (its unfilter's):
    horizontal from the left (the first row from 0, later first columns
    from above), vertical from above, gradient clip(left + above -
    above-left); the first row is horizontal whatever the filter."""
    h, w = rows.shape
    r = rows.astype(np.int64)
    pred = np.zeros_like(r)
    pred[0, 1:] = r[0, :-1]
    if h > 1:
        if filt == 1:
            pred[1:, 0] = r[:-1, 0]
            pred[1:, 1:] = r[1:, :-1]
        elif filt == 2:
            pred[1:] = r[:-1]
        else:
            pred[1:, 0] = r[:-1, 0]
            pred[1:, 1:] = np.clip(r[1:, :-1] + r[:-1, 1:] - r[:-1, :-1], 0, 255)
    return pred


def alpha_chunk(alpha: np.ndarray, filt: int, method: int) -> bytes:
    """An ALPH chunk body for the (H, W) uint8 ``alpha``: filter ``filt``
    (0 none, 1 horizontal, 2 vertical, 3 gradient), method 0 (raw) or 1
    (the filtered plane in the green of a VP8L stream without its header,
    written by PIL's lossless encoder)."""
    d = alpha.astype(np.int64) - (_alpha_predict(alpha, filt) if filt else 0)
    d = (d % 256).astype(np.uint8)
    if method == 0:
        return bytes([filt << 2]) + d.tobytes()
    from PIL import Image

    rgb = np.zeros(d.shape + (3,), np.uint8)
    rgb[..., 1] = d
    buf = io.BytesIO()
    Image.fromarray(rgb, "RGB").save(buf, "WEBP", lossless=True, quality=100, method=4)
    vp8l = dict(riff_chunks(buf.getvalue()))[b"VP8L"]
    return bytes([(filt << 2) | 1]) + vp8l[5:]


def animation(canvas: tuple, frames) -> bytes:
    """An animated WebP of ``canvas`` (w, h): frames (x, y, chunks), each
    ANMF's image chunks (ALPH and VP8, or VP8L) at the even offset (x, y),
    the frame's size its bitstream's."""
    w, h = canvas
    out = [vp8x(w, h, 0x12), (b"ANIM", struct.pack("<IH", 0xff336699, 0))]
    for x, y, chunks, size in frames:
        fw, fh = size
        head = (struct.pack("<I", x // 2)[:3] + struct.pack("<I", y // 2)[:3] + struct.pack("<I", fw - 1)[:3]
                + struct.pack("<I", fh - 1)[:3] + struct.pack("<I", 100)[:3] + b"\0")
        out.append((b"ANMF", head + b"".join(_riff_chunk(k, b) for k, b in chunks)))
    return webp_file(out)


# RFC 6386's keyframe tables, for the VP8 writer below; the decoder's copies
# (csrc/webp_tables.h) are libwebp's. Read from the C header, so they are
# the same bytes.
def _vp8_tables() -> dict:
    import re

    src = open(os.path.join(HERE, "..", "..", "..", "mvd_tpu_torch", "csrc", "webp_tables.h")).read()
    out = {}
    for m in re.finditer(r"constexpr u?int\d+_t (\w+)((?:\[\d+\])+) = \{(.*?)\};", src, re.S):
        dims = [int(d) for d in re.findall(r"\d+", m.group(2))]
        out[m.group(1)] = np.array([int(v) for v in re.findall(r"-?\d+", m.group(3))]).reshape(dims)
    return out


class BoolEncoder:
    """RFC 6386 section 7.3's boolean entropy encoder."""

    def __init__(self):
        self.out, self.range, self.bottom, self.bit_count = bytearray(), 255, 0, 24

    def _carry(self):
        i = len(self.out) - 1
        while self.out[i] == 255:
            self.out[i] = 0
            i -= 1
        self.out[i] += 1

    def put(self, bit: int, prob: int):
        split = 1 + (((self.range - 1) * prob) >> 8)
        if bit:
            self.bottom += split
            self.range -= split
        else:
            self.range = split
        while self.range < 128:
            self.range <<= 1
            if self.bottom & (1 << 31):
                self._carry()
            self.bottom = (self.bottom << 1) & 0xFFFFFFFF
            self.bit_count -= 1
            if not self.bit_count:
                self.out.append(self.bottom >> 24)
                self.bottom &= (1 << 24) - 1
                self.bit_count = 8

    def value(self, v: int, bits: int):
        for b in range(bits - 1, -1, -1):
            self.put((v >> b) & 1, 128)

    def signed(self, v: int, bits: int):
        self.value(abs(v), bits)
        self.put(int(v < 0), 128)

    def flush(self) -> bytes:
        c, v = self.bit_count, self.bottom
        if v & (1 << (32 - c)):
            self._carry()
        v = (v << (c & 7)) & 0xFFFFFFFF
        for _ in range(c >> 3):
            v = (v << 8) & 0xFFFFFFFF
        for _ in range(4):
            self.out.append(v >> 24)
            v = (v << 8) & 0xFFFFFFFF
        return bytes(self.out)


def _put_tree(e: BoolEncoder, tree, probs, leaf: int):
    """Write ``leaf`` of a libwebp-layout tree (a leaf is -value; node i's
    branches at tree[2i], tree[2i + 1], its probability probs[i])."""
    def path(node):
        for b in (0, 1):
            nxt = tree[2 * node + b]
            if nxt <= 0:
                if -nxt == leaf:
                    return [(node, b)]
            else:
                sub = path(nxt)
                if sub:
                    return [(node, b)] + sub
        return None

    for node, b in path(0):
        e.put(b, int(probs[node]))


def encode_vp8_random(rng, w: int, h: int, **force) -> bytes:
    """A VP8 key frame (the chunk body) of w x h with every header field,
    macroblock mode and coefficient drawn from ``rng``: segments (absolute
    or relative, with or without a map), the loop filter's type, level,
    sharpness and reference/mode deltas, quantizer deltas, 1-8 token
    partitions, probability updates, skip flags, every 16x16, 4x4 and
    chroma mode, and sparse coefficients up to the largest token (their
    dequantized values kept within [-2047, 2047], the range a conforming
    encoder writes). ``force`` fixes header fields by name. Written with
    RFC 6386's boolean encoder; PIL's libwebp is the oracle of its pixels."""
    T = _vp8_tables()
    r = lambda lo, hi: int(rng.integers(lo, hi + 1))
    hdr = dict(segments=r(0, 1), update_map=r(0, 1), update_data=r(0, 1), absolute=r(0, 1),
               filter_type=r(0, 1), level=r(0, 63), sharpness=r(0, 7), lf_adj=r(0, 1), lf_update=r(0, 1),
               log2_parts=r(0, 3), base_q=r(0, 127), use_skip=r(0, 1), skip_p=r(1, 254), proba_updates=r(0, 1))
    hdr.update(force)
    quant_deltas = [r(-15, 15) if rng.random() < 0.4 else None for _ in range(5)]
    e = BoolEncoder()
    e.put(0, 128)  # colour space
    e.put(r(0, 1), 128)  # clamping type
    seg_q, seg_f, seg_probs = [0] * 4, [0] * 4, [255] * 3
    e.put(hdr["segments"], 128)
    if hdr["segments"]:
        e.put(hdr["update_map"], 128)
        e.put(hdr["update_data"], 128)
        if hdr["update_data"]:
            e.put(hdr["absolute"], 128)
            for s in range(4):
                seg_q[s] = r(0, 127) if hdr["absolute"] else r(-30, 30)
                e.put(1, 128)
                e.signed(seg_q[s], 7)
            for s in range(4):
                seg_f[s] = r(0, 63) if hdr["absolute"] else r(-20, 20)
                present = rng.random() < 0.8
                e.put(int(present), 128)
                if present:
                    e.signed(seg_f[s], 6)
                else:
                    seg_f[s] = 0
        if hdr["update_map"]:
            for i in range(3):
                seg_probs[i] = r(1, 255) if rng.random() < 0.7 else 255
                e.put(int(seg_probs[i] != 255), 128)
                if seg_probs[i] != 255:
                    e.value(seg_probs[i], 8)
    e.put(hdr["filter_type"], 128)
    e.value(hdr["level"], 6)
    e.value(hdr["sharpness"], 3)
    e.put(hdr["lf_adj"], 128)
    if hdr["lf_adj"]:
        e.put(hdr["lf_update"], 128)
        if hdr["lf_update"]:
            for _ in range(8):  # 4 reference, 4 mode deltas
                present = rng.random() < 0.6
                e.put(int(present), 128)
                if present:
                    e.signed(r(-63, 63), 6)
    e.value(hdr["log2_parts"], 2)
    e.value(hdr["base_q"], 7)
    for d in quant_deltas:
        e.put(int(d is not None), 128)
        if d is not None:
            e.signed(d, 4)
    e.put(r(0, 1), 128)  # refresh entropy probs
    proba = T["CoeffsProba0"].copy()
    for idx in np.ndindex(proba.shape):
        upd = hdr["proba_updates"] and rng.random() < 0.1
        e.put(int(upd), int(T["CoeffsUpdateProba"][idx]))
        if upd:
            proba[idx] = r(1, 255)
            e.value(int(proba[idx]), 8)
    e.put(hdr["use_skip"], 128)
    if hdr["use_skip"]:
        e.value(hdr["skip_p"], 8)

    # the quantizer steps, to keep dequantized coefficients in range
    def q_of(seg):
        q = (seg_q[seg] + (0 if hdr["absolute"] else hdr["base_q"])) if hdr["segments"] else hdr["base_q"]
        if hdr["segments"] and not hdr["update_data"]:
            q = 0
        d = [x or 0 for x in quant_deltas]
        c = lambda v, m: min(max(v, 0), m)
        return dict(y1=(int(T["kDcTable"][c(q + d[0], 127)]), int(T["kAcTable"][c(q, 127)])),
                    y2=(int(T["kDcTable"][c(q + d[1], 127)]) * 2,
                        max(8, (int(T["kAcTable"][c(q + d[2], 127)]) * 101581) >> 16)),
                    uv=(int(T["kDcTable"][c(q + d[3], 117)]), int(T["kAcTable"][c(q + d[4], 127)])))

    mb_w, mb_h = (w + 15) // 16, (h + 15) // 16
    nparts = 1 << hdr["log2_parts"]
    parts = [BoolEncoder() for _ in range(nparts)]
    intra_t = [0] * (4 * mb_w)
    top_nz, top_nz_dc = [0] * mb_w, [0] * mb_w
    cat_tabs = [T["kCat3"], T["kCat4"], T["kCat5"], T["kCat6"]]
    bands, zigzag = T["kBands"], T["kZigzag"]

    def put_coeffs(p_enc, typ, ctx, first, coeffs):
        """coeffs: 16 values in zigzag order; returns the decoder's nz."""
        last = max([i for i in range(first, 16) if coeffs[i]], default=-1)
        p = proba[typ][bands[first]][ctx]
        n = first
        if last < 0:
            p_enc.put(0, int(p[0]))
            return first
        while n <= last:
            p_enc.put(1, int(p[0]))  # not the end of the block
            while coeffs[n] == 0:
                p_enc.put(0, int(p[1]))
                n += 1
                p = proba[typ][bands[n]][0]
            p_enc.put(1, int(p[1]))
            v = abs(int(coeffs[n]))
            if v == 1:
                p_enc.put(0, int(p[2]))
                nxt = 1
            else:
                p_enc.put(1, int(p[2]))
                if v <= 4:
                    p_enc.put(0, int(p[3]))
                    if v == 2:
                        p_enc.put(0, int(p[4]))
                    else:
                        p_enc.put(1, int(p[4]))
                        p_enc.put(v - 3, int(p[5]))
                elif v <= 10:
                    p_enc.put(1, int(p[3]))
                    p_enc.put(0, int(p[6]))
                    if v <= 6:
                        p_enc.put(0, int(p[7]))
                        p_enc.put(v - 5, 159)
                    else:
                        p_enc.put(1, int(p[7]))
                        p_enc.put((v - 7) >> 1, 165)
                        p_enc.put((v - 7) & 1, 145)
                else:
                    p_enc.put(1, int(p[3]))
                    p_enc.put(1, int(p[6]))
                    cat = 0 if v < 19 else 1 if v < 35 else 2 if v < 67 else 3
                    p_enc.put(cat >> 1, int(p[8]))
                    p_enc.put(cat & 1, int(p[9 + (cat >> 1)]))
                    extra = v - (3 + (8 << cat))
                    tab = [int(t) for t in cat_tabs[cat] if t]
                    for i, prob in enumerate(tab):
                        p_enc.put((extra >> (len(tab) - 1 - i)) & 1, prob)
                nxt = 2
            p_enc.put(int(coeffs[n] < 0), 128)
            n += 1
            if n < 16:
                p = proba[typ][bands[n]][nxt]
        if n < 16:
            p_enc.put(0, int(p[0]))  # end of block
        return n

    def random_block(first, q, density, cap):
        out = [0] * 16
        for i in range(first, 16):
            if rng.random() < density:
                step = q[1] if i else q[0]
                lim = max(1, min(cap, 2047 // step))
                mag = 1 + int(rng.integers(0, lim)) if rng.random() < 0.3 else int(rng.integers(1, min(lim, 4) + 1))
                out[i] = mag if rng.random() < 0.5 else -mag
        return out

    for mb_y in range(mb_h):
        intra_l = [0] * 4
        left_nz, left_nz_dc = 0, 0
        tokens = parts[mb_y & (nparts - 1)]
        for mb_x in range(mb_w):
            seg = r(0, 3) if hdr["segments"] and hdr["update_map"] else 0
            if hdr["segments"] and hdr["update_map"]:
                if seg < 2:
                    e.put(0, seg_probs[0])
                    e.put(seg, seg_probs[1])
                else:
                    e.put(1, seg_probs[0])
                    e.put(seg - 2, seg_probs[2])
            skip = r(0, 1) if hdr["use_skip"] and rng.random() < 0.3 else 0
            if hdr["use_skip"]:
                e.put(skip, hdr["skip_p"])
            i4 = r(0, 1)
            e.put(1 - i4, 145)
            if not i4:
                ymode = r(0, 3)  # DC, TM, V, H
                if ymode in (1, 3):
                    e.put(1, 156)
                    e.put(int(ymode == 1), 128)
                else:
                    e.put(0, 156)
                    e.put(int(ymode == 2), 163)
                intra_t[4 * mb_x:4 * mb_x + 4] = [ymode] * 4
                intra_l = [ymode] * 4
            else:
                for y in range(4):
                    ym = intra_l[y]
                    for x in range(4):
                        mode = r(0, 9)
                        _put_tree(e, T["kYModesIntra4"], T["kBModesProba"][intra_t[4 * mb_x + x]][ym], mode)
                        ym = mode
                        intra_t[4 * mb_x + x] = mode
                    intra_l[y] = ym
            uv = r(0, 3)
            e.put(int(uv != 0), 142)
            if uv:
                e.put(int(uv != 2), 114)
                if uv != 2:
                    e.put(int(uv == 1), 183)
            # residuals, with the decoder's non-zero contexts
            if skip:
                top_nz[mb_x], left_nz = 0, 0
                if not i4:
                    top_nz_dc[mb_x] = left_nz_dc = 0
                continue
            q = q_of(seg)
            density = rng.choice([0.0, 0.1, 0.4, 0.9])
            first = 0 if i4 else 1
            if not i4:
                dc = random_block(0, q["y2"], density, 500 // 16)
                nz = put_coeffs(tokens, 1, top_nz_dc[mb_x] + left_nz_dc, 0, dc)
                top_nz_dc[mb_x] = left_nz_dc = int(nz > 0)
            tnz, lnz = top_nz[mb_x] & 0x0F, left_nz & 0x0F
            for y in range(4):
                l = lnz & 1
                for x in range(4):
                    nz = put_coeffs(tokens, 0 if not i4 else 3, l + (tnz & 1), first,
                                    random_block(first, q["y1"], density, 2047))
                    l = int(nz > first)
                    tnz = (tnz >> 1) | (l << 7)
                tnz >>= 4
                lnz = (lnz >> 1) | (l << 7)
            out_t, out_l = tnz, lnz >> 4
            for ch in (0, 2):
                tnz = top_nz[mb_x] >> (4 + ch)
                lnz = left_nz >> (4 + ch)
                for y in range(2):
                    l = lnz & 1
                    for x in range(2):
                        nz = put_coeffs(tokens, 2, l + (tnz & 1), 0, random_block(0, q["uv"], density, 2047))
                        l = int(nz > 0)
                        tnz = (tnz >> 1) | (l << 3)
                    tnz >>= 2
                    lnz = (lnz >> 1) | (l << 5)
                out_t |= (tnz << 4) << ch
                out_l |= (lnz & 0xF0) << ch
            top_nz[mb_x], left_nz = out_t & 0xFF, out_l & 0xFF
    first_part = e.flush()
    data = [p.flush() for p in parts]
    tag = (len(first_part) << 5) | (1 << 4) | (r(0, 3) << 1)  # key frame, shown, a profile 0-3
    out = bytearray(struct.pack("<I", tag)[:3]) + b"\x9d\x01\x2a" + struct.pack("<HH", w, h)
    out += first_part
    for d in data[:-1]:
        out += struct.pack("<I", len(d))[:3]
    for d in data:
        out += d
    return bytes(out)


def _pil_webp(img: np.ndarray, **options) -> bytes:
    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray(img).save(buf, "WEBP", **options)
    return buf.getvalue()


def _webp_images(rng):
    """name -> an image each lossless form is made of: an RGBA
    gradient (predictor, cross-colour, subtract-green), a noisy photo-like
    RGB one, and palettes of 2, 4, 16 and 200 colours (colour indexing with
    8, 4, 2 and 1 pixels a byte)."""
    h, w = 37, 53
    y, x = np.mgrid[:h, :w]
    gradient = np.stack([(3 * x + 2 * y) % 256, (x * y) % 256, (5 * y) % 256, 255 - (2 * x) % 256], -1)
    photo = np.clip(np.stack([x * 4 + y, y * 6, 255 - x * 3], -1) + rng.integers(0, 24, (h, w, 3)), 0, 255)
    out = {"gradient": gradient.astype(np.uint8), "photo": photo.astype(np.uint8)}
    for n in (2, 4, 16, 200):
        pal = rng.integers(0, 256, (n, 4)).astype(np.uint8)
        pal[:, 3] = np.where(np.arange(n) % 3 == 0, 255, pal[:, 3])
        out[f"pal{n}"] = pal[(x // 3 + y // 2 + rng.integers(0, 2, (h, w))) % n]
    return out


def _render_512():
    """The 512² procedural render of seed 0 (RGBA, most of it transparent)
    that the card fixtures hold."""
    sys.path.insert(0, os.path.abspath(os.path.join(HERE, "..", "..", "..")))
    from mvd_tpu_torch.tools.procedural import object_cameras, render_view, sample_object

    rng = np.random.default_rng(0)
    prims = sample_object(rng)
    return render_view(prims, object_cameras(rng, 1)[0], 512)


def webp_fixtures() -> tuple:
    """name -> WebP bytes, and name -> extra digest entries (the sha256 of
    the RGBA a lossless file with ``exact`` must decode to)."""
    from PIL import Image

    rng = np.random.default_rng(19)
    files, extra = {}, {}
    imgs = _webp_images(rng)
    for name, img in imgs.items():  # lossless: every method, several qualities
        for method, quality in ((0, 0), (2, 25), (4, 75), (6, 100)) if name in ("gradient", "photo") else ((3, 50),):
            files[f"webp_ll_{name}_m{method}_q{quality}.webp"] = _pil_webp(img, lossless=True, method=method,
                                                                           quality=quality, exact=True)
            extra[f"webp_ll_{name}_m{method}_q{quality}.webp"] = {
                "source_sha256": hashlib.sha256(img.tobytes()).hexdigest()}
    for m in (1, 5):
        files[f"webp_ll_photo_m{m}_q90.webp"] = _pil_webp(imgs["photo"], lossless=True, method=m, quality=90)
    files["webp_ll_gradient_inexact.webp"] = _pil_webp(imgs["gradient"], lossless=True)  # transparent RGB rewritten
    one = rng.integers(0, 256, (1, 1, 4)).astype(np.uint8)
    files["webp_ll_1x1.webp"] = _pil_webp(one, lossless=True, exact=True)
    files["webp_lossy_1x1.webp"] = _pil_webp(one[..., :3].copy(), quality=80)
    files["webp_alpha_1x1.webp"] = _pil_webp(one, quality=80)
    for h, w in ((3, 5), (17, 2), (31, 33)):  # odd sizes: the crop and the upsampler's edges
        img = rng.integers(0, 256, (h, w, 4)).astype(np.uint8)
        files[f"webp_ll_{h}x{w}.webp"] = _pil_webp(img, lossless=True, exact=True)
        files[f"webp_lossy_{h}x{w}.webp"] = _pil_webp(img[..., :3].copy(), quality=70)
        files[f"webp_alpha_{h}x{w}.webp"] = _pil_webp(img, quality=70)
    photo = imgs["photo"]
    for q in (0, 10, 25, 50, 75, 90, 100):  # lossy: the quantizer range
        files[f"webp_lossy_q{q}.webp"] = _pil_webp(photo, quality=q, method=4)
    rgba = imgs["gradient"].copy()
    rgba[..., 3] = np.where((np.arange(53)[None] + np.arange(37)[:, None]) % 7 < 2, 0, rgba[..., 3])
    for aq in (0, 40, 100):  # lossy with alpha: the alpha levels
        files[f"webp_alpha_aq{aq}.webp"] = _pil_webp(rgba, quality=80, alpha_quality=aq)
    # the features PIL's save cannot select, from libwebp's encoder
    big = np.clip(np.stack([np.mgrid[:96, :112][1] * 2, np.mgrid[:96, :112][0] * 3,
                            (np.mgrid[:96, :112][0] * np.mgrid[:96, :112][1]) % 256, np.full((96, 112), 255)], -1)
                  + rng.integers(0, 40, (96, 112, 4)) * np.array([1, 1, 1, 0]), 0, 255).astype(np.uint8)
    files["webp_simple_filter.webp"] = webp_encode(big, filter_type=0, filter_strength=60)
    files["webp_strong_filter.webp"] = webp_encode(big, filter_type=1, filter_strength=100, sns_strength=100)
    for parts in (1, 2, 3):  # libwebp 1.2 writes one partition at method 3 and up
        files[f"webp_parts{1 << parts}.webp"] = webp_encode(big, partitions=parts, quality=60, method=2)
    for seg in (1, 2, 3, 4):
        files[f"webp_segments{seg}.webp"] = webp_encode(big, segments=seg, sns_strength=80, quality=50)
    for sharp in (1, 5, 7):
        files[f"webp_sharpness{sharp}.webp"] = webp_encode(big, filter_sharpness=sharp, filter_strength=80)
    files["webp_no_filter.webp"] = webp_encode(big, filter_strength=0)
    alpha_img = big.copy()
    alpha_img[..., 3] = np.clip(np.mgrid[:96, :112][1] * 2 + rng.integers(0, 3, (96, 112)), 0, 255)
    files["webp_alpha_raw.webp"] = webp_encode(alpha_img, alpha_compression=0)
    files["webp_alpha_best.webp"] = webp_encode(alpha_img, alpha_filtering=2)
    lossy = dict(riff_chunks(webp_encode(alpha_img[..., :3].copy(), quality=70)))[b"VP8 "]
    for filt, fname in enumerate(("none", "horizontal", "vertical", "gradient")):
        for method in (0, 1):
            files[f"webp_alph_{fname}_m{method}.webp"] = webp_file(
                [vp8x(112, 96, 0x10), (b"ALPH", alpha_chunk(alpha_img[..., 3], filt, method)), (b"VP8 ", lossy)])
    # header fields libwebp's encoder never writes, from the random VP8
    # writer: loop-filter reference and mode deltas (normal and simple
    # filter), segments relative to the base quantizer and filter level, and
    # segments enabled without data (every segment at quantizer 0)
    for name, force in (("lf_deltas", dict(lf_adj=1, lf_update=1, filter_type=0, level=36, sharpness=2)),
                        ("lf_deltas_simple", dict(lf_adj=1, lf_update=1, filter_type=1, level=20)),
                        ("relative_segments", dict(segments=1, update_map=1, update_data=1, absolute=0, level=30,
                                                   lf_adj=0)),
                        ("segments_no_data", dict(segments=1, update_map=1, update_data=0, level=12))):
        files[f"webp_vp8_{name}.webp"] = webp_file([(b"VP8 ", encode_vp8_random(rng, 61, 45, **force))])
    # animations: PIL's own (frame 1 full size), and a first frame at an
    # offset of a larger canvas, lossless and lossy with alpha
    frames = [Image.fromarray(imgs["gradient"]), Image.fromarray(imgs["pal16"])]
    buf = io.BytesIO()
    frames[0].save(buf, "WEBP", save_all=True, append_images=frames[1:], duration=100, lossless=True)
    files["webp_anim_pil.webp"] = buf.getvalue()
    small = imgs["pal200"][:10, :20]
    ll = dict(riff_chunks(_pil_webp(small, lossless=True, exact=True)))[b"VP8L"]
    files["webp_anim_offset_lossless.webp"] = animation((40, 30), [(6, 4, [(b"VP8L", ll)], (20, 10)),
                                                                   (0, 0, [(b"VP8L", ll)], (20, 10))])
    al = riff_chunks(_pil_webp(small, quality=60))
    files["webp_anim_offset_alpha.webp"] = animation((41, 31), [(20, 20, [c for c in al if c[0] != b"VP8X"],
                                                                  (20, 10))])
    # the card fixtures: CO3D's frame lossy at quality 90; the procedural
    # render lossless with exact (its own pixels) and lossy with alpha
    frame = np.asarray(Image.open(os.path.join(JPEG_DIR, "frame_a.jpg")).convert("RGB"))
    files["webp_frame_a_q90.webp"] = _pil_webp(frame, quality=90)
    render = _render_512()
    files["webp_render_lossless.webp"] = _pil_webp(render, lossless=True, exact=True)
    extra["webp_render_lossless.webp"] = {"source_sha256": hashlib.sha256(render.tobytes()).hexdigest()}
    files["webp_render_alpha.webp"] = _pil_webp(render, quality=90)
    return files, extra


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
    from PIL import Image

    digests, extra = {}, {}
    files = dict(png_fixtures())
    files.update(jpeg_fixtures())
    for name, (data, twin) in arithmetic_fixtures().items():
        files[name] = data
        if twin is not None:
            files["twin_" + name] = twin
            extra[name] = {"huffman_twin": "twin_" + name}
    for name, (data, source) in lossless_fixtures().items():
        files[name] = data
        if source is not None:
            extra[name] = {"source_sha256": hashlib.sha256(source.tobytes()).hexdigest()}
    # phase 9d's smoothed source, from CO3D's frame (frame_a.jpg's pixels)
    frame = np.asarray(Image.open(os.path.join(JPEG_DIR, "frame_a.jpg")).convert("RGB"))
    files["frame_a_smooth.jpg"] = smoothed_frame(frame)
    webp, webp_extra = webp_fixtures()
    files.update(webp)
    extra.update(webp_extra)
    for name, data in sorted(files.items()):
        with open(os.path.join(out_dir, name), "wb") as fh:
            fh.write(data)
        digests[name] = pil_digest(data)
        digests[name].update(extra.get(name, {}))
    with open(os.path.join(out_dir, "pil_sha256.json"), "w") as fh:
        json.dump(digests, fh, indent=1, sort_keys=True)
        fh.write("\n")
    return 0


if __name__ == "__main__":
    sys.exit(main(*sys.argv[1:]))
