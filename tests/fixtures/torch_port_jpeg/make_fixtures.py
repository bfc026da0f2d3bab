"""Write the JPEG fixtures of ``tests/test_torch_port_readers.py`` and
``chip_smoke.py`` phase 9, and ``pil_sha256.json``: for each file, the
sha256 and shape of what PIL decodes it to (``Image.open(...).convert("RGB")``).

    python tests/fixtures/torch_port_jpeg/make_fixtures.py

Most files are written by PIL's encoder (4:4:4, 4:2:2, 4:2:0, gray, odd
sizes, restart markers, a progressive and a CMYK file, and two 1067x800
frames at CO3D's size). PIL cannot write 4:4:0, 4:1:1, scans of one
component or components named R, G, B, so ``encode_baseline`` below writes
those: a plain baseline encoder (float DCT, one quantization table,
fixed-length Huffman codes). The files are made from fixed seeds, so the
script writes the same bytes on every run with the same PIL.
"""

from __future__ import annotations

import hashlib
import io
import json
import math
import os
import struct
import sys

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
_ZIGZAG = np.array([
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5, 12, 19, 26, 33, 40, 48, 41, 34, 27, 20,
    13, 6, 7, 14, 21, 28, 35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51, 58, 59,
    52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63])


def photo(h: int, w: int, c: int, seed: int, noise: int = 48) -> np.ndarray:
    """Gradients plus noise: every block has AC energy."""
    y, x = np.mgrid[:h, :w]
    rng = np.random.default_rng(seed)
    base = np.stack([3 * x + 5 * y + 40 * k for k in range(c)], -1)
    return ((base + rng.integers(0, noise, (h, w, c))) % 256).astype(np.uint8)


def frame(h: int, w: int, seed: int) -> np.ndarray:
    """A smooth frame at CO3D's size: low-frequency waves and a little noise."""
    y, x = np.mgrid[:h, :w].astype(np.float64)
    rng = np.random.default_rng(seed)
    chans = []
    for k in range(3):
        fx, fy, ph = rng.uniform(1, 4), rng.uniform(1, 4), rng.uniform(0, 6)
        v = 128 + 70 * np.sin(2 * np.pi * (fx * x / w + fy * y / h) + ph) + 40 * np.cos(
            2 * np.pi * (x * y) / (w * h) * 3 + k)
        chans.append(v + rng.normal(0, 2, (h, w)))
    return np.clip(np.stack(chans, -1), 0, 255).round().astype(np.uint8)


class _Bits:
    def __init__(self):
        self.out = bytearray()
        self.acc = 0
        self.n = 0

    def put(self, value: int, length: int):
        for i in range(length - 1, -1, -1):
            self.acc = (self.acc << 1) | ((value >> i) & 1)
            self.n += 1
            if self.n == 8:
                self.out.append(self.acc)
                if self.acc == 0xFF:
                    self.out.append(0)
                self.acc, self.n = 0, 0

    def flush(self):
        while self.n:
            self.put(1, 1)


def _category(v: int) -> int:
    return 0 if v == 0 else int(abs(v)).bit_length()


def _segment(marker: int, body: bytes) -> bytes:
    return struct.pack(">BBH", 0xFF, marker, len(body) + 2) + body


def encode_baseline(planes, sampling, ids=(1, 2, 3), quality_table=None, restart=0,
                    interleaved=True, jfif=True) -> bytes:
    """A baseline JPEG of ``planes`` (one uint8 array a component, each
    already at its own sampled size) with the given (h, v) sampling factors
    and component ids, one quantization table, one fixed-length Huffman
    code per table class, ``restart`` MCUs a restart interval (0: none) and
    either one interleaved scan or one scan a component."""
    q = np.full(64, 4, np.int64) if quality_table is None else np.asarray(quality_table, np.int64)
    hmax = max(h for h, _ in sampling)
    vmax = max(v for _, v in sampling)
    H, W = planes[0].shape  # component 0 has the largest sampling factors
    n = np.arange(8)
    basis = np.cos((2 * n[:, None] + 1) * n[None, :] * np.pi / 16)  # [sample, frequency]
    cu = np.where(n == 0, 1 / math.sqrt(2), 1.0)
    mcux, mcuy = -(-W // (8 * hmax)), -(-H // (8 * vmax))
    several = interleaved and len(planes) > 1

    def zigzag_blocks(ci: int) -> np.ndarray:
        """(blocks high, blocks wide, 64) quantized coefficients, zigzag order."""
        h, v = sampling[ci]
        p = planes[ci].astype(np.float64) - 128
        bw = mcux * h if several else -(-p.shape[1] // 8)
        bh = mcuy * v if several else -(-p.shape[0] // 8)
        padded = np.pad(p, ((0, bh * 8 - p.shape[0]), (0, bw * 8 - p.shape[1])), mode="edge")
        blk = padded.reshape(bh, 8, bw, 8).transpose(0, 2, 1, 3)
        coef = np.einsum("abyx,yi,xj->abij", blk, basis, basis) * (cu[:, None] * cu[None, :]) / 4
        natural = np.round(coef.reshape(bh, bw, 64) / q).astype(np.int64)
        return natural[..., _ZIGZAG]

    coefs = [zigzag_blocks(ci) for ci in range(len(planes))]

    def scan_units(comps):
        if len(comps) > 1:
            for my in range(mcuy):
                for mx in range(mcux):
                    yield [(ci, my * sampling[ci][1] + vv, mx * sampling[ci][0] + hh)
                           for ci in comps for vv in range(sampling[ci][1])
                           for hh in range(sampling[ci][0])]
        else:
            ci = comps[0]
            for by in range(coefs[ci].shape[0]):
                for bx in range(coefs[ci].shape[1]):
                    yield [(ci, by, bx)]

    def table(syms):
        """Fixed-length codes: symbol i gets code i (never all ones)."""
        length = max(1, math.ceil(math.log2(len(syms) + 1)))
        bits = [0] * 16
        bits[length - 1] = len(syms)
        return {s: (i, length) for i, s in enumerate(syms)}, bytes(bits) + bytes(syms)

    dc_syms = list(range(12))
    ac_syms = [0x00, 0xF0] + [(r << 4) | s for r in range(16) for s in range(1, 11)]
    dc_code, dc_body = table(dc_syms)
    ac_code, ac_body = table(ac_syms)

    out = bytearray(b"\xff\xd8")
    if jfif:
        out += _segment(0xE0, b"JFIF\x00\x01\x01\x00\x00\x01\x00\x01\x00\x00")
    out += _segment(0xDB, bytes([0]) + bytes(int(x) for x in q[_ZIGZAG]))
    sof = struct.pack(">BHHB", 8, H, W, len(planes))
    for ci, (h, v) in enumerate(sampling):
        sof += bytes([ids[ci], (h << 4) | v, 0])
    out += _segment(0xC0, sof)
    out += _segment(0xC4, bytes([0x00]) + dc_body + bytes([0x10]) + ac_body)
    if restart:
        out += _segment(0xDD, struct.pack(">H", restart))
    scans = [list(range(len(planes)))] if interleaved else [[ci] for ci in range(len(planes))]
    for comps in scans:
        sos = bytes([len(comps)]) + b"".join(bytes([ids[ci], 0x00]) for ci in comps) + b"\x00\x3f\x00"
        out += _segment(0xDA, sos)
        bits = _Bits()
        pred = [0] * len(planes)
        for m, unit in enumerate(scan_units(comps)):
            if restart and m and m % restart == 0:
                bits.flush()
                bits.out += bytes([0xFF, 0xD0 + ((m // restart - 1) & 7)])
                pred = [0] * len(planes)
            for ci, by, bx in unit:
                blk = coefs[ci][by, bx]
                diff = int(blk[0]) - pred[ci]
                pred[ci] = int(blk[0])
                s = _category(diff)
                bits.put(*dc_code[s])
                if s:
                    bits.put(diff if diff > 0 else diff + (1 << s) - 1, s)
                run = 0
                for k in range(1, 64):
                    v = int(blk[k])
                    if v == 0:
                        run += 1
                        continue
                    while run > 15:
                        bits.put(*ac_code[0xF0])
                        run -= 16
                    s = _category(v)
                    bits.put(*ac_code[(run << 4) | s])
                    bits.put(v if v > 0 else v + (1 << s) - 1, s)
                    run = 0
                if run:
                    bits.put(*ac_code[0x00])
        bits.flush()
        out += bits.out
    out += b"\xff\xd9"
    return bytes(out)


def _ycc(rgb: np.ndarray):
    r, g, b = (rgb[..., i].astype(np.float64) for i in range(3))
    y = 0.299 * r + 0.587 * g + 0.114 * b
    cb = 128 - 0.168736 * r - 0.331264 * g + 0.5 * b
    cr = 128 + 0.5 * r - 0.418688 * g - 0.081312 * b
    return [np.clip(np.round(c), 0, 255).astype(np.uint8) for c in (y, cb, cr)]


def _down(p: np.ndarray, fy: int, fx: int) -> np.ndarray:
    h, w = -(-p.shape[0] // fy), -(-p.shape[1] // fx)
    padded = np.pad(p.astype(np.float64), ((0, h * fy - p.shape[0]), (0, w * fx - p.shape[1])),
                    mode="edge")
    return np.round(padded.reshape(h, fy, w, fx).mean((1, 3))).astype(np.uint8)


def _pil(arr: np.ndarray, mode: str = None, **options) -> bytes:
    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray(arr, mode).save(buf, "JPEG", **options)
    return buf.getvalue()


def fixtures():
    """name -> JPEG bytes."""
    a = photo(37, 53, 3, seed=1)
    y, cb, cr = _ycc(a)
    f = {
        "s444.jpg": _pil(a, quality=90, subsampling=0),
        "s422.jpg": _pil(a, quality=90, subsampling=1),
        "s420.jpg": _pil(a, quality=90, subsampling=2),
        "s420_q10.jpg": _pil(photo(61, 29, 3, seed=2), quality=10, subsampling=2),
        "s420_q100.jpg": _pil(photo(16, 16, 3, seed=3), quality=100, subsampling=2),
        "s420_rst.jpg": _pil(photo(45, 67, 3, seed=4), quality=80, subsampling=2, restart_marker_blocks=1),
        "s422_rst_rows.jpg": _pil(photo(61, 29, 3, seed=5), quality=80, subsampling=1,
                                  restart_marker_rows=1),
        "s420_3x5.jpg": _pil(photo(5, 3, 3, seed=6), quality=90, subsampling=2),
        "s420_1x1.jpg": _pil(photo(1, 1, 3, seed=7), quality=90, subsampling=2),
        "gray.jpg": _pil(a[..., 0], "L", quality=85),
        "gray_rst.jpg": _pil(photo(33, 70, 1, seed=8)[..., 0], "L", quality=70, restart_marker_blocks=2),
        "s440.jpg": encode_baseline([y, _down(cb, 2, 1), _down(cr, 2, 1)], [(1, 2), (1, 1), (1, 1)]),
        "s440_rst.jpg": encode_baseline([y, _down(cb, 2, 1), _down(cr, 2, 1)], [(1, 2), (1, 1), (1, 1)],
                                        restart=2),
        "s411.jpg": encode_baseline([y, _down(cb, 1, 4), _down(cr, 1, 4)], [(4, 1), (1, 1), (1, 1)]),
        "s420_scans.jpg": encode_baseline([y, _down(cb, 2, 2), _down(cr, 2, 2)], [(2, 2), (1, 1), (1, 1)],
                                          interleaved=False, restart=3),
        "rgb_ids.jpg": encode_baseline([a[..., 0], a[..., 1], a[..., 2]], [(1, 1)] * 3, ids=(82, 71, 66),
                                       jfif=False),
        "progressive.jpg": _pil(a, quality=90, progressive=True),
        "cmyk.jpg": _pil(np.dstack([a, a[..., :1]]), "CMYK", quality=90),
        "frame_a.jpg": _pil(frame(800, 1067, seed=10), quality=85, subsampling=2),
        "frame_b.jpg": _pil(frame(800, 1067, seed=11), quality=85, subsampling=2),
    }
    return f


def main(out_dir: str = HERE) -> int:
    from PIL import Image

    digests = {}
    for name, data in fixtures().items():
        with open(os.path.join(out_dir, name), "wb") as fh:
            fh.write(data)
        rgb = np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))
        digests[name] = {"shape": list(rgb.shape), "sha256": hashlib.sha256(rgb.tobytes()).hexdigest(),
                         "bytes": len(data)}
    with open(os.path.join(out_dir, "pil_sha256.json"), "w") as fh:
        json.dump(digests, fh, indent=1, sort_keys=True)
        fh.write("\n")
    return 0


if __name__ == "__main__":
    sys.exit(main(*sys.argv[1:]))
