"""PIL's ``convert("RGB")`` of a LAB image, without PIL or LittleCMS (host:
the standard library and numpy).

PIL 12.1.0 converts LAB to RGB through ImageCms: a LittleCMS 2.17
transform from ``createProfile("LAB")`` (``cmsCreateLab2Profile``, D50) to
``createProfile("sRGB")`` (``cmsCreate_sRGBProfile``), perceptual intent,
8-bit Lab in (PIL's LAB bytes: L, then a and b offset by 128) and 8-bit
RGB out. LittleCMS optimizes that pipeline by resampling
(``OptimizeByResampling``): it evaluates the float pipeline (Lab -> XYZ,
the matrix from XYZ to linear sRGB, the sRGB curve's analytic inverse) at
the 33 x 33 x 33 nodes of a 16-bit table (``XFormSampler16``), and each
pixel is the table's tetrahedral interpolation (``TetrahedralInterp16``) of
the pixel's 16-bit value, cut to 8 bits. This module copies each step: the
profile's matrix from Rec. 709's primaries and D65 (0.3127, 0.3290),
adapted to D50 by Bradford, as ``_cmsBuildRGB2XYZtransferMatrix`` builds
it; float32 between the pipeline's stages as ``_LUTevalFloat`` keeps them;
``_cmsQuickSaturateWord``'s rounding; the interpolation's fixed point.
Every one of the 2^24 inputs gives PIL's pixel (measured against PIL 12.1.0
with LittleCMS 2.17).
"""
from __future__ import annotations

import functools
import math

import numpy as np

GRID = 33  # _cmsReasonableGridpointsByColorspace of three channels
D50 = (0.9642, 1.0, 0.8249)
BRADFORD = ((0.8951, 0.2664, -0.1614), (-0.7502, 1.7135, 0.0367), (0.0389, -0.0685, 1.0296))
MAX_ENCODEABLE_XYZ = 1.0 + 32767.0 / 32768.0
# the sRGB curve's parameters (Build_sRGBGamma: type 4)
SRGB = (2.4, 1.0 / 1.055, 0.055 / 1.055, 1.0 / 12.92, 0.04045)


def _inverse(a):
    """_cmsMAT3inverse."""
    c0 = a[1][1] * a[2][2] - a[1][2] * a[2][1]
    c1 = -a[1][0] * a[2][2] + a[1][2] * a[2][0]
    c2 = a[1][0] * a[2][1] - a[1][1] * a[2][0]
    det = a[0][0] * c0 + a[0][1] * c1 + a[0][2] * c2
    return [[c0 / det, (a[0][2] * a[2][1] - a[0][1] * a[2][2]) / det, (a[0][1] * a[1][2] - a[0][2] * a[1][1]) / det],
            [c1 / det, (a[0][0] * a[2][2] - a[0][2] * a[2][0]) / det, (a[0][2] * a[1][0] - a[0][0] * a[1][2]) / det],
            [c2 / det, (a[0][1] * a[2][0] - a[0][0] * a[2][1]) / det, (a[0][0] * a[1][1] - a[0][1] * a[1][0]) / det]]


def _product(a, b):
    """_cmsMAT3per."""
    return [[a[i][0] * b[0][j] + a[i][1] * b[1][j] + a[i][2] * b[2][j] for j in range(3)] for i in range(3)]


def _apply(a, v):
    """_cmsMAT3eval."""
    return [a[i][0] * v[0] + a[i][1] * v[1] + a[i][2] * v[2] for i in range(3)]


def srgb_matrix():
    """The sRGB profile's colorants (RGB -> XYZ, D50), as
    ``cmsCreateRGBProfile`` computes them."""
    xn, yn = 0.3127, 0.3290
    (xr, yr), (xg, yg), (xb, yb) = (0.64, 0.33), (0.30, 0.60), (0.15, 0.06)
    coef = _apply(_inverse([[xr, xg, xb], [yr, yg, yb], [1 - xr - yr, 1 - xg - yg, 1 - xb - yb]]),
                  [xn / yn, 1.0, (1.0 - xn - yn) / yn])
    rgb2xyz = [[coef[0] * xr, coef[1] * xg, coef[2] * xb], [coef[0] * yr, coef[1] * yg, coef[2] * yb],
               [coef[0] * (1.0 - xr - yr), coef[1] * (1.0 - xg - yg), coef[2] * (1.0 - xb - yb)]]
    # _cmsAdaptMatrixToD50: Bradford from the white point's XYZ to D50's
    white = [(xn / yn) * 1.0, 1.0, ((1 - xn - yn) / yn) * 1.0]
    src, dst = _apply(BRADFORD, white), _apply(BRADFORD, D50)
    cone = [[dst[0] / src[0], 0.0, 0.0], [0.0, dst[1] / src[1], 0.0], [0.0, 0.0, dst[2] / src[2]]]
    adapt = _product(_inverse(BRADFORD), _product(cone, BRADFORD))
    return _product(adapt, rgb2xyz)


def _f32(v: float) -> float:
    return float(np.float32(v))


def _saturate_word(d: float) -> int:
    """_cmsQuickSaturateWord: + 0.5, clamped, floored after rounding to
    1/65536 (its magic-number floor)."""
    d += 0.5
    if d <= 0:
        return 0
    if d >= 65535.0:
        return 0xFFFF
    return int(math.floor(round((d - 32767.0) * 65536.0) / 65536.0)) + 32767


def _f_1(t: float) -> float:
    """cmsLab2XYZ's inverse of the Lab companding."""
    if t <= 24.0 / 116.0:
        return (108.0 / 841.0) * (t - (16.0 / 116.0))
    return t * t * t


def _curve_inverse(r: float) -> float:
    """The sRGB curve's analytic inverse (parametric type -4), in
    double."""
    g, a, b, c, d = SRGB
    e = a * d + b
    disc = 0.0 if e < 0 else math.pow(e, g)
    if r >= disc:
        return (math.pow(r, 1.0 / g) - b) / a
    return r / c


@functools.lru_cache(maxsize=1)
def clut() -> np.ndarray:
    """The 16-bit table (33^3 nodes, L slowest, 3 outputs a node) of
    ``XFormSampler16`` over the Lab -> sRGB pipeline."""
    inv = [[v * MAX_ENCODEABLE_XYZ for v in row] for row in _inverse(srgb_matrix())]
    nodes = [_saturate_word(i * 65535.0 / (GRID - 1)) for i in range(GRID)]
    out = np.empty((GRID, GRID, GRID, 3), np.int64)
    for i, li in enumerate(nodes):
        lab_l = _f32(li / 65535.0) * 100.0
        y = (lab_l + 16.0) / 116.0
        yy = _f32(_f_1(y) * D50[1] / MAX_ENCODEABLE_XYZ)
        for j, aj in enumerate(nodes):
            xx = _f32(_f_1(y + 0.002 * (_f32(aj / 65535.0) * 255.0 - 128.0)) * D50[0] / MAX_ENCODEABLE_XYZ)
            for k, bk in enumerate(nodes):
                zz = _f32(_f_1(y - 0.005 * (_f32(bk / 65535.0) * 255.0 - 128.0)) * D50[2] / MAX_ENCODEABLE_XYZ)
                for ch in range(3):
                    lin = _f32(xx * inv[ch][0] + yy * inv[ch][1] + zz * inv[ch][2])
                    out[i, j, k, ch] = _saturate_word(_f32(_curve_inverse(lin)) * 65535.0)
    return out


def _fixed_domain(a: np.ndarray) -> np.ndarray:
    """_cmsToFixedDomain."""
    return a + ((a + 0x7FFF) // 0xFFFF)


def lab_to_rgb(lab: np.ndarray) -> np.ndarray:
    """(..., >= 3) uint8 LAB as PIL stores it -> (..., 3) uint8 RGB, PIL's
    ``convert("RGB")``: each channel's 16-bit value (x * 257) interpolated
    in ``clut`` as ``TetrahedralInterp16`` interpolates it, then
    ``FROM_16_TO_8``."""
    table = clut().reshape(-1)
    shape = lab.shape[:-1]
    v = [lab[..., c].reshape(-1).astype(np.int64) * 257 for c in range(3)]
    f = [_fixed_domain(x * (GRID - 1)) for x in v]
    r = [x & 0xFFFF for x in f]
    base = sum((x >> 16) * step for x, step in zip(f, (3 * GRID * GRID, 3 * GRID, 3)))
    x1, y1, z1 = (np.where(x == 0xFFFF, 0, step) for x, step in zip(v, (3 * GRID * GRID, 3 * GRID, 3)))
    rx, ry, rz = r
    # the six tetrahedra of TetrahedralInterp16 and, for each, the corners
    # its three steps reach and the weight of each step
    cases = [(rx >= ry) & (ry >= rz), (rx >= ry) & (ry < rz) & (rz >= rx), (rx >= ry) & (ry < rz) & (rz < rx),
             (rx < ry) & (rx >= rz), (rx < ry) & (rx < rz) & (ry >= rz), (rx < ry) & (rx < rz) & (ry < rz)]
    p = np.select(cases, [x1, z1, x1, y1, y1, z1])
    q = np.select(cases, [x1 + y1, x1 + z1, x1 + z1, x1 + y1, y1 + z1, y1 + z1])
    s = x1 + y1 + z1
    w1 = np.select(cases, [rx, rz, rx, ry, ry, rz])
    w2 = np.select(cases, [ry, rx, rz, rx, rz, ry])
    w3 = np.select(cases, [rz, ry, ry, rz, rx, rx])
    out = np.empty((v[0].size, 3), np.int64)
    for ch in range(3):
        c0, cp, cq, cs = (table[base + off + ch] for off in (0, p, q, s))
        rest = (cp - c0) * w1 + (cq - cp) * w2 + (cs - cq) * w3 + 0x8001
        out[:, ch] = (c0 + ((rest + (rest >> 16)) >> 16)) & 0xFFFF
    return (((out * 65281 + 8388608) >> 24) & 0xFF).astype(np.uint8).reshape(shape + (3,))
