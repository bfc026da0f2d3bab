"""Procedural multi-view corpus generator (no Blender, no network).

Counterpart of ``tools/rendering/procedural.py``, with the port's own
cameras (``camera.look_at_camera`` / ``to_homogeneous``) and PNG writer
(``utils/images.encode_png``) in place of ``mvd_tpu.camera`` and PIL. It
stays a host numpy ray tracer, as the JAX tool is, so that both write the
same corpus: for the same seed every zip holds the same members in the same
order, the same ``.npy`` bytes, ``prompt.txt`` and ``metadata.json``, and
PNGs that decode to the same RGBA pixels (their bytes differ: the zlib
settings differ).

Renders textured geometric primitives (spheres, boxes, cylinders) at known
look-at cameras and writes per-object zips in the reference render
contract: ``NNN.png`` (RGBA, transparent background) + ``NNN.npy`` (4x4
camera-to-world ``matrix_world``) + ``prompt.txt`` + ``metadata.json``,
which ``data/objaverse.py`` reads. Every target view is a deterministic
function of (object, camera), which is what the view-synthesis experiment
(``EVIDENCE.md``) needs. The rig is the repo's: look-at camera-to-world
matrices with columns (right, up, -forward), ring radius 1.8 and the 35 mm
lens FOV (54.43 deg) that ``camera.ray_grid`` assumes.

    python -m mvd_tpu_torch.tools.procedural --out /data/corpus --num-objects 300
"""

from __future__ import annotations

import argparse
import io
import json
import os
import zipfile
from dataclasses import dataclass
from typing import List, Optional, Sequence

import numpy as np

from ..camera import look_at_camera, to_homogeneous
from ..utils.images import encode_png

FOV_DEG = 54.43  # 35 mm lens on a 36 mm sensor: 2*atan(18/35)

COLORS = {
    "red": (0.85, 0.15, 0.12),
    "green": (0.15, 0.70, 0.20),
    "blue": (0.15, 0.25, 0.85),
    "yellow": (0.90, 0.80, 0.10),
    "purple": (0.55, 0.20, 0.70),
    "orange": (0.95, 0.55, 0.10),
    "cyan": (0.10, 0.75, 0.80),
    "white": (0.90, 0.90, 0.90),
}

LIGHTS = [  # fixed world-frame directional lights (4-sun rig analogue)
    (np.array([0.5, 0.3, 0.8]), 0.75),
    (np.array([-0.6, -0.2, 0.5]), 0.45),
    (np.array([0.1, -0.8, 0.3]), 0.35),
]
AMBIENT = 0.25


@dataclass
class Primitive:
    kind: str  # sphere | box | cylinder
    center: np.ndarray  # (3,)
    size: np.ndarray  # sphere: (r,,); box: half-extents (3,); cyl: (r, half_h,)
    rotation: np.ndarray  # (3,3) object-to-world
    color_name: str
    checker: bool  # checker texture in object-local coords
    checker_scale: float = 3.0


def _rot_z(theta: float) -> np.ndarray:
    c, s = np.cos(theta), np.sin(theta)
    return np.array([[c, -s, 0.0], [s, c, 0.0], [0.0, 0.0, 1.0]])


def sample_object(rng: np.random.Generator) -> List[Primitive]:
    """2-3 primitives with distinct colors, inside the unit-ish cube the
    Blender rig normalizes to (blender_script.py:512-614)."""
    n = int(rng.integers(2, 4))
    kinds = rng.choice(["sphere", "box", "cylinder"], size=n)
    color_names = rng.choice(list(COLORS), size=n, replace=False)
    prims = []
    for i in range(n):
        kind = str(kinds[i])
        center = rng.uniform(-0.45, 0.45, 3)
        center[2] = rng.uniform(-0.25, 0.35)
        if kind == "sphere":
            size = np.array([rng.uniform(0.18, 0.34)])
        elif kind == "box":
            size = rng.uniform(0.14, 0.30, 3)
        else:
            size = np.array([rng.uniform(0.12, 0.24), rng.uniform(0.18, 0.38)])
        prims.append(
            Primitive(
                kind=kind,
                center=center,
                size=size,
                rotation=_rot_z(float(rng.uniform(0, 2 * np.pi))),
                color_name=str(color_names[i]),
                checker=bool(rng.uniform() < 0.5),
                checker_scale=float(rng.uniform(2.0, 5.0)),
            )
        )
    return prims


def object_prompt(prims: Sequence[Primitive]) -> str:
    parts = [
        f"a {'checkered ' if p.checker else ''}{p.color_name} {p.kind}" for p in prims
    ]
    return "a 3D scene of " + " and ".join(parts)


# ---------------------------------------------------------------------------
# ray-primitive intersection (vectorized over N rays)
# ---------------------------------------------------------------------------


def _intersect_sphere(o, d, prim):
    oc = o - prim.center
    r = prim.size[0]
    b = d @ oc  # (N,)
    c = oc @ oc - r * r
    disc = b * b - c
    t = np.where(disc >= 0, -b - np.sqrt(np.maximum(disc, 0.0)), np.inf)
    return np.where(t > 1e-4, t, np.inf)


def _intersect_box(o, d, prim):
    # transform into the box's local frame
    R = prim.rotation
    ol = (o - prim.center) @ R  # R^T @ (o - c)
    dl = d @ R
    h = prim.size
    with np.errstate(divide="ignore", invalid="ignore"):
        inv = 1.0 / dl
        t1 = (-h - ol) * inv
        t2 = (h - ol) * inv
    tmin = np.nanmax(np.minimum(t1, t2), axis=1)
    tmax = np.nanmin(np.maximum(t1, t2), axis=1)
    hit = (tmax >= tmin) & (tmax > 1e-4)
    t = np.where(tmin > 1e-4, tmin, tmax)
    return np.where(hit & (t > 1e-4), t, np.inf)


def _intersect_cylinder(o, d, prim):
    # capped cylinder along local z
    R = prim.rotation
    ol = (o - prim.center) @ R
    dl = d @ R
    r, hh = prim.size[0], prim.size[1]
    a = dl[:, 0] ** 2 + dl[:, 1] ** 2
    b = ol[0] * dl[:, 0] + ol[1] * dl[:, 1]
    c = ol[0] ** 2 + ol[1] ** 2 - r * r
    with np.errstate(divide="ignore", invalid="ignore"):
        disc = b * b - a * c
        sq = np.sqrt(np.maximum(disc, 0.0))
        t_side = np.where((disc >= 0) & (a > 1e-12), (-b - sq) / a, np.inf)
    z_side = ol[2] + t_side * dl[:, 2]
    t_side = np.where(np.abs(z_side) <= hh, t_side, np.inf)
    # caps
    with np.errstate(divide="ignore", invalid="ignore"):
        t_top = (hh - ol[2]) / dl[:, 2]
        t_bot = (-hh - ol[2]) / dl[:, 2]
    for tc in (t_top, t_bot):
        xc = ol[0] + tc * dl[:, 0]
        yc = ol[1] + tc * dl[:, 1]
        ok = (xc * xc + yc * yc <= r * r) & (tc > 1e-4) & np.isfinite(tc)
        t_side = np.where(ok & (tc < t_side), tc, t_side)
    return np.where(t_side > 1e-4, t_side, np.inf)


def _normal(points, prim):
    """Outward normal at world-space hit points (N,3)."""
    R = prim.rotation
    pl = (points - prim.center) @ R
    if prim.kind == "sphere":
        n = pl
    elif prim.kind == "box":
        q = np.abs(pl) / prim.size
        axis = np.argmax(q, axis=1)
        n = np.zeros_like(pl)
        n[np.arange(len(pl)), axis] = np.sign(pl[np.arange(len(pl)), axis])
    else:  # cylinder
        r, hh = prim.size[0], prim.size[1]
        on_cap = np.abs(np.abs(pl[:, 2]) - hh) < 1e-3
        n = np.concatenate([pl[:, :2], np.zeros((len(pl), 1))], axis=1)
        n[on_cap] = 0.0
        n[on_cap, 2] = np.sign(pl[on_cap, 2])
    n = n @ R.T  # back to world
    return n / np.maximum(np.linalg.norm(n, axis=1, keepdims=True), 1e-9)


def _albedo(points, prim):
    base = np.array(COLORS[prim.color_name])
    if not prim.checker:
        return np.broadcast_to(base, (len(points), 3))
    pl = (points - prim.center) @ prim.rotation * prim.checker_scale
    parity = (np.floor(pl[:, 0]) + np.floor(pl[:, 1]) + np.floor(pl[:, 2])) % 2
    dark = base * 0.35
    return np.where(parity[:, None] > 0.5, base, dark)


_INTERSECT = {
    "sphere": _intersect_sphere,
    "box": _intersect_box,
    "cylinder": _intersect_cylinder,
}


def render_view(
    prims: Sequence[Primitive], cam: np.ndarray, size: int, supersample: int = 2
) -> np.ndarray:
    """RGBA uint8 render of ``prims`` from a 4x4 camera-to-world ``cam``.

    Pixel rays reproduce camera.ray_grid's convention (x right, y up,
    looking down -z, pixel centers, row 0 = top) so the saved camera matrices
    are exactly consistent with the framework's ray-map conditioning.
    """
    s = size * supersample
    half = float(np.tan(np.deg2rad(FOV_DEG) / 2.0))
    xs = ((np.arange(s) + 0.5) / s * 2.0 - 1.0) * half
    ys = (1.0 - (np.arange(s) + 0.5) / s * 2.0) * half
    x, y = np.meshgrid(xs, ys, indexing="xy")
    d_cam = np.stack([x, y, -np.ones_like(x)], axis=-1).reshape(-1, 3)
    d_cam /= np.linalg.norm(d_cam, axis=1, keepdims=True)
    R, pos = cam[:3, :3], cam[:3, 3]
    d = d_cam @ R.T
    o = pos.astype(np.float64)

    ts = np.stack([_INTERSECT[p.kind](o, d, p) for p in prims])  # (P, N)
    t_best = ts.min(axis=0)
    which = ts.argmin(axis=0)
    hit = np.isfinite(t_best)

    rgb = np.zeros((len(d), 3))
    for i, prim in enumerate(prims):
        m = hit & (which == i)
        if not m.any():
            continue
        pts = o + t_best[m, None] * d[m]
        n = _normal(pts, prim)
        alb = _albedo(pts, prim)
        shade = np.full(m.sum(), AMBIENT)
        for ldir, inten in LIGHTS:
            l = ldir / np.linalg.norm(ldir)
            shade = shade + inten * np.maximum(0.0, n @ l)
        rgb[m] = np.clip(alb * shade[:, None], 0.0, 1.0)

    rgba = np.zeros((s, s, 4), np.float32)
    rgba[..., :3] = rgb.reshape(s, s, 3)
    rgba[..., 3] = hit.reshape(s, s).astype(np.float32)
    if supersample > 1:
        rgba = rgba.reshape(size, supersample, size, supersample, 4).mean(axis=(1, 3))
    return (rgba * 255.0 + 0.5).astype(np.uint8)


def object_cameras(
    rng: np.random.Generator, num_views: int, radius: float = 1.8
) -> np.ndarray:
    """Fixed-elevation azimuth ring (the Blender rig's layout,
    blender_script.py:1041-1058) with a per-object random elevation and
    start azimuth. Returns (V, 4, 4) camera-to-world."""
    elev = float(rng.uniform(10.0, 35.0))
    start = float(rng.uniform(0.0, 360.0))
    cams = []
    for i in range(num_views):
        az = np.deg2rad(start + 360.0 * i / num_views)
        el = np.deg2rad(elev)
        pos = (
            radius * np.cos(el) * np.cos(az),
            radius * np.cos(el) * np.sin(az),
            radius * np.sin(el),
        )
        cams.append(to_homogeneous(look_at_camera(pos)).astype(np.float32))
    return np.stack(cams)


def write_object_zip(
    path: str,
    prims: Sequence[Primitive],
    cams: np.ndarray,
    size: int,
    supersample: int = 2,
) -> None:
    tmp = path + ".tmp"
    with zipfile.ZipFile(tmp, "w", compression=zipfile.ZIP_STORED) as z:
        for v, cam in enumerate(cams):
            z.writestr(f"{v:03d}.png", encode_png(render_view(prims, cam, size, supersample)))
            buf = io.BytesIO()
            np.save(buf, cam.astype(np.float32))
            z.writestr(f"{v:03d}.npy", buf.getvalue())
        z.writestr("prompt.txt", object_prompt(prims))
        z.writestr(
            "metadata.json",
            json.dumps(
                {
                    "views": len(cams),
                    "generator": "procedural-raytrace-v1",
                    "primitives": [
                        {"kind": p.kind, "color": p.color_name, "checker": p.checker}
                        for p in prims
                    ],
                }
            ),
        )
    os.replace(tmp, path)


def generate_corpus(
    out_dir: str,
    num_objects: int,
    views_per_object: int = 8,
    size: int = 256,
    seed: int = 0,
    supersample: int = 2,
    start_index: int = 0,
) -> str:
    """Write ``num_objects`` zips under ``out_dir/renders_final``; resumable
    (existing zips are skipped). Returns the renders dir."""
    renders = os.path.join(out_dir, "renders_final")
    os.makedirs(renders, exist_ok=True)
    for i in range(start_index, start_index + num_objects):
        path = os.path.join(renders, f"proc_{i:05d}.zip")
        if os.path.exists(path):
            continue
        rng = np.random.default_rng(seed * 1_000_003 + i)  # per-object stream
        prims = sample_object(rng)
        cams = object_cameras(rng, views_per_object)
        write_object_zip(path, prims, cams, size, supersample)
    return renders


def main(argv: Optional[Sequence[str]] = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--out", required=True, help="corpus root (renders_final/ under it)")
    ap.add_argument("--num-objects", type=int, default=300)
    ap.add_argument("--views", type=int, default=8)
    ap.add_argument("--size", type=int, default=256)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--supersample", type=int, default=2)
    args = ap.parse_args(argv)
    renders = generate_corpus(
        args.out, args.num_objects, args.views, args.size, args.seed, args.supersample
    )
    n = len([f for f in os.listdir(renders) if f.endswith(".zip")])
    print(f"corpus ready: {renders} ({n} objects x {args.views} views @ {args.size}^2)")


if __name__ == "__main__":
    main()
