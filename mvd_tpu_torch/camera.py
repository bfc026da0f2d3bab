"""Camera math (PyTorch tensors, plus host-side numpy camera builders).

Counterpart of ``mvd_tpu/camera.py``: the relative source->target transform
and the NeRF-style positional encoding the camera encoder consumes, and the
look-at / orbit cameras the CLI and ``chip_smoke.py`` build, and the
Plücker ray maps of ray-map conditioning (computed in f32).
"""

from __future__ import annotations

import numpy as np
import torch


def relative_transform(source_camera: torch.Tensor, target_camera: torch.Tensor):
    """R_rel = R_t @ R_s^T,  T_rel = T_t - R_rel @ T_s, for [..., 4, 4] or
    [..., 3, 4] camera-to-world matrices; returns (R [..., 3, 3], T [..., 3])."""
    sR = source_camera[..., :3, :3]
    sT = source_camera[..., :3, 3]
    tR = target_camera[..., :3, :3]
    tT = target_camera[..., :3, 3]
    rel_R = tR @ sR.transpose(-1, -2)
    rel_T = tT - (rel_R @ sT[..., None])[..., 0]
    return rel_R, rel_T


def positional_encoding_freqs(pos_enc_dim: int, max_freq: float = 10.0, device=None) -> torch.Tensor:
    """Log-spaced frequencies exp(linspace(0, log(max_freq), D)), f32."""
    return torch.exp(torch.linspace(0.0, float(np.log(max_freq)), pos_enc_dim, device=device))


def positional_encoding(x: torch.Tensor, pos_enc_dim: int, max_freq: float = 10.0) -> torch.Tensor:
    """[B, D_in] -> [B, D_in * 2 * pos_enc_dim]: sin||cos per coordinate."""
    angles = x[..., None] * positional_encoding_freqs(pos_enc_dim, max_freq, x.device)
    enc = torch.cat([torch.sin(angles), torch.cos(angles)], dim=-1)  # [B, D_in, 2P]
    return enc.reshape(x.shape[:-1] + (-1,))


def ray_grid(h: int, w: int, fov_deg: float = 54.43, device=None) -> torch.Tensor:
    """Unit camera-space ray directions on an (h, w) grid of pixel centres,
    (h, w, 3) f32: x right, y up, looking down -z (the render rig's
    convention; 54.43 degrees is its 35 mm lens on a 36 mm sensor)."""
    half = float(np.tan(np.deg2rad(fov_deg) / 2.0))
    xs = (torch.arange(w, dtype=torch.float32, device=device) + 0.5) / w * 2.0 - 1.0
    ys = 1.0 - (torch.arange(h, dtype=torch.float32, device=device) + 0.5) / h * 2.0
    y, x = torch.meshgrid(ys * half, xs * half, indexing="ij")
    d = torch.stack([x, y, -torch.ones_like(x)], dim=-1)
    return d / torch.linalg.vector_norm(d, dim=-1, keepdim=True)


def ray_grid_from_intrinsics(K: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """Unit camera-space rays from pinhole intrinsics K (..., 3, 3), with
    (fx, fy, cx, cy) in pixels of the (h, w) grid, in ``ray_grid``'s
    convention; (..., h, w, 3)."""
    fx, fy = K[..., 0, 0, None, None], K[..., 1, 1, None, None]
    cx, cy = K[..., 0, 2, None, None], K[..., 1, 2, None, None]
    v, u = torch.meshgrid(torch.arange(h, dtype=torch.float32, device=K.device) + 0.5,
                          torch.arange(w, dtype=torch.float32, device=K.device) + 0.5, indexing="ij")
    x = (u - cx) / fx
    y = (cy - v) / fy
    d = torch.stack([x, y, -torch.ones_like(x)], dim=-1)
    return d / torch.linalg.vector_norm(d, dim=-1, keepdim=True)


def plucker_ray_map(source_camera: torch.Tensor, target_camera: torch.Tensor, h: int, w: int,
                    fov_deg: float = 54.43) -> torch.Tensor:
    """Per-pixel Plücker rays (d, o x d) of the target view in the source
    camera's frame, (..., h, w, 6) f32, for camera-to-world matrices
    (..., 4, 4) or (..., 3, 4): d = R_s^T R_t d_cam, o = R_s^T (T_t - T_s).
    source == target gives the canonical grid (d = d_cam, moment 0)."""
    sR, sT = source_camera[..., :3, :3], source_camera[..., :3, 3]
    tR, tT = target_camera[..., :3, :3], target_camera[..., :3, 3]
    rel_R = sR.transpose(-1, -2) @ tR
    o = torch.einsum("...ji,...j->...i", sR, tT - sT)
    d = torch.einsum("...ij,hwj->...hwi", rel_R, ray_grid(h, w, fov_deg, source_camera.device))
    o = o[..., None, None, :].expand(d.shape)
    return torch.cat([d, torch.linalg.cross(o, d, dim=-1)], dim=-1).float()


def look_at_camera(position, target=(0.0, 0.0, 0.0), up=(0.0, 0.0, 1.0)) -> np.ndarray:
    """3x4 camera-to-world [R|t] with columns (right, up, -forward) and the
    camera position as translation."""
    position = np.asarray(position, dtype=np.float64)
    target = np.asarray(target, dtype=np.float64)
    up = np.asarray(up, dtype=np.float64)

    forward = target - position
    forward = forward / np.linalg.norm(forward)
    right = np.cross(forward, up)
    right = right / np.linalg.norm(right)
    cam_up = np.cross(right, forward)

    mat = np.zeros((3, 4), dtype=np.float32)
    mat[:, 0] = right
    mat[:, 1] = cam_up
    mat[:, 2] = -forward
    mat[:, 3] = position
    return mat


def to_homogeneous(cam: np.ndarray) -> np.ndarray:
    """[3,4] -> [4,4] with a (0,0,0,1) bottom row."""
    if cam.shape[-2:] == (4, 4):
        return cam
    bottom = np.zeros(cam.shape[:-2] + (1, 4), dtype=cam.dtype)
    bottom[..., 0, 3] = 1.0
    return np.concatenate([cam, bottom], axis=-2)


def orbit_cameras(
    num_views: int,
    radius: float = 1.8,
    elevation_deg: float = 20.0,
    start_azimuth_deg: float = 0.0,
) -> np.ndarray:
    """Ring of ``num_views`` look-at cameras around the origin, (V, 4, 4)."""
    elev = np.deg2rad(elevation_deg)
    cams = []
    for i in range(num_views):
        az = np.deg2rad(start_azimuth_deg + 360.0 * i / num_views)
        pos = (
            radius * np.cos(elev) * np.cos(az),
            radius * np.cos(elev) * np.sin(az),
            radius * np.sin(elev),
        )
        cams.append(to_homogeneous(look_at_camera(pos)))
    return np.stack(cams)
