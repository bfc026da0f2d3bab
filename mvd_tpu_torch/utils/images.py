"""Image IO helpers (host-side, numpy + PIL): a copy of
``mvd_tpu/utils/images.py``, kept in the port so that it imports nothing of
the JAX package."""

from __future__ import annotations

import os
from typing import Optional, Sequence

import numpy as np


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


def save_image(img: np.ndarray, path: str):
    from PIL import Image

    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    Image.fromarray(to_uint8(img)).save(path)


def load_image(path: str, size: Optional[int] = None) -> np.ndarray:
    """PNG -> (H, W, 3) float32 in [-1, 1] (reference utils.py:36-48, NHWC)."""
    from PIL import Image

    img = Image.open(path).convert("RGB")
    if size is not None and img.size != (size, size):
        img = img.resize((size, size), Image.LANCZOS)
    arr = np.asarray(img, np.float32) / 255.0
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
