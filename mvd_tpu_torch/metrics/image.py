"""Image quality metrics (NHWC tensors).

Counterpart of ``mvd_tpu/metrics/image.py``: PSNR over the batch or per
image, and SSIM after Wang et al. 2004 with the 11x11 Gaussian window,
sigma 1.5, K1 0.01, K2 0.03 (torchmetrics' definition; data_range 2.0 for
[-1, 1] images). Everything computes in f32.

SSIM's variance terms E[x²] − μ² cancel catastrophically in reduced
precision (the JAX package measured a true 0.78 read as 0.06 under bf16
passes on a TPU). On the GPU cuDNN may run an f32 convolution in TF32, so
``_filter2d`` turns TF32 off for its own convolution and restores the
setting after it (``no_tf32``, which the metric towers share); no other
product of the process is touched.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch
import torch.nn.functional as F


def psnr(a: torch.Tensor, b: torch.Tensor, data_range: float = 2.0) -> torch.Tensor:
    """Peak signal-to-noise ratio in dB over the whole batch."""
    mse = torch.mean((a.float() - b.float()) ** 2)
    return 10.0 * torch.log10(data_range**2 / torch.clamp(mse, min=1e-12))


def psnr_per_image(a: torch.Tensor, b: torch.Tensor, data_range: float = 2.0) -> torch.Tensor:
    mse = torch.mean((a.float() - b.float()) ** 2, dim=tuple(range(1, a.dim())))
    return 10.0 * torch.log10(data_range**2 / torch.clamp(mse, min=1e-12))


def _gaussian_window(size: int = 11, sigma: float = 1.5) -> np.ndarray:
    x = np.arange(size) - size // 2
    g = np.exp(-(x**2) / (2 * sigma**2))
    g = g / g.sum()
    return np.outer(g, g).astype(np.float32)


@contextlib.contextmanager
def no_tf32():
    """cuDNN convolutions and cuBLAS matmuls in full f32 inside the block
    only; both switches are restored after it."""
    old = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = old


def _filter2d(x: torch.Tensor, win: torch.Tensor) -> torch.Tensor:
    """Depthwise 2D filter, VALID padding, in full f32. x: (B, H, W, C)."""
    C = x.shape[-1]
    kernel = win[None, None].expand(C, 1, *win.shape)
    with no_tf32():
        out = F.conv2d(x.permute(0, 3, 1, 2), kernel, groups=C)
    return out.permute(0, 2, 3, 1)


def ssim(
    a: torch.Tensor,
    b: torch.Tensor,
    data_range: float = 2.0,
    window_size: int = 11,
    sigma: float = 1.5,
    per_image: bool = False,
) -> torch.Tensor:
    a, b = a.float(), b.float()
    win = torch.as_tensor(_gaussian_window(window_size, sigma), device=a.device)
    c1 = (0.01 * data_range) ** 2
    c2 = (0.03 * data_range) ** 2

    mu_a = _filter2d(a, win)
    mu_b = _filter2d(b, win)
    mu_aa, mu_bb, mu_ab = mu_a * mu_a, mu_b * mu_b, mu_a * mu_b
    sigma_a = _filter2d(a * a, win) - mu_aa
    sigma_b = _filter2d(b * b, win) - mu_bb
    sigma_ab = _filter2d(a * b, win) - mu_ab

    ssim_map = ((2 * mu_ab + c1) * (2 * sigma_ab + c2)) / (
        (mu_aa + mu_bb + c1) * (sigma_a + sigma_b + c2)
    )
    if per_image:
        return ssim_map.mean(dim=(1, 2, 3))
    return ssim_map.mean()
