"""Training losses as plain functions.

Counterpart of ``mvd_tpu/train/losses.py``: the Min-SNR-weighted
v-prediction (or epsilon) MSE, with the weights applied per sample
(``per_sample``) or as the reference's ``scalar_mse * mean(w)``
(``faithful``), the frozen-UNet feature-matching loss, and the no-grad
reconstruction metrics (x0-hat latent and pixel MSE, SSIM).
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from ..diffusion.schedules import (
    NoiseSchedule,
    compute_snr,
    get_velocity,
    min_snr_weight,
    pred_original_sample,
)
from ..metrics.image import ssim


def noise_loss(
    schedule: NoiseSchedule,
    noise_pred: torch.Tensor,
    noise: torch.Tensor,
    target_latents: torch.Tensor,
    timesteps: torch.Tensor,
    snr_gamma: float = 5.0,
    use_snr: bool = True,
    weighting: str = "per_sample",
) -> Dict[str, torch.Tensor]:
    """{"noise_loss", "mean_snr", "mean_snr_weight"}, f32 scalars."""
    if schedule.prediction_type == "v_prediction":
        target = get_velocity(schedule, target_latents, noise, timesteps)
    else:
        target = noise
    err = (noise_pred.float() - target.float()) ** 2
    snr = compute_snr(schedule, timesteps)
    w = min_snr_weight(schedule, timesteps, snr_gamma) if use_snr else torch.ones_like(snr)
    if weighting == "faithful":
        loss = err.mean() * w.mean()
    else:
        loss = (err.mean(dim=tuple(range(1, err.dim()))) * w).mean()
    return {"noise_loss": loss, "mean_snr": snr.mean(), "mean_snr_weight": w.mean()}


def feature_matching_loss(
    feats_pred: Dict[str, torch.Tensor], feats_target: Dict[str, torch.Tensor]
) -> torch.Tensor:
    """Mean over blocks of the squared feature distance, each block divided
    by its target's variance (at least 1e-6). The caller detaches the target
    side; gradient flows through the prediction side."""
    losses = []
    for name in sorted(feats_target):
        p, t = feats_pred[name].float(), feats_target[name].float()
        scale = torch.clamp(t.var(unbiased=False), min=1e-6)
        losses.append(((p - t) ** 2).mean() / scale)
    return torch.stack(losses).mean()


@torch.no_grad()
def reconstruction_metrics(
    schedule: NoiseSchedule,
    noise_pred: torch.Tensor,
    noisy_latents: torch.Tensor,
    target_latents: torch.Tensor,
    timesteps: torch.Tensor,
    vae_decode=None,
    image_metric_fns: Optional[Dict] = None,
) -> Dict[str, torch.Tensor]:
    """``latent_recon_loss`` (x0-hat against the target latents) and, with
    ``vae_decode``, ``pixel_recon_loss``, ``ssim_value`` and ``ssim_loss``
    on the decoded [-1, 1] images, plus ``name: fn(img_hat, img_tgt)`` for
    each entry of ``image_metric_fns`` (the hook for tower metrics)."""
    noise_pred, target_latents = noise_pred.detach(), target_latents.detach()
    x0_hat = pred_original_sample(schedule, noise_pred, noisy_latents, timesteps)
    out = {"latent_recon_loss": torch.mean((x0_hat.float() - target_latents.float()) ** 2)}
    if vae_decode is not None:
        img_hat = vae_decode(x0_hat)
        img_tgt = vae_decode(target_latents)
        out["pixel_recon_loss"] = torch.mean((img_hat.float() - img_tgt.float()) ** 2)
        s = ssim(img_hat, img_tgt, data_range=2.0)
        out["ssim_value"] = s
        out["ssim_loss"] = 1.0 - s
        for name, fn in (image_metric_fns or {}).items():
            out[name] = fn(img_hat, img_tgt)
    return out
