"""Training losses as plain functions.

Counterpart of ``mvd_tpu/train/losses.py``: the Min-SNR-weighted
v-prediction (or epsilon) MSE, with the weights applied per sample
(``per_sample``) or as the reference's ``scalar_mse * mean(w)``
(``faithful``), and the frozen-UNet feature-matching loss. Not ported yet:
``reconstruction_metrics`` (it needs ``metrics/image.py``).
"""

from __future__ import annotations

from typing import Dict

import torch

from ..diffusion.schedules import NoiseSchedule, compute_snr, get_velocity, min_snr_weight


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
