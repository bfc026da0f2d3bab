"""Noise schedules and the sampling steps (PyTorch).

Counterpart of ``mvd_tpu/diffusion/schedules.py``: diffusers DDPMScheduler
semantics (scaled-linear betas, v-prediction, ``fixed_small`` variance,
'leading' timestep spacing with steps_offset), the ShiftSNR rewrite of the
betas, the forward process (``add_noise``, ``get_velocity``), the Min-SNR
weight, and the sampling steps: ancestral DDPM, DDIM, the DDIM inversion
step and DPM-Solver++(2M). Timesteps are an int or a tensor of per-row
timesteps. A sampling step takes its timestep as a Python int (and the
DPM-Solver++ state its previous one), so it indexes the device schedule
without a host round trip; ``ddpm_step`` and ``ddim_step`` with eta > 0 take
their noise as an argument, so a caller (or a test) decides where the random
numbers come from.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch


def make_betas(
    num_train_timesteps: int = 1000,
    beta_schedule: str = "scaled_linear",
    beta_start: float = 0.00085,
    beta_end: float = 0.012,
) -> np.ndarray:
    """Beta schedule computed in float64, returned float32."""
    if beta_schedule == "linear":
        betas = np.linspace(beta_start, beta_end, num_train_timesteps, dtype=np.float64)
    elif beta_schedule == "scaled_linear":
        betas = np.linspace(beta_start**0.5, beta_end**0.5, num_train_timesteps, dtype=np.float64) ** 2
    elif beta_schedule == "squaredcos_cap_v2":
        t = np.arange(num_train_timesteps, dtype=np.float64)
        f = lambda s: np.cos((s / num_train_timesteps + 0.008) / 1.008 * np.pi / 2) ** 2
        betas = np.clip(1.0 - f(t + 1) / f(t), 0.0, 0.999)
    else:
        raise ValueError(f"unknown beta_schedule: {beta_schedule}")
    return betas.astype(np.float32)


@dataclasses.dataclass(frozen=True)
class NoiseSchedule:
    """Schedule tensors (shape [T], float32) plus the step settings."""

    betas: torch.Tensor
    alphas_cumprod: torch.Tensor
    num_train_timesteps: int = 1000
    prediction_type: str = "v_prediction"
    steps_offset: int = 1
    timestep_spacing: str = "leading"

    @classmethod
    def create(
        cls,
        betas: Optional[np.ndarray] = None,
        num_train_timesteps: int = 1000,
        beta_schedule: str = "scaled_linear",
        beta_start: float = 0.00085,
        beta_end: float = 0.012,
        prediction_type: str = "v_prediction",
        steps_offset: int = 1,
        timestep_spacing: str = "leading",
    ) -> "NoiseSchedule":
        if betas is None:
            betas = make_betas(num_train_timesteps, beta_schedule, beta_start, beta_end)
        betas = torch.as_tensor(np.asarray(betas), dtype=torch.float32)
        return cls(
            betas=betas,
            alphas_cumprod=torch.cumprod(1.0 - betas, dim=0),
            num_train_timesteps=int(betas.shape[0]),
            prediction_type=prediction_type,
            steps_offset=steps_offset,
            timestep_spacing=timestep_spacing,
        )

    def to(self, device) -> "NoiseSchedule":
        return dataclasses.replace(
            self, betas=self.betas.to(device), alphas_cumprod=self.alphas_cumprod.to(device)
        )

    @property
    def init_noise_sigma(self) -> float:
        return 1.0


def _timesteps(schedule: NoiseSchedule, timesteps) -> torch.Tensor:
    return torch.as_tensor(timesteps, device=schedule.alphas_cumprod.device).long()


def compute_snr(schedule: NoiseSchedule, timesteps) -> torch.Tensor:
    """SNR_t = alpha_bar_t / (1 - alpha_bar_t), in the sqrt form."""
    ac = schedule.alphas_cumprod[_timesteps(schedule, timesteps)]
    return (torch.sqrt(ac) / torch.sqrt(1.0 - ac)) ** 2


def _gather_sqrt_ac(schedule: NoiseSchedule, timesteps, ndim: int):
    """sqrt(alpha_bar_t), sqrt(1 - alpha_bar_t), shaped to broadcast over a
    tensor of rank ``ndim`` whose leading dims are the timesteps'. An int
    timestep indexes without a host-to-device copy, which would synchronise
    the sampling loop's stream."""
    if isinstance(timesteps, int):
        ac = schedule.alphas_cumprod[timesteps]
    else:
        t = _timesteps(schedule, timesteps)
        ac = schedule.alphas_cumprod[t].float().reshape(t.shape + (1,) * (ndim - t.dim()))
    return torch.sqrt(ac), torch.sqrt(1.0 - ac)


def add_noise(schedule: NoiseSchedule, sample: torch.Tensor, noise: torch.Tensor, timesteps) -> torch.Tensor:
    """x_t = sqrt(a_bar) x_0 + sqrt(1 - a_bar) eps (DDPMScheduler.add_noise)."""
    sa, so = _gather_sqrt_ac(schedule, timesteps, sample.dim())
    return (sa * sample + so * noise).to(sample.dtype)


def get_velocity(schedule: NoiseSchedule, sample: torch.Tensor, noise: torch.Tensor, timesteps) -> torch.Tensor:
    """v = sqrt(a_bar) eps - sqrt(1 - a_bar) x_0 (DDPMScheduler.get_velocity)."""
    sa, so = _gather_sqrt_ac(schedule, timesteps, sample.dim())
    return (sa * noise - so * sample).to(sample.dtype)


def min_snr_weight(schedule: NoiseSchedule, timesteps, gamma: float = 5.0) -> torch.Tensor:
    """w_t = min(SNR_t, gamma) / SNR_t (Min-SNR)."""
    snr = compute_snr(schedule, timesteps)
    return torch.clamp(snr, max=gamma) / snr


def snr_to_betas(snr: torch.Tensor) -> torch.Tensor:
    alphas_cumprod = snr / (1.0 + snr)
    prev = torch.cat([torch.ones(1, dtype=snr.dtype, device=snr.device), alphas_cumprod[:-1]])
    return 1.0 - alphas_cumprod / prev


def shift_snr_betas(schedule: NoiseSchedule, shift_scale: float, mode: str = "interpolated") -> torch.Tensor:
    """ShiftSNR: ``default`` divides the SNR by shift_scale everywhere;
    ``interpolated`` interpolates log-SNR from the original (t=0) to the
    shifted one (t=T-1)."""
    t = torch.arange(schedule.num_train_timesteps, device=schedule.alphas_cumprod.device)
    snr = compute_snr(schedule, t)
    shifted = snr / shift_scale
    if mode == "default":
        return snr_to_betas(shifted)
    if mode == "interpolated":
        w = t.float() / (schedule.num_train_timesteps - 1)
        return snr_to_betas(torch.exp(torch.log(snr) * (1.0 - w) + torch.log(shifted) * w))
    raise ValueError(f"unknown shift mode: {mode}")


def make_shifted_schedule(base: NoiseSchedule, shift_scale: float = 6.0, mode: str = "interpolated") -> NoiseSchedule:
    return NoiseSchedule.create(
        betas=shift_snr_betas(base, shift_scale, mode).cpu().numpy(),
        prediction_type=base.prediction_type,
        steps_offset=base.steps_offset,
        timestep_spacing=base.timestep_spacing,
    )


def inference_timesteps(schedule: NoiseSchedule, num_inference_steps: int) -> np.ndarray:
    """Descending int32 timestep grid (diffusers spacing with steps_offset)."""
    T = schedule.num_train_timesteps
    if schedule.timestep_spacing == "leading":
        ratio = T // num_inference_steps
        ts = (np.arange(0, num_inference_steps) * ratio).round()[::-1].astype(np.int64)
        ts = ts + schedule.steps_offset
    elif schedule.timestep_spacing == "trailing":
        ratio = T / num_inference_steps
        ts = np.round(np.arange(T, 0, -ratio)).astype(np.int64) - 1
    else:  # linspace
        ts = np.linspace(0, T - 1, num_inference_steps).round()[::-1].astype(np.int64)
    return np.clip(ts, 0, T - 1).astype(np.int32)


def pred_original_sample(schedule: NoiseSchedule, model_output, sample, timesteps):
    """x0-hat for the schedule's prediction type at an int timestep or at
    per-row timesteps."""
    sa, so = _gather_sqrt_ac(schedule, timesteps, sample.dim())
    p = schedule.prediction_type
    if p == "epsilon":
        return (sample - so * model_output) / sa
    if p == "v_prediction":
        return sa * sample - so * model_output
    if p == "sample":
        return model_output
    raise ValueError(f"unknown prediction_type: {p}")


def pred_epsilon(schedule: NoiseSchedule, model_output, sample, timesteps):
    """eps-hat for the schedule's prediction type at an int timestep or at
    per-row timesteps."""
    sa, so = _gather_sqrt_ac(schedule, timesteps, sample.dim())
    p = schedule.prediction_type
    if p == "epsilon":
        return model_output
    if p == "v_prediction":
        return sa * model_output + so * sample
    if p == "sample":
        return (sample - sa * model_output) / so
    raise ValueError(f"unknown prediction_type: {p}")


def _ac_at(schedule: NoiseSchedule, t: int) -> torch.Tensor:
    """alpha_bar at an int timestep; 1 (the clean end) where t < 0."""
    ac = schedule.alphas_cumprod
    return ac[t] if t >= 0 else torch.ones_like(ac[0])


def ddpm_step(
    schedule: NoiseSchedule,
    model_output: torch.Tensor,
    timestep: int,
    sample: torch.Tensor,
    noise: torch.Tensor,
    num_inference_steps: int,
) -> torch.Tensor:
    """One ancestral DDPM step (DDPMScheduler.step, fixed_small variance)
    with the caller's standard-normal ``noise`` of the sample's shape."""
    prev_t = timestep - schedule.num_train_timesteps // num_inference_steps
    ac_t = schedule.alphas_cumprod[timestep]
    ac_prev = _ac_at(schedule, prev_t)
    beta_prod_t = 1.0 - ac_t
    beta_prod_prev = 1.0 - ac_prev
    alpha_t = ac_t / ac_prev
    beta_t = 1.0 - alpha_t

    x0 = pred_original_sample(schedule, model_output, sample, timestep)
    x0_coeff = torch.sqrt(ac_prev) * beta_t / beta_prod_t
    xt_coeff = torch.sqrt(alpha_t) * beta_prod_prev / beta_prod_t
    prev_sample = x0_coeff * x0 + xt_coeff * sample
    if timestep > 0:
        variance = torch.clamp(beta_prod_prev / beta_prod_t * beta_t, min=1e-20)
        prev_sample = prev_sample + torch.sqrt(variance) * noise.float()
    return prev_sample.to(sample.dtype)


def ddim_step(
    schedule: NoiseSchedule,
    model_output: torch.Tensor,
    timestep: int,
    sample: torch.Tensor,
    num_inference_steps: int,
    eta: float = 0.0,
    noise: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """One DDIM step (diffusers DDIMScheduler.step); deterministic at
    eta 0, and with eta > 0 it adds sigma times the caller's standard-normal
    ``noise``."""
    prev_t = timestep - schedule.num_train_timesteps // num_inference_steps
    ac_t = schedule.alphas_cumprod[timestep]
    ac_prev = _ac_at(schedule, prev_t)
    x0 = pred_original_sample(schedule, model_output, sample, timestep)
    eps = pred_epsilon(schedule, model_output, sample, timestep)
    sigma = 0.0
    if eta > 0.0:
        if noise is None:
            raise ValueError("ddim_step with eta > 0 needs the caller's noise")
        sigma = eta * torch.sqrt((1 - ac_prev) / (1 - ac_t) * (1 - ac_t / ac_prev))
    prev_sample = torch.sqrt(ac_prev) * x0 + torch.sqrt(1.0 - ac_prev - sigma**2) * eps
    if eta > 0.0:
        prev_sample = prev_sample + sigma * noise.float()
    return prev_sample.to(sample.dtype)


def ddim_inverse_step(
    schedule: NoiseSchedule,
    model_output: torch.Tensor,
    timestep: int,
    sample: torch.Tensor,
    num_inference_steps: int,
) -> torch.Tensor:
    """One DDIM inversion step: ``sample`` lives at ``timestep - T // n``
    (clean where that is < 0) and is mapped up the schedule to ``timestep``,
    with the model evaluated at ``timestep`` (diffusers DDIMInverseScheduler
    semantics)."""
    s = timestep - schedule.num_train_timesteps // num_inference_steps
    ac_s = _ac_at(schedule, s)
    sa_s, so_s = torch.sqrt(ac_s), torch.sqrt(1.0 - ac_s)
    p = schedule.prediction_type
    if p == "epsilon":
        eps = model_output
        x0 = (sample - so_s * eps) / sa_s
    elif p == "v_prediction":
        x0 = sa_s * sample - so_s * model_output
        eps = sa_s * model_output + so_s * sample
    elif p == "sample":
        x0 = model_output
        eps = (sample - sa_s * x0) / torch.clamp(so_s, min=1e-12)
    else:
        raise ValueError(f"unknown prediction_type: {p}")
    ac_t = schedule.alphas_cumprod[timestep]
    return (torch.sqrt(ac_t) * x0 + torch.sqrt(1.0 - ac_t) * eps).to(sample.dtype)


def dpmpp_2m_init(sample: torch.Tensor) -> Tuple[torch.Tensor, int]:
    """The multistep state of ``dpmpp_2m_step``: (the previous step's x0
    prediction, its timestep), with timestep -1 for "no previous step"."""
    return torch.zeros_like(sample, dtype=torch.float32), -1


def dpmpp_2m_step(
    schedule: NoiseSchedule,
    model_output: torch.Tensor,
    timestep: int,
    sample: torch.Tensor,
    state: Tuple[torch.Tensor, int],
    num_inference_steps: int,
) -> Tuple[torch.Tensor, Tuple[torch.Tensor, int]]:
    """One deterministic DPM-Solver++(2M) step (arXiv 2211.01095; diffusers
    DPMSolverMultistepScheduler with algorithm_type "dpmsolver++",
    solver_order 2, lower_order_final). First order on the first step (no
    history) and on the last one, whose endpoint t < 0 is clean (sigma 0):
    there the step returns x0. Returns (prev_sample, new state)."""
    x0_prev, t_prev = state
    prev_t = timestep - schedule.num_train_timesteps // num_inference_steps

    def lam(t: int) -> torch.Tensor:  # log(alpha / sigma)
        a = schedule.alphas_cumprod[t]
        return 0.5 * (torch.log(a) - torch.log1p(-a))

    x0 = pred_original_sample(schedule, model_output, sample, timestep).float()
    if prev_t < 0:
        prev_sample = x0
    else:
        ac_t, ac_s = schedule.alphas_cumprod[timestep], schedule.alphas_cumprod[prev_t]
        lam_t = lam(timestep)
        h = lam(prev_t) - lam_t
        D = x0
        if t_prev >= 0:
            r = (lam_t - lam(t_prev)) / h
            D = (1.0 + 1.0 / (2.0 * r)) * x0 - (1.0 / (2.0 * r)) * x0_prev
        prev_sample = (torch.sqrt(1.0 - ac_s) / torch.sqrt(1.0 - ac_t)) * sample.float() \
            - torch.sqrt(ac_s) * torch.expm1(-h) * D
    return prev_sample.to(model_output.dtype), (x0, timestep)


SAMPLERS = ("ddpm", "ddim", "dpmpp_2m")
