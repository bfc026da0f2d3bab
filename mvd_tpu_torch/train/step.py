"""The training step.

Counterpart of the single-device path of ``mvd_tpu/train/step.py``:
frozen text encode -> frozen VAE encode of source and target (sampled,
times the scaling factor) -> noise and uniform timesteps -> ``add_noise`` on
the (shifted) schedule -> ``MultiViewUNet`` prediction -> Min-SNR-weighted
v-prediction MSE -> backward into the trainable partition -> global-norm
clip and AdamW. The text and VAE passes run without gradient; the frozen
parameters have ``requires_grad=False``, so no weight gradient is computed
for them.

Metric keys are the JAX package's: ``noise_loss``, ``mean_snr``,
``mean_snr_weight``, ``grad_norm/*``, ``grad_max/*``, ``hist/grad/*``,
``modulation/*`` (and ``feature_matching_loss`` / ``total_loss`` with
feature matching on). Values are 0-d tensors on the model's device; the
``hist/grad/*`` entries are 1-d samples.

Random numbers come from a ``torch.Generator``, or from the caller:
``draws`` may hold ``noise`` (N, h, w, 4), ``timesteps`` (N,) and the VAE
sample noises ``source_vae_noise`` / ``target_vae_noise`` (N, h, w, 4).
``torch.Generator`` cannot reproduce ``jax.random``, so the tests hand the
JAX step's draws in. ``make_loss_fn(with_recon_metrics=True)`` adds the
no-grad reconstruction metrics (the VAE decode of x0-hat and of the target,
``train/losses.py:reconstruction_metrics``), which the Trainer runs every
``metrics_log_interval`` steps; gradient accumulation lives in
``TrainState.apply_gradients``. (B, V, ...) batches flatten to rows
b * V + v, so a model with joint attention over ``num_views`` = V attends
across the V views of each sample. Not ported yet: the view-sharded step
(ROADMAP item 16).
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from ..config import TrainConfig
from ..diffusion.schedules import NoiseSchedule, add_noise, pred_original_sample
from .losses import feature_matching_loss, noise_loss, reconstruction_metrics
from .state import TrainState

Tensors = Dict[str, torch.Tensor]

GRAD_GROUPS = {
    "camera_encoder": lambda parts: "camera_encoder" in parts
    and not any(p.startswith("mod_") for p in parts),
    "image_attention_processor": lambda parts: "adapter_self" in parts
    or "adapter_cross" in parts,
    "down_modulators": lambda parts: any(p.startswith("mod_down") for p in parts),
    "up_modulators": lambda parts: any(p.startswith("mod_up") for p in parts),
    "mid_modulators": lambda parts: any(
        p.startswith("mod_mid") or p.startswith("mod_output") for p in parts
    ),
}


def _group_leaves(grads: Tensors, pred):
    return [g for name, g in grads.items() if pred(name.split("."))]


def grad_group_norms(grads: Tensors) -> Tensors:
    """Per-group gradient norm and max |g|, and ``grad_norm/total`` over
    every trainable gradient (name -> gradient of the trainable
    parameters under ``model["mvd"]``)."""
    out = {}
    zero = torch.zeros((), device=next(iter(grads.values())).device)
    for name, pred in GRAD_GROUPS.items():
        leaves = _group_leaves(grads, pred)
        if leaves:
            out[f"grad_norm/{name}"] = torch.sqrt(sum(g.float().square().sum() for g in leaves))
            out[f"grad_max/{name}"] = torch.stack([g.abs().max().float() for g in leaves]).max()
        else:
            out[f"grad_norm/{name}"] = out[f"grad_max/{name}"] = zero
    out["grad_norm/total"] = torch.sqrt(sum(g.float().square().sum() for g in grads.values()))
    return out


def grad_group_samples(grads: Tensors, k: int = 512) -> Tensors:
    """About ``k`` strided samples of raw gradient values per group, spread
    evenly over its parameters (``hist/grad/<group>``), for histograms."""
    out = {}
    for name, pred in GRAD_GROUPS.items():
        leaves = [g.reshape(-1).float() for g in _group_leaves(grads, pred) if g.numel() > 0]
        if not leaves:
            continue
        per = max(1, k // len(leaves))
        out[f"hist/grad/{name}"] = torch.cat(
            [v[:: max(1, v.shape[0] // per)][:per] for v in leaves]
        )
    return out


def film_stats(film) -> Tensors:
    """Per-modulator mean and (population) std of the FiLM scale and shift."""
    out = {}
    for name, (scale, shift) in film.items():
        out[f"modulation/{name}/scale_mean"] = scale.mean()
        out[f"modulation/{name}/scale_std"] = scale.std(unbiased=False)
        out[f"modulation/{name}/shift_mean"] = shift.mean()
        out[f"modulation/{name}/shift_std"] = shift.std(unbiased=False)
    return out


def _flat(x: torch.Tensor) -> torch.Tensor:
    return x.reshape((-1,) + tuple(x.shape[2:]))


def _draws(batch: Tensors, latent_shape, schedule: NoiseSchedule,
           generator: Optional[torch.Generator], draws: Optional[Tensors]) -> Tensors:
    """The step's random numbers: the caller's where given, the rest from
    ``generator``, in the order noise, timesteps, source, target."""
    draws = dict(draws or {})
    dev = batch["input_ids"].device
    randn = lambda: torch.randn(latent_shape, generator=generator, device=dev)
    if "noise" not in draws:
        draws["noise"] = randn()
    if "timesteps" not in draws:
        draws["timesteps"] = torch.randint(
            0, schedule.num_train_timesteps, latent_shape[:1], generator=generator, device=dev
        )
    for key in ("source_vae_noise", "target_vae_noise"):
        if key not in draws:
            draws[key] = randn()
    return {k: torch.as_tensor(v, device=dev) for k, v in draws.items()}


def make_loss_fn(schedule: NoiseSchedule, cfg: TrainConfig, source_repeat: int = 1,
                 with_recon_metrics: bool = False,
                 image_metric_fns: Optional[Dict[str, Any]] = None):
    """``loss_fn(model, batch, generator=None, draws=None) -> (loss,
    metrics)`` over flat-row batches (N, ...).

    ``batch`` holds ``input_ids``, the cameras and either pixels
    (``source_image``/``target_image``, (N, H, W, 3) in [-1, 1]) or cached
    posterior moments (``source_moments``/``target_moments``,
    (N, 2, h, w, 4)). With ``source_repeat`` > 1, runs of that many rows
    share a source view: the source encoder runs over the unique rows and
    the moments are tiled back. ``with_recon_metrics`` adds the
    reconstruction metrics of the same forward pass (``image_metric_fns``
    maps names to ``fn(img_hat, img_tgt) -> scalar`` on the decoded
    images)."""
    mcfg = cfg.model
    sf = mcfg.vae.scaling_factor

    def sample(mean, logvar, eps):
        return (mean.float() + torch.exp(0.5 * logvar.float()) * eps) * sf

    def encode(vae, batch, side, eps):
        if f"{side}_moments" in batch:
            m = batch[f"{side}_moments"]
            return sample(m[:, 0], m[:, 1], eps)
        px = batch[f"{side}_image"]
        if side == "source" and source_repeat > 1:
            mean, logvar = vae.encode_moments(px[::source_repeat])
            tile = lambda t: t.repeat_interleave(source_repeat, dim=0)
            return sample(tile(mean), tile(logvar), eps)
        return vae.encode(px, eps).float() * sf

    def loss_fn(model, batch: Tensors, generator=None, draws=None):
        ids = batch["input_ids"]
        N = ids.shape[0]
        h = mcfg.unet.sample_size
        if "target_image" in batch:
            h = batch["target_image"].shape[1] // 8
        elif "target_moments" in batch:
            h = batch["target_moments"].shape[2]
        d = _draws(batch, (N, h, h, mcfg.unet.in_channels), schedule, generator, draws)
        with torch.no_grad():
            text = model["text_encoder"](ids)
            src_lat = encode(model["vae"], batch, "source", d["source_vae_noise"])
            tgt_lat = encode(model["vae"], batch, "target", d["target_vae_noise"])

        noise, t = d["noise"].float(), d["timesteps"]
        noisy = add_noise(schedule, tgt_lat, noise, t)
        mvd = model["mvd"]
        pred = mvd(
            noisy, t, text,
            source_camera=batch.get("source_camera"),
            target_camera=batch.get("target_camera"),
            source_image_latents=src_lat if mcfg.use_image_conditioning else None,
        )
        metrics = {}
        if mcfg.use_camera_conditioning and batch.get("target_camera") is not None:
            with torch.no_grad():
                _, film = mvd.camera_encoder(batch["source_camera"], batch["target_camera"])
                metrics = film_stats(film)
        ld = noise_loss(
            schedule, pred, noise, tgt_lat, t, snr_gamma=cfg.loss.snr_gamma,
            use_snr=cfg.loss.use_snr_loss, weighting=cfg.loss.weighting,
        )
        if cfg.loss.feature_matching_weight > 0.0:
            # the frozen feature tower over the differentiable x0-hat against
            # the (detached) target latents; "noise_loss" stays the pure
            # noise objective, the optimizer sees the weighted total
            x0_hat = pred_original_sample(schedule, pred, noisy, t)
            feats_pred = mvd.extract_features(x0_hat, text)
            with torch.no_grad():
                feats_tgt = mvd.extract_features(tgt_lat, text)
            fm = feature_matching_loss(feats_pred, feats_tgt)
            ld = {**ld, "feature_matching_loss": fm,
                  "total_loss": ld["noise_loss"] + cfg.loss.feature_matching_weight * fm}
        if with_recon_metrics:
            vae = model["vae"]
            metrics = {**metrics, **reconstruction_metrics(
                schedule, pred, noisy, tgt_lat, t, vae_decode=lambda z: vae.decode(z / sf),
                image_metric_fns=image_metric_fns,
            )}
        return ld.get("total_loss", ld["noise_loss"]), {**ld, **metrics}

    return loss_fn


def make_eval_fn(schedule: NoiseSchedule, cfg: TrainConfig, with_recon_metrics: bool = False,
                 image_metric_fns: Optional[Dict[str, Any]] = None):
    """``eval_fn(model, batch, generator=None, draws=None) -> (loss,
    metrics)`` on (B, V, ...) batches, without gradient; with the
    reconstruction metrics where ``with_recon_metrics``."""
    loss_fn = make_loss_fn(schedule, cfg, with_recon_metrics=with_recon_metrics,
                           image_metric_fns=image_metric_fns)

    @torch.no_grad()
    def eval_fn(model, batch: Tensors, generator=None, draws=None):
        return loss_fn(model, {k: _flat(v) for k, v in batch.items()}, generator, draws)

    return eval_fn


def make_train_step(schedule: NoiseSchedule, cfg: TrainConfig):
    """``step(state, batch, generator=None, draws=None) -> metrics`` on
    (B, V, ...) batches; updates ``state`` in place."""

    def step(state: TrainState, batch: Tensors, generator=None, draws=None) -> Tensors:
        V = batch["input_ids"].shape[1]
        rep = V if (V > 1 and cfg.unique_source_encode) else 1
        loss_fn = make_loss_fn(schedule, cfg, source_repeat=rep)
        state.zero_grad()
        loss, metrics = loss_fn(
            state.model, {k: _flat(v) for k, v in batch.items()}, generator, draws
        )
        loss.backward()
        grads = state.grads()
        metrics = {k: v.detach() for k, v in metrics.items()}
        metrics.update(grad_group_norms(grads))
        metrics.update(grad_group_samples(grads))
        state.apply_gradients(metrics["grad_norm/total"])
        return metrics

    return step
