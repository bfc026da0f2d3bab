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
across the V views of each sample.

Over a mesh of processes (``mesh.py``) each rank runs its block of the
global batch and the step keeps both of the JAX package's semantics:

  * data-parallel (``view_sharded=False``, a whole view axis): the rank's
    rows are its data index's (B_l, V, ...); the draws are those of the
    global batch from the one generator (JAX: one key over rows that GSPMD
    shards), of which it takes its rows;
  * view-sharded (``view_sharded=True``, the model's ``view_axis`` "view"):
    the rank's (B_l, V_l, ...) block runs with ring attention between the
    view processes, forward and backward inside ``Mesh.bind``, from draws
    of its own generator, seeded from the caller's and folded with its
    data and view indices (JAX: ``fold_in`` of both axis indices).

Either way the loss, its metrics and the trainable gradients are averaged
over the mesh by one all-reduce of one flat f32 buffer, divided by the
number of processes, before the global-norm clip (optax clips the summed
gradient of the global mean loss, so this is the same). No
``DistributedDataParallel``: its hooks would fire inside remat's recompute,
and the step orders its own work. Given ``draws``, a sharded step takes
the global batch's (N = B*V rows), from which it takes its rows.
"""

from __future__ import annotations

import contextlib
from typing import Any, Dict, Optional

import torch
import torch.distributed as dist

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


class _Sharding:
    """Where a rank's rows sit in the global batch of a mesh, and how it
    draws and reduces: the two branches of the JAX step."""

    def __init__(self, mesh, view_sharded: bool, cfg: TrainConfig):
        if not mesh.member:
            raise RuntimeError(f"rank {mesh.rank} is not in {mesh!r}")
        if mesh.shape["model"] > 1:
            raise NotImplementedError(
                f"a train step on a model axis of {mesh.shape['model']}: the model axis in training "
                "(ROADMAP item 17) is not ported; the JAX package's meshed step keeps its "
                "parameters replicated")
        if view_sharded and cfg.model.unet.view_axis != "view":
            raise ValueError("a view-sharded step needs a model whose view_axis is 'view' "
                             f"(parallel.for_view_sharding), got {cfg.model.unet.view_axis!r}")
        if not view_sharded and mesh.shape["view"] > 1:
            raise ValueError("a data-parallel step over a mesh with a view axis of "
                             f"{mesh.shape['view']} needs view_sharded=True (ring attention)")
        self.mesh, self.view_sharded = mesh, view_sharded

    def global_rows(self, batch: Tensors) -> tuple:
        """(B, V) of the global batch that this rank's (B_l, V_l) block is
        part of."""
        B, V = batch["input_ids"].shape[:2]
        return B * self.mesh.shape["data"], V * self.mesh.shape["view"]

    def draws(self, batch: Tensors, lat: int, channels: int, schedule, generator, draws):
        B, V = self.global_rows(batch)
        if draws is None and self.view_sharded:
            # JAX folds the data and view indices into the shard's key
            c = self.mesh.coords
            seed = int(torch.randint(0, 2**62, (), generator=generator,
                                     device=generator.device if generator is not None else "cpu"))
            dev = batch["input_ids"].device
            gen = torch.Generator(dev).manual_seed(hash((seed, c["data"], c["view"])) & (2**63 - 1))
            n = batch["input_ids"].shape[0] * batch["input_ids"].shape[1]
            return _draws(batch, (n, lat, lat, channels), schedule, gen, None)
        full = _draws(batch, (B * V, lat, lat, channels), schedule, generator, draws)
        block = lambda x: self.mesh.block(x.reshape((B, V) + tuple(x.shape[1:]))).flatten(0, 1)
        return {k: block(v) for k, v in full.items()}

    def bind(self):
        return self.mesh.bind()

    def mean(self, tensors) -> None:
        """Replace each tensor of ``tensors`` by its mean over the mesh, in
        place: one all-reduce of one flat f32 buffer."""
        if not dist.is_initialized():
            return
        flat = torch.cat([t.detach().reshape(-1).float() for t in tensors])
        dist.all_reduce(flat, group=self.mesh.group)
        flat /= self.mesh.group_size
        i = 0
        for t in tensors:
            t.copy_(flat[i:i + t.numel()].view(t.shape))
            i += t.numel()


def _latent_size(batch: Tensors, mcfg) -> int:
    if "target_image" in batch:
        return batch["target_image"].shape[-3] // 8
    if "target_moments" in batch:
        return batch["target_moments"].shape[-2]
    return mcfg.unet.sample_size


def make_eval_fn(schedule: NoiseSchedule, cfg: TrainConfig, with_recon_metrics: bool = False,
                 image_metric_fns: Optional[Dict[str, Any]] = None, mesh=None,
                 view_sharded: bool = False):
    """``eval_fn(model, batch, generator=None, draws=None) -> (loss,
    metrics)`` on (B, V, ...) batches, without gradient; with the
    reconstruction metrics where ``with_recon_metrics``. Over a ``mesh``,
    ``batch`` is this rank's block and the loss and its 0-d metrics are
    means over the mesh."""
    loss_fn = make_loss_fn(schedule, cfg, with_recon_metrics=with_recon_metrics,
                           image_metric_fns=image_metric_fns)
    shard = _Sharding(mesh, view_sharded, cfg) if mesh is not None else None

    @torch.no_grad()
    def eval_fn(model, batch: Tensors, generator=None, draws=None):
        flat = {k: _flat(v) for k, v in batch.items()}
        if shard is None:
            return loss_fn(model, flat, generator, draws)
        d = shard.draws(batch, _latent_size(batch, cfg.model), cfg.model.unet.in_channels,
                        schedule, generator, draws)
        with shard.bind():
            loss, metrics = loss_fn(model, flat, None, d)
        scalars = [loss] + [v for v in metrics.values() if v.dim() == 0]
        shard.mean(scalars)
        return loss, metrics

    return eval_fn


def make_train_step(schedule: NoiseSchedule, cfg: TrainConfig, mesh=None, view_sharded: bool = False):
    """``step(state, batch, generator=None, draws=None) -> metrics`` on
    (B, V, ...) batches; updates ``state`` in place. Over a ``mesh``
    (``view_sharded`` as in the JAX step), ``batch`` is this rank's block
    and the step's metrics are the mesh's."""
    shard = _Sharding(mesh, view_sharded, cfg) if mesh is not None else None

    def step(state: TrainState, batch: Tensors, generator=None, draws=None) -> Tensors:
        V = batch["input_ids"].shape[1]  # the rank's views under view sharding
        rep = V if (V > 1 and cfg.unique_source_encode) else 1
        loss_fn = make_loss_fn(schedule, cfg, source_repeat=rep)
        state.zero_grad()
        flat = {k: _flat(v) for k, v in batch.items()}
        if shard is not None:
            draws = shard.draws(batch, _latent_size(batch, cfg.model), cfg.model.unet.in_channels,
                                schedule, generator, draws)
            generator = None
        with shard.bind() if shard is not None else contextlib.nullcontext():
            loss, metrics = loss_fn(state.model, flat, generator, draws)
            loss.backward()
        grads = state.grads()
        metrics = {k: v.detach() for k, v in metrics.items()}
        if shard is not None:
            shard.mean([v for v in metrics.values() if v.dim() == 0] + list(grads.values()))
        metrics.update(grad_group_norms(grads))
        metrics.update(grad_group_samples(grads))
        state.apply_gradients(metrics["grad_norm/total"])
        return metrics

    return step
