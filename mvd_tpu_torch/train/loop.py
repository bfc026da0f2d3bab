"""The training loop, in one process or over a mesh of processes.

Counterpart of ``mvd_tpu/train/loop.py:Trainer``:

  * an epoch loop over the data module's train loader through
    ``make_train_step`` (batches copied from pinned memory, without
    waiting), the step's metrics fetched with one copy every
    ``log_every_steps`` (``train/*``, ``train/step_time_s``, ``train/lr``,
    ``epoch``);
  * every ``metrics_log_interval`` steps the reconstruction metrics on the
    training batch (x0-hat decoded by the VAE, SSIM) and the gradient
    histograms;
  * validation (fractional ``val_check_interval`` validates mid-epoch, and
    every epoch ends with one): the eval loss over the val split, then
    20-step DDPM generation (guidance 1.0, ref_scale 0.1, empty prompts,
    seed ``epoch * 1000 + batch``, ``min(2, B * V)`` images per batch,
    rounded up to whole groups of the model's joint views) with PSNR, SSIM,
    pixel MSE and comparison PNGs;
  * checkpoints (``checkpoint/io.py``: top k by ``val/noise_loss`` plus the
    latest), validation before the save, the final save skipped when the
    loop saved that step; ``--resume`` continues a run in its own run dir;
  * the ``max_duration_hours`` stop.

Validation generates through the pipeline's compute-dtype copy of the
networks, cast anew from the train state's masters at each validation and
dropped after it (``MVDPipeline.drop_compute_model``): the cached copy
would otherwise keep the weights of the first validation. Random
numbers come from a ``torch.Generator`` on the model's device, seeded with
``cfg.seed`` at every ``fit``, as the JAX loop restarts its key; the
checkpoint does not hold it, so a resumed run is not bitwise an
uninterrupted one (in either package). ``timings`` holds, per step, the
seconds the loop waited on the loader and the seconds of the step.

Over a ``mesh`` of processes (one per GPU, ``distributed.py``), as the JAX
loop's multi-process branches: each process's loader gives the rows of its
data index and ``distributed.global_batch`` cuts its views; the step and
the evaluation run over the mesh (``make_train_step(mesh=...)``); every
rank starts from the first rank's weights (``replicate_to_mesh``); the
primary mints the run dir and broadcasts it (``broadcast_str``), writes
every checkpoint and log line alone, and alone generates the validation
images, on an unsharded pipeline over the same modules, while the others
wait at their next collective.
"""

from __future__ import annotations

import logging
import os
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from ..checkpoint.io import CheckpointManager, resolve_resume_path
from ..config import TrainConfig
from ..distributed import broadcast_str, global_batch, is_primary, process_count, replicate_to_mesh
from ..metrics.image import psnr, ssim
from ..utils.images import save_image, side_by_side
from ..utils.logging import MetricLogger, create_output_dirs, reuse_output_dirs
from .state import TrainState, count_params, trainable_mask
from .step import make_eval_fn, make_train_step

logger = logging.getLogger(__name__)


def fetch_metrics(metrics: Dict[str, torch.Tensor]) -> Dict[str, float]:
    """0-d device tensors -> host floats with one stack and one copy."""
    if not metrics:
        return {}
    values = torch.stack([v.detach().float().reshape(()) for v in metrics.values()]).cpu().tolist()
    return dict(zip(metrics, values))


class Trainer:
    def __init__(
        self,
        cfg: TrainConfig,
        pipe,
        datamodule,
        mesh=None,
        view_sharded: bool = False,
        output_dir: Optional[str] = None,
        logger: Optional[MetricLogger] = None,
        max_duration_hours: float = 147.0,
        image_metric_fns: Optional[Dict[str, Any]] = None,
        resume_from: Optional[str] = None,
    ):
        self.cfg = cfg
        self.pipe = pipe
        self.dm = datamodule
        self.device = pipe.device
        self.mesh = mesh
        self.view_sharded = view_sharded
        self._multiprocess = process_count() > 1
        if self._multiprocess and mesh is None:
            raise ValueError("multi-process training needs a mesh")
        self._primary = is_primary()
        self.resume_from = resume_from
        self._resume_step: Optional[int] = None
        if resume_from:
            ckpt_dir, self._resume_step = resolve_resume_path(resume_from)
            self.dirs = reuse_output_dirs(os.path.dirname(ckpt_dir))
        elif self._multiprocess:
            # the primary mints the timestamped run dir; every rank enters it
            root = create_output_dirs(output_dir or cfg.output_dir)["root"] if self._primary else None
            self.dirs = reuse_output_dirs(broadcast_str(root, group=mesh.group))
        else:
            self.dirs = create_output_dirs(output_dir or cfg.output_dir)
        self.logger = logger or MetricLogger(self.dirs["logs"], config={"cfg": str(cfg)},
                                             enabled=self._primary)
        self.max_duration_s = max_duration_hours * 3600

        self.train_loader = datamodule.loader("train")
        self.val_loader = datamodule.loader("val")
        if len(self.train_loader) == 0:
            raise ValueError(
                "train loader is empty (0 batches); check dataset_path (dataset has "
                f"{len(getattr(self.train_loader, 'ds', []))} samples; batch_size/"
                "views_per_sample may exceed it). A silent zero-step run would otherwise exit "
                "successfully.")
        steps_per_epoch = max(1, len(self.train_loader))
        self.total_steps = cfg.max_steps or steps_per_epoch * cfg.max_epochs

        replicate_to_mesh(mesh, pipe.model)
        self.state = TrainState.create(pipe.model, cfg, self.total_steps)
        pipe.drop_compute_model()
        mvd = pipe.model["mvd"]
        mask = trainable_mask(mvd, cfg.train_denoising_unet)
        self.logger.log({"params/trainable": count_params(mvd, mask, True),
                         "params/total": count_params(mvd)}, step=0)

        self._lr_schedule = self.state.lr_schedule
        par = dict(mesh=mesh, view_sharded=view_sharded)
        self.step_fn = make_train_step(pipe.schedule, cfg, **par)
        self.loss_fn = make_eval_fn(pipe.schedule, cfg, **par)
        self.image_metric_fns = image_metric_fns
        self.recon_metrics_fn = make_eval_fn(pipe.schedule, cfg, with_recon_metrics=True,
                                             image_metric_fns=image_metric_fns, **par)
        self._local_pipe = None
        self.ckpt = CheckpointManager(self.dirs["checkpoints"], max_to_keep=cfg.max_checkpoints,
                                      save_interval_steps=cfg.checkpoint_every_steps)
        self.timings: List[Dict[str, float]] = []

    def _put_batch(self, batch: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
        """A host batch on the model's device (over a mesh, this rank's
        block of it): from pinned memory without waiting where that is a
        GPU."""
        batch = global_batch(self.mesh, {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()})
        if self.device.type != "cuda":
            return {k: v.contiguous() for k, v in batch.items()}
        return {k: v.contiguous().pin_memory().to(self.device, non_blocking=True)
                for k, v in batch.items()}

    # ------------------------------------------------------------------
    def resume(self, step: Optional[int] = None) -> bool:
        """Restore ``step`` (the latest by default) into the train state, the
        data module's sampling state and the W&B run id."""
        state, meta = self.ckpt.restore(self.state, step)
        if state is None:
            return False
        if meta.get("dataset_state"):
            self.dm.load_state_dict(meta["dataset_state"])
        if meta.get("wandb_run_id") and self.logger.run_id is None:
            self.logger.run_id = meta["wandb_run_id"]
        return True

    def _save(self, step: int, last_val: Dict[str, float], force: bool = False) -> bool:
        """Save ``step`` (the primary writes; the others return whether it
        does)."""
        if not self._primary:
            return force or not (self.ckpt.save_interval_steps and step % self.ckpt.save_interval_steps)
        return self.ckpt.save(step, self.state, dataset_state=self.dm.state_dict(),
                              extra={"wandb_run_id": self.logger.run_id},
                              metrics=last_val or None, force=force)

    # ------------------------------------------------------------------
    def fit(self, resume: bool = False) -> TrainState:
        cfg = self.cfg
        if resume or self.resume_from:
            restored = self.resume(self._resume_step)
            if not restored and self.resume_from:
                logger.error("--resume %s requested but no checkpoint found under %s; training "
                             "starts from step 0 IN THAT RUN DIR",
                             self.resume_from, self.dirs["checkpoints"])
            elif restored:
                logger.info("resumed from step %d (%s)", self.state.step, self.dirs["checkpoints"])
        gen = torch.Generator(self.device).manual_seed(cfg.seed)
        start = time.time()
        step = self.state.step
        last_val: Dict[str, float] = {}
        # a resume that already reached max_steps takes no step
        stop = bool(cfg.max_steps and step >= cfg.max_steps)
        steps_per_epoch = max(1, len(self.train_loader))
        val_every = (max(1, int(steps_per_epoch * cfg.val_check_interval))
                     if cfg.val_check_interval < 1.0 else None)
        trained_any = False
        last_saved_step = -1
        for epoch in range(cfg.max_epochs):
            if stop:
                break
            t_ready = time.perf_counter()
            for batch in self.train_loader:
                wait = time.perf_counter() - t_ready
                t0 = time.perf_counter()
                batch = self._put_batch(batch)
                metrics = self.step_fn(self.state, batch, generator=gen)
                trained_any = True
                hists = {k: v for k, v in metrics.items() if k.startswith("hist/")}
                metrics = {k: v for k, v in metrics.items() if not k.startswith("hist/")}
                step = self.state.step
                if step % cfg.log_every_steps == 0:
                    logged = {f"train/{k}": v for k, v in fetch_metrics(metrics).items()}
                    logged["train/step_time_s"] = time.perf_counter() - t0
                    logged["train/lr"] = float(self._lr_schedule(step))
                    logged["epoch"] = epoch
                    self.logger.log(logged, step=step)
                self.timings.append({"step": step, "loader_wait_s": wait,
                                     "step_s": time.perf_counter() - t0})
                if cfg.metrics_log_interval and step % cfg.metrics_log_interval == 0:
                    _, rm = self.recon_metrics_fn(self.state.model, batch, generator=gen)
                    rm = fetch_metrics(rm)
                    self.logger.log({
                        f"train/{k}": v for k, v in rm.items()
                        if k.startswith(("latent_recon", "pixel_recon", "ssim"))
                        or k in (self.image_metric_fns or {})
                    }, step=step)
                    if hists:
                        self.logger.log_histograms(
                            {k[len("hist/"):]: v for k, v in hists.items()}, step=step)
                # validate before the save, so that a checkpoint carries this
                # step's metrics; a failure there must not cost the save
                if val_every and step % val_every == 0:
                    try:
                        last_val = self.validate(epoch, gen)
                    except Exception:
                        logger.exception("in-loop validation failed at step %d; saving with the "
                                         "previous validation's metrics", step)
                if step % cfg.checkpoint_every_steps == 0 and self._save(step, last_val):
                    last_saved_step = step
                if cfg.max_steps and step >= cfg.max_steps:
                    stop = True
                    break
                if time.time() - start > self.max_duration_s:
                    stop = True
                    break
                t_ready = time.perf_counter()
            last_val = self.validate(epoch, gen)
        # the final save, unless the loop saved this step already or a
        # resumed, finished run took no step (its checkpoint is this state)
        if max(step, 1) == last_saved_step:
            pass
        elif trained_any or self.ckpt.latest_step() is None:
            self._save(max(step, 1), last_val, force=True)
        else:
            logger.info("no training steps taken (resumed at step %d, already complete); "
                        "keeping the existing checkpoint", step)
        self.ckpt.wait()
        if self._multiprocess:  # the final checkpoint is on disk before any rank returns
            torch.distributed.barrier(group=self.mesh.group)
        return self.state

    # ------------------------------------------------------------------
    def validate(self, epoch: int, gen: Optional[torch.Generator] = None, max_batches: int = 8,
                 generate: bool = True, gen_batches: int = 4) -> Dict[str, float]:
        losses, gen_pool = [], []
        for i, batch in enumerate(self.val_loader):
            if i >= max_batches:
                break
            if len(gen_pool) < gen_batches:
                gen_pool.append(batch)
            loss, _ = self.loss_fn(self.state.model, self._put_batch(batch), generator=gen)
            losses.append(loss.float())
        out: Dict[str, float] = {}
        if losses:
            out["val/noise_loss"] = float(np.mean(torch.stack(losses).cpu().numpy()))
        if generate and gen_pool and self._primary:
            # over several processes the primary generates alone, on an
            # unsharded pipeline; the others go on to their next collective
            out.update(self._generation_metrics(gen_pool, epoch))
        if out:
            self.logger.log(out, step=self.state.step)
        return out

    def _generation_metrics(self, batches, epoch: int) -> Dict[str, float]:
        """20-step generation over the validation batches, their metrics
        averaged over the batches, and comparison sheets (source | target |
        generated) of the first batch."""
        pipe = self._local_pipeline()
        pipe.drop_compute_model()  # cast from this step's masters
        try:
            return self._generate_batches(pipe, batches, epoch)
        finally:
            pipe.drop_compute_model()

    def _local_pipeline(self):
        """The pipeline validation generates with: ``self.pipe``, or, where
        it holds a mesh, its unsharded single-process twin on the same
        modules (no collective, so that the primary runs it alone)."""
        if self.pipe.mesh is None:
            return self.pipe
        if self._local_pipe is None:
            p = self.pipe
            self._local_pipe = type(p)(p.config, p.model, p.device, p.tokenizer)
        return self._local_pipe

    def _generate_batches(self, pipe, batches, epoch: int) -> Dict[str, float]:
        per_batch, panels = [], {}
        for bi, batch in enumerate(batches):
            B, V = batch["source_image"].shape[:2]
            # two images, or the smallest whole group of joint views above
            # them (the JAX loop takes two, which only V <= 2 divides)
            views = pipe.config.unet.num_views
            n = min(B * V, -(-min(2, B * V) // views) * views)
            flat = {k: np.asarray(v).reshape((-1,) + v.shape[2:])[:n] for k, v in batch.items()}
            src = (flat["source_image"] + 1) / 2
            res = src.shape[1]
            images = pipe(
                [""] * n, num_inference_steps=20, guidance_scale=1.0, height=res, width=res,
                source_camera=flat["source_camera"], target_camera=flat["target_camera"],
                source_images=src, ref_scale=0.1, seed=epoch * 1000 + bi, output_type="pt",
            )["images"].float()
            tgt_np = (flat["target_image"] + 1) / 2
            tgt = torch.from_numpy(tgt_np).to(images.device)
            mse, p, s = torch.stack([((images - tgt) ** 2).mean(), psnr(images, tgt, data_range=1.0),
                                     ssim(images, tgt, data_range=1.0)]).cpu().tolist()
            per_batch.append({"val/gen_pixel_mse": mse, "val/gen_psnr": p, "val/gen_ssim": s})
            if bi == 0:
                gen_np = images.cpu().numpy()
                for i in range(n):
                    sheet = side_by_side([src[i], tgt_np[i], gen_np[i]])
                    save_image(sheet, f"{self.dirs['comparisons']}/epoch{epoch:03d}_sample{i}.png")
                    panels[f"val/comparison_{i}"] = sheet
        m = {k: float(np.mean([pb[k] for pb in per_batch])) for k in per_batch[0]}
        self.logger.log_images(panels, step=self.state.step)
        return m
