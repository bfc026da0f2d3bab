"""Pretrain the VAE on a rendered corpus (reconstruction + KL).

Counterpart of ``tools/pretrain_vae.py``. The reference ships SD2.1's
pretrained AutoencoderKL and freezes it; with no network there are no
pretrained weights, and a random VAE decoder makes pixel-space evaluation
meaningless. This tool trains the stand-in: an AutoencoderKL trained from
scratch on the corpus's train split (the same seeded split
``ObjaverseDataset`` uses, so held-out objects stay unseen) and written by
``checkpoint.save_params`` as a ``vae`` component, which ``cli.train
--init-params``, ``cli.precompute_latents --checkpoint`` and ``cli.val
--vae-params`` read.

    python -m mvd_tpu_torch.tools.pretrain_vae --dataset-path /data/corpus \\
        --config config/evidence_256.yaml --steps 3000 --output /data/vae_params

The JAX tool's flags, with ``--device`` in place of ``--platform``: the GPU
by default (without one it raises), ``--device cpu`` for the tests. Without
``--config`` the VAE is SD2.1's (128, 256, 512, 512) at
``TrainConfig.image_size`` (768²).

What each step computes is the JAX tool's: the [-1, 1] batch in f32, the
posterior sample ``mean + exp(logvar / 2) * noise``, the decode, the
reconstruction MSE in f32 against the f32 batch, the KL term in the compute
dtype of mean and logvar, then optax's ``clip_by_global_norm(1.0)`` and
``adamw`` (b1 0.9, b2 0.999, eps 1e-8, weight decay 1e-4 on every
parameter) at ``cosine_decay_schedule(lr, steps, alpha=0.1)``; update k
runs at count k - 1, so step 1 runs at the full lr. Parameters are f32
masters; every Linear and Conv2d computes in ``cfg.model.dtype``, as
``TrainState.create`` sets it, and every GroupNorm forward runs the K2
kernel on the card. The noise comes from a ``torch.Generator`` seeded with
``seed + 1``: ``jax.random`` cannot be reproduced, so the tests hand both
tools' losses the same noise. The host reads the device only where the JAX
tool does (the loss at step 1 and every 100 steps, validation, the latent
probe and the save), never on another step.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import queue
import threading
import time
import zipfile
from typing import Callable, Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..utils.images import decode_image, resize

PREFETCH = 4  # batches the loader thread keeps ready (the JAX tool's depth)
MAX_GRAD_NORM = 1.0
BETAS = (0.9, 0.999)
WEIGHT_DECAY = 1e-4
LR_FLOOR = 0.1  # the cosine's alpha: the last step runs at 0.1 lr


def build_image_index(files: Sequence[str]) -> List[Tuple[str, str]]:
    """(zip_path, png_name) for every view of every object zip."""
    index = []
    for zp in files:
        with zipfile.ZipFile(zp) as z:
            for n in sorted(z.namelist()):
                if n.endswith(".png"):
                    index.append((zp, n))
    return index


def load_image(zp: str, name: str, size: int) -> np.ndarray:
    """PNG -> (size, size, 3) uint8: RGBA composited over white (the
    dataset loader's convention), then Lanczos-resized; bitwise the JAX
    tool's PIL path. Kept uint8 on the host: the [-1, 1] normalize runs on
    the device."""
    with zipfile.ZipFile(zp) as z:
        img = decode_image(z.read(name), composite_alpha=True)
    return resize(img, size, size)


def cosine_decay_schedule(init_value: float, decay_steps: int, alpha: float = 0.0) -> Callable[[int], float]:
    """optax's ``cosine_decay_schedule``: ``init_value`` decayed along half
    a cosine to ``alpha * init_value`` at ``decay_steps``, flat after."""

    def schedule(count: int) -> float:
        frac = min(count, decay_steps) / decay_steps
        return init_value * ((1.0 - alpha) * 0.5 * (1.0 + math.cos(math.pi * frac)) + alpha)

    return schedule


def make_optimizer(vae: torch.nn.Module) -> torch.optim.AdamW:
    """AdamW over every parameter of ``vae`` (the JAX tool's optax adamw)."""
    from ..train.state import make_adamw

    return make_adamw(vae.parameters(), BETAS, WEIGHT_DECAY)


def to_unit_range(batch_u8: torch.Tensor) -> torch.Tensor:
    """uint8 images -> f32 in [-1, 1]."""
    return batch_u8.float() / 127.5 - 1.0


def vae_loss(vae, batch_u8: torch.Tensor, noise: torch.Tensor,
             kl_weight: float) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(loss, recon, kl) of a uint8 batch (B, H, W, 3) with the posterior
    sample's noise (B, H/8, W/8, latent channels): the reconstruction MSE
    in f32 against the f32 batch, the KL to N(0, 1) in the dtype of the
    moments, ``loss = recon + kl_weight * kl``."""
    batch = to_unit_range(batch_u8)
    mean, logvar = vae.encode_moments(batch)
    z = mean + torch.exp(0.5 * logvar) * noise.to(mean.dtype)
    recon = vae.decode(z)
    recon_loss = torch.mean(torch.square(recon.float() - batch))
    kl = -0.5 * torch.mean(1.0 + logvar - torch.square(mean) - torch.exp(logvar))
    return recon_loss + kl_weight * kl, recon_loss, kl


def to_device(batch_u8, device: torch.device) -> torch.Tensor:
    """A host uint8 batch on ``device``; to the GPU from pinned memory and
    without a wait, so a step never syncs on its upload."""
    t = torch.as_tensor(batch_u8)
    if device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)


def apply_update(optimizer: torch.optim.AdamW, lr: float) -> None:
    """optax's ``clip_by_global_norm(MAX_GRAD_NORM)`` then one AdamW step at
    ``lr``, on the gradients held in each parameter's ``grad``."""
    from ..train.state import clip_by_global_norm_

    grads = [p.grad for group in optimizer.param_groups for p in group["params"]]
    norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
    clip_by_global_norm_(grads, norm, MAX_GRAD_NORM)
    for group in optimizer.param_groups:
        group["lr"] = lr
    optimizer.step()


def train_step(vae, optimizer: torch.optim.AdamW, lr: float, batch_u8, generator: torch.Generator,
               kl_weight: float, compute_dtype: torch.dtype) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One update at learning rate ``lr`` on the host batch ``batch_u8``:
    upload, noise from ``generator``, loss, gradients, the global-norm
    clip and AdamW. Returns (loss, recon, kl) as 0-d device tensors; reads
    nothing back from the device."""
    device = next(vae.parameters()).device
    batch = to_device(batch_u8, device)
    B, H, W, _ = batch.shape
    noise = torch.randn((B, H // 8, W // 8, vae.cfg.latent_channels), generator=generator, device=device,
                        dtype=compute_dtype)
    optimizer.zero_grad(set_to_none=True)
    loss, recon, kl = vae_loss(vae, batch, noise, kl_weight)
    loss.backward()
    apply_update(optimizer, lr)
    return loss.detach(), recon.detach(), kl.detach()


def _chunks(batch_u8: torch.Tensor, chunk: int):
    return [batch_u8[i:i + chunk] for i in range(0, batch_u8.shape[0], chunk)]


@torch.no_grad()
def val_recon(vae, batch_u8: torch.Tensor, chunk: int) -> torch.Tensor:
    """Reconstruction PSNR of the posterior mean (data range 2), per image,
    averaged over the images; ``chunk`` images a forward. A 0-d f32
    device tensor."""
    psnr = []
    for part in _chunks(batch_u8, chunk):
        batch = to_unit_range(part)
        mean, _ = vae.encode_moments(batch)
        recon = vae.decode(mean).float()
        mse = torch.mean(torch.square(recon - batch), dim=(1, 2, 3))
        psnr.append(10.0 * torch.log10(4.0 / mse))
    return torch.cat(psnr).mean()


@torch.no_grad()
def latent_std(vae, batch_u8: torch.Tensor, chunk: int) -> torch.Tensor:
    """Standard deviation (population) of the posterior means of a uint8
    batch, ``chunk`` images an encode: the latent scale that
    ``vae_config.scaling_factor`` should invert. A 0-d f32 device tensor."""
    means = [vae.encode_moments(to_unit_range(part))[0].float() for part in _chunks(batch_u8, chunk)]
    return torch.std(torch.cat(means), correction=0)


def batch_stream(index: Sequence[Tuple[str, str]], batch_size: int, size: int,
                 seed: int) -> Iterator[np.ndarray]:
    """Endless uint8 batches (batch_size, size, size, 3): epochs of the
    ``np.random.default_rng(seed)`` permutation of ``index``, the last
    partial batch of each dropped, decoded on a background thread PREFETCH
    batches ahead. Closing the generator stops the thread; a decode error
    is raised to the consumer."""
    if len(index) < batch_size:
        raise ValueError(f"{len(index)} images make no batch of {batch_size}")
    q: "queue.Queue" = queue.Queue(maxsize=PREFETCH)
    stop = threading.Event()

    def put(item) -> bool:
        while not stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except queue.Full:
                pass
        return False

    def produce():
        try:
            order_rng = np.random.default_rng(seed)
            while True:
                order = order_rng.permutation(len(index))
                for s in range(0, len(order) - batch_size + 1, batch_size):
                    batch = np.stack([load_image(*index[i], size) for i in order[s:s + batch_size]])
                    if not put(batch):
                        return
        except Exception as e:  # handed to the consumer, which raises it
            put(e)

    thread = threading.Thread(target=produce, name="pretrain_vae-batches", daemon=True)
    thread.start()
    try:
        while True:
            item = q.get()
            if isinstance(item, Exception):
                raise item
            yield item
    finally:
        stop.set()
        thread.join(timeout=60)


def vae_state_dict(vae) -> Dict[str, torch.Tensor]:
    """The parameters as contiguous host tensors, for ``save_params``."""
    return {k: v.detach().to("cpu").contiguous() for k, v in vae.state_dict().items()}


def build_argparser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description="Pretrain the VAE on a rendered corpus (reconstruction + KL)")
    ap.add_argument("--dataset-path", required=True)
    ap.add_argument("--output", required=True, help="save_params output dir")
    ap.add_argument("--config", default=None, help="YAML with vae_config overrides")
    ap.add_argument("--steps", type=int, default=3000)
    ap.add_argument("--batch-size", type=int, default=16)
    ap.add_argument("--image-size", type=int, default=None)
    ap.add_argument("--lr", type=float, default=1e-4)
    ap.add_argument("--kl-weight", type=float, default=1e-6)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--val-every", type=int, default=500)
    ap.add_argument("--device", default="cuda", help="cuda (default; raises without a GPU) or cpu")
    return ap


def main(argv: Optional[Sequence[str]] = None) -> dict:
    """Train, validate, probe the latent scale and save; returns what
    ``mvd_config.json`` records, with the logged losses under ``"logged"``."""
    args = build_argparser().parse_args(argv)

    from ..checkpoint import save_params
    from ..config import TrainConfig, train_config_from_yaml
    from ..data.latent_cache import corpus_zips
    from ..data.objaverse import split_files
    from ..nn.layers import set_compute_dtype
    from ..nn.vae import AutoencoderKL
    from ..pipeline.pipeline import DTYPES, init_weights, resolve_device

    device = resolve_device(args.device)
    cfg = train_config_from_yaml(args.config) if args.config else TrainConfig()
    size = args.image_size or cfg.image_size
    compute_dtype = DTYPES[cfg.model.dtype]

    # the splits ObjaverseDataset takes at its defaults (seed 42, 0.1 / 0.1)
    zips = corpus_zips(args.dataset_path)
    train_idx = build_image_index(split_files(zips, 42, 0.1, 0.1, "train")[0])
    val_idx = build_image_index(split_files(zips, 42, 0.1, 0.1, "val")[0])[: args.batch_size * 4]
    print(f"train images: {len(train_idx)}, val images: {len(val_idx)}")

    with torch.device(device):
        vae = AutoencoderKL(cfg.model.vae)
    init_weights(vae, torch.Generator(device).manual_seed(args.seed))
    for p in vae.parameters():  # f32 masters, conv weights channels_last
        if p.dim() == 4:
            p.data = p.data.contiguous(memory_format=torch.channels_last)
    set_compute_dtype(vae, None if compute_dtype == torch.float32 else compute_dtype)
    optimizer = make_optimizer(vae)
    schedule = cosine_decay_schedule(args.lr, args.steps, alpha=LR_FLOOR)

    val_batch = None
    if val_idx:
        val_batch = torch.from_numpy(np.stack([load_image(zp, n, size) for zp, n in val_idx])).to(device)

    it = batch_stream(train_idx, args.batch_size, size, args.seed)
    generator = torch.Generator(device).manual_seed(args.seed + 1)
    history, logged = [], []
    t0 = time.time()
    try:
        for step in range(1, args.steps + 1):
            loss, recon, kl = train_step(vae, optimizer, schedule(step - 1), next(it), generator,
                                         args.kl_weight, compute_dtype)
            if step == 1 or step % 100 == 0:
                loss, recon, kl = float(loss), float(recon), float(kl)
                logged.append({"step": step, "loss": loss, "recon": recon, "kl": kl})
                print(f"step {step}: loss={loss:.5f} recon={recon:.5f} kl={kl:.3f} "
                      f"({time.time() - t0:.0f}s)", flush=True)
            if val_batch is not None and (step % args.val_every == 0 or step == args.steps):
                psnr = float(val_recon(vae, val_batch, args.batch_size))
                history.append({"step": step, "val_recon_psnr_db": round(psnr, 3)})
                print(f"step {step}: val recon PSNR {psnr:.2f} dB", flush=True)

        # the diffusion schedule assumes ~unit-variance latents (SD's
        # scaling_factor 0.18215 is 1/std of its VAE's latents)
        probe = val_batch if val_batch is not None else to_device(next(it), device)
    finally:
        it.close()
    std = float(latent_std(vae, probe, args.batch_size))
    rec_scaling = 1.0 / max(std, 1e-6)
    print(f"latent std {std:.4f} -> recommended vae_config.scaling_factor {rec_scaling:.5f}")

    meta = {
        "tool": "pretrain_vae",
        "image_size": size,
        "steps": args.steps,
        "kl_weight": args.kl_weight,
        "compute_dtype": cfg.model.dtype,
        "latent_std": std,
        "recommended_scaling_factor": rec_scaling,
        "val_history": history,
    }
    os.makedirs(os.path.dirname(os.path.abspath(args.output)), exist_ok=True)
    save_params(args.output, {"vae": vae_state_dict(vae)}, config_json=json.dumps(meta))
    print(f"saved VAE params to {args.output}")
    if device.type == "cuda":
        print(f"peak device memory {torch.cuda.max_memory_allocated(device) / 2**30:.2f} GiB")
    if history:
        print(f"final val recon PSNR: {history[-1]['val_recon_psnr_db']} dB")
    return {**meta, "logged": logged}


if __name__ == "__main__":
    main()
