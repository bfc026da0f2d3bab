"""Validation harness: generation over a loader with per-sample PSNR and
SSIM, the tower metrics, comparison PNGs, timing, and the two CSV outputs.

Counterpart of ``mvd_tpu/metrics/harness.py:run_validation``:
``validation_results.csv`` (one row per sample, with ``perceptual``,
``lpips`` and ``clip_score`` per batch where those towers are available)
and ``overall_metrics.csv`` (``fid`` where its tower is available, the
towers' means, mean/std/min/max of PSNR, SSIM and MSE, and from the second
batch on, which excludes first-call costs, the batch times and images per
second), with the JAX package's columns in its order. Each generation is
timed to the end of its device work. ``towers`` is what
``metrics.load_towers.load_towers`` returns; each tower runs on the device
of the generated images: perceptual and LPIPS on [-1, 1], CLIP on [0, 1],
FID with the targets as real and the generations as fake, on [0, 1].
"""

from __future__ import annotations

import csv
import os
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from ..utils.images import save_image, side_by_side
from .image import psnr_per_image, ssim


def run_validation(
    pipe,
    loader,
    output_dir: str,
    num_inference_steps: int = 20,
    guidance_scale: float = 1.0,
    ref_scale: float = 0.1,
    max_batches: Optional[int] = None,
    save_images: bool = True,
    seed: int = 0,
    towers: Optional[Dict] = None,
    sampler: Optional[str] = None,
    encoder_reuse: int = 1,
) -> Dict[str, float]:
    towers = towers or {}
    fid = towers.get("fid")
    os.makedirs(output_dir, exist_ok=True)
    rows: List[Dict] = []
    batch_times: List[tuple] = []
    n_samples = 0
    for bi, batch in enumerate(loader):
        if max_batches is not None and bi >= max_batches:
            break
        flat = {k: np.asarray(v).reshape((-1,) + v.shape[2:]) for k, v in batch.items()}
        n = flat["source_image"].shape[0]
        src = (flat["source_image"] + 1) / 2
        tgt_np = (flat["target_image"] + 1) / 2
        res = src.shape[1]

        t0 = time.perf_counter()
        gen = pipe(
            [""] * n, num_inference_steps=num_inference_steps, guidance_scale=guidance_scale,
            height=res, width=res, source_camera=flat["source_camera"],
            target_camera=flat["target_camera"], source_images=src, ref_scale=ref_scale,
            seed=seed + bi, output_type="pt", sampler=sampler, encoder_reuse=encoder_reuse,
        )["images"].float()
        if gen.is_cuda:
            torch.cuda.synchronize(gen.device)
        dt = time.perf_counter() - t0
        if bi > 0:  # the first batch holds first-call costs
            batch_times.append((dt, n))
        tgt = torch.from_numpy(tgt_np).to(gen.device)
        p = psnr_per_image(gen, tgt, data_range=1.0).cpu().numpy()
        s = ssim(gen, tgt, data_range=1.0, per_image=True).cpu().numpy()
        mse = ((gen - tgt) ** 2).mean(dim=(1, 2, 3)).cpu().numpy()

        extra: Dict[str, float] = {}
        gen_m11, tgt_m11 = gen * 2 - 1, tgt * 2 - 1
        for key, name, a, b in (("perceptual", "perceptual", gen_m11, tgt_m11),
                                ("lpips", "lpips", gen_m11, tgt_m11),
                                ("clip", "clip_score", gen, tgt)):
            tower = towers.get(key)
            if tower is not None and tower.available:
                extra[name] = float(tower(a, b))
        if fid is not None and fid.available:
            fid.update(tgt, real=True)
            fid.update(gen, real=False)
        for i in range(n):
            rows.append({"batch": bi, "sample": n_samples + i, "psnr": float(p[i]),
                         "ssim": float(s[i]), "mse": float(mse[i]), "inference_time_s": dt / n,
                         **extra})
        if save_images and bi < 4:
            gen_np = gen.cpu().numpy()
            for i in range(min(n, 2)):
                sheet = side_by_side([src[i], tgt_np[i], gen_np[i]])
                save_image(sheet, os.path.join(output_dir, f"val_b{bi}_s{i}.png"))
        n_samples += n

    if rows:
        with open(os.path.join(output_dir, "validation_results.csv"), "w", newline="") as f:
            w = csv.DictWriter(f, fieldnames=list(rows[0].keys()))
            w.writeheader()
            w.writerows(rows)
    overall: Dict[str, float] = {"num_samples": n_samples}
    if fid is not None and fid.available and n_samples:
        overall["fid"] = fid.compute()
    for extra_key in ("perceptual", "lpips", "clip_score"):
        vals = [r[extra_key] for r in rows if extra_key in r]
        if vals:
            overall[f"{extra_key}_mean"] = float(np.mean(vals))
    for key in ("psnr", "ssim", "mse"):
        vals = np.array([r[key] for r in rows]) if rows else np.array([0.0])
        overall[f"{key}_mean"] = float(vals.mean())
        overall[f"{key}_std"] = float(vals.std())
        overall[f"{key}_min"] = float(vals.min())
        overall[f"{key}_max"] = float(vals.max())
    if batch_times:
        bt = np.array([t for t, _ in batch_times])
        n_timed = sum(n for _, n in batch_times)
        overall.update({
            "batch_time_mean_s": float(bt.mean()), "batch_time_std_s": float(bt.std()),
            "batch_time_min_s": float(bt.min()), "batch_time_max_s": float(bt.max()),
            "total_inference_s": float(bt.sum()), "img_per_sec": float(n_timed / bt.sum()),
        })
    with open(os.path.join(output_dir, "overall_metrics.csv"), "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["metric", "value"])
        for k, v in overall.items():
            w.writerow([k, v])
    return overall
