"""Observability: run directories, metric logging, NaN guards.

Counterpart of ``mvd_tpu/utils/logging.py``. Metrics always stream to
``<logs>/metrics.jsonl``; W&B is imported only when the caller asks for it
(``use_wandb=True``) and is used when it imports and initializes, so a run
without it logs to the JSONL alone. ``enable_nan_debugging`` is
``torch.autograd.set_detect_anomaly``; the JAX package's compilation-cache
switch has no counterpart.
"""

from __future__ import annotations

import json
import logging
import os
import time
from datetime import datetime
from typing import Any, Dict, Optional

import numpy as np
import torch

logger = logging.getLogger(__name__)

RUN_SUBDIRS = ("checkpoints", "comparisons", "samples", "logs")


def reuse_output_dirs(root: str) -> Dict[str, str]:
    """Re-enter a run dir (a resumed run keeps writing into the same run),
    making its subdirectories where they are missing."""
    root = os.path.abspath(root)
    dirs = {"root": root}
    for sub in RUN_SUBDIRS:
        dirs[sub] = os.path.join(root, sub)
        os.makedirs(dirs[sub], exist_ok=True)
    return dirs


def create_output_dirs(base: str = "outputs") -> Dict[str, str]:
    """A timestamped run dir under ``base`` with checkpoints/, comparisons/,
    samples/ and logs/."""
    return reuse_output_dirs(os.path.join(base, datetime.now().strftime("%Y-%m-%d_%H-%M-%S")))


def log_debug(path: Optional[str], msg: str) -> None:
    """Append one timestamped line to ``path`` (no-op without a path)."""
    if not path:
        return
    with open(path, "a") as f:
        f.write(f"[{datetime.now().isoformat(timespec='milliseconds')}] {msg}\n")


def _scalar(v):
    if isinstance(v, torch.Tensor):
        return float(v.detach().float().cpu())
    if isinstance(v, np.ndarray) or isinstance(v, np.generic):
        return float(v)
    return v


class MetricLogger:
    """JSONL always, W&B when asked for and available. ``enabled=False``
    makes it a no-op sink."""

    def __init__(
        self,
        log_dir: str,
        project: str = "mvd",
        run_name: Optional[str] = None,
        run_id: Optional[str] = None,
        config: Optional[Dict[str, Any]] = None,
        use_wandb: bool = False,
        enabled: bool = True,
    ):
        self.enabled = enabled
        os.makedirs(log_dir, exist_ok=True)
        self.jsonl_path = os.path.join(log_dir, "metrics.jsonl")
        self._f = open(self.jsonl_path, "a") if enabled else None
        self.wandb = None
        self.run_id = run_id
        if use_wandb and enabled:
            try:
                import wandb  # noqa: PLC0415

                self.wandb = wandb.init(
                    project=project, name=run_name, id=run_id,
                    resume="must" if run_id else None, config=config,
                )
                self.run_id = self.wandb.id
            except Exception as e:
                logger.info("wandb unavailable (%s); JSONL only", e)

    def _write(self, rec: Dict[str, Any]) -> None:
        self._f.write(json.dumps(rec) + "\n")
        self._f.flush()

    def log(self, metrics: Dict[str, Any], step: Optional[int] = None):
        """One JSONL record of ``metrics`` (tensors and numpy scalars as
        floats)."""
        if not self.enabled:
            return
        clean = {k: _scalar(v) for k, v in metrics.items()}
        self._write({"step": step, "time": time.time(), **clean})
        if self.wandb is not None:
            self.wandb.log(clean, step=step)

    def log_histograms(self, hists: Dict[str, Any], step: Optional[int] = None, bins: int = 16):
        """Raw-value samples -> a 16-bin record in the JSONL (and W&B
        histograms)."""
        if not self.enabled:
            return
        rec: Dict[str, Any] = {"step": step, "time": time.time()}
        arrays = {k: np.asarray(torch.as_tensor(v).detach().float().cpu(), np.float64)
                  for k, v in hists.items()}
        for k, v in arrays.items():
            counts, edges = np.histogram(v[np.isfinite(v)], bins=bins)
            rec[k] = {"counts": counts.tolist(), "lo": float(edges[0]), "hi": float(edges[-1])}
        self._write(rec)
        if self.wandb is not None:
            import wandb  # noqa: PLC0415

            self.wandb.log({k: wandb.Histogram(v) for k, v in arrays.items()}, step=step)

    def log_images(self, images: Dict[str, np.ndarray], step: Optional[int] = None):
        """Image panels go to W&B only (the PNGs are on disk already)."""
        if self.wandb is not None:
            import wandb  # noqa: PLC0415

            self.wandb.log({k: wandb.Image(np.asarray(v)) for k, v in images.items()}, step=step)

    def finish(self):
        if self._f is not None:
            self._f.close()
            self._f = None
        if self.wandb is not None:
            self.wandb.finish()


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{prefix}[{k!r}]")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{prefix}[{i}]")
    elif isinstance(tree, torch.nn.Module):
        for k, v in tree.state_dict().items():
            yield f"{prefix}.{k}", v
    elif isinstance(tree, (torch.Tensor, np.ndarray, float, int)):
        yield prefix, tree


def check_finite(tree, name: str = "tree") -> bool:
    """Host-side NaN/Inf sweep over the tensors of a dict/list tree or a
    module; logs each non-finite leaf and returns whether all are finite."""
    ok = True
    for path, leaf in _leaves(tree):
        leaf = torch.as_tensor(leaf)
        if leaf.is_floating_point() and not bool(torch.isfinite(leaf).all()):
            logger.error("non-finite values in %s%s", name, path)
            ok = False
    return ok


def enable_nan_debugging():
    """Raise at the backward op that first produces a NaN."""
    torch.autograd.set_detect_anomaly(True)
