"""FID: streaming feature moments and the Fréchet distance, with a
pluggable feature extractor.

Counterpart of ``mvd_tpu/metrics/fid.py``; the statistics are its numpy
code in float64, copied so that the port imports nothing of the JAX
package:

  * ``RunningMoments``: streaming mean and covariance over feature batches
    (exact, not minibatch-biased; torchmetrics' ``update``),
  * ``frechet_distance``: ||mu1 - mu2||² + tr(S1 + S2 - 2 sqrt(S1 S2)), the
    trace of the matrix square root from the eigenvalues of S1·S2 (clipped
    at 0), with eps 1e-6 on each covariance's diagonal,
  * ``FID``: both tied to a feature extractor, which maps [0, 1] NHWC
    images to (N, dim) features on the host. The standard extractor is
    InceptionV3 pool3 (``metrics/inception.py``); ``vgg_pool_extractor``
    gives "FID-VGG", which is not comparable with Inception-FID numbers.
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from .image import no_tf32
from .towers import _imagenet_norm, _nchw, _on


class RunningMoments:
    def __init__(self, dim: int):
        self.dim = dim
        self.n = 0
        self.sum = np.zeros(dim, np.float64)
        self.outer = np.zeros((dim, dim), np.float64)

    def update(self, feats: np.ndarray):
        feats = np.asarray(feats, np.float64)
        if feats.ndim != 2 or feats.shape[1] != self.dim:
            raise ValueError(f"features of shape {feats.shape}, expected (N, {self.dim})")
        self.n += feats.shape[0]
        self.sum += feats.sum(0)
        self.outer += feats.T @ feats

    @property
    def mean(self) -> np.ndarray:
        return self.sum / max(self.n, 1)

    @property
    def cov(self) -> np.ndarray:
        if self.n < 2:
            return np.zeros((self.dim, self.dim))
        mu = self.mean
        return (self.outer - self.n * np.outer(mu, mu)) / (self.n - 1)

    def reset(self):
        self.n = 0
        self.sum[:] = 0
        self.outer[:] = 0


def _sqrtm_trace(a: np.ndarray, b: np.ndarray) -> float:
    """tr(sqrtm(a @ b)) from the eigenvalues of the (non-symmetric) product
    of two PSD matrices: its spectrum is real and non-negative up to
    rounding, so imaginary parts and negative values are dropped."""
    eigs = np.real(np.linalg.eigvals(a @ b))
    eigs[eigs < 0] = 0.0
    return float(np.sqrt(eigs).sum())


def frechet_distance(mu1, cov1, mu2, cov2, eps: float = 1e-6) -> float:
    mu1, mu2 = np.asarray(mu1, np.float64), np.asarray(mu2, np.float64)
    cov1 = np.asarray(cov1, np.float64) + eps * np.eye(len(mu1))
    cov2 = np.asarray(cov2, np.float64) + eps * np.eye(len(mu2))
    diff = mu1 - mu2
    return float(diff @ diff + np.trace(cov1) + np.trace(cov2) - 2.0 * _sqrtm_trace(cov1, cov2))


class FID:
    """Streaming FID between a "real" and a "fake" image set."""

    def __init__(self, extractor: Optional[Callable] = None):
        self.extractor = extractor
        self._real: Optional[RunningMoments] = None
        self._fake: Optional[RunningMoments] = None

    @property
    def available(self) -> bool:
        return self.extractor is not None

    def _moments(self, real: bool) -> RunningMoments:
        bank = self._real if real else self._fake
        if bank is None:
            raise RuntimeError("update() must run once to set the feature width")
        return bank

    def update(self, images01, real: bool):
        """Add the features of ``images01`` ((N, H, W, 3) in [0, 1], a
        tensor on any device or an array) to the real or the fake set."""
        if self.extractor is None:
            raise RuntimeError("FID has no feature extractor")
        feats = np.asarray(self.extractor(images01))
        if self._real is None:
            self._real = RunningMoments(feats.shape[1])
            self._fake = RunningMoments(feats.shape[1])
        self._moments(real).update(feats)

    def compute(self) -> float:
        r, f = self._moments(True), self._moments(False)
        return frechet_distance(r.mean, r.cov, f.mean, f.cov)

    def reset(self):
        if self._real is not None:
            self._real.reset()
            self._fake.reset()


def vgg_pool_extractor(model):
    """Feature extractor from a ``towers.VGG16Features``: the spatial mean
    of its last relu map, ``relu5_3`` ("FID-VGG"). It runs on the device of
    the images it is given, in f32 with TF32 off, and returns the features
    on the host once per batch."""

    def extract(images01) -> np.ndarray:
        x = _nchw(images01)
        with torch.no_grad(), no_tf32():
            feats = _on(model, x)(_imagenet_norm(x * 2 - 1))["relu5_3"]
        return feats.mean(dim=(2, 3)).cpu().numpy()

    return extract
