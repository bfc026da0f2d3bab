"""Precomputed VAE latent-moment cache for training.

Counterpart of ``mvd_tpu/data/latent_cache.py``, in the same on-disk
format, so that a cache written by either package reads in the other::

    <cache_dir>/meta.json         {"image_size": N, "dtype": storage dtype,
                                   "version": 2, "compute_dtype": encoder
                                   numerics, "views": {basename: [keys]}}
    <cache_dir>/<zip_basename>.npz   keys "000", "001", ... each
                                     (2, H/8, W/8, 4): (mean, logvar)

``precompute_latent_cache`` encodes every view of every zip once through
the port's ``AutoencoderKL.encode_moments`` in padded batches of one shape;
training then draws ``mean + exp(0.5 logvar) * eps`` per step from the
cached moments instead of running the VAE encoder. It refuses to extend a
cache built at another image size or another compute dtype.
``LatentCacheReader`` serves per-view moments to the dataset, thread-safe,
with at most ``max_resident`` zips decompressed in memory.
"""

from __future__ import annotations

import json
import logging
import os
import threading
import zipfile
from collections import OrderedDict
from glob import glob
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

logger = logging.getLogger(__name__)

META_NAME = "meta.json"


def cache_file_for(cache_dir: str, zip_path: str) -> str:
    base = os.path.splitext(os.path.basename(zip_path))[0]
    return os.path.join(cache_dir, base + ".npz")


def _list_views(zf: zipfile.ZipFile) -> List[int]:
    views = []
    for name in zf.namelist():
        stem = os.path.basename(name)
        if stem.endswith(".png") and stem[:-4].isdigit():
            views.append(int(stem[:-4]))
    return sorted(set(views))


def write_meta(cache_dir: str, image_size: int, dtype: str, compute_dtype: Optional[str] = None,
               views: Optional[Dict[str, List[str]]] = None):
    """Write ``meta.json`` by a rename: ``compute_dtype`` records the
    encoder's numerics, ``views`` the cached view keys of every npz."""
    os.makedirs(cache_dir, exist_ok=True)
    meta: Dict = {"image_size": image_size, "dtype": dtype, "version": 2}
    if compute_dtype is not None:
        meta["compute_dtype"] = compute_dtype
    if views is not None:
        meta["views"] = views
    tmp = os.path.join(cache_dir, META_NAME + ".tmp")
    with open(tmp, "w") as f:
        json.dump(meta, f)
    os.replace(tmp, os.path.join(cache_dir, META_NAME))


def read_meta(cache_dir: str) -> Optional[Dict]:
    path = os.path.join(cache_dir, META_NAME)
    if not os.path.exists(path):
        return None
    with open(path) as f:
        return json.load(f)


@torch.inference_mode()
def precompute_latent_cache(
    vae,
    zip_paths: Sequence[str],
    cache_dir: str,
    image_size: int,
    batch_size: int = 8,
    dtype: str = "float32",
    overwrite: bool = False,
    compute_dtype: Optional[str] = None,
) -> Dict[str, int]:
    """Encode every view of every zip with ``vae`` (the port's
    ``AutoencoderKL``, on its device and in its compute dtype) and write one
    moment ``.npz`` per zip. Batches are padded to ``batch_size``. Returns
    ``{"zips": n, "views": n, "skipped": n}``. ``compute_dtype`` names the
    encoder's numerics; extending a cache built at another one raises."""
    from .objaverse import _load_image_from_bytes

    store_dtype = np.dtype(dtype)
    existing = read_meta(cache_dir) or {}
    if existing:
        if existing.get("image_size") not in (None, image_size):
            raise ValueError(f"cache at {cache_dir!r} was built at image_size="
                             f"{existing.get('image_size')}, not {image_size}")
        old_cd = existing.get("compute_dtype")
        if compute_dtype and old_cd and old_cd != compute_dtype:
            raise ValueError(
                f"cache at {cache_dir!r} was encoded at compute_dtype={old_cd}; refusing to "
                f"extend it at {compute_dtype} (use a fresh cache dir or --overwrite the whole "
                "corpus)")
    views_map: Dict[str, List[str]] = dict(existing.get("views") or {})
    write_meta(cache_dir, image_size, store_dtype.name, compute_dtype, views_map)
    device = next(vae.parameters()).device

    stats = {"zips": 0, "views": 0, "skipped": 0}
    pending: List[tuple] = []  # (zip_path, view, pixels)
    per_zip: Dict[str, Dict[str, np.ndarray]] = {}
    counts: Dict[str, int] = {}

    def flush():
        if not pending:
            return
        px = np.stack([p[2] for p in pending])
        n = px.shape[0]
        if n < batch_size:  # pad to the one batch shape
            px = np.concatenate([px, np.zeros((batch_size - n,) + px.shape[1:], px.dtype)])
        mean, logvar = vae.encode_moments(torch.from_numpy(px).to(device))
        mom = torch.stack([mean.float(), logvar.float()], dim=1)[:n].cpu().numpy()
        for (zp, view, _), m in zip(pending, mom):
            per_zip[zp][f"{view:03d}"] = m.astype(store_dtype)
            counts[zp] -= 1
            if counts[zp] == 0:
                out = cache_file_for(cache_dir, zp)
                done = per_zip.pop(zp)
                np.savez_compressed(out + ".tmp.npz", **done)
                os.replace(out + ".tmp.npz", out)
                views_map[os.path.splitext(os.path.basename(zp))[0]] = sorted(done)
                stats["zips"] += 1
        stats["views"] += len(pending)
        pending.clear()

    for zp in zip_paths:
        out = cache_file_for(cache_dir, zp)
        if os.path.exists(out) and not overwrite:
            stats["skipped"] += 1
            base = os.path.splitext(os.path.basename(zp))[0]
            if base not in views_map:  # a cache file without a views entry
                with np.load(out) as z:
                    views_map[base] = sorted(z.files)
            continue
        try:
            with zipfile.ZipFile(zp) as zf:
                views = _list_views(zf)
                if not views:
                    logger.warning("no views in %s", zp)
                    continue
                per_zip[zp] = {}
                counts[zp] = len(views)
                for v in views:
                    png = next(n for n in zf.namelist() if os.path.basename(n) == f"{v:03d}.png")
                    pending.append((zp, v, _load_image_from_bytes(zf.read(png), image_size)))
                    if len(pending) == batch_size:
                        flush()
        except (zipfile.BadZipFile, OSError) as e:
            logger.warning("skipping unreadable zip %s: %s", zp, e)
            per_zip.pop(zp, None)
            counts.pop(zp, None)
            pending[:] = [p for p in pending if p[0] != zp]
    flush()
    write_meta(cache_dir, image_size, store_dtype.name, compute_dtype, views_map)
    return stats


class LatentCacheReader:
    """Thread-safe per-view moment lookup: ``read(zip_path, view)`` gives a
    (2, h, w, 4) float32 array of (mean, logvar); ``FileNotFoundError``
    where the zip has no cache file, ``KeyError`` for a missing view."""

    def __init__(self, cache_dir: str, image_size: Optional[int] = None, max_resident: int = 256):
        self.cache_dir = cache_dir
        self.max_resident = max(1, max_resident)
        meta = read_meta(cache_dir)
        if meta is None:
            raise FileNotFoundError(f"latent cache at {cache_dir!r} has no {META_NAME}; run "
                                    "cli/precompute_latents.py over the corpus first")
        if image_size is not None and meta.get("image_size") != image_size:
            raise ValueError(f"latent cache was built at image_size={meta.get('image_size')} "
                             f"but the dataset wants {image_size}; rebuild the cache")
        self.meta = meta
        self._lock = threading.Lock()
        self._handles: "OrderedDict[str, Dict[str, np.ndarray]]" = OrderedDict()

    def coverage(self, zip_paths: Sequence[str]) -> List[str]:
        """The zip paths with no cache file."""
        return [zp for zp in zip_paths if not os.path.exists(cache_file_for(self.cache_dir, zp))]

    def _load(self, zp: str) -> Dict[str, np.ndarray]:
        with self._lock:
            if zp not in self._handles:
                path = cache_file_for(self.cache_dir, zp)
                if not os.path.exists(path):
                    raise FileNotFoundError(f"no latent cache for {zp!r} (expected {path})")
                with np.load(path) as z:
                    self._handles[zp] = {k: z[k] for k in z.files}
                while len(self._handles) > self.max_resident:
                    self._handles.popitem(last=False)
            else:
                self._handles.move_to_end(zp)
            return self._handles[zp]

    def view_keys(self, zip_path: str) -> List[str]:
        """The cached view keys of one zip, from the meta's views map where
        it has one, else from the npz."""
        base = os.path.splitext(os.path.basename(zip_path))[0]
        from_meta = (self.meta.get("views") or {}).get(base)
        if from_meta is not None:
            return list(from_meta)
        path = cache_file_for(self.cache_dir, zip_path)
        if not os.path.exists(path):
            raise FileNotFoundError(f"no latent cache for {zip_path!r}")
        with np.load(path) as z:
            return list(z.files)

    def read(self, zip_path: str, view: int) -> np.ndarray:
        data = self._load(zip_path)
        key = f"{view:03d}"
        if key not in data:
            raise KeyError(f"view {key} not in latent cache for {zip_path!r}")
        return data[key].astype(np.float32)

    def evict(self, zip_path: str):
        with self._lock:
            self._handles.pop(zip_path, None)


def corpus_zips(data_root: str) -> List[str]:
    files = sorted(glob(os.path.join(data_root, "renders_final", "*.zip")))
    if not files:
        files = sorted(glob(os.path.join(data_root, "*.zip")))
    return files
