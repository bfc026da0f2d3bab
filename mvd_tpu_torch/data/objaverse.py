"""Objaverse multi-view dataset (the rendered-zip contract) and its
resumable loader.

Counterpart of ``mvd_tpu/data/objaverse.py``, numpy-only. One zip per
object holds ``NNN.png`` renders, ``NNN.npy`` 4x4 camera-to-world matrices,
``prompt.txt`` and ``metadata.json``. Kept from the JAX package, so that
both packages read a corpus into the same batches:

  * ``<root>/renders_final/*.zip`` (else ``<root>/*.zip``);
  * the seeded 0.8/0.1/0.1 split with the md5 hash of its file list;
  * ordered source -> target pairs (all i < j) over up to
    ``max_views_per_object`` sampled views, the ``dataset_samples`` cap, and
    the JSON pair cache in the same file format and name;
  * self-healing reads (3 tries, evicting a broken zip or pair live);
  * RGBA composited over white, Lanczos resize, [-1, 1] (``utils/images.py``,
    without PIL: bitwise PIL's decode, composite and resize on the tested
    shapes; BMP, GIF, PNG, JPEG, TIFF or WebP, another format raises
    ``ValueError``);
  * ``use_native=True``: the C++ reader (``data/native_loader.py``), the
    JAX package's other function (float composite, bilinear resize). The
    JAX dataset takes it whenever ``g++`` and libpng build it
    (``use_native=None``) and falls back to PIL where a read fails; the port
    takes it only when asked, and raises where it cannot build or read;
  * ``state_dict`` / ``load_state_dict`` of the sampling RNG.

The loader returns (B, V, ...) numpy batches. Unlike the JAX package's,
whose worker threads hand batches over in the order they finish, it yields
them in batch order whatever ``num_workers`` is; over several processes
each loads its contiguous rows of every global batch (``process_count``,
``process_index``).
"""

from __future__ import annotations

import hashlib
import io
import json
import logging
import os
import random
import threading
import zipfile
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass
from glob import glob
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..utils.images import decode_image, resize

logger = logging.getLogger(__name__)


def _load_image_from_bytes(data: bytes, image_size: int) -> np.ndarray:
    """Image bytes ``decode_image`` reads -> (H, W, 3) float32 in [-1, 1], RGBA composited
    over white, Lanczos-resized to (image_size, image_size)."""
    img = decode_image(data, composite_alpha=True)
    if img.shape[:2] != (image_size, image_size):
        img = resize(img, image_size, image_size)
    arr = img.astype(np.float32) / 255.0
    return arr * 2.0 - 1.0


def _homogeneous(cam: np.ndarray) -> np.ndarray:
    if cam.shape == (3, 4):
        cam = np.concatenate([cam, np.array([[0, 0, 0, 1]], np.float32)], axis=0)
    return cam


@dataclass
class ViewPair:
    zip_path: str
    source_view: int
    target_view: int
    prompt: str


@dataclass
class ViewGroup:
    """One source view conditioning V target views of the same object."""

    zip_path: str
    source_view: int
    target_views: tuple
    prompt: str


def split_files(files: Sequence, seed: int, val_split: float, test_split: float, split: str):
    """The seeded test/val/train split of ``files`` and the md5 hash (12 hex
    digits) of the chosen split's list."""
    assert val_split + test_split < 1.0
    files = list(files)
    random.Random(seed).shuffle(files)
    n = len(files)
    n_test, n_val = int(n * test_split), int(n * val_split)
    chosen = {
        "test": files[:n_test],
        "val": files[n_test:n_test + n_val],
        "train": files[n_test + n_val:],
    }[split]
    return chosen, hashlib.md5("".join(chosen).encode()).hexdigest()[:12]


def object_pairs(key: str, views: List[int], prompt: str, max_views: int,
                 rng: random.Random) -> List[ViewPair]:
    """Every ordered pair i < j over the object's views, after sampling
    ``max_views`` of them with ``rng`` where it has more."""
    if len(views) > max_views:
        views = sorted(rng.sample(views, max_views))
    return [ViewPair(key, views[i], views[j], prompt)
            for i in range(len(views)) for j in range(i + 1, len(views))]


def group_views(pairs: Sequence[ViewPair], num_targets: int) -> List[ViewGroup]:
    """The pair list grouped into per-object (source, V targets) units."""
    by_obj: Dict[Tuple[str, int], List[ViewPair]] = {}
    for p in pairs:
        by_obj.setdefault((p.zip_path, p.source_view), []).append(p)
    groups = []
    for (zp, src), plist in by_obj.items():
        tgts = sorted({p.target_view for p in plist})
        for i in range(0, len(tgts) - num_targets + 1, num_targets):
            groups.append(ViewGroup(zp, src, tuple(tgts[i:i + num_targets]), plist[0].prompt))
    return groups


def rng_state_dict(rng: random.Random, split: str, seed: int) -> Dict:
    return {"rng_state": json.dumps(rng.getstate(), default=list), "split": split, "seed": seed}


def rng_from_state(state: Dict, seed: int) -> Tuple[random.Random, int]:
    seed = state.get("seed", seed)
    rng = random.Random(seed)
    rs = state.get("rng_state")
    if rs:
        loaded = json.loads(rs)
        rng.setstate((loaded[0], tuple(loaded[1]), loaded[2]))
    return rng, seed


class ObjaverseDataset:
    def __init__(
        self,
        data_root: str,
        split: str = "train",
        image_size: int = 768,
        max_views_per_object: int = 8,
        dataset_samples: Optional[int] = None,
        seed: int = 42,
        val_split: float = 0.1,
        test_split: float = 0.1,
        cache_dir: Optional[str] = None,
        views_per_sample: int = 1,
        use_native: bool = False,
        latent_cache_dir: Optional[str] = None,
    ):
        assert split in ("train", "val", "test")
        self.data_root = data_root
        self.split = split
        self.image_size = image_size
        self.max_views = max_views_per_object
        self.dataset_samples = dataset_samples
        self.seed = seed
        self.val_split = val_split
        self.test_split = test_split
        self.cache_dir = cache_dir or os.path.join(data_root, ".mvd_cache")
        self.views_per_sample = views_per_sample
        self.use_native = use_native
        # with a latent cache, samples carry "{source,target}_moments"
        # (2, h, w, 4) instead of pixels and the step skips the VAE encode
        self.latent_cache_dir = latent_cache_dir
        self.latent_cache = None
        self.rng = random.Random(seed)
        self._zip_lock = threading.Lock()
        self._zip_handles: Dict[str, zipfile.ZipFile] = {}
        self._build()

    # ------------------------------------------------------------------
    def _build(self):
        from .latent_cache import corpus_zips

        self.all_files = corpus_zips(self.data_root)
        self.files, self.split_hash = split_files(
            self.all_files, self.seed, self.val_split, self.test_split, self.split)
        self._build_view_pairs()
        if self.latent_cache_dir:
            self._attach_latent_cache()

    def _attach_latent_cache(self):
        from .latent_cache import LatentCacheReader

        self.latent_cache = LatentCacheReader(self.latent_cache_dir, image_size=self.image_size)
        missing = self.latent_cache.coverage(sorted({p.zip_path for p in self.pairs}))
        if missing:
            raise FileNotFoundError(
                f"latent cache at {self.latent_cache_dir!r} is missing {len(missing)} of the "
                f"split's zips (e.g. {missing[:3]}); run cli/precompute_latents.py over the "
                "corpus first"
            )
        # a cache file older than its zip's views fails here, not mid-epoch
        need: Dict[str, set] = {}
        for p in self.pairs:
            need.setdefault(p.zip_path, set()).update((p.source_view, p.target_view))
        stale = []
        for zp, views in sorted(need.items()):
            wanted = {f"{v:03d}" for v in views}
            if not wanted <= set(self.latent_cache.view_keys(zp)):
                stale.append((zp, sorted(wanted - set(self.latent_cache.view_keys(zp)))))
        if stale:
            raise ValueError(
                f"latent cache at {self.latent_cache_dir!r} is STALE for {len(stale)} zips "
                f"(e.g. {stale[0][0]} lacks views {stale[0][1][:4]}); re-run "
                "cli/precompute_latents.py with --overwrite"
            )

    def _pair_cache_path(self) -> str:
        cap = self.dataset_samples or "all"
        return os.path.join(
            self.cache_dir, f"pairs_{self.split}_{self.split_hash}_{self.max_views}_{cap}.json")

    def _build_view_pairs(self):
        cache = self._pair_cache_path()
        if os.path.exists(cache):
            try:
                with open(cache) as f:
                    self.pairs = [ViewPair(**p) for p in json.load(f)]
                logger.info("loaded %d pairs from cache %s", len(self.pairs), cache)
                return
            except Exception:
                logger.warning("pair cache unreadable, rebuilding: %s", cache)

        pairs: List[ViewPair] = []
        for zp in self.files:
            try:
                with zipfile.ZipFile(zp) as z:
                    names = z.namelist()
                    views = sorted(
                        int(os.path.splitext(os.path.basename(n))[0]) for n in names
                        if n.endswith(".png") and os.path.splitext(os.path.basename(n))[0].isdigit()
                    )
                    prompt = "3D object"
                    for n in names:
                        if n.endswith("prompt.txt"):
                            prompt = z.read(n).decode("utf-8", "replace").strip() or prompt
                            break
            except Exception as e:
                logger.warning("skipping corrupt zip %s: %s", zp, e)
                continue
            if len(views) < 2:
                continue
            pairs += object_pairs(zp, views, prompt, self.max_views, self.rng)
            if self.dataset_samples and len(pairs) >= self.dataset_samples:
                pairs = pairs[:self.dataset_samples]
                break
        self.pairs = pairs
        try:
            os.makedirs(self.cache_dir, exist_ok=True)
            with open(cache, "w") as f:
                json.dump([p.__dict__ for p in pairs], f)
        except OSError as e:
            logger.warning("could not write pair cache: %s", e)

    # ------------------------------------------------------------------
    def __len__(self) -> int:
        return len(self.pairs)

    def _zip(self, path: str) -> zipfile.ZipFile:
        with self._zip_lock:
            if path not in self._zip_handles:
                self._zip_handles[path] = zipfile.ZipFile(path)
            return self._zip_handles[path]

    def _entry(self, zp: str, view: int, ext: str) -> bytes:
        z = self._zip(zp)
        return z.read(next(n for n in z.namelist() if n.endswith(f"{view:03d}{ext}")))

    def _read_camera(self, zp: str, view: int) -> np.ndarray:
        return _homogeneous(np.load(io.BytesIO(self._entry(zp, view, ".npy"))).astype(np.float32))

    def _read_view(self, zp: str, view: int) -> Tuple[np.ndarray, np.ndarray]:
        if self.use_native:  # no fallback: a failed read raises, naming zip and entry
            from . import native_loader

            img = native_loader.load_view(zp, f"{view:03d}.png", self.image_size)
            cam = np.load(io.BytesIO(native_loader.read_entry(zp, f"{view:03d}.npy")))
            return img, _homogeneous(cam.astype(np.float32))
        img = _load_image_from_bytes(self._entry(zp, view, ".png"), self.image_size)
        return img, self._read_camera(zp, view)

    def _view_payload(self, zp: str, view: int, role: str) -> Dict[str, np.ndarray]:
        """One view as sample entries: pixels (``<role>_image``), or the
        cached latent moments (``<role>_moments``) with a latent cache; the
        camera comes from the zip either way."""
        if self.latent_cache is not None:
            return {f"{role}_moments": self.latent_cache.read(zp, view),
                    f"{role}_camera": self._read_camera(zp, view)}
        img, cam = self._read_view(zp, view)
        return {f"{role}_image": img, f"{role}_camera": cam}

    def view_groups(self, num_targets: int) -> List[ViewGroup]:
        return group_views(self.pairs, num_targets)

    def __getitem__(self, idx: int) -> Dict[str, np.ndarray]:
        """Self-healing read: 3 tries, evicting broken zips and pairs live."""
        for _ in range(3):
            if not self.pairs:
                raise RuntimeError("dataset exhausted: all pairs evicted")
            pair = self.pairs[idx % len(self.pairs)]
            try:
                return {
                    **self._view_payload(pair.zip_path, pair.source_view, "source"),
                    **self._view_payload(pair.zip_path, pair.target_view, "target"),
                    "prompt": pair.prompt,
                }
            except (zipfile.BadZipFile, FileNotFoundError, OSError) as e:
                # the whole archive is unreadable: evict every pair from it
                logger.warning("dropping unreadable zip %s: %s", pair.zip_path, e)
                with self._zip_lock:
                    self._zip_handles.pop(pair.zip_path, None)
                if self.latent_cache is not None:
                    self.latent_cache.evict(pair.zip_path)
                self.pairs = [p for p in self.pairs if p.zip_path != pair.zip_path]
            except Exception as e:
                logger.warning("dropping bad pair %s (%d->%d): %s",
                               pair.zip_path, pair.source_view, pair.target_view, e)
                self.pairs = [p for p in self.pairs if p is not pair]
                idx += 1
        raise RuntimeError("3 consecutive corrupt samples")

    # ------------------------------------------------------------------
    def state_dict(self) -> Dict:
        return rng_state_dict(self.rng, self.split, self.seed)

    def load_state_dict(self, state: Dict):
        self.rng, self.seed = rng_from_state(state, self.seed)
        self._build()


def collate(samples: Sequence[Dict[str, np.ndarray]], tokenizer,
            views_per_sample: int = 1) -> Dict[str, np.ndarray]:
    """Stack samples into (B, V, ...) arrays plus the tokenized prompts
    (``input_ids``)."""
    V = views_per_sample
    assert len(samples) % V == 0
    B = len(samples) // V

    def stack(key):
        return np.stack([s[key] for s in samples]).reshape((B, V) + samples[0][key].shape)

    ids = tokenizer([s["prompt"] for s in samples]).reshape(B, V, -1)
    out = {k: stack(k) for k in samples[0] if k != "prompt"}
    out["input_ids"] = ids
    return out


class DataLoader:
    """Thread-pool loader of (B, V, ...) numpy batches: ``num_workers``
    threads (at least one) load up to ``prefetch`` batches ahead, and the
    batches come out in batch order. A batch whose load fails is skipped
    with a warning (the dataset heals itself underneath).

    Over ``process_count`` processes every process computes the same global
    batch order (the seeded shuffle) and loads only its contiguous
    ``batch_size / process_count`` rows of each batch, in process order (the
    DistributedSampler's role); ``batch_size`` stays the global batch and
    ``len`` the global step count. A batch that the process count does not
    divide raises."""

    def __init__(
        self,
        dataset,
        tokenizer,
        batch_size: int,
        views_per_sample: int = 1,
        shuffle: bool = True,
        seed: int = 0,
        num_workers: int = 4,
        prefetch: int = 4,
        drop_last: bool = True,
        process_count: int = 1,
        process_index: int = 0,
    ):
        self.ds = dataset
        self.tokenizer = tokenizer
        self.batch_size = batch_size
        self.V = views_per_sample
        self.shuffle = shuffle
        self.seed = seed
        self.num_workers = max(1, num_workers)
        self.prefetch = max(1, prefetch)
        self.drop_last = drop_last
        self.epoch = 0
        self.process_count = max(1, process_count)
        self.process_index = process_index
        if batch_size % self.process_count:
            raise ValueError(f"global batch_size ({batch_size}) must be divisible by the process "
                             f"count ({self.process_count})")

    def __len__(self):
        if self.V > 1:
            return len(self.ds.view_groups(self.V)) // self.batch_size
        n = len(self.ds) // (self.batch_size * self.V)
        if not self.drop_last and len(self.ds) % (self.batch_size * self.V):
            n += 1
        return n

    def _payload(self, zp: str, view: int, role: str) -> Dict[str, np.ndarray]:
        fn = getattr(self.ds, "_view_payload", None)
        if fn is not None:
            return fn(zp, view, role)
        img, cam = self.ds._read_view(zp, view)
        return {f"{role}_image": img, f"{role}_camera": cam}

    def _load_group(self, group: ViewGroup) -> List[Dict[str, np.ndarray]]:
        """V samples that share one source view."""
        src = self._payload(group.zip_path, group.source_view, "source")
        return [{**src, **self._payload(group.zip_path, tv, "target"), "prompt": group.prompt}
                for tv in group.target_views]

    def _load(self, indices, groups) -> Optional[Dict[str, np.ndarray]]:
        try:
            if groups is not None:
                samples = [s for i in indices for s in self._load_group(groups[i])]
            else:
                samples = [self.ds[i] for i in indices]
            return collate(samples, self.tokenizer, self.V)
        except Exception as e:
            logger.warning("batch skipped: %s", e)
            return None

    def __iter__(self):
        if self.V > 1:
            groups = self.ds.view_groups(self.V)
            order = list(range(len(groups)))
        else:
            groups = None
            order = list(range(len(self.ds)))
        if self.shuffle:
            random.Random(self.seed + self.epoch).shuffle(order)
        self.epoch += 1
        per_batch = self.batch_size if groups is not None else self.batch_size * self.V
        batches = [order[i:i + per_batch] for i in range(0, len(order) - per_batch + 1, per_batch)]
        if self.process_count > 1:  # this process's contiguous rows of every global batch
            k = per_batch // self.process_count
            batches = [bi[self.process_index * k:(self.process_index + 1) * k] for bi in batches]
        batches = iter(batches)
        pool = ThreadPoolExecutor(self.num_workers, thread_name_prefix="mvd-loader")
        pending = deque()
        try:
            for bi in batches:
                pending.append(pool.submit(self._load, bi, groups))
                if len(pending) >= self.prefetch:
                    break
            while pending:
                batch = pending.popleft().result()
                bi = next(batches, None)
                if bi is not None:
                    pending.append(pool.submit(self._load, bi, groups))
                if batch is not None:
                    yield batch
        finally:
            pool.shutdown(wait=False, cancel_futures=True)


class ObjaverseDataModule:
    """train/val/test datasets, their loaders and the checkpointable state.
    ``dataset_format`` is "objaverse" (rendered-zip shards) or "co3d"
    (``data/co3d.py``); only objaverse takes a latent cache (train split
    only: validation generates from and compares against pixels).
    ``process_count`` / ``process_index`` go to every loader; ``use_native``
    to the objaverse datasets (CO3D has no native reader)."""

    def __init__(self, data_root: str, tokenizer, image_size=768, batch_size=6,
                 max_views_per_object=8, dataset_samples=None, views_per_sample=1,
                 num_workers=4, seed=42, dataset_format: str = "objaverse",
                 latent_cache_dir: Optional[str] = None, process_count: int = 1,
                 process_index: int = 0, use_native: bool = False):
        self.kwargs = dict(data_root=data_root, image_size=image_size,
                           max_views_per_object=max_views_per_object,
                           dataset_samples=dataset_samples, seed=seed,
                           views_per_sample=views_per_sample)
        self.tokenizer = tokenizer
        self.batch_size = batch_size
        self.views_per_sample = views_per_sample
        self.num_workers = num_workers
        self.dataset_format = dataset_format
        self.latent_cache_dir = latent_cache_dir
        self.process_count = process_count
        self.process_index = process_index
        self.use_native = use_native
        self.datasets: Dict[str, ObjaverseDataset] = {}

    def _dataset_cls(self):
        if self.dataset_format == "co3d":
            from .co3d import CO3DDataset

            return CO3DDataset
        if self.dataset_format != "objaverse":
            raise ValueError(f"unknown dataset_format: {self.dataset_format!r}")
        return ObjaverseDataset

    def setup(self):
        cls = self._dataset_cls()
        if self.latent_cache_dir and cls is not ObjaverseDataset:
            raise ValueError(
                f"latent_cache_dir is set but dataset_format={self.dataset_format!r} does not "
                "support a latent cache (only the objaverse rendered-zip format does); unset one")
        if self.use_native and cls is not ObjaverseDataset:
            raise ValueError(f"use_native is set but dataset_format={self.dataset_format!r} has no "
                             "native reader (only the objaverse rendered-zip format does)")
        for split in ("train", "val", "test"):
            kw = dict(self.kwargs)
            if split == "train" and self.latent_cache_dir:
                kw["latent_cache_dir"] = self.latent_cache_dir
            if cls is ObjaverseDataset:
                kw["use_native"] = self.use_native
            self.datasets[split] = cls(split=split, **kw)

    def loader(self, split: str, shuffle: Optional[bool] = None) -> DataLoader:
        if split not in self.datasets:
            self.setup()
        return DataLoader(
            self.datasets[split], self.tokenizer, batch_size=self.batch_size,
            views_per_sample=self.views_per_sample,
            shuffle=shuffle if shuffle is not None else split == "train",
            num_workers=self.num_workers, process_count=self.process_count,
            process_index=self.process_index,
        )

    def state_dict(self):
        return {k: d.state_dict() for k, d in self.datasets.items()}

    def load_state_dict(self, state):
        if not self.datasets:
            self.setup()
        for k, s in state.items():
            if k in self.datasets:
                self.datasets[k].load_state_dict(s)
