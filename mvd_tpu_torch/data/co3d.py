"""CO3D-style multi-view sequence dataset.

Counterpart of ``mvd_tpu/data/co3d.py``. Reads sequences laid out as CO3D
ships them::

    <root>/<category>/frame_annotations.jgz      # gzipped JSON frame list
    <root>/<category>/<sequence>/images/frame000001.jpg

(each record: ``sequence_name``, ``frame_number``, ``image.path`` and a
PyTorch3D ``viewpoint`` with row-vector world-to-camera ``R`` and ``T``),
or, without annotations, ``<category>/<sequence>/images/*.png|jpg`` beside
``cameras.npy`` ((N, 4, 4) camera-to-world). Cameras become 4x4
camera-to-world matrices, the Objaverse renderer's contract. The dataset
has ``ObjaverseDataset``'s interface (``pairs``, ``view_groups``,
``_read_view``, ``state_dict``), so ``DataLoader`` and the Trainer take it
unchanged. Prompts are "a photo of a <category>" unless the sequence holds
a ``prompt.txt``. Frames decode through ``utils/images.py:decode_image``:
JPEG (what CO3D ships) bitwise PIL's, the other formats it reads likewise, then the Lanczos
resize within one level of PIL's, as in the JAX package.
"""

from __future__ import annotations

import gzip
import json
import logging
import os
import random
from glob import glob
from typing import Dict, List, Optional, Tuple

import numpy as np

from .objaverse import (
    ViewGroup,
    ViewPair,
    _load_image_from_bytes,
    group_views,
    object_pairs,
    rng_from_state,
    rng_state_dict,
    split_files,
)

logger = logging.getLogger(__name__)


def pytorch3d_to_c2w(R: np.ndarray, T: np.ndarray) -> np.ndarray:
    """PyTorch3D viewpoint (``x_cam = x_world @ R + T``) -> 4x4
    camera-to-world ``[[R, -R·T], [0, 1]]``."""
    R = np.asarray(R, np.float32).reshape(3, 3)
    T = np.asarray(T, np.float32).reshape(3)
    c2w = np.eye(4, dtype=np.float32)
    c2w[:3, :3] = R
    c2w[:3, 3] = -R @ T
    return c2w


def _load_frame_annotations(path: str) -> List[dict]:
    if path.endswith(".jgz"):
        with gzip.open(path, "rt") as f:
            return json.load(f)
    with open(path) as f:
        return json.load(f)


class CO3DDataset:
    """Sequence-split multi-view dataset over CO3D-style shards."""

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
        cache_dir: Optional[str] = None,  # interface parity; pairs are cheap
        views_per_sample: int = 1,
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
        self.views_per_sample = views_per_sample
        self.rng = random.Random(seed)
        self._build()

    # ------------------------------------------------------------------
    def _discover(self) -> Dict[str, Dict[int, Tuple[str, np.ndarray]]]:
        """sequence dir -> {frame number: (image path, 4x4 c2w)}."""
        frames: Dict[str, Dict[int, Tuple[str, np.ndarray]]] = {}
        for cat in sorted(glob(os.path.join(self.data_root, "*"))):
            if not os.path.isdir(cat):
                continue
            ann_path = next((os.path.join(cat, n) for n in
                             ("frame_annotations.jgz", "frame_annotations.json")
                             if os.path.exists(os.path.join(cat, n))), None)
            if ann_path:
                try:
                    anns = _load_frame_annotations(ann_path)
                except Exception as e:
                    logger.warning("unreadable annotations %s: %s", ann_path, e)
                    continue
                for a in anns:
                    seq = os.path.join(cat, a["sequence_name"])
                    img = os.path.join(self.data_root, a["image"]["path"])
                    vp = a["viewpoint"]
                    frames.setdefault(seq, {})[int(a["frame_number"])] = (
                        img, pytorch3d_to_c2w(vp["R"], vp["T"]))
                continue
            for seq in sorted(glob(os.path.join(cat, "*"))):
                cams_path = os.path.join(seq, "cameras.npy")
                imgs = sorted(glob(os.path.join(seq, "images", "*.png"))
                              + glob(os.path.join(seq, "images", "*.jpg")))
                if not imgs or not os.path.exists(cams_path):
                    continue
                cams = np.load(cams_path).astype(np.float32)
                if cams.shape[0] < len(imgs):
                    logger.warning("camera/frame count mismatch in %s", seq)
                    continue
                frames[seq] = {i: (p, cams[i]) for i, p in enumerate(imgs)}
        return frames

    def _build(self):
        self.frames = self._discover()
        self.sequences, self.split_hash = split_files(
            sorted(self.frames), self.seed, self.val_split, self.test_split, self.split)
        pairs: List[ViewPair] = []
        for seq in self.sequences:
            views = sorted(self.frames[seq])
            if len(views) < 2:
                continue
            pairs += object_pairs(seq, views, self._prompt(seq), self.max_views, self.rng)
            if self.dataset_samples and len(pairs) >= self.dataset_samples:
                pairs = pairs[:self.dataset_samples]
                break
        self.pairs = pairs

    def _prompt(self, seq: str) -> str:
        p = os.path.join(seq, "prompt.txt")
        if os.path.exists(p):
            try:
                with open(p) as f:
                    text = f.read().strip()
                if text:
                    return text
            except OSError:
                pass
        category = os.path.basename(os.path.dirname(seq))
        return f"a photo of a {category.replace('_', ' ')}"

    # ------------------------------------------------------------------
    def __len__(self) -> int:
        return len(self.pairs)

    def _read_view(self, seq: str, view: int) -> Tuple[np.ndarray, np.ndarray]:
        path, c2w = self.frames[seq][view]
        with open(path, "rb") as f:
            img = _load_image_from_bytes(f.read(), self.image_size)
        return img, c2w.copy()

    def view_groups(self, num_targets: int) -> List[ViewGroup]:
        return group_views(self.pairs, num_targets)

    def __getitem__(self, idx: int) -> Dict[str, np.ndarray]:
        """Self-healing read, as ``ObjaverseDataset.__getitem__``."""
        for _ in range(3):
            if not self.pairs:
                raise RuntimeError("dataset exhausted: all pairs evicted")
            pair = self.pairs[idx % len(self.pairs)]
            try:
                src_img, src_cam = self._read_view(pair.zip_path, pair.source_view)
                tgt_img, tgt_cam = self._read_view(pair.zip_path, pair.target_view)
                return {"source_image": src_img, "target_image": tgt_img,
                        "source_camera": src_cam, "target_camera": tgt_cam,
                        "prompt": pair.prompt}
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
