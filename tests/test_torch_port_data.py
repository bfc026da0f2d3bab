"""The port's data modules against ``mvd_tpu.data`` on synthetic corpora.

Objaverse zips come from ``tests/test_data.py:make_zip`` (PIL-written RGBA
PNGs with random alpha), CO3D trees from ``tests/test_co3d.py:make_co3d_tree``
with its frames written as PNG (the port reads PNG only).
Bars: image decode, splits, split hashes, pair lists and pair-cache files,
view groups, sampling state and every loader batch (pixels, cameras,
``input_ids``, moments) bitwise; latent moments >= 60 dB against the JAX
package's precompute on the same VAE weights.
"""

import io
import json
import os
import zipfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from _torch_port_util import random_params, snr_db
from mvd_tpu.config import TINY_VAE as J_TINY_VAE
from mvd_tpu.data import co3d as jco3d
from mvd_tpu.data import latent_cache as jlc
from mvd_tpu.data import objaverse as jobj
from mvd_tpu.data.tokenizer import HashTokenizer as JHashTokenizer
from mvd_tpu.nn import AutoencoderKL as JVAE
from mvd_tpu_torch.checkpoint import load_jax_params
from mvd_tpu_torch.config import TINY_VAE
from mvd_tpu_torch.data import co3d as tco3d
from mvd_tpu_torch.data import latent_cache as tlc
from mvd_tpu_torch.data import objaverse as tobj
from mvd_tpu_torch.data.tokenizer import HashTokenizer
from mvd_tpu_torch.nn.vae import AutoencoderKL
from mvd_tpu_torch.utils.images import encode_png, over_white
from tests.test_co3d import make_co3d_tree
from tests.test_data import make_zip

SPLITS = dict(val_split=0.25, test_split=0.25)  # 8 objects: 4 train, 2 val, 2 test
BAR_DB = 60.0


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = tmp_path_factory.mktemp("objaverse")
    (root / "renders_final").mkdir()
    rng = np.random.default_rng(42)
    for i in range(8):
        make_zip(root / "renders_final" / f"obj_{i}.zip", num_views=4, size=24, rng=rng)
    return str(root)


def _datasets(corpus, tmp_path, split, **kw):
    """The JAX and the port's dataset over ``corpus``, each with a pair
    cache of its own."""
    j = jobj.ObjaverseDataset(corpus, split, cache_dir=str(tmp_path / "jax"), use_native=False,
                              **SPLITS, **kw)
    t = tobj.ObjaverseDataset(corpus, split, cache_dir=str(tmp_path / "port"), **SPLITS, **kw)
    return j, t


def _assert_batches_equal(want, got):
    assert len(want) == len(got) and len(want) > 0
    for w, g in zip(want, got):
        assert w.keys() == g.keys()
        for k in w:
            assert w[k].dtype == g[k].dtype and np.array_equal(w[k], g[k]), k


# ---------------------------------------------------------------- decode


def test_over_white_matches_pil_for_every_alpha():
    a, c = np.meshgrid(np.arange(256), np.arange(256))
    rgba = np.stack([c, 255 - c, (7 * c) % 256, a], -1).astype(np.uint8)
    img = Image.fromarray(rgba, "RGBA")
    white = Image.new("RGBA", img.size, (255, 255, 255, 255))
    assert np.array_equal(over_white(rgba), np.asarray(Image.alpha_composite(white, img).convert("RGB")))


@pytest.mark.parametrize("mode", ["RGBA", "RGB", "L", "LA"])
@pytest.mark.parametrize("src,dst", [(24, 24), (24, 16), (16, 48), (48, 33)])
def test_load_image_matches_jax(mode, src, dst):
    """PNG or JPEG -> composite -> Lanczos -> [-1, 1] bitwise the JAX
    package's PIL path, for PIL-written and port-written PNGs and a
    PIL-written JPEG; a file that is neither raises."""
    rng = np.random.default_rng(src * 100 + dst)
    ch = {"RGBA": 4, "RGB": 3, "L": 1, "LA": 2}[mode]
    arr = rng.integers(0, 256, (src, src, ch), dtype=np.uint8)
    buf = io.BytesIO()
    Image.fromarray(arr[..., 0] if ch == 1 else arr, mode).save(buf, "PNG")
    blobs = [buf.getvalue()] + ([encode_png(arr)] if ch in (3, 4) else [])
    for data in blobs:
        want = jobj._load_image_from_bytes(data, dst)
        got = tobj._load_image_from_bytes(data, dst)
        assert want.dtype == got.dtype and np.array_equal(want, got)
    buf = io.BytesIO()
    Image.fromarray(arr[..., :1].repeat(3, -1)).save(buf, "JPEG")
    want = jobj._load_image_from_bytes(buf.getvalue(), dst)
    got = tobj._load_image_from_bytes(buf.getvalue(), dst)
    assert want.dtype == got.dtype and np.array_equal(want, got)
    with pytest.raises(ValueError, match="GIF: no image in the file"):
        tobj._load_image_from_bytes(b"GIF89a" + bytes(16), dst)


# ------------------------------------------------------- objaverse dataset


def test_dataset_splits_pairs_and_cache_match_jax(corpus, tmp_path):
    for split in ("train", "val", "test"):
        j, t = _datasets(corpus, tmp_path, split, image_size=16, max_views_per_object=3)
        assert t.files == j.files and t.split_hash == j.split_hash
        assert [p.__dict__ for p in t.pairs] == [p.__dict__ for p in j.pairs]
        assert [g.__dict__ for g in t.view_groups(2)] == [g.__dict__ for g in j.view_groups(2)]
        assert t.state_dict() == j.state_dict()
        with open(t._pair_cache_path()) as f, open(j._pair_cache_path()) as g:
            assert f.read() == g.read()
        assert os.path.basename(t._pair_cache_path()) == os.path.basename(j._pair_cache_path())
        # the port reads the JAX package's pair cache
        t2 = tobj.ObjaverseDataset(corpus, split, cache_dir=str(tmp_path / "jax"), image_size=16,
                                   max_views_per_object=3, **SPLITS)
        assert [p.__dict__ for p in t2.pairs] == [p.__dict__ for p in j.pairs]
        for i in range(min(len(j), 3)):
            w, g = j[i], t[i]
            assert w.keys() == g.keys()
            assert all(np.array_equal(w[k], g[k]) for k in w if k != "prompt")
            assert w["prompt"] == g["prompt"]


def test_state_dict_round_trip_matches_jax(corpus, tmp_path):
    """A sampling state saved by either package restores the same pairs in
    the other (max_views 3 of 4 views: the RNG picks the views; a rebuild
    without a pair cache samples from the restored state)."""
    j, t = _datasets(corpus, tmp_path, "train", image_size=16, max_views_per_object=3)
    state = t.state_dict()
    json.dumps(state)
    t.load_state_dict(state)
    j.load_state_dict(state)
    assert [p.__dict__ for p in t.pairs] == [p.__dict__ for p in j.pairs]
    j2, t2 = _datasets(corpus, tmp_path / "b", "train", image_size=16, max_views_per_object=3,
                       seed=7)
    t2.load_state_dict(j.state_dict())
    j2.load_state_dict(t.state_dict())
    assert t2.seed == j2.seed == 42 and t2.state_dict() == j2.state_dict()
    assert [p.__dict__ for p in t2.pairs] == [p.__dict__ for p in j2.pairs]


@pytest.mark.parametrize("workers", [0, 2])
@pytest.mark.parametrize("views", [1, 2])
def test_loader_batches_match_jax(corpus, tmp_path, workers, views):
    """Every batch, in order, bitwise the JAX loader's (run with one worker
    thread, whose order is the batch order)."""
    j, t = _datasets(corpus, tmp_path, "train", image_size=16)
    jl = jobj.DataLoader(j, JHashTokenizer(), batch_size=2, views_per_sample=views, seed=3,
                         num_workers=1)
    tl = tobj.DataLoader(t, HashTokenizer(), batch_size=2, views_per_sample=views, seed=3,
                         num_workers=workers)
    assert len(tl) == len(jl)
    for _ in range(2):  # two epochs: the shuffle follows the epoch
        _assert_batches_equal(list(jl), list(tl))


def test_datamodule_matches_jax(corpus, monkeypatch):
    from mvd_tpu.data import native_loader

    monkeypatch.setattr(native_loader, "available", lambda: False)  # the PIL path
    j = jobj.ObjaverseDataModule(corpus, JHashTokenizer(), image_size=16, batch_size=2, num_workers=2)
    t = tobj.ObjaverseDataModule(corpus, HashTokenizer(), image_size=16, batch_size=2, num_workers=2)
    j.setup()
    t.setup()
    assert t.state_dict() == j.state_dict()
    assert len(t.datasets["val"]) == len(j.datasets["val"]) == 0  # 8 objects at 0.1 / 0.1
    jl, tl = j.loader("train"), t.loader("train")
    jl.num_workers = 1
    assert len(tl) == len(jl)
    _assert_batches_equal(list(jl), list(tl))
    t.load_state_dict(j.state_dict())
    assert t.state_dict() == j.state_dict()
    with pytest.raises(ValueError, match="latent cache"):
        tobj.ObjaverseDataModule(corpus, HashTokenizer(), dataset_format="co3d",
                                 latent_cache_dir="x").setup()


def test_dataset_heals_a_broken_zip(corpus, tmp_path):
    """A zip that stops reading is evicted with all its pairs, as in JAX."""
    root = tmp_path / "heal"
    (root / "renders_final").mkdir(parents=True)
    for name in os.listdir(os.path.join(corpus, "renders_final")):
        with open(os.path.join(corpus, "renders_final", name), "rb") as f:
            (root / "renders_final" / name).write_bytes(f.read())
    j, t = _datasets(str(root), tmp_path, "train", image_size=16)
    broken = t.pairs[0].zip_path
    with open(broken, "wb") as f:
        f.write(b"not a zip")
    got, want = t[0], j[0]
    assert all(np.array_equal(got[k], want[k]) for k in want if k != "prompt")
    assert broken not in {p.zip_path for p in t.pairs}
    assert [p.__dict__ for p in t.pairs] == [p.__dict__ for p in j.pairs]


# ------------------------------------------------------------------- CO3D


def _write_png_frame(path, rng, size=16):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    Image.fromarray(rng.integers(0, 255, (size, size, 3), dtype=np.uint8)).save(path, format="PNG")


@pytest.mark.parametrize("annotated", [True, False], ids=["jgz", "npy"])
def test_co3d_matches_jax(tmp_path, annotated, monkeypatch):
    import tests.test_co3d

    monkeypatch.setattr(tests.test_co3d, "_write_image", _write_png_frame)
    root = make_co3d_tree(str(tmp_path), n_seq=4, n_frames=4, annotated=annotated)
    for split in ("train", "val"):
        kw = dict(image_size=16, val_split=0.25, test_split=0.25, max_views_per_object=3)
        j, t = jco3d.CO3DDataset(root, split, **kw), tco3d.CO3DDataset(root, split, **kw)
        assert t.sequences == j.sequences and t.split_hash == j.split_hash
        assert [p.__dict__ for p in t.pairs] == [p.__dict__ for p in j.pairs]
        assert t.state_dict() == j.state_dict()
    np.testing.assert_array_equal(
        tco3d.pytorch3d_to_c2w(np.eye(3) * 2, np.ones(3)), jco3d.pytorch3d_to_c2w(np.eye(3) * 2, np.ones(3)))
    jl = jobj.DataLoader(j, JHashTokenizer(), batch_size=2, num_workers=1, shuffle=False)
    tl = tobj.DataLoader(t, HashTokenizer(), batch_size=2, num_workers=2, shuffle=False)
    _assert_batches_equal(list(jl), list(tl))


# ------------------------------------------------------------ latent cache


@pytest.fixture(scope="module")
def vaes():
    """The TINY VAE at both sides on the same random weights."""
    params = random_params(JVAE(J_TINY_VAE).init, jnp.zeros((1, 16, 16, 3)), seed=2)
    vae = AutoencoderKL(TINY_VAE)
    load_jax_params(vae, params)
    return JVAE(J_TINY_VAE), jax.tree.map(jnp.asarray, params), vae.eval()


def _meta_without_views(meta):
    return {k: v for k, v in meta.items() if k != "views"}


def test_latent_cache_matches_jax_and_cross_reads(corpus, tmp_path, vaes):
    jvae, jparams, vae = vaes
    zips = tlc.corpus_zips(corpus)
    assert zips == jlc.corpus_zips(corpus)
    zips = zips[:3]
    jdir, tdir = str(tmp_path / "jax"), str(tmp_path / "port")
    jstats = jlc.precompute_latent_cache(jvae, jparams, zips, jdir, image_size=24, batch_size=5,
                                         compute_dtype="float32")
    tstats = tlc.precompute_latent_cache(vae, zips, tdir, image_size=24, batch_size=5,
                                         compute_dtype="float32")
    assert tstats == jstats == {"zips": 3, "views": 12, "skipped": 0}
    jmeta, tmeta = jlc.read_meta(jdir), tlc.read_meta(tdir)
    assert tmeta == jmeta and set(tmeta) == {"image_size", "dtype", "version", "compute_dtype", "views"}
    for zp in zips:
        jr, tr = jlc.LatentCacheReader(jdir, image_size=24), tlc.LatentCacheReader(tdir, image_size=24)
        for v in range(4):
            want, got = jr.read(zp, v), tr.read(zp, v)
            assert got.shape == (2, 3, 3, 4) and got.dtype == np.float32
            assert snr_db(want, got) >= BAR_DB
            # each package reads the other's cache bitwise
            assert np.array_equal(jlc.LatentCacheReader(tdir).read(zp, v), got)
            assert np.array_equal(tlc.LatentCacheReader(jdir).read(zp, v), want)
        assert tr.view_keys(zp) == jr.view_keys(zp)
    # the rest of the corpus extends the cache; done zips are skipped
    more = tlc.precompute_latent_cache(vae, tlc.corpus_zips(corpus), tdir, image_size=24,
                                       batch_size=5, compute_dtype="float32")
    assert more == {"zips": 5, "views": 20, "skipped": 3}


def test_latent_cache_refusals_match_jax(corpus, tmp_path, vaes):
    jvae, jparams, vae = vaes
    zips = tlc.corpus_zips(corpus)[:1]
    for side in ("jax", "port"):
        d = str(tmp_path / side)
        if side == "jax":
            jlc.precompute_latent_cache(jvae, jparams, zips, d, image_size=24, batch_size=4,
                                        compute_dtype="float32")
        else:
            tlc.precompute_latent_cache(vae, zips, d, image_size=24, batch_size=4,
                                        compute_dtype="float32")
        with pytest.raises(ValueError, match="image_size"):
            tlc.precompute_latent_cache(vae, zips, d, image_size=16, compute_dtype="float32")
        with pytest.raises(ValueError, match="compute_dtype"):
            tlc.precompute_latent_cache(vae, zips, d, image_size=24, compute_dtype="bfloat16")
        with pytest.raises(ValueError, match="image_size"):
            tlc.LatentCacheReader(d, image_size=16)
    with pytest.raises(FileNotFoundError):
        tlc.LatentCacheReader(str(tmp_path / "none"))


def test_latent_cache_dataset_batches_match_jax(corpus, tmp_path, vaes):
    """Train batches from a cache carry the moments (and no pixels),
    bitwise the JAX loader's over the same cache; a stale or missing cache
    raises at setup in both."""
    jvae, jparams, vae = vaes
    cache = str(tmp_path / "cache")
    tlc.precompute_latent_cache(vae, tlc.corpus_zips(corpus), cache, image_size=24, batch_size=8,
                                compute_dtype="float32")
    j, t = _datasets(corpus, tmp_path, "train", image_size=24, latent_cache_dir=cache)
    jl = jobj.DataLoader(j, JHashTokenizer(), batch_size=2, num_workers=1)
    tl = tobj.DataLoader(t, HashTokenizer(), batch_size=2, num_workers=2)
    batches = list(tl)
    assert set(batches[0]) == {"source_moments", "target_moments", "source_camera",
                               "target_camera", "input_ids"}
    _assert_batches_equal(list(jl), batches)
    meta = tlc.read_meta(cache)
    base = os.path.splitext(os.path.basename(t.pairs[0].zip_path))[0]
    meta["views"][base] = ["000"]
    tlc.write_meta(cache, meta["image_size"], meta["dtype"], meta["compute_dtype"], meta["views"])
    with pytest.raises(ValueError, match="STALE"):
        tobj.ObjaverseDataset(corpus, "train", image_size=24, latent_cache_dir=cache, **SPLITS)
    os.remove(tlc.cache_file_for(cache, t.pairs[0].zip_path))
    with pytest.raises(FileNotFoundError, match="missing"):
        tobj.ObjaverseDataset(corpus, "train", image_size=24, latent_cache_dir=cache, **SPLITS)


def test_zip_reads_only_png_views(tmp_path):
    """Views are the zip's numeric PNG entries, as the JAX package lists
    them (the latent cache and the pair list)."""
    zp = str(tmp_path / "a.zip")
    make_zip(zp, num_views=3, size=16)
    with zipfile.ZipFile(zp, "a") as z:
        z.writestr("thumb.png", b"x")
    with zipfile.ZipFile(zp) as z:
        assert tlc._list_views(z) == jlc._list_views(z) == [0, 1, 2]
