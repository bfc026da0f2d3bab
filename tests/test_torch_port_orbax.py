"""The port's reader of the JAX package's orbax checkpoints
(``mvd_tpu_torch/checkpoint/ocdbt.py``, ``zarr.py``, ``orbax_read.py``,
``from_jax.carry_jax_train_state``, the orbax forms of ``io.py`` and
``torch_convert.load_checkpoint``) held to tensorstore, orbax and the JAX
package on what the JAX package writes:

* the OCDBT store's keys and values bitwise tensorstore's ``ocdbt``
  KvStore, its manifest, version-tree and B+tree nodes those of
  ``tensorstore.ocdbt.dump``;
* ``read_tree`` bitwise the JAX ``load_params`` leaf by leaf (bf16, int32,
  0-d, multi-chunk), zarr edge and missing chunks bitwise tensorstore's
  zarr driver, and what it does not read refused by name;
* the committed fixtures read to the JAX package's digests;
* ``load_checkpoint`` of a JAX ``save_params`` dir bitwise
  ``load_jax_params`` of the same tree, and a generation from it >= 50 dB
  against the JAX pipeline;
* a JAX Trainer step restored bitwise ``load_jax_train_state`` of the JAX
  ``TrainState`` (with and without ``grad_accum_steps=2``), and the next
  step from it bitwise the next step from the carried state;
* the repair: the port's ``CheckpointManager`` never replaces or removes a
  JAX step, and ``--resume`` of a JAX run dir continues it; ``cli.val``
  restores a JAX run's latest step;
* the layout writer that ``chip_smoke.py`` uses read bitwise by orbax's
  ``StandardCheckpointer`` and the JAX ``CheckpointManager``.

One module-scoped JAX save of a TINY pipeline and two TINY Trainer runs
serve the tests (no JAX init and no train-step compile: the parameters come
from the port's TINY pipeline, the optimizer states are filled from a seed).
"""

from __future__ import annotations

import hashlib
import io
import json
import os
import shutil
import zipfile

import jax
import jax.numpy as jnp
import numpy as np
import orbax.checkpoint as ocp
import pytest
import tensorstore as ts
import torch

import _torch_port_orbax_writer as W
from _torch_port_util import cut_config, random_params, snr_db
from mvd_tpu.checkpoint.orbax_io import CheckpointManager as JCheckpointManager
from mvd_tpu.checkpoint.orbax_io import load_params as j_load_params
from mvd_tpu.checkpoint.orbax_io import save_params as j_save_params
from mvd_tpu.config import TINY_MODEL as J_TINY
from mvd_tpu.config import OptimizerConfig as JOptimizerConfig
from mvd_tpu.nn import CLIPTextEncoder as JCLIP
from mvd_tpu.nn import AutoencoderKL as JVAE
from mvd_tpu.nn import MultiViewUNet as JMVD
from mvd_tpu.pipeline import MVDPipeline as JPipeline
from mvd_tpu.train import TrainState as JTrainState
from mvd_tpu.train import make_optimizer as j_make_optimizer
from mvd_tpu_torch.camera import orbit_cameras
from mvd_tpu_torch.checkpoint import (
    CheckpointManager,
    convert_jax_params,
    load_checkpoint,
    load_component,
    load_jax_train_state,
    load_params_into,
    read_step,
    read_tree,
)
from mvd_tpu_torch.checkpoint.ocdbt import Location, OcdbtStore
from mvd_tpu_torch.checkpoint.zarr import ZarrArray
from mvd_tpu_torch.cli import infer, serve, val
from mvd_tpu_torch.cli import train as train_cli
from mvd_tpu_torch.config import TINY_MODEL, OptimizerConfig, TrainConfig
from mvd_tpu_torch.pipeline import MVDPipeline, build_schedule
from mvd_tpu_torch.train.loop import Trainer, make_train_step
from mvd_tpu_torch.train.state import TrainState
from mvd_tpu_torch.utils.images import encode_png

FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)), "fixtures", "torch_port_orbax")
TOTAL = 10


def _leaves(tree, prefix=()):
    """{"a/b/0": leaf} of nested dicts, lists and (named) tuples; None
    leaves kept."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = (getattr(tree, "_asdict", lambda: dict(enumerate(tree)))()).items()
    else:
        return {"/".join(map(str, prefix)): tree}
    out = {}
    for k, v in items:
        out.update(_leaves(v, prefix + (k,)))
    return out


def _bits(x) -> bytes:
    if torch.is_tensor(x):
        return x.contiguous().view(torch.int16).numpy().tobytes() if x.dtype == torch.bfloat16 \
            else x.numpy().tobytes()
    a = np.asarray(x)
    return a.view(np.uint16).tobytes() if a.dtype.name == "bfloat16" else a.tobytes()


def _assert_trees_bitwise(got, want):
    """Every array leaf of the JAX tree ``want`` bitwise in ``got``; a JAX
    leaf that is None, or an empty container, is None or absent."""
    g, w = _leaves(got), jax.tree_util.tree_flatten_with_path(want)[0]
    w = {"/".join(str(getattr(p, "key", getattr(p, "idx", getattr(p, "name", p)))) for p in path): v
         for path, v in w}
    assert set(w) == {k for k, v in g.items() if v is not None}
    for k, v in w.items():
        assert np.shape(g[k]) == np.shape(v) and _bits(g[k]) == _bits(v), k


def parse_location(text):
    """``kind:base:rel:offset:length`` as ``tensorstore.ocdbt.dump`` prints a
    location -> (base + rel, offset, length)."""
    _, rest = text.split(":", 1)
    body, offset, length = rest.rsplit(":", 2)
    base, rel = body.split(":", 1)
    return base + rel, int(offset), int(length)


def _sha_files(root):
    return {os.path.relpath(os.path.join(d, n), root): hashlib.sha256(open(os.path.join(d, n), "rb").read()).hexdigest()
            for d, _, fs in os.walk(root) for n in fs}


def _jax_state(mvd_tree, k):
    """A JAX ``TrainState`` of ``make_optimizer`` over ``mvd_tree``, its
    optimizer state filled from a seed as if 2 (k = 1) or 3 (k = 2: one
    update and one accumulated call) steps had run."""
    tx = j_make_optimizer(JOptimizerConfig(), mvd_tree, total_steps=TOTAL, grad_accum_steps=k)
    updates, mini = (2, 0) if k == 1 else (1, 1)
    rng = np.random.default_rng(10 + k)

    def fill(path, leaf):
        names = [getattr(p, "name", getattr(p, "key", None)) for p in path]
        if jnp.issubdtype(leaf.dtype, jnp.integer):
            return jnp.asarray(mini if "mini_step" in names else updates, leaf.dtype)
        x = 1e-3 * rng.standard_normal(leaf.shape).astype(np.float32)
        return jnp.asarray(np.abs(x) if "nu" in names else x)

    opt = jax.tree_util.tree_map_with_path(fill, jax.eval_shape(tx.init, mvd_tree))
    return JTrainState(step=jnp.asarray(updates * k + mini, jnp.int32), params=mvd_tree, opt_state=opt, tx=tx)


@pytest.fixture(scope="module")
def saves(tmp_path_factory):
    """A JAX ``save_params`` of a TINY pipeline and two JAX Trainer run
    dirs (k = 1, step 2; k = 2, step 3) over its multi-view UNet."""
    root = tmp_path_factory.mktemp("jax")
    src = MVDPipeline.create(TINY_MODEL, seed=7, device="cpu")
    tree = jax.tree.map(jnp.asarray, W.jax_pipeline_tree(src.model))
    params_dir = str(root / "params")
    j_save_params(params_dir, tree)
    runs = {}
    for k in (1, 2):
        jstate = _jax_state(tree["mvd"], k)
        run = str(root / f"run{k}")
        mgr = JCheckpointManager(os.path.join(run, "checkpoints"), save_interval_steps=1)
        mgr.save(int(jstate.step), jstate, extra={"wandb_run_id": f"jax-{k}"},
                 metrics={"val/noise_loss": 0.5 - 0.1 * k})
        mgr.wait()
        mgr.close()
        runs[k] = (run, jstate)
    return dict(src=src, tree=tree, params=params_dir, runs=runs)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """10 objects x 4 views of random 64² RGBA PNGs with cameras and
    prompts: one object each in the val and the test split."""
    root = tmp_path_factory.mktemp("corpus")
    os.makedirs(root / "renders_final")
    rng = np.random.default_rng(0)
    cams = orbit_cameras(4)
    hw = TINY_MODEL.unet.sample_size * 8
    for i in range(10):
        with zipfile.ZipFile(root / "renders_final" / f"obj_{i}.zip", "w") as z:
            for v in range(4):
                z.writestr(f"{v:03d}.png", encode_png(rng.integers(0, 255, (hw, hw, 4), dtype=np.uint8)))
                buf = io.BytesIO()
                np.save(buf, cams[v].astype(np.float32))
                z.writestr(f"{v:03d}.npy", buf.getvalue())
            z.writestr("prompt.txt", f"object {i}")
    return str(root)


# ------------------------------------------------------------------ OCDBT


def _tensorstore_store(root):
    """A store written by tensorstore with small nodes (interior B+tree
    levels) and a version tree of arity 4 (version-tree nodes)."""
    spec = {"driver": "ocdbt", "base": f"file://{root}/",
            "config": {"max_decoded_node_bytes": 1024, "max_inline_value_bytes": 16,
                       "version_tree_arity_log2": 2}}
    kv = ts.KvStore.open(spec).result()
    for g in range(6):
        with ts.Transaction() as txn:
            for i in range(60):
                kv.with_transaction(txn).write(b"key/%03d/%d" % (i, g), bytes([i % 251]) * (i % 40)).result()
    return str(root)


def _check_node(store, base, loc_text):
    want = ts.ocdbt.dump(base, loc_text).result()
    got = store.btree_node(Location(*parse_location(loc_text)))
    assert want["height"] == got["height"] and len(want["entries"]) == len(got["entries"])
    for w, g in zip(want["entries"], got["entries"]):
        assert w["key"] == g[0]
        if want["height"] == 0:
            if "inline_value" in w:
                assert g[1].location is None and w["inline_value"] == g[1].inline
            else:
                assert parse_location(w["indirect_value"]) == tuple(g[1].location)
        else:
            assert w["subtree_common_prefix"] == g[1] and parse_location(w["location"]) == tuple(g[2])
            assert w["statistics"] == g[3]
            _check_node(store, base, w["location"])


def test_ocdbt_reader_agrees_with_tensorstore(saves, tmp_path):
    roots = [os.path.join(FIXTURES, "params"), os.path.join(FIXTURES, "params", "ocdbt.process_0"),
             os.path.join(FIXTURES, "run", "checkpoints", "2", "state"), saves["params"],
             _tensorstore_store(tmp_path / "ts")]
    for root in roots:
        store = OcdbtStore(root)
        kv = ts.KvStore.open({"driver": "ocdbt", "base": f"file://{root}/"}).result()
        keys = sorted(bytes(k) for k in kv.list().result())
        assert store.list() == keys, root
        for k in keys:
            assert store.read(k) == kv.read(k).result().value, (root, k)
        base = ts.KvStore.open(f"file://{root}/").result()
        want = ts.ocdbt.dump(base).result()
        cfg = store.manifest["config"]
        assert want["config"]["uuid"] == cfg["uuid"]
        for key in ("max_inline_value_bytes", "max_decoded_node_bytes", "version_tree_arity_log2"):
            assert want["config"][key] == cfg[key], key
        mine = store.manifest["versions"]
        assert len(want["versions"]) == len(mine)
        for w, g in zip(want["versions"], mine):
            assert (w["generation_number"], w["root_height"], w["commit_time"]) == \
                (g["generation_number"], g["root_height"], g["commit_time"])
            assert parse_location(w["root"]["location"]) == tuple(g["root"])
            assert w["root"]["statistics"] == {k: g[k] for k in ("num_keys", "num_tree_bytes",
                                                                  "num_indirect_value_bytes")}
        for w, g in zip(want["version_tree_nodes"], store.manifest["version_tree_nodes"]):
            assert parse_location(w["location"]) == tuple(g["location"])
            assert (w["height"], w["num_generations"], w["generation_number"]) == \
                (g["height"], g["num_generations"], g["generation_number"])
            node = ts.ocdbt.dump(base, w["location"]).result()
            assert [e["generation_number"] for e in node["entries"]] == \
                [e["generation_number"] for e in store.version_node(g["location"])["entries"]]
        _check_node(store, base, want["versions"][-1]["root"]["location"])
        store.close()
    # the tensorstore store's node and version structure was exercised
    store = OcdbtStore(roots[-1])
    assert store.manifest["versions"][-1]["root_height"] >= 1 and store.manifest["version_tree_nodes"]
    gens = [v["generation_number"] for v in store.versions()]
    assert gens == list(range(1, gens[-1] + 1)) and len(gens) > 4


def test_ocdbt_reader_refuses_damage(tmp_path):
    root = tmp_path / "params"
    shutil.copytree(os.path.join(FIXTURES, "params"), root)
    manifest = root / "manifest.ocdbt"
    blob = bytearray(manifest.read_bytes())
    blob[20] ^= 1
    manifest.write_bytes(bytes(blob))
    with pytest.raises(ValueError, match="CRC-32C"):
        OcdbtStore(str(root))
    manifest.write_bytes(bytes(blob[:-9]))
    with pytest.raises(ValueError, match="header says"):
        OcdbtStore(str(root))


# ------------------------------------------------------------------ trees and arrays


def test_read_tree_is_bitwise_jax_load_params(saves, tmp_path):
    # bf16, int32, 0-d, inline and indirect values: the fixture; a TINY
    # pipeline; multi-chunk arrays (orbax's chunk_byte_size)
    rng = np.random.default_rng(3)
    chunked = {"w": jnp.asarray(rng.standard_normal((37, 50)), jnp.float32),
               "h": jnp.asarray(rng.standard_normal((6, 40)), jnp.bfloat16),
               "n": jnp.arange(24, dtype=jnp.int32).reshape(4, 6)}
    ckptr = ocp.StandardCheckpointer()
    ckptr.save(str(tmp_path / "chunked"), chunked,
               save_args=jax.tree.map(lambda _: ocp.SaveArgs(chunk_byte_size=64), chunked))
    ckptr.wait_until_finished()
    assert len([k for k in OcdbtStore(str(tmp_path / "chunked")).list() if k.startswith(b"w/")]) > 10
    for path in (os.path.join(FIXTURES, "params"), saves["params"], str(tmp_path / "chunked")):
        got = read_tree(path)
        _assert_trees_bitwise(got, j_load_params(path))
    got = read_tree(os.path.join(FIXTURES, "params"))
    assert got["norm"]["scale"].dtype == torch.bfloat16 and got["temperature"].shape == ()
    assert isinstance(got["stack"], list)


def _ts_zarr(root, name, shape, chunks, dtype, fill):
    return ts.open({"driver": "zarr", "kvstore": {"driver": "ocdbt", "base": f"file://{root}/"},
                    "path": f"{name}/",
                    "metadata": {"shape": shape, "chunks": chunks, "dtype": dtype, "order": "C",
                                 "compressor": {"id": "zstd", "level": 3}, "fill_value": fill,
                                 "dimension_separator": "."}},
                   create=True).result()


def test_zarr_edge_and_missing_chunks_match_tensorstore(tmp_path):
    root = str(tmp_path / "z")
    rng = np.random.default_rng(4)
    cases = [("f4", [7, 10], [3, 4], "<f4", 1.5), ("f2", [5, 3], [2, 2], "<f2", None),
             ("i8", [9], [4], "<i8", -3), ("u1", [4, 4], [3, 3], "|u1", 7), ("b1", [5], [2], "|b1", True),
             ("bf", [3, 5], [2, 2], "bfloat16", 0.5), ("d0", [], [], "<f4", None)]
    for name, shape, chunks, dtype, fill in cases:
        arr = _ts_zarr(root, name, shape, chunks, dtype, fill)
        if shape:  # leave the chunks that hold index 0 of the last axis unwritten
            values = rng.standard_normal(shape) * 10
            sl = tuple(slice(None) for _ in shape[:-1]) + (slice(chunks[-1], None),)
            arr[sl] = values[sl].astype(arr.dtype.numpy_dtype)
        else:
            arr[()] = np.float32(2.25)
    store = OcdbtStore(root)
    for name, *_ in cases:
        want = ts.open({"driver": "zarr", "kvstore": {"driver": "ocdbt", "base": f"file://{root}/"},
                        "path": f"{name}/"}).result().read().result()
        got = ZarrArray(store, name).load()
        assert np.shape(got) == want.shape and _bits(got) == _bits(want), name


def test_what_the_reader_does_not_read_raises(tmp_path):
    w = W.OcdbtWriter(str(tmp_path / "bad"))
    good = {"chunks": [2], "compressor": None, "dimension_separator": ".", "dtype": "<f4",
            "fill_value": None, "filters": None, "order": "C", "shape": [2], "zarr_format": 2}
    variants = {"fortran": dict(order="F"), "blosc": dict(compressor={"id": "blosc"}),
                "filtered": dict(filters=[{"id": "delta"}]), "complex": dict(dtype="<c8"),
                "v3": None}
    for name, change in variants.items():
        if change is None:
            w.put(f"{name}/zarr.json".encode(), b"{}")
            continue
        w.put(f"{name}/.zarray".encode(), json.dumps({**good, **change}).encode())
    w.finish()
    store = OcdbtStore(str(tmp_path / "bad"))
    for name, match in (("fortran", "order 'F'"), ("blosc", "compressor 'blosc'"), ("filtered", "filters"),
                        ("complex", "dtype '<c8'"), ("v3", "zarr v3")):
        with pytest.raises(ValueError, match=match):
            ZarrArray(store, name).load()
    meta = tmp_path / "meta"
    W.write_pytree(str(meta), {"a": np.zeros(2, np.float32)})
    doc = json.loads((meta / "_METADATA").read_text())
    (meta / "_METADATA").write_text(json.dumps({**doc, "use_zarr3": True}))
    with pytest.raises(ValueError, match="zarr v3"):
        read_tree(str(meta))


def test_fixtures_read_to_the_jax_digests():
    with open(os.path.join(FIXTURES, "jax_sha256.json")) as f:
        want = json.load(f)

    def digests(tree):
        out = {}
        for k, v in _leaves(tree).items():
            if v is not None:
                out[k] = {"dtype": str(v.dtype).replace("torch.", ""), "shape": list(np.shape(v)),
                          "sha256": hashlib.sha256(_bits(v)).hexdigest()}
        return out

    assert digests(read_tree(os.path.join(FIXTURES, "params"))) == want["params"]
    state, meta, metrics = read_step(os.path.join(FIXTURES, "run", "checkpoints", "2"))
    step = want["run/checkpoints/2"]
    assert digests(state) == step["state"]
    assert meta == step["meta"] and metrics == step["metrics"]


# ------------------------------------------------------------------ params into pipelines


def _params_equal(a, b):
    sa, sb = dict(a.named_parameters()), dict(b.named_parameters())
    assert sa.keys() == sb.keys()
    return [k for k in sa if not torch.equal(sa[k], sb[k])]


def test_load_checkpoint_of_a_jax_save_params_dir(saves, tmp_path, capsys):
    want = MVDPipeline.create(TINY_MODEL, seed=1, device="cpu")
    want.load_jax_params(jax.tree.map(np.asarray, saves["tree"]))
    pipe = MVDPipeline.create(TINY_MODEL, seed=0, device="cpu")
    assert load_checkpoint(pipe, saves["params"]) == ([], [])
    assert "(orbax)" in capsys.readouterr().out
    assert _params_equal(pipe.model, want.model) == []
    # the CLIs' --checkpoint
    common = ["--tiny", "--device", "cpu", "--checkpoint", saves["params"]]
    got = infer.main(common + ["--num-images", "1", "--num-steps", "1", "--output-dir", str(tmp_path / "o")])
    served, _ = serve.build_pipeline(serve.build_argparser().parse_args(common))
    assert _params_equal(got.model, want.model) == [] and _params_equal(served.model, want.model) == []
    # components: --init-params and a VAE alone (precompute_latents, val --vae-params)
    part = str(tmp_path / "vae_only")
    j_save_params(part, {"vae": saves["tree"]["vae"]})
    fresh = MVDPipeline.create(TINY_MODEL, seed=0, device="cpu")
    assert load_params_into(fresh, part) == ["vae"]
    assert _params_equal(fresh.model["vae"], want.model["vae"]) == []
    vae = MVDPipeline.create(TINY_MODEL, seed=3, device="cpu").model["vae"]
    load_component(vae, saves["params"], "vae")
    assert _params_equal(vae, want.model["vae"]) == []
    # a missing component, a missing leaf, an extra leaf or a wrong dtype raise
    with pytest.raises(ValueError, match="whole pipeline|pipeline's tree"):
        load_checkpoint(fresh, part)
    with pytest.raises(ValueError, match="no 'text_encoder'"):
        load_component(vae, part, "text_encoder")
    tree = W.jax_pipeline_tree(want.model)
    del tree["vae"]["params"]["decoder"]["conv_out"]["bias"]
    W.write_pytree(str(tmp_path / "missing"), tree)
    with pytest.raises(ValueError, match="conv_out.bias"):
        load_checkpoint(fresh, str(tmp_path / "missing"))
    tree = W.jax_pipeline_tree(want.model)
    tree["vae"]["params"]["stray"] = {"kernel": np.zeros((2, 2), np.float32)}
    W.write_pytree(str(tmp_path / "extra"), tree)
    with pytest.raises(ValueError, match="stray"):
        load_params_into(fresh, str(tmp_path / "extra"))
    tree = W.jax_pipeline_tree(want.model)
    tree["vae"]["params"]["decoder"]["conv_out"]["bias"] = torch.zeros(3, dtype=torch.bfloat16)
    W.write_pytree(str(tmp_path / "bf16"), tree)
    with pytest.raises(ValueError, match="bfloat16 in the checkpoint"):
        load_params_into(fresh, str(tmp_path / "bf16"))


def test_tiny_generation_from_a_jax_save_params_dir_matches_jax(tmp_path):
    j_cfg, t_cfg = cut_config(J_TINY), cut_config(TINY_MODEL)
    lat = j_cfg.unet.sample_size
    z = jnp.zeros((1, lat, lat, 4))
    cam = jnp.eye(4)[None]
    params = {
        "mvd": random_params(JMVD(j_cfg).init, z, jnp.zeros((), jnp.int32),
                             jnp.zeros((1, 77, j_cfg.unet.cross_attention_dim)), source_camera=cam,
                             target_camera=cam, source_image_latents=z, seed=1),
        "vae": random_params(JVAE(j_cfg.vae).init, jnp.zeros((1, 16, 16, 3)), seed=2),
        "text_encoder": random_params(JCLIP(j_cfg.text_encoder).init, jnp.zeros((1, 77), jnp.int32), seed=3),
    }
    path = str(tmp_path / "params")
    j_save_params(path, jax.tree.map(jnp.asarray, params))
    tpipe = MVDPipeline.create(t_cfg, seed=0, device="cpu")
    load_checkpoint(tpipe, path)
    ref = MVDPipeline.create(t_cfg, seed=5, device="cpu")
    ref.load_jax_params(params)
    assert _params_equal(tpipe.model, ref.model) == []
    B, steps, seed = 2, 2, 5
    cams = orbit_cameras(B)
    src = np.random.default_rng(0).uniform(0, 1, (1, lat * 8, lat * 8, 3)).astype(np.float32)
    kw = dict(num_inference_steps=steps, guidance_scale=1.0, source_camera=np.tile(cams[:1], (B, 1, 1)),
              target_camera=cams, source_images=src, ref_scale=1.0)
    want = JPipeline(j_cfg, jax.tree.map(jnp.asarray, params))(["a chair"] * B, seed=seed, **kw)["images"]
    # the JAX pipeline's draws from its own key splits
    shape = (B, lat, lat, 4)
    rng, lat_rng = jax.random.split(jax.random.PRNGKey(seed))
    latents = np.array(jax.random.normal(lat_rng, shape, jnp.float32))
    rng, enc_rng = jax.random.split(rng)
    vae_noise = np.array(jax.random.normal(enc_rng, shape, jnp.float32))
    noises = []
    for _ in range(steps):
        rng, step_rng = jax.random.split(rng)
        noises.append(np.array(jax.random.normal(step_rng, shape, jnp.float32)))
    got = tpipe(["a chair"] * B, seed=seed, latents=latents, vae_noise=vae_noise,
                step_noises=np.stack(noises), **kw)["images"]
    assert np.isfinite(got).all() and snr_db(want, got) >= 50.0


# ------------------------------------------------------------------ train states


def _train_cfg(k):
    return TrainConfig(model=TINY_MODEL, grad_accum_steps=k, optimizer=OptimizerConfig())


def _model(src):
    """A fresh TINY model whose VAE and text encoder hold ``src``'s weights."""
    pipe = MVDPipeline.create(TINY_MODEL, seed=11, device="cpu")
    for net in ("vae", "text_encoder"):
        pipe.model[net].load_state_dict(src.model[net].state_dict())
    return pipe.model


def _snapshot(state):
    opt = {n: {k: (v.clone() if torch.is_tensor(v) else v) for k, v in state.optimizer.state[p].items()}
           for n, p in state.trainable.items()}
    return dict(params={k: v.clone() for k, v in state.model["mvd"].state_dict().items()}, opt=opt,
                counts=(state.step, state.updates, state.mini_step),
                acc=None if state.acc is None else {k: v.clone() for k, v in state.acc.items()})


def _assert_same(a, b):
    assert a["counts"] == b["counts"] and a["params"].keys() == b["params"].keys()
    for k in a["params"]:
        assert a["params"][k].dtype == b["params"][k].dtype and torch.equal(a["params"][k], b["params"][k]), k
    assert a["opt"].keys() == b["opt"].keys()
    for n in a["opt"]:
        assert a["opt"][n].keys() == b["opt"][n].keys()
        for k in a["opt"][n]:
            assert torch.equal(torch.as_tensor(a["opt"][n][k]), torch.as_tensor(b["opt"][n][k])), (n, k)
    assert (a["acc"] is None) == (b["acc"] is None)
    for k in a["acc"] or {}:
        assert torch.equal(a["acc"][k], b["acc"][k]), k


def _tiny_batch():
    hw = TINY_MODEL.unet.sample_size * 8
    rng = np.random.default_rng(6)
    cams = orbit_cameras(2).astype(np.float32)
    src = rng.uniform(-1, 1, (1, 1, hw, hw, 3)).astype(np.float32)
    b = {"source_image": np.repeat(src, 2, axis=1),
         "target_image": rng.uniform(-1, 1, (1, 2, hw, hw, 3)).astype(np.float32),
         "source_camera": np.tile(cams[:1], (1, 2, 1, 1)), "target_camera": cams[None],
         "input_ids": rng.integers(0, TINY_MODEL.text_encoder.vocab_size, (1, 2, 77)).astype(np.int32)}
    return {k: torch.from_numpy(v) for k, v in b.items()}


@pytest.mark.parametrize("k", [1, 2])
def test_a_jax_step_restores_bitwise_the_carried_state(saves, k):
    run, jstate = saves["runs"][k]
    cfg = _train_cfg(k)
    state = TrainState.create(_model(saves["src"]), cfg, TOTAL)
    mgr = CheckpointManager(os.path.join(run, "checkpoints"))
    assert mgr.all_steps() == [int(jstate.step)] == [mgr.latest_step()] == [mgr.best_step()]
    _, meta = mgr.restore(state)
    assert meta["wandb_run_id"] == f"jax-{k}" and meta["format"] == "orbax"
    assert meta["metrics"] == {"val/noise_loss": pytest.approx(0.5 - 0.1 * k)}
    carried = load_jax_train_state(_model(saves["src"]), jax.tree.map(np.asarray, jstate), cfg, TOTAL)
    a, b = _snapshot(state), _snapshot(carried)
    _assert_same(a, b)
    assert a["counts"] == ((2, 2, 0) if k == 1 else (3, 1, 1)) and (a["acc"] is None) == (k == 1)
    # the moments are the JAX state's (layouts converted)
    adam = jstate.opt_state.inner_states["trainable"].inner_state
    adam = (adam.inner_opt_state if k > 1 else adam)[1][0]
    mu = convert_jax_params(jax.tree.map(np.asarray, adam.mu))
    for name, p in state.trainable.items():
        assert np.array_equal(state.optimizer.state[p]["exp_avg"].numpy(), mu[name]), name
    # the next step from each: bitwise the same loss and parameters (the
    # carried state's step is held to the JAX step in test_torch_port_train.py)
    step = make_train_step(build_schedule(TINY_MODEL), cfg)
    batch = _tiny_batch()
    la = step(state, batch, generator=torch.Generator().manual_seed(0))["noise_loss"]
    lb = step(carried, batch, generator=torch.Generator().manual_seed(0))["noise_loss"]
    assert torch.isfinite(la) and torch.equal(la, lb) and snr_db(lb.numpy(), la.numpy()) >= 60.0
    _assert_same(_snapshot(state), _snapshot(carried))
    # a MultiSteps state under k = 1, or none under k = 2, does not carry
    other = TrainState.create(_model(saves["src"]), _train_cfg(3 - k), TOTAL)
    with pytest.raises(ValueError, match="grad_accum_steps"):
        mgr.restore(other)


def test_the_port_never_replaces_a_jax_step_and_resume_continues_it(saves, corpus, tmp_path):
    run = str(tmp_path / "run")
    shutil.copytree(saves["runs"][1][0], run)
    before = _sha_files(os.path.join(run, "checkpoints", "2"))
    state = TrainState.create(_model(saves["src"]), _train_cfg(1), TOTAL)
    mgr = CheckpointManager(os.path.join(run, "checkpoints"), max_to_keep=1, save_interval_steps=1)
    with pytest.raises(FileExistsError, match="checkpoints/2 was written by the JAX package"):
        mgr.save(2, state)
    for step in (4, 5, 6):  # retention keeps the port's best and latest, and never the JAX step's dir
        mgr.save(step, state, metrics={"val/noise_loss": 1.0 + step})
    assert mgr.all_steps() == [2, 4, 6] and mgr.best_step() == 2  # the JAX step's 0.4 ranks first
    for step in (4, 6):
        shutil.rmtree(os.path.join(run, "checkpoints", str(step)))
    restored = []
    resume = Trainer.resume

    def spy(self, *a, **kw):
        ok = resume(self, *a, **kw)
        restored.append(self.state.step)
        return ok

    with pytest.MonkeyPatch.context() as m:
        m.setattr(Trainer, "resume", spy)
        m.setattr(Trainer, "validate", lambda self, *a, **k: {})
        tr = train_cli.main(["--tiny", "--device", "cpu", "--dataset-path", corpus, "--batch-size", "2",
                             "--max-steps", "3", "--resume", run, "--output-dir", str(tmp_path / "out")])
    assert restored == [2] and tr.state.step == 3 and tr.logger.run_id == "jax-1"
    assert tr.ckpt.all_steps() == [2, 3]
    assert _sha_files(os.path.join(run, "checkpoints", "2")) == before


def test_val_cli_restores_a_jax_runs_latest_step(saves, corpus, tmp_path, capsys):
    run, jstate = saves["runs"][1]
    pipe, _ = val.main(["--tiny", "--device", "cpu", "--dataset-path", corpus, "--num-samples", "1",
                        "--batch-size", "1", "--num-steps", "1", "--output-dir", str(tmp_path / "out"),
                        "--checkpoint", run])
    assert "restored run checkpoint at step 2" in capsys.readouterr().out
    want = convert_jax_params(jax.tree.map(np.asarray, jstate.params))
    got = dict(pipe.model["mvd"].named_parameters())
    assert set(got) == set(want)
    for name, p in got.items():
        assert np.array_equal(p.detach().float().numpy(), want[name]), name


# ------------------------------------------------------------------ the layout writer


def test_layout_writer_is_read_by_orbax_and_the_jax_checkpoint_manager(saves, tmp_path):
    rng = np.random.default_rng(8)
    tree = {"a": {"kernel": rng.standard_normal((40, 30)).astype(np.float32)},
            "h": torch.randn(3, 4).to(torch.bfloat16), "n": np.arange(5, dtype=np.int32),
            "t": np.float32(0.5), "l": [np.ones(2, np.float32), np.zeros((1, 3), np.float32)]}
    W.write_pytree(str(tmp_path / "tree"), tree)
    got = ocp.StandardCheckpointer().restore(str(tmp_path / "tree"))
    _assert_trees_bitwise(read_tree(str(tmp_path / "tree")), got)
    assert _bits(got["h"]) == _bits(tree["h"]) and np.asarray(got["t"]).shape == ()
    # a port TrainState (k = 2, restored from the JAX run) written as a JAX
    # Trainer step: the JAX CheckpointManager restores the JAX state
    run, jstate = saves["runs"][2]
    state = TrainState.create(_model(saves["src"]), _train_cfg(2), TOTAL)
    CheckpointManager(os.path.join(run, "checkpoints")).restore(state)
    ckpt = str(tmp_path / "run" / "checkpoints")
    W.write_train_step(ckpt, state.step, W.jax_train_state_tree(state), {"wandb_run_id": "w"},
                       {"val/noise_loss": 0.1})
    mgr = JCheckpointManager(ckpt)
    back, meta = mgr.restore(jstate)
    mgr.close()
    assert meta == {"wandb_run_id": "w"}
    _assert_trees_bitwise(_leaves({"step": back.step, "params": back.params, "opt_state": back.opt_state}),
                          {"step": jstate.step, "params": jstate.params, "opt_state": jstate.opt_state})
    again = TrainState.create(_model(saves["src"]), _train_cfg(2), TOTAL)
    CheckpointManager(ckpt).restore(again)
    _assert_same(_snapshot(again), _snapshot(state))
