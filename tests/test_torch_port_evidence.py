"""The port's evidence-chain tools (``mvd_tpu_torch/tools/``) against the
JAX package's (``tools/rendering/procedural.py``, ``tools/pretrain_vae.py``)
on the CPU, at TINY_VAE, 32² and batch 2.

Bars: the corpus generator's objects, cameras and renders bitwise, its zips
member for member (the same names in the same order, the same ``.npy``,
``prompt.txt`` and ``metadata.json`` bytes, PNGs of the same RGBA pixels);
the batch stream bitwise the JAX tool's PIL loader over the same
permutation; loss, reconstruction and KL >= 60 dB against the JAX tool's
formula on ``mvd_tpu.nn.vae.AutoencoderKL`` with the same parameters and
noise, every gradient leaf >= 40 dB; the parameters and their updates
after 3 steps of the optimizer fed the same gradients >= 60 dB against
optax; the validation PSNR and the latent std >= 60 dB. The port's
``main`` writes a directory that ``cli.train --init-params`` and ``cli.val
--vae-params`` load bitwise, and reads the JAX tool's output
(``tests/fixtures/torch_port_evidence/jax_vae``) to the digests the JAX
package's reader gave. One JAX compile in the file.
"""

import hashlib
import importlib.util
import io
import json
import os
import sys
import zipfile

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from PIL import Image

from _torch_port_util import snr_db
from mvd_tpu.nn.vae import AutoencoderKL as JVAE
from mvd_tpu_torch.checkpoint import export_jax_params, load_component, load_params
from mvd_tpu_torch.cli import train as train_cli
from mvd_tpu_torch.cli import val as val_cli
from mvd_tpu_torch.config import TINY_VAE
from mvd_tpu_torch.nn.vae import AutoencoderKL
from mvd_tpu_torch.tools import pretrain_vae as tt
from mvd_tpu_torch.tools import procedural as tp
from mvd_tpu_torch.train.loop import Trainer
from mvd_tpu_torch.utils.images import png_samples

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURES = os.path.join(REPO, "tests", "fixtures", "torch_port_evidence")
YAML = os.path.join(FIXTURES, "tiny_vae.yaml")
SIZE, BATCH, KL_WEIGHT = 32, 2, 0.05  # a KL weight that moves the loss and the gradients


def _load_tool(name: str, path: str):
    spec = importlib.util.spec_from_file_location(name, os.path.join(REPO, path))
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod  # dataclasses look their module up
    spec.loader.exec_module(mod)
    return mod


jp = _load_tool("jax_tool_procedural", "tools/rendering/procedural.py")
jt = _load_tool("jax_tool_pretrain_vae", "tools/pretrain_vae.py")


def _fixture_index():
    zips = sorted(os.path.join(FIXTURES, "renders_final", n)
                  for n in os.listdir(os.path.join(FIXTURES, "renders_final")))
    return tt.build_image_index(zips)


def _random_vae(seed: int = 0) -> AutoencoderKL:
    """TINY_VAE with every parameter drawn from a numpy seed: conv and
    dense weights N(0, 1/fan_in), norm scales near 1, biases small."""
    vae = AutoencoderKL(TINY_VAE)
    rng = np.random.default_rng(seed)
    with torch.no_grad():
        for name, p in vae.named_parameters():
            if p.dim() > 1:
                v = rng.normal(0.0, p[0].numel() ** -0.5, p.shape)
            elif "norm" in name and name.endswith("weight"):
                v = 1.0 + 0.1 * rng.normal(size=p.shape)
            else:
                v = 0.1 * rng.normal(size=p.shape)
            p.copy_(torch.from_numpy(v.astype(np.float32)))
    return vae


def _flat(tree, prefix=()):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, prefix + (k,)))
        else:
            out["/".join(prefix + (k,))] = np.asarray(v)
    return out


# ------------------------------------------------------------------ the corpus


def test_objects_cameras_and_renders_are_the_jax_tools():
    rng_j, rng_t = np.random.default_rng(5), np.random.default_rng(5)
    seen = set()
    for _ in range(6):
        pj, pt = jp.sample_object(rng_j), tp.sample_object(rng_t)
        assert [(p.kind, p.color_name, p.checker, p.checker_scale) for p in pj] == \
               [(p.kind, p.color_name, p.checker, p.checker_scale) for p in pt]
        for a, b in zip(pj, pt):
            for f in ("center", "size", "rotation"):
                assert np.array_equal(getattr(a, f), getattr(b, f)), f
        assert jp.object_prompt(pj) == tp.object_prompt(pt)
        cj, ct = jp.object_cameras(rng_j, 2), tp.object_cameras(rng_t, 2)
        assert cj.dtype == ct.dtype == np.float32 and np.array_equal(cj, ct)
        for cam in cj:
            want, got = jp.render_view(pj, cam, 12), tp.render_view(pt, cam, 12)
            assert got.dtype == np.uint8 and np.array_equal(want, got)
        seen |= {(p.kind, p.checker) for p in pt}
    # every intersector, normal and albedo branch ran
    assert {k for k, _ in seen} == {"sphere", "box", "cylinder"} and {c for _, c in seen} == {True, False}


def test_generate_corpus_writes_the_jax_tools_zips(tmp_path):
    jp.generate_corpus(str(tmp_path / "jax"), 2, 3, SIZE, seed=3)
    tp.main(["--out", str(tmp_path / "port"), "--num-objects", "2", "--views", "3", "--size", str(SIZE),
             "--seed", "3"])
    for i in range(2):
        name = f"renders_final/proc_{i:05d}.zip"
        with zipfile.ZipFile(tmp_path / "jax" / name) as a, zipfile.ZipFile(tmp_path / "port" / name) as b:
            assert a.namelist() == b.namelist()
            assert [n for n in b.namelist() if n.endswith(".png")] == [f"{v:03d}.png" for v in range(3)]
            for n in a.namelist():
                want, got = a.read(n), b.read(n)
                if n.endswith(".png"):  # RGBA pixels: PIL's of the JAX file; the port's and PIL's of the port's
                    pixels = np.asarray(Image.open(io.BytesIO(want)))
                    assert pixels.shape == (SIZE, SIZE, 4)
                    assert np.array_equal(png_samples(got)[0], pixels)
                    assert np.array_equal(np.asarray(Image.open(io.BytesIO(got))), pixels)
                else:
                    assert want == got, n


def test_the_fixture_is_what_the_port_renders(tmp_path):
    """chip_smoke.py phase 11a holds the card host's render to these zips;
    here the CPU's, on the first view of each object."""
    rng = np.random.default_rng(0)  # object 0's stream (seed 0)
    prims = tp.sample_object(rng)
    cams = tp.object_cameras(rng, 8)
    with zipfile.ZipFile(os.path.join(FIXTURES, "renders_final", "proc_00000.zip")) as z:
        assert z.read("prompt.txt").decode() == tp.object_prompt(prims)
        assert np.array_equal(np.load(io.BytesIO(z.read("000.npy"))), cams[0])
        assert np.array_equal(png_samples(z.read("000.png"))[0], tp.render_view(prims, cams[0], 256))


# ------------------------------------------------------------------ the batch stream


def test_batch_stream_is_the_jax_tools_loader():
    """Three batches of 6 from 16 images: the drop-last at the end of the
    first epoch and the second epoch's permutation included."""
    index = _fixture_index()
    assert index == jt.build_image_index(sorted({zp for zp, _ in index}))
    order_rng = np.random.default_rng(7)
    want = []
    while len(want) < 3:
        order = order_rng.permutation(len(index))
        for s in range(0, len(order) - 6 + 1, 6):
            want.append(np.stack([jt.load_image(*index[i], SIZE) for i in order[s:s + 6]]))
    stream = tt.batch_stream(index, 6, SIZE, seed=7)
    got = [next(stream) for _ in range(3)]
    stream.close()
    for w, g in zip(want, got[:3]):
        assert g.dtype == np.uint8 and g.shape == (6, SIZE, SIZE, 3) and np.array_equal(w, g)


def test_batch_stream_raises_what_its_thread_hit():
    index = _fixture_index()
    stream = tt.batch_stream([(index[0][0], "missing.png")] * 4, 2, SIZE, seed=0)
    with pytest.raises(KeyError, match="missing.png"):
        next(stream)
    with pytest.raises(ValueError, match="no batch"):
        next(tt.batch_stream(index[:1], 2, SIZE, seed=0))


# ------------------------------------------------------------------ loss, gradients, validation


@pytest.fixture(scope="module")
def reference():
    """The JAX tool's loss (``tools/pretrain_vae.py:114-124``) and its
    gradients on ``mvd_tpu.nn.vae.AutoencoderKL`` with the port's random
    parameters, a batch of two fixture views and fixed noise; with zero
    noise the decode is ``val_recon``'s (:135-141), whose per-image PSNR
    and the latent std (:195-198) are taken from the same run. One
    compile."""
    vae = _random_vae()
    jvae = JVAE(TINY_VAE)
    params = {"params": export_jax_params(vae)}
    batch = np.stack([tt.load_image(*ix, SIZE) for ix in _fixture_index()[3:3 + BATCH]])
    noise = np.random.default_rng(1).normal(size=(BATCH, SIZE // 8, SIZE // 8, 4)).astype(np.float32)

    def loss_fn(params, batch_u8, key_noise):
        batch = batch_u8.astype(jnp.float32) / 127.5 - 1.0
        mean, logvar = jvae.apply(params, batch, method=jvae.encode_moments)
        std = jnp.exp(0.5 * logvar)
        z = mean + std * key_noise.astype(mean.dtype)
        recon = jvae.apply(params, z, method=jvae.decode)
        recon_loss = jnp.mean(jnp.square(recon.astype(jnp.float32) - batch))
        kl = -0.5 * jnp.mean(1.0 + logvar - jnp.square(mean) - jnp.exp(logvar))
        mse = jnp.mean(jnp.square(recon.astype(jnp.float32) - batch), axis=(1, 2, 3))
        psnr = jnp.mean(10.0 * jnp.log10(4.0 / mse))
        return recon_loss + KL_WEIGHT * kl, (recon_loss, kl, psnr, jnp.std(mean.astype(jnp.float32)))

    run = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))
    # XLA's backend optimization level 0 halves the compile; f32 math is the same
    run = run.lower(params, batch, noise).compile(compiler_options={"xla_backend_optimization_level": 0})
    (loss, (recon, kl, _, _)), grads = jax.device_get(run(params, batch, noise))
    (_, (_, _, psnr, std)), _ = jax.device_get(run(params, batch, np.zeros_like(noise)))
    return vae, batch, noise, dict(loss=loss, recon=recon, kl=kl, grads=grads, psnr=psnr, std=std)


def test_loss_and_gradients_match_the_jax_tool(reference):
    vae, batch, noise, want = reference
    loss, recon, kl = tt.vae_loss(vae, torch.from_numpy(batch), torch.from_numpy(noise), KL_WEIGHT)
    for name, v in (("loss", loss), ("recon", recon), ("kl", kl)):
        assert v.dtype == torch.float32 and snr_db(want[name], v.item()) >= 60, name
    assert abs(KL_WEIGHT * float(want["kl"])) > 1e-3 * float(want["loss"])  # the KL term counts
    loss.backward()
    grads = _flat(export_jax_params(vae, {n: p.grad for n, p in vae.named_parameters()}))
    ref = _flat(want["grads"]["params"])
    assert grads.keys() == ref.keys()
    # a key bias adds q.b to every logit of a query's row, which the softmax
    # takes away: its gradient is 0, and both packages give rounding noise
    # far below the gradient's scale
    zero = {f"{net}/mid_attn/to_k/bias" for net in ("encoder", "decoder")}
    scale = np.sqrt(sum(np.sum(np.square(r, dtype=np.float64)) for r in ref.values()))
    for k, g in grads.items():
        assert g.shape == ref[k].shape, k
        if k in zero:
            assert np.linalg.norm(g) < 1e-6 * scale and np.linalg.norm(ref[k]) < 1e-6 * scale, k
        else:
            assert snr_db(ref[k], g) >= 40, k


def test_validation_psnr_and_latent_std_match_the_jax_tool(reference):
    vae, batch, _, want = reference
    for chunk in (1, BATCH):
        psnr = tt.val_recon(vae, torch.from_numpy(batch), chunk)
        std = tt.latent_std(vae, torch.from_numpy(batch), chunk)
        assert snr_db(want["psnr"], psnr.item()) >= 60 and snr_db(want["std"], std.item()) >= 60


def test_optimizer_matches_optax():
    """3 updates fed the same gradients, the global norm above the clip at
    the first two and below it at the third: the parameters and what the
    updates moved them by, against optax's chain of the JAX tool."""
    torch.manual_seed(2)
    net = torch.nn.Sequential(torch.nn.Conv2d(3, 8, 3), torch.nn.GroupNorm(4, 8), torch.nn.Flatten(),
                              torch.nn.Linear(8, 5))
    lr, steps = 3e-3, 3
    params = {n: p.detach().numpy().copy() for n, p in net.named_parameters()}
    rng = np.random.default_rng(3)
    grads = [{n: (rng.normal(size=p.shape) * scale).astype(np.float32) for n, p in params.items()}
             for scale in (1.0, 0.2, 1e-3)]
    tx = optax.chain(optax.clip_by_global_norm(1.0),
                     optax.adamw(optax.cosine_decay_schedule(lr, steps, alpha=0.1), weight_decay=1e-4))
    @jax.jit
    def updated(p, grads):
        state = tx.init(p)
        for g in grads:
            updates, state = tx.update(g, state, p)
            p = optax.apply_updates(p, updates)
        return p

    jparams = jax.device_get(updated(params, grads))

    opt = tt.make_optimizer(net)
    schedule = tt.cosine_decay_schedule(lr, steps, alpha=tt.LR_FLOOR)
    for count, g in enumerate(grads):
        for n, p in net.named_parameters():
            p.grad = torch.from_numpy(g[n])
        tt.apply_update(opt, schedule(count))
    for n, p in net.named_parameters():
        want, got = np.asarray(jparams[n]), p.detach().numpy()
        assert snr_db(want, got) >= 60 and snr_db(want - params[n], got - params[n]) >= 60, n


def test_schedule_is_optax_cosine_decay():
    want = optax.cosine_decay_schedule(1e-4, 10, alpha=0.1)
    got = tt.cosine_decay_schedule(1e-4, 10, alpha=0.1)
    assert got(0) == 1e-4  # update 1 runs at the full lr
    for count in (0, 1, 5, 9, 10, 12):
        assert abs(got(count) - float(want(count))) <= 1e-7 * 1e-4, count


# ------------------------------------------------------------------ the entry point


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """12 objects of 3 views at 32²: 10 train, 1 val, 1 test."""
    root = tmp_path_factory.mktemp("evidence_corpus")
    tp.generate_corpus(str(root), 12, 3, SIZE, seed=0)
    return str(root)


def test_main_writes_what_train_and_val_load(corpus, tmp_path, capsys):
    out = str(tmp_path / "vae")
    meta = tt.main(["--device", "cpu", "--dataset-path", corpus, "--output", out, "--config", YAML,
                    "--steps", "2", "--batch-size", str(BATCH), "--val-every", "1"])
    text = capsys.readouterr().out
    assert "train images: 30, val images: 3" in text
    with open(os.path.join(out, "mvd_config.json")) as f, \
            open(os.path.join(FIXTURES, "jax_vae", "mvd_config.json")) as g:
        written, jax_written = json.load(f), json.load(g)
    assert written.keys() == jax_written.keys() and written == {k: meta[k] for k in written}
    assert [h["step"] for h in meta["val_history"]] == [1, 2] and meta["steps"] == 2
    assert [r["step"] for r in meta["logged"]] == [1] and np.isfinite(meta["logged"][0]["loss"])
    assert meta["recommended_scaling_factor"] == pytest.approx(1.0 / meta["latent_std"])
    saved = load_params(out)["vae"]

    with pytest.MonkeyPatch.context() as m:
        m.setattr(Trainer, "validate", lambda self, *a, **k: {})
        tr = train_cli.main(["--tiny", "--device", "cpu", "--dataset-path", corpus, "--batch-size", "1",
                             "--max-steps", "1", "--output-dir", str(tmp_path / "run"), "--init-params", out])
    pipe, overall = val_cli.main(["--tiny", "--device", "cpu", "--dataset-path", corpus, "--num-samples", "1",
                                  "--batch-size", "1", "--num-steps", "1", "--output-dir",
                                  str(tmp_path / "val"), "--vae-params", out])
    assert overall["num_samples"] == 1
    for model in (tr.state.model["vae"], pipe.model["vae"]):
        sd = model.state_dict()
        assert sd.keys() == saved.keys()
        for k, v in saved.items():
            assert torch.equal(sd[k].float(), v), k


def test_port_reads_the_jax_tools_output_bitwise():
    with open(os.path.join(FIXTURES, "jax_vae_sha256.json")) as f:
        want = json.load(f)
    vae = AutoencoderKL(TINY_VAE)
    with torch.no_grad():
        for p in vae.parameters():
            p.fill_(float("nan"))
    load_component(vae, os.path.join(FIXTURES, "jax_vae"), "vae")
    got = {f"vae/params/{k}": {"dtype": v.dtype.name, "shape": list(v.shape),
                               "sha256": hashlib.sha256(v.tobytes()).hexdigest()}
           for k, v in _flat(export_jax_params(vae)).items()}
    assert got == want


def test_main_needs_a_gpu_unless_told_cpu(corpus, tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tt.main(["--dataset-path", corpus, "--output", str(tmp_path / "vae"), "--config", YAML])
    assert not (tmp_path / "vae").exists()
