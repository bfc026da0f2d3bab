"""The port's modules against the JAX package's, at tiny widths on the CPU.

Each case makes flax params with ``jax.eval_shape`` filled from a numpy
seed, carries them into the port with ``checkpoint/from_jax.py`` (which
fails on any unmatched leaf), runs both sides in f32 on the same numpy
inputs and holds the port to >= 60 dB. The traps the JAX records name
(GELU form, LayerNorm and GroupNorm eps, adapter K/V dtype, VAE padding,
skipped dummy adapter calls) each get a case that a wrong port fails.
"""

import ast
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as fnn

from _torch_port_util import random_params, snr_db
from mvd_tpu import camera as jcam
from mvd_tpu.config import TINY_CLIP, TINY_MODEL as J_TINY, TINY_VAE
from mvd_tpu.nn import adapter_init as j_adapter_init
from mvd_tpu.nn import layers as jl
from mvd_tpu.nn.camera_encoder import CameraEncoder as JCameraEncoder
from mvd_tpu.nn.camera_encoder import modulation_dims as j_modulation_dims
from mvd_tpu.nn.clip_text import CLIPTextEncoder as JCLIP
from mvd_tpu.nn.vae import AutoencoderKL as JVAE
from mvd_tpu_torch import camera as tcam
from mvd_tpu_torch.checkpoint import convert_jax_params, load_jax_params
from mvd_tpu_torch.config import TINY_MODEL, CameraEncoderConfig
from mvd_tpu_torch.kernels.flash_attention import flash_attention_packed_fwd
from mvd_tpu_torch.nn import adapter_init as t_adapter_init
from mvd_tpu_torch.nn import layers as tl
from mvd_tpu_torch.nn.camera_encoder import CameraEncoder, modulation_dims
from mvd_tpu_torch.nn.clip_text import CLIPTextEncoder
from mvd_tpu_torch.nn.unet import UNet2DCondition
from mvd_tpu_torch.nn.vae import AutoencoderKL
from mvd_tpu_torch.pipeline.pipeline import _signed_range

BAR_DB = 60.0
REPO = pathlib.Path(__file__).resolve().parents[1]


def _rand(shape, seed=0, scale=1.0, offset=0.0):
    return (np.random.default_rng(seed).normal(size=shape) * scale + offset).astype(np.float32)


def _nchw(x):
    return torch.from_numpy(x).permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)


def _nhwc(t):
    return t.permute(0, 2, 3, 1).detach().numpy()


def _carry(jmod, tmod, *args, seed=1, **kwargs):
    params = random_params(jmod.init, *args, seed=seed, **kwargs)
    load_jax_params(tmod, params)
    return params


# ---------------------------------------------------------------------------
# building blocks that hold a kernel (GroupNorm -> K2, attention -> K1)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("eps,silu", [(1e-5, True), (1e-6, False)])
def test_groupnorm_module(eps, silu):
    x = _rand((2, 4, 4, 32), offset=0.3)
    jm = jl.GroupNorm(8, eps, fuse_silu=silu)
    tm = tl.GroupNorm(8, 32, eps, fuse_silu=silu)
    p = _carry(jm, tm, jnp.asarray(x))
    assert snr_db(jm.apply(p, jnp.asarray(x)), _nhwc(tm(_nchw(x)))) >= BAR_DB


@pytest.mark.parametrize("context", [False, True])
def test_attention_module(context):
    x = _rand((2, 24, 32))
    ctx = _rand((2, 77, 48), seed=1) if context else None
    jm = jl.Attention(heads=2, head_dim=16)
    tm = tl.Attention(32, 2, 16, 48 if context else None)
    jargs = (jnp.asarray(x),) + ((jnp.asarray(ctx),) if context else ())
    p = _carry(jm, tm, *jargs)
    targs = (torch.from_numpy(x),) + ((torch.from_numpy(ctx),) if context else ())
    assert snr_db(jm.apply(p, *jargs), tm(*targs).detach().numpy()) >= BAR_DB


@pytest.mark.parametrize("precomputed", [False, True])
def test_cross_view_adapter(precomputed):
    x, ref = _rand((2, 16, 32)), _rand((2, 20, 32), seed=2)
    jm = jl.CrossViewAdapter(heads=2, head_dim=16)
    tm = tl.CrossViewAdapter(32, 2, 16)
    p = _carry(jm, tm, jnp.asarray(x), jnp.asarray(ref))
    if precomputed:
        w = p["params"]
        k, v = ref @ w["to_k_ref"]["kernel"], ref @ w["to_v_ref"]["kernel"]
        jref, tref = (jnp.asarray(k), jnp.asarray(v)), (torch.from_numpy(k), torch.from_numpy(v))
    else:
        jref, tref = jnp.asarray(ref), torch.from_numpy(ref)
    want = jm.apply(p, jnp.asarray(x), jref)
    assert snr_db(want, tm(torch.from_numpy(x), tref).detach().numpy()) >= BAR_DB


def test_adapter_casts_precomputed_kv_to_compute_dtype(monkeypatch):
    """Precomputed K/V arrive in f32; the kernel must see the compute dtype."""
    seen = []
    real = tl.attention_packed

    def spy(q, k, v, heads, **kwargs):
        seen.append((q.dtype, k.dtype, v.dtype))
        return real(q, k, v, heads, **kwargs)

    monkeypatch.setattr(tl, "attention_packed", spy)
    tm = tl.CrossViewAdapter(32, 2, 16).to(torch.bfloat16)
    kv = (torch.randn(1, 5, 32), torch.randn(1, 5, 32))
    out = tm(torch.randn(1, 4, 32, dtype=torch.bfloat16), kv)
    assert seen == [(torch.bfloat16,) * 3] and out.dtype == torch.bfloat16


def test_feedforward_gelu_is_tanh_approximation():
    x = _rand((2, 8, 16), scale=2.0)
    jm, tm = jl.FeedForward(dim=16), tl.FeedForward(16)
    p = _carry(jm, tm, jnp.asarray(x))
    want = np.asarray(jm.apply(p, jnp.asarray(x)))
    # the exact/tanh GELU gap (~1e-3) is far above this tolerance
    np.testing.assert_allclose(tm(torch.from_numpy(x)).detach().numpy(), want, atol=2e-5, rtol=1e-5)


@pytest.mark.parametrize("kind", ["streaming", "flax"])
def test_layernorm_eps(kind):
    """Small-variance rows make eps visible: 1e-5 (transformer blocks) vs
    flax's 1e-6 (camera encoder)."""
    x = _rand((3, 16), scale=2e-3)
    if kind == "streaming":
        jm, tm = jl.StreamingLayerNorm(epsilon=1e-5), tl.StreamingLayerNorm(16)
    else:
        jm, tm = fnn.LayerNorm(dtype=jnp.float32), tl.LayerNorm(16)
    p = _carry(jm, tm, jnp.asarray(x))
    want = np.asarray(jm.apply(p, jnp.asarray(x)))
    np.testing.assert_allclose(tm(torch.from_numpy(x)).detach().numpy(), want, atol=1e-4, rtol=1e-4)


def test_groupnorm_eps_per_site():
    unet = UNet2DCondition(TINY_MODEL.unet)
    vae = AutoencoderKL(TINY_MODEL.vae)
    norms = [(n, m) for n, m in unet.named_modules() if isinstance(m, tl.GroupNorm)]
    for name, m in norms:  # Transformer2D.norm 1e-6, resnets and conv_norm_out 1e-5
        assert m.eps == (1e-6 if "attn" in name else 1e-5), name
    assert {m.eps for _, m in norms} == {1e-5, 1e-6}
    assert all(m.eps == 1e-6 for m in vae.modules() if isinstance(m, tl.GroupNorm))


def test_timestep_embedding():
    t = np.array([0, 1, 500, 999], np.int32)
    want = jl.timestep_embedding(jnp.asarray(t), 32)
    assert snr_db(want, tl.timestep_embedding(torch.from_numpy(t), 32).numpy()) >= BAR_DB


def test_normalize_ref_feature():
    f = _rand((2, 4, 4, 8), offset=1.0)
    want = jl.normalize_ref_feature(jnp.asarray(f))
    assert snr_db(want, tl.normalize_ref_feature(torch.from_numpy(f)).numpy()) >= BAR_DB


def test_resnet_block():
    x, temb = _rand((2, 8, 8, 32)), _rand((2, 128), seed=3)
    jm = jl.ResnetBlock(out_channels=64, norm_num_groups=8)
    tm = tl.ResnetBlock(32, 64, 8, 1e-5, temb_dim=128)
    p = _carry(jm, tm, jnp.asarray(x), jnp.asarray(temb))
    want = jm.apply(p, jnp.asarray(x), jnp.asarray(temb))
    assert snr_db(want, _nhwc(tm(_nchw(x), torch.from_numpy(temb)))) >= BAR_DB


def test_transformer2d_with_adapters():
    x, ctx, ref = _rand((2, 4, 4, 32)), _rand((2, 77, 48), seed=1), _rand((2, 16, 32), seed=2)
    jm = jl.Transformer2D(heads=2, head_dim=16, norm_num_groups=8, with_adapters=True)
    tm = tl.Transformer2D(32, 2, 16, 48, 1, 8, with_adapters=True)
    args = (jnp.asarray(x), jnp.asarray(ctx), jnp.asarray(ref))
    p = _carry(jm, tm, *args)
    want = jm.apply(p, *args, jnp.float32(0.7))
    got = tm(_nchw(x), torch.from_numpy(ctx), torch.from_numpy(ref), 0.7)
    assert snr_db(want, _nhwc(got)) >= BAR_DB


@pytest.mark.parametrize("asym", [False, True])
def test_downsample_and_upsample(asym):
    x = _rand((2, 8, 8, 16))
    jd, td = jl.Downsample(16, asymmetric_pad=asym), tl.Downsample(16, 16, asym)
    p = _carry(jd, td, jnp.asarray(x))
    assert snr_db(jd.apply(p, jnp.asarray(x)), _nhwc(td(_nchw(x)))) >= BAR_DB
    ju, tu = jl.Upsample(8), tl.Upsample(16, 8)
    p = _carry(ju, tu, jnp.asarray(x), seed=2)
    assert snr_db(ju.apply(p, jnp.asarray(x)), _nhwc(tu(_nchw(x)))) >= BAR_DB


# ---------------------------------------------------------------------------
# networks
# ---------------------------------------------------------------------------


def test_camera_encoder():
    cfg = CameraEncoderConfig(output_dim=48, hidden_dim=32)
    dims = tuple(sorted(j_modulation_dims((32, 64, 64, 64), 4, 4).items()))
    assert dims == tuple(sorted(modulation_dims((32, 64, 64, 64), 4, 4).items()))
    cams = jcam.orbit_cameras(3)
    src = np.tile(cams[:1], (3, 1, 1))
    np.testing.assert_array_equal(cams, tcam.orbit_cameras(3))
    jm, tm = JCameraEncoder(J_TINY.camera_encoder, dims), CameraEncoder(cfg, dims)
    p = _carry(jm, tm, jnp.asarray(src), jnp.asarray(cams))
    jemb, jfilm = jax.jit(jm.apply)(p, jnp.asarray(src), jnp.asarray(cams))
    temb, tfilm = tm(torch.from_numpy(src), torch.from_numpy(cams))
    assert snr_db(jemb, temb.detach().numpy()) >= BAR_DB
    assert jfilm.keys() == tfilm.keys()
    for name in jfilm:
        for a, b in zip(jfilm[name], tfilm[name]):
            assert snr_db(a, b.detach().numpy()) >= BAR_DB, name


@pytest.mark.parametrize("act", ["gelu", "quick_gelu"])
def test_clip_text_encoder(act):
    import dataclasses

    jcfg = dataclasses.replace(TINY_CLIP, hidden_act=act)
    ids = np.random.default_rng(0).integers(0, jcfg.vocab_size, (2, 77)).astype(np.int32)
    jm, tm = JCLIP(jcfg), CLIPTextEncoder(dataclasses.replace(TINY_MODEL.text_encoder, hidden_act=act))
    p = _carry(jm, tm, jnp.asarray(ids))
    assert snr_db(jm.apply(p, jnp.asarray(ids)), tm(torch.from_numpy(ids)).detach().numpy()) >= BAR_DB


def test_vae_encode_decode():
    img = np.random.default_rng(0).uniform(-1, 1, (1, 16, 16, 3)).astype(np.float32)
    jm, tm = JVAE(TINY_VAE), AutoencoderKL(TINY_MODEL.vae)
    p = _carry(jm, tm, jnp.asarray(img))
    jmean, jlogvar = jax.jit(lambda p, x: jm.apply(p, x, method=jm.encode_moments))(p, jnp.asarray(img))
    tmean, tlogvar = tm.encode_moments(torch.from_numpy(img))
    assert snr_db(jmean, tmean.detach().numpy()) >= BAR_DB
    assert snr_db(jlogvar, tlogvar.detach().numpy()) >= BAR_DB
    z = np.array(jmean)
    want = jax.jit(lambda p, z: jm.apply(p, z, method=jm.decode))(p, jnp.asarray(z))
    assert snr_db(want, tm.decode(torch.from_numpy(z)).detach().numpy()) >= BAR_DB


def test_unet_feature_pass_skips_dummy_adapter_calls():
    """With no reference features the adapters run nowhere: two attention
    calls per transformer block (attn1, attn2), four with adapter K/V."""
    unet = UNet2DCondition(TINY_MODEL.unet)
    blocks = sum(1 for n, _ in unet.named_modules() if n.endswith("transformer_blocks_0"))
    x, ctx = torch.randn(1, 8, 8, 4), torch.randn(1, 77, 64)
    calls = flash_attention_packed_fwd.plain_calls
    with torch.no_grad():
        _, feats = unet(x, torch.tensor(0), ctx)
    assert flash_attention_packed_fwd.plain_calls - calls == 2 * blocks
    assert len(feats) == blocks == 16


# ---------------------------------------------------------------------------
# adapter init, source range, weights, imports
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("base,shape", [((64, 32), (32, 32)), ((32, 64), (64, 64)), ((48, 64), (64, 64))])
def test_adapt_kv_weight_rules(base, shape):
    """Copy, zero-pad and truncate-transpose, on torch (out, in) weights
    against the JAX rule on flax (in, out) kernels."""
    kern = _rand(base)  # flax (in, out)
    want = np.asarray(j_adapter_init._adapt_kv_kernel(jnp.asarray(kern), *shape))
    got = t_adapter_init._adapt_kv_weight(torch.from_numpy(kern.T.copy()), shape[1], shape[0])
    np.testing.assert_array_equal(got.numpy().T, want)


def test_init_adapters_from_frozen():
    x, ctx = _rand((1, 4, 4, 32)), _rand((1, 77, 64), seed=1)
    jm = jl.Transformer2D(heads=2, head_dim=16, norm_num_groups=8, with_adapters=True)
    tm = tl.Transformer2D(32, 2, 16, 64, 1, 8, with_adapters=True)
    p = _carry(jm, tm, jnp.asarray(x), jnp.asarray(ctx), jnp.asarray(x.reshape(1, 16, 32)))
    want = convert_jax_params(jax.tree.map(np.asarray, j_adapter_init.init_adapters_from_frozen(p)))
    t_adapter_init.init_adapters_from_frozen(tm)
    got = {k: v.detach().numpy() for k, v in tm.named_parameters()}
    assert want.keys() == got.keys()
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_load_jax_params_rejects_unmatched_leaves():
    jm, tm = jl.FeedForward(dim=16), tl.FeedForward(16)
    p = random_params(jm.init, jnp.zeros((1, 2, 16)))
    extra = {"params": {**p["params"], "stray": {"kernel": np.zeros((16, 16), np.float32)}}}
    with pytest.raises(KeyError, match="stray"):
        load_jax_params(tm, extra)
    with pytest.raises(KeyError, match="proj_out"):
        load_jax_params(tm, {"params": {"proj_geglu": p["params"]["proj_geglu"]}})


def test_signed_range():
    unit = torch.rand(1, 4, 4, 3)
    torch.testing.assert_close(_signed_range(unit), 2 * unit - 1)
    signed = unit * 2 - 1
    torch.testing.assert_close(_signed_range(signed), signed)


def test_port_imports_nothing_of_jax():
    files = sorted((REPO / "mvd_tpu_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]
    assert len(files) > 10
    # the multi-process modules, and the helper whose processes run them
    for name in ("distributed.py", "mesh.py", "kernels/ring_attention.py"):
        assert REPO / "mvd_tpu_torch" / name in files, name
    files.append(REPO / "tests" / "_torch_port_world.py")
    # the orbax layout writer chip_smoke.py runs on the card's machine
    files.append(REPO / "tests" / "_torch_port_orbax_writer.py")
    # the evidence-chain tools the port adds beside the JAX package's
    for name in ("tools/procedural.py", "tools/pretrain_vae.py"):
        assert REPO / "mvd_tpu_torch" / name in files, name
    # no JAX, and none of the libraries that read or write orbax checkpoints:
    # the port reads them with its own OCDBT, zarr and zstd readers; no PIL,
    # which the card's machine lacks: the port decodes and writes its own
    # PNGs and JPEGs
    banned = ("jax", "flax", "mvd_tpu", "orbax", "tensorstore", "zstandard", "numcodecs", "PIL")
    for path in files:
        for node in ast.walk(ast.parse(path.read_text(), str(path))):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""] if node.level == 0 else []
            else:
                continue
            for name in names:
                assert name.split(".")[0] not in banned, f"{path}: imports {name}"
