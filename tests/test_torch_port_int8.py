"""The port's int8 attention (K6) and (B, H, S, D) flash entry point (K5)
against the JAX package, on the CPU.

Seeded numpy inputs go to both sides in f32. The JAX side runs its Pallas
kernels in interpret mode; the port's wrappers take their plain versions on
CPU tensors. Bars: the quantizers bit-equal; K6's plain version >= 60 dB
against the interpret kernel on out and lse, >= 30 dB against exact
attention (the JAX package's own bar), its straight-through gradients
>= 50 dB; K5 >= 60 dB on values and gradients. The CUDA kernels are held
against these plain versions on the card (``test_torch_port_cuda.py``,
``chip_smoke.py``).
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port_util import random_params, snr_db
from mvd_tpu.nn import layers as jl
from mvd_tpu_torch.checkpoint import load_jax_params
from mvd_tpu_torch.config import TINY_MODEL, UNetConfig
from mvd_tpu_torch.nn import layers as tl
from mvd_tpu_torch.pipeline.pipeline import build_model

# the modules, not the functions of the same name the packages export
jfa = importlib.import_module("mvd_tpu.kernels.flash_attention")
tfa = importlib.import_module("mvd_tpu_torch.kernels.flash_attention")

BAR_DB = 60.0


def _rand(shape, seed, offset=0.0):
    return (np.random.default_rng(seed).normal(size=shape) + offset).astype(np.float32)


def _exact(q, k, v, heads):
    return tfa.attention_packed_plain(*(torch.from_numpy(t) for t in (q, k, v)), heads)[0].numpy()


# ---------------------------------------------------------------------------
# K6: quantizers, plain version, gradients, routing
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("which", ["rows", "heads", "channels"])
def test_quantizers_bit_equal(which):
    x = _rand((2, 96, 128), seed=7, offset=0.3)
    x[0, :, 64:] = 0.0  # an all-zero head: the 1e-6 floor of the scale
    x[1, 5, :] *= 40.0  # an outlier token
    heads = 2
    if which == "rows":
        want = jfa._quantize_rows(jnp.asarray(x), heads)
        got = tfa.quantize_rows(torch.from_numpy(x), heads)
    elif which == "heads":
        want = jfa._quantize_heads(jnp.asarray(x), heads)
        got = tfa.quantize_heads(torch.from_numpy(x), heads)
    else:
        want = jfa._quantize_channels(jnp.asarray(x))
        got = tfa.quantize_channels(torch.from_numpy(x))
    assert got[0].dtype == torch.int8 and got[1].dtype == torch.float32
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_smooth_k_matches_jax():
    k = _rand((2, 256, 128), seed=8, offset=0.7)
    k4 = jnp.asarray(k).reshape(2, 256, 2, 64)
    want = (k4 - k4.mean(axis=1, keepdims=True)).reshape(2, 256, 128)
    got = tfa.smooth_k(torch.from_numpy(k), 2).numpy()
    np.testing.assert_allclose(got, np.asarray(want), atol=2e-6, rtol=0)


@pytest.mark.parametrize(
    "B,Sq,Sk,heads,D,block_k,k_mean",
    [(1, 256, 256, 2, 64, 128, 0.7), (2, 128, 384, 2, 32, 128, 0.0),
     (1, 128, 1024, 1, 64, 1024, 0.7)],
)
def test_int8_plain_matches_pallas_interpret(B, Sq, Sk, heads, D, block_k, k_mean):
    q = _rand((B, Sq, heads * D), seed=Sq)
    k = _rand((B, Sk, heads * D), seed=Sk + 1, offset=k_mean)
    v = _rand((B, Sk, heads * D), seed=Sk + 2)
    scale = D**-0.5
    want_out, want_lse = jfa._flash_fwd_packed_int8(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), heads, scale, 128, block_k, True
    )
    plain = tfa.flash_attention_packed_int8_fwd.plain_calls
    out, lse = tfa.flash_attention_packed_int8_fwd(
        *(torch.from_numpy(t) for t in (q, k, v)), heads, block_k=block_k
    )
    assert tfa.flash_attention_packed_int8_fwd.plain_calls == plain + 1
    assert out.shape == (B, Sq, heads * D) and lse.shape == (B, Sq, heads)
    assert snr_db(want_out, out.numpy()) >= BAR_DB
    assert snr_db(want_lse, lse.numpy()) >= BAR_DB
    assert snr_db(_exact(q, k, v, heads), out.numpy()) >= 30.0


def test_int8_groups_change_the_numbers():
    """P is quantized per key group: the group is part of the function."""
    q, k, v = (_rand((1, 128, 64), seed=s) for s in (1, 2, 3))
    args = [torch.from_numpy(t) for t in (q, k, v)]
    a = tfa.attention_packed_int8_plain(*args, 1, block_k=128)[0].numpy()
    b = tfa.attention_packed_int8_plain(*args, 1, block_k=64)[0].numpy()
    assert not np.array_equal(a, b)


def test_int8_straight_through_grads():
    B, S, heads, D = 1, 256, 2, 64
    q, k, v, g = (_rand((B, S, heads * D), seed=20 + i) for i in range(4))
    f = lambda q, k, v: jfa.flash_attention_packed_int8(
        q, k, v, heads, block_q=128, block_k=128, interpret=True
    )
    _, vjp = jax.vjp(f, *(jnp.asarray(t) for t in (q, k, v)))
    want = vjp(jnp.asarray(g))
    leaves = [torch.from_numpy(t).requires_grad_() for t in (q, k, v)]
    calls = tfa.flash_attention_packed_bwd_dq.plain_calls
    got = torch.autograd.grad(
        tfa.flash_attention_packed_int8(*leaves, heads, block_k=128), leaves, torch.from_numpy(g)
    )
    assert tfa.flash_attention_packed_bwd_dq.plain_calls == calls + 1
    for w, t in zip(want, got):
        assert snr_db(w, t.numpy()) >= 50.0


# (Sq, Sk, quantized) at every attention site of 512² and 768² generation
ROUTES = [
    (4096, 4096, True), (4096, 77, False), (1024, 1024, True), (1024, 77, False),
    (256, 256, False), (256, 77, False), (64, 64, False), (64, 77, False),
    (9216, 9216, True), (9216, 77, False), (2304, 2304, False), (2304, 77, False),
    (576, 576, False), (576, 77, False), (144, 144, False), (144, 77, False),
]


@pytest.mark.parametrize("Sq,Sk,quantized", ROUTES)
def test_int8_routing_follows_jax_on_tpu(monkeypatch, Sq, Sk, quantized):
    """The JAX package's impl="int8" routing as it runs on a TPU (traced
    only), against the port's ``int8_site`` and the table."""
    seen = []

    def spy(label):
        return lambda q, *args, **kwargs: seen.append(label) or q

    monkeypatch.setattr(jfa.jax, "default_backend", lambda: "tpu")
    monkeypatch.setattr(jfa, "_flash_attention_packed_int8", spy("int8"))
    monkeypatch.setattr(jfa, "flash_attention_packed", spy("exact"))
    shape = lambda s: jax.ShapeDtypeStruct((1, s, 64), jnp.float32)
    jax.eval_shape(lambda q, k, v: jfa.attention_packed(q, k, v, 1, impl="int8"),
                   shape(Sq), shape(Sk), shape(Sk))
    assert (seen == ["int8"]) == quantized == tfa.int8_site(Sq, Sk)


def test_int8_routes_untileable_to_k1():
    q, kv = torch.randn(1, 300, 128), torch.randn(1, 77, 128)
    n8, n1 = tfa.flash_attention_packed_int8_fwd.plain_calls, tfa.flash_attention_packed_fwd.plain_calls
    out = tfa.flash_attention_packed_int8(q, kv, kv, 2)
    assert (tfa.flash_attention_packed_int8_fwd.plain_calls, tfa.flash_attention_packed_fwd.plain_calls) == (n8, n1 + 1)
    torch.testing.assert_close(out, tfa.attention_packed_plain(q, kv, kv, 2)[0])
    with pytest.raises(ValueError, match="whole tiles"):
        tfa.flash_attention_packed_int8_fwd(q, kv, kv, 2)


@pytest.mark.parametrize("impl", ["pallas_interpret", "int8_interpret", "flash"])
def test_config_rejects_what_the_port_does_not_run(impl):
    with pytest.raises(ValueError, match="attention impl"):
        UNetConfig(attention_impl=impl)


def test_model_carries_attention_impl():
    """The model built from a config (as ``MVDPipeline.create`` and the train
    step build it) passes ``attention_impl`` to every attention site, and a
    JAX param tree carries across whatever it is."""
    cfg = TINY_MODEL.__class__(**{**TINY_MODEL.__dict__, "unet": UNetConfig(
        **{**TINY_MODEL.unet.__dict__, "attention_impl": "int8"})})
    unet = build_model(cfg)["mvd"].unet
    sites = [m for m in unet.modules() if isinstance(m, (tl.Attention, tl.CrossViewAdapter))]
    assert sites and all(m.attention_impl == "int8" for m in sites)
    exact = build_model(TINY_MODEL)["mvd"].unet
    assert [n for n, _ in unet.named_parameters()] == [n for n, _ in exact.named_parameters()]


def test_transformer2d_int8_matches_jax_int8_interpret():
    """One Transformer2D with adapters at Sq = Sk = 1024 (a 32² latent),
    where the port's "int8" and the JAX "int8_interpret" quantize the same
    sites (attn1 and both adapters; the text site is exact on both)."""
    x, ctx, ref = _rand((1, 32, 32, 64), 30), _rand((1, 77, 48), 31), _rand((1, 1024, 64), 32)
    jm = jl.Transformer2D(heads=1, head_dim=64, norm_num_groups=8, with_adapters=True,
                          attention_impl="int8_interpret")
    tm = tl.Transformer2D(64, 1, 64, 48, 1, 8, with_adapters=True, attention_impl="int8")
    args = (jnp.asarray(x), jnp.asarray(ctx), jnp.asarray(ref))
    params = random_params(jm.init, *args, seed=3)
    load_jax_params(tm, params)
    want = np.asarray(jax.jit(lambda p, *a: jm.apply(p, *a, jnp.float32(0.7)))(params, *args))
    n8 = tfa.flash_attention_packed_int8_fwd.plain_calls
    nchw = torch.from_numpy(x).permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)
    with torch.no_grad():
        got = tm(nchw, torch.from_numpy(ctx), torch.from_numpy(ref), 0.7)
    assert tfa.flash_attention_packed_int8_fwd.plain_calls == n8 + 3
    got = got.permute(0, 2, 3, 1).numpy()
    assert snr_db(want, got) >= 50.0
    tm_exact = tl.Transformer2D(64, 1, 64, 48, 1, 8, with_adapters=True)
    load_jax_params(tm_exact, params)
    with torch.no_grad():
        exact = tm_exact(nchw, torch.from_numpy(ctx), torch.from_numpy(ref), 0.7)
    assert snr_db(exact.permute(0, 2, 3, 1).numpy(), got) >= 30.0


# ---------------------------------------------------------------------------
# K6 on the card: its key order, K6q's plain version, the exact conversions
# ---------------------------------------------------------------------------


def _int8_operands(B, S, heads, seed):
    """bf16-valued q, k, v (B, S, heads * 64) with a K mean of 0.7, values
    that divide to ties, and rows, heads and channels of zeros that hit the
    1e-6 floor of the scales."""
    q, k, v = (_rand((B, S, heads * 64), seed=seed + i) for i in range(3))
    k += 0.7
    q[0, 3] = 0.0  # a zero token: every head's scale at the floor
    # amax 127, so the scale rounds to 1 and q / scale = +-(i + 0.5): ties
    q[0, 4, :64] = np.where(np.arange(64) % 2, 1, -1) * (np.arange(64) % 8 + 0.5)
    q[0, 4, 0] = 127.0
    k[-1, :, 64:128] = 0.25  # a constant head: k - mean = 0, its scale at the floor
    v[:, :, 7] = 0.0  # a zero channel
    v[0, :, 9] = np.where(np.arange(S) % 2, 127.0, 0.5)  # sv rounds to 1, v / sv = 0.5: a tie
    return [torch.from_numpy(t).bfloat16().float() for t in (q, k, v)]


def test_k6_key_order_is_a_permutation_of_each_16_key_block():
    assert sorted(tfa.K6_KEY_ORDER) == list(range(16))
    # position 4t + i holds key 8 (i // 2) + 2t + i % 2: accumulator keys
    # 2t, 2t+1 and 8+2t, 9+2t of thread t, in its byte lanes 0-3
    assert tfa.K6_KEY_ORDER[:8] == (0, 1, 8, 9, 2, 3, 10, 11)
    v8 = torch.from_numpy(np.random.default_rng(1).integers(-127, 128, (2, 64, 96), dtype=np.int8))
    v8t = tfa.v8_to_key_order(v8)
    assert v8t.shape == (2, 96, 64) and v8t.is_contiguous()
    assert torch.equal(v8t[:, :, 16 + 4], v8[:, 16 + 2])
    assert torch.equal(tfa.v8_from_key_order(v8t), v8)


@pytest.mark.parametrize("block_k", [64, 128, 1024])
def test_int8_plain_core_is_bitwise_the_same_on_permuted_keys(block_k):
    """The plain core on K8 and V8 with the keys of every 16-key block in
    K6's order gives bitwise the (out, lse) it gives in the keys' own order:
    its integer products are exact f32 sums, whatever their order."""
    B, S, heads = 1, 256, 2
    q, k, v = _int8_operands(B, S, heads, seed=60)
    q8, k8, v8t, sq, sk, sv = tfa.quantize_int8_plain(q, k, v, heads)
    v8 = tfa.v8_from_key_order(v8t)
    idx = tfa._key_order_index(S, "cpu")
    args = (sq, sk, sv, heads, 0.125, block_k, torch.float32)
    out, lse = tfa._int8_core(q8, k8, v8, *args)
    out_p, lse_p = tfa._int8_core(q8, k8[:, idx], v8[:, idx], *args)
    assert torch.equal(out, out_p) and torch.equal(lse, lse_p)
    # and the core on K6's operand layout is the same function
    core = tfa.attention_int8_core_plain((q8, k8, v8t, sq, sk, sv), heads, 0.125, block_k, torch.float32)
    assert torch.equal(core[0], out) and torch.equal(core[1], lse)


@pytest.mark.parametrize("B,S,heads", [(2, 256, 5), (2, 128, 10)])
def test_k6q_plain_is_bitwise_the_eager_quantizers(B, S, heads):
    """K6q's plain version, through its wrapper on CPU tensors (V8 in K6's
    key order, sk (B, H), sv (B, H*D)), against ``_quantize_int8``, the
    eager quantizers bit-equal to the JAX package's, at the int8 sites' head
    counts: every output bitwise; the 1e-6 floor and ties included."""
    q, k, v = _int8_operands(B, S, heads, seed=61)
    calls = tfa.quantize_int8.plain_calls
    q8, k8, v8t, sq, sk, sv = tfa.quantize_int8(q, k, v, heads)
    assert tfa.quantize_int8.plain_calls == calls + 1
    (wq8, wsq), (wk8, wsk), (wv8, wsv) = tfa._quantize_int8(q, k, v, heads)
    assert sk.shape == (B, heads) and sv.shape == (B, heads * 64) and v8t.shape == (B, heads * 64, S)
    for got, want in ((q8, wq8), (sq, wsq), (k8, wk8), (sk, wsk.reshape(B, heads)),
                      (tfa.v8_from_key_order(v8t), wv8), (sv, wsv.reshape(B, -1))):
        assert got.dtype == want.dtype and torch.equal(got, want)
    assert (sq[0, 3] == np.float32(1e-6) * np.float32(1 / 127)).all()  # the floor was hit
    assert (sk[-1, 1] == np.float32(1e-6) * np.float32(1 / 127)) and (k8[-1, :, 64:128] == 0).all()
    assert (sv[0, 9] == 1.0) and (tfa.v8_from_key_order(v8t)[0, ::2, 9] == 0).all()  # half to even


@pytest.mark.parametrize("offset,spread", [(0.0, 1.0), (0.7, 1.0), (-3.0, 0.01), (100.0, 30.0)])
def test_smoothed_k_amax_from_max_and_min_is_exact(offset, spread):
    """max_s |k - mean| == max(max k - mean, mean - min k) bitwise in f32:
    subtracting a constant is monotone under rounding, and |a - b| rounds
    as a - b does."""
    k = torch.from_numpy(_rand((3, 500, 320), seed=62) * spread + offset)
    mean = k.mean(dim=1, keepdim=True)
    direct = (k - mean).abs().amax(dim=1)
    via = torch.maximum(k.amax(dim=1) - mean[:, 0], mean[:, 0] - k.amin(dim=1))
    assert torch.equal(direct, via)


def test_magic_number_s32_to_f32_is_exact_for_every_score():
    """K6's s32 -> f32 conversion, __int_as_float(s + 0x4B400000) - 1.5 * 2^23,
    equals float32(s) for every |s| <= 127^2 * 64, the largest int8 score."""
    s = np.arange(-127**2 * 64, 127**2 * 64 + 1, dtype=np.int32)
    f = (s + np.int32(0x4B400000)).view(np.float32) - np.float32(12582912.0)
    np.testing.assert_array_equal(f, s.astype(np.float32))


def test_int8_bounds_at_the_hot_site():
    """K6 at B4 S4096² H5: 8.59e10 int8 operations (0.0434 ms at 1,979
    TOP/s) under 3.36e8 exponentials (0.0802 ms at 16 a clock on 132 SMs at
    1,980 MHz); K6q moves 47.5 MB (0.0142 ms)."""
    from mvd_tpu_torch.kernels.measure import int8_bounds, k6q_bounds

    b = int8_bounds(4, 4096, 4096, 5, 1.98e9)
    assert abs(b["ops_ms"] - 8.59e10 / 1.979e15 * 1e3) < 1e-4
    assert abs(b["exp_ms"] - 0.0802) < 1e-4 and b["bound_ms"] == b["exp_ms"]
    assert b["bound_by"] == "operations" and b["bytes_ms"] < b["ops_ms"]
    q = k6q_bounds(4, 4096, 4096, 5)
    assert abs(q["bytes_ms"] - 47.52e6 / 3.35e12 * 1e3) < 1e-4 and q["bound_by"] == "bytes"
    assert abs(q["two_read_ms"] - 68.49e6 / 3.35e12 * 1e3) < 1e-4


# ---------------------------------------------------------------------------
# K5: (B, H, S, D)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize(
    "B,H,Sq,Sk,D", [(2, 2, 200, 77, 64), (1, 3, 130, 300, 32), (1, 1, 64, 64, 64)]
)
def test_k5_matches_pallas_interpret(B, H, Sq, Sk, D):
    q, k, v, g = (_rand(s, seed=40 + i) for i, s in enumerate(
        [(B, H, Sq, D), (B, H, Sk, D), (B, H, Sk, D), (B, H, Sq, D)]))
    f = lambda q, k, v: jfa.flash_attention(q, k, v, block_q=128, block_k=128, interpret=True)
    want, vjp = jax.vjp(f, *(jnp.asarray(t) for t in (q, k, v)))
    want_grads = vjp(jnp.asarray(g))
    leaves = [torch.from_numpy(t).requires_grad_() for t in (q, k, v)]
    calls = (tfa.flash_attention_fwd.plain_calls, tfa.flash_attention_packed_bwd_dq.plain_calls,
             tfa.flash_attention_packed_bwd_dkv.plain_calls)
    out = tfa.flash_attention(*leaves)
    grads = torch.autograd.grad(out, leaves, torch.from_numpy(g))
    assert (tfa.flash_attention_fwd.plain_calls, tfa.flash_attention_packed_bwd_dq.plain_calls,
            tfa.flash_attention_packed_bwd_dkv.plain_calls) == tuple(c + 1 for c in calls)
    assert tfa.flash_attention_fwd.launches == 0
    assert snr_db(want, out.detach().numpy()) >= BAR_DB
    for w, t in zip(want_grads, grads):
        assert snr_db(w, t.numpy()) >= BAR_DB
    lse = tfa.flash_attention_fwd(*(torch.from_numpy(t) for t in (q, k, v)))[1]
    want_lse = jfa._flash_fwd(*(jnp.asarray(t) for t in (q, k, v)), D**-0.5, Sq, Sk, Sk, True)[1]
    assert snr_db(np.asarray(want_lse).reshape(B, H, Sq), lse.numpy()) >= BAR_DB


@pytest.mark.parametrize("impl", ["auto", "pallas", "xla"])
def test_attention_entry_matches_jax(impl):
    q, k, v = (_rand((2, 2, 96, 32), seed=50 + i) for i in range(3))
    jimpl = "pallas_interpret" if impl == "pallas" else impl
    want = jfa.attention(*(jnp.asarray(t) for t in (q, k, v)), impl=jimpl)
    got = tfa.attention(*(torch.from_numpy(t) for t in (q, k, v)), impl)
    assert snr_db(want, got.numpy()) >= BAR_DB
    want_xla = jfa.xla_attention(*(jnp.asarray(t) for t in (q, k, v)))
    got_xla = tfa.xla_attention(*(torch.from_numpy(t) for t in (q, k, v)))
    assert snr_db(want_xla, got_xla.numpy()) >= BAR_DB
