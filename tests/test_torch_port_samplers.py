"""The port's samplers, DDIM inversion, encoder reuse and ray maps against
the JAX package at TINY_MODEL (cut in depth), on the CPU in f32.

Bars: >= 60 dB for the step functions (DDIM at eta 0 and 0.5 with the same
noise, the inversion step, a 3-step DPM-Solver++(2M) chain, eps-hat for
all three prediction types), the ray-map functions and one ray-conditioned
denoise; >= 50 dB on the images of whole pipelines over 3 steps
(DPM-Solver++, DDIM from ``invert``'s latents, DDPM with encoder reuse 2,
the JAX pipeline's draws replayed), and on ``invert``'s latents. A
ray-conditioned pipeline whose conv_in is zero-padded gives the unpadded
model's images to 1e-6. The pipelines and the JAX draws are those of
``test_torch_port_pipeline.py``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port_util import random_params, snr_db
from mvd_tpu import camera as jcam
from mvd_tpu.config import TINY_MODEL as J_TINY
from mvd_tpu.diffusion import schedules as jsched
from mvd_tpu.nn import MultiViewUNet as JMVD
from mvd_tpu.pipeline import build_schedule as j_build_schedule
from mvd_tpu_torch import camera as tcam
from mvd_tpu_torch.checkpoint import load_jax_params, zero_pad_conv_in
from mvd_tpu_torch.config import TINY_MODEL
from mvd_tpu_torch.diffusion import schedules as tsched
from mvd_tpu_torch.nn import MultiViewUNet
from mvd_tpu_torch.pipeline import MVDPipeline, build_schedule
from test_torch_port_pipeline import B, HW, J_CFG, LAT, SEED, STEPS, T_CFG, _inputs, _jax_draws, pipes  # noqa: F401

PROMPTS = ["a chair"] * B
T = torch.from_numpy


def _schedules(prediction_type):
    js = dataclasses.replace(j_build_schedule(J_TINY), prediction_type=prediction_type)
    return js, dataclasses.replace(build_schedule(TINY_MODEL), prediction_type=prediction_type)


@pytest.mark.parametrize("prediction_type", ["epsilon", "v_prediction", "sample"])
def test_step_functions_match_jax(prediction_type):
    js, ts = _schedules(prediction_type)
    rng = np.random.default_rng(7)
    lat, pred = (rng.normal(size=(2, 4, 4, 4)).astype(np.float32) for _ in range(2))
    key = jax.random.PRNGKey(9)
    noise = np.array(jax.random.normal(key, lat.shape, jnp.float32))
    J = lambda a: jnp.asarray(a)
    for t in (981, 501, 1):
        want = jsched.pred_epsilon(js, J(pred), J(lat), jnp.int32(t))
        assert snr_db(want, tsched.pred_epsilon(ts, T(pred), T(lat), t).numpy()) >= 60.0, t
        for eta in (0.0, 0.5):
            want = jsched.ddim_step(js, J(pred), jnp.int32(t), J(lat), 20, eta, key)
            got = tsched.ddim_step(ts, T(pred), t, T(lat), 20, eta, T(noise))
            assert snr_db(want, got.numpy()) >= 60.0, (t, eta)
    for t in (1, 501, 951):
        want = jsched.ddim_inverse_step(js, J(pred), jnp.int32(t), J(lat), 20)
        got = tsched.ddim_inverse_step(ts, T(pred), t, T(lat), 20)
        assert snr_db(want, got.numpy()) >= 60.0, t
    # three steps: first order (no history), second order, first order to the clean end
    jstate, tstate = jsched.dpmpp_2m_init(J(lat)), tsched.dpmpp_2m_init(T(lat))
    jlat, tlat = J(lat), T(lat)
    for i, t in enumerate(jsched.inference_timesteps(js, 3).tolist()):
        step_pred = rng.normal(size=lat.shape).astype(np.float32)
        jlat, jstate = jsched.dpmpp_2m_step(js, J(step_pred), jnp.int32(t), jlat, jstate, 3)
        tlat, tstate = tsched.dpmpp_2m_step(ts, T(step_pred), t, tlat, tstate, 3)
        assert snr_db(jlat, tlat.numpy()) >= 60.0, i
    assert tsched.SAMPLERS == jsched.SAMPLERS


def test_ray_functions_match_jax():
    cams = jcam.orbit_cameras(3)
    src = np.tile(cams[:1], (3, 1, 1))
    for h, w, fov in ((6, 8, 60.0), (8, 8, 54.43)):
        assert snr_db(jcam.ray_grid(h, w, fov), tcam.ray_grid(h, w, fov).numpy()) >= 60.0
        want = jcam.plucker_ray_map(jnp.asarray(src), jnp.asarray(cams), h, w, fov)
        got = tcam.plucker_ray_map(T(src), T(cams), h, w, fov)
        assert got.shape == (3, h, w, 6) and snr_db(want, got.numpy()) >= 60.0
        want = jcam.plucker_ray_map(jnp.asarray(cams[:, :3]), jnp.asarray(src[:, :3]), h, w, fov)
        assert snr_db(want, tcam.plucker_ray_map(T(cams[:, :3]), T(src[:, :3]), h, w, fov).numpy()) >= 60.0
    K = np.array([[[7.0, 0, 4.1], [0, 6.5, 2.9], [0, 0, 1]], [[9.0, 0, 3.0], [0, 9.0, 3.5], [0, 0, 1]]],
                 np.float32)
    want = jcam.ray_grid_from_intrinsics(jnp.asarray(K), 6, 8)
    assert snr_db(want, tcam.ray_grid_from_intrinsics(T(K), 6, 8).numpy()) >= 60.0


def test_ray_conditioned_denoise_matches_jax():
    """prepare_conditioning (ray map in the FiLM dict, canonical rays in the
    feature pass) and one denoise of a ray-conditioned model whose conv_in
    ray rows are nonzero, at a cfg batch of twice the cameras."""
    jcfg = dataclasses.replace(J_CFG, use_ray_conditioning=True)
    tcfg = dataclasses.replace(T_CFG, use_ray_conditioning=True)
    z = jnp.zeros((1, LAT, LAT, 4))
    cam = jnp.eye(4)[None]
    jm = JMVD(jcfg)
    params = random_params(jm.init, z, jnp.zeros((), jnp.int32), jnp.zeros((1, 77, jcfg.unet.cross_attention_dim)),
                           source_camera=cam, target_camera=cam, source_image_latents=z, seed=13)
    assert params["params"]["unet"]["conv_in"]["kernel"].shape[2] == 10
    rng = np.random.default_rng(2)
    text = rng.normal(size=(2 * B, 77, jcfg.unet.cross_attention_dim)).astype(np.float32)
    src_lat, lat = (rng.normal(size=(B, LAT, LAT, 4)).astype(np.float32) for _ in range(2))
    inp = _inputs()
    cams = [np.asarray(inp["source_camera"], np.float32), np.asarray(inp["target_camera"], np.float32)]
    t = 501

    def run(p, *a):
        film, refs = jm.apply(p, a[0], a[1], a[2], a[3], cfg_batch=2 * B, precompute_kv=True,
                              method=jm.prepare_conditioning)
        return jm.apply(p, a[4], jnp.int32(t), a[0], film, refs, jnp.float32(0.7), method=jm.denoise)

    want = jax.jit(run)(params, jnp.asarray(text), *map(jnp.asarray, cams), jnp.asarray(src_lat),
                        jnp.asarray(np.concatenate([lat, lat])))
    tm = MultiViewUNet(tcfg)
    load_jax_params(tm, params)
    with torch.no_grad():
        film, refs = tm.prepare_conditioning(T(text), *map(T, cams), T(src_lat), cfg_batch=2 * B,
                                             precompute_kv=True)
        got = tm.denoise(T(np.concatenate([lat, lat])), torch.tensor(t), T(text), film, refs, 0.7)
    assert film["ray_map"].shape == (2 * B, LAT, LAT, 6)
    assert snr_db(want, got.numpy()) >= 60.0


def _call_both(pipes, steps_noise=True, **kw):
    jpipe, tpipe, _ = pipes
    kw = dict(num_inference_steps=STEPS, guidance_scale=1.0, **_inputs(), **kw)
    want = jpipe(PROMPTS, seed=SEED, **kw)["images"]
    latents, vae_noise, step_noises = _jax_draws(SEED, STEPS)
    got = tpipe(PROMPTS, seed=SEED, latents=latents, vae_noise=vae_noise,
                step_noises=step_noises if steps_noise else None, **kw)["images"]
    assert got.shape == (B, HW, HW, 3) and np.isfinite(got).all()
    return want, got


def test_dpm_solver_pipeline_matches_jax(pipes):
    want, got = _call_both(pipes, steps_noise=False, sampler="dpmpp_2m")
    assert snr_db(want, got) >= 50.0


def test_encoder_reuse_pipeline_matches_jax(pipes):
    """DDPM with encoder_reuse 2 over 3 steps: one group (a key step and a
    cached one) and one step past it, the step noises of the JAX key splits,
    which split once per step in both kinds of step."""
    want, got = _call_both(pipes, encoder_reuse=2)
    assert snr_db(want, got) >= 50.0
    latents, vae_noise, step_noises = _jax_draws(SEED, STEPS)
    exact = pipes[1](PROMPTS, seed=SEED, num_inference_steps=STEPS, guidance_scale=1.0, latents=latents,
                     vae_noise=vae_noise, step_noises=step_noises, **_inputs())["images"]
    assert not np.array_equal(exact, got)  # the cached step did take the cache


def test_inversion_then_ddim_matches_jax(pipes):
    jpipe, tpipe, _ = pipes
    inp = _inputs()
    images = np.random.default_rng(8).uniform(0, 1, (B, HW, HW, 3)).astype(np.float32)
    kw = dict(num_inference_steps=STEPS, source_camera=inp["target_camera"],
              target_camera=inp["target_camera"], source_images=inp["source_images"], ref_scale=1.0)
    want = jpipe.invert(images, "a chair", **kw)["latents"]
    got = tpipe.invert(images, "a chair", **kw)["latents"]
    assert got.shape == (B, LAT, LAT, 4) and snr_db(want, got) >= 50.0
    kw = dict(num_inference_steps=STEPS, guidance_scale=1.0, sampler="ddim", **_inputs())
    want_img = jpipe(PROMPTS, seed=SEED, latents=want, **kw)["images"]
    got_img = tpipe(PROMPTS, seed=SEED, latents=got, vae_noise=_jax_draws(SEED, STEPS)[1], **kw)["images"]
    assert snr_db(want_img, got_img) >= 50.0


def test_zero_padded_ray_model_gives_the_unpadded_images(pipes):
    _, tpipe, params = pipes
    cfg = dataclasses.replace(T_CFG, use_ray_conditioning=True)
    ray = MVDPipeline.create(cfg, seed=0, device="cpu")
    mvd = dict(params["mvd"]["params"])
    mvd["unet"] = zero_pad_conv_in(mvd["unet"])
    ray.load_jax_params({**params, "mvd": {"params": mvd}})
    assert ray.model["mvd"].unet.conv_in.weight.shape[1] == 10
    latents, vae_noise, step_noises = _jax_draws(SEED, STEPS)
    kw = dict(num_inference_steps=STEPS, guidance_scale=1.0, latents=latents, vae_noise=vae_noise,
              step_noises=step_noises, **_inputs())
    want = tpipe(PROMPTS, seed=SEED, **kw)["images"]
    got = ray(PROMPTS, seed=SEED, **kw)["images"]
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def test_pipeline_rejects_unknown_sampler_and_reuse(pipes):
    tpipe = pipes[1]
    with pytest.raises(ValueError, match="unknown sampler"):
        tpipe(PROMPTS, num_inference_steps=1, sampler="euler")
    with pytest.raises(ValueError, match="encoder_reuse"):
        tpipe(PROMPTS, num_inference_steps=1, encoder_reuse=0)


def test_encode_and_decode_helpers_match_jax(pipes):
    """encode_text, vae_encode (the posterior's mean) and vae_decode, which
    the entry points beside the sampler call."""
    jpipe, tpipe, _ = pipes
    images = np.random.default_rng(3).uniform(-1, 1, (B, HW, HW, 3)).astype(np.float32)
    # jitted: one compile costs less than eager JAX's per-op compiles
    want = jax.jit(lambda x: jpipe.vae_encode(x, None, sample=False))(jnp.asarray(images))
    got = tpipe.vae_encode(images)
    assert got.shape == (B, LAT, LAT, 4) and snr_db(want, got.numpy()) >= 60.0
    assert snr_db(jax.jit(jpipe.vae_decode)(want), tpipe.vae_decode(got).numpy()) >= 60.0
    ids = jnp.asarray(jpipe.tokenizer(PROMPTS))
    want = jax.jit(lambda i: jpipe.text_encoder.apply(jpipe.params["text_encoder"], i))(ids)
    assert snr_db(want, tpipe.encode_text(PROMPTS).numpy()) >= 60.0
