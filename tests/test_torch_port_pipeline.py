"""The port's pipeline against ``mvd_tpu.pipeline.MVDPipeline`` at TINY_MODEL.

Both pipelines hold the same weights (a flax tree made from a numpy seed and
carried across by ``checkpoint/from_jax.py``) and draw the same noise: the
test replays the JAX pipeline's key splits (initial latents, VAE sample
noise, one DDPM noise per step) and hands the draws to the port. Bars:
>= 50 dB on the images after 3 DDPM steps (error compounds across steps),
>= 60 dB for one denoise step and for the schedule. TINY_MODEL is cut in
depth (``cut_config``, widths kept) so the JAX compile stays short.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port_util import cut_config, random_params, snr_db
from mvd_tpu.camera import orbit_cameras
from mvd_tpu.config import TINY_MODEL as J_TINY
from mvd_tpu.diffusion import ddpm_step as j_ddpm_step
from mvd_tpu.diffusion import inference_timesteps as j_inference_timesteps
from mvd_tpu.nn import AutoencoderKL as JVAE
from mvd_tpu.nn import CLIPTextEncoder as JCLIP
from mvd_tpu.nn import MultiViewUNet as JMVD
from mvd_tpu.pipeline import MVDPipeline as JPipeline
from mvd_tpu.pipeline import build_schedule as j_build_schedule
from mvd_tpu_torch.checkpoint import load_jax_params
from mvd_tpu_torch.cli import infer
from mvd_tpu_torch.config import TINY_MODEL
from mvd_tpu_torch.diffusion import ddpm_step, inference_timesteps
from mvd_tpu_torch.nn import MultiViewUNet
from mvd_tpu_torch.pipeline import MVDPipeline, build_schedule

B, STEPS, SEED = 2, 3, 5
LAT = J_TINY.unet.sample_size
HW = LAT * 8


J_CFG, T_CFG = cut_config(J_TINY), cut_config(TINY_MODEL)


@pytest.fixture(scope="module")
def pipes():
    """Both pipelines with the same random weights, and the flax tree."""
    z = jnp.zeros((1, LAT, LAT, 4))
    ctx = jnp.zeros((1, 77, J_CFG.unet.cross_attention_dim))
    cam = jnp.eye(4)[None]
    params = {
        "mvd": random_params(
            JMVD(J_CFG).init, z, jnp.zeros((), jnp.int32), ctx,
            source_camera=cam, target_camera=cam, source_image_latents=z, seed=1,
        ),
        "vae": random_params(JVAE(J_CFG.vae).init, jnp.zeros((1, 16, 16, 3)), seed=2),
        "text_encoder": random_params(
            JCLIP(J_CFG.text_encoder).init, jnp.zeros((1, 77), jnp.int32), seed=3
        ),
    }
    jpipe = JPipeline(J_CFG, jax.tree.map(jnp.asarray, params))
    tpipe = MVDPipeline.create(T_CFG, seed=0, device="cpu")
    tpipe.load_jax_params(params)
    return jpipe, tpipe, params


def _inputs():
    cams = orbit_cameras(B)
    src = np.random.default_rng(0).uniform(0, 1, (1, HW, HW, 3)).astype(np.float32)
    return dict(
        source_camera=np.tile(cams[:1], (B, 1, 1)), target_camera=cams,
        source_images=src, ref_scale=1.0,
    )


def _jax_draws(seed, steps):
    """The JAX pipeline's draws, from its own key splits
    (mvd_tpu/pipeline/pipeline.py: latents, source encode, one per step)."""
    shape = (B, LAT, LAT, 4)
    rng, lat_rng = jax.random.split(jax.random.PRNGKey(seed))
    latents = jax.random.normal(lat_rng, shape, jnp.float32)
    rng, enc_rng = jax.random.split(rng)
    vae_noise = jax.random.normal(enc_rng, shape, jnp.float32)
    step_noises = []
    for _ in range(steps):
        rng, step_rng = jax.random.split(rng)
        step_noises.append(jax.random.normal(step_rng, shape, jnp.float32))
    return np.array(latents), np.array(vae_noise), np.stack(step_noises)


def test_pipeline_matches_jax(pipes):
    jpipe, tpipe, _ = pipes
    kw = dict(num_inference_steps=STEPS, guidance_scale=1.0, **_inputs())
    want = jpipe(["a chair"] * B, seed=SEED, **kw)["images"]
    latents, vae_noise, step_noises = _jax_draws(SEED, STEPS)
    got = tpipe(
        ["a chair"] * B, seed=SEED, latents=latents, vae_noise=vae_noise,
        step_noises=step_noises, **kw,
    )["images"]
    assert got.shape == (B, HW, HW, 3) and np.isfinite(got).all()
    assert snr_db(want, got) >= 50.0


def test_denoise_step_matches_jax(pipes):
    """Conditioning (camera FiLM, feature pass, adapter K/V), one UNet
    denoise with adapters and FiLM, and one DDPM step."""
    jcfg, tcfg = J_CFG, T_CFG
    rng = np.random.default_rng(1)
    text = rng.normal(size=(B, 77, jcfg.unet.cross_attention_dim)).astype(np.float32)
    src_lat, lat = (rng.normal(size=(B, LAT, LAT, 4)).astype(np.float32) for _ in range(2))
    inp = _inputs()
    cams = [np.asarray(inp["source_camera"], np.float32), np.asarray(inp["target_camera"], np.float32)]
    jm = JMVD(jcfg)
    p = pipes[2]["mvd"]
    schedule = j_build_schedule(jcfg)
    t = int(j_inference_timesteps(schedule, 20)[3])

    # jitted: one compile costs less than eager JAX's per-op compiles
    prepare = jax.jit(lambda p, *a: jm.apply(
        p, *a, cfg_batch=B, precompute_kv=True, method=jm.prepare_conditioning))
    film, refs = prepare(p, jnp.asarray(text), *map(jnp.asarray, cams), jnp.asarray(src_lat))
    denoise = jax.jit(lambda p, *a: jm.apply(p, *a, method=jm.denoise))
    pred = denoise(p, jnp.asarray(lat), jnp.int32(t), jnp.asarray(text), film, refs, jnp.float32(0.7))
    # the JAX step draws its noise from a key; the port takes that draw
    key = jax.random.PRNGKey(7)
    want = j_ddpm_step(schedule, pred, jnp.int32(t), jnp.asarray(lat), key, 20)
    noise = torch.from_numpy(np.array(jax.random.normal(key, lat.shape, jnp.float32)))

    tm = MultiViewUNet(tcfg)
    load_jax_params(tm, p)
    with torch.no_grad():
        tfilm, trefs = tm.prepare_conditioning(
            torch.from_numpy(text), *map(torch.from_numpy, cams), torch.from_numpy(src_lat),
            cfg_batch=B, precompute_kv=True,
        )
        tpred = tm.denoise(torch.from_numpy(lat), torch.tensor(t), torch.from_numpy(text),
                           tfilm, trefs, 0.7)
    got = ddpm_step(build_schedule(tcfg), tpred, t, torch.from_numpy(lat), noise, 20)
    assert snr_db(pred, tpred.numpy()) >= 60.0
    assert snr_db(want, got.numpy()) >= 60.0


def test_schedule_matches_jax():
    js, ts = j_build_schedule(J_TINY), build_schedule(TINY_MODEL)
    assert snr_db(js.alphas_cumprod, ts.alphas_cumprod.numpy()) >= 60.0
    assert snr_db(js.betas, ts.betas.numpy()) >= 60.0
    for steps in (3, 20, 50):
        np.testing.assert_array_equal(j_inference_timesteps(js, steps), inference_timesteps(ts, steps))
    lat = np.random.default_rng(2).normal(size=(2, 4, 4, 4)).astype(np.float32)
    pred = np.random.default_rng(3).normal(size=lat.shape).astype(np.float32)
    key = jax.random.PRNGKey(3)
    noise = torch.from_numpy(np.array(jax.random.normal(key, lat.shape, jnp.float32)))
    for t in (981, 1, 0):
        want = j_ddpm_step(js, jnp.asarray(pred), jnp.int32(t), jnp.asarray(lat), key, 20)
        got = ddpm_step(ts, torch.from_numpy(pred), t, torch.from_numpy(lat), noise, 20)
        assert snr_db(want, got.numpy()) >= 60.0, t


def test_cfg_puts_unconditional_text_first(pipes, monkeypatch):
    _, tpipe, _ = pipes
    model = tpipe.compute_model
    seen = {}
    real = model["mvd"].prepare_conditioning

    def spy(embeds, *args, **kwargs):
        seen["embeds"] = embeds
        return real(embeds, *args, **kwargs)

    monkeypatch.setattr(model["mvd"], "prepare_conditioning", spy)
    tpipe(["a chair"] * B, num_inference_steps=1, guidance_scale=3.0,
          negative_prompt="blurry", **_inputs())
    with torch.no_grad():
        uncond = model["text_encoder"](torch.as_tensor(tpipe.tokenizer(["blurry"] * B)))
        cond = model["text_encoder"](torch.as_tensor(tpipe.tokenizer(["a chair"] * B)))
    torch.testing.assert_close(seen["embeds"], torch.cat([uncond, cond]))


def test_entry_points_raise_without_cuda(tmp_path):
    """The GPU is the default; without one the entry points raise instead of
    continuing on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the CUDA default is valid here")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        MVDPipeline.create(TINY_MODEL, seed=0)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        infer.main(["--tiny", "--num-images", "1", "--num-steps", "1",
                    "--output-dir", str(tmp_path)])
    assert not any(tmp_path.iterdir())


def test_cli_rejects_tiny_on_gpu(tmp_path, monkeypatch):
    """TINY_MODEL's f32, 16-wide heads are not what the GPU kernels take, so
    ``--tiny`` on the GPU stops with a message before it builds anything."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    with pytest.raises(ValueError, match="--device cpu"):
        infer.main(["--tiny", "--num-images", "1", "--output-dir", str(tmp_path)])
    assert not any(tmp_path.iterdir())


def test_cli_runs_on_cpu_when_asked(tmp_path):
    infer.main(["--tiny", "--num-images", "1", "--num-steps", "2", "--device", "cpu",
                "--output-dir", str(tmp_path)])
    names = sorted(p.name for p in tmp_path.iterdir())
    assert names == ["comparison_00.png", "generated_00.png", "source.png"]
