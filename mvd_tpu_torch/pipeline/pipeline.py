"""MVD generation pipeline: text + source view + cameras -> multi-view images.

Counterpart of ``mvd_tpu/pipeline/pipeline.py`` (DDPM, guidance on or off):

  * CLIP text encode, CFG concat (unconditional first);
  * VAE encode of the unique source images, moments tiled to the batch;
  * step-invariant conditioning (camera FiLM, frozen feature pass, adapter
    K/V) computed once;
  * the denoise loop, a Python loop of ``denoise`` + ``ddpm_step``;
  * VAE decode, then (x/2 + 0.5) clamped to [0, 1].

Runs on the GPU unless the caller passes ``device="cpu"``; without a GPU the
default raises rather than falling back. Random numbers come from a
``torch.Generator`` seeded with ``seed``, unless the caller hands in the
initial latents, the VAE sample noise and the per-step DDPM noise.
"""

from __future__ import annotations

import copy
import math
from typing import List, Mapping, Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.nn as nn

from ..checkpoint.from_jax import load_jax_params
from ..config import ModelConfig
from ..data.tokenizer import load_tokenizer
from ..diffusion.schedules import (
    NoiseSchedule,
    ddpm_step,
    inference_timesteps,
    make_shifted_schedule,
)
from ..nn.adapter_init import init_adapters_from_frozen
from ..nn.clip_text import CLIPTextEncoder
from ..nn.layers import LayerNorm, StreamingLayerNorm, GroupNorm
from ..nn.mvd_unet import MultiViewUNet
from ..nn.vae import AutoencoderKL

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def resolve_device(device: Union[str, torch.device]) -> torch.device:
    """The device to run on; a CUDA device without a GPU raises."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available: the port runs on the GPU; pass device='cpu' "
            "explicitly to run its plain CPU path"
        )
    return device


def build_schedule(cfg: ModelConfig) -> NoiseSchedule:
    s = cfg.scheduler
    base = NoiseSchedule.create(
        num_train_timesteps=s.num_train_timesteps,
        beta_schedule=s.beta_schedule,
        beta_start=s.beta_start,
        beta_end=s.beta_end,
        prediction_type=s.prediction_type,
        steps_offset=s.steps_offset,
        timestep_spacing=s.timestep_spacing,
    )
    if s.shift_mode and s.shift_mode != "none":
        return make_shifted_schedule(base, s.shift_scale, s.shift_mode)
    return base


def build_model(cfg: ModelConfig) -> nn.ModuleDict:
    """The three networks, named as the JAX pipeline's param tree."""
    return nn.ModuleDict({
        "mvd": MultiViewUNet(cfg),
        "vae": AutoencoderKL(cfg.vae),
        "text_encoder": CLIPTextEncoder(cfg.text_encoder),
    })


@torch.no_grad()
def init_weights(model: nn.Module, generator: torch.Generator) -> None:
    """Random init from ``generator``, following the flax initializers'
    scales: weights N(0, 1/fan_in), biases 0, norm scales 1; FiLM output
    layers N(0, 0.02) with bias 0.5 on the scale half; the translation
    projection N(0, 1/fan_in); the position embedding N(0, 0.01)."""
    norms = (LayerNorm, StreamingLayerNorm, GroupNorm)

    def normal_(p, std):
        p.copy_(torch.randn(p.shape, generator=generator, device=p.device) * std)

    for mod_name, mod in model.named_modules():
        if isinstance(mod, norms):
            mod.weight.fill_(1.0)
            mod.bias.zero_()
        elif isinstance(mod, (nn.Linear, nn.Conv2d)):
            if mod_name.rsplit(".", 1)[-1].startswith("mod_") and mod_name.endswith("_dense_1"):
                normal_(mod.weight, 0.02)
                half = mod.bias.shape[0] // 2
                mod.bias.zero_()
                mod.bias[:half] = 0.5
                continue
            normal_(mod.weight, 1.0 / math.sqrt(mod.weight[0].numel()))
            if mod.bias is not None:
                mod.bias.zero_()
        elif isinstance(mod, nn.Embedding):
            normal_(mod.weight, 1.0 / math.sqrt(mod.weight.shape[1]))
    for name, p in model.named_parameters():
        if name.endswith("translation_projection"):
            normal_(p, 1.0 / math.sqrt(p.shape[0]))
        elif name.endswith("position_embedding"):
            normal_(p, 0.01)


def cast_for_compute(model: nn.Module, dtype: torch.dtype) -> nn.Module:
    """A copy with every parameter in ``dtype`` except those whose name
    contains "norm" (kept f32 for the f32 statistics), and 4-D conv weights
    in channels_last memory."""
    out = copy.deepcopy(model)
    for name, p in out.named_parameters():
        data = p.data if "norm" in name.lower() else p.data.to(dtype)
        if data.dim() == 4:
            data = data.contiguous(memory_format=torch.channels_last)
        p.data = data
    return out.eval()


def _signed_range(img: torch.Tensor) -> torch.Tensor:
    """[0,1] -> [-1,1] iff the data lies in [0,1] (decided on the device)."""
    in_unit = (img.min() >= 0) & (img.max() <= 1)
    return torch.where(in_unit, 2 * img - 1, img)


class MVDPipeline:
    """Holds the networks, the schedule and the tokenizer; callable like the
    JAX pipeline (same argument names)."""

    def __init__(self, config: ModelConfig, model: nn.ModuleDict, device, tokenizer=None):
        self.config = config
        self.device = resolve_device(device)
        self.model = model.to(self.device).eval()
        self.tokenizer = tokenizer or load_tokenizer(
            vocab_size=config.text_encoder.vocab_size,
            max_length=config.text_encoder.max_length,
        )
        self.schedule = build_schedule(config).to(self.device)
        self._compute_model: Optional[nn.Module] = None

    @classmethod
    def create(cls, config: ModelConfig, seed: int = 0, device="cuda", tokenizer=None):
        """Random-init all params from ``seed`` on ``device`` (the GPU by
        default); adapters start from the frozen attention when the config
        says so."""
        device = resolve_device(device)
        with torch.device(device):
            model = build_model(config)
        init_weights(model, torch.Generator(device).manual_seed(seed))
        if config.use_image_conditioning and config.adapter_init_from_frozen:
            init_adapters_from_frozen(model["mvd"])
        return cls(config, model, device, tokenizer)

    def load_jax_params(self, tree: Mapping) -> None:
        """Load the JAX pipeline's params (numpy leaves) into the masters."""
        load_jax_params(self.model, tree)
        self._compute_model = None

    @property
    def compute_model(self) -> nn.Module:
        """The networks in the compute dtype (norm params stay f32), cast
        once from the f32 masters."""
        dtype = DTYPES[self.config.dtype]
        if dtype == torch.float32:
            return self.model
        if self._compute_model is None:
            self._compute_model = cast_for_compute(self.model, dtype)
        return self._compute_model

    def _ids(self, prompts: Sequence[str], repeat: int) -> torch.Tensor:
        ids = np.repeat(np.asarray(self.tokenizer(list(prompts))), repeat, axis=0)
        return torch.as_tensor(ids, device=self.device)

    def _encode_source(self, model, src_images, B, noise, gen):
        """VAE-encode the unique source images, tile the moments to B and
        sample with per-row noise; returns scaled latents."""
        mean, logvar = model["vae"].encode_moments(_signed_range(src_images))
        n = src_images.shape[0]
        if n != B:
            mean, logvar = mean.repeat(B // n, 1, 1, 1), logvar.repeat(B // n, 1, 1, 1)
        if noise is None:
            noise = torch.randn(mean.shape, generator=gen, device=self.device)
        noise = torch.as_tensor(noise, dtype=mean.dtype, device=self.device)
        z = mean + torch.exp(0.5 * logvar) * noise
        return z * self.config.vae.scaling_factor

    def _cameras(self, c, B) -> torch.Tensor:
        c = np.asarray(c, np.float32)
        if c.ndim == 2:
            c = c[None]
        if c.shape[-2] == 3:  # [3,4] -> [4,4]
            pad = np.tile(np.array([0, 0, 0, 1], np.float32), (c.shape[0], 1, 1))
            c = np.concatenate([c, pad], axis=-2)
        if c.shape[0] < B:
            c = np.tile(c, (B // c.shape[0], 1, 1))
        return torch.as_tensor(c, device=self.device)

    def timesteps(self, num_inference_steps: int) -> List[Tuple[int, torch.Tensor]]:
        """The descending inference timesteps, each as a Python int (for
        ``ddpm_step``, which only indexes the schedule) and as a 0-d int64
        view of one device tensor made here (for the UNet)."""
        ts = inference_timesteps(self.schedule, num_inference_steps)
        on_device = torch.as_tensor(ts, dtype=torch.int64).to(self.device)
        return list(zip(ts.tolist(), on_device.unbind(0)))

    def denoise_loop(
        self,
        model: nn.Module,
        lat: torch.Tensor,
        timesteps: Sequence[Tuple[int, torch.Tensor]],
        embeds: torch.Tensor,
        film,
        ref_feats,
        ref_scale: float,
        guidance_scale: float,
        num_inference_steps: int,
        step_noises: Optional[torch.Tensor] = None,
        gen: Optional[torch.Generator] = None,
    ) -> torch.Tensor:
        """``denoise`` + ``ddpm_step`` at each of ``timesteps`` (pairs from
        ``MVDPipeline.timesteps``), with the noise of ``step_noises`` (steps,
        B, h, w, 4), already on the device, or drawn from ``gen``. Nothing
        here waits for the device."""
        do_cfg = guidance_scale > 1.0
        for i, (t, t_dev) in enumerate(timesteps):
            inp = torch.cat([lat, lat], dim=0) if do_cfg else lat
            pred = model["mvd"].denoise(inp, t_dev, embeds, film, ref_feats, ref_scale)
            if do_cfg:
                un, co = pred.chunk(2, dim=0)
                pred = un + guidance_scale * (co - un)
            if step_noises is not None:
                noise = step_noises[i]
            else:
                noise = torch.randn(lat.shape, generator=gen, device=lat.device)
            lat = ddpm_step(self.schedule, pred, t, lat, noise, num_inference_steps)
        return lat

    @torch.inference_mode()
    def __call__(
        self,
        prompt: Union[str, List[str], None] = None,
        height: Optional[int] = None,
        width: Optional[int] = None,
        num_inference_steps: int = 50,
        guidance_scale: float = 7.5,
        negative_prompt: Union[str, List[str], None] = None,
        num_images_per_prompt: int = 1,
        latents=None,
        source_camera=None,
        target_camera=None,
        source_images=None,
        ref_scale: float = 0.1,
        seed: int = 0,
        output_type: str = "np",
        vae_noise=None,
        step_noises=None,
    ):
        """Generate images: {"images": (B, H, W, 3) in [0, 1]}.

        ``latents`` (B, h, w, 4), ``vae_noise`` (B, h, w, 4) and
        ``step_noises`` (steps, B, h, w, 4) replace the draws from the seeded
        generator where given."""
        cfg = self.config
        dev = self.device
        prompt = "" if prompt is None else prompt
        prompts = [prompt] if isinstance(prompt, str) else list(prompt)
        B = len(prompts) * num_images_per_prompt
        height = height or cfg.unet.sample_size * 8
        width = width or cfg.unet.sample_size * 8
        lat_h, lat_w = height // 8, width // 8
        gen = torch.Generator(dev).manual_seed(seed)
        model = self.compute_model

        if latents is None:
            latents = torch.randn((B, lat_h, lat_w, 4), generator=gen, device=dev)
            latents = latents * self.schedule.init_noise_sigma
        lat = torch.as_tensor(latents, dtype=torch.float32, device=dev)

        text = model["text_encoder"](self._ids(prompts, num_images_per_prompt))
        do_cfg = guidance_scale > 1.0
        if do_cfg:
            neg = "" if negative_prompt is None else negative_prompt
            neg = [neg] if isinstance(neg, str) else list(neg)
            if len(neg) == 1:
                neg = neg * len(prompts)
            uncond = model["text_encoder"](self._ids(neg, num_images_per_prompt))
            embeds = torch.cat([uncond, text], dim=0)  # unconditional first
        else:
            embeds = text

        src_latents = None
        if cfg.use_image_conditioning and source_images is not None:
            src = torch.as_tensor(source_images, dtype=torch.float32, device=dev)
            if src.dim() == 3:
                src = src[None]
            if B % src.shape[0]:
                raise ValueError(f"batch {B} is not a multiple of {src.shape[0]} source images")
            src_latents = self._encode_source(model, src, B, vae_noise, gen)

        has_cam = cfg.use_camera_conditioning and target_camera is not None
        film, ref_feats = model["mvd"].prepare_conditioning(
            embeds,
            self._cameras(source_camera, B) if has_cam else None,
            self._cameras(target_camera, B) if has_cam else None,
            src_latents,
            cfg_batch=2 * B if do_cfg else B,
            precompute_kv=True,
        )

        # host-to-device copies happen here, once: inside the loop a pageable
        # copy would wait for the device to drain at every step
        if step_noises is not None:
            step_noises = torch.as_tensor(step_noises, dtype=torch.float32, device=dev)
        lat = self.denoise_loop(
            model, lat, self.timesteps(num_inference_steps), embeds, film, ref_feats,
            ref_scale, guidance_scale, num_inference_steps, step_noises, gen,
        )

        img = model["vae"].decode(lat / cfg.vae.scaling_factor)
        img = torch.clamp(img.float() / 2 + 0.5, 0.0, 1.0)
        if output_type == "np":
            img = img.cpu().numpy()
        return {"images": img}
