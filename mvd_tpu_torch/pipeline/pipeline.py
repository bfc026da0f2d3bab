"""MVD generation pipeline: text + source view + cameras -> multi-view images.

Counterpart of ``mvd_tpu/pipeline/pipeline.py`` (guidance on or off):

  * CLIP text encode, CFG concat (unconditional first);
  * VAE encode of the unique source images, moments tiled to the batch;
  * step-invariant conditioning (camera FiLM, the ray map under ray
    conditioning, frozen feature pass, adapter K/V) computed once;
  * the denoise loop, a Python loop of ``denoise`` and the sampler's step
    (DDPM, DDIM or DPM-Solver++(2M)), optionally with encoder propagation
    (``encoder_reuse``: the down path runs at the first step of each group
    and the others reuse its state);
  * VAE decode, then (x/2 + 0.5) clamped to [0, 1].

``invert`` maps clean images up the schedule by DDIM inversion, for a
DDIM resample from them. With joint multi-view attention
(``UNetConfig.num_views`` V > 1) the batch is V-view groups (row b*V + v),
so V must divide it; under CFG the unconditional half comes first and each
half is whole groups, so joint attention never mixes the two. Given a
``mesh`` and a model whose ``view_axis`` is the mesh's view axis of more
than one process, generation is view-sharded, as the JAX pipeline's
``_build_sharded_generate``: every rank computes the conditioning of the
whole batch (the unsharded twin of JAX), each denoise runs on the rank's
block of view groups and views with ring attention between the view
processes (``parallel.py``), the blocks of the prediction are gathered over
the mesh, and every rank takes the sampler's step on the whole batch with
the same noise, so the draws are those of the unsharded pipeline. Given a
``mesh`` whose model axis is more than one process, the networks must be
cut over it first (``parallel.shard_params_model_parallel(pipe.model,
mesh)``, after the weights are loaded): every rank then runs the whole
generation with its part of the widest products, K1 on its heads, each
sharded layer meeting the others over the model axis it carries, and
every rank draws the same noise and returns the whole images. A view axis
and a model axis together raise, as the JAX package shards no such
combination. Runs on
the GPU unless the caller passes
``device="cpu"``; without a GPU the default raises rather than falling back.
Random numbers come from a ``torch.Generator`` seeded with ``seed``, unless
the caller hands in the initial latents, the VAE sample noise and the
per-step DDPM noise.
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
    SAMPLERS,
    NoiseSchedule,
    ddim_inverse_step,
    ddim_step,
    ddpm_step,
    dpmpp_2m_init,
    dpmpp_2m_step,
    inference_timesteps,
    make_shifted_schedule,
)
from ..nn.adapter_init import init_adapters_from_frozen
from ..nn.clip_text import CLIPTextEncoder
from ..tensor_parallel import is_sharded
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


def build_model(cfg: ModelConfig, share_image_encoder: bool = True) -> nn.ModuleDict:
    """The three networks, named as the JAX pipeline's param tree; with
    ``share_image_encoder=False`` the multi-view UNet holds a separate
    feature-pass UNet (``image_encoder_unet``)."""
    return nn.ModuleDict({
        "mvd": MultiViewUNet(cfg, share_image_encoder),
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

    def __init__(self, config: ModelConfig, model: nn.ModuleDict, device, tokenizer=None, mesh=None):
        if mesh is not None and mesh.shape["view"] > 1 and mesh.shape["model"] > 1:
            raise ValueError(f"a mesh of view {mesh.shape['view']} x model {mesh.shape['model']}: "
                             "the JAX package takes a view-sharded call's params replicated, so a "
                             "view axis and a model axis do not shard one generation together")
        self.config = config
        self.mesh = mesh
        self.device = resolve_device(device)
        self.model = model.to(self.device).eval()
        self.tokenizer = tokenizer or load_tokenizer(
            vocab_size=config.text_encoder.vocab_size,
            max_length=config.text_encoder.max_length,
        )
        self.schedule = build_schedule(config).to(self.device)
        self._compute_model: Optional[nn.Module] = None

    @property
    def view_sharded(self) -> bool:
        """Whether generation runs view-sharded over ``mesh``."""
        axis = self.config.unet.view_axis
        return self.mesh is not None and axis is not None and self.mesh.shape.get(axis, 1) > 1

    @classmethod
    def create(cls, config: ModelConfig, seed: int = 0, device="cuda", tokenizer=None, mesh=None):
        """Random-init all params from ``seed`` on ``device`` (the GPU by
        default); adapters start from the frozen attention when the config
        says so. Every rank of a ``mesh`` draws the same weights."""
        device = resolve_device(device)
        with torch.device(device):
            model = build_model(config)
        init_weights(model, torch.Generator(device).manual_seed(seed))
        if config.use_image_conditioning and config.adapter_init_from_frozen:
            init_adapters_from_frozen(model["mvd"])
        return cls(config, model, device, tokenizer, mesh)

    def load_jax_params(self, tree: Mapping, keep_missing: bool = False) -> List[str]:
        """Load the JAX pipeline's params (numpy leaves) into the masters.
        With ``keep_missing`` only the networks the tree names are loaded,
        and a parameter of theirs the tree lacks keeps its value; returns
        those parameters' names."""
        if keep_missing:
            kept = [f"{net}.{name}" for net, sub in tree.items()
                    for name in load_jax_params(self.model[net], sub, keep_missing=True)]
        else:
            kept = load_jax_params(self.model, tree)
        self._compute_model = None
        return kept

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

    def drop_compute_model(self) -> None:
        """Forget the cached compute-dtype copy of the networks: the next
        use of ``compute_model`` casts anew from the masters. A trainer
        calls it around each validation, so that generation sees the
        latest update and the copy is not held between validations."""
        self._compute_model = None

    def _check_views(self, B: int) -> None:
        V = self.config.unet.num_views
        if B % V:
            raise ValueError(f"joint attention over {V} views needs a batch that {V} divides, "
                             f"got {B} images")

    def _check_model_axis(self, model: nn.Module) -> None:
        """A mesh with a model axis generates only with the networks cut
        over it: never silently replicated."""
        if self.mesh is not None and self.mesh.shape["model"] > 1 and not is_sharded(model):
            raise ValueError(f"the mesh has a model axis of {self.mesh.shape['model']} but the "
                             "networks are whole: call parallel.shard_params_model_parallel("
                             "pipe.model, mesh) after loading the weights")

    def _denoiser(self, mvd):
        """``mvd.denoise``, or its view-sharded form over the mesh: the same
        arguments on the whole flat batch (rows b * V + v) and the same
        result on every rank; the encoder cache holds the rank's rows."""
        if not self.view_sharded:
            return mvd.denoise
        from ..parallel import sharded_denoise_cache_fns, tree_map

        mesh, V = self.mesh, self.config.unet.num_views
        with_cache, cached = sharded_denoise_cache_fns(mvd, mesh)
        bv = lambda tree: tree_map(lambda x: x.reshape((x.shape[0] // V, V) + tuple(x.shape[1:])), tree)
        flat = lambda x: mesh.gather_blocks(x).flatten(0, 1)

        def denoise(sample, t, text, film=None, ref_features=None, ref_scale=None,
                    cached_encoder=None, return_encoder_cache=False):
            groups = text.shape[0] // V
            if groups % mesh.shape["data"]:
                raise ValueError(f"view-sharded generation needs its {groups} view groups (CFG "
                                 f"halves included) to divide over the mesh's {mesh.shape['data']} "
                                 "data processes")
            args = (bv(text), bv(film), bv(ref_features), ref_scale)
            if cached_encoder is not None:
                return flat(cached(cached_encoder, None, t, *args))
            if return_encoder_cache:
                pred, cache = with_cache(bv(sample), t, *args)
                return flat(pred), cache
            return flat(with_cache(bv(sample), t, *args)[0])

        return denoise

    def _ids(self, prompts: Sequence[str], repeat: int) -> torch.Tensor:
        ids = np.repeat(np.asarray(self.tokenizer(list(prompts))), repeat, axis=0)
        return torch.as_tensor(ids, device=self.device)

    @torch.inference_mode()
    def encode_text(self, prompts: Union[str, List[str]]) -> torch.Tensor:
        """Prompts -> CLIP hidden states (B, 77, D) in the compute dtype."""
        prompts = [prompts] if isinstance(prompts, str) else prompts
        return self.compute_model["text_encoder"](self._ids(prompts, 1))

    @torch.inference_mode()
    def vae_encode(self, images, noise=None) -> torch.Tensor:
        """[-1, 1] NHWC images -> scaled latents: the posterior's mean, or
        its sample ``mean + std * noise`` where ``noise`` is given."""
        images = torch.as_tensor(images, dtype=torch.float32, device=self.device)
        if noise is not None:
            noise = torch.as_tensor(noise, device=self.device)
        return self.compute_model["vae"].encode(images, noise) * self.config.vae.scaling_factor

    @torch.inference_mode()
    def vae_decode(self, latents) -> torch.Tensor:
        """Scaled latents -> NHWC images in about [-1, 1]."""
        latents = torch.as_tensor(latents, device=self.device)
        return self.compute_model["vae"].decode(latents / self.config.vae.scaling_factor)

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
        sampler: str = "ddpm",
        encoder_reuse: int = 1,
    ) -> torch.Tensor:
        """``denoise`` + the ``sampler``'s step at each of ``timesteps``
        (pairs from ``MVDPipeline.timesteps``). DDPM takes the noise of
        ``step_noises`` (steps, B, h, w, 4), already on the device, or draws
        it from ``gen``; DDIM and DPM-Solver++(2M) draw none. With
        ``encoder_reuse`` k > 1 the steps run in groups of k: the first of a
        group runs the whole UNet and keeps its encoder cache, the other
        k - 1 run the mid block and the up path from it, and the steps past
        the last whole group run the whole UNet. Nothing here waits for the
        device."""
        do_cfg = guidance_scale > 1.0
        self._check_model_axis(model)
        denoise = self._denoiser(model["mvd"])
        state = dpmpp_2m_init(lat) if sampler == "dpmpp_2m" else None
        grouped = (len(timesteps) // encoder_reuse) * encoder_reuse if encoder_reuse > 1 else 0
        cache = None
        for i, (t, t_dev) in enumerate(timesteps):
            inp = torch.cat([lat, lat], dim=0) if do_cfg else lat
            args = (inp, t_dev, embeds, film, ref_feats, ref_scale)
            if i < grouped and i % encoder_reuse:
                pred = denoise(*args, cached_encoder=cache)
            elif i < grouped:
                pred, cache = denoise(*args, return_encoder_cache=True)
            else:
                pred = denoise(*args)
            if do_cfg:
                un, co = pred.chunk(2, dim=0)
                pred = un + guidance_scale * (co - un)
            if sampler == "ddim":
                lat = ddim_step(self.schedule, pred, t, lat, num_inference_steps)
            elif sampler == "dpmpp_2m":
                lat, state = dpmpp_2m_step(self.schedule, pred, t, lat, state, num_inference_steps)
            else:
                if step_noises is not None:
                    noise = step_noises[i]
                else:
                    noise = torch.randn(lat.shape, generator=gen, device=lat.device)
                lat = ddpm_step(self.schedule, pred, t, lat, noise, num_inference_steps)
        return lat

    def _conditioning(self, model, embeds, source_camera, target_camera, src_latents, B, cfg_batch,
                      latent_hw):
        """prepare_conditioning with the cameras on the device, where the
        config uses them and the caller gave a target camera."""
        has_cam = self.config.use_camera_conditioning and target_camera is not None
        return model["mvd"].prepare_conditioning(
            embeds,
            self._cameras(source_camera, B) if has_cam else None,
            self._cameras(target_camera, B) if has_cam else None,
            src_latents, cfg_batch=cfg_batch, precompute_kv=True, latent_hw=latent_hw,
        )

    def _source_images(self, source_images, B) -> Optional[torch.Tensor]:
        """The unique source images on the device, (n, H, W, 3) with n
        dividing B, or None where the config takes none."""
        if not self.config.use_image_conditioning or source_images is None:
            return None
        src = torch.as_tensor(source_images, dtype=torch.float32, device=self.device)
        if src.dim() == 3:
            src = src[None]
        if B % src.shape[0]:
            raise ValueError(f"batch {B} is not a multiple of {src.shape[0]} source images")
        return src

    @torch.inference_mode()
    def invert(
        self,
        images,
        prompt: Union[str, List[str], None] = None,
        num_inference_steps: int = 50,
        source_camera=None,
        target_camera=None,
        source_images=None,
        ref_scale: float = 0.1,
        output_type: str = "np",
    ):
        """DDIM inversion: clean images ((B, H, W, 3) in [0, 1]) mapped up
        the noise schedule, so that a DDIM resample with the same prompt,
        conditioning and step count about reconstructs them
        (arXiv 2508.10688). Deterministic: mean-mode VAE encode, guidance
        1.0, no noise draws. Returns {"latents": (B, H/8, W/8, 4)}, to feed
        back as ``pipe(latents=..., sampler="ddim", guidance_scale=1.0)``."""
        cfg = self.config
        prompts = [""] if prompt is None else [prompt] if isinstance(prompt, str) else list(prompt)
        images = torch.as_tensor(images, dtype=torch.float32, device=self.device)
        if images.dim() == 3:
            images = images[None]
        B = images.shape[0]
        if len(prompts) == 1:
            prompts = prompts * B
        if len(prompts) != B:
            raise ValueError(f"{len(prompts)} prompts for {B} images")
        self._check_views(B)
        model = self.compute_model
        embeds = model["text_encoder"](self._ids(prompts, 1))
        lat = model["vae"].encode_moments(_signed_range(images))[0] * cfg.vae.scaling_factor
        src_latents = None
        src = self._source_images(source_images, B)
        if src is not None:
            s_lat = model["vae"].encode_moments(_signed_range(src))[0] * cfg.vae.scaling_factor
            src_latents = s_lat.repeat(B // s_lat.shape[0], 1, 1, 1)
        film, ref_feats = self._conditioning(model, embeds, source_camera, target_camera, src_latents,
                                             B, B, tuple(lat.shape[1:3]))
        lat = self.inversion_loop(model, lat, self.timesteps(num_inference_steps), embeds, film,
                                  ref_feats, ref_scale, num_inference_steps)
        return {"latents": lat.float().cpu().numpy() if output_type == "np" else lat}

    def inversion_loop(self, model, lat, timesteps, embeds, film, ref_feats, ref_scale: float,
                       num_inference_steps: int) -> torch.Tensor:
        """``denoise`` + ``ddim_inverse_step`` up ``timesteps`` (pairs from
        ``MVDPipeline.timesteps``, taken in ascending order). Nothing here
        waits for the device."""
        self._check_model_axis(model)
        for t, t_dev in reversed(timesteps):
            pred = model["mvd"].denoise(lat, t_dev, embeds, film, ref_feats, ref_scale)
            lat = ddim_inverse_step(self.schedule, pred, t, lat, num_inference_steps)
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
        encoder_reuse: int = 1,
        sampler: Optional[str] = None,
    ):
        """Generate images: {"images": (B, H, W, 3) in [0, 1]}.

        ``latents`` (B, h, w, 4), ``vae_noise`` (B, h, w, 4) and
        ``step_noises`` (steps, B, h, w, 4) replace the draws from the seeded
        generator where given. ``sampler`` ("ddpm", "ddim" or "dpmpp_2m",
        the second-order DPM-Solver++ that needs about 10 steps where DDIM
        needs 20-50) overrides the config's for this call.
        ``encoder_reuse`` k > 1 reuses the down path's state for k - 1 of
        every k steps (arXiv 2312.09608): an approximation, where 1 keeps
        the exact trajectory."""
        if encoder_reuse < 1:
            raise ValueError(f"encoder_reuse must be >= 1, got {encoder_reuse}")
        sampler = sampler or self.config.scheduler.sampler
        if sampler not in SAMPLERS:
            raise ValueError(f"unknown sampler {sampler!r}; expected one of {SAMPLERS}")
        cfg = self.config
        dev = self.device
        prompt = "" if prompt is None else prompt
        prompts = [prompt] if isinstance(prompt, str) else list(prompt)
        B = len(prompts) * num_images_per_prompt
        self._check_views(B)
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
        src = self._source_images(source_images, B)
        if src is not None:
            src_latents = self._encode_source(model, src, B, vae_noise, gen)
        film, ref_feats = self._conditioning(model, embeds, source_camera, target_camera, src_latents,
                                             B, 2 * B if do_cfg else B, (lat_h, lat_w))

        # host-to-device copies happen here, once: inside the loop a pageable
        # copy would wait for the device to drain at every step
        if step_noises is not None:
            step_noises = torch.as_tensor(step_noises, dtype=torch.float32, device=dev)
        lat = self.denoise_loop(
            model, lat, self.timesteps(num_inference_steps), embeds, film, ref_feats,
            ref_scale, guidance_scale, num_inference_steps, step_noises, gen, sampler,
            encoder_reuse,
        )

        img = model["vae"].decode(lat / cfg.vae.scaling_factor)
        img = torch.clamp(img.float() / 2 + 0.5, 0.0, 1.0)
        if output_type == "np":
            img = img.cpu().numpy()
        return {"images": img}
