"""Multi-view UNet composition: camera FiLM + image cross-attention adapters.

Counterpart of ``mvd_tpu/nn/mvd_unet.py``:

  1. camera conditioning: ``CameraEncoder`` turns the relative source->target
     transform into per-block FiLM params;
  2. image conditioning: the same UNet runs over the source-view latents at
     t=0 with conditioning off; its per-layer features are normalized and,
     in the sampling pipeline, projected once through the adapters' K/V
     weights (they are step-invariant);
  3. denoising: the UNet with text context, adapter K/V and FiLM params.

``forward`` is the training call (the JAX ``__call__``): the camera encoder
and the adapters run with gradient, the frozen feature pass without, and
the adapter K/V are projected inside the adapters, not precomputed.

Conditioning tensors are tiled across the classifier-free-guidance batch
(unconditional half first). Under ray-map conditioning the Plücker ray map
of the target view rides the FiLM dict under "ray_map" (tiled like the FiLM
params), and ``denoise`` hands it to the UNet; the feature pass feeds the
source view's canonical rays.

With ``share_image_encoder=False`` the feature pass runs a second,
separate UNet of the same config (``image_encoder_unet``, frozen), as when
the denoising UNet itself is fine-tuned; by default it is the denoising
UNet. The feature pass keeps the config's ``num_views``: under joint
attention the source features are themselves computed jointly over the
flat B*V source rows. Over a model axis
(``parallel.shard_params_model_parallel``) the adapter K/V computed ahead
of the loop are each rank's heads.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..camera import plucker_ray_map, ray_grid
from ..config import ModelConfig
from ..tensor_parallel import ColumnParallelLinear
from .camera_encoder import CameraEncoder, modulation_dims
from .layers import normalize_ref_feature
from .unet import UNet2DCondition


def _adapter_module_name(feature_name: str) -> str:
    """down_block_0_attn_1 -> down_0_attn_1, mid_block_attn_0 -> mid_attn_0."""
    parts = feature_name.split("_")
    if feature_name.startswith("mid_block"):
        return f"mid_attn_{parts[-1]}"
    return f"{parts[0]}_{parts[2]}_attn_{parts[4]}"


class MultiViewUNet(nn.Module):
    def __init__(self, cfg: ModelConfig, share_image_encoder: bool = True):
        super().__init__()
        self.cfg = cfg
        self.share_image_encoder = share_image_encoder
        extra = 6 if cfg.use_ray_conditioning else 0
        self.unet = UNet2DCondition(cfg.unet, extra_in_channels=extra)
        if cfg.use_image_conditioning and not share_image_encoder:
            self.image_encoder_unet = UNet2DCondition(cfg.unet, extra_in_channels=extra)
        if cfg.use_camera_conditioning:
            dims = modulation_dims(
                cfg.unet.block_out_channels,
                num_down=len(cfg.unet.down_block_types),
                num_up=len(cfg.unet.up_block_types),
            )
            self.camera_encoder = CameraEncoder(cfg.camera_encoder, tuple(sorted(dims.items())))

    def extract_features(self, source_latents, encoder_hidden_states) -> Dict[str, torch.Tensor]:
        """Frozen-encoder pass: full UNet at t=0, features only. Under ray
        conditioning the source view's own rays in its own frame (the
        canonical grid: d = d_cam, moment 0) keep conv_in's channel count."""
        B, h, w, _ = source_latents.shape
        rays = None
        if self.cfg.use_ray_conditioning:
            d = ray_grid(h, w, self.cfg.ray_fov_deg, source_latents.device)
            rays = torch.cat([d, torch.zeros_like(d)], dim=-1).expand(B, h, w, 6)
        t0 = torch.zeros((B,), dtype=torch.int32, device=source_latents.device)
        enc = self.unet if self.share_image_encoder else self.image_encoder_unet
        return enc(source_latents, t0, encoder_hidden_states, ray_map=rays)[1]

    def _precompute_adapter_kv(self, name: str, feat: torch.Tensor):
        """Project normalized features (b, S, C) through the adapter K/V
        weights once, in the compute dtype: {"self": (k, v), "cross": (k, v)};
        model-sharded, k and v are the shards of each rank's heads."""
        block = getattr(self.unet, _adapter_module_name(name)).transformer_blocks_0
        out = {}
        for key, adapter in (("self", block.adapter_self), ("cross", block.adapter_cross)):
            to_k, to_v = adapter.to_k_ref, adapter.to_v_ref
            if isinstance(to_k, ColumnParallelLinear):
                out[key] = (to_k(feat), to_v(feat))
                continue
            f = feat.to(to_k.weight.dtype)
            out[key] = (F.linear(f, to_k.weight), F.linear(f, to_v.weight))
        return out

    def prepare_conditioning(
        self,
        encoder_hidden_states: torch.Tensor,  # (B or B*, 77, D)
        source_camera: Optional[torch.Tensor] = None,  # (B, 4, 4)
        target_camera: Optional[torch.Tensor] = None,
        source_image_latents: Optional[torch.Tensor] = None,  # (B, h, w, 4)
        cfg_batch: Optional[int] = None,  # B* (2B under CFG); None -> cond batch
        precompute_kv: bool = False,
        latent_hw: Optional[Tuple[int, int]] = None,  # the ray map's (h, w)
    ):
        """Step-invariant conditioning, computed once: FiLM params from the
        cameras (with gradient where grad mode is on), the ray map under
        ray conditioning (its size ``latent_hw``, else the source latents',
        else the config's sample size), and per-layer reference features (or
        adapter K/V) from a feature pass that never records gradient."""
        cfg = self.cfg
        film = None
        if cfg.use_camera_conditioning and target_camera is not None:
            if source_camera is None:
                raise ValueError("target_camera given without source_camera")
            _, film = self.camera_encoder(source_camera, target_camera)
            cam_b = source_camera.shape[0]
            if cfg_batch is not None and cam_b < cfg_batch:
                rep = cfg_batch // cam_b
                film = {k: (s.repeat(rep, 1), sh.repeat(rep, 1)) for k, (s, sh) in film.items()}
        if cfg.use_ray_conditioning:
            if source_camera is None or target_camera is None:
                raise ValueError("use_ray_conditioning needs source and target cameras")
            if latent_hw is None:
                latent_hw = (source_image_latents.shape[1:3] if source_image_latents is not None
                             else (cfg.unet.sample_size, cfg.unet.sample_size))
            rays = plucker_ray_map(source_camera, target_camera, *latent_hw, cfg.ray_fov_deg)
            if cfg_batch is not None and rays.shape[0] < cfg_batch:
                rays = rays.repeat(cfg_batch // rays.shape[0], 1, 1, 1)
            film = {**(film or {}), "ray_map": rays}

        ref_features = None
        if cfg.use_image_conditioning and source_image_latents is not None:
            b = source_image_latents.shape[0]
            # conditional half of the text context
            if encoder_hidden_states.shape[0] == 2 * b:
                enc_text = encoder_hidden_states[b:]
            else:
                enc_text = encoder_hidden_states[:b]
            with torch.no_grad():  # frozen tower; its features are detached
                feats = self.extract_features(source_image_latents, enc_text)
            ref_features = {}
            for name, f in feats.items():
                f = normalize_ref_feature(f)  # (b, H, W, C) f32
                f = f.reshape(b, -1, f.shape[-1])
                if cfg_batch is not None and b < cfg_batch:
                    f = f.repeat(cfg_batch // b, 1, 1)
                if precompute_kv and cfg.unet.with_adapters:
                    ref_features[name] = self._precompute_adapter_kv(name, f)
                else:
                    ref_features[name] = f
        return film, ref_features

    def denoise(self, sample, timestep, encoder_hidden_states, film=None,
                ref_features=None, ref_scale=None, cached_encoder=None,
                return_encoder_cache: bool = False):
        """One UNet evaluation with precomputed conditioning -> f32 NHWC, and
        with ``return_encoder_cache`` the encoder cache beside it; from a
        ``cached_encoder`` only the mid block and the up path run (see
        ``UNet2DCondition.forward``)."""
        Bs = (sample if cached_encoder is None else cached_encoder[1]).shape[0]
        if encoder_hidden_states.shape[0] < Bs:  # CFG text repeat
            rep = Bs // encoder_hidden_states.shape[0]
            encoder_hidden_states = encoder_hidden_states.repeat(rep, 1, 1)
        rays = None
        if film is not None and "ray_map" in film:
            film = dict(film)
            rays = film.pop("ray_map")
            film = film or None
        out = self.unet(
            sample, timestep, encoder_hidden_states, ref_features=ref_features, film=film,
            ref_scale=ref_scale, cached_encoder=cached_encoder,
            return_encoder_cache=return_encoder_cache, ray_map=rays,
        )
        return (out[0], out[2]) if return_encoder_cache else out[0]

    def forward(
        self,
        sample: torch.Tensor,  # (B*, h, w, 4) NHWC
        timestep: torch.Tensor,  # () or (B*,)
        encoder_hidden_states: torch.Tensor,  # (B or B*, 77, D)
        source_camera: Optional[torch.Tensor] = None,  # (B, 4, 4)
        target_camera: Optional[torch.Tensor] = None,
        source_image_latents: Optional[torch.Tensor] = None,  # (B, h, w, 4)
        ref_scale: Optional[float] = None,
    ) -> torch.Tensor:
        """Conditioning and one denoise in a single differentiable call
        -> f32 NHWC prediction."""
        Bs = sample.shape[0]
        if encoder_hidden_states.shape[0] < Bs:  # CFG text repeat
            encoder_hidden_states = encoder_hidden_states.repeat(
                Bs // encoder_hidden_states.shape[0], 1, 1)
        film, ref_features = self.prepare_conditioning(
            encoder_hidden_states, source_camera, target_camera, source_image_latents,
            cfg_batch=Bs,
        )
        return self.denoise(sample, timestep, encoder_hidden_states, film, ref_features, ref_scale)
