"""SD2.1-class conditional UNet with explicit feature dataflow (PyTorch).

Counterpart of ``mvd_tpu/nn/unet.py``: one module serves as the denoising
UNet (text context, per-layer adapter features, FiLM camera modulation) and
as the frozen feature extractor (called at t=0 with conditioning off; the
per-attention-layer features come back as a dict named
``down_block_{i}_attn_{j}`` / ``mid_block_attn_0`` / ``up_block_{i}_attn_{j}``).

FiLM params arrive as ``name -> (scale, shift)`` of shape (B, C) and apply as
``x * scale + shift`` after each down/mid/up block; "output" modulates the
input latents before conv_in, and a Plücker ray map, where given, joins them
as 6 more input channels after it. For encoder-reuse sampling the forward
returns, or consumes, the down path's state (skip residuals and the
bottleneck input). Not ported yet: remat.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn as nn

from ..config import UNetConfig
from .layers import (
    Downsample,
    GroupNorm,
    ResnetBlock,
    TimestepEmbedMLP,
    Transformer2D,
    Upsample,
    conv3x3,
    timestep_embedding,
)

Features = Dict[str, torch.Tensor]
Film = Dict[str, Tuple[torch.Tensor, torch.Tensor]]
# (skip residuals of the down path, NCHW; the bottleneck input)
EncoderCache = Tuple[Tuple[torch.Tensor, ...], torch.Tensor]


def apply_film(x: torch.Tensor, film: Optional[Film], name: str) -> torch.Tensor:
    """x * scale + shift with (B, C) params broadcast over NCHW."""
    if film is None or name not in film:
        return x
    scale, shift = film[name]
    return x * scale[:, :, None, None].to(x.dtype) + shift[:, :, None, None].to(x.dtype)


class UNet2DCondition(nn.Module):
    """``extra_in_channels``: input channels beside the latents (6 for a
    ray map), which conv_in takes after them."""

    def __init__(self, cfg: UNetConfig, extra_in_channels: int = 0):
        super().__init__()
        self.cfg = cfg
        ch = cfg.block_out_channels
        temb_dim = ch[0] * 4
        G, eps = cfg.norm_num_groups, cfg.norm_eps

        def attn(i_block, channels):
            heads = cfg.num_attention_heads[i_block]
            return Transformer2D(
                channels, heads, ch[i_block] // heads, cfg.cross_attention_dim,
                cfg.transformer_layers_per_block, G, cfg.with_adapters, cfg.img_ref_scale,
                cfg.attention_impl,
            )

        self.time_embedding = TimestepEmbedMLP(ch[0], temb_dim)
        self.conv_in = conv3x3(cfg.in_channels + extra_in_channels, ch[0])
        skip_ch = [ch[0]]
        h_ch = ch[0]
        for i, block_type in enumerate(cfg.down_block_types):
            for j in range(cfg.layers_per_block):
                setattr(self, f"down_{i}_resnet_{j}", ResnetBlock(h_ch, ch[i], G, eps, temb_dim))
                h_ch = ch[i]
                if block_type == "CrossAttnDownBlock2D":
                    setattr(self, f"down_{i}_attn_{j}", attn(i, h_ch))
                skip_ch.append(h_ch)
            if i < len(cfg.down_block_types) - 1:
                setattr(self, f"down_{i}_downsample", Downsample(h_ch, h_ch))
                skip_ch.append(h_ch)

        self.mid_resnet_0 = ResnetBlock(h_ch, ch[-1], G, eps, temb_dim)
        self.mid_attn_0 = attn(len(ch) - 1, ch[-1])
        self.mid_resnet_1 = ResnetBlock(ch[-1], ch[-1], G, eps, temb_dim)
        h_ch = ch[-1]

        rev = list(reversed(ch))
        for i, block_type in enumerate(cfg.up_block_types):
            for j in range(cfg.layers_per_block + 1):
                setattr(self, f"up_{i}_resnet_{j}",
                        ResnetBlock(h_ch + skip_ch.pop(), rev[i], G, eps, temb_dim))
                h_ch = rev[i]
                if block_type == "CrossAttnUpBlock2D":
                    setattr(self, f"up_{i}_attn_{j}", attn(len(ch) - 1 - i, h_ch))
            if i < len(cfg.up_block_types) - 1:
                setattr(self, f"up_{i}_upsample", Upsample(h_ch, h_ch))

        self.conv_norm_out = GroupNorm(G, h_ch, eps, fuse_silu=True)
        self.conv_out = conv3x3(h_ch, cfg.out_channels)

    def forward(
        self,
        sample: torch.Tensor,  # (B, h, w, C_in) NHWC latents
        timesteps: torch.Tensor,  # () or (B,)
        encoder_hidden_states: torch.Tensor,  # (B, 77, D_ctx)
        ref_features: Optional[Dict] = None,
        film: Optional[Film] = None,
        ref_scale: Optional[float] = None,
        cached_encoder: Optional[EncoderCache] = None,
        return_encoder_cache: bool = False,
        ray_map: Optional[torch.Tensor] = None,  # (B, h, w, 6) f32 Plücker rays
    ):
        """Returns (out (B, h, w, C_out) f32 NHWC, features name -> NHWC),
        and the encoder cache third with ``return_encoder_cache``.

        Encoder propagation (arXiv 2312.09608): ``return_encoder_cache``
        also returns the down path's state ``(residuals, h)``, taken before
        the mid block; ``cached_encoder`` skips the down path and runs the
        mid block and the up path from such a state (``sample`` and
        ``ray_map`` are then unused)."""
        cfg = self.cfg
        B = (sample if cached_encoder is None else cached_encoder[1]).shape[0]
        if timesteps.dim() == 0:
            timesteps = timesteps.expand(B)
        dtype = self.conv_in.dtype
        temb = self.time_embedding(timestep_embedding(timesteps, cfg.block_out_channels[0]))
        ctx = encoder_hidden_states.to(dtype)

        def get_ref(name):
            return None if ref_features is None else ref_features.get(name)

        features: Features = {}
        nhwc = lambda t: t.permute(0, 2, 3, 1)

        if cached_encoder is not None:
            residuals, h = list(cached_encoder[0]), cached_encoder[1]
        else:
            x = sample.permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)
            x = apply_film(x, film, "output")
            if ray_map is not None:  # after the FiLM, which modulates the latents only
                x = torch.cat([x, ray_map.permute(0, 3, 1, 2).to(x.dtype)], dim=1)
                x = x.contiguous(memory_format=torch.channels_last)
            h = self.conv_in(x.to(dtype))
            residuals = [h]

            for i, block_type in enumerate(cfg.down_block_types):
                for j in range(cfg.layers_per_block):
                    h = getattr(self, f"down_{i}_resnet_{j}")(h, temb)
                    if block_type == "CrossAttnDownBlock2D":
                        fname = f"down_block_{i}_attn_{j}"
                        h = getattr(self, f"down_{i}_attn_{j}")(h, ctx, get_ref(fname), ref_scale)
                        features[fname] = nhwc(h)
                    residuals.append(h)
                if i < len(cfg.down_block_types) - 1:
                    h = getattr(self, f"down_{i}_downsample")(h)
                    residuals.append(h)
                h = apply_film(h, film, f"down_{i}")
        cache = (tuple(residuals), h)

        h = self.mid_resnet_0(h, temb)
        h = self.mid_attn_0(h, ctx, get_ref("mid_block_attn_0"), ref_scale)
        features["mid_block_attn_0"] = nhwc(h)
        h = self.mid_resnet_1(h, temb)
        h = apply_film(h, film, "mid")

        for i, block_type in enumerate(cfg.up_block_types):
            for j in range(cfg.layers_per_block + 1):
                h = torch.cat([h, residuals.pop().to(h.dtype)], dim=1)
                h = getattr(self, f"up_{i}_resnet_{j}")(h, temb)
                if block_type == "CrossAttnUpBlock2D":
                    fname = f"up_block_{i}_attn_{j}"
                    h = getattr(self, f"up_{i}_attn_{j}")(h, ctx, get_ref(fname), ref_scale)
                    features[fname] = nhwc(h)
            if i < len(cfg.up_block_types) - 1:
                h = getattr(self, f"up_{i}_upsample")(h)
            h = apply_film(h, film, f"up_{i}")

        out = nhwc(self.conv_out(self.conv_norm_out(h))).float()
        if return_encoder_cache:
            return out, features, cache
        return out, features
