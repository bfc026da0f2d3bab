"""SD AutoencoderKL (VAE) in PyTorch.

Counterpart of ``mvd_tpu/nn/vae.py``: encoder with the asymmetric
((0,1),(0,1)) downsample padding, single-head mid-block attention, decoder;
``encode_moments`` returns (mean, logvar) with logvar clipped to [-30, 20].
Every VAE GroupNorm has eps 1e-6. Public tensors are NHWC. The mid-block
attention (one head of width 512) is plain matmul + softmax, as it is plain
``einsum`` in the JAX package.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn as nn

from ..config import VAEConfig
from .layers import Conv2d, Downsample, GroupNorm, Linear, ResnetBlock, Upsample, conv3x3

_EPS = 1e-6


class VAEAttention(nn.Module):
    """GroupNorm + single-head full attention over spatial positions."""

    def __init__(self, channels: int, norm_num_groups: int = 32):
        super().__init__()
        self.group_norm = GroupNorm(norm_num_groups, channels, _EPS)
        self.to_q = Linear(channels, channels)
        self.to_k = Linear(channels, channels)
        self.to_v = Linear(channels, channels)
        self.to_out = Linear(channels, channels)

    def forward(self, x):
        B, C, H, W = x.shape
        h = self.group_norm(x).permute(0, 2, 3, 1).reshape(B, H * W, C)
        q, k, v = self.to_q(h), self.to_k(h), self.to_v(h)
        logits = q.float() @ k.float().transpose(-1, -2)
        probs = torch.softmax(logits / math.sqrt(C), dim=-1)
        h = (probs.to(v.dtype) @ v).to(x.dtype)
        h = self.to_out(h)
        return x + h.reshape(B, H, W, C).permute(0, 3, 1, 2)


class Encoder(nn.Module):
    def __init__(self, cfg: VAEConfig):
        super().__init__()
        self.cfg = cfg
        ch, G = cfg.block_out_channels, cfg.norm_num_groups
        self.conv_in = conv3x3(cfg.in_channels, ch[0])
        h_ch = ch[0]
        for i, out_ch in enumerate(ch):
            for j in range(cfg.layers_per_block):
                setattr(self, f"down_{i}_resnet_{j}", ResnetBlock(h_ch, out_ch, G, _EPS))
                h_ch = out_ch
            if i < len(ch) - 1:
                setattr(self, f"down_{i}_downsample", Downsample(h_ch, h_ch, asymmetric_pad=True))
        self.mid_resnet_0 = ResnetBlock(h_ch, h_ch, G, _EPS)
        self.mid_attn = VAEAttention(h_ch, G)
        self.mid_resnet_1 = ResnetBlock(h_ch, h_ch, G, _EPS)
        self.conv_norm_out = GroupNorm(G, h_ch, _EPS, fuse_silu=True)
        self.conv_out = conv3x3(h_ch, 2 * cfg.latent_channels)

    def forward(self, x):
        cfg = self.cfg
        h = self.conv_in(x)
        for i in range(len(cfg.block_out_channels)):
            for j in range(cfg.layers_per_block):
                h = getattr(self, f"down_{i}_resnet_{j}")(h)
            if i < len(cfg.block_out_channels) - 1:
                h = getattr(self, f"down_{i}_downsample")(h)
        h = self.mid_resnet_1(self.mid_attn(self.mid_resnet_0(h)))
        return self.conv_out(self.conv_norm_out(h))


class Decoder(nn.Module):
    def __init__(self, cfg: VAEConfig):
        super().__init__()
        self.cfg = cfg
        rev, G = list(reversed(cfg.block_out_channels)), cfg.norm_num_groups
        self.conv_in = conv3x3(cfg.latent_channels, rev[0])
        self.mid_resnet_0 = ResnetBlock(rev[0], rev[0], G, _EPS)
        self.mid_attn = VAEAttention(rev[0], G)
        self.mid_resnet_1 = ResnetBlock(rev[0], rev[0], G, _EPS)
        h_ch = rev[0]
        for i, out_ch in enumerate(rev):
            for j in range(cfg.layers_per_block + 1):
                setattr(self, f"up_{i}_resnet_{j}", ResnetBlock(h_ch, out_ch, G, _EPS))
                h_ch = out_ch
            if i < len(rev) - 1:
                setattr(self, f"up_{i}_upsample", Upsample(h_ch, h_ch))
        self.conv_norm_out = GroupNorm(G, h_ch, _EPS, fuse_silu=True)
        self.conv_out = conv3x3(h_ch, cfg.out_channels)

    def forward(self, z):
        cfg = self.cfg
        h = self.conv_in(z)
        h = self.mid_resnet_1(self.mid_attn(self.mid_resnet_0(h)))
        n = len(cfg.block_out_channels)
        for i in range(n):
            for j in range(cfg.layers_per_block + 1):
                h = getattr(self, f"up_{i}_resnet_{j}")(h)
            if i < n - 1:
                h = getattr(self, f"up_{i}_upsample")(h)
        return self.conv_out(self.conv_norm_out(h))


def _nchw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)


class AutoencoderKL(nn.Module):
    def __init__(self, cfg: VAEConfig):
        super().__init__()
        self.cfg = cfg
        self.encoder = Encoder(cfg)
        self.decoder = Decoder(cfg)
        self.quant_conv = Conv2d(2 * cfg.latent_channels, 2 * cfg.latent_channels, 1)
        self.post_quant_conv = Conv2d(cfg.latent_channels, cfg.latent_channels, 1)

    def encode_moments(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """image (B,H,W,3) in [-1,1] -> (mean, logvar), each (B,H/8,W/8,4) NHWC."""
        moments = self.quant_conv(self.encoder(_nchw(x))).permute(0, 2, 3, 1)
        mean, logvar = moments.chunk(2, dim=-1)
        return mean, torch.clamp(logvar, -30.0, 20.0)

    def encode(self, x: torch.Tensor, noise: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Latent sample ``mean + std * noise`` (the mean when ``noise`` is
        None), without the scaling_factor multiply."""
        mean, logvar = self.encode_moments(x)
        if noise is None:
            return mean
        return mean + torch.exp(0.5 * logvar) * noise.to(mean.dtype)

    def decode(self, z: torch.Tensor) -> torch.Tensor:
        """latents (B,h,w,4) without scaling factor -> image (B,H,W,3) ~[-1,1]."""
        return self.decoder(self.post_quant_conv(_nchw(z))).permute(0, 2, 3, 1)
