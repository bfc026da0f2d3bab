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
bottleneck input).

Remat (``UNetConfig.remat``, the JAX package's ``nn.remat`` of the heavy
blocks): while grad is on, every ResnetBlock and Transformer2D runs under
``torch.utils.checkpoint`` (non-reentrant), so the backward recomputes it
from its inputs. ``MVD_REMAT_POLICY`` says what the recompute may keep, as
in the JAX package (``mvd_tpu/nn/unet.py:_remat_policy``): ``flash_conv``
(default) saves each flash forward's (out, lse) and the two 3x3 conv outputs
(bias included) of every ResnetBlock, ``flash`` only the former,
``flash_conv_dots`` also every matmul output, ``none`` nothing. The flash
forward (its custom operator, ``kernels/flash_attention.py:flash_fwd_op``)
and the convs (``layers.kept_conv``) keep their outputs on the block's tape
(``mvd_tpu_torch/remat.py``), so K1 never runs again in a backward;
everything else, K2's GroupNorms included, runs again. Without grad
(generation, the frozen feature pass) no checkpoint is entered.
"""

from __future__ import annotations

import functools
import os
from typing import Dict, Optional, Tuple

import torch
import torch.nn as nn
from torch.utils.checkpoint import CheckpointPolicy, checkpoint, create_selective_checkpoint_contexts

from .. import remat
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


REMAT_POLICIES = ("flash_conv", "flash", "flash_conv_dots", "none")
_MATMULS = ("mm", "addmm", "bmm", "baddbmm")


def remat_context(mode: Optional[str] = None):
    """The checkpoint ``context_fn`` of ``mode`` (default: the
    ``MVD_REMAT_POLICY`` environment variable, else ``flash_conv``), or None
    for ``none``: recompute everything. ``flash`` and ``flash_conv`` keep
    their outputs on the block's tape (``mvd_tpu_torch/remat.py``);
    ``flash_conv_dots``, which also keeps every matmul output, is PyTorch's
    selective checkpointing."""
    mode = mode or os.environ.get("MVD_REMAT_POLICY", "flash_conv")
    if mode not in REMAT_POLICIES:
        raise ValueError(f"MVD_REMAT_POLICY={mode!r}: expected one of {REMAT_POLICIES}")
    if mode == "none":
        return None
    if mode != "flash_conv_dots":
        return functools.partial(remat.tape_contexts, convs=mode == "flash_conv")
    aten = torch.ops.aten
    save = {torch.ops.mvd_tpu_torch.flash_fwd.default} | {getattr(aten, n).default for n in _MATMULS}

    def policy(ctx, op, *args, **kwargs):
        # inside a remat'd block the only 3x3 convolutions are a
        # ResnetBlock's conv1 and conv2 (the shortcut is 1x1)
        if op in save or (op is aten.convolution.default and args[1].shape[-2:] == (3, 3)):
            return CheckpointPolicy.MUST_SAVE
        return CheckpointPolicy.PREFER_RECOMPUTE

    return functools.partial(create_selective_checkpoint_contexts, policy)


def _remat(block: nn.Module, context_fn, *args):
    """``block(*args)`` under a non-reentrant checkpoint with ``context_fn``
    (None: recompute everything). The blocks draw no random numbers, so the
    RNG state is not saved."""
    kwargs = {} if context_fn is None else {"context_fn": context_fn}
    return checkpoint(block, *args, use_reentrant=False, preserve_rng_state=False, **kwargs)


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
                cfg.attention_impl, cfg.num_views, cfg.view_axis,
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

        if cfg.remat and torch.is_grad_enabled():
            context_fn = remat_context()
            run = lambda block, *args: _remat(block, context_fn, *args)
        else:
            run = lambda block, *args: block(*args)

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
                    h = run(getattr(self, f"down_{i}_resnet_{j}"), h, temb)
                    if block_type == "CrossAttnDownBlock2D":
                        fname = f"down_block_{i}_attn_{j}"
                        h = run(getattr(self, f"down_{i}_attn_{j}"), h, ctx, get_ref(fname), ref_scale)
                        features[fname] = nhwc(h)
                    residuals.append(h)
                if i < len(cfg.down_block_types) - 1:
                    h = getattr(self, f"down_{i}_downsample")(h)
                    residuals.append(h)
                h = apply_film(h, film, f"down_{i}")
        cache = (tuple(residuals), h)

        h = run(self.mid_resnet_0, h, temb)
        h = run(self.mid_attn_0, h, ctx, get_ref("mid_block_attn_0"), ref_scale)
        features["mid_block_attn_0"] = nhwc(h)
        h = run(self.mid_resnet_1, h, temb)
        h = apply_film(h, film, "mid")

        for i, block_type in enumerate(cfg.up_block_types):
            for j in range(cfg.layers_per_block + 1):
                h = torch.cat([h, residuals.pop().to(h.dtype)], dim=1)
                h = run(getattr(self, f"up_{i}_resnet_{j}"), h, temb)
                if block_type == "CrossAttnUpBlock2D":
                    fname = f"up_block_{i}_attn_{j}"
                    h = run(getattr(self, f"up_{i}_attn_{j}"), h, ctx, get_ref(fname), ref_scale)
                    features[fname] = nhwc(h)
            if i < len(cfg.up_block_types) - 1:
                h = getattr(self, f"up_{i}_upsample")(h)
            h = apply_film(h, film, f"up_{i}")

        out = nhwc(self.conv_out(self.conv_norm_out(h))).float()
        if return_encoder_cache:
            return out, features, cache
        return out, features
