"""Building blocks of the SD2.1-class UNet and VAE in PyTorch.

Counterparts of ``mvd_tpu/nn/layers.py``. Parameter names follow the flax
paths (``norm1.weight`` for ``norm1/scale``), so the JAX package's params
carry across mechanically (``checkpoint/from_jax.py``).

Layout: activations are NCHW tensors in ``torch.channels_last`` memory, so
the NHWC views that the GroupNorm kernel and the attention projections take
are free permutes. ``Linear`` and ``Conv2d`` compute in their
``compute_dtype``, by default their weight's dtype (the sampling pipeline
pre-casts a bf16 copy of the params). ``set_compute_dtype`` sets it on a
whole tree for training: input, weight and bias are then cast to it by a
differentiable cast, as flax's ``Dense(dtype=bf16)`` does with f32 params,
so the f32 master weights receive f32 gradients.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from .. import remat
from ..kernels.flash_attention import attention_packed
from ..kernels.groupnorm_silu import groupnorm_silu_diff
from ..kernels.ring_attention import ring_attention_packed
from ..mesh import bound_axis, bound_mesh
from ..tensor_parallel import Shards, each


class _ComputeDtype:
    """``compute_dtype`` (None: the weight's dtype) for a module with
    ``weight`` and ``bias``."""

    compute_dtype: Optional[torch.dtype] = None

    @property
    def dtype(self) -> torch.dtype:
        return self.compute_dtype or self.weight.dtype

    def _weights(self):
        """(weight, bias) in the compute dtype; uncast on the sampling path,
        which sets no compute dtype."""
        dt = self.compute_dtype
        if dt is None:
            return self.weight, self.bias
        return self.weight.to(dt), None if self.bias is None else self.bias.to(dt)


class Linear(_ComputeDtype, nn.Linear):
    """``nn.Linear`` computing in its compute dtype."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w, b = self._weights()
        return F.linear(x.to(w.dtype), w, b)


class Conv2d(_ComputeDtype, nn.Conv2d):
    """``nn.Conv2d`` computing in its compute dtype."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w, b = self._weights()
        return self._conv_forward(x.to(w.dtype), w, b)


def set_compute_dtype(module: nn.Module, dtype: Optional[torch.dtype]) -> nn.Module:
    """Set the compute dtype of every ``Linear`` and ``Conv2d`` under
    ``module`` (None: back to each weight's dtype); returns ``module``."""
    for m in module.modules():
        if isinstance(m, (Linear, Conv2d)):
            m.compute_dtype = dtype
    return module


class LayerNorm(nn.Module):
    """flax ``nn.LayerNorm(dtype=float32)``: f32 compute and f32 output.
    The default eps is flax's 1e-6, not torch's 1e-5."""

    def __init__(self, dim: int, eps: float = 1e-6):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.layer_norm(
            x.float(), (x.shape[-1],), self.weight.float(), self.bias.float(), self.eps
        )


class StreamingLayerNorm(nn.Module):
    """LayerNorm of the transformer blocks (eps 1e-5), in the input dtype
    with f32 statistics (PyTorch's layer norm accumulates in f32)."""

    def __init__(self, dim: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.layer_norm(
            x, (x.shape[-1],), self.weight.to(x.dtype), self.bias.to(x.dtype), self.eps
        )


def timestep_embedding(
    timesteps: torch.Tensor,
    dim: int,
    flip_sin_to_cos: bool = True,
    downscale_freq_shift: float = 0.0,
    max_period: float = 10000.0,
) -> torch.Tensor:
    """Sinusoidal timestep embedding (diffusers ``get_timestep_embedding``;
    SD uses flip_sin_to_cos=True, freq_shift=0), f32."""
    half = dim // 2
    exponent = -math.log(max_period) * torch.arange(
        half, dtype=torch.float32, device=timesteps.device
    )
    exponent = exponent / (half - downscale_freq_shift)
    emb = timesteps.float()[:, None] * torch.exp(exponent)[None, :]
    sin, cos = torch.sin(emb), torch.cos(emb)
    if flip_sin_to_cos:
        return torch.cat([cos, sin], dim=-1)
    return torch.cat([sin, cos], dim=-1)


class TimestepEmbedMLP(nn.Module):
    """time_embedding: Linear -> SiLU -> Linear (320 -> 1280 -> 1280)."""

    def __init__(self, in_dim: int, dim: int):
        super().__init__()
        self.linear_1 = Linear(in_dim, dim)
        self.linear_2 = Linear(dim, dim)

    def forward(self, x):
        return self.linear_2(each(F.silu, self.linear_1(x)))


class GroupNorm(nn.Module):
    """GroupNorm with f32 statistics, optionally fused with the SiLU that
    follows it; runs the K2 kernel on CUDA tensors."""

    def __init__(self, num_groups: int, channels: int, eps: float = 1e-5, fuse_silu: bool = False):
        super().__init__()
        self.num_groups = num_groups
        self.eps = eps
        self.fuse_silu = fuse_silu
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x: NCHW (any memory format) -> NCHW in channels_last memory."""
        nhwc = x.contiguous(memory_format=torch.channels_last).permute(0, 2, 3, 1)
        y = groupnorm_silu_diff(
            nhwc, self.weight, self.bias, self.num_groups, self.eps, self.fuse_silu
        )
        return y.permute(0, 3, 1, 2)


def normalize_ref_feature(feat: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """Adapter K/V pre-normalization on an NHWC feature: unbiased std over
    (batch, channel), clamped at ``eps``, times 0.5; f32, no gradient.

    Inside a sharded train step (a mesh bound by ``Mesh.bind``) the batch is
    the mesh's global batch: the sums over this rank's rows are summed over
    the mesh (two all-reduces), so each rank normalizes as the unsharded
    step does. The JAX package's data-parallel step gets the same from
    GSPMD; its view-sharded step, inside ``shard_map``, takes each shard's
    own statistics."""
    feat = feat.detach().float()
    mesh = bound_mesh()
    spread = mesh is not None and mesh.group_size > 1
    n = feat.shape[0] * feat.shape[3] * (mesh.group_size if spread else 1)

    def summed(x):
        x = x.sum(dim=(0, 3), keepdim=True)
        if spread:
            torch.distributed.all_reduce(x, group=mesh.group)
        return x

    mean = summed(feat) / n
    var = summed((feat - mean) ** 2) / max(n - 1, 1)
    std = torch.clamp(torch.sqrt(var), min=eps)
    return (feat - mean) / std * 0.5


class CrossViewAdapter(nn.Module):
    """Image cross-attention adapter: queries from the view's normed hidden
    states, keys/values from the frozen feature pass (or precomputed K/V).
    Model-sharded (``parallel.shard_params_model_parallel``), each shard
    attends over its own heads."""

    def __init__(self, dim: int, heads: int, head_dim: int, attention_impl: str = "auto"):
        super().__init__()
        self.heads = heads
        self.head_dim = head_dim
        self.attention_impl = attention_impl
        inner = heads * head_dim
        self.to_q_ref = Linear(dim, inner, bias=False)
        self.to_k_ref = Linear(dim, inner, bias=False)
        self.to_v_ref = Linear(dim, inner, bias=False)
        self.to_out_ref = Linear(inner, dim)

    def forward(self, hidden: torch.Tensor, ref) -> torch.Tensor:
        """``ref``: normalized features (B, Sk, C), or a precomputed (k, v)
        pair of packed (B, Sk, H*head_dim) projections (their shards where
        the adapter is model-sharded)."""
        q = self.to_q_ref(hidden)
        if isinstance(ref, tuple):
            # the compute dtype (q's), never the f32 the features carry
            dtype = (q[0] if isinstance(q, Shards) else q).dtype
            k, v = (each(lambda t: t.to(dtype), t) for t in ref)
        else:
            ref = ref.to(hidden.dtype)
            k, v = self.to_k_ref(ref), self.to_v_ref(ref)
        attend = lambda q, k, v: attention_packed(q, k, v, q.shape[-1] // self.head_dim,
                                                  impl=self.attention_impl)
        return self.to_out_ref(each(attend, q, k, v))


class Attention(nn.Module):
    """Multi-head attention, self (context=None) or cross, on the packed
    layout.

    Joint multi-view self-attention: with ``num_views`` V > 1 the flat
    (B*V, S, H*D) rows (row b*V + v) are regrouped into (B, V*S, H*D) by a
    free reshape, so every view attends to every other view's tokens of its
    group. Cross-attention stays per row. With ``view_axis`` named and bound
    by a sharded call (``mesh.Mesh.bind``, ``parallel.py``), the rows are
    this rank's V_local = V / (view processes) views of each group, and the
    packed (B, V_local*S, H*D) shards go straight into ring attention
    (``kernels/ring_attention.py``), exact at every hop whatever
    ``attention_impl`` says, as in JAX. Outside a sharded call the same
    module attends over whole groups on one device, as the JAX package's
    unsharded twin of a view-sharded model does. Model-sharded
    (``parallel.shard_params_model_parallel``), the projections give each
    shard its own heads, attention (K1) runs on them shard by shard, and
    the output projection sums the shards; a view axis and a model axis
    together raise."""

    def __init__(self, dim: int, heads: int, head_dim: int, context_dim: Optional[int] = None,
                 attention_impl: str = "auto", num_views: int = 1, view_axis: Optional[str] = None):
        super().__init__()
        self.heads = heads
        self.head_dim = head_dim
        self.attention_impl = attention_impl
        self.num_views = num_views
        self.view_axis = view_axis
        inner = heads * head_dim
        ctx = dim if context_dim is None else context_dim
        self.to_q = Linear(dim, inner, bias=False)
        self.to_k = Linear(ctx, inner, bias=False)
        self.to_v = Linear(ctx, inner, bias=False)
        self.to_out = Linear(inner, dim)

    def forward(self, hidden: torch.Tensor, context: Optional[torch.Tensor] = None):
        ctx = hidden if context is None else context.to(hidden.dtype)
        q, k, v = self.to_q(hidden), self.to_k(ctx), self.to_v(ctx)
        # on q's heads: a shard's, model-sharded
        attend = lambda q, k, v: attention_packed(q, k, v, q.shape[-1] // self.head_dim,
                                                  impl=self.attention_impl)
        V = self.num_views
        if context is None and V > 1:
            B, S, _ = hidden.shape
            axis = bound_axis(self.view_axis) if self.view_axis is not None else None
            if axis is not None:
                if isinstance(q, Shards):
                    raise NotImplementedError(
                        "joint attention over a view axis with model-sharded projections: the "
                        "JAX package does not shard a view axis and a model axis together")
                if V % axis.size:
                    raise ValueError(f"{V} views do not divide over the {axis.size} processes of "
                                     f"mesh axis {self.view_axis!r}")
                V //= axis.size  # local views per shard
            if B % V:
                raise ValueError(f"joint attention over {V} views needs a batch that {V} "
                                 f"divides, got {B} rows")
            merge = lambda t: t.reshape(B // V, V * S, t.shape[-1])
            if axis is not None:
                out = ring_attention_packed(merge(q), merge(k), merge(v), self.heads, self.view_axis)
                out = out.reshape(B, S, -1)
            else:
                out = each(lambda q, k, v: attend(merge(q), merge(k), merge(v)).reshape(B, S, -1), q, k, v)
        else:
            out = each(attend, q, k, v)
        return self.to_out(out)


def _geglu(h: torch.Tensor) -> torch.Tensor:
    a, gate = h.chunk(2, dim=-1)
    return a * F.gelu(gate, approximate="tanh")


class FeedForward(nn.Module):
    """GEGLU feed-forward (dim -> 4*dim gated -> dim). The gate is flax's
    default ``nn.gelu``: the tanh approximation. Model-sharded, each shard
    of ``proj_geglu`` holds matching parts of ``a`` and ``gate``."""

    def __init__(self, dim: int, mult: int = 4):
        super().__init__()
        inner = dim * mult
        self.proj_geglu = Linear(dim, inner * 2)
        self.proj_out = Linear(inner, dim)

    def forward(self, x):
        return self.proj_out(each(_geglu, self.proj_geglu(x)))


class BasicTransformerBlock(nn.Module):
    """LN -> self-attn, LN -> cross-attn, LN -> GEGLU FF, each residual; with
    adapters, ``ref_scale`` times the adapter output joins the attention
    output before the residual add."""

    def __init__(self, dim, heads, head_dim, context_dim, with_adapters=False, ref_scale=0.3,
                 attention_impl="auto", num_views=1, view_axis=None):
        super().__init__()
        self.with_adapters = with_adapters
        self.ref_scale = ref_scale
        self.norm1 = StreamingLayerNorm(dim)
        self.attn1 = Attention(dim, heads, head_dim, attention_impl=attention_impl,
                               num_views=num_views, view_axis=view_axis)
        self.norm2 = StreamingLayerNorm(dim)
        self.attn2 = Attention(dim, heads, head_dim, context_dim, attention_impl)
        if with_adapters:
            self.adapter_self = CrossViewAdapter(dim, heads, head_dim, attention_impl)
            self.adapter_cross = CrossViewAdapter(dim, heads, head_dim, attention_impl)
        self.norm3 = StreamingLayerNorm(dim)
        self.ff = FeedForward(dim)

    def forward(self, x, context, ref=None, ref_scale=None):
        scale = self.ref_scale if ref_scale is None else ref_scale
        # per-layer ref: raw features shared by both adapters, or a
        # {"self": (k, v), "cross": (k, v)} dict of precomputed projections
        if isinstance(ref, dict):
            ref_self, ref_cross = ref.get("self"), ref.get("cross")
        else:
            ref_self = ref_cross = ref

        h = self.norm1(x)
        a = self.attn1(h)
        if self.with_adapters and ref_self is not None:
            a = a + scale * self.adapter_self(h, ref_self)
        x = x + a

        h = self.norm2(x)
        a = self.attn2(h, context)
        if self.with_adapters and ref_cross is not None:
            a = a + scale * self.adapter_cross(h, ref_cross)
        x = x + a

        return x + self.ff(self.norm3(x))


class Transformer2D(nn.Module):
    """diffusers Transformer2DModel with use_linear_projection=True:
    GroupNorm (eps 1e-6) -> linear proj_in -> blocks -> proj_out -> residual."""

    def __init__(self, channels, heads, head_dim, context_dim, num_layers=1,
                 norm_num_groups=32, with_adapters=False, ref_scale=0.3, attention_impl="auto",
                 num_views=1, view_axis=None):
        super().__init__()
        inner = heads * head_dim
        self.num_layers = num_layers
        self.norm = GroupNorm(norm_num_groups, channels, 1e-6)
        self.proj_in = Linear(channels, inner)
        for i in range(num_layers):
            setattr(self, f"transformer_blocks_{i}", BasicTransformerBlock(
                inner, heads, head_dim, context_dim, with_adapters, ref_scale, attention_impl,
                num_views, view_axis,
            ))
        self.proj_out = Linear(inner, channels)

    def forward(self, x, context, ref=None, ref_scale=None):
        B, C, H, W = x.shape
        h = self.norm(x).permute(0, 2, 3, 1).reshape(B, H * W, C)
        h = self.proj_in(h)
        for i in range(self.num_layers):
            h = getattr(self, f"transformer_blocks_{i}")(h, context, ref, ref_scale)
        h = self.proj_out(h)
        return h.reshape(B, H, W, C).permute(0, 3, 1, 2) + x


def conv3x3(in_ch: int, out_ch: int) -> Conv2d:
    """3x3 stride-1 SAME conv (the JAX package's ``Conv3x3``/``nn.Conv``)."""
    return Conv2d(in_ch, out_ch, 3, padding=1)


class _KeptConv(torch.autograd.Function):
    """A conv whose output the forward kept (``mvd_tpu_torch/remat.py``):
    its value from the tape, its backward the conv's own
    (``convolution_backward``, called as autograd calls it), saving the
    tensors the conv saves, input then weight."""

    @staticmethod
    def forward(ctx, x, w, b, kept, conv):
        ctx.save_for_backward(x, w)
        ctx.conv, ctx.has_bias = conv, b is not None
        return kept.detach()

    @staticmethod
    def backward(ctx, grad):
        x, w = ctx.saved_tensors
        c = ctx.conv
        dx, dw, db = torch.ops.aten.convolution_backward(
            grad, x, w, [w.shape[0]] if ctx.has_bias else None, c.stride, c.padding, c.dilation,
            False, [0, 0], c.groups, list(ctx.needs_input_grad[:3]))
        return dx, dw, db, None, None


def kept_conv(conv: Conv2d, x: torch.Tensor) -> torch.Tensor:
    """``conv(x)``; inside a remat'd block whose tape keeps conv outputs the
    forward keeps the output and the recompute takes it back instead of
    running the conv again, as the JAX package's ``conv_out`` is saved."""
    tape = remat.active()
    if tape is None or not tape.convs:
        return conv(x)
    if not tape.replaying:
        out = conv(x)
        tape.keep(out.detach())
        return out
    w, b = conv._weights()
    return _KeptConv.apply(x.to(w.dtype), w, b, tape.take(), conv)


class ResnetBlock(nn.Module):
    """SD ResnetBlock2D: GroupNorm+SiLU, 3x3 convs, additive time embedding,
    1x1 shortcut on channel change."""

    def __init__(self, in_ch, out_ch, norm_num_groups=32, norm_eps=1e-5, temb_dim=None):
        super().__init__()
        self.norm1 = GroupNorm(norm_num_groups, in_ch, norm_eps, fuse_silu=True)
        self.conv1 = conv3x3(in_ch, out_ch)
        if temb_dim is not None:
            self.time_emb_proj = Linear(temb_dim, out_ch)
        self.norm2 = GroupNorm(norm_num_groups, out_ch, norm_eps, fuse_silu=True)
        self.conv2 = conv3x3(out_ch, out_ch)
        if in_ch != out_ch:
            self.conv_shortcut = Conv2d(in_ch, out_ch, 1)

    def forward(self, x, temb=None):
        h = kept_conv(self.conv1, self.norm1(x))
        if temb is not None and hasattr(self, "time_emb_proj"):
            t = self.time_emb_proj(F.silu(temb))
            h = h + t[:, :, None, None].to(h.dtype)
        h = kept_conv(self.conv2, self.norm2(h))
        if hasattr(self, "conv_shortcut"):
            x = self.conv_shortcut(x)
        return x + h


class Downsample(nn.Module):
    """3x3 stride-2 conv; ``asymmetric_pad`` is the VAE encoder's
    (0,1)x(0,1) padding, the UNet pads 1 on every side."""

    def __init__(self, in_ch, out_ch, asymmetric_pad=False):
        super().__init__()
        self.asymmetric_pad = asymmetric_pad
        self.conv = Conv2d(in_ch, out_ch, 3, stride=2, padding=0 if asymmetric_pad else 1)

    def forward(self, x):
        if self.asymmetric_pad:
            x = F.pad(x, (0, 1, 0, 1)).contiguous(memory_format=torch.channels_last)
        return self.conv(x)


class Upsample(nn.Module):
    """Nearest x2 then 3x3 conv (the JAX package folds the two into one
    transposed conv for the TPU's layouts; the math is the same)."""

    def __init__(self, in_ch, out_ch):
        super().__init__()
        self.conv = conv3x3(in_ch, out_ch)

    def forward(self, x):
        return self.conv(F.interpolate(x, scale_factor=2.0, mode="nearest"))
