"""Hand-written Hopper kernels of the port, each beside its plain version."""

from .flash_attention import (  # noqa: F401
    FlashAttention,
    attention_packed,
    attention_packed_bwd_plain,
    attention_packed_plain,
    flash_attention_packed_bwd,
    flash_attention_packed_bwd_dkv,
    flash_attention_packed_bwd_dq,
    flash_attention_packed_fwd,
)
from .groupnorm_silu import (  # noqa: F401
    GroupNormSiLU,
    groupnorm_silu,
    groupnorm_silu_diff,
    groupnorm_silu_plain,
    groupnorm_silu_vjp,
)

# kernel -> the wrapper that launches it and counts its launches
KERNELS = {
    "flash_attn_fwd": flash_attention_packed_fwd,
    "flash_attn_bwd_dq": flash_attention_packed_bwd_dq,
    "flash_attn_bwd_dkv": flash_attention_packed_bwd_dkv,
    "groupnorm_silu": groupnorm_silu,
}
# source name under csrc/ -> the kernels it holds
KERNEL_SOURCES = {
    "flash_attn_fwd": ("flash_attn_fwd",),
    "flash_attn_bwd": ("flash_attn_bwd_dq", "flash_attn_bwd_dkv"),
    "groupnorm_silu": ("groupnorm_silu",),
}
