"""Hand-written Hopper kernels of the port, each beside its plain version."""

from .flash_attention import (  # noqa: F401
    attention_packed,
    attention_packed_plain,
    flash_attention_packed_fwd,
)
from .groupnorm_silu import groupnorm_silu, groupnorm_silu_plain  # noqa: F401

# source name under csrc/ -> the wrapper that launches it
KERNEL_SOURCES = {
    "flash_attn_fwd": flash_attention_packed_fwd,
    "groupnorm_silu": groupnorm_silu,
}
