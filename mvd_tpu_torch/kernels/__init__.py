"""Hand-written Hopper kernels of the port, each beside its plain version.

The attention entry points mirror the JAX kernels package
(``mvd_tpu/kernels/__init__.py``: ``attention``, ``flash_attention``,
``xla_attention``) plus the packed and int8 functions the model calls.
"""

from .flash_attention import (  # noqa: F401
    ATTENTION_IMPLS,
    FLASH_KINDS,
    attention,
    attention_int8_core_plain,
    attention_packed,
    attention_packed_bwd_plain,
    attention_packed_int8_plain,
    attention_packed_plain,
    attention_plain,
    check_impl,
    flash_attention,
    flash_attention_fwd,
    flash_attention_packed_bwd,
    flash_attention_packed_bwd_dkv,
    flash_attention_packed_bwd_dq,
    flash_attention_packed_fwd,
    flash_attention_packed_int8,
    flash_attention_packed_int8_fwd,
    flash_fwd_op,
    int8_site,
    int8_tiles,
    quantize_channels,
    quantize_heads,
    quantize_int8,
    quantize_int8_plain,
    quantize_rows,
    smooth_k,
    xla_attention,
)
from .ring_attention import (  # noqa: F401
    ring_attention_packed,
    ring_attention_virtual_bwd,
    ring_attention_virtual_fwd,
    ring_merge,
    ring_merge_plain,
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
    "flash_attn_fwd": flash_attention_packed_fwd,  # K1
    "flash_attn_fwd_bhsd": flash_attention_fwd,  # K5
    "flash_attn_bwd_dq": flash_attention_packed_bwd_dq,  # K3a, both layouts
    "flash_attn_bwd_dkv": flash_attention_packed_bwd_dkv,  # K3b, both layouts
    "flash_attn_int8": flash_attention_packed_int8_fwd,  # K6
    "quantize_int8": quantize_int8,  # K6q
    "groupnorm_silu": groupnorm_silu,  # K2
    "ring_merge": ring_merge,  # K4m, the merge of ring attention (K4)
}
# source name under csrc/ -> the kernels it holds
KERNEL_SOURCES = {
    "flash_attn_fwd": ("flash_attn_fwd", "flash_attn_fwd_bhsd"),
    "flash_attn_bwd": ("flash_attn_bwd_dq", "flash_attn_bwd_dkv"),
    "flash_attn_int8": ("flash_attn_int8",),
    "quantize_int8": ("quantize_int8",),
    "groupnorm_silu": ("groupnorm_silu",),
    "ring_merge": ("ring_merge",),
}
# the host C++ under csrc/ (<name>.cpp, built with c++): the JPEG decoder, the
# PNG scanline decoder, the WebP, GIF, BMP and TIFF decoders, the RLE and QOI
# decoders of PIL's small formats and the BCn decoder of DDS, the native
# Objaverse reader and the zstd decoder of the orbax checkpoint reader
HOST_SOURCES = ("jpeg_decode", "png_decode", "webp_decode", "gif_decode", "bmp_decode", "tiff_decode", "small_decode",
                "bcn_decode", "native_reader", "zstd_decode")
