"""Model configuration dataclasses of the PyTorch port.

A copy of the model and train-step half of ``mvd_tpu/config.py`` (the port
imports nothing of the JAX package): the SD2.1 UNet, VAE, CLIP text tower,
camera encoder and noise-schedule settings, the ``TINY_*`` variants the
tests use, and the loss, optimizer and train settings that the train step
reads. Field names and defaults are the JAX package's, so a config built
for one side describes the same model on the other. Fields of paths the
port does not run yet (remat, joint multi-view attention, the separate
image-encoder UNet, gradient accumulation, checkpointing, validation and
logging intervals, the mesh) are left out until they are ported; so are the
loop's batch, image size, view count and seed (the step takes them from its
batch), the data configs and the YAML loader.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Tuple

from .kernels.flash_attention import check_impl


@dataclass(frozen=True)
class UNetConfig:
    """SD2.1 UNet2DConditionModel architecture
    (stabilityai/stable-diffusion-2-1 unet/config.json values)."""

    sample_size: int = 96
    in_channels: int = 4
    out_channels: int = 4
    block_out_channels: Tuple[int, ...] = (320, 640, 1280, 1280)
    layers_per_block: int = 2
    down_block_types: Tuple[str, ...] = (
        "CrossAttnDownBlock2D",
        "CrossAttnDownBlock2D",
        "CrossAttnDownBlock2D",
        "DownBlock2D",
    )
    up_block_types: Tuple[str, ...] = (
        "UpBlock2D",
        "CrossAttnUpBlock2D",
        "CrossAttnUpBlock2D",
        "CrossAttnUpBlock2D",
    )
    num_attention_heads: Tuple[int, ...] = (5, 10, 20, 20)
    cross_attention_dim: int = 1024
    norm_num_groups: int = 32
    norm_eps: float = 1e-5
    transformer_layers_per_block: int = 1
    # auto | pallas | xla: exact attention (K1 at every site on the card);
    # int8: the sites the JAX package quantizes on the TPU run K6
    # (kernels/flash_attention.py:int8_site), the others K1. The JAX
    # package's CPU-interpret choices raise here.
    attention_impl: str = "auto"
    with_adapters: bool = True  # image cross-attention adapters in every attn
    img_ref_scale: float = 0.3  # adapter output scale

    def __post_init__(self):
        check_impl(self.attention_impl)


TINY_UNET = UNetConfig(
    sample_size=8,
    block_out_channels=(32, 64, 64, 64),
    num_attention_heads=(2, 4, 4, 4),
    cross_attention_dim=64,
    norm_num_groups=8,
)


@dataclass(frozen=True)
class VAEConfig:
    """SD AutoencoderKL (stabilityai/stable-diffusion-2-1 vae/config.json)."""

    in_channels: int = 3
    out_channels: int = 3
    latent_channels: int = 4
    block_out_channels: Tuple[int, ...] = (128, 256, 512, 512)
    layers_per_block: int = 2
    norm_num_groups: int = 32
    scaling_factor: float = 0.18215
    sample_size: int = 768


TINY_VAE = VAEConfig(block_out_channels=(16, 32, 32, 32), norm_num_groups=8, sample_size=64)


@dataclass(frozen=True)
class CLIPTextConfig:
    """OpenCLIP ViT-H/14 text tower as shipped with SD2.1 (23 hidden layers:
    the penultimate-layer cut is baked into the checkpoint)."""

    vocab_size: int = 49408
    hidden_size: int = 1024
    num_layers: int = 23
    num_heads: int = 16
    intermediate_size: int = 4096
    max_length: int = 77
    layer_norm_eps: float = 1e-5
    hidden_act: str = "gelu"


TINY_CLIP = CLIPTextConfig(
    vocab_size=1000, hidden_size=64, num_layers=2, num_heads=4, intermediate_size=128
)


@dataclass(frozen=True)
class CameraEncoderConfig:
    """Camera encoder hyper-parameters."""

    output_dim: int = 1024
    hidden_dim: int = 512
    max_freq: float = 10.0
    modulation_strength: float = 0.2
    simple_encoder: bool = False

    @property
    def pos_enc_dim(self) -> int:
        return (self.output_dim // 2) // 3


@dataclass(frozen=True)
class SchedulerConfig:
    """Noise schedule: SD2.1's scaled-linear betas with the interpolated
    SNR shift (scale 6.0), v-prediction, leading timestep spacing."""

    num_train_timesteps: int = 1000
    beta_schedule: str = "scaled_linear"
    beta_start: float = 0.00085
    beta_end: float = 0.012
    prediction_type: str = "v_prediction"
    shift_mode: str = "interpolated"  # none | default | interpolated
    shift_scale: float = 6.0
    sampler: str = "ddpm"  # ddpm | ddim | dpmpp_2m
    steps_offset: int = 1
    timestep_spacing: str = "leading"


@dataclass(frozen=True)
class ModelConfig:
    unet: UNetConfig = field(default_factory=UNetConfig)
    vae: VAEConfig = field(default_factory=VAEConfig)
    text_encoder: CLIPTextConfig = field(default_factory=CLIPTextConfig)
    camera_encoder: CameraEncoderConfig = field(default_factory=CameraEncoderConfig)
    scheduler: SchedulerConfig = field(default_factory=SchedulerConfig)
    use_camera_conditioning: bool = True
    use_image_conditioning: bool = True
    # Per-pixel Plücker ray map of the target view in the source frame,
    # concatenated to the UNet's input channels (camera.py:plucker_ray_map);
    # conv_in takes 6 more channels, zero-padded from checkpoints trained
    # without them (checkpoint/torch_convert.py:zero_pad_conv_in)
    use_ray_conditioning: bool = False
    ray_fov_deg: float = 54.43  # render rig: 35 mm lens, 36 mm sensor
    # Initialize adapter q/k/v/out from the frozen base attention at
    # construction. Applies to fresh inits only.
    adapter_init_from_frozen: bool = True
    dtype: str = "bfloat16"  # compute dtype; params always float32


TINY_MODEL = ModelConfig(
    unet=TINY_UNET,
    vae=TINY_VAE,
    text_encoder=TINY_CLIP,
    camera_encoder=CameraEncoderConfig(output_dim=48, hidden_dim=32),
    dtype="float32",
)


@dataclass(frozen=True)
class LossConfig:
    use_snr_loss: bool = True
    snr_gamma: float = 5.0
    # "per_sample" applies the Min-SNR weights per sample; "faithful"
    # reproduces the reference's scalar_mse * mean(w)
    weighting: str = "per_sample"
    # frozen-UNet feature matching of x0-hat against the target; 0 = off
    feature_matching_weight: float = 0.0


@dataclass(frozen=True)
class OptimizerConfig:
    learning_rate: float = 1e-5
    betas: Tuple[float, float] = (0.9, 0.999)
    weight_decay: float = 0.01
    max_grad_norm: float = 1.0
    warmup_fraction: float = 0.05
    schedule: str = "cosine"  # cosine | constant


@dataclass(frozen=True)
class TrainConfig:
    model: ModelConfig = field(default_factory=ModelConfig)
    loss: LossConfig = field(default_factory=LossConfig)
    optimizer: OptimizerConfig = field(default_factory=OptimizerConfig)
    train_denoising_unet: bool = False
    # encode only the unique source view of each (B, V) group and tile the
    # posterior moments to the V rows
    unique_source_encode: bool = True
