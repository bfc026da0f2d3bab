"""Model configuration dataclasses of the PyTorch port.

A copy of ``mvd_tpu/config.py`` (the port imports nothing of the JAX
package): the SD2.1 UNet, VAE, CLIP text tower, camera encoder and
noise-schedule settings, the ``TINY_*`` variants the tests use, the loss,
optimizer, train-loop and data settings, and the YAML loaders. Field names
and defaults are the JAX package's, so a config built for one side
describes the same model on the other. ``UNetConfig.remat`` (read from
``enable_gradient_checkpointing``) checkpoints the UNet's heavy blocks in
training (``nn/unet.py``); ``UNetConfig.num_views`` > 1 is joint multi-view
self-attention; with ``view_axis`` naming the mesh's view axis, a sharded
call (``parallel.py``) runs it as ring attention over the view processes.
PyYAML is imported by the two loaders only, never at import.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any, Dict, Optional, Tuple

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
    # diffusers' Transformer2DModel switch; only the linear projection
    # (SD2.1's) is built, so False raises (the JAX package ignores the field
    # and builds the linear model either way)
    use_linear_projection: bool = True
    norm_num_groups: int = 32
    norm_eps: float = 1e-5
    transformer_layers_per_block: int = 1
    # auto | pallas | xla: exact attention (K1 at every site on the card);
    # int8: the sites the JAX package quantizes on the TPU run K6
    # (kernels/flash_attention.py:int8_site), the others K1. The JAX
    # package's CPU-interpret choices raise here.
    attention_impl: str = "auto"
    # torch.utils.checkpoint around every ResnetBlock and Transformer2D while
    # grad is on; MVD_REMAT_POLICY picks what is saved (nn/unet.py)
    remat: bool = True
    with_adapters: bool = True  # image cross-attention adapters in every attn
    img_ref_scale: float = 0.3  # adapter output scale
    # joint multi-view attention: with num_views > 1 the flat (B*V, S, D)
    # rows (row b*V + v) self-attend over the (V*S) tokens of their group.
    # view_axis names the mesh axis the views are sharded over: inside a
    # sharded call the self-attention of each group runs as ring attention
    # over that axis (nn/layers.py:Attention, kernels/ring_attention.py)
    num_views: int = 1
    view_axis: Optional[str] = None

    def __post_init__(self):
        check_impl(self.attention_impl)
        if not self.use_linear_projection:
            raise ValueError("use_linear_projection=False (1x1-conv projections in Transformer2D) is "
                             "not built: only the linear projection (SD2.1's) is")


TINY_UNET = UNetConfig(
    sample_size=8,
    block_out_channels=(32, 64, 64, 64),
    num_attention_heads=(2, 4, 4, 4),
    cross_attention_dim=64,
    norm_num_groups=8,
    remat=False,
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
    batch_size: int = 6
    grad_accum_steps: int = 1
    max_epochs: int = 25
    max_steps: Optional[int] = None
    image_size: int = 768
    num_views: int = 2
    seed: int = 42
    train_denoising_unet: bool = False
    checkpoint_every_steps: int = 1000
    max_checkpoints: int = 3
    val_check_interval: float = 1.0
    metrics_log_interval: int = 50
    # encode only the unique source view of each (B, V) group and tile the
    # posterior moments to the V rows
    unique_source_encode: bool = True
    log_every_steps: int = 1
    output_dir: str = "outputs"


@dataclass(frozen=True)
class DataConfig:
    dataset_path: str = ""
    # "objaverse" (rendered-zip shards) or "co3d" (CO3D-style sequences)
    dataset_format: str = "objaverse"
    image_size: int = 768
    max_views_per_object: int = 8
    dataset_samples: Optional[int] = None
    num_workers: int = 8
    val_split: float = 0.1
    test_split: float = 0.1
    seed: int = 42
    # precomputed VAE latent-moment cache (cli/precompute_latents.py)
    latent_cache_dir: Optional[str] = None


# ---------------------------------------------------------------------------
# YAML loading: the keys of the reference's config/train_config.yaml mapped
# onto the dataclasses, as mvd_tpu/config.py maps them
# ---------------------------------------------------------------------------


def _get(cfg: Dict[str, Any], *keys, default=None):
    for k in keys:
        if k in cfg:
            return cfg[k]
    return default


def _apply_overrides(cfg, overrides: Optional[Dict[str, Any]]):
    """Replace dataclass fields from a YAML mapping; lists become tuples.
    Unknown keys raise, so a typo'd architecture knob cannot silently train
    the default width."""
    if not overrides:
        return cfg
    valid = {f.name for f in dataclasses.fields(cfg)}
    unknown = set(overrides) - valid
    if unknown:
        raise ValueError(f"unknown {type(cfg).__name__} override keys: {sorted(unknown)}")
    fixed = {k: tuple(v) if isinstance(v, list) else v for k, v in overrides.items()}
    return dataclasses.replace(cfg, **fixed)


def _read_yaml(path: str) -> Dict[str, Any]:
    try:
        import yaml
    except ImportError as e:
        raise SystemExit(
            f"reading {path!r} needs PyYAML, which is not installed; pass the "
            "settings as flags instead"
        ) from e
    with open(path) as f:
        return yaml.safe_load(f) or {}


def train_config_from_yaml(path: str) -> TrainConfig:
    """A reference-style YAML (config/train_config.yaml keys) as a
    TrainConfig: unknown top-level keys are ignored, missing keys keep the
    defaults, ``unet_config`` / ``vae_config`` / ``text_encoder_config``
    override the architecture field by field."""
    raw = _read_yaml(path)
    unet = UNetConfig(
        img_ref_scale=float(_get(raw, "img_ref_scale", default=0.3)),
        with_adapters=bool(_get(raw, "use_image_conditioning", default=True)),
        remat=bool(_get(raw, "enable_gradient_checkpointing", default=True)),
        attention_impl=_get(raw, "attention_impl", default="auto"),
    )
    unet = _apply_overrides(unet, raw.get("unet_config"))
    vae = _apply_overrides(VAEConfig(), raw.get("vae_config"))
    text = _apply_overrides(CLIPTextConfig(), raw.get("text_encoder_config"))
    cam = CameraEncoderConfig(
        output_dim=int(_get(raw, "camera_embedding_dim", "cam_output_dim", default=1024)),
        hidden_dim=int(_get(raw, "camera_hidden_dim", "cam_hidden_dim", default=512)),
        modulation_strength=float(_get(raw, "cam_modulation_strength", default=0.2)),
        simple_encoder=bool(_get(raw, "simple_cam_encoder", default=False)),
    )
    sch_raw = raw.get("scheduler_config", {}) or {}
    sched = SchedulerConfig(
        shift_mode=sch_raw.get("shift_mode", "interpolated"),
        shift_scale=float(sch_raw.get("shift_scale", 6.0)),
        prediction_type=sch_raw.get("prediction_type", "v_prediction"),
        sampler=sch_raw.get("sampler", "ddpm"),
    )
    loss_raw = raw.get("loss_config", {}) or {}
    loss = LossConfig(
        use_snr_loss=bool(loss_raw.get("use_snr_loss", True)),
        snr_gamma=float(loss_raw.get("snr_gamma", 5.0)),
        weighting=loss_raw.get("weighting", "per_sample"),
        feature_matching_weight=float(loss_raw.get("feature_matching_weight", 0.0)),
    )
    opt = OptimizerConfig(
        learning_rate=float(_get(raw, "learning_rate", "lr", default=1e-5)),
        max_grad_norm=float(_get(raw, "max_grad_norm", default=1.0)),
    )
    if text.hidden_size != unet.cross_attention_dim:
        raise ValueError(
            f"text_encoder_config.hidden_size ({text.hidden_size}) must equal "
            f"unet_config.cross_attention_dim ({unet.cross_attention_dim}): the text "
            "context feeds the UNet cross-attention directly"
        )
    model = ModelConfig(
        unet=unet,
        vae=vae,
        text_encoder=text,
        camera_encoder=cam,
        scheduler=sched,
        use_camera_conditioning=bool(_get(raw, "use_camera_conditioning", default=True)),
        use_image_conditioning=bool(_get(raw, "use_image_conditioning", default=True)),
        use_ray_conditioning=bool(_get(raw, "use_ray_conditioning", default=False)),
        ray_fov_deg=float(_get(raw, "ray_fov_deg", default=54.43)),
        dtype="float32" if str(_get(raw, "precision", default="16")) == "32" else "bfloat16",
    )
    return TrainConfig(
        model=model,
        loss=loss,
        optimizer=opt,
        batch_size=int(_get(raw, "batch_size", default=6)),
        grad_accum_steps=int(_get(raw, "accumulate_grad_batches", default=1)),
        max_epochs=int(_get(raw, "max_epochs", "num_epochs", default=25)),
        image_size=int(_get(raw, "image_size", default=768)),
        seed=int(_get(raw, "seed", default=42)),
        train_denoising_unet=bool(_get(raw, "train_denoising_unet", default=False)),
        checkpoint_every_steps=int(_get(raw, "checkpoint_every_steps", default=1000)),
        max_checkpoints=int(_get(raw, "max_checkpoints", default=3)),
        val_check_interval=float(_get(raw, "val_check_interval", default=1.0)),
        metrics_log_interval=int(_get(raw, "metrics_log_interval", default=50)),
    )


def data_config_from_yaml(path: str) -> DataConfig:
    """The dataset settings of the same YAML."""
    raw = _read_yaml(path)
    samples = _get(raw, "dataset_samples", default=None)
    return DataConfig(
        dataset_path=str(_get(raw, "dataset_path", default="") or ""),
        dataset_format=str(_get(raw, "dataset_format", default="objaverse")),
        image_size=int(_get(raw, "image_size", default=768)),
        max_views_per_object=int(_get(raw, "max_views_per_object", default=8)),
        dataset_samples=None if samples is None else int(samples),
        num_workers=int(_get(raw, "num_workers", default=8)),
        seed=int(_get(raw, "seed", default=42)),
        latent_cache_dir=_get(raw, "latent_cache_dir", default=None),
    )
