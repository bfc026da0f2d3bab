from .adapter_init import init_adapters_from_frozen  # noqa: F401
from .camera_encoder import CameraEncoder, modulation_dims  # noqa: F401
from .clip_text import CLIPTextEncoder  # noqa: F401
from .mvd_unet import MultiViewUNet  # noqa: F401
from .unet import UNet2DCondition  # noqa: F401
from .vae import AutoencoderKL  # noqa: F401
