"""Image metrics and the validation harness of the port."""

from .image import psnr, psnr_per_image, ssim  # noqa: F401
