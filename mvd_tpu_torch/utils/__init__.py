from .images import load_image, save_image, side_by_side, to_uint8  # noqa: F401
