from .images import load_image, save_image, side_by_side, to_uint8  # noqa: F401
from .logging import (  # noqa: F401
    MetricLogger,
    check_finite,
    create_output_dirs,
    enable_nan_debugging,
    log_debug,
    reuse_output_dirs,
)
