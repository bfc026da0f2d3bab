"""The train step of the port: losses, train state and the step itself."""

from .losses import feature_matching_loss, noise_loss, reconstruction_metrics  # noqa: F401
from .state import (  # noqa: F401
    TRAINABLE_MARKERS,
    TrainState,
    count_params,
    make_lr_schedule,
    trainable_mask,
)
from .step import (  # noqa: F401
    GRAD_GROUPS,
    film_stats,
    grad_group_norms,
    grad_group_samples,
    make_eval_fn,
    make_loss_fn,
    make_train_step,
)
