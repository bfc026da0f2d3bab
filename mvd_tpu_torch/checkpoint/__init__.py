from .io import (  # noqa: F401
    CheckpointManager,
    load_component,
    load_params,
    load_params_into,
    peek_checkpoint_meta,
    resolve_resume_path,
    save_params,
)
from .from_jax import (  # noqa: F401
    carry_jax_train_state,
    convert_jax_params,
    export_jax_params,
    load_jax_params,
    load_jax_train_state,
)
from .orbax_read import is_orbax_dir, is_orbax_step, orbax_steps, read_step, read_tree  # noqa: F401
from .torch_convert import (  # noqa: F401
    convert_camera_encoder_state_dict,
    convert_clip_text_state_dict,
    convert_lightning_checkpoint,
    convert_unet_state_dict,
    convert_vae_state_dict,
    export_lightning_state_dict,
    export_unet_state_dict,
    load_checkpoint,
    split_lightning_state_dict,
    zero_pad_conv_in,
)
