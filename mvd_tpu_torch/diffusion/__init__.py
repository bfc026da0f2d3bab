from .schedules import (  # noqa: F401
    NoiseSchedule,
    add_noise,
    compute_snr,
    ddpm_step,
    get_velocity,
    inference_timesteps,
    make_betas,
    make_shifted_schedule,
    min_snr_weight,
    pred_original_sample,
    shift_snr_betas,
    snr_to_betas,
)
