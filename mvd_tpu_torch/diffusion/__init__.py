from .schedules import (  # noqa: F401
    NoiseSchedule,
    compute_snr,
    ddpm_step,
    inference_timesteps,
    make_betas,
    make_shifted_schedule,
    pred_original_sample,
    shift_snr_betas,
    snr_to_betas,
)
