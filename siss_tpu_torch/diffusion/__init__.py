from siss_tpu_torch.diffusion.schedule import (
    NoiseSchedule,
    ddim_step,
    ddpm_step,
    make_beta_schedule,
    pred_x0_from_eps,
    q_sample,
    snr_weights,
    spaced_timesteps,
)
from siss_tpu_torch.diffusion.sd_pipeline import sd_noise_schedule

__all__ = ["NoiseSchedule", "ddim_step", "ddpm_step", "make_beta_schedule", "pred_x0_from_eps",
           "q_sample", "snr_weights", "spaced_timesteps", "sd_noise_schedule"]
