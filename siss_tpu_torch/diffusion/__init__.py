from siss_tpu_torch.diffusion.schedule import (
    NoiseSchedule,
    make_beta_schedule,
    q_sample,
    snr_weights,
)
from siss_tpu_torch.diffusion.sd_pipeline import sd_noise_schedule

__all__ = ["NoiseSchedule", "make_beta_schedule", "q_sample", "snr_weights",
           "sd_noise_schedule"]
