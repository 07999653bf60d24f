from siss_tpu_torch.diffusion.schedule import (
    NoiseSchedule,
    make_beta_schedule,
    q_sample,
    snr_weights,
)

__all__ = ["NoiseSchedule", "make_beta_schedule", "q_sample", "snr_weights"]
