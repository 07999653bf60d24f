"""Stable Diffusion 1.x pieces: port of ``siss_tpu/diffusion/sd_pipeline.py``.

For now only the SD-1.x noise schedule, which the latent SISS step needs.
The sampling pipeline (CFG with noise-norm tracking, img2img, the text
conditioning helpers) comes with the SD task (ROADMAP Queue 1 item 11).
"""

from __future__ import annotations

from siss_tpu_torch.diffusion.schedule import NoiseSchedule


def sd_noise_schedule(num_train_timesteps: int = 1000, device="cuda") -> NoiseSchedule:
    """SD-1.x schedule: scaled_linear β ∈ [0.00085, 0.012], no clipping."""
    return NoiseSchedule.create(num_train_timesteps, "scaled_linear", 0.00085, 0.012,
                                clip_sample=False, device=device)
