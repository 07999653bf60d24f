"""Sampling and evaluation harness: port of ``siss_tpu/evaluate.py``.

* ``sample_images``: ancestral DDPM (or DPM-Solver++(2M)) samples
* ``denoise_images``: the reverse loop from a given timestep (denoising
  injections)
* ``make_grid_from_images``: a square grid of NHWC images

Outputs are numpy NHWC float arrays in [0, 1], as in the JAX package. With
``set_generator=True`` the draws come from a generator seeded with
``random_seed``, so panels are reproducible from call to call. The JAX
package's mesh sharding of the sampling batch is not ported (one device).
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from siss_tpu_torch.diffusion.sampling import (
    denoise_from_t,
    denoise_from_t_dpm,
    sample_ddpm,
    sample_dpm_solver_2m,
)
from siss_tpu_torch.diffusion.schedule import NoiseSchedule


class Evaluator:
    """Wraps an ε model and a schedule into a sampling harness."""

    def __init__(self, eps_apply: Callable, schedule: NoiseSchedule, sample_shape: tuple,
                 num_inference_steps: int = 50, random_seed: int = 0, solver: str = "ddpm",
                 injection_steps: int = 10):
        """``eps_apply(model, x, t, cond) -> eps`` on NHWC latents;
        ``sample_shape`` is (H, W, C). ``solver``: "ddpm" (the reference's
        ancestral loop) or "dpm" (DPM-Solver++(2M), which also runs the
        denoising injections in ``injection_steps`` model calls)."""
        if solver not in ("ddpm", "dpm"):
            raise ValueError(f"Unknown solver {solver!r}: choose ddpm or dpm")
        self.eps_apply = eps_apply
        self.schedule = schedule
        self.sample_shape = tuple(sample_shape)
        self.num_inference_steps = num_inference_steps
        self.random_seed = random_seed
        self.solver = solver
        self.injection_steps = injection_steps

    def _generator(self, set_generator: bool) -> torch.Generator:
        seed = self.random_seed if set_generator else int(np.random.randint(2 ** 31))
        return torch.Generator(device=self.schedule.gamma.device).manual_seed(seed)

    def _eps_fn(self, model):
        return lambda x, t, cond: self.eps_apply(model, x, t, cond)

    @staticmethod
    def _to_unit(x: torch.Tensor) -> np.ndarray:
        return np.clip((x.float().cpu().numpy() + 1.0) / 2.0, 0.0, 1.0)

    def sample_images(self, model, num_samples: int, set_generator: bool = False) -> np.ndarray:
        """Samples as numpy NHWC float in [0, 1]."""
        sampler = sample_dpm_solver_2m if self.solver == "dpm" else sample_ddpm
        imgs = sampler(self._eps_fn(model), self.schedule, (num_samples, *self.sample_shape),
                       self.num_inference_steps, generator=self._generator(set_generator))
        return self._to_unit(imgs)

    def denoise_images(self, model, noisy_image_batch, timestep: int,
                       set_generator: bool = True) -> np.ndarray:
        """Reverse-diffuse a noised NHWC batch (array or tensor) from
        ``timestep`` to 0; numpy NHWC in [0, 1]."""
        device = self.schedule.gamma.device
        x_t = torch.as_tensor(noisy_image_batch, device=device)
        if self.solver == "dpm":
            out = denoise_from_t_dpm(self._eps_fn(model), self.schedule, x_t, int(timestep),
                                     num_inference_steps=self.injection_steps)
        else:
            out = denoise_from_t(self._eps_fn(model), self.schedule, x_t, int(timestep),
                                 generator=self._generator(set_generator))
        return self._to_unit(out)

    @staticmethod
    def make_grid_from_images(images: np.ndarray, padding: int = 2) -> np.ndarray:
        """Square grid of NHWC images (torchvision ``make_grid`` layout; a
        1-channel image stays 1-channel)."""
        n, h, w, c = images.shape
        ncol = int(np.ceil(np.sqrt(n)))
        nrow = int(np.ceil(n / ncol))
        grid = np.zeros((nrow * h + padding * (nrow + 1), ncol * w + padding * (ncol + 1), c),
                        dtype=images.dtype)
        for idx in range(n):
            r, col = divmod(idx, ncol)
            y = padding + r * (h + padding)
            x = padding + col * (w + padding)
            grid[y:y + h, x:x + w] = images[idx]
        return grid
