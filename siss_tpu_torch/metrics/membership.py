"""Membership loss: port of ``siss_tpu/metrics/membership.py``.

The mean over an N×M image×noise grid of the ε-MSE summed over pixels, at
fixed timesteps, for the keep and the forget sets. The grid is walked in
chunks of ``eval_batch_size`` rows. The images are chosen by numpy's
``default_rng(seed)`` as in the JAX package; the noise comes from a torch
generator or is passed in.
"""

from __future__ import annotations

from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from siss_tpu_torch.diffusion.schedule import NoiseSchedule, q_sample


class MembershipLoss:
    def __init__(self, eps_apply: Callable, schedule: NoiseSchedule, dataset_all,
                 dataset_deletion, num_image_samples: int, num_noise_samples: int,
                 eval_batch_size: int = 4096, seed: int = 0):
        """``eps_apply(model, x, t, cond) -> eps`` on NHWC images; the grid
        runs on the schedule's device."""
        self.eps_apply = eps_apply
        self.schedule = schedule
        self.dataset_all = dataset_all
        self.dataset_deletion = dataset_deletion
        self.num_image_samples = num_image_samples
        self.num_noise_samples = num_noise_samples
        self.eval_batch_size = eval_batch_size
        self.seed = seed
        self.rng = np.random.default_rng(seed)
        self.device = schedule.gamma.device

    def sample_images(self) -> None:
        n_all, n_del, n = len(self.dataset_all), len(self.dataset_deletion), self.num_image_samples
        all_idx = self.rng.choice(n_all, n, replace=n_all < n)
        if n_del == 1:
            del_idx = np.zeros(n, np.int64)
        else:
            del_idx = self.rng.choice(n_del, n, replace=n_del < n)
        self.all_images = np.stack([np.asarray(self.dataset_all[int(i)]) for i in all_idx])
        self.del_images = np.stack([np.asarray(self.dataset_deletion[int(i)]) for i in del_idx])

    def sample_noises(self, generator: Optional[torch.Generator] = None,
                      noise: Optional[torch.Tensor] = None) -> None:
        """M noise images [M, H, W, C]: ``noise`` as given, or drawn from
        ``generator`` (seeded with ``seed`` when there is none)."""
        if noise is None:
            if generator is None:
                generator = torch.Generator(device=self.device).manual_seed(self.seed)
            noise = torch.randn((self.num_noise_samples, *self.all_images.shape[1:]),
                                generator=generator, device=generator.device)
        self.noise = torch.as_tensor(noise, dtype=torch.float32).to(self.device)

    @torch.no_grad()
    def _grid_mean_loss(self, model, images: torch.Tensor, t: int) -> float:
        N, M = self.num_image_samples, self.num_noise_samples
        bs = min(self.eval_batch_size, N * M)
        total = torch.zeros((), device=self.device)
        for start in range(0, N * M, bs):
            idx = torch.arange(start, min(start + bs, N * M), device=self.device)
            x0, eps = images[idx // M % N], self.noise[idx % M]
            ts = torch.full((idx.shape[0],), t, dtype=torch.long, device=self.device)
            pred = self.eps_apply(model, q_sample(self.schedule, x0, eps, ts), ts, None)
            total += ((pred - eps) ** 2).sum(dim=tuple(range(1, x0.ndim))).sum()
        return float(total / (N * M))

    def compute_membership_losses(self, model, timesteps: Sequence[int]
                                  ) -> List[Tuple[float, float]]:
        """[(all_loss, deletion_loss), …], one pair per timestep."""
        all_imgs = torch.from_numpy(self.all_images).to(self.device)
        del_imgs = torch.from_numpy(self.del_images).to(self.device)
        return [(self._grid_mean_loss(model, all_imgs, int(t)),
                 self._grid_mean_loss(model, del_imgs, int(t))) for t in timesteps]
