"""DDPM noise schedule tables and the reverse steps, plain float32.

The tables are made on the host in float64 and cast to float32: β
(``linear`` or ``scaled_linear``), ᾱ = Πᵢ(1 − βᵢ), γ = √ᾱ, σ = √(1 − ᾱ).
The inference grid is diffusers' "leading" spacing: for T = 1000 and 50
steps, [980, 960, ..., 0].
"""

from __future__ import annotations

import numpy as np
import torch


class Schedule:
    def __init__(self, spec: dict, device):
        T = int(spec["num_train_timesteps"])
        lo, hi = float(spec["beta_start"]), float(spec["beta_end"])
        if spec["beta_schedule"] == "linear":
            betas = np.linspace(lo, hi, T, dtype=np.float64)
        elif spec["beta_schedule"] == "scaled_linear":
            betas = np.linspace(lo ** 0.5, hi ** 0.5, T, dtype=np.float64) ** 2
        else:
            raise ValueError(f"unknown beta_schedule {spec['beta_schedule']!r}")
        abar = np.cumprod(1.0 - betas.astype(np.float32).astype(np.float64)).astype(np.float32)
        self.T = T
        self.clip_sample = bool(spec["clip_sample"])
        self.abar = torch.from_numpy(abar).to(device)
        self.gamma = torch.from_numpy(np.sqrt(abar)).to(device)
        self.sigma = torch.from_numpy(np.sqrt(1.0 - abar)).to(device)

    def grid(self, steps: int):
        """[(t, t_prev)] of the inference grid, t_prev = -1 at the end."""
        ts = [int(t) for t in (np.arange(steps) * (self.T // steps))[::-1]]
        return list(zip(ts, ts[1:] + [-1]))

    def q_sample(self, x0, noise, t):
        shape = (-1,) + (1,) * (x0.ndim - 1)
        return self.gamma[t].reshape(shape) * x0 + self.sigma[t].reshape(shape) * noise

    def _abar(self, t):
        return self.abar[t] if t >= 0 else torch.ones((), device=self.abar.device)

    def x0(self, x, eps, t):
        x0 = (x - self.sigma[t] * eps) / self.gamma[t]
        return x0.clamp(-1.0, 1.0) if self.clip_sample else x0

    def ddpm_step(self, x, eps, t, t_prev, noise):
        """Ancestral step with the "fixed_small" variance."""
        a_t, a_prev = self._abar(t), self._abar(t_prev)
        alpha = a_t / a_prev
        beta = 1.0 - alpha
        mean = (torch.sqrt(a_prev) * beta / (1.0 - a_t)) * self.x0(x, eps, t) \
            + (torch.sqrt(alpha) * (1.0 - a_prev) / (1.0 - a_t)) * x
        if t_prev < 0:
            return mean
        var = torch.clamp((1.0 - a_prev) / (1.0 - a_t) * beta, min=1e-20)
        return mean + torch.sqrt(var) * noise

    def ddim_step(self, x, eps, t, t_prev):
        """Deterministic DDIM step (η = 0)."""
        a_t, a_prev = self._abar(t), self._abar(t_prev)
        x0 = self.x0(x, eps, t)
        eps = (x - torch.sqrt(a_t) * x0) / torch.sqrt(1.0 - a_t)
        return torch.sqrt(a_prev) * x0 + torch.sqrt(torch.clamp(1.0 - a_prev, min=0.0)) * eps
