"""Discrete-time DDPM noise schedule: the tables and q(x_t | x_0).

Port of ``siss_tpu/diffusion/schedule.py``. The tables are built on the host
in float64 and cast to float32 exactly as the reference does, so both
packages hold bitwise-equal γ/σ tables. The sampling steps (``ddpm_step``,
``ddim_step``, ``spaced_timesteps``) come with the sampling slice.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from siss_tpu_torch.device import resolve_device


def make_beta_schedule(name: str, num_train_timesteps: int, beta_start: float = 1e-4,
                       beta_end: float = 0.02) -> np.ndarray:
    """Beta schedule, host-side in float64, cast to float32."""
    if name == "linear":
        betas = np.linspace(beta_start, beta_end, num_train_timesteps, dtype=np.float64)
    elif name == "scaled_linear":
        betas = np.linspace(beta_start**0.5, beta_end**0.5, num_train_timesteps,
                            dtype=np.float64) ** 2
    elif name == "squaredcos_cap_v2":
        def alpha_bar(t):
            return np.cos((t + 0.008) / 1.008 * np.pi / 2) ** 2

        ts = np.arange(num_train_timesteps, dtype=np.float64)
        betas = np.minimum(1.0 - alpha_bar((ts + 1) / num_train_timesteps)
                           / alpha_bar(ts / num_train_timesteps), 0.999)
    else:
        raise ValueError(f"Unknown beta schedule: {name!r}")
    return betas.astype(np.float32)


@dataclasses.dataclass(frozen=True)
class NoiseSchedule:
    """γ = √ᾱ_t and σ = √(1 − ᾱ_t) tables, float32 [T] on one device."""

    betas: torch.Tensor
    alphas_cumprod: torch.Tensor
    gamma: torch.Tensor
    sigma: torch.Tensor
    num_train_timesteps: int
    prediction_type: str = "epsilon"
    clip_sample: bool = True
    clip_sample_range: float = 1.0

    @classmethod
    def create(cls, num_train_timesteps: int = 1000, beta_schedule: str = "linear",
               beta_start: float = 1e-4, beta_end: float = 0.02,
               prediction_type: str = "epsilon", clip_sample: bool = True,
               clip_sample_range: float = 1.0, device="cuda") -> "NoiseSchedule":
        dev = resolve_device(device)
        betas = make_beta_schedule(beta_schedule, num_train_timesteps, beta_start, beta_end)
        alphas_cumprod = np.cumprod(1.0 - betas.astype(np.float64)).astype(np.float32)

        def t(a):
            return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

        return cls(
            betas=t(betas),
            alphas_cumprod=t(alphas_cumprod),
            gamma=t(np.sqrt(alphas_cumprod)),
            sigma=t(np.sqrt(1.0 - alphas_cumprod)),
            num_train_timesteps=num_train_timesteps,
            prediction_type=prediction_type,
            clip_sample=clip_sample,
            clip_sample_range=clip_sample_range,
        )


def _bcast(coef: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """Broadcast a per-batch coefficient [B] against [B, ...]."""
    return coef.reshape(coef.shape + (1,) * (like.ndim - coef.ndim))


def q_sample(schedule: NoiseSchedule, x0: torch.Tensor, noise: torch.Tensor,
             t: torch.Tensor) -> torch.Tensor:
    """Forward noising q(x_t | x_0) = γ_t·x0 + σ_t·ε; ``t`` is integer [B]."""
    gamma = _bcast(schedule.gamma[t], x0)
    sigma = _bcast(schedule.sigma[t], x0)
    return gamma * x0 + sigma * noise


def snr_weights(schedule: NoiseSchedule, t: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """SNR = ᾱ/(1 − ᾱ), broadcast against ``like``."""
    a = schedule.alphas_cumprod[t]
    return _bcast(a / (1.0 - a), like)
