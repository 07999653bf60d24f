"""Discrete-time DDPM noise schedule: the tables, q(x_t | x_0) and the
reverse-process steps.

Port of ``siss_tpu/diffusion/schedule.py``. The tables are built on the host
in float64 and cast to float32 exactly as the reference does, so both
packages hold bitwise-equal γ/σ tables. The reverse steps take one scalar
timestep and compute their coefficients as 0-d float32 tensors on the
schedule's device, in the reference's order of operations. Their noise is an
argument (or is drawn from a ``torch.Generator``), so a test can hand in the
JAX package's draws.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Union

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


def spaced_timesteps(num_train_timesteps: int, num_inference_steps: int) -> np.ndarray:
    """Descending inference grid with diffusers' leading spacing (stride
    T // n): for T = 1000, n = 50 it is [980, 960, ..., 0]."""
    step_ratio = num_train_timesteps // num_inference_steps
    ts = (np.arange(0, num_inference_steps) * step_ratio).round()[::-1]
    return ts.astype(np.int32)


def pred_x0_from_eps(schedule: NoiseSchedule, x_t: torch.Tensor, eps: torch.Tensor,
                     t: torch.Tensor) -> torch.Tensor:
    gamma = _bcast(schedule.gamma[t], x_t)
    sigma = _bcast(schedule.sigma[t], x_t)
    return (x_t - sigma * eps) / gamma


def _model_pred_to_x0(schedule: NoiseSchedule, x_t, model_out, t):
    if schedule.prediction_type == "epsilon":
        x0 = pred_x0_from_eps(schedule, x_t, model_out, t)
    elif schedule.prediction_type == "sample":
        x0 = model_out
    elif schedule.prediction_type == "v_prediction":
        gamma = _bcast(schedule.gamma[t], x_t)
        sigma = _bcast(schedule.sigma[t], x_t)
        x0 = gamma * x_t - sigma * model_out
    else:
        raise ValueError(f"Unknown prediction_type {schedule.prediction_type!r}")
    if schedule.clip_sample:
        x0 = torch.clamp(x0, -schedule.clip_sample_range, schedule.clip_sample_range)
    return x0


TimeIndex = Union[int, torch.Tensor]


def _alpha_prods(schedule: NoiseSchedule, t: TimeIndex, prev_t: TimeIndex):
    """ᾱ_t and ᾱ_prev as 0-d float32 tensors; ᾱ_prev = 1 for ``prev_t < 0``."""
    ac = schedule.alphas_cumprod
    prev_t = int(prev_t)
    alpha_prev = ac[prev_t] if prev_t >= 0 else torch.ones((), dtype=ac.dtype, device=ac.device)
    return ac[int(t)], alpha_prev


def _t_index(schedule: NoiseSchedule, t: TimeIndex) -> torch.Tensor:
    return torch.full((1,), int(t), dtype=torch.long, device=schedule.gamma.device)


def ddpm_step(schedule: NoiseSchedule, x_t: torch.Tensor, model_out: torch.Tensor, t: TimeIndex,
              prev_t: TimeIndex, noise: Optional[torch.Tensor] = None,
              generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """One ancestral DDPM reverse step x_t → x_{prev_t} (diffusers
    ``DDPMScheduler.step``, ``variance_type="fixed_small"``), for any
    spacing; ``prev_t < 0`` is the final step and adds no noise. ``noise``
    [like x_t] is drawn from ``generator`` when not given."""
    alpha_prod_t, alpha_prod_prev = _alpha_prods(schedule, t, prev_t)
    beta_prod_t = 1.0 - alpha_prod_t
    beta_prod_prev = 1.0 - alpha_prod_prev
    current_alpha = alpha_prod_t / alpha_prod_prev
    current_beta = 1.0 - current_alpha

    x0 = _model_pred_to_x0(schedule, x_t, model_out, _t_index(schedule, t))
    # Posterior mean coefficients (Ho et al. eq. 7).
    coef_x0 = (torch.sqrt(alpha_prod_prev) * current_beta) / beta_prod_t
    coef_xt = (torch.sqrt(current_alpha) * beta_prod_prev) / beta_prod_t
    mean = coef_x0 * x0 + coef_xt * x_t
    if int(prev_t) < 0:
        return mean
    # fixed_small variance, clamped as diffusers does.
    variance = torch.clamp(beta_prod_prev / beta_prod_t * current_beta, min=1e-20)
    if noise is None:
        noise = torch.randn(x_t.shape, generator=generator, dtype=x_t.dtype, device=x_t.device)
    return mean + torch.sqrt(variance) * noise


def ddim_step(schedule: NoiseSchedule, x_t: torch.Tensor, model_out: torch.Tensor, t: TimeIndex,
              prev_t: TimeIndex, eta: float = 0.0, noise: Optional[torch.Tensor] = None,
              generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """One DDIM reverse step (diffusers ``DDIMScheduler`` semantics); ``eta
    = 0`` is deterministic, ``eta > 0`` mixes in ``noise`` (or a draw from
    ``generator``)."""
    alpha_prod_t, alpha_prod_prev = _alpha_prods(schedule, t, prev_t)
    beta_prod_t = 1.0 - alpha_prod_t

    x0 = _model_pred_to_x0(schedule, x_t, model_out, _t_index(schedule, t))
    # The epsilon consistent with the (possibly clipped) x0.
    eps = (x_t - torch.sqrt(alpha_prod_t) * x0) / torch.sqrt(beta_prod_t)

    variance = (1.0 - alpha_prod_prev) / (1.0 - alpha_prod_t) * (1.0 - alpha_prod_t / alpha_prod_prev)
    std = eta * torch.sqrt(torch.clamp(variance, min=0.0))
    dir_xt = torch.sqrt(torch.clamp(1.0 - alpha_prod_prev - std ** 2, min=0.0)) * eps
    prev = torch.sqrt(alpha_prod_prev) * x0 + dir_xt
    if eta > 0.0:
        if noise is None:
            if generator is None:
                raise ValueError("eta > 0 requires noise or a generator")
            noise = torch.randn(x_t.shape, generator=generator, dtype=x_t.dtype,
                                device=x_t.device)
        prev = prev + std * noise
    return prev
