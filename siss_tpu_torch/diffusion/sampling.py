"""Sampling loops: port of ``siss_tpu/diffusion/sampling.py`` (DDPM
ancestral, DDIM, classifier-free-guidance DDIM with noise-norm tracking,
the denoising injection and DPM-Solver++(2M)).

Each ``lax.scan`` of the JAX package is a Python loop here, run under
``torch.inference_mode()``. The random draws are arguments: ``x_init`` (the
starting noise) and ``step_noise`` (one tensor per step) are drawn from
``generator`` on the samples' device when not given, so a test can hand in
the JAX package's draws. ``eps_fn(x, t, cond)`` takes NHWC latents and a [B]
integer timestep tensor.

Each public sampler is one ``sample.request`` span (``utils.spans``); in
it each model call (with CFG's concatenation) is a ``sample.unet`` span,
and each scheduler update (the step noise, CFG's combine and noise norms)
a ``sample.update`` span.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from siss_tpu_torch.diffusion.schedule import (
    NoiseSchedule,
    ddim_step,
    ddpm_step,
    spaced_timesteps,
)
from siss_tpu_torch.utils.spans import span

EpsFn = Callable[[torch.Tensor, torch.Tensor, Any], torch.Tensor]


def _timestep_grid(schedule: NoiseSchedule, num_inference_steps: int):
    ts = spaced_timesteps(schedule.num_train_timesteps, num_inference_steps)
    prev = np.concatenate([ts[1:], [-1]])
    return [int(t) for t in ts], [int(p) for p in prev]


def _start(shape, generator, x_init, dtype, device):
    if x_init is not None:
        return x_init
    return torch.randn(shape, generator=generator, dtype=dtype, device=device)


def _t_batch(t: int, batch: int, device) -> torch.Tensor:
    return torch.full((batch,), t, dtype=torch.long, device=device)


def cfg_branches(eps_fn: EpsFn, x: torch.Tensor, t: int, both: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The two guidance branches in ONE model call of batch 2B: ``[x, x]``
    at timestep ``t`` under ``both`` = [uncond; cond] embeddings. Returns
    (ε_uncond, ε_text − ε_uncond)."""
    B = x.shape[0]
    eps_both = eps_fn(torch.cat([x, x], dim=0), _t_batch(t, 2 * B, x.device), both)
    return eps_both[:B], eps_both[B:] - eps_both[:B]


@span("sample.request")
@torch.inference_mode()
def sample_ddpm(eps_fn: EpsFn, schedule: NoiseSchedule, shape: Tuple[int, ...],
                num_inference_steps: int = 50, conditioning: Any = None,
                generator: Optional[torch.Generator] = None,
                x_init: Optional[torch.Tensor] = None,
                step_noise: Optional[Sequence[torch.Tensor]] = None,
                dtype=torch.float32) -> torch.Tensor:
    """Ancestral DDPM sampling from pure noise; images in [-1, 1] (clipped
    per ``schedule.clip_sample``)."""
    device = schedule.gamma.device
    ts, prev = _timestep_grid(schedule, num_inference_steps)
    x = _start(shape, generator, x_init, dtype, device)
    for i, (t, p) in enumerate(zip(ts, prev)):
        with span("sample.unet"):
            eps = eps_fn(x, _t_batch(t, shape[0], device), conditioning)
        with span("sample.update"):
            x = ddpm_step(schedule, x, eps, t, p, None if step_noise is None else step_noise[i],
                          generator)
    return x


@span("sample.request")
@torch.inference_mode()
def sample_ddim(eps_fn: EpsFn, schedule: NoiseSchedule, shape: Tuple[int, ...],
                num_inference_steps: int = 50, conditioning: Any = None, eta: float = 0.0,
                generator: Optional[torch.Generator] = None,
                x_init: Optional[torch.Tensor] = None,
                step_noise: Optional[Sequence[torch.Tensor]] = None,
                dtype=torch.float32) -> torch.Tensor:
    device = schedule.gamma.device
    ts, prev = _timestep_grid(schedule, num_inference_steps)
    x = _start(shape, generator, x_init, dtype, device)
    for i, (t, p) in enumerate(zip(ts, prev)):
        with span("sample.unet"):
            eps = eps_fn(x, _t_batch(t, shape[0], device), conditioning)
        with span("sample.update"):
            x = ddim_step(schedule, x, eps, t, p, eta=eta,
                          noise=None if step_noise is None else step_noise[i],
                          generator=generator)
    return x


@span("sample.request")
@torch.inference_mode()
def sample_ddim_cfg(eps_fn: EpsFn, schedule: NoiseSchedule, shape: Tuple[int, ...],
                    cond_embeds: torch.Tensor, uncond_embeds: torch.Tensor,
                    guidance_scale: float = 7.5, num_inference_steps: int = 50,
                    track_noise_norm: bool = False, eta: float = 0.0,
                    generator: Optional[torch.Generator] = None,
                    x_init: Optional[torch.Tensor] = None,
                    step_noise: Optional[Sequence[torch.Tensor]] = None,
                    dtype=torch.float32
                    ) -> Tuple[torch.Tensor, Optional[Dict[str, torch.Tensor]]]:
    """Classifier-free-guidance DDIM with the optional per-step noise norms
    of the memorisation diagnostic: per image, ‖ε_uncond‖ and ‖ε_text −
    ε_uncond‖ in fp32. The two branches go through ONE model call of batch
    2B, ``[uncond, cond]``; eps = ε_u + g·(ε_c − ε_u).

    Returns ``(latents, norms)``; norms is None or a dict of ``uncond_norm``
    and ``text_norm`` tensors shaped [steps, B]. With ``eta > 0`` each
    step's noise is ``step_noise[i]`` or a draw from ``generator``."""
    device = schedule.gamma.device
    ts, prev = _timestep_grid(schedule, num_inference_steps)
    x = _start(shape, generator, x_init, dtype, device)
    both = torch.cat([uncond_embeds, cond_embeds], dim=0)
    dims = tuple(range(1, x.ndim))
    uncond_norms, text_norms = [], []
    for i, (t, p) in enumerate(zip(ts, prev)):
        with span("sample.unet"):
            eps_uncond, delta = cfg_branches(eps_fn, x, t, both)
        with span("sample.update"):
            if track_noise_norm:
                uncond_norms.append(torch.linalg.vector_norm(eps_uncond.float(), dim=dims))
                text_norms.append(torch.linalg.vector_norm(delta.float(), dim=dims))
            x = ddim_step(schedule, x, eps_uncond + guidance_scale * delta, t, p, eta=eta,
                          noise=None if step_noise is None else step_noise[i],
                          generator=generator)
    if not track_noise_norm:
        return x, None
    return x, {"uncond_norm": torch.stack(uncond_norms), "text_norm": torch.stack(text_norms)}


@span("sample.request")
@torch.inference_mode()
def denoise_from_t(eps_fn: EpsFn, schedule: NoiseSchedule, x_t: torch.Tensor, t_start: int,
                   conditioning: Any = None, generator: Optional[torch.Generator] = None,
                   step_noise: Optional[Sequence[torch.Tensor]] = None) -> torch.Tensor:
    """Ancestral reverse loop from ``t_start`` down to 0, one step per
    timestep: the denoising injection."""
    x = x_t
    for i, t in enumerate(range(int(t_start), -1, -1)):
        with span("sample.unet"):
            eps = eps_fn(x, _t_batch(t, x_t.shape[0], x_t.device), conditioning)
        with span("sample.update"):
            x = ddpm_step(schedule, x, eps, t, t - 1,
                          None if step_noise is None else step_noise[i], generator)
    return x


@span("sample.request")
@torch.inference_mode()
def sample_dpm_solver_2m(eps_fn: EpsFn, schedule: NoiseSchedule, shape: Tuple[int, ...],
                         num_inference_steps: int = 15, conditioning: Any = None,
                         generator: Optional[torch.Generator] = None,
                         x_init: Optional[torch.Tensor] = None,
                         dtype=torch.float32) -> torch.Tensor:
    """DPM-Solver++(2M), second-order multistep in the data-prediction
    parameterisation (Lu et al. 2022): deterministic after the start."""
    ts, _ = _timestep_grid(schedule, num_inference_steps)
    x = _start(shape, generator, x_init, dtype, schedule.gamma.device)
    return _dpm_solver_2m_core(eps_fn, schedule, x, ts, conditioning)


@span("sample.request")
@torch.inference_mode()
def denoise_from_t_dpm(eps_fn: EpsFn, schedule: NoiseSchedule, x_t: torch.Tensor, t_start: int,
                       num_inference_steps: int = 10, conditioning: Any = None) -> torch.Tensor:
    """The denoising injection by DPM-Solver++(2M): from ``t_start`` to 0 in
    about ``num_inference_steps`` model calls, without noise."""
    n = max(2, min(int(num_inference_steps), int(t_start) + 1))
    ts = np.unique(np.linspace(t_start, 0, n).round())[::-1].astype(np.int32)
    return _dpm_solver_2m_core(eps_fn, schedule, x_t, [int(t) for t in ts], conditioning)


def _dpm_solver_2m_core(eps_fn: EpsFn, schedule: NoiseSchedule, x: torch.Tensor,
                        ts: Sequence[int], conditioning: Any = None) -> torch.Tensor:
    """The solver's coefficients are float32 scalars computed once on the
    host, in the reference's order; the images stay on their device."""
    f32 = torch.float32
    idx = torch.tensor(ts, dtype=torch.long)
    gamma_tab, sigma_tab = schedule.gamma.cpu(), schedule.sigma.cpu()
    # λ(t) = log(γ/σ) over the grid and the final clean point (γ = 1, σ → 0 clamped)
    gamma_all = torch.cat([gamma_tab[idx], torch.ones(1, dtype=f32)])
    sigma_all = torch.clamp(torch.cat([sigma_tab[idx], torch.zeros(1, dtype=f32)]), min=1e-4)
    lam = torch.log(gamma_all / sigma_all)
    clip = schedule.clip_sample_range

    x0_prev = None
    for i, t in enumerate(ts):
        with span("sample.unet"):
            eps = eps_fn(x, _t_batch(t, x.shape[0], x.device), conditioning)
        with span("sample.update"):
            x0 = (x - float(sigma_tab[t]) * eps) / float(gamma_tab[t])
            if schedule.clip_sample:
                x0 = torch.clamp(x0, -clip, clip)
            h = lam[i + 1] - lam[i]
            r = (lam[i] - lam[max(i - 1, 0)]) / h
            # lower_order_final: the last step's h (to the clean point) is
            # large and second-order extrapolation there is unstable.
            use_second = (0 < i < len(ts) - 1 and bool(torch.isfinite(r))
                          and float(r.abs()) > 1e-6)
            if use_second:
                inv = 1.0 / (2.0 * r)
                d = float(1.0 + inv) * x0 - float(inv) * x0_prev
            else:
                d = x0
            x = (float(sigma_all[i + 1] / sigma_all[i]) * x
                 - float(gamma_all[i + 1] * torch.expm1(-h)) * d)
            x0_prev = x0
    return x
