"""Exact NLL in bits/dim through the probability-flow ODE: port of
``siss_tpu/metrics/likelihood.py``.

The VP-SDE's reverse probability-flow ODE is integrated from t_eps to 1
together with the Hutchinson–Skilling estimate of the drift's divergence;
bpd = −(log p_T(z) + Δlog p)/ln 2/D + 7 (8-bit data in [−1, 1]).

Score conversion (discrete time): labels = t·(N − 1) in float32, truncated
to an integer index, and score = −ε_θ(x, index)/σ[index] with σ from the
task's noise schedule.

Divergence: the JAX package forms ε·(Jε) with ``jax.jvp``. This port forms
ε·(Jᵀε) with one ``torch.autograd.grad`` pull of the drift against ε, which
has the same value. The reverse-mode pull runs the same backward kernels
every train step of the UNet already runs (conv, group norm, the
materialised attention, channels_last on the card); forward-mode AD would
add a second, separately verified set of rules for a forward-and-tangent
pass of about the same cost.

The probe ε (Rademacher or Gaussian) comes from an explicit generator,
seeded with ``random_seed`` when the caller gives none, or is passed in.
"""

from __future__ import annotations

import math
from typing import Callable, Optional, Tuple

import numpy as np
import torch

from siss_tpu_torch.diffusion.ode import odeint_rk4, odeint_rk45
from siss_tpu_torch.diffusion.schedule import NoiseSchedule
from siss_tpu_torch.diffusion.sde import VPSDE


class LikelihoodEvaluator:
    """``evaluate_likelihood(model, img_batch) -> (bpd[B], z, nfe)``.

    ``eps_apply(model, x, t, cond) -> eps`` on NHWC images; ``schedule`` is
    the task's (its σ table converts ε to a score); without one the DDPM
    discretisation of ``sde`` is used."""

    def __init__(self, eps_apply: Callable, sde: VPSDE = VPSDE(),
                 schedule: Optional[NoiseSchedule] = None, hutchinson_type: str = "Rademacher",
                 rtol: float = 1e-5, atol: float = 1e-5, t_eps: float = 1e-5,
                 method: str = "rk45", rk4_steps: int = 180, max_steps: int = 2000,
                 random_seed: int = 0, device="cuda"):
        if hutchinson_type not in ("Rademacher", "Gaussian"):
            raise NotImplementedError(hutchinson_type)
        if method not in ("rk45", "rk4"):
            raise ValueError(f"Unknown method {method!r}: choose rk45 or rk4")
        if schedule is None:
            schedule = NoiseSchedule.create(sde.N, "linear", sde.beta_0 / sde.N,
                                            sde.beta_1 / sde.N, device=device)
        self.eps_apply = eps_apply
        self.sde = sde
        self.sigma_table = schedule.sigma
        self.hutchinson_type = hutchinson_type
        self.rtol, self.atol, self.t_eps = rtol, atol, t_eps
        self.method = method
        self.rk4_steps = rk4_steps
        self.max_steps = max_steps
        self.random_seed = random_seed

    def _drift(self, model, x: torch.Tensor, t: np.float32) -> torch.Tensor:
        idx = int(np.float32(t) * np.float32(self.sde.N - 1))
        vec_t = torch.full((x.shape[0],), idx, dtype=torch.long, device=x.device)
        score = -self.eps_apply(model, x, vec_t, None) / self.sigma_table[idx]
        return self.sde.probability_flow_drift(x, t, score)

    def draw_probe(self, shape, generator: torch.Generator) -> torch.Tensor:
        if self.hutchinson_type == "Gaussian":
            return torch.randn(shape, generator=generator, device=generator.device)
        bits = torch.randint(0, 2, shape, generator=generator, device=generator.device)
        return bits.to(torch.float32) * 2.0 - 1.0

    def evaluate_likelihood(self, model, img_batch, generator: Optional[torch.Generator] = None,
                            probe: Optional[torch.Tensor] = None
                            ) -> Tuple[torch.Tensor, torch.Tensor, int]:
        """bpd [B], the latent z = x(1) and the JAX count of function
        evaluations (6 per RK45 step, 4 per RK4 step) for an NHWC batch in
        [−1, 1] on the model's device."""
        data = torch.as_tensor(img_batch, dtype=torch.float32, device=self.sigma_table.device)
        if probe is None:
            if generator is None:
                generator = torch.Generator(device=data.device).manual_seed(self.random_seed)
            probe = self.draw_probe(data.shape, generator)
        eps = torch.as_tensor(probe, dtype=torch.float32, device=data.device)

        def ode_func(state, t):
            x = state[0].detach().requires_grad_(True)
            with torch.enable_grad():
                drift = self._drift(model, x, t)
                (vjp,) = torch.autograd.grad(drift, x, eps)
            div = (vjp * eps).sum(dim=tuple(range(1, x.ndim)))
            return drift.detach(), div

        y0 = (data, torch.zeros(data.shape[0], device=data.device))
        if self.method == "rk45":
            (z, delta_logp), nfe = odeint_rk45(ode_func, y0, self.t_eps, self.sde.T,
                                               rtol=self.rtol, atol=self.atol,
                                               max_steps=self.max_steps)
        else:
            z, delta_logp = odeint_rk4(ode_func, y0, self.t_eps, self.sde.T, self.rk4_steps)
            nfe = 4 * self.rk4_steps
        n = math.prod(data.shape[1:])
        bpd = -(self.sde.prior_logp(z) + delta_logp) / math.log(2.0) / n + 7.0
        return bpd, z, nfe
