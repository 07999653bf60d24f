"""Continuous-time SDEs for the probability-flow-ODE likelihood: port of
``siss_tpu/diffusion/sde.py``.

VP-SDE (the NLL metric's), sub-VP and VE, each a frozen dataclass of plain
floats whose methods work on tensors. ``t`` is a tensor, or a host scalar
(a float or a numpy float32, as the ODE solvers pass it): then the
coefficients are computed on the host in its type and scale the tensors as
Python numbers, so no step of the solver copies a time to the device.
``prior_logp`` sums over the non-batch dimensions.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch


def _math(t):
    """torch for a tensor ``t``, numpy for a host scalar."""
    return torch if isinstance(t, torch.Tensor) else np


def _scale(c, x: torch.Tensor) -> torch.Tensor:
    """c·x for a tensor or a host scalar ``c``."""
    return c * x if isinstance(c, torch.Tensor) else float(c) * x


def _gaussian_logp(z: torch.Tensor, var: float) -> torch.Tensor:
    """log N(z; 0, var·I) summed over the non-batch dimensions."""
    n = math.prod(z.shape[1:])
    return (-n / 2.0 * math.log(2 * math.pi * var)
            - (z.reshape(z.shape[0], -1) ** 2).sum(-1) / (2.0 * var))


@dataclasses.dataclass(frozen=True)
class VPSDE:
    """Variance-preserving SDE, the continuous limit of DDPM:
    dx = −½β(t)x dt + √β(t) dW, β(t) = β₀ + t(β₁ − β₀)."""

    beta_0: float = 0.1
    beta_1: float = 20.0
    N: int = 1000

    @property
    def T(self) -> float:
        return 1.0

    def _log_mean_coeff(self, t):
        return -0.25 * t ** 2 * (self.beta_1 - self.beta_0) - 0.5 * t * self.beta_0

    def sde(self, x: torch.Tensor, t):
        beta_t = self.beta_0 + t * (self.beta_1 - self.beta_0)
        return _scale(-0.5 * beta_t, x), _math(t).sqrt(beta_t)

    def marginal_prob(self, x: torch.Tensor, t):
        return _scale(_math(t).exp(self._log_mean_coeff(t)), x), self.marginal_std(t)

    def marginal_std(self, t):
        m = _math(t)
        return m.sqrt(1.0 - m.exp(2.0 * self._log_mean_coeff(t)))

    def prior_logp(self, z: torch.Tensor) -> torch.Tensor:
        return _gaussian_logp(z, 1.0)

    def probability_flow_drift(self, x: torch.Tensor, t, score: torch.Tensor) -> torch.Tensor:
        """Reverse probability-flow ODE drift f(x, t) − ½ g(t)² ∇log p_t(x)."""
        drift, diffusion = self.sde(x, t)
        return drift - _scale(0.5 * diffusion ** 2, score)


@dataclasses.dataclass(frozen=True)
class SubVPSDE:
    """Sub-VP SDE: the VP drift with diffusion β(t)(1 − e^{−2∫β})."""

    beta_0: float = 0.1
    beta_1: float = 20.0
    N: int = 1000

    @property
    def T(self) -> float:
        return 1.0

    def _log_mean_coeff(self, t):
        return -0.25 * t ** 2 * (self.beta_1 - self.beta_0) - 0.5 * t * self.beta_0

    def sde(self, x: torch.Tensor, t):
        m = _math(t)
        beta_t = self.beta_0 + t * (self.beta_1 - self.beta_0)
        discount = 1.0 - m.exp(-2.0 * self.beta_0 * t - (self.beta_1 - self.beta_0) * t ** 2)
        return _scale(-0.5 * beta_t, x), m.sqrt(beta_t * discount)

    def marginal_prob(self, x: torch.Tensor, t):
        return _scale(_math(t).exp(self._log_mean_coeff(t)), x), self.marginal_std(t)

    def marginal_std(self, t):
        return 1.0 - _math(t).exp(2.0 * self._log_mean_coeff(t))

    def prior_logp(self, z: torch.Tensor) -> torch.Tensor:
        return _gaussian_logp(z, 1.0)

    def probability_flow_drift(self, x: torch.Tensor, t, score: torch.Tensor) -> torch.Tensor:
        drift, diffusion = self.sde(x, t)
        return drift - _scale(0.5 * diffusion ** 2, score)


@dataclasses.dataclass(frozen=True)
class VESDE:
    """Variance-exploding SDE: σ(t) = σ_min (σ_max/σ_min)^t, no drift."""

    sigma_min: float = 0.01
    sigma_max: float = 50.0
    N: int = 1000

    @property
    def T(self) -> float:
        return 1.0

    def sde(self, x: torch.Tensor, t):
        scale = math.sqrt(2.0 * (math.log(self.sigma_max) - math.log(self.sigma_min)))
        return torch.zeros_like(x), self.marginal_std(t) * scale

    def marginal_prob(self, x: torch.Tensor, t):
        return x, self.marginal_std(t)

    def marginal_std(self, t):
        return self.sigma_min * (self.sigma_max / self.sigma_min) ** t

    def prior_logp(self, z: torch.Tensor) -> torch.Tensor:
        return _gaussian_logp(z, self.sigma_max ** 2)

    def probability_flow_drift(self, x: torch.Tensor, t, score: torch.Tensor) -> torch.Tensor:
        drift, diffusion = self.sde(x, t)
        return drift - _scale(0.5 * diffusion ** 2, score)
