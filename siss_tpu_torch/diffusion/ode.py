"""Adaptive (Dormand–Prince RK45) and fixed-grid (RK4) ODE integration:
port of ``siss_tpu/diffusion/ode.py``.

The state is a tuple of tensors. The JAX ``lax.while_loop`` becomes a
Python loop that reads the step's error norm on the host once per step (one
synchronisation), from which the accept test and the step-size controller
follow. ``t`` and ``h`` live on the host as float32, so the controller's
arithmetic (``h = min(h, t1 − t)``, the clipped factor, the clipped next
step) rounds as the JAX package's float32 does, and the same right-hand
side takes the same steps. ``f(y, t)`` receives ``t`` as a host
``numpy.float32``, so no call copies a time to the device.
"""

from __future__ import annotations

from typing import Callable, Sequence, Tuple

import numpy as np
import torch

State = Tuple[torch.Tensor, ...]
RHS = Callable[[State, np.float32], State]

_F32 = np.float32
# Dormand–Prince 4(5) Butcher tableau (scipy's RK45), as float32.
_C = np.array([0.0, 1 / 5, 3 / 10, 4 / 5, 8 / 9, 1.0, 1.0], _F32)
_A = [
    [],
    [1 / 5],
    [3 / 40, 9 / 40],
    [44 / 45, -56 / 15, 32 / 9],
    [19372 / 6561, -25360 / 2187, 64448 / 6561, -212 / 729],
    [9017 / 3168, -355 / 33, 46732 / 5247, 49 / 176, -5103 / 18656],
    [35 / 384, 0.0, 500 / 1113, 125 / 192, -2187 / 6784, 11 / 84],
]
_B5 = np.array([35 / 384, 0.0, 500 / 1113, 125 / 192, -2187 / 6784, 11 / 84, 0.0], _F32)
_B4 = np.array([5179 / 57600, 0.0, 7571 / 16695, 393 / 640, -92097 / 339200, 187 / 2100, 1 / 40],
               _F32)


def _axpy(a, x: State, y: State) -> State:
    """a·x + y, leaf by leaf, for a host float32 ``a``."""
    return tuple(torch.add(yi, xi, alpha=float(a)) for xi, yi in zip(x, y))


def _error_norm(err: State, y0: State, y1: State, rtol: float, atol: float) -> torch.Tensor:
    """RMS of err / (atol + rtol·max(|y0|, |y1|)) over every element."""
    total = sum(((e / (atol + rtol * torch.maximum(a.abs(), b.abs()))) ** 2).sum()
                for e, a, b in zip(err, y0, y1))
    return torch.sqrt(total / sum(e.numel() for e in err))


def odeint_rk45(f: RHS, y0: Sequence[torch.Tensor], t0: float, t1: float, rtol: float = 1e-5,
                atol: float = 1e-5, max_steps: int = 1000,
                first_step: float = 1e-3) -> Tuple[State, int]:
    """Integrate dy/dt = f(y, t) from t0 to t1 (t1 > t0). Returns (y(t1),
    nfe). ``nfe`` counts 6 per step, accepted or rejected, as the JAX package
    does (each step makes 7 calls of ``f``). A rejected step keeps t and y;
    reaching ``max_steps`` returns the state where it stands."""
    y = tuple(y0)
    t, t0, t1 = _F32(t0), _F32(t0), _F32(t1)
    h = _F32(first_step)
    steps = 0
    while t < t1 and steps < max_steps:
        h = min(h, _F32(t1 - t))
        ks = []
        for i in range(7):
            yi = y
            for j, aij in enumerate(_A[i]):
                yi = _axpy(h * _F32(aij), ks[j], yi)
            ks.append(f(yi, t + h * _C[i]))
        y5, y4 = y, y
        for i in range(7):
            y5 = _axpy(h * _B5[i], ks[i], y5)
            y4 = _axpy(h * _B4[i], ks[i], y4)
        err = tuple(a - b for a, b in zip(y5, y4))
        enorm = _F32(_error_norm(err, y, y5, rtol, atol).item())   # the step's one host read
        factor = np.clip(_F32(0.9) * (enorm + _F32(1e-10)) ** _F32(-0.2), _F32(0.2), _F32(10.0))
        h_next = np.clip(h * factor, _F32(1e-6), _F32(t1 - t0))
        if enorm <= 1.0:
            t, y = _F32(t + h), y5
        h = h_next
        steps += 1
    return y, 6 * steps


def odeint_rk4(f: RHS, y0: Sequence[torch.Tensor], t0: float, t1: float,
               num_steps: int = 200) -> State:
    """Classic RK4 on a fixed grid of ``num_steps`` steps."""
    h = (t1 - t0) / num_steps
    ts = _F32(h) * np.arange(num_steps, dtype=_F32) + _F32(t0)
    y = tuple(y0)
    for t in ts:
        k1 = f(y, t)
        k2 = f(_axpy(h / 2, k1, y), t + _F32(h / 2))
        k3 = f(_axpy(h / 2, k2, y), t + _F32(h / 2))
        k4 = f(_axpy(h, k3, y), t + _F32(h))
        incr = tuple((a + 2 * b + 2 * c + d) / 6 for a, b, c, d in zip(k1, k2, k3, k4))
        y = _axpy(h, incr, y)
    return y
