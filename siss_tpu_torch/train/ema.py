"""Exponential moving average of parameters: port of ``siss_tpu/train/ema.py``.

diffusers ``EMAModel`` decay: ``decay = 1 − (1 + step/inv_gamma)^(−power)``,
clamped to ``[min_decay, max_decay]``, computed in float32 as in the JAX
package. The update runs in place on the EMA copy.
"""

from __future__ import annotations

import dataclasses
from typing import List

import numpy as np
import torch


@dataclasses.dataclass
class EMAState:
    params: List[torch.Tensor]
    step: int = 0

    @classmethod
    def create(cls, params) -> "EMAState":
        return cls(params=[p.detach().clone() for p in params], step=0)


def ema_decay(step: int, inv_gamma: float = 1.0, power: float = 0.75,
              min_decay: float = 0.0, max_decay: float = 0.9999) -> float:
    f32 = np.float32
    value = f32(1.0) - (f32(1.0) + f32(step) / f32(inv_gamma)) ** f32(-power)
    return float(np.clip(value, f32(min_decay), f32(max_decay)))


@torch.no_grad()
def ema_update(state: EMAState, new_params, inv_gamma: float = 1.0, power: float = 0.75,
               min_decay: float = 0.0, max_decay: float = 0.9999) -> EMAState:
    """e ← e − (1 − decay)·(e − p), in place; returns ``state``."""
    state.step += 1
    decay = ema_decay(state.step, inv_gamma, power, min_decay, max_decay)
    one_minus = float(np.float32(1.0) - np.float32(decay))
    new = [p.detach().to(e.dtype) for e, p in zip(state.params, new_params)]
    torch._foreach_add_(state.params, torch._foreach_sub(state.params, new), alpha=-one_minus)
    return state
