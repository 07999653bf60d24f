"""Training state: port of ``siss_tpu/train/state.py``.

JAX's state is an immutable pytree returned anew by each step; here the
step updates the model, optimizer and EMA copy in place, which keeps one
copy of each on the card.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from siss_tpu_torch.train.ema import EMAState
from siss_tpu_torch.train.optim import Schedule


@dataclasses.dataclass
class TrainState:
    model: torch.nn.Module
    optimizer: torch.optim.Optimizer
    lr_schedule: Schedule
    step: int = 0
    ema: Optional[EMAState] = None

    @classmethod
    def create(cls, model: torch.nn.Module, optimizer: torch.optim.Optimizer,
               lr_schedule: Schedule, use_ema: bool = False) -> "TrainState":
        return cls(model=model, optimizer=optimizer, lr_schedule=lr_schedule, step=0,
                   ema=EMAState.create(model.parameters()) if use_ema else None)
