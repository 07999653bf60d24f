"""Training state: port of ``siss_tpu/train/state.py``.

JAX's state is an immutable pytree returned anew by each step; here the
step updates the model, optimizer and EMA copy in place, which keeps one
copy of each on the card.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

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

    def ema_state_dict(self) -> Optional[Dict[str, torch.Tensor]]:
        """The EMA weights under the model's parameter names (a state dict
        the model loads), or None without EMA."""
        if self.ema is None:
            return None
        return {name: e for (name, _), e in zip(self.model.named_parameters(), self.ema.params)}

    def state_dict(self) -> Dict[str, Any]:
        """Model, optimizer, EMA and step: what a resume needs. The LR
        schedule is a function of the step and is rebuilt from the config."""
        ema = None if self.ema is None else {"params": self.ema_state_dict(), "step": self.ema.step}
        return {"model": self.model.state_dict(), "optimizer": self.optimizer.state_dict(),
                "step": self.step, "ema": ema}

    def load_state_dict(self, sd: Dict[str, Any]) -> None:
        self.model.load_state_dict(sd["model"])
        self.optimizer.load_state_dict(sd["optimizer"])
        self.step = int(sd["step"])
        if (self.ema is None) != (sd["ema"] is None):
            raise ValueError("the checkpoint's EMA does not match this state's use_ema")
        if self.ema is not None:
            names = [name for name, _ in self.model.named_parameters()]
            with torch.no_grad():
                for e, name in zip(self.ema.params, names):
                    e.copy_(sd["ema"]["params"][name])
            self.ema.step = int(sd["ema"]["step"])
