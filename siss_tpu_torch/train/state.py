"""Training state: port of ``siss_tpu/train/state.py``.

JAX's state is an immutable pytree returned anew by each step; here the
step updates the model, optimizer and EMA copy in place, which keeps one
copy of each on the card.

The state knows how its model is laid out over the ranks (``sharding``, a
``parallel.fsdp.Sharding``; by default nothing split, every rank on the
``data`` axis). Under an ``fsdp`` or a ``tensor`` axis, or both, the
model's parameters, the optimizer's state and the EMA are this rank's
blocks; ``state_dict`` and ``load_state_dict`` gather and split them over
both axes, so a checkpoint has the one-process format whatever the mesh, as
orbax restores global arrays into any sharding.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional

import torch

from siss_tpu_torch.parallel.fsdp import Sharding, shard_module
from siss_tpu_torch.train.ema import EMAState
from siss_tpu_torch.train.optim import Schedule, state_layout


@dataclasses.dataclass
class TrainState:
    model: torch.nn.Module
    optimizer: torch.optim.Optimizer
    lr_schedule: Schedule
    step: int = 0
    ema: Optional[EMAState] = None
    sharding: Optional[Sharding] = None

    def __post_init__(self):
        if self.sharding is None:
            self.sharding = shard_module(self.model)

    @classmethod
    def create(cls, model: torch.nn.Module, optimizer: torch.optim.Optimizer,
               lr_schedule: Schedule, use_ema: bool = False,
               sharding: Optional[Sharding] = None) -> "TrainState":
        """``sharding``: how ``shard_module`` split ``model`` (before the
        optimizer was built on its parameters)."""
        return cls(model=model, optimizer=optimizer, lr_schedule=lr_schedule, step=0,
                   ema=EMAState.create(model.parameters()) if use_ema else None,
                   sharding=sharding)

    def ema_state_dict(self) -> Optional[Dict[str, torch.Tensor]]:
        """The whole EMA weights under the model's parameter names (a state
        dict the model loads), or None without EMA. Collective."""
        if self.ema is None:
            return None
        sh = self.sharding
        return dict(zip(sh.names, sh.gather_host(self.ema.params)))

    def _optimizer_layout(self, state: Dict[int, Dict[str, Any]]):
        """(index, key, ``Layout``) of each split tensor of an optimizer
        state dict's ``state``."""
        sh = self.sharding
        params = [p for g in self.optimizer.param_groups for p in g["params"]]
        out = []
        for idx in sorted(state):
            lay, shape = sh.layout(params[idx])
            if not lay.axes:
                continue
            for key, value in state[idx].items():
                if isinstance(value, torch.Tensor):
                    split = state_layout(key, value, lay, shape)
                    if split.axes:
                        out.append((idx, key, split))
        return out

    def state_dict(self) -> Dict[str, Any]:
        """Model, optimizer, EMA and step: what a resume needs, whole
        (collective on every rank). The LR schedule is a function of the
        step and is rebuilt from the config."""
        opt = self.optimizer.state_dict()
        layout = self._optimizer_layout(opt["state"])
        if layout:
            state = {idx: dict(st) for idx, st in opt["state"].items()}
            whole = self.sharding.gather_host([state[i][k] for i, k, _ in layout],
                                              [lay for *_, lay in layout])
            for (i, k, _), t in zip(layout, whole):
                state[i][k] = t
            opt = {**opt, "state": state}
        ema = None if self.ema is None else {"params": self.ema_state_dict(), "step": self.ema.step}
        return {"model": self.sharding.full_state_dict(), "optimizer": opt, "step": self.step,
                "ema": ema}

    def load_state_dict(self, sd: Dict[str, Any]) -> None:
        """Load a one-process state dict: each rank keeps its blocks."""
        sh = self.sharding
        sh.load_full_state_dict(sd["model"])
        opt = sd["optimizer"]
        layout = self._optimizer_layout(opt["state"])
        if layout:
            state = {idx: dict(st) for idx, st in opt["state"].items()}
            for i, k, lay in layout:
                state[i][k] = sh.take(state[i][k], lay).clone()
            opt = {**opt, "state": state}
        self.optimizer.load_state_dict(opt)
        self.step = int(sd["step"])
        if (self.ema is None) != (sd["ema"] is None):
            raise ValueError("the checkpoint's EMA does not match this state's use_ema")
        if self.ema is not None:
            with torch.no_grad():
                for e, name, lay in zip(self.ema.params, sh.names, sh.layouts):
                    e.copy_(sh.take(sd["ema"]["params"][name], lay))
            self.ema.step = int(sd["ema"]["step"])

    def held_bytes(self) -> Dict[str, int]:
        """Bytes of the parameters, the optimizer's tensors and the EMA this
        rank holds."""
        def size(ts: List[torch.Tensor]) -> int:
            return sum(t.numel() * t.element_size() for t in ts)

        moments = [v for st in self.optimizer.state.values() for v in st.values()
                   if isinstance(v, torch.Tensor)]
        return {"params": size(list(self.model.parameters())), "optimizer": size(moments),
                "ema": size(self.ema.params) if self.ema is not None else 0}
