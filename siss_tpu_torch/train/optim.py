"""Optimizer and LR-schedule builders: port of ``siss_tpu/train/optim.py``.

The schedules are plain functions of the update count, evaluated at the
count before the update as optax does; the train step writes
``schedule(state.step)`` into the optimizer's param groups before each
``optimizer.step()``. AdamW/Adam map to ``torch.optim.AdamW``/``Adam`` with
the same betas, eps and (decoupled) weight decay as ``optax.adamw``/``adam``.
"""

from __future__ import annotations

import math
from typing import Any, Callable, Iterable, Optional, Tuple

import torch

Schedule = Callable[[int], float]


def _linear(init: float, end: float, steps: int) -> Schedule:
    def f(count: int) -> float:
        c = min(max(count, 0), steps)
        return (init - end) * (1.0 - c / steps) + end
    return f


def build_lr_schedule(name: str, base_lr: float, warmup_steps: int = 0,
                      total_steps: Optional[int] = None) -> Schedule:
    name = (name or "constant").lower()
    if name == "constant":
        def sched(count: int) -> float:
            return base_lr
    elif name == "cosine":
        decay_steps = max((total_steps or 10000) - warmup_steps, 1)

        def sched(count: int) -> float:
            c = min(count, decay_steps)
            return base_lr * 0.5 * (1.0 + math.cos(math.pi * c / decay_steps))
    elif name == "linear":
        sched = _linear(base_lr, 0.0, max((total_steps or 10000) - warmup_steps, 1))
    else:
        raise ValueError(f"Unknown lr_scheduler {name!r}")
    if warmup_steps > 0:
        warmup = _linear(0.0, base_lr, warmup_steps)
        main = sched

        def sched(count: int) -> float:
            return warmup(count) if count < warmup_steps else main(count - warmup_steps)
    return sched


def build_optimizer(cfg: Any, params: Iterable[torch.nn.Parameter],
                    lr_scheduler: str = "constant", warmup_steps: int = 0,
                    total_steps: Optional[int] = None) -> Tuple[torch.optim.Optimizer, Schedule]:
    """``cfg``: mapping with torch.optim.AdamW's keys (lr, betas,
    weight_decay, eps) and an optional ``_target_``. Returns the optimizer
    and its LR schedule."""
    target = str(cfg.get("_target_", "torch.optim.AdamW"))
    lr = float(cfg["lr"])
    betas = tuple(float(b) for b in cfg.get("betas", [0.9, 0.999]))
    wd = float(cfg.get("weight_decay", 0.0))
    eps = float(cfg.get("eps", cfg.get("adam_epsilon", 1e-8)))
    for knob in ("mu_dtype", "nu_dtype"):
        if cfg.get(knob, None):
            raise NotImplementedError(
                f"{knob} is not ported yet (ROADMAP Queue 1 item 6b, optimizer state dtypes)")
    sched = build_lr_schedule(lr_scheduler, lr, warmup_steps, total_steps)
    params = list(params)
    name = target.rsplit(".", 1)[-1].lower()
    if name == "adamw":
        opt = torch.optim.AdamW(params, lr=sched(0), betas=betas, eps=eps, weight_decay=wd)
    elif name == "adam":
        opt = torch.optim.Adam(params, lr=sched(0), betas=betas, eps=eps, weight_decay=0.0)
    elif name == "sgd":
        opt = torch.optim.SGD(params, lr=sched(0), momentum=float(cfg.get("momentum", 0.0)))
    elif name == "adafactor":
        raise NotImplementedError("adafactor is not ported yet (ROADMAP Queue 1 item 6b)")
    else:
        raise ValueError(f"Unsupported optimizer target {target!r}")
    return opt, sched
