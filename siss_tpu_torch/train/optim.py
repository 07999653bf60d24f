"""Optimizer and LR-schedule builders: port of ``siss_tpu/train/optim.py``.

The schedules are plain functions of the update count, evaluated at the
count before the update as optax does; the train step writes
``schedule(state.step)`` into the optimizer's param groups before each
``optimizer.step()``, and every optimizer here reads its ``lr`` from there.
AdamW/Adam map to ``torch.optim.AdamW``/``Adam`` with the same betas, eps
and (decoupled) weight decay as ``optax.adamw``/``adam``. With
``mu_dtype``/``nu_dtype`` (the SD task's single-card memory mode) they map
to ``Adam`` below, which stores its moments in those types as optax does and
torch's optimizers cannot. ``adafactor`` is the JAX package's hand-built
optax chain (``Adafactor`` below).
"""

from __future__ import annotations

import math
from types import SimpleNamespace
from typing import Any, Callable, Iterable, Optional, Tuple

import numpy as np
import torch

from siss_tpu_torch.parallel.multihost import all_reduce_

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


def _decayed(moment: torch.Tensor, decay: float) -> torch.Tensor:
    """decay·moment as optax forms it: in the stored moment's type, with the
    decay rounded to that type (JAX's weak typing), then fp32."""
    return (moment * torch.tensor(decay, dtype=moment.dtype, device=moment.device)).float()


class Adam(torch.optim.Optimizer):
    """``optax.adam``/``adamw`` with ``mu_dtype`` (and the JAX package's
    ``cast_nu_dtype``): per update, the new moments are formed in fp32 from
    the stored ones, the step is taken from those uncast fp32 moments, and
    only then are they stored cast to ``mu_dtype``/``nu_dtype``. The update
    is p − lr·(m̂/(√v̂ + eps) + wd·p): decoupled decay, 0 for Adam."""

    def __init__(self, params, lr: float, betas=(0.9, 0.999), eps: float = 1e-8,
                 weight_decay: float = 0.0, mu_dtype: Optional[torch.dtype] = None,
                 nu_dtype: Optional[torch.dtype] = None):
        super().__init__(params, dict(lr=lr, betas=tuple(betas), eps=eps,
                                      weight_decay=weight_decay))
        self.mu_dtype, self.nu_dtype = mu_dtype, nu_dtype

    @torch.no_grad()
    def step(self, closure=None):
        for group in self.param_groups:
            (b1, b2), lr, eps, wd = group["betas"], group["lr"], group["eps"], group["weight_decay"]
            for p in group["params"]:
                if p.grad is None:
                    continue
                g = p.grad.float()
                st = self.state[p]
                if not st:
                    st["step"] = 0
                    st["mu"] = torch.zeros_like(p, dtype=self.mu_dtype or p.dtype)
                    st["nu"] = torch.zeros_like(p, dtype=self.nu_dtype or p.dtype)
                st["step"] += 1
                mu = (1 - b1) * g + _decayed(st["mu"], b1)
                nu = (1 - b2) * (g * g) + _decayed(st["nu"], b2)
                mu_hat = mu / np.float32(1 - np.float32(b1) ** st["step"])
                nu_hat = nu / np.float32(1 - np.float32(b2) ** st["step"])
                u = mu_hat / (nu_hat.sqrt() + eps)
                if wd:
                    u = u + wd * p
                p.sub_((lr * u).to(p.dtype))
                st["mu"], st["nu"] = mu.to(st["mu"].dtype), nu.to(st["nu"].dtype)

    def load_state_dict(self, state_dict):
        """torch casts loaded floating state to each param's type; the
        moments go back to their own types."""
        super().load_state_dict(state_dict)
        for st in self.state.values():
            st["mu"] = st["mu"].to(self.mu_dtype or st["mu"].dtype)
            st["nu"] = st["nu"].to(self.nu_dtype or st["nu"].dtype)


def factored_dims(shape) -> Optional[Tuple[int, int]]:
    """optax's ``_factored_dims`` with ``min_dim_size_to_factor`` 128: the
    (second largest, largest) dims of ``shape`` when the smaller is ≥ 128,
    else None. A torch OIHW or [out, in] param has the same two dims as its
    flax HWIO or [in, out] counterpart, and the factored estimate is
    symmetric in them, so both packages factor alike."""
    if len(shape) < 2:
        return None
    order = np.argsort(shape, kind="stable")
    if shape[order[-2]] < 128:
        return None
    return int(order[-2]), int(order[-1])


class Adafactor(torch.optim.Optimizer):
    """The JAX package's ``adafactor`` chain, per parameter:

    1. ``scale_by_factored_rms(decay_rate, epsilon)``: the second-moment
       estimate, factored over two dims (``factored_dims``) or full, with
       decay 1 − (k+1)^−decay_rate at update k;
    2. ``clip_by_block_rms(1.0)``;
    3. with ``multiply_by_parameter_scale``, × max(rms(p), 1e-3);
    4. × lr (before the momentum);
    5. with ``momentum``, its EMA (not debiased);
    6. with ``weight_decay``, + lr·wd·p (AdamW's decay, outside the EMA);
    7. p −= the result.

    With a ``sharding`` (``parallel.fsdp``), a parameter split over the
    ``fsdp`` or the ``tensor`` ranks, or both, is this rank's block of it:
    ``factored_dims`` reads its whole shape, and each mean over a split
    dimension, the update's RMS and the parameter's RMS are sums of the
    ranks' partial sums, over the axis that splits that dimension or over
    every axis that splits the leaf (``_step_split``). At ``fsdp`` 2 ×
    ``tensor`` 2 a conv or dense kernel's two factored dimensions are the
    two split ones, so ``v_row``'s and ``v_col``'s means run over different
    axes.
    """

    def __init__(self, params, lr: float, decay_rate: float = 0.8, eps: float = 1e-30,
                 momentum: Optional[float] = None, weight_decay: float = 0.0,
                 multiply_by_parameter_scale: bool = False, sharding=None):
        super().__init__(params, dict(lr=lr, decay_rate=decay_rate, eps=eps, momentum=momentum,
                                      weight_decay=weight_decay,
                                      multiply_by_parameter_scale=multiply_by_parameter_scale))
        self.sharding = sharding

    def _init_state(self, p: torch.Tensor, dims, momentum) -> dict:
        st = self.state[p]
        if not st:
            st["step"] = 0
            if dims is None:
                st["v"] = torch.zeros_like(p)
            else:
                st["v_row"] = torch.zeros_like(p.mean(dims[1]))
                st["v_col"] = torch.zeros_like(p.mean(dims[0]))
            if momentum is not None:
                st["ema"] = torch.zeros_like(p)
        return st

    def _apply(self, p: torch.Tensor, u: torch.Tensor, u_rms: torch.Tensor,
               p_rms: Optional[torch.Tensor], group: dict) -> None:
        """Steps 2–7 on the update ``u`` of RMS ``u_rms``, ``p_rms`` the
        parameter's RMS before the update."""
        lr, momentum, st = group["lr"], group["momentum"], self.state[p]
        u = u / torch.clamp(u_rms, min=1.0)
        if group["multiply_by_parameter_scale"]:
            u = u * torch.where(p_rms <= 1e-3, torch.full_like(p_rms, 1e-3), p_rms)
        u = lr * u
        if momentum is not None:
            u = st["ema"] = (1.0 - momentum) * u + momentum * st["ema"]
        if group["weight_decay"]:
            u = u + lr * group["weight_decay"] * p
        p.sub_(u.to(p.dtype))
        st["step"] += 1

    @torch.no_grad()
    def step(self, closure=None):
        for group in self.param_groups:
            eps, scale = group["eps"], group["multiply_by_parameter_scale"]
            split = []
            for p in group["params"]:
                if p.grad is None:
                    continue
                lay, shape = (None, p.shape) if self.sharding is None else self.sharding.layout(p)
                dims = factored_dims(shape)
                st = self._init_state(p, dims, group["momentum"])
                t = torch.tensor(st["step"] + 1, dtype=torch.float32)
                decay = float(1.0 - t ** -group["decay_rate"])
                g = p.grad.float()
                if lay is not None and lay.axes:
                    split.append(SimpleNamespace(p=p, g=g, st=st, lay=lay, shape=shape,
                                                 dims=dims, decay=decay))
                    continue
                g2 = g * g + eps
                if dims is None:
                    st["v"] = decay * st["v"] + (1.0 - decay) * g2
                    u = g * st["v"] ** -0.5
                else:
                    d1, d0 = dims
                    st["v_row"] = decay * st["v_row"] + (1.0 - decay) * g2.mean(d0)
                    st["v_col"] = decay * st["v_col"] + (1.0 - decay) * g2.mean(d1)
                    row_mean = st["v_row"].mean(d1 - 1 if d1 > d0 else d1, keepdim=True)
                    row = (st["v_row"] / row_mean) ** -0.5
                    u = g * row.unsqueeze(d0) * (st["v_col"] ** -0.5).unsqueeze(d1)
                p_rms = p.float().square().mean().sqrt() if scale else None
                self._apply(p, u, u.square().mean().sqrt(), p_rms, group)
            if split:
                self._step_split(split, group)

    def _sum(self, parts) -> None:
        """All-reduce (SUM) in place each (tensor, axes) of ``parts`` over
        the ranks along its axes: one bucketed all-reduce a set of axes."""
        for axes in dict.fromkeys(axes for _, axes in parts):
            all_reduce_([t for t, a in parts if a == axes], group=self.sharding.group(axes))

    def _step_split(self, recs, group: dict) -> None:
        """``step`` for the parameters split over the mesh, each a block
        split along one dimension or two (``Layout``): local partial sums,
        then three rounds of all-reduces for all of them at once. A
        factored mean over a split dimension is a sum over that dimension's
        axis (so ``v_row``'s and ``v_col``'s means may each run over
        another axis), the update's and the parameter's RMS sums over every
        axis that splits the leaf. Round 1: the factored sums and the
        parameter's; round 2: the sums of ``v_row`` over a split larger
        dimension (which need round 1's rows); round 3: the updates'."""
        eps, scale = group["eps"], group["multiply_by_parameter_scale"]
        first, second, third = [], [], []
        for r in recs:
            r.split = {d: (a,) for a, d in (("fsdp", r.lay.fsdp), ("tensor", r.lay.tensor))
                       if d is not None}
            g2 = r.g * r.g + eps
            if r.dims is None:
                r.st["v"] = r.decay * r.st["v"] + (1.0 - r.decay) * g2
                r.u = r.g * r.st["v"] ** -0.5
            else:
                d1, d0 = r.dims
                r.row = g2.sum(d0) if d0 in r.split else g2.mean(d0)
                r.col = g2.sum(d1) if d1 in r.split else g2.mean(d1)
                first += [(t, r.split[d]) for t, d in ((r.row, d0), (r.col, d1)) if d in r.split]
            if scale:
                r.p_sq = r.p.float().square().sum()
                first.append((r.p_sq, r.lay.axes))
        self._sum(first)
        for r in recs:
            if r.dims is not None:
                d1, d0 = r.dims
                row = r.row / r.shape[d0] if d0 in r.split else r.row
                r.st["v_row"] = r.decay * r.st["v_row"] + (1.0 - r.decay) * row
                if d1 in r.split:  # v_row is split along d1
                    r.row_sum = r.st["v_row"].sum(d1 - 1 if d1 > d0 else d1, keepdim=True)
                    second.append((r.row_sum, r.split[d1]))
        self._sum(second)
        for r in recs:
            if r.dims is not None:
                d1, d0 = r.dims
                if d1 in r.split:
                    row_mean, col = r.row_sum / r.shape[d1], r.col / r.shape[d1]
                else:
                    row_mean = r.st["v_row"].mean(d1 - 1 if d1 > d0 else d1, keepdim=True)
                    col = r.col
                r.st["v_col"] = r.decay * r.st["v_col"] + (1.0 - r.decay) * col
                row = (r.st["v_row"] / row_mean) ** -0.5
                r.u = r.g * row.unsqueeze(d0) * (r.st["v_col"] ** -0.5).unsqueeze(d1)
            r.u_sq = r.u.square().sum()
            third.append((r.u_sq, r.lay.axes))
        self._sum(third)
        for r in recs:
            n = math.prod(r.shape)
            p_rms = (r.p_sq / n).sqrt() if scale else None
            self._apply(r.p, r.u, (r.u_sq / n).sqrt(), p_rms, group)


def state_split_dim(key: str, state: torch.Tensor, dim: Optional[int], shape) -> Optional[int]:
    """The dimension along which optimizer state ``key`` of a parameter of
    whole shape ``shape``, split along ``dim`` (None: whole), is split
    (None: whole on every rank). Adafactor's factored rows and columns drop
    one of the factored dims: they are whole when that is the split one."""
    if dim is None:
        return None
    if key in ("v_row", "v_col"):
        d1, d0 = factored_dims(shape)
        dropped = d0 if key == "v_row" else d1
        return None if dim == dropped else dim - (dim > dropped)
    return dim if state.ndim == len(shape) else None


def state_layout(key: str, state: torch.Tensor, layout, shape):
    """The ``parallel.Layout`` of optimizer state ``key`` of a parameter of
    whole ``shape`` laid out as ``layout``: ``state_split_dim`` for each
    axis's dimension."""
    return layout._replace(tensor=state_split_dim(key, state, layout.tensor, shape),
                           fsdp=state_split_dim(key, state, layout.fsdp, shape))


def _dtype(name) -> Optional[torch.dtype]:
    return getattr(torch, str(name)) if name else None


def build_optimizer(cfg: Any, params: Iterable[torch.nn.Parameter],
                    lr_scheduler: str = "constant", warmup_steps: int = 0,
                    total_steps: Optional[int] = None,
                    sharding=None) -> Tuple[torch.optim.Optimizer, Schedule]:
    """``cfg``: mapping with torch.optim.AdamW's keys (lr, betas,
    weight_decay, eps), an optional ``_target_`` and, for AdamW/Adam,
    optional ``mu_dtype``/``nu_dtype``; for ``adafactor``, optional
    ``decay_rate``, ``eps`` (1e-30 unless set), ``momentum`` and
    ``multiply_by_parameter_scale``. ``sharding``: the ``parallel.fsdp``
    split of ``params``, which Adafactor reads (the other optimizers are
    elementwise and run on the blocks as they are). Returns the optimizer
    and its LR schedule."""
    target = str(cfg.get("_target_", "torch.optim.AdamW"))
    lr = float(cfg["lr"])
    betas = tuple(float(b) for b in cfg.get("betas", [0.9, 0.999]))
    wd = float(cfg.get("weight_decay", 0.0))
    eps = float(cfg.get("eps", cfg.get("adam_epsilon", 1e-8)))
    mu_dtype, nu_dtype = _dtype(cfg.get("mu_dtype", None)), _dtype(cfg.get("nu_dtype", None))
    sched = build_lr_schedule(lr_scheduler, lr, warmup_steps, total_steps)
    params = list(params)
    name = target.rsplit(".", 1)[-1].lower()
    if name in ("adafactor", "sgd") and (mu_dtype or nu_dtype):
        raise ValueError("mu_dtype/nu_dtype are Adam-state options; they have no effect with "
                         f"{name} — remove them or switch the optimizer target")
    if name in ("adamw", "adam") and (mu_dtype or nu_dtype):
        opt = Adam(params, lr=sched(0), betas=betas, eps=eps,
                   weight_decay=wd if name == "adamw" else 0.0,
                   mu_dtype=mu_dtype, nu_dtype=nu_dtype)
    elif name == "adamw":
        opt = torch.optim.AdamW(params, lr=sched(0), betas=betas, eps=eps, weight_decay=wd)
    elif name == "adam":
        opt = torch.optim.Adam(params, lr=sched(0), betas=betas, eps=eps, weight_decay=0.0)
    elif name == "sgd":
        opt = torch.optim.SGD(params, lr=sched(0), momentum=float(cfg.get("momentum", 0.0)))
    elif name == "adafactor":
        momentum = cfg.get("momentum", None)
        opt = Adafactor(params, lr=sched(0), decay_rate=float(cfg.get("decay_rate", 0.8)),
                        eps=float(cfg["eps"]) if "eps" in cfg else 1e-30,
                        momentum=None if momentum is None else float(momentum), weight_decay=wd,
                        multiply_by_parameter_scale=bool(cfg.get("multiply_by_parameter_scale",
                                                                 False)),
                        sharding=sharding)
    else:
        raise ValueError(f"Unsupported optimizer target {target!r}")
    return opt, sched
