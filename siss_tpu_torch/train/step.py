"""The unlearning train step: loss → paired gradients → surgery → update;
and the DDPM pretraining step (``build_pretrain_step``).

Port of ``siss_tpu/train/step.py``. Per microbatch, q(x_t|x_0) noising of
the keep and forget latents with shared noise, then one of four gradient
paths, picked by ``loss_fn`` as in the JAX step:

* the scalar path (``simple_neg_del``, ``naive_del``): one gradient of
  ``loss.sum()/mb``, clipped; no surgery;
* the fused SISS path (``importance_sampling_with_mixture`` with
  ``fused_siss``): the Bernoulli(λ) mixture, ONE UNet forward, the fused
  epilogue (``ops.siss``: the ``siss_reduce`` and ``siss_bwd`` kernels on
  the card) and TWO gradient pulls from that forward (``retain_graph``);
* the shared-forward path (``subscore_bernoulli``, and SISS with
  ``fused_siss=False``): the loss method's one forward, two pulls;
* the two-forward path (``double_forward_with_neg_del``, ``erasediff``):
  each term differentiated through only its own UNet call.

The two gradients accumulate in fp32 over the microbatches and are
averaged; then the surgery g = clip(g_x − s·g_a, max_grad_norm) with
s = scaling_norm/‖g_a‖, or EraseDiff's projection s = −max(η −
⟨g_x, g_a⟩/‖g_a‖², 0); then the optimizer and EMA updates.
``fused_surgery`` picks between the JAX step's two forms of the surgery,
which differ only in how EraseDiff's ‖g_a‖² is formed (a sum of squares, or
the square of the norm); the combine and the clip are one sequence here.

Dynamic loss scalars (``superfactor``, or λ off the fused path) are plain
numbers or 0-d tensors, or [A] tensors that give each microbatch its own
value. Normalisation matches the reference: each microbatch loss is
``sum()/microbatch``, gradients are averaged over accumulation steps. The
SD options of ROADMAP item 6b raise ``NotImplementedError`` when the step
is built.
"""

from __future__ import annotations

import dataclasses
import inspect
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch

from siss_tpu_torch.diffusion.schedule import NoiseSchedule, q_sample, snr_weights
from siss_tpu_torch.losses.deletion import (
    LOSS_DRAWS,
    LOSS_FUNCTIONS,
    SCALAR_PATH_LOSSES,
    SHARED_FORWARD_LOSSES,
    DeletionLoss,
)
from siss_tpu_torch.ops.siss import siss_weighted_sums
from siss_tpu_torch.train.ema import ema_update
from siss_tpu_torch.train.state import TrainState

EpsApply = Callable[[torch.nn.Module, torch.Tensor, torch.Tensor, Any], torch.Tensor]
# (model, noisy latents [B, H, W, C], timesteps [B], conditioning) -> eps [B, H, W, C]


def unet_eps_apply(model: torch.nn.Module, x: torch.Tensor, t: torch.Tensor, cond: Any) -> torch.Tensor:
    """Run an NCHW UNet on NHWC latents. The permutes are views: an NHWC
    tensor viewed as NCHW is in channels_last format, which the model on the
    card keeps, so its NCHW output viewed as NHWC is contiguous again."""
    del cond
    return model(x.permute(0, 3, 1, 2), t).permute(0, 2, 3, 1)


def cond_unet_eps_apply(model: torch.nn.Module, x: torch.Tensor, t: torch.Tensor,
                        cond: torch.Tensor) -> torch.Tensor:
    """``unet_eps_apply`` for a conditional UNet: ``cond`` [B, L, D] goes in
    as its ``encoder_hidden_states``."""
    return model(x.permute(0, 3, 1, 2), t, cond).permute(0, 2, 3, 1)


def global_norm(tensors: Sequence[torch.Tensor]) -> torch.Tensor:
    """Global L2 norm of a list of tensors, accumulated in float32."""
    norms = torch._foreach_norm([t.float() for t in tensors])
    return torch.linalg.vector_norm(torch.stack(norms))


def tree_dot(a: Sequence[torch.Tensor], b: Sequence[torch.Tensor]) -> torch.Tensor:
    """Σ over the lists of ⟨a_i, b_i⟩, in float32."""
    return torch.stack([torch.dot(x.float().reshape(-1), y.float().reshape(-1))
                        for x, y in zip(a, b)]).sum()


def clip_by_global_norm(tensors: Sequence[torch.Tensor], max_norm: float):
    """torch.nn.utils.clip_grad_norm_ semantics; returns (clipped, norm)."""
    norm = global_norm(tensors)
    scale = torch.clamp(max_norm / (norm + 1e-6), max=1.0)
    return [t * scale.to(t.dtype) for t in tensors], norm


def _tensor_stats(x: torch.Tensor, prefix: str) -> Dict[str, torch.Tensor]:
    """mean|max|min|std over per-sample values; std is the population std."""
    x = x.detach()
    per_sample = x.mean(dim=tuple(range(1, x.ndim))) if x.ndim > 1 else x
    return {
        f"{prefix}/mean": x.mean(),
        f"{prefix}/max": per_sample.max(),
        f"{prefix}/min": per_sample.min(),
        f"{prefix}/std": per_sample.std(correction=0),
    }


@dataclasses.dataclass(frozen=True)
class DeletionStepConfig:
    """Static knobs of the unlearning step, as in the JAX package."""

    loss_fn: str = "importance_sampling_with_mixture"
    loss_params: Tuple[Tuple[str, float], ...] = (("lambd", 0.5),)
    scaling_norm: float = 5.0
    eta: float = 1e-3
    max_grad_norm: float = 1.0
    grad_accum_steps: int = 1
    t_min: int = 0
    t_max: int = 1000
    guard_inf_scaling: bool = True
    use_ema: bool = False
    ema_inv_gamma: float = 1.0
    ema_power: float = 0.75
    ema_max_decay: float = 0.9999
    noise_offset: float = 0.0
    input_perturbation: float = 0.0
    fused_siss: bool = True
    batched_dual_backward: bool = False
    grad_accum_dtype: str = "float32"
    fused_surgery: bool = True
    param_cast_dtype: Optional[str] = None

    def __post_init__(self):
        if self.loss_fn == "modified_noise_obj":
            raise NotImplementedError(
                "modified_noise_obj is an abandoned variant in the reference "
                f"(config option with no implementation); choose one of {LOSS_FUNCTIONS}")
        if self.loss_fn not in LOSS_FUNCTIONS:
            raise ValueError(f"Unknown loss_fn {self.loss_fn!r}; choose one of {LOSS_FUNCTIONS}")

    @property
    def is_scalar_path(self) -> bool:
        return self.loss_fn in SCALAR_PATH_LOSSES

    @property
    def is_shared_forward(self) -> bool:
        return self.loss_fn in SHARED_FORWARD_LOSSES

    @property
    def is_fused_siss(self) -> bool:
        return self.loss_fn == "importance_sampling_with_mixture" and self.fused_siss


def _check_ported(cfg: DeletionStepConfig) -> None:
    checks = [
        (cfg.noise_offset != 0.0, "noise_offset"),
        (cfg.input_perturbation != 0.0, "input_perturbation"),
        (cfg.batched_dual_backward, "batched_dual_backward"),
        (cfg.grad_accum_dtype != "float32", f"grad_accum_dtype={cfg.grad_accum_dtype!r}"),
        (cfg.param_cast_dtype is not None, "param_cast_dtype"),
    ]
    for bad, what in checks:
        if bad:
            raise NotImplementedError(f"{what} is not ported yet (ROADMAP Queue 1 item 6b)")


def draw_microbatch_randomness(generator: torch.Generator, A: int, mb: int, shape,
                               t_min: int, t_max: int, device,
                               uniform_target: bool = False) -> Dict[str, torch.Tensor]:
    """The step's draws for A microbatches: noise ~ N(0,1) [A, mb, ...],
    t ~ U{t_min..t_max−1} [A, mb], u ~ U[0,1) [A, mb] (the mixtures' keep
    test) and, with ``uniform_target``, EraseDiff's forget target
    "uniform" ~ U[0,1) [A, mb, ...]."""
    draws = {
        "noise": torch.randn((A, mb) + tuple(shape), generator=generator, device=device),
        "t": torch.randint(t_min, t_max, (A, mb), generator=generator, device=device),
        "u": torch.rand((A, mb), generator=generator, device=device),
    }
    if uniform_target:
        draws["uniform"] = torch.rand((A, mb) + tuple(shape), generator=generator, device=device)
    return draws


def build_deletion_train_step(eps_apply: EpsApply, schedule: NoiseSchedule,
                              cfg: DeletionStepConfig):
    """Returns ``step(state, batch, generator=None, dyn_scalars=None,
    draws=None) -> (state, metrics)``.

    ``batch``: dict with "all" and "deletion", [A, mb, H, W, C] keep-set and
    forget-set clean latents (A = accumulation steps), and an optional
    "conditioning" with leading [A, mb] axes. ``draws``: an optional dict as
    ``draw_microbatch_randomness`` makes it ("noise", "t", "u", and
    "uniform" for EraseDiff) to use instead of drawing from ``generator``.
    ``dyn_scalars``: loss parameters decayed at run time, merged over
    ``cfg.loss_params``. The step updates ``state`` in place and returns it
    with a dict of 0-d metric tensors.
    """
    _check_ported(cfg)
    loss_method = getattr(DeletionLoss(gamma=schedule.gamma, sigma=schedule.sigma), cfg.loss_fn)
    # Keep only the params the chosen loss accepts, so one config sweeps
    # across loss_fns without editing loss_params.
    accepted = set(inspect.signature(loss_method).parameters)
    static_params = {k: v for k, v in dict(cfg.loss_params).items() if k in accepted}
    draw_name = LOSS_DRAWS.get(cfg.loss_fn)

    def microbatch_terms(model, keep, forget, cond, dr, dyn):
        """The loss method's outputs and stats for one microbatch."""
        noise, t = dr["noise"], dr["t"]
        all_samples = {"og_latents": keep, "noisy_latents": q_sample(schedule, keep, noise, t)}
        deletion_samples = {"og_latents": forget,
                            "noisy_latents": q_sample(schedule, forget, noise, t)}
        params = {**static_params, **{k: v for k, v in dyn.items() if k in accepted}}
        out = loss_method(lambda x, tt, c: eps_apply(model, x, tt, c), dr.get(draw_name), t,
                          noise, cond, all_samples, deletion_samples, **params)
        stats = {}
        for name in ("loss", "loss_x", "loss_a", "importance_weight_x", "importance_weight_a"):
            if getattr(out, name) is not None:
                stats.update(_tensor_stats(getattr(out, name), name))
        return out, stats

    if cfg.is_scalar_path:

        def micro_grads(params, model, keep, forget, cond, dr, dyn):
            out, stats = microbatch_terms(model, keep, forget, cond, dr, dyn)
            return torch.autograd.grad(out.loss.sum() / keep.shape[0], params), None, stats

    elif cfg.is_fused_siss:
        lambd = float(static_params["lambd"])

        def micro_grads(params, model, keep, forget, cond, dr, dyn):
            if "lambd" in dyn:
                raise ValueError("dynamic lambd is not supported by the fused SISS path; "
                                 "set fused_siss=False to decay lambd at runtime")
            mb = keep.shape[0]
            noise, t = dr["noise"], dr["t"]
            mask = (dr["u"] > lambd).reshape((mb,) + (1,) * (keep.ndim - 1))
            mix = torch.where(mask, q_sample(schedule, keep, noise, t),
                              q_sample(schedule, forget, noise, t))
            preds = eps_apply(model, mix, t, cond)
            wlx, wla, aux = siss_weighted_sums(preds, mix, keep, forget, schedule.gamma[t],
                                               schedule.sigma[t], lambd)
            stats = {}
            stats.update(_tensor_stats(aux["lx_mean"], "loss_x"))
            stats.update(_tensor_stats(aux["la_mean"], "loss_a"))
            stats.update(_tensor_stats(aux["iw_x"], "importance_weight_x"))
            stats.update(_tensor_stats(aux["iw_a"], "importance_weight_a"))
            # ONE forward, TWO backward pulls over the shared graph.
            g_x = torch.autograd.grad(wlx / mb, params, retain_graph=True)
            return g_x, torch.autograd.grad(wla / mb, params), stats

    elif cfg.is_shared_forward:

        def micro_grads(params, model, keep, forget, cond, dr, dyn):
            out, stats = microbatch_terms(model, keep, forget, cond, dr, dyn)
            mb = keep.shape[0]
            g_x = torch.autograd.grad(out.weighted_loss_x.sum() / mb, params, retain_graph=True)
            return g_x, torch.autograd.grad(out.weighted_loss_a.sum() / mb, params), stats

    else:  # double_forward_with_neg_del, erasediff

        def micro_grads(params, model, keep, forget, cond, dr, dyn):
            # Each term through only its own UNet forward (2 forwards + 2
            # backwards; the loss method would run both forwards per term).
            mb = keep.shape[0]
            noise, t = dr["noise"], dr["t"]
            target_a = dr["uniform"] if cfg.loss_fn == "erasediff" else noise
            lx = (eps_apply(model, q_sample(schedule, keep, noise, t), t, cond) - noise) ** 2
            g_x = torch.autograd.grad(lx.sum() / mb, params)
            la = (eps_apply(model, q_sample(schedule, forget, noise, t), t, cond) - target_a) ** 2
            g_a = torch.autograd.grad(la.sum() / mb, params)
            return g_x, g_a, {**_tensor_stats(lx, "loss_x"), **_tensor_stats(la, "loss_a")}

    def step(state: TrainState, batch: Dict[str, Any], generator: Optional[torch.Generator] = None,
             dyn_scalars: Optional[Dict[str, Any]] = None,
             draws: Optional[Dict[str, torch.Tensor]] = None):
        dyn_scalars = dyn_scalars or {}
        keep_all, forget_all = batch["all"], batch["deletion"]
        cond_all = batch.get("conditioning")
        A, mb = keep_all.shape[:2]
        if draws is None:
            if generator is None:
                raise ValueError("pass a torch.Generator or explicit draws")
            draws = draw_microbatch_randomness(generator, A, mb, keep_all.shape[2:],
                                               cfg.t_min, cfg.t_max, keep_all.device,
                                               uniform_target=cfg.loss_fn == "erasediff")
        # [A] scalars vary per microbatch (the task decays superfactor once
        # per microbatch); other scalars hold for every microbatch.
        per_mb = {k for k, v in dyn_scalars.items()
                  if getattr(v, "ndim", 0) >= 1 and v.shape[0] == A}

        model = state.model
        params = list(model.parameters())
        g_x_acc = [torch.zeros_like(p, dtype=torch.float32) for p in params]
        g_a_acc = None if cfg.is_scalar_path else [torch.zeros_like(p, dtype=torch.float32)
                                                   for p in params]
        stats_mb: Dict[str, List[torch.Tensor]] = {}
        for a in range(A):
            cond = None if cond_all is None else cond_all[a]
            dyn = {k: v[a] if k in per_mb else v for k, v in dyn_scalars.items()}
            g_x, g_a, stats = micro_grads(params, model, keep_all[a], forget_all[a], cond,
                                          {k: v[a] for k, v in draws.items()}, dyn)
            torch._foreach_add_(g_x_acc, [g.float() for g in g_x])
            if g_a is not None:
                torch._foreach_add_(g_a_acc, [g.float() for g in g_a])
            del g_x, g_a
            for k, v in stats.items():
                stats_mb.setdefault(k, []).append(v)
        # Mean over microbatches (Accelerate divides by accumulation steps).
        torch._foreach_div_(g_x_acc, A)

        # Extrema keep their semantics across microbatches; means/stds average.
        metrics = {}
        for k, vs in stats_mb.items():
            v = torch.stack(vs)
            metrics[k] = v.max() if k.endswith("/max") else v.min() if k.endswith("/min") else v.mean()

        if cfg.is_scalar_path:
            final, pre_clip_norm = clip_by_global_norm(g_x_acc, cfg.max_grad_norm)
        else:
            torch._foreach_div_(g_a_acc, A)
            final, pre_clip_norm = _surgery(cfg, g_x_acc, g_a_acc, metrics)
        metrics["gradient/pre_clip_norm"] = pre_clip_norm
        _apply_update(state, params, final, cfg.ema_inv_gamma, cfg.ema_power, cfg.ema_max_decay)
        return state, metrics

    return step


def _surgery(cfg: DeletionStepConfig, g_x: List[torch.Tensor], g_a: List[torch.Tensor],
             metrics: Dict[str, torch.Tensor]):
    """clip(g_x − s·g_a), written into the g_x buffers; logs ‖g_x‖, ‖g_a‖
    and s. Returns (final gradient, its pre-clip norm)."""
    norm_x = global_norm(g_x)
    norm_a = global_norm(g_a)
    if cfg.loss_fn == "erasediff":
        # EraseDiff's projected-gradient step.
        norm_a_sq = (torch.stack(torch._foreach_norm(g_a)) ** 2).sum() if cfg.fused_surgery \
            else norm_a ** 2
        scaling = -torch.clamp(cfg.eta - tree_dot(g_x, g_a) / norm_a_sq, min=0.0)
    else:
        scaling = cfg.scaling_norm / norm_a
    if cfg.guard_inf_scaling:
        scaling = torch.where(torch.isfinite(scaling), scaling, torch.zeros_like(scaling))
    # Exact combine-then-norm (the closed form ‖x‖² − 2s⟨x,a⟩ + s²‖a‖²
    # loses precision to cancellation when the surgery nearly zeroes the
    # gradient).
    torch._foreach_mul_(g_a, scaling)
    torch._foreach_sub_(g_x, g_a)
    pre_clip_norm = global_norm(g_x)
    torch._foreach_mul_(g_x, torch.clamp(cfg.max_grad_norm / (pre_clip_norm + 1e-6), max=1.0))
    metrics["gradient/norm_loss_x"] = norm_x
    metrics["gradient/norm_loss_a"] = norm_a
    metrics["gradient/scaling_factor"] = scaling
    return g_x, pre_clip_norm


def _apply_update(state: TrainState, params: List[torch.Tensor], grads: Sequence[torch.Tensor],
                  ema_inv_gamma: float, ema_power: float, ema_max_decay: float) -> None:
    """The optimizer update with ``schedule(state.step)`` as its LR, then
    the EMA update and the step count, all in place."""
    for p, g in zip(params, grads):
        p.grad = g.to(p.dtype)
    lr = state.lr_schedule(state.step)
    for group in state.optimizer.param_groups:
        group["lr"] = lr
    state.optimizer.step()
    state.optimizer.zero_grad(set_to_none=True)
    if state.ema is not None:
        ema_update(state.ema, params, inv_gamma=ema_inv_gamma, power=ema_power,
                   max_decay=ema_max_decay)
    state.step += 1


def build_pretrain_step(eps_apply: EpsApply, schedule: NoiseSchedule, *,
                        prediction_type: str = "epsilon", max_grad_norm: float = 1.0,
                        ema_inv_gamma: float = 1.0, ema_power: float = 0.75,
                        ema_max_decay: float = 0.9999):
    """The DDPM pretraining step of ``siss_tpu/train/step.py``: ε-MSE, or
    the SNR-weighted sample-prediction loss, clipped by global norm, then the
    optimizer and EMA updates.

    Returns ``step(state, batch, generator=None, draws=None) -> (state,
    metrics)``; ``batch`` is [B, H, W, C] clean images; ``draws`` an optional
    dict of "noise" [B, H, W, C] and "t" [B] used instead of drawing from
    ``generator`` (t ~ U{0..T−1}). Metrics: "loss" and
    "gradient/pre_clip_norm"."""
    if prediction_type not in ("epsilon", "sample"):
        raise ValueError(prediction_type)

    def step(state: TrainState, batch: torch.Tensor, generator: Optional[torch.Generator] = None,
             draws: Optional[Dict[str, torch.Tensor]] = None):
        if draws is None:
            if generator is None:
                raise ValueError("pass a torch.Generator or explicit draws")
            draws = {"noise": torch.randn(batch.shape, generator=generator, dtype=batch.dtype,
                                          device=batch.device),
                     "t": torch.randint(0, schedule.num_train_timesteps, (batch.shape[0],),
                                        generator=generator, device=batch.device)}
        noise, t = draws["noise"], draws["t"]
        pred = eps_apply(state.model, q_sample(schedule, batch, noise, t), t, None)
        if prediction_type == "epsilon":
            loss = ((pred - noise) ** 2).mean()
        else:
            loss = (snr_weights(schedule, t, pred) * (pred - batch) ** 2).mean()
        params = list(state.model.parameters())
        grads, grad_norm = clip_by_global_norm(torch.autograd.grad(loss, params), max_grad_norm)
        _apply_update(state, params, grads, ema_inv_gamma, ema_power, ema_max_decay)
        return state, {"loss": loss.detach(), "gradient/pre_clip_norm": grad_norm}

    return step
