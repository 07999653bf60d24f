"""The unlearning train step: loss → paired gradients → surgery → update;
and the DDPM pretraining step (``build_pretrain_step``).

Port of the fused SISS branch of ``siss_tpu/train/step.py``: per
microbatch, q(x_t|x_0) noising of the keep and forget latents with shared
noise, the Bernoulli(λ) keep/forget mixture, ONE UNet forward, the fused
SISS epilogue (``ops.siss``), and TWO gradient pulls from that forward
(``retain_graph=True``). The two gradients accumulate in fp32 over the
microbatches and are averaged; then the surgery
g = clip(g_x − (scaling_norm/‖g_a‖)·g_a, max_grad_norm), the optimizer
update and the EMA update.

Normalisation matches the reference: each microbatch loss is
``sum()/microbatch``, gradients are averaged over accumulation steps.

Branches of the JAX step that are not ported yet raise
``NotImplementedError`` when the step is built.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch

from siss_tpu_torch.diffusion.schedule import NoiseSchedule, q_sample, snr_weights
from siss_tpu_torch.ops.siss import siss_weighted_sums
from siss_tpu_torch.train.ema import ema_update
from siss_tpu_torch.train.state import TrainState

EpsApply = Callable[[torch.nn.Module, torch.Tensor, torch.Tensor, Any], torch.Tensor]
# (model, noisy latents [B, H, W, C], timesteps [B], conditioning) -> eps [B, H, W, C]

LOSS_FUNCTIONS = (
    "importance_sampling_with_mixture",
    "double_forward_with_neg_del",
    "erasediff",
    "simple_neg_del",
    "naive_del",
    "subscore_bernoulli",
)


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


def clip_by_global_norm(tensors: Sequence[torch.Tensor], max_norm: float):
    """torch.nn.utils.clip_grad_norm_ semantics; returns (clipped, norm)."""
    norm = global_norm(tensors)
    scale = torch.clamp(max_norm / (norm + 1e-6), max=1.0)
    return [t * scale.to(t.dtype) for t in tensors], norm


def _tensor_stats(x: torch.Tensor, prefix: str) -> Dict[str, torch.Tensor]:
    """mean|max|min|std over per-sample values; std is the population std."""
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


def _check_ported(cfg: DeletionStepConfig) -> None:
    later = "is not ported yet (ROADMAP Queue 1 item 6)"
    if cfg.loss_fn != "importance_sampling_with_mixture":
        raise NotImplementedError(f"loss_fn={cfg.loss_fn!r} {later}; only the fused SISS path is")
    checks = [
        (not cfg.fused_siss, "fused_siss=False"),
        (cfg.noise_offset != 0.0, "noise_offset"),
        (cfg.input_perturbation != 0.0, "input_perturbation"),
        (cfg.batched_dual_backward, "batched_dual_backward"),
        (cfg.grad_accum_dtype != "float32", f"grad_accum_dtype={cfg.grad_accum_dtype!r}"),
        (cfg.param_cast_dtype is not None, "param_cast_dtype"),
        (not cfg.fused_surgery, "fused_surgery=False"),
    ]
    for bad, what in checks:
        if bad:
            raise NotImplementedError(f"{what} {later}")


def draw_microbatch_randomness(generator: torch.Generator, A: int, mb: int, shape,
                               t_min: int, t_max: int, device) -> Dict[str, torch.Tensor]:
    """The step's draws for A microbatches: noise ~ N(0,1) [A, mb, ...],
    t ~ U{t_min..t_max−1} [A, mb], u ~ U[0,1) [A, mb]."""
    return {
        "noise": torch.randn((A, mb) + tuple(shape), generator=generator, device=device),
        "t": torch.randint(t_min, t_max, (A, mb), generator=generator, device=device),
        "u": torch.rand((A, mb), generator=generator, device=device),
    }


def build_deletion_train_step(eps_apply: EpsApply, schedule: NoiseSchedule,
                              cfg: DeletionStepConfig):
    """Returns ``step(state, batch, generator=None, dyn_scalars=None,
    draws=None) -> (state, metrics)``.

    ``batch``: dict with "all" and "deletion", [A, mb, H, W, C] keep-set and
    forget-set clean latents (A = accumulation steps), and an optional
    "conditioning" with leading [A, mb] axes. ``draws``: optional dict of
    "noise" [A, mb, H, W, C], "t" [A, mb] and "u" [A, mb] to use instead
    of drawing from ``generator``. The step updates ``state`` in place and
    returns it with a dict of 0-d metric tensors.
    """
    _check_ported(cfg)
    lambd = float(dict(cfg.loss_params)["lambd"])

    def micro_grads(params: List[torch.Tensor], model, keep, forget, cond, noise, t, u):
        mb = keep.shape[0]
        noisy_keep = q_sample(schedule, keep, noise, t)
        noisy_forget = q_sample(schedule, forget, noise, t)
        mask = (u > lambd).reshape((mb,) + (1,) * (keep.ndim - 1))
        mix = torch.where(mask, noisy_keep, noisy_forget)
        gamma_t = schedule.gamma[t]
        sigma_t = schedule.sigma[t]

        preds = eps_apply(model, mix, t, cond)
        wlx, wla, aux = siss_weighted_sums(preds, mix, keep, forget, gamma_t, sigma_t, lambd)
        stats = {}
        stats.update(_tensor_stats(aux["lx_mean"], "loss_x"))
        stats.update(_tensor_stats(aux["la_mean"], "loss_a"))
        stats.update(_tensor_stats(aux["iw_x"], "importance_weight_x"))
        stats.update(_tensor_stats(aux["iw_a"], "importance_weight_a"))
        # ONE forward, TWO backward pulls over the shared graph.
        g_x = torch.autograd.grad(wlx / mb, params, retain_graph=True)
        g_a = torch.autograd.grad(wla / mb, params)
        return g_x, g_a, stats

    def step(state: TrainState, batch: Dict[str, Any], generator: Optional[torch.Generator] = None,
             dyn_scalars: Optional[Dict[str, Any]] = None,
             draws: Optional[Dict[str, torch.Tensor]] = None):
        if dyn_scalars and "lambd" in dyn_scalars:
            raise ValueError("dynamic lambd is not supported by the fused SISS path; "
                             "set fused_siss=False to decay lambd at runtime")
        keep_all, forget_all = batch["all"], batch["deletion"]
        cond_all = batch.get("conditioning")
        A, mb = keep_all.shape[:2]
        if draws is None:
            if generator is None:
                raise ValueError("pass a torch.Generator or explicit draws")
            draws = draw_microbatch_randomness(generator, A, mb, keep_all.shape[2:],
                                               cfg.t_min, cfg.t_max, keep_all.device)

        model = state.model
        params = list(model.parameters())
        g_x_acc = [torch.zeros_like(p, dtype=torch.float32) for p in params]
        g_a_acc = [torch.zeros_like(p, dtype=torch.float32) for p in params]
        per_mb: Dict[str, List[torch.Tensor]] = {}
        for a in range(A):
            cond = None if cond_all is None else cond_all[a]
            g_x, g_a, stats = micro_grads(params, model, keep_all[a], forget_all[a], cond,
                                          draws["noise"][a], draws["t"][a], draws["u"][a])
            torch._foreach_add_(g_x_acc, [g.float() for g in g_x])
            torch._foreach_add_(g_a_acc, [g.float() for g in g_a])
            del g_x, g_a
            for k, v in stats.items():
                per_mb.setdefault(k, []).append(v.detach())
        # Mean over microbatches (Accelerate divides by accumulation steps).
        torch._foreach_div_(g_x_acc, A)
        torch._foreach_div_(g_a_acc, A)

        # Extrema keep their semantics across microbatches; means/stds average.
        metrics = {}
        for k, vs in per_mb.items():
            v = torch.stack(vs)
            metrics[k] = v.max() if k.endswith("/max") else v.min() if k.endswith("/min") else v.mean()

        norm_x = global_norm(g_x_acc)
        norm_a = global_norm(g_a_acc)
        scaling = cfg.scaling_norm / norm_a
        if cfg.guard_inf_scaling:
            scaling = torch.where(torch.isfinite(scaling), scaling, torch.zeros_like(scaling))
        # Exact combine-then-norm (the closed form ‖x‖² − 2s⟨x,a⟩ + s²‖a‖²
        # loses precision to cancellation when the surgery nearly zeroes the
        # gradient). The combine is written into the g_x buffers.
        torch._foreach_mul_(g_a_acc, scaling)
        torch._foreach_sub_(g_x_acc, g_a_acc)
        combined = g_x_acc
        del g_a_acc
        pre_clip_norm = global_norm(combined)
        clip_scale = torch.clamp(cfg.max_grad_norm / (pre_clip_norm + 1e-6), max=1.0)
        torch._foreach_mul_(combined, clip_scale)
        metrics["gradient/norm_loss_x"] = norm_x
        metrics["gradient/norm_loss_a"] = norm_a
        metrics["gradient/scaling_factor"] = scaling
        metrics["gradient/pre_clip_norm"] = pre_clip_norm

        _apply_update(state, params, combined, cfg.ema_inv_gamma, cfg.ema_power,
                      cfg.ema_max_decay)
        return state, metrics

    return step


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
