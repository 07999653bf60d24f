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

The two gradients accumulate over the microbatches in ``grad_accum_dtype``
(each microbatch's gradient cast on add) and are averaged; then the surgery
g = clip(g_x − s·g_a, max_grad_norm) with s = scaling_norm/‖g_a‖, or
EraseDiff's projection s = −max(η − ⟨g_x, g_a⟩/‖g_a‖², 0), formed in fp32;
then the optimizer and EMA updates. ``fused_surgery`` picks between the JAX
step's two forms of the surgery, which differ only in how EraseDiff's ‖g_a‖²
is formed (a sum of squares, or the square of the norm); the combine and
the clip are one sequence here.

The SD options, as in the JAX step: ``noise_offset`` adds a per-sample,
per-channel draw to the noise, ``input_perturbation`` perturbs the noise
that forms x_t only (the loss keeps the unperturbed noise); either sends
SISS down the unfused path. ``param_cast_dtype`` casts the fp32 params once
a step and pulls the gradients with respect to the cast copies.
``batched_dual_backward`` takes the two pulls of a shared forward as one
backward over the stacked seeds (1, 0) and (0, 1)
(``autograd.grad(..., is_grads_batched=True)``; ``ops.batched``).

Dynamic loss scalars (``superfactor``, or λ off the fused path) are plain
numbers or 0-d tensors, or [A] tensors that give each microbatch its own
value. Normalisation matches the reference: each microbatch loss is
``sum()/microbatch``, gradients are averaged over accumulation steps.

Data parallelism (``siss_tpu_torch.parallel``; the JAX package's ``data``
axis, docs/DESIGN.md §1): under a process group of R ranks each rank's
batch is its block of the global batch (``rank_rows``), every rank draws
the global batch's randomness from its generator and keeps its rows, the
microbatch divisor is the global microbatch, and the accumulated g_x and
g_a are all-reduced (SUM) once each before the norms, the surgery and the
clip: the reference's surgery after the DDP all-reduce. With accumulators
below fp32 (``grad_accum_dtype``) each microbatch's two trees are summed
over the data ranks in their own dtype before they are rounded into the
accumulators, as JAX rounds the whole batch's gradient. The step's
statistics are computed from every rank's per-sample values, so they are
the one-process statistics of the global batch. The model is not wrapped in
``DistributedDataParallel``: its reducer fires on ``.grad`` accumulation and
expects one backward a forward, while the step pulls with
``autograd.grad`` twice. The surgery, the optimizer and the EMA then run on
the same values on every rank, and the ranks' parameters stay equal.

The ``fsdp`` axis (``parallel.fsdp``; the JAX package's ``shard_params_fsdp``
placement, whose collectives XLA inserts): the state's ``sharding`` splits
the large parameters, their optimizer state, the EMA and the two gradient
accumulators over the ``fsdp`` ranks. The step gathers the whole parameters
once, before the first microbatch, and keeps them through every pull;
reduce-scatters each microbatch's two pulled trees into the block-sized
accumulators and sums those over ``data`` after the last microbatch; and
forms ‖g_x‖², ‖g_a‖², ⟨g_x, g_a⟩ and the clip's norm from partial sums over
the blocks, each whole leaf counted once (``Sharding.sum_leaves``). The
combine, the clip, the optimizer and the EMA run on the blocks.

The ``tensor`` axis (``parallel.tensor``; the JAX package's ``_tp_spec``
placement): the model is this rank's local model, which computes on its
blocks of the Megatron-role parameters (never gathered over ``tensor``)
and all-reduces each block's partial output in its forward. The ranks of a
tensor group take the same rows of the batch (``rank_rows`` by the mesh's
batch coordinate). Their pulled gradients are their blocks' own, and the
whole leaves' are the whole gradients, equal on every tensor rank, but for
the whole biases a split layer uses only in its slice, which
``scatter_add_`` sums over the tensor ranks; the norms and the clip sum the
blocks' parts over the tensor ranks and count each whole leaf once.

Both axes (``data × fsdp × tensor``, JAX's ``_param_spec``): a Megatron
block that ``fsdp`` splits once more is gathered over ``fsdp`` alone, to
the tensor block the local model computes on; its gradient is
reduce-scattered over ``fsdp`` and stays split over ``tensor``; and its
parts of the norms are summed over the ``fsdp × tensor`` plane.
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
from siss_tpu_torch.ops.batched import contiguous_norm_inputs
from siss_tpu_torch.ops.siss import siss_weighted_sums
from siss_tpu_torch.parallel import all_reduce_mean, gather_rows, rank_rows
from siss_tpu_torch.parallel.fsdp import Sharding
from siss_tpu_torch.train.ema import ema_update
from siss_tpu_torch.train.state import TrainState
from siss_tpu_torch.utils.spans import span

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


def _squared_norms(tensors: Sequence[torch.Tensor]) -> torch.Tensor:
    """[L] each tensor's squared L2 norm, in float32."""
    return torch.stack(torch._foreach_norm(list(tensors), 2, dtype=torch.float32)) ** 2


def global_norm(tensors: Sequence[torch.Tensor], sharding: Optional[Sharding] = None
                ) -> torch.Tensor:
    """Global L2 norm of a list of tensors, accumulated in float32; with a
    ``sharding``, of the whole tree of which ``tensors`` are this rank's
    leaves (collective)."""
    squares = _squared_norms(tensors)
    return (squares.sum() if sharding is None else sharding.sum_leaves(squares)).sqrt()


def clip_by_global_norm(tensors: Sequence[torch.Tensor], max_norm: float,
                        sharding: Optional[Sharding] = None):
    """torch.nn.utils.clip_grad_norm_ semantics; returns (clipped, norm)."""
    norm = global_norm(tensors, sharding)
    scale = torch.clamp(max_norm / (norm + 1e-6), max=1.0)
    return [t * scale.to(t.dtype) for t in tensors], norm


def _per_sample(x: torch.Tensor) -> torch.Tensor:
    """[mb] per-sample means of a [mb, ...] tensor (a [mb] one as it is), fp32."""
    x = x.detach().float()
    return x.mean(dim=tuple(range(1, x.ndim))) if x.ndim > 1 else x


def _tensor_stats(v: torch.Tensor, prefix: str) -> Dict[str, torch.Tensor]:
    """mean|max|min|std of [A, mb] per-sample values: each microbatch's
    mean and population std, averaged over the microbatches; the extrema
    over all of them."""
    return {
        f"{prefix}/mean": v.mean(dim=1).mean(),
        f"{prefix}/max": v.max(),
        f"{prefix}/min": v.min(),
        f"{prefix}/std": v.std(dim=1, correction=0).mean(),
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
        # The JAX step leaves the fused path when either SD noise option is on.
        return (self.loss_fn == "importance_sampling_with_mixture" and self.fused_siss
                and self.noise_offset == 0.0 and self.input_perturbation == 0.0)


def draw_microbatch_randomness(generator: torch.Generator, A: int, mb: int, shape,
                               t_min: int, t_max: int, device, uniform_target: bool = False,
                               noise_offset: bool = False,
                               input_perturbation: bool = False) -> Dict[str, torch.Tensor]:
    """The step's draws for A microbatches of [H, W, C] latents: noise ~
    N(0,1) [A, mb, H, W, C], t ~ U{t_min..t_max−1} [A, mb], u ~ U[0,1) [A, mb]
    (the mixtures' keep test); with ``uniform_target``, EraseDiff's forget
    target "uniform" ~ U[0,1) [A, mb, H, W, C]; with ``noise_offset``, the
    per-sample, per-channel "offset" ~ N(0,1) [A, mb, 1, 1, C]; with
    ``input_perturbation``, "perturb" ~ N(0,1) [A, mb, H, W, C]."""
    shape = tuple(shape)
    draws = {
        "noise": torch.randn((A, mb) + shape, generator=generator, device=device),
        "t": torch.randint(t_min, t_max, (A, mb), generator=generator, device=device),
        "u": torch.rand((A, mb), generator=generator, device=device),
    }
    if uniform_target:
        draws["uniform"] = torch.rand((A, mb) + shape, generator=generator, device=device)
    if noise_offset:
        offset_shape = (A, mb) + (1,) * (len(shape) - 1) + shape[-1:]
        draws["offset"] = torch.randn(offset_shape, generator=generator, device=device)
    if input_perturbation:
        draws["perturb"] = torch.randn((A, mb) + shape, generator=generator, device=device)
    return draws


class _Call(torch.nn.Module):
    """``_Call(model)(fn) = fn(model)``, so that ``torch.func.functional_call``
    keeps the model's parameters replaced through all of ``fn``: its
    backward pulls and the checkpoint recomputation inside them."""

    def __init__(self, model: torch.nn.Module):
        super().__init__()
        self.model = model

    def forward(self, fn):
        return fn(self.model)


def _working_params(model: torch.nn.Module, sharding: Sharding, dtype: Optional[torch.dtype]):
    """(the tensors the step pulls its gradients with respect to, a
    ``call(fn)`` that runs ``fn(model)`` with the model computing from
    them): the parameters themselves, or, when some are split over the
    ``fsdp`` ranks or ``dtype`` casts them, the parameters gathered over
    ``fsdp`` (in ``dtype``; collective). Blocks split over the ``tensor``
    ranks are never gathered over ``tensor``: the local model computes on
    them, and on the tensor block a leaf split over both axes is gathered
    back to. A model that computes in fp32 sees cast copies upcast again,
    as flax promotes them."""
    params = list(model.parameters())
    if dtype is None and not sharding.gathers:
        return params, lambda fn: fn(model)
    with span("train.gather"):
        gathered = sharding.gather(dtype=dtype, axes=("fsdp",))
        leaves = [p if t.dtype == p.dtype and lay.fsdp is None else t.requires_grad_()
                  for p, t, lay in zip(params, gathered, sharding.layouts)]
        compute = getattr(model, "dtype", torch.float32)
        swapped = {f"model.{name}": c if c.dtype == compute else c.to(p.dtype)
                   for name, p, c in zip(sharding.names, params, leaves)}
    wrapper = _Call(model)

    def call(fn):
        return torch.func.functional_call(wrapper, swapped, (fn,), strict=False)
    return leaves, call


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

    Under a process group ``batch`` is this rank's block of the global batch
    ([A, mb/R, ...]) and ``draws`` are the global batch's ([A, mb, ...]).
    """
    loss_method = getattr(DeletionLoss(gamma=schedule.gamma, sigma=schedule.sigma), cfg.loss_fn)
    # Keep only the params the chosen loss accepts, so one config sweeps
    # across loss_fns without editing loss_params.
    accepted = set(inspect.signature(loss_method).parameters)
    static_params = {k: v for k, v in dict(cfg.loss_params).items() if k in accepted}
    draw_name = LOSS_DRAWS.get(cfg.loss_fn)
    acc_dtype = getattr(torch, cfg.grad_accum_dtype)
    cast_dtype = getattr(torch, cfg.param_cast_dtype) if cfg.param_cast_dtype else None

    def noises(dr):
        """(the loss's noise, the noise that forms x_t) of one microbatch."""
        noise = dr["noise"]
        if cfg.noise_offset > 0.0:
            noise = noise + cfg.noise_offset * dr["offset"]
        if cfg.input_perturbation > 0.0:
            return noise, noise + cfg.input_perturbation * dr["perturb"]
        return noise, noise

    def two_pulls(loss_x, loss_a, params):
        """g_x and g_a from one forward: two pulls, or one batched pull."""
        if cfg.batched_dual_backward:
            with span("train.pulls"):
                # The cotangents of (loss_x, loss_a) for both pulls: (1, 0), (0, 1).
                seeds = (torch.tensor([1.0, 0.0], device=loss_x.device),
                         torch.tensor([0.0, 1.0], device=loss_x.device))
                g = torch.autograd.grad((loss_x, loss_a), params, seeds, is_grads_batched=True)
            return [t[0] for t in g], [t[1] for t in g]
        with span("train.pull_x"):
            g_x = torch.autograd.grad(loss_x, params, retain_graph=True)
        with span("train.pull_a"):
            return g_x, torch.autograd.grad(loss_a, params)

    def microbatch_terms(model, keep, forget, cond, dr, dyn):
        """The loss method's outputs and per-sample stats for one microbatch."""
        t = dr["t"]
        noise, input_noise = noises(dr)
        all_samples = {"og_latents": keep,
                       "noisy_latents": q_sample(schedule, keep, input_noise, t)}
        deletion_samples = {"og_latents": forget,
                            "noisy_latents": q_sample(schedule, forget, input_noise, t)}
        params = {**static_params, **{k: v for k, v in dyn.items() if k in accepted}}
        out = loss_method(lambda x, tt, c: eps_apply(model, x, tt, c), dr.get(draw_name), t,
                          noise, cond, all_samples, deletion_samples, **params)
        names = ("loss", "loss_x", "loss_a", "importance_weight_x", "importance_weight_a")
        return out, {name: _per_sample(getattr(out, name)) for name in names
                     if getattr(out, name) is not None}

    # micro_grads(params, model, keep, forget, cond, dr, dyn, mb) -> (g_x,
    # g_a or None, per-sample stats), ``mb`` the global microbatch.
    if cfg.is_scalar_path:

        def micro_grads(params, model, keep, forget, cond, dr, dyn, mb):
            with span("train.forward"):
                out, stats = microbatch_terms(model, keep, forget, cond, dr, dyn)
                loss = out.loss.sum() / mb
            with span("train.pull"):
                return torch.autograd.grad(loss, params), None, stats

    elif cfg.is_fused_siss:
        lambd = float(static_params["lambd"])

        def micro_grads(params, model, keep, forget, cond, dr, dyn, mb):
            if "lambd" in dyn:
                raise ValueError("dynamic lambd is not supported by the fused SISS path; "
                                 "set fused_siss=False to decay lambd at runtime")
            noise, t = dr["noise"], dr["t"]
            with span("train.forward"):
                mask = (dr["u"] > lambd).reshape((keep.shape[0],) + (1,) * (keep.ndim - 1))
                mix = torch.where(mask, q_sample(schedule, keep, noise, t),
                                  q_sample(schedule, forget, noise, t))
                preds = eps_apply(model, mix, t, cond)
            with span("train.siss"):
                wlx, wla, aux = siss_weighted_sums(preds, mix, keep, forget, schedule.gamma[t],
                                                   schedule.sigma[t], lambd)
                stats = {"loss_x": _per_sample(aux["lx_mean"]),
                         "loss_a": _per_sample(aux["la_mean"]),
                         "importance_weight_x": _per_sample(aux["iw_x"]),
                         "importance_weight_a": _per_sample(aux["iw_a"])}
                loss_x, loss_a = wlx / mb, wla / mb
            # ONE forward, TWO backward pulls over the shared graph.
            return (*two_pulls(loss_x, loss_a, params), stats)

    elif cfg.is_shared_forward:

        def micro_grads(params, model, keep, forget, cond, dr, dyn, mb):
            with span("train.forward"):
                out, stats = microbatch_terms(model, keep, forget, cond, dr, dyn)
                loss_x, loss_a = out.weighted_loss_x.sum() / mb, out.weighted_loss_a.sum() / mb
            return (*two_pulls(loss_x, loss_a, params), stats)

    else:  # double_forward_with_neg_del, erasediff

        def micro_grads(params, model, keep, forget, cond, dr, dyn, mb):
            # Each term through only its own UNet forward (2 forwards + 2
            # backwards; the loss method would run both forwards per term).
            t = dr["t"]
            with span("train.forward"):
                noise, input_noise = noises(dr)
                target_a = dr["uniform"] if cfg.loss_fn == "erasediff" else noise
                lx = (eps_apply(model, q_sample(schedule, keep, input_noise, t), t, cond)
                      - noise) ** 2
                stats = {"loss_x": _per_sample(lx)}
                loss = lx.sum() / mb
            with span("train.pull_x"):
                g_x = torch.autograd.grad(loss, params)
            with span("train.forward"):
                la = (eps_apply(model, q_sample(schedule, forget, input_noise, t), t, cond)
                      - target_a) ** 2
                stats["loss_a"] = _per_sample(la)
                loss = la.sum() / mb
            with span("train.pull_a"):
                g_a = torch.autograd.grad(loss, params)
            return g_x, g_a, stats

    @span("train.step")
    def step(state: TrainState, batch: Dict[str, Any], generator: Optional[torch.Generator] = None,
             dyn_scalars: Optional[Dict[str, Any]] = None,
             draws: Optional[Dict[str, torch.Tensor]] = None):
        dyn_scalars = dyn_scalars or {}
        keep_all, forget_all = batch["all"], batch["deletion"]
        cond_all = batch.get("conditioning")
        model, sharding = state.model, state.sharding
        mesh = sharding.mesh
        A, mb = keep_all.shape[:2]
        mb *= mesh.batch_ranks  # the global microbatch
        if draws is None:
            if generator is None:
                raise ValueError("pass a torch.Generator or explicit draws")
            draws = draw_microbatch_randomness(generator, A, mb, keep_all.shape[2:],
                                               cfg.t_min, cfg.t_max, keep_all.device,
                                               uniform_target=cfg.loss_fn == "erasediff",
                                               noise_offset=cfg.noise_offset > 0.0,
                                               input_perturbation=cfg.input_perturbation > 0.0)
        draws = {k: rank_rows(v, axis=1, mesh=mesh) for k, v in draws.items()}
        # [A] scalars vary per microbatch (the task decays superfactor once
        # per microbatch); other scalars hold for every microbatch.
        per_mb = {k for k, v in dyn_scalars.items()
                  if getattr(v, "ndim", 0) >= 1 and v.shape[0] == A}

        # The whole parameters (gathered once, a step) live through every pull.
        grad_of, call = _working_params(model, sharding, cast_dtype)
        with span("train.accumulate"):
            g_x_acc = sharding.zeros(acc_dtype)
            g_a_acc = None if cfg.is_scalar_path else sharding.zeros(acc_dtype)
        stats_mb: Dict[str, List[torch.Tensor]] = {}
        for a in range(A):
            cond = None if cond_all is None else cond_all[a]
            dyn = {k: v[a] if k in per_mb else v for k, v in dyn_scalars.items()}
            dr = {k: v[a] for k, v in draws.items()}
            with contiguous_norm_inputs(model, cfg.batched_dual_backward):
                g_x, g_a, stats = call(lambda m: micro_grads(grad_of, m, keep_all[a],
                                                             forget_all[a], cond, dr, dyn, mb))
            with span("train.accumulate"):
                sharding.scatter_add_(g_x, g_x_acc)
                if g_a is not None:
                    sharding.scatter_add_(g_a, g_a_acc)
            del g_x, g_a
            for k, v in stats.items():
                stats_mb.setdefault(k, []).append(v)
        del grad_of, call
        with span("train.accumulate"):
            # Sum over the data ranks, then the mean over microbatches
            # (Accelerate divides by accumulation steps).
            for acc in (g_x_acc, g_a_acc):
                if acc is not None:
                    sharding.finish_(acc)
                    torch._foreach_div_(acc, A)

        with span("train.stats"):
            # Every rank's per-sample values ([stat, A, mb]), in one all-reduce.
            names = list(stats_mb)
            per_sample = gather_rows(torch.stack([torch.stack(stats_mb[k]) for k in names]),
                                     axis=2, mesh=mesh)
            metrics = {}
            for k, v in zip(names, per_sample):
                metrics.update(_tensor_stats(v, k))

        with span("train.surgery"):
            if cfg.is_scalar_path:
                final, pre_clip_norm = clip_by_global_norm(g_x_acc, cfg.max_grad_norm, sharding)
            else:
                final, pre_clip_norm = _surgery(cfg, sharding, g_x_acc, g_a_acc, metrics)
        metrics["gradient/pre_clip_norm"] = pre_clip_norm
        _apply_update(state, final, cfg.ema_inv_gamma, cfg.ema_power, cfg.ema_max_decay)
        return state, metrics

    return step


def _surgery(cfg: DeletionStepConfig, sharding: Sharding, g_x: List[torch.Tensor],
             g_a: List[torch.Tensor], metrics: Dict[str, torch.Tensor]):
    """clip(g_x − s·g_a), in fp32: written into the g_x buffers when they
    are fp32, else into new fp32 ones, a leaf at a time (the JAX step
    combines bf16 accumulators in fp32 too); logs ‖g_x‖, ‖g_a‖ and s.
    ‖g_x‖², ‖g_a‖² (and EraseDiff's ⟨g_x, g_a⟩) are summed over the tree
    in one reduction, the clip's norm in a second. Returns (final gradient,
    its pre-clip norm)."""
    parts = [_squared_norms(g_x), _squared_norms(g_a)]
    if cfg.loss_fn == "erasediff":
        parts.append(torch.stack([torch.dot(x.float().reshape(-1), y.float().reshape(-1))
                                  for x, y in zip(g_x, g_a)]))
    sums = sharding.sum_leaves(torch.stack(parts))
    norm_x, norm_a = sums[0].sqrt(), sums[1].sqrt()
    if cfg.loss_fn == "erasediff":
        # EraseDiff's projected-gradient step.
        norm_a_sq = sums[1] if cfg.fused_surgery else norm_a ** 2
        scaling = -torch.clamp(cfg.eta - sums[2] / norm_a_sq, min=0.0)
    else:
        scaling = cfg.scaling_norm / norm_a
    if cfg.guard_inf_scaling:
        scaling = torch.where(torch.isfinite(scaling), scaling, torch.zeros_like(scaling))
    # Exact combine-then-norm (the closed form ‖x‖² − 2s⟨x,a⟩ + s²‖a‖²
    # loses precision to cancellation when the surgery nearly zeroes the
    # gradient).
    if g_x[0].dtype == torch.float32:
        torch._foreach_mul_(g_a, scaling)
        torch._foreach_sub_(g_x, g_a)
    else:
        for i in range(len(g_x)):
            g_x[i] = g_x[i].float() - scaling * g_a[i].float()
            g_a[i] = None
    pre_clip_norm = global_norm(g_x, sharding)
    torch._foreach_mul_(g_x, torch.clamp(cfg.max_grad_norm / (pre_clip_norm + 1e-6), max=1.0))
    metrics["gradient/norm_loss_x"] = norm_x
    metrics["gradient/norm_loss_a"] = norm_a
    metrics["gradient/scaling_factor"] = scaling
    return g_x, pre_clip_norm


def _apply_update(state: TrainState, grads: Sequence[torch.Tensor], ema_inv_gamma: float,
                  ema_power: float, ema_max_decay: float) -> None:
    """The optimizer update with ``schedule(state.step)`` as its LR, then
    the EMA update and the step count, all in place (on this rank's blocks
    under an ``fsdp`` axis)."""
    params = state.sharding.params
    with span("train.optimizer"):
        for p, g in zip(params, grads):
            p.grad = g.to(p.dtype)
        lr = state.lr_schedule(state.step)
        for group in state.optimizer.param_groups:
            group["lr"] = lr
        state.optimizer.step()
        state.optimizer.zero_grad(set_to_none=True)
    if state.ema is not None:
        with span("train.ema"):
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
    "gradient/pre_clip_norm".

    Under a process group of R ranks ``batch`` is this rank's block of the
    global batch and ``draws`` are the global batch's, of which it keeps its
    rows; each rank's mean loss counts 1/R and the gradients are summed over
    the ranks before the clip: all-reduced, or under an ``fsdp`` axis
    reduce-scattered into this rank's blocks and clipped by the partial-sum
    norm, as the unlearning step does."""
    if prediction_type not in ("epsilon", "sample"):
        raise ValueError(prediction_type)

    @span("train.step")
    def step(state: TrainState, batch: torch.Tensor, generator: Optional[torch.Generator] = None,
             draws: Optional[Dict[str, torch.Tensor]] = None):
        sharding = state.sharding
        mesh = sharding.mesh
        n_ranks = mesh.batch_ranks
        if draws is None:
            if generator is None:
                raise ValueError("pass a torch.Generator or explicit draws")
            B = batch.shape[0] * n_ranks
            draws = {"noise": torch.randn((B,) + tuple(batch.shape[1:]), generator=generator,
                                          dtype=batch.dtype, device=batch.device),
                     "t": torch.randint(0, schedule.num_train_timesteps, (B,),
                                        generator=generator, device=batch.device)}
        noise, t = rank_rows(draws["noise"], mesh=mesh), rank_rows(draws["t"], mesh=mesh)
        grad_of, call = _working_params(state.model, sharding, None)

        def loss_and_grads(model):
            with span("train.forward"):
                pred = eps_apply(model, q_sample(schedule, batch, noise, t), t, None)
                if prediction_type == "epsilon":
                    loss = ((pred - noise) ** 2).mean()
                else:
                    loss = (snr_weights(schedule, t, pred) * (pred - batch) ** 2).mean()
            with span("train.pull"):
                return loss, torch.autograd.grad(loss / n_ranks, grad_of)

        loss, grads = call(loss_and_grads)
        del grad_of, call
        with span("train.accumulate"):
            grads = sharding.reduce(grads)
        with span("train.surgery"):
            grads, grad_norm = clip_by_global_norm(grads, max_grad_norm, sharding)
        _apply_update(state, grads, ema_inv_gamma, ema_power, ema_max_decay)
        with span("train.stats"):
            loss = all_reduce_mean(loss)
        return state, {"loss": loss, "gradient/pre_clip_norm": grad_norm}

    return step
