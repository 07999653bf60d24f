"""The fsdp cases of tests/test_torch_fsdp.py, run the same way by the test
process (one process, no group: the reference) and by each rank of
tests/torch_fsdp_worker.py (gloo groups on the CPU, ``data × fsdp``).

Every case takes the global batch and the global draws from the inputs file
the test writes; ``run_case`` gives the step its rank's block of the batch.
The UNet is the tiny celeb-like one at 128 channels on both levels, with
one resnet a block and no attention (which keeps the JAX step's compile
short): 28 of its 112 parameters (95% of its 4.3M elements) reach the 2^16
elements that ``fsdp_dim`` splits, among them kernels that Adafactor
factors with the split dimension as the larger factored one (the time
embedding's first matrix) and as the smaller (the rest). The ``cond_*``
cases run the tiny conditional UNet at 16² latents with the flash path (the
kernels' plain versions on the CPU), split at ``min_size`` 1024 (its
attention, GEGLU and resnet matrices): as it is, with bf16
``param_cast_dtype`` and ``remat_policy=dots``, and with bf16
``grad_accum_dtype`` (each JAX step takes ~25 s to compile on the CPU; two
bf16 knobs in one case round twice, beyond the bf16 rule's two ulps).
Imports torch only, as the workers do not load JAX.
"""

import numpy as np
import torch

from torch_parity import CELEB_LIKE
from siss_tpu_torch.diffusion import NoiseSchedule
from siss_tpu_torch.evaluate import Evaluator
from siss_tpu_torch.models import UNet2D, UNet2DCondition, UNet2DConditionConfig, UNet2DConfig
from siss_tpu_torch.parallel import rank_rows, shard_module
from siss_tpu_torch.train import (DeletionStepConfig, TrainState, build_deletion_train_step,
                                  build_optimizer, build_pretrain_step, cond_unet_eps_apply,
                                  unet_eps_apply)
from siss_tpu_torch.utils.checkpoint import to_host

A, MB, HW = 2, 4, 8     # accumulation steps, GLOBAL microbatch, image side
FSDP_UNET = dict(CELEB_LIKE, block_out_channels=(128, 128), layers_per_block=1,
                 down_block_types=("DownBlock2D",) * 2, up_block_types=("UpBlock2D",) * 2)
LR = 1e-4
SGD = {"_target_": "sgd", "lr": 1.0}
ADAMW = {"_target_": "torch.optim.AdamW", "lr": LR, "betas": [0.95, 0.999], "weight_decay": 1e-6}
ADAFACTOR = {"_target_": "adafactor", "lr": 1e-3, "momentum": 0.9, "weight_decay": 1e-2,
             "multiply_by_parameter_scale": True}
SISS = "importance_sampling_with_mixture"
BASE_KW = dict(loss_params=(("lambd", 0.5), ("superfactor", 0.8)), scaling_norm=5.0,
               grad_accum_steps=A)

# name -> (optimizer, steps, step config)
CASES = {
    "siss_adamw_ema": (ADAMW, 2, dict(BASE_KW, loss_fn=SISS, use_ema=True)),
    "siss_unfused": (SGD, 1, dict(BASE_KW, loss_fn=SISS, fused_siss=False)),
    "erasediff": (SGD, 1, dict(BASE_KW, loss_fn="erasediff")),
    "simple_neg_del": (SGD, 1, dict(BASE_KW, loss_fn="simple_neg_del")),
    "batched_dual": (SGD, 1, dict(BASE_KW, loss_fn=SISS, batched_dual_backward=True)),
    "adafactor": (ADAFACTOR, 2, dict(BASE_KW, loss_fn=SISS, use_ema=True)),
    "cond_flash": (SGD, 1, dict(BASE_KW, loss_fn=SISS)),
    "cond_param_cast_dots": (SGD, 1, dict(BASE_KW, loss_fn=SISS, param_cast_dtype="bfloat16")),
    "cond_bf16_accum": (SGD, 1, dict(BASE_KW, loss_fn=SISS, grad_accum_dtype="bfloat16")),
}
#: The conditional UNet's cases: their bf16 knobs, their model's config.
COND_HW, COND_C, CTX = 16, 4, (7, 32)
COND = dict(UNet2DConditionConfig.tiny().__dict__, sample_size=COND_HW, attention_impl="flash")
COND_MIN_SIZE = 1024
BF16_CASES = ("cond_param_cast_dots", "cond_bf16_accum")
#: The cases whose checkpoints go from fsdp ranks to one process and back.
CHECKPOINT_CASES = ("siss_adamw_ema", "adafactor")
EVAL_CASES = ("sample_ddpm", "denoise_ddpm")


def is_cond(name: str) -> bool:
    return name.startswith("cond")


def weights_of(name: str, inputs: dict) -> dict:
    """The whole weights a case's model starts from."""
    return inputs["cond" if is_cond(name) else "unet"]


def build_state(name: str, unet_state: dict, mesh=None) -> TrainState:
    """A case's state on ``mesh`` (None: one process), from whole weights."""
    opt_cfg, _, kw = CASES[name]
    if is_cond(name):
        remat = (dict(gradient_checkpointing=True, remat_policy="dots")
                 if name == "cond_param_cast_dots" else {})
        model = UNet2DCondition(UNet2DConditionConfig(**dict(COND, **remat)))
    else:
        model = UNet2D(UNet2DConfig(**FSDP_UNET))
    model.load_state_dict(unet_state)
    sharding = shard_module(model, mesh, **({"min_size": COND_MIN_SIZE} if is_cond(name) else {}))
    opt, sched = build_optimizer(opt_cfg, model.parameters(), sharding=sharding)
    return TrainState.create(model, opt, sched, use_ema=kw.get("use_ema", False),
                             sharding=sharding)


def case_step(name: str):
    return build_deletion_train_step(cond_unet_eps_apply if is_cond(name) else unet_eps_apply,
                                     NoiseSchedule.create(1000, device="cpu"),
                                     DeletionStepConfig(**CASES[name][2]))


def held(state: TrainState, accumulators) -> dict:
    """Elements this rank holds of each parameter: the parameter, the EMA,
    each optimizer state tensor and each of the step's accumulators."""
    sh = state.sharding
    opt = [{k: v.numel() for k, v in state.optimizer.state[p].items()
            if isinstance(v, torch.Tensor) and v.ndim > 0} for p in sh.params]
    return {"param": [p.numel() for p in sh.params],
            "ema": None if state.ema is None else [e.numel() for e in state.ema.params],
            "optimizer": opt, "accumulators": accumulators, "bytes": state.held_bytes()}


def blocks(state: TrainState) -> dict:
    """This rank's own tensors: parameter and EMA blocks, optimizer state."""
    sh = state.sharding
    return {"params": [p.detach().clone() for p in sh.params],
            "ema": None if state.ema is None else [e.clone() for e in state.ema.params],
            "optimizer": [{k: v.clone() if isinstance(v, torch.Tensor) else v
                           for k, v in state.optimizer.state[p].items()} for p in sh.params]}


def run_case(name: str, inputs: dict, mesh=None, start=0, stop=None, state_dict=None) -> dict:
    """Steps ``start``..``stop`` of a case on this rank (from ``state_dict``
    when given): the whole state after them, the metrics of each step, the
    elements held and this rank's blocks."""
    state = build_state(name, weights_of(name, inputs), mesh)
    if state_dict is not None:
        state.load_state_dict(to_host(state_dict))  # loading aliases the optimizer's step
    loaded = blocks(state)
    step = case_step(name)
    accumulators = []
    zeros = state.sharding.zeros

    def recording_zeros(dtype):
        out = zeros(dtype)
        accumulators.append([t.numel() for t in out])
        return out

    state.sharding.zeros = recording_zeros
    batch = {k: rank_rows(v, 1) for k, v in inputs[name]["batch"].items()}
    metrics = []
    for draws in inputs[name]["draws"][start:stop or CASES[name][1]]:
        state, m = step(state, batch, draws=draws)
        metrics.append({k: float(v) for k, v in m.items()})
    return {"state": to_host(state.state_dict()), "metrics": metrics,
            "held": held(state, accumulators),
            "loaded": loaded, "blocks": blocks(state)}


def run_pretrain(inputs: dict, mesh=None) -> dict:
    model = UNet2D(UNet2DConfig(**FSDP_UNET))
    model.load_state_dict(inputs["unet"])
    sharding = shard_module(model, mesh)
    opt, sched = build_optimizer(SGD, model.parameters(), sharding=sharding)
    state = TrainState.create(model, opt, sched, sharding=sharding)
    step = build_pretrain_step(unet_eps_apply, NoiseSchedule.create(1000, device="cpu"))
    p = inputs["pretrain"]
    _, m = step(state, rank_rows(p["batch"]), draws=p["draws"])
    return {"params": state.state_dict()["model"], "metrics": {k: float(v) for k, v in m.items()}}


def run_evaluator(name: str, inputs: dict, mesh=None) -> np.ndarray:
    """Samples or a denoising injection of MB images by the UNet, whole on
    every rank (gathered into a full copy when split)."""
    model = UNet2D(UNet2DConfig(**FSDP_UNET))
    model.load_state_dict(inputs["unet"])
    sharding = shard_module(model, mesh)
    whole = sharding.load_full(sharding.full_copy())
    ev = Evaluator(unet_eps_apply, NoiseSchedule.create(1000, device="cpu"), (HW, HW, 3),
                   num_inference_steps=5, random_seed=3)
    if name.startswith("sample"):
        return ev.sample_images(whole, MB, set_generator=True)
    return ev.denoise_images(whole, inputs["noisy"], 20)


def make_inputs(unet_state: dict, draws: dict, cond_state: dict) -> dict:
    """The inputs file's content: the UNets' whole weights, each case's
    global batch (numpy seeds) and ``draws[name]``, the pretrain batch and
    ``draws["pretrain"]``, the noisy injection batch."""
    rng = np.random.default_rng(11)
    inputs = {"unet": unet_state, "cond": cond_state}
    for name in CASES:
        shape = (COND_HW, COND_HW, COND_C) if is_cond(name) else (HW, HW, 3)
        batch = {k: torch.from_numpy(rng.normal(size=(A, MB) + shape).astype(np.float32))
                 for k in ("all", "deletion")}
        if is_cond(name):
            batch["conditioning"] = torch.from_numpy(rng.normal(size=(A, MB) + CTX)
                                                     .astype(np.float32))
        inputs[name] = {"batch": batch, "draws": draws[name]}
    inputs["pretrain"] = {
        "batch": torch.from_numpy(rng.uniform(-1, 1, size=(MB, HW, HW, 3)).astype(np.float32)),
        "draws": draws["pretrain"]}
    inputs["noisy"] = torch.from_numpy(rng.normal(size=(MB, HW, HW, 3)).astype(np.float32))
    return inputs


# The collectives' and the surgery's own checks.

#: (shape, split dim, channels_last) of the gather and reduce-scatter checks.
COLLECTIVE_SHAPES = [((8, 3, 4, 6), 0, False), ((6, 8, 3, 2), 1, True), ((4, 6, 2, 8), 3, True),
                     ((10, 4), 1, False), ((12,), 0, False)]


def whole(shape, dtype=torch.float32, seed=0) -> torch.Tensor:
    """The same whole tensor on every rank."""
    g = torch.Generator().manual_seed(seed)
    return torch.randn(shape, generator=g).to(dtype)


class Leaves(torch.nn.Module):
    """A matrix that fsdp splits (at ``min_size`` 1024) and a whole bias (5
    elements: no fsdp axis divides it)."""

    def __init__(self):
        super().__init__()
        self.w = torch.nn.Parameter(torch.zeros(64, 32))
        self.b = torch.nn.Parameter(torch.zeros(5))


def surgery_trees():
    """(g_x, g_a) whole trees over Leaves: the whole bias carries ~99.9% of
    ‖g_a‖ and most of ⟨g_x, g_a⟩."""
    g_x = [whole((64, 32), seed=20) * 0.01, whole((5,), seed=21)]
    g_a = [whole((64, 32), seed=22) * 0.01, whole((5,), seed=23) * 30.0]
    return g_x, g_a
