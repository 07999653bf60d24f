"""The cases of tests/test_torch_tensor_fsdp.py, run the same way by the test
process (one process, no group: the reference) and by each rank of
tests/torch_tensor_fsdp_worker.py (gloo groups on the CPU, ``data × fsdp ×
tensor``).

Three UNets, split at ``min_size`` 1024 so that the tiny ones have leaves
split over both axes: the tiny ``UNet2D`` whose attention has four heads
(``multi``) and the celeb-like one whose attention is one head over all its
channels (``single``) of tests/torch_tensor_cases.py, and the tiny
``UNet2DCondition`` at 16² latents with the flash path (the kernels' plain
versions on the CPU) widened to 128 channels on its second level
(``cond``), so that its mid block's projections, GEGLU and resnet kernels
have both factored dimensions of Adafactor split, one over each axis.
The single-head UNet runs the fused SISS step with AdamW and EMA, EraseDiff
(the surgery's dot product) and the pretrain step, the multi-head one the
fused SISS step, the conditional one Adafactor with EMA and bf16
``grad_accum_dtype``; each JAX step takes 15–35 s to compile on the CPU,
which bounds the list. Every case takes the global batch and the global
draws from the inputs file the test writes; ``run_case`` gives the step its
rank's block of the batch (a tensor group's ranks share one). Imports torch
only, as the workers do not load JAX.
"""

import numpy as np
import torch

from torch_fsdp_cases import ADAFACTOR, ADAMW, BASE_KW, SGD, SISS, blocks, held
from torch_tensor_cases import A, COND_C, COND_HW, CTX, HW, MB, MULTI, SINGLE
from siss_tpu_torch.diffusion import NoiseSchedule
from siss_tpu_torch.evaluate import Evaluator
from siss_tpu_torch.models import UNet2D, UNet2DCondition, UNet2DConditionConfig, UNet2DConfig
from siss_tpu_torch.parallel import Layout, rank_rows, shard_module
from siss_tpu_torch.parallel.tensor import take_chunked
from siss_tpu_torch.train import (DeletionStepConfig, TrainState, build_deletion_train_step,
                                  build_optimizer, build_pretrain_step, cond_unet_eps_apply,
                                  unet_eps_apply)
from siss_tpu_torch.train.optim import state_layout
from siss_tpu_torch.utils.checkpoint import to_host

MIN_SIZE = 1024
COND = dict(UNet2DConditionConfig.tiny().__dict__, sample_size=COND_HW, attention_impl="flash",
            block_out_channels=(32, 128))
# kind -> (model class, config)
MODELS = {"multi": (UNet2D, UNet2DConfig(**MULTI)), "single": (UNet2D, UNet2DConfig(**SINGLE)),
          "cond": (UNet2DCondition, UNet2DConditionConfig(**COND))}

# name -> (model kind, optimizer, steps, step config)
CASES = {
    "single_siss_adamw_ema": ("single", ADAMW, 2, dict(BASE_KW, loss_fn=SISS, use_ema=True)),
    "single_erasediff": ("single", SGD, 1, dict(BASE_KW, loss_fn="erasediff")),
    "multi_siss_adamw_ema": ("multi", ADAMW, 2, dict(BASE_KW, loss_fn=SISS, use_ema=True)),
    "cond_adafactor": ("cond", ADAFACTOR, 2, dict(BASE_KW, loss_fn=SISS, use_ema=True)),
    "cond_bf16_accum": ("cond", SGD, 1, dict(BASE_KW, loss_fn=SISS,
                                             grad_accum_dtype="bfloat16")),
}
#: The cases held to the bf16 rule (tests/test_torch_fsdp.py).
BF16_CASES = ("cond_bf16_accum",)
#: The cases whose checkpoints go from the mesh to one process and back.
CHECKPOINT_CASES = ("multi_siss_adamw_ema", "cond_adafactor")
PRETRAIN_KINDS = ("single",)
EVAL_CASES = ("sample_ddpm", "denoise_ddpm")
#: The worlds: name -> (data, fsdp, tensor).
WORLDS = {"f2t2": (1, 2, 2), "d2f2t2": (2, 2, 2)}


def shape_of(kind: str) -> tuple:
    """One image (or latent) of a model kind: [H, W, C]."""
    return (COND_HW, COND_HW, COND_C) if kind == "cond" else (HW, HW, 3)


def build_model(kind: str, weights: dict) -> torch.nn.Module:
    cls, cfg = MODELS[kind]
    model = cls(cfg)
    model.load_state_dict(weights[kind])
    return model


def build_state(name: str, weights: dict, mesh=None) -> TrainState:
    """A case's state on ``mesh`` (None: one process), from whole weights."""
    kind, opt_cfg, _, kw = CASES[name]
    model = build_model(kind, weights)
    sharding = shard_module(model, mesh, min_size=MIN_SIZE)
    opt, sched = build_optimizer(opt_cfg, model.parameters(), sharding=sharding)
    return TrainState.create(model, opt, sched, use_ema=kw.get("use_ema", False),
                             sharding=sharding)


def case_step(name: str):
    kind, _, _, kw = CASES[name]
    eps_apply = cond_unet_eps_apply if kind == "cond" else unet_eps_apply
    return build_deletion_train_step(eps_apply, NoiseSchedule.create(1000, device="cpu"),
                                     DeletionStepConfig(**kw))


def block_of(t: torch.Tensor, layout, coords, sizes) -> torch.Tensor:
    """The block of a whole ``t`` that the rank at (fsdp, tensor)
    coordinates ``coords`` of a mesh of ``sizes`` holds under ``layout``
    ((tensor dim, fsdp dim, chunks)): its tensor block, then that block's
    fsdp block."""
    tdim, fdim, chunks = layout
    (f, tr), (nf, nt) = coords, sizes
    if tdim is not None:
        t = take_chunked(t, tdim, nt, tr, chunks)
    if fdim is not None:
        t = take_chunked(t, fdim, nf, f)
    return t


def state_share(key: str, layout, shape, sizes) -> int:
    """The ranks over which optimizer state ``key`` of a parameter of whole
    ``shape`` laid out as ``layout`` ((tensor dim, fsdp dim, chunks)) is
    split, on a mesh of (fsdp, tensor) ``sizes``."""
    lay = state_layout(key, torch.empty(shape, device="meta"), Layout(*layout), shape)
    nf, nt = sizes
    return (nf if lay.fsdp is not None else 1) * (nt if lay.tensor is not None else 1)


def run_case(name: str, inputs: dict, mesh=None, start=0, stop=None, state_dict=None) -> dict:
    """Steps ``start``..``stop`` of a case on this rank (from ``state_dict``
    when given): the whole state after them, the metrics of each step, the
    elements held, the layouts, and this rank's blocks before and after."""
    state = build_state(name, inputs["weights"], mesh)
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
    batch = {k: rank_rows(v, 1, mesh) for k, v in inputs[name]["batch"].items()}
    metrics = []
    for draws in inputs[name]["draws"][start:stop or CASES[name][2]]:
        state, m = step(state, batch, draws=draws)
        metrics.append({k: float(v) for k, v in m.items()})
    return {"state": to_host(state.state_dict()), "metrics": metrics,
            "held": held(state, accumulators),
            "layouts": [tuple(lay) for lay in state.sharding.layouts],
            "loaded": loaded, "blocks": blocks(state)}


def run_pretrain(kind: str, inputs: dict, mesh=None) -> dict:
    model = build_model(kind, inputs["weights"])
    sharding = shard_module(model, mesh, min_size=MIN_SIZE)
    opt, sched = build_optimizer(SGD, model.parameters(), sharding=sharding)
    state = TrainState.create(model, opt, sched, sharding=sharding)
    step = build_pretrain_step(unet_eps_apply, NoiseSchedule.create(1000, device="cpu"))
    p = inputs["pretrain"]
    _, m = step(state, rank_rows(p["batch"], mesh=mesh), draws=p["draws"])
    return {"params": state.state_dict()["model"], "metrics": {k: float(v) for k, v in m.items()}}


def run_evaluator(name: str, inputs: dict, mesh=None) -> np.ndarray:
    """Samples or a denoising injection of MB images by the multi-head
    UNet, whole on every rank (gathered over both axes into a full copy),
    the batch split over the batch ranks."""
    model = build_model("multi", inputs["weights"])
    sharding = shard_module(model, mesh, min_size=MIN_SIZE)
    whole = sharding.load_full(sharding.full_copy())
    ev = Evaluator(unet_eps_apply, NoiseSchedule.create(1000, device="cpu"), (HW, HW, 3),
                   num_inference_steps=5, random_seed=3, mesh=mesh)
    if name.startswith("sample"):
        return ev.sample_images(whole, MB, set_generator=True)
    return ev.denoise_images(whole, inputs["noisy"], 20)


def make_inputs(weights: dict, draws: dict) -> dict:
    """The inputs file's content: each model's whole weights, each case's
    global batch (numpy seeds) and ``draws[name]``, the pretrain batch and
    ``draws["pretrain"]``, the noisy injection batch."""
    rng = np.random.default_rng(13)
    inputs = {"weights": weights}
    for name, (kind, _, _, _) in CASES.items():
        batch = {k: torch.from_numpy(rng.normal(size=(A, MB) + shape_of(kind))
                                     .astype(np.float32)) for k in ("all", "deletion")}
        if kind == "cond":
            batch["conditioning"] = torch.from_numpy(rng.normal(size=(A, MB) + CTX)
                                                     .astype(np.float32))
        inputs[name] = {"batch": batch, "draws": draws[name]}
    inputs["pretrain"] = {
        "batch": torch.from_numpy(rng.uniform(-1, 1, size=(MB, HW, HW, 3)).astype(np.float32)),
        "draws": draws["pretrain"]}
    inputs["noisy"] = torch.from_numpy(rng.normal(size=(MB, HW, HW, 3)).astype(np.float32))
    return inputs
