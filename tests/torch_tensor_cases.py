"""The tensor cases of tests/test_torch_tensor.py, run the same way by the
test process (one process, no group: the reference) and by each rank of
tests/torch_tensor_worker.py (gloo groups on the CPU, ``data × tensor``).

Three UNets: a tiny ``UNet2D`` whose attention has four heads (``multi``),
the tiny celeb-like ``UNet2D`` whose attention is one head over all its
channels (``single``), both with one resnet a block (the JAX package's
tensor test's pixel UNet), and the tiny ``UNet2DCondition`` at 16² latents
with the flash path (the kernels' plain versions on the CPU; ``cond``),
once with ``remat_policy=dots`` and bf16 ``param_cast_dtype``
(``cond_dots``). Every resnet, attention
block and GEGLU feed-forward of each is split at tensor 2 and 4. The
single-head UNet runs every step case of tests/torch_fsdp_cases.py, the
multi-head one the fused SISS step with AdamW and EMA, the conditional one
that step, Adafactor and the bf16 parameter casts with ``dots``; each JAX
step takes 15–35 s to compile on the CPU, which bounds the list.
Every case takes the global batch and
the global draws from the inputs file the test writes; ``run_case`` gives
the step its rank's block of the batch (a tensor group's ranks share one).
Imports torch only, as the workers do not load JAX.
"""

import numpy as np
import torch

from torch_fsdp_cases import ADAFACTOR, ADAMW, BASE_KW, SGD, SISS, blocks, held
from torch_fsdp_cases import CASES as FSDP_CASES
from torch_parity import CELEB_LIKE, TINY_UNET
from siss_tpu_torch.diffusion import NoiseSchedule
from siss_tpu_torch.evaluate import Evaluator
from siss_tpu_torch.models import UNet2D, UNet2DCondition, UNet2DConditionConfig, UNet2DConfig
from siss_tpu_torch.models.layers import SpatialAttention
from siss_tpu_torch.models.unet2d import init_weights
from siss_tpu_torch.parallel import rank_rows, shard_module
from siss_tpu_torch.train import (DeletionStepConfig, TrainState, build_deletion_train_step,
                                  build_optimizer, build_pretrain_step, cond_unet_eps_apply,
                                  unet_eps_apply)
from siss_tpu_torch.utils.checkpoint import to_host

A, MB = 2, 4            # accumulation steps, GLOBAL microbatch
HW = 8                  # the UNet2Ds' images
COND_HW, COND_C, CTX = 16, 4, (7, 32)
MULTI = dict(TINY_UNET, in_channels=3, out_channels=3, attention_head_dim=8,  # 4 heads at 32
             layers_per_block=1)
SINGLE = dict(CELEB_LIKE, layers_per_block=1)
COND = dict(UNet2DConditionConfig.tiny().__dict__, sample_size=COND_HW, attention_impl="flash")
# kind -> (family of weights, model class, config)
MODELS = {"multi": ("multi", UNet2D, UNet2DConfig(**MULTI)),
          "single": ("single", UNet2D, UNet2DConfig(**SINGLE)),
          "cond": ("cond", UNet2DCondition, UNet2DConditionConfig(**COND)),
          "cond_dots": ("cond", UNet2DCondition,
                        UNet2DConditionConfig(**dict(COND, gradient_checkpointing=True,
                                                     remat_policy="dots")))}
FAMILIES = ("multi", "single", "cond")

# name -> (model kind, optimizer, steps, step config)
CASES = {f"single_{name}": ("single", *case) for name, case in FSDP_CASES.items()
         if not name.startswith("cond")}
CASES.update({
    "multi_siss_adamw_ema": ("multi", *FSDP_CASES["siss_adamw_ema"]),
    "cond_siss_adamw_ema": ("cond", ADAMW, 2, dict(BASE_KW, loss_fn=SISS, use_ema=True)),
    "cond_adafactor": ("cond", ADAFACTOR, 2, dict(BASE_KW, loss_fn=SISS, use_ema=True)),
    "cond_param_cast_dots": ("cond_dots", SGD, 1, dict(BASE_KW, loss_fn=SISS,
                                                       param_cast_dtype="bfloat16")),
})
#: The cases held to the bf16 rule (tests/test_torch_fsdp.py).
BF16_CASES = ("cond_param_cast_dots",)
#: The cases whose checkpoints go from tensor ranks to one process and back.
CHECKPOINT_CASES = ("multi_siss_adamw_ema", "single_adafactor", "cond_adafactor")
PRETRAIN_KINDS = ("single",)
EVAL_CASES = ("sample_ddpm", "denoise_ddpm")
#: The worlds: name -> (data, tensor, the model kinds its ranks run).
WORLDS = {"t2": (1, 2, tuple(MODELS)), "d2t2": (2, 2, tuple(MODELS)),
          "t4": (1, 4, ("multi", "single"))}


def shape_of(kind: str) -> tuple:
    """One image (or latent) of a model kind: [H, W, C]."""
    return (COND_HW, COND_HW, COND_C) if kind.startswith("cond") else (HW, HW, 3)


def build_model(kind: str, weights: dict) -> torch.nn.Module:
    family, cls, cfg = MODELS[kind]
    model = cls(cfg)
    model.load_state_dict(weights[family])
    return model


def build_state(name: str, weights: dict, mesh=None) -> TrainState:
    """A case's state on ``mesh`` (None: one process), from whole weights."""
    kind, opt_cfg, _, kw = CASES[name]
    model = build_model(kind, weights)
    sharding = shard_module(model, mesh)
    opt, sched = build_optimizer(opt_cfg, model.parameters(), sharding=sharding)
    return TrainState.create(model, opt, sched, use_ema=kw.get("use_ema", False),
                             sharding=sharding)


def case_step(name: str):
    kind, _, _, kw = CASES[name]
    eps_apply = cond_unet_eps_apply if kind.startswith("cond") else unet_eps_apply
    return build_deletion_train_step(eps_apply, NoiseSchedule.create(1000, device="cpu"),
                                     DeletionStepConfig(**kw))


def layout(state: TrainState) -> dict:
    """Each parameter's split dimension (None: whole), the axes that split
    it ("fsdp", "tensor" or "fsdp+tensor"; None), its chunks, and whether it
    is a whole leaf used in slices."""
    sh = state.sharding
    return {"dims": [lay.tensor if lay.tensor is not None else lay.fsdp for lay in sh.layouts],
            "chunks": [lay.chunks for lay in sh.layouts], "partial": list(sh.partial),
            "axes": ["+".join(lay.axes) or None for lay in sh.layouts]}


def run_case(name: str, inputs: dict, mesh=None, start=0, stop=None, state_dict=None) -> dict:
    """Steps ``start``..``stop`` of a case on this rank (from ``state_dict``
    when given): the whole state after them, the metrics of each step, the
    elements held, the layout, and this rank's blocks before and after."""
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
            "held": held(state, accumulators), "layout": layout(state),
            "loaded": loaded, "blocks": blocks(state)}


def run_pretrain(kind: str, inputs: dict, mesh=None) -> dict:
    model = build_model(kind, inputs["weights"])
    sharding = shard_module(model, mesh)
    opt, sched = build_optimizer(SGD, model.parameters(), sharding=sharding)
    state = TrainState.create(model, opt, sched, sharding=sharding)
    step = build_pretrain_step(unet_eps_apply, NoiseSchedule.create(1000, device="cpu"))
    p = inputs["pretrain"]
    _, m = step(state, rank_rows(p["batch"], mesh=mesh), draws=p["draws"])
    return {"params": state.state_dict()["model"], "metrics": {k: float(v) for k, v in m.items()}}


def run_evaluator(name: str, inputs: dict, mesh=None) -> np.ndarray:
    """Samples or a denoising injection of MB images by the single-head
    UNet, whole on every rank (gathered into a full copy when split), the
    batch split over the batch ranks."""
    model = build_model("single", inputs["weights"])
    sharding = shard_module(model, mesh)
    whole = sharding.load_full(sharding.full_copy())
    ev = Evaluator(unet_eps_apply, NoiseSchedule.create(1000, device="cpu"), (HW, HW, 3),
                   num_inference_steps=5, random_seed=3, mesh=mesh)
    if name.startswith("sample"):
        return ev.sample_images(whole, MB, set_generator=True)
    return ev.denoise_images(whole, inputs["noisy"], 20)


def split_attention(mesh=None) -> dict:
    """A one-head ``SpatialAttention`` over 32 channels split along its
    dimension over ``mesh``'s tensor ranks (None: whole): its output and
    the gradients of a weighted sum of it, of its input and of its whole
    parameters."""
    g = torch.Generator().manual_seed(8)
    att = init_weights(SpatialAttention(32, 1, groups=8), g)
    with torch.no_grad():
        for p in att.parameters():
            p.add_(0.1 * torch.randn(p.shape, generator=g))
    x = torch.randn(2, 32, 4, 4, generator=g).requires_grad_()
    w = torch.randn(2, 32, 4, 4, generator=g)
    sharding = shard_module(att, mesh)
    y = att(x)
    grads = torch.autograd.grad((y * w).sum(), [x] + sharding.params)
    acc = sharding.zeros(None)
    sharding.scatter_add_(list(grads[1:]), acc)
    whole = sharding.gather(acc)
    return {"y": y.detach(), "dx": grads[0],
            "params": dict(zip(sharding.names, (t.detach().clone() for t in whole)))}


def make_inputs(weights: dict, draws: dict) -> dict:
    """The inputs file's content: each family's whole weights, each case's
    global batch (numpy seeds) and ``draws[name]``, the pretrain batch and
    ``draws["pretrain"]``, the noisy injection batch."""
    rng = np.random.default_rng(12)
    inputs = {"weights": weights}
    for name, (kind, _, _, _) in CASES.items():
        batch = {k: torch.from_numpy(rng.normal(size=(A, MB) + shape_of(kind))
                                     .astype(np.float32)) for k in ("all", "deletion")}
        if kind.startswith("cond"):
            batch["conditioning"] = torch.from_numpy(rng.normal(size=(A, MB) + CTX)
                                                     .astype(np.float32))
        inputs[name] = {"batch": batch, "draws": draws[name]}
    inputs["pretrain"] = {
        "batch": torch.from_numpy(rng.uniform(-1, 1, size=(MB, HW, HW, 3)).astype(np.float32)),
        "draws": draws["pretrain"]}
    inputs["noisy"] = torch.from_numpy(rng.normal(size=(MB, HW, HW, 3)).astype(np.float32))
    return inputs
