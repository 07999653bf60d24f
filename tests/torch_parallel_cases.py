"""The data-parallel cases of tests/test_torch_parallel.py, run the same way
by the test process (one process, no group: the reference) and by each rank
of tests/torch_parallel_worker.py (a 2-rank gloo group on the CPU).

Every case takes the global batch and the global draws from the inputs file
the test writes. ``run_case`` gives the step its rank's block of the batch
(``rank_rows`` along the microbatch axis) and the global draws, of which the
step keeps its rows. Imports torch only, as the workers do not load JAX.
"""

import numpy as np
import torch

from torch_parity import CELEB_LIKE, TinyEps, tiny_apply, tiny_params
from siss_tpu_torch.diffusion import NoiseSchedule, sd_noise_schedule
from siss_tpu_torch.evaluate import Evaluator
from siss_tpu_torch.models import (UNet2D, UNet2DConditionConfig, UNet2DConfig,
                                   build_unet_cond)
from siss_tpu_torch.parallel import rank_rows
from siss_tpu_torch.train import (DeletionStepConfig, TrainState, build_deletion_train_step,
                                  build_optimizer, build_pretrain_step, cond_unet_eps_apply,
                                  unet_eps_apply)

A, MB = 2, 4            # accumulation steps, GLOBAL microbatch
HW = 8                  # the tiny celeb-like UNet's images
TINY_HW, TINY_C = 6, 2  # TinyEps images
SD_HW, SD_C, SD_LEN = 16, 4, 7
SD_MB = 2               # the SD step's global microbatch
LR = 1e-4
SGD = {"_target_": "sgd", "lr": 1.0}
ADAMW = {"_target_": "torch.optim.AdamW", "lr": LR, "betas": [0.95, 0.999], "weight_decay": 1e-6}
UNET_KW = dict(loss_fn="importance_sampling_with_mixture", loss_params=(("lambd", 0.5),),
               scaling_norm=5.0, grad_accum_steps=A, t_min=500, t_max=1000)
TINY_KW = dict(loss_params=(("lambd", 0.5), ("superfactor", 0.8)), scaling_norm=3.0,
               grad_accum_steps=A)
SD_KW = dict(loss_fn="importance_sampling_with_mixture", loss_params=(("lambd", 0.5),),
             scaling_norm=750.0, grad_accum_steps=A, t_min=999, t_max=1000)

# name -> (model, optimizer, steps, step config)
STEP_CASES = {
    "siss_unet_sgd": ("unet", SGD, 1, dict(UNET_KW)),
    "siss_unet_adamw_ema": ("unet", ADAMW, 2, dict(UNET_KW, use_ema=True)),
    "erasediff": ("tiny", SGD, 1, dict(TINY_KW, loss_fn="erasediff")),
    "simple_neg_del": ("tiny", SGD, 1, dict(TINY_KW, loss_fn="simple_neg_del")),
    "siss_unfused": ("tiny", SGD, 1, dict(TINY_KW, loss_fn="importance_sampling_with_mixture",
                                          fused_siss=False)),
    "sd_flash": ("sd", SGD, 1, dict(SD_KW)),
}
EVAL_CASES = ("sample_ddpm", "sample_dpm", "denoise_ddpm")


def sd_config() -> UNet2DConditionConfig:
    return UNet2DConditionConfig(**dict(UNet2DConditionConfig.tiny().__dict__,
                                        sample_size=SD_HW, attention_impl="flash"))


def build_model(kind: str, inputs: dict) -> torch.nn.Module:
    if kind == "unet":
        model = UNet2D(UNet2DConfig(**CELEB_LIKE))
        model.load_state_dict(inputs["unet"])
        return model
    if kind == "tiny":
        return TinyEps(tiny_params(0, channels=TINY_C))
    return build_unet_cond(sd_config(), seed=5, device="cpu")


def run_case(name: str, inputs: dict) -> dict:
    """One step case on this rank: its params, EMA and metrics after each step."""
    kind, opt_cfg, steps, kw = STEP_CASES[name]
    model = build_model(kind, inputs)
    opt, sched = build_optimizer(opt_cfg, model.parameters())
    state = TrainState.create(model, opt, sched, use_ema=kw.get("use_ema", False))
    if kind == "sd":
        eps_apply, schedule = cond_unet_eps_apply, sd_noise_schedule(device="cpu")
    else:
        eps_apply = unet_eps_apply if kind == "unet" else tiny_apply
        schedule = NoiseSchedule.create(1000, device="cpu")
    step = build_deletion_train_step(eps_apply, schedule, DeletionStepConfig(**kw))
    batch = {k: rank_rows(v, 1) for k, v in inputs[name]["batch"].items()}
    metrics = []
    for draws in inputs[name]["draws"][:steps]:
        state, m = step(state, batch, draws=draws)
        metrics.append({k: float(v) for k, v in m.items()})
    return {"params": {k: v.detach().clone() for k, v in model.state_dict().items()},
            "ema": None if state.ema is None else [e.clone() for e in state.ema.params],
            "metrics": metrics}


def run_pretrain(inputs: dict) -> dict:
    model = UNet2D(UNet2DConfig(**CELEB_LIKE))
    model.load_state_dict(inputs["unet"])
    opt, sched = build_optimizer(SGD, model.parameters())
    state = TrainState.create(model, opt, sched)
    step = build_pretrain_step(unet_eps_apply, NoiseSchedule.create(1000, device="cpu"))
    p = inputs["pretrain"]
    _, m = step(state, rank_rows(p["batch"]), draws=p["draws"])
    return {"params": {k: v.detach().clone() for k, v in model.state_dict().items()},
            "metrics": {k: float(v) for k, v in m.items()}}


def run_evaluator(name: str, inputs: dict) -> np.ndarray:
    """Samples or a denoising injection of MB images by the tiny UNet."""
    model = UNet2D(UNet2DConfig(**CELEB_LIKE))
    model.load_state_dict(inputs["unet"])
    solver = "dpm" if name.endswith("dpm") else "ddpm"
    ev = Evaluator(unet_eps_apply, NoiseSchedule.create(1000, device="cpu"), (HW, HW, 3),
                   num_inference_steps=5, random_seed=3, solver=solver)
    if name.startswith("sample"):
        return ev.sample_images(model, MB, set_generator=True)
    return ev.denoise_images(model, inputs["noisy"], 20)


def make_inputs(unet_state: dict, draws: dict) -> dict:
    """The inputs file's content: ``unet_state`` the tiny UNet's weights,
    ``draws[name]`` each step case's list of global draws; batches, the
    pretrain draws and the noisy injection batch from numpy seeds."""
    rng = np.random.default_rng(11)
    shapes = {"unet": (HW, HW, 3), "tiny": (TINY_HW, TINY_HW, TINY_C), "sd": (SD_HW, SD_HW, SD_C)}
    inputs = {"unet": unet_state}
    for name, (kind, _, _, _) in STEP_CASES.items():
        mb = SD_MB if kind == "sd" else MB
        batch = {k: torch.from_numpy(rng.normal(size=(A, mb) + shapes[kind]).astype(np.float32))
                 for k in ("all", "deletion")}
        if kind == "sd":
            cond = rng.normal(size=(SD_LEN, 32)).astype(np.float32)
            batch["conditioning"] = torch.from_numpy(np.broadcast_to(cond, (A, mb) + cond.shape)
                                                     .copy())
        inputs[name] = {"batch": batch, "draws": draws[name]}
    inputs["pretrain"] = {
        "batch": torch.from_numpy(rng.normal(size=(MB, HW, HW, 3)).astype(np.float32)),
        "draws": {"noise": torch.from_numpy(rng.normal(size=(MB, HW, HW, 3)).astype(np.float32)),
                  "t": torch.from_numpy(rng.integers(0, 1000, size=MB))}}
    inputs["noisy"] = torch.from_numpy(rng.normal(size=(MB, HW, HW, 3)).astype(np.float32))
    return inputs
