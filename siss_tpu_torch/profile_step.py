"""Where a SISS train step's device time goes, on one NVIDIA card.

    python3 -m siss_tpu_torch.profile_step [--workload celeb|sd|tshirt]

``celeb`` (the default) builds the flagship SISS deletion step (celebahq_256
UNet, microbatch 16 × 4 accumulation steps, fp32 params with bf16 autocast,
AdamW, EMA, t ≡ 999); ``sd`` the SD-1.x latent step of
``configs/delete_sd.yaml`` (``make_sd_path``); ``tshirt`` the unlearning
step of ``configs/delete_tshirt.yaml`` (``make_tshirt_path``). Weights are
random from a seed; both TF32 switches are off. The script runs one warm-up
step, times three steps on the host clock, then traces one step with
``torch.profiler`` while recording the step's spans (``utils.spans``), and
prints the device's busy share of the step (the union of kernel
intervals), the device time of the kernels launched in each span (the
innermost span open at a kernel's launch, on whichever thread launched it:
the autograd engine launches a backward's kernels from its own), and the
longest kernels. ``chip_smoke.py`` drives the same steps through
``make_main_path`` and ``make_sd_path``.
"""

from __future__ import annotations

import argparse
import statistics
import time
from collections import defaultdict

import torch

from siss_tpu_torch.utils import spans

MAIN_ACCUM, MAIN_MB = 4, 16
SD_ACCUM, SD_MB = 16, 1
# configs/delete_sd.yaml's optimizer and step knobs.
SD_ADAMW = {"_target_": "torch.optim.AdamW", "lr": 1e-5, "betas": [0.9, 0.999],
            "weight_decay": 1e-2, "eps": 1e-8}
SD_STEP_KW = dict(loss_params=(("lambd", 0.5),), scaling_norm=750.0, max_grad_norm=1.0,
                  grad_accum_steps=SD_ACCUM, t_min=999, t_max=1000)
TSHIRT_MB = 64

def make_main_path(device="cuda", dtype=torch.bfloat16, mesh=None):
    """(state, step, batch, generator) of the flagship step on ``device``;
    ``dtype`` is the UNet's compute type (bf16 autocast over fp32 params);
    ``mesh`` a ``parallel.RankMesh`` whose ``fsdp`` or ``tensor`` axis
    splits the UNet (None: every rank on ``data``)."""
    from siss_tpu_torch.diffusion import NoiseSchedule
    from siss_tpu_torch.models import UNet2DConfig, build_unet
    from siss_tpu_torch.parallel import shard_module
    from siss_tpu_torch.train import (DeletionStepConfig, TrainState, build_deletion_train_step,
                                      build_optimizer, unet_eps_apply)

    model = build_unet(UNet2DConfig.celebahq_256(), seed=0, dtype=dtype, device=device)
    sharding = shard_module(model, mesh)
    opt, sched = build_optimizer({"_target_": "torch.optim.AdamW", "lr": 5e-6,
                                  "betas": [0.95, 0.999], "weight_decay": 1e-6}, model.parameters(),
                                 sharding=sharding)
    state = TrainState.create(model, opt, sched, use_ema=True, sharding=sharding)
    step = build_deletion_train_step(
        unet_eps_apply, NoiseSchedule.create(1000, "linear", device=device),
        DeletionStepConfig(loss_params=(("lambd", 0.5),), scaling_norm=500.0,
                           grad_accum_steps=MAIN_ACCUM, t_min=999, t_max=1000, use_ema=True))
    gen = torch.Generator(device=device).manual_seed(0)
    batch = {k: torch.randn(MAIN_ACCUM, MAIN_MB, 256, 256, 3, generator=gen, device=device)
             for k in ("all", "deletion")}
    return state, step, batch, gen


def make_sd_path(device="cuda", mesh=None, dtype=torch.bfloat16, optimizer=None):
    """(state, step, batch, generator) of the SD-1.x latent SISS step on
    ``device``, as ``bench.py --workload sd`` builds it (``build_sd``) with
    ``configs/delete_sd.yaml``'s settings and ``--attention-impl flash``:
    sd_v1 UNet with gradient checkpointing of the resnets only, bf16
    autocast over fp32 params, AdamW(1e-5, betas (0.9, 0.999), wd 1e-2,
    eps 1e-8), scaling_norm 750, λ 0.5, t ≡ 999, max_grad_norm 1, no EMA,
    microbatch 1 × 16 accumulation steps of [64, 64, 4] latents, and one
    77×768 prompt embedding shared by every microbatch. ``mesh`` and
    ``dtype`` as in ``make_main_path``; ``optimizer``: another optimizer
    config than the AdamW (``build_optimizer``'s keys)."""
    from siss_tpu_torch.diffusion import sd_noise_schedule
    from siss_tpu_torch.models import UNet2DConditionConfig, build_unet_cond
    from siss_tpu_torch.parallel import shard_module
    from siss_tpu_torch.train import (DeletionStepConfig, TrainState, build_deletion_train_step,
                                      build_optimizer, cond_unet_eps_apply)

    cfg = UNet2DConditionConfig.sd_v1(gradient_checkpointing=True, attention_impl="flash",
                                      remat_attention=False)
    model = build_unet_cond(cfg, seed=0, dtype=dtype, device=device)
    sharding = shard_module(model, mesh)
    opt, sched = build_optimizer(optimizer or SD_ADAMW, model.parameters(), sharding=sharding)
    state = TrainState.create(model, opt, sched, sharding=sharding)
    step = build_deletion_train_step(cond_unet_eps_apply, sd_noise_schedule(device=device),
                                     DeletionStepConfig(**SD_STEP_KW))
    gen = torch.Generator(device=device).manual_seed(0)
    hw, ch = cfg.sample_size, cfg.in_channels
    batch = {k: torch.randn(SD_ACCUM, SD_MB, hw, hw, ch, generator=gen, device=device)
             for k in ("all", "deletion")}
    prompt = torch.randn(77, cfg.cross_attention_dim, generator=gen, device=device)
    batch["conditioning"] = prompt.expand(SD_ACCUM, SD_MB, *prompt.shape)
    return state, step, batch, gen


def make_tshirt_path(device="cuda"):
    """(state, step, batch, generator) of the t-shirt unlearning step on
    ``device``, with ``configs/delete_tshirt.yaml``'s settings: the
    full-width mnist_tshirt UNet in float32, AdamW(5e-5, betas (0.95,
    0.999), wd 1e-6, eps 1e-8), SISS with λ 0.5 and scaling_norm 5, t ~
    U{0..999}, max_grad_norm 1, no EMA, one microbatch of 64 [28, 28, 1]
    images."""
    from siss_tpu_torch.diffusion import NoiseSchedule
    from siss_tpu_torch.models import UNet2DConfig, build_unet
    from siss_tpu_torch.train import (DeletionStepConfig, TrainState, build_deletion_train_step,
                                      build_optimizer, unet_eps_apply)

    cfg = UNet2DConfig.mnist_tshirt()
    model = build_unet(cfg, seed=0, dtype=torch.float32, device=device)
    opt, sched = build_optimizer({"_target_": "torch.optim.AdamW", "lr": 5e-5,
                                  "betas": [0.95, 0.999], "weight_decay": 1e-6, "eps": 1e-8},
                                 model.parameters())
    state = TrainState.create(model, opt, sched)
    step = build_deletion_train_step(
        unet_eps_apply, NoiseSchedule.create(1000, "linear", device=device),
        DeletionStepConfig(loss_params=(("lambd", 0.5),), scaling_norm=5.0, t_min=0, t_max=1000))
    gen = torch.Generator(device=device).manual_seed(0)
    hw, ch = cfg.sample_size, cfg.in_channels
    batch = {k: torch.randn(1, TSHIRT_MB, hw, hw, ch, generator=gen, device=device)
             for k in ("all", "deletion")}
    return state, step, batch, gen


PATHS = {"celeb": make_main_path, "sd": make_sd_path, "tshirt": make_tshirt_path}


def _kernels_by_span(events, recorded):
    """(device ms of the kernels launched in each span, "(no span)" for the
    rest; busy ms, the union of the kernel intervals; {kernel: [ms, count]}).
    A kernel's launch is the runtime or driver call of its correlation id."""
    cuda = torch.autograd.DeviceType.CUDA
    launches, kernels = {}, []
    for e in events:
        if e.device_type() == cuda:
            if not e.is_user_annotation() and e.end_ns() > e.start_ns():
                kernels.append(e)
        elif not e.is_user_annotation() and e.name().startswith("cu"):
            launches[e.correlation_id()] = e.start_ns()     # a runtime or driver call
    by_span, by_kernel = defaultdict(float), defaultdict(lambda: [0.0, 0])
    busy, cursor = 0, None
    for k in sorted(kernels, key=lambda e: e.start_ns()):
        ms = (k.end_ns() - k.start_ns()) / 1e6
        t = launches.get(k.linked_correlation_id() or k.correlation_id())
        inner = min((s for s in recorded if t is not None and s.start_ns <= t < s.end_ns),
                    key=lambda s: s.end_ns - s.start_ns, default=None)
        by_span["(no span)" if inner is None else inner.name] += ms
        by_kernel[k.name()][0] += ms
        by_kernel[k.name()][1] += 1
        start = k.start_ns() if cursor is None else max(k.start_ns(), cursor)
        if cursor is None or k.end_ns() > cursor:
            busy += k.end_ns() - start
            cursor = k.end_ns()
    return by_span, busy / 1e6, by_kernel


def main() -> None:
    from torch.profiler import ProfilerActivity, profile

    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--workload", choices=tuple(PATHS), default="celeb")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_step needs an NVIDIA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    state, step, batch, gen = PATHS[args.workload]()
    state, _ = step(state, batch, gen)
    torch.cuda.synchronize()
    seconds = []
    for _ in range(3):
        t0 = time.perf_counter()
        state, _ = step(state, batch, gen)
        torch.cuda.synchronize()
        seconds.append(time.perf_counter() - t0)
    print(f"card: {torch.cuda.get_device_name(0)}, workload {args.workload}")
    print(f"step seconds {[round(s, 4) for s in seconds]}, median {statistics.median(seconds):.4f}")

    # Device activity only, as the benchmark traces: with host ops recorded
    # too, a kernel's linked correlation names its op, not its launch.
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        spans.start_recording()
        t0 = time.perf_counter()
        state, _ = step(state, batch, gen)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        recorded = spans.stop_recording()
    by_span, busy, by_kernel = _kernels_by_span(prof.profiler.kineto_results.events(), recorded)
    print(f"traced step: wall {wall * 1e3:.1f} ms, device busy {busy:.1f} ms "
          f"({100 * busy / (wall * 1e3):.1f}%, the union of kernel intervals), "
          f"idle {100 * (1 - busy / (wall * 1e3)):.1f}%")
    print("device time of the kernels launched in each span:")
    total = sum(by_span.values())
    for name, ms in sorted(by_span.items(), key=lambda kv: -kv[1]):
        print(f"  {ms:9.2f} ms {100 * ms / total:5.1f}%  {name}")
    print("top kernels:")
    for name, (ms, n) in sorted(by_kernel.items(), key=lambda kv: -kv[1][0])[:15]:
        print(f"  {ms:9.2f} ms x{n:<5d} {name[:110]}")
    print("this repo's kernels:")
    for name, (ms, n) in sorted(by_kernel.items(), key=lambda kv: -kv[1][0]):
        if name.startswith(("void siss::", "void flash::", "siss::", "flash::")):
            print(f"  {ms:9.2f} ms x{n:<5d} {name.split('(')[0]}")


if __name__ == "__main__":
    main()
