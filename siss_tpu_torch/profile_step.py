"""Where the flagship train step's device time goes, on one NVIDIA card.

    python3 -m siss_tpu_torch.profile_step

Builds the flagship SISS deletion step (celebahq_256 UNet, microbatch 16 ×
4 accumulation steps, fp32 params with bf16 autocast, AdamW, EMA, t ≡ 999)
with random weights from a seed, runs one warm-up step, times three steps
on the host clock, then traces one step with ``torch.profiler`` and prints
the device time by kernel family and the device's busy share of the step.
``chip_smoke.py`` drives the same step through ``make_main_path``.
"""

from __future__ import annotations

import statistics
import time
from collections import defaultdict

import torch

MAIN_ACCUM, MAIN_MB = 4, 16

# Kernel-name fragments → family, first match wins.
_FAMILIES = (
    ("siss::", "siss epilogue (this repo's CUDA kernels)"),
    ("conv", "convolution (cuDNN)"), ("xmma", "convolution (cuDNN)"),
    ("implicit", "convolution (cuDNN)"), ("wgrad", "convolution (cuDNN)"),
    ("dgrad", "convolution (cuDNN)"), ("fprop", "convolution (cuDNN)"),
    ("gemm", "matmul (cuBLAS)"), ("cutlass", "matmul (cuBLAS)"), ("nvjet", "matmul (cuBLAS)"),
    ("group_norm", "group norm"), ("GroupNorm", "group norm"),
    ("multi_tensor", "optimizer / foreach"), ("foreach", "optimizer / foreach"),
    ("reduce", "reductions"), ("softmax", "softmax"),
    ("elementwise", "elementwise"), ("vectorized", "elementwise"),
    ("copy", "copies / casts"), ("cat", "copies / casts"), ("upsample", "upsample"),
)


def make_main_path(device="cuda"):
    """(state, step, batch, generator) of the flagship step on ``device``."""
    from siss_tpu_torch.diffusion import NoiseSchedule
    from siss_tpu_torch.models import UNet2DConfig, build_unet
    from siss_tpu_torch.train import (DeletionStepConfig, TrainState, build_deletion_train_step,
                                      build_optimizer, unet_eps_apply)

    model = build_unet(UNet2DConfig.celebahq_256(), seed=0, dtype=torch.bfloat16, device=device)
    opt, sched = build_optimizer({"_target_": "torch.optim.AdamW", "lr": 5e-6,
                                  "betas": [0.95, 0.999], "weight_decay": 1e-6}, model.parameters())
    state = TrainState.create(model, opt, sched, use_ema=True)
    step = build_deletion_train_step(
        unet_eps_apply, NoiseSchedule.create(1000, "linear", device=device),
        DeletionStepConfig(loss_params=(("lambd", 0.5),), scaling_norm=500.0,
                           grad_accum_steps=MAIN_ACCUM, t_min=999, t_max=1000, use_ema=True))
    gen = torch.Generator(device=device).manual_seed(0)
    batch = {k: torch.randn(MAIN_ACCUM, MAIN_MB, 256, 256, 3, generator=gen, device=device)
             for k in ("all", "deletion")}
    return state, step, batch, gen


def _family(name: str) -> str:
    for frag, fam in _FAMILIES:
        if frag in name:
            return fam
    return "other"


def main() -> None:
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        raise SystemExit("profile_step needs an NVIDIA card")
    state, step, batch, gen = make_main_path()
    state, _ = step(state, batch, gen)
    torch.cuda.synchronize()
    seconds = []
    for _ in range(3):
        t0 = time.perf_counter()
        state, _ = step(state, batch, gen)
        torch.cuda.synchronize()
        seconds.append(time.perf_counter() - t0)
    print(f"card: {torch.cuda.get_device_name(0)}")
    print(f"step seconds {[round(s, 4) for s in seconds]}, median {statistics.median(seconds):.4f}")

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        state, _ = step(state, batch, gen)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    by_family, by_kernel = defaultdict(float), defaultdict(lambda: [0.0, 0])
    for ev in prof.events():
        if ev.device_type == torch.autograd.DeviceType.CUDA:
            ms = ev.time_range.elapsed_us() / 1e3
            by_family[_family(ev.name)] += ms
            by_kernel[ev.name][0] += ms
            by_kernel[ev.name][1] += 1
    busy = sum(by_family.values())
    print(f"traced step: wall {wall * 1e3:.1f} ms, device busy {busy:.1f} ms "
          f"({100 * busy / (wall * 1e3):.1f}%), idle {100 * (1 - busy / (wall * 1e3)):.1f}%")
    for fam, ms in sorted(by_family.items(), key=lambda kv: -kv[1]):
        print(f"  {ms:9.2f} ms {100 * ms / busy:5.1f}%  {fam}")
    print("top kernels:")
    for name, (ms, n) in sorted(by_kernel.items(), key=lambda kv: -kv[1][0])[:15]:
        print(f"  {ms:9.2f} ms x{n:<5d} {name[:110]}")


if __name__ == "__main__":
    main()
