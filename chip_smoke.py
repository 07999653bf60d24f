#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (siss_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py

Phases, each of which raises on failure (the script then exits non-zero and
prints no result):

1. The card: its name and power limit as nvidia-smi reports them.
2. Build the CUDA kernels from ``siss_tpu_torch/ops/csrc`` (nvcc, sm_90a).
3. Hold each kernel against its plain PyTorch version on the card: the
   main-path shape [16, 256, 256, 3] fp32 with the main path's data
   (t = 999 noising and the keep/forget mixture), the same in bf16, and
   ragged shapes (28×28×1, and 15×15×3, whose row length takes the
   one-element-per-load path). The reduce runs twice and must repeat bit
   for bit. Then time kernel and plain version at the main-path shape.
4. One fused SISS train step of a tiny UNet on the card against the same
   step on the CPU (plain versions), from the same weights and draws.
5. The main path at full width: UNet2DConfig.celebahq_256(), microbatch 16
   × 4 accumulation steps, fp32 params with bf16 autocast, AdamW(5e-6,
   betas (0.95, 0.999), wd 1e-6), scaling_norm 500, λ 0.5, t ≡ 999, EMA;
   random weights from a seed; 1 warm-up and 3 timed steps. The kernels'
   launch counts are set to 0 just before and read just after: each step
   must launch the reduce 4 times and the backward 8 times.

The line before the last is the kernels' JSON record; the last line is
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
H100_BYTES_PER_S = 3.35e12     # HBM3, H100 SXM data sheet
H100_FP32_FLOPS = 67e12        # fp32 outside the tensor cores, H100 SXM data sheet
REDUCE_FLOPS_PER_ELEM = 14     # 2 residuals (mul+sub), 2 eps (mul+sub), 4 squares+adds
BWD_FLOPS_PER_ELEM = 11        # 2 residuals, 2 eps, 2 weights, 1 add


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def gpu_ms(torch, fn, launches=20, repeats=5):
    """Median device time of one call of ``fn``, from CUDA events around
    ``launches`` back-to-back calls. A sleep kernel is queued first so the
    host enqueues every call before the device reaches them: the events then
    time the device, not the host's launch overhead."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(repeats):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(20_000_000)
        start.record()
        for _ in range(launches):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / launches)
    return times


def main_path_inputs(torch, shape, dtype, seed):
    """preds, mix, keep, forget, gamma, sigma as the fused step makes them at t = 999."""
    from siss_tpu_torch.diffusion import NoiseSchedule, q_sample

    gen = torch.Generator(device="cuda").manual_seed(seed)
    sched = NoiseSchedule.create(1000, "linear", device="cuda")
    B = shape[0]
    keep, forget, noise, preds = (torch.randn(shape, generator=gen, device="cuda") for _ in range(4))
    t = torch.full((B,), 999, device="cuda")
    mask = (torch.rand(B, generator=gen, device="cuda") > 0.5).reshape((B,) + (1,) * (len(shape) - 1))
    mix = torch.where(mask, q_sample(sched, keep, noise, t), q_sample(sched, forget, noise, t))
    big = [x.to(dtype).contiguous() for x in (preds, mix, keep, forget)]
    return big, sched.gamma[t], sched.sigma[t]


def random_inputs(torch, shape, dtype, seed, lo, hi):
    """Independent normals with gamma ~ U(lo, hi), as tests/test_pallas_ops.py."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    big = [torch.randn(shape, generator=gen, device="cuda").to(dtype) for _ in range(4)]
    gamma = lo + (hi - lo) * torch.rand(shape[0], generator=gen, device="cuda")
    return big, gamma, torch.sqrt(1 - gamma ** 2)


def check_kernels(torch, name, big, gamma, sigma, rtol_sum, rtol_iw):
    """Kernel vs plain version on one input set; returns the max abs errors."""
    from siss_tpu_torch.ops import siss

    B = big[0].shape[0]
    flat = [x.reshape(B, -1) for x in big]
    inv_sigma = 1.0 / sigma
    sums_k = siss.siss_reduce(*flat, gamma, inv_sigma)
    sums_k2 = siss.siss_reduce(*flat, gamma, inv_sigma)
    sums_p = siss.siss_reduce_plain(*flat, gamma, inv_sigma)
    torch.cuda.synchronize()
    if not all(torch.equal(a, b) for a, b in zip(sums_k, sums_k2)):
        raise AssertionError(f"{name}: the reduce kernel did not repeat bit for bit")
    labels = ("dist_x", "dist_a", "lx", "la")
    for lab, k, p in zip(labels, sums_k, sums_p):
        torch.testing.assert_close(k, p, rtol=rtol_sum, atol=0, msg=lambda m: f"{name} {lab}: {m}")
    reduce_err = max(float((k - p).abs().max()) for k, p in zip(sums_k, sums_p))

    # The epilogue as the step calls it (kernels inside the autograd.Function),
    # against the same math from the plain sums. iw = exp(−logaddexp(…, d))
    # with d = (dist_x − dist_a)/2σ²: the two sums are ~2e5 at the main
    # shape and nearly equal, so the rounding of each fp32 sum moves d, and
    # a small iw by that much relative, whatever the summation order. Each
    # row is held at the larger of rtol_iw and the worst-case rounding of a
    # tree sum of P terms, log2(P)·2^-24 of each sum, carried into d: a bound
    # set by the dtype and the shape, not by this run.
    preds = big[0].clone().requires_grad_(True)
    wlx, wla, aux = siss.siss_weighted_sums(preds, *big[1:], gamma, sigma, 0.5)
    iw_x, iw_a = siss._iw_from_dists(sums_p[0], sums_p[1], sigma, 0.5)
    ulp_sum = math.ceil(math.log2(flat[0].shape[1])) * 2.0 ** -24
    row_tol = torch.clamp(ulp_sum * (sums_p[0] + sums_p[1]) / (2 * sigma.float() ** 2),
                          min=rtol_iw)
    iw_err = 0.0
    for lab, got, want in (("iw_x", aux["iw_x"], iw_x), ("iw_a", aux["iw_a"], iw_a)):
        rel = (got - want).abs() / want.abs().clamp_min(1e-30)
        if not bool((rel <= row_tol).all()):
            raise AssertionError(f"{name} {lab}: relative errors {rel.tolist()} above {row_tol.tolist()}")
        iw_err = max(iw_err, float(rel.max()))
    pixels = flat[0].shape[1]
    w_tol = max(rtol_sum, float(row_tol.max()))
    for lab, got, want in (("lx_mean", aux["lx_mean"], sums_p[2] / pixels),
                           ("la_mean", aux["la_mean"], sums_p[3] / pixels),
                           ("wlx", wlx, (iw_x * sums_p[2]).sum()),
                           ("wla", wla, (iw_a * sums_p[3]).sum())):
        rtol = rtol_sum if lab.endswith("mean") else w_tol
        torch.testing.assert_close(got, want, rtol=rtol, atol=0, msg=lambda m: f"{name} {lab}: {m}")

    # Both backward pulls: the kernel through autograd against the plain
    # gradient with the same per-row weights (cotangent 1 on one output).
    bwd_err = 0.0
    zero = torch.zeros_like(aux["iw_x"])
    for pull, (out, cx, ca) in enumerate(((wlx, aux["iw_x"], zero), (wla, zero, aux["iw_a"]))):
        (g,) = torch.autograd.grad(out, preds, retain_graph=pull == 0)
        want = siss.siss_grad_preds_plain(*flat, gamma, inv_sigma, cx, ca).to(g.dtype).reshape(g.shape)
        torch.testing.assert_close(g, want, rtol=1e-3, atol=1e-6, msg=lambda m: f"{name} pull {pull}: {m}")
        bwd_err = max(bwd_err, float((g.float() - want.float()).abs().max()))
    # The backward kernel alone on random per-row weights.
    gen = torch.Generator(device="cuda").manual_seed(1)
    cx, ca = (2 * torch.rand(B, generator=gen, device="cuda") for _ in range(2))
    g_k = siss.siss_grad_preds(*flat, gamma, inv_sigma, cx, ca)
    g_p = siss.siss_grad_preds_plain(*flat, gamma, inv_sigma, cx, ca)
    torch.testing.assert_close(g_k, g_p, rtol=1e-3, atol=1e-6, msg=lambda m: f"{name} bwd: {m}")
    bwd_err = max(bwd_err, float((g_k - g_p).abs().max()))
    print(f"kernel check {name}: ok  reduce max_abs_err={reduce_err:.3e}  "
          f"bwd max_abs_err={bwd_err:.3e}  iw max rel err {iw_err:.3e} "
          f"(row bound up to {float(row_tol.max()):.3e})")
    return reduce_err, bwd_err


def phase_kernels(torch):
    from siss_tpu_torch.ops import siss

    main_shape = (16, 256, 256, 3)
    big, gamma, sigma = main_path_inputs(torch, main_shape, torch.float32, seed=0)
    errs = check_kernels(torch, "main fp32 [16,256,256,3]", big, gamma, sigma, 1e-5, 1e-3)
    bf, g_bf, s_bf = main_path_inputs(torch, main_shape, torch.bfloat16, seed=0)
    check_kernels(torch, "main bf16 [16,256,256,3]", bf, g_bf, s_bf, 1e-2, 1e-2)
    for shape, dtype, rtol in (((3, 28, 28, 1), torch.float32, 1e-5),
                               ((2, 15, 15, 3), torch.float32, 1e-5),
                               ((3, 28, 28, 1), torch.bfloat16, 1e-2)):
        r = random_inputs(torch, shape, dtype, seed=1, lo=0.3, hi=0.7)
        check_kernels(torch, f"ragged {str(dtype)[6:]} {list(shape)}", *r, rtol, max(rtol, 1e-3))

    # Timing at the main-path shape, in turns: plain, kernel, kernel, plain.
    B = main_shape[0]
    flat = [x.reshape(B, -1) for x in big]
    inv_sigma = 1.0 / sigma
    cx, ca = torch.full((B,), 0.7, device="cuda"), torch.full((B,), 1.3, device="cuda")
    fns = {
        "siss_reduce": (lambda: siss.siss_reduce(*flat, gamma, inv_sigma),
                        lambda: siss.siss_reduce_plain(*flat, gamma, inv_sigma)),
        "siss_bwd": (lambda: siss.siss_grad_preds(*flat, gamma, inv_sigma, cx, ca),
                     lambda: siss.siss_grad_preds_plain(*flat, gamma, inv_sigma, cx, ca)),
    }
    timings = {}
    for name, (kernel, plain) in fns.items():
        p1, k1, k2, p2 = (gpu_ms(torch, f) for f in (plain, kernel, kernel, plain))
        timings[name] = (statistics.median(k1 + k2), statistics.median(p1 + p2))
    elems = B * flat[0].shape[1]
    esize = flat[0].element_size()
    bounds = {
        "siss_reduce": (4 * elems * esize + 2 * B * 4 + 4 * B * 4, REDUCE_FLOPS_PER_ELEM * elems),
        "siss_bwd": (4 * elems * esize + 4 * B * 4 + elems * 4, BWD_FLOPS_PER_ELEM * elems),
    }
    record = {}
    for name, (nbytes, flops) in bounds.items():
        t_bytes = nbytes / H100_BYTES_PER_S * 1e3
        t_ops = flops / H100_FP32_FLOPS * 1e3
        ms, plain_ms = timings[name]
        record[name] = dict(max_abs_err=errs[0] if name == "siss_reduce" else errs[1], ms=ms,
                            plain_ms=plain_ms, bound_ms=max(t_bytes, t_ops),
                            bound_by="bytes" if t_bytes >= t_ops else "operations",
                            library_ms=None)
        print(f"kernel time {name} [16,256,256,3] fp32: {ms:.4f} ms  plain {plain_ms:.4f} ms  "
              f"bound {max(t_bytes, t_ops):.4f} ms ({nbytes / 1e6:.1f} MB)")
    return record


def phase_tiny_step_parity(torch):
    """The whole fused step on the card (kernels) against the CPU (plain
    versions), tiny UNet, fp32, no TF32, the same weights and draws."""
    from siss_tpu_torch.diffusion import NoiseSchedule
    from siss_tpu_torch.models import UNet2DConfig, build_unet
    from siss_tpu_torch.train import (DeletionStepConfig, TrainState, build_deletion_train_step,
                                      build_optimizer, unet_eps_apply)
    from siss_tpu_torch.train.step import draw_microbatch_randomness

    cfg = UNet2DConfig(sample_size=16, in_channels=3, out_channels=3, block_out_channels=(32, 64),
                       down_block_types=("DownBlock2D", "AttnDownBlock2D"),
                       up_block_types=("AttnUpBlock2D", "UpBlock2D"), attention_head_dim=None,
                       norm_num_groups=8, flip_sin_to_cos=False, freq_shift=1, downsample_padding=0)
    step_cfg = DeletionStepConfig(scaling_norm=5.0, grad_accum_steps=2, t_min=900, t_max=1000)
    gen = torch.Generator().manual_seed(0)
    batch = {k: torch.randn(2, 4, 16, 16, 3, generator=gen) for k in ("all", "deletion")}
    draws = draw_microbatch_randomness(gen, 2, 4, (16, 16, 3), 900, 1000, "cpu")
    results = {}
    for dev in ("cpu", "cuda"):
        model = build_unet(cfg, seed=3, device=dev)
        opt, sched = build_optimizer({"_target_": "sgd", "lr": 1.0}, model.parameters())
        step = build_deletion_train_step(unet_eps_apply, NoiseSchedule.create(1000, device=dev), step_cfg)
        state, metrics = step(TrainState.create(model, opt, sched),
                              {k: v.to(dev) for k, v in batch.items()},
                              draws={k: v.to(dev) for k, v in draws.items()})
        results[dev] = ({k: v.detach().cpu() for k, v in model.state_dict().items()},
                        {k: float(v) for k, v in metrics.items()})
    (p_cpu, m_cpu), (p_gpu, m_gpu) = results["cpu"], results["cuda"]
    for k in m_cpu:
        rtol = 1e-3 if k.startswith("importance_weight") else 1e-4
        if abs(m_gpu[k] - m_cpu[k]) > 1e-6 + rtol * abs(m_cpu[k]):
            raise AssertionError(f"tiny step metric {k}: card {m_gpu[k]} vs CPU {m_cpu[k]}")
    err = max(float((p_gpu[k] - p_cpu[k]).abs().max()) for k in p_cpu)
    for k in p_cpu:
        torch.testing.assert_close(p_gpu[k], p_cpu[k], rtol=1e-4, atol=1e-6,
                                   msg=lambda m: f"tiny step param {k}: {m}")
    print(f"tiny step card vs CPU: ok  params max_abs_err={err:.3e}  "
          f"scaling_factor={m_gpu['gradient/scaling_factor']:.6g}")


def phase_main_path(torch):
    from siss_tpu_torch.ops import launch_counts, reset_launch_counts
    from siss_tpu_torch.profile_step import MAIN_ACCUM, MAIN_MB, make_main_path

    accum, mb = MAIN_ACCUM, MAIN_MB
    state, step, batch, gen = make_main_path()
    model = state.model
    n_params = sum(p.numel() for p in model.parameters())
    before = [p.detach().clone() for p in model.parameters()]

    reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    seconds, all_metrics = [], []
    for i in range(4):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, metrics = step(state, batch, gen)
        torch.cuda.synchronize()
        seconds.append(time.perf_counter() - t0)
        all_metrics.append({k: float(v) for k, v in metrics.items()})
    counts = dict(launch_counts)
    peak = torch.cuda.max_memory_allocated()

    expected = {"siss_reduce": 4 * accum, "siss_bwd": 4 * 2 * accum}
    if counts != expected:
        raise AssertionError(f"launch counts {counts} over 4 steps, expected {expected}")
    for i, m in enumerate(all_metrics):
        bad = {k: v for k, v in m.items() if v != v or v in (float("inf"), float("-inf"))}
        if bad:
            raise AssertionError(f"step {i}: non-finite metrics {bad}")
    moved = sum(float((p.detach() - b).abs().sum()) for p, b in zip(model.parameters(), before))
    if not moved > 0:
        raise AssertionError("the parameters did not move")
    if state.step != 4 or state.ema.step != 4:
        raise AssertionError(f"step counters {state.step}, {state.ema.step} != 4")
    timed = seconds[1:]
    med = statistics.median(timed)
    print(f"main path celebahq_256 ({n_params} params) bs {mb} x accum {accum}: "
          f"warm-up {seconds[0]:.3f} s, steps {[round(s, 4) for s in timed]} s, "
          f"median {med:.4f} s = {accum * mb / med:.2f} img/s, "
          f"peak memory {peak / 2**30:.2f} GiB, launches {counts}")
    print("main path metrics (last step): " + json.dumps(all_metrics[-1], sort_keys=True))
    return counts


def main() -> int:
    if not (ROOT / "siss_tpu_torch").is_dir():
        print(f"chip_smoke.py must run from a checkout of the repository: no siss_tpu_torch/ "
              f"beside {Path(__file__).name}", file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available():
        print("torch.cuda.is_available() is False: chip_smoke.py needs an NVIDIA card",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()

    card = card_line()
    print(f"card: {card}")
    print(f"torch {torch.__version__} cuda {torch.version.cuda} python {sys.version.split()[0]}")

    from siss_tpu_torch.ops import build

    build.load()
    info = build.build_info
    print(f"kernels built in {info['seconds']:.2f} s")
    for line in info["log"].splitlines():
        if "registers" in line or "Compiling entry" in line or "spill" in line:
            print("  " + line.strip())

    record = phase_kernels(torch)
    phase_tiny_step_parity(torch)
    counts = phase_main_path(torch)

    sources = {"siss_reduce": ("siss_tpu_torch/ops/csrc/siss_reduce.cu", "siss_tpu/ops/siss_pallas.py:55"),
               "siss_bwd": ("siss_tpu_torch/ops/csrc/siss_bwd.cu", "siss_tpu/ops/siss_pallas.py:120")}
    kernels = [dict(name=name, route="cuda", source=src, replaces=rep, launches=counts[name],
                    **record[name]) for name, (src, rep) in sources.items()]
    print(f"total {time.perf_counter() - t_start:.1f} s")
    print(f"card: {card}")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
