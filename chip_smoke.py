#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (siss_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py

Phases, each of which raises on failure (the script then exits non-zero and
prints no result):

1. The card: its name and power limit as nvidia-smi reports them.
2. Build the CUDA kernels from ``siss_tpu_torch/ops/csrc`` (nvcc, sm_90a);
   print ptxas' registers, spills and any wgmma-serialization warning
   (C75xx) for each tensor-core flash kernel (bf16 ``flash::sm90::``, fp32
   ``flash::tf32x3::``), and fail if ``flash::sm90::dq_kernel<40>`` or
   ``<80>`` (the SD shapes' dQ) spills or serializes, or if
   ``flash::tf32x3::fwd_kernel<40>``, ``<80>``, ``dkv_kernel<40>``,
   ``<80>``, ``dq_kernel<40>`` or ``<80>`` spills; show from the library's
   SASS (cuobjdump) that every bf16 kernel runs HGMMA (wgmma), that every
   fp32 forward, dK/dV and dQ runs HMMA with TF32 operands (mma.sync
   m16n8k8) for all of its products, with fewer FFMA than one key (or
   query) tile would need on the FMA units, and that the FMA forward, dK/dV
   and dQ are gone.
3. Hold each kernel against its plain PyTorch version on the card: the
   main-path shape [16, 256, 256, 3] fp32 with the main path's data
   (t = 999 noising and the keep/forget mixture), the same in bf16, the
   shipped celeb task's microbatch [4, 256, 256, 3] with the same data in
   fp32 and bf16, the SD
   step's shape [1, 64, 64, 4] fp32 with the SD schedule's t = 999 (one
   row split into 8 chunks), the t-shirt step's [64, 28, 28, 1] fp32 with
   t ~ U{0..999}, and ragged shapes (28×28×1, and 15×15×3, whose row
   length takes the one-element-per-load path). The reduce runs twice and
   must repeat bit for bit. Then time kernel and plain version at the
   celeb, celeb task, SD and t-shirt shapes, and an empty kernel launched
   the same way (the launch floor, for 1 and 2 launches).
4. Hold the three flash-attention kernels (forward, dK/dV, dQ) against
   their plain versions on the card: o, lse, dq, dk and dv at the SD
   shapes (B, H, N, d) = (1, 8, 4096, 40) and (1, 8, 1024, 80) and at
   (2, 4, 256, 8), (1, 2, 128, 128), (1, 2, 128, 24) (d padded to 40),
   (4, 12, 384, 40) (three 128-row tiles, two consumer warpgroups) and
   (2, 3, 256, 40), each in fp32 and bf16, with the operands in the UNet's
   strided [B, N, H, d] layout, and (2, 3, 256, 40) once more with
   contiguous [B, H, N, d] operands: every element within its bound, and
   in bf16 the RMS error within its bound too. Each case prints which
   kernel ran for each (kernel, type): ``wgmma`` or ``tf32x3``.
   lse, o, dk, dv and dq must repeat bit for bit; the autograd.Function
   must give the kernels' gradients; a shape the kernels cannot take, and a
   bf16 operand that breaks TMA's 16-byte rule, must raise. At the SD
   shapes the largest errors of the fp32 forward, dK/dV and dQ against a
   float64 reference (the plain versions' formulas in float64) must be at
   most twice the fp32 plain versions' own, in o and lse, in dk and dv, and
   in dq, and each must agree with the plain model of its arithmetic
   (``flash_attention_tf32x3_emulated``, ``flash_bwd_dkv_tf32x3_emulated``,
   ``flash_bwd_dq_tf32x3_emulated``) within the same bound. Then time
   kernel, plain version and PyTorch's scaled_dot_product_attention at the
   SD shapes, in bf16 and in fp32 (SDPA with TF32 off; the 3xTF32 kernels'
   bounds at the TF32 rate for their three products, beside the 67 TFLOP/s
   FMA bound). The fp32 dQ at
   (1, 8, 4096, 40) is timed in three rounds spread over the phase, each
   with the SM clock, power draw and temperature that nvidia-smi sampled
   during it.
5. One fused SISS train step of a tiny UNet on the card against the same
   step on the CPU (plain versions), from the same weights and draws; then
   the same for the SD latent step of a tiny conditional UNet whose level-0
   self-attention (256 tokens) runs the flash kernels.
6. The t-shirt task through ``siss_tpu_torch.main`` at the full
   mnist_tshirt width (``configs/train_tshirt_mnist.yaml`` and
   ``configs/delete_tshirt.yaml``): pretrain 10 epochs of the repository's
   5,632 images at batch 128 (440 steps), check the checkpoint bundle, then
   30 SISS unlearning steps at batch 64 from its ``latest`` with 50-step
   DDPM evaluations of 128 images every 10 steps and the shipped metrics
   block: the exact likelihood (RK45, every 30 steps) must log a finite,
   positive ``metrics/likelihood`` at steps 0 and 30, each evaluation's
   seconds and NFE printed. The run must launch the reduce exactly 30 and
   the SISS backward 60 times and log finite values of the task's metric
   keys. Then the probe: ε-MSE at t = 300 on 256 forget and 256 keep
   images before and after; the forget ratio must exceed the keep ratio.
6b. From the same pretrain bundle, each of the five other objectives
   (NegGrad with superfactor 1.0 decaying by 0.99 a microbatch) and SISS
   with ``deletion.fused_siss=false``, 30 steps at batch 64, evaluations
   off: finite metrics, ``gradient/scaling_factor`` on every step of a
   surgery objective (> 0; ≤ 0 for EraseDiff) and on none of a scalar one,
   no SISS kernel launch; each prints its median step time, img/s and
   probe ratios; unfused SISS's ratios must be within 5% of the fused
   run's.
6c. ``--config-name=train_classifier`` as shipped (final batch accuracy
   above 0.9), then 10 SISS steps with the Inception Score over that
   classifier (``num_classes=11``) and the membership losses turned on:
   ``metrics/is_mean``, ``metrics/is_std`` and the membership keys finite
   at steps 0, 5 and 10; 10 reduce and 20 SISS backward launches.
7. The celeb main path at full width: UNet2DConfig.celebahq_256(),
   microbatch 16 × 4 accumulation steps, fp32 params with bf16 autocast,
   AdamW(5e-6, betas (0.95, 0.999), wd 1e-6), scaling_norm 500, λ 0.5,
   t ≡ 999, EMA; random weights from a seed; 1 warm-up and 3 timed steps.
   Each step must launch the reduce 4 times and the SISS backward 8 times.
7b. The celeb task through ``siss_tpu_torch.main`` at full width
   (``configs/delete_celeb.yaml``: celebahq_256, bs 4 × 16 accumulation
   steps, bf16 autocast, t ≡ 999, evaluations every step: a 50-step DDPM
   sample and the denoising injections at t = 250) on a folder of 64
   random 256² JPEGs, random weights, 3 steps, with FID (16 samples, the
   random-projection embedder: ``metrics/fid_rand``) at steps 0 and 3 and
   membership at t = 250 on every evaluation. It must launch the reduce 48
   and the SISS backward 96 times and log finite step metrics, both panels
   and the membership keys at steps 0–3. Then InceptionV3 (``fid``
   variant) on the card with the golden synthetic weights
   (``tests/goldens/inception_fid_golden.npz``, TF32 off) must give the
   recorded features within 1e-3, and is timed at batch 64 × 299².
8. The SD main path at full width (``profile_step.make_sd_path``, the
   ``configs/delete_sd.yaml`` step of ``bench.py --workload sd`` with
   ``attention_impl="flash"``): the sd_v1 UNet, microbatch 1 × 16
   accumulation steps; 1 warm-up and 2 timed steps. Each step must launch
   flash_fwd 160, flash_bwd_dkv 320, flash_bwd_dq 320, siss_reduce 16 and
   siss_bwd 32 times.

For each path the kernels' launch counts are set to 0 just before it and
read just after. The line before the last is the kernels' JSON record: each
kernel's launches on the path that runs it (the bf16 flash kernels on the
SD path, the fp32 forward, dK/dV and dQ, ``flash_fwd_fp32``,
``flash_bwd_dkv_fp32`` and ``flash_bwd_dq_fp32``, on phase 5's tiny SD
step),
its times at the heaviest SD site and its error; the last line is
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import math
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
H100_BYTES_PER_S = 3.35e12     # HBM3, H100 SXM data sheet
H100_FP32_FLOPS = 67e12        # fp32 outside the tensor cores, H100 SXM data sheet
H100_BF16_FLOPS = 989e12       # bf16 tensor cores, dense, H100 SXM data sheet
H100_TF32_FLOPS = 495e12       # TF32 tensor cores, dense, H100 SXM data sheet
# Exponentials per second: 16 a clock per SM (the SFUs) on 132 SMs at the
# 1.98 GHz boost clock. A floor beside the bound for softmax at small d.
H100_EXP_PER_S = 16 * 132 * 1.98e9
REDUCE_FLOPS_PER_ELEM = 14     # 2 residuals (mul+sub), 2 eps (mul+sub), 4 squares+adds
BWD_FLOPS_PER_ELEM = 11        # 2 residuals, 2 eps, 2 weights, 1 add
# The SISS kernels' operands on the SD step: one [64, 64, 4] latent per
# microbatch; on the t-shirt unlearning step: 64 [28, 28, 1] images.
SISS_SD_SHAPE = (1, 64, 64, 4)
SISS_TSHIRT_SHAPE = (64, 28, 28, 1)
# The shipped celeb task's microbatch (configs/delete_celeb.yaml: bs 4 × 16).
SISS_CELEB_TASK_SHAPE = (4, 256, 256, 3)
# (B, H, N, d): the SD UNet's flash sites (64×64 and 32×32 latents), then
# a small head dim, the largest one, and one padded to a built head dim.
FLASH_SD_SHAPES = ((1, 8, 4096, 40), (1, 8, 1024, 80))
FLASH_SHAPES = FLASH_SD_SHAPES + ((2, 4, 256, 8), (1, 2, 128, 128), (1, 2, 128, 24),
                                  (4, 12, 384, 40), (2, 3, 256, 40))
# Matrix-product operations per B·H·N²·d of each flash kernel (2 per
# multiply-add): the forward's S and P·V; dK/dV recomputes S and dP and
# forms dV and dK; dQ recomputes S and dP and forms dQ.
FLASH_OPS = {"flash_fwd": 4, "flash_bwd_dkv": 8, "flash_bwd_dq": 6}
# Tensor-core products per product of the 3xTF32 kernels (lo·hi, hi·lo, hi·hi).
TF32X3_PASSES = 3
# Peak rate and products per product of each flash kernel_impl.
FLASH_PEAKS = {"wgmma": (H100_BF16_FLOPS, 1), "tf32x3": (H100_TF32_FLOPS, TF32X3_PASSES)}


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


def main_path_inputs(torch, sched, shape, dtype, seed, t_range=None):
    """preds, mix, keep, forget, gamma, sigma as the fused step makes them
    at t = 999 of the noise schedule ``sched``, or at t ~ U{t_range}."""
    from siss_tpu_torch.diffusion import q_sample

    gen = torch.Generator(device="cuda").manual_seed(seed)
    B = shape[0]
    keep, forget, noise, preds = (torch.randn(shape, generator=gen, device="cuda") for _ in range(4))
    t = (torch.full((B,), 999, device="cuda") if t_range is None
         else torch.randint(*t_range, (B,), generator=gen, device="cuda"))
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


def siss_times(torch, big, gamma, sigma):
    """Kernel and plain ms of both SISS kernels on one input set, in turns
    (plain, kernel, kernel, plain), and each kernel's bound."""
    from siss_tpu_torch.ops import siss

    B = big[0].shape[0]
    flat = [x.reshape(B, -1) for x in big]
    inv_sigma = 1.0 / sigma
    cx, ca = torch.full((B,), 0.7, device="cuda"), torch.full((B,), 1.3, device="cuda")
    fns = {
        "siss_reduce": (lambda: siss.siss_reduce(*flat, gamma, inv_sigma),
                        lambda: siss.siss_reduce_plain(*flat, gamma, inv_sigma)),
        "siss_bwd": (lambda: siss.siss_grad_preds(*flat, gamma, inv_sigma, cx, ca),
                     lambda: siss.siss_grad_preds_plain(*flat, gamma, inv_sigma, cx, ca)),
    }
    elems = B * flat[0].shape[1]
    esize = flat[0].element_size()
    bounds = {
        "siss_reduce": (4 * elems * esize + 2 * B * 4 + 4 * B * 4, REDUCE_FLOPS_PER_ELEM * elems),
        "siss_bwd": (4 * elems * esize + 4 * B * 4 + elems * 4, BWD_FLOPS_PER_ELEM * elems),
    }
    times = {}
    for name, (kernel, plain) in fns.items():
        p1, k1, k2, p2 = (gpu_ms(torch, f) for f in (plain, kernel, kernel, plain))
        nbytes, flops = bounds[name]
        t_bytes = nbytes / H100_BYTES_PER_S * 1e3
        t_ops = flops / H100_FP32_FLOPS * 1e3
        times[name] = dict(ms=statistics.median(k1 + k2), plain_ms=statistics.median(p1 + p2),
                           bound_ms=max(t_bytes, t_ops),
                           bound_by="bytes" if t_bytes >= t_ops else "operations")
        print(f"kernel time {name} {list(big[0].shape)} {str(big[0].dtype)[6:]}: "
              f"{times[name]['ms']:.4f} ms  plain {times[name]['plain_ms']:.4f} ms  "
              f"bound {times[name]['bound_ms']:.3g} ms ({nbytes / 1e6:.3g} MB)")
    return times


def phase_kernels(torch):
    from siss_tpu_torch.diffusion import NoiseSchedule, sd_noise_schedule

    celeb = NoiseSchedule.create(1000, "linear", device="cuda")
    main_shape = (16, 256, 256, 3)
    big, gamma, sigma = main_path_inputs(torch, celeb, main_shape, torch.float32, seed=0)
    errs = check_kernels(torch, "main fp32 [16,256,256,3]", big, gamma, sigma, 1e-5, 1e-3)
    bf, g_bf, s_bf = main_path_inputs(torch, celeb, main_shape, torch.bfloat16, seed=0)
    check_kernels(torch, "main bf16 [16,256,256,3]", bf, g_bf, s_bf, 1e-2, 1e-2)
    task = main_path_inputs(torch, celeb, SISS_CELEB_TASK_SHAPE, torch.float32, seed=4)
    check_kernels(torch, f"celeb task fp32 {list(SISS_CELEB_TASK_SHAPE)}", *task, 1e-5, 1e-3)
    task_bf = main_path_inputs(torch, celeb, SISS_CELEB_TASK_SHAPE, torch.bfloat16, seed=4)
    check_kernels(torch, f"celeb task bf16 {list(SISS_CELEB_TASK_SHAPE)}", *task_bf, 1e-2, 1e-2)
    # The SD step's operands: fp32 (the UNet's output type), SD schedule.
    sd = main_path_inputs(torch, sd_noise_schedule(device="cuda"), SISS_SD_SHAPE, torch.float32,
                          seed=2)
    check_kernels(torch, f"SD fp32 {list(SISS_SD_SHAPE)}", *sd, 1e-5, 1e-3)
    for shape, dtype, rtol in (((3, 28, 28, 1), torch.float32, 1e-5),
                               ((2, 15, 15, 3), torch.float32, 1e-5),
                               ((3, 28, 28, 1), torch.bfloat16, 1e-2)):
        r = random_inputs(torch, shape, dtype, seed=1, lo=0.3, hi=0.7)
        check_kernels(torch, f"ragged {str(dtype)[6:]} {list(shape)}", *r, rtol, max(rtol, 1e-3))

    # The t-shirt step's operands: one microbatch of 64 [28, 28, 1] images,
    # t ~ U{0..999} as configs/delete_tshirt.yaml draws it.
    tshirt = main_path_inputs(torch, celeb, SISS_TSHIRT_SHAPE, torch.float32, seed=3,
                              t_range=(0, 1000))
    check_kernels(torch, f"t-shirt fp32 {list(SISS_TSHIRT_SHAPE)}", *tshirt, 1e-5, 1e-3)

    # The JSON record holds the celeb shape; the celeb task's, SD and t-shirt
    # shapes' times are printed, beside the launch floor.
    record = siss_times(torch, big, gamma, sigma)
    siss_times(torch, *task)
    siss_times(torch, *sd)
    siss_times(torch, *tshirt)
    floors = {n: statistics.median(launch_floor_ms(torch, n)) for n in (1, 2)}
    print(f"launch floor (empty kernel through ctypes on the same stream): "
          f"{floors[1]:.4f} ms for 1 launch (siss_bwd launches 1), "
          f"{floors[2]:.4f} ms for 2 (siss_reduce launches 2)")
    for name, err in zip(("siss_reduce", "siss_bwd"), errs):
        record[name].update(max_abs_err=err, library_ms=None)
    return record


def launch_floor_ms(torch, n):
    """gpu_ms of ``n`` launches of the library's empty kernel."""
    from siss_tpu_torch.ops import build

    lib = build.load()

    def launch():
        err = lib.empty_launches(n, torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"empty kernel launch failed: CUDA error {err}")

    return gpu_ms(torch, launch)


def flash_bound(torch, ref, terms, dtype, N):
    """Largest |kernel − plain| each element of a flash output may show.

    Each output element is a sum over N products, ``terms`` the sum of
    their magnitudes (Σ|p|·|v| for o, and so on). Both versions sum in
    fp32, in other orders: up to ~log2(N) fp32 roundings of ``terms`` (a
    factor 32 of headroom on top). Each also rounds one factor of every
    product to the operands' type (P, or dS) before the product, at other
    places (the forward kernel rounds P before normalising it), so the two
    may differ by 2u of ``terms``, u the type's unit roundoff. A bf16
    output is rounded once more, where a last-bit difference may flip the
    rounding: 2u of the element."""
    u = 2.0 ** -8 if dtype == torch.bfloat16 else 2.0 ** -24
    return 2 * u * ref.float().abs() + (2 * u + 32 * math.log2(N) * 2.0 ** -24) * terms


def rms(t):
    return float(t.float().square().mean().sqrt())


def flash_rms_bound(ref, quad):
    """Largest RMS, over one bf16 output, of kernel − plain.

    ``flash_bound`` adds the bf16 roundings of an element's terms as if all
    had one sign. They are independent from term to term, each at most u =
    2^-8 relative in either version, so their sum has an RMS of at most
    u·√(2/3) of ``quad`` = √(Σ term²); 2u·rms(quad) leaves a factor 2.4.
    The last rounding of two nearby values differs by at most one ulp,
    ≤ 2u of the element: 2u·rms(ref). The fp32 sums' order differences,
    log2(N)·2^-24 of Σ|term| ≤ √N·quad, stay under 1% of 2u·quad for
    N ≤ 4096."""
    return 2 * 2.0 ** -8 * (rms(quad) + rms(ref))


def check_flash_case(torch, shape, dtype, seed, contiguous=False):
    """Kernels against plain versions on one input set; max abs errors.
    The operands are [B, H, N, d] views of [B, N, H, d] tensors, the UNet's
    layout, or with ``contiguous`` contiguous [B, H, N, d] tensors."""
    from siss_tpu_torch.ops import flash_attention as fa
    from siss_tpu_torch.ops import launch_counts

    B, H, N, d = shape
    gen = torch.Generator(device="cuda").manual_seed(seed)
    if contiguous:
        q, k, v, do = (torch.randn(shape, generator=gen, device="cuda").to(dtype) for _ in range(4))
    else:
        q, k, v, do = (torch.randn((B, N, H, d), generator=gen, device="cuda").to(dtype)
                       .transpose(1, 2) for _ in range(4))
    scale = 1.0 / math.sqrt(d)
    name = f"{list(shape)} {str(dtype)[6:]}{' contiguous' if contiguous else ''}"
    before = dict(launch_counts)
    o, lse = fa.flash_fwd(q, k, v, scale)
    o2, lse2 = fa.flash_fwd(q, k, v, scale)
    di = fa.row_dot(o, do)
    dk, dv = fa.flash_bwd_dkv(q, k, v, lse, do, di, scale)
    dk2, dv2 = fa.flash_bwd_dkv(q, k, v, lse, do, di, scale)
    dq = fa.flash_bwd_dq(q, k, v, lse, do, di, scale)
    dq2 = fa.flash_bwd_dq(q, k, v, lse, do, di, scale)
    torch.cuda.synchronize()
    launched = {key: launch_counts[key] - before[key] for key in FLASH_OPS}
    if launched != {"flash_fwd": 2, "flash_bwd_dkv": 2, "flash_bwd_dq": 2}:
        raise AssertionError(f"flash {name}: the wrappers did not launch the kernels: {launched}")
    if not (torch.equal(lse, lse2) and torch.equal(o, o2)):
        raise AssertionError(f"flash {name}: the forward kernel did not repeat bit for bit")
    if not (torch.equal(dk, dk2) and torch.equal(dv, dv2)):
        raise AssertionError(f"flash {name}: the dK/dV kernel did not repeat bit for bit")
    if not torch.equal(dq, dq2):
        raise AssertionError(f"flash {name}: the dQ kernel did not repeat bit for bit")
    del dk2, dv2
    impls = {key: fa.kernel_impl(key, dtype) for key in FLASH_OPS}

    o_p, lse_p = fa.flash_attention_plain(q, k, v, scale)
    dk_p, dv_p = fa.flash_bwd_dkv_plain(q, k, v, lse, do, di, scale)
    dq_p = fa.flash_bwd_dq_plain(q, k, v, lse, do, di, scale)
    # Σ of the magnitudes of each output element's terms.
    p, ds = fa._probs(q, k, v, lse, do, di, scale)
    qa, ka, va, doa = (t.float().abs() for t in (q, k, v, do))
    terms = {"o": p @ va, "lse": lse_p.abs(), "dv": p.transpose(-1, -2) @ doa,
             "dk": ds.abs().transpose(-1, -2) @ qa, "dq": ds.abs() @ ka}
    # √(Σ term²) of each element, for the bf16 outputs' RMS bound.
    quad = {}
    if dtype == torch.bfloat16:
        p2, ds2 = p.square(), ds.square()
        quad = {"o": (p2 @ va.square()).sqrt(), "dv": (p2.transpose(-1, -2) @ doa.square()).sqrt(),
                "dk": (ds2.transpose(-1, -2) @ qa.square()).sqrt(),
                "dq": (ds2 @ ka.square()).sqrt()}
        del p2, ds2
    del p, ds
    errs, rms_ratios = {}, []
    for kernel, label, got, want, out_dtype in (
            ("flash_fwd", "o", o, o_p, dtype), ("flash_fwd", "lse", lse, lse_p, torch.float32),
            ("flash_bwd_dkv", "dk", dk, dk_p, dtype), ("flash_bwd_dkv", "dv", dv, dv_p, dtype),
            ("flash_bwd_dq", "dq", dq, dq_p, dtype)):
        err = (got.float() - want.float()).abs()
        bound = flash_bound(torch, want, terms[label], out_dtype, N)
        if not bool((err <= bound).all()):
            worst = int(torch.argmax(err - bound))
            raise AssertionError(f"flash {name} {label}: |err| {float(err.flatten()[worst]):.3e} "
                                 f"above its bound {float(bound.flatten()[worst]):.3e}")
        if label in quad:
            rms_err, rms_bound = rms(err), flash_rms_bound(want, quad[label])
            if not rms_err <= rms_bound:
                raise AssertionError(f"flash {name} {label}: RMS error {rms_err:.3e} above its "
                                     f"bound {rms_bound:.3e}")
            rms_ratios.append(f"{label} {rms_err / rms_bound:.3f}")
        errs[kernel] = max(errs.get(kernel, 0.0), float(err.max()))

    if dtype == torch.float32 and shape in FLASH_SD_SHAPES:
        check_fp32_forward(torch, fa, name, q, k, v, scale, o, lse, o_p, lse_p, terms, N)
        check_fp32_dkv(torch, fa, name, q, k, v, lse, do, di, scale, dk, dv, dk_p, dv_p, terms, N)
        check_fp32_dq(torch, fa, name, q, k, v, lse, do, di, scale, dq, dq_p, terms, N)

    # The autograd.Function on the card: the same kernels, so the same bits.
    leaves = [t.detach().requires_grad_(True) for t in (q, k, v)]
    grads = torch.autograd.grad(fa.flash_attention(*leaves, scale), leaves, do)
    for label, got, want in zip(("dq", "dk", "dv"), grads, (dq, dk, dv)):
        if not torch.equal(got, want):
            raise AssertionError(f"flash {name}: FlashAttention's {label} is not the kernels'")
    print(f"flash check {name}: ok  " + "  ".join(f"{k} ({impls[k]}) max_abs_err={e:.3e}"
                                                  for k, e in errs.items())
          + (f"  RMS err / bound: {', '.join(rms_ratios)}" if rms_ratios else ""))
    return errs


def float64_errors(torch, q, k, v, scale, o, lse, o_p, lse_p):
    """{"o": (kernel's, plain version's), "lse": (…)}: the largest |error|
    of each against the plain version's formula in float64."""
    s64 = torch.matmul(q.double(), k.double().transpose(-1, -2)) * scale
    lse64 = torch.logsumexp(s64, dim=-1)
    o64 = torch.matmul(torch.exp(s64 - lse64[..., None]), v.double())
    del s64
    return {label: tuple(float((t.double() - ref).abs().max()) for t in (got, plain))
            for label, got, plain, ref in (("o", o, o_p, o64), ("lse", lse, lse_p, lse64))}


def check_fp32_forward(torch, fa, name, q, k, v, scale, o, lse, o_p, lse_p, terms, N):
    """The fp32 (3xTF32) forward beyond flash_bound: against a float64
    reference, the plain version's formula in float64 (flash_attention_plain
    casts its operands with .float()), its largest error must be at most
    twice the fp32 plain version's own, in o and in lse: as accurate as
    cuBLAS in fp32. And it must agree with flash_attention_tf32x3_emulated,
    the plain model of its arithmetic, within flash_bound."""
    ratios = []
    for label, (err, plain_err) in float64_errors(torch, q, k, v, scale, o, lse, o_p,
                                                  lse_p).items():
        if not err <= 2 * plain_err:
            raise AssertionError(f"flash {name} {label}: float64 error {err:.3e}, more than twice "
                                 f"the fp32 plain version's {plain_err:.3e}")
        ratios.append(f"{label} {err:.3e} vs plain {plain_err:.3e} ({err / plain_err:.2f}x)")
    o_e, lse_e = fa.flash_attention_tf32x3_emulated(q, k, v, scale)
    for label, got, want, t in (("o", o, o_e, terms["o"]), ("lse", lse, lse_e, lse_e.abs())):
        if not bool(((got - want).abs() <= flash_bound(torch, want, t, torch.float32, N)).all()):
            raise AssertionError(f"flash {name} {label}: the kernel and its emulated arithmetic "
                                 f"differ beyond flash_bound")
    emu_err = float((o - o_e).abs().max())
    print(f"flash check {name} fp32 forward against float64: {'; '.join(ratios)}; "
          f"against its emulated arithmetic: o max_abs_err={emu_err:.3e}")


def float64_dkv_errors(torch, q, k, v, lse, do, di, scale, dk, dv, dk_p, dv_p):
    """{"dk": (kernel's, plain version's), "dv": (…)}: the largest |error|
    of each against flash_bwd_dkv_plain's formula in float64, from the same
    lse and di cast to float64."""
    q, k, v, do = (t.double() for t in (q, k, v, do))
    p = torch.exp(torch.matmul(q, k.transpose(-1, -2)) * scale - lse.double()[..., None])
    ds = (torch.matmul(do, v.transpose(-1, -2)) - di.double()[..., None]) * p * scale
    dv64 = torch.matmul(p.transpose(-1, -2), do)
    del p
    dk64 = torch.matmul(ds.transpose(-1, -2), q)
    del ds
    return {label: tuple(float((t.double() - ref).abs().max()) for t in (got, plain))
            for label, got, plain, ref in (("dk", dk, dk_p, dk64), ("dv", dv, dv_p, dv64))}


def check_fp32_dkv(torch, fa, name, q, k, v, lse, do, di, scale, dk, dv, dk_p, dv_p, terms, N):
    """The fp32 (3xTF32) dK/dV beyond flash_bound, as check_fp32_forward
    holds the forward: its largest float64 error in dk and in dv at most
    twice the fp32 plain version's, and agreement with
    flash_bwd_dkv_tf32x3_emulated, the plain model of its arithmetic,
    within flash_bound."""
    ratios = []
    for label, (err, plain_err) in float64_dkv_errors(torch, q, k, v, lse, do, di, scale, dk, dv,
                                                      dk_p, dv_p).items():
        if not err <= 2 * plain_err:
            raise AssertionError(f"flash {name} {label}: float64 error {err:.3e}, more than twice "
                                 f"the fp32 plain version's {plain_err:.3e}")
        ratios.append(f"{label} {err:.3e} vs plain {plain_err:.3e} ({err / plain_err:.2f}x)")
    dk_e, dv_e = fa.flash_bwd_dkv_tf32x3_emulated(q, k, v, lse, do, di, scale)
    emu_errs = []
    for label, got, want in (("dk", dk, dk_e), ("dv", dv, dv_e)):
        if not bool(((got - want).abs() <= flash_bound(torch, want, terms[label], torch.float32,
                                                         N)).all()):
            raise AssertionError(f"flash {name} {label}: the kernel and its emulated arithmetic "
                                 f"differ beyond flash_bound")
        emu_errs.append(f"{label} max_abs_err={float((got - want).abs().max()):.3e}")
    print(f"flash check {name} fp32 dK/dV against float64: {'; '.join(ratios)}; "
          f"against its emulated arithmetic: {', '.join(emu_errs)}")


def float64_dq_errors(torch, q, k, v, lse, do, di, scale, dq, dq_p):
    """(kernel's, plain version's) largest |error| in dq against
    flash_bwd_dq_plain's formula in float64, from the same lse and di cast
    to float64."""
    q, k, v, do = (t.double() for t in (q, k, v, do))
    p = torch.exp(torch.matmul(q, k.transpose(-1, -2)) * scale - lse.double()[..., None])
    ds = (torch.matmul(do, v.transpose(-1, -2)) - di.double()[..., None]) * p * scale
    del p
    dq64 = torch.matmul(ds, k)
    del ds
    return tuple(float((t.double() - dq64).abs().max()) for t in (dq, dq_p))


def check_fp32_dq(torch, fa, name, q, k, v, lse, do, di, scale, dq, dq_p, terms, N):
    """The fp32 (3xTF32) dQ beyond flash_bound, as check_fp32_dkv holds the
    dK/dV: its largest float64 error at most twice the fp32 plain
    version's, and agreement with flash_bwd_dq_tf32x3_emulated, the plain
    model of its arithmetic, within flash_bound."""
    err, plain_err = float64_dq_errors(torch, q, k, v, lse, do, di, scale, dq, dq_p)
    if not err <= 2 * plain_err:
        raise AssertionError(f"flash {name} dq: float64 error {err:.3e}, more than twice the "
                             f"fp32 plain version's {plain_err:.3e}")
    dq_e = fa.flash_bwd_dq_tf32x3_emulated(q, k, v, lse, do, di, scale)
    if not bool(((dq - dq_e).abs() <= flash_bound(torch, dq_e, terms["dq"], torch.float32,
                                                   N)).all()):
        raise AssertionError(f"flash {name} dq: the kernel and its emulated arithmetic differ "
                             f"beyond flash_bound")
    print(f"flash check {name} fp32 dQ against float64: dq {err:.3e} vs plain {plain_err:.3e} "
          f"({err / plain_err:.2f}x); against its emulated arithmetic: dq "
          f"max_abs_err={float((dq - dq_e).abs().max()):.3e}")


def phase_flash_kernels(torch):
    import torch.nn.functional as F

    from siss_tpu_torch.ops import flash_attention as fa

    dq_rounds = [dq_round(torch, fa, "before the checks")]
    errs = {}
    for shape in FLASH_SHAPES:
        for dtype in (torch.float32, torch.bfloat16):
            errs[shape, dtype] = check_flash_case(torch, shape, dtype, seed=len(errs))
    for dtype in (torch.float32, torch.bfloat16):
        check_flash_case(torch, (2, 3, 256, 40), dtype, seed=len(errs) + 1, contiguous=True)
    # On a CUDA tensor the wrapper launches its kernel or raises: shapes the
    # kernels cannot take, and bf16 operands that break TMA's 16-byte rule
    # (a view one element off an aligned base; a head dim of 12).
    flat = torch.zeros(1 * 128 * 2 * 40 + 1, dtype=torch.bfloat16, device="cuda")
    for shape, dtype, offset, match in (((1, 2, 200, 40), torch.float32, 0, "N %"),
                                        ((1, 2, 128, 136), torch.float32, 0, "head_dim"),
                                        ((1, 2, 128, 40), torch.bfloat16, 1, "16 bytes"),
                                        ((1, 2, 128, 12), torch.bfloat16, 0, "head_dim % 8")):
        B, H, N, d = shape
        x = (torch.zeros((B, N, H, d), dtype=dtype, device="cuda") if not offset
             else flat[offset:offset + B * N * H * d].view(B, N, H, d)).transpose(1, 2)
        try:
            fa.flash_fwd(x, x, x, 0.1)
        except ValueError as e:
            if match not in str(e):
                raise
        else:
            raise AssertionError(f"flash_fwd took an unsupported {dtype} operand {shape} "
                                 f"(offset {offset}) on the card")

    dq_rounds.append(dq_round(torch, fa, "after the checks"))
    # Timing at the SD shapes in bf16 (the main path's type), then in fp32
    # (the 3xTF32 kernels, against SDPA in fp32 with TF32 off). The JSON
    # record holds each kernel at the 64×64-latent sites, the SD step's
    # heaviest: bf16, and the fp32 forward, dK/dV and dQ beside it.
    times = {(shape, dtype): time_flash(torch, fa, F, shape, dtype, errs[shape, dtype])
             for dtype in (torch.bfloat16, torch.float32) for shape in FLASH_SD_SHAPES}
    dq_rounds.append(dq_round(torch, fa, "after the timing"))
    print(f"fp32 dQ ({fa.kernel_impl('flash_bwd_dq', torch.float32)}) [1, 8, 4096, 40] by round: "
          + "; ".join(dq_rounds))
    record = dict(times[FLASH_SD_SHAPES[0], torch.bfloat16])
    for name in FLASH_OPS:
        record[f"{name}_fp32"] = times[FLASH_SD_SHAPES[0], torch.float32][name]
    return record


def dq_round(torch, fa, label):
    """One round of timing the fp32 dQ at (1, 8, 4096, 40) (median of 25
    batches of 20 launches), with nvidia-smi sampling the SM clock, power
    draw and temperature every 100 ms during it; a line to print."""
    B, H, N, d = FLASH_SD_SHAPES[0]
    gen = torch.Generator(device="cuda").manual_seed(7)
    q, k, v, do = (torch.randn((B, N, H, d), generator=gen, device="cuda").transpose(1, 2)
                   for _ in range(4))
    scale = 1.0 / math.sqrt(d)
    o, lse = fa.flash_fwd(q, k, v, scale)
    di = fa.row_dot(o, do)
    smi = subprocess.Popen(["nvidia-smi", "--query-gpu=clocks.sm,power.draw,temperature.gpu",
                            "--format=csv,noheader,nounits", "-lms", "100"],
                           stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
    try:
        ms = statistics.median(gpu_ms(torch, lambda: fa.flash_bwd_dq(q, k, v, lse, do, di, scale),
                                      repeats=25))
    finally:
        smi.terminate()
        out, _ = smi.communicate(timeout=30)
    samples = [[float(x) for x in line.split(",")] for line in out.splitlines()
               if line.count(",") == 2 and "N/A" not in line]
    if not samples:
        return f"{label} {ms:.4f} ms (no nvidia-smi samples)"
    clock, power, temp = (statistics.median(col) for col in zip(*samples))
    return (f"{label} {ms:.4f} ms at SM clock {clock:.0f} MHz, {power:.1f} W, {temp:.0f} C "
            f"(medians of {len(samples)} samples)")


def time_flash(torch, fa, F, shape, dtype, errs):
    """Kernel, plain version (in turns: plain, kernel, kernel, plain) and
    SDPA's forward and forward + backward at one shape and type; the bound
    from the bytes and the matrix products at the rate of the units the
    kernel runs them on (``FLASH_PEAKS`` by ``kernel_impl``): bf16 tensor
    cores; for the fp32 kernels the TF32 tensor cores, three products each
    (3xTF32)."""
    B, H, N, d = shape
    gen = torch.Generator(device="cuda").manual_seed(7)
    q, k, v, do = (torch.randn((B, N, H, d), generator=gen, device="cuda")
                   .to(dtype).transpose(1, 2) for _ in range(4))
    scale = 1.0 / math.sqrt(d)
    o, lse = fa.flash_fwd(q, k, v, scale)
    di = fa.row_dot(o, do)
    fns = {
        "flash_fwd": (lambda: fa.flash_fwd(q, k, v, scale),
                      lambda: fa.flash_attention_plain(q, k, v, scale)),
        "flash_bwd_dkv": (lambda: fa.flash_bwd_dkv(q, k, v, lse, do, di, scale),
                          lambda: fa.flash_bwd_dkv_plain(q, k, v, lse, do, di, scale)),
        "flash_bwd_dq": (lambda: fa.flash_bwd_dq(q, k, v, lse, do, di, scale),
                         lambda: fa.flash_bwd_dq_plain(q, k, v, lse, do, di, scale)),
    }
    leaves = [t.detach().requires_grad_(True) for t in (q, k, v)]
    sdpa_fwd = statistics.median(gpu_ms(torch, lambda: F.scaled_dot_product_attention(
        *leaves, scale=scale)))
    sdpa_all = statistics.median(gpu_ms(torch, lambda: torch.autograd.grad(
        F.scaled_dot_product_attention(*leaves, scale=scale), leaves, do)))
    esize = q.element_size()
    bhn2d = B * H * N * N * d
    elems = B * H * N * d
    nbytes = {"flash_fwd": 4 * elems * esize + B * H * N * 4,
              "flash_bwd_dkv": 6 * elems * esize + 2 * B * H * N * 4,
              "flash_bwd_dq": 5 * elems * esize + 2 * B * H * N * 4}
    type_name = str(dtype)[6:]

    def ops_ms(name):  # the matrix products' time at the peak of the units that run them
        peak, passes = FLASH_PEAKS[fa.kernel_impl(name, dtype)]
        return passes * FLASH_OPS[name] * bhn2d / peak * 1e3

    this = {}
    for name, (kernel, plain) in fns.items():
        impl = fa.kernel_impl(name, dtype)
        peak, passes = FLASH_PEAKS[impl]
        p1, k1, k2, p2 = (gpu_ms(torch, f) for f in (plain, kernel, kernel, plain))
        t_bytes = nbytes[name] / H100_BYTES_PER_S * 1e3
        t_ops = ops_ms(name)
        rec = dict(impl=impl, max_abs_err=errs[name],
                   ms=statistics.median(k1 + k2), plain_ms=statistics.median(p1 + p2),
                   bound_ms=max(t_bytes, t_ops),
                   bound_by="bytes" if t_bytes >= t_ops else "operations",
                   library_ms=sdpa_fwd if name == "flash_fwd" else sdpa_all - sdpa_fwd)
        this[name] = rec
        # Every kernel evaluates exp once per (query, key) pair.
        exp_floor = B * H * N * N / H100_EXP_PER_S * 1e3
        extra = ""
        if impl == "tf32x3":
            fma_bound = FLASH_OPS[name] * bhn2d / H100_FP32_FLOPS * 1e3
            extra = (f"  ({rec['bound_ms'] / rec['ms']:.1%} of it; fp32 FMA bound "
                     f"{fma_bound:.4f} ms at {H100_FP32_FLOPS / 1e12:.0f} TFLOP/s)")
        print(f"kernel time {name} ({impl}) {list(shape)} {type_name}: {rec['ms']:.4f} ms  "
              f"plain {rec['plain_ms']:.4f} ms  bound {rec['bound_ms']:.4f} ms "
              f"({rec['bound_by']}, {passes} × {FLASH_OPS[name]}·B·H·N²·d at "
              f"{peak / 1e12:.0f} TFLOP/s){extra}  exp floor {exp_floor:.4f} ms  "
              f"SDPA {'fwd' if name == 'flash_fwd' else 'bwd (fwd+bwd − fwd)'} "
              f"{rec['library_ms']:.4f} ms")
    # The two backward kernels' own operation bounds, each by its impl,
    # beside one kernel's 10·B·H·N²·d at the rate of the dK/dV's units.
    bwd = ("flash_bwd_dkv", "flash_bwd_dq")
    peak, passes = FLASH_PEAKS[this["flash_bwd_dkv"]["impl"]]
    print(f"  whole backward {list(shape)} {type_name}: kernels "
          f"{sum(this[n]['ms'] for n in bwd):.4f} ms  bound "
          f"{sum(ops_ms(n) for n in bwd):.4f} ms (sum of the kernels' own: "
          + " + ".join(f"{this[n]['impl']} {ops_ms(n):.4f}" for n in bwd)
          + f"); one kernel {passes * 10 * bhn2d / peak * 1e3:.4f} ms (10·B·H·N²·d at "
          f"{peak / 1e12:.0f} TFLOP/s × {passes})  SDPA {sdpa_all - sdpa_fwd:.4f} ms")
    return this


# The tensor-core kernels that must not spill or serialize their wgmma:
# the bf16 dQ and the fp32 forward, dK/dV and dQ at the SD UNet's two head
# dims.
SM90_CLEAN = ("flash::sm90::dq_kernel<40>", "flash::sm90::dq_kernel<80>")
TF32X3_CLEAN = ("flash::tf32x3::fwd_kernel<40>", "flash::tf32x3::fwd_kernel<80>",
                "flash::tf32x3::dkv_kernel<40>", "flash::tf32x3::dkv_kernel<80>",
                "flash::tf32x3::dq_kernel<40>", "flash::tf32x3::dq_kernel<80>")


def flash_kernel_name(mangled):
    """``flash::sm90::<kernel><D>`` or ``flash::tf32x3::<kernel><D>`` for
    the mangled name of a tensor-core flash kernel (``_ZN5flash4sm90…``,
    ``_ZN5flash6tf32x3…``), else None."""
    m = re.match(r"_ZN5flash(4sm90|6tf32x3)(\d+)", mangled)
    if m is None:
        return None
    ns, n, rest = m.group(1)[1:], int(m.group(2)), mangled[m.end():]
    d = re.match(r"ILi(\d+)E", rest[n:])
    return f"flash::{ns}::{rest[:n]}" + (f"<{d.group(1)}>" if d else "")


def ptxas_report(log):
    """{kernel: {"registers", "spill_bytes", "warnings"}} of the tensor-core
    flash kernels, from ptxas' -v output in the build log."""
    report, fn = {}, None
    for line in log.splitlines():
        named = re.search(r"(?:entry function|Function properties for|the function) '?(_Z\w+)", line)
        if named:
            fn = flash_kernel_name(named.group(1))
            if fn is not None:
                report.setdefault(fn, {"registers": None, "spill_bytes": 0, "warnings": []})
        if fn is None:
            continue
        if m := re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line):
            report[fn]["spill_bytes"] += int(m.group(1)) + int(m.group(2))
        elif m := re.search(r"Used (\d+) registers", line):
            report[fn]["registers"] = int(m.group(1))
        elif m := re.search(r"\((C75\d\d)\)", line):
            report[fn]["warnings"].append(m.group(1))
    return report


def check_ptxas(log):
    """Print each tensor-core kernel's registers, spills and C75xx
    warnings; raise if one of SM90_CLEAN or TF32X3_CLEAN spills or
    serializes its wgmma."""
    report = ptxas_report(log)
    for line in log.splitlines():
        if "(C75" in line:
            print("  " + line.strip())
    for fn, r in sorted(report.items()):
        print(f"  ptxas {fn}: {r['registers']} registers, {r['spill_bytes']} bytes spilled, "
              f"warnings {r['warnings'] or 'none'}")
    for fn in SM90_CLEAN + TF32X3_CLEAN:
        r = report.get(fn)
        if r is None or r["registers"] is None:
            raise AssertionError(f"ptxas reported nothing for {fn}")
        if r["spill_bytes"] or r["warnings"]:
            raise AssertionError(f"{fn}: {r['spill_bytes']} bytes spilled, warnings {r['warnings']}")


def sass_counts(sass):
    """{kernel: {opcode: count}} over the SASS of a library, for HGMMA (bf16
    wgmma), HMMA.1688.F32.TF32 (mma.sync m16n8k8, TF32 operands) and FFMA,
    with one example line of each; tensor-core flash kernels by
    ``flash_kernel_name``, others by their mangled names."""
    counts, fn = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            fn = line.split("Function :")[1].strip()
            fn = flash_kernel_name(fn) or fn
            counts[fn] = {"HGMMA": 0, "HMMA.1688.F32.TF32": 0, "FFMA": 0, "examples": {}}
            continue
        if fn is None or "*/" not in line:
            continue
        text = " ".join(line.split("*/")[1].split())
        for op in ("HGMMA", "HMMA.1688.F32.TF32", "FFMA"):
            if re.search(rf"\b{re.escape(op)}\b", text):
                counts[fn][op] += 1
                counts[fn]["examples"].setdefault(op, text.split(";")[0])
    return counts


def check_tensor_core_sass(lib_path):
    """From the built library's SASS: every bf16 tensor-core flash kernel
    runs HGMMA; every fp32 forward ``flash::tf32x3::fwd_kernel<D>`` runs at
    least 3·D + 24 HMMA with TF32 operands (three per 16 × 8 × 8 block: the
    3·D of a 64-key tile's O += P·V, which is fully unrolled, and the 24 of
    at least one 8-deep step of its S = Q·Kᵀ) and fewer FFMA than the 64·D a
    lane would issue for one key tile's two products on the FMA units; every
    fp32 dK/dV ``flash::tf32x3::dkv_kernel<D>`` runs at least 3·D + 24 TF32
    HMMA (a 32-query tile's dV += Pᵀ·dO and dK += dSᵀ·Q, fully unrolled:
    4 query steps × D/8 n-tiles × 3 each, and at least one 8-deep step of
    its Sᵀ = K·Qᵀ and dPᵀ = V·dOᵀ: 4 query n-tiles × 3 each) and fewer FFMA
    than the 64·D a lane would issue for one query tile's four products on
    the FMA units (16 keys × 32 queries × D × 4 over 32 lanes); every fp32
    dQ ``flash::tf32x3::dq_kernel<D>`` runs at least 3·D/2 + 24 TF32 HMMA
    (a 32-key tile's dQ += dS·K, fully unrolled: 4 key steps × D/8 n-tiles
    × 3 each, and at least one 8-deep step of its S = Q·Kᵀ and dP = dO·Vᵀ:
    4 key n-tiles × 3 each) and fewer FFMA than the 48·D a lane would issue
    for one key tile's three products on the FMA units (16 queries × 32
    keys × D × 3 over 32 lanes); the FMA forward
    (``flash::fwd_kernel<float, D>``), dK/dV (``flash::dkv_kernel<float,
    D>``) and dQ (``flash::dq_kernel<float, D>``) are gone. Raise
    otherwise."""
    from siss_tpu_torch.ops import build

    cuobjdump = Path(build._nvcc()).with_name("cuobjdump")
    sass = subprocess.run([str(cuobjdump), "--dump-sass", str(lib_path)], capture_output=True,
                          text=True, timeout=120, check=True).stdout
    counts = sass_counts(sass)
    sm90 = {f: c for f, c in counts.items() if f.startswith("flash::sm90::")}
    if not sm90 or not all(c["HGMMA"] for c in sm90.values()) or not set(SM90_CLEAN) <= set(sm90):
        raise AssertionError(f"bf16 tensor-core flash kernels without HGMMA in their SASS: "
                             f"{ {f: c['HGMMA'] for f, c in sm90.items()} }")
    for f, c in sorted(sm90.items()):
        print(f"  SASS {f}: {c['HGMMA']} HGMMA, e.g. {c['examples']['HGMMA']}")
    tf32 = {f: c for f, c in counts.items() if f.startswith("flash::tf32x3::")}
    if not set(TF32X3_CLEAN) <= set(tf32):
        raise AssertionError(f"fp32 tensor-core kernels are missing from the SASS: {sorted(tf32)}")
    # Per kernel: (HMMA floor, FFMA ceiling) at head dim D.
    floors = {"fwd_kernel": lambda D: (3 * D + 24, 64 * D),
              "dkv_kernel": lambda D: (3 * D + 24, 64 * D),
              "dq_kernel": lambda D: (3 * D // 2 + 24, 48 * D)}
    for f, c in sorted(tf32.items()):
        D = int(f[f.index("<") + 1:-1])
        least, most = floors[f[len("flash::tf32x3::"):f.index("<")]](D)
        hmma, ffma = c["HMMA.1688.F32.TF32"], c["FFMA"]
        print(f"  SASS {f}: {hmma} HMMA.1688.F32.TF32 (at least {least}), {ffma} FFMA "
              f"(under {most}), e.g. {c['examples'].get('HMMA.1688.F32.TF32')}")
        if hmma < least or ffma >= most:
            raise AssertionError(f"{f}: {hmma} TF32 HMMA (at least {least} expected) and "
                                 f"{ffma} FFMA (under {most} expected)")
    fma = [f for f in counts if f.startswith(("_ZN5flash10fwd_kernelIf", "_ZN5flash10dkv_kernelIf",
                                               "_ZN5flash9dq_kernelIf"))]
    if fma:
        raise AssertionError(f"the FMA forward, dK/dV or dQ is still built: {fma}")
    others = {f: c for f, c in counts.items() if f not in sm90 and f not in tf32}
    print(f"  SASS: {sum(c['HGMMA'] + c['HMMA.1688.F32.TF32'] for c in others.values())} HGMMA "
          f"or TF32 HMMA in the other {len(others)} kernels; no FMA forward, dK/dV or dQ")


def step_card_vs_cpu(torch, name, build_model, eps_apply, schedule, step_cfg, shape, cond=None):
    """One fused step on the card (kernels) against the CPU (plain
    versions), fp32, no TF32, the same weights and draws. Returns the
    card run's kernel launch counts."""
    from siss_tpu_torch.ops import launch_counts, reset_launch_counts
    from siss_tpu_torch.train import TrainState, build_deletion_train_step, build_optimizer
    from siss_tpu_torch.train.step import draw_microbatch_randomness

    A, mb = step_cfg.grad_accum_steps, 4
    gen = torch.Generator().manual_seed(0)
    batch = {k: torch.randn(A, mb, *shape, generator=gen) for k in ("all", "deletion")}
    if cond is not None:
        batch["conditioning"] = torch.randn(A, mb, *cond, generator=gen)
    draws = draw_microbatch_randomness(gen, A, mb, shape, step_cfg.t_min, step_cfg.t_max, "cpu")
    results = {}
    for dev in ("cpu", "cuda"):
        model = build_model(dev)
        opt, sched = build_optimizer({"_target_": "sgd", "lr": 1.0}, model.parameters())
        step = build_deletion_train_step(eps_apply, schedule(dev), step_cfg)
        reset_launch_counts()
        state, metrics = step(TrainState.create(model, opt, sched),
                              {k: v.to(dev) for k, v in batch.items()},
                              draws={k: v.to(dev) for k, v in draws.items()})
        results[dev] = ({k: v.detach().cpu() for k, v in model.state_dict().items()},
                        {k: float(v) for k, v in metrics.items()}, dict(launch_counts))
    (p_cpu, m_cpu, _), (p_gpu, m_gpu, counts) = results["cpu"], results["cuda"]
    for k in m_cpu:
        rtol = 1e-3 if k.startswith("importance_weight") else 1e-4
        if abs(m_gpu[k] - m_cpu[k]) > 1e-6 + rtol * abs(m_cpu[k]):
            raise AssertionError(f"{name} metric {k}: card {m_gpu[k]} vs CPU {m_cpu[k]}")
    err = max(float((p_gpu[k] - p_cpu[k]).abs().max()) for k in p_cpu)
    for k in p_cpu:
        torch.testing.assert_close(p_gpu[k], p_cpu[k], rtol=1e-4, atol=1e-6,
                                   msg=lambda m: f"{name} param {k}: {m}")
    print(f"{name} card vs CPU: ok  params max_abs_err={err:.3e}  "
          f"scaling_factor={m_gpu['gradient/scaling_factor']:.6g}  card launches {counts}")
    return counts


def phase_tiny_step_parity(torch):
    """The tiny celeb-like step, then the tiny SD step, card against CPU;
    the latter's card launch counts: the one path that runs the fp32 flash
    kernels."""
    import dataclasses

    from siss_tpu_torch.diffusion import NoiseSchedule, sd_noise_schedule
    from siss_tpu_torch.models import (UNet2DConditionConfig, UNet2DConfig, build_unet,
                                       build_unet_cond)
    from siss_tpu_torch.train import DeletionStepConfig, cond_unet_eps_apply, unet_eps_apply

    cfg = UNet2DConfig(sample_size=16, in_channels=3, out_channels=3, block_out_channels=(32, 64),
                       down_block_types=("DownBlock2D", "AttnDownBlock2D"),
                       up_block_types=("AttnUpBlock2D", "UpBlock2D"), attention_head_dim=None,
                       norm_num_groups=8, flip_sin_to_cos=False, freq_shift=1, downsample_padding=0)
    step_card_vs_cpu(torch, "tiny step", lambda dev: build_unet(cfg, seed=3, device=dev),
                     unet_eps_apply, lambda dev: NoiseSchedule.create(1000, device=dev),
                     DeletionStepConfig(scaling_norm=5.0, grad_accum_steps=2, t_min=900,
                                        t_max=1000), (16, 16, 3))

    # sample_size 16: level 0 has 256 tokens, so its self-attention (4 heads
    # of 8) runs the flash kernels; the 64-token mid block stays einsum.
    cond_cfg = dataclasses.replace(UNet2DConditionConfig.tiny(), sample_size=16,
                                   attention_impl="flash")
    counts = step_card_vs_cpu(
        torch, "tiny SD step", lambda dev: build_unet_cond(cond_cfg, seed=3, device=dev),
        cond_unet_eps_apply, lambda dev: sd_noise_schedule(device=dev),
        DeletionStepConfig(scaling_norm=750.0, grad_accum_steps=2, t_min=999, t_max=1000),
        (16, 16, 4), cond=(7, cond_cfg.cross_attention_dim))
    if not all(counts[k] > 0 for k in FLASH_OPS):
        raise AssertionError(f"the tiny SD step on the card did not run every flash kernel: {counts}")
    return counts


def drive_path(torch, name, make, steps, per_step, images_per_step):
    """Drive a full-width main path for ``steps`` steps (the first a
    warm-up) with the launch counts set to 0 just before and read just
    after; every kernel must have launched ``per_step`` times a step (0 for
    a kernel off this path). Returns the counts."""
    from siss_tpu_torch.ops import launch_counts, reset_launch_counts

    state, step, batch, gen = make()
    model = state.model
    n_params = sum(p.numel() for p in model.parameters())
    before = [p.detach().clone() for p in model.parameters()]

    reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    seconds, all_metrics = [], []
    for _ in range(steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, metrics = step(state, batch, gen)
        torch.cuda.synchronize()
        seconds.append(time.perf_counter() - t0)
        all_metrics.append({k: float(v) for k, v in metrics.items()})
    counts = dict(launch_counts)
    peak = torch.cuda.max_memory_allocated()

    expected = {k: steps * per_step.get(k, 0) for k in counts}
    if counts != expected:
        raise AssertionError(f"{name}: launch counts {counts} over {steps} steps, expected {expected}")
    for i, m in enumerate(all_metrics):
        bad = {k: v for k, v in m.items() if not math.isfinite(v)}
        if bad:
            raise AssertionError(f"{name} step {i}: non-finite metrics {bad}")
    moved = sum(float((p.detach() - b).abs().sum()) for p, b in zip(model.parameters(), before))
    del before
    if not moved > 0:
        raise AssertionError(f"{name}: the parameters did not move")
    if state.step != steps or (state.ema is not None and state.ema.step != steps):
        raise AssertionError(f"{name}: step counters {state.step} != {steps}")
    timed = seconds[1:]
    med = statistics.median(timed)
    print(f"main path {name} ({n_params} params): warm-up {seconds[0]:.3f} s, "
          f"steps {[round(t, 4) for t in timed]} s, median {med:.4f} s = "
          f"{images_per_step / med:.2f} img/s, peak memory {peak / 2**30:.2f} GiB, "
          f"launches {counts}")
    print(f"main path {name} metrics (last step): " + json.dumps(all_metrics[-1], sort_keys=True))
    return counts


def phase_main_path(torch):
    from siss_tpu_torch.profile_step import MAIN_ACCUM, MAIN_MB, make_main_path

    return drive_path(torch, f"celebahq_256 bs {MAIN_MB} x accum {MAIN_ACCUM}", make_main_path,
                      4, {"siss_reduce": MAIN_ACCUM, "siss_bwd": 2 * MAIN_ACCUM},
                      MAIN_MB * MAIN_ACCUM)


def phase_sd_path(torch):
    from siss_tpu_torch.profile_step import SD_ACCUM, SD_MB, make_sd_path

    # Per microbatch: 10 flash self-attention sites in the forward (5 at
    # 64×64 latents, 5 at 32×32), each differentiated by both pulls.
    per_step = {"flash_fwd": 10 * SD_ACCUM, "flash_bwd_dkv": 20 * SD_ACCUM,
                "flash_bwd_dq": 20 * SD_ACCUM, "siss_reduce": SD_ACCUM, "siss_bwd": 2 * SD_ACCUM}
    return drive_path(torch, f"sd_v1 flash bs {SD_MB} x accum {SD_ACCUM}", make_sd_path, 3,
                      per_step, SD_MB * SD_ACCUM)


CELEB_WORK = ROOT / "build" / "chip_smoke_celeb"
CELEB_IMAGES, CELEB_SIZE, CELEB_STEPS = 64, 256, 3
# FID at steps 0 and 3 over 16 samples (the random-projection embedder: the
# repository holds no InceptionV3 weights), membership at t = 250 on every
# evaluation; the shipped config leaves both off.
CELEB_METRICS_ON = (
    "metrics.fid={step_frequency: 3, num_imgs_to_generate: 16, batch_size: 8, "
    "class_cfg: {inception_batch_size: 16}}",
    "metrics.membership_loss={step_frequency: 1, timesteps: [250], class_cfg: "
    "{num_image_samples: 8, num_noise_samples: 4, eval_batch_size: 32}}",
)
CELEB_STEP_KEYS = ("loss_x/mean", "importance_weight_x/mean", "gradient/scaling_factor",
                   "images_per_sec")
CELEB_EVAL_KEYS = ("Sampled Images/files", "Target Image Generations (t=250)/files",
                   "membership_loss/all_membership_loss_t=250",
                   "membership_loss/deletion_membership_loss_t=250",
                   "membership_loss/membership_ratio_t=250")
TOWER_GOLDENS = ROOT / "tests" / "tower_goldens.py"
INCEPTION_GOLDEN = ROOT / "tests" / "goldens" / "inception_fid_golden.npz"
INCEPTION_BATCH = 64


def write_image_folder(root: Path, n: int, size: int) -> None:
    """``n`` random size² RGB JPEGs named 10000.jpg, 10001.jpg, …"""
    import numpy as np
    from PIL import Image

    root.mkdir(parents=True)
    rng = np.random.default_rng(0)
    for i in range(n):
        Image.fromarray(rng.integers(0, 256, (size, size, 3), dtype=np.uint8)).save(
            root / f"{10000 + i}.jpg")


def phase_celeb_task(torch, card):
    """The shipped delete_celeb config through the port's command line at
    full width for 3 steps, with FID and membership turned on."""
    import shutil

    from siss_tpu_torch import main as cli
    from siss_tpu_torch.ops import launch_counts, reset_launch_counts

    shutil.rmtree(CELEB_WORK, ignore_errors=True)
    write_image_folder(CELEB_WORK / "data", CELEB_IMAGES, CELEB_SIZE)
    reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    (task,) = cli.main(["--config-name=delete_celeb", f"data_dir={CELEB_WORK / 'data'}",
                        f"output_dir={CELEB_WORK / 'out'}",
                        f"checkpoint_path={CELEB_WORK / 'no_weights'}",
                        f"training_steps={CELEB_STEPS}", *CELEB_METRICS_ON])
    seconds = time.perf_counter() - t0
    counts = dict(launch_counts)
    peak = torch.cuda.max_memory_allocated()
    accum, bs = int(task.cfg.gradient_accumulation_steps), int(task.cfg.train_batch_size)
    expected = {k: 0 for k in counts} | {"siss_reduce": CELEB_STEPS * accum,
                                         "siss_bwd": 2 * CELEB_STEPS * accum}
    if counts != expected:
        raise AssertionError(f"celeb task: launch counts {counts}, expected {expected}")

    with open(Path(str(task.cfg.output_dir)) / "metrics.jsonl") as f:
        rows = [json.loads(line) for line in f]
    bad = {(r["_step"], k): v for r in rows for k, v in r.items()
           if isinstance(v, (int, float)) and not math.isfinite(v)}
    if bad:
        raise AssertionError(f"celeb task: non-finite metrics {bad}")
    steps = [r for r in rows if "loss_x/mean" in r]
    if ([r["_step"] for r in steps] != list(range(1, CELEB_STEPS + 1))
            or any(k not in r for r in steps for k in CELEB_STEP_KEYS)
            or not all(r["gradient/scaling_factor"] > 0 for r in steps)):
        raise AssertionError(f"celeb task: step rows {steps}, expected {CELEB_STEP_KEYS} "
                             f"(scaling factor > 0) at steps 1–{CELEB_STEPS}")
    for key in CELEB_EVAL_KEYS:
        if [r["_step"] for r in rows if key in r] != list(range(CELEB_STEPS + 1)):
            raise AssertionError(f"celeb task: {key} not logged once at each of steps "
                                 f"0–{CELEB_STEPS}")
    fid = [(r["_step"], r["metrics/fid_rand"]) for r in rows if "metrics/fid_rand" in r]
    if [s for s, _ in fid] != [0, CELEB_STEPS]:
        raise AssertionError(f"celeb task: metrics/fid_rand by step {fid}, expected steps 0 "
                             f"and {CELEB_STEPS}")

    med = statistics.median(task.step_seconds)
    print(f"celeb task ({card}): --config-name=delete_celeb, {CELEB_IMAGES} random "
          f"{CELEB_SIZE}² JPEGs, random weights, {CELEB_STEPS} steps of bs {bs} x accum {accum} "
          f"in {seconds:.2f} s: steps {[round(x, 4) for x in task.step_seconds]} s, median "
          f"{med:.4f} s = {bs * accum / med:.2f} img/s, peak memory {peak / 2**30:.2f} GiB, "
          f"launches {counts}")
    for rec in task.eval_records:
        parts = {k: round(v, 4) for k, v in rec.items() if k != "step"}
        print(f"celeb task evaluation at step {rec['step']} (seconds; {task.cfg.eval_batch_size} "
              f"sample of {task.cfg.pipeline.num_inference_steps} DDPM steps, injection of "
              f"{int(task.cfg.metrics.denoising_injections.timestep) + 1} calls): "
              + json.dumps(parts, sort_keys=True))
    print("celeb task last step: " + json.dumps({k: steps[-1][k] for k in CELEB_STEP_KEYS},
                                                sort_keys=True)
          + "; membership and FID: " + json.dumps(
              {f"{r['_step']} {k}": round(v, 6) for r in rows for k, v in r.items()
               if k.startswith(("membership_loss/", "metrics/fid"))}, sort_keys=True))
    inception_on_card(torch, card)


def inception_on_card(torch, card):
    """InceptionV3 (fid variant) with the golden synthetic weights against
    the recorded features, then its time at batch 64 × 299²."""
    import importlib.util

    from siss_tpu_torch.metrics.inception_v3 import (InceptionV3Features, embedding_feature_fn,
                                                     load_inception_state_dict)

    # by its path: an installed package named ``tests`` may shadow the
    # repository's directory
    spec = importlib.util.spec_from_file_location("tower_goldens", TOWER_GOLDENS)
    goldens = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(goldens)
    meta, imgs, want = goldens.load_golden(INCEPTION_GOLDEN)
    model = InceptionV3Features(variant="fid")
    load_inception_state_dict(model, goldens.synth_state_dict(meta))
    # the golden inputs are 299² in [−1, 1]: no resize, no range map
    got = embedding_feature_fn(model, batch_input_range="11", device="cuda")(imgs)
    want = torch.from_numpy(want).to(got.device)
    torch.testing.assert_close(got, want, rtol=1e-3, atol=1e-3,
                               msg=lambda m: f"InceptionV3 on the card vs golden: {m}")
    err = float((got - want).abs().max())
    x = (2 * torch.rand(INCEPTION_BATCH, 3, 299, 299, device="cuda") - 1).contiguous(
        memory_format=torch.channels_last)
    with torch.inference_mode():
        ms = statistics.median(gpu_ms(torch, lambda: model(x), launches=5, repeats=3))
    # The bound: the convolutions' operations (2 per multiply-add) at the
    # fp32 rate, counted on one image by forward hooks.
    flops = []
    hooks = [m.register_forward_hook(lambda mod, i, o: flops.append(
        2 * o.numel() * mod.in_channels * mod.kernel_size[0] * mod.kernel_size[1]))
        for m in model.modules() if isinstance(m, torch.nn.Conv2d)]
    with torch.inference_mode():
        model(x[:1])
    for h in hooks:
        h.remove()
    bound_ms = INCEPTION_BATCH * sum(flops) / H100_FP32_FLOPS * 1e3
    print(f"InceptionV3 fid ({card}): golden features max_abs_err={err:.3e} (bound 1e-3 + 1e-3 "
          f"relative); {ms:.3f} ms per batch of {INCEPTION_BATCH} at 299² "
          f"({INCEPTION_BATCH / ms * 1e3:.1f} img/s, fp32, TF32 off); bound {bound_ms:.3f} ms "
          f"({sum(flops) / 1e9:.3f} GFLOP an image at {H100_FP32_FLOPS / 1e12:.0f} TFLOP/s): "
          f"{bound_ms / ms:.1%} of it")


TSHIRT_DATA = ROOT / "data" / "datasets" / "mnist_with_tshirt.npz"
TSHIRT_WORK = ROOT / "build" / "chip_smoke_tshirt"
# The pretrain: 10 epochs of the 5,632 images at batch 128 (440 steps).
TSHIRT_PRETRAIN = ("num_epochs=10", "lr_warmup_steps=50", "sampling_steps=0")
TSHIRT_STEPS = 30
TSHIRT_KEYS = ("loss_x/mean", "importance_weight_x/mean", "gradient/scaling_factor",
               "metrics/deletion_class_fraction", "images_per_sec")
TSHIRT_PROBE_T, TSHIRT_PROBE_N = 300, 256


def tshirt_probe(torch, task, weights):
    """ε-MSE at t = 300 on the first 256 forget and the first 256 keep
    images, with one fixed noise draw, for each state dict of ``weights``:
    {name: (forget MSE, keep MSE)}."""
    import numpy as np

    from siss_tpu_torch.data import LabeledImageDataset
    from siss_tpu_torch.diffusion import q_sample
    from siss_tpu_torch.train import unet_eps_apply

    model, _ = task.build_unet()
    schedule = task.build_schedule()
    gen = torch.Generator(device=task.device).manual_seed(300)
    sets = []
    for filt in ("deletion", "nondeletion"):
        ds = LabeledImageDataset.from_npz(filt, str(TSHIRT_DATA), class_to_remove=10)
        x0 = torch.from_numpy(np.stack([ds[i] for i in range(TSHIRT_PROBE_N)])).to(task.device)
        sets.append((x0, torch.randn(x0.shape, generator=gen, device=task.device)))
    t = torch.full((TSHIRT_PROBE_N,), TSHIRT_PROBE_T, device=task.device)
    out = {}
    with torch.inference_mode():
        for name, sd in weights.items():
            model.load_state_dict(sd)
            out[name] = tuple(float(((unet_eps_apply(model, q_sample(schedule, x0, noise, t), t,
                                                     None) - noise) ** 2).mean())
                              for x0, noise in sets)
    return out


def tshirt_rows(task):
    """The run's metrics.jsonl rows; fails on a non-finite number."""
    with open(Path(str(task.cfg.output_dir)) / "metrics.jsonl") as f:
        rows = [json.loads(line) for line in f]
    bad = {(r["_step"], k): v for r in rows for k, v in r.items()
           if isinstance(v, (int, float)) and not math.isfinite(v)}
    if bad:
        raise AssertionError(f"t-shirt {task.cfg.deletion.loss_fn}: non-finite metrics {bad}")
    return rows


def delete_tshirt(cli, base, out, *extra):
    """One t-shirt unlearning run through the command line at the full
    mnist_tshirt width and batch 64, from the pretrain bundle ``base``."""
    (task,) = cli.main(["--config-name=delete_tshirt", f"checkpoint_path={base}/latest",
                        f"output_dir={out}", f"dataset.path={TSHIRT_DATA}",
                        f"dataset_all.path={TSHIRT_DATA}", f"dataset_deletion.path={TSHIRT_DATA}",
                        "train_batch_size=64", *extra])
    return task


def phase_tshirt(torch, card):
    """The t-shirt task through the port's command line on the card: the
    full-width mnist_tshirt pretrain, then 30 SISS unlearning steps from its
    latest bundle with the shipped metrics block (the likelihood at steps 0
    and 30), then the selectivity probe. Returns the pretrain bundle's
    directory and SISS's (forget, keep) probe ratios."""
    import shutil

    from siss_tpu_torch import main as cli
    from siss_tpu_torch.ops import launch_counts, reset_launch_counts
    from siss_tpu_torch.utils import CheckpointManager

    shutil.rmtree(TSHIRT_WORK, ignore_errors=True)
    torch.cuda.reset_peak_memory_stats()
    (pre,) = cli.main(["--config-name=train_tshirt_mnist", f"dataset.path={TSHIRT_DATA}",
                       f"output_dir={TSHIRT_WORK / 'base'}", *TSHIRT_PRETRAIN])
    pre_peak = torch.cuda.max_memory_allocated()
    base = Path(str(pre.cfg.output_dir))
    latest = CheckpointManager(str(base)).latest()
    if latest is None or not {"state", "unet", "unet_ema"} <= {p.name for p in Path(latest).iterdir()}:
        raise AssertionError(f"the pretrain wrote no state/unet/unet_ema bundle under {base}")

    reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    dele = delete_tshirt(cli, base, TSHIRT_WORK / "deletion", f"training_steps={TSHIRT_STEPS}",
                         "deletion.loss_fn=importance_sampling_with_mixture",
                         "deletion.scaling_norm=5", "sampling_steps=10", "eval_images=128",
                         "pipeline.num_inference_steps=50")
    counts = dict(launch_counts)
    del_peak = torch.cuda.max_memory_allocated()
    expected = {k: 0 for k in counts} | {"siss_reduce": TSHIRT_STEPS, "siss_bwd": 2 * TSHIRT_STEPS}
    if counts != expected:
        raise AssertionError(f"t-shirt unlearning: launch counts {counts}, expected {expected}")

    rows = tshirt_rows(dele)
    keys = set().union(*map(set, rows))
    if missing := [k for k in TSHIRT_KEYS if k not in keys]:
        raise AssertionError(f"t-shirt metrics.jsonl lacks {missing}")
    scaling = [r["gradient/scaling_factor"] for r in rows if "gradient/scaling_factor" in r]
    if len(scaling) != TSHIRT_STEPS or not all(s > 0 for s in scaling):
        raise AssertionError(f"t-shirt: gradient/scaling_factor {scaling}")
    fractions = [(r["_step"], r["metrics/deletion_class_fraction"]) for r in rows
                 if "metrics/deletion_class_fraction" in r]
    likelihood = [(r["_step"], r["metrics/likelihood"]) for r in rows if "metrics/likelihood" in r]
    if [s for s, _ in likelihood] != [0, TSHIRT_STEPS] or not all(v > 0 for _, v in likelihood):
        raise AssertionError(f"t-shirt: metrics/likelihood by step {likelihood}, expected a "
                             f"positive value at steps 0 and {TSHIRT_STEPS}")

    mgr = CheckpointManager(str(base))
    probe = tshirt_probe(torch, dele, {
        "pretrain unet_ema": mgr.restore_item("latest", "unet_ema"),
        "unlearned": CheckpointManager(str(dele.cfg.output_dir)).restore_item("latest", "unet")})
    (f0, k0), (f1, k1) = probe["pretrain unet_ema"], probe["unlearned"]
    forget_ratio, keep_ratio = f1 / f0, k1 / k0
    pre_med, del_med = statistics.median(pre.step_seconds), statistics.median(dele.step_seconds)
    print(f"t-shirt ({card}): pretrain {len(pre.step_seconds)} steps at batch "
          f"{pre.cfg.train_batch_size}: median {pre_med * 1e3:.3f} ms = "
          f"{int(pre.cfg.train_batch_size) / pre_med:.1f} img/s, peak memory "
          f"{pre_peak / 2**30:.3f} GiB; unlearning {len(dele.step_seconds)} steps at batch "
          f"{dele.cfg.train_batch_size}: median {del_med * 1e3:.3f} ms = "
          f"{int(dele.cfg.train_batch_size) / del_med:.1f} img/s, peak memory "
          f"{del_peak / 2**30:.3f} GiB, launches {counts}")
    print(f"t-shirt evaluations ({dele.cfg.eval_images} images, "
          f"{dele.cfg.pipeline.num_inference_steps}-step DDPM): seconds "
          f"{[round(x, 4) for x in dele.eval_seconds]}, deletion_class_fraction by step {fractions}")
    for run in dele.likelihood_runs:
        print(f"t-shirt likelihood (RK45, rtol = atol = 1e-5, one forget image) at step "
              f"{run['step']}: {run['bpd']:.4f} bits/dim in {run['seconds']:.3f} s, nfe "
              f"{run['nfe']} ({run['nfe'] // 6} steps, {7 * (run['nfe'] // 6)} ε-model calls)")
    print(f"t-shirt probe (ε-MSE at t = {TSHIRT_PROBE_T}, {TSHIRT_PROBE_N} images each): forget "
          f"{f0:.6f} → {f1:.6f} (ratio {forget_ratio:.4f}), keep {k0:.6f} → {k1:.6f} "
          f"(ratio {keep_ratio:.4f}); last step's metrics "
          + json.dumps({k: v for k, v in [r for r in rows if "loss_x/mean" in r][-1].items()
                        if k in TSHIRT_KEYS}, sort_keys=True))
    if not forget_ratio > keep_ratio:
        raise AssertionError(f"t-shirt: the forget-set ε-MSE ratio {forget_ratio:.4f} is not "
                             f"above the keep-set ratio {keep_ratio:.4f}")
    return base, (forget_ratio, keep_ratio)


# (label, deletion.loss_fn, overrides): the five other objectives, then SISS
# off its fused path. The shipped config has no superfactor, which NegGrad
# needs.
TSHIRT_OBJECTIVES = (
    ("double_forward_with_neg_del", "double_forward_with_neg_del", ()),
    ("erasediff", "erasediff", ()),
    ("simple_neg_del", "simple_neg_del",
     ("+deletion.loss_params.superfactor=1.0", "deletion.superfactor_decay=0.99")),
    ("naive_del", "naive_del", ()),
    ("subscore_bernoulli", "subscore_bernoulli", ()),
    ("siss_unfused", "importance_sampling_with_mixture", ("+deletion.fused_siss=false",)),
)
SCALAR_OBJECTIVES = ("simple_neg_del", "naive_del")
# SISS's probe ratios as PERF.md §6 records them for this card, printed for
# reference.
SISS_RATIOS_RECORDED = (1.9161, 0.9852)
# The unfused SISS step makes the fused one's draws and, but for the order
# of its sums, its arithmetic: its probe ratios must land this close.
UNFUSED_RATIO_RTOL = 0.05


def phase_tshirt_objectives(torch, card, base, siss_ratios):
    """Each other objective, and SISS unfused, for 30 steps at batch 64 from
    the pretrain bundle, evaluations off: finite metrics, the surgery
    objectives' scaling factor (> 0; ≤ 0 for EraseDiff) and none on the
    scalar ones, no SISS kernel launch, and the probe ratios."""
    from siss_tpu_torch import main as cli
    from siss_tpu_torch.ops import launch_counts, reset_launch_counts
    from siss_tpu_torch.utils import CheckpointManager

    weights, report = {}, {}
    for label, name, extra in TSHIRT_OBJECTIVES:
        reset_launch_counts()
        task = delete_tshirt(cli, base, TSHIRT_WORK / label, f"training_steps={TSHIRT_STEPS}",
                             f"deletion.loss_fn={name}", "sampling_steps=0",
                             "metrics.likelihood=null", *extra)
        counts = dict(launch_counts)
        if any(counts.values()):
            raise AssertionError(f"t-shirt {label}: launch counts {counts}, expected none")
        rows = [r for r in tshirt_rows(task) if "gradient/pre_clip_norm" in r]
        if len(rows) != TSHIRT_STEPS:
            raise AssertionError(f"t-shirt {label}: {len(rows)} step rows")
        scaling = [r.get("gradient/scaling_factor") for r in rows]
        if name in SCALAR_OBJECTIVES:
            ok = all(s is None for s in scaling)
        elif name == "erasediff":
            ok = all(s is not None and s <= 0 for s in scaling)
        else:
            ok = all(s is not None and s > 0 for s in scaling)
        if not ok:
            raise AssertionError(f"t-shirt {label}: gradient/scaling_factor {scaling}")
        weights[label] = CheckpointManager(str(task.cfg.output_dir)).restore_item("latest", "unet")
        med = statistics.median(task.step_seconds)
        report[label] = {"median_ms": med * 1e3, "img_per_s": int(task.cfg.train_batch_size) / med,
                         "last": {k: v for k, v in rows[-1].items() if not k.startswith("_")}}

    probe = tshirt_probe(torch, task, {"pretrain unet_ema": CheckpointManager(str(base))
                                       .restore_item("latest", "unet_ema"), **weights})
    f0, k0 = probe.pop("pretrain unet_ema")
    print(f"t-shirt objectives ({card}), {TSHIRT_STEPS} steps at batch "
          f"{task.cfg.train_batch_size} each; probe ratios (ε-MSE at t = "
          f"{TSHIRT_PROBE_T}) beside fused SISS's {siss_ratios[0]:.4f} / {siss_ratios[1]:.4f} "
          f"in phase 6 and {SISS_RATIOS_RECORDED[0]} / {SISS_RATIOS_RECORDED[1]} in PERF.md:")
    for label, (f1, k1) in probe.items():
        r = report[label]
        r["forget_ratio"], r["keep_ratio"] = f1 / f0, k1 / k0
        print(f"  {label}: median {r['median_ms']:.3f} ms = {r['img_per_s']:.1f} img/s, forget "
              f"ratio {r['forget_ratio']:.4f}, keep ratio {r['keep_ratio']:.4f}; last step "
              + json.dumps(r["last"], sort_keys=True))
    unfused = report["siss_unfused"]
    for got, want, what in ((unfused["forget_ratio"], siss_ratios[0], "forget"),
                            (unfused["keep_ratio"], siss_ratios[1], "keep")):
        if not abs(got - want) <= UNFUSED_RATIO_RTOL * want:
            raise AssertionError(f"t-shirt: unfused SISS's {what} ratio {got:.4f} is not within "
                                 f"{UNFUSED_RATIO_RTOL:.0%} of the fused run's {want:.4f}")


CLASSIFIER_STEPS = 10
# Membership and IS as the JAX task reads them (siss_tpu/tasks/delete_tshirt.py:
# 127-163, 188-201); the shipped config leaves both off.
TSHIRT_METRICS_ON = (
    "metrics.inception_score={step_frequency: 5, num_imgs_to_generate: 512, batch_size: 128}",
    "metrics.membership_loss={step_frequency: 5, timesteps: [100, 300, 500], class_cfg: "
    "{num_image_samples: 64, num_noise_samples: 16, eval_batch_size: 512}}",
    "metrics.classifier_cfg.classifier_args.num_classes=11",
)


def phase_classifier(torch, card, base):
    """``--config-name=train_classifier`` as shipped, then 10 t-shirt steps
    with the Inception Score over its checkpoint and the membership losses."""
    from siss_tpu_torch import main as cli
    from siss_tpu_torch.ops import launch_counts, reset_launch_counts

    t0 = time.perf_counter()
    (clf,) = cli.main(["--config-name=train_classifier", f"dataset.path={TSHIRT_DATA}",
                       f"output_dir={TSHIRT_WORK / 'classifier'}"])
    seconds = time.perf_counter() - t0
    with open(Path(str(clf.cfg.output_dir)) / "metrics.jsonl") as f:
        rows = [json.loads(line) for line in f]
    acc = rows[-1]["final_accuracy"]
    print(f"classifier ({card}): resnet18, {clf.cfg.num_classes} classes, "
          f"{len(clf.step_seconds)} steps at batch {clf.cfg.train_batch_size} in {seconds:.2f} s "
          f"(steps {sum(clf.step_seconds):.2f} s, median {statistics.median(clf.step_seconds) * 1e3:.3f} "
          f"ms), final batch accuracy {acc:.4f}; accuracy by step "
          + json.dumps([(r["_step"], round(r.get("accuracy", r.get("final_accuracy")), 4))
                        for r in rows]))
    if not acc > 0.9:
        raise AssertionError(f"classifier: final accuracy {acc}")

    reset_launch_counts()
    task = delete_tshirt(cli, base, TSHIRT_WORK / "metrics", f"training_steps={CLASSIFIER_STEPS}",
                         "sampling_steps=5", "metrics.likelihood=null", *TSHIRT_METRICS_ON,
                         f"metrics.classifier_cfg.classifier_ckpt={clf.cfg.output_dir}")
    counts = dict(launch_counts)
    expected = {k: 0 for k in counts} | {"siss_reduce": CLASSIFIER_STEPS,
                                         "siss_bwd": 2 * CLASSIFIER_STEPS}
    if counts != expected:
        raise AssertionError(f"t-shirt metrics run: launch counts {counts}, expected {expected}")
    keys = ["metrics/is_mean", "metrics/is_std"] + [
        f"membership_loss/{k}_t={t}" for t in (100, 300, 500) for k in ("all", "deletion", "ratio")]
    evals = [r for r in tshirt_rows(task) if "metrics/deletion_class_fraction" in r]
    if [r["_step"] for r in evals] != [0, 5, 10] or any(k not in r for r in evals for k in keys):
        raise AssertionError(f"t-shirt metrics run: evaluations {evals}, expected {keys} "
                             "at steps 0, 5 and 10")
    for r in evals:
        print(f"t-shirt IS and membership ({card}) at step {r['_step']}: "
              + json.dumps({k: round(r[k], 6) for k in keys}))


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
    check_ptxas(info["log"])
    check_tensor_core_sass(info["path"])

    record = phase_kernels(torch)
    record.update(phase_flash_kernels(torch))
    fp32_counts = phase_tiny_step_parity(torch)
    base, siss_ratios = phase_tshirt(torch, card)
    phase_tshirt_objectives(torch, card, base, siss_ratios)
    phase_classifier(torch, card, base)
    celeb_counts = phase_main_path(torch)
    phase_celeb_task(torch, card)
    sd_counts = phase_sd_path(torch)

    # Launches: the SISS kernels' from the celeb path, the bf16 flash
    # kernels' from the SD path (the SISS kernels' SD counts are printed
    # above), the fp32 flash kernels' from the tiny SD step in fp32 on the
    # card.
    counts = {**celeb_counts, **{k: sd_counts[k] for k in FLASH_OPS},
              **{f"{k}_fp32": fp32_counts[k] for k in FLASH_OPS}}
    sources = {"siss_reduce": ("siss_tpu_torch/ops/csrc/siss_reduce.cu", "siss_tpu/ops/siss_pallas.py:55"),
               "siss_bwd": ("siss_tpu_torch/ops/csrc/siss_bwd.cu", "siss_tpu/ops/siss_pallas.py:120"),
               "flash_fwd": ("siss_tpu_torch/ops/csrc/flash_fwd_sm90.cu", "jax/experimental/pallas/ops/tpu/flash_attention.py:331"),
               "flash_fwd_fp32": ("siss_tpu_torch/ops/csrc/flash_fwd_tf32x3.cu", "jax/experimental/pallas/ops/tpu/flash_attention.py:331"),
               "flash_bwd_dkv": ("siss_tpu_torch/ops/csrc/flash_bwd_dkv_sm90.cu", "jax/experimental/pallas/ops/tpu/flash_attention.py:796"),
               "flash_bwd_dkv_fp32": ("siss_tpu_torch/ops/csrc/flash_bwd_dkv_tf32x3.cu", "jax/experimental/pallas/ops/tpu/flash_attention.py:796"),
               "flash_bwd_dq": ("siss_tpu_torch/ops/csrc/flash_bwd_dq_sm90.cu", "jax/experimental/pallas/ops/tpu/flash_attention.py:1146"),
               "flash_bwd_dq_fp32": ("siss_tpu_torch/ops/csrc/flash_bwd_dq_tf32x3.cu", "jax/experimental/pallas/ops/tpu/flash_attention.py:1146")}
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
