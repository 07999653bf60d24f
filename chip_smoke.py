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
   shipped celeb task's microbatch [4, 256, 256, 3] and each rank's
   microbatch of phase 9, [8, 256, 256, 3], with the same data in fp32 and
   bf16, the SD
   step's shape [1, 64, 64, 4] fp32 with the SD schedule's t = 999 (one
   row split into 8 chunks), the t-shirt step's [64, 28, 28, 1] fp32 with
   t ~ U{0..999}, and ragged shapes (28×28×1, and 15×15×3, whose row
   length takes the one-element-per-load path). The reduce runs twice and
   must repeat bit for bit. Then time kernel and plain version at the
   celeb, celeb task, SD and t-shirt shapes, and an empty kernel launched
   the same way (the launch floor, for 1 and 2 launches).
4. Hold the three flash-attention kernels (forward, dK/dV, dQ) against
   their plain versions on the card: o, lse, dq, dk and dv at the SD
   shapes (B, H, N, d) = (1, 8, 4096, 40) and (1, 8, 1024, 80), at the
   SD validation's batch-2 CFG shapes (2, 8, 4096, 40) and (2, 8, 1024, 80),
   and at (2, 4, 256, 8), (1, 2, 128, 128), (1, 2, 128, 24) (d padded to 40),
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
   ``configs/delete_tshirt.yaml``): pretrain 4 epochs of the repository's
   5,632 images at batch 128 (176 steps), check the checkpoint bundle, then
   30 SISS unlearning steps at batch 64 from its ``latest`` with 50-step
   DDPM evaluations of 128 images every 10 steps and the shipped metrics
   block, the likelihood's frequency cut from 30 steps to once: the exact
   likelihood (RK45) must log a finite, positive ``metrics/likelihood`` at
   step 0, each evaluation's
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
   random 256² JPEGs, random weights, 1 step, with FID (16 samples, the
   random-projection embedder: ``metrics/fid_rand``) at steps 0 and 1 and
   membership at t = 250 on every evaluation. It must launch the reduce 16
   and the SISS backward 32 times and log finite step metrics, both panels
   and the membership keys at steps 0–1. Then InceptionV3 (``fid``
   variant) on the card with the golden synthetic weights
   (``tests/goldens/inception_fid_golden.npz``, TF32 off) must give the
   recorded features within 1e-3, and is timed at batch 64 × 299².
7c. Serving and diffusers model directories on 7b's final bundle
   (celebahq_256, 113,673,219 parameters), copied with a stand-in
   ``unet_ema`` (its ``unet`` plus 2⁻¹⁰: the shipped config keeps no EMA):
   (a) ``export_bundle_to_diffusers``
   writes ``unet/`` and ``unet_ema/`` (``config.json`` and an fp32
   ``diffusion_pytorch_model.bin``), each imported back by
   ``import_hf_unet`` into a fresh UNet equal bit for bit to the bundle's
   tensors; (b) the exported ``unet`` renamed to the pre-0.18 attention
   names (google/ddpm-celebahq-256's ``query``/``key``/``value``/
   ``proj_attn``, the mid-block's q, k and v as [O, I, 1]) loads through
   ``convert_unet2d`` bit for bit, and with one extra tensor raises; (c)
   a ``SamplerService`` on the bundle in bf16 on the card behind a
   ``ThreadingHTTPServer`` on 127.0.0.1: ``/healthz``, ``POST /sample``
   of 4 images by 50 DDPM and by 25 DPM-Solver++ steps sent at once from
   two threads, each again with its seed (the same PNG bytes), both keys
   listed by ``/healthz``, 400 on a malformed body, and each served grid
   equal to the port's sampler called directly with that seed on the same
   weights, cuDNN deterministic. It prints each request's seconds (its
   key's first, cold, and again, warm), images/s, peak memory, the five kernel
   families' launches (all 0: the served UNet runs cuDNN, GroupNorm and the
   plain attention) and the bytes written (``/proc/self/io``).
8. The SD main path at full width (``profile_step.make_sd_path``, the
   ``configs/delete_sd.yaml`` step of ``bench.py --workload sd`` with
   ``attention_impl="flash"``): the sd_v1 UNet, microbatch 1 × 16
   accumulation steps; 1 warm-up and 1 timed step. Each step must launch
   flash_fwd 160, flash_bwd_dkv 320, flash_bwd_dq 320, siss_reduce 16 and
   siss_bwd 32 times.
8b. The SD task through ``siss_tpu_torch.main`` at full width
   (``configs/delete_sd.yaml``: the sd_v1 UNet, the SD-1 VAE and the CLIP
   ViT-L/14 text tower, resolution 512, bs 1 × 16, bf16, the latent cache
   on ``auto``, ``random_flip``, a validation every step: CFG DDIM at
   guidance 7.5 with noise norms, its 50 steps cut to 15) with
   ``attention_impl=flash``, 1 step and ``eval_batches=1``, on 16 random 512² PNGs under
   ``build/chip_smoke_sd/`` with their side files, two prompt files and a
   synthetic byte-level CLIP vocabulary (random weights: the pretrained
   directory holds only ``tokenizer/``); then 1 step from a fresh output
   directory with ``cache_latents=false`` (the VAE encodes in the step).
   Each run must launch siss_reduce 16, siss_bwd 32, flash_bwd_dkv and
   flash_bwd_dq 320 times a step, and flash_fwd 160 a step plus 10 a CFG
   UNet call; log finite step metrics at image count 16, both
   prompts' panels and noise-norm line series at every validation (one
   curve more each time) and read ``frac_deletion`` = 1/16. It prints the
   set-up, step and validation seconds, peak memory and each run's
   launches on a line of their own, then times the VAE encode and decode
   of one 512² image and the CLIP text tower on one prompt beside the
   bound of their convolution and matmul operations at the bf16 rate.
8c. The SD config's other options at full width. (b) Phase 8's sd_v1 step
   (1 × 16) on one built UNet: 1 step with the default knobs; 1 + 1 with
   the memory mode (bf16 Adam moments, accumulators and a bf16 copy of
   the params a step), whose peak memory must be at least 4 GiB under the
   default's; one microbatch's gradients by one batched pull against two
   pulls through the kernels with ``remat_policy=dots``, both against the
   fp32 gradients (the batched pull's largest and RMS error in each tensor
   at most twice the two pulls', plus 2⁻¹⁶ of its largest |g|); then 1 + 1
   steps with ``batched_dual_backward``. Each part must launch its kernels
   exactly (the batched pull launches each flash backward kernel once a
   site, the seeds folded into its batch). (a) ``--config-name=delete_sd``
   on the Adafactor fast path the config documents (bs 2 × 8, bf16
   accumulators, no recomputation), ``attention_impl=flash``, 1 step,
   with ``metrics.fraction_deletion``, ``sscd`` and ``clip_iqa`` on
   synthetic artifacts written under ``build/chip_smoke_sd/metric_files``
   (k-means centers, a TorchScript embedder, a random full-width ViT-L/14
   vision state dict and anchors): the launches of 8b's rule, finite
   metric values under the JAX task's keys (read from
   ``siss_tpu/tasks/delete_sd.py``) at every validation, each metric's
   seconds printed; then the ViT-L/14 on one 224² image in fp32 beside
   its bound. The tiny SD step of phase 5 also runs card against CPU
   with ``noise_offset`` and ``input_perturbation``, launching no SISS
   kernel.
9. Data parallelism (``siss_tpu_torch.parallel``) on phase 7's celeb step
   at full width, 16 × 4, 1 step from one global batch and its draws:
   (a) one process without a group, in bf16 and in fp32 (TF32 off), θ
   after the step and the norms ``gradient/norm_loss_x``,
   ``gradient/norm_loss_a``, ``gradient/pre_clip_norm`` kept on the host;
   (b) the bf16 step under an NCCL group of world size 1, which must give
   (a)'s bf16 parameters and norms bit for bit; (c) after printing the
   card's compute mode (an exclusive mode fails the phase), two ranks
   sharing the card over gloo, each on its 8 rows of every microbatch:
   their parameters equal bit for bit after each step, 4 reduce and 8 SISS
   backward launches a step on each, and against (a)'s fp32 steps the
   largest and RMS errors of Δθ and the norms' largest and RMS relative
   errors at most twice (a)'s bf16 ones; each rank's step and all-reduce
   seconds and peak memory printed; (d) ``python3 -m torch.distributed.run
   --standalone --nproc_per_node 2 -m siss_tpu_torch.main
   --config-name=delete_tshirt --device cuda:0 --dist-backend gloo`` from
   phase 6's pretrain at full width, 2 steps at batch 64 with an
   evaluation of 64 images at step 0: one run directory, one tracker log
   with steps 1–2, one checkpoint; (e) the
   fsdp axis: (c) again on a ``data=1 × fsdp=2`` mesh over gloo, each
   rank holding its block of every parameter that ``fsdp_dim`` splits, of
   its AdamW moments, EMA and both accumulators: θ and the EMA gathered
   after each step equal bit for bit on the two ranks, exact launches,
   errors within (c)'s rule, each rank's held bytes exactly 9(c)'s less
   half of the split parameters' (printed with the gathered working copy
   apart), step, gather and reduce-scatter seconds and peak memory
   printed; (f) (d) with ``mesh.fsdp=2``, run beside (d): each rank prints the mesh, one
   run directory, log and checkpoint, the logged keys equal (d)'s, and one
   process loads the bundle whole (the ``unet`` item strictly, the
   ``state`` item into a TrainState); (g) the tensor axis: the celeb step
   cut to microbatch 2 × 2 accumulation steps, 2 steps from (a)'s seed, on
   a ``data=1 × tensor=2`` mesh over gloo (each rank runs its block of
   every resnet's and attention block's channels, with an all-reduce of
   each one's partial output): θ and the EMA gathered after each step and
   every whole parameter equal bit for bit on the two ranks, 2 reduce and
   4 SISS backward launches a step on each, errors against one process's
   fp32 steps on the same cut within (c)'s rule, held bytes exactly one
   process's less half of the split parameters' (parameters 256,333,836),
   step and activation all-reduce seconds and peak memory printed; (i)
   (g) again on four ranks, ``data=1 × fsdp=2 × tensor=2`` (each block of
   a split layer split once more over fsdp: one image a batch rank),
   against (g)'s own one-process steps: the same checks, parameters
   128,849,932 B a rank, each rank's gather, reduce-scatter and
   activation all-reduce seconds printed; (h) phase 8's sd_v1 step with
   flash and the SD fast path's Adafactor at microbatch 2 × 1, 2 steps,
   on ``data=1 × tensor=2``, from one seed, against one process's bf16
   and fp32 steps on the same cut and draws (each one-process step's
   norms that are exactly 0 printed beside the sets its samples came
   from): θ after the last step and every whole parameter equal on the
   two ranks, equal norms, errors against the fp32 steps within (c)'s
   rule, on each rank 10 flash forward, 20 dK/dV, 20 dQ, 1 reduce and 2
   SISS backward launches a step (the flash kernels at 4 local heads),
   1,924,824,336 parameter bytes a rank, seconds and peak memory printed;
   then the bf16 flash kernels at the local heads' shapes (2, 4, 4096,
   40) and (2, 4, 1024, 80) against their plain versions as in phase 4;
   (j) (h) again on four ranks, ``data=1 × fsdp=2 × tensor=2``, against
   the same one-process steps: the same checks and launches, 963,165,456
   parameter bytes a rank, the flash kernels at (1, 4, 4096, 40) and (1,
   4, 1024, 80). (g) runs beside (i) and (h) beside (j), six ranks on the
   one card at most, so the ranks' step seconds include the other set's
   load. Each part prints its seconds. NCCL across several cards is not
   run: the script needs one card.
   cuDNN is set deterministic for the phase.
10. The examples and the SD memorization demo through their ``main``s, on
   the card: (a) ``examples.celeb_sampler`` on 7b's bundle at the full
   celebahq_256 width, 4 samples of 50 DDPM steps (a 2 × 2 grid of 256²
   with 2-pixel padding, finite); (b) ``examples.likelihood_eval --arch
   mnist_tshirt`` on phase 6's pretrain with two t-shirts of the real npz
   as PNGs (finite bits/dim, nfe > 0); (c) ``examples.membership_curve``
   on the same at its defaults (20 timesteps × 2 finite losses; the plot
   where matplotlib is installed, else the computing function with a line
   that says the plot was not drawn and why); (d) an sd_v1 directory (8b's
   UNet bundle item linked, random VAE and CLIP text state dicts in bf16,
   8b's synthetic tokenizer), then
   ``examples.inference_time_mitigation --iters 2`` (embeddings [1, 77,
   768], finite token gradients) and ``examples.sd_inference`` at 512²,
   2 samples of 15 DDIM steps, from ``--prompt`` and from the augmented
   ``--prompt-embeds`` (finite images and noise norms); the directory is
   deleted after; (e) ``examples.sscd_score`` with a scripted
   stand-in for SSCD on two images against a target (one similarity each,
   in [−1, 1]); (f) first, before phase 6, the demo's two pretraining
   loops as ``fit`` runs them on the card (a CUDA graph after three eager
   steps) against the same loops run eagerly from the same weights and
   draws, 8 steps each: losses and parameters equal bit for bit; then
   ``sd_memorization_demo`` at its defaults, in a process of its own
   started before phase 6 and read after (a)–(e) (it needs nothing of
   the script's phases; it and phases 6–7b are host-bound; its launches
   are counted in that process): memorized
   before (``mem_fraction`` ≥ 0.9), forgotten after 100 SISS steps
   (``mem_fraction`` ≤ 0.125), the keep-prompt control at 0.0 before and
   after, 2 reduce and 4 SISS backward launches a step and no flash
   launch (the tiny UNet runs einsum attention). Every part prints its
   seconds, peak memory and launches; (a)–(e) launch no kernel.
   Each phase's seconds are printed after it, and the script's bytes
   written (``/proc/self/io``) at the end.

For each path the kernels' launch counts are set to 0 just before it and
read just after. The line before the last is the kernels' JSON record: each
kernel's launches on the path that runs it (the SISS kernels on the celeb
path, the bf16 flash kernels on the SD path of phase 8, the fp32 forward,
dK/dV and dQ, ``flash_fwd_fp32``, ``flash_bwd_dkv_fp32`` and
``flash_bwd_dq_fp32``, on phase 5's tiny SD step; phase 8b's counts are
printed on lines of their own), its times at the heaviest SD site and its error; the last line is
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
# Each rank's microbatch of the celeb main path on two ranks (phase 9).
SISS_DP_SHAPE = (8, 256, 256, 3)
# (B, H, N, d): the SD UNet's flash sites (64×64 and 32×32 latents), then
# a small head dim, the largest one, and one padded to a built head dim.
FLASH_SD_SHAPES = ((1, 8, 4096, 40), (1, 8, 1024, 80))
# The SD validation's CFG UNet calls run the forward at batch 2.
FLASH_CFG_SHAPES = ((2, 8, 4096, 40), (2, 8, 1024, 80))
FLASH_SHAPES = FLASH_SD_SHAPES + ((2, 4, 256, 8), (1, 2, 128, 128), (1, 2, 128, 24),
                                  (4, 12, 384, 40), (2, 3, 256, 40)) + FLASH_CFG_SHAPES
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
    dp = main_path_inputs(torch, celeb, SISS_DP_SHAPE, torch.float32, seed=5)
    check_kernels(torch, f"celeb per rank fp32 {list(SISS_DP_SHAPE)}", *dp, 1e-5, 1e-3)
    dp_bf = main_path_inputs(torch, celeb, SISS_DP_SHAPE, torch.bfloat16, seed=5)
    check_kernels(torch, f"celeb per rank bf16 {list(SISS_DP_SHAPE)}", *dp_bf, 1e-2, 1e-2)
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
    siss_times(torch, *dp)
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
    draws = draw_microbatch_randomness(gen, A, mb, shape, step_cfg.t_min, step_cfg.t_max, "cpu",
                                       noise_offset=step_cfg.noise_offset > 0,
                                       input_perturbation=step_cfg.input_perturbation > 0)
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
    # The SD noise knobs leave the fused SISS path, as the JAX step does.
    knobs = step_card_vs_cpu(
        torch, "tiny SD step, noise_offset and input_perturbation 0.1",
        lambda dev: build_unet_cond(cond_cfg, seed=3, device=dev), cond_unet_eps_apply,
        lambda dev: sd_noise_schedule(device=dev),
        DeletionStepConfig(scaling_norm=750.0, grad_accum_steps=2, t_min=999, t_max=1000,
                           noise_offset=0.1, input_perturbation=0.1),
        (16, 16, 4), cond=(7, cond_cfg.cross_attention_dim))
    if knobs["siss_reduce"] or knobs["siss_bwd"] or not knobs["flash_fwd"]:
        raise AssertionError(f"the noise knobs' step must launch no SISS kernel: {knobs}")
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
    # 1 warm-up and 1 timed step (2 timed until the script passed 700 s).
    return drive_path(torch, f"sd_v1 flash bs {SD_MB} x accum {SD_ACCUM}", make_sd_path, 2,
                      per_step, SD_MB * SD_ACCUM)


CELEB_WORK = ROOT / "build" / "chip_smoke_celeb"
CELEB_IMAGES, CELEB_SIZE, CELEB_STEPS = 64, 256, 1
# FID at steps 0 and 1 over 16 samples (the random-projection embedder: the
# repository holds no InceptionV3 weights), membership at t = 250 on every
# evaluation; the shipped config leaves both off.
CELEB_METRICS_ON = (
    f"metrics.fid={{step_frequency: {CELEB_STEPS}, num_imgs_to_generate: 16, batch_size: 8, "
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
    full width for CELEB_STEPS steps, with FID and membership turned on;
    returns the run's final bundle."""
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
    bundle = Path(str(task.cfg.output_dir)) / f"checkpoint-{CELEB_STEPS}"
    if not (bundle / "unet" / "item.pt").is_file():
        raise AssertionError(f"celeb task: no final bundle at {bundle}")
    return bundle


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


CELEB_PARAMS = 113_673_219    # UNet2DConfig.celebahq_256()'s parameters
# Phase 7c's requests: (body, seed of its repeat); sent at once, then each
# again with its seed.
SERVE_REQUESTS = ({"n": 4, "steps": 50, "sampler": "ddpm", "seed": 7},
                  {"n": 4, "steps": 25, "sampler": "dpm", "seed": 8})
LEGACY_ATTENTION = {".to_q.": ".query.", ".to_k.": ".key.", ".to_v.": ".value.",
                    ".to_out.0.": ".proj_attn."}


def io_written() -> dict:
    """This process's ``/proc/self/io`` write counts: ``wchar`` (bytes passed
    to write calls) and ``write_bytes`` (bytes the storage layer accounted
    to it)."""
    with open("/proc/self/io") as f:
        fields = dict(line.split(":") for line in f if line.strip())
    return {k: int(fields[k]) for k in ("wchar", "write_bytes")}


def legacy_names(sd: dict) -> dict:
    """A diffusers ≥ 0.18 state dict under google/ddpm-celebahq-256's
    pre-0.18 attention names, the mid-block's q, k and v as [O, I, 1]."""
    out = {}
    for k, v in sd.items():
        for new, old in LEGACY_ATTENTION.items():
            k = k.replace(new, old)
        if k.startswith("mid_block.attentions.") and k.endswith(
                (".query.weight", ".key.weight", ".value.weight")):
            v = v[:, :, None]
        out[k] = v
    return out


def assert_same_tensors(torch, label: str, got: dict, want: dict) -> None:
    """The same keys, and under each the same dtype, shape and values."""
    if sorted(got) != sorted(want):
        raise AssertionError(f"{label}: keys differ: {sorted(set(got) ^ set(want))[:6]}")
    bad = [k for k, v in want.items() if got[k].dtype != v.dtype or not torch.equal(got[k], v)]
    if bad:
        raise AssertionError(f"{label}: {len(bad)} tensors differ, e.g. {bad[:4]}")


def http(url: str, body: bytes = None):
    """(status, bytes, seconds) of a GET, or of a POST of ``body``."""
    import urllib.error
    import urllib.request

    req = urllib.request.Request(url, data=body, headers={"Content-Type": "application/json"})
    t0 = time.perf_counter()
    try:
        with urllib.request.urlopen(req, timeout=600) as r:
            return r.status, r.read(), time.perf_counter() - t0
    except urllib.error.HTTPError as e:
        return e.code, e.read(), time.perf_counter() - t0


def phase_serve(torch, card, bundle: Path):
    """7c: phase 7b's final bundle, with a stand-in EMA, exported to
    diffusers directories and imported back, under the legacy names too,
    then served over HTTP."""
    import io
    import shutil
    import threading
    from http.server import ThreadingHTTPServer

    import numpy as np
    from PIL import Image

    from siss_tpu_torch.diffusion.sampling import sample_ddpm, sample_dpm_solver_2m
    from siss_tpu_torch.evaluate import Evaluator
    from siss_tpu_torch.models import UNet2D, UNet2DConfig
    from siss_tpu_torch.ops import launch_counts, reset_launch_counts
    from siss_tpu_torch.serve import SamplerService, make_handler
    from siss_tpu_torch.train import unet_eps_apply
    from siss_tpu_torch.utils import CheckpointManager
    from siss_tpu_torch.utils.export import export_bundle_to_diffusers
    from siss_tpu_torch.utils.hf_convert import (convert_unet2d, import_hf_unet,
                                                 load_torch_state_dict)

    written0 = io_written()
    torch.backends.cudnn.deterministic = True
    unet = torch.load(bundle / "unet" / "item.pt", map_location="cpu", weights_only=True)
    ema = {k: v + 2.0 ** -10 if v.is_floating_point() else v for k, v in unet.items()}
    bundle = Path(CheckpointManager(str(bundle.parent / "with_ema")).save_bundle(
        int(bundle.name.split("-")[-1]), {"unet": unet, "unet_ema": ema}))
    del unet, ema
    ucfg = UNet2DConfig.celebahq_256()

    def fresh():
        with torch.device("meta"):
            model = UNet2D(ucfg)
        return model.to_empty(device="cpu")

    # (a) both items to diffusers directories, each imported back
    out = bundle.parent / "exported"
    shutil.rmtree(out, ignore_errors=True)
    t0 = time.perf_counter()
    dirs = export_bundle_to_diffusers(str(bundle), ucfg, str(out))
    export_s = time.perf_counter() - t0
    if sorted(dirs) != ["unet", "unet_ema"]:
        raise AssertionError(f"serve (a): exported {sorted(dirs)}, expected unet and unet_ema")
    items = {}
    t0 = time.perf_counter()
    for item, path in dirs.items():
        items[item] = torch.load(bundle / item / "item.pt", map_location="cpu", weights_only=True)
        model = import_hf_unet(path, fresh())
        n = sum(p.numel() for p in model.parameters())
        if n != CELEB_PARAMS:
            raise AssertionError(f"serve (a): {item} has {n:,} parameters, expected "
                                 f"{CELEB_PARAMS:,}")
        assert_same_tensors(torch, f"serve (a): {item} imported back", model.state_dict(),
                            items[item])
    import_s = time.perf_counter() - t0
    if all(torch.equal(v, items["unet_ema"][k]) for k, v in items["unet"].items()):
        raise AssertionError("serve (a): unet and unet_ema are equal: the export is not tested")

    # (b) the exported state dict under the pre-0.18 names
    legacy = legacy_names(load_torch_state_dict(dirs["unet"]))
    convs = [k for k, v in legacy.items() if v.ndim == 3]
    if len(convs) != 3 or not any(".proj_attn." in k for k in legacy):
        raise AssertionError(f"serve (b): legacy names not exercised ({convs})")
    model = fresh()
    model.load_state_dict(convert_unet2d(legacy, model))
    assert_same_tensors(torch, "serve (b): legacy import", model.state_dict(), items["unet"])
    try:
        convert_unet2d({**legacy, "mid_block.attentions.0.rel_pos.weight": legacy[convs[0]]},
                       model)
    except ValueError:
        pass
    else:
        raise AssertionError("serve (b): a state dict with an extra tensor loaded")
    del model, legacy

    # (c) the service on the bundle in bf16 behind a ThreadingHTTPServer
    reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    svc = SamplerService(str(bundle), arch="celebahq_256", dtype=torch.bfloat16,
                         device="cuda")
    load_s = time.perf_counter() - t0
    assert_same_tensors(torch, "serve (c): served weights", {k: v.cpu() for k, v in
                                                       svc.model.state_dict().items()},
                        items["unet"])
    server = ThreadingHTTPServer(("127.0.0.1", 0), make_handler(svc))
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    url = f"http://127.0.0.1:{server.server_address[1]}"
    code, body, _ = http(f"{url}/healthz")
    health = json.loads(body)
    if code != 200 or health != {"ok": True, "model": "celebahq_256", "compiled": []}:
        raise AssertionError(f"serve (c): /healthz {code} {health}")
    cold = [None] * len(SERVE_REQUESTS)

    def ask(i):
        cold[i] = http(f"{url}/sample", json.dumps(SERVE_REQUESTS[i]).encode())

    threads = [threading.Thread(target=ask, args=(i,)) for i in range(len(SERVE_REQUESTS))]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    both_s = time.perf_counter() - t0
    warm = [http(f"{url}/sample", json.dumps(r).encode()) for r in SERVE_REQUESTS]
    for r, (c_code, c_png, _), (w_code, w_png, _) in zip(SERVE_REQUESTS, cold, warm):
        if c_code != 200 or w_code != 200 or c_png[:4] != b"\x89PNG":
            raise AssertionError(f"serve (c): {r} answered {c_code} {c_png[:300]!r}, then "
                                 f"{w_code} {w_png[:300]!r}")
        if c_png != w_png:
            raise AssertionError(f"serve (c): {r} again with its seed gave other PNG bytes")
    code, body, _ = http(f"{url}/healthz")
    keys = sorted(tuple(k) for k in json.loads(body)["compiled"])
    want_keys = sorted((r["n"], r["steps"], r["sampler"]) for r in SERVE_REQUESTS)
    if keys != want_keys:
        raise AssertionError(f"serve (c): /healthz lists {keys}, expected {want_keys}")
    code, body, _ = http(f"{url}/sample", b'{"n": "x"}')
    if code != 400 or "error" not in json.loads(body):
        raise AssertionError(f"serve (c): a malformed body gave {code} {body[:200]!r}")
    server.shutdown()
    server.server_close()
    thread.join()
    counts = dict(launch_counts)
    peak = torch.cuda.max_memory_allocated()

    # The served grids against the port's sampler called directly.
    for r, (_, png, _) in zip(SERVE_REQUESTS, warm):
        fn = sample_dpm_solver_2m if r["sampler"] == "dpm" else sample_ddpm
        x = fn(lambda x, t, c: unet_eps_apply(svc.model, x, t, c), svc.schedule,
               (r["n"], *svc.shape), r["steps"],
               generator=torch.Generator(device=svc.device).manual_seed(r["seed"]))
        grid = Evaluator.make_grid_from_images(np.clip((x.float().cpu().numpy() + 1) / 2, 0, 1))
        served = np.asarray(Image.open(io.BytesIO(png)))
        want = (grid * 255).astype(np.uint8)
        if served.shape != want.shape or not np.array_equal(served, want):
            diff = (np.abs(served.astype(int) - want.astype(int)).max()
                    if served.shape == want.shape else served.shape)
            raise AssertionError(f"serve (c): {r}'s served grid differs from the sampler's own "
                                 f"call (largest difference {diff})")
    torch.backends.cudnn.deterministic = False
    if any(counts.values()) or not {"siss_reduce", "siss_bwd", "flash_fwd", "flash_bwd_dkv",
                                     "flash_bwd_dq"} <= set(counts):
        raise AssertionError(f"serve (c): launch counts {counts}, expected every kernel 0")
    del svc
    torch.cuda.empty_cache()
    print(f"serve ({card}): export of unet and unet_ema {export_s:.2f} s, imported back bit for "
          f"bit in {import_s:.2f} s ({CELEB_PARAMS:,} params); legacy names (3 [O, I, 1] "
          f"convs) bit for bit, an extra tensor refused; service built in {load_s:.2f} s")
    for r, (_, _, c_s), (_, _, w_s) in zip(SERVE_REQUESTS, cold, warm):
        print(f"serve ({card}) {json.dumps(r, sort_keys=True)}: cold {c_s:.3f} s (both at once "
              f"in {both_s:.3f} s), warm {w_s:.3f} s = {r['n'] / w_s:.2f} img/s")
    exported = sum(f.stat().st_size for f in out.rglob("*") if f.is_file())
    written = {k: (v - written0[k]) / 1e9 for k, v in io_written().items()}
    print(f"serve ({card}): peak memory {peak / 2**30:.2f} GiB, launches {counts}; written "
          f"(/proc/self/io) wchar {written['wchar']:.3f} GB, write_bytes "
          f"{written['write_bytes']:.3f} GB; the two directories hold {exported / 1e9:.3f} GB")


SD_WORK = ROOT / "build" / "chip_smoke_sd"
# The cached run takes 2 steps (3 until phase 8c took the script near
# 700 s; PERF.md §4 names the cut).
SD_IMAGES, SD_SIZE, SD_STEPS = 16, 512, 1
# The shipped validation sampler takes 50 steps; cut to 25 since the whole
# script reached ~600 s, to 15 to pay for phase 9(g)–(h) (PERF.md §4 names
# the cuts).
SD_INFERENCE_STEPS = 15
SD_IMAGES_NAME = "sylvester_stallone"   # configs/delete_sd.yaml's images_name
SD_STEP_KEYS = ("loss_x/mean", "importance_weight_x/mean", "gradient/scaling_factor",
                "images_per_sec")
# Flash sites of the sd_v1 UNet: 10 self-attentions a forward (5 at 64×64
# latents, 5 at 32×32), each differentiated by both pulls.
SD_FLASH_SITES = 10
SD_PROMPT_TOKENS = 77


def write_sd_dataset(root: Path, n: int, size: int) -> None:
    """An SD task's data under ``root``: ``images/`` of ``n`` random size²
    PNGs (``img_0.png`` memorised), ``kmeans_labels.json``,
    ``clustering_info.json``, two prompt files keyed by the config's
    ``images_name``, and ``pretrained/tokenizer/`` holding a synthetic CLIP
    byte-level vocabulary (256 byte symbols, each with ``</w>``, a few
    merges, BOS and EOS: every id below 49,408) and nothing else, so the
    towers and UNet start from random weights."""
    import numpy as np
    from PIL import Image

    from siss_tpu_torch.models.clip_bpe import bytes_to_unicode

    (root / "images").mkdir(parents=True)
    rng = np.random.default_rng(0)
    labels = {}
    for i in range(n):
        name = f"img_{i}.png"
        Image.fromarray(rng.integers(0, 256, (size, size, 3), dtype=np.uint8)).save(
            root / "images" / name)
        labels[name] = int(i == 0)
    (root / "kmeans_labels.json").write_text(json.dumps(labels))
    (root / "clustering_info.json").write_text(
        json.dumps({"frac_deletion": 1 / n, "mem_img_name": "img_0.png"}))
    (root / "og_prompts.json").write_text(
        json.dumps({SD_IMAGES_NAME: "a photo of sylvester stallone"}))
    (root / "modified_prompts.json").write_text(
        json.dumps({SD_IMAGES_NAME: "a painting of a man on a beach"}))
    syms = [bytes_to_unicode()[b] for b in range(256)]
    merges = ["p h", "ph o", "t o</w>", "pho t", "phot o</w>", "o f</w>", "a n</w>", "t h",
              "th e</w>"]
    vocab = {s: i for i, s in enumerate(syms + [s + "</w>" for s in syms]
                                        + ["".join(m.split()) for m in merges]
                                        + ["<|startoftext|>", "<|endoftext|>"])}
    tok = root / "pretrained" / "tokenizer"
    tok.mkdir(parents=True)
    (tok / "vocab.json").write_text(json.dumps(vocab, ensure_ascii=False), encoding="utf-8")
    (tok / "merges.txt").write_text("#version: 0.2\n" + "\n".join(merges) + "\n",
                                    encoding="utf-8")


def sd_task_run(torch, cli, label, steps, *extra):
    """One ``--config-name=delete_sd`` run on ``SD_WORK`` with the launch
    counts set to 0 just before it; returns (task, counts, seconds, peak)."""
    from siss_tpu_torch.ops import launch_counts, reset_launch_counts

    torch.cuda.empty_cache()
    reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    (task,) = cli.main(["--config-name=delete_sd", f"base_dir={SD_WORK}",
                        f"output_dir={SD_WORK / ('out_' + label)}",
                        f"pretrained_model_name_or_path={SD_WORK / 'pretrained'}",
                        f"og_prompts_path={SD_WORK / 'og_prompts.json'}",
                        f"modified_prompts_path={SD_WORK / 'modified_prompts.json'}",
                        "attention_impl=flash", f"training_steps={steps}", "eval_batches=1",
                        f"num_inference_steps={SD_INFERENCE_STEPS}", *extra])
    seconds = time.perf_counter() - t0
    return task, dict(launch_counts), seconds, torch.cuda.max_memory_allocated()


def check_sd_run(task, label, steps, counts):
    """Exact launch counts, finite step metrics at image counts, both
    prompts' panels and growing noise-norm series at every validation, and
    ``frac_deletion`` from the side file."""
    cfg = task.cfg
    accum, bs = int(cfg.gradient_accumulation_steps), int(cfg.train_batch_size)
    prompts, n_inf = len(cfg.validation_prompts), int(cfg.num_inference_steps)
    cfg_calls = steps * prompts * int(cfg.eval_batches) * n_inf   # one validation a step
    expected = {k: 0 for k in counts} | {
        "siss_reduce": steps * accum, "siss_bwd": 2 * steps * accum,
        "flash_fwd": steps * SD_FLASH_SITES * accum + SD_FLASH_SITES * cfg_calls,
        "flash_bwd_dkv": 2 * steps * SD_FLASH_SITES * accum,
        "flash_bwd_dq": 2 * steps * SD_FLASH_SITES * accum}
    if counts != expected:
        raise AssertionError(f"SD task ({label}): launch counts {counts}, expected {expected}")
    if cfg.deletion.frac_deletion != 1 / SD_IMAGES:
        raise AssertionError(f"SD task ({label}): frac_deletion {cfg.deletion.frac_deletion}")
    with open(Path(str(cfg.output_dir)) / "metrics.jsonl") as f:
        rows = [json.loads(line) for line in f]
    images = [bs * accum * (i + 1) for i in range(steps)]
    step_rows = [r for r in rows if "loss_x/mean" in r]
    if ([r["_step"] for r in step_rows] != images
            or any(not math.isfinite(r[k]) for r in step_rows for k in SD_STEP_KEYS)
            or not all(r["gradient/scaling_factor"] > 0 for r in step_rows)):
        raise AssertionError(f"SD task ({label}): step rows {step_rows}, expected finite "
                             f"{SD_STEP_KEYS} (scaling factor > 0) at image counts {images}")
    for pi in range(prompts):
        panels = [r["_step"] for r in rows if f"Generated Images (prompt {pi})/files" in r]
        series = [r for r in rows if r.get("_name") == f"noise_norms/noise_norms_{pi}"]
        if (panels != images or [r["_step"] for r in series] != images
                or [len(r["ys"]) for r in series] != list(range(1, steps + 1))
                or any(len(ys) != n_inf or not all(math.isfinite(v) for v in ys)
                       for r in series for ys in r["ys"])):
            raise AssertionError(f"SD task ({label}): prompt {pi} panels at {panels}, noise-norm "
                                 f"series {[(r['_step'], len(r['ys'])) for r in series]}; "
                                 f"expected one of each at {images}, one curve more each time")
    return step_rows


def count_tower_flops(torch, models, fn):
    """Operations (2 per multiply-add) of one ``fn()`` through ``models``,
    counted from the shapes by forward hooks: convolutions, and matmuls
    (linear layers and the attention products QKᵀ and P·V)."""
    from siss_tpu_torch.models.clip_text import CLIPAttention
    from siss_tpu_torch.models.layers import SpatialAttention

    flops = {"conv": 0, "matmul": 0}

    def count(mod, inp, out):
        if isinstance(mod, torch.nn.Conv2d):
            flops["conv"] += 2 * out.numel() * mod.in_channels * math.prod(mod.kernel_size)
        elif isinstance(mod, torch.nn.Linear):
            flops["matmul"] += 2 * out.numel() * mod.in_features
        elif isinstance(mod, SpatialAttention):   # one head over the H·W tokens
            B, C, H, W = inp[0].shape
            flops["matmul"] += 4 * B * (H * W) ** 2 * C
        elif isinstance(mod, CLIPAttention):
            B, N, D = inp[0].shape
            flops["matmul"] += 4 * B * N * N * D

    kinds = (torch.nn.Conv2d, torch.nn.Linear, SpatialAttention, CLIPAttention)
    hooks = [m.register_forward_hook(count) for model in models for m in model.modules()
             if isinstance(m, kinds)]
    try:
        with torch.inference_mode():
            fn()
    finally:
        for h in hooks:
            h.remove()
    return flops


def tower_times(torch, card):
    """The SD-1 VAE's encode and decode of one 512² image and the CLIP text
    tower on one 77-token prompt, in bf16 autocast as the task runs them,
    random weights: ms a call beside the bound of their convolution and
    matmul operations at the bf16 tensor-core rate."""
    from siss_tpu_torch.models import (AutoencoderKLConfig, CLIPTextConfig, build_clip_text,
                                       build_vae)

    vae = build_vae(AutoencoderKLConfig.sd_v1(), dtype=torch.bfloat16).requires_grad_(False)
    text = build_clip_text(CLIPTextConfig.sd_v1(), dtype=torch.bfloat16).requires_grad_(False)
    gen = torch.Generator(device="cuda").manual_seed(0)
    x = 2 * torch.rand(1, SD_SIZE, SD_SIZE, 3, generator=gen, device="cuda") - 1
    z = torch.randn(1, SD_SIZE // 8, SD_SIZE // 8, 4, generator=gen, device="cuda")
    ids = torch.randint(0, 49408, (1, SD_PROMPT_TOKENS), generator=gen, device="cuda")
    calls = {"VAE encode (512², one image)": (vae, lambda: vae.encode_moments(x)),
             "VAE decode (512², one image)": (vae, lambda: vae.decode(z)),
             "CLIP text (one 77-token prompt)": (text, lambda: text(ids))}
    for name, (model, fn) in calls.items():
        flops = count_tower_flops(torch, (model,), fn)
        with torch.inference_mode():
            ms = statistics.median(gpu_ms(torch, fn, launches=5, repeats=3))
        bound = (flops["conv"] + flops["matmul"]) / H100_BF16_FLOPS * 1e3
        print(f"{name} ({card}; bf16 autocast, TF32 off): {ms:.3f} ms; conv "
              f"{flops['conv'] / 1e9:.3f} + matmul {flops['matmul'] / 1e9:.3f} GFLOP, bound "
              f"{bound:.4f} ms at {H100_BF16_FLOPS / 1e12:.0f} TFLOP/s: {bound / ms:.1%} of it")


def phase_sd_task(torch, card):
    """The shipped delete_sd config through the port's command line at full
    width: SD_STEPS steps with the latent cache, then 1 step from a fresh output
    directory encoding in the step (``cache_latents=false``)."""
    import shutil

    from siss_tpu_torch import main as cli

    shutil.rmtree(SD_WORK, ignore_errors=True)
    write_sd_dataset(SD_WORK, SD_IMAGES, SD_SIZE)
    for label, steps, extra in (("cached", SD_STEPS, ()),
                                ("uncached", 1, ("cache_latents=false",))):
        task, counts, seconds, peak = sd_task_run(torch, cli, label, steps, *extra)
        check_sd_run(task, label, steps, counts)
        cfg = task.cfg
        accum, bs = int(cfg.gradient_accumulation_steps), int(cfg.train_batch_size)
        med = statistics.median(task.step_seconds)
        setup = {k: round(v, 3) for k, v in task.setup_seconds.items()}
        print(f"SD task {label} ({card}): --config-name=delete_sd, {SD_IMAGES} random "
              f"{SD_SIZE}² PNGs, random weights, attention_impl=flash, {steps} steps of bs {bs} "
              f"x accum {accum} in {seconds:.2f} s: set-up {json.dumps(setup)} s, steps "
              f"{[round(s, 4) for s in task.step_seconds]} s, median {med:.4f} s = "
              f"{bs * accum / med:.2f} img/s, peak memory {peak / 2**30:.2f} GiB")
        print(f"SD task {label} launches: " + json.dumps(counts, sort_keys=True))
        for rec in task.eval_records:
            parts = {k: round(v, 4) for k, v in rec.items() if k != "step"}
            print(f"SD task {label} validation at step {rec['step']} (seconds; "
                  f"{len(cfg.validation_prompts)} prompts x {cfg.eval_batches} CFG sample of "
                  f"{cfg.num_inference_steps} DDIM steps at batch 2): "
                  + json.dumps(parts, sort_keys=True))
        rows = [json.loads(line) for line in open(Path(str(cfg.output_dir)) / "metrics.jsonl")]
        last = [r for r in rows if "loss_x/mean" in r][-1]
        print(f"SD task {label} last step: "
              + json.dumps({k: last[k] for k in SD_STEP_KEYS}, sort_keys=True))
        del task
    tower_times(torch, card)


# Phase 8c(a): the SD task's Adafactor fast path (configs/delete_sd.yaml's
# commented block) with the three SD metrics on, 1 step (2 until phase
# 9(g)–(h) took the script past 700 s; PERF.md §4 names the cut).
SD_FAST_PATH = ("optimizer={_target_: adafactor, weight_decay: 1.0e-2}", "train_batch_size=2",
                "gradient_accumulation_steps=8", "deletion.grad_accum_dtype=bfloat16",
                "gradient_checkpointing=false")
SD_FAST_STEPS = 1
JAX_SD_TASK = ROOT / "siss_tpu" / "tasks" / "delete_sd.py"
# Phase 8c(b): the least the memory mode must take off the SD step's peak.
MEMORY_MODE_SAVING = 4 * 2**30


def jax_sd_metric_keys(prompts):
    """The JAX SD task's validation metric keys, read from its source (the
    script imports nothing of the JAX package)."""
    templates = set(re.findall(r'logs\[f"(metrics/[a-z_]+)_\{pi\}"\]', JAX_SD_TASK.read_text()))
    if not templates:
        raise AssertionError(f"no metric keys found in {JAX_SD_TASK}")
    return {f"{t}_{pi}" for t in templates for pi in range(prompts)}


def write_sd_metric_files(torch, root: Path) -> None:
    """Synthetic stand-ins for the SD metrics' artifacts under ``root``:
    k-means centers (the memorised image and mid-grey) at 512², a small
    TorchScript embedder for SSCD, and ``clip/``: a random full-width
    ViT-L/14 vision state dict (bf16) under transformers' names and random
    anchors."""
    import numpy as np
    from PIL import Image

    from siss_tpu_torch.models.clip_vision import CLIPVisionConfig, build_clip_vision

    root.mkdir(parents=True)
    mem = np.asarray(Image.open(SD_WORK / "images" / "img_0.png"), np.float32).reshape(-1)
    np.savez(root / "km.npz", centers=np.stack([mem, np.full_like(mem, 127.5)]))
    write_sscd_standin(torch, root / "sscd.pt")
    (root / "clip" / "vision").mkdir(parents=True)
    vision = build_clip_vision(CLIPVisionConfig.vit_l14(), seed=0, device="cpu")
    # bf16 halves the call's disk writes (the tower loads them in fp32)
    torch.save({k: v.to(torch.bfloat16) for k, v in vision.state_dict().items()},
               root / "clip" / "vision" / "pytorch_model.bin")
    rng = np.random.default_rng(0)
    np.savez(root / "clip" / "iqa_anchors.npz", good=rng.normal(size=768), bad=rng.normal(size=768))


def write_sscd_standin(torch, path: Path) -> None:
    """A small TorchScript embedder standing in for SSCD: NCHW images to
    L2-normalised 512-dimensional embeddings, as the real model gives."""
    torch.manual_seed(0)
    trunk = torch.nn.Sequential(torch.nn.Conv2d(3, 64, 7, stride=4), torch.nn.ReLU(),
                                torch.nn.AdaptiveAvgPool2d(1), torch.nn.Flatten(),
                                torch.nn.Linear(64, 512)).eval()

    class Normalized(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.trunk = trunk

        def forward(self, x):
            return torch.nn.functional.normalize(self.trunk(x), dim=-1)

    torch.jit.save(torch.jit.trace(Normalized().eval(), torch.zeros(1, 3, 64, 64)), str(path))


def vit_times(torch, card):
    """The CLIP ViT-L/14 vision tower on one 224² image in fp32 (TF32 off),
    as CLIP-IQA runs it: ms beside the bound of its convolution and matmul
    operations at the fp32 rate."""
    from siss_tpu_torch.models.clip_vision import CLIPVisionConfig, build_clip_vision

    vision = build_clip_vision(CLIPVisionConfig.vit_l14()).requires_grad_(False)
    x = torch.randn(1, 3, 224, 224, generator=torch.Generator(device="cuda").manual_seed(0),
                    device="cuda")
    flops = count_tower_flops(torch, (vision,), lambda: vision(x))
    with torch.inference_mode():
        ms = statistics.median(gpu_ms(torch, lambda: vision(x), launches=5, repeats=3))
    bound = (flops["conv"] + flops["matmul"]) / H100_FP32_FLOPS * 1e3
    print(f"CLIP ViT-L/14 vision tower, one 224² image ({card}; fp32, TF32 off): {ms:.3f} ms; "
          f"conv {flops['conv'] / 1e9:.3f} + matmul {flops['matmul'] / 1e9:.3f} GFLOP, bound "
          f"{bound:.4f} ms at {H100_FP32_FLOPS / 1e12:.0f} TFLOP/s: {bound / ms:.1%} of it")


def phase_sd_fast_path(torch, card):
    """8c(a): the SD task's Adafactor fast path through the command line at
    full width with the three SD metrics on synthetic artifacts."""
    import os
    import shutil

    from siss_tpu_torch import main as cli

    if not (SD_WORK / "images").is_dir():
        write_sd_dataset(SD_WORK, SD_IMAGES, SD_SIZE)
    files = SD_WORK / "metric_files"
    shutil.rmtree(files, ignore_errors=True)
    t0 = time.perf_counter()
    write_sd_metric_files(torch, files)
    print(f"SD metric artifacts written in {time.perf_counter() - t0:.2f} s")
    os.environ["SISS_CLIP_DIR"] = str(files / "clip")
    try:
        task, counts, seconds, peak = sd_task_run(
            torch, cli, "fast_path", SD_FAST_STEPS, *SD_FAST_PATH,
            f"metrics.fraction_deletion={{classifier_path: {files / 'km.npz'}}}",
            f"metrics.sscd={{model_path: {files / 'sscd.pt'}}}", "metrics.clip_iqa=true")
    finally:
        del os.environ["SISS_CLIP_DIR"]
        shutil.rmtree(files, ignore_errors=True)
    check_sd_run(task, "fast path", SD_FAST_STEPS, counts)
    cfg = task.cfg
    accum, bs = int(cfg.gradient_accumulation_steps), int(cfg.train_batch_size)
    rows = [json.loads(line) for line in open(Path(str(cfg.output_dir)) / "metrics.jsonl")]
    want = jax_sd_metric_keys(len(cfg.validation_prompts))
    validations = [r for r in rows if "noise_norms/text_step0" in r]
    for r in validations:
        got = {k for k in r if k.startswith("metrics/")}
        if got != want or not all(math.isfinite(r[k]) for k in want):
            raise AssertionError(f"SD fast path: metric keys {sorted(got)} at {r['_step']}, "
                                 f"expected the JAX task's {sorted(want)}, finite")
        print(f"SD fast path metrics at image {r['_step']}: "
              + json.dumps({k: r[k] for k in sorted(want)}))
    if [r["_step"] for r in validations] != [bs * accum * (i + 1) for i in range(SD_FAST_STEPS)]:
        raise AssertionError(f"SD fast path: validations at {[r['_step'] for r in validations]}")
    for rec in task.eval_records:
        print(f"SD fast path validation at step {rec['step']} (seconds): "
              + json.dumps({k: round(v, 4) for k, v in rec.items() if k != "step"}))
    med = statistics.median(task.step_seconds)
    print(f"SD fast path ({card}): --config-name=delete_sd {' '.join(SD_FAST_PATH)}, "
          f"{SD_FAST_STEPS} steps of bs {bs} x accum {accum} in {seconds:.2f} s: set-up "
          f"{json.dumps({k: round(v, 3) for k, v in task.setup_seconds.items()})} s, steps "
          f"{[round(t, 4) for t in task.step_seconds]} s, median {med:.4f} s = "
          f"{bs * accum / med:.2f} img/s, peak memory {peak / 2**30:.2f} GiB")
    print("SD fast path launches: " + json.dumps(counts, sort_keys=True))
    del task
    vit_times(torch, card)


def knob_steps(torch, label, state, step, batch, gen, steps, per_step):
    """``steps`` steps of the SD path with the launch counts and the peak
    memory set to 0 just before; each kernel must launch ``per_step`` times
    a step. Returns the peak."""
    from siss_tpu_torch.ops import launch_counts, reset_launch_counts

    torch.cuda.empty_cache()
    reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    seconds = []
    for _ in range(steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, metrics = step(state, batch, gen)
        torch.cuda.synchronize()
        seconds.append(time.perf_counter() - t0)
        bad = {k: float(v) for k, v in metrics.items() if not math.isfinite(float(v))}
        if bad:
            raise AssertionError(f"SD knobs ({label}): non-finite metrics {bad}")
    counts, peak = dict(launch_counts), torch.cuda.max_memory_allocated()
    expected = {k: steps * per_step.get(k, 0) for k in counts}
    if counts != expected:
        raise AssertionError(f"SD knobs ({label}): launches {counts}, expected {expected}")
    print(f"SD knobs {label}: steps {[round(t, 4) for t in seconds]} s, peak memory "
          f"{peak / 2**30:.2f} GiB, launches {json.dumps(counts, sort_keys=True)}")
    return peak


def check_batched_pull(torch, model, schedule, batch, gen):
    """One microbatch's (g_x, g_a) of the SD path by one batched pull and by
    two pulls from the same forward and draws, in bf16 through the kernels,
    each held to the same gradients in fp32 (TF32 off; the fp32 kernels). A
    UNet's gradient has no closed Σ|terms| bound, so the fp32 gradients
    stand in as phase 4's float64 reference does: in every tensor the
    batched pull's largest and RMS errors must be at most twice the two
    pulls' (plus 2⁻¹⁶ of the tensor's largest |g|)."""
    from siss_tpu_torch.diffusion import q_sample
    from siss_tpu_torch.ops.batched import contiguous_norm_inputs
    from siss_tpu_torch.ops.siss import siss_weighted_sums
    from siss_tpu_torch.train import cond_unet_eps_apply

    params = list(model.parameters())
    keep, forget, cond = batch["all"][0], batch["deletion"][0], batch["conditioning"][0]
    noise = torch.randn(keep.shape, generator=gen, device=keep.device)
    t = torch.full((keep.shape[0],), 999, device=keep.device)
    mix = q_sample(schedule, keep, noise, t)   # the keep side of the mixture

    def losses():
        preds = cond_unet_eps_apply(model, mix, t, cond)
        wlx, wla, _ = siss_weighted_sums(preds, mix, keep, forget, schedule.gamma[t],
                                         schedule.sigma[t], 0.5)
        return wlx, wla

    def two_pulls():
        wlx, wla = losses()
        return (torch.autograd.grad(wlx, params, retain_graph=True),
                torch.autograd.grad(wla, params))

    two = two_pulls()
    with contiguous_norm_inputs(model):
        wlx, wla = losses()
        seeds = (torch.tensor([1.0, 0.0], device=keep.device),
                 torch.tensor([0.0, 1.0], device=keep.device))
        both = torch.autograd.grad((wlx, wla), params, seeds, is_grads_batched=True)
    compute, model.dtype = model.dtype, torch.float32
    try:
        ref = two_pulls()
    finally:
        model.dtype = compute
    worst = (0.0, 0.0)
    for which in (0, 1):
        for g2, b, r in zip(two[which], both, ref[which]):
            r = r.float()
            floor = 2 ** -16 * float(r.abs().max())
            e2, eb = (g.float() - r for g in (g2, b[which]))
            for i, norm in enumerate((lambda e: float(e.abs().max()),
                                      lambda e: float(e.square().mean().sqrt()))):
                bound = 2 * norm(e2) + floor   # 0 where the gradient is exactly 0
                ratio = norm(eb) / bound if bound else (0.0 if norm(eb) == 0 else math.inf)
                worst = tuple(max(w, ratio) if j == i else w for j, w in enumerate(worst))
    if not max(worst) <= 1.0:
        raise AssertionError(f"batched pull against two pulls: error against fp32 at "
                             f"{worst[0]:.3f} (largest) and {worst[1]:.3f} (RMS) of its bound")
    print(f"SD knobs batched pull against two pulls (one microbatch, bf16 autocast, kernels; "
          f"reference: the fp32 gradients): worst tensor at {worst[0]:.4f} (largest error) and "
          f"{worst[1]:.4f} (RMS) of its bound, 2 × the two pulls' error + 2⁻¹⁶·max|g|")


def phase_sd_knobs(torch, card):
    """8c(b): the full-width SD step of phase 8 on one built UNet: (0) the
    default knobs, (i) the memory mode, (ii) the batched dual backward with
    remat_policy=dots, each with its launches; the memory mode's peak must
    be at least 4 GiB under the default's."""
    import dataclasses
    import gc

    from siss_tpu_torch.diffusion import sd_noise_schedule
    from siss_tpu_torch.profile_step import SD_ACCUM, SD_ADAMW, SD_STEP_KW, make_sd_path
    from siss_tpu_torch.train import (DeletionStepConfig, TrainState, build_deletion_train_step,
                                      build_optimizer, cond_unet_eps_apply)

    state, step, batch, gen = make_sd_path()
    model = state.model
    schedule = sd_noise_schedule(device=batch["all"].device)
    sites = SD_FLASH_SITES * SD_ACCUM
    per_step = {"flash_fwd": sites, "flash_bwd_dkv": 2 * sites, "flash_bwd_dq": 2 * sites,
                "siss_reduce": SD_ACCUM, "siss_bwd": 2 * SD_ACCUM}
    default_peak = knob_steps(torch, "(0) default knobs", state, step, batch, gen, 1, per_step)

    def fresh(opt_extra, **step_kw):
        opt, sched = build_optimizer({**SD_ADAMW, **opt_extra}, model.parameters())
        return (TrainState.create(model, opt, sched),
                build_deletion_train_step(cond_unet_eps_apply, schedule,
                                          DeletionStepConfig(**SD_STEP_KW, **step_kw)))

    del state, step
    gc.collect()
    state, step = fresh({"mu_dtype": "bfloat16", "nu_dtype": "bfloat16"},
                        grad_accum_dtype="bfloat16", param_cast_dtype="bfloat16")
    memory_peak = knob_steps(torch, "(i) memory mode (bf16 Adam moments, accumulators, "
                             "param cast)", state, step, batch, gen, 2, per_step)
    print(f"SD knobs ({card}): peak memory default {default_peak / 2**30:.2f} GiB, memory mode "
          f"{memory_peak / 2**30:.2f} GiB: {(default_peak - memory_peak) / 2**30:.2f} GiB less")
    if not default_peak - memory_peak >= MEMORY_MODE_SAVING:
        raise AssertionError(f"the memory mode's step peak is not "
                             f"{MEMORY_MODE_SAVING / 2**30:.0f} GiB under the default's")

    del state, step
    gc.collect()
    model.config = dataclasses.replace(model.config, remat_policy="dots")
    check_batched_pull(torch, model, schedule, batch, gen)
    state, step = fresh({}, batched_dual_backward=True)
    # One batched pull: each flash backward kernel launches once a site (the
    # two seeds folded into its batch), the SISS backward once a seed.
    knob_steps(torch, "(ii) batched dual backward, remat_policy=dots", state, step, batch, gen,
               2, dict(per_step, flash_bwd_dkv=sites, flash_bwd_dq=sites))


TSHIRT_DATA = ROOT / "data" / "datasets" / "mnist_with_tshirt.npz"
TSHIRT_WORK = ROOT / "build" / "chip_smoke_tshirt"
# The pretrain: 4 epochs of the 5,632 images at batch 128 (176 steps).
TSHIRT_PRETRAIN = ("num_epochs=4", "lr_warmup_steps=50", "sampling_steps=0")
# The shipped block evaluates the likelihood every 30 steps, at steps 0 and
# 30 of this run; once (step 0) keeps the script under its time.
TSHIRT_LIKELIHOOD_EVERY = 1000
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
    latest bundle with the shipped metrics block (the likelihood at step 0
    only), then the selectivity probe. Returns the pretrain bundle's
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
                         "pipeline.num_inference_steps=50",
                         f"metrics.likelihood.step_frequency={TSHIRT_LIKELIHOOD_EVERY}")
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
    if [s for s, _ in likelihood] != [0] or not all(v > 0 for _, v in likelihood):
        raise AssertionError(f"t-shirt: metrics/likelihood by step {likelihood}, expected a "
                             f"positive value at step 0")

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


# Phase 9: data parallelism on the celeb main path (phase 7's step).
DP_WORK = ROOT / "build" / "chip_smoke_dp"
DP_STEPS, DP_RANKS = 1, 2   # the steps of (a), (b) and (e); PERF.md §4 lists the cuts
DP_DATA_STEPS = 1   # 9(c)'s steps: one keeps the script within its time
DP_NORMS = ("gradient/norm_loss_x", "gradient/norm_loss_a", "gradient/pre_clip_norm")
# The CLI drives: the t-shirt unlearning task on two ranks from phase 6's
# pretrain, 2 steps with an evaluation of 64 images at step 0 and no
# likelihood; (d) on the data axis and (f) with mesh.fsdp=2, side by side.
DP_CLI_STEPS = 2
DP_CLI = (f"training_steps={DP_CLI_STEPS}", "sampling_steps=1000", "eval_images=64",
          "metrics.likelihood=null")
HELD = ("params", "optimizer", "ema", "accumulators")
# 9(g)–(j): the tensor axis at tensor 2, alone on two gloo ranks ((g), (h))
# and with fsdp 2 on four ((i), (j)), the celeb step's global microbatch ×
# accumulation cut to TP_MB × TP_ACCUM and the sd step's to TP_SD_MB ×
# TP_SD_ACCUM: every activation all-reduce is staged through the host by
# gloo. (g) runs beside (i), and (h) beside (j), on the one card.
TP_ACCUM, TP_MB, TP_STEPS = 2, 2, 2
TP_SD_ACCUM, TP_SD_MB = 1, 2
# The sd step's optimizer there: the SD fast path's Adafactor
# (configs/delete_sd.yaml:118-133, at the config's learning rate).
TP_SD_OPTIMIZER = {"_target_": "adafactor", "lr": 1e-5, "weight_decay": 1e-2}
# Parameter bytes a rank holds (JAX's placement: at tensor 2, 99,179,520 of
# the celeb UNet's 113,673,219 elements split, 756,629,760 of sd_v1's
# 859,520,964; at fsdp 2 × tensor 2, 32,212,483 and 240,791,364 elements a
# rank), and sd_v1's whole.
TP_PARAM_BYTES = {"celeb": 256_333_836, "sd": 1_924_824_336}
TP_FSDP_PARAM_BYTES = {"celeb": 128_849_932, "sd": 963_165_456}
SD_PARAM_BYTES = 3_438_083_856
TP_SD_PER_STEP = {"flash_fwd": 10 * TP_SD_ACCUM, "flash_bwd_dkv": 20 * TP_SD_ACCUM,
                  "flash_bwd_dq": 20 * TP_SD_ACCUM, "siss_reduce": TP_SD_ACCUM,
                  "siss_bwd": 2 * TP_SD_ACCUM}
# The local heads' flash shapes on the SD path at tensor 2: (h)'s ranks take
# both images of a microbatch, (j)'s one each.
TP_FLASH_SHAPES = {"h": ((2, 4, 4096, 40), (2, 4, 1024, 80)),
                   "j": ((1, 4, 4096, 40), (1, 4, 1024, 80))}
# scripts/fsdp_memory.py's peaks a rank for the sd_v1 step (global
# microbatch 2, no accumulation; NVIDIA H100 80GB HBM3, 700 W; PERF.md §6),
# printed beside 9(h)'s.
FSDP_MEMORY_GIB = {"data=2": 22.89, "fsdp=2": 18.09}


def dp_inputs(torch, device, accum=None, mb=None, steps=DP_STEPS):
    """The phase's global batch and ``steps`` steps' global draws, from one
    seed on the card: every process makes the same ones. ``accum`` × ``mb``:
    the celeb step's 4 × 16 unless given (9(g) cuts them)."""
    from siss_tpu_torch.profile_step import MAIN_ACCUM, MAIN_MB
    from siss_tpu_torch.train.step import draw_microbatch_randomness

    accum, mb = accum or MAIN_ACCUM, mb or MAIN_MB
    gen = torch.Generator(device=device).manual_seed(9)
    batch = {k: torch.randn(accum, mb, 256, 256, 3, generator=gen, device=device)
             for k in ("all", "deletion")}
    draws = [draw_microbatch_randomness(gen, accum, mb, (256, 256, 3), 999, 1000, device)
             for _ in range(steps)]
    return batch, draws


def whole_digest(torch, sharding):
    """Each whole (unsplit) parameter's bits summed as integers: equal on
    two ranks exactly when those parameters are, up to a collision."""
    return torch.stack([p.detach().reshape(-1).view(torch.int32).long().sum()
                        for p, lay in zip(sharding.params, sharding.layouts)
                        if not lay.axes]).cpu()


def dp_steps(torch, dtype, device, mesh=None, steps=DP_STEPS, accum=None, mb=None):
    """DP_STEPS celeb steps (``make_main_path`` at ``dtype``, split over
    ``mesh``'s fsdp or tensor ranks) on this rank's rows of the global
    batch (``dp_inputs``): θ0, and θ and the EMA after each step (whole,
    flat fp32 on the host), the three norms, the synchronised step seconds,
    the launches, the peak memory, the bytes this rank holds (parameters,
    optimizer state, EMA, the step's two accumulators) and the digest of
    its whole parameters."""
    from siss_tpu_torch.ops import launch_counts, reset_launch_counts
    from siss_tpu_torch.parallel import rank_rows
    from siss_tpu_torch.profile_step import make_main_path

    state, step, _, _ = make_main_path(device, dtype=dtype, mesh=mesh)
    batch, draws = dp_inputs(torch, device, accum, mb, steps)
    batch = {k: rank_rows(v, 1, mesh).contiguous() for k, v in batch.items()}
    sharding = state.sharding
    acc_bytes = []
    zeros = sharding.zeros

    def recording_zeros(dtype):
        out = zeros(dtype)
        acc_bytes.append(sum(t.numel() * t.element_size() for t in out))
        return out

    sharding.zeros = recording_zeros

    def flat(tensors):   # not ``gather``, which 9(e) times as the step's
        whole = sharding.gather_along(list(tensors), sharding.layouts)
        return torch.cat([t.detach().reshape(-1).float() for t in whole]).cpu()

    out = {"theta0": flat(sharding.params), "theta": [], "ema": [], "norms": [], "seconds": []}
    reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    for d in draws[:steps]:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, m = step(state, batch, draws=d)
        torch.cuda.synchronize()
        out["seconds"].append(time.perf_counter() - t0)
        out["norms"].append({k: float(m[k]) for k in DP_NORMS})
        out["theta"].append(flat(sharding.params))
        out["ema"].append(flat(state.ema.params))
    out["launches"] = dict(launch_counts)
    out["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    out["held"] = {**state.held_bytes(), "accumulators": sum(acc_bytes[-2:])}  # g_x, g_a
    out["whole"] = whole_digest(torch, sharding)
    return out


def sd_steps(torch, dtype, device, mesh=None):
    """9(h) and 9(j): TP_STEPS sd_v1 steps (``make_sd_path`` at ``dtype``,
    flash, Adafactor) at global microbatch TP_SD_MB × TP_SD_ACCUM, split
    over ``mesh``'s ranks, on this rank's rows: θ after the last step
    (whole, flat fp32 on the host), the norms, the samples' sets (keep
    where u > λ) and importance weights of each step, the synchronised step
    seconds, the launches, the peak memory, the bytes held and the digest of
    the whole parameters."""
    from siss_tpu_torch.ops import launch_counts, reset_launch_counts
    from siss_tpu_torch.parallel import rank_rows
    from siss_tpu_torch.profile_step import make_sd_path
    from siss_tpu_torch.train.step import draw_microbatch_randomness

    state, step, _, _ = make_sd_path(device, mesh=mesh, dtype=dtype, optimizer=TP_SD_OPTIMIZER)
    sharding = state.sharding
    gen = torch.Generator(device=device).manual_seed(9)
    shape = (TP_SD_ACCUM, TP_SD_MB, 64, 64, 4)
    batch = {k: torch.randn(shape, generator=gen, device=device) for k in ("all", "deletion")}
    prompt = torch.randn(77, 768, generator=gen, device=device)
    batch["conditioning"] = prompt.expand(*shape[:2], *prompt.shape)
    batch = {k: rank_rows(v, 1, mesh) for k, v in batch.items()}
    draws = [draw_microbatch_randomness(gen, TP_SD_ACCUM, TP_SD_MB, shape[2:], 999, 1000, device)
             for _ in range(TP_STEPS)]
    iw_keys = ("importance_weight_x/min", "importance_weight_x/max", "importance_weight_a/min",
               "importance_weight_a/max")
    out = {"norms": [], "seconds": [], "weights": [],
           "sets": [["keep" if u > 0.5 else "forget" for u in d["u"].reshape(-1).tolist()]
                    for d in draws]}
    reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    for d in draws:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, m = step(state, batch, draws=d)
        torch.cuda.synchronize()
        out["seconds"].append(time.perf_counter() - t0)
        out["norms"].append({k: float(m[k]) for k in DP_NORMS})
        out["weights"].append({k: float(m[k]) for k in iw_keys})
    out["launches"] = dict(launch_counts)
    out["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    out["held"] = state.held_bytes()
    out["whole"] = whole_digest(torch, sharding)
    whole = sharding.gather_along(list(sharding.params), sharding.layouts)
    out["theta"] = [torch.cat([t.detach().reshape(-1).float().cpu() for t in whole])]
    return out


def dp_rank(rank, port, queue, fp32_path, fsdp, steps, tensor=1, kind="celeb", ranks=DP_RANKS):
    """One of the ``ranks`` ranks of phase 9(c) (``fsdp`` 1), 9(e) (``fsdp``
    2), 9(g) (``tensor`` 2) or 9(i) (both 2, four ranks), or with ``kind``
    "sd" of 9(h) or 9(j): gloo on cuda:0; under (c) and (e) its 8 rows of
    each microbatch, under (g) and (h) the whole cut batch, under (i) and
    (j) its batch rank's half of it. Puts its norms, seconds, collective seconds ((c): the
    all-reduces; (e), (i), (j): the gather and the reduce-scatters; (g)–(j):
    the tensor axis's all-reduces), launches, peak memory, held bytes and
    whether its θ and EMA (celeb) and its whole parameters' digest equal
    rank 0's; rank 0 also its errors against one process's fp32 run
    (``save_fp32_ref``'s file at ``fp32_path``)."""
    import traceback

    try:
        import torch
        import torch.distributed as dist

        sys.path.insert(0, str(ROOT))
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cudnn.deterministic = True
        from siss_tpu_torch.parallel import (MeshConfig, destroy_distributed,
                                             initialize_distributed, make_rank_mesh)
        from siss_tpu_torch.parallel import fsdp as fsdp_module
        from siss_tpu_torch.parallel import tensor as tensor_module
        from siss_tpu_torch.train import step as step_module

        dev = initialize_distributed("cuda:0", "gloo", rank=rank, world_size=ranks,
                                     init_method=f"tcp://localhost:{port}", timeout_s=600)
        mesh = make_rank_mesh(MeshConfig(data=ranks // (fsdp * tensor), fsdp=fsdp,
                                         tensor=tensor))
        seconds = {"all_reduce": [], "gather": [], "scatter": [], "tensor": []}

        def timed(fn, key):
            def run(*args, **kwargs):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                out = fn(*args, **kwargs)
                torch.cuda.synchronize()
                seconds[key].append(time.perf_counter() - t0)
                return out
            return run

        fsdp_module.all_reduce_ = timed(fsdp_module.all_reduce_, "all_reduce")
        fsdp_module.Sharding.gather = timed(fsdp_module.Sharding.gather, "gather")
        fsdp_module.Sharding.scatter_add_ = timed(fsdp_module.Sharding.scatter_add_, "scatter")
        tensor_module._summed = timed(tensor_module._summed, "tensor")
        assert step_module.Sharding is fsdp_module.Sharding
        if kind == "sd":
            out = sd_steps(torch, torch.bfloat16, dev, mesh)
        else:
            accum, mb = (TP_ACCUM, TP_MB) if tensor > 1 else (None, None)
            out = dp_steps(torch, torch.bfloat16, dev, mesh, steps, accum, mb)
        equal = []
        for mine in out["theta"] + out.get("ema", []) + [out["whole"]]:
            ref = mine.clone()
            dist.broadcast(ref, 0)
            equal.append(torch.equal(ref, mine))
        destroy_distributed()
        errors = (step_errors(out, torch.load(fp32_path, mmap=True, weights_only=True))
                  if rank == 0 else None)
        queue.put({"rank": rank, "equal": equal, "norms": out["norms"], "seconds": out["seconds"],
                   "collectives": {k: v for k, v in seconds.items() if v},
                   "launches": out["launches"], "peak_gib": out["peak_gib"],
                   "held": out["held"], "errors": errors})
    except Exception:
        queue.put({"rank": rank, "error": traceback.format_exc()})


def start_ranks(fp32_path, fsdp, steps, tensor=1, kind="celeb", ranks=DP_RANKS):
    """Start ``dp_rank`` for ``steps`` steps on ``ranks`` processes sharing the
    card, on a port of their own; returns what ``collect_ranks`` takes."""
    import multiprocessing as mp
    import socket

    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    ctx = mp.get_context("spawn")
    queue = ctx.Queue()
    procs = [ctx.Process(target=dp_rank,
                         args=(r, port, queue, fp32_path, fsdp, steps, tensor, kind, ranks))
             for r in range(ranks)]
    for proc in procs:
        proc.start()
    return procs, queue, f"{kind} ranks (fsdp {fsdp}, tensor {tensor})"


def collect_ranks(*started):
    """The reports of each set of ranks that ``start_ranks`` started, rank
    0's first. Every process of every set is joined or killed, whatever
    fails."""
    try:
        out = [sorted((queue.get(timeout=900) for _ in procs), key=lambda r: r["rank"])
               for procs, queue, _ in started]
    finally:
        for procs, _, _ in started:
            for proc in procs:
                proc.join(timeout=60)
                if proc.is_alive():
                    proc.kill()
    for (_, _, label), reports in zip(started, out):
        for r in reports:
            if "error" in r:
                raise AssertionError(f"{label} rank {r['rank']} failed:\n{r['error']}")
    return out


def spawn_ranks(fp32_path, fsdp, steps, tensor=1, kind="celeb", ranks=DP_RANKS):
    """``dp_rank``'s reports from ``ranks`` processes sharing the card, rank
    0's first."""
    return collect_ranks(start_ranks(fp32_path, fsdp, steps, tensor, kind, ranks))[0]


def step_errors(run, fp32):
    """Δθ's largest and RMS error and the norms' largest and RMS relative
    error of ``run`` (θ after each step kept, the norms of each step)
    against the fp32 run ``fp32``."""
    # in float64 a slice at a time: sd_v1's θ is 859,520,964 elements, and
    # ranks of two meshes compute this at once
    n, dmax, sq, chunk = 0, 0.0, 0.0, 1 << 24
    for t, f in zip(run["theta"], fp32["theta"]):
        t, f = t.reshape(-1), f.reshape(-1)
        for i in range(0, t.numel(), chunk):
            d = t[i:i + chunk].double() - f[i:i + chunk].double()
            dmax, sq = max(dmax, float(d.abs().max())), sq + float((d ** 2).sum())
        n += t.numel()
    rel = [relative(a[k], b[k]) for a, b in zip(run["norms"], fp32["norms"]) for k in DP_NORMS]
    return {"dtheta_max": dmax, "dtheta_rms": math.sqrt(sq / n),
            "norm_rel_max": max(rel), "norm_rel_rms": math.sqrt(sum(x * x for x in rel) / len(rel))}


def save_fp32_ref(torch, ref, name):
    """Write one process's fp32 θ and norms where the ranks' rank 0 reads
    them (``dp_rank``): each family's once, which keeps the script's disk
    writes small (sd_v1's θ is 3.4 GB). Returns the path."""
    path = DP_WORK / f"{name}_fp32.pt"
    torch.save({"theta": ref["fp32"]["theta"], "norms": ref["fp32"]["norms"]}, path)
    return path


def check_ranks(torch, label, ranks, ref, steps, per_step=None):
    """The ranks' checks of 9(c), 9(e) and 9(g)–(j): θ (and EMA)
    equal across the ranks after each step it was kept and their whole
    parameters' digests equal, exact launches (``per_step``: the celeb
    step's 4 reduce and 8 backward unless given), equal norms, and rank
    0's errors against one process's fp32 steps at most twice one
    process's bf16 errors. Returns the errors' ratios."""
    per_step = per_step or {"siss_reduce": 4, "siss_bwd": 8}
    for r in ranks:
        if not all(r["equal"]):
            raise AssertionError(f"data parallel ({label}): rank {r['rank']}'s parameters, EMA or "
                                 f"whole parameters differ from rank 0's: {r['equal']}")
        want = {k: steps * per_step.get(k, 0) for k in r["launches"]}
        if r["launches"] != want:
            raise AssertionError(f"data parallel ({label}) rank {r['rank']}: launches "
                                 f"{r['launches']}, expected {want}")
        if r["norms"] != ranks[0]["norms"]:
            raise AssertionError(f"data parallel ({label}): the ranks' norms differ")
    e_one, e_two = step_errors(ref["bf16"], ref["fp32"]), ranks[0]["errors"]
    ratios = {k: relative(e_two[k], 0.0) if e_one[k] == 0 else e_two[k] / e_one[k] for k in e_one}
    print(f"data parallel ({label}): errors against one process's fp32 step, one process bf16 "
          f"{json.dumps(e_one)}, the ranks {json.dumps(e_two)}, ratio {json.dumps(ratios)}")
    bad = {k: v for k, v in ratios.items() if not v <= 2.0}
    if bad:
        raise AssertionError(f"data parallel ({label}): the ranks' errors above twice one "
                             f"process's bf16 errors: {bad}")
    return ratios


def relative(a, b):
    """|a − b| / |b|; where ``b`` is 0 (a norm of a step whose importance
    weights all underflow, as sd_v1's 16,384-dimensional latents at t = 999
    can give), 0 if ``a`` is 0 too, else infinite."""
    if b == 0:
        return 0.0 if a == 0 else math.inf
    return abs(a - b) / abs(b)


def rank_elements(torch, fsdp=1, tensor=1):
    """Elements of the celeb UNet's parameters that a rank holds on an
    ``fsdp`` × ``tensor`` mesh (``param_dims``, JAX's placement), and of
    all of them."""
    from siss_tpu_torch.models import UNet2D, UNet2DConfig
    from siss_tpu_torch.parallel import param_dims

    with torch.device("meta"):
        params = list(UNet2D(UNet2DConfig.celebahq_256()).named_parameters())
    held = 0
    for k, p in params:
        t, f = param_dims(k.split("."), p.shape, fsdp, tensor)
        held += p.numel() // ((tensor if t is not None else 1) * (fsdp if f is not None else 1))
    return held, sum(p.numel() for _, p in params)


def cli_two_ranks(base, out_dir, *extra):
    """Start ``delete_tshirt`` through ``torch.distributed.run`` on two gloo
    ranks sharing cuda:0 from the pretrain ``base``; ``cli_result`` waits
    for it. Returns (the launcher, its start time, its log)."""
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node",
           str(DP_RANKS), "-m", "siss_tpu_torch.main", "--config-name=delete_tshirt",
           "--device", "cuda:0", "--dist-backend", "gloo", f"checkpoint_path={base}/latest",
           f"output_dir={out_dir}", f"dataset.path={TSHIRT_DATA}",
           f"dataset_all.path={TSHIRT_DATA}", f"dataset_deletion.path={TSHIRT_DATA}",
           "train_batch_size=64", *DP_CLI, *extra]
    log = open(f"{out_dir}.log", "w+")
    return subprocess.Popen(cmd, cwd=ROOT, stdout=log, stderr=subprocess.STDOUT), time.perf_counter(), log


def cli_result(started, out_dir, *extra):
    """Wait for a ``cli_two_ranks`` run and check it: one run directory, one
    log with each step once and finite values, one checkpoint. Returns (the
    run directory, its log's rows, checkpoints, seconds with start-up, the
    launcher's output)."""
    proc, t0, log = started
    with log:
        try:
            proc.wait(timeout=600)
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        seconds = time.perf_counter() - t0
        log.seek(0)
        stdout = log.read()
    if proc.returncode != 0:
        raise AssertionError(f"the two-rank command line {extra} failed ({proc.returncode}):\n"
                             f"{stdout[-6000:]}")
    runs = [p for p in out_dir.iterdir() if p.is_dir()]
    logs = list(out_dir.rglob("metrics.jsonl"))
    if len(runs) != 1 or len(logs) != 1:
        raise AssertionError(f"the two-rank command line {extra}: {len(runs)} run directories and "
                             f"{len(logs)} tracker logs, expected one of each")
    cps = sorted(p.name for p in runs[0].iterdir() if p.name.startswith("checkpoint-"))
    with open(logs[0]) as f:
        rows = [json.loads(line) for line in f]
    steps = [r["_step"] for r in rows if "loss_x/mean" in r]
    bad = {(r["_step"], k): v for r in rows for k, v in r.items()
           if isinstance(v, (int, float)) and not math.isfinite(v)}
    if (cps != [f"checkpoint-{DP_CLI_STEPS}"] or steps != list(range(1, DP_CLI_STEPS + 1))
            or bad):
        raise AssertionError(f"the two-rank command line {extra}: checkpoints {cps}, logged steps "
                             f"{steps}, non-finite {bad}")
    return runs[0], rows, cps, seconds, stdout


def load_in_one_process(torch, run):
    """Load a t-shirt bundle into one process's full-width state: the
    ``unet`` item into the UNet (strict), the ``state`` item into a
    TrainState with the config's optimizer (and an EMA when the bundle has
    one); the UNet's parameters must equal the state's model bit for bit.
    Returns the parameter count."""
    from siss_tpu_torch.config import load_config, to_dict
    from siss_tpu_torch.models import UNet2DConfig, build_unet
    from siss_tpu_torch.train import TrainState, build_optimizer
    from siss_tpu_torch.utils import CheckpointManager

    cfg = load_config("delete_tshirt", [], str(ROOT / "configs"))
    node = {k: tuple(v) if isinstance(v, list) else v for k, v in to_dict(cfg.unet).items()
            if k != "_target_"}
    mgr = CheckpointManager(str(run))
    unet = build_unet(UNet2DConfig(**node), device="cuda")
    unet.load_state_dict(mgr.restore_item("latest", "unet"))
    model = build_unet(UNet2DConfig(**node), device="cuda")
    opt, sched = build_optimizer(cfg.optimizer, model.parameters())
    sd = mgr.restore_item("latest", "state")
    state = TrainState.create(model, opt, sched, use_ema=sd["ema"] is not None)
    state.load_state_dict(sd)
    for (k, a), b in zip(unet.named_parameters(), model.parameters()):
        if not torch.equal(a, b):
            raise AssertionError(f"the bundle's unet and state disagree at {k}")
    return sum(p.numel() for p in model.parameters())


def phase_data_parallel(torch, card, base):
    """9: the celeb main path at full width under data parallelism and
    under fsdp (see the module docstring), then the t-shirt task on two
    ranks through the command line, on each axis."""
    import gc
    import shutil
    import socket

    from siss_tpu_torch.parallel import destroy_distributed, initialize_distributed

    shutil.rmtree(DP_WORK, ignore_errors=True)
    DP_WORK.mkdir(parents=True)
    torch.backends.cudnn.deterministic = True
    t0 = time.perf_counter()

    # (a) one process, no group: bf16 autocast and fp32 (TF32 off).
    ref = {name: dp_steps(torch, dtype, "cuda") for name, dtype in
           (("bf16", torch.bfloat16), ("fp32", torch.float32))}
    # (b) NCCL at world size 1, through the same code path.
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    initialize_distributed("cuda:0", "nccl", rank=0, world_size=1,
                           init_method=f"tcp://localhost:{port}")
    try:
        nccl = dp_steps(torch, torch.bfloat16, "cuda:0")
    finally:
        destroy_distributed()
    for k in range(DP_STEPS):
        if not torch.equal(nccl["theta"][k], ref["bf16"]["theta"][k]):
            raise AssertionError(f"data parallel (b): NCCL at world size 1 gave other "
                                 f"parameters than one process after step {k + 1}")
        if nccl["norms"][k] != ref["bf16"]["norms"][k]:
            raise AssertionError(f"data parallel (b): norms {nccl['norms'][k]} != "
                                 f"{ref['bf16']['norms'][k]}")
    print(f"data parallel (b) ({card}): NCCL world size 1 bit-identical to one process over "
          f"{DP_STEPS} steps; step s {[round(t, 4) for t in nccl['seconds']]} against "
          f"{[round(t, 4) for t in ref['bf16']['seconds']]}")
    del nccl
    gc.collect()
    torch.cuda.empty_cache()
    t0 = lap("9(a)–(b)", t0)

    # (c) two ranks sharing the card over gloo, on the data axis.
    mode = subprocess.run(["nvidia-smi", "--query-gpu=compute_mode", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    print(f"data parallel (c): compute mode {mode}")
    if "exclusive" in mode.lower():
        raise AssertionError(f"compute mode {mode}: two processes cannot share the card, so "
                             "phase 9(c) cannot run")
    fp32_path = save_fp32_ref(torch, ref, "celeb")
    data_ranks = spawn_ranks(fp32_path, 1, DP_DATA_STEPS)
    check_ranks(torch, "c", data_ranks, ref, DP_DATA_STEPS)
    for r in data_ranks:
        print(f"data parallel (c) ({card}) rank {r['rank']}: step s "
              f"{[round(t, 4) for t in r['seconds']]} (one process bf16 "
              f"{[round(t, 4) for t in ref['bf16']['seconds']]}), all-reduce s "
              f"{[round(t, 4) for t in r['collectives']['all_reduce']]} (g_x, g_a a step), peak "
              f"memory {r['peak_gib']:.2f} GiB (one process {ref['bf16']['peak_gib']:.2f}), "
              f"launches {r['launches']}")

    t0 = lap("9(c)", t0)

    # (e) data=1 x fsdp=2 on two ranks sharing the card over gloo. (It does
    # not run beside (c): four ranks of ~18.3 GiB each do not fit the card.)
    fsdp_ranks = spawn_ranks(fp32_path, 2, DP_STEPS)
    check_ranks(torch, "e", fsdp_ranks, ref, DP_STEPS)
    held, total = rank_elements(torch, fsdp=2)
    split = 2 * (total - held)
    whole = data_ranks[0]["held"]
    # each category holds fp32 tensors of the parameters' shapes: 1 (params,
    # EMA) or 2 (AdamW's moments, the two accumulators) of them
    copies = {"params": 1, "ema": 1, "optimizer": 2, "accumulators": 2}
    for r in fsdp_ranks:
        want = {k: whole[k] - 4 * copies[k] * split // 2 for k in HELD}
        if {k: r["held"][k] for k in HELD} != want:
            raise AssertionError(f"data parallel (e) rank {r['rank']}: held bytes {r['held']}, "
                                 f"expected {want}")
    print(f"data parallel (e) ({card}): {split} of {total} parameters split over fsdp 2; held "
          f"bytes a rank {json.dumps({k: fsdp_ranks[0]['held'][k] for k in HELD})} against 9(c)'s "
          f"{json.dumps({k: whole[k] for k in HELD})}; the step's gathered working copy "
          f"{4 * split} bytes beside them")
    for r in fsdp_ranks:
        c = r["collectives"]
        print(f"data parallel (e) ({card}) rank {r['rank']}: step s "
              f"{[round(t, 4) for t in r['seconds']]} (9(c) rank 0 "
              f"{[round(t, 4) for t in data_ranks[0]['seconds']]}), gather s "
              f"{[round(t, 4) for t in c['gather']]} (1 a step), reduce-scatter s "
              f"{[round(t, 4) for t in c['scatter']]} (g_x, g_a per microbatch), "
              f"{round(sum(c['gather']) + sum(c['scatter']), 4)} s in all; peak memory "
              f"{r['peak_gib']:.2f} GiB (9(c) {data_ranks[0]['peak_gib']:.2f}), launches "
              f"{r['launches']}")
    del ref
    gc.collect()
    t0 = lap("9(e)", t0)

    # (d) the command line on two ranks sharing the card, data axis, and (f)
    # the same with mesh.fsdp=2, side by side.
    d_run = cli_two_ranks(base, DP_WORK / "cli")
    f_started = cli_two_ranks(base, DP_WORK / "cli_fsdp", "mesh.fsdp=2")
    run, rows, cps, seconds, stdout = cli_result(d_run, DP_WORK / "cli")
    f_run, f_rows, f_cps, f_seconds, f_stdout = cli_result(f_started, DP_WORK / "cli_fsdp",
                                                           "mesh.fsdp=2")
    ranks_seen = sorted(set(re.findall(r"rank=(\d)/2", stdout)))
    print(f"data parallel (d) ({card}): delete_tshirt on 2 gloo ranks sharing cuda:0 "
          f"(ranks {ranks_seen}), {seconds:.1f} s with start-up, beside (f); one run directory "
          f"{run.name}, one log, {cps}; img/s "
          f"{[round(r['images_per_sec'], 2) for r in rows if 'loss_x/mean' in r]}")

    if f_stdout.count("mesh=data 1 x fsdp 2") != DP_RANKS:
        raise AssertionError("data parallel (f): the ranks did not print the data 1 x fsdp 2 mesh")
    keys = [set().union(*map(set, r)) for r in (rows, f_rows)]
    if keys[0] != keys[1]:
        raise AssertionError(f"data parallel (f): logged keys differ from (d)'s: "
                             f"{sorted(keys[0] ^ keys[1])}")
    n = load_in_one_process(torch, f_run)
    print(f"data parallel (f) ({card}): delete_tshirt with mesh.fsdp=2 on 2 gloo ranks sharing "
          f"cuda:0, {f_seconds:.1f} s with start-up; one run directory {f_run.name}, one log "
          f"with (d)'s {len(keys[0])} keys, {f_cps}, loaded whole in one process ({n} params); "
          f"img/s {[round(r['images_per_sec'], 2) for r in f_rows if 'loss_x/mean' in r]}")
    lap("9(d) and (f)", t0)
    tensor_parallel(torch, card)
    torch.backends.cudnn.deterministic = False


def lap(label, t0):
    """Print ``label``'s seconds since ``t0``; returns the time now."""
    now = time.perf_counter()
    print(f"phase {label}: {now - t0:.1f} s")
    return now


def check_held(torch, card, label, ranks, whole, fsdp, tensor, param_bytes):
    """Each rank holds exactly the placement's share of one process's
    parameters, EMA, AdamW moments and accumulators (``whole``: one
    process's held bytes), and ``param_bytes`` of parameters."""
    held, total = rank_elements(torch, fsdp, tensor)
    # each category holds fp32 tensors of the parameters' shapes: 1 (params,
    # EMA) or 2 (AdamW's moments, the two accumulators) of them
    copies = {"params": 1, "ema": 1, "optimizer": 2, "accumulators": 2}
    want = {k: whole[k] - 4 * copies[k] * (total - held) for k in HELD}
    for r in ranks:
        if {k: r["held"][k] for k in HELD} != want or r["held"]["params"] != param_bytes:
            raise AssertionError(f"tensor ({label}) rank {r['rank']}: held bytes {r['held']}, "
                                 f"expected {want} (parameters {param_bytes})")
    print(f"tensor ({label}) ({card}): {held} of {total} parameter elements held a rank at "
          f"fsdp {fsdp} x tensor {tensor}; held bytes a rank "
          f"{json.dumps({k: ranks[0]['held'][k] for k in HELD})} against one process's "
          f"{json.dumps({k: whole[k] for k in HELD})}")


def print_ranks(card, label, ranks, one, extra=""):
    """Each rank's step seconds, its fsdp gather and reduce-scatter seconds
    (when it has them), its activation all-reduces a step, peak memory and
    launches."""
    for r in ranks:
        c, ar = r["collectives"], r["collectives"]["tensor"]
        fsdp = (f"gather s {[round(t, 4) for t in c['gather']]}, reduce-scatter s "
                f"{round(sum(c['scatter']), 4)} in {len(c['scatter'])}, " if "gather" in c else "")
        print(f"tensor ({label}) ({card}) rank {r['rank']}: step s "
              f"{[round(t, 4) for t in r['seconds']]} (one process bf16 "
              f"{[round(t, 4) for t in one['seconds']]}), {fsdp}{len(ar) // TP_STEPS} "
              f"activation all-reduces {round(sum(ar) / TP_STEPS, 4)} s a step, peak memory "
              f"{r['peak_gib']:.2f} GiB (one process {one['peak_gib']:.2f}{extra}), launches "
              f"{r['launches']}")


def tensor_parallel(torch, card):
    """9(g): the celeb step at full width on ``data=1 × tensor=2``, cut to
    TP_MB × TP_ACCUM, against one process's bf16 and fp32 steps on the same
    cut; 9(i): the same on ``data=1 × fsdp=2 × tensor=2`` against the same
    steps, beside (g); 9(h): the sd_v1 step with flash and Adafactor at
    microbatch TP_SD_MB × TP_SD_ACCUM on ``data=1 × tensor=2``, likewise
    against one process's (whose norms that are exactly 0 are printed with
    the sets of the step's samples), 9(j) the same on ``data=1 × fsdp=2 ×
    tensor=2``, beside (h); and the bf16 flash kernels at the local heads'
    shapes against their plain versions."""
    import gc

    t0 = time.perf_counter()
    ref = {name: dp_steps(torch, dtype, "cuda", steps=TP_STEPS, accum=TP_ACCUM, mb=TP_MB)
           for name, dtype in (("bf16", torch.bfloat16), ("fp32", torch.float32))}
    per_step = {"siss_reduce": TP_ACCUM, "siss_bwd": 2 * TP_ACCUM}
    fp32_path = save_fp32_ref(torch, ref, "celeb_tp")
    t0 = lap("9(g) and (i)'s one-process steps", t0)
    for label, ranks in zip("gi", collect_ranks(
            start_ranks(fp32_path, 1, TP_STEPS, tensor=2),
            start_ranks(fp32_path, 2, TP_STEPS, tensor=2, ranks=4))):
        fsdp = 1 if label == "g" else 2
        check_ranks(torch, label, ranks, ref, TP_STEPS, per_step)
        check_held(torch, card, label, ranks, ref["bf16"]["held"], fsdp, 2,
                   (TP_PARAM_BYTES if label == "g" else TP_FSDP_PARAM_BYTES)["celeb"])
        print_ranks(card, label, ranks, ref["bf16"])
    t0 = lap("9(g) beside (i)", t0)
    del ref
    gc.collect()
    torch.cuda.empty_cache()

    ref = {}
    for name, dtype in (("bf16", torch.bfloat16), ("fp32", torch.float32)):
        ref[name] = sd_steps(torch, dtype, "cuda")
        gc.collect()
        torch.cuda.empty_cache()
        for k, (norms, sets, weights) in enumerate(zip(*(ref[name][key] for key in
                                                         ("norms", "sets", "weights")))):
            zero = [n for n, v in norms.items() if v == 0.0]
            print(f"tensor (h) one process {name} step {k + 1}: samples from {sets}, importance "
                  f"weights {json.dumps(weights)}, norms exactly 0: {zero or 'none'}")
    print("tensor (h): a set with no sample in a step has importance weights of ~e^-|d| "
          "(|d| ~ 60-95 at t = 999 over 16,384 dimensions), so its gradient's squared norm "
          "underflows fp32 to exactly 0, in JAX's step too (tests/test_torch_sd_zero_norm.py)")
    fp32_path = save_fp32_ref(torch, ref, "sd")
    t0 = lap("9(h) and (j)'s one-process steps", t0)
    want = {k: TP_STEPS * n for k, n in TP_SD_PER_STEP.items()}
    for label, ranks in zip("hj", collect_ranks(
            start_ranks(fp32_path, 1, TP_STEPS, tensor=2, kind="sd"),
            start_ranks(fp32_path, 2, TP_STEPS, tensor=2, kind="sd", ranks=4))):
        param_bytes = (TP_PARAM_BYTES if label == "h" else TP_FSDP_PARAM_BYTES)["sd"]
        check_ranks(torch, label, ranks, ref, TP_STEPS, TP_SD_PER_STEP)
        for r in ranks:
            if r["launches"] != want:
                raise AssertionError(f"tensor ({label}) rank {r['rank']}: launches "
                                     f"{r['launches']}, expected {want}")
            if r["held"]["params"] != param_bytes:
                raise AssertionError(f"tensor ({label}) rank {r['rank']}: {r['held']['params']} "
                                     f"parameter bytes, expected {param_bytes}")
        print_ranks(card, label, ranks, ref["bf16"],
                    f"; scripts/fsdp_memory.py's readings at 1 x 2 with AdamW: {FSDP_MEMORY_GIB}")
        for r in ranks:
            print(f"tensor ({label}) ({card}) rank {r['rank']}: held bytes {json.dumps(r['held'])} "
                  f"(parameters whole {SD_PARAM_BYTES}), norms {r['norms'][-1]}")
        for i, shape in enumerate(TP_FLASH_SHAPES[label]):
            check_flash_case(torch, shape, torch.bfloat16, seed=100 + i)
    lap("9(h) beside (j)", t0)


# Phase 10: the examples and the SD memorization demo on the card.
EX_WORK = ROOT / "build" / "chip_smoke_examples"
EX_CELEB = ("--n", "4", "--steps", "50")
EX_SD = ("--n", "2", "--steps", str(SD_INFERENCE_STEPS))
EX_MITIGATION_ITERS = 2
EX_PROMPT = "a photo of sylvester stallone"
# The sd_v1 directory's parameters (UNet, VAE, CLIP text): 8b's UNet
# linked, the towers written in bf16 to keep the call's disk writes down
# (the modules load them in fp32).
SD_V1_PARAMS = {"unet": 859_520_964, "vae": 83_653_863, "text_encoder": 123_060_480}
# The demo's checks: memorized before, forgotten after (at most one of its
# eight samples), the keep-prompt control never classified memorized.
DEMO_MEMORIZED, DEMO_FORGOTTEN = 0.9, 0.125


def example_part(torch, card, label, fn, *args, **kwargs):
    """``fn(*args, **kwargs)`` with the launch counts and the peak memory
    set to 0 just before; prints its seconds, peak memory and launches and
    returns (its result, the launches)."""
    from siss_tpu_torch.ops import launch_counts, reset_launch_counts

    torch.cuda.empty_cache()
    reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    out = fn(*args, **kwargs)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts = dict(launch_counts)
    print(f"examples ({label}) ({card}): {seconds:.2f} s, peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB, launches {counts}")
    return out, counts, seconds


def no_launches(label, counts):
    if any(counts.values()) or not {"siss_reduce", "siss_bwd", "flash_fwd"} <= set(counts):
        raise AssertionError(f"examples ({label}): launch counts {counts}, expected every "
                             "kernel 0")


def write_sd_v1_dir(torch, root: Path) -> None:
    """An SD-1.x directory of random weights: 8b's UNet (the fp32 ``unet``
    item of its cached run's final bundle, linked, not copied), random VAE
    and CLIP text state dicts in bf16 under diffusers and transformers
    names, and 8b's synthetic ``tokenizer/``."""
    import shutil

    from siss_tpu_torch.models import (AutoencoderKLConfig, CLIPTextConfig, build_clip_text,
                                       build_vae)

    found = sorted((SD_WORK / "out_cached").glob(f"*/checkpoint-{SD_STEPS}/unet/item.pt"))
    if len(found) != 1:
        raise AssertionError(f"8b's cached run left {len(found)} final unet items: {found}")
    unet = found[0]
    shutil.copytree(SD_WORK / "pretrained" / "tokenizer", root / "tokenizer")
    (root / "unet").mkdir(parents=True)
    (root / "unet" / "diffusion_pytorch_model.bin").symlink_to(unet)
    n = sum(v.numel() for v in torch.load(unet, mmap=True, weights_only=True).values())
    if n != SD_V1_PARAMS["unet"]:
        raise AssertionError(f"8b's sd_v1 unet: {n} parameters, expected {SD_V1_PARAMS['unet']}")
    for sub, build, cfg, fname in (
            ("vae", build_vae, AutoencoderKLConfig.sd_v1(), "diffusion_pytorch_model.bin"),
            ("text_encoder", build_clip_text, CLIPTextConfig.sd_v1(), "pytorch_model.bin")):
        sd = build(cfg, seed=0, device="cuda").state_dict()
        n = sum(v.numel() for v in sd.values())
        if n != SD_V1_PARAMS[sub]:
            raise AssertionError(f"sd_v1 {sub}: {n} parameters, expected {SD_V1_PARAMS[sub]}")
        (root / sub).mkdir(parents=True)
        torch.save({k: v.to("cpu", torch.bfloat16) for k, v in sd.items()}, root / sub / fname)
        del sd
    torch.cuda.empty_cache()


def phase_examples(torch, card, bundle: Path, base: Path):
    """10(a)–(e): the six examples through their ``main``s on the card."""
    import importlib.util
    import shutil

    import numpy as np
    from PIL import Image

    from siss_tpu_torch.examples import (celeb_sampler, inference_time_mitigation,
                                         likelihood_eval, membership_curve, sd_inference,
                                         sscd_score)

    # (a) celeb_sampler on 7b's bundle
    out, counts, seconds = example_part(
        torch, card, "a", celeb_sampler.main,
        ["--checkpoint", str(bundle), *EX_CELEB, "--out", str(EX_WORK / "celeb.png")])
    no_launches("a", counts)
    side = 2 * 256 + 3 * 2
    png = np.asarray(Image.open(EX_WORK / "celeb.png"))
    if png.shape != (side, side, 3) or not np.array_equal(png, out["grid"]):
        raise AssertionError(f"celeb_sampler: PNG of shape {png.shape}, expected ({side}, {side}, "
                             "3), the grid it returned")
    if out["images"].shape != (4, 256, 256, 3) or not np.isfinite(out["images"]).all():
        raise AssertionError("celeb_sampler: samples not 4 finite 256² images")
    print(f"celeb_sampler ({card}): 4 samples of 50 DDPM steps at celebahq_256 in "
          f"{seconds:.2f} s = {4 / seconds:.2f} img/s (model load included)")

    # (b) likelihood_eval on two t-shirts of the real npz
    with np.load(TSHIRT_DATA) as z:
        tshirts = z["images"][z["labels"] == 10][:2, ..., 0]
    paths = []
    for i, img in enumerate(tshirts):
        paths.append(str(EX_WORK / f"tshirt_{i}.png"))
        Image.fromarray(img).save(paths[-1])
    out, counts, seconds = example_part(
        torch, card, "b", likelihood_eval.main,
        ["--checkpoint", f"{base}/latest", "--images", *paths, "--arch", "mnist_tshirt"])
    no_launches("b", counts)
    if not (np.isfinite(out["bpd"]).all() and out["bpd"].shape == (2,) and out["nfe"] > 0):
        raise AssertionError(f"likelihood_eval: bits/dim {out['bpd']}, nfe {out['nfe']}")
    print(f"likelihood_eval ({card}): RK45 on the pretrain's unet, bits/dim "
          f"{[round(float(b), 4) for b in out['bpd']]}, nfe {out['nfe']}, {seconds:.2f} s")

    # (c) membership_curve on the same, at its defaults
    argv = ["--checkpoint", f"{base}/latest", "--npz", str(TSHIRT_DATA), "--out",
            str(EX_WORK / "membership.png")]
    if importlib.util.find_spec("matplotlib") is not None:
        out, counts, seconds = example_part(torch, card, "c", membership_curve.main, argv)
        if not (EX_WORK / "membership.png").stat().st_size:
            raise AssertionError("membership_curve: empty plot")
        timesteps, losses = out["timesteps"], out["losses"]
    else:
        (timesteps, losses), counts, seconds = example_part(
            torch, card, "c", membership_curve.membership_losses,
            membership_curve.parse_args(argv))
        print("membership_curve: the plot was not drawn: matplotlib is not installed on this "
              "machine; membership_losses computed the curve")
    no_launches("c", counts)
    if (timesteps != list(range(0, 1000, 50)) or len(losses) != 20
            or not all(len(pair) == 2 and all(math.isfinite(v) for v in pair) for pair in losses)):
        raise AssertionError(f"membership_curve: timesteps {timesteps}, losses {losses}")
    print(f"membership_curve ({card}): 32 images x 16 noises a set, (keep, forget) by timestep "
          + json.dumps({t: [round(a, 4), round(b, 4)] for t, (a, b) in zip(timesteps, losses)}))

    # (d) the SD examples at full sd_v1 width
    model = EX_WORK / "sd_v1"
    _, _, seconds = example_part(torch, card, "d: sd_v1 directory", write_sd_v1_dir, torch, model)
    size = sum(f.stat().st_size for f in model.rglob("*") if f.is_file() and not f.is_symlink())
    print(f"sd_v1 directory ({card}): the towers' {size / 1e9:.3f} GB (bf16) written and 8b's "
          f"unet linked in {seconds:.2f} s")
    aug = EX_WORK / "aug_prompt.npz"
    out, counts, seconds = example_part(
        torch, card, "d: inference_time_mitigation", inference_time_mitigation.main,
        ["--model", str(model), "--prompt", EX_PROMPT, "--iters", str(EX_MITIGATION_ITERS),
         "--out", str(aug)])
    no_launches("d", counts)
    grads = out["token_grads"]
    if out["embeds"].shape != (1, SD_PROMPT_TOKENS, 768) or grads.shape != (SD_PROMPT_TOKENS,) \
            or not np.isfinite(grads).all() or not np.isfinite(out["embeds"]).all():
        raise AssertionError(f"inference_time_mitigation: embeddings {out['embeds'].shape}, "
                             f"token gradients {grads.shape}, finite "
                             f"{np.isfinite(grads).all()}")
    print(f"inference_time_mitigation ({card}): {EX_MITIGATION_ITERS} iterations, token gradient "
          f"norms max {grads.max():.4g}, mean {grads.mean():.4g}; augmented embeddings "
          f"{out['embeds'].shape} moved by {np.abs(out['embeds']).max():.4g} at most")
    for label, src in (("prompt", ["--prompt", EX_PROMPT]),
                       ("prompt-embeds", ["--prompt-embeds", str(aug)])):
        out, counts, seconds = example_part(
            torch, card, f"d: sd_inference --{label}", sd_inference.main,
            ["--model", str(model), *src, *EX_SD, "--out", str(EX_WORK / f"sd_{label}.png")])
        no_launches("d", counts)
        norms = out["text_norm"]
        if out["images"].shape != (2, 512, 512, 3) or not np.isfinite(out["images"]).all() \
                or norms.shape != (SD_INFERENCE_STEPS, 2) or not np.isfinite(norms).all() \
                or not np.isfinite(out["uncond_norm"]).all():
            raise AssertionError(f"sd_inference --{label}: images {out['images'].shape}, "
                                 f"norms {norms.shape}, not all finite")
        print(f"sd_inference --{label} ({card}): 2 samples of {SD_INFERENCE_STEPS} CFG DDIM "
              f"steps at 512² in {seconds:.2f} s (model load included); text-cond noise norm by "
              f"step {np.round(norms.mean(axis=1), 3).tolist()}")
    shutil.rmtree(model)

    # (e) sscd_score with the scripted stand-in
    write_sscd_standin(torch, EX_WORK / "sscd.pt")
    images = [str(SD_WORK / "images" / f"img_{i}.png") for i in (1, 2)]
    out, counts, seconds = example_part(
        torch, card, "e", sscd_score.main,
        ["--model", str(EX_WORK / "sscd.pt"), "--target", str(SD_WORK / "images" / "img_0.png"),
         "--images", *images])
    no_launches("e", counts)
    sims = out["sims"]
    if sims.shape != (2,) or not (np.abs(sims) <= 1 + 1e-6).all():
        raise AssertionError(f"sscd_score: similarities {sims}")
    print(f"sscd_score ({card}): {[round(float(v), 6) for v in sims]}")


# The demo's process: its main at the defaults, its launch counts set to 0
# just before and read just after, its result as the last line.
DEMO_RUNNER = """
import json, sys, time
sys.path.insert(0, sys.argv[1])
import torch
from siss_tpu_torch import sd_memorization_demo as demo
from siss_tpu_torch.ops import launch_counts, reset_launch_counts
reset_launch_counts()
t0 = time.perf_counter()
out = demo.main(sys.argv[2:])
torch.cuda.synchronize()
print(json.dumps({"result": out, "launches": dict(launch_counts),
                  "seconds": time.perf_counter() - t0,
                  "peak_gib": torch.cuda.max_memory_allocated() / 2**30}))
"""


# 10(f)'s check of the demo's CUDA-graphed ``fit``: each of its two loops
# for FIT_STEPS steps (the eager warm-up and five replays).
FIT_STEPS = 8


def check_fit_graph(torch, card):
    """The demo's two pretraining loops as ``fit`` runs them on the card (a
    CUDA graph after the warm-up) and eagerly, from the same weights and
    draws, FIT_STEPS steps each, under the demo's switches (TF32 off, cuDNN
    deterministic): every step's loss and the parameters after the last
    must be equal bit for bit."""
    from siss_tpu_torch import sd_memorization_demo as demo
    from siss_tpu_torch.diffusion import sd_noise_schedule
    from siss_tpu_torch.models import build_unet_cond, build_vae

    unet_cfg, vae_cfg, text_cfg = demo.demo_configs()
    n, res = 9, 32   # the demo's 8 keep images and the memorized one, 32²
    gen = torch.Generator(device="cuda").manual_seed(0)
    x_all = torch.rand((n, res, res, 3), generator=gen, device="cuda") * 2 - 1
    e_all = torch.randn((n, text_cfg.max_position_embeddings, text_cfg.hidden_size),
                        generator=gen, device="cuda") * 0.5
    latent = (res // vae_cfg.scale_factor, res // vae_cfg.scale_factor, vae_cfg.latent_channels)
    schedule = sd_noise_schedule(device="cuda")

    def run(graphed):
        g = torch.Generator(device="cuda").manual_seed(1)
        losses = {"vae": [], "unet": []}
        vae = build_vae(vae_cfg, seed=0, device="cuda")
        demo.fit(vae.parameters(), FIT_STEPS,
                 lambda: torch.randn((n, *latent), generator=g, device="cuda"),
                 lambda noise: demo.vae_loss(vae, x_all, noise),
                 lambda i, loss: losses["vae"].append(loss.item()), graphed)
        vae.requires_grad_(False).eval()
        unet = build_unet_cond(unet_cfg, seed=1, device="cuda")
        demo.fit(unet.parameters(), FIT_STEPS,
                 lambda: demo.draw_unet_batch(g, n, 16, 0.33, latent,
                                              schedule.num_train_timesteps),
                 lambda draws: demo.unet_loss(unet, vae, schedule, x_all, e_all, draws),
                 lambda i, loss: losses["unet"].append(loss.item()), graphed)
        return losses, [p.detach().clone() for m in (vae, unet) for p in m.parameters()]

    deterministic, torch.backends.cudnn.deterministic = torch.backends.cudnn.deterministic, True
    try:
        (g_loss, g_params), (e_loss, e_params) = run(True), run(False)
    finally:
        torch.backends.cudnn.deterministic = deterministic
    dloss = max(abs(a - b) for k in g_loss for a, b in zip(g_loss[k], e_loss[k]))
    dparam = max(float((a - b).abs().max()) for a, b in zip(g_params, e_params))
    print(f"demo fit ({card}): {FIT_STEPS} steps of each loop graphed after "
          f"{demo.WARMUP_STEPS} eager ones, against eager: losses "
          f"{json.dumps(g_loss)}; largest loss difference {dloss:.3g}, largest parameter "
          f"difference {dparam:.3g}")
    if g_loss != e_loss or not all(torch.equal(a, b) for a, b in zip(g_params, e_params)):
        raise AssertionError(f"demo fit: the CUDA-graphed loops differ from the eager ones "
                             f"(losses by {dloss:.3g}, parameters by {dparam:.3g})")


def start_demo():
    """10(f): ``sd_memorization_demo`` at its defaults in a process of its
    own, from phase 6 on (it needs nothing of the script's phases, and
    both it and phases 6–7b are host-bound; the card has room for both);
    its output goes to a file. Returns the process and the file."""
    import shutil

    shutil.rmtree(EX_WORK, ignore_errors=True)
    EX_WORK.mkdir(parents=True)
    log = open(EX_WORK / "demo.log", "w")
    proc = subprocess.Popen([sys.executable, "-c", DEMO_RUNNER, str(ROOT), "--out",
                             str(EX_WORK / "demo")], stdout=log, stderr=subprocess.STDOUT)
    return proc, log


def finish_demo(card, proc, log):
    """Wait for the demo, print its output, and check that it memorized,
    forgot and kept its control, with 2 reduce and 4 SISS backward
    launches a step and none of the flash kernels."""
    proc.wait(timeout=900)
    log.close()
    lines = (EX_WORK / "demo.log").read_text().splitlines()
    results = [line for line in lines if line.startswith('{"result": ')]
    print("\n".join(f"demo: {line}" for line in lines if line not in results))
    if proc.returncode != 0 or len(results) != 1:
        raise AssertionError(f"sd_memorization_demo exited {proc.returncode} with "
                             f"{len(results)} result lines")
    run = json.loads(results[0])
    before, after, series = (run["result"][k] for k in ("before", "after", "series"))
    counts, steps = run["launches"], 100   # the demo's --unlearn-steps
    expected = {k: 0 for k in counts} | {"siss_reduce": 2 * steps, "siss_bwd": 4 * steps}
    print(f"sd_memorization_demo ({card}): {run['seconds']:.2f} s from phase 6 on, peak memory "
          f"{run['peak_gib']:.3f} GiB; before {json.dumps(before)}; after {json.dumps(after)}; "
          f"deletion_fraction_0 by image {series}; launches {counts} "
          f"({counts['siss_reduce'] / steps:g} reduce, {counts['siss_bwd'] / steps:g} SISS "
          "backward a step)")
    if counts != expected:
        raise AssertionError(f"sd_memorization_demo: launch counts {counts}, expected {expected}")
    if before["mem_fraction"] < DEMO_MEMORIZED:
        raise AssertionError(f"sd_memorization_demo: mem_fraction {before['mem_fraction']} before "
                             f"unlearning, below {DEMO_MEMORIZED}: not memorized")
    if after["mem_fraction"] > DEMO_FORGOTTEN:
        raise AssertionError(f"sd_memorization_demo: mem_fraction {after['mem_fraction']} after "
                             f"{steps} steps, above {DEMO_FORGOTTEN}: not forgotten")
    if before["keep_fraction"] != 0.0 or after["keep_fraction"] != 0.0:
        raise AssertionError(f"sd_memorization_demo: keep_fraction {before['keep_fraction']} → "
                             f"{after['keep_fraction']}, expected 0.0 before and after")


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

    def phase(label, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        print(f"phase {label}: {time.perf_counter() - t0:.1f} s")
        return out

    record = phase("3", phase_kernels, torch)
    record.update(phase("4", phase_flash_kernels, torch))
    fp32_counts = phase("5", phase_tiny_step_parity, torch)
    phase("10(f): the demo's fit", check_fit_graph, torch, card)
    demo, demo_log = start_demo()
    try:
        base, siss_ratios = phase("6", phase_tshirt, torch, card)
        phase("6b", phase_tshirt_objectives, torch, card, base, siss_ratios)
        phase("6c", phase_classifier, torch, card, base)
        celeb_counts = phase("7", phase_main_path, torch)
        bundle = phase("7b", phase_celeb_task, torch, card)
        phase("7c", phase_serve, torch, card, bundle)
        sd_counts = phase("8", phase_sd_path, torch)
        phase("8b", phase_sd_task, torch, card)
        phase("8c(b)", phase_sd_knobs, torch, card)
        phase("8c(a)", phase_sd_fast_path, torch, card)
        phase("9", phase_data_parallel, torch, card, base)
        t10 = time.perf_counter()
        phase("10(a)–(e)", phase_examples, torch, card, bundle, base)
        finish_demo(card, demo, demo_log)
    finally:
        if demo.poll() is None:
            demo.kill()
            demo.wait()
    print(f"phase 10: {time.perf_counter() - t10:.1f} s")

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
    written = io_written()
    print(f"total {time.perf_counter() - t_start:.1f} s; written (/proc/self/io) wchar "
          f"{written['wchar'] / 2**30:.3f} GiB, write_bytes {written['write_bytes'] / 2**30:.3f} "
          "GiB")
    print(f"card: {card}")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
