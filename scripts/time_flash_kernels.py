#!/usr/bin/env python3
"""Time the PyTorch/CUDA port's flash-attention kernels at the SD UNet's
two shapes, for the ``siss_tpu_torch`` package of any checkout.

    python3 scripts/time_flash_kernels.py [--root CHECKOUT] [--label NAME]
                                          [--dtype bfloat16|float32]

Imports ``siss_tpu_torch`` from CHECKOUT (default: this repository), builds
its kernels there, and prints one JSON line: the card, and the median
device ms of one launch of flash_fwd, flash_bwd_dkv and flash_bwd_dq at
(B, H, N, d) = (1, 8, 4096, 40) and (1, 8, 1024, 80) in the given type
(default bf16), operands in the UNet's [B, N, H, d] layout, timed as
``chip_smoke.py`` times them (CUDA events over 20-launch batches, the
device kept ahead of the host), and ptxas' registers, spills and C75xx
warnings for the tensor-core kernels at those head dims; in fp32 also the
forward's, the dK/dV's and the dQ's largest errors against a float64
reference beside the fp32 plain versions' (``chip_smoke.float64_errors``,
``chip_smoke.float64_dkv_errors``, ``chip_smoke.float64_dq_errors``). To
compare two
checkouts on one card, run it for each in turns (A, B, B, A) in one
command; the parent of a change can be unpacked with ``git archive`` into
a git-ignored directory for that.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import math
import statistics
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
SHAPES = ((1, 8, 4096, 40), (1, 8, 1024, 80))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", type=Path, default=REPO, help="checkout whose siss_tpu_torch to time")
    ap.add_argument("--label", default=None, help="name for the JSON line (default: the root)")
    ap.add_argument("--dtype", choices=("bfloat16", "float32"), default="bfloat16",
                    help="the operands' type (default bfloat16)")
    args = ap.parse_args()
    sys.path.insert(0, str(args.root.resolve()))
    import torch

    if not torch.cuda.is_available():
        print("no CUDA card: the kernels run only on one", file=sys.stderr)
        return 2
    # chip_smoke.py of this repository, for its timing and card helpers.
    spec = importlib.util.spec_from_file_location("chip_smoke", REPO / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    from siss_tpu_torch.ops import build
    from siss_tpu_torch.ops import flash_attention as fa

    build.load()
    dtype = getattr(torch, args.dtype)
    times, float64, dkv_float64, dq_float64 = {}, {}, {}, {}
    for shape in SHAPES:
        B, H, N, d = shape
        gen = torch.Generator(device="cuda").manual_seed(7)
        q, k, v, do = (torch.randn((B, N, H, d), generator=gen, device="cuda")
                       .to(dtype).transpose(1, 2) for _ in range(4))
        scale = 1.0 / math.sqrt(d)
        o, lse = fa.flash_fwd(q, k, v, scale)
        di = fa.row_dot(o, do)
        if dtype == torch.float32:
            float64[str(list(shape))] = smoke.float64_errors(
                torch, q, k, v, scale, o, lse, *fa.flash_attention_plain(q, k, v, scale))
            dkv_float64[str(list(shape))] = smoke.float64_dkv_errors(
                torch, q, k, v, lse, do, di, scale, *fa.flash_bwd_dkv(q, k, v, lse, do, di, scale),
                *fa.flash_bwd_dkv_plain(q, k, v, lse, do, di, scale))
            dq_float64[str(list(shape))] = smoke.float64_dq_errors(
                torch, q, k, v, lse, do, di, scale, fa.flash_bwd_dq(q, k, v, lse, do, di, scale),
                fa.flash_bwd_dq_plain(q, k, v, lse, do, di, scale))
        fns = {"flash_fwd": lambda: fa.flash_fwd(q, k, v, scale),
               "flash_bwd_dkv": lambda: fa.flash_bwd_dkv(q, k, v, lse, do, di, scale),
               "flash_bwd_dq": lambda: fa.flash_bwd_dq(q, k, v, lse, do, di, scale)}
        for name, fn in fns.items():
            times[f"{name} {list(shape)}"] = statistics.median(smoke.gpu_ms(torch, fn))
    ptxas = {fn: r for fn, r in smoke.ptxas_report(build.build_info["log"]).items()
             if fn.endswith(("<40>", "<80>"))}
    print(json.dumps({"label": args.label or str(args.root), "dtype": args.dtype,
                      "card": smoke.card_line(), "build_s": build.build_info["seconds"],
                      "ms": times, "ptxas": ptxas, "fwd_float64_err_vs_plain": float64,
                      "dkv_float64_err_vs_plain": dkv_float64,
                      "dq_float64_err_vs_plain": dq_float64}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
