#!/usr/bin/env python3
"""Device memory of the SD step on two ranks sharing one card: the ``data``
axis against the ``fsdp`` axis.

    python3 scripts/fsdp_memory.py [--steps 2] [--out build/fsdp_memory.json]

Runs the full-width sd_v1 step of ``chip_smoke.py`` phase 8
(``profile_step.make_sd_path``: flash attention, AdamW, bf16 autocast over
fp32 parameters) at a global microbatch of 2 with no accumulation, on two
gloo ranks sharing ``cuda:0`` (one row each): first on a ``data=2`` mesh,
then on ``data=1 × fsdp=2``, ``--steps`` steps each. Prints, for each rank,
the peak device memory of the steps (``torch.cuda.max_memory_allocated``
after the model is built), the bytes it holds (parameters, AdamW moments,
the two gradient accumulators) and each step's seconds, with the card's
name and power limit, and writes them as JSON to ``--out``.
"""

from __future__ import annotations

import argparse
import json
import multiprocessing as mp
import socket
import subprocess
import sys
import time
import traceback
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
MESHES = {"data2": (2, 1), "fsdp2": (1, 2)}   # name -> (data, fsdp)
RANKS = 2


def rank_main(rank: int, port: int, data: int, fsdp: int, steps: int, queue) -> None:
    try:
        import torch

        sys.path.insert(0, str(ROOT))
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        from siss_tpu_torch.diffusion import sd_noise_schedule
        from siss_tpu_torch.parallel import (MeshConfig, destroy_distributed,
                                             initialize_distributed, make_rank_mesh, rank_rows)
        from siss_tpu_torch.profile_step import SD_STEP_KW, make_sd_path
        from siss_tpu_torch.train import (DeletionStepConfig, build_deletion_train_step,
                                          cond_unet_eps_apply)
        from siss_tpu_torch.train.step import draw_microbatch_randomness

        dev = initialize_distributed("cuda:0", "gloo", rank=rank, world_size=RANKS,
                                     init_method=f"tcp://localhost:{port}", timeout_s=900)
        mesh = make_rank_mesh(MeshConfig(data=data, fsdp=fsdp))
        state, _, _, _ = make_sd_path(dev, mesh)
        step = build_deletion_train_step(cond_unet_eps_apply, sd_noise_schedule(device=dev),
                                         DeletionStepConfig(**{**SD_STEP_KW,
                                                               "grad_accum_steps": 1}))
        cfg = state.model.config
        hw, ch, mb = cfg.sample_size, cfg.in_channels, RANKS
        gen = torch.Generator(device=dev).manual_seed(0)
        batch = {k: torch.randn(1, mb, hw, hw, ch, generator=gen, device=dev)
                 for k in ("all", "deletion")}
        prompt = torch.randn(77, cfg.cross_attention_dim, generator=gen, device=dev)
        batch["conditioning"] = prompt.expand(1, mb, *prompt.shape)
        batch = {k: rank_rows(v, 1).contiguous() for k, v in batch.items()}
        acc_bytes = []
        zeros = state.sharding.zeros

        def recording_zeros(dtype):
            out = zeros(dtype)
            acc_bytes.append(sum(t.numel() * t.element_size() for t in out))
            return out

        state.sharding.zeros = recording_zeros
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        seconds = []
        for _ in range(steps):
            draws = draw_microbatch_randomness(gen, 1, mb, (hw, hw, ch), 999, 1000, dev)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, _ = step(state, batch, draws=draws)
            torch.cuda.synchronize()
            seconds.append(time.perf_counter() - t0)
        held = {**state.held_bytes(), "accumulators": sum(acc_bytes[-2:])}
        del held["ema"]   # the SD step keeps no EMA
        queue.put({"rank": rank, "peak_bytes": torch.cuda.max_memory_allocated(),
                   "held_bytes": held, "step_seconds": seconds,
                   "split_params": sum(bool(lay.axes) for lay in state.sharding.layouts)})
        destroy_distributed()
    except Exception:
        queue.put({"rank": rank, "error": traceback.format_exc()})


def run_mesh(name: str, steps: int) -> list:
    data, fsdp = MESHES[name]
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    ctx = mp.get_context("spawn")
    queue = ctx.Queue()
    procs = [ctx.Process(target=rank_main, args=(r, port, data, fsdp, steps, queue))
             for r in range(RANKS)]
    for proc in procs:
        proc.start()
    try:
        ranks = sorted((queue.get(timeout=1200) for _ in procs), key=lambda r: r["rank"])
    finally:
        for proc in procs:
            proc.join(timeout=60)
            if proc.is_alive():
                proc.kill()
    for r in ranks:
        if "error" in r:
            raise RuntimeError(f"{name} rank {r['rank']} failed:\n{r['error']}")
    return ranks


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--steps", type=int, default=2)
    parser.add_argument("--out", default=str(ROOT / "build" / "fsdp_memory.json"))
    args = parser.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("fsdp_memory.py needs an NVIDIA card", file=sys.stderr)
        return 2
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip()
    result = {"card": card, "meshes": {}}
    for name in MESHES:
        ranks = run_mesh(name, args.steps)
        result["meshes"][name] = ranks
        for r in ranks:
            held = {k: round(v / 1e9, 4) for k, v in r["held_bytes"].items()}
            print(f"{name} rank {r['rank']} ({card}): peak {r['peak_bytes'] / 2**30:.2f} GiB, "
                  f"held GB {json.dumps(held)}, split params {r['split_params']}, step s "
                  f"{[round(t, 4) for t in r['step_seconds']]}")
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(result, indent=1))
    print(json.dumps({k: [r["peak_bytes"] for r in v] for k, v in result["meshes"].items()}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
