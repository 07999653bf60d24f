#!/usr/bin/env python3
"""Run chosen phases of a checkout's ``chip_smoke.py`` on the card, to
compare two checkouts' step times on one card.

    python3 scripts/time_phases.py [--root CHECKOUT] PHASE [PHASE ...]

PHASE names a ``phase_<PHASE>`` function of CHECKOUT's ``chip_smoke.py``
that takes ``(torch)`` or ``(torch, card)``: ``main_path`` (the celeb
16 × 4 step), ``celeb_task`` (the shipped celeb task through the CLI),
``sd_path`` (the SD 1 × 16 step), ``sd_task`` (the SD task through the
CLI), among others. Imports ``siss_tpu_torch`` from CHECKOUT (default: this
repository), builds its kernels there, turns TF32 off as ``chip_smoke.py``
does, and runs each phase with its own checks and printed lines, then its
seconds. To compare two checkouts, unpack the parent with ``git archive``
into a git-ignored directory and run both in turns (A, B, B, A), each in a
process of its own, in one command.
"""

from __future__ import annotations

import argparse
import importlib.util
import inspect
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", type=Path, default=REPO, help="checkout whose phases to run")
    ap.add_argument("phases", nargs="+", help="phase names, e.g. sd_path celeb_task")
    args = ap.parse_args()
    root = args.root.resolve()
    sys.path.insert(0, str(root))
    import torch

    if not torch.cuda.is_available():
        print("no CUDA card: the phases run only on one", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    spec = importlib.util.spec_from_file_location("chip_smoke", root / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    sys.modules["chip_smoke"] = smoke
    spec.loader.exec_module(smoke)
    phases = [getattr(smoke, f"phase_{name}") for name in args.phases]
    from siss_tpu_torch.ops import build

    build.load()
    card = smoke.card_line()
    print(f"checkout {root} on {card}: kernels built in {build.build_info['seconds']:.2f} s")
    for name, fn in zip(args.phases, phases):
        t0 = time.perf_counter()
        fn(*((torch, card) if len(inspect.signature(fn).parameters) == 2 else (torch,)))
        print(f"phase {name} of {root}: {time.perf_counter() - t0:.2f} s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
