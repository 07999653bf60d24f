"""Readings that set the limits of a cell's numbers, on the card at the
cell's own size (or anywhere at the sizes a test gives), many seeds in one
process.

    python3 -m portbench.control --workload <cell> --seeds 11 12 13 --control 3
    python3 -m portbench.control --workload <cell> --seeds 11 12 13 --fault half_batch

Each seed is a whole run (a window of ``--seconds``) and prints one JSON
line with the numbers the run compared: sound readings of the program, or,
with ``--fault``, of the program with that fault planted
(``portbench.faults``). For the first ``--control`` seeds the line also
holds the control's numbers: the reference put in the program's place and
computed a precision below the configuration's (float8 e4m3 with one scale
per tensor for every operand of a matrix product or convolution, where the
configuration computes in bfloat16), against the float32 reference, on the
same inputs and, for a training cell's late step, from the same copy of
the program's state.
"""

from __future__ import annotations

import argparse
import gc
import json

import torch

from portbench import faults, manifest, run

BELOW = {"bfloat16": "float8", "float16": "float8"}


def below(workload: str, root=manifest.ROOT) -> str:
    man = manifest.load(root)
    return BELOW[manifest.config(man, manifest.cell(man, workload)["config"], root)
                 ["compute_dtype"]]


def control_numbers(workload: str, seed: int, seconds: float = 2.0, device="cuda",
                    root=manifest.ROOT) -> dict:
    """The control's numbers after one run of ``workload``."""
    res = run.execute(workload, seed, seconds, False, device=device, root=root,
                      log=lambda *a: None, control=below(workload, root))
    return res["control"]


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", type=int, nargs="+", required=True)
    parser.add_argument("--control", type=int, default=0,
                        help="how many of the seeds, from the first, also read the control")
    parser.add_argument("--fault", choices=faults.FAULTS)
    parser.add_argument("--seconds", type=float, default=10.0)
    args = parser.parse_args(argv)
    man = manifest.load()
    traffic = manifest.traffic(manifest.cell(man, args.workload)["traffic"])
    for i, seed in enumerate(args.seeds):
        undo = (faults.plant(args.fault, traffic["kind"], traffic, seed)
                if args.fault else lambda: None)
        try:
            res = run.execute(args.workload, seed, args.seconds, False, log=lambda *a: None,
                              control=below(args.workload) if i < args.control else None)
        finally:
            undo()
        out = {"workload": args.workload, "seed": seed, "fault": args.fault,
               "correct": res["correct"],
               "numbers": {k: c["value"] for k, c in res["checks"].items()}}
        if "control" in res:
            out["control"] = res["control"]
        print(json.dumps(out), flush=True)
        gc.collect()
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
