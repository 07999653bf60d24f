"""The numbers a run compares with the reference, each against its limit.

Training (the first ``check_steps`` steps; the same numbers of the late
step, after the window, come as ``late_*`` from ``loops/unlearn_step.py``):
- ``loss_gap``: the largest relative gap, over those steps, of the mean
  keep and forget ε-MSE;
- ``weight_gap``: the largest gap, over those steps, of the keep and
  forget importance weights' mean and std (each microbatch's, averaged).
  The weights' scale is 1 (their mean under the mixture), so the gap is
  absolute. They come from the inputs alone and agree to round-off; a step
  that leaves rows out moves them;
- ``grad_gap``: over the leaves, the largest gap between the program's and
  the reference's norm of the first step's clipped gradient (the program's
  as AdamW holds it: its first moment over 1 − β1), as a share of the
  reference's norm of that leaf or of the median leaf, whichever is larger;
- ``grad_median_gap``: the median over the leaves of that gap, steady from
  seed to seed where the worst leaf is not (§6 of PERF.md);
- ``change_gap``: the same as ``grad_gap`` for each leaf's change after the last of those
  steps (and each EMA leaf's). Leaves whose reference gradient is under a
  thousandth of the median leaf's move by round-off alone and are left out.

Sampling (the answers drawn from the seed among those the window finished):
- ``image_gap``: the largest relative L2 gap of a checked image;
- ``noise_norm_gap``: under guidance, the largest relative gap of a checked
  image's per-step noise norms.
"""

from __future__ import annotations

import math
import statistics

ROUND_OFF_LEAF = 1e-3


def _leaf_gaps(prog: dict, ref: dict, names):
    """[(gap, leaf)] over ``names``, largest first."""
    med = statistics.median(ref.values())
    return sorted(((abs(prog[n] - ref[n]) / max(ref[n], med), n) for n in names), reverse=True)


def _step_gap(prog, ref):
    return max(abs(p - r) / abs(r) for ps, rs in zip(prog, ref) for p, r in zip(ps, rs))


def _moved(ref: dict):
    """The change's leaves whose reference gradient is no round-off."""
    med = statistics.median(ref["grad"].values())
    return [n for n in ref["change"] if ref["grad"][n.removeprefix("ema.")] >= ROUND_OFF_LEAF * med]


def training(prog: dict, ref: dict) -> dict:
    return {"loss_gap": _step_gap(prog["loss"], ref["loss"]),
            "weight_gap": max(abs(p - r) for ps, rs in zip(prog["weights"], ref["weights"])
                              for p, r in zip(ps, rs)),
            "grad_gap": _leaf_gaps(prog["grad"], ref["grad"], ref["grad"])[0][0],
            "grad_median_gap": statistics.median(
                g for g, _ in _leaf_gaps(prog["grad"], ref["grad"], ref["grad"])),
            "change_gap": _leaf_gaps(prog["change"], ref["change"], _moved(ref))[0][0]}


def worst_leaves(prog: dict, ref: dict, n: int = 3) -> dict:
    """The ``n`` leaves of largest gradient and change gap, for the log."""
    return {"grad": [(k, round(g, 6)) for g, k in _leaf_gaps(prog["grad"], ref["grad"],
                                                             ref["grad"])[:n]],
            "change": [(k, round(g, 6)) for g, k in _leaf_gaps(prog["change"], ref["change"],
                                                               _moved(ref))[:n]]}


def sampling(prog: dict, ref: dict) -> dict:
    out = {"image_gap": max(float((prog[k]["images"] - ref[k]["images"]).norm()
                                  / ref[k]["images"].norm()) for k in ref)}
    if any(ref[k]["norms"] is not None for k in ref):
        out["noise_norm_gap"] = max(float(((prog[k]["norms"] - ref[k]["norms"]).abs()
                                           / ref[k]["norms"]).max()) for k in ref)
    return out


def judge(numbers: dict, limits: dict) -> bool:
    """Every number finite, and within its limit where the cell's limits
    give one (a number without a limit is reported, not compared)."""
    return all(math.isfinite(v) and (limits.get(k) is None or v <= limits[k])
               for k, v in numbers.items())
