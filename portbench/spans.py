"""Device time and idle by the program's spans (``siss_tpu_torch.utils.spans``)
over a traced part of a window.

    python3 -m portbench.spans --workload <cell> --seed <n> --seconds <s>

runs a cell's set-up and window as ``portbench.run --trace 1`` does, with a
capture that also records the program's spans, and prints the device time
by span; it checks no answer and reports no metric.

Each kernel goes to the innermost recorded span that contains its launch,
the start of the CUDA runtime or driver call whose correlation id it
carries (a host event named ``cuda…`` or ``cu…``), on any thread: the
autograd engine launches a backward's kernels from its own thread while
the caller waits inside its span. Each gap in the union of kernel
intervals goes to the innermost span that contains its midpoint; gaps
whose midpoint lies in the profiler's own "Activity Buffer Request" are
counted apart. Kernel time with no span, or whose launch the
trace lacks, is ``unattributed``. A span's host self time is its length
less what its child spans cover.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import statistics
import time
from collections import defaultdict
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from portbench import trace

UNATTRIBUTED = "unattributed"
PROFILER_BUFFER = "Activity Buffer Request"


@dataclasses.dataclass
class SpanTrace(trace.Trace):
    """A ``Trace`` with each kernel's times and the spans recorded over it."""

    timed: List[Tuple[str, Optional[int], int, int]] = dataclasses.field(default_factory=list)
    # (name, launch ns or None, start ns, end ns) of each kernel, by start
    spans: list = dataclasses.field(default_factory=list)         # utils.spans.Span
    buffer: List[Tuple[int, int]] = dataclasses.field(default_factory=list)
    # the profiler's own buffer requests on the host (start ns, end ns)
    start_ns: int = 0                   # when recording started


def _is_launch(e) -> bool:
    """A CUDA runtime (``cuda…``) or driver (``cu…``) call on the host: the
    profiler's other host events (its buffer requests, PyTorch's ops,
    user annotations) are named otherwise."""
    return not e.is_user_annotation() and e.name().startswith("cu")


def timed_kernels(events) -> Tuple[List[Tuple[str, Optional[int], int, int]],
                                   List[Tuple[int, int]]]:
    """Each device op of ``events`` (user annotations left out, as
    ``trace.reduce_events`` leaves them out) with its launch time, by start;
    and the profiler's buffer requests."""
    cuda = torch.autograd.DeviceType.CUDA
    launches: Dict[int, int] = {}
    kernels, buffer = [], []
    for e in events:
        if e.device_type() == cuda:
            if not e.is_user_annotation() and e.end_ns() > e.start_ns():
                kernels.append(e)
        elif e.name() == PROFILER_BUFFER:
            buffer.append((e.start_ns(), e.end_ns()))
        elif _is_launch(e):
            launches[e.correlation_id()] = e.start_ns()
    out = [(k.name(), launches.get(k.linked_correlation_id() or k.correlation_id()),
            k.start_ns(), k.end_ns()) for k in kernels]
    return sorted(out, key=lambda k: k[2]), buffer


def innermost(spans: Sequence, times: np.ndarray) -> np.ndarray:
    """For each time, the index in ``spans`` of the shortest span that
    contains it (start <= t < end), or -1."""
    best = np.full(times.shape, -1, dtype=np.int64)
    length = np.full(times.shape, np.iinfo(np.int64).max, dtype=np.int64)
    for i, s in enumerate(spans):
        inside = (times >= s.start_ns) & (times < s.end_ns) & (s.end_ns - s.start_ns < length)
        best[inside] = i
        length[inside] = s.end_ns - s.start_ns
    return best


def gaps(timed) -> List[Tuple[int, int]]:
    """The gaps between the kernels' union of intervals (the span's two
    ends left out, as ``trace.reduce_events`` counts them apart)."""
    out, cursor = [], None
    for _, _, s, t in timed:
        if cursor is not None and s > cursor:
            out.append((cursor, s))
        cursor = t if cursor is None else max(cursor, t)
    return out


def self_ns(spans: Sequence, since: int = 0) -> List[int]:
    """Each span's length after ``since`` less the part its children cover."""
    def length(s):
        return max(s.end_ns - max(s.start_ns, since), 0)

    covered = defaultdict(int)
    for s in spans:
        if s.parent is not None:
            covered[s.parent] += length(s)
    return [length(s) - covered[s.id] for s in spans]


def by_span(tr: SpanTrace, units: int = 1) -> Dict[str, dict]:
    """Per span name, per unit (step or UNet call): device ms of the kernels
    it launched, launches, idle ms, host self ms, the median lag (ms) from
    launch to kernel start, and whether it is a leaf (no span of it
    encloses another); and ``unattributed``, with the idle that the
    profiler's buffer requests hold under ``profiler buffer``."""
    spans = tr.spans
    parents = {s.parent for s in spans}
    names = [s.name for s in spans] + [UNATTRIBUTED]
    rows = {n: {"device_ms": 0.0, "launches": 0, "idle_ms": 0.0, "host_self_ms": 0.0,
                "lags": [], "leaf": True} for n in names}
    for s, own in zip(spans, self_ns(spans, tr.start_ns)):
        rows[s.name]["host_self_ms"] += own / 1e6
        rows[s.name]["leaf"] &= s.id not in parents
    rows[UNATTRIBUTED]["leaf"] = False
    # A launch the trace lacks reads -1, inside no span; index -1 of
    # ``names`` is ``unattributed``.
    launch = np.array([-1 if k[1] is None else k[1] for k in tr.timed], dtype=np.int64)
    for (_, launched, start, end), i in zip(tr.timed, innermost(spans, launch)):
        row = rows[names[i]]
        row["device_ms"] += (end - start) / 1e6
        row["launches"] += 1
        if launched is not None:
            row["lags"].append((start - launched) / 1e6)
    idle = gaps(tr.timed)
    mids = np.array([(s + t) // 2 for s, t in idle], dtype=np.int64)
    in_buffer = np.zeros(mids.shape, dtype=bool)
    for b0, b1 in tr.buffer:
        in_buffer |= (mids >= b0) & (mids < b1)
    buffered = 0.0
    for (s, t), i, buf in zip(idle, innermost(spans, mids), in_buffer):
        if buf:
            buffered += (t - s) / 1e6
        else:
            rows[names[i]]["idle_ms"] += (t - s) / 1e6
    out = {}
    for n, row in rows.items():
        lags = row.pop("lags")
        out[n] = {k: v / units if k.endswith("_ms") else v for k, v in row.items()}
        out[n]["launches"] = row["launches"] / units
        out[n]["lag_ms"] = statistics.median(lags) if lags else None
    out["profiler buffer"] = {"idle_ms": buffered / units}
    return out


def leaf_share(table: Dict[str, dict], prefix: str) -> float:
    """The share of all kernel time launched in a leaf span named
    ``prefix``…"""
    total = sum(r.get("device_ms", 0.0) for r in table.values())
    leaves = sum(r["device_ms"] for n, r in table.items()
                 if n.startswith(prefix) and r.get("leaf"))
    return leaves / total if total else 0.0


class SpanCapture(trace.Capture):
    """``trace.Capture`` that also records the program's spans over the
    traced work; ``stop()`` gives a ``SpanTrace``. A program without spans
    gives a trace without them."""

    def start(self):
        super().start()
        self.recorder = _recorder()
        if self.recorder is not None:
            self.recorder.start_recording()
        self.start_ns = time.time_ns()

    def stop(self) -> SpanTrace:
        torch.cuda.synchronize()
        recorded = self.recorder.stop_recording() if self.recorder is not None else []
        tr = super().stop()
        timed, buffer = timed_kernels(self.prof.profiler.kineto_results.events())
        return SpanTrace(**vars(tr), timed=timed, spans=recorded, buffer=buffer,
                         start_ns=self.start_ns)


def _recorder():
    try:
        from siss_tpu_torch.utils import spans
    except ImportError:
        return None
    return spans


def main(argv=None):
    from portbench import drive, manifest, run

    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    args = parser.parse_args(argv)
    man = manifest.load()
    cell = manifest.cell(man, args.workload)
    config = manifest.config(man, cell["config"])
    traffic = manifest.traffic(cell["traffic"])
    loop = manifest.loop(traffic["kind"])
    loop.Capture = SpanCapture      # the loops take their capture from their own namespace
    device = torch.device("cuda", 0)
    for line in run.card_lines(device):
        print(line)
    torch.backends.cuda.matmul.allow_tf32 = bool(config["tf32"])
    torch.backends.cudnn.allow_tf32 = bool(config["tf32"])
    work = loop.Work(drive.Model(config), traffic, args.seed, device)
    work.set_up()
    drive.sync(device)
    window = work.window(args.seconds, True, print)
    tr, units = window["trace"], window["units"]
    table = by_span(tr, units)
    prefix = "train." if traffic["kind"] == "unlearn_step" else "sample."
    print(f"busy {tr.busy_s / units * 1e3:.3f} ms of {tr.window_s / units * 1e3:.3f} ms a "
          f"{work.per}; kernel time in a leaf {prefix}* span: "
          f"{100 * leaf_share(table, prefix):.3f}%")
    for name, row in sorted(table.items(), key=lambda kv: -kv[1].get("device_ms", 0.0)):
        print(f"  {name:24s} " + json.dumps(row))
    print(json.dumps({"workload": args.workload, "seed": args.seed, "units": units,
                      "busy_ms": tr.busy_s / units * 1e3, "window_ms": tr.window_s / units * 1e3,
                      "leaf_share": leaf_share(table, prefix), "by_span": table}))


if __name__ == "__main__":
    main()
