"""The traced part of a window: ``torch.profiler`` over a few steps or
calls, reduced to device-kernel intervals, the device's busy time (the
union of those intervals), idle gaps named by what the host was doing in
them, and time by kernel family.

Only device activity is traced (CUPTI: kernels, copies and the CUDA
runtime calls that launched them): recording every host op as well more
than doubled a host-bound SD step. The traced span runs from one
synchronise to another and is timed on the host clock; a gap between
kernels is named by the CUDA runtime call the host was in at its middle
("cudaLaunchKernel": the host was launching the next one), or as host work
outside the runtime (Python and dispatch). Device-side user annotations are
spans, not work, and are left out, as ``siss_tpu_torch/profile_step.py``
leaves them out.
"""

import dataclasses
import time
from collections import defaultdict
from typing import Callable, List, Tuple

import numpy as np
import torch

NAMED_GAPS = 200

# Kernel-name fragments → family, first match wins: a frozen copy of
# siss_tpu_torch/profile_step.py's table, so that a change to the program
# cannot move the yardstick.
FAMILIES = (
    ("siss::", "siss epilogue (this repo's CUDA kernels)"),
    ("flash::", "flash attention (this repo's CUDA kernels)"),
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


def family(name: str) -> str:
    for frag, fam in FAMILIES:
        if frag in name:
            return fam
    return "other"


@dataclasses.dataclass
class Trace:
    window_s: float
    kernels: List[Tuple[str, float]]      # (name, seconds) of each device op in the span
    busy_s: float
    gaps: List[Tuple[str, float]]         # (host op active in the gap, seconds)

    def seconds_where(self, keep: Callable[[str], bool]) -> float:
        return sum(s for n, s in self.kernels if keep(n))

    def by_family(self):
        out = defaultdict(float)
        for n, s in self.kernels:
            out[family(n)] += s
        return dict(out)

    def breakdown(self, top: int = 10):
        ops = defaultdict(float)
        for n, s in self.kernels:
            ops[n[:160]] += s
        gaps = defaultdict(float)
        for n, s in self.gaps:
            gaps[n[:160]] += s
        return {"device_ops": sorted(([n, s] for n, s in ops.items()), key=lambda x: -x[1])[:top],
                "idle_gaps": sorted(([n, s] for n, s in gaps.items()), key=lambda x: -x[1])[:top]}


class Capture:
    """``torch.profiler`` over the work between ``start()`` and ``stop()``,
    each of which first synchronises."""

    def start(self):
        from torch.profiler import ProfilerActivity, profile

        torch.cuda.synchronize()
        self.prof = profile(activities=[ProfilerActivity.CUDA])
        self.prof.__enter__()
        self.t0 = time.perf_counter()

    def stop(self) -> "Trace":
        torch.cuda.synchronize()
        window_s = time.perf_counter() - self.t0
        self.prof.__exit__(None, None, None)
        return reduce_events(self.prof.profiler.kineto_results.events(), window_s)


HOST_WORK = "host work outside the CUDA runtime"


def reduce_events(events, window_s: float) -> Trace:
    """Busy time, kernels and named gaps of one traced span of ``window_s``
    seconds, from the profiler's events."""
    cuda = torch.autograd.DeviceType.CUDA
    kernels, host = [], []
    for e in events:
        if e.device_type() == cuda:
            if not e.is_user_annotation() and e.end_ns() > e.start_ns():
                kernels.append((e.name(), e.start_ns(), e.end_ns()))
        elif not e.is_user_annotation():
            host.append((e.start_ns(), e.end_ns(), e.name()))
    if not kernels:
        raise RuntimeError("the traced span holds no device op")
    kernels.sort(key=lambda k: k[1])
    busy, gaps, cursor = 0, [], kernels[0][1]
    for _, s, t in kernels:
        if s > cursor:
            gaps.append((cursor, s))
        if t > cursor:
            busy += t - max(s, cursor)
            cursor = t
    # Each of the longest gaps is named by the innermost host event active
    # at its middle; the rest are summed under one name, and the span's two
    # ends (before the first kernel, after the last) under another.
    gaps.sort(key=lambda g: g[0] - g[1])
    starts = np.array([h[0] for h in host], dtype=np.int64)
    ends = np.array([h[1] for h in host], dtype=np.int64)
    named = []
    for s, t in gaps[:NAMED_GAPS]:
        mid = (s + t) // 2
        inner = np.flatnonzero((starts <= mid) & (ends > mid))
        name = host[inner[np.argmin(ends[inner] - starts[inner])]][2] if inner.size else HOST_WORK
        named.append((name, (t - s) / 1e9))
    rest = sum(t - s for s, t in gaps[NAMED_GAPS:])
    if rest:
        named.append((f"{HOST_WORK} or the runtime, gaps shorter than the {NAMED_GAPS} longest",
                      rest / 1e9))
    edges = window_s - (cursor - kernels[0][1]) / 1e9
    if edges > 0:
        named.append(("the span's ends: synchronise to first kernel, last kernel to synchronise",
                      edges))
    return Trace(window_s=window_s, kernels=[(n, (t - s) / 1e9) for n, s, t in kernels],
                 busy_s=busy / 1e9, gaps=named)
