"""Device time and idle by span (``portbench.spans``), worked by hand on
synthetic kernel, runtime and span events."""

import pytest
import torch

from portbench import spans, trace

US = 1000           # the events' clock is in ns; the cases are written in µs
T0 = 1_700_000_000_000_000_000


class Event:
    """The part of a ``torch.profiler`` kineto event the reduction reads."""

    def __init__(self, name, start, end, kind, correlation=0, linked=0, device="cuda"):
        self._name, self._start, self._end = name, T0 + start * US, T0 + end * US
        self._kind, self._correlation, self._linked = kind, correlation, linked
        self._device = (torch.autograd.DeviceType.CUDA if device == "cuda"
                        else torch.autograd.DeviceType.CPU)

    def name(self):
        return self._name

    def start_ns(self):
        return self._start

    def end_ns(self):
        return self._end

    def device_type(self):
        return self._device

    def is_user_annotation(self):
        return "user_annotation" in self._kind

    def correlation_id(self):
        return self._correlation

    def linked_correlation_id(self):
        return self._linked


def kernel(name, start, end, correlation):
    return Event(name, start, end, "kernel", correlation, correlation)


def launch(start, correlation, name="cudaLaunchKernel"):
    return Event(name, start, start + 2, "cuda_runtime", correlation, device="cpu")


class Span:
    def __init__(self, name, id, parent, start, end, root=1):
        self.name, self.id, self.parent, self.root = name, id, parent, root
        self.start_ns, self.end_ns = T0 + start * US, T0 + end * US


STEP = [Span("train.step", 1, None, 0, 1000), Span("train.forward", 2, 1, 100, 300),
        Span("train.pull", 3, 1, 300, 800), Span("train.optimizer", 4, 1, 850, 950)]
EVENTS = [
    launch(110, 1), kernel("fwd_a", 200, 300, 1),
    launch(150, 2), kernel("fwd_b", 300, 350, 2),
    launch(400, 3), kernel("bwd_a", 420, 600, 3),       # launched by the engine's thread
    launch(500, 4, "cuLaunchKernel"), kernel("bwd_b", 600, 700, 4),
    launch(860, 5), kernel("adam", 880, 900, 5),
    launch(980, 6), kernel("tail", 985, 990, 6),
    kernel("no_launch", 995, 999, 99),                  # its launch is not in the trace
    Event("train.pull", 400, 700, "gpu_user_annotation"),   # the device's view of a span
    Event("aten::mm", 398, 402, "cpu_op", correlation=3, device="cpu"),   # another id space
    Event(spans.PROFILER_BUFFER, 780, 800, "cuda_runtime", device="cpu"),
]


def span_trace(step=STEP, events=EVENTS):
    tr = trace.reduce_events(events, window_s=1000e-6)
    timed, buffer = spans.timed_kernels(events)
    return spans.SpanTrace(**vars(tr), timed=timed, spans=step, buffer=buffer, start_ns=T0)


def test_kernels_keep_their_launch_times():
    timed, buffer = spans.timed_kernels(EVENTS)
    assert [(n, None if l is None else (l - T0) // US) for n, l, _, _ in timed] == [
        ("fwd_a", 110), ("fwd_b", 150), ("bwd_a", 400), ("bwd_b", 500), ("adam", 860),
        ("tail", 980), ("no_launch", None)]
    assert buffer == [(T0 + 780 * US, T0 + 800 * US)]


def test_device_time_idle_and_host_time_by_span():
    table = spans.by_span(span_trace())
    ms = 1e-3      # one µs
    want = {
        "train.forward": dict(device_ms=150 * ms, launches=2, idle_ms=0.0, host_self_ms=200 * ms,
                              lag_ms=120 * ms, leaf=True),
        "train.pull": dict(device_ms=280 * ms, launches=2, idle_ms=70 * ms,
                           host_self_ms=500 * ms, lag_ms=60 * ms, leaf=True),
        "train.optimizer": dict(device_ms=20 * ms, launches=1, idle_ms=85 * ms,
                                host_self_ms=100 * ms, lag_ms=20 * ms, leaf=True),
        "train.step": dict(device_ms=5 * ms, launches=1, idle_ms=5 * ms, host_self_ms=200 * ms,
                           lag_ms=5 * ms, leaf=False),
        spans.UNATTRIBUTED: dict(device_ms=4 * ms, launches=1, idle_ms=0.0, host_self_ms=0.0,
                                 lag_ms=None, leaf=False),
    }
    assert set(table) == set(want) | {"profiler buffer"}
    for name, row in want.items():
        for k, v in row.items():
            want_v = v if v is None or isinstance(v, bool) else pytest.approx(v)
            assert table[name][k] == want_v, (name, k)
    # The gap 700–880 has its middle in the profiler's buffer request.
    assert table["profiler buffer"]["idle_ms"] == pytest.approx(180 * ms)
    assert spans.leaf_share(table, "train.") == pytest.approx(450 / 459)
    # Every kernel and gap is counted once.
    tr = span_trace()
    assert sum(r.get("device_ms", 0.0) for r in table.values()) == pytest.approx(459 * ms)
    assert sum(r["idle_ms"] for r in table.values()) == pytest.approx(
        1e3 * (tr.window_s - tr.busy_s) - 200 * ms - 1 * ms)   # less the span's two ends


def test_per_unit_and_the_window_start():
    """Two units halve each number; a span open before recording counts
    host time from the recording's start only."""
    table = spans.by_span(span_trace(), units=2)
    assert table["train.pull"]["device_ms"] == pytest.approx(0.14)
    assert table["train.pull"]["launches"] == 1
    tr = span_trace()
    tr.start_ns = T0 + 500 * US
    table = spans.by_span(tr)
    assert table["train.step"]["host_self_ms"] == pytest.approx(0.1)   # 500–1000 less 300 + 100
    assert table["train.pull"]["host_self_ms"] == pytest.approx(0.3)
    assert table["train.forward"]["host_self_ms"] == 0.0


def test_the_innermost_span_wins_on_any_thread():
    """A span on another thread that overlaps the step: each time goes to
    the shortest span that contains it."""
    other = Span("sample.unet", 9, None, 380, 450, root=9)
    table = spans.by_span(span_trace(STEP + [other]))
    assert table["sample.unet"]["device_ms"] == pytest.approx(0.18)     # bwd_a, launched at 400
    assert table["train.pull"]["device_ms"] == pytest.approx(0.1)
    assert table["sample.unet"]["idle_ms"] == pytest.approx(0.07)       # the gap 350–420


def test_no_spans_leaves_everything_unattributed():
    table = spans.by_span(span_trace(step=[]))
    assert set(table) == {spans.UNATTRIBUTED, "profiler buffer"}
    assert table[spans.UNATTRIBUTED]["device_ms"] == pytest.approx(0.459)
    assert spans.leaf_share(table, "train.") == 0.0
