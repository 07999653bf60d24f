"""The port's spans (``siss_tpu_torch.utils.spans``): nesting, parents and
roots, threads, spans open across a start or a stop of recording, the
clock they share with ``torch.profiler``, the phases the train steps and
the samplers record, and that recording changes no result."""

import threading
import time

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from siss_tpu_torch.diffusion import NoiseSchedule, sampling
from siss_tpu_torch.train import (
    DeletionStepConfig,
    TrainState,
    build_deletion_train_step,
    build_optimizer,
    build_pretrain_step,
)
from siss_tpu_torch.train.step import draw_microbatch_randomness
from siss_tpu_torch.utils import spans
from siss_tpu_torch.utils.spans import span

A, MB, HW, C = 2, 3, 4, 3


@pytest.fixture(autouse=True)
def no_recording():
    """Every test starts and ends with recording off."""
    spans.stop_recording()
    yield
    spans.stop_recording()


def recorded(fn):
    spans.start_recording()
    try:
        fn()
    finally:
        got = spans.stop_recording()
    return got


def test_nesting_parents_roots_and_threads():
    def work(tag):
        with span(f"{tag}.outer"):
            with span(f"{tag}.mid"):
                with span(f"{tag}.inner"):
                    pass
            with span(f"{tag}.sibling"):
                pass

    def both():
        other = threading.Thread(target=work, args=("b",))
        with span("a.outer"):
            other.start()
            work("a")
            other.join(timeout=30)
        assert not other.is_alive()

    got = recorded(both)
    by = {s.name: s for s in got if s.name != "a.outer" or s.parent is None}
    a_roots = [s for s in got if s.name == "a.outer"]
    assert len(a_roots) == 2 and len(got) == 9
    top = next(s for s in a_roots if s.parent is None)
    nested = next(s for s in a_roots if s.parent is not None)
    assert nested.parent == top.id and nested.root == top.id == top.root
    assert by["a.mid"].parent == nested.id and by["a.inner"].parent == by["a.mid"].id
    assert by["a.sibling"].parent == nested.id
    assert {s.root for s in got if s.name.startswith("a.")} == {top.id}
    assert by["b.outer"].parent is None and by["b.outer"].root == by["b.outer"].id
    assert by["b.inner"].root == by["b.outer"].id and by["b.inner"].parent == by["b.mid"].id
    assert by["b.outer"].thread != top.thread == threading.get_ident()
    assert len({s.id for s in got}) == len(got)
    for s in got:
        assert s.start_ns <= s.end_ns
        if s.parent is not None:
            parent = next(p for p in got if p.id == s.parent)
            assert parent.start_ns <= s.start_ns and s.end_ns <= parent.end_ns
    assert [s.start_ns for s in got] == sorted(s.start_ns for s in got)


def test_spans_open_when_recording_starts_or_stops():
    with span("t.before"):
        with span("t.closed_inside"):
            spans.start_recording()
        with span("t.whole"):
            pass
        with span("t.open_at_stop"):
            got = spans.stop_recording()
            stopped = time.time_ns()
        with span("t.after"):
            pass
    assert spans.stop_recording() == []          # nothing once recording stopped
    by = {s.name: s for s in got}
    assert set(by) == {"t.before", "t.closed_inside", "t.whole", "t.open_at_stop"}
    before, inside, whole = by["t.before"], by["t.closed_inside"], by["t.whole"]
    # An open span keeps its true start; one open at the stop ends there.
    assert before.start_ns <= inside.start_ns < whole.start_ns
    assert inside.end_ns <= whole.start_ns and whole.end_ns <= by["t.open_at_stop"].start_ns
    assert by["t.open_at_stop"].end_ns == before.end_ns <= stopped
    assert inside.parent == before.id and whole.parent == before.id
    assert by["t.open_at_stop"].parent == before.id and before.parent is None
    assert {s.root for s in got} == {before.id}


def test_nothing_is_recorded_when_off():
    for _ in range(3):
        with span("t.off"):
            pass
    assert spans.stop_recording() == []
    assert recorded(lambda: None) == []
    got = recorded(lambda: span("t.on").__enter__().__exit__(None, None, None))
    assert [s.name for s in got] == ["t.on"]


def test_a_decorated_function_is_one_span_a_call():
    @span("t.call")
    def twice(x):
        """Doubles."""
        return 2 * x

    got = recorded(lambda: [twice(1), twice(2)])
    assert [s.name for s in got] == ["t.call", "t.call"] and twice(3) == 6
    assert twice.__name__ == "twice" and twice.__doc__ == "Doubles."


def clock_bounds(calls=20):
    """Spans around ``torch.mm`` under a CPU-activity profiler; each
    encloses its ``aten::mm`` event to within 50 µs. Returns the least and
    the most offset (ns) of the spans' clock from the profiler's that every
    call allows: a span's clock is read, in truth, after its annotation
    opens and before ``aten::mm`` starts, and after ``aten::mm`` ends and
    before the annotation closes."""
    a, out = torch.randn(256, 256), torch.empty(256, 256)
    for _ in range(3):
        torch.mm(a, a, out=out)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        spans.start_recording()
        for _ in range(calls):
            with span("t.mm"):
                torch.mm(a, a, out=out)      # no allocation or free inside the span
        got = [s for s in spans.stop_recording() if s.name == "t.mm"]
    events = sorted(prof.profiler.kineto_results.events(), key=lambda e: e.start_ns())
    mms = [e for e in events if e.name() == "aten::mm"]
    annotations = [e for e in events if e.name() == "t.mm"]
    assert len(got) == len(mms) == len(annotations) == calls
    least, most = [], []
    for s, mm, ann in zip(got, mms, annotations):
        assert s.start_ns <= mm.start_ns() + 50_000 and mm.end_ns() - 50_000 <= s.end_ns, (
            s, mm.start_ns(), mm.end_ns())
        least += [s.start_ns - mm.start_ns(), s.end_ns - ann.end_ns()]
        most += [s.start_ns - ann.start_ns(), s.end_ns - mm.end_ns()]
    return max(least), min(most)


def test_spans_share_the_profilers_clock():
    """A span around ``torch.mm`` encloses the profiler's ``aten::mm``
    event within 50 µs at each end, and the calls pin the offset between
    the two clocks to within 50 µs. (On a virtual machine the profiler's
    cycle counter has run 1.8% fast of the host's clocks for a while; a
    span read on those clocks then drifted off the profiler's events by
    about 90 µs every 5 ms.) The host's own delays (the profiler's
    callbacks) widen each call's bounds, by more than 100 µs on a loaded
    CPU, so the best of a few rounds of calls decides; an offset between
    the clocks would show in every round."""
    rounds = [clock_bounds() for _ in range(5)]
    assert all(least <= most for least, most in rounds), rounds   # one offset fits every call
    assert any(-50_000 <= least and most <= 50_000 for least, most in rounds), rounds


class Tiny(torch.nn.Module):
    """ε(x, t) = tanh(x W + b) + w·t/1000 on NHWC images."""

    def __init__(self, seed=0):
        super().__init__()
        g = torch.Generator().manual_seed(seed)
        self.lin = torch.nn.Linear(C, C)
        self.t_w = torch.nn.Parameter(torch.randn(C, generator=g))
        with torch.no_grad():
            self.lin.weight.copy_(torch.randn(C, C, generator=g) / C)
            self.lin.bias.copy_(torch.randn(C, generator=g) / 10)

    def forward(self, x, t):
        return torch.tanh(self.lin(x)) + self.t_w * (t.float() / 1000)[:, None, None, None]


def tiny_apply(model, x, t, cond):
    del cond
    return model(x, t)


def deletion_step(**kw):
    """(one deletion step's outputs: parameters, EMA and metrics; the spans
    it recorded, or None) on fixed weights, batch and draws."""
    def run(record):
        model = Tiny()
        opt, sched = build_optimizer({"_target_": "torch.optim.AdamW", "lr": 1e-2},
                                     model.parameters())
        cfg = DeletionStepConfig(**dict(dict(loss_params=(("lambd", 0.5), ("superfactor", 0.5)),
                                             scaling_norm=3.0,
                                             grad_accum_steps=A, t_min=100, t_max=900,
                                             use_ema=True), **kw))
        step = build_deletion_train_step(tiny_apply, NoiseSchedule.create(1000, device="cpu"),
                                         cfg)
        gen = torch.Generator().manual_seed(1)
        batch = {k: torch.randn(A, MB, HW, HW, C, generator=gen) for k in ("all", "deletion")}
        draws = draw_microbatch_randomness(gen, A, MB, (HW, HW, C), 100, 900, "cpu",
                                           uniform_target=cfg.loss_fn == "erasediff")
        state = TrainState.create(model, opt, sched, use_ema=True)
        if record:
            spans.start_recording()
        state, metrics = step(state, batch, draws=draws)
        got = spans.stop_recording() if record else None
        return ([p.detach().clone() for p in model.parameters()],
                [e.clone() for e in state.ema.params], metrics), got
    return run


def pretrain_step(record):
    model = Tiny()
    opt, sched = build_optimizer({"_target_": "torch.optim.AdamW", "lr": 1e-2},
                                 model.parameters())
    step = build_pretrain_step(tiny_apply, NoiseSchedule.create(1000, device="cpu"))
    gen = torch.Generator().manual_seed(2)
    state = TrainState.create(model, opt, sched, use_ema=True)
    if record:
        spans.start_recording()
    state, metrics = step(state, torch.randn(MB, HW, HW, C, generator=gen), gen)
    got = spans.stop_recording() if record else None
    return ([p.detach().clone() for p in model.parameters()],
            [e.clone() for e in state.ema.params], metrics), got


PULLS = ["train.pull_x", "train.pull_a"]
PER_MICROBATCH = {
    "fused_siss": ["train.forward", "train.siss"] + PULLS,
    "shared_forward": ["train.forward"] + PULLS,
    "batched_dual_backward": ["train.forward", "train.siss", "train.pulls"],
    "scalar": ["train.forward", "train.pull"],
    "two_forward": ["train.forward", "train.pull_x", "train.forward", "train.pull_a"],
    "erasediff": ["train.forward", "train.pull_x", "train.forward", "train.pull_a"],
    "param_cast": ["train.forward", "train.siss"] + PULLS,
}
STEPS = {
    "fused_siss": deletion_step(),
    "shared_forward": deletion_step(fused_siss=False),
    "batched_dual_backward": deletion_step(batched_dual_backward=True),
    "scalar": deletion_step(loss_fn="simple_neg_del"),
    "two_forward": deletion_step(loss_fn="double_forward_with_neg_del"),
    "erasediff": deletion_step(loss_fn="erasediff"),
    "param_cast": deletion_step(param_cast_dtype="bfloat16"),
}
TAIL = ["train.accumulate", "train.stats", "train.surgery", "train.optimizer", "train.ema"]


def leaves(got):
    """The names of the spans no other span encloses, in order."""
    parents = {s.parent for s in got}
    return [s.name for s in got if s.id not in parents]


@pytest.mark.parametrize("path", list(STEPS))
def test_each_gradient_path_records_its_phases(path):
    _, got = STEPS[path](True)
    (root,) = [s for s in got if s.parent is None]
    assert root.name == "train.step" and {s.root for s in got} == {root.id}
    head = ["train.gather"] if path == "param_cast" else []
    micro = PER_MICROBATCH[path] + ["train.accumulate"]
    assert leaves(got) == head + ["train.accumulate"] + micro * A + TAIL
    assert all(s.parent == root.id for s in got if s is not root)


def test_pretraining_records_its_phases():
    _, got = pretrain_step(True)
    (root,) = [s for s in got if s.parent is None]
    assert root.name == "train.step"
    assert leaves(got) == ["train.forward", "train.pull", "train.accumulate", "train.surgery",
                           "train.optimizer", "train.ema", "train.stats"]


def assert_identical(a, b):
    params_a, ema_a, metrics_a = a
    params_b, ema_b, metrics_b = b
    assert all(torch.equal(x, y) for x, y in zip(params_a + ema_a, params_b + ema_b))
    assert sorted(metrics_a) == sorted(metrics_b)
    assert all(torch.equal(metrics_a[k], metrics_b[k]) for k in metrics_a)


@pytest.mark.parametrize("path", ["fused_siss", "two_forward", "pretrain"])
def test_recording_changes_no_step_result(path):
    run = pretrain_step if path == "pretrain" else STEPS[path]
    assert_identical(run(True)[0], run(False)[0])


def tiny_eps(x, t, cond):
    w = torch.linspace(-0.5, 0.5, x.shape[-1])
    eps = torch.tanh(x * w) * (t.float() / 1000)[:, None, None, None]
    if cond is not None:
        eps = eps + cond.mean(dim=(1, 2))[:, None, None, None]
    return eps


STEPS_N = 4
SCHEDULE = NoiseSchedule.create(1000, device="cpu")
SAMPLERS = {
    "ddpm": lambda: sampling.sample_ddpm(tiny_eps, SCHEDULE, (2, HW, HW, C), STEPS_N,
                                         generator=torch.Generator().manual_seed(3)),
    "ddim_cfg": lambda: sampling.sample_ddim_cfg(
        tiny_eps, SCHEDULE, (2, HW, HW, C), torch.ones(2, 5, 8), torch.zeros(2, 5, 8), 7.5,
        STEPS_N, track_noise_norm=True, eta=0.5, generator=torch.Generator().manual_seed(3)),
    "dpm_solver_2m": lambda: sampling.sample_dpm_solver_2m(
        tiny_eps, SCHEDULE, (2, HW, HW, C), STEPS_N, generator=torch.Generator().manual_seed(3)),
}


@pytest.mark.parametrize("name", list(SAMPLERS))
def test_samplers_record_a_request_of_unet_calls_and_updates(name):
    out = {}
    got = recorded(lambda: out.setdefault("x", SAMPLERS[name]()))
    (root,) = [s for s in got if s.parent is None]
    assert root.name == "sample.request"
    assert [s.name for s in got if s is not root] == ["sample.unet", "sample.update"] * STEPS_N
    assert all(s.parent == root.id == s.root for s in got if s is not root)
    again = SAMPLERS[name]()
    first, second = (out["x"], again) if name != "ddim_cfg" else (out["x"][0], again[0])
    assert torch.equal(first, second)                  # recording changed no image
    if name == "ddim_cfg":
        assert all(torch.equal(out["x"][1][k], again[1][k]) for k in again[1])


class Event:
    """The part of a kineto event that ``profile_step`` reads (times in µs)."""

    def __init__(self, name, start, end, kind, correlation=0, device="cuda"):
        self._name, self._start, self._end, self._kind = name, start * 1000, end * 1000, kind
        self._correlation = correlation
        self._device = getattr(torch.autograd.DeviceType, device.upper())

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
        return self._correlation if self._kind == "kernel" else 0


def test_profile_step_counts_kernels_by_the_span_of_their_launch():
    """A kernel launched from another thread inside a span is the span's;
    overlapping kernels count once towards the busy time."""
    from siss_tpu_torch.profile_step import _kernels_by_span

    recorded = [spans.Span("train.step", 1, None, 1, 0, 1_000_000, 1),
                spans.Span("train.pull_x", 2, 1, 1, 100_000, 500_000, 1)]
    events = [Event("cudaLaunchKernel", 50, 52, "cuda_runtime", 7, "cpu"),
              Event("k_step", 60, 160, "kernel", 7),
              Event("cudaLaunchKernel", 200, 202, "cuda_runtime", 8, "cpu"),   # engine thread
              Event("k_pull", 150, 400, "kernel", 8),
              Event("aten::mm", 300, 301, "cpu_op", 9, "cpu"),
              Event("k_orphan", 700, 710, "kernel", 9),
              Event("train.pull_x", 150, 400, "gpu_user_annotation")]
    by_span, busy, by_kernel = _kernels_by_span(events, recorded)
    assert by_span == {"train.step": pytest.approx(0.1), "train.pull_x": pytest.approx(0.25),
                       "(no span)": pytest.approx(0.01)}
    assert busy == pytest.approx(0.35) and by_kernel["k_pull"] == [pytest.approx(0.25), 1]
