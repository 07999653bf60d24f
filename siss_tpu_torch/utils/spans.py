"""Named spans at the phase boundaries of the port's step and sampler.

    with span("train.forward"):
        ...

    @span("train.step")
    def step(...): ...

Recording or not, a span costs one clock reading and a push and a pop on
its thread's stack of open spans (under 1 µs on the host). Between
``start_recording()`` and ``stop_recording()`` every span that ends, and
every span still open at the stop (its end cut there), is kept in memory
and handed over as a ``Span`` by ``stop_recording()``; nothing is written
out. A span open when recording starts is kept with its true start.
Recording is switched on by a caller alone; sessions do not nest.

``parent`` is the enclosing span on the same thread, ``root`` the outermost
one: the spans of one step or one sampler call share it. ``start_ns`` and
``end_ns`` are on the clock of ``torch.profiler``'s events (epoch
nanoseconds), so a span can be set against the kernels of a trace taken
over the same work. The profiler stamps its events with an approximate
clock (the CPU's cycle counter) and maps it onto epoch time linearly
between the session's start and end; spans read the same counter and map
it the same way between the recording's start and stop, so a recording
held inside a profiler session stays on the profiler's clock even where
the counter's rate strays from the host's clocks. The autograd engine
launches a backward's kernels from its own thread while the calling thread
waits inside its span, so a kernel belongs to the span open when it was
launched, on whichever thread.

While a ``torch.profiler`` session is active each span also opens
``torch.profiler.record_function`` under its name, so the profiler's own
trace carries the same phases; the span's clock readings lie inside it.
"""

from __future__ import annotations

import functools
import itertools
import threading
import time
import weakref
from typing import Dict, List, NamedTuple, Optional, Tuple

import torch
import torch.autograd.profiler as _profiler
from torch.profiler import record_function


class Span(NamedTuple):
    name: str
    id: int
    parent: Optional[int]
    root: int
    start_ns: int
    end_ns: int
    thread: int


class _Stack(list):
    """A thread's open spans, ``(name, id, start, record_function or
    None)`` each, outermost first."""

    __slots__ = ("thread", "__weakref__")


# The profiler's approximate clock, where this PyTorch exposes it.
_now = getattr(torch._C._profiler, "_get_approximate_time", time.perf_counter_ns)
_ids = itertools.count(1)
_local = threading.local()
# Every live thread's stack, for the spans open at a stop; a stack goes
# with its thread's local storage.
_open: "weakref.WeakValueDictionary[int, _Stack]" = weakref.WeakValueDictionary()
_recorded: Optional[list] = None     # raw spans: (name, id, parent, root, start, end, thread)
_start: Tuple[int, int] = (0, 0)     # (clock, epoch ns) when recording started


def _new_stack() -> _Stack:
    stack = _local.stack = _Stack()
    stack.thread = threading.get_ident()
    _open[stack.thread] = stack
    return stack


def _raw(entry, below: list, thread: int, end: int) -> tuple:
    """The raw span of the stack entry ``entry`` under the entries
    ``below`` it, ending at ``end``."""
    name, sid, start, _ = entry
    return (name, sid, below[-1][1] if below else None, below[0][1] if below else sid,
            start, end, thread)


class _Named:
    """The span context manager of one name. Its state lives on the
    thread's stack, so it may be entered again and from several threads."""

    __slots__ = ("name",)

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        try:
            stack = _local.stack
        except AttributeError:
            stack = _new_stack()
        annotation = None
        if _profiler._is_profiler_enabled:
            annotation = record_function(self.name)
            annotation.__enter__()
        stack.append((self.name, next(_ids), _now(), annotation))
        return self

    def __exit__(self, exc_type, exc, tb):
        stack = _local.stack
        entry = stack.pop()
        recorded = _recorded        # read once: another thread may stop the recording
        if recorded is not None:
            recorded.append(_raw(entry, stack, stack.thread, _now()))
        if entry[3] is not None:
            entry[3].__exit__(None, None, None)
        return False

    def __call__(self, fn):
        @functools.wraps(fn)
        def spanned(*args, **kwargs):
            with self:
                return fn(*args, **kwargs)
        return spanned


_named: Dict[str, _Named] = {}


def span(name: str) -> _Named:
    """The span named ``name``: a context manager, or a decorator that puts
    each call of a function in it."""
    try:
        return _named[name]
    except KeyError:
        return _named.setdefault(name, _Named(name))


def _pair() -> Tuple[int, int]:
    """(the spans' clock, ``time.time_ns()``) read together: the closest of
    a few paired readings."""
    best = None
    for _ in range(5):
        a = _now()
        wall = time.time_ns()
        b = _now()
        if best is None or b - a < best[0]:
            best = (b - a, (a + b) // 2, wall)
    return best[1], best[2]


def start_recording() -> None:
    """Keep every span that ends from now on, until ``stop_recording()``."""
    global _recorded, _start
    _start = _pair()
    _recorded = []


def stop_recording() -> List[Span]:
    """The spans kept since ``start_recording()``, and those still open with
    their ends cut now, ordered by start; recording stops. Without a
    recording, none."""
    global _recorded
    end = _now()
    recorded, _recorded = _recorded, None
    if recorded is None:
        return []
    for stack in list(_open.values()):
        entries = list(stack)
        for depth, entry in enumerate(entries):
            recorded.append(_raw(entry, entries[:depth], stack.thread, end))
    (c0, w0), (c1, w1) = _start, _pair()
    scale = (w1 - w0) / (c1 - c0) if c1 > c0 else 1.0

    def epoch(c):
        return w0 + round((c - c0) * scale)

    spans = [Span(n, i, p, r, epoch(s), epoch(e), t) for n, i, p, r, s, e, t in recorded]
    return sorted(spans, key=lambda s: (s.start_ns, s.id))
