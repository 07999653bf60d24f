"""Host-side batching with background prefetch: port of
``siss_tpu/data/loader.py``.

A small thread assembles NHWC float32 numpy batches ahead of the train loop,
as in the JAX package; the task moves them to the card. The JAX loader's
optional C++ batcher is host code and is not carried over: this is its numpy
path.
"""

from __future__ import annotations

import queue
import threading
from typing import Any, Callable, Iterator, Optional

import numpy as np


class BatchLoader:
    """dataset + index sampler → infinite iterator of batches.

    ``collate`` turns a list of items into a batch (default: stack arrays,
    and stack each field of tuple items). A finite sampler's last, short
    batch is dropped unless ``drop_last=False``. ``skip_batches`` (settable
    before the first ``next``) drops that many leading batches at the
    sampler level, reading no images: the resume fast-forward."""

    def __init__(self, dataset, sampler, batch_size: int, prefetch: int = 2,
                 collate: Optional[Callable] = None, drop_last: bool = True,
                 skip_batches: int = 0):
        self.dataset = dataset
        self.sampler = sampler
        self.batch_size = batch_size
        self.collate = collate or default_collate
        self.prefetch = prefetch
        self.drop_last = drop_last
        self.skip_batches = skip_batches

    def _batches(self) -> Iterator[Any]:
        buf = []
        to_skip = int(self.skip_batches) * self.batch_size
        for idx in self.sampler:
            if to_skip > 0:
                to_skip -= 1
                continue
            buf.append(self.dataset[idx])
            if len(buf) == self.batch_size:
                yield self.collate(buf)
                buf = []
        if buf and not self.drop_last:  # a finite sampler's tail
            yield self.collate(buf)

    def __iter__(self) -> Iterator[Any]:
        if self.prefetch <= 0:
            yield from self._batches()
            return
        q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        done = object()
        stop = threading.Event()

        def put(item) -> bool:
            # a bounded put that re-checks stop, so an abandoned iterator
            # never leaves the worker blocked on a full queue
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def worker():
            try:
                for b in self._batches():
                    if not put(b):
                        return
                put(done)
            except Exception as e:  # surface dataset errors to the consumer
                put((done, e))

        t = threading.Thread(target=worker, daemon=True)
        t.start()
        try:
            while True:
                b = q.get()
                if b is done:
                    return
                if isinstance(b, tuple) and len(b) == 2 and b[0] is done:
                    raise RuntimeError("BatchLoader worker failed") from b[1]
                yield b
        finally:
            stop.set()
            while not q.empty():  # unblock a worker waiting on a full queue
                try:
                    q.get_nowait()
                except queue.Empty:
                    break


def default_collate(items):
    """Stack array items; stack tuple items field by field."""
    if isinstance(items[0], tuple):
        return tuple(np.stack([it[i] for it in items]) for i in range(len(items[0])))
    return np.stack(items)


def dual_stream(keep_iter: Iterator, forget_iter: Iterator, accum_steps: int) -> Iterator[dict]:
    """Zip the keep and forget loaders into {"all", "deletion"} step inputs
    of shape [A, mb, ...] (A = accumulation steps)."""
    while True:
        keep = np.stack([next(keep_iter) for _ in range(accum_steps)])
        forget = np.stack([next(forget_iter) for _ in range(accum_steps)])
        yield {"all": keep, "deletion": forget}
