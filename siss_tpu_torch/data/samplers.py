"""Index streams: port of ``siss_tpu/data/samplers.py``'s
``InfiniteSampler`` and ``RepeatedSampler``.

``InfiniteSampler`` draws from numpy's ``default_rng`` exactly as the JAX
package does, so the two give the same indices for the same seed, bit for
bit.
"""

from __future__ import annotations

from typing import Iterator

import numpy as np


class InfiniteSampler:
    """Endless shuffled index stream with a bounded reshuffle window.

    Each epoch is a fresh uniform permutation of ``range(dataset_len)``;
    consecutive epochs pass through a shuffle buffer of
    ``round(dataset_len * window_size)`` slots: every draw takes a uniformly
    random slot and refills it from the epoch stream. With ``num_replicas >
    1`` rank r keeps positions r, r+R, r+2R, … of the one stream that every
    rank generates.
    """

    def __init__(self, dataset_len: int, rank: int = 0, num_replicas: int = 1,
                 shuffle: bool = True, seed: int = 0, window_size: float = 0.5):
        if dataset_len <= 0 or num_replicas <= 0 or not 0 <= rank < num_replicas:
            raise ValueError(f"bad sampler arguments: dataset_len={dataset_len}, rank={rank}, "
                             f"num_replicas={num_replicas}")
        if not 0 <= window_size <= 1:
            raise ValueError(f"window_size must be in [0, 1], got {window_size}")
        self.dataset_len = dataset_len
        self.rank = rank
        self.num_replicas = num_replicas
        self.shuffle = shuffle
        self.seed = seed
        self.window_size = window_size

    def _buffer_len(self) -> int:
        return int(np.rint(self.dataset_len * self.window_size))

    def _feed(self, rng: np.random.Generator) -> Iterator[np.ndarray]:
        """Infinite sequence of epoch index blocks."""
        if not self.shuffle:
            block = np.arange(self.dataset_len)
            while True:
                yield block
        # A window of fewer than 2 slots disables local reshuffling: one fixed
        # permutation is replayed forever.
        if self._buffer_len() < 2:
            block = rng.permutation(self.dataset_len)
            while True:
                yield block
        while True:
            yield rng.permutation(self.dataset_len)

    def __iter__(self) -> Iterator[int]:
        rng = np.random.default_rng(self.seed)
        epoch_stream = (int(i) for block in self._feed(rng) for i in block)
        buf_len = self._buffer_len() if self.shuffle else 0
        buffer = [next(epoch_stream) for _ in range(max(buf_len, 1))]
        pos = 0
        while True:
            slot = int(rng.integers(len(buffer))) if buf_len >= 2 else 0
            out = buffer[slot]
            buffer[slot] = next(epoch_stream)
            if pos % self.num_replicas == self.rank:
                yield out
            pos += 1


class RepeatedSampler:
    """Each index of ``range(dataset_len)`` ``num_repeats`` times in a row,
    then the next: several forget images are forgotten one after another."""

    def __init__(self, dataset_len: int, num_repeats: int):
        self.dataset_len = dataset_len
        self.num_repeats = num_repeats

    def __len__(self) -> int:
        return self.dataset_len * self.num_repeats

    def __iter__(self) -> Iterator[int]:
        for i in range(self.dataset_len):
            for _ in range(self.num_repeats):
                yield i
