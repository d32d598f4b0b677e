"""Bounded ring buffer for streaming capture (host copy of the numpy path
of audio_classification_tpu/audio_io/stream_buffer.py).

One capture thread pushes float samples, one pump thread pops fixed-size
blocks for batched device dispatch. Push never blocks: when the buffer is
full the newest samples are dropped and counted.
"""
from __future__ import annotations

import threading

import numpy as np


class RingBuffer:
    """Bounded float32 ring buffer guarded by a lock (one producer, one
    consumer). Push never blocks; overflow samples drop."""

    def __init__(self, capacity: int):
        self.capacity = int(capacity)
        self._buf = np.empty(self.capacity, dtype=np.float32)
        self._head = 0  # samples ever written
        self._tail = 0  # samples ever read
        self._dropped = 0
        self._lock = threading.Lock()

    def push(self, samples: np.ndarray) -> int:
        """Append what fits -> the number of samples taken."""
        x = np.ascontiguousarray(samples, dtype=np.float32).reshape(-1)
        with self._lock:
            free = self.capacity - (self._head - self._tail)
            n = min(x.size, free)
            idx = (self._head + np.arange(n)) % self.capacity
            self._buf[idx] = x[:n]
            self._head += n
            self._dropped += x.size - n
            return int(n)

    def pop(self, n: int) -> np.ndarray:
        """The oldest min(n, size) samples, in order."""
        with self._lock:
            got = min(int(n), self._head - self._tail)
            idx = (self._tail + np.arange(got)) % self.capacity
            out = self._buf[idx]
            self._tail += got
            return out

    @property
    def size(self) -> int:
        with self._lock:
            return int(self._head - self._tail)

    @property
    def dropped(self) -> int:
        with self._lock:
            return int(self._dropped)
