"""Bounded ring buffer for streaming capture (port of
audio_classification_tpu/audio_io/stream_buffer.py).

One capture thread pushes float samples, one pump thread pops fixed-size
blocks for batched device dispatch. Push never blocks: when the buffer is
full the newest samples are dropped and counted.

``RingBuffer`` is the port's native lock-free single-producer /
single-consumer buffer (native/ringbuffer.cpp, built with g++ at first use by
``_build.host_library``; a failed build raises). ``NumpyRingBuffer`` is its
plain version, a numpy array guarded by a lock, which the tests hold it to.
"""
from __future__ import annotations

import ctypes
import functools
import threading

import numpy as np


@functools.lru_cache(maxsize=1)
def _native_lib() -> ctypes.CDLL:
    """The C++ ring buffer, built at first use; its entry points declared."""
    from .._build import host_library

    lib = host_library("ringbuffer")
    lib.rb_create.restype = ctypes.c_void_p
    lib.rb_create.argtypes = [ctypes.c_longlong]
    lib.rb_destroy.restype = None
    lib.rb_destroy.argtypes = [ctypes.c_void_p]
    for fn in ("rb_size", "rb_capacity", "rb_dropped"):
        getattr(lib, fn).restype = ctypes.c_longlong
        getattr(lib, fn).argtypes = [ctypes.c_void_p]
    for fn in ("rb_push", "rb_pop"):
        getattr(lib, fn).restype = ctypes.c_longlong
        getattr(lib, fn).argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_float),
                                     ctypes.c_longlong]
    return lib


def _float_ptr(x: np.ndarray):
    return x.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


class RingBuffer:
    """Bounded float32 ring buffer in native memory (one producer, one
    consumer, no lock). Push never blocks; overflow samples drop."""

    def __init__(self, capacity: int):
        self.capacity = int(capacity)
        self._lib = _native_lib()
        handle = self._lib.rb_create(self.capacity)
        if not handle:
            raise ValueError(f"RingBuffer: cannot allocate {self.capacity} samples")
        self._handle = ctypes.c_void_p(handle)

    def __del__(self):
        handle = getattr(self, "_handle", None)
        if handle is not None:
            self._lib.rb_destroy(handle)
            self._handle = None

    def push(self, samples: np.ndarray) -> int:
        """Append what fits -> the number of samples taken."""
        x = np.ascontiguousarray(samples, dtype=np.float32).reshape(-1)
        return int(self._lib.rb_push(self._handle, _float_ptr(x), x.size))

    def pop(self, n: int) -> np.ndarray:
        """The oldest min(n, size) samples, in order."""
        out = np.empty(max(int(n), 0), dtype=np.float32)
        got = int(self._lib.rb_pop(self._handle, _float_ptr(out), out.size))
        return out[:got]

    @property
    def size(self) -> int:
        return int(self._lib.rb_size(self._handle))

    @property
    def dropped(self) -> int:
        return int(self._lib.rb_dropped(self._handle))


class NumpyRingBuffer:
    """``RingBuffer``'s plain version: a numpy array guarded by a lock."""

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
            got = max(min(int(n), self._head - self._tail), 0)
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
