"""Tracing and profiling utilities (port of
audio_classification_tpu/utils/profiling.py).

The reference's observability is manual time.time() bracketing
(reference: SURVEY.md §5.1); the port keeps those metric fields and adds
device-level tracing:

- ``trace(dir)``: context manager around ``torch.profiler`` (CPU and, where
  there is a card, CUDA activities), writing a Chrome trace
  (``torch_trace_<time>_<pid>.json``, for chrome://tracing or Perfetto) into
  ``dir``; a no-op when ``dir`` is empty. ``--profile-dir`` of
  cli/offline_overlap_3src.
- ``stage_range(name)``: a ``record_function`` range ``engine.<name>`` around
  one of the engine's stage programs (osd, overlap, clean, asr), the
  counterpart of the per-program names in the JAX trace; it costs a few
  microseconds a batch when no profiler runs.
- ``StageTimer``: wall-clock stage accounting that separates a stage's first
  call for each tag (warm-up: allocator growth, cuDNN plans, the kernels'
  build) from its warm calls.
"""
from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict
from pathlib import Path
from typing import Dict, Iterator, Optional

import torch


@contextlib.contextmanager
def trace(log_dir: Optional[str]) -> Iterator[None]:
    """torch.profiler trace of the block into ``log_dir`` when it is set;
    no-op otherwise."""
    if not log_dir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    out = Path(log_dir)
    out.mkdir(parents=True, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    name = f"torch_trace_{time.strftime('%Y-%m-%d_%H-%M-%S')}_{os.getpid()}.json"
    prof.export_chrome_trace(str(out / name))


def stage_range(name: str):
    """The profiler range of one engine stage program: ``engine.<name>``."""
    return torch.profiler.record_function(f"engine.{name}")


class StageTimer:
    """Per-stage wall clock with a warm-up / warm split.

    The first timed call for a (stage, tag) pair counts as warm-up
    (``compile_sec``, the JAX field's name: there it is XLA's compile);
    later calls count as execute. ``tag`` is usually the padded batch
    shape."""

    def __init__(self):
        self.compile_sec: Dict[str, float] = defaultdict(float)
        self.execute_sec: Dict[str, float] = defaultdict(float)
        self.calls: Dict[str, int] = defaultdict(int)
        self._seen: set = set()

    @contextlib.contextmanager
    def time(self, stage: str, tag: object = None) -> Iterator[None]:
        key = (stage, tag)
        t0 = time.time()
        try:
            yield
        finally:
            dt = time.time() - t0
            self.calls[stage] += 1
            if key in self._seen:
                self.execute_sec[stage] += dt
            else:
                self._seen.add(key)
                self.compile_sec[stage] += dt

    def summary(self) -> Dict[str, Dict[str, float]]:
        out = {}
        for stage in sorted(set(self.compile_sec) | set(self.execute_sec)):
            out[stage] = {
                "compile_sec": round(self.compile_sec[stage], 3),
                "execute_sec": round(self.execute_sec[stage], 3),
                "calls": self.calls[stage],
            }
        return out
