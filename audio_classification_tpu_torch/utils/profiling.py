"""The port's tracer, and torch.profiler (port of
audio_classification_tpu/utils/profiling.py, whose observability is manual
time.time() bracketing: SURVEY.md §5.1).

One tracer serves the whole program:

- ``span(name, **attrs)``: a context manager around one piece of work. Its
  record holds the name, start and end (``time.perf_counter_ns``), its own
  id, its parent's id (the innermost span open on the same thread), the id
  of its job (the innermost ``new_job`` bracket above it, 0 where none is
  open) and small integer attributes, which serve as counters
  (``Span.set``; ``note`` sets them on the innermost open span).
- The tracer is on while a ``torch.profiler`` session is active
  (``torch.autograd._profiler_enabled()``) or after ``enable()``; otherwise
  ``span`` costs one flag check and returns a span that does nothing.
- While a profiler is active, each span named ``engine.*`` is also entered as
  a ``torch.profiler.record_function`` of the same name, so its host range
  and its device-side annotation sit on the profiler's clock beside the
  kernels. Only ``engine.*`` names are mirrored: the benchmark's trace
  reader (perfbench/trace.py) takes a device-side event as a range only
  under ``engine.`` and ``perfbench.``, and would count any other mirrored
  name as a device operation. ``pipeline.*`` spans stay in the store.
- ``bracket(name)`` is a span that measures its own duration (``ns``,
  ``seconds``) even when the tracer is off, for callers that need the time
  either way (the pipeline's ``time_*_sec`` fields); it records only when
  the tracer is on.
- Records stay in memory: ``spans()`` returns them, ``clear()`` empties
  them, ``export_chrome(path)`` writes them once at the end as a Chrome
  trace (``"X"`` events; ``args`` carry id, parent, job and attributes).
- Anchors: at the first span it records after a profiler came on (as the
  tracer last saw it: at an earlier span, ``enable()``, ``clear()`` or
  ``trace()``) the tracer records ``time.time_ns() - time.perf_counter_ns()``.
  The profiler stamps its events in Unix nanoseconds (kineto's
  ``trace_start_ns()`` plus an event's offset), so a record's
  ``start_ns + anchor`` places it, pipeline spans too, on the device trace's
  clock. ``export_chrome`` writes them as ``anchors_ns``.

Besides:

- ``trace(dir)``: context manager around ``torch.profiler`` (CPU and, where
  there is a card, CUDA activities), writing a Chrome trace
  (``torch_trace_<time>_<pid>.json``, for chrome://tracing or Perfetto) into
  ``dir``; a no-op when ``dir`` is empty. ``--profile-dir`` of
  cli/offline_overlap_3src; ``--trace-spans`` writes the tracer's store.
- ``stage_range(name)``: the span ``engine.<name>`` around one of the
  engine's stage programs (osd, overlap, clean, asr), the counterpart of the
  per-program names in the JAX trace.
"""
from __future__ import annotations

import contextlib
import itertools
import json
import os
import threading
import time
from pathlib import Path
from typing import Dict, Iterator, List, NamedTuple, Optional

import torch

_profiling = torch.autograd._profiler_enabled
_enabled = False
_records: List["SpanRecord"] = []
_anchors: List[int] = []
_in_session = False  # the profiler was on at the last span the tracer recorded
_ids = itertools.count(1)
_local = threading.local()


class SpanRecord(NamedTuple):
    name: str
    start_ns: int
    end_ns: int
    id: int
    parent: int  # 0: a root
    job: int  # 0: outside any job
    thread: int
    attrs: Dict[str, int]


def _stack() -> list:
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    return stack


class Span:
    """One span: ``with span(...) as sp: ...; sp.set(counter=n)``."""

    __slots__ = ("name", "attrs", "on", "new_job", "start_ns", "end_ns", "id", "parent", "job",
                 "_rf")

    def __init__(self, name: str, attrs: Dict[str, int], on: bool, new_job: bool = False):
        self.name, self.attrs, self.on, self.new_job = name, attrs, on, new_job
        self.start_ns = self.end_ns = 0
        self._rf = None

    def set(self, **attrs: int) -> None:
        if self.on:
            self.attrs.update(attrs)

    @property
    def ns(self) -> int:
        return self.end_ns - self.start_ns

    @property
    def seconds(self) -> float:
        return self.ns * 1e-9

    def __enter__(self) -> "Span":
        global _in_session
        if self.on:
            stack = _stack()
            top = stack[-1] if stack else None
            self.id = next(_ids)
            self.parent = top.id if top is not None else 0
            self.job = self.id if self.new_job else (top.job if top is not None else 0)
            stack.append(self)
            profiling = _profiling()
            if profiling and not _in_session:
                _anchors.append(time.time_ns() - time.perf_counter_ns())
            _in_session = profiling
            self.start_ns = time.perf_counter_ns()
            if profiling and self.name.startswith("engine."):
                # the profiler stamps the range inside its entry: the
                # entry's midpoint is the same instant on both clocks
                self._rf = torch.profiler.record_function(self.name)
                self._rf.__enter__()
                self.start_ns = (self.start_ns + time.perf_counter_ns()) // 2
            return self
        self.start_ns = time.perf_counter_ns()
        return self

    def __exit__(self, *exc) -> None:
        if self.on:
            self.end_ns = time.perf_counter_ns()
            if self._rf is not None:
                self._rf.__exit__(*exc)
                self._rf = None
                self.end_ns = (self.end_ns + time.perf_counter_ns()) // 2
            _stack().pop()
            _records.append(SpanRecord(self.name, self.start_ns, self.end_ns, self.id,
                                       self.parent, self.job, threading.get_ident(),
                                       self.attrs))
        else:
            self.end_ns = time.perf_counter_ns()


class _Off:
    """What ``span`` returns while the tracer is off."""

    __slots__ = ()
    on = False

    def __enter__(self) -> "_Off":
        return self

    def __exit__(self, *exc) -> None:
        return None

    def set(self, **attrs: int) -> None:
        return None


OFF = _Off()


def on() -> bool:
    return _enabled or _profiling()


def enable() -> None:
    global _enabled, _in_session
    _enabled, _in_session = True, False


def disable() -> None:
    global _enabled
    _enabled = False


def span(name: str, **attrs: int):
    """A span of ``name``: recorded (and mirrored, for ``engine.*``) while
    the tracer is on, ``OFF`` otherwise."""
    if _enabled or _profiling():
        return Span(name, attrs, True)
    return OFF


def bracket(name: str, new_job: bool = False, **attrs: int) -> Span:
    """A span that always measures its duration and records only while the
    tracer is on; ``new_job`` starts a job: every span beneath it carries
    its id as ``job``."""
    return Span(name, attrs, _enabled or _profiling(), new_job)


def note(**attrs: int) -> None:
    """Set attributes on the innermost span open on this thread (none
    while the tracer is off)."""
    if _enabled or _profiling():
        stack = _stack()
        if stack:
            stack[-1].set(**attrs)


def spans() -> List[SpanRecord]:
    return list(_records)


def anchors() -> List[int]:
    return list(_anchors)


def clear() -> None:
    global _in_session
    _records.clear()
    _anchors.clear()
    _in_session = False


def export_chrome(path: str) -> None:
    """The store as a Chrome trace: one ``"X"`` event a span (``ts`` and
    ``dur`` in microseconds of ``perf_counter_ns``), and ``anchors_ns``, the
    profiler sessions' offsets from those stamps to Unix nanoseconds."""
    tids: Dict[int, int] = {}
    events = [{"name": r.name, "ph": "X", "ts": r.start_ns / 1e3,
               "dur": (r.end_ns - r.start_ns) / 1e3, "pid": os.getpid(),
               "tid": tids.setdefault(r.thread, len(tids)),
               "args": {"id": r.id, "parent": r.parent, "job": r.job, **r.attrs}}
              for r in sorted(_records, key=lambda r: r.start_ns)]
    out = Path(path)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps({"traceEvents": events, "displayTimeUnit": "ms",
                               "clock": "perf_counter_ns", "anchors_ns": list(_anchors)}))


@contextlib.contextmanager
def trace(log_dir: Optional[str]) -> Iterator[None]:
    """torch.profiler trace of the block into ``log_dir`` when it is set;
    no-op otherwise."""
    global _in_session
    if not log_dir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    out = Path(log_dir)
    out.mkdir(parents=True, exist_ok=True)
    _in_session = False
    with profile(activities=activities) as prof:
        yield
    name = f"torch_trace_{time.strftime('%Y-%m-%d_%H-%M-%S')}_{os.getpid()}.json"
    prof.export_chrome_trace(str(out / name))


def stage_range(name: str):
    """The span of one engine stage program: ``engine.<name>``."""
    return span(f"engine.{name}")
