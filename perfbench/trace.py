"""From a torch.profiler trace to what the per-layer readers read.

``Trace`` keeps, in microseconds on the profiler's clock: the device
operations (kernels, copies, sets) by name; the ranges mirrored onto the
device's timeline (the engine's ``engine.<stage>`` ranges and this
benchmark's ``perfbench.<name>`` ranges: from the first to the last operation
launched inside one); and the same ranges as the host ran them. It is plain
data (``to_dict`` / ``from_dict``), so a recorded trace can stand as a test
fixture. Busy time is ``scripts/profile_torch_scene.py``'s ``busy_ms``: the
length of the union of the operations' intervals.
"""
from __future__ import annotations

import bisect
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

Span = Tuple[float, float]
RANGE_PREFIXES = ("engine.", "perfbench.")
WINDOW = "perfbench.window"


def merged(spans: List[Span]) -> List[Span]:
    """[start, end) spans -> their union as disjoint spans, in order."""
    out: List[List[float]] = []
    for s, e in sorted(spans):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def union_us(spans: List[Span]) -> float:
    """Length of the union of [start, end) spans."""
    return sum(e - s for s, e in merged(spans))


@dataclass
class Trace:
    ops: List[Tuple[str, float, float]] = field(default_factory=list)
    device_ranges: Dict[str, List[Span]] = field(default_factory=dict)
    host_ranges: Dict[str, List[Span]] = field(default_factory=dict)

    @classmethod
    def from_profile(cls, prof) -> "Trace":
        import torch

        t = cls()
        for ev in prof.events():
            name = ev.name
            span = (float(ev.time_range.start), float(ev.time_range.end))
            is_range = name.startswith(RANGE_PREFIXES)
            if ev.device_type == torch.autograd.DeviceType.CUDA:
                if is_range:
                    t.device_ranges.setdefault(name, []).append(span)
                else:
                    t.ops.append((name, *span))
            elif is_range:
                t.host_ranges.setdefault(name, []).append(span)
        return t

    def to_dict(self) -> dict:
        return {"ops": self.ops, "device_ranges": self.device_ranges,
                "host_ranges": self.host_ranges}

    @classmethod
    def from_dict(cls, d: dict) -> "Trace":
        return cls([tuple(o) for o in d["ops"]],
                   {k: [tuple(s) for s in v] for k, v in d["device_ranges"].items()},
                   {k: [tuple(s) for s in v] for k, v in d["host_ranges"].items()})

    # ------------------------------------------------------------ readings
    def window(self) -> Optional[Span]:
        spans = self.host_ranges.get(WINDOW)
        return (min(s for s, _ in spans), max(e for _, e in spans)) if spans else None

    def busy_us(self) -> float:
        return union_us([(s, e) for _, s, e in self.ops])

    def device_us_in(self, range_name: str) -> Optional[float]:
        """Device time of the operations inside the device-side spans of
        ``range_name`` (None where the range never ran on the device)."""
        spans = sorted(self.device_ranges.get(range_name, []))
        if not spans:
            return None
        starts = [s for s, _ in spans]
        total = 0.0
        for _, s, e in self.ops:
            i = bisect.bisect_right(starts, s) - 1
            if i >= 0 and e <= spans[i][1]:
                total += e - s
        return total

    def top_ops(self, n: int = 10) -> List[list]:
        by: Dict[str, float] = {}
        for name, s, e in self.ops:
            by[name] = by.get(name, 0.0) + (e - s) * 1e-6
        return [[k, v] for k, v in sorted(by.items(), key=lambda kv: -kv[1])[:n]]

    def idle_gaps(self, n: int = 10) -> List[list]:
        """Idle device time inside the window, by the innermost host range
        open when each gap began ("host" where none was)."""
        win = self.window()
        if win is None:
            return []
        busy = merged([(max(s, win[0]), min(e, win[1])) for _, s, e in self.ops
                       if e > win[0] and s < win[1]])
        gaps, cur = [], win[0]
        for s, e in busy:
            if s > cur:
                gaps.append((cur, s))
            cur = max(cur, e)
        if win[1] > cur:
            gaps.append((cur, win[1]))
        host = sorted((s, e, name) for name, spans in self.host_ranges.items()
                      if name != WINDOW for s, e in spans)
        by: Dict[str, float] = {}
        for g0, g1 in gaps:
            label, best = "host", None
            for s, e, name in host:
                if s > g0:
                    break
                if e > g0 and (best is None or s >= best):
                    label, best = name, s
            by[label] = by.get(label, 0.0) + (g1 - g0) * 1e-6
        return [[k, v] for k, v in sorted(by.items(), key=lambda kv: -kv[1])[:n]]


@dataclass
class View:
    """What a per-layer reader gets: the trace, the jobs it holds, the
    traced window's seconds (host clock), the seconds the same jobs took
    just before without the profiler (host clock; None where that pass
    failed), the kernels' recorded calls with their work, the model FLOPs
    of the traced jobs, and the card's peaks (None on a card the table
    does not list)."""

    trace: Trace
    jobs: int
    window_s: float
    untraced_s: Optional[float]
    calls: Dict[str, List[dict]]
    flops: float
    peaks: Optional[dict]

    def roofline(self, kernel: str) -> Optional[float]:
        """The kernel's share of its roofline in %: the bound of every
        recorded call over the device time inside its ranges."""
        calls = self.calls.get(kernel)
        dev_us = self.trace.device_us_in(f"perfbench.{kernel}")
        if not calls or not dev_us or self.peaks is None:
            return None
        from .work import bound_s

        return 100.0 * sum(bound_s(c, self.peaks) for c in calls) / (dev_us * 1e-6)

    def stage_ms_per_job(self, stage: str) -> Optional[float]:
        us = self.trace.device_us_in(f"engine.{stage}")
        return None if us is None or not self.jobs else us * 1e-3 / self.jobs
