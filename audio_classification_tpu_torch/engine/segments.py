"""Segment algebra: pure host-side interval math (host copy of
audio_classification_tpu/engine/segments.py).

Everything here is tiny O(#segments) list processing (the per-sample /
per-frame work happens on device); behaviors mirror the reference exactly:

- ``flags_to_segments``       reference: src/osd/osd.py:110-147
- ``rasterize_intervals``     reference: src/osd/osd.py:99-108
- ``merge_intervals``         reference: overlap3_core.py:508-522
- ``complement_intervals``    reference: overlap3_core.py:524-537
- ``exclusive_segments``      reference: overlap3_core.py:499-541
- ``masks_to_segments``       reference: evaluate_with_sources.py:199-218
- ``segments_to_mask``        reference: evaluate_with_sources.py:238-254
"""
from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np

Segment = Tuple[float, float, bool]  # (start_sec, end_sec, is_overlap)
Interval = Tuple[float, float]


def hop_grid(dur: float, win_sec: float, hop_sec: float) -> np.ndarray:
    """Frame-start grid [0, hop, 2*hop, ...] up to dur - win (inclusive-ish)."""
    return np.arange(0, max(dur - win_sec, 0) + 1e-9, hop_sec)


def rasterize_intervals(
    intervals: Sequence[Interval], dur: float, win_sec: float, hop_sec: float
) -> np.ndarray:
    """Mark grid positions whose window intersects any interval.

    A grid point g is flagged when g >= s - win/2 and g <= e for some
    interval (s, e) — the reference's window-center test.
    """
    grid = hop_grid(dur, win_sec, hop_sec)
    flags = np.zeros(len(grid), dtype=bool)
    for s, e in intervals:
        idx = np.where((grid >= s - win_sec / 2) & (grid <= e))[0]
        flags[idx] = True
    return flags


def flags_to_segments(
    flags: np.ndarray, dur: float, win_sec: float, hop_sec: float,
    merge_gap: float = 0.05,
) -> List[Segment]:
    """Boolean hop-grid flags -> full-coverage alternating segment list.

    Runs of equal flags become segments; a flagged run extends win_sec past
    its last hop; gaps under ``merge_gap`` between same-flag segments merge;
    results clip to [0, dur].
    """
    if len(flags) == 0:
        return [(0.0, dur, False)]
    segs: List[Segment] = []
    cur_flag = bool(flags[0])
    cur_start = 0.0
    for i in range(1, len(flags)):
        if bool(flags[i]) != cur_flag:
            segs.append((cur_start, i * hop_sec + win_sec, cur_flag))
            cur_flag = bool(flags[i])
            cur_start = i * hop_sec
    segs.append((cur_start, dur, cur_flag))

    merged: List[Segment] = []
    for s, e, f in segs:
        if merged and f == merged[-1][2] and s - merged[-1][1] < merge_gap:
            merged[-1] = (merged[-1][0], e, f)
        else:
            merged.append((s, e, f))
    return [(max(0.0, s), min(dur, e), f) for s, e, f in merged if min(dur, e) > max(0.0, s)]


def merge_intervals(intervals: Sequence[Interval], dur: float) -> List[Interval]:
    """Clip to [0, dur], sort, and merge touching/overlapping intervals."""
    iv = [(max(0.0, s), min(dur, e)) for s, e in intervals if e > s]
    iv.sort(key=lambda x: (x[0], x[1]))
    merged: List[List[float]] = []
    for s, e in iv:
        if not merged or s > merged[-1][1]:
            merged.append([s, e])
        elif e > merged[-1][1]:
            merged[-1][1] = e
    return [(float(s), float(e)) for s, e in merged]


def complement_intervals(intervals: Sequence[Interval], start: float, end: float) -> List[Interval]:
    """Gaps of a sorted disjoint interval list within [start, end]."""
    res: List[Interval] = []
    cur = start
    for s, e in intervals:
        if s > cur:
            res.append((cur, s))
        cur = max(cur, e)
    if cur < end:
        res.append((cur, end))
    return res


def exclusive_segments(
    osd_segs: Sequence[Segment], dur: float, min_overlap_dur: float
) -> List[Segment]:
    """Post-process OSD output so clean = complement of merged overlaps.

    Overlap spans shorter than ``min_overlap_dur`` are dropped (they fall
    into clean time); output is sorted by (start, end, overlap-first).
    """
    olaps = [
        (max(0.0, float(s)), min(float(dur), float(e)))
        for s, e, is_ol in osd_segs
        if is_ol and (e - s) >= min_overlap_dur and min(float(dur), float(e)) > max(0.0, float(s))
    ]
    merged = merge_intervals(olaps, dur)
    clean = complement_intervals(merged, 0.0, float(dur))
    segments = [(s, e, True) for s, e in merged] + [(s, e, False) for s, e in clean]
    segments.sort(key=lambda x: (x[0], x[1], not x[2]))
    return segments


def masks_to_segments(
    mask: np.ndarray, hop: float, win: float, total_dur: float
) -> List[Interval]:
    """True-runs of a frame mask -> (start, end) intervals (eval grid)."""
    segs: List[Interval] = []
    if len(mask) == 0:
        return []
    cur = bool(mask[0])
    start_t = 0.0
    for i in range(1, len(mask)):
        if bool(mask[i]) != cur:
            if cur:
                segs.append((start_t, min(i * hop + win, total_dur)))
            start_t = i * hop
            cur = bool(mask[i])
    if cur:
        segs.append((start_t, total_dur))
    return [(max(0.0, s), min(total_dur, e)) for s, e in segs if e > s]


def segments_to_mask(
    segments: Sequence[Segment], dur: float, hop: float, win: float
) -> np.ndarray:
    """Overlap segments -> boolean mask on the eval frame grid.

    A frame [t, t+win) is marked when it intersects any overlap segment.
    """
    grid = hop_grid(dur, win, hop)
    mask = np.zeros(len(grid), dtype=bool)
    for s, e, is_olap in segments:
        if not is_olap:
            continue
        idx = np.where((grid < e) & (grid + win > s))[0]
        mask[idx] = True
    return mask
