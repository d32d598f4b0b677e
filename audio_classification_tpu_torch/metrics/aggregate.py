"""Statistic aggregation helpers shared by pipelines and batch_eval (host copy of
audio_classification_tpu/metrics/aggregate.py).

Field conventions copy the reference so downstream artifact consumers see
identical shapes (reference: overlap3_core.py:860-869 `_agg`;
batch_eval.py:17-135 adds min/max).
"""
from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np


def agg_stats(vals: List[float]) -> Dict[str, Optional[float]]:
    """mean/median/std/count over floats (reference: overlap3_core.py:860-869)."""
    if not vals:
        return {"mean": None, "median": None, "std": None, "count": 0}
    arr = np.asarray(vals, dtype=np.float32)
    return {
        "mean": round(float(np.mean(arr)), 4),
        "median": round(float(np.median(arr)), 4),
        "std": round(float(np.std(arr)), 4),
        "count": int(arr.size),
    }


def agg_stats_full(vals: List[float]) -> Dict[str, Optional[float]]:
    """mean/median/std/min/max/count (reference: batch_eval.py aggregation)."""
    if not vals:
        return {"mean": None, "median": None, "std": None, "min": None, "max": None, "count": 0}
    arr = np.asarray(vals, dtype=np.float64)
    return {
        "mean": float(np.mean(arr)),
        "median": float(np.median(arr)),
        "std": float(np.std(arr)),
        "min": float(np.min(arr)),
        "max": float(np.max(arr)),
        "count": int(arr.size),
    }


def maybe_round(x, nd: int = 4):
    if x is None:
        return None
    try:
        return round(x, nd)
    except (TypeError, ValueError):
        return None
