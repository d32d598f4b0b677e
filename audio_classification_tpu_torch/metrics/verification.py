"""Speaker-verification trial metrics.

The reference gates on a single cosine threshold (sv_threshold,
overlap3_core.py:397); equal error rate summarizes the whole operating
curve of the same/different-speaker score distributions the trainer's
quality gate already collects.

Host copy of audio_classification_tpu/metrics/verification.py.
"""
from __future__ import annotations

import numpy as np


def eer(same_scores, diff_scores) -> tuple:
    """-> (eer, threshold): the rate where false-accept == false-reject.

    ``same_scores``: target-trial scores (higher = more same-speaker);
    ``diff_scores``: impostor-trial scores. Linear interpolation between
    the two candidate thresholds straddling the crossing.
    """
    s = np.sort(np.asarray(same_scores, np.float64))
    d = np.sort(np.asarray(diff_scores, np.float64))
    if s.size == 0 or d.size == 0:
        return float("nan"), float("nan")
    # sweep candidate thresholds over all observed scores
    thr = np.unique(np.concatenate([s, d]))
    # false reject: same-scores below threshold; false accept: diff >= thr
    frr = np.searchsorted(s, thr, side="left") / s.size
    far = 1.0 - np.searchsorted(d, thr, side="left") / d.size
    gap = frr - far
    i = int(np.argmax(gap >= 0))
    if i == 0:
        return float((frr[0] + far[0]) / 2), float(thr[0])
    # interpolate between thr[i-1] (gap<0) and thr[i] (gap>=0)
    g0, g1 = gap[i - 1], gap[i]
    w = 0.0 if g1 == g0 else -g0 / (g1 - g0)
    t = thr[i - 1] + w * (thr[i] - thr[i - 1])
    e = (frr[i - 1] + w * (frr[i] - frr[i - 1])
         + far[i - 1] + w * (far[i] - far[i - 1])) / 2
    return float(e), float(t)
