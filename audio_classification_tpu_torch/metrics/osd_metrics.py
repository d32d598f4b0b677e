"""OSD quality metrics vs energy-based ground truth.

Mirrors the evaluator's frame-mask pipeline
(reference: evaluate_with_sources.py:181-283): per-source frame RMS,
activity threshold as a ratio of the global RMS peak, GT overlap = >=2
sources active, then precision/recall/F1/IoU between boolean frame masks.
This module holds the host-side RMS, mask logic and the exact metric
formulas (host copy of audio_classification_tpu/metrics/osd_metrics.py).
"""
from __future__ import annotations

from typing import Dict, Sequence

import numpy as np


def frame_rms_np(wav: np.ndarray, sr: int, win: float, hop: float) -> np.ndarray:
    """Sliding-window RMS (host parity version;
    reference: evaluate_with_sources.py:181-196)."""
    win_s, hop_s = int(win * sr), int(hop * sr)
    if win_s <= 0 or hop_s <= 0:
        raise ValueError("win/hop too small")
    out = []
    for start in range(0, max(len(wav) - win_s + 1, 1), hop_s):
        seg = wav[start : start + win_s]
        out.append(0.0 if len(seg) == 0 else float(np.sqrt(np.mean(seg**2) + 1e-12)))
    return np.asarray(out, dtype=np.float32)


def build_gt_overlap_mask(
    sources: Sequence[np.ndarray], sr: int, win: float, hop: float, thr_ratio: float,
    min_active: int = 2,
) -> np.ndarray:
    """GT overlap mask: frames where >= ``min_active`` sources exceed
    peak * thr_ratio (reference: evaluate_with_sources.py:221-235, extended
    to K sources per SURVEY.md §3.4 '>=2 active')."""
    rms = [frame_rms_np(s, sr, win, hop) for s in sources]
    n = min(len(r) for r in rms)
    rms = np.stack([r[:n] for r in rms])
    peak = max(float(rms.max(initial=0.0)), 1e-9)
    active = rms > peak * thr_ratio
    return active.sum(axis=0) >= min_active


def compute_osd_metrics(gt_mask: np.ndarray, pred_mask: np.ndarray) -> Dict[str, float]:
    """P/R/F1/IoU + frame counts on aligned boolean masks
    (reference: evaluate_with_sources.py:257-283)."""
    if len(gt_mask) == 0 or len(pred_mask) == 0:
        return {"precision": 0.0, "recall": 0.0, "f1": 0.0, "iou": 0.0}
    n = min(len(gt_mask), len(pred_mask))
    gt, pr = gt_mask[:n], pred_mask[:n]
    tp = float(np.sum(gt & pr))
    fp = float(np.sum(~gt & pr))
    fn = float(np.sum(gt & ~pr))
    precision = tp / (tp + fp) if (tp + fp) > 0 else 0.0
    recall = tp / (tp + fn) if (tp + fn) > 0 else 0.0
    f1 = 2 * precision * recall / (precision + recall) if (precision + recall) > 0 else 0.0
    iou = tp / (tp + fp + fn) if (tp + fp + fn) > 0 else 0.0
    return {
        "precision": round(precision, 4),
        "recall": round(recall, 4),
        "f1": round(f1, 4),
        "iou": round(iou, 4),
        "tp_frames": int(tp),
        "fp_frames": int(fp),
        "fn_frames": int(fn),
    }
