"""Text metrics: CER / WER with the reference's normalization rules.

- ``normalize_for_cer``: strip spaces, keep only CJK + alphanumerics
  (reference: benchmark_pipeline.py:146-154)
- ``cer`` / ``wer``: Levenshtein distance / reference length
  (reference: benchmark_pipeline.py:464-482, evaluate_with_sources.py:530-573)

Host copy of audio_classification_tpu/metrics/text.py.
"""
from __future__ import annotations

import re
from typing import List, Sequence

_CJK_RE = re.compile(r"[一-鿿]")
_ALNUM_RE = re.compile(r"[A-Za-z0-9]")


def normalize_for_cer(text: str) -> str:
    if not text:
        return ""
    text = text.replace(" ", "").strip()
    return "".join(ch for ch in text if _CJK_RE.match(ch) or _ALNUM_RE.match(ch))


def edit_distance(ref: Sequence, hyp: Sequence) -> int:
    """Levenshtein distance with two-row DP."""
    m, n = len(ref), len(hyp)
    if m == 0:
        return n
    prev = list(range(n + 1))
    for i in range(1, m + 1):
        cur = [i] + [0] * n
        ri = ref[i - 1]
        for j in range(1, n + 1):
            cost = 0 if ri == hyp[j - 1] else 1
            cur[j] = min(prev[j] + 1, cur[j - 1] + 1, prev[j - 1] + cost)
        prev = cur
    return prev[n]


def cer(ref: str, hyp: str, normalize: bool = False) -> float:
    """Character error rate. ``normalize=True`` applies the CJK/alnum filter
    used by the SID benchmark; the source evaluator uses plain strip only."""
    if normalize:
        ref, hyp = normalize_for_cer(ref), normalize_for_cer(hyp)
    else:
        ref, hyp = ref.strip(), hyp.strip()
    ref_chars, hyp_chars = list(ref), list(hyp)
    if not ref_chars:
        return 0.0 if not hyp_chars else 1.0
    return edit_distance(ref_chars, hyp_chars) / len(ref_chars)


def _split_words(t: str) -> List[str]:
    t = t.strip()
    return t.split() if t else []


def wer(ref: str, hyp: str) -> float:
    r, h = _split_words(ref), _split_words(hyp)
    if not r:
        return 0.0 if not h else 1.0
    return edit_distance(r, h) / len(r)
