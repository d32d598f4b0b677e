"""Length bucketing + padded batch assembly (host copy of
audio_classification_tpu/engine/bucketing.py without the mu-law arena
codec).

XLA compiles one program per shape; segments have arbitrary lengths
(reference processes them one by one at native length —
overlap3_core.py:604-840). Here every variable-length item snaps to a
geometric length bucket and batches snap to power-of-two sizes, so the
total number of compiled programs per stage is
O(#buckets x log2(max_batch)) and every program is reused across the run.
"""
from __future__ import annotations

import warnings
from dataclasses import dataclass, field
from typing import List, Sequence, Tuple

import numpy as np


def default_buckets(sample_rate: int = 16000, min_sec: float = 0.5, max_sec: float = 64.0) -> Tuple[int, ...]:
    """Geometric (x2) bucket lengths in samples."""
    out = []
    sec = min_sec
    while sec < max_sec:
        out.append(int(sec * sample_rate))
        sec *= 2.0
    out.append(int(max_sec * sample_rate))
    return tuple(out)


@dataclass(frozen=True)
class BucketSpec:
    lengths: Tuple[int, ...] = field(default_factory=default_buckets)
    max_batch: int = 8
    batch_multiple: int = 1   # e.g. mesh data-axis size for even DP sharding

    def bucket_for(self, n: int) -> int:
        for b in self.lengths:
            if n <= b:
                return b
        # Longer than the configured cap: keep doubling geometrically so the
        # item is processed at full length (the reference runs every segment
        # at native length — overlap3_core.py:604-840). This costs one extra
        # compiled program per rare oversized bucket instead of silently
        # truncating the tail of the audio.
        b = self.lengths[-1]
        while b < n:
            b *= 2
        warnings.warn(
            f"input of {n} samples exceeds the largest configured bucket "
            f"({self.lengths[-1]}); extending to an ad-hoc {b}-sample bucket "
            "(one-time XLA compile for this shape)",
            stacklevel=2,
        )
        return b

    def long_bucket_for(self, n: int) -> int:
        """Bucket for the LONG-FORM path (transcribe_long): same geometric
        ×2 grid extended past the configured cap, but pre-declared — no
        warning, because long-form inputs are expected to exceed the
        segment cap and each grid point compiles once (and persists in the
        XLA compilation cache across processes)."""
        for b in self.lengths:
            if n <= b:
                return b
        b = self.lengths[-1]
        while b < n:
            b *= 2
        return b

    def batch_size_for(self, n_items: int) -> int:
        b = self.batch_multiple
        while b < n_items and b < self.max_batch:
            b *= 2
        return max(min(b, self.max_batch), self.batch_multiple)


def pad_batch(
    items: Sequence[np.ndarray], bucket_len: int, batch_size: int
) -> Tuple[np.ndarray, np.ndarray]:
    """Stack 1-D arrays into [batch_size, bucket_len] + lengths [batch_size].

    Items must fit the bucket: callers pick the bucket via
    ``BucketSpec.bucket_for`` on the item lengths, which never returns a
    bucket smaller than the item, so an overflow here is a caller bug —
    raise rather than silently truncate audio.
    """
    assert len(items) <= batch_size
    wav = np.zeros((batch_size, bucket_len), dtype=np.float32)
    lengths = np.zeros((batch_size,), dtype=np.int32)
    for i, x in enumerate(items):
        n = x.shape[-1]
        if n > bucket_len:
            raise ValueError(
                f"item {i} has {n} samples > bucket {bucket_len}; pick the "
                "bucket with BucketSpec.bucket_for to avoid truncating audio"
            )
        wav[i, :n] = x[..., :n]
        lengths[i] = n
    return wav, lengths


def quantize_i16(x: np.ndarray) -> np.ndarray:
    """clip(rint(x * 32768)) -> int16 — THE audio uplink quantization.

    Single definition so the arena path's bit-exactness contract
    (slice-then-quantize == quantize-then-slice, tested by
    test_device_gather_matches_host_uplink) cannot drift between
    ``pad_batch_i16``, ``flat_pack_i16`` and the engine's direct uplinks.
    """
    y = np.asarray(x, dtype=np.float32) * 32768.0
    np.rint(y, out=y)
    np.clip(y, -32768, 32767, out=y)
    return y.astype(np.int16)  # integral floats in range: exact conversion


def pad_batch_i16(
    items: Sequence[np.ndarray], bucket_len: int, batch_size: int
) -> Tuple[np.ndarray, np.ndarray]:
    """Padded int16 uplink batch built directly from float waveforms.

    Bit-identical to ``pad_batch`` followed by the engine's int16 audio
    quantization (clip(rint(x * 32768))), but touches ONLY each item's
    valid samples: the padding stays calloc zeros (0.0 quantizes to 0) and
    the [batch, bucket] float32 intermediate never exists. On the 1-core
    host the pad->quantize pair dominated warm pass walls (profiled 3.3 s
    of a 6.7 s pass at 128x10 s mixtures: full-buffer zero-fill + mult +
    rint + clip + astype over padded rows); this path cuts that to one
    scaled-rint-clip pass over the real audio.
    """
    assert len(items) <= batch_size
    wav = np.zeros((batch_size, bucket_len), dtype=np.int16)
    lengths = np.zeros((batch_size,), dtype=np.int32)
    for i, x in enumerate(items):
        n = x.shape[-1]
        if n > bucket_len:
            raise ValueError(
                f"item {i} has {n} samples > bucket {bucket_len}; pick the "
                "bucket with BucketSpec.bucket_for to avoid truncating audio"
            )
        wav[i, :n] = quantize_i16(x[..., :n])
        lengths[i] = n
    return wav, lengths


def flat_pack_i16(
    items: Sequence[np.ndarray], tail: int, grid: int = 1 << 20
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Pack whole waveforms into ONE tightly-concatenated int16 buffer.

    The device-gather uplink path: a wave's audio crosses host->device
    once, back to back with no per-item bucket padding (only a ``tail``
    of zeros so on-device ``dynamic_slice`` windows of up to ``tail``
    samples never clamp, plus padding to a multiple of ``grid`` so the
    arena shape — and every gather program keyed on it — repeats across
    waves instead of compiling per exact length). Quantization is the
    same clip(rint(x * 32768)) as ``pad_batch_i16``, applied once per
    sample, so slicing the packed buffer is bit-identical to quantizing
    the slice.

    Returns (buf [N], offsets [n] int64, lengths [n] int64).
    """
    lengths = np.array([int(x.shape[-1]) for x in items], dtype=np.int64)
    offsets = np.zeros(len(items), dtype=np.int64)
    if len(items):
        np.cumsum(lengths[:-1], out=offsets[1:])
    total = int(lengths.sum()) + int(tail)
    n_pad = -(-total // grid) * grid
    buf = np.zeros(n_pad, dtype=np.int16)
    for x, off, n in zip(items, offsets, lengths):
        buf[off : off + n] = quantize_i16(x[..., :n])
    return buf, offsets, lengths


def group_by_bucket(
    items: Sequence[np.ndarray], spec: BucketSpec
) -> List[Tuple[int, List[int]]]:
    """Group item indices by target bucket -> [(bucket_len, [indices])]."""
    groups: dict = {}
    for i, x in enumerate(items):
        b = spec.bucket_for(x.shape[-1])
        groups.setdefault(b, []).append(i)
    return sorted(groups.items())
