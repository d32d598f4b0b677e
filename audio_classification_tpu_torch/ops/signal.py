"""Small signal helpers (port of audio_classification_tpu/ops/signal.py),
and ``no_tf32``, the float32 guard of code the card may run outside a
StageEngine (which sets the same flags for its whole life)."""
from __future__ import annotations

import contextlib

import numpy as np
import torch


@contextlib.contextmanager
def no_tf32():
    """float32 matmuls, convolutions and RNNs without TF32 inside (cuDNN
    takes TF32 for convolutions and RNNs by default); the caller's flags
    restored after."""
    flags = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = flags


def l2norm(v):
    """Zero-safe L2 normalization over the last axis, for numpy arrays and
    torch tensors (reference: src/model.py:32-34)."""
    if isinstance(v, torch.Tensor):
        n = torch.sqrt(torch.sum(v * v, dim=-1, keepdim=True))
        return torch.where(n > 0, v / torch.where(n > 0, n, torch.ones_like(n)), v)
    n = np.sqrt(np.sum(v * v, axis=-1, keepdims=True))
    return np.where(n > 0, v / np.where(n > 0, n, 1.0), v)


def frame_rms(x: torch.Tensor, frame_length: int, frame_shift: int) -> torch.Tensor:
    """Per-frame RMS energy [..., T] -> [..., N] (the energy-based overlap
    mask of the evaluation; reference: evaluate_with_sources.py:181-196)."""
    from .frames import frame_signal

    frames = frame_signal(x, frame_length, frame_shift)
    return torch.sqrt(torch.mean(frames * frames, dim=-1) + 1e-12)


def peak_limit(x: torch.Tensor, peak: float = 0.98) -> torch.Tensor:
    """x scaled down iff max |x| exceeds ``peak`` (reference: mix_wavs.py
    limiter)."""
    m = x.abs().max()
    scale = torch.where(m > peak, peak / torch.clamp_min(m, 1e-12), torch.ones_like(m))
    return x * scale


def mix_with_gains(sources, gains_db) -> torch.Tensor:
    """[S, T] sources mixed with per-source dB gains -> [T] float32."""
    src = (sources.float() if isinstance(sources, torch.Tensor)
           else torch.from_numpy(np.asarray(sources, np.float32)))
    g = 10.0 ** (torch.from_numpy(np.asarray(gains_db, np.float32)).to(src.device) / 20.0)
    return torch.sum(src * g[:, None], dim=0)
