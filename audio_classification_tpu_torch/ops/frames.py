"""Framing and window functions (port of audio_classification_tpu/ops/frames.py).

Framing is a strided view (``Tensor.unfold``); windows are host constants
cached on the signal's device.
"""
from __future__ import annotations

import functools

import numpy as np
import torch


def num_frames(n_samples: int, frame_length: int, frame_shift: int, snip_edges: bool = True) -> int:
    """Frame count for a signal of n_samples (kaldi snip_edges semantics)."""
    if snip_edges:
        if n_samples < frame_length:
            return 0
        return 1 + (n_samples - frame_length) // frame_shift
    return (n_samples + frame_shift // 2) // frame_shift


def frame_signal(x: torch.Tensor, frame_length: int, frame_shift: int) -> torch.Tensor:
    """[..., T] -> [..., N, frame_length] (snip_edges)."""
    if num_frames(x.shape[-1], frame_length, frame_shift) <= 0:
        return x.new_zeros(x.shape[:-1] + (0, frame_length))
    return x.unfold(-1, frame_length, frame_shift)


@functools.lru_cache(maxsize=32)
def _window_np(kind: str, length: int) -> np.ndarray:
    n = np.arange(length, dtype=np.float64)
    if kind == "hann":
        w = 0.5 - 0.5 * np.cos(2 * np.pi * n / (length - 1))
    elif kind == "hamming":
        w = 0.54 - 0.46 * np.cos(2 * np.pi * n / (length - 1))
    elif kind == "povey":
        # kaldi's default: hann ** 0.85
        w = (0.5 - 0.5 * np.cos(2 * np.pi * n / (length - 1))) ** 0.85
    elif kind == "rectangular":
        w = np.ones(length)
    elif kind == "periodic_hann":
        w = 0.5 - 0.5 * np.cos(2 * np.pi * n / length)
    else:
        raise ValueError(f"unknown window: {kind}")
    return w.astype(np.float32)


@functools.lru_cache(maxsize=32)
def _window_on(kind: str, length: int, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(_window_np(kind, length)).to(device)


def window(kind: str, length: int, device=None) -> torch.Tensor:
    """The window on ``device``, uploaded once per (kind, length, device):
    a per-call host-to-device copy would make the host wait for the
    device's queue. Read-only: callers must not modify it in place."""
    return _window_on(kind, length, torch.device(device if device is not None else "cpu"))
