"""Real-input DFT basis (numpy copy of audio_classification_tpu/ops/stft.py's
``_dft_basis_np``; the fbank frontend multiplies frames by it)."""
from __future__ import annotations

import functools

import numpy as np


@functools.lru_cache(maxsize=8)
def _dft_basis_np(n_fft: int):
    """Real-input DFT basis: returns (cos [n_fft, F], -sin [n_fft, F])."""
    f = n_fft // 2 + 1
    k = np.arange(f)[None, :]
    n = np.arange(n_fft)[:, None]
    ang = 2.0 * np.pi * n * k / n_fft
    return np.cos(ang).astype(np.float32), (-np.sin(ang)).astype(np.float32)
