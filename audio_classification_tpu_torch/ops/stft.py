"""STFT / iSTFT as products with DFT bases (port of
audio_classification_tpu/ops/stft.py; the fbank frontend multiplies frames
by ``_dft_basis_np`` too). The products run in float32 with TF32 off
(``signal.no_tf32``), as the JAX functions ask for ``precision='highest'``.
"""
from __future__ import annotations

import functools
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from .frames import frame_signal, window
from .signal import no_tf32


@functools.lru_cache(maxsize=8)
def _dft_basis_np(n_fft: int):
    """Real-input DFT basis: returns (cos [n_fft, F], -sin [n_fft, F])."""
    f = n_fft // 2 + 1
    k = np.arange(f)[None, :]
    n = np.arange(n_fft)[:, None]
    ang = 2.0 * np.pi * n * k / n_fft
    return np.cos(ang).astype(np.float32), (-np.sin(ang)).astype(np.float32)


@functools.lru_cache(maxsize=8)
def _idft_basis_np(n_fft: int):
    """Inverse basis mapping (real, imag) bins back to time samples:
    x[n] = (1/n_fft) sum_k w_k (Re X_k cos(ang) - Im X_k sin(ang)), w_k = 1
    for DC and Nyquist, 2 for the interior bins (conjugate symmetry)."""
    f = n_fft // 2 + 1
    k = np.arange(f)[None, :]
    n = np.arange(n_fft)[:, None]
    ang = 2.0 * np.pi * n * k / n_fft
    wk = np.full((1, f), 2.0)
    wk[0, 0] = 1.0
    if n_fft % 2 == 0:
        wk[0, -1] = 1.0
    re_b = (np.cos(ang) * wk / n_fft).astype(np.float32)
    im_b = (-np.sin(ang) * wk / n_fft).astype(np.float32)
    return re_b, im_b


@functools.lru_cache(maxsize=16)
def _bases(n_fft: int, inverse: bool, device: torch.device) -> tuple:
    """The DFT (or inverse) bases on ``device``, uploaded once per shape."""
    basis = _idft_basis_np(n_fft) if inverse else _dft_basis_np(n_fft)
    return tuple(torch.from_numpy(b).to(device) for b in basis)


def stft(x: torch.Tensor, n_fft: int = 512, frame_length: Optional[int] = None,
         frame_shift: int = 160, win: str = "hann") -> tuple:
    """[..., T] -> (real, imag), each [..., N, n_fft // 2 + 1]."""
    frame_length = frame_length or n_fft
    frames = frame_signal(x, frame_length, frame_shift) * window(win, frame_length, x.device)
    if frame_length < n_fft:
        frames = F.pad(frames, (0, n_fft - frame_length))
    cos_b, msin_b = _bases(n_fft, False, x.device)
    with no_tf32():
        return frames @ cos_b, frames @ msin_b


def istft(re: torch.Tensor, im: torch.Tensor, n_fft: int = 512,
          frame_length: Optional[int] = None, frame_shift: int = 160, win: str = "hann",
          length: Optional[int] = None) -> torch.Tensor:
    """(real, imag) [..., N, F] -> [..., T] by windowed overlap-add, divided
    by the overlap-added squared window (the standard synthesis
    normalisation); ``length`` cuts or zero-pads the result."""
    frame_length = frame_length or n_fft
    re_b, im_b = _bases(n_fft, True, re.device)
    with no_tf32():
        frames = re @ re_b.t() + im @ im_b.t()
    w = window(win, frame_length, re.device)
    frames = frames[..., :frame_length] * w
    n = frames.shape[-2]
    t_out = (n - 1) * frame_shift + frame_length
    sig = overlap_add(frames, frame_shift)
    norm = overlap_add((w * w).expand(n, frame_length), frame_shift)
    sig = sig / torch.clamp_min(norm, 1e-8)
    if length is not None:
        sig = sig[..., :length] if length <= t_out else F.pad(sig, (0, length - t_out))
    return sig


def overlap_add(frames: torch.Tensor, frame_shift: int) -> torch.Tensor:
    """[..., N, L] -> [..., (N - 1) * shift + L]: each frame added at its
    offset (one scatter-add over static indices)."""
    n, l = frames.shape[-2], frames.shape[-1]
    t_out = (n - 1) * frame_shift + l
    idx = (torch.arange(n, device=frames.device)[:, None] * frame_shift
           + torch.arange(l, device=frames.device)[None, :]).reshape(-1)
    flat = frames.reshape(frames.shape[:-2] + (n * l,))
    out = frames.new_zeros(frames.shape[:-2] + (t_out,))
    return out.index_add_(-1, idx, flat)
