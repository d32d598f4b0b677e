"""Kaldi-compatible log-mel filterbank frontend (port of
audio_classification_tpu/ops/fbank.py).

DC removal, pre-emphasis, the povey window and the 400 -> 512 zero pad are
plain tensor ops here; the DFT-power-mel-log chain is kernel K1
(ops/kernels/fbank.py), which runs its plain twin for CPU tensors. The
constants of both are built here, once per config and device
(``fbank_bases``).

Defaults mirror kaldi: frame 25 ms / shift 10 ms, preemph 0.97, povey window,
snip_edges, 80 bins over [20 Hz, nyquist], no dither (deterministic).
"""
from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from .frames import frame_signal, num_frames, window
from .kernels.fbank import FbankBases, fbank_power_mel
from .stft import _dft_basis_np
from .work import shape_keyed


def _next_pow2(n: int) -> int:
    p = 1
    while p < n:
        p *= 2
    return p


@functools.lru_cache(maxsize=16)
def mel_filterbank_np(
    num_bins: int,
    n_fft: int,
    sample_rate: int,
    low_freq: float = 20.0,
    high_freq: float = 0.0,
) -> np.ndarray:
    """Kaldi-style triangular mel filterbank -> [n_fft//2 + 1, num_bins].

    high_freq <= 0 means nyquist + high_freq (kaldi semantics).
    """
    nyq = sample_rate / 2.0
    if high_freq <= 0.0:
        high_freq = nyq + high_freq

    def mel(f):
        return 1127.0 * np.log(1.0 + f / 700.0)

    mel_lo, mel_hi = mel(low_freq), mel(high_freq)
    mel_pts = np.linspace(mel_lo, mel_hi, num_bins + 2)
    fft_freqs = np.arange(n_fft // 2 + 1) * (sample_rate / n_fft)
    fft_mel = mel(fft_freqs)

    fb = np.zeros((n_fft // 2 + 1, num_bins), dtype=np.float32)
    for b in range(num_bins):
        left, center, right = mel_pts[b], mel_pts[b + 1], mel_pts[b + 2]
        up = (fft_mel - left) / (center - left)
        down = (right - fft_mel) / (right - center)
        fb[:, b] = np.maximum(0.0, np.minimum(up, down)).astype(np.float32)
    return fb


@dataclass(frozen=True)
class FbankConfig:
    sample_rate: int = 16000
    num_bins: int = 80
    frame_length_ms: float = 25.0
    frame_shift_ms: float = 10.0
    preemph: float = 0.97
    window: str = "povey"
    low_freq: float = 20.0
    high_freq: float = 0.0
    remove_dc: bool = True
    use_energy: bool = False
    log_floor: float = 1.1920928955078125e-07  # FLT_EPSILON, kaldi's floor

    @property
    def frame_length(self) -> int:
        return int(self.sample_rate * self.frame_length_ms / 1000.0)

    @property
    def frame_shift(self) -> int:
        return int(self.sample_rate * self.frame_shift_ms / 1000.0)

    @property
    def n_fft(self) -> int:
        return _next_pow2(self.frame_length)

    def frames_for(self, n_samples: int) -> int:
        return num_frames(n_samples, self.frame_length, self.frame_shift)


def fbank_kernel_tables_np(n_fft: int, mel: np.ndarray):
    """K1's constants from the DFT basis and the mel bank ``mel`` [F, nb]:
    (twiddle [F, 2] f32, bands [nb, 2] int32, band_w [max count, nb] f32).

    twiddle[e] = (cos, -sin)(2 pi e / n_fft), row 1 of ``_dft_basis_np``
    (float64, rounded to float32). Each filter is the run of bins from its
    first to its last non-zero weight: bands[b] = (first, count), and
    band_w[q, b] = mel[first + q, b] (zeros past count; an all-zero filter
    has count 0)."""
    cos_b, msin_b = _dft_basis_np(n_fft)
    twiddle = np.ascontiguousarray(np.stack([cos_b[1], msin_b[1]], axis=1))
    nz = mel != 0
    has = nz.any(axis=0)
    first = np.where(has, nz.argmax(axis=0), 0)
    count = np.where(has, nz.shape[0] - nz[::-1].argmax(axis=0) - first, 0)
    band_w = np.zeros((max(1, int(count.max(initial=0))), mel.shape[1]), np.float32)
    for b in range(mel.shape[1]):
        band_w[:count[b], b] = mel[first[b]:first[b] + count[b], b]
    return twiddle, np.stack([first, count], axis=1).astype(np.int32), band_w


def make_fbank_bases(n_fft: int, mel: np.ndarray, device: torch.device) -> FbankBases:
    """The twin's and the kernel's constants for frames of ``n_fft`` and the
    mel bank ``mel`` [n_fft // 2 + 1, nb], as float32 / int32 on ``device``."""
    arrays = _dft_basis_np(n_fft) + (mel,) + fbank_kernel_tables_np(n_fft, mel)
    return FbankBases(*(torch.from_numpy(np.ascontiguousarray(a)).to(device) for a in arrays),
                      mel_nnz=int(np.count_nonzero(mel)))


@functools.lru_cache(maxsize=8)
def fbank_bases(cfg: FbankConfig, device: torch.device) -> FbankBases:
    """``make_fbank_bases`` for ``cfg``, once per config and device."""
    mel = mel_filterbank_np(cfg.num_bins, cfg.n_fft, cfg.sample_rate, cfg.low_freq,
                            cfg.high_freq)
    return make_fbank_bases(cfg.n_fft, mel, device)


def windowed_frames(x: torch.Tensor, cfg: FbankConfig = FbankConfig()) -> torch.Tensor:
    """[..., T] float waveform in [-1, 1] -> [..., N, n_fft] frames after the
    x32768 scale (kaldi's int16 range), DC removal, pre-emphasis, the
    window and the zero pad to n_fft: the input of kernel K1."""
    x = x.float() * 32768.0
    frames = frame_signal(x, cfg.frame_length, cfg.frame_shift)
    if cfg.remove_dc:
        frames = frames - frames.mean(dim=-1, keepdim=True)
    if cfg.preemph > 0:
        first = frames[..., :1] * (1.0 - cfg.preemph)
        rest = frames[..., 1:] - cfg.preemph * frames[..., :-1]
        frames = torch.cat([first, rest], dim=-1)
    frames = frames * window(cfg.window, cfg.frame_length, frames.device)
    if cfg.frame_length < cfg.n_fft:
        frames = F.pad(frames, (0, cfg.n_fft - cfg.frame_length))
    return frames


@shape_keyed
def log_mel_fbank(x: torch.Tensor, cfg: FbankConfig = FbankConfig()) -> torch.Tensor:
    """[..., T] float waveform in [-1, 1] -> [..., N, num_bins] log-mel."""
    frames = windowed_frames(x, cfg)
    lead = frames.shape[:-1]
    out = fbank_power_mel(frames.reshape(-1, cfg.n_fft).contiguous(),
                          fbank_bases(cfg, frames.device), cfg.log_floor)
    return out.reshape(lead + (cfg.num_bins,))


def apply_lfr(feats: torch.Tensor, lfr_m: int = 7, lfr_n: int = 6) -> torch.Tensor:
    """Low-frame-rate stacking (Paraformer/SenseVoice frontend).

    [..., N, D] -> [..., ceil(N/lfr_n), lfr_m*D]: each output frame stacks
    lfr_m consecutive input frames, hopping lfr_n, left-padded by repeating
    the first frame (funasr convention).
    """
    n, d = feats.shape[-2], feats.shape[-1]
    left = (lfr_m - 1) // 2
    head = feats[..., :1, :].expand(feats.shape[:-2] + (left, d))
    padded = torch.cat([head, feats], dim=-2)
    n_pad = padded.shape[-2]
    n_out = int(np.ceil(n / lfr_n))
    need = (n_out - 1) * lfr_n + lfr_m
    if need > n_pad:
        tail = padded[..., -1:, :].expand(feats.shape[:-2] + (need - n_pad, d))
        padded = torch.cat([padded, tail], dim=-2)
    stacked = padded[..., _lfr_index(n_out, lfr_m, lfr_n, feats.device), :]
    return stacked.reshape(feats.shape[:-2] + (n_out, lfr_m * d))


@functools.lru_cache(maxsize=64)
def _lfr_index(n_out: int, lfr_m: int, lfr_n: int, device: torch.device) -> torch.Tensor:
    """Flat gather index of apply_lfr, uploaded once per shape and device."""
    idx = (np.arange(n_out)[:, None] * lfr_n + np.arange(lfr_m)[None, :]).reshape(-1)
    return torch.from_numpy(idx).to(device)


def apply_cmvn(feats: torch.Tensor, mean: Optional[torch.Tensor],
               istd: Optional[torch.Tensor]) -> torch.Tensor:
    """Global CMVN: (x + neg_mean) * inv_stddev, identity when stats absent."""
    if mean is not None:
        feats = feats + mean
    if istd is not None:
        feats = feats * istd
    return feats
