"""Sample-rate conversion on the device (port of
audio_classification_tpu/ops/resample.py).

- ``resample_poly``: windowed-sinc polyphase resampler (quality path). The
  JAX package writes it as one convolution of the zero-stuffed input; here
  the same sum runs in polyphase form, one strided ``conv1d`` with ``up``
  output channels, so no zero-stuffed signal of ``up`` times the length is
  ever formed. It is plain tensor code in the reference (not a kernel), so
  the library convolution is the right tool.
- ``resample_linear``: linear interpolation, n_new = round(T * new / orig),
  endpoints mapped over [0, T - 1].
"""
from __future__ import annotations

import functools
import math

import numpy as np
import torch
import torch.nn.functional as F


@functools.lru_cache(maxsize=32)
def _polyphase_kernel_np(up: int, down: int, width: int = 16,
                         rolloff: float = 0.9475937167399596) -> np.ndarray:
    """Windowed-sinc lowpass prototype for rational resampling, zero-padded
    to a multiple of ``up`` taps.

    Cutoff at min(1/up, 1/down) * rolloff (in units of the intermediate
    nyquist), Kaiser window (beta = 14.77)."""
    base_freq = min(1.0 / up, 1.0 / down) * rolloff
    half = int(width * max(up, down))
    n = np.arange(-half, half + 1, dtype=np.float64)
    kernel = np.sinc(n * base_freq) * base_freq
    kernel = (kernel * np.kaiser(n.size, 14.769656459379492)) * up
    kernel = np.concatenate([kernel, np.zeros((-kernel.size) % up)])
    return kernel.astype(np.float32)


@functools.lru_cache(maxsize=32)
def _polyphase_bank(up: int, down: int, width: int, device: torch.device):
    """The prototype as a bank of ``up`` phase filters for one strided
    correlation -> (weight [up, 1, W] on ``device``, left pad).

    Output sample j = c + up * m reads the zero-stuffed convolution at
    p = j * down + off (off = taps - 1 - taps // 2, the reference's
    centring): with b_c, r_c = divmod(c * down + off, up),
    out[j] = sum_q x[b_c + down * m - q] * kernel[r_c + up * q]."""
    kernel = _polyphase_kernel_np(up, down, width)
    taps = kernel.size
    n_q = taps // up
    off = taps - 1 - taps // 2
    b = [(c * down + off) // up for c in range(up)]
    r = [(c * down + off) % up for c in range(up)]
    pad_left = n_q - 1 - min(b)
    w = np.zeros((up, 1, pad_left + max(b) + 1), np.float32)
    for c in range(up):
        for q in range(n_q):
            w[c, 0, pad_left + b[c] - q] = kernel[r[c] + up * q]
    return torch.from_numpy(w).to(device), pad_left


def resample_poly(x: torch.Tensor, orig_sr: int, new_sr: int, width: int = 16) -> torch.Tensor:
    """[..., T] -> [..., ceil(T * new / orig)] windowed-sinc resample."""
    if orig_sr == new_sr:
        return x
    g = math.gcd(orig_sr, new_sr)
    up, down = new_sr // g, orig_sr // g
    weight, pad_left = _polyphase_bank(up, down, width, x.device)
    t = x.shape[-1]
    t_out = -(-t * up // down)
    n_m = -(-t_out // up)  # windows per phase
    pad_right = max((n_m - 1) * down + weight.shape[-1] - pad_left - t, 0)
    xb = F.pad(x.reshape(-1, 1, t).float(), (pad_left, pad_right))
    y = F.conv1d(xb, weight, stride=down)[..., :n_m]  # [B, up, n_m]
    y = y.transpose(1, 2).reshape(-1, n_m * up)[:, :t_out]
    return y.reshape(x.shape[:-1] + (t_out,))


def resample_linear(x: torch.Tensor, orig_sr: int, new_sr: int) -> torch.Tensor:
    """Linear-interpolation resample: n_new = round(T * new / orig) points
    over [0, T - 1]."""
    if orig_sr == new_sr:
        return x
    t = x.shape[-1]
    n_new = int(round(t * float(new_sr) / float(orig_sr)))
    pos = torch.from_numpy(np.linspace(0.0, t - 1.0, n_new).astype(np.float32)).to(x.device)
    i0 = pos.floor().long().clamp(0, t - 1)
    i1 = (i0 + 1).clamp(0, t - 1)
    frac = pos - i0.float()
    return x[..., i0] * (1.0 - frac) + x[..., i1] * frac
