"""Shared set-up of K1's tests (not a test module; imports no JAX, since the
card's tests use it too): the waveforms on which K1
(csrc/fbank_power_mel.cu) and its CPU emulation are held to the twin, and
the accuracy criterion.

The criterion: the log-mel error against the twin run in float64 is at most
max(1e-4, 4 x the float32 twin's own error against float64) on active bins
(within 15 nats of the float64 twin's peak) and at most max(5e-3, 4 x the
float32 twin's own error) on all bins. Neither a float32 FFT nor the float32
DFT as a matmul is uniformly closer to the float64 result, so the float32
twin is no oracle for the FFT: at a 1 kHz tone over 1e-4 noise it is itself
~9e-5 off on active bins at n_fft 512, and at n_fft 1024 with 128 bins
7e-2 to 3e-1 off on the narrow low filters ~31 nats below the peak (a bin
~1e-7 of the peak's amplitude, below float32's resolution of the frame),
where the all-bin limit of 5e-3 alone would hold no float32 method.
"""
import numpy as np
import torch

from audio_classification_tpu_torch.ops import fbank
from audio_classification_tpu_torch.ops.kernels.fbank import fbank_power_mel_reference

SR = 16000
KINDS = ("noise", "tone", "harmonics", "zeros", "full_scale")
TOL_ACTIVE, TOL_ALL, TWIN_FACTOR = 1e-4, 5e-3, 4.0


def waveform(kind: str, n: int, seed: int = 0) -> np.ndarray:
    """[n] float32 in [-1, 1]: noise 0.1; a 1 kHz tone over 1e-4 noise; 19
    harmonics of 180 Hz over 3e-3 noise; digital silence; a full-scale
    +-1.0 square wave."""
    rng = np.random.default_rng(seed)
    t = np.arange(n) / SR
    if kind == "noise":
        x = 0.1 * rng.standard_normal(n)
    elif kind == "tone":
        x = 0.5 * np.sin(2 * np.pi * 1000.0 * t) + 1e-4 * rng.standard_normal(n)
    elif kind == "harmonics":
        x = 0.2 * sum(np.sin(2 * np.pi * h * 180.0 * t) / h for h in range(1, 20))
        x = x + 3e-3 * rng.standard_normal(n)
    elif kind == "zeros":
        x = np.zeros(n)
    elif kind == "full_scale":
        x = np.where(np.sin(2 * np.pi * 440.0 * t + 0.1) >= 0, 1.0, -1.0)
    else:
        raise ValueError(kind)
    return x.astype(np.float32)


def config(n_fft: int) -> fbank.FbankConfig:
    """The port's config at n_fft 512; the JAX package's 64 ms config
    (pipelines/quality_gate.py: 128 bins) at 1024."""
    if n_fft == 512:
        return fbank.FbankConfig()
    if n_fft == 1024:
        return fbank.FbankConfig(frame_length_ms=64.0, num_bins=128)
    raise ValueError(n_fft)


def frames(kind: str, n_frames: int, cfg: fbank.FbankConfig, device="cpu",
           seed: int = 0) -> torch.Tensor:
    """[n_frames, n_fft] windowed frames of ``waveform(kind)``."""
    wav = waveform(kind, cfg.frame_length + cfg.frame_shift * (n_frames - 1), seed)
    out = fbank.windowed_frames(torch.from_numpy(wav).to(device)[None], cfg)
    out = out.reshape(-1, cfg.n_fft).contiguous()
    assert out.shape[0] == n_frames
    return out


def accuracy(out: torch.Tensor, frames_: torch.Tensor, bases, log_floor: float) -> dict:
    """``out``'s error against the twin run in float64, on active bins and
    on all, beside the float32 twin's own, and the criterion's limits."""
    ref64 = fbank_power_mel_reference(frames_.double(), bases.cos_b.double(),
                                      bases.msin_b.double(), bases.mel_w.double(), log_floor)
    ref32 = fbank_power_mel_reference(frames_, bases.cos_b, bases.msin_b, bases.mel_w,
                                      log_floor)
    active = ref64 > ref64.max() - 15.0

    def errs(x):
        e = (x.double() - ref64).abs()
        return e[active].max().item(), e.max().item()

    err_active, err_all = errs(out)
    twin_active, twin_all = errs(ref32)
    return {"err_active": err_active, "err_all": err_all, "twin32_err_active": twin_active,
            "twin32_err_all": twin_all,
            "tol_active": max(TOL_ACTIVE, TWIN_FACTOR * twin_active),
            "tol_all": max(TOL_ALL, TWIN_FACTOR * twin_all)}


def meets(acc: dict) -> bool:
    return acc["err_active"] <= acc["tol_active"] and acc["err_all"] <= acc["tol_all"]
