"""K1: DFT power + mel + log for the fbank frontend, in one launch.

Kernel: csrc/fbank_power_mel.cu (CUDA C++, sm_90a), replacing
audio_classification_tpu/ops/pallas/fbank_kernel.py::fbank_power_mel_pallas.
The kernel runs a real FFT of each frame and sums each mel filter over its
own run of bins; bound and design are in the source's header. The plain twin
below is the same function as three float32 matmuls (dense DFT bases and
mel bank).
"""
from __future__ import annotations

import ctypes
import math
from dataclasses import dataclass

import torch

from ... import _build
from ..work import counted

# the n_fft the kernel is instantiated for (a template per power of two)
KERNEL_N_FFT = (256, 512, 1024)


@dataclass(frozen=True)
class FbankBases:
    """The constants of one fbank config on one device.

    The twin's: ``cos_b``, ``msin_b`` [n_fft, F] (F = n_fft // 2 + 1) and
    ``mel_w`` [F, nb]. The kernel's: ``twiddle`` [F, 2], W^e = exp(-2 pi i e /
    n_fft) as (cos, -sin), which is row 1 of the twin's bases; ``bands``
    int32 [nb, 2], each filter's first bin and count of bins; ``band_w``
    [max count, nb], those bins' weights (``band_w[q, b]`` is
    ``mel_w[bands[b, 0] + q, b]``). ``mel_nnz``: the mel bank's non-zero
    weights, on the host (``work`` counts them). Built by
    ``ops.fbank.fbank_bases``."""

    cos_b: torch.Tensor
    msin_b: torch.Tensor
    mel_w: torch.Tensor
    twiddle: torch.Tensor
    bands: torch.Tensor
    band_w: torch.Tensor
    mel_nnz: int


def work(n: int, n_fft: int, nb: int, mel_nnz: int, band_rows: int) -> dict:
    """K1's work on n frames: the FFT's float32 operations a frame (5 M log2 M
    for the M = n_fft / 2 point complex FFT, 19 a bin for the split and the
    power, 2 a mel weight of the ``mel_nnz`` non-zero ones, 1 a log); bytes:
    the frames in, the log-mel out and the kernel's constants (twiddle
    [F, 2], bands [nb, 2], band_w [band_rows, nb]), float32 and int32. The
    DFT as a GEMM, which the plain twin computes, is not this count."""
    m, n_bins = n_fft // 2, n_fft // 2 + 1
    consts = 2 * n_bins + 2 * nb + band_rows * nb
    return {"flops": n * (5.0 * m * math.log2(m) + 19.0 * n_bins + 2.0 * mel_nnz + nb),
            "bytes": 4.0 * (n * n_fft + n * nb + consts)}


def fbank_power_mel_reference(frames: torch.Tensor, cos_b: torch.Tensor, msin_b: torch.Tensor,
                              mel_w: torch.Tensor, log_floor: float) -> torch.Tensor:
    """Plain twin: [N, n_fft] x [n_fft, F] (re, im) -> power -> x [F, nb] -> log."""
    re = frames @ cos_b
    im = frames @ msin_b
    power = re * re + im * im
    return torch.log(torch.clamp_min(power @ mel_w, log_floor))


@counted(lambda frames, bases, log_floor: work(frames.shape[0], frames.shape[-1],
                                               bases.mel_w.shape[-1], bases.mel_nnz,
                                               bases.band_w.shape[0]))
def fbank_power_mel(frames: torch.Tensor, bases: FbankBases, log_floor: float) -> torch.Tensor:
    """[N, n_fft] windowed f32 frames -> [N, nb] f32 log-mel.

    CPU tensors run the plain twin (any n_fft); CUDA tensors launch the
    kernel (n_fft in ``KERNEL_N_FFT``) or raise. A work count
    (``ops/work``) takes ``work`` for the call on either device."""
    if frames.device.type == "cpu":
        return fbank_power_mel_reference(frames, bases.cos_b, bases.msin_b, bases.mel_w,
                                         log_floor)
    if not frames.is_cuda:
        raise ValueError(f"fbank_power_mel: unsupported device {frames.device}")
    if frames.dim() != 2:
        raise ValueError(f"fbank_power_mel: frames must be [N, n_fft], got {tuple(frames.shape)}")
    n, n_fft = frames.shape
    if n_fft not in KERNEL_N_FFT:
        raise ValueError(f"fbank_power_mel: n_fft {n_fft} has no kernel on the card "
                         f"(it takes {', '.join(map(str, KERNEL_N_FFT))})")
    bw, nb = bases.band_w.shape
    for name, t, shape, dtype in (
            ("frames", frames, (n, n_fft), torch.float32),
            ("twiddle", bases.twiddle, (n_fft // 2 + 1, 2), torch.float32),
            ("bands", bases.bands, (nb, 2), torch.int32),
            ("band_w", bases.band_w, (bw, nb), torch.float32)):
        if t.dtype != dtype or not t.is_contiguous() or tuple(t.shape) != shape \
                or t.device != frames.device:
            raise ValueError(f"fbank_power_mel: {name} must be a contiguous {dtype} "
                             f"{shape} tensor on {frames.device}, got {t.dtype} "
                             f"{tuple(t.shape)} on {t.device}")
    if frames.data_ptr() % 16:
        raise ValueError("fbank_power_mel: frames must start on a 16-byte boundary "
                         "(the kernel reads rows as float4)")
    out = torch.empty((n, nb), dtype=torch.float32, device=frames.device)
    if n == 0 or nb == 0:
        return out
    fn = _build.kernel("act_fbank_power_mel", [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4
                       + [ctypes.c_float, ctypes.c_void_p])
    fbank_power_mel.launches += 1
    _build.launch("act_fbank_power_mel", fn, frames.device, frames.data_ptr(),
                  bases.twiddle.data_ptr(), bases.bands.data_ptr(), bases.band_w.data_ptr(),
                  out.data_ptr(), n, n_fft, nb, bw, float(log_floor))
    return out


fbank_power_mel.launches = 0  # kernel launches, counted where they happen
