"""K1: fused DFT power + mel + log for the fbank frontend.

Kernel: csrc/fbank_power_mel.cu (CUDA C++, sm_90a), replacing
audio_classification_tpu/ops/pallas/fbank_kernel.py::fbank_power_mel_pallas.
Bound and design are in the source's header; the plain twin below is the
same chain as three float32 matmuls.
"""
from __future__ import annotations

import ctypes

import torch

from ... import _build


def fbank_power_mel_reference(frames: torch.Tensor, cos_b: torch.Tensor, msin_b: torch.Tensor,
                              mel_w: torch.Tensor, log_floor: float) -> torch.Tensor:
    """Plain twin: [N, n_fft] x [n_fft, F] (re, im) -> power -> x [F, nb] -> log."""
    re = frames @ cos_b
    im = frames @ msin_b
    power = re * re + im * im
    return torch.log(torch.clamp_min(power @ mel_w, log_floor))


def fbank_power_mel(frames: torch.Tensor, cos_b: torch.Tensor, msin_b: torch.Tensor,
                    mel_w: torch.Tensor, log_floor: float) -> torch.Tensor:
    """[N, n_fft] windowed f32 frames -> [N, nb] f32 log-mel.

    CPU tensors run the plain twin; CUDA tensors launch the kernel."""
    if frames.device.type == "cpu":
        return fbank_power_mel_reference(frames, cos_b, msin_b, mel_w, log_floor)
    if not frames.is_cuda:
        raise ValueError(f"fbank_power_mel: unsupported device {frames.device}")
    n, n_fft = frames.shape
    nf, nb = mel_w.shape
    for name, t, shape in (("frames", frames, (n, n_fft)), ("cos_b", cos_b, (n_fft, nf)),
                           ("msin_b", msin_b, (n_fft, nf)), ("mel_w", mel_w, (nf, nb))):
        if t.dtype != torch.float32 or not t.is_contiguous() or tuple(t.shape) != shape \
                or t.device != frames.device:
            raise ValueError(f"fbank_power_mel: {name} must be a contiguous float32 "
                             f"{shape} tensor on {frames.device}, got {t.dtype} "
                             f"{tuple(t.shape)} on {t.device}")
    out = torch.empty((n, nb), dtype=torch.float32, device=frames.device)
    if n == 0:
        return out
    fn = _build.kernel("act_fbank_power_mel", [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4
                       + [ctypes.c_float, ctypes.c_void_p])
    fbank_power_mel.launches += 1
    _build.check("act_fbank_power_mel", fn(
        frames.data_ptr(), cos_b.data_ptr(), msin_b.data_ptr(), mel_w.data_ptr(),
        out.data_ptr(), n, n_fft, nf, nb, float(log_floor),
        torch.cuda.current_stream(frames.device).cuda_stream))
    return out


fbank_power_mel.launches = 0  # kernel launches, counted where they happen
