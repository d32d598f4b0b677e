"""K3: masked non-causal multi-head self-attention as a streaming softmax.

Kernel: csrc/flash_attention.cu (CUDA C++, sm_90a), replacing
audio_classification_tpu/ops/pallas/attention_kernel.py::flash_attention.
Bound and design are in the source's header; the plain twin below is the
dense masked softmax the JAX package uses below the flash threshold
(models/common.py:237-245).
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from ... import _build

#: flash path from this sequence length on, as on the TPU
#: (attention_kernel.flash_enabled: ACT_FLASH_ATTN_MIN_T default 512)
FLASH_MIN_T = 512
HEAD_DIM = 64  # the kernel's only head dimension (OSDNet and SenseVoice both use 64)


def attention_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        kv_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain twin: softmax(q k^T / sqrt(D) + bias) v, bias 0 / -1e9 per key."""
    logits = torch.matmul(q, k.transpose(-1, -2)) / math.sqrt(q.shape[-1])
    if kv_mask is not None:
        bias = torch.zeros(kv_mask.shape, dtype=logits.dtype, device=logits.device)
        bias = bias.masked_fill(~kv_mask.bool(), -1e9)
        logits = logits + bias[:, None, None, :]
    return torch.matmul(torch.softmax(logits, dim=-1), v)


def _aligned(t: torch.Tensor) -> torch.Tensor:
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    kv_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """[B, H, T, D] f32 q, k, v + optional [B, T] bool key mask -> [B, H, T, D].

    CPU tensors run the plain twin; CUDA tensors launch the kernel
    (D = 64 only)."""
    if q.device.type == "cpu":
        return attention_reference(q, k, v, kv_mask)
    if not q.is_cuda:
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    b, h, t, d = q.shape
    if d != HEAD_DIM:
        raise ValueError(f"flash_attention: head dim {d} not supported (only {HEAD_DIM})")
    for name, x in (("q", q), ("k", k), ("v", v)):
        if x.dtype != torch.float32 or tuple(x.shape) != (b, h, t, d) or x.device != q.device:
            raise ValueError(f"flash_attention: {name} must be float32 {(b, h, t, d)} on "
                             f"{q.device}, got {x.dtype} {tuple(x.shape)} on {x.device}")
    q, k, v = _aligned(q), _aligned(k), _aligned(v)
    mask_ptr = None
    if kv_mask is not None:
        if tuple(kv_mask.shape) != (b, t) or kv_mask.device != q.device:
            raise ValueError(f"flash_attention: kv_mask must be {(b, t)} on {q.device}, "
                             f"got {tuple(kv_mask.shape)} on {kv_mask.device}")
        kv_mask = kv_mask.to(torch.uint8).contiguous()
        mask_ptr = kv_mask.data_ptr()
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    fn = _build.kernel("act_flash_attention", [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4
                       + [ctypes.c_float, ctypes.c_void_p])
    flash_attention.launches += 1
    _build.check("act_flash_attention", fn(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), mask_ptr, out.data_ptr(), b, h, t, d,
        1.0 / math.sqrt(d), torch.cuda.current_stream(q.device).cuda_stream))
    return out


flash_attention.launches = 0  # kernel launches, counted where they happen
