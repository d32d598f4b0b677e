"""K3 and K5: masked non-causal multi-head attention as a streaming softmax.

Kernels: csrc/flash_attention.cu (CUDA C++, sm_90a; one templated body with
two epilogues), replacing
audio_classification_tpu/ops/pallas/attention_kernel.py::flash_attention
(K3: out = acc / l) and ::flash_attention_stats (K5: the unnormalised
accumulator with the row's running max m and sum l, which
parallel/ring_attention.py merges across key blocks). Bound and design are
in the source's header. K3's plain twin is the dense masked softmax the JAX
package uses below the flash threshold (models/common.py:237-245); K5's is
the same softmax stopped before its division, with K5's 0 / -1e9 key bias.
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


def attention_stats_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                              kv_mask: Optional[torch.Tensor] = None) -> tuple:
    """K5's plain twin: with s = q k^T / sqrt(D) + bias (0 / -1e9 per key),
    (o, m, l) = (sum_k exp(s - m) v, max_k s, sum_k exp(s - m)). A key block
    that is masked whole gives m = -1e9 and l = its key count."""
    logits = torch.matmul(q, k.transpose(-1, -2)) / math.sqrt(q.shape[-1])
    if kv_mask is not None:
        bias = torch.zeros(kv_mask.shape, dtype=logits.dtype, device=logits.device)
        bias = bias.masked_fill(~kv_mask.bool(), -1e9)
        logits = logits + bias[:, None, None, :]
    m = logits.amax(dim=-1)
    p = torch.exp(logits - m[..., None])
    return torch.matmul(p, v), m, p.sum(dim=-1)


def _aligned(t: torch.Tensor) -> torch.Tensor:
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _check_qkv(name: str, q, k, v, kv_mask):
    """Shapes, types and devices the kernels take -> (q, k, v, mask pointer
    holder) ready for the launch; raises ValueError on anything else."""
    b, h, tq, d = q.shape
    tk = k.shape[2]
    if d != HEAD_DIM:
        raise ValueError(f"{name}: head dim {d} not supported (only {HEAD_DIM})")
    for label, x, shape in (("q", q, (b, h, tq, d)), ("k", k, (b, h, tk, d)),
                            ("v", v, (b, h, tk, d))):
        if x.dtype != torch.float32 or tuple(x.shape) != shape or x.device != q.device:
            raise ValueError(f"{name}: {label} must be float32 {shape} on "
                             f"{q.device}, got {x.dtype} {tuple(x.shape)} on {x.device}")
    if kv_mask is not None:
        if tuple(kv_mask.shape) != (b, tk) or kv_mask.device != q.device:
            raise ValueError(f"{name}: kv_mask must be {(b, tk)} on {q.device}, "
                             f"got {tuple(kv_mask.shape)} on {kv_mask.device}")
        # the kernel reads one byte a key and tests it against 0: a bool or
        # uint8 mask goes as it is, without a cast of its own
        if kv_mask.dtype not in (torch.bool, torch.uint8):
            kv_mask = kv_mask != 0
        kv_mask = kv_mask.contiguous()
    return _aligned(q), _aligned(k), _aligned(v), kv_mask


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
    if k.shape[2] != t:
        raise ValueError(f"flash_attention: k has {k.shape[2]} rows, q has {t} "
                         "(self-attention only; flash_attention_stats takes both)")
    q, k, v, kv_mask = _check_qkv("flash_attention", q, k, v, kv_mask)
    mask_ptr = None if kv_mask is None else kv_mask.data_ptr()
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


def flash_attention_stats(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          kv_mask: Optional[torch.Tensor] = None) -> tuple:
    """K5: q [B, H, Tq, D], k, v [B, H, Tk, D] f32 + optional [B, Tk] bool key
    mask -> (o [B, H, Tq, D], m [B, H, Tq], l [B, H, Tq]): the streaming
    softmax without its final division (``attention_stats_reference``).
    o / l is the attention over these keys; triples of several key blocks
    merge by rescaling to a common m (parallel/ring_attention.py).

    CPU tensors run the plain twin; CUDA tensors launch the kernel
    (D = 64 only, Tk >= 1)."""
    if q.device.type == "cpu":
        return attention_stats_reference(q, k, v, kv_mask)
    if not q.is_cuda:
        raise ValueError(f"flash_attention_stats: unsupported device {q.device}")
    b, h, tq, d = q.shape
    tk = k.shape[2]
    if tk < 1:
        raise ValueError("flash_attention_stats: needs at least one key")
    q, k, v, kv_mask = _check_qkv("flash_attention_stats", q, k, v, kv_mask)
    mask_ptr = None if kv_mask is None else kv_mask.data_ptr()
    out = torch.empty_like(q)
    m = torch.empty((b, h, tq), dtype=torch.float32, device=q.device)
    l = torch.empty_like(m)
    if out.numel() == 0:
        return out, m, l
    fn = _build.kernel("act_flash_attention_stats", [ctypes.c_void_p] * 7 + [ctypes.c_int] * 5
                       + [ctypes.c_float, ctypes.c_void_p])
    flash_attention_stats.launches += 1
    _build.check("act_flash_attention_stats", fn(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), mask_ptr, out.data_ptr(), m.data_ptr(),
        l.data_ptr(), b, h, tq, tk, d, 1.0 / math.sqrt(d),
        torch.cuda.current_stream(q.device).cuda_stream))
    return out, m, l


flash_attention_stats.launches = 0  # K5's launches, counted apart from K3's
