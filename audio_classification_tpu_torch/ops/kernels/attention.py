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

import collections
import ctypes
import math
from typing import Optional

import torch
import torch.nn.functional as F

from ... import _build

#: flash path from this sequence length on, as on the TPU
#: (attention_kernel.flash_enabled: ACT_FLASH_ATTN_MIN_T default 512)
FLASH_MIN_T = 512
#: the head dims the kernel body is instantiated at, and the slab width of
#: the wide body that takes every multiple of it above the largest, as the
#: dispatch switch in csrc/flash_attention.cu (their owner) takes them; a
#: card test holds the two equal. OSDNet, SenseVoice and the transducer and
#: whisper-style encoders use 64, Paraformer 80 (320 / 4 heads). The wrapper
#: zero-pads D up to the next head dim the kernels take, as the TPU kernel
#: pads D to its lane width (attention_kernel._pad_softmax_operands): zero
#: columns add nothing to q k^T, and the padded output columns are sliced off
HEAD_DIMS = (64, 80, 128)
WIDE_SLAB = 64


def attention_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        kv_mask: Optional[torch.Tensor] = None,
                        scale: Optional[float] = None) -> torch.Tensor:
    """Plain twin: softmax(q k^T * scale + bias) v, bias 0 / -1e9 per key,
    scale 1 / sqrt(D) unless given."""
    scale = 1.0 / math.sqrt(q.shape[-1]) if scale is None else scale
    logits = torch.matmul(q, k.transpose(-1, -2)) * scale
    if kv_mask is not None:
        bias = torch.zeros(kv_mask.shape, dtype=logits.dtype, device=logits.device)
        bias = bias.masked_fill(~kv_mask.bool(), -1e9)
        logits = logits + bias[:, None, None, :]
    return torch.matmul(torch.softmax(logits, dim=-1), v)


def attention_stats_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                              kv_mask: Optional[torch.Tensor] = None,
                              scale: Optional[float] = None) -> tuple:
    """K5's plain twin: with s = q k^T * scale + bias (0 / -1e9 per key;
    scale 1 / sqrt(D) unless given), (o, m, l) = (sum_k exp(s - m) v,
    max_k s, sum_k exp(s - m)). A key block that is masked whole gives
    m = -1e9 and l = its key count."""
    scale = 1.0 / math.sqrt(q.shape[-1]) if scale is None else scale
    logits = torch.matmul(q, k.transpose(-1, -2)) * scale
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


def padded_head_dim(d: int) -> int:
    """The head dim a true head dim d runs at: the least of ``HEAD_DIMS``
    >= d, and above the largest, d rounded up to a multiple of
    ``WIDE_SLAB`` (the wide body)."""
    for inst in HEAD_DIMS:
        if d <= inst:
            return inst
    return -(-d // WIDE_SLAB) * WIDE_SLAB


def pad_head_dim(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> tuple:
    """(q, k, v) with D zero-padded to the head dim it runs at
    (``padded_head_dim``). The caller passes 1 / sqrt(D) of the true D as
    the scale."""
    pad = padded_head_dim(q.shape[-1]) - q.shape[-1]
    if not pad:
        return q, k, v
    return tuple(F.pad(x, (0, pad)) for x in (q, k, v))


def _check_qkv(name: str, q, k, v, kv_mask):
    """Shapes, types and devices the kernels take -> (q, k, v, mask) ready
    for the launch, D zero-padded to the head dim it runs at; raises
    ValueError on anything else."""
    b, h, tq, d = q.shape
    tk = k.shape[2]
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
    q, k, v = pad_head_dim(q, k, v)
    return _aligned(q), _aligned(k), _aligned(v), kv_mask


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    kv_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """[B, H, T, D] f32 q, k, v + optional [B, T] bool key mask -> [B, H, T, D].

    CPU tensors run the plain twin; CUDA tensors launch the kernel (any D,
    zero-padded to the head dim it runs at, ``padded_head_dim``; scale
    1 / sqrt(D) of the true D)."""
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
        return out[..., :d]
    fn = _build.kernel("act_flash_attention", [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4
                       + [ctypes.c_float, ctypes.c_void_p])
    flash_attention.launches += 1
    flash_attention.launches_by_head_dim[d] += 1
    _build.check("act_flash_attention", fn(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), mask_ptr, out.data_ptr(), b, h, t,
        q.shape[-1], 1.0 / math.sqrt(d), torch.cuda.current_stream(q.device).cuda_stream))
    return out[..., :d]  # the padded columns sliced off (a view)


flash_attention.launches = 0  # kernel launches, counted where they happen
flash_attention.launches_by_head_dim = collections.Counter()  # the same, by the true D


def flash_attention_stats(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          kv_mask: Optional[torch.Tensor] = None) -> tuple:
    """K5: q [B, H, Tq, D], k, v [B, H, Tk, D] f32 + optional [B, Tk] bool key
    mask -> (o [B, H, Tq, D], m [B, H, Tq], l [B, H, Tq]): the streaming
    softmax without its final division (``attention_stats_reference``).
    o / l is the attention over these keys; triples of several key blocks
    merge by rescaling to a common m (parallel/ring_attention.py).

    CPU tensors run the plain twin; CUDA tensors launch the kernel (Tk >= 1;
    any D, zero-padded as in ``flash_attention``)."""
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
    out_d = out[..., :d]  # the padded columns sliced off (a view)
    if out.numel() == 0:
        return out_d, m, l
    fn = _build.kernel("act_flash_attention_stats", [ctypes.c_void_p] * 7 + [ctypes.c_int] * 5
                       + [ctypes.c_float, ctypes.c_void_p])
    flash_attention_stats.launches += 1
    flash_attention_stats.launches_by_head_dim[d] += 1
    _build.check("act_flash_attention_stats", fn(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), mask_ptr, out.data_ptr(), m.data_ptr(),
        l.data_ptr(), b, h, tq, tk, q.shape[-1], 1.0 / math.sqrt(d),
        torch.cuda.current_stream(q.device).cuda_stream))
    return out_d, m, l


flash_attention_stats.launches = 0  # K5's launches, counted apart from K3's
flash_attention_stats.launches_by_head_dim = collections.Counter()
