"""K4: gated-attention-unit scores, relu(q k^T * scale * key_mask)^2 v.

Kernel: csrc/gau_attention.cu (CUDA C++, sm_90a: both products on the
tensor cores in 3xTF32 by mma.sync), replacing
audio_classification_tpu/ops/pallas/attention_kernel.py::gau_attention.
Bound and design are in the source's header. The plain twin below walks
blocks of query rows (as the JAX package's ``_gau_blockwise_ref``), so it
never holds a [T, T] matrix: at T = 63999 frames a dense float32 [T, T] is
16 GB per item.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from ... import _build
from .attention import _aligned

MAX_QK_DIM = 128  # the kernel's shared-memory tiles are sized for Dqk <= 128


def gau_attention_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                            kv_mask: Optional[torch.Tensor], scale: float,
                            block_q: int = 1024) -> torch.Tensor:
    """Plain twin, blockwise over query rows: [B, T, Dqk] q, k and
    [B, T, De] v + optional [B, T] 0/1 key mask -> [B, T, De]. A masked key
    contributes exactly 0 (the mask multiplies the scaled logits)."""
    b, t, _ = q.shape
    out = torch.empty((b, t, v.shape[-1]), dtype=torch.float32, device=q.device)
    kt = k.transpose(1, 2)
    m = None if kv_mask is None else kv_mask.to(torch.float32)[:, None, :]
    for i0 in range(0, t, block_q):
        s = torch.matmul(q[:, i0:i0 + block_q], kt) * scale
        if m is not None:
            s = s * m
        out[:, i0:i0 + block_q] = torch.matmul(torch.relu(s) ** 2, v)
    return out


@functools.cache
def _entry():
    """The C entry point, built, loaded and declared at the first launch."""
    return _build.kernel("act_gau_attention", [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4
                         + [ctypes.c_float, ctypes.c_void_p])


def gau_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  kv_mask: Optional[torch.Tensor], scale: float) -> torch.Tensor:
    """[B, T, Dqk] f32 q, k, [B, T, De] f32 v + optional [B, T] bool key mask
    -> [B, T, De] f32.

    CPU tensors run the plain twin; CUDA tensors launch the kernel
    (Dqk and De multiples of 4, Dqk <= 128)."""
    if q.device.type == "cpu":
        return gau_attention_reference(q, k, v, kv_mask, scale)
    if not q.is_cuda:
        raise ValueError(f"gau_attention: unsupported device {q.device}")
    b, t, dqk = q.shape
    de = v.shape[-1]
    for name, x, shape in (("q", q, (b, t, dqk)), ("k", k, (b, t, dqk)), ("v", v, (b, t, de))):
        if x.dtype != torch.float32 or tuple(x.shape) != shape or x.device != q.device:
            raise ValueError(f"gau_attention: {name} must be float32 {shape} on {q.device}, "
                             f"got {x.dtype} {tuple(x.shape)} on {x.device}")
    if dqk % 4 or de % 4 or not 0 < dqk <= MAX_QK_DIM:
        raise ValueError(f"gau_attention: needs Dqk % 4 == 0, Dqk <= {MAX_QK_DIM} and "
                         f"De % 4 == 0, got Dqk={dqk}, De={de}")
    q, k, v = _aligned(q), _aligned(k), _aligned(v)
    mask_ptr = None
    if kv_mask is not None:
        if tuple(kv_mask.shape) != (b, t) or kv_mask.device != q.device:
            raise ValueError(f"gau_attention: kv_mask must be {(b, t)} on {q.device}, "
                             f"got {tuple(kv_mask.shape)} on {kv_mask.device}")
        # the kernel reads one byte a key and tests it against 0: a bool or
        # uint8 mask goes as it is, without a cast of its own
        if kv_mask.dtype not in (torch.bool, torch.uint8):
            kv_mask = kv_mask != 0
        kv_mask = kv_mask.contiguous()
        mask_ptr = kv_mask.data_ptr()
    out = torch.empty((b, t, de), dtype=torch.float32, device=q.device)
    if out.numel() == 0:
        return out
    fn = _entry()
    gau_attention.launches += 1
    _build.check("act_gau_attention", fn(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), mask_ptr, out.data_ptr(), b, t, dqk, de,
        float(scale), torch.cuda.current_stream(q.device).cuda_stream))
    return out


gau_attention.launches = 0  # kernel launches, counted where they happen
