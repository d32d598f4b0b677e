"""K4: gated-attention-unit scores, relu(q k^T * scale * key_mask)^2 v.

Kernel: csrc/gau_attention.cu (CUDA C++, sm_90a: both products on the
tensor cores in 3xTF32 by mma.sync), replacing
audio_classification_tpu/ops/pallas/attention_kernel.py::gau_attention.
Bound and design are in the source's header. The plain twin below walks
blocks of query rows (as the JAX package's ``_gau_blockwise_ref``), so it
never holds a [T, T] matrix: at T = 63999 frames a dense float32 [T, T] is
16 GB per item.

bfloat16 q, k, v (MossFormer's first GAU layer in the engine's bf16 mode)
take their own entry point, ``act_gau_attention_bf16``: both products are
single bf16 tensor-core products with float32 accumulators, and p is rounded
to bfloat16 before p v, as the JAX kernel casts p to v's dtype
(attention_kernel.py:337). The output is float32 either way.

Gradients: with grad enabled and an input that requires it, the wrapper goes
through ``_GauCore``, the counterpart of the JAX ``custom_vjp``
(attention_kernel.py:390-407): its forward is the wrapper's (the kernel on
the card, counted as ever; the twin on the CPU) and saves the inputs; its
backward differentiates the twin a block of query rows at a time
(attention.blockwise_vjp: about 16M scores a block), as the JAX ``bwd``
differentiates ``_gau_blockwise_ref``, summing dk and dv over the blocks in
float32. The key mask gets no gradient. There is no
backward kernel, as there is no backward Pallas kernel: the backward is torch
code, as XLA code is outside a kernel.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from ... import _build
from .attention import _aligned, _wants_grad, blockwise_vjp

MAX_QK_DIM = 128  # the kernel's shared-memory tiles are sized for Dqk <= 128


def gau_attention_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                            kv_mask: Optional[torch.Tensor], scale: float,
                            block_q: int = 1024, acc: Optional[torch.dtype] = None
                            ) -> torch.Tensor:
    """Plain twin, blockwise over query rows: [B, T, Dqk] q, k and
    [B, T, De] v + optional [B, T] 0/1 key mask -> [B, T, De]. A masked key
    contributes exactly 0 (the mask multiplies the scaled logits).

    The products run in ``acc`` (default: float32, or the inputs' dtype when
    it is wider); bfloat16 inputs round p to bfloat16 before p v, as the
    bf16 kernel does, and give float32."""
    b, t, _ = q.shape
    lowp = q.dtype == torch.bfloat16
    acc = acc or (torch.float32 if lowp else q.dtype)
    out_dtype = torch.float32 if lowp else acc
    out = torch.empty((b, t, v.shape[-1]), dtype=out_dtype, device=q.device)
    kt = k.to(acc).transpose(1, 2)
    va = v.to(acc)
    m = None if kv_mask is None else kv_mask.to(acc)[:, None, :]
    for i0 in range(0, t, block_q):
        s = torch.matmul(q[:, i0:i0 + block_q].to(acc), kt) * scale
        if m is not None:
            s = s * m
        p = torch.relu(s) ** 2
        if lowp:
            p = p.to(torch.bfloat16).to(acc)
        out[:, i0:i0 + block_q] = torch.matmul(p, va)
    return out


@functools.cache
def _entry(name: str):
    """The C entry point, built, loaded and declared at the first launch."""
    return _build.kernel(name, [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4
                         + [ctypes.c_float, ctypes.c_void_p])


class _GauCore(torch.autograd.Function):
    """K4 under autograd: the wrapper's forward, the twin's blockwise
    backward; no gradient for the mask or the scale."""

    @staticmethod
    def forward(ctx, q, k, v, kv_mask, scale):
        ctx.save_for_backward(q, k, v, kv_mask)
        ctx.scale = scale
        return _gau_forward(q, k, v, kv_mask, scale)

    @staticmethod
    def backward(ctx, g):
        q, k, v, kv_mask = ctx.saved_tensors
        dq, dk, dv = blockwise_vjp(
            lambda qb, kd, vd: gau_attention_reference(qb, kd, vd, kv_mask, ctx.scale,
                                                       block_q=qb.shape[1]),
            q, k, v, (g,), row_axis=1)
        return dq, dk, dv, None, None


def gau_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  kv_mask: Optional[torch.Tensor], scale: float) -> torch.Tensor:
    """[B, T, Dqk] q, k, [B, T, De] v, all float32 or all bfloat16, +
    optional [B, T] bool key mask -> [B, T, De] f32.

    CPU tensors run the plain twin; CUDA tensors launch the kernel of their
    dtype (float32: Dqk and De multiples of 4; bfloat16: multiples of 8;
    Dqk <= 128), counted in ``launches`` / ``launches_bf16``. A bfloat16 q
    never runs the float32 kernel. Under autograd the call goes through
    ``_GauCore`` (the same forward, the twin's backward)."""
    if _wants_grad(q, k, v):
        return _GauCore.apply(q, k, v, kv_mask, scale)
    return _gau_forward(q, k, v, kv_mask, scale)


def _gau_forward(q, k, v, kv_mask, scale):
    b, t, dqk = q.shape
    de = v.shape[-1]
    # float64 (the twin's gradcheck) on the CPU only: the kernels take neither
    dtypes = (torch.float32, torch.bfloat16) + ((torch.float64,) if q.device.type == "cpu" else ())
    for name, x, shape in (("q", q, (b, t, dqk)), ("k", k, (b, t, dqk)), ("v", v, (b, t, de))):
        if (q.dtype not in dtypes or x.dtype != q.dtype
                or tuple(x.shape) != shape or x.device != q.device):
            raise ValueError(f"gau_attention: {name} must be float32 or bfloat16 (as q) {shape} "
                             f"on {q.device}, got {x.dtype} {tuple(x.shape)} on {x.device}")
    if q.device.type == "cpu":
        return gau_attention_reference(q, k, v, kv_mask, scale)
    if not q.is_cuda:
        raise ValueError(f"gau_attention: unsupported device {q.device}")
    lowp = q.dtype == torch.bfloat16
    step = 8 if lowp else 4
    if dqk % step or de % step or not 0 < dqk <= MAX_QK_DIM:
        raise ValueError(f"gau_attention: needs Dqk % {step} == 0, Dqk <= {MAX_QK_DIM} and "
                         f"De % {step} == 0 for {q.dtype}, got Dqk={dqk}, De={de}")
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
    name = "act_gau_attention_bf16" if lowp else "act_gau_attention"
    fn = _entry(name)
    if lowp:
        gau_attention.launches_bf16 += 1
    else:
        gau_attention.launches += 1
    _build.launch(name, fn, q.device, q.data_ptr(), k.data_ptr(), v.data_ptr(), mask_ptr,
                  out.data_ptr(), b, t, dqk, de, float(scale))
    return out


# kernel launches, counted where they happen: float32 and bfloat16 entry points
gau_attention.launches = 0
gau_attention.launches_bf16 = 0
