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

bfloat16 q, k, v take entry points of their own (``act_flash_attention_bf16``,
``act_flash_attention_stats_bf16``), as the JAX kernels take bf16: the
scores, m, l and the accumulator stay float32, p is rounded to bfloat16
before p v (attention_kernel.py:99) and the output is float32. p is rounded
against the running max of the key blocks seen so far, so the result
depends on the key-block width: the twins ``attention_reference_lowp`` /
``attention_stats_reference_lowp`` take it as ``block_k`` (``BLOCK_K``, the
kernels' tile, by default; the JAX kernel's is min(256, round_up(Tk, 128)),
attention_kernel.py:247).

Gradients: with grad enabled and an input that requires it, the wrappers go
through ``_FlashCore`` / ``_FlashStatsCore``, the counterparts of the JAX
``custom_vjp``s (attention_kernel.py:194-232). Their forward is the wrapper's
(the kernel on the card, counted as ever; the twin on the CPU) and saves the
inputs, not the scores. Their backward differentiates the plain twin, as the
JAX ``bwd`` differentiates its XLA replica ``_blockwise_ref``: one block of
query rows at a time (a multiple of 256 rows, ``backward_rows``: about 16M
scores a block) is recomputed under autograd and dk, dv summed over the
blocks, so the backward holds one block's scores and never [T, T]. The JAX package has no backward Pallas kernel, so neither has
the port: the backward is torch code, as XLA code is outside a kernel. At
bfloat16 the twin is the JAX replica's: p rounded to bfloat16 against the
row's max over all keys (one key block), dk and dv summed in float32. The
key mask gets no gradient.
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
#: keys a tile of the CUDA bodies (csrc/flash_attention.cu BK): the block
#: width the bfloat16 twins take by default, on the CPU as on the card
BLOCK_K = 64
#: query rows the backward recomputes at a time: a multiple of 256 (the JAX
#: replica's block_q) whose scores hold about BACKWARD_BLOCK_ELEMS values
#: (64 MB in float32): few and large products, a bounded peak memory
BACKWARD_BLOCK_Q = 256
BACKWARD_BLOCK_ELEMS = 1 << 24


def backward_rows(rows: int, scores_per_row: int) -> int:
    """Query rows a backward block takes when each row holds
    ``scores_per_row`` scores (batch x heads x keys)."""
    fit = BACKWARD_BLOCK_ELEMS // max(scores_per_row, 1) // BACKWARD_BLOCK_Q * BACKWARD_BLOCK_Q
    return min(max(rows, 1), max(fit, BACKWARD_BLOCK_Q))


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


def attention_stats_reference_lowp(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                                   kv_mask: Optional[torch.Tensor] = None,
                                   scale: Optional[float] = None, block_k: int = BLOCK_K,
                                   acc: torch.dtype = torch.float32) -> tuple:
    """K5's twin at bfloat16 q, k, v -> (o, m, l) in ``acc``: the JAX body's
    streaming softmax over key blocks of ``block_k`` (keys past Tk left
    out, as the kernels leave them): per block, s = (q k^T) * scale + bias
    (0 / -1e9), m' = max(m, rowmax s), alpha = exp(m - m'), p = exp(s - m'),
    l = alpha l + rowsum p (p unrounded), o = alpha o + bf16(p) v.
    ``acc=torch.float64`` is the oracle with the same rounding points."""
    scale = 1.0 / math.sqrt(q.shape[-1]) if scale is None else scale
    qa, ka, va = (x.to(acc) for x in (q, k, v))
    tk = k.shape[2]
    bias = None
    if kv_mask is not None:
        bias = torch.zeros(kv_mask.shape, dtype=acc, device=q.device)
        bias = bias.masked_fill(~kv_mask.bool(), -1e9)[:, None, None, :]
    m = torch.full(q.shape[:3], -1e30, dtype=acc, device=q.device)
    l = torch.zeros_like(m)
    o = torch.zeros(q.shape, dtype=acc, device=q.device)
    for j0 in range(0, tk, block_k):
        j1 = min(j0 + block_k, tk)
        s = torch.matmul(qa, ka[:, :, j0:j1].transpose(-1, -2)) * scale
        if bias is not None:
            s = s + bias[..., j0:j1]
        m_new = torch.maximum(m, s.amax(dim=-1))
        alpha = torch.exp(m - m_new)
        p = torch.exp(s - m_new[..., None])
        l = alpha * l + p.sum(dim=-1)
        o = o * alpha[..., None] + torch.matmul(p.to(torch.bfloat16).to(acc), va[:, :, j0:j1])
        m = m_new
    return o, m, l


def attention_reference_lowp(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                             kv_mask: Optional[torch.Tensor] = None,
                             scale: Optional[float] = None, block_k: int = BLOCK_K,
                             acc: torch.dtype = torch.float32) -> torch.Tensor:
    """K3's twin at bfloat16 q, k, v: ``attention_stats_reference_lowp``'s
    o / max(l, 1e-30), in ``acc``."""
    o, _m, l = attention_stats_reference_lowp(q, k, v, kv_mask, scale, block_k, acc)
    return o / torch.clamp_min(l, 1e-30)[..., None]


def _is_bf16(name: str, q, k, v) -> bool:
    """Whether q, k, v are bfloat16; raises ValueError unless all three are
    float32 (float64 too, on the CPU twin) or all three bfloat16."""
    dts = {x.dtype for x in (q, k, v)}
    if len(dts) != 1 or torch.float16 in dts:
        raise ValueError(f"{name}: q, k and v must be all float32 or all bfloat16, got "
                         f"{', '.join(str(x.dtype) for x in (q, k, v))}")
    return dts == {torch.bfloat16}


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
    ValueError on anything else (q's dtype, float32 or bfloat16, for all)."""
    b, h, tq, d = q.shape
    tk = k.shape[2]
    for label, x, shape in (("q", q, (b, h, tq, d)), ("k", k, (b, h, tk, d)),
                            ("v", v, (b, h, tk, d))):
        if (x.dtype != q.dtype or q.dtype not in (torch.float32, torch.bfloat16)
                or tuple(x.shape) != shape or x.device != q.device):
            raise ValueError(f"{name}: {label} must be float32 or bfloat16 (as q) {shape} on "
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


def _wants_grad(*tensors) -> bool:
    """Whether autograd records this call: grad mode on and an input that
    requires grad."""
    return torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in tensors)


def blockwise_vjp(twin, q, k, v, cots, row_axis: int) -> tuple:
    """(dq, dk, dv) of ``twin(q_rows, k, v)`` (one tensor or a tuple) at the
    cotangents ``cots`` of its outputs, recomputed a block of query rows
    (along ``row_axis`` of q and of each cotangent) at a time
    (``backward_rows``); dk and dv sum over the blocks in float32 (or the
    inputs' wider dtype)."""
    n_rows = q.shape[row_axis]
    step = backward_rows(n_rows, math.prod(q.shape[:row_axis]) * k.shape[row_axis])
    acc = torch.promote_types(k.dtype, torch.float32)
    dq = torch.empty_like(q)
    dk = torch.zeros(k.shape, dtype=acc, device=k.device)
    dv = torch.zeros(v.shape, dtype=acc, device=v.device)
    with torch.enable_grad():
        kd, vd = k.detach().requires_grad_(), v.detach().requires_grad_()
        for i0 in range(0, n_rows, step):
            rows = (slice(None),) * row_axis + (slice(i0, i0 + step),)
            qb = q[rows].detach().requires_grad_()
            outs = twin(qb, kd, vd)
            dqb, dkb, dvb = torch.autograd.grad(outs if isinstance(outs, tuple) else (outs,),
                                                (qb, kd, vd), [g[rows] for g in cots])
            dq[rows] = dqb
            dk += dkb
            dv += dvb
    return dq, dk.to(k.dtype), dv.to(v.dtype)


def _twin_vjp(q, k, v, kv_mask, cots, stats: bool) -> tuple:
    """``blockwise_vjp`` of K3's (or, with ``stats``, K5's) plain twin. At
    bfloat16 the twin takes one key block: p rounds against the row's max
    over all keys, as in the JAX replica."""
    if q.dtype == torch.bfloat16:
        fn = attention_stats_reference_lowp if stats else attention_reference_lowp
        twin = lambda qb, kd, vd: fn(qb, kd, vd, kv_mask, block_k=max(k.shape[2], 1))  # noqa: E731
    else:
        fn = attention_stats_reference if stats else attention_reference
        twin = lambda qb, kd, vd: fn(qb, kd, vd, kv_mask)  # noqa: E731
    return blockwise_vjp(twin, q, k, v, cots, row_axis=2)


class _FlashCore(torch.autograd.Function):
    """K3 under autograd (attention_kernel.py:194-211): the wrapper's
    forward, the twin's blockwise backward; no gradient for the mask."""

    @staticmethod
    def forward(ctx, q, k, v, kv_mask):
        ctx.save_for_backward(q, k, v, kv_mask)
        return _flash_forward(q, k, v, kv_mask)

    @staticmethod
    def backward(ctx, g):
        q, k, v, kv_mask = ctx.saved_tensors
        return (*_twin_vjp(q, k, v, kv_mask, (g,), stats=False), None)


class _FlashStatsCore(torch.autograd.Function):
    """K5 under autograd (attention_kernel.py:214-232): cotangents for all
    three of (o, m, l) go through the twin, whose row max (``amax``) splits
    its gradient evenly among ties, as ``jnp.max``'s does."""

    @staticmethod
    def forward(ctx, q, k, v, kv_mask):
        ctx.save_for_backward(q, k, v, kv_mask)
        return _flash_stats_forward(q, k, v, kv_mask)

    @staticmethod
    def backward(ctx, go, gm, gl):
        q, k, v, kv_mask = ctx.saved_tensors
        return (*_twin_vjp(q, k, v, kv_mask, (go, gm, gl), stats=True), None)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    kv_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """[B, H, T, D] q, k, v, all float32 or all bfloat16, + optional [B, T]
    bool key mask -> [B, H, T, D] float32.

    CPU tensors run the plain twin (``attention_reference``; at bfloat16
    ``attention_reference_lowp`` over the kernels' key tiles); CUDA tensors
    launch the kernel of their dtype (any D, zero-padded to the head dim it
    runs at, ``padded_head_dim``; scale 1 / sqrt(D) of the true D), counted
    in ``launches`` or ``launches_bf16``. Under autograd the call goes
    through ``_FlashCore`` (the same forward, the twin's backward)."""
    if _wants_grad(q, k, v):
        return _FlashCore.apply(q, k, v, kv_mask)
    return _flash_forward(q, k, v, kv_mask)


def _flash_forward(q, k, v, kv_mask):
    lowp = _is_bf16("flash_attention", q, k, v)
    if q.device.type == "cpu":
        if lowp:
            return attention_reference_lowp(q, k, v, kv_mask)
        return attention_reference(q, k, v, kv_mask)
    if not q.is_cuda:
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    b, h, t, d = q.shape
    if k.shape[2] != t:
        raise ValueError(f"flash_attention: k has {k.shape[2]} rows, q has {t} "
                         "(self-attention only; flash_attention_stats takes both)")
    q, k, v, kv_mask = _check_qkv("flash_attention", q, k, v, kv_mask)
    mask_ptr = None if kv_mask is None else kv_mask.data_ptr()
    out = torch.empty(q.shape, dtype=torch.float32, device=q.device)
    if out.numel() == 0:
        return out[..., :d]
    name = "act_flash_attention_bf16" if lowp else "act_flash_attention"
    fn = _build.kernel(name, [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4
                       + [ctypes.c_float, ctypes.c_void_p])
    if lowp:
        flash_attention.launches_bf16 += 1
    else:
        flash_attention.launches += 1
    flash_attention.launches_by_head_dim[d] += 1
    _build.launch(name, fn, q.device, q.data_ptr(), k.data_ptr(), v.data_ptr(), mask_ptr,
                  out.data_ptr(), b, h, t, q.shape[-1], 1.0 / math.sqrt(d))
    return out[..., :d]  # the padded columns sliced off (a view)


# kernel launches, counted where they happen: the float32 and bfloat16 entry
# points apart, and both together by the true D
flash_attention.launches = 0
flash_attention.launches_bf16 = 0
flash_attention.launches_by_head_dim = collections.Counter()


def flash_attention_stats(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          kv_mask: Optional[torch.Tensor] = None) -> tuple:
    """K5: q [B, H, Tq, D], k, v [B, H, Tk, D], all float32 or all
    bfloat16, + optional [B, Tk] bool key mask -> float32 (o [B, H, Tq, D],
    m [B, H, Tq], l [B, H, Tq]): the streaming softmax without its final
    division (``attention_stats_reference``; at bfloat16
    ``attention_stats_reference_lowp``). o / l is the attention over these
    keys; triples of several key blocks merge by rescaling to a common m
    (parallel/ring_attention.py).

    CPU tensors run the plain twin; CUDA tensors launch the kernel of their
    dtype (Tk >= 1; any D, zero-padded as in ``flash_attention``). Under
    autograd the call goes through ``_FlashStatsCore``."""
    if _wants_grad(q, k, v):
        return _FlashStatsCore.apply(q, k, v, kv_mask)
    return _flash_stats_forward(q, k, v, kv_mask)


def _flash_stats_forward(q, k, v, kv_mask):
    lowp = _is_bf16("flash_attention_stats", q, k, v)
    if q.device.type == "cpu":
        if lowp:
            return attention_stats_reference_lowp(q, k, v, kv_mask)
        return attention_stats_reference(q, k, v, kv_mask)
    if not q.is_cuda:
        raise ValueError(f"flash_attention_stats: unsupported device {q.device}")
    b, h, tq, d = q.shape
    tk = k.shape[2]
    if tk < 1:
        raise ValueError("flash_attention_stats: needs at least one key")
    q, k, v, kv_mask = _check_qkv("flash_attention_stats", q, k, v, kv_mask)
    mask_ptr = None if kv_mask is None else kv_mask.data_ptr()
    out = torch.empty(q.shape, dtype=torch.float32, device=q.device)
    m = torch.empty((b, h, tq), dtype=torch.float32, device=q.device)
    l = torch.empty_like(m)
    out_d = out[..., :d]  # the padded columns sliced off (a view)
    if out.numel() == 0:
        return out_d, m, l
    name = "act_flash_attention_stats_bf16" if lowp else "act_flash_attention_stats"
    fn = _build.kernel(name, [ctypes.c_void_p] * 7 + [ctypes.c_int] * 5
                       + [ctypes.c_float, ctypes.c_void_p])
    if lowp:
        flash_attention_stats.launches_bf16 += 1
    else:
        flash_attention_stats.launches += 1
    flash_attention_stats.launches_by_head_dim[d] += 1
    _build.launch(name, fn, q.device, q.data_ptr(), k.data_ptr(), v.data_ptr(), mask_ptr,
                  out.data_ptr(), m.data_ptr(), l.data_ptr(), b, h, tq, tk, q.shape[-1],
                  1.0 / math.sqrt(d))
    return out_d, m, l


flash_attention_stats.launches = 0  # K5's launches, counted apart from K3's
flash_attention_stats.launches_bf16 = 0
flash_attention_stats.launches_by_head_dim = collections.Counter()
