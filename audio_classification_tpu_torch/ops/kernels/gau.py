"""K4: gated-attention-unit scores, relu(q k^T * scale * key_mask)^2 v.

Kernel: csrc/gau_attention.cu (CUDA C++, sm_90a: both products on
Hopper's warpgroup products in 3xTF32, fed by TMA; a split launch first
writes k split into TF32 halves and v transposed and split, ``tf32_plan``
gives the launch), replacing
audio_classification_tpu/ops/pallas/attention_kernel.py::gau_attention.
Bound and design are in the source's header. The plain twin below walks
blocks of query rows (as the JAX package's ``_gau_blockwise_ref``), so it
never holds a [T, T] matrix: at T = 63999 frames a dense float32 [T, T] is
16 GB per item.

bfloat16 q, k, v (MossFormer's first GAU layer in the engine's bf16 mode)
take their own entry point, ``act_gau_attention_bf16``: both products are
single bf16 ``wgmma`` products with float32 accumulators (the attention
pipeline of csrc/attention_wgmma.cuh, planned by ``bf16_plan``), and p is
rounded to bfloat16 before p v, as the JAX kernel casts p to v's dtype
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

from typing import Optional, Sequence

import torch

from ... import _build
from ..work import counted
from .attention import (BLOCK_K, _aligned, _entry, _wants_grad, bf16_block, blockwise_vjp,
                        valid_key_count)

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


#: the card's SMs, whose rounds of blocks the plan counts
BF16_SMS = 132
#: the float32 kernel's block: consumer warpgroups (64 query rows each),
#: output columns, keys a tile, ring stages (csrc/gau_attention.cu, t32)
TF32_WARPGROUPS, TF32_COLS, TF32_KEYS, TF32_STAGES = 2, 192, 32, 2


def tf32_plan(batch: int, t: int, dqk: int, de: int) -> dict:
    """The launch of a float32 K4 call, as ``csrc/gau_attention.cu`` plans
    it (its ``act_gau_attention_plan`` returns the same): blocks of
    ``TF32_WARPGROUPS`` x 64 query rows by ``TF32_COLS`` output columns
    (each forms its rows' scores), the grid (row blocks, batch, column
    chunks), the block's threads (a producer warpgroup beside the
    consumers), stages and shared memory (1024 bytes of alignment slack, q
    raw in ``Dqk / 32`` boxes of 32 dims, the stages' k and v^T halves,
    the keys' mask, the tile indices and the barriers), and the split
    launch's scratch: k split [2, B, T, Dqk], v^T split [2, B, De, Tp]
    with Tp = T rounded up to 8. The wrapper reads only the two scratch
    sizes; the launch's geometry is mirrored here, as in ``bf16_plan``, so
    that the CPU tests can show that the grid covers every query row and
    output column once (a card test holds it to the C plan)."""
    rows = 64 * TF32_WARPGROUPS
    slot = 2 * 4 * TF32_KEYS * 128 + 2 * TF32_COLS * 128
    smem = (1024 + 4 * rows * 128 + TF32_STAGES * slot + 4 * TF32_STAGES * TF32_KEYS
            + 4 * TF32_STAGES + 8 * (2 * TF32_STAGES + 1))
    tp = -(-t // 8) * 8
    return {"nwg": TF32_WARPGROUPS, "cols": TF32_COLS,
            "grid": (-(-t // rows), batch, -(-de // TF32_COLS)),
            "threads": 128 * TF32_WARPGROUPS + 128, "stages": TF32_STAGES, "smem": smem,
            "k_split": 2 * batch * t * dqk, "v_split": 2 * batch * de * tp}


def bf16_plan(batch: int, t: int, dqk: int, de: int) -> dict:
    """The launch of a bf16 K4 call, as ``csrc/gau_attention.cu`` plans it
    (its ``act_gau_attention_bf16_plan`` returns the same): one chunk of the
    De columns a block, nc = ceil(De / 256) chunks of ceil(De / nc) columns
    rounded up to 64; two consumer warpgroups a block (128 query rows
    sharing each K / V tile) where halving the blocks saves a round of
    ``BF16_SMS``, else one; the grid (row blocks, batch, chunks) and the
    block's threads, stages and shared memory (q and K in one 64-wide box up
    to Dqk 64, else two)."""
    nc = -(-de // 256)
    cols = -(-(-(-de // nc)) // 64) * 64
    rounds = [-(-(-(-t // (64 * n)) * batch * nc) // BF16_SMS) for n in (1, 2)]
    nwg = 2 if rounds[1] < rounds[0] else 1
    return {"nwg": nwg, "cols": cols, "grid": (-(-t // (64 * nwg)), batch, nc),
            **bf16_block(1 if dqk <= 64 else 2, cols, nwg, -(-t // BLOCK_K))}


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


def work(b: int, t: int, dqk: int, de: int, itemsize: int = 4, masked: bool = True,
         valid_keys: Optional[Sequence[int]] = None) -> dict:
    """K4's work on q, k [b, t, dqk], v [b, t, de]: 2 T n (Dqk + De) products
    for n valid keys (q k^T and p v; a masked key contributes exactly 0);
    bytes: q read and the float32 output written for every row, k and v for
    the valid keys, q, k, v at ``itemsize`` bytes, and the one-byte key mask
    when there is one. ``valid_keys``: one count an item; None counts the
    padded shape, b x t."""
    n = valid_key_count(b, t, valid_keys)
    return {"flops": 2.0 * t * n * (dqk + de),
            "bytes": itemsize * (b * t * dqk + n * (dqk + de)) + 4.0 * b * t * de
                     + (b * t if masked else 0)}


@counted(lambda q, k, v, kv_mask, scale: work(*q.shape, v.shape[-1], q.element_size(),
                                                kv_mask is not None))
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
    ptrs = [q.data_ptr(), k.data_ptr(), v.data_ptr(), mask_ptr, out.data_ptr()]
    if lowp:
        name = "act_gau_attention_bf16"
        gau_attention.launches_bf16 += 1
    else:
        name = "act_gau_attention"
        # the split launch's scratch: k's TF32 halves, v^T's
        pl = tf32_plan(b, t, dqk, de)
        scratch = [torch.empty(pl[key], dtype=torch.float32, device=q.device)
                   for key in ("k_split", "v_split")]
        ptrs += [x.data_ptr() for x in scratch]
        gau_attention.launches += 1
    _build.launch(name, _entry(name, len(ptrs), 4), q.device, *ptrs, b, t, dqk, de, float(scale))
    return out


# kernel launches, counted where they happen: float32 and bfloat16 entry points
gau_attention.launches = 0
gau_attention.launches_bf16 = 0
