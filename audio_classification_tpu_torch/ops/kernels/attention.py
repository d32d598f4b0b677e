"""K3 and K5: masked non-causal multi-head attention as a streaming softmax.

Kernels: csrc/flash_attention.cu (CUDA C++, sm_90a; one body with two
epilogues at each dtype), replacing
audio_classification_tpu/ops/pallas/attention_kernel.py::flash_attention
(K3: out = acc / l) and ::flash_attention_stats (K5: the unnormalised
accumulator with the row's running max m and sum l, which
parallel/ring_attention.py merges across key blocks). Bound and design are
in the source's header. K3's plain twin is the dense masked softmax the JAX
package uses below the flash threshold (models/common.py:237-245); K5's is
the same softmax stopped before its division, with K5's 0 / -1e9 key bias.

float32 q, k, v run in 3xTF32 on Hopper's warpgroup products, fed by TMA,
in two launches a call: a split launch writes k split into TF32 halves and
v transposed and split (``tf32_split_kv`` is its plain version; the wrapper
allocates the scratch with ``torch.empty``), then the attention launch,
planned by ``tf32_plan``.

bfloat16 q, k, v take entry points of their own (``act_flash_attention_bf16``,
``act_flash_attention_stats_bf16``: both products on ``wgmma`` in the
attention pipeline of csrc/attention_wgmma.cuh, planned by ``bf16_plan``),
as the JAX kernels take bf16: the scores, m, l and the accumulator stay
float32, p is rounded to bfloat16 before p v (attention_kernel.py:99) and
the output is float32. p is rounded
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
import functools
import math
from typing import Optional, Sequence

import torch
import torch.nn.functional as F

from ... import _build
from ..work import counted

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


def valid_key_count(b: int, tk: int, valid_keys: Optional[Sequence[int]]) -> int:
    """The keys a work count takes: ``valid_keys`` (one count an item)
    summed, or all b x tk when it is None."""
    return b * tk if valid_keys is None else sum(valid_keys)


def work(b: int, h: int, tq: int, tk: int, d: int, itemsize: int = 4, masked: bool = True,
         valid_keys: Optional[Sequence[int]] = None) -> dict:
    """K3's work on q [b, h, tq, d] against tk keys: 4 Tq Tk D products a
    head (q k^T and p v) and Tq Tk exponentials, over the valid keys (a
    masked key adds exp(-1e9) = 0, and a tile without one is skipped);
    bytes: q read and the float32 output written for every row, k and v
    for the valid keys, q, k, v at ``itemsize`` bytes, and the one-byte key
    mask when there is one. ``valid_keys``: one count an item; None counts
    the padded shape, b x tk."""
    n = valid_key_count(b, tk, valid_keys)
    q = b * h * tq * d
    return {"flops": 4.0 * h * tq * n * d, "exps": 1.0 * h * tq * n,
            "bytes": itemsize * (q + 2.0 * h * d * n) + 4.0 * q + (b * tk if masked else 0)}


def stats_work(b: int, h: int, tq: int, tk: int, d: int, itemsize: int = 4,
               masked: bool = True, valid_keys: Optional[Sequence[int]] = None) -> dict:
    """K5's work: K3's (``work``), with m and l written beside the
    unnormalised output."""
    out = work(b, h, tq, tk, d, itemsize, masked, valid_keys)
    return {**out, "bytes": out["bytes"] + 8.0 * b * h * tq}


def padded_head_dim(d: int) -> int:
    """The head dim a true head dim d runs at: the least of ``HEAD_DIMS``
    >= d, and above the largest, d rounded up to a multiple of
    ``WIDE_SLAB`` (the wide body)."""
    for inst in HEAD_DIMS:
        if d <= inst:
            return inst
    return -(-d // WIDE_SLAB) * WIDE_SLAB


#: the bf16 bodies' blocks (csrc/attention_wgmma.cuh): a {64, 64} bf16 box
#: of 128-byte rows, and the shared memory the ring's stages are sized within
BF16_BOX = 64 * 128
BF16_SMEM_CAP = 224 * 1024
#: the wide body (head dims above 256): its stages, each four boxes
BF16_WIDE_STAGES = 4


def bf16_block(nd: int, dv: int, nwg: int, n_tiles: int) -> dict:
    """Threads, ring stages and dynamic shared memory of a block of the bf16
    attention pipeline (``attention_wgmma.cuh`` ``Cfg``) with ``nd`` boxes of
    q and K, ``dv`` columns of p v and ``nwg`` consumer warpgroups (one
    takes a producer warp, two a producer warpgroup), over ``n_tiles`` key
    tiles."""
    nv = -(-dv // 64)
    q_bytes, slot = nwg * nd * BF16_BOX, (nd + nv) * BF16_BOX
    stages = min(4, (BF16_SMEM_CAP - q_bytes - 4096) // slot)
    return {"threads": 128 * nwg + (128 if nwg == 2 else 32), "stages": stages,
            "smem": 1024 + q_bytes + stages * slot + 4 * stages * BLOCK_K
                    + 8 * (2 * stages + 1) + n_tiles}


def bf16_plan(batch: int, heads: int, tq: int, tk: int, d: int) -> dict:
    """The launch of a bf16 K3 / K5 call on q [batch, heads, tq, d] and
    [.., tk, d] keys, as ``csrc/flash_attention.cu`` plans it (its
    ``act_flash_attention_bf16_plan`` returns the same): the head dim it
    runs at, output columns a block, the grid (64-row tiles, batch x heads,
    column slices) and the block's threads, stages and shared memory. A
    block is one consumer warpgroup of 64 query rows. Up to 256 it holds
    every column (one wgmma of N = D for p v); above, the wide body splits
    them into slices of at most 256, rounded up to 64."""
    dp = padded_head_dim(d)
    items, n_tiles = batch * heads, -(-tk // BLOCK_K)
    if dp > 256:
        n_sl = -(-dp // 256)
        cols = -(-(-(-dp // n_sl)) // 64) * 64
        wide = 4 * BF16_BOX
        block = {"threads": 160, "stages": BF16_WIDE_STAGES,
                 "smem": 1024 + BF16_WIDE_STAGES * (wide + 4 * BLOCK_K + 16) + n_tiles}
        return {"head_dim": dp, "cols": cols, "grid": (-(-tq // 64), items, n_sl), **block}
    return {"head_dim": dp, "cols": dp, "grid": (-(-tq // 64), items, 1),
            **bf16_block(-(-dp // 64), dp, 1, n_tiles)}


#: the float32 bodies (csrc/flash_attention.cu, namespace t32): a swizzled
#: row of 32 floats, a {32 d, 64 rows} box of q, the dynamic shared memory a
#: block may take and the part of it the ring's stages leave to the rest
#: (alignment slack, key bias, barriers, live-tile map); the card's SMs,
#: whose rounds the plan counts; the wide body's output columns a block,
#: keys a tile and ring stages
TF32_ROW, TF32_QBOX = 128, 64 * 128
TF32_SMEM_MAX, TF32_SMEM_RESERVE = 232448, 3072
TF32_SMS = 132
TF32_WIDE_COLS, TF32_WIDE_KEYS, TF32_WIDE_STAGES = 128, 32, 4


def tf32_keys(dp: int) -> int:
    """Keys a tile of the float32 narrow body at head dim ``dp`` (64, 80,
    128): 64 at D = 64, else 32 (a 64-key stage of both halves of K and
    v^T would not leave room for two stages)."""
    return 64 if dp == 64 else 32


def tf32_plan(batch: int, heads: int, tq: int, tk: int, d: int) -> dict:
    """The launch of a float32 K3 / K5 call on q [batch, heads, tq, d] and
    [.., tk, d] keys, as ``csrc/flash_attention.cu`` plans it (its
    ``act_flash_attention_plan`` returns the same): the head dim it runs at,
    consumer warpgroups of 64 query rows a block, output columns a block,
    the grid (row blocks, batch x heads, column slices), the block's
    threads, stages of each of its two rings (K's, v^T's), shared memory
    and keys a tile, and the split launch's scratch in floats
    (``k_split``, ``v_split``, and ``q_split`` for the wide body above 128,
    else 0). At 64 and 80 a block is two
    warpgroups (128 rows sharing each K / v^T tile) where the rounds of
    ``TF32_SMS`` times a block's cost are fewer: in quarter key tiles, a
    prologue of 2 tiles and then 4 a tile with one warpgroup, 7 with two (a
    block of two took 1.75x one of one on the card). One at 128 (q's halves
    of 128 rows leave no second stage) and in the wide body, whose blocks hold
    ``TF32_WIDE_COLS`` output columns each. The wrapper reads only the
    scratch sizes; the geometry is mirrored so that the CPU tests can show
    that the grid covers every query row and output column once (a card
    test holds it to the C plan)."""
    dp = padded_head_dim(d)
    items = batch * heads
    tkp = -(-tk // 8) * 8
    scratch = {"k_split": 2 * items * tk * dp, "v_split": 2 * items * dp * tkp,
               "q_split": 2 * items * tq * dp if dp > 128 else 0}
    if dp > 128:
        bk, stages = TF32_WIDE_KEYS, TF32_WIDE_STAGES
        slot = 2 * 2 * TF32_QBOX + 2 * 2 * bk * TF32_ROW
        return {"head_dim": dp, "nwg": 1, "cols": TF32_WIDE_COLS,
                "grid": (-(-tq // 64), items, -(-dp // TF32_WIDE_COLS)), "threads": 160,
                "stages": stages, "keys": bk, **scratch,
                "smem": 1024 + stages * slot + 4 * stages * bk + 16 * stages + -(-tk // bk)}
    bk, nd = tf32_keys(dp), -(-dp // 32)
    nwg = 1
    if dp != 128:
        rounds = [-(-(-(-tq // (64 * n)) * items) // TF32_SMS) for n in (1, 2)]
        tiles = -(-tk // bk)
        nwg = 2 if rounds[1] * (8 + 7 * tiles) < rounds[0] * (8 + 4 * tiles) else 1
    q_half = nwg * nd * TF32_QBOX
    slot = 2 * nd * bk * TF32_ROW + 2 * (bk // 32) * dp * TF32_ROW  # K's and v^T's halves
    stages = min(4, (TF32_SMEM_MAX - TF32_SMEM_RESERVE - 2 * q_half) // slot)
    return {"head_dim": dp, "nwg": nwg, "cols": dp,
            "grid": (-(-tq // (64 * nwg)), items, 1),
            "threads": 128 * nwg + (128 if nwg == 2 else 32), "stages": stages, "keys": bk,
            **scratch, "smem": 1024 + 2 * q_half + stages * slot + 4 * stages * bk
                               + 8 * (4 * stages + 1) + -(-tk // bk)}


def tf32_split(x: torch.Tensor) -> tuple:
    """float32 x = big + small, both rounded to TF32 to nearest with ties
    away from zero, bit for bit as tf32_mma.cuh's ``split`` forms them (add
    half of the 13 dropped bits to the magnitude's pattern, then clear
    them): big + small is x within 2^-22 of |x|."""
    def rna(v):
        return ((v.contiguous().view(torch.int32) + 0x1000) & ~0x1FFF).view(torch.float32)

    big = rna(x)
    return big, rna(x - big)


#: v^T's key order inside each group of 8: position i holds key 2 i, i + 4
#: key 2 i + 1, so that a warp's score accumulator is p v's A fragment
TF32_KEY_ORDER = (0, 2, 4, 6, 1, 3, 5, 7)


def tf32_split_kv(k: torch.Tensor, v: torch.Tensor, q: Optional[torch.Tensor] = None) -> tuple:
    """The float32 kernels' split copies, as their split launch writes them
    (the plain version of ``tf32_split_kernel``, csrc/attention_wgmma.cuh),
    flat: k [B, H, Tk, D] as [2, B H, Tk, D] (big halves, then small; K-major
    as it lies), v as [2, B H, D, Tkp] (transposed, Tkp = Tk rounded up to
    8, keys in ``TF32_KEY_ORDER`` inside each group of 8, zero past Tk), and
    q (the wide body's, else None) as k. D is the head dim the kernels run
    at (the wrapper's zero-padded one)."""
    b, h, tk, d = k.shape
    tkp = -(-tk // 8) * 8
    ks = torch.cat([x.reshape(-1) for x in tf32_split(k.float())])
    vt = F.pad(v.float().reshape(b * h, tk, d), (0, 0, 0, tkp - tk))
    vt = vt.view(b * h, tkp // 8, 8, d)[:, :, list(TF32_KEY_ORDER)].reshape(b * h, tkp, d)
    vs = torch.cat([x.reshape(-1) for x in tf32_split(vt.transpose(1, 2).contiguous())])
    qs = None if q is None else torch.cat([x.reshape(-1) for x in tf32_split(q.float())])
    return ks, vs, qs


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


@functools.cache
def _entry(name: str, pointers: int, ints: int):
    """The C entry point, built, loaded and declared at the first launch."""
    return _build.kernel(name, [ctypes.c_void_p] * pointers + [ctypes.c_int] * ints
                         + [ctypes.c_float, ctypes.c_void_p])


def _split_scratch(b: int, h: int, tq: int, tk: int, d: int, device) -> list:
    """The float32 call's split scratch (``tf32_plan``): k's and v^T's
    halves, and q's for the wide body (else None). The caller holds the
    tensors until the launch is queued: a tensor freed earlier would hand
    its block to the next allocation."""
    pl = tf32_plan(b, h, tq, tk, d)
    return [torch.empty(pl[key], dtype=torch.float32, device=device) if pl[key] else None
            for key in ("k_split", "v_split", "q_split")]


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


@counted(lambda q, k, v, kv_mask: work(q.shape[0], q.shape[1], q.shape[-2], k.shape[-2],
                                        q.shape[-1], q.element_size(), kv_mask is not None))
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
    ptrs = [q.data_ptr(), k.data_ptr(), v.data_ptr(), mask_ptr, out.data_ptr()]
    if lowp:
        name = "act_flash_attention_bf16"
        flash_attention.launches_bf16 += 1
    else:
        name = "act_flash_attention"
        scratch = _split_scratch(b, h, t, t, d, q.device)
        ptrs += [None if x is None else x.data_ptr() for x in scratch]
        flash_attention.launches += 1
    flash_attention.launches_by_head_dim[d] += 1
    _build.launch(name, _entry(name, len(ptrs), 4), q.device, *ptrs, b, h, t, q.shape[-1],
                  1.0 / math.sqrt(d))
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


@counted(lambda q, k, v, kv_mask: stats_work(q.shape[0], q.shape[1], q.shape[-2],
                                              k.shape[-2], q.shape[-1], q.element_size(),
                                              kv_mask is not None))
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
    ptrs = [q.data_ptr(), k.data_ptr(), v.data_ptr(), mask_ptr, out.data_ptr(), m.data_ptr(),
            l.data_ptr()]
    if lowp:
        name = "act_flash_attention_stats_bf16"
        flash_attention_stats.launches_bf16 += 1
    else:
        name = "act_flash_attention_stats"
        scratch = _split_scratch(b, h, tq, tk, d, q.device)
        ptrs += [None if x is None else x.data_ptr() for x in scratch]
        flash_attention_stats.launches += 1
    flash_attention_stats.launches_by_head_dim[d] += 1
    _build.launch(name, _entry(name, len(ptrs), 5), q.device, *ptrs, b, h, tq, tk, q.shape[-1],
                  1.0 / math.sqrt(d))
    return out_d, m, l


flash_attention_stats.launches = 0  # K5's launches, counted apart from K3's
flash_attention_stats.launches_bf16 = 0
flash_attention_stats.launches_by_head_dim = collections.Counter()
