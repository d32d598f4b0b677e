"""Sequence-parallel ring attention (port of
audio_classification_tpu/parallel/ring_attention.py).

The sequence axis is cut into ``mesh.shape[axis]`` shards. Shard i keeps its
query block; the key, value and mask blocks travel round the ring, one
neighbour a step, and each shard folds the block it holds into a running
(max m, sum l, unnormalised output o) with the streaming-softmax rescaling.
After n steps every shard has seen every key, and o / l is full softmax
attention. From ``FLASH_MIN_T`` frames a shard on, a block's (o, m, l) comes
from kernel K5 (ops/kernels/attention.flash_attention_stats, its twin on the
CPU) and the [Ts, Ts] block logits never reach device memory; below it from
the dense block.

The shard program is written once, as a loop over the shards in one
process: the mesh's entries name one device (parallel/mesh.py). The only
thing that crosses shards is ``_ppermute_ring``; a mesh over several cards
puts its send/recv there and leaves the shard body as it is.

Layout: the public function takes [B, T, H, D], as the JAX function does.
Inside, everything stays in K5's [B, H, Ts, D] layout: one transposing copy
at entry splits q, k, v into n contiguous blocks, one at exit joins the
shards' outputs, and the n^2 block calls in between copy nothing.
"""
from __future__ import annotations

import math
from typing import List, Optional

import torch

from ..ops.kernels.attention import FLASH_MIN_T, flash_attention_stats


def _local_attn_block(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float,
                      kv_mask: Optional[torch.Tensor] = None) -> tuple:
    """q [B,H,Ts,D] x k, v [B,H,Tb,D] -> (m [B,H,Ts], l [B,H,Ts], o [B,H,Ts,D]):
    row max of the scores, exp-sums under it, and the unnormalised weighted v.
    kv_mask [B,Tb] (True = valid key) masks padded keys of this block.

    The two branches mask differently. K5 adds a 0 / -1e9 bias, so a block
    masked whole comes back as m = -1e9, l = Tb; the dense block gives
    m = -1e30, l = 0, o = 0. Both vanish in the merge, exp(m_b - m_new) = 0,
    once the row has met one valid key in any block.

    bfloat16 q, k, v go to K5's bfloat16 entry as they are (p rounded to
    bf16 there); the dense block computes them in float32, as the JAX
    einsums with ``preferred_element_type=float32`` and p promoting v do.
    Either way the triple is float32."""
    if q.shape[2] >= FLASH_MIN_T:
        if not math.isclose(scale, 1.0 / math.sqrt(q.shape[-1])):
            raise ValueError("ring attention: K5 scales by 1/sqrt(D) only")
        o, m, l = flash_attention_stats(q, k, v, kv_mask)
        return m, l, o
    q, k, v = q.float(), k.float(), v.float()
    logits = torch.matmul(q, k.transpose(-1, -2)) * scale
    if kv_mask is not None:
        keep = kv_mask.bool()[:, None, None, :]
        logits = logits.masked_fill(~keep, -1e30)
    m = logits.amax(dim=-1)
    p = torch.exp(logits - m[..., None])
    if kv_mask is not None:
        p = p * keep.to(p.dtype)
    return m, p.sum(dim=-1), torch.matmul(p, v)


def _ppermute_ring(blocks: List) -> List:
    """One ring step: shard i receives what shard i - 1 held (the
    ``ppermute`` with perm [(j, j + 1 mod n)] of the JAX shard body). Every
    shard lives in this process, so it is a rotation of the list."""
    return blocks[-1:] + blocks[:-1]


def _merge(carry: tuple, block: tuple) -> tuple:
    """Fold one block's (m, l, o) into the running triple."""
    m, l, o = carry
    m_b, l_b, o_b = block
    m_new = torch.maximum(m, m_b)
    c_old = torch.exp(m - m_new)
    c_new = torch.exp(m_b - m_new)
    return m_new, l * c_old + l_b * c_new, o * c_old[..., None] + o_b * c_new[..., None]


def _to_blocks(x: torch.Tensor, n: int) -> torch.Tensor:
    """[B, T, H, D] -> [n, B, H, T/n, D], each block contiguous."""
    b, t, h, d = x.shape
    return x.reshape(b, n, t // n, h, d).permute(1, 0, 3, 2, 4).contiguous()


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, mesh, axis: str = "data",
                   kv_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Full-softmax attention with the sequence axis cut over ``axis``.

    q, k, v: [B, T, H, D], all float32 or all bfloat16; T must divide by
    mesh.shape[axis]. Optional kv_mask [B, T] (True = valid key) masks
    padded positions; its blocks travel the ring with K and V. Returns
    [B, T, H, D] float32 (the merge is float32 at either dtype)."""
    n = mesh.shape[axis]
    b, t, h, d = q.shape
    if t % n != 0:
        raise ValueError(f"ring_attention: T = {t} must divide by the {n} shards of {axis!r}")
    scale = 1.0 / math.sqrt(d)
    q_blk = _to_blocks(q, n)
    k_cur, v_cur = list(_to_blocks(k, n)), list(_to_blocks(v, n))
    mask_cur = [None] * n
    if kv_mask is not None:
        # bytes, the form K5 takes: converted here once, not at each of its n^2 calls
        mask_u8 = kv_mask.to(torch.uint8).reshape(b, n, t // n)
        mask_cur = list(mask_u8.transpose(0, 1).contiguous())

    carry = [_local_attn_block(q_blk[i], k_cur[i], v_cur[i], scale, mask_cur[i])
             for i in range(n)]
    for _ in range(1, n):
        k_cur, v_cur, mask_cur = (_ppermute_ring(z) for z in (k_cur, v_cur, mask_cur))
        carry = [_merge(carry[i], _local_attn_block(q_blk[i], k_cur[i], v_cur[i], scale,
                                                    mask_cur[i]))
                 for i in range(n)]
    out = torch.stack([o / torch.clamp_min(l, 1e-30)[..., None] for _m, l, o in carry])
    # [n, B, H, Ts, D] -> [B, T, H, D]
    return out.permute(1, 0, 3, 2, 4).reshape(b, t, h, d)


def reference_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        kv_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One-shard oracle, [B, T, H, D] -> [B, T, H, D]."""
    qh, kh, vh = (z.transpose(1, 2) for z in (q, k, v))
    logits = torch.matmul(qh, kh.transpose(-1, -2)) / math.sqrt(q.shape[-1])
    if kv_mask is not None:
        logits = logits.masked_fill(~kv_mask.bool()[:, None, None, :], -1e30)
    return torch.matmul(torch.softmax(logits, dim=-1), vh).transpose(1, 2)
