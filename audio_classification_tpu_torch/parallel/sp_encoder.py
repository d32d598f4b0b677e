"""Sequence-parallel transformer encoder block (port of
audio_classification_tpu/parallel/sp_encoder.py).

A block for long-audio encoders whose attention runs ring-parallel over the
mesh (parallel/ring_attention) while the per-frame pieces (LN, QKV and out
projections, FFN) need nothing from another shard. ``sp_seq_shard`` /
``sp_seq_unshard`` are how an encoder enters and leaves the sharded regime:
pad the sequence to a multiple of the shard count with masked frames, slice
the padding off afterwards. The JAX functions also pin shardings for the
SPMD partitioner; here every rank holds the whole sequence and ring_attention
runs the rank's own shards, so there is nothing to pin.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..models.common import gelu
from .ring_attention import reference_attention, ring_attention


def sp_seq_shard(x: torch.Tensor, mask: Optional[torch.Tensor], mesh, sp_axis: str = "data"):
    """[B, T, C] (+ mask [B, T]) -> (x, mask, orig_t) with T padded to a
    multiple of the shard count; the padded frames are masked out."""
    n = mesh.shape[sp_axis]
    b, t = x.shape[0], x.shape[1]
    if mask is None:
        mask = torch.ones((b, t), dtype=torch.bool, device=x.device)
    mask = mask.bool()
    pad = (-t) % n
    if pad:
        x = F.pad(x, (0, 0, 0, pad))
        mask = F.pad(mask, (0, pad))
    return x, mask, t


def sp_seq_unshard(x: torch.Tensor, mesh, orig_t: int) -> torch.Tensor:
    """Leave the sharded regime: slice the ring padding off."""
    return x if x.shape[1] == orig_t else x[:, :orig_t]


class SPMultiHeadSelfAttention(nn.Module):
    """MHSA whose attention core is ring-parallel when a mesh is supplied.
    The same parameters serve both paths, so the dense path is the numeric
    oracle for the ring path."""

    def __init__(self, dim: int, heads: int):
        super().__init__()
        self.dim, self.heads = dim, heads
        self.qkv = nn.Linear(dim, 3 * dim)
        self.out = nn.Linear(dim, dim)

    def forward(self, x: torch.Tensor, mesh=None, axis: str = "data") -> torch.Tensor:
        b, t, _ = x.shape
        q, k, v = (z.reshape(b, t, self.heads, self.dim // self.heads)
                   for z in self.qkv(x).split(self.dim, dim=-1))
        if mesh is not None:
            out = ring_attention(q, k, v, mesh, axis=axis)
        else:
            out = reference_attention(q, k, v)
        return self.out(out.reshape(b, t, self.dim))


class SPTransformerBlock(nn.Module):
    """Pre-LN transformer block with sequence-parallel attention (no conv
    branch, no mask). Submodules carry the flax param names: flax numbers
    the two FFN layers in the order they are constructed, and the JAX block
    constructs the outer (contracting) one first, so ``Dense_1`` widens and
    ``Dense_0`` narrows."""

    def __init__(self, dim: int, heads: int, ffn_mult: int = 4):
        super().__init__()
        self.LayerNorm_0 = nn.LayerNorm(dim, eps=1e-6)
        self.attn = SPMultiHeadSelfAttention(dim, heads)
        self.LayerNorm_1 = nn.LayerNorm(dim, eps=1e-6)
        self.Dense_1 = nn.Linear(dim, dim * ffn_mult)
        self.Dense_0 = nn.Linear(dim * ffn_mult, dim)

    def forward(self, x: torch.Tensor, mesh=None, axis: str = "data") -> torch.Tensor:
        x = x + self.attn(self.LayerNorm_0(x), mesh, axis)
        return x + self.Dense_0(gelu(self.Dense_1(self.LayerNorm_1(x))))
