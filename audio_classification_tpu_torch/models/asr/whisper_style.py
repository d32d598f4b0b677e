"""Whisper-style encoder-decoder ASR, the autoregressive family (port of
audio_classification_tpu/models/asr/whisper_style.py): a transformer
encoder over the shared fbank frontend (conv subsample x2; at dim 256 and
4 heads its attention runs K3 at D = 64 from ``FLASH_MIN_T`` frames) and a
causal decoder with cross-attention.

Greedy decoding is a loop over output positions on device tensors with a
key / value cache per decoder layer: self-attention keys and values are
written into [B, L, H, Dh] caches, cross-attention keys and values are
computed once from the encoder memory. Every position runs (done items emit
EOS), so no step waits on the host.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Optional

import torch
from torch import nn

from ...ops.fbank import FbankConfig, log_mel_fbank
from ...ops.work import loop_step, shape_keyed
from ..common import (Conv1d, Dense, DenseQ, LayerNorm, MultiHeadSelfAttention, gelu,
                      lengths_to_mask, param_as, position_table)


@dataclass(frozen=True)
class WhisperStyleConfig:
    vocab_size: int = 512
    dim: int = 256
    heads: int = 4
    enc_layers: int = 4
    dec_layers: int = 2
    ffn_mult: int = 4
    num_mel: int = 80
    max_decode_len: int = 96
    bos_id: int = 1
    eos_id: int = 2
    quant: str = "none"   # "int8": the encoder's projections through ops/quant
                          # (the decoder stays float)
    fbank: FbankConfig = field(default_factory=FbankConfig)


def _split_heads(x: torch.Tensor, heads: int) -> torch.Tensor:
    b, n, d = x.shape
    return x.reshape(b, n, heads, d // heads)


def _attend(q, k, v, valid, additive: bool = False) -> torch.Tensor:
    """q [B, Lq, H, Dh], k, v [B, Lk, H, Dh], valid broadcastable to
    [B, H, Lq, Lk] -> [B, Lq, H * Dh], as the JAX einsums: the invalid
    scores replaced by -1e9 (causal self-attention), or with ``additive``
    shifted by -1e9 (cross-attention's key bias)."""
    logits = torch.einsum("bqhd,bkhd->bhqk", q, k) / math.sqrt(q.shape[-1])
    if additive:
        logits = logits + torch.where(valid, 0.0, -1e9)
    else:
        logits = torch.where(valid, logits, torch.full_like(logits, -1e9))
    attn = torch.softmax(logits, dim=-1)
    o = torch.einsum("bhqk,bkhd->bqhd", attn, v)
    return o.reshape(o.shape[0], o.shape[1], -1)


class CausalSelfAttention(nn.Module):
    def __init__(self, dim: int, heads: int):
        super().__init__()
        self.dim, self.heads = dim, heads
        self.qkv = Dense(dim, 3 * dim)
        self.out = Dense(dim, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """Full-sequence causal attention (teacher forcing)."""
        t = x.shape[1]
        q, k, v = (_split_heads(z, self.heads) for z in self.qkv(x).split(self.dim, dim=-1))
        causal = torch.tril(torch.ones((t, t), dtype=torch.bool, device=x.device))
        return self.out(_attend(q, k, v, causal[None, None]))

    def step(self, x_t: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor,
             pos: int) -> torch.Tensor:
        """One token with the cache: x_t [B, 1, D]; k_cache, v_cache
        [B, L, H, Dh], written at ``pos`` in place -> y_t [B, 1, D]."""
        q, k, v = (_split_heads(z, self.heads) for z in self.qkv(x_t).split(self.dim, dim=-1))
        k_cache[:, pos] = k[:, 0]
        v_cache[:, pos] = v[:, 0]
        valid = torch.arange(k_cache.shape[1], device=x_t.device) <= pos
        return self.out(_attend(q, k_cache, v_cache, valid[None, None, None, :]))


class CrossAttention(nn.Module):
    def __init__(self, dim: int, heads: int):
        super().__init__()
        self.dim, self.heads = dim, heads
        self.q = Dense(dim, dim)
        self.k = Dense(dim, dim)
        self.v = Dense(dim, dim)
        self.out = Dense(dim, dim)

    def precompute(self, mem: torch.Tensor) -> tuple:
        return _split_heads(self.k(mem), self.heads), _split_heads(self.v(mem), self.heads)

    def attend(self, x, mem_k, mem_v, mem_mask) -> torch.Tensor:
        q = _split_heads(self.q(x), self.heads)
        return self.out(_attend(q, mem_k, mem_v, mem_mask[:, None, None, :], additive=True))

    def forward(self, x, mem, mem_mask) -> torch.Tensor:
        return self.attend(x, *self.precompute(mem), mem_mask)


class DecoderBlock(nn.Module):
    def __init__(self, dim: int, heads: int, ffn_mult: int):
        super().__init__()
        self.ln1 = LayerNorm(dim)
        self.ln2 = LayerNorm(dim)
        self.ln3 = LayerNorm(dim)
        self.self_attn = CausalSelfAttention(dim, heads)
        self.cross_attn = CrossAttention(dim, heads)
        self.fc1 = Dense(dim, dim * ffn_mult)
        self.fc2 = Dense(dim * ffn_mult, dim)

    def _ffn(self, x):
        return x + self.fc2(gelu(self.fc1(self.ln3(x))))

    @shape_keyed
    def forward(self, x, mem, mem_mask):
        x = x + self.self_attn(self.ln1(x))
        x = x + self.cross_attn(self.ln2(x), mem, mem_mask)
        return self._ffn(x)

    def step(self, x_t, k_cache, v_cache, pos, mem_k, mem_v, mem_mask):
        x_t = x_t + self.self_attn.step(self.ln1(x_t), k_cache, v_cache, pos)
        x_t = x_t + self.cross_attn.attend(self.ln2(x_t), mem_k, mem_v, mem_mask)
        return self._ffn(x_t)


class _EncBlock(nn.Module):
    """Pre-LN encoder block. Its flax names: the FFN's widening layer is
    ``Dense_1`` and the narrowing one ``Dense_0`` (construction order)."""

    def __init__(self, dim: int, heads: int, ffn_mult: int, quant: str = "none"):
        super().__init__()
        self.LayerNorm_0 = LayerNorm(dim)
        self.attn = MultiHeadSelfAttention(dim, heads, quant)
        self.LayerNorm_1 = LayerNorm(dim)
        self.Dense_1 = DenseQ(dim, dim * ffn_mult, quant)
        self.Dense_0 = DenseQ(dim * ffn_mult, dim, quant)

    @shape_keyed
    def forward(self, x, mask):
        x = x + self.attn(self.LayerNorm_0(x), mask)
        x = x + self.Dense_0(gelu(self.Dense_1(self.LayerNorm_1(x), mask)), mask)
        if mask is not None:
            x = x * mask[..., None]
        return x


class WhisperStyle(nn.Module):
    def __init__(self, cfg: WhisperStyleConfig = WhisperStyleConfig()):
        super().__init__()
        if cfg.quant not in ("none", "int8"):
            raise ValueError(f"WhisperStyle: quant must be none|int8, got {cfg.quant!r}")
        self.cfg = c = cfg
        self.sub1 = Conv1d(c.num_mel, c.dim, 3)
        # kernel-centred explicit pads, not "SAME" (parity-dependent at stride 2)
        self.sub2 = Conv1d(c.dim, c.dim, 3, stride=2, padding=((1, 1),))
        for i in range(c.enc_layers):
            self.add_module(f"enc_{i}", _EncBlock(c.dim, c.heads, c.ffn_mult, c.quant))
        self.enc_ln = LayerNorm(c.dim)
        self.tok_embed = nn.Embedding(c.vocab_size, c.dim)
        for i in range(c.dec_layers):
            self.add_module(f"dec_{i}", DecoderBlock(c.dim, c.heads, c.ffn_mult))
        self.dec_ln = LayerNorm(c.dim)

    def _dec_blocks(self):
        return [getattr(self, f"dec_{i}") for i in range(self.cfg.dec_layers)]

    def encode(self, feats: torch.Tensor, frame_mask: Optional[torch.Tensor]) -> tuple:
        """-> (memory [B, T', D], mask [B, T'])."""
        c = self.cfg
        if frame_mask is not None:
            feats = feats * frame_mask[..., None].to(feats.dtype)
        x = gelu(self.sub1(feats))
        if frame_mask is not None:
            # gelu(bias) at padded positions would leak into sub2's last window
            x = x * frame_mask[..., None].to(x.dtype)
        x = gelu(self.sub2(x))
        b, t = x.shape[0], x.shape[1]
        if frame_mask is not None:
            lengths = frame_mask.to(torch.int64).sum(dim=-1)
            mask = lengths_to_mask(torch.clamp_min((lengths + 1) // 2, 1), t)
        else:
            mask = torch.ones((b, t), dtype=torch.bool, device=x.device)
        x = x + position_table(t, c.dim, x.device)[None]
        for i in range(c.enc_layers):
            x = getattr(self, f"enc_{i}")(x, mask)
        return self.enc_ln(x), mask

    def decode_logits(self, tokens: torch.Tensor, mem: torch.Tensor,
                      mem_mask: torch.Tensor) -> torch.Tensor:
        """tokens [B, L] -> logits [B, L, V] (teacher forcing, no cache)."""
        c = self.cfg
        y = self.tok_embed(tokens.long()) + position_table(tokens.shape[1], c.dim,
                                                           mem.device)[None]
        for blk in self._dec_blocks():
            y = blk(y, mem, mem_mask)
        return self._logits(self.dec_ln(y))

    def _logits(self, y: torch.Tensor) -> torch.Tensor:
        """y @ the token embedding^T, in jnp's promoted dtype (a bfloat16
        table meets the float32 stream as a float32 cast of itself)."""
        emb = param_as(self.tok_embed, "weight", torch.promote_types(y.dtype,
                                                                    self.tok_embed.weight.dtype))
        return y @ emb.t()

    def forward(self, feats, frame_mask, tokens) -> torch.Tensor:
        mem, mem_mask = self.encode(feats, frame_mask)
        return self.decode_logits(tokens, mem, mem_mask)

    def greedy_decode(self, feats: torch.Tensor, frame_mask: Optional[torch.Tensor],
                      max_len: Optional[int] = None) -> tuple:
        """-> (ids [B, l - 1], lengths [B]), BOS stripped, positions past a
        length hold EOS. ``max_len`` overrides cfg.max_decode_len (no weight
        depends on it, so long-form callers scale it with the audio)."""
        c = self.cfg
        mem, mem_mask = self.encode(feats, frame_mask)
        b, dev = mem.shape[0], mem.device
        l = int(max_len) if max_len is not None else c.max_decode_len
        blocks = self._dec_blocks()
        cross = [blk.cross_attn.precompute(mem) for blk in blocks]
        pos_table = position_table(l, c.dim, dev)
        shape = (b, l, c.heads, c.dim // c.heads)
        caches = [(torch.zeros(shape, device=dev), torch.zeros(shape, device=dev))
                  for _ in blocks]
        tokens = torch.full((b, l), c.eos_id, dtype=torch.int64, device=dev)
        tokens[:, 0] = c.bos_id
        done = torch.zeros((b,), dtype=torch.bool, device=dev)
        count = torch.zeros((b,), dtype=torch.int32, device=dev)
        for i in range(l - 1):
            with loop_step(i, l - 1):
                x_t = self.tok_embed(tokens[:, i : i + 1]) + pos_table[i]
                for blk, (kc, vc), (mk, mv) in zip(blocks, caches, cross):
                    x_t = blk.step(x_t, kc, vc, i, mk, mv, mem_mask)
                logits = self._logits(self.dec_ln(x_t))[:, 0]
                nxt = torch.where(done, c.eos_id, logits.argmax(dim=-1))
                tokens[:, i + 1] = nxt
                count = count + (~done & (nxt != c.eos_id)).to(torch.int32)
                done = done | (nxt == c.eos_id)
        return tokens[:, 1:], count


def whisper_frontend(wav: torch.Tensor, wav_lengths: torch.Tensor,
                     cfg: WhisperStyleConfig) -> tuple:
    """[B, T] padded waveforms + lengths -> (fbank [B, F, mel], mask)."""
    feats = log_mel_fbank(wav, cfg.fbank)
    shift, flen = cfg.fbank.frame_shift, cfg.fbank.frame_length
    f_len = torch.clamp_min(torch.div(wav_lengths - flen, shift, rounding_mode="floor") + 1, 1)
    return feats, lengths_to_mask(f_len, feats.shape[1])
