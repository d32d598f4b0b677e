"""Paraformer: non-autoregressive ASR with a CIF predictor (port of
audio_classification_tpu/models/asr/paraformer.py):

- encoder: SAN-M-style transformer over LFR-stacked fbank (the shared
  TransformerBlock with its depthwise conv branch); at dim 320 and 4 heads
  its attention runs K3 at D = 80 from ``FLASH_MIN_T`` frames on, and K5
  under a mesh;
- predictor: CIF (continuous integrate-and-fire), per-frame weights alpha
  accumulated until the threshold, each firing integrating the weighted
  frames into one acoustic token, into a static token capacity;
- decoder: bidirectional transformer (no conv branch) over the fired tokens
  -> vocab logits; greedy output is a parallel argmax.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

import torch
from torch import nn

from ...ops.fbank import FbankConfig, apply_lfr, log_mel_fbank
from ...ops.work import loop_step, shape_keyed
from ...parallel.sp_encoder import sp_seq_shard, sp_seq_unshard
from ..common import Dense, LayerNorm, TransformerBlock, lengths_to_mask, position_table


@dataclass(frozen=True)
class ParaformerConfig:
    vocab_size: int = 512
    dim: int = 320
    heads: int = 4
    enc_layers: int = 8
    dec_layers: int = 4
    ffn_mult: int = 4
    conv_kernel: int = 11
    lfr_m: int = 7
    lfr_n: int = 6
    num_mel: int = 80
    max_tokens: int = 128       # CIF output capacity per utterance
    cif_threshold: float = 1.0
    quant: str = "none"         # "int8": the encoder blocks' projections through ops/quant
    fbank: FbankConfig = field(default_factory=FbankConfig)


def cif_integrate(h: torch.Tensor, alpha: torch.Tensor, max_tokens: int,
                  threshold: float = 1.0) -> tuple:
    """Continuous integrate-and-fire with a static output capacity.

    h [B, T, D] encoder states, alpha [B, T] non-negative firing weights ->
    (tokens [B, max_tokens, D], counts [B]). The carry runs frame by frame
    on the device with the JAX scan's arithmetic, operation for operation,
    so every fire decision is the reference's (a cumulative sum would
    reorder the additions and move fires at near-ties); no step waits on
    the host. The crossing frame's weight is split between the firing
    token and the next one. The token writes follow the scan's rule (slot
    min(count, max_tokens - 1), a later write overwriting an earlier one)
    in one gather after the loop; the residual fires as a last token when it
    carries at least half the threshold."""
    b, t, d = h.shape
    acc_w = torch.zeros((b,), dtype=h.dtype, device=h.device)
    acc_v = torch.zeros((b, d), dtype=h.dtype, device=h.device)
    zero = torch.zeros((), dtype=h.dtype, device=h.device)
    tokens, fires = [], []
    for i in range(t):
        with loop_step(i, t):
            a_t, h_t = alpha[:, i], h[:, i]
            total = acc_w + a_t
            fire = total >= threshold
            used = torch.where(fire, threshold - acc_w, a_t)
            rem = torch.where(fire, total - threshold, zero)
            token = acc_v + used[:, None] * h_t
            tokens.append(token)
            fires.append(fire)
            acc_v = torch.where(fire[:, None], rem[:, None] * h_t, token)
            acc_w = torch.where(fire, rem, total)
    # the tail as a last firing step whose token is the residual
    tokens.append(acc_v)
    fires.append(acc_w >= threshold * 0.5)
    tokens, fires = torch.stack(tokens, dim=1), torch.stack(fires, dim=1)  # [B, T+1, D], [B, T+1]
    n_fire = fires.to(torch.int64)
    slot = torch.clamp_max(torch.cumsum(n_fire, dim=1) - n_fire, max_tokens - 1)
    # the last step that writes each slot (a step that does not fire writes
    # the spare column max_tokens)
    steps = torch.arange(t + 1, device=h.device).expand(b, -1)
    writer = torch.full((b, max_tokens + 1), -1, dtype=torch.int64, device=h.device)
    writer.scatter_reduce_(1, torch.where(fires, slot, max_tokens), steps, "amax")
    writer = writer[:, :max_tokens]
    out = torch.gather(tokens, 1, torch.clamp_min(writer, 0)[..., None].expand(-1, -1, d))
    out = torch.where((writer >= 0)[..., None], out, zero)
    return out, torch.clamp_max(n_fire.sum(dim=1), max_tokens).to(torch.int32)


class Paraformer(nn.Module):
    """[B, T_lfr, lfr_m*mel] -> (logits [B, max_tokens, V], counts [B])."""

    def __init__(self, cfg: ParaformerConfig = ParaformerConfig()):
        super().__init__()
        if cfg.quant not in ("none", "int8"):
            raise ValueError(f"Paraformer: quant must be none|int8, got {cfg.quant!r}")
        self.cfg = c = cfg
        self.in_proj = Dense(c.lfr_m * c.num_mel, c.dim)
        for i in range(c.enc_layers):
            self.add_module(f"enc_{i}", TransformerBlock(c.dim, c.heads, c.ffn_mult,
                                                         c.conv_kernel, c.quant))
        self.enc_ln = LayerNorm(c.dim)
        self.cif_hidden = Dense(c.dim, c.dim)
        self.cif_out = Dense(c.dim, 1)
        for i in range(c.dec_layers):
            self.add_module(f"dec_{i}", TransformerBlock(c.dim, c.heads, c.ffn_mult, 0))
        self.dec_ln = LayerNorm(c.dim)
        self.out = Dense(c.dim, c.vocab_size)

    @shape_keyed
    def forward(self, feats: torch.Tensor, frame_mask: Optional[torch.Tensor] = None,
                mesh=None, sp_axis: str = "data") -> tuple:
        """``mesh`` runs the encoder blocks sequence-parallel (ring attention
        over ``sp_axis``); CIF and the decoder over the acoustic tokens stay
        dense (max_tokens is short, and CIF is sequential over frames)."""
        c = self.cfg
        x = self.in_proj(feats)
        b, t = x.shape[0], x.shape[1]
        mask = (frame_mask.bool() if frame_mask is not None
                else torch.ones((b, t), dtype=torch.bool, device=x.device))
        x = x + position_table(t, c.dim, x.device)[None]
        blk_mask = mask
        if mesh is not None:
            x, blk_mask, orig_t = sp_seq_shard(x, mask, mesh, sp_axis)
        for i in range(c.enc_layers):
            x = getattr(self, f"enc_{i}")(x, blk_mask, mesh, sp_axis)
        if mesh is not None:
            x = sp_seq_unshard(x, mesh, orig_t)
        x = self.enc_ln(x)

        alpha = torch.sigmoid(self.cif_out(torch.relu(self.cif_hidden(x))))[..., 0]
        alpha = alpha * mask.to(alpha.dtype)
        tokens, counts = cif_integrate(x, alpha, c.max_tokens, c.cif_threshold)

        tok_mask = torch.arange(c.max_tokens, device=x.device)[None, :] < counts[:, None]
        y = tokens + position_table(c.max_tokens, c.dim, x.device)[None]
        for i in range(c.dec_layers):
            y = getattr(self, f"dec_{i}")(y, tok_mask)
        return self.out(self.dec_ln(y)), counts


def paraformer_greedy(logits: torch.Tensor, counts: torch.Tensor) -> tuple:
    """Parallel argmax over the fired tokens -> (ids [B, max_tokens], lengths)."""
    ids = logits.argmax(dim=-1).to(torch.int32)
    mask = torch.arange(ids.shape[1], device=ids.device)[None, :] < counts[:, None]
    return torch.where(mask, ids, torch.zeros_like(ids)), counts


def paraformer_frontend(wav: torch.Tensor, wav_lengths: torch.Tensor, cfg: ParaformerConfig,
                        cmvn_mean: Optional[torch.Tensor] = None,
                        cmvn_istd: Optional[torch.Tensor] = None) -> tuple:
    """[B, T] padded waveforms + lengths -> (LFR feats [B, T', lfr_m*mel],
    mask). CMVN as in sensevoice_frontend: post-LFR for lfr_m*num_mel
    stats, pre-LFR for per-mel stats."""
    feats = log_mel_fbank(wav, cfg.fbank)
    pre_lfr = cmvn_mean is not None and cmvn_mean.shape[-1] == feats.shape[-1]
    if pre_lfr:
        feats = feats + cmvn_mean
        if cmvn_istd is not None:
            feats = feats * cmvn_istd
    lfr = apply_lfr(feats, cfg.lfr_m, cfg.lfr_n)
    if cmvn_mean is not None and not pre_lfr:
        lfr = lfr + cmvn_mean
        if cmvn_istd is not None:
            lfr = lfr * cmvn_istd
    shift, flen = cfg.fbank.frame_shift, cfg.fbank.frame_length
    f_len = torch.clamp_min(torch.div(wav_lengths - flen, shift, rounding_mode="floor") + 1, 0)
    lfr_len = torch.clamp_min(torch.ceil(f_len / cfg.lfr_n).long(), 1)
    return lfr, lengths_to_mask(lfr_len, lfr.shape[1])
