"""Transducer (RNN-T) ASR: encoder + stateless predictor + joiner (port of
audio_classification_tpu/models/asr/transducer.py):

- encoder: conv subsample x4 over fbank (explicit kernel-centred pads, not
  "SAME"), then the shared transformer blocks -> [B, T', D]; at dim 256
  and 4 heads its attention runs K3 at D = 64 from ``FLASH_MIN_T`` frames;
- predictor: stateless, the embeddings of the last ``context`` tokens
  concatenated and projected, so a decode carries only token ids;
- joiner: tanh(enc_proj + pred_proj) -> vocab logits;
- greedy search: a loop over encoder frames on device tensors, at most one
  symbol a frame, the whole batch at once, no host sync a frame; modified
  beam search in asr/beam.py.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

import torch
from torch import nn

from ...ops.fbank import FbankConfig, log_mel_fbank
from ...ops.work import loop_step, shape_keyed
from ..common import (Conv1d, Dense, LayerNorm, TransformerBlock, gelu, lengths_to_mask,
                      position_table)
from .beam import left_pack_symbols, modified_beam_search


@dataclass(frozen=True)
class TransducerConfig:
    vocab_size: int = 512
    dim: int = 256
    heads: int = 4
    layers: int = 6
    ffn_mult: int = 4
    conv_kernel: int = 9
    context: int = 2          # predictor token context
    pred_dim: int = 256
    joiner_dim: int = 256
    num_mel: int = 80
    blank_id: int = 0
    quant: str = "none"       # "int8": the encoder blocks' projections through ops/quant
    fbank: FbankConfig = field(default_factory=FbankConfig)


class TransducerEncoder(nn.Module):
    def __init__(self, cfg: TransducerConfig):
        super().__init__()
        c = self.cfg = cfg
        # kernel-centred explicit pads (torch Conv1d pad = k // 2): "SAME"
        # splits its pad by input parity under stride 2
        self.sub1 = Conv1d(c.num_mel, c.dim, 5, stride=2, padding=((2, 2),))
        self.sub2 = Conv1d(c.dim, c.dim, 5, stride=2, padding=((2, 2),))
        for i in range(c.layers):
            self.add_module(f"block_{i}", TransformerBlock(c.dim, c.heads, c.ffn_mult,
                                                           c.conv_kernel, c.quant))
        self.out_ln = LayerNorm(c.dim)

    @shape_keyed
    def forward(self, feats: torch.Tensor,
                frame_mask: Optional[torch.Tensor] = None) -> tuple:
        """-> (enc [B, T', D], mask [B, T'])."""
        c = self.cfg
        if frame_mask is not None:
            # padded fbank frames hold the log-mel floor: zeroed, so sub1's
            # boundary windows see a solo run's zero pad
            feats = feats * frame_mask[..., None].to(feats.dtype)
        x = gelu(self.sub1(feats))
        if frame_mask is not None:
            # gelu(bias) at padded sub1 positions is not zero and sub2's
            # window at the last valid frame would read it
            l1 = (frame_mask.to(torch.int64).sum(dim=-1) + 1) // 2
            x = x * lengths_to_mask(torch.clamp_min(l1, 1), x.shape[1])[..., None].to(x.dtype)
        x = gelu(self.sub2(x))
        b, t = x.shape[0], x.shape[1]
        if frame_mask is not None:
            lengths = frame_mask.to(torch.int64).sum(dim=-1)
            mask = lengths_to_mask(torch.clamp_min((lengths + 3) // 4, 1), t)
        else:
            mask = torch.ones((b, t), dtype=torch.bool, device=x.device)
        x = x + position_table(t, c.dim, x.device)[None]
        for i in range(c.layers):
            x = getattr(self, f"block_{i}")(x, mask)
        return self.out_ln(x), mask


class TransducerPredictor(nn.Module):
    """Stateless predictor over the last ``context`` non-blank tokens."""

    def __init__(self, cfg: TransducerConfig):
        super().__init__()
        self.cfg = cfg
        self.embed = nn.Embedding(cfg.vocab_size, cfg.pred_dim)
        self.proj = Dense(cfg.context * cfg.pred_dim, cfg.pred_dim)

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        """tokens [..., context] -> [..., pred_dim]."""
        emb = self.embed(tokens.long())
        return torch.relu(self.proj(emb.reshape(emb.shape[:-2] + (-1,))))


class TransducerJoiner(nn.Module):
    def __init__(self, cfg: TransducerConfig):
        super().__init__()
        self.enc_proj = Dense(cfg.dim, cfg.joiner_dim)
        self.pred_proj = Dense(cfg.pred_dim, cfg.joiner_dim)
        self.out = Dense(cfg.joiner_dim, cfg.vocab_size)

    def forward(self, enc: torch.Tensor, pred: torch.Tensor) -> torch.Tensor:
        return self.out(torch.tanh(self.enc_proj(enc) + self.pred_proj(pred)))


class Transducer(nn.Module):
    """Encoder, predictor and joiner with greedy and beam search on device."""

    def __init__(self, cfg: TransducerConfig = TransducerConfig()):
        super().__init__()
        if cfg.quant not in ("none", "int8"):
            raise ValueError(f"Transducer: quant must be none|int8, got {cfg.quant!r}")
        self.cfg = cfg
        self.encoder = TransducerEncoder(cfg)
        self.predictor = TransducerPredictor(cfg)
        self.joiner = TransducerJoiner(cfg)

    def greedy_decode(self, feats: torch.Tensor, frame_mask: torch.Tensor) -> tuple:
        """[B, T, mel] -> (ids [B, T'] left-packed, blank-padded; counts [B]):
        one frame at a time, at most one symbol a frame."""
        c = self.cfg
        enc, mask = self.encoder(feats, frame_mask)
        b, t, _ = enc.shape
        ctx = torch.full((b, c.context), c.blank_id, dtype=torch.int64, device=enc.device)
        count = torch.zeros((b,), dtype=torch.int32, device=enc.device)
        syms = []
        for i in range(t):
            with loop_step(i, t):
                logits = self.joiner(enc[:, i], self.predictor(ctx))
                sym = logits.argmax(dim=-1)
                emit = (sym != c.blank_id) & mask[:, i]
                ctx = torch.where(emit[:, None], torch.cat([ctx[:, 1:], sym[:, None]], dim=1),
                                  ctx)
                syms.append(torch.where(emit, sym, c.blank_id))
                count = count + emit.to(torch.int32)
        packed, _ = left_pack_symbols(torch.stack(syms, dim=1), c.blank_id)
        return packed, count

    def beam_decode(self, feats: torch.Tensor, frame_mask: torch.Tensor, beam: int = 4,
                    return_score: bool = False) -> tuple:
        """Modified beam search (asr/beam.py) with ``beam`` hypotheses an
        utterance; ``beam=1`` is exactly ``greedy_decode``. Returns (ids,
        counts) like greedy_decode, with ``return_score`` also the best
        hypothesis's log-probability [B]."""
        c = self.cfg
        enc, mask = self.encoder(feats, frame_mask)

        def score(e_t, ctx):  # [B, D], [B, K, context] -> [B, K, V]
            return self.joiner(e_t[:, None, :], self.predictor(ctx))

        return modified_beam_search(enc, mask, score, blank_id=c.blank_id, context=c.context,
                                    beam=beam, return_score=return_score)


def transducer_frontend(wav: torch.Tensor, wav_lengths: torch.Tensor,
                        cfg: TransducerConfig) -> tuple:
    """[B, T] padded waveforms + lengths -> (fbank [B, F, mel], mask)."""
    feats = log_mel_fbank(wav, cfg.fbank)
    shift, flen = cfg.fbank.frame_shift, cfg.fbank.frame_length
    f_len = torch.clamp_min(torch.div(wav_lengths - flen, shift, rounding_mode="floor") + 1, 1)
    return feats, lengths_to_mask(f_len, feats.shape[1])
