"""SenseVoice-style non-autoregressive CTC ASR encoder (port of
audio_classification_tpu/models/asr/sensevoice.py):

  waveform -> log-mel fbank(80) -> LFR(7,6) stack -> CMVN -> linear to d
  -> 4 prompt frames (language + itn embeddings + 2 learned pads)
  -> transformer encoder with a depthwise-conv (FSMN-like) branch per block
  -> CTC vocabulary logits (greedy decode in asr/ctc.py)
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

import numpy as np
import torch
from torch import nn

from ...ops.fbank import FbankConfig, apply_lfr, log_mel_fbank
from ...ops.work import shape_keyed
from ...parallel.sp_encoder import sp_seq_shard, sp_seq_unshard
from ...utils.profiling import note
from ..block_graphs import StackGraphs, eager_reason
from ..common import Dense, LayerNorm, TransformerBlock, lengths_to_mask, position_table

LANGUAGES = ("auto", "zh", "en", "yue", "ja", "ko", "nospeech")


@dataclass(frozen=True)
class SenseVoiceConfig:
    vocab_size: int = 512            # real model: 25055; tests use small vocabs
    dim: int = 512
    heads: int = 8
    layers: int = 12
    ffn_mult: int = 4
    conv_kernel: int = 11            # FSMN-equivalent memory span
    lfr_m: int = 7
    lfr_n: int = 6
    num_mel: int = 80
    num_prompt: int = 4              # language, event, emotion, itn slots
    quant: str = "none"              # "int8": every block's attention and FFN
                                     # projections through ops/quant; in_proj,
                                     # the embeddings and ctc_head stay float
    #: per-utterance CMVN over valid frames (masked mean/var of the LFR feats)
    utt_cmvn: bool = False
    fbank: FbankConfig = field(default_factory=FbankConfig)

    def out_frames(self, n_samples: int) -> int:
        n = self.fbank.frames_for(n_samples)
        return int(np.ceil(n / self.lfr_n)) + self.num_prompt


class SenseVoiceEncoder(nn.Module):
    """[B, T_lfr, lfr_m*mel] features (+ mask) -> [B, prompt+T_lfr, vocab].

    On the card the block chain replays CUDA graphs kept per input shape
    (models/block_graphs.py), cut at the K3 calls; on the CPU, with a mesh,
    int8 blocks, gradients or a work count open, the blocks run op by op.
    ``in_proj``, the prompt, the positions, ``final_ln`` and ``ctc_head`` run
    op by op either way: the logits are a new tensor every call."""

    def __init__(self, cfg: SenseVoiceConfig = SenseVoiceConfig()):
        super().__init__()
        if cfg.quant not in ("none", "int8"):
            raise ValueError(f"SenseVoiceEncoder: quant must be none|int8, got {cfg.quant!r}")
        self.cfg = c = cfg
        self.in_proj = Dense(c.lfr_m * c.num_mel, c.dim)
        self.lang_embed = nn.Parameter(torch.empty(len(LANGUAGES), c.dim))
        self.itn_embed = nn.Parameter(torch.empty(2, c.dim))
        self.prompt_pad = nn.Parameter(torch.empty(c.num_prompt - 2, c.dim))
        for i in range(c.layers):
            self.add_module(f"block_{i}", TransformerBlock(c.dim, c.heads, c.ffn_mult,
                                                           c.conv_kernel, c.quant))
        self.final_ln = LayerNorm(c.dim)
        self.ctc_head = Dense(c.dim, c.vocab_size)
        self._graphs = StackGraphs()

    @shape_keyed
    def forward(self, feats: torch.Tensor, frame_mask: Optional[torch.Tensor] = None,
                language_id: int = 0, use_itn: bool = True, mesh=None,
                sp_axis: str = "data") -> torch.Tensor:
        """``mesh`` turns on sequence parallelism: every block's attention
        runs ring-parallel over ``sp_axis`` with the frame mask travelling
        the ring, on the same parameters as the dense path."""
        c = self.cfg
        x = self.in_proj(feats)
        b, t = x.shape[0], x.shape[1]
        prompt = torch.cat([self.lang_embed[language_id][None],
                            self.itn_embed[1 if use_itn else 0][None], self.prompt_pad])
        x = torch.cat([prompt[None].expand(b, -1, -1), x], dim=1)
        mask = None
        if frame_mask is not None:
            mask = torch.cat([torch.ones((b, c.num_prompt), dtype=torch.bool, device=x.device),
                              frame_mask.bool()], dim=1)
        x = x + position_table(t + c.num_prompt, c.dim, x.device)[None]
        blocks = [getattr(self, f"block_{i}") for i in range(c.layers)]
        reason = eager_reason(x.device.type, mesh, c.quant)
        if reason is None:
            return self._graphs.run(blocks, x, mask, self._logits)
        if reason == "count":
            self._graphs.saw(blocks, x, mask)
        if mesh is not None:
            # the prompt concat and the positions come first, on the whole
            # sequence; then one pad to the shard count enters the sharded regime
            x, mask, orig_total = sp_seq_shard(x, mask, mesh, sp_axis)
        for blk in blocks:
            x = blk(x, mask, mesh, sp_axis)
        if mesh is not None:
            x = sp_seq_unshard(x, mesh, orig_total)
        note(graph_replays=0, graph_captures=0, eager_blocks=len(blocks))
        return self._logits(x)

    def _logits(self, x: torch.Tensor) -> torch.Tensor:
        return self.ctc_head(self.final_ln(x))


def sensevoice_frontend(
    wav: torch.Tensor,
    wav_lengths: torch.Tensor,
    cfg: SenseVoiceConfig,
    cmvn_mean: Optional[torch.Tensor] = None,
    cmvn_istd: Optional[torch.Tensor] = None,
) -> tuple:
    """[B, T] padded waveforms + lengths -> (lfr feats [B, T', D'], mask).

    CMVN: y = (x + cmvn_mean) * cmvn_istd (the model dir's ``am.mvn``),
    after LFR stacking (dim = lfr_m * num_mel) or, for per-mel-bin stats
    (dim = num_mel), before it.
    """
    feats = log_mel_fbank(wav, cfg.fbank)
    pre_lfr = cmvn_mean is not None and cmvn_mean.shape[-1] == feats.shape[-1]
    if pre_lfr:
        feats = feats + cmvn_mean
        if cmvn_istd is not None:
            feats = feats * cmvn_istd
    lfr = apply_lfr(feats, cfg.lfr_m, cfg.lfr_n)
    if cmvn_mean is not None and not pre_lfr:
        if cmvn_mean.shape[-1] != lfr.shape[-1]:
            raise ValueError(
                f"CMVN dim {cmvn_mean.shape[-1]} matches neither mel "
                f"({feats.shape[-1]}) nor LFR ({lfr.shape[-1]})")
        lfr = lfr + cmvn_mean
        if cmvn_istd is not None:
            lfr = lfr * cmvn_istd
    n_t = lfr.shape[1]
    shift, flen = cfg.fbank.frame_shift, cfg.fbank.frame_length
    fb_len = torch.clamp_min(torch.div(wav_lengths - flen, shift, rounding_mode="floor") + 1, 0)
    lfr_len = torch.ceil(fb_len / cfg.lfr_n).long()
    mask = lengths_to_mask(torch.clamp_min(lfr_len, 1), n_t)
    if cfg.utt_cmvn:
        m = mask.to(lfr.dtype)[..., None]                      # [B, T, 1]
        denom = torch.clamp_min(m.sum(dim=1, keepdim=True), 1.0)
        mu = (lfr * m).sum(dim=1, keepdim=True) / denom
        var = ((lfr - mu) ** 2 * m).sum(dim=1, keepdim=True) / denom
        lfr = (lfr - mu) / torch.sqrt(var + 1e-5) * m
    return lfr, mask
