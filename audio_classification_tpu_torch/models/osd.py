"""Overlapped-speech detection segmenter (port of
audio_classification_tpu/models/osd.py): conv subsampling x4 over log-mel,
then MHSA blocks, then per-frame {speech, overlap} probabilities."""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch
from torch import nn

from ..ops.work import shape_keyed
from .common import Conv1d, Dense, TransformerBlock, gelu, position_table


@dataclass(frozen=True)
class OSDConfig:
    num_mel: int = 80
    dim: int = 256
    heads: int = 4
    layers: int = 4
    conv_kernel: int = 9
    subsample: int = 4          # output frame rate = fbank rate / subsample
    sample_rate: int = 16000
    frame_shift_ms: float = 10.0

    @property
    def out_frame_sec(self) -> float:
        return self.frame_shift_ms / 1000.0 * self.subsample


class OSDNet(nn.Module):
    """[B, T, mel] fbank (+ frame mask) -> [B, ceil(T/4), 2] probs
    ([..., 0] = p(speech), [..., 1] = p(overlap))."""

    def __init__(self, cfg: OSDConfig = OSDConfig()):
        super().__init__()
        self.cfg = cfg
        self.sub1 = Conv1d(cfg.num_mel, cfg.dim, 5, stride=2)
        self.sub2 = Conv1d(cfg.dim, cfg.dim, 5, stride=2)
        for i in range(cfg.layers):
            self.add_module(f"block_{i}", TransformerBlock(cfg.dim, cfg.heads,
                                                           conv_kernel=cfg.conv_kernel))
        self.head = Dense(cfg.dim, 2)

    @shape_keyed
    def forward(self, feats: torch.Tensor, frame_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        c = self.cfg
        x = gelu(self.sub2(gelu(self.sub1(feats))))
        t = x.shape[1]
        mask = None
        if frame_mask is not None:
            lengths = frame_mask.long().sum(dim=-1)
            out_len = torch.clamp_min((lengths + c.subsample - 1) // c.subsample, 1)
            mask = torch.arange(t, device=x.device)[None, :] < out_len[:, None]
        x = x + position_table(t, c.dim, x.device)[None]
        for i in range(c.layers):
            x = getattr(self, f"block_{i}")(x, mask)
        probs = torch.sigmoid(self.head(x))
        if mask is not None:
            probs = probs * mask[..., None]
        return probs


def probs_to_hop_flags(
    overlap_probs: np.ndarray,
    n_out_frames: int,
    dur: float,
    out_frame_sec: float,
    threshold: float,
    win_sec: float,
    hop_sec: float,
) -> np.ndarray:
    """Project model-frame overlap probabilities onto the reference's
    win/hop raster grid (numpy copy of osd.probs_to_hop_flags; reference:
    src/osd/osd.py:99-108)."""
    from ..engine.segments import rasterize_intervals

    p = np.asarray(overlap_probs)[:n_out_frames]
    on = p > threshold
    intervals = []
    i = 0
    while i < len(on):
        if on[i]:
            j = i
            while j + 1 < len(on) and on[j + 1]:
                j += 1
            intervals.append((i * out_frame_sec, min((j + 1) * out_frame_sec, dur)))
            i = j + 1
        else:
            i += 1
    return rasterize_intervals(intervals, dur, win_sec, hop_sec)
