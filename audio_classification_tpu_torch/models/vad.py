"""Voice activity detection, the silero-VAD slot (port of
audio_classification_tpu/models/vad.py):

- ``VADNet``: a small dilated conv stack over the shared log-mel frontend
  and a per-frame speech probability;
- ``VoiceActivityDetector``: the host's hysteresis that turns frame
  probabilities into speech segments with min_silence / min_speech rules.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np
import torch
from torch import nn

from ..ops.work import shape_keyed
from .common import Conv1d, Dense, gelu


@dataclass(frozen=True)
class VADConfig:
    num_mel: int = 80
    dim: int = 96
    layers: int = 3
    kernel: int = 5
    sample_rate: int = 16000
    frame_shift_ms: float = 10.0
    threshold: float = 0.5
    min_silence_duration: float = 0.25
    min_speech_duration: float = 0.25


class VADNet(nn.Module):
    """[B, T, mel] -> [B, T] speech probability."""

    def __init__(self, cfg: VADConfig = VADConfig()):
        super().__init__()
        self.cfg = c = cfg
        for i in range(c.layers):
            self.add_module(f"conv_{i}", Conv1d(c.num_mel if i == 0 else c.dim, c.dim, c.kernel,
                                                dilation=2 ** i))
        self.head = Dense(c.dim, 1)

    @shape_keyed
    def forward(self, feats: torch.Tensor,
                frame_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        x = feats
        for i in range(self.cfg.layers):
            x = gelu(getattr(self, f"conv_{i}")(x))
        p = torch.sigmoid(self.head(x))[..., 0]
        return p if frame_mask is None else p * frame_mask.to(p.dtype)


class VoiceActivityDetector:
    """Hysteresis post-processing: frame probabilities -> [(start_sec, end_sec)]."""

    def __init__(self, cfg: VADConfig = VADConfig()):
        self.cfg = cfg

    def segments(self, probs, dur: float) -> List[Tuple[float, float]]:
        c = self.cfg
        frame_sec = c.frame_shift_ms / 1000.0
        on = np.asarray(probs) > c.threshold
        segs: List[Tuple[float, float]] = []
        start = None
        last_true = None
        for i, f in enumerate(on):
            t = i * frame_sec
            if f:
                if start is None:
                    start = t
                last_true = t + frame_sec
            elif start is not None and t - last_true >= c.min_silence_duration:
                segs.append((start, min(last_true, dur)))
                start = None
        if start is not None:
            segs.append((start, min(dur, last_true if last_true else dur)))
        return [(s, e) for s, e in segs if e - s >= c.min_speech_duration - 1e-9]
