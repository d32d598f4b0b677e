"""Wrapper-layer API: the model-facade surface of the JAX package (port of
audio_classification_tpu/models/facades.py), backed by the batched torch
StageEngine:

- ``default_engine`` / ``set_default_engine``: one shared engine per process
- ``ASRRecognizer``, ``SpeakerExtractor``: recognizer and embedder handles
- ``OverlapAnalyzer``: analyze(samples, sr) -> [(start, end, is_overlap)]
- ``Separator``: separate(samples, sr) -> n_src wavs at the model's rate

What needs modules that are not ported yet raises NotImplementedError naming
the ROADMAP slice: separator checkpoints (slices 14 and 15), the
sequence-parallel ``separate_long`` (slice 16), long-form transcription and
the ``SpeakerASRModels`` / ``SpeakerBank`` SID facade (slice 12).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np

from ..engine.runtime import G_SAMPLE_RATE, EnginePreset, ModelPack, StageEngine, tiny_preset

_DEFAULT_ENGINE: Optional[StageEngine] = None


def default_engine(preset: str = "full", seed: int = 0, device=None) -> StageEngine:
    """Process-wide shared engine, built on first use on ``device`` (default:
    the first CUDA device; raises without one unless the CPU is asked for)."""
    global _DEFAULT_ENGINE
    if _DEFAULT_ENGINE is None:
        p = tiny_preset() if preset == "tiny" else EnginePreset()
        _DEFAULT_ENGINE = StageEngine(ModelPack(p, seed=seed, device=device))
    return _DEFAULT_ENGINE


def set_default_engine(engine: Optional[StageEngine]) -> None:
    global _DEFAULT_ENGINE
    _DEFAULT_ENGINE = engine


class ASRRecognizer:
    """OfflineRecognizer-equivalent handle bound to a StageEngine."""

    def __init__(self, engine: StageEngine, language: str = "auto", use_itn: bool = True):
        self.engine = engine
        self.language = language
        self.use_itn = use_itn

    def transcribe(self, samples: np.ndarray, sr: int, long_form: bool = False) -> str:
        if long_form:
            raise NotImplementedError(
                "long-form transcription (StageEngine.transcribe_long) is not ported to "
                "audio_classification_tpu_torch yet (ROADMAP slice 12)")
        wav = self.engine.resample(np.asarray(samples, np.float32), sr, G_SAMPLE_RATE)
        return self.engine.transcribe([wav], self.language, self.use_itn)[0]

    def transcribe_batch(self, chunks, sr: int) -> List[str]:
        chunks = [self.engine.resample(np.asarray(c, np.float32), sr, G_SAMPLE_RATE)
                  for c in chunks]
        return self.engine.transcribe(chunks, self.language, self.use_itn)


class SpeakerExtractor:
    """SpeakerEmbeddingExtractor-equivalent (compute-only, batched)."""

    def __init__(self, engine: StageEngine):
        self.engine = engine

    @property
    def dim(self) -> int:
        return self.engine.pack.preset.spk.embed_dim

    def compute(self, samples: np.ndarray, sr: int) -> np.ndarray:
        wav = self.engine.resample(np.asarray(samples, np.float32), sr, G_SAMPLE_RATE)
        return self.engine.embed([wav])[0]

    def compute_batch(self, chunks, sr: int) -> np.ndarray:
        chunks = [self.engine.resample(np.asarray(c, np.float32), sr, G_SAMPLE_RATE)
                  for c in chunks]
        return self.engine.embed(chunks)


@dataclass
class OverlapAnalyzer:
    """OSD facade (reference: src/osd/osd.py:20-147): analyze(samples, sr)
    -> full-coverage [(start, end, is_overlap)]."""

    threshold: float = 0.5
    win_sec: float = 0.5
    hop_sec: float = 0.1
    backend: Optional[str] = None
    engine: Optional[StageEngine] = None

    def __post_init__(self):
        self.backend = self.backend or "osdnet"
        if self.engine is None:
            self.engine = default_engine()

    def analyze(self, samples: np.ndarray, sr: int) -> List[Tuple[float, float, bool]]:
        dur = len(samples) / sr if sr else 0.0
        if dur <= 0:
            return []
        wav = self.engine.resample(np.asarray(samples, np.float32), sr, G_SAMPLE_RATE)
        return self.engine.osd_segments(wav, G_SAMPLE_RATE, self.threshold, self.win_sec,
                                        self.hop_sec)


@dataclass
class Separator:
    """Separation facade (reference: src/osd/separation.py:14-163).

    separate(samples, sr) -> list of n_src numpy wavs at the model's sample
    rate; resampling into the model rate uses the same linear-interp
    semantics as the reference (:91-103); raises if the model emits fewer
    than n_src streams.
    """

    backend: Optional[str] = None
    sample_rate: int = 16000
    checkpoint: Optional[str] = None
    n_src: int = 2
    engine: Optional[StageEngine] = None

    def __post_init__(self):
        self.backend = self.backend or "convtasnet"
        if self.checkpoint:
            raise NotImplementedError(
                "Separator(checkpoint=...): separator checkpoints (orbax dirs of "
                "train/checkpoint.py, ROADMAP slice 14; torch checkpoints of "
                "models/convert, ROADMAP slice 15) are not ported to "
                "audio_classification_tpu_torch yet")
        if self.engine is None:
            self.engine = default_engine()
        if self.backend == "mossformer":
            self.sample_rate = self.engine.pack.preset.mossformer.sample_rate

    def separate(self, samples: np.ndarray, sr: int) -> List[np.ndarray]:
        wav = self._ensure_sr(np.asarray(samples, np.float32), sr)
        out = self.engine.separate([wav], n_src=self.n_src, backend=self.backend)[0]
        if out.shape[0] < self.n_src:
            raise RuntimeError(f"Separation output has < {self.n_src} sources; check model/config.")
        return [out[i] for i in range(self.n_src)]

    def separate_batch(self, chunks, sr: int) -> List[List[np.ndarray]]:
        wavs = [self._ensure_sr(np.asarray(c, np.float32), sr) for c in chunks]
        outs = self.engine.separate(wavs, n_src=self.n_src, backend=self.backend)
        return [[o[i] for i in range(self.n_src)] for o in outs]

    def separate_long(self, samples: np.ndarray, sr: int, mesh, axis: str = "data"):
        raise NotImplementedError(
            "Separator.separate_long: sequence-parallel separation over several devices "
            "(parallel/sp_convtasnet) is not ported to audio_classification_tpu_torch yet "
            "(ROADMAP slice 16)")

    def _ensure_sr(self, samples: np.ndarray, sr: int) -> np.ndarray:
        if sr == self.sample_rate or len(samples) <= 1:
            return samples
        tgt_n = int(round(len(samples) * self.sample_rate / sr))
        if tgt_n <= 1:
            return samples
        old_idx = np.arange(len(samples), dtype=np.float64)
        new_idx = np.linspace(0, len(samples) - 1, tgt_n, dtype=np.float64)
        return np.interp(new_idx, old_idx, samples).astype(np.float32)


class SpeakerASRModels:
    """Unified SID+ASR facade of the JAX package: not ported yet."""

    def __init__(self, *_args, **_kwargs):
        raise NotImplementedError(
            "SpeakerASRModels needs the SpeakerBank cosine search and the SID runners, "
            "which are not ported to audio_classification_tpu_torch yet (ROADMAP slice 12)")
