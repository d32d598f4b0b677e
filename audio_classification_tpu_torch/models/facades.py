"""Wrapper-layer API: the model-facade surface of the JAX package (port of
audio_classification_tpu/models/facades.py), backed by the batched torch
StageEngine:

- ``default_engine`` / ``set_default_engine``: one shared engine per process
- ``ASRRecognizer``, ``SpeakerExtractor``: recognizer and embedder handles;
  ``create_asr_model``, the recognizer's one-of factory, and
  ``create_extractor_model``, the embedder's
- ``SpeakerASRModels``: the SID + ASR facade (enrollment, bank search, ASR)
- ``OverlapAnalyzer``: analyze(samples, sr) -> [(start, end, is_overlap)]
- ``Separator``: separate(samples, sr) -> n_src wavs at the model's rate

``Separator(checkpoint=...)`` loads a checkpoint directory of the port
(cli/train_separator --export) or a torch file (asteroid Conv-TasNet,
ModelScope / ClearVoice MossFormer: convert/torch_import.py); an orbax
directory raises NotImplementedError naming scripts/orbax_to_torch.py, the
converter. The long-form calls (``transcribe(long_form=True)``,
``separate_long``) take a mesh whose shards live on one device
(parallel/mesh.make_mesh); a mesh over several cards is slice 16.

The facades and factories take the JAX package's parameters in its order;
a torch device string in ``device`` / ``provider`` (default "cuda" where the
JAX package says "tpu") picks the device of the default engine a facade
builds when it is given none. ``auth_token`` is accepted and unused, as
there.
"""
from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..convert.torch_import import load_convtasnet_torch, load_mossformer_torch
from ..engine.runtime import G_SAMPLE_RATE, EnginePreset, ModelPack, StageEngine, tiny_preset
from ..ops.signal import l2norm
from .speaker import SpeakerBank

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
        """``long_form`` routes through StageEngine.transcribe_long: the
        utterance runs as ONE program with full attention context, its frame
        axis cut over the engine's mesh (ring attention) when it has one."""
        wav = self.engine.resample(np.asarray(samples, np.float32), sr, G_SAMPLE_RATE)
        if long_form:
            return self.engine.transcribe_long(wav, self.language, self.use_itn)
        return self.engine.transcribe([wav], self.language, self.use_itn)[0]

    def transcribe_batch(self, chunks, sr: int) -> List[str]:
        chunks = [self.engine.resample(np.asarray(c, np.float32), sr, G_SAMPLE_RATE)
                  for c in chunks]
        return self.engine.transcribe(chunks, self.language, self.use_itn)


def create_asr_model(
    *, paraformer: str = "", sense_voice: str = "", encoder: str = "", decoder: str = "",
    joiner: str = "", tokens: str = "", num_threads: int = 1, feature_dim: int = 80,
    decoding_method: str = "greedy_search", debug: bool = False, language: str = "auto",
    provider: str = "cuda", engine: Optional[StageEngine] = None,
) -> ASRRecognizer:
    """The reference's one-of factory (src/model.py:37-100): one of
    paraformer / sense_voice / transducer (encoder) must be given, else
    ValueError. The engine's pack holds the family and its weights (built
    by ``build_engine`` from the same flags); the names here only select."""
    if not (paraformer or sense_voice or encoder):
        raise ValueError("Provide one ASR model (paraformer | sense_voice | transducer)")
    eng = engine or default_engine(device=provider)
    return ASRRecognizer(eng, language=language, use_itn=bool(sense_voice))


def create_extractor_model(
    *, model: str = "", num_threads: int = 1, provider: str = "cuda", debug: bool = False,
    engine: Optional[StageEngine] = None,
) -> "SpeakerExtractor":
    """The reference's speaker-extractor factory (src/model.py:103-124;
    models/facades.py:111-115): the engine's pack holds the embedder and its
    weights, ``model`` only names them."""
    return SpeakerExtractor(engine or default_engine(device=provider))


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
    device: str = "cuda"
    backend: Optional[str] = None
    auth_token: Optional[str] = None
    engine: Optional[StageEngine] = None

    def __post_init__(self):
        self.backend = self.backend or "osdnet"
        if self.engine is None:
            self.engine = default_engine(device=self.device)

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
    device: str = "cuda"
    sample_rate: int = 16000
    checkpoint: Optional[str] = None
    n_src: int = 2
    engine: Optional[StageEngine] = None

    def __post_init__(self):
        self.backend = self.backend or "convtasnet"
        if self.engine is None:
            self.engine = default_engine(device=self.device)
        if self.checkpoint:
            self._load_checkpoint(self.checkpoint)
        if self.backend == "mossformer":
            self.sample_rate = self.engine.pack.preset.mossformer.sample_rate

    def _load_checkpoint(self, path: str) -> None:
        """A checkpoint directory of the port (cli/train_separator --export;
        an orbax one raises NotImplementedError naming the converter) or a
        torch file into the backend's separator: MossFormer (ModelScope /
        ClearVoice naming; MossFormerImportError on drift), else Conv-TasNet
        with ``n_src`` sources (asteroid naming)."""
        pack = self.engine.pack
        if os.path.isdir(path):
            from ..train.checkpoint import load_params

            stage = ("mossformer" if self.backend == "mossformer"
                     else "sep3" if self.n_src == 3 else "sep2")
            pack.load_params(stage, load_params(path, pack.models[stage]))
            return
        if not os.path.isfile(path):
            raise FileNotFoundError(f"Separator checkpoint not found: {path}")
        if self.backend == "mossformer":
            pack.load_params("mossformer", load_mossformer_torch(path, pack.preset.mossformer))
        else:
            stage = "sep3" if self.n_src == 3 else "sep2"
            pack.load_params(stage, load_convtasnet_torch(path, getattr(pack.preset, stage)))

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

    def separate_long(self, samples: np.ndarray, sr: int, mesh,
                      axis: str = "data") -> List[np.ndarray]:
        """One arbitrarily long mixture with its TIME axis cut over the mesh
        (parallel/sp_convtasnet: halo-exchanged convs; summed gLN statistics
        for Conv-TasNet, plain-sum ring passes for MossFormer's relu^2
        attention). Numerically the dense masked forward of the selected
        backend, in float (the audio is not quantised to int16 on the way)."""
        import torch

        from ..parallel.sp_convtasnet import sp_separate, sp_separate_mossformer

        wav = self._ensure_sr(np.asarray(samples, np.float32), sr)
        pack = self.engine.pack
        mix = torch.from_numpy(np.ascontiguousarray(wav))[None].to(pack.device)
        with torch.inference_mode():
            if self.backend == "mossformer":
                out = sp_separate_mossformer(pack.models["mossformer"], mix, None, mesh,
                                             axis=axis)
            else:
                stage = "sep3" if self.n_src == 3 else "sep2"
                out = sp_separate(pack.models[stage], mix, None, mesh, axis=axis)
        out = out[0].cpu().numpy()
        if out.shape[0] < self.n_src:  # same contract as separate()
            raise RuntimeError(
                f"Separation output has {out.shape[0]} < {self.n_src} sources; the "
                f"'{self.backend}' preset emits {out.shape[0]} streams: check model/config.")
        return [out[i] for i in range(self.n_src)]

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
    """The SID + ASR facade (reference: src/model.py:127-374). Reads the
    same fields off ``args``: enrollment with per-wav ``.npy`` caches
    (``emb_cache_dir``), npz save / load of the speakers' mean embeddings,
    ``identify`` (bank search + top-1 cosine) and ``asr_infer``. The bank
    lives on the engine's device."""

    def __init__(self, args, engine: Optional[StageEngine] = None):
        self.args = args
        self.provider = getattr(args, "provider", "cuda")
        self.engine = engine or default_engine(getattr(args, "preset", "full"),
                                               device=self.provider)
        self.using_cuda = self.engine.device.type == "cuda"
        self.asr = ASRRecognizer(self.engine, language=getattr(args, "language", "auto"),
                                 use_itn=True)
        self.extractor = SpeakerExtractor(self.engine)
        self.manager = SpeakerBank(self.extractor.dim, device=self.engine.device)
        self.enrolled: Dict[str, np.ndarray] = {}
        self.enrolled_norm: Dict[str, np.ndarray] = {}

    @staticmethod
    def _to_numpy_waveform(samples) -> np.ndarray:
        if isinstance(samples, np.ndarray):
            return samples.astype(np.float32, copy=False)
        return np.asarray(samples, dtype=np.float32).reshape(-1)

    def enroll_from_map(self, spk_map: Dict[str, List[str]], load_audio_func) -> None:
        args = self.args
        load_npz = getattr(args, "load_speaker_embeds", "")
        if load_npz:
            data = np.load(load_npz, allow_pickle=True)
            for spk in data.files:
                vec = data[spk].astype(np.float32)
                self.enrolled[spk] = vec
                self.enrolled_norm[spk] = np.asarray(l2norm(vec))
                if not self.manager.add(spk, vec):
                    raise RuntimeError(f"Failed to add speaker {spk} from preloaded embeds")
            return

        cache_dir = getattr(args, "emb_cache_dir", "")
        if cache_dir:
            os.makedirs(cache_dir, exist_ok=True)
        speaker_means: Dict[str, np.ndarray] = {}
        for spk, wavs in spk_map.items():
            if not wavs:
                continue
            # the wavs without a cached embedding go to the device as one batch
            cached: Dict[str, np.ndarray] = {}
            to_compute: List[Tuple[str, np.ndarray]] = []
            for w in wavs:
                cache_path = None
                if cache_dir:
                    cache_path = os.path.join(cache_dir,
                                              os.path.splitext(os.path.basename(w))[0] + ".npy")
                    if os.path.isfile(cache_path):
                        try:
                            cached[w] = np.asarray(l2norm(np.load(cache_path).astype(np.float32)))
                            continue
                        except (OSError, ValueError):
                            pass
                loaded = load_audio_func(w)
                if isinstance(loaded, tuple):
                    samples, sr = loaded[0], (loaded[1] if len(loaded) >= 2 else G_SAMPLE_RATE)
                else:
                    samples, sr = loaded, G_SAMPLE_RATE
                wav16 = self.engine.resample(self._to_numpy_waveform(samples), sr, G_SAMPLE_RATE)
                to_compute.append((w, wav16))
            if to_compute:
                embs = self.engine.embed([x for _, x in to_compute])
                for (w, _), emb in zip(to_compute, embs):
                    emb = np.asarray(l2norm(emb.astype(np.float32)))
                    cached[w] = emb
                    if cache_dir:
                        try:
                            np.save(os.path.join(cache_dir, os.path.splitext(
                                os.path.basename(w))[0] + ".npy"), emb)
                        except OSError:
                            pass
            mean_emb = (sum(cached[w] for w in wavs) / float(len(wavs))).astype(np.float32)
            speaker_means[spk] = mean_emb
            self.enrolled[spk] = mean_emb
            self.enrolled_norm[spk] = np.asarray(l2norm(mean_emb))
            if not self.manager.add(spk, mean_emb):
                raise RuntimeError(f"Failed to add speaker {spk}")

        save_npz = getattr(args, "save_speaker_embeds", "")
        if save_npz:
            try:
                np.savez_compressed(save_npz, **speaker_means)
            except OSError:
                pass

    def top1(self, emb: np.ndarray) -> float:
        """The best cosine score of ``emb`` over the enrolled speakers (nan
        with none)."""
        if not self.enrolled_norm:
            return float("nan")
        mat = np.stack(list(self.enrolled_norm.values()))
        return float((mat @ np.asarray(l2norm(emb))).max())

    def identify(self, samples, sr: int, threshold: float) -> Tuple[str, float]:
        emb = self.extractor.compute(self._to_numpy_waveform(samples), sr)
        pred = self.manager.search(emb, threshold=threshold) or "unknown"
        return pred, self.top1(emb)

    def asr_infer(self, samples, sr: int) -> str:
        return self.asr.transcribe(self._to_numpy_waveform(samples), sr)
