"""Typed pipeline configs (host copy of audio_classification_tpu/utils/config.py:
Overlap3Config and SidBenchmarkConfig) mirroring the reference CLI surface.

The reference passes raw argparse namespaces into components that read them
with getattr defaults (reference: overlap3_core.py:146-160, SURVEY.md §5.6).
Here every pipeline has an explicit dataclass whose field names equal the
reference's flag names (dashes->underscores), so CLI parity is mechanical
and components get a typed contract.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional


@dataclass
class Overlap3Config:
    """Flags of offline_overlap_3src.py (reference: :25-154) + framework knobs."""

    # Dataset (LibriMix)
    librimix_root: str = ""
    subset: str = "test"
    sample_rate: int = 16000
    task: str = "sep_clean"
    mode: str = "min"
    max_files: int = 0
    seed: int = -1
    # File-mode
    input_wavs: Optional[List[str]] = None
    target_wav: str = ""
    refs_csv: str = ""
    ref_wavs: Optional[List[str]] = None
    # OSD
    osd_backend: str = "osdnet"
    osd_thr: float = 0.5
    osd_win: float = 0.5
    osd_hop: float = 0.1
    # Separation
    sep_backend: str = "convtasnet"
    sep_checkpoint: str = ""
    # OSD
    osd_checkpoint: str = ""          # params dir of cli/distill_osd or
                                      # pyannote torch ckpt (.bin/.ckpt/.pt/.pth)
    # pyannote Binarize hysteresis for the PyanNet OSD path (negative =
    # unset; any field >= 0 enables hysteresis, unset fields use pyannote
    # defaults onset/offset 0.5, durations 0.0)
    osd_onset: float = -1.0
    osd_offset: float = -1.0
    osd_min_on: float = -1.0
    osd_min_off: float = -1.0
    # ASR (model selection mirrors create_asr_model's one-of contract)
    paraformer: str = ""
    sense_voice: str = ""
    encoder: str = ""
    decoder: str = ""
    joiner: str = ""
    whisper_encoder: str = ""          # whisper family (sp-id script:316-345)
    whisper_decoder: str = ""
    whisper_language: str = ""         # "" = export default / multilingual sot
    whisper_task: str = "transcribe"
    tokens: str = ""
    cmvn: str = ""                     # kaldi am.mvn stats for the ASR frontend
    decoding_method: str = "greedy_search"  # greedy_search | modified_beam_search
                                            # (beam: transducer family only,
                                            # as in sherpa-onnx)
    num_active_paths: int = 4               # beam width for modified_beam_search
    feature_dim: int = 80
    language: str = "auto"
    num_threads: int = 1
    provider: str = "cuda"            # "cuda" (default; raises without a card) or "cpu"
    # Target speaker
    spk_embed_model: str = ""
    sv_threshold: float = 0.6
    # Overlap handling
    min_overlap_dur: float = 0.4
    exclusive_segments: bool = True
    # Output / metrics
    out_dir: str = "test/overlap3"
    enable_metrics: bool = False
    monitor_interval: float = 0.5
    metrics_out: str = "metrics.json"
    eval_separation: bool = False
    save_sep_details: bool = False
    sep_details_out: str = "overlap_sep_details.csv"
    debug: bool = False
    # --- framework knobs of the JAX runner (no reference equivalent) ---
    preset: str = "full"              # model-size preset ("full" | "tiny")
    checkpoint_dir: str = ""          # orbax params for all models
    max_batch: int = 8
    max_segment_sec: float = 64.0
    profile_dir: str = ""             # torch.profiler trace output dir (utils/profiling.trace)
    data_parallel: int = 0            # shard stage batches over N chips (0 = single device)
    model_parallel: int = 0           # TP: separators' TCN hidden dim over M chips
    slices: int = 1                   # multi-slice deployments: DP spans slices x chips
                                      # with the DCN factor outermost (TP stays in-slice)
    compute_dtype: str = "float32"    # "bfloat16": the models run in bf16 (norm stats f32)
    wave_mixtures: int = 0            # mixtures per wave (0 = 4x max_batch); larger waves
                                      # amortize per-phase dispatch latency over more audio
    onnx_exec: str = "map"            # ONNX checkpoints: "map" weights onto our modules,
                                      # "direct" executes the exported graph itself,
                                      # "auto" tries map then falls back to direct
    onnx_asr_skip_frames: int = -1    # leading logit frames to drop in direct ASR exec
                                      # (-1 = the family's prompt count)
    fused_paths: bool = True          # True: sep+SV+ASR in one device program per path
                                      # (fastest; path wall books to time_sep/time_asr).
                                      # False: granular stage programs — time_sep/time_asr
                                      # are then reference-comparable per-stage walls
    device_gather: bool = True        # upload each wave's audio ONCE as a packed int16
                                      # arena and gather OSD/segment batches from it on
                                      # device (halves+ H2D bytes); False: per-batch uplink
    arena_codec: str = "i16"          # arena uplink encoding: "i16" (bit-parity default)
                                      # or "mulaw" (8-bit companding, half the uplink
                                      # bytes, ~38 dB SNR; device LUT decode)
    quant: str = "none"               # "int8": separators and the ASR encoder on the
                                      # int8 path (ops/quant; K2's int8 weight stream)


@dataclass
class SidBenchmarkConfig:
    """Flags of benchmark_pipeline.py (SID + ASR benchmark); the JAX
    package's fields and defaults, but ``provider``, which names the port's
    devices (cuda, or cpu when asked for)."""

    speaker_file: str = ""
    test_list: str = ""
    model: str = ""                    # speaker embedding model path (reference name)
    threshold: float = 0.5
    num_threads: int = 1
    provider: str = "cuda"
    paraformer: str = ""
    sense_voice: str = ""
    encoder: str = ""
    decoder: str = ""
    joiner: str = ""
    tokens: str = ""
    cmvn: str = ""
    decoding_method: str = "greedy_search"  # greedy_search | modified_beam_search
                                            # (beam: transducer family only)
    num_active_paths: int = 4               # beam width for modified_beam_search
    feature_dim: int = 80
    language: str = "auto"
    debug: bool = False
    emb_cache_dir: str = ""
    load_speaker_embeds: str = ""
    save_speaker_embeds: str = ""
    ref_text_list: str = ""
    out_dir: str = "test/benchmark"
    monitor_interval: float = 0.5
    preset: str = "full"
    checkpoint_dir: str = ""
    max_batch: int = 8
    onnx_exec: str = "map"
    onnx_asr_skip_frames: int = -1
