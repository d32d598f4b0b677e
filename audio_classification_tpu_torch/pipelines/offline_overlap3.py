"""Flagship offline pipeline: OSD -> 3-src separation -> SV gate -> ASR
(port of audio_classification_tpu/pipelines/offline_overlap3.py, file mode
and LibriMix dataset mode).

Mixtures (given files, or a LibriMix split with a seeded random target
source per mixture) are processed in waves; within a wave each stage runs once over
everything that needs it: OSD over the wave's mixtures, then the fused
overlap path (separation + per-branch SV + best-branch ASR) and the fused
clean path (SV + ASR) over the segments, then target-span ASR. Record and
metric field names and the gating semantics are the JAX pipeline's
(reference: overlap3_core.py:174-937); time_* fields are wall-clock around
each stage's device work, summed from the run's brackets: ``time_osd_sec``
OSD's collection; ``time_sep_sec`` a wave's launches and the overlap path's
collection (where the wave has overlap rows) and separations;
``time_asr_sec`` the enrollment's transcript, the clean and target-span
paths' collections and transcriptions.

Each ``run()`` is one job of the tracer (utils/profiling): a root bracket
``pipeline.job`` with ``pipeline.load``, ``enroll``, ``osd``, ``rows``,
``launch`` and ``collect`` (``granular`` in their place under
``fused_paths=False``), ``gate`` and ``records`` beneath it, and the
engine's ``engine.*`` spans beneath those. The brackets time themselves
whether or not the tracer records them.

Model files are read as the JAX runner reads them: an .onnx value of a
family flag, of --spk-embed-model / --model, maps onto the port's modules
(``--onnx-exec map``), runs as the graph itself (``direct``) or tries map
first (``auto``); checkpoint directories of the port and torch files load
too. Model weights the port does not read raise (``check_ported``); none
is ignored. ``--data-parallel`` / ``--model-parallel`` / ``--slices`` run
the engine over a mesh of one rank per card under ``torchrun``
(parallel/launch.py); only rank 0 writes.
"""
from __future__ import annotations

import contextlib
import dataclasses
import random
import time
from dataclasses import dataclass
from pathlib import Path
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from ..audio_io import read_wav, to_mono
from ..convert.assets import load_kaldi_cmvn
from ..convert.torch_import import load_convtasnet_torch, load_pyannet_torch
from ..data.librimix import LibriMixDataset
from ..engine import BucketSpec, ModelPack, StageEngine, exclusive_segments, tiny_preset
from ..engine.bucketing import default_buckets
from ..engine.runtime import G_SAMPLE_RATE, EnginePreset, resolve_device
from ..metrics import agg_stats, maybe_round, sdr_improvement_pit
from ..models.asr.tokens import TokenTable
from ..models.pyannet import BinarizeConfig
from ..parallel.launch import mesh_for
from ..runtime.monitor import ResourceMonitor
from ..train.checkpoint import (ORBAX_HINT, check_state_dict, is_orbax_dir, load_model_pack,
                                load_params)
from ..utils.config import Overlap3Config
from ..utils.profiling import bracket

# the flags that name model files: the ASR families' (reference:
# src/model.py:37-100), the speaker model's and the VAD's. An .onnx file loads
# (``load_onnx_models``; --silero-vad-model in cli/speaker_id_vad_asr), a
# value that is neither an .onnx file nor a directory selects the model with
# seeded weights, as the JAX pipeline does, and a directory of a flag not in
# _CHECKPOINT_DIR_FLAGS raises in check_ported
_MODEL_FILE_FLAGS = ("paraformer", "encoder", "decoder", "joiner", "whisper_encoder",
                     "whisper_decoder", "sense_voice", "wenet_ctc", "model", "spk_embed_model",
                     "silero_vad_model")

# the flags whose directory is a checkpoint of the port (train/checkpoint.py),
# loaded in build_engine: --sense-voice and --spk-embed-model / --model take
# an export of cli/train_asr / cli/train_speaker, --sep-checkpoint one of
# cli/train_separator, --osd-checkpoint the output of cli/distill_osd,
# --checkpoint-dir a whole model pack
_CHECKPOINT_DIR_FLAGS = ("sense_voice", "spk_embed_model", "model", "sep_checkpoint",
                         "osd_checkpoint", "checkpoint_dir")

# torch files an --osd-checkpoint may name: a pyannote segmentation checkpoint
_TORCH_SUFFIXES = (".bin", ".ckpt", ".pt", ".pth")

def check_ported(cfg) -> None:
    """Raise NotImplementedError for model weights this package does not
    read: a directory of a model-file flag that takes none (every family flag but
    --sense-voice, and --silero-vad-model: the JAX package reads none
    either), and an orbax directory of a checkpoint flag (converted by
    scripts/orbax_to_torch.py). An .onnx file of a model-file flag loads in
    ``build_engine`` (``load_onnx_models``). A torch file of
    --sep-checkpoint (asteroid Conv-TasNet) or --osd-checkpoint (pyannote
    PyanNet) and a checkpoint directory of the port
    (``_CHECKPOINT_DIR_FLAGS``; for --osd-checkpoint the params directory
    cli/distill_osd writes) load in ``build_engine``. An --osd-checkpoint
    that names neither a directory nor a torch file raises
    FileNotFoundError."""
    codec = getattr(cfg, "arena_codec", "i16")
    if codec not in ("i16", "mulaw"):
        raise ValueError(f"--arena-codec must be i16|mulaw, got {codec!r}")
    for name in _CHECKPOINT_DIR_FLAGS:
        value = getattr(cfg, name, "") or ""
        if value and is_orbax_dir(value):
            raise NotImplementedError(f"--{name.replace('_', '-')} {value}: {ORBAX_HINT}")
    osd = getattr(cfg, "osd_checkpoint", "") or ""
    if osd and not osd.endswith(_TORCH_SUFFIXES) and not Path(osd).is_dir():
        raise FileNotFoundError(
            f"--osd-checkpoint {osd}: neither a params directory of cli/distill_osd nor a "
            f"pyannote PyanNet torch file ({'/'.join(_TORCH_SUFFIXES)})")
    mode = getattr(cfg, "onnx_exec", "map")
    if mode not in ("map", "direct", "auto"):
        raise ValueError(f"--onnx-exec must be map|direct|auto, got {mode!r}")
    for name in _MODEL_FILE_FLAGS:
        value = getattr(cfg, name, "") or ""
        if value and Path(value).is_dir() and name not in _CHECKPOINT_DIR_FLAGS:
            raise NotImplementedError(
                f"--{name.replace('_', '-')} {value}: a directory is not a model file of "
                "this flag (the JAX package reads none either): give its .onnx file; any "
                "other value selects the model with seeded weights")


def _load_stage_dir(pack, stage: str, path: str, flag: str, hint: str) -> None:
    """A ``save_params`` directory into stage ``stage``; names or shapes
    that differ from the preset's model fail loud."""
    try:
        sd = load_params(path, pack.models[stage])
    except ValueError as e:
        raise ValueError(f"{flag} {path}: the checkpoint does not match the "
                         f"'{pack.preset.name}' preset's {stage} config -- {hint} "
                         f"(cause: {e})") from e
    pack.load_params(stage, sd)


def load_checkpoint_dirs(pack, cfg) -> None:
    """The checkpoint directories of the port that ``cfg`` names, into
    ``pack``, in the JAX runner's order (pipelines/offline_overlap3.py
    build_engine): --sense-voice (SenseVoice family only), --spk-embed-model
    (or --model), --checkpoint-dir (every stage), --sep-checkpoint (the
    first separator stage whose names and shapes it matches: sep3, sep2,
    then mossformer)."""
    sv = getattr(cfg, "sense_voice", "") or ""
    if sv and Path(sv).is_dir() and pack.asr_family == "sensevoice":
        _load_stage_dir(pack, "asr", sv, "--sense-voice",
                        "vocab from --tokens, dims from the preset")
    spk = getattr(cfg, "spk_embed_model", "") or getattr(cfg, "model", "") or ""
    if spk and Path(spk).is_dir():
        _load_stage_dir(pack, "spk", spk, "--spk-embed-model",
                        "was it trained with other --channels / --embed-dim?")
    ckpt = getattr(cfg, "checkpoint_dir", "") or ""
    if ckpt:
        load_model_pack(pack, ckpt)
    sep = getattr(cfg, "sep_checkpoint", "") or ""
    if sep and Path(sep).is_dir():
        sd = load_params(sep)
        stages = ("sep3", "sep2", "mossformer")
        errors = []
        for stage in stages:
            try:
                check_state_dict(sd, pack.models[stage].state_dict(), stage)
            except ValueError as e:
                errors.append(str(e))
                continue
            pack.load_params(stage, sd)
            return
        raise ValueError(f"--sep-checkpoint {sep}: the checkpoint matches none of the "
                         f"separator presets {stages} -- was it trained with other --enc-dim "
                         f"/ --hidden / --mf-dim flags? (causes: {'; '.join(errors)})")


def load_onnx_models(pack, cfg) -> None:
    """The .onnx files ``cfg`` names, into ``pack``, as the JAX runner loads
    them (pipelines/offline_overlap3.py build_engine). ``onnx_exec``:

    * "map": the graph-aware importer (convert/onnx_graph_map) puts the
      graph's weights onto the port's module, failing loud on a topology
      that does not match;
    * "direct": the graph itself serves the stage (convert/onnx_stage,
      ``pack.set_onnx_stage``);
    * "auto": map, and direct where mapping fails.

    --sense-voice x.onnx drops ``onnx_asr_skip_frames`` leading logit frames
    in direct mode (default: the prompt count); --wenet-ctc always runs
    direct, on plain fbank frames (LFR collapsed to 1); --whisper-encoder /
    --whisper-decoder, --paraformer (direct: the (logits, token_num) pair)
    and --encoder / --decoder / --joiner select their family's stage;
    --spk-embed-model (or --model) the speaker embedder's."""
    from ..convert.onnx_graph_map import import_onnx_state_dict
    from ..convert.onnx_stage import OnnxStage, OnnxTransducerStage, OnnxWhisperStage

    mode = getattr(cfg, "onnx_exec", "map")
    family, dev = pack.asr_family, pack.device

    def _load(stage: str, files, mapper: str, mod_cfg, direct_builder=None, **stage_kw):
        if mode != "direct":
            try:
                pack.load_params(stage, import_onnx_state_dict(files, mapper, mod_cfg))
                return
            except Exception as e:
                if mode == "map":
                    raise
                print(f"[build_engine] graph-aware mapping for stage '{stage}' failed "
                      f"({e}); serving the graph directly")
        if direct_builder is not None:
            pack.set_onnx_stage(stage, direct_builder())
            return
        first = files[0] if isinstance(files, list) else files
        pack.set_onnx_stage(stage, OnnxStage(first, device=dev, **stage_kw))

    sv = getattr(cfg, "sense_voice", "") or ""
    if sv.endswith(".onnx") and family == "sensevoice":
        # real SenseVoice exports emit their 4 prompt positions in the CTC
        # logits; drop them before decode unless overridden
        skip = int(getattr(cfg, "onnx_asr_skip_frames", -1))
        _load("asr", sv, "sensevoice", pack.asr_cfg,
              skip_frames=pack.asr_cfg.num_prompt if skip < 0 else skip)
    wn = getattr(cfg, "wenet_ctc", "") or ""
    if wn.endswith(".onnx") and family == "sensevoice" and not sv:
        # the WeNet CTC family (reference sp-id:346-357, from_wenet_ctc):
        # plain fbank frames in, no prompt positions in the logits, the
        # engine's CTC decode; no graph-aware mapper exists for it
        pack.asr_cfg = dataclasses.replace(pack.asr_cfg, lfr_m=1, lfr_n=1)
        skip = max(int(getattr(cfg, "onnx_asr_skip_frames", -1)), 0)
        pack.set_onnx_stage("asr", OnnxStage(wn, skip_frames=skip, device=dev))
    wh = getattr(cfg, "whisper_encoder", "") or ""
    if wh.endswith(".onnx") and family == "whisper":
        wh_dec = getattr(cfg, "whisper_decoder", "") or ""
        files = [wh] + ([wh_dec] if wh_dec.endswith(".onnx") else [])

        def _whisper_direct():
            if len(files) != 2:
                raise ValueError("direct whisper execution needs both "
                                 "--whisper-encoder and --whisper-decoder")
            wc = pack.whisper_cfg
            return OnnxWhisperStage(
                files[0], files[1], sot_sequence=(wc.bos_id,), eot_id=wc.eos_id,
                max_decode_len=wc.max_decode_len, num_mel=wc.num_mel,
                language=getattr(cfg, "whisper_language", "") or None,
                task=getattr(cfg, "whisper_task", "transcribe"), device=dev)

        _load("asr", files, "whisper", pack.whisper_cfg, direct_builder=_whisper_direct)
    pf = getattr(cfg, "paraformer", "") or ""
    if pf.endswith(".onnx") and family == "paraformer":
        _load("asr", pf, "paraformer", pack.paraformer_cfg, n_outputs=2)
    enc = getattr(cfg, "encoder", "") or ""
    if enc.endswith(".onnx") and family == "transducer":
        # the reference's from_transducer takes encoder / decoder / joiner
        # files (src/model.py:88-99); whichever are given, in that order
        files = [enc] + [f for f in (getattr(cfg, "decoder", ""), getattr(cfg, "joiner", ""))
                         if (f or "").endswith(".onnx")]

        def _transducer_direct():
            if len(files) != 3:
                raise ValueError("direct transducer execution needs all three of "
                                 "--encoder/--decoder/--joiner .onnx files")
            return OnnxTransducerStage(*files, blank_id=pack.tokens.blank_id, device=dev)

        _load("asr", files, "transducer", pack.transducer_cfg,
              direct_builder=_transducer_direct)
    # the flagship runner calls the speaker model --spk-embed-model; the SID
    # benchmark and sp-id scripts call it --model (reference:
    # benchmark_pipeline.py:498-504, sp-id:491-501)
    spk = getattr(cfg, "spk_embed_model", "") or getattr(cfg, "model", "") or ""
    if spk.endswith(".onnx"):
        _load("spk", spk, "speaker", pack.preset.spk)


def asr_family(cfg) -> str:
    """The ASR family the config's flags select, in the reference's one-of
    order: --paraformer, then --encoder (transducer), then
    --whisper-encoder; SenseVoice otherwise."""
    if getattr(cfg, "paraformer", ""):
        return "paraformer"
    if getattr(cfg, "encoder", ""):
        return "transducer"
    if getattr(cfg, "whisper_encoder", ""):
        return "whisper"
    return "sensevoice"


@dataclass
class PipelineResult:
    segments: List[Dict[str, Any]]
    sep_details_rows: List[List[Any]]
    metrics: Dict[str, Any]
    dataset_name: str
    subset: str
    processed_mixtures: int
    sample_rate: int


def build_engine(cfg, device=None) -> StageEngine:
    """ModelPack (seeded weights, ``preset``) + StageEngine on ``device``.

    ``device=None`` takes the config's ``provider`` ("cuda", the default, or
    "cpu"). The card is the default and a RuntimeError says so when there is
    none: the CPU is used only when asked for.

    The ASR family comes from the family flags (``asr_family``) and
    ``decoding_method`` / ``num_active_paths`` pick the transducer's search.

    ``quant="int8"`` switches both Conv-TasNet separators and the four ASR
    encoders to the int8 path (ops/quant; the masker's weights stream as
    int8 through K2). Quantisation happens at run time from the float
    parameters (the first forward keeps the int8 weights:
    ops/quant.constant_of), so a seed draws the same weights with and
    without it. MossFormer, OSDNet, the speaker embedder, the VAD and the
    decoders have no int8 path and stay float.

    Weight and asset files, as the JAX runner reads them: .onnx files of
    the family flags and the speaker model's (``load_onnx_models``, by
    ``onnx_exec``), ``cmvn`` (a
    kaldi am.mvn for the SenseVoice and Paraformer frontends), the port's
    checkpoint directories (``load_checkpoint_dirs``: what the training
    CLIs export, a whole model pack, or scripts/orbax_to_torch.py wrote),
    ``sep_checkpoint`` (a directory, or an asteroid Conv-TasNet torch file,
    into the 3-source separator) and ``osd_checkpoint``: a params directory
    of cli/distill_osd into the OSD stage (held to the preset's OSDNet, as
    the JAX runner loads it into the "osd" stage), or a pyannote
    segmentation torch file: PyanNet serves OSD, and any of ``osd_onset`` /
    ``osd_offset`` / ``osd_min_on`` / ``osd_min_off`` >= 0 switches its
    segments to pyannote's hysteresis, the others at BinarizeConfig's
    defaults; without a PyanNet they have no effect, as in JAX.

    ``compute_dtype`` ("float32" or "bfloat16") and ``arena_codec`` ("i16"
    or "mulaw") go to the StageEngine, as the JAX runner passes them
    (pipelines/offline_overlap3.py:312-322), and so does the mesh of
    ``data_parallel`` x ``model_parallel`` entries (``slices`` lays its data
    axis out), one rank per card under torchrun (parallel/launch.mesh_for;
    the pack then lives on the rank's card)."""
    check_ported(cfg)
    quant = getattr(cfg, "quant", "none")
    if quant not in ("none", "int8"):
        raise ValueError(f"--quant must be none|int8, got {quant!r}")
    if device is None:
        device = getattr(cfg, "provider", "cuda") or "cuda"
        if device != "cpu" and not str(device).startswith("cuda"):
            raise ValueError(f"--provider must be cuda|cpu, got {device!r}")
    device = resolve_device(device)
    mesh = mesh_for(getattr(cfg, "data_parallel", 0), getattr(cfg, "model_parallel", 0),
                    int(getattr(cfg, "slices", 1) or 1), device)
    device = mesh.device if mesh is not None else device
    preset = tiny_preset() if getattr(cfg, "preset", "full") == "tiny" else EnginePreset()
    if quant == "int8":
        preset = dataclasses.replace(
            preset,
            sep3=dataclasses.replace(preset.sep3, quant="int8"),
            sep2=dataclasses.replace(preset.sep2, quant="int8"),
            asr=dataclasses.replace(preset.asr, quant="int8"),
            transducer=dataclasses.replace(preset.transducer, quant="int8"),
            paraformer=dataclasses.replace(preset.paraformer, quant="int8"),
            whisper=dataclasses.replace(preset.whisper, quant="int8"))
    family = asr_family(cfg)
    tokens = None
    tok_path = getattr(cfg, "tokens", "")
    if tok_path and Path(tok_path).is_file():
        # sherpa-onnx whisper exports carry base64 byte-BPE tokens
        tokens = TokenTable.load(tok_path, base64_tokens=True if family == "whisper" else None)
    cmvn_path = getattr(cfg, "cmvn", "")
    pack = ModelPack(preset, seed=max(int(getattr(cfg, "seed", -1)), 0), tokens=tokens,
                     device=device, asr_family=family,
                     decoding_method=getattr(cfg, "decoding_method", "greedy_search"),
                     num_active_paths=getattr(cfg, "num_active_paths", 4),
                     cmvn=load_kaldi_cmvn(cmvn_path) if cmvn_path else None)
    load_onnx_models(pack, cfg)
    load_checkpoint_dirs(pack, cfg)
    sep_ckpt = getattr(cfg, "sep_checkpoint", "")
    if sep_ckpt and not Path(sep_ckpt).is_dir():
        pack.load_params("sep3", load_convtasnet_torch(sep_ckpt, preset.sep3))
    osd_ckpt = getattr(cfg, "osd_checkpoint", "")
    if osd_ckpt and Path(osd_ckpt).is_dir():
        _load_stage_dir(pack, "osd", osd_ckpt, "--osd-checkpoint",
                        "was it distilled with another --preset?")
    elif osd_ckpt:
        pn_cfg, pn_sd = load_pyannet_torch(osd_ckpt)
        hyst = {field: float(getattr(cfg, f"osd_{flag}", -1.0))
                for field, flag in (("onset", "onset"), ("offset", "offset"),
                                    ("min_duration_on", "min_on"),
                                    ("min_duration_off", "min_off"))}
        binarize = None
        if any(v >= 0 for v in hyst.values()):
            defaults = BinarizeConfig()
            binarize = BinarizeConfig(**{k: v if v >= 0 else getattr(defaults, k)
                                         for k, v in hyst.items()})
        pack.set_osd_pyannet(pn_cfg, pn_sd, binarize=binarize)
    buckets = BucketSpec(
        lengths=default_buckets(G_SAMPLE_RATE, 0.5, getattr(cfg, "max_segment_sec", 64.0)),
        max_batch=getattr(cfg, "max_batch", 8),
    )
    return StageEngine(pack, buckets, mesh=mesh,
                       compute_dtype=getattr(cfg, "compute_dtype", "float32") or "float32",
                       arena_codec=getattr(cfg, "arena_codec", "i16") or "i16")


def _load_resampled(engine: StageEngine, path: str) -> Tuple[np.ndarray, int]:
    wav, sr = read_wav(path)
    wav = to_mono(wav)
    wav = engine.resample(wav, sr, G_SAMPLE_RATE)
    return wav, G_SAMPLE_RATE


class Overlap3Pipeline:
    """Compute-only pipeline; the CLI runner writes all artifacts."""

    def __init__(self, cfg: Overlap3Config, engine: Optional[StageEngine] = None):
        check_ported(cfg)
        self.cfg = cfg
        if cfg.seed is not None and int(cfg.seed) >= 0:
            random.seed(int(cfg.seed))
            np.random.seed(int(cfg.seed))
        self.engine = engine or build_engine(cfg)

    # ------------------------------------------------------------------
    @contextlib.contextmanager
    def _bracket(self, name: str, field: Optional[str] = None):
        """The bracket ``pipeline.<name>``; its seconds are added to
        ``time_<field>_sec`` where ``field`` is given."""
        with bracket(f"pipeline.{name}") as b:
            yield b
        if field is not None:
            self._time[field] += b.seconds

    def run(self) -> PipelineResult:
        with bracket("pipeline.job", new_job=True):
            return self._run()

    def _run(self) -> PipelineResult:
        cfg = self.cfg
        eng = self.engine
        file_mode = bool(cfg.input_wavs)
        dataset_name = "manual-files" if file_mode else "LibriMix"

        ds: Optional[LibriMixDataset] = None
        file_items: List[Tuple[str, np.ndarray]] = []
        self._time = dict(osd=0.0, sep=0.0, asr=0.0)
        if file_mode:
            if not cfg.target_wav:
                raise ValueError("In file mode (--input-wavs), --target-wav is required.")
            # load first, then resample all non-16k files in one bucketed
            # batch per source rate
            with self._bracket("load"):
                loaded: List[Tuple[str, np.ndarray, int]] = []
                for p in cfg.input_wavs or []:
                    if not Path(p).is_file():
                        continue
                    wav, src_sr = read_wav(p)
                    loaded.append((str(Path(p)), to_mono(wav), int(src_sr)))
                by_sr: Dict[int, List[int]] = {}
                for i, (_p, _w, s0) in enumerate(loaded):
                    if s0 != G_SAMPLE_RATE:
                        by_sr.setdefault(s0, []).append(i)
                for s0, idxs in by_sr.items():
                    for i, w in zip(idxs, eng.resample_batch(
                            [loaded[i][1] for i in idxs], s0, G_SAMPLE_RATE)):
                        loaded[i] = (loaded[i][0], w, G_SAMPLE_RATE)
                file_items = [(p, np.asarray(w, np.float32)) for p, w, _ in loaded]
            limit = len(file_items)
        else:
            ds = LibriMixDataset(
                cfg.librimix_root, cfg.subset, num_speakers=3,
                sample_rate=cfg.sample_rate, task=cfg.task, mode=cfg.mode,
            )
            total = len(ds)
            limit = cfg.max_files if cfg.max_files and cfg.max_files > 0 else total

        refs_map = self._load_refs_csv() if (file_mode and cfg.refs_csv) else {}

        # ---- metric accumulators (names match overlap3_core.py:353-373)
        M = dict(
            n_segments=0, n_clean_segments=0, n_overlap_segments=0,
            n_separated_streams=0, n_matched_segments=0,
            n_seen_clean_segments=0, n_seen_overlap_segments=0,
            n_missed_segments=0, n_missed_clean_segments=0, n_missed_overlap_segments=0,
        )
        A = dict(
            total_audio_sec=0.0, total_overlap_audio_sec=0.0, total_clean_audio_sec=0.0,
            total_matched_audio_sec=0.0, total_seen_clean_audio_sec=0.0,
            total_seen_overlap_audio_sec=0.0, total_missed_audio_sec=0.0,
        )
        sep_sisdr: List[float] = []
        sep_sisdri: List[float] = []
        sep_details_rows: List[List[Any]] = []
        segments_out: List[Dict[str, Any]] = []

        monitor = None
        if cfg.enable_metrics:
            monitor = ResourceMonitor(cfg.monitor_interval)
            monitor.start()
        t0_all = time.perf_counter_ns()

        # ---- global target enrollment (file mode)
        g_target = None
        if file_mode:
            with self._bracket("enroll"):
                t_np, _ = _load_resampled(eng, cfg.target_wav)
                vec = eng.embed([t_np])[0]
                with self._bracket("enroll.asr", "asr"):
                    text = eng.transcribe([t_np], cfg.language)[0]
                g_target = dict(vec=vec, np=t_np, abs=str(Path(cfg.target_wav)), text=text)
                if getattr(cfg, "device_gather", True):
                    # target-span ASR windows gather from this single upload
                    # of the (shared) enrollment wav instead of re-uploading a
                    # window per segment row
                    g_target["arena"] = eng.upload_arena([t_np])

        wave_size = int(getattr(cfg, "wave_mixtures", 0) or 0)
        if wave_size <= 0:
            wave_size = 4 * max(int(getattr(cfg, "max_batch", 8)), 1)

        def prepare_wave(wave_start: int):
            """Load + batch-resample a wave and queue its OSD batch (one wave
            ahead, so the next wave's host work overlaps this wave's device
            work)."""
            with self._bracket("load"):
                return _prepare_wave(wave_start)

        def _prepare_wave(wave_start: int):
            wave_idx = list(range(wave_start, min(wave_start + wave_size, limit)))
            mixtures = [
                self._load_mixture(i, file_mode, file_items, ds, refs_map)
                for i in wave_idx
            ]
            # batch-resample the whole wave (dataset mode: one bucketed
            # dispatch instead of one device call per mixture/source)
            for src_sr in sorted({mx["sr_item"] for mx in mixtures if mx["sr_item"] != G_SAMPLE_RATE}):
                need = [mx for mx in mixtures if mx["sr_item"] == src_sr]
                flat: List[np.ndarray] = []
                owners: List[Tuple[dict, int]] = []
                for mx in need:
                    flat.append(mx["mix"])
                    owners.append((mx, -1))
                    if mx["sources"]:
                        for si, s in enumerate(mx["sources"]):
                            flat.append(s)
                            owners.append((mx, si))
                res = eng.resample_batch(flat, src_sr, G_SAMPLE_RATE)
                for (mx, si), w in zip(owners, res):
                    if si < 0:
                        mx["mix"] = w
                    else:
                        mx["sources"][si] = w
                for mx in need:
                    mx["dur"] = len(mx["mix"]) / G_SAMPLE_RATE
                    mx["sr_item"] = G_SAMPLE_RATE
            # one upload for the wave's audio; OSD batches and (below) the
            # fused-path segment windows gather from it on the device (None
            # -> per-batch upload: overlong items or --no-device-gather)
            arena = None
            if getattr(cfg, "device_gather", True):
                arena = eng.upload_arena([mx["mix"] for mx in mixtures])
            if arena is not None:
                for k, mx in enumerate(mixtures):
                    mx["arena_off"] = int(arena.offsets[k])
                h_osd = eng.launch_osd_arena(arena)
            else:
                h_osd = eng.launch_osd_batch([mx["mix"] for mx in mixtures], G_SAMPLE_RATE)
            return mixtures, h_osd, arena

        wave_starts = list(range(0, limit, wave_size))
        prefetched = prepare_wave(wave_starts[0]) if wave_starts else None
        for wi, wave_start in enumerate(wave_starts):
            mixtures, h_osd, arena = prefetched
            if wi + 1 < len(wave_starts):
                prefetched = prepare_wave(wave_starts[wi + 1])
            for mx in mixtures:
                A["total_audio_sec"] += mx["dur"]

            # ---- Stage: OSD over the whole wave (launched in prepare_wave)
            with self._bracket("osd", "osd"):
                osd_lists = eng.collect_osd_batch(h_osd, cfg.osd_thr, cfg.osd_win, cfg.osd_hop)
            # ---- host: exclusivity + segment rows; target selection
            with self._bracket("rows"):
                for mx, osd_segs in zip(mixtures, osd_lists):
                    if not osd_segs:
                        osd_segs = [(0.0, mx["dur"], False)]
                    if cfg.exclusive_segments:
                        segments = exclusive_segments(osd_segs, mx["dur"], cfg.min_overlap_dur)
                    else:
                        segments = [(float(s), float(e), bool(f)) for s, e, f in osd_segs]
                    rows = []
                    sr = G_SAMPLE_RATE
                    for s, e, is_olap in segments:
                        if e - s <= 0:
                            continue
                        s_i, e_i = int(s * sr), int(e * sr)
                        kind = ("overlap" if (is_olap and (e - s) >= cfg.min_overlap_dur)
                                else "clean")
                        rows.append(dict(s=s, e=e, s_i=s_i, e_i=e_i,
                                         chunk=mx["mix"][s_i:e_i], kind=kind))
                    mx["rows"] = rows
                    self._select_target(mx, file_mode, g_target, ds)

            # ---- Stage: enroll wave targets (dataset mode) in one batch each
            if not file_mode:
                need = [mx for mx in mixtures if mx.get("target_np") is not None]
                if need:
                    with self._bracket("enroll"):
                        embs = eng.embed([mx["target_np"] for mx in need])
                        with self._bracket("enroll.asr", "asr"):
                            texts = eng.transcribe([mx["target_np"] for mx in need],
                                                   cfg.language)
                        for mx, v, txt in zip(need, embs, texts):
                            mx["target_vec"] = v
                            mx["target_text_fb"] = txt

            # ---- Stages: queue the three independent device paths back to
            # back, then collect:
            #   A. fused overlap path (sep + per-branch SV + best-branch ASR;
            #      branches stay on the device unless the separation eval
            #      needs them)
            #   B. fused clean path (embed + SV + ASR)
            #   C. target-span ASR for every row with an enrolled source
            #      (speculative: launched before gating; discards are cheap
            #      compared to a serialized post-gate round trip)
            overlap_rows = [
                (mx, r) for mx in mixtures for r in mx["rows"]
                if r["kind"] == "overlap" and mx.get("target_vec") is not None
            ]
            clean_rows = [
                (mx, r) for mx in mixtures for r in mx["rows"]
                if r["kind"] == "clean" and mx.get("target_vec") is not None
            ]
            tspan_rows = [
                (mx, r) for mx in mixtures for r in mx["rows"]
                if mx.get("target_np") is not None
            ]
            h_ov = h_cl = h_tg = None
            fused = getattr(cfg, "fused_paths", True)
            if not fused:
                # granular stage dispatch: time_sep/time_asr become
                # reference-comparable per-stage walls (slower: branches
                # cross to the host and each stage dispatches separately)
                with self._bracket("granular"):
                    self._run_wave_granular(overlap_rows, clean_rows, tspan_rows)
            else:  # fused paths (default serving configuration)
                def _mix_spans(rows):
                    # segment windows into the wave arena (device gather);
                    # None when any row's mixture missed the arena
                    if arena is None or any("arena_off" not in mx for mx, _ in rows):
                        return None
                    return [(mx["arena_off"] + r["s_i"], len(r["chunk"]))
                            for mx, r in rows]

                with self._bracket("launch") as launched:
                    if overlap_rows:
                        with self._bracket("launch.overlap"):
                            h_ov = eng.launch_overlap(
                                [r["chunk"] for _, r in overlap_rows],
                                [mx["target_vec"] for mx, _ in overlap_rows],
                                cfg.language, return_branches=cfg.eval_separation,
                                backend=cfg.sep_backend,
                                arena=arena, spans=_mix_spans(overlap_rows),
                            )
                    if clean_rows:
                        with self._bracket("launch.clean"):
                            h_cl = eng.launch_clean(
                                [r["chunk"] for _, r in clean_rows],
                                [mx["target_vec"] for mx, _ in clean_rows],
                                cfg.language,
                                arena=arena, spans=_mix_spans(clean_rows),
                            )
                    if tspan_rows:
                        with self._bracket("launch.target"):
                            tg_chunks = [mx["target_np"][r["s_i"]:r["e_i"]]
                                         for mx, r in tspan_rows]
                            tg_arena = (g_target or {}).get("arena")
                            tg_spans = None
                            if tg_arena is not None and all(
                                mx["target_np"] is g_target["np"] for mx, _ in tspan_rows
                            ):
                                # file mode: every row slices the one enrollment wav
                                T = len(g_target["np"])
                                tg_spans = [
                                    (min(r["s_i"], T), max(min(r["e_i"], T) - r["s_i"], 0))
                                    for _, r in tspan_rows
                                ]
                            h_tg = eng.launch_transcribe(
                                tg_chunks, cfg.language, arena=tg_arena, spans=tg_spans,
                            )

            with self._bracket("collect") if fused else contextlib.nullcontext():
                # collect A (with the overlapped launches the per-stage
                # split is an attribution of the shared device timeline,
                # rtf_total stays exact)
                if h_ov is not None:
                    with self._bracket("collect.overlap") as b:
                        ov_out = eng.collect_overlap(h_ov, [r["chunk"] for _, r in overlap_rows],
                                                     cfg.eval_separation, cfg.sep_backend)
                    # time_sep_sec: the wave's launches and this collection
                    t_ov = launched.seconds + b.seconds
                    self._time["sep"] += t_ov
                    total_ov_samples = sum(len(r["chunk"]) for _, r in overlap_rows) or 1
                    for (mx, r), rec in zip(overlap_rows, ov_out):
                        r["branch_scores"] = {i: float(s) for i, s in enumerate(np.asarray(rec["scores"]))}
                        r["fused_best"] = rec["best"]
                        r["fused_text"] = rec["text"]
                        r["fused_share"] = t_ov * len(r["chunk"]) / total_ov_samples
                        if "branches" in rec:
                            r["branches"] = [np.asarray(rec["branches"][i]) for i in range(rec["branches"].shape[0])]
                # overlap rows with no enrollment still count as seen+missed in
                # gating below (reference: overlap3_core.py:787-791)

                # ---- optional separation quality eval (host PIT, parity oracle)
                if cfg.eval_separation:
                    # the reference separates before SV gating, so overlap rows of
                    # mixtures with no enrollment still get evaluated — run their
                    # separation granularly (rare: enrollment failure)
                    orphan = [
                        (mx, r) for mx in mixtures for r in mx["rows"]
                        if r["kind"] == "overlap" and mx.get("target_vec") is None and mx["src_paths"]
                    ]
                    if orphan:
                        with self._bracket("separate", "sep"):
                            outs = eng.separate([r["chunk"] for _, r in orphan], n_src=3,
                                                backend=cfg.sep_backend)
                        for (_, r), est in zip(orphan, outs):
                            r["branches"] = [np.asarray(est[i]) for i in range(est.shape[0])]
                    for mx in mixtures:
                        self._eval_separation(mx, file_mode, ds, sep_sisdr, sep_sisdri, sep_details_rows)

                # collect B + C
                if h_cl is not None:
                    with self._bracket("collect.clean", "asr") as b:
                        cl_out = eng.collect_clean(h_cl)
                    t_cl = b.seconds
                    total_cl_samples = sum(len(r["chunk"]) for _, r in clean_rows) or 1
                    for (mx, r), (score, text) in zip(clean_rows, cl_out):
                        r["sv_score"] = score
                        r["fused_text"] = text
                        r["fused_share"] = t_cl * len(r["chunk"]) / total_cl_samples
                if h_tg is not None:
                    with self._bracket("collect.target", "asr"):
                        tg_texts = eng.collect_transcribe(h_tg)
                    for (mx, r), text in zip(tspan_rows, tg_texts):
                        r["target_text"] = text

            # ---- gate (metrics bookkeeping) + granular ASR for pass-through
            # clean rows of mixtures with no enrollment
            with self._bracket("gate"):
                asr_items: List[np.ndarray] = []
                asr_owner: List[Tuple[dict, dict, str]] = []
                for mx in mixtures:
                    for r in mx["rows"]:
                        self._gate_row(mx, r, M, A, asr_items, asr_owner)

                if asr_items:
                    with self._bracket("transcribe", "asr") as b:
                        texts = eng.transcribe(asr_items, cfg.language)
                    total_asr_samples = sum(len(c) for c in asr_items) or 1
                    for (mx, r, role), text, chunk in zip(asr_owner, texts, asr_items):
                        if role == "main":
                            r["text"] = text
                            r["asr_time"] = b.seconds * (len(chunk) / total_asr_samples)

            # ---- emit records (field names: overlap3_core.py:667-680,820-833)
            with self._bracket("records"):
                for mx in mixtures:
                    for r in mx["rows"]:
                        if r.get("drop") or "text" not in r:
                            continue
                        tgt_text = r.get("target_text", "") or mx.get("target_text_fb", "")
                        seg_dur = r["e"] - r["s"]
                        segments_out.append({
                            "wav": mx["abs_path"],
                            "start": round(r["s"], 3),
                            "end": round(r["e"], 3),
                            "kind": r["kind"],
                            "stream": int(r["best_branch"]) if r["kind"] == "overlap" else None,
                            "text": r["text"],
                            "asr_time": round(r.get("asr_time", 0.0), 3),
                            "sv_score": round(r["sv_score"], 4) if r.get("sv_score") is not None else None,
                            "target_src": mx.get("target_abs"),
                            "target_src_text": tgt_text,
                        })
                        M["n_segments"] += 1
                        M["n_matched_segments"] += 1
                        A["total_matched_audio_sec"] += seg_dur
                        if r["kind"] == "clean":
                            M["n_clean_segments"] += 1
                            A["total_clean_audio_sec"] += seg_dur
                        else:
                            M["n_overlap_segments"] += 1
                            M["n_separated_streams"] += 1

        elapsed_compute = (time.perf_counter_ns() - t0_all) * 1e-9
        resource_stats: Dict[str, Any] = {}
        if monitor is not None:
            monitor.stop()
            resource_stats = monitor.aggregate()

        seen = M["n_seen_clean_segments"] + M["n_seen_overlap_segments"]
        rtf_total = elapsed_compute / A["total_audio_sec"] if A["total_audio_sec"] > 0 else None
        rtf_asr = self._time["asr"] / A["total_audio_sec"] if A["total_audio_sec"] > 0 else None
        metrics: Dict[str, Any] = {
            "total_audio_sec": round(A["total_audio_sec"], 3),
            "audio_overlap_sec": round(A["total_overlap_audio_sec"], 3),
            "audio_clean_sec": round(A["total_clean_audio_sec"], 3),
            "audio_matched_sec": round(A["total_matched_audio_sec"], 3),
            "audio_seen_clean_sec": round(A["total_seen_clean_audio_sec"], 3),
            "audio_seen_overlap_sec": round(A["total_seen_overlap_audio_sec"], 3),
            "audio_missed_sec": round(A["total_missed_audio_sec"], 3),
            "segments_total": M["n_segments"],
            "segments_clean": M["n_clean_segments"],
            "segments_overlap_streams": M["n_overlap_segments"],
            "separated_streams": M["n_separated_streams"],
            "segments_matched": M["n_matched_segments"],
            "segments_seen_clean": M["n_seen_clean_segments"],
            "segments_seen_overlap": M["n_seen_overlap_segments"],
            "segments_missed": M["n_missed_segments"],
            "segments_missed_clean": M["n_missed_clean_segments"],
            "segments_missed_overlap": M["n_missed_overlap_segments"],
            "target_hit_rate_segments": (
                round(M["n_matched_segments"] / seen, 4) if seen > 0 else None
            ),
            "time_osd_sec": round(self._time["osd"], 3),
            "time_sep_sec": round(self._time["sep"], 3),
            "time_asr_sec": round(self._time["asr"], 3),
            "time_compute_total_sec": round(elapsed_compute, 3),
            "rtf_total": maybe_round(rtf_total, 4),
            "rtf_asr": maybe_round(rtf_asr, 4),
        }
        if cfg.eval_separation:
            sisdr_stats = agg_stats(sep_sisdr)
            sisdri_stats = agg_stats(sep_sisdri)
            metrics.update({
                "sep_eval_k_refs": None,
                "sep_eval_segments": sisdr_stats["count"],
                "sep_sisdr_mean": sisdr_stats["mean"],
                "sep_sisdr_median": sisdr_stats["median"],
                "sep_sisdr_std": sisdr_stats["std"],
                "sep_sisdri_mean": sisdri_stats["mean"],
                "sep_sisdri_median": sisdri_stats["median"],
                "sep_sisdri_std": sisdri_stats["std"],
            })
        metrics.update(resource_stats)

        return PipelineResult(
            segments=segments_out,
            sep_details_rows=sep_details_rows,
            metrics=metrics,
            dataset_name=dataset_name,
            subset=cfg.subset,
            processed_mixtures=limit,
            sample_rate=cfg.sample_rate,
        )

    # ------------------------------------------------------------------
    def _load_mixture(self, idx, file_mode, file_items, ds, refs_map) -> dict:
        cfg = self.cfg
        eng = self.engine
        if file_mode:
            abs_path, mix_np = file_items[idx]
            src_paths: List[str] = []
            sources = None
            mix_norm = str(Path(abs_path))
            if mix_norm in refs_map:
                src_paths = refs_map[mix_norm]
            elif cfg.ref_wavs and len(file_items) == 1:
                src_paths = [str(Path(p)) for p in cfg.ref_wavs]
        else:
            sr_item, mix_wav, sources = ds[idx]
            _sr_meta, mix_rel, src_rel = ds.get_metadata(idx)
            src_paths = list(src_rel)
            abs_path = str(Path(cfg.librimix_root) / mix_rel)
            mix_np = mix_wav  # resampled wave-batched by the caller
            return dict(
                idx=idx, abs_path=abs_path, mix=mix_np, sources=sources,
                src_paths=src_paths, sr_item=sr_item,
                dur=len(mix_np) / sr_item,
            )
        return dict(
            idx=idx, abs_path=abs_path, mix=mix_np, sources=sources,
            src_paths=src_paths, sr_item=G_SAMPLE_RATE,
            dur=len(mix_np) / G_SAMPLE_RATE,
        )

    def _select_target(self, mx: dict, file_mode: bool, g_target, ds) -> None:
        """Per-mixture target (dataset mode: seeded random source pick,
        reference: overlap3_core.py:555-595). Embedding/ASR of dataset-mode
        targets happens later in a wave batch; here only the pick."""
        cfg = self.cfg
        if file_mode:
            if g_target is not None:
                mx["target_vec"] = g_target["vec"]
                mx["target_np"] = g_target["np"]
                mx["target_abs"] = g_target["abs"]
                mx["target_text_fb"] = g_target["text"]
            return
        mx["target_vec"] = None
        mx["target_np"] = None
        mx["target_abs"] = None
        mx["target_text_fb"] = ""
        try:
            t_idx = 0
            sources = mx["sources"]
            if sources:
                t_idx = random.randrange(len(sources))
            if mx["src_paths"] and len(mx["src_paths"]) > t_idx:
                mx["target_abs"] = str(Path(cfg.librimix_root) / mx["src_paths"][t_idx])
            if sources:
                mx["target_np"] = sources[t_idx]
        except Exception:
            mx["target_np"] = None

    def _eval_separation(self, mx: dict, file_mode: bool, ds, sep_sisdr, sep_sisdri, rows_out) -> None:
        cfg = self.cfg
        if not mx["src_paths"]:
            return
        overlap_rows = [r for r in mx["rows"] if r["kind"] == "overlap" and "branches" in r]
        if not overlap_rows:
            return
        ref_wavs = self._load_ref_sources(file_mode, mx["src_paths"], mx["sources"])
        if ref_wavs is None or len(ref_wavs) < 2:
            return
        k = 3 if len(ref_wavs) >= 3 else len(ref_wavs)
        mix_rel_path = mx["abs_path"] if file_mode else ds.get_metadata(mx["idx"])[1]
        for r in overlap_rows:
            refs = [rw[r["s_i"]:r["e_i"]] for rw in ref_wavs[:k]]
            best, sdri, idx_sel = sdr_improvement_pit(r["chunk"], refs, r["branches"])
            if not (np.isnan(best) or np.isnan(sdri)):
                sep_sisdr.append(float(best))
                sep_sisdri.append(float(sdri))
                rows_out.append([
                    mix_rel_path, f"{r['s']:.3f}", f"{r['e']:.3f}", k,
                    f"{best:.4f}", f"{sdri:.4f}",
                    ";".join(str(i) for i in idx_sel),
                ])

    def _run_wave_granular(self, overlap_rows, clean_rows, tspan_rows) -> None:
        """Granular stage dispatch (``fused_paths=False``): stage walls book
        exactly as the reference's per-stage timers do — separation to
        time_sep (overlap3_core.py:689-691), every ASR call to time_asr
        (:644-649,795-799), SV embedding UNBOOKED (the reference never adds
        it to a stage bucket) — so time_sep/time_asr are directly
        reference-comparable. Rows get the same fields the fused collectors
        set, so gating/metrics code downstream is shared."""
        eng, cfg = self.engine, self.cfg
        if overlap_rows:
            with self._bracket("separate", "sep"):
                ests = eng.separate([r["chunk"] for _, r in overlap_rows],
                                    n_src=3, backend=cfg.sep_backend)
            flat = [np.asarray(est[i]) for est in ests for i in range(est.shape[0])]
            embs = eng.embed(flat)
            best_wavs, owners = [], []
            pos = 0
            for (mx, r), est in zip(overlap_rows, ests):
                k = est.shape[0]
                scores = embs[pos:pos + k] @ np.asarray(mx["target_vec"])
                pos += k
                r["branch_scores"] = {i: float(s) for i, s in enumerate(scores)}
                r["fused_best"] = int(np.argmax(scores))
                if cfg.eval_separation:
                    r["branches"] = [np.asarray(est[i]) for i in range(k)]
                best_wavs.append(np.asarray(est[r["fused_best"]]))
                owners.append(r)
            with self._bracket("transcribe", "asr") as b:
                texts = eng.transcribe(best_wavs, cfg.language)
            tot = sum(len(w) for w in best_wavs) or 1
            for r, text, w in zip(owners, texts, best_wavs):
                r["fused_text"] = text
                r["fused_share"] = b.seconds * len(w) / tot
        if clean_rows:
            embs = eng.embed([r["chunk"] for _, r in clean_rows])
            for (mx, r), v in zip(clean_rows, embs):
                r["sv_score"] = float(np.dot(np.asarray(v), np.asarray(mx["target_vec"])))
            with self._bracket("transcribe", "asr") as b:
                texts = eng.transcribe([r["chunk"] for _, r in clean_rows], cfg.language)
            tot = sum(len(r["chunk"]) for _, r in clean_rows) or 1
            for (mx, r), text in zip(clean_rows, texts):
                r["fused_text"] = text
                r["fused_share"] = b.seconds * len(r["chunk"]) / tot
        if tspan_rows:
            with self._bracket("transcribe", "asr"):
                texts = eng.transcribe(
                    [mx["target_np"][r["s_i"]:r["e_i"]] for mx, r in tspan_rows],
                    self.cfg.language)
            for (mx, r), text in zip(tspan_rows, texts):
                r["target_text"] = text

    def _gate_row(self, mx: dict, r: dict, M: dict, A: dict, asr_items, asr_owner) -> None:
        """SV gating + ASR work collection for one segment row
        (semantics: overlap3_core.py:611-791)."""
        cfg = self.cfg
        seg_dur = r["e"] - r["s"]
        has_target = mx.get("target_vec") is not None
        if r["kind"] == "clean":
            M["n_seen_clean_segments"] += 1
            A["total_seen_clean_audio_sec"] += seg_dur
            sv = r.get("sv_score")
            matched = (sv is not None and sv >= cfg.sv_threshold) if has_target else True
            if not matched:
                M["n_missed_segments"] += 1
                M["n_missed_clean_segments"] += 1
                A["total_missed_audio_sec"] += seg_dur
                r["drop"] = True
                return
            if "fused_text" in r:
                r["text"] = r["fused_text"]
                r["asr_time"] = r.get("fused_share", 0.0)
            else:  # no enrollment: pass-through clean row, granular ASR
                asr_items.append(r["chunk"])
                asr_owner.append((mx, r, "main"))
        else:
            M["n_seen_overlap_segments"] += 1
            A["total_seen_overlap_audio_sec"] += seg_dur
            A["total_overlap_audio_sec"] += seg_dur
            bscores = r.get("branch_scores", {})
            if not has_target or not bscores:
                M["n_missed_segments"] += 1
                M["n_missed_overlap_segments"] += 1
                A["total_missed_audio_sec"] += seg_dur
                r["drop"] = True
                return
            best_b = max(bscores, key=bscores.get)
            best_score = bscores[best_b]
            if best_score < cfg.sv_threshold:
                M["n_missed_segments"] += 1
                M["n_missed_overlap_segments"] += 1
                A["total_missed_audio_sec"] += seg_dur
                r["drop"] = True
                return
            r["best_branch"] = best_b
            r["sv_score"] = best_score
            r["text"] = r["fused_text"]
            r["asr_time"] = r.get("fused_share", 0.0)

    # ------------------------------------------------------------------
    def _load_refs_csv(self) -> Dict[str, List[str]]:
        """mix,ref1,ref2[,ref3] rows (reference: overlap3_core.py:424-448)."""
        import csv

        refs_map: Dict[str, List[str]] = {}
        with open(self.cfg.refs_csv, "r", encoding="utf-8") as f:
            rdr = csv.reader(f)
            header = next(rdr, None)
            if header and not any("mix" in (c or "").lower() for c in header):
                if len(header) >= 3:
                    refs_map[str(Path(header[0]))] = [str(Path(x)) for x in header[1:] if (x or "").strip()]
            for row in rdr:
                if not row or len(row) < 3:
                    continue
                refs_map[str(Path(row[0]))] = [str(Path(x)) for x in row[1:] if (x or "").strip()]
        return refs_map

    def _load_ref_sources(self, file_mode: bool, src_paths: List[str], sources) -> Optional[List[np.ndarray]]:
        if not file_mode and sources is not None:
            return sources
        out = []
        for sp in src_paths:
            p = Path(sp) if file_mode else Path(self.cfg.librimix_root) / sp
            if not p.is_file():
                return None
            wav, _ = _load_resampled(self.engine, str(p))
            out.append(wav)
        return out
