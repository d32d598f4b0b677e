"""Offline OSD + 3-source separation + ASR runner, PyTorch port (port of
audio_classification_tpu/cli/offline_overlap_3src.py).

The flag set and the artifact writers (segments.jsonl, segments.csv,
optional overlap_sep_details.csv / metrics.json, summary.json under
<out-dir>/<timestamp>/) are the JAX runner's. Flags whose feature is not
ported yet raise NotImplementedError naming the ROADMAP slice
(pipelines/offline_overlap3.check_ported). Runs on the GPU unless
``--provider cpu`` is given.

    python -m audio_classification_tpu_torch.cli.offline_overlap_3src \
        --input-wavs mix.wav --target-wav target.wav --preset full --seed 0
    python -m audio_classification_tpu_torch.cli.offline_overlap_3src \
        --librimix-root <parent of Libri3Mix> --sep-backend mossformer --eval-separation
    python -m audio_classification_tpu_torch.cli.offline_overlap_3src \
        --input-wavs mix.wav --target-wav target.wav --trace-spans spans.json
"""
from __future__ import annotations

import argparse
import csv
import json
from datetime import datetime
from pathlib import Path

from ..parallel.launch import is_writer
from ..pipelines.offline_overlap3 import Overlap3Pipeline, PipelineResult
from ..utils.config import Overlap3Config
from ..utils import profiling


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    # Dataset (LibriMix)
    p.add_argument("--librimix-root", default="", help="Parent dir of Libri2Mix/Libri3Mix")
    p.add_argument("--subset", default="test", choices=["train-360", "train-100", "dev", "test"])
    p.add_argument("--sample-rate", type=int, default=16000, choices=[8000, 16000])
    p.add_argument("--task", default="sep_clean",
                   choices=["enh_single", "enh_both", "sep_clean", "sep_noisy"])
    p.add_argument("--mode", default="min", choices=["min", "max"])
    p.add_argument("--max-files", type=int, default=0, help="Limit number of mixtures processed (0=all)")
    p.add_argument("--seed", type=int, default=-1, help="Random seed for reproducibility (>=0 to enable)")
    # File-mode
    p.add_argument("--input-wavs", nargs="+", default=None,
                   help="Process given mixture WAV files directly (bypasses LibriMix). If set, --target-wav is required.")
    p.add_argument("--target-wav", default="", help="Enrollment audio WAV for the target speaker (REQUIRED in file mode).")
    p.add_argument("--refs-csv", default="", help="CSV mapping mixture to reference sources: mix,ref1,ref2[,ref3].")
    p.add_argument("--ref-wavs", nargs="+", default=None,
                   help="Reference source WAVs (2 or 3) when only a single mixture is provided.")
    # OSD
    p.add_argument("--osd-backend", default="osdnet")
    p.add_argument("--osd-thr", type=float, default=0.5)
    p.add_argument("--osd-win", type=float, default=0.5)
    p.add_argument("--osd-hop", type=float, default=0.1)
    # Separation
    p.add_argument("--sep-backend", default="convtasnet")
    p.add_argument("--sep-checkpoint", default="", help="separator weights: a directory of cli/train_separator --export, or an asteroid Conv-TasNet torch checkpoint (an orbax dir: convert it with scripts/orbax_to_torch.py)")
    p.add_argument("--osd-checkpoint", default="", help="OSD weights: a params dir of cli/distill_osd or a pyannote segmentation torch checkpoint (.bin/.ckpt/.pt/.pth); an orbax dir raises (scripts/orbax_to_torch.py converts it)")
    p.add_argument("--osd-onset", type=float, default=-1.0,
                   help="PyanNet OSD: pyannote Binarize onset (enables hysteresis)")
    p.add_argument("--osd-offset", type=float, default=-1.0,
                   help="PyanNet OSD: pyannote Binarize offset")
    p.add_argument("--osd-min-on", type=float, default=-1.0,
                   help="PyanNet OSD: min_duration_on seconds")
    p.add_argument("--osd-min-off", type=float, default=-1.0,
                   help="PyanNet OSD: min_duration_off seconds")
    # ASR
    p.add_argument("--paraformer", default="")
    p.add_argument("--sense-voice", default="")
    p.add_argument("--encoder", default="")
    p.add_argument("--decoder", default="")
    p.add_argument("--joiner", default="")
    p.add_argument("--whisper-encoder", default="",
                   help="Whisper-style ASR family (seeded weights unless an .onnx file: "
                        "the encoder graph, with --whisper-decoder's)")
    p.add_argument("--whisper-decoder", default="")
    p.add_argument("--tokens", default="")
    p.add_argument("--cmvn", default="", help="kaldi am.mvn CMVN stats for the ASR frontend")
    p.add_argument("--decoding-method", default="greedy_search")
    p.add_argument("--num-active-paths", type=int, default=4,
                   help="beam width for modified_beam_search (transducer)")
    p.add_argument("--feature-dim", type=int, default=80)
    p.add_argument("--language", default="auto")
    p.add_argument("--num-threads", type=int, default=1)
    p.add_argument("--provider", default="cuda",
                   help="Device: cuda (raises when no GPU is found) or cpu")
    # Target speaker
    p.add_argument("--spk-embed-model", default="", help="Speaker embedder weights: a directory of cli/train_speaker --export, or an .onnx graph (--onnx-exec)")
    p.add_argument("--sv-threshold", type=float, default=0.6, help="Cosine similarity threshold (0~1)")
    # Overlap handling
    p.add_argument("--min-overlap-dur", type=float, default=0.4)
    p.add_argument("--exclusive-segments", dest="exclusive_segments", action="store_true",
                   help="Make clean segments the complement of merged overlap segments.")
    p.add_argument("--no-exclusive-segments", dest="exclusive_segments", action="store_false")
    p.set_defaults(exclusive_segments=True)
    # Output / metrics
    p.add_argument("--out-dir", default="test/overlap3")
    p.add_argument("--enable-metrics", action="store_true")
    p.add_argument("--monitor-interval", type=float, default=0.5)
    p.add_argument("--metrics-out", default="metrics.json")
    p.add_argument("--eval-separation", action="store_true",
                   help="Evaluate separation SI-SDR / SI-SDRi on predicted overlap segments (K=3)")
    p.add_argument("--save-sep-details", action="store_true")
    p.add_argument("--sep-details-out", default="overlap_sep_details.csv")
    # framework knobs (the JAX runner's; unported ones raise)
    p.add_argument("--preset", default="full", choices=["full", "tiny"])
    p.add_argument("--checkpoint-dir", default="", help="model-pack directory for all model params (train/checkpoint.save_model_pack, or scripts/orbax_to_torch.py from an orbax dir)")
    p.add_argument("--max-batch", type=int, default=8)
    p.add_argument("--max-segment-sec", type=float, default=64.0)
    p.add_argument("--profile-dir", default="", help="torch.profiler trace output dir (a Chrome trace of the run, stage ranges engine.osd / overlap / clean / asr)")
    p.add_argument("--trace-spans", default="", metavar="PATH",
                   help="turn the port's tracer on (no profiler needed) and write its spans "
                        "as a Chrome trace JSON to PATH when the run ends: pipeline.* phases, "
                        "engine.launch.* / engine.wait.* per batch, with ids, parents, the "
                        "job and counters (and the profiler's clock anchors with "
                        "--profile-dir)")
    p.add_argument("--data-parallel", type=int, default=0,
                   help="Shard stage batches over N cards, one torchrun rank each "
                        "(torchrun --nproc-per-node N x M; 0 = single device)")
    p.add_argument("--model-parallel", type=int, default=0,
                   help="TP: shard the separators' TCN hidden dim over M "
                        "cards (mesh = data x model ranks; 0 = off)")
    p.add_argument("--slices", type=int, default=1,
                   help="Multi-node deployments: the data axis spans "
                        "slices x per-node cards, node-major (torchrun "
                        "ranks); TP never crosses a node")
    p.add_argument("--compute-dtype", default="float32", choices=["float32", "bfloat16"],
                   help="bfloat16 compute: the models run as a bfloat16 copy of their weights "
                        "(the JAX engine's bf16 mode; every ASR family, OSDNet or an "
                        "--osd-checkpoint PyanNet)")
    p.add_argument("--wave-mixtures", type=int, default=0,
                   help="Mixtures per processing wave (0 = 4x max-batch)")
    p.add_argument("--onnx-exec", default="map", choices=["map", "direct", "auto"],
                   help="ONNX checkpoints: map weights onto our modules, "
                        "execute the exported graph directly, or try map "
                        "then fall back to direct")
    p.add_argument("--onnx-asr-skip-frames", type=int, default=-1,
                   help="Leading logit frames dropped in direct ONNX ASR "
                        "exec (-1 = the family's prompt count)")
    p.add_argument("--no-fused-paths", dest="fused_paths",
                   action="store_false", default=True,
                   help="Dispatch sep/SV/ASR as granular stage programs "
                        "instead of fused path programs: slower (branches "
                        "cross device->host), but time_sep/time_asr become "
                        "reference-comparable per-stage walls")
    p.add_argument("--no-device-gather", dest="device_gather",
                   action="store_false", default=True,
                   help="Upload every stage batch from host instead of "
                        "gathering segment windows on device from one "
                        "packed per-wave audio uplink (the default halves+ "
                        "host->device bytes)")
    p.add_argument("--arena-codec", dest="arena_codec", default="i16",
                   choices=["i16", "mulaw"],
                   help="Wave-arena uplink encoding: i16 keeps the "
                        "bit-parity contract with the host-pad path; mulaw "
                        "halves the audio uplink bytes (8-bit companding, "
                        "~38 dB SNR, decoded on device) — worthwhile when "
                        "the host->device link is the bottleneck")
    p.add_argument("--quant", default="none", choices=["none", "int8"],
                   help="int8: the Conv-TasNet separators and the ASR encoders run "
                        "dynamic int8 (ops/quant); the masker streams int8 weights")
    return p.parse_args(argv)


def config_from_args(args: argparse.Namespace) -> Overlap3Config:
    fields = Overlap3Config.__dataclass_fields__
    kwargs = {k: getattr(args, k) for k in fields if hasattr(args, k)}
    return Overlap3Config(**kwargs)


def write_artifacts(out_dir: Path, result: PipelineResult, cfg: Overlap3Config) -> None:
    """Writers mirror offline_overlap_3src.py:169-253 field-for-field."""
    with (out_dir / "segments.jsonl").open("w", encoding="utf-8") as jf, \
         (out_dir / "segments.csv").open("w", newline="", encoding="utf-8") as cf:
        w = csv.writer(cf)
        w.writerow(["wav", "start", "end", "kind", "stream", "text", "asr_time",
                    "sv_score", "target_src", "target_src_text"])
        for rec in result.segments:
            jf.write(json.dumps(rec, ensure_ascii=False) + "\n")
            w.writerow([
                rec.get("wav", ""),
                f"{rec.get('start', 0):.3f}",
                f"{rec.get('end', 0):.3f}",
                rec.get("kind", ""),
                rec.get("stream") if rec.get("stream") is not None else "",
                rec.get("text", ""),
                f"{rec.get('asr_time', 0):.3f}",
                rec.get("sv_score") if rec.get("sv_score") is not None else "",
                rec.get("target_src", "") or "",
                rec.get("target_src_text", ""),
            ])

    if cfg.eval_separation and cfg.save_sep_details:
        with (out_dir / cfg.sep_details_out).open("w", newline="", encoding="utf-8") as fh:
            w = csv.writer(fh)
            w.writerow(["wav", "start", "end", "k_refs", "sisdr", "sisdri", "selected_pred_indices"])
            for row in result.sep_details_rows:
                w.writerow(row)

    metrics = result.metrics
    summary = {
        "segments": metrics.get("segments_total"),
        "dataset": result.dataset_name,
        "subset": result.subset,
        "num_speakers": 3,
        "sample_rate": result.sample_rate,
        "processed_mixtures": result.processed_mixtures,
        "notes": "ASR only; overlap segments separated into 3 branches; no CER.",
        "target_hits_segments": metrics.get("segments_matched"),
        "target_misses_segments": metrics.get("segments_missed"),
        "target_hits_clean_segments": metrics.get("segments_clean"),
        "target_misses_clean_segments": metrics.get("segments_missed_clean"),
        "target_hits_overlap_segments": metrics.get("segments_overlap_streams"),
        "target_misses_overlap_segments": metrics.get("segments_missed_overlap"),
    }
    if cfg.enable_metrics:
        with (out_dir / cfg.metrics_out).open("w", encoding="utf-8") as mf:
            json.dump(metrics, mf, ensure_ascii=False, indent=2)
        summary["metrics"] = metrics
    with (out_dir / "summary.json").open("w", encoding="utf-8") as f:
        json.dump(summary, f, ensure_ascii=False, indent=2)


def main(argv=None):
    args = parse_args(argv)
    cfg = config_from_args(args)
    if not cfg.input_wavs and not cfg.librimix_root:
        raise SystemExit("Provide --librimix-root (dataset mode) or --input-wavs (file mode)")
    pipeline = Overlap3Pipeline(cfg)  # raises for options not ported yet

    if args.trace_spans:
        profiling.clear()
        profiling.enable()
    try:
        with profiling.trace(cfg.profile_dir):
            result = pipeline.run()
    finally:
        if args.trace_spans:
            profiling.disable()
    if not is_writer():  # a rank of a mesh: rank 0 writes
        return None, result
    if args.trace_spans:
        profiling.export_chrome(args.trace_spans)
        profiling.clear()
    base_out = Path(cfg.out_dir)
    base_out.mkdir(parents=True, exist_ok=True)
    out_dir = base_out / datetime.now().strftime("%Y-%m-%d_%H-%M-%S")
    out_dir.mkdir(parents=True, exist_ok=True)
    write_artifacts(out_dir, result, cfg)
    print(
        f"Done. segments={result.metrics.get('segments_total')}, "
        f"mixtures={result.processed_mixtures}, out_dir={out_dir}"
    )
    return out_dir, result


if __name__ == "__main__":
    main()
