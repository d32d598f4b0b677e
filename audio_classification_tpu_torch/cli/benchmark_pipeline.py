"""SID + ASR benchmark CLI, PyTorch port (port of
audio_classification_tpu/cli/benchmark_pipeline.py; reference:
scripts/benchmark_pipeline.py:66-547).

Same flag names and output files (timestamped dir under --out-dir with
detail.jsonl / predictions.csv / summary.json / summary.txt, optional
cpu_usage.csv/.png with --plot-cpu). The ASR family comes from
--paraformer / --sense-voice / --encoder (seeded weights, or the .onnx files
these flags and --model name, read by ``--onnx-exec map|direct|auto`` as the
flagship runner reads them). Runs on the GPU unless ``--provider cpu`` is
given.

    python -m audio_classification_tpu_torch.cli.benchmark_pipeline \
        --speaker-file enroll.txt --test-list test.txt --sense-voice seeded
"""
from __future__ import annotations

import argparse
import time
from datetime import datetime
from pathlib import Path

from ..models.facades import SpeakerASRModels, set_default_engine
from ..pipelines.offline_overlap3 import build_engine
from ..pipelines.sid_benchmark import BenchmarkRunner, load_audio, load_pairs, load_refs
from ..utils.config import SidBenchmarkConfig


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    p.add_argument("--speaker-file", required=True, help="Enrollment list <spk> <wav>")
    p.add_argument("--test-list", required=True, help="Test list <spk> <wav>")
    p.add_argument("--model", default="", help="Speaker embedding model path")
    p.add_argument("--silero-vad-model", default="", help="(Unused here) VAD model path")
    p.add_argument("--threshold", type=float, default=0.5, help="Speaker match threshold")
    p.add_argument("--num-threads", type=int, default=1)
    p.add_argument("--provider", type=str, default="cuda",
                   help="Device: cuda (raises when no GPU is found) or cpu")
    p.add_argument("--debug", action="store_true")
    p.add_argument("--paraformer", default="")
    p.add_argument("--sense-voice", default="")
    p.add_argument("--encoder", default="")
    p.add_argument("--decoder", default="")
    p.add_argument("--joiner", default="")
    p.add_argument("--tokens", default="")
    p.add_argument("--cmvn", default="", help="kaldi am.mvn CMVN stats for the ASR frontend")
    p.add_argument("--decoding-method", default="greedy_search")
    p.add_argument("--num-active-paths", type=int, default=4,
                   help="beam width for modified_beam_search (transducer)")
    p.add_argument("--feature-dim", type=int, default=80)
    p.add_argument("--language", default="auto")
    p.add_argument("--ref-text-list", default="", help="<wav>\\t<ref_text> or <utt_id> <text>")
    p.add_argument("--out-dir", default="test")
    p.add_argument("--emb-cache-dir", default="")
    p.add_argument("--save-speaker-embeds", default="")
    p.add_argument("--load-speaker-embeds", default="")
    p.add_argument("--cpu-normalize", action="store_true")
    p.add_argument("--plot-cpu", action="store_true")
    p.add_argument("--preset", default="full", choices=["full", "tiny"])
    p.add_argument("--checkpoint-dir", default="")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--max-batch", type=int, default=8)
    p.add_argument("--onnx-exec", default="map", choices=["map", "direct", "auto"],
                   help="ONNX checkpoints: map weights onto our modules, execute the "
                        "exported graph directly, or try map then fall back to direct")
    p.add_argument("--batch-mode", action="store_true",
                   help="Batch the whole test list through the device (per-"
                        "utterance times become apportioned batch shares)")
    return p.parse_args(argv)


def config_from_args(args: argparse.Namespace) -> SidBenchmarkConfig:
    """The parsed flags that SidBenchmarkConfig names, typed (the runner
    reads the namespace, whose other flags it also takes)."""
    fields = SidBenchmarkConfig.__dataclass_fields__
    return SidBenchmarkConfig(**{k: getattr(args, k) for k in fields if hasattr(args, k)})


def main(argv=None):
    args = parse_args(argv)
    start_all = time.time()

    engine = build_engine(args)
    set_default_engine(engine)
    models = SpeakerASRModels(args, engine=engine)

    spk_map = load_pairs(args.speaker_file)
    test_map = load_pairs(args.test_list)
    models.enroll_from_map(spk_map, load_audio)

    flat = [(spk, wav) for spk, wavs in test_map.items() for wav in wavs]
    all_wavs = [w for _, w in flat]
    refs = load_refs(args.ref_text_list, all_wavs)

    out_dir = Path(args.out_dir) / datetime.now().strftime("%Y-%m-%d_%H-%M-%S")
    out_dir.mkdir(parents=True, exist_ok=True)

    runner = BenchmarkRunner(args, models)
    runner.set_total_items(len(flat))
    if args.batch_mode:
        runner.process_batch(flat, refs)
    else:
        for spk_true, wav in flat:
            runner.process_one(spk_true, wav, refs)

    asr_type = ("paraformer" if args.paraformer else
                "sense_voice" if args.sense_voice else
                "transducer" if args.encoder else "sense_voice")
    summary = runner.finalize(start_all, out_dir, args.model, asr_type)
    runner.write_outputs(out_dir)
    print(f"Accuracy: {summary['accuracy']}, utts={summary['total_utts']}, out={out_dir}")
    return out_dir, summary


if __name__ == "__main__":
    main()
