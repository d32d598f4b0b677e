"""Overlap MVP (2-src) runner: OSD -> 2-source separation -> ASR, no SV
(port of audio_classification_tpu/cli/offline_overlap_mvp.py).

Reimplements the reference's self-contained MVP
(reference: scripts/osd/offline_overlap_mvp.py:96-479): Libri2Mix 8k test
split -> resample 16k -> OSD; clean segments go straight to ASR, overlap
segments get 2-source separation and BOTH branches are transcribed.
Identical CSV columns (wav,start,end,kind,stream,text,asr_time) and
metrics fields including the per-stage shares (:439-456).

Per wave of mixtures, all overlap chunks separate in one bucketed batch
(Conv-TasNet-2, or MossFormer with --sep-backend mossformer) and all ASR
(clean chunks + both branches of every overlap chunk) decodes in one batch.
Flags whose feature is not ported yet raise NotImplementedError
(pipelines/offline_overlap3.check_ported).

    python -m audio_classification_tpu_torch.cli.offline_overlap_mvp \
        --librimix-root <parent of Libri2Mix> --preset full --enable-metrics
"""
from __future__ import annotations

import argparse
import csv
import json
import time
from datetime import datetime
from pathlib import Path
from typing import Dict, List

from ..data.librimix import LibriMixDataset
from ..engine.runtime import G_SAMPLE_RATE
from ..metrics.aggregate import maybe_round
from ..pipelines.offline_overlap3 import build_engine
from ..runtime.monitor import ResourceMonitor


def parse_args(argv=None):
    p = argparse.ArgumentParser(formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    p.add_argument("--model", default="", help="(Ignored) speaker embedding path placeholder")
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
    p.add_argument("--num-threads", type=int, default=1)
    p.add_argument("--provider", default="cuda",
                   help="Device: cuda (raises when no GPU is found) or cpu")
    p.add_argument("--threshold", type=float, default=0.5,
                   help="(Ignored) kept for backward CLI compatibility")
    p.add_argument("--max-files", type=int, default=0, help="Limit number of mixtures processed (0 = all)")
    p.add_argument("--osd-backend", default="osdnet")
    p.add_argument("--osd-thr", type=float, default=0.5)
    p.add_argument("--osd-win", type=float, default=0.5)
    p.add_argument("--osd-hop", type=float, default=0.1)
    p.add_argument("--sep-backend", default="convtasnet")
    p.add_argument("--sep-checkpoint", default="")
    p.add_argument("--osd-checkpoint", default="", help="OSD weights: orbax dir (cli/distill_osd) or pyannote segmentation torch checkpoint (.bin/.ckpt/.pt)")
    p.add_argument("--min-overlap-dur", type=float, default=0.4)
    p.add_argument("--out-dir", default="test_overlap")
    p.add_argument("--enable-metrics", action="store_true")
    p.add_argument("--monitor-interval", type=float, default=0.5)
    p.add_argument("--metrics-out", default="metrics.json")
    # dataset location (the reference pulls Libri2Mix_8k from ModelScope; here local)
    p.add_argument("--librimix-root", required=True, help="Parent dir of Libri2Mix (wav8k)")
    p.add_argument("--preset", default="full", choices=["full", "tiny"])
    p.add_argument("--quant", default="none", choices=["none", "int8"],
                   help="int8 inference (not ported yet: raises)")
    p.add_argument("--checkpoint-dir", default="")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--max-batch", type=int, default=8)
    p.add_argument("--max-segment-sec", type=float, default=64.0)
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    base_out = Path(args.out_dir)
    base_out.mkdir(parents=True, exist_ok=True)
    out_dir = base_out / datetime.now().strftime("%Y-%m-%d_%H-%M-%S")
    out_dir.mkdir(parents=True, exist_ok=True)

    engine = build_engine(args)
    ds = LibriMixDataset(args.librimix_root, subset="test", num_speakers=2,
                         sample_rate=8000, task="sep_clean", mode="min")
    total = len(ds)
    limit = args.max_files if args.max_files and args.max_files > 0 else total
    print(f"[overlap_mvp] Loaded Libri2Mix_8k test split size={total}, processing={limit}")

    seg_jsonl = (out_dir / "segments.jsonl").open("w", encoding="utf-8")
    pred_csv = (out_dir / "segments.csv").open("w", newline="", encoding="utf-8")
    w = csv.writer(pred_csv)
    w.writerow(["wav", "start", "end", "kind", "stream", "text", "asr_time"])

    n_segments = n_clean = n_overlap = n_streams = 0
    total_audio = total_overlap = total_clean = 0.0
    time_osd = time_sep = time_asr = 0.0

    monitor = None
    if args.enable_metrics:
        monitor = ResourceMonitor(args.monitor_interval)
        monitor.start()
    t0_all = time.time()
    processed = 0

    # wave-batched execution (same architecture as the flagship pipeline):
    # per wave, each stage dispatches once over everything that needs it
    wave_size = 4 * int(getattr(args, "max_batch", 8))
    sr = G_SAMPLE_RATE
    for wave_start in range(0, limit, wave_size):
        wave_idx = list(range(wave_start, min(wave_start + wave_size, limit)))
        raw = [ds[i] for i in wave_idx]
        paths = [str(ds.items[i].mix_path) for i in wave_idx]
        samples_list = engine.resample_batch([mix for _, mix, _ in raw], raw[0][0], sr) \
            if raw and raw[0][0] != sr else [mix for _, mix, _ in raw]

        t_o = time.time()
        seg_lists = engine.osd_segments_batch(samples_list, sr, args.osd_thr,
                                              args.osd_win, args.osd_hop)
        time_osd += time.time() - t_o

        wave_rows: List[dict] = []
        for wav_path, samples, segs in zip(paths, samples_list, seg_lists):
            dur = len(samples) / sr
            total_audio += dur
            if not segs:
                segs = [(0.0, dur, False)]
            for s, e, is_olap in segs:
                if e - s <= 0:
                    continue
                chunk = samples[int(s * sr):int(e * sr)]
                kind = "overlap" if (is_olap and (e - s) >= args.min_overlap_dur) else "clean"
                wave_rows.append(dict(wav=wav_path, s=s, e=e, chunk=chunk, kind=kind))

        over = [r for r in wave_rows if r["kind"] == "overlap"]
        if over:
            t_s = time.time()
            outs = engine.separate([r["chunk"] for r in over], n_src=2, backend=args.sep_backend)
            time_sep += time.time() - t_s
            for r, o in zip(over, outs):
                r["branches"] = [o[0], o[1]]

        asr_items, owners = [], []
        for r in wave_rows:
            if r["kind"] == "clean":
                asr_items.append(r["chunk"]); owners.append((r, None))
                total_clean += r["e"] - r["s"]
            else:
                total_overlap += r["e"] - r["s"]
                for k, b in enumerate(r["branches"]):
                    asr_items.append(b); owners.append((r, k))
        asr_elapsed = 0.0
        texts: List[str] = []
        if asr_items:
            t_a = time.time()
            texts = engine.transcribe(asr_items, args.language)
            asr_elapsed = time.time() - t_a
            time_asr += asr_elapsed
        total_samples = sum(len(c) for c in asr_items) or 1
        for (r, k), text, chunk in zip(owners, texts, asr_items):
            share = asr_elapsed * len(chunk) / total_samples
            rec = {
                "wav": r["wav"],
                "start": round(r["s"], 3),
                "end": round(r["e"], 3),
                "kind": r["kind"],
                "stream": k,
                "text": text,
                "asr_time": round(share, 3),
            }
            seg_jsonl.write(json.dumps(rec, ensure_ascii=False) + "\n")
            w.writerow([r["wav"], f"{r['s']:.3f}", f"{r['e']:.3f}", r["kind"],
                        "" if k is None else k, text, f"{share:.3f}"])
            n_segments += 1
            if r["kind"] == "clean":
                n_clean += 1
            else:
                n_overlap += 1
                n_streams += 1
        processed += len(wave_idx)
        if processed % 50 < len(wave_idx):
            print(f"[overlap_mvp] Processed {processed}/{limit} mixtures")

    seg_jsonl.close()
    pred_csv.close()
    elapsed = time.time() - t0_all
    resource_stats = {}
    if monitor:
        monitor.stop()
        resource_stats = monitor.aggregate()

    rtf_total = elapsed / total_audio if total_audio > 0 else None
    rtf_asr = time_asr / total_audio if total_audio > 0 else None
    share = lambda t: (t / elapsed) if elapsed > 0 else None

    metrics: Dict[str, object] = {
        "total_audio_sec": round(total_audio, 3),
        "audio_overlap_sec": round(total_overlap, 3),
        "audio_clean_sec": round(total_clean, 3),
        "segments_total": n_segments,
        "segments_clean": n_clean,
        "segments_overlap_streams": n_overlap,
        "separated_streams": n_streams,
        "time_wall_sec": round(elapsed, 3),
        "time_osd_sec": round(time_osd, 3),
        "time_sep_sec": round(time_sep, 3),
        "time_asr_sec": round(time_asr, 3),
        "share_osd": maybe_round(share(time_osd), 4),
        "share_sep": maybe_round(share(time_sep), 4),
        "share_asr": maybe_round(share(time_asr), 4),
        "rtf_total": maybe_round(rtf_total, 4),
        "rtf_asr": maybe_round(rtf_asr, 4),
    }
    metrics.update(resource_stats)

    summary = {
        "segments": n_segments,
        "elapsed_wall_sec": round(elapsed, 3),
        "dataset": "Libri2Mix_8k",
        "processed_mixtures": processed,
        "sample_rate_target": G_SAMPLE_RATE,
        "notes": "ASR only; overlap segments separated; no CER (no refs).",
    }
    if args.enable_metrics:
        summary["metrics"] = metrics
        with (out_dir / args.metrics_out).open("w", encoding="utf-8") as mf:
            json.dump(metrics, mf, ensure_ascii=False, indent=2)
    with (out_dir / "summary.json").open("w", encoding="utf-8") as f:
        json.dump(summary, f, ensure_ascii=False, indent=2)
    print(
        f"Done. segments={n_segments}, mixtures={processed}, elapsed={elapsed:.3f}s, "
        f"RTF={metrics.get('rtf_total') if args.enable_metrics else 'n/a'}, out_dir={out_dir}"
    )
    return out_dir, metrics


if __name__ == "__main__":
    main()
