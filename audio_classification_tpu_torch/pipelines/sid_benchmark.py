"""Speaker-ID + ASR benchmark pipeline (port of
audio_classification_tpu/pipelines/sid_benchmark.py).

The reference's BenchmarkRunner flow (reference:
scripts/benchmark_pipeline.py:158-371): enroll speakers from a
`<spk> <wav>` map, then for each test utterance identify + transcribe,
accumulating sid/asr/total timings, RTF (= asr_time / duration), CER with
CJK/alnum normalization, and per-utterance CPU snapshots. Outputs keep the
reference's detail.jsonl / predictions.csv / summary.json(.txt) schemas.

With --batch-mode the identification embeddings and the ASR decode run as
bucketed device batches over the whole test list; per-utterance times are
then the batch wall-clock apportioned by audio share. ``psutil`` and
``matplotlib`` are optional: without them the CPU columns stay empty and
the CPU plot is skipped.
"""
from __future__ import annotations

import math
import os
import time
from collections import defaultdict
from pathlib import Path
from typing import Any, Dict, Iterable, List, Optional, Tuple

import numpy as np

from ..audio_io import read_wav
from ..engine.runtime import G_SAMPLE_RATE
from ..metrics.text import cer as cer_fn
from ..metrics.text import normalize_for_cer
from ..models.facades import SpeakerASRModels

try:
    import psutil
except ImportError:  # pragma: no cover - absent on some machines
    psutil = None


def load_pairs(path: str) -> Dict[str, List[str]]:
    """`<spk> <wav>` list -> {spk: [wavs]} (reference: :111-123)."""
    d: Dict[str, List[str]] = defaultdict(list)
    with open(path, "r", encoding="utf-8") as f:
        for ln in f:
            ln = ln.strip()
            if not ln:
                continue
            parts = ln.split()
            if len(parts) != 2:
                raise ValueError(f"Bad line: {ln}")
            d[parts[0]].append(parts[1])
    return d


def load_audio(fname: str) -> Tuple[np.ndarray, int, float]:
    """Decode + mono + linear-resample to 16 kHz (reference: :126-138)."""
    data, sr = read_wav(fname, always_2d=True)
    samples = np.ascontiguousarray(data[0])
    dur = len(samples) / sr if sr else 0.0
    if sr != G_SAMPLE_RATE and len(samples) > 1:
        tgt_n = int(round(len(samples) * G_SAMPLE_RATE / sr))
        if tgt_n > 1:
            old_idx = np.arange(len(samples), dtype=np.float64)
            new_idx = np.linspace(0, len(samples) - 1, tgt_n, dtype=np.float64)
            samples = np.interp(new_idx, old_idx, samples).astype(np.float32)
            sr = G_SAMPLE_RATE
    return samples, sr, dur


def load_refs(path: str, test_wavs: Optional[Iterable[str]] = None) -> Dict[str, str]:
    """Reference-text loader with core-id broadcast (reference: :375-460).

    Mode 1 (TSV `<wav>\\t<text>`) maps directly; mode 2 (`<utt_id> <text>`)
    broadcasts to every test wav whose 4-token core id matches.
    """
    if not path:
        return {}
    refs: Dict[str, str] = {}

    def core_id(b: str) -> str:
        parts = b.split("_")
        return "_".join(parts[:4]) if len(parts) >= 4 else b

    core_map: Dict[str, List[str]] = defaultdict(list)
    wavs_list = list(test_wavs) if test_wavs else []
    for w in wavs_list:
        core_map[core_id(os.path.splitext(os.path.basename(w))[0])].append(w)

    ref_lines_total = core_ids_matched = wavs_assigned = 0
    seen: set = set()
    with open(path, "r", encoding="utf-8") as f:
        for ln in f:
            ln = ln.rstrip("\n")
            if not ln:
                continue
            if "\t" in ln:
                wav, txt = ln.split("\t", 1)
                refs[wav] = txt.strip()
                wavs_assigned += 1
            else:
                parts = ln.split(maxsplit=1)
                if len(parts) != 2:
                    continue
                utt_id, txt = parts
                ref_lines_total += 1
                targets = core_map.get(utt_id)
                if not targets:
                    for k in core_map:
                        if k.startswith(utt_id):
                            targets = core_map[k]
                            break
                if targets:
                    for w in targets:
                        refs[w] = txt.strip()
                    wavs_assigned += len(targets)
                    if utt_id not in seen:
                        core_ids_matched += 1
                        seen.add(utt_id)
    if wavs_list:
        total = len(wavs_list)
        coverage = wavs_assigned / total * 100.0 if total else 0.0
        avg_var = wavs_assigned / core_ids_matched if core_ids_matched else 0.0
        print(
            f"[load_refs] ref_lines_total={ref_lines_total} core_ids_matched={core_ids_matched} "
            f"wavs_assigned={wavs_assigned} test_wavs_total={total} "
            f"coverage_wavs={coverage:.1f}% avg_variants_per_core={avg_var:.2f}"
        )
    return refs


class BenchmarkRunner:
    """Per-utterance loop + metric accumulation (reference: :158-315)."""

    def __init__(self, args, models: SpeakerASRModels):
        self.args = args
        self.models = models
        self.proc = psutil.Process(os.getpid()) if psutil else None
        if self.proc:
            self.proc.cpu_percent(None)
        self.detail_records: List[Dict[str, Any]] = []
        self.rows_csv: List[List[str]] = []
        self.metrics: Dict[str, Any] = {}
        self._durations: List[float] = []
        self._sid_times: List[float] = []
        self._asr_times: List[float] = []
        self._total_times: List[float] = []
        self._rtfs: List[float] = []
        self._cer_vals: List[float] = []
        self._cpu_before_seq: List[Optional[float]] = []
        self._cpu_after_seq: List[Optional[float]] = []
        self.total = self.correct = self.unknown = 0
        self.total_items = 0
        self._last_report = time.time()

    def set_total_items(self, n: int):
        self.total_items = n

    def _cpu(self) -> Optional[float]:
        if not self.proc:
            return None
        v = self.proc.cpu_percent(interval=None)
        if getattr(self.args, "cpu_normalize", False):
            v /= os.cpu_count() or 1
        return v

    def process_one(self, spk_true: str, wav: str, refs: Dict[str, str]):
        samples, sr, dur = load_audio(wav)
        t0 = time.time()
        cpu_before = self._cpu()
        sid_start = time.time()
        pred, score = self.models.identify(samples, sr, self.args.threshold)
        sid_end = time.time()
        text = self.models.asr_infer(samples, sr)
        asr_end = time.time()
        cpu_after = self._cpu()
        sid_time = sid_end - sid_start
        asr_time = asr_end - sid_end
        total_time = asr_end - t0
        rtf = asr_time / dur if dur > 0 else 0.0
        self._record(spk_true, wav, refs, dur, pred, score, text,
                     sid_time, asr_time, total_time, rtf, cpu_before, cpu_after)

    def process_batch(self, flat, refs: Dict[str, str]):
        """Batched variant (--batch-mode): one embedding batch + one ASR
        batch for the whole test list; per-utterance times are the batch
        wall-clock apportioned by audio share (deviation from the
        reference's serial per-utterance timing, outputs otherwise equal).
        """
        loaded = [load_audio(w) for _, w in flat]
        cpu_before = self._cpu()
        t_sid0 = time.time()
        embs = self.models.extractor.compute_batch([s for s, _, _ in loaded], 16000)
        sid_elapsed = time.time() - t_sid0
        t_asr0 = time.time()
        texts = self.models.asr.transcribe_batch([s for s, _, _ in loaded], 16000)
        asr_elapsed = time.time() - t_asr0
        cpu_after = self._cpu()
        total_dur = sum(d for _, _, d in loaded) or 1.0
        for (spk_true, wav), (samples, sr, dur), emb, text in zip(flat, loaded, embs, texts):
            pred = self.models.manager.search(emb, threshold=self.args.threshold) or "unknown"
            score = self.models.top1(emb)
            share = dur / total_dur
            sid_time = sid_elapsed * share
            asr_time = asr_elapsed * share
            rtf = asr_time / dur if dur > 0 else 0.0
            self._record(spk_true, wav, refs, dur, pred, score, text,
                         sid_time, asr_time, sid_time + asr_time, rtf,
                         cpu_before, cpu_after)

    def _record(self, spk_true, wav, refs, dur, pred, score, text,
                sid_time, asr_time, total_time, rtf, cpu_before, cpu_after):
        self.total += 1
        if pred == spk_true:
            self.correct += 1
        elif pred == "unknown":
            self.unknown += 1
        ref_raw = refs.get(wav, "")
        ref_norm = normalize_for_cer(ref_raw) if ref_raw else ""
        hyp_norm = normalize_for_cer(text)
        cer_val = cer_fn(ref_norm, hyp_norm) if ref_norm else float("nan")
        if not math.isnan(cer_val):
            self._cer_vals.append(cer_val)
        self._durations.append(dur)
        self._sid_times.append(sid_time)
        self._asr_times.append(asr_time)
        self._total_times.append(total_time)
        self._rtfs.append(rtf)
        fmt = lambda x: "" if x is None else f"{x:.3f}"
        self._cpu_before_seq.append(cpu_before)
        self._cpu_after_seq.append(cpu_after)
        self.rows_csv.append([
            wav, spk_true, pred, f"{score:.3f}", text, f"{dur:.3f}",
            f"{sid_time:.3f}", f"{asr_time:.3f}", f"{total_time:.3f}", f"{rtf:.3f}",
            fmt(cpu_before), fmt(cpu_after),
            "" if math.isnan(cer_val) else f"{cer_val:.3f}",
        ])
        self.detail_records.append({
            "wav": wav, "speaker_true": spk_true, "speaker_pred": pred,
            "score": score, "text": text, "text_norm": hyp_norm,
            "ref_text": ref_raw, "ref_text_norm": ref_norm,
            "dur_sec": round(dur, 3), "sid_time": round(sid_time, 3),
            "asr_time": round(asr_time, 3), "total_time": round(total_time, 3),
            "rtf": round(rtf, 3),
            "cpu_before": None if cpu_before is None else round(cpu_before, 3),
            "cpu_after": None if cpu_after is None else round(cpu_after, 3),
            "cer": None if math.isnan(cer_val) else cer_val,
        })
        now = time.time()
        if now - self._last_report >= 5.0:
            pct = self.total / self.total_items * 100.0 if self.total_items else 0.0
            acc = self.correct / self.total if self.total else 0.0
            avg_rtf = float(np.mean(self._rtfs)) if self._rtfs else 0.0
            print(f"[Progress] {self.total}/{self.total_items} ({pct:.1f}%) acc={acc:.3f} avg_rtf={avg_rtf:.3f}")
            self._last_report = now

    def finalize(self, start_all: float, out_dir: Path, model_path: str, asr_type: str) -> Dict[str, Any]:
        acc = self.correct / self.total if self.total else 0.0
        self.metrics = {
            "total_utts": self.total,
            "train_speakers": len(self.models.enrolled),
            "correct": self.correct,
            "unknown": self.unknown,
            "accuracy": round(acc, 3),
            "avg_sid_time": round(float(np.mean(self._sid_times)), 3) if self._sid_times else 0.0,
            "avg_asr_time": round(float(np.mean(self._asr_times)), 3) if self._asr_times else 0.0,
            "avg_total_time": round(float(np.mean(self._total_times)), 3) if self._total_times else 0.0,
            "p95_rtf": round(float(np.percentile(self._rtfs, 95)), 3) if self._rtfs else 0.0,
            "avg_rtf": round(float(np.mean(self._rtfs)), 3) if self._rtfs else 0.0,
            "cer_mean": None if not self._cer_vals else round(float(np.mean(self._cer_vals)), 3),
            "duration_audio_sum_sec": round(float(np.sum(self._durations)), 3),
            "elapsed_wall_sec": round(time.time() - start_all, 3),
            "threshold": self.args.threshold,
            "model": model_path,
            "asr_model_type": asr_type,
            "output_dir": str(out_dir),
        }
        return self.metrics

    def write_outputs(self, out_dir: Path):
        import csv
        import json

        with (out_dir / "predictions.csv").open("w", newline="", encoding="utf-8") as f:
            w = csv.writer(f)
            w.writerow(["wav", "speaker_true", "speaker_pred", "score", "text", "dur_sec",
                        "sid_time", "asr_time", "total_time", "rtf",
                        "cpu_pct_before", "cpu_pct_after", "cer"])
            for row in self.rows_csv:
                w.writerow(row)
        with (out_dir / "detail.jsonl").open("w", encoding="utf-8") as f:
            for rec in self.detail_records:
                f.write(json.dumps(rec, ensure_ascii=False) + "\n")
        with (out_dir / "summary.json").open("w", encoding="utf-8") as f:
            json.dump(self.metrics, f, ensure_ascii=False, indent=2)
        with (out_dir / "summary.txt").open("w", encoding="utf-8") as f:
            f.write("Benchmark Summary\n")
            for k, v in self.metrics.items():
                f.write(f"{k}: {v}\n")
        if self._cpu_after_seq and getattr(self.args, "plot_cpu", False):
            with (out_dir / "cpu_usage.csv").open("w", newline="", encoding="utf-8") as f:
                w = csv.writer(f)
                w.writerow(["index", "cpu_before", "cpu_after"])
                for i, (b, a) in enumerate(zip(self._cpu_before_seq, self._cpu_after_seq)):
                    w.writerow([i, "" if b is None else f"{b:.3f}", "" if a is None else f"{a:.3f}"])
            try:
                import matplotlib

                matplotlib.use("Agg")
                import matplotlib.pyplot as plt

                xs = list(range(len(self._cpu_after_seq)))
                plt.figure(figsize=(10, 3))
                plt.plot(xs, [a if a is not None else float("nan") for a in self._cpu_after_seq],
                         label="cpu_after", linewidth=1.0)
                plt.plot(xs, [b if b is not None else float("nan") for b in self._cpu_before_seq],
                         label="cpu_before", linewidth=0.8, alpha=0.6)
                plt.xlabel("Utterance Index")
                plt.ylabel("CPU Usage" + (" (normalized)" if getattr(self.args, "cpu_normalize", False) else " (%)"))
                plt.title("Per-utterance CPU Usage")
                plt.legend()
                plt.tight_layout()
                plt.savefig(out_dir / "cpu_usage.png", dpi=150)
                plt.close()
            except Exception as e:  # pragma: no cover - plotting is best-effort
                print(f"[plot-cpu] Skip plot (matplotlib not available or error: {e})")
