"""Batch aggregator over timestamped run dirs (port of
audio_classification_tpu/cli/batch_eval.py).

Re-implements the reference aggregator (reference: batch_eval.py:12-253):
scans --results-dir for subdirectories containing metrics.json, aggregates
the same 18 metric series with mean/median/std/min/max/count, writes
batch_analysis.json + a human report .txt with the same sections
(speed / accuracy / separation quality / resources / time breakdown).
"""
from __future__ import annotations

import argparse
import json
from pathlib import Path
from typing import Any, Dict, List

from ..metrics import agg_stats_full

# metrics.json field -> series name (reference: batch_eval.py:17-103)
_SERIES = [
    ("rtf_total", "rtf_total"),
    ("rtf_asr", "rtf_asr"),
    ("time_compute_total_sec", "time_total"),
    ("time_osd_sec", "time_osd"),
    ("time_sep_sec", "time_sep"),
    ("time_asr_sec", "time_asr"),
    ("target_hit_rate_segments", "target_hit_rate"),
    ("segments_matched", "segments_matched"),
    ("segments_total", "segments_total"),
    ("sep_sisdr_mean", "sisdr"),
    ("sep_sisdri_mean", "sisdri"),
    ("sep_eval_segments", "sep_eval_segments"),
    ("cpu_avg", "cpu_avg"),
    ("cpu_peak", "cpu_peak"),
    ("rss_avg_mb", "memory_avg"),
    ("rss_peak_mb", "memory_peak"),
    ("total_audio_sec", "audio_duration"),
]


def analyze_batch_results(result_dirs: List[Path]) -> Dict[str, Any]:
    stats: Dict[str, List[float]] = {name: [] for _, name in _SERIES}
    stats["overlap_ratio"] = []
    valid = 0
    for d in result_dirs:
        mf = d / "metrics.json"
        if not mf.exists():
            continue
        try:
            metrics = json.loads(mf.read_text(encoding="utf-8"))
            for src, name in _SERIES:
                v = metrics.get(src)
                if v:  # reference uses truthiness (drops zeros), keep parity
                    stats[name].append(v)
            if metrics.get("total_audio_sec") and metrics.get("audio_overlap_sec"):
                stats["overlap_ratio"].append(
                    metrics["audio_overlap_sec"] / metrics["total_audio_sec"]
                )
            valid += 1
        except (json.JSONDecodeError, OSError) as e:
            print(f"Error processing {d}: {e}")
            continue
    return {
        "total_results": valid,
        "metrics": {k: agg_stats_full(v) for k, v in stats.items()},
    }


def generate_report(summary: Dict[str, Any]) -> str:
    r: List[str] = []
    r.append("=" * 60)
    r.append("语音分离识别系统批量测试报告")
    r.append("=" * 60)
    r.append(f"总测试结果数: {summary['total_results']}")
    r.append("")
    m = summary["metrics"]

    r.append("处理速度指标:")
    if m["rtf_total"]["count"] > 0:
        rtf = m["rtf_total"]
        r.append(f"  • 实时因子 (RTF): {rtf['mean']:.4f} ± {rtf['std']:.4f}")
        r.append(f"    (范围: {rtf['min']:.4f} - {rtf['max']:.4f})")
        r.append(f"    处理1秒音频需 {rtf['mean']:.2f} 秒")

    r.append("")
    r.append("准确率指标(?):")
    if m["target_hit_rate"]["count"] > 0:
        h = m["target_hit_rate"]
        r.append(f"  • target_hit_rate_segments: {h['mean']:.1%} ± {h['std']:.1%}")

    r.append("")
    r.append("分离质量指标:")
    if m["sisdr"]["count"] > 0:
        s, si = m["sisdr"], m["sisdri"]
        r.append(f"  • SI-SDR: {s['mean']:.2f} ± {s['std']:.2f} dB")
        r.append(f"  • SI-SDRi: {si['mean']:.2f} ± {si['std']:.2f} dB")

    r.append("")
    r.append("资源使用:")
    if m["cpu_avg"]["count"] > 0:
        cpu, mem = m["cpu_avg"], m["memory_avg"]
        r.append(f"  • CPU使用率: {cpu['mean']:.1f}% ± {cpu['std']:.1f}%")
        r.append(f"  • 内存使用: {mem['mean']:.1f} MB ± {mem['std']:.1f} MB")

    r.append("")
    r.append("时间分解 (秒):")
    if m["time_total"]["count"] > 0:
        total = m["time_total"]["mean"]
        osd = m["time_osd"]["mean"] or 0
        sep = m["time_sep"]["mean"] or 0
        asr = m["time_asr"]["mean"] or 0
        r.append(f"  • 重叠检测: {osd:.3f}s ({osd/total*100:.1f}%)")
        r.append(f"  • 语音分离: {sep:.3f}s ({sep/total*100:.1f}%)")
        r.append(f"  • 语音识别: {asr:.3f}s ({asr/total*100:.1f}%)")
        r.append(f"  • 其他: {total-osd-sep-asr:.3f}s ({(total-osd-sep-asr)/total*100:.1f}%)")

    r.append("")
    r.append("=" * 60)
    return "\n".join(r)


def main(argv=None):
    p = argparse.ArgumentParser(description="批量分析语音分离识别结果")
    p.add_argument("--results-dir", required=True, help="包含多个测试结果的目录")
    p.add_argument("--output", default="batch_analysis.json", help="输出文件路径")
    args = p.parse_args(argv)

    base = Path(args.results_dir)
    result_dirs = [d for d in base.iterdir() if d.is_dir() and (d / "metrics.json").exists()]
    if not result_dirs:
        print(f"在 {base} 中未找到有效的结果目录")
        return
    print(f"找到 {len(result_dirs)} 个结果目录")

    summary = analyze_batch_results(result_dirs)
    with open(args.output, "w", encoding="utf-8") as f:
        json.dump(summary, f, ensure_ascii=False, indent=2)
    report = generate_report(summary)
    print(report)
    report_file = Path(args.output).with_suffix(".txt")
    report_file.write_text(report, encoding="utf-8")
    print(f"\n详细统计已保存到: {args.output}")
    print(f"报告文本已保存到: {report_file}")


if __name__ == "__main__":
    main()
