#!/usr/bin/env python3
"""Where one pipeline scene of the PyTorch port spends its time on the GPU.

Builds ONE full-preset engine (seeded random weights), runs the flagship
file-mode pipeline warm a few times for the wall clock, then once more under
torch.profiler, and prints one JSON object per scene: warm walls, rtf_total,
device busy time (union of kernel intervals), idle share, device time by
kernel name, peak device memory. Scenes:

  overlap    20 s three-talker mixture, every segment forced to overlap,
             Conv-TasNet-3 (32 s bucket)
  clean      the same mixture, every segment forced clean
  mossformer 6 s two-talker mixture, forced overlap, --sep-backend mossformer
             (8 s bucket, K4 at T = 15999 in 8 layers)

    python3 scripts/profile_torch_scene.py [--scenes overlap,clean,mossformer] [--warm 3]
        [--out build/profile_torch_scene.json]

Needs a CUDA device; run it from the repository root. The whole report also
goes to the --out file.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))


def busy_ms(intervals) -> float:
    """Length of the union of [start, end) intervals, in ms (inputs in us)."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total / 1e3


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--scenes", default="overlap,clean,mossformer")
    ap.add_argument("--warm", type=int, default=3)
    ap.add_argument("--out", default=str(ROOT / "build" / "profile_torch_scene.json"))
    args = ap.parse_args()
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print("profile_torch_scene: no CUDA device", file=sys.stderr)
        return 2
    from chip_smoke import SR, talkers

    from audio_classification_tpu_torch.audio_io import write_wav
    from audio_classification_tpu_torch.pipelines.offline_overlap3 import (
        Overlap3Pipeline,
        build_engine,
    )
    from audio_classification_tpu_torch.utils.config import Overlap3Config

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi, flush=True)
    work = ROOT / "build" / "profile_scene"
    work.mkdir(parents=True, exist_ok=True)
    mix3 = sum(talkers(20 * SR, 3)) / 3.0
    write_wav(work / "mix.wav", 0.6 * mix3 / np.abs(mix3).max(), SR)
    two = talkers(6 * SR, 5)[:2]
    write_wav(work / "mix2.wav", 0.6 * (two[0] + two[1]) / np.abs(two[0] + two[1]).max(), SR)
    target = talkers(6 * SR, 4)[0]
    write_wav(work / "target.wav", 0.6 * target / np.abs(target).max(), SR)

    base = dict(target_wav=str(work / "target.wav"), preset="full", seed=0, sv_threshold=-1.0)
    scenes = {
        "overlap": dict(input_wavs=[str(work / "mix.wav")], osd_thr=0.0),
        "clean": dict(input_wavs=[str(work / "mix.wav")], osd_thr=1.0),
        "mossformer": dict(input_wavs=[str(work / "mix2.wav")], osd_thr=0.0,
                           sep_backend="mossformer"),
    }
    engine = build_engine(Overlap3Config(**base))
    report = {"device": smi, "scenes": {}}
    for name in args.scenes.split(","):
        cfg = Overlap3Config(**base, **scenes[name])

        def run():
            res = Overlap3Pipeline(cfg, engine=engine).run()
            torch.cuda.synchronize()
            return res

        run()  # first call: builds kernels, cuDNN plans, cached constants
        walls, rtfs = [], []
        for _ in range(args.warm):
            t0 = time.perf_counter()
            res = run()
            walls.append((time.perf_counter() - t0) * 1e3)
            rtfs.append(res.metrics["rtf_total"])
        torch.cuda.reset_peak_memory_stats()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            run()
            traced_wall = (time.perf_counter() - t0) * 1e3
        by_name, intervals = {}, []
        for ev in prof.events():
            if ev.device_type == torch.autograd.DeviceType.CUDA:
                dur = ev.time_range.end - ev.time_range.start
                by_name[ev.name] = by_name.get(ev.name, [0, 0.0])
                by_name[ev.name][0] += 1
                by_name[ev.name][1] += dur / 1e3
                intervals.append((ev.time_range.start, ev.time_range.end))
        busy = busy_ms(intervals)
        span = (max(e for _, e in intervals) - min(s for s, _ in intervals)) / 1e3
        top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:14]
        report["scenes"][name] = {
            "warm_wall_ms": walls, "rtf_total": rtfs, "traced_wall_ms": traced_wall,
            "device_busy_ms": busy, "device_span_ms": span,
            "idle_share_of_wall": 1.0 - busy / traced_wall, "device_ops": len(intervals),
            "peak_device_mem_mb": torch.cuda.max_memory_allocated() / 2**20,
            "top_kernels_ms": [{"name": k[:90], "calls": v[0], "ms": v[1]} for k, v in top],
        }
        print(json.dumps({name: report["scenes"][name]}), flush=True)
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(report, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
