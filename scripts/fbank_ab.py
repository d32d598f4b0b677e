#!/usr/bin/env python3
"""K1 (fbank_power_mel, the log-mel kernel) of one checkout, timed at the
shapes chip_smoke.py checks, so that two versions of the kernel can be set
side by side in one call on one card.

Imports ``audio_classification_tpu_torch`` from --root (default: this
repository), builds that checkout's kernels into its own build/ directory,
and prints one JSON line per shape: device milliseconds by CUDA events over
--iters launches after two warm-up launches (``ms``) and by the replay of a
CUDA graph of as many launches (``graph_ms``: without the host time of the
Python calls, which exceeds a small shape's kernel), the device ops of one
call (torch.profiler), the error against the float32 twin, and the card's
nvidia-smi name and power limit. The frames are chip_smoke.py's: 8 x 32 s of
synthetic talkers (25584 frames), 2 s windows of them (a serving tick's 8
and 24, a streaming block's 1 and 3), and the 64 ms, 128-bin config on the
8 x 32 s. To compare a parent commit with the working tree, unpack the
parent into a directory that .gitignore lists and run the two in turns
(parent, change, change, parent):

    git archive <commit> | tar -x -C build/parent
    for r in build/parent . . build/parent; do
        python3 scripts/fbank_ab.py --root $r --label $r; done

Needs a CUDA device.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

SR = 16000


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=str(Path(__file__).resolve().parents[1]))
    ap.add_argument("--label", default="")
    ap.add_argument("--iters", type=int, default=20)
    args = ap.parse_args()
    sys.path.insert(0, str(Path(args.root).resolve()))
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from audio_classification_tpu_torch.ops import fbank
    from audio_classification_tpu_torch.ops.kernels import fbank as k_fbank
    from chip_smoke import graph_ms, talkers

    if not torch.cuda.is_available():
        print("fbank_ab: needs a CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    dev = torch.device("cuda")
    mix = sum(talkers(32 * SR, 1)) * 0.2
    wav = torch.from_numpy(np.stack([np.roll(mix, 997 * i) for i in range(8)])).to(dev)
    cfg, cfg64 = fbank.FbankConfig(), fbank.FbankConfig(frame_length_ms=64.0, num_bins=128)
    cases = [("main", cfg, wav)]
    for name, windows in (("serving_osd", 8), ("serving_streams", 24), ("streaming", 1),
                          ("streaming_streams", 3)):
        cases.append((name, cfg, wav[:, :2 * SR].repeat(windows // 8 + 1, 1)[:windows]))
    cases.append(("n_fft_1024", cfg64, wav))
    for name, c, w in cases:
        frames = fbank.windowed_frames(w, c).reshape(-1, c.n_fft).contiguous()
        bases = fbank.fbank_bases(c, frames.device)
        # the wrapper took the twin's three bases before the kernel's tables
        consts = tuple(bases) if isinstance(bases, tuple) else (bases,)

        def run():
            return k_fbank.fbank_power_mel(frames, *consts, c.log_floor)

        out = run()
        run()
        torch.cuda.synchronize()
        twin = consts if isinstance(bases, tuple) else (bases.cos_b, bases.msin_b, bases.mel_w)
        ref = k_fbank.fbank_power_mel_reference(frames, *twin, c.log_floor)
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        for _ in range(args.iters):
            run()
        end.record()
        end.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            run()
            torch.cuda.synchronize()
        ops = sum(ev.device_type == torch.autograd.DeviceType.CUDA for ev in prof.events())
        print(json.dumps({"label": args.label, "case": name, "shape": list(frames.shape),
                          "ms": start.elapsed_time(end) / args.iters,
                          "graph_ms": graph_ms(torch, run, args.iters), "device_ops": ops,
                          "max_abs_err": (out - ref).abs().max().item(), "device": smi}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
