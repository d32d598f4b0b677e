#!/usr/bin/env python3
"""K2 / K2-s8 (the Conv-TasNet masker kernel) of one checkout, timed at the
shapes chip_smoke.py checks, so that two versions of the kernel can be set
side by side in one call on one card.

Imports ``audio_classification_tpu_torch`` from --root (default: this
repository), builds that checkout's kernels into its own build/ directory,
and prints one JSON line per shape and weight stream: device milliseconds
by CUDA events (the mean over --iters launches after two warm-up launches),
the launch's error against the twin on valid rows, and the card's
nvidia-smi name and power limit. The stacks are the full preset's masker
(seed 0), as in chip_smoke.py. To compare a parent commit with the working
tree, unpack the parent into a directory that .gitignore lists and run the
two in turns (parent, change, change, parent):

    git archive <commit> | tar -x -C build/parent
    for r in build/parent . . build/parent; do
        python3 scripts/tcn_masker_ab.py --root $r --label $r; done

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
    ap.add_argument("--iters", type=int, default=10)
    args = ap.parse_args()
    sys.path.insert(0, str(Path(args.root).resolve()))
    import torch

    from audio_classification_tpu_torch.engine.runtime import EnginePreset, ModelPack
    from audio_classification_tpu_torch.ops.kernels import tcn

    if not torch.cuda.is_available():
        print("tcn_masker_ab: needs a CUDA device", file=sys.stderr)
        return 2
    torch.set_grad_enabled(False)  # inference stacks: detached, no autograd
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    dev = torch.device("cuda")
    blocks = ModelPack(EnginePreset(), seed=0, device=dev).models["sep3"].tcn_blocks()
    stacks = {"float": tcn.stack_tcn_params(blocks),
              "int8": tcn.stack_tcn_params(blocks, weight_quant=True)}
    f32, f2 = (32 * SR - 32) // 16 + 1, (2 * SR - 32) // 16 + 1
    shapes = (("flagship", 1, f32, [(20 * SR - 32) // 16 + 1]), ("streaming", 1, f2, [f2]),
              ("serving", 8, f2, [f2, f2, 1500, f2, 1000, f2, 750, f2]))
    gen = torch.Generator().manual_seed(0)
    for shape, b, f, lens in shapes:
        x = torch.randn((b, f, 128), generator=gen).to(dev)
        f_len = torch.tensor(lens, dtype=torch.int32, device=dev)
        valid = (torch.arange(f, device=dev)[None, :] < f_len[:, None])[..., None]
        for stream, st in stacks.items():
            def run():
                return tcn.fused_tcn_masker(x, f_len, st, n_per_repeat=8)

            out = run()
            run()
            torch.cuda.synchronize()
            ref = tcn.tcn_masker_reference(x, f_len, st, n_per_repeat=8)
            start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            start.record()
            for _ in range(args.iters):
                run()
            end.record()
            end.synchronize()
            err = ((out - ref).abs() * valid).max().item() / (ref.abs() * valid).max().item()
            print(json.dumps({"label": args.label, "shape": shape, "stream": stream,
                              "b_f": [b, f], "f_len": lens,
                              "ms": start.elapsed_time(end) / args.iters, "rel_err": err,
                              "device": smi}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
