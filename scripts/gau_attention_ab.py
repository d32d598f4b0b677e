#!/usr/bin/env python3
"""K4's bfloat16 entry point (gau_attention on bf16 q, k, v) of one
checkout, timed at the shapes chip_smoke.py's ``check_gau_bf16`` checks, so
that two versions of the kernel can be set side by side in one call on one
card.

Imports ``audio_classification_tpu_torch`` from --root (default: this
repository), builds that checkout's kernels into its own build/ directory,
and prints one JSON line per shape: device milliseconds by the replay of a
CUDA graph of --iters launches (``graph_ms``, without the host time of the
Python calls), the error against the bf16 twin run in float64
(``gau_attention_reference(..., acc=torch.float64)``, relative to its
max|out|) and the device operations of one call (``device_ops``, under
torch.profiler). The shapes: the full-preset MossFormer's 8 s bucket
[1, 15999, 128 | 768] with 11999 keys valid, the same at v's 384 columns
(``separate`` at TP 2 in bf16) and a ragged batch of 3 with one item
masked whole; with --plan-shapes also the shapes on both sides of the
plan's choice of one or two consumer warpgroups a block (``gau.bf16_plan``:
[1,4000,128|768], [1,15999,128|192], [1,2000,128|384], [2,1000,64|1000],
[3,333,32|96]). ``--f32``: the float32 entry point instead, at
chip_smoke.py's ``check_gau`` shapes ([1, 15999 | 11999 valid], [1, 31999]
all valid, [3, 1237] ragged with one item masked whole, Dqk 128, De 768),
held to the float32 twin run in float64. ``--registers`` prints each
kernel of gau_attention.cu with its registers and spill bytes (ptxas).
First line: the card's nvidia-smi name and power limit. To
compare a parent commit with the working tree, unpack the parent into a
directory that .gitignore lists and run the two in turns (parent, change,
change, parent):

    git archive <commit> | tar -x -C build/parent
    for r in build/parent . . build/parent; do
        python3 scripts/gau_attention_ab.py --root $r --label $r; done

Needs nvcc (CUDA_HOME or PATH) and a CUDA device.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

# (B, T, Dqk, De, valid keys of each item, graph iterations)
SHAPES = ((1, 15999, 128, 768, [11999], 10), (1, 15999, 128, 384, [11999], 10),
          (3, 1237, 128, 768, [1237, 700, 0], 20))
F32_SHAPES = ((1, 15999, 128, 768, [11999], 10), (1, 31999, 128, 768, [31999], 4),
              (3, 1237, 128, 768, [1237, 700, 0], 20))
PLAN_SHAPES = ((1, 4000, 128, 768, [4000], 20), (1, 15999, 128, 192, [11999], 10),
               (1, 2000, 128, 384, [1500], 20), (2, 1000, 64, 1000, [1000, 517], 20),
               (3, 333, 32, 96, [333, 111, 0], 20))


def device_ops(torch, fn) -> int:
    """The device operations one call of fn queues (under torch.profiler)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(e.device_type == torch.autograd.DeviceType.CUDA for e in prof.events())


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=str(Path(__file__).resolve().parents[1]))
    ap.add_argument("--label", default="")
    ap.add_argument("--plan-shapes", action="store_true")
    ap.add_argument("--f32", action="store_true")
    ap.add_argument("--registers", action="store_true")
    args = ap.parse_args()
    root = Path(args.root).resolve()
    sys.path.insert(0, str(root))
    import torch

    from audio_classification_tpu_torch.ops.kernels import gau
    from chip_smoke import graph_ms
    from tcn_masker_ab import registers

    if not torch.cuda.is_available():
        print("gau_attention_ab: needs a CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    print(smi, flush=True)
    if args.registers:
        for rec in registers(root, "gau_attention.cu"):
            print(json.dumps({"label": args.label, **rec}), flush=True)
    dev = torch.device("cuda")
    dt = torch.float32 if args.f32 else torch.bfloat16
    shapes = F32_SHAPES if args.f32 else SHAPES + (PLAN_SHAPES if args.plan_shapes else ())
    for b, t, dqk, de, lens, iters in shapes:
        gen = torch.Generator(device="cpu").manual_seed(t + de)
        q, k = (torch.randn((b, t, dqk), generator=gen).to(dev).to(dt) for _ in range(2))
        v = torch.randn((b, t, de), generator=gen).to(dev).to(dt)
        mask = torch.arange(t, device=dev)[None, :] < torch.tensor(lens, device=dev)[:, None]
        scale = 1.0 / t
        fn = lambda: gau.gau_attention(q, k, v, mask, scale)  # noqa: E731
        out = fn()
        ref = (gau.gau_attention_reference(q.double(), k.double(), v.double(), mask, scale)
               if args.f32 else
               gau.gau_attention_reference(q, k, v, mask, scale, acc=torch.float64).float())
        n_valid = sum(lens)
        print(json.dumps({"label": args.label,
                          "kernel": "K4 f32" if args.f32 else "K4 bf16",
                          "shape": [b, t, dqk, de],
                          "valid_keys": lens, "graph_ms": graph_ms(torch, fn, iters),
                          "flops": 2.0 * t * n_valid * (dqk + de),
                          "rel_err_vs_float64_twin":
                              (out - ref).abs().max().item() / ref.abs().max().item(),
                          "masked_item_zero": not out[torch.tensor(lens, device=dev) == 0].any(),
                          "device_ops": device_ops(torch, fn), "device": smi}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
