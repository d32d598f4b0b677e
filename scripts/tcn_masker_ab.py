#!/usr/bin/env python3
"""K2 / K2-s8 (the Conv-TasNet masker kernel) of one checkout, timed at the
shapes chip_smoke.py checks, so that two versions of the kernel can be set
side by side in one call on one card.

Imports ``audio_classification_tpu_torch`` from --root (default: this
repository), builds that checkout's kernels into its own build/ directory,
and prints one JSON line per shape and entry point: device milliseconds by
CUDA events (``ms``: the mean over --iters calls after two warm-up calls)
and by CUDA-graph replay (``graph_ms``: the same calls captured in one graph,
so that the wrapper's host time drops out), the call's error against its
twin on valid rows, and the card's nvidia-smi name and power limit. With
``--split``, one more call under torch.profiler gives the device operations
of one call and their device time by kernel name (``split``: name ->
[count, ms]). The stacks are the full preset's masker (seed 0), as in
chip_smoke.py: float32 (``float``, ``int8``) and the bf16 engine's copy
(``bf16``, ``s8_bf16``, held to ``tcn_masker_reference_lowp``); the float
streams are also held to the twin run in float64 (``rel_err_f64``).
``--registers`` prints each kernel of tcn_masker.cu with its registers and
spill bytes (ptxas). To compare
a parent commit with the working tree, unpack the parent into a directory
that .gitignore lists and run the two in turns (parent, change, change,
parent):

    git archive <commit> | tar -x -C build/parent
    for r in build/parent . . build/parent; do
        python3 scripts/tcn_masker_ab.py --root $r --label $r --split; done

Needs a CUDA device.
"""
from __future__ import annotations

import argparse
import copy
import json
import subprocess
import sys
import tempfile
from collections import defaultdict
from pathlib import Path

SR = 16000
STREAMS = ("float", "int8", "bf16", "s8_bf16")


def graph_ms(torch, fn, iters: int) -> float:
    """Mean device ms of fn, its iters calls captured in one CUDA graph and
    replayed once (warm-up calls on a side stream first)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(2):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def split(torch, fn) -> tuple:
    """(device ops, {kernel name: [count, device ms]}) of one call of fn."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    evs = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    by = defaultdict(lambda: [0, 0.0])
    for e in evs:
        key = e.name.removeprefix("void ").replace("(anonymous namespace)::", "")
        by[key][0] += 1
        by[key][1] += (getattr(e, "device_time", None) or getattr(e, "cuda_time", 0.0)) / 1e3
    return len(evs), dict(sorted(by.items()))


def registers(root: Path, source: str) -> list:
    """Registers and spill bytes of every kernel in the checkout's
    csrc/``source`` (the ptxas report of a compile of that file alone, with
    the build's flags): [{kernel, registers, spill_bytes}]."""
    from audio_classification_tpu_torch import _build

    src = root / "audio_classification_tpu_torch" / "csrc" / source
    with tempfile.TemporaryDirectory() as tmp:
        report = subprocess.run(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-Xptxas", "-v", "-c", "-o",
             str(Path(tmp) / "k.o"), str(src)], capture_output=True, text=True, check=True).stderr
    return _build.kernel_resources(report)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=str(Path(__file__).resolve().parents[1]))
    ap.add_argument("--label", default="")
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--streams", default=",".join(STREAMS),
                    help=f"comma-separated subset of {','.join(STREAMS)}")
    ap.add_argument("--split", action="store_true",
                    help="also profile one call: device ops and device ms by kernel")
    ap.add_argument("--registers", action="store_true")
    args = ap.parse_args()
    streams = args.streams.split(",")
    if not set(streams) <= set(STREAMS):
        ap.error(f"--streams takes {STREAMS}")
    sys.path.insert(0, str(Path(args.root).resolve()))
    import torch

    from audio_classification_tpu_torch.engine.runtime import EnginePreset, ModelPack
    from audio_classification_tpu_torch.ops.kernels import tcn

    if not torch.cuda.is_available():
        print("tcn_masker_ab: needs a CUDA device", file=sys.stderr)
        return 2
    if args.registers:
        for rec in registers(Path(args.root).resolve(), "tcn_masker.cu"):
            print(json.dumps({"label": args.label, **rec}), flush=True)
    torch.set_grad_enabled(False)  # inference stacks: detached, no autograd
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    dev = torch.device("cuda")
    model = ModelPack(EnginePreset(), seed=0, device=dev).models["sep3"]
    bf16_blocks = copy.deepcopy(model).to(torch.bfloat16).tcn_blocks()
    stacks = {"float": lambda: tcn.stack_tcn_params(model.tcn_blocks()),
              "int8": lambda: tcn.stack_tcn_params(model.tcn_blocks(), weight_quant=True),
              "bf16": lambda: tcn.stack_tcn_params(bf16_blocks, torch.bfloat16),
              "s8_bf16": lambda: tcn.stack_tcn_params(bf16_blocks, torch.bfloat16,
                                                      weight_quant=True)}
    stacks = {k: stacks[k]() for k in streams}
    f32, f2 = (32 * SR - 32) // 16 + 1, (2 * SR - 32) // 16 + 1
    shapes = (("flagship", 1, f32, [(20 * SR - 32) // 16 + 1]), ("streaming", 1, f2, [f2]),
              ("serving", 8, f2, [f2, f2, 1500, f2, 1000, f2, 750, f2]))
    gen = torch.Generator().manual_seed(0)
    for shape, b, f, lens in shapes:
        x32 = torch.randn((b, f, 128), generator=gen).to(dev)
        f_len = torch.tensor(lens, dtype=torch.int32, device=dev)
        valid = (torch.arange(f, device=dev)[None, :] < f_len[:, None])[..., None]
        for stream, st in stacks.items():
            lowp = stream.endswith("bf16")
            x = x32.to(torch.bfloat16) if lowp else x32

            def run():
                return tcn.fused_tcn_masker(x, f_len, st, n_per_repeat=8)

            out = run()
            run()
            torch.cuda.synchronize()
            ref = (tcn.tcn_masker_reference_lowp if lowp else tcn.tcn_masker_reference)(
                x, f_len, st, n_per_repeat=8).float()
            start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            start.record()
            for _ in range(args.iters):
                run()
            end.record()
            end.synchronize()
            err = (((out.float() - ref).abs() * valid).max().item()
                   / (ref.abs() * valid).max().item())
            rec = {"label": args.label, "shape": shape,
                   "stream": stream, "b_f": [b, f], "f_len": lens,
                   "ms": start.elapsed_time(end) / args.iters,
                   "graph_ms": graph_ms(torch, run, args.iters), "rel_err": err,
                   "device": smi}
            if not lowp:
                deq = tcn.dequant_stack(st) if stream == "int8" else st
                st64 = {k: v.double() for k, v in deq.items()}
                ref64 = tcn.tcn_masker_reference(x.double(), f_len, st64, n_per_repeat=8)
                rec["rel_err_f64"] = (((out.double() - ref64).abs() * valid).max().item()
                                      / (ref64.abs() * valid).max().item())
            if args.split:
                rec["device_ops"], rec["split"] = split(torch, run)
            print(json.dumps(rec), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
