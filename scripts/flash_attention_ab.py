#!/usr/bin/env python3
"""K3 / K5 (flash_attention, flash_attention_stats) of one checkout, timed
at the shapes chip_smoke.py checks, so that two versions of the kernel can
be set side by side in one call on one card.

Imports ``audio_classification_tpu_torch`` from --root (default: this
repository), builds that checkout's kernels into its own build/ directory,
and prints one JSON line per shape: device milliseconds by the replay of a
CUDA graph of --iters calls (``graph_ms``, without the host time of the
Python calls; every device op of a call, the float32 split launch
included) for the kernel and for SDPA on the same inputs, and the error
against the float64 twin. The D = 64 shapes are chip_smoke.py's (OSDNet and
SenseVoice); the D = 80 shapes are Paraformer's (its 32 s bucket, the 200 s
utterance's 256 s bucket and one shard's block of it); then D = 128 and the
wide body (192, 256, and 200 zero-padded to 256), chip_smoke.py's
``check_attention_head_dims`` shapes. With --split each line adds the
device ms of each kernel a call launches (``kernels_ms``, by name, under
torch.profiler) and the device ops of one call. With --registers it also
compiles the checkout's csrc/flash_attention.cu alone with ``-Xptxas -v``
and prints each kernel's template arguments, registers, spill bytes and
whether ptxas serialized its wgmma (C7513 / C7514 notes). ``--define
NAME=VALUE`` (repeatable) builds the checkout's kernels with ``-DNAME=VALUE``.
With --bf16 it times the bfloat16 entry points instead, at the shapes of
chip_smoke.py's ``check_attention_bf16`` (K3 at D = 64, 80, 128 and, zero-
padded, 40 and 200; K5 on a long-form shard's block), with SDPA at bf16 on
the same inputs beside each, the error against the bf16 twin run in float64
(``attention_reference_lowp`` / ``attention_stats_reference_lowp``: max and
mean, relative to max|o| and mean|o|) and the device operations of one call
(``device_ops``, under torch.profiler). First line: the card's
nvidia-smi name and power limit. To compare a parent commit with the
working tree, unpack the parent into a directory that .gitignore lists and
run the two in turns (parent, change, change, parent):

    git archive <commit> | tar -x -C build/parent
    for r in build/parent . . build/parent; do
        python3 scripts/flash_attention_ab.py --root $r --label $r; done
    for r in build/parent . . build/parent; do
        python3 scripts/flash_attention_ab.py --root $r --label $r --bf16; done

Needs nvcc (CUDA_HOME or PATH) and a CUDA device.
"""
from __future__ import annotations

import argparse
import json
import re
import subprocess
import sys
import tempfile
from pathlib import Path

# (kernel, B, H, Tq, Tk, D, valid keys of each item)
SHAPES = (("K3", 8, 8, 537, 537, 64, None), ("K3", 1, 8, 537, 537, 64, None),
          ("K3", 1, 4, 800, 800, 64, None), ("K3", 1, 8, 4271, 4271, 64, [3337]),
          ("K5", 1, 8, 1068, 1068, 64, [1068]), ("K5", 1, 8, 1068, 1068, 64, [133]),
          ("K3", 1, 4, 533, 533, 80, None), ("K3", 1, 4, 4267, 4267, 80, [3333]),
          ("K5", 1, 4, 1067, 1067, 80, [1067]), ("K5", 1, 4, 1067, 1067, 80, [132]),
          ("K3", 2, 4, 200, 200, 128, [200, 77]), ("K3", 1, 4, 800, 800, 192, [800]),
          ("K3", 1, 4, 800, 800, 256, [800]), ("K3", 2, 4, 300, 300, 200, [300, 129]))
# the bf16 entry points at chip_smoke.check_attention_bf16's shapes
BF16_SHAPES = (("K3", 8, 8, 537, 537, 64, [537 - 97 * i % 537 for i in range(8)]),
               ("K3", 1, 8, 537, 537, 64, [537]), ("K3", 1, 4, 800, 800, 64, [800]),
               ("K3", 1, 8, 4271, 4271, 64, [3337]), ("K3", 1, 4, 533, 533, 80, [533]),
               ("K3", 2, 4, 200, 200, 128, [200, 77]), ("K3", 2, 4, 300, 300, 40, [300, 129]),
               ("K3", 2, 4, 300, 300, 200, [300, 129]), ("K5", 1, 8, 1068, 1068, 64, [1068]),
               ("K5", 1, 8, 1068, 1068, 64, [133]), ("K5", 3, 8, 537, 1068, 64, [1068, 300, 33]))


def device_ops(torch, fn) -> int:
    """The device operations one call of fn queues (under torch.profiler)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(e.device_type == torch.autograd.DeviceType.CUDA for e in prof.events())


def run_bf16(torch, attention, graph_ms, args, smi) -> None:
    """One JSON line per shape of BF16_SHAPES: the bf16 entry point's and
    SDPA's device ms at bf16 on the same inputs, the error against the
    float64 twin, the device operations of one call."""
    dev, bf = torch.device("cuda"), torch.bfloat16
    for kind, b, h, tq, tk, d, lens in BF16_SHAPES:
        gen = torch.Generator(device="cpu").manual_seed(tq + d)
        q = torch.randn((b, h, tq, d), generator=gen).to(dev).to(bf)
        k, v = (torch.randn((b, h, tk, d), generator=gen).to(dev).to(bf) for _ in range(2))
        mask = torch.arange(tk, device=dev)[None, :] < torch.tensor(lens, device=dev)[:, None]
        if kind == "K3":
            fn = lambda: attention.flash_attention(q, k, v, mask)  # noqa: E731
            got = fn()
            ref = attention.attention_reference_lowp(q, k, v, mask, acc=torch.float64)
        else:
            fn = lambda: attention.flash_attention_stats(q, k, v, mask)  # noqa: E731
            got = fn()[0]
            ref = attention.attention_stats_reference_lowp(q, k, v, mask, acc=torch.float64)[0]
        err = (got - ref.float()).abs()
        ref = ref.float().abs()
        sdpa = lambda: torch.nn.functional.scaled_dot_product_attention(  # noqa: E731
            q, k, v, attn_mask=mask[:, None, None, :])
        ms, sdpa_ms = graph_ms(torch, fn, args.iters), graph_ms(torch, sdpa, args.iters)
        print(json.dumps({"label": args.label, "kernel": kind + " bf16", "shape": [b, h, tq, d],
                          "keys": tk, "valid_keys": lens, "graph_ms": ms,
                          "sdpa_bf16_graph_ms": sdpa_ms, "ms_over_sdpa": ms / sdpa_ms,
                          "rel_err_vs_float64_twin": err.max().item() / ref.max().item(),
                          "mean_rel_err_vs_float64_twin": err.mean().item() / ref.mean().item(),
                          "device_ops": device_ops(torch, fn), "device": smi}), flush=True)


def registers(root: Path) -> list:
    """Template arguments, registers, spill bytes and wgmma serialization of
    every kernel in the checkout's flash_attention.cu (ptxas report of a
    compile of that file alone, with the build's flags)."""
    from audio_classification_tpu_torch import _build

    src = root / "audio_classification_tpu_torch" / "csrc" / "flash_attention.cu"
    with tempfile.TemporaryDirectory() as tmp:
        report = subprocess.run(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-Xptxas", "-v", "-c", "-o",
             str(Path(tmp) / "k.o"), str(src)], capture_output=True, text=True, check=True).stderr
    serialized = set(re.findall(r"serialized.*?function '(\S+)'", report))
    out, name, spill = [], None, None
    for line in report.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            name, spill = m.group(1), None
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m and name:
            spill = int(m.group(1)) + int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            out.append({"instance": name, "namespace": "t32" if "3t32" in name else
                        "b16" if "3b16" in name else "",
                        "template_args": [int(x) for x in re.findall(r"L[ib](\d+)E", name)],
                        "registers": int(m.group(1)), "spill_bytes": spill,
                        "serialized": name in serialized})
            name = None
    return out


def kernels_ms(torch, fn, iters: int = 10) -> dict:
    """Device ms per call of each kernel fn launches, by name (torch.profiler
    over iters calls after a warm one)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = getattr(e, "self_cuda_time_total", 0.0)
        if us:
            out[e.key[:60]] = us / 1e3 / iters
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=str(Path(__file__).resolve().parents[1]))
    ap.add_argument("--label", default="")
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--registers", action="store_true")
    ap.add_argument("--define", action="append", default=[])
    ap.add_argument("--bf16", action="store_true")
    ap.add_argument("--split", action="store_true")
    args = ap.parse_args()
    root = Path(args.root).resolve()
    sys.path.insert(0, str(root))
    import torch

    from audio_classification_tpu_torch import _build
    from audio_classification_tpu_torch.ops.kernels import attention
    from chip_smoke import graph_ms

    if not torch.cuda.is_available():
        print("flash_attention_ab: needs a CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    print(smi, flush=True)
    _build.NVCC_FLAGS = (*_build.NVCC_FLAGS, *(f"-D{d}" for d in args.define))
    if args.registers:
        for rec in registers(root):
            print(json.dumps({"label": args.label, **rec}), flush=True)
    if args.bf16:
        run_bf16(torch, attention, graph_ms, args, smi)
        return 0
    dev = torch.device("cuda")
    takes_80 = hasattr(attention, "padded_head_dim")
    for kind, b, h, tq, tk, d, valid in SHAPES:
        if d != 64 and not takes_80:
            print(json.dumps({"label": args.label, "kernel": kind, "shape": [b, h, tq, d],
                              "skipped": "this checkout's kernel takes D = 64 only"}), flush=True)
            continue
        gen = torch.Generator(device="cpu").manual_seed(tq + d)
        q = torch.randn((b, h, tq, d), generator=gen).to(dev)
        k, v = (torch.randn((b, h, tk, d), generator=gen).to(dev) for _ in range(2))
        lens = torch.tensor(valid or [tk - 97 * i % tk for i in range(b)], device=dev)
        mask = torch.arange(tk, device=dev)[None, :] < lens[:, None]
        if kind == "K3":
            fn = lambda: attention.flash_attention(q, k, v, mask)  # noqa: E731
            out = fn()
            ref = attention.attention_reference(q.double(), k.double(), v.double(), mask)
            err = ((out - ref.float()).abs() * mask[:, None, :, None]).max().item()
        else:
            fn = lambda: attention.flash_attention_stats(q, k, v, mask)  # noqa: E731
            o = fn()[0]
            ro = attention.attention_stats_reference(q.double(), k.double(), v.double(), mask)[0]
            err = ((o - ro.float()).abs().max() / ro.abs().max()).item()
        sdpa = lambda: torch.nn.functional.scaled_dot_product_attention(  # noqa: E731
            q, k, v, attn_mask=mask[:, None, None, :])
        rec = {"label": args.label, "defines": args.define, "kernel": kind,
               "shape": [b, h, tq, d], "keys": tk, "valid_keys": int(mask.sum()),
               "graph_ms": graph_ms(torch, fn, args.iters),
               "sdpa_graph_ms": graph_ms(torch, sdpa, args.iters),
               "err_vs_float64": err, "device": smi}
        if args.split:
            rec.update(kernels_ms=kernels_ms(torch, fn), device_ops=device_ops(torch, fn))
        print(json.dumps(rec), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
