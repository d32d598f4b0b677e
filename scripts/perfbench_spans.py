#!/usr/bin/env python3
"""A benchmark cell's window with the port's tracer on: where a job's host
time goes, and how the SenseVoice calls ran.

Runs ``perfbench.harness.run`` for one cell with ``--trace 0`` and
``utils.profiling.enable()``, drops the spans of the set-up (warm jobs
included) when the harness reports it warmed up, and prints one JSON object:

- ``jobs``: the window's jobs; ``job_ms``: the medians of a job's wall, of
  each ``pipeline.*`` phase directly beneath it, of the union of its
  ``engine.launch.*`` spans (dispatch) and of its ``engine.wait.*`` spans
  (blocking reads), in ms;
- ``sensevoice``: per stage span that noted the block chain's counters
  (``engine.asr``, ``engine.clean``, ``engine.overlap``): the calls, and the
  sums of ``graph_replays``, ``graph_captures`` and ``eager_blocks``
  (models/block_graphs.py); empty where the checkout notes none;
- ``captures``: the set-up's calls that captured graphs (the span, its
  graphs, its ms: warm pass, captures and the first replay);
- the harness's own result line (``result``: the end-to-end metrics and
  ``correct``).

    python3 scripts/perfbench_spans.py --workload tse3-clean --seed 2718281829
        [--seconds 20] [--root <checkout>]

Needs a CUDA device; run it from the repository root. ``--root`` takes the
port's package and ``perfbench/`` from another checkout (a parent commit
unpacked with ``git archive`` into a directory that .gitignore lists).
"""
from __future__ import annotations

import argparse
import json
import statistics
import sys
import time
from collections import defaultdict
from pathlib import Path

T_START = time.perf_counter()


def union_ns(spans) -> int:
    total, end = 0, None
    for s, e in sorted(spans):
        if end is None or s > end:
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total


def summary(records) -> dict:
    """The spans of a window -> the job medians and the chain counters."""
    jobs = {r.id: r for r in records if r.name == "pipeline.job"}
    phases, dispatch, waits = defaultdict(dict), defaultdict(list), defaultdict(list)
    chains = defaultdict(lambda: {"calls": 0, "graph_replays": 0, "graph_captures": 0,
                                  "eager_blocks": 0})
    for r in records:
        if r.parent in jobs and r.name.startswith("pipeline."):
            key = r.name.split(".", 1)[1]
            phases[r.job][key] = phases[r.job].get(key, 0) + r.end_ns - r.start_ns
        elif r.name.startswith("engine.launch."):
            dispatch[r.job].append((r.start_ns, r.end_ns))
        elif r.name.startswith("engine.wait."):
            waits[r.job].append((r.start_ns, r.end_ns))
        if "graph_replays" in r.attrs:
            c = chains[r.name]
            c["calls"] += 1
            for k in ("graph_replays", "graph_captures", "eager_blocks"):
                c[k] += r.attrs[k]

    def med(values):
        return round(statistics.median(values) * 1e-6, 2) if values else None

    names = sorted({k for p in phases.values() for k in p})
    job_ms = {"job": med([j.end_ns - j.start_ns for j in jobs.values()])}
    job_ms |= {n: med([phases[j].get(n, 0) for j in jobs]) for n in names}
    job_ms["dispatch"] = med([union_ns(dispatch[j]) for j in jobs])
    job_ms["wait"] = med([union_ns(waits[j]) for j in jobs])
    return {"jobs": len(jobs), "job_ms": job_ms, "sensevoice": dict(chains)}


class WindowLog:
    """The harness's phase log: passed on to standard error; the tracer's
    store emptied when set-up ends, so only the window's spans stay, the
    set-up's capturing calls kept aside."""

    def __init__(self, profiling):
        self.profiling = profiling
        self.captures = []

    def write(self, text: str) -> int:
        if "warmed up" in text:
            self.captures = [{"span": r.name, "graphs": r.attrs["graph_captures"],
                              "ms": round((r.end_ns - r.start_ns) * 1e-6, 2)}
                             for r in self.profiling.spans() if r.attrs.get("graph_captures")]
            self.profiling.clear()
        return sys.stderr.write(text)

    def flush(self) -> None:
        sys.stderr.flush()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=20.0)
    ap.add_argument("--root", default=str(Path(__file__).resolve().parents[1]))
    args = ap.parse_args(argv)
    sys.path.insert(0, str(Path(args.root).resolve()))

    import torch

    from audio_classification_tpu_torch.utils import profiling
    from perfbench import harness

    if not torch.cuda.is_available():
        print("perfbench_spans: needs a CUDA device", file=sys.stderr)
        return 3
    torch.set_num_threads(2)  # as perfbench/run.py
    cell = harness.Cell.from_manifest(args.workload, harness.load_manifest())
    profiling.enable()
    log = WindowLog(profiling)
    result = harness.run(cell, args.seed, args.seconds, False, "cuda", T_START, log=log)
    records = profiling.spans()
    profiling.disable()
    out = {"workload": args.workload, "seed": args.seed, "root": args.root,
           "device": torch.cuda.get_device_name(0), **summary(records),
           "captures": log.captures,
           "result": {k: result[k] for k in ("correct", "attempted", "failed", "metrics")}}
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
