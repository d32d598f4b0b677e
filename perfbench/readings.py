#!/usr/bin/env python3
"""The readings a cell's comparison limits are set from, on the card:

- the program's numbers on each of ``--seeds`` (the lower readings): for
  each seed, the cell's compared jobs run through the pipeline at the cell's
  own sizes and are compared with the plain reference, as a run compares
  them;
- the control's numbers on each of ``--control-seeds`` (the upper
  readings): the reference computed one precision below float32 (every
  product's operands rounded to TF32) in the program's place, compared with
  the float32 reference in the same way.

    python3 perfbench/readings.py --workload <cell> --seeds 1,2,... \\
        --control-seeds 1,2,3 [--out readings.jsonl] [--fixture trace.json.gz]

One line of JSON a seed. The benchmark's runs do not run this. ``--fixture``
writes a trimmed torch.profiler trace of one traced job (the metric readers'
test fixture).
"""
import argparse
import gzip
import json
import sys
import tempfile
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--out", default="")
    ap.add_argument("--fixture", default="")
    args = ap.parse_args(argv)

    import torch

    from perfbench import check, harness, traffic
    from perfbench.reference.pipeline import Reference

    cell = harness.Cell.from_manifest(args.workload, harness.load_manifest())
    cfg, wl = cell.config, cell.workload
    device = torch.device("cuda")
    seeds = [int(s) for s in args.seeds.split(",") if s]
    control = {int(s) for s in args.control_seeds.split(",") if s}
    out = open(args.out, "a") if args.out else None
    workdir = tempfile.mkdtemp(prefix="perfbench_readings_")
    engine = symbols = None
    from audio_classification_tpu_torch.pipelines.offline_overlap3 import Overlap3Pipeline

    for seed in seeds + sorted(control - set(seeds)):
        t0 = time.perf_counter()
        jobs = traffic.make_jobs(wl, seed, device)
        traffic.write(jobs, f"{workdir}/{seed}")
        if engine is None:
            engine, symbols = harness.build_engine(cfg, wl, seed, device, workdir, cell.asr)
        else:  # a new PyanNet module too: hooked again below
            capture.remove()
            harness.load_seed(engine.pack, cfg, wl, seed, device, workdir, cell.asr)
        capture = harness.Capture(engine, harness.sep_stage(cfg), cell.asr)
        ref = harness.reference_for(cfg, wl, seed, device, symbols, cell.asr)
        line = {"seed": seed}
        if seed in seeds:
            per_job = []
            for i in harness.check_jobs(wl, jobs, seed):
                job = jobs[i]
                capture.on = True
                res = Overlap3Pipeline(harness.pipeline_config(cfg, job, device),
                                       engine=engine).run()
                capture.on = False
                side = harness.program_outputs(capture.take(), res.segments, cell.asr)
                follow = ([r["stream"] for r in side["records"]] if wl["kind"] == "overlap"
                          else None)
                r = ref.run_job(job.mixtures, job.target, wl["kind"], follow, side["asr"])
                per_job.append(check.compare_job(side, r, len(job.mixtures)))
                per_job[-1]["records_ok"] = float(harness.records_ok(res.segments, job,
                                                                     wl["kind"]))
            line["program"] = {k: max(j[k] for j in per_job) for k in per_job[0]}
            line["records_ok"] = min(j["records_ok"] for j in per_job)
        if seed in control:
            ctl = Reference(cfg, ref.w, ref.pn, symbols, device, cell.asr, tf32=True)
            per_job = []
            for i in harness.check_jobs(wl, jobs, seed):
                job = jobs[i]
                side = ctl.run_job(job.mixtures, job.target, wl["kind"])
                follow = ([r["stream"] for r in side["records"]] if wl["kind"] == "overlap"
                          else None)
                r = ref.run_job(job.mixtures, job.target, wl["kind"], follow, side["asr"])
                per_job.append(check.compare_job(side, r, len(job.mixtures)))
            line["control"] = check.worst(per_job)
        line["seconds"] = time.perf_counter() - t0
        print(json.dumps(line), flush=True)
        if out:
            out.write(json.dumps(line) + "\n")
            out.flush()
        del ref
    if args.fixture:
        write_fixture(args.fixture, cell, engine, jobs, device)
    return 0


def write_fixture(path: str, cell, engine, jobs, device) -> None:
    """A traced run of one job, trimmed to what the readers read: the
    trace's device operations and ranges, and the reader's context (with
    the seconds of the same job run before without the profiler)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from audio_classification_tpu_torch.pipelines.offline_overlap3 import Overlap3Pipeline
    from perfbench import harness, work
    from perfbench.trace import Trace

    cfg, wl = cell.config, cell.workload

    def job():
        Overlap3Pipeline(harness.pipeline_config(cfg, jobs[0], device), engine=engine).run()
        torch.cuda.synchronize(device)

    job()
    t0 = time.perf_counter()
    job()
    untraced_s = time.perf_counter() - t0
    kr = harness.KernelRanges()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        with torch.profiler.record_function("perfbench.window"):
            job()
        window_s = time.perf_counter() - t0
    kr.restore()
    trace = Trace.from_profile(prof)
    trace.ops = [(name[:80], s, e) for name, s, e in trace.ops]
    fixture = {"cell": cell.name, "trace": trace.to_dict(), "jobs": 1, "window_s": window_s,
               "untraced_s": untraced_s, "calls": kr.work(),
               "flops": work.job_flops([len(m) for m in jobs[0].mixtures], len(jobs[0].target),
                                       cfg, wl["kind"], cell.asr),
               "kind": torch.cuda.get_device_name(device)}
    with gzip.open(path, "wt", encoding="utf-8") as f:
        json.dump(fixture, f)


if __name__ == "__main__":
    sys.exit(main())
