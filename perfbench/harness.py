"""One run of one cell: set up, warm up, measure, check, report.

Everything about a cell comes from files that ``BENCHMARK.json`` names: the
cell's configuration (``configs/<config>.json``), its recognizer family
(``asr/<family>.py``, by the configuration's ``asr_family``), its traffic
(``workloads/<traffic>.json``), its comparison limits (``limits/<cell>.json``)
and one reader a per-layer metric (``metrics/<metric>.py``).

The window drives ``Overlap3Pipeline(cfg, engine=...).run()`` in file mode in
a closed loop with one client: job after job, cycling through the workload's
pool, until ``--seconds`` have passed. Set-up builds the engine through the
port's normal path (``ModelPack`` + ``StageEngine``, PyanNet through the
port's pyannote importer), loads the benchmark's weights, writes the jobs'
wavs to ``TMPDIR`` and runs the workload's warm jobs, which use every shape
the window uses.

Forward hooks on the stage models (on the recognizer, its family's) keep
(without a copy or a wait) what the sampled jobs' stage calls returned; once
the window has closed the program is freed and the plain reference runs those
jobs again from the benchmark's own samples and weights (``reference/``), and
``check`` compares.
"""
from __future__ import annotations

import dataclasses
import gc
import importlib.util
import json
import math
import os
import shutil
import sys
import tempfile
import time
import traceback
from pathlib import Path
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from . import check, traffic, weights, work
from .reference.pipeline import Reference
from .trace import View, Trace

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "audio_classification_tpu")


def sep_stage(cfg: dict) -> str:
    """The pack's stage of the configuration's separator."""
    return "mossformer" if cfg["sep_backend"] == "mossformer" else "sep3"


def used_stages(cfg: dict, wl: dict) -> List[str]:
    """The stages whose weights a cell's jobs use (OSD is PyanNet's)."""
    return ([sep_stage(cfg)] if wl["kind"] == "overlap" else []) + ["spk", "asr"]


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name (before the first dot) is one
    the port's runs must not load."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def load_manifest(root: Path = ROOT) -> dict:
    with open(root / "BENCHMARK.json", encoding="utf-8") as f:
        return json.load(f)


def load_config(name: str, root: Path = HERE) -> dict:
    with open(root / "configs" / f"{name}.json", encoding="utf-8") as f:
        return json.load(f)


def _module(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_reader(metric: str, root: Path = HERE):
    return _module(root / "metrics" / f"{metric}.py", "perfbench_metric_" + metric).read


def family_name(cfg: dict) -> str:
    """The configuration's recognizer family: its ``asr_family``, SenseVoice
    where it has none."""
    return cfg.get("asr_family", "sensevoice")


def load_family(name: str, root: Path = HERE):
    """The recognizer family ``name``: the module ``asr/<name>.py`` under
    ``root`` (what it holds: ``asr/sensevoice.py``'s docstring)."""
    path = root / "asr" / f"{name}.py"
    if not path.is_file():
        raise SystemExit(f"no recognizer family {name!r}: {path} does not exist")
    return _module(path, "perfbench_asr_" + name)


@dataclasses.dataclass
class Cell:
    name: str
    config: dict
    workload: dict
    limits: Dict[str, float]
    end_to_end: List[dict]
    per_layer: List[dict]
    root: Path = HERE
    asr: Any = dataclasses.field(init=False)  # the recognizer family's module

    def __post_init__(self):
        self.asr = load_family(family_name(self.config), self.root)

    @classmethod
    def from_manifest(cls, name: str, manifest: dict, root: Path = HERE) -> "Cell":
        entry = next((w for w in manifest["workloads"] if w["name"] == name), None)
        if entry is None:
            raise SystemExit(f"no workload {name!r} in BENCHMARK.json")

        def mine(m):
            return "workloads" not in m or name in m["workloads"]

        return cls(name, load_config(entry["config"], root),
                   traffic.load_workload(entry["traffic"], root), check.load_limits(name, root),
                   [m for m in manifest["end_to_end"] if mine(m)],
                   [m for m in manifest["per_layer"] if mine(m)], root)


# ------------------------------------------------------------ the program
def build_engine(cfg: dict, wl: dict, seed: int, device, workdir: str, asr):
    """The port's engine at the configuration's widths, its recognizer of
    the family ``asr``, with the benchmark's weights loaded through the
    normal path."""
    from audio_classification_tpu_torch.engine import BucketSpec, ModelPack, StageEngine
    from audio_classification_tpu_torch.engine.bucketing import default_buckets
    from audio_classification_tpu_torch.engine.runtime import EnginePreset

    base = EnginePreset()
    fields = {}
    for stage, values in cfg["preset"].items():
        cur = getattr(base, stage)
        vals = {k: (tuple(v) if isinstance(v, list) else v) for k, v in values.items()}
        fields[stage] = dataclasses.replace(cur, **vals)
    preset = dataclasses.replace(base, **fields)
    symbols = asr.token_symbols(cfg["preset"][asr.PRESET])
    pack = ModelPack(preset, seed=0, tokens=asr.token_table(symbols), device=device,
                     asr_family=asr.PACK_FAMILY)
    load_seed(pack, cfg, wl, seed, device, workdir, asr)
    buckets = BucketSpec(lengths=default_buckets(traffic.SR, 0.5, 64.0), max_batch=8)
    return StageEngine(pack, buckets, compute_dtype=cfg["dtype"]), symbols


def seed_weights(cfg: dict, wl: dict, seed: int, device, asr) -> Dict[str, dict]:
    """The state dicts of the stages a cell's jobs use, for ``seed``; the
    recognizer's at its family's preset field and spec."""
    p = cfg["preset"]
    return {s: (weights.stage_weights(s, p[asr.PRESET], seed, device, asr.spec) if s == "asr"
                else weights.stage_weights(s, p[s], seed, device))
            for s in used_stages(cfg, wl)}


def load_seed(pack, cfg: dict, wl: dict, seed: int, device, workdir: str, asr) -> None:
    """The benchmark's weights for ``seed`` into the pack: the used stages'
    state dicts, and PyanNet from a pyannote checkpoint written to
    ``workdir`` and read by the port's importer."""
    from audio_classification_tpu_torch.convert.torch_import import load_pyannet_torch
    from audio_classification_tpu_torch.models.pyannet import BinarizeConfig

    pack.load_state_dicts(seed_weights(cfg, wl, seed, device, asr))
    ckpt = os.path.join(workdir, "segmentation.ckpt")
    weights.write_pyannote_checkpoint(ckpt, cfg["pyannet"], seed, device)
    o = wl["osd"]
    pack.set_osd_pyannet(*load_pyannet_torch(ckpt), binarize=BinarizeConfig(
        onset=o["onset"], offset=o["offset"], min_duration_on=o["min_on"],
        min_duration_off=o["min_off"]))


def pipeline_config(cfg: dict, job: traffic.Job, device):
    from audio_classification_tpu_torch.utils.config import Overlap3Config

    return Overlap3Config(input_wavs=list(job.paths), target_wav=job.target_path,
                          sv_threshold=-1.0, sep_backend=cfg["sep_backend"],
                          provider=str(device), max_batch=8, compute_dtype=cfg["dtype"])


class Capture:
    """Forward hooks on the stage models: while ``on``, each call's
    positional inputs and output are kept as they are (device tensors; no
    copy, no wait), in call order; the recognizer's calls as its family
    ``asr`` keeps them."""

    def __init__(self, engine, sep_stage: str, asr):
        pack = engine.pack
        self.on = False
        self.calls: List[tuple] = []
        mods = {"osd": pack.osd_pyannet, "sep": pack.models[sep_stage],
                "spk": pack.models["spk"]}
        self.handles = [m.register_forward_hook(self._hook(n)) for n, m in mods.items()]
        self.handles += asr.capture(pack.models["asr"], self._keep("asr"))

    def _keep(self, name):
        def fn(kept):
            if self.on:
                self.calls.append((name, kept))
        return fn

    def _hook(self, name):
        keep = self._keep(name)
        return lambda _module, args, out: keep((args, out))

    def take(self) -> List[tuple]:
        calls, self.calls = self.calls, []
        return calls

    def remove(self):
        for h in self.handles:
            h.remove()


def program_outputs(calls: List[tuple], records: List[dict], asr) -> dict:
    """The judged side of ``check`` from one job's captured stage calls and
    its records; the recognizer's entries by its family ``asr``."""
    out: dict = {"feats_spk": [], "emb": [], "asr": []}
    for name, kept in calls:
        if name == "asr":
            out["asr"].append(asr.program_entry(kept))
            continue
        args, res = kept
        if name == "osd":
            out["osd"] = res
        elif name == "sep":
            out["sep"] = res
        elif name == "spk":
            valid = args[1].sum(dim=1)
            out["feats_spk"].append((args[0], valid))
            out["emb"].append(res / torch.clamp_min(res.norm(dim=-1, keepdim=True), 1e-12))
    out["records"] = [{"kind": r["kind"], "stream": r["stream"], "sv_score": r["sv_score"],
                       "text": r["text"], "target_text": r["target_src_text"],
                       "start": r["start"], "end": r["end"]} for r in records]
    return out


def records_ok(records: List[dict], job: traffic.Job, kind: str) -> bool:
    """One record a mixture, in order, of the workload's kind, spanning it."""
    if len(records) != len(job.mixtures):
        return False
    for r, x, p in zip(records, job.mixtures, job.paths):
        dur = len(x) / traffic.SR
        if (r["kind"] != kind or r["wav"] != p or r["start"] != 0.0
                or r["end"] != round(dur, 3) or r.get("sv_score") is None):
            return False
    return True


# ------------------------------------------------------------ kernel ranges
class KernelRanges:
    """In a traced run: a ``perfbench.k2`` / ``k3`` / ``k4`` range around
    each call of the masker, the attention core and the GAU core, with the
    call's shapes (and its valid-length tensor, read after the window)
    kept for its work count."""

    def __init__(self):
        from audio_classification_tpu_torch.models import common, convtasnet, mossformer

        self.calls: Dict[str, List[tuple]] = {"k2": [], "k3": [], "k4": []}
        rf = torch.profiler.record_function
        self.saved = [(convtasnet, "fused_tcn_masker"), (common, "flash_attention"),
                      (mossformer, "gau_attention")]
        self.orig = [getattr(m, n) for m, n in self.saved]
        k2, k3, k4 = self.orig

        def masker(x, f_len, st, *, n_per_repeat):
            wbytes = sum(t.numel() * t.element_size() for k, t in st.items()
                         if k in ("w_in", "w_dw", "w_res", "w_skip", "vecs", "cvecs"))
            self.calls["k2"].append((tuple(x.shape), st["w_in"].shape, wbytes, f_len,
                                     x.element_size()))
            with rf("perfbench.k2"):
                return k2(x, f_len, st, n_per_repeat=n_per_repeat)

        def flash(q, k, v, kv_mask=None):
            self.calls["k3"].append((tuple(q.shape), kv_mask, q.element_size()))
            with rf("perfbench.k3"):
                return k3(q, k, v, kv_mask)

        def gau(q, k, v, kv_mask, scale):
            self.calls["k4"].append((tuple(q.shape), v.shape[-1], kv_mask, q.element_size()))
            with rf("perfbench.k4"):
                return k4(q, k, v, kv_mask, scale)

        for (m, n), fn in zip(self.saved, (masker, flash, gau)):
            setattr(m, n, fn)

    def restore(self):
        for (m, n), fn in zip(self.saved, self.orig):
            setattr(m, n, fn)

    def work(self) -> Dict[str, List[dict]]:
        """Each call's work over its valid frames or keys (the device reads
        happen here, after the window)."""
        out: Dict[str, List[dict]] = {k: [] for k in self.calls}
        for shape, w_shape, wbytes, f_len, isz in self.calls["k2"]:
            nb, c, hd = w_shape
            out["k2"].append(work.k2_work(shape[0], shape[1], c, hd, nb, wbytes,
                                          f_len.tolist(), isz))
        for shape, mask, isz in self.calls["k3"]:
            b, h, t, d = shape
            keys = None if mask is None else mask.sum(dim=1).tolist()
            out["k3"].append(work.k3_work(b, h, t, t, d, isz, mask is not None, keys))
        for shape, de, mask, isz in self.calls["k4"]:
            b, t, dqk = shape
            keys = None if mask is None else mask.sum(dim=1).tolist()
            out["k4"].append(work.k4_work(b, t, dqk, de, isz, mask is not None, keys))
        return out


# ------------------------------------------------------------ a run
def device_info(device) -> dict:
    if device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 1}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(device), "count": 1}


def check_jobs(wl: dict, jobs: List[traffic.Job], seed: int) -> List[int]:
    """Pool indices whose jobs are compared: the one with the most audio,
    and others drawn from the seed."""
    longest = int(np.argmax([j.audio_s for j in jobs]))
    rest = [i for i in np.random.default_rng([seed, 2]).permutation(len(jobs)) if i != longest]
    return sorted([longest] + [int(i) for i in rest[:wl["check_jobs"] - 1]])


def run(cell: Cell, seed: int, seconds: float, trace: bool, device=None,
        t_start: Optional[float] = None, log=sys.stderr) -> dict:
    """One run -> the result line's object (with ``checks`` last)."""
    t_start = time.perf_counter() if t_start is None else t_start
    from audio_classification_tpu_torch.pipelines.offline_overlap3 import Overlap3Pipeline

    device = torch.device(device or "cuda")
    cfg, wl = cell.config, cell.workload

    def phase(name):
        print(f"[perfbench] {cell.name}: {name} at {time.perf_counter() - t_start:.3f} s",
              file=log, flush=True)

    phase("imported")
    workdir = tempfile.mkdtemp(prefix="perfbench_")
    try:
        jobs = traffic.make_jobs(wl, seed, device)
        traffic.write(jobs, workdir)
        phase("jobs written")
        engine, symbols = build_engine(cfg, wl, seed, device, workdir, cell.asr)
        phase("engine built")
        capture = Capture(engine, sep_stage(cfg), cell.asr)

        def one(job):
            return Overlap3Pipeline(pipeline_config(cfg, job, device), engine=engine).run()

        for j in range(wl["warm_jobs"]):
            one(jobs[j % len(jobs)])
        if device.type == "cuda":
            torch.cuda.synchronize(device)
            torch.cuda.reset_peak_memory_stats(device)
        setup_s = time.perf_counter() - t_start
        phase("warmed up (set-up)")

        def timed(job):
            with torch.profiler.record_function("perfbench.job"):
                res = one(job)
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            return res

        compare_at = check_jobs(wl, jobs, seed)
        walls, audio, captured, failed = [], 0.0, {}, 0
        kr = prof = untraced_s = None
        if trace:
            # the same pass over the pool without the profiler first: the
            # profiler stretches the host's side of a job, so the idle share
            # and mfu take their seconds from this pass
            t_u = time.perf_counter()
            try:
                for job in jobs:
                    timed(job)
                untraced_s = time.perf_counter() - t_u
            except Exception:  # the traced pass runs these jobs again and counts them
                traceback.print_exc(file=log)
            phase(f"untraced pass of {len(jobs)} jobs: {untraced_s} s")
            kr = KernelRanges()
            from torch.profiler import ProfilerActivity, profile
            acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if device.type == "cuda"
                                            else [])
            prof = profile(activities=acts)
            prof.__enter__()
            window_rf = torch.profiler.record_function("perfbench.window")
            window_rf.__enter__()
        t0 = time.perf_counter()
        deadline = t0 + seconds
        pos = 0
        while (pos < len(jobs)) if trace else (time.perf_counter() < deadline):
            job_i = pos % len(jobs)
            job = jobs[job_i]
            capture.on = pos == job_i and job_i in compare_at
            t_job = time.perf_counter()
            try:
                res = timed(job)
                ok = records_ok(res.segments, job, wl["kind"])
            except Exception:  # a job that raises counts as failed; the window goes on
                traceback.print_exc(file=log)
                res, ok = None, False
            walls.append(time.perf_counter() - t_job)
            audio += job.audio_s
            failed += 0 if ok else 1
            if capture.on:
                calls = capture.take()
                if ok:
                    captured[job_i] = program_outputs(calls, res.segments, cell.asr)
            capture.on = False
            pos += 1
        t_end = time.perf_counter()
        if trace:
            window_rf.__exit__(None, None, None)
            prof.__exit__(None, None, None)
            kr.restore()
        capture.remove()
        window_s = t_end - t0
        phase(f"window closed after {len(walls)} jobs, {window_s:.3f} s")
        found = forbidden_modules()
        if found:
            raise SystemExit(f"perfbench: forbidden modules loaded: {', '.join(found)}")
        dev = device_info(device)
        if device.type == "cuda":
            dev["memory_peak_bytes"] = int(torch.cuda.max_memory_allocated(device))
        else:
            dev["memory_peak_bytes"] = 0
        result = {"correct": False, "attempted": len(walls), "failed": failed, "metrics": {},
                  "device": dev}
        if trace:
            view = View(Trace.from_profile(prof), len(walls), window_s, untraced_s, kr.work(),
                        sum(work.job_flops([len(m) for m in jobs[i % len(jobs)].mixtures],
                                           len(jobs[i % len(jobs)].target), cfg, wl["kind"],
                                           cell.asr)
                            for i in range(len(walls))),
                        peaks_for(dev["kind"]))
            dev["busy_s"] = view.trace.busy_us() * 1e-6
            dev["window_s"] = window_s
            for m in cell.per_layer:
                val = load_reader(m["name"])(view)
                if val is not None:
                    result["metrics"][m["name"]] = {"value": float(val), "unit": m["unit"]}
            result["breakdown"] = {"device_ops": view.trace.top_ops(),
                                   "idle_gaps": view.trace.idle_gaps()}
            del prof, view
        else:
            e2e = {"audio_s_per_s": audio / window_s,
                   "job_p90_ms": 1e3 * float(np.percentile(walls, 90)) if walls else math.inf,
                   "setup_s": setup_s}
            for m in cell.end_to_end:
                result["metrics"][m["name"]] = {"value": e2e[m["name"]], "unit": m["unit"]}
        # ---- the reference, once the program is freed
        del engine, capture
        gc.collect()
        if device.type == "cuda":
            torch.cuda.empty_cache()
        numbers = reference_numbers(cfg, wl, jobs, captured, seed, device, symbols, cell.asr)
        phase("reference compared")
        result["correct"] = (failed == 0 and len(captured) > 0
                             and check.judge(numbers, cell.limits))
        result["checks"] = {k: {"value": numbers.get(k, math.inf), "limit": v}
                            for k, v in cell.limits.items()}
        return result
    finally:
        shutil.rmtree(workdir, ignore_errors=True)


def peaks_for(kind: str) -> Optional[dict]:
    with open(HERE / "peaks.json", encoding="utf-8") as f:
        return json.load(f).get(kind)


def reference_for(cfg: dict, wl: dict, seed: int, device, symbols, asr, tf32: bool = False):
    pn = weights.pyannote_state_dict(cfg["pyannet"], seed, device)
    return Reference(cfg, seed_weights(cfg, wl, seed, device, asr), pn, symbols, device, asr,
                     tf32=tf32)


def reference_numbers(cfg, wl, jobs, captured: Dict[int, dict], seed, device, symbols,
                      asr) -> dict:
    """The reference over every compared job -> the worst of each number."""
    if not captured:
        return {}
    ref = reference_for(cfg, wl, seed, device, symbols, asr)
    per_job = []
    for i, side in sorted(captured.items()):
        job = jobs[i]
        follow = [r["stream"] for r in side["records"]] if wl["kind"] == "overlap" else None
        r = ref.run_job(job.mixtures, job.target, wl["kind"], follow, side["asr"])
        per_job.append(check.compare_job(side, r, len(job.mixtures)))
        del r
    return check.worst(per_job)
