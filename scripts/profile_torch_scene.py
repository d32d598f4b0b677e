#!/usr/bin/env python3
"""Where one pipeline scene of the PyTorch port spends its time on the GPU.

Builds ONE full-preset engine per --quant value (seeded random weights), runs
a scene warm a few times for the wall clock, then once more under
torch.profiler, and prints one JSON object per scene: warm walls, rtf_total
or per-window / per-tick latencies, device busy time (union of kernel
intervals), idle share, device time by kernel name, peak device memory and,
for the int8 scenes, the device time inside ops/quant split into quantise
(activations and weights), the integer product (torch._int_mm) and the
rescale, and the fbank frontend's device time and device ops: the prologue
that forms K1's frames (ops/fbank.windowed_frames) and K1 itself, with the
frame shapes K1 was called at. Scenes:

  overlap      20 s three-talker mixture, every segment forced to overlap,
               Conv-TasNet-3 (32 s bucket)
  clean        the same mixture, every segment forced clean
  mossformer   6 s two-talker mixture, forced overlap, --sep-backend mossformer
               (8 s bucket, K4 at T = 15999 in 8 layers)
  overlap-int8 the overlap scene under --quant int8 (K2-s8 at F = 31999)
  overlap-bf16, clean-bf16, mossformer-bf16, overlap-int8-bf16
               the four file scenes above with --compute-dtype bfloat16
               (K2 / K2-s8 bf16; K4 bf16 in the first GAU layer)
  paraformer, transducer, beam, whisper (and each with -bf16)
               the clean scene with another ASR family (seeded weights;
               beam: the transducer with modified_beam_search, 4 paths)
  pyannet (and pyannet-bf16)
               the overlap scene with PyanNet serving OSD, from a pyannote
               checkpoint at the published widths (chip_smoke.py's), forced
               through the hysteresis flags to every frame overlapped
  streaming    --quant int8: the six 1.984 s blocks of a 12 s three-talker
               wav through StreamingOverlap3Pipeline._analyze_segment
  serving      --quant int8: 8 sessions x 12 s, six ticks of 8 windows of 2 s
               through StreamingServer.step()
  long-form    a 200 s utterance through ASRRecognizer.transcribe(
               long_form=True) on an engine without a mesh (256 s bucket,
               K3 at T = 4271 in 12 blocks)
  long-form-ring4  the same utterance on an engine with a mesh of 4 shards
               on the one card (ring attention: K5 on 1068-frame blocks,
               16 launches and 12 merges a block)

torch.profiler's context is thread-local, so the streaming and serving scenes
drive the pipeline's per-chunk analysis and the server's tick on the calling
thread (what the worker threads run, without the queue in between).

    python3 scripts/profile_torch_scene.py [--scenes overlap,clean,...] [--warm 3]
        [--out build/profile_torch_scene.json] [--root <checkout>]

Needs a CUDA device; run it from the repository root. The whole report also
goes to the --out file, with the file scenes' records of their first run
(kind, span, stream, text, sv_score; the long-form scenes' text as one
record). --root takes the port's package from
another checkout (a parent commit unpacked with ``git archive`` into a
directory that .gitignore lists), so that two versions are profiled by the
same script; scripts/compare_scene_records.py sets two reports' records side
by side.
"""
from __future__ import annotations

import argparse
import bisect
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
    ap.add_argument("--scenes",
                    default="overlap,clean,mossformer,overlap-int8,streaming,serving,"
                            "long-form,long-form-ring4")
    ap.add_argument("--warm", type=int, default=3)
    ap.add_argument("--out", default=str(ROOT / "build" / "profile_torch_scene.json"))
    ap.add_argument("--root", default=str(ROOT), help="checkout whose package is profiled")
    args = ap.parse_args()
    sys.path.insert(0, str(Path(args.root).resolve()))  # before the package is imported
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print("profile_torch_scene: no CUDA device", file=sys.stderr)
        return 2
    from chip_smoke import LONG_SEC, LONG_SHARDS, SR, talkers, write_pyannote_checkpoint

    from audio_classification_tpu_torch.audio_io import write_wav
    from audio_classification_tpu_torch.cli import serve_streams, streaming_overlap_3src
    from audio_classification_tpu_torch.engine.runtime import StageEngine
    from audio_classification_tpu_torch.models import common, convtasnet, facades
    from audio_classification_tpu_torch.ops import fbank, quant
    from audio_classification_tpu_torch.ops.kernels import tcn
    from audio_classification_tpu_torch.parallel.mesh import make_mesh
    from audio_classification_tpu_torch.pipelines.offline_overlap3 import (
        Overlap3Pipeline,
        build_engine,
    )
    from audio_classification_tpu_torch.pipelines.serving import StreamingServer
    from audio_classification_tpu_torch.pipelines.streaming import (
        StreamingOverlap3Pipeline,
        StreamingSegment,
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
    mix12 = sum(talkers(12 * SR, 6)) / 3.0
    mix12 = (0.6 * mix12 / np.abs(mix12).max()).astype(np.float32)
    calls = []
    for i in range(8):
        call = sum(talkers(12 * SR, 20 + i, f0s=(100.0 + 9 * i, 170.0 + 11 * i, 240.0 + 13 * i)))
        calls.append((0.6 * call / np.abs(call).max()).astype(np.float32))

    # device time inside ops/quant, by part: ranges around the module's
    # functions while a profile is taken (looked up at call time, so patching
    # the modules that hold them is enough)
    def ranged(fn, label):
        def wrapped(*a, **kw):
            with torch.profiler.record_function(label):
                return fn(*a, **kw)
        return wrapped

    for mod, names in ((quant, ("quantize_dynamic", "quantize_weight", "int_matmul")),
                       (common, ("int8_matmul", "int8_conv1d")), (convtasnet, ("int8_matmul",)),
                       (tcn, ("quantize_weight",))):  # the masker's weight stack (first call only:
                                                   # the models keep their int8 weights)
        for fname in names:
            label = "int8::" + ("whole" if fname.startswith("int8_") else
                                "masker_stack" if mod is tcn else fname)
            setattr(mod, fname, ranged(getattr(mod, fname), label))

    # the fbank frontend: log_mel_fbank looks both names up in ops/fbank at
    # call time; K1's frame shapes are kept for the profiled run
    k1_shapes = []

    def k1_ranged(fn):
        def wrapped(frames, *a, **kw):
            k1_shapes.append(tuple(frames.shape))
            return fn(frames, *a, **kw)
        return ranged(wrapped, "fbank::k1")

    fbank.windowed_frames = ranged(fbank.windowed_frames, "fbank::prologue")
    fbank.fbank_power_mel = k1_ranged(fbank.fbank_power_mel)

    base = dict(target_wav=str(work / "target.wav"), preset="full", seed=0, sv_threshold=-1.0)
    file_scenes = {
        "overlap": dict(input_wavs=[str(work / "mix.wav")], osd_thr=0.0),
        "clean": dict(input_wavs=[str(work / "mix.wav")], osd_thr=1.0),
        "mossformer": dict(input_wavs=[str(work / "mix2.wav")], osd_thr=0.0,
                           sep_backend="mossformer"),
        "overlap-int8": dict(input_wavs=[str(work / "mix.wav")], osd_thr=0.0, quant="int8"),
    }
    transducer = dict(encoder="seeded", decoder="seeded", joiner="seeded")
    families = {"paraformer": dict(paraformer="seeded"), "transducer": transducer,
                "beam": dict(transducer, decoding_method="modified_beam_search",
                             num_active_paths=4),
                "whisper": dict(whisper_encoder="seeded", whisper_decoder="seeded")}
    for name, flags in families.items():
        file_scenes[name] = dict(file_scenes["clean"], **flags)
    write_pyannote_checkpoint(torch, np, work / "segmentation.ckpt", seed=21)
    file_scenes["pyannet"] = dict(file_scenes["overlap"],
                                  osd_checkpoint=str(work / "segmentation.ckpt"), osd_onset=0.0,
                                  osd_offset=0.0, osd_min_on=0.1, osd_min_off=0.1)
    for name in list(file_scenes):
        file_scenes[name + "-bf16"] = dict(file_scenes[name], compute_dtype="bfloat16")
    engines = {}

    def engine_for(q="none", dtype="float32", **fields):
        """One engine per set of engine flags (quant, dtype, the family's,
        the OSD checkpoint's): the pipeline-only fields do not key it."""
        fields = {k: v for k, v in fields.items()
                  if k not in ("input_wavs", "osd_thr", "sep_backend")}
        key = (q, dtype, tuple(sorted(fields.items())))
        if key not in engines:
            engines[key] = build_engine(Overlap3Config(**base, quant=q, compute_dtype=dtype,
                                                       **fields))
        return engines[key]

    def file_scene(name):
        cfg = Overlap3Config(**base, **file_scenes[name])
        fields = {k: v for k, v in file_scenes[name].items() if k not in ("quant", "compute_dtype")}
        engine = engine_for(cfg.quant, cfg.compute_dtype, **fields)

        def run():
            res = Overlap3Pipeline(cfg, engine=engine).run()
            torch.cuda.synchronize()
            keys = ("kind", "start", "end", "stream", "text", "sv_score")
            return {"rtf_total": res.metrics["rtf_total"],
                    "records": [{k: r[k] for k in keys} for r in res.segments]}
        return run

    def streaming_scene():
        args = streaming_overlap_3src.parse_args(
            ["--target-wav", str(work / "target.wav"), "--quant", "int8", "--sv-threshold", "-1",
             "--seed", "0"])
        pipe = StreamingOverlap3Pipeline(args, args.target_wav, engine=engine_for("int8"))
        pipe.close()  # the worker is not used: the chunks run on this thread
        block = int(SR * 2.0 / 1024) * 1024

        def run():
            lat = []
            for k in range(len(mix12) // block):
                seg = StreamingSegment(mix12[k * block: (k + 1) * block], 2.0 * k, 2.0 * (k + 1), SR)
                t0 = time.perf_counter()
                pipe._analyze_segment(seg)
                torch.cuda.synchronize()
                lat.append((time.perf_counter() - t0) * 1e3)
            return {"chunk_ms": lat, "records": len(pipe.get_results())}
        return run

    def serving_scene():
        args = serve_streams.parse_args(
            ["--wavs", "-", "--targets", str(work / "target.wav"), "--quant", "int8",
             "--sv-threshold", "-1", "--seed", "0", "--max-batch", "16"])
        server = StreamingServer(args, engine=engine_for("int8"), autostart=False)
        sids = [server.open_session(target_wav=str(work / "target.wav")) for _ in calls]

        def run():
            lat, records = [], 0
            for k in range(6):
                for sid, call in zip(sids, calls):
                    server.add_audio(sid, call[k * 2 * SR: (k + 1) * 2 * SR])
                t0 = time.perf_counter()
                assert server.step() == len(sids)
                torch.cuda.synchronize()
                lat.append((time.perf_counter() - t0) * 1e3)
                records += sum(len(server.get_results(sid)) for sid in sids)
            return {"tick_ms": lat, "records": records}
        return run

    def long_form_scene(shards):
        pack = engine_for("none").pack
        engine = StageEngine(pack, mesh=make_mesh(shards) if shards else None)
        speech = sum(talkers(LONG_SEC * SR, 30)) / 3.0
        speech = (0.6 * speech / np.abs(speech).max()).astype(np.float32)
        rec = facades.ASRRecognizer(engine)

        def run():
            text = rec.transcribe(speech, SR, long_form=True)  # ends in a copy to the host
            # the text as the scene's one record, for compare_scene_records.py
            return {"text_len": len(text), "audio_sec": LONG_SEC,
                    "records": [{"kind": "long_form", "start": 0.0, "end": float(LONG_SEC),
                                 "stream": 0, "text": text, "sv_score": None}]}
        return run

    report = {"device": smi, "scenes": {}}
    for name in args.scenes.split(","):
        if name == "streaming":
            run = streaming_scene()
        elif name == "serving":
            run = serving_scene()
        elif name.startswith("long-form"):
            run = long_form_scene(LONG_SHARDS if name.endswith("ring4") else 0)
        else:
            run = file_scene(name)
        first = run()  # first call: builds kernels, cuDNN plans, cached constants
        walls, extras = [], []
        for _ in range(args.warm):
            t0 = time.perf_counter()
            extras.append(run())
            walls.append((time.perf_counter() - t0) * 1e3)
        torch.cuda.reset_peak_memory_stats()
        k1_shapes.clear()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            run()
            traced_wall = (time.perf_counter() - t0) * 1e3
        # device events: kernels and copies, and the record_function ranges
        # mirrored onto the device's timeline (first to last kernel launched
        # under one): this script's int8:: and fbank:: ranges and the engine's
        # own engine.* stage ranges (utils/profiling.stage_range), which are
        # no device work and must not count as busy time or as device ops
        by_name, intervals, ranges = {}, [], {}
        for ev in prof.events():
            if ev.device_type != torch.autograd.DeviceType.CUDA:
                continue
            span = (ev.time_range.start, ev.time_range.end)
            if ev.name.startswith(("int8::", "fbank::", "engine.")):
                ranges.setdefault(ev.name, []).append(span)
                continue
            by_name[ev.name] = by_name.get(ev.name, [0, 0.0])
            by_name[ev.name][0] += 1
            by_name[ev.name][1] += (span[1] - span[0]) / 1e3
            intervals.append(span)
        busy = busy_ms(intervals)
        span = (max(e for _, e in intervals) - min(s for s, _ in intervals)) / 1e3
        top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:14]
        # kernel time under each range: a kernel counts for the innermost range
        # that holds it; what int8_matmul / int8_conv1d launch outside their
        # three parts is the rescale (and the conv's window gather)
        fbank_ranges = {k[7:]: v for k, v in ranges.items() if k.startswith("fbank::")}
        ranges = {k[6:]: v for k, v in ranges.items() if k.startswith("int8::")}
        inner = sorted((s, e, k) for k, v in ranges.items() if k != "whole" for s, e in v)
        whole = sorted(ranges.get("whole", []))
        int8_ms = {k: {"ranges": len(v), "kernel_ms": 0.0} for k, v in ranges.items()}
        if whole:
            int8_ms["rescale_and_gather"] = {"kernel_ms": 0.0}
        for s, e in intervals:
            i = bisect.bisect_right(inner, (s, float("inf"), "")) - 1
            if i >= 0 and e <= inner[i][1]:
                int8_ms[inner[i][2]]["kernel_ms"] += (e - s) / 1e3
                continue
            i = bisect.bisect_right(whole, (s, float("inf"))) - 1
            if i >= 0 and e <= whole[i][1]:
                int8_ms["rescale_and_gather"]["kernel_ms"] += (e - s) / 1e3
        int8_ms.pop("whole", None)
        if int8_ms:
            int8_ms["all"] = {"kernel_ms": sum(v["kernel_ms"] for v in int8_ms.values()),
                              "share_of_busy": sum(v["kernel_ms"] for v in int8_ms.values()) / busy}
        # kernels and copies inside each fbank range (the ranges do not nest)
        fbank_device = {}
        for k, spans in fbank_ranges.items():
            ops = [(s, e) for s, e in intervals for rs, re_ in spans if rs <= s and e <= re_]
            fbank_device[k] = {"ranges": len(spans), "device_ops": len(ops),
                               "kernel_ms": sum(e - s for s, e in ops) / 1e3}
        if k1_shapes:
            fbank_device["k1_shapes"] = {"x".join(map(str, sh)): k1_shapes.count(sh)
                                         for sh in sorted(set(k1_shapes))}
        scene = {
            "warm_wall_ms": walls, "traced_wall_ms": traced_wall,
            "device_busy_ms": busy, "device_span_ms": span,
            "idle_share_of_wall": 1.0 - busy / traced_wall, "device_ops": len(intervals),
            "peak_device_mem_mb": torch.cuda.max_memory_allocated() / 2**20,
            "int8_device_ms": int8_ms, "fbank_device": fbank_device,
            "top_kernels_ms": [{"name": k[:90], "calls": v[0], "ms": v[1]} for k, v in top],
            # the port's own kernels (csrc/ puts each in an anonymous
            # namespace), whatever their rank
            "port_kernels_ms": [{"name": k[:90], "calls": v[0], "ms": v[1]}
                                for k, v in sorted(by_name.items(), key=lambda kv: -kv[1][1])
                                if "(anonymous namespace)::" in k],
        }
        if isinstance(first.get("records"), list):  # a file scene's records
            scene["records"] = first["records"]
            for e in extras:
                del e["records"]
        for key in extras[0]:
            vals = [e[key] for e in extras]
            scene[key] = vals
            if key.endswith("_ms"):  # per-window / per-tick latencies over the warm passes
                flat = np.asarray([x for v in vals for x in v])
                scene[key[:-3] + "_p50_ms"] = float(np.percentile(flat, 50))
                scene[key[:-3] + "_p95_ms"] = float(np.percentile(flat, 95))
        report["scenes"][name] = scene
        print(json.dumps({name: scene}), flush=True)
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(report, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
