#!/usr/bin/env python3
"""Smoke test of the PyTorch port (audio_classification_tpu_torch) on one
NVIDIA GPU: builds the CUDA kernels, holds each against its plain PyTorch
twin at the main path's shapes, drives the flagship 3-source target-speaker
CLI at the full preset twice (every segment forced to overlap, then every
segment forced clean) and checks that each kernel ran on that path.

    python3 chip_smoke.py

One JSON object per phase on stdout, then the card's nvidia-smi name and
power limit, the per-kernel summary, and last
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
Exits non-zero, printing no result, without a CUDA device or outside a
checkout of the repository. Needs no JAX and no network.
"""
from __future__ import annotations

import json
import math
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SR = 16000


def log(obj) -> None:
    print(json.dumps(obj), flush=True)


def gpu_name_and_power_limit() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip().splitlines()[0]


def cuda_ms(torch, fn, iters: int) -> float:
    """Mean device milliseconds of fn over iters launches, after warm-up."""
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def talkers(n: int, seed: int, f0s=(120.0, 185.0, 255.0)):
    """Speech-like sources: harmonic tones with syllable-rate envelopes over
    a -50 dB noise floor (a microphone's; no frame is digital silence)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    t = np.arange(n) / SR
    out = []
    for f0 in f0s:
        vib = f0 * (1.0 + 0.03 * np.sin(2 * np.pi * rng.uniform(3, 6) * t))
        phase = 2 * np.pi * np.cumsum(vib) / SR
        src = sum(np.sin(h * phase) / h for h in range(1, 9))
        env = np.clip(np.sin(2 * np.pi * rng.uniform(3, 5) * t + rng.uniform(0, 6)), 0, None)
        noise = 0.003 * rng.standard_normal(n)
        out.append((src * env + noise).astype(np.float32))
    return out


def check_fbank(torch, np) -> dict:
    """K1 against its twin on the frames of 8 x 32 s buckets (8 x 3198 x 512)."""
    from audio_classification_tpu_torch.ops import fbank
    from audio_classification_tpu_torch.ops.kernels import fbank as k_fbank

    dev = torch.device("cuda")
    cfg = fbank.FbankConfig()
    mix = sum(talkers(32 * SR, 1)) * 0.2
    wav = torch.from_numpy(np.stack([np.roll(mix, 997 * i) for i in range(8)])).to(dev)
    frames = fbank.windowed_frames(wav, cfg).reshape(-1, cfg.n_fft).contiguous()
    bases = fbank.fbank_bases(cfg, dev)
    out = k_fbank.fbank_power_mel(frames, *bases, cfg.log_floor)
    torch.cuda.synchronize()
    ref = k_fbank.fbank_power_mel_reference(frames, *bases, cfg.log_floor)
    err = (out - ref).abs()
    active = ref > ref.max() - 15.0
    k1 = {"shape": list(frames.shape), "max_abs_err": err.max().item(),
          "max_abs_err_active": err[active].max().item(), "tol_active": 5e-4, "tol": 5e-3,
          "ms": cuda_ms(torch, lambda: k_fbank.fbank_power_mel(frames, *bases, cfg.log_floor), 20),
          "plain_ms": cuda_ms(torch, lambda: k_fbank.fbank_power_mel_reference(
              frames, *bases, cfg.log_floor), 20)}
    log({"phase": "kernel", "name": "fbank_power_mel", **k1})
    # f32, SIMT sequential FMA over 512 taps vs cuBLAS's blocked sums: bins
    # far below the peak carry the DFT's cancellation error
    assert k1["max_abs_err_active"] <= 5e-4 and k1["max_abs_err"] <= 5e-3, k1
    return k1


def check_tcn(torch, np) -> dict:
    """K2 against its twin: the full-preset masker (seeded weights), B=1,
    F=31999 (a 32 s bucket), f_len of a 20 s segment."""
    from audio_classification_tpu_torch.engine.runtime import EnginePreset, ModelPack
    from audio_classification_tpu_torch.ops.kernels import tcn

    dev = torch.device("cuda")
    gen = torch.Generator(device="cpu").manual_seed(0)
    model = ModelPack(EnginePreset(), seed=0, device=dev).models["sep3"]
    st = tcn.stack_tcn_params(model.tcn_blocks())
    f = (32 * SR - 32) // 16 + 1
    x = torch.randn((1, f, 128), generator=gen).to(dev)
    f_len = torch.tensor([(20 * SR - 32) // 16 + 1], dtype=torch.int32, device=dev)
    out = tcn.fused_tcn_masker(x, f_len, st, n_per_repeat=8)
    torch.cuda.synchronize()
    ref = tcn.tcn_masker_reference(x, f_len, st, n_per_repeat=8)
    valid = slice(0, int(f_len[0]))
    err = (out[:, valid] - ref[:, valid]).abs().max().item()
    scale = ref[:, valid].abs().max().item()
    k2 = {"shape": [1, f, 128], "f_len": int(f_len[0]), "max_abs_err": err,
          "rel_err": err / scale, "tol_rel": 1e-3,
          "ms": cuda_ms(torch, lambda: tcn.fused_tcn_masker(x, f_len, st, n_per_repeat=8), 3),
          "plain_ms": cuda_ms(torch, lambda: tcn.tcn_masker_reference(
              x, f_len, st, n_per_repeat=8), 3)}
    log({"phase": "kernel", "name": "tcn_masker", **k2})
    # f32 through 24 residual blocks, another summation order in every
    # 128/512-wide contraction and in the F x H gLN reductions
    assert math.isfinite(err) and k2["rel_err"] <= 1e-3, k2
    return k2


def check_attention(torch, np) -> dict:
    """K3 against its twin: SenseVoice on a 32 s clean span (T=537, 8 heads)
    at batch 8 and at the file-mode pipeline's batch 1, and OSDNet on a 32 s
    bucket (T=800, 4 heads), ragged key masks."""
    from audio_classification_tpu_torch.ops.kernels import attention

    dev = torch.device("cuda")
    gen = torch.Generator(device="cpu").manual_seed(1)
    cases = []
    for b, h, t in ((8, 8, 537), (1, 8, 537), (1, 4, 800)):
        q, k, v = (torch.randn((b, h, t, 64), generator=gen).to(dev) for _ in range(3))
        lens = torch.tensor([t - 97 * i % t for i in range(b)], device=dev)
        mask = torch.arange(t, device=dev)[None, :] < lens[:, None]
        out = attention.flash_attention(q, k, v, mask)
        torch.cuda.synchronize()
        ref = attention.attention_reference(q, k, v, mask)
        rows = mask[:, None, :, None]
        err = ((out - ref).abs() * rows).max().item()
        cases.append({"shape": [b, h, t, 64], "max_abs_err": err,
                      "ms": cuda_ms(torch, lambda: attention.flash_attention(q, k, v, mask), 20),
                      "plain_ms": cuda_ms(torch, lambda: attention.attention_reference(
                          q, k, v, mask), 20)})
        log({"phase": "kernel", "name": "flash_attention", **cases[-1], "tol": 2e-5})
        # f32 softmax over <= 800 keys with O(1) outputs; padded query rows
        # are discarded downstream and not compared
        assert err <= 2e-5, cases[-1]
    return {"max_abs_err": max(c["max_abs_err"] for c in cases),
            "ms": cases[0]["ms"], "plain_ms": cases[0]["plain_ms"], "cases": cases}


def check_small_input_against_cpu(torch, np) -> None:
    """The full-preset stages on the card (kernels) against the same weights
    on the CPU (plain twins) for two 4 s items: OSD probs, separated
    branches, speaker embeddings and ASR logits, 1e-3 x max|ref| (float32,
    different kernels and summation orders through up to 24 blocks)."""
    from audio_classification_tpu_torch.engine.runtime import EnginePreset, ModelPack, StageEngine
    from audio_classification_tpu_torch.models.asr.sensevoice import sensevoice_frontend

    n = 4 * SR
    src = talkers(n, 2)
    wav = np.stack([sum(src) * 0.25, src[0] * 0.5]).astype(np.float32)
    wav_i16 = np.clip(np.rint(wav * 32768), -32768, 32767).astype(np.int16)
    lens = np.array([n, 3 * SR], np.int32)
    engines = {}
    for d in ("cuda", "cpu"):
        engines[d] = StageEngine(ModelPack(EnginePreset(), seed=0, device=d))

    def asr_logits(e, w, l):
        feats, mask = sensevoice_frontend(e._dq(w), l, e.pack.asr_cfg)
        return e.pack.models["asr"](feats, mask)

    stages = {
        "osd_probs": lambda e, w, l: e._osd_fn(w, l),
        "sep_branches": lambda e, w, l: e._sep_core(e._dq(w), l),
        "spk_embeddings": lambda e, w, l: e._embed_core(e._dq(w), l),
        "asr_logits": asr_logits,
    }
    report = {}
    with torch.inference_mode():
        for name, fn in stages.items():
            outs = {}
            for d, e in engines.items():
                w = torch.from_numpy(wav_i16).to(d)
                outs[d] = fn(e, w, torch.from_numpy(lens).to(d)).float().cpu()
            err = (outs["cuda"] - outs["cpu"]).abs().max().item()
            rel = err / max(outs["cpu"].abs().max().item(), 1e-12)
            report[name] = rel
            assert math.isfinite(rel) and rel <= 1e-3, (name, rel)
    log({"phase": "small_input_vs_cpu", "rel_err": report, "tol_rel": 1e-3})


def run_pipeline(torch, np, counters: dict) -> None:
    """The port's CLI at the full preset, twice, with the launch counts."""
    from audio_classification_tpu_torch.audio_io import write_wav
    from audio_classification_tpu_torch.cli.offline_overlap_3src import main

    work = ROOT / "build" / "chip_smoke"
    work.mkdir(parents=True, exist_ok=True)
    src = talkers(20 * SR, 3)
    mix = sum(src) / 3.0
    write_wav(work / "mix.wav", 0.6 * mix / np.abs(mix).max(), SR)
    target = talkers(6 * SR, 4)[0]
    write_wav(work / "target.wav", 0.6 * target / np.abs(target).max(), SR)

    for fn in counters.values():
        fn.launches = 0
    runs = {}
    for thr, kind in (("0.0", "overlap"), ("1.0", "clean")):
        t0 = time.perf_counter()
        out_dir, result = main([
            "--input-wavs", str(work / "mix.wav"), "--target-wav", str(work / "target.wav"),
            "--preset", "full", "--seed", "0", "--sv-threshold", "-1", "--osd-thr", thr,
            "--out-dir", str(work / "out")])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        for name in ("segments.jsonl", "segments.csv", "summary.json"):
            assert (out_dir / name).is_file(), name
        recs = [json.loads(x) for x in (out_dir / "segments.jsonl").read_text().splitlines()]
        assert recs and all(r["kind"] == kind for r in recs), recs
        assert all(math.isfinite(r["sv_score"]) for r in recs), recs
        m = result.metrics
        runs[kind] = {k: m[k] for k in ("segments_total", "segments_clean",
                                         "segments_overlap_streams", "time_osd_sec",
                                         "time_sep_sec", "time_asr_sec",
                                         "time_compute_total_sec", "rtf_total",
                                         "total_audio_sec")}
        runs[kind]["wall_sec"] = wall
        runs[kind]["records"] = recs
        log({"phase": "pipeline", "osd_thr": float(thr), **runs[kind]})
    launches = {name: fn.launches for name, fn in counters.items()}
    log({"phase": "launches", **launches})
    assert runs["overlap"]["segments_overlap_streams"] > 0 and runs["clean"]["segments_clean"] > 0
    for name, n in launches.items():
        assert n > 0, f"kernel {name} was not launched on the main path"


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: PyTorch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this smoke test runs on the GPU only",
              file=sys.stderr)
        return 2
    if not (ROOT / "audio_classification_tpu_torch" / "csrc").is_dir():
        print(f"chip_smoke: {ROOT} is not a checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    import numpy as np

    from audio_classification_tpu_torch import _build
    from audio_classification_tpu_torch.ops.kernels.attention import flash_attention
    from audio_classification_tpu_torch.ops.kernels.fbank import fbank_power_mel
    from audio_classification_tpu_torch.ops.kernels.tcn import fused_tcn_masker

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = gpu_name_and_power_limit()
    print(smi, flush=True)
    log({"phase": "device", "kind": torch.cuda.get_device_name(0),
         "count": torch.cuda.device_count(), "torch": torch.__version__,
         "cuda": torch.version.cuda})

    t0 = time.perf_counter()
    nvcc_s = _build.build(verbose=True)
    log({"phase": "build", "nvcc_sec": nvcc_s, "sec": time.perf_counter() - t0,
         "library": _build.library_path().name})

    results = {"fbank_power_mel": check_fbank(torch, np),
               "tcn_masker": check_tcn(torch, np),
               "flash_attention": check_attention(torch, np)}
    check_small_input_against_cpu(torch, np)
    counters = {"fbank_power_mel": fbank_power_mel, "tcn_masker": fused_tcn_masker,
                "flash_attention": flash_attention}
    run_pipeline(torch, np, counters)

    meta = {
        "fbank_power_mel": ("audio_classification_tpu_torch/csrc/fbank_power_mel.cu",
                            "audio_classification_tpu/ops/pallas/fbank_kernel.py:95"),
        "tcn_masker": ("audio_classification_tpu_torch/csrc/tcn_masker.cu",
                       "audio_classification_tpu/ops/pallas/tcn_kernel.py:489"),
        "flash_attention": ("audio_classification_tpu_torch/csrc/flash_attention.cu",
                            "audio_classification_tpu/ops/pallas/attention_kernel.py:268"),
    }
    kernels = [{"name": name, "route": "cuda", "source": src, "replaces": rep,
                "launches": counters[name].launches,
                "max_abs_err": results[name]["max_abs_err"],
                "ms": results[name]["ms"], "plain_ms": results[name]["plain_ms"]}
               for name, (src, rep) in meta.items()]
    print(smi, flush=True)
    log({"kernels": kernels})
    log({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
