#!/usr/bin/env python3
"""Smoke test of the PyTorch port (audio_classification_tpu_torch) on one
NVIDIA GPU: builds the CUDA kernels, holds each against its plain PyTorch
twin at the main path's shapes (with its time, the twin's, the card's bound
for the same work and, for attention, one library call's time), checks the
full-preset stages on the card against the CPU, and drives the port's entry
points at the full preset, reading every kernel's launch count around each:

- the flagship 3-source target-speaker CLI, every segment forced to overlap,
  then every segment forced clean (Conv-TasNet-3: K1, K2, K3);
- the same CLI with --sep-backend mossformer, separation evaluation and the
  resource monitor on, on a mixture in the 8 s bucket (K1, K4);
- the 2-source MVP runner over a small synthetic Libri2Mix tree at 8 kHz,
  once per separation backend (resampler, K1, K2 / K4);
- the MossFormer demo on one 8 kHz wav (K4).

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
# NVIDIA H100 SXM data sheet: float32 outside the tensor cores (every kernel
# here is IEEE float32 FMA) and HBM3 bandwidth
PEAK_F32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12


def bound(flops: float, nbytes: float) -> dict:
    """The least time the card could take: the larger of operations over the
    float32 peak and bytes (inputs read once, outputs written once) over the
    memory rate."""
    by_ops, by_bytes = flops / PEAK_F32_FLOPS * 1e3, nbytes / PEAK_BYTES_PER_S * 1e3
    return {"bound_ms": max(by_ops, by_bytes),
            "bound_by": "operations" if by_ops >= by_bytes else "bytes",
            "flops": flops, "bytes": nbytes}


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
              frames, *bases, cfg.log_floor), 20),
          "library_ms": None}
    n, n_fft = frames.shape
    n_in = sum(b.numel() for b in bases) + frames.numel()
    # DFT as [N, n_fft] x [n_fft, 2 bins], then power x mel [bins, n_mel]
    n_bins, n_mel = n_fft // 2 + 1, out.shape[-1]
    k1.update(bound(2.0 * n * n_fft * 2 * n_bins + 2.0 * n * n_bins * n_mel,
                    4.0 * (n_in + out.numel())))
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
              x, f_len, st, n_per_repeat=8), 3),
          "library_ms": None}
    nb, c, hd = st["w_in"].shape
    # per block and frame: in (C x H), res|skip (H x 2C) and the 3-tap depthwise conv
    k2.update(bound(nb * f * (2.0 * c * hd + 2.0 * hd * 2 * c + 6.0 * hd),
                    4.0 * (2 * x.numel() + sum(t.numel() for t in st.values()))))
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
        sdpa_mask = mask[:, None, None, :]
        cases.append({"shape": [b, h, t, 64], "max_abs_err": err,
                      "ms": cuda_ms(torch, lambda: attention.flash_attention(q, k, v, mask), 20),
                      "plain_ms": cuda_ms(torch, lambda: attention.attention_reference(
                          q, k, v, mask), 20),
                      # yardstick only: the port never calls it
                      "library_ms": cuda_ms(
                          torch, lambda: torch.nn.functional.scaled_dot_product_attention(
                              q, k, v, attn_mask=sdpa_mask), 20),
                      **bound(4.0 * b * h * t * t * 64, 4.0 * (4 * q.numel() + mask.numel() / 4))})
        log({"phase": "kernel", "name": "flash_attention", **cases[-1], "tol": 2e-5})
        # f32 softmax over <= 800 keys with O(1) outputs; padded query rows
        # are discarded downstream and not compared
        assert err <= 2e-5, cases[-1]
    return {**cases[0], "max_abs_err": max(c["max_abs_err"] for c in cases), "cases": cases}


def check_gau(torch, np) -> dict:
    """K4 against its blockwise twin at the main path's shape (one 8 s bucket
    of the full-preset MossFormer: T = 15999 frames, Dqk 128, De 768, the
    keys of a 6 s segment valid) and at a small ragged batch of 3 with one
    fully masked item."""
    from audio_classification_tpu_torch.ops.kernels import gau

    dev = torch.device("cuda")
    gen = torch.Generator(device="cpu").manual_seed(4)
    cases = []
    for b, t, lens, iters in ((1, 15999, [11999], 3), (3, 1237, [1237, 700, 0], 10)):
        q, k = (torch.randn((b, t, 128), generator=gen).to(dev) for _ in range(2))
        v = torch.randn((b, t, 768), generator=gen).to(dev)
        mask = torch.arange(t, device=dev)[None, :] < torch.tensor(lens, device=dev)[:, None]
        scale = 1.0 / t
        out = gau.gau_attention(q, k, v, mask, scale)
        torch.cuda.synchronize()
        ref = gau.gau_attention_reference(q, k, v, mask, scale)
        err = (out - ref).abs().max().item()
        peak = ref.abs().max().item()
        # operations for the valid keys only: a masked key contributes exactly 0
        flops = 2.0 * t * sum(lens) * (128 + 768)
        cases.append({"shape": [b, t, 128, 768], "valid_keys": lens, "max_abs_err": err,
                      "rel_err": err / peak, "tol_rel": 1e-4,
                      "ms": cuda_ms(torch, lambda: gau.gau_attention(q, k, v, mask, scale), iters),
                      "plain_ms": cuda_ms(torch, lambda: gau.gau_attention_reference(
                          q, k, v, mask, scale), iters),
                      "library_ms": None,  # no single PyTorch call computes relu^2 attention
                      **bound(flops, 4.0 * (2 * q.numel() + 2 * v.numel() + mask.numel() / 4))})
        log({"phase": "kernel", "name": "gau_attention", **cases[-1]})
        # predicted before the first run on the card: ~1e-5 of max|out|. Both
        # sides are IEEE f32; the kernel adds up to 16k key terms of mixed sign
        # one after another, the twin in cuBLAS's blocked order, so the error
        # walks like sqrt(keys) * 2^-24 of the partial sums. Tolerance 1e-4.
        assert math.isfinite(err) and err <= 1e-4 * peak, cases[-1]
        assert not out[torch.tensor(lens, device=dev) == 0].any()  # fully masked item: exact zeros
    return {**cases[0], "max_abs_err": max(c["max_abs_err"] for c in cases), "cases": cases}


def check_small_input_against_cpu(torch, np) -> None:
    """The full-preset stages on the card (kernels) against the same weights
    on the CPU (plain twins) for two 4 s items: OSD probs, separated
    branches (Conv-TasNet with 3 and 2 sources), speaker embeddings and ASR
    logits; and MossFormer on two items in a 2 s bucket (T = 3999 frames, so
    the CPU side stays below half a TFLOP). 1e-3 x max|ref| (float32,
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
        "sep2_branches": lambda e, w, l: e._sep_core(e._dq(w), l, "sep2"),
        # the first 2 s of both items, 2 s and 1.5 s valid
        "mossformer_branches": lambda e, w, l: e._sep_core(e._dq(w[:, : 2 * SR]), l // 2,
                                                           "mossformer"),
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


def _counted(torch, counters: dict, expect: tuple, name: str, fn):
    """Run one entry point with every launch count set to 0 just before and
    read just after; the kernels in ``expect`` must have been launched."""
    for k in counters.values():
        k.launches = 0
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k: fn_k.launches for k, fn_k in counters.items()}
    log({"phase": "launches", "path": name, "wall_sec": wall, **launches})
    for k in expect:
        assert launches[k] > 0, f"kernel {k} was not launched by {name}"
    return out, launches


def run_paths(torch, np, counters: dict) -> dict:
    """The port's entry points at the full preset (seeded random weights),
    each with its launch counts -> total launches per kernel."""
    from audio_classification_tpu_torch.audio_io import read_wav, write_wav
    from audio_classification_tpu_torch.cli import mossformer_infer, offline_overlap_mvp
    from audio_classification_tpu_torch.cli.offline_overlap_3src import main as overlap3_main
    from audio_classification_tpu_torch.models import facades

    work = ROOT / "build" / "chip_smoke"
    work.mkdir(parents=True, exist_ok=True)
    src = talkers(20 * SR, 3)
    mix = sum(src) / 3.0
    write_wav(work / "mix.wav", 0.6 * mix / np.abs(mix).max(), SR)
    target = talkers(6 * SR, 4)[0]
    write_wav(work / "target.wav", 0.6 * target / np.abs(target).max(), SR)
    total = {k: 0 for k in counters}

    def add(launches):
        for k, n in launches.items():
            total[k] += n

    metric_keys = ("segments_total", "segments_clean", "segments_overlap_streams",
                   "time_osd_sec", "time_sep_sec", "time_asr_sec", "time_compute_total_sec",
                   "rtf_total", "total_audio_sec")

    def flagship(name, argv, kind, expect):
        (out_dir, result), launches = _counted(torch, counters, expect, name, lambda: overlap3_main(
            [*argv, "--target-wav", str(work / "target.wav"), "--preset", "full", "--seed", "0",
             "--sv-threshold", "-1", "--out-dir", str(work / "out")]))
        add(launches)
        for fname in ("segments.jsonl", "segments.csv", "summary.json"):
            assert (out_dir / fname).is_file(), fname
        recs = [json.loads(x) for x in (out_dir / "segments.jsonl").read_text().splitlines()]
        assert recs and all(r["kind"] == kind for r in recs), recs
        assert all(math.isfinite(r["sv_score"]) for r in recs), recs
        log({"phase": "pipeline", "path": name, **{k: result.metrics[k] for k in metric_keys},
             "records": recs})
        return result

    # flagship CLI, Conv-TasNet-3: a 20 s mixture (32 s bucket: OSD attention
    # at T = 800, SenseVoice at T = 537, the masker at F = 31999)
    r = flagship("overlap3 --osd-thr 0.0", ["--input-wavs", str(work / "mix.wav"),
                                            "--osd-thr", "0.0"],
                 "overlap", ("fbank_power_mel", "tcn_masker", "flash_attention"))
    assert r.metrics["segments_overlap_streams"] > 0
    r = flagship("overlap3 --osd-thr 1.0", ["--input-wavs", str(work / "mix.wav"),
                                            "--osd-thr", "1.0"],
                 "clean", ("fbank_power_mel", "flash_attention"))
    assert r.metrics["segments_clean"] > 0

    # flagship CLI, MossFormer: a 6 s two-talker mixture (8 s bucket: K4 at
    # T = 15999 in each of the 8 GAU layers), with the separation evaluated
    # against its two sources and the resource monitor on
    two = talkers(6 * SR, 5)[:2]
    peak = np.abs(two[0] + two[1]).max()
    for i, x in enumerate(two):
        write_wav(work / f"s{i + 1}.wav", 0.6 * x / peak, SR)
    write_wav(work / "mix2.wav", 0.6 * (two[0] + two[1]) / peak, SR)
    r = flagship("overlap3 --sep-backend mossformer",
                 ["--input-wavs", str(work / "mix2.wav"), "--osd-thr", "0.0",
                  "--sep-backend", "mossformer", "--eval-separation", "--enable-metrics",
                  "--ref-wavs", str(work / "s1.wav"), str(work / "s2.wav")],
                 "overlap", ("fbank_power_mel", "gau_attention"))
    assert r.metrics["sep_eval_segments"] >= 1 and math.isfinite(r.metrics["sep_sisdr_mean"])
    log({"phase": "sep_eval", **{k: v for k, v in r.metrics.items()
                                 if k.startswith(("sep_", "gpu_", "rss_", "cpu_"))}})

    # 2-source MVP runner over a synthetic Libri2Mix tree at 8 kHz (three
    # mixtures of 3-5 s, decimated from the 16 kHz talkers), every segment
    # forced to overlap, once per backend
    base = work / "librimix" / "Libri2Mix" / "wav8k" / "min" / "test"
    for sub in ("mix_clean", "s1", "s2"):
        (base / sub).mkdir(parents=True, exist_ok=True)
    for m, sec in enumerate((3, 4, 5)):
        a, b2 = (x[::2] for x in talkers(sec * SR, 10 + m, f0s=(110.0 + 10 * m, 210.0 + 15 * m)))
        peak = np.abs(a + b2).max()
        write_wav(base / "s1" / f"mix{m}.wav", 0.6 * a / peak, SR // 2)
        write_wav(base / "s2" / f"mix{m}.wav", 0.6 * b2 / peak, SR // 2)
        write_wav(base / "mix_clean" / f"mix{m}.wav", 0.6 * (a + b2) / peak, SR // 2)
    for backend, kernel in (("convtasnet", "tcn_masker"), ("mossformer", "gau_attention")):
        name = f"overlap_mvp --sep-backend {backend}"
        (out_dir, metrics), launches = _counted(
            torch, counters, ("fbank_power_mel", kernel), name, lambda: offline_overlap_mvp.main(
                ["--librimix-root", str(work / "librimix"), "--preset", "full", "--seed", "0",
                 "--osd-thr", "0.0", "--sep-backend", backend, "--enable-metrics",
                 "--out-dir", str(work / "out_mvp")]))
        add(launches)
        recs = [json.loads(x) for x in (out_dir / "segments.jsonl").read_text().splitlines()]
        # both branches of every overlap segment are transcribed
        assert recs and all(r["kind"] == "overlap" and r["stream"] in (0, 1) for r in recs), recs
        assert metrics["separated_streams"] == len(recs) >= 6 and metrics["total_audio_sec"] == 12.0
        log({"phase": "pipeline", "path": name, **metrics})

    # the MossFormer demo: one 8 kHz wav at the model's native rate -> int16 branches
    facades.set_default_engine(None)
    written, launches = _counted(
        torch, counters, ("gau_attention",), "mossformer_infer", lambda: mossformer_infer.main(
            [str(base / "mix_clean" / "mix2.wav"), "--preset", "full", "--out-dir",
             str(work / "out_infer")]))
    add(launches)
    facades.set_default_engine(None)
    assert len(written) == 2
    for path in written:
        wav, sr = read_wav(path)
        assert sr == 8000 and wav.shape == (5 * 8000,) and np.isfinite(wav).all() and wav.any()
    for k, n in total.items():
        assert n > 0, f"kernel {k} was not launched on any path"
    log({"phase": "launches", "path": "all", **total})
    return total


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
    from audio_classification_tpu_torch.ops.kernels.gau import gau_attention
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
               "flash_attention": check_attention(torch, np),
               "gau_attention": check_gau(torch, np)}
    check_small_input_against_cpu(torch, np)
    counters = {"fbank_power_mel": fbank_power_mel, "tcn_masker": fused_tcn_masker,
                "flash_attention": flash_attention, "gau_attention": gau_attention}
    launches = run_paths(torch, np, counters)

    meta = {
        "fbank_power_mel": ("audio_classification_tpu_torch/csrc/fbank_power_mel.cu",
                            "audio_classification_tpu/ops/pallas/fbank_kernel.py:95"),
        "tcn_masker": ("audio_classification_tpu_torch/csrc/tcn_masker.cu",
                       "audio_classification_tpu/ops/pallas/tcn_kernel.py:489"),
        "flash_attention": ("audio_classification_tpu_torch/csrc/flash_attention.cu",
                            "audio_classification_tpu/ops/pallas/attention_kernel.py:268"),
        "gau_attention": ("audio_classification_tpu_torch/csrc/gau_attention.cu",
                          "audio_classification_tpu/ops/pallas/attention_kernel.py:410"),
    }
    kernels = [{"name": name, "route": "cuda", "source": src, "replaces": rep,
                "launches": launches[name],
                **{k: results[name][k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms",
                                                 "bound_by", "library_ms")}}
               for name, (src, rep) in meta.items()]
    print(smi, flush=True)
    log({"kernels": kernels})
    log({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
