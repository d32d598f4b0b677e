#!/usr/bin/env python3
"""Smoke test of the PyTorch port (audio_classification_tpu_torch) on one
NVIDIA GPU: builds the CUDA kernels, holds each against its plain PyTorch
twin at the main paths' shapes (with its time, the twin's, the card's bound
for the same work and, for attention, one library call's time), checks the
full-preset stages on the card against the CPU, and drives the port's entry
points at the full preset, reading every kernel's launch count around each:

- the flagship 3-source target-speaker CLI, every segment forced to overlap,
  then every segment forced clean (Conv-TasNet-3: K1, K2, K3);
- the same CLI with --sep-backend mossformer, separation evaluation and the
  resource monitor on, on a mixture in the 8 s bucket (K1, K4);
- the 2-source MVP runner over a small synthetic Libri2Mix tree at 8 kHz,
  once per separation backend (resampler, K1, K2 / K4);
- the MossFormer demo on one 8 kHz wav (K4);
- the flagship CLI with --quant int8 on the 20 s mixture (K1, K3 and the
  masker's int8 weight stream K2-s8; the float K2 must stay unlaunched);
- the streaming application replaying a 12 s wav through its worker thread
  with --quant int8, and once more with --quant none (K1, K2-s8 / K2): every
  window fed must come out analysed, so no failure was swallowed;
- the multi-session server replaying 8 callers with --quant int8 (K1,
  K2-s8 at batch 8): every window of every session answered, none dropped;
  then two sessions at 8 and 16 kHz in one tick (the in-tick resampler);
- long-form transcription of a 200 s utterance (256 s bucket, 4271 encoder
  frames) through ASRRecognizer.transcribe(long_form=True): on an engine
  with a mesh of 4 shards on the one card (ring attention, K5 at 12 blocks x
  16 block pairs = 192 launches, K3 none) and on one without a mesh (K3 at
  T = 4271, 12 launches, K5 none), CTC logits and texts of the two compared;
  a 100 s utterance over 8 shards (268 frames a shard: the dense block);
- Separator.separate_long over 4 shards, Conv-TasNet-3 on a 20 s mixture and
  MossFormer on a 16 s one, against Separator.separate on the same engine;
- the flagship CLI with each other ASR family (--paraformer, the transducer
  greedy and with modified_beam_search, --whisper-encoder; seeded weights)
  on the 20 s mixture forced to overlap and forced clean (K1, K3; K3 at head
  dim 80 on the Paraformer path), the 200 s utterance through each family's
  long form (Paraformer also over 4 shards: K5 at D = 80), each family's
  device ops a call, and the SID product: benchmark_pipeline and
  speaker_id_vad_asr on 4 talkers x 2 enrollment wavs and 8 test wavs;
- pyannet-flagship: the flagship CLI on the 20 s mixture with
  --osd-checkpoint (a pyannote segmentation checkpoint at the published
  widths: PyanNet serves OSD), --sep-checkpoint (an asteroid Conv-TasNet at
  the preset's widths), --cmvn (an am.mvn of the LFR dim 560) and
  --profile-dir, forced through the hysteresis flags to every frame
  overlapped (K1, K2, K3) and to every frame clean (K1, K3); the
  torch.profiler trace must name the engine's stage ranges.

- --compute-dtype bfloat16: the flagship CLI forced to overlap and to clean
  (the masker's bf16 entry point K2 bf16), with --sep-backend mossformer
  (K4 bf16 in the first GAU layer, K4 float32 in the seven after it) and
  with --quant int8 (K2-s8 bf16), a 6 s replay of the streaming application
  and one serving tick of two sessions under --quant int8; the float32
  masker entry points must stay unlaunched on these paths.

- --compute-dtype bfloat16 beyond the flagship: the flagship CLI with each
  other ASR family and with PyanNet serving OSD, forced to overlap (K2 bf16,
  K3 float32: the encoders' float32 positional tables promote their
  streams, as in JAX); the 200 s utterance on bf16 engines over 4 shards
  (K5 float32, 192 launches) and without a mesh (K3 float32), SenseVoice
  and Paraformer, texts equal; K3 / K5's bf16 entry points stay unlaunched
  on all of these, and are reached through the op entry and through the
  ring of 4 on bf16 q, k, v (16 K5 bf16 launches).

- training: each kernel's autograd Function (the kernel's forward, the
  twin's backward) against autograd through the float64 twin at the
  training shapes, with its forward + backward time (K3 beside SDPA's);
  then train_separator (MossFormer at EnginePreset's widths on 4 s crops at
  8 kHz, 8 K4 launches a step, resumed; Conv-TasNet at the flagship's
  widths, the dense loop: no K2), train_asr (SenseVoice 512 / 8 / 12 on
  32 s wavs: K1, K3; resumed; with --seq-parallel over 4 shards on 124 s
  wavs: K5 192 launches a forward) and train_speaker (the serving
  embedder's widths: K1) through their main(), each model's one step on the
  card against the CPU, and the exports served by the flagship CLI
  (--sep-checkpoint, --spk-embed-model) and Separator(checkpoint=).

- slice 14b: the quality-gate CLI at --steps-scale 0.05 (all four stages
  trained on the synthetic world, then the flagship with real SV gating on
  2 held-out scenes: K1, and K2 at the world's widths C 64 / H 128), its
  artifact's keys those of the JAX package's QUALITY_r05.json; distill_osd
  at the full preset on 4 s synthetic crops, then with a pyannote teacher at
  the published widths (K1), its output loaded through --osd-checkpoint
  into build_engine and the flagship CLI; and the native host codecs (the
  C++ WAV codec and ring buffer against their numpy versions, host only).

- slice 15, ONNX (files in a temporary directory): the port's exporters
  write every stage of the full-preset pack (SenseVoice float and int8);
  the flagship CLI serves a SenseVoice graph (runtime textnorm input) and
  the speaker export mapped onto the modules (--onnx-exec map: records equal
  to the same CLI on the same weights from a checkpoint directory) and run
  whole by the graph executor (direct: texts equal, K3 unlaunched in the
  ASR stage, the logits' error against K3 stated); the int8 export through
  the executor on the card against the CPU (the first MatMulInteger's int32
  accumulators equal); speaker_id_vad_asr with --silero-vad-model vad.onnx;
  the Paraformer, transducer (greedy, beam) and whisper direct stages on
  fixture graphs at the preset's widths; convert_models --verify,
  export_models, and distill_asr at the full SenseVoice widths from the
  exported teacher (K1, K3; losses falling).

- slice 16, the mesh paths (``mesh_paths``; the lease has one card and NCCL
  refuses two ranks on one card, so traffic between ranks is tested over gloo
  on the CPU): the flagship overlap scene on a DP 4 and a DP 2 x TP 2 mesh of
  entries on the one card (K1, K2 / the TP dense loop, K3), then both under
  NCCL with a world of 1, records equal to the meshless run's; the 200 s
  utterance over a ring of 4 under NCCL (K5 192 launches) and ring attention
  on the ring's blocks; MossFormer at TP 2 (K4 on v's 384 columns), K4 at
  De 384 and 192 against its twin; both separators at TP 2 in bfloat16
  against the meshless bfloat16 engine; one DP 2 x TP 2 SeparatorTrainer step in
  float64 against the meshless step; dryrun_multichip(2).

- slice 19, the program statistics (``program_stats``; engine/programs.py):
  four tiny-preset scenes on the card and on the CPU (the flagship's stages
  with both backends: K1, K2, K4; 32 s buckets: K3; transcribe_long over 4
  shards: K5; PyanNet serving OSD: its LSTMs) record the same programs,
  keys, calls, flops and bytes; the full-preset flagship overlap scene's
  programs with their work and first-call seconds, one warm pass's work
  over its compute seconds against the dense bf16 and float32 peaks, the
  warm pass's device operations equal to those with the registry taken
  out, a second input of another length (18 s) calling the same programs
  with no new count, and the first pass counted again with the module memo
  off (``ops/work.shape_keyed``) to the same work. Every kernel case's
  flops, exponentials and bytes come from its kernel's ``work()``.

The bf16 entry points are held to their bf16 twins and to the twins run in
float64 (the same rounding points) at the float phases' shapes, timed by
graph replay beside the float32 entry points (K3 / K5 bf16 beside SDPA at
bf16 too), and the full-preset stages of a bf16 engine on the card are held
to the same bf16 engine on the CPU: the flagship's stages, each other
family's recognizer (encoder outputs and token ids, greedy and beam),
PyanNet and SenseVoice over a mesh of 4.

K2 is also held to its twin and its float64 twin at the quality gate's
world widths (8 blocks, C 64, H 128, B 4 ragged). K3 and K5 are also held
to their float64 twin at the head dims beside 64
(Paraformer's 80 at its main shapes, 128, and 40, which the wrapper pads;
192 and 256 on the wide body, and 200, which it pads to 256), each family's
recognizer on the card to the same weights on the CPU, and PyanNet at its
published widths on the card to the CPU.

    python3 chip_smoke.py

One JSON object per phase on stdout, then the card's nvidia-smi name and
power limit, the per-kernel summary, and last
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
Exits non-zero, printing no result, without a CUDA device or outside a
checkout of the repository. Needs no JAX and no network.
"""
from __future__ import annotations

import dataclasses
import json
import math
import re
import shutil
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SR = 16000
# NVIDIA H100 SXM data sheet: float32 outside the tensor cores (K1's FFT is
# IEEE float32; its bound is the bytes) and HBM3 bandwidth
PEAK_F32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12
# K2 / K2-s8 and K3 / K4 / K5 run their products on the tensor cores in
# 3xTF32: three TF32 products per float32 product at the data sheet's dense
# TF32 rate
# (495 TFLOP/s, H100 SXM); their exponentials go through the special function
# units, 16 results per SM per clock (CUDA C++ Programming Guide, throughput
# of native arithmetic instructions, compute capability 9.0) on 132 SMs at
# 1.83 GHz, the clock behind the data sheet's tensor rates
PEAK_3XTF32_FLOPS = 495e12 / 3
PEAK_SFU_PER_S = 16 * 132 * 1.83e9
# the bf16 entry points of K2 / K2-s8 / K4: one bf16 tensor-core product per
# product, at the data sheet's dense bf16 rate (989 TFLOP/s, H100 SXM)
PEAK_BF16_FLOPS = 989e12
# the long-form path: a 200 s utterance snaps to the 256 s bucket, whose
# (256 * SR - 400) // 160 + 1 = 25598 fbank frames make ceil(25598 / 6) = 4267
# LFR frames + 4 prompt frames; 4 shards pad that to 4 x 1068. The utterance's
# own 19998 fbank frames make 3333 + 4 valid encoder frames.
LONG_SEC, LONG_T, LONG_VALID_T, LONG_SHARDS = 200, 4271, 3337, 4


def bound(flops: float, nbytes: float) -> dict:
    """The least time the card could take: the larger of operations over the
    float32 peak and bytes (inputs read once, outputs written once) over the
    memory rate."""
    by_ops, by_bytes = flops / PEAK_F32_FLOPS * 1e3, nbytes / PEAK_BYTES_PER_S * 1e3
    return {"bound_ms": max(by_ops, by_bytes),
            "bound_by": "operations" if by_ops >= by_bytes else "bytes",
            "flops": flops, "bytes": nbytes}


def tensor_bound(flops: float, exps: float, nbytes: float) -> dict:
    """K2 / K2-s8 / K3 / K4 / K5: the larger of the products at the 3xTF32
    tensor-core rate, the exponentials at the SFU rate (K2 and K4 have none)
    and the bytes; beside it the float32 SIMT figure (``bound_simt_ms``)
    that the kernel's earlier SIMT design was held to, so that its times
    compare with the new ones."""
    terms = {"tensor_3xtf32": flops / PEAK_3XTF32_FLOPS * 1e3,
             "sfu_exp": exps / PEAK_SFU_PER_S * 1e3,
             "bytes": nbytes / PEAK_BYTES_PER_S * 1e3}
    term = max(terms, key=terms.get)
    return {"bound_ms": terms[term], "bound_by": "bytes" if term == "bytes" else "operations",
            "bound_term": term, "bound_simt_ms": bound(flops, nbytes)["bound_ms"],
            "flops": flops, "exps": exps, "bytes": nbytes}


def _terms(work: dict) -> tuple:
    """A kernel's ``work()`` count as the bound functions take it: (flops,
    exps, bytes)."""
    return work["flops"], work.get("exps", 0.0), work["bytes"]


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


def graph_ms(torch, fn, iters: int) -> float:
    """Mean device milliseconds of fn, its iters calls captured in one CUDA
    graph and replayed: the kernels fn launches without the host time of
    its Python (checks, allocations, dispatch). A batch-1 attention kernel
    runs for less than that host time, so ``cuda_ms`` of a loop of calls
    times the host; K3, K5, their twins and SDPA are timed both ways."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # warm-up off the capture, as capture asks
        for _ in range(2):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    end.synchronize()
    del graph
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


def _fbank_bounds(n: int, n_fft: int, nb: int, bases) -> dict:
    """K1's bound: its ``work()`` (the FFT's float32 operations against the
    bytes of frames in, log-mel out and the kernel's constants; the bytes
    bind); beside it the bound of the DFT as a GEMM that the kernel replaced
    (``bound_dft_ms``)."""
    from audio_classification_tpu_torch.ops.kernels import fbank as k_fbank

    n_bins = n_fft // 2 + 1
    w = k_fbank.work(n, n_fft, nb, bases.mel_nnz, bases.band_w.shape[0])
    fft = bound(w["flops"], w["bytes"])
    dft_bytes = 4.0 * (n * n_fft + 2 * n_fft * n_bins + n_bins * nb + n * nb)
    dft = bound(2.0 * n * n_fft * 2 * n_bins + 2.0 * n * n_bins * nb, dft_bytes)
    return {**fft, "bound_dft_ms": dft["bound_ms"]}


def _fbank_case(torch, frames, cfg, iters: int) -> dict:
    """One K1 shape: errors against the float32 twin and the float64 twin,
    the repeat call's bits, device ms (CUDA events over a loop of calls and
    by CUDA-graph replay), the twin's, cuFFT's rfft of the same frames (the
    port never calls it) and the bounds."""
    from audio_classification_tpu_torch.ops import fbank
    from audio_classification_tpu_torch.ops.kernels import fbank as k_fbank

    bases = fbank.fbank_bases(cfg, frames.device)
    twin = (bases.cos_b, bases.msin_b, bases.mel_w)

    def k1():
        return k_fbank.fbank_power_mel(frames, bases, cfg.log_floor)

    out, again = k1(), k1()
    torch.cuda.synchronize()
    assert torch.equal(out, again), "K1: a repeat call changed bits"
    ref = k_fbank.fbank_power_mel_reference(frames, *twin, cfg.log_floor)
    ref64 = k_fbank.fbank_power_mel_reference(frames.double(), *(t.double() for t in twin),
                                              cfg.log_floor)
    active, active64 = ref > ref.max() - 15.0, ref64 > ref64.max() - 15.0
    err, err64, twin_err64 = (out - ref).abs(), (out - ref64).abs(), (ref - ref64).abs()
    n, n_fft = frames.shape
    case = {"shape": list(frames.shape), "num_bins": cfg.num_bins,
            "max_abs_err": err.max().item(), "max_abs_err_active": err[active].max().item(),
            "tol_active": 5e-4, "tol": 5e-3,
            "err64": err64.max().item(), "err64_active": err64[active64].max().item(),
            "twin32_err64": twin_err64.max().item(),
            "twin32_err64_active": twin_err64[active64].max().item(),
            "repeat_identical": True,
            "ms": cuda_ms(torch, k1, iters), "graph_ms": graph_ms(torch, k1, iters),
            "plain_ms": cuda_ms(torch, lambda: k_fbank.fbank_power_mel_reference(
                frames, *twin, cfg.log_floor), iters),
            "rfft_ms": cuda_ms(torch, lambda: torch.fft.rfft(frames, dim=-1), iters),
            "library_ms": None}
    case["tol64_active"] = max(1e-4, 4.0 * case["twin32_err64_active"])
    case["tol64"] = max(5e-3, 4.0 * case["twin32_err64"])
    case.update(_fbank_bounds(n, n_fft, cfg.num_bins, bases))
    case["share_of_bound"] = case["bound_ms"] / case["ms"]
    return case


def check_fbank(torch, np) -> dict:
    """K1 against its twins on the frames of 8 x 32 s buckets (8 x 3198 x 512),
    then at the serving tick's and the streaming block's shapes (2 s windows
    of 198 frames: 8 and 24 of them in a tick, 1 and 3 in a block) and at
    n_fft 1024 (the 64 ms, 128-bin config) on the same 8 x 32 s."""
    from torch.profiler import ProfilerActivity, profile

    from audio_classification_tpu_torch.ops import fbank
    from audio_classification_tpu_torch.ops.kernels import fbank as k_fbank

    dev = torch.device("cuda")
    cfg = fbank.FbankConfig()
    mix = sum(talkers(32 * SR, 1)) * 0.2
    wav = torch.from_numpy(np.stack([np.roll(mix, 997 * i) for i in range(8)])).to(dev)
    frames = fbank.windowed_frames(wav, cfg).reshape(-1, cfg.n_fft).contiguous()
    k1 = _fbank_case(torch, frames, cfg, 20)
    # device ops of one call (the kernel and nothing else: no memset, no
    # second launch)
    bases = fbank.fbank_bases(cfg, frames.device)  # uploaded by the case above
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        k_fbank.fbank_power_mel(frames, bases, cfg.log_floor)
        torch.cuda.synchronize()
    ops = [ev.name for ev in prof.events() if ev.device_type == torch.autograd.DeviceType.CUDA]
    k1["device_ops_per_call"], k1["device_op_names"] = len(ops), ops
    small = {}
    for name, windows in (("serving_osd", 8), ("serving_streams", 24), ("streaming", 1),
                          ("streaming_streams", 3)):
        win = wav[:, :2 * SR].repeat(windows // 8 + 1, 1)[:windows]
        small[name] = _fbank_case(torch, fbank.windowed_frames(win, cfg).reshape(
            -1, cfg.n_fft).contiguous(), cfg, 200)
    cfg64 = fbank.FbankConfig(frame_length_ms=64.0, num_bins=128)
    small["n_fft_1024"] = _fbank_case(torch, fbank.windowed_frames(wav, cfg64).reshape(
        -1, cfg64.n_fft).contiguous(), cfg64, 20)
    k1["shapes"] = small
    log({"phase": "kernel", "name": "fbank_power_mel", **k1})
    # the float32 twin sums 512 taps in another order (cuBLAS) and neither
    # it nor the FFT is uniformly closer to float64: held to the float64
    # twin within max(1e-4, 4 x the float32 twin's own error) on bins within
    # 15 nats of the peak (max(5e-3, 4 x) on all), and at n_fft 512 to the
    # float32 twin as before
    for case in (k1, *small.values()):
        assert case["err64_active"] <= case["tol64_active"] and case["err64"] <= case["tol64"], case
        if case["shape"][1] == 512:
            assert case["max_abs_err_active"] <= 5e-4 and case["max_abs_err"] <= 5e-3, case
    assert k1["device_ops_per_call"] == 1, k1["device_ops_per_call"]
    return k1


def _tcn_case(torch, tcn, st, x, f_len, n_per_repeat, iters) -> tuple:
    """One K2 / K2-s8 call at a main-path shape against its twin: error on
    valid rows relative to max|skips| there, padded rows exact zeros, a
    repeat call bit-identical; times of the kernel and its twin; the bound
    over the valid frames; the device operations of one call."""
    out = tcn.fused_tcn_masker(x, f_len, st, n_per_repeat=n_per_repeat)
    again = tcn.fused_tcn_masker(x, f_len, st, n_per_repeat=n_per_repeat)
    torch.cuda.synchronize()
    ref = tcn.tcn_masker_reference(x, f_len, st, n_per_repeat=n_per_repeat)
    b, f, c = x.shape
    valid = (torch.arange(f, device=x.device)[None, :] < f_len[:, None])[..., None]
    err = ((out - ref).abs() * valid).max().item()
    lens = f_len.tolist()
    case = {"shape": [b, f, c], "f_len": lens, "max_abs_err": err,
            "rel_err": err / (ref.abs() * valid).max().item(), "tol_rel": 1e-4,
            "padded_rows_zero": not (out * ~valid).any().item(),
            "repeat_identical": torch.equal(out, again),
            "ms": cuda_ms(torch, lambda: tcn.fused_tcn_masker(x, f_len, st,
                                                              n_per_repeat=n_per_repeat), iters),
            "plain_ms": cuda_ms(torch, lambda: tcn.tcn_masker_reference(
                x, f_len, st, n_per_repeat=n_per_repeat), iters),
            "library_ms": None}  # no single PyTorch call computes the masker
    nb, _, hd = st["w_in"].shape
    # over the VALID frames (rows past f_len are padding that the kernel
    # never computes), the weights at their own width
    case.update(tensor_bound(*_terms(tcn.work(
        b, f, c, hd, nb, sum(t.numel() * t.element_size() for t in st.values()), f_len=lens))))
    case["share"] = case["bound_ms"] / case["ms"]
    case["share_simt"] = case["bound_simt_ms"] / case["ms"]
    case["device_ops_per_call"] = queued_ops(torch, lambda: tcn.fused_tcn_masker(
        x, f_len, st, n_per_repeat=n_per_repeat))
    # 3xTF32 through 24 residual blocks (~6e-6 measured), another summation
    # order in every 128/512-wide contraction and in the F x H gLN reductions;
    # one plain TF32 product (~7.6e-4) fails it
    assert math.isfinite(err) and case["rel_err"] <= 1e-4, case
    assert case["padded_rows_zero"] and case["repeat_identical"], case
    return case, out


def check_tcn(torch, np) -> dict:
    """K2 against its twin on the full-preset masker (seeded weights) at the
    main paths' shapes: the flagship B=1, F=31999 (a 32 s bucket) with the
    f_len of a 20 s segment; the streaming window B=1, F=1999, all valid;
    and 8 sessions' 2 s windows B=8, F=1999 with a ragged f_len (the
    server's shape, run here on the float stack)."""
    from audio_classification_tpu_torch.engine.runtime import EnginePreset, ModelPack
    from audio_classification_tpu_torch.ops.kernels import tcn

    dev = torch.device("cuda")
    gen = torch.Generator(device="cpu").manual_seed(0)
    model = ModelPack(EnginePreset(), seed=0, device=dev).models["sep3"]
    st = tcn.stack_tcn_params(model.tcn_blocks())
    f32, f2 = (32 * SR - 32) // 16 + 1, (2 * SR - 32) // 16 + 1
    cases = []
    for b, f, lens, iters in ((1, f32, [(20 * SR - 32) // 16 + 1], 10), (1, f2, [f2], 20),
                              (8, f2, [f2, f2, 1500, f2, 1000, f2, 750, f2], 20)):
        x = torch.randn((b, f, 128), generator=gen).to(dev)
        f_len = torch.tensor(lens, dtype=torch.int32, device=dev)
        case, out = _tcn_case(torch, tcn, st, x, f_len, 8, iters)
        case.update(_f64_err(torch, tcn, st, x, f_len, 8, out))
        log({"phase": "kernel", "name": "tcn_masker", **case})
        assert math.isfinite(case["rel_err_f64"]) and case["rel_err_f64"] <= 1e-4, case
        cases.append(case)
    cases.append(_check_tcn_world(torch, tcn, gen))
    return {**cases[0], "max_abs_err": max(c_["max_abs_err"] for c_ in cases), "cases": cases}


def _check_tcn_world(torch, tcn, gen) -> dict:
    """K2 at the quality gate's world separator (pipelines/quality_gate
    .world_configs: 8 blocks of C 64 / H 128, 4 a repeat): 4 rows of the 4 s
    bucket (F = 7999) with a ragged f_len, the shape of the gate's
    calibration and scene segments. Held to the float32 twin (_tcn_case) and
    to the twin run in float64, both within 1e-4 of max|ref| on valid rows."""
    from audio_classification_tpu_torch.engine.runtime import ModelPack
    from audio_classification_tpu_torch.pipelines.quality_gate import world_configs

    dev = torch.device("cuda")
    preset, tokens = world_configs()
    cfg = preset.sep3
    model = ModelPack(preset, seed=0, tokens=tokens, device=dev).models["sep3"]
    st = tcn.stack_tcn_params(model.tcn_blocks())
    f = (4 * SR - cfg.enc_kernel) // cfg.stride + 1
    x = torch.randn((4, f, cfg.bottleneck), generator=gen).to(dev)
    f_len = torch.tensor([f, 5999, 3999, 2373], dtype=torch.int32, device=dev)
    case, out = _tcn_case(torch, tcn, st, x, f_len, cfg.n_blocks, 20)
    case.update({"world": "quality gate", "blocks": int(st["w_in"].shape[0]),
                 "C": cfg.bottleneck, "H": cfg.hidden,
                 **_f64_err(torch, tcn, st, x, f_len, cfg.n_blocks, out)})
    log({"phase": "kernel", "name": "tcn_masker", **case})
    assert (case["blocks"], case["C"], case["H"]) == (8, 64, 128), case
    assert math.isfinite(case["rel_err_f64"]) and case["rel_err_f64"] <= 1e-4, case
    return case


def _f64_err(torch, tcn, st, x, f_len, n_per_repeat, out) -> dict:
    """K2's output against the float stack's twin run in float64, on valid
    rows: the absolute error and its share of max|ref|."""
    st64 = {k: v.double() for k, v in st.items()}
    ref64 = tcn.tcn_masker_reference(x.double(), f_len, st64, n_per_repeat=n_per_repeat)
    valid = (torch.arange(x.shape[1], device=x.device)[None, :] < f_len[:, None])[..., None]
    err64 = ((out.double() - ref64).abs() * valid).max().item()
    return {"max_abs_err_f64": err64, "rel_err_f64": err64 / (ref64.abs() * valid).max().item()}


def check_tcn_s8(torch, np) -> dict:
    """K2-s8 (the masker's int8 weight stream) against its twin on the
    dequantised stack, and against the float kernel on that stack, at the
    main-path shape (B=1, F=31999, f_len of a 20 s segment) and at the
    serving shape (8 sessions' 2 s windows: B=8, F=1999, ragged f_len)."""
    from audio_classification_tpu_torch.engine.runtime import EnginePreset, ModelPack
    from audio_classification_tpu_torch.ops.kernels import tcn

    dev = torch.device("cuda")
    gen = torch.Generator(device="cpu").manual_seed(5)
    model = ModelPack(EnginePreset(), seed=0, device=dev).models["sep3"]
    st = tcn.stack_tcn_params(model.tcn_blocks(), weight_quant=True)
    assert st["w_in"].dtype == torch.int8 and tuple(st["vecs"].shape[1:]) == (10, 512)
    deq = tcn.dequant_stack(st)
    nb, c, hd = st["w_in"].shape
    f32, f2 = (32 * SR - 32) // 16 + 1, (2 * SR - 32) // 16 + 1
    cases = []
    for b, f, lens, iters in ((1, f32, [(20 * SR - 32) // 16 + 1], 10),
                              (8, f2, [f2, f2, 1500, f2, 1000, f2, 750, f2], 20)):
        x = torch.randn((b, f, c), generator=gen).to(dev)
        f_len = torch.tensor(lens, dtype=torch.int32, device=dev)
        case, out = _tcn_case(torch, tcn, st, x, f_len, 8, iters)
        flt = tcn.fused_tcn_masker(x, f_len, deq, n_per_repeat=8)
        # the same products in the same order on bit-identical weights
        case["max_abs_diff_vs_float_kernel"] = (out - flt).abs().max().item()
        case["float_kernel_ms"] = cuda_ms(torch, lambda: tcn.fused_tcn_masker(
            x, f_len, deq, n_per_repeat=8), iters)
        log({"phase": "kernel", "name": "tcn_masker_s8", **case})
        assert case["max_abs_diff_vs_float_kernel"] == 0.0, case
        cases.append(case)
    return {**cases[0], "max_abs_err": max(c_["max_abs_err"] for c_ in cases), "cases": cases}


def check_attention(torch, np) -> dict:
    """K3 against its twin: SenseVoice on a 32 s clean span (T=537, 8 heads)
    at batch 8 and at the file-mode pipeline's batch 1, OSDNet on a 32 s
    bucket (T=800, 4 heads), ragged key masks; the batch-8 shape again with
    holes in the masks (valid keys after key tiles masked whole, which the
    kernel skips); and the long-form path's shape, SenseVoice on a 200 s
    utterance in the 256 s bucket (T=4271, the first 3337 keys valid)."""
    from audio_classification_tpu_torch.ops.kernels import attention

    dev = torch.device("cuda")
    gen = torch.Generator(device="cpu").manual_seed(1)
    cases = []
    for b, h, t, valid, holes in ((8, 8, 537, None, False), (1, 8, 537, None, False),
                                  (1, 4, 800, None, False), (8, 8, 537, None, True),
                                  (1, 8, LONG_T, LONG_VALID_T, False)):
        q, k, v = (torch.randn((b, h, t, 64), generator=gen).to(dev) for _ in range(3))
        lens = torch.tensor([valid or t - 97 * i % t for i in range(b)], device=dev)
        keys = torch.arange(t, device=dev)[None, :]
        mask = keys < lens[:, None]
        if holes:  # the two first 64-key tiles of every other item and keys 256-319 of all
            even = (torch.arange(b, device=dev) % 2 == 0)[:, None]
            mask &= ~((keys < 128) & even) & ~((keys >= 256) & (keys < 320))
        out = attention.flash_attention(q, k, v, mask)
        torch.cuda.synchronize()
        ref = attention.attention_reference(q, k, v, mask)
        rows = mask[:, None, :, None]
        err = ((out - ref).abs() * rows).max().item()
        # the twin in float64 too: the float32 twin adds its own error
        ref64 = attention.attention_reference(q.double(), k.double(), v.double(), mask)
        err64 = ((out - ref64.float()).abs() * rows).max().item()
        sdpa_mask = mask[:, None, None, :]
        n_valid = int(mask.sum())
        k3 = lambda: attention.flash_attention(q, k, v, mask)  # noqa: E731
        twin = lambda: attention.attention_reference(q, k, v, mask)  # noqa: E731
        # yardstick only: the port never calls it
        sdpa = lambda: torch.nn.functional.scaled_dot_product_attention(  # noqa: E731
            q, k, v, attn_mask=sdpa_mask)
        # device time (graph replay) in ms, plain_ms, library_ms; each call
        # through Python (the host's time where it is the longer) beside
        cases.append({"shape": [b, h, t, 64], "valid_keys": n_valid, "mask_holes": holes,
                      "max_abs_err": err, "max_abs_err_vs_float64_twin": err64,
                      "device_ops_per_call": queued_ops(torch, k3),
                      "ms": graph_ms(torch, k3, 20), "plain_ms": graph_ms(torch, twin, 20),
                      "library_ms": graph_ms(torch, sdpa, 20),
                      "wrapper_ms": cuda_ms(torch, k3, 20),
                      "plain_eager_ms": cuda_ms(torch, twin, 20),
                      "library_eager_ms": cuda_ms(torch, sdpa, 20),
                      # over the valid keys: a masked key adds exp(-1e9) = 0,
                      # and k, v are read for the valid keys alone
                      **tensor_bound(*_terms(attention.work(
                          b, h, t, t, 64, valid_keys=mask.sum(1).tolist())))})
        cases[-1]["ms_over_library_ms"] = cases[-1]["ms"] / cases[-1]["library_ms"]
        cases[-1]["wrapper_ms_over_library_eager_ms"] = (cases[-1]["wrapper_ms"]
                                                         / cases[-1]["library_eager_ms"])
        log({"phase": "kernel", "name": "flash_attention", **cases[-1], "tol": 2e-5})
        # f32 softmax over <= 4271 keys with O(1) outputs; padded query rows
        # are discarded downstream and not compared
        assert err <= 2e-5 and err64 <= 2e-5, cases[-1]
    return {**cases[0], "max_abs_err": max(c["max_abs_err"] for c in cases), "cases": cases}


def check_attention_stats(torch, np) -> dict:
    """K5 against its twin at the long-form path's shapes (one shard's 1068
    queries of the 256 s bucket against a whole valid key block, and against
    the block that holds the utterance's end: 133 keys valid) and at a ragged
    batch with Tq != Tk off both tiles; then the ring of 4 over
    [1, 4272, 8, 64] merged, against K3 at the same T and the dense oracle."""
    from audio_classification_tpu_torch.ops.kernels import attention
    from audio_classification_tpu_torch.parallel.mesh import make_mesh
    from audio_classification_tpu_torch.parallel.ring_attention import (
        reference_attention,
        ring_attention,
    )

    dev = torch.device("cuda")
    gen = torch.Generator(device="cpu").manual_seed(7)
    ts = -(-LONG_T // LONG_SHARDS)
    cases = []
    for b, h, tq, tk, lens in ((1, 8, ts, ts, [ts]),
                               (1, 8, ts, ts, [LONG_VALID_T - 3 * ts]),
                               (3, 8, 537, 1068, [1068, 300, 33])):
        q = torch.randn((b, h, tq, 64), generator=gen).to(dev)
        k, v = (torch.randn((b, h, tk, 64), generator=gen).to(dev) for _ in range(2))
        mask = torch.arange(tk, device=dev)[None, :] < torch.tensor(lens, device=dev)[:, None]
        o, m, l = attention.flash_attention_stats(q, k, v, mask)
        torch.cuda.synchronize()
        ro, rm, rl = attention.attention_stats_reference(q, k, v, mask)
        err_o = (o - ro).abs().max().item()
        peak = ro.abs().max().item()
        err_m = ((m - rm).abs() / rm.abs().clamp_min(1.0)).max().item()
        err_l = ((l - rl).abs() / rl.abs()).max().item()
        # and against the twin in float64 (the float32 twin adds its own error)
        xo, xm, xl = (x.float() for x in attention.attention_stats_reference(
            q.double(), k.double(), v.double(), mask))
        err64 = {"rel_err_vs_float64_twin": (o - xo).abs().max().item() / xo.abs().max().item(),
                 "m_rel_err_vs_float64_twin":
                     ((m - xm).abs() / xm.abs().clamp_min(1.0)).max().item(),
                 "l_rel_err_vs_float64_twin": ((l - xl).abs() / xl.abs()).max().item()}
        sdpa_mask = mask[:, None, None, :]
        k5 = lambda: attention.flash_attention_stats(q, k, v, mask)  # noqa: E731
        twin = lambda: attention.attention_stats_reference(q, k, v, mask)  # noqa: E731
        sdpa = lambda: torch.nn.functional.scaled_dot_product_attention(  # noqa: E731
            q, k, v, attn_mask=sdpa_mask)
        cases.append({
            "shape": [b, h, tq, 64], "keys": tk, "valid_keys": lens, "max_abs_err": err_o,
            "rel_err": err_o / peak, "tol_rel": 1e-4, "m_rel_err": err_m, "l_rel_err": err_l,
            "tol_ml_rel": 1e-5, **err64, "device_ops_per_call": queued_ops(torch, k5),
            # device time (graph replay); through Python beside, as for K3
            "ms": graph_ms(torch, k5, 20), "plain_ms": graph_ms(torch, twin, 20),
            "wrapper_ms": cuda_ms(torch, k5, 20), "plain_eager_ms": cuda_ms(torch, twin, 20),
            # no single PyTorch call returns the unnormalised float32 triple
            # (o, m, l): scaled_dot_product_attention returns the normalised
            # output alone. Its time on the same q, k, v is written beside,
            # as a yardstick of another function
            "library_ms": None,
            "sdpa_ms_same_inputs": None if tq != tk else graph_ms(torch, sdpa, 20),
            "sdpa_eager_ms_same_inputs": None if tq != tk else cuda_ms(torch, sdpa, 20),
            # over the valid keys, as the operations: k and v are read for
            # them alone (a tile with none is skipped)
            **tensor_bound(*_terms(attention.stats_work(b, h, tq, tk, 64, valid_keys=lens)))})
        if len(cases) == 2:
            # the 133-valid block against the full one: 3 of its 17 key tiles
            # hold a valid key, the other 14 are skipped. Recorded, not
            # asserted: times are noisy
            cases[-1]["ms_share_of_full_block"] = cases[-1]["ms"] / cases[0]["ms"]
        log({"phase": "kernel", "name": "flash_attention_stats", **cases[-1]})
        # float32 accuracy on both sides (the kernel in 3xTF32 on the tensor
        # cores, tile by tile; the twin in cuBLAS's blocked f32 order). m is a
        # maximum of products that differ by rounding alone
        assert math.isfinite(err_o) and err_o <= 1e-4 * peak, cases[-1]
        assert err_m <= 1e-5 and err_l <= 1e-5, cases[-1]
        assert err64["rel_err_vs_float64_twin"] <= 1e-4, cases[-1]
        assert err64["m_rel_err_vs_float64_twin"] <= 1e-5, cases[-1]
        assert err64["l_rel_err_vs_float64_twin"] <= 1e-5, cases[-1]

    # the ring as the long-form encoder calls it: 4 shards of 1068 frames on
    # this card, the keys past the utterance's end masked (the last shard
    # holds 133 valid keys). 16 K5 launches and 12 merges against one K3 call
    t = ts * LONG_SHARDS
    q, k, v = (torch.randn((1, t, 8, 64), generator=gen).to(dev) for _ in range(3))
    mask = (torch.arange(t, device=dev) < LONG_VALID_T)[None, :]
    mesh = make_mesh(LONG_SHARDS, devices=[dev] * LONG_SHARDS)
    qh, kh, vh = (z.transpose(1, 2).contiguous() for z in (q, k, v))
    before = attention.flash_attention_stats.launches
    out = ring_attention(q, k, v, mesh, kv_mask=mask)
    torch.cuda.synchronize()
    assert attention.flash_attention_stats.launches - before == LONG_SHARDS ** 2
    k3 = attention.flash_attention(qh, kh, vh, mask).transpose(1, 2)
    ref = reference_attention(q, k, v, mask)
    rows = mask[:, :, None, None]
    ring = {"shape": [1, t, 8, 64], "shards": LONG_SHARDS, "valid_keys": LONG_VALID_T,
            "max_abs_err_vs_oracle": ((out - ref).abs() * rows).max().item(),
            "max_abs_diff_vs_flash_attention": ((out - k3).abs() * rows).max().item(),
            "tol": 2e-5,
            "ring_ms": cuda_ms(torch, lambda: ring_attention(q, k, v, mesh, kv_mask=mask), 10),
            "flash_attention_ms": cuda_ms(
                torch, lambda: attention.flash_attention(qh, kh, vh, mask), 10),
            "oracle_ms": cuda_ms(torch, lambda: reference_attention(q, k, v, mask), 10)}
    log({"phase": "ring_attention", **ring})
    assert ring["max_abs_err_vs_oracle"] <= 2e-5, ring
    assert ring["max_abs_diff_vs_flash_attention"] <= 2e-5, ring
    return {**cases[0], "max_abs_err": max(c["max_abs_err"] for c in cases), "cases": cases,
            "ring": ring}


# Paraformer (dim 320, 4 heads: D = 80) on the same 200 s utterance: the 256 s
# bucket's 25598 fbank frames make ceil(25598 / 6) = 4267 LFR frames, 3333 of
# them valid; 4 shards pad that to 4 x 1067, and the last block holds 132
PF_LONG_T, PF_LONG_VALID_T = 4267, 3333


def check_attention_head_dims(torch, np) -> dict:
    """K3 and K5 at the head dims beside 64: Paraformer's D = 80 on its 32 s
    bucket ([1, 4, 533, 80]), on the 200 s utterance's 256 s bucket
    ([1, 4, 4267, 80], 3333 keys valid) and, for K5, on one shard's
    1067-frame block of it (all keys valid, and the last block's 132); one
    small ragged case at D = 128 and one at D = 40, which the wrapper
    zero-pads to the instance at 64; and the wide body above 128 (no model
    of the repository has such a head; the JAX kernels take any D): D = 192
    and 256 at OSDNet's T = 800 and on a shard's 1067-key block, and D = 200
    zero-padded to 256, ragged. Each against the twin in float64 (K3 2e-5
    abs, K5's o 1e-4 of max|o|, m and l 1e-5 relative, as at D = 64), with
    the kernel's device time, the float32 twin's and SDPA's by graph replay,
    and the bound for the true D (the wide body forms the scores once for
    each 128-column slice of the output: ``bound_with_recompute_ms`` counts
    the products it does)."""
    from audio_classification_tpu_torch.ops.kernels import attention

    dev = torch.device("cuda")
    gen = torch.Generator(device="cpu").manual_seed(80)
    ts = -(-PF_LONG_T // LONG_SHARDS)
    k3, k5 = [], []
    for kind, b, h, tq, tk, d, lens in (
            ("K3", 1, 4, 533, 533, 80, [533]),
            ("K3", 1, 4, PF_LONG_T, PF_LONG_T, 80, [PF_LONG_VALID_T]),
            ("K3", 2, 4, 200, 200, 128, [200, 77]),
            ("K3", 2, 4, 300, 300, 40, [300, 129]),
            ("K3", 1, 4, 800, 800, 192, [800]),
            ("K3", 1, 4, 800, 800, 256, [800]),
            ("K3", 2, 4, 300, 300, 200, [300, 129]),
            ("K5", 1, 4, ts, ts, 80, [ts]),
            ("K5", 1, 4, ts, ts, 80, [PF_LONG_VALID_T - 3 * ts]),
            ("K5", 2, 4, 200, 333, 128, [333, 64]),
            ("K5", 2, 4, 300, 300, 40, [300, 129]),
            ("K5", 1, 4, ts, ts, 192, [ts]),
            ("K5", 1, 4, ts, ts, 256, [ts]),
            ("K5", 2, 4, 300, 300, 200, [300, 129])):
        q = torch.randn((b, h, tq, d), generator=gen).to(dev)
        k, v = (torch.randn((b, h, tk, d), generator=gen).to(dev) for _ in range(2))
        mask = torch.arange(tk, device=dev)[None, :] < torch.tensor(lens, device=dev)[:, None]
        n_valid = int(mask.sum())
        sdpa = lambda: torch.nn.functional.scaled_dot_product_attention(  # noqa: E731
            q, k, v, attn_mask=mask[:, None, None, :])
        dp = attention.padded_head_dim(d)
        case = {"kernel": kind, "shape": [b, h, tq, d], "keys": tk, "valid_keys": lens,
                "head_dim": d, "instance": dp}
        if kind == "K3":
            out = attention.flash_attention(q, k, v, mask)
            torch.cuda.synchronize()
            ref = attention.attention_reference(q.double(), k.double(), v.double(), mask)
            case["max_abs_err"] = ((out - ref.float()).abs() * mask[:, None, :, None]).max().item()
            fn = lambda: attention.flash_attention(q, k, v, mask)  # noqa: E731
            twin = lambda: attention.attention_reference(q, k, v, mask)  # noqa: E731
            work = attention.work
        else:
            o, m, l = attention.flash_attention_stats(q, k, v, mask)
            torch.cuda.synchronize()
            ro, rm, rl = (x.float() for x in attention.attention_stats_reference(
                q.double(), k.double(), v.double(), mask))
            peak = ro.abs().max().item()
            case.update({"max_abs_err": (o - ro).abs().max().item(),
                         "rel_err": (o - ro).abs().max().item() / peak,
                         "m_rel_err": ((m - rm).abs() / rm.abs().clamp_min(1.0)).max().item(),
                         "l_rel_err": ((l - rl).abs() / rl.abs()).max().item()})
            fn = lambda: attention.flash_attention_stats(q, k, v, mask)  # noqa: E731
            twin = lambda: attention.attention_stats_reference(q, k, v, mask)  # noqa: E731
            work = attention.stats_work
        case.update({
            "ms": graph_ms(torch, fn, 20), "plain_ms": graph_ms(torch, twin, 20),
            # SDPA (the normalised output alone) on the same q, k, v: K3's
            # library call; beside K5 a yardstick of another function
            "library_ms" if kind == "K3" else "sdpa_ms_same_inputs":
                graph_ms(torch, sdpa, 20) if tq == tk or kind == "K3" else None,
            "wrapper_ms": cuda_ms(torch, fn, 20),
            **tensor_bound(*_terms(work(b, h, tq, tk, d, valid_keys=lens)))})
        if dp > 128:
            # the wide body: the scores over dp once per 128-column slice,
            # and p v over 128 columns a slice
            slices = -(-dp // 128)
            case.update({"scores_formed": slices, "bound_with_recompute_ms": tensor_bound(
                2.0 * h * tq * n_valid * slices * (dp + 128), 1.0 * h * tq * n_valid,
                0.0)["bound_ms"]})
        if kind == "K3":
            case["ms_over_library_ms"] = case["ms"] / case["library_ms"]
        log({"phase": "kernel", "name": "flash_attention" if kind == "K3"
             else "flash_attention_stats", **case})
        if kind == "K3":
            assert case["max_abs_err"] <= 2e-5, case
            k3.append(case)
        else:
            assert math.isfinite(case["max_abs_err"]) and case["rel_err"] <= 1e-4, case
            assert case["m_rel_err"] <= 1e-5 and case["l_rel_err"] <= 1e-5, case
            k5.append(case)
    return {"flash_attention": k3, "flash_attention_stats": k5}


def _gau_case(torch, gau, gen, b: int, t: int, de: int, lens, iters: int) -> dict:
    """K4 against its blockwise twin (float32, and float64 as the oracle) at
    q, k [b, t, 128], v [b, t, de], the first ``lens`` keys of each item
    valid; device time by CUDA-graph replay, each call through Python
    beside."""
    dev = torch.device("cuda")
    q, k = (torch.randn((b, t, 128), generator=gen).to(dev) for _ in range(2))
    v = torch.randn((b, t, de), generator=gen).to(dev)
    mask = torch.arange(t, device=dev)[None, :] < torch.tensor(lens, device=dev)[:, None]
    scale = 1.0 / t
    out = gau.gau_attention(q, k, v, mask, scale)
    torch.cuda.synchronize()
    ref = gau.gau_attention_reference(q, k, v, mask, scale)
    # the twin in float64 as well: the float32 twin adds its own error
    ref64 = gau.gau_attention_reference(q.double(), k.double(), v.double(), mask, scale)
    err = (out - ref).abs().max().item()
    err64 = (out - ref64).abs().max().item()
    peak = ref64.abs().max().item()
    k4 = lambda: gau.gau_attention(q, k, v, mask, scale)  # noqa: E731
    twin = lambda: gau.gau_attention_reference(q, k, v, mask, scale)  # noqa: E731
    case = {"shape": [b, t, 128, de], "valid_keys": lens, "max_abs_err": err,
            "rel_err": err / peak, "max_abs_err_vs_float64_twin": err64,
            "rel_err_vs_float64_twin": err64 / peak,
            "twin_rel_err_vs_float64_twin": (ref - ref64).abs().max().item() / peak,
            "tol_rel": 1e-4,
            # device time (graph replay); each call through Python beside
            "ms": graph_ms(torch, k4, iters), "plain_ms": graph_ms(torch, twin, iters),
            "wrapper_ms": cuda_ms(torch, k4, iters),
            "plain_eager_ms": cuda_ms(torch, twin, iters),
            "library_ms": None,  # no single PyTorch call computes relu^2 attention
            # over the valid keys (a masked key contributes exactly 0): q read
            # and out written for every row, k and v for the valid keys alone
            **tensor_bound(*_terms(gau.work(b, t, 128, de, valid_keys=lens)))}
    case["share"] = case["bound_ms"] / case["ms"]
    case["share_simt"] = case["bound_simt_ms"] / case["ms"]
    case["device_ops_per_call"] = queued_ops(torch, k4)
    log({"phase": "kernel", "name": "gau_attention", **case})
    # float32 accuracy on both sides (the kernel in 3xTF32 on the tensor
    # cores tile by tile, ~3e-7 of max|out| in the CPU emulation; the twin in
    # cuBLAS's blocked order): 1e-4 of max|out| against each twin
    assert math.isfinite(err) and err <= 1e-4 * peak, case
    assert err64 <= 1e-4 * peak, case
    assert not out[torch.tensor(lens, device=dev) == 0].any()  # fully masked item: exact zeros
    return case


def check_gau(torch, np) -> dict:
    """K4 against its blockwise twin at the main path's shape (one 8 s bucket
    of the full-preset MossFormer: T = 15999 frames, Dqk 128, De 768, the
    keys of a 6 s segment valid), at the 16 s bucket (T = 31999, every key
    valid: Separator.separate's MossFormer run) and at a small ragged batch
    of 3 with one fully masked item. Timed as K3: device time by CUDA-graph
    replay, each call through Python beside, for the kernel and its twin."""
    from audio_classification_tpu_torch.ops.kernels import gau

    gen = torch.Generator(device="cpu").manual_seed(4)
    cases = [_gau_case(torch, gau, gen, b, t, 768, lens, iters)
             for b, t, lens, iters in ((1, 15999, [11999], 10), (1, 31999, [31999], 4),
                                       (3, 1237, [1237, 700, 0], 20))]
    return {**cases[0], "max_abs_err": max(c["max_abs_err"] for c in cases), "cases": cases}


def bf16_bound(flops: float, nbytes: float) -> dict:
    """The bf16 entry points: the larger of the products at the data
    sheet's dense bf16 tensor rate and the bytes at the memory rate."""
    by_ops, by_bytes = flops / PEAK_BF16_FLOPS * 1e3, nbytes / PEAK_BYTES_PER_S * 1e3
    return {"bound_ms": max(by_ops, by_bytes),
            "bound_by": "operations" if by_ops >= by_bytes else "bytes",
            "flops": flops, "bytes": nbytes}


def bf16_tensor_bound(flops: float, exps: float, nbytes: float) -> dict:
    """K3 / K5's bf16 entry points: the larger of the products at the dense
    bf16 tensor rate, the exponentials at the SFU rate and the bytes."""
    terms = {"tensor_bf16": flops / PEAK_BF16_FLOPS * 1e3,
             "sfu_exp": exps / PEAK_SFU_PER_S * 1e3,
             "bytes": nbytes / PEAK_BYTES_PER_S * 1e3}
    term = max(terms, key=terms.get)
    return {"bound_ms": terms[term], "bound_by": "bytes" if term == "bytes" else "operations",
            "bound_term": term, "flops": flops, "exps": exps, "bytes": nbytes}


def check_attention_bf16(torch, np) -> dict:
    """K3 and K5 at bf16 q, k, v (act_flash_attention_bf16 /
    act_flash_attention_stats_bf16) at the float32 phases' shapes: K3 at
    [8,8,537,64], [1,8,537,64], [1,4,800,64] ragged, [1,8,4271,64] with 3337
    keys valid, D = 80 [1,4,533,80], D = 128 [2,4,200,128] ragged, D = 40
    and D = 200 ragged (zero-padded to 64 and to the wide body's 256); K5 on
    a shard's [1,8,1068,64] block with all keys valid and with 133, and
    [3,8,537,64] x 1068 keys ragged. Each against the bf16 twin over the
    kernels' own 64-key blocks (p is rounded against the running max, so the
    block width is part of the function) and against that twin in float64
    (the same rounding points): a float32 sum in another order moves a p
    across a bf16 rounding boundary now and then, and one flip moves an
    output by up to 2^-9 p |v| / l, so o is held to 2e-3 of max|o| and its
    mean error to 5e-5 of mean|o| (an unrounded p v or another block width
    is ~1e-3 off in the mean); m and l to 1e-5 relative. Device ms by graph
    replay with the twin's and SDPA's at bf16 on the same inputs (K3's
    library call; beside K5 a yardstick of another function), the float32
    entry point's on the same values, and each call through Python; the
    launch plan (``attention.bf16_plan``) and the device operations one call
    queues (``queued_ops``: the zero-pad copies of D = 40 and 200 beside the
    kernel)."""
    from audio_classification_tpu_torch.ops.kernels import attention

    dev = torch.device("cuda")
    bf = torch.bfloat16
    gen = torch.Generator(device="cpu").manual_seed(16)
    ts = -(-LONG_T // LONG_SHARDS)
    out_cases = {"K3": [], "K5": []}
    for kind, b, h, tq, tk, d, lens in (
            ("K3", 8, 8, 537, 537, 64, [537 - 97 * i % 537 for i in range(8)]),
            ("K3", 1, 8, 537, 537, 64, [537]),
            ("K3", 1, 4, 800, 800, 64, [800]),
            ("K3", 1, 8, LONG_T, LONG_T, 64, [LONG_VALID_T]),
            ("K3", 1, 4, 533, 533, 80, [533]),
            ("K3", 2, 4, 200, 200, 128, [200, 77]),
            ("K3", 2, 4, 300, 300, 40, [300, 129]),
            ("K3", 2, 4, 300, 300, 200, [300, 129]),
            ("K5", 1, 8, ts, ts, 64, [ts]),
            ("K5", 1, 8, ts, ts, 64, [LONG_VALID_T - 3 * ts]),
            ("K5", 3, 8, 537, 1068, 64, [1068, 300, 33])):
        q = torch.randn((b, h, tq, d), generator=gen).to(dev).to(bf)
        k, v = (torch.randn((b, h, tk, d), generator=gen).to(dev).to(bf) for _ in range(2))
        mask = torch.arange(tk, device=dev)[None, :] < torch.tensor(lens, device=dev)[:, None]
        q32, k32, v32 = q.float(), k.float(), v.float()
        sdpa = lambda: torch.nn.functional.scaled_dot_product_attention(  # noqa: E731
            q, k, v, attn_mask=mask[:, None, None, :])
        case = {"kernel": kind, "shape": [b, h, tq, d], "keys": tk, "valid_keys": lens,
                "instance": attention.padded_head_dim(d), "block_k": attention.BLOCK_K,
                "plan": attention.bf16_plan(b, h, tq, tk, d)}
        if kind == "K3":
            fn = lambda: attention.flash_attention(q, k, v, mask)  # noqa: E731
            twin = lambda: attention.attention_reference_lowp(q, k, v, mask)  # noqa: E731
            f32 = lambda: attention.flash_attention(q32, k32, v32, mask)  # noqa: E731
            got, again = (fn(),), (fn(),)
            torch.cuda.synchronize()
            refs = ((twin(),), (attention.attention_reference_lowp(q, k, v, mask,
                                                                   acc=torch.float64),))
            work = attention.work
        else:
            fn = lambda: attention.flash_attention_stats(q, k, v, mask)  # noqa: E731
            twin = lambda: attention.attention_stats_reference_lowp(q, k, v, mask)  # noqa: E731
            f32 = lambda: attention.flash_attention_stats(q32, k32, v32, mask)  # noqa: E731
            got, again = fn(), fn()
            torch.cuda.synchronize()
            refs = (twin(), attention.attention_stats_reference_lowp(q, k, v, mask,
                                                                    acc=torch.float64))
            work = attention.stats_work
        assert got[0].dtype == torch.float32 and got[0].shape == (b, h, tq, d)
        for label, ref in zip(("", "_vs_float64_twin"), refs):
            ro = ref[0].float()
            err = (got[0] - ro).abs()
            case["max_abs_err" + label] = err.max().item()
            case["rel_err" + label] = err.max().item() / ro.abs().max().item()
            case["mean_rel_err" + label] = err.mean().item() / ro.abs().mean().item()
            if kind == "K5":
                rm, rl = ref[1].float(), ref[2].float()
                case["m_rel_err" + label] = ((got[1] - rm).abs()
                                             / rm.abs().clamp_min(1.0)).max().item()
                case["l_rel_err" + label] = ((got[2] - rl).abs() / rl.abs()).max().item()
        case.update({
            "tol_rel": 2e-3, "tol_mean_rel": 5e-5, "tol_ml_rel": 1e-5,
            "repeat_identical": all(torch.equal(x, y) for x, y in zip(got, again)),
            "ms": graph_ms(torch, fn, 20), "plain_ms": graph_ms(torch, twin, 20),
            "f32_entry_ms": graph_ms(torch, f32, 20),
            "library_ms" if kind == "K3" else "sdpa_ms_same_inputs":
                graph_ms(torch, sdpa, 20) if tq == tk or kind == "K3" else None,
            "wrapper_ms": cuda_ms(torch, fn, 20), "device_ops": queued_ops(torch, fn),
            # over the valid keys (a tile with none is skipped, a masked key
            # adds exp(-1e9) = 0): q read and the outputs written for every
            # row, k and v for the valid keys, at 2 bytes
            **bf16_tensor_bound(*_terms(work(b, h, tq, tk, d, itemsize=2, valid_keys=lens)))})
        if kind == "K5":
            case["library_ms"] = None  # no single PyTorch call returns (o, m, l)
        else:
            case["ms_over_library_ms"] = case["ms"] / case["library_ms"]
        case["share"] = case["bound_ms"] / case["ms"]
        log({"phase": "kernel", "name": "flash_attention_bf16" if kind == "K3"
             else "flash_attention_stats_bf16", **case})
        for label in ("", "_vs_float64_twin"):
            assert math.isfinite(case["rel_err" + label]), case
            assert case["rel_err" + label] <= 2e-3, case
            assert case["mean_rel_err" + label] <= 5e-5, case
            if kind == "K5":
                assert case["m_rel_err" + label] <= 1e-5, case
                assert case["l_rel_err" + label] <= 1e-5, case
        assert case["repeat_identical"], case
        out_cases[kind].append(case)
    return {name: {**cases[0], "max_abs_err": max(c["max_abs_err"] for c in cases),
                   "cases": cases}
            for name, cases in (("flash_attention_bf16", out_cases["K3"]),
                                ("flash_attention_stats_bf16", out_cases["K5"]))}


def _bf16_stack(torch, tcn, model, quant: bool) -> dict:
    """The stack a bf16 engine's masker runs: the bf16 copy of the
    full-preset Conv-TasNet's blocks (weights and vector bundles rounded
    to bf16), as StageEngine's copy makes it."""
    import copy

    return tcn.stack_tcn_params(copy.deepcopy(model).to(torch.bfloat16).tcn_blocks(),
                                torch.bfloat16, weight_quant=quant)


#: device operations of one K2 bf16 / K2-s8 bf16 call before the wgmma
#: redesign (72 launches and 2 memsets, 24 dequant launches more at s8, the
#: wrapper's cat and clamp), as scripts/tcn_masker_ab.py --split counted
#: them on the parent commit on an NVIDIA H100 80GB HBM3
TCN_BF16_PARENT_DEVICE_OPS = {False: 76, True: 100}


def check_tcn_bf16(torch, np, quant: bool) -> dict:
    """K2 (``quant`` False) or K2-s8 at bf16 against their bf16 twin and
    the twin run in float64 (the same rounding points, float64 between
    them) at the float phases' shapes: B=1, F=31999 with a 20 s segment's
    f_len, 8 ragged 2 s windows, and the streaming window (B=1, F=1999 all
    valid: the bf16 streaming replay's call). The bf16 residual stream and skip sum
    round at every one of the 24 blocks, so a flip of one rounding in a
    row (another summation order) is carried down the stack: held to 5e-2
    of max|twin| on valid rows (tests/test_bf16.py's bf16-vs-f32 bound) and
    a mean of 5e-3; padded rows exactly 0, repeat calls bit-identical. The
    s8 entry point must equal the bf16 entry point on the stack dequantised
    to bf16. Device ms by CUDA-graph replay, the float32 entry point's on
    the float32 stack beside it; the device operations of one call
    (torch.profiler) beside the parent's count."""
    from audio_classification_tpu_torch.engine.runtime import EnginePreset, ModelPack
    from audio_classification_tpu_torch.ops.kernels import tcn

    dev = torch.device("cuda")
    bf = torch.bfloat16
    gen = torch.Generator(device="cpu").manual_seed(7 if quant else 6)
    model = ModelPack(EnginePreset(), seed=0, device=dev).models["sep3"]
    st = _bf16_stack(torch, tcn, model, quant)
    st32 = tcn.stack_tcn_params(model.tcn_blocks(), weight_quant=quant)
    nb, c, hd = st["w_in"].shape
    f32, f2 = (32 * SR - 32) // 16 + 1, (2 * SR - 32) // 16 + 1
    name = "tcn_masker_s8_bf16" if quant else "tcn_masker_bf16"
    cases = []
    for b, f, lens, iters in ((1, f32, [(20 * SR - 32) // 16 + 1], 10),
                              (8, f2, [f2, f2, 1500, f2, 1000, f2, 750, f2], 20),
                              (1, f2, [f2], 20)):
        x = torch.randn((b, f, c), generator=gen).to(dev).to(bf)
        f_len = torch.tensor(lens, dtype=torch.int32, device=dev)
        k2 = lambda: tcn.fused_tcn_masker(x, f_len, st, n_per_repeat=8)  # noqa: E731
        out, again = k2(), k2()
        torch.cuda.synchronize()
        ref = tcn.tcn_masker_reference_lowp(x, f_len, st, n_per_repeat=8).float()
        ref64 = tcn.tcn_masker_reference_lowp(x, f_len, st, n_per_repeat=8,
                                              acc=torch.float64).float()
        valid = (torch.arange(f, device=dev)[None, :] < f_len[:, None])[..., None]
        n_valid = sum(lens)
        peak = (ref64.abs() * valid).max().item()
        err = ((out.float() - ref).abs() * valid)
        err64 = ((out.float() - ref64).abs() * valid)
        x32 = x.float()
        case = {"shape": [b, f, c], "f_len": lens, "max_abs_err": err.max().item(),
                "rel_err": err.max().item() / peak,
                "mean_rel_err": err.sum().item() / (n_valid * c) / peak,
                "max_abs_err_vs_float64_twin": err64.max().item(),
                "rel_err_vs_float64_twin": err64.max().item() / peak,
                "twin_rel_err_vs_float64_twin": ((ref - ref64).abs() * valid).max().item() / peak,
                "tol_rel": 5e-2, "tol_mean_rel": 5e-3,
                "padded_rows_zero": not (out.float() * ~valid).any().item(),
                "repeat_identical": torch.equal(out, again),
                "ms": graph_ms(torch, k2, iters),
                "f32_entry_ms": graph_ms(torch, lambda: tcn.fused_tcn_masker(
                    x32, f_len, st32, n_per_repeat=8), iters),
                "plain_ms": cuda_ms(torch, lambda: tcn.tcn_masker_reference_lowp(
                    x, f_len, st, n_per_repeat=8), max(iters // 5, 2)),
                "library_ms": None,  # no single PyTorch call computes the masker
                # a profiler session may come back empty: the larger of two
                "device_ops": max(device_ops(torch, k2)["device_ops"] for _ in range(2)),
                "parent_device_ops": TCN_BF16_PARENT_DEVICE_OPS[quant]}
        if quant:
            deq = tcn.fused_tcn_masker(x, f_len, tcn.dequant_stack(st, bf), n_per_repeat=8)
            case["equal_to_bf16_entry_on_dequantised_stack"] = torch.equal(out, deq)
        # the float phases' count over the VALID frames; bytes: valid rows of
        # x in and of the sum out at 2 bytes, the weights at their own width
        w = tcn.work(b, f, c, hd, nb, sum(t.numel() * t.element_size() for t in st.values()),
                     f_len=lens, itemsize=2)
        case.update(bf16_bound(w["flops"], w["bytes"]))
        case["share"] = case["bound_ms"] / case["ms"]
        log({"phase": "kernel", "name": name, **case})
        assert math.isfinite(case["rel_err"]) and case["rel_err"] <= 5e-2, case
        assert case["rel_err_vs_float64_twin"] <= 5e-2, case
        assert case["mean_rel_err"] <= 5e-3, case
        assert case["padded_rows_zero"] and case["repeat_identical"], case
        assert case.get("equal_to_bf16_entry_on_dequantised_stack", True), case
        cases.append(case)
    return {**cases[0], "max_abs_err": max(c_["max_abs_err"] for c_ in cases), "cases": cases}


def check_gau_bf16(torch, np) -> dict:
    """K4's bf16 entry point (MossFormer's first GAU layer in a bf16 engine)
    against its bf16 twin and the twin in float64 (p rounded to bf16 in
    both) at the float phase's shapes: the 8 s bucket with 11999 keys valid
    and a ragged batch of 3 with one item masked whole. 2e-3 of max|out|:
    the two sums' orders differ in float32, and a p that lands on a bf16
    rounding boundary goes either way. Device ms by graph replay, the
    float32 entry point's on the same values beside it. Also v's 384
    columns with 11999 keys valid: bf16 ``separate`` at TP 2 runs K4 there.
    Each case logs the launch plan (``gau.bf16_plan``) and the device
    operations one call queues (``queued_ops``)."""
    from audio_classification_tpu_torch.ops.kernels import gau

    dev = torch.device("cuda")
    bf = torch.bfloat16
    gen = torch.Generator(device="cpu").manual_seed(8)
    cases = []
    for b, t, de, lens, iters in ((1, 15999, 768, [11999], 10), (3, 1237, 768, [1237, 700, 0], 20),
                                  (1, 15999, 384, [11999], 10)):
        q, k = (torch.randn((b, t, 128), generator=gen).to(dev).to(bf) for _ in range(2))
        v = torch.randn((b, t, de), generator=gen).to(dev).to(bf)
        mask = torch.arange(t, device=dev)[None, :] < torch.tensor(lens, device=dev)[:, None]
        scale = 1.0 / t
        k4 = lambda: gau.gau_attention(q, k, v, mask, scale)  # noqa: E731
        out, again = k4(), k4()
        torch.cuda.synchronize()
        ref = gau.gau_attention_reference(q, k, v, mask, scale)
        ref64 = gau.gau_attention_reference(q, k, v, mask, scale, acc=torch.float64)
        peak = ref64.abs().max().item()
        err, err64 = (out - ref).abs().max().item(), (out - ref64).abs().max().item()
        q32, k32, v32 = q.float(), k.float(), v.float()
        w = gau.work(b, t, 128, de, itemsize=2, valid_keys=lens)
        case = {"shape": [b, t, 128, de], "valid_keys": lens, "max_abs_err": err,
                "rel_err": err / peak, "max_abs_err_vs_float64_twin": err64,
                "rel_err_vs_float64_twin": err64 / peak,
                "twin_rel_err_vs_float64_twin": (ref - ref64).abs().max().item() / peak,
                "tol_rel": 2e-3, "repeat_identical": torch.equal(out, again),
                "plan": gau.bf16_plan(b, t, 128, de), "device_ops": queued_ops(torch, k4),
                "ms": graph_ms(torch, k4, iters),
                "f32_entry_ms": graph_ms(torch, lambda: gau.gau_attention(q32, k32, v32, mask,
                                                                           scale), iters),
                "plain_ms": graph_ms(torch, lambda: gau.gau_attention_reference(
                    q, k, v, mask, scale), iters),
                "wrapper_ms": cuda_ms(torch, k4, iters),
                "library_ms": None,  # no single PyTorch call computes relu^2 attention
                # over the valid keys: q read and out (float32) written for
                # every row, k and v for the valid keys alone, at 2 bytes
                **bf16_bound(w["flops"], w["bytes"])}
        case["share"] = case["bound_ms"] / case["ms"]
        log({"phase": "kernel", "name": "gau_attention_bf16", **case})
        assert math.isfinite(err) and err <= 2e-3 * peak and err64 <= 2e-3 * peak, case
        assert case["repeat_identical"], case
        assert not out[torch.tensor(lens, device=dev) == 0].any()  # the masked item: zeros
        cases.append(case)
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

    # --quant int8: Conv-TasNet-3 and SenseVoice as build_engine configures
    # them, same seed. The integer products are exact on both devices, but the
    # float layers between them differ ~1e-6 (the masker's weight stream runs
    # in K2-s8 here and in its twin there), which moves single activations
    # across a rounding boundary: each flip is one int8 step, 1/127 of that
    # tensor's peak, and the layers after it amplify it. So the tolerance is
    # 3e-2 of max|ref|, 30x the float stages' 1e-3; a wrong scale, mask or
    # weight grid shows as ~1e-1 and more.
    from audio_classification_tpu_torch.pipelines.offline_overlap3 import build_engine
    from audio_classification_tpu_torch.utils.config import Overlap3Config

    q_engines = {d: build_engine(Overlap3Config(preset="full", seed=0, quant="int8", provider=d))
                 for d in ("cuda", "cpu")}
    assert q_engines["cuda"].pack.models["sep3"].cfg.quant == "int8"
    report = {}
    with torch.inference_mode():
        for name in ("sep_branches", "asr_logits"):
            outs = {}
            for d, e in q_engines.items():
                w = torch.from_numpy(wav_i16).to(d)
                outs[d] = stages[name](e, w, torch.from_numpy(lens).to(d)).float().cpu()
            err = (outs["cuda"] - outs["cpu"]).abs().max().item()
            rel = err / max(outs["cpu"].abs().max().item(), 1e-12)
            report[name + "_int8"] = rel
            assert math.isfinite(rel) and rel <= 3e-2, (name, rel)
    log({"phase": "small_input_vs_cpu_int8", "rel_err": report, "tol_rel": 3e-2})


def check_bf16_against_cpu(torch, np) -> None:
    """The full-preset stages of a ``compute_dtype="bfloat16"`` engine on the
    card (the bf16 kernels, cuBLAS / cuDNN in bf16) against the same bf16
    engine on the CPU (the bf16 twins, torch's CPU bf16 ops) for two items
    of 4 s (MossFormer: 2 s). Both round at the same points, their float32
    sums run in other orders, and a flipped bf16 rounding is carried on:
    through Conv-TasNet's 24 masker blocks, whose residual stream is bf16,
    as far as bf16 is from float32 itself. So the tolerance of each stage is
    the distance between the CPU's bf16 and float32 engines on the same
    input (max |.| over max |float32|): the card's bf16 must stand no
    further from the CPU's bf16 than bf16 stands from float32."""
    from audio_classification_tpu_torch.engine.runtime import EnginePreset, ModelPack, StageEngine
    from audio_classification_tpu_torch.models.asr.sensevoice import sensevoice_frontend

    n = 4 * SR
    src = talkers(n, 2)
    wav = np.stack([sum(src) * 0.25, src[0] * 0.5]).astype(np.float32)
    wav_i16 = np.clip(np.rint(wav * 32768), -32768, 32767).astype(np.int16)
    lens = np.array([n, 3 * SR], np.int32)
    cpu_pack = ModelPack(EnginePreset(), seed=0, device="cpu")
    engines = {"cuda": StageEngine(ModelPack(EnginePreset(), seed=0, device="cuda"),
                                   compute_dtype="bfloat16"),
               "cpu": StageEngine(cpu_pack, compute_dtype="bfloat16"),
               "cpu_f32": StageEngine(cpu_pack)}

    def asr_logits(e, w, l):
        feats, mask = sensevoice_frontend(e._dq(w), l, e.pack.asr_cfg)
        return e.models["asr"](feats.to(e.compute_dtype), mask)

    stages = {
        "osd_probs": lambda e, w, l: e._osd_fn(w, l),
        "sep_branches": lambda e, w, l: e._sep_core(e._dq(w), l),
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
                w = torch.from_numpy(wav_i16).to(e.device)
                outs[d] = fn(e, w, torch.from_numpy(lens).to(e.device)).float().cpu()
            peak = max(outs["cpu_f32"].abs().max().item(), 1e-12)
            rel = (outs["cuda"] - outs["cpu"]).abs().max().item() / peak
            gap = (outs["cpu"] - outs["cpu_f32"]).abs().max().item() / peak
            report[name] = {"rel_err": rel, "tol_rel_bf16_vs_f32": gap,
                            "l2_rel_err": ((outs["cuda"] - outs["cpu"]).norm()
                                           / outs["cpu"].norm()).item()}
    log({"phase": "small_input_vs_cpu_bf16", "stages": report})
    for name, r in report.items():
        assert math.isfinite(r["rel_err"]) and r["rel_err"] <= r["tol_rel_bf16_vs_f32"], (name, r)


def check_families_against_cpu(torch, np) -> None:
    """The Paraformer, transducer and whisper-style recognizers at the full
    preset (seeded weights) on the card against the same weights on the CPU,
    two 4 s items: encoder outputs (Paraformer: its logits on the fired
    tokens) within 1e-3 of max|ref| as the other stages, and the token ids
    of every decoder equal (CIF counts and ids, greedy and modified beam
    search, whisper's KV-cache greedy)."""
    from audio_classification_tpu_torch.engine.runtime import EnginePreset, seeded_init_
    from audio_classification_tpu_torch.models.asr.paraformer import (
        Paraformer,
        paraformer_frontend,
        paraformer_greedy,
    )
    from audio_classification_tpu_torch.models.asr.transducer import (
        Transducer,
        transducer_frontend,
    )
    from audio_classification_tpu_torch.models.asr.whisper_style import (
        WhisperStyle,
        whisper_frontend,
    )

    preset = EnginePreset()
    n = 4 * SR
    src = talkers(n, 3)
    wav = np.stack([sum(src) * 0.25, src[1] * 0.5]).astype(np.float32)
    lens = np.array([n, 3 * SR], np.int64)

    def paraformer(m, w, l):
        logits, counts = m(*paraformer_frontend(w, l, m.cfg))
        ids, _ = paraformer_greedy(logits, counts)
        rows = torch.arange(logits.shape[1], device=w.device)[None, :] < counts[:, None]
        return logits * rows[..., None], {"counts": counts, "ids": ids}

    def transducer(m, w, l):
        feats, mask = transducer_frontend(w, l, m.cfg)
        enc, emask = m.encoder(feats, mask)
        return enc * emask[..., None], {"greedy": m.greedy_decode(feats, mask)[0],
                                        "beam4": m.beam_decode(feats, mask, 4)[0]}

    def whisper(m, w, l):
        feats, mask = whisper_frontend(w, l, m.cfg)
        mem, mmask = m.encode(feats, mask)
        return mem * mmask[..., None], {"greedy": m.greedy_decode(feats, mask)[0]}

    report = {}
    for name, cls, cfg, run in (("paraformer", Paraformer, preset.paraformer, paraformer),
                                ("transducer", Transducer, preset.transducer, transducer),
                                ("whisper", WhisperStyle, preset.whisper, whisper)):
        outs = {}
        for d in ("cuda", "cpu"):
            model = seeded_init_(cls(cfg), torch.Generator().manual_seed(0)).to(d).eval()
            with torch.inference_mode():
                x, ids = run(model, torch.from_numpy(wav).to(d), torch.from_numpy(lens).to(d))
            outs[d] = (x.float().cpu(), {k: v.cpu() for k, v in ids.items()})
        err = (outs["cuda"][0] - outs["cpu"][0]).abs().max().item()
        rel = err / max(outs["cpu"][0].abs().max().item(), 1e-12)
        equal = {k: bool(torch.equal(outs["cuda"][1][k], outs["cpu"][1][k]))
                 for k in outs["cpu"][1]}
        report[name] = {"rel_err": rel, "ids_equal": equal,
                        "tokens": {k: int((v != 0).sum()) for k, v in outs["cpu"][1].items()}}
        assert math.isfinite(rel) and rel <= 1e-3, (name, rel)
        assert all(equal.values()), (name, equal)
    log({"phase": "families_vs_cpu", "tol_rel": 1e-3, **report})


# pyannote/segmentation's published architecture: SincNet of 80 filters (40
# analytic cos / sin pairs of asteroid's ParamSincFB) of 251 taps at stride
# 10, two conv stages of 60 channels (kernel 5, max pool 3), a 4-layer
# bidirectional LSTM of 128, linear 128 / 128 and 3 speaker classes
PYANNET_WIDTHS = dict(rows=40, n_filters=80, conv=(60, 60), kernel=5, hidden=128, layers=4,
                      linear=(128, 128), classes=3)


def write_pyannote_checkpoint(torch, np, path, seed: int) -> None:
    """A pytorch-lightning checkpoint at PYANNET_WIDTHS: seeded tensors under
    pyannote's PyanNet names, mel-spaced band edges, torch's default init
    scales."""
    w = PYANNET_WIDTHS
    rng = np.random.default_rng(seed)
    mel = np.linspace(2595 * np.log10(1 + 30 / 700), 2595 * np.log10(1 + 7900 / 700),
                      w["rows"] + 1)
    hz = 700 * (10 ** (mel / 2595) - 1)
    uni = lambda bound, *shape: rng.uniform(-bound, bound, shape)  # noqa: E731
    sd = {"sincnet.wav_norm1d.weight": np.ones(1), "sincnet.wav_norm1d.bias": np.zeros(1),
          "sincnet.conv1d.0.filterbank.low_hz_": hz[:-1, None] - 50.0,
          "sincnet.conv1d.0.filterbank.band_hz_": np.diff(hz)[:, None] - 50.0,
          "sincnet.norm1d.0.weight": 1 + 0.1 * rng.standard_normal(w["n_filters"]),
          "sincnet.norm1d.0.bias": 0.1 * rng.standard_normal(w["n_filters"])}
    cin = w["n_filters"]
    for i, ch in enumerate(w["conv"], start=1):
        bound = (cin * w["kernel"]) ** -0.5
        sd.update({f"sincnet.conv1d.{i}.weight": uni(bound, ch, cin, w["kernel"]),
                   f"sincnet.conv1d.{i}.bias": uni(bound, ch),
                   f"sincnet.norm1d.{i}.weight": 1 + 0.1 * rng.standard_normal(ch),
                   f"sincnet.norm1d.{i}.bias": 0.1 * rng.standard_normal(ch)})
        cin = ch
    h = w["hidden"]
    for layer in range(w["layers"]):
        for sfx in ("", "_reverse"):
            sd.update({f"lstm.weight_ih_l{layer}{sfx}": uni(h ** -0.5, 4 * h, cin),
                       f"lstm.weight_hh_l{layer}{sfx}": uni(h ** -0.5, 4 * h, h),
                       f"lstm.bias_ih_l{layer}{sfx}": uni(h ** -0.5, 4 * h),
                       f"lstm.bias_hh_l{layer}{sfx}": uni(h ** -0.5, 4 * h)})
        cin = 2 * h
    for j, dim in enumerate(w["linear"]):
        sd.update({f"linear.{j}.weight": uni(cin ** -0.5, dim, cin),
                   f"linear.{j}.bias": uni(cin ** -0.5, dim)})
        cin = dim
    sd.update({"classifier.weight": uni(cin ** -0.5, w["classes"], cin),
               "classifier.bias": uni(cin ** -0.5, w["classes"])})
    torch.save({"state_dict": {k: torch.from_numpy(np.asarray(v, np.float32)) for k, v in sd.items()},
                "epoch": 0}, str(path))


def write_asteroid_convtasnet(torch, np, path, cfg, seed: int) -> None:
    """An asteroid ConvTasNet state_dict at ``cfg``'s widths, seeded, under
    asteroid's names (gLN gamma / beta as [1, C, 1])."""
    rng = np.random.default_rng(seed)
    n, l, b, h, p = cfg.enc_dim, cfg.enc_kernel, cfg.bottleneck, cfg.hidden, cfg.conv_kernel
    r = lambda scale, *shape: scale * rng.standard_normal(shape)  # noqa: E731
    sd = {"encoder.filterbank._filters": r(l ** -0.5, n, 1, l),
          "decoder.filterbank._filters": r(n ** -0.5, n, 1, l),
          "masker.bottleneck.0.gamma": 1 + r(0.05, 1, n, 1),
          "masker.bottleneck.0.beta": r(0.05, 1, n, 1),
          "masker.bottleneck.1.weight": r(n ** -0.5, b, n, 1),
          "masker.bottleneck.1.bias": r(0.05, b),
          "masker.mask_net.0.weight": np.full(1, 0.25),
          "masker.mask_net.1.weight": r(b ** -0.5, cfg.n_src * n, b, 1),
          "masker.mask_net.1.bias": r(0.05, cfg.n_src * n)}
    for i in range(cfg.n_repeats * cfg.n_blocks):
        pre = f"masker.TCN.{i}"
        sd.update({f"{pre}.shared_block.0.weight": r(b ** -0.5, h, b, 1),
                   f"{pre}.shared_block.0.bias": r(0.05, h),
                   f"{pre}.shared_block.1.weight": np.full(1, 0.25),
                   f"{pre}.shared_block.2.gamma": 1 + r(0.05, 1, h, 1),
                   f"{pre}.shared_block.2.beta": r(0.05, 1, h, 1),
                   f"{pre}.shared_block.3.weight": r(p ** -0.5, h, 1, p),
                   f"{pre}.shared_block.3.bias": r(0.05, h),
                   f"{pre}.shared_block.4.weight": np.full(1, 0.25),
                   f"{pre}.shared_block.5.gamma": 1 + r(0.05, 1, h, 1),
                   f"{pre}.shared_block.5.beta": r(0.05, 1, h, 1),
                   f"{pre}.res_conv.weight": r(h ** -0.5, b, h, 1),
                   f"{pre}.res_conv.bias": r(0.05, b),
                   f"{pre}.skip_conv.weight": r(h ** -0.5, b, h, 1),
                   f"{pre}.skip_conv.bias": r(0.05, b)})
    torch.save({k: torch.from_numpy(np.asarray(v, np.float32)) for k, v in sd.items()}, str(path))


def write_am_mvn(np, path, dim: int, seed: int) -> None:
    """A FunASR am.mvn (<AddShift> / <Rescale>) of ``dim`` with log-mel-like
    statistics (shift about -8, scale about 0.25)."""
    rng = np.random.default_rng(seed)
    vec = lambda v: "[ " + " ".join(f"{x:.6f}" for x in v) + " ]"  # noqa: E731
    shift, scale = -8.0 + rng.standard_normal(dim), 0.25 + 0.05 * rng.random(dim)
    Path(path).write_text(f"<Nnet>\n<Splice> {dim} {dim}\n[ 0 ]\n<AddShift> {dim} {dim}\n"
                          f"<LearnRateCoef> 0 {vec(shift)}\n<Rescale> {dim} {dim}\n"
                          f"<LearnRateCoef> 0 {vec(scale)}\n</Nnet>\n")


def check_pyannet_against_cpu(torch, np) -> None:
    """PyanNet at pyannote/segmentation's published widths, imported from a
    checkpoint written here, on the card (cuDNN LSTM, one call a layer and
    direction) against the same weights on the CPU: a 10 s ragged batch
    (10 s and 7.3 s), 1e-3 x max|ref| of the probabilities as the other
    stages; then one call of the engine's shape on the card (the 20 s
    mixture in the 32 s bucket): its wall, device ops and device time."""
    from audio_classification_tpu_torch.convert.torch_import import load_pyannet_torch
    from audio_classification_tpu_torch.models.pyannet import PyanNet, reduce_overlap_channels

    work = ROOT / "build" / "chip_smoke"
    work.mkdir(parents=True, exist_ok=True)
    write_pyannote_checkpoint(torch, np, work / "segmentation.ckpt", seed=21)
    cfg, sd = load_pyannet_torch(str(work / "segmentation.ckpt"))
    assert (cfg.n_filters, cfg.analytic, cfg.conv_channels, cfg.lstm_hidden, cfg.lstm_layers,
            cfg.linear_dims, cfg.num_classes, cfg.frame_period) == (
        80, True, (60, 60), 128, 4, (128, 128), 3, 270), cfg
    models = {}
    for d in ("cuda", "cpu"):
        models[d] = PyanNet(cfg)
        models[d].load_state_dict(sd)
        models[d].to(d).eval()
    src = talkers(10 * SR, 31)
    wav = np.stack([sum(src) / 3.0, np.where(np.arange(10 * SR) < 7.3 * SR, src[1], 0.0)])
    wav = (0.6 * wav / np.abs(wav).max()).astype(np.float32)
    lens = np.array([10 * SR, int(7.3 * SR)], np.int64)
    outs = {}
    with torch.inference_mode():
        for d, m in models.items():
            outs[d] = m(torch.from_numpy(wav).to(d), torch.from_numpy(lens).to(d)).cpu()
    ref = outs["cpu"]
    rel = (outs["cuda"] - ref).abs().max().item() / ref.abs().max().item()
    frames = [int(cfg.out_frames(int(n))) for n in lens]
    assert outs["cuda"].shape == (2, frames[0], 3) and not outs["cuda"][1, frames[1]:].any()
    assert math.isfinite(rel) and rel <= 1e-3, rel

    mix = sum(talkers(20 * SR, 3)) / 3.0
    batch = np.zeros((1, 32 * SR), np.float32)
    batch[0, : 20 * SR] = 0.6 * mix / np.abs(mix).max()
    w, n = torch.from_numpy(batch).cuda(), torch.tensor([20 * SR], device="cuda")
    with torch.inference_mode():
        call = device_ops(torch, lambda: reduce_overlap_channels(models["cuda"](w, n)))
    log({"phase": "pyannet_vs_cpu", "rel_err": rel, "tol_rel": 1e-3, "frames": frames,
         "frame_period": cfg.frame_period, "lstm_calls": cfg.lstm_layers * 2,
         "osd_call_20s_in_32s_bucket": call, "device": gpu_name_and_power_limit()})

def check_bf16_paths_against_cpu(torch, np) -> None:
    """The paths this port opened to ``compute_dtype="bfloat16"`` after the
    flagship, on the card against the same bf16 models on the CPU, as
    ``check_bf16_against_cpu`` holds the flagship's stages: each output's
    tolerance is the distance between the CPU's bf16 and float32 runs on
    the same input (max |.| over max |float32|). The recognizers at the full
    preset (seeded weights) on two 4 s items: Paraformer's logits on the
    fired tokens, the transducer's and whisper-style encoders' outputs; and
    their token ids (CIF counts and ids, greedy and modified beam search,
    whisper's KV-cache greedy), which must equal the CPU's bf16 ids wherever
    the CPU's bf16 and float32 ids agree. PyanNet at pyannote/segmentation's
    widths (the float32 net on bf16-rounded weights) on a 10 s ragged
    batch. SenseVoice over a mesh of 4 shards on the one card: the logits
    and text of a 40 s utterance through the bf16 engine's ring."""
    from audio_classification_tpu_torch.convert.torch_import import load_pyannet_torch
    from audio_classification_tpu_torch.engine.runtime import (
        EnginePreset,
        ModelPack,
        StageEngine,
        _cast_copy,
        seeded_init_,
    )
    from audio_classification_tpu_torch.models.asr.paraformer import (
        Paraformer,
        paraformer_frontend,
        paraformer_greedy,
    )
    from audio_classification_tpu_torch.models.asr.sensevoice import sensevoice_frontend
    from audio_classification_tpu_torch.models.asr.transducer import (
        Transducer,
        transducer_frontend,
    )
    from audio_classification_tpu_torch.models.asr.whisper_style import (
        WhisperStyle,
        whisper_frontend,
    )
    from audio_classification_tpu_torch.models.pyannet import PyanNet, rounded_copy
    from audio_classification_tpu_torch.parallel.mesh import make_mesh

    bf = torch.bfloat16
    preset = EnginePreset()
    n = 4 * SR
    src = talkers(n, 3)
    wav = np.stack([sum(src) * 0.25, src[1] * 0.5]).astype(np.float32)
    lens = np.array([n, 3 * SR], np.int64)

    def paraformer(m, w, l, dt):
        feats, mask = paraformer_frontend(w, l, m.cfg)
        logits, counts = m(feats.to(dt), mask)
        ids, _ = paraformer_greedy(logits.float(), counts)
        rows = torch.arange(logits.shape[1], device=w.device)[None, :] < counts[:, None]
        return logits.float() * rows[..., None], {"counts": counts, "ids": ids}

    def transducer(m, w, l, dt):
        feats, mask = transducer_frontend(w, l, m.cfg)
        enc, emask = m.encoder(feats.to(dt), mask)
        return enc.float() * emask[..., None], {
            "greedy": m.greedy_decode(feats.to(dt), mask)[0],
            "beam4": m.beam_decode(feats.to(dt), mask, 4)[0]}

    def whisper(m, w, l, dt):
        feats, mask = whisper_frontend(w, l, m.cfg)
        mem, mmask = m.encode(feats.to(dt), mask)
        return mem.float() * mmask[..., None], {"greedy": m.greedy_decode(feats.to(dt), mask)[0]}

    def compare(outs):
        """outs: {run: (tensor, {name: ids})} for cuda / cpu bf16 and cpu f32."""
        peak = max(outs["cpu_f32"][0].abs().max().item(), 1e-12)
        rel = (outs["cuda"][0] - outs["cpu"][0]).abs().max().item() / peak
        gap = (outs["cpu"][0] - outs["cpu_f32"][0]).abs().max().item() / peak
        ids = {}
        for k in outs["cpu"][1]:
            same = bool(torch.equal(outs["cuda"][1][k], outs["cpu"][1][k]))
            bf16_kept = bool(torch.equal(outs["cpu"][1][k], outs["cpu_f32"][1][k]))
            ids[k] = {"equal_to_cpu_bf16": same, "cpu_bf16_equal_to_f32": bf16_kept,
                      "tokens": int((outs["cpu"][1][k] != 0).sum())}
            assert same or not bf16_kept, (k, ids[k])
        assert math.isfinite(rel) and rel <= gap, (rel, gap)
        return {"rel_err": rel, "tol_rel_bf16_vs_f32": gap, "ids": ids}

    report = {}
    for name, cls, cfg, run in (("paraformer", Paraformer, preset.paraformer, paraformer),
                                ("transducer", Transducer, preset.transducer, transducer),
                                ("whisper", WhisperStyle, preset.whisper, whisper)):
        outs = {}
        for d, run_name in (("cuda", "cuda"), ("cpu", "cpu")):
            model = seeded_init_(cls(cfg), torch.Generator().manual_seed(0)).to(d).eval()
            copies = {run_name: _cast_copy(model, bf)}
            if d == "cpu":
                copies["cpu_f32"] = model
            for key, m in copies.items():
                dt = bf if key != "cpu_f32" else torch.float32
                with torch.inference_mode():
                    x, ids = run(m, torch.from_numpy(wav).to(d), torch.from_numpy(lens).to(d), dt)
                outs[key] = (x.float().cpu(), {k: v.cpu() for k, v in ids.items()})
        report[name] = compare(outs)

    # PyanNet: its bf16 copy (weights rounded, band edges and LSTM bias sums
    # in bf16) on both devices, and the float32 net on the CPU
    work = ROOT / "build" / "chip_smoke"
    work.mkdir(parents=True, exist_ok=True)
    write_pyannote_checkpoint(torch, np, work / "segmentation.ckpt", seed=21)
    pcfg, sd = load_pyannet_torch(str(work / "segmentation.ckpt"))
    psrc = talkers(10 * SR, 31)
    pwav = np.stack([sum(psrc) / 3.0, np.where(np.arange(10 * SR) < 7.3 * SR, psrc[1], 0.0)])
    pwav = (0.6 * pwav / np.abs(pwav).max()).astype(np.float32)
    plens = np.array([10 * SR, int(7.3 * SR)], np.int64)
    outs = {}
    for d in ("cuda", "cpu"):
        model = PyanNet(pcfg)
        model.load_state_dict(sd)
        model = model.to(d).eval()
        runs = {d: rounded_copy(model, bf), **({"cpu_f32": model} if d == "cpu" else {})}
        for key, m in runs.items():
            with torch.inference_mode():
                outs[key] = (m(torch.from_numpy(pwav).to(d), torch.from_numpy(plens).to(d))
                             .float().cpu(), {})
    report["pyannet"] = compare(outs)

    # SenseVoice over 4 shards of the one card: a 40 s utterance (64 s
    # bucket, 1067 + 4 frames: 268 a shard, the ring's dense blocks)
    speech = sum(talkers(40 * SR, 33)) / 3.0
    speech = (0.6 * speech / np.abs(speech).max()).astype(np.float32)
    outs, texts = {}, {}
    for d in ("cuda", "cpu"):
        pack = ModelPack(EnginePreset(), seed=0, device=d)
        mesh = make_mesh(LONG_SHARDS, devices=[d] * LONG_SHARDS)
        runs = {d: StageEngine(pack, mesh=mesh, compute_dtype="bfloat16")}
        if d == "cpu":
            runs["cpu_f32"] = StageEngine(pack, mesh=mesh)
        for key, eng in runs.items():
            t = eng.buckets.long_bucket_for(len(speech))
            with torch.inference_mode():
                w = torch.zeros((1, t), device=d)
                w[0, : len(speech)] = torch.from_numpy(np.round(speech * 32768) / 32768).to(d)
                feats, mask = sensevoice_frontend(w, torch.tensor([len(speech)], device=d),
                                                  pack.asr_cfg)
                logits = eng.models["asr"](feats.to(eng.compute_dtype), mask, mesh=mesh,
                                           sp_axis="data").float()
            texts[key] = eng.transcribe_long(speech)
            outs[key] = (logits.cpu(), {})
    report["sensevoice, mesh of 4"] = {**compare(outs), "texts": {
        "equal_to_cpu_bf16": texts["cuda"] == texts["cpu"],
        "cpu_bf16_equal_to_f32": texts["cpu"] == texts["cpu_f32"], "len": len(texts["cpu"])}}
    assert texts["cuda"] == texts["cpu"] or texts["cpu"] != texts["cpu_f32"], report
    log({"phase": "bf16_paths_vs_cpu", **report})


def device_ops(torch, fn) -> dict:
    """One call of fn after a warm one: its wall, then the device ops it
    queued and their device time under torch.profiler (a second call)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    evs = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    us = sum(getattr(e, "device_time", None) or getattr(e, "cuda_time", 0.0) for e in evs)
    return {"wall_ms": wall * 1e3, "device_ops": len(evs), "device_ms": us / 1e3}


def queued_ops(torch, fn) -> int:
    """The device operations one call of fn queues (after a warm call),
    counted on the host: the CUDA runtime and driver calls that enqueue work
    (kernel launches, memsets, copies) under torch.profiler. Late in this
    script the profiler's device-side records of a short call can go
    missing (no kernel at all for a K3 launch that ran, after the bf16 K4
    check's graph replays); these host-side records still arrive."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    enqueue = ("cudaLaunch", "cuLaunch", "cudaMemset", "cuMemset", "cudaMemcpy", "cuMemcpy")
    return sum(e.device_type != torch.autograd.DeviceType.CUDA and e.name.startswith(enqueue)
               for e in prof.events())


def _by_head_dim(counters: dict) -> dict:
    """K3's and K5's launches by head dim (the wrappers' second count)."""
    return {k: dict(sorted(wrapper.launches_by_head_dim.items()))
            for k, (wrapper, attr) in counters.items()
            if attr == "launches" and hasattr(wrapper, "launches_by_head_dim")}


def _counted(torch, counters: dict, expect: tuple, name: str, fn, unexpected: tuple = (),
             exact: dict = None, head_dims: dict = None):
    """Run one entry point with every launch count set to 0 just before and
    read just after (the entry points join their worker threads before they
    return); the kernels in ``expect`` must have been launched, those in
    ``unexpected`` must not, those in ``exact`` that many times, and for each
    (kernel, head dim) in ``head_dims`` at least that many launches at it."""
    for wrapper, attr in counters.values():
        setattr(wrapper, attr, 0)
        if hasattr(wrapper, "launches_by_head_dim"):
            wrapper.launches_by_head_dim.clear()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k: getattr(wrapper, attr) for k, (wrapper, attr) in counters.items()}
    by_dim = _by_head_dim(counters)
    log({"phase": "launches", "path": name, "wall_sec": wall, **launches,
         "by_head_dim": by_dim})
    for k in expect:
        assert launches[k] > 0, f"kernel {k} was not launched by {name}"
    for k in unexpected:
        assert launches[k] == 0, f"kernel {k} was launched by {name}"
    for k, n in (exact or {}).items():
        assert launches[k] == n, f"kernel {k}: {launches[k]} launches by {name}, expected {n}"
    for (k, d), n in (head_dims or {}).items():
        assert by_dim[k].get(d, 0) >= n, f"{k} at D = {d}: {by_dim[k]} by {name}, expected {n}"
    return out, launches


def run_paths(torch, np, counters: dict) -> dict:
    """The port's entry points at the full preset (seeded random weights),
    each with its launch counts -> total launches per kernel."""
    from audio_classification_tpu_torch.audio_io import read_wav, to_mono, write_wav
    from audio_classification_tpu_torch.cli import (
        benchmark_pipeline,
        mossformer_infer,
        offline_overlap_mvp,
        serve_streams,
        speaker_id_vad_asr,
        streaming_overlap_3src,
    )
    from audio_classification_tpu_torch.cli.offline_overlap_3src import main as overlap3_main
    from audio_classification_tpu_torch.models import facades
    from audio_classification_tpu_torch.pipelines.serving import StreamingServer

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

    def flagship(name, argv, kind, expect, unexpected=(), head_dims=None):
        (out_dir, result), launches = _counted(torch, counters, expect, name, lambda: overlap3_main(
            [*argv, "--target-wav", str(work / "target.wav"), "--preset", "full", "--seed", "0",
             "--sv-threshold", "-1", "--out-dir", str(work / "out")]), unexpected,
            head_dims=head_dims)
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

    # pyannet-flagship: the same CLI with pyannote's OSD model from a
    # segmentation checkpoint, an asteroid Conv-TasNet for the 3-source
    # separator and an am.mvn for SenseVoice's LFR features (all written
    # here at the published widths; PyanNet replaces OSDNet, so no K3 at
    # T = 800), forced through the hysteresis flags (onset = offset = 0:
    # every frame overlapped, with min_on / min_off 0.1; 1: every frame
    # clean) and traced with --profile-dir: the trace must name the stage
    # ranges the scene runs
    from audio_classification_tpu_torch.engine.runtime import EnginePreset

    preset = EnginePreset()
    write_asteroid_convtasnet(torch, np, work / "convtasnet.pth", preset.sep3, seed=22)
    write_am_mvn(np, work / "am.mvn", preset.asr.lfr_m * preset.asr.num_mel, seed=23)
    write_pyannote_checkpoint(torch, np, work / "segmentation.ckpt", seed=21)
    files = ["--osd-checkpoint", str(work / "segmentation.ckpt"), "--sep-checkpoint",
             str(work / "convtasnet.pth"), "--cmvn", str(work / "am.mvn")]
    for scene, hyst, expect in (
            ("overlap", ["--osd-onset", "0.0", "--osd-offset", "0.0", "--osd-min-on", "0.1",
                         "--osd-min-off", "0.1"],
             ("fbank_power_mel", "tcn_masker", "flash_attention")),
            ("clean", ["--osd-onset", "1.0", "--osd-offset", "1.0"],
             ("fbank_power_mel", "flash_attention"))):
        prof = work / f"profile_{scene}"
        shutil.rmtree(prof, ignore_errors=True)
        r = flagship(f"pyannet-flagship {scene}",
                     ["--input-wavs", str(work / "mix.wav"), *files, *hyst,
                      "--profile-dir", str(prof)], scene, expect)
        assert r.metrics["segments_total"] > 0
        traces = list(prof.glob("torch_trace_*.json"))
        assert len(traces) == 1, traces
        events = json.loads(traces[0].read_text())["traceEvents"]
        ranges = sorted({e["name"] for e in events if str(e.get("name", "")).startswith("engine.")})
        assert {"engine.osd", "engine.asr", f"engine.{scene}"} <= set(ranges), ranges
        log({"phase": "profile_trace", "path": f"pyannet-flagship {scene}",
             "file": traces[0].name, "bytes": traces[0].stat().st_size, "events": len(events),
             "cuda_events": sum(e.get("cat") == "kernel" for e in events),
             "stage_ranges": ranges})

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

    # flagship CLI under --quant int8: the same 20 s mixture, forced overlap.
    # The separator's encoder, bottleneck, mask conv and decoder and the
    # SenseVoice projections run dynamic int8; the masker streams int8 weights
    # through K2-s8 (F = 31999) and the float entry point stays unlaunched
    r = flagship("overlap3 --quant int8", ["--input-wavs", str(work / "mix.wav"),
                                           "--osd-thr", "0.0", "--quant", "int8"],
                 "overlap", ("fbank_power_mel", "tcn_masker_s8", "flash_attention"),
                 unexpected=("tcn_masker",))
    assert r.metrics["segments_overlap_streams"] > 0

    # --compute-dtype bfloat16: the flagship scenes on both backends and the
    # int8 overlap scene. The masker runs its bf16 entry points and the
    # float32 ones stay unlaunched; MossFormer's first GAU layer takes bf16
    # q, k, v and the seven after it float32 (the kernel's float32 output
    # promotes the stream); K3 is fed float32 (the encoders' positional
    # table promotes their streams)
    bf16 = ["--compute-dtype", "bfloat16"]
    masker_entries = ("tcn_masker", "tcn_masker_s8", "tcn_masker_bf16", "tcn_masker_s8_bf16")
    r = flagship("overlap3 --compute-dtype bfloat16 --osd-thr 0.0",
                 ["--input-wavs", str(work / "mix.wav"), "--osd-thr", "0.0", *bf16], "overlap",
                 ("fbank_power_mel", "tcn_masker_bf16", "flash_attention"),
                 unexpected=tuple(k for k in masker_entries if k != "tcn_masker_bf16"))
    assert r.metrics["segments_overlap_streams"] > 0
    r = flagship("overlap3 --compute-dtype bfloat16 --osd-thr 1.0",
                 ["--input-wavs", str(work / "mix.wav"), "--osd-thr", "1.0", *bf16], "clean",
                 ("fbank_power_mel", "flash_attention"), unexpected=masker_entries)
    assert r.metrics["segments_clean"] > 0
    r = flagship("overlap3 --compute-dtype bfloat16 --sep-backend mossformer",
                 ["--input-wavs", str(work / "mix2.wav"), "--osd-thr", "0.0",
                  "--sep-backend", "mossformer", *bf16], "overlap",
                 ("fbank_power_mel", "gau_attention_bf16", "gau_attention"))
    assert r.metrics["segments_overlap_streams"] > 0
    r = flagship("overlap3 --compute-dtype bfloat16 --sep-backend mossformer --osd-thr 1.0",
                 ["--input-wavs", str(work / "mix2.wav"), "--osd-thr", "1.0",
                  "--sep-backend", "mossformer", *bf16], "clean",
                 ("fbank_power_mel",), unexpected=("gau_attention", "gau_attention_bf16"))
    assert r.metrics["segments_clean"] > 0
    r = flagship("overlap3 --compute-dtype bfloat16 --quant int8",
                 ["--input-wavs", str(work / "mix.wav"), "--osd-thr", "0.0", "--quant", "int8",
                  *bf16], "overlap",
                 ("fbank_power_mel", "tcn_masker_s8_bf16", "flash_attention"),
                 unexpected=tuple(k for k in masker_entries if k != "tcn_masker_s8_bf16"))
    assert r.metrics["segments_overlap_streams"] > 0

    # streaming application: a 12 s three-talker wav replayed as fast as it
    # goes, captured in 1024-sample chunks and analysed in blocks of
    # 31 x 1024 samples by the pipeline's worker thread. The worker prints a
    # chunk's failure and goes on, so the proof that none was swallowed is
    # that every block fed comes out analysed, with its three
    # full_separation records (--sv-threshold -1 emits every branch)
    mix12 = sum(talkers(12 * SR, 6)) / 3.0
    write_wav(work / "stream.wav", 0.6 * mix12 / np.abs(mix12).max(), SR)
    block = int(SR * 2.0 / 1024) * 1024
    fed = -(-12 * SR // block)
    for quant, kernel, other in (("int8", "tcn_masker_s8", "tcn_masker"),
                                 ("none", "tcn_masker", "tcn_masker_s8")):
        name = f"streaming_overlap_3src --quant {quant}"
        app, launches = _counted(
            torch, counters, ("fbank_power_mel", kernel), name,
            lambda: streaming_overlap_3src.main(
                ["--target-wav", str(work / "target.wav"), "--input-wav",
                 str(work / "stream.wav"), "--no-realtime", "--process-seconds", "2.0",
                 "--quant", quant, "--sv-threshold", "-1", "--preset", "full", "--seed", "0",
                 "--output-dir", str(work / "out_stream")]), (other,))
        add(launches)
        stats = app.pipeline.latency_stats()
        assert not app.pipeline._worker.is_alive()
        assert stats["chunks"] == fed, (stats, fed)
        recs = app.all_results
        assert sum(x["kind"] == "full_separation" for x in recs) == 3 * fed, len(recs)
        assert all(math.isfinite(x["sv_score"]) for x in recs)
        assert launches[kernel] >= fed
        log({"phase": "pipeline", "path": name, "windows_fed": fed, **stats,
             "records": len(recs),
             "kinds": {k: sum(x["kind"] == k for x in recs)
                       for k in ("clean", "overlap", "full_separation")}})

    # ... and a few blocks of it (6 s: three windows) at bf16
    write_wav(work / "stream6.wav", 0.6 * mix12[: 6 * SR] / np.abs(mix12).max(), SR)
    fed6 = -(-6 * SR // block)
    name = "streaming_overlap_3src --compute-dtype bfloat16"
    app, launches = _counted(
        torch, counters, ("fbank_power_mel", "tcn_masker_bf16"), name,
        lambda: streaming_overlap_3src.main(
            ["--target-wav", str(work / "target.wav"), "--input-wav", str(work / "stream6.wav"),
             "--no-realtime", "--process-seconds", "2.0", "--compute-dtype", "bfloat16",
             "--sv-threshold", "-1", "--preset", "full", "--seed", "0",
             "--output-dir", str(work / "out_stream_bf16")]), ("tcn_masker",))
    add(launches)
    stats = app.pipeline.latency_stats()
    assert not app.pipeline._worker.is_alive() and stats["chunks"] == fed6, (stats, fed6)
    recs = app.all_results
    assert sum(x["kind"] == "full_separation" for x in recs) == 3 * fed6, len(recs)
    assert all(math.isfinite(x["sv_score"]) for x in recs)
    log({"phase": "pipeline", "path": name, "windows_fed": fed6, **stats, "records": len(recs)})

    # multi-session server: 8 callers of 12 s (one recorded at 8 kHz), 2 s
    # windows, every tick batching one window of every session
    calls = []
    for i in range(8):
        call = sum(talkers(12 * SR, 20 + i, f0s=(100.0 + 9 * i, 170.0 + 11 * i, 240.0 + 13 * i)))
        call = 0.6 * call / np.abs(call).max()
        calls.append(work / f"call{i}.wav")
        write_wav(calls[-1], call[::2] if i == 3 else call, SR // 2 if i == 3 else SR)
    records = work / "serving_records.jsonl"
    name = "serve_streams --quant int8"
    stats, launches = _counted(
        torch, counters, ("fbank_power_mel", "tcn_masker_s8"), name, lambda: serve_streams.main(
            ["--wavs", *map(str, calls), "--targets", str(work / "target.wav"),
             "--process-seconds", "2.0", "--max-batch", "16", "--quant", "int8",
             "--sv-threshold", "-1", "--preset", "full", "--seed", "0", "--out", str(records)]),
        ("tcn_masker",))
    add(launches)
    log({"phase": "serving_stats", "path": name, "device": gpu_name_and_power_limit(), **stats})
    windows = 12 * SR // (2 * SR)
    assert stats["sessions"] == 8 and stats["chunks_dropped"] == 0, stats
    assert stats["chunks_per_tick_max"] == 8 and stats["ticks"] >= windows, stats
    # chunks_per_tick_mean is rounded to 2 decimals
    assert abs(stats["chunks_per_tick_mean"] * stats["ticks"] - 8 * windows) \
        <= 0.005 * stats["ticks"] + 1e-9, stats
    recs = [json.loads(x) for x in records.read_text().splitlines()]
    for sid in range(8):
        full = [x for x in recs if x["session"] == sid and x["kind"] == "full_separation"]
        assert len(full) == 3 * windows, (sid, len(full))
    assert all(math.isfinite(x["sv_score"]) for x in recs)
    assert launches["tcn_masker_s8"] >= windows

    # the server's own resampler: the CLI above resamples a whole file on its
    # way in, so two sessions of one recording, at 8 and at 16 kHz, go into
    # one tick here; the 8 kHz window is resampled inside the tick
    args = serve_streams.parse_args(
        ["--wavs", "-", "--targets", str(work / "target.wav"), "--quant", "int8",
         "--sv-threshold", "-1", "--preset", "full", "--seed", "0"])
    call = to_mono(read_wav(calls[0])[0])

    def mixed_rates():
        server = StreamingServer(args, autostart=False)
        try:
            s8 = server.open_session(target_wav=str(work / "target.wav"))
            s16 = server.open_session(target_wav=str(work / "target.wav"))
            server.add_audio(s8, call[: 2 * SR: 2], sample_rate=SR // 2)
            server.add_audio(s16, call[: 2 * SR])
            assert server.step() == 2
            return server.get_results(s8), server.get_results(s16)
        finally:
            server.close()

    (got8, got16), launches = _counted(torch, counters, ("fbank_power_mel", "tcn_masker_s8"),
                                       "StreamingServer, 8 and 16 kHz sessions", mixed_rates)
    add(launches)
    for got in (got8, got16):
        assert sum(x["kind"] == "full_separation" for x in got) == 3, got
        assert all(math.isfinite(x["sv_score"]) for x in got)

    # one serving tick at bf16 with the int8 weight stream: two sessions'
    # first 2 s windows batched into K2-s8's bf16 entry point
    args_bf16 = serve_streams.parse_args(
        ["--wavs", "-", "--targets", str(work / "target.wav"), "--quant", "int8",
         "--compute-dtype", "bfloat16", "--sv-threshold", "-1", "--preset", "full",
         "--seed", "0"])

    def bf16_tick():
        server = StreamingServer(args_bf16, autostart=False)
        try:
            sids = [server.open_session(target_wav=str(work / "target.wav")) for _ in range(2)]
            for sid, path in zip(sids, calls[:2]):
                server.add_audio(sid, to_mono(read_wav(path)[0])[: 2 * SR])
            assert server.step() == 2
            return [server.get_results(sid) for sid in sids]
        finally:
            server.close()

    got, launches = _counted(torch, counters, ("fbank_power_mel", "tcn_masker_s8_bf16"),
                             "StreamingServer --compute-dtype bfloat16 --quant int8, one tick",
                             bf16_tick, ("tcn_masker", "tcn_masker_s8", "tcn_masker_bf16"))
    add(launches)
    for g in got:
        assert sum(x["kind"] == "full_separation" for x in g) == 3, g
        assert all(math.isfinite(x["sv_score"]) for x in g)

    # the other three ASR families through the flagship CLI (seeded weights:
    # a value that is not an .onnx file selects the family), on the 20 s
    # mixture forced to overlap and forced clean. In the 32 s bucket the
    # Paraformer encoder (dim 320, 4 heads) runs K3 at T = 533, D = 80; the
    # transducer's at T = 800 and the whisper-style at T = 1600, both D = 64;
    # OSDNet runs K3 at T = 800, D = 64 on every path
    families = (
        ("paraformer", ["--paraformer", "seeded"], 80),
        ("transducer", ["--encoder", "seeded", "--decoder", "seeded", "--joiner", "seeded"], 64),
        ("transducer, modified_beam_search",
         ["--encoder", "seeded", "--decoder", "seeded", "--joiner", "seeded",
          "--decoding-method", "modified_beam_search", "--num-active-paths", "4"], 64),
        ("whisper", ["--whisper-encoder", "seeded", "--whisper-decoder", "seeded"], 64))
    for family, flags, head_dim in families:
        for thr, kind in (("0.0", "overlap"), ("1.0", "clean")):
            r = flagship(f"overlap3 {family} --osd-thr {thr}",
                         ["--input-wavs", str(work / "mix.wav"), "--osd-thr", thr, *flags], kind,
                         ("fbank_power_mel", "flash_attention"),
                         head_dims={("flash_attention", head_dim): 1})
            assert r.metrics["segments_total"] > 0

    # --compute-dtype bfloat16 with each of those families, and with PyanNet
    # serving OSD, forced to overlap: the masker runs its bf16 entry point
    # and K3 takes float32 (each encoder's float32 positional table promotes
    # its stream, as in JAX: tests/test_torch_bf16_kernels.py records it in
    # both packages), so K3's and K5's bf16 entry points stay unlaunched
    attn_bf16 = ("flash_attention_bf16", "flash_attention_stats_bf16")
    for family, flags, head_dim in families:
        r = flagship(f"overlap3 {family} --compute-dtype bfloat16 --osd-thr 0.0",
                     ["--input-wavs", str(work / "mix.wav"), "--osd-thr", "0.0", *flags, *bf16],
                     "overlap", ("fbank_power_mel", "tcn_masker_bf16", "flash_attention"),
                     unexpected=attn_bf16 + ("tcn_masker",),
                     head_dims={("flash_attention", head_dim): 1})
        assert r.metrics["segments_overlap_streams"] > 0
    r = flagship("pyannet-flagship --compute-dtype bfloat16 overlap",
                 ["--input-wavs", str(work / "mix.wav"), *files, "--osd-onset", "0.0",
                  "--osd-offset", "0.0", "--osd-min-on", "0.1", "--osd-min-off", "0.1", *bf16],
                 "overlap", ("fbank_power_mel", "tcn_masker_bf16", "flash_attention"),
                 unexpected=attn_bf16 + ("tcn_masker",))
    assert r.metrics["segments_overlap_streams"] > 0

    # the speaker-ID product: a synthetic set of 4 talkers x 2 enrollment
    # wavs and 8 test wavs (one at 8 kHz), through both CLIs at the full
    # preset; their output files are read back
    sid = work / "sid"
    sid.mkdir(parents=True, exist_ok=True)
    enroll, tests = [], []
    for i, f0 in enumerate((110.0, 150.0, 205.0, 260.0)):
        for j in range(2):
            x = talkers((3 + j) * SR, 40 + 2 * i + j, f0s=(f0,))[0]
            write_wav(sid / f"spk{i}_enroll_{j}.wav", 0.5 * x / np.abs(x).max(), SR)
            enroll.append(f"spk{i} {sid / f'spk{i}_enroll_{j}.wav'}")
        for j in range(2):
            x = talkers((2 + j) * SR, 60 + 2 * i + j, f0s=(f0 * (1.03 if j else 0.97),))[0]
            x = 0.5 * x / np.abs(x).max()
            low = (i, j) == (1, 1)
            write_wav(sid / f"spk{i}_test_{j}.wav", x[::2] if low else x, SR // 2 if low else SR)
            tests.append(f"spk{i} {sid / f'spk{i}_test_{j}.wav'}")
    (sid / "speakers.txt").write_text("\n".join(enroll) + "\n")
    (sid / "test.txt").write_text("\n".join(tests) + "\n")
    base = ["--speaker-file", str(sid / "speakers.txt"), "--test-list", str(sid / "test.txt"),
            "--preset", "full", "--threshold", "0.3"]
    (out_dir, summary), launches = _counted(
        torch, counters, ("fbank_power_mel",), "benchmark_pipeline --batch-mode",
        lambda: benchmark_pipeline.main([*base, "--sense-voice", "seeded", "--batch-mode",
                                         "--out-dir", str(sid / "out_bench")]))
    add(launches)
    for fname in ("predictions.csv", "detail.jsonl", "summary.json", "summary.txt"):
        assert (out_dir / fname).is_file(), fname
    assert summary["total_utts"] == 8 and summary["train_speakers"] == 4, summary
    assert len((out_dir / "predictions.csv").read_text().splitlines()) == 9
    log({"phase": "pipeline", "path": "benchmark_pipeline", **{
        k: summary[k] for k in ("total_utts", "train_speakers", "correct", "unknown",
                                "accuracy", "avg_sid_time", "avg_asr_time", "avg_rtf")}})
    run_dir, launches = _counted(
        torch, counters, ("fbank_power_mel",), "speaker_id_vad_asr --paraformer --apply-vad",
        lambda: speaker_id_vad_asr.main([*base, "--paraformer", "seeded", "--apply-vad",
                                         "--out-dir", str(sid / "out_spid")]))
    add(launches)
    rows = (run_dir / "predictions.csv").read_text().splitlines()
    report = (run_dir / "report.txt").read_text()
    assert len(rows) == 9 and "Test utterances: 8" in report and "Train speakers: 4" in report
    log({"phase": "pipeline", "path": "speaker_id_vad_asr", "report": report.splitlines()})
    return total


def run_long_form(torch, np, counters: dict) -> dict:
    """The long-form entry points at the full preset (seeded random weights)
    on n shards of the one card, each with its launch counts -> total
    launches per kernel."""
    from audio_classification_tpu_torch.engine.runtime import EnginePreset, ModelPack, StageEngine
    from audio_classification_tpu_torch.models import facades
    from audio_classification_tpu_torch.models.asr.paraformer import cif_integrate
    from audio_classification_tpu_torch.models.asr.sensevoice import sensevoice_frontend
    from audio_classification_tpu_torch.parallel.mesh import make_mesh

    total = {k: 0 for k in counters}
    pack = ModelPack(EnginePreset(), seed=0, device="cuda")
    layers = pack.asr_cfg.layers
    assert (pack.asr_cfg.dim, pack.asr_cfg.heads, layers) == (512, 8, 12)
    single = StageEngine(pack)
    ring4 = StageEngine(pack, mesh=make_mesh(LONG_SHARDS))
    ring8 = StageEngine(pack, mesh=make_mesh(8))
    speech = sum(talkers(LONG_SEC * SR, 30)) / 3.0
    speech = (0.6 * speech / np.abs(speech).max()).astype(np.float32)

    def transcribe(name, engine, wav, expect, exact, head_dims=None):
        text, launches = _counted(
            torch, counters, expect, name,
            lambda: facades.ASRRecognizer(engine).transcribe(wav, SR, long_form=True),
            exact=exact, head_dims=head_dims)
        for k, n in launches.items():
            total[k] += n
        return text

    # a 200 s utterance: the 256 s bucket, 4271 encoder frames. Over 4 shards
    # every block's attention is 4 x 4 K5 launches on 1068-frame blocks;
    # without a mesh it is one K3 launch at T = 4271
    text4 = transcribe(f"transcribe long_form, {LONG_SEC} s, mesh of {LONG_SHARDS}", ring4, speech,
                       ("fbank_power_mel",),
                       {"flash_attention_stats": layers * LONG_SHARDS ** 2, "flash_attention": 0})
    text1 = transcribe(f"transcribe long_form, {LONG_SEC} s, no mesh", single, speech,
                       ("fbank_power_mel",),
                       {"flash_attention": layers, "flash_attention_stats": 0})
    # a 100 s utterance over 8 shards: the 128 s bucket's 2138 frames make
    # 268 a shard, below the kernel's threshold of 512: the dense block
    half = speech[: LONG_SEC * SR // 2]
    text8 = transcribe(f"transcribe long_form, {LONG_SEC // 2} s, mesh of 8", ring8, half,
                       ("fbank_power_mel",), {"flash_attention_stats": 0, "flash_attention": 0})
    text8_ref = single.transcribe_long(half)

    # the CTC logits of the ring against those of the one-shard path, on the
    # utterance's own frames: float32 through 12 blocks on two attention
    # kernels that add in different orders. 1e-3 of max|logit|
    with torch.inference_mode():
        t = single.buckets.long_bucket_for(len(speech))
        w = torch.zeros((1, t), device="cuda")
        w[0, : len(speech)] = torch.from_numpy(np.round(speech * 32768) / 32768).to("cuda")
        lens = torch.tensor([len(speech)], device="cuda")
        feats, mask = sensevoice_frontend(w, lens, pack.asr_cfg)
        dense = pack.models["asr"](feats, mask)
        ring = pack.models["asr"](feats, mask, mesh=ring4.mesh, sp_axis="data")
    assert dense.shape == ring.shape == (1, LONG_T, pack.asr_cfg.vocab_size), dense.shape
    valid = torch.cat([torch.ones((1, pack.asr_cfg.num_prompt), dtype=torch.bool, device="cuda"),
                       mask], dim=1)[..., None]
    assert int(valid.sum()) == LONG_VALID_T
    err = ((dense - ring).abs() * valid).max().item()
    peak = (dense.abs() * valid).max().item()
    same_ids = ((dense.argmax(-1) == ring.argmax(-1)) | ~valid[..., 0]).float().mean().item()
    log({"phase": "long_form", "seconds": LONG_SEC, "bucket_samples": t, "frames": LONG_T,
         "valid_frames": LONG_VALID_T, "logits_max_abs_diff": err, "logits_peak": peak,
         "rel_err": err / peak, "tol_rel": 1e-3, "frames_with_equal_argmax": same_ids,
         "text_len": len(text1), "texts_equal": text4 == text1,
         "texts_equal_8_shards": text8 == text8_ref, "text_head": text1[:60]})
    assert torch.isfinite(dense).all() and torch.isfinite(ring).all()
    assert err <= 1e-3 * peak, (err, peak)
    assert text4 == text1 and len(text1) > 0, (text4[:80], text1[:80])
    assert text8 == text8_ref and len(text8) > 0, (text8[:80], text8_ref[:80])

    # time-sharded separation over 4 shards against the batched stage of the
    # same engine. Both get audio on the int16 grid (the batched stage
    # quantises its input, the long path does not). The batched stage pads to
    # a bucket, and MossFormer scales its attention by 1 / (frames of the
    # padded batch), so its mixture fills a bucket exactly (128000 samples,
    # 16 s at its 8 kHz); Conv-TasNet's masked forward does not depend on the
    # padding and takes 20 s. The long path is dense PyTorch per shard, the
    # batched stage runs K2 / K4: float32 through 24 TCN blocks or 8 GAU
    # layers, 1e-3 of max|ref| as for the stages against the CPU
    mesh = make_mesh(LONG_SHARDS)
    for backend, n_src, kernel, n in (("convtasnet", 3, "tcn_masker", 20 * SR),
                                      ("mossformer", 2, "gau_attention", 128000)):
        sep = facades.Separator(backend=backend, n_src=n_src, engine=single)
        assert backend != "mossformer" or n in single.buckets.lengths
        mix = sum(talkers(n, 31)[:n_src]) / n_src
        mix = (np.round(0.6 * mix / np.abs(mix).max() * 32768) / 32768).astype(np.float32)
        name = f"separate_long --backend {backend}, {n / sep.sample_rate:g} s, " \
               f"mesh of {LONG_SHARDS}"
        got, launches = _counted(torch, counters, (), name,
                                 lambda: sep.separate_long(mix, sep.sample_rate, mesh),
                                 exact={k: 0 for k in counters})
        ref, _ = _counted(torch, counters, (kernel,), f"separate --backend {backend}, same mixture",
                          lambda: sep.separate(mix, sep.sample_rate))
        got, ref = np.stack(got), np.stack(ref)
        assert got.shape == ref.shape == (n_src, n) and np.isfinite(got).all() and got.any()
        rel = float(np.abs(got - ref).max() / np.abs(ref).max())
        log({"phase": "separate_long", "backend": backend, "n_src": n_src, "samples": n,
             "sample_rate": sep.sample_rate, "shards": LONG_SHARDS, "rel_err_vs_separate": rel,
             "tol_rel": 1e-3})
        assert rel <= 1e-3, (backend, rel)

    # the same utterance on bf16 engines, over 4 shards and without a mesh:
    # the encoder's stream is float32 past its positional table, so the
    # ring's K5 and the unsharded K3 take float32 as in JAX, and their bf16
    # entry points stay unlaunched
    attn_bf16 = {"flash_attention_bf16": 0, "flash_attention_stats_bf16": 0}
    text4b = transcribe(f"transcribe long_form, {LONG_SEC} s, mesh of {LONG_SHARDS}, bfloat16",
                        StageEngine(pack, mesh=make_mesh(LONG_SHARDS), compute_dtype="bfloat16"),
                        speech, ("fbank_power_mel",),
                        {"flash_attention_stats": layers * LONG_SHARDS ** 2, "flash_attention": 0,
                         **attn_bf16})
    text1b = transcribe(f"transcribe long_form, {LONG_SEC} s, no mesh, bfloat16",
                        StageEngine(pack, compute_dtype="bfloat16"), speech, ("fbank_power_mel",),
                        {"flash_attention": layers, "flash_attention_stats": 0, **attn_bf16})
    log({"phase": "long_form_bf16", "seconds": LONG_SEC, "text_len": len(text1b),
         "texts_equal": text4b == text1b, "texts_equal_float32": text1b == text1})
    assert text4b == text1b and len(text1b) > 0, (text4b[:80], text1b[:80])

    # K3 and K5's bf16 entry points, which no engine path feeds: a caller
    # reaches them through the op entry and through the ring, on bf16 q, k,
    # v as the JAX functions take them. The ring of 4 over the 4272 frames
    # of the long-form test above: 16 K5 launches of 1068-frame blocks
    gen = torch.Generator(device="cpu").manual_seed(9)
    t = -(-LONG_T // LONG_SHARDS) * LONG_SHARDS
    q, k, v = (torch.randn((1, t, 8, 64), generator=gen).cuda().to(torch.bfloat16)
               for _ in range(3))
    kv_mask = (torch.arange(t, device="cuda") < LONG_VALID_T)[None, :]
    from audio_classification_tpu_torch.ops.kernels import attention
    from audio_classification_tpu_torch.parallel.ring_attention import ring_attention

    ring, launches = _counted(
        torch, counters, (), f"ring_attention, bfloat16 q, k, v, mesh of {LONG_SHARDS}",
        lambda: ring_attention(q, k, v, make_mesh(LONG_SHARDS), kv_mask=kv_mask),
        exact={"flash_attention_stats_bf16": LONG_SHARDS ** 2, "flash_attention_stats": 0})
    for kk, nn in launches.items():
        total[kk] += nn
    qh, kh, vh = (z.transpose(1, 2).contiguous() for z in (q, k, v))
    k3, launches = _counted(
        torch, counters, (), "flash_attention op entry, bfloat16 q, k, v",
        lambda: attention.flash_attention(qh, kh, vh, kv_mask).transpose(1, 2),
        exact={"flash_attention_bf16": 1, "flash_attention": 0})
    for kk, nn in launches.items():
        total[kk] += nn
    # the ring merges K5's float32 triples. Against one K3 call on the same
    # bf16 values it rounds p against other running maxima (key blocks of
    # 1068 cut into 64-key tiles, not 64-key tiles from key 0), which moves
    # the output about as far as not rounding p at all (the twins on the
    # CPU: 1.16e-3 and 1.11e-3 of max|out| at this shape). So the ring is
    # held to twice the distance between K3 at bf16 and K3 at float32 on
    # the same values, on the valid rows
    rows = kv_mask[:, :, None, None]
    peak = (k3.abs() * rows).max().item()
    k3_f32 = attention.flash_attention(qh.float(), kh.float(), vh.float(), kv_mask).transpose(1, 2)
    diff = ((ring - k3).abs() * rows).max().item() / peak
    gap = ((k3_f32 - k3).abs() * rows).max().item() / peak
    log({"phase": "ring_attention_bf16", "shape": [1, t, 8, 64], "shards": LONG_SHARDS,
         "dtype_out": str(ring.dtype), "rel_diff_vs_flash_attention_bf16": diff,
         "rel_gap_bf16_vs_float32": gap, "tol_rel": 2 * gap})
    assert ring.dtype == torch.float32 and diff <= 2 * gap, (diff, gap)

    # the other three families on the same 200 s utterance, without a mesh
    # (K3 from T = 512 on: Paraformer's encoder at T = 4267, D = 80, 8 layers;
    # the transducer's at T = 6400 and the whisper-style one's at T = 12800,
    # D = 64, whose decoders then run frame by frame, whisper with a budget of
    # ceil(96 x 256 / 30) = 820 tokens), and Paraformer over 4 shards (K5 at
    # D = 80: 8 layers x 16 block pairs of 1067 frames)
    texts = {}
    for family, layers, head_dim in (("paraformer", 8, 80), ("transducer", 6, 64),
                                     ("whisper", 4, 64)):
        fpack = ModelPack(EnginePreset(), seed=0, device="cuda", asr_family=family)
        texts[family] = transcribe(
            f"transcribe long_form, {LONG_SEC} s, {family}, no mesh", StageEngine(fpack), speech,
            ("fbank_power_mel",), {"flash_attention": layers, "flash_attention_stats": 0},
            {("flash_attention", head_dim): layers})
        # one ASR call of the family on a 20 s stretch (the 32 s bucket): its
        # device ops, device time and wall; the decoders loop on the host
        eng = StageEngine(fpack)
        log({"phase": "family_device_ops", "family": family, "input_sec": 20,
             **device_ops(torch, lambda: eng.transcribe([speech[: 20 * SR]]))})
        if family == "transducer":
            bpack = ModelPack(EnginePreset(), seed=0, device="cuda", asr_family=family,
                              decoding_method="modified_beam_search", num_active_paths=4)
            beng = StageEngine(bpack)
            ops = device_ops(torch, lambda: beng.transcribe([speech[: 20 * SR]]))
            log({"phase": "family_device_ops", "family": "transducer, modified_beam_search",
                 "input_sec": 20, **ops})
        if family == "paraformer":
            # CIF alone at the 32 s bucket's 533 frames and dim 320
            h = torch.randn((1, 533, 320), generator=torch.Generator().manual_seed(3)).cuda()
            alpha = torch.rand((1, 533), generator=torch.Generator().manual_seed(4)).cuda() * 0.6
            log({"phase": "family_device_ops", "family": "paraformer, cif_integrate alone",
                 "frames": 533, **device_ops(torch, lambda: cif_integrate(h, alpha, 128))})
            texts["paraformer, mesh of 4"] = transcribe(
                f"transcribe long_form, {LONG_SEC} s, paraformer, mesh of {LONG_SHARDS}",
                StageEngine(fpack, mesh=make_mesh(LONG_SHARDS)), speech, ("fbank_power_mel",),
                {"flash_attention_stats": layers * LONG_SHARDS ** 2, "flash_attention": 0},
                {("flash_attention_stats", 80): layers * LONG_SHARDS ** 2})
            # at bf16, over 4 shards and without: float32 K5 / K3 at D = 80
            for mesh_b, exact in ((make_mesh(LONG_SHARDS), {
                    "flash_attention_stats": layers * LONG_SHARDS ** 2, "flash_attention": 0}),
                                  (None, {"flash_attention": layers, "flash_attention_stats": 0})):
                key = "paraformer, bfloat16" + (", mesh of 4" if mesh_b is not None else "")
                texts[key] = transcribe(
                    f"transcribe long_form, {LONG_SEC} s, {key}",
                    StageEngine(fpack, mesh=mesh_b, compute_dtype="bfloat16"), speech,
                    ("fbank_power_mel",), {**exact, **attn_bf16})
    log({"phase": "long_form_families", "seconds": LONG_SEC,
         "text_len": {k: len(v) for k, v in texts.items()},
         "paraformer_texts_equal": texts["paraformer"] == texts["paraformer, mesh of 4"],
         "paraformer_bf16_texts_equal": (texts["paraformer, bfloat16"]
                                         == texts["paraformer, bfloat16, mesh of 4"])})
    assert texts["paraformer"] == texts["paraformer, mesh of 4"]
    assert texts["paraformer, bfloat16"] == texts["paraformer, bfloat16, mesh of 4"]
    return total


def _grads(torch, fn, inputs, cots) -> tuple:
    """Gradients of sum(out * cot) over fn's outputs, for every input."""
    leaves = [x.detach().requires_grad_() for x in inputs]
    outs = fn(*leaves)
    outs = outs if isinstance(outs, tuple) else (outs,)
    return torch.autograd.grad(outs, leaves, cots)


def _grad_errs(got, ref) -> list:
    """Per input: max|got - ref| / max|ref|, in float64."""
    return [((g.double() - r.double()).abs().max() / r.double().abs().max().clamp_min(1e-30))
            .item() for g, r in zip(got, ref)]


def _grad_norm_errs(got, ref) -> list:
    """Per input: ||got - ref|| / ||ref||, in float64."""
    return [((g.double() - r.double()).norm() / r.double().norm().clamp_min(1e-30)).item()
            for g, r in zip(got, ref)]


def _stats_tied(q, k, v):
    """K5's (o, m, l) on a key block masked whole, in float64 and written
    out apart from the port: every score sits at the -1e9 bias, where
    float32 (ulp 64) makes them one number, so they are forced equal here
    while their gradient still flows (s - s.detach() - 1e9); the row max
    (amax) splits its gradient evenly among the ties, as jnp.max's does."""
    s = q @ k.transpose(-1, -2) / math.sqrt(q.shape[-1])
    s = s - s.detach() - 1e9
    m = s.amax(dim=-1)
    p = (s - m[..., None]).exp()
    return p @ v, m, p.sum(dim=-1)


def check_train_grads(torch, np) -> dict:
    """Each kernel's autograd Function (ops/kernels: the kernel's forward,
    the twin's backward) on the card against autograd in float64 on the same
    inputs, at the training paths' shapes: K4 at a 4 s 8 kHz MossFormer crop
    ([2, 3999], Dqk 128, De 768, keys 3999 / 3000 valid), K3 at SenseVoice's
    32 s crop ([2, 8, 537, 64], ragged), K5 at one ring shard of the 124 s
    crop ([1, 8, 1068, 64], 900 keys valid; and a block masked whole), K2
    over the full-preset stack ([2, 3999, 128], 24 blocks, H 512, f_len
    3999 / 3000). The float64 reference is the twin, except for the block
    masked whole: there every float32 score at the -1e9 bias is the same
    number (the row max splits its gradient among all keys, as in JAX),
    where float64 would keep them apart, so its reference is ``_stats_tied``.
    Per input the max error relative to max|grad| and the error's norm
    relative to the gradient's, held to fixed bounds: K3-K5 1e-4 of max;
    K2 2e-2 of max and 2e-3 in norm (float32 autodiff through the 24 gLN
    blocks of the seeded stack is itself 1.5e-2 of max and 1.1e-3 in norm
    from float64 at this shape: the Function's backward is that autodiff,
    on an NVIDIA H100 80GB HBM3 as on the CPU); beside them, logged,
    the float32 twin's own distance. Forward + backward ms (CUDA events
    around a loop of calls: the backward is torch code); SDPA's forward +
    backward on K3's masked inputs as the library time. An int8 stack's
    backward raises."""
    from audio_classification_tpu_torch.engine.runtime import EnginePreset, ModelPack
    from audio_classification_tpu_torch.ops.kernels import attention, gau, tcn

    dev = torch.device("cuda")
    gen = torch.Generator(device="cpu").manual_seed(31)

    def randn(*shape):
        return torch.randn(shape, generator=gen).to(dev)

    def lens_mask(t, lens):
        return torch.arange(t, device=dev)[None, :] < torch.tensor(lens, device=dev)[:, None]

    out = {}

    def case(name, fn, ref_fn, inputs, cots, tol, iters, flops, library=None, tol_norm=None,
             ref64=None):
        """``flops``: the forward's products over the valid keys / frames.
        The bound of forward + backward: the forward's products and the
        backward's two a forward product, all at the 3xTF32 rate (float32
        accuracy on the tensor cores), or the bytes (inputs, cotangents and
        gradients once each), the larger; beside it the same at the float32
        SIMT rate (``bound_simt_ms``). ``ref64``: the float64 reference
        when it is not ``ref_fn``."""
        got = _grads(torch, fn, inputs, cots)
        torch.cuda.synchronize()
        ref = _grads(torch, ref64 or ref_fn, [x.double() for x in inputs],
                     [c.double() for c in cots])
        errs, norms = _grad_errs(got, ref), _grad_norm_errs(got, ref)
        # the float32 twin's own autograd against the same reference, logged
        plain = _grads(torch, ref_fn, inputs, cots)
        rec = {"name": name, "shapes": [list(x.shape) for x in inputs], "rel_err": errs,
               "norm_rel_err": norms,
               "reference": "float64 twin" if ref64 is None else "float64, scores tied",
               "plain_rel_err": _grad_errs(plain, ref), "tol_rel": tol, "tol_norm": tol_norm,
               "fwd_bwd_ms": cuda_ms(torch, lambda: _grads(torch, fn, inputs, cots), iters),
               "plain_fwd_bwd_ms": cuda_ms(torch, lambda: _grads(torch, ref_fn, inputs, cots),
                                           iters),
               "library_fwd_bwd_ms": None if library is None else cuda_ms(
                   torch, lambda: _grads(torch, library, inputs, cots), iters)}
        nbytes = 4.0 * (2 * sum(x.numel() for x in inputs) + sum(c.numel() for c in cots))
        by_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
        by_ops = 3 * flops / PEAK_3XTF32_FLOPS * 1e3
        rec.update({"bound_ms": max(by_ops, by_bytes),
                    "bound_by": "operations" if by_ops >= by_bytes else "bytes",
                    "bound_simt_ms": max(3 * flops / PEAK_F32_FLOPS * 1e3, by_bytes)})
        log({"phase": "train_grads", **rec})
        assert all(math.isfinite(e) and e <= tol for e in errs), rec
        assert tol_norm is None or all(e <= tol_norm for e in norms), rec
        out.setdefault(name.split()[0], []).append(rec)

    # K4: MossFormer's 4 s crop
    t = 3999
    mask = lens_mask(t, [t, 3000])
    case("gau_attention", lambda q, k, v: gau.gau_attention(q, k, v, mask, 1.0 / t),
         lambda q, k, v: gau.gau_attention_reference(q, k, v, mask, 1.0 / t),
         [randn(2, t, 128), randn(2, t, 128), randn(2, t, 768)], [randn(2, t, 768)], 1e-4, 5,
         gau.work(2, t, 128, 768, valid_keys=[t, 3000])["flops"])
    # K3: SenseVoice's 32 s crop
    t = 537
    mask = lens_mask(t, [t, 440])
    qkv = [randn(2, 8, t, 64) for _ in range(3)]
    case("flash_attention", lambda q, k, v: attention.flash_attention(q, k, v, mask),
         lambda q, k, v: attention.attention_reference(q, k, v, mask), qkv,
         [randn(2, 8, t, 64)], 1e-4, 20,
         attention.work(2, 8, t, t, 64, valid_keys=[t, 440])["flops"],
         # yardstick only: the port never calls it
         library=lambda q, k, v: torch.nn.functional.scaled_dot_product_attention(
             q, k, v, attn_mask=mask[:, None, None, :]))
    # K5: one shard block of the ring, a ragged one and one masked whole
    t = 1068
    qkv = [randn(1, 8, t, 64) for _ in range(3)]
    cots = [randn(1, 8, t, 64), randn(1, 8, t), randn(1, 8, t)]
    for label, valid, ref64 in (("ragged", 900, None), ("masked whole", 0, _stats_tied)):
        mask = lens_mask(t, [valid])
        case(f"flash_attention_stats {label}",
             lambda q, k, v: attention.flash_attention_stats(q, k, v, mask),
             lambda q, k, v: attention.attention_stats_reference(q, k, v, mask), qkv, cots,
             1e-4, 20, attention.stats_work(1, 8, t, t, 64, valid_keys=[max(valid, 1)])["flops"],
             ref64=ref64)
    # K2: the full-preset stack at the 4 s crop
    model = ModelPack(EnginePreset(), seed=0, device=dev).models["sep3"]
    with torch.no_grad():
        st = tcn.stack_tcn_params(model.tcn_blocks())
        st8 = tcn.stack_tcn_params(model.tcn_blocks(), weight_quant=True)
    t = 3999
    f_len = torch.tensor([t, 3000], dtype=torch.int32, device=dev)
    g = randn(2, t, 128) * lens_mask(t, [t, 3000])[..., None]

    def masker(x, *stack):
        return tcn.fused_tcn_masker(x, f_len, dict(zip(tcn.STACK_KEYS, stack)), n_per_repeat=8)

    def masker_twin(x, *stack):
        return tcn.tcn_masker_reference(x, f_len, dict(zip(tcn.STACK_KEYS, stack)),
                                        n_per_repeat=8)

    # float32 autodiff through the 24 gLN blocks of the seeded stack is
    # itself 1.5e-2 of max and 1.1e-3 in norm from float64 at this shape
    # (its statistics' sums cancel): fixed bounds of 2e-2 and 2e-3
    case("tcn_masker", masker, masker_twin, [randn(2, t, 128), *(st[k] for k in tcn.STACK_KEYS)],
         [g], 2e-2, 3, tcn.work(2, t, 128, 512, 24, 0, f_len=[t, 3000])["flops"], tol_norm=2e-3)
    x = randn(1, 400, 128).requires_grad_()
    y = tcn.fused_tcn_masker(x, f_len[:1].clamp_max(400), st8, n_per_repeat=8)
    try:
        y.sum().backward()
    except NotImplementedError as e:
        log({"phase": "train_grads", "name": "tcn_masker_s8", "backward": "raises",
             "message": str(e)})
    else:
        raise AssertionError("the int8 stack's backward did not raise")
    return out


def _step_vs_cpu(torch, name, make, loss_fn, batch, dtype=None) -> dict:
    """One step's loss and gradients of ``make()``'s model (seeded init on
    the CPU, a copy moved to the card) on the card against the CPU in
    ``dtype``, TF32 off: the loss within 1e-3 relative and every gradient
    within 1e-3 of the largest |grad|. float32 by default; float64 for a
    path that runs no kernel of the port (Conv-TasNet's dense loop), whose
    float32 autodiff is itself ~2e-3 from float64 at its random init (its
    decoder and SI-SDR matrix stay float32 even then, as the reference
    computes them). Logged beside a float32 comparison, not held: each
    device's distance from the CPU in float64."""
    import copy

    dtype = dtype or torch.float32
    runs = {"cpu": ("cpu", dtype), "cuda": ("cuda", dtype)}
    if dtype != torch.float64:
        runs["cpu64"] = ("cpu", torch.float64)
    model = make().eval()  # as the trainers hold it: BatchNorm on its statistics
    res = {}
    for key, (dev, dt) in runs.items():
        m = copy.deepcopy(model).to(dev, dt)
        b = {k: v.to(dev, dt) if v.is_floating_point() else v.to(dev) for k, v in batch.items()}
        loss = loss_fn(m, b)
        loss.backward()
        res[key] = (float(loss.detach()), {n: p.grad.detach().cpu().double()
                                           for n, p in m.named_parameters() if p.grad is not None})
    (l_cpu, g_cpu), (l_gpu, g_gpu) = res["cpu"], res["cuda"]
    top = max(g.abs().max().item() for g in g_cpu.values())
    gerr = max((g_gpu[n] - g).abs().max().item() for n, g in g_cpu.items()) / top
    rec = {"phase": "train_step_vs_cpu", "path": name, "dtype": str(dtype).split(".")[-1],
           "loss_cuda": l_gpu, "loss_cpu": l_cpu, "loss_rel_err": abs(l_gpu - l_cpu) / abs(l_cpu),
           "grad_rel_err": gerr, "tol_rel": 1e-3, "n_grads": len(g_cpu)}
    if "cpu64" in res:
        l_64, g_64 = res["cpu64"]
        top64 = max(g.abs().max().item() for g in g_64.values())
        rec.update({"loss_cpu_float64": l_64, **{
            f"{d}_vs_float64_grad_rel_err": max((gd[n] - g).abs().max().item()
                                                for n, g in g_64.items()) / top64
            for d, gd in (("cpu", g_cpu), ("cuda", g_gpu))}})
    log(rec)
    assert set(g_gpu) == set(g_cpu), name
    assert rec["loss_rel_err"] <= 1e-3 and gerr <= 1e-3, rec
    return rec


def run_train_paths(torch, np, counters: dict) -> dict:
    """The three training CLIs through their main() on the card at full
    widths, each with its launch counts (K4 8 times a MossFormer forward,
    the dense Conv-TasNet loop no K2, K3 12 times a SenseVoice forward,
    K5 192 times a forward over 4 shards), their losses per step finite, a
    one-step card-vs-CPU check of each model and loss, and the exports
    loaded by offline_overlap_3src --sep-checkpoint / --spk-embed-model and
    Separator(checkpoint=) -> total launches per kernel."""
    from audio_classification_tpu_torch.audio_io import write_wav
    from audio_classification_tpu_torch.cli import train_asr, train_separator, train_speaker
    from audio_classification_tpu_torch.cli.offline_overlap_3src import main as overlap3_main
    from audio_classification_tpu_torch.models import facades
    from audio_classification_tpu_torch.models.asr.ctc import ctc_loss
    from audio_classification_tpu_torch.models.asr.sensevoice import (SenseVoiceConfig,
                                                                     SenseVoiceEncoder,
                                                                     sensevoice_frontend)
    from audio_classification_tpu_torch.models.mossformer import MossFormerConfig
    from audio_classification_tpu_torch.models.convtasnet import ConvTasNetConfig
    from audio_classification_tpu_torch.models.speaker import SpeakerEmbedderConfig
    from audio_classification_tpu_torch.ops.fbank import FbankConfig, log_mel_fbank
    from audio_classification_tpu_torch.parallel.mesh import make_mesh
    from audio_classification_tpu_torch.train.trainer import SeparatorTrainer, flax_init_

    work = ROOT / "build" / "chip_smoke" / "train"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    total = {k: 0 for k in counters}

    def run(name, cli, argv, ckpt, expect, exact=None, unexpected=()):
        _, launches = _counted(torch, counters, expect, name, lambda: cli.main(argv),
                               unexpected, exact)
        for k, n in launches.items():
            total[k] += n
        meta = json.loads((ckpt / "run.json").read_text())
        losses = meta["losses"]
        log({"phase": "train", "path": name, "losses": losses,
             **{k: v for k, v in meta.items() if k.endswith(("before", "after"))}})
        assert losses and all(math.isfinite(x) for x in losses), (name, losses)

    gen = torch.Generator().manual_seed(40)

    # train_separator --arch mossformer at EnginePreset's MossFormer: 3 steps
    # of 2 x 4 s at 8 kHz (T = 3999 frames: K4 in each of the 8 GAU layers,
    # 8 launches a step) and the two held-out SI-SDRi evaluations (one
    # forward of 16 crops each), then --resume for 2 more
    mf = MossFormerConfig()
    mf_args = ["--synthetic", "--arch", "mossformer", "--n-src", "2", "--sample-rate", "8000",
               "--seconds", "4", "--batch", "2", "--enc-dim", str(mf.enc_dim), "--mf-dim",
               str(mf.dim), "--mf-qk-dim", str(mf.qk_dim), "--mf-expansion", str(mf.expansion),
               "--mf-layers", str(mf.layers), "--log-every", "1", "--provider", "cuda",
               "--ckpt-dir", str(work / "mf_ck")]
    no_k2 = ("tcn_masker", "tcn_masker_s8", "tcn_masker_bf16", "tcn_masker_s8_bf16")
    run("train_separator mossformer", train_separator,
        [*mf_args, "--steps", "3", "--export", str(work / "mf_export")], work / "mf_ck",
        ("gau_attention",), {"gau_attention": mf.layers * (3 + 2)},
        ("gau_attention_bf16",) + no_k2)
    run("train_separator mossformer --resume", train_separator,
        [*mf_args, "--steps", "5", "--resume"], work / "mf_ck",
        ("gau_attention",), {"gau_attention": mf.layers * (2 + 2)})
    # the same model and loss, one step on a 0.52 s crop (519 frames: K4 on
    # the card, its twin on the CPU), card against CPU
    mix = 0.3 * torch.randn((2, 4160), generator=gen)
    refs = 0.3 * torch.randn((2, 2, 4160), generator=gen)
    mask = torch.ones((2, 4160))
    mask[1, 3000:] = 0.0
    _step_vs_cpu(torch, "train_separator mossformer",
                 lambda: SeparatorTrainer(mf, seed=0, device="cpu").model,
                 lambda m, b: _pit(m, b), {"mix": mix, "refs": refs, "mask": mask})

    # train_separator --arch convtasnet at the flagship's widths (N 512, B
    # 128, H 512, 8 x 3): the dense TCN loop, as the JAX trainer trains it,
    # so K2 is not launched
    tas = ConvTasNetConfig(n_src=2, enc_kernel=16, sample_rate=16000)
    run("train_separator convtasnet", train_separator,
        ["--synthetic", "--arch", "convtasnet", "--n-src", "2", "--sample-rate", "16000",
         "--seconds", "2", "--batch", "2", "--enc-dim", str(tas.enc_dim), "--bottleneck",
         str(tas.bottleneck), "--hidden", str(tas.hidden), "--n-blocks", str(tas.n_blocks),
         "--n-repeats", str(tas.n_repeats), "--steps", "3", "--log-every", "1",
         "--provider", "cuda", "--ckpt-dir", str(work / "tas_ck")], work / "tas_ck",
        (), {k: 0 for k in no_k2})
    mix = 0.3 * torch.randn((2, 8000), generator=gen)
    refs = 0.3 * torch.randn((2, 2, 8000), generator=gen)
    _step_vs_cpu(torch, "train_separator convtasnet",
                 lambda: SeparatorTrainer(tas, seed=0, device="cpu").model,
                 lambda m, b: _pit(m, b), {"mix": mix, "refs": refs, "mask": torch.ones((2, 8000))},
                 dtype=torch.float64)

    # train_asr, SenseVoice 512 / 8 / 12, on a manifest of 32 s wavs (3198
    # fbank frames: 533 LFR frames + 4 prompts, so K3 runs in each of the 12
    # blocks): 3 steps and the two CER evaluations, then --resume for 2
    words = ["abcab", "bacca", "cabba", "abcca", "bbaca"]

    def manifest(name, seconds, n):
        lines = []
        for i in range(n):
            wav = sum(talkers(int(seconds * SR), 50 + i)) / 3.0
            write_wav(work / f"{name}{i}.wav", (0.5 * wav / np.abs(wav).max()).astype(np.float32),
                      SR)
            lines.append(json.dumps({"wav": str(work / f"{name}{i}.wav"), "text": words[i]}))
        (work / f"{name}.jsonl").write_text("\n".join(lines) + "\n")
        return work / f"{name}.jsonl"

    sv = SenseVoiceConfig(vocab_size=4)  # the char vocab of the texts: blank, a, b, c
    asr_args = ["--max-seconds", "32", "--batch", "2", "--dim", str(sv.dim), "--heads",
                str(sv.heads), "--layers", str(sv.layers), "--conv-kernel", str(sv.conv_kernel),
                "--log-every", "1", "--provider", "cuda", "--ckpt-dir", str(work / "asr_ck"),
                "--manifest", str(manifest("utt", 32, 5))]
    run("train_asr", train_asr, [*asr_args, "--steps", "3"], work / "asr_ck",
        ("fbank_power_mel", "flash_attention"), {"flash_attention": sv.layers * (3 + 2)},
        ("flash_attention_stats",))
    run("train_asr --resume", train_asr, [*asr_args, "--steps", "5", "--resume"], work / "asr_ck",
        ("fbank_power_mel", "flash_attention"), {"flash_attention": sv.layers * (2 + 2)})
    # --seq-parallel over 4 shards of the card on 124 s wavs: 12398 fbank
    # frames, 2067 LFR frames + 4 prompts, padded to 4 x 518, so every block
    # of the ring runs K5 (12 layers x 16 block pairs = 192 launches a
    # forward); the CER evaluations run the encoder without the mesh (K3)
    run("train_asr --seq-parallel --data-parallel 4", train_asr,
        ["--max-seconds", "124", "--batch", "2", "--dim", str(sv.dim), "--heads", str(sv.heads),
         "--layers", str(sv.layers), "--conv-kernel", str(sv.conv_kernel), "--log-every", "1",
         "--provider", "cuda", "--ckpt-dir", str(work / "sp_ck"), "--steps", "2",
         "--seq-parallel", "--data-parallel", "4", "--manifest", str(manifest("long", 124, 3))],
        work / "sp_ck", ("fbank_power_mel", "flash_attention_stats", "flash_attention"),
        {"flash_attention_stats": sv.layers * 16 * 2, "flash_attention": sv.layers * 2})
    fb = FbankConfig()
    wavs = []
    for i, seconds in enumerate((32, 124)):
        w = sum(talkers(seconds * SR, 60 + i)) / 3.0
        wavs.append(torch.from_numpy(np.stack([w, w[::-1].copy()]).astype(np.float32) * 0.2))
    for label, wav, mesh in (("train_asr", wavs[0], None),
                             ("train_asr --seq-parallel", wavs[1], 4)):
        lens = torch.tensor([wav.shape[1], wav.shape[1] * 3 // 4])

        def ctc(m, b, mesh=mesh):
            feats, fmask = sensevoice_frontend(b["wav"], b["lens"], m.cfg)
            sp = None if mesh is None else make_mesh(mesh, devices=[b["wav"].device] * mesh)
            logits = m(feats, fmask, mesh=sp)[:, m.cfg.num_prompt:]
            return ctc_loss(logits, fmask, b["labels"], b["lab_lens"])

        _step_vs_cpu(torch, label, lambda: flax_init_(SenseVoiceEncoder(sv), 0), ctc,
                     {"wav": wav, "lens": lens, "labels": torch.tensor([[1, 2, 3, 1, 2]] * 2),
                      "lab_lens": torch.tensor([5, 3])})

    # train_speaker at the serving embedder's widths (32, 64, 128, 256 / 192):
    # fbank features by K1
    spk = SpeakerEmbedderConfig()
    run("train_speaker", train_speaker,
        ["--synthetic", "--channels", ",".join(map(str, spk.channels)), "--embed-dim",
         str(spk.embed_dim), "--batch", "8", "--max-seconds", "2", "--num-speakers", "8",
         "--steps", "3", "--log-every", "1", "--provider", "cuda",
         "--ckpt-dir", str(work / "spk_ck"), "--export", str(work / "spk_export")],
        work / "spk_ck", ("fbank_power_mel",))
    feats = log_mel_fbank(torch.from_numpy(np.stack(talkers(2 * SR, 70)[:2]) * 0.3), fb)
    _step_vs_cpu(torch, "train_speaker",
                 lambda: flax_init_(train_speaker.embedder_with_head(spk, 8), 0), _aam,
                 {"feats": feats, "labels": torch.tensor([3, 5])})

    # the exports serve: the MossFormer export through --sep-checkpoint (the
    # preset's mossformer stage) and the embedder through --spk-embed-model
    # in the flagship CLI, and through Separator(checkpoint=)
    two = talkers(6 * SR, 5)[:2]
    peak = np.abs(two[0] + two[1]).max()
    write_wav(work / "mix2.wav", 0.6 * (two[0] + two[1]) / peak, SR)
    write_wav(work / "target.wav", 0.6 * two[0][: 3 * SR] / peak, SR)
    (out_dir, result), launches = _counted(
        torch, counters, ("fbank_power_mel", "gau_attention"), "overlap3 trained exports",
        lambda: overlap3_main(["--input-wavs", str(work / "mix2.wav"), "--target-wav",
                               str(work / "target.wav"), "--osd-thr", "0.0", "--sep-backend",
                               "mossformer", "--sep-checkpoint", str(work / "mf_export"),
                               "--spk-embed-model", str(work / "spk_export"), "--preset", "full",
                               "--seed", "0", "--sv-threshold", "-1", "--out-dir",
                               str(work / "out")]))
    for k, n in launches.items():
        total[k] += n
    recs = [json.loads(x) for x in (out_dir / "segments.jsonl").read_text().splitlines()]
    assert recs and all(r["kind"] == "overlap" and math.isfinite(r["sv_score"]) for r in recs)
    sep = facades.Separator(backend="mossformer", checkpoint=str(work / "mf_export"))
    streams = sep.separate(two[0] + two[1], SR)
    assert len(streams) == 2 and all(np.isfinite(s).all() for s in streams)
    log({"phase": "train_exports", "segments": len(recs), "separator_streams": len(streams)})
    return total


def _quiet(fn):
    """Run fn with its standard output kept -> (result, the text)."""
    import contextlib
    import io

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = fn()
    return out, buf.getvalue()


def run_quality_paths(torch, np, counters: dict) -> dict:
    """Slice 14b on the card, each entry point with its launch counts:
    the quality-gate CLI at --steps-scale 0.05 (all four stages trained,
    the flagship run on 2 held-out scenes with real SV gating: K1 in every
    stage's batches and the pipeline, K2 in the SV calibration's and the
    scenes' overlap path at the world's widths); distill_osd at the full
    preset on synthetic scenes and with a pyannote teacher written at the
    published widths, its output loaded by --osd-checkpoint into
    build_engine and the flagship CLI; then the native host codecs, on the
    host only -> total launches per kernel."""
    import re

    from audio_classification_tpu_torch.audio_io import read_wav, write_wav
    from audio_classification_tpu_torch.cli import distill_osd, quality_gate
    from audio_classification_tpu_torch.cli.offline_overlap_3src import main as overlap3_main
    from audio_classification_tpu_torch.pipelines.offline_overlap3 import build_engine
    from audio_classification_tpu_torch.train.checkpoint import load_params
    from audio_classification_tpu_torch.utils.config import Overlap3Config

    work = ROOT / "build" / "chip_smoke" / "gate"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    total = {k: 0 for k in counters}

    def add(launches):
        for k, n in launches.items():
            total[k] += n

    lowp = ("tcn_masker_s8", "tcn_masker_bf16", "tcn_masker_s8_bf16", "gau_attention",
            "gau_attention_bf16", "flash_attention_bf16", "flash_attention_stats_bf16")
    # ---- the quality gate: the CLI a user runs, at 5 % of the step budget
    out = work / "QUALITY_smoke.json"
    (artifact, text), launches = _counted(
        torch, counters, ("fbank_power_mel", "tcn_masker"), "quality_gate --steps-scale 0.05",
        lambda: _quiet(lambda: quality_gate.main(
            ["--out", str(out), "--steps-scale", "0.05", "--scenes", "2", "--no-gate-exit",
             "--ckpt-dir", str(work / "world_pack")])), lowp)
    add(launches)
    walls = {k: float(v) for k, v in re.findall(r"^  (\w+) wall ([\d.]+) s$", text, re.M)}
    on_disk = json.loads(out.read_text())
    want_keys = list(json.loads((ROOT / "QUALITY_r05.json").read_text()))
    losses = {k: on_disk[k] for k in ("sep_final_loss", "osd_final_loss", "spk_final_loss",
                                      "asr_final_loss")}
    log({"phase": "quality_gate", "stage_wall_sec": walls, "losses": losses,
         **{k: on_disk[k] for k in ("backend", "device", "quality_ok",
                                    "target_hit_rate_segments", "cer_mean", "cer_clean_mean",
                                    "cer_oracle_sep_mean", "sep_sisdri_mean",
                                    "sv_threshold_calibrated", "segments_total",
                                    "train_wall_sec", "pipeline_wall_sec",
                                    "pipeline_wall_cold_sec")},
         "launches": launches})
    assert list(on_disk) == want_keys, (list(on_disk), want_keys)
    assert on_disk["backend"] == "cuda" and on_disk["device"] == torch.cuda.get_device_name(0)
    assert sorted(walls) == ["asr", "osd", "sep", "spk"], walls
    assert all(math.isfinite(v) for v in losses.values()), losses
    assert artifact["quality_ok"] == on_disk["quality_ok"]

    # ---- distill_osd: the full preset's OSDNet on 4 s crops, energy labels,
    # then the pyannote teacher (PyanNet at the published widths) on the card
    write_pyannote_checkpoint(torch, np, work / "segmentation.ckpt", seed=31)
    base = ["--synthetic", "--preset", "full", "--steps", "20", "--batch", "8", "--dur", "4",
            "--f1-target", "0.0", "--seed", "0"]
    for name, extra in (("distill_osd", []),
                        ("distill_osd --teacher-ckpt",
                         ["--teacher-ckpt", str(work / "segmentation.ckpt")])):
        dst = work / ("osd_teacher" if extra else "osd_energy")
        (m, text), launches = _counted(
            torch, counters, ("fbank_power_mel",), name,
            lambda: _quiet(lambda: distill_osd.main([*base, *extra, "--out", str(dst)])),
            lowp + ("tcn_masker",))
        add(launches)
        bce = [float(x) for x in re.findall(r"frame BCE ([\d.]+)", text)]
        run = json.loads((dst / "run.json").read_text())
        log({"phase": "distill_osd", "path": name, "bce": bce, "f1": m["f1"],
             "precision": m["precision"], "recall": m["recall"], "device": run["device"],
             "launches": launches})
        assert bce and all(math.isfinite(x) for x in bce), bce
        assert run["cuda_device_name"] == torch.cuda.get_device_name(0)

    # its output through --osd-checkpoint: into build_engine on the card, then
    # one offline_overlap_3src scene
    engine = build_engine(Overlap3Config(seed=0, osd_checkpoint=str(work / "osd_teacher")))
    saved = load_params(work / "osd_teacher")
    for k, v in engine.pack.models["osd"].state_dict().items():
        assert torch.equal(v.cpu(), saved[k]), k
    src = talkers(6 * SR, 7)
    mix = sum(src) / 3.0
    write_wav(work / "mix.wav", 0.6 * mix / np.abs(mix).max(), SR)
    write_wav(work / "target.wav", 0.6 * src[0][: 3 * SR] / np.abs(src[0]).max(), SR)
    (out_dir, result), launches = _counted(
        torch, counters, ("fbank_power_mel",), "overlap3 --osd-checkpoint distill_osd",
        lambda: overlap3_main(["--input-wavs", str(work / "mix.wav"), "--target-wav",
                               str(work / "target.wav"), "--preset", "full", "--seed", "0",
                               "--sv-threshold", "-1", "--osd-checkpoint",
                               str(work / "osd_teacher"), "--out-dir", str(work / "out")]),
        lowp)
    add(launches)
    log({"phase": "pipeline", "path": "overlap3 --osd-checkpoint distill_osd",
         "segments_total": result.metrics["segments_total"],
         "segments_overlap_streams": result.metrics["segments_overlap_streams"],
         "segments_clean": result.metrics["segments_clean"]})
    assert result.metrics["segments_total"] > 0 and (out_dir / "summary.json").is_file()

    # ---- the native host codecs (host only): both paths, equal bytes
    from audio_classification_tpu_torch.audio_io.stream_buffer import NumpyRingBuffer, RingBuffer
    from audio_classification_tpu_torch.audio_io.wav import read_wav_numpy, write_wav_numpy

    x = np.stack(talkers(10 * SR, 8)[:2]) * 0.4
    t0 = time.perf_counter()
    write_wav(work / "native.wav", x, SR)
    back, sr = read_wav(work / "native.wav")
    native_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    write_wav_numpy(work / "numpy.wav", x, SR)
    back_np, _ = read_wav_numpy(work / "numpy.wav")
    numpy_ms = (time.perf_counter() - t0) * 1e3
    same_bytes = (work / "native.wav").read_bytes() == (work / "numpy.wav").read_bytes()
    rings = [RingBuffer(4000), NumpyRingBuffer(4000)]
    outs = [[r.push(x[0][i: i + 3000]) for i in range(0, 12000, 3000)]
            + [float(r.pop(2500).sum()), r.size, r.dropped] for r in rings]
    log({"phase": "native_codecs", "shape": list(x.shape), "bytes_equal": same_bytes,
         "samples_equal": bool(np.array_equal(back, back_np)), "ring": outs[0],
         "native_write_read_ms": native_ms, "numpy_write_read_ms": numpy_ms})
    assert same_bytes and sr == SR and np.array_equal(back, back_np), "native codec"
    assert outs[0] == outs[1], outs
    return total


def _sv_einsum_block(ox, g, x, blk, dim, heads, conv_kernel):
    """onnx_export's transformer block with the attention products as Einsum
    nodes: the graph-aware importer takes every MatMul / Gemm for a dense
    layer, so a graph with MatMul attention does not map."""
    np = ox.np
    dh = dim // heads
    h = ox._layernorm(g, x, blk["LayerNorm_0"])
    q, k, v = g.add("Split", [ox._dense(g, h, blk["MultiHeadSelfAttention_0"]["qkv"])],
                    n_out=3, axis=-1)

    def split_heads(z):
        z = g.add("Reshape", [z, g.init("shape", np.asarray([0, 0, heads, dh], np.int64))])
        return g.add("Transpose", [z], perm=[0, 2, 1, 3])

    q, k, v = split_heads(q), split_heads(k), split_heads(v)
    sc = g.add("Einsum", [q, k], equation="bhqd,bhkd->bhqk")
    sc = g.add("Mul", [sc, g.init("scale", np.float32(1.0 / np.sqrt(dh)).reshape(()))])
    o = g.add("Einsum", [g.add("Softmax", [sc], axis=-1), v], equation="bhqk,bhkd->bhqd")
    o = g.add("Transpose", [o], perm=[0, 2, 1, 3])
    o = g.add("Reshape", [o, g.init("shape", np.asarray([0, 0, dim], np.int64))])
    x = g.add("Add", [x, ox._dense(g, o, blk["MultiHeadSelfAttention_0"]["out"])])
    hc = g.add("Transpose", [ox._layernorm(g, x, blk["LayerNorm_1"])], perm=[0, 2, 1])
    hc = ox._conv(g, hc, blk["dwconv"], groups=dim, pads=ox._same_pads(1, conv_kernel))
    x = g.add("Add", [x, ox._silu(g, g.add("Transpose", [hc], perm=[0, 2, 1]))])
    h = ox._gelu_tanh(g, ox._dense(g, ox._layernorm(g, x, blk["LayerNorm_2"]), blk["Dense_0"]))
    return g.add("Add", [x, ox._dense(g, h, blk["Dense_1"])])


def write_sensevoice_graph(tree, cfg, path, frames: int) -> None:
    """SenseVoice as the reference's sherpa export takes its inputs (feats,
    language [1] and textnorm [1] at run time), with Einsum attention and
    the positional table sliced to the input's frame count (at most
    ``frames``): a graph the graph-aware importer maps and the executor
    runs at any bucket. onnx_export.export_sensevoice bakes the text-norm
    row and writes MatMul attention, so its graph does not map back."""
    from audio_classification_tpu_torch.convert import onnx_export as ox
    from audio_classification_tpu_torch.models.common import sinusoidal_positions

    np = ox.np
    p, pr = tree["params"], cfg.num_prompt
    i64 = lambda v: np.asarray(v, np.int64)
    g = ox.OnnxGraphWriter("sensevoice")
    x = ox._dense(g, "feats", p["in_proj"])
    lang = g.add("Gather", [g.init("lang_embed", p["lang_embed"]), "language"], axis=0)
    itn = g.add("Gather", [g.init("itn_embed", p["itn_embed"]), "textnorm"], axis=0)
    prompt = g.add("Concat", [lang, itn, g.init("prompt_pad", p["prompt_pad"])], axis=0)
    prompt = g.add("Unsqueeze", [prompt, g.init("axes", i64([0]))])
    shp = g.add("Shape", ["feats"])
    batch = g.add("Slice", [shp, g.init("s", i64([0])), g.init("e", i64([1]))])
    target = g.add("Concat", [batch, g.init("pd", i64([pr, cfg.dim]))], axis=0)
    x = g.add("Concat", [g.add("Expand", [prompt, target]), x], axis=1)
    t = g.add("Add", [g.add("Slice", [shp, g.init("s", i64([1])), g.init("e", i64([2]))]),
                      g.init("pr", i64([pr]))])
    pos = g.add("Slice", [g.init("pos", sinusoidal_positions(frames + pr, cfg.dim)),
                          g.init("s", i64([0])), t, g.init("a", i64([0]))])
    x = g.add("Add", [x, pos])
    for i in range(cfg.layers):
        x = _sv_einsum_block(ox, g, x, p[f"block_{i}"], cfg.dim, cfg.heads, cfg.conv_kernel)
    g.add("Identity", [ox._dense(g, ox._layernorm(g, x, p["final_ln"]), p["ctc_head"])],
          out="logits")
    Path(path).write_bytes(g.serialize(
        inputs=[("feats", np.float32, ["batch", "frames", cfg.lfr_m * cfg.num_mel]),
                ("language", np.int64, [1]), ("textnorm", np.int64, [1])],
        outputs=[("logits", np.float32, ["batch", "prompt_frames", cfg.vocab_size])]))


def write_family_graphs(np, work: Path, preset) -> dict:
    """The direct stages' fixture graphs of the Paraformer, transducer and
    whisper families at the preset's widths (feature dims, model dims,
    vocab), written with the port's OnnxGraphWriter: the shapes of the
    reference's sherpa / funasr exports, the weights seeded. No exporter of
    the package writes these families (nor does the JAX one's)."""
    from audio_classification_tpu_torch.convert.onnx_export import OnnxGraphWriter

    rng = np.random.default_rng(71)
    r = lambda *s: (rng.standard_normal(s) / np.sqrt(s[0])).astype(np.float32)
    i64 = lambda v: np.asarray(v, np.int64)
    out = {}
    # Paraformer: speech [B, T, 560] + lengths -> (logits [B, N, V], token_num)
    pc, n_tok = preset.paraformer, 32
    g = OnnxGraphWriter("paraformer")
    head = g.add("Slice", ["speech", g.init("s", i64([0])), g.init("e", i64([n_tok])),
                           g.init("a", i64([1]))])
    h = g.add("Tanh", [g.add("MatMul", [head, g.init("w1", r(pc.lfr_m * pc.num_mel, pc.dim))])])
    g.add("MatMul", [h, g.init("w2", r(pc.dim, pc.vocab_size))], out="logits")
    cap = g.add("Div", ["speech_lengths", g.init("six", np.asarray([6], np.int32))])
    g.add("Min", [cap, g.init("cap", np.asarray([n_tok], np.int32))], out="token_num")
    out["paraformer"] = work / "paraformer.onnx"
    out["paraformer"].write_bytes(g.serialize(
        inputs=[("speech", np.float32, ["B", "T", pc.lfr_m * pc.num_mel]),
                ("speech_lengths", np.int32, ["B"])],
        outputs=[("logits", np.float32, ["B", n_tok, pc.vocab_size]),
                 ("token_num", np.int32, ["B"])]))
    # transducer triple: encoder (stride-4 subsampling conv), stateless
    # decoder over a context of 2, joiner
    tc = preset.transducer
    g = OnnxGraphWriter("encoder")
    xt = g.add("Transpose", ["x"], perm=[0, 2, 1])
    y = g.add("Conv", [xt, g.init("w", r(tc.num_mel * 5, tc.dim).T.reshape(tc.dim, tc.num_mel, 5)
                                         .copy())], strides=[4], pads=[2, 2])
    g.add("Transpose", [g.add("Relu", [y])], out="encoder_out", perm=[0, 2, 1])
    ln = g.add("Add", [g.add("Div", [g.add("Sub", ["x_lens", g.init("one", np.asarray([1], np.int32))]),
                                    g.init("four", np.asarray([4], np.int32))]),
                       g.init("one", np.asarray([1], np.int32))], out="encoder_out_lens")
    out["encoder"] = work / "encoder.onnx"
    out["encoder"].write_bytes(g.serialize(
        inputs=[("x", np.float32, ["B", "T", tc.num_mel]), ("x_lens", np.int32, ["B"])],
        outputs=[("encoder_out", np.float32, ["B", "T", tc.dim]),
                 ("encoder_out_lens", np.int32, ["B"])]))
    g = OnnxGraphWriter("decoder")
    e = g.add("Gather", [g.init("emb", r(tc.vocab_size, tc.pred_dim)), "y"])
    e = g.add("Reshape", [e, g.init("shape", i64([0, 2 * tc.pred_dim]))])
    g.add("Relu", [g.add("MatMul", [e, g.init("w", r(2 * tc.pred_dim, tc.dim))])],
          out="decoder_out")
    out["decoder"] = work / "decoder.onnx"
    out["decoder"].write_bytes(g.serialize(
        inputs=[("y", np.int64, ["B", 2])], outputs=[("decoder_out", np.float32, ["B", tc.dim])]))
    g = OnnxGraphWriter("joiner")
    hj = g.add("Tanh", [g.add("Add", ["encoder_out", "decoder_out"])])
    g.add("MatMul", [hj, g.init("w", r(tc.dim, tc.vocab_size))], out="logit")
    out["joiner"] = work / "joiner.onnx"
    out["joiner"].write_bytes(g.serialize(
        inputs=[("encoder_out", np.float32, ["B", tc.dim]),
                ("decoder_out", np.float32, ["B", tc.dim])],
        outputs=[("logit", np.float32, ["B", tc.vocab_size])]))
    # whisper pair: channels-first mel encoder -> cross [B, 1, D]; decoder
    # with token / offset inputs and a fixed-size self-attention cache
    wc = preset.whisper
    g = OnnxGraphWriter("whisper_encoder")
    pr = g.add("MatMul", [g.add("Transpose", ["mel"], perm=[0, 2, 1]),
                          g.init("w", r(wc.num_mel, wc.dim))])
    g.add("ReduceMean", [g.add("Tanh", [pr])], out="cross_k", axes=[1], keepdims=1)
    out["whisper_encoder"] = work / "whisper_encoder.onnx"
    out["whisper_encoder"].write_bytes(g.serialize(
        inputs=[("mel", np.float32, ["B", wc.num_mel, "T"])],
        outputs=[("cross_k", np.float32, ["B", 1, wc.dim])]))
    g = OnnxGraphWriter("whisper_decoder")
    te = g.add("Gather", [g.init("emb", r(wc.vocab_size, wc.dim)), "tokens"])
    hd = g.add("Tanh", [g.add("Add", [te, "cross_k"])])
    g.add("MatMul", [hd, g.init("w", r(wc.dim, wc.vocab_size) * 4)], out="logits")
    g.add("Add", ["in_n_layer_self_k_cache", g.init("one", np.float32(1.0).reshape(()))],
          out="out_n_layer_self_k_cache")
    out["whisper_decoder"] = work / "whisper_decoder.onnx"
    out["whisper_decoder"].write_bytes(g.serialize(
        inputs=[("tokens", np.int64, ["B", "n"]), ("offset", np.int64, ["B"]),
                ("in_n_layer_self_k_cache", np.float32, [4, "B", "L", wc.dim]),
                ("cross_k", np.float32, ["B", 1, wc.dim])],
        outputs=[("logits", np.float32, ["B", "n", wc.vocab_size]),
                 ("out_n_layer_self_k_cache", np.float32, [4, "B", "L", wc.dim])]))
    return out


def run_onnx_paths(torch, np, counters: dict) -> dict:
    """Slice 15, ONNX, at the full preset (seeded weights), files in a
    temporary directory: the port's exporters write every stage; the
    flagship CLI serves a SenseVoice graph and the speaker export mapped onto
    the port's modules (--onnx-exec map: records equal to the CLI on the same
    weights from a checkpoint directory) and run by the graph executor
    (direct: K3 unlaunched in the ASR stage, texts equal to map mode, the
    logits' error against K3's 3xTF32 stated); the int8 SenseVoice export
    through the executor on the card against the CPU (the first
    MatMulInteger's int32 accumulators equal); the VAD export through
    speaker_id_vad_asr; each other family's direct stage once; then
    convert_models --verify, export_models and distill_asr. Each path's
    launches, walls and device ops are logged."""
    import tempfile

    from audio_classification_tpu_torch.audio_io import write_wav
    from audio_classification_tpu_torch.cli import (convert_models, distill_asr, export_models,
                                                    speaker_id_vad_asr)
    from audio_classification_tpu_torch.cli.offline_overlap_3src import main as overlap3_main
    from audio_classification_tpu_torch.convert import onnx_export as ox
    from audio_classification_tpu_torch.convert.from_jax import state_dict_to_variables
    from audio_classification_tpu_torch.convert.onnx_exec import OnnxModel
    from audio_classification_tpu_torch.convert.onnx_import import ValueInfo
    from audio_classification_tpu_torch.engine.runtime import EnginePreset, ModelPack
    from audio_classification_tpu_torch.models.asr.sensevoice import sensevoice_frontend
    from audio_classification_tpu_torch.pipelines.offline_overlap3 import build_engine
    from audio_classification_tpu_torch.train.checkpoint import save_model_pack
    from audio_classification_tpu_torch.utils.config import Overlap3Config

    total = {k: 0 for k in counters}

    def add(launches):
        for k, n in launches.items():
            total[k] += n

    tmp = tempfile.TemporaryDirectory(prefix="chip_smoke_onnx_")
    work = Path(tmp.name)
    preset = EnginePreset()
    pack = ModelPack(preset, seed=0)
    cfg = pack.asr_cfg
    var = {k: state_dict_to_variables(m) for k, m in pack.models.items()}
    # the 32 s bucket's LFR frames, from the port's frontend
    with torch.inference_mode():
        feats32, _ = sensevoice_frontend(torch.zeros(1, 32 * SR, device="cuda"),
                                         torch.tensor([32 * SR], device="cuda"), cfg)
    frames = int(feats32.shape[1])
    assert frames == cfg.out_frames(32 * SR) - cfg.num_prompt, frames

    # ---- exports of every stage, sizes and walls
    fb_frames = preset.spk.sample_rate // 100 * 4 - 2  # fbank frames of 4 s: 398
    exports = {}
    for name, fn, tree, c, kw in (
            ("sensevoice", ox.export_sensevoice, var["asr"], cfg, dict(frames=frames)),
            ("sensevoice_int8", ox.export_sensevoice, var["asr"], cfg,
             dict(frames=frames, quant="int8")),
            ("speaker", ox.export_speaker, var["spk"], preset.spk, dict(frames=fb_frames)),
            ("osdnet", ox.export_osdnet, var["osd"], preset.osd, dict(frames=fb_frames)),
            ("vadnet", ox.export_vadnet, var["vad"], preset.vad, dict(frames=fb_frames)),
            ("convtasnet3", ox.export_convtasnet, var["sep3"], preset.sep3, dict(seconds=4.0)),
            ("mossformer", ox.export_mossformer, var["mossformer"], preset.mossformer,
             dict(seconds=4.0))):
        t0 = time.perf_counter()
        fn(tree, c, str(work / f"{name}.onnx"), **kw)
        exports[name] = {"wall_sec": time.perf_counter() - t0,
                         "bytes": (work / f"{name}.onnx").stat().st_size}
    t0 = time.perf_counter()
    write_sensevoice_graph(var["asr"], cfg, work / "sv.onnx", frames)
    exports["sensevoice_runtime_textnorm"] = {"wall_sec": time.perf_counter() - t0,
                                              "bytes": (work / "sv.onnx").stat().st_size}
    log({"phase": "onnx_exports", "frames": frames, **exports})

    # ---- map mode: the flagship CLI on the .onnx files against the same CLI
    # on the same weights from the port's checkpoint directory. The graphs
    # have no length input (as the reference's exports): the executor sees a
    # padded batch whole, so the audio fills its buckets (a 32 s mixture, an
    # 8 s target) for direct mode to compute what the modules compute
    src = talkers(32 * SR, 3)
    mix = sum(src) / 3.0
    write_wav(work / "mix.wav", 0.6 * mix / np.abs(mix).max(), SR)
    target = talkers(8 * SR, 4)[0]
    write_wav(work / "target.wav", 0.6 * target / np.abs(target).max(), SR)
    save_model_pack(pack, work / "pack")
    base = ["--input-wavs", str(work / "mix.wav"), "--target-wav", str(work / "target.wav"),
            "--preset", "full", "--seed", "0", "--sv-threshold", "-1"]
    onnx_files = ["--sense-voice", str(work / "sv.onnx"), "--spk-embed-model",
                  str(work / "speaker.onnx")]
    kernels = ("fbank_power_mel", "tcn_masker", "flash_attention")

    def records(argv, name, expect):
        (out_dir, result), launches = _counted(torch, counters, expect, name, lambda: overlap3_main(
            [*base, *argv, "--out-dir", str(work / "out")]))
        add(launches)
        recs = [json.loads(x) for x in (out_dir / "segments.jsonl").read_text().splitlines()]
        return recs, launches

    for thr, kind, expect in (("0.0", "overlap", kernels),
                              ("1.0", "clean", ("fbank_power_mel", "flash_attention"))):
        ref, l_ref = records(["--checkpoint-dir", str(work / "pack"), "--osd-thr", thr],
                             f"onnx checkpoint-dir {kind}", expect)
        got, l_map = records([*onnx_files, "--onnx-exec", "map", "--osd-thr", thr],
                             f"onnx map {kind}", expect)
        assert got and all(r["kind"] == kind for r in got), got
        keys = ("kind", "start", "end", "stream", "text", "sv_score", "target_src_text")
        assert [[r[k] for k in keys] for r in got] == [[r[k] for k in keys] for r in ref]
        assert {k: l_map[k] for k in kernels} == {k: l_ref[k] for k in kernels}
        log({"phase": "onnx_map", "scene": kind, "records": len(got),
             "launches": {k: l_map[k] for k in kernels}})
        direct, l_dir = records([*onnx_files, "--onnx-exec", "direct", "--osd-thr", thr],
                                f"onnx direct {kind}", ("fbank_power_mel",))
        assert [r["text"] for r in direct] == [r["text"] for r in got], (direct, got)
        assert l_dir["fbank_power_mel"] == l_map["fbank_power_mel"]

    # ---- direct vs map on the engine: the ASR stage alone (32 s items
    # filling the 32 s bucket: K3 at [2, 8, 537, 64] in map mode, none
    # direct)
    engines = {}
    for mode, sv in (("map", "sv.onnx"), ("direct", "sv.onnx"), ("direct_export", "sensevoice.onnx")):
        engines[mode] = build_engine(Overlap3Config(
            preset="full", seed=0, sense_voice=str(work / sv), spk_embed_model=str(
                work / "speaker.onnx"), onnx_exec="map" if mode == "map" else "direct"))
    wav32 = (0.6 * mix / np.abs(mix).max()).astype(np.float32)
    other = talkers(32 * SR, 5)[0]
    other = (0.6 * other / np.abs(other).max()).astype(np.float32)
    texts, calls = {}, {}
    for mode, eng in engines.items():
        texts[mode], launches = _counted(torch, counters, ("fbank_power_mel",), f"onnx asr {mode}",
                                         lambda e=eng: e.transcribe([wav32, other]),
                                         exact={"flash_attention": 0} if mode != "map" else None)
        add(launches)
        if mode == "map":
            assert launches["flash_attention"] == cfg.layers, launches
        calls[mode] = device_ops(torch, lambda e=eng: e.transcribe([wav32]))
    assert texts["direct"] == texts["map"] == texts["direct_export"], texts
    m_eng, d_eng = engines["map"], engines["direct"]
    with torch.inference_mode():
        w = torch.from_numpy(wav32).cuda()[None]
        feats, mask = sensevoice_frontend(w, torch.tensor([w.shape[1]], device="cuda"), cfg)
        ref = m_eng.models["asr"](feats, mask)[:, cfg.num_prompt:]
        stage = d_eng.onnx_stages["asr"]
        got = stage(stage.params, feats, mask)
        got_exp = engines["direct_export"].onnx_stages["asr"]
        got_exp = got_exp(got_exp.params, feats, mask)
    valid = mask[0]
    err = (got - ref)[0, valid].abs().max().item() / ref[0, valid].abs().max().item()
    err_exp = (got_exp - ref)[0, valid].abs().max().item() / ref[0, valid].abs().max().item()
    log({"phase": "onnx_direct_vs_map", "shape": list(feats.shape), "logits_rel_err": err,
         "export_logits_rel_err": err_exp, "texts_equal": True,
         "device": gpu_name_and_power_limit(), "per_call": calls})
    assert err <= 1e-3 and err_exp <= 1e-3, (err, err_exp)
    # the speaker stage: the export mapped vs run whole
    emb = {}
    for mode in ("map", "direct"):
        eng = engines[mode]
        emb[mode] = eng.embed([wav32[: 4 * SR], wav32[4 * SR: 6 * SR]])
        calls[f"spk_{mode}"] = device_ops(torch, lambda e=eng: e.embed([wav32[: 4 * SR]]))
    spk_err = float(np.abs(emb["map"] - emb["direct"]).max())
    assert spk_err <= 1e-3, spk_err

    # ---- int8 through the executor: card against CPU on the same feats
    feats_np = feats.cpu().numpy()
    outs = {}
    for dev in ("cuda", "cpu"):
        m = OnnxModel(str(work / "sensevoice_int8.onnx"), device=dev)
        node = next(n for n in m.graph.nodes if n.op_type == "MatMulInteger")
        dql = next(n for n in m.graph.nodes if n.op_type == "DynamicQuantizeLinear")
        m.graph.outputs += [ValueInfo(name=node.outputs[0]), ValueInfo(name=dql.outputs[0])]
        t0 = time.perf_counter()
        o = m(feats=feats_np, language=np.zeros(1, np.int64))
        outs[dev] = {k: v.cpu() for k, v in o.items()}
        outs[dev]["wall_ms"] = (time.perf_counter() - t0) * 1e3
    acc_equal = torch.equal(outs["cuda"][node.outputs[0]], outs["cpu"][node.outputs[0]])
    q_equal = torch.equal(outs["cuda"][dql.outputs[0]], outs["cpu"][dql.outputs[0]])
    lc, lcpu = outs["cuda"]["logits"][0, cfg.num_prompt:], outs["cpu"]["logits"][0, cfg.num_prompt:]
    v = valid.cpu()
    int8_err = (lc - lcpu)[v].abs().max().item() / lcpu[v].abs().max().item()
    agree = float((lc.argmax(-1) == lcpu.argmax(-1))[v].float().mean())
    log({"phase": "onnx_int8_exec", "first_matmulinteger": list(outs["cpu"][node.outputs[0]].shape),
         "accumulators_equal": acc_equal, "quantized_inputs_equal": q_equal,
         "logits_rel_err": int8_err, "argmax_agreement": agree,
         "wall_ms": {d: outs[d]["wall_ms"] for d in outs}})
    assert acc_equal and q_equal, "int8 accumulators differ between the card and the CPU"
    assert math.isfinite(int8_err)

    # ---- the VAD export through speaker_id_vad_asr, and each family's
    # direct stage once
    sid = work / "sid"
    sid.mkdir()
    enroll, tests = [], []
    for i, f0 in enumerate((120.0, 230.0)):
        x = talkers(3 * SR, 80 + i, f0s=(f0,))[0]
        write_wav(sid / f"e{i}.wav", 0.5 * x / np.abs(x).max(), SR)
        enroll.append(f"spk{i} {sid / f'e{i}.wav'}")
        x = talkers(2 * SR, 90 + i, f0s=(f0 * 1.02,))[0]
        write_wav(sid / f"t{i}.wav", 0.5 * x / np.abs(x).max(), SR)
        tests.append(f"spk{i} {sid / f't{i}.wav'}")
    (sid / "speakers.txt").write_text("\n".join(enroll) + "\n")
    (sid / "test.txt").write_text("\n".join(tests) + "\n")
    run_dir, launches = _counted(
        torch, counters, ("fbank_power_mel",), "speaker_id_vad_asr --silero-vad-model vad.onnx",
        lambda: speaker_id_vad_asr.main([
            "--speaker-file", str(sid / "speakers.txt"), "--test-list", str(sid / "test.txt"),
            "--preset", "full", "--sense-voice", "seeded", "--apply-vad", "--silero-vad-model",
            str(work / "vadnet.onnx"), "--out-dir", str(sid / "out")]))
    add(launches)
    assert "Test utterances: 2" in (run_dir / "report.txt").read_text()
    fam = write_family_graphs(np, work, preset)
    for name, flags in (
            ("paraformer", ["--paraformer", str(fam["paraformer"])]),
            ("transducer", ["--encoder", str(fam["encoder"]), "--decoder", str(fam["decoder"]),
                            "--joiner", str(fam["joiner"])]),
            ("transducer beam", ["--encoder", str(fam["encoder"]), "--decoder",
                                 str(fam["decoder"]), "--joiner", str(fam["joiner"]),
                                 "--decoding-method", "modified_beam_search"]),
            ("whisper", ["--whisper-encoder", str(fam["whisper_encoder"]), "--whisper-decoder",
                         str(fam["whisper_decoder"])])):
        kw = {f.lstrip("-").replace("-", "_"): v for f, v in zip(flags[::2], flags[1::2])}
        eng = build_engine(Overlap3Config(preset="full", seed=0, onnx_exec="direct", **kw))
        assert "asr" in eng.onnx_stages, name
        out, launches = _counted(torch, counters, ("fbank_power_mel",), f"onnx {name} direct",
                                 lambda e=eng: e.transcribe([wav32[: 8 * SR]]),
                                 exact={"flash_attention": 0})
        add(launches)
        log({"phase": "onnx_family", "family": name, "text_len": len(out[0]),
             **device_ops(torch, lambda e=eng: e.transcribe([wav32[: 8 * SR]]))})

    # ---- tools: convert_models --verify over a reference-layout tree,
    # export_models for all stages, distill_asr with the exported teacher
    ref_dir = work / "models"
    (ref_dir / "speaker-recognition").mkdir(parents=True)
    shutil.copy(work / "speaker.onnx",
                ref_dir / "speaker-recognition" / "3dspeaker_speech_eres2net_sv_16k.onnx")
    (ref_dir / "vad").mkdir()
    shutil.copy(work / "vadnet.onnx", ref_dir / "vad" / "silero_vad.onnx")
    svd = ref_dir / "asr" / "sherpa-onnx-sense-voice-full"
    svd.mkdir(parents=True)
    shutil.copy(work / "sv.onnx", svd / "model.onnx")
    (svd / "tokens.txt").write_text("\n".join(["<blk> 0"] + [
        f"{chr(0x4e00 + i)} {i}" for i in range(1, cfg.vocab_size)]) + "\n", encoding="utf-8")
    t0 = time.perf_counter()
    verified = convert_models.main(["--verify", str(ref_dir), "--verify-out",
                                    str(work / "verify.json"), "--preset", "full"])
    log({"phase": "onnx_verify", "wall_sec": time.perf_counter() - t0,
         "checks": [{k: r[k] for k in ("model", "check", "status", "seconds")}
                    for r in verified["checks"]]})
    assert verified["ok"] and all(r["status"] == "pass" for r in verified["checks"]), verified
    t0 = time.perf_counter()
    written = export_models.main(["--out-dir", str(work / "exported"), "--preset", "full",
                                  "--seconds", "4", "--checkpoint-dir", str(work / "pack")])
    assert len(written) == 7
    log({"phase": "onnx_export_models", "wall_sec": time.perf_counter() - t0,
         "files": {Path(p).name: Path(p).stat().st_size for p in written}})
    tokens = work / "tokens.txt"
    tokens.write_text("\n".join(["<blk> 0"] + [f"{c} {i}" for i, c in enumerate("abcdefgh", 1)]
                                + [f"<unused{i}> {i}" for i in range(9, cfg.vocab_size)]) + "\n")
    losses = []

    def distill():
        with torch.enable_grad():
            return distill_asr.main([
                "--teacher-onnx", str(work / "sensevoice.onnx"), "--tokens", str(tokens),
                "--synthetic", "--max-seconds", "32", "--steps", "4", "--batch", "2",
                "--lr", "1e-3", "--dim", str(cfg.dim), "--heads", str(cfg.heads), "--layers",
                str(cfg.layers), "--conv-kernel", str(cfg.conv_kernel), "--log-every", "1",
                "--export", str(work / "student")])

    (a0, a1), launches = _counted(torch, counters, ("fbank_power_mel", "flash_attention"),
                                  "distill_asr --synthetic", distill)
    add(launches)
    losses = json.loads((work / "student" / "run.json").read_text())["losses"]
    log({"phase": "onnx_distill_asr", "losses": losses, "agreement_before": a0,
         "agreement_after": a1})
    assert all(math.isfinite(x) for x in losses) and losses[-1] < losses[0], losses
    tmp.cleanup()
    return total


#: the program-statistics scenes (engine/programs.py), each on a tiny-preset
#: engine: the kernels it must reach on the card, and its bucket cap (s)
PROGRAM_STATS_SCENES = {
    "flagship": (("fbank_power_mel", "tcn_masker", "gau_attention"), 8.0),
    "long_buckets": (("fbank_power_mel", "flash_attention"), 32.0),
    "ring": (("fbank_power_mel", "flash_attention_stats"), 8.0),
    "pyannet": ((), 8.0),
}


def program_stats_engine(scene: str, device):
    """The tiny-preset engine of one program-statistics scene on ``device``
    (seed 0: the same weights on the card and on the CPU): ``ring`` over a
    mesh of ``LONG_SHARDS`` entries, ``pyannet`` with PyanNet (the published
    widths) serving OSD."""
    from audio_classification_tpu_torch.engine import BucketSpec, ModelPack, StageEngine
    from audio_classification_tpu_torch.engine import default_buckets, tiny_preset
    from audio_classification_tpu_torch.models.pyannet import PyanNet, PyanNetConfig
    from audio_classification_tpu_torch.parallel.mesh import make_mesh

    pack = ModelPack(tiny_preset(), seed=0, device=device)
    if scene == "pyannet":
        cfg = PyanNetConfig()
        pack.set_osd_pyannet(cfg, PyanNet(cfg).init(0).state_dict())
    mesh = make_mesh(LONG_SHARDS, devices=[device] * LONG_SHARDS) if scene == "ring" else None
    return StageEngine(pack, BucketSpec(default_buckets(SR, 0.5, PROGRAM_STATS_SCENES[scene][1]),
                                        4), mesh=mesh)


def drive_program_stats_scene(np, engine, scene: str) -> None:
    """One program-statistics scene through the engine's entry points:

    - flagship: the arena upload and the stages fed from it (OSD, the
      overlap path, the clean path, ASR), the fused paths from host batches
      with each backend (branches kept on the device and transcribed
      there), the stages one by one, an 8 -> 16 kHz resample (K1, K2, K4);
    - long_buckets: a 32 s bucket, OSDNet at T = 800 and SenseVoice at T =
      537 frames (K3 from ``FLASH_MIN_T``), and the clean path on it;
    - ring: a 100 s utterance through transcribe_long over the mesh (the
      128 s bucket, 535 frames a shard: K5);
    - pyannet: OSD by PyanNet on two 2 s mixtures (its LSTMs)."""
    rng = np.random.default_rng(5)
    targets = rng.standard_normal((3, 32)).astype(np.float32)
    targets = list(targets / np.linalg.norm(targets, axis=1, keepdims=True))

    def mixtures(seconds, n, seed):
        return [(0.2 * sum(talkers(int(seconds * SR), seed + i))).astype(np.float32)
                for i in range(n)]

    if scene == "flagship":
        wavs = mixtures(2, 3, 40)
        arena = engine.upload_arena(wavs)
        spans = [(int(o), int(n)) for o, n in zip(arena.offsets, arena.lengths)]
        engine.collect_osd_batch(engine.launch_osd_arena(arena), 0.5, 0.5, 0.1)
        engine.collect_overlap(engine.launch_overlap(None, targets, arena=arena, spans=spans),
                               wavs)
        engine.collect_clean(engine.launch_clean(None, targets, arena=arena, spans=spans))
        engine.collect_transcribe(engine.launch_transcribe(None, arena=arena, spans=spans))
        res = engine.process_overlap(wavs, targets, return_branches=True, lazy_branches=True)
        engine.transcribe_branches([r["branches"].ref(0) for r in res])
        engine.process_overlap(wavs, targets, backend="mossformer")
        engine.separate(wavs, 3)
        engine.separate(wavs[:2], 2)
        engine.separate(wavs[:1], backend="mossformer")
        engine.embed(wavs)
        engine.transcribe(wavs)
        engine.vad_probs_batch(wavs)
        engine.resample_batch([w[::2] for w in wavs], SR // 2, SR)
    elif scene == "long_buckets":
        wavs = mixtures(30, 1, 50)
        engine.osd_segments_batch(wavs, SR, 0.5, 0.5, 0.1)
        engine.transcribe(wavs)
        engine.process_clean(wavs, targets[:1])
    elif scene == "ring":
        engine.transcribe_long(mixtures(100, 1, 60)[0])
    else:
        engine.osd_segments_batch(mixtures(2, 2, 70), SR, 0.5, 0.5, 0.1)


def _program_rows(engine) -> list:
    """program_stats() without the first call's seconds, in order."""
    return [{k: s[k] for k in ("name", "shapes", "static", "calls", "flops", "bytes")}
            for s in engine.program_stats()]


def run_program_stats(torch, np, counters: dict) -> dict:
    """The program statistics (engine/programs.py) on the card:

    1. each of ``PROGRAM_STATS_SCENES`` on a tiny-preset engine on the card
       and the same engine on the CPU: the same programs, keys, calls,
       flops and bytes (each kernel by its ``work()``, PyanNet's LSTMs and
       the int8 GEMM by their formulas), the scene's kernels launched;
    2. the full-preset flagship overlap scene (the 20 s mixture of
       ``run_paths``, --osd-thr 0.0, Conv-TasNet-3): each program's key,
       calls, flops, bytes and first-call seconds, ``compile_summary()``,
       then one warm pass's work (Δ ``executed_flops()``) over its compute
       seconds against the dense bf16 and the float32 SIMT peaks;
    3. that warm pass counts nothing (no WorkCount is made) and queues the
       same device operations as with the registry taken out of the calls;
       so does the first pass of a second input of another length (the
       first 18 s of the mixture, the same buckets): its arena is shorter,
       and the arena's length is not in the programs' keys;
    4. the first pass counted again with the module memo off (every call of
       a ``shape_keyed`` block or model counted op by op) records the same
       programs, flops and bytes.
    -> launches per kernel."""
    from audio_classification_tpu_torch.engine import programs
    from audio_classification_tpu_torch.ops import work as work_mod
    from audio_classification_tpu_torch.pipelines.offline_overlap3 import (Overlap3Pipeline,
                                                                          build_engine)
    from audio_classification_tpu_torch.utils.config import Overlap3Config

    from audio_classification_tpu_torch.audio_io import read_wav, write_wav

    total = {k: 0 for k in counters}
    for scene, (expect, _cap) in PROGRAM_STATS_SCENES.items():
        rows, t0 = {}, time.perf_counter()
        for dev in ("cuda", "cpu"):
            engine = program_stats_engine(scene, torch.device(dev))
            if dev == "cuda":
                _, launches = _counted(torch, counters, expect, f"program_stats {scene}",
                                       lambda: drive_program_stats_scene(np, engine, scene))
                for k, n in launches.items():
                    total[k] += n
            else:
                drive_program_stats_scene(np, engine, scene)
            rows[dev] = _program_rows(engine)
        log({"phase": "program_stats", "scene": scene, "programs": rows["cuda"],
             "equal_to_cpu": rows["cuda"] == rows["cpu"], "sec": time.perf_counter() - t0})
        assert rows["cuda"] == rows["cpu"], (scene, rows)

    work_dir = ROOT / "build" / "chip_smoke"
    cfg = Overlap3Config(input_wavs=[str(work_dir / "mix.wav")], osd_thr=0.0,
                         target_wav=str(work_dir / "target.wav"), preset="full", seed=0,
                         sv_threshold=-1.0)
    engine = build_engine(cfg)
    t0 = time.perf_counter()
    first = Overlap3Pipeline(cfg, engine=engine).run()
    torch.cuda.synchronize()
    first_sec = time.perf_counter() - t0
    stats = engine.program_stats()
    first_rows = _program_rows(engine)
    summary = engine.compile_summary()
    log({"phase": "program_stats", "scene": "flagship overlap, full preset",
         "programs": stats, "compile_summary": summary, "first_pass_sec": first_sec,
         "segments_overlap_streams": first.metrics["segments_overlap_streams"]})
    assert summary["n_programs"] == len(stats) > 0 and all(s["flops"] > 0 for s in stats), stats

    made = []
    real = programs.WorkCount

    class Spy(real):
        def __init__(self):
            super().__init__()
            made.append(self)

    mix, sr = read_wav(work_dir / "mix.wav")
    write_wav(work_dir / "mix_18s.wav", mix[..., : 18 * sr], sr)
    cfg18 = dataclasses.replace(cfg, input_wavs=[str(work_dir / "mix_18s.wav")])
    programs.WorkCount = Spy
    try:
        calls = {(s["name"], s["shapes"], s["static"]): s["calls"] for s in stats}
        flops0 = engine.executed_flops()
        t0 = time.perf_counter()
        res = Overlap3Pipeline(cfg, engine=engine).run()
        torch.cuda.synchronize()
        warm_sec = time.perf_counter() - t0
        window = engine.executed_flops() - flops0
        # the window's work is the flops of the calls it made
        made_calls = sum(s["flops"] * (s["calls"] - calls[(s["name"], s["shapes"], s["static"])])
                         for s in engine.program_stats())
        compute_s = res.metrics["time_compute_total_sec"]
        warm = lambda: Overlap3Pipeline(cfg, engine=engine).run()  # noqa: E731
        with_registry = device_ops(torch, warm)["device_ops"]
        queued = queued_ops(torch, warm)
        # the 18 s input's first pass: no new program, no count
        t0 = time.perf_counter()
        Overlap3Pipeline(cfg18, engine=engine).run()
        torch.cuda.synchronize()
        first_18s_sec = time.perf_counter() - t0
        keys_18s = [(s["name"], s["shapes"], s["static"]) for s in engine.program_stats()]
        warm18 = lambda: Overlap3Pipeline(cfg18, engine=engine).run()  # noqa: E731
        with_registry_18s = device_ops(torch, warm18)["device_ops"]
    finally:
        programs.WorkCount = real
    assert keys_18s == list(calls) and not made, (keys_18s, list(calls), len(made))
    assert engine.compile_summary()["n_programs"] == len(stats)
    assert window == made_calls > 0, (window, made_calls)

    def bare(name, args, statics, run):
        return run()

    engine._programs.call = bare  # the registry taken out: each program as it runs
    without = device_ops(torch, warm)["device_ops"]
    queued_without = queued_ops(torch, warm)
    without_18s = device_ops(torch, warm18)["device_ops"]
    del engine._programs.call

    class NoMemo(dict):  # every call of a shape_keyed function counted op by op
        def get(self, key, default=None):
            return None

        def __setitem__(self, key, value):
            pass

    memo, work_mod._MEMO = work_mod._MEMO, NoMemo()
    engine._programs = programs.ProgramRegistry()
    try:
        t0 = time.perf_counter()
        Overlap3Pipeline(cfg, engine=engine).run()
        torch.cuda.synchronize()
        every_call_sec = time.perf_counter() - t0
    finally:
        work_mod._MEMO = memo
    every_call_rows = _program_rows(engine)
    report = {"phase": "program_stats", "scene": "flagship overlap, warm pass",
              "device": gpu_name_and_power_limit(),
              "window_flops": window, "compute_sec": compute_s,
              "flops_per_sec": window / compute_s,
              "share_of_989_tflops_dense_bf16": window / (compute_s * PEAK_BF16_FLOPS),
              "share_of_67_tflops_f32_simt": window / (compute_s * PEAK_F32_FLOPS),
              "work_counts_made": len(made), "first_pass_sec": first_sec,
              "warm_pass_sec": warm_sec, "first_pass_18s_input_sec": first_18s_sec,
              "device_ops": with_registry, "device_ops_without_registry": without,
              "queued_ops": queued, "queued_ops_without_registry": queued_without,
              "device_ops_18s_input": with_registry_18s,
              "device_ops_18s_input_without_registry": without_18s,
              "first_pass_every_call_counted_sec": every_call_sec,
              "memo_counts_equal_every_call": every_call_rows == first_rows}
    log(report)
    assert every_call_rows == first_rows, (every_call_rows, first_rows)
    assert (with_registry, queued, with_registry_18s) == (without, queued_without,
                                                          without_18s), report
    return total


def _pit(model, b):
    """cli/train_separator's loss: PIT SI-SDR of the separated mixture."""
    from audio_classification_tpu_torch.train.losses import pit_si_sdr_loss

    return pit_si_sdr_loss(model(b["mix"], b["mask"]), b["refs"], b["mask"])


def _aam(model, b):
    """cli/train_speaker's loss: AAM softmax against the model's centres."""
    from audio_classification_tpu_torch.train.losses import aam_softmax_loss

    emb, centres = model(b["feats"])
    return aam_softmax_loss(emb, b["labels"], centres)


def _same_records(recs, ref, name: str) -> None:
    """A mesh run's records against the meshless run's: kind, span, stream
    and text exact, sv_score within 1e-3 relative."""
    assert len(recs) == len(ref) > 0, (name, len(recs), len(ref))
    for a, b in zip(recs, ref):
        for key in ("kind", "start", "end", "stream", "text"):
            assert a.get(key) == b.get(key), (name, key, a.get(key), b.get(key))
        sa, sb = a.get("sv_score"), b.get("sv_score")
        assert (sa is None) == (sb is None), (name, sa, sb)
        if sa is not None:
            assert abs(sa - sb) <= 1e-3 * max(1.0, abs(sb)), (name, sa, sb)


def run_mesh_paths(torch, np, counters: dict) -> tuple:
    """Slice 16, the mesh paths at the full preset (seeded random weights)
    on the one card -> (launches per kernel, K4 cases at the TP shard
    widths). The lease has one card, and NCCL refuses two ranks on one
    card, so this phase shows the shard arithmetic with a mesh's entries in
    one process, and NCCL with a world of 1 on every mesh path; traffic
    between ranks is tested over gloo on the CPU (tests/test_torch_mesh_*):

    1. the flagship overlap scene (the 20 s mixture forced to overlap) on a
       DP 4 mesh (each entry's rows: K1, K2, K3) and on a DP 2 x TP 2 mesh
       (the TP separator is the dense TCN loop: no K2), records equal to the
       meshless run's;
    2. the same two runs under NCCL with a world of 1 (file:// init,
       destroyed after), equal to (1); also the 200 s utterance through
       transcribe(long_form=True) over a ring of 4 (K5 192 launches), its
       encoder logits against the one-shard path, and ring attention over
       [1, 4272, 8, 64] against the dense oracle (16 K5 launches);
    3. the MossFormer scene at TP 2 (K4 on v's De / 2 = 384 columns),
       records equal to the meshless run's; K4 at De 384 and 192 against its
       twin, timed; both separators at TP 2 in bfloat16 against the
       meshless bfloat16 engine on the same algorithm (2e-2 of max|s|);
    4. SeparatorTrainer DP 2 x TP 2 at the preset's Conv-TasNet widths: one
       step in float64 against the meshless step;
    5. dryrun_multichip(2) over the one card's entries."""
    import dataclasses
    import tempfile

    import torch.distributed as dist

    from audio_classification_tpu_torch.engine.runtime import ModelPack, StageEngine
    from audio_classification_tpu_torch.models import facades
    from audio_classification_tpu_torch.models.asr.sensevoice import sensevoice_frontend
    from audio_classification_tpu_torch.ops.kernels import gau
    from audio_classification_tpu_torch.parallel.dryrun import dryrun_multichip
    from audio_classification_tpu_torch.parallel.mesh import make_mesh
    from audio_classification_tpu_torch.parallel.ring_attention import (reference_attention,
                                                                        ring_attention)
    from audio_classification_tpu_torch.pipelines.offline_overlap3 import (Overlap3Pipeline,
                                                                           build_engine)
    from audio_classification_tpu_torch.train.trainer import SeparatorTrainer
    from audio_classification_tpu_torch.utils.config import Overlap3Config

    t_phase = time.perf_counter()
    work = ROOT / "build" / "chip_smoke"
    total = {k: 0 for k in counters}

    def add(launches):
        for k, n in launches.items():
            total[k] += n

    def scene(cfg, name, engine, expect, unexpected=()):
        res, launches = _counted(torch, counters, expect, name,
                                 lambda: Overlap3Pipeline(cfg, engine=engine).run(), unexpected)
        add(launches)
        return res.segments

    def cfg_of(**kw):
        return Overlap3Config(target_wav=str(work / "target.wav"), preset="full", seed=0,
                              sv_threshold=-1.0, osd_thr=0.0, out_dir=str(work / "mesh_out"),
                              **kw)

    cfg = cfg_of(input_wavs=[str(work / "mix.wav")])
    base = build_engine(cfg)
    ref = scene(cfg, "mesh_paths overlap scene, no mesh", base,
                ("fbank_power_mel", "tcn_masker", "flash_attention"))
    layouts = {"dp4": (4, 1, ("fbank_power_mel", "tcn_masker", "flash_attention"), ()),
               "dp2xtp2": (4, 2, ("fbank_power_mel", "flash_attention"), ("tcn_masker",))}

    def mesh_scenes(tag):
        for name, (n, mp, expect, unexpected) in layouts.items():
            mesh = make_mesh(n, model_axis=mp)
            assert mesh.distributed == (tag == "nccl world 1"), mesh
            recs = scene(cfg, f"mesh_paths overlap scene, {name}, {tag}",
                         StageEngine(base.pack, base.buckets, mesh=mesh), expect, unexpected)
            _same_records(recs, ref, name)
            log({"phase": "mesh_scene", "layout": name, "mesh": mesh.shape, "how": tag,
                 "records": len(recs), "equal_to_meshless": True})

    mesh_scenes("entries on one card")
    init = Path(tempfile.mkdtemp(dir=work)) / "pg_init"
    dist.init_process_group("nccl", init_method=f"file://{init}", rank=0, world_size=1)
    try:
        mesh_scenes("nccl world 1")
        # long form over a ring of 4 under NCCL: K5 on every block pair
        pack = base.pack
        layers = pack.asr_cfg.layers
        speech = sum(talkers(LONG_SEC * SR, 30)) / 3.0
        speech = (0.6 * speech / np.abs(speech).max()).astype(np.float32)
        ring4 = StageEngine(pack, mesh=make_mesh(LONG_SHARDS))
        text4, launches = _counted(
            torch, counters, ("fbank_power_mel",), f"mesh_paths long form {LONG_SEC} s, "
            f"ring of {LONG_SHARDS}, nccl world 1",
            lambda: facades.ASRRecognizer(ring4).transcribe(speech, SR, long_form=True),
            exact={"flash_attention_stats": layers * LONG_SHARDS ** 2, "flash_attention": 0})
        add(launches)
        text1 = StageEngine(pack).transcribe_long(speech)
        with torch.inference_mode():
            t = ring4.buckets.long_bucket_for(len(speech))
            w = torch.zeros((1, t), device="cuda")
            w[0, : len(speech)] = torch.from_numpy(np.round(speech * 32768) / 32768).to("cuda")
            feats, mask = sensevoice_frontend(w, torch.tensor([len(speech)], device="cuda"),
                                              pack.asr_cfg)
            dense = pack.models["asr"](feats, mask)
            ring = pack.models["asr"](feats, mask, mesh=ring4.mesh, sp_axis="data")
        valid = torch.cat([torch.ones((1, pack.asr_cfg.num_prompt), dtype=torch.bool,
                                      device="cuda"), mask], dim=1)[..., None]
        err = ((dense - ring).abs() * valid).max().item()
        peak = (dense.abs() * valid).max().item()
        # ring attention itself over [1, 4272, 8, 64], the ring of 4's blocks
        gen = torch.Generator(device="cpu").manual_seed(16)
        q, k, v = (torch.randn((1, 4272, 8, 64), generator=gen).to("cuda") for _ in range(3))
        kv_mask = torch.arange(4272, device="cuda")[None, :] < 3337
        out, launches = _counted(torch, counters, (), "mesh_paths ring attention, ring of 4, "
                                 "nccl world 1",
                                 lambda: ring_attention(q, k, v, ring4.mesh, kv_mask=kv_mask),
                                 exact={"flash_attention_stats": LONG_SHARDS ** 2})
        add(launches)
        oracle = reference_attention(q.double(), k.double(), v.double(), kv_mask)
        ring_err = (out.double() - oracle).abs().max().item() / oracle.abs().max().item()
        log({"phase": "mesh_long_form", "how": "nccl world 1", "seconds": LONG_SEC,
             "shards": LONG_SHARDS, "texts_equal": text4 == text1, "text_len": len(text1),
             "logits_rel_err": err / peak, "tol_rel": 1e-3,
             "ring_attention_rel_err_vs_float64_oracle": ring_err, "ring_tol_rel": 1e-4})
        assert text4 == text1 and len(text1) > 0, (text4[:80], text1[:80])
        assert err <= 1e-3 * peak and ring_err <= 1e-4, (err, peak, ring_err)
    finally:
        dist.destroy_process_group()

    # MossFormer at TP 2: K4 on v's 384 columns in every GAU of each shard
    cfg2 = cfg_of(input_wavs=[str(work / "mix2.wav")], sep_backend="mossformer")
    base2 = build_engine(cfg2)
    ref2 = scene(cfg2, "mesh_paths mossformer scene, no mesh", base2,
                 ("fbank_power_mel", "gau_attention"))
    tp2 = StageEngine(base2.pack, base2.buckets, mesh=make_mesh(2, model_axis=2))
    recs2 = scene(cfg2, "mesh_paths mossformer scene, tp2", tp2,
                  ("fbank_power_mel", "gau_attention"))
    _same_records(recs2, ref2, "mossformer tp2")
    gen = torch.Generator(device="cpu").manual_seed(44)
    k4_cases = [_gau_case(torch, gau, gen, 1, 15999, de, [11999], 10) for de in (384, 192)]

    # TP 2 in bfloat16 (the bfloat16 copy's shard weights meet MossFormer's
    # float32 stream), each separator against the meshless bfloat16 engine
    # on the same algorithm (for Conv-TasNet the dense TCN loop, which TP
    # runs; K2 bf16 rounds at other points) within 2e-2 of max|s|: TP rounds
    # each shard's product to bfloat16 before the sum (1.75e-2 on the CPU at
    # the preset's widths); a wrong shard or bias would be O(1). The distance
    # of both from float32 is logged beside.
    mix4 = sum(talkers(4 * SR, 46)) / 3.0
    mix4 = (0.6 * mix4 / np.abs(mix4).max()).astype(np.float32)
    preset = base.pack.preset
    dense = ModelPack(dataclasses.replace(
        preset, sep3=dataclasses.replace(preset.sep3, fused_tcn="off")), seed=0, device="cuda")
    dense.load_params("sep3", base.pack.models["sep3"].state_dict())
    for backend, pack, expect in (("convtasnet", dense, ()),
                                  ("mossformer", base2.pack, ("gau_attention",))):
        ref32 = StageEngine(pack, base.buckets).separate([mix4], backend=backend)[0]
        plain = StageEngine(pack, base.buckets, compute_dtype="bfloat16").separate(
            [mix4], backend=backend)[0]
        tp_bf16 = StageEngine(pack, base.buckets, mesh=make_mesh(2, model_axis=2),
                              compute_dtype="bfloat16")
        got_s, launches = _counted(torch, counters, expect,
                                   f"mesh_paths {backend} separate, tp2, bfloat16",
                                   lambda: tp_bf16.separate([mix4], backend=backend)[0],
                                   ("tcn_masker", "tcn_masker_bf16"))
        add(launches)
        peak = float(np.abs(ref32).max())
        e_tp, e_plain, e_pair = (float(np.abs(a - b).max() / peak)
                                 for a, b in ((got_s, ref32), (plain, ref32), (got_s, plain)))
        log({"phase": "mesh_tp_bfloat16", "backend": backend, "layout": "tp2",
             "shape": list(got_s.shape), "rel_err_vs_meshless_bfloat16": e_pair,
             "tol_rel": 2e-2, "rel_err_vs_float32": e_tp,
             "meshless_bfloat16_rel_err_vs_float32": e_plain, "launches": launches})
        assert got_s.shape == ref32.shape and np.isfinite(got_s).all(), backend
        assert e_pair <= 2e-2, (backend, e_pair)

    # one DP 2 x TP 2 training step in float64 against the meshless step
    with torch.enable_grad():
        sep_cfg = base.pack.preset.sep3
        rng = np.random.default_rng(5)
        refs = torch.from_numpy(0.3 * rng.standard_normal((4, 3, 8000))).to("cuda")
        mix, mask = refs.sum(dim=1), torch.ones((4, 8000), dtype=torch.float64, device="cuda")
        steps = {}
        for name, mesh in (("no mesh", None), ("dp2xtp2", make_mesh(4, model_axis=2))):
            tr = SeparatorTrainer(sep_cfg, mesh=mesh, lr=1e-3, seed=0, device="cuda")
            tr.model.double()
            loss = tr._update(lambda: tr.loss(mix, refs, mask))
            steps[name] = (loss, {n: p.detach().clone() for n, p in tr.model.named_parameters()},
                           {n: p.grad.clone() for n, p in tr.model.named_parameters()
                            if p.grad is not None})
        (l0, w0, g0), (l1, w1, g1) = steps["no mesh"], steps["dp2xtp2"]
        g_err = max(((g1[n] - g).abs().max() / g.abs().max().clamp_min(1e-30)).item()
                    for n, g in g0.items())
        w_err = max((w1[n] - w).abs().max().item() for n, w in w0.items())
        log({"phase": "mesh_train_step", "layout": "dp2xtp2", "dtype": "float64",
             "loss": l1, "loss_no_mesh": l0, "loss_rel_err": abs(l1 - l0) / abs(l0),
             "grad_rel_err_max": g_err, "weights_max_abs_diff": w_err})
        assert abs(l1 - l0) <= 1e-9 * abs(l0) and g_err <= 1e-7 and w_err <= 1e-9, \
            (l0, l1, g_err, w_err)

    dry = dryrun_multichip(2)
    log({"phase": "dryrun_multichip", "entries": 2, "how": "entries on one card", **dry})
    log({"phase": "mesh_paths", "sec": time.perf_counter() - t_phase})
    return total, k4_cases


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
    from audio_classification_tpu_torch.ops.kernels.attention import (
        flash_attention,
        flash_attention_stats,
    )
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
    # registers and spills of the float32 kernels on wgmma (ptxas -v of this
    # build; absent when the library was already built), and whether ptxas
    # serialized their wgmma (its C7513 / C7514 notes name the function).
    # K3 / K5's (flash_attention.cu) must neither spill nor serialize
    for src in ("tcn_masker.cu", "gau_attention.cu", "flash_attention.cu"):
        report = _build.reports.get(src, "")
        serialized = set(re.findall(r"serialized.*?function '(\S+)'", report))
        for r in _build.kernel_resources(report):
            if "3t32" in r["kernel"]:  # namespace t32
                rec = {"phase": "registers", "source": src, **r,
                       "serialized": r["kernel"] in serialized}
                log(rec)
                if src == "flash_attention.cu":
                    assert r["spill_bytes"] == 0 and not rec["serialized"], rec

    # the inference phases run without autograd, as the engine does: the
    # kernels' wrappers then launch as they always have (a stack of TCN
    # weights built with grad on stays attached to the model's parameters)
    torch.set_grad_enabled(False)
    results = {"fbank_power_mel": check_fbank(torch, np),
               "tcn_masker": check_tcn(torch, np),
               "tcn_masker_s8": check_tcn_s8(torch, np),
               "flash_attention": check_attention(torch, np),
               "gau_attention": check_gau(torch, np),
               "flash_attention_stats": check_attention_stats(torch, np),
               "tcn_masker_bf16": check_tcn_bf16(torch, np, quant=False),
               "tcn_masker_s8_bf16": check_tcn_bf16(torch, np, quant=True),
               "gau_attention_bf16": check_gau_bf16(torch, np),
               **check_attention_bf16(torch, np)}
    # K3 and K5 at D = 80 (Paraformer), 128 and a padded 40: their cases join
    # the kernels' records, errors against the float64 twin
    for name, cases in check_attention_head_dims(torch, np).items():
        results[name]["cases"] += cases
        results[name]["max_abs_err"] = max(results[name]["max_abs_err"],
                                           *(c["max_abs_err"] for c in cases))
    check_small_input_against_cpu(torch, np)
    check_bf16_against_cpu(torch, np)
    check_families_against_cpu(torch, np)
    check_pyannet_against_cpu(torch, np)
    check_bf16_paths_against_cpu(torch, np)
    # each wrapper's count of kernel launches; the masker's four C entry
    # points and K4's two count apart
    counters = {"fbank_power_mel": (fbank_power_mel, "launches"),
                "tcn_masker": (fused_tcn_masker, "launches"),
                "tcn_masker_s8": (fused_tcn_masker, "launches_s8"),
                "flash_attention": (flash_attention, "launches"),
                "gau_attention": (gau_attention, "launches"),
                "flash_attention_stats": (flash_attention_stats, "launches"),
                "tcn_masker_bf16": (fused_tcn_masker, "launches_bf16"),
                "tcn_masker_s8_bf16": (fused_tcn_masker, "launches_s8_bf16"),
                "gau_attention_bf16": (gau_attention, "launches_bf16"),
                "flash_attention_bf16": (flash_attention, "launches_bf16"),
                "flash_attention_stats_bf16": (flash_attention_stats, "launches_bf16")}
    launches = run_paths(torch, np, counters)
    for k, n in run_long_form(torch, np, counters).items():
        launches[k] += n
    # slice 15: ONNX export, map and direct serving, the tools, distill_asr
    for k, n in run_onnx_paths(torch, np, counters).items():
        launches[k] += n
    # slice 16: the mesh paths on the one card (entries, NCCL with a world of
    # 1), K4 at the TP shard widths
    mesh_launches, k4_tp = run_mesh_paths(torch, np, counters)
    for k, n in mesh_launches.items():
        launches[k] += n
    # slice 19: the program statistics, the card's against the CPU's, and the
    # flagship overlap scene's
    for k, n in run_program_stats(torch, np, counters).items():
        launches[k] += n
    results["gau_attention"]["cases"] += k4_tp
    results["gau_attention"]["max_abs_err"] = max(results["gau_attention"]["max_abs_err"],
                                                  *(c["max_abs_err"] for c in k4_tp))
    # the training slice, gradients on: the kernels' autograd Functions, then
    # the training CLIs
    torch.set_grad_enabled(True)
    check_train_grads(torch, np)
    for k, n in run_train_paths(torch, np, counters).items():
        launches[k] += n
    # slice 14b: the quality gate, distill_osd and --osd-checkpoint DIR, and
    # the native host codecs
    for k, n in run_quality_paths(torch, np, counters).items():
        launches[k] += n
    for k, n in launches.items():
        assert n > 0, f"kernel {k} was not launched on any path"
    log({"phase": "launches", "path": "all", **launches})

    meta = {
        "fbank_power_mel": ("audio_classification_tpu_torch/csrc/fbank_power_mel.cu",
                            "audio_classification_tpu/ops/pallas/fbank_kernel.py:95"),
        "tcn_masker": ("audio_classification_tpu_torch/csrc/tcn_masker.cu",
                       "audio_classification_tpu/ops/pallas/tcn_kernel.py:489"),
        # the same call with an int8 stack (cfg.wq): act_tcn_masker_s8
        "tcn_masker_s8": ("audio_classification_tpu_torch/csrc/tcn_masker.cu",
                          "audio_classification_tpu/ops/pallas/tcn_kernel.py:489"),
        "flash_attention": ("audio_classification_tpu_torch/csrc/flash_attention.cu",
                            "audio_classification_tpu/ops/pallas/attention_kernel.py:268"),
        "gau_attention": ("audio_classification_tpu_torch/csrc/gau_attention.cu",
                          "audio_classification_tpu/ops/pallas/attention_kernel.py:410"),
        # K3's body with the other epilogue: act_flash_attention_stats
        "flash_attention_stats": ("audio_classification_tpu_torch/csrc/flash_attention.cu",
                                  "audio_classification_tpu/ops/pallas/attention_kernel.py:293"),
        # the bf16 entry points: act_tcn_masker_bf16, act_tcn_masker_s8_bf16,
        # act_gau_attention_bf16 (the JAX kernels at dt = bfloat16)
        "tcn_masker_bf16": ("audio_classification_tpu_torch/csrc/tcn_masker.cu",
                            "audio_classification_tpu/ops/pallas/tcn_kernel.py:489"),
        "tcn_masker_s8_bf16": ("audio_classification_tpu_torch/csrc/tcn_masker.cu",
                               "audio_classification_tpu/ops/pallas/tcn_kernel.py:489"),
        "gau_attention_bf16": ("audio_classification_tpu_torch/csrc/gau_attention.cu",
                               "audio_classification_tpu/ops/pallas/attention_kernel.py:410"),
        # act_flash_attention_bf16, act_flash_attention_stats_bf16: the JAX
        # body at bf16 q, k, v (p cast to v's dtype :99)
        "flash_attention_bf16": ("audio_classification_tpu_torch/csrc/flash_attention.cu",
                                 "audio_classification_tpu/ops/pallas/attention_kernel.py:268"),
        "flash_attention_stats_bf16": (
            "audio_classification_tpu_torch/csrc/flash_attention.cu",
            "audio_classification_tpu/ops/pallas/attention_kernel.py:293"),
    }
    kernels = [{"name": name, "route": "cuda", "source": src, "replaces": rep,
                "launches": launches[name],
                **{k: results[name][k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms",
                                                 "bound_by", "library_ms")}}
               for name, (src, rep) in meta.items()]
    log({"phase": "elapsed", "sec": time.perf_counter() - t0})
    print(smi, flush=True)
    log({"kernels": kernels})
    log({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
