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

K3 and K5 are also held to their float64 twin at the head dims beside 64
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

import json
import math
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
    """K1's bound: the FFT's float32 operations a frame (5 M log2 M for the
    M = n_fft / 2 point complex FFT, 19 a bin for the split and the power,
    2 a mel weight, 1 a log) against the bytes (frames in, log-mel out, the
    kernel's constants), the bytes binding; beside it the bound of the DFT
    as a GEMM that the kernel replaced (``bound_dft_ms``)."""
    m, n_bins = n_fft // 2, n_fft // 2 + 1
    nnz = int((bases.mel_w != 0).sum().item())
    consts = bases.twiddle.numel() + bases.bands.numel() + bases.band_w.numel()
    fft = bound(n * (5.0 * m * math.log2(m) + 19.0 * n_bins + 2.0 * nnz + nb),
                4.0 * (n * n_fft + n * nb + consts))
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
    over the valid frames."""
    out = tcn.fused_tcn_masker(x, f_len, st, n_per_repeat=n_per_repeat)
    again = tcn.fused_tcn_masker(x, f_len, st, n_per_repeat=n_per_repeat)
    torch.cuda.synchronize()
    ref = tcn.tcn_masker_reference(x, f_len, st, n_per_repeat=n_per_repeat)
    b, f, c = x.shape
    valid = (torch.arange(f, device=x.device)[None, :] < f_len[:, None])[..., None]
    err = ((out - ref).abs() * valid).max().item()
    lens = f_len.tolist()
    case = {"shape": [b, f, c], "f_len": lens, "max_abs_err": err,
            "rel_err": err / (ref.abs() * valid).max().item(), "tol_rel": 1e-3,
            "padded_rows_zero": not (out * ~valid).any().item(),
            "repeat_identical": torch.equal(out, again),
            "ms": cuda_ms(torch, lambda: tcn.fused_tcn_masker(x, f_len, st,
                                                              n_per_repeat=n_per_repeat), iters),
            "plain_ms": cuda_ms(torch, lambda: tcn.tcn_masker_reference(
                x, f_len, st, n_per_repeat=n_per_repeat), iters),
            "library_ms": None}  # no single PyTorch call computes the masker
    nb, _, hd = st["w_in"].shape
    # per block and VALID frame (rows past f_len are padding that the
    # kernel never computes): in (C x H), res|skip (H x 2C) and the 3-tap
    # depthwise conv; bytes: the valid rows of x in and of the sum out, the
    # weights at their own width (one byte each in the int8 stream)
    n_valid = sum(lens)
    case.update(tensor_bound(nb * n_valid * (2.0 * c * hd + 2.0 * hd * 2 * c + 6.0 * hd), 0.0,
                             4.0 * 2 * n_valid * c
                             + sum(t.numel() * t.element_size() for t in st.values())))
    case["share"] = case["bound_ms"] / case["ms"]
    case["share_simt"] = case["bound_simt_ms"] / case["ms"]
    # 3xTF32 through 24 residual blocks (~1e-6 expected), another summation
    # order in every 128/512-wide contraction and in the F x H gLN reductions
    assert math.isfinite(err) and case["rel_err"] <= 1e-3, case
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
        case, _ = _tcn_case(torch, tcn, st, x, f_len, 8, iters)
        log({"phase": "kernel", "name": "tcn_masker", **case})
        cases.append(case)
    return {**cases[0], "max_abs_err": max(c_["max_abs_err"] for c_ in cases), "cases": cases}


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
                      "max_abs_err": err,
                      "ms": graph_ms(torch, k3, 20), "plain_ms": graph_ms(torch, twin, 20),
                      "library_ms": graph_ms(torch, sdpa, 20),
                      "wrapper_ms": cuda_ms(torch, k3, 20),
                      "plain_eager_ms": cuda_ms(torch, twin, 20),
                      "library_eager_ms": cuda_ms(torch, sdpa, 20),
                      # over the valid keys: a masked key adds exp(-1e9) = 0,
                      # and k, v are read for the valid keys alone
                      **tensor_bound(4.0 * h * t * n_valid * 64, 1.0 * h * t * n_valid,
                                        4.0 * (2 * q.numel() + 2 * h * 64 * n_valid)
                                        + mask.numel())})
        cases[-1]["ms_over_library_ms"] = cases[-1]["ms"] / cases[-1]["library_ms"]
        cases[-1]["wrapper_ms_over_library_eager_ms"] = (cases[-1]["wrapper_ms"]
                                                         / cases[-1]["library_eager_ms"])
        log({"phase": "kernel", "name": "flash_attention", **cases[-1], "tol": 2e-5})
        # f32 softmax over <= 4271 keys with O(1) outputs; padded query rows
        # are discarded downstream and not compared
        assert err <= 2e-5, cases[-1]
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
        sdpa_mask = mask[:, None, None, :]
        n_out = o.numel() + m.numel() + l.numel()
        k5 = lambda: attention.flash_attention_stats(q, k, v, mask)  # noqa: E731
        twin = lambda: attention.attention_stats_reference(q, k, v, mask)  # noqa: E731
        sdpa = lambda: torch.nn.functional.scaled_dot_product_attention(  # noqa: E731
            q, k, v, attn_mask=sdpa_mask)
        cases.append({
            "shape": [b, h, tq, 64], "keys": tk, "valid_keys": lens, "max_abs_err": err_o,
            "rel_err": err_o / peak, "tol_rel": 1e-4, "m_rel_err": err_m, "l_rel_err": err_l,
            "tol_ml_rel": 1e-5,
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
            **tensor_bound(4.0 * h * tq * sum(lens) * 64, 1.0 * h * tq * sum(lens),
                              4.0 * (q.numel() + 2 * h * 64 * sum(lens) + n_out)
                              + mask.numel())})
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
            n_out = q.numel()
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
            n_out = q.numel() + 2 * b * h * tq
        case.update({
            "ms": graph_ms(torch, fn, 20), "plain_ms": graph_ms(torch, twin, 20),
            # SDPA (the normalised output alone) on the same q, k, v: K3's
            # library call; beside K5 a yardstick of another function
            "library_ms" if kind == "K3" else "sdpa_ms_same_inputs":
                graph_ms(torch, sdpa, 20) if tq == tk or kind == "K3" else None,
            "wrapper_ms": cuda_ms(torch, fn, 20),
            **tensor_bound(4.0 * h * tq * n_valid * d, 1.0 * h * tq * n_valid,
                           4.0 * (q.numel() + 2 * h * d * n_valid + n_out) + mask.numel())})
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


def check_gau(torch, np) -> dict:
    """K4 against its blockwise twin at the main path's shape (one 8 s bucket
    of the full-preset MossFormer: T = 15999 frames, Dqk 128, De 768, the
    keys of a 6 s segment valid), at the 16 s bucket (T = 31999, every key
    valid: Separator.separate's MossFormer run) and at a small ragged batch
    of 3 with one fully masked item. Timed as K3: device time by CUDA-graph
    replay, each call through Python beside, for the kernel and its twin."""
    from audio_classification_tpu_torch.ops.kernels import gau

    dev = torch.device("cuda")
    gen = torch.Generator(device="cpu").manual_seed(4)
    cases = []
    for b, t, lens, iters in ((1, 15999, [11999], 10), (1, 31999, [31999], 4),
                              (3, 1237, [1237, 700, 0], 20)):
        q, k = (torch.randn((b, t, 128), generator=gen).to(dev) for _ in range(2))
        v = torch.randn((b, t, 768), generator=gen).to(dev)
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
        n_valid = sum(lens)
        cases.append({"shape": [b, t, 128, 768], "valid_keys": lens, "max_abs_err": err,
                      "rel_err": err / peak, "max_abs_err_vs_float64_twin": err64,
                      "rel_err_vs_float64_twin": err64 / peak,
                      "twin_rel_err_vs_float64_twin": (ref - ref64).abs().max().item() / peak,
                      "tol_rel": 1e-4,
                      # device time (graph replay); each call through Python beside
                      "ms": graph_ms(torch, k4, iters), "plain_ms": graph_ms(torch, twin, iters),
                      "wrapper_ms": cuda_ms(torch, k4, iters),
                      "plain_eager_ms": cuda_ms(torch, twin, iters),
                      "library_ms": None,  # no single PyTorch call computes relu^2 attention
                      # over the valid keys (a masked key contributes exactly 0):
                      # q read and out written for every row, k and v for the
                      # valid keys alone
                      **tensor_bound(2.0 * t * n_valid * (128 + 768), 0.0,
                                        4.0 * (q.numel() + n_valid * (128 + 768) + out.numel())
                                        + mask.numel())})
        cases[-1]["share"] = cases[-1]["bound_ms"] / cases[-1]["ms"]
        cases[-1]["share_simt"] = cases[-1]["bound_simt_ms"] / cases[-1]["ms"]
        log({"phase": "kernel", "name": "gau_attention", **cases[-1]})
        # float32 accuracy on both sides (the kernel in 3xTF32 on the tensor
        # cores tile by tile, ~3e-7 of max|out| in the CPU emulation; the
        # twin in cuBLAS's blocked order): 1e-4 of max|out| against each twin
        assert math.isfinite(err) and err <= 1e-4 * peak, cases[-1]
        assert err64 <= 1e-4 * peak, cases[-1]
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
    log({"phase": "long_form_families", "seconds": LONG_SEC,
         "text_len": {k: len(v) for k, v in texts.items()},
         "paraformer_texts_equal": texts["paraformer"] == texts["paraformer, mesh of 4"]})
    assert texts["paraformer"] == texts["paraformer, mesh of 4"]
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

    results = {"fbank_power_mel": check_fbank(torch, np),
               "tcn_masker": check_tcn(torch, np),
               "tcn_masker_s8": check_tcn_s8(torch, np),
               "flash_attention": check_attention(torch, np),
               "gau_attention": check_gau(torch, np),
               "flash_attention_stats": check_attention_stats(torch, np)}
    # K3 and K5 at D = 80 (Paraformer), 128 and a padded 40: their cases join
    # the kernels' records, errors against the float64 twin
    for name, cases in check_attention_head_dims(torch, np).items():
        results[name]["cases"] += cases
        results[name]["max_abs_err"] = max(results[name]["max_abs_err"],
                                           *(c["max_abs_err"] for c in cases))
    check_small_input_against_cpu(torch, np)
    check_families_against_cpu(torch, np)
    check_pyannet_against_cpu(torch, np)
    # each wrapper's count of kernel launches; the masker's two C entry points
    # count apart
    counters = {"fbank_power_mel": (fbank_power_mel, "launches"),
                "tcn_masker": (fused_tcn_masker, "launches"),
                "tcn_masker_s8": (fused_tcn_masker, "launches_s8"),
                "flash_attention": (flash_attention, "launches"),
                "gau_attention": (gau_attention, "launches"),
                "flash_attention_stats": (flash_attention_stats, "launches")}
    launches = run_paths(torch, np, counters)
    for k, n in run_long_form(torch, np, counters).items():
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
