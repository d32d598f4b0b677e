"""Shared set-up of the port's tests (not a test module): the JAX engine and
the port's on the same tiny weights, the fixture windows and the record
comparison of the streaming, serving and int8 pipeline tests; and the TF32
rounding with which the attention tests emulate the tensor-core kernels
(K3 / K5 csrc/flash_attention.cu, K4 csrc/gau_attention.cu) on the CPU.

Records are compared on kind, stream, text, ``end - start`` (the absolute
times come from ``time.time()``) and sv_score within ``SV_TOL``.
"""
import dataclasses
import time
import types

import numpy as np
import torch

from audio_classification_tpu.engine import BucketSpec as JaxBucketSpec
from audio_classification_tpu.engine import ModelPack as JaxModelPack
from audio_classification_tpu.engine import StageEngine as JaxStageEngine
from audio_classification_tpu.engine import default_buckets as jax_default_buckets
from audio_classification_tpu.engine import tiny_preset as jax_tiny_preset
from audio_classification_tpu_torch.convert.from_jax import params_to_state_dicts
from audio_classification_tpu_torch.engine import BucketSpec, ModelPack, StageEngine, tiny_preset
from audio_classification_tpu_torch.engine.bucketing import default_buckets

SR = 16000
SV_TOL = 2e-3


def _tone(dur, hz, amp=0.3):
    t = np.arange(int(dur * SR)) / SR
    return (amp * np.sin(2 * np.pi * hz * t)).astype(np.float32)


def _args(**kw):
    base = dict(sample_rate=SR, osd_thr=0.5, osd_win=0.5, osd_hop=0.1, sep_backend="convtasnet",
                sep_checkpoint="", sv_threshold=-1.0, min_overlap_dur=0.4, language="auto",
                preset="tiny", checkpoint_dir="", seed=0, max_batch=4, max_segment_sec=8.0,
                tokens="", provider="cpu", quant="none")
    base.update(kw)
    return types.SimpleNamespace(**base)


def _int8(preset, **sep_kw):
    return dataclasses.replace(
        preset, sep3=dataclasses.replace(preset.sep3, quant="int8", **sep_kw),
        sep2=dataclasses.replace(preset.sep2, quant="int8", **sep_kw),
        asr=dataclasses.replace(preset.asr, quant="int8"))


def shared_engines(quant: str):
    """The JAX engine and the port's on the same tiny weights and buckets.
    Under int8 the presets carry the quant fields ``build_engine`` sets; the
    JAX tiny separators always run the dense loop, so the port's take
    fused_tcn="off" (the same model, activations quantised too)."""
    jp, tp = jax_tiny_preset(), tiny_preset()
    if quant == "int8":
        jp, tp = _int8(jp), _int8(tp, fused_tcn="off")
    jax_pack = JaxModelPack(jp, seed=0)
    pack = ModelPack(tp, seed=1, device="cpu")  # every weight is overwritten
    pack.load_state_dicts(params_to_state_dicts(
        {k: jax_pack.params[k] for k in ModelPack.STAGES}))
    jax_eng = JaxStageEngine(jax_pack, JaxBucketSpec(jax_default_buckets(SR, 0.5, 8.0), 4))
    eng = StageEngine(pack, BucketSpec(default_buckets(SR, 0.5, 8.0), 4))
    return jax_eng, eng


def windows(seed=1, n=3):
    """2 s windows: a steady talker, one joined by a second voice half way,
    one of two voices throughout, over a little noise."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        w = _tone(2.0, 440 + 30 * i)
        if i % 3 == 1:
            w = w + np.concatenate([np.zeros(SR, np.float32), _tone(1.0, 880)])
        if i % 3 == 2:
            w = w + _tone(2.0, 700, 0.2)
        out.append((w + 0.01 * rng.standard_normal(w.size)).astype(np.float32))
    return out


def _sig(rec):
    return (rec["kind"], -1 if rec["stream"] is None else rec["stream"],
            round(rec["end"] - rec["start"], 3), rec["text"])


def assert_records_match(got, ref):
    got, ref = sorted(got, key=_sig), sorted(ref, key=_sig)
    assert [_sig(r) for r in got] == [_sig(r) for r in ref]
    for g, r in zip(got, ref):
        assert abs(g["sv_score"] - r["sv_score"]) <= SV_TOL
        assert g["target_src_text"] == r["target_src_text"]


def run_stream(cls, args, target_wav, engine, chunks):
    """add_audio_data -> drain -> close, one window at a time so that each
    window's records can be told apart -> (records per window, stats)."""
    pipe = cls(args, target_wav, engine=engine)
    per_window = []
    try:
        for c in chunks:
            pipe.add_audio_data(c)
            pipe.drain(timeout=120)
            t0 = time.time()
            while len(pipe.chunk_latencies) < len(per_window) + 1 and time.time() - t0 < 120:
                time.sleep(0.02)
            per_window.append(pipe.get_results())
    finally:
        pipe.close()
    return per_window, pipe.latency_stats()


# --- TF32 as the kernels' mma.sync products see it ---


def _tf32(x: torch.Tensor) -> torch.Tensor:
    """Round float32 to TF32 (10 mantissa bits), to nearest with ties away
    from zero, as cvt.rna.tf32.f32 does: add half of the 13 dropped bits to
    the magnitude's bit pattern and clear them."""
    u = x.contiguous().view(torch.int32)
    return ((u + 0x1000) & ~0x1FFF).view(torch.float32)


def _tf32_trunc(x: torch.Tensor) -> torch.Tensor:
    """What a TF32 mma makes of a raw float32 operand: the 13 low bits
    dropped (truncated toward zero)."""
    return (x.contiguous().view(torch.int32) & ~0x1FFF).view(torch.float32)


def _split_tf32(x: torch.Tensor, small_round: bool = True) -> tuple:
    """x = big + small, big rounded to TF32. K3 / K5 round the small half too
    (tf32_mma.cuh ``split``); K4 leaves it raw for the mma to truncate
    (``split_fast``)."""
    big = _tf32(x)
    small = x - big
    return big, _tf32(small) if small_round else _tf32_trunc(small)


def _mm_3xtf32(a: torch.Tensor, b: torch.Tensor, small_round: bool = True) -> torch.Tensor:
    """a @ b as the kernels form it: both sides split into big + small TF32
    halves, the small cross terms and then big * big summed in float32."""
    a_big, a_small = _split_tf32(a, small_round)
    b_big, b_small = _split_tf32(b, small_round)
    return (a_small @ b_big + a_big @ b_small) + a_big @ b_big


def _mm_tf32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """One plain TF32 product (what the tensor cores give without the split)."""
    return _tf32(a) @ _tf32(b)
