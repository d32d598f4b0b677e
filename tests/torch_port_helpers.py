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
from pathlib import Path

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


def shared_engines(quant: str, compute_dtype: str = "float32"):
    """The JAX engine and the port's on the same tiny weights and buckets,
    both in ``compute_dtype``. Under int8 the presets carry the quant fields
    ``build_engine`` sets; the JAX tiny separators always run the dense loop
    (bottleneck 32 never fuses), so the port's take fused_tcn="off" (the same
    model, activations quantised too); in bfloat16 too, so that both run the
    dense loop's rounding."""
    jp, tp = jax_tiny_preset(), tiny_preset()
    if quant == "int8":
        jp, tp = _int8(jp), _int8(tp, fused_tcn="off")
    elif compute_dtype != "float32":
        tp = dataclasses.replace(tp, sep3=dataclasses.replace(tp.sep3, fused_tcn="off"),
                                 sep2=dataclasses.replace(tp.sep2, fused_tcn="off"))
    jax_pack = JaxModelPack(jp, seed=0)
    pack = ModelPack(tp, seed=1, device="cpu")  # every weight is overwritten
    pack.load_state_dicts(params_to_state_dicts(
        {k: jax_pack.params[k] for k in ModelPack.STAGES}))
    jax_eng = JaxStageEngine(jax_pack, JaxBucketSpec(jax_default_buckets(SR, 0.5, 8.0), 4),
                             compute_dtype=compute_dtype)
    eng = StageEngine(pack, BucketSpec(default_buckets(SR, 0.5, 8.0), 4),
                      compute_dtype=compute_dtype)
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


def assert_records_match(got, ref, sv_tol=SV_TOL):
    got, ref = sorted(got, key=_sig), sorted(ref, key=_sig)
    assert [_sig(r) for r in got] == [_sig(r) for r in ref]
    for g, r in zip(got, ref):
        assert abs(g["sv_score"] - r["sv_score"]) <= sv_tol
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


# ------------------------------------------------------------ torch checkpoints
def pyannote_state_dict(cfg, rng) -> dict:
    """Seeded float32 tensors under pyannote's PyanNet names for ``cfg`` (a
    PyanNetConfig of either package), band edges inside the usable band."""
    rows = cfg.n_filters // 2 if cfg.analytic else cfg.n_filters
    sd = {
        "sincnet.wav_norm1d.weight": rng.randn(1) * 0.2 + 1.0,
        "sincnet.wav_norm1d.bias": rng.randn(1) * 0.1,
        "sincnet.conv1d.0.filterbank.low_hz_": rng.uniform(20, 0.1 * cfg.sample_rate, (rows, 1)),
        "sincnet.conv1d.0.filterbank.band_hz_": rng.uniform(20, 0.05 * cfg.sample_rate, (rows, 1)),
        "sincnet.norm1d.0.weight": rng.randn(cfg.n_filters) * 0.2 + 1.0,
        "sincnet.norm1d.0.bias": rng.randn(cfg.n_filters) * 0.1,
    }
    cin = cfg.n_filters
    for i, ch in enumerate(cfg.conv_channels, start=1):
        sd[f"sincnet.conv1d.{i}.weight"] = rng.randn(ch, cin, cfg.conv_kernel) * 0.2
        sd[f"sincnet.conv1d.{i}.bias"] = rng.randn(ch) * 0.1
        sd[f"sincnet.norm1d.{i}.weight"] = rng.randn(ch) * 0.2 + 1.0
        sd[f"sincnet.norm1d.{i}.bias"] = rng.randn(ch) * 0.1
        cin = ch
    h = cfg.lstm_hidden
    dirs = ("", "_reverse") if cfg.bidirectional else ("",)
    for layer in range(cfg.lstm_layers):
        in_dim = cin if layer == 0 else len(dirs) * h
        for sfx in dirs:
            sd[f"lstm.weight_ih_l{layer}{sfx}"] = rng.randn(4 * h, in_dim) * 0.2
            sd[f"lstm.weight_hh_l{layer}{sfx}"] = rng.randn(4 * h, h) * 0.2
            sd[f"lstm.bias_ih_l{layer}{sfx}"] = rng.randn(4 * h) * 0.1
            sd[f"lstm.bias_hh_l{layer}{sfx}"] = rng.randn(4 * h) * 0.1
    cin = len(dirs) * h
    for j, dim in enumerate(cfg.linear_dims):
        sd[f"linear.{j}.weight"] = rng.randn(dim, cin) * 0.2
        sd[f"linear.{j}.bias"] = rng.randn(dim) * 0.1
        cin = dim
    sd["classifier.weight"] = rng.randn(cfg.num_classes, cin) * 0.2
    sd["classifier.bias"] = rng.randn(cfg.num_classes) * 0.1
    return {k: v.astype(np.float32) for k, v in sd.items()}


def asteroid_convtasnet_state_dict(cfg, rng) -> dict:
    """Seeded float32 tensors under asteroid's ConvTasNet names for ``cfg``
    (a ConvTasNetConfig of either package)."""
    n, l, b, h, p = cfg.enc_dim, cfg.enc_kernel, cfg.bottleneck, cfg.hidden, cfg.conv_kernel
    sd = {"encoder.filterbank._filters": rng.randn(n, 1, l) / np.sqrt(l),
          "decoder.filterbank._filters": rng.randn(n, 1, l) / np.sqrt(n),
          "masker.bottleneck.0.gamma": 1.0 + 0.1 * rng.randn(1, n, 1),
          "masker.bottleneck.0.beta": 0.1 * rng.randn(1, n, 1),
          "masker.bottleneck.1.weight": rng.randn(b, n, 1) / np.sqrt(n),
          "masker.bottleneck.1.bias": 0.1 * rng.randn(b),
          "masker.mask_net.0.weight": np.full((1,), 0.25),
          "masker.mask_net.1.weight": rng.randn(cfg.n_src * n, b, 1) / np.sqrt(b),
          "masker.mask_net.1.bias": 0.1 * rng.randn(cfg.n_src * n)}
    for i in range(cfg.n_repeats * cfg.n_blocks):
        pre = f"masker.TCN.{i}"
        sd.update({f"{pre}.shared_block.0.weight": rng.randn(h, b, 1) / np.sqrt(b),
                   f"{pre}.shared_block.0.bias": 0.1 * rng.randn(h),
                   f"{pre}.shared_block.1.weight": np.full((1,), 0.25),
                   f"{pre}.shared_block.2.gamma": 1.0 + 0.1 * rng.randn(1, h, 1),
                   f"{pre}.shared_block.2.beta": 0.1 * rng.randn(1, h, 1),
                   f"{pre}.shared_block.3.weight": rng.randn(h, 1, p) / np.sqrt(p),
                   f"{pre}.shared_block.3.bias": 0.1 * rng.randn(h),
                   f"{pre}.shared_block.4.weight": np.full((1,), 0.25),
                   f"{pre}.shared_block.5.gamma": 1.0 + 0.1 * rng.randn(1, h, 1),
                   f"{pre}.shared_block.5.beta": 0.1 * rng.randn(1, h, 1),
                   f"{pre}.res_conv.weight": rng.randn(b, h, 1) / np.sqrt(h),
                   f"{pre}.res_conv.bias": 0.1 * rng.randn(b),
                   f"{pre}.skip_conv.weight": rng.randn(b, h, 1) / np.sqrt(h),
                   f"{pre}.skip_conv.bias": 0.1 * rng.randn(b)})
    return {k: np.asarray(v, np.float32) for k, v in sd.items()}


def save_torch_checkpoint(path, sd: dict, nested: bool = True) -> str:
    """``torch.save`` of numpy tensors, wrapped as a lightning checkpoint
    (``{"state_dict": ...}``) when ``nested``, else a bare state_dict."""
    tensors = {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in sd.items()}
    torch.save({"state_dict": tensors, "epoch": 3} if nested else tensors, str(path))
    return str(path)


def clearvoice_mossformer_state_dict(cfg, rng) -> dict:
    """Seeded float32 tensors under the ClearVoice / ModelScope MossFormer
    names for ``cfg`` (a MossFormerConfig of either package), with a rotary
    buffer riding along as in a real checkpoint."""
    d_e = cfg.dim * cfg.expansion
    stem = "mask_net.mdl.mossformerM.layers"
    sd = {"encoder.conv1d.weight": rng.randn(cfg.enc_dim, 1, cfg.enc_kernel) * 0.3,
          "mask_net.conv1d_encoder.weight": rng.randn(cfg.dim, cfg.enc_dim, 1) * 0.2,
          "mask_net.conv1d_encoder.bias": rng.randn(cfg.dim) * 0.1,
          "mask_net.norm_out.weight": 1.0 + 0.1 * rng.randn(cfg.dim),
          "mask_net.norm_out.bias": 0.1 * rng.randn(cfg.dim),
          "mask_net.mask_head.weight": rng.randn(cfg.n_src * cfg.enc_dim, cfg.dim, 1) * 0.2,
          "mask_net.mask_head.bias": 0.1 * rng.randn(cfg.n_src * cfg.enc_dim),
          "decoder.weight": rng.randn(cfg.enc_dim, 1, cfg.enc_kernel) * 0.2,
          "mask_net.mdl.rotary.freqs": rng.randn(8)}
    for i in range(cfg.layers):
        p = f"{stem}.{i}"
        sd.update({f"{p}.norm.weight": 1.0 + 0.1 * rng.randn(cfg.dim),
                   f"{p}.norm.bias": 0.1 * rng.randn(cfg.dim),
                   f"{p}.conv.weight": rng.randn(cfg.dim, 1, cfg.conv_kernel) * 0.3,
                   f"{p}.conv.bias": 0.1 * rng.randn(cfg.dim),
                   f"{p}.to_u.weight": rng.randn(d_e, cfg.dim) * 0.2,
                   f"{p}.to_u.bias": 0.1 * rng.randn(d_e),
                   f"{p}.to_v.weight": rng.randn(d_e, cfg.dim) * 0.2,
                   f"{p}.to_v.bias": 0.1 * rng.randn(d_e),
                   f"{p}.to_qk.weight": rng.randn(cfg.qk_dim, cfg.dim) * 0.2,
                   f"{p}.to_qk.bias": 0.1 * rng.randn(cfg.qk_dim),
                   f"{p}.qk_offset_scale.gamma": 1.0 + 0.1 * rng.randn(2, cfg.qk_dim),
                   f"{p}.qk_offset_scale.beta": 0.1 * rng.randn(2, cfg.qk_dim),
                   f"{p}.to_out.weight": rng.randn(cfg.dim, d_e) * 0.2,
                   f"{p}.to_out.bias": 0.1 * rng.randn(cfg.dim)})
    return {k: np.asarray(v, np.float32) for k, v in sd.items()}


def write_am_mvn(path, shift, scale, bare: bool = False) -> str:
    """A kaldi / FunASR ``am.mvn`` (<AddShift> / <Rescale> layers), or the
    bare two-vector form."""
    vec = lambda v: "[ " + " ".join(f"{x:.8g}" for x in v) + " ]"  # noqa: E731
    d = len(shift)
    if bare:
        text = f"{vec(shift)}\n{vec(scale)}\n"
    else:
        text = (f"<Nnet>\n<Splice> {d} {d}\n[ 0 ]\n<AddShift> {d} {d}\n<LearnRateCoef> 0 "
                f"{vec(shift)}\n<Rescale> {d} {d}\n<LearnRateCoef> 0 {vec(scale)}\n</Nnet>\n")
    Path(path).write_text(text)
    return str(path)
