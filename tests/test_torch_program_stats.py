"""Program statistics of the port's StageEngine (engine/programs.py) against
the JAX engine's AOT registry (audio_classification_tpu/engine/runtime.py:
265-337, 926-951), and each kernel's ``work()`` against independent counts.

- ``work()`` of K2-K5 equals torch's FlopCounterMode on the float32 twins at
  small padded shapes (D 64 and 80); K1's equals its formula written out;
  the bf16 and int8 entries count what the float32 ones count.
- ``work()`` at every kernel case of chip_smoke.py equals the flops, bytes
  and exponentials of the inline formulas that the bounds there used before
  they read ``work()`` (``PARENT_CASES``: computed once from those formulas).
- The tiny flagship run on both engines (torch_port_helpers.shared_engines):
  the same program names, keys (but for ``PORT_DIFFERS``) and calls; each
  program's flops, port over JAX, within ``RATIO_TOL`` of ``RATIOS``.
  Products are counted alike (XLA counts the padded program; the port's
  dispatch count the padded shape's products by torch's formulas); the
  ratios stand under 1 by what each side counts beyond them: XLA adds a flop
  an element for elementwise ops, and counts the frontend's DFT as a GEMM
  where the port counts kernel K1's FFT (5 M log2 M a frame, ~40 times
  fewer): the tiny models are small beside their frontends, so a program
  with a frontend sits far under 1. The resampler's polyphase conv counts
  the same products on both sides. branch_q is elementwise: 0 on the port.
- The count hides a kernel entry's own ops (the twin's on the CPU), counts
  the int8 and bf16 programs as float32, once a key (warm calls and a
  second thread only add calls), and under a DP 2 mesh records the same
  programs with the rank's flops summed over its entries.
"""
import ast
import contextlib
import math
import threading

import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from audio_classification_tpu_torch.engine import BucketSpec, ModelPack, StageEngine, tiny_preset
from audio_classification_tpu_torch.engine import programs
from audio_classification_tpu_torch.engine.bucketing import default_buckets
from audio_classification_tpu_torch.ops import fbank as ops_fbank
from audio_classification_tpu_torch.ops import work as ops_work
from audio_classification_tpu_torch.ops.kernels import attention, fbank, gau, tcn
from audio_classification_tpu_torch.parallel.mesh import make_mesh
from torch_port_helpers import SR, _int8, shared_engines, windows

torch.set_num_threads(2)

#: flops port / JAX of each program of the flagship run, by (name, first
#: argument's shape, backend, return_branches), measured on the CPU
RATIOS = {
    ("osd_arena", (None,), None, None): 0.1264,
    ("osd", (2, 128000), None, None): 0.1389,
    ("overlap_arena", (None,), "convtasnet", False): 0.4395,
    ("overlap_path", (4, 32000), "convtasnet", True): 0.4394,
    ("overlap_path", (4, 32000), "mossformer", False): 0.9487,
    ("clean_arena", (None,), None, None): 0.3647,
    ("clean_path", (4, 32000), None, None): 0.3648,
    ("asr_arena", (None,), None, None): 0.1117,
    ("asr", (4, 32000), None, None): 0.1117,
    ("asr", (2, 128000), None, None): 0.1192,
    ("branch_q", (4, 3, 32000), None, None): 0.0,
    ("sep3", (4, 32000), None, None): 0.9656,
    ("sep2", (2, 32000), None, None): 0.9669,
    ("mossformer", (1, 32000), None, None): 0.9862,
    ("spk", (4, 32000), None, None): 0.3078,
    ("spk", (2, 128000), None, None): 0.3076,
    ("vad", (4, 32000), None, None): 0.0539,
    ("resample", (4, 8000), None, None): 1.0005,
}
RATIO_TOL = 0.02
#: where the port's key differs from the JAX engine's, by design: the arena
#: programs leave the arena's length out (JAX keys its 16384-sample grid)
#: and the gather starts are int64 (_launch_bucketed_arena);
#: transcribe_branches' row indices js, bis are int64 -> {name: {argument
#: index: what differs}}
ARENA_DIFFERS = {0: "shape", 1: "dtype"}
PORT_DIFFERS = {"osd_arena": ARENA_DIFFERS, "asr_arena": ARENA_DIFFERS,
                "clean_arena": ARENA_DIFFERS, "overlap_arena": ARENA_DIFFERS,
                "branch_q": {1: "dtype", 2: "dtype"}}
#: JAX programs without a port counterpart (none runs in the flagship run):
#: gather, a standalone test oracle, and arena_concat, the chunked arena
#: upload the port leaves out; the port's asr_long (transcribe_long) is a
#: plain jit outside the JAX registry
NO_COUNTERPART = {"gather", "arena_concat", "asr_long"}


def _targets(n):
    rng = np.random.default_rng(0)
    vecs = rng.standard_normal((n, 32)).astype(np.float32)
    return list(vecs / np.linalg.norm(vecs, axis=1, keepdims=True))


def flagship(engine):
    """The tiny flagship run: one arena upload and the stages fed from it
    (OSD, the overlap path, the clean path, ASR), the fused paths from host
    batches with each separation backend (branches kept on the device and
    transcribed there), the stages one by one, and an 8 -> 16 kHz resample."""
    wavs, tv = windows(1, 3), _targets(3)
    long = [np.concatenate([w, w, w[: SR // 2]]) for w in wavs[:2]]  # 4.5 s: the 8 s bucket
    arena = engine.upload_arena(wavs)
    spans = [(int(o), int(n)) for o, n in zip(arena.offsets, arena.lengths)]
    engine.collect_osd_batch(engine.launch_osd_arena(arena), 0.5, 0.5, 0.1)
    engine.collect_overlap(engine.launch_overlap(None, tv, arena=arena, spans=spans), wavs)
    engine.collect_clean(engine.launch_clean(None, tv, arena=arena, spans=spans))
    engine.collect_transcribe(engine.launch_transcribe(None, arena=arena, spans=spans))
    engine.osd_segments_batch(long, SR, 0.5, 0.5, 0.1)
    res = engine.process_overlap(wavs, tv, return_branches=True, lazy_branches=True)
    engine.transcribe_branches([r["branches"].ref(0) for r in res])
    engine.process_overlap(wavs, tv, backend="mossformer")
    engine.process_clean(wavs, tv)
    engine.separate(wavs, 3)
    engine.separate(wavs[:2], 2)
    engine.separate(wavs[:1], backend="mossformer")
    engine.embed(wavs + long)
    engine.transcribe(wavs + long)
    engine.vad_probs_batch(wavs)
    engine.resample_batch([w[: SR // 2] for w in wavs], SR // 2, SR)


def _parsed(stat):
    return ast.literal_eval(stat["shapes"]), ast.literal_eval(stat["static"])


def _label(stat):
    shapes, static = _parsed(stat)
    return (stat["name"], shapes[0][0], dict(static).get("backend"),
            dict(static).get("return_branches"))


def _by_key(engine):
    return {(s["name"], s["shapes"], s["static"]): s for s in engine.program_stats()}


@pytest.fixture(autouse=True)
def fresh_memo(monkeypatch):
    """Each test counts its modules afresh (ops/work.shape_keyed keeps a
    module's count for the process), so that what it checks is counted."""
    monkeypatch.setattr(ops_work, "_MEMO", {})


@pytest.fixture(scope="module")
def runs():
    jax_eng, eng = shared_engines("none")
    flagship(jax_eng)
    flagship(eng)
    return jax_eng, eng


def _matched(runs):
    """(port stat, JAX stat) of each program, the JAX key found by the
    port's with ``PORT_DIFFERS`` taken out."""
    jax_eng, eng = runs
    ref = {}
    for s in jax_eng.program_stats():
        shapes, static = _parsed(s)
        ref[(s["name"], _masked(s["name"], shapes), static)] = (s, shapes)
    out = []
    for s in eng.program_stats():
        shapes, static = _parsed(s)
        out.append((s, shapes, *ref[(s["name"], _masked(s["name"], shapes), static)]))
    return out


def _masked(name, shapes):
    differs = PORT_DIFFERS.get(name, {})
    return tuple((None if differs.get(i) == "shape" else shape,
                  None if differs.get(i) == "dtype" else dtype)
                 for i, (shape, dtype) in enumerate(shapes))


# ------------------------------------------------------------ (c) the JAX registry
def test_programs_match_the_jax_engine(runs):
    """Names, shapes, statics and calls as the JAX engine records them, but
    for the arguments ``PORT_DIFFERS`` lists, which differ as it says."""
    jax_eng, eng = runs
    got, ref = eng.program_stats(), jax_eng.program_stats()
    assert len(got) == len(ref) == 18
    assert {s["name"] for s in got} == {s["name"] for s in ref}
    assert not {s["name"] for s in got} & NO_COUNTERPART
    for s, shapes, r, ref_shapes in _matched(runs):
        assert s["static"] == r["static"] and s["calls"] == r["calls"], (s, r)
        for i, what in PORT_DIFFERS.get(s["name"], {}).items():
            (shape, dtype), (ref_shape, ref_dtype) = shapes[i], ref_shapes[i]
            if what == "dtype":
                assert (shape, dtype, ref_dtype) == (ref_shape, "int64", "int32"), s
            else:  # the arena: any length on the port, JAX's 16384-sample grid
                assert (shape, dtype) == ((None,), ref_dtype) and ref_shape[0] % 16384 == 0, s
    assert {(s["name"], s["calls"]) for s in got} >= {("asr", 2), ("overlap_path", 1)}


def test_flop_ratios_to_jax(runs):
    """Each program's flops, port over JAX, within RATIO_TOL of its stated
    ratio; bytes and first-call seconds are there and non-negative."""
    seen = {}
    for s, _shapes, r, _ in _matched(runs):
        seen[_label(s)] = s["flops"] / r["flops"]
        assert s["bytes"] > 0 and s["lower_s"] >= 0.0 and s["compile_s"] == 0.0, s
    assert seen.keys() == RATIOS.keys()
    for label, ratio in seen.items():
        assert abs(ratio - RATIOS[label]) <= RATIO_TOL, (label, ratio)


def test_executed_flops_and_summary(runs):
    _jax, eng = runs
    stats = eng.program_stats()
    assert eng.executed_flops() == sum(s["flops"] * s["calls"] for s in stats)
    summary = eng.compile_summary()
    assert summary["n_programs"] == len(stats)
    assert summary["lower_total_s"] == round(sum(s["lower_s"] for s in stats), 3)
    assert summary["compile_total_s"] == 0.0


# ------------------------------------------------------------ (a) work() by an independent count
def _torch_flops(fn, *args, **kwargs) -> int:
    with FlopCounterMode(display=False) as counter:
        fn(*args, **kwargs)
    return counter.get_total_flops()


def _counted(fn, *args, **kwargs) -> ops_work.WorkCount:
    with ops_work.WorkCount() as count:
        fn(*args, **kwargs)
    return count


@pytest.fixture(scope="module")
def tiny_stacks():
    """The tiny Conv-TasNet masker stacked three ways: float32, bfloat16 and
    the int8 weight stream (2 blocks, C 32, H 64)."""
    model = ModelPack(tiny_preset(), seed=0, device="cpu").models["sep3"]
    with torch.no_grad():
        return {"float32": tcn.stack_tcn_params(model.tcn_blocks()),
                "bfloat16": tcn.stack_tcn_params(model.to(torch.bfloat16).tcn_blocks(),
                                                 torch.bfloat16),
                "int8": tcn.stack_tcn_params(model.float().tcn_blocks(), weight_quant=True)}


def test_tcn_work_counts_the_twin(tiny_stacks):
    """K2: work() flops equal FlopCounterMode on the float32 twin at the
    padded shape; the entry reports them on every weight stream and dtype,
    bytes at the activations' width and the stack's own."""
    gen = torch.Generator().manual_seed(0)
    x = torch.randn((2, 50, 32), generator=gen)
    f_len = torch.tensor([50, 31], dtype=torch.int32)
    st = tiny_stacks["float32"]
    nb, c, hd = st["w_in"].shape
    want = tcn.work(2, 50, c, hd, nb, 0)["flops"]
    assert _torch_flops(tcn.tcn_masker_reference, x, f_len, st, n_per_repeat=2) == want
    for name, stack in tiny_stacks.items():
        xs = x.to(torch.bfloat16) if name == "bfloat16" else x
        got = _counted(tcn.fused_tcn_masker, xs, f_len, stack, n_per_repeat=2)
        weights = sum(stack[k].numel() * stack[k].element_size() for k in tcn.STACK_KEYS)
        assert (got.flops, got.bytes) == (want, xs.element_size() * 2.0 * 100 * c + weights)


@pytest.mark.parametrize("d", [64, 80])
@pytest.mark.parametrize("stats", [False, True])
def test_attention_work_counts_the_twin(d, stats):
    """K3 / K5: 4 Tq Tk D a head equals FlopCounterMode on the float32 twin
    at the padded shape; the bf16 entry counts the same flops, its q, k, v
    read at 2 bytes."""
    gen = torch.Generator().manual_seed(d)
    q = torch.randn((2, 3, 40, d), generator=gen)
    k, v = (torch.randn((2, 3, 56, d), generator=gen) for _ in range(2))
    mask = torch.arange(56)[None, :] < torch.tensor([56, 20])[:, None]
    twin = attention.attention_stats_reference if stats else attention.attention_reference
    entry = attention.flash_attention_stats if stats else attention.flash_attention
    work = attention.stats_work if stats else attention.work
    if not stats:  # K3 is self-attention
        k, v = k[:, :, :40], v[:, :, :40]
        mask = mask[:, :40]
    want = work(2, 3, 40, k.shape[2], d)
    assert _torch_flops(twin, q, k, v, mask) == want["flops"]
    got = _counted(entry, q, k, v, mask)
    assert (got.flops, got.bytes) == (want["flops"], want["bytes"])
    half = _counted(entry, *(z.to(torch.bfloat16) for z in (q, k, v)), mask)
    assert (half.flops, half.bytes) == (want["flops"], work(2, 3, 40, k.shape[2], d, 2)["bytes"])
    assert _counted(entry, q, k, v, None).bytes == want["bytes"] - 2 * k.shape[2]


def test_gau_work_counts_the_twin():
    """K4: 2 T n (Dqk + De) equals FlopCounterMode on the float32 twin at
    the padded shape; the bf16 entry counts the same flops."""
    gen = torch.Generator().manual_seed(4)
    q, k = (torch.randn((2, 40, 32), generator=gen) for _ in range(2))
    v = torch.randn((2, 40, 48), generator=gen)
    mask = torch.arange(40)[None, :] < torch.tensor([40, 17])[:, None]
    want = gau.work(2, 40, 32, 48)
    assert _torch_flops(gau.gau_attention_reference, q, k, v, mask, 0.025) == want["flops"]
    got = _counted(gau.gau_attention, q, k, v, mask, 0.025)
    assert (got.flops, got.bytes) == (want["flops"], want["bytes"])
    half = _counted(gau.gau_attention, q.bfloat16(), k.bfloat16(), v.bfloat16(), mask, 0.025)
    assert (half.flops, half.bytes) == (want["flops"], gau.work(2, 40, 32, 48, 2)["bytes"])


@pytest.mark.parametrize("cfg", [ops_fbank.FbankConfig(),
                                 ops_fbank.FbankConfig(frame_length_ms=64.0, num_bins=128)],
                         ids=["512", "1024"])
def test_fbank_work_is_the_fft_count(cfg):
    """K1: the formula written out (a 5 M log2 M complex FFT of M = n_fft / 2
    points, 19 operations a bin, 2 a non-zero mel weight, 1 a log a frame;
    frames and log-mel at 4 bytes and the kernel's tables), not the twin's
    DFT-GEMM; the bases carry the mel bank's non-zero count."""
    bases = ops_fbank.fbank_bases(cfg, torch.device("cpu"))
    nnz, rows, m = int((bases.mel_w != 0).sum()), bases.band_w.shape[0], cfg.n_fft // 2
    assert bases.mel_nnz == nnz
    frames = torch.randn((10, cfg.n_fft), generator=torch.Generator().manual_seed(1))
    got = _counted(fbank.fbank_power_mel, frames, bases, cfg.log_floor)
    assert got.flops == 10 * (5 * m * math.log2(m) + 19 * (m + 1) + 2 * nnz + cfg.num_bins)
    assert got.bytes == 4 * (10 * cfg.n_fft + 10 * cfg.num_bins + 2 * (m + 1)
                             + 2 * cfg.num_bins + rows * cfg.num_bins)
    assert got.flops < _torch_flops(fbank.fbank_power_mel_reference, frames, bases.cos_b,
                                    bases.msin_b, bases.mel_w, cfg.log_floor) / 10


def test_rnn_work_counts_the_decomposition():
    """rnn_work (PyanNet's LSTMs, and aten._cudnn_rnn's registration) is the
    CPU's decomposition: the input projection of every step, then one
    recurrent product a step, counted here by torch's formulas; the
    registration reads cuDNN's arguments; PyanNet's LSTM call reports it."""
    from audio_classification_tpu_torch.models import pyannet

    lstm = torch.nn.LSTM(20, 16, batch_first=True)
    x = torch.randn(3, 7, 20)

    def steps(x):
        gi = torch.nn.functional.linear(x, lstm.weight_ih_l0, lstm.bias_ih_l0)
        h = torch.zeros(3, 16)
        for t in range(x.shape[1]):
            g = gi[:, t] + torch.nn.functional.linear(h, lstm.weight_hh_l0, lstm.bias_hh_l0)
            h = torch.tanh(g[:, :16])
        return h

    want = ops_work.rnn_work(7, 3, 20, 16)
    assert _torch_flops(steps, x) == want["flops"]
    with torch.no_grad():
        got = _counted(pyannet._lstm, lstm, x)
    assert (got.flops, got.bytes) == (want["flops"], want["bytes"])
    args = (x, [], 4, None, None, None, 2, 16, 0, 2, True, 0.0, False, True, [], None)
    assert ops_work._cudnn_rnn_counts(args) == ops_work.rnn_work(7, 3, 20, 16, 2, 2)


def test_int_mm_is_counted():
    """aten._int_mm (2 M N K), which FlopCounterMode does not count, and the
    int8 GEMM entry by its formula on either device."""
    from audio_classification_tpu_torch.ops import quant

    a8 = torch.randint(-127, 128, (32, 24), dtype=torch.int8)
    b8 = torch.randint(-127, 128, (24, 16), dtype=torch.int8)
    assert _counted(torch._int_mm, a8, b8).flops == 2 * 32 * 24 * 16
    got = _counted(quant.int_matmul, a8, b8)
    assert (got.flops, got.bytes) == (2 * 32 * 24 * 16, 32 * 24 + 24 * 16 + 4 * 32 * 16)


# ------------------------------------------------------------ (b) chip_smoke's bounds
#: (work function, chip_smoke phase, work() arguments, flops, bytes[, exps])
#: at every kernel case of chip_smoke.py, from the inline formulas its
#: bounds used before they read work() (bytes None: the training cases'
#: bound takes the forward's flops alone)
PARENT_CASES = [
    ("fbank", "8 x 32 s", dict(n=25584, n_fft=512, nb=80, mel_nnz=501, band_rows=16),
     414588720, 60590728),
    ("fbank", "serving_osd", dict(n=1584, n_fft=512, nb=80, mel_nnz=501, band_rows=16),
     25668720, 3758728),
    ("fbank", "serving_streams", dict(n=4752, n_fft=512, nb=80, mel_nnz=501, band_rows=16),
     77006160, 11260552),
    ("fbank", "streaming", dict(n=198, n_fft=512, nb=80, mel_nnz=501, band_rows=16),
     3208590, 476680),
    ("fbank", "streaming_streams", dict(n=594, n_fft=512, nb=80, mel_nnz=501, band_rows=16),
     9625770, 1414408),
    ("fbank", "n_fft_1024", dict(n=25552, n_fft=1024, nb=128, mel_nnz=1009, band_rows=21),
     892608016, 117759496),
    ("tcn", "f32", dict(b=1, f=31999, c=128, hd=512, n_blocks=24, weight_bytes=19439616,
                        f_len=[19999], itemsize=4),
     190208729088, 39918592),
    ("tcn", "f32", dict(b=1, f=1999, c=128, hd=512, n_blocks=24, weight_bytes=19439616,
                        f_len=[1999], itemsize=4),
     19012313088, 21486592),
    ("tcn", "f32", dict(b=8, f=1999, c=128, hd=512, n_blocks=24, weight_bytes=19439616,
                        f_len=[1999, 1999, 1500, 1999, 1000, 1999, 750, 1999], itemsize=4),
     125972029440, 33002496),
    ("tcn", "world", dict(b=4, f=7999, c=64, hd=128, n_blocks=8, weight_bytes=835584, f_len=[7999,
                          5999, 3999, 2373], itemsize=4),
     8134963200, 11265024),
    ("tcn", "s8", dict(b=1, f=31999, c=128, hd=512, n_blocks=24, weight_bytes=5296128,
                       f_len=[19999], itemsize=4),
     190208729088, 25775104),
    ("tcn", "s8", dict(b=8, f=1999, c=128, hd=512, n_blocks=24, weight_bytes=5296128, f_len=[1999,
                       1999, 1500, 1999, 1000, 1999, 750, 1999], itemsize=4),
     125972029440, 18859008),
    ("tcn", "bf16", dict(b=1, f=31999, c=128, hd=512, n_blocks=24, weight_bytes=9928704,
                         f_len=[19999], itemsize=2),
     190208729088, 20168192),
    ("tcn", "bf16", dict(b=8, f=1999, c=128, hd=512, n_blocks=24, weight_bytes=9928704,
                         f_len=[1999, 1999, 1500, 1999, 1000, 1999, 750, 1999], itemsize=2),
     125972029440, 16710144),
    ("tcn", "bf16", dict(b=1, f=1999, c=128, hd=512, n_blocks=24, weight_bytes=9928704,
                         f_len=[1999], itemsize=2),
     19012313088, 10952192),
    ("tcn", "s8_bf16", dict(b=1, f=31999, c=128, hd=512, n_blocks=24, weight_bytes=5296128,
                            f_len=[19999], itemsize=2),
     190208729088, 15535616),
    ("tcn", "s8_bf16", dict(b=8, f=1999, c=128, hd=512, n_blocks=24, weight_bytes=5296128,
                            f_len=[1999, 1999, 1500, 1999, 1000, 1999, 750, 1999], itemsize=2),
     125972029440, 12077568),
    ("tcn", "s8_bf16", dict(b=1, f=1999, c=128, hd=512, n_blocks=24, weight_bytes=5296128,
                            f_len=[1999], itemsize=2),
     19012313088, 6319616),
    ("attention", "check_attention", dict(b=8, h=8, tq=537, tk=537, d=64, itemsize=4,
                                          valid_keys=[537, 440, 343, 246, 149, 52, 492, 395]),
     2918805504, 28471496, 11401584),
    ("attention", "check_attention", dict(b=1, h=8, tq=537, tk=537, d=64, itemsize=4,
                                          valid_keys=[537]),
     590579712, 4399641, 2306952),
    ("attention", "check_attention", dict(b=1, h=4, tq=800, tk=800, d=64, itemsize=4,
                                          valid_keys=[800]),
     655360000, 3277600, 2560000),
    ("attention", "check_attention", dict(b=8, h=8, tq=537, tk=537, d=64, itemsize=4,
                                          valid_keys=[345, 376, 151, 246, 21, 52, 300, 331]),
     2003791872, 25063624, 7827312),
    ("attention", "check_attention", dict(b=1, h=8, tq=4271, tk=4271, d=64, itemsize=4,
                                          valid_keys=[3337]),
     29188765696, 31166639, 114018616),
    ("attention_stats", "check_attention_stats", dict(b=1, h=8, tq=1068, tk=1068, d=64, itemsize=4,
                                                      valid_keys=[1068]),
     2335997952, 8818476, 9124992),
    ("attention_stats", "check_attention_stats", dict(b=1, h=8, tq=1068, tk=1068, d=64, itemsize=4,
                                                      valid_keys=[133]),
     290906112, 4988716, 1136352),
    ("attention_stats", "check_attention_stats", dict(b=3, h=8, tq=537, tk=1068, d=64, itemsize=4,
                                                      valid_keys=[1068, 300, 33]),
     1540786176, 12443460, 6018696),
    ("attention", "check_attention_head_dims", dict(b=1, h=4, tq=533, tk=533, d=80, itemsize=4,
                                                    valid_keys=[533]),
     363633920, 2729493, 1136356),
    ("attention", "check_attention_head_dims", dict(b=1, h=4, tq=4267, tk=4267, d=80, itemsize=4,
                                                    valid_keys=[3333]),
     18204046080, 19460267, 56887644),
    ("attention", "check_attention_head_dims", dict(b=2, h=4, tq=200, tk=200, d=128, itemsize=4,
                                                    valid_keys=[200, 77]),
     113459200, 2773392, 221600),
    ("attention", "check_attention_head_dims", dict(b=2, h=4, tq=300, tk=300, d=40, itemsize=4,
                                                    valid_keys=[300, 129]),
     82368000, 1317720, 514800),
    ("attention", "check_attention_head_dims", dict(b=1, h=4, tq=800, tk=800, d=192, itemsize=4,
                                                    valid_keys=[800]),
     1966080000, 9831200, 2560000),
    ("attention", "check_attention_head_dims", dict(b=1, h=4, tq=800, tk=800, d=256, itemsize=4,
                                                    valid_keys=[800]),
     2621440000, 13108000, 2560000),
    ("attention", "check_attention_head_dims", dict(b=2, h=4, tq=300, tk=300, d=200, itemsize=4,
                                                    valid_keys=[300, 129]),
     411840000, 6586200, 514800),
    ("attention_stats", "check_attention_head_dims", dict(b=1, h=4, tq=1067, tk=1067, d=80,
                                                          itemsize=4, valid_keys=[1067]),
     1457265920, 5498251, 4553956),
    ("attention_stats", "check_attention_head_dims", dict(b=1, h=4, tq=1067, tk=1067, d=80,
                                                          itemsize=4, valid_keys=[132]),
     180280320, 3104651, 563376),
    ("attention_stats", "check_attention_head_dims", dict(b=2, h=4, tq=200, tk=333, d=128,
                                                          itemsize=4, valid_keys=[333, 64]),
     162611200, 3277978, 317600),
    ("attention_stats", "check_attention_head_dims", dict(b=2, h=4, tq=300, tk=300, d=40,
                                                          itemsize=4, valid_keys=[300, 129]),
     82368000, 1336920, 514800),
    ("attention_stats", "check_attention_head_dims", dict(b=1, h=4, tq=1067, tk=1067, d=192,
                                                          itemsize=4, valid_keys=[1067]),
     3497438208, 13146507, 4553956),
    ("attention_stats", "check_attention_head_dims", dict(b=1, h=4, tq=1067, tk=1067, d=256,
                                                          itemsize=4, valid_keys=[1067]),
     4663250944, 17516939, 4553956),
    ("attention_stats", "check_attention_head_dims", dict(b=2, h=4, tq=300, tk=300, d=200,
                                                          itemsize=4, valid_keys=[300, 129]),
     411840000, 6605400, 514800),
    ("attention", "check_attention_bf16", dict(b=8, h=8, tq=537, tk=537, d=64, itemsize=2,
                                               valid_keys=[537, 440, 343, 246, 149, 52, 492,
                                                           395]),
     2918805504, 18637000, 11401584),
    ("attention", "check_attention_bf16", dict(b=1, h=8, tq=537, tk=537, d=64, itemsize=2,
                                               valid_keys=[537]),
     590579712, 2749977, 2306952),
    ("attention", "check_attention_bf16", dict(b=1, h=4, tq=800, tk=800, d=64, itemsize=2,
                                               valid_keys=[800]),
     655360000, 2048800, 2560000),
    ("attention", "check_attention_bf16", dict(b=1, h=8, tq=4271, tk=4271, d=64, itemsize=2,
                                               valid_keys=[3337]),
     29188765696, 19958959, 114018616),
    ("attention", "check_attention_bf16", dict(b=1, h=4, tq=533, tk=533, d=80, itemsize=2,
                                               valid_keys=[533]),
     363633920, 1706133, 1136356),
    ("attention", "check_attention_bf16", dict(b=2, h=4, tq=200, tk=200, d=128, itemsize=2,
                                               valid_keys=[200, 77]),
     113459200, 1796496, 221600),
    ("attention", "check_attention_bf16", dict(b=2, h=4, tq=300, tk=300, d=40, itemsize=2,
                                               valid_keys=[300, 129]),
     82368000, 851160, 514800),
    ("attention", "check_attention_bf16", dict(b=2, h=4, tq=300, tk=300, d=200, itemsize=2,
                                               valid_keys=[300, 129]),
     411840000, 4253400, 514800),
    ("attention_stats", "check_attention_bf16", dict(b=1, h=8, tq=1068, tk=1068, d=64, itemsize=2,
                                                     valid_keys=[1068]),
     2335997952, 5537580, 9124992),
    ("attention_stats", "check_attention_bf16", dict(b=1, h=8, tq=1068, tk=1068, d=64, itemsize=2,
                                                     valid_keys=[133]),
     290906112, 3622700, 1136352),
    ("attention_stats", "check_attention_bf16", dict(b=3, h=8, tq=537, tk=1068, d=64, itemsize=2,
                                                     valid_keys=[1068, 300, 33]),
     1540786176, 7924548, 6018696),
    ("gau", "check_gau", dict(b=1, t=15999, dqk=128, de=768, itemsize=4, valid_keys=[11999]),
     344013825792, 100360831),
    ("gau", "check_gau", dict(b=1, t=31999, dqk=128, de=768, itemsize=4, valid_keys=[31999]),
     1834893313792, 229400831),
    ("gau", "check_gau", dict(b=3, t=1237, dqk=128, de=768, itemsize=4, valid_keys=[1237, 700, 0]),
     4293755648, 20246143),
    ("gau", "check_gau_bf16", dict(b=1, t=15999, dqk=128, de=768, itemsize=2, valid_keys=[11999]),
     344013825792, 74762879),
    ("gau", "check_gau_bf16", dict(b=3, t=1237, dqk=128, de=768, itemsize=2, valid_keys=[1237, 700,
                                   0]),
     4293755648, 15825023),
    ("gau", "check_gau_bf16", dict(b=1, t=15999, dqk=128, de=384, itemsize=2, valid_keys=[11999]),
     196579329024, 40973183),
    ("gau", "train_grads", dict(b=2, t=3999, dqk=128, de=768, valid_keys=[3999, 3000]),
     50156289792, None),
    ("attention", "train_grads", dict(b=2, h=8, tq=537, tk=537, d=64, valid_keys=[537, 440]),
     1074481152, None),
    ("attention_stats", "train_grads", dict(b=1, h=8, tq=1068, tk=1068, d=64, valid_keys=[900]),
     1968537600, None),
    ("attention_stats", "train_grads", dict(b=1, h=8, tq=1068, tk=1068, d=64, valid_keys=[1]),
     2187264, None),
    ("tcn", "train_grads", dict(b=2, f=3999, c=128, hd=512, n_blocks=24, weight_bytes=0,
                                f_len=[3999, 3000]),
     66566873088, None),
]
WORK = {"fbank": fbank.work, "tcn": tcn.work, "attention": attention.work,
        "attention_stats": attention.stats_work, "gau": gau.work}


@pytest.mark.parametrize("case", PARENT_CASES, ids=lambda c: f"{c[0]}-{c[1]}")
def test_work_is_chip_smokes_earlier_count(case):
    kind, _phase, kwargs, flops, nbytes, *exps = case
    got = WORK[kind](**kwargs)
    assert got["flops"] == flops
    if nbytes is not None:  # the bound's terms (K2, K4 and K1 have no exponentials)
        assert got["bytes"] == nbytes and got.get("exps", 0.0) == (exps[0] if exps else 0.0)


@pytest.mark.parametrize("cfg, nnz, rows", [(ops_fbank.FbankConfig(), 501, 16), (
    ops_fbank.FbankConfig(frame_length_ms=64.0, num_bins=128), 1009, 21)], ids=["512", "1024"])
def test_fbank_bases_carry_chip_smokes_counts(cfg, nnz, rows):
    """The mel counts PARENT_CASES' K1 rows take are the bases' own."""
    bases = ops_fbank.fbank_bases(cfg, torch.device("cpu"))
    assert (bases.mel_nnz, bases.band_w.shape[0]) == (nnz, rows)


# ------------------------------------------------------------ (d)-(h) the count
def test_kernel_entry_hides_its_twin(runs, monkeypatch):
    """sep3 (K2 inside) counts the same with the masker's twin replaced by
    zeros of its shape: the twin's ops are not the program's count."""
    _jax, eng = runs
    ref = _by_key(eng)
    monkeypatch.setattr(tcn, "tcn_masker_reference",
                        lambda x, f_len, st, n_per_repeat: torch.zeros_like(x))
    stub = StageEngine(eng.pack, eng.buckets)
    stub.separate(windows(1, 3), 3)
    (s,) = stub.program_stats()
    r = ref[(s["name"], s["shapes"], s["static"])]
    assert s["name"] == "sep3" and (s["flops"], s["bytes"]) == (r["flops"], r["bytes"])


def test_int8_counts_the_float_products(runs):
    """An int8 engine's sep3 (the dense loop on int8 GEMMs) and asr count the
    products the float32 engine counts on the same batches."""
    _jax, eng = runs
    ref = _by_key(eng)
    q = StageEngine(ModelPack(_int8(tiny_preset(), fused_tcn="off"), seed=0, device="cpu"),
                    eng.buckets)
    wavs = windows(1, 3)
    q.separate(wavs, 3)
    q.transcribe(wavs)
    stats = q.program_stats()
    assert [s["name"] for s in stats] == ["sep3", "asr"]
    for s in stats:
        assert s["flops"] == ref[(s["name"], s["shapes"], s["static"])]["flops"] > 0, s


def test_bfloat16_counts_the_float32_flops(runs):
    _jax, eng = runs
    half = StageEngine(eng.pack, eng.buckets, compute_dtype="bfloat16")
    flagship(half)
    ref, got = _by_key(eng), _by_key(half)
    assert got.keys() == ref.keys()
    for key, s in got.items():
        assert s["flops"] == ref[key]["flops"], key


def test_counted_once_a_key(runs, monkeypatch):
    """A warm call adds a call and no count (no dispatch mode is made); two
    threads making the first call of one key at once record it once, with
    calls 2 and the count of one call."""
    _jax, eng = runs
    made = []

    class Spy(ops_work.WorkCount):
        def __init__(self):
            super().__init__()
            made.append(self)

    monkeypatch.setattr(programs, "WorkCount", Spy)
    wavs = windows(1, 3)
    one = StageEngine(eng.pack, eng.buckets)
    one.embed(wavs)
    (first,) = one.program_stats()
    one.embed(wavs)
    (again,) = one.program_stats()
    assert len(made) == 1 and first["calls"] == 1 and again["calls"] == 2
    assert (again["flops"], again["bytes"]) == (first["flops"], first["bytes"]) != (0.0, 0.0)
    assert one.executed_flops() == 2 * first["flops"]

    made.clear()
    two = StageEngine(eng.pack, eng.buckets)
    gate = threading.Barrier(2)

    def call():
        gate.wait()
        two.embed(wavs)

    threads = [threading.Thread(target=call) for _ in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    (s,) = two.program_stats()
    assert len(made) == 1 and s["calls"] == 2
    assert (s["flops"], s["bytes"]) == (first["flops"], first["bytes"])


def test_arena_and_resample_keys_take_no_length(runs, monkeypatch):
    """A second arena wave of another total length (the same buckets), and a
    second single resample of another length in the same bucket, call the
    programs the first made: calls 2, no second WorkCount, the same work."""
    _jax, eng = runs
    made = []

    class Spy(ops_work.WorkCount):
        def __init__(self):
            super().__init__()
            made.append(self)

    monkeypatch.setattr(programs, "WorkCount", Spy)
    one = StageEngine(eng.pack, eng.buckets)
    wavs, tv = windows(1, 3), _targets(3)
    for wave in (wavs, [w[: 7 * w.shape[-1] // 8] for w in wavs]):
        arena = one.upload_arena(wave)
        spans = [(int(o), int(n)) for o, n in zip(arena.offsets, arena.lengths)]
        one.collect_osd_batch(one.launch_osd_arena(arena), 0.5, 0.5, 0.1)
        one.collect_overlap(one.launch_overlap(None, tv, arena=arena, spans=spans), wave)
        one.resample(wave[0][: wave[0].shape[-1] // 2], SR // 2, SR)
    stats = one.program_stats()
    assert [s["name"] for s in stats] == ["osd_arena", "overlap_arena", "resample"]
    assert len(made) == 3 and all(s["calls"] == 2 for s in stats), stats
    assert ast.literal_eval(stats[0]["shapes"])[0] == ((None,), "int16")
    bucket = eng.buckets.long_bucket_for(wavs[0].shape[-1] // 2)
    assert ast.literal_eval(stats[2]["shapes"]) == (((bucket,), "float32"),)


class _Dispatches(ops_work.WorkCount):
    """A WorkCount that also counts the ops that reach its handler."""

    def __init__(self):
        super().__init__()
        self.dispatched = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.dispatched += 1
        return super().__torch_dispatch__(func, types, args, kwargs)


def test_counted_entry_runs_outside_the_mode():
    """A counted entry adds its work() and runs with the count's mode off
    the stack: none of its ops (the twin's, here) reaches the handler, and
    the mode is back after it."""
    cfg = ops_fbank.FbankConfig()
    bases = ops_fbank.fbank_bases(cfg, torch.device("cpu"))
    frames = torch.randn(6, cfg.n_fft)
    with _Dispatches() as count:
        fbank.fbank_power_mel(frames, bases, cfg.log_floor)
        inside = (count.dispatched, count.flops, count.bytes)
        torch.zeros(3) + 1
    want = fbank.work(6, cfg.n_fft, cfg.num_bins, bases.mel_nnz, bases.band_w.shape[0])
    assert inside == (0, want["flops"], want["bytes"]), inside
    assert count.dispatched > 0 and count.hidden == 0


def _decoder(name):
    """(module holding the loop, a call of it) on tiny widths."""
    from audio_classification_tpu_torch.models.asr import beam, paraformer, transducer
    from audio_classification_tpu_torch.models.asr import whisper_style

    gen = torch.Generator().manual_seed(0)
    feats = torch.randn(2, 96, 8, generator=gen)
    mask = torch.arange(96)[None, :] < torch.tensor([96, 70])[:, None]
    if name == "cif":
        h, alpha = torch.randn(2, 12, 8, generator=gen), torch.rand(2, 12, generator=gen)
        return paraformer, lambda: paraformer.cif_integrate(h, alpha, 6)
    if name == "whisper":
        model = whisper_style.WhisperStyle(whisper_style.WhisperStyleConfig(
            vocab_size=16, dim=16, heads=2, enc_layers=1, dec_layers=1, num_mel=8,
            max_decode_len=6))
        return whisper_style, lambda: model.greedy_decode(feats, mask)
    model = transducer.Transducer(transducer.TransducerConfig(
        vocab_size=16, dim=16, heads=2, layers=1, pred_dim=16, joiner_dim=16, num_mel=8))
    if name == "transducer":
        return transducer, lambda: model.greedy_decode(feats, mask)
    return beam, lambda: model.beam_decode(feats, mask, beam=3)


@pytest.mark.parametrize("name", ["transducer", "transducer_beam", "whisper", "cif"])
def test_host_loop_counted_by_its_first_step(name, monkeypatch):
    """A decoder's host loop under loop_step counts what counting every step
    counts, and only its first step's ops reach the handler."""
    module, run = _decoder(name)
    with torch.inference_mode(), _Dispatches() as fast:
        run()
    monkeypatch.setattr(module, "loop_step", lambda i, n: contextlib.nullcontext())
    with torch.inference_mode(), _Dispatches() as every:
        run()
    assert (fast.flops, fast.bytes) == (every.flops, every.bytes) and fast.bytes > 0
    assert fast.dispatched < every.dispatched / 2, (fast.dispatched, every.dispatched)


class _NoMemo(dict):
    """A module memo that keeps nothing: every call counted op by op."""

    def get(self, key, default=None):
        return None

    def __setitem__(self, key, value):
        pass


def test_shape_keyed_modules_count_what_every_call_counts(runs, monkeypatch):
    """The tiny flagship run counts the same programs, flops and bytes with
    the module memo (a repeated block, or a model another program ran,
    counted once and its count reused) as with every call counted op by op,
    and fewer ops reach the handler."""
    _jax, eng = runs
    seen = {}
    for memo in ("kept", "none"):
        monkeypatch.setattr(ops_work, "_MEMO", {} if memo == "kept" else _NoMemo())
        dispatched = []

        class Count(_Dispatches):
            def __init__(self):
                super().__init__()
                dispatched.append(self)

        monkeypatch.setattr(programs, "WorkCount", Count)
        engine = StageEngine(eng.pack, eng.buckets)
        flagship(engine)
        seen[memo] = ([(s["name"], s["shapes"], s["static"], s["calls"], s["flops"], s["bytes"])
                       for s in engine.program_stats()], sum(c.dispatched for c in dispatched))
    assert seen["kept"][0] == seen["none"][0]
    assert seen["kept"][1] < 0.8 * seen["none"][1], (seen["kept"][1], seen["none"][1])


def test_mesh_records_the_rank_work(runs):
    """Under a DP 2 mesh (two entries on the CPU) each program keeps its name
    and key, one call a batch, its flops the sum over the rank's entries:
    the meshless count of the same batch."""
    _jax, eng = runs
    ref = _by_key(eng)
    dp = StageEngine(eng.pack, BucketSpec(default_buckets(SR, 0.5, 8.0), 4),
                     mesh=make_mesh(2, devices=["cpu"] * 2))
    wavs, tv = windows(1, 3), _targets(3)
    dp.process_overlap(wavs, tv, return_branches=True)
    dp.separate(wavs, 3)
    dp.transcribe(wavs)
    stats = dp.program_stats()
    assert [s["name"] for s in stats] == ["overlap_path", "sep3", "asr"]
    for s in stats:
        r = ref[(s["name"], s["shapes"], s["static"])]
        assert s["calls"] == 1 and s["flops"] == r["flops"], (s, r)
