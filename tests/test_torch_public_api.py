"""The rest of the public API against the JAX package: the engine's fused
paths as the JAX engine's own tests call them (tests/test_fused_paths.py:
``process_clean``, ``process_overlap`` with eager and lazy branches,
``pull_branch_rows``, ``collect_tokens``), the STFT and signal helpers on
seeded inputs, and the package exports name by name.

Tiny preset, CPU, the same converted weights (torch_port_helpers.
shared_engines). Tolerances: sv scores 1e-4 as the float32 pipeline tests
allow; separated branches 1e-4 of their peak (float32 summation order); the
STFT products 1e-4 of the largest bin (float32 DFT bases summed over 512
samples in another order), the iSTFT 1e-3 of its peak (the first and last
samples are divided by the overlap-added squared window, which falls to
w[1]^2 ~ 1e-4 there and magnifies that order: measured 1.6e-4), the
elementwise helpers 1e-6.
"""
import importlib

import numpy as np
import pytest
import torch

from audio_classification_tpu_torch.engine import StageEngine
from test_torch_long_form import _bursts
from torch_port_helpers import shared_engines

# the modules, not the functions of the same names that the ops packages export
jax_signal = importlib.import_module("audio_classification_tpu.ops.signal")
jax_stft = importlib.import_module("audio_classification_tpu.ops.stft")
signal = importlib.import_module("audio_classification_tpu_torch.ops.signal")
stft = importlib.import_module("audio_classification_tpu_torch.ops.stft")

torch.set_num_threads(2)

SV_TOL = 1e-4
BRANCH_TOL = 1e-4


@pytest.fixture(scope="module")
def engines():
    return shared_engines("none")


def _chunks():
    return [_bursts(5000, seed=21), _bursts(7000, seed=22), _bursts(4096, seed=23)]


def _target(eng, n=8000):
    return eng.embed([_bursts(n, seed=24)])[0]


def test_process_clean_matches_jax(engines):
    jax_eng, eng = engines
    chunks = _chunks()
    ref = jax_eng.process_clean(chunks, [_target(jax_eng)] * 3)
    got = eng.process_clean(chunks, [_target(eng)] * 3)
    assert len(got) == len(ref) == 3
    for (gs, gt), (rs, rt) in zip(got, ref):
        assert isinstance(gs, float) and abs(gs - rs) <= SV_TOL
        assert gt == rt


@pytest.mark.parametrize("mode", ["plain", "eager", "lazy"])
def test_process_overlap_matches_jax(engines, mode):
    """The fused overlap path: scores, best branch and text as the JAX
    engine's; the branches (eager arrays, or lazy rows read one by one)
    within BRANCH_TOL of its peak."""
    jax_eng, eng = engines
    chunks = _chunks()
    kw = dict(return_branches=mode != "plain", lazy_branches=mode == "lazy")
    ref = jax_eng.process_overlap(chunks, [_target(jax_eng)] * 3, **kw)
    got = eng.process_overlap(chunks, [_target(eng)] * 3, **kw)
    assert len(got) == len(ref) == 3
    for g, r, chunk in zip(got, ref, chunks):
        assert set(g) == set(r)
        np.testing.assert_allclose(g["scores"], np.asarray(r["scores"]), atol=SV_TOL)
        assert g["best"] == r["best"] and g["text"] == r["text"]
        if mode == "plain":
            continue
        assert len(g["branches"]) == len(r["branches"]) == 3
        for bi in range(3):
            gb, rb = np.asarray(g["branches"][bi]), np.asarray(r["branches"][bi])
            assert gb.shape == rb.shape == (chunk.shape[-1],)
            assert np.abs(gb - rb).max() <= BRANCH_TOL * np.abs(rb).max()


def test_pull_branch_rows_matches_jax_and_the_lazy_rows(engines):
    """One pull over refs spanning rows and branches: each row equals the
    lazy row read alone, and the JAX engine's pull within BRANCH_TOL."""
    jax_eng, eng = engines
    chunks = _chunks()
    kw = dict(return_branches=True, lazy_branches=True)
    lazy = eng.process_overlap(chunks, [_target(eng)] * 3, **kw)
    jlazy = jax_eng.process_overlap(chunks, [_target(jax_eng)] * 3, **kw)
    refs = [rec["branches"].ref(bi) for rec in lazy for bi in (0, 2)]
    jrefs = [rec["branches"].ref(bi) for rec in jlazy for bi in (0, 2)]
    pulled = StageEngine.pull_branch_rows(refs)
    jpulled = type(jax_eng).pull_branch_rows(jrefs)
    assert len(pulled) == len(jpulled) == len(refs)
    for (dev, j, bi, n), got, want in zip(refs, pulled, jpulled):
        np.testing.assert_array_equal(got, lazy[j]["branches"][bi])
        assert got.shape == want.shape == (n,)
        assert np.abs(got - want).max() <= BRANCH_TOL * np.abs(want).max()
    assert StageEngine.pull_branch_rows([]) == []


def test_collect_tokens_matches_jax(engines):
    """The token ids and counts behind transcribe, item by item."""
    jax_eng, eng = engines
    chunks = _chunks()
    ref = jax_eng.collect_tokens(jax_eng.launch_transcribe(chunks))
    got = eng.collect_tokens(eng.launch_transcribe(chunks))
    assert len(got) == len(ref) == 3
    for (gi, gn), (ri, rn) in zip(got, ref):
        assert isinstance(gn, int) and gn == rn
        np.testing.assert_array_equal(np.asarray(gi)[:gn], np.asarray(ri)[:rn])
    assert [eng.pack.tokens.decode(ids[:n]) for ids, n in got] == eng.transcribe(chunks)


def test_empty_inputs(engines):
    _, eng = engines
    assert eng.process_clean([], []) == []
    assert eng.process_overlap([], []) == []


# ------------------------------------------------------------ ops
def _signal(seed=3, shape=(2, 4000)):
    return (0.3 * np.random.default_rng(seed).standard_normal(shape)).astype(np.float32)


@pytest.mark.parametrize("n_fft,frame_length,shift,win", [
    (512, None, 160, "hann"), (512, 400, 160, "povey"), (256, 200, 80, "hamming"),
    (400, None, 100, "periodic_hann")])
def test_stft_and_istft_match_jax(n_fft, frame_length, shift, win):
    x = _signal()
    re_j, im_j = (np.array(a) for a in jax_stft.stft(x, n_fft, frame_length, shift, win))
    re, im = stft.stft(torch.from_numpy(x), n_fft, frame_length, shift, win)
    scale = np.abs(re_j).max()
    assert re.shape == re_j.shape and im.shape == im_j.shape
    assert np.abs(re.numpy() - re_j).max() <= 1e-4 * scale
    assert np.abs(im.numpy() - im_j).max() <= 1e-4 * scale
    for length in (None, 3000, 5000):
        want = np.asarray(jax_stft.istft(re_j, im_j, n_fft, frame_length, shift, win, length))
        got = stft.istft(torch.from_numpy(re_j), torch.from_numpy(im_j), n_fft, frame_length,
                         shift, win, length).numpy()
        assert got.shape == want.shape
        assert np.abs(got - want).max() <= 1e-3 * np.abs(want).max()


@pytest.mark.parametrize("shape,shift", [((7, 16), 4), ((2, 3, 5, 10), 10), ((1, 1, 8), 3)])
def test_overlap_add_matches_jax(shape, shift):
    frames = _signal(4, shape)
    want = np.asarray(jax_stft.overlap_add(frames, shift))
    got = stft.overlap_add(torch.from_numpy(frames), shift).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=1e-6)


@pytest.mark.parametrize("frame_length,shift", [(400, 160), (320, 320), (4000, 1)])
def test_frame_rms_matches_jax(frame_length, shift):
    x = _signal(5)
    want = np.asarray(jax_signal.frame_rms(x, frame_length, shift))
    got = signal.frame_rms(torch.from_numpy(x), frame_length, shift).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("amp,peak", [(0.3, 0.98), (3.0, 0.98), (1.0, 0.5)])
def test_peak_limit_matches_jax(amp, peak):
    x = _signal(6) * amp
    want = np.asarray(jax_signal.peak_limit(x, peak))
    got = signal.peak_limit(torch.from_numpy(x), peak).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6)
    assert np.abs(got).max() <= max(peak, np.abs(x).max()) * (1 + 1e-6)


@pytest.mark.parametrize("gains", [[0.0, 0.0], [-3.0, 6.0], [-20.0, 1.5]])
def test_mix_with_gains_matches_jax(gains):
    src = _signal(7)
    want = np.asarray(jax_signal.mix_with_gains(src, gains))
    for given in (src, torch.from_numpy(src), list(src)):
        got = signal.mix_with_gains(given, gains).numpy()
        assert got.dtype == np.float32
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)


# ------------------------------------------------------------ exports
@pytest.mark.parametrize("module", ["", ".ops", ".models", ".engine", ".data"])
def test_exports_match_jax(module):
    """Each package's ``__all__`` names what the JAX package's does, and
    every name resolves."""
    ref = importlib.import_module("audio_classification_tpu" + module)
    got = importlib.import_module("audio_classification_tpu_torch" + module)
    want = getattr(ref, "__all__", None)
    if want is None:  # the top-level package: its constants
        assert got.__version__ == ref.__version__
        assert got.G_SAMPLE_RATE == ref.G_SAMPLE_RATE
        return
    assert sorted(got.__all__) == sorted(want)
    for name in got.__all__:
        assert getattr(got, name) is not None, name


def test_presets_match_jax():
    """engine.PRESETS (the JAX engine/runtime.py:93 registry): the same names,
    each factory giving the preset of that name, every config field the two
    packages share equal, nested configs too (the port's configs add fields
    of their own, such as the masker's ``fused_tcn``)."""
    import dataclasses

    from audio_classification_tpu.engine.runtime import PRESETS as JAX_PRESETS
    from audio_classification_tpu_torch.engine import PRESETS

    def same(a, b, where):
        if not dataclasses.is_dataclass(b):
            assert a == b, where
            return
        shared = {f.name for f in dataclasses.fields(a)} & {f.name for f in dataclasses.fields(b)}
        assert shared, where
        for k in shared:
            same(getattr(a, k), getattr(b, k), f"{where}.{k}")

    assert PRESETS.keys() == JAX_PRESETS.keys() == {"full", "tiny"}
    for name, make in PRESETS.items():
        assert make().name == name
        same(make(), JAX_PRESETS[name](), name)
