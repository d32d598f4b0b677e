"""PyTorch port vs the JAX package: the fbank frontend (K1's twin), framing,
windows, LFR stacking, CMVN and l2norm (CPU, float32)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audio_classification_tpu.ops import fbank as jax_fbank
from audio_classification_tpu.ops.frames import frame_signal as jax_frame_signal
from audio_classification_tpu.ops.pallas.fbank_kernel import fbank_power_mel_pallas
from audio_classification_tpu.ops.signal import l2norm as jax_l2norm
from audio_classification_tpu_torch.ops import fbank
from audio_classification_tpu_torch.ops.frames import frame_signal, num_frames, window
from audio_classification_tpu_torch.ops.kernels.fbank import fbank_power_mel
from audio_classification_tpu_torch.ops.signal import l2norm

torch.set_num_threads(2)


def _speechlike(n, seed, batch=()):
    rng = np.random.default_rng(seed)
    t = np.arange(n) / 16000.0
    tone = 0.3 * np.sin(2 * np.pi * 523 * t) + 0.1 * np.sin(2 * np.pi * 1700 * t)
    return (tone + 0.05 * rng.standard_normal(batch + (n,))).astype(np.float32)


@pytest.mark.parametrize("shape", [(16000,), (2, 4000)])
def test_log_mel_fbank_matches_jax(shape):
    """log-mel within 1e-4 abs on bins within 15 nats of the peak (f32, a
    different summation order over 512 taps and 257 bins). Bins further
    below the peak carry the DFT's f32 cancellation error, which grows as
    the bin's power falls relative to the frame's energy, and are held to
    1e-3 (the JAX package holds its own kernel to 0.05 / 1.0 there,
    tests/test_pallas_fbank.py)."""
    x = _speechlike(shape[-1], 0, shape[:-1])
    cfg = fbank.FbankConfig()
    ref = np.asarray(jax_fbank.log_mel_fbank(jnp.asarray(x), jax_fbank.FbankConfig(),
                                             use_pallas=False))
    out = fbank.log_mel_fbank(torch.from_numpy(x), cfg).numpy()
    assert out.shape == ref.shape
    active = ref > ref.max() - 15.0
    assert np.abs(out - ref)[active].max() < 1e-4
    assert np.abs(out - ref).max() < 1e-3


def test_fbank_twin_matches_pallas_kernel():
    """K1's twin against the Pallas kernel in interpret mode on the same
    windowed frames (same tolerance split as above)."""
    cfg = fbank.FbankConfig()
    rng = np.random.default_rng(1)
    frames = (rng.standard_normal((300, cfg.n_fft)) * 3000.0).astype(np.float32)
    frames[:, cfg.frame_length:] = 0.0
    ref = np.asarray(fbank_power_mel_pallas(
        jnp.asarray(frames), cfg.n_fft, cfg.num_bins, cfg.sample_rate, cfg.low_freq,
        cfg.high_freq, cfg.log_floor, interpret=True))
    out = fbank_power_mel(torch.from_numpy(frames), fbank.fbank_bases(cfg, torch.device("cpu")),
                          cfg.log_floor).numpy()
    active = ref > ref.max() - 15.0
    assert np.abs(out - ref)[active].max() < 1e-4
    assert np.abs(out - ref).max() < 1e-3


def test_frames_and_window_match_jax():
    x = np.arange(1000, dtype=np.float32).reshape(2, 500)
    ref = np.asarray(jax_frame_signal(jnp.asarray(x), 100, 40))
    out = frame_signal(torch.from_numpy(x), 100, 40).numpy()
    np.testing.assert_array_equal(out, ref)
    assert out.shape[-2] == num_frames(500, 100, 40)
    assert frame_signal(torch.zeros(2, 50), 100, 40).shape == (2, 0, 100)
    w = window("povey", 400).numpy()
    assert w.shape == (400,) and w[0] == 0.0 and abs(w[199] - 1.0) < 1e-3


@pytest.mark.parametrize("n", [1, 6, 37])
def test_apply_lfr_matches_jax(n):
    rng = np.random.default_rng(n)
    feats = rng.standard_normal((2, n, 5)).astype(np.float32)
    ref = np.asarray(jax_fbank.apply_lfr(jnp.asarray(feats), 7, 6))
    out = fbank.apply_lfr(torch.from_numpy(feats), 7, 6).numpy()
    np.testing.assert_array_equal(out, ref)  # pure data movement: exact


def test_apply_cmvn_matches_jax():
    rng = np.random.default_rng(2)
    feats, mean, istd = (rng.standard_normal(s).astype(np.float32) for s in ((3, 4), (4,), (4,)))
    ref = np.asarray(jax_fbank.apply_cmvn(jnp.asarray(feats), jnp.asarray(mean),
                                          jnp.asarray(istd)))
    out = fbank.apply_cmvn(torch.from_numpy(feats), torch.from_numpy(mean),
                           torch.from_numpy(istd)).numpy()
    np.testing.assert_allclose(out, ref, rtol=1e-6)
    np.testing.assert_array_equal(  # identity without stats
        fbank.apply_cmvn(torch.from_numpy(feats), None, None).numpy(), feats)


def test_l2norm_matches_jax_and_is_zero_safe():
    v = np.array([[3.0, 4.0], [0.0, 0.0]], np.float32)
    ref = np.asarray(jax_l2norm(jnp.asarray(v)))
    np.testing.assert_allclose(l2norm(torch.from_numpy(v)).numpy(), ref, rtol=1e-6)
    np.testing.assert_allclose(l2norm(v), ref, rtol=1e-6)
