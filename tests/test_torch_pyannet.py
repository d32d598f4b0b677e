"""PyTorch port vs the JAX package: PyanNet (the pyannote segmentation
model), its frame count, the (speech, overlap) reduction and the pyannote
Binarize hysteresis, on the same seeded weights and inputs (CPU, float32).

JAX weights come from ``init_pyannet_params`` and cross through
``convert.from_jax.pyannet_params_to_state_dict``; the JAX model runs under
``jax.jit`` (its unjitted LSTM scan is slow).
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from audio_classification_tpu.models import pyannet as jax_pyannet
from audio_classification_tpu_torch.convert.from_jax import pyannet_params_to_state_dict
from audio_classification_tpu_torch.models import pyannet

torch.set_num_threads(2)

# the JAX package's own tiny PyanNet (tests/test_pyannet.py), at 16 kHz
TINY = dict(sample_rate=16000, n_filters=8, kernel_size=31, stride=5, analytic=True,
            conv_channels=(6, 6), conv_kernel=5, pool=3, lstm_hidden=16, lstm_layers=2,
            bidirectional=True, linear_dims=(16,), num_classes=3)


def _models(seed: int = 3, **over):
    """The JAX model and params and the port's model on the same weights."""
    kw = {**TINY, **over}
    jcfg, tcfg = jax_pyannet.PyanNetConfig(**kw), pyannet.PyanNetConfig(**kw)
    params = jax_pyannet.init_pyannet_params(jcfg, seed=seed)
    model = pyannet.PyanNet(tcfg)
    model.load_state_dict(pyannet_params_to_state_dict(params))
    return jax_pyannet.PyanNet(jcfg), params, model.eval()


def _ragged(seed: int, lens):
    rng = np.random.RandomState(seed)
    batch = np.zeros((len(lens), max(lens)), np.float32)
    for i, n in enumerate(lens):
        batch[i, :n] = 0.3 * rng.randn(n)
    return batch, np.asarray(lens, np.int32)


@pytest.mark.parametrize("analytic,bidirectional", [(True, True), (False, True), (True, False)])
def test_pyannet_matches_jax(analytic, bidirectional):
    """Probabilities [B, T', 3] of a ragged batch within 1e-5 abs (float32;
    sigmoid outputs in [0, 1], two LSTM layers), zeros past each item's
    frames on both sides."""
    jm, params, model = _models(analytic=analytic, bidirectional=bidirectional)
    wav, lens = _ragged(4, [4000, 2600, 3111])
    want = np.asarray(jax.jit(jm.apply)(params, wav, lens))
    with torch.inference_mode():
        got = model(torch.from_numpy(wav), torch.from_numpy(lens)).numpy()
    assert got.shape == want.shape
    assert np.abs(got - want).max() < 1e-5
    for i, n in enumerate(lens):
        assert not got[i, int(model.cfg.out_frames(int(n))):].any()


def test_pyannet_ragged_batch_matches_each_item_alone():
    """The valid-prefix trap: the backward LSTM reverses each row's valid
    prefix and the norms count valid frames only, so an item padded in a
    batch gives what it gives alone (2e-6 abs: the same arithmetic on
    other shapes) and zeros past its frames."""
    _, _, model = _models(seed=5)
    wav, lens = _ragged(6, [4000, 2600, 1700])
    with torch.inference_mode():
        batch = model(torch.from_numpy(wav), torch.from_numpy(lens))
        for i, n in enumerate(lens):
            solo = model(torch.from_numpy(wav[i:i + 1, :n]), torch.from_numpy(lens[i:i + 1]))
            frames = int(model.cfg.out_frames(int(n)))
            assert solo.shape[1] == frames
            assert (batch[i, :frames] - solo[0]).abs().max().item() < 2e-6
            assert not batch[i, frames:].any()


def test_pyannet_reverse_padded_matches_jax():
    """The prefix reversal alone, on a batch with an empty and a full row:
    equal to the JAX gather."""
    rng = np.random.RandomState(0)
    x = rng.randn(3, 7, 2).astype(np.float32)
    lens = np.asarray([7, 3, 0], np.int32)
    want = np.asarray(jax_pyannet._reverse_padded(x, lens))
    got = pyannet._reverse_padded(torch.from_numpy(x), torch.from_numpy(lens).long()).numpy()
    np.testing.assert_array_equal(got, want)


def test_pyannet_sinc_filters_match_jax():
    """The sinc filterbank from the band edges, analytic and not: within
    1e-5 of max|filter| (float32 sin / cos of arguments up to ~pi)."""
    for analytic in (True, False):
        kw = {**TINY, "analytic": analytic, "n_filters": 80, "kernel_size": 251, "stride": 10}
        jcfg, tcfg = jax_pyannet.PyanNetConfig(**kw), pyannet.PyanNetConfig(**kw)
        params = jax_pyannet.init_pyannet_params(jcfg, seed=1)
        want = np.asarray(jax_pyannet._sinc_filters(jcfg, params["sinc"]["low_hz"],
                                                    params["sinc"]["band_hz"]))[:, 0, :].T
        got = pyannet.sinc_filters(tcfg, torch.from_numpy(np.array(params["sinc"]["low_hz"])),
                                   torch.from_numpy(np.array(params["sinc"]["band_hz"])))
        assert got.shape == (80, 1, 251)
        assert np.abs(got[:, 0].numpy() - want).max() < 1e-5 * np.abs(want).max()


@pytest.mark.parametrize("cfg_kw", [TINY, {}])
def test_out_frames_matches_jax_and_the_forward(cfg_kw):
    """Frame counts (torch floor math) equal as ints and as tensors, at the
    tiny and the published widths; the port's forward emits that many."""
    jcfg, tcfg = jax_pyannet.PyanNetConfig(**cfg_kw), pyannet.PyanNetConfig(**cfg_kw)
    ns = [251, 2000, 3001, 4000, 16000, 160000, 320000]
    assert [int(tcfg.out_frames(n)) for n in ns] == [int(jcfg.out_frames(n)) for n in ns]
    assert tcfg.out_frames(torch.tensor(ns)).tolist() == [int(jcfg.out_frames(n)) for n in ns]
    assert tcfg.frame_period == jcfg.frame_period == (270 if not cfg_kw else 135)
    assert tcfg.out_frame_sec == jcfg.out_frame_sec
    if cfg_kw:
        _, _, model = _models()
        for n in (2000, 3001):
            with torch.inference_mode():
                out = model(torch.zeros((1, n)), torch.tensor([n]))
            assert out.shape[1] == int(tcfg.out_frames(n))


@pytest.mark.parametrize("classes", [1, 2, 3, 4])
def test_reduce_overlap_channels_matches_jax(classes):
    rng = np.random.RandomState(classes)
    probs = rng.uniform(size=(2, 50, classes)).astype(np.float32)
    want = np.asarray(jax_pyannet.reduce_overlap_channels(probs))
    got = pyannet.reduce_overlap_channels(torch.from_numpy(probs)).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("bc", [
    dict(), dict(onset=0.6, offset=0.4), dict(onset=0.5, offset=0.3, min_duration_off=0.3),
    dict(onset=0.5, offset=0.3, min_duration_on=0.2), dict(onset=0.0, offset=0.0),
    dict(onset=1.0, offset=1.0), dict(onset=0.55, offset=0.45, min_duration_on=0.1,
                                      min_duration_off=0.1, pad_onset=0.05, pad_offset=0.02)])
def test_hysteresis_intervals_match_jax(bc):
    """Intervals equal as lists on seeded smooth scores (runs above and
    below the thresholds), at PyanNet's published frame period."""
    rng = np.random.RandomState(7)
    scores = np.clip(0.5 + np.cumsum(rng.randn(600)) * 0.05, 0.0, 1.0).astype(np.float32)
    frame = pyannet.PyanNetConfig().out_frame_sec
    want = jax_pyannet.hysteresis_intervals(scores, frame, jax_pyannet.BinarizeConfig(**bc))
    got = pyannet.hysteresis_intervals(scores, frame, pyannet.BinarizeConfig(**bc))
    assert got == want
    assert dataclasses.asdict(pyannet.BinarizeConfig(**bc)) == \
        dataclasses.asdict(jax_pyannet.BinarizeConfig(**bc))


def test_pyannet_keeps_the_callers_tf32_flags():
    """The forward runs without TF32 and restores the flags it found."""
    _, _, model = _models()
    before = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cudnn.allow_tf32 = True
    try:
        seen = []
        hook = model.lstm[0]["fw"].register_forward_hook(
            lambda *a: seen.append((torch.backends.cuda.matmul.allow_tf32,
                                    torch.backends.cudnn.allow_tf32)))
        with torch.inference_mode():
            model(torch.zeros((1, 3000)), torch.tensor([3000]))
        hook.remove()
        assert seen == [(False, False)]
        assert torch.backends.cudnn.allow_tf32
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = before
