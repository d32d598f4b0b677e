"""The port's metrics and resource monitor against the JAX package's, on
the same seeded inputs: SI-SDR (scalar and batched PIT), CER / WER / edit
distance, OSD frame metrics, EER, monitor aggregate keys."""
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audio_classification_tpu import metrics as jm
from audio_classification_tpu.runtime import monitor as jax_monitor
from audio_classification_tpu_torch import metrics as tm
from audio_classification_tpu_torch.runtime import monitor

torch.set_num_threads(2)


def _sources(k, n, t, seed):
    rng = np.random.default_rng(seed)
    refs = [rng.standard_normal(t).astype(np.float32) for _ in range(k)]
    preds = [(refs[(i + 1) % k] if i < k else rng.standard_normal(t)).astype(np.float32)
             + 0.2 * rng.standard_normal(t).astype(np.float32) for i in range(n)]
    mix = np.sum(refs, axis=0).astype(np.float32)
    return mix, refs, preds


def test_exports_match():
    assert set(jm.__all__) <= set(tm.__all__)


@pytest.mark.parametrize("k,n", [(2, 2), (2, 3), (3, 3), (3, 4)])
def test_host_sisdr_and_pit_equal_reference(k, n):
    """The numpy functions are copies: results are equal exactly."""
    mix, refs, preds = _sources(k, n, 4000, seed=10 * k + n)
    assert tm.si_sdr(refs[0], preds[0]) == jm.si_sdr(refs[0], preds[0])
    assert tm.si_sdr(refs[0], preds[0][:3000]) == jm.si_sdr(refs[0], preds[0][:3000])
    assert np.isnan(tm.si_sdr(np.zeros(10, np.float32), np.ones(10, np.float32))) == \
        np.isnan(jm.si_sdr(np.zeros(10, np.float32), np.ones(10, np.float32)))
    assert tm.pit_best_si_sdr(refs, preds) == jm.pit_best_si_sdr(refs, preds)
    assert tm.sdr_improvement_pit(mix, refs, preds) == jm.sdr_improvement_pit(mix, refs, preds)
    if k == 2:
        assert tm.pit_best_si_sdr_2(refs, preds) == jm.pit_best_si_sdr_2(refs, preds)
        assert tm.sdr_improvement_pit_2(mix, refs[0], refs[1], preds) == \
            jm.sdr_improvement_pit_2(mix, refs[0], refs[1], preds)
    got = tm.pit_best_si_sdr(refs, preds[: k - 1])
    assert np.isnan(got[0]) and got[1] == []


@pytest.mark.parametrize("k,n", [(2, 2), (2, 3), (3, 3)])
def test_batched_pit_matches_reference(k, n):
    """Torch batched SI-SDR matrix / PIT against the JAX batched versions:
    2e-3 dB (float32 energies of 4000-sample signals, log10 of their ratio)
    and the same assignment; a zero reference gives the -1e9 sentinel."""
    b, t = 3, 4000
    packs = [_sources(k, n, t, seed=100 + i) for i in range(b)]
    mix = np.stack([p[0] for p in packs])
    refs = np.stack([np.stack(p[1]) for p in packs])
    preds = np.stack([np.stack(p[2]) for p in packs])
    mask = (np.arange(t)[None, :] < np.array([t, 3000, 2500])[:, None]).astype(np.float32)
    ref_mat = np.asarray(jm.si_sdr_matrix(jnp.asarray(refs), jnp.asarray(preds), jnp.asarray(mask)))
    got_mat = tm.si_sdr_matrix(torch.from_numpy(refs), torch.from_numpy(preds),
                               torch.from_numpy(mask)).numpy()
    assert np.abs(got_mat - ref_mat).max() < 2e-3
    rb, ri, rx = jm.sdr_improvement_pit_batch(jnp.asarray(mix), jnp.asarray(refs),
                                              jnp.asarray(preds), jnp.asarray(mask), k)
    gb, gi, gx = tm.sdr_improvement_pit_batch(torch.from_numpy(mix), torch.from_numpy(refs),
                                              torch.from_numpy(preds), torch.from_numpy(mask), k)
    assert np.abs(gb.numpy() - np.asarray(rb)).max() < 2e-3
    assert np.abs(gi.numpy() - np.asarray(ri)).max() < 2e-3
    np.testing.assert_array_equal(gx.numpy(), np.asarray(rx))
    # the batched PIT agrees with the host oracle on an unpadded item
    best, idx = tm.pit_best_si_sdr(list(refs[0]), list(preds[0]))
    assert abs(float(gb[0]) - best) < 2e-3 and list(gx[0].numpy()) == idx
    refs0 = refs.copy()
    refs0[1, 0] = 0.0
    z = tm.si_sdr_matrix(torch.from_numpy(refs0), torch.from_numpy(preds), torch.from_numpy(mask))
    assert (z[1, 0] == -1e9).all()


@pytest.mark.parametrize("ref,hyp", [
    ("hello world", "hello word"), ("", ""), ("", "x"), ("a b c", ""), ("你好 世界", "你好世"),
    ("the cat sat", "the  cat sat on"), ("A-b c!", "ab c"),
])
def test_text_metrics_equal_reference(ref, hyp):
    assert tm.cer(ref, hyp) == jm.cer(ref, hyp)
    assert tm.cer(ref, hyp, normalize=True) == jm.cer(ref, hyp, normalize=True)
    assert tm.wer(ref, hyp) == jm.wer(ref, hyp)
    assert tm.edit_distance(list(ref), list(hyp)) == jm.edit_distance(list(ref), list(hyp))
    assert tm.normalize_for_cer(ref) == jm.normalize_for_cer(ref)


def test_osd_metrics_equal_reference():
    rng = np.random.default_rng(0)
    sr = 8000
    srcs = [(rng.standard_normal(3 * sr) * (np.arange(3 * sr) > i * sr // 2)).astype(np.float32)
            for i in range(3)]
    np.testing.assert_array_equal(tm.frame_rms_np(srcs[0], sr, 0.5, 0.1),
                                  jm.frame_rms_np(srcs[0], sr, 0.5, 0.1))
    gt = tm.build_gt_overlap_mask(srcs, sr, 0.5, 0.1, 0.03)
    np.testing.assert_array_equal(gt, jm.build_gt_overlap_mask(srcs, sr, 0.5, 0.1, 0.03))
    pred = rng.random(len(gt) + 2) > 0.5
    assert tm.compute_osd_metrics(gt, pred) == jm.compute_osd_metrics(gt, pred)
    assert tm.compute_osd_metrics(gt[:0], pred) == jm.compute_osd_metrics(gt[:0], pred)
    with pytest.raises(ValueError):
        tm.frame_rms_np(srcs[0], sr, 0.0, 0.1)


def test_eer_and_aggregates_equal_reference():
    rng = np.random.default_rng(1)
    same, diff = rng.normal(0.6, 0.2, 200), rng.normal(0.1, 0.2, 300)
    assert tm.eer(same, diff) == jm.eer(same, diff)
    vals = list(rng.normal(5, 2, 11))
    assert tm.agg_stats(vals) == jm.agg_stats(vals)
    assert tm.agg_stats_full(vals) == jm.agg_stats_full(vals)


def test_monitor_aggregate_keys_match_reference():
    """Same aggregate keys as the JAX package's monitor; without a CUDA
    device the GPU fields read 0.0, as the reference's do without device
    statistics."""
    mons = [monitor.ResourceMonitor(0.1), jax_monitor.ResourceMonitor(0.1)]
    for m in mons:
        m.start()
    time.sleep(0.45)
    for m in mons:
        m.stop()
    got, ref = (m.aggregate() for m in mons)
    assert got and set(got) == set(ref)
    assert got["rss_peak_mb"] > 0 and got["cpu_peak"] >= 0
    if not torch.cuda.is_available():
        assert got["gpu_mem_allocated_peak_mb"] == 0.0
    assert monitor.ResourceMonitor(0.0).interval == 0.1
    cpu, jcpu = monitor.CPUMonitor(0.1), jax_monitor.CPUMonitor(0.1)
    cpu.start(), jcpu.start()
    time.sleep(0.35)
    assert set(cpu.stop()) == set(jcpu.stop())
