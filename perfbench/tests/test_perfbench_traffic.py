"""The traffic generator: a seed repeats, seeds differ, every seed carries the
same work, and the wavs written are what the pipeline reads."""
import sys
from pathlib import Path

import numpy as np
import pytest

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))
from perfbench import traffic  # noqa: E402

CELLS = ("tse3-overlap", "mf2-overlap", "tse3-clean")


def _small(name):
    return dict(traffic.load_workload(name), pool_jobs=2)


@pytest.mark.parametrize("name", CELLS)
def test_a_seed_repeats_and_seeds_differ(name):
    wl = _small(name)
    a = traffic.make_jobs(wl, 2**31 + 11, n_jobs=1)
    b = traffic.make_jobs(wl, 2**31 + 11, n_jobs=1)
    c = traffic.make_jobs(wl, 2**31 + 12, n_jobs=1)
    for x, y in zip(a[0].mixtures + [a[0].target], b[0].mixtures + [b[0].target]):
        np.testing.assert_array_equal(x, y)
    assert any(len(x) != len(y) or not np.array_equal(x, y)
               for x, y in zip(a[0].mixtures, c[0].mixtures))


@pytest.mark.parametrize("name", CELLS)
def test_every_seed_gets_the_same_lengths_in_its_bucket(name):
    wl = traffic.load_workload(name)
    got = [np.sort(traffic.mixture_lengths(wl, s).ravel()) for s in (1, 2**31 + 5, 77)]
    for g in got[1:]:
        np.testing.assert_array_equal(got[0], g)
    lo, hi = wl["length_s"]
    assert got[0].min() >= lo * traffic.SR and got[0].max() <= hi * traffic.SR
    assert got[0].max() <= wl["bucket_s"] * traffic.SR
    assert got[0].min() > wl["bucket_s"] * traffic.SR // 2
    assert not np.array_equal(traffic.mixture_lengths(wl, 1), traffic.mixture_lengths(wl, 2))


@pytest.mark.parametrize("length_s", [[7.0, 16.0], [8.5, 16.5]])
def test_lengths_outside_the_bucket_are_refused(length_s):
    wl = dict(traffic.load_workload("tse3-overlap"), length_s=length_s)
    with pytest.raises(ValueError, match="bucket"):
        traffic.make_jobs(wl, 3)


def test_written_wavs_read_back_as_int16_over_32768(tmp_path):
    from audio_classification_tpu_torch.audio_io import read_wav

    jobs = traffic.make_jobs(dict(_small("mf2-overlap"), pool_jobs=1), 5)
    traffic.write(jobs, str(tmp_path))
    for path, x in zip(jobs[0].paths + [jobs[0].target_path], jobs[0].mixtures + [jobs[0].target]):
        wav, sr = read_wav(path)
        assert sr == traffic.SR
        np.testing.assert_array_equal(wav, x.astype(np.float32) / 32768.0)
    assert jobs[0].audio_s == sum(len(m) for m in jobs[0].mixtures) / traffic.SR
