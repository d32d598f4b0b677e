"""The port's resamplers against the JAX package (CPU, float32, inputs made
from a seed with numpy): ops-level resample_poly / resample_linear and the
engine's resample / resample_batch."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audio_classification_tpu.ops.resample import resample_linear as jax_resample_linear
from audio_classification_tpu.ops.resample import resample_poly as jax_resample_poly
from audio_classification_tpu_torch.engine import BucketSpec, ModelPack, StageEngine, tiny_preset
from audio_classification_tpu_torch.engine.bucketing import default_buckets
from audio_classification_tpu_torch.ops.resample import resample_linear, resample_poly

torch.set_num_threads(2)
RATES = [(8000, 16000), (16000, 8000), (44100, 16000)]


@pytest.mark.parametrize("orig,new", RATES)
@pytest.mark.parametrize("t", [1, 2, 501, 4000])
def test_resample_poly_matches_jax(orig, new, t):
    """Same windowed-sinc prototype, the sum taken phase by phase instead of
    over the zero-stuffed signal: 5e-6 abs on unit-variance noise; output
    length ceil(T * up / down)."""
    x = np.random.default_rng(t).standard_normal((2, t)).astype(np.float32)
    ref = np.asarray(jax_resample_poly(jnp.asarray(x), orig, new))
    got = resample_poly(torch.from_numpy(x), orig, new).numpy()
    assert got.shape == ref.shape == (2, -(-t * new // orig))
    assert np.abs(got - ref).max() < 5e-6
    one = resample_poly(torch.from_numpy(x[0]), orig, new).numpy()  # no leading axis
    assert one.shape == got[0].shape and np.abs(one - got[0]).max() < 2e-6  # batch 1 vs 2


@pytest.mark.parametrize("orig,new", RATES)
@pytest.mark.parametrize("t", [1, 2, 501])
def test_resample_linear_matches_jax(orig, new, t):
    """n_new = round(T * new / orig) points over [0, T - 1]. 1e-4 abs on a
    300 Hz tone of amplitude 0.5: the two float32 position grids differ by up
    to T * 2^-23 samples, times the tone's slope per sample."""
    x = (0.5 * np.sin(2 * np.pi * 300 * np.arange(t) / orig + 0.3)).astype(np.float32)[None]
    ref = np.asarray(jax_resample_linear(jnp.asarray(x), orig, new))
    got = resample_linear(torch.from_numpy(x), orig, new).numpy()
    assert got.shape == ref.shape
    if ref.size:
        assert np.abs(got - ref).max() < 1e-4


def test_same_rate_is_identity():
    x = torch.arange(5.0)
    assert resample_poly(x, 16000, 16000) is x and resample_linear(x, 8000, 8000) is x


@pytest.fixture(scope="module")
def engine():
    pack = ModelPack(tiny_preset(), seed=0, device="cpu")
    return StageEngine(pack, BucketSpec(default_buckets(16000, 0.5, 4.0), 4))


def test_engine_resample_batch_matches_per_item(engine):
    """Bucket padding only touches samples past each item's true output
    length, which are sliced off: batch == per-item calls within 2e-6 (the
    same filter, sums in the same order, other batch shapes); items of 0
    and 1 samples pass through, as in the reference."""
    rng = np.random.default_rng(0)
    wavs = [rng.standard_normal(n).astype(np.float32) for n in (8000, 1, 12345, 0, 30011, 4001)]
    out = engine.resample_batch(wavs, 8000, 16000)
    assert [len(o) for o in out] == [16000, 1, 24690, 0, 60022, 8002]
    for w, o in zip(wavs, out):
        single = engine.resample(w, 8000, 16000)
        assert single.shape == o.shape and o.dtype == np.float32
        if o.size:
            assert np.abs(single - o).max() < 2e-6
    same = engine.resample_batch(wavs, 16000, 16000)
    assert all(np.array_equal(a, b) for a, b in zip(same, wavs))


def test_engine_resample_matches_jax_engine(engine):
    from audio_classification_tpu.engine import BucketSpec as JaxBucketSpec
    from audio_classification_tpu.engine import ModelPack as JaxModelPack
    from audio_classification_tpu.engine import StageEngine as JaxStageEngine
    from audio_classification_tpu.engine import default_buckets as jax_default_buckets
    from audio_classification_tpu.engine import tiny_preset as jax_tiny_preset

    jax_eng = JaxStageEngine(JaxModelPack(jax_tiny_preset(), seed=0),
                             JaxBucketSpec(jax_default_buckets(16000, 0.5, 4.0), 4))
    rng = np.random.default_rng(1)
    wavs = [rng.standard_normal(n).astype(np.float32) for n in (9001, 20000)]
    for a, b in zip(engine.resample_batch(wavs, 8000, 16000),
                    jax_eng.resample_batch(wavs, 8000, 16000)):
        assert a.shape == b.shape and np.abs(a - b).max() < 5e-6
