"""PyTorch port vs the JAX package: long-form transcription. The SenseVoice
encoder with ``mesh=`` (ring attention over n shards of one device) against
the JAX encoder on its virtual CPU mesh and against the port's dense encoder;
``StageEngine.transcribe_long`` with and without a mesh, float and int8, and
the facade ``ASRRecognizer.transcribe(long_form=True)``, against the JAX
engine on the same tiny weights (CPU).

Texts are compared exactly. A random tiny recognizer turns a ~1e-6 difference
into another token only where two logits nearly tie, so the wavs come from a
fixed seed without such a tie (as tests/test_torch_mvp.py fixes its seed), and
the encoder tests hold the logits themselves to a tolerance. The wavs are
bursts of tones, noise and silence: on steady audio the random recognizer
decodes to the empty text, which would compare nothing.
"""
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audio_classification_tpu.engine import BucketSpec as JaxBucketSpec
from audio_classification_tpu.engine import StageEngine as JaxStageEngine
from audio_classification_tpu.engine.runtime import tiny_preset as jax_tiny_preset
from audio_classification_tpu.models import facades as jax_facades
from audio_classification_tpu.models.asr.sensevoice import SenseVoiceEncoder as JaxSenseVoice
from audio_classification_tpu.parallel.mesh import make_mesh as jax_make_mesh
from audio_classification_tpu_torch.convert.from_jax import variables_to_state_dict
from audio_classification_tpu_torch.engine import BucketSpec, StageEngine, tiny_preset
from audio_classification_tpu_torch.models import common, facades
from audio_classification_tpu_torch.models.asr.sensevoice import SenseVoiceEncoder
from audio_classification_tpu_torch.parallel.mesh import make_mesh
from torch_port_helpers import SR, _tone, shared_engines

torch.set_num_threads(2)
LENGTHS = (4000, 8000, 16000)


def cpu_mesh(n):
    return make_mesh(n, devices=["cpu"] * n)


@pytest.fixture(scope="module")
def encoders():
    """The JAX tiny SenseVoice encoder with perturbed weights and the port's
    on the same weights."""
    cfg = jax_tiny_preset().asr
    jm = JaxSenseVoice(cfg)
    lfr_dim = cfg.lfr_m * cfg.num_mel
    rng = np.random.default_rng(6)
    variables = jax.tree.map(
        lambda a: np.asarray(a) + 0.05 * rng.standard_normal(np.shape(a)).astype(np.float32),
        jax.device_get(jm.init(jax.random.PRNGKey(2), jnp.zeros((1, 10, lfr_dim)),
                               jnp.ones((1, 10), bool))))
    pm = SenseVoiceEncoder(tiny_preset().asr).eval()
    pm.load_state_dict(variables_to_state_dict(variables))
    return jm, variables, pm, lfr_dim


@pytest.mark.parametrize("n,t", [(2, 23), (4, 26), (8, 24), (8, 16), (2, 1050)])
def test_sensevoice_with_mesh_matches_jax_and_dense(encoders, n, t):
    """4 prompt frames + t is no multiple of n in the four short cases: the
    encoder pads once on entry. Against the JAX encoder on n virtual devices
    and against the port's dense encoder, atol 1e-4 + rtol 1e-4 as
    tests/test_sp_encoder.py. The last case has 527 frames a shard and runs
    K5's twin, the short ones the dense block."""
    jm, variables, pm, lfr_dim = encoders
    rng = np.random.default_rng(t)
    feats = rng.standard_normal((2, t, lfr_dim)).astype(np.float32)
    mask = np.arange(t)[None, :] < np.array([[t], [t - 6]])
    with torch.no_grad():
        dense = pm(torch.from_numpy(feats), torch.from_numpy(mask), language_id=1).numpy()
        out = pm(torch.from_numpy(feats), torch.from_numpy(mask), language_id=1,
                 mesh=cpu_mesh(n), sp_axis="data").numpy()
    jmesh = jax_make_mesh(n, model_axis=1)
    ref = np.asarray(jax.jit(lambda p, f, m: jm.apply(p, f, m, language_id=1, mesh=jmesh,
                                                      sp_axis="data"))(
        variables, jnp.asarray(feats), jnp.asarray(mask)))
    assert out.shape == ref.shape == dense.shape
    np.testing.assert_allclose(out, ref, atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(out, dense, atol=1e-4, rtol=1e-4)


def test_sensevoice_with_mesh_takes_no_mask(encoders):
    _jm, _v, pm, lfr_dim = encoders
    feats = torch.from_numpy(
        np.random.default_rng(0).standard_normal((1, 21, lfr_dim)).astype(np.float32))
    with torch.no_grad():
        torch.testing.assert_close(pm(feats, None, mesh=cpu_mesh(4)), pm(feats, None),
                                   atol=1e-4, rtol=1e-4)


def test_attention_under_a_mesh_pads_to_the_shard_count():
    """MultiHeadSelfAttention called directly with T = 13 over 4 shards pads
    q, k, v and the mask itself and slices the pad off."""
    torch.manual_seed(0)
    att = common.MultiHeadSelfAttention(16, 2).eval()
    x = torch.randn(2, 13, 16)
    mask = torch.arange(13)[None, :] < torch.tensor([13, 7])[:, None]
    with torch.no_grad():
        out, dense = att(x, mask, cpu_mesh(4)), att(x, mask)
        torch.testing.assert_close(out, dense, atol=2e-5, rtol=0)
        torch.testing.assert_close(att(x, None, cpu_mesh(4)), att(x, None), atol=2e-5, rtol=0)


def _engines(quant, n=8):
    jax_eng, eng = shared_engines(quant)
    single = StageEngine(eng.pack, BucketSpec(LENGTHS, 8))
    sharded = StageEngine(eng.pack, BucketSpec(LENGTHS, 8), mesh=cpu_mesh(n))
    jspec = JaxBucketSpec(lengths=LENGTHS, max_batch=8)
    jsingle = JaxStageEngine(jax_eng.pack, jspec)
    jsharded = JaxStageEngine(jax_eng.pack, jspec, mesh=jax_make_mesh(n, model_axis=1))
    return single, sharded, jsingle, jsharded


@pytest.fixture(scope="module")
def float_engines():
    return _engines("none")


@pytest.fixture(scope="module")
def int8_engines():
    return _engines("int8")


def _bursts(n, seed=2, seg=1600):
    """0.1 s pieces of silence, a tone, noise or two tones, drawn from a seed."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n // seg + 1):
        kind = rng.integers(4)
        if kind == 0:
            out.append(np.zeros(seg, np.float32))
        elif kind == 1:
            out.append(_tone(seg / SR, rng.uniform(100, 4000), rng.uniform(0.05, 0.9)))
        elif kind == 2:
            out.append((rng.uniform(0.01, 0.8) * rng.standard_normal(seg)).astype(np.float32))
        else:
            out.append(_tone(seg / SR, rng.uniform(3000, 7000), 0.9)
                       + _tone(seg / SR, rng.uniform(50, 300), 0.5))
    return np.concatenate(out)[:n]


def _long_wavs():
    """Inside the largest bucket, the same bucket again, and past the largest
    bucket (48000 samples -> the long grid's 64000)."""
    return {"in-bucket": _bursts(15000), "same-bucket": _bursts(13000),
            "long-grid": _bursts(48000)}


@pytest.mark.parametrize("which", ["in-bucket", "same-bucket", "long-grid"])
def test_transcribe_long_matches_jax(float_engines, which):
    """With a mesh of 8 and without one: the texts of the JAX engine, and of
    ``transcribe([wav])[0]`` on the same engine; no ad-hoc-bucket warning on
    the long path."""
    single, sharded, jsingle, jsharded = float_engines
    wav = _long_wavs()[which]
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # the segment path's ad-hoc bucket
        segment = single.transcribe([wav])[0]
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        got_single, got_sharded = single.transcribe_long(wav), sharded.transcribe_long(wav)
    assert got_single == jsingle.transcribe_long(wav)
    assert got_sharded == jsharded.transcribe_long(wav)
    assert got_single == got_sharded == segment
    assert len(segment) >= 4


@pytest.mark.parametrize("n", [2, 4])
def test_transcribe_long_other_shard_counts(float_engines, n):
    single = float_engines[0]
    wav = _long_wavs()["long-grid"]
    eng = StageEngine(single.pack, BucketSpec(LENGTHS, 8), mesh=cpu_mesh(n))
    assert eng.transcribe_long(wav, language="en", use_itn=False) == single.transcribe_long(
        wav, language="en", use_itn=False)


def test_transcribe_long_int8_pack(int8_engines, monkeypatch):
    """An int8 pack keeps its int8 projections without a mesh and runs float
    projections under one (a per-sample activation scale would span the
    shards); both as the JAX engine does."""
    single, sharded, jsingle, jsharded = int8_engines
    wav = _long_wavs()["in-bucket"]
    calls = []
    orig = common.int8_matmul
    monkeypatch.setattr(common, "int8_matmul", lambda *a, **k: (calls.append(1), orig(*a, **k))[1])
    got_sharded = sharded.transcribe_long(wav)
    assert not calls
    got_single = single.transcribe_long(wav)
    layers = single.pack.asr_cfg.layers
    assert len(calls) == 4 * layers  # qkv, out, Dense_0, Dense_1 per block
    assert got_single == jsingle.transcribe_long(wav) == single.transcribe([wav])[0]
    assert got_sharded == jsharded.transcribe_long(wav)


def test_long_form_facade_and_engine_mesh(float_engines):
    single, sharded, _jsingle, jsharded = float_engines
    wav = _long_wavs()["in-bucket"]
    wav8 = wav[::2].copy()  # an 8 kHz utterance: the facade resamples first
    for w, sr in ((wav, SR), (wav8, 8000)):
        ref = jax_facades.ASRRecognizer(jsharded).transcribe(w, sr, long_form=True)
        assert facades.ASRRecognizer(sharded).transcribe(w, sr, long_form=True) == ref
        assert facades.ASRRecognizer(single).transcribe(w, sr, long_form=True) == ref
    assert single.mesh is None and sharded.mesh.shape["data"] == 8
    assert StageEngine.LONG_FORM_FAMILIES == ("sensevoice", "paraformer")
    assert StageEngine.LONG_FORM_SINGLE_CHIP == (
        "sensevoice", "paraformer", "transducer", "whisper")
    # a mesh of another device type than the pack's is refused
    with pytest.raises(ValueError, match="the mesh lives on"):
        StageEngine(single.pack, mesh=make_mesh(2, devices=["cuda", "cuda"]))
