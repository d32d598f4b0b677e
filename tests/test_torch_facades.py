"""The port's model facades and factories take the JAX package's parameters
in the JAX package's order (models/facades.py), so that a caller of one
calls the other the same way: ``inspect.signature`` compares equal on
names, order and kinds. Defaults of ``device`` / ``provider`` differ by
design ("cuda" where the JAX package says "tpu")."""
import inspect

import numpy as np
import pytest

from audio_classification_tpu.engine import BucketSpec as JaxBucketSpec
from audio_classification_tpu.engine import ModelPack as JaxModelPack
from audio_classification_tpu.engine import StageEngine as JaxStageEngine
from audio_classification_tpu.engine import tiny_preset as jax_tiny_preset
from audio_classification_tpu.models import facades as jax_facades
from audio_classification_tpu_torch.convert.from_jax import params_to_state_dicts
from audio_classification_tpu_torch.engine import BucketSpec, ModelPack, StageEngine, tiny_preset
from audio_classification_tpu_torch.models import facades

DEVICE_PARAMS = ("device", "provider")


def _params(obj):
    return [(p.name, p.kind, None if p.name in DEVICE_PARAMS else p.default)
            for p in inspect.signature(obj).parameters.values()]


@pytest.mark.parametrize("name", ["OverlapAnalyzer", "Separator", "create_extractor_model",
                                  "SpeakerExtractor", "ASRRecognizer", "create_asr_model"])
def test_facade_signatures_match_jax(name):
    assert _params(getattr(facades, name)) == _params(getattr(jax_facades, name))


@pytest.mark.parametrize("name", ["OverlapAnalyzer", "Separator", "create_extractor_model",
                                  "create_asr_model"])
def test_device_defaults_to_the_card(name):
    params = inspect.signature(getattr(facades, name)).parameters
    (dev,) = [p for n, p in params.items() if n in DEVICE_PARAMS]
    assert dev.default == "cuda"


@pytest.fixture(scope="module")
def engines():
    jax_pack = JaxModelPack(jax_tiny_preset(), seed=0)
    pack = ModelPack(tiny_preset(), seed=1, device="cpu")
    pack.load_state_dicts(params_to_state_dicts({k: jax_pack.params[k] for k in ModelPack.STAGES}))
    lengths = (8000, 16000)
    return (JaxStageEngine(jax_pack, JaxBucketSpec(lengths, 2)),
            StageEngine(pack, BucketSpec(lengths, 2)))


def test_positional_construction_puts_the_device_in_device(engines):
    """``Separator("convtasnet", "cuda")`` and ``OverlapAnalyzer(0.5, 0.5,
    0.1, "cuda")`` fill ``device``, as in the JAX package, and leave
    ``sample_rate`` / ``backend`` at their defaults."""
    _, eng = engines
    sep = facades.Separator("convtasnet", "cuda", engine=eng)
    assert (sep.backend, sep.device, sep.sample_rate, sep.n_src) == ("convtasnet", "cuda",
                                                                      16000, 2)
    ana = facades.OverlapAnalyzer(0.4, 0.5, 0.1, "cuda", engine=eng)
    assert (ana.threshold, ana.device, ana.backend, ana.auth_token) == (0.4, "cuda", "osdnet",
                                                                       None)
    assert facades.OverlapAnalyzer(device="cuda", auth_token="hf_x", engine=eng).auth_token == \
        "hf_x"


@pytest.mark.parametrize("make", [
    lambda: facades.OverlapAnalyzer(device="cpu"),
    lambda: facades.Separator(device="cpu"),
    lambda: facades.create_extractor_model(provider="cpu"),
])
def test_device_picks_the_default_engines_device(monkeypatch, make):
    """A facade given no engine builds the default one on its device
    string."""
    seen = []
    monkeypatch.setattr(facades, "default_engine",
                        lambda *a, device=None, **k: seen.append(device) or object())
    make()
    assert seen == ["cpu"]


def test_create_extractor_model_matches_jax(engines):
    """The factory returns the embedder handle bound to the engine: the same
    embedding as the JAX factory's on shared weights (float32 path)."""
    jax_eng, eng = engines
    x = (np.random.default_rng(3).standard_normal(12000) * 0.1).astype(np.float32)
    got = facades.create_extractor_model(model="spk.onnx", engine=eng)
    ref = jax_facades.create_extractor_model(model="spk.onnx", engine=jax_eng)
    assert isinstance(got, facades.SpeakerExtractor) and got.dim == ref.dim
    np.testing.assert_allclose(got.compute(x, 16000), ref.compute(x, 16000), atol=1e-5)
