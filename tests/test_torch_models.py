"""PyTorch port vs the JAX package, per model (CPU, float32).

Each model is initialised in flax, every parameter and BatchNorm statistic
is perturbed with seeded noise (so a wrong layout, transpose or name in
convert/from_jax.py cannot hide behind ones/zeros), the weights are
converted with ``params_to_state_dicts`` and loaded strictly into the port,
and both run on the same numpy inputs. On the CPU the port's kernels run
their plain twins, so these tests hold the twins and the surrounding
PyTorch code to the JAX reference.

Tolerance: 1e-4 relative to the output's max magnitude, unless a test says
otherwise — float32 end to end with a different summation order
(XLA vs ATen) through a few layers.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audio_classification_tpu.engine.runtime import tiny_preset as jax_tiny_preset
from audio_classification_tpu.models.asr.ctc import ctc_greedy_decode as jax_ctc
from audio_classification_tpu.models.asr.sensevoice import SenseVoiceEncoder as JaxSenseVoice
from audio_classification_tpu.models.osd import OSDNet as JaxOSD
from audio_classification_tpu.models.speaker import SpeakerEmbedder as JaxSpeaker
from audio_classification_tpu_torch.convert.from_jax import params_to_state_dicts
from audio_classification_tpu_torch.engine.runtime import ModelPack, tiny_preset
from audio_classification_tpu_torch.models.asr.ctc import ctc_greedy_decode
from audio_classification_tpu_torch.models.asr.sensevoice import SenseVoiceEncoder
from audio_classification_tpu_torch.models.common import same_padding
from audio_classification_tpu_torch.models.osd import OSDNet
from audio_classification_tpu_torch.models.speaker import SpeakerEmbedder

torch.set_num_threads(2)
RTOL = 1e-4


def perturbed(variables, seed):
    """Flax variables with every leaf moved by seeded noise (variances kept
    positive)."""
    rng = np.random.default_rng(seed)

    def move(path, leaf):
        a = np.asarray(leaf, np.float32)
        noise = rng.standard_normal(a.shape).astype(np.float32)
        if getattr(path[-1], "key", None) == "var":
            return a + 0.5 * np.abs(noise)
        return a + 0.05 * noise

    return jax.tree_util.tree_map_with_path(move, jax.device_get(variables))


def port_module(cls, cfg, variables, stage):
    m = cls(cfg).eval()
    m.load_state_dict(params_to_state_dicts({stage: variables})[stage])
    return m


def rel_err(a, b, valid=None):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    if valid is not None:
        a, b = a * valid, b * valid
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-12)


def lengths_mask(lengths, t):
    return np.arange(t)[None, :] < np.asarray(lengths)[:, None]


@pytest.mark.parametrize("t", [50, 2047])  # T=2047 -> 512 model frames: flash path
def test_osdnet_matches_jax(t):
    cfg = jax_tiny_preset().osd
    jm = JaxOSD(cfg)
    rng = np.random.default_rng(1)
    feats = rng.standard_normal((2, t, 80)).astype(np.float32)
    mask = lengths_mask([t, t - 13], t)
    v = perturbed(jm.init(jax.random.PRNGKey(0), jnp.zeros((1, 50, 80)),
                          jnp.ones((1, 50), bool)), 2)
    ref = np.asarray(jm.apply(v, jnp.asarray(feats), jnp.asarray(mask)))
    pm = port_module(OSDNet, tiny_preset().osd, v, "osd")
    with torch.no_grad():
        out = pm(torch.from_numpy(feats), torch.from_numpy(mask)).numpy()
    assert out.shape == ref.shape
    assert rel_err(out, ref) < RTOL


def test_speaker_embedder_matches_jax():
    cfg = jax_tiny_preset().spk
    jm = JaxSpeaker(cfg)
    rng = np.random.default_rng(3)
    feats = rng.standard_normal((2, 61, 80)).astype(np.float32)
    mask = lengths_mask([61, 40], 61)
    v = perturbed(jm.init(jax.random.PRNGKey(1), jnp.zeros((1, 50, 80)),
                          jnp.ones((1, 50), bool)), 4)
    ref = np.asarray(jm.apply(v, jnp.asarray(feats), jnp.asarray(mask)))
    pm = port_module(SpeakerEmbedder, tiny_preset().spk, v, "spk")
    with torch.no_grad():
        out = pm(torch.from_numpy(feats), torch.from_numpy(mask)).numpy()
    assert out.shape == ref.shape
    assert rel_err(out, ref) < RTOL


@pytest.mark.parametrize("t", [40, 520])  # 520 + 4 prompt frames: flash path
def test_sensevoice_and_ctc_match_jax(t):
    cfg = jax_tiny_preset().asr
    jm = JaxSenseVoice(cfg)
    rng = np.random.default_rng(5)
    lfr_dim = cfg.lfr_m * cfg.num_mel
    feats = rng.standard_normal((2, t, lfr_dim)).astype(np.float32)
    mask = lengths_mask([t, t - 9], t)
    v = perturbed(jm.init(jax.random.PRNGKey(2), jnp.zeros((1, 10, lfr_dim)),
                          jnp.ones((1, 10), bool)), 6)
    ref = np.asarray(jm.apply(v, jnp.asarray(feats), jnp.asarray(mask), language_id=2,
                              use_itn=False))
    pm = port_module(SenseVoiceEncoder, tiny_preset().asr, v, "asr")
    with torch.no_grad():
        out = pm(torch.from_numpy(feats), torch.from_numpy(mask), language_id=2,
                 use_itn=False).numpy()
    assert out.shape == ref.shape
    assert rel_err(out, ref) < RTOL
    # greedy CTC over the same body logits: ids and lengths exact
    body = ref[:, cfg.num_prompt:]
    ids_j, n_j = jax_ctc(jnp.asarray(body), jnp.asarray(mask, jnp.float32))
    ids_p, n_p = ctc_greedy_decode(torch.from_numpy(out[:, cfg.num_prompt:]),
                                   torch.from_numpy(mask))
    np.testing.assert_array_equal(n_p.numpy(), np.asarray(n_j))
    for b in range(2):
        np.testing.assert_array_equal(ids_p.numpy()[b, : n_p[b]], np.asarray(ids_j)[b, : n_j[b]])


def test_ctc_greedy_decode_collapse_and_pack():
    # frames: a a _ a b b _ (pad) -> "a a b" packed left; pad frame ignored
    v = 4
    seq = [1, 1, 0, 1, 2, 2, 0, 3]
    logits = np.full((1, len(seq), v), -5.0, np.float32)
    logits[0, np.arange(len(seq)), seq] = 5.0
    mask = np.array([[1, 1, 1, 1, 1, 1, 1, 0]], bool)
    ids, n = ctc_greedy_decode(torch.from_numpy(logits), torch.from_numpy(mask))
    assert int(n[0]) == 3
    assert ids[0, :3].tolist() == [1, 1, 2]
    assert ids[0, 3:].eq(0).all()


@pytest.mark.parametrize("t,want", [(3198, (1, 2)), (1599, (2, 2)), (10, (1, 2))])
def test_same_padding_stride2_is_asymmetric(t, want):
    # XLA "SAME" for OSDNet's k=5, s=2 subsampling convs
    assert same_padding(t, 5, 2) == want


def test_from_jax_round_trip_every_stage():
    """Every leaf of every stage's flax tree lands in the port's state_dict
    (strict load: nothing missing, nothing extra) with the documented
    layout change, and reads back unchanged."""
    from audio_classification_tpu.models.convtasnet import ConvTasNet as JaxTasNet

    jp = jax_tiny_preset()
    feats0 = jnp.zeros((1, 50, 80))
    lfr_dim = jp.asr.lfr_m * jp.asr.num_mel
    trees = {
        "osd": JaxOSD(jp.osd).init(jax.random.PRNGKey(0), feats0, jnp.ones((1, 50), bool)),
        "sep3": JaxTasNet(jp.sep3).init(jax.random.PRNGKey(1), jnp.zeros((1, 800)),
                                        jnp.ones((1, 800))),
        "spk": JaxSpeaker(jp.spk).init(jax.random.PRNGKey(2), feats0, jnp.ones((1, 50), bool)),
        "asr": JaxSenseVoice(jp.asr).init(jax.random.PRNGKey(3), jnp.zeros((1, 10, lfr_dim)),
                                          jnp.ones((1, 10), bool)),
    }
    trees = {k: perturbed(v, i) for i, (k, v) in enumerate(trees.items())}
    pack = ModelPack(tiny_preset(), seed=0, device="cpu")
    sds = params_to_state_dicts(trees)
    pack.load_state_dicts(sds)  # strict
    for stage, tree in trees.items():
        live = pack.models[stage].state_dict()
        for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
            keys = [p.key for p in path]
            col, *mods, name = keys
            a = np.asarray(leaf)
            if col == "batch_stats":
                key = ".".join(mods + [{"mean": "running_mean", "var": "running_var"}[name]])
            elif name == "kernel":
                key = ".".join(mods + ["weight"])
                a = np.transpose(a, {2: (1, 0), 3: (2, 1, 0), 4: (3, 2, 0, 1)}[a.ndim])
            elif name == "scale":
                key = ".".join(mods + ["weight"])
            else:
                key = ".".join(mods + [name])
            np.testing.assert_array_equal(live[key].numpy(), a, err_msg=f"{stage}:{key}")
