"""The port's MossFormer and ChannelLayerNorm against the JAX package with
weights carried by convert/from_jax.py (tiny preset, CPU, float32), and the
converter's key sets for the two separators this slice adds."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audio_classification_tpu.engine import tiny_preset as jax_tiny_preset
from audio_classification_tpu.models.common import ChannelLayerNorm as JaxChannelLayerNorm
from audio_classification_tpu.models.convtasnet import ConvTasNet as JaxConvTasNet
from audio_classification_tpu.models.mossformer import MossFormer as JaxMossFormer
from audio_classification_tpu_torch.convert.from_jax import (
    params_to_state_dicts,
    variables_to_state_dict,
)
from audio_classification_tpu_torch.engine import ModelPack, tiny_preset
from audio_classification_tpu_torch.engine.runtime import seeded_init_
from audio_classification_tpu_torch.models.common import ChannelLayerNorm
from audio_classification_tpu_torch.models.mossformer import MossFormer

torch.set_num_threads(2)


def _perturbed(params, rng):
    leaves, tree = jax.tree_util.tree_flatten(params)
    return jax.tree_util.tree_unflatten(
        tree, [np.asarray(l) + 0.1 * rng.standard_normal(l.shape).astype(np.float32)
               for l in leaves])


# T below enc_kernel (16), T not a stride multiple below and above the K4
# threshold of 512 frames (4700 samples -> 586 frames)
@pytest.mark.parametrize("t", [5, 1003, 4700])
@pytest.mark.parametrize("masked", [True, False])
def test_mossformer_matches_jax(t, masked):
    """2e-5 abs on outputs of order 1: float32 through 2 GAU layers, the
    decoder as a transposed conv instead of a scatter-add."""
    rng = np.random.default_rng(t)
    x = (0.1 * rng.standard_normal((2, t))).astype(np.float32)
    sm = (np.arange(t)[None, :] < np.array([t, max(2 * t // 3, 1)])[:, None]).astype(np.float32)
    jcfg = jax_tiny_preset().mossformer
    jmod = JaxMossFormer(jcfg)
    params = _perturbed(jmod.init(jax.random.PRNGKey(0), jnp.asarray(x), jnp.asarray(sm)), rng)
    mod = MossFormer(tiny_preset().mossformer).eval()
    mod.load_state_dict(variables_to_state_dict(params))
    jm = jnp.asarray(sm) if masked else None
    tm = torch.from_numpy(sm) if masked else None
    ref = np.asarray(jmod.apply(params, jnp.asarray(x), jm))
    with torch.no_grad():
        got = mod(torch.from_numpy(x), tm).numpy()
    assert got.shape == ref.shape == (2, jcfg.n_src, t)
    assert np.abs(got - ref).max() < 2e-5


def test_channel_layer_norm_matches_jax():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 9, 24)).astype(np.float32) * 3 + 1
    jmod = JaxChannelLayerNorm(24)
    params = _perturbed(jmod.init(jax.random.PRNGKey(0), jnp.asarray(x)), rng)
    mod = ChannelLayerNorm(24)
    mod.load_state_dict(variables_to_state_dict(params))
    assert mod.eps == jmod.eps == 1e-8
    with torch.no_grad():
        got = mod(torch.from_numpy(x)).numpy()
    assert np.abs(got - np.asarray(jmod.apply(params, jnp.asarray(x)))).max() < 1e-5


def test_converter_key_sets_for_sep2_and_mossformer():
    """Every leaf of the JAX sep2 and mossformer trees lands on a state_dict
    key of the port's module and nothing is missing (strict load); the GAU's
    [2, qk_dim] gamma/beta keep name and layout."""
    jp = jax_tiny_preset()
    x0, m0 = jnp.zeros((1, 800)), jnp.ones((1, 800))
    trees = {"sep2": JaxConvTasNet(jp.sep2).init(jax.random.PRNGKey(1), x0, m0),
             "mossformer": JaxMossFormer(jp.mossformer).init(jax.random.PRNGKey(2), x0, m0)}
    rng = np.random.default_rng(3)
    trees = {k: _perturbed(v, rng) for k, v in trees.items()}
    pack = ModelPack(tiny_preset(), seed=0, device="cpu")
    sds = params_to_state_dicts(trees)
    for stage in ("sep2", "mossformer"):
        assert set(sds[stage]) == set(pack.models[stage].state_dict())
    pack.load_state_dicts(sds)
    gamma = np.asarray(trees["mossformer"]["params"]["gau_0"]["gamma"])
    assert gamma.shape == (2, jp.mossformer.qk_dim)
    np.testing.assert_array_equal(pack.models["mossformer"].gau_0.gamma.detach().numpy(), gamma)


def test_seeded_init_keeps_earlier_stages_and_gau_gamma_ones():
    """The stages added after the flagship four draw their weights last, so a
    seed gives osd/sep3/spk/asr the weights it gave before they existed; the
    GAU's 2-D gamma starts at ones and beta at zeros, as in the reference."""
    pack = ModelPack(tiny_preset(), seed=5, device="cpu")
    assert ModelPack.STAGES[:4] == ("osd", "sep3", "spk", "asr")
    gen = torch.Generator().manual_seed(5)
    for stage in ModelPack.STAGES[:4]:
        fresh = seeded_init_(type(pack.models[stage])(pack.models[stage].cfg), gen)
        for (name, a), (_n, b) in zip(fresh.state_dict().items(),
                                      pack.models[stage].state_dict().items()):
            assert torch.equal(a, b), (stage, name)
    g = pack.models["mossformer"].gau_1
    assert torch.equal(g.gamma, torch.ones_like(g.gamma))
    assert torch.equal(g.beta, torch.zeros_like(g.beta))
    assert g.to_qk.weight.std() > 0
