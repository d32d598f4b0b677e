"""K4's plain twin (gau_attention_reference) against the JAX package's
Pallas kernel in interpret mode and against the dense expression, and the
port's GAUBlock against the JAX GAUBlock on both of its paths (CPU, float32,
inputs made from a seed with numpy and handed to both)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audio_classification_tpu.models.mossformer import GAUBlock as JaxGAUBlock
from audio_classification_tpu.models.mossformer import MossFormerConfig as JaxMossFormerConfig
from audio_classification_tpu.ops.pallas.attention_kernel import gau_attention as jax_gau_attention
from audio_classification_tpu_torch.convert.from_jax import variables_to_state_dict
from audio_classification_tpu_torch.models.mossformer import GAUBlock, MossFormerConfig
from audio_classification_tpu_torch.ops.kernels import gau

torch.set_num_threads(2)


def _inputs(b, t, dqk, de, lens, seed):
    rng = np.random.default_rng(seed)
    q, k = (rng.standard_normal((b, t, dqk)).astype(np.float32) for _ in range(2))
    v = rng.standard_normal((b, t, de)).astype(np.float32)
    mask = np.arange(t)[None, :] < np.asarray(lens)[:, None]
    return q, k, v, mask


def _dense(q, k, v, mask, scale):
    s = np.einsum("btd,bsd->bts", q.astype(np.float64), k.astype(np.float64)) * scale
    if mask is not None:
        s = s * mask[:, None, :]
    return np.einsum("bts,bse->bte", np.maximum(s, 0.0) ** 2, v.astype(np.float64))


@pytest.mark.parametrize("b,t,dqk,de,lens", [
    (2, 128, 64, 96, (128, 87)),      # ragged mask
    (2, 300, 128, 256, (300, 259)),   # T not a multiple of the block
    (3, 70, 32, 48, (70, 0, 33)),     # Dqk != De, one fully masked item
])
def test_twin_matches_pallas_interpret_and_dense(b, t, dqk, de, lens):
    """1e-4 abs against the Pallas kernel (interpret mode, blocks of 128:
    float32 sums taken in another order, |out| up to ~10) and 1e-4 against
    the dense expression in float64; a fully masked item gives exact zeros."""
    q, k, v, mask = _inputs(b, t, dqk, de, lens, seed=t)
    scale = 1.0 / t
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    for block_q in (1024, 64):  # one block, and several ragged blocks
        got = gau.gau_attention_reference(tq, tk, tv, torch.from_numpy(mask), scale,
                                          block_q=block_q).numpy()
        ref = np.asarray(jax_gau_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                           jnp.asarray(mask), scale, block_q=128, block_k=128,
                                           interpret=True))
        assert np.abs(got - ref).max() < 1e-4
        assert np.abs(got - _dense(q, k, v, mask, scale)).max() < 1e-4
        for i, n in enumerate(lens):
            if n == 0:
                assert not got[i].any()
    # no mask at all, and the wrapper's CPU route is the twin
    got = gau.gau_attention(tq, tk, tv, None, scale).numpy()
    assert np.abs(got - _dense(q, k, v, None, scale)).max() < 1e-4


def test_wrapper_counts_no_launch_on_cpu():
    q, k, v, mask = _inputs(1, 16, 8, 12, (9,), seed=0)
    before = gau.gau_attention.launches
    gau.gau_attention(*(torch.from_numpy(a) for a in (q, k, v)), torch.from_numpy(mask), 0.1)
    assert gau.gau_attention.launches == before  # the count is of kernel launches only


@pytest.mark.parametrize("t,flash", [(160, "0"), (160, "1"), (600, "0")])
def test_gau_block_matches_jax(monkeypatch, t, flash):
    """The port's GAUBlock with carried weights against the JAX GAUBlock on
    its dense path (ACT_FLASH_ATTN=0) and its Pallas path (=1, interpret
    mode on the CPU). T = 160 takes the port's dense expression, T = 600
    (>= FLASH_MIN_T) the K4 wrapper. 2e-5 abs: float32, residual outputs of
    order 1."""
    cfg = dict(dim=64, qk_dim=32, enc_dim=48, expansion=2, layers=1)
    rng = np.random.default_rng(t)
    x = rng.standard_normal((2, t, 64)).astype(np.float32)
    mask = np.arange(t)[None, :] < np.array([t, t - 43])[:, None]
    jmod = JaxGAUBlock(JaxMossFormerConfig(**cfg))
    params = jmod.init(jax.random.PRNGKey(0), jnp.asarray(x), jnp.asarray(mask))
    leaves, tree = jax.tree_util.tree_flatten(params)
    params = jax.tree_util.tree_unflatten(
        tree, [np.asarray(l) + 0.1 * rng.standard_normal(l.shape).astype(np.float32)
               for l in leaves])  # gamma/beta off their 1/0 init
    monkeypatch.setenv("ACT_FLASH_ATTN", flash)
    ref = np.asarray(jmod.apply(params, jnp.asarray(x), jnp.asarray(mask)))
    mod = GAUBlock(MossFormerConfig(**cfg))
    mod.load_state_dict(variables_to_state_dict(params))
    with torch.no_grad():
        got = mod(torch.from_numpy(x), torch.from_numpy(mask)).numpy()
        got_nomask = mod(torch.from_numpy(x), None).numpy()
    assert np.abs(got - ref).max() < 2e-5
    ref_nomask = np.asarray(jmod.apply(params, jnp.asarray(x), None))
    assert np.abs(got_nomask - ref_nomask).max() < 2e-5
