"""PyTorch port vs the JAX package: K3's twin (masked attention), the MHSA
module on both sides of the flash threshold, and the TransformerBlock
(CPU, float32)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audio_classification_tpu.models.common import TransformerBlock as JaxBlock
from audio_classification_tpu.ops.pallas.attention_kernel import flash_attention as jax_flash
from audio_classification_tpu_torch.convert.from_jax import variables_to_state_dict
from audio_classification_tpu_torch.models.common import TransformerBlock
from audio_classification_tpu_torch.ops.kernels.attention import (
    FLASH_MIN_T,
    attention_reference,
    flash_attention,
)

torch.set_num_threads(2)


def _qkv(b, h, t, d, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((b, h, t, d)).astype(np.float32) for _ in range(3)]


def test_attention_twin_matches_pallas_kernel():
    """T=300 (not a block multiple), ragged key mask: 1e-5 abs on valid
    query rows (float32 softmax over <= 300 keys, O(1) outputs); padded
    rows are discarded downstream and not compared."""
    b, h, t, d = 2, 2, 300, 64
    q, k, v = _qkv(b, h, t, d, 0)
    mask = np.arange(t)[None, :] < np.array([t, 263])[:, None]
    ref = np.asarray(jax_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                               jnp.asarray(mask), block_q=128, block_k=128, interpret=True))
    out = flash_attention(*(torch.from_numpy(a) for a in (q, k, v)),
                          torch.from_numpy(mask)).numpy()
    assert out.shape == ref.shape
    valid = mask[:, None, :, None]
    assert np.abs((out - ref) * valid).max() < 1e-5


def test_attention_wrapper_on_cpu_is_the_twin():
    q, k, v = (torch.from_numpy(a) for a in _qkv(1, 2, 40, 64, 1))
    before = flash_attention.launches
    torch.testing.assert_close(flash_attention(q, k, v), attention_reference(q, k, v),
                               rtol=0, atol=0)
    assert flash_attention.launches == before


@pytest.mark.parametrize("t", [37, FLASH_MIN_T + 3])
def test_transformer_block_matches_jax(t):
    """Pre-LN block (MHSA + depthwise conv + GELU FFN) with converted
    weights; T >= FLASH_MIN_T routes the port's attention through K3's
    wrapper (its twin on CPU) against the JAX dense einsum path. 1e-4
    relative to max|out|."""
    dim, heads, conv = 128, 2, 5
    jm = JaxBlock(dim, heads, conv_kernel=conv)
    rng = np.random.default_rng(t)
    x = rng.standard_normal((2, t, dim)).astype(np.float32)
    mask = np.arange(t)[None, :] < np.array([t, t - 11])[:, None]
    variables = jm.init(jax.random.PRNGKey(0), jnp.asarray(x[:, :8]), jnp.asarray(mask[:, :8]))
    variables = jax.tree.map(
        lambda a: np.asarray(a) + 0.05 * rng.standard_normal(np.shape(a)).astype(np.float32),
        jax.device_get(variables))
    ref = np.asarray(jm.apply(variables, jnp.asarray(x), jnp.asarray(mask)))
    pm = TransformerBlock(dim, heads, conv_kernel=conv).eval()
    pm.load_state_dict(variables_to_state_dict(variables))
    with torch.no_grad():
        out = pm(torch.from_numpy(x), torch.from_numpy(mask)).numpy()
    assert np.abs(out - ref).max() / np.abs(ref).max() < 1e-4
