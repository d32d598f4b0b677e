"""PyTorch port vs the JAX package: K5's twin (the streaming softmax without
its division) against the Pallas kernel in interpret mode, ring attention over
n shards of one device against the JAX ring on its virtual CPU mesh and
against the dense oracle, the sequence-parallel transformer block, and the
port's mesh object (CPU, float32)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audio_classification_tpu.ops.pallas.attention_kernel import (
    flash_attention_stats as jax_flash_stats,
)
from audio_classification_tpu.parallel.mesh import make_mesh as jax_make_mesh
from audio_classification_tpu.parallel.ring_attention import ring_attention as jax_ring
from audio_classification_tpu.parallel.sp_encoder import SPTransformerBlock as JaxSPBlock
from audio_classification_tpu_torch.convert.from_jax import variables_to_state_dict
from audio_classification_tpu_torch.ops.kernels.attention import (
    FLASH_MIN_T,
    attention_reference,
    attention_stats_reference,
    flash_attention_stats,
)
from audio_classification_tpu_torch.parallel import ring_attention as ring_mod
from audio_classification_tpu_torch.parallel.mesh import make_mesh
from audio_classification_tpu_torch.parallel.ring_attention import (
    reference_attention,
    ring_attention,
)
from audio_classification_tpu_torch.parallel.sp_encoder import (
    SPTransformerBlock,
    sp_seq_shard,
    sp_seq_unshard,
)

torch.set_num_threads(2)


def cpu_mesh(n, model_axis=1):
    return make_mesh(n, model_axis=model_axis, devices=["cpu"] * n)


def _rand(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


@pytest.mark.parametrize("tq,tk,d", [(300, 300, 64), (150, 260, 16), (260, 150, 64)])
def test_stats_twin_matches_pallas_kernel(tq, tk, d):
    """[2, 4, T, 16|64] with a ragged key mask, Tq != Tk, T off the 128
    blocks: (o, m, l) within 2e-5 abs (l relative) of the Pallas kernel in
    interpret mode. Both items keep a valid key in every compared row's
    block (the kernel counts its own padded keys in l of a block masked
    whole, the twin does not have them)."""
    b, h = 2, 4
    q, k, v = _rand((b, h, tq, d), 0), _rand((b, h, tk, d), 1), _rand((b, h, tk, d), 2)
    mask = np.arange(tk)[None, :] < np.array([tk, tk - 37])[:, None]
    ro, rm, rl = (np.asarray(a) for a in jax_flash_stats(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(mask),
        block_q=128, block_k=128, interpret=True))
    o, m, l = (a.numpy() for a in flash_attention_stats(
        *(torch.from_numpy(a) for a in (q, k, v)), torch.from_numpy(mask)))
    assert o.shape == ro.shape == (b, h, tq, d) and m.shape == rm.shape == l.shape == (b, h, tq)
    assert np.abs(o - ro).max() < 2e-5 * max(1.0, np.abs(ro).max())
    assert np.abs(m - rm).max() < 2e-5
    assert np.abs(l / rl - 1).max() < 2e-5
    # normalised, it is K3's twin
    qt, kt, vt = (torch.from_numpy(a) for a in (q, k, v))
    ref = attention_reference(qt, kt, vt, torch.from_numpy(mask)).numpy()
    assert np.abs(o / l[..., None] - ref).max() < 2e-5


def test_stats_wrapper_on_cpu_is_the_twin_and_masks_like_the_kernel():
    """On a CPU tensor the wrapper is the twin and counts no launch. A key
    block masked whole gives m = -1e9 and l = Tk (K5's bias convention)."""
    q, k, v = (torch.from_numpy(_rand((2, 2, 40, 64), i)) for i in range(3))
    mask = torch.arange(40)[None, :] < torch.tensor([40, 0])[:, None]
    before = flash_attention_stats.launches
    got = flash_attention_stats(q, k, v, mask)
    for a, r in zip(got, attention_stats_reference(q, k, v, mask)):
        torch.testing.assert_close(a, r, rtol=0, atol=0)
    assert flash_attention_stats.launches == before
    assert (got[1][1] == -1e9).all() and (got[2][1] == 40).all()


@pytest.mark.parametrize("masked", [False, True], ids=["unmasked", "masked"])
@pytest.mark.parametrize("ts", [8, FLASH_MIN_T + 8], ids=["dense-block", "k5-twin"])
@pytest.mark.parametrize("n", [1, 2, 4, 8])
def test_ring_attention_matches_jax_ring_and_reference(n, ts, masked):
    """n shards of ``ts`` frames, below the K5 threshold (the dense block)
    and above it (K5's twin), against the JAX ring on n virtual devices and
    both packages' dense oracles; the mask leaves item 0 a third of its keys,
    so whole shards are empty. 2e-5 abs, as tests/test_ring_attention.py."""
    b, h, d = 2, 2, 16
    t = n * ts
    q, k, v = (_rand((b, t, h, d), 10 * n + i) for i in range(3))
    mask = np.stack([np.arange(t) < max(t // 3, 1), np.ones(t, bool)]) if masked else None
    calls = []
    orig = ring_mod.flash_attention_stats
    ring_mod.flash_attention_stats = lambda *a: (calls.append(1), orig(*a))[1]
    try:
        out = ring_attention(*(torch.from_numpy(a) for a in (q, k, v)), cpu_mesh(n),
                             kv_mask=None if mask is None else torch.from_numpy(mask)).numpy()
    finally:
        ring_mod.flash_attention_stats = orig
    assert len(calls) == (n * n if ts >= FLASH_MIN_T else 0)
    ref = reference_attention(*(torch.from_numpy(a) for a in (q, k, v)),
                              None if mask is None else torch.from_numpy(mask)).numpy()
    jref = np.asarray(jax_ring(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                               jax_make_mesh(n, model_axis=1),
                               kv_mask=None if mask is None else jnp.asarray(mask)))
    assert out.shape == (b, t, h, d)
    assert np.abs(out - ref).max() < 2e-5
    assert np.abs(out - jref).max() < 2e-5


def test_ring_attention_against_jax_ring_through_its_pallas_kernel(monkeypatch):
    """Both rings on their K5: the JAX shard body forced through
    flash_attention_stats (interpret mode), the port's through the twin;
    2 shards of 520 frames, item 1 keeps 400 keys (shard 1 is empty). 2e-5."""
    b, t, h, d = 2, 2 * (FLASH_MIN_T + 8), 2, 16
    q, k, v = (_rand((b, t, h, d), 90 + i) for i in range(3))
    mask = np.arange(t)[None, :] < np.array([t, 400])[:, None]
    monkeypatch.setenv("ACT_FLASH_ATTN", "1")
    jref = np.asarray(jax_ring(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                               jax_make_mesh(2, model_axis=1), kv_mask=jnp.asarray(mask)))
    out = ring_attention(*(torch.from_numpy(a) for a in (q, k, v)), cpu_mesh(2),
                         kv_mask=torch.from_numpy(mask)).numpy()
    assert np.abs((out - jref) * mask[:, :, None, None]).max() < 2e-5


def test_ring_attention_ignores_masked_keys_and_checks_its_shapes():
    t = 64
    q, k, v = (torch.from_numpy(_rand((2, t, 2, 8), 20 + i)) for i in range(3))
    mask = torch.stack([torch.arange(t) < 40, torch.ones(t, dtype=torch.bool)])
    mesh = cpu_mesh(8)
    out = ring_attention(q, k, v, mesh, kv_mask=mask)
    v2 = v.clone()
    v2[0, 40:] = 999.0
    out2 = ring_attention(q, k, v2, mesh, kv_mask=mask)
    assert (out2[0] - out[0]).abs().max() < 2e-5
    with pytest.raises(ValueError, match="must divide"):
        ring_attention(q[:, :60], k[:, :60], v[:, :60], mesh)
    # the data axis of a (2, 2) mesh has 2 shards
    torch.testing.assert_close(ring_attention(q, k, v, cpu_mesh(4, model_axis=2)),
                               reference_attention(q, k, v), rtol=0, atol=2e-5)


@pytest.mark.parametrize("n", [None, 4, 8], ids=["dense", "ring4", "ring8"])
def test_sp_transformer_block_matches_jax(n):
    """SPTransformerBlock with converted weights (qkv, out, LayerNorm_0/1,
    Dense_0/1) against the JAX block, dense and ring; 5e-5 abs, as
    tests/test_sp_encoder.py."""
    dim, heads, t = 32, 4, 64
    jm = JaxSPBlock(dim=dim, heads=heads)
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, t, dim)).astype(np.float32)
    variables = jax.tree.map(
        lambda a: np.asarray(a) + 0.05 * rng.standard_normal(np.shape(a)).astype(np.float32),
        jax.device_get(jm.init(jax.random.PRNGKey(0), jnp.asarray(x))))
    jmesh = None if n is None else jax_make_mesh(n, model_axis=1)
    ref = np.asarray(jm.apply(variables, jnp.asarray(x), mesh=jmesh))
    pm = SPTransformerBlock(dim, heads).eval()
    pm.load_state_dict(variables_to_state_dict(variables))
    with torch.no_grad():
        out = pm(torch.from_numpy(x), None if n is None else cpu_mesh(n)).numpy()
    assert np.abs(out - ref).max() < 5e-5


def test_sp_seq_shard_pads_with_masked_frames():
    x = torch.from_numpy(_rand((2, 13, 4), 5))
    mask = torch.arange(13)[None, :] < torch.tensor([13, 9])[:, None]
    xs, ms, orig = sp_seq_shard(x, mask, cpu_mesh(4))
    assert xs.shape == (2, 16, 4) and ms.shape == (2, 16) and orig == 13
    assert not xs[:, 13:].any() and not ms[:, 13:].any() and torch.equal(ms[:, :13], mask)
    assert torch.equal(sp_seq_unshard(xs, cpu_mesh(4), orig), x)
    xs, ms, orig = sp_seq_shard(x[:, :12], None, cpu_mesh(4))
    assert xs.shape == (2, 12, 4) and ms.all() and ms.dtype == torch.bool


def test_mesh_shapes_and_what_it_refuses():
    m = cpu_mesh(8, model_axis=2)
    assert m.shape == {"data": 4, "model": 2} and m.device == torch.device("cpu")
    assert make_mesh(3, devices=["cpu"] * 8).shape == {"data": 3, "model": 1}
    with pytest.raises(ValueError, match="must divide"):
        cpu_mesh(8, model_axis=3)
    # several distinct devices in one process: a mesh over several cards is
    # one rank per card under torchrun, and the message says so
    for devs in (["cuda:0", "cuda:1"], ["cpu", "cuda:0"]):
        with pytest.raises(ValueError, match="torchrun --nproc-per-node"):
            make_mesh(2, devices=devs)
    assert make_mesh(2, devices=["cuda", "cuda:0"]).shape["data"] == 2  # one card named twice
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make_mesh(4)  # the card is the default; the CPU is asked for
