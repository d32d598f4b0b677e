"""K4's plain twin (gau_attention_reference) against the JAX package's
Pallas kernel in interpret mode and against the dense expression, the
port's GAUBlock against the JAX GAUBlock on both of its paths, and the
numerics of the K4 kernel (tiles, column chunks, 3xTF32, skip rule)
emulated (CPU, float32, inputs made from a seed with numpy and handed to
both)."""
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
from torch_port_helpers import _mm_3xtf32, _mm_tf32, _split_tf32

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


# --- the numerics csrc/gau_attention.cu relies on, emulated on the CPU ---
#
# The kernel runs both products on the tensor cores in 3xTF32 (big halves
# rounded, small halves left for the mma to truncate), forms the scores of
# 64 query rows x 32 keys once for all columns (a cluster of two blocks,
# one 384-wide chunk of the output columns each) and shares them as p split
# into big and small, adds each key tile's p v to the accumulator in
# float32, and skips a key tile whose keys are all masked. The emulation below does the same in float32
# PyTorch (it is no path of the package), so that the tiling and the
# rounding are held to the twin and to the JAX kernel here.

_GAU_ROWS, _GAU_KEYS, _GAU_COLS = 64, 32, 384


def _gau_scores(q, k, plain_tf32=False):
    """q k^T as the kernel forms it: dims 0-63 and 64-127 apart, and in each
    half big x big and the two small cross terms apart, then summed."""
    if plain_tf32:
        return _mm_tf32(q, k.T)
    qb, qs = _split_tf32(q, small_round=False)
    kb, ks = _split_tf32(k, small_round=False)
    halves = [slice(0, 64), slice(64, None)]
    big = [qb[:, h] @ kb[:, h].T for h in halves]
    cross = [qs[:, h] @ kb[:, h].T + qb[:, h] @ ks[:, h].T for h in halves]
    return (big[0] + big[1]) + (cross[0] + cross[1])


def _emulate_gau_kernel(q, k, v, kv_mask, scale, plain_tf32=False, skip=True):
    """out as the kernel's blocks form it: 64-row blocks, 32-key tiles (keys
    past T zero-filled, masked-whole tiles skipped iff ``skip``), p formed and
    split once a tile for all 384-column chunks, each tile's p v added to the
    running sum in float32."""
    b, t, _ = q.shape
    de = v.shape[-1]
    n_tiles = -(-t // _GAU_KEYS)
    pad = n_tiles * _GAU_KEYS - t
    kp, vp = (torch.nn.functional.pad(z, (0, 0, 0, pad)) for z in (k, v))
    valid = torch.ones((b, t), dtype=torch.bool) if kv_mask is None else kv_mask
    mk = torch.nn.functional.pad(valid.to(torch.float32), (0, pad))
    out = torch.zeros((b, t, de))
    for i in range(b):
        for j in range(n_tiles):
            keys = slice(j * _GAU_KEYS, (j + 1) * _GAU_KEYS)
            if skip and not mk[i, keys].any():
                continue
            for r0 in range(0, t, _GAU_ROWS):
                rows = slice(r0, r0 + _GAU_ROWS)
                s = _gau_scores(q[i, rows], kp[i, keys], plain_tf32)
                p = torch.relu(s * scale * mk[i, keys]) ** 2
                for c0 in range(0, de, _GAU_COLS):
                    cols = slice(c0, c0 + _GAU_COLS)
                    vt = vp[i, keys, cols]
                    pv = _mm_tf32(p, vt) if plain_tf32 else _mm_3xtf32(p, vt, small_round=False)
                    out[i, rows, cols] += pv
    return out


def _holed_mask(t, specs):
    """[B, T] bool masks, each the union of half-open [start, end) spans."""
    mask = np.zeros((len(specs), t), bool)
    for i, spans in enumerate(specs):
        for lo, hi in spans:
            mask[i, lo:hi] = True
    return mask


_GAU_EMULATION_CASES = {
    # rows off the 64-row block, keys off the 32-key tile; item 0: two tiles
    # masked whole before a partly masked one, then a hole of two whole
    # tiles and a ragged end; item 1 a plain ragged length
    "b2_t203_dqk128_de96_holes": (2, 203, 128, 96, [[(70, 110), (170, 190)], [(0, 131)]]),
    # De over two column chunks, the second ragged; Dqk % 8 == 4; a single
    # valid key at each end of item 0, item 1 with no valid key at all
    "b2_t77_dqk12_de400_ends": (2, 77, 12, 400, [[(0, 1), (76, 77)], []]),
}


@pytest.mark.parametrize("case", sorted(_GAU_EMULATION_CASES))
def test_kernel_numerics_emulation_matches_twin_and_pallas(case, record_property):
    """The kernel's tiling, column chunks, skip rule and 3xTF32 rounding,
    emulated: within K4's 1e-4 of max|out| of the twin and of the JAX kernel
    (interpret mode), with q and k as drawn and x3; skipping the
    masked-whole tiles changes no bit; the item with no valid key gives
    exact zeros. relu^2 is homogeneous, so q and k x4 would scale out by
    4^4, a power of two, and repeat the first case bit for bit: x3 rounds
    otherwise. The error of one plain TF32 product is recorded, not
    asserted (4-5e-4 of max|out|, four times the tolerance, which is why
    the kernel splits)."""
    b, t, dqk, de, spans = _GAU_EMULATION_CASES[case]
    rng = np.random.default_rng(t + de)
    q, k = (rng.standard_normal((b, t, dqk)).astype(np.float32) for _ in range(2))
    v = rng.standard_normal((b, t, de)).astype(np.float32)
    mask = _holed_mask(t, spans)
    tm = torch.from_numpy(mask)
    for amp in (1.0, 3.0):
        qa, ka = q * amp, k * amp
        scale = 4.0 / (t * np.sqrt(dqk))
        tq, tk, tv = (torch.from_numpy(a) for a in (qa, ka, v))
        got = _emulate_gau_kernel(tq, tk, tv, tm, scale)
        twin = gau.gau_attention_reference(tq, tk, tv, tm, scale)
        peak = twin.abs().max().item()
        assert (got - twin).abs().max().item() <= 1e-4 * peak
        ref = np.asarray(jax_gau_attention(jnp.asarray(qa), jnp.asarray(ka), jnp.asarray(v),
                                           jnp.asarray(mask), scale, block_q=128, block_k=128,
                                           interpret=True))
        assert np.abs(got.numpy() - ref).max() <= 1e-4 * peak
        assert torch.equal(got, _emulate_gau_kernel(tq, tk, tv, tm, scale, skip=False))
        for i in np.flatnonzero(~mask.any(axis=1)):
            assert not got[i].any()
        dense = _dense(qa, ka, v, mask, scale)
        record_property(f"three_tf32_products_rel_err_x{amp:g}",
                        float(np.abs(got.numpy() - dense).max() / np.abs(dense).max()))
        one = _emulate_gau_kernel(tq, tk, tv, tm, scale, plain_tf32=True).numpy()
        record_property(f"one_tf32_product_rel_err_x{amp:g}",
                        float(np.abs(one - dense).max() / np.abs(dense).max()))


def test_tf32_halves_of_the_kernel_split():
    """The split K4 uses: big rounded to TF32, small = x - big exact in
    float32 and truncated by the mma; big + small recovers x within 2^-21 of
    |x| (rounding small too: 2^-22)."""
    x = torch.from_numpy(np.random.default_rng(3).standard_normal(4096).astype(np.float32))
    for small_round, bound in ((False, 2.0 ** -21), (True, 2.0 ** -22)):
        big, small = _split_tf32(x, small_round)
        assert ((big.view(torch.int32) & 0x1FFF) == 0).all()
        assert ((small.view(torch.int32) & 0x1FFF) == 0).all()
        err = ((big.double() + small.double()) - x.double()).abs()
        assert (err <= bound * x.double().abs()).all()
