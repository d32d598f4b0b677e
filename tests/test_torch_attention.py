"""PyTorch port vs the JAX package: K3's twin (masked attention), the MHSA
module on both sides of the flash threshold, the TransformerBlock, and the
numerics of the float32 K3 / K5 kernels (tiles, skip rule, 3xTF32 split on
the fly, accumulation order) emulated (CPU, float32)."""
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
    TF32_WIDE_KEYS,
    attention_reference,
    attention_stats_reference,
    flash_attention,
    padded_head_dim,
    tf32_keys,
    tf32_split,
)
from torch_port_helpers import _mm_tf32, _split_tf32, _tf32

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


# --- the numerics csrc/flash_attention.cu relies on, emulated on the CPU ---
#
# The float32 kernel runs both products on the tensor cores in 3xTF32 (k, v
# and q split into rounded TF32 halves, p split in registers with its small
# half left for the product to truncate), walks the keys in tiles of
# ``attention.tf32_keys(D)`` (64 at D = 64, 32 at 80 and 128), skips a tile
# whose keys are all masked when the item has a valid key elsewhere, and
# excludes keys past Tk outright. The scores gather q big x k big in one
# accumulator and the two small cross terms in another, joined once a tile;
# each tile's p v is formed from zero and merged into the running
# accumulator as alpha acc + pv with one rounding. The emulation below does
# the same in float32 PyTorch (it is no path of the package) so that the
# rules and the rounding are held to K5's twin and to the JAX kernel here.
# The tensor cores' own truncating sums are not emulated (their adds are
# IEEE here); the card's float64-twin checks guard them.

_STEP = 8  # the depth of a TF32 product step (m64nNk8)


def _scores_3xtf32(q, k):
    """q [.., T, D] k^T [.., D, keys] as the kernel forms it: both sides in
    rounded TF32 halves; per 8-deep step q big x k big into one float32 sum
    and q small x k big, q big x k small into another; the two added once."""
    qb, qs = tf32_split(q.contiguous())
    kb, ks = tf32_split(k.contiguous())
    hi = torch.zeros((*q.shape[:-1], k.shape[-1]))
    lo = torch.zeros_like(hi)
    for k0 in range(0, q.shape[-1], _STEP):
        d = slice(k0, k0 + _STEP)
        lo = lo + qs[..., d] @ kb[..., d, :]
        lo = lo + qb[..., d] @ ks[..., d, :]
        hi = hi + qb[..., d] @ kb[..., d, :]
    return hi + lo


def _pv_3xtf32(p, v):
    """p [.., T, keys] v [.., keys, D] as the kernel forms a tile's p v: p
    split in registers (big rounded, small truncated by the product), v in
    rounded halves; the three products of each 8-deep step added in turn
    into one float32 sum from zero."""
    pb, ps = _split_tf32(p, small_round=False)
    vb, vs = tf32_split(v.contiguous())
    acc = torch.zeros((*p.shape[:-1], v.shape[-1]))
    for k0 in range(0, p.shape[-1], _STEP):
        j = slice(k0, k0 + _STEP)
        acc = acc + ps[..., j] @ vb[..., j, :]
        acc = acc + pb[..., j] @ vs[..., j, :]
        acc = acc + pb[..., j] @ vb[..., j, :]
    return acc


def _merge(o, alpha, pv):
    """alpha o + pv with one rounding (fmaf): exact in float64, then
    rounded."""
    return (o.double() * alpha.double()[..., None] + pv.double()).float()


def _tile_update(o, m, l, s, bias, v_tile, plain_tf32):
    """One computed key tile: s * scale already applied; + bias, the
    running max and sum, p v of the tile merged into o."""
    s = s + bias
    m_new = torch.maximum(m, s.amax(-1))
    alpha = torch.exp(m - m_new)
    p = torch.exp(s - m_new[..., None])
    l = alpha * l + p.sum(-1)
    pv = _mm_tf32(p, v_tile) if plain_tf32 else _pv_3xtf32(p, v_tile)
    return _merge(o, alpha, pv), m_new, l


def _emulate_kernel(q, k, v, kv_mask, plain_tf32=False, skip=True):
    """(o, m, l) as the float32 body's tile loop forms them (D <= 128):
    keys padded to whole tiles whose padding scores are -inf, running max
    and sum per row, masked-whole tiles skipped iff ``skip`` and the item
    has a valid key. ``plain_tf32``: one TF32 product for each of the two
    products (what the kernel would give without the split)."""
    b, h, tq, d = q.shape
    tk = k.shape[2]
    bk = tf32_keys(padded_head_dim(d))
    n_tiles = -(-tk // bk)
    pad = n_tiles * bk - tk
    kp, vp = (torch.nn.functional.pad(z, (0, 0, 0, pad)) for z in (k, v))
    valid = torch.ones((b, tk), dtype=torch.bool) if kv_mask is None else kv_mask
    bias = torch.where(valid, 0.0, -1e9).to(torch.float32)
    bias = torch.nn.functional.pad(bias, (0, pad), value=float("-inf"))
    scale = np.float32(1.0 / np.sqrt(d))
    o = torch.zeros_like(q)
    m = torch.full((b, h, tq), -1e30)
    l = torch.zeros((b, h, tq))
    for i in range(b):
        item_skips = skip and kv_mask is not None and bool(valid[i].any())
        for j in range(n_tiles):
            keys = slice(j * bk, (j + 1) * bk)
            if item_skips and not valid[i, keys].any():
                continue
            kt = kp[i, :, keys].transpose(-1, -2)
            s = _mm_tf32(q[i], kt) if plain_tf32 else _scores_3xtf32(q[i], kt)
            o[i], m[i], l[i] = _tile_update(o[i], m[i], l[i], s * scale, bias[i, keys],
                                            vp[i, :, keys], plain_tf32)
    return o, m, l


def _holed_masks(tk, specs):
    """[B, Tk] bool masks, each the union of half-open [start, end) spans."""
    mask = np.zeros((len(specs), tk), bool)
    for i, spans in enumerate(specs):
        for lo, hi in spans:
            mask[i, lo:hi] = True
    return mask


_EMULATION_CASES = {
    # self-attention, T off the tile: item 0's first two tiles masked whole,
    # then a partly masked tile, a hole of two whole tiles and a ragged end;
    # item 1 a plain ragged length
    "b2_t537_holes": (2, 537, 537, [[(140, 320), (448, 500)], [(0, 263)]], 64),
    # a shard's 537 queries against 1068 keys (16 tiles + 44): a valid run
    # after three masked tiles and a hole of three, a short prefix, and an
    # item with no valid key at all
    "b3_tq537_tk1068_holes": (3, 537, 1068, [[(200, 512), (704, 1068)], [(0, 300)], []], 64),
    # Paraformer's head dim (32-key tiles): a hole of masked-whole tiles, a
    # ragged end, and Tq != Tk
    "b2_tq533_tk600_d80": (2, 533, 600, [[(0, 40), (130, 533)], [(0, 300)]], 80),
}


@pytest.mark.parametrize("case", sorted(_EMULATION_CASES))
def test_kernel_numerics_emulation_matches_twin_and_pallas(case, record_property):
    """The float32 kernel's tiling, skip rule, split on the fly and 3xTF32
    rounding with its accumulation order, emulated: o, m, l
    within K5's tolerances of its twin (o 1e-4 of max|o|, m and l 1e-5
    relative); o / l within K3's 2e-5 of the JAX kernel (interpret mode) on
    the items with a valid key; skipping the masked-whole tiles changes no
    bit; the item with no valid key keeps m = -1e9 and l = Tk. The error of
    one plain TF32 product is recorded, not asserted (ten times K3's
    tolerance, which is why the kernel splits)."""
    b, tq, tk, spans, d = _EMULATION_CASES[case]
    h = 8
    rng = np.random.default_rng(tq + tk)
    q = rng.standard_normal((b, h, tq, d)).astype(np.float32)
    k, v = (rng.standard_normal((b, h, tk, d)).astype(np.float32) for _ in range(2))
    mask = _holed_masks(tk, spans)
    tq_, tk_, tv_, tm_ = (torch.from_numpy(a) for a in (q, k, v, mask))

    o, m, l = _emulate_kernel(tq_, tk_, tv_, tm_)
    ro, rm, rl = attention_stats_reference(tq_, tk_, tv_, tm_)
    assert (o - ro).abs().max().item() <= 1e-4 * ro.abs().max().item()
    assert ((m - rm).abs() <= 1e-5 * rm.abs().clamp_min(1.0)).all()
    assert ((l - rl).abs() <= 1e-5 * rl.abs()).all()

    # skipping is exact, not merely close
    o_all, m_all, l_all = _emulate_kernel(tq_, tk_, tv_, tm_, skip=False)
    for got, want in ((o, o_all), (m, m_all), (l, l_all)):
        assert torch.equal(got, want)

    has_key = mask.any(axis=1)
    assert (m[~torch.from_numpy(has_key)] == -1e9).all()
    assert (l[~torch.from_numpy(has_key)] == tk).all()

    ref = np.asarray(jax_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                               jnp.asarray(mask), block_q=256, block_k=256, interpret=True))
    out = (o / l[..., None]).numpy()
    assert out.shape == ref.shape
    assert np.abs(out - ref)[has_key].max() < 2e-5

    o1, _, l1 = _emulate_kernel(tq_, tk_, tv_, tm_, plain_tf32=True)
    err_tf32 = np.abs((o1 / l1[..., None]).numpy() - ref)[has_key].max()
    record_property("one_tf32_product_max_abs_err", float(err_tf32))
    record_property("three_tf32_products_max_abs_err",
                    float(np.abs(out - ref)[has_key].max()))


def test_tf32_round_is_to_nearest_ties_away():
    """The bit-level round of the emulation: 13 low bits cleared, ties away
    from zero on either sign, carries into the exponent."""
    ulp = 2.0 ** -10
    x = torch.tensor([1.0 + ulp / 2, -(1.0 + ulp / 2), 1.0 + ulp / 2 - 2.0 ** -23,
                      2.0 - ulp / 2, 3.0], dtype=torch.float32)
    want = torch.tensor([1.0 + ulp, -(1.0 + ulp), 1.0, 2.0, 3.0], dtype=torch.float32)
    assert torch.equal(_tf32(x), want)
    assert ((_tf32(x).view(torch.int32) & 0x1FFF) == 0).all()


_UNIT = 64  # dims of a wide body's unit of the scores


def _emulate_wide_kernel(q, k, v, kv_mask):
    """(o, m, l) as the wide body (D above 128) forms them: D zero-padded to
    a multiple of 64, keys in tiles of ``attention.TF32_WIDE_KEYS``; each
    tile's q big x k big formed unit by unit (64 dims) from zero and added
    to the tile's scores in float32, the small cross terms of every unit in
    one sum added last; then the tile's softmax update and p v as in the
    other body; masked-whole tiles skipped where the item has a valid key.
    The output's column slices share these scores, so they are one
    computation here."""
    b, h, tq, d = q.shape
    dp = -(-d // _UNIT) * _UNIT
    q, k, v = (torch.nn.functional.pad(z, (0, dp - d)) for z in (q, k, v))
    tk = k.shape[2]
    bk = TF32_WIDE_KEYS
    n_tiles = -(-tk // bk)
    pad = n_tiles * bk - tk
    kp, vp = (torch.nn.functional.pad(z, (0, 0, 0, pad)) for z in (k, v))
    valid = torch.ones((b, tk), dtype=torch.bool) if kv_mask is None else kv_mask
    bias = torch.where(valid, 0.0, -1e9).to(torch.float32)
    bias = torch.nn.functional.pad(bias, (0, pad), value=float("-inf"))
    scale = np.float32(1.0 / np.sqrt(d))
    qb, qs = tf32_split(q)
    o = torch.zeros_like(q)
    m = torch.full((b, h, tq), -1e30)
    l = torch.zeros((b, h, tq))
    for i in range(b):
        item_skips = kv_mask is not None and bool(valid[i].any())
        for j in range(n_tiles):
            keys = slice(j * bk, (j + 1) * bk)
            if item_skips and not valid[i, keys].any():
                continue
            kb, ks = tf32_split(kp[i, :, keys].transpose(-1, -2).contiguous())
            s = torch.zeros((h, tq, bk))
            lo = torch.zeros((h, tq, bk))
            for u in range(0, dp, _UNIT):
                hi = torch.zeros((h, tq, bk))
                for k0 in range(u, u + _UNIT, _STEP):
                    dd = slice(k0, k0 + _STEP)
                    lo = lo + qs[i, :, :, dd] @ kb[:, dd]
                    lo = lo + qb[i, :, :, dd] @ ks[:, dd]
                    hi = hi + qb[i, :, :, dd] @ kb[:, dd]
                s = s + hi
            o[i], m[i], l[i] = _tile_update(o[i], m[i], l[i], (s + lo) * scale,
                                            bias[i, keys], vp[i, :, keys], False)
    return o[..., :d], m, l


@pytest.mark.parametrize("d", [136, 192, 200, 256])
def test_wide_head_dims_match_jax_kernels(d):
    """Head dims above 128 (the wide body; 136 and 200 zero-padded to 192 and
    256): the twins with the wrapper's padding rule and the true-D scale,
    and the wide body's unit-by-unit numerics emulated, against the JAX
    kernels in interpret mode (which pad D to their lane width), on a
    ragged batch with a hole of masked-whole tiles. K3 2e-5 abs on the
    items' valid rows, K5's o 1e-4 of max|o| and m, l 1e-5 relative (the
    kernel's tolerances); the twins 1e-5 (the rule's own test)."""
    from audio_classification_tpu.ops.pallas.attention_kernel import (
        flash_attention_stats as jax_flash_stats,
    )
    from audio_classification_tpu_torch.ops.kernels.attention import pad_head_dim

    b, h, t = 2, 2, 200
    rng = np.random.default_rng(d)
    q, k, v = (rng.standard_normal((b, h, t, d)).astype(np.float32) for _ in range(3))
    mask = _holed_masks(t, [[(0, 40), (130, 200)], [(0, 97)]])
    tq_, tk_, tv_, tm_ = (torch.from_numpy(a) for a in (q, k, v, mask))
    jq, jk, jv, jm = (jnp.asarray(a) for a in (q, k, v, mask))
    ref = np.asarray(jax_flash(jq, jk, jv, jm, block_q=128, block_k=128, interpret=True))
    ro, rm, rl = (np.asarray(x) for x in jax_flash_stats(jq, jk, jv, jm, block_q=128,
                                                         block_k=128, interpret=True))
    scale = 1.0 / np.sqrt(d)
    qp, kp, vp = pad_head_dim(tq_, tk_, tv_)
    assert qp.shape[-1] == -(-d // _UNIT) * _UNIT
    out = attention_reference(qp, kp, vp, tm_, scale=scale)[..., :d].numpy()
    assert np.abs(out - ref).max() < 1e-5
    o, m, l = attention_stats_reference(qp, kp, vp, tm_, scale=scale)
    assert np.abs(o[..., :d].numpy() - ro).max() <= 1e-5 * np.abs(ro).max()
    np.testing.assert_allclose(m.numpy(), rm, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(l.numpy(), rl, rtol=1e-5)

    eo, em, el = _emulate_wide_kernel(tq_, tk_, tv_, tm_)
    valid_rows = mask.any(axis=1)[:, None, None, None]
    assert np.abs(((eo / el[..., None]).numpy() - ref) * valid_rows).max() < 2e-5
    assert np.abs(eo.numpy() - ro).max() <= 1e-4 * np.abs(ro).max()
    np.testing.assert_allclose(em.numpy(), rm, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(el.numpy(), rl, rtol=1e-5)
