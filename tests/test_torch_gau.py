"""K4's plain twin (gau_attention_reference) against the JAX package's
Pallas kernel in interpret mode and against the dense expression, the
port's GAUBlock against the JAX GAUBlock on both of its paths, and the
numerics of the K4 kernel (key tiles, 3xTF32, skip rule)
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
from audio_classification_tpu_torch.ops.kernels.tcn import tf32_split
from torch_port_helpers import _mm_tf32, _split_tf32

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
# The kernel runs both products on warpgroup products in 3xTF32: the A
# operands (q, p) split in registers (big rounded, small left for the
# product to truncate), the B operands (k, and v transposed) split into two
# rounded halves by the split launch. Per 32-key tile, s = q k^T adds the
# three products of each 8-deep step (small x big, big x small, big x big)
# into one float32 accumulator over all of Dqk; p = relu(s * scale *
# mask)^2; each tile's p v is formed from zero the same way and added to
# the running sum in float32; a key tile whose keys are all masked is
# skipped. Rows and output columns are independent (the kernel's 128-row
# blocks and 192-column chunks form identical scores). The emulation below
# does the same in float32 PyTorch (it is no path of the package), so that
# the tiling and the rounding are held to the twin and to the JAX kernel
# here.

_GAU_KEYS, _GAU_STEP = 32, 8


def _wgmma_3xtf32(a, b):
    """a @ b as the kernel's products form it: a split in registers, b in
    two rounded halves (tcn.tf32_split), the three products of each 8-deep
    step added in turn into one float32 accumulator from zero. The
    accumulator's own rounding is not emulated: these adds are IEEE
    float32, while wgmma's sum of TF32 products rounds more coarsely (one
    accumulator over 31999 keys was 2.5e-4 of max|out| off the float64 twin
    on the card, which is why the kernel sums a tile at a time). The guard
    for that rounding is the card's float64-twin check (chip_smoke.py
    ``check_gau``, 1e-4 of max|out|)."""
    a_big, a_small = _split_tf32(a, small_round=False)
    b_big, b_small = tf32_split(b.contiguous())
    acc = torch.zeros((a.shape[0], b.shape[1]))
    for k0 in range(0, a.shape[1], _GAU_STEP):
        k = slice(k0, k0 + _GAU_STEP)
        acc = acc + a_small[:, k] @ b_big[k]
        acc = acc + a_big[:, k] @ b_small[k]
        acc = acc + a_big[:, k] @ b_big[k]
    return acc


def _emulate_gau_kernel(q, k, v, kv_mask, scale, plain_tf32=False, skip=True):
    """out as the kernel forms it: 32-key tiles (keys past T zero-filled,
    masked-whole tiles skipped iff ``skip``), the scores and each tile's
    p v in 3xTF32 (``_wgmma_3xtf32``; ``plain_tf32``: one TF32 product
    each), each tile's p v added to the running sum in float32."""
    mm = (lambda a, b: _mm_tf32(a, b)) if plain_tf32 else _wgmma_3xtf32
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
            s = mm(q[i], kp[i, keys].T)
            p = torch.relu(s * scale * mk[i, keys]) ** 2
            out[i] += mm(p, vp[i, keys])
    return out


def _holed_mask(t, specs):
    """[B, T] bool masks, each the union of half-open [start, end) spans."""
    mask = np.zeros((len(specs), t), bool)
    for i, spans in enumerate(specs):
        for lo, hi in spans:
            mask[i, lo:hi] = True
    return mask


_GAU_EMULATION_CASES = {
    # rows off the 128-row block, keys off the 32-key tile; item 0: two tiles
    # masked whole before a partly masked one, then a hole of two whole
    # tiles and a ragged end; item 1 a plain ragged length
    "b2_t203_dqk128_de96_holes": (2, 203, 128, 96, [[(70, 110), (170, 190)], [(0, 131)]]),
    # De over three 192-column chunks, the last ragged; Dqk % 8 == 4; a single
    # valid key at each end of item 0, item 1 with no valid key at all
    "b2_t77_dqk12_de400_ends": (2, 77, 12, 400, [[(0, 1), (76, 77)], []]),
}


@pytest.mark.parametrize("case", sorted(_GAU_EMULATION_CASES))
def test_kernel_numerics_emulation_matches_twin_and_pallas(case, record_property):
    """The kernel's key tiles, skip rule and 3xTF32 rounding,
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
    """The splits K4 uses: its A operands (q, p) split in registers, big
    rounded to TF32 and small = x - big exact in float32, truncated by the
    product (big + small recovers x within 2^-21 of |x|); its B operands (k,
    v) split by the split launch into two rounded halves (``tf32_split``:
    within 2^-22)."""
    x = torch.from_numpy(np.random.default_rng(3).standard_normal(4096).astype(np.float32))
    for halves, bound in ((_split_tf32(x, small_round=False), 2.0 ** -21),
                          (tf32_split(x), 2.0 ** -22)):
        big, small = halves
        assert ((big.view(torch.int32) & 0x1FFF) == 0).all()
        assert ((small.view(torch.int32) & 0x1FFF) == 0).all()
        err = ((big.double() + small.double()) - x.double()).abs()
        assert (err <= bound * x.double().abs()).all()
