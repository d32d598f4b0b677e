"""PyTorch port vs the JAX package: K2's twin (the Conv-TasNet masker) and
the whole ConvTasNet (CPU, float32).

K2's twin is held to the Pallas kernel in interpret mode and to the JAX
reference loop on the same stacked weights, at C = H = 128 with 2 x 4
blocks, a ragged f_len and F not a multiple of the kernel's tile. Tolerance:
1e-4 x max|skips| on valid frames — float32, summation order differs over
the 128- and 512-wide contractions and the gLN reductions over F x H.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audio_classification_tpu.engine.runtime import tiny_preset as jax_tiny_preset
from audio_classification_tpu.models.convtasnet import ConvTasNet as JaxTasNet
from audio_classification_tpu.ops.pallas.tcn_kernel import (
    fused_tcn_masker as jax_fused_tcn_masker,
    stack_tcn_params as jax_stack_tcn_params,
    tcn_masker_reference as jax_tcn_reference,
)
from audio_classification_tpu_torch.convert.from_jax import params_to_state_dicts
from audio_classification_tpu_torch.engine.runtime import tiny_preset
from audio_classification_tpu_torch.models.convtasnet import ConvTasNet
from audio_classification_tpu_torch.ops.kernels.tcn import (
    BF16_TILES,
    dequant_stack,
    fused_tcn_masker,
    stack_tcn_params,
    tcn_masker_reference,
    tf32_plan,
    tf32_split,
)
from torch_port_helpers import _mm_tf32, _split_tf32

torch.set_num_threads(2)
NB_PER, NREP, C, H = 4, 2, 128, 128
TOL = 1e-4


def _blocks(rng):
    def mk():
        return {
            "in_conv": {"kernel": rng.normal(size=(1, C, H)).astype(np.float32) * 0.1,
                        "bias": rng.normal(size=(H,)).astype(np.float32) * 0.1},
            "prelu1": {"alpha": np.array([0.25], np.float32)},
            "norm1": {"gamma": rng.normal(size=(H,)).astype(np.float32) * 0.5 + 1.0,
                      "beta": rng.normal(size=(H,)).astype(np.float32) * 0.1},
            "dw_conv": {"kernel": rng.normal(size=(3, 1, H)).astype(np.float32) * 0.3,
                        "bias": rng.normal(size=(H,)).astype(np.float32) * 0.1},
            "prelu2": {"alpha": np.array([0.3], np.float32)},
            "norm2": {"gamma": rng.normal(size=(H,)).astype(np.float32) * 0.5 + 1.0,
                      "beta": rng.normal(size=(H,)).astype(np.float32) * 0.1},
            "res_conv": {"kernel": rng.normal(size=(1, H, C)).astype(np.float32) * 0.1,
                         "bias": rng.normal(size=(C,)).astype(np.float32) * 0.1},
            "skip_conv": {"kernel": rng.normal(size=(1, H, C)).astype(np.float32) * 0.1,
                          "bias": rng.normal(size=(C,)).astype(np.float32) * 0.1},
        }

    return [mk() for _ in range(NB_PER * NREP)]


@pytest.fixture(scope="module")
def masker_case():
    rng = np.random.default_rng(0)
    blocks = _blocks(rng)
    st = jax_stack_tcn_params([jax.tree.map(jnp.asarray, b) for b in blocks], jnp.float32)
    x = rng.normal(size=(2, 150, C)).astype(np.float32)  # 150: not a multiple of tile=64
    f_len = np.array([150, 97], np.int32)
    st_np = {k: np.array(v) for k, v in st.items()}
    out = tcn_masker_reference(torch.from_numpy(x), torch.from_numpy(f_len),
                               {k: torch.from_numpy(v) for k, v in st_np.items()},
                               n_per_repeat=NB_PER).numpy()
    return blocks, st, x, f_len, out


def _valid_err(out, ref, f_len):
    valid = (np.arange(out.shape[1])[None, :] < f_len[:, None])[..., None]
    return np.abs((out - ref) * valid).max() / np.abs(ref * valid).max()


def test_tcn_twin_matches_pallas_kernel(masker_case):
    _, st, x, f_len, out = masker_case
    ref = np.asarray(jax_fused_tcn_masker(jnp.asarray(x), jnp.asarray(f_len), st,
                                          n_per_repeat=NB_PER, tile=64, interpret=True))
    assert out.shape == ref.shape
    assert _valid_err(out, ref, f_len) < TOL


def test_tcn_twin_matches_jax_reference_loop(masker_case):
    _, st, x, f_len, out = masker_case
    ref = np.asarray(jax_tcn_reference(jnp.asarray(x), jnp.asarray(f_len), st,
                                       n_per_repeat=NB_PER))
    assert _valid_err(out, ref, f_len) < TOL


def test_tcn_wrapper_on_cpu_runs_twin_and_counts_no_launch(masker_case):
    """The wrapper's contract on the CPU, for a float and an int8 stack:
    valid rows are the twin's bit for bit, rows past f_len exactly 0 (the
    kernel computes none of them), and no launch is counted."""
    blocks, st, x, f_len, _ = masker_case
    st8 = jax_stack_tcn_params([jax.tree.map(jnp.asarray, b) for b in blocks], jnp.float32,
                               weight_quant=True)
    valid = np.arange(x.shape[1])[None, :] < f_len[:, None]
    assert not valid.all()
    for stack in (st, st8):
        tst = {k: torch.from_numpy(np.array(v)) for k, v in stack.items()}
        twin = tcn_masker_reference(torch.from_numpy(x), torch.from_numpy(f_len), tst,
                                    n_per_repeat=NB_PER).numpy()
        before = (fused_tcn_masker.launches, fused_tcn_masker.launches_s8)
        got = fused_tcn_masker(torch.from_numpy(x), torch.from_numpy(f_len), tst,
                               n_per_repeat=NB_PER).numpy()
        np.testing.assert_array_equal(got[valid], twin[valid])
        assert not got[~valid].any()
        assert (fused_tcn_masker.launches, fused_tcn_masker.launches_s8) == before


def test_tcn_wrapper_rejects_int8_stack(masker_case):
    """The int8 weight stream is taken only whole: int8 weights without their
    scale rows (vecs [NB, 10, H], cvecs [NB, 4, C]), one weight left float, or
    a scale row of another width are rejected, on the CPU too."""
    blocks, _, x, f_len, _ = masker_case
    st8 = jax_stack_tcn_params([jax.tree.map(jnp.asarray, b) for b in blocks], jnp.float32,
                               weight_quant=True)
    st8 = {k: torch.from_numpy(np.array(v)) for k, v in st8.items()}
    args = (torch.from_numpy(x), torch.from_numpy(f_len))
    assert fused_tcn_masker(*args, st8, n_per_repeat=NB_PER).shape == x.shape
    for name, bad in (("vecs", st8["vecs"][:, :8].contiguous()),
                      ("cvecs", st8["cvecs"][:, :2].contiguous()),
                      ("w_dw", st8["w_dw"].float()),
                      ("vecs", st8["vecs"][:, :, :-1].contiguous())):
        with pytest.raises(ValueError, match=name):
            fused_tcn_masker(*args, {**st8, name: bad}, n_per_repeat=NB_PER)


# --- the kernel's algorithm (csrc/tcn_masker.cu), emulated on the CPU ---
# GEMM tiles as tcn.tf32_plan picks them on a card of 132 SMs; depthwise
# chunks of 128 rows x 64 channels (two consumer warpgroups' worth of
# threads); a TF32 wgmma's contraction step
_SMS, _DW_ROWS, _K_STEP = 132, 128, 8


def _chan(a, b):
    """Chan's parallel merge of (count, mean, m2) partials, in float64."""
    (na, ma, qa), (nb, mb, qb) = a, b
    if nb == 0.0:
        return a
    n = na + nb
    d = mb - ma
    return n, ma + d * (nb / n), qa + qb + d * d * (na * nb / n)


def _warp_tree(lanes):
    """A warp's shuffle-down tree (offsets 16 .. 1): lane 0's result."""
    for o in (16, 8, 4, 2, 1):
        lanes = [_chan(lanes[i], lanes[i + o] if i + o < 32 else lanes[i]) for i in range(32)]
    return lanes[0]


def _stats(total):
    n, mean, m2 = total
    return np.float32(mean), np.float32(1.0 / np.sqrt(m2 / max(n, 1.0) + 1e-8))


def _merge_launch(parts, nwg, batch):
    """A launch's last CTA merges an item's partials in this order
    (merge_stats): its 4 nwg consumer warps in groups of max(1, 4 nwg /
    batch), a group an item; thread i of the group takes slots i, i + 32
    per, ...; each warp's shuffle-down tree; the group's warps by a tree in
    its first warp."""
    per = max(1, 4 * nwg // batch)
    lanes = [(0.0, 0.0, 0.0)] * (32 * per)
    for i, p in enumerate(parts):
        lanes[i % (32 * per)] = _chan(lanes[i % (32 * per)], p)
    warps = [_warp_tree(lanes[32 * w: 32 * w + 32]) for w in range(per)]
    return _stats(_warp_tree(warps + [(0.0, 0.0, 0.0)] * (32 - per)))


def _tile_partial(v):
    """One tile's partial: count, mean and m2 about it, two passes in float32."""
    mu = v.sum() / np.float32(v.numel())
    return float(v.numel()), float(mu), float(((v - mu) ** 2).sum())


def _mm_kernel(a, b):
    """a @ b as a GEMM's warpgroup products form it: a split in registers
    (big rounded, small left for the product to truncate: tf32_mma.cuh
    ``split_fast``), b from the split copy (both halves rounded:
    ``tcn.tf32_split``), and per k8 step the three products (a small x b
    big, a big x b small, a big x b big) added in turn into one float32
    accumulator over the whole contraction. The accumulator's own rounding
    is not emulated: these adds are IEEE float32, while wgmma's sum of TF32
    products rounds more coarsely (on the card 5.8e-6 of max|skips| off the
    float64 twin at the flagship shape, against 6.4e-7 for k-chunks formed
    from zero and added in IEEE float32). The guard for that rounding is
    the card's float64-twin check (chip_smoke.py ``check_tcn``, 1e-4)."""
    a_big, a_small = _split_tf32(a, small_round=False)
    b_big, b_small = tf32_split(b.contiguous())
    acc = torch.zeros((a.shape[0], b.shape[1]))
    for k0 in range(0, a.shape[1], _K_STEP):
        k = slice(k0, k0 + _K_STEP)
        acc = acc + a_small[:, k] @ b_big[k]
        acc = acc + a_big[:, k] @ b_small[k]
        acc = acc + a_big[:, k] @ b_big[k]
    return acc


def _emulate_k2(x, f_len, st, n_per_repeat, mm=_mm_kernel):
    """The masker as the kernel computes it: valid rows only (no tile past
    f_len), 3xTF32 products, gLN statistics as per-tile partials (GEMM A
    tiles of the plan's shape, depthwise chunks of 128 rows x 64 channels),
    merged in merge_stats's order; rows past f_len are 0."""
    if st["w_in"].dtype == torch.int8:
        st = dequant_stack(st)
    nb, c, hd = st["w_in"].shape
    batch = x.shape[0]
    nwg, bn = BF16_TILES[tf32_plan(batch, x.shape[1], c, hd, _SMS)["cfg_in"]]
    bm = 64 * nwg
    out = torch.zeros_like(x)
    for i_b, fl in enumerate(int(n) for n in f_len):
        h = x[i_b, :fl]
        skips = torch.zeros((fl, c))
        for i in range(nb if fl else 0):
            v, dil = st["vecs"][i], 2 ** (i % n_per_repeat)
            h1 = mm(h, st["w_in"][i]) + v[0]
            h1 = torch.where(h1 >= 0, h1, v[1, 0] * h1)
            mean1, rstd1 = _merge_launch([_tile_partial(h1[r:r + bm, c0:c0 + bn])
                                          for r in range(0, fl, bm)
                                          for c0 in range(0, hd, bn)], nwg, batch)
            z = torch.nn.functional.pad(((h1 - mean1) * rstd1) * v[2] + v[3], (0, 0, dil, dil))
            w = st["w_dw"][i]
            h2 = (z[:fl] * w[0] + z[dil:dil + fl] * w[1]) + z[2 * dil:] * w[2] + v[4]
            h2 = torch.where(h2 >= 0, h2, v[5, 0] * h2)
            mean2, rstd2 = _merge_launch([_tile_partial(h2[r:r + _DW_ROWS, c0:c0 + 64])
                                          for r in range(0, fl, _DW_ROWS)
                                          for c0 in range(0, hd, 64)], 2, batch)
            y = (h2 - mean2) * (v[6] * rstd2) + v[7]
            rs = mm(y, torch.cat([st["w_res"][i], st["w_skip"][i]], dim=1))
            h = (h + rs[:, :c]) + st["cvecs"][i, 0]
            skips = (skips + rs[:, c:]) + st["cvecs"][i, 1]
        out[i_b, :fl] = skips
    return out


_K2_EMULATION_CASES = {
    # F off the 128-row tile, f_len of a tile + 1 (two row tiles, the
    # second of one row), dilations up to 8
    "b2_f150_ragged": (150, [150, 129], 4, 0),
    # dilations up to 128 > f_len; item 1 a single frame, item 2 empty
    "b3_f260_dil128": (260, [260, 1, 0], 8, 1),
}


@pytest.mark.parametrize("case", sorted(_K2_EMULATION_CASES))
def test_kernel_numerics_emulation_matches_twin_and_pallas(masker_case, case, record_property):
    """The kernel's algorithm (valid rows only, 3xTF32 on warpgroup products
    accumulated over the whole contraction, gLN statistics merged from
    per-tile partials with Chan's formula in the kernel's order) within
    1e-4 of max|skips| of the twin and of the Pallas
    kernel (interpret mode) on valid rows; rows past f_len exactly 0. The
    error of one plain TF32 product a product is recorded beside it, not
    asserted: it is what the split into three products buys back."""
    blocks, st, _, _, _ = masker_case
    f, lens, npr, seed = _K2_EMULATION_CASES[case]
    rng = np.random.default_rng(seed + 10)
    x = rng.normal(size=(len(lens), f, C)).astype(np.float32)
    f_len = np.array(lens, np.int32)
    tst = {k: torch.from_numpy(np.array(v)) for k, v in st.items()}
    got = _emulate_k2(torch.from_numpy(x), f_len, tst, npr)
    twin = tcn_masker_reference(torch.from_numpy(x), torch.from_numpy(f_len), tst,
                                n_per_repeat=npr).numpy()
    ref = np.asarray(jax_fused_tcn_masker(jnp.asarray(x), jnp.asarray(f_len), st,
                                          n_per_repeat=npr, tile=64, interpret=True))
    valid = np.arange(f)[None, :] < f_len[:, None]
    assert not got.numpy()[~valid].any()

    def err(a, b):  # on valid rows alone: the JAX kernel leaves NaN in an empty item
        return np.abs(a[valid] - b[valid]).max() / np.abs(b[valid]).max()

    err_twin = err(got.numpy(), twin)
    assert err_twin < TOL
    assert err(got.numpy(), ref) < TOL
    record_property("three_tf32_products_rel_err", float(err_twin))
    one = _emulate_k2(torch.from_numpy(x), f_len, tst, npr, mm=_mm_tf32).numpy()
    record_property("one_tf32_product_rel_err", float(err(one, twin)))


def test_gln_statistics_merged_from_partials_are_two_pass_grade(record_property):
    """The kernel's statistics of 2000 x 512 values of mean 100 and std
    1e-2 (a tile partial per 128 x 128 GEMM tile, merged in order) against
    float64 two-pass: mean within 1e-6, rstd within 1e-5 (each tile's
    float32 mean is off by ~1e-7 of 100, 1e-3 of the std, and those offsets
    add their squares to the variance); float32 E[x^2] - mean^2 over the
    same values is off by more than half the variance itself."""
    rng = np.random.default_rng(3)
    v = torch.from_numpy((100.0 + 1e-2 * rng.standard_normal((2000, 512))).astype(np.float32))
    mean, rstd = _merge_launch([_tile_partial(v[r:r + 128, c0:c0 + 128])
                                for r in range(0, v.shape[0], 128)
                                for c0 in range(0, v.shape[1], 128)], 2, 1)
    exact = v.double()
    mu = exact.mean().item()
    var64 = ((exact - mu) ** 2).mean().item()
    rstd64 = 1.0 / np.sqrt(var64 + 1e-8)
    record_property("mean_rel_err", float(abs(mean - mu) / abs(mu)))
    record_property("rstd_rel_err", float(abs(rstd - rstd64) / rstd64))
    assert abs(mean - mu) <= 1e-6 * abs(mu)
    assert abs(rstd - rstd64) <= 1e-5 * rstd64
    naive = ((v * v).mean() - v.mean() ** 2).item()
    assert abs(naive - var64) > 0.5 * var64


@pytest.fixture(scope="module")
def tasnet_case():
    cfg = jax_tiny_preset().sep3
    rng = np.random.default_rng(7)
    variables = JaxTasNet(cfg).init(jax.random.PRNGKey(0), jnp.zeros((1, 800)),
                                    jnp.ones((1, 800)))
    variables = jax.tree.map(
        lambda a: np.asarray(a) + 0.05 * rng.standard_normal(np.shape(a)).astype(np.float32),
        jax.device_get(variables))
    t = 3000
    wav = (0.3 * rng.standard_normal((2, t))).astype(np.float32)
    sm = (np.arange(t)[None, :] < np.array([t, 2100])[:, None]).astype(np.float32)
    ref = np.asarray(JaxTasNet(cfg).apply(variables, jnp.asarray(wav), jnp.asarray(sm)))
    sd = params_to_state_dicts({"sep3": variables})["sep3"]
    return variables, wav, sm, ref, sd


@pytest.mark.parametrize("fused_tcn", ["auto", "off"])
def test_convtasnet_matches_jax(tasnet_case, fused_tcn):
    """Tiny Conv-TasNet-3 with converted weights: the K2 path ("auto", the
    twin on CPU) and the dense block loop ("off") against the JAX dense
    model, 1e-4 relative to max|out|."""
    import dataclasses

    _, wav, sm, ref, sd = tasnet_case
    model = ConvTasNet(dataclasses.replace(tiny_preset().sep3, fused_tcn=fused_tcn)).eval()
    model.load_state_dict(sd)
    with torch.no_grad():
        out = model(torch.from_numpy(wav), torch.from_numpy(sm)).numpy()
    assert out.shape == ref.shape == (2, 3, wav.shape[1])
    assert np.abs(out - ref).max() / np.abs(ref).max() < TOL


def test_stack_tcn_params_matches_jax(tasnet_case):
    variables, _, _, _, sd = tasnet_case
    model = ConvTasNet(tiny_preset().sep3).eval()
    model.load_state_dict(sd)
    ours = stack_tcn_params(model.tcn_blocks())
    c = tiny_preset().sep3
    blocks = [variables["params"][f"tcn_{r}_{x}"]
              for r in range(c.n_repeats) for x in range(c.n_blocks)]
    theirs = jax_stack_tcn_params([jax.tree.map(jnp.asarray, b) for b in blocks], jnp.float32)
    for k, v in theirs.items():
        np.testing.assert_array_equal(ours[k].detach().numpy(), np.asarray(v), err_msg=k)
