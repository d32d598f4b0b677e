"""The float32 kernels' host side: K2's launch plan (``tcn.tf32_plan``) and
the split, K-major copy of the stack its split launch writes
(``tcn.tf32_stack``, ``tcn.tf32_split``); K4's launch plan
(``gau.tf32_plan``). The kernels themselves run only on the card
(tests/test_torch_kernels_cuda.py)."""
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from audio_classification_tpu_torch.ops.kernels import gau, tcn
from audio_classification_tpu_torch.ops.quant import quantize_weight

CSRC = Path(tcn.__file__).resolve().parents[2] / "csrc"
SR = 16000
F32, F2 = (32 * SR - 32) // 16 + 1, (2 * SR - 32) // 16 + 1
#: every width the wrapper takes (C % 32, H % 64, H dividing 1024)
WIDTHS = [(32, 64), (64, 128), (96, 256), (128, 512), (160, 1024), (32, 1024)]
#: (f_len, F): the flagship segment, the serving windows, the streaming
#: window, and ragged small buckets with empty and one-row items
BUCKETS = [([(20 * SR - 32) // 16 + 1], F32), ([F2, F2, 1500, F2, 1000, F2, 750, F2], F2),
           ([F2], F2), ([77, 1, 0], 77), ([129, 128, 127], 300), ([0, 0], 64)]


@pytest.mark.parametrize("sms", [132, 114, 8])
@pytest.mark.parametrize("c,hd", WIDTHS)
@pytest.mark.parametrize("lens,f", BUCKETS)
def test_tf32_plan_picks_the_bf16_tile_shapes_and_room_for_the_split_stack(lens, f, c, hd, sms):
    """The float32 GEMMs take the bf16 GEMMs' tile table and the same pick
    (the first shape whose columns divide N and whose tiles fill the card);
    every GEMM A tile and depthwise chunk of an item has a gLN partial slot,
    the depthwise pass's grid is the bf16 one's, and the split copy is two
    halves of C H (W_in) + 2 H C ([W_res | W_skip]) a block."""
    pl = tcn.tf32_plan(len(lens), f, c, hd, sms)
    bf = tcn.bf16_plan(len(lens), f, c, hd, sms)
    assert {k: pl[k] for k in ("cfg_in", "grid_in", "cfg_out", "grid_out")} == \
        {k: bf[k] for k in ("cfg_in", "grid_in", "cfg_out", "grid_out")}
    for k, n in (("in", hd), ("out", 2 * c)):
        nwg, bn = tcn.BF16_TILES[pl["cfg_" + k]]
        assert n % bn == 0
        tiles = len(lens) * -(-f // (64 * nwg)) * (n // bn)
        assert 1 <= pl["grid_" + k] <= max(tiles, 1)
        assert pl["grid_" + k] <= sms * (2 if nwg == 1 else 1)
    nwg, bn = tcn.BF16_TILES[pl["cfg_in"]]
    assert -(-f // (64 * nwg)) * (hd // bn) <= tcn.gln_partials(f, hd)
    rows = tcn.BF16_DW_ROWS  # the depthwise chunks: a partial each, a grid of 2 CTAs an SM
    assert -(-f // rows) * (hd // 64) <= tcn.gln_partials(f, hd)
    assert pl["grid_dw"] == bf["grid_dw"] == max(1, min(len(lens) * -(-f // rows) * (hd // 64),
                                                       2 * sms))
    assert pl["split_per_block"] == 2 * (c * hd + 2 * hd * c)


@pytest.mark.parametrize("c,hd", WIDTHS)
@pytest.mark.parametrize("lens,f", BUCKETS)
def test_tf32_schedule_covers_every_valid_row_once(lens, f, c, hd):
    """Over the float32 plan's grids, the tiles of GEMM A and C (walked in
    ``bf16_schedule``'s order) cover each valid (row, column) of every item
    once and start no tile past f_len, with plan edge tiles: a last row
    tile of one row, items of 0 and 1 rows."""
    pl = tcn.tf32_plan(len(lens), f, c, hd, 132)
    for k, n in (("in", hd), ("out", 2 * c)):
        nwg, bn = tcn.BF16_TILES[pl["cfg_" + k]]
        bm = 64 * nwg
        seen = {}
        for cta in tcn.bf16_schedule(lens, bm, n // bn, pl["grid_" + k]):
            for b, rt, ct in cta:
                assert rt * bm < lens[b]
                for r in range(rt * bm, min((rt + 1) * bm, lens[b])):
                    for col in range(ct * bn, (ct + 1) * bn, 64):
                        seen[(b, r, col)] = seen.get((b, r, col), 0) + 1
        assert len(seen) == sum(lens) * (n // 64) and set(seen.values()) <= {1}


def _stack(c, hd, nb, seed, quant=False):
    g = torch.Generator().manual_seed(seed)
    st = {"w_in": torch.randn((nb, c, hd), generator=g) * 0.1,
          "w_dw": torch.randn((nb, 3, hd), generator=g) * 0.3,
          "w_res": torch.randn((nb, hd, c), generator=g) * 0.1,
          "w_skip": torch.randn((nb, hd, c), generator=g) * 0.1,
          "vecs": torch.randn((nb, 8, hd), generator=g), "cvecs": torch.randn((nb, 2, c), generator=g)}
    if quant:
        scales = {}
        for name in ("w_in", "w_dw", "w_res", "w_skip"):
            st[name], scales[name] = quantize_weight(st[name], channel_axis=-1, keep_axes=(0,))
        st["vecs"] = torch.cat([st["vecs"], scales["w_in"], scales["w_dw"]], dim=1)
        st["cvecs"] = torch.cat([st["cvecs"], scales["w_res"], scales["w_skip"]], dim=1)
    return st


def _rna_tf32_numpy(x: np.ndarray) -> np.ndarray:
    """TF32 round to nearest, ties away from zero, by float64 arithmetic:
    the multiple of 2^(e - 10) nearest x, e = floor(log2 |x|)."""
    out = np.zeros_like(x, dtype=np.float64)
    nz = x != 0
    e = np.floor(np.log2(np.abs(x[nz].astype(np.float64))))
    ulp = 2.0 ** (e - 10)
    q = np.abs(x[nz]) / ulp
    out[nz] = np.sign(x[nz]) * np.floor(q + 0.5) * ulp
    return out.astype(np.float32)


def test_tf32_split_big_is_round_to_nearest_and_big_plus_small_rebuilds_x():
    """``tf32_split`` (the split launch's, tf32_mma.cuh ``split``): big is
    round to nearest with ties away from zero (held to a float64
    computation, ties included), both halves hold 10 mantissa bits, and
    big + small is x within 2^-22 |x|."""
    rng = np.random.default_rng(7)
    x = np.concatenate([rng.standard_normal(20000) * 10.0 ** rng.integers(-6, 6, 20000),
                        [0.0, 1.0, -1.0, 1.0 + 2.0 ** -11, -(1.0 + 2.0 ** -11),
                         1.0 + 3 * 2.0 ** -11, 3.0 * 2.0 ** -12]]).astype(np.float32)
    big, small = tcn.tf32_split(torch.from_numpy(x))
    assert np.array_equal(big.numpy(), _rna_tf32_numpy(x))
    assert big[-4].item() == 1.0 + 2.0 ** -10 and big[-3].item() == -(1.0 + 2.0 ** -10)  # ties away
    for h in (big, small):
        assert ((h.view(torch.int32) & 0x1FFF) == 0).all()
    err = ((big.double() + small.double()) - torch.from_numpy(x).double()).abs()
    assert (err <= 2.0 ** -22 * torch.from_numpy(x).double().abs()).all()


def test_tf32_round_is_the_c_helpers():
    """``tf32_split`` rounds as tf32_mma.cuh's ``tf32_round`` (add 0x1000,
    clear the low 13 bits) and ``split`` (both halves rounded)."""
    src = (CSRC / "tf32_mma.cuh").read_text()
    assert "return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;" in src
    assert re.search(r"big = tf32_round\(x\);\s*small = tf32_round\(x - __uint_as_float\(big\)\);",
                     src)


@pytest.mark.parametrize("c,hd,nb", [(32, 64, 3), (128, 512, 2)])
def test_tf32_stack_is_k_major_and_split(c, hd, nb):
    """The split copy: W_in as [NB, H, C] and [W_res | W_skip] as
    [NB, 2 C, H] (the contraction index contiguous), big halves of every
    block then small; the halves rebuild each weight within 2^-22."""
    st = _stack(c, hd, nb, seed=c + hd)
    flat = tcn.tf32_stack(st)
    assert flat.numel() == nb * tcn.tf32_plan(1, 1, c, hd, 132)["split_per_block"]
    n_in, n_rs = nb * hd * c, nb * 2 * c * hd
    in_big, in_small, rs_big, rs_small = torch.split(flat, [n_in, n_in, n_rs, n_rs])
    w_in = st["w_in"].transpose(1, 2)
    w_rs = torch.cat([st["w_res"], st["w_skip"]], dim=-1).transpose(1, 2)
    for big, small, w in ((in_big, in_small, w_in), (rs_big, rs_small, w_rs)):
        big, small = big.view(w.shape), small.view(w.shape)
        assert torch.equal(big, tcn.tf32_split(w.contiguous())[0])
        err = (big.double() + small.double() - w.double()).abs()
        assert (err <= 2.0 ** -22 * w.double().abs()).all()
    # K-major: element (block, n, k) of W_in's copy is w_in[block, k, n]
    assert in_big.view(nb, hd, c)[1, 5, 7] == tcn.tf32_split(st["w_in"][1, 7, 5])[0]


def test_tf32_stack_of_int8_equals_the_float_path_on_the_dequantised_stack():
    """The int8 stream is dequantised, then split: bit for bit the float
    path's copy of ``dequant_stack``, which is what makes K2-s8 equal to K2
    on the dequantised stack."""
    st8 = _stack(64, 128, 3, seed=5, quant=True)
    assert st8["w_in"].dtype == torch.int8
    assert torch.equal(tcn.tf32_stack(st8), tcn.tf32_stack(tcn.dequant_stack(st8)))


#: gau_attention_ab.py's shapes, with --plan-shapes
K4_SHAPES = [(1, 15999, 128, 768), (1, 15999, 128, 384), (3, 1237, 128, 768), (1, 31999, 128, 768),
             (1, 4000, 128, 768), (1, 15999, 128, 192), (1, 2000, 128, 384), (2, 1000, 64, 1000),
             (3, 333, 32, 96), (1, 1, 128, 768), (2, 200, 100, 4)]


@pytest.mark.parametrize("b,t,dqk,de", K4_SHAPES)
def test_k4_tf32_plan_covers_every_row_and_column_once(b, t, dqk, de):
    """K4's float32 grid covers every query row and output column of every
    item once, fits a block's shared memory (232448 bytes) and sizes the
    split launch's scratch."""
    pl = gau.tf32_plan(b, t, dqk, de)
    rows, cols = 64 * pl["nwg"], pl["cols"]
    gx, gy, gz = pl["grid"]
    assert gy == b and (gx - 1) * rows < t <= gx * rows and (gz - 1) * cols < de <= gz * cols
    assert pl["smem"] <= 232448 and pl["threads"] == 128 * pl["nwg"] + 128
    assert pl["k_split"] == 2 * b * t * dqk
    assert pl["v_split"] == 2 * b * de * (-(-t // 8) * 8)


def test_k4_tf32_plan_is_the_c_constants():
    """``gau.TF32_*`` are the float32 kernel's BK, NWG, DV and NS."""
    src = (CSRC / "gau_attention.cu").read_text()
    body = src[src.index("namespace t32 {"):src.index("}  // namespace t32")]

    def const(name):
        return int(re.search(rf"constexpr int {name} = (\d+);", body).group(1))

    assert (const("NWG"), const("DV"), const("BK"), const("NS")) == (
        gau.TF32_WARPGROUPS, gau.TF32_COLS, gau.TF32_KEYS, gau.TF32_STAGES)
