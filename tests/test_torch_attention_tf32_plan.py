"""The float32 K3 / K5 kernels' host side: their launch plan
(``attention.tf32_plan``, the C ``act_flash_attention_plan``'s mirror) and
the split copies of k, v and q their split launch writes
(``attention.tf32_split_kv``). The kernels themselves run only on the card
(tests/test_torch_kernels_cuda.py)."""
import re
from pathlib import Path

import pytest
import torch

from audio_classification_tpu_torch.ops.kernels import attention

CSRC = Path(attention.__file__).resolve().parents[2] / "csrc"
#: (B, H, Tq, Tk): chip_smoke's K3 and K5 shapes (SenseVoice at 32 s batch 8
#: and 1, OSDNet at 32 s, the 200 s utterance's 256 s bucket, one shard's
#: block of it, a shard's queries against two blocks, Paraformer's buckets)
#: and edge shapes (one row, Tq != Tk off every tile, rounds of the card)
SHAPES = [(8, 8, 537, 537), (1, 8, 537, 537), (1, 4, 800, 800), (1, 8, 4271, 4271),
          (1, 8, 1068, 1068), (3, 8, 537, 1068), (1, 4, 533, 533), (1, 4, 4267, 4267),
          (1, 4, 1067, 1067), (2, 4, 200, 333), (1, 1, 1, 1), (2, 3, 70, 45),
          (1, 132, 64, 64), (1, 133, 128, 128)]
#: the head dims: the instances, the wide body's, and D that run zero-padded
HEAD_DIMS = [40, 64, 80, 128, 136, 192, 200, 256, 320, 640]


@pytest.mark.parametrize("d", HEAD_DIMS)
@pytest.mark.parametrize("b,h,tq,tk", SHAPES)
def test_tf32_plan_covers_every_row_and_column_once(b, h, tq, tk, d):
    """The grid covers every query row of every item once (row blocks of 64
    per warpgroup) and every output column once (the head dim in one block,
    or the wide body's column slices); a block fits the card's 227 KB of
    shared memory with at least two ring stages; the split scratch holds
    both halves of k, of v^T over Tk rounded up to 8, and of q for the wide
    body."""
    pl = attention.tf32_plan(b, h, tq, tk, d)
    dp = attention.padded_head_dim(d)
    rows, cols = 64 * pl["nwg"], pl["cols"]
    gx, gy, gz = pl["grid"]
    assert pl["head_dim"] == dp and gy == b * h
    assert (gx - 1) * rows < tq <= gx * rows
    assert (gz - 1) * cols < dp <= gz * cols
    if dp <= 128:
        assert gz == 1 and cols == dp and pl["keys"] == attention.tf32_keys(dp)
    else:
        assert cols == attention.TF32_WIDE_COLS and pl["nwg"] == 1
    assert 2 <= pl["stages"] <= 4 and pl["smem"] <= 232448
    assert pl["threads"] == 128 * pl["nwg"] + (128 if pl["nwg"] == 2 else 32)
    tkp = -(-tk // 8) * 8
    assert pl["k_split"] == 2 * b * h * tk * dp and pl["v_split"] == 2 * b * h * dp * tkp
    assert pl["q_split"] == (2 * b * h * tq * dp if dp > 128 else 0)


@pytest.mark.parametrize("b,h,tq,tk", SHAPES)
def test_tf32_plan_takes_two_warpgroups_where_rounds_times_cost_are_fewer(b, h, tq, tk):
    """At D = 64 and 80 a block is two warpgroups (128 rows sharing each
    K / v^T tile) exactly where the card's rounds of blocks times a block's
    cost are fewer (in quarter tiles: a prologue of 2 tiles, a key tile at
    4 with one warpgroup, 7 with two); at D = 128 always one (q's halves of
    128 rows would leave no second stage)."""
    for d in (64, 80):
        rounds = [-(-(-(-tq // (64 * n)) * b * h) // attention.TF32_SMS) for n in (1, 2)]
        tiles = -(-tk // attention.tf32_keys(d))
        two = rounds[1] * (8 + 7 * tiles) < rounds[0] * (8 + 4 * tiles)
        assert attention.tf32_plan(b, h, tq, tk, d)["nwg"] == (2 if two else 1)
    assert attention.tf32_plan(b, h, tq, tk, 128)["nwg"] == 1


@pytest.mark.parametrize("b,h,tq,tk,nwg", [
    # measured on the card (PERF.md §6): the faster side of each
    (8, 8, 537, 537, 2), (1, 8, 1068, 1068, 2), (1, 8, 4271, 4271, 1), (1, 8, 537, 537, 1),
    (1, 4, 800, 800, 1)])
def test_tf32_plan_picks_the_faster_block_at_the_measured_shapes(b, h, tq, tk, nwg):
    """The rule's choice at the D = 64 shapes where both block sizes were
    timed on the card, and at D = 80's 256 s bucket (one warpgroup)."""
    assert attention.tf32_plan(b, h, tq, tk, 64)["nwg"] == nwg
    assert attention.tf32_plan(1, 4, 4267, 4267, 80)["nwg"] == 1


def test_tf32_plan_is_the_c_constants():
    """``attention.TF32_*`` and ``tf32_keys`` are the float32 bodies'
    constants (csrc/flash_attention.cu, namespace t32)."""
    src = (CSRC / "flash_attention.cu").read_text()
    body = src[src.index("namespace t32 {"):src.index("}  // namespace t32")]

    def const(name):
        return int(re.search(rf"constexpr int {name} = (\d+);", body).group(1))

    assert (const("ROW"), const("SMEM_MAX"), const("SMEM_RESERVE"), const("SMS")) == (
        attention.TF32_ROW, attention.TF32_SMEM_MAX, attention.TF32_SMEM_RESERVE,
        attention.TF32_SMS)
    assert (const("WCOLS"), const("WBK"), const("WNS")) == (
        attention.TF32_WIDE_COLS, attention.TF32_WIDE_KEYS, attention.TF32_WIDE_STAGES)
    assert "constexpr int QBOX = 64 * ROW;" in body and attention.TF32_QBOX == 64 * 128
    assert "constexpr int keys_of(int d) { return d == 64 ? 64 : 32; }" in body
    assert [attention.tf32_keys(d) for d in (64, 80, 128)] == [64, 32, 32]


def test_tf32_key_order_makes_the_score_accumulator_p_v_a_fragment():
    """A thread's score accumulator holds keys 2 t and 2 t + 1 of each group
    of 8 (columns 8 j + 2 t, + 1); the TF32 A fragment holds k = t and
    t + 4. v^T's permuted positions t and t + 4 must hold those keys, and
    the split launch's permutation (attention_wgmma.cuh) is the same."""
    for t in range(4):
        assert attention.TF32_KEY_ORDER[t] == 2 * t
        assert attention.TF32_KEY_ORDER[t + 4] == 2 * t + 1
    src = (CSRC / "attention_wgmma.cuh").read_text()
    assert "key = (tx & ~7) + (pos < 4 ? 2 * pos : 2 * (pos - 4) + 1)" in src
    assert sorted(attention.TF32_KEY_ORDER) == list(range(8))


@pytest.mark.parametrize("tk", [1, 7, 8, 9, 64, 65, 537])
@pytest.mark.parametrize("d", [64, 80, 192])
def test_tf32_split_kv_puts_every_key_where_the_kernel_reads_it(tk, d):
    """Every element of the split copies: k's halves at [half, item, key,
    dim] as k lies (big rounded to nearest, big + small within 2^-22 |k|);
    v^T's at [half, item, column, position], position 8 g + i holding key
    8 g + TF32_KEY_ORDER[i] and 0 for every position past Tk; q's (the
    wide body) as k's."""
    b, h, tq = 2, 3, 5
    g = torch.Generator().manual_seed(tk * 1000 + d)
    q = torch.randn((b, h, tq, d), generator=g)
    k = torch.randn((b, h, tk, d), generator=g) * 3.0
    v = torch.randn((b, h, tk, d), generator=g)
    ks, vs, qs = attention.tf32_split_kv(k, v, q if d > 128 else None)
    pl = attention.tf32_plan(b, h, tq, tk, d)
    assert ks.numel() == pl["k_split"] and vs.numel() == pl["v_split"]
    assert (qs is None) == (pl["q_split"] == 0) and (qs is None or qs.numel() == pl["q_split"])
    items, tkp = b * h, -(-tk // 8) * 8
    for flat, x in ((ks, k), (qs, q)):
        if flat is None:
            continue
        big, small = flat.view(2, items, -1, d)
        x = x.reshape(items, -1, d)
        assert torch.equal(big, attention.tf32_split(x)[0])
        assert ((big.view(torch.int32) & 0x1FFF) == 0).all()
        assert ((small.view(torch.int32) & 0x1FFF) == 0).all()
        err = (big.double() + small.double() - x.double()).abs()
        assert (err <= 2.0 ** -22 * x.double().abs()).all()
    vbig, vsmall = vs.view(2, items, d, tkp)
    vv = v.reshape(items, tk, d)
    for pos in range(tkp):
        key = pos // 8 * 8 + attention.TF32_KEY_ORDER[pos % 8]
        if key >= tk:
            assert not vbig[:, :, pos].any() and not vsmall[:, :, pos].any()
            continue
        assert torch.equal(vbig[:, :, pos], attention.tf32_split(vv[:, key])[0])
        err = (vbig[:, :, pos].double() + vsmall[:, :, pos].double() - vv[:, key].double()).abs()
        assert (err <= 2.0 ** -22 * vv[:, key].double().abs()).all()
