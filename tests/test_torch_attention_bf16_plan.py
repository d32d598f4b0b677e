"""The launch plans of the bf16 attention kernels on the host: K3 / K5 bf16
(``attention.bf16_plan``: the head dim a call runs at, the block's output
columns, the grid) and K4 bf16 (``gau.bf16_plan``: the block's warpgroups,
the column chunks of De, the grid). The C entry points plan the same
(``act_flash_attention_bf16_plan``, ``act_gau_attention_bf16_plan``; the card
test ``test_bf16_attention_plans_are_the_c_plans`` holds the two equal); the
kernels themselves run only on the card (tests/test_torch_kernels_cuda.py)."""
import re
from pathlib import Path

import pytest

from audio_classification_tpu_torch.ops.kernels import attention, gau

CSRC = Path(attention.__file__).resolve().parents[2] / "csrc"
#: the shared memory a block may use on an H100 (the opt-in cap)
CARD_SMEM = 232448
#: (B, H, Tq, Tk): chip_smoke's shapes (OSDNet / SenseVoice, the long-form
#: utterance and its shards, Paraformer's bucket) and tile edges
K3_SHAPES = [(8, 8, 537, 537), (1, 8, 537, 537), (1, 4, 800, 800), (1, 8, 4271, 4271),
             (1, 8, 1068, 1068), (3, 8, 537, 1068), (2, 4, 300, 300), (2, 4, 200, 333),
             (1, 1, 1, 1), (2, 3, 63, 64), (2, 3, 64, 65), (2, 3, 65, 63), (1, 2, 129, 17)]
#: every head dim class: the instances, the zero-padded ones and the wide body
HEAD_DIMS = [40, 64, 65, 80, 96, 128, 129, 192, 200, 256, 257, 320, 384, 448, 640]


def _covered(pl, t: int) -> dict:
    """(row tile of 64, column chunk) -> how many consumer warpgroups own it
    over the plan's grid (64 rows a warpgroup, ``nwg`` a block); rows past t
    start no tile."""
    gx, _gy, gz = pl["grid"]
    nwg = pl.get("nwg", 1)
    seen = {}
    for x in range(gx):
        for w in range(nwg):
            r = x * 64 * nwg + 64 * w
            for z in range(gz):
                if r < t:
                    seen[(r // 64, z)] = seen.get((r // 64, z), 0) + 1
    return seen


@pytest.mark.parametrize("d", HEAD_DIMS)
@pytest.mark.parametrize("b,h,tq,tk", K3_SHAPES)
def test_k3_plan_covers_every_row_tile_and_column_once(b, h, tq, tk, d):
    """Over the plan's grid each 64-row tile of every item meets each column
    slice exactly once (a block is one warpgroup of 64 rows), the slices
    cover the padded head dim and none starts past it."""
    pl = attention.bf16_plan(b, h, tq, tk, d)
    dp = pl["head_dim"]
    assert dp == attention.padded_head_dim(d)
    gx, gy, gz = pl["grid"]
    assert gy == b * h and gx == -(-tq // 64)
    assert _covered(pl, tq) == {(i, z): 1 for i in range(-(-tq // 64)) for z in range(gz)}
    assert (gz - 1) * pl["cols"] < dp <= gz * pl["cols"]


@pytest.mark.parametrize("d", range(1, 641))
def test_k3_plan_has_an_instance_for_every_head_dim_the_wrapper_takes(d):
    """Every D the wrapper takes runs at its padded head dim: up to 256 one
    block holds all columns (p v is one wgmma of N = D <= 256, a multiple of
    16), above it the wide body's slices of 192 or 256; the block is one
    consumer warpgroup and a producer warp, its ring has two to four stages,
    and its shared memory fits the card with the live map of a 2^17-key
    call."""
    pl = attention.bf16_plan(1, 1, 200, 1 << 17, d)
    dp = pl["head_dim"]
    assert dp in attention.HEAD_DIMS or (dp > 128 and dp % attention.WIDE_SLAB == 0)
    if dp <= 256:
        assert pl["cols"] == dp and pl["grid"][2] == 1
    else:
        assert pl["cols"] in (192, 256)
    assert pl["cols"] % 16 == 0 and pl["cols"] <= 256
    assert pl["threads"] == 160  # one consumer warpgroup and a producer warp
    assert 2 <= pl["stages"] <= 4
    assert pl["smem"] <= CARD_SMEM


@pytest.mark.parametrize("nwg", [1, 2])
@pytest.mark.parametrize("dp", [64, 80, 128, 192, 256])
def test_block_ring_sizes(dp, nwg):
    """The stages of a block's ring: as many as fit 224 KB beside q (at most
    4), each one K tile and one V tile of 64 keys in 64-wide boxes (D = 80
    takes two boxes a row, the second zero-filled past column 80); one
    consumer warpgroup takes a producer warp, two a producer warpgroup."""
    blk = attention.bf16_block(-(-dp // 64), dp, nwg, 0)
    nd = -(-dp // 64)
    q, slot = nwg * nd * 8192, 2 * nd * 8192
    assert blk["stages"] == min(4, (224 * 1024 - q - 4096) // slot) >= 2
    assert blk["smem"] == 1024 + q + blk["stages"] * (slot + 256 + 16) + 8
    assert blk["threads"] == (160 if nwg == 1 else 384)


@pytest.mark.parametrize("de", range(8, 2049, 8))
def test_k4_plan_chunks_cover_de_once(de):
    """K4's column chunks: nc = ceil(De / 256) of one width (a multiple of
    64, at most 256) that cover De, none starting past it; the flagship's
    768 in three chunks of 256, TP 2's 384 in two of 192, TP 4's 192 in
    one."""
    pl = gau.bf16_plan(1, 15999, 128, de)
    gz, cols = pl["grid"][2], pl["cols"]
    assert gz == -(-de // 256)
    assert cols % 64 == 0 and cols <= 256
    assert (gz - 1) * cols < de <= gz * cols
    assert pl["smem"] <= CARD_SMEM and 2 <= pl["stages"] <= 4
    assert pl["threads"] == (384 if pl["nwg"] == 2 else 160)
    expect = {768: (3, 256), 384: (2, 192), 192: (1, 192)}
    if de in expect:
        assert (gz, cols) == expect[de]


@pytest.mark.parametrize("dqk", [8, 32, 64, 72, 104, 128])
@pytest.mark.parametrize("b,t,de", [(1, 1, 768), (3, 333, 96), (2, 63, 768), (2, 64, 768),
                                    (2, 65, 768), (1, 15999, 768), (1, 15999, 384),
                                    (1, 15999, 192), (3, 1237, 768), (1, 31999, 768)])
def test_k4_plan_rows_and_boxes(b, t, de, dqk):
    """K4's grid: every 64-row tile of every item meets each column chunk in
    exactly one consumer warpgroup (every query row is written, padded rows
    too); two warpgroups a block only where halving the blocks saves a round
    of the card's SMs; one q / K box up to Dqk 64 and two above."""
    pl = gau.bf16_plan(b, t, dqk, de)
    nwg, (gx, gy, gz) = pl["nwg"], pl["grid"]
    assert gy == b and gx == -(-t // (64 * nwg))
    assert _covered(pl, t) == {(i, z): 1 for i in range(-(-t // 64)) for z in range(gz)}
    rounds = [-(-(-(-t // (64 * n)) * b * gz) // gau.BF16_SMS) for n in (1, 2)]
    assert (nwg == 2) == (rounds[1] < rounds[0])
    nd = 1 if dqk <= 64 else 2
    assert {k: pl[k] for k in ("threads", "stages", "smem")} == \
        attention.bf16_block(nd, pl["cols"], nwg, -(-t // 64))


def test_plans_are_the_c_sources():
    """The Python plans' constants and instances are the C sources': the box,
    the shared-memory budget, the wide body's stages, the K3 / K5 dispatch's
    instances (boxes, k16 steps and p v columns of each head dim, one
    warpgroup) and K4's (q boxes, warpgroups, chunk widths, the SM count of
    its rule)."""
    cuh = (CSRC / "attention_wgmma.cuh").read_text()
    assert re.search(r"constexpr int BOX = 64 \* 128;", cuh)
    assert re.search(r"constexpr int BK = (\d+);", cuh).group(1) == str(attention.BLOCK_K)
    assert int(eval(re.search(r"constexpr int SMEM_CAP = ([\d *]+);", cuh).group(1))) \
        == attention.BF16_SMEM_CAP
    assert re.search(r"static constexpr int NS = NS_FIT > 4 \? 4 : NS_FIT;", cuh)
    fa = (CSRC / "flash_attention.cu").read_text()
    assert re.search(r"constexpr int WNS = (\d+);", fa).group(1) == str(attention.BF16_WIDE_STAGES)
    inst = set(re.findall(r"aw::launch<MODE, (\d+), (\d+), (\d+), (\d+)>", fa))
    assert inst == {(str(-(-dp // 64)), str(-(-dp // 16)), str(dp), "1")
                    for dp in (64, 80, 128, 192, 256)}
    assert set(re.findall(r"launch_wide<EMIT_STATS, (\d+)>\(grid", fa)) == {"192", "256"}
    ga = (CSRC / "gau_attention.cu").read_text()
    assert set(re.findall(r"launch_cfg<(\d), DV, (\d)>\(grid", ga)) == \
        {(nd, nwg) for nd in ("1", "2") for nwg in ("1", "2")}
    assert set(re.findall(r"launch_cols<(\d+)>\(wide_q", ga)) == {"64", "128", "192", "256"}
    assert re.search(r"per_row \+ (\d+)\) / (\d+);", ga).groups() == \
        (str(gau.BF16_SMS - 1), str(gau.BF16_SMS))
