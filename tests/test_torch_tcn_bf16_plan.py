"""The bf16 masker's launch plan on the host (``tcn.bf16_plan``), the tile
order its GEMM and depthwise kernels walk (``tcn.bf16_schedule``), and the scratch the
wrapper sizes for them (``tcn.gln_partials``, the int8 stack's bf16 copy).
The kernels themselves run only on the card (tests/test_torch_kernels_cuda.py)."""
import re
from pathlib import Path

import pytest

from audio_classification_tpu_torch.ops.kernels import tcn

SR = 16000
F32, F2 = (32 * SR - 32) // 16 + 1, (2 * SR - 32) // 16 + 1
#: every width the wrapper takes (C % 32, H % 64, H dividing 1024): the tiny
#: preset, the quality gate's world, the full preset, and the edges
WIDTHS = [(32, 64), (64, 128), (96, 256), (128, 512), (160, 1024), (32, 1024)]
#: (f_len, F): the flagship segment, the serving windows, the streaming
#: window, and ragged small buckets with empty and one-row items
BUCKETS = [([(20 * SR - 32) // 16 + 1], F32), ([F2, F2, 1500, F2, 1000, F2, 750, F2], F2),
           ([F2], F2), ([77, 1, 0], 77), ([129, 128, 127], 300), ([0, 0], 64)]


def _tiles(nwg, bn, b, f, n):
    return b * -(-f // (64 * nwg)) * (n // bn)


@pytest.mark.parametrize("sms", [132, 114, 8])
@pytest.mark.parametrize("c,hd", WIDTHS)
@pytest.mark.parametrize("lens,f", BUCKETS)
def test_plan_takes_a_tile_shape_that_divides_n_and_fills_the_card(lens, f, c, hd, sms):
    """Each GEMM gets a tile shape whose columns divide its N (H for A, 2 C
    for C): the first that fills the card over the whole bucket, else the
    1 x 64 shape (the most tiles); its grid is at least 1 and at most the
    tiles and the card's slots (2 CTAs an SM at one warpgroup)."""
    pl = tcn.bf16_plan(len(lens), f, c, hd, sms)
    for k, n in (("in", hd), ("out", 2 * c)):
        cfg, grid = pl["cfg_" + k], pl["grid_" + k]
        nwg, bn = tcn.BF16_TILES[cfg]
        assert n % bn == 0
        tiles = _tiles(nwg, bn, len(lens), f, n)
        earlier = [i for i, (w, m) in enumerate(tcn.BF16_TILES[:cfg]) if n % m == 0]
        assert all(_tiles(*tcn.BF16_TILES[i], len(lens), f, n) < sms for i in earlier)
        assert tiles >= sms or cfg == len(tcn.BF16_TILES) - 1
        assert 1 <= grid <= max(tiles, 1) and grid <= sms * (2 if nwg == 1 else 1)


@pytest.mark.parametrize("c,hd", WIDTHS)
@pytest.mark.parametrize("lens,f", BUCKETS)
def test_schedule_covers_every_valid_row_once_and_no_padded_tile(lens, f, c, hd):
    """Over the plan's grid, the tiles of GEMM A and C cover each valid
    (row, column) of every item exactly once, no tile starts at or past its
    item's f_len, each CTA walks its tiles in the static order, and the
    CTAs' loads differ by at most one tile."""
    pl = tcn.bf16_plan(len(lens), f, c, hd, 132)
    for k, n in (("in", hd), ("out", 2 * c)):
        nwg, bn = tcn.BF16_TILES[pl["cfg_" + k]]
        bm, n_ct = 64 * nwg, n // bn
        sched = tcn.bf16_schedule(lens, bm, n_ct, pl["grid_" + k])
        seen = {}
        for cta in sched:
            assert cta == sorted(cta)
            for b, rt, ct in cta:
                assert rt * bm < lens[b]
                for r in range(rt * bm, min((rt + 1) * bm, lens[b])):
                    for col in range(ct * bn, (ct + 1) * bn, 64):
                        seen[(b, r, col)] = seen.get((b, r, col), 0) + 1
        assert len(seen) == sum(lens) * (n // 64)
        assert set(seen.values()) <= {1}
        sizes = [len(cta) for cta in sched]
        assert max(sizes) - min(sizes) <= 1


@pytest.mark.parametrize("c,hd", WIDTHS)
@pytest.mark.parametrize("lens,f", BUCKETS)
def test_depthwise_chunks_cover_every_valid_row_once(lens, f, c, hd):
    """The bf16 depthwise pass walks chunks of BF16_DW_ROWS rows by 64
    channels in the GEMMs' order over its grid (1 .. 2 CTAs an SM): every
    valid (row, channel slice) once, no chunk past f_len."""
    pl = tcn.bf16_plan(len(lens), f, c, hd, 132)
    rows = tcn.BF16_DW_ROWS
    chunks = len(lens) * -(-f // rows) * (hd // 64)
    assert 1 <= pl["grid_dw"] <= max(1, min(chunks, 264))
    sched = tcn.bf16_schedule(lens, rows, hd // 64, pl["grid_dw"])
    seen = [(b, r, cs) for cta in sched for b, rt, cs in cta
            for r in range(rt * rows, min((rt + 1) * rows, lens[b]))]
    assert all(rt * rows < lens[b] for cta in sched for b, rt, _ in cta)
    assert len(seen) == len(set(seen)) == sum(lens) * (hd // 64)


@pytest.mark.parametrize("c,hd", WIDTHS)
@pytest.mark.parametrize("lens,f", BUCKETS)
def test_scratch_has_room_for_every_partial_and_the_dequantised_stack(lens, f, c, hd):
    """``gln_partials`` slots hold one partial per GEMM A tile of an item at
    any tile shape and per depthwise block (4096 / H rows); the int8
    stack's bf16 copy is C H + 3 H + 2 H C elements a TCN block."""
    room = tcn.gln_partials(f, hd)
    for nwg, bn in tcn.BF16_TILES:
        if hd % bn == 0:
            assert -(-f // (64 * nwg)) * (hd // bn) <= room
    assert -(-f // (4096 // hd)) <= room
    assert -(-f // tcn.BF16_DW_ROWS) * (hd // 64) <= room
    pl = tcn.bf16_plan(len(lens), f, c, hd, 132)
    assert pl["wdq_per_block"] == c * hd + 3 * hd + 2 * hd * c


def test_tile_shapes_are_the_c_entry_points_table():
    """BF16_TILES numbers the shapes as the C entry points do (the TILES
    table and the launch dispatch of csrc/tcn_masker.cu), and BF16_DW_ROWS
    is the depthwise chunk's DR."""
    src = (Path(tcn.__file__).resolve().parents[2] / "csrc" / "tcn_masker.cu").read_text()
    table = re.search(r"constexpr int TILES\[(\d+)\]\[2\] = \{(.*?)\};", src)
    pairs = tuple((int(a), int(b)) for a, b in re.findall(r"\{(\d+), (\d+)\}", table.group(2)))
    assert int(table.group(1)) == len(tcn.BF16_TILES) and pairs == tcn.BF16_TILES
    cases = dict((int(i), (int(w), int(n))) for i, w, n in re.findall(
        r"case (\d+): return launch_cfg<MODE, (\d+), (\d+)>", src))
    assert cases == dict(enumerate(tcn.BF16_TILES))
    assert re.search(r"constexpr int DR = (\d+), DW = 64;", src).group(1) == str(tcn.BF16_DW_ROWS)
