"""The port's CUDA kernels against their plain twins, on the card.

CUDA kernels have no CPU mode: without a CUDA device every test here skips.
On the GPU machine run them with

    python -m pytest tests/test_torch_kernels_cuda.py -q

Edge cases the main path does not reach: ragged tails of every tile size,
batch > 1 with ragged lengths, fully masked rows, the tiny preset's widths.
"""
import ctypes

import numpy as np
import pytest
import torch

from audio_classification_tpu_torch.ops import fbank
from audio_classification_tpu_torch.ops.kernels import attention, gau, tcn
from audio_classification_tpu_torch.ops.kernels import fbank as k_fbank

import torch_fbank_inputs

torch.set_num_threads(2)
pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.parametrize("n_fft", [512, 1024])
@pytest.mark.parametrize("kind", torch_fbank_inputs.KINDS)
@pytest.mark.parametrize("n", [1, 7, 8, 9, 33, 1000, 3198])
def test_fbank_kernel_matches_twin(dev, n, kind, n_fft):
    """Frame counts on both sides of the 8-frame block and past one wave,
    at n_fft 512 (80 bins) and 1024 (the 64 ms config, 128 bins). Held to
    the float64 twin under tests/torch_fbank_inputs.py's criterion; on the
    noise input at n_fft 512 also to the float32 twin within 1e-4 on bins
    within 15 nats of the peak and 5e-3 on all. Silence gives exactly
    log(log_floor); a second call gives the same bits; each call is one
    launch."""
    cfg = torch_fbank_inputs.config(n_fft)
    frames = torch_fbank_inputs.frames(kind, n, cfg, dev, seed=n)
    bases = fbank.fbank_bases(cfg, dev)
    before = k_fbank.fbank_power_mel.launches
    out = k_fbank.fbank_power_mel(frames, bases, cfg.log_floor)
    again = k_fbank.fbank_power_mel(frames, bases, cfg.log_floor)
    torch.cuda.synchronize()
    assert k_fbank.fbank_power_mel.launches == before + 2
    assert out.shape == (n, cfg.num_bins) and torch.isfinite(out).all()
    assert torch.equal(out, again)
    acc = torch_fbank_inputs.accuracy(out, frames, bases, cfg.log_floor)
    assert torch_fbank_inputs.meets(acc), acc
    if kind == "zeros":
        assert (out == torch.log(torch.tensor(cfg.log_floor, device=dev))).all()
    if kind == "noise" and n_fft == 512:
        ref = k_fbank.fbank_power_mel_reference(frames, bases.cos_b, bases.msin_b, bases.mel_w,
                                                cfg.log_floor)
        err = (out - ref).abs()
        assert err[ref > ref.max() - 15.0].max().item() < 1e-4
        assert err.max().item() < 5e-3


@pytest.mark.parametrize("n_fft", [400, 768, 128, 2048])
def test_fbank_kernel_refuses_other_n_fft(dev, n_fft):
    """Powers of two 256-1024 only on the card, named in the ValueError."""
    bases = fbank.make_fbank_bases(n_fft, fbank.mel_filterbank_np(40, n_fft, 16000), dev)
    frames = torch.zeros((3, n_fft), device=dev)
    before = k_fbank.fbank_power_mel.launches
    with pytest.raises(ValueError, match=f"n_fft {n_fft}"):
        k_fbank.fbank_power_mel(frames, bases, 1e-7)
    assert k_fbank.fbank_power_mel.launches == before


def test_fbank_kernel_never_hands_a_cuda_tensor_to_the_twin(dev, monkeypatch):
    """The wrapper launches or raises: with the twin made to fail, a CUDA
    call still returns; unaligned frames raise before any launch."""
    cfg = fbank.FbankConfig()
    bases = fbank.fbank_bases(cfg, dev)
    frames = torch_fbank_inputs.frames("noise", 50, cfg, dev)

    def refuse(*args):
        raise AssertionError("the twin got a CUDA tensor")

    monkeypatch.setattr(k_fbank, "fbank_power_mel_reference", refuse)
    assert k_fbank.fbank_power_mel(frames, bases, cfg.log_floor).shape == (50, 80)
    flat = torch.zeros(50 * 512 + 1, device=dev)
    flat[1:] = frames.reshape(-1)
    with pytest.raises(ValueError, match="16-byte"):
        k_fbank.fbank_power_mel(flat[1:].view(50, 512), bases, cfg.log_floor)
    with pytest.raises(ValueError, match="float32"):
        k_fbank.fbank_power_mel(frames.double(), bases, cfg.log_floor)


# sequence lengths on both sides of the 16-row fragment, the 64-key tile and
# the 64-row block
_TILE_EDGES = (1, 15, 16, 17, 63, 64, 65, 129, 1068)


@pytest.mark.parametrize("b,h,t", [(2, 2, 1), (2, 3, 70), (3, 8, 537)]
                         + [(2, 3, t) for t in _TILE_EDGES if t != 1])
def test_flash_kernel_matches_twin(dev, b, h, t):
    """Ragged key masks with one fully masked row, and no mask; 2e-5 abs on
    valid rows (f32 softmax, O(1) outputs); fully masked rows only need be
    finite. Staged rows past T are zero-filled and excluded, none stored."""
    g = torch.Generator().manual_seed(t)
    q, k, v = (torch.randn((b, h, t, 64), generator=g).to(dev) for _ in range(3))
    lens = torch.tensor([t] + [max(t // (i + 2), 1) for i in range(b - 2)] + [0])[:b].to(dev)
    mask = torch.arange(t, device=dev)[None, :] < lens[:, None]
    out = attention.flash_attention(q, k, v, mask)
    torch.cuda.synchronize()
    ref = attention.attention_reference(q, k, v, mask)
    assert torch.isfinite(out).all()
    valid = (lens > 0)[:, None, None, None]
    assert ((out - ref).abs() * valid).max().item() < 2e-5
    out = attention.flash_attention(q, k, v, None)
    assert (out - attention.attention_reference(q, k, v, None)).abs().max().item() < 2e-5
    # a head dim without an instance runs zero-padded to the next one (32 -> 64)
    q32, k32, v32 = q[..., :32], k[..., :32], v[..., :32]
    out = attention.flash_attention(q32, k32, v32, mask)
    assert out.shape == q32.shape
    ref = attention.attention_reference(q32, k32, v32, mask)
    assert ((out - ref).abs() * valid).max().item() < 2e-5
    # above the largest instance the wide body runs (136 -> 192, two column slices)
    q136, k136, v136 = (torch.cat([x, x, x[..., :8]], dim=-1) for x in (q, k, v))
    out = attention.flash_attention(q136, k136, v136, mask)
    assert out.shape == q136.shape
    ref = attention.attention_reference(q136, k136, v136, mask)
    assert ((out - ref).abs() * valid).max().item() < 2e-5


# (C, H, F, f_len per item, n_per_repeat): f_len of 1, one GEMM row tile
# (128) - 1, the tile, + 1 and F; F smaller than one tile; an empty item;
# n_per_repeat 8 over 8 blocks, so dilations up to 128 exceed short f_len
_TCN_CASES = [(32, 64, 77, [77, 1, 0], 4), (32, 64, 300, [300, 129, 128], 8),
              (128, 512, 300, [127, 128, 129], 8), (128, 512, 1000, [1000, 503], 4),
              (128, 512, 1999, [1999, 1500, 1, 0], 8)]


def _tcn_stack(g, dev, c, hd, nb, quant):
    """Random block weights; under ``quant`` the int8 stream with its scale
    rows (vecs [NB, 10, H], cvecs [NB, 4, C])."""
    from audio_classification_tpu_torch.ops.quant import quantize_weight

    def r(*s, scale=0.1):
        return (torch.randn(s, generator=g) * scale).to(dev)

    rows = [r(nb, hd), torch.full((nb, hd), 0.25, device=dev), 1 + r(nb, hd), r(nb, hd),
            r(nb, hd), torch.full((nb, hd), 0.3, device=dev), 1 + r(nb, hd), r(nb, hd)]
    crows = [r(nb, c), r(nb, c)]
    st = {"w_in": r(nb, c, hd), "w_dw": r(nb, 3, hd, scale=0.3), "w_res": r(nb, hd, c),
          "w_skip": r(nb, hd, c)}
    if quant:
        for name in ("w_in", "w_dw", "w_res", "w_skip"):
            st[name], scale = quantize_weight(st[name], channel_axis=-1, keep_axes=(0,))
            (rows if name in ("w_in", "w_dw") else crows).append(scale[:, 0])
    st["vecs"] = torch.stack(rows, dim=1).contiguous()
    st["cvecs"] = torch.stack(crows, dim=1).contiguous()
    return st


def _check_tcn_call(dev, st, c, f, lens, npr):
    """One kernel call against the twin: 1e-4 x max|skips| on valid rows
    (3xTF32 on the tensor cores, ~1e-6 expected; another summation order
    over 8 blocks), rows past f_len exactly 0, a second call bit-identical
    (statistics merged in a fixed order, no atomics on sums), and padded
    rows of x at +-1e4 change no bit (no padded row is read) -> output."""
    g = torch.Generator().manual_seed(f + len(lens))
    x = torch.randn((len(lens), f, c), generator=g).to(dev)
    f_len = torch.tensor(lens, dtype=torch.int32, device=dev)
    out = tcn.fused_tcn_masker(x, f_len, st, n_per_repeat=npr)
    torch.cuda.synchronize()
    ref = tcn.tcn_masker_reference(x, f_len, st, n_per_repeat=npr)
    valid = (torch.arange(f, device=dev)[None, :] < f_len[:, None])[..., None]
    if valid.any():
        err = ((out - ref).abs() * valid).max().item()
        assert err / (ref.abs() * valid).max().item() < 1e-4
    assert not (out * ~valid).any()
    assert torch.equal(out, tcn.fused_tcn_masker(x, f_len, st, n_per_repeat=npr))
    poisoned = torch.where(valid, x, 1e4 * torch.sign(torch.randn_like(x)))
    assert torch.equal(out, tcn.fused_tcn_masker(poisoned, f_len, st, n_per_repeat=npr))
    return x, f_len, out


@pytest.mark.parametrize("c,hd,f,lens,npr", _TCN_CASES)
def test_tcn_kernel_matches_twin(dev, c, hd, f, lens, npr):
    """K2 (float stack) at the row-tile edges, with empty and one-frame
    items; each call counts one float launch and no int8 one."""
    st = _tcn_stack(torch.Generator().manual_seed(c), dev, c, hd, 8, quant=False)
    before = (tcn.fused_tcn_masker.launches, tcn.fused_tcn_masker.launches_s8)
    _check_tcn_call(dev, st, c, f, lens, npr)
    assert (tcn.fused_tcn_masker.launches, tcn.fused_tcn_masker.launches_s8) == \
        (before[0] + 3, before[1])


@pytest.mark.parametrize("c,hd,f,lens,npr", _TCN_CASES)
def test_tcn_s8_kernel_matches_twin_and_float_kernel(dev, c, hd, f, lens, npr):
    """The int8 weight stream (K2-s8) at the same cases: as K2 against the
    twin on the dequantised stack, and EQUAL to the float kernel on that
    stack (the same products in the same order on bit-identical weights).
    Each entry point counts its own launches."""
    st = _tcn_stack(torch.Generator().manual_seed(c + 1), dev, c, hd, 8, quant=True)
    before = (tcn.fused_tcn_masker.launches, tcn.fused_tcn_masker.launches_s8)
    x, f_len, out = _check_tcn_call(dev, st, c, f, lens, npr)
    assert (tcn.fused_tcn_masker.launches, tcn.fused_tcn_masker.launches_s8) == \
        (before[0], before[1] + 3)
    flt = tcn.fused_tcn_masker(x, f_len, tcn.dequant_stack(st), n_per_repeat=npr)
    assert (tcn.fused_tcn_masker.launches, tcn.fused_tcn_masker.launches_s8) == \
        (before[0] + 1, before[1] + 3)
    assert torch.equal(out, flt)
    with pytest.raises(ValueError, match="vecs"):
        tcn.fused_tcn_masker(x, f_len, {**st, "vecs": st["vecs"][:, :8].contiguous()},
                             n_per_repeat=npr)


@pytest.mark.parametrize("m,k,n", [(1, 8, 8), (17, 33, 7), (504, 32, 512), (2000, 32, 512),
                                   (1999, 512, 32), (537, 2048, 512)])
def test_int_matmul_is_exact_on_the_card(dev, m, k, n):
    """ops/quant.int_matmul pads to what torch._int_mm takes on this card
    (rows to 32, K and N to 8): exact integer sums at row counts, depths and
    widths off those grids, the 2 s window's [2000, 32] x [32, 512] among
    them."""
    from audio_classification_tpu_torch.ops.quant import int_matmul

    g = torch.Generator().manual_seed(m + k + n)
    a = torch.randint(-127, 128, (m, k), generator=g, dtype=torch.int8)
    b = torch.randint(-127, 128, (k, n), generator=g, dtype=torch.int8)
    got = int_matmul(a.to(dev), b.to(dev)).cpu()
    assert got.shape == (m, n) and torch.equal(got, int_matmul(a, b))


@pytest.mark.parametrize("b,t,dqk,de,lens,amp", [
    (1, 1, 128, 768, [1], 1.0),                # a single frame
    (3, 333, 32, 96, [333, 111, 0], 1.0),      # the tiny preset's widths, one fully masked item
    (2, 70, 128, 768, [70, 33], 1.0),          # one ragged tile of queries and of keys
    (2, 1000, 64, 1000, [1000, 517], 1.0),     # De over several column chunks, the last ragged
    (1, 4099, 128, 768, [3000], 1.0),          # many key tiles, the tail ones skipped as masked
    # T at both sides of the 32-key tile and the 64-row block
    (2, 31, 128, 768, [31, 30], 1.0),
    (2, 33, 128, 768, [33, 1], 1.0),
    (2, 63, 128, 768, [63, 32], 1.0),
    (2, 65, 128, 768, [65, 64], 1.0),
    (1, 129, 128, 768, [129], 1.0),
    # De off the 384-column chunk, the 96-column warp and the 16-column pair;
    # Dqk % 8 == 4 (the last k-step half zero)
    (2, 200, 128, 392, [200, 150], 1.0),
    (2, 200, 100, 4, [200, 9], 1.0),
    (1, 300, 12, 1156, [300], 1.0),
    # holes: a valid run after key tiles masked whole, a hole of whole
    # tiles, single valid keys at both ends, an item with no valid key
    (3, 537, 128, 768, [[(200, 300), (420, 537)], [(0, 1), (536, 537)], []], 1.0),
    # q and k x3 (scores x9: relu^2 is homogeneous, so x4 would repeat x1
    # bit for bit scaled by a power of two), with holes
    (2, 1068, 128, 768, [[(0, 100), (640, 1068)], [(300, 301)]], 3.0),
])
def test_gau_kernel_matches_twin(dev, b, t, dqk, de, lens, amp):
    """Ragged and holed masks, T off every tile, De off every column split,
    Dqk != De; 1e-4 x max|out| against the twin run in float64 (the kernel in
    3xTF32 tile by tile, ~3e-7 in the CPU emulation; the float32 twin adds
    its own cuBLAS error); a fully masked item gives exact zeros; the mask
    may be absent, bool or uint8."""
    g = torch.Generator().manual_seed(t + de)
    q, k = (torch.randn((b, t, dqk), generator=g).to(dev) * amp for _ in range(2))
    v = torch.randn((b, t, de), generator=g).to(dev)
    mask = torch.zeros((b, t), dtype=torch.bool)
    for i, item in enumerate(lens):
        for lo, hi in (item if isinstance(item, list) else [(0, item)]):
            mask[i, lo:hi] = True
    mask = mask.to(dev)
    empty = ~mask.any(dim=1)
    before = gau.gau_attention.launches
    for m in (mask, None, mask.to(torch.uint8)):
        out = gau.gau_attention(q, k, v, m, 4.0 / t)
        torch.cuda.synchronize()
        ref = gau.gau_attention_reference(q.double(), k.double(), v.double(), m, 4.0 / t)
        assert torch.isfinite(out).all()
        assert (out - ref).abs().max().item() <= 1e-4 * max(ref.abs().max().item(), 1e-30)
        if m is not None:
            assert not out[empty].any()
    assert gau.gau_attention.launches == before + 3
    with pytest.raises(ValueError, match="Dqk"):
        gau.gau_attention(q[..., :6], k[..., :6], v, mask, 1.0)
    with pytest.raises(ValueError, match="float32"):
        gau.gau_attention(q.double(), k, v, mask, 1.0)


@pytest.mark.parametrize("b,h,tq,tk,lens", [
    (1, 1, 1, 1, [1]),                      # a single query and key
    (2, 2, 70, 45, [45, 17]),               # Tq != Tk, both off the 16-row and 64-key tiles
    (3, 8, 537, 1068, [1068, 300, 33]),     # B > 1, ragged masks, whole key tiles masked
    (1, 8, 1068, 1068, [1068]),             # the long-form path's shape (256 s over 4 shards)
    (2, 3, 100, 64, [64, 0]),               # one item with every key masked
] + [(2, 3, tq, tk, [tk, max(tk // 2, 1)])  # Tq and Tk at the tile edges
     for tq, tk in zip(_TILE_EDGES, reversed(_TILE_EDGES))])
def test_flash_stats_kernel_matches_twin(dev, b, h, tq, tk, lens):
    """K5 against its twin: o to 1e-4 of max|o|, m and l to 1e-5 relative
    (float32 accuracy on both sides: the kernel in 3xTF32 tile by tile, the
    twin in cuBLAS's blocked order). An item whose keys are all masked
    gives m = -1e9 and l = Tk on both sides. The mask may be absent. o / l
    is K3's output."""
    g = torch.Generator().manual_seed(tq + tk)
    q = torch.randn((b, h, tq, 64), generator=g).to(dev)
    k, v = (torch.randn((b, h, tk, 64), generator=g).to(dev) for _ in range(2))
    lens_t = torch.tensor(lens, device=dev)
    mask = torch.arange(tk, device=dev)[None, :] < lens_t[:, None]
    before = attention.flash_attention_stats.launches
    for msk in (mask, None):
        o, m, l = attention.flash_attention_stats(q, k, v, msk)
        torch.cuda.synchronize()
        ro, rm, rl = attention.attention_stats_reference(q, k, v, msk)
        assert o.shape == ro.shape and m.shape == rm.shape == l.shape == (b, h, tq)
        assert (o - ro).abs().max().item() <= 1e-4 * ro.abs().max().item()
        assert ((m - rm).abs() <= 1e-5 * rm.abs().clamp_min(1.0)).all()
        assert ((l - rl).abs() <= 1e-5 * rl.abs()).all()
    assert attention.flash_attention_stats.launches == before + 2
    empty = lens_t == 0
    if empty.any():
        o, m, l = attention.flash_attention_stats(q, k, v, mask)
        assert (m[empty] == -1e9).all() and (l[empty] == tk).all()
    if tq == tk:
        out = attention.flash_attention(q, k, v, mask)
        o, m, l = attention.flash_attention_stats(q, k, v, mask)
        assert (out - o / l[..., None]).abs().max().item() < 2e-6
    # 32 runs zero-padded to 64; 136 on the wide body, zero-padded to 192
    for sub in ((x[..., :32] for x in (q, k, v)),
                (torch.cat([x, x, x[..., :8]], dim=-1) for x in (q, k, v))):
        qd, kd, vd = sub
        o, m, l = attention.flash_attention_stats(qd, kd, vd, mask)
        ro, rm, rl = attention.attention_stats_reference(qd, kd, vd, mask)
        assert o.shape == ro.shape and (o - ro).abs().max().item() <= 1e-4 * ro.abs().max().item()
        assert ((m - rm).abs() <= 1e-5 * rm.abs().clamp_min(1.0)).all()
        assert ((l - rl).abs() <= 1e-5 * rl.abs()).all()
    with pytest.raises(ValueError, match="must be float32"):
        attention.flash_attention_stats(q, k, v[:, :, :-1], mask)


@pytest.mark.parametrize("d", [40, 64, 80, 128, 136, 192, 200, 256])
@pytest.mark.parametrize("b,tq,tk,lens", [
    (3, 70, 70, [70, 33, 0]),        # ragged, an item with no valid key, off the tiles
    (2, 65, 129, [129, 64]),         # Tq one past a 64-row block, Tk one past two key tiles
    (1, 533, 533, [533]),            # Paraformer's 32 s bucket (LFR frames)
    (2, 17, 1068, [1068, 300]),      # K5's long-form block, Tq across the 16-row fragment
])
def test_flash_kernels_at_every_head_dim(dev, d, b, tq, tk, lens):
    """K3 and K5 at the instances (64, 80, 128), at the wide body's head dims
    (192 and 256: two column slices of 64 + 128 and of 128 + 128) and at D
    that run zero-padded (40 -> 64, 136 -> 192, 200 -> 256, scaled by
    1 / sqrt of the true D), against the twin in
    float64 on the items with a valid key: K3 2e-5 abs, K5's o 1e-4 of
    max|o|, m and l 1e-5 relative; an item with no valid key gives
    m = -1e9 and l = Tk, as the float32 twin does."""
    g = torch.Generator().manual_seed(d * 1000 + tq + tk)
    q = torch.randn((b, 4, tq, d), generator=g).to(dev)
    k, v = (torch.randn((b, 4, tk, d), generator=g).to(dev) for _ in range(2))
    lens_t = torch.tensor(lens, device=dev)
    mask = torch.arange(tk, device=dev)[None, :] < lens_t[:, None]
    has_key = (lens_t > 0)
    o, m, l = attention.flash_attention_stats(q, k, v, mask)
    torch.cuda.synchronize()
    ro, rm, rl = attention.attention_stats_reference(q.double(), k.double(), v.double(), mask)
    sel = has_key.view(-1, 1, 1, 1)
    assert o.shape == (b, 4, tq, d) and torch.isfinite(o).all()
    assert ((o - ro.float()).abs() * sel).max().item() <= 1e-4 * ro.abs().max().item()
    assert ((m - rm.float()).abs() <= 1e-5 * rm.float().abs().clamp_min(1.0))[has_key].all()
    assert ((l - rl.float()).abs() <= 1e-5 * rl.float().abs())[has_key].all()
    if not has_key.all():
        assert (m[~has_key] == -1e9).all() and (l[~has_key] == tk).all()
    if tq == tk:
        before = attention.flash_attention.launches
        out = attention.flash_attention(q, k, v, mask)
        torch.cuda.synchronize()
        assert attention.flash_attention.launches == before + 1
        ref = attention.attention_reference(q.double(), k.double(), v.double(), mask).float()
        assert out.shape == q.shape and torch.isfinite(out).all()
        assert ((out - ref).abs() * sel).max().item() < 2e-5


def test_flash_head_dims_are_the_c_instances(dev):
    """The wrapper's rule is the set of D the C dispatch switch takes: both
    entry points accept exactly the D that ``padded_head_dim`` keeps as they
    are (``HEAD_DIMS``, and every multiple of ``WIDE_SLAB`` above the
    largest; empty calls, which launch nothing and read no pointer) and
    refuse every other D up to 640."""
    from audio_classification_tpu_torch import _build

    k3 = _build.kernel("act_flash_attention", [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4
                       + [ctypes.c_float, ctypes.c_void_p])
    k5 = _build.kernel("act_flash_attention_stats", [ctypes.c_void_p] * 7
                       + [ctypes.c_int] * 5 + [ctypes.c_float, ctypes.c_void_p])
    stream = torch.cuda.current_stream(dev).cuda_stream
    dims = range(1, 641)
    taken = [d for d in dims if k3(None, None, None, None, None, 1, 1, 0, d, 1.0, stream) == 0]
    taken5 = [d for d in dims
              if k5(None, None, None, None, None, None, None, 1, 1, 0, 1, d, 1.0, stream) == 0]
    wanted = [d for d in dims if attention.padded_head_dim(d) == d]
    assert taken == taken5 == wanted
    assert tuple(wanted[:3]) == attention.HEAD_DIMS and wanted[3:5] == [192, 256]


@pytest.mark.parametrize("b,tq,tk,spans,amp", [
    # holes: a valid run after three tiles masked whole, a hole of three
    # whole tiles, a short prefix, and an item with no valid key
    (3, 537, 1068, [[(200, 512), (704, 1068)], [(0, 300)], []], 1.0),
    # self-attention (K3 too): two masked-whole tiles first, then a partly
    # masked one, a hole of two whole tiles, a ragged end
    (2, 537, 537, [[(140, 320), (448, 500)], [(0, 263)]], 1.0),
    # the same with q and k scaled by 4: scores of std 16, most p underflow
    # to 0
    (2, 537, 537, [[(140, 320), (448, 500)], [(0, 263)]], 4.0),
    # 15 masked-whole tiles before the only valid keys; single valid keys at
    # both ends of an item
    (2, 129, 1068, [[(1000, 1068)], [(0, 1), (1067, 1068)]], 4.0),
    # items with no valid key beside items with one key and with all keys
    (4, 65, 200, [[], [(64, 65)], [(0, 200)], []], 1.0),
])
def test_flash_kernels_skip_masked_tiles(dev, b, tq, tk, spans, amp, record_property):
    """Masked-whole key tiles are skipped only where the item has a valid
    key, and the result is the twin's: K5 and K3 at their tolerances; an
    item with no valid key computes every tile and gives m = -1e9, l = Tk."""
    g = torch.Generator().manual_seed(b * tq + tk)
    q = torch.randn((b, 8, tq, 64), generator=g).to(dev) * amp
    k = torch.randn((b, 8, tk, 64), generator=g).to(dev) * amp
    v = torch.randn((b, 8, tk, 64), generator=g).to(dev)
    mask = torch.zeros((b, tk), dtype=torch.bool)
    for i, item in enumerate(spans):
        for lo, hi in item:
            mask[i, lo:hi] = True
    mask = mask.to(dev)
    has_key = mask.any(dim=1)
    empty = ~has_key
    o, m, l = attention.flash_attention_stats(q, k, v, mask)
    torch.cuda.synchronize()
    # the twin in float64 on the items with a valid key: at scores of std 16
    # the float32 twin is itself 1.3e-5 off in l and 3e-5 in K3's output. An
    # item with no valid key is held to the float32 twin, whose -1e9 scores
    # round as the kernel's do (m = -1e9, l = Tk)
    exact = attention.attention_stats_reference(q.double(), k.double(), v.double(), mask)
    rounded = attention.attention_stats_reference(q, k, v, mask)
    ro, rm, rl = (torch.where(has_key.view(-1, *[1] * (x.dim() - 1)), x.float(), y)
                  for x, y in zip(exact, rounded))
    assert torch.isfinite(o).all() and torch.isfinite(m).all() and torch.isfinite(l).all()
    assert (o - ro).abs().max().item() <= 1e-4 * ro.abs().max().item()
    assert ((m - rm).abs() <= 1e-5 * rm.abs().clamp_min(1.0)).all()
    assert ((l - rl).abs() <= 1e-5 * rl.abs()).all()
    if tq == tk:  # K3: 2e-5 abs, and K5's o / l within 2e-6
        out = attention.flash_attention(q, k, v, mask)
        torch.cuda.synchronize()
        ref = attention.attention_reference(q.double(), k.double(), v.double(), mask).float()
        assert torch.isfinite(out).all()
        assert (out - ref)[has_key].abs().max().item() < 2e-5
        assert (out - o / l[..., None]).abs().max().item() < 2e-6
    # why the oracle is float64: the float32 twin's own error in l
    record_property("twin_float32_l_rel_err_vs_float64",
                    ((rounded[2] - exact[2]).abs() / exact[2])[has_key].max().item())
    if amp == 1.0 and empty.any():  # |q k| / 8 < 32: every score rounds to -1e9
        assert (m[empty] == -1e9).all() and (l[empty] == tk).all()


@pytest.mark.parametrize("n,t", [(2, 1100), (4, 2139), (4, 4272), (8, 2144)])
def test_ring_attention_on_the_card(dev, n, t):
    """The ring over n shards of one card against K3 and against the dense
    oracle, [1, T, 8, 64] with a padded tail that masks the last shard's keys
    whole: per-shard lengths on both sides of the K5 threshold (n = 8 runs
    the dense block), T padded to a multiple of n. 2e-5 abs on valid rows."""
    from audio_classification_tpu_torch.parallel.mesh import make_mesh
    from audio_classification_tpu_torch.parallel.ring_attention import (
        reference_attention,
        ring_attention,
    )

    g = torch.Generator().manual_seed(t)
    tp = -(-t // n) * n
    q, k, v = (torch.randn((1, tp, 8, 64), generator=g).to(dev) for _ in range(3))
    valid = t - (tp // n) - 5 if n > 2 else t   # n > 2: the last shard holds no valid key
    mask = (torch.arange(tp, device=dev) < valid)[None, :]
    mesh = make_mesh(n, devices=[dev] * n)
    before = attention.flash_attention_stats.launches
    out = ring_attention(q, k, v, mesh, kv_mask=mask)
    torch.cuda.synchronize()
    want = n * n if tp // n >= attention.FLASH_MIN_T else 0
    assert attention.flash_attention_stats.launches == before + want
    ref = reference_attention(q, k, v, mask)
    k3 = attention.flash_attention(*(z.transpose(1, 2) for z in (q, k, v)), mask).transpose(1, 2)
    rows = mask[:, :, None, None]
    assert ((out - ref).abs() * rows).max().item() < 2e-5
    assert ((out - k3).abs() * rows).max().item() < 2e-5
