"""The port's CUDA kernels against their plain twins, on the card.

CUDA kernels have no CPU mode: without a CUDA device every test here skips.
On the GPU machine run them with

    python -m pytest tests/test_torch_kernels_cuda.py -q

Edge cases the main path does not reach: ragged tails of every tile size,
batch > 1 with ragged lengths, fully masked rows, the tiny preset's widths.
"""
import numpy as np
import pytest
import torch

from audio_classification_tpu_torch.ops import fbank
from audio_classification_tpu_torch.ops.kernels import attention, gau, tcn
from audio_classification_tpu_torch.ops.kernels import fbank as k_fbank

torch.set_num_threads(2)
pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.parametrize("n", [1, 33, 1000])
def test_fbank_kernel_matches_twin(dev, n):
    """Frame counts off the 128-frame tile; 1e-4 abs on bins within 15 nats
    of the peak, 5e-3 on all (f32, another summation order over 512 taps)."""
    cfg = fbank.FbankConfig()
    rng = np.random.default_rng(n)
    wav = torch.from_numpy((0.1 * rng.standard_normal((1, 400 + 160 * (n - 1))))
                           .astype(np.float32)).to(dev)
    frames = fbank.windowed_frames(wav, cfg).reshape(-1, cfg.n_fft).contiguous()
    assert frames.shape[0] == n
    bases = fbank.fbank_bases(cfg, dev)
    before = k_fbank.fbank_power_mel.launches
    out = k_fbank.fbank_power_mel(frames, *bases, cfg.log_floor)
    torch.cuda.synchronize()
    assert k_fbank.fbank_power_mel.launches == before + 1
    ref = k_fbank.fbank_power_mel_reference(frames, *bases, cfg.log_floor)
    err = (out - ref).abs()
    assert err[ref > ref.max() - 15.0].max().item() < 1e-4
    assert err.max().item() < 5e-3


@pytest.mark.parametrize("b,h,t", [(2, 2, 1), (2, 3, 70), (3, 8, 537)])
def test_flash_kernel_matches_twin(dev, b, h, t):
    """Ragged key masks with one fully masked row; 2e-5 abs on valid rows
    (f32 softmax, O(1) outputs); fully masked rows only need be finite."""
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
    with pytest.raises(ValueError, match="head dim"):
        attention.flash_attention(q[..., :32], k[..., :32], v[..., :32], mask)


@pytest.mark.parametrize("c,hd,f", [(32, 64, 77), (128, 512, 1000)])
def test_tcn_kernel_matches_twin(dev, c, hd, f):
    """Batch of 2 with a ragged f_len; 1e-4 x max|skips| on valid rows
    (f32, another summation order over 2 x 4 blocks)."""
    g = torch.Generator().manual_seed(c)
    nb = 8

    def r(*s, scale=0.1):
        return (torch.randn(s, generator=g) * scale).to(dev)

    vecs = torch.stack([r(nb, hd), torch.full((nb, hd), 0.25, device=dev), 1 + r(nb, hd),
                        r(nb, hd), r(nb, hd), torch.full((nb, hd), 0.3, device=dev),
                        1 + r(nb, hd), r(nb, hd)], dim=1)
    st = {"w_in": r(nb, c, hd), "w_dw": r(nb, 3, hd, scale=0.3), "w_res": r(nb, hd, c),
          "w_skip": r(nb, hd, c), "vecs": vecs.contiguous(), "cvecs": r(nb, 2, c)}
    x = r(2, f, c, scale=1.0)
    f_len = torch.tensor([f, f // 2 + 3], dtype=torch.int32, device=dev)
    out = tcn.fused_tcn_masker(x, f_len, st, n_per_repeat=4)
    torch.cuda.synchronize()
    ref = tcn.tcn_masker_reference(x, f_len, st, n_per_repeat=4)
    valid = (torch.arange(f, device=dev)[None, :] < f_len[:, None])[..., None]
    err = ((out - ref).abs() * valid).max().item()
    assert err / (ref.abs() * valid).max().item() < 1e-4


@pytest.mark.parametrize("b,t,dqk,de,lens", [
    (1, 1, 128, 768, [1]),                 # a single frame
    (3, 333, 32, 96, [333, 111, 0]),       # the tiny preset's widths, one fully masked item
    (2, 70, 128, 768, [70, 33]),           # one ragged tile of queries and of keys
    (2, 1000, 64, 1000, [1000, 517]),      # De over several column chunks, the last ragged
    (1, 4099, 128, 768, [3000]),           # many key tiles, the tail ones skipped as masked
])
def test_gau_kernel_matches_twin(dev, b, t, dqk, de, lens):
    """Ragged masks, T off every tile size, Dqk != De; 1e-4 x max|out| (f32,
    key terms added one after another instead of in cuBLAS's blocked order);
    a fully masked item gives exact zeros; the mask may be absent."""
    g = torch.Generator().manual_seed(t)
    q, k = (torch.randn((b, t, dqk), generator=g).to(dev) for _ in range(2))
    v = torch.randn((b, t, de), generator=g).to(dev)
    lens_t = torch.tensor(lens, device=dev)
    mask = torch.arange(t, device=dev)[None, :] < lens_t[:, None]
    before = gau.gau_attention.launches
    for m in (mask, None):
        out = gau.gau_attention(q, k, v, m, 4.0 / t)
        torch.cuda.synchronize()
        ref = gau.gau_attention_reference(q, k, v, m, 4.0 / t)
        assert torch.isfinite(out).all()
        assert (out - ref).abs().max().item() <= 1e-4 * max(ref.abs().max().item(), 1e-30)
        if m is not None:
            assert not out[lens_t == 0].any()
    assert gau.gau_attention.launches == before + 2
    with pytest.raises(ValueError, match="Dqk"):
        gau.gau_attention(q[..., :6], k[..., :6], v, mask, 1.0)
    with pytest.raises(ValueError, match="float32"):
        gau.gau_attention(q.double(), k, v, mask, 1.0)
