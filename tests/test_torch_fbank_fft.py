"""K1's algorithm on the CPU: an emulation, in float32 torch, of what
csrc/fbank_power_mel.cu computes for each frame (the packing z[m] = x[2m] +
i x[2m+1], the Stockham passes in the source's radix order with its
in-register radix-2 DIT and its twiddle gathering, the split to the
n_fft / 2 + 1 bins, each mel filter's own run of bins, the log), held to the
float64 twin and to the JAX package's Pallas kernel in interpret mode; and
the kernel's constants (twiddle table, band table) against the DFT basis and
the mel bank they come from. The kernel itself runs only on the card
(tests/test_torch_kernels_cuda.py)."""
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audio_classification_tpu.ops.pallas.fbank_kernel import fbank_power_mel_pallas
from audio_classification_tpu.ops.stft import _dft_basis_np as jax_dft_basis_np
from audio_classification_tpu_torch.ops import fbank
from audio_classification_tpu_torch.ops.kernels.fbank import (
    fbank_power_mel,
    fbank_power_mel_reference,
)
from audio_classification_tpu_torch.ops.stft import _dft_basis_np
from torch_fbank_inputs import KINDS, accuracy, config, frames, meets

torch.set_num_threads(2)
SOURCE = (Path(__file__).resolve().parents[1] / "audio_classification_tpu_torch" / "csrc"
          / "fbank_power_mel.cu").read_text()
# the radix-8 DFT's constant, float32(cos(pi / 4)), as the source writes it
RSQRT2 = np.float32(re.search(r"RSQRT2 = ([0-9.]+)f;", SOURCE).group(1))


def _radix(m: int, ns: int) -> int:
    """csrc radix_of: radix 8, or less where what is left of m, or m / 32
    (the points a lane holds), is smaller."""
    return min(8, m // ns, m // 32)


def _cmul(a, w):
    return a[0] * w[0] - a[1] * w[1], a[0] * w[1] + a[1] * w[0]


def _dft_regs(v):
    """csrc dft_regs: radix-2 DIT over the r points of a butterfly, W_len^m
    = W_8^(8m / len) as the source special-cases it."""
    r = len(v)
    bits = r.bit_length() - 1
    t = [v[int(format(i, f"0{bits}b")[::-1], 2)] for i in range(r)]
    length = 2
    while length <= r:
        for s in range(0, r, length):
            for m in range(length // 2):
                a, b = t[s + m], t[s + m + length // 2]
                q = m * 8 // length
                if q == 1:
                    b = (RSQRT2 * (b[0] + b[1]), RSQRT2 * (b[1] - b[0]))
                elif q == 2:
                    b = (b[1], -b[0])
                elif q == 3:
                    b = (RSQRT2 * (b[1] - b[0]), -(RSQRT2 * (b[0] + b[1])))
                t[s + m] = (a[0] + b[0], a[1] + b[1])
                t[s + m + length // 2] = (a[0] - b[0], a[1] - b[1])
        length *= 2
    return t


def _k1_emulation(frames_: torch.Tensor, bases, log_floor: float) -> torch.Tensor:
    """What the kernel computes for each row of ``frames_`` [N, n_fft],
    vectorised over rows, in float32."""
    n_fft = frames_.shape[1]
    m = n_fft // 2
    table = bases.twiddle

    def tw(e):  # W^e, e < 2M: the table, negated past M
        e = torch.as_tensor(e)
        w = table[torch.where(e < m, e, e - m)]
        return torch.where((e < m)[:, None], w, -w)

    zr, zi = frames_[:, 0::2], frames_[:, 1::2]
    ns = 1
    while ns < m:
        r = _radix(m, ns)
        j = torch.arange(m // r)
        k = j % ns
        v = [(zr[:, j + t * (m // r)], zi[:, j + t * (m // r)]) for t in range(r)]
        if ns > 1:
            for t in range(1, r):
                w = tw(t * k * (2 * m // (ns * r)))
                v[t] = _cmul(v[t], (w[:, 0], w[:, 1]))
        v = _dft_regs(v)
        zr, zi = torch.empty_like(zr), torch.empty_like(zi)
        base = (j - k) * r + k
        for t in range(r):
            zr[:, base + t * ns], zi[:, base + t * ns] = v[t]
        ns *= r
    # split: X[k] = E + W^k O, Z[M] = Z[0]
    k = torch.arange(m + 1)
    ar, ai = zr[:, k % m], zi[:, k % m]
    cr, ci = zr[:, (m - k) % m], zi[:, (m - k) % m]
    er, ei = 0.5 * (ar + cr), 0.5 * (ai - ci)
    o_r, o_i = 0.5 * (ai + ci), -0.5 * (ar - cr)
    wr, wi = table[:, 0], table[:, 1]
    xr, xi = er + (o_r * wr - o_i * wi), ei + (o_r * wi + o_i * wr)
    power = xr * xr + xi * xi
    # each filter over its own run of bins, in the source's order
    mel = torch.zeros(frames_.shape[0], bases.bands.shape[0])
    for b, (first, count) in enumerate(bases.bands.tolist()):
        s = torch.zeros(frames_.shape[0])
        for q in range(count):
            s = s + power[:, first + q] * bases.band_w[q, b]
        mel[:, b] = s
    return torch.log(torch.clamp_min(mel, log_floor))


@pytest.mark.parametrize("n_fft", [512, 1024])
def test_twiddle_table_is_dft_basis_row_1(n_fft):
    """Bit for bit the float32 rounding of the float64 basis, in the port's
    copy and in the JAX package's; the in-register radix-8 constant is the
    table's value at e = M / 4."""
    tw = fbank.fbank_bases(config(n_fft), torch.device("cpu")).twiddle.numpy()
    for cos_b, msin_b in (_dft_basis_np(n_fft), jax_dft_basis_np(n_fft)):
        np.testing.assert_array_equal(tw[:, 0], cos_b[1])
        np.testing.assert_array_equal(tw[:, 1], msin_b[1])
    m = n_fft // 2
    assert tw.shape == (m + 1, 2) and tw.dtype == np.float32
    assert tw[m // 4, 0] == RSQRT2 and tw[m // 4, 1] == -RSQRT2


@pytest.mark.parametrize("n_fft", [512, 1024])
def test_band_table_rebuilds_mel_bank(n_fft):
    """Scattering the band table back gives mel_w exactly; each filter is one
    contiguous run of non-zero weights; no bin lies in more than two bands."""
    bases = fbank.fbank_bases(config(n_fft), torch.device("cpu"))
    mel = bases.mel_w.numpy()
    bands, band_w = bases.bands.numpy(), bases.band_w.numpy()
    assert bands.dtype == np.int32 and band_w.shape == (bands[:, 1].max(), mel.shape[1])
    rebuilt = np.zeros_like(mel)
    cover = np.zeros(mel.shape[0], int)
    for b, (first, count) in enumerate(bands):
        rebuilt[first:first + count, b] = band_w[:count, b]
        assert (band_w[:count, b] != 0).all() and (band_w[count:, b] == 0).all()
        cover[first:first + count] += 1
    np.testing.assert_array_equal(rebuilt, mel)
    assert cover.max() <= 2


@pytest.mark.parametrize("n_fft", [512, 1024])
@pytest.mark.parametrize("kind", KINDS)
def test_emulation_matches_float64_twin(kind, n_fft):
    """The kernel's algorithm in float32 against the float64 twin, under the
    criterion of tests/torch_fbank_inputs.py; digital silence gives exactly
    log(log_floor) everywhere."""
    cfg = config(n_fft)
    bases = fbank.fbank_bases(cfg, torch.device("cpu"))
    x = frames(kind, 301, cfg)
    out = _k1_emulation(x, bases, cfg.log_floor)
    assert out.shape == (301, cfg.num_bins) and torch.isfinite(out).all()
    acc = accuracy(out, x, bases, cfg.log_floor)
    assert meets(acc), acc
    if kind == "zeros":
        assert (out == torch.log(torch.tensor(cfg.log_floor))).all()


@pytest.mark.parametrize("n_fft", [512, 1024])
def test_emulation_matches_pallas_kernel(n_fft):
    """Against the JAX kernel in interpret mode on the same frames (the
    tolerance split of tests/test_torch_ops.py's twin test)."""
    cfg = config(n_fft)
    rng = np.random.default_rng(n_fft)
    x = (rng.standard_normal((200, n_fft)) * 3000.0).astype(np.float32)
    x[:, cfg.frame_length:] = 0.0
    ref = np.asarray(fbank_power_mel_pallas(
        jnp.asarray(x), n_fft, cfg.num_bins, cfg.sample_rate, cfg.low_freq, cfg.high_freq,
        cfg.log_floor, interpret=True))
    out = _k1_emulation(torch.from_numpy(x), fbank.fbank_bases(cfg, torch.device("cpu")),
                        cfg.log_floor).numpy()
    active = ref > ref.max() - 15.0
    assert np.abs(out - ref)[active].max() < 1e-4
    assert np.abs(out - ref).max() < 1e-3


def test_cpu_wrapper_runs_the_twin_at_any_n_fft():
    """The card takes n_fft 256-1024 in powers of two; the CPU path is the
    twin, whatever n_fft."""
    mel = fbank.mel_filterbank_np(40, 400, 16000)
    bases = fbank.make_fbank_bases(400, mel, torch.device("cpu"))
    x = torch.from_numpy(np.random.default_rng(0).standard_normal((5, 400)).astype(np.float32))
    out = fbank_power_mel(x, bases, 1e-7)
    ref = fbank_power_mel_reference(x, bases.cos_b, bases.msin_b, bases.mel_w, 1e-7)
    assert out.shape == (5, 40)
    torch.testing.assert_close(out, ref, rtol=0, atol=0)
