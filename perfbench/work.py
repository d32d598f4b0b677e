"""The benchmark's own work counts: the kernels' operations and bytes (frozen
copies of the port's ``ops/kernels/*.work`` formulas, which
``tests/test_perfbench_work.py`` holds equal to them at the cells' shapes) and
the models' float32 FLOPs for a job, which ``mfu`` reads.

Model FLOPs count the products of the published networks over each item's
valid frames (2 FLOPs a multiply-add; elementwise work, norms and the
softmax left out): the work a job needs, whatever the program computes on
padding. Attention counts valid queries against valid keys.
"""
from __future__ import annotations

import functools
import math
from typing import Optional, Sequence

SR = 16000


# ------------------------------------------------------------ kernel work
def k1_work(n: int, n_fft: int, nb: int, mel_nnz: int, band_rows: int) -> dict:
    """K1 (fbank_power_mel) on n frames: the n_fft / 2 point complex FFT,
    the split to bins and the power, the mel weights, the log."""
    m, n_bins = n_fft // 2, n_fft // 2 + 1
    consts = 2 * n_bins + 2 * nb + band_rows * nb
    return {"flops": n * (5.0 * m * math.log2(m) + 19.0 * n_bins + 2.0 * mel_nnz + nb),
            "bytes": 4.0 * (n * n_fft + n * nb + consts)}


def k2_work(b: int, f: int, c: int, hd: int, n_blocks: int, weight_bytes: int,
            f_len: Optional[Sequence[int]] = None, itemsize: int = 4) -> dict:
    """K2 (the TCN masker) on x [b, f, c] through n_blocks blocks of hidden
    width hd, over the valid frames ``f_len`` (all b x f when None)."""
    n = b * f if f_len is None else sum(f_len)
    return {"flops": n_blocks * n * (2.0 * c * hd + 2.0 * hd * 2 * c + 6.0 * hd),
            "bytes": itemsize * 2.0 * n * c + weight_bytes}


def _keys(b: int, tk: int, valid_keys: Optional[Sequence[int]]) -> int:
    return b * tk if valid_keys is None else sum(valid_keys)


def k3_work(b: int, h: int, tq: int, tk: int, d: int, itemsize: int = 4, masked: bool = True,
            valid_keys: Optional[Sequence[int]] = None) -> dict:
    """K3 (flash attention) on q [b, h, tq, d] against tk keys, over the
    valid keys of each item."""
    n = _keys(b, tk, valid_keys)
    q = b * h * tq * d
    return {"flops": 4.0 * h * tq * n * d, "exps": 1.0 * h * tq * n,
            "bytes": itemsize * (q + 2.0 * h * d * n) + 4.0 * q + (b * tk if masked else 0)}


def k4_work(b: int, t: int, dqk: int, de: int, itemsize: int = 4, masked: bool = True,
            valid_keys: Optional[Sequence[int]] = None) -> dict:
    """K4 (the GAU's relu^2 attention) on q, k [b, t, dqk], v [b, t, de],
    over the valid keys of each item."""
    n = _keys(b, t, valid_keys)
    return {"flops": 2.0 * t * n * (dqk + de),
            "bytes": itemsize * (b * t * dqk + n * (dqk + de)) + 4.0 * b * t * de
                     + (b * t if masked else 0)}


def bound_s(work: dict, peaks: dict) -> float:
    """The least time the card could take: operations at the TF32 tensor
    peak or bytes at the HBM bandwidth, whichever binds."""
    return max(work["flops"] / peaks["tf32_flops"], work["bytes"] / peaks["hbm_bytes"])


# ------------------------------------------------------------ model FLOPs
def fbank_frames(n: int) -> int:
    return 0 if n < 400 else 1 + (n - 400) // 160


@functools.lru_cache(maxsize=1)
def mel_bank_counts() -> tuple:
    """(non-zero weights, widest band) of the 80-bin mel bank at 512 points."""
    from .reference.models import _mel_bank

    nz = _mel_bank() != 0
    first = nz.argmax(axis=0)
    last = nz.shape[0] - nz[::-1].argmax(axis=0)
    return int(nz.sum()), int((last - first).max())


def fbank_flops(n: int) -> float:
    """K1's operations for a wave of n samples (the kaldi frontend)."""
    nnz, rows = mel_bank_counts()
    return k1_work(fbank_frames(n), 512, 80, nnz, rows)["flops"]


def pyannet_flops(n: int, w: dict) -> float:
    """PyanNet on n samples: the sinc conv, two conv stages, the BiLSTM
    stack and the head."""
    t = (n - 251) // 10 + 1
    fl = 2.0 * t * w["n_filters"] * 251
    t //= 3
    cin = w["n_filters"]
    for ch in w["conv"]:
        t -= w["kernel"] - 1
        fl += 2.0 * t * ch * cin * w["kernel"]
        t //= 3
        cin = ch
    h = w["hidden"]
    for _ in range(w["layers"]):
        fl += 2 * 2.0 * t * 4 * h * (cin + h)
        cin = 2 * h
    for dim in w["linear"]:
        fl += 2.0 * t * cin * dim
        cin = dim
    return fl + 2.0 * t * cin * w["classes"]


def _sep_frames(n: int, kernel: int) -> int:
    return max((n - kernel) // (kernel // 2) + 1, 1)


def convtasnet_flops(n: int, c: dict) -> float:
    """Conv-TasNet on n samples: encoder, bottleneck, the TCN blocks, the
    mask conv and the decoder."""
    f = _sep_frames(n, c["enc_kernel"])
    nn_, b, h, s = c["enc_dim"], c["bottleneck"], c["hidden"], c["n_src"]
    blocks = c["n_blocks"] * c["n_repeats"]
    per_frame = (2.0 * nn_ * c["enc_kernel"] + 2.0 * nn_ * b
                 + blocks * (2.0 * b * h + 2.0 * h * c["conv_kernel"] + 4.0 * h * b)
                 + 2.0 * b * s * nn_ + 2.0 * s * nn_ * c["enc_kernel"])
    return f * per_frame


def mossformer_flops(n: int, c: dict) -> float:
    """MossFormer on n samples: encoder, input projection, the GAU layers
    (token mixer, u, v, q/k, the relu^2 attention over the valid frames, the
    output projection), mask head and decoder."""
    f = _sep_frames(n, c["enc_kernel"])
    nn_, d, qk = c["enc_dim"], c["dim"], c["qk_dim"]
    de = d * c["expansion"]
    layer = f * (2.0 * d * c["conv_kernel"] + 2 * 2.0 * d * de + 2.0 * d * qk + 2.0 * de * d) \
        + 2.0 * f * f * (qk + de)
    return (f * (2.0 * nn_ * c["enc_kernel"] + 2.0 * nn_ * d) + c["layers"] * layer
            + f * (2.0 * d * c["n_src"] * nn_ + 2.0 * c["n_src"] * nn_ * c["enc_kernel"]))


def speaker_flops(n: int, c: dict) -> float:
    """The embedder on the log-mel of n samples: its 2-D convolutions, the
    pooling's attention and the projection."""
    t, fr = max(fbank_frames(n), 1), c["num_mel"]
    ch0 = c["channels"][0]
    fl = 2.0 * t * fr * ch0 * 9
    cin = ch0
    for i, ch in enumerate(c["channels"]):
        if i:
            t, fr = -(-t // 2), -(-fr // 2)
        w = ch // c["scale"]
        pos = t * fr
        fl += pos * (2.0 * cin * ch + (c["scale"] - 1) * 2.0 * w * w * 9 + 2.0 * ch * ch)
        if i or cin != ch:
            fl += pos * 2.0 * cin * ch
        cin = ch
    flat = fr * cin
    return fl + t * 4.0 * flat * c["asp_hidden"] + 2.0 * 2 * flat * c["embed_dim"]


def job_flops(mix_lengths: Sequence[int], enroll_len: int, cfg: dict, kind: str,
              family) -> float:
    """One job's model FLOPs: the enrollment's embedding and transcript; OSD
    over every mixture; for overlap, separation, an embedding a branch and
    the transcript of one branch; for clean, an embedding and a transcript;
    and the enrollment's transcript over each record's span. A transcript is
    one call of the recognizer ``family`` (``asr/<family>.py``)."""
    p = cfg["preset"]
    asr = lambda n: family.flops(n, p[family.PRESET])  # noqa: E731
    spk = lambda n: fbank_flops(n) + speaker_flops(n, p["spk"])  # noqa: E731
    fl = spk(enroll_len) + asr(enroll_len)
    moss = cfg["sep_backend"] == "mossformer"
    for n in mix_lengths:
        fl += pyannet_flops(n, cfg["pyannet"])
        if kind == "overlap":
            sc = p["mossformer" if moss else "sep3"]
            fl += mossformer_flops(n, sc) if moss else convtasnet_flops(n, sc)
            fl += sc["n_src"] * spk(n) + asr(n)
        else:
            fl += spk(n) + asr(n)
        fl += asr(min(n, enroll_len))
    return fl
