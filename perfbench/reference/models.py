"""Plain forward passes of the models the benchmark's cells run: the kaldi
log-mel frontend, PyanNet, Conv-TasNet, MossFormer, the ERes2Net-style
speaker embedder and the SenseVoice-style CTC encoder.

A frozen copy of the port's forward passes in float32 PyTorch, with each
kernel written as its plain expression: the fbank's FFT as a DFT (in float64),
the TCN masker as its block loop, the attention cores as softmax(q k^T) v and
relu(q k^T / T)^2 v, in blocks of query rows where whole sequences would not
fit. Every product goes through ``Ops``, which with ``tf32=True`` rounds both
operands to TF32 (10 mantissa bits, to nearest) and so computes the same
network one precision below float32: the control of the comparison.

Weights are the benchmark's own state dicts (the port's names) and its
pyannote checkpoint (pyannote's names, renamed here). Nothing here imports the
port, JAX or the JAX package.
"""
from __future__ import annotations

import math
from typing import Dict, Tuple

import numpy as np
import torch
import torch.nn.functional as F

SD = Dict[str, torch.Tensor]
SR = 16000
FRAME, SHIFT, NFFT = 400, 160, 512
LOG_FLOOR = 1.1920928955078125e-07


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """float32 -> the nearest TF32 value (10 mantissa bits), as float32."""
    bits = x.float().contiguous().view(torch.int32)
    return torch.bitwise_and(bits + 0x1000, -0x2000).view(torch.float32)


class Ops:
    """The products of the reference: float32 without TF32, or with
    ``tf32`` both operands rounded to TF32 first."""

    def __init__(self, tf32: bool = False):
        self.tf32 = tf32

    def r(self, x: torch.Tensor) -> torch.Tensor:
        return tf32_round(x) if self.tf32 else x

    def linear(self, x, w, b=None):
        return F.linear(self.r(x), self.r(w), b)

    def matmul(self, a, b):
        return torch.matmul(self.r(a), self.r(b))

    def conv1d(self, x, w, b=None, stride=1, padding=0, dilation=1, groups=1):
        return F.conv1d(self.r(x), self.r(w), b, stride, padding, dilation, groups)

    def conv2d(self, x, w, b=None, stride=1, padding=0):
        return F.conv2d(self.r(x), self.r(w), b, stride, padding)

    def conv_transpose1d(self, x, w, stride):
        return F.conv_transpose1d(self.r(x), self.r(w), stride=stride)


# ------------------------------------------------------------------ frontend
def _mel_bank() -> np.ndarray:
    """kaldi's triangular mel bank [257, 80] over [20 Hz, 8 kHz], float64."""
    def mel(f):
        return 1127.0 * np.log(1.0 + f / 700.0)
    pts = np.linspace(mel(20.0), mel(SR / 2.0), 82)
    fm = mel(np.arange(NFFT // 2 + 1) * (SR / NFFT))
    fb = np.zeros((NFFT // 2 + 1, 80))
    for b in range(80):
        up = (fm - pts[b]) / (pts[b + 1] - pts[b])
        down = (pts[b + 2] - fm) / (pts[b + 2] - pts[b + 1])
        fb[:, b] = np.maximum(0.0, np.minimum(up, down))
    return fb.astype(np.float32).astype(np.float64)


def _dft() -> Tuple[np.ndarray, np.ndarray]:
    n = np.arange(NFFT)[:, None]
    k = np.arange(NFFT // 2 + 1)[None, :]
    ang = 2.0 * np.pi * ((n * k) % NFFT) / NFFT
    return np.cos(ang), -np.sin(ang)


def fbank(ops: Ops, wav: torch.Tensor) -> torch.Tensor:
    """[B, T] wave in [-1, 1] -> [B, N, 80] kaldi log-mel: frames of 25 ms
    every 10 ms (snip edges), DC removed, pre-emphasis 0.97, povey window,
    zero pad to 512, power spectrum, mel, log (floor FLT_EPSILON). The
    power and mel products in float64, or in TF32 under ``ops.tf32``."""
    dt = torch.float32 if ops.tf32 else torch.float64
    x = wav.to(dt) * 32768.0
    frames = x.unfold(-1, FRAME, SHIFT)
    frames = frames - frames.mean(dim=-1, keepdim=True)
    frames = torch.cat([frames[..., :1] * (1.0 - 0.97),
                        frames[..., 1:] - 0.97 * frames[..., :-1]], dim=-1)
    n = np.arange(FRAME, dtype=np.float64)
    win = (0.5 - 0.5 * np.cos(2 * np.pi * n / (FRAME - 1))) ** 0.85
    frames = frames * torch.from_numpy(win).to(frames.device, dt)
    frames = F.pad(frames, (0, NFFT - FRAME))
    cos_b, msin_b = (torch.from_numpy(a).to(frames.device, dt) for a in _dft())
    re, im = ops.matmul(frames, cos_b), ops.matmul(frames, msin_b)
    mel = torch.from_numpy(_mel_bank()).to(frames.device, dt)
    power = ops.matmul(re * re + im * im, mel)
    return torch.log(torch.clamp_min(power, LOG_FLOOR)).float()


def fbank_frames(lengths: torch.Tensor) -> torch.Tensor:
    """Valid fbank frames of each item (at least 1)."""
    return torch.clamp_min(torch.div(lengths - FRAME, SHIFT, rounding_mode="floor") + 1, 1)


def apply_lfr(feats: torch.Tensor, m: int, n: int) -> torch.Tensor:
    """[B, N, D] -> [B, ceil(N / n), m D]: m frames stacked every n, the
    first frame repeated (m - 1) // 2 times in front, the last one behind."""
    b, t, d = feats.shape
    left = (m - 1) // 2
    padded = torch.cat([feats[:, :1].expand(b, left, d), feats], dim=1)
    n_out = -(-t // n)
    need = (n_out - 1) * n + m
    if need > padded.shape[1]:
        padded = torch.cat([padded, padded[:, -1:].expand(b, need - padded.shape[1], d)], dim=1)
    idx = (torch.arange(n_out)[:, None] * n + torch.arange(m)[None, :]).reshape(-1)
    return padded[:, idx.to(feats.device)].reshape(b, n_out, m * d)


# ------------------------------------------------------------------ PyanNet
def _instance_norm(x, mask, w, b, eps=1e-5):
    m = mask[:, None, :].to(x.dtype)
    n = torch.clamp_min(m.sum(dim=2, keepdim=True), 1.0)
    mean = (x * m).sum(dim=2, keepdim=True) / n
    var = ((x - mean) ** 2 * m).sum(dim=2, keepdim=True) / n
    return ((x - mean) * torch.rsqrt(var + eps) * w[None, :, None] + b[None, :, None]) * m


def _mask(n: int, lengths: torch.Tensor) -> torch.Tensor:
    return torch.arange(n, device=lengths.device)[None, :] < lengths[:, None]


def _reverse_valid(x: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
    pos = torch.arange(x.shape[1], device=x.device)[None, :]
    idx = lengths[:, None] - 1 - pos
    idx = torch.where(idx >= 0, idx, pos)
    return torch.gather(x, 1, idx[..., None].expand(-1, -1, x.shape[2]))


def _sinc_filters(low_hz, band_hz, kernel=251, min_low=50.0, min_band=50.0):
    """SincNet's analytic filterbank (cos filters, then sin) [2R, 1, K]."""
    half = (kernel - 1) // 2
    dev = low_hz.device
    low = min_low + low_hz.abs()
    high = torch.clamp(low + min_band + band_hz.abs(), min_low, SR / 2)
    band = (high - low)[:, 0]
    n_lin = torch.linspace(0.0, kernel / 2 - 1, kernel // 2, device=dev)
    window = 0.54 - 0.46 * torch.cos(2 * math.pi * n_lin / kernel)
    n_ = 2 * math.pi * torch.arange(-half, 0, dtype=torch.float32, device=dev)[None, :] / SR
    f_low, f_high = low * n_, high * n_
    norm = 2 * band[:, None]
    left_cos = ((torch.sin(f_high) - torch.sin(f_low)) / (n_ / 2)) * window
    cos_f = torch.cat([left_cos, norm, torch.flip(left_cos, dims=(1,))], dim=1) / norm
    left_sin = ((torch.cos(f_low) - torch.cos(f_high)) / (n_ / 2)) * window
    sin_f = torch.cat([left_sin, torch.zeros_like(norm), -torch.flip(left_sin, dims=(1,))],
                      dim=1) / norm
    return torch.cat([cos_f, sin_f], dim=0)[:, None, :]


def _lstm_pair(ops: Ops, x: torch.Tensor, w: Dict[str, torch.Tensor]) -> torch.Tensor:
    """Two LSTMs (forward on x[0], backward on x[1]) stepped together:
    x [2, B, T, F] -> [2, B, T, H]; torch's gate order i, f, g, o."""
    xw = ops.matmul(x, w["ih"].transpose(1, 2)[:, None]) + w["b"][:, None, None, :]
    _, b, t, _ = x.shape
    hid = w["hh"].shape[2]
    h = x.new_zeros(2, b, hid)
    c = x.new_zeros(2, b, hid)
    whh = w["hh"].transpose(1, 2)
    out = []
    for s in range(t):
        g = xw[:, :, s] + ops.matmul(h, whh)
        i, f, gg, o = g.chunk(4, dim=-1)
        c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(gg)
        h = torch.sigmoid(o) * torch.tanh(c)
        out.append(h)
    return torch.stack(out, dim=2)


def pyannet(ops: Ops, sd: SD, wav: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
    """pyannote's PyanNet on [B, T] waves -> [B, T', classes] sigmoid
    activations, zero past each item's frames; ``sd`` in pyannote's names."""
    lengths = lengths.long()
    x = wav.float()[:, None, :]
    x = _instance_norm(x, _mask(x.shape[2], lengths), sd["sincnet.wav_norm1d.weight"],
                       sd["sincnet.wav_norm1d.bias"])
    filt = _sinc_filters(sd["sincnet.conv1d.0.filterbank.low_hz_"].reshape(-1, 1),
                         sd["sincnet.conv1d.0.filterbank.band_hz_"].reshape(-1, 1))
    x = F.max_pool1d(ops.conv1d(x, filt, stride=10).abs(), 3)
    flen = torch.clamp_min((lengths - 251) // 10 + 1, 0) // 3
    x = F.leaky_relu(_instance_norm(x, _mask(x.shape[2], flen), sd["sincnet.norm1d.0.weight"],
                                    sd["sincnet.norm1d.0.bias"]))
    i = 1
    while f"sincnet.conv1d.{i}.weight" in sd:
        w = sd[f"sincnet.conv1d.{i}.weight"]
        x = ops.conv1d(x, w, sd[f"sincnet.conv1d.{i}.bias"])
        flen = torch.clamp_min(flen - (w.shape[2] - 1), 0)
        x = F.max_pool1d(x * _mask(x.shape[2], flen)[:, None, :], 3)
        flen = flen // 3
        x = F.leaky_relu(_instance_norm(x, _mask(x.shape[2], flen),
                                        sd[f"sincnet.norm1d.{i}.weight"],
                                        sd[f"sincnet.norm1d.{i}.bias"]))
        i += 1
    mask = _mask(x.shape[2], flen)
    x = x.transpose(1, 2)
    layer = 0
    while f"lstm.weight_ih_l{layer}" in sd:
        w = {"ih": torch.stack([sd[f"lstm.weight_ih_l{layer}"],
                                sd[f"lstm.weight_ih_l{layer}_reverse"]]),
             "hh": torch.stack([sd[f"lstm.weight_hh_l{layer}"],
                                sd[f"lstm.weight_hh_l{layer}_reverse"]]),
             "b": torch.stack([sd[f"lstm.bias_ih_l{layer}"] + sd[f"lstm.bias_hh_l{layer}"],
                               sd[f"lstm.bias_ih_l{layer}_reverse"]
                               + sd[f"lstm.bias_hh_l{layer}_reverse"]])}
        fw, bw = _lstm_pair(ops, torch.stack([x, _reverse_valid(x, flen)]), w)
        x = torch.cat([fw, _reverse_valid(bw, flen)], dim=-1) * mask[..., None]
        layer += 1
    j = 0
    while f"linear.{j}.weight" in sd:
        x = F.leaky_relu(ops.linear(x, sd[f"linear.{j}.weight"], sd[f"linear.{j}.bias"]))
        j += 1
    return torch.sigmoid(ops.linear(x, sd["classifier.weight"], sd["classifier.bias"])) \
        * mask[..., None]


def pyannet_frames(n_samples: int) -> int:
    t = (n_samples - 251) // 10 + 1
    t //= 3
    for _ in range(2):
        t = (t - 4) // 3
    return t


# ------------------------------------------------------------------ separators
def _frame_lengths(lengths: torch.Tensor, kernel: int, stride: int) -> torch.Tensor:
    return torch.clamp_min(torch.div(lengths - kernel, stride, rounding_mode="floor") + 1, 1)


def _encode(ops: Ops, w_enc, mix, lengths, kernel, stride):
    """Pad so the frames tile the signal, mask, encode -> relu(W x) [B, N, F]
    and the frame mask [B, F]."""
    t = mix.shape[1]
    pad = (-(t - kernel)) % stride if t >= kernel else kernel - t
    sm = _mask(t, lengths).float()
    x = (F.pad(mix, (0, pad)) * F.pad(sm, (0, pad)))[:, None, :]
    w = torch.relu(ops.conv1d(x, w_enc, stride=stride))
    fmask = _mask(w.shape[2], _frame_lengths(lengths, kernel, stride))
    return w, fmask, sm


def _decode(ops: Ops, dec, masked, t, stride, sm):
    """[B, S, N, F] -> [B, S, T] overlap-add of the decoder basis, masked."""
    b, s, n, f = masked.shape
    sig = ops.conv_transpose1d(masked.reshape(b * s, n, f), dec.t()[:, None, :], stride)
    sig = sig.reshape(b, s, -1)[..., :t]
    if sig.shape[-1] < t:
        sig = F.pad(sig, (0, t - sig.shape[-1]))
    return sig * sm[:, None, :]


def _gln(x, mask, gamma, beta, eps=1e-8):
    """Global layer norm of [B, C, F] over the valid frames."""
    m = mask[:, None, :].float()
    count = torch.clamp_min(m.sum(dim=(1, 2), keepdim=True) * x.shape[1], 1.0)
    mean = (x * m).sum(dim=(1, 2), keepdim=True) / count
    var = (((x - mean) * m) ** 2).sum(dim=(1, 2), keepdim=True) / count
    return (x - mean) * torch.rsqrt(var + eps) * gamma[None, :, None] + beta[None, :, None]


def _prelu(x, a):
    return torch.where(x >= 0, x, a * x)


def convtasnet(ops: Ops, sd: SD, c: dict, mix: torch.Tensor, lengths: torch.Tensor):
    """Conv-TasNet: [B, T] mixtures -> [B, n_src, T] estimates."""
    kernel, stride = c["enc_kernel"], c["enc_kernel"] // 2
    w, fmask, sm = _encode(ops, sd["encoder.weight"], mix, lengths, kernel, stride)
    mf = fmask[:, None, :].float()
    h = ops.conv1d(_gln(w, fmask, sd["ln_in.gamma"], sd["ln_in.beta"]), sd["bottleneck.weight"],
                   sd["bottleneck.bias"])
    skips = torch.zeros_like(h)
    for r in range(c["n_repeats"]):
        for xb in range(c["n_blocks"]):
            p = f"tcn_{r}_{xb}."
            d = 2 ** xb
            h1 = _prelu(ops.conv1d(h, sd[p + "in_conv.weight"], sd[p + "in_conv.bias"]),
                        sd[p + "prelu1.alpha"])
            h1 = _gln(h1, fmask, sd[p + "norm1.gamma"], sd[p + "norm1.beta"]) * mf
            h2 = ops.conv1d(h1, sd[p + "dw_conv.weight"], sd[p + "dw_conv.bias"], padding=d,
                            dilation=d, groups=h1.shape[1])
            h2 = _gln(_prelu(h2, sd[p + "prelu2.alpha"]), fmask, sd[p + "norm2.gamma"],
                      sd[p + "norm2.beta"])
            h = h + ops.conv1d(h2, sd[p + "res_conv.weight"], sd[p + "res_conv.bias"])
            skips = skips + ops.conv1d(h2, sd[p + "skip_conv.weight"], sd[p + "skip_conv.bias"])
    m = ops.conv1d(_prelu(skips, sd["mask_prelu.alpha"]), sd["mask_conv.weight"],
                   sd["mask_conv.bias"])
    b, _, f = m.shape
    m = torch.relu(m.reshape(b, c["n_src"], c["enc_dim"], f))
    masked = w[:, None] * m * mf[:, None]
    return _decode(ops, sd["decoder"], masked, mix.shape[1], stride, sm)


def _cln(x, gamma, beta, eps=1e-8):
    mean = x.mean(dim=-1, keepdim=True)
    var = ((x - mean) ** 2).mean(dim=-1, keepdim=True)
    return (x - mean) * torch.rsqrt(var + eps) * gamma + beta


def _depthwise_same(ops: Ops, x, w, b):
    """Depthwise conv of [B, T, C] at stride 1 with "SAME" padding."""
    k = w.shape[-1]
    y = ops.conv1d(F.pad(x.transpose(1, 2), ((k - 1) // 2, k - 1 - (k - 1) // 2)), w, b,
                   groups=x.shape[-1])
    return y.transpose(1, 2)


def gau_attention(ops: Ops, q, k, v, mask, scale, block=1024):
    """relu(q k^T * scale * key mask)^2 v, in blocks of query rows."""
    out = torch.empty(v.shape[:2] + (v.shape[-1],), dtype=torch.float32, device=q.device)
    kt = k.transpose(1, 2)
    m = mask.float()[:, None, :]
    for i in range(0, q.shape[1], block):
        s = ops.matmul(q[:, i:i + block], kt) * scale * m
        out[:, i:i + block] = ops.matmul(torch.relu(s) ** 2, v)
    return out


def mossformer(ops: Ops, sd: SD, c: dict, mix: torch.Tensor, lengths: torch.Tensor):
    """MossFormer as the port runs it: [B, T] mixtures -> [B, n_src, T]; the
    GAU attends over the whole padded sequence with scale 1 / T (T the
    padded frame count)."""
    kernel, stride = c["enc_kernel"], c["enc_kernel"] // 2
    w, fmask, sm = _encode(ops, sd["encoder.weight"], mix, lengths, kernel, stride)
    wt = w.transpose(1, 2)
    h = ops.linear(wt, sd["in_proj.weight"], sd["in_proj.bias"])
    t = h.shape[1]
    mf = fmask[..., None].float()
    for i in range(c["layers"]):
        p = f"gau_{i}."
        g = _cln(h, sd[p + "ln.gamma"], sd[p + "ln.beta"])
        g = g + F.silu(_depthwise_same(ops, g, sd[p + "dwconv.weight"], sd[p + "dwconv.bias"]))
        z = ops.linear(g, sd[p + "to_qk.weight"], sd[p + "to_qk.bias"])
        q = z * sd[p + "gamma"][0] + sd[p + "beta"][0]
        k = z * sd[p + "gamma"][1] + sd[p + "beta"][1]
        u = F.silu(ops.linear(g, sd[p + "to_u.weight"], sd[p + "to_u.bias"]))
        v = F.silu(ops.linear(g, sd[p + "to_v.weight"], sd[p + "to_v.bias"]))
        att = gau_attention(ops, q, k, v, fmask, 1.0 / t)
        h = h + ops.linear(u * att, sd[p + "to_out.weight"], sd[p + "to_out.bias"]) * mf
    m = torch.relu(ops.linear(_cln(h, sd["ln_out.gamma"], sd["ln_out.beta"]),
                              sd["mask_head.weight"], sd["mask_head.bias"]))
    b = m.shape[0]
    m = m.reshape(b, t, c["n_src"], c["enc_dim"]).permute(0, 2, 3, 1)
    return _decode(ops, sd["decoder"], w[:, None] * m, mix.shape[1], stride, sm)


# ------------------------------------------------------------------ speaker embedder
def _bn(x, sd, p, eps=1e-5):
    col = lambda k: sd[p + k][None, :, None, None]  # noqa: E731
    return (x - col("running_mean")) / torch.sqrt(col("running_var") + eps) * col("weight") \
        + col("bias")


def speaker(ops: Ops, sd: SD, c: dict, feats: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """ERes2Net-style embedder: [B, T, 80] log-mel -> [B, embed_dim]."""
    x = F.relu(_bn(ops.conv2d(feats[:, None], sd["stem.weight"], sd["stem.bias"], padding=1),
                   sd, "bn0."))
    for i in range(len(c["channels"])):
        p = f"block_{i}."
        stride = 1 if i == 0 else 2
        y = F.relu(_bn(ops.conv2d(x, sd[p + "in_conv.weight"], sd[p + "in_conv.bias"], stride),
                       sd, p + "bn_in."))
        parts = y.chunk(c["scale"], dim=1)
        outs, prev = [parts[0]], None
        for j in range(1, c["scale"]):
            inp = parts[j] if prev is None else parts[j] + prev
            prev = F.relu(_bn(ops.conv2d(inp, sd[p + f"conv_{j}.weight"],
                                         sd[p + f"conv_{j}.bias"], padding=1), sd, p + f"bn_{j}."))
            outs.append(prev)
        y = _bn(ops.conv2d(torch.cat(outs, dim=1), sd[p + "out_conv.weight"],
                           sd[p + "out_conv.bias"]), sd, p + "bn_out.")
        if p + "short.weight" in sd:
            x = ops.conv2d(x, sd[p + "short.weight"], sd[p + "short.bias"], stride)
        x = F.relu(x + y)
        if i > 0:
            mask = mask[:, ::2][:, : x.shape[2]]
    b, ch, t, f = x.shape
    x = x.permute(0, 2, 3, 1).reshape(b, t, f * ch)
    a = ops.linear(torch.tanh(ops.linear(x, sd["asp.Dense_0.weight"], sd["asp.Dense_0.bias"])),
                   sd["asp.Dense_1.weight"], sd["asp.Dense_1.bias"])
    w = torch.softmax(a.masked_fill(~mask[..., None], -1e9), dim=1)
    mean = (w * x).sum(dim=1)
    std = torch.sqrt((w * (x - mean[:, None]) ** 2).sum(dim=1) + 1e-7)
    return ops.linear(torch.cat([mean, std], dim=-1), sd["proj.weight"], sd["proj.bias"])


# ------------------------------------------------------------------ SenseVoice
def _positions(n: int, d: int, device) -> torch.Tensor:
    pos = np.arange(n, dtype=np.float64)[:, None]
    i = np.arange(d, dtype=np.float64)[None, :]
    ang = pos / np.power(10000.0, (2 * (i // 2)) / d)
    return torch.from_numpy(np.where(i % 2 == 0, np.sin(ang), np.cos(ang)).astype(np.float32)) \
        .to(device)


def _ln(x, sd, p):
    return F.layer_norm(x, x.shape[-1:], sd[p + "weight"], sd[p + "bias"], 1e-6)


def sensevoice(ops: Ops, sd: SD, c: dict, feats: torch.Tensor, mask: torch.Tensor,
               language_id: int = 0, use_itn: bool = True) -> torch.Tensor:
    """[B, T, 560] LFR features + [B, T] mask -> [B, 4 + T, vocab] CTC logits:
    4 prompt frames, sinusoidal positions, pre-LN blocks (attention, a
    depthwise-conv branch, a GELU feed-forward), a final LN, the head."""
    d, heads = c["dim"], c["heads"]
    x = ops.linear(feats, sd["in_proj.weight"], sd["in_proj.bias"])
    b, t = x.shape[:2]
    prompt = torch.cat([sd["lang_embed"][language_id][None], sd["itn_embed"][int(use_itn)][None],
                        sd["prompt_pad"]])
    x = torch.cat([prompt[None].expand(b, -1, -1), x], dim=1)
    n_p = prompt.shape[0]
    mask = torch.cat([torch.ones((b, n_p), dtype=torch.bool, device=x.device), mask.bool()], 1)
    x = x + _positions(t + n_p, d, x.device)[None]
    tt = t + n_p
    bias = torch.zeros(mask.shape, device=x.device).masked_fill(~mask, -1e9)[:, None, None, :]
    mf = mask[..., None].float()
    for i in range(c["layers"]):
        p = f"block_{i}."
        a = p + "MultiHeadSelfAttention_0."
        qkv = ops.linear(_ln(x, sd, p + "LayerNorm_0."), sd[a + "qkv.weight"], sd[a + "qkv.bias"])
        q, k, v = (z.reshape(b, tt, heads, d // heads).transpose(1, 2)
                   for z in qkv.split(d, dim=-1))
        s = ops.matmul(q, k.transpose(-1, -2)) * (1.0 / math.sqrt(d // heads)) + bias
        o = ops.matmul(torch.softmax(s, dim=-1), v).transpose(1, 2).reshape(b, tt, d)
        x = x + ops.linear(o, sd[a + "out.weight"], sd[a + "out.bias"])
        h = _ln(x, sd, p + "LayerNorm_1.") * mf
        x = x + F.silu(_depthwise_same(ops, h, sd[p + "dwconv.weight"], sd[p + "dwconv.bias"]))
        f = F.gelu(ops.linear(_ln(x, sd, p + "LayerNorm_2."), sd[p + "Dense_0.weight"],
                              sd[p + "Dense_0.bias"]), approximate="tanh")
        x = (x + ops.linear(f, sd[p + "Dense_1.weight"], sd[p + "Dense_1.bias"])) * mf
    return ops.linear(_ln(x, sd, "final_ln."), sd["ctc_head.weight"], sd["ctc_head.bias"])


def sensevoice_frontend(ops: Ops, c: dict, wav: torch.Tensor, lengths: torch.Tensor):
    """[B, T] waves -> (LFR features [B, T', 560], mask [B, T'])."""
    feats = apply_lfr(fbank(ops, wav), c["lfr_m"], c["lfr_n"])
    fb = torch.clamp_min(torch.div(lengths - FRAME, SHIFT, rounding_mode="floor") + 1, 0)
    lfr = torch.ceil(fb / c["lfr_n"]).long()
    return feats, _mask(feats.shape[1], torch.clamp_min(lfr, 1))


def ctc_greedy(logits: torch.Tensor, mask: torch.Tensor, cap: int, blank: int = 0) -> list:
    """Per item: argmax a frame, repeats collapsed, blanks dropped, at most
    ``cap`` ids."""
    best = logits.argmax(dim=-1).cpu().numpy()
    valid = mask.cpu().numpy()
    out = []
    for row, ok in zip(best, valid):
        ids, prev = [], blank
        for tok, keep in zip(row, ok):
            if keep and tok != blank and tok != prev:
                ids.append(int(tok))
            prev = tok
        out.append(ids[:cap])
    return out


def decode_text(ids, symbols) -> str:
    """Ids -> text: blanks dropped, ``▁`` a word start."""
    out = []
    for i in ids:
        sym = symbols[i]
        if sym == "<blk>":
            continue
        out.append(" " + sym[1:] if sym.startswith("▁") else sym)
    return "".join(out).strip()
