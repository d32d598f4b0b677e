"""PyanNet, the pyannote.audio segmentation architecture (port of
audio_classification_tpu/models/pyannet.py).

SincNet (a learnable sinc band-pass filterbank, then two conv stages) ->
stacked bidirectional LSTM -> feed-forward head -> per-frame, per-speaker
sigmoid activations: the model under the reference's pyannote
``OverlappedSpeechDetection`` pipeline. A pyannote checkpoint loads through
``convert.torch_import.load_pyannet_torch``; JAX weights through
``convert.from_jax.pyannet_params_to_state_dict``. The module's parameter
names follow the JAX params tree (``sinc.low_hz``, ``lstm.0.bw.weight_ih_l0``,
``linear.0.weight``, ...).

On a padded batch the forward is the JAX module's, item by item:

- the instance norms take their statistics over each item's valid frames
  only (``nn.InstanceNorm1d`` would count the padding);
- after each valid conv, frames past the item's length are zeroed, and max
  pooling floors (torch ``MaxPool1d``);
- the backward LSTM runs over each row's valid prefix reversed, the padding
  kept at the tail (``_reverse_padded``), which ``nn.LSTM(bidirectional=
  True)`` on a padded batch does not do. Each layer and direction is one
  ``nn.LSTM`` call over the whole sequence (cuDNN on the card; the JAX
  forward is a ``lax.scan`` with no kernel under it), the reversal a gather
  on the device: no loop over frames on the host, and no host sync for
  the lengths.

The sinc conv (251 taps) and the LSTM run with TF32 off whoever calls the
model (``ops.signal.no_tf32``): cuDNN would otherwise take TF32 for both.

``rounded_copy`` is the model the engine's bfloat16 mode runs: the JAX
osd_fn applies PyanNet to the float32 wave with every parameter cast to
bfloat16 (engine/runtime.py:499-503, 904-921), and jnp's promotion makes
that a float32 network on bfloat16-rounded weights, but for two sums that
meet only parameters and Python scalars and so stay in bfloat16: the sinc
band edges (``_sinc_filters``: low, high and band) and each LSTM's
``b_ih + b_hh``.
"""
from __future__ import annotations

import copy
import math
from dataclasses import dataclass
from typing import Any, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..ops.signal import no_tf32
from ..ops.work import counted, rnn_work, shape_keyed


@dataclass(frozen=True)
class PyanNetConfig:
    sample_rate: int = 16000
    n_filters: int = 80          # sinc output channels
    kernel_size: int = 251
    stride: int = 10
    min_low_hz: float = 50.0
    min_band_hz: float = 50.0
    analytic: bool = True        # ParamSincFB cos+sin pairs (rows = n_filters//2)
    conv_channels: Tuple[int, ...] = (60, 60)
    conv_kernel: int = 5
    pool: int = 3
    lstm_hidden: int = 128
    lstm_layers: int = 2
    bidirectional: bool = True
    linear_dims: Tuple[int, ...] = (128, 128)
    num_classes: int = 3         # per-frame speaker activations

    @property
    def frame_period(self) -> int:
        """Samples between consecutive output frames."""
        return self.stride * self.pool ** (1 + len(self.conv_channels))

    @property
    def out_frame_sec(self) -> float:
        return self.frame_period / self.sample_rate

    def out_frames(self, n_samples) -> Any:
        """Output frame count for an input of n_samples, an int or a tensor
        (torch floor math: valid sinc conv, then [pool, valid conv] per
        stage)."""
        t = (n_samples - self.kernel_size) // self.stride + 1
        t = t // self.pool
        for _ in self.conv_channels:
            t = t - (self.conv_kernel - 1)
            t = t // self.pool
        return t


def _to_mel(hz):
    return 2595.0 * np.log10(1.0 + hz / 700.0)


def _to_hz(mel):
    return 700.0 * (10.0 ** (mel / 2595.0) - 1.0)


def init_pyannet_params(cfg: PyanNetConfig, seed: int = 0) -> dict:
    """A fresh PyanNet parameter tree with the torch modules' default inits,
    drawn from ``numpy.random.RandomState(seed)`` in the JAX package's
    order (models/pyannet.py: its tree of numpy arrays, bit for bit; the
    port's PyanNet takes it through convert/from_jax.pyannet_params_to_state_dict):
    sinc band edges on the mel scale, conv / LSTM / linear weights and
    biases uniform in +-1/sqrt(fan_in), norms 1 and 0."""
    rng = np.random.RandomState(seed)
    rows = cfg.n_filters // 2 if cfg.analytic else cfg.n_filters
    low_hz, high_hz = 30.0, cfg.sample_rate / 2 - (cfg.min_low_hz + cfg.min_band_hz)
    hz = _to_hz(np.linspace(_to_mel(low_hz), _to_mel(high_hz), rows + 1))

    def lin(fan_out, fan_in):
        b = 1.0 / math.sqrt(fan_in)
        return rng.uniform(-b, b, (fan_out, fan_in)).astype(np.float32)

    def vec(fan_out, fan_in):
        b = 1.0 / math.sqrt(fan_in)
        return rng.uniform(-b, b, (fan_out,)).astype(np.float32)

    params: dict = {
        "wav_norm": {"weight": np.ones(1, np.float32), "bias": np.zeros(1, np.float32)},
        "sinc": {"low_hz": hz[:-1, None].astype(np.float32),
                 "band_hz": np.diff(hz)[:, None].astype(np.float32)},
        "norm0": {"weight": np.ones(cfg.n_filters, np.float32),
                  "bias": np.zeros(cfg.n_filters, np.float32)},
    }
    cin = cfg.n_filters
    for i, ch in enumerate(cfg.conv_channels, start=1):
        b = 1.0 / math.sqrt(cin * cfg.conv_kernel)
        params[f"conv{i}"] = {
            "weight": rng.uniform(-b, b, (ch, cin, cfg.conv_kernel)).astype(np.float32),
            "bias": rng.uniform(-b, b, (ch,)).astype(np.float32),
        }
        params[f"norm{i}"] = {"weight": np.ones(ch, np.float32), "bias": np.zeros(ch, np.float32)}
        cin = ch
    h = cfg.lstm_hidden
    dirs = ("fw", "bw") if cfg.bidirectional else ("fw",)
    lstm = []
    for layer in range(cfg.lstm_layers):
        in_dim = cin if layer == 0 else h * len(dirs)
        lstm.append({d: {"w_ih": lin(4 * h, in_dim), "w_hh": lin(4 * h, h),
                         "b_ih": vec(4 * h, h), "b_hh": vec(4 * h, h)} for d in dirs})
    params["lstm"] = lstm
    cin = h * len(dirs)
    linear = []
    for dim in cfg.linear_dims:
        linear.append({"weight": lin(dim, cin), "bias": vec(dim, cin)})
        cin = dim
    params["linear"] = linear
    params["classifier"] = {"weight": lin(cfg.num_classes, cin),
                            "bias": vec(cfg.num_classes, cin)}
    return params


def sinc_filters(cfg: PyanNetConfig, low_hz: torch.Tensor, band_hz: torch.Tensor) -> torch.Tensor:
    """[n_filters, 1, K] conv weight from the learnable band edges [R, 1]
    (SincConv_fast's construction: the closed-form band-pass left half
    under half a Hamming window, centre 2 * band, the right half mirrored;
    with ``analytic`` the sin filters of asteroid's ParamSincFB below the
    cos ones; all divided by 2 * band)."""
    k, sr = cfg.kernel_size, cfg.sample_rate
    half = (k - 1) // 2
    dev = low_hz.device
    low = cfg.min_low_hz + low_hz.abs()                                  # [R, 1]
    high = torch.clamp(low + cfg.min_band_hz + band_hz.abs(), cfg.min_low_hz, sr / 2)
    band = (high - low)[:, 0]                                            # [R]
    n_lin = torch.linspace(0.0, k / 2 - 1, k // 2, device=dev)
    window = 0.54 - 0.46 * torch.cos(2 * math.pi * n_lin / k)            # [half]
    n_ = 2 * math.pi * torch.arange(-half, 0, dtype=torch.float32, device=dev)[None, :] / sr
    ft_low, ft_high = low * n_, high * n_                                # [R, half]
    denom = n_ / 2
    norm = 2 * band[:, None]
    left_cos = ((torch.sin(ft_high) - torch.sin(ft_low)) / denom) * window
    filters = torch.cat([left_cos, norm, torch.flip(left_cos, dims=(1,))], dim=1) / norm
    if cfg.analytic:
        left_sin = ((torch.cos(ft_low) - torch.cos(ft_high)) / denom) * window
        sin_f = torch.cat([left_sin, torch.zeros_like(norm),
                           -torch.flip(left_sin, dims=(1,))], dim=1) / norm
        filters = torch.cat([filters, sin_f], dim=0)                     # [2R, K]
    return filters[:, None, :]


def _masked_instance_norm(x: torch.Tensor, mask: torch.Tensor, norm: "_Affine",
                          eps: float = 1e-5) -> torch.Tensor:
    """Instance norm (affine) of x [B, C, T] with statistics over the valid
    frames of mask [B, T] only; padded frames come out 0."""
    m = mask[:, None, :].to(x.dtype)
    n = torch.clamp_min(m.sum(dim=2, keepdim=True), 1.0)
    mean = (x * m).sum(dim=2, keepdim=True) / n
    var = ((x - mean) ** 2 * m).sum(dim=2, keepdim=True) / n
    y = (x - mean) * torch.rsqrt(var + eps)
    return (y * norm.weight[None, :, None] + norm.bias[None, :, None]) * m


def _frame_mask(n: int, lengths: torch.Tensor) -> torch.Tensor:
    return torch.arange(n, device=lengths.device)[None, :] < lengths[:, None]


def _reverse_padded(x: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
    """x [B, T, F] with each row's valid prefix reversed, padding kept at
    the tail (a gather on x's device)."""
    pos = torch.arange(x.shape[1], device=x.device)[None, :]
    idx = lengths[:, None] - 1 - pos
    idx = torch.where(idx >= 0, idx, pos)
    return torch.gather(x, 1, idx[..., None].expand(-1, -1, x.shape[2]))


class _Affine(nn.Module):
    """An instance norm's weight and bias."""

    def __init__(self, n: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(n))
        self.bias = nn.Parameter(torch.zeros(n))


class _SincBands(nn.Module):
    """The sinc filterbank's band edges, [R, 1] each."""

    def __init__(self, rows: int):
        super().__init__()
        self.low_hz = nn.Parameter(torch.zeros(rows, 1))
        self.band_hz = nn.Parameter(torch.zeros(rows, 1))


@counted(lambda lstm, x: rnn_work(x.shape[1], x.shape[0], x.shape[2], lstm.hidden_size,
                                  itemsize=x.element_size()))
def _lstm(lstm: nn.LSTM, x: torch.Tensor) -> torch.Tensor:
    """One batch-first LSTM over x [B, T, F] -> its outputs [B, T, H]. A
    work count (ops/work) takes ``rnn_work`` on either device, not cuDNN's
    fused op on the card or the CPU's decomposition."""
    return lstm(x)[0]


class PyanNet(nn.Module):
    """``forward(wav [B, T], lengths [B])`` -> per-frame class
    probabilities [B, T', num_classes] (sigmoid, multilabel: pyannote's
    segmentation activation), zero past each item's valid frame count."""

    def __init__(self, cfg: PyanNetConfig = PyanNetConfig()):
        super().__init__()
        self.cfg = c = cfg
        self.wav_norm = _Affine(1)
        self.sinc = _SincBands(c.n_filters // 2 if c.analytic else c.n_filters)
        self.norm0 = _Affine(c.n_filters)
        cin = c.n_filters
        for i, ch in enumerate(c.conv_channels, start=1):
            self.add_module(f"conv{i}", nn.Conv1d(cin, ch, c.conv_kernel))
            self.add_module(f"norm{i}", _Affine(ch))
            cin = ch
        dirs = ("fw", "bw") if c.bidirectional else ("fw",)
        self.lstm = nn.ModuleList()
        for layer in range(c.lstm_layers):
            in_dim = cin if layer == 0 else c.lstm_hidden * len(dirs)
            self.lstm.append(nn.ModuleDict(
                {d: nn.LSTM(in_dim, c.lstm_hidden, batch_first=True) for d in dirs}))
        cin = c.lstm_hidden * len(dirs)
        self.linear = nn.ModuleList()
        for dim in c.linear_dims:
            self.linear.append(nn.Linear(cin, dim))
            cin = dim
        self.classifier = nn.Linear(cin, c.num_classes)
        #: the dtype of the sinc band-edge arithmetic (``rounded_copy``)
        self.edge_dtype = torch.float32

    def init(self, seed: int = 0) -> "PyanNet":
        """Fresh weights, ``init_pyannet_params(cfg, seed)`` (the JAX
        ``PyanNet.init``), loaded into this module; -> self."""
        from ..convert.from_jax import pyannet_params_to_state_dict

        self.load_state_dict(pyannet_params_to_state_dict(init_pyannet_params(self.cfg, seed)))
        return self

    @shape_keyed
    def forward(self, wav: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
        with no_tf32():
            return self._forward(wav, lengths)

    def _forward(self, wav: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
        c = self.cfg
        lengths = lengths.long()
        x = wav.float()[:, None, :]                                       # [B, 1, T]
        x = _masked_instance_norm(x, _frame_mask(x.shape[2], lengths), self.wav_norm)
        edges = (self.sinc.low_hz.to(self.edge_dtype), self.sinc.band_hz.to(self.edge_dtype))
        x = F.conv1d(x, sinc_filters(c, *edges).float(), stride=c.stride)
        x = F.max_pool1d(x.abs(), c.pool)
        flen = torch.clamp_min((lengths - c.kernel_size) // c.stride + 1, 0) // c.pool
        mask = _frame_mask(x.shape[2], flen)
        x = F.leaky_relu(_masked_instance_norm(x, mask, self.norm0))
        for i in range(1, 1 + len(c.conv_channels)):
            x = getattr(self, f"conv{i}")(x)
            flen = torch.clamp_min(flen - (c.conv_kernel - 1), 0)
            # zero padding leaking into the valid tail through the conv
            x = x * _frame_mask(x.shape[2], flen)[:, None, :]
            x = F.max_pool1d(x, c.pool)
            flen = flen // c.pool
            mask = _frame_mask(x.shape[2], flen)
            x = F.leaky_relu(_masked_instance_norm(x, mask, getattr(self, f"norm{i}")))

        x = x.transpose(1, 2)                                             # [B, T', F]
        for layer in self.lstm:
            fw = _lstm(layer["fw"], x)
            if c.bidirectional:
                bw = _lstm(layer["bw"], _reverse_padded(x, flen))
                x = torch.cat([fw, _reverse_padded(bw, flen)], dim=-1)
            else:
                x = fw
            x = x * mask[..., None]
        for lin in self.linear:
            x = F.leaky_relu(lin(x))
        return torch.sigmoid(self.classifier(x)) * mask[..., None]


def rounded_copy(model: PyanNet, dtype: torch.dtype) -> PyanNet:
    """The JAX PyanNet on parameters cast to ``dtype`` (bfloat16), as a
    float32 model: every weight rounded to ``dtype`` and held in float32,
    the sinc band edges computed in ``dtype`` (``edge_dtype``), and each
    LSTM's two biases replaced by their sum rounded to ``dtype`` (the JAX
    ``b_ih + b_hh``, models/pyannet.py:223) with ``b_hh`` zero. The wave,
    the SincNet, the cuDNN LSTMs and the head stay float32.

    The JAX forward itself raises at bf16 params (its ``lax.conv`` of the
    two conv stages refuses a float32 input with a bfloat16 kernel,
    ROADMAP §3); this is what jnp's promotion gives at every other op, with
    the conv kernels widened to float32 as the promotion would widen them."""
    out = copy.deepcopy(model).float()
    with torch.no_grad():
        for p in out.parameters():
            p.copy_(p.to(dtype))
        for layer in out.lstm:
            for lstm in layer.values():
                for k in range(lstm.num_layers):
                    b_ih, b_hh = getattr(lstm, f"bias_ih_l{k}"), getattr(lstm, f"bias_hh_l{k}")
                    b_ih.copy_(b_ih.to(dtype) + b_hh.to(dtype))
                    b_hh.zero_()
    out.edge_dtype = dtype
    return out.requires_grad_(False)


@dataclass(frozen=True)
class BinarizeConfig:
    """pyannote ``Binarize`` hyperparameters (onset / offset hysteresis and
    duration pruning; reference: src/osd/osd.py:64-70)."""

    onset: float = 0.5
    offset: float = 0.5
    min_duration_on: float = 0.0
    min_duration_off: float = 0.0
    pad_onset: float = 0.0
    pad_offset: float = 0.0


def hysteresis_intervals(probs: np.ndarray, frame_sec: float, bc: BinarizeConfig) -> list:
    """Frame scores -> [(start_sec, end_sec)] active intervals.

    pyannote Binarize semantics: a region opens when the score rises above
    ``onset`` and closes when it falls below ``offset``; regions are then
    padded, gaps shorter than ``min_duration_off`` are filled, and regions
    shorter than ``min_duration_on`` are dropped (in that order)."""
    p = np.asarray(probs, np.float64)
    regions = []
    active = False
    start = 0.0
    for i, v in enumerate(p):
        t = (i + 0.5) * frame_sec
        if not active and v > bc.onset:
            active, start = True, t
        elif active and v < bc.offset:
            regions.append((start, t))
            active = False
    if active:
        regions.append((start, len(p) * frame_sec))
    regions = [(s - bc.pad_onset, e + bc.pad_offset) for s, e in regions]
    merged: list = []
    for s, e in regions:
        if merged and s - merged[-1][1] < bc.min_duration_off:
            merged[-1] = (merged[-1][0], max(merged[-1][1], e))
        else:
            merged.append((s, e))
    return [(max(s, 0.0), e) for s, e in merged if e - s >= bc.min_duration_on]


def reduce_overlap_channels(probs: torch.Tensor) -> torch.Tensor:
    """[B, T', C] speaker activations -> [B, T', 2] (speech, overlap): the
    largest activation and the second largest (two speakers at once), as
    pyannote's OverlappedSpeechDetection scores a frame; the engine's OSD
    channel contract (models/osd.py)."""
    if probs.shape[-1] < 2:
        sp = probs[..., 0]
        return torch.stack([sp, torch.zeros_like(sp)], dim=-1)
    return torch.topk(probs, 2, dim=-1).values
