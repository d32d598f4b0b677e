"""Weights made from the seed on the device, handed alike to the program and
to the plain reference.

Each model's tensors are listed by ``spec`` (the port's state-dict names and
shapes, which ``load_state_dict`` holds the program to strictly) and filled
from ONE draw of a ``torch.Generator`` on the device per model, cut into
leaves: matrices and filters N(0, 1 / fan_in), biases, shifts and
embeddings N(0, 0.02^2), scales 1 + N(0, 0.05^2), PReLU slopes 0.25,
BatchNorm running means N(0, 0.05^2) and variances exp(N(0, 0.1^2)). The
PyanNet checkpoint is written under pyannote's own names (a pytorch-lightning
file), which the port reads through its pyannote importer and the reference
through its own renames.
"""
from __future__ import annotations

import math
from typing import Callable, Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch

Spec = List[Tuple[str, tuple, str]]
STAGE_TAG = {"osd": 1, "sep3": 2, "mossformer": 3, "spk": 4, "asr": 5}


def _lin(name: str, cout: int, cin: int, bias: bool = True) -> Iterator:
    yield f"{name}.weight", (cout, cin), "w"
    if bias:
        yield f"{name}.bias", (cout,), "b"


def _conv1d(name: str, cout: int, cin: int, k: int, bias: bool = True) -> Iterator:
    yield f"{name}.weight", (cout, cin, k), "w"
    if bias:
        yield f"{name}.bias", (cout,), "b"


def _norm(name: str, n: int, scale: str = "gamma", shift: str = "beta") -> Iterator:
    yield f"{name}.{scale}", (n,), "g"
    yield f"{name}.{shift}", (n,), "b"


def convtasnet_spec(c: dict) -> Spec:
    n, b, h, s = c["enc_dim"], c["bottleneck"], c["hidden"], c["n_src"]
    out = [("encoder.weight", (n, 1, c["enc_kernel"]), "w"), *_norm("ln_in", n),
           *_conv1d("bottleneck", b, n, 1)]
    for r in range(c["n_repeats"]):
        for x in range(c["n_blocks"]):
            p = f"tcn_{r}_{x}"
            out += [*_conv1d(f"{p}.in_conv", h, b, 1), (f"{p}.prelu1.alpha", (1,), "a"),
                    *_norm(f"{p}.norm1", h), *_conv1d(f"{p}.dw_conv", h, 1, c["conv_kernel"]),
                    (f"{p}.prelu2.alpha", (1,), "a"), *_norm(f"{p}.norm2", h),
                    *_conv1d(f"{p}.res_conv", b, h, 1), *_conv1d(f"{p}.skip_conv", b, h, 1)]
    out += [("mask_prelu.alpha", (1,), "a"), *_conv1d("mask_conv", s * n, b, 1),
            ("decoder", (c["enc_kernel"], n), "dec")]
    return out


def mossformer_spec(c: dict) -> Spec:
    n, d, de, qk = c["enc_dim"], c["dim"], c["dim"] * c["expansion"], c["qk_dim"]
    out = [("encoder.weight", (n, 1, c["enc_kernel"]), "w"), *_lin("in_proj", d, n)]
    for i in range(c["layers"]):
        p = f"gau_{i}"
        out += [*_norm(f"{p}.ln", d), *_conv1d(f"{p}.dwconv", d, 1, c["conv_kernel"]),
                *_lin(f"{p}.to_u", de, d), *_lin(f"{p}.to_v", de, d), *_lin(f"{p}.to_qk", qk, d),
                (f"{p}.gamma", (2, qk), "g"), (f"{p}.beta", (2, qk), "b"),
                *_lin(f"{p}.to_out", d, de)]
    out += [*_norm("ln_out", d), *_lin("mask_head", c["n_src"] * n, d),
            ("decoder", (c["enc_kernel"], n), "dec")]
    return out


def _bn(name: str, ch: int) -> Spec:
    return [(f"{name}.weight", (ch,), "g"), (f"{name}.bias", (ch,), "b"),
            (f"{name}.running_mean", (ch,), "rm"), (f"{name}.running_var", (ch,), "rv"),
            (f"{name}.num_batches_tracked", (), "nbt")]


def speaker_spec(c: dict) -> Spec:
    ch0 = c["channels"][0]
    out = [("stem.weight", (ch0, 1, 3, 3), "w"), ("stem.bias", (ch0,), "b"), *_bn("bn0", ch0)]
    cin, freq = ch0, c["num_mel"]
    for i, ch in enumerate(c["channels"]):
        stride = 1 if i == 0 else 2
        w = ch // c["scale"]
        p = f"block_{i}"
        out += [(f"{p}.in_conv.weight", (ch, cin, 1, 1), "w"), (f"{p}.in_conv.bias", (ch,), "b"),
                *_bn(f"{p}.bn_in", ch)]
        for j in range(1, c["scale"]):
            out += [(f"{p}.conv_{j}.weight", (w, w, 3, 3), "w"), (f"{p}.conv_{j}.bias", (w,), "b"),
                    *_bn(f"{p}.bn_{j}", w)]
        out += [(f"{p}.out_conv.weight", (ch, ch, 1, 1), "w"),
                (f"{p}.out_conv.bias", (ch,), "b"), *_bn(f"{p}.bn_out", ch)]
        if stride > 1 or cin != ch:
            out += [(f"{p}.short.weight", (ch, cin, 1, 1), "w"), (f"{p}.short.bias", (ch,), "b")]
        cin, freq = ch, -(-freq // stride)
    flat = freq * cin
    out += [*_lin("asp.Dense_0", c["asp_hidden"], flat),
            *_lin("asp.Dense_1", flat, c["asp_hidden"]), *_lin("proj", c["embed_dim"], 2 * flat)]
    return out


SPECS = {"sep3": convtasnet_spec, "mossformer": mossformer_spec, "spk": speaker_spec}


def fill(spec: Spec, seed: int, tag: int, device) -> Dict[str, torch.Tensor]:
    """One N(0, 1) draw for the whole model, cut and scaled leaf by kind."""
    gen = torch.Generator(device=device).manual_seed((int(seed) * 16 + tag) % 2**63)
    sizes = [int(np.prod(shape)) for _, shape, _ in spec]
    flat = torch.randn(sum(sizes), generator=gen, device=device, dtype=torch.float32)
    out, off = {}, 0
    for (name, shape, kind), n in zip(spec, sizes):
        z = flat[off:off + n].view(shape)
        off += n
        if kind == "w":
            t = z * (float(np.prod(shape[1:])) ** -0.5)
        elif kind == "dec":
            t = z * (shape[0] ** -0.5)
        elif kind == "b":
            t = 0.02 * z
        elif kind == "g":
            t = 1.0 + 0.05 * z
        elif kind == "a":
            t = torch.full(shape, 0.25, device=device)
        elif kind == "rm":
            t = 0.05 * z
        elif kind == "rv":
            t = torch.exp(0.1 * z)
        elif kind == "nbt":
            t = torch.zeros((), dtype=torch.int64, device=device)
        else:
            raise ValueError(f"unknown leaf kind {kind!r}")
        out[name] = t.contiguous()
    return out


def stage_weights(stage: str, cfg: dict, seed: int, device,
                  spec: Optional[Callable[[dict], Spec]] = None) -> Dict[str, torch.Tensor]:
    """The state dict of ``stage`` ("sep3", "mossformer", "spk", or "asr"
    with its family's ``spec``) at ``cfg``'s widths for ``seed``, on
    ``device``."""
    return fill((spec or SPECS[stage])(cfg), seed, STAGE_TAG[stage], device)


def pyannote_state_dict(w: dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """PyanNet at widths ``w`` (rows, n_filters, conv, kernel, hidden, layers,
    linear, classes) under pyannote's names: mel-spaced sinc band edges from
    30 Hz to 7.9 kHz with a seeded jitter, instance-norm scales 1 + N(0,
    0.1^2), everything else uniform in +-1 / sqrt(fan_in) (torch's default
    init scale), from one draw on the device."""
    sizes: List[Tuple[str, tuple, float]] = []
    cin = w["n_filters"]
    for i, ch in enumerate(w["conv"], start=1):
        bound = (cin * w["kernel"]) ** -0.5
        sizes += [(f"sincnet.conv1d.{i}.weight", (ch, cin, w["kernel"]), bound),
                  (f"sincnet.conv1d.{i}.bias", (ch,), bound)]
        cin = ch
    h = w["hidden"]
    for layer in range(w["layers"]):
        for sfx in ("", "_reverse"):
            sizes += [(f"lstm.weight_ih_l{layer}{sfx}", (4 * h, cin), h ** -0.5),
                      (f"lstm.weight_hh_l{layer}{sfx}", (4 * h, h), h ** -0.5),
                      (f"lstm.bias_ih_l{layer}{sfx}", (4 * h,), h ** -0.5),
                      (f"lstm.bias_hh_l{layer}{sfx}", (4 * h,), h ** -0.5)]
        cin = 2 * h
    for j, dim in enumerate(w["linear"]):
        sizes += [(f"linear.{j}.weight", (dim, cin), cin ** -0.5),
                  (f"linear.{j}.bias", (dim,), cin ** -0.5)]
        cin = dim
    sizes += [("classifier.weight", (w["classes"], cin), cin ** -0.5),
              ("classifier.bias", (w["classes"],), cin ** -0.5)]
    norms = [("sincnet.norm1d.0", w["n_filters"])] + [
        (f"sincnet.norm1d.{i}", ch) for i, ch in enumerate(w["conv"], start=1)]
    gen = torch.Generator(device=device).manual_seed((int(seed) * 16 + STAGE_TAG["osd"]) % 2**63)
    n_uni = sum(int(np.prod(s)) for _, s, _ in sizes)
    n_norm = sum(2 * n for _, n in norms) + w["rows"] + 1
    uni = torch.rand(n_uni, generator=gen, device=device) * 2.0 - 1.0
    nrm = torch.randn(n_norm, generator=gen, device=device)
    sd: Dict[str, torch.Tensor] = {}
    off = 0
    for name, shape, bound in sizes:
        n = int(np.prod(shape))
        sd[name] = (bound * uni[off:off + n]).view(shape).contiguous()
        off += n
    off = 0
    for name, n in norms:
        sd[f"{name}.weight"] = 1.0 + 0.1 * nrm[off:off + n]
        sd[f"{name}.bias"] = 0.1 * nrm[off + n:off + 2 * n]
        off += 2 * n
    lo, hi = 2595 * math.log10(1 + 30 / 700), 2595 * math.log10(1 + 7900 / 700)
    mel = torch.linspace(lo, hi, w["rows"] + 1, device=device) + 5.0 * nrm[off:off + w["rows"] + 1]
    hz = 700 * (10 ** (mel / 2595) - 1)
    sd["sincnet.conv1d.0.filterbank.low_hz_"] = (hz[:-1, None] - 50.0).contiguous()
    sd["sincnet.conv1d.0.filterbank.band_hz_"] = (torch.diff(hz)[:, None] - 50.0).contiguous()
    sd["sincnet.wav_norm1d.weight"] = torch.ones(1, device=device)
    sd["sincnet.wav_norm1d.bias"] = torch.zeros(1, device=device)
    return sd


def write_pyannote_checkpoint(path: str, w: dict, seed: int, device) -> None:
    """``pyannote_state_dict`` as a pytorch-lightning checkpoint file."""
    sd = pyannote_state_dict(w, seed, device)
    torch.save({"state_dict": {k: v.cpu() for k, v in sd.items()}, "epoch": 0}, path)

