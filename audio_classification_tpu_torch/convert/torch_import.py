"""Torch checkpoints -> the port's state_dicts (port of
audio_classification_tpu/models/convert/torch_import.py).

The reference loads asteroid Conv-TasNet weights, the ModelScope / ClearVoice
MossFormer and pyannote's segmentation model (PyanNet) from local torch
files (reference: separation.py:105-163, src/mossformer/infer.py:13-23,
src/osd/osd.py:60-71). The port's modules keep torch layouts, so each
importer only renames: it matches the checkpoint's tensors by name and role
and returns a ``state_dict`` for ``load_state_dict`` (PyanNet: its config,
inferred from the tensor shapes, with it). No network: files must be local.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from ..models.convtasnet import ConvTasNetConfig
from ..models.mossformer import MossFormer, MossFormerConfig
from ..models.pyannet import PyanNetConfig

StateDict = Dict[str, torch.Tensor]


def _load_state_dict(path: str) -> StateDict:
    """The tensors of a torch file, unwrapped from a ``state_dict`` /
    ``model_state_dict`` / ``model`` entry (pytorch-lightning and trainer
    checkpoints). ``weights_only=False``, as the reference loads them: a
    lightning checkpoint pickles more than tensors."""
    ckpt = torch.load(path, map_location="cpu", weights_only=False)
    if isinstance(ckpt, dict):
        for key in ("state_dict", "model_state_dict", "model"):
            if key in ckpt and isinstance(ckpt[key], dict):
                ckpt = ckpt[key]
                break
    return {k: v.detach().cpu() for k, v in ckpt.items() if hasattr(v, "detach")}


def _f32(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.float32).contiguous()


def load_convtasnet_torch(path: str, cfg: ConvTasNetConfig) -> StateDict:
    """An asteroid ConvTasNet checkpoint -> the port's ConvTasNet state_dict.

    asteroid names: encoder.filterbank._filters [N, 1, L], decoder.filterbank.
    _filters [N, 1, L], masker.bottleneck.{0,1}, masker.TCN.{i}.shared_block.
    {0..5} / res_conv / skip_conv, masker.mask_net.{0,1}. A missing tensor
    raises KeyError."""
    sd = _load_state_dict(path)

    def want(name: str) -> torch.Tensor:
        for k in sd:
            if k.endswith(name) or name in k:
                return sd[k]
        raise KeyError(f"torch checkpoint missing tensor matching '{name}'")

    out = {
        "encoder.weight": want("encoder.filterbank._filters"),                # [N, 1, L]
        "decoder": want("decoder.filterbank._filters")[:, 0, :].T,           # [L, N]
        "ln_in.gamma": want("masker.bottleneck.0.gamma").reshape(-1),
        "ln_in.beta": want("masker.bottleneck.0.beta").reshape(-1),
        "bottleneck.weight": want("masker.bottleneck.1.weight"),              # [B, N, 1]
        "bottleneck.bias": want("masker.bottleneck.1.bias"),
        "mask_prelu.alpha": want("masker.mask_net.0.weight").reshape(1),
        "mask_conv.weight": want("masker.mask_net.1.weight"),                 # [S N, B, 1]
        "mask_conv.bias": want("masker.mask_net.1.bias"),
    }
    block = {"in_conv.weight": "shared_block.0.weight", "in_conv.bias": "shared_block.0.bias",
             "prelu1.alpha": "shared_block.1.weight", "norm1.gamma": "shared_block.2.gamma",
             "norm1.beta": "shared_block.2.beta", "dw_conv.weight": "shared_block.3.weight",
             "dw_conv.bias": "shared_block.3.bias", "prelu2.alpha": "shared_block.4.weight",
             "norm2.gamma": "shared_block.5.gamma", "norm2.beta": "shared_block.5.beta",
             "res_conv.weight": "res_conv.weight", "res_conv.bias": "res_conv.bias",
             "skip_conv.weight": "skip_conv.weight", "skip_conv.bias": "skip_conv.bias"}
    for r in range(cfg.n_repeats):
        for x in range(cfg.n_blocks):
            i = r * cfg.n_blocks + x
            for ours, theirs in block.items():
                t = sd[f"masker.TCN.{i}.{theirs}"]
                out[f"tcn_{r}_{x}.{ours}"] = t.reshape(1) if "prelu" in ours else (
                    t.reshape(-1) if ".gamma" in ours or ".beta" in ours else t)
    return {k: _f32(v) for k, v in out.items()}


class MossFormerImportError(RuntimeError):
    """Structured MossFormer import failure: lists every unmatched role and
    every leftover checkpoint tensor so naming drift is diagnosable."""

    def __init__(self, missing, shape_errors, unused):
        self.missing = list(missing)
        self.shape_errors = list(shape_errors)
        self.unused = list(unused)
        lines = ["MossFormer torch checkpoint does not map onto this architecture."]
        if missing:
            lines.append("  roles with no matching tensor:")
            lines += [f"    - {m}" for m in missing]
        if shape_errors:
            lines.append("  shape mismatches (role: got vs want):")
            lines += [f"    - {e}" for e in shape_errors]
        if unused:
            lines.append(f"  checkpoint tensors left unmatched ({len(unused)}):")
            lines += [f"    - {k}" for k in unused[:20]]
            if len(unused) > 20:
                lines.append(f"    ... and {len(unused) - 20} more")
        lines.append(
            "  The ModelScope `speech_mossformer_separation_temporal_8k` "
            "distribution's exact naming is unverifiable offline "
            "(reference: src/mossformer/infer.py:13-23); this importer keys "
            "on the published ClearVoice/ModelScope module naming. If your "
            "checkpoint drifts, re-export to ONNX or rename per the roles above.")
        super().__init__("\n".join(lines))


def load_mossformer_torch(path: str, cfg: MossFormerConfig = None) -> StateDict:
    """A ModelScope / ClearVoice MossFormer checkpoint -> the port's
    MossFormer state_dict, matched by ROLE over the naming variants the
    reference accepts (``mask_net.mdl.mossformerM.layers.{i}``,
    ``mask_net.layers.{i}``, ...). Any unmatched role, leftover weight or
    shape mismatch raises :class:`MossFormerImportError` listing
    everything at once."""
    cfg = cfg or MossFormerConfig()
    sd = _load_state_dict(path)
    for pre in ("model.", "module.", "separator."):
        if all(k.startswith(pre) for k in sd):
            sd = {k[len(pre):]: v for k, v in sd.items()}
    shapes = {k: tuple(v.shape) for k, v in MossFormer(cfg).state_dict().items()}

    matched = set()
    missing, shape_errors = [], []
    out: StateDict = {}

    def find(cands):
        """First tensor whose key equals / ends with any candidate suffix."""
        for c in cands:
            for k in sd:
                if k == c or k.endswith("." + c) or k.endswith(c):
                    matched.add(k)
                    return k, sd[k]
        return None, None

    def take(key, role, cands, transform=lambda v: v):
        k, v = find(cands)
        if v is None:
            missing.append(f"{role} (tried: {', '.join(cands)})")
            return
        try:
            val = transform(v)
        except Exception as e:  # a reshape of a wrong-size tensor
            shape_errors.append(f"{role}: {k} has shape {tuple(v.shape)} ({e})")
            return
        if tuple(val.shape) != shapes[key]:
            shape_errors.append(f"{role}: {k} -> {tuple(val.shape)} vs want {shapes[key]}")
            return
        out[key] = _f32(val)

    def lin_w(v):
        """torch Linear [out, in], or a 1x1 Conv1d [out, in, 1]."""
        return v[..., 0] if v.ndim == 3 and v.shape[-1] == 1 else v

    flat = lambda v: v.reshape(-1)  # noqa: E731
    take("encoder.weight", "encoder", ["encoder.conv1d.weight", "encoder.weight"])
    take("in_proj.weight", "in_proj.weight",
         ["mask_net.conv1d_encoder.weight", "mask_net.bottleneck.weight", "in_proj.weight"], lin_w)
    take("in_proj.bias", "in_proj.bias",
         ["mask_net.conv1d_encoder.bias", "mask_net.bottleneck.bias", "in_proj.bias"], flat)
    for i in range(cfg.layers):
        stems = [f"mask_net.mdl.mossformerM.layers.{i}", f"mask_net.mdl.layers.{i}",
                 f"mask_net.layers.{i}", f"layers.{i}"]
        for key, names, tf in (
                ("ln.gamma", ["norm.weight", "ln.weight", "norm.gamma"], flat),
                ("ln.beta", ["norm.bias", "ln.bias", "norm.beta"], flat),
                ("dwconv.weight", ["conv.weight", "dwconv.weight"], lambda v: v),
                ("dwconv.bias", ["conv.bias", "dwconv.bias"], flat),
                ("to_u.weight", ["to_u.weight", "to_hidden.u.weight"], lin_w),
                ("to_u.bias", ["to_u.bias", "to_hidden.u.bias"], flat),
                ("to_v.weight", ["to_v.weight", "to_hidden.v.weight"], lin_w),
                ("to_v.bias", ["to_v.bias", "to_hidden.v.bias"], flat),
                ("to_qk.weight", ["to_qk.weight"], lin_w),
                ("to_qk.bias", ["to_qk.bias"], flat),
                ("gamma", ["offset_scale.gamma", "qk_offset_scale.gamma"],
                 lambda v: v.reshape(2, cfg.qk_dim)),
                ("beta", ["offset_scale.beta", "qk_offset_scale.beta"],
                 lambda v: v.reshape(2, cfg.qk_dim)),
                ("to_out.weight", ["to_out.weight"], lin_w),
                ("to_out.bias", ["to_out.bias"], flat)):
            take(f"gau_{i}.{key}", f"layer{i}.{names[0]}",
                 [f"{s}.{n}" for n in names for s in stems], tf)
    take("ln_out.gamma", "ln_out.weight",
         ["mask_net.norm_out.weight", "ln_out.weight", "mask_net.norm_out.gamma"], flat)
    take("ln_out.beta", "ln_out.bias",
         ["mask_net.norm_out.bias", "ln_out.bias", "mask_net.norm_out.beta"], flat)
    take("mask_head.weight", "mask_head.weight",
         ["mask_net.mask_head.weight", "mask_net.conv1d_out.weight", "mask_head.weight"], lin_w)
    take("mask_head.bias", "mask_head.bias",
         ["mask_net.mask_head.bias", "mask_net.conv1d_out.bias", "mask_head.bias"], flat)
    # decoder: a ConvTranspose1d [enc_dim, 1, K] -> [K, enc_dim]
    take("decoder", "decoder", ["decoder.weight"], lambda v: v[:, 0, :].T if v.ndim == 3 else v)

    # non-parameter buffers (rotary tables, bookkeeping) may ride along in a
    # real checkpoint; only unmatched WEIGHTS indicate a naming / arch mismatch
    buffers = ("num_batches_tracked", "rotary", "freqs", "pe", "position")
    unused = sorted(k for k in sd if k not in matched and not any(b in k.lower() for b in buffers))
    if missing or shape_errors or unused:
        raise MossFormerImportError(missing, shape_errors, unused)
    return out


def load_pyannet_torch(path: str, sample_rate: int = 16000, kernel_size: int = 251,
                       stride: int = 10) -> Tuple[PyanNetConfig, StateDict]:
    """A pyannote segmentation checkpoint -> (PyanNetConfig, the port's
    PyanNet state_dict).

    pyannote stores the model as a pytorch-lightning checkpoint under the
    PyanNet naming (``sincnet.conv1d.0.filterbank.low_hz_``,
    ``lstm.weight_ih_l0``, ``linear.0.weight``, ``classifier.weight`` ...).
    Everything architectural is inferred from tensor shapes; only the sinc
    kernel size and stride (not stored: the filters are synthesised from
    their band edges) come from arguments, pyannote's 251 / 10 by
    default. Both LSTM biases are kept (the forward adds both)."""
    sd = _load_state_dict(path)
    sd = {(k[len("model."):] if k.startswith("model.") else k): v for k, v in sd.items()}

    def want(name: str) -> torch.Tensor:
        for k in sd:
            if k == name or k.endswith(name):
                return sd[k]
        raise KeyError(f"pyannet checkpoint missing tensor '{name}'")

    low = want("sincnet.conv1d.0.filterbank.low_hz_").reshape(-1, 1)
    band = want("sincnet.conv1d.0.filterbank.band_hz_").reshape(-1, 1)
    n_out = int(want("sincnet.norm1d.0.weight").shape[0])
    if low.shape[0] == n_out:
        analytic = False
    elif 2 * low.shape[0] == n_out:
        analytic = True
    else:
        raise ValueError(f"sinc parameter rows ({low.shape[0]}) match neither the "
                         f"filter count ({n_out}) nor half of it")
    conv_channels = []
    while f"sincnet.conv1d.{len(conv_channels) + 1}.weight" in sd:
        conv_channels.append(int(sd[f"sincnet.conv1d.{len(conv_channels) + 1}.weight"].shape[0]))
    if not conv_channels:
        raise ValueError("pyannet checkpoint has no sincnet.conv1d.{1..} stages")
    lstm_layers = 0
    while f"lstm.weight_ih_l{lstm_layers}" in sd:
        lstm_layers += 1
    if lstm_layers == 0:
        raise ValueError("pyannet checkpoint has no lstm.weight_ih_l0")
    linear_dims = []
    while f"linear.{len(linear_dims)}.weight" in sd:
        linear_dims.append(int(sd[f"linear.{len(linear_dims)}.weight"].shape[0]))
    bidirectional = "lstm.weight_ih_l0_reverse" in sd
    cls_w = want("classifier.weight")
    cfg = PyanNetConfig(
        sample_rate=sample_rate, n_filters=n_out, kernel_size=kernel_size, stride=stride,
        analytic=analytic, conv_channels=tuple(conv_channels),
        conv_kernel=int(sd["sincnet.conv1d.1.weight"].shape[2]),
        lstm_hidden=int(sd["lstm.weight_hh_l0"].shape[1]), lstm_layers=lstm_layers,
        bidirectional=bidirectional, linear_dims=tuple(linear_dims),
        num_classes=int(cls_w.shape[0]))

    out = {"wav_norm.weight": want("sincnet.wav_norm1d.weight").reshape(-1),
           "wav_norm.bias": want("sincnet.wav_norm1d.bias").reshape(-1),
           "sinc.low_hz": low, "sinc.band_hz": band,
           "norm0.weight": want("sincnet.norm1d.0.weight"),
           "norm0.bias": want("sincnet.norm1d.0.bias"),
           "classifier.weight": cls_w, "classifier.bias": want("classifier.bias")}
    for j in range(1, 1 + len(conv_channels)):
        for part in ("weight", "bias"):
            out[f"conv{j}.{part}"] = sd[f"sincnet.conv1d.{j}.{part}"]
            out[f"norm{j}.{part}"] = sd[f"sincnet.norm1d.{j}.{part}"]
    for layer in range(lstm_layers):
        for direction, sfx in (("fw", ""), ("bw", "_reverse")):
            if direction == "bw" and not bidirectional:
                continue
            for part in ("weight_ih", "weight_hh", "bias_ih", "bias_hh"):
                out[f"lstm.{layer}.{direction}.{part}_l0"] = sd[f"lstm.{part}_l{layer}{sfx}"]
    for j in range(len(linear_dims)):
        for part in ("weight", "bias"):
            out[f"linear.{j}.{part}"] = sd[f"linear.{j}.{part}"]
    return cfg, {k: _f32(v) for k, v in out.items()}
