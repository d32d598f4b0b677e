"""Carry the JAX package's ModelPack weights into the port.

``params_to_state_dicts`` maps each stage's flax variable tree (``params``
and, for the speaker embedder, ``batch_stats``) onto the ``state_dict`` of
the port's module of the same stage. The port names its submodules after
the flax param paths, so keys map by path; only the leaves change layout:

  Dense kernel [in, out]            -> Linear weight [out, in]
  Conv1d kernel [K, Cin/g, Cout]    -> weight [Cout, Cin/g, K]
  nn.Conv kernel [kh, kw, in, out]  -> Conv2d weight [out, in, kh, kw]
  LayerNorm / BatchNorm scale       -> weight
  nn.Embed embedding [V, D]         -> Embedding weight [V, D] (no transpose;
                                       the transducer predictor's ``embed``,
                                       whisper's ``tok_embed``)
  BatchNorm batch_stats mean / var  -> running_mean / running_var
  everything else (bias, gLN gamma/beta, PReLU alpha [1], the Conv-TasNet
  decoder [L, N], the SenseVoice prompt embeddings) keeps name and layout.

The families' trees map by the same rule: Paraformer (``enc_i`` / ``dec_i``
TransformerBlocks, ``cif_hidden``, ``cif_out``), the transducer
(``encoder`` / ``predictor`` / ``joiner``), whisper-style (``enc_i``,
``dec_i`` with ``self_attn`` / ``cross_attn``, ``tok_embed``) and VADNet.

PyanNet's params are a plain dict tree, not a flax one, already in torch
layouts (``pyannet_params_to_state_dict``): lists become indices and each
LSTM direction's w_ih / w_hh / b_ih / b_hh become nn.LSTM's ``weight_ih_l0``
/ ``weight_hh_l0`` / ``bias_ih_l0`` / ``bias_hh_l0``.

Leaves may be numpy or jax arrays; the converter reads them with
``np.asarray`` and needs no jax import of its own.
"""
from __future__ import annotations

from collections.abc import Mapping
from typing import Dict

import numpy as np
import torch


def _walk(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from _walk(v, prefix + (str(k),))
        else:
            yield prefix + (str(k),), np.array(v, dtype=np.float32)  # a writable copy


def _param(path: tuple, a: np.ndarray):
    *mods, leaf = path
    if leaf == "kernel":
        leaf = "weight"
        if a.ndim == 2:
            a = a.T
        elif a.ndim == 3:
            a = a.transpose(2, 1, 0)
        elif a.ndim == 4:
            a = a.transpose(3, 2, 0, 1)
    elif leaf in ("scale", "embedding"):
        leaf = "weight"
    return ".".join(mods + [leaf]), a


def variables_to_state_dict(variables: Mapping) -> Dict[str, torch.Tensor]:
    """One stage's flax variables ({"params": ..., "batch_stats": ...})
    -> torch state_dict."""
    sd: Dict[str, torch.Tensor] = {}
    for path, a in _walk(variables.get("params", {})):
        key, a = _param(path, a)
        sd[key] = torch.from_numpy(np.ascontiguousarray(a))
    for path, a in _walk(variables.get("batch_stats", {})):
        *mods, leaf = path
        name = {"mean": "running_mean", "var": "running_var"}[leaf]
        sd[".".join(mods + [name])] = torch.from_numpy(np.ascontiguousarray(a))
        sd[".".join(mods + ["num_batches_tracked"])] = torch.tensor(0)
    return sd


def params_to_state_dicts(params: Mapping) -> Dict[str, Dict[str, torch.Tensor]]:
    """JAX ``ModelPack.params`` ({stage: variables}) -> {stage: state_dict}."""
    return {stage: variables_to_state_dict(v) for stage, v in params.items()}


_LSTM_NAMES = {"w_ih": "weight_ih_l0", "w_hh": "weight_hh_l0", "b_ih": "bias_ih_l0",
               "b_hh": "bias_hh_l0"}


def pyannet_params_to_state_dict(params: Mapping) -> Dict[str, torch.Tensor]:
    """JAX PyanNet params (models/pyannet.init_pyannet_params or
    models/convert/torch_import.load_pyannet_torch) -> the port's PyanNet
    state_dict. Every leaf keeps its layout."""
    def t(a):
        return torch.from_numpy(np.array(a, dtype=np.float32))

    sd: Dict[str, torch.Tensor] = {}
    for key, sub in params.items():
        if key == "lstm":
            for i, layer in enumerate(sub):
                for direction, p in layer.items():
                    for name, a in p.items():
                        sd[f"lstm.{i}.{direction}.{_LSTM_NAMES[name]}"] = t(a)
        elif key == "linear":
            for i, p in enumerate(sub):
                for name, a in p.items():
                    sd[f"linear.{i}.{name}"] = t(a)
        else:
            for name, a in sub.items():
                sd[f"{key}.{name}"] = t(a)
    return sd
