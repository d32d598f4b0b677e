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

The inverse, ``state_dict_to_variables`` (``module_variables`` of a module)
and ``pyannet_state_dict_to_params``, turns the port's weights back into
those trees of numpy arrays: the layout the ONNX exporters
(convert/onnx_export) and the graph-aware importer (convert/onnx_graph_map)
share with the JAX package. A ``weight`` leaf's owner module decides what it
was: a Linear / Conv1d / Conv2d kernel, a LayerNorm / BatchNorm scale, an
Embedding's embedding.
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


def _kernel_back(a: np.ndarray) -> np.ndarray:
    """The inverse of ``_param``'s kernel transposes."""
    if a.ndim == 2:
        return a.T
    if a.ndim == 3:
        return a.transpose(2, 1, 0)
    return a.transpose(2, 3, 1, 0)


def _put(tree: dict, path, leaf: str, a: np.ndarray) -> None:
    for m in path:
        tree = tree.setdefault(m, {})
    tree[leaf] = np.ascontiguousarray(a)


def state_dict_to_variables(module: torch.nn.Module, state_dict=None) -> dict:
    """The port's module (or ``state_dict`` laid out as its own) -> flax
    variables {"params": ..., ["batch_stats": ...]} of float32 numpy arrays:
    the inverse of ``variables_to_state_dict``."""
    from ..models.common import Conv1d

    sd = module.state_dict() if state_dict is None else state_dict
    owners = dict(module.named_modules())
    params: dict = {}
    stats: dict = {}
    for key, t in sd.items():
        *mods, leaf = key.split(".")
        if leaf == "num_batches_tracked":
            continue
        a = t.detach().float().cpu().numpy()
        if leaf in ("running_mean", "running_var"):
            _put(stats, mods, {"running_mean": "mean", "running_var": "var"}[leaf], a)
            continue
        if leaf == "weight":
            owner = owners[".".join(mods)]
            if isinstance(owner, (torch.nn.Linear, torch.nn.Conv2d, Conv1d)):
                leaf, a = "kernel", _kernel_back(a)
            elif isinstance(owner, torch.nn.Embedding):
                leaf = "embedding"
            elif isinstance(owner, (torch.nn.LayerNorm, torch.nn.BatchNorm2d)):
                leaf = "scale"
            else:
                raise ValueError(f"{key}: no flax leaf for a weight of {type(owner).__name__}")
        _put(params, mods, leaf, a)
    out = {"params": params}
    if stats:
        out["batch_stats"] = stats
    return out


def module_variables(models: Mapping[str, torch.nn.Module]) -> Dict[str, dict]:
    """{stage: module} (e.g. ``ModelPack.models``) -> {stage: variables}."""
    return {stage: state_dict_to_variables(m) for stage, m in models.items()}


_LSTM_BACK = {v: k for k, v in _LSTM_NAMES.items()}


def pyannet_state_dict_to_params(sd: Mapping[str, torch.Tensor]) -> dict:
    """The port's PyanNet state_dict -> the JAX PyanNet params tree (lists
    for ``lstm`` and ``linear``), float32 numpy leaves: the inverse of
    ``pyannet_params_to_state_dict``."""
    params: dict = {}
    for key, t in sd.items():
        a = np.ascontiguousarray(t.detach().float().cpu().numpy())
        parts = key.split(".")
        if parts[0] == "lstm":
            _, i, direction, name = parts
            layers = params.setdefault("lstm", [])
            while len(layers) <= int(i):
                layers.append({})
            layers[int(i)].setdefault(direction, {})[_LSTM_BACK[name]] = a
        elif parts[0] == "linear":
            _, i, name = parts
            layers = params.setdefault("linear", [])
            while len(layers) <= int(i):
                layers.append({})
            layers[int(i)][name] = a
        else:
            params.setdefault(parts[0], {})[parts[1]] = a
    return params
