"""Tensor parallelism of the separators over the mesh's "model" axis (the
JAX package leaves it to XLA under ``convtasnet_param_spec`` /
``mossformer_param_spec``, parallel/mesh.py).

The blocks run their own forwards over a list of shards, one per local
model entry (models/convtasnet.TCNBlock, models/mossformer.GAUBlock): each
submodule takes its shard's leaves as ``params`` and the collectives of
parallel/collectives join the shards, megatron style:

- Conv-TasNet TCN block: in_conv and the depthwise conv column-parallel on
  H / model channels, gLN statistics summed over the model shards,
  res_conv and skip_conv row-parallel, their sums all-reduced;
- MossFormer GAU: to_u and to_v column-parallel on d_e / model, the
  attention map whole on every shard, so kernel K4 runs on the shard's
  columns of v, and to_out row-parallel with an all-reduce.

A row-parallel layer's bias is added after the sum, once on every rank:
every rank then holds its logical gradient without a collective, and the
ranks' backward passes make the same collectives. The TP forward is the dense TCN loop,
never K2: gLN over a sharded H needs the model shards' statistics inside the
masker. int8 models do not take it: their per-sample activation scales span
the whole of H.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence

import torch

from .collectives import enter_sharded, psum, reduce_replicated
from .mesh import apply_param_specs


def tensor_parallel(mesh) -> bool:
    return mesh is not None and mesh.shape["model"] > 1


def model_shards(module, mesh, rule: Callable, subs: Sequence[str],
                 row_parallel: Sequence[str] = ()) -> List[Optional[Dict[str, dict]]]:
    """The leaves of ``module``'s submodules ``subs`` for each local model
    entry of ``mesh``: ``[{submodule: {leaf: shard}}]``, sliced by ``rule``
    (parallel/mesh.apply_param_specs) after ``enter_sharded`` (a leaf's
    gradient then sums over the model ranks that read a slice of it). The
    biases of the ``row_parallel`` submodules are left out (``row_sum``
    adds them). Without a model axis above 1: ``[None]``, one shard of the
    module's own weights."""
    if not tensor_parallel(mesh):
        return [None]
    full = {name: enter_sharded(p, mesh) for name, p in module.named_parameters()
            if name.split(".")[0] in subs and name not in {f"{r}.bias" for r in row_parallel}}
    out = []
    for flat in apply_param_specs(mesh, full, rule):
        nested: Dict[str, dict] = {sub: {} for sub in subs}
        for name, leaf in flat.items():
            sub, part = name.split(".", 1)
            nested[sub][part] = leaf
        out.append(nested)
    return out


def row_sum(outs: List[torch.Tensor], mesh, bias: Optional[torch.Tensor]) -> torch.Tensor:
    """A row-parallel layer's output from its shards' products: their sum
    over the model axis, then the layer's bias. Without TP, the one shard's
    output (its bias inside)."""
    if not tensor_parallel(mesh):
        return outs[0]
    y = reduce_replicated(outs, mesh)
    return y if bias is None else y + bias.to(y.dtype)


def of(shard: Optional[Dict[str, dict]], sub: str) -> Optional[dict]:
    """A submodule's leaves in ``shard``; None (its own) without TP."""
    return None if shard is None else shard[sub]


def model_total(mesh) -> Optional[Callable]:
    """gLN's ``total`` over the model shards (None without TP)."""
    return (lambda parts: psum(parts, mesh, "model")) if tensor_parallel(mesh) else None
