"""Device mesh (port of audio_classification_tpu/parallel/mesh.py:19-56).

A mesh is a ("data", "model") grid of ``torch.device``s. The sequence-parallel
paths (ring attention, the time-sharded separators) cut one utterance into
``mesh.shape["data"]`` shards. Several entries of a mesh may name the same
device: n shards then live on one card and the shard program runs as a loop
in one process, the way the JAX package's tests run n virtual CPU devices.
A mesh over several distinct cards needs the NCCL rotation of ROADMAP slice
16 and raises until then; so do the tensor-parallel parameter rules.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Sequence, Tuple

import torch


@dataclass(frozen=True)
class Mesh:
    """``devices[i][j]`` is the device of data shard i, model shard j."""

    devices: Tuple[Tuple[torch.device, ...], ...]

    @property
    def shape(self) -> Dict[str, int]:
        return {"data": len(self.devices), "model": len(self.devices[0])}

    @property
    def device(self) -> torch.device:
        """The one device every shard lives on."""
        return self.devices[0][0]


def make_mesh(n_devices: Optional[int] = None, model_axis: int = 1,
              devices: Optional[Sequence] = None) -> Mesh:
    """A ("data", "model") mesh of ``n_devices`` entries; ``model_axis``
    divides it and the data axis gets the rest. ``devices`` defaults to
    ``n_devices`` (default 1) entries of the first CUDA device, and may name
    one device several times ("cpu" in the tests)."""
    if devices is None:
        from ..engine.runtime import resolve_device

        devs = [resolve_device(None)] * (1 if n_devices is None else int(n_devices))
    else:
        devs = [torch.device(d) for d in devices]
        if n_devices is not None:
            devs = devs[:n_devices]
    n = len(devs)
    if n < 1 or n % model_axis != 0:
        raise ValueError(f"model_axis {model_axis} must divide device count {n}")
    # "cuda" and "cuda:0" are one card
    distinct = {(d.type, d.index if d.index is not None else 0) for d in devs}
    if len(distinct) > 1:
        raise NotImplementedError(
            f"make_mesh: a mesh over {len(distinct)} distinct devices needs the NCCL "
            "rotation and the DP/TP engine, which are not ported to "
            "audio_classification_tpu_torch yet (ROADMAP slice 16); name one device "
            "n times to run n shards on it")
    rows = n // model_axis
    return Mesh(tuple(tuple(devs[i * model_axis:(i + 1) * model_axis]) for i in range(rows)))
