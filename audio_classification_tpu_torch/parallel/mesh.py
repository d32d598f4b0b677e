"""Device mesh and the tensor-parallel parameter rules (port of
audio_classification_tpu/parallel/mesh.py).

A mesh is a ("data", "model") grid of entries, one entry per shard. The
entries are spread over the ranks of a ``torch.distributed`` world, one rank
per card (``torchrun``; parallel/launch.py), and each rank owns a contiguous
block of them:

- world size 1 (no process group): every entry is local, on one device, and a
  shard program runs its entries as a loop in one process, the way the JAX
  package's tests run n virtual CPU devices;
- world size W > 1: with a model axis of 1 each rank owns ``data / W``
  contiguous rows; with a model axis m > 1 each rank owns one column of
  ``data * m / W`` rows (W must then divide by m).

Shard bodies are written over the rank's local list of shards
(parallel/sp_convtasnet.py, ring_attention.py). What crosses shards goes
through parallel/collectives.py, which acts on the local list and crosses
ranks only at its ends, so the same body runs at every world size. The
process groups of the two axes are made here, by every rank in the same
order (``torch.distributed.new_group`` is collective).

``data_sharding`` / ``replicated`` / ``shard_batch`` mean row ranges and
replication here: XLA's NamedSharding has no counterpart when each rank is
its own program. The TP rules (``convtasnet_param_spec``,
``mossformer_param_spec``) take a port state-dict name and tensor and
return a spec in the torch layout, one entry per dimension: "model" where
that dimension splits over the model axis, else None. ``apply_param_specs``
slices a state dict for a model column.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

Spec = Tuple[Optional[str], ...]


def _dist():
    import torch.distributed as dist

    return dist if dist.is_available() and dist.is_initialized() else None


@dataclass(frozen=True, eq=False)
class Mesh:
    """``devices[i][j]`` is the device of data shard i, model shard j as this
    rank sees it (the rank's own card for its entries); ``ranks[i][j]`` the
    rank that owns the entry. ``groups`` holds this rank's process groups of
    the two axes when the mesh spans a process group, else it is empty and
    every entry is local."""

    devices: Tuple[Tuple[torch.device, ...], ...]
    ranks: Tuple[Tuple[int, ...], ...] = ()
    rank: int = 0
    groups: Dict[str, object] = field(default_factory=dict)

    def __post_init__(self):
        if not self.ranks:
            object.__setattr__(self, "ranks",
                               tuple(tuple(0 for _ in row) for row in self.devices))

    @property
    def shape(self) -> Dict[str, int]:
        return {"data": len(self.devices), "model": len(self.devices[0])}

    @property
    def world(self) -> int:
        return len({r for row in self.ranks for r in row})

    @property
    def distributed(self) -> bool:
        """True when the mesh spans a process group (collectives go through
        ``torch.distributed`` even at world size 1)."""
        return bool(self.groups)

    @property
    def device(self) -> torch.device:
        """This rank's device: every local entry lives on it."""
        i, j = self.local_range("data").start, self.local_range("model").start
        return self.devices[i][j]

    def local_range(self, axis: str) -> range:
        """The global indices along ``axis`` of this rank's entries."""
        if axis == "data":
            idx = [i for i, row in enumerate(self.ranks) if self.rank in row]
        else:
            idx = [j for j in range(self.shape["model"])
                   if any(row[j] == self.rank for row in self.ranks)]
        return range(idx[0], idx[-1] + 1)

    def local_count(self, axis: str) -> int:
        return len(self.local_range(axis))

    def axis_ranks(self, axis: str) -> List[int]:
        """The ranks of this rank's group along ``axis``, in axis order: the
        owners of the column (``"data"``) or row (``"model"``) it sits in."""
        i, j = self.local_range("data").start, self.local_range("model").start
        line = [row[j] for row in self.ranks] if axis == "data" else list(self.ranks[i])
        out: List[int] = []
        for r in line:
            if not out or out[-1] != r:
                out.append(r)
        return out


def world_info() -> Tuple[int, int]:
    """(rank, world size) of the process group, (0, 1) without one."""
    dist = _dist()
    return (dist.get_rank(), dist.get_world_size()) if dist is not None else (0, 1)


def rank_grid(n: int, model_axis: int, world: int) -> np.ndarray:
    """[n // model_axis, model_axis] owner rank of each entry, ranks in
    row-major (data-major, node-major under torchrun) order."""
    rows = n // model_axis
    if world == 1:
        return np.zeros((rows, model_axis), np.int64)
    if n % world != 0:
        raise ValueError(f"the world's {world} ranks must divide the mesh's {n} entries")
    if model_axis == 1:
        return np.repeat(np.arange(world), rows // world)[:, None]
    if world % model_axis != 0:
        raise ValueError(f"a model axis of {model_axis} over {world} ranks: each rank owns "
                         "one model column, so the world size must divide by the model axis")
    rd = world // model_axis
    per = rows // rd
    return (np.arange(rows)[:, None] // per) * model_axis + np.arange(model_axis)[None, :]


def make_mesh(n_devices: Optional[int] = None, model_axis: int = 1,
              devices: Optional[Sequence] = None, slices: int = 1,
              world: Optional[int] = None, rank: Optional[int] = None) -> Mesh:
    """A ("data", "model") mesh of ``n_devices`` entries (default: one a
    rank of the world). ``model_axis x slices`` must divide it; the data
    axis gets the rest, slice-major (the JAX ``_hybrid_device_grid``: with
    ranks node-major, the rows of slice s are the ranks of node s, and a
    model row never crosses a slice).

    ``devices`` names each entry's device at world size 1 (default: the
    first CUDA device n times; "cpu" in the tests) and may name one device
    several times: n shards then run on it in one process. Under a process
    group ``devices`` names the kind of device only (default: CUDA): every
    entry this rank owns lives on the rank's current card
    (``torch.cuda.current_device()``, set by parallel/launch.py), or on the
    CPU where the caller names it, and the group's backend must carry that
    device's tensors (NCCL for CUDA, gloo for the CPU). Two ranks never
    share a card.

    ``world`` / ``rank`` lay out the rank grid of a world that is not the
    running one (no process groups are made): the layout tests use it."""
    dist = _dist()
    live = world is None and dist is not None
    cur_rank, cur_world = world_info() if live else (int(rank or 0), int(world or 1))
    if n_devices is None:
        n_devices = len(devices) if devices is not None else cur_world
    n = int(n_devices)
    slices = max(int(slices), 1)
    if n < 1 or n % (model_axis * slices) != 0:
        raise ValueError(
            f"model_axis {model_axis} x slices {slices} must divide device count {n}")
    grid = rank_grid(n, model_axis, cur_world)
    if live:
        devs = [_rank_device(dist, devices)] * n
    elif devices is None:
        from ..engine.runtime import resolve_device

        devs = [resolve_device(None)] * n
    else:
        devs = [torch.device(d) for d in devices][:n]
        if len(devs) < n:
            raise ValueError(f"make_mesh: {len(devs)} devices named for {n} entries")
        # "cuda" and "cuda:0" are one card; the distinct cards of a mesh are
        # its ranks' (parallel/launch.py), never entries of one process
        distinct = {(d.type, d.index if d.index is not None else 0) for d in devs}
        if len(distinct) > 1 and cur_world == 1:
            raise ValueError(
                f"make_mesh: {len(distinct)} distinct devices in one process; a mesh over "
                "several cards runs one rank per card: torchrun --nproc-per-node N "
                "-m <module> ... (parallel/launch.py)")
    rows = n // model_axis
    dgrid = tuple(tuple(devs[i * model_axis + j] for j in range(model_axis))
                  for i in range(rows))
    rgrid = tuple(tuple(int(r) for r in row) for row in grid)
    groups: Dict[str, object] = {}
    if live:
        groups = _make_groups(dist, rgrid, cur_rank)
    return Mesh(dgrid, rgrid, cur_rank, groups)


def _rank_device(dist, devices) -> torch.device:
    """The device of a rank's entries under a process group: the kind
    ``devices`` names (CUDA without them), on the rank's current card; the
    group's backend must carry its tensors. Never a device the caller did
    not ask for."""
    from ..engine.runtime import resolve_device

    kinds = {torch.device(d).type for d in devices} if devices is not None else {"cuda"}
    if len(kinds) != 1:
        raise ValueError(f"make_mesh: a rank's entries live on one device, not on "
                         f"{sorted(set(map(str, devices)))}")
    kind = kinds.pop()
    backend = str(dist.get_backend())
    carrier = "nccl" if kind == "cuda" else "gloo"
    if carrier not in backend:
        raise ValueError(
            f"make_mesh: the process group's backend {backend!r} does not carry {kind} tensors "
            f"({carrier} does): join it with init_process_group(\"cuda:nccl,cpu:gloo\") "
            "(parallel/launch.init_distributed)")
    if kind == "cuda":
        resolve_device("cuda")
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(kind)


def _make_groups(dist, rgrid, rank: int) -> Dict[str, object]:
    """One process group per data column and per model row, made by every
    rank in the same order; -> this rank's two."""
    world = dist.get_world_size()
    cols = sorted({tuple(dict.fromkeys(row[j] for row in rgrid))
                   for j in range(len(rgrid[0]))})
    rows = sorted({tuple(dict.fromkeys(row)) for row in rgrid})
    out: Dict[str, object] = {}
    for axis, lines in (("data", cols), ("model", rows)):
        for line in lines:
            g = dist.group.WORLD if len(line) == world else dist.new_group(list(line))
            if rank in line:
                out[axis] = g
    return out


# ---------------------------------------------------------------------------
# Row ranges and replication (the JAX NamedShardings)
# ---------------------------------------------------------------------------

def data_sharding(mesh: Mesh, batch: int) -> List[range]:
    """The rows of a [batch, ...] array each of this rank's data entries
    holds: ``batch / data`` contiguous rows an entry (``P("data")``)."""
    n = mesh.shape["data"]
    if batch % n != 0:
        raise ValueError(f"a batch of {batch} rows does not split over {n} data shards")
    per = batch // n
    return [range(i * per, (i + 1) * per) for i in mesh.local_range("data")]


def replicated(mesh: Mesh) -> torch.device:
    """``P()``: the whole array on this rank's device."""
    return mesh.device


def shard_batch(mesh: Mesh, tree):
    """A tree of host arrays / tensors with a leading batch dim -> one tree
    per local data entry holding its rows, on the rank's device."""
    def rows(x, r):
        t = x if isinstance(x, torch.Tensor) else torch.as_tensor(np.asarray(x))
        return t[r.start:r.stop].to(mesh.device)

    def walk(x, r):
        if isinstance(x, dict):
            return {k: walk(v, r) for k, v in x.items()}
        if isinstance(x, (list, tuple)):
            return type(x)(walk(v, r) for v in x)
        return rows(x, r)

    first = tree
    while isinstance(first, (dict, list, tuple)):
        first = next(iter(first.values())) if isinstance(first, dict) else first[0]
    return [walk(tree, r) for r in data_sharding(mesh, int(np.shape(first)[0]))]


# ---------------------------------------------------------------------------
# Parameter partitioning rules (TP), in the torch layout
# ---------------------------------------------------------------------------

def convtasnet_param_spec(name: str, leaf) -> Spec:
    """TP rules for ConvTasNet (the JAX rule on the port's names and
    layouts): the TCN hidden dim H splits over "model".

    - in_conv / dw_conv weights [H, Cin/g, K] -> ("model", None, None);
      their biases [H] -> ("model",)
    - res_conv / skip_conv weights [B, H, 1] -> (None, "model", None)
    everything else replicated (the gLN gamma / beta too: a TP forward
    reads the columns of its shard)."""
    parts = name.split(".")
    shape = tuple(getattr(leaf, "shape", ()))
    if any(p in ("in_conv", "dw_conv") for p in parts):
        if parts[-1] == "weight" and len(shape) == 3:
            return ("model", None, None)
        if parts[-1] == "bias":
            return ("model",)
    if (any(p in ("res_conv", "skip_conv") for p in parts) and parts[-1] == "weight"
            and len(shape) == 3):
        return (None, "model", None)
    return (None,) * len(shape)


def mossformer_param_spec(name: str, leaf) -> Spec:
    """TP rules for MossFormer: the GAU's expanded width d_e splits over
    "model" (megatron pair).

    - to_u / to_v weights [d_e, dim] -> ("model", None) (column parallel);
      biases [d_e] -> ("model",)
    - to_out weight [dim, d_e] -> (None, "model") (row parallel; the sum
      over the shards is an all-reduce)
    everything else replicated."""
    parts = name.split(".")
    shape = tuple(getattr(leaf, "shape", ()))
    if any(p in ("to_u", "to_v") for p in parts):
        if parts[-1] == "weight" and len(shape) == 2:
            return ("model", None)
        if parts[-1] == "bias":
            return ("model",)
    if "to_out" in parts and parts[-1] == "weight" and len(shape) == 2:
        return (None, "model")
    return (None,) * len(shape)


def shard_of(leaf: torch.Tensor, spec: Spec, j: int, m: int) -> torch.Tensor:
    """Model shard j of m of ``leaf`` under ``spec`` (a view)."""
    for dim, ax in enumerate(spec):
        if ax == "model":
            n = leaf.shape[dim] // m
            leaf = leaf.narrow(dim, j * n, n)
    return leaf


def apply_param_specs(mesh: Mesh, params: Dict[str, torch.Tensor],
                      rule: Callable) -> List[Dict[str, torch.Tensor]]:
    """A state dict -> one dict per local model entry, each leaf sliced to
    that entry's shard by ``rule(name, leaf)`` (views: a gradient through a
    shard reaches the full leaf)."""
    m = mesh.shape["model"]
    return [{k: shard_of(v, rule(k, v), j, m) for k, v in params.items()}
            for j in mesh.local_range("model")]
