"""How a run gets its mesh from ``--data-parallel`` / ``--model-parallel`` /
``--slices``: one ``torch.distributed`` rank per card.

Under ``torchrun`` (``WORLD_SIZE`` in the environment) each rank takes the
card ``LOCAL_RANK`` (``torch.cuda.set_device``) and joins the process group
(NCCL for CUDA tensors, gloo for CPU ones; the CPU alone takes gloo), and
the mesh's data x model entries must equal the world size:

    torchrun --nproc-per-node 4 -m audio_classification_tpu_torch.cli.offline_overlap_3src \\
        --data-parallel 4 --input-wavs mix.wav --target-wav t.wav

A process group made by the caller (the tests' gloo ranks) is taken as it
is. Without one, a run is one process on one card: ``--data-parallel n``
with a shard flag (``--time-shard``, ``--seq-parallel``) puts n shards on
that card, and any other count above 1 raises with the command to run.
Two ranks never share a card, and nothing moves to the CPU on its own.
"""
from __future__ import annotations

import os
from typing import Optional, Tuple

import torch

from .mesh import Mesh, make_mesh


def _dist():
    import torch.distributed as dist

    return dist


def launched() -> bool:
    """True under torchrun or an initialised process group."""
    dist = _dist()
    return (dist.is_available() and dist.is_initialized()) or "WORLD_SIZE" in os.environ


def init_distributed(device_type: str = "cuda") -> Tuple[int, int]:
    """Join the world torchrun describes (once) -> (rank, world size);
    (0, 1) without one. A CUDA run first takes the card LOCAL_RANK."""
    dist = _dist()
    if not dist.is_available():
        return 0, 1
    if not dist.is_initialized():
        if "WORLD_SIZE" not in os.environ:
            return 0, 1
        if device_type == "cuda":
            if not torch.cuda.is_available():
                raise RuntimeError("no CUDA device found: a torchrun rank of "
                                   "audio_classification_tpu_torch runs on its card; ask for "
                                   "the CPU explicitly (--provider cpu)")
            local = int(os.environ.get("LOCAL_RANK", 0))
            if local >= torch.cuda.device_count():
                raise RuntimeError(
                    f"LOCAL_RANK {local} has no card of its own ({torch.cuda.device_count()} "
                    "visible): two ranks never share a card; start at most one rank per card "
                    "(torchrun --nproc-per-node <cards>)")
            torch.cuda.set_device(local)
            dist.init_process_group("cuda:nccl,cpu:gloo")
        else:
            dist.init_process_group("gloo")
    return dist.get_rank(), dist.get_world_size()


def is_writer() -> bool:
    """Rank 0 writes records and artifacts; every rank without a world."""
    dist = _dist()
    return not (dist.is_available() and dist.is_initialized()) or dist.get_rank() == 0


def entry_module() -> str:
    """The runner a launch message names: the ``-m`` module of this process."""
    import __main__

    spec = getattr(__main__, "__spec__", None)
    name = getattr(spec, "name", "") or ""
    return name if name.startswith("audio_classification_tpu_torch") else \
        "audio_classification_tpu_torch.cli.<runner>"


def world_mesh(device) -> Optional[Mesh]:
    """Under torchrun, a data-parallel mesh over every rank of the world (the
    JAX tools that run over every device); None without one."""
    if not launched():
        return None
    dev = torch.device(device)
    world = init_distributed(dev.type)[1]
    return make_mesh(world, devices=[dev] * world)


def training_mesh(args, device, shard_flag: str = "", shards_on: bool = False
                  ) -> Optional[Mesh]:
    """The mesh of a training CLI's ``--data-parallel`` / ``--model-parallel``
    / ``--slices`` (``mesh_for``). As the JAX CLIs take every device when
    neither count is given, a torchrun world without them is data-parallel
    over all its ranks. A shard flag without a count gets a mesh of one."""
    dp, mp = int(args.data_parallel or 0), int(args.model_parallel or 0)
    dev = torch.device(device)
    if not dp and not mp and launched():
        dp = init_distributed(dev.type)[1]
    mesh = mesh_for(dp, mp, args.slices, dev, shard_flag, shards_on)
    if mesh is None and shards_on:
        mesh = make_mesh(1, devices=[dev])
    return mesh


def mesh_for(data_parallel: int = 0, model_parallel: int = 0, slices: int = 1,
             device="cuda", shard_flag: str = "", shards_on: bool = False) -> Optional[Mesh]:
    """The mesh the three flags ask for, or None for one card and no mesh.

    Under torchrun / a process group: ``dp x mp`` entries over the world
    (``dp x mp`` must equal it; ``slices`` lays the data axis slice-major,
    parallel/mesh.make_mesh). One process: ``dp`` shards on ``device`` when
    ``shards_on`` (``shard_flag`` given), else anything above 1 raises."""
    dp, mp = max(int(data_parallel or 0), 1), max(int(model_parallel or 0), 1)
    n = dp * mp
    if n == 1:
        return None
    dev = torch.device(device)
    entry = entry_module()
    if launched():
        _rank, world = init_distributed(dev.type)
        if world > 1 or _dist().is_initialized():
            if n != world:
                raise ValueError(
                    f"--data-parallel {dp} x --model-parallel {mp} = {n} mesh entries, but the "
                    f"world has {world} ranks: one rank per card, so start "
                    f"torchrun --nproc-per-node {n} -m {entry} --data-parallel {dp}"
                    + (f" --model-parallel {mp}" if mp > 1 else ""))
            return make_mesh(n, model_axis=mp, slices=slices, devices=[dev] * n)
    if shards_on and mp == 1:
        return make_mesh(dp, devices=[dev] * dp)
    raise ValueError(
        f"--data-parallel {dp} x --model-parallel {mp}: a mesh over {n} cards runs one rank "
        f"per card: torchrun --nproc-per-node {n} -m {entry} --data-parallel {dp}"
        + (f" --model-parallel {mp}" if mp > 1 else "")
        + (f"; with {shard_flag} one process puts {dp} shards on its card"
           if shard_flag and mp == 1 else ""))
