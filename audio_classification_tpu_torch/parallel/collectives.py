"""What crosses the shards of a mesh (parallel/mesh.py), written over a
rank's local list of shards.

XLA inserts these from the shardings in the JAX package (``ppermute``,
``psum``, the all-gathers of a pjit program); here they are explicit. Each
function takes the list of this rank's shards along one mesh axis, in axis
order, does the local part as list operations and crosses ranks only at the
ends of the list, through the axis's process group: NCCL for CUDA tensors,
gloo on the CPU. Without a process group (world size 1) they are the list
operations alone, so one shard body runs at every world size.

Every function is differentiable. The backward of a collective depends on
what consumes its output:

- ``ring_shift`` / ``halo_from_right`` / ``halo_from_left`` move tensors;
  their backward moves the gradients back the way they came;
- ``psum`` feeds computations that differ per shard (gLN statistics, the
  GAU's partial sums): its backward is ``psum`` again;
- ``reduce_replicated`` ends a row-parallel product whose sum every rank then
  uses identically (megatron's g): its backward is the identity, and
  ``enter_sharded`` (megatron's f: identity forward, summed backward) marks
  where a replicated tensor enters per-shard computation;
- ``all_gather`` collects shards into a tensor every rank then uses
  identically; its backward keeps the rank's own part.
"""
from __future__ import annotations

from typing import List, Optional, Sequence

import torch


def _group(mesh, axis: str):
    """The axis's process group, or None when every shard of the axis is in
    this process and no process group runs."""
    return mesh.groups.get(axis) if mesh is not None and mesh.distributed else None


def _dist():
    import torch.distributed as dist

    return dist


def _wire(x: torch.Tensor) -> torch.Tensor:
    """A tensor a backend sends: contiguous, bool as uint8."""
    x = x.contiguous()
    return x.to(torch.uint8) if x.dtype == torch.bool else x


def _unwire(x: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bool) if like.dtype == torch.bool else x


def _p2p(send: Optional[torch.Tensor], dst: Optional[int], like: torch.Tensor,
         src: Optional[int], group) -> Optional[torch.Tensor]:
    """Send ``send`` to global rank ``dst`` and receive a tensor shaped like
    ``like`` from ``src`` (either may be None), as one batch of P2P ops."""
    dist = _dist()
    ops, out = [], None
    if src is not None:
        out = torch.empty_like(_wire(like))
        ops.append(dist.P2POp(dist.irecv, out, src, group))
    if dst is not None:
        ops.append(dist.P2POp(dist.isend, _wire(send), dst, group))
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    return None if out is None else _unwire(out, like)


class _Exchange(torch.autograd.Function):
    """x goes to ``dst``; the output is what ``src`` sent (zeros when src is
    None). Backward: the output's gradient goes back to src, and x's comes
    from dst."""

    @staticmethod
    def forward(ctx, x, dst, src, group):
        ctx.dst, ctx.src, ctx.group = dst, src, group
        got = _p2p(x, dst, x, src, group)
        return torch.zeros_like(x) if got is None else got

    @staticmethod
    def backward(ctx, g):
        back = _p2p(g, ctx.src, g, ctx.dst, ctx.group)
        return (torch.zeros_like(g) if back is None else back), None, None, None


def _exchange(x: torch.Tensor, dst: Optional[int], src: Optional[int], group) -> torch.Tensor:
    if x.requires_grad:
        return _Exchange.apply(x, dst, src, group)
    got = _p2p(x, dst, x, src, group)
    return torch.zeros_like(x) if got is None else got


def _neighbours(mesh, axis: str):
    """(previous rank, next rank) along the axis, None past the ends, and
    the axis' ranks in order."""
    line = mesh.axis_ranks(axis)
    k = line.index(mesh.rank)
    prev = line[k - 1] if k > 0 else None
    nxt = line[k + 1] if k + 1 < len(line) else None
    return prev, nxt, line


def ring_shift(xs: List, mesh=None, axis: str = "data") -> List:
    """One ring step: shard i receives what shard i - 1 held (the JAX
    ``ppermute`` with perm [(j, j + 1 mod n)]). The local list rotates; the
    last local shard goes to the next rank, the first comes from the
    previous one. Entries may be None (nothing travels)."""
    group = _group(mesh, axis)
    if group is None or xs[0] is None:
        return xs[-1:] + xs[:-1]
    _prev, _nxt, line = _neighbours(mesh, axis)
    if len(line) == 1:
        return xs[-1:] + xs[:-1]
    k = line.index(mesh.rank)
    nxt, prev = line[(k + 1) % len(line)], line[(k - 1) % len(line)]
    return [_exchange(xs[-1], nxt, prev, group)] + xs[:-1]


def halo_from_right(xs: List[torch.Tensor], h: int, mesh=None,
                    axis: str = "data") -> List[torch.Tensor]:
    """For each shard the first h rows (axis 1) of its RIGHT neighbour;
    zeros on the last shard of the axis."""
    out = [xs[i + 1][:, :h] for i in range(len(xs) - 1)]
    group = _group(mesh, axis)
    last = torch.zeros_like(xs[-1][:, :h])
    if group is not None:
        prev, nxt, line = _neighbours(mesh, axis)
        if len(line) > 1:
            last = _exchange(xs[0][:, :h], prev, nxt, group)
    return out + [last]


def halo_from_left(xs: List[torch.Tensor], h: int, mesh=None,
                   axis: str = "data") -> List[torch.Tensor]:
    """For each shard the last h rows of its LEFT neighbour; zeros on the
    first shard of the axis."""
    first = torch.zeros_like(xs[0][:, -h:])
    group = _group(mesh, axis)
    if group is not None:
        prev, nxt, line = _neighbours(mesh, axis)
        if len(line) > 1:
            first = _exchange(xs[-1][:, -h:], nxt, prev, group)
    return [first] + [xs[i - 1][:, -h:] for i in range(1, len(xs))]


def _all_reduce(x: torch.Tensor, group) -> torch.Tensor:
    y = _wire(x).clone()
    _dist().all_reduce(y, group=group)
    return y


class _AllReduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, sum_backward):
        ctx.group, ctx.sum_backward = group, sum_backward
        return _all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return (_all_reduce(g, ctx.group) if ctx.sum_backward else g), None, None


class _EnterSharded(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.group), None


def _reduce(x: torch.Tensor, group, sum_backward: bool) -> torch.Tensor:
    if group is None:
        return x
    if x.requires_grad:
        return _AllReduce.apply(x, group, sum_backward)
    return _all_reduce(x, group)


def psum(xs: Sequence[torch.Tensor], mesh=None, axis: str = "data") -> torch.Tensor:
    """The sum over every shard of the axis, which every shard receives;
    consumers that differ per shard (backward: psum)."""
    local = xs[0] if len(xs) == 1 else torch.stack(list(xs)).sum(dim=0)
    return _reduce(local, _group(mesh, axis), True)


def reduce_replicated(xs: Sequence[torch.Tensor], mesh=None,
                      axis: str = "model") -> torch.Tensor:
    """The sum over every shard of the axis, used identically by every rank
    (a row-parallel product's output, a global loss): backward identity."""
    local = xs[0] if len(xs) == 1 else torch.stack(list(xs)).sum(dim=0)
    return _reduce(local, _group(mesh, axis), False)


def enter_sharded(x: torch.Tensor, mesh=None, axis: str = "model") -> torch.Tensor:
    """A replicated tensor about to feed per-shard computation: identity
    forward; backward sums the gradient over the axis's ranks."""
    group = _group(mesh, axis)
    if group is None or not x.requires_grad:
        return x
    return _EnterSharded.apply(x, group)


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, index, world):
        ctx.index, ctx.n = index, x.shape[0]
        return _gather_plain(x, group, world)

    @staticmethod
    def backward(ctx, g):
        return g[ctx.index * ctx.n:(ctx.index + 1) * ctx.n], None, None, None


def all_gather(xs: Sequence[torch.Tensor], mesh=None, axis: str = "data",
               dim: int = 0) -> torch.Tensor:
    """The axis's shards joined along ``dim`` in axis order, on every rank
    (used identically there: backward keeps the rank's own part). Shards
    of other ranks must have this rank's shapes but along ``dim``'s
    neighbours: pad first where they may differ (``pad_to_common``)."""
    local = xs[0] if len(xs) == 1 else torch.cat(list(xs), dim=dim)
    group = _group(mesh, axis)
    if group is None:
        return local
    line = mesh.axis_ranks(axis)
    moved = local.movedim(dim, 0).contiguous()
    if moved.requires_grad:
        out = _AllGather.apply(moved, group, line.index(mesh.rank), len(line))
    else:
        out = _gather_plain(moved, group, len(line))
    return out.movedim(0, dim)


def _gather_plain(x: torch.Tensor, group, world: int) -> torch.Tensor:
    parts = [torch.empty_like(_wire(x)) for _ in range(world)]
    _dist().all_gather(parts, _wire(x), group=group)
    return _unwire(torch.cat(parts), x)


def spans_ranks(mesh) -> bool:
    """True when ``mesh`` runs over more than one rank: every rank must then
    make the same collective calls in the same order."""
    return mesh is not None and mesh.distributed and mesh.world > 1


def world_min(values: Sequence[int], mesh) -> List[int]:
    """The elementwise minimum of ``values`` over every rank of the mesh's
    world (as they are on one rank): how ranks that feed themselves agree on
    the work they all have. Every rank passes a list of the same length."""
    if not spans_ranks(mesh):
        return [int(v) for v in values]
    t = torch.tensor([int(v) for v in values], dtype=torch.int64, device=mesh.device)
    _dist().all_reduce(t, op=_dist().ReduceOp.MIN)
    return t.tolist()


def pad_to_common(x: torch.Tensor, mesh=None, axis: str = "data") -> torch.Tensor:
    """``x`` zero-padded at the end of every dim but the first to the
    largest extent any rank of the axis holds (a decoder's token axis, which
    stops where its own rows stop)."""
    group = _group(mesh, axis)
    if group is None or x.ndim < 2:
        return x
    ext = torch.tensor(list(x.shape[1:]), dtype=torch.int64, device=x.device)
    _dist().all_reduce(ext, op=_dist().ReduceOp.MAX, group=group)
    pad = []
    for have, want in reversed(list(zip(x.shape[1:], ext.tolist()))):
        pad += [0, int(want) - int(have)]
    return torch.nn.functional.pad(x, pad) if any(pad) else x
