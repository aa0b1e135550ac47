"""Collectives over the ranks of one :class:`~flexflow_tpu_torch.machine.Group`,
each an autograd function whose backward is the adjoint collective.

The convention that makes the adjoints right: a value held by several
ranks (a replica) carries on each rank a *partial* gradient, and its true
gradient is the sum of the partials over the replicas.  So

* a gather that makes pieces visible to every member (all-gather, then
  each member copies the part it needs) has as its backward a
  reduce-scatter: each piece's owner receives the sum of every member's
  gradient of that piece;
* a local slice of a replica has the plain slice's backward (zeros
  outside the slice);
* an all-to-all that moves a split axis from one tensor dim to another
  has the reverse all-to-all as its backward;
* an all-reduce of per-shard sums (BatchNorm's statistics) has an
  all-reduce as its backward: the summed value is a replica;
* the loss, every rank's partial sum added up by :func:`global_sum`, is
  differentiated from each rank's own partial: its backward is the
  identity, and a term must be counted on one rank only.

Pieces of uneven blocks are zero-padded to one shape for the collective
and trimmed after it.  A group of one member runs no collective.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import torch

from flexflow_tpu_torch.machine import Group

Box = Tuple[Tuple[int, int], ...]


def _handle(group: Group):
    if group.handle is None:
        raise RuntimeError(
            f"collective over ranks {group.ranks} without a process group: "
            f"build the machine with distributed.initialize")
    return group.handle


def _group_order(group: Group) -> List[int]:
    """Index in ``group.ranks`` of each group rank (process groups number
    their members in ascending global rank)."""
    srt = sorted(group.ranks)
    return [group.ranks.index(r) for r in srt]


def all_gather_list(x: torch.Tensor, group: Group) -> List[torch.Tensor]:
    """Every member's ``x`` (one shape), in ``group.positions`` order."""
    import torch.distributed as dist

    x = x.contiguous()
    if group.size == 1 and group.handle is None:
        return [x]
    out = [torch.empty_like(x) for _ in range(group.size)]
    dist.all_gather(out, x, group=_handle(group))
    by_member = [None] * group.size
    for grank, member in enumerate(_group_order(group)):
        by_member[member] = out[grank]
    return by_member


def reduce_scatter_list(pieces: Sequence[torch.Tensor],
                        group: Group) -> torch.Tensor:
    """The sum over members of their ``pieces[i]`` for ``i`` this rank's
    member index; ``pieces`` in ``group.positions`` order, one shape."""
    import torch.distributed as dist

    if group.size == 1 and group.handle is None:
        return pieces[0]
    order = _group_order(group)
    out = torch.empty_like(pieces[0])
    dist.reduce_scatter(out, [pieces[m].contiguous() for m in order],
                        group=_handle(group))
    return out


def all_reduce_(x: torch.Tensor, group: Group) -> torch.Tensor:
    """Sum ``x`` over the group, in place."""
    import torch.distributed as dist

    if group.size == 1 and group.handle is None:
        return x
    dist.all_reduce(x, group=_handle(group))
    return x


def _extent(box: Box) -> Tuple[int, ...]:
    return tuple(hi - lo for lo, hi in box)


def _pad_to(x: torch.Tensor, shape) -> torch.Tensor:
    if tuple(x.shape) == tuple(shape):
        return x.contiguous()
    out = x.new_zeros(shape)
    out[tuple(slice(0, n) for n in x.shape)] = x
    return out


def _overlap(a: Box, b: Box):
    """``(slices into a, slices into b)`` of the intersection of boxes a
    and b (global ``(lo, hi)`` per dim), or None when it is empty."""
    sa, sb = [], []
    for (alo, ahi), (blo, bhi) in zip(a, b):
        lo, hi = max(alo, blo), min(ahi, bhi)
        if lo >= hi:
            return None
        sa.append(slice(lo - alo, hi - alo))
        sb.append(slice(lo - blo, hi - blo))
    return tuple(sa), tuple(sb)


class GatherCopy(torch.autograd.Function):
    """All-gather every member's block (``src[m]``, global boxes) and copy
    the parts of ``dst`` (this rank's wanted box) that the source members
    ``sources`` hold; the backward reduce-scatters each source piece's
    gradient to its owner."""

    @staticmethod
    def forward(ctx, x, group, src, sources, dst, me):
        pad = tuple(max(hi - lo for lo, hi in dims)
                    for dims in zip(*src))
        pieces = all_gather_list(_pad_to(x, pad), group)
        out = x.new_empty(_extent(dst))
        for m in sources:
            ov = _overlap(src[m], dst)
            if ov is not None:
                out[ov[1]] = pieces[m][ov[0]]
        ctx.meta = (group, src, sources, dst, me, pad)
        return out

    @staticmethod
    def backward(ctx, g):
        group, src, sources, dst, me, pad = ctx.meta
        bufs = [g.new_zeros(pad) for _ in range(group.size)]
        for m in sources:
            ov = _overlap(src[m], dst)
            if ov is not None:
                bufs[m][ov[0]] = g[ov[1]]
        mine = reduce_scatter_list(bufs, group)
        return (mine[tuple(slice(0, n) for n in _extent(src[me]))],
                None, None, None, None, None)


class AllToAllMove(torch.autograd.Function):
    """Move a split axis from tensor dim ``j`` to dim ``k``: this rank's
    block is cut into ``group.size`` equal chunks along ``k``, chunk ``c``
    goes to member ``c``, and the chunks received are joined along ``j``
    in member order.  The backward is the move from ``k`` back to ``j``."""

    @staticmethod
    def forward(ctx, x, group, j, k):
        ctx.meta = (group, j, k)
        return _all_to_all(x, group, j, k)

    @staticmethod
    def backward(ctx, g):
        group, j, k = ctx.meta
        return _all_to_all(g, group, k, j), None, None, None


def _all_to_all(x, group: Group, j: int, k: int) -> torch.Tensor:
    import torch.distributed as dist

    chunks = [c.contiguous() for c in torch.chunk(x, group.size, dim=k)]
    order = _group_order(group)
    out = [torch.empty_like(chunks[0]) for _ in range(group.size)]
    dist.all_to_all(out, [chunks[m] for m in order], group=_handle(group))
    by_member = [None] * group.size
    for grank, member in enumerate(order):
        by_member[member] = out[grank]
    return torch.cat(by_member, dim=j)


class AllReduceSum(torch.autograd.Function):
    """The sum over the group; a replica on every member, so its backward
    sums the members' partial gradients (an all-reduce too)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return all_reduce_(x.clone(), group)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_(g.clone(), ctx.group), None


class GlobalSum(torch.autograd.Function):
    """The sum over the group of every member's partial value, whose
    backward hands each member the gradient of its own partial unchanged
    (each term of the sum lives on one member)."""

    @staticmethod
    def forward(ctx, x, group):
        return all_reduce_(x.clone(), group)

    @staticmethod
    def backward(ctx, g):
        return g, None


def all_reduce_sum(x, group: Group):
    return AllReduceSum.apply(x, group)


def global_sum(x, group: Group):
    return GlobalSum.apply(x, group)
