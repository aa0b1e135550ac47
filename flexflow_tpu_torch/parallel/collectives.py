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
  identity, and a term must be counted on one rank only;
* a rotation of the ring (:func:`rotate`: each member sends its block
  to the next member and receives the previous one's) has the reverse
  rotation as its backward;
* the all-reduce max of :func:`all_reduce_max` (a stability shift)
  carries no gradient, as ``lax.pmax`` of a detached value;
* a halo exchange (:func:`halo_exchange`: each member receives the rows
  of its span that other members' blocks hold) has as its backward the
  reverse exchange, each owner adding the gradients of the rows it sent
  into its own block's.

A rotation moves by the transport the machine fixed at start from the
backend (``MachineModel.send_recv``): paired ``isend``/``irecv``
batched by ``batch_isend_irecv`` ("p2p", NCCL and gloo with CPU
tensors), or, on gloo with CUDA tensors, which gloo carries no
point-to-point for, an all-gather within the group from which each
member keeps its predecessor's block ("gather").  A halo exchange takes
"p2p" likewise, and there "host": the same point-to-point on host
copies of its few rows.  The transport is never switched because a call
failed.

Pieces of uneven blocks are zero-padded to one shape for the collective
and trimmed after it.  A group of one member runs no collective.  On
tensors of the ``meta`` device (the dry run, ``--dry-compile``) every
collective returns a meta tensor of its output's shape without calling
``torch.distributed``.

**The recorder.**  Inside :func:`recording` every collective adds one
record to a list, live or on ``meta`` tensors alike, in the fields of
the JAX package's ``hlo_audit.parse_collectives``: ``op`` (XLA's
mnemonic), ``bytes`` (the buffer it moves: an all-gather's or
all-reduce's result, a reduce-scatter's piece, an all-to-all's or a
rotation's block; a halo exchange's largest member's rows, one record
per direction), ``groups`` (the ranks of the process group, or the
``[source, target]`` pairs of a point-to-point move), ``size`` (the
group's) and ``owner``, the one rank that keeps the record when the
ranks' lists are joined (the group's first rank), so that a collective
counts once per group, not once per member; the join then makes the
records of parallel groups one record listing every group, as XLA's
instruction does (``utils/hlo_audit.join_records``).  A group of one
member records nothing.

**The order of the backward collectives.**  Under placement the ranks
run different ops, so their autograd graphs differ, and autograd alone
would issue the backward collectives of two groups that share ranks in
different orders on different ranks (a hang).  A training step
therefore threads a *token* through every collective it records
(:class:`TokenChain`): each autograd function takes the token as an
input and returns a new one, so a rank's backward collectives run in
exactly the reverse of its forward order.  Every rank walks the graph in
one topological order and calls a collective only where it is a member,
so the forward orders, and with them the backward orders, agree across
the members of every group.  The step adds the last token (zero) to its
loss and asks autograd for the first token's gradient as well, which
makes every collective node reachable on every rank, whatever its data
input.  Integer tensors (token ids, labels) move outside autograd.
"""

from __future__ import annotations

import contextlib
import contextvars
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


# ---------------------------------------------------------------------------
# the recorder (utils/hlo_audit.py)

#: the records of the open :func:`recording`, None when none is open (a
#: module global, not a context variable: autograd runs the backward's
#: collectives on threads of its own)
_records = None


@contextlib.contextmanager
def recording():
    """Record every collective issued inside the block (and on ``meta``
    tensors every one that would be): yields the list the records go
    to.  Recordings do not nest."""
    global _records
    if _records is not None:
        raise RuntimeError("a collective recording is open already")
    _records = []
    try:
        yield _records
    finally:
        _records = None


def _nbytes(x: torch.Tensor) -> int:
    return x.numel() * x.element_size()


def _record(op: str, nbytes: int, group: Group, pairs=None) -> None:
    """One record of ``op`` over ``group`` moving ``nbytes``; ``pairs``
    the ``(source, target)`` ranks of a point-to-point move."""
    if _records is None or group.size <= 1:
        return
    ranks = sorted(int(r) for r in group.ranks)
    groups = [[int(a), int(b)] for a, b in pairs] if pairs is not None \
        else [ranks]
    if groups:
        _records.append({"op": op, "bytes": float(nbytes),
                         "groups": groups, "owner": ranks[0],
                         "size": len(ranks)})


def all_gather_list(x: torch.Tensor, group: Group) -> List[torch.Tensor]:
    """Every member's ``x`` (one shape), in ``group.positions`` order."""
    import torch.distributed as dist

    x = x.contiguous()
    if group.size == 1 and group.handle is None:
        return [x]
    _record("all-gather", _nbytes(x) * group.size, group)
    out = [torch.empty_like(x) for _ in range(group.size)]
    if x.is_meta:
        return out
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
    _record("reduce-scatter", _nbytes(out), group)
    if out.is_meta:
        return out
    dist.reduce_scatter(out, [pieces[m].contiguous() for m in order],
                        group=_handle(group))
    return out


def all_reduce_(x: torch.Tensor, group: Group) -> torch.Tensor:
    """Sum ``x`` over the group, in place."""
    import torch.distributed as dist

    if group.size == 1 and group.handle is None:
        return x
    _record("all-reduce", _nbytes(x), group)
    if x.is_meta:
        return x
    dist.all_reduce(x, group=_handle(group))
    return x


def all_reduce_flat(xs: Sequence[torch.Tensor],
                    group: Group) -> List[torch.Tensor]:
    """Sum each of ``xs`` (one dtype) over the group by one all-reduce of
    their concatenation; the sums in ``xs``' order and shapes."""
    flat = all_reduce_(torch.cat([x.reshape(-1) for x in xs]), group)
    return [part.view_as(x)
            for x, part in zip(xs, flat.split([x.numel() for x in xs]))]


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


class TokenChain:
    """The token threaded through one recorded step's collectives:
    ``first`` is the leaf autograd is asked about, ``token`` the newest
    (both zero)."""

    def __init__(self, device):
        self.first = torch.zeros((), device=device, requires_grad=True)
        self.token = self.first


#: the chain of the step being recorded, None outside one
_chain: contextvars.ContextVar = contextvars.ContextVar("token_chain",
                                                       default=None)


@contextlib.contextmanager
def token_chain(device):
    """Record the collectives run inside the block on one new chain."""
    chain = TokenChain(device)
    reset = _chain.set(chain)
    try:
        yield chain
    finally:
        _chain.reset(reset)


def _chained(fn, x, *args):
    """``fn`` on ``x`` as an autograd function with the recording chain's
    token threaded through it; an integer ``x`` moves by ``fn.run``,
    outside autograd."""
    if x is not None and not x.is_floating_point():
        return fn.run(x, *args)
    chain = _chain.get()
    if chain is None or not torch.is_grad_enabled():
        return fn.apply(x, None, *args)[0]
    y, chain.token = fn.apply(x, chain.token, *args)
    return y


def _next_token(token):
    return None if token is None else token.clone()


class GatherCopy(torch.autograd.Function):
    """All-gather every member's block (``src[m]``, global boxes) and copy
    the parts of ``dst`` (this rank's wanted box) that the source members
    ``sources`` hold; the backward reduce-scatters each source piece's
    gradient to its owner."""

    @staticmethod
    def run(x, group, src, sources, dst, me):
        pad = tuple(max(hi - lo for lo, hi in dims)
                    for dims in zip(*src))
        pieces = all_gather_list(_pad_to(x, pad), group)
        out = x.new_empty(_extent(dst))
        for m in sources:
            ov = _overlap(src[m], dst)
            if ov is not None:
                out[ov[1]] = pieces[m][ov[0]]
        return out

    @staticmethod
    def forward(ctx, x, token, group, src, sources, dst, me):
        ctx.meta = (group, src, sources, dst, me)
        return GatherCopy.run(x, group, src, sources, dst, me), \
            _next_token(token)

    @staticmethod
    def backward(ctx, g, g_token):
        group, src, sources, dst, me = ctx.meta
        pad = tuple(max(hi - lo for lo, hi in dims) for dims in zip(*src))
        bufs = [g.new_zeros(pad) for _ in range(group.size)]
        for m in sources:
            ov = _overlap(src[m], dst)
            if ov is not None:
                bufs[m][ov[0]] = g[ov[1]]
        mine = reduce_scatter_list(bufs, group)
        return (mine[tuple(slice(0, n) for n in _extent(src[me]))],
                g_token, None, None, None, None, None)


def gather_copy(x, group, src, sources, dst, me):
    return _chained(GatherCopy, x, group, src, sources, dst, me)


class AllToAllMove(torch.autograd.Function):
    """Move a split axis from tensor dim ``j`` to dim ``k``: this rank's
    block is cut into ``group.size`` equal chunks along ``k``, chunk ``c``
    goes to member ``c``, and the chunks received are joined along ``j``
    in member order.  The backward is the move from ``k`` back to ``j``."""

    @staticmethod
    def run(x, group, j, k):
        return _all_to_all(x, group, j, k)

    @staticmethod
    def forward(ctx, x, token, group, j, k):
        ctx.meta = (group, j, k)
        return _all_to_all(x, group, j, k), _next_token(token)

    @staticmethod
    def backward(ctx, g, g_token):
        group, j, k = ctx.meta
        return _all_to_all(g, group, k, j), g_token, None, None, None


def all_to_all_move(x, group, j, k):
    return _chained(AllToAllMove, x, group, j, k)


def _all_to_all(x, group: Group, j: int, k: int) -> torch.Tensor:
    import torch.distributed as dist

    chunks = [c.contiguous() for c in torch.chunk(x, group.size, dim=k)]
    order = _group_order(group)
    out = [torch.empty_like(chunks[0]) for _ in range(group.size)]
    _record("all-to-all", _nbytes(x), group)
    if not x.is_meta:
        dist.all_to_all(out, [chunks[m] for m in order],
                        group=_handle(group))
    by_member = [None] * group.size
    for grank, member in enumerate(order):
        by_member[member] = out[grank]
    return torch.cat(by_member, dim=j)


class AllReduceSum(torch.autograd.Function):
    """The sum over the group; a replica on every member, so its backward
    sums the members' partial gradients (an all-reduce too)."""

    @staticmethod
    def forward(ctx, x, token, group):
        ctx.group = group
        return all_reduce_(x.clone(), group), _next_token(token)

    @staticmethod
    def backward(ctx, g, g_token):
        return all_reduce_(g.clone(), ctx.group), g_token, None


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
    return _chained(AllReduceSum, x, group)


def global_sum(x, group: Group):
    return GlobalSum.apply(x, group)


# ---------------------------------------------------------------------------
# moves by box overlap (placed producers and consumers)


class BoxMove(torch.autograd.Function):
    """A value from the boxes its source members hold to the boxes its
    destination members want, over the group of both.  ``plan`` is a
    :class:`~flexflow_tpu_torch.parallel.regrid.BoxPlan` as this rank
    runs it: ``send`` the box this rank contributes (None: it contributes
    zeros), ``pad`` the shape every member pads to, ``cells`` the
    ``(member, slices into that member's piece, slices into the output)``
    this rank copies, ``out`` its output shape (None: it wants nothing
    and returns an empty tensor).  The backward sends each copied cell's
    gradient back to its source member by a reduce-scatter."""

    @staticmethod
    def run(x, plan):
        dtype, dev = plan.dtype, plan.device
        buf = _pad_to(x.to(dtype), plan.pad) if plan.send is not None \
            else torch.zeros(plan.pad, dtype=dtype, device=dev)
        pieces = all_gather_list(buf, plan.group)
        if plan.out is None:
            return torch.empty((0,), dtype=dtype, device=dev)
        out = torch.empty(plan.out, dtype=dtype, device=dev)
        for m, src_sl, dst_sl in plan.cells:
            out[dst_sl] = pieces[m][src_sl]
        return out

    @staticmethod
    def forward(ctx, x, token, plan):
        ctx.plan = plan
        return BoxMove.run(x, plan), _next_token(token)

    @staticmethod
    def backward(ctx, g, g_token):
        plan = ctx.plan
        bufs = [torch.zeros(plan.pad, dtype=plan.dtype, device=plan.device)
                for _ in range(plan.group.size)]
        if plan.out is not None:
            for m, src_sl, dst_sl in plan.cells:
                bufs[m][src_sl] += g[dst_sl]
        mine = reduce_scatter_list(bufs, plan.group)
        if plan.send is None or not ctx.needs_input_grad[0]:
            return None, g_token, None
        return (mine[tuple(slice(0, hi - lo) for lo, hi in plan.send)],
                g_token, None)


def box_move(x, plan):
    """``x`` (None where this rank holds no source) moved by ``plan``."""
    if not plan.dtype.is_floating_point:
        return BoxMove.run(x, plan)
    return _chained(BoxMove, x, plan)


# ---------------------------------------------------------------------------
# the ring's moves (parallel/ring_attention.py)


def all_reduce_max(x: torch.Tensor, group: Group) -> torch.Tensor:
    """The elementwise max of ``x`` over the group, with no gradient
    (``lax.pmax`` of a detached value)."""
    import torch.distributed as dist

    x = x.detach().clone()
    if group.size == 1 and group.handle is None:
        return x
    _record("all-reduce", _nbytes(x), group)
    if x.is_meta:
        return x
    dist.all_reduce(x, op=dist.ReduceOp.MAX, group=_handle(group))
    return x


def _rotate(x: torch.Tensor, group: Group, shift: int,
            transport: str) -> torch.Tensor:
    """Member ``m``'s ``x`` lands on member ``(m + shift) % size``: every
    member returns the block of member ``(m - shift) % size``."""
    import torch.distributed as dist

    size = group.size
    x = x.contiguous()
    if transport == "gather":
        pieces = all_gather_list(x, group)
        if x.is_meta:
            return torch.empty_like(x)
        me = group.ranks.index(dist.get_rank())
        return pieces[(me - shift) % size].clone()
    _record("collective-permute", _nbytes(x), group,
            pairs=[(group.ranks[m], group.ranks[(m + shift) % size])
                   for m in range(size)])
    if x.is_meta:
        return torch.empty_like(x)
    me = group.ranks.index(dist.get_rank())
    dst = group.ranks[(me + shift) % size]
    src = group.ranks[(me - shift) % size]
    out = torch.empty_like(x)
    ops = [dist.P2POp(dist.isend, x, dst, _handle(group)),
           dist.P2POp(dist.irecv, out, src, _handle(group))]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return out


class Rotate(torch.autograd.Function):
    """One step of the ring: each member's block moves to the member
    ``shift`` places on (members in ``group.positions`` order, cyclic);
    the backward moves the gradients ``shift`` places back."""

    @staticmethod
    def run(x, group, shift, transport):
        return _rotate(x, group, shift, transport)

    @staticmethod
    def forward(ctx, x, token, group, shift, transport):
        ctx.meta = (group, shift, transport)
        return _rotate(x, group, shift, transport), _next_token(token)

    @staticmethod
    def backward(ctx, g, g_token):
        group, shift, transport = ctx.meta
        return _rotate(g, group, -shift, transport), g_token, None, None, \
            None


def rotate(x, group: Group, transport: str, shift: int = 1):
    """``x`` of the member ``shift`` places before this one in
    ``group.positions`` (cyclic), as an autograd function on the
    recording step's token chain; ``transport`` "p2p" or "gather"."""
    if group.size == 1:
        return x
    return _chained(Rotate, x, group, shift, transport)


# ---------------------------------------------------------------------------
# the neighbour halo exchange (ops/conv.py window_blocks)

#: bytes this process has moved by halo exchanges, forward and backward
#: (:func:`halo_bytes`, :func:`reset_halo_bytes`)
_halo = {"sent": 0, "received": 0}


def halo_bytes() -> dict:
    """``{"sent", "received"}``: the bytes this rank's halo exchanges have
    sent and received since the last :func:`reset_halo_bytes`."""
    return dict(_halo)


def reset_halo_bytes() -> None:
    _halo["sent"] = _halo["received"] = 0


def _send_recv(sends, recvs, group: Group, transport: str, like):
    """Point-to-point pieces over ``group``: ``sends`` ``(member,
    tensor)``, ``recvs`` ``(member, shape)``; the received tensors in
    ``recvs`` order, on ``like``'s device and dtype.  ``transport``
    "p2p" posts every send and receive in one ``batch_isend_irecv``;
    "host" does so on host copies (gloo carries no point-to-point for
    CUDA tensors) and moves what it received back to the device."""
    import torch.distributed as dist

    if like.is_meta:
        return [torch.empty(shape, dtype=like.dtype, device=like.device)
                for _, shape in recvs]
    host = transport == "host"
    buf_dev = torch.device("cpu") if host else like.device
    ops, outs = [], []
    for m, t in sends:
        t = t.contiguous()
        _halo["sent"] += t.numel() * t.element_size()
        if host:
            t = t.cpu()
        ops.append(dist.P2POp(dist.isend, t, group.ranks[m],
                              _handle(group)))
    for m, shape in recvs:
        buf = torch.empty(shape, dtype=like.dtype, device=buf_dev)
        _halo["received"] += buf.numel() * buf.element_size()
        outs.append(buf)
        ops.append(dist.P2POp(dist.irecv, buf, group.ranks[m],
                              _handle(group)))
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    if host:
        outs = [o.to(like.device) for o in outs]
    return outs


class HaloExchange(torch.autograd.Function):
    """The rows ``[lo, hi)`` of a dim split into ``blocks`` over the
    members of ``group`` (in block order): this rank's block ``x``
    supplies its own rows, each other member the rows of its block in
    the span, by point-to-point from that member alone; this rank sends
    each member the rows of its block in that member's span.  ``spans``
    holds every member's ``(lo, hi)``, so that every rank knows what to
    send.  The backward sends each received piece's gradient back to
    its owner and adds the gradients of the pieces it sent into its own
    block's."""

    @staticmethod
    def _plan(blocks, spans, me):
        """``(sends, recvs)``: per other member, the ``(lo, hi)`` of the
        rows this rank sends it and receives from it (global rows)."""
        def ov(a, b):
            lo, hi = max(a[0], b[0]), min(a[1], b[1])
            return (lo, hi) if lo < hi else None

        sends = [(m, ov(blocks[me], spans[m])) for m in range(len(blocks))
                 if m != me]
        recvs = [(m, ov(blocks[m], spans[me])) for m in range(len(blocks))]
        return ([(m, r) for m, r in sends if r is not None],
                [(m, r) for m, r in recvs if r is not None])

    @staticmethod
    def _record(group, dim, blocks, spans, shape, esize, reverse):
        """The exchange's records, one per direction as XLA's permutes of
        a halo: every member's sends to later members, then to earlier
        ones (``reverse``: the backward's, each forward piece sent back),
        each record's bytes the largest member's."""
        row = esize
        for d, n in enumerate(shape):
            if d != dim:
                row *= n
        for later in (True, False):
            pairs, sent = [], [0] * len(blocks)
            for m in range(len(blocks)):
                for t, (lo, hi) in HaloExchange._plan(blocks, spans, m)[0]:
                    if (t > m) != later:
                        continue
                    src, dst = (t, m) if reverse else (m, t)
                    pairs.append((group.ranks[src], group.ranks[dst]))
                    sent[src] += (hi - lo) * row
            if pairs:
                _record("collective-permute", max(sent), group,
                        pairs=pairs)

    @staticmethod
    def run(x, group, dim, blocks, spans, me, transport):
        HaloExchange._record(group, dim, blocks, spans, x.shape,
                             x.element_size(), False)
        sends, recvs = HaloExchange._plan(blocks, spans, me)
        base = blocks[me][0]

        def rows(shape, lo, hi):
            s = list(shape)
            s[dim] = hi - lo
            return tuple(s)

        got = iter(_send_recv(
            [(m, x.narrow(dim, lo - base, hi - lo)) for m, (lo, hi) in sends],
            [(m, rows(x.shape, lo, hi)) for m, (lo, hi) in recvs
             if m != me],
            group, transport, x))
        pieces = [x.narrow(dim, lo - base, hi - lo) if m == me else next(got)
                  for m, (lo, hi) in recvs]
        return pieces[0] if len(pieces) == 1 else torch.cat(pieces, dim)

    @staticmethod
    def forward(ctx, x, token, group, dim, blocks, spans, me, transport):
        ctx.meta = (group, dim, blocks, spans, me, transport, x.shape)
        return HaloExchange.run(x, group, dim, blocks, spans, me,
                                transport), _next_token(token)

    @staticmethod
    def backward(ctx, g, g_token):
        group, dim, blocks, spans, me, transport, shape = ctx.meta
        HaloExchange._record(group, dim, blocks, spans, shape,
                             g.element_size(), True)
        sends, recvs = HaloExchange._plan(blocks, spans, me)
        base, lo0 = blocks[me][0], spans[me][0]
        # the reverse exchange: the gradient of each received piece goes
        # back to its owner; those of the pieces sent come back here
        back = [(m, g.narrow(dim, lo - lo0, hi - lo))
                for m, (lo, hi) in recvs if m != me]
        shapes = []
        for m, (lo, hi) in sends:
            s = list(shape)
            s[dim] = hi - lo
            shapes.append((m, tuple(s)))
        got = _send_recv(back, shapes, group, transport, g)
        dx = g.new_zeros(shape)
        for m, (lo, hi) in recvs:
            if m == me:
                dx.narrow(dim, lo - base, hi - lo).add_(
                    g.narrow(dim, lo - lo0, hi - lo))
        for (m, (lo, hi)), piece in zip(sends, got):
            dx.narrow(dim, lo - base, hi - lo).add_(piece)
        return dx, g_token, None, None, None, None, None, None


def halo_exchange(x, group: Group, dim: int, blocks, spans, me: int,
                  transport: str):
    """Rows ``spans[me]`` of tensor ``dim`` from this rank's block ``x``
    (block ``me`` of ``blocks``) and its neighbours', as an autograd
    function on the recording step's token chain; ``transport`` "p2p"
    or "host" (:func:`_send_recv`)."""
    return _chained(HaloExchange, x, group, dim, tuple(blocks),
                    tuple(spans), me, transport)
