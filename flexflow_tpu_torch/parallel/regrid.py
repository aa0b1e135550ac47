"""Whole-graph regrid planner and its execution (PyTorch port of
``flexflow_tpu/parallel/regrid.py``).

Every producer->consumer edge whose layouts differ is planned once, at
build time: the produced value's layout and the consumer's wanted layout
are per-dim tuples of global mesh axes (``MachineModel.global_entries``),
and :func:`plan_hops` picks the cheapest chain of single-axis hops under
the machine's link costs, the same uniform-cost search over the same
moves with the same prices as the JAX planner, so that each edge gets
the JAX plan's hop chain.  Each hop then runs as one collective over the
ranks along the hop's axes (:func:`make_hop`):

* a split (an axis added) is a local slice of each rank's block;
* a move of an axis between two tensor dims is an all-to-all over that
  axis (when both dims divide evenly and the backend has an all-to-all
  for the device's tensors, ``MachineModel.all_to_all``);
* a drop (an axis gathered), and any other move, is an all-gather over
  the hop's axes, each rank then
  copying the part of its new block that the others hold; if the ranks
  along those axes do not hold all of it (uneven blocks nested across
  hops) the gather widens to every axis of the dims that change.

Each is an autograd function with the adjoint collective as its backward
(``parallel/collectives.py``).  A value that several consumers want in
one layout is resharded once (the plan's share keys).

An edge whose producer or consumer is placed on a device subset
(``parallel/placement.py``) has no layout on the global mesh: the value
is held in a box on each of some positions (:class:`Placed`).  Such an
edge is one move by box overlap (:func:`plan_box_move`): every rank
knows every position's source and destination box from the grid maps,
each destination's box is cut into cells by the source boxes' edges and
each cell copied from one holder (itself where it can), over the group
of the destinations that need another rank's data and the sources they
read.  The move is an all-gather of the sources' blocks within that
group (gloo carries it on CUDA tensors, as the backward's
reduce-scatter), and its backward is the reverse move.
:func:`plan_state_migration` prices an elastic resize's live-state
move between two machines.
"""

from __future__ import annotations

import dataclasses
import heapq
import math
from typing import Dict, List, Optional, Tuple

from flexflow_tpu_torch.machine import MachineModel, Topology
from flexflow_tpu_torch.parallel import collectives

# cost charged to a pure split hop (a slice: no wire traffic) — small and
# nonzero so the search prefers fewer hops among traffic-free plans
_SPLIT_EPS = 1.0e-7

# uniform-cost-search state cap; beyond it the greedy decomposition
_MAX_STATES = 20000

#: bytes per element of the dtype names the graph carries
_ITEMSIZE = {"float32": 4, "bfloat16": 2, "float16": 2, "int32": 4}


# ---------------------------------------------------------------------------
# hop pricing (flexflow_tpu/sim/collectives.py:60-131)


def _spread(devs: Tuple[int, ...], topo: Topology) -> Tuple[int, int, int]:
    """(G, p_in, p_min): fast-tier groups spanned, the largest per-group
    share and the smallest."""
    counts: dict = {}
    for d in devs:
        g = d // topo.devices_per_ici_group
        counts[g] = counts.get(g, 0) + 1
    return len(counts), max(counts.values()), min(counts.values())


def _allreduce(vol_bytes: float, devs: Tuple[int, ...],
               topo: Topology) -> float:
    """Hierarchical ring all-reduce of one shard's ``vol_bytes``."""
    p = len(devs)
    if p <= 1 or vol_bytes <= 0:
        return 0.0
    G, p_in, _ = _spread(devs, topo)
    t = 0.0
    if p_in > 1:
        t += (2.0 * (p_in - 1) / p_in * vol_bytes / topo.ici_bandwidth
              + 2.0 * (p_in - 1) * topo.ici_latency)
    if G > 1:
        chunk = vol_bytes / max(p_in, 1)
        t += (2.0 * (G - 1) / G * chunk / topo.dcn_bandwidth
              + 2.0 * (G - 1) * topo.dcn_latency)
    return t


def _alltoall(vol_bytes: float, devs: Tuple[int, ...],
              topo: Topology) -> float:
    """All-to-all of one shard's ``vol_bytes``, split by destination
    tier."""
    p = len(devs)
    if p <= 1 or vol_bytes <= 0:
        return 0.0
    G, p_in, p_min = _spread(devs, topo)
    t = 0.0
    if p_in > 1:
        t += ((p_in - 1) / p * vol_bytes / topo.ici_bandwidth
              + (p_in - 1) * topo.ici_latency)
    if G > 1:
        t += ((p - p_min) / p * vol_bytes / topo.dcn_bandwidth
              + (G - 1) * topo.dcn_latency)
    return t


class _MeshCosts:
    """Link costs of hops on one machine's global factored mesh, priced
    on the axis group that holds position 0."""

    def __init__(self, machine: MachineModel):
        self.topo: Topology = machine.topology
        fac = machine.global_factors()
        self.sizes = {name: s for name, s in fac}
        strides: Dict[str, int] = {}
        stride = 1
        for name, s in reversed(fac):
            strides[name] = stride
            stride *= s
        self.strides = strides
        self._groups: Dict[Tuple[str, ...], Tuple[int, ...]] = {}

    def group(self, axes: Tuple[str, ...]) -> Tuple[int, ...]:
        key = tuple(sorted(axes))
        devs = self._groups.get(key)
        if devs is None:
            devs = (0,)
            for a in key:
                stride, size = self.strides[a], self.sizes[a]
                devs = tuple(d + i * stride for d in devs
                             for i in range(size))
            devs = tuple(sorted(devs))
            self._groups[key] = devs
        return devs

    def nshards(self, state) -> int:
        n = 1
        for t in state:
            for a in t:
                n *= self.sizes[a]
        return n

    def alltoall(self, per_shard_bytes: float, axis: str) -> float:
        return _alltoall(per_shard_bytes, self.group((axis,)), self.topo)

    def allgather(self, per_shard_bytes_after: float,
                  axes: Tuple[str, ...]) -> float:
        # half an all-reduce of the gathered volume
        return 0.5 * _allreduce(per_shard_bytes_after, self.group(axes),
                                self.topo)


def _hop_traffic(costs: _MeshCosts, total_bytes: float,
                 prev, nxt) -> Tuple[float, float]:
    """(seconds, wire_bytes) of the single hop ``prev -> nxt``."""
    prev_axes = [a for t in prev for a in t]
    nxt_axes = [a for t in nxt for a in t]
    removed = tuple(a for a in prev_axes if a not in nxt_axes)
    added = [a for a in nxt_axes if a not in prev_axes]
    per_prev = total_bytes / max(costs.nshards(prev), 1)
    per_nxt = total_bytes / max(costs.nshards(nxt), 1)
    if removed and not added:
        p = len(costs.group(removed))
        return (costs.allgather(per_nxt, removed),
                (p - 1) / max(p, 1) * total_bytes)
    if not removed and not added:
        moved = None
        for a in prev_axes:
            loc_prev = next((j, t.index(a)) for j, t in enumerate(prev)
                            if a in t)
            loc_nxt = next((j, t.index(a)) for j, t in enumerate(nxt)
                           if a in t)
            if loc_prev != loc_nxt:
                moved = a
                break
        if moved is None:
            return 0.0, 0.0
        s = costs.sizes[moved]
        return (costs.alltoall(per_prev, moved),
                (s - 1) / s * total_bytes)
    if added and not removed:
        return _SPLIT_EPS, 0.0
    p = len(costs.group(removed))
    return (costs.allgather(per_nxt, removed),
            (p - 1) / max(p, 1) * total_bytes)


def price_chain(machine: MachineModel, src, chain: List,
                shape: Tuple[int, ...], itemsize: int = 4,
                costs: Optional[_MeshCosts] = None) -> Tuple[float, float]:
    """(seconds, wire_bytes) of walking ``src`` through ``chain``."""
    costs = costs or _MeshCosts(machine)
    total = float(math.prod(shape)) * itemsize
    secs = moved = 0.0
    cur = src
    for step in chain:
        s, b = _hop_traffic(costs, total, cur, step)
        secs += s
        moved += b
        cur = step
    return secs, moved


def _correct_prefix_len(cur_j, dst_j) -> int:
    n = 0
    for a, b in zip(cur_j, dst_j):
        if a != b:
            break
        n += 1
    return n


def plan_hops(machine: MachineModel, src, dst,
              shape: Tuple[int, ...], itemsize: int = 4,
              costs: Optional[_MeshCosts] = None):
    """Min-cost single-axis hop decomposition of ``src -> dst``: returns
    ``(chain, seconds, wire_bytes)``, ``chain`` the intermediate layouts
    ending with ``dst`` (empty when ``src == dst``); the greedy
    decomposition past the search's state budget
    (``flexflow_tpu/parallel/regrid.py:190``)."""
    if len(src) != len(dst):
        raise ValueError(f"rank mismatch: {src} vs {dst}")
    if src == dst:
        return [], 0.0, 0.0
    costs = costs or _MeshCosts(machine)
    total = float(math.prod(shape)) * itemsize
    dst_axes = {a for t in dst for a in t}
    src_t = tuple(tuple(t) for t in src)
    dst_t = tuple(tuple(t) for t in dst)

    def neighbors(state):
        cur = [list(t) for t in state]
        loc = {a: j for j, t in enumerate(cur) for a in t}
        out = []
        foreign = [a for t in cur for a in t if a not in dst_axes]
        if foreign:
            out.append(tuple(tuple(a for a in t if a in dst_axes)
                             for t in cur))
        for j, t in enumerate(cur):
            keep = _correct_prefix_len(t, dst_t[j])
            for i, a in enumerate(t):
                if i >= keep and (a in dst_axes or len(foreign) > 1):
                    nxt = [list(x) for x in cur]
                    nxt[j].remove(a)
                    out.append(tuple(tuple(x) for x in nxt))
        for j, t in enumerate(cur):
            p = len(t)
            if p < len(dst_t[j]) and tuple(t) == dst_t[j][:p]:
                a = dst_t[j][p]
                nxt = [list(x) for x in cur]
                if a in loc:
                    nxt[loc[a]].remove(a)
                nxt[j].append(a)
                out.append(tuple(tuple(x) for x in nxt))
        return out

    frontier = [(0.0, 0, src_t, None)]
    best: Dict = {}
    parents: Dict = {}
    order = 0
    explored = 0
    while frontier:
        cost, _, state, parent = heapq.heappop(frontier)
        if state in best and best[state] <= cost:
            continue
        best[state] = cost
        parents[state] = parent
        if state == dst_t:
            chain = []
            cur = state
            while cur is not None and cur != src_t:
                chain.append(cur)
                cur = parents[cur]
            chain.reverse()
            _, moved = price_chain(machine, src_t, chain, shape,
                                   itemsize, costs)
            return chain, cost, moved
        explored += 1
        if explored > _MAX_STATES:
            break
        for nxt in neighbors(state):
            if nxt == state:
                continue
            s, _ = _hop_traffic(costs, total, state, nxt)
            order += 1
            heapq.heappush(frontier, (cost + s, order, nxt, state))
    steps = machine.regrid_steps(src_t, dst_t)
    if steps is None:
        chain = [tuple(() for _ in src_t), dst_t]
    else:
        chain = list(steps) + [dst_t]
    secs, moved = price_chain(machine, src_t, chain, shape, itemsize, costs)
    return chain, secs, moved


# ---------------------------------------------------------------------------
# hop execution


@dataclasses.dataclass
class Hop:
    """One hop ``prev -> nxt`` as this rank runs it: ``kind`` is "slice",
    "alltoall" or "gather"; ``axes`` the global axes of its group."""

    kind: str
    axes: Tuple[str, ...] = ()
    slices: Tuple = ()
    group: object = None
    dims: Tuple[int, int] = (0, 0)
    src: Tuple = ()
    sources: Tuple[int, ...] = ()
    dst: Tuple = ()
    me: int = 0

    def __call__(self, x):
        if self.kind == "slice":
            # contiguous, as the kernels' wrappers take their operands
            return x[self.slices].contiguous()
        if self.kind == "alltoall":
            return collectives.all_to_all_move(x, self.group, *self.dims)
        return collectives.gather_copy(x, self.group, self.src,
                                       self.sources, self.dst, self.me)


def _inside(inner, outer) -> bool:
    return all(olo <= ilo and ihi <= ohi
               for (ilo, ihi), (olo, ohi) in zip(inner, outer))


def _volume(box) -> int:
    return math.prod(max(hi - lo, 0) for lo, hi in box)


def _overlap_volume(a, b) -> int:
    return math.prod(max(min(ahi, bhi) - max(alo, blo), 0)
                     for (alo, ahi), (blo, bhi) in zip(a, b))


def _moved_axis(prev, nxt):
    """``(axis, j, k)`` when the hop moves one axis from the minor end of
    dim j to the minor end of dim k and changes nothing else."""
    if sorted(a for t in prev for a in t) != sorted(a for t in nxt
                                                    for a in t):
        return None
    changed = [d for d in range(len(prev)) if prev[d] != nxt[d]]
    if len(changed) != 2:
        return None
    for j, k in (changed, changed[::-1]):
        if prev[j] and nxt[k] and prev[j][-1] == nxt[k][-1] \
                and nxt[j] == prev[j][:-1] and nxt[k][:-1] == prev[k]:
            return prev[j][-1], j, k
    return None


def make_hop(machine: MachineModel, prev, nxt, shape) -> Hop:
    """The hop ``prev -> nxt`` of a ``shape`` tensor as this rank runs it;
    its process group is made here (every rank plans every hop in one
    order).  The choice depends on the layouts and shape alone, so every
    rank makes the same one."""
    n = machine.num_devices
    sizes = machine.axis_sizes()
    bp = [machine.block(prev, shape, p) for p in range(n)]
    bn = [machine.block(nxt, shape, p) for p in range(n)]
    me = machine.position
    if all(_inside(bn[p], bp[p]) for p in range(n)):
        return Hop("slice", slices=tuple(
            slice(lo - plo, hi - plo)
            for (lo, hi), (plo, _) in zip(bn[me], bp[me])))
    moved = _moved_axis(prev, nxt) if machine.all_to_all else None
    if moved is not None:
        a, j, k = moved
        if shape[j] % math.prod(sizes[x] for x in prev[j]) == 0 \
                and shape[k] % math.prod(sizes[x] for x in nxt[k]) == 0:
            machine.create_groups([(a,)])
            return Hop("alltoall", axes=(a,), group=machine.group((a,)),
                       dims=(j, k))

    def loc(state):
        return {a: (d, i) for d, t in enumerate(state)
                for i, a in enumerate(t)}

    lp, ln = loc(prev), loc(nxt)
    hop_axes = {a for a in set(lp) | set(ln) if lp.get(a) != ln.get(a)}
    changed = {a for d in range(len(prev)) if prev[d] != nxt[d]
               for a in prev[d] + nxt[d]}
    order = [name for name, _ in machine.global_factors()]
    for cand in (hop_axes, hop_axes | changed):
        axes = tuple(a for a in order if a in cand)
        if _covers(machine, axes, set(lp), bp, bn):
            break
    else:
        raise AssertionError(f"regrid {prev} -> {nxt} of {shape}: the "
                             f"blocks do not tile")
    machine.create_groups([axes])
    group = machine.group(axes)
    sources = tuple(i for i, p in enumerate(group.positions)
                    if all(machine.coords(p)[a] == 0
                           for a in axes if a not in lp))
    return Hop("gather", axes=axes, group=group,
               src=tuple(bp[p] for p in group.positions), sources=sources,
               dst=bn[me], me=group.positions.index(me))


def _covers(machine, axes, used, bp, bn) -> bool:
    """True when, for every position, the source members of its group
    along ``axes`` (those at coordinate 0 on the axes the source layout
    does not use; the rest hold copies) hold all of its new block."""
    sizes = machine.axis_sizes()
    for p in range(machine.num_devices):
        members = machine._members(axes, p, sizes)
        srcs = [m for m in members
                if all(machine.coords(m)[a] == 0
                       for a in axes if a not in used)]
        if sum(_overlap_volume(bp[m], bn[p]) for m in srcs) \
                != _volume(bn[p]):
            return False
    return True


# ---------------------------------------------------------------------------
# moves by box overlap


@dataclasses.dataclass(frozen=True)
class Placed:
    """A value held by some positions only: ``boxes[p]`` is the global
    box held at position ``p``, None where it holds none."""

    boxes: Tuple


def spec_box(spec, shape, index: Dict[str, int],
             sizes: Dict[str, int]) -> Tuple[Tuple[int, int], ...]:
    """The global box of grid point ``index`` (``{axis: index}``) of a
    ``shape`` tensor split as ``spec``: a dim split over axes ``(a, b,
    ...)`` has ceil-sized blocks, the block index the mixed radix of the
    point's indices (``a`` slowest)."""
    out = []
    for d, n in enumerate(shape):
        entry = spec[d] if spec is not None and d < len(spec) else None
        if entry is None:
            out.append((0, n))
            continue
        parts, idx = 1, 0
        for name in (entry if isinstance(entry, tuple) else (entry,)):
            parts *= sizes.get(name, 1)
            idx = idx * sizes.get(name, 1) + index.get(name, 0)
        b = -(-n // parts)
        out.append((min(idx * b, n), min((idx + 1) * b, n)))
    return tuple(out)


def placed_layout(machine: MachineModel, op, positions, spec,
                  shape) -> Placed:
    """The boxes a placed op's points hold (or want) of a ``shape`` tensor
    laid out as ``spec`` over its grid."""
    from flexflow_tpu_torch.parallel.placement import grid_index

    sizes = dict(zip(op.AXIS_NAMES, op.pc.dims))
    boxes: List = [None] * machine.num_devices
    for j, pos in enumerate(positions):
        boxes[pos] = spec_box(spec, shape,
                              grid_index(j, op.pc.dims, op.AXIS_NAMES),
                              sizes)
    return Placed(tuple(boxes))


def layout_boxes(machine: MachineModel, layout, shape) -> Tuple:
    """Every position's box of a value in ``layout`` (global entries or
    :class:`Placed`)."""
    if isinstance(layout, Placed):
        return layout.boxes
    if layout is None:
        return tuple((tuple((0, n) for n in shape),)
                     * machine.num_devices)
    return tuple(machine.block(layout, shape, p)
                 for p in range(machine.num_devices))


def _cells(box, holders):
    """``box`` cut into cells by the edges of the boxes in ``holders``
    inside it, each cell as a box."""
    cuts = []
    for d, (lo, hi) in enumerate(box):
        edges = {lo, hi}
        for h in holders:
            for e in h[d]:
                if lo < e < hi:
                    edges.add(e)
        e = sorted(edges)
        cuts.append(list(zip(e[:-1], e[1:])))
    cells = [()]
    for iv in cuts:
        cells = [c + (i,) for c in cells for i in iv]
    return cells


def _rel(inner, outer):
    return tuple(slice(lo - olo, hi - olo)
                 for (lo, hi), (olo, _) in zip(inner, outer))


@dataclasses.dataclass
class BoxPlan:
    """This rank's part of a move by box overlap (``collectives.BoxMove``):
    the group of the move's members, the box it sends (None: zeros), the
    padded piece shape, the cells it copies and its output shape (None:
    it receives nothing)."""

    group: object
    send: Optional[Tuple]
    pad: Tuple[int, ...]
    cells: List
    out: Optional[Tuple[int, ...]]
    dtype: object
    device: object


@dataclasses.dataclass
class BoxEdge:
    """One edge moved by box overlap, as this rank runs it: ``move`` when
    it is a member of the move's group, ``local`` (slices of its own
    block) when it wants a box that it holds."""

    move: Optional[BoxPlan] = None
    local: Optional[Tuple] = None

    def __call__(self, x):
        from flexflow_tpu_torch.parallel import collectives

        y = None
        if self.move is not None:
            y = collectives.box_move(x, self.move)
        if self.local is not None:
            y = x[self.local].contiguous()
        return y


def plan_box_move(machine: MachineModel, src: Tuple, dst: Tuple,
                  dtype) -> Optional[BoxEdge]:
    """The move of a value held in boxes ``src`` (per position, None where
    not held) to boxes ``dst``: each cell of a destination box is read
    from the destination itself when it holds it, else from the first
    position that does.  None when no destination wants anything another
    rank holds and none wants a box it does not hold whole (a no-op);
    the group is made here, on every rank in one order."""
    n = machine.num_devices
    holders = [b for b in src if b is not None]
    reads: Dict[int, List] = {}
    for q, box in enumerate(dst):
        if box is None:
            continue
        cells = []
        for cell in _cells(box, holders):
            if src[q] is not None and _inside(cell, src[q]):
                cells.append((q, cell))
                continue
            p = next((p for p in range(n) if src[p] is not None
                      and _inside(cell, src[p])), None)
            if p is None:
                raise AssertionError(f"no position holds {cell} of {box}")
            cells.append((p, cell))
        reads[q] = cells
    remote = [q for q, cells in reads.items()
              if any(p != q for p, _ in cells)]
    me = machine.position
    local = None
    if me in reads and me not in remote:
        local = _rel(dst[me], src[me])
    if not remote:
        if all(dst[q] == src[q] for q in reads):
            return None
        return BoxEdge(local=local)
    sources = sorted({p for q in remote for p, _ in reads[q]})
    members = tuple(sorted(set(remote) | set(sources)))
    group = machine.group_of(members)
    if me not in members:
        return BoxEdge(local=local)
    pad = tuple(max(src[p][d][1] - src[p][d][0] for p in sources)
                for d in range(len(dst[remote[0]])))
    cells, out = [], None
    if me in remote:
        out = tuple(hi - lo for lo, hi in dst[me])
        cells = [(members.index(p), _rel(cell, src[p]),
                  _rel(cell, dst[me])) for p, cell in reads[me]]
    return BoxEdge(
        move=BoxPlan(group, src[me] if me in sources else None, pad, cells,
                     out, dtype, machine.device),
        local=local)


# ---------------------------------------------------------------------------
# the plan


@dataclasses.dataclass
class EdgePlan:
    """One consumer input's resharding: ``chain`` the layouts it passes
    through (ending at the destination; empty = no-op edge), ``hops`` the
    hop each step runs, ``share_key`` the (produced value, source,
    destination) that consumers wanting the same layout share; an edge
    with a placed end has ``box`` instead of hops."""

    chain: List
    hops: List[Hop] = dataclasses.field(default_factory=list)
    share_key: Optional[Tuple] = None
    #: the move of an edge with a placed end (no hop chain)
    box: Optional[BoxEdge] = None


class RegridPlan:
    """Per-edge reshard plans for one model, built once by
    :func:`build_regrid_plan`, keyed by (consumer op name, input index);
    ``layouts`` maps each tensor id to the layout its value is held in."""

    def __init__(self, machine: MachineModel):
        self.machine = machine
        self.edges: Dict[Tuple[str, int], EdgePlan] = {}
        self.layouts: Dict[int, Tuple] = {}

    def add_edge(self, op_name: str, input_idx: int, src, dst, shape,
                 itemsize: int = 4, costs: Optional[_MeshCosts] = None,
                 tid: Optional[int] = None, dtype=None) -> None:
        key = (op_name, input_idx)
        if dst is None:
            return
        if src == dst:
            self.edges[key] = EdgePlan(chain=[])
            return
        if isinstance(src, Placed) or isinstance(dst, Placed):
            dst_boxes = layout_boxes(self.machine, dst, shape)
            edge = plan_box_move(self.machine,
                                 layout_boxes(self.machine, src, shape),
                                 dst_boxes, dtype)
            self.edges[key] = EdgePlan(
                chain=[] if edge is None else [dst],
                box=edge, share_key=(tid, dst_boxes))
            return
        chain, _, _ = plan_hops(self.machine, src, dst, shape, itemsize,
                                costs)
        hops, cur = [], src
        for step in chain:
            hops.append(make_hop(self.machine, cur, step, shape))
            cur = step
        self.edges[key] = EdgePlan(
            chain=chain, hops=hops,
            share_key=(tid, tuple(map(tuple, src)), tuple(map(tuple, dst))))

    def apply(self, op_name: str, input_idx: int, x, cache: Dict):
        """Run the planned hops of one edge on ``x``; consumers sharing a
        (produced value, destination) reuse the first reshard."""
        ep = self.edges.get((op_name, input_idx))
        if ep is None or not (ep.hops or ep.box):
            return x
        ck = ep.share_key
        if ck in cache:
            return cache[ck]
        if ep.box is not None:
            x = ep.box(x)
        for hop in ep.hops:
            x = hop(x)
        cache[ck] = x
        return x


def build_regrid_plan(model) -> RegridPlan:
    """Walk ``model.layers`` as ``FFModel.apply`` will and plan every
    reshard edge once: model inputs arrive batch-split over the whole
    machine (the data loaders' convention), each op wants its inputs in
    its ``regrid_input_specs`` and leaves its outputs in its
    ``output_specs`` (``flexflow_tpu/parallel/regrid.py:449``), on the
    global mesh or, for an op placed on a device subset
    (``model._grids[name].positions``), in the boxes of its points: a move
    by box overlap, unless the producer's layout is global and the whole-
    machine hop chain to the consumer's normalized layout delivers its
    points' boxes (every rank then runs that chain).  The loss op's
    labels follow the batch split of its output (edge
    ``(loss op, "labels")``).  A world of one rank holds every value
    whole: its plan is empty."""
    from flexflow_tpu_torch.parallel.placement import placed
    from flexflow_tpu_torch.strategy import ParallelConfig

    machine = model.machine
    plan = RegridPlan(machine)
    if machine.num_devices <= 1:
        return plan
    costs = _MeshCosts(machine)
    layouts = plan.layouts
    dp = ParallelConfig.data_parallel(1, machine.num_devices)
    for t in model._inputs:
        layouts[t.tid] = machine.global_entries(dp, ("n",), ("n",),
                                                rank=t.ndim)

    grids = getattr(model, "_grids", None)

    def positions_of(op):
        if grids is not None:
            return grids[op.name].positions
        return placed(op, machine)

    def layout(op, spec, t):
        positions = positions_of(op)
        if positions is not None:
            return placed_layout(machine, op, positions, spec, t.shape)
        return machine.global_entries(op.pc, op.AXIS_NAMES, spec,
                                      rank=t.ndim)

    def covered(src, dst, op, spec, t):
        """The normalized layout of a placed consumer when the whole-
        machine hop chain from ``src`` delivers each of its points' boxes
        there (then every rank runs the chain, as JAX does)."""
        if not isinstance(src, tuple) or not isinstance(dst, Placed):
            return None
        norm = machine.global_entries(op.pc, op.AXIS_NAMES, spec,
                                      rank=t.ndim)
        if norm is None:
            return None
        boxes = layout_boxes(machine, norm, t.shape)
        if any(b is not None and b != boxes[p]
               for p, b in enumerate(dst.boxes)):
            return None
        return norm

    for op in model.layers:
        want = op.regrid_input_specs()
        if want is not None:
            for j, (t, spec) in enumerate(zip(op.inputs, want)):
                if spec is None:
                    continue
                src, dst = layouts.get(t.tid), layout(op, spec, t)
                dst = covered(src, dst, op, spec, t) or dst
                plan.add_edge(op.name, j, src, dst, t.shape,
                              _ITEMSIZE.get(t.dtype, 4), costs, t.tid,
                              _dtype_of(model, t))
        for t, spec in zip(op.all_outputs(), op.output_specs()):
            if spec is not None:
                layouts[t.tid] = layout(op, spec, t)
        out = layouts.get(op.output.tid)
        if getattr(op, "is_loss", False) and len(op.inputs) == 1 \
                and isinstance(out, tuple):
            plan.add_edge(op.name, "labels",
                          machine.global_entries(dp, ("n",), ("n",),
                                                 rank=1),
                          out[:1], (model._inputs[0].shape[0],), 4, costs)
    return plan


def _dtype_of(model, t):
    """The torch dtype a value of graph tensor ``t`` has at run time: ids
    and labels int32, float values in the compute dtype."""
    from flexflow_tpu_torch.ops.base import torch_dtype

    return torch_dtype("int32" if t.dtype == "int32"
                       else model.config.compute_dtype)


def plan_state_migration(old_model, new_model, params: Dict,
                         state: Optional[Dict] = None,
                         opt_state: Optional[Dict] = None) -> Dict:
    """Accounting plan for moving live train state between two machines
    (an elastic resize, ``utils/elastic.py``), JAX's
    ``plan_state_migration`` (``flexflow_tpu/parallel/regrid.py:528``)
    term for term: each leaf is gathered off its source layout (one hop,
    half an all-reduce of the whole value over the OLD machine's links;
    none when the source is one part) and re-placed on the new layout
    (one hop: each new device's slice on the NEW machine's fast tier, or
    the full broadcast for a replicated landing).

    Returns per-key rows and the totals the ``elastic_resize`` record
    carries (``bytes``, ``hops``, ``predicted_s``).  Pure accounting over
    the leaves' sizes and dtypes (torch tensors or numpy arrays); the
    movement is ``FFModel.gather_trees`` and ``FFModel.place_state``."""
    from flexflow_tpu_torch.sim.cost_model import dtype_bytes

    old_n = old_model.machine.num_devices
    new_n = new_model.machine.num_devices
    new_topo = new_model.machine.topology
    old_topo = old_model.machine.topology

    def shard_count(model, key):
        for op in model.layers:
            if op.param_key == key or op.name == key:
                return max(op.pc.num_parts, 1)
        return 1

    def leaf_bytes(leaf) -> float:
        n = leaf.numel() if hasattr(leaf, "numel") else leaf.size
        return float(n * dtype_bytes(str(leaf.dtype).replace("torch.", "")))

    rows = []
    total_bytes = 0.0
    total_hops = 0
    total_s = 0.0
    trees = [("params", params)]
    if state:
        trees.append(("state", state))
    if opt_state:
        trees.append(("opt", opt_state))
    for tree_name, tree in trees:
        for key, sub in (tree or {}).items():
            kb = sum(leaf_bytes(leaf) for leaf in (sub or {}).values())
            src_parts = shard_count(old_model, key)
            dst_parts = shard_count(new_model, key)
            hops = 1
            secs = 0.0
            if src_parts > 1:
                hops += 1
                secs += 0.5 * _allreduce(kb, tuple(range(old_n)), old_topo)
            if dst_parts > 1:
                secs += kb / dst_parts / new_topo.ici_bandwidth \
                    + new_topo.ici_latency
            else:
                secs += 0.5 * _allreduce(kb, tuple(range(new_n)), new_topo)
            rows.append({"tree": tree_name, "key": key, "bytes": kb,
                         "src_parts": src_parts, "dst_parts": dst_parts,
                         "hops": hops, "predicted_s": secs})
            total_bytes += kb
            total_hops += hops
            total_s += secs
    return {"keys": len(rows), "bytes": total_bytes, "hops": total_hops,
            "predicted_s": total_s,
            "from_devices": old_n, "to_devices": new_n, "rows": rows}
