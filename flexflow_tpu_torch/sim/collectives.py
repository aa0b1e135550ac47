"""Collective-communication costs for the strategy simulator (PyTorch
port of ``flexflow_tpu/sim/collectives.py``).

Ops whose parallelism is realized by collectives inside the op (the ring
attention's K/V rotation, the MoE's token all-to-all, the all-reduces of
a channel split's input gradient, the vocab-split head's statistics) pay
for them here, per shard and training step (forward + backward, the
compute costs' 3x-forward convention), over the machine ``Topology``'s
two tiers.  The simulator adds the result to each (op, candidate)
compute cost.

"ICI" and "DCN" name the topology's fast and slow tiers (NVLink and
InfiniBand under ``Topology.hopper``).  Conventions, as in the JAX
package:
  * 4 bytes an element, as ``native/simulator.cc`` prices transfers;
  * a collective over grid axis k involves the devices of one axis-k slice
    of the grid (dim 0 fastest over ``pc.devices``), and the worst-spread
    slice prices the op;
  * a collective across fast-tier groups is hierarchical: an all-reduce
    over G groups is an intra-group reduce-scatter + all-gather plus an
    inter-group all-reduce of the per-group chunk; an all-to-all splits
    its volume by destination tier; a ring's step completes at its
    slowest hop.
"""

from __future__ import annotations

import math
from typing import Sequence, Tuple

from flexflow_tpu_torch.machine import Topology
from flexflow_tpu_torch.ops.base import Op
from flexflow_tpu_torch.strategy import ParallelConfig

BYTES = 4.0


def _axis_groups(pc: ParallelConfig, axis: int) -> Sequence[Tuple[int, ...]]:
    """Device tuples of each collective group over grid axis ``axis``:
    one group per combination of the other grid indices (dim 0 varies
    fastest over pc.devices — the mappers' Rect order)."""
    dims = pc.dims
    stride = math.prod(dims[:axis])
    size = dims[axis]
    total = math.prod(dims)
    outer = total // (stride * size)
    groups = []
    for o in range(outer):
        for i in range(stride):
            base = o * stride * size + i
            groups.append(tuple(pc.devices[base + j * stride]
                                for j in range(size)))
    return groups


def _spread(devs: Tuple[int, ...],
            topo: Topology) -> Tuple[int, int, int]:
    """(G, p_in, p_min): ICI groups spanned, the largest per-group share
    (prices the intra-group ring) and the smallest (the worst-placed
    device, which pushes the most of its volume across DCN)."""
    counts: dict = {}
    for d in devs:
        g = d // topo.devices_per_ici_group
        counts[g] = counts.get(g, 0) + 1
    return len(counts), max(counts.values()), min(counts.values())


def _worst_group(pc: ParallelConfig, axis: int,
                 topo: Topology) -> Tuple[int, ...]:
    """The axis-``axis`` group spanning the most ICI groups (ties: most
    devices beyond the smallest per-group share — the _alltoall DCN
    volume — then fewest in the largest share) — the slice that prices
    the op."""
    if (_spread(tuple(pc.devices), topo)[0] <= 1):
        # whole device set inside one ICI group (the common offline-search
        # case) — every axis group is pure-ICI, skip the enumeration
        size = pc.dims[axis]
        stride = math.prod(pc.dims[:axis])
        return tuple(pc.devices[j * stride] for j in range(size))

    def badness(g):
        G, p_in, p_min = _spread(g, topo)
        return (G, len(g) - p_min, -p_in)

    return max(_axis_groups(pc, axis), key=badness)


def _allreduce(vol_bytes: float, devs: Tuple[int, ...],
               topo: Topology) -> float:
    """Hierarchical ring all-reduce of one shard's ``vol_bytes`` over
    ``devs``: intra-ICI-group reduce-scatter + all-gather on the full
    volume, inter-group all-reduce of the per-group chunk at DCN."""
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
    """All-to-all of one shard's ``vol_bytes`` over ``devs``, volume split
    by destination tier: the worst-placed device (smallest fast-tier
    group) keeps (p_min-1)/p on the fast tier and pushes (p-p_min)/p
    across the slow one; the intra-group ring term is priced at the
    largest share."""
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


def _ring_step(devs: Tuple[int, ...], topo: Topology) -> Tuple[float, float]:
    """(bandwidth, latency) of the slowest neighbor hop in a ring over
    ``devs`` — every ring step moves all hops concurrently, so the step
    completes at the slowest link (DCN if any hop crosses a group)."""
    crosses = any(
        topo.bandwidth(devs[i], devs[(i + 1) % len(devs)])
        == topo.dcn_bandwidth
        for i in range(len(devs)))
    if crosses:
        return topo.dcn_bandwidth, topo.dcn_latency
    return topo.ici_bandwidth, topo.ici_latency


def priced_collectives(records, topo: Topology) -> dict:
    """Predicted seconds of a list of collective records, priced with the
    ring formulas the simulator charges in-op collectives with
    (``flexflow_tpu/sim/collectives.py:146``).  A record is ``{"op":
    "all-reduce" | "all-gather" | "reduce-scatter" | "all-to-all" |
    "collective-permute" (an ``-start`` suffix is dropped), "bytes",
    "groups": [[device, ...], ...], "cross", "async"}``: an all-reduce or
    all-gather carries the whole (result) volume, a reduce-scatter the
    per-shard result (scaled back up here, unless ``async``).  Groups of
    one record run at once (the max prices it); records add up.  The
    audit that feeds the JAX package's records from a compiled program
    is not ported (ROADMAP Queue A item 7)."""
    total = cross_s = intra_s = 0.0
    for r in records or []:
        op = r["op"]
        if op.endswith("-start"):
            op = op[:-len("-start")]
        vol = float(r.get("bytes", 0.0))
        groups = [tuple(g) for g in (r.get("groups") or []) if g]
        if not groups:
            # group membership unknowable: the flat single-link bound
            t = vol / topo.ici_bandwidth + topo.ici_latency
        elif op == "collective-permute":
            # every pair moves concurrently; the step completes at the
            # slowest link crossed
            bw, lat = ((topo.dcn_bandwidth, topo.dcn_latency)
                       if r.get("cross")
                       else (topo.ici_bandwidth, topo.ici_latency))
            t = vol / bw + lat
        else:
            t = 0.0
            for g in groups:
                if op == "all-reduce":
                    tg = _allreduce(vol, g, topo)
                elif op == "all-gather":
                    tg = 0.5 * _allreduce(vol, g, topo)
                elif op == "reduce-scatter":
                    full = vol if r.get("async") else vol * len(g)
                    tg = 0.5 * _allreduce(full, g, topo)
                elif op == "all-to-all":
                    tg = _alltoall(vol, g, topo)
                else:
                    tg = vol / topo.ici_bandwidth + topo.ici_latency
                t = max(t, tg)
        total += t
        if r.get("cross"):
            cross_s += t
        else:
            intra_s += t
    return {"seconds": total, "cross_s": cross_s, "intra_s": intra_s,
            "n": len(records or [])}


def dispatch_overhead_cost(op: Op, pc: ParallelConfig, topo: Topology,
                           n_devices: int) -> float:
    """The entry and exit resharding of the JAX package's placed execution
    (``flexflow_tpu/sim/collectives.py:204``): its placement groups
    replicate a placed op's operands over the whole machine and return
    its outputs through a group-stacked array.  Model: one hierarchical
    broadcast of the inputs and one of the outputs per step (an
    all-gather is half an all-reduce), doubled for the backward.  Zero
    for the canonical device list and for a list the executor
    normalizes (``placement.placement_slot`` None).

    Kept with its formula and constant so that the search prices what
    the JAX search prices.  The port's executor does not pay it: a rank
    per process runs a placed op on its own ranks and moves each value
    by box overlap (``parallel/regrid.py``), the point-to-point bytes the
    simulator's edges already price (ROADMAP, Known differences)."""
    if pc.devices == tuple(range(n_devices)):
        return 0.0   # canonical full machine: no placement group
    from flexflow_tpu_torch.parallel.placement import placement_slot

    if placement_slot(op, n_devices, pc) is None:
        return 0.0   # executor normalizes this config: no group lowering
    all_devs = tuple(range(n_devices))
    in_bytes = BYTES * sum(t.size() for t in op.inputs)
    out_bytes = BYTES * sum(t.size() for t in op.all_outputs())
    return 2.0 * 0.5 * (_allreduce(in_bytes, all_devs, topo)
                        + _allreduce(out_bytes, all_devs, topo))


def collective_cost(op: Op, pc: ParallelConfig, topo: Topology) -> float:
    """Seconds of in-op collective time ONE shard spends per training step
    under ``pc``.  Zero for ops/configs whose sharding needs no in-op
    collectives (their cross-shard traffic is the producer->consumer edges
    the simulator already derives)."""
    kind = type(op).__name__

    if kind == "MultiHeadAttention":
        ps, ph, pn = pc.dims
        n, s, d = op.output.shape
        t = 0.0
        if ps > 1:
            # ring CP: each of (ps-1) steps rotates this shard's K and V
            # blocks to the neighbor; backward re-rotates K/V and
            # additionally rotates dK/dV accumulators -> 3x forward volume
            devs = _worst_group(pc, 0, topo)
            bw, lat = _ring_step(devs, topo)
            kv_block = 2.0 * BYTES * n * s * d / (pn * ps * ph)
            t += 3.0 * (ps - 1) * (kv_block / bw + lat)
        if ph > 1:
            # head TP (Megatron pair): fwd all-reduce of the row-parallel
            # wo partial products; bwd all-reduce of dL/dx from the
            # column-parallel q/k/v -> 2 all-reduces of the activation
            act = BYTES * n * s * d / pn
            t += 2.0 * _allreduce(act, _worst_group(pc, 1, topo), topo)
        return t

    if kind == "MixtureOfExperts":
        pe, pcc, pn = pc.dims
        t = 0.0
        n, s, d = op.output.shape
        if pe > 1:
            # EP token all-to-all: dispatched tensor (E, B/pn, C, d) leaves
            # (pe-1)/pe of its slots; forward = dispatch + combine pair,
            # backward = the mirrored pair -> 2x the 2-way forward volume
            disp = BYTES * op.num_experts * op.capacity * d * n / pn
            t += 2.0 * 2.0 * _alltoall(disp, _worst_group(pc, 0, topo),
                                       topo)
        if pcc > 1:
            # expert-channel TP: all-reduce of the expert outputs (fwd) and
            # of dL/dx (bwd) over the c shards
            act = BYTES * op.num_experts * op.capacity * d * n / pn
            t += 2.0 * _allreduce(act, _worst_group(pc, 1, topo), topo)
        return t

    if kind in ("Linear", "RnnLinear"):
        pcc, pn = pc.dims
        if pcc <= 1:
            return 0.0
        # column-parallel weights: dL/dx needs the cross-c-shard sum (the
        # reference's replica regions + BWD2 task, linear.cu:570-603) — an
        # all-reduce of this shard's input-gradient block.  The vocab-TP
        # fused-CE statistic merge (2 floats/token, model.py
        # _run_fused_lm_head) rides the same all-reduce and is dominated by
        # it; charged together here.
        in_bytes = BYTES * op.inputs[0].size() / pn
        return _allreduce(in_bytes, _worst_group(pc, 0, topo), topo)

    if kind == "Conv2D":
        pw, ph_, pcc, pn = pc.dims
        if pcc <= 1:
            return 0.0
        # output-channel TP: input is replicated over c (fwd broadcast is
        # a producer->consumer edge already); bwd dL/dx all-reduces over c
        in_bytes = BYTES * op.inputs[0].size() / (pn * ph_ * pw)
        return _allreduce(in_bytes, _worst_group(pc, 2, topo), topo)

    return 0.0
