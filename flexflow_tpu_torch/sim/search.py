"""Strategy search (PyTorch port of ``flexflow_tpu/sim/search.py``):
candidate generation, shard geometry, the native simulator's tables, the
Metropolis search and the closed loop back to an executable
:class:`~flexflow_tpu_torch.strategy.Strategy` (the reference leaves that
loop open: SURVEY.md section 2.5).

Geometry: for every (op, candidate config) the search emits, per grid
point, the device and the output tile's rectangle and each input's
footprint rectangle in its producer's coordinates, the information Legion
derives from region trees and the reference's simulator recomputes
(``scripts/simulator.cc:886-959``).  The native library intersects
producer tiles with consumer footprints to derive the communication.

Everything here prices what the JAX search prices, so that the same cost
tables and seed give the same strategy in both packages, and the GPipe
proposal (:meth:`StrategySearch.propose_pipeline`) the same candidates.
:func:`price_on_slice` prices a whole job on a virtual slice, and
:func:`decode_step_ratio` gives the analytic decode-to-prefill step
ratio.
"""

from __future__ import annotations

import logging
import math
import re
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from flexflow_tpu_torch import obs as _obs
from flexflow_tpu_torch.machine import MachineModel
from flexflow_tpu_torch.model import FFModel
from flexflow_tpu_torch.ops.base import Op
from flexflow_tpu_torch.sim.collectives import (collective_cost,
                                                dispatch_overhead_cost)
from flexflow_tpu_torch.sim.cost_model import (AnalyticCostModel,
                                               param_byte_scale,
                                               param_shard_fraction)
from flexflow_tpu_torch.sim.native import NativeSimulator
from flexflow_tpu_torch.strategy import (ParallelConfig, Strategy,
                                         uneven_spatial_ok)

logger = logging.getLogger(__name__)

_META = torch.device("meta")


def _split(extent: int, parts: int, idx: int) -> Tuple[int, int]:
    """Shard ``idx``'s [lo, hi) of ``extent`` split ``parts`` ways.  Uneven
    extents use ceil-sized shards with the last one short — the
    executor's blocks (and XLA's padding of non-dividing shardings), and
    the cost-relevant one (every shard but the last does ceil work).  The reference pads
    uneven partitions the same way via its restriction transform
    (conv_2d.cu:95-113)."""
    base = -(-extent // parts)
    return min(idx * base, extent), min((idx + 1) * base, extent)


def _rect(*pairs) -> List[int]:
    out = []
    for p in pairs:
        out.extend(p)
    while len(out) < 8:
        out.extend((0, 1))
    return out


def op_geometry(op: Op, pc: ParallelConfig):
    """[(device, out_rect, [in_rects...])] for each grid point (dim0
    fastest, matching ParallelConfig.devices linearization)."""
    kind = type(op).__name__
    dims = pc.dims
    pts = []
    for lin in range(pc.num_parts):
        idx = []
        rem = lin
        for d in dims:
            idx.append(rem % d)
            rem //= d
        dev = pc.devices[lin]
        out_rect, in_rects = _point_geometry(op, kind, dims, idx)
        pts.append((dev, out_rect, in_rects))
    return pts


def _in_window(out_lo: int, out_hi: int, stride: int, kernel: int,
               pad: int, extent: int) -> Tuple[int, int]:
    """Input rows a [out_lo, out_hi) output tile needs: stride mapping plus
    kernel halo (the overlap Legion's image partitions carry and the
    reference's restriction-partitioned inputs exchange, conv_2d.cu:93-113).
    Clamped to the tensor."""
    lo = out_lo * stride - pad
    hi = (out_hi - 1) * stride - pad + kernel
    return max(lo, 0), min(hi, extent)


def _point_geometry(op: Op, kind: str, dims, idx):
    i0 = op.inputs[0] if op.inputs else None
    if kind in ("Conv2D", "Pool2D", "BatchNorm", "Add", "Concat"):
        pw, ph, pcc, pn = dims
        iw, ih, ic, in_ = idx
        n, oh, ow, oc = op.output.shape
        out = _rect(_split(n, pn, in_), _split(oh, ph, ih),
                    _split(ow, pw, iw), _split(oc, pcc, ic))
        ins = []
        for i, t in enumerate(op.inputs):
            tn, th, tw, tc = t.shape
            if kind in ("BatchNorm", "Add"):
                cr = _split(tc, pcc, ic)
                hr = _split(th, ph, ih)
                wr = _split(tw, pw, iw)
            elif kind == "Concat":
                cr = (0, tc)  # each input's own full channel range
                hr = _split(th, ph, ih)
                wr = _split(tw, pw, iw)
            else:  # conv/pool: all input channels + stride/halo windows
                cr = (0, tc)
                olo, ohi = _split(oh, ph, ih)
                hr = _in_window(olo, ohi, op.stride_h, op.kernel_h,
                                op.padding_h, th)
                olo, ohi = _split(ow, pw, iw)
                wr = _in_window(olo, ohi, op.stride_w, op.kernel_w,
                                op.padding_w, tw)
            ins.append(_rect(_split(tn, pn, in_), hr, wr, cr))
        return out, ins
    if kind == "Flat":
        pcc, pn = dims
        ic, in_ = idx
        n, d = op.output.shape
        out = _rect(_split(n, pn, in_), (0, d))
        tn, th, tw, tc = i0.shape
        return out, [_rect(_split(tn, pn, in_), (0, th), (0, tw), (0, tc))]
    if kind in ("Linear",):
        pcc, pn = dims
        ic, in_ = idx
        n, c = op.output.shape
        out = _rect(_split(n, pn, in_), _split(c, pcc, ic))
        tn, td = i0.shape
        return out, [_rect(_split(tn, pn, in_), (0, td))]
    if kind == "RnnLinear":
        pcc, pn = dims
        ic, in_ = idx
        n, l, v = op.output.shape
        out = _rect(_split(n, pn, in_), (0, l), _split(v, pcc, ic))
        tn, tl, td = i0.shape
        return out, [_rect(_split(tn, pn, in_), (0, tl), (0, td))]
    if kind == "Softmax":
        (pn,) = dims
        (in_,) = idx
        n, c = op.output.shape
        out = _rect(_split(n, pn, in_), (0, c))
        return out, [_rect(_split(n, pn, in_), (0, c))]
    if kind == "SoftmaxDP":
        (pn,) = dims
        (in_,) = idx
        n, l, v = op.output.shape
        out = _rect(_split(n, pn, in_), (0, l), (0, v))
        labels = op.inputs[1]
        return out, [
            _rect(_split(n, pn, in_), (0, l), (0, v)),
            _rect(_split(labels.shape[0], pn, in_), (0, labels.shape[1])),
        ]
    if kind == "SliceSeq":
        (pn,) = dims
        (in_,) = idx
        n, l = op.output.shape
        out = _rect(_split(n, pn, in_), (0, l))
        return out, [_rect(_split(n, pn, in_),
                           (op.start, op.start + op.length))]
    if kind == "Embed":
        (pn,) = dims
        (in_,) = idx
        n, l, e = op.output.shape
        out = _rect(_split(n, pn, in_), (0, l), (0, e))
        return out, [_rect(_split(n, pn, in_), (0, l))]
    if kind in ("LayerNormSeq", "AddSeq", "PosEmbed", "GeluSeq"):
        ps, pn = dims
        is_, in_ = idx
        n, l, d = op.output.shape
        out = _rect(_split(n, pn, in_), _split(l, ps, is_), (0, d))
        ins = []
        for t in op.inputs:
            ins.append(_rect(_split(t.shape[0], pn, in_),
                             _split(t.shape[1], ps, is_), (0, t.shape[2])))
        return out, ins
    if kind == "MultiHeadAttention":
        ps, ph, pn = dims
        is_, ih, in_ = idx
        n, l, d = op.output.shape
        out = _rect(_split(n, pn, in_), _split(l, ps, is_),
                    _split(d, ph, ih))
        # ring attention: each shard consumes its own s-slice of x; the K/V
        # rotation is an in-op collective charged by sim/collectives.py
        tn, tl, td = op.inputs[0].shape
        return out, [_rect(_split(tn, pn, in_), _split(tl, ps, is_),
                           (0, td))]
    if kind == "MixtureOfExperts":
        pe, pcc, pn = dims
        ie, ic, in_ = idx
        n, l, d = op.output.shape
        nlo, nhi = _split(n, pn, in_)
        # The MoE output is n-sharded and replicated over (e, c); one
        # representative point per n-shard carries the data (and consumes
        # the input n-shard) — the internal token all-to-all is an in-op
        # collective charged by sim/collectives.py (same treatment as ring
        # attention above).
        if ie == 0 and ic == 0:
            out = _rect((nlo, nhi), (0, l), (0, d))
            ins = [_rect((nlo, nhi), (0, l), (0, d))]
        else:
            out = _rect((nlo, nlo), (0, 0), (0, 0))
            ins = [_rect((nlo, nlo), (0, 0), (0, 0))]
        return out, ins
    if kind == "_InputSource":
        (pn,) = dims
        (in_,) = idx
        shape = op.output.shape
        pairs = [_split(shape[0], pn, in_)] + [(0, s) for s in shape[1:]]
        return _rect(*pairs), []
    if kind == "LSTMChunk":
        (pn,) = dims
        (in_,) = idx
        n, l, h = op.output.shape
        out = _rect(_split(n, pn, in_), (0, l), (0, h))
        ins = []
        x = op.inputs[0]
        ins.append(_rect(_split(x.shape[0], pn, in_), (0, x.shape[1]),
                         (0, x.shape[2])))
        # hx/cx: footprint in the producer LSTM's y-space = its last step
        for t in op.inputs[1:]:
            prod = t.producer
            lp = prod.output.shape[1]
            ins.append(_rect(_split(t.shape[0], pn, in_), (lp - 1, lp),
                             (0, t.shape[1])))
        return out, ins
    raise NotImplementedError(f"no geometry for op kind {kind}")


def _axis_extents(op: Op) -> Dict[str, List[int]]:
    """Per grid axis, the tensor extents it must divide."""
    kind = type(op).__name__
    if kind in ("Conv2D", "Pool2D", "BatchNorm", "Add", "Concat"):
        n, oh, ow, oc = op.output.shape
        in_, ih, iw, ic = op.inputs[0].shape
        ext = {"w": [ow, iw], "h": [oh, ih], "c": [oc], "n": [n]}
        if kind in ("BatchNorm", "Add"):
            ext["c"].append(ic)
        return ext
    if kind in ("Linear",):
        n, c = op.output.shape
        return {"c": [c], "n": [n]}
    if kind == "Flat":
        return {"c": [1], "n": [op.output.shape[0]]}
    if kind == "RnnLinear":
        n, _, v = op.output.shape
        return {"c": [v], "n": [n]}
    if kind in ("LayerNormSeq", "AddSeq", "PosEmbed", "GeluSeq"):
        n, l, _ = op.output.shape
        return {"s": [l], "n": [n]}
    if kind == "MultiHeadAttention":
        n, l, d = op.output.shape
        return {"s": [l], "h": [op.num_heads, d], "n": [n]}
    if kind == "MixtureOfExperts":
        n = op.output.shape[0]
        return {"e": [op.num_experts], "c": [op.d_ff], "n": [n]}
    return {"n": [op.output.shape[0]]}


# 4-D CNN op kinds whose h/w grid axes may split unevenly (ceil-sized
# blocks, as XLA pads and the reference's restriction transform does,
# conv_2d.cu:95-113);
# every other op/axis keeps the strict divisibility invariant (notably the
# attention 'h' axis is HEADS — splitting a head is never admissible)
_UNEVEN_KINDS = ("Conv2D", "Pool2D", "BatchNorm", "Add", "Concat")
_UNEVEN_AXES = ("h", "w")


def candidate_configs(op: Op, num_devices: int,
                      max_per_axis: Optional[Dict[str, int]] = None,
                      placement: bool = True,
                      stats: Optional[Dict[str, int]] = None
                      , subset_ok=True) -> List[ParallelConfig]:
    """Power-of-2 grids (the reference constrains the search the same way,
    scripts/simulator.cc:143-151) whose product divides the machine and
    whose dims divide the tensor extents they partition — except spatial
    (h, w) extents, which may split unevenly (Inception's 35/17 extents;
    the reference pads via restriction partitions, conv_2d.cu:95-113).

    ``stats`` (optional) accumulates pruning counts: raw grid space,
    divisibility-pruned, emitted.

    Device maps: the canonical full-prefix list always; additionally, for
    sub-machine grids the op supports in placed execution
    (parallel/placement.py), every aligned device BLOCK — the searchable
    placement dimension of the SOAP space.  The reference randomizes the
    whole per-op device map (scripts/simulator.cc:224-235); here the
    candidates are exactly the placements the executor honors, so a
    searched strategy never claims a placement that would silently degrade
    to replication."""
    ext = _axis_extents(op)
    axes = op.AXIS_NAMES
    uneven_kind = type(op).__name__ in _UNEVEN_KINDS
    choices_per_axis = []
    pruned = 0
    raw = 0
    for a in axes:
        limit = num_devices
        if max_per_axis and a in max_per_axis:
            limit = min(limit, max_per_axis[a])
        opts = []
        p = 1
        while p <= limit:
            raw += 1
            exts = ext.get(a, [1])
            if all(e % p == 0 for e in exts) or (
                    uneven_kind and a in _UNEVEN_AXES
                    and all(uneven_spatial_ok(e, p) for e in exts)):
                opts.append(p)
            else:
                pruned += 1
            p *= 2
        choices_per_axis.append(opts or [1])
    if stats is not None:
        stats["axis_options_raw"] = stats.get("axis_options_raw", 0) + raw
        stats["axis_options_pruned"] = \
            stats.get("axis_options_pruned", 0) + pruned
    out = []
    # mirror placement_slot's gate: stateful ops place when they say how
    # their state splits (BatchNorm's state_specs); callers may veto
    # subset placement entirely (subset_ok=False: LM head ops whose
    # sub-machine placement de-fuses the vocab head into a
    # logit-materializing path the simulator does not price)
    placeable = subset_ok and placement \
        and op.placement_signature() is not None \
        and not (op.init_state(_META) and op.state_specs() is None)

    def emit(dims):
        prod = math.prod(dims)
        pc0 = ParallelConfig(dims, tuple(range(prod)))
        if prod == num_devices:
            out.append(pc0)  # full-machine SPMD: always honored
            return
        # Sub-machine grids are candidates ONLY when the executor honors
        # them as real placements (parallel/placement.py) — otherwise the
        # simulator would model devices outside the subset as free for
        # concurrent work while execution degrades to replication.
        if not placeable or op.input_specs(pc0) is None:
            return
        out.append(pc0)
        for g in range(1, num_devices // prod):
            out.append(ParallelConfig(
                dims, tuple(range(g * prod, (g + 1) * prod))))

    def rec(i, dims, prod):
        if prod > num_devices or num_devices % prod and i == len(axes):
            return
        if i == len(axes):
            if num_devices % prod == 0:
                emit(tuple(dims))
            return
        for c in choices_per_axis[i]:
            if prod * c <= num_devices:
                rec(i + 1, dims + [c], prod * c)
    rec(0, [], 1)
    # dedupe + keep deterministic order
    uniq = {}
    for pc in out:
        uniq[(pc.dims, pc.devices)] = pc
    if not uniq:
        # nothing full-machine divides and nothing places: the degenerate
        # replicated grid (honest last resort — execution replicates)
        dims = tuple(1 for _ in axes)
        uniq[(dims, (0,))] = ParallelConfig(dims, (0,))
    return list(uniq.values())


def _rect_vol(rect) -> int:
    v = 1
    for i in range(0, len(rect), 2):
        v *= max(rect[i + 1] - rect[i], 0)
    return v


def shard_hbm_bytes(op: Op, pc: ParallelConfig) -> float:
    """Resident HBM bytes the WORST shard of this op pins during a train
    step: fp32 params+grad+momentum at its param-shard fraction, plus the
    fp32 activation+gradient of the shard's actual input/output rects from
    :func:`op_geometry` — which knows about replication (a pure-c-TP
    Linear's every shard reads the FULL input; dividing by num_parts would
    pass exactly the OOM plans this check exists to reject).  The 3x
    param term holds for bfloat16 storage too: bf16 param + bf16 grad +
    f32 momentum + f32 master = 12 bytes/param, the same total as the
    f32 triple — mixed precision moves HBM *traffic*, not residency."""
    worst = 0
    for _dev, out_rect, in_rects in op_geometry(op, pc):
        v = _rect_vol(out_rect) + sum(_rect_vol(r) for r in in_rects)
        worst = max(worst, v)
    return (3.0 * op.param_bytes() * param_shard_fraction(op, pc)
            + 2.0 * 4.0 * worst)


class _InputSource(Op):
    """Virtual producer for a model input: the data loader's batch-sharded
    tensor (data/synthetic.py convention).  Zero compute, one fixed DP
    candidate — exists so the simulator derives a COMMUNICATION edge when
    a consumer's grid wants the input in a different layout (previously
    free, letting e.g. spatially-split first convs dodge their input
    repartition cost; the reference's LOAD_IMAGES is likewise a real task
    with its own partition, cnn_mapper.cc:43-48)."""

    AXIS_NAMES = ("n",)

    def __init__(self, tensor, num_devices: int):
        super().__init__(f"_input{tensor.tid}",
                         ParallelConfig.data_parallel(1, num_devices), [])
        self.output = tensor

    def output_spec(self):
        return ("n",)


# layer-name prefix the transformer builder emits (``blk{i}_attn`` ...);
# generalized so any model that labels repeated stages ``<word><idx>_``
# partitions the same way
_BLOCK_RE = re.compile(r"^([A-Za-z]+\d+)_")


class _Block:
    """One contiguous partition of the op graph (decomposed search)."""

    __slots__ = ("name", "indices")

    def __init__(self, name: str, indices: List[int]):
        self.name = name
        self.indices = indices


# ops per fallback chunk when the graph carries no ``blkN_`` labels (CNNs,
# NMT): contiguous topological segments — coarse, but the decomposition
# still bounds each sub-search's move space
_FALLBACK_CHUNK = 32


def partition_blocks(ops: Sequence[Op]) -> List[_Block]:
    """Partition the search's op list (input sources included) into
    contiguous blocks by the ``blk{i}_*`` name prefixes the transformer
    builder emits: everything before the first labeled op is the
    ``stem`` (inputs, embeddings), everything after the last is the
    ``head`` (final LN, vocab projection, loss).  Unlabeled graphs fall
    back to fixed-size contiguous chunks.  Ops arrive in build
    (topological) order, so every block is a contiguous schedule
    segment and the stitch order is well-defined."""
    labels = []
    any_labeled = False
    for op in ops:
        m = _BLOCK_RE.match(op.name)
        labels.append(m.group(1) if m else None)
        any_labeled = any_labeled or bool(m)
    blocks: List[_Block] = []
    if not any_labeled:
        for lo in range(0, len(ops), _FALLBACK_CHUNK):
            idx = list(range(lo, min(lo + _FALLBACK_CHUNK, len(ops))))
            blocks.append(_Block(f"chunk{len(blocks)}", idx))
        return blocks
    last_labeled = max(i for i, l in enumerate(labels) if l)
    cur_name, cur_idx = None, []
    for i, l in enumerate(labels):
        if l is None:
            name = "stem" if not blocks and cur_name is None else \
                ("head" if i > last_labeled else cur_name or "stem")
        else:
            name = l
        if name != cur_name and cur_idx:
            blocks.append(_Block(cur_name, cur_idx))
            cur_idx = []
        cur_name = name
        cur_idx.append(i)
    if cur_idx:
        blocks.append(_Block(cur_name, cur_idx))
    return blocks


class StrategySearchDecomposedMixin:
    """Block-decomposed search: partition, fingerprint-keyed
    shared-block memoization, masked per-block sub-searches on the full
    graph, stitch, boundary refinement.  Mixed into
    :class:`StrategySearch` below (kept separate only for readability —
    the methods use the search's ops/candidates/sim state directly)."""

    def partition_blocks(self) -> List[_Block]:
        return partition_blocks(self.ops)

    def block_fingerprint(self, indices: Sequence[int]) -> str:
        """Structural fingerprint of a block: per op — kind, output
        shape, param bytes, the FULL candidate list (dims + device
        maps), and producer topology (block-internal producers by local
        position, external ones by kind + shape).  Two blocks with equal
        fingerprints have positionally identical candidate lists, so a
        sub-search result transfers as a candidate-index copy — the
        memoization that makes depth ~free (N identical layers cost one
        sub-search)."""
        import hashlib

        local = {gi: li for li, gi in enumerate(indices)}
        parts = []
        for i in indices:
            op = self.ops[i]
            cands = tuple((tuple(pc.dims), tuple(pc.devices))
                          for pc in self.candidates[i])
            prods = []
            for t in op.inputs:
                p = self._op_index.get(t.tid, -1)
                if p in local:
                    prods.append(("in", local[p]))
                else:
                    po = self.ops[p] if 0 <= p < len(self.ops) else None
                    prods.append((
                        "ext",
                        type(po).__name__ if po is not None else "none",
                        tuple(po.output.shape) if po is not None else ()))
            parts.append((type(op).__name__, tuple(op.output.shape),
                          float(op.param_bytes()), cands, tuple(prods)))
        return hashlib.sha256(repr(parts).encode()).hexdigest()[:16]

    def _boundary_ops(self, blocks: List[_Block],
                      assignment: Sequence[int]):
        """Ops on cross-block edges (the refinement pass's move set) and
        the total regrid price of those edges under ``assignment`` —
        the regrid planner's cost view of the stitch
        (:func:`flexflow_tpu_torch.verify.plan.regrid_edge_cost`)."""
        from flexflow_tpu_torch.verify.plan import regrid_edge_cost

        block_of = {}
        for b in blocks:
            for i in b.indices:
                block_of[i] = b.name
        boundary = set()
        regrid_s = 0.0
        for i, op in enumerate(self.ops):
            for t in op.inputs:
                p = self._op_index.get(t.tid, -1)
                if p < 0 or block_of.get(p) == block_of.get(i):
                    continue
                boundary.add(i)
                if not isinstance(self.ops[p], _InputSource):
                    boundary.add(p)
                regrid_s += regrid_edge_cost(
                    t.shape, self.candidates[p][assignment[p]],
                    self.candidates[i][assignment[i]], self.machine)
        return sorted(boundary), regrid_s

    def search_decomposed(self, iters: int = 250_000, beta: float = 5e3,
                          seed: int = 0, delta: bool = True,
                          start: Optional[Sequence[int]] = None,
                          budget_s: Optional[float] = None,
                          block_budget_s: Optional[float] = None,
                          boundary_refine_iters: int = 0):
        """Decomposed MCMC at an EQUAL proposal budget to :meth:`search`:
        ``iters`` total proposals are split ~80/20 between per-block
        sub-searches and a global boundary-refinement pass, so flat vs
        decomposed comparisons (SEARCH_r01.json) spend the same budget.

        Each unique block fingerprint gets ONE masked sub-search
        (:meth:`NativeSimulator.masked_mcmc` — Metropolis restricted to
        the block's ops on the FULL graph, so boundary edges are priced
        by the same delta re-simulation as interior ones), warm-started
        from the assignment the previous blocks left behind; repeated
        blocks take the result as a positional candidate-index copy
        (``memo_hits``).  The refinement pass then frees exactly the
        ops on cross-block edges.

        Budgets: ``budget_s`` is the TOTAL wall budget — one absolute
        deadline threads through every sub-search and the refinement, so
        N blocks never multiply the budget N-fold.  ``block_budget_s``
        additionally caps each sub-search.  Both default off — the
        bit-reproducible mode, where only the proposal counts bind.

        Emits one ``search_block`` obs record per block (memo copies
        included), one ``search_stitch``, then the standard
        ``search_result``/``search_breakdown``.  Returns (strategy,
        info) shaped like :meth:`search` plus the decomposition keys
        (blocks/unique_blocks/memo_hits/stitched_time/...)."""
        import time as _time

        t_start = _time.perf_counter()
        dp = self.dp_assignment()
        dp_time = self.simulate(dp)
        cur = list(start) if start is not None else list(dp)
        if len(cur) != len(self.ops):
            raise ValueError(
                f"warm-start assignment has {len(cur)} entries for "
                f"{len(self.ops)} ops")
        self.sim.set_delta(delta)
        blocks = self.partition_blocks()
        n_cands = [len(c) for c in self.candidates]
        deadline = None if budget_s is None \
            else t_start + float(budget_s)
        groups: Dict[str, List[int]] = {}
        for bi, b in enumerate(blocks):
            groups.setdefault(self.block_fingerprint(b.indices),
                              []).append(bi)
        order = sorted(groups.values(), key=lambda g: g[0])
        refine_iters = int(boundary_refine_iters) if boundary_refine_iters \
            else max(int(iters) // 5, 0)
        block_pool = max(int(iters) - refine_iters, 0)
        n_groups = len(order)
        tot_prop = tot_acc = 0
        memo_hits = 0
        budget_hit = False
        for gi, group in enumerate(order):
            g_iters = block_pool // n_groups \
                + (1 if gi < block_pool % n_groups else 0)
            rep = blocks[group[0]]
            if deadline is not None and _time.perf_counter() >= deadline:
                budget_hit = True
                g_iters = 0
            bl_deadline = deadline
            if block_budget_s is not None:
                d2 = _time.perf_counter() + float(block_budget_s)
                bl_deadline = d2 if bl_deadline is None \
                    else min(bl_deadline, d2)
            t0 = _time.perf_counter()
            st = {"proposed": 0, "accepted": 0}
            best_t = None
            if g_iters > 0:
                best, best_t, _cur, _cur_t, st = self.sim.masked_mcmc(
                    cur, rep.indices, n_cands, g_iters, beta=beta,
                    seed=seed * 1_000_003 + gi, deadline=bl_deadline)
                cur = list(best)
                tot_prop += st["proposed"]
                tot_acc += st["accepted"]
            wall = _time.perf_counter() - t0
            self.obs.event(
                "search_block", block=rep.name, ops=len(rep.indices),
                group=gi, repeats=len(group), iters=g_iters,
                proposed=st["proposed"], accepted=st["accepted"],
                best_time_s=(best_t + self._opt_stream_s)
                if best_t is not None else None,
                wall_s=wall, memo=False)
            for other_bi in group[1:]:
                other = blocks[other_bi]
                for src_i, dst_i in zip(rep.indices, other.indices):
                    cur[dst_i] = cur[src_i]
                memo_hits += 1
                self.obs.event(
                    "search_block", block=other.name,
                    ops=len(other.indices), group=gi,
                    repeats=len(group), iters=0, proposed=0, accepted=0,
                    best_time_s=None, wall_s=0.0, memo=True,
                    memo_from=rep.name)
        stitched_time = self.simulate(cur)
        boundary, regrid_s = self._boundary_ops(blocks, cur)
        refined = 0
        if refine_iters > 0 and boundary and not (
                deadline is not None
                and _time.perf_counter() >= deadline):
            best, _bt, _c, _ct, st = self.sim.masked_mcmc(
                cur, boundary, n_cands, refine_iters, beta=beta,
                seed=seed * 1_000_003 + n_groups + 17, deadline=deadline)
            cur = list(best)
            refined = st["proposed"]
            tot_prop += st["proposed"]
            tot_acc += st["accepted"]
        elif deadline is not None and _time.perf_counter() >= deadline:
            budget_hit = True
        best_time = self.simulate(cur)
        tot_wall = _time.perf_counter() - t_start
        self.obs.event(
            "search_stitch", blocks=len(blocks), unique_blocks=n_groups,
            memo_hits=memo_hits, boundary_ops=len(boundary),
            boundary_regrid_s=regrid_s, refine_iters=refine_iters,
            refined_proposed=refined, stitched_time_s=stitched_time,
            best_time_s=best_time, dp_time_s=dp_time,
            proposed=tot_prop, budget_hit=budget_hit, wall_s=tot_wall)
        info = {
            "dp_time": dp_time,
            "best_time": best_time,
            "speedup_vs_dp": dp_time / best_time if best_time else 1.0,
            "assignment": cur,
            "accept_rate": tot_acc / tot_prop if tot_prop else 0.0,
            "proposals_per_sec": tot_prop / tot_wall
            if tot_wall > 0 else 0.0,
            "iters_done": tot_prop,
            "budget_hit": budget_hit,
            "decomposed": True,
            "blocks": len(blocks),
            "unique_blocks": n_groups,
            "memo_hits": memo_hits,
            "boundary_ops": len(boundary),
            "boundary_regrid_s": regrid_s,
            "stitched_time": stitched_time,
            "wall_s": tot_wall,
        }
        result = {"dp_time_s": dp_time, "best_time_s": best_time,
                  "speedup_vs_dp": info["speedup_vs_dp"],
                  "iters": tot_prop, "budget_hit": budget_hit,
                  "accepted": tot_acc, "proposed": tot_prop,
                  "accept_rate": info["accept_rate"], "seed": seed,
                  "beta": beta, "chains": 1, "delta": delta,
                  "delta_hit_rate": 1.0 if tot_prop else 0.0,
                  "proposals_per_sec": info["proposals_per_sec"],
                  "decomposed": True, "blocks": len(blocks),
                  "unique_blocks": n_groups, "memo_hits": memo_hits,
                  "stitched_time_s": stitched_time,
                  "cost_cache": {"hits": self.cost_model.cache_hits,
                                 "misses": self.cost_model.cache_misses}}
        self.obs.event("search_result", **result)
        if self.obs.enabled:
            self._emit_breakdown(cur)
        return self.assignment_to_strategy(cur), info


class StrategySearch(StrategySearchDecomposedMixin):
    """Closed loop: model -> candidates -> cost tables -> native sim ->
    MCMC -> Strategy (executable + serializable)."""

    def __init__(self, model: FFModel, machine: Optional[MachineModel] = None,
                 cost_model=None,
                 max_per_axis: Optional[Dict[str, int]] = None,
                 placement: bool = True, obs=None,
                 objective: str = "makespan"):
        """``placement=False`` restricts candidates to canonical device
        lists (the dims-only search).  ``obs`` is an optional
        :class:`flexflow_tpu_torch.obs.RunLog`; the build and the search
        emit their records into it (search_space, plan_gate,
        search_chunk, search_result, search_breakdown, search_block,
        search_stitch).  ``cost_model`` defaults to the analytic roofline
        at the model's compute dtype.

        ``objective`` picks what one simulated step is:

          * ``"makespan"`` — a training step: forward + backward + the
            gradient sync + the optimizer's HBM stream;
          * ``"latency"`` — one forward step of a serving deployment:
            every candidate's compute and collective cost drops to its
            forward third (both cost models price fwd+bwd as 3x the
            forward), the gradient sync and the optimizer stream vanish;
            the input cast keeps its cost;
          * ``"decode"`` — one single-token step of a disaggregated
            serving deployment: the latency transform, then every
            candidate's compute shrinks to its one-token column (cost /
            seq) and each attention candidate pays the KV-cache traffic
            its (s, h, n) grid implies: its cache shard streamed from HBM
            every step, plus one ring hop per extra sequence part.  This
            is what makes the decode pool's search prefer wider head and
            batch splits and shallower sequence splits than prefill's."""
        if objective not in ("makespan", "latency", "decode"):
            raise ValueError(
                f"objective must be 'makespan', 'latency' or 'decode', "
                f"got {objective!r}")
        self.model = model
        self.machine = machine or model.machine
        config = getattr(model, "config", None)
        # every param-byte figure (sync volume, the optimizer stream, the
        # roofline's weight stream) prices the storage dtype's bytes
        self._param_scale = param_byte_scale(config)
        self.cost_model = cost_model or AnalyticCostModel(
            param_scale=self._param_scale,
            dtype=getattr(config, "compute_dtype", "float32"))
        self.max_per_axis = max_per_axis
        self.placement = placement
        self.objective = objective
        self.obs = obs or _obs.NULL
        n_dev = self.machine.num_devices
        self.inputs = [_InputSource(t, n_dev)
                       for t in getattr(model, "_inputs", [])]
        self.ops: List[Op] = self.inputs + list(model.layers)
        self._op_index = {}
        for i, op in enumerate(self.ops):
            for t in op.all_outputs():
                self._op_index[t.tid] = i
        self.candidates: List[List[ParallelConfig]] = []
        self.sim: Optional[NativeSimulator] = None
        self._build()

    def _fused_heads(self) -> set:
        """ids of the RnnLinear heads feeding a SoftmaxDP that the JAX
        executor runs as its fused vocab-head kernel, which it does only
        on canonical device lists (``_fusion_ok``): a single consumer,
        b*s >= 2048 and d <= 4096.  The search withholds their subset
        candidates, as the JAX search does (``sim/search.py:813-840``),
        whatever the port's executor fuses (ROADMAP, Known
        differences)."""
        from flexflow_tpu_torch.ops.rnn_linear import RnnLinear
        from flexflow_tpu_torch.ops.softmax_dp import SoftmaxDP

        consumers: Dict[int, int] = {}
        for o in self.ops:
            for t in o.inputs:
                consumers[t.tid] = consumers.get(t.tid, 0) + 1
        fused = set()
        for o in self.ops:
            if not isinstance(o, SoftmaxDP):
                continue
            pi = self._op_index.get(o.inputs[0].tid)
            prod = self.ops[pi] if pi is not None else None
            if (isinstance(prod, RnnLinear)
                    and consumers.get(prod.output.tid) == 1
                    and prod.inputs[0].shape[0] * prod.inputs[0].shape[1]
                    >= 2048
                    and prod.in_channels <= 4096):
                fused.add(id(prod))
        return fused

    def _build(self):
        from flexflow_tpu_torch.verify.plan import candidate_findings

        n_dev = self.machine.num_devices
        topo = self.machine.topology
        perf = getattr(self.cost_model, "perf", None) or \
            self.cost_model.fallback.perf
        hbm_cap = perf.hbm_capacity
        ints: List[int] = [n_dev, topo.devices_per_ici_group, len(self.ops)]
        costs: List[float] = []
        cost_pairs: List[tuple] = []  # (index into costs, op, pc)
        replicas: List[float] = []
        colls: List[float] = []
        pbytes: List[float] = []
        seen_param_keys = set()
        fused_heads = self._fused_heads()
        self.stats = {"ops": len(self.ops), "candidates": 0,
                      "mem_rejected": 0, "plan_checked": 0,
                      "plan_rejected": 0}
        plan_by_code: Dict[str, int] = {}
        for op in self.ops:
            if isinstance(op, _InputSource):
                # fixed: the loader's batch-split layout.  A float input
                # costs its compute-dtype cast where there is one (read
                # f32 + write the compute dtype); int token inputs and
                # float32-trained models cost nothing.
                self.candidates.append([op.pc])
                ints.append(0)
                ints.append(1)
                pts = op_geometry(op, op.pc)
                ints.append(len(pts))
                for dev, out_rect, in_rects in pts:
                    ints.append(dev)
                    ints.extend(out_rect)
                cdtype = getattr(getattr(self.model, "config", None),
                                 "compute_dtype", "float32")
                if op.output.dtype == "int32" or cdtype == op.output.dtype:
                    costs.append(0.0)
                else:
                    elems = op.output.size() / n_dev
                    costs.append(6.0 * elems / (perf.hbm_bandwidth
                                                * perf.vector_efficiency))
                replicas.append(1.0)
                colls.append(0.0)
                pbytes.append(0.0)
                seen_param_keys.add(op.param_key)
                continue
            cands = candidate_configs(op, n_dev, self.max_per_axis,
                                      placement=self.placement,
                                      stats=self.stats,
                                      subset_ok=id(op) not in fused_heads)
            # plan-legality pre-gate: the plan checker vets every
            # candidate before any table row exists for it, so the MCMC
            # (which draws from these lists) never proposes a grid the
            # executor would degrade
            self.stats["plan_checked"] += len(cands)
            legal, rejected_errs = [], []
            for pc in cands:
                errs = candidate_findings(op, pc, self.machine)
                if errs:
                    rejected_errs.append(errs)
                else:
                    legal.append(pc)
            if legal:
                self.stats["plan_rejected"] += len(rejected_errs)
                for errs in rejected_errs:
                    for f in errs:
                        plan_by_code[f.code] = \
                            plan_by_code.get(f.code, 0) + 1
                cands = legal
            elif rejected_errs:
                logger.warning(
                    "op %r: every candidate grid fails the plan checker "
                    "— keeping them all (degraded execution beats an "
                    "empty search space)", op.name)
            # HBM feasibility: a candidate whose shard footprint cannot
            # fit the card is not a plan
            feasible = [pc for pc in cands
                        if shard_hbm_bytes(op, pc) <= hbm_cap]
            if feasible and len(feasible) < len(cands):
                self.stats["mem_rejected"] += len(cands) - len(feasible)
                cands = feasible
            elif not feasible:
                logger.warning(
                    "op %r: every candidate grid exceeds the %.1f GB HBM "
                    "model — keeping them all (model may not fit at this "
                    "batch)", op.name, hbm_cap / 1e9)
            self.stats["candidates"] += len(cands)
            self.candidates.append(cands)
            producers = [self._op_index.get(t.tid, -1) for t in op.inputs]
            ints.append(len(producers))
            ints.extend(producers)
            ints.append(len(cands))
            for pc in cands:
                pts = op_geometry(op, pc)
                ints.append(len(pts))
                for dev, out_rect, in_rects in pts:
                    ints.append(dev)
                    ints.extend(out_rect)
                    assert len(in_rects) == len(producers)
                    for r in in_rects:
                        ints.extend(r)
                cost_pairs.append((len(costs), op, pc))
                costs.append(0.0)  # resolved in the two-pass loop below
                replicas.append(self._param_replicas(op, pc))
                # in-op collectives + the placed-execution entry/exit
                # resharding of the JAX executor (collectives.py)
                colls.append(collective_cost(op, pc, topo)
                             + dispatch_overhead_cost(op, pc, topo,
                                                      n_dev))
            # shared weights (param_key) sync once per step: charge the
            # first op carrying the key
            if op.param_key in seen_param_keys:
                pbytes.append(0.0)
            else:
                seen_param_keys.add(op.param_key)
                pbytes.append(float(op.param_bytes()) * self._param_scale)
        # two passes for a measured model: the first measures and collects
        # the kind anchors, the second serves the cache and re-derives the
        # estimates of unmeasurable candidates against the complete
        # anchors (estimates are never cached)
        if hasattr(self.cost_model, "flush"):
            for _, op, pc in cost_pairs:
                self.cost_model.op_cost(op, pc)
        for i, op, pc in cost_pairs:
            costs[i] = self.cost_model.op_cost(op, pc)
        if hasattr(self.cost_model, "flush"):
            self.cost_model.flush()
        if self.objective in ("latency", "decode"):
            # forward-only pricing: a third of every candidate's compute
            # and collective cost, no gradient sync (input-source rows are
            # not in cost_pairs and keep their once-per-step cast)
            for i, _, _ in cost_pairs:
                costs[i] /= 3.0
                colls[i] /= 3.0
            pbytes = [0.0] * len(pbytes)
        if self.objective == "decode":
            self._decode_terms(cost_pairs, costs, colls, perf, topo)
        logger.info(
            "search space: %d ops, %d candidates (%d axis options pruned "
            "by divisibility, %d candidates rejected by the %.0f GB HBM "
            "model)", self.stats["ops"], self.stats["candidates"],
            self.stats.get("axis_options_pruned", 0),
            self.stats["mem_rejected"], hbm_cap / 1e9)
        self.obs.event(
            "search_space", ops=self.stats["ops"],
            candidates=self.stats["candidates"],
            axis_options_pruned=self.stats.get("axis_options_pruned", 0),
            mem_rejected=self.stats["mem_rejected"],
            devices=n_dev,
            ici_group=topo.devices_per_ici_group,
            placement=self.placement,
            objective=self.objective,
            cost_model=type(self.cost_model).__name__)
        # proposals draw from the per-op lists only, so a candidate the
        # plan gate or the HBM model rejected is never simulated
        self.obs.event(
            "plan_gate", ops=self.stats["ops"],
            checked=self.stats["plan_checked"],
            rejected=self.stats["plan_rejected"],
            mem_rejected=self.stats["mem_rejected"],
            by_code=plan_by_code,
            devices=n_dev)
        dbls = [topo.ici_bandwidth, topo.dcn_bandwidth, topo.ici_latency]
        dbls.extend(pbytes)
        dbls.extend(costs)
        dbls.extend(replicas)
        dbls.extend(colls)
        self.sim = NativeSimulator(ints, dbls, len(self.ops))
        # The optimizer's parameter stream, in no op's compute time: the
        # update reads p and g and writes p (3x the params) and reads and
        # writes every optimizer-state buffer once.  Charged whole (DP
        # replicates everything; an upper bound for split params).
        if self.objective in ("latency", "decode"):
            # serving runs no optimizer
            self._opt_stream_s = 0.0
        else:
            total_param_bytes = sum(pbytes)  # already once per key
            opt_bytes = self._opt_state_bytes(total_param_bytes)
            self._opt_stream_s = \
                (3.0 * total_param_bytes + 2.0 * opt_bytes) \
                / (perf.hbm_bandwidth * perf.vector_efficiency)

    def _decode_terms(self, cost_pairs, costs, colls, perf, topo) -> None:
        """The single-token step (``flexflow_tpu/sim/search.py:981-1013``):
        every candidate's forward third shrinks to its one-token column,
        and each attention candidate adds its K+V shard streamed from HBM
        and, with ``s_p > 1`` sequence parts, one ring rotation of that
        shard per extra part (the one-token query visits every sequence
        shard)."""
        from flexflow_tpu_torch.ops.attention import MultiHeadAttention
        from flexflow_tpu_torch.sim.cost_model import dtype_bytes

        kv_elem = dtype_bytes(getattr(getattr(self.model, "config", None),
                                      "compute_dtype", "float32"))
        for i, op, pc in cost_pairs:
            shape = op.inputs[0].shape if op.inputs else ()
            seq = int(shape[1]) if len(shape) >= 2 else 1
            costs[i] /= max(seq, 1)
            if not isinstance(op, MultiHeadAttention):
                continue
            dims = tuple(pc.dims) + (1,) * (3 - len(pc.dims))
            s_p, h_p, n_p = int(dims[0]), int(dims[1]), int(dims[2])
            batch = int(shape[0]) if len(shape) >= 1 else 1
            kv_shard = (2.0 * -(-batch // max(n_p, 1))
                        * -(-op.num_heads // max(h_p, 1))
                        * -(-seq // max(s_p, 1))
                        * op.head_dim * kv_elem)
            costs[i] += kv_shard / (perf.hbm_bandwidth
                                    * perf.vector_efficiency)
            if s_p > 1:
                colls[i] += (s_p - 1) * (kv_shard / topo.ici_bandwidth
                                         + topo.ici_latency)

    def _opt_state_bytes(self, total_param_bytes: float) -> float:
        """Bytes of the model's optimizer state, without materializing
        it: ``FFModel.init_opt_state``'s momentum (float32, the params'
        size) doubled by the float32 masters under mixed precision; a
        model overriding ``init_opt_state`` (the sequence models' plain
        SGD) keeps no momentum and is priced as stateless.  This is the
        JAX search's rule on a machine without devices
        (``sim/search.py:1085-1098``), which is what its offline search
        runs on."""
        if type(self.model).init_opt_state is FFModel.init_opt_state:
            f32_bytes = total_param_bytes / max(self._param_scale, 1e-9)
            return f32_bytes * (2.0 if self._param_scale != 1.0 else 1.0)
        return 0.0

    @staticmethod
    def _param_replicas(op: Op, pc: ParallelConfig) -> float:
        return pc.num_parts * param_shard_fraction(op, pc)

    # ------------------------------------------------------------------

    def op_candidates(self, name: str) -> List[ParallelConfig]:
        """Candidate configs of the op called ``name`` (self.ops is
        prefixed by the virtual _InputSource entries — index by name, not
        by the model's layer position)."""
        for op, cands in zip(self.ops, self.candidates):
            if op.name == name:
                return cands
        raise KeyError(name)

    def dp_assignment(self) -> List[int]:
        """Index of the pure-DP candidate per op (batch split over all
        devices; falls back to the largest batch-only split available)."""
        out = []
        for op, cands in zip(self.ops, self.candidates):
            best, best_n = 0, -1
            for i, pc in enumerate(cands):
                batch_parts = pc.dims[-1]
                others = pc.num_parts // batch_parts
                if others == 1 and batch_parts > best_n:
                    best, best_n = i, batch_parts
            out.append(best)
        return out

    def assignment_to_strategy(self, assignment: Sequence[int]) -> Strategy:
        s = Strategy()
        for op, cands, idx in zip(self.ops, self.candidates, assignment):
            if isinstance(op, _InputSource):
                continue  # loader layout is fixed, not a strategy entry
            s[op.name] = cands[idx]
        return s

    def simulate(self, assignment: Sequence[int]) -> float:
        return self.sim.simulate(assignment) + self._opt_stream_s

    def simulate_trace(self, assignment: Sequence[int]) -> dict:
        """Full simulation of ``assignment`` exporting the schedule with
        op names attached (ffsim_simulate_trace) — the simulated-timeline
        producer behind ``apps/search.py -trace`` / obs/trace.py.  Returns
        ``{"events": [...], "op_s": {name: per-shard seconds},
        "makespan_sync_s", "opt_stream_s", "total_s"}``; ``total_s``
        equals :meth:`simulate` on the same assignment.  ``op_s`` is each
        op's per-shard compute + in-op collective time under its assigned
        config — the join key the drift-attribution pass matches against
        measured ``op_time`` records."""
        records, raw = self.sim.simulate_trace(assignment)
        events = []
        op_s: Dict[str, float] = {}
        for r in records:
            op = self.ops[r["op"]]
            ev = dict(r)
            ev["op"] = op.name
            ev["op_kind"] = type(op).__name__
            if not isinstance(op, _InputSource):
                if r["kind"] == "compute":
                    op_s[op.name] = max(op_s.get(op.name, 0.0), r["dur"])
            events.append(ev)
        # the assignment-invariant optimizer parameter stream, laid after
        # everything the native schedule contains (same term simulate()
        # adds on top of the raw makespan + sync)
        if self._opt_stream_s > 0.0:
            events.append({"kind": "sync", "op": "_opt_stream",
                           "op_kind": "OptStream", "cfg": -1,
                           "start": raw, "dur": self._opt_stream_s})
        return {"events": events, "op_s": op_s,
                "makespan_sync_s": raw,
                "opt_stream_s": self._opt_stream_s,
                "total_s": raw + self._opt_stream_s,
                "devices": self.machine.num_devices}

    def propose_pipeline(self, stage_options=None,
                         micro_options=(2, 4, 8), log=None,
                         reference_s=None, stage_divisor=None,
                         batch=None, tp_divisor=None,
                         tp_options=(1, 2, 4)) -> dict:
        """Price GPipe candidates (S stages x M microbatches x tp-way
        Megatron inside each stage) against the best non-pipelined plan
        and propose or reject a ``__pipeline__`` block
        (``flexflow_tpu/sim/search.py:1178-1388``, in its order of sums).

        Candidates: S in (2, 4, 8) dividing the machine, below it, at
        most the layer count and dividing ``stage_divisor``; tp in
        (1, 2, 4) dividing ``tp_divisor`` and the stage width (tp = 1
        alone without a divisor); M in (2, 4, 8) with ``batch % M == 0``
        and ``(batch / M) % dp == 0``, the microbatches the GPipe
        executor (``parallel/pipeline.py``) admits.  The data-parallel
        shard costs, scaled by S, split into greedy contiguous stages;
        a candidate costs (M + S - 1) x the largest stage load / M, plus
        each cut's boundary bytes in the compute dtype at the tier of
        the +stage_width peer (2 M link latencies a cut), 4 M Megatron
        all-reduces per parameterized layer when tp > 1, the worst
        stage's gradient all-reduce over its dp peers and the optimizer
        stream.  Accepted only below min(data parallel,
        ``reference_s``).  Every candidate is logged with its terms and
        recorded (``pipeline_candidate``), and so is the decision
        (``pipeline_decision``)."""
        from flexflow_tpu_torch.sim.collectives import _allreduce
        from flexflow_tpu_torch.sim.cost_model import dtype_bytes

        logger_fn = log or logger.info
        n = self.machine.num_devices
        topo = self.machine.topology
        dp = self.dp_assignment()
        # the bar is the best non-pipelined plan known: an accepted block
        # replaces the per-op plan in the consuming driver
        t_ref = self.simulate(dp)
        if reference_s is not None:
            t_ref = min(t_ref, float(reference_s))
        layer_ops, layer_costs = [], []
        for op, cands, idx in zip(self.ops, self.candidates, dp):
            if isinstance(op, _InputSource):
                continue
            layer_ops.append(op)
            layer_costs.append(self.cost_model.op_cost(op, cands[idx]))
        total_param_bytes = sum(
            float(op.param_bytes()) for op in layer_ops) \
            * self._param_scale
        if stage_options is None:
            stage_options = [s for s in (2, 4, 8)
                             if n % s == 0 and s < n
                             and s <= len(layer_ops)
                             and (stage_divisor is None
                                  or stage_divisor % s == 0)]
        # without a divisor the executor's divisibility (heads, d_ff) is
        # unknown: tp = 1 alone
        tp_opts = [1] if tp_divisor is None else \
            [t for t in tp_options if tp_divisor % t == 0]
        feasible_micro = {}
        for S in stage_options:
            for t in tp_opts:
                if (n // S) % t:
                    continue
                dp_width = max(n // (S * t), 1)
                feasible_micro[(S, t)] = [
                    m for m in micro_options
                    if batch is None or (batch % m == 0
                                         and (batch // m) % dp_width == 0)]
        cdtype = getattr(getattr(self.model, "config", None),
                         "compute_dtype", "float32")
        dt_bytes = float(dtype_bytes(cdtype))
        group = topo.devices_per_ici_group
        candidates = []
        for S in stage_options:
            # greedy contiguous balance of the (M-independent) stage load
            base = [c * float(S) for c in layer_costs]
            target = sum(base) / S
            cuts, acc, left = [], 0.0, S
            for i, ti in enumerate(base):
                acc += ti
                rest = len(base) - i - 1
                if left > 1 and (acc >= target or rest < left):
                    cuts.append(i)
                    acc, left = 0.0, left - 1
            stage_sums, s_acc, ci = [], 0.0, 0
            for i, ti in enumerate(base):
                s_acc += ti
                if ci < len(cuts) and i == cuts[ci]:
                    stage_sums.append(s_acc)
                    s_acc, ci = 0.0, ci + 1
            stage_sums.append(s_acc)
            # stages lie on contiguous rank blocks ((stage, n, tp) mesh,
            # MachineModel.pipeline_mesh), so a cut whose +stage_width
            # peer sits in another fast-tier group crosses the slow tier
            stage_width = max(n // S, 1)
            for tp in tp_opts:
                if (S, tp) not in feasible_micro:
                    continue
                dp_width = max(stage_width // tp, 1)
                # each stage syncs 1/(S tp) of the params over its dp
                # peers (stride tp in its block); the worst prices it
                sync = max((_allreduce(
                    total_param_bytes / (S * tp),
                    tuple(s * stage_width + j * tp
                          for j in range(dp_width)),
                    topo) for s in range(S)), default=0.0)
                cut_links = []  # (per-device bytes, bandwidth, latency)
                for k, i in enumerate(cuts):
                    bytes_cut = dt_bytes * math.prod(
                        layer_ops[i].output.shape)
                    crosses = any(
                        d // group != (d + stage_width) // group
                        for d in range(k * stage_width,
                                       (k + 1) * stage_width))
                    cut_links.append((
                        bytes_cut / dp_width,
                        topo.dcn_bandwidth if crosses
                        else topo.ici_bandwidth,
                        topo.dcn_latency if crosses
                        else topo.ici_latency))
                # ~4 Megatron all-reduces per parameterized layer and
                # microbatch over the tp ranks (fastest, contiguous)
                tp_acts = []
                if tp > 1:
                    tp_acts = [dt_bytes * math.prod(op_l.output.shape)
                               / dp_width
                               for op_l in layer_ops
                               if op_l.param_bytes() > 0]
                tp_devs = tuple(range(tp))
                for M in feasible_micro[(S, tp)]:
                    L = max(stage_sums) / M
                    comm = sum(2.0 * (per_dev / bw + M * lat)
                               for per_dev, bw, lat in cut_links)
                    tp_comm = sum(4.0 * M * _allreduce(a / M, tp_devs,
                                                       topo)
                                  for a in tp_acts)
                    t = (M + S - 1) * L + comm + tp_comm + sync \
                        + self._opt_stream_s
                    candidates.append({
                        "stages": S, "microbatches": M, "tp": tp,
                        "time_s": t, "stage_makespan_s": L,
                        "bubble_factor": (M + S - 1) / M,
                        "comm_s": comm, "tp_comm_s": tp_comm,
                        "param_sync_s": sync})
                    self.obs.event("pipeline_candidate",
                                   reference_time_s=t_ref,
                                   **candidates[-1])
                    logger_fn(
                        "pipeline candidate S=%d M=%d tp=%d: %.4fs "
                        "(makespan %.4fs x %.2f bubble + %.4fs comm + "
                        "%.4fs tp + %.4fs sync) vs %.4fs non-pipelined"
                        % (S, M, tp, t, L, (M + S - 1) / M, comm,
                           tp_comm, sync, t_ref))
        best = min(candidates, key=lambda c: c["time_s"], default=None)
        accepted = bool(best and best["time_s"] < t_ref)
        logger_fn("pipeline decision: %s (best %s vs non-pipelined %.4fs)"
                  % ("ACCEPT" if accepted else "REJECT",
                     f"S={best['stages']} M={best['microbatches']} "
                     f"tp={best['tp']} {best['time_s']:.4f}s"
                     if best else "none", t_ref))
        self.obs.event(
            "pipeline_decision", accepted=accepted,
            reference_time_s=t_ref,
            best=({"stages": best["stages"],
                   "microbatches": best["microbatches"], "tp": best["tp"],
                   "time_s": best["time_s"]} if best else None))
        return {"candidates": candidates, "reference_time_s": t_ref,
                "accepted": accepted,
                "best": ({"stages": best["stages"],
                          "microbatches": best["microbatches"],
                          "tp": best["tp"]}
                         if accepted else None)}

    def assignment_for(self, strategy) -> List[int]:
        """Candidate index per op matching ``strategy``'s entries (ops the
        strategy does not name take their DP default).  Raises KeyError
        when a named entry is not among the op's candidates — such a pc is
        one the search would never have emitted (the executor degrades
        it), so simulating it would claim a cost the plan cannot have.
        Prices a loaded strategy without re-searching."""
        dp = self.dp_assignment()
        out = []
        for op, cands, dflt in zip(self.ops, self.candidates, dp):
            pc = None if isinstance(op, _InputSource) \
                else strategy.get(op.name)
            if pc is None:
                out.append(dflt)
                continue
            for i, c in enumerate(cands):
                if c.dims == pc.dims and c.devices == pc.devices:
                    out.append(i)
                    break
            else:
                raise KeyError(
                    f"strategy entry for {op.name!r} (dims {pc.dims}) is "
                    f"not among its {len(cands)} search candidates")
        return out

    def search(self, iters: int = 250_000, beta: float = 5e3,
               seed: int = 0, chunks: int = 25, chains: int = 1,
               delta: bool = True, delta_check: bool = False,
               start: Optional[Sequence[int]] = None,
               budget_s: Optional[float] = None):
        """MCMC from the DP start point (reference: scripts/simulator.cc
        :1427-1471).  ``chains`` independent Metropolis chains advance
        concurrently on native threads (per-chain RNG derived from
        ``seed``; chain 0 IS the legacy single chain, so ``chains=1``
        reproduces the old trajectory exactly), in up to ``chunks``
        chain-continuing native calls (ffsim_mcmc_chains_run) so the
        trajectory is observable: each chunk emits one ``search_chunk``
        obs record PER CHAIN (chain id, best-cost curve, acceptance rate,
        proposals/sec, delta-hit rate) and the run closes with
        ``search_result`` + ``search_breakdown`` records.  Between chunks
        the chains exchange best states deterministically (every chain
        whose current cost is worse than the global best adopts it).
        ``delta`` gates the native delta re-simulation (off = every
        proposal pays a full re-simulation); ``delta_check`` additionally
        cross-checks every delta against a full re-simulation and aborts
        on divergence (debug mode — per-proposal acceptance semantics are
        identical either way).  ``start`` warm-starts every chain from a
        given assignment instead of the DP point; ``budget_s``
        caps the search WALL CLOCK — chunks stop once the budget is
        spent, so a mid-run re-search is bounded regardless of graph
        size (the best-so-far state is returned, never nothing).
        Returns (strategy, info); ``info["trace"]`` carries the
        per-(chunk, chain) trajectory for programmatic callers."""
        import time as _time

        dp = self.dp_assignment()
        dp_time = self.simulate(dp)
        init = list(start) if start is not None else list(dp)
        if len(init) != len(self.ops):
            raise ValueError(
                f"warm-start assignment has {len(init)} entries for "
                f"{len(self.ops)} ops")
        chains = max(1, int(chains))
        self.sim.set_delta(delta)
        self.sim.set_crosscheck(delta_check)
        chunks = max(1, min(int(chunks), max(iters, 1)))
        curs = [list(init) for _ in range(chains)]
        bests = [list(init) for _ in range(chains)]
        times = [[-1.0, -1.0] for _ in range(chains)]
        trace = []
        tot_acc = tot_prop = tot_delta = tot_full = done = 0
        tot_wall = 0.0
        budget_hit = False
        t_start = _time.perf_counter()
        for ci in range(chunks):
            if budget_s is not None \
                    and _time.perf_counter() - t_start >= budget_s \
                    and done > 0:
                budget_hit = True
                break
            it_n = iters // chunks + (1 if ci < iters % chunks else 0)
            if it_n <= 0:
                continue
            t0 = _time.perf_counter()
            curs, bests, times, stats = self.sim.mcmc_chains_chunk(
                curs, bests, times, it_n, beta=beta,
                seed=seed * 1_000_003 + ci)
            wall = _time.perf_counter() - t0
            tot_wall += wall
            done += it_n
            for chain_i in range(chains):
                st = stats[chain_i]
                tot_acc += st["accepted"]
                tot_prop += st["proposed"]
                tot_delta += st["delta_evals"]
                tot_full += st["full_evals"]
                evals = st["delta_evals"] + st["full_evals"]
                rec = {
                    "chain": chain_i,
                    "iters_done": done,
                    "best_time_s": times[chain_i][1] + self._opt_stream_s,
                    "cur_time_s": times[chain_i][0] + self._opt_stream_s,
                    "accepted": st["accepted"], "proposed": st["proposed"],
                    "accept_rate": st["accepted"] / st["proposed"]
                    if st["proposed"] else 0.0,
                    "proposals_per_sec": st["proposed"] / wall
                    if wall > 0 else 0.0,
                    "delta_hit_rate": st["delta_evals"] / evals
                    if evals else 0.0,
                    "wall_s": wall,
                }
                trace.append(rec)
                self.obs.event("search_chunk", **rec)
            if chains > 1:
                # deterministic elitist exchange (mirrors the native
                # one-shot ffsim_mcmc_chains: ties break to the lowest
                # chain id, so a fixed seed reproduces the run)
                gb = min(range(chains), key=lambda i: (times[i][1], i))
                for i in range(chains):
                    if i != gb and times[gb][1] < times[i][0]:
                        curs[i] = list(bests[gb])
                        times[i][0] = times[gb][1]
        if done == 0:  # iters <= 0: the start point is the answer
            best, best_t = list(init), self.sim.simulate(init)
        else:
            gb = min(range(chains), key=lambda i: (times[i][1], i))
            best, best_t = bests[gb], times[gb][1]
        best_time = best_t + self._opt_stream_s  # the optimizer stream is
        # assignment-invariant; the native chains rank raw makespans
        evals = tot_delta + tot_full
        info = {
            "dp_time": dp_time,
            "best_time": best_time,
            "speedup_vs_dp": dp_time / best_time if best_time else 1.0,
            "assignment": best,
            "trace": trace,
            "accept_rate": tot_acc / tot_prop if tot_prop else 0.0,
            "chains": chains,
            "delta": delta,
            "delta_hit_rate": tot_delta / evals if evals else 0.0,
            "proposals_per_sec": tot_prop / tot_wall if tot_wall > 0 else 0.0,
            "iters_done": done,
            "budget_hit": budget_hit,
        }
        result = {"dp_time_s": dp_time, "best_time_s": best_time,
                  "speedup_vs_dp": info["speedup_vs_dp"], "iters": done,
                  "budget_hit": budget_hit,
                  "accepted": tot_acc, "proposed": tot_prop,
                  "accept_rate": info["accept_rate"], "seed": seed,
                  "beta": beta, "chains": chains, "delta": delta,
                  "delta_hit_rate": info["delta_hit_rate"],
                  "proposals_per_sec": info["proposals_per_sec"],
                  "cost_cache": {"hits": self.cost_model.cache_hits,
                                 "misses": self.cost_model.cache_misses}}
        self.obs.event("search_result", **result)
        if self.obs.enabled:
            self._emit_breakdown(best)
        return self.assignment_to_strategy(best), info

    def cost_breakdown(self, assignment: Sequence[int]) -> list:
        """Per-op cost rows of an assignment: ``{op, kind, dims, devices,
        compute_s, collective_s}`` per graph op (input sources excluded).
        Costs come from the already-warmed cost model (a measured model
        serves its cache): the winning strategy's ``search_breakdown``
        obs record."""
        topo = self.machine.topology
        n_dev = self.machine.num_devices
        rows = []
        for op, cands, idx in zip(self.ops, self.candidates, assignment):
            if isinstance(op, _InputSource):
                continue
            pc = cands[idx]
            rows.append({
                "op": op.name, "kind": type(op).__name__,
                "dims": list(pc.dims),
                "devices": len(set(pc.devices)),
                "compute_s": float(self.cost_model.op_cost(op, pc)),
                "collective_s": float(
                    collective_cost(op, pc, topo)
                    + dispatch_overhead_cost(op, pc, topo, n_dev))})
        return rows

    def _emit_breakdown(self, assignment: Sequence[int]) -> None:
        """The winning strategy's ``search_breakdown`` obs record."""
        self.obs.event("search_breakdown",
                       ops=self.cost_breakdown(assignment),
                       opt_stream_s=self._opt_stream_s)


def price_on_slice(rebuild, config, num_devices, *,
                   objective: str = "makespan", iters: int = 300,
                   seed: int = 0, warm_strategy=None,
                   budget_s: Optional[float] = None, topology=None,
                   obs=None):
    """Price one job on one candidate slice size
    (``flexflow_tpu/sim/search.py:1583-1624``): the job's best-found
    strategy on a virtual ``num_devices``-device machine.

    ``rebuild(config, machine)`` is the job's model factory (the one the
    elastic path uses); the graph is built on
    :meth:`MachineModel.virtual`, so nothing touches a device.  The
    search starts from ``warm_strategy`` (the entries that survive on the
    slice keep their config) and stops at ``iters`` or ``budget_s``:
    under a fixed seed with a generous budget the iteration bound binds,
    so the result is reproducible.  The analytic roofline at the
    model's dtype prices it.

    Returns ``(predicted_s, strategy, info)``: the objective's value
    (the step for ``"makespan"``, the forward step for ``"latency"``,
    the single-token step for ``"decode"``), the strategy and the
    search's info."""
    import copy

    from flexflow_tpu_torch.utils.elastic import warm_assignment

    shell_cfg = copy.copy(config)
    shell_cfg.strategies = Strategy()
    machine = MachineModel.virtual(int(num_devices), topology)
    shell = rebuild(shell_cfg, machine)
    ss = StrategySearch(shell, machine=machine,
                        obs=obs if obs is not None else _obs.NULL,
                        objective=objective)
    start = None
    if warm_strategy is not None and len(warm_strategy):
        start = warm_assignment(ss, warm_strategy)
    strategy, info = ss.search(iters=int(iters), seed=int(seed),
                               chunks=4, chains=1, delta=True,
                               start=start, budget_s=budget_s)
    return float(info["best_time"]), strategy, info


def decode_step_ratio(model, strategy=None, perf=None) -> float:
    """The analytic ratio of one single-token DECODE step to one
    full-prompt forward step of ``model`` under ``strategy``
    (``flexflow_tpu/sim/search.py:1627-1679``): no simulator, no search,
    no clock, so a serving app derives a decode pool's virtual step
    time (``base_step * ratio``) the same way every run.  Both steps are
    priced by the analytic model's forward thirds: the decode step takes
    each op's one-token column (cost / seq) plus every attention op's
    KV-cache read at HBM rate for its grid.  ``perf`` defaults to
    :class:`~flexflow_tpu_torch.sim.cost_model.HopperChipPerf` (the JAX
    package prices its TPU's).  Clamped to (0, 1]."""
    from flexflow_tpu_torch.ops.attention import MultiHeadAttention
    from flexflow_tpu_torch.sim.cost_model import HopperChipPerf, dtype_bytes

    config = getattr(model, "config", None)
    dtype = getattr(config, "compute_dtype", "float32")
    cm = AnalyticCostModel(perf=perf or HopperChipPerf(),
                           param_scale=param_byte_scale(config),
                           dtype=dtype)
    perf = cm.perf
    strategy = strategy if strategy is not None \
        else getattr(config, "strategies", None)
    machine = getattr(model, "machine", None)
    kv_elem = dtype_bytes(dtype)
    full = dec = 0.0
    for op in model.layers:
        pc = strategy.get(op.name) if strategy is not None else None
        if pc is None and machine is not None:
            pc = machine.default_pc(max(len(op.output.shape), 1))
        if pc is None:
            continue
        fwd = cm.op_cost(op, pc) / 3.0
        shape = op.inputs[0].shape if op.inputs else ()
        seq = int(shape[1]) if len(shape) >= 2 else 1
        full += fwd
        dec += fwd / max(seq, 1)
        if isinstance(op, MultiHeadAttention):
            dims = tuple(pc.dims) + (1,) * (3 - len(pc.dims))
            s_p, h_p, n_p = int(dims[0]), int(dims[1]), int(dims[2])
            batch = int(shape[0]) if len(shape) >= 1 else 1
            kv_shard = (2.0 * -(-batch // max(n_p, 1))
                        * -(-op.num_heads // max(h_p, 1))
                        * -(-seq // max(s_p, 1))
                        * op.head_dim * kv_elem)
            dec += kv_shard / (perf.hbm_bandwidth
                               * perf.vector_efficiency)
    if full <= 0.0:
        return 1.0
    return float(min(max(dec / full, 1e-6), 1.0))
