"""KV cache for autoregressive decode: layout, slots, bytes (the port's own
copy of ``flexflow_tpu/serve/kv_cache.py``, with its own
:func:`dtype_bytes`).

The layout follows each attention op's strategy entry, the ('s', 'h',
'n') grid: heads shard over 'h', batch slots over 'n', the sequence over
's'.  On one GPU every grid is (1, 1, 1).  Slots are RING buffers:
position ``p`` of slot ``b`` lives at row ``p % max_seq``.

The decode forward recomputes attention over the in-window tokens; the
cache is FILLED from that same forward (K/V projected with the op's own
weights) and carries the layout and byte accounting an incremental decode
kernel would read.  :func:`kv_cache_bytes` is what ``verify/plan.py``
charges a serving strategy per device.

The prefill-to-decode handoff of the disaggregated router
(``serve/router.py``): :meth:`KVCache.export_request` packs one slot's
surviving rows as host numpy in logical order, so a ``handoff_drop``
loses only the transfer and the payload survives for a retransmit;
:meth:`KVCache.import_request` re-rings them under the destination's
layout, where they die with the replica on a ``replica_crash`` (the
router then re-prefills the carried tokens, a ``kv_rebuild``).
:func:`plan_kv_handoff` prices the move.  Where the topology names no
link bandwidth, it prices the hop at a tenth of ``HopperChipPerf``'s HBM
rate (the JAX package takes its TPU's).  A rank of a routed world that
does not run a replica keeps a :class:`KVLedger` for it: the lengths
alone, whose exports carry no rows (``serve/replicas.py`` moves the rows
to the ranks that import them).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np

_DTYPE_BYTES = {"float32": 4, "bfloat16": 2, "float16": 2}


def dtype_bytes(dtype: str) -> int:
    return _DTYPE_BYTES.get(str(dtype), 4)


def _attention_ops(model) -> List:
    from flexflow_tpu_torch.ops.attention import MultiHeadAttention

    return [op for op in model.layers
            if isinstance(op, MultiHeadAttention)]


def _grid_for(op, strategy, machine) -> Tuple[int, int, int]:
    """(s_parts, h_parts, n_parts) for one attention op: its strategy
    entry when present, else the machine's pure-DP default."""
    pc = strategy.get(op.name) if strategy is not None else None
    if pc is None and machine is not None:
        pc = machine.default_pc(3)
    if pc is None:
        return (1, 1, 1)
    dims = tuple(pc.dims) + (1,) * (3 - len(pc.dims))
    return (int(dims[0]), int(dims[1]), int(dims[2]))


@dataclasses.dataclass(frozen=True)
class KVCacheLayout:
    """Per-layer cache geometry + the sharding the strategy assigned."""

    num_layers: int
    num_heads: int
    head_dim: int
    max_batch: int
    max_seq: int
    dtype: str = "float32"
    s_parts: int = 1
    h_parts: int = 1
    n_parts: int = 1

    @classmethod
    def from_model(cls, model, max_batch: int,
                   max_seq: Optional[int] = None,
                   strategy=None) -> Optional["KVCacheLayout"]:
        """Layout derived from ``model``'s attention ops; None for models
        with no attention."""
        ops = _attention_ops(model)
        if not ops:
            return None
        strategy = strategy if strategy is not None \
            else getattr(model.config, "strategies", None)
        machine = getattr(model, "machine", None)
        s_p = h_p = n_p = 1
        for op in ops:
            s, h, n = _grid_for(op, strategy, machine)
            s_p, h_p, n_p = max(s_p, s), max(h_p, h), max(n_p, n)
        seq = int(max_seq) if max_seq is not None \
            else int(ops[0].inputs[0].shape[1])
        return cls(num_layers=len(ops), num_heads=ops[0].num_heads,
                   head_dim=ops[0].head_dim, max_batch=int(max_batch),
                   max_seq=seq, dtype=str(model.config.compute_dtype),
                   s_parts=s_p, h_parts=h_p, n_parts=n_p)

    def total_bytes(self) -> int:
        """K + V across all layers, unsharded."""
        return (2 * self.num_layers * self.max_batch * self.num_heads
                * self.max_seq * self.head_dim * dtype_bytes(self.dtype))

    def bytes_per_device(self) -> int:
        """The charge one device carries (ceil-sized shards)."""
        heads = -(-self.num_heads // max(self.h_parts, 1))
        batch = -(-self.max_batch // max(self.n_parts, 1))
        seq = -(-self.max_seq // max(self.s_parts, 1))
        return (2 * self.num_layers * batch * heads * seq * self.head_dim
                * dtype_bytes(self.dtype))

    def describe(self) -> Dict:
        return {
            "num_layers": self.num_layers, "num_heads": self.num_heads,
            "head_dim": self.head_dim, "max_batch": self.max_batch,
            "max_seq": self.max_seq, "dtype": self.dtype,
            "grid": [self.s_parts, self.h_parts, self.n_parts],
            "total_bytes": self.total_bytes(),
            "bytes_per_device": self.bytes_per_device(),
        }


def kv_cache_bytes(model, max_batch: int, max_seq: Optional[int] = None,
                   strategy=None) -> int:
    """Per-device KV-cache bytes a serving deployment of ``model`` needs
    (0 for a model without attention): the term ``verify/memory.py``
    adds to the forward-only peak."""
    layout = KVCacheLayout.from_model(model, max_batch, max_seq,
                                      strategy=strategy)
    return 0 if layout is None else layout.bytes_per_device()


def host_dtype(layout: KVCacheLayout) -> np.dtype:
    """The host mirror's dtype: numpy has no bfloat16, so a bf16 cache is
    stored as float32."""
    return np.dtype("float32") if layout.dtype == "bfloat16" \
        else np.dtype(layout.dtype)


class KVCache:
    """Host-resident cache over :class:`KVCacheLayout`, shaped
    ``(num_layers, max_batch, num_heads, max_seq, head_dim)``.
    ``lengths[b]`` counts positions written to slot ``b``."""

    def __init__(self, layout: KVCacheLayout):
        self.layout = layout
        shape = (layout.num_layers, layout.max_batch, layout.num_heads,
                 layout.max_seq, layout.head_dim)
        dt = host_dtype(layout)
        self.k = np.zeros(shape, dt)
        self.v = np.zeros(shape, dt)
        self.lengths = np.zeros((layout.max_batch,), np.int64)

    def write(self, layer: int, slot: int, pos: int,
              k: np.ndarray, v: np.ndarray) -> None:
        """Store one position's (num_heads, head_dim) K/V for one slot at
        ring row ``pos % max_seq``."""
        row = int(pos) % self.layout.max_seq
        self.k[layer, slot, :, row, :] = k
        self.v[layer, slot, :, row, :] = v
        if layer == 0:
            self.lengths[slot] = max(int(self.lengths[slot]), int(pos) + 1)

    def write_span(self, layer: int, slot: int, start: int,
                   k: np.ndarray, v: np.ndarray) -> None:
        """Store ``k``/``v`` of shape (span, num_heads, head_dim) at
        logical positions ``start..start+span``."""
        for i in range(k.shape[0]):
            self.write(layer, slot, start + i, k[i], v[i])

    def read(self, layer: int, slot: int) -> Tuple[np.ndarray, np.ndarray]:
        """(K, V) for one slot in LOGICAL position order, shape
        ``(n, num_heads, head_dim)`` with ``n = min(length, max_seq)``."""
        n = int(self.lengths[slot])
        ms = self.layout.max_seq
        rows = np.arange(n) if n <= ms else np.arange(n - ms, n) % ms
        return (self.k[layer, slot, :, rows, :],
                self.v[layer, slot, :, rows, :])

    def reclaim(self, slot: int) -> None:
        """Free a finished sequence's slot (zeroed, so a stale read is
        visibly empty)."""
        self.k[:, slot] = 0
        self.v[:, slot] = 0
        self.lengths[slot] = 0

    # -- prefill -> decode handoff (serve/router.py) ---------------------

    def export_request(self, slot: int) -> Optional[Dict]:
        """One slot's surviving ring rows for a cross-pool handoff: every
        layer's K/V in LOGICAL order (:meth:`read`'s), the slot's logical
        length and the first kept position; None for an empty slot."""
        n = int(self.lengths[slot])
        if n == 0:
            return None
        kept = min(n, self.layout.max_seq)
        layers = self.layout.num_layers
        k = np.stack([self.read(li, slot)[0] for li in range(layers)])
        v = np.stack([self.read(li, slot)[1] for li in range(layers)])
        return {"k": k, "v": v, "length": n, "start": n - kept,
                "grid": [self.layout.s_parts, self.layout.h_parts,
                         self.layout.n_parts]}

    def import_request(self, slot: int, payload: Dict) -> int:
        """Unpack an :meth:`export_request` payload into ``slot``, each row
        at its logical position under THIS layout's ring (a narrower
        window keeps the newest rows).  Returns the logical length now
        filled, which the engine takes as already cached."""
        if payload is None:
            return 0
        k, v = payload["k"], payload["v"]
        if (k.shape[0] != self.layout.num_layers
                or k.shape[2] != self.layout.num_heads
                or k.shape[3] != self.layout.head_dim):
            raise ValueError(
                f"kv handoff shape mismatch: payload "
                f"{tuple(k.shape)} vs layout "
                f"({self.layout.num_layers}, *, {self.layout.num_heads}, "
                f"*, {self.layout.head_dim})")
        self.reclaim(slot)
        start = int(payload["start"])
        for li in range(self.layout.num_layers):
            self.write_span(li, slot, start, k[li], v[li])
        # the exporter's logical length survives a window that kept fewer
        self.lengths[slot] = int(payload["length"])
        return int(payload["length"])


class KVLedger:
    """:class:`KVCache`'s lengths without its rows: what a rank that does
    not run a replica keeps of its cache.  Its export is the payload's
    bookkeeping (``length``, ``start``, ``grid``) with ``k`` and ``v``
    None; its import takes the logical length."""

    def __init__(self, layout: KVCacheLayout):
        self.layout = layout
        self.lengths = np.zeros((layout.max_batch,), np.int64)

    def fill(self, slot: int, end: int) -> None:
        """Positions up to ``end`` written to ``slot``."""
        self.lengths[slot] = max(int(self.lengths[slot]), int(end))

    def reclaim(self, slot: int) -> None:
        self.lengths[slot] = 0

    def export_request(self, slot: int) -> Optional[Dict]:
        n = int(self.lengths[slot])
        if n == 0:
            return None
        kept = min(n, self.layout.max_seq)
        return {"k": None, "v": None, "length": n, "start": n - kept,
                "grid": [self.layout.s_parts, self.layout.h_parts,
                         self.layout.n_parts]}

    def import_request(self, slot: int, payload: Dict) -> int:
        if payload is None:
            return 0
        self.lengths[slot] = int(payload["length"])
        return int(payload["length"])


def plan_kv_handoff(src_layout: KVCacheLayout, dst_layout: KVCacheLayout,
                    length: int, *, src_topology=None,
                    dst_topology=None) -> Dict:
    """Bytes, hops and predicted seconds of moving one request's filled
    KV rows from the prefill layout's (s, h, n) grid to the decode
    layout's (``flexflow_tpu/serve/kv_cache.py:261-303``): one hop to
    gather rows the source grid splits, one across the pools (always),
    one to re-place them where the destination grid splits.  Pure
    accounting, recorded per request as ``serve_handoff``; the move
    itself is the host-side export and import.  A topology without an
    ``ici_bandwidth`` prices at a tenth of ``HopperChipPerf``'s HBM rate.
    Returns ``{"bytes", "hops", "predicted_s", "rows", "rows_kept"}``."""
    from flexflow_tpu_torch.sim.cost_model import HopperChipPerf

    rows = min(int(length), src_layout.max_seq)
    kept = min(rows, dst_layout.max_seq)
    kb = (2.0 * src_layout.num_layers * rows * src_layout.num_heads
          * src_layout.head_dim * dtype_bytes(src_layout.dtype))
    ici_bw = getattr(src_topology, "ici_bandwidth", None) \
        or HopperChipPerf().hbm_bandwidth / 10.0
    ici_lat = getattr(src_topology, "ici_latency", 0.0) or 1e-6
    dst_bw = getattr(dst_topology, "ici_bandwidth", None) or ici_bw
    dst_lat = getattr(dst_topology, "ici_latency", 0.0) or ici_lat
    hops = 1            # the cross-pool transfer itself
    secs = kb / ici_bw + ici_lat
    src_parts = (src_layout.s_parts * src_layout.h_parts
                 * src_layout.n_parts)
    if src_parts > 1:
        hops += 1
        secs += kb / ici_bw + ici_lat
    dst_parts = (dst_layout.s_parts * dst_layout.h_parts
                 * dst_layout.n_parts)
    dst_kb = kb * (kept / rows) if rows else 0.0
    if dst_parts > 1:
        hops += 1
        secs += dst_kb / dst_parts / dst_bw + dst_lat
    return {"bytes": kb, "hops": hops, "predicted_s": secs,
            "rows": rows, "rows_kept": kept}
