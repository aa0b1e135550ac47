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
kernel would read.  The prefill-to-decode handoff of the disaggregated
router comes with that router.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

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



class KVCache:
    """Host-resident cache over :class:`KVCacheLayout`, shaped
    ``(num_layers, max_batch, num_heads, max_seq, head_dim)``.
    ``lengths[b]`` counts positions written to slot ``b``."""

    def __init__(self, layout: KVCacheLayout):
        self.layout = layout
        shape = (layout.num_layers, layout.max_batch, layout.num_heads,
                 layout.max_seq, layout.head_dim)
        # numpy has no bfloat16: the host mirror stores bf16 caches as f32
        dt = np.dtype("float32") if layout.dtype == "bfloat16" \
            else np.dtype(layout.dtype)
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
