"""Continuous batching: the request queue and decode-slot manager (the
port's own copy of the decode half of ``flexflow_tpu/serve/batcher.py``).

Requests join the running batch the moment a slot frees (join-on-arrival,
up to ``max_batch`` slots), and a finished sequence's slot is reclaimed
the same decode step its EOS (or token budget) lands.  The batch the
device sees is always the full ``(max_batch, seq)`` rectangle; inactive
slots are pad rows.  Everything here is host-side bookkeeping on the
VIRTUAL clock (serve/loadgen.py), deterministic by construction.
:func:`batch_requests` assembles the padded fixed-shape batches of the
CNN/NMT forward-only service (``flexflow_tpu/serve/batcher.py:215-250``).
"""

from __future__ import annotations

import dataclasses
from collections import deque
from typing import Iterable, Iterator, List, Optional, Tuple

import numpy as np

from flexflow_tpu_torch.serve.loadgen import Request


def _eff_arrival(req: Request) -> float:
    """The virtual instant a request becomes admissible: its arrival, or
    the instant a router's KV handoff lands (``handoff_v``)."""
    return req.handoff_v if req.handoff_v is not None else req.arrival_v


class RequestQueue:
    """Arrival-ordered FIFO with virtual-time admission, served by
    ``(effective arrival, rid)``.  ``depth(vnow)`` counts requests that
    have ARRIVED but not yet been admitted."""

    def __init__(self, requests: Optional[Iterable[Request]] = None):
        items = sorted(requests or [],
                       key=lambda r: (_eff_arrival(r), r.rid))
        self._q: deque = deque(items)

    def push(self, req: Request) -> None:
        """Queue one more request in ``(effective arrival, rid)`` order
        (a router's admission and handoff path)."""
        if self._q and (_eff_arrival(req), req.rid) < \
                (_eff_arrival(self._q[-1]), self._q[-1].rid):
            items = sorted(list(self._q) + [req],
                           key=lambda r: (_eff_arrival(r), r.rid))
            self._q = deque(items)
        else:
            self._q.append(req)

    def pop_ready(self, vnow: float, k: int) -> List[Request]:
        """Up to ``k`` requests whose arrival time has passed, in order."""
        out: List[Request] = []
        while self._q and len(out) < k \
                and _eff_arrival(self._q[0]) <= vnow:
            out.append(self._q.popleft())
        return out

    def depth(self, vnow: float) -> int:
        return sum(1 for r in self._q if _eff_arrival(r) <= vnow)

    def pending(self) -> int:
        """All requests still queued, arrived or not."""
        return len(self._q)

    def next_arrival(self) -> Optional[float]:
        return _eff_arrival(self._q[0]) if self._q else None

    def drain(self) -> List[Request]:
        """Remove and return everything still queued (a drain reports
        these as unserved)."""
        out = list(self._q)
        self._q.clear()
        return out


@dataclasses.dataclass
class Slot:
    """One occupied decode slot: the request plus its generation state."""

    req: Request
    tokens: List[int]              # prompt + generated so far
    generated: int = 0
    done: bool = False

    @property
    def length(self) -> int:
        return len(self.tokens)


class ContinuousBatcher:
    """``max_batch`` decode slots with join-on-arrival and EOS reclaim.

    Free slots are filled in ascending slot order by queue order, and
    finished slots are reclaimed in ascending slot order, so the slot of
    every request is a pure function of the arrival stream."""

    def __init__(self, max_batch: int, max_len: int):
        if max_batch < 1:
            raise ValueError(f"max_batch must be >= 1, got {max_batch}")
        self.max_batch = max_batch
        self.max_len = max_len
        self.slots: List[Optional[Slot]] = [None] * max_batch

    def active(self) -> List[Tuple[int, Slot]]:
        return [(i, s) for i, s in enumerate(self.slots)
                if s is not None and not s.done]

    def num_active(self) -> int:
        return sum(1 for s in self.slots if s is not None and not s.done)

    def free_slots(self) -> List[int]:
        return [i for i, s in enumerate(self.slots) if s is None]

    def admit(self, queue: RequestQueue, vnow: float) -> List[int]:
        """Fill free slots (ascending) from the queue's ready requests.
        Returns the slot indices admitted this call."""
        free = self.free_slots()
        ready = queue.pop_ready(vnow, len(free))
        admitted = []
        for slot_idx, req in zip(free, ready):
            if len(req.tokens) >= self.max_len:
                raise ValueError(
                    f"request {req.rid}: prompt length {len(req.tokens)} "
                    f"leaves no room to generate within the model's "
                    f"sequence window {self.max_len}")
            if req.admit_v is None:
                req.admit_v = vnow
            carried = [int(t) for t in (req.carried_tokens or ())]
            self.slots[slot_idx] = Slot(
                req=req,
                tokens=[int(t) for t in req.tokens] + carried,
                generated=len(carried))
            admitted.append(slot_idx)
        return admitted

    def record_token(self, slot_idx: int, token: int) -> None:
        """Append one generated token; marks the slot done on EOS or on
        exhausting the request's token budget or the sequence window."""
        s = self.slots[slot_idx]
        if s is None or s.done:
            raise ValueError(f"slot {slot_idx} is not generating")
        s.tokens.append(int(token))
        s.generated += 1
        if (int(token) == s.req.eos_id
                or s.generated >= s.req.max_new_tokens
                or s.length >= self.max_len):
            s.done = True

    def release(self, slot_idx: int) -> Optional[Slot]:
        """Free one slot WITHOUT completing its request: a prefill pool's
        handoff, where the request leaves with its generated tokens (no
        ``done_v``/``reply`` stamp here)."""
        s = self.slots[slot_idx]
        self.slots[slot_idx] = None
        return s

    def reclaim(self, vnow: float) -> List[Tuple[int, Request]]:
        """Free every finished slot (ascending order) and return
        ``(slot_idx, request)`` pairs with ``done_v``/``reply`` stamped."""
        out: List[Tuple[int, Request]] = []
        for i, s in enumerate(self.slots):
            if s is not None and s.done:
                s.req.done_v = vnow
                s.req.reply = s.tokens[len(s.req.tokens):]
                out.append((i, s.req))
                self.slots[i] = None
        return out

    def token_matrix(self, pad_id: int = 0) -> np.ndarray:
        """The full ``(max_batch, max_len)`` int32 rectangle: each live
        slot's tokens left-aligned, everything else ``pad_id``."""
        m = np.full((self.max_batch, self.max_len), pad_id, np.int32)
        for i, s in enumerate(self.slots):
            if s is not None:
                m[i, :s.length] = s.tokens
        return m


def batch_requests(requests: Iterator[Request], batch_size: int,
                   pad_shape: Optional[Tuple[int, ...]] = None,
                   dtype=None) -> Iterator[Tuple[np.ndarray, List[Request]]]:
    """Padded fixed-shape batches for the forward-only service.

    Yields ``(batch, members)``: ``batch`` is always exactly
    ``(batch_size,) + sample_shape`` (the model's input rectangle; a
    short final group is zero-padded up, and ``members`` names which
    leading rows are real).  An empty upstream yields nothing."""
    if batch_size < 1:
        raise ValueError(f"batch_size must be >= 1, got {batch_size}")
    group: List[Request] = []
    for req in requests:
        group.append(req)
        if len(group) == batch_size:
            yield _assemble(group, batch_size, pad_shape, dtype), group
            group = []
    if group:
        yield _assemble(group, batch_size, pad_shape, dtype), group


def _assemble(group: List[Request], batch_size: int,
              pad_shape: Optional[Tuple[int, ...]], dtype) -> np.ndarray:
    sample = np.asarray(group[0].tokens)
    shape = tuple(pad_shape) if pad_shape is not None else sample.shape
    dt = np.dtype(dtype) if dtype is not None else sample.dtype
    out = np.zeros((batch_size,) + shape, dt)
    for i, req in enumerate(group):
        arr = np.asarray(req.tokens, dt)
        sl = tuple(slice(0, n) for n in arr.shape)
        out[(i,) + sl] = arr
    return out
