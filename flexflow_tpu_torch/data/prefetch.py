"""Device prefetch: host batch preparation and the host-to-device copy of
step N+1 overlap step N's compute (PyTorch port of
``flexflow_tpu/data/prefetch.py``).

One worker thread pulls from the upstream iterator, copies each host
tensor into pinned memory and then to the card with
``non_blocking=True`` on a side stream, records a CUDA event after the
copies, and hands the batch through a queue of ``depth`` batches.  The
consumer makes its current stream wait on that event and marks each
tensor with ``record_stream``, so the step never reads a half-copied
batch and the allocator never hands a batch's memory to another tensor
while the step still reads it.  Tensors already on the card pass
through; on the CPU the prefetcher is plain read-ahead.

Contracts the tests pin (``tests/test_torch_checkpoint.py``):

  * **order** — one worker, a FIFO queue: batches arrive in upstream
    order;
  * **errors reach the consumer** — an upstream error is caught on the
    worker, carried through the queue (:class:`_Failure`) and raised by
    ``__next__``; the end of the upstream arrives as :class:`_End`;
  * **clean shutdown** — ``close()`` (or ``with``-exit, or garbage
    collection) stops the worker even when it is blocked on a full
    queue, and joins it.

``stall_s`` sums the time ``__next__`` waited on an empty queue: the
input cost the overlap could not hide.
"""

from __future__ import annotations

import queue
import threading
import time
import warnings
from typing import Iterator

import torch

_STOP_POLL_S = 0.1
# how long close() waits for the worker before reporting it leaked
_JOIN_TIMEOUT_S = 2.0


class _Failure:
    """Queue sentinel carrying a worker-side exception to the consumer."""

    def __init__(self, exc: BaseException):
        self.exc = exc


class _End:
    """Queue sentinel: the upstream iterator is exhausted."""


class DevicePrefetcher:
    """Iterator over ``upstream``'s batches (tuples of tensors or arrays)
    placed on ``device`` by a background thread, ``depth`` batches
    ahead."""

    def __init__(self, upstream: Iterator, device, depth: int = 2):
        if depth < 1:
            raise ValueError(f"prefetch depth must be >= 1, got {depth}")
        self.device = torch.device(device)
        self.depth = depth
        self.stall_s = 0.0
        self.batches = 0
        self.leaked = False
        self._upstream = upstream
        self._stream = (torch.cuda.Stream(self.device)
                        if self.device.type == "cuda" else None)
        self._q: "queue.Queue" = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._exhausted = False
        self._thread = threading.Thread(
            target=self._worker, name="ff-device-prefetch", daemon=True)
        self._thread.start()

    # -- worker ----------------------------------------------------------

    def _place(self, batch):
        """``(tensors, event)``: the batch on the device and the event
        recorded after its copies (None on the CPU)."""
        batch = tuple(torch.as_tensor(b) for b in batch)
        if self._stream is None:
            return batch, None
        out = []
        with torch.cuda.device(self.device), torch.cuda.stream(self._stream):
            for t in batch:
                if t.device.type != "cuda":
                    # the copy from pinned memory is asynchronous; the
                    # host allocator keeps the pinned buffer until it ends
                    t = t.pin_memory().to(self.device, non_blocking=True)
                out.append(t)
            event = torch.cuda.Event()
            event.record(self._stream)
        return tuple(out), event

    def _worker(self):
        while not self._stop.is_set():
            try:
                item = self._place(next(self._upstream))
            except StopIteration:
                item = _End()
            except BaseException as e:  # raised again in the consumer
                item = _Failure(e)
            while not self._stop.is_set():
                try:
                    self._q.put(item, timeout=_STOP_POLL_S)
                    break
                except queue.Full:
                    continue
            if isinstance(item, (_End, _Failure)):
                return

    # -- consumer --------------------------------------------------------

    def __iter__(self):
        return self

    def __next__(self):
        if self._exhausted:
            raise StopIteration
        if self._stop.is_set():
            raise RuntimeError("DevicePrefetcher is closed")
        t0 = time.perf_counter()
        item = self._q.get()
        self.stall_s += time.perf_counter() - t0
        if isinstance(item, _End):
            self._exhausted = True
            self.close()
            raise StopIteration
        if isinstance(item, _Failure):
            self._exhausted = True
            self.close()
            raise item.exc
        batch, event = item
        if event is not None:
            stream = torch.cuda.current_stream(self.device)
            stream.wait_event(event)
            for t in batch:
                if t.device.type == "cuda":
                    t.record_stream(stream)
        self.batches += 1
        return batch

    def close(self) -> None:
        """Stop the worker (unblocking a put in progress) and join it.
        Idempotent; runs at garbage collection too.  A join that times
        out (a worker stuck in the upstream iterator) is reported with a
        ``RuntimeWarning`` and the daemon thread is left behind."""
        self._stop.set()
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
        t = self._thread
        if t is not None and t.is_alive() \
                and t is not threading.current_thread():
            t.join(timeout=_JOIN_TIMEOUT_S)
            if t.is_alive() and not self.leaked:
                self.leaked = True
                warnings.warn(
                    f"DevicePrefetcher worker did not exit within "
                    f"{_JOIN_TIMEOUT_S:.1f}s (stuck in the upstream "
                    f"iterator?); leaking the daemon thread",
                    RuntimeWarning)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False

    def summary(self) -> dict:
        """The ``prefetch`` obs record's body."""
        return {"depth": self.depth, "batches": self.batches,
                "input_stall_s": self.stall_s, "leaked": self.leaked}

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
