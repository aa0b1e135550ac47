"""HDF5 batch stream (PyTorch port of ``flexflow_tpu/data/hdf5.py``): the
reference's legacy loader (ops.h:545-565, ops.cu:281-420), a list of HDF5
files, each with an ``images`` and a ``labels`` dataset, read round robin
with wraparound inside each file by a background prefetch thread.

Images stored as uint8 HWC are normalized with the JPEG path's
``(u8/256 - mean) / std``; float32 images pass through.  Every read runs
under the bounded retry of ``utils/retry.py`` (the injected ``data_io``
fault fires before each attempt); a range that fails past the retries is
skipped (the cursor moves on, a ``data_fault`` record) until the run's
``skip_budget`` is spent.  The records, warnings and messages are the JAX
package's.

As ``data/imagenet.py``'s stream, this one (:class:`HDF5Stream`) yields
this rank's rows of each global batch (``machine.batch_block``), as
tensors on the machine's device or, with ``place=False``, on the host,
and an elastic resize rebinds it to the new machine's block
(:meth:`HDF5Stream.rebind`).  ``h5py`` is imported only when a stream is
made.
"""

from __future__ import annotations

import queue
import threading
import warnings
from typing import List, Optional

import numpy as np

from flexflow_tpu_torch.data.imagenet import IMAGENET_MEAN, IMAGENET_STD

# how long teardown waits for the prefetch thread before declaring it
# leaked (module-level so tests can shrink it)
_JOIN_TIMEOUT_S = 2.0


def _read_batch(files: List, positions: List[int], file_idx: int,
                batch_size: int):
    """One batch from ``files[file_idx]`` at its cursor, wrapping within
    the file as often as needed; advances the cursor.  Returns (images,
    labels, next file index)."""
    f = files[file_idx]
    images, labels = f["images"], f["labels"]
    n = images.shape[0]
    start = positions[file_idx]
    img_parts, lbl_parts, need = [], [], batch_size
    while need > 0:
        take = min(need, n - start)
        img_parts.append(images[start:start + take])
        lbl_parts.append(labels[start:start + take])
        start = (start + take) % n
        need -= take
    positions[file_idx] = start
    img = img_parts[0] if len(img_parts) == 1 else np.concatenate(img_parts)
    lbl = lbl_parts[0] if len(lbl_parts) == 1 else np.concatenate(lbl_parts)
    return np.asarray(img), np.asarray(lbl), (file_idx + 1) % len(files)


class _ProducerError:
    """Carries a prefetch thread's exception to the consumer."""

    def __init__(self, exc: Exception):
        self.exc = exc


def _normalize(img: np.ndarray) -> np.ndarray:
    if img.dtype == np.uint8:
        return ((img.astype(np.float32) / 256.0 - IMAGENET_MEAN)
                / IMAGENET_STD)
    return img.astype(np.float32)


def hdf5_batches(machine, paths: List[str], batch_size: int,
                 prefetch: int = 2, place: bool = True, olog=None,
                 retry_attempts: int = 4, skip_budget: int = 16,
                 device="cuda") -> "HDF5Stream":
    """(images, labels) forever from HDF5 batch files, read ahead on a
    background thread: this rank's rows of each global batch, as tensors
    on ``machine``'s device (``device`` without a machine), or host
    tensors with ``place=False``.

    A transient ``OSError`` read is retried (``retry_attempts`` tries in
    all, with backoff); a range that keeps failing is skipped (cursor
    advanced, ``data_fault`` record on ``olog``) until ``skip_budget`` is
    spent.  ``olog`` is any obs sink, not owned here.  Closing the
    stream stops the thread, which closes the files; a thread that does
    not stop within ``_JOIN_TIMEOUT_S`` is reported as leaked (a
    ``thread_leak`` record and a ``RuntimeWarning``)."""
    return HDF5Stream(machine, paths, batch_size, prefetch=prefetch,
                      place=place, olog=olog, retry_attempts=retry_attempts,
                      skip_budget=skip_budget, device=device)


class HDF5Stream:
    """The stream :func:`hdf5_batches` makes.  ``position`` counts the
    global batches yielded; global batch k comes from file ``k % files``
    at that file's cursor, which each batch read from it, and each range
    skipped in it, moves ``batch_size`` rows on (with wraparound)."""

    def __init__(self, machine, paths: List[str], batch_size: int,
                 prefetch: int = 2, place: bool = True, olog=None,
                 retry_attempts: int = 4, skip_budget: int = 16,
                 device="cuda"):
        import h5py

        from flexflow_tpu_torch import obs
        from flexflow_tpu_torch.utils.retry import RetryPolicy

        if not paths:
            raise ValueError("hdf5_batches needs at least one file")
        self.paths = list(paths)
        self.batch_size = int(batch_size)
        self.prefetch = prefetch
        self.place = place
        self._device = device
        self.olog = olog if olog is not None else obs.NULL
        self.policy = RetryPolicy(attempts=max(int(retry_attempts), 1))
        self.skip_budget = skip_budget
        self.skips = 0
        self.position = 0
        self._files = [h5py.File(p, "r") for p in self.paths]
        self._cursors = [0] * len(self._files)
        # ranges skipped in each file: they move its cursor on
        self._skipped = [0] * len(self._files)
        self._next_file = 0
        self._closing = False
        self._thread = None
        self._bind(machine)

    # -- the reader thread ---------------------------------------------

    def _read_resilient(self, idx):
        """One batch read under retry; a range failing past the retries
        is skipped (within ``skip_budget``) instead of ending the run."""
        from flexflow_tpu_torch.utils import faultinject
        from flexflow_tpu_torch.utils.retry import call_with_retry

        olog, policy, files = self.olog, self.policy, self._files
        while True:
            fidx = idx

            def once():
                faultinject.raise_if("data_io",
                                     site=f"hdf5:{self.paths[fidx]}")
                return _read_batch(files, self._cursors, fidx,
                                   self.batch_size)

            try:
                return call_with_retry(
                    once, policy, retry_on=(OSError,),
                    on_retry=lambda e, n, d: olog.event(
                        "data_fault", source="hdf5", action="retry",
                        attempt=n, delay_s=d, error=str(e)),
                    on_recover=lambda n: olog.event(
                        "recovery", source="hdf5", after="retry",
                        failures=n))
            except OSError as e:
                self.skips += 1
                if self.skips > self.skip_budget:
                    raise RuntimeError(
                        f"hdf5 read skip budget ({self.skip_budget}) "
                        f"exhausted") from e
                warnings.warn(
                    f"hdf5: skipping a batch range after "
                    f"{policy.attempts} failed reads: {e}",
                    RuntimeWarning)
                olog.event("data_fault", source="hdf5", action="skip",
                           skips=self.skips, error=str(e))
                try:
                    n = files[idx]["images"].shape[0]
                    self._cursors[idx] = (self._cursors[idx]
                                          + self.batch_size) % n
                    self._skipped[idx] += 1
                except Exception:
                    idx = (idx + 1) % len(files)

    def _producer(self, q, stop, lo, hi):
        # only this thread touches the files while it runs; it closes them
        # after it sees stop at the stream's close, so that teardown
        # cannot race a read (a rebind's stop leaves them open)
        try:
            while not stop.is_set():
                try:
                    img, lbl, self._next_file = self._read_resilient(
                        self._next_file)
                    item = (_normalize(img[lo:hi]),
                            np.asarray(lbl[lo:hi], np.int32))
                except Exception as e:  # to the consumer, not a hang
                    item = _ProducerError(e)
                while not stop.is_set():
                    try:
                        q.put(item, timeout=0.1)
                        break
                    except queue.Full:
                        continue
                if isinstance(item, _ProducerError):
                    return
        finally:
            if self._closing:
                self._close_files()

    def _close_files(self) -> None:
        for f in self._files:
            try:
                f.close()
            except Exception:
                pass

    def _bind(self, machine) -> None:
        from flexflow_tpu_torch.machine import resolve_device

        self.machine = machine
        self.device = machine.device if machine is not None \
            else resolve_device(self._device) if self.place else None
        lo, hi = (0, self.batch_size) if machine is None \
            else machine.batch_block(self.batch_size)
        self._q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        self._stop = threading.Event()
        self._thread = threading.Thread(
            target=self._producer, args=(self._q, self._stop, lo, hi),
            name="ff-hdf5-prefetch", daemon=True)
        self._thread.start()

    def _halt(self) -> bool:
        """Stop the reader thread; False when it did not stop within
        ``_JOIN_TIMEOUT_S`` (recorded as a leak)."""
        self._stop.set()
        self._thread.join(timeout=_JOIN_TIMEOUT_S)
        if not self._thread.is_alive():
            return True
        # say that the daemon thread leaked instead of pretending the
        # shutdown succeeded
        warnings.warn(
            f"hdf5 prefetch thread did not exit within "
            f"{_JOIN_TIMEOUT_S:.1f}s; leaking the daemon thread",
            RuntimeWarning)
        self.olog.event("thread_leak", source="hdf5_batches",
                        timeout_s=_JOIN_TIMEOUT_S)
        return False

    # -- the consumer ----------------------------------------------------

    def rebind(self, machine, position: Optional[int] = None) -> None:
        """Yield ``machine``'s blocks from now on (every row when it is
        None), from global batch ``position`` when given, else from where
        the stream stands.  The batches read ahead for the old block are
        dropped, and every file's cursor is put where ``position``
        batches and this rank's skips in it leave it."""
        if self._thread is not None and not self._halt():
            raise RuntimeError("hdf5: the prefetch thread did not stop for "
                               "the rebind")
        if position is not None:
            self.position = int(position)
        nf = len(self._files)
        for f, h in enumerate(self._files):
            reads = len(range(f, self.position, nf))
            n = h["images"].shape[0]
            self._cursors[f] = ((reads + self._skipped[f])
                                * self.batch_size) % n
        self._next_file = self.position % nf
        self._bind(machine)

    def __iter__(self) -> "HDF5Stream":
        return self

    def __next__(self) -> tuple:
        import torch

        item = self._q.get()
        if isinstance(item, _ProducerError):
            raise RuntimeError("hdf5 prefetch thread failed") from item.exc
        self.position += 1
        img, lbl = (torch.from_numpy(np.ascontiguousarray(a)) for a in item)
        return (img, lbl) if not self.place \
            else (img.to(self.device), lbl.to(self.device))

    def close(self) -> None:
        """Stop the reader thread, which closes the files."""
        if self._closing:
            return
        self._closing = True
        if not self._thread.is_alive():
            self._close_files()
            return
        self._halt()

    def __del__(self):
        # an abandoned stream stops its thread (which closes the files)
        # without waiting for it
        try:
            self._closing = True
            self._stop.set()
        except AttributeError:
            pass
