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

As ``data/imagenet.py``'s stream, this one yields this rank's rows of
each global batch (``machine.batch_block``), as tensors on the machine's
device or, with ``place=False``, on the host.  ``h5py`` is imported only
when a stream is made.
"""

from __future__ import annotations

import queue
import threading
import warnings
from typing import Iterator, List, Tuple

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
                 device="cuda") -> Iterator[Tuple]:
    """Yield (images, labels) forever from HDF5 batch files, read ahead
    on a background thread: this rank's rows of each global batch, as
    tensors on ``machine``'s device (``device`` without a machine), or
    host tensors with ``place=False``.

    A transient ``OSError`` read is retried (``retry_attempts`` tries in
    all, with backoff); a range that keeps failing is skipped (cursor
    advanced, ``data_fault`` record on ``olog``) until ``skip_budget`` is
    spent.  ``olog`` is any obs sink, not owned here.  Closing the
    generator stops the thread, which closes the files; a thread that
    does not stop within ``_JOIN_TIMEOUT_S`` is reported as leaked (a
    ``thread_leak`` record and a ``RuntimeWarning``)."""
    import h5py
    import torch

    from flexflow_tpu_torch import obs
    from flexflow_tpu_torch.machine import resolve_device
    from flexflow_tpu_torch.utils import faultinject
    from flexflow_tpu_torch.utils.retry import RetryPolicy, call_with_retry

    if not paths:
        raise ValueError("hdf5_batches needs at least one file")
    olog = olog if olog is not None else obs.NULL
    dev = machine.device if machine is not None \
        else resolve_device(device) if place else None
    lo, hi = (0, batch_size) if machine is None \
        else machine.batch_block(batch_size)
    files = [h5py.File(p, "r") for p in paths]
    positions = [0] * len(files)
    policy = RetryPolicy(attempts=max(int(retry_attempts), 1))

    q: "queue.Queue" = queue.Queue(maxsize=prefetch)
    stop = threading.Event()
    skips = [0]

    def read_resilient(idx):
        """One batch read under retry; a range failing past the retries
        is skipped (within ``skip_budget``) instead of ending the run."""
        while True:
            fidx = idx

            def once():
                faultinject.raise_if("data_io", site=f"hdf5:{paths[fidx]}")
                return _read_batch(files, positions, fidx, batch_size)

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
                skips[0] += 1
                if skips[0] > skip_budget:
                    raise RuntimeError(
                        f"hdf5 read skip budget ({skip_budget}) "
                        f"exhausted") from e
                warnings.warn(
                    f"hdf5: skipping a batch range after "
                    f"{policy.attempts} failed reads: {e}",
                    RuntimeWarning)
                olog.event("data_fault", source="hdf5", action="skip",
                           skips=skips[0], error=str(e))
                try:
                    n = files[idx]["images"].shape[0]
                    positions[idx] = (positions[idx] + batch_size) % n
                except Exception:
                    idx = (idx + 1) % len(files)

    def producer():
        # the producer owns the files: only it touches them, and it closes
        # them after it sees stop, so that teardown cannot race a read
        try:
            idx = 0
            while not stop.is_set():
                try:
                    img, lbl, idx = read_resilient(idx)
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
            for f in files:
                try:
                    f.close()
                except Exception:
                    pass

    t = threading.Thread(target=producer, name="ff-hdf5-prefetch",
                         daemon=True)
    t.start()
    try:
        while True:
            item = q.get()
            if isinstance(item, _ProducerError):
                raise RuntimeError("hdf5 prefetch thread failed") from item.exc
            img, lbl = (torch.from_numpy(np.ascontiguousarray(a))
                        for a in item)
            yield (img, lbl) if not place else (img.to(dev), lbl.to(dev))
    finally:
        stop.set()
        t.join(timeout=_JOIN_TIMEOUT_S)
        if t.is_alive():
            # say that the daemon thread leaked instead of pretending the
            # shutdown succeeded
            warnings.warn(
                f"hdf5 prefetch thread did not exit within "
                f"{_JOIN_TIMEOUT_S:.1f}s; leaking the daemon thread",
                RuntimeWarning)
            olog.event("thread_leak", source="hdf5_batches",
                       timeout_s=_JOIN_TIMEOUT_S)
