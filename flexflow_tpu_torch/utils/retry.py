"""Bounded retry with exponential backoff and deterministic jitter (the
port's own copy of ``flexflow_tpu/utils/retry.py``; that module imports
no JAX, but the port imports nothing of the JAX package).

``fit`` pulls every batch through :func:`retrying_iter`, the port's one
``data_io`` site: the injected fault (``utils/faultinject.py``) fires
before each attempt of a pull and the :class:`RetryPolicy` absorbs it,
as the JAX package's HDF5 and ImageNet readers absorb theirs
(``data/hdf5.py``, ``data/imagenet.py``; the port has no file reader
yet).  Two properties the tests pin:

  * **bounded**: a :class:`RetryPolicy` caps total attempts; the last
    failure re-raises unchanged;
  * **deterministic**: the jitter fraction is derived from
    ``crc32(seed, attempt)``, not ``random``, so two runs of the same
    failing schedule back off identically.

Only ``OSError`` is retried (the transient-I/O family, including the
injector's ``InjectedIOError``); anything else propagates at once.
"""

from __future__ import annotations

import dataclasses
import time
import zlib
from typing import Callable, Iterator, Optional, Tuple, Type

from flexflow_tpu_torch.utils import faultinject


@dataclasses.dataclass(frozen=True)
class RetryPolicy:
    """Backoff schedule: failure ``n`` (1-based) waits ``min(base_delay *
    multiplier**(n-1), max_delay)`` scaled by a deterministic jitter
    factor in ``[1 - jitter, 1]``."""

    attempts: int = 4          # total tries (1 initial + attempts-1 retries)
    base_delay: float = 0.05
    max_delay: float = 1.0
    multiplier: float = 2.0
    jitter: float = 0.5
    seed: int = 0

    def delay(self, failures: int) -> float:
        d = min(self.base_delay * self.multiplier ** max(failures - 1, 0),
                self.max_delay)
        if self.jitter <= 0:
            return d
        frac = zlib.crc32(f"{self.seed}:{failures}".encode()) % 1000 / 1000.0
        return d * (1.0 - self.jitter * frac)


def call_with_retry(fn: Callable, policy: Optional[RetryPolicy] = None,
                    on_retry: Optional[Callable] = None,
                    sleep: Callable[[float], None] = time.sleep,
                    retry_on: Tuple[Type[BaseException], ...] = (OSError,)):
    """Call ``fn()`` under ``policy``, retrying ``retry_on`` (by default
    ``OSError``, the transient-I/O family, the injector's
    ``InjectedIOError`` included; the elastic device probe retries any
    ``Exception``); anything else propagates at once.  ``on_retry(exc,
    failures, delay)`` fires before each backoff sleep.  The final
    failure re-raises the original exception."""
    policy = policy or RetryPolicy()
    failures = 0
    while True:
        try:
            return fn()
        except retry_on as e:
            failures += 1
            if failures >= policy.attempts:
                raise
            d = policy.delay(failures)
            if on_retry is not None:
                on_retry(e, failures, d)
            sleep(d)


def retrying_iter(upstream: Iterator, log=None) -> Iterator:
    """``upstream``'s items, each pull under :func:`call_with_retry`; the
    ``data_io`` fault fires before every attempt.  Ends when ``upstream``
    does.  An attempt that raised before pulling leaves ``upstream``
    where it was, so a retried pull yields the batch the failed one
    would have."""
    def once():
        faultinject.raise_if("data_io", site="fit:batch")
        return next(upstream)

    def on_retry(e, failures, delay):
        if log is not None:
            log(f"data: pull failed ({e}); retry {failures} in "
                f"{delay:.3f} s")

    while True:
        try:
            yield call_with_retry(once, on_retry=on_retry)
        except StopIteration:
            return
