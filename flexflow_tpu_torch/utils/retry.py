"""Bounded retry with exponential backoff and deterministic jitter (the
port's own copy of ``flexflow_tpu/utils/retry.py``; that module imports
no JAX, but the port imports nothing of the JAX package).

The file readers (``data/hdf5.py``, ``data/imagenet.py``) run each read
or decode under :func:`call_with_retry`; the injected ``data_io`` fault
(``utils/faultinject.py``) fires before each attempt there, as in the
JAX package's readers.  Two properties the tests pin:

  * **bounded**: a :class:`RetryPolicy` caps total attempts; the last
    failure re-raises unchanged;
  * **deterministic**: the jitter fraction is derived from
    ``crc32(seed, attempt)``, not ``random``, so two runs of the same
    failing schedule back off identically.

Only ``OSError`` is retried by default (the transient-I/O family,
including the injector's ``InjectedIOError``); anything else propagates
at once.
"""

from __future__ import annotations

import dataclasses
import time
import zlib
from typing import Callable, Optional, Tuple, Type


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
                    retry_on: Tuple[Type[BaseException], ...] = (OSError,),
                    on_recover: Optional[Callable] = None):
    """Call ``fn()`` under ``policy``, retrying ``retry_on`` (by default
    ``OSError``, the transient-I/O family, the injector's
    ``InjectedIOError`` included; the elastic device probe retries any
    ``Exception``); anything else propagates at once.  ``on_retry(exc,
    failures, delay)`` fires before each backoff sleep;
    ``on_recover(failures)`` when a call succeeds after at least one
    failure (the readers' ``recovery`` record).  The final failure
    re-raises the original exception."""
    policy = policy or RetryPolicy()
    failures = 0
    while True:
        try:
            out = fn()
        except retry_on as e:
            failures += 1
            if failures >= policy.attempts:
                raise
            d = policy.delay(failures)
            if on_retry is not None:
                on_retry(e, failures, d)
            sleep(d)
            continue
        if failures and on_recover is not None:
            on_recover(failures)
        return out

