"""The training runtime's fatal device faults and its graceful drain
(PyTorch port of the part of ``flexflow_tpu/utils/elastic.py`` that runs
without elastic training).

  * :class:`DeviceLostError` — a lost card (the injected
    ``device_loss``) or a boundary past the step watchdog's deadline;
    without elastic training ``fit`` raises it (``model.py:2300-2327``
    of the JAX package);
  * :class:`HostCrashError` — the injected ``host_crash``: the process
    leaves ``fit`` through its error exit (the prefetcher closed, the
    async writer abandoned, the process group released);
  * the preemption drain: :func:`install_drain_handler` (or
    :class:`drain_scope`) makes SIGTERM and SIGINT set a flag that
    ``fit`` reads at its boundaries; the loop finishes the step, commits
    a verified checkpoint within ``drain_budget_s``, writes one
    ``preempt_drain`` record and returns, and the training app exits 0.
    :func:`request_drain` is the injected ``preempt``'s way in.

Elastic recovery (``classify``, ``probe_devices``, ``recover`` and the
rest of the JAX module) is not here: ROADMAP Queue A item 5, elastic
training.
"""

from __future__ import annotations

import signal
import threading
from typing import Dict, Optional


class DeviceLostError(RuntimeError):
    """Permanent device loss that the run cannot (or may not) recover
    from: elastic training is off, or no usable state is left."""


class HostCrashError(RuntimeError):
    """An injected ``host_crash``: this process is simulated as dying
    mid-run and leaves ``fit`` through its error exit."""


def install_drain_handler(drain: Dict, log=print):
    """Install SIGTERM/SIGINT handlers that set ``drain["requested"]``
    (and ``drain["signum"]``) and return an idempotent, re-entrant
    restore callable: the drain path and the error path may both call
    it.  ``signal.signal`` works only on the main thread; elsewhere, or
    where the runtime forbids handlers, ``drain["installed"]`` stays
    False and :func:`request_drain` sets the flag directly."""
    drain.setdefault("requested", False)
    drain.setdefault("signum", None)
    drain["installed"] = False

    def _handler(signum, frame):
        if not drain["requested"]:
            drain["requested"] = True
            drain["signum"] = int(signum)
            try:
                name = signal.Signals(signum).name
            except ValueError:
                name = str(signum)
            log(f"elastic: {name} received — draining at the next "
                f"host-sync boundary")

    prev: Dict = {}
    try:
        for signum in (signal.SIGTERM, signal.SIGINT):
            prev[signum] = signal.signal(signum, _handler)
        drain["installed"] = True
    except (ValueError, OSError, RuntimeError):
        # not the main thread: undo what was installed, run flag-only
        for signum, old in prev.items():
            try:
                signal.signal(signum, old)
            except (ValueError, OSError, RuntimeError):
                pass
        prev = {}

    done = [False]
    lock = threading.Lock()

    def restore() -> bool:
        with lock:
            if done[0]:
                return False
            done[0] = True
        for signum, old in prev.items():
            try:
                signal.signal(signum, old)
            except (ValueError, OSError, RuntimeError):
                pass
        return True

    return restore


class drain_scope:
    """:func:`install_drain_handler` as a context manager::

        with drain_scope(log=log) as drain:
            ...  # the loop reads drain["requested"] at its boundaries

    It yields the drain dict and restores the previous handlers on every
    exit path (an early ``restore()`` is safe too)."""

    def __init__(self, log=print, drain: Optional[Dict] = None):
        self.drain: Dict = drain if drain is not None else {}
        self._log = log
        self._restore = None

    def __enter__(self) -> Dict:
        self._restore = install_drain_handler(self.drain, log=self._log)
        return self.drain

    def restore(self) -> bool:
        if self._restore is None:
            return False
        return self._restore()

    def __exit__(self, exc_type, exc, tb) -> bool:
        self.restore()
        return False


def request_drain(drain: Dict) -> None:
    """The injected ``preempt``: raise SIGTERM through the installed
    handler (the production path), or set the flag when none is
    installed."""
    if drain.get("installed"):
        signal.raise_signal(signal.SIGTERM)
    else:
        drain["requested"] = True
        drain["signum"] = int(signal.SIGTERM)
