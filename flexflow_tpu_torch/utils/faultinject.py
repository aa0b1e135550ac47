"""Deterministic fault injection — the port's own copy of
``flexflow_tpu/utils/faultinject.py`` (that module imports no JAX, but the
port imports nothing of the JAX package).  The same spec string drives
both packages.  The sites named below are the JAX package's.  This
package fires ``loss_nan``, ``host_crash``, ``device_loss``, ``preempt``
and ``step_hang`` in ``FFModel.fit``, ``device_return`` in the elastic
regrow probe (``utils/elastic.py:probe_regrow``), ``data_io`` before
each read or decode attempt of the file readers (``data/hdf5.py``,
``data/imagenet.py``, as in the JAX package), ``ckpt_truncate`` and
``ckpt_corrupt`` in ``utils/checkpoint.py:save_checkpoint``, and the
serving faults in ``serve/router.py`` and ``serve/engine.py``.

``FFConfig.fault_spec`` names faults to fire at EXACT occurrence indices,
so every recovery path in the runtime — step health guard rollback
(model.py::fit), checkpoint restore cascade (utils/checkpoint.py),
retrying data sources (data/hdf5.py, data/imagenet.py) — is exercised at
reproducible points in tests and in ``make fault-smoke``.

Grammar (comma-separated entries)::

    <kind>@<at>            fire on occurrence <at>        loss_nan@120
    <kind>@<at>x<times>    fire on <at> .. <at+times-1>   data_io@50x3

Occurrences are counted per kind by the injector itself: every ``fire()``
call at a site increments the kind's counter, so ``loss_nan@120`` means
"the 120th training step of this run", ``data_io@50x3`` means "the 50th
through 52nd read attempts" (each RETRY is a new attempt — ``x3`` with a
4-attempt retry policy is a transient fault the retries absorb, a huge
``x`` count is a permanent one that forces the skip path), and
``ckpt_truncate@2`` means "the 2nd checkpoint save".  Counting attempts
instead of wall positions is what makes recovery terminate: after a
rollback the re-run steps consume FRESH occurrence indices, so a fault
pinned at one index cannot re-fire forever.

Kinds:

  * ``loss_nan``      — fit() poisons that step's recorded loss with NaN
                        (device-side; exercises the health guard);
  * ``data_io``       — the data sources raise :class:`InjectedIOError`
                        (an ``OSError``; exercises retry + skip budget);
  * ``ckpt_truncate`` — save_checkpoint truncates the just-committed
                        ``arrays.npz`` (a torn write; exercises digest
                        verification + the restore cascade);
  * ``ckpt_corrupt``  — save_checkpoint flips one byte of the committed
                        ``arrays.npz`` (a bit flip; same recovery path);
  * ``device_loss``   — fit() marks one device (the highest live ordinal)
                        as PERMANENTLY lost at that training step; the
                        elastic runtime (utils/elastic.py) must detect it
                        at the next host-sync boundary and shrink onto
                        the surviving mesh.  ``device_loss@5x2`` loses one
                        device at step 5 and another at step 6 — one
                        resize event covering both at the next boundary;
  * ``host_crash``    — fit() raises ``HostCrashError`` (utils/elastic.py)
                        at that training step, simulating
                        this whole process dying mid-run (exercises the
                        error-exit cleanup — coordinator release,
                        prefetcher shutdown — and the ``--elastic``
                        restart/rejoin protocol in distributed.py);
  * ``device_return`` — counted per elastic REGROW PROBE (the boundary
                        probe of previously-dead ordinals after a
                        shrink): on fire, the injected-dead devices
                        answer again, so after ``--regrow-probes``
                        consecutive healthy probes the run grows back
                        (``recover_grow``, utils/elastic.py);
  * ``preempt``       — counted per training step: raises the graceful-
                        drain signal path (the same SIGTERM handler fit
                        installs), so the run finishes the in-flight
                        step, commits a final verified checkpoint and
                        exits 0 within ``--drain-budget-s``;
  * ``step_hang``     — counted per training step: deterministically
                        stalls the NEXT host-sync boundary past the step
                        watchdog's deadline (``--hang-factor``,
                        utils/health.StepWatchdog), converting a wedged
                        collective into the probe/classify recovery
                        path;
  * ``replica_crash`` — serving (serve/router.py): counted per
                        decode-boundary HEALTH CHECK per live decode
                        replica (the router probes replicas in index
                        order at each boundary it steps); on fire the
                        probed replica dies — its in-flight sessions
                        lose their imported KV and re-route through the
                        ``kv_rebuild`` re-prefill path, its queued
                        handoffs retransmit, and the replica revives
                        after the router's ``restart_s``;
  * ``handoff_drop``  — counted per DISPATCHED prefill->decode handoff:
                        the priced transfer is lost in flight (the
                        payload survives host-side), so the request
                        retries the retransmit path under the router's
                        RetryPolicy;
  * ``kv_corrupt``    — counted per dispatched handoff alongside
                        ``handoff_drop``: the payload arrives but its
                        rows are untrusted — the router discards it and
                        re-materializes the session by re-prefilling
                        its carried tokens (``kv_rebuild``);
  * ``slow_replica``  — counted per DECODE-phase engine step: that step
                        takes ``SLOW_REPLICA_FACTOR`` times its virtual
                        service time (a straggler, not a death) —
                        the hedged-decode mode's p99 adversary.

One injector is installed process-globally (``install``/``get``) so data
sources running on background threads see the same schedule; ``fit()``
installs from its config and restores the previous injector on exit.
Every fired fault is emitted as a first-class ``fault`` obs record when
the injector carries a sink.
"""

from __future__ import annotations

import threading
from typing import Dict, List, Optional, Tuple

KINDS = ("loss_nan", "data_io", "ckpt_truncate", "ckpt_corrupt",
         "device_loss", "host_crash", "device_return", "preempt",
         "step_hang", "replica_crash", "handoff_drop", "kv_corrupt",
         "slow_replica")


class FaultSpecError(ValueError):
    """Malformed ``fault_spec`` string."""


class InjectedIOError(OSError):
    """A deterministically injected transient I/O failure (``data_io``) —
    an ``OSError`` so the retry policies treat it exactly like a real
    read error."""


def parse_fault_spec(spec: str) -> Dict[str, List[Tuple[int, int]]]:
    """``"loss_nan@120,data_io@50x3"`` -> ``{kind: [(at, times), ...]}``.
    Raises :class:`FaultSpecError` on unknown kinds or bad syntax, so a
    typo'd spec fails at config time instead of silently never firing."""
    out: Dict[str, List[Tuple[int, int]]] = {}
    for raw in (spec or "").split(","):
        entry = raw.strip()
        if not entry:
            continue
        if "@" not in entry:
            raise FaultSpecError(
                f"fault spec entry {entry!r} needs '<kind>@<at>[x<times>]'")
        kind, _, pos = entry.partition("@")
        kind = kind.strip()
        if kind not in KINDS:
            raise FaultSpecError(
                f"unknown fault kind {kind!r}; known: {', '.join(KINDS)}")
        at_s, _, times_s = pos.partition("x")
        try:
            at = int(at_s)
            times = int(times_s) if times_s else 1
        except ValueError:
            raise FaultSpecError(
                f"fault spec entry {entry!r}: occurrence and repeat count "
                f"must be integers") from None
        if at < 1 or times < 1:
            raise FaultSpecError(
                f"fault spec entry {entry!r}: occurrence index and repeat "
                f"count are 1-based and must be >= 1")
        out.setdefault(kind, []).append((at, times))
    return out


class NullInjector:
    """The disabled injector: ``fire()`` is always False and counts
    nothing.  A single shared instance (``NULL``) is the default."""

    enabled = False

    def fire(self, kind: str, site: str = "") -> bool:
        return False

    def fired(self, kind: Optional[str] = None) -> int:
        return 0

    def state(self) -> Dict[str, int]:
        return {}

    def adopt(self, counts: Dict[str, int]) -> None:
        pass


NULL = NullInjector()


class FaultInjector:
    """Deterministic occurrence-counting injector for one run.  Thread-safe
    (data sources fire from background threads)."""

    enabled = True

    def __init__(self, spec: str, olog=None):
        self.spec = spec
        self.ranges = parse_fault_spec(spec)
        self.olog = olog
        self._lock = threading.Lock()
        self._counts: Dict[str, int] = {}
        self._fired: List[Tuple[str, int, str]] = []

    def fire(self, kind: str, site: str = "") -> bool:
        """Count one occurrence of ``kind`` at ``site``; True when the
        spec schedules a fault for this occurrence.  Emits a ``fault``
        obs record (source="injected") for every fire."""
        with self._lock:
            n = self._counts.get(kind, 0) + 1
            self._counts[kind] = n
            hit = any(at <= n < at + times
                      for at, times in self.ranges.get(kind, ()))
            if hit:
                self._fired.append((kind, n, site))
        if hit and self.olog is not None:
            self.olog.event("fault", source="injected", fault=kind,
                            occurrence=n, site=site)
        return hit

    def fired(self, kind: Optional[str] = None) -> int:
        """How many faults have actually fired (optionally of one kind)."""
        with self._lock:
            if kind is None:
                return len(self._fired)
            return sum(1 for k, _, _ in self._fired if k == kind)

    def state(self) -> Dict[str, int]:
        """The occurrences counted so far, per kind."""
        with self._lock:
            return dict(self._counts)

    def adopt(self, counts: Dict[str, int]) -> None:
        """Continue from another injector's counts (:meth:`state`): a
        rank that stood by through an elastic shrink takes the running
        ranks' when it is called back, so that every rank fires the
        same occurrences."""
        with self._lock:
            self._counts = dict(counts)


_current = NULL
_install_lock = threading.Lock()


def get():
    """The process-global injector (``NULL`` unless a run installed one)."""
    return _current


def install(injector):
    """Make ``injector`` the process-global one; returns the previous
    injector so the installer can restore it (``fit()`` does, in a
    ``finally``)."""
    global _current
    with _install_lock:
        prev = _current
        _current = injector if injector is not None else NULL
        return prev


def install_scoped(injector):
    """Install ``injector`` and return an IDEMPOTENT, re-entrant restore
    callable.  fit()'s graceful-drain path and its error path can both
    reach the uninstall; a second (or concurrent) call must be a no-op
    instead of clobbering whatever a later run installed."""
    prev = install(injector)
    done = [False]
    lock = threading.Lock()

    def restore() -> bool:
        with lock:
            if done[0]:
                return False
            done[0] = True
        install(prev)
        return True

    return restore


def from_config(config, olog=None):
    """A :class:`FaultInjector` for ``config.fault_spec``, or ``NULL``
    when the spec is empty/absent — the one gate ``fit()`` calls."""
    spec = getattr(config, "fault_spec", "") or ""
    return FaultInjector(spec, olog=olog) if spec.strip() else NULL


def raise_if(kind: str, site: str = "") -> None:
    """Data-source hook: raise :class:`InjectedIOError` when the global
    injector fires ``kind`` for this occurrence."""
    inj = _current
    if inj.enabled and inj.fire(kind, site=site):
        raise InjectedIOError(f"injected {kind} fault at {site or '?'}")
