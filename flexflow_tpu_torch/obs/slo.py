"""Declarative serving SLOs and error-budget burn rate (the port's own
copy of ``flexflow_tpu/obs/slo.py``, pure stdlib).

An SLO is the SRE shape: "the p99 request latency stays under
``latency_target_s``, and at least ``availability`` of requests
individually meet that target".  The complement of availability is the
**error budget**; the **burn rate** is how fast a stream spends it:

    burn_rate = error_rate / (1 - availability)

It is computed over ``serve_request`` records once over the whole
stream (:func:`evaluate`) and per rolling window of virtual completion
time (:func:`burn_rate_windows`).  Times are the serve engine's virtual
clock (``done_v``), so burn rates are deterministic under a seed.
Results flow out as an ``slo`` obs record (:func:`log_record`) and
``ff_slo_*`` gauges (:func:`export_gauges`).  The router's admission
gate (:class:`~flexflow_tpu_torch.serve.router.AdmissionGate`) prices
its live burn with :func:`_burn`.
"""

from __future__ import annotations

import math
from dataclasses import asdict, dataclass
from typing import Dict, Iterable, List, Optional

__all__ = ["SLOSpec", "burn_rate_windows", "evaluate", "export_gauges",
           "log_record"]


@dataclass(frozen=True)
class SLOSpec:
    """One serving SLO: latency percentile target + availability.

    ``latency_target_s`` is the per-request latency bound (virtual
    seconds, arrival to completion); ``percentile`` is the percentile
    that must meet it for the stream to be *compliant*;
    ``availability`` is the fraction of individual requests that must
    meet it (its complement is the error budget); ``window_s`` is the
    rolling burn-rate window width in virtual seconds."""

    name: str = "default"
    latency_target_s: float = 0.5
    percentile: float = 99.0
    availability: float = 0.999
    window_s: float = 60.0

    def __post_init__(self):
        if not self.latency_target_s > 0:
            raise ValueError("latency_target_s must be > 0")
        if not 0 < self.percentile <= 100:
            raise ValueError("percentile must be in (0, 100]")
        if not 0 < self.availability < 1:
            raise ValueError("availability must be in (0, 1)")
        if not self.window_s > 0:
            raise ValueError("window_s must be > 0")

    @property
    def error_budget(self) -> float:
        return 1.0 - self.availability

    @classmethod
    def from_dict(cls, d: Dict) -> "SLOSpec":
        known = set(cls.__dataclass_fields__)
        return cls(**{k: v for k, v in d.items() if k in known})

    def to_dict(self) -> Dict:
        return asdict(self)


def _percentile(values: List[float], q: float) -> Optional[float]:
    """np.percentile's default linear interpolation, stdlib-only."""
    if not values:
        return None
    vs = sorted(values)
    if len(vs) == 1:
        return float(vs[0])
    rank = (q / 100.0) * (len(vs) - 1)
    lo = int(math.floor(rank))
    hi = min(lo + 1, len(vs) - 1)
    frac = rank - lo
    return float(vs[lo] + (vs[hi] - vs[lo]) * frac)


def _completed_requests(events: Iterable[Dict], *,
                        kind: str = "serve_request",
                        latency_field: str = "latency_s",
                        time_field: str = "done_v") -> List[Dict]:
    return [e for e in events
            if e.get("kind") == kind
            and e.get(time_field) is not None
            and e.get(latency_field) is not None]


def _violates(rec: Dict, spec: SLOSpec, *,
              latency_field: str = "latency_s") -> bool:
    return float(rec[latency_field]) > spec.latency_target_s


def _burn(bad: int, total: int, budget: float) -> float:
    error_rate = (bad / total) if total else 0.0
    if budget <= 0:
        return math.inf if bad else 0.0
    return error_rate / budget


def burn_rate_windows(events: Iterable[Dict], spec: SLOSpec, *,
                      kind: str = "serve_request",
                      latency_field: str = "latency_s",
                      time_field: str = "done_v") -> List[Dict]:
    """Tile the stream's completion-time (``time_field``) span with
    ``spec.window_s``-wide windows and compute the burn rate in each.
    Empty stream -> ``[]``; a degenerate span (every request completing
    at the same instant) is one window.  Windows with zero completions
    report burn 0.0 — no traffic burns no budget.

    The defaults are the serving shape (``serve_request`` /
    ``latency_s`` / ``done_v``); a wait-time SLO over a fleet stream is
    the SAME math with ``kind="fleet_wait", latency_field="wait_s"``."""
    reqs = _completed_requests(events, kind=kind,
                               latency_field=latency_field,
                               time_field=time_field)
    if not reqs:
        return []
    times = [float(r[time_field]) for r in reqs]
    t0, t_end = min(times), max(times)
    n_win = max(1, int(math.ceil((t_end - t0) / spec.window_s)) or 1)
    if t0 + n_win * spec.window_s <= t_end:  # endpoint lands on edge
        n_win += 1
    windows = []
    for k in range(n_win):
        w0 = t0 + k * spec.window_s
        w1 = w0 + spec.window_s
        members = [r for r in reqs if w0 <= float(r[time_field]) < w1
                   or (k == n_win - 1 and float(r[time_field]) == w1)]
        bad = sum(1 for r in members
                  if _violates(r, spec, latency_field=latency_field))
        total = len(members)
        windows.append({
            "t0": w0, "t1": w1, "total": total, "bad": bad,
            "error_rate": (bad / total) if total else 0.0,
            "burn_rate": _burn(bad, total, spec.error_budget),
        })
    return windows


def evaluate(events: Iterable[Dict], spec: SLOSpec, *,
             kind: str = "serve_request",
             latency_field: str = "latency_s",
             time_field: str = "done_v") -> Dict:
    """Whole-stream SLO verdict for one spec.

    Returns totals, whole-stream and worst-window burn rates, the
    achieved latency at ``spec.percentile``, a ``compliant`` bit
    (achieved percentile within target — the SLO statement itself),
    and ``goodput_qps`` (SLO-meeting completions per virtual second of
    the stream's completion span).  An empty stream is vacuously
    compliant with zero burn.  ``kind`` / ``latency_field`` /
    ``time_field`` retarget the same math at any record family that
    stamps a completion time and a latency-like value — e.g. a
    wait-time SLO over ``fleet_wait`` records (``latency_field=
    "wait_s"``), which is how apps/fleetsim.py scores each pool
    size."""
    events = list(events)
    reqs = _completed_requests(events, kind=kind,
                               latency_field=latency_field,
                               time_field=time_field)
    windows = burn_rate_windows(reqs, spec, kind=kind,
                                latency_field=latency_field,
                                time_field=time_field)
    total = len(reqs)
    bad = sum(1 for r in reqs
              if _violates(r, spec, latency_field=latency_field))
    good = total - bad
    latencies = [float(r[latency_field]) for r in reqs]
    achieved = _percentile(latencies, spec.percentile)
    span = (max(float(r[time_field]) for r in reqs)) if reqs else 0.0
    return {
        "spec": spec.to_dict(),
        "total": total,
        "good": good,
        "violations": bad,
        "error_rate": (bad / total) if total else 0.0,
        "error_budget": spec.error_budget,
        "burn_rate": _burn(bad, total, spec.error_budget),
        "max_window_burn_rate": max(
            (w["burn_rate"] for w in windows), default=0.0),
        "windows": len(windows),
        "achieved_percentile_s": achieved,
        "compliant": bool(achieved is None
                          or achieved <= spec.latency_target_s),
        "goodput_qps": (good / span) if span > 0 else 0.0,
    }


def export_gauges(metrics, result: Dict) -> None:
    """Publish an :func:`evaluate` result as ``ff_slo_*`` gauges on a
    live MetricsExporter (no-op when ``metrics`` is None).  Infinite
    burn rates are dropped by the exporter's finite-only contract."""
    if metrics is None:
        return
    metrics.update(
        slo_burn_rate=result["burn_rate"],
        slo_max_window_burn_rate=result["max_window_burn_rate"],
        slo_error_rate=result["error_rate"],
        slo_goodput_qps=result["goodput_qps"],
        slo_compliant=1.0 if result["compliant"] else 0.0)
    metrics.write()


def log_record(olog, result: Dict) -> None:
    """Mirror an :func:`evaluate` result into the obs stream as one
    ``slo`` record (flat fields; the spec nested under ``spec``)."""
    olog.event("slo", **result)
