"""Live metrics export: a Prometheus textfile plus a JSON snapshot,
rewritten atomically at the training loop's boundaries (the port's own
copy of ``flexflow_tpu/obs/metrics.py``, writing the same bytes).

The obs JSONL is an append-only event stream; this module publishes the
handful of gauges an operator watches — throughput, MFU, device memory
peak and live bytes, rollback and fault counters, prefetch stall — as two
small files any scraper understands:

  * ``<metrics_path>`` — the Prometheus *textfile collector* format
    (``# HELP`` / ``# TYPE`` / ``name value`` lines; point a node
    exporter's ``--collector.textfile.directory`` at the parent
    directory, or read it with :func:`read_textfile`);
  * ``<metrics_path>.json`` — the same gauges as one JSON object.

Contracts:

  * **atomic rewrite** — each write goes to a temporary file in the
    target directory and ``os.replace``s into place, so a scraper never
    reads a torn file;
  * **finite values only** — a gauge whose value is None, NaN or inf is
    left out of the files (a poisoned loss must not corrupt the scrape);
    counters are monotone within one exporter's lifetime;
  * **boundary cadence** — ``FFModel.fit`` updates at its print and
    checkpoint boundaries and once after the loop, never per step
    (``FFConfig.metrics_path`` enables it, independent of ``obs_dir``).

Every written snapshot is also mirrored as a ``metrics`` obs record when
the run has a live obs stream, so the JSONL and the scrape agree.
"""

from __future__ import annotations

import json
import math
import os
import tempfile
import time
from typing import Dict, Optional

PREFIX = "ff_"

# gauge name -> HELP text; written in this order.  Anything update()d
# outside this table is still exported (HELP omitted).
_HELP = {
    "throughput_items_per_sec": "training throughput (items/s, machine)",
    "images_per_sec": "training throughput alias (images/s, machine)",
    "mfu": "achieved model FLOPs utilization (0..1)",
    "mfu_ceiling": "roofline MFU ceiling of the compiled step (0..1)",
    "step_wall_seconds": "recent mean wall seconds per step",
    "loss": "most recent training loss",
    "steps_total": "training steps completed this run",
    "hbm_peak_bytes": "peak device memory (runtime stats, else compiled "
                      "memory analysis estimate)",
    "hbm_live_bytes": "device bytes currently in use (runtime stats)",
    "prefetch_stall_seconds_total": "input stall the prefetch overlap "
                                    "could not hide",
    "rollbacks_total": "health-guard rollbacks this run",
    "faults_total": "fault records this run (injected, detected, or "
                    "refused-checkpoint)",
    "elastic_events": "elastic resizes (surviving-mesh recoveries and "
                      "re-expansions) this run; also exported per "
                      "direction as ff_elastic_events{direction=...}",
    "ckpt_async_inflight": "async checkpoint writes currently in flight "
                           "(0 or 1)",
    "drain_pending": "1 while a SIGTERM/SIGINT graceful drain is "
                     "committing its final checkpoint, else 0",
    "qps": "serving throughput (completed requests per virtual second)",
    "queue_depth": "serving requests arrived but not yet admitted "
                   "to a decode slot",
    "latency_p50_s": "serving request latency p50 (virtual seconds, "
                     "arrival to completion)",
    "latency_p99_s": "serving request latency p99 (virtual seconds)",
    "ttft_p50_s": "serving time-to-first-token p50 (virtual seconds, "
                  "arrival to first decoded token)",
    "ttft_p99_s": "serving time-to-first-token p99 (virtual seconds)",
    "tpot_p50_s": "serving time-per-output-token p50 (virtual seconds "
                  "per decode token after the first)",
    "requests_total": "serving requests completed this run",
    "serve_pool_queue_depth": "disaggregated serving queue depth per "
                              "pool, exported as ff_serve_pool_"
                              "queue_depth{pool=\"prefill\"|\"decode\"}",
    "serve_pool_active_slots": "occupied decode slots per pool, "
                               "exported as ff_serve_pool_active_slots"
                               "{pool=...}",
    "serve_pool_step_time_s": "virtual step time per pool (the "
                              "per-phase searched strategy's step), "
                              "exported as ff_serve_pool_step_time_s"
                              "{pool=...}",
    "serve_pool_requests_total": "requests completed per pool, "
                                 "exported as ff_serve_pool_requests_"
                                 "total{pool=...}",
    "serve_retries_total": "serving retries this run (handoff "
                           "retransmits + KV rebuilds under the "
                           "router's RetryPolicy)",
    "serve_shed_total": "serving arrivals shed by the SLO-burn "
                        "admission gate this run (explicit "
                        "serve_shed records, never silent drops)",
    "replicas_live": "decode replicas currently live (crashed "
                     "replicas leave until their restart_s revival)",
    "slo_burn_rate": "SLO error-budget burn rate over the full stream "
                     "(1.0 = burning exactly the budget)",
    "slo_max_window_burn_rate": "worst rolling-window SLO burn rate",
    "slo_error_rate": "fraction of requests violating the SLO latency "
                      "target",
    "slo_goodput_qps": "SLO-compliant completed requests per virtual "
                       "second",
    "slo_compliant": "1 if the achieved latency percentile meets the "
                     "SLO target, else 0",
    "fleet_jobs": "fleet jobs by lifecycle state, exported as "
                  "ff_fleet_jobs{state=...}; the plain series is the "
                  "total job count",
    "fleet_job_devices": "devices currently assigned to each fleet "
                         "job, exported as ff_fleet_job_devices"
                         "{job=...}; the plain series is the pool's "
                         "assigned total",
    "fleet_rebalances_total": "fleet packing rebalances this run",
    "fleet_util": "pool utilization last fleet round (busy device-steps "
                  "/ pool capacity x round span, 0..1)",
}
_COUNTER_EXTRA = {"fleet_rebalances_total"}
_COUNTERS = {"steps_total", "rollbacks_total", "faults_total",
             "prefetch_stall_seconds_total", "elastic_events",
             "requests_total", "serve_retries_total",
             "serve_shed_total"} | _COUNTER_EXTRA

# Fixed log-spaced latency buckets: 1 ms .. 100 s in quarter-decade
# steps (21 finite upper bounds + the implicit +Inf).  Fixed — never
# derived from observed data — so scrapes from different replicas
# aggregate bucket-for-bucket.
LATENCY_BUCKETS = tuple(round(0.001 * 10 ** (i / 4), 10)
                        for i in range(21))

_HIST_HELP = {
    "request_latency_s": "serving request latency (virtual seconds, "
                         "arrival to completion)",
    "request_ttft_s": "serving time-to-first-token (virtual seconds)",
    "fleet_job_wait_s": "fleet job queue wait (virtual seconds, submit "
                        "to placement start)",
}


def _finite(v) -> Optional[float]:
    try:
        f = float(v)
    except (TypeError, ValueError):
        return None
    return f if math.isfinite(f) else None


class MetricsExporter:
    """Holds the current gauge values and rewrites the export files.

    ``update(**gauges)`` merges new values (None/non-finite dropped at
    write time), ``write()`` publishes both files atomically.  The
    exporter also carries a small ``meta`` dict (model/run id) rendered
    as an ``ff_run_info`` label line, and a scratch ``cache`` dict
    ``fit`` uses to keep its step FLOP count across boundaries."""

    def __init__(self, path: str, meta: Optional[Dict] = None):
        self.path = path
        self.json_path = path + ".json"
        self.meta = dict(meta or {})
        self.cache: Dict = {}
        self.values: Dict[str, float] = {}
        # labeled series: bare name -> {rendered label string -> value};
        # published right after the same-named plain series (which stays
        # the all-directions total, so unlabeled dashboards keep working)
        self.labeled: Dict[str, Dict[str, float]] = {}
        # histograms: bare name -> {"counts": per-bucket (non-cumulative,
        # +Inf last), "sum": float, "count": int}; buckets are the fixed
        # LATENCY_BUCKETS so replicas aggregate bucket-for-bucket
        self.histograms: Dict[str, Dict] = {}
        self._writes = 0
        d = os.path.dirname(os.path.abspath(path))
        os.makedirs(d, exist_ok=True)

    def update(self, **gauges) -> None:
        for k, v in gauges.items():
            self.values[k] = v

    def update_labeled(self, name: str, labels: Dict[str, str],
                       value) -> None:
        """Set one labeled sample, e.g. ``update_labeled("elastic_events",
        {"direction": "grow"}, 1)`` ->
        ``ff_elastic_events{direction="grow"} 1``."""
        key = ",".join(f'{k}="{v}"' for k, v in sorted(labels.items()))
        self.labeled.setdefault(name, {})[key] = value

    def observe(self, name: str, value) -> None:
        """Record one sample into the ``name`` histogram (fixed
        LATENCY_BUCKETS).  Non-finite samples are dropped — same
        poisoned-value contract as the gauges."""
        f = _finite(value)
        if f is None:
            return
        h = self.histograms.setdefault(
            name, {"counts": [0] * (len(LATENCY_BUCKETS) + 1),
                   "sum": 0.0, "count": 0})
        for i, le in enumerate(LATENCY_BUCKETS):
            if f <= le:
                h["counts"][i] += 1
                break
        else:
            h["counts"][-1] += 1  # +Inf bucket
        h["sum"] += f
        h["count"] += 1

    def finite_values(self) -> Dict[str, float]:
        out = {}
        for k, v in self.values.items():
            f = _finite(v)
            if f is not None:
                out[k] = f
        return out

    def render(self) -> str:
        vals = self.finite_values()
        lines = []
        if self.meta:
            labels = ",".join(
                f'{k}="{v}"' for k, v in sorted(self.meta.items()))
            lines.append(f"# HELP {PREFIX}run_info run identity labels")
            lines.append(f"# TYPE {PREFIX}run_info gauge")
            lines.append(f"{PREFIX}run_info{{{labels}}} 1")
        extra = set(vals) | set(self.labeled)
        ordered = [k for k in _HELP if k in extra] \
            + sorted(k for k in extra if k not in _HELP)
        for k in ordered:
            name = PREFIX + k
            if k in _HELP:
                lines.append(f"# HELP {name} {_HELP[k]}")
            lines.append(f"# TYPE {name} "
                         f"{'counter' if k in _COUNTERS else 'gauge'}")
            if k in vals:
                lines.append(f"{name} {vals[k]:.10g}")
            for labels, v in sorted(self.labeled.get(k, {}).items()):
                f = _finite(v)
                if f is not None:
                    lines.append(f"{name}{{{labels}}} {f:.10g}")
        for k in sorted(self.histograms):
            name = PREFIX + k
            if k in _HIST_HELP:
                lines.append(f"# HELP {name} {_HIST_HELP[k]}")
            lines.append(f"# TYPE {name} histogram")
            h = self.histograms[k]
            cum = 0
            for le, n in zip(LATENCY_BUCKETS, h["counts"]):
                cum += n
                lines.append(f'{name}_bucket{{le="{le:.10g}"}} {cum}')
            cum += h["counts"][-1]
            lines.append(f'{name}_bucket{{le="+Inf"}} {cum}')
            lines.append(f'{name}_sum {h["sum"]:.10g}')
            lines.append(f'{name}_count {h["count"]}')
        return "\n".join(lines) + "\n"

    def write(self) -> None:
        """Atomic rewrite of the textfile and the JSON snapshot (a
        failed write never tears the published files)."""
        self._writes += 1
        _replace(self.path, self.render())
        snap = {"ts": time.time(), "writes": self._writes,
                "meta": self.meta, "gauges": self.finite_values()}
        if self.histograms:
            snap["histograms"] = self.histograms
        _replace(self.json_path, json.dumps(snap, indent=1) + "\n")


def _replace(path: str, content: str) -> None:
    d = os.path.dirname(os.path.abspath(path))
    fd, tmp = tempfile.mkstemp(dir=d, prefix=".metrics-")
    try:
        with os.fdopen(fd, "w") as f:
            f.write(content)
        os.replace(tmp, path)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise


def from_config(config, meta: Optional[Dict] = None) \
        -> Optional[MetricsExporter]:
    """A live exporter when ``config.metrics_path`` is set, else None.
    Independent of ``obs_dir`` — a run may scrape without JSONL."""
    path = getattr(config, "metrics_path", "") or ""
    if not path:
        return None
    return MetricsExporter(path, meta=meta)


def read_textfile(path: str) -> Dict[str, float]:
    """Parse a Prometheus textfile back into ``{bare_name: value}`` (the
    ``ff_`` prefix stripped, label lines like ``run_info`` skipped) —
    the verification half of the export used by tests and
    ``apps.budget_smoke``.  Raises ValueError on a malformed sample
    line, which is exactly what "the textfile parses" means."""
    out: Dict[str, float] = {}
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            parts = line.split()
            if len(parts) != 2:
                raise ValueError(f"malformed metrics line: {line!r}")
            name, value = parts
            if "{" in name:
                continue  # labeled series (see read_labeled)
            if not name.startswith(PREFIX):
                raise ValueError(f"unexpected metric name: {name!r}")
            out[name[len(PREFIX):]] = float(value)
    return out


def read_histogram(path: str) -> Dict[str, Dict]:
    """Parse the histogram series of a textfile back into
    ``{bare_name: {"buckets": [(le, cumulative_count), ...],
    "sum": float, "count": int}}`` with ``le`` floats (``inf`` for the
    +Inf bucket) — the verification half of
    :meth:`MetricsExporter.observe`.  Raises ValueError when a
    histogram's buckets are not monotone non-decreasing or its +Inf
    bucket disagrees with ``_count``."""
    out: Dict[str, Dict] = {}
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            if "_bucket{le=" in line:
                name_part, _, rest = line.partition("_bucket{le=\"")
                le_str, _, val = rest.partition("\"}")
                bare = name_part[len(PREFIX):]
                le = float("inf") if le_str == "+Inf" else float(le_str)
                out.setdefault(bare, {"buckets": [], "sum": 0.0,
                                      "count": 0})
                out[bare]["buckets"].append((le, int(float(val))))
            elif "{" not in line:
                name, _, val = line.partition(" ")
                if name.endswith("_sum") and \
                        name[len(PREFIX):-len("_sum")] in out:
                    out[name[len(PREFIX):-len("_sum")]]["sum"] = \
                        float(val)
                elif name.endswith("_count") and \
                        name[len(PREFIX):-len("_count")] in out:
                    out[name[len(PREFIX):-len("_count")]]["count"] = \
                        int(float(val))
    for bare, h in out.items():
        counts = [n for _le, n in h["buckets"]]
        if any(b > a for a, b in zip(counts[1:], counts)):
            raise ValueError(
                f"histogram {bare!r} buckets not monotone: {counts}")
        if h["buckets"] and not math.isinf(h["buckets"][-1][0]):
            raise ValueError(f"histogram {bare!r} missing +Inf bucket")
        if h["buckets"] and counts[-1] != h["count"]:
            raise ValueError(
                f"histogram {bare!r}: +Inf bucket {counts[-1]} != "
                f"_count {h['count']}")
    return out


def read_labeled(path: str) -> Dict[str, Dict[str, float]]:
    """Parse the LABELED samples of a textfile back into
    ``{bare_name: {label_string: value}}`` (e.g.
    ``{"elastic_events": {'direction="grow"': 1.0}}``), skipping the
    ``run_info`` identity line — the verification half of
    :meth:`MetricsExporter.update_labeled`."""
    out: Dict[str, Dict[str, float]] = {}
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#") or "{" not in line:
                continue
            head, _, rest = line.partition("{")
            labels, _, value = rest.rpartition("}")
            if not head.startswith(PREFIX):
                raise ValueError(f"unexpected metric name: {head!r}")
            bare = head[len(PREFIX):]
            if bare == "run_info":
                continue
            out.setdefault(bare, {})[labels] = float(value.strip())
    return out
