"""Step-time budget and the MFU waterfall (the port's own copy of
``flexflow_tpu/obs/budget.py``): the accounting that turns "MFU is low"
into a ranked list of levers.

  * :func:`build_step_budget` — one (sampled or loop-mean) step's wall
    time decomposed into ``compute`` (isolated per-op shard timings plus
    the optimizer section), ``comm`` (the simulator's collective pricing
    of the loaded strategy, else the measured section residual),
    ``input_stall`` (the prefetcher's stall), ``host_sync`` (the
    boundaries' syncs), ``checkpoint`` (the saves' time on the
    boundary) and ``residual`` (what no instrument claimed).  Buckets
    are allocated greedily against the wall clock and clamped, so they
    are non-negative and sum to exactly the wall step time; the raw
    values are kept beside them.  ``FFModel.fit`` writes the result as
    one ``step_budget`` record per run, after the loop;
  * :func:`mfu_waterfall` — the run's ``step_budget`` record joined with
    its ``compile`` record (the step's FLOPs) and the card's peaks: the
    achieved MFU at the measured wall, then the MFU reached by removing
    each bucket, largest first, ending at the roofline ceiling;
  * :func:`render_waterfall` — the human table of the waterfall.

The default peaks are :class:`~flexflow_tpu_torch.sim.cost_model.
HopperChipPerf`'s, at the rate of the run's compute dtype
(``flops_rate``: the plain float32 rate for float32, the tensor cores'
bfloat16 rate otherwise) when the stream's ``run_start`` names it; a
``perf`` without ``flops_rate`` is read at its ``peak_flops``, as the
JAX module reads its own.
"""

from __future__ import annotations

from typing import Dict, Iterable, List, Optional

# allocation priority: earlier buckets claim wall time first; residual
# absorbs whatever remains.  Compute leads — it is the best-instrumented
# bucket — and the externally-amortized costs trail.
BUCKET_ORDER = ("compute", "comm", "input_stall", "host_sync",
                "checkpoint")


def build_step_budget(wall_s: float,
                      compute_s: Optional[float] = None,
                      comm_s: Optional[float] = None,
                      input_stall_s: Optional[float] = None,
                      host_sync_s: Optional[float] = None,
                      checkpoint_s: Optional[float] = None,
                      sources: Optional[Dict[str, str]] = None,
                      n_samples: int = 0) -> Dict:
    """The ``step_budget`` obs record body.  ``wall_s`` is the measured
    step wall time; each bucket argument is that family's raw estimate
    in seconds (None = no instrument, treated as 0 with source "none").

    Invariant: every bucket is >= 0 and the
    buckets INCLUDING ``residual`` sum to exactly ``wall_s`` — raw
    estimates are clamped to the remaining unallocated wall time in
    :data:`BUCKET_ORDER` priority, so an over-counting instrument (e.g.
    isolated op timings that exceed the fused step) cannot push the sum
    past the clock.  Clamped buckets are listed in ``clamped`` and their
    pre-clamp values kept in ``raw``."""
    wall_s = max(float(wall_s), 0.0)
    raw = {"compute": compute_s, "comm": comm_s,
           "input_stall": input_stall_s, "host_sync": host_sync_s,
           "checkpoint": checkpoint_s}
    buckets: Dict[str, float] = {}
    clamped: List[str] = []
    remaining = wall_s
    for name in BUCKET_ORDER:
        v = max(float(raw[name] or 0.0), 0.0)
        if v > remaining:
            clamped.append(name)
            v = remaining
        buckets[name] = v
        remaining -= v
    buckets["residual"] = remaining
    srcs = dict(sources or {})
    for name in BUCKET_ORDER:
        srcs.setdefault(name, "none" if raw[name] is None else "measured")
    return {
        "step_wall_s": wall_s,
        "buckets": buckets,
        "raw": {k: (None if v is None else float(v))
                for k, v in raw.items()},
        "clamped": clamped,
        "sources": srcs,
        "n_samples": int(n_samples),
    }


def check_budget(rec: Dict, tol: float = 1e-9) -> List[str]:
    """Violations of the budget invariant (empty = sound): buckets
    present, non-negative, and summing to <= step wall time (within
    float tolerance)."""
    errors: List[str] = []
    wall = rec.get("step_wall_s")
    buckets = rec.get("buckets")
    if not isinstance(wall, (int, float)) or wall < 0:
        return ["step_wall_s must be a non-negative number"]
    if not isinstance(buckets, dict):
        return ["buckets must be a dict"]
    total = 0.0
    for name, v in buckets.items():
        if not isinstance(v, (int, float)) or v < -tol:
            errors.append(f"bucket {name!r} must be non-negative, "
                          f"got {v!r}")
            continue
        total += max(float(v), 0.0)
    if total > wall + max(tol, wall * 1e-6):
        errors.append(f"buckets sum to {total} > step wall {wall}")
    return errors


# ---------------------------------------------------------------------------
# the MFU waterfall: budget x roofline ceiling


def peak_rate(perf, dtype: Optional[str] = None) -> float:
    """One card's peak FLOP/s for a compute dtype: ``perf.flops_rate``
    where ``perf`` has one and the dtype is known, else
    ``perf.peak_flops``."""
    if dtype and hasattr(perf, "flops_rate"):
        return float(perf.flops_rate(dtype))
    return float(perf.peak_flops)


def _latest(events: Iterable[Dict], kind: str) -> Optional[Dict]:
    found = None
    for e in events:
        if e.get("kind") == kind:
            found = e
    return found


def mfu_waterfall(events: Iterable[Dict], perf=None) -> Optional[Dict]:
    """Join a run's ``step_budget`` record with its ``compile`` record
    (the step's FLOPs and, where known, bytes) and the card's roofline
    into the waterfall:

      achieved MFU at the measured wall
        -> MFU after removing bucket 1 (the largest)
        -> ... (each bucket, descending seconds)
        -> roofline ceiling (the memory/compute floor of the step)

    ``rows`` lists the removable buckets largest-first with the MFU
    reached when that bucket (and every larger one) is removed —
    ``rows[0]`` is the biggest lever.  The ``compute`` bucket is only
    removable down to the roofline floor; its excess is listed as
    ``compute_overhead``.  Returns None when the stream has no
    ``step_budget`` record; MFU fields are None (seconds-only waterfall)
    when the compile record carries no FLOP count."""
    events = list(events)
    budget = _latest(events, "step_budget")
    if budget is None:
        return None
    wall = float(budget.get("step_wall_s") or 0.0)
    buckets = dict(budget.get("buckets") or {})
    compile_rec = _latest(events, "compile") or {}
    flops = float(compile_rec.get("flops") or 0.0)
    bytes_ = float(compile_rec.get("bytes_accessed") or 0.0)
    devices = 1
    dtype = None
    for e in events:
        if e.get("kind") == "run_start" and e.get("devices"):
            devices = int(e["devices"])
        if e.get("kind") == "run_start" and e.get("compute_dtype"):
            dtype = e["compute_dtype"]
    if perf is None:
        from flexflow_tpu_torch.sim.cost_model import HopperChipPerf

        perf = HopperChipPerf()
    peak = peak_rate(perf, dtype) * max(devices, 1)
    hbm = perf.hbm_bandwidth * max(devices, 1)

    floor_s = None
    mfu_ceiling = None
    if flops > 0:
        floor_s = max(flops / peak, bytes_ / hbm)
        mfu_ceiling = flops / floor_s / peak if floor_s > 0 else None

    def mfu_at(seconds: float) -> Optional[float]:
        if flops <= 0 or seconds <= 0:
            return None
        v = flops / seconds / peak
        # the floor is the honest limit; measurement jitter must not
        # report "above ceiling"
        return min(v, mfu_ceiling) if mfu_ceiling else v

    compute = float(buckets.get("compute", 0.0))
    compute_floor = min(compute, floor_s) if floor_s is not None \
        else compute
    removable = {k: float(v) for k, v in buckets.items() if k != "compute"}
    overhead = compute - compute_floor
    if overhead > 0:
        removable["compute_overhead"] = overhead
    rows = []
    remaining = wall
    for name, secs in sorted(removable.items(), key=lambda kv: -kv[1]):
        remaining -= secs
        rows.append({"bucket": name, "seconds": secs,
                     "share_of_step": secs / wall if wall > 0 else 0.0,
                     "mfu_after": mfu_at(remaining)})
    out = {
        "step_wall_s": wall,
        "buckets": buckets,
        "sources": budget.get("sources") or {},
        "n_samples": budget.get("n_samples", 0),
        "devices": devices,
        "flops_per_step": flops or None,
        "bytes_per_step": bytes_ or None,
        "floor_s": floor_s,
        "mfu": mfu_at(wall),
        "mfu_ceiling": mfu_ceiling,
        "rows": rows,
    }
    summary = _latest(events, "summary")
    if summary and summary.get("images_per_sec"):
        out["images_per_sec"] = summary["images_per_sec"]
    return out


def _fmt_s(s: float) -> str:
    return f"{s * 1e3:.3f} ms" if s < 1.0 else f"{s:.3f} s"


def _pct(v: Optional[float]) -> str:
    return f"{100.0 * v:5.1f}%" if v is not None else "    ?"


def render_waterfall(wf: Dict) -> List[str]:
    """The human MFU waterfall table (the JAX package's ``report
    budget``)."""
    lines = [f"== MFU waterfall =="]
    head = (f"  step {_fmt_s(wf['step_wall_s'])}"
            + (f", {wf['devices']} devices" if wf.get("devices") else ""))
    if wf.get("images_per_sec"):
        head += f", {wf['images_per_sec']:.1f} items/s"
    if wf.get("n_samples"):
        head += f" ({wf['n_samples']} sampled steps)"
    lines.append(head)
    if wf.get("mfu") is not None:
        lines.append(f"  achieved MFU {_pct(wf['mfu'])}  "
                     f"(ceiling {_pct(wf['mfu_ceiling'])} at the "
                     f"{_fmt_s(wf['floor_s'])} roofline floor)")
    else:
        lines.append("  (no compiled cost analysis in the stream: "
                     "seconds-only waterfall, MFU columns omitted)")
    lines.append(f"  {'remove bucket':<18s} {'seconds':>12s} "
                 f"{'of step':>8s} {'MFU after':>10s}")
    for r in wf["rows"]:
        lines.append(
            f"  {r['bucket']:<18s} {_fmt_s(r['seconds']):>12s} "
            f"{100.0 * r['share_of_step']:>7.1f}% "
            f"{_pct(r['mfu_after']):>10s}")
    srcs = wf.get("sources") or {}
    noted = {k: v for k, v in sorted(srcs.items()) if v != "measured"}
    if noted:
        lines.append("  sources: " + ", ".join(
            f"{k}={v}" for k, v in noted.items()))
    biggest = wf["rows"][0] if wf.get("rows") else None
    if biggest and biggest["seconds"] > 0:
        lines.append(f"  biggest lever: {biggest['bucket']} "
                     f"({_fmt_s(biggest['seconds'])}/step)")
    return lines
