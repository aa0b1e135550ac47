"""Per-op timelines and the simulator's drift per op (PyTorch port of
``flexflow_tpu/obs/trace.py``): Chrome/Perfetto ``trace_event`` export of
simulated schedules and of ``fit``'s measured op times, and the join of
the two that ``apps/calibrate.py --from-obs`` refits from.

  * :func:`sim_trace_events` / :func:`fit_trace_events` /
    :func:`fit_counter_events` — ``trace_event`` lanes from a
    :meth:`StrategySearch.simulate_trace` dict or from ``fit``'s
    ``op_time``, ``step`` and ``metrics`` records;
  * :func:`chrome_trace` / :func:`write_trace` / :func:`validate_trace`
    — the JSON container and its schema check (required keys,
    non-negative times, no overlapping compute on one lane, finite
    counter values);
  * :func:`real_op_seconds` / :func:`sim_op_seconds` /
    :func:`drift_attribution` — measured against simulated seconds per
    op, ranked by each op's share of the absolute drift;
  * :func:`serve_trace_events` — a serving run's lanes: each request's
    queue, prefill, KV handoff and decode spans, the admission groups'
    arrows, the ``serve_batch`` counters (per pool when routed) and the
    resilience marks (``serve_retry``, ``serve_fault``, ``kv_rebuild``,
    ``serve_shed``, ``replica_down``);
  * :func:`trace_events_from_file` — the events of a written trace.

  * :func:`fleet_trace_events` — a fleet coordinator run's lanes: each
    job's devices and lifecycle, the rebalances with their flow arrows
    to the resizes they caused, the pool's utilization counters;

``python -m flexflow_tpu_torch.obs.trace --smoke`` simulates a toy
two-device graph on the port's native simulator, exports its trace and
validates it.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, Iterable, List, Optional

_US = 1e6  # trace_event timestamps/durations are microseconds

# fixed pid assignment of the standard lanes; extra producers may pick
# any other pid — pids only have to be distinct within one file
PID_SIM_BEST = 0
PID_SIM_DP = 1
PID_REAL = 2
PID_SERVE = 3
PID_FLEET = 4


def meta_event(pid: int, name: str, tid: Optional[int] = None) -> Dict:
    ev = {"name": "thread_name" if tid is not None else "process_name",
          "ph": "M", "pid": pid, "args": {"name": name}}
    if tid is not None:
        ev["tid"] = tid
    return ev


def sim_trace_events(sim: Dict, pid: int = PID_SIM_BEST,
                     label: str = "sim") -> List[Dict]:
    """Chrome events for one simulated schedule (the dict
    :meth:`StrategySearch.simulate_trace` returns).  Lanes: one thread
    per device for compute intervals, one ``dev N recv`` thread per
    destination device for transfers (concurrent flows may overlap
    there), one ``param sync`` thread for the serialized sync terms."""
    events = [meta_event(pid, label)]
    named = set()

    def lane(tid: int, name: str):
        if tid not in named:
            named.add(tid)
            events.append(meta_event(pid, name, tid))

    for r in sim.get("events", []):
        args = {"op": r.get("op"), "op_kind": r.get("op_kind"),
                "seconds": r["dur"], "cfg": r.get("cfg")}
        if r["kind"] == "compute":
            tid = r["device"]
            lane(tid, f"dev {r['device']}")
            cat = "compute"
        elif r["kind"] == "transfer":
            tid = 1000 + r["dst_device"]
            lane(tid, f"dev {r['dst_device']} recv")
            cat = "transfer"
            args["bytes"] = r.get("bytes", 0.0)
            args["src_device"] = r.get("src_device")
        else:  # sync
            tid = 2000
            lane(tid, "param sync")
            cat = "sync"
        events.append({"name": str(r.get("op")), "cat": cat, "ph": "X",
                       "ts": r["start"] * _US, "dur": r["dur"] * _US,
                       "pid": pid, "tid": tid, "args": args})
    return events


def fit_trace_events(records: Iterable[Dict], pid: int = PID_REAL,
                     label: str = "real") -> List[Dict]:
    """Chrome events for the measured side: ``op_time`` obs records from
    a ``fit()`` run with op timing enabled.  Section samples (forward /
    backward / optimizer, per sampled step) lay out sequentially on one
    ``sections`` thread in record order; isolated per-op shard timings on
    an ``ops (isolated shard)`` thread.  Timestamps are synthetic
    cursors — the lanes show relative durations side by side with the
    simulated schedule, not wall-clock alignment.  Counter lanes
    (:func:`fit_counter_events`) ride along: per-step throughput from
    ``step`` records plus MFU / HBM bytes from ``metrics`` records,
    rendered by Perfetto as value-over-time tracks under the same
    process."""
    records = list(records)
    sections = [r for r in records if r.get("kind") == "op_time"
                and r.get("scope") == "section"]
    per_op = [r for r in records if r.get("kind") == "op_time"
              and r.get("scope") == "op"]
    events = [meta_event(pid, label)]
    if sections:
        events.append(meta_event(pid, "sections", 0))
        t = 0.0
        for r in sections:
            dur = float(r.get("seconds", 0.0))
            events.append({
                "name": str(r.get("section", "?")), "cat": "compute",
                "ph": "X", "ts": t * _US, "dur": dur * _US,
                "pid": pid, "tid": 0,
                "args": {"step": r.get("step"), "seconds": dur}})
            t += dur
    if per_op:
        events.append(meta_event(pid, "ops (isolated shard)", 1))
        t = 0.0
        for r in per_op:
            dur = float(r.get("seconds", 0.0))
            events.append({
                "name": str(r.get("op", "?")), "cat": "compute",
                "ph": "X", "ts": t * _US, "dur": dur * _US,
                "pid": pid, "tid": 1,
                "args": {"op_kind": r.get("op_kind"), "seconds": dur,
                         "measured": r.get("measured")}})
            t += dur
    events.extend(fit_counter_events(records, pid=pid))
    return events


def fit_counter_events(records: Iterable[Dict],
                       pid: int = PID_REAL) -> List[Dict]:
    """Perfetto **counter** lanes (``ph: "C"``) of a fit run's gauges on
    the run's own step-time axis:

      * ``imgs/s`` — per-step throughput from the ``step`` records,
        sampled at each step's cumulative wall time;
      * ``MFU`` and ``HBM bytes`` (live/peak) — from the ``metrics``
        records the exporter mirrors into the obs stream, positioned at
        the cumulative wall time of the step count each snapshot
        reports.

    Counter events carry their series values in ``args`` (Perfetto
    renders one track per arg key).  Empty when the stream has neither
    record kind."""
    records = list(records)
    steps = [r for r in records if r.get("kind") == "step"
             and isinstance(r.get("wall_ms"), (int, float))]
    metrics = [r for r in records if r.get("kind") == "metrics"]
    events: List[Dict] = []
    # cumulative wall-clock cursor per step (seconds), indexed by step
    # ordinal — the shared time axis of every counter lane
    cum: List[float] = [0.0]
    t = 0.0
    for r in steps:
        t += float(r["wall_ms"]) / 1e3
        cum.append(t)

    def at_step(n) -> float:
        try:
            n = int(n)
        except (TypeError, ValueError):
            return cum[-1]
        return cum[min(max(n, 0), len(cum) - 1)]

    for i, r in enumerate(steps):
        v = r.get("images_per_sec")
        if isinstance(v, (int, float)):
            events.append({"name": "imgs/s", "ph": "C", "pid": pid,
                           "tid": 0, "ts": cum[i + 1] * _US,
                           "args": {"imgs/s": float(v)}})
    for r in metrics:
        ts = at_step(r.get("steps_total", None)) * _US
        mfu = r.get("mfu")
        if isinstance(mfu, (int, float)):
            events.append({"name": "MFU", "ph": "C", "pid": pid,
                           "tid": 0, "ts": ts,
                           "args": {"mfu": float(mfu)}})
        hbm = {k: float(r[k]) for k in ("hbm_live_bytes",
                                        "hbm_peak_bytes")
               if isinstance(r.get(k), (int, float))}
        if hbm:
            events.append({"name": "HBM bytes", "ph": "C", "pid": pid,
                           "tid": 0, "ts": ts, "args": hbm})
    return events


def chrome_trace(*event_lists: Iterable[Dict]) -> Dict:
    """The ``trace_event`` JSON object (object-format container, the one
    Perfetto and chrome://tracing both load)."""
    events: List[Dict] = []
    for lst in event_lists:
        events.extend(lst)
    return {"traceEvents": events, "displayTimeUnit": "ms"}


def write_trace(path: str, trace: Dict) -> str:
    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)
    with open(path, "w") as f:
        json.dump(trace, f)
    return path


def validate_trace(trace: Any) -> List[str]:
    """Schema check for a ``trace_event`` object: required keys per
    event, non-negative timestamps/durations, non-overlapping (monotone)
    compute intervals per (pid, tid) lane, and — for counter events
    (``ph: "C"``) — an ``args`` dict of finite numeric series values.
    Returns the list of violations — empty means the trace is loadable
    and internally consistent.  Transfer lanes are exempt from the
    overlap check: concurrent flows into one device legitimately
    overlap."""
    import math

    errors: List[str] = []
    if not isinstance(trace, dict) or not isinstance(
            trace.get("traceEvents"), list):
        return ["trace must be a dict with a traceEvents list"]
    lanes: Dict[tuple, List[tuple]] = {}
    for i, ev in enumerate(trace["traceEvents"]):
        if not isinstance(ev, dict):
            errors.append(f"event {i}: not an object")
            continue
        for k in ("name", "ph", "pid"):
            if k not in ev:
                errors.append(f"event {i}: missing required key {k!r}")
        ph = ev.get("ph")
        if ph == "M":
            continue
        if ph != "C" and "tid" not in ev:
            errors.append(f"event {i}: missing required key 'tid'")
        ts = ev.get("ts")
        if not isinstance(ts, (int, float)) or ts < 0:
            errors.append(f"event {i}: ts must be a non-negative number")
            continue
        if ph == "C":
            args = ev.get("args")
            if not isinstance(args, dict) or not args:
                errors.append(
                    f"event {i}: counter event needs a non-empty args "
                    f"dict of series values")
                continue
            for k, v in args.items():
                if not isinstance(v, (int, float)) \
                        or not math.isfinite(v):
                    errors.append(
                        f"event {i}: counter series {k!r} must be a "
                        f"finite number, got {v!r}")
            continue
        if ph == "X":
            dur = ev.get("dur")
            if not isinstance(dur, (int, float)) or dur < 0:
                errors.append(
                    f"event {i}: X event needs non-negative dur")
                continue
            if ev.get("cat") == "compute":
                lanes.setdefault((ev.get("pid"), ev.get("tid")),
                                 []).append((ts, dur, i))
    for (pid, tid), iv in lanes.items():
        iv.sort()
        end = 0.0
        for ts, dur, i in iv:
            if ts < end - 1e-3:  # 1 ns slack in trace microseconds
                errors.append(
                    f"event {i}: compute intervals overlap on lane "
                    f"pid={pid} tid={tid} (start {ts} < prev end {end})")
            end = max(end, ts + dur)
    return errors


# ---------------------------------------------------------------------------
# serving lanes: per-request lifecycle + engine counters


def serve_trace_events(records: Iterable[Dict], pid: int = PID_SERVE,
                       label: str = "serve") -> List[Dict]:
    """Chrome events for one serve-engine or router run
    (``flexflow_tpu/obs/trace.py:290-494``), from its
    ``serve_request`` / ``serve_batch`` obs records (virtual-clock
    timestamps, so the trace is bit-identical under a fixed seed).

    Lanes:

      * one thread per request (``req <rid>``): a ``queue`` span from
        arrival to admission, then a ``decode`` span from admission to
        completion carrying TTFT/TPOT/latency in ``args``.  Request
        cats are NOT ``compute`` — concurrent requests legitimately
        overlap across lanes and within a continuous batch;
      * ROUTED requests (a ``serve_handoff`` record exists for the
        rid, serve/router.py) split the lane into the full lifecycle:
        ``queue`` (arrival -> admit), a ``prefill`` span (admit ->
        first token, the prompt pass), a ``handoff`` flow arrow
        (``ph: "s"``/``"f"``) spanning the priced KV transfer, then
        the ``decode`` span from the handoff landing to completion;
      * admission flow arrows (``ph: "s"``/``"f"``): requests admitted
        at the same virtual instant are one continuous-batching
        admission group — the arrow runs from the group's first
        request lane to each other member;
      * counter lanes from ``serve_batch``: queue depth, active/
        admitted slots, and KV-cache occupancy (tokens + fraction of
        the ``max_batch x max_seq`` rectangle) over virtual time —
        per pool (``... [prefill]``/``... [decode]``) when the batch
        records carry pool labels;
      * resilience instants (``ph: "i"``, cat ``fault`` — never
        ``compute``, so the overlap check ignores them): per-request
        marks on the rid's lane for ``serve_retry`` / ``serve_fault``
        / ``kv_rebuild`` / ``serve_shed`` records (shed rids get a
        lane even though they never produce a ``serve_request``), and
        process-scoped ``replica_down`` marks on a dedicated
        ``replica faults`` lane.

    Timestamps are shifted so the earliest arrival lands at 0 (trace
    viewers and :func:`validate_trace` want non-negative ts)."""
    records = list(records)
    reqs = [r for r in records if r.get("kind") == "serve_request"]
    batches = [r for r in records if r.get("kind") == "serve_batch"]
    handoffs = {r.get("rid"): r for r in records
                if r.get("kind") == "serve_handoff"}
    marks = [r for r in records
             if r.get("kind") in ("serve_retry", "serve_fault",
                                  "kv_rebuild", "serve_shed")]
    downs = [r for r in records if r.get("kind") == "replica_down"]
    events = [meta_event(pid, label)]
    if not reqs and not batches and not marks and not downs:
        return events
    t0 = min([float(r["arrival_v"]) for r in reqs
              if r.get("arrival_v") is not None]
             + [float(b["vnow"]) for b in batches
                if b.get("vnow") is not None]
             + [float(m["vnow"]) for m in marks + downs
                if m.get("vnow") is not None] + [0.0])

    def ts(v: float) -> float:
        return (float(v) - t0) * _US

    tids: Dict[Any, int] = {}
    for r in reqs:
        rid = r.get("rid")
        if rid not in tids:
            tids[rid] = 10 + len(tids)
            events.append(meta_event(pid, f"req {rid}", tids[rid]))
        tid = tids[rid]
        arrival = r.get("arrival_v")
        admit = r.get("admit_v")
        done = r.get("done_v")
        if arrival is not None and admit is not None:
            events.append({
                "name": f"queue {rid}", "cat": "queue", "ph": "X",
                "ts": ts(arrival),
                "dur": max(0.0, (float(admit) - float(arrival)) * _US),
                "pid": pid, "tid": tid,
                "args": {"rid": rid,
                         "queue_wait_s": float(admit) - float(arrival)}})
        decode_args = {"rid": rid, "latency_s": r.get("latency_s"),
                       "ttft_s": r.get("ttft_s"),
                       "tpot_s": r.get("tpot_s"),
                       "prompt_len": r.get("prompt_len"),
                       "new_tokens": r.get("new_tokens")}
        ho = handoffs.get(rid)
        first = r.get("first_token_v")
        land = ho.get("handoff_v") if ho else None
        if ho is not None and admit is not None and done is not None \
                and first is not None and land is not None:
            # routed lifecycle: prefill span -> handoff flow arrow
            # (spanning the priced KV transfer) -> decode span.  Flow
            # ids live above 1_000_000 so they never collide with the
            # admission-group ids (which enumerate from 0).
            events.append({
                "name": f"prefill {rid}", "cat": "prefill", "ph": "X",
                "ts": ts(admit),
                "dur": max(0.0, (float(first) - float(admit)) * _US),
                "pid": pid, "tid": tid,
                "args": {"rid": rid, "prompt_len": r.get("prompt_len"),
                         "from_replica": ho.get("from_replica")}})
            flow_id = 1_000_000 + tid
            ho_args = {"rid": rid, "bytes": ho.get("bytes"),
                       "hops": ho.get("hops"),
                       "predicted_s": ho.get("predicted_s"),
                       "from_replica": ho.get("from_replica"),
                       "to_replica": ho.get("to_replica")}
            events.append({"name": "handoff", "cat": "handoff",
                           "ph": "s", "id": flow_id, "ts": ts(first),
                           "pid": pid, "tid": tid, "args": ho_args})
            events.append({"name": "handoff", "cat": "handoff",
                           "ph": "f", "bp": "e", "id": flow_id,
                           "ts": ts(land), "pid": pid, "tid": tid,
                           "args": ho_args})
            decode_args["to_replica"] = ho.get("to_replica")
            events.append({
                "name": f"decode {rid}", "cat": "decode", "ph": "X",
                "ts": ts(land),
                "dur": max(0.0, (float(done) - float(land)) * _US),
                "pid": pid, "tid": tid, "args": decode_args})
        elif admit is not None and done is not None:
            events.append({
                "name": f"decode {rid}", "cat": "decode", "ph": "X",
                "ts": ts(admit),
                "dur": max(0.0, (float(done) - float(admit)) * _US),
                "pid": pid, "tid": tid, "args": decode_args})
    # resilience marks: per-request fault/retry/rebuild/shed instants
    # on the rid's lane (allocated on demand — a shed request has no
    # serve_request record, but its refusal still deserves a mark)
    for m in marks:
        rid, vnow = m.get("rid"), m.get("vnow")
        if vnow is None:
            continue
        if rid not in tids:
            tids[rid] = 10 + len(tids)
            events.append(meta_event(pid, f"req {rid}", tids[rid]))
        args = {k: m.get(k) for k in
                ("rid", "reason", "attempt", "attempts", "delay_s",
                 "tokens", "to_replica", "burn_rate", "priority")
                if m.get(k) is not None}
        events.append({"name": m["kind"], "cat": "fault", "ph": "i",
                       "s": "t", "ts": ts(vnow), "pid": pid,
                       "tid": tids[rid], "args": args})
    # pool-level replica_down instants on a dedicated faults lane
    if downs:
        events.append(meta_event(pid, "replica faults", 9))
    for d in downs:
        vnow = d.get("vnow")
        if vnow is None:
            continue
        events.append({
            "name": f"replica_down {d.get('pool')}[{d.get('replica')}]",
            "cat": "fault", "ph": "i", "s": "p", "ts": ts(vnow),
            "pid": pid, "tid": 9,
            "args": {k: d.get(k) for k in
                     ("pool", "replica", "in_flight", "queued",
                      "restart_s") if d.get(k) is not None}})
    # admission groups -> flow arrows between member lanes
    groups: Dict[float, List[Dict]] = {}
    for r in reqs:
        if r.get("admit_v") is not None:
            groups.setdefault(float(r["admit_v"]), []).append(r)
    for flow_id, admit in enumerate(sorted(groups)):
        members = groups[admit]
        if len(members) < 2:
            continue  # a single admission needs no arrow
        head, rest = members[0], members[1:]
        events.append({"name": "admit", "cat": "admission", "ph": "s",
                       "id": flow_id, "ts": ts(admit), "pid": pid,
                       "tid": tids[head.get("rid")],
                       "args": {"batch": len(members)}})
        for m in rest:
            events.append({"name": "admit", "cat": "admission",
                           "ph": "f", "bp": "e", "id": flow_id,
                           "ts": ts(admit), "pid": pid,
                           "tid": tids[m.get("rid")],
                           "args": {"batch": len(members)}})
    for b in batches:
        vnow = b.get("vnow")
        if vnow is None:
            continue
        bts = ts(vnow)
        # disaggregated pools get their own counter tracks ("queue
        # depth [prefill]" / "[decode]"); single-pool runs keep the
        # plain names.
        pool = b.get("pool") or ""
        suffix = f" [{pool}]" if pool else ""
        if isinstance(b.get("queue_depth"), (int, float)):
            events.append({"name": f"queue depth{suffix}", "ph": "C",
                           "pid": pid, "tid": 0, "ts": bts,
                           "args": {"queued": float(b["queue_depth"])}})
        slots = {k: float(b[k]) for k in ("active", "admitted")
                 if isinstance(b.get(k), (int, float))}
        if slots:
            events.append({"name": f"slots{suffix}", "ph": "C",
                           "pid": pid, "tid": 0, "ts": bts,
                           "args": slots})
        kv = {k: float(b[k]) for k in ("kv_tokens", "kv_frac")
              if isinstance(b.get(k), (int, float))}
        if kv:
            events.append({"name": f"KV cache{suffix}", "ph": "C",
                           "pid": pid, "tid": 0, "ts": bts,
                           "args": kv})
    return events


# ---------------------------------------------------------------------------
# drift attribution: the sim-vs-real per-op join


def real_op_seconds(events: Iterable[Dict]) -> Dict[str, Dict]:
    """Measured per-op seconds from ``op_time`` obs records
    (``scope == "op"``): median over samples, op kind carried along.
    Genuinely measured samples outrank analytic stand-ins (records with
    ``measured: false`` — an unrealizable shard that fit() priced via the
    roofline), and the ``measured`` flag is surfaced so consumers like
    ``calibrate --from-obs`` can refuse to fit anchors on a stand-in
    (real/analytic would be exactly 1.0 — circular, not informative)."""
    samples: Dict[str, List[float]] = {}
    fallback: Dict[str, List[float]] = {}
    kinds: Dict[str, str] = {}
    for e in events:
        if e.get("kind") != "op_time" or e.get("scope") != "op":
            continue
        op = str(e.get("op"))
        sink = fallback if e.get("measured") is False else samples
        sink.setdefault(op, []).append(float(e.get("seconds", 0.0)))
        if e.get("op_kind"):
            kinds[op] = e["op_kind"]
    out = {}
    for op in set(samples) | set(fallback):
        vals = sorted(samples.get(op) or fallback.get(op) or [0.0])
        out[op] = {"seconds": vals[len(vals) // 2], "n": len(vals),
                   "op_kind": kinds.get(op),
                   "measured": op in samples}
    return out


def sim_op_seconds(events: Iterable[Dict]) -> Dict[str, Dict]:
    """Simulated per-op seconds from obs records: prefers ``sim_trace``
    records (written by ``apps/search.py -trace``, per-shard scheduled
    times), falls back to ``search_breakdown`` (compute + in-op
    collective per op).  Later records win — the newest search speaks for
    the strategy actually shipped."""
    out: Dict[str, Dict] = {}
    breakdown: Dict[str, Dict] = {}
    for e in events:
        if e.get("kind") == "sim_trace" and isinstance(
                e.get("op_s"), dict):
            for op, s in e["op_s"].items():
                out[str(op)] = {"seconds": float(s), "source": "sim_trace"}
        elif e.get("kind") == "search_breakdown":
            for row in e.get("ops", []):
                breakdown[str(row.get("op"))] = {
                    "seconds": float(row.get("compute_s", 0.0))
                    + float(row.get("collective_s", 0.0)),
                    "op_kind": row.get("kind"),
                    "compute_s": float(row.get("compute_s", 0.0)),
                    "collective_s": float(row.get("collective_s", 0.0)),
                    "source": "search_breakdown"}
    for op, row in breakdown.items():
        if op in out:
            out[op].setdefault("op_kind", row.get("op_kind"))
            out[op]["compute_s"] = row["compute_s"]
            out[op]["collective_s"] = row["collective_s"]
        else:
            out[op] = row
    return out


def drift_attribution(sim_ops: Dict[str, Dict],
                      real_ops: Dict[str, Dict],
                      step: Optional[Dict] = None) -> Dict:
    """Join simulated vs measured per-op seconds and rank ops by absolute
    drift contribution.  ``drift_s = real - sim`` (positive = the
    simulator is optimistic about this op); ``share`` is each op's
    fraction of the total absolute drift.  Ops present on only one side
    are listed separately — an op the simulator prices but the sampler
    never measured (or vice versa) is a coverage gap, not zero drift."""
    rows = []
    for op in sorted(set(sim_ops) & set(real_ops)):
        sim_s = float(sim_ops[op]["seconds"])
        real_s = float(real_ops[op]["seconds"])
        rows.append({
            "op": op,
            "op_kind": sim_ops[op].get("op_kind")
            or real_ops[op].get("op_kind"),
            "sim_s": sim_s, "real_s": real_s,
            "drift_s": real_s - sim_s,
            "ratio": real_s / sim_s if sim_s > 0 else None,
            "measured": real_ops[op].get("measured", True)})
    total_abs = sum(abs(r["drift_s"]) for r in rows)
    for r in rows:
        r["share"] = abs(r["drift_s"]) / total_abs if total_abs else 0.0
    rows.sort(key=lambda r: -abs(r["drift_s"]))
    out = {
        "ops": rows,
        "totals": {
            "sim_s": sum(r["sim_s"] for r in rows),
            "real_s": sum(r["real_s"] for r in rows),
            "drift_s": sum(r["drift_s"] for r in rows),
            "abs_drift_s": total_abs,
        },
        "sim_only": sorted(set(sim_ops) - set(real_ops)),
        "real_only": sorted(set(real_ops) - set(sim_ops)),
    }
    if step:
        out["step"] = step
    return out


# the fleet lifecycle states a trace lane renders (mirrors
# fleet.job.STATES + the historical "evicted" terminal; kept local so
# the obs layer stays importable without the fleet package)
STATES_ORDER = ("pending", "placing", "running", "draining", "resized",
                "done", "failed", "evicted")


def fleet_trace_events(records: Iterable[Dict],
                       pid: int = PID_FLEET,
                       label: str = "fleet") -> List[Dict]:
    """Perfetto lanes for one fleet coordinator run, from its
    ``fleet_job`` / ``fleet_rebalance`` / ``fleet_util`` obs records.

    Lanes:

      * one counter track per job (``job <name> devices``) sampled
        wherever its assignment is visible: ``fleet_job`` records
        carrying a ``devices`` field (admission, resize, completion —
        completion and eviction drop the track to 0) and
        ``fleet_rebalance`` moves (the post-move ``to`` length);
      * one LIFECYCLE thread per job (``job <name>``): an ``X`` span
        per state the job passes through (pending / placing / running
        / draining / resized), named by the state and spanning until
        the next transition; terminal ``done``/``failed`` is a
        zero-duration marker.  Lifecycle cats are not ``compute`` —
        the spans of different jobs legitimately overlap;
      * a ``coordinator`` thread with one zero-duration ``rebalance``
        marker per ``fleet_rebalance`` record, plus flow arrows
        (``ph: "s"``/``"f"``, ids from 2_000_000 — above the serving
        handoff range) from each rebalance to the first subsequent
        ``draining`` transition of every job it moves: the causal
        edge from the packing decision to the resizes it bought;
      * a ``pool util`` counter lane from the per-round ``fleet_util``
        records: average busy / resizing / idle device counts over
        each round span.

    The time axis prefers the records' virtual-clock ``vts`` stamps
    (bit-deterministic under a seed) and falls back to wall ``ts`` for
    pre-clock streams; everything is shifted so the earliest event
    lands at 0."""
    records = list(records)

    def tv(r) -> Optional[float]:
        v = r.get("vts", r.get("ts"))
        return float(v) if isinstance(v, (int, float)) else None

    samples: List[tuple] = []   # (t, job, devices) counter samples
    trail: Dict[str, List[tuple]] = {}   # job -> [(t, state)]
    rebalances: List[tuple] = []         # (t, rebalance_no, [jobs])
    utils: List[tuple] = []              # (t, busy, resizing, idle)
    job_order: List[str] = []
    for r in records:
        kind = r.get("kind")
        t = tv(r)
        if t is None:
            continue
        if kind == "fleet_job":
            job = r.get("job")
            devices = r.get("devices")
            state = r.get("state")
            if job is None:
                continue
            job = str(job)
            if job not in trail:
                trail[job] = []
                job_order.append(job)
            if state in STATES_ORDER:
                trail[job].append((t, state))
            if state in ("done", "failed", "evicted"):
                samples.append((t, job, 0.0))
            elif isinstance(devices, (int, float)):
                samples.append((t, job, float(devices)))
        elif kind == "fleet_rebalance":
            moved = []
            for mv in r.get("moves", []) or []:
                job = mv.get("job")
                to = mv.get("to")
                if job is not None and isinstance(to, list):
                    samples.append((t, str(job), float(len(to))))
                    moved.append(str(job))
            rebalances.append((t, r.get("rebalance"), moved))
        elif kind == "fleet_util":
            span = r.get("span_steps")
            if isinstance(span, (int, float)) and span > 0:
                utils.append((t,
                              float(r.get("busy_steps", 0)) / span,
                              float(r.get("resizing_steps", 0)) / span,
                              float(r.get("idle_steps", 0)) / span))
    events = [meta_event(pid, label)]
    times = ([s[0] for s in samples]
             + [t for ts_ in trail.values() for t, _ in ts_]
             + [t for t, _, _ in rebalances] + [t for t, *_ in utils])
    if not times:
        return events
    t0, t_end = min(times), max(times)

    def ts(t: float) -> float:
        return (t - t0) * _US

    # per-job device-occupancy counters (the original lanes)
    for t, job, devices in sorted(samples):
        events.append({"name": f"job {job} devices", "ph": "C",
                       "pid": pid, "tid": 0, "ts": ts(t),
                       "args": {"devices": devices}})
    # pool-utilization counter lane
    for t, busy, resizing, idle in sorted(utils):
        events.append({"name": "pool util", "ph": "C", "pid": pid,
                       "tid": 0, "ts": ts(t),
                       "args": {"busy": busy, "resizing": resizing,
                                "idle": idle}})
    # per-job lifecycle span lanes
    tids: Dict[str, int] = {}
    for job in job_order:
        tids[job] = 10 + len(tids)
        events.append(meta_event(pid, f"job {job}", tids[job]))
        walk = sorted(trail[job], key=lambda s: s[0])
        for i, (t, state) in enumerate(walk):
            if state in ("done", "failed", "evicted"):
                events.append({"name": state, "cat": "lifecycle",
                               "ph": "X", "ts": ts(t), "dur": 0.0,
                               "pid": pid, "tid": tids[job],
                               "args": {"job": job}})
                continue
            until = walk[i + 1][0] if i + 1 < len(walk) else t_end
            events.append({"name": state, "cat": "lifecycle",
                           "ph": "X", "ts": ts(t),
                           "dur": max(0.0, (until - t) * _US),
                           "pid": pid, "tid": tids[job],
                           "args": {"job": job}})
    # coordinator lane: rebalance markers + causal arrows to the
    # draining transitions each rebalance bought.  Flow ids from
    # 2_000_000 — above the serving handoff range, so merged
    # serve+fleet traces never collide.
    if rebalances:
        events.append(meta_event(pid, "coordinator", 1))
    flow_id = 2_000_000
    for t, number, moved in sorted(rebalances,
                                   key=lambda r: (r[0], str(r[1]))):
        events.append({"name": f"rebalance {number}", "cat": "sched",
                       "ph": "X", "ts": ts(t), "dur": 0.0, "pid": pid,
                       "tid": 1, "args": {"moves": len(moved)}})
        for job in moved:
            drains = [tj for tj, state in trail.get(job, [])
                      if state == "draining" and tj >= t]
            if not drains or job not in tids:
                continue
            args = {"job": job, "rebalance": number}
            events.append({"name": "move", "cat": "sched", "ph": "s",
                           "id": flow_id, "ts": ts(t), "pid": pid,
                           "tid": 1, "args": args})
            events.append({"name": "move", "cat": "sched", "ph": "f",
                           "bp": "e", "id": flow_id,
                           "ts": ts(min(drains)), "pid": pid,
                           "tid": tids[job], "args": args})
            flow_id += 1
    return events


def trace_events_from_file(path: str) -> List[Dict]:
    """Events of an on-disk Chrome trace JSON (a ``*.trace.json`` the
    search wrote), for merging into a combined sim+real file."""
    with open(path) as f:
        obj = json.load(f)
    if isinstance(obj, dict) and isinstance(obj.get("traceEvents"), list):
        return obj["traceEvents"]
    raise ValueError(f"{path}: not a trace_event JSON object")


# ---------------------------------------------------------------------------
# smoke entry (python -m flexflow_tpu_torch.obs.trace --smoke)


def _smoke() -> int:
    """Toy 2-device, 2-op graph through ffsim_simulate_trace: op0 shards
    rows over both devices, op1 gathers them on device 0, so the trace
    must contain compute intervals on both devices plus one cross-device
    transfer; the exported total must equal ffsim_simulate."""
    from flexflow_tpu_torch.sim.native import NativeSimulator

    ints = [2, 2, 2,
            # op0: no inputs, 1 config, 2 points (rows 0-2 on dev0,
            # rows 2-4 on dev1)
            0, 1, 2,
            0, 0, 2, 0, 1, 0, 1, 0, 1,
            1, 2, 4, 0, 1, 0, 1, 0, 1,
            # op1: consumes op0, 1 config, 1 point on dev0 needing all
            # 4 rows (rows 2-4 must cross from dev1)
            1, 0, 1, 1,
            0, 0, 4, 0, 1, 0, 1, 0, 1, 0, 4, 0, 1, 0, 1, 0, 1]
    dbls = [1.0, 1.0, 0.0,        # intra_bw, cross_bw, latency
            0.0, 0.0,             # param_bytes
            0.25, 0.5,            # compute per config
            1.0, 1.0,             # param_replicas
            0.0, 0.0]             # collective costs
    sim = NativeSimulator(ints, dbls, 2)
    records, total = sim.simulate_trace([0, 0])
    full = sim.simulate([0, 0])
    assert abs(total - full) < 1e-12, (total, full)
    xfers = [r for r in records if r["kind"] == "transfer"]
    assert len(xfers) == 1 and xfers[0]["bytes"] == 8.0, xfers
    wrapped = {"events": [
        {**r, "op": f"op{r['op']}", "op_kind": "Toy"} for r in records],
        "devices": 2}
    trace = chrome_trace(sim_trace_events(wrapped, label="sim:toy"))
    errors = validate_trace(trace)
    assert not errors, errors
    # the file round-trips through json (what Perfetto will parse)
    parsed = json.loads(json.dumps(trace))
    assert not validate_trace(parsed)
    print(f"ffsim trace smoke OK: {len(records)} records, "
          f"total {total:.3f}s, 1 cross-device transfer of 8 bytes")
    return 0


if __name__ == "__main__":
    import sys

    if "--smoke" in sys.argv[1:]:
        raise SystemExit(_smoke())
    print(__doc__.strip())
