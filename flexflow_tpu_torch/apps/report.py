"""Run-telemetry report CLI, the reader of the obs record schema (PyTorch
port of ``flexflow_tpu/apps/report.py``; the port writes the JAX
package's records, so both packages' streams render here).

    python -m flexflow_tpu_torch.apps.report <run.jsonl|obs_dir ...> [--json]
    python -m flexflow_tpu_torch.apps.report trace <run.jsonl|x.trace.json ...> \\
        [-o DIR] [--json]
    python -m flexflow_tpu_torch.apps.report budget <run.jsonl|obs_dir ...> \\
        [--json]
    python -m flexflow_tpu_torch.apps.report serve <run.jsonl|obs_dir ...> \\
        [--json] [--trace OUT.trace.json]
    python -m flexflow_tpu_torch.apps.report slo <run.jsonl|obs_dir ...> \\
        [--target-s X] [--availability Y] [--window-s W] \\
        [--percentile P] [--kind K] [--latency-field F] \\
        [--time-field T] [--json]
    python -m flexflow_tpu_torch.apps.report search <run.jsonl|obs_dir ...> \\
        [--json]
    python -m flexflow_tpu_torch.apps.report fusions <profile.json ...> \\
        [--top N] [--json]
    python -m flexflow_tpu_torch.apps.report fleet <run.jsonl|obs_dir ...> \\
        [--json] [--trace OUT.trace.json]

The default mode renders a run's JSONL stream (an ``-obs-dir`` run, the
``.trace.jsonl`` beside a saved strategy) into the summary tables
(``obs/report.py``: training, faults, elastic resizes, serving, SLO,
search, audits, traces); several files render as one merged stream,
rotated parts are walked, and a directory expands (recursively) to its
``*.jsonl`` streams.  ``--json`` prints :func:`obs.report.summarize`'s
one object instead.

* ``trace``: the drift-attribution pass: simulated per-op times
  (``sim_trace`` or ``search_breakdown`` records, or Chrome trace files)
  joined with measured ``op_time`` records, ranked by drift share, to
  ``<DIR>/drift_attribution.json`` and ``<DIR>/merged.trace.json``.
* ``budget``: the MFU waterfall of the stream's ``step_budget`` record
  (``obs/budget.py``); exit 1 without one or on a broken invariant.
* ``serve``: a serving run's latency histogram and percentiles, TTFT and
  TPOT, batch occupancy, resizes and the resilience lines; ``--trace``
  writes the validated per-request Perfetto lanes
  (``obs/trace.serve_trace_events``).  Exit 1 without ``serve_*``
  records.
* ``slo``: a latency SLO over ``serve_request`` records (``obs/slo.py``):
  burn rates, achieved percentile, goodput; ``--kind`` and
  ``--latency-field`` retarget it.  Exit 1 without completed requests.
* ``search``: a strategy search's space, plan gate, trajectory, the
  decomposed path's blocks and stitch, and the plan's per-op costs.

* ``fusions``: the ranked residual account of an ``apps.profile``
  report (``obs/fusions.py``); exit 1 when an account breaks its
  invariants.
* ``fleet``: a fleet run's ``fleet_*`` records (``apps.fleet``,
  ``apps.fleetsim``): lifecycle trails, wait decompositions, packings,
  rebalances, the utilization account re-checked against its invariant
  (exit 1 when a ``fleet_util`` record breaks it), fleetsim points;
  ``--trace`` exports the fleet's lanes.
"""

from __future__ import annotations

import json
import os
import sys


def _expand_dirs(paths, log):
    """Directory arguments expand to the ``*.jsonl`` streams inside them
    (rotated parts ride along via run_files), so a whole obs dir can be
    rendered without globbing.  Expansion RECURSES into subdirectories:
    a fleet run keeps each job's stream in ``obs_dir/<job_id>/``, and
    ``report <obs_dir>`` must merge the coordinator's records with every
    job's."""
    import re

    out = []
    for p in paths:
        if os.path.isdir(p):
            found = []
            for dirpath, dirnames, filenames in os.walk(p):
                dirnames.sort()
                found.extend(
                    os.path.join(dirpath, fn) for fn in sorted(filenames)
                    if fn.endswith(".jsonl"))
            if not found:
                # rotated-only streams: point at each base-numbered part
                for dirpath, dirnames, filenames in os.walk(p):
                    dirnames.sort()
                    found.extend(
                        os.path.join(dirpath, fn)
                        for fn in sorted(filenames)
                        if re.search(r"\.jsonl\.\d+$", fn))
            if not found:
                log(f"warning: no *.jsonl streams under {p}")
            out.extend(found)
        else:
            out.append(p)
    return out


def _read_paths(paths, log):
    """Events of every given stream: JSONL runs (rotated parts walked via
    run_files) merged with the events of Chrome trace JSON files.
    Directories expand to their ``*.jsonl`` streams.
    Returns (obs_events, chrome_events)."""
    from flexflow_tpu_torch.obs import read_events, run_files

    obs_events, chrome_events = [], []
    for p in _expand_dirs(paths, log):
        if p.endswith(".json"):
            try:
                from flexflow_tpu_torch.obs.trace import trace_events_from_file

                chrome_events.extend(trace_events_from_file(p))
                continue
            except (ValueError, json.JSONDecodeError):
                pass  # a .json that is not a trace: fall through to JSONL
        files = run_files(p) or [p]
        for f in files:
            try:
                obs_events.extend(read_events(f))
            except OSError as e:
                log(f"warning: cannot read {f}: {e}")
    return obs_events, chrome_events


def trace_main(argv, log=print) -> int:
    """The drift-attribution pass (``report trace``): sim-vs-real per-op
    join + merged Perfetto trace."""
    from flexflow_tpu_torch.obs import trace as obstrace

    out_dir = "."
    paths = []
    json_out = False
    i = 0
    while i < len(argv):
        a = argv[i]
        if a in ("-o", "--out"):
            i += 1
            if i >= len(argv):
                raise SystemExit(f"flag {a!r} expects a value")
            out_dir = argv[i]
        elif a == "--json":
            json_out = True
        elif not a.startswith("-"):
            paths.append(a)
        i += 1
    if not paths:
        log(__doc__.strip())
        return 2
    events, chrome_events = _read_paths(paths, log)
    sim_ops = obstrace.sim_op_seconds(events)
    real_ops = obstrace.real_op_seconds(events)
    drift = [e for e in events if e.get("kind") == "sim_drift"]
    step = None
    if drift:
        d = drift[-1]
        step = {"predicted_s": d.get("predicted_s"),
                "measured_s": d.get("measured_s"),
                "ratio": d.get("value"), "source": d.get("source")}
    attribution = obstrace.drift_attribution(sim_ops, real_ops, step=step)
    os.makedirs(out_dir, exist_ok=True)
    attr_path = os.path.join(out_dir, "drift_attribution.json")
    with open(attr_path, "w") as f:
        json.dump(attribution, f, indent=1)
    # merged trace: sim lanes (from trace files when given, else a
    # sequential lane rebuilt from the per-op simulated seconds) next to
    # the measured lanes from the op_time records
    lanes = [chrome_events] if chrome_events else []
    if not chrome_events and sim_ops:
        lane = [obstrace.meta_event(obstrace.PID_SIM_BEST, "sim (per-op)"),
                obstrace.meta_event(obstrace.PID_SIM_BEST,
                               "ops (simulated)", 0)]
        t = 0.0
        for op in sorted(sim_ops, key=lambda o: -sim_ops[o]["seconds"]):
            dur = sim_ops[op]["seconds"]
            lane.append({"name": op, "cat": "compute", "ph": "X",
                         "ts": t * 1e6, "dur": dur * 1e6,
                         "pid": obstrace.PID_SIM_BEST, "tid": 0,
                         "args": {"seconds": dur,
                                  "op_kind": sim_ops[op].get("op_kind")}})
            t += dur
        lanes.append(lane)
    lanes.append(obstrace.fit_trace_events(events))
    merged = obstrace.chrome_trace(*lanes)
    merged_path = os.path.join(out_dir, "merged.trace.json")
    obstrace.write_trace(merged_path, merged)
    if json_out:
        log(json.dumps({"attribution": attribution,
                        "attribution_path": attr_path,
                        "merged_trace_path": merged_path}))
        return 0
    rows = attribution["ops"]
    if rows:
        log(f"drift attribution ({len(rows)} ops joined, "
            f"sim {attribution['totals']['sim_s'] * 1e3:.3f} ms vs real "
            f"{attribution['totals']['real_s'] * 1e3:.3f} ms):")
        log(f"  {'op':<18s} {'kind':<14s} {'sim ms':>9s} {'real ms':>9s} "
            f"{'drift ms':>9s} {'share':>6s}")
        for r in rows[:20]:
            log(f"  {r['op']:<18s} {str(r['op_kind'] or '?'):<14s} "
                f"{r['sim_s'] * 1e3:>9.3f} {r['real_s'] * 1e3:>9.3f} "
                f"{r['drift_s'] * 1e3:>+9.3f} {r['share']:>5.1%}")
    else:
        log("no joinable ops: need simulated per-op times (search -trace "
            "or search_breakdown records) AND measured op_time records "
            "(fit with --op-time-every N)")
    for side, ops in (("sim-only", attribution["sim_only"]),
                      ("real-only", attribution["real_only"])):
        if ops:
            log(f"  {side} (coverage gap): {', '.join(ops)}")
    if step:
        log(f"  step-level: predicted {step['predicted_s']}s vs measured "
            f"{step['measured_s']}s (ratio {step['ratio']})")
    log(f"written: {attr_path}, {merged_path}")
    return 0


def budget_main(argv, log=print) -> int:
    """The MFU-waterfall pass (``report budget``): join the stream's
    ``step_budget`` record with its compile-record FLOPs/bytes and the
    chip roofline, render largest-lever-first."""
    from flexflow_tpu_torch.obs.budget import (check_budget, mfu_waterfall,
                                         render_waterfall)

    json_out = "--json" in argv
    paths = [a for a in argv if not a.startswith("-")]
    if not paths:
        log(__doc__.strip())
        return 2
    events, _ = _read_paths(paths, log)
    events.sort(key=lambda e: e.get("ts", 0.0))
    wf = mfu_waterfall(events)
    if wf is None:
        log("no step_budget record in the stream(s): run fit() with "
            "-obs-dir set (add --op-time-every N for sampled-step "
            "decomposition and --metrics-path for live gauges)")
        return 1
    violations = check_budget({"step_wall_s": wf["step_wall_s"],
                               "buckets": wf["buckets"]})
    if json_out:
        log(json.dumps({"waterfall": wf, "violations": violations}))
        return 0 if not violations else 1
    log("\n".join(render_waterfall(wf)))
    if violations:
        log("BUDGET INVARIANT VIOLATED: " + "; ".join(violations))
        return 1
    return 0


def fusions_main(argv, log=print) -> int:
    """The per-fusion residual pass (``report fusions``): price each
    profiled row of a roofline profile JSON (``apps.profile``'s report,
    the ``utils/hlo_profile.roofline_report`` schema) against the card's
    roofline and print the ranked, verdicted residual account
    (obs/fusions.py).  Exit 1 when an account violates its sum-to-
    residual / verdict-coverage invariants."""
    from flexflow_tpu_torch.obs.fusions import (check_account, fusion_account,
                                          render_account)

    json_out = "--json" in argv
    top_n = 10
    paths = []
    i = 0
    while i < len(argv):
        a = argv[i]
        if a == "--top":
            i += 1
            if i >= len(argv):
                raise SystemExit("flag '--top' expects a value")
            top_n = int(argv[i])
        elif not a.startswith("-"):
            paths.append(a)
        i += 1
    if not paths:
        log(fusions_main.__doc__.strip())
        return 2
    accounts, problems = [], []
    for p in paths:
        with open(p) as f:
            profile = json.load(f)
        if not isinstance(profile, dict) or "top_ops" not in profile:
            log(f"{p}: not a roofline profile (no top_ops) — run "
                "apps.profile first")
            return 2
        acct = fusion_account(profile, top_n=top_n)
        accounts.append(acct)
        problems += [f"{p}: {m}" for m in check_account(acct)]
    if json_out:
        log(json.dumps({"accounts": accounts, "violations": problems}))
    else:
        for acct in accounts:
            log(render_account(acct))
        if problems:
            log("ACCOUNT INVARIANT VIOLATED: " + "; ".join(problems))
    return 1 if problems else 0


def serve_main(argv, log=print) -> int:
    """The serving pass (``report serve``): render the latency histogram
    + percentiles (latency, TTFT, TPOT), batch occupancy, autoscale
    resizes, and the resilience lines — per-crash ``replica_down``
    summaries, retry/rebuild/fault counts, and SLO-burn shed totals —
    of a serving run's ``serve_*`` records (apps/serve.py
    -obs-dir).  ``--trace OUT.trace.json`` exports the per-request
    Perfetto lanes (+ fault instant marks + fleet lanes when present),
    validated before writing.  Exit 1 when the stream carries no
    serving records."""
    from flexflow_tpu_torch.obs.report import _serve_section, summarize

    json_out = "--json" in argv
    trace_out = None
    paths = []
    i = 0
    while i < len(argv):
        a = argv[i]
        if a == "--trace":
            i += 1
            if i >= len(argv):
                raise SystemExit("flag '--trace' expects a value")
            trace_out = argv[i]
        elif not a.startswith("-"):
            paths.append(a)
        i += 1
    if not paths:
        log(serve_main.__doc__.strip())
        return 2
    events, _ = _read_paths(paths, log)
    events.sort(key=lambda e: e.get("ts", 0.0))
    if trace_out:
        from flexflow_tpu_torch.obs import trace as obstrace

        lanes = [obstrace.serve_trace_events(events)]
        if any(e.get("kind") in ("fleet_job", "fleet_rebalance")
               for e in events):
            lanes.append(obstrace.fleet_trace_events(events))
        trace = obstrace.chrome_trace(*lanes)
        errors = obstrace.validate_trace(trace)
        if errors:
            for e in errors:
                log(f"trace invalid: {e}")
            return 1
        obstrace.write_trace(trace_out, trace)
        log(f"written: {trace_out} "
            f"({len(trace['traceEvents'])} events; open in "
            f"ui.perfetto.dev)")
    if json_out:
        s = summarize(events).get("serve")
        log(json.dumps(s or {}))
        return 0 if s else 1
    lines = _serve_section(events)
    if not lines:
        log("no serve_* records in the stream(s): run apps/serve.py "
            "with -obs-dir set")
        return 1
    log("\n".join(lines))
    return 0


def fleet_main(argv, log=print) -> int:
    """The fleet pass (``report fleet``): render a coordinator run's
    ``fleet_*`` records — per-job lifecycle trails, wait
    decompositions (``fleet_wait``), packings, rebalances, the
    device-second utilization account (``fleet_util``, validated
    against its exact busy+idle+resizing == capacity invariant), and
    fleetsim sweep points.  ``--trace OUT.trace.json`` exports the
    per-job lifecycle lanes + rebalance flow arrows + pool-util
    counters, validated before writing.  Exit 1 when the stream
    carries no fleet records or a ``fleet_util`` record violates the
    invariant."""
    from flexflow_tpu_torch.fleet.coordinator import check_fleet_util
    from flexflow_tpu_torch.obs.report import _fleet_section, summarize

    json_out = "--json" in argv
    trace_out = None
    paths = []
    i = 0
    while i < len(argv):
        a = argv[i]
        if a == "--trace":
            i += 1
            if i >= len(argv):
                raise SystemExit("flag '--trace' expects a value")
            trace_out = argv[i]
        elif not a.startswith("-"):
            paths.append(a)
        i += 1
    if not paths:
        log(fleet_main.__doc__.strip())
        return 2
    events, _ = _read_paths(paths, log)
    events.sort(key=lambda e: e.get("ts", 0.0))
    violations = []
    for e in events:
        if e.get("kind") == "fleet_util":
            violations += check_fleet_util(e)
    if trace_out:
        from flexflow_tpu_torch.obs import trace as obstrace

        trace = obstrace.chrome_trace(obstrace.fleet_trace_events(events))
        errors = obstrace.validate_trace(trace)
        if errors:
            for e in errors:
                log(f"trace invalid: {e}")
            return 1
        obstrace.write_trace(trace_out, trace)
        log(f"written: {trace_out} "
            f"({len(trace['traceEvents'])} events; open in "
            f"ui.perfetto.dev)")
    if json_out:
        s = summarize(events)
        out = {k: s[k] for k in ("fleet", "fleetsim") if k in s}
        if violations:
            out["util_violations"] = violations
        log(json.dumps(out))
        return 0 if out and not violations else 1
    lines = _fleet_section(events)
    if not lines:
        log("no fleet_* records in the stream(s): run apps.fleet "
            "or apps.fleetsim with -obs-dir set")
        return 1
    log("\n".join(lines))
    if violations:
        log("FLEET_UTIL INVARIANT VIOLATED: " + "; ".join(violations))
        return 1
    return 0


def search_main(argv, log=print) -> int:
    """The search pass (``report search``): render a strategy-search
    run's records — the candidate space, pre-sim plan gate, flat-MCMC
    best-cost trajectory, and (for ``--decompose`` runs) the per-block
    sub-searches (``search_block``: searched vs memo-replayed, with
    acceptance and per-block best cost), the stitch account
    (``search_stitch``: boundary ops, regrid seconds, refinement,
    budget hit), the final result, and the winning plan's per-op cost
    breakdown.  ``--json`` emits summarize()'s ``search`` object.
    Exit 1 when the stream carries no search records."""
    from flexflow_tpu_torch.obs.report import _search_section, summarize

    json_out = "--json" in argv
    paths = [a for a in argv if not a.startswith("-")]
    if not paths:
        log(search_main.__doc__.strip())
        return 2
    events, _ = _read_paths(paths, log)
    events.sort(key=lambda e: e.get("ts", 0.0))
    if json_out:
        s = summarize(events).get("search")
        log(json.dumps(s or {}))
        return 0 if s else 1
    lines = _search_section(events)
    if not lines:
        log("no search records in the stream(s): run apps/search.py "
            "or apps/searchscale.py with -obs-dir set (or point at "
            "the .trace.jsonl written next to a saved strategy)")
        return 1
    log("\n".join(lines))
    return 0


def slo_main(argv, log=print) -> int:
    """The SLO pass (``report slo``): evaluate a latency SLO over the
    stream's ``serve_request`` records — whole-stream + worst-window
    error-budget burn rate, achieved percentile, goodput-under-SLO.
    Spec via ``--target-s`` / ``--availability`` / ``--window-s`` /
    ``--percentile``.  ``--kind`` / ``--latency-field`` /
    ``--time-field`` retarget the same burn-rate math at another
    record family (e.g. a wait-time SLO over a fleet stream:
    ``--kind fleet_wait --latency-field wait_s``).  Exit 1 when the
    stream has no completed requests."""
    from flexflow_tpu_torch.obs.slo import SLOSpec, burn_rate_windows, evaluate

    json_out = "--json" in argv
    spec_kw = {}
    flags = {"--target-s": ("latency_target_s", float),
             "--availability": ("availability", float),
             "--window-s": ("window_s", float),
             "--percentile": ("percentile", float),
             "--name": ("name", str)}
    stream_kw = {"kind": "serve_request", "latency_field": "latency_s",
                 "time_field": "done_v"}
    stream_flags = {"--kind": "kind", "--latency-field": "latency_field",
                    "--time-field": "time_field"}
    paths = []
    i = 0
    while i < len(argv):
        a = argv[i]
        if a in flags or a in stream_flags:
            i += 1
            if i >= len(argv):
                raise SystemExit(f"flag {a!r} expects a value")
            if a in flags:
                key, cast = flags[a]
                spec_kw[key] = cast(argv[i])
            else:
                stream_kw[stream_flags[a]] = argv[i]
        elif not a.startswith("-"):
            paths.append(a)
        i += 1
    if not paths:
        log(slo_main.__doc__.strip())
        return 2
    spec = SLOSpec(**spec_kw)
    events, _ = _read_paths(paths, log)
    events.sort(key=lambda e: e.get("ts", 0.0))
    result = evaluate(events, spec, **stream_kw)
    if not result["total"]:
        log(f"no completed {stream_kw['kind']} records in the "
            f"stream(s): run apps/serve.py, apps/loadtest.py, or "
            f"apps/fleetsim.py with -obs-dir set")
        return 1
    if json_out:
        result["window_detail"] = burn_rate_windows(events, spec,
                                                    **stream_kw)
        log(json.dumps(result))
        return 0
    s = result["spec"]
    log(f"slo[{s['name']}]: p{s['percentile']:g} latency <= "
        f"{s['latency_target_s']}s, availability {s['availability']}")
    log(f"  requests: {result['total']} ({result['violations']} over "
        f"target -> error rate {result['error_rate']:.4f} of budget "
        f"{result['error_budget']:.4f})")
    log(f"  burn rate: {result['burn_rate']:.2f}x overall, worst "
        f"{s['window_s']:g}s window {result['max_window_burn_rate']:.2f}x "
        f"({result['windows']} windows)")
    ach = result["achieved_percentile_s"]
    log(f"  achieved p{s['percentile']:g}: {ach:.4f}s -> "
        f"{'COMPLIANT' if result['compliant'] else 'VIOLATED'}, "
        f"goodput {result['goodput_qps']:.1f} qps")
    return 0


def main(argv=None, log=print) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if argv and argv[0] == "trace":
        return trace_main(argv[1:], log)
    if argv and argv[0] == "budget":
        return budget_main(argv[1:], log)
    if argv and argv[0] == "fusions":
        return fusions_main(argv[1:], log)
    if argv and argv[0] == "serve":
        return serve_main(argv[1:], log)
    if argv and argv[0] == "slo":
        return slo_main(argv[1:], log)
    if argv and argv[0] == "fleet":
        return fleet_main(argv[1:], log)
    if argv and argv[0] == "search":
        return search_main(argv[1:], log)
    json_out = "--json" in argv
    paths = [a for a in argv if not a.startswith("-")]
    if not paths or "-h" in argv or "--help" in argv:
        log(__doc__.strip())
        return 0 if paths or "-h" in argv or "--help" in argv else 2
    events, _ = _read_paths(paths, log)
    events.sort(key=lambda e: e.get("ts", 0.0))
    if json_out:
        from flexflow_tpu_torch.obs.report import summarize

        log(json.dumps(summarize(events)))
    else:
        from flexflow_tpu_torch.obs.report import render

        log(render(events))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
