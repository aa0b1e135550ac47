"""Trace-driven fleet simulation (PyTorch port of
``flexflow_tpu/apps/fleetsim.py``).

    python -m flexflow_tpu_torch.apps.fleetsim --out f.json
    python -m flexflow_tpu_torch.apps.fleetsim --smoke

Drives hundreds of SEEDED synthetic jobs (mixed train+serve; arrival
times from the load generator's composable patterns stretched over a
virtual day, sizes/priorities/durations from one fixed-order
RandomState) through the REAL
:class:`~flexflow_tpu_torch.fleet.coordinator. FleetCoordinator` /
:class:`~flexflow_tpu_torch.fleet.arbiter.Arbiter` in virtual time. Jobs
run in ``JobSpec.sim_steps`` trace mode and the arbiter prices with the
public DP proxy (``Arbiter.proxy_pricer``), so no model is ever built,
nothing touches a device, and a whole virtual day costs CPU-milliseconds
— while placement, packing, demand watermarks, and directed-resize
rebalances all exercise the production code paths.

The sweep scales the POOL (``--pools``) under the same offered load, so
the artifact pins the scheduler's capacity curve: per point it reports
device-second utilization (from the ``fleet_util`` records, whose
busy/idle/resizing buckets must sum EXACTLY to pool capacity x span at
every round — ``check_fleet_util`` runs on every record and any
violation fails the run), queue-wait percentiles (p50/p90/p99 over the
``fleet_wait`` decompositions), rebalance churn (moved-device count per
executed move), and a wait-time SLO verdict (obs/slo.py ``evaluate``
retargeted at ``kind="fleet_wait", latency_field="wait_s"``). One
``fleetsim`` obs record per point feeds ``report fleet`` /
``summarize``.

stdout carries EXACTLY ONE JSON line in the bench metric-line shape;
``--out`` additionally writes the ``fleet_bench_v1`` artifact: every
number in it is virtual-time derived and bit-reproducible under
``--seed`` (``--smoke`` PROVES it by running the first sweep point twice
and asserting byte-identical point payloads, and additionally validates
the lifecycle Perfetto trace).
"""

from __future__ import annotations

import json
import math
import os
import sys


def _err(*a, **kw):
    print(*a, file=sys.stderr, **kw)
    sys.stderr.flush()


def parse_args(argv):
    from flexflow_tpu_torch.config import flag_stream

    opts = {
        "pools": "8,16,32", "jobs": 120, "day_s": 86400.0, "seed": 0,
        "pattern": "diurnal+bursty", "quantum": 6, "step_time_s": 10.0,
        "resize_steps": 3, "train_frac": 0.7,
        "slo_wait_s": 1800.0, "percentile": 95.0, "availability": 0.9,
        "slo_window_s": 3600.0,
        "out": "", "trace": "", "obs_dir": "", "smoke": False,
    }
    for a, val in flag_stream(list(argv)):
        if a == "--pools":
            opts["pools"] = val()
        elif a in ("-n", "--jobs"):
            opts["jobs"] = int(val())
        elif a == "--day-s":
            opts["day_s"] = float(val())
        elif a == "--seed":
            opts["seed"] = int(val())
        elif a == "--pattern":
            opts["pattern"] = val()
        elif a == "--quantum":
            opts["quantum"] = int(val())
        elif a == "--step-time-s":
            opts["step_time_s"] = float(val())
        elif a == "--resize-steps":
            opts["resize_steps"] = int(val())
        elif a == "--train-frac":
            opts["train_frac"] = float(val())
        elif a == "--slo-wait-s":
            opts["slo_wait_s"] = float(val())
        elif a == "--percentile":
            opts["percentile"] = float(val())
        elif a == "--availability":
            opts["availability"] = float(val())
        elif a == "--slo-window-s":
            opts["slo_window_s"] = float(val())
        elif a in ("-o", "--out"):
            opts["out"] = val()
        elif a == "--trace":
            opts["trace"] = val()
        elif a in ("-obs-dir", "--obs-dir"):
            opts["obs_dir"] = val()
        elif a == "--smoke":
            opts["smoke"] = True
    if opts["jobs"] < 1:
        raise SystemExit("fleetsim: --jobs must be >= 1")
    if opts["day_s"] <= 0:
        raise SystemExit("fleetsim: --day-s must be > 0")
    if opts["step_time_s"] <= 0:
        raise SystemExit("fleetsim: --step-time-s must be > 0")
    if opts["smoke"]:
        opts["jobs"] = min(opts["jobs"], 24)
        opts["day_s"] = min(opts["day_s"], 7200.0)
        opts["pools"] = "4,8"
    return opts


def _round(v, nd=6):
    """Stable rounding for the committed artifact (loadtest idiom):
    virtual-time floats are bit-deterministic, rounding just keeps the
    JSON diff-friendly."""
    if v is None or not isinstance(v, float):
        return v
    return round(v, nd) if math.isfinite(v) else v


def _percentile(values, q):
    """Nearest-rank percentile over a non-empty list (obs/slo.py's
    convention, duplicated so this module stays import-light)."""
    if not values:
        return None
    xs = sorted(values)
    idx = max(0, min(len(xs) - 1,
                     int(math.ceil(q / 100.0 * len(xs))) - 1))
    return float(xs[idx])


def gen_jobs(opts):
    """The day's synthetic job mix: ``(arrival_v, spec_kwargs)`` pairs,
    bit-reproducible under ``--seed``.

    Arrival times come from the serving load generator's composed
    pattern machinery (one request = one job submission) with the
    diurnal period stretched to the virtual day and the mean rate set
    so ``--jobs`` arrivals span it; job shapes come from ONE seeded
    RandomState in a fixed draw order — kind (``--train-frac`` train,
    rest serve), priority in {0.5, 1, 2}, a 1-2 device floor with a
    +1/+2/+4 headroom cap, a heavy-tailed lognormal duration in
    virtual steps, and a backlog watermark for serve jobs so demand
    shifts (and therefore rebalances) happen for real."""
    import numpy as np

    from flexflow_tpu_torch.serve.loadgen import patterned_requests

    day = float(opts["day_s"])
    n = int(opts["jobs"])
    reqs = patterned_requests(
        n, seed=opts["seed"], rate_qps=n / day,
        pattern=opts["pattern"], prompt_len=1, max_new_tokens=1,
        diurnal_period_s=day, burst_on_s=day / 144.0,
        burst_off_s=day / 24.0)
    rng = np.random.RandomState(opts["seed"] + 1)
    out = []
    for i, r in enumerate(reqs):
        kind = "train" if rng.uniform() < opts["train_frac"] \
            else "serve"
        priority = float(rng.choice([0.5, 1.0, 2.0]))
        min_devices = int(rng.choice([1, 2]))
        max_devices = min_devices + int(rng.choice([1, 2, 4]))
        sim_steps = int(min(2000, max(8, rng.lognormal(4.0, 1.0))))
        queue_hi = max(4, sim_steps // 4) if kind == "serve" else 0
        out.append((float(r.arrival_v), {
            "job_id": f"sim-{i:04d}", "kind": kind, "build": None,
            "config": None, "priority": priority,
            "min_devices": min_devices, "max_devices": max_devices,
            "queue_hi": queue_hi, "sim_steps": sim_steps,
        }))
    return out


def _drive(coord, arrivals, step_time_s, log):
    """Run the virtual day through the coordinator: submit each job
    when its arrival time passes, round-robin quanta while anything
    runs, place queued arrivals into an emptied pool, and fast-forward
    (all-idle, still accounted) across gaps with nothing runnable."""
    queue = list(arrivals)          # (arrival_v, JobSpec), ascending

    def submit_due():
        while queue and queue[0][0] <= coord.clock.now() + 1e-9:
            _, spec = queue.pop(0)
            coord.submit(spec)

    submit_due()
    coord.start()
    while True:
        submit_due()
        if coord.step_round():
            continue
        # nothing running: place anything queued, else skip to the
        # next arrival, else the day is over
        if any(j.state == "pending" for j in coord.jobs):
            if coord.place_pending():
                continue
        if not queue:
            break
        gap = queue[0][0] - coord.clock.now()
        coord.idle_advance(max(1, int(math.ceil(gap / step_time_s))))
        submit_due()
        if not coord.place_pending() and not queue:
            break
    return coord.finish(wall_s=0.0)


def _sweep_point(pool_devices, opts, stream_path, log):
    """One sweep point: the same seeded day of jobs against a
    ``pool_devices``-wide virtual pool.  Returns the point payload (all
    virtual-time derived — bit-reproducible) after emitting it as a
    ``fleetsim`` record on the point's stream."""
    from flexflow_tpu_torch import obs
    from flexflow_tpu_torch.fleet import FleetCoordinator, check_fleet_util
    from flexflow_tpu_torch.fleet.arbiter import Arbiter
    from flexflow_tpu_torch.fleet.job import JobSpec
    from flexflow_tpu_torch.machine import MachineModel
    from flexflow_tpu_torch.obs.slo import SLOSpec, evaluate

    pool = MachineModel.virtual(pool_devices)
    olog = obs.RunLog(stream_path, surface="fleet",
                      meta={"app": "fleetsim", "seed": opts["seed"],
                            "pool_devices": pool_devices,
                            "jobs": opts["jobs"],
                            "day_s": opts["day_s"]})
    coord = FleetCoordinator(
        pool, olog=olog, pricer=Arbiter.proxy_pricer,
        quantum=opts["quantum"], seed=opts["seed"],
        step_time_s=opts["step_time_s"],
        resize_steps=opts["resize_steps"], log=log)
    arrivals = [(t, JobSpec(**kw)) for t, kw in gen_jobs(opts)]
    summary = _drive(coord, arrivals, opts["step_time_s"], log)

    events = list(obs.read_run(stream_path))
    utils = [e for e in events if e.get("kind") == "fleet_util"]
    violations = []
    for u in utils:
        violations.extend(check_fleet_util(u))
    busy = sum(u["busy_steps"] for u in utils)
    idle = sum(u["idle_steps"] for u in utils)
    resizing = sum(u["resizing_steps"] for u in utils)
    accounted = busy + idle + resizing
    waits = [e for e in events if e.get("kind") == "fleet_wait"]
    wait_s = [float(w["wait_s"]) for w in waits]
    churn = sum(
        len(set(m.get("to") or []) ^ set(m.get("from") or []))
        for e in events if e.get("kind") == "fleet_rebalance"
        for m in e.get("moves") or [])
    spec = SLOSpec(name=f"wait-p{opts['percentile']:g}-"
                        f"{opts['slo_wait_s']:g}s",
                   latency_target_s=opts["slo_wait_s"],
                   percentile=opts["percentile"],
                   availability=opts["availability"],
                   window_s=opts["slo_window_s"])
    slo = evaluate(events, spec, kind="fleet_wait",
                   latency_field="wait_s")

    point = {
        "pool": pool_devices,
        "jobs": len(coord.jobs),
        "jobs_done": summary["by_state"].get("done", 0),
        "jobs_failed": summary["by_state"].get("failed", 0),
        "rounds": sum(1 for u in utils if u.get("phase") == "round"),
        "virtual_s": summary["virtual_s"],
        "busy_steps": busy, "idle_steps": idle,
        "resizing_steps": resizing,
        "util": (busy / accounted) if accounted else 0.0,
        "util_violations": len(violations),
        "wait_p50_s": _percentile(wait_s, 50.0),
        "wait_p90_s": _percentile(wait_s, 90.0),
        "wait_p99_s": _percentile(wait_s, 99.0),
        "wait_mean_s": (sum(wait_s) / len(wait_s)) if wait_s else None,
        "rebalances": summary["rebalances"],
        "packs": summary["packs"],
        "churn_devices": churn,
        "slo_compliant": slo["compliant"],
        "slo_burn_rate": slo["burn_rate"],
        "slo_violations": slo["violations"],
    }
    olog.event("fleetsim", seed=opts["seed"], pattern=opts["pattern"],
               day_s=opts["day_s"], **point)
    olog.close()
    for v in violations:
        log(f"fleetsim UTIL INVARIANT VIOLATED [pool "
            f"{pool_devices}]: {v}")
    log(f"fleetsim: pool {pool_devices} -> "
        f"{point['jobs_done']}/{point['jobs']} done, util "
        f"{100.0 * point['util']:.1f}%, wait p50 "
        f"{point['wait_p50_s'] or 0.0:.0f}s p99 "
        f"{point['wait_p99_s'] or 0.0:.0f}s, "
        f"{point['rebalances']} rebalance(s), churn {churn}, "
        f"wait-slo " + ("COMPLIANT" if slo["compliant"]
                        else "VIOLATED"))
    return point


def _write_trace(opts, stream_path, log) -> bool:
    """Export + validate the first point's lifecycle Perfetto lanes.
    Returns True when the trace validated (and was written)."""
    from flexflow_tpu_torch import obs
    from flexflow_tpu_torch.obs import trace as obstrace

    events = list(obs.read_run(stream_path))
    trace = obstrace.chrome_trace(obstrace.fleet_trace_events(events))
    errors = obstrace.validate_trace(trace)
    if errors:
        for e in errors:
            log(f"fleetsim trace INVALID: {e}")
        return False
    path = opts["trace"] or os.path.join(
        os.path.dirname(stream_path), "fleet.trace.json")
    obstrace.write_trace(path, trace)
    opts["trace"] = path
    log(f"fleetsim trace ok: {path} "
        f"({len(trace['traceEvents'])} events)")
    return True


def run(opts, log=_err) -> dict:
    pools = sorted({int(p) for p in str(opts["pools"]).split(",")
                    if p.strip()})
    if not pools:
        raise SystemExit("fleetsim: --pools must name at least one "
                         "pool size")
    if any(p < 1 for p in pools):
        raise SystemExit(f"fleetsim: pool sizes must be >= 1, got "
                         f"{pools}")

    def stream(tag):
        return os.path.join(opts["obs_dir"], f"fleetsim_{tag}.jsonl")

    points = [_sweep_point(p, opts, stream(f"p{p}"), log)
              for p in pools]
    repro = None
    if opts["smoke"]:
        again = _sweep_point(pools[0], opts, stream("repro"), log)
        repro = json.dumps(again, sort_keys=True) == \
            json.dumps(points[0], sort_keys=True)
        if not repro:
            raise SystemExit(
                "fleetsim: NOT reproducible — pool "
                f"{pools[0]} point payload differs between two runs "
                f"of the same seed")
        log(f"fleetsim repro ok: pool {pools[0]} point bit-identical "
            f"across two runs")
    trace_ok = _write_trace(opts, stream(f"p{pools[0]}"), log)
    util_violations = sum(p["util_violations"] for p in points)
    if util_violations:
        raise SystemExit(f"fleetsim: {util_violations} fleet_util "
                         f"invariant violation(s) — see stderr")

    base, top = points[0], points[-1]
    vs_baseline = (base["util"] / top["util"]) \
        if top["util"] > 0 else None
    line = {
        "metric": f"fleet_sim_util_{base['pool']}dev",
        "value": _round(base["util"], 4),
        "unit": "frac",
        "vs_baseline": _round(vs_baseline, 4),
        "seed": opts["seed"],
        "pattern": opts["pattern"],
        "jobs": opts["jobs"],
        "day_s": opts["day_s"],
        "sweep_points": len(points),
        "wait_p50_s": _round(base["wait_p50_s"]),
        "wait_p99_s": _round(base["wait_p99_s"]),
        "rebalances": base["rebalances"],
        "churn_devices": base["churn_devices"],
        "slo_compliant": base["slo_compliant"],
        "util_violations": util_violations,
        "repro": repro,
        "trace_validated": trace_ok,
        "trace": opts["trace"] or None,
    }
    artifact = {
        "schema": "fleet_bench_v1",
        "seed": opts["seed"],
        "jobs": opts["jobs"],
        "day_s": opts["day_s"],
        "pattern": opts["pattern"],
        "quantum": opts["quantum"],
        "step_time_s": opts["step_time_s"],
        "resize_steps": opts["resize_steps"],
        "train_frac": opts["train_frac"],
        "slo": {"wait_target_s": opts["slo_wait_s"],
                "percentile": opts["percentile"],
                "availability": opts["availability"],
                "window_s": opts["slo_window_s"]},
        "parsed": {k: line[k] for k in
                   ("metric", "value", "unit", "vs_baseline")},
        "points": [{k: _round(v) for k, v in p.items()}
                   for p in points],
    }
    if opts["out"]:
        with open(opts["out"], "w") as f:
            json.dump(artifact, f, indent=1)
            f.write("\n")
        log(f"fleetsim artifact: {opts['out']}")
        line["out"] = opts["out"]
    return {"line": line, "artifact": artifact}


def main(argv=None, log=_err) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    opts = parse_args(argv)
    if not opts["obs_dir"]:
        import tempfile

        with tempfile.TemporaryDirectory(prefix="ff-fleetsim-") as td:
            opts["obs_dir"] = td
            result = run(opts, log)
            print(json.dumps(result["line"]))
            return 0
    os.makedirs(opts["obs_dir"], exist_ok=True)
    result = run(opts, log)
    print(json.dumps(result["line"]))
    return 0


if __name__ == "__main__":
    sys.exit(main())
