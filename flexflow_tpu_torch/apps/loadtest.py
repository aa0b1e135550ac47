"""Sustained-load serving harness (PyTorch port of
``flexflow_tpu/apps/loadtest.py``), on the card unless ``--device cpu``
is given.

    python -m flexflow_tpu_torch.apps.loadtest --smoke
    python -m flexflow_tpu_torch.apps.loadtest --devices 2,4,8 -o sweep.json
    python -m flexflow_tpu_torch.apps.loadtest --disagg \\
        --chaos replica_crash@3,handoff_drop@5 --baseline disagg.json

Drives the seeded load generator's composable arrival patterns
(``diurnal``/``bursty``/``heavy_tail``, '+'-composed; serve/loadgen.py)
through the continuous-batching engine of the tiny GPT at a sweep of
device counts (``--devices``) and records each point's
p50/p99/TTFT/TPOT/QPS and goodput under the latency SLO.

A sweep point is priced at its width and run on one card.  Every number
is virtual time at a fixed step, so a point's device count acts through
its slots (``--slots-per-device`` times the count) and, under
``--disagg``, its carve alone: the point's engine, or its one-card
replicas, runs in this process on ``--device`` with those slots; each
replica's KV layout (which prices the handoffs) and the decode pool's
step ratio come from a shadow graph of its width
(``apps.serve._tiny_engine``, ``apps.serve.pool_step_ratio``).  So
every field of a point is the JAX harness's at the same width.

Per point the SLO (``obs/slo.py``) is evaluated over its requests, and
one ``loadtest`` and one ``slo`` record are written; after the sweep the
per-request Perfetto trace (``obs/trace.serve_trace_events``) is
exported and validated.  stdout carries one JSON line in the bench
metric shape (``vs_baseline``: the widest point's goodput over the
narrowest's); ``--out`` also writes the ``serve_bench_v1`` artifact.

``--disagg`` carves each point into prefill replicas and a decode pool
behind the router (:func:`_disagg_carve`); ``--chaos SPEC`` (implies
``--disagg``) replays the sweep with a fresh fault injector per point
against the router's resilience stack and asserts ``completed +
unserved + shed + failed == offered`` at every point.  ``--baseline
PATH`` adds the ``vs_r01`` block (a ``--disagg`` sweep against a
single-pool artifact) or the ``vs_r02`` block (a ``--chaos`` sweep
against a fault-free ``--disagg`` artifact); without it there is no
comparison (the JAX harness defaults to its own committed artifacts,
which are its clock, not the port's).
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
        "requests": 60, "rate_qps": 80.0, "pattern": "diurnal+bursty",
        "devices": "2,4,8", "slots_per_device": 2, "seed": 0,
        "prompt_len": 4, "max_new_tokens": 3, "step_time_s": 0.0,
        "slo_target_s": 0.25, "availability": 0.95, "slo_window_s": 2.0,
        "percentile": 99.0, "out": "", "trace": "", "obs_dir": "",
        "run_id": "", "metrics_path": "", "smoke": False,
        "disagg": False, "baseline": "", "chaos": "", "device": "cuda",
    }
    for a, val in flag_stream(list(argv)):
        if a in ("-n", "--requests"):
            opts["requests"] = int(val())
        elif a == "--rate-qps":
            opts["rate_qps"] = float(val())
        elif a == "--pattern":
            opts["pattern"] = val()
        elif a == "--devices":
            opts["devices"] = val()
        elif a == "--slots-per-device":
            opts["slots_per_device"] = int(val())
        elif a == "--seed":
            opts["seed"] = int(val())
        elif a == "--prompt-len":
            opts["prompt_len"] = int(val())
        elif a == "--max-new-tokens":
            opts["max_new_tokens"] = int(val())
        elif a == "--step-time-s":
            opts["step_time_s"] = float(val())
        elif a == "--slo-target-s":
            opts["slo_target_s"] = float(val())
        elif a == "--availability":
            opts["availability"] = float(val())
        elif a == "--slo-window-s":
            opts["slo_window_s"] = float(val())
        elif a == "--percentile":
            opts["percentile"] = float(val())
        elif a in ("-o", "--out"):
            opts["out"] = val()
        elif a == "--trace":
            opts["trace"] = val()
        elif a in ("-obs-dir", "--obs-dir"):
            opts["obs_dir"] = val()
        elif a in ("-run-id", "--run-id"):
            opts["run_id"] = val()
        elif a in ("-metrics-path", "--metrics-path"):
            opts["metrics_path"] = val()
        elif a == "--disagg":
            opts["disagg"] = True
        elif a == "--chaos":
            # a utils/faultinject.py occurrence spec (e.g.
            # "replica_crash@3,handoff_drop@5"), replayed FRESH at
            # every sweep point against the --disagg router with the
            # resilience stack armed; implies --disagg
            opts["chaos"] = val()
            opts["disagg"] = True
        elif a == "--baseline":
            opts["baseline"] = val()
        elif a == "--smoke":
            opts["smoke"] = True
        elif a == "--device":
            opts["device"] = val()
    if opts["smoke"]:
        opts["requests"] = min(opts["requests"], 18)
    return opts


def _round(v, nd=6):
    """Stable rounding for the committed artifact: virtual-time floats
    are bit-deterministic, rounding just keeps the JSON diff-friendly.
    None passes through; non-finite values are preserved (the smoke
    asserts finiteness separately)."""
    if v is None or not isinstance(v, float):
        return v
    return round(v, nd) if math.isfinite(v) else v


def _disagg_carve(devices: int) -> dict:
    """Deterministic prefill/decode split of a ``devices``-wide sweep
    point: half the mesh prefils (two replicas once it is >= 4 devices
    wide), the rest decodes as one pool.  2 -> 1p/1d, 4 -> 2p/2d,
    8 -> 2x2p/4d."""
    prefill_devices = max(1, devices // 2)
    decode_devices = max(1, devices - prefill_devices)
    prefill_replicas = 2 if prefill_devices >= 4 else 1
    return {
        "prefill_devices": prefill_devices,
        "decode_devices": decode_devices,
        "prefill_replicas": prefill_replicas,
        "per_replica_devices": prefill_devices // prefill_replicas,
    }


def _disagg_router(device, devices, opts, olog, metrics, log):
    """The sweep point's disaggregated stack (``flexflow_tpu/apps/
    loadtest.py:153-196``): prefill replicas of ``slots_per_device`` times
    their width in slots at the full step, and one decode replica whose
    step is scaled by the single-token ratio priced at the decode pool's
    width; each replica one card (``device``).  Returns (router, carve,
    decode_step_ratio)."""
    from flexflow_tpu_torch.apps.serve import (_tiny_engine,
                                               pool_step_ratio)
    from flexflow_tpu_torch.serve.engine import DEFAULT_STEP_TIME_S
    from flexflow_tpu_torch.serve.router import AdmissionGate, ServeRouter
    from flexflow_tpu_torch.utils.retry import RetryPolicy

    carve = _disagg_carve(devices)
    base_step = opts["step_time_s"] or DEFAULT_STEP_TIME_S
    pbatch = max(1, opts["slots_per_device"] * carve["per_replica_devices"])
    prefill = [_tiny_engine(device, pbatch, olog, metrics, step=base_step,
                            phase="prefill",
                            width=carve["per_replica_devices"])
               for _ in range(carve["prefill_replicas"])]
    dbatch = max(1, opts["slots_per_device"] * carve["decode_devices"])
    ratio = pool_step_ratio(dbatch, carve["decode_devices"])
    decode = [_tiny_engine(device, dbatch, olog, metrics,
                           step=base_step * ratio, phase="decode",
                           width=carve["decode_devices"])]
    for eng in prefill + decode:
        eng.log = log
    kw = {}
    if opts.get("chaos"):
        # the full resilience stack: bounded seeded retries and the
        # SLO-burn admission gate from the SLO the sweep evaluates
        kw = dict(retry_policy=RetryPolicy(),
                  admission=AdmissionGate(
                      latency_target_s=opts["slo_target_s"],
                      availability=opts["availability"],
                      window_s=opts["slo_window_s"]))
    return (ServeRouter(prefill, decode, olog=olog, metrics=metrics,
                        log=log, **kw), carve, ratio)


def _sweep_point(device, devices, opts, olog, metrics, log) -> dict:
    """One sweep point (``flexflow_tpu/apps/loadtest.py:199-340``): the
    tiny GPT with ``slots_per_device * devices`` slots on one card,
    serving the same seeded patterned stream, then the SLO.  Under
    ``--disagg`` the point is carved into one-card prefill replicas and
    a decode replica behind the router."""
    from flexflow_tpu_torch.apps.serve import _tiny_engine
    from flexflow_tpu_torch.obs.slo import SLOSpec, evaluate, log_record
    from flexflow_tpu_torch.serve.loadgen import patterned_requests

    batch = max(1, opts["slots_per_device"] * devices)
    carve = ratio = None
    if opts["disagg"]:
        router, carve, ratio = _disagg_router(device, devices, opts,
                                              olog, metrics, log)
        seq = int(router.decode[0].model._inputs[0].shape[1])
        vocab = router.decode[0].model.t.vocab_size
    else:
        engine = _tiny_engine(device, batch, olog, metrics,
                              step=opts["step_time_s"] or None,
                              width=devices)
        engine.log = log
        model = engine.model
        seq = int(model._inputs[0].shape[1])
        vocab = model.t.vocab_size
    reqs = patterned_requests(
        opts["requests"], seed=opts["seed"], rate_qps=opts["rate_qps"],
        pattern=opts["pattern"], vocab_size=vocab,
        prompt_len=opts["prompt_len"],
        max_new_tokens=opts["max_new_tokens"],
        max_prompt_len=max(opts["prompt_len"],
                           seq - opts["max_new_tokens"] - 1))
    # unique rids across sweep points so the merged obs stream's
    # per-request trace lanes stay distinct
    for i, r in enumerate(reqs):
        r.rid = devices * 100000 + i
    inj = None
    if opts["disagg"] and opts.get("chaos"):
        # a FRESH injector per sweep point: every point replays the
        # same occurrence-indexed fault schedule, so the whole sweep
        # is bit-reproducible under --seed + --chaos
        from flexflow_tpu_torch.utils.faultinject import (FaultInjector,
                                                          install_scoped)

        inj = FaultInjector(opts["chaos"], olog=olog)
        restore = install_scoped(inj)
        try:
            summary = router.run(reqs)
        finally:
            restore()
    else:
        summary = router.run(reqs) if opts["disagg"] \
            else engine.run(reqs)

    spec = SLOSpec(name=f"p{opts['percentile']:g}-"
                        f"{opts['slo_target_s']:g}s",
                   latency_target_s=opts["slo_target_s"],
                   percentile=opts["percentile"],
                   availability=opts["availability"],
                   window_s=opts["slo_window_s"])
    point_events = [{"kind": "serve_request", "done_v": r.done_v,
                     "latency_s": r.latency_s}
                    for r in reqs if r.done_v is not None]
    slo = evaluate(point_events, spec)
    log_record(olog, dict(slo, devices=devices))

    last_arrival = max(r.arrival_v for r in reqs) if reqs else 0.0
    point = {
        "devices": devices,
        "slots": batch,
        "requests": summary["requests"],
        "completed": summary["completed"],
        "unserved": summary["unserved"],
        "qps": summary["qps"],
        "offered_qps": (len(reqs) / last_arrival)
        if last_arrival > 0 else 0.0,
        "p50_s": summary["p50_s"],
        "p99_s": summary["p99_s"],
        "ttft_p50_s": summary["ttft_p50_s"],
        "ttft_p99_s": summary["ttft_p99_s"],
        "tpot_p50_s": summary["tpot_p50_s"],
        "tpot_p99_s": summary["tpot_p99_s"],
        "goodput_qps": slo["goodput_qps"],
        "slo_burn_rate": slo["burn_rate"],
        "slo_max_window_burn_rate": slo["max_window_burn_rate"],
        "slo_compliant": slo["compliant"],
        "steps": summary["steps"],
        "virtual_s": summary["virtual_s"],
    }
    shape = f"{devices} device(s) x {batch} slots"
    if opts["disagg"]:
        point.update({
            "prefill_devices": carve["prefill_devices"],
            "prefill_replicas": carve["prefill_replicas"],
            "decode_devices": carve["decode_devices"],
            "decode_step_ratio": ratio,
            "handoffs": summary["handoffs"],
            "affinity_hits": summary["affinity_hits"],
            "kv_refetches": summary["kv_refetches"],
        })
        shape = (f"{devices} device(s) "
                 f"[{carve['prefill_replicas']}x"
                 f"{carve['per_replica_devices']}dev prefill + "
                 f"{carve['decode_devices']}dev decode, "
                 f"step ratio {ratio:.3f}]")
    if inj is not None:
        accounted = summary["completed"] + summary["unserved"] \
            + summary["shed"] + summary["failed"]
        point.update({
            "offered": len(reqs),
            "shed": summary["shed"],
            "failed": summary["failed"],
            "retries": summary["retries"],
            "kv_rebuilds": summary["kv_rebuilds"],
            "replica_downs": summary["replica_down"],
            "replicas_live": summary["replicas_live"],
            "faults_fired": inj.fired(),
            "recovery": {k: {kk: _round(vv) for kk, vv in d.items()}
                         for k, d in summary["recovery"].items()},
        })
        assert accounted == summary["requests"] == len(reqs), \
            (f"silent request loss at {devices} device(s): "
             f"{accounted} accounted of {len(reqs)} offered "
             f"({summary})")
        shape += (f" + chaos ({inj.fired()} fault(s): "
                  f"{summary['replica_down']} down, "
                  f"{summary['retries']} retries, "
                  f"{summary['kv_rebuilds']} rebuilds, "
                  f"{summary['shed']} shed, "
                  f"{summary['failed']} failed)")
    olog.event("loadtest", pattern=opts["pattern"],
               rate_qps=opts["rate_qps"], seed=opts["seed"], **point)
    log(f"loadtest: {shape} -> "
        f"qps {point['qps']:.1f}, p50 {point['p50_s'] * 1e3:.0f} ms, "
        f"p99 {point['p99_s'] * 1e3:.0f} ms, ttft p50 "
        f"{point['ttft_p50_s'] * 1e3:.0f} ms, goodput "
        f"{point['goodput_qps']:.1f} qps "
        f"(burn {point['slo_burn_rate']:.2f}x)")
    return point


def _write_trace(opts, olog, log) -> bool:
    """Export + validate the sweep's per-request Perfetto lanes.
    Returns True when the trace validated (and was written)."""
    from flexflow_tpu_torch import obs
    from flexflow_tpu_torch.obs import trace as obstrace

    if not olog.enabled:
        return False
    events = list(obs.read_run(olog.path))
    trace = obstrace.chrome_trace(obstrace.serve_trace_events(events))
    errors = obstrace.validate_trace(trace)
    if errors:
        for e in errors:
            log(f"loadtest trace INVALID: {e}")
        return False
    path = opts["trace"] or os.path.join(
        os.path.dirname(olog.path), "serve.trace.json")
    obstrace.write_trace(path, trace)
    opts["trace"] = path
    log(f"loadtest trace ok: {path} "
        f"({len(trace['traceEvents'])} events)")
    return True


def _vs_baseline_artifact(sweep, path, log):
    """Per-device-count deltas of a ``--disagg`` sweep against a
    single-pool ``serve_bench_v1`` artifact at ``path`` (same seed and
    traffic, so the TTFT-p99 speedup and goodput ratio at each shared
    device count isolate the disaggregation's effect).  Returns None
    (and logs) when the artifact is missing."""
    if not path or not os.path.exists(path):
        log(f"loadtest: baseline artifact {path or '<unset>'} not "
            f"found — vs_r01 omitted")
        return None
    with open(path) as f:
        base = json.load(f)
    by_dev = {int(p["devices"]): p for p in base.get("sweep", [])
              if p.get("devices")}
    points = {}
    for p in sweep:
        b = by_dev.get(int(p["devices"]))
        if b is None:
            continue
        entry = {}
        for k in ("ttft_p99_s", "p99_s", "goodput_qps",
                  "slo_compliant"):
            entry[f"{k}_r01"] = b.get(k)
            entry[f"{k}_r02"] = _round(p.get(k))
        if b.get("ttft_p99_s") and p.get("ttft_p99_s"):
            entry["ttft_p99_speedup"] = _round(
                b["ttft_p99_s"] / p["ttft_p99_s"], 4)
        if b.get("goodput_qps") and p.get("goodput_qps"):
            entry["goodput_ratio"] = _round(
                p["goodput_qps"] / b["goodput_qps"], 4)
        points[str(p["devices"])] = entry
    return {"baseline": os.path.basename(path),
            "baseline_schema": base.get("schema"),
            "points": points}


def _vs_chaos_baseline(sweep, path, log):
    """The bounded-degradation account of a ``--chaos`` sweep against a
    fault-free ``--disagg`` artifact at ``path`` (same seed, traffic and
    carve): at every point the accounting invariant (``completed +
    unserved + shed + failed == offered``: nothing silently lost) and
    how far goodput and p99 degraded from the fault-free run.  Returns
    None (and logs) when the artifact is missing."""
    if not path or not os.path.exists(path):
        log(f"loadtest: chaos baseline artifact {path or '<unset>'} "
            f"not found — vs_r02 omitted")
        return None
    with open(path) as f:
        base = json.load(f)
    by_dev = {int(p["devices"]): p for p in base.get("sweep", [])
              if p.get("devices")}
    points = {}
    for p in sweep:
        accounted = p["completed"] + p["unserved"] + p["shed"] \
            + p["failed"]
        entry = {
            "offered": p["offered"],
            "accounted": accounted,
            "no_silent_loss": accounted == p["offered"],
            "completed": p["completed"],
            "unserved": p["unserved"],
            "shed": p["shed"],
            "failed": p["failed"],
            "retries": p["retries"],
            "kv_rebuilds": p["kv_rebuilds"],
            "replica_downs": p["replica_downs"],
        }
        b = by_dev.get(int(p["devices"]))
        if b is not None:
            for k in ("completed", "goodput_qps", "p99_s",
                      "ttft_p99_s"):
                entry[f"{k}_r02"] = b.get(k)
                entry[f"{k}_r03"] = _round(p.get(k))
            if b.get("goodput_qps") and p.get("goodput_qps"):
                entry["goodput_ratio"] = _round(
                    p["goodput_qps"] / b["goodput_qps"], 4)
            if b.get("p99_s") and p.get("p99_s"):
                entry["p99_ratio"] = _round(p["p99_s"] / b["p99_s"], 4)
        points[str(p["devices"])] = entry
    return {"baseline": os.path.basename(path),
            "baseline_schema": base.get("schema"),
            "points": points}


def run(opts, log=_err) -> dict:
    from flexflow_tpu_torch import obs
    from flexflow_tpu_torch.machine import resolve_device
    from flexflow_tpu_torch.obs.metrics import MetricsExporter

    device = resolve_device(opts["device"])   # raises without CUDA
    sweep_devices = sorted({int(d) for d in
                            str(opts["devices"]).split(",") if d.strip()})
    if not sweep_devices:
        raise SystemExit("loadtest: --devices must name at least one "
                         "device count")
    bad = [d for d in sweep_devices if d < 1]
    if bad:
        raise SystemExit(f"loadtest: device counts {bad} below 1")
    meta = {"app": "serve", "model": "gpt-tiny",
            "requests": opts["requests"], "seed": opts["seed"]}
    olog = obs.NULL
    if opts["obs_dir"]:
        run_id = opts["run_id"] or obs.new_run_id()
        olog = obs.RunLog(os.path.join(opts["obs_dir"], f"{run_id}.jsonl"),
                          run_id=run_id, surface="loadtest",
                          meta=dict(meta, device=str(device)))
    metrics = MetricsExporter(opts["metrics_path"], meta=meta) \
        if opts["metrics_path"] else None
    sweep = [_sweep_point(device, d, opts, olog, metrics, log)
             for d in sweep_devices]
    trace_ok = _write_trace(opts, olog, log)
    olog.close()

    base, top = sweep[0], sweep[-1]
    vs_baseline = (top["goodput_qps"] / base["goodput_qps"]) \
        if base["goodput_qps"] > 0 else None
    kind = "chaos_serve" if opts["chaos"] \
        else ("disagg_serve" if opts["disagg"] else "serve")
    line = {
        "metric": f"gpt_tiny_{kind}_qps_{top['devices']}dev",
        "value": _round(top["qps"], 4),
        "unit": "req/s",
        "vs_baseline": _round(vs_baseline, 4),
        "run_id": olog.run_id if olog.enabled else None,
        "seed": opts["seed"],
        "pattern": opts["pattern"],
        "sweep_points": len(sweep),
        "p50_s": _round(top["p50_s"]),
        "p99_s": _round(top["p99_s"]),
        "ttft_p50_s": _round(top["ttft_p50_s"]),
        "ttft_p99_s": _round(top["ttft_p99_s"]),
        "tpot_p50_s": _round(top["tpot_p50_s"]),
        "burn_rate": _round(top["slo_burn_rate"]),
        "goodput_qps": _round(top["goodput_qps"]),
        "trace_validated": trace_ok,
        "trace": opts["trace"] or None,
    }
    artifact = {
        "schema": "serve_bench_v1",
        "seed": opts["seed"],
        "pattern": opts["pattern"],
        "requests_per_point": opts["requests"],
        "rate_qps": opts["rate_qps"],
        "max_new_tokens": opts["max_new_tokens"],
        "prompt_len": opts["prompt_len"],
        "slots_per_device": opts["slots_per_device"],
        "slo": {"latency_target_s": opts["slo_target_s"],
                "percentile": opts["percentile"],
                "availability": opts["availability"],
                "window_s": opts["slo_window_s"]},
        "parsed": {k: line[k] for k in
                   ("metric", "value", "unit", "vs_baseline")},
        "sweep": [{k: _round(v) for k, v in p.items()} for p in sweep],
    }
    if opts["chaos"]:
        artifact["disagg"] = True
        artifact["chaos"] = opts["chaos"]
        vs_r02 = _vs_chaos_baseline(sweep, opts["baseline"], log) \
            if opts["baseline"] else None
        if vs_r02 is not None:
            artifact["vs_r02"] = vs_r02
            line["vs_r02"] = {d: e.get("goodput_ratio")
                              for d, e in vs_r02["points"].items()}
    elif opts["disagg"]:
        artifact["disagg"] = True
        vs_r01 = _vs_baseline_artifact(sweep, opts["baseline"], log) \
            if opts["baseline"] else None
        if vs_r01 is not None:
            artifact["vs_r01"] = vs_r01
            line["vs_r01"] = {d: e.get("ttft_p99_speedup")
                              for d, e in vs_r01["points"].items()}
    if opts["out"]:
        with open(opts["out"], "w") as f:
            json.dump(artifact, f, indent=1)
            f.write("\n")
        log(f"loadtest artifact: {opts['out']}")
        line["out"] = opts["out"]
    return {"line": line, "artifact": artifact}


def main(argv=None, log=_err) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    opts = parse_args(argv)
    if not opts["obs_dir"]:
        import tempfile

        with tempfile.TemporaryDirectory(prefix="ff-loadtest-") as td:
            opts["obs_dir"] = os.path.join(td, "obs")
            result = run(opts, log)
            print(json.dumps(result["line"]))
            return 0
    result = run(opts, log)
    print(json.dumps(result["line"]))
    return 0


if __name__ == "__main__":
    sys.exit(main())
