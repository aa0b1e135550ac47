"""Refit of the simulator's knobs from run telemetry (PyTorch port of
``flexflow_tpu/apps/calibrate.py``'s ``--from-obs`` path).

    python -m flexflow_tpu_torch.apps.calibrate --from-obs runs/ -o recal.json

reads every obs stream (``*.jsonl``, rotated parts included) under the
directory: the measured per-op times of training runs (``fit``'s
``op_time`` records under ``-op-time-every``), the simulated per-op
times of the strategies they ran (``apps.search -trace``'s
``sim_trace``, ``search_breakdown``) and the step-level ``sim_drift``
gauges.  It refits the two knob families the simulator reads:

  * the per-kind anchors, the median over a kind's ops of measured over
    simulated compute seconds, which
    ``MeasuredCostModel(anchors_path=...)`` loads as ``kind_anchors``
    (an op timed by its analytic stand-in anchors nothing);
  * the slow tier's constants: the measured step less the anchored
    compute, the optimizer stream and the step budget's non-
    communication buckets is what the run paid for communication; its
    ratio to the simulated collective seconds (clamped to 10x either
    way) rescales ``dcn_bandwidth`` and ``dcn_latency`` from the model's
    default ``Topology()``, the keys ``Topology.with_calibration`` reads
    (``apps.search --dcn-calibration``).

The JAX driver's mode without ``--from-obs`` times the real step of each
model through the repository's ``bench.py`` and compares it with the
simulator's; its PyTorch counterpart is the port's benchmark (ROADMAP
Queue A item 1), so here that mode raises ``NotImplementedError``.
"""

from __future__ import annotations

import json
import os
import re
import sys


def _median(values):
    values = sorted(values)
    return values[len(values) // 2] if values else None


def calibrate_from_obs(obs_dir: str, out: str = "", log=print) -> dict:
    """The refit payload from the obs streams under ``obs_dir``
    (``flexflow_tpu/apps/calibrate.py:152``), written to ``out`` when
    given; see the module docstring for what is fitted."""
    from flexflow_tpu_torch.machine import Topology
    from flexflow_tpu_torch.obs import read_events
    from flexflow_tpu_torch.obs.trace import real_op_seconds, sim_op_seconds

    events = []
    names = sorted(fn for fn in os.listdir(obs_dir)
                   if fn.endswith(".jsonl")
                   or re.search(r"\.jsonl\.\d+$", fn))
    for fn in names:
        events.extend(read_events(os.path.join(obs_dir, fn)))
    sim_ops = sim_op_seconds(events)
    real_ops = real_op_seconds(events)
    drifts = [e for e in events if e.get("kind") == "sim_drift"]
    # per-kind anchors against the simulated compute alone: the isolated
    # shard timing sees no in-op collective
    by_kind = {}
    joined = 0
    for op in set(sim_ops) & set(real_ops):
        kind = sim_ops[op].get("op_kind") or real_ops[op].get("op_kind")
        base = sim_ops[op].get("compute_s", sim_ops[op]["seconds"])
        if not real_ops[op].get("measured", True):
            continue   # an analytic stand-in would anchor at exactly 1
        if not kind or not base or base <= 0:
            continue
        joined += 1
        by_kind.setdefault(str(kind), []).append(
            real_ops[op]["seconds"] / base)
    anchors = {k: round(_median(v), 4) for k, v in sorted(by_kind.items())}
    # the slow tier: the measured step less the anchored compute, the
    # optimizer stream and the step budget's non-communication buckets,
    # over the simulated collective seconds
    comm_scale = None
    breakdowns = [e for e in events if e.get("kind") == "search_breakdown"]
    budgets = [e for e in events if e.get("kind") == "step_budget"]
    measured_step = _median([float(d["measured_s"]) for d in drifts
                             if d.get("measured_s")])
    budget_excluded = {}
    if budgets:
        bk = budgets[-1].get("buckets") or {}
        budget_excluded = {
            k: float(bk.get(k, 0.0) or 0.0)
            for k in ("input_stall", "host_sync", "checkpoint")
            if bk.get(k)}
    excluded_s = sum(budget_excluded.values())
    if breakdowns and measured_step:
        bd = breakdowns[-1]
        anchored_compute = sum(
            float(r.get("compute_s", 0.0))
            * anchors.get(str(r.get("kind")), 1.0)
            for r in bd.get("ops", []))
        sim_comm = sum(float(r.get("collective_s", 0.0))
                       for r in bd.get("ops", []))
        opt_s = float(bd.get("opt_stream_s", 0.0))
        residual = measured_step - anchored_compute - opt_s - excluded_s
        if sim_comm > 0 and residual > 0:
            comm_scale = min(max(residual / sim_comm, 0.1), 10.0)
    base_topo = Topology()
    payload = {
        "source": "obs",
        "obs_dir": os.path.abspath(obs_dir),
        "streams": len(names),
        "records": len(events),
        "joined_ops": joined,
        "sim_drift": {"n": len(drifts),
                      "median_ratio": _median(
                          [float(d["value"]) for d in drifts
                           if d.get("value")])},
        "kind_anchors": anchors,
        "collective_scale": round(comm_scale, 4) if comm_scale else None,
        "dcn_bandwidth": base_topo.dcn_bandwidth / (comm_scale or 1.0),
        "dcn_latency": base_topo.dcn_latency * (comm_scale or 1.0),
        "budget_excluded": {k: round(v, 6)
                            for k, v in budget_excluded.items()},
        "budget_excluded_s": round(excluded_s, 6),
    }
    for k, v in anchors.items():
        log(f"anchor {k}: x{v} (n={len(by_kind[k])})")
    if excluded_s:
        log(f"step_budget exclusions: {excluded_s * 1e3:.3f} ms/step "
            f"({', '.join(sorted(budget_excluded))}) kept out of the "
            f"collective residual")
    if comm_scale:
        log(f"collective residual scale: x{comm_scale:.3f} -> "
            f"dcn_bandwidth {payload['dcn_bandwidth']:.3e} B/s")
    elif drifts:
        log("collective constants unchanged (no positive residual or no "
            "search_breakdown in the streams)")
    if not anchors and not drifts:
        log("warning: no op_time/sim_drift records found — run fit() "
            "with -obs-dir and --op-time-every N first")
    if out:
        with open(out, "w") as f:
            json.dump(payload, f, indent=1)
        log(f"written to {out}")
    return payload


def main(argv=None, log=print) -> dict:
    """``--from-obs DIR [-o OUT]``: the refit's payload."""
    from flexflow_tpu_torch.config import flag_stream

    argv = list(sys.argv[1:] if argv is None else argv)
    out = ""
    from_obs = ""
    for a, val in flag_stream(argv):
        if a in ("-o", "--out"):
            out = val()
        elif a == "--from-obs":
            from_obs = val()
    if not from_obs:
        raise NotImplementedError(
            "calibrate without --from-obs times each model's real step "
            "through the JAX package's bench.py; the port's benchmark "
            "(bench_torch.py) is ROADMAP Queue A item 1: pass --from-obs "
            "DIR to refit from the obs records of runs already made")
    return calibrate_from_obs(from_obs, out, log=log)


if __name__ == "__main__":
    main()
