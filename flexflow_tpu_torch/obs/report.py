"""Render a run-telemetry JSONL (obs record schema) back into the summary
tables humans read — the reader side of the obs subsystem (PyTorch
port of ``flexflow_tpu/obs/report.py``, which has no JAX in it: the port
writes the JAX package's records, so the same renderer reads both).

``python -m flexflow_tpu_torch.apps.report <run.jsonl>`` is the CLI
wrapper.  Sections are emitted only for the record kinds actually
present, so one renderer serves fit runs, search runs, serving runs and
mixed streams; :func:`summarize` is its machine-readable counterpart.
"""

from __future__ import annotations

from typing import Dict, Iterable, List

_SPARK = "▁▂▃▄▅▆▇█"


def _spark(values: List[float], width: int = 40) -> str:
    """Compact ascii curve of ``values`` (downsampled to ``width``)."""
    if not values:
        return ""
    if len(values) > width:
        step = len(values) / width
        values = [values[int(i * step)] for i in range(width)]
    lo, hi = min(values), max(values)
    if hi <= lo:
        return _SPARK[0] * len(values)
    return "".join(
        _SPARK[min(int((v - lo) / (hi - lo) * (len(_SPARK) - 1)),
                   len(_SPARK) - 1)] for v in values)


def _fmt_s(s: float) -> str:
    return f"{s * 1e3:.3f} ms" if s < 1.0 else f"{s:.3f} s"


def _header(events: List[Dict]) -> List[str]:
    runs = sorted({e.get("run") for e in events if e.get("run")})
    surfaces = sorted({e.get("surface") for e in events
                       if e.get("surface")})
    ts = [e["ts"] for e in events if isinstance(e.get("ts"), (int, float))]
    lines = [f"run: {', '.join(str(r) for r in runs) or '?'}"]
    if surfaces:
        lines.append(f"surfaces: {', '.join(surfaces)}")
    if ts:
        lines.append(f"records: {len(events)}, span: "
                     f"{max(ts) - min(ts):.1f}s")
    for e in events:
        if e.get("kind") == "run_start":
            extras = {k: v for k, v in e.items()
                      if k not in ("run", "ts", "kind", "surface",
                                   "schema")}
            if extras:
                lines.append("meta: " + ", ".join(
                    f"{k}={v}" for k, v in sorted(extras.items())))
    return lines


def _fit_section(events: List[Dict]) -> List[str]:
    steps = [e for e in events if e.get("kind") == "step"]
    compiles = [e for e in events if e.get("kind") == "compile"]
    summaries = [e for e in events if e.get("kind") == "summary"]
    ckpts = [e for e in events
             if e.get("kind") in ("checkpoint_save", "checkpoint_restore")]
    drift = [e for e in events if e.get("kind") == "sim_drift"]
    no_drift = [e for e in events
                if e.get("kind") == "sim_drift_unavailable"]
    op_times = [e for e in events if e.get("kind") == "op_time"]
    if not (steps or compiles or summaries or op_times or drift
            or no_drift):
        return []
    lines = ["== training =="]
    for c in compiles:
        parts = [f"compile: {c.get('seconds', 0.0):.2f}s"]
        if c.get("flops"):
            parts.append(f"{c['flops']:.3e} FLOPs/step")
        if c.get("bytes_accessed"):
            parts.append(f"{c['bytes_accessed']:.3e} bytes/step")
        lines.append("  " + ", ".join(parts))
    if steps:
        walls = [e["wall_ms"] for e in steps if "wall_ms" in e]
        losses = [e["loss"] for e in steps if e.get("loss") is not None]
        lines.append(
            f"  steps: {len(steps)}"
            + (f", wall ms min/mean/max = {min(walls):.2f}/"
               f"{sum(walls) / len(walls):.2f}/{max(walls):.2f}"
               if walls else ""))
        if losses:
            lines.append(f"  loss: first {losses[0]:.4f} -> "
                         f"final {losses[-1]:.4f}   "
                         f"{_spark([float(l) for l in losses])}")
    for s in summaries:
        lines.append(
            f"  summary: {s.get('iterations', '?')} iters, "
            f"elapsed {s.get('elapsed_s', 0.0):.4f}s, "
            f"tp {s.get('images_per_sec', 0.0):.2f} images/s")
    for c in ckpts:
        lines.append(f"  {c['kind']}: step {c.get('step', '?')} "
                     f"({c.get('seconds', 0.0):.3f}s)")
    if op_times:
        sections = [e for e in op_times if e.get("scope") == "section"]
        per_op = [e for e in op_times if e.get("scope") == "op"]
        if sections:
            by_name: Dict[str, List[float]] = {}
            for e in sections:
                by_name.setdefault(str(e.get("section")), []).append(
                    float(e.get("seconds", 0.0)))
            parts = []
            for name in ("forward", "backward", "optimizer", "step"):
                vals = sorted(by_name.get(name, []))
                if vals:
                    parts.append(
                        f"{name} {_fmt_s(vals[len(vals) // 2])}")
            n_steps = len({e.get("step") for e in sections})
            lines.append(f"  op_time sections ({n_steps} sampled steps, "
                         f"median): " + ", ".join(parts))
        if per_op:
            lines.append(f"  op_time per-op (isolated shard, "
                         f"{len(per_op)} records):")
            rows = sorted(per_op, key=lambda e: -e.get("seconds", 0.0))
            for e in rows[:12]:
                mark = "" if e.get("measured") else "~"
                lines.append(
                    f"    {str(e.get('op', '?')):<18s} "
                    f"{str(e.get('op_kind', '?')):<14s} "
                    f"{mark}{_fmt_s(e.get('seconds', 0.0))}")
    for d in drift:
        lines.append(
            f"  sim_drift: predicted {_fmt_s(d.get('predicted_s', 0.0))} "
            f"vs measured {_fmt_s(d.get('measured_s', 0.0))} "
            f"-> ratio {d.get('value', 0.0):.3f} "
            f"[{d.get('source', '?')}]")
    for u in no_drift:
        # say WHY the gauge is missing — a silently absent sim_drift
        # reads as "no drift", which is exactly wrong
        lines.append("  sim_drift unavailable: "
                     f"{u.get('reason') or u.get('error') or '?'}")
    # execution-performance records (round 6)
    for r in (e for e in events if e.get("kind") == "regrid_plan"):
        lines.append(
            f"  regrid plan: {r.get('edges', 0)} edges "
            f"({r.get('noop_edges', 0)} coalesced no-ops, "
            f"{r.get('shared_edges', 0)} fan-out shared), "
            f"constraints {r.get('constraints_before', 0)} -> "
            f"{r.get('constraints_after', 0)}, predicted transfer "
            f"{_fmt_s(r.get('predicted_transfer_s', 0.0))} "
            f"(greedy {_fmt_s(r.get('greedy_transfer_s', 0.0))})")
    for p in (e for e in events if e.get("kind") == "prefetch"):
        lines.append(
            f"  prefetch: depth {p.get('depth', '?')}, "
            f"{p.get('batches', 0)} batches, input stall "
            f"{_fmt_s(p.get('input_stall_s', 0.0))}")
    # step-budget + live-metrics records (MFU waterfall round): one
    # summary line each; the full waterfall is `report budget`
    for b in (e for e in events if e.get("kind") == "step_budget"):
        bk = b.get("buckets") or {}
        wall = b.get("step_wall_s", 0.0) or 0.0
        parts = [f"{k} {_fmt_s(v)}"
                 for k, v in sorted(bk.items(), key=lambda kv: -kv[1])
                 if v > 0]
        lines.append(
            f"  step budget ({_fmt_s(wall)} wall, "
            f"{b.get('n_samples', 0)} samples): "
            + (", ".join(parts) if parts else "(all zero)")
            + "  [render: report budget]")
    mets = [e for e in events if e.get("kind") == "metrics"]
    if mets:
        m = mets[-1]
        parts = []
        if m.get("images_per_sec") is not None:
            parts.append(f"{m['images_per_sec']:.1f} items/s")
        if m.get("mfu") is not None:
            parts.append(f"mfu {m['mfu']:.4f}")
        if m.get("hbm_peak_bytes"):
            parts.append(f"hbm peak {m['hbm_peak_bytes'] / 1e9:.3f} GB")
        lines.append(f"  metrics export ({len(mets)} writes"
                     + (f", {m['path']}" if m.get("path") else "")
                     + "): " + (", ".join(parts) or "(no finite gauges)"))
    return lines


def _elastic_section(events: List[Dict]) -> List[str]:
    """The elastic-runtime records: device-loss detections/probes,
    resizes in BOTH directions (loss detected -> re-search time ->
    regrid bytes/hops -> steps lost; device return -> regrow),
    step hangs, preemption drains, fallbacks/refusals, rejoins, async
    checkpoint commits."""
    losses = [e for e in events if e.get("kind") == "device_loss"]
    probes = [e for e in events if e.get("kind") == "device_probe"]
    resizes = [e for e in events if e.get("kind") == "elastic_resize"]
    returns = [e for e in events if e.get("kind") == "device_return"]
    hangs = [e for e in events if e.get("kind") == "step_hang"]
    drains = [e for e in events if e.get("kind") == "preempt_drain"]
    fallbacks = [e for e in events if e.get("kind") == "elastic_fallback"]
    refused = [e for e in events if e.get("kind") == "elastic_refused"]
    rejoins = [e for e in events if e.get("kind") == "elastic_rejoin"]
    asyncs = [e for e in events if e.get("kind") == "ckpt_async"]
    if not (losses or resizes or returns or hangs or drains or fallbacks
            or refused or rejoins or asyncs):
        return []
    lines = ["== elastic =="]
    for d in losses:
        what = (f"dead ordinals {d['dead']}" if d.get("dead")
                else f"error {d.get('error', '?')!r}")
        lines.append(f"  device_loss[{d.get('classification', '?')}] at "
                     f"step {d.get('step', '?')}: {what} "
                     f"({d.get('live', '?')} live)")
    for h in hangs:
        lines.append(f"  step_hang at step {h.get('step', '?')}: "
                     f"deadline {_fmt_s(h.get('deadline_s', 0.0))} "
                     f"(estimate {_fmt_s(h.get('estimate_s', 0.0))}, "
                     f"factor {h.get('factor', '?')})")
    for r in returns:
        lines.append(f"  device_return at step {r.get('step', '?')}: "
                     f"ordinals {r.get('returned', '?')} back after "
                     f"{r.get('probes', '?')} probe(s)")
    dead_probes = [p for p in probes if p.get("outcome") == "dead"]
    trans_probes = [p for p in probes if p.get("outcome") == "transient"]
    regrow_probes = [p for p in probes
                     if p.get("outcome") in ("answering", "out")]
    if probes:
        lines.append(f"  probes: {len(dead_probes)} dead, "
                     f"{len(trans_probes)} transient recoveries"
                     + (f", {len(regrow_probes)} regrow"
                        if regrow_probes else ""))
    for f in fallbacks:
        lines.append(f"  fallback to checkpoint at step "
                     f"{f.get('step', '?')}: {f.get('reason', '?')}")
    for r in refused:
        lines.append(f"  REFUSED shrink at step {r.get('step', '?')}: "
                     f"{r.get('live', '?')} live < min-devices "
                     f"{r.get('min_devices', '?')}")
    for r in resizes:
        research = r.get("research") or {}
        regrid = ""
        if r.get("regrid_bytes") is not None:
            regrid = (f", regrid {r['regrid_bytes'] / 1e6:.2f} MB / "
                      f"{r.get('regrid_hops', 0)} hops")
        direction = r.get("direction") or (
            "grow" if r.get("to_devices", 0) > r.get("from_devices", 0)
            else "shrink")
        lines.append(
            f"  elastic_resize[{direction}]: "
            f"{r.get('from_devices', '?')} -> "
            f"{r.get('to_devices', '?')} devices at step "
            f"{r.get('step', '?')} (re-search "
            f"{_fmt_s(r.get('research_s', 0.0))} "
            f"[{research.get('mode', '?')}], migration "
            f"{r.get('migration', '?')}{regrid}, "
            f"{r.get('steps_lost', 0)} step(s) lost)")
    for d in drains:
        at = (f"checkpoint at step {d['ckpt_step']}"
              if d.get("ckpt_step") is not None else "no checkpoint")
        lines.append(
            f"  preempt_drain at step {d.get('step', '?')}: "
            f"{d.get('steps_completed', '?')} step(s) completed, {at} "
            f"({_fmt_s(d.get('seconds', 0.0))} of "
            f"{_fmt_s(d.get('budget_s', 0.0))} budget, mode "
            f"{d.get('mode', '?')})")
    for r in rejoins:
        lines.append(f"  rejoin: step {r.get('step', '?')} on "
                     f"{r.get('devices', '?')} devices "
                     f"(from {r.get('dir', '?')})")
    if asyncs:
        commits = sorted(float(a.get("commit_s", 0.0)) for a in asyncs)
        lines.append(
            f"  async checkpoints: {len(asyncs)} commits, median "
            f"submit->commit {_fmt_s(commits[len(commits) // 2])}")
    return lines


def _fault_section(events: List[Dict]) -> List[str]:
    """The fault-tolerance records (robustness round): injected faults,
    guard detections, rollbacks, recoveries, data retries/skips,
    checkpoint fallbacks, leaked worker threads."""
    faults = [e for e in events if e.get("kind") == "fault"]
    rollbacks = [e for e in events if e.get("kind") == "rollback"]
    recoveries = [e for e in events if e.get("kind") == "recovery"]
    data_faults = [e for e in events if e.get("kind") == "data_fault"]
    fallbacks = [e for e in events if e.get("kind") == "ckpt_fallback"]
    leaks = [e for e in events if e.get("kind") == "thread_leak"]
    if not (faults or rollbacks or recoveries or data_faults or fallbacks
            or leaks):
        return []
    lines = ["== faults / recovery =="]
    for f in faults:
        where = ""
        if f.get("step") is not None:
            where = f" at step {f['step']}"
        elif f.get("occurrence") is not None:
            where = f" (occurrence {f['occurrence']})"
        detail = ""
        if f.get("value") is not None:
            detail = f", loss={f['value']}"
        elif f.get("site"):
            detail = f", site={f['site']}"
        lines.append(f"  fault[{f.get('source', '?')}]: "
                     f"{f.get('fault', '?')}{where}{detail}")
    retries = [d for d in data_faults if d.get("action") == "retry"]
    if retries:
        srcs = sorted({str(d.get("source")) for d in retries})
        lines.append(f"  data retries: {len(retries)} "
                     f"({', '.join(srcs)})")
    for d in data_faults:
        if d.get("action") == "skip":
            lines.append(
                f"  data skip[{d.get('source', '?')}]: "
                f"{d.get('file') or 'batch range'} "
                f"(skip #{d.get('skips', '?')}: {d.get('error', '?')})")
    for c in fallbacks:
        skipped = c.get("skipped") or []
        why = "; ".join(f"step {s.get('step')}: {s.get('reason')}"
                        for s in skipped if isinstance(s, dict))
        lines.append(f"  ckpt_fallback: step {c.get('from_step', '?')} -> "
                     f"{c.get('to_step', '?')}" + (f" ({why})" if why
                                                   else ""))
    for r in rollbacks:
        lines.append(f"  rollback: iteration {r.get('from_step', '?')} -> "
                     f"checkpoint step {r.get('to_step', '?')}")
    for r in recoveries:
        after = r.get("after", "?")
        spot = (f"step {r['step']}" if r.get("step") is not None
                else f"{r.get('failures', '?')} failures")
        lines.append(f"  recovery[{r.get('source', '?')}]: after {after} "
                     f"({spot})")
    for l in leaks:
        lines.append(f"  thread leak: {l.get('source', '?')} (join timed "
                     f"out after {l.get('timeout_s', '?')}s)")
    return lines


def _search_section(events: List[Dict]) -> List[str]:
    space = [e for e in events if e.get("kind") == "search_space"]
    gates = [e for e in events if e.get("kind") == "plan_gate"]
    chunks = [e for e in events if e.get("kind") == "search_chunk"]
    blocks = [e for e in events if e.get("kind") == "search_block"]
    stitches = [e for e in events if e.get("kind") == "search_stitch"]
    results = [e for e in events if e.get("kind") == "search_result"]
    breakdown = [e for e in events if e.get("kind") == "search_breakdown"]
    pipes = [e for e in events if e.get("kind") == "pipeline_decision"]
    if not (space or gates or chunks or blocks or stitches or results):
        return []
    lines = ["== strategy search =="]
    for s in space:
        lines.append(
            f"  space: {s.get('ops', '?')} ops, "
            f"{s.get('candidates', '?')} candidates "
            f"({s.get('axis_options_pruned', 0)} axis options pruned, "
            f"{s.get('mem_rejected', 0)} HBM-rejected)")
    for g in gates:
        by = g.get("by_code") or {}
        lines.append(
            f"  plan gate: {g.get('checked', '?')} candidate grids "
            f"checked, {g.get('rejected', 0)} rejected pre-sim"
            + (f" ({', '.join(f'{k}={v}' for k, v in sorted(by.items()))})"
               if by else ""))
    if chunks:
        curve = [c["best_time_s"] for c in chunks if "best_time_s" in c]
        acc = sum(c.get("accepted", 0) for c in chunks)
        prop = sum(c.get("proposed", 0) for c in chunks)
        pps = [c["proposals_per_sec"] for c in chunks
               if c.get("proposals_per_sec")]
        if curve:
            lines.append(
                f"  best-cost curve ({len(curve)} chunks): "
                f"{_fmt_s(curve[0])} -> {_fmt_s(curve[-1])}   "
                f"{_spark(curve)}")
        lines.append(
            f"  acceptance: {acc}/{prop} "
            f"({100.0 * acc / prop if prop else 0.0:.1f}%)"
            + (f", {sum(pps) / len(pps):,.0f} proposals/s" if pps else ""))
    if blocks:
        searched = [b for b in blocks if not b.get("memo")]
        memoed = [b for b in blocks if b.get("memo")]
        lines.append(
            f"  blocks: {len(blocks)} ({len(searched)} searched, "
            f"{len(memoed)} memo replays)")
        for b in searched[:12]:
            reps = b.get("repeats", 1)
            lines.append(
                f"    {str(b.get('block', '?')):<14s} "
                f"{b.get('ops', '?'):>3} ops"
                + (f" x{reps:<3d}" if reps and reps > 1 else "     ")
                + f" {b.get('accepted', 0)}/{b.get('proposed', 0)} "
                f"accepted -> {_fmt_s(b.get('best_time_s') or 0.0)}")
        if len(searched) > 12:
            lines.append(f"    ... {len(searched) - 12} more searched "
                         f"block(s)")
    for st in stitches:
        lines.append(
            f"  stitch: {st.get('blocks', '?')} blocks "
            f"({st.get('unique_blocks', '?')} unique, "
            f"{st.get('memo_hits', 0)} memo hits) -> "
            f"{_fmt_s(st.get('stitched_time_s', 0.0))}, "
            f"{st.get('boundary_ops', 0)} boundary ops "
            f"(regrid {_fmt_s(st.get('boundary_regrid_s', 0.0))}), "
            f"refine {st.get('refined_proposed', 0)}/"
            f"{st.get('refine_iters', 0)} -> "
            f"{_fmt_s(st.get('best_time_s', 0.0))}"
            + (" [budget hit]" if st.get("budget_hit") else ""))
    for r in results:
        lines.append(
            f"  result: dp {_fmt_s(r.get('dp_time_s', 0.0))}, "
            f"best {_fmt_s(r.get('best_time_s', 0.0))} "
            f"({r.get('speedup_vs_dp', 0.0):.3f}x vs DP)")
        cache = r.get("cost_cache")
        if cache:
            tot = cache.get("hits", 0) + cache.get("misses", 0)
            lines.append(
                f"  cost cache: {cache.get('hits', 0)}/{tot} hits "
                f"({100.0 * cache.get('hits', 0) / tot if tot else 0.0:.1f}%)")
    for b in breakdown:
        ops = sorted(b.get("ops", []),
                     key=lambda o: -(o.get("compute_s", 0.0)
                                     + o.get("collective_s", 0.0)))
        lines.append(f"  winning strategy, per-op cost "
                     f"(top {min(len(ops), 12)} of {len(ops)}):")
        lines.append(f"    {'op':<18s} {'kind':<14s} {'grid':<14s} "
                     f"{'compute':>10s} {'collective':>10s}")
        for o in ops[:12]:
            lines.append(
                f"    {str(o.get('op', '?')):<18s} "
                f"{str(o.get('kind', '?')):<14s} "
                f"{str(tuple(o.get('dims', ()))):<14s} "
                f"{_fmt_s(o.get('compute_s', 0.0)):>10s} "
                f"{_fmt_s(o.get('collective_s', 0.0)):>10s}")
        if b.get("opt_stream_s"):
            lines.append(f"    optimizer param stream: "
                         f"{_fmt_s(b['opt_stream_s'])}")
    for p in pipes:
        lines.append(
            f"  pipeline: {'ACCEPT' if p.get('accepted') else 'REJECT'}"
            + (f" S={p['best'].get('stages')} "
               f"M={p['best'].get('microbatches')} "
               f"tp={p['best'].get('tp')}" if p.get("best") else "")
            + f" (ref {_fmt_s(p.get('reference_time_s', 0.0))})")
    return lines


def _latency_histogram(lat: List[float], buckets: int = 10) -> List[str]:
    """Fixed-width latency histogram lines: one row per bucket with its
    bound, count, and a proportional bar — the ``report serve``
    rendering of the smoke's obs stream."""
    if not lat:
        return []
    lo, hi = min(lat), max(lat)
    span = (hi - lo) or max(hi, 1e-9)
    counts = [0] * buckets
    for v in lat:
        counts[min(int((v - lo) / span * buckets), buckets - 1)] += 1
    peak = max(counts)
    lines = []
    for i, c in enumerate(counts):
        hi_edge = lo + span * (i + 1) / buckets
        bar = "█" * int(round(24 * c / peak)) if peak else ""
        lines.append(f"    <= {_fmt_s(hi_edge):>10s}  {c:>5d}  {bar}")
    return lines


def _serve_section(events: List[Dict]) -> List[str]:
    """The serving-runtime records: per-request latencies (histogram +
    percentiles), batch occupancy, autoscale resizes, the run summary."""
    reqs = [e for e in events if e.get("kind") == "serve_request"]
    batches = [e for e in events if e.get("kind") == "serve_batch"]
    resizes = [e for e in events if e.get("kind") == "serve_resize"]
    summaries = [e for e in events if e.get("kind") == "serve_summary"]
    handoffs = [e for e in events if e.get("kind") == "serve_handoff"]
    refetches = [e for e in events if e.get("kind") == "kv_refetch"]
    routers = [e for e in events if e.get("kind") == "router_summary"]
    retries = [e for e in events if e.get("kind") == "serve_retry"]
    faults = [e for e in events if e.get("kind") == "serve_fault"]
    rebuilds = [e for e in events if e.get("kind") == "kv_rebuild"]
    sheds = [e for e in events if e.get("kind") == "serve_shed"]
    downs = [e for e in events if e.get("kind") == "replica_down"]
    if not (reqs or batches or resizes or summaries or handoffs
            or refetches or routers or retries or faults or rebuilds
            or sheds or downs):
        return []
    lines = ["== serving =="]
    lat = sorted(float(e["latency_s"]) for e in reqs
                 if e.get("latency_s") is not None)
    if lat:
        def pct(q):
            return lat[min(int(q / 100.0 * len(lat)), len(lat) - 1)]
        lines.append(
            f"  requests: {len(reqs)} completed, latency p50 "
            f"{_fmt_s(pct(50))} / p90 {_fmt_s(pct(90))} / p99 "
            f"{_fmt_s(pct(99))} (min {_fmt_s(lat[0])}, max "
            f"{_fmt_s(lat[-1])})")
        ttft = sorted(float(e["ttft_s"]) for e in reqs
                      if e.get("ttft_s") is not None)
        tpot = sorted(float(e["tpot_s"]) for e in reqs
                      if e.get("tpot_s") is not None)
        if ttft:
            def tpct(vals, q):
                return vals[min(int(q / 100.0 * len(vals)),
                                len(vals) - 1)]
            line = (f"  ttft: p50 {_fmt_s(tpct(ttft, 50))} / p99 "
                    f"{_fmt_s(tpct(ttft, 99))}")
            if tpot:
                line += (f", tpot: p50 {_fmt_s(tpct(tpot, 50))} / p99 "
                         f"{_fmt_s(tpct(tpot, 99))}")
            lines.append(line)
        lines.append("  latency histogram (virtual seconds):")
        lines.extend(_latency_histogram(lat))
    if batches:
        occ = [float(b.get("active", 0)) for b in batches]
        admitted = sum(int(b.get("admitted", 0)) for b in batches)
        lines.append(
            f"  batches: {len(batches)} steps, {admitted} admissions, "
            f"occupancy mean {sum(occ) / len(occ):.1f} / max "
            f"{max(occ):.0f}   {_spark(occ)}")
        # disaggregated runs label each serve_batch with its pool —
        # break the stream down per pool (queue depth, slot occupancy,
        # step time), the per-pool view the router's split exists for
        pools = sorted({b.get("pool") for b in batches if b.get("pool")})
        for pool in pools:
            pb = [b for b in batches if b.get("pool") == pool]
            pocc = [float(b.get("active", 0)) for b in pb]
            pq = [float(b.get("queue_depth", 0)) for b in pb]
            pst = [float(b["step_time_s"]) for b in pb
                   if b.get("step_time_s") is not None]
            step_part = f", step {_fmt_s(pst[0])}" if pst else ""
            lines.append(
                f"  pool[{pool}]: {len(pb)} steps, occupancy mean "
                f"{sum(pocc) / len(pocc):.1f} / max {max(pocc):.0f}, "
                f"queue depth mean {sum(pq) / len(pq):.1f} / max "
                f"{max(pq):.0f}{step_part}   {_spark(pocc)}")
    if handoffs:
        hb = sum(float(h.get("bytes", 0.0)) for h in handoffs)
        hs = [float(h.get("predicted_s", 0.0)) for h in handoffs]
        lines.append(
            f"  handoffs: {len(handoffs)} prefill->decode "
            f"({hb / 1e6:.2f} MB KV moved, mean "
            f"{_fmt_s(sum(hs) / len(hs))}/handoff), "
            f"{len(refetches)} kv_refetch(es)")
    elif refetches:
        lines.append(f"  kv_refetches: {len(refetches)}")
    for d in downs:
        lines.append(
            f"  replica_down[{d.get('pool', '?')}"
            f"[{d.get('replica', '?')}]] at v="
            f"{_fmt_s(d.get('vnow') or 0.0)}: "
            f"{d.get('in_flight', 0)} in-flight re-prefill, "
            f"{d.get('queued', 0)} queued retransmit, restart "
            f"{_fmt_s(d.get('restart_s') or 0.0)}")
    if retries or rebuilds or faults:
        by_reason: Dict[str, int] = {}
        for r in retries:
            reason = str(r.get("reason", "?"))
            by_reason[reason] = by_reason.get(reason, 0) + 1
        reason_part = ", ".join(f"{k} x{v}"
                                for k, v in sorted(by_reason.items()))
        lines.append(
            f"  resilience: {len(retries)} serve_retry "
            f"({reason_part or 'none'}), {len(rebuilds)} kv_rebuild "
            f"(re-prefilled sessions), {len(faults)} serve_fault "
            f"(retry budget exhausted)")
    if sheds:
        burns = [float(s.get("burn_rate", 0.0)) for s in sheds]
        lines.append(
            f"  shed: {len(sheds)} arrival(s) refused by the SLO-burn "
            f"admission gate (burn {min(burns):.2f}x..{max(burns):.2f}x"
            f" over threshold) — explicit serve_shed, not drops")
    for r in routers:
        pools = r.get("pools") or {}
        pool_part = ", ".join(
            f"{k}: {v.get('replicas', '?')}x{v.get('devices', 0) // max(v.get('replicas', 1), 1)}dev"
            for k, v in sorted(pools.items()))
        resil_part = ""
        if any(r.get(k) for k in ("retries", "kv_rebuilds",
                                  "replica_down", "shed", "failed")):
            resil_part = (
                f", {r.get('replica_down', 0)} replica(s) down, "
                f"{r.get('retries', 0)} retry(ies), "
                f"{r.get('kv_rebuilds', 0)} rebuild(s), "
                f"{r.get('shed', 0)} shed, "
                f"{r.get('failed', 0)} failed")
        lines.append(
            f"  router: {r.get('completed', 0)}/{r.get('requests', 0)} "
            f"served across {pool_part or '?'}, "
            f"{r.get('handoffs', 0)} handoff(s), "
            f"{r.get('affinity_hits', 0)} affinity hit(s), "
            f"{r.get('kv_refetches', 0)} refetch(es)" + resil_part
            + (", drained" if r.get("drained") else ""))
    for r in resizes:
        research = r.get("research") or {}
        lines.append(
            f"  serve_resize[{r.get('direction', '?')}]: "
            f"{r.get('from_devices', '?')} -> {r.get('to_devices', '?')} "
            f"devices at step {r.get('step', '?')} (queue depth "
            f"{r.get('queue_depth', '?')}, idle streak "
            f"{r.get('idle_streak', '?')}, re-search "
            f"{_fmt_s(r.get('research_s', 0.0))} "
            f"[{research.get('mode', '?')}])")
    for s in summaries:
        ttft_part = ""
        if s.get("ttft_p50_s") is not None:
            ttft_part = (f", ttft p50 {_fmt_s(s.get('ttft_p50_s', 0.0))}"
                         f", tpot p50 {_fmt_s(s.get('tpot_p50_s') or 0.0)}")
        lines.append(
            f"  summary: {s.get('completed', 0)}/{s.get('requests', 0)} "
            f"served ({s.get('unserved', 0)} unserved, "
            f"{s.get('dropped', 0)} dropped), qps "
            f"{s.get('qps', 0.0):.1f}, p50 {_fmt_s(s.get('p50_s', 0.0))},"
            f" p99 {_fmt_s(s.get('p99_s', 0.0))}{ttft_part}, "
            f"{s.get('resizes', 0)} resize(s), "
            f"{s.get('devices', '?')} devices"
            + (", drained" if s.get("drained") else ""))
    return lines


def _slo_section(events: List[Dict]) -> List[str]:
    """The SLO / load-harness records: per-spec burn-rate verdicts
    (``slo``) and sustained-load sweep points (``loadtest``)."""
    slos = [e for e in events if e.get("kind") == "slo"]
    points = [e for e in events if e.get("kind") == "loadtest"]
    if not (slos or points):
        return []
    lines = ["== slo / loadtest =="]
    for s in slos:
        spec = s.get("spec") or {}
        ach = s.get("achieved_percentile_s")
        lines.append(
            f"  slo[{spec.get('name', '?')}]: p{spec.get('percentile')} "
            f"<= {_fmt_s(spec.get('latency_target_s') or 0.0)} @ "
            f"{spec.get('availability')} -> "
            f"{'COMPLIANT' if s.get('compliant') else 'VIOLATED'} "
            f"(achieved {_fmt_s(ach) if ach is not None else '?'}, "
            f"burn {s.get('burn_rate', 0.0):.2f}x, worst window "
            f"{s.get('max_window_burn_rate', 0.0):.2f}x over "
            f"{s.get('windows', 0)} window(s), goodput "
            f"{s.get('goodput_qps', 0.0):.1f} qps)")
    for p in points:
        lines.append(
            f"  loadtest[{p.get('pattern', '?')}] {p.get('devices', '?')}"
            f" device(s): {p.get('completed', '?')}/"
            f"{p.get('requests', '?')} served, qps "
            f"{p.get('qps', 0.0):.1f} (offered "
            f"{p.get('offered_qps', 0.0):.1f}), p50 "
            f"{_fmt_s(p.get('p50_s') or 0.0)}, p99 "
            f"{_fmt_s(p.get('p99_s') or 0.0)}, ttft p50 "
            f"{_fmt_s(p.get('ttft_p50_s') or 0.0)}, goodput "
            f"{p.get('goodput_qps', 0.0):.1f} qps")
    return lines


def _audit_bench_section(events: List[Dict]) -> List[str]:
    audits = [e for e in events if e.get("kind") == "hlo_audit"]
    benches = [e for e in events if e.get("kind") == "bench"]
    if not (audits or benches):
        return []
    lines = ["== audit / bench =="]
    for a in audits:
        lines.append(
            f"  hlo_audit[{a.get('plan', '?')}]: "
            f"searched {a.get('searched_cross_mb', '?')} MB cross-tier "
            f"vs DP {a.get('dp_cross_mb', '?')} MB -> "
            f"{'CONSISTENT' if a.get('consistent') else 'CONTRADICTED'}")
    for b in benches:
        extras = ""
        if b.get("mfu") is not None:
            extras += f", mfu {b['mfu']}"
        if b.get("mfu_ceiling") is not None:
            extras += f" (ceiling {b['mfu_ceiling']})"
        if b.get("hbm_peak_gb") is not None:
            extras += f", hbm {b['hbm_peak_gb']} GB"
        shares = ", ".join(f"{k[:-5]} {100.0 * b[k]:.1f}%"
                           for k in ("comm_frac", "stall_frac")
                           if isinstance(b.get(k), (int, float)))
        if shares:
            extras += f", shares: {shares}"
        lines.append(
            f"  bench: {b.get('metric', '?')} = {b.get('value', '?')} "
            f"{b.get('unit', '')} (vs_baseline {b.get('vs_baseline', '?')}"
            + extras + ")")
    return lines


def _lint_section(events: List[Dict]) -> List[str]:
    lints = [e for e in events if e.get("kind") == "lint"]
    if not lints:
        return []
    lines = ["== lint =="]
    for rec in lints:
        lines.append(
            f"  verifier[{rec.get('model', '?')}]: "
            f"{rec.get('error', 0)} error(s), "
            f"{rec.get('warning', 0)} warning(s), "
            f"{rec.get('exempted', 0)} exempted")
        for f in rec.get("findings", []) or []:
            lines.append(f"    {f.get('severity')} "
                         f"[{f.get('pass_name')}:{f.get('code')}] "
                         f"{f.get('message')}")
        pred = rec.get("predicted")
        if pred:
            lines.append(
                f"    predicted: searched {pred.get('searched_pred_s')} s"
                f" vs dp {pred.get('dp_pred_s')} s "
                f"({pred.get('mode')}) -> "
                f"{'CONSISTENT' if pred.get('consistent') else 'CONTRADICTED'}")
    return lines


def _trace_section(events: List[Dict]) -> List[str]:
    traces = [e for e in events if e.get("kind") == "sim_trace"]
    if not traces:
        return []
    lines = ["== traces =="]
    for t in traces:
        lines.append(
            f"  sim trace: {t.get('path', '?')} "
            f"(best {_fmt_s(t.get('total_s', 0.0))} vs dp "
            f"{_fmt_s(t.get('dp_total_s', 0.0))}; open in "
            f"ui.perfetto.dev)")
    return lines


def _fleet_section(events: List[Dict]) -> List[str]:
    """The coordinator's view: per-job lifecycle trails, wait
    decompositions (``fleet_wait``), each arbiter packing, each
    executed rebalance, the device-second utilization account
    (``fleet_util``), fleet-simulation sweep points (``fleetsim``),
    and the final fleet summary.  Renders merged multi-job streams
    (coordinator + per-job subdirs) as readily as the coordinator's
    stream alone."""
    jobs = [e for e in events if e.get("kind") == "fleet_job"]
    placements = [e for e in events
                  if e.get("kind") == "fleet_placement"]
    rebalances = [e for e in events
                  if e.get("kind") == "fleet_rebalance"]
    summaries = [e for e in events if e.get("kind") == "fleet_summary"]
    waits = [e for e in events if e.get("kind") == "fleet_wait"]
    utils = [e for e in events if e.get("kind") == "fleet_util"]
    sims = [e for e in events if e.get("kind") == "fleetsim"]
    if not (jobs or placements or rebalances or summaries or waits
            or utils or sims):
        return []
    lines = ["== fleet =="]
    trail: Dict[str, List[str]] = {}
    workload: Dict[str, str] = {}
    for e in jobs:
        jid = str(e.get("job"))
        if e.get("workload"):
            workload[jid] = str(e["workload"])
        states = trail.setdefault(jid, [])
        st = str(e.get("state"))
        if not states or states[-1] != st:
            states.append(st)
    for jid in sorted(trail):
        wl = f" ({workload[jid]})" if jid in workload else ""
        lines.append(f"  job {jid}{wl}: " + " -> ".join(trail[jid]))
    for p in placements:
        lines.append(f"  placement #{p.get('pack', '?')}: "
                     f"sizes {p.get('sizes')} (demands "
                     f"{p.get('demands')}, pool {p.get('pool')})")
    for r in rebalances:
        moves = ", ".join(
            f"{m.get('job')} {len(m.get('from') or [])}->"
            f"{len(m.get('to') or [])}" for m in r.get("moves") or [])
        lines.append(f"  rebalance #{r.get('rebalance', '?')}: {moves}")
    for w in waits:
        lines.append(
            f"  wait {w.get('job', '?')}: "
            f"wait {_fmt_s(w.get('wait_s') or 0.0)} + place "
            f"{_fmt_s(w.get('placement_s') or 0.0)} + run "
            f"{_fmt_s(w.get('run_s') or 0.0)} + drain "
            f"{_fmt_s(w.get('drain_s') or 0.0)} + resize "
            f"{_fmt_s(w.get('resize_s') or 0.0)} = "
            f"{_fmt_s(w.get('total_s') or 0.0)} ({w.get('state', '?')})")
    if utils:
        busy = sum(int(u.get("busy_steps") or 0) for u in utils)
        idle = sum(int(u.get("idle_steps") or 0) for u in utils)
        rsz = sum(int(u.get("resizing_steps") or 0) for u in utils)
        cap = busy + idle + rsz
        lines.append(
            f"  util: {len(utils)} round(s), {busy} busy + {idle} idle "
            f"+ {rsz} resizing device-step(s)"
            + (f" -> {100.0 * busy / cap:.1f}% busy" if cap else ""))
    for p in sims:
        slo = p.get("slo_compliant")
        lines.append(
            f"  fleetsim[pool {p.get('pool', '?')}]: "
            f"{p.get('jobs_done', '?')}/{p.get('jobs', '?')} job(s) "
            f"done, util {100.0 * (p.get('util') or 0.0):.1f}%, wait "
            f"p50 {_fmt_s(p.get('wait_p50_s') or 0.0)} p99 "
            f"{_fmt_s(p.get('wait_p99_s') or 0.0)}, "
            f"{p.get('rebalances', 0)} rebalance(s), churn "
            f"{p.get('churn_devices', 0)} device(s), wait-slo "
            + ("?" if slo is None
               else ("COMPLIANT" if slo else "VIOLATED")))
    if summaries:
        s = summaries[-1]
        lines.append(
            f"  summary: {len(s.get('jobs') or [])} job(s) "
            f"{s.get('by_state')}, {s.get('rebalances', 0)} "
            f"rebalance(s), {s.get('packs', 0)} packing(s), "
            f"{s.get('native_prices', 0)} native + "
            f"{s.get('proxy_prices', 0)} proxy price(s), pool "
            f"{s.get('pool_devices')}")
    return lines


def _misc_section(events: List[Dict]) -> List[str]:
    known = {"run_start", "compile", "step", "summary", "checkpoint_save",
             "checkpoint_restore", "sim_drift", "sim_drift_unavailable",
             "op_time", "sim_trace", "search_space", "plan_gate",
             "search_chunk", "search_result", "search_breakdown",
             "pipeline_candidate", "pipeline_decision", "hlo_audit",
             "bench", "regrid_plan", "prefetch",
             "step_budget", "metrics",
             "fault", "rollback", "recovery", "data_fault",
             "ckpt_fallback", "thread_leak",
             "device_loss", "device_probe", "elastic_resize",
             "elastic_fallback", "elastic_refused", "elastic_rejoin",
             "device_return", "step_hang", "preempt_drain",
             "ckpt_async", "lint",
             "serve_request", "serve_batch", "serve_resize",
             "serve_summary", "serve_handoff", "kv_refetch",
             "router_summary", "serve_fault", "serve_retry",
             "kv_rebuild", "serve_shed", "replica_down",
             "fleet_job", "fleet_placement", "fleet_rebalance",
             "fleet_summary", "fleet_wait", "fleet_util", "fleetsim"}
    lines = []
    for e in events:
        kind = e.get("kind")
        if kind in known:
            continue
        if kind == "counter":
            lines.append(f"  counter {e.get('name')}: {e.get('value')}")
        elif kind == "gauge":
            lines.append(f"  gauge {e.get('name')}: {e.get('value')}")
        elif kind == "timer":
            lines.append(f"  timer {e.get('name')}: "
                         f"{_fmt_s(e.get('seconds', 0.0))}")
        else:
            body = {k: v for k, v in e.items()
                    if k not in ("run", "ts", "surface")}
            lines.append(f"  {body}")
    return (["== other records =="] + lines) if lines else []


def render(events: Iterable[Dict]) -> str:
    """One human-readable report of a run's event stream."""
    events = list(events)
    if not events:
        return "(empty run log)"
    sections = [_header(events), _fit_section(events),
                _fault_section(events), _elastic_section(events),
                _serve_section(events), _slo_section(events),
                _fleet_section(events),
                _search_section(events),
                _audit_bench_section(events), _lint_section(events),
                _trace_section(events), _misc_section(events)]
    return "\n".join("\n".join(s) for s in sections if s)


def render_file(path: str) -> str:
    from flexflow_tpu_torch.obs import read_events

    return render(read_events(path))


def _median(values: List[float]) -> float:
    values = sorted(values)
    return values[len(values) // 2] if values else 0.0


def summarize(events: Iterable[Dict]) -> Dict:
    """The machine-readable counterpart of :func:`render` (the report
    CLI's ``--json`` output): one JSON-serializable object per stream so
    CI and bench tooling consume fields instead of scraping prose.  Only
    sections whose record kinds are present appear."""
    events = list(events)
    kinds: Dict[str, int] = {}
    for e in events:
        kinds[str(e.get("kind"))] = kinds.get(str(e.get("kind")), 0) + 1
    out: Dict = {
        "runs": sorted({str(e["run"]) for e in events if e.get("run")}),
        "surfaces": sorted({e["surface"] for e in events
                            if e.get("surface")}),
        "records": len(events),
        "kinds": kinds,
    }
    meta = {}
    for e in events:
        if e.get("kind") == "run_start":
            meta.update({k: v for k, v in e.items()
                         if k not in ("run", "ts", "kind", "surface",
                                      "schema")})
    if meta:
        out["meta"] = meta
    steps = [e for e in events if e.get("kind") == "step"]
    summaries = [e for e in events if e.get("kind") == "summary"]
    compiles = [e for e in events if e.get("kind") == "compile"]
    if steps or summaries or compiles:
        walls = [e["wall_ms"] for e in steps if "wall_ms" in e]
        losses = [e["loss"] for e in steps if e.get("loss") is not None]
        tr: Dict = {"steps": len(steps)}
        if compiles:
            tr["compile_s"] = compiles[0].get("seconds", 0.0)
            if compiles[0].get("flops"):
                tr["flops_per_step"] = compiles[0]["flops"]
        if walls:
            tr["wall_ms"] = {"min": min(walls),
                             "mean": sum(walls) / len(walls),
                             "max": max(walls)}
        if losses:
            tr["loss"] = {"first": float(losses[0]),
                          "final": float(losses[-1])}
        if summaries:
            s = summaries[-1]
            tr["elapsed_s"] = s.get("elapsed_s", 0.0)
            tr["images_per_sec"] = s.get("images_per_sec", 0.0)
        out["training"] = tr
    drift = [e for e in events if e.get("kind") == "sim_drift"]
    if drift:
        d = drift[-1]
        out["sim_drift"] = {"value": d.get("value"),
                            "predicted_s": d.get("predicted_s"),
                            "measured_s": d.get("measured_s"),
                            "source": d.get("source"),
                            "n": len(drift)}
    no_drift = [e for e in events
                if e.get("kind") == "sim_drift_unavailable"]
    if no_drift:
        out["sim_drift_unavailable"] = [
            e.get("reason") or e.get("error") or "?" for e in no_drift]
    op_times = [e for e in events if e.get("kind") == "op_time"]
    if op_times:
        sections = [e for e in op_times if e.get("scope") == "section"]
        per_op = [e for e in op_times if e.get("scope") == "op"]
        ot: Dict = {}
        if sections:
            by_name: Dict[str, List[float]] = {}
            for e in sections:
                by_name.setdefault(str(e.get("section")), []).append(
                    float(e.get("seconds", 0.0)))
            ot["sections_median_s"] = {k: _median(v)
                                       for k, v in by_name.items()}
            ot["sampled_steps"] = len({e.get("step") for e in sections})
        if per_op:
            ot["ops"] = {str(e.get("op")): {
                "seconds": e.get("seconds"),
                "op_kind": e.get("op_kind"),
                "measured": e.get("measured")} for e in per_op}
        out["op_time"] = ot
    space = [e for e in events if e.get("kind") == "search_space"]
    gates = [e for e in events if e.get("kind") == "plan_gate"]
    chunks = [e for e in events if e.get("kind") == "search_chunk"]
    blocks = [e for e in events if e.get("kind") == "search_block"]
    stitches = [e for e in events if e.get("kind") == "search_stitch"]
    results = [e for e in events if e.get("kind") == "search_result"]
    if space or gates or chunks or blocks or stitches or results:
        se: Dict = {}
        if space:
            se["space"] = {k: space[-1].get(k) for k in
                           ("ops", "candidates", "axis_options_pruned",
                            "mem_rejected", "devices", "cost_model")}
        if gates:
            se["plan_gate"] = {k: gates[-1].get(k) for k in
                               ("checked", "rejected", "mem_rejected",
                                "by_code")}
        if chunks:
            curve = [c["best_time_s"] for c in chunks
                     if "best_time_s" in c]
            acc = sum(c.get("accepted", 0) for c in chunks)
            prop = sum(c.get("proposed", 0) for c in chunks)
            se["chunks"] = len(chunks)
            if curve:
                se["best_time_s"] = {"first": curve[0], "last": curve[-1]}
            se["accept_rate"] = acc / prop if prop else 0.0
        if blocks:
            searched = [b for b in blocks if not b.get("memo")]
            se["blocks"] = {
                "total": len(blocks),
                "searched": len(searched),
                "memo_replays": len(blocks) - len(searched),
                "proposed": sum(b.get("proposed", 0) for b in blocks),
                "accepted": sum(b.get("accepted", 0) for b in blocks),
            }
        if stitches:
            st = stitches[-1]
            se["stitch"] = {k: st.get(k) for k in
                            ("blocks", "unique_blocks", "memo_hits",
                             "boundary_ops", "boundary_regrid_s",
                             "refine_iters", "refined_proposed",
                             "stitched_time_s", "best_time_s",
                             "dp_time_s", "budget_hit")}
        if results:
            r = results[-1]
            se["result"] = {k: r.get(k) for k in
                            ("dp_time_s", "best_time_s", "speedup_vs_dp",
                             "iters", "chains", "delta_hit_rate",
                             "proposals_per_sec")}
        out["search"] = se
    audits = [e for e in events if e.get("kind") == "hlo_audit"]
    if audits:
        out["hlo_audit"] = [{k: v for k, v in a.items()
                             if k not in ("run", "ts", "kind", "surface")}
                            for a in audits]
    benches = [e for e in events if e.get("kind") == "bench"]
    if benches:
        out["bench"] = [{k: v for k, v in b.items()
                         if k not in ("run", "ts", "kind", "surface")}
                        for b in benches]
    lints = [e for e in events if e.get("kind") == "lint"]
    if lints:
        rec = lints[-1]
        out["lint"] = {k: rec.get(k) for k in
                       ("model", "strategy", "error", "warning", "info",
                        "exempted", "findings", "predicted", "donation")
                       if rec.get(k) is not None}
    traces = [e for e in events if e.get("kind") == "sim_trace"]
    if traces:
        out["sim_trace"] = [{"path": t.get("path"),
                             "total_s": t.get("total_s"),
                             "dp_total_s": t.get("dp_total_s")}
                            for t in traces]
    budgets = [e for e in events if e.get("kind") == "step_budget"]
    if budgets:
        b = budgets[-1]
        out["step_budget"] = {
            "step_wall_s": b.get("step_wall_s"),
            "buckets": b.get("buckets"),
            "sources": b.get("sources"),
            "clamped": b.get("clamped"),
            "n_samples": b.get("n_samples"),
        }
    mets = [e for e in events if e.get("kind") == "metrics"]
    if mets:
        m = mets[-1]
        out["metrics"] = {
            "writes": len(mets),
            "path": m.get("path"),
            "gauges": {k: v for k, v in m.items()
                       if k not in ("run", "ts", "kind", "surface",
                                    "path")
                       and isinstance(v, (int, float))},
        }
    elastic_kinds = ("device_loss", "device_probe", "elastic_resize",
                     "elastic_fallback", "elastic_refused",
                     "elastic_rejoin", "device_return", "step_hang",
                     "preempt_drain", "ckpt_async")
    if any(kinds.get(k) for k in elastic_kinds):
        el: Dict = {"counts": {k: kinds[k] for k in elastic_kinds
                               if kinds.get(k)}}
        resizes = [e for e in events if e.get("kind") == "elastic_resize"]
        if resizes:
            el["resizes"] = [
                {"step": r.get("step"),
                 "direction": r.get("direction") or (
                     "grow" if (r.get("to_devices") or 0)
                     > (r.get("from_devices") or 0) else "shrink"),
                 "from_devices": r.get("from_devices"),
                 "to_devices": r.get("to_devices"),
                 "research_s": r.get("research_s"),
                 "research_mode": (r.get("research") or {}).get("mode"),
                 "migration": r.get("migration"),
                 "regrid_bytes": r.get("regrid_bytes"),
                 "regrid_hops": r.get("regrid_hops"),
                 "steps_lost": r.get("steps_lost")} for r in resizes]
        dl = [e for e in events if e.get("kind") == "device_loss"]
        if dl:
            el["device_losses"] = [
                {"step": d.get("step"),
                 "classification": d.get("classification"),
                 "dead": d.get("dead")} for d in dl]
        hangs = [e for e in events if e.get("kind") == "step_hang"]
        if hangs:
            el["step_hangs"] = [
                {"step": h.get("step"),
                 "deadline_s": h.get("deadline_s"),
                 "estimate_s": h.get("estimate_s")} for h in hangs]
        rets = [e for e in events if e.get("kind") == "device_return"]
        if rets:
            el["device_returns"] = [
                {"step": r.get("step"),
                 "returned": r.get("returned"),
                 "probes": r.get("probes")} for r in rets]
        drains = [e for e in events if e.get("kind") == "preempt_drain"]
        if drains:
            d = drains[-1]
            el["preempt_drain"] = {
                "step": d.get("step"),
                "ckpt_step": d.get("ckpt_step"),
                "signal": d.get("signal"),
                "seconds": d.get("seconds"),
                "budget_s": d.get("budget_s"),
                "mode": d.get("mode")}
        asyncs = [e for e in events if e.get("kind") == "ckpt_async"]
        if asyncs:
            commits = sorted(float(a.get("commit_s", 0.0))
                             for a in asyncs)
            el["ckpt_async"] = {
                "commits": len(asyncs),
                "median_commit_s": commits[len(commits) // 2],
                "faults": max(int(a.get("faults", 0)) for a in asyncs),
            }
        out["elastic"] = el
    serve_kinds = ("serve_request", "serve_batch", "serve_resize",
                   "serve_summary", "serve_handoff", "kv_refetch",
                   "router_summary", "serve_fault", "serve_retry",
                   "kv_rebuild", "serve_shed", "replica_down")
    if any(kinds.get(k) for k in serve_kinds):
        sv: Dict = {"counts": {k: kinds[k] for k in serve_kinds
                               if kinds.get(k)}}
        lat = sorted(float(e["latency_s"]) for e in events
                     if e.get("kind") == "serve_request"
                     and e.get("latency_s") is not None)
        if lat:
            sv["latency_s"] = {
                "p50": lat[min(len(lat) // 2, len(lat) - 1)],
                "p99": lat[min(int(0.99 * len(lat)), len(lat) - 1)],
                "min": lat[0], "max": lat[-1], "n": len(lat)}
        for key, field in (("ttft_s", "ttft_s"), ("tpot_s", "tpot_s")):
            vals = sorted(float(e[field]) for e in events
                          if e.get("kind") == "serve_request"
                          and e.get(field) is not None)
            if vals:
                sv[key] = {
                    "p50": vals[min(len(vals) // 2, len(vals) - 1)],
                    "p99": vals[min(int(0.99 * len(vals)),
                                    len(vals) - 1)],
                    "n": len(vals)}
        srs = [e for e in events if e.get("kind") == "serve_resize"]
        if srs:
            sv["resizes"] = [
                {"direction": r.get("direction"),
                 "from_devices": r.get("from_devices"),
                 "to_devices": r.get("to_devices"),
                 "step": r.get("step"),
                 "research_s": r.get("research_s"),
                 "research_mode": (r.get("research") or {}).get("mode")}
                for r in srs]
        sums = [e for e in events if e.get("kind") == "serve_summary"]
        if sums:
            s = sums[-1]
            sv["summary"] = {k: s.get(k) for k in
                             ("requests", "completed", "unserved",
                              "dropped", "qps", "p50_s", "p99_s",
                              "ttft_p50_s", "ttft_p99_s", "tpot_p50_s",
                              "tpot_p99_s", "steps",
                              "resizes", "virtual_s", "drained",
                              "devices")}
        hoffs = [e for e in events if e.get("kind") == "serve_handoff"]
        if hoffs:
            sv["handoffs"] = {
                "n": len(hoffs),
                "bytes": sum(float(h.get("bytes", 0.0)) for h in hoffs),
                "kv_refetches": kinds.get("kv_refetch", 0)}
        routers = [e for e in events
                   if e.get("kind") == "router_summary"]
        if routers:
            r = routers[-1]
            sv["router"] = {k: r.get(k) for k in
                            ("requests", "completed", "unserved",
                             "qps", "p50_s", "p99_s", "ttft_p50_s",
                             "ttft_p99_s", "tpot_p50_s", "steps",
                             "devices", "pools", "handoffs",
                             "affinity_hits", "kv_refetches",
                             "drained", "shed", "failed", "retries",
                             "kv_rebuilds", "replica_down",
                             "replicas_live", "recovery")}
        if any(kinds.get(k) for k in ("serve_retry", "serve_fault",
                                      "kv_rebuild", "serve_shed",
                                      "replica_down")):
            sv["resilience"] = {
                "retries": kinds.get("serve_retry", 0),
                "faults": kinds.get("serve_fault", 0),
                "kv_rebuilds": kinds.get("kv_rebuild", 0),
                "sheds": kinds.get("serve_shed", 0),
                "replica_downs": kinds.get("replica_down", 0)}
        out["serve"] = sv
    slos = [e for e in events if e.get("kind") == "slo"]
    if slos:
        out["slo"] = [{k: s.get(k) for k in
                       ("spec", "total", "good", "violations",
                        "error_rate", "error_budget", "burn_rate",
                        "max_window_burn_rate", "windows",
                        "achieved_percentile_s", "compliant",
                        "goodput_qps")} for s in slos]
    points = [e for e in events if e.get("kind") == "loadtest"]
    if points:
        out["loadtest"] = [{k: v for k, v in p.items()
                            if k not in ("run", "ts", "kind", "surface")}
                           for p in points]
    points = [e for e in events if e.get("kind") == "fleetsim"]
    if points:
        out["fleetsim"] = [{k: v for k, v in p.items()
                            if k not in ("run", "ts", "kind", "surface")}
                           for p in points]
    fleet_kinds = ("fleet_job", "fleet_placement", "fleet_rebalance",
                   "fleet_summary", "fleet_wait", "fleet_util")
    if any(kinds.get(k) for k in fleet_kinds):
        fl: Dict = {"counts": {k: kinds[k] for k in fleet_kinds
                               if kinds.get(k)},
                    "rebalances": kinds.get("fleet_rebalance", 0)}
        trail: Dict[str, List[str]] = {}
        for e in events:
            if e.get("kind") != "fleet_job":
                continue
            states = trail.setdefault(str(e.get("job")), [])
            st = str(e.get("state"))
            if not states or states[-1] != st:
                states.append(st)
        if trail:
            fl["jobs"] = trail
        packs = [e for e in events
                 if e.get("kind") == "fleet_placement"]
        if packs:
            fl["packs"] = [{"pack": p.get("pack"),
                            "sizes": p.get("sizes"),
                            "demands": p.get("demands")} for p in packs]
        moves = [e for e in events if e.get("kind") == "fleet_rebalance"]
        if moves:
            fl["moves"] = [
                [{"job": m.get("job"),
                  "from_devices": len(m.get("from") or []),
                  "to_devices": len(m.get("to") or [])}
                 for m in r.get("moves") or []] for r in moves]
        waits = [e for e in events if e.get("kind") == "fleet_wait"]
        if waits:
            fl["waits"] = [{k: w.get(k) for k in
                            ("job", "workload", "state", "wait_s",
                             "placement_s", "run_s", "drain_s",
                             "resize_s", "total_s", "submit_v",
                             "done_v")} for w in waits]
        utils = [e for e in events if e.get("kind") == "fleet_util"]
        if utils:
            busy = sum(int(u.get("busy_steps") or 0) for u in utils)
            idle = sum(int(u.get("idle_steps") or 0) for u in utils)
            rsz = sum(int(u.get("resizing_steps") or 0) for u in utils)
            cap = busy + idle + rsz
            fl["util"] = {"rounds": len(utils), "busy_steps": busy,
                          "idle_steps": idle, "resizing_steps": rsz,
                          "busy_frac": (busy / cap) if cap else 0.0}
        fsums = [e for e in events if e.get("kind") == "fleet_summary"]
        if fsums:
            s = fsums[-1]
            fl["summary"] = {k: s.get(k) for k in
                             ("pool_devices", "by_state", "rebalances",
                              "packs", "native_prices", "proxy_prices",
                              "wall_s", "virtual_s")}
        out["fleet"] = fl
    fault_kinds = ("fault", "rollback", "recovery", "data_fault",
                   "ckpt_fallback", "thread_leak")
    if any(kinds.get(k) for k in fault_kinds):
        fa: Dict = {"counts": {k: kinds[k] for k in fault_kinds
                               if kinds.get(k)}}
        rollbacks = [e for e in events if e.get("kind") == "rollback"]
        if rollbacks:
            fa["rollbacks"] = [{"from_step": r.get("from_step"),
                                "to_step": r.get("to_step")}
                               for r in rollbacks]
        fallbacks = [e for e in events if e.get("kind") == "ckpt_fallback"]
        if fallbacks:
            fa["ckpt_fallbacks"] = [{"from_step": c.get("from_step"),
                                     "to_step": c.get("to_step")}
                                    for c in fallbacks]
        skips = [e for e in events if e.get("kind") == "data_fault"
                 and e.get("action") == "skip"]
        if skips:
            fa["data_skips"] = len(skips)
        out["faults"] = fa
    return out
