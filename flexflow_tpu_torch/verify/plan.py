"""Static plan analyzer, the strategy typechecker (PyTorch port of
``flexflow_tpu/verify/plan.py``).

It checks a plan, a (model graph, strategy, machine) triple, without
running or simulating anything.  Every case the executor degrades with a
one-shot warning (a grid that does not divide the machine and
replicates, a device list ``parallel/placement.placement_slot``
normalizes) is a structured
:class:`~flexflow_tpu_torch.verify.findings.Finding` (an error by
default; ``allow_degraded`` demotes those to warnings), beside the hard
illegalities (rank, divisibility, device lists) and the whole-program
OOMs no per-op check can see (:mod:`flexflow_tpu_torch.verify.memory`).

Diagnostic codes (:data:`CODE_RULES`):

===================== ======== ==========================================
code                  severity rule
===================== ======== ==========================================
parse                 error    strategy file does not parse
bad_dims              error    grid dims must be integers >= 1
grid_size             error    len(devices) != prod(dims)
rank                  error    grid rank != the op's grid rank
device_range          error    device id outside [0, num_devices)
device_dup            error    duplicate device ids in one grid
divisibility          error    partitioned tensor dim not divisible by
                               its grid (spatial h/w may split unevenly
                               per ``uneven_spatial_ok``)
degraded_replicated   error*   grid does not divide the machine; op
                               would run fully replicated
degraded_normalized   error*   device list not honored placed; would be
                               normalized onto canonical order
regrid_unreachable    error    grid does not decompose over the machine
                               prime factors — outside the regrid hop
                               vocabulary
pipeline              error    __pipeline__ stage/microbatch/tp
                               divisibility (mirrors PipelinedLM)
oom                   error    predicted per-device peak HBM exceeds
                               capacity (verify/memory.py)
regrid_greedy         warning  greedy regrid decomposition fails for a
                               producer/consumer pair (the planner still
                               reaches via gather+re-split)
unknown_op            warning  strategy entry names no model op
===================== ======== ==========================================

(*) demoted to warning under ``allow_degraded``.

The checks back the search's feasibility gate (:func:`candidate_findings`:
``sim/search.py`` filters candidates before any simulator table exists
and reports the tally in its ``plan_gate`` record) and the decomposed
search's boundary pricing (:func:`regrid_edge_cost`).  :func:`check_plan`
is the drivers' fail-fast on a loaded strategy: ``apps.cnn``,
``apps.nmt`` and ``apps.lm`` run it before they build.
"""

from __future__ import annotations

import json
import math
import os
from typing import Dict, List, Mapping, Optional, Tuple

from flexflow_tpu_torch.ops.base import Op
from flexflow_tpu_torch.strategy import (ParallelConfig, Strategy,
                                         uneven_spatial_ok)
from flexflow_tpu_torch.verify.findings import Finding

PASS = "plan"

#: code -> (default severity, one-line rule)
CODE_RULES: Dict[str, Tuple[str, str]] = {
    "parse": ("error", "strategy file does not parse (JSON or proto2)"),
    "bad_dims": ("error", "grid dims must be integers >= 1"),
    "grid_size": ("error", "len(devices) != prod(dims)"),
    "rank": ("error", "grid rank != the op's grid rank (AXIS_NAMES)"),
    "device_range": ("error", "device id outside [0, num_devices)"),
    "device_dup": ("error", "duplicate device ids in one grid"),
    "divisibility": ("error",
                     "partitioned tensor dim not divisible by its grid "
                     "(spatial h/w may split unevenly)"),
    "degraded_replicated": ("error",
                            "grid does not divide the machine; op would "
                            "run fully replicated (1-device speed)"),
    "degraded_normalized": ("error",
                            "device list not honored placed (duplicates "
                            "or no placed support); would be normalized "
                            "onto the canonical order"),
    "regrid_unreachable": ("error",
                           "grid does not decompose over the machine's "
                           "prime factors — outside the regrid hop "
                           "vocabulary, every transition "
                           "full-rematerializes"),
    "pipeline": ("error",
                 "__pipeline__ stage/microbatch/tp inconsistency "
                 "(mirrors PipelinedLM's divisibility contract)"),
    "oom": ("error",
            "predicted per-device peak HBM exceeds capacity"),
    "regrid_greedy": ("warning",
                      "greedy regrid decomposition fails for a "
                      "producer/consumer pair (planner reaches via "
                      "gather + re-split)"),
    "unknown_op": ("warning", "strategy entry names no model op"),
}


def _f(code: str, where: str, message: str,
       severity: Optional[str] = None) -> Finding:
    return Finding(PASS, code, severity or CODE_RULES[code][0], where,
                   message)


# ---------------------------------------------------------------------------
# raw (pre-ParallelConfig) structural checks — ParallelConfig.__post_init__
# raises on these, so a file has to be vetted BEFORE construction to
# produce a diagnostic list instead of a single traceback


def strategy_file_findings(path: str, where_prefix: Optional[str] = None
                           ) -> Tuple[List[Finding], Optional[Strategy]]:
    """Structural vetting of a strategy FILE: parse + per-entry dims/
    devices shape + ``__pipeline__`` field types.  Returns the findings
    plus a Strategy built from the well-formed entries (None when the
    file does not parse at all), so semantic checks can continue past
    individual bad entries."""
    prefix = (where_prefix if where_prefix is not None
              else os.path.basename(path) + ":")
    findings: List[Finding] = []
    try:
        with open(path, "rb") as f:
            raw = f.read()
    except OSError as e:
        return [_f("parse", prefix.rstrip(":"), f"cannot read: {e}")], None
    if not raw.lstrip().startswith(b"{"):
        # proto2 wire format: no partial recovery — parse or fail whole
        try:
            return findings, Strategy.from_proto_bytes(raw)
        except (ValueError, UnicodeDecodeError) as e:
            return [_f("parse", prefix.rstrip(":"),
                       f"proto strategy does not parse: {e}")], None
    try:
        obj = json.loads(raw.decode("utf-8"))
    except (ValueError, UnicodeDecodeError) as e:
        return [_f("parse", prefix.rstrip(":"),
                   f"JSON strategy does not parse: {e}")], None
    if not isinstance(obj, dict):
        return [_f("parse", prefix.rstrip(":"),
                   f"top level must be an object, got "
                   f"{type(obj).__name__}")], None
    s = Strategy()
    pp = obj.pop("__pipeline__", None)
    if pp is not None:
        ok = isinstance(pp, dict)
        for k in ("stages", "microbatches"):
            if ok and not (isinstance(pp.get(k), int) and pp[k] >= 1):
                findings.append(_f(
                    "pipeline", prefix + "__pipeline__",
                    f"{k!r} must be an integer >= 1, got {pp.get(k)!r}"))
                ok = False
        if ok and not (isinstance(pp.get("tp", 1), int)
                       and pp.get("tp", 1) >= 1):
            findings.append(_f(
                "pipeline", prefix + "__pipeline__",
                f"'tp' must be an integer >= 1, got {pp.get('tp')!r}"))
            ok = False
        if not isinstance(pp, dict):
            findings.append(_f("pipeline", prefix + "__pipeline__",
                               f"must be an object, got {pp!r}"))
        elif ok:
            s.pipeline = {"stages": pp["stages"],
                          "microbatches": pp["microbatches"],
                          "tp": pp.get("tp", 1)}
    pred = obj.pop("__predicted__", None)
    if pred:
        s.predicted = dict(pred)
    for name, d in obj.items():
        where = prefix + name
        if not isinstance(d, dict) or "dims" not in d or "devices" not in d:
            findings.append(_f("parse", where,
                               "entry must be {\"dims\": [...], "
                               "\"devices\": [...]}"))
            continue
        dims, devices = d["dims"], d["devices"]
        if (not isinstance(dims, list) or not dims
                or any(not isinstance(x, int) or x < 1 for x in dims)):
            findings.append(_f("bad_dims", where,
                               f"grid dims must be integers >= 1, "
                               f"got {dims!r}"))
            continue
        if (not isinstance(devices, list)
                or any(not isinstance(x, int) for x in devices)):
            findings.append(_f("grid_size", where,
                               f"devices must be a list of integers, "
                               f"got {devices!r}"))
            continue
        n = math.prod(dims)
        if len(devices) != n:
            findings.append(_f(
                "grid_size", where,
                f"devices list has {len(devices)} entries but grid "
                f"{tuple(dims)} has {n} points"))
            continue
        s[name] = ParallelConfig(tuple(dims), tuple(devices))
    return findings, s


# ---------------------------------------------------------------------------
# per-op legality — the unit the search gate reuses per candidate


def op_findings(op: Op, pc: ParallelConfig, machine, *,
                allow_degraded: bool = False,
                where_prefix: str = "") -> List[Finding]:
    """Legality findings for running ``op`` under ``pc`` on ``machine``:
    rank / device list / divisibility errors, the promoted degradation
    diagnostics, and hop-vocabulary (global mesh) reachability."""
    from flexflow_tpu_torch.parallel.placement import placement_slot

    out: List[Finding] = []
    where = where_prefix + op.name
    n = machine.num_devices
    deg_sev = "warning" if allow_degraded else "error"
    if len(pc.dims) != len(op.AXIS_NAMES):
        out.append(_f("rank", where,
                      f"ParallelConfig rank {pc.ndims} does not match op "
                      f"grid rank {len(op.AXIS_NAMES)} "
                      f"({op.AXIS_NAMES})"))
        return out  # nothing downstream is meaningful
    dev_bad = False
    bad = sorted({d for d in pc.devices if d < 0 or d >= n})
    if bad:
        out.append(_f("device_range", where,
                      f"device ids {bad} out of range [0, {n})"))
        dev_bad = True
    if len(set(pc.devices)) != pc.num_parts:
        dups = sorted({d for d in pc.devices if pc.devices.count(d) > 1})
        out.append(_f("device_dup", where,
                      f"duplicate device ids {dups} in grid {pc.dims} "
                      f"(every grid point needs its own device)"))
        dev_bad = True
    # divisibility — Op.validate_partitioning's rule applied to the
    # CANDIDATE pc (the op keeps its own config untouched)
    sizes = dict(zip(op.AXIS_NAMES, pc.dims))
    try:
        tensors = list(zip(op.all_outputs(), op.output_specs()))
    except Exception:
        tensors = []
    for t, spec in tensors:
        if spec is None:
            continue
        for d, entry in enumerate(spec):
            if entry is None or d >= len(t.shape):
                continue
            axes = entry if isinstance(entry, tuple) else (entry,)
            parts = 1
            for a in axes:
                parts *= sizes.get(a, 1)
            if parts <= 1 or t.shape[d] % parts == 0:
                continue
            if all(a in ("h", "w") for a in axes) \
                    and uneven_spatial_ok(t.shape[d], parts):
                continue  # uneven spatial split, ceil-sized blocks
            out.append(_f(
                "divisibility", where,
                f"output dim {d} of size {t.shape[d]} not divisible by "
                f"its partition count {parts} (grid {pc.dims})"))
    if dev_bad:
        # an unusable device list already implies the "norm" degradation;
        # reporting it again would double-count one defect
        return out
    if not machine.is_canonical(pc):
        if placement_slot(op, n, pc) is None:
            if n % pc.num_parts != 0:
                out.append(_f(
                    "degraded_replicated", where,
                    f"strategy grid {pc.dims} does not divide the "
                    f"{n}-device machine; op would run fully replicated "
                    f"(1-device speed)", severity=deg_sev))
            else:
                out.append(_f(
                    "degraded_normalized", where,
                    f"devices {pc.devices} for grid {pc.dims}: op cannot "
                    f"execute placed under this grid; the device list "
                    f"would be normalized onto the canonical order "
                    f"(placement not honored — see parallel/placement.py "
                    f"placement_slot)", severity=deg_sev))
        # a placed op moves its values by box overlap and a degraded one
        # replicates — neither takes global-mesh regrids, so the hop-
        # vocabulary check below applies to canonical grids only
        return out
    if pc.num_parts > 1 \
            and machine.global_assign(pc, op.AXIS_NAMES) is None:
        facs = [s for _, s in machine.global_factors()]
        out.append(_f(
            "regrid_unreachable", where,
            f"grid {pc.dims} does not decompose over the machine's "
            f"prime factors {facs}: the op leaves the global-mesh hop "
            f"vocabulary (parallel/regrid.py), so every producer/"
            f"consumer transition full-rematerializes"))
    return out


def candidate_findings(op: Op, pc: ParallelConfig, machine
                       ) -> List[Finding]:
    """The search gate's unit: error-severity legality findings for one
    candidate (degradations stay errors — the simulator must never price
    a grid the executor would silently replicate)."""
    return [f for f in op_findings(op, pc, machine, allow_degraded=False)
            if f.severity == "error"]


# ---------------------------------------------------------------------------
# pipeline block — mirrors PipelinedLM.__init__'s raises (pipeline.py)


def pipeline_findings(pp: Mapping, model, machine,
                      where_prefix: str = "") -> List[Finding]:
    out: List[Finding] = []
    where = where_prefix + "__pipeline__"
    s, m = int(pp.get("stages", 0)), int(pp.get("microbatches", 0))
    tp = int(pp.get("tp", 1))
    if s < 1 or m < 1 or tp < 1:
        out.append(_f("pipeline", where,
                      f"stages={s} microbatches={m} tp={tp}: all must "
                      f"be >= 1"))
        return out
    n = machine.num_devices
    if n % (s * tp):
        out.append(_f("pipeline", where,
                      f"{n} devices not divisible into {s} stages x "
                      f"{tp} tp"))
        return out
    dp = n // (s * tp)
    batch = getattr(getattr(model, "config", None), "batch_size", 0) or 0
    if batch:
        if batch % m:
            out.append(_f("pipeline", where,
                          f"batch {batch} not divisible by "
                          f"{m} microbatches"))
        elif (batch // m) % dp:
            out.append(_f("pipeline", where,
                          f"microbatch size {batch // m} not divisible "
                          f"by the data-parallel axis ({dp} devices)"))
    t = getattr(model, "t", None)  # TransformerConfig, when one exists
    layers = getattr(t, "num_layers", 0) or 0
    heads = getattr(t, "num_heads", 0) or 0
    d_ff = getattr(t, "d_ff", 0) or 0
    if layers and layers % s:
        out.append(_f("pipeline", where,
                      f"{layers} layers not divisible into {s} stages"))
    if heads and heads % tp:
        out.append(_f("pipeline", where,
                      f"tp={tp} must divide num_heads ({heads})"))
    if d_ff and d_ff % tp:
        out.append(_f("pipeline", where,
                      f"tp={tp} must divide d_ff ({d_ff})"))
    return out


# ---------------------------------------------------------------------------
# whole-plan analysis


def plan_findings(model, strategy=None, machine=None, *,
                  allow_degraded: bool = False,
                  check_memory: bool = True,
                  hbm_capacity: Optional[float] = None,
                  where_prefix: str = ""
                  ) -> Tuple[List[Finding], dict]:
    """Analyze the whole plan: every op's legality under its effective
    pc, producer/consumer regrid reachability, the ``__pipeline__``
    block, and the per-device HBM fit.  ``strategy`` (op name ->
    ParallelConfig, or a :class:`Strategy`) overrides the pcs the model
    was built with; None checks the built-in plan.  Returns
    ``(findings, summary)`` — summary carries per-code counts and the
    memory report for rendering."""
    from flexflow_tpu_torch.verify.memory import device_memory_report

    machine = machine or model.machine
    findings: List[Finding] = []
    op_names = {op.name for op in model.layers}
    if strategy is not None:
        for name in strategy:
            if name not in op_names:
                findings.append(_f(
                    "unknown_op", where_prefix + name,
                    f"strategy entry {name!r} names no op of this model "
                    f"({len(op_names)} ops)"))

    def eff(op):
        if strategy is not None:
            pc = strategy.get(op.name)
            if pc is not None:
                return pc
        return op.pc

    flagged = set()
    for op in model.layers:
        fs = op_findings(op, eff(op), machine,
                         allow_degraded=allow_degraded,
                         where_prefix=where_prefix)
        if fs:
            flagged.add(op.name)
        findings.extend(fs)

    # producer/consumer reachability inside the hop vocabulary: when both
    # endpoints express as global-mesh entries plan_hops always reaches
    # (parallel/regrid.py), so the pairwise check only flags pairs the
    # GREEDY decomposition cannot serve (priced worse, never fatal);
    # endpoints OUTSIDE the vocabulary were flagged regrid_unreachable
    # above
    regrid_pairs = 0
    for op in model.layers:
        pc = eff(op)
        if op.name in flagged or len(pc.dims) != len(op.AXIS_NAMES):
            continue  # already-diagnosed ops would only add echo noise
        try:
            ispecs = op.input_specs(pc)
        except Exception:
            ispecs = None
        if ispecs is None:
            continue
        for i, t in enumerate(op.inputs):
            prod = t.producer
            if prod is None or i >= len(ispecs) or ispecs[i] is None \
                    or prod.name in flagged:
                continue
            ppc = eff(prod)
            if len(ppc.dims) != len(prod.AXIS_NAMES):
                continue
            try:
                oi = [x.tid for x in prod.all_outputs()].index(t.tid)
                ospec = prod.output_specs()[oi]
            except Exception:
                continue
            src = machine.global_entries(ppc, prod.AXIS_NAMES, ospec,
                                         rank=t.ndim)
            dst = machine.global_entries(pc, op.AXIS_NAMES, ispecs[i],
                                         rank=t.ndim)
            if src is None or dst is None:
                continue
            regrid_pairs += 1
            if src != dst and machine.regrid_steps(src, dst) is None:
                findings.append(_f(
                    "regrid_greedy",
                    where_prefix + f"{prod.name}->{op.name}",
                    f"greedy regrid {src} -> {dst} has no single-axis "
                    f"decomposition; the planner reaches it via gather "
                    f"+ re-split at extra cost"))

    pp = getattr(strategy, "pipeline", None) if strategy is not None \
        else None
    if pp:
        findings.extend(pipeline_findings(pp, model, machine,
                                          where_prefix=where_prefix))

    # a SERVING strategy (apps/search.py --serve stamps
    # __predicted__.objective == "latency", or "decode" for a
    # disaggregated decode pool) is vetted forward-only: no optimizer
    # state or gradient cotangents in the peak, activation factor 1.0,
    # and the KV cache charged per device.  Under disaggregation the
    # cache is charged to the DECODE pool only: a prefill-phase
    # strategy (serve.phase == "prefill") streams its K/V straight into
    # the handoff export and holds no ring, so its HBM peak carries
    # kv_bytes == 0.
    pred = getattr(strategy, "predicted", None) if strategy is not None \
        else None
    serving = bool(pred) and pred.get("objective") in ("latency",
                                                       "decode")
    kv_bytes = 0.0
    serve_phase = ""
    if serving:
        serve = pred.get("serve") or {}
        serve_phase = serve.get("phase") or \
            ("decode" if pred.get("objective") == "decode" else "")
        if serve_phase != "prefill":
            kv_bytes = float(serve.get("kv_cache_bytes_per_device",
                                       0.0))
            if not kv_bytes:
                from flexflow_tpu_torch.serve.kv_cache import kv_cache_bytes

                batch = serve.get("max_batch") \
                    or getattr(getattr(model, "config", None),
                               "batch_size", 1)
                kv_bytes = float(kv_cache_bytes(model, batch,
                                                strategy=strategy))

    mem = None
    if check_memory:
        mem = device_memory_report(model, strategy, machine,
                                   hbm_capacity=hbm_capacity,
                                   forward_only=serving,
                                   kv_cache_bytes=kv_bytes)
        for dev, total in mem["over"]:
            b = mem["per_device"][dev]
            kv = b.get("kv_cache", 0.0)
            kv_part = f" + kv_cache {kv / 1e9:.2f}" if kv else ""
            findings.append(_f(
                "oom", where_prefix + f"device{dev}",
                f"predicted peak {total / 1e9:.2f} GB exceeds "
                f"{mem['capacity'] / 1e9:.2f} GB HBM (params "
                f"{b['params'] / 1e9:.2f} + opt {b['opt'] / 1e9:.2f} + "
                f"grads {b['grads'] / 1e9:.2f} + activations "
                f"{b['activations'] / 1e9:.2f} + inputs "
                f"{b['inputs'] / 1e9:.2f}{kv_part} GB)"))

    by_code: Dict[str, int] = {}
    for f in findings:
        by_code[f.code] = by_code.get(f.code, 0) + 1
    summary = {
        "ops": len(model.layers),
        "devices": machine.num_devices,
        "regrid_pairs": regrid_pairs,
        "by_code": by_code,
        "allow_degraded": allow_degraded,
    }
    if serving:
        summary["serving"] = {"forward_only": True,
                              "kv_cache_bytes_per_device": kv_bytes}
        if serve_phase:
            summary["serving"]["phase"] = serve_phase
    if mem is not None:
        peak = max((b["total"] for b in mem["per_device"].values()),
                   default=0.0)
        summary["memory"] = {"capacity": mem["capacity"],
                             "max_device_bytes": peak,
                             "over_devices": len(mem["over"])}
    return findings, summary


def format_findings(findings: List[Finding]) -> str:
    lines = []
    for f in findings:
        tag = "EXEMPT" if f.exempted else f.severity.upper()
        lines.append(f"[{tag}] {f.ident()}: {f.message}"
                     + (f" (exempt: {f.reason})" if f.exempted else ""))
    return "\n".join(lines)


def check_plan(model, strategy, machine=None, *,
               allow_degraded: bool = False,
               check_memory: bool = True,
               hbm_capacity: Optional[float] = None,
               label: str = "strategy") -> List[Finding]:
    """Driver-side fail-fast: run :func:`plan_findings` and raise
    ``SystemExit(2)`` with the full diagnostic list when any error
    remains — the strategy-load replacement for mid-compile tracebacks.
    Warnings print and continue (matching the executor's historical
    degrade-with-a-warning under ``allow_degraded``)."""
    import sys

    findings, _summary = plan_findings(
        model, strategy, machine, allow_degraded=allow_degraded,
        check_memory=check_memory, hbm_capacity=hbm_capacity)
    errors = [f for f in findings
              if f.severity == "error" and not f.exempted]
    if findings:
        print(f"plan check ({label}):\n{format_findings(findings)}",
              file=sys.stderr)
    if errors:
        print(f"plan check: {len(errors)} error(s) — refusing to run "
              f"(pass --allow-degraded to keep the old degrade-and-"
              f"continue behavior for degradation findings)",
              file=sys.stderr)
        raise SystemExit(2)
    return findings


def regrid_edge_cost(tensor_shape, src_pc: ParallelConfig,
                     dst_pc: ParallelConfig, machine,
                     itemsize: int = 4) -> float:
    """Price of resharding one boundary tensor from its producer's grid
    to its consumer's grid — the decomposed search's view of a
    block-stitch edge, with the simulator's ring formulas
    (``sim/collectives``).

    Equal grids cost zero; a mismatch is priced as one all-to-all of
    the full tensor over the union of the two device sets — the upper
    bound of the planner's hop chain (every element leaves its source
    shard at most once)."""
    from flexflow_tpu_torch.sim.collectives import _alltoall

    if (tuple(src_pc.dims) == tuple(dst_pc.dims)
            and tuple(src_pc.devices) == tuple(dst_pc.devices)):
        return 0.0
    devs = tuple(sorted(set(src_pc.devices) | set(dst_pc.devices)))
    if len(devs) <= 1:
        return 0.0
    vol = float(itemsize) * float(math.prod(tensor_shape))
    return float(_alltoall(vol, devs, machine.topology))
