"""Model-size sweep of the strategy search: flat against decomposed at an
equal proposal budget (PyTorch port of ``flexflow_tpu/apps/searchscale.py``).

    python -m flexflow_tpu_torch.apps.searchscale
    python -m flexflow_tpu_torch.apps.searchscale --smoke
    python -m flexflow_tpu_torch.apps.searchscale --sizes 0.1b,0.4b \\
        --devices 16 -o sweep.json

Each row builds one ``models/gpt.py`` preset on a virtual machine of
``--devices`` H100s (an NVLink tier of min(N, 8), as ``apps.search``;
nothing is allocated and no device is touched: the analytic cost model
prices every proposal) and runs both searches from the same
data-parallel start at the same proposal budget (``--iters``): the
chunked single-chain search (``StrategySearch.search``) and the
block-level sub-searches with shared-block memoization and boundary
refinement (``StrategySearch.search_decomposed``).  Every decomposed
plan passes through the plan checker (``verify/plan.py``): an
error-severity finding fails the run.  The headline row (``--headline``,
default ``1.3b``) also gets a ``serving`` block: one decomposed search
per serving objective (``latency``, one forward step; ``decode``, one
single-token step), each plan stamped as ``apps.search --serve`` stamps
it and passed through the plan checker forward-only with the KV cache
charged.  ``--no-serving`` leaves it out, and so does ``--smoke``.

stdout carries one JSON line (metric, value, unit, vs_baseline and the
headline row's account); ``-o`` also writes the ``searchscale_bench_v1``
artifact.  Every field is bit-deterministic under ``--seed`` except each
row's ``timing`` block and the serving searches' ``wall_s``.  ``--smoke`` proves that on a 4-layer graph: it
runs the row twice, and fails unless the payloads are bit-identical,
the shared-block memo hit and the stitched plan passed the plan gate.
"""

from __future__ import annotations

import hashlib
import json
import math
import os
import sys
import time

#: --smoke graph: small enough for a quick check, deep enough that blk1+
#: share a fingerprint (blk0 differs: its producer is the positional
#: embed, not a previous block's residual add)
SMOKE_OVERRIDES = dict(num_layers=4, d_model=128, num_heads=4, d_ff=512,
                       vocab_size=2048, seq_length=64, batch_size=16)


def _err(*a, **kw):
    print(*a, file=sys.stderr, **kw)
    sys.stderr.flush()


def parse_args(argv):
    from flexflow_tpu_torch.config import flag_stream

    opts = {
        "sizes": "0.1b,0.4b,1.3b,1.3b-deep", "devices": 16,
        "iters": 40000, "seed": 0, "headline": "1.3b",
        "serving": True, "out": "", "obs_dir": "", "smoke": False,
    }
    for a, val in flag_stream(list(argv)):
        if a == "--sizes":
            opts["sizes"] = val()
        elif a in ("-d", "--devices"):
            opts["devices"] = int(val())
        elif a in ("-i", "--iters"):
            opts["iters"] = int(val())
        elif a == "--seed":
            opts["seed"] = int(val())
        elif a == "--headline":
            opts["headline"] = val()
        elif a == "--no-serving":
            opts["serving"] = False
        elif a in ("-o", "--out"):
            opts["out"] = val()
        elif a in ("-obs-dir", "--obs-dir"):
            opts["obs_dir"] = val()
        elif a == "--smoke":
            opts["smoke"] = True
    if opts["iters"] < 100:
        raise SystemExit("searchscale: --iters must be >= 100")
    if opts["devices"] < 2:
        raise SystemExit("searchscale: --devices must be >= 2")
    if opts["smoke"]:
        opts["sizes"] = "tiny"
        opts["headline"] = "tiny"
        opts["devices"] = min(opts["devices"], 8)
        opts["iters"] = min(opts["iters"], 4000)
        opts["serving"] = False
    return opts


def _sizes(opts):
    return [s.strip() for s in str(opts["sizes"]).split(",") if s.strip()]


def _round(v, nd=6):
    """Stable rounding for the artifact."""
    if v is None or not isinstance(v, float):
        return v
    return round(v, nd) if math.isfinite(v) else v


def _build(size, machine):
    """(model, parameter count) of a sweep row; ``tiny`` is the smoke
    shape."""
    from flexflow_tpu_torch.models.gpt import build_gpt, gpt_param_count

    if size == "tiny":
        model = build_gpt("0.1b", machine, **SMOKE_OVERRIDES)
    else:
        model = build_gpt(size, machine)
    return model, gpt_param_count(model.t)


def _gate(model, strategy, machine, where, log):
    """The plan checker on a searched strategy: an error-severity finding
    means the stitch made an illegal plan, and fails the run."""
    from flexflow_tpu_torch.verify.plan import plan_findings

    findings, _ = plan_findings(model, strategy, machine)
    errors = [f for f in findings
              if f.severity == "error" and not f.exempted]
    for f in errors:
        log(f"searchscale PLAN GATE [{where}]: {f.code} {f.where}: "
            f"{f.message}")
    if errors:
        raise SystemExit(f"searchscale: {len(errors)} error-severity "
                         f"plan finding(s) on the {where} strategy")
    return True


def _assignment_sha(assignment):
    return hashlib.sha256(
        json.dumps(list(assignment)).encode()).hexdigest()[:16]


def _row(size, opts, machine, stream_path, log):
    """One sweep row: flat and decomposed at one proposal budget;
    everything but ``timing`` bit-deterministic under the seed."""
    from flexflow_tpu_torch import obs
    from flexflow_tpu_torch.sim.search import StrategySearch

    olog = obs.RunLog(stream_path, surface="search",
                      meta={"app": "searchscale", "size": size,
                            "devices": machine.num_devices,
                            "iters": opts["iters"],
                            "seed": opts["seed"]}) \
        if stream_path else obs.NULL

    t0 = time.perf_counter()
    model, params = _build(size, machine)
    search = StrategySearch(model, machine, obs=olog)
    build_s = time.perf_counter() - t0

    t0 = time.perf_counter()
    _, flat = search.search(iters=opts["iters"], seed=opts["seed"])
    flat_wall = time.perf_counter() - t0

    t0 = time.perf_counter()
    dstrat, dec = search.search_decomposed(iters=opts["iters"],
                                           seed=opts["seed"])
    dec_wall = time.perf_counter() - t0
    _gate(model, dstrat, machine, f"{size}/decomposed", log)

    row = {
        "size": size,
        "params": params,
        "ops": len(search.ops),
        "layers": model.t.num_layers,
        "devices": machine.num_devices,
        "iters": opts["iters"],
        "seed": opts["seed"],
        "dp_time_s": _round(dec["dp_time"], 9),
        "flat": {
            "best_time_s": _round(flat["best_time"], 9),
            "speedup_vs_dp": _round(flat["speedup_vs_dp"]),
        },
        "decomposed": {
            "best_time_s": _round(dec["best_time"], 9),
            "speedup_vs_dp": _round(dec["speedup_vs_dp"]),
            "stitched_time_s": _round(dec["stitched_time"], 9),
            "blocks": dec["blocks"],
            "unique_blocks": dec["unique_blocks"],
            "memo_hits": dec["memo_hits"],
            "boundary_ops": dec["boundary_ops"],
            "boundary_regrid_s": _round(dec["boundary_regrid_s"], 9),
            "assignment_sha": _assignment_sha(dec["assignment"]),
            "plan_gate_clean": True,
        },
        "decomposed_vs_flat": _round(
            flat["best_time"] / dec["best_time"]
            if dec["best_time"] > 0 else None),
        "timing": {    # wall clock: outside the repro contract
            "build_s": _round(build_s, 3),
            "flat_wall_s": _round(flat_wall, 3),
            "flat_proposals_per_sec": _round(
                flat.get("proposals_per_sec"), 1),
            "decomposed_wall_s": _round(dec_wall, 3),
            "decomposed_proposals_per_sec": _round(
                dec.get("proposals_per_sec"), 1),
        },
    }
    if opts["serving"] and size == opts["headline"]:
        row["serving"] = _serving(model, machine, opts, olog, size, log)
    olog.close()
    log(f"searchscale: {size} ({params / 1e9:.2f}B params, "
        f"{row['ops']} ops) dp {row['dp_time_s']:.4f}s | flat "
        f"{row['flat']['best_time_s']:.4f}s "
        f"({row['flat']['speedup_vs_dp']:.3f}x) | decomposed "
        f"{row['decomposed']['best_time_s']:.4f}s "
        f"({row['decomposed']['speedup_vs_dp']:.3f}x, "
        f"{row['decomposed']['blocks']} blocks, "
        f"{row['decomposed']['memo_hits']} memo hits) -> "
        f"{row['decomposed_vs_flat']:.3f}x vs flat")
    return row


def _serving(model, machine, opts, olog, size, log) -> dict:
    """The headline row's serving plans (``flexflow_tpu/apps/
    searchscale.py:205-235``): one decomposed search per objective, each
    plan stamped as ``apps.search --serve`` stamps it and gated
    forward-only with the KV cache charged."""
    from flexflow_tpu_torch.sim.search import StrategySearch

    out = {}
    for objective in ("latency", "decode"):
        search = StrategySearch(model, machine, obs=olog,
                                objective=objective)
        t0 = time.perf_counter()
        strategy, info = search.search_decomposed(iters=opts["iters"],
                                                  seed=opts["seed"])
        strategy.predicted = {"objective": objective,
                              "serve": {"max_batch": model.t.batch_size}}
        _gate(model, strategy, machine, f"{size}/{objective}", log)
        out[objective] = {
            "dp_time_s": _round(info["dp_time"], 9),
            "best_time_s": _round(info["best_time"], 9),
            "speedup_vs_dp": _round(info["speedup_vs_dp"]),
            "memo_hits": info["memo_hits"],
            "plan_gate_clean": True,
            "wall_s": _round(time.perf_counter() - t0, 3),
        }
    return out


def deterministic(row):
    """The repro-contract view of a row: everything but ``timing`` and
    the serving searches' ``wall_s``."""
    out = {k: v for k, v in row.items() if k != "timing"}
    if "serving" in out:
        out["serving"] = {
            obj: {k: v for k, v in blk.items() if k != "wall_s"}
            for obj, blk in out["serving"].items()}
    return out


def run(opts, log=_err) -> dict:
    from flexflow_tpu_torch.apps.search import NODE_CARDS
    from flexflow_tpu_torch.machine import MachineModel, Topology

    sizes = _sizes(opts)
    if not sizes:
        raise SystemExit("searchscale: --sizes must name at least one "
                         "preset")
    # apps.search's machine: one NVLink tier of up to a node's cards
    n = opts["devices"]
    machine = MachineModel.virtual(n, Topology.hopper(min(n, NODE_CARDS)))

    def stream(tag):
        return os.path.join(opts["obs_dir"],
                            f"searchscale_{tag}.jsonl") \
            if opts["obs_dir"] else ""

    rows = [_row(s, opts, machine, stream(s), log) for s in sizes]
    repro = None
    if opts["smoke"]:
        again = _row(sizes[0], opts, machine, stream("repro"), log)
        repro = json.dumps(deterministic(again), sort_keys=True) == \
            json.dumps(deterministic(rows[0]), sort_keys=True)
        if not repro:
            raise SystemExit(
                f"searchscale: NOT reproducible — size {sizes[0]} "
                f"deterministic payload differs between two runs of "
                f"seed {opts['seed']}")
        if rows[0]["decomposed"]["memo_hits"] < 1:
            raise SystemExit(
                "searchscale: shared-block memo never hit on the "
                "smoke graph — fingerprint grouping is broken")
        log(f"searchscale repro ok: size {sizes[0]} deterministic "
            f"payload bit-identical across two runs "
            f"({rows[0]['decomposed']['memo_hits']} memo hits)")

    head = next((r for r in rows if r["size"] == opts["headline"]),
                rows[-1])
    line = {
        "metric": (f"search_decomposed_speedup_{head['size']}_"
                   f"{head['devices']}dev"),
        "value": head["decomposed"]["speedup_vs_dp"],
        "unit": "x_vs_dp",
        "vs_baseline": head["decomposed_vs_flat"],
        "seed": opts["seed"],
        "iters": opts["iters"],
        "sizes": [r["size"] for r in rows],
        "params": head["params"],
        "blocks": head["decomposed"]["blocks"],
        "unique_blocks": head["decomposed"]["unique_blocks"],
        "memo_hits": head["decomposed"]["memo_hits"],
        "plan_gate_clean": all(
            r["decomposed"]["plan_gate_clean"] for r in rows),
        "repro": repro,
    }
    artifact = {
        "schema": "searchscale_bench_v1",
        "seed": opts["seed"],
        "iters": opts["iters"],
        "devices": opts["devices"],
        "headline": head["size"],
        "repro_contract": ("all fields bit-deterministic under seed "
                           "except rows[*].timing"),
        "parsed": {k: line[k] for k in
                   ("metric", "value", "unit", "vs_baseline")},
        "rows": rows,
    }
    if opts["out"]:
        with open(opts["out"], "w") as f:
            json.dump(artifact, f, indent=1)
            f.write("\n")
        log(f"searchscale artifact: {opts['out']}")
        line["out"] = opts["out"]
    return {"line": line, "artifact": artifact}


def main(argv=None, log=_err) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    opts = parse_args(argv)
    if opts["obs_dir"]:
        os.makedirs(opts["obs_dir"], exist_ok=True)
    result = run(opts, log)
    print(json.dumps(result["line"]))
    return 0


if __name__ == "__main__":
    sys.exit(main())
