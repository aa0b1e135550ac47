"""Offline strategy search (PyTorch port of ``flexflow_tpu/apps/search.py``;
the reference's ``scripts/simulator.cc`` main, with its loop closed: the
strategy found is written to a file the training drivers run).

    python -m flexflow_tpu_torch.apps.search alexnet --devices 8 -o s.json
    python -m flexflow_tpu_torch.apps.search alexnet --devices 4 \\
        --measured --cache .chip_strategy/cache.json -o s.json
    torchrun --standalone --nproc-per-node 4 -m flexflow_tpu_torch.apps.cnn \\
        alexnet -s s.json -ll:gpu 4

``--devices N`` searches for an N-card machine, whatever the local
hardware (default: the visible CUDA cards); the graph is built on
``MachineModel.virtual`` and nothing runs on a device unless
``--measured`` asks for it.  The machine's links are
``Topology.hopper``: an NVLink tier of ``--ici-group`` cards (default
min(N, 8), one node) and InfiniBand between tiers, whose slow tier a
``--dcn-calibration`` file replaces.  The per-op costs are the analytic
roofline over the H100's published peaks, or with ``--measured`` one
grid point's forward and gradient timed on ``--device`` (default
``cuda``; the run raises without CUDA unless ``--device cpu`` is given)
with CUDA events, through the port's ops and kernels, cached in
``--cache``.  ``-o x.json`` writes JSON with a ``__predicted__`` block,
any other extension the reference's proto2 wire format.

The JAX driver's flags: ``-i/--iters``, ``-b``, ``--seed``, ``--dtype``,
``--experts``, ``-obs-dir``, ``-run-id``, ``-chains``, ``-delta
on|off|check``, ``--objective makespan|latency|decode``, ``--serve``,
``--disagg N``, ``--decompose``, ``--block-budget-s``,
``--boundary-refine-iters``, ``--no-audit``, ``-trace``.  ``--audit``
(the compiled program's audit, ROADMAP Queue A item 7) raises
``NotImplementedError``.  So does the JAX driver's
default audit, which runs where a saved strategy (``-o``) on a machine
of several tiers claims a win over 1.05x, or carries an accepted
``__pipeline__`` block: there the port stops unless ``--no-audit`` is
given.

``--serve`` writes a serving artifact: the objective defaults to
``latency`` and ``__predicted__`` gains a ``serve`` block (``max_batch``,
``kv_cache_bytes_per_device``, ``forward_step_s``; ``phase`` ``decode``
under ``--objective decode``) that ``apps.serve -s`` reads as its step
and ``verify/plan.py`` charges the KV cache from.  ``--disagg N``
(implies ``--serve``) makes the main search the prefill phase's plan
and adds a companion search of the decode phase on its own N-card
virtual slice under the ``decode`` objective, on the same
``Topology.hopper`` family and the same cost model (a measured run
times each shard once): the block's ``prefill`` and ``decode`` entries
carry each phase's step, and ``decode`` its plan inline.

The transformer (``transformer``, ``gpt``, ``bert``) under ``--objective
makespan`` also gets the GPipe proposal
(``StrategySearch.propose_pipeline``): every (stages, microbatches, tp)
candidate is logged with its bubble, boundary, tp and sync terms, and
the best one becomes the strategy's ``__pipeline__`` block when it beats
the searched plan (``result["pipeline"]`` says which).  ``apps.lm
--strategy`` trains such a block.  A proto ``-o`` cannot carry the
block, so the whole plan also goes to the JSON sidecar
``<out>.pipeline.json``.

``-trace`` writes the simulated per-op timelines of the plan found and
of data parallelism as one Chrome/Perfetto ``trace_event`` file
(``<out-stem>.trace.json`` beside ``-o``, else
``<obs-dir>/<run-id>.trace.json``, else ``<model>.trace.json``) and a
``sim_trace`` record with each op's simulated seconds, the join keys
``obs/trace.py`` and ``apps.calibrate --from-obs`` match against the
``op_time`` records of a training run under the plan.

One JSON line on stdout carries the model, objective, devices,
``dp_time_s``, ``best_time_s`` and ``speedup_vs_dp`` (plus the
decomposition's account under ``--decompose`` and the measurement's
under ``--measured``).
"""

from __future__ import annotations

import json
import math
import os
import sys

from flexflow_tpu_torch.config import flag_stream
from flexflow_tpu_torch.machine import MachineModel, Topology

#: flags of the JAX driver whose modules are not ported, and where
UNPORTED_FLAGS = {
    "--audit": "the compiled program's collective audit (ROADMAP Queue A "
               "item 7)",
}

#: cards in one NVLink domain (a node)
NODE_CARDS = 8


def parse_args(argv):
    opts = {
        "model": "alexnet", "devices": None, "iters": 250_000,
        "out": "", "measured": False, "batch_size": 64, "seed": 0,
        "ici_group": None, "cache": "", "audit": None,
        "dtype": "float32", "dcn_calibration": "", "experts": 0,
        "obs_dir": "", "run_id": "", "chains": 1, "delta": "on",
        "objective": None, "decompose": False, "serve": False,
        "disagg": 0,
        "block_budget_s": 0.0, "boundary_refine_iters": 0,
        "device": "cuda", "trace": False,
    }
    args = list(argv)
    if args and not args[0].startswith("-"):
        opts["model"] = args.pop(0)
    for a, val in flag_stream(args):
        if a in UNPORTED_FLAGS:
            raise NotImplementedError(
                f"{a} is not ported to flexflow_tpu_torch: "
                f"{UNPORTED_FLAGS[a]}")
        if a == "--devices":
            opts["devices"] = int(val())
        elif a in ("-i", "--iters"):
            opts["iters"] = int(val())
        elif a in ("-o", "--out"):
            opts["out"] = val()
        elif a == "--measured":
            opts["measured"] = True
        elif a == "--cache":
            opts["cache"] = val()
        elif a in ("-b", "--batch-size"):
            opts["batch_size"] = int(val())
        elif a == "--seed":
            opts["seed"] = int(val())
        elif a == "--ici-group":
            opts["ici_group"] = int(val())
        elif a == "--no-audit":
            opts["audit"] = False
        elif a == "--dtype":
            opts["dtype"] = val()
        elif a == "--dcn-calibration":
            opts["dcn_calibration"] = val()
        elif a == "--experts":
            opts["experts"] = int(val())
        elif a in ("-obs-dir", "--obs-dir"):
            opts["obs_dir"] = val()
        elif a in ("-run-id", "--run-id"):
            opts["run_id"] = val()
        elif a in ("-chains", "--chains"):
            opts["chains"] = int(val())
        elif a in ("-delta", "--delta"):
            opts["delta"] = val()
        elif a == "--objective":
            opts["objective"] = val()
        elif a == "--serve":
            opts["serve"] = True
        elif a == "--disagg":
            opts["disagg"] = int(val())
        elif a == "--decompose":
            opts["decompose"] = True
        elif a == "--block-budget-s":
            opts["block_budget_s"] = float(val())
        elif a == "--boundary-refine-iters":
            opts["boundary_refine_iters"] = int(val())
        elif a == "--device":
            opts["device"] = val()
        elif a in ("-trace", "--trace"):
            opts["trace"] = True
    if opts["delta"] not in ("on", "off", "check"):
        raise SystemExit(f"-delta must be on|off|check, got "
                         f"{opts['delta']!r}")
    if opts["disagg"]:
        opts["serve"] = True
    if opts["objective"] is None:
        opts["objective"] = "latency" if opts["serve"] else "makespan"
    if opts["objective"] not in ("makespan", "latency", "decode"):
        raise SystemExit(f"--objective must be makespan|latency|decode, "
                         f"got {opts['objective']!r}")
    return opts


def build_model(name: str, machine: MachineModel, batch_size: int,
                dtype: str = "float32", experts: int = 0):
    """The graph of model ``name`` from the port's builders on
    ``machine`` (224x224 CNNs, 299x299 Inception; the ``gpt-*`` presets
    own their batch and sequence)."""
    if name == "nmt":
        from flexflow_tpu_torch.nmt.rnn_model import RnnConfig, RnnModel

        return RnnModel(RnnConfig(batch_size=batch_size,
                                  compute_dtype=dtype), machine)
    if name in ("transformer", "gpt", "bert"):
        from flexflow_tpu_torch.models.transformer import (TransformerConfig,
                                                           TransformerLM)

        return TransformerLM(TransformerConfig(batch_size=batch_size,
                                               compute_dtype=dtype,
                                               num_experts=experts),
                             machine)
    if name.startswith("gpt-"):
        from flexflow_tpu_torch.models.gpt import build_gpt

        return build_gpt(name[4:], machine, compute_dtype=dtype,
                         num_experts=experts)
    from flexflow_tpu_torch.apps.cnn import MODELS, build
    from flexflow_tpu_torch.config import FFConfig

    if name not in MODELS:
        raise SystemExit(f"unknown model {name!r}")
    size = 299 if name.startswith("inception") else 224
    cfg = FFConfig(batch_size=batch_size, input_height=size,
                   input_width=size, compute_dtype=dtype)
    return build(name, cfg, machine)


def _search_kw(opts):
    """search() keywords from the -chains / -delta flags."""
    return {"chains": opts["chains"],
            "delta": opts["delta"] != "off",
            "delta_check": opts["delta"] == "check"}


def _machine(opts, n=None) -> MachineModel:
    """The virtual machine searched for: ``n`` cards (default
    ``--devices``, else the visible CUDA cards) on ``Topology.hopper``."""
    n = n or opts["devices"]
    if not n:
        import torch

        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA card to search for: pass "
                               "--devices N")
        n = torch.cuda.device_count()
    topo = Topology.hopper(opts.get("ici_group") or min(n, NODE_CARDS))
    if opts["dcn_calibration"]:
        topo = topo.with_calibration(opts["dcn_calibration"])
    return MachineModel.virtual(n, topo)


#: what a measured search says of its plan: the simulator's drift from
#: the executor on the cards is not closed yet
MEASURED_UNCHECKED = (
    "warning: a plan searched on measured shard times is not checked "
    "against a data-parallel run on the cards; the simulator can rank "
    "the two backwards there (ROADMAP Queue A item 4, the drift): train "
    "both and keep the faster before relying on the plan")


def _cost_model(opts):
    """None (the search's analytic default) or the measured model on
    ``--device``, whose analytic fallback carries the card's memory."""
    if not opts["measured"]:
        return None
    import torch

    from flexflow_tpu_torch.machine import resolve_device
    from flexflow_tpu_torch.sim.cost_model import (AnalyticCostModel,
                                                   HopperChipPerf,
                                                   MeasuredCostModel)

    dev = resolve_device(opts["device"])
    perf = None
    if dev.type == "cuda":
        # time what the training drivers run: float32 without TF32
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        perf = HopperChipPerf.for_device(dev)
    return MeasuredCostModel(cache_path=opts["cache"] or None,
                             fallback=AnalyticCostModel(perf=perf),
                             device=dev)


def _write_sim_trace(opts, search, info, olog, log) -> str:
    """The ``-trace`` export (``flexflow_tpu/apps/search.py:259``): the
    simulated timelines of the plan found and of data parallelism as two
    process lanes of one trace file, and a ``sim_trace`` record with
    each op's simulated seconds; the file's path."""
    from flexflow_tpu_torch.obs import trace as obstrace

    best = search.simulate_trace(info["assignment"])
    dp = search.simulate_trace(search.dp_assignment())
    if opts["out"]:
        path = os.path.splitext(opts["out"])[0] + ".trace.json"
    elif opts["obs_dir"] and olog.enabled:
        path = os.path.join(opts["obs_dir"], f"{olog.run_id}.trace.json")
    else:
        path = f"{opts['model']}.trace.json"
    obstrace.write_trace(path, obstrace.chrome_trace(
        obstrace.sim_trace_events(best, pid=obstrace.PID_SIM_BEST,
                                  label="sim:best"),
        obstrace.sim_trace_events(dp, pid=obstrace.PID_SIM_DP,
                                  label="sim:dp")))
    olog.event("sim_trace", path=path, op_s=best["op_s"],
               total_s=best["total_s"], dp_total_s=dp["total_s"],
               opt_stream_s=best["opt_stream_s"])
    log(f"sim trace written to {path} (sim:best + sim:dp lanes; open in "
        f"ui.perfetto.dev)")
    return path


def _decode_companion_search(opts, cost_model, olog, log) -> dict:
    """The ``--disagg N`` companion (``flexflow_tpu/apps/search.py:
    440-470``): the decode phase's plan on its own N-card virtual slice
    under the ``decode`` objective, with ``cost_model`` (a measured run
    times each shard once).  The slice is the main search's topology
    family, ``Topology.hopper`` (JAX's is its default ``Topology``; ROADMAP
    Known differences).  Returns the ``serve.decode`` block: the step
    time and the plan inline, so one artifact carries both phases."""
    from flexflow_tpu_torch.sim.search import StrategySearch

    n = opts["disagg"]
    machine = _machine({"dcn_calibration": opts["dcn_calibration"]}, n)
    model = build_model(opts["model"], machine, opts["batch_size"],
                        opts["dtype"], opts["experts"])
    search = StrategySearch(model, machine, cost_model=cost_model,
                            obs=olog, objective="decode")
    strategy, info = search.search(iters=opts["iters"],
                                   seed=opts["seed"],
                                   **_search_kw(opts))
    log(f"disagg decode search: {n} device(s), step "
        f"{info['best_time']:.3e}s ({info['speedup_vs_dp']:.2f}x vs dp)")
    return {
        "devices": n,
        "objective": "decode",
        "step_time_s": info["best_time"],
        "speedup_vs_dp": info["speedup_vs_dp"],
        "strategies": {name: {"dims": list(pc.dims),
                              "devices": list(pc.devices)}
                       for name, pc in strategy.items()},
    }


def _serve_block(opts, machine, model, strategy, info, cost_model, olog,
                 log) -> dict:
    """``__predicted__.serve`` (``flexflow_tpu/apps/search.py:204-240``):
    the engine reads ``forward_step_s`` (or its phase's ``step_time_s``)
    as its virtual step, the plan check charges
    ``kv_cache_bytes_per_device`` to the phase that holds the cache."""
    from flexflow_tpu_torch.serve.kv_cache import kv_cache_bytes

    serve = {
        "max_batch": opts["batch_size"],
        "kv_cache_bytes_per_device": kv_cache_bytes(
            model, opts["batch_size"], strategy=strategy),
        "forward_step_s": info["best_time"],
    }
    if opts["objective"] == "decode":
        serve["phase"] = "decode"
    if opts["disagg"]:
        # the main search is the prefill plan; the decode phase has its
        # own searched step on its own slice
        serve["phase"] = "prefill"
        serve["prefill"] = {"devices": machine.num_devices,
                            "objective": opts["objective"],
                            "step_time_s": info["best_time"]}
        serve["decode"] = _decode_companion_search(opts, cost_model, olog,
                                                   log)
    return serve


def _propose_pipeline(opts, machine, model, search, strategy, info,
                      result, multi_tier, log) -> dict:
    """The GPipe block (``flexflow_tpu/apps/search.py:595-640``):
    propose or reject it against the searched plan, with every
    candidate logged; ``result["pipeline"]``, and ``strategy.pipeline``
    when accepted.  NMT is left out (no NMT driver consumes the block)
    and so is the latency objective (GPipe schedules a training step).
    JAX audits an accepted block's compiled program before it writes
    it to a machine of several tiers; that audit is not ported.
    Returns the proposal with every candidate."""
    pp = search.propose_pipeline(
        log=log, reference_s=info["best_time"],
        stage_divisor=model.t.num_layers, batch=model.t.batch_size,
        tp_divisor=math.gcd(model.t.num_heads, model.t.d_ff))
    result["pipeline"] = {
        "accepted": pp["accepted"], "best": pp["best"],
        "reference_time_s": pp["reference_time_s"]}
    if not pp["accepted"]:
        return pp
    strategy.pipeline = pp["best"]
    audit = opts["audit"] if opts["audit"] is not None \
        else (bool(opts["out"]) and multi_tier)
    if audit:
        raise NotImplementedError(
            "an accepted __pipeline__ block on a machine of several "
            "tiers, where the JAX driver audits the pipelined program's "
            "collectives before writing it; the audit is not ported "
            "(ROADMAP Queue A item 7): pass --no-audit to write the "
            "simulated block as it is")
    return pp


def main(argv=None, log=print) -> dict:
    import time

    from flexflow_tpu_torch import obs as _obs
    from flexflow_tpu_torch.sim.search import StrategySearch

    argv = list(sys.argv[1:] if argv is None else argv)
    opts = parse_args(argv)
    machine = _machine(opts)
    model = build_model(opts["model"], machine, opts["batch_size"],
                        opts["dtype"], opts["experts"])
    if opts["model"].startswith("gpt-"):
        # the preset owns the batch
        opts["batch_size"] = model.t.batch_size
    cost_model = _cost_model(opts)

    meta = {"app": "search", "model": opts["model"],
            "devices": machine.num_devices, "iters": opts["iters"],
            "measured": opts["measured"], "seed": opts["seed"],
            "chains": opts["chains"], "delta": opts["delta"],
            "objective": opts["objective"],
            "decompose": opts["decompose"]}
    if opts["obs_dir"]:
        run_id = opts["run_id"] or _obs.new_run_id()
        olog = _obs.RunLog(
            os.path.join(opts["obs_dir"], f"{run_id}.jsonl"),
            run_id=run_id, surface="search", meta=meta)
    elif opts["out"]:
        # every saved strategy has its trajectory beside it
        trace_path = os.path.splitext(opts["out"])[0] + ".trace.jsonl"
        olog = _obs.RunLog(trace_path, run_id=opts["run_id"] or None,
                           surface="search", meta=meta)
    else:
        olog = _obs.NULL

    t0 = time.perf_counter()
    search = StrategySearch(model, machine, cost_model=cost_model,
                            obs=olog, objective=opts["objective"])
    build_s = time.perf_counter() - t0
    if opts["decompose"]:
        strategy, info = search.search_decomposed(
            iters=opts["iters"], seed=opts["seed"],
            delta=opts["delta"] != "off",
            block_budget_s=opts["block_budget_s"] or None,
            boundary_refine_iters=opts["boundary_refine_iters"])
    else:
        strategy, info = search.search(iters=opts["iters"],
                                       seed=opts["seed"],
                                       **_search_kw(opts))
    result = {
        "model": opts["model"],
        "objective": opts["objective"],
        "devices": machine.num_devices,
        "dp_time_s": info["dp_time"],
        "best_time_s": info["best_time"],
        "speedup_vs_dp": info["speedup_vs_dp"],
    }
    if opts["decompose"]:
        result.update({
            "metric": (f"{opts['model']}_decomposed_step_s_"
                       f"{machine.num_devices}dev"),
            "value": info["best_time"],
            "unit": "s",
            "vs_baseline": info["speedup_vs_dp"],
            "decomposed": True,
            "blocks": info["blocks"],
            "unique_blocks": info["unique_blocks"],
            "memo_hits": info["memo_hits"],
            "stitched_time_s": info["stitched_time"],
            "proposals_per_sec": info["proposals_per_sec"],
        })
    if opts["measured"]:
        result["measurement"] = {
            "device": str(cost_model.device), "protocol": cost_model.protocol,
            "shards_timed": cost_model.measured,
            "timed_s": cost_model.measure_s, "build_s": build_s,
            "estimated": cost_model.estimated,
            "cache_hits": cost_model.cache_hits,
            "anchors": cost_model.anchors()}
    multi_tier = machine.topology.devices_per_ici_group \
        < machine.num_devices
    if opts["audit"] is None and opts["out"] and multi_tier \
            and info["speedup_vs_dp"] > 1.05:
        raise NotImplementedError(
            f"the searched plan claims {info['speedup_vs_dp']:.2f}x on a "
            f"machine of several tiers, where the JAX driver audits the "
            f"compiled program before writing it; the audit is not "
            f"ported (ROADMAP Queue A item 7): pass --no-audit to write "
            f"the simulated plan as it is")
    if opts["measured"]:
        log(MEASURED_UNCHECKED)
    proposal = None   # the GPipe candidates, where they are priced
    if opts["model"] in ("transformer", "gpt", "bert") \
            and opts["objective"] == "makespan":
        proposal = _propose_pipeline(opts, machine, model, search,
                                     strategy, info, result, multi_tier,
                                     log)
    # the artifact carries its simulated prediction
    strategy.predicted = {
        "model": opts["model"], "devices": machine.num_devices,
        "dp_time_s": info["dp_time"], "best_time_s": info["best_time"],
        "speedup_vs_dp": info["speedup_vs_dp"],
        "cost_model": "measured" if opts["measured"] else "analytic",
        "batch_size": opts["batch_size"],
        "objective": opts["objective"],
    }
    if opts["serve"]:
        strategy.predicted["serve"] = _serve_block(
            opts, machine, model, strategy, info, cost_model, olog, log)
        result["serve"] = strategy.predicted["serve"]
    if opts["trace"]:
        result["trace_path"] = _write_sim_trace(opts, search, info, olog,
                                                log)
    if olog.enabled:
        result["run_id"] = olog.run_id
        result["obs_path"] = olog.path
    log(json.dumps(result))
    if opts["out"]:
        if strategy.pipeline and not opts["out"].endswith(".json"):
            # the proto2 wire format cannot carry the block: a JSON
            # sidecar carries the whole plan
            sidecar = opts["out"] + ".pipeline.json"
            strategy.save(sidecar)
            log(f"warning: {opts['out']} is proto format, which cannot "
                f"carry the accepted __pipeline__ block — full plan "
                f"written to {sidecar}")
        strategy.save(opts["out"])
        log(f"strategy written to {opts['out']}")
    olog.close()
    return {"strategy": strategy, "search": search, "proposal": proposal,
            **result}


if __name__ == "__main__":
    main()
