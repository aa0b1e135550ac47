"""Serving entry point (PyTorch port of ``flexflow_tpu/apps/serve.py``):
continuous-batching decode of the transformer LM on one card or over the
ranks ``torchrun`` starts, with the queue-driven autoscaler; the
disaggregated prefill/decode pools behind the router; and the batched
forward-only service of the CNNs and the NMT model.

    python -m flexflow_tpu_torch.apps.serve gpt --requests 16 \\
        --max-new-tokens 4 [--tiny] [--device cuda|cpu] [-obs-dir obs/]
    torchrun --nproc-per-node 2 -m flexflow_tpu_torch.apps.serve gpt \\
        --serve-idle-boundaries 3 --serve-queue-hi 3 --shrink-to 1
    python -m flexflow_tpu_torch.apps.serve gpt --serve-prefill-devices 2 \\
        --serve-prefill-replicas 2 --serve-decode-replicas 2
    python -m flexflow_tpu_torch.apps.serve densenet121 --requests 32 \\
        --max-batch 8 [-metrics-path m.prom] [--device cuda|cpu]
    python -m flexflow_tpu_torch.apps.serve nmt --requests 16

``gpt`` (also ``transformer`` / ``bert``, the same causal LM as in the JAX
app) is the GPT-2-small-width model: 12 layers, d_model 768, 12 heads,
d_ff 3072, vocab 32768, seq 512, batch 8; ``--tiny`` is the 2-layer
CPU-sized one.  Under ``torchrun`` (``WORLD_SIZE`` set) the LM serves
over the world's ranks (``distributed.initialize``), each rank holding
its blocks under ``-s/--strategy`` (data parallel without it); a
strategy file is vetted by the plan checker first (``verify/plan.py``,
exit 2 on an error finding).  ``--serve-idle-boundaries N`` shrinks the
world to ``--shrink-to`` ranks after N idle decode boundaries and
``--serve-queue-hi D`` grows it back at queue depth D, each resize
re-searched under the latency objective within 10 s and 2000 proposals
(``ServeEngine``; ``build_lm``'s ``research_budget_s`` and
``elastic_search_iters``).  A
parked rank stands by; when the run ends rank 0 releases it, and rank 0
alone prints the result.

``--serve-prefill-devices P`` (> 0) carves the cards this process sees
into a prefill pool of ``--serve-prefill-replicas`` replicas and a
decode pool of ``--serve-decode-replicas`` (:func:`_disagg_run`,
``serve/router.py``).  A replica is one card (with ``--device cpu``, the
CPU): a pool that gives a replica several cards is refused.

The CNNs (``apps.cnn``'s names: alexnet, vgg16, resnet101, densenet121,
inception_v3, ...) take 224x224 images (299x299 for Inception) and
``nmt`` is the JAX app's default NMT model; each request carries one
seeded random sample of the model's first input
(:func:`_forward_payloads`), the service pads them into ``--max-batch``
(default ``-b``, 8) rows and replies with each request's row of the loss
op's output (``ServeEngine.run_forward``), on one card.  The device
defaults to ``cuda`` and the run raises when CUDA is absent unless
``--device cpu`` is given.  float32 matrix products and convolutions run
in full float32 on the GPU: TF32 is switched off.

Drain contract: SIGTERM or SIGINT stops admission, the in-flight work
finishes, the requests not yet admitted are reported ``unserved`` (never
dropped), and the process exits 0.

stdout carries exactly one JSON line with the keys of the JAX app's
``_result_line`` (run_id, qps, p50_s, p99_s, resizes, requests,
completed, unserved, dropped, devices, drained); narration goes to
stderr.  ``-obs-dir`` streams the serve_request, serve_batch,
serve_resize and serve_summary records (and the router's); ``-metrics-path``
exports the ff_qps, ff_queue_depth, ff_latency_p50_s, ff_latency_p99_s
and ff_requests_total gauges (``obs/metrics.py``).  The JAX app's smokes
(``--smoke``, ``--disagg-smoke``, ``--chaos-smoke``) are not ported.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np
import torch

LM_MODELS = ("gpt", "transformer", "bert")
#: the forward-only service's models: apps.cnn's names and the NMT model
FORWARD_MODELS = ("alexnet", "vgg16", "vgg", "inception", "inception_v3",
                  "resnet101", "resnet", "densenet", "densenet121", "nmt")
#: ``--burst``'s tail: the virtual gap after the last request and its
#: rate (the JAX serve smoke's, ``flexflow_tpu/apps/serve.py:465-472``)
BURST_GAP_S, BURST_RATE_QPS = 30.0, 2000.0


def _err(*a, **kw):
    print(*a, file=sys.stderr, **kw)
    sys.stderr.flush()


def _quiet(*a, **kw):
    pass


#: the options that ``FFConfig`` parses (``config.SERVE_FIELDS``):
#: option -> its field
CONFIG_OPTS = {"max_batch": "max_batch", "queue_hi": "serve_queue_hi",
               "idle_boundaries": "serve_idle_boundaries",
               "prefill_devices": "serve_prefill_devices",
               "prefill_replicas": "serve_prefill_replicas",
               "decode_replicas": "serve_decode_replicas"}


def parse_args(argv) -> dict:
    """The app's options, with the keys of the JAX app's.  ``--max-batch``
    and the five ``--serve-*`` flags go to ``FFConfig.from_args``, the
    rest to this parser."""
    from flexflow_tpu_torch.config import SERVE_FIELDS, FFConfig, flag_stream

    serving, rest = [], []
    for a, take in flag_stream(argv):
        if a in SERVE_FIELDS:
            serving += [a, take()]
        else:
            rest.append(a)
    cfg = FFConfig.from_args(serving)
    ap = argparse.ArgumentParser(prog="flexflow_tpu_torch.apps.serve")
    ap.add_argument("model", nargs="?", default="gpt")
    ap.add_argument("-b", "--batch-size", type=int, default=8)
    ap.add_argument("-n", "--requests", type=int, default=16)
    ap.add_argument("--rate-qps", type=float, default=100.0)
    ap.add_argument("--max-new-tokens", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=4)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("-s", "--strategy", default="")
    ap.add_argument("--dtype", default="float32",
                    choices=("float32", "bfloat16"))
    ap.add_argument("--shrink-to", type=int, default=0)
    ap.add_argument("--burst", type=int, default=0)
    ap.add_argument("-obs-dir", "--obs-dir", dest="obs_dir", default="")
    ap.add_argument("-run-id", "--run-id", dest="run_id", default="")
    ap.add_argument("-metrics-path", "--metrics-path", dest="metrics_path",
                    default="")
    ap.add_argument("--step-time-s", type=float, default=0.0)
    ap.add_argument("--tiny", action="store_true")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--dist-backend", default=None)
    ap.add_argument("--result-json", default="")
    opts = vars(ap.parse_args(rest))
    opts.update({k: getattr(cfg, f) for k, f in CONFIG_OPTS.items()})
    return opts


def build_lm(*, batch, seed=0, dtype="float32", strategies=None,
             tiny=False, device="cuda", machine=None,
             research_budget_s=10.0, elastic_search_iters=2000):
    """``(model, rebuild)``: the serving TransformerLM at the JAX app's
    widths (``tiny``: the 2-layer smoke geometry) on ``machine`` (default
    one process on ``device``), and the factory that rebuilds it on a
    resized machine under a re-searched strategy
    (``flexflow_tpu/apps/serve.py:126-147``)."""
    from flexflow_tpu_torch.models.transformer import (TransformerConfig,
                                                       TransformerLM)

    kw = dict(batch_size=batch, causal=True, seed=seed, compute_dtype=dtype,
              research_budget_s=research_budget_s,
              elastic_search_iters=elastic_search_iters)
    if tiny:
        kw.update(seq_length=16, num_layers=2, d_model=32, num_heads=4,
                  d_ff=128, vocab_size=64)
    cfg_t = TransformerConfig(**kw)
    model = TransformerLM(cfg_t, machine, strategies=strategies,
                          device=device)

    def rebuild(ff_cfg, m):
        return TransformerLM(cfg_t, m, ff_cfg.strategies)

    return model, rebuild


def _build_forward(name, batch, dtype="float32", device="cuda"):
    """A CNN or the NMT model for the forward-only service
    (``flexflow_tpu/apps/serve.py:151-172``): the CNNs at 224x224 (299 for
    Inception), the NMT at the JAX driver's defaults."""
    from flexflow_tpu_torch.machine import MachineModel

    machine = MachineModel(device)
    if name == "nmt":
        from flexflow_tpu_torch.nmt.rnn_model import RnnConfig, RnnModel

        return RnnModel(RnnConfig(batch_size=batch, compute_dtype=dtype),
                        machine)
    from flexflow_tpu_torch.apps.cnn import build
    from flexflow_tpu_torch.config import FFConfig

    size = 299 if name.startswith("inception") else 224
    cfg = FFConfig(batch_size=batch, input_height=size, input_width=size,
                   compute_dtype=dtype)
    return build(name, cfg, machine)


def _forward_payloads(model, requests, seed):
    """Give each request one sample of the model's first input in place of
    its token prompt (``flexflow_tpu/apps/serve.py:175-190``): uniform
    images in [-1, 1) for a CNN, token rows in [2, 64) for the NMT, from
    one generator seeded with ``seed``."""
    in0 = model._inputs[0]
    shape = tuple(int(d) for d in in0.shape[1:])
    rng = np.random.RandomState(seed)
    for r in requests:
        if np.issubdtype(np.dtype(in0.dtype), np.integer):
            r.tokens = rng.randint(2, 64, size=shape).astype(in0.dtype)
        else:
            r.tokens = rng.uniform(-1.0, 1.0, size=shape).astype(in0.dtype)
    return requests


def _strategies(opts):
    from flexflow_tpu_torch.strategy import Strategy

    return Strategy.load(opts["strategy"]) if opts["strategy"] else None


def _lm_kwargs(opts) -> dict:
    return dict(seed=opts["seed"], dtype=opts["dtype"], tiny=opts["tiny"])


def _check(opts, strategies, machine, batch, label) -> None:
    """The plan check of a serving strategy (``flexflow_tpu/apps/
    serve.py:385-389``), on a shadow LM built without it on a virtual
    machine of ``machine``'s size: exit 2 on an error finding."""
    from flexflow_tpu_torch.apps.cnn import check_strategy

    check_strategy(
        lambda m: build_lm(batch=batch, machine=m, **_lm_kwargs(opts))[0],
        strategies, machine, False, label)


def _olog_metrics(opts, device, rank=0):
    """The run's obs sink and metrics exporter (rank 0's; the disabled
    sink and None on the other ranks)."""
    from flexflow_tpu_torch import obs
    from flexflow_tpu_torch.obs.metrics import MetricsExporter

    if rank != 0:
        return obs.NULL, None
    meta = {"app": "serve", "model": opts["model"],
            "requests": opts["requests"], "seed": opts["seed"]}
    if opts["obs_dir"]:
        run_id = opts["run_id"] or obs.new_run_id()
        olog = obs.RunLog(
            os.path.join(opts["obs_dir"], f"{run_id}.jsonl"),
            run_id=run_id, surface="serve",
            meta=dict(meta, device=str(device)))
    else:
        olog = obs.NULL
    metrics = MetricsExporter(opts["metrics_path"], meta=meta) \
        if opts["metrics_path"] else None
    return olog, metrics


def _requests(opts, vocab):
    """The seeded load: ``--requests`` at ``--rate-qps``, then with
    ``--burst N`` the JAX serve smoke's gap-then-burst tail: N more,
    ``BURST_GAP_S`` virtual seconds after the last, at ``BURST_RATE_QPS``
    from seed + 1, their rids from 100."""
    from flexflow_tpu_torch.serve.loadgen import synthetic_requests

    kw = dict(vocab_size=vocab, prompt_len=opts["prompt_len"],
              max_new_tokens=opts["max_new_tokens"])
    reqs = synthetic_requests(opts["requests"], seed=opts["seed"],
                              rate_qps=opts["rate_qps"], **kw)
    if opts["burst"] > 0:
        if len(reqs) > 100:
            raise SystemExit("--burst: the burst's rids start at 100; "
                             "give at most 100 --requests")
        burst = synthetic_requests(
            opts["burst"], seed=opts["seed"] + 1, rate_qps=BURST_RATE_QPS,
            start_v=(reqs[-1].arrival_v if reqs else 0.0) + BURST_GAP_S,
            **kw)
        for i, r in enumerate(burst):
            r.rid = 100 + i
        reqs += burst
    return reqs


def machine_for(opts):
    """The run's machine: the world of ranks under ``torchrun``
    (``WORLD_SIZE`` set), else this one process on ``--device``."""
    from flexflow_tpu_torch.apps.cnn import machine_for as world

    return world(opts["device"], opts["dist_backend"])


def build_engine(opts, log=_err, machine=None):
    """(engine, requests, olog, forward) for one single-pool serving run:
    the model at its full widths on ``machine`` (default: the world
    ``torchrun`` started, else ``opts["device"]``), random weights from
    ``opts["seed"]``, the seeded synthetic load, and whether the model
    takes the forward-only service."""
    from flexflow_tpu_torch.serve.engine import ServeEngine

    name = opts["model"]
    if name not in LM_MODELS + FORWARD_MODELS:
        raise SystemExit(f"model {name!r} is not ported yet (serving "
                         f"supports {', '.join(LM_MODELS + FORWARD_MODELS)})")
    forward = name in FORWARD_MODELS
    machine = machine if machine is not None else machine_for(opts)
    device = machine.device
    if device.type == "cuda":
        # a float32 reference runs its products in float32, not TF32
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    batch = opts["max_batch"] or opts["batch_size"]
    rebuild = None
    if forward:
        if opts["strategy"] or machine.num_devices > 1:
            raise SystemExit("-s/--strategy and torchrun: the forward-only "
                             "service runs on one device in the port")
        model = _build_forward(name, batch, opts["dtype"], device)
    else:
        strategies = _strategies(opts)
        if strategies is not None:
            _check(opts, strategies, machine, batch,
                   os.path.basename(opts["strategy"]))
        model, rebuild = build_lm(batch=batch, strategies=strategies,
                                  machine=machine, **_lm_kwargs(opts))
    olog, metrics = _olog_metrics(opts, device, machine.rank)
    engine = ServeEngine(model, rebuild, olog=olog, metrics=metrics,
                         log=log, step_time_s=opts["step_time_s"] or None,
                         queue_hi=opts["queue_hi"],
                         idle_boundaries=opts["idle_boundaries"],
                         shrink_to=opts["shrink_to"])
    requests = _requests(opts, getattr(getattr(model, "t", None),
                                       "vocab_size", 64))
    if forward:
        _forward_payloads(model, requests, opts["seed"])
    return engine, requests, olog, forward


def _decode_pool_strategy(strategies, dbatch):
    """The decode pool's plan from a disaggregated search artifact's inline
    ``serve.decode.strategies`` mapping, marked as a decode-phase artifact
    so that the plan check charges the KV ring to this pool
    (``flexflow_tpu/apps/serve.py:229-255``); None when there is none."""
    from flexflow_tpu_torch.strategy import ParallelConfig, Strategy

    serve = (getattr(strategies, "predicted", None) or {}).get("serve") \
        or {}
    dec = serve.get("decode") or {}
    if not dec.get("strategies"):
        return None
    out = Strategy({
        name: ParallelConfig(dims=tuple(int(d) for d in e["dims"]),
                             devices=tuple(int(d) for d in e["devices"]))
        for name, e in dec["strategies"].items()})
    out.predicted = {
        "objective": "decode",
        "serve": {"phase": "decode", "max_batch": dbatch,
                  "decode": {k: dec[k] for k in ("step_time_s", "devices")
                             if k in dec}},
    }
    return out


def pool_devices(opts) -> list:
    """The devices the pools are carved from: every card this process
    sees, or with ``--device cpu`` the CPU once per replica."""
    if torch.device(opts["device"]).type == "cpu":
        return ["cpu"] * (opts["prefill_devices"]
                          + max(1, opts["decode_replicas"]))
    from flexflow_tpu_torch.machine import resolve_device

    resolve_device(opts["device"])   # raises without CUDA
    return [f"cuda:{i}" for i in range(torch.cuda.device_count())]


def _disagg_run(opts, devices, olog, metrics, log,
                drain=None) -> dict:
    """Disaggregated serving (``flexflow_tpu/apps/serve.py:258-346``): the
    first ``--serve-prefill-devices`` of ``devices`` become the prefill
    pool, the rest the decode pool, each pool split evenly into its
    replicas; each phase's plan is vetted; the router serves the seeded
    load under the drain contract.  A replica is one device, a one-rank
    ``MachineModel`` in this process: a split that gives a replica
    several is refused (a replica over ranks would need the router to
    drive other processes' worlds)."""
    from flexflow_tpu_torch.machine import MachineModel
    from flexflow_tpu_torch.serve.engine import (DEFAULT_STEP_TIME_S,
                                                 ServeEngine)
    from flexflow_tpu_torch.serve.router import ServeRouter
    from flexflow_tpu_torch.sim.search import decode_step_ratio
    from flexflow_tpu_torch.utils.elastic import drain_scope

    n = len(devices)
    p = opts["prefill_devices"]
    pr, dr = max(1, opts["prefill_replicas"]), \
        max(1, opts["decode_replicas"])
    if not (0 < p < n):
        raise SystemExit(f"--serve-prefill-devices must split the "
                         f"{n}-device pool, got {p}")
    if p % pr or (n - p) % dr:
        raise SystemExit(f"pools must split evenly: {p} prefill "
                         f"device(s) / {pr} replica(s), {n - p} decode "
                         f"device(s) / {dr} replica(s)")
    if opts["model"] not in LM_MODELS:
        raise SystemExit("disaggregated serving needs an autoregressive "
                         "LM (transformer/gpt/bert)")
    per, dper = p // pr, (n - p) // dr
    if per > 1 or dper > 1:
        raise SystemExit(
            f"a replica of several devices ({per} per prefill replica, "
            f"{dper} per decode replica) is not ported: a replica is one "
            f"card in flexflow_tpu_torch; give each replica one")
    strategies = _strategies(opts)
    if strategies is not None:
        span = max((max(pc.devices) for pc in strategies.values()
                    if getattr(pc, "devices", None)), default=-1) + 1
        if span > per:
            raise SystemExit(
                f"prefill plan spans {span} device(s) but each of the "
                f"{pr} prefill replica(s) has {per}: search the prefill "
                f"phase at the per-replica slice")
    batch = max(1, opts["batch_size"])
    base_step = opts["step_time_s"] or DEFAULT_STEP_TIME_S
    label = os.path.basename(opts["strategy"])
    prefill = []
    for j in range(pr):
        m = MachineModel(devices[j])
        model, _ = build_lm(batch=batch, strategies=strategies, machine=m,
                            **_lm_kwargs(opts))
        if strategies is not None and j == 0:
            _check(opts, strategies, m, batch, label)
        prefill.append(ServeEngine(
            model, None, olog=olog, metrics=metrics, log=log,
            step_time_s=opts["step_time_s"] or None, phase="prefill"))
    dstrat = _decode_pool_strategy(strategies, batch)
    if dstrat is not None:
        span = max((max(pc.devices) for pc in dstrat.values()
                    if getattr(pc, "devices", None)), default=-1) + 1
        if span > dper:
            raise SystemExit(
                f"decode plan spans {span} device(s) but each of the "
                f"{dr} decode replica(s) has {dper}")
    decode = []
    for j in range(dr):
        m = MachineModel(devices[p + j])
        model, _ = build_lm(batch=batch, strategies=dstrat, machine=m,
                            **_lm_kwargs(opts))
        if dstrat is not None and j == 0:
            _check(opts, dstrat, m, batch, f"{label}[decode]")
        step = None if dstrat is not None and opts["step_time_s"] == 0 \
            else base_step * decode_step_ratio(model)
        decode.append(ServeEngine(
            model, None, olog=olog, metrics=metrics, log=log,
            step_time_s=step, phase="decode"))
    router = ServeRouter(prefill, decode, olog=olog, metrics=metrics,
                         log=log)
    requests = _requests(opts, prefill[0].model.t.vocab_size)
    if drain is not None:
        return router.run(requests, drain=drain)
    with drain_scope(log=log) as d:
        return router.run(requests, drain=d)


def serve_run(opts, log=_err) -> dict:
    """One serving run under the drain handler (SIGTERM/SIGINT stop
    admission); returns the summary (rank 0's is the run's) with the
    run's obs sink under ``"_olog"`` (the caller prints the line)."""
    from flexflow_tpu_torch.utils import elastic

    if opts["prefill_devices"] > 0:
        if "WORLD_SIZE" in os.environ:
            raise SystemExit("the disaggregated pools run in one process "
                             "(a replica per card), not under torchrun")
        olog, metrics = _olog_metrics(opts, opts["device"])
        try:
            summary = _disagg_run(opts, pool_devices(opts), olog, metrics,
                                  log)
        finally:
            olog.close()
        summary["_olog"] = olog
        return summary
    machine = machine_for(opts)
    if machine.rank != 0:
        log = _quiet
    engine, requests, olog, forward = build_engine(opts, log, machine)
    try:
        with elastic.drain_scope(log=log) as drain:
            if forward:
                summary = engine.run_forward(requests, drain=drain)
                done = []
            else:
                engine.start(requests, drain=drain)
                while engine.step_once():
                    pass
                # this rank's session: after a grow a returning rank's
                # requests are rank 0's
                done = engine.session_completed()
                summary = engine.finish()
        if engine._parked and engine.model.machine.rank == 0:
            # the ranks still parked leave their standby
            elastic.release_standbys(engine._parked,
                                     {"devices": summary["devices"]})
    finally:
        olog.close()
    if opts["result_json"]:
        _write_result(opts["result_json"], summary, engine, done,
                      machine.rank)
    summary["_olog"] = olog
    summary["_rank"] = machine.rank   # in the world torchrun started
    return summary


def _write_result(path, summary, engine, done, rank) -> None:
    """One rank's run: its summary, each completed request's reply (by
    rid; the decode service's alone), the resizes, whether it ended
    parked and the kernel launches, to ``path`` on rank 0 and
    ``path.rank<r>`` on rank r (first-world ranks)."""
    from flexflow_tpu_torch.ops import kernels

    res = {"summary": summary, "resizes": engine.resizes,
           "out_of_service": engine.out_of_service,
           "launches": dict(kernels.launches),
           "replies": {str(r.rid): [int(t) for t in r.reply]
                       for r in done}}
    if rank:
        path = f"{path}.rank{rank}"
    with open(path, "w") as f:
        json.dump(res, f)


def _result_line(summary, olog) -> str:
    """The one stdout JSON line, with the JAX app's keys."""
    rec = {
        "run_id": olog.run_id if olog.enabled else None,
        "qps": summary["qps"],
        "p50_s": summary["p50_s"],
        "p99_s": summary["p99_s"],
        "resizes": summary["resizes"],
        "requests": summary["requests"],
        "completed": summary["completed"],
        "unserved": summary["unserved"],
        "dropped": summary["dropped"],
        "devices": summary["devices"],
        "drained": summary["drained"],
    }
    return json.dumps(rec)


def main(argv=None, log=_err) -> int:
    opts = parse_args(sys.argv[1:] if argv is None else argv)
    summary = serve_run(opts, log)
    if summary.pop("_rank", 0) == 0:
        print(_result_line(summary, summary.pop("_olog")))
    return 0


if __name__ == "__main__":
    from flexflow_tpu_torch import distributed as _dist

    rc = main()
    _dist.shutdown()
    sys.exit(rc)
