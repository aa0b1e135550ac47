"""Serving entry point (PyTorch port of ``flexflow_tpu/apps/serve.py``):
continuous-batching decode of the transformer LM on one card or over the
ranks ``torchrun`` starts, with the queue-driven autoscaler; the
disaggregated prefill/decode pools behind the router, a replica one card
or a slice of ``torchrun``'s ranks; and the batched forward-only service
of the CNNs and the NMT model, on one card or over the ranks.

    python -m flexflow_tpu_torch.apps.serve gpt --requests 16 \\
        --max-new-tokens 4 [--tiny] [--device cuda|cpu] [-obs-dir obs/]
    torchrun --nproc-per-node 2 -m flexflow_tpu_torch.apps.serve gpt \\
        --serve-idle-boundaries 3 --serve-queue-hi 3 --shrink-to 1
    python -m flexflow_tpu_torch.apps.serve gpt --serve-prefill-devices 2 \\
        --serve-prefill-replicas 2 --serve-decode-replicas 2
    torchrun --nproc-per-node 4 -m flexflow_tpu_torch.apps.serve gpt \\
        --serve-prefill-devices 2 --serve-prefill-replicas 1 \\
        --serve-decode-replicas 1 [--pattern session] [-fault-spec SPEC]
    python -m flexflow_tpu_torch.apps.serve densenet121 --requests 32 \\
        --max-batch 8 [-metrics-path m.prom] [--device cuda|cpu]
    torchrun --nproc-per-node 4 -m flexflow_tpu_torch.apps.serve \\
        densenet121 [-s strategy.json]
    torchrun --nproc-per-node 2 -m flexflow_tpu_torch.apps.serve nmt \\
        [--pipeline-stages 2]

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

``--serve-prefill-devices P`` (> 0) carves the devices into a prefill
pool of the first P and a decode pool of the rest, each split evenly
into ``--serve-prefill-replicas`` and ``--serve-decode-replicas``
replicas (:func:`_disagg_run`, ``serve/router.py``).  Under ``torchrun``
the devices are the world's ranks and a replica is a slice of them of
any width, its model sharded over them (data parallel, or the plan of
``-s``), the router running on every rank (``serve/replicas.py``).  In
one process a replica is one card this process sees (with ``--device
cpu``, the CPU), and a split that gives a replica several is refused:
one process drives one card.  ``--pattern`` draws the load from
``loadgen.patterned_requests`` (``session``: multi-turn sessions) in
place of the Poisson ``synthetic_requests``, and ``-fault-spec`` installs
a seeded fault injector (``replica_crash``, ``handoff_drop``,
``kv_corrupt``, ...) on every rank for the run.

The CNNs (``apps.cnn``'s names: alexnet, vgg16, resnet101, densenet121,
inception_v3, ...) take 224x224 images (299x299 for Inception) and
``nmt`` is the JAX app's default NMT model; each request carries one
seeded random sample of the model's first input
(:func:`_forward_payloads`), the service pads them into ``--max-batch``
(default ``-b``, 8) rows and replies with each request's row of the loss
op's output (``ServeEngine.run_forward``).  Under ``torchrun`` the model
runs over the world's ranks, each staging its rows of each batch and
the output assembled on every rank; ``-s`` names a strategy file, vetted
by the plan checker first (exit 2 on an error finding), and for the NMT
``--pipeline-stages S`` takes ``pipeline_stage_strategy`` (the default
is the reference's ``default_global_config``).  The device defaults to
``cuda`` and the run raises when CUDA is absent unless ``--device cpu``
is given.  float32 matrix products and convolutions run in full float32
on the GPU: TF32 is switched off.

Drain contract: SIGTERM or SIGINT stops admission, the in-flight work
finishes, the requests not yet admitted are reported ``unserved`` (never
dropped), and the process exits 0.

stdout carries exactly one JSON line with the keys of the JAX app's
``_result_line`` (run_id, qps, p50_s, p99_s, resizes, requests,
completed, unserved, dropped, devices, drained); narration goes to
stderr.  ``-obs-dir`` streams the serve_request, serve_batch,
serve_resize and serve_summary records (and the router's); ``-metrics-path``
exports the ff_qps, ff_queue_depth, ff_latency_p50_s, ff_latency_p99_s
and ff_requests_total gauges (``obs/metrics.py``); ``python -m
flexflow_tpu_torch.apps.report serve <obs_dir>`` renders them.

The JAX app's three smokes, at its tiny 2-layer geometry, slots, loads
and step times, each passing its own checks and ending in ``report
serve`` and a validated ``serve_trace_events`` trace:

    torchrun --nproc-per-node 2 -m flexflow_tpu_torch.apps.serve --smoke
    python -m flexflow_tpu_torch.apps.serve --disagg-smoke [--device cpu]
    python -m flexflow_tpu_torch.apps.serve --chaos-smoke [--device cpu]

``--smoke``: five requests through 8 slots and through 1 reply alike
(on rank 0), then a gap-then-burst load autoscales the world
``torchrun`` started (at least 2 ranks) down to ``3 * world // 4`` and
back, 46 completed.  ``--disagg-smoke``: two prefill replicas and one
decode replica serve a multi-turn load with the single pool's replies,
then drain mid-run.  ``--chaos-smoke``: the resilience stack armed but
idle is inert, then ``CHAOS_SMOKE_SPEC`` kills a decode replica and
drops a KV transfer and every request still completes alike.  A
replica is one card, priced at the JAX smoke's width
(:func:`_tiny_engine`, :func:`pool_step_ratio`).
"""

from __future__ import annotations

import argparse
import json
import math
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


#: ``--help``'s description: the forms the app serves
USAGE = """\
forms:
  gpt [--tiny] [-s plan.json]                 the LM, one card or torchrun's
                                              ranks, with the autoscaler
                                              (--serve-idle-boundaries N
                                              --serve-queue-hi D --shrink-to R)
  gpt --serve-prefill-devices P --serve-prefill-replicas A
      --serve-decode-replicas B               routed prefill/decode pools: a
                                              replica one card in one process,
                                              or under torchrun a slice of the
                                              world's ranks of any width
  densenet121|resnet101|vgg16|alexnet|inception_v3|nmt [-s plan.json]
      [--max-batch 8]                         the forward-only service, one
                                              card or torchrun's ranks (the
                                              NMT: --pipeline-stages S)
  --smoke | --disagg-smoke | --chaos-smoke    the JAX app's smokes
"""

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
    ap = argparse.ArgumentParser(
        prog="flexflow_tpu_torch.apps.serve",
        formatter_class=argparse.RawDescriptionHelpFormatter,
        description=USAGE)
    ap.add_argument("model", nargs="?", default="gpt")
    ap.add_argument("-b", "--batch-size", type=int, default=8)
    ap.add_argument("-n", "--requests", type=int, default=16)
    ap.add_argument("--rate-qps", type=float, default=100.0)
    ap.add_argument("--max-new-tokens", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=4)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("-s", "--strategy", default="")
    ap.add_argument("--pipeline-stages", dest="pipeline_stages", type=int,
                    default=0, help="the NMT's LSTM layers on S device "
                    "blocks (pipeline_stage_strategy)")
    ap.add_argument("--pattern", default="",
                    help="loadgen.patterned_requests' arrival pattern "
                    "(e.g. session) in place of the Poisson load")
    ap.add_argument("-fault-spec", "--fault-spec", dest="fault_spec",
                    default="", help="a seeded fault injector for the "
                    "routed pools (replica_crash@3,handoff_drop@5, ...)")
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
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--disagg-smoke", dest="disagg_smoke",
                    action="store_true")
    ap.add_argument("--chaos-smoke", dest="chaos_smoke",
                    action="store_true")
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


def _build_forward(name, batch, dtype, machine, strategies=None):
    """A CNN or the NMT model for the forward-only service on ``machine``
    with the strategy passed at construction
    (``flexflow_tpu/apps/serve.py:150-172``): the CNNs at 224x224 (299
    for Inception), the NMT at the JAX driver's defaults (its default
    strategy ``default_global_config``)."""
    if name == "nmt":
        from flexflow_tpu_torch.nmt.rnn_model import RnnConfig, RnnModel

        return RnnModel(RnnConfig(batch_size=batch, compute_dtype=dtype),
                        machine, strategies)
    from flexflow_tpu_torch.apps.cnn import build
    from flexflow_tpu_torch.config import FFConfig

    size = 299 if name.startswith("inception") else 224
    cfg = FFConfig(batch_size=batch, input_height=size, input_width=size,
                   compute_dtype=dtype)
    if strategies is not None:
        cfg.strategies = strategies
    return build(name, cfg, machine)


def _forward_strategies(opts, machine, batch):
    """The forward service's strategy: ``-s``'s file, vetted first (exit
    2 on an error finding), or for the NMT ``--pipeline-stages``'s
    ``pipeline_stage_strategy`` (``apps.nmt``'s); None for the default."""
    name = opts["model"]
    if opts["pipeline_stages"]:
        if name != "nmt" or opts["strategy"]:
            raise SystemExit("--pipeline-stages places the NMT's LSTM "
                             "layers (apps.nmt's pipeline_stage_strategy); "
                             "give it for nmt, without -s")
        from flexflow_tpu_torch.nmt.rnn_model import (
            RnnConfig, pipeline_stage_strategy)

        return pipeline_stage_strategy(
            RnnConfig(batch_size=batch, compute_dtype=opts["dtype"]),
            machine, opts["pipeline_stages"])
    strategies = _strategies(opts)
    if strategies is not None:
        # the shadow is built without the file (the NMT's under its
        # default strategy, whose pinned embeds are placements)
        _check(opts, strategies, machine, batch,
               os.path.basename(opts["strategy"]),
               shadow=lambda m: _build_forward(name, batch, opts["dtype"],
                                               m))
    return strategies


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


def _check(opts, strategies, machine, batch, label, shadow=None) -> None:
    """The plan check of a serving strategy (``flexflow_tpu/apps/
    serve.py:385-389``), on a shadow model built without it on a virtual
    machine of ``machine``'s size (``shadow(machine)``; default the LM):
    exit 2 on an error finding."""
    from flexflow_tpu_torch.apps.cnn import check_strategy

    if shadow is None:
        def shadow(m):
            return build_lm(batch=batch, machine=m, **_lm_kwargs(opts))[0]
    check_strategy(shadow, strategies, machine, False, label)


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
    """The seeded load: ``--requests`` at ``--rate-qps`` (with
    ``--pattern``, ``loadgen.patterned_requests`` of that pattern), then
    with ``--burst N`` the JAX serve smoke's gap-then-burst tail: N more,
    ``BURST_GAP_S`` virtual seconds after the last, at ``BURST_RATE_QPS``
    from seed + 1, their rids from 100."""
    from flexflow_tpu_torch.serve.loadgen import (patterned_requests,
                                                  synthetic_requests)

    kw = dict(vocab_size=vocab, prompt_len=opts["prompt_len"],
              max_new_tokens=opts["max_new_tokens"])
    if opts["pattern"]:
        reqs = patterned_requests(opts["requests"], seed=opts["seed"],
                                  rate_qps=opts["rate_qps"],
                                  pattern=opts["pattern"], **kw)
    else:
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
        model = _build_forward(name, batch, opts["dtype"], machine,
                               _forward_strategies(opts, machine, batch))
    else:
        if opts["pipeline_stages"]:
            raise SystemExit("--pipeline-stages places the NMT's LSTM "
                             "layers; the LM serves under -s")
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


def _replica_pools(opts, devices, olog, metrics, log, world=None):
    """``(prefill, decode, seats, ranks)``: the engines of the
    disaggregated pools (``flexflow_tpu/apps/serve.py:258-336``).  The
    first ``--serve-prefill-devices`` devices become the prefill pool,
    the rest the decode pool, each pool split evenly into its replicas
    (``ranks``: each replica's device ordinals); each phase's plan is
    vetted on its replica 0.  ``world`` (the world ``torchrun`` started)
    carves its ranks by ordinal, as JAX carves its mesh: a replica is a
    running slice of them of any width (``MachineModel.running_slice``),
    every replica's model set up on every rank in replica order, and
    ``seats`` (a ``serve.replicas.ReplicaWorld``) places them.  Without
    it a replica is one of ``devices`` in this process (``seats`` None),
    and a split that gives a replica several is refused."""
    from flexflow_tpu_torch.machine import MachineModel
    from flexflow_tpu_torch.serve.engine import (DEFAULT_STEP_TIME_S,
                                                 ServeEngine)
    from flexflow_tpu_torch.serve.replicas import ReplicaWorld
    from flexflow_tpu_torch.sim.search import decode_step_ratio

    n = world.num_devices if world is not None else len(devices)
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
    if world is None and (per > 1 or dper > 1):
        raise SystemExit(
            f"a replica of several devices ({per} per prefill replica, "
            f"{dper} per decode replica) runs over ranks: one process "
            f"drives one card, so start the pools under torchrun "
            f"(torchrun --nproc-per-node {n} -m "
            f"flexflow_tpu_torch.apps.serve ...)")
    strategies = _strategies(opts)
    if strategies is not None:
        span = max((max(pc.devices) for pc in strategies.values()
                    if getattr(pc, "devices", None)), default=-1) + 1
        if span > per:
            raise SystemExit(
                f"prefill plan spans {span} device(s) but each of the "
                f"{pr} prefill replica(s) has {per}: search the prefill "
                f"phase at the per-replica slice (apps/search --devices "
                f"{per} --serve --disagg {n - p})")
    batch = max(1, opts["batch_size"])
    dstrat = _decode_pool_strategy(strategies, batch)
    if dstrat is not None:
        span = max((max(pc.devices) for pc in dstrat.values()
                    if getattr(pc, "devices", None)), default=-1) + 1
        if span > dper:
            raise SystemExit(
                f"decode plan spans {span} device(s) but each of the "
                f"{dr} decode replica(s) has {dper}: search the decode "
                f"companion at the per-replica slice (apps/search "
                f"--serve --disagg {dper})")
    ranks = [tuple(range(j * per, (j + 1) * per)) for j in range(pr)] \
        + [tuple(range(p + j * dper, p + (j + 1) * dper))
           for j in range(dr)]
    label = os.path.basename(opts["strategy"])
    models = []
    for k, rr in enumerate(ranks):
        plan = dstrat if k >= pr else strategies
        m = world.running_slice(rr) if world is not None \
            else MachineModel(devices[rr[0]])
        model, _ = build_lm(batch=batch, strategies=plan, machine=m,
                            **_lm_kwargs(opts))
        if m.num_devices > 1:
            # this replica's groups, on every rank, before any replica runs
            model._setup_sharded()
        models.append(model)
        if plan is not None and k in (0, pr):
            _check(opts, plan, m, batch,
                   f"{label}[decode]" if k >= pr else label)
    seats = ReplicaWorld(world, ranks[:pr], ranks[pr:]) \
        if world is not None else None
    base_step = opts["step_time_s"] or DEFAULT_STEP_TIME_S
    prefill = [ServeEngine(
        model, None, olog=olog, metrics=metrics, log=log,
        step_time_s=opts["step_time_s"] or None, phase="prefill",
        seat=seats.prefill[k] if seats else None)
        for k, model in enumerate(models[:pr])]
    decode = []
    for k, model in enumerate(models[pr:]):
        # the decode replica's own model at its width prices its step
        step = None if dstrat is not None and opts["step_time_s"] == 0 \
            else base_step * decode_step_ratio(model)
        decode.append(ServeEngine(
            model, None, olog=olog, metrics=metrics, log=log,
            step_time_s=step, phase="decode",
            seat=seats.decode[k] if seats else None))
    return prefill, decode, seats, ranks


def _disagg_run(opts, devices, olog, metrics, log, drain=None,
                world=None) -> dict:
    """Disaggregated serving (``flexflow_tpu/apps/serve.py:258-346``):
    the pools of :func:`_replica_pools` behind the router, serving the
    seeded load under the drain contract (and ``-fault-spec``'s
    injector).  Returns the router's summary, with the requests under
    ``"_requests"`` and each replica's forward steps and their wall
    seconds under ``"_replicas"``."""
    from flexflow_tpu_torch.serve.router import ServeRouter
    from flexflow_tpu_torch.utils import faultinject
    from flexflow_tpu_torch.utils.elastic import drain_scope

    prefill, decode, seats, ranks = _replica_pools(opts, devices, olog,
                                                   metrics, log, world)
    router = ServeRouter(prefill, decode, olog=olog, metrics=metrics,
                         log=log, world=seats)
    requests = _requests(opts, prefill[0].model.t.vocab_size)
    restore = faultinject.install_scoped(faultinject.FaultInjector(
        opts["fault_spec"], olog=olog)) if opts["fault_spec"] \
        else (lambda: None)
    try:
        if drain is not None:
            summary = router.run(requests, drain=drain)
        else:
            with drain_scope(log=log) as d:
                summary = router.run(requests, drain=d)
    finally:
        restore()
    summary["_requests"] = requests
    summary["_replicas"] = [
        {"phase": eng.phase, "index": k if k < len(prefill)
         else k - len(prefill), "ranks": list(rr), "runs": eng.runs,
         "steps": eng.forward_steps, "busy_s": eng.busy_s,
         "step_time_s": eng.step_time_s}
        for k, (eng, rr) in enumerate(zip(prefill + decode, ranks))]
    return summary


def serve_run(opts, log=_err) -> dict:
    """One serving run under the drain handler (SIGTERM/SIGINT stop
    admission); returns the summary (rank 0's is the run's) with the
    run's obs sink under ``"_olog"`` (the caller prints the line)."""
    from flexflow_tpu_torch.utils import elastic

    if opts["prefill_devices"] > 0:
        world = machine_for(opts) if "WORLD_SIZE" in os.environ else None
        rank = world.rank if world is not None else 0
        if rank != 0:
            log = _quiet
        olog, metrics = _olog_metrics(
            opts, world.device if world is not None else opts["device"],
            rank)
        try:
            summary = _disagg_run(
                opts, pool_devices(opts) if world is None else None, olog,
                metrics, log, world=world)
        finally:
            olog.close()
        done = [r for r in summary.pop("_requests") if r.reply is not None]
        if opts["result_json"]:
            _write_result(opts["result_json"], summary, None, done, rank,
                          summary.get("_replicas"))
        summary["_olog"] = olog
        summary["_rank"] = rank
        return summary
    machine = machine_for(opts)
    if machine.rank != 0:
        log = _quiet
    engine, requests, olog, forward = build_engine(opts, log, machine)
    try:
        with elastic.drain_scope(log=log) as drain:
            if forward:
                summary = engine.run_forward(requests, drain=drain)
                done = [r for r in requests if r.reply is not None]
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


def _write_result(path, summary, engine, done, rank, replicas=None) -> None:
    """One rank's run: its summary, each completed request's reply (by
    rid), the resizes, whether it ended parked and the kernel launches,
    to ``path`` on rank 0 and ``path.rank<r>`` on rank r (first-world
    ranks); a routed run's replicas (``engine`` None).  The forward
    service's float replies go to ``<path>.replies.npy`` (rank 0's, in
    the order of ``reply_rids``)."""
    from flexflow_tpu_torch.ops import kernels

    res = {"summary": {k: v for k, v in summary.items()
                       if not k.startswith("_")},
           "resizes": engine.resizes if engine is not None else [],
           "out_of_service": engine.out_of_service
           if engine is not None else False,
           "launches": dict(kernels.launches), "replicas": replicas}
    if rank:
        path = f"{path}.rank{rank}"
    done = sorted(done, key=lambda r: r.rid)
    if done and np.asarray(done[0].reply).dtype.kind == "f":
        res["replies"] = {}
        res["reply_rids"] = [r.rid for r in done]
        if not rank:
            np.save(f"{path}.replies.npy",
                    np.stack([np.asarray(r.reply) for r in done]))
    else:
        res["replies"] = {str(r.rid): [int(t) for t in r.reply]
                          for r in done}
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


# ---------------------------------------------------------------------------
# the JAX app's three smokes (flexflow_tpu/apps/serve.py:414-828), at its
# tiny 2-layer geometry, its slots, loads and step times


def _smoke_devices(opts, n: int) -> list:
    """The devices of a smoke's ``n`` one-card replicas: a card each where
    enough are visible, else all on ``--device`` (``cuda:0`` shared on one
    card), or the CPU."""
    if torch.device(opts["device"]).type == "cpu":
        return ["cpu"] * n
    from flexflow_tpu_torch.machine import resolve_device

    dev = resolve_device(opts["device"])   # raises without CUDA
    if torch.cuda.device_count() >= n:
        return [f"cuda:{i}" for i in range(n)]
    return [str(dev)] * n


def _tiny_engine(device, batch, olog=None, metrics=None, *, step=None,
                 phase="full", width=1):
    """A one-card engine of the tiny GPT (seed 0) with ``batch`` slots,
    priced as a replica ``width`` devices wide: its KV layout, which the
    router prices each handoff from, takes the grid of a shadow graph on
    ``MachineModel.virtual(width)`` (the JAX app's replica over ``width``
    devices); the cache itself and the forward stay on the card."""
    from flexflow_tpu_torch.machine import MachineModel
    from flexflow_tpu_torch.serve.engine import ServeEngine
    from flexflow_tpu_torch.serve.kv_cache import KVCacheLayout

    model, _ = build_lm(batch=batch, seed=0, tiny=True,
                        machine=MachineModel(device))
    eng = ServeEngine(model, None, olog=olog, metrics=metrics, log=_quiet,
                      step_time_s=step, phase=phase)
    if width > 1:
        eng.kv_layout = KVCacheLayout.from_model(
            _shadow(batch, width), eng.max_batch, eng.kv_window)
    return eng


def _shadow(batch: int, width: int):
    """The tiny GPT at ``batch`` slots on a ``width``-device virtual
    machine: a graph to price, never run."""
    from flexflow_tpu_torch.machine import MachineModel

    return build_lm(batch=batch, seed=0, tiny=True,
                    machine=MachineModel.virtual(width))[0]


def pool_step_ratio(batch: int, width: int) -> float:
    """``decode_step_ratio`` of the tiny GPT at ``batch`` slots on a
    shadow graph ``width`` devices wide: the decode pool's virtual step as
    the JAX app prices its ``width``-device pool, for a replica that runs
    on one card."""
    from flexflow_tpu_torch.sim.search import decode_step_ratio

    return decode_step_ratio(_shadow(batch, width))


def _session_load():
    from flexflow_tpu_torch.serve.loadgen import patterned_requests

    return patterned_requests(12, seed=0, rate_qps=50.0, pattern="session",
                              vocab_size=64, prompt_len=6, max_new_tokens=4)


def _replies(reqs) -> dict:
    return {r.rid: (list(r.reply) if r.reply is not None else None)
            for r in reqs}


def _assert_same_replies(got, want, reqs, engine, what) -> None:
    """``got == want`` (rid -> reply); else fail naming the first request
    and position that differ and ``engine``'s top-2 log-prob gap there
    (a near tie: a rounding-level difference between two GEMM shapes)."""
    if got == want:
        return
    rid = next(r for r in sorted(want) if got.get(r) != want[r])
    a, b = got.get(rid) or [], want[rid]
    pos = next((i for i, (x, y) in enumerate(zip(a, b)) if x != y),
               min(len(a), len(b)))
    prompt = next(r.tokens for r in reqs if r.rid == rid)
    toks = np.zeros((engine.max_batch, engine.max_len), np.int32)
    row = [int(t) for t in prompt] + list(b[:pos])
    toks[0, :len(row)] = row
    lp = engine.model.make_predict_step()(engine.params, {}, toks,
                                          np.zeros_like(toks))[0]
    top = torch.topk(lp[0, len(row) - 1].float(), 2).values
    raise AssertionError(
        f"{what}: request {rid} differs at position {pos} ({a} vs {b}); "
        f"top-2 log-prob gap there {float(top[0] - top[1]):.3e}")


def _render_serve(olog, log, need=None) -> None:
    """``report serve`` of the smoke's stream (and its validated
    ``serve_trace_events`` trace): both must render."""
    from flexflow_tpu_torch import obs
    from flexflow_tpu_torch.apps.report import serve_main
    from flexflow_tpu_torch.obs.trace import (chrome_trace,
                                              serve_trace_events,
                                              validate_trace)

    events = list(obs.read_run(olog.path))
    errors = validate_trace(chrome_trace(serve_trace_events(events)))
    assert not errors, errors
    rendered = []
    rc = serve_main([olog.path], log=rendered.append)
    assert rc == 0 and rendered, "report serve must render"
    if need is not None:
        assert any(need in ln for ln in rendered), \
            f"report serve must render {need!r}"
    for line in rendered:
        log(line)
    return events


def _smoke_equivalence(opts, log) -> None:
    """Batching must not change a reply: five requests through an 8-slot
    engine and through a 1-slot engine, on one card, reply bit for bit
    alike (``flexflow_tpu/apps/serve.py:417-445``; JAX's 8-slot engine
    spans its 8 devices)."""
    from flexflow_tpu_torch.serve.loadgen import synthetic_requests

    dev = _smoke_devices(opts, 1)[0]
    runs = []
    for batch in (8, 1):
        eng = _tiny_engine(dev, batch)
        reqs = synthetic_requests(5, seed=0, rate_qps=1000.0, vocab_size=64,
                                  prompt_len=4, max_new_tokens=3)
        eng.run(reqs)
        runs.append((_replies(reqs), reqs, eng))
    (a, _, _), (b, reqs, one) = runs
    _assert_same_replies(a, b, reqs, one,
                         "batched replies must be bit-identical to "
                         "single-request replies")
    log(f"serve-smoke equivalence ok: {len(a)} replies bit-identical with "
        f"batching on (8 slots) vs off (1 slot) on {dev}")


def _smoke_lifecycle(opts, log, machine) -> dict:
    """Gap-then-burst load against the autoscaling engine over the world
    ``torchrun`` started (``flexflow_tpu/apps/serve.py:448-518``): 6
    early requests, a 30-virtual-second gap (shrink to ``3 * world //
    4`` ranks), a 40-request burst (queue-depth grow back).  Exactly one
    resize each way, 46 completed, none unserved or dropped, finite
    latencies, back at the world's size; the stream renders through
    ``report serve``."""
    from flexflow_tpu_torch import obs
    from flexflow_tpu_torch.obs.report import summarize
    from flexflow_tpu_torch.serve.engine import ServeEngine
    from flexflow_tpu_torch.serve.loadgen import synthetic_requests
    from flexflow_tpu_torch.utils import elastic

    world = machine.num_devices
    target = 3 * world // 4
    model, rebuild = build_lm(batch=24, seed=0, tiny=True, machine=machine,
                              research_budget_s=2.0)
    olog, metrics = _olog_metrics(opts, machine.device, machine.rank)
    engine = ServeEngine(model, rebuild, olog=olog, metrics=metrics, log=log,
                         queue_hi=4, idle_boundaries=3, shrink_to=target)
    early = synthetic_requests(6, seed=0, rate_qps=500.0, vocab_size=64,
                               prompt_len=4, max_new_tokens=3)
    burst = synthetic_requests(40, seed=1, rate_qps=2000.0, vocab_size=64,
                               prompt_len=4, max_new_tokens=3,
                               start_v=early[-1].arrival_v + 30.0)
    for i, r in enumerate(burst):
        r.rid = 100 + i
    try:
        summary = engine.run(early + burst)
        if engine._parked and engine.model.machine.rank == 0:
            elastic.release_standbys(engine._parked,
                                     {"devices": summary["devices"]})
    finally:
        olog.close()
    dirs = [(r["direction"], r["from_devices"], r["to_devices"])
            for r in engine.resizes]
    want = [("shrink", world, target), ("grow", target, world)]
    assert dirs == want, f"expected exactly {want}, got {dirs}"
    assert summary["completed"] == 46 and summary["unserved"] == 0 \
        and summary["dropped"] == 0, summary
    assert math.isfinite(summary["p50_s"]) \
        and math.isfinite(summary["p99_s"]), summary
    assert summary["devices"] == world, \
        f"the run must end on the whole world after the grow: {summary}"
    if olog.enabled:
        events = list(obs.read_run(olog.path))
        srs = [e for e in events if e["kind"] == "serve_resize"]
        assert [(r["direction"], r["from_devices"], r["to_devices"])
                for r in srs] == dirs, srs
        s = summarize(events)
        assert s.get("serve", {}).get("summary", {}).get("dropped") == 0, \
            s.get("serve")
        _render_serve(olog, log, need="latency histogram")
    log(f"serve-smoke lifecycle ok: {summary['completed']} served, resizes "
        f"{dirs}, p50 {summary['p50_s'] * 1e3:.1f} ms, p99 "
        f"{summary['p99_s'] * 1e3:.1f} ms")
    summary["_olog"] = olog
    summary["_rank"] = machine.rank
    summary["_resizes"] = engine.resizes
    return summary


class _DrainAfter(dict):
    """A deterministic drain flag: not requested for the first ``after``
    checks, then requested (the router checks once per event-loop
    boundary, so the drain lands at a fixed virtual instant)."""

    def __init__(self, after: int):
        super().__init__()
        self.after = int(after)
        self.checks = 0

    def get(self, key, default=None):
        if key == "requested":
            self.checks += 1
            return self.checks > self.after
        return super().get(key, default)


def _single_pool_replies(opts):
    """The single-pool engine's replies to the session load (the routed
    runs' ground truth): (replies, requests, engine)."""
    eng = _tiny_engine(_smoke_devices(opts, 1)[0], 8)
    reqs = _session_load()
    eng.run(reqs)
    return _replies(reqs), reqs, eng


def _smoke_disagg(opts, log) -> dict:
    """The disaggregation scenario (``flexflow_tpu/apps/serve.py:
    539-635``): two prefill replicas of 2 slots and one decode replica
    of 4, each one card priced at the JAX app's width (2, 2 and 4
    devices: :func:`_tiny_engine`, :func:`pool_step_ratio`), serving the
    seeded multi-turn ``session`` load. Every routed reply equals the
    single pool's, the router hands off at least once and hits session
    affinity at least once, and a mid-run drain finishes the in-flight
    work, leaves the rest unserved and returns; the stream renders and
    traces clean."""
    from flexflow_tpu_torch import obs
    from flexflow_tpu_torch.serve.engine import DEFAULT_STEP_TIME_S
    from flexflow_tpu_torch.serve.router import ServeRouter

    devs = _smoke_devices(opts, 3)
    dstep = DEFAULT_STEP_TIME_S * pool_step_ratio(4, 4)

    def build_pools(olog, metrics):
        prefill = [_tiny_engine(devs[j], 2, olog, metrics,
                                step=DEFAULT_STEP_TIME_S, phase="prefill",
                                width=2) for j in range(2)]
        return prefill, [_tiny_engine(devs[2], 4, olog, metrics,
                                      step=dstep, phase="decode", width=4)]

    olog, metrics = _olog_metrics(opts, devs[0])
    router = ServeRouter(*build_pools(olog, metrics), olog=olog,
                         metrics=metrics, log=log)
    reqs = _session_load()
    summary = router.run(reqs)
    expected, sreqs, single = _single_pool_replies(opts)
    _assert_same_replies(_replies(reqs), expected, sreqs, single,
                         "routed replies must be bit-identical to the "
                         "single-pool engine's")
    assert summary["handoffs"] >= 1 and summary["affinity_hits"] >= 1, \
        f"the smoke must exercise the router: {summary['handoffs']} " \
        f"handoff(s), {summary['affinity_hits']} affinity hit(s)"
    assert summary["completed"] == 12 and summary["unserved"] == 0, summary
    assert summary["kv_refetches"] == 0, summary
    # a mid-run drain on fresh pools after three event-loop boundaries
    router2 = ServeRouter(*build_pools(olog, metrics), olog=olog,
                          metrics=metrics, log=log)
    dsum = router2.run(_session_load(), drain=_DrainAfter(3))
    assert dsum["drained"], dsum
    assert dsum["completed"] + dsum["unserved"] == 12 \
        and dsum["unserved"] >= 1, dsum
    olog.close()
    if olog.enabled:
        kinds = {e["kind"] for e in obs.read_run(olog.path)}
        assert {"serve_handoff", "router_summary"} <= kinds, kinds
        _render_serve(olog, log)
    log(f"disagg-smoke ok: {summary['completed']} routed replies "
        f"bit-identical to single-pool, {summary['handoffs']} handoff(s), "
        f"{summary['affinity_hits']} affinity hit(s); drain left "
        f"{dsum['unserved']} unserved and exited clean")
    summary["_olog"] = olog
    summary["_drained"] = dsum
    return summary


#: the seeded chaos of the recovery phase: the decode pool's third health
#: probe kills a replica mid-decode, the fifth KV transfer is dropped on
#: the wire; both recover under the default retry budget
CHAOS_SMOKE_SPEC = "replica_crash@3,handoff_drop@5"


def _smoke_chaos(opts, log) -> dict:
    """The resilience scenario (``flexflow_tpu/apps/serve.py:646-812``)
    on two prefill and two decode replicas of 2 slots, each one card
    priced at the JAX app's 2 devices:

    1. the resilience machinery armed (an injector with an empty spec, a
       ``RetryPolicy``, an ``AdmissionGate``) but never firing is inert:
       replies and summary counters equal a plain router's and the
       single pool's;
    2. ``CHAOS_SMOKE_SPEC``: every request still completes with the same
       replies, one replica down, at least one KV rebuild and two
       retries, none unserved, failed or shed, the crashed replica back
       by the end; the stream renders (with its resilience line) and
       traces clean."""
    from flexflow_tpu_torch import obs
    from flexflow_tpu_torch.serve.engine import DEFAULT_STEP_TIME_S
    from flexflow_tpu_torch.serve.router import AdmissionGate, ServeRouter
    from flexflow_tpu_torch.utils.faultinject import (FaultInjector,
                                                      install_scoped)
    from flexflow_tpu_torch.utils.retry import RetryPolicy

    devs = _smoke_devices(opts, 4)
    dstep = DEFAULT_STEP_TIME_S * pool_step_ratio(2, 2)

    def build_pools(olog, metrics):
        prefill = [_tiny_engine(devs[j], 2, olog, metrics,
                                step=DEFAULT_STEP_TIME_S, phase="prefill",
                                width=2) for j in range(2)]
        decode = [_tiny_engine(devs[2 + j], 2, olog, metrics, step=dstep,
                               phase="decode", width=2) for j in range(2)]
        return prefill, decode

    def resilient_router(olog, metrics):
        return ServeRouter(*build_pools(olog, metrics), olog=olog,
                           metrics=metrics, log=log,
                           retry_policy=RetryPolicy(),
                           admission=AdmissionGate())

    expected, sreqs, single = _single_pool_replies(opts)
    # phase 1: armed but idle against a plain router
    plain = ServeRouter(*build_pools(obs.NULL, None), log=_quiet)
    breqs = _session_load()
    bsum = plain.run(breqs)
    olog, metrics = _olog_metrics(opts, devs[0])
    router = resilient_router(olog, metrics)
    idle = FaultInjector("")
    restore = install_scoped(idle)
    try:
        areqs = _session_load()
        asum = router.run(areqs)
    finally:
        restore()
    _assert_same_replies(_replies(breqs), expected, sreqs, single,
                         "the plain router's replies")
    _assert_same_replies(_replies(areqs), expected, sreqs, single,
                         "armed-but-idle resilience machinery must be "
                         "byte-inert")
    assert idle.fired() == 0, f"an empty spec must never fire: {idle.fired()}"
    assert asum["retries"] == asum["shed"] == asum["failed"] == 0 \
        and asum["replica_down"] == 0 and asum["kv_rebuilds"] == 0, asum
    inert_keys = ("completed", "unserved", "shed", "failed", "handoffs",
                  "affinity_hits", "kv_refetches", "steps", "p50_s",
                  "p99_s", "ttft_p50_s", "virtual_s")
    diverged = {k: (bsum[k], asum[k]) for k in inert_keys
                if bsum[k] != asum[k]}
    assert not diverged, \
        f"armed summary diverged from the plain router's: {diverged}"
    log(f"chaos-smoke equivalence ok: armed-but-idle machinery byte-inert "
        f"({asum['completed']} replies bit-identical to plain router and "
        f"single pool)")
    # phase 2: the seeded chaos; recovery must be total
    router2 = resilient_router(olog, metrics)
    inj = FaultInjector(CHAOS_SMOKE_SPEC, olog=olog)
    restore2 = install_scoped(inj)
    try:
        creqs = _session_load()
        csum = router2.run(creqs)
    finally:
        restore2()
    _assert_same_replies(
        {r.rid: list(r.reply) for r in creqs if r.reply is not None},
        expected, sreqs, single,
        "recovered replies must be bit-identical to the fault-free run")
    assert csum["completed"] == 12 and csum["unserved"] == 0 \
        and csum["failed"] == 0 and csum["shed"] == 0, csum
    assert csum["completed"] + csum["unserved"] + csum["shed"] \
        + csum["failed"] == csum["requests"] == 12, csum
    assert csum["replica_down"] == 1, csum
    assert csum["kv_rebuilds"] >= 1, \
        f"the crash must force >= 1 KV re-materialization: {csum}"
    assert csum["retries"] >= 2, csum
    assert csum["replicas_live"] == 2, \
        f"the crashed replica must be back by run end: {csum}"
    assert inj.fired("replica_crash") == 1 \
        and inj.fired("handoff_drop") == 1, \
        f"spec {CHAOS_SMOKE_SPEC!r} must fire both faults: " \
        f"{inj.fired('replica_crash')} crash(es), " \
        f"{inj.fired('handoff_drop')} drop(s)"
    olog.close()
    if olog.enabled:
        events = _render_serve(olog, log, need="resilience:")
        downs = [e for e in events if e["kind"] == "replica_down"]
        retries = [e for e in events if e["kind"] == "serve_retry"]
        rebuilds = [e for e in events if e["kind"] == "kv_rebuild"]
        assert len(downs) == 1 and downs[0]["replica"] == 0, downs
        assert len(retries) == csum["retries"] and len(retries) >= 2, \
            retries
        assert len(rebuilds) == csum["kv_rebuilds"] >= 1, rebuilds
        assert not any(e["kind"] == "serve_fault" for e in events)
    log(f"chaos-smoke recovery ok: {CHAOS_SMOKE_SPEC!r} -> "
        f"{csum['completed']}/12 complete with bit-identical replies, "
        f"{csum['replica_down']} replica down, {csum['kv_rebuilds']} KV "
        f"rebuild(s), {csum['retries']} retry(ies), 0 lost")
    csum["_olog"] = olog
    csum["_armed"] = asum
    return csum


def smoke(opts, log=_err, machine=None) -> dict:
    """``--smoke``: the equivalence on one rank (rank 0), then the
    lifecycle over the world ``torchrun`` started, which must hold at
    least two ranks (JAX's smoke refuses anything but its 8 devices)."""
    machine = machine if machine is not None else machine_for(opts)
    if machine.num_devices < 2:
        raise SystemExit(
            f"serve --smoke autoscales over the ranks torchrun starts and "
            f"needs at least 2, got {machine.num_devices} (torchrun "
            f"--nproc-per-node 2 -m flexflow_tpu_torch.apps.serve --smoke)")
    if machine.rank != 0:
        log = _quiet
    else:
        _smoke_equivalence(opts, log)
    return _smoke_lifecycle(opts, log, machine)


def main(argv=None, log=_err) -> int:
    opts = parse_args(sys.argv[1:] if argv is None else argv)
    smoker = _smoke_chaos if opts["chaos_smoke"] else (
        _smoke_disagg if opts["disagg_smoke"] else (
            smoke if opts["smoke"] else None))
    if smoker is None:
        summary = serve_run(opts, log)
    elif opts["obs_dir"]:
        summary = smoker(opts, log)
    else:
        import tempfile

        with tempfile.TemporaryDirectory(prefix="ff-serve-smoke-") as td:
            opts["obs_dir"] = os.path.join(td, "obs")
            summary = smoker(opts, log)
    if smoker is not None and opts["result_json"]:
        _write_smoke_result(opts["result_json"], summary)
    if summary.pop("_rank", 0) == 0:
        print(_result_line(summary, summary.pop("_olog")))
    return 0


def _write_smoke_result(path, summary) -> None:
    """A smoke's summary and resizes, to ``path`` on rank 0 and
    ``path.rank<r>`` on rank r."""
    rank = summary.get("_rank", 0)
    res = {"summary": {k: v for k, v in summary.items()
                       if not k.startswith("_")},
           "resizes": summary.get("_resizes", [])}
    with open(f"{path}.rank{rank}" if rank else path, "w") as f:
        json.dump(res, f)


if __name__ == "__main__":
    from flexflow_tpu_torch import distributed as _dist

    rc = main()
    _dist.shutdown()
    sys.exit(rc)
