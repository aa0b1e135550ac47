"""Fleet driver: a training job and a serving job timesharing one pool of
cards through the fleet coordinator (PyTorch port of
``flexflow_tpu/apps/fleet.py``).

    torchrun --standalone --nproc-per-node 8 -m flexflow_tpu_torch.apps.fleet \\
        --smoke --device cpu
    torchrun --standalone --nproc-per-node 4 -m flexflow_tpu_torch.apps.fleet \\
        --fleet-quantum 2 -obs-dir obs/

The pool is the world of ranks ``torchrun`` makes (one rank a card, or
``--device cpu`` for gloo CPU ranks; ``--dist-backend gloo`` puts every
rank on ``--device cuda:0``), every rank running the same coordinator
(``fleet/``).  The reference mix: training job A (the elastic smoke's
CNN, batch 24) beside serving job B (the tiny GPT, batch 8, a queue
watermark of 4), at JAX's sizes on a pool of 8 (A on 6 of 2-6, B on 2 of
2-4) and at half of them on a pool of 4 (A on 3 of 1-3, B on 1 of 1-2).
Flags ride ``FFConfig``: ``--fleet-quantum``, ``--fleet-search-budget-s``,
``-obs-dir``, ``-metrics-path``, ``--seed``, ``--iterations`` (48 unless
given: A must outlast B's burst).

Rank 0 prints EXACTLY ONE JSON line on stdout (``run_id``, the job
counts, ``rebalances``, the pricers' counts, ``train_final_loss``,
``serve_completed``, ...); the narration goes to stderr.
``--result-json F`` has every rank write its summary, kernel launches
and served replies (``F.rank<r>`` on rank r > 0).  SIGTERM or
SIGINT makes every job wind down at its next boundary (the flag is
agreed over the world each round) and the process exits 0.

``--smoke`` is the deterministic scenario: B's burst crosses its
watermark, the arbiter re-packs, A hands devices to B (one
``fleet_rebalance``, a directed ``elastic_resize`` on each job), and
when B's queue drains the trade reverses.  Rank 0 asserts the exact
record sequence, A's losses finite and unbroken across both moves, B's
20 requests served, no fault record, ``check_fleet_util`` on every
``fleet_util`` record, the wait decompositions, and that a second
arbiter reproduces the packing under the seed.
"""

from __future__ import annotations

import json
import math
import os
import sys

import numpy as np

BATCH = 24   # divisible by every slice size the pool hands job A


def _err(*a, **kw):
    print(*a, file=sys.stderr, **kw)
    sys.stderr.flush()


def _quiet(*a, **kw):
    pass


# ---------------------------------------------------------------------------
# the reference two-job mix


def _train_build(cfg, machine):
    """Job A's factory: the elastic smoke's CNN."""
    from flexflow_tpu_torch.apps.elastic_smoke import _build

    return _build(cfg, machine)


def _host_batches(seed: int = 3, n: int = 4):
    """Job A's global host batches (JAX's ``elastic_smoke._host_batches``:
    the same arrays under the same seed); each rank of A's slice takes
    its block."""
    rng = np.random.RandomState(seed)
    ring = [(rng.randn(BATCH, 16, 16, 3).astype("float32"),
             rng.randint(0, 8, (BATCH,)).astype("int32"))
            for _ in range(n)]
    i = 0
    while True:
        yield ring[i % n]
        i += 1


def _serve_build(ff_cfg, machine):
    """Job B's factory: the tiny GPT (2 layers, d_model 32, 4 heads of 8,
    vocab 64, seq 16) on whatever slice the coordinator assigns."""
    from flexflow_tpu_torch.models.transformer import (TransformerConfig,
                                                       TransformerLM)

    cfg_t = TransformerConfig(
        batch_size=ff_cfg.batch_size, causal=True, seed=ff_cfg.seed,
        seq_length=16, num_layers=2, d_model=32, num_heads=4, d_ff=128,
        vocab_size=64)
    return TransformerLM(cfg_t, machine, ff_cfg.strategies)


def sizes_for(pool: int) -> dict:
    """Each job's (min, max) slice and the moves the smoke forces on a
    pool of ``pool`` ranks (8: JAX's; 4: half of them)."""
    if pool == 8:
        return {"a": (2, 6), "b": (2, 4),
                "a_moves": [("shrink", 6, 4), ("grow", 4, 6)],
                "b_moves": [("grow", 2, 4), ("shrink", 4, 2)]}
    if pool == 4:
        return {"a": (1, 3), "b": (1, 2),
                "a_moves": [("shrink", 3, 2), ("grow", 2, 3)],
                "b_moves": [("grow", 1, 2), ("shrink", 2, 1)]}
    raise SystemExit(f"the fleet mix needs a pool of 4 or 8 ranks, got "
                     f"{pool}")


def _scenario(cfg, pool: int = 8):
    """The two JobSpecs of the reference mix on a pool of ``pool``
    ranks: train job A and serve job B (``flexflow_tpu/apps/fleet.py:
    69``)."""
    import copy

    from flexflow_tpu_torch.config import FFConfig
    from flexflow_tpu_torch.fleet import JobSpec
    from flexflow_tpu_torch.serve.loadgen import synthetic_requests

    size = sizes_for(pool)
    train_cfg = FFConfig(batch_size=BATCH, input_height=16, input_width=16,
                         num_iterations=cfg.num_iterations, print_freq=0,
                         num_classes=8, seed=cfg.seed)
    job_a = JobSpec(
        job_id="train-a", kind="train", build=_train_build,
        config=train_cfg, payload=_host_batches, priority=1.0,
        min_devices=size["a"][0], max_devices=size["a"][1],
        search_iters=40)

    serve_cfg = FFConfig(batch_size=8, seed=cfg.seed)
    early = synthetic_requests(4, seed=cfg.seed, rate_qps=1000.0,
                               vocab_size=64, prompt_len=4,
                               max_new_tokens=3)
    burst = synthetic_requests(16, seed=cfg.seed + 1, rate_qps=5000.0,
                               vocab_size=64, prompt_len=4,
                               max_new_tokens=3,
                               start_v=early[-1].arrival_v + 5.0)
    for i, r in enumerate(burst):
        r.rid = 100 + i
    job_b = JobSpec(
        job_id="serve-b", kind="serve", build=_serve_build,
        config=serve_cfg, payload=early + burst, priority=1.0,
        min_devices=size["b"][0], max_devices=size["b"][1], queue_hi=4,
        search_iters=40)
    return [job_a, job_b], copy.copy(train_cfg)


def pool_machine(device="cuda", backend=None):
    """The pool: the world ``torchrun`` made (``WORLD_SIZE`` set), else
    this one process on ``device``."""
    from flexflow_tpu_torch.apps.cnn import machine_for

    return machine_for(device, backend)


def fleet_run(cfg, pool, log=_err, pricer=None):
    """One coordinator run of the reference mix on ``pool`` (every rank
    calls it).  Returns ``(summary, coordinator)``."""
    import torch

    from flexflow_tpu_torch.fleet import FleetCoordinator
    from flexflow_tpu_torch.obs.metrics import from_config
    from flexflow_tpu_torch.utils.elastic import drain_scope

    if pool.device.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    metrics = from_config(cfg, meta={"app": "fleet",
                                     "pool": pool.num_devices}) \
        if pool.rank == 0 else None
    coord = FleetCoordinator(
        pool, obs_dir=cfg.obs_dir, metrics=metrics,
        quantum=cfg.fleet_quantum, budget_s=cfg.fleet_search_budget_s,
        iters=200, seed=cfg.seed, pricer=pricer, log=log)
    specs, _ = _scenario(cfg, pool.num_devices)
    for spec in specs:
        coord.submit(spec)
    with drain_scope(log=log) as drain:
        summary = coord.run(drain=drain)
    return summary, coord


def _result_line(summary, coord) -> str:
    """The one stdout JSON line: headline keys first, detail after."""
    by_state = summary["by_state"]
    rec = {
        "run_id": coord.olog.run_id if coord.olog.enabled else None,
        "pool_devices": summary["pool_devices"],
        "jobs": len(summary["jobs"]),
        "done": by_state.get("done", 0),
        "failed": by_state.get("failed", 0),
        "rebalances": summary["rebalances"],
        "packs": summary["packs"],
        "native_prices": summary["native_prices"],
        "proxy_prices": summary["proxy_prices"],
        "wall_s": summary["wall_s"],
    }
    for j in summary["jobs"]:
        if j["kind"] == "train":
            rec["train_final_loss"] = j.get("final_loss")
        else:
            rec["serve_completed"] = j.get("completed")
            rec["serve_unserved"] = j.get("unserved")
    return json.dumps(rec)


# ---------------------------------------------------------------------------
# the deterministic --smoke scenario


def _read_stream(path):
    from flexflow_tpu_torch import obs

    return list(obs.read_run(path))


def check_smoke(cfg, summary, coord, log=_err) -> dict:
    """Rank 0's checks of a smoke run (``flexflow_tpu/apps/fleet.py:
    160-256``) on a pool of 4 or 8; returns the facts checked."""
    pool = summary["pool_devices"]
    size = sizes_for(pool)
    by_job = {j["job"]: j for j in summary["jobs"]}
    assert by_job["train-a"]["state"] == "done" \
        and by_job["serve-b"]["state"] == "done", summary
    assert summary["rebalances"] == 2, \
        f"expected exactly 2 rebalances (trade out, trade back): " \
        f"{summary}"
    assert summary["native_prices"] > 0, \
        f"the native pricer never ran: {coord.arbiter.pricer_errors}"

    job_a = next(j for j in coord.jobs if j.spec.job_id == "train-a")
    losses = job_a.result["loss"]
    assert len(losses) == cfg.num_iterations, \
        f"A must complete all {cfg.num_iterations} iterations: " \
        f"{len(losses)}"
    assert all(math.isfinite(v) for v in losses), losses
    assert by_job["serve-b"]["completed"] == 20 \
        and by_job["serve-b"]["unserved"] == 0, by_job["serve-b"]

    a_events = _read_stream(os.path.join(cfg.obs_dir, "train-a",
                                         "train-a.jsonl"))
    b_events = _read_stream(os.path.join(cfg.obs_dir, "serve-b",
                                         "serve-b.jsonl"))
    fleet_events = _read_stream(os.path.join(cfg.obs_dir, "fleet.jsonl"))

    def resizes(events):
        return [(e["direction"], e["from_devices"], e["to_devices"],
                 e["cause"]) for e in events
                if e["kind"] == "elastic_resize"]

    want_a = [m + ("directed",) for m in size["a_moves"]]
    want_b = [m + ("directed",) for m in size["b_moves"]]
    assert resizes(a_events) == want_a, \
        f"A resize sequence: {resizes(a_events)}"
    assert resizes(b_events) == want_b, \
        f"B resize sequence: {resizes(b_events)}"
    for events, who in ((a_events, "A"), (b_events, "B")):
        faults = [e["kind"] for e in events
                  if e["kind"] in ("device_loss", "device_return")]
        assert not faults, f"job {who} has fault records: {faults}"

    merged = sorted(a_events + b_events + fleet_events,
                    key=lambda e: e["ts"])
    seq = [e["kind"] for e in merged
           if e["kind"] in ("fleet_rebalance", "elastic_resize")]
    assert seq == ["fleet_rebalance", "elastic_resize",
                   "elastic_resize"] * 2, f"merged sequence: {seq}"
    kinds = {e["kind"] for e in fleet_events}
    assert {"fleet_job", "fleet_placement", "fleet_rebalance",
            "fleet_summary", "fleet_util"} <= kinds, kinds

    from flexflow_tpu_torch.fleet import check_fleet_util

    util_recs = [e for e in fleet_events if e["kind"] == "fleet_util"]
    assert util_recs, "no fleet_util rounds recorded"
    for rec in util_recs:
        violations = check_fleet_util(rec)
        assert not violations, f"fleet_util invariant: {violations}"
    assert any(rec["busy_steps"] > 0 for rec in util_recs), \
        "no busy device-steps accounted across the whole run"

    waits = {e["job"]: e for e in a_events + b_events
             if e["kind"] == "fleet_wait"}
    assert set(waits) == {"train-a", "serve-b"}, set(waits)
    for jid, w in waits.items():
        parts = [w["wait_s"], w["placement_s"], w["run_s"],
                 w["drain_s"], w["resize_s"]]
        assert all(math.isfinite(v) and v >= 0 for v in parts), w
        assert math.isfinite(w["total_s"]) and w["total_s"] > 0, w
        assert abs(sum(parts) - w["total_s"]) < 1e-9, w
        assert w["drain_s"] > 0 and w["resize_s"] > 0, w

    from flexflow_tpu_torch.obs.report import summarize

    s = summarize(merged)
    assert s.get("fleet", {}).get("rebalances") == 2, s.get("fleet")
    assert len(s["fleet"].get("waits", [])) == 2, s["fleet"]
    assert s["fleet"].get("util", {}).get("busy_steps", 0) > 0

    from flexflow_tpu_torch.fleet import Arbiter, Job

    specs, _ = _scenario(cfg, pool)
    packs = []
    for _ in range(2):
        arb = Arbiter(pool, budget_s=cfg.fleet_search_budget_s, iters=200,
                      seed=cfg.seed, log=_quiet)
        packs.append(arb.pack([Job(sp) for sp in specs]))
    assert packs[0] == packs[1], \
        f"arbiter packing must reproduce under a fixed seed: {packs}"

    a, b = size["a_moves"], size["b_moves"]
    log(f"fleet-smoke ok: A {len(losses)} iters (final loss "
        f"{losses[-1]:.4f}) across {a[0][1]}->{a[0][2]}->{a[1][2]} "
        f"devices, B 20/20 served across {b[0][1]}->{b[0][2]}->"
        f"{b[1][2]}, {summary['rebalances']} rebalances, packing "
        f"reproducible")
    return {"losses": losses, "resizes_a": resizes(a_events),
            "resizes_b": resizes(b_events), "sequence": seq,
            "util_records": len(util_recs)}


def _write_result(path: str, pool, summary, coord, facts) -> None:
    """``--result-json``: every rank's own (``<path>.rank<r>`` on rank r >
    0): the summary, its kernel launches, the serving job's completed
    replies on the ranks that served them, and rank 0's smoke facts."""
    from flexflow_tpu_torch.ops import kernels

    serve = next((j for j in coord.jobs if j.spec.kind == "serve"), None)
    out = {"launches": dict(kernels.launches),
           "replies": {r.rid: list(r.reply or ())
                       for r in (serve.served if serve else [])},
           "summary": summary, "facts": facts}
    with open(path + (f".rank{pool.rank}" if pool.rank else ""), "w") as f:
        json.dump(out, f, default=str)


def main(argv=None, log=_err) -> int:
    import tempfile

    from flexflow_tpu_torch.apps.cnn import _flag_value
    from flexflow_tpu_torch.config import FFConfig

    argv = list(sys.argv[1:] if argv is None else argv)
    device, argv = _flag_value(argv, "--device", "cuda")
    backend, argv = _flag_value(argv, "--dist-backend", None)
    result_json, argv = _flag_value(argv, "--result-json", "")
    is_smoke = "--smoke" in argv
    cfg = FFConfig.from_args([a for a in argv if a != "--smoke"])
    if cfg.num_iterations == 10:   # FFConfig default: A must outlast
        cfg.num_iterations = 48    # B's burst
    pool = pool_machine(device, backend)
    if pool.rank != 0:
        log = _quiet
    tmp = None
    if is_smoke and not cfg.obs_dir:
        # one directory for every rank: rank 0 alone writes there
        from flexflow_tpu_torch import distributed

        tmp = distributed.share(tempfile.mkdtemp(prefix="ff-fleet-smoke-")
                                if pool.rank == 0 else None, 0)
        cfg.obs_dir = os.path.join(tmp, "obs")
    summary, coord = fleet_run(cfg, pool, log=log)
    facts = None
    if pool.rank == 0:
        if is_smoke:
            facts = check_smoke(cfg, summary, coord, log)
        print(_result_line(summary, coord))
        sys.stdout.flush()
        if tmp:
            import shutil

            shutil.rmtree(tmp, ignore_errors=True)
    if result_json:
        _write_result(result_json, pool, summary, coord, facts)
    return 0


if __name__ == "__main__":
    from flexflow_tpu_torch import distributed as _dist

    code = main()
    _dist.shutdown()
    sys.exit(code)
