"""The port's router under injected faults against the JAX package's
(``tests/test_serve_faults.py``'s router tests), on two one-device
prefill and two one-device decode replicas in both (JAX's over
``machine8.shrink([j])``) from one set of JAX parameters, each run under
the same ``FaultInjector`` spec in both packages: replies, virtual stamps,
the summary (but ``wall_s``), the injector's fires and every obs record
(``serve_retry``, ``serve_fault``, ``kv_rebuild``, ``replica_down``,
``serve_shed``, ``serve_handoff``, the ``fault`` records, ...) but its
wall-clock fields are JAX's.  Then, in the port alone, what each fault
path promises: replies identical to the undisturbed run, and every
request completed, unserved, shed or explicitly failed.
"""

import pytest
import torch

import torch_serve_pools as sp_pools
from flexflow_tpu.utils.retry import RetryPolicy as JRetry
from flexflow_tpu_torch.serve import loadgen as t_loadgen
from flexflow_tpu_torch.utils.retry import RetryPolicy

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def models(machine8):
    return sp_pools.Models(machine8, 2, 2)


@pytest.fixture(scope="module")
def baseline(models):
    """The undisturbed routed run every recovery path must reproduce."""
    reqs, summary, _, _, _ = sp_pools.routed(models, True)
    return sp_pools.replies(reqs), summary


def _both(models, tmp_path, spec, jax_kw=None, **kw):
    """The same routed run in both packages; checks they agree and returns
    the port's."""
    want = sp_pools.routed(models, False, spec, path=tmp_path / "j.jsonl",
                           **(jax_kw if jax_kw is not None else kw))
    got = sp_pools.routed(models, True, spec, path=tmp_path / "t.jsonl",
                          **kw)
    sp_pools.same_run(want, got)
    return got


def _accounted(summary, n=12):
    assert summary["requests"] == n == summary["completed"] \
        + summary["unserved"] + summary["shed"] + summary["failed"]


def test_armed_idle_router_is_inert(models, baseline, tmp_path):
    expected, base = baseline
    reqs, summary, inj, _, _ = _both(
        models, tmp_path, "", retry_policy=RetryPolicy(),
        jax_kw=dict(retry_policy=JRetry()))
    assert sp_pools.replies(reqs) == expected
    assert inj.fired() == 0
    for k in ("completed", "unserved", "shed", "failed", "handoffs",
              "affinity_hits", "kv_refetches", "retries", "kv_rebuilds",
              "replica_down", "steps", "p50_s", "p99_s", "ttft_p50_s",
              "virtual_s"):
        assert summary[k] == base[k], k


@pytest.mark.parametrize("spec,check", [
    # a decode replica dies mid-run: in-flight sessions re-prefill their
    # carried tokens, queued handoffs retransmit
    ("replica_crash@3", lambda s: s["replica_down"] == 1
     and s["replicas_live"] == 2),
    # an untrusted payload is discarded and rebuilt by re-prefilling
    ("kv_corrupt@2", lambda s: s["kv_rebuilds"] >= 1 and s["retries"] >= 1),
    # a dropped transfer retransmits; the payload survived host-side
    ("handoff_drop@2", lambda s: s["retries"] >= 1
     and s["kv_rebuilds"] == 0),
    # both decode replicas down at one boundary: handoffs park until the
    # first revival, burning no retry
    ("replica_crash@1x2", lambda s: s["replica_down"] == 2
     and s["replicas_live"] == 2),
], ids=["replica_crash", "kv_corrupt", "handoff_drop", "all_decode_down"])
def test_fault_recovers_with_identical_replies(models, baseline, tmp_path,
                                               spec, check):
    expected, _ = baseline
    reqs, summary, inj, _, records = _both(models, tmp_path, spec)
    assert sp_pools.replies(reqs) == expected
    assert inj.fired() >= 1
    assert summary["completed"] == 12 and summary["failed"] == 0
    _accounted(summary)
    assert check(summary), summary
    assert [r for r in records if r["kind"] == "fault"]


def test_slow_replica_stretches_time_not_tokens(models, baseline, tmp_path):
    expected, base = baseline
    reqs, summary, inj, _, _ = _both(models, tmp_path, "slow_replica@1x4")
    assert inj.fired("slow_replica") == 4
    assert sp_pools.replies(reqs) == expected
    assert summary["completed"] == 12
    assert summary["p99_s"] > base["p99_s"]


def test_exhausted_budget_is_an_explicit_failure(models, tmp_path):
    reqs, summary, _, _, records = _both(
        models, tmp_path, "handoff_drop@1x99",
        retry_policy=RetryPolicy(attempts=2, base_delay=0.001, jitter=0.0),
        jax_kw=dict(retry_policy=JRetry(attempts=2, base_delay=0.001,
                                        jitter=0.0)))
    assert summary["failed"] >= 1
    _accounted(summary)
    faults = [r for r in records if r["kind"] == "serve_fault"]
    assert len(faults) == summary["failed"]
    assert {(f["reason"], f["attempts"]) for f in faults} == \
        {("handoff_drop", 2)}
    failed = {f["rid"] for f in faults}
    assert all(r.reply is None for r in reqs if r.rid in failed)


def test_forced_burn_sheds_explicitly(models, tmp_path):
    from flexflow_tpu.serve.router import AdmissionGate as JGate

    from flexflow_tpu_torch.serve.router import AdmissionGate

    gate = dict(latency_target_s=1e-6, window_s=100.0, bucket_rate=0.0,
                bucket_cap=0.0)
    reqs, summary, _, _, records = _both(
        models, tmp_path, None, admission=AdmissionGate(**gate),
        jax_kw=dict(admission=JGate(**gate)))
    assert summary["shed"] >= 1 and summary["completed"] >= 1
    _accounted(summary)
    sheds = [r for r in records if r["kind"] == "serve_shed"]
    assert len(sheds) == summary["shed"]
    assert all(r["burn_rate"] > 1.0 for r in sheds)
    shed = {r["rid"] for r in sheds}
    assert all(r.reply is None for r in reqs if r.rid in shed)


def test_lowest_priority_sheds_first(models):
    from flexflow_tpu_torch.serve.router import AdmissionGate, ServeRouter

    prefill, decode = models.engines(True)
    router = ServeRouter(prefill, decode, log=lambda *a: None,
                         admission=AdmissionGate(bucket_rate=0.0,
                                                 bucket_cap=1.0))
    router._burn_rate = lambda t: 99.0
    for eng in prefill:
        eng.start([], open_ended=True)
    lo, hi, mid = (sp_pools.request(t_loadgen, rid, priority=p)
                   for rid, p in ((1, 0), (2, 2), (3, 1)))
    router._admit_arrivals([lo, hi, mid], 0.0)
    assert router.sheds == 2
    assert [r.rid for r in router._shed] == [mid.rid, lo.rid]
    assert sum(eng.load() for eng in prefill) == 1


def test_hedged_decode_bit_identical(models, baseline, tmp_path):
    expected, _ = baseline
    reqs, summary, _, _, _ = _both(models, tmp_path, "slow_replica@1x6",
                                   hedge=True)
    assert sp_pools.replies(reqs) == expected
    assert summary["hedges"] >= 1 and summary["completed"] == 12


def test_resolve_hedges_first_wins(models):
    from flexflow_tpu_torch.serve.router import HEDGE_RID_BASE, ServeRouter

    prefill, decode = models.engines(True)
    router = ServeRouter(prefill, decode, log=lambda *a: None)
    router.hedges = 3

    def done(rid, done_v, reply):
        r = sp_pools.request(t_loadgen, rid)
        r.done_v, r.reply = done_v, reply
        return r

    win_prim, win_clone = done(1, 5.0, [7, 7]), \
        done(1 + HEDGE_RID_BASE, 3.0, [7, 7])
    tie_prim, tie_clone = done(2, 4.0, [8]), \
        done(2 + HEDGE_RID_BASE, 4.0, [9])
    orphan = done(3 + HEDGE_RID_BASE, 1.0, [5])
    out = router._resolve_hedges([win_prim, win_clone, tie_prim, tie_clone,
                                  orphan])
    assert [r.rid for r in out] == [1, 2]
    assert win_prim.done_v == 3.0 and router.hedge_wins == 1
    assert tie_prim.done_v == 4.0 and tie_prim.reply == [8]


def test_pending_at_drain_is_explicitly_unserved(models, tmp_path):
    """A request between the pools (a pending retransmit) when the drain
    lands is an explicit unserved, never a silent loss."""
    import numpy as np

    from flexflow_tpu.serve import loadgen as j_loadgen

    stranded = {}

    def setup_for(mod):
        def setup(router):
            req = sp_pools.request(mod, 77)
            stranded[mod.__name__] = req
            router._pseq += 1
            router._pending.append((0.0, router._pseq, "dispatch", req, 0))
        return setup

    want = sp_pools.routed(models, False, reqs=lambda lg: [],
                           drain=sp_pools.DrainAfter(0),
                           setup=setup_for(j_loadgen))
    got = sp_pools.routed(models, True, reqs=lambda lg: [],
                          drain=sp_pools.DrainAfter(0),
                          setup=setup_for(t_loadgen))
    sp_pools.same_run(want, got)
    summary = got[1]
    assert summary["drained"]
    assert (summary["unserved"], summary["completed"],
            summary["requests"]) == (1, 0, 1)
    assert stranded[t_loadgen.__name__].reply is None
    assert np.isnan(summary["p50_s"])
