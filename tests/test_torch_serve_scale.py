"""The port's serving autoscaler over two gloo ranks, against the JAX
package's engine on two devices of its virtual CPU mesh
(``tests/test_serve.py::test_autoscale_lifecycle_and_serve_resize_records``).

The tiny GPT (2 layers, d_model 32, 4 heads, vocab 64, seq 16, batch 8)
from JAX's initial parameters, the gap-then-burst load (3 requests at 500
qps, then 30 virtual seconds later 12 at 2000 qps), ``shrink_to`` 1,
``queue_hi`` 3, ``idle_boundaries`` 3.  Both re-searches run 200
proposals under a budget the clock never reaches, the port's priced on
the JAX package's constants, so that they are deterministic: each chosen
strategy equals JAX's before anything else is compared.  Then the
resizes ``[("shrink", 2, 1), ("grow", 1, 2)]``, each ``serve_resize``
record's fields but the timing and search ones, all 15 replies with
their virtual stamps, and the summary equal JAX's; rank 1, parked at
the shrink and called back at the grow, ends with rank 0's session.  In
the same world ``apps.serve`` serves the same load with the same
watermarks (its own seeded weights): one shrink, one grow, and each
rank's replies those of the app in one process.

Also: the idle branch's virtual clock on one rank against JAX's, and
the serving flags' parse into ``FFConfig``.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

import torch_ranks as tr
import torch_sim_parity as sp
from flexflow_tpu.config import FFConfig as JConfig
from flexflow_tpu_torch.config import FFConfig as TConfig

torch.set_num_threads(2)

#: the re-search: proposals that bind, a wall clock that does not
ITERS, BUDGET_S = 200, 1e6
WATERMARKS = dict(queue_hi=3, idle_boundaries=3, shrink_to=1)


def _quiet(*a, **k):
    pass


def _jax_run(machine8, tmp_path, phase="full"):
    """JAX's engine of ``phase`` on ``machine8.shrink([0, 1])``: (initial
    params, summary, replies, stamps, resizes, records, strategies)."""
    from flexflow_tpu import obs
    from flexflow_tpu.apps.serve import _build_lm
    from flexflow_tpu.serve.engine import ServeEngine
    from flexflow_tpu.utils import elastic

    model, rebuild = _build_lm(machine8.shrink([0, 1]), batch=8, seed=0,
                               tiny=True, research_budget_s=BUDGET_S)
    model.config.elastic_search_iters = ITERS

    def rebuild_iters(cfg, m):
        out = rebuild(cfg, m)
        out.config.elastic_search_iters = ITERS
        return out

    chosen = []
    saved = elastic.research_strategy

    def research(*args, **kwargs):
        strategy, info = saved(*args, **kwargs)
        chosen.append(strategy.to_json())
        return strategy, info

    elastic.research_strategy = research
    try:
        olog = obs.RunLog(str(tmp_path / "jax.jsonl"), surface="serve")
        eng = ServeEngine(model, rebuild_iters, olog=olog, log=_quiet,
                          phase=phase, **WATERMARKS)
        params = jax.tree.map(np.asarray, eng.params)
        reqs = _requests_jax()
        summary = eng.run(reqs)
        olog.close()
    finally:
        elastic.research_strategy = saved
    summary.pop("wall_s")
    done = sorted(reqs, key=lambda r: r.rid)
    stamps = [(r.rid, r.arrival_v, r.admit_v, r.first_token_v, r.done_v)
              for r in done]
    resizes = [{k: v for k, v in r.items()
                if k not in ("research_s", "research", "total_s")}
               for r in eng.resizes]
    records = [r for r in obs.read_run(olog.path)
               if r["kind"] == "serve_resize"]
    return (params, summary, {r.rid: list(r.reply) for r in done}, stamps,
            resizes, records, chosen)


def _requests_jax():
    from flexflow_tpu.serve.loadgen import synthetic_requests

    early = synthetic_requests(3, seed=0, rate_qps=500.0, vocab_size=64,
                               prompt_len=4, max_new_tokens=2)
    burst = synthetic_requests(12, seed=1, rate_qps=2000.0, vocab_size=64,
                               prompt_len=4, max_new_tokens=2,
                               start_v=early[-1].arrival_v + 30.0)
    for i, r in enumerate(burst):
        r.rid = 100 + i
    return early + burst


def test_autoscale_over_two_ranks_matches_jax(machine8, tmp_path):
    from flexflow_tpu_torch import obs

    (params, j_sum, j_replies, j_stamps, j_resizes, j_records,
     j_chosen) = _jax_run(machine8, tmp_path)
    trees = str(tmp_path / "trees.npz")
    tr.save_trees(trees, params, {})
    perf = dataclasses.asdict(sp.jax_perf())
    port_log = str(tmp_path / "port.jsonl")
    app_json = str(tmp_path / "app.json")
    cases = tr.run_ranks(tr.run_cases, 2, [
        ("serve_scale", (perf, trees, dict(research_budget_s=BUDGET_S,
                                           elastic_search_iters=ITERS),
                         WATERMARKS, port_log)),
        # then, in the same world, the app's run of the same load
        ("serve_app", (APP_ARGV + AUTOSCALE_ARGV
                       + ["--result-json", app_json],))], timeout=240.0)
    res = [c[0] for c in cases]
    summary, replies, stamps, resizes, chosen, parked = res[0]
    # the re-searches first: everything after them depends on them
    assert len(chosen) == len(j_chosen) == 2
    assert chosen == j_chosen
    assert [(r["direction"], r["from_devices"], r["to_devices"])
            for r in resizes] == [("shrink", 2, 1), ("grow", 1, 2)]
    assert resizes == j_resizes
    recs = [r for r in obs.read_run(port_log) if r["kind"] == "serve_resize"]
    assert [{k: r[k] for k in j_resizes[0]} for r in recs] == \
        [{k: r[k] for k in j_resizes[0]} for r in j_records]
    assert all(r["research"]["mode"] == "mcmc"
               and r["research"]["objective"] == "latency" for r in recs)
    assert replies == j_replies and len(replies) == 15
    assert stamps == j_stamps
    assert summary == j_sum
    assert (summary["completed"], summary["unserved"], summary["dropped"],
            summary["devices"], summary["resizes"]) == (15, 0, 0, 2, 2)
    assert not parked
    # rank 1 stood by from the shrink, came back at the grow with rank 0's
    # session, and ends with the same tokens and counts
    assert res[1][:4] == res[0][:4] and res[1][5] is False
    _check_app(tmp_path, app_json)


#: ``apps.serve`` on the same gap-then-burst load, the tiny GPT from its
#: own seed
APP_ARGV = ["gpt", "--tiny", "--device", "cpu", "-n", "3", "--rate-qps",
            "500", "--max-new-tokens", "2", "--burst", "12"]
AUTOSCALE_ARGV = ["--serve-idle-boundaries", "3", "--serve-queue-hi", "3",
                  "--shrink-to", "1"]


def _check_app(tmp_path, app_json):
    """The app over two ranks: one shrink and one grow, every request
    served, back on two ranks, each rank's replies those of the app in
    one process without the watermarks."""
    import json

    from flexflow_tpu_torch.apps import serve

    ranks = [json.loads(open(p).read())
             for p in (app_json, app_json + ".rank1")]
    one = str(tmp_path / "one.json")
    assert serve.main(APP_ARGV + ["--result-json", one],
                      log=_quiet) == 0
    want = json.loads(open(one).read())
    for got in ranks:
        assert [(r["direction"], r["from_devices"], r["to_devices"])
                for r in got["resizes"]] == [("shrink", 2, 1),
                                             ("grow", 1, 2)]
        s = got["summary"]
        assert (s["completed"], s["unserved"], s["dropped"],
                s["devices"]) == (15, 0, 0, 2)
        assert got["replies"] == want["replies"]
        assert not got["out_of_service"]
        # each rank's records are whole, the returning rank's grow too
        assert all(r["total_s"] >= r["research_s"] >= 0
                   for r in got["resizes"])


def test_idle_branch_clock_matches_jax(machine1, pair_tiny):
    """One rank, ``idle_boundaries`` 2 and no rebuild: the idle
    boundaries step the virtual clock by ``step_time_s`` until the streak
    passes the watermark, then jump to the next arrival; ``vnow`` at
    every boundary equals JAX's."""
    from flexflow_tpu.serve.engine import ServeEngine as JEngine

    from flexflow_tpu_torch.serve.engine import ServeEngine as TEngine

    jm, tm, tp = pair_tiny
    clocks = []
    for eng, reqs in ((JEngine(jm, None, log=_quiet, idle_boundaries=2),
                       _requests_jax()),
                      (TEngine(tm, None, params=tp, log=_quiet,
                               idle_boundaries=2), tr.scale_requests())):
        eng.start(reqs)
        seen = [eng.session_vnow()]
        while eng.step_once():
            seen.append(eng.session_vnow())
        eng.finish()
        clocks.append(seen)
    assert clocks[0] == clocks[1]
    steps = np.diff(clocks[1])
    # some idle boundaries advance by exactly one step time, then jump
    assert any(d == pytest.approx(0.01) for d in steps)
    assert max(steps) > 1.0


def test_adopt_resize_mid_session_matches_jax(machine1, pair_tiny):
    """A resize made outside the engine, adopted between two steps
    (``adopt_resize``, a coordinator's surface): the rebuilt model and
    the carried params take over, the KV cache restarts empty and the
    next step refills it; the replies and virtual stamps equal JAX's
    engine adopting the same at the same boundary, and the run's
    without the resize."""
    from flexflow_tpu.apps.serve import _build_lm
    from flexflow_tpu.serve.engine import ServeEngine as JEngine

    from flexflow_tpu_torch.apps import serve
    from flexflow_tpu_torch.serve.engine import ServeEngine as TEngine

    jm, tm, tp = pair_tiny
    jnew, _ = _build_lm(machine1, batch=8, seed=0, tiny=True)
    tnew, _ = serve.build_lm(batch=8, seed=0, tiny=True, device="cpu")
    runs = []
    for eng, new, reqs in (
            (JEngine(jm, None, log=_quiet), jnew, _requests_jax()),
            (TEngine(tm, None, params=tp, log=_quiet), tnew,
             tr.scale_requests()),
            (TEngine(tm, None, params=tp, log=_quiet), None,
             tr.scale_requests())):
        eng.start(reqs)
        for _ in range(ADOPT_AFTER_STEPS):
            assert eng.step_once()
        if new is not None:
            eng.adopt_resize(new, {"params": eng.params,
                                   "state": eng.state}, parked=[1])
            assert eng.model is new and eng._parked == [1]
            if isinstance(eng, TEngine):
                assert eng._kv_filled == [0] * 8
        while eng.step_once():
            pass
        eng.finish()
        done = sorted(reqs, key=lambda r: r.rid)
        runs.append([(r.rid, list(r.reply), r.arrival_v, r.admit_v,
                      r.first_token_v, r.done_v) for r in done])
    assert runs[1] == runs[0] == runs[2]
    assert len(runs[0]) == 15


#: the boundary at which the adopted resize lands: mid-burst, seven
#: requests in flight with their KV cache filled
ADOPT_AFTER_STEPS = 7


@pytest.fixture(scope="module")
def pair_tiny(machine1):
    from flexflow_tpu.apps.serve import _build_lm

    from flexflow_tpu_torch.apps import serve
    from flexflow_tpu_torch.interop import params_from_jax

    jm, _ = _build_lm(machine1, batch=8, seed=0, tiny=True)
    jp, _ = jm.init(0)
    tm, _ = serve.build_lm(batch=8, seed=0, tiny=True, device="cpu")
    return jm, tm, params_from_jax(jax.tree.map(np.asarray, jp), "cpu")


@pytest.mark.parametrize("flag,field", [
    ("--max-batch", "max_batch"),
    ("--serve-queue-hi", "serve_queue_hi"),
    ("--serve-idle-boundaries", "serve_idle_boundaries"),
    ("--serve-prefill-devices", "serve_prefill_devices"),
    ("--serve-prefill-replicas", "serve_prefill_replicas"),
    ("--serve-decode-replicas", "serve_decode_replicas"),
])
def test_serving_flags_parse_as_jax(flag, field):
    assert getattr(TConfig(), field) == getattr(JConfig(), field)
    assert getattr(TConfig.from_args([flag, "3"]), field) == \
        getattr(JConfig.from_args([flag, "3"]), field) == 3


def test_serve_app_parses_the_autoscale_and_pool_flags():
    from flexflow_tpu.apps.serve import parse_args as j_parse

    from flexflow_tpu_torch.apps.serve import parse_args

    argv = ["gpt", "--serve-queue-hi", "3", "--serve-idle-boundaries", "4",
            "--shrink-to", "1", "--serve-prefill-devices", "2",
            "--serve-prefill-replicas", "2", "--serve-decode-replicas", "2"]
    got, want = parse_args(argv), j_parse(argv)
    for key in ("queue_hi", "idle_boundaries", "shrink_to",
                "prefill_devices", "prefill_replicas", "decode_replicas"):
        assert got[key] == want[key], key
