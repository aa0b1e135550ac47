"""The serving search of the PyTorch port against the JAX package's
(``flexflow_tpu/sim/search.py``, ``flexflow_tpu/apps/search.py``,
``tests/test_disagg.py``), on the tiny GPT (2 layers, d_model 32, 4
heads, d_ff 128, vocab 64, seq 16, batch 8) and the JAX package's cost
constants (``torch_sim_parity.jax_perf``):

* the ``decode`` objective's simulator tables (costs, collectives, the
  zeroed param bytes) on 8 virtual devices equal JAX's, and a flat search
  under a fixed seed reaches JAX's best time and assignment; the decode
  step prices below the latency step; the objective's validation; a
  decode-objective artifact is vetted as the decode phase;
* ``price_on_slice`` on 2 and 4 virtual devices equals JAX's;
* ``apps.search gpt --serve`` and ``--serve --disagg 2`` write JAX's
  ``__predicted__`` block key for key; the plan checker reads the
  artifact back and ``apps.serve -s`` takes ``forward_step_s`` as its
  step;
* an autoscaling ``phase="decode"`` engine over two gloo ranks
  re-searches under ``decode`` and equals JAX's engine on
  ``machine8.shrink([0, 1])``: its strategies, ``serve_resize`` records,
  replies and virtual stamps.
"""

import dataclasses
import json

import numpy as np
import pytest
import torch

import test_torch_serve_scale as scale
import torch_ranks as tr
import torch_sim_parity as sp

torch.set_num_threads(2)

TINY = dict(seq_length=16, num_layers=2, d_model=32, num_heads=4, d_ff=128,
            vocab_size=64)


def _tiny_lms(n, batch=8):
    """(JAX, port) tiny causal GPTs on ``n`` virtual devices."""
    from flexflow_tpu.models.transformer import TransformerConfig as JCfg
    from flexflow_tpu.models.transformer import TransformerLM as JLM

    from flexflow_tpu_torch.models.transformer import (TransformerConfig,
                                                       TransformerLM)

    jm, tm = sp.machines(n)
    kw = dict(TINY, batch_size=batch, causal=True)
    return (JLM(JCfg(**kw), jm), TransformerLM(TransformerConfig(**kw), tm),
            jm, tm)


@pytest.fixture(scope="module")
def decode8():
    jlm, tlm, jm, tm = _tiny_lms(8)
    return sp.searches(jlm, tlm, jm, tm, objective="decode")


def test_decode_tables_and_search_equal_jax(decode8):
    js, ts = decode8
    assert ts.objective == js.objective == "decode"
    np.testing.assert_array_equal(ts.sim._ints, js.sim._ints)
    np.testing.assert_array_equal(ts.sim._dbls, js.sim._dbls)
    # no gradient sync, no optimizer stream
    n_ops = len(ts.ops)
    assert not np.any(np.asarray(ts.sim._dbls[3:3 + n_ops]))
    assert ts._opt_stream_s == js._opt_stream_s == 0.0
    kw = dict(iters=2000, seed=0)
    jstrat, jinfo = js.search(**kw)
    tstrat, tinfo = ts.search(**kw)
    assert tinfo["best_time"] == jinfo["best_time"]
    assert tinfo["dp_time"] == jinfo["dp_time"]
    assert tinfo["assignment"] == jinfo["assignment"]
    assert tstrat.to_json() == jstrat.to_json()


def test_decode_prices_below_latency(decode8):
    """``tests/test_disagg.py:150``: a single-token step prices well under
    the full forward (the per-token cost divides by seq, the KV stream
    rides on top)."""
    from flexflow_tpu_torch.sim.search import StrategySearch

    _, dec = decode8
    lat = StrategySearch(dec.model, dec.machine,
                         cost_model=sp.port_analytic(dec.model),
                         objective="latency")
    _, li = lat.search(iters=30, seed=0)
    _, di = dec.search(iters=30, seed=0)
    assert di["best_time"] < li["best_time"]


def test_objective_validation():
    """``tests/test_disagg.py:141``."""
    from flexflow_tpu_torch.sim.search import StrategySearch

    _, tlm, _, tm = _tiny_lms(8)
    with pytest.raises(ValueError, match="decode"):
        StrategySearch(tlm, tm, objective="bogus")
    assert StrategySearch(tlm, tm, objective="decode").objective == "decode"


def test_decode_objective_implies_decode_phase():
    """``tests/test_disagg.py:401``: a decode-objective artifact is vetted
    as the decode phase, with the KV cache charged to it."""
    from flexflow_tpu_torch.strategy import Strategy
    from flexflow_tpu_torch.verify.plan import plan_findings

    _, tlm, _, tm = _tiny_lms(8)
    strat = Strategy()
    strat.predicted = {"objective": "decode", "serve": {"max_batch": 8}}
    _, summary = plan_findings(tlm, strat, tm)
    assert summary["serving"]["phase"] == "decode"
    assert summary["serving"]["kv_cache_bytes_per_device"] > 0


@pytest.fixture
def jax_constants(monkeypatch):
    """The port on the JAX package's chip constants and links."""
    from flexflow_tpu_torch.machine import Topology
    from flexflow_tpu_torch.sim import cost_model

    perf = sp.jax_perf()
    monkeypatch.setattr(cost_model, "HopperChipPerf", lambda: perf)
    monkeypatch.setattr(Topology, "hopper", classmethod(
        lambda cls, g=8: cls(devices_per_ici_group=g)))


@pytest.mark.parametrize("objective", ["latency", "decode"])
def test_price_on_slice_equals_jax(jax_constants, objective):
    from flexflow_tpu.models.transformer import TransformerConfig as JCfg
    from flexflow_tpu.models.transformer import TransformerLM as JLM
    from flexflow_tpu.sim.search import price_on_slice as jax_price

    from flexflow_tpu_torch.models.transformer import (TransformerConfig,
                                                       TransformerLM)
    from flexflow_tpu_torch.sim.search import price_on_slice

    kw = dict(TINY, batch_size=8, causal=True)
    jcfg_t, tcfg_t = JCfg(**kw), TransformerConfig(**kw)
    jlm, tlm, _, _ = _tiny_lms(2)
    warm = {}
    for n in (2, 4):
        jt, js, ji = jax_price(lambda c, m: JLM(jcfg_t, m, c.strategies),
                               jlm.config, n, objective=objective,
                               iters=300, seed=0,
                               warm_strategy=warm.get("jax"))
        tt, ts, ti = price_on_slice(
            lambda c, m: TransformerLM(tcfg_t, m, c.strategies),
            tlm.config, n, objective=objective, iters=300, seed=0,
            warm_strategy=warm.get("port"))
        assert tt == jt and ti["assignment"] == ji["assignment"]
        assert ts.to_json() == js.to_json()
        # the next slice starts from this one's plan
        warm = {"jax": js, "port": ts}


def _tiny_build(pkg):
    """``build_model`` of ``apps.search`` of package ``pkg``, on the tiny
    causal GPT for ``gpt``."""
    if pkg == "jax":
        from flexflow_tpu.models.transformer import (TransformerConfig,
                                                     TransformerLM)
    else:
        from flexflow_tpu_torch.models.transformer import (
            TransformerConfig, TransformerLM)

    def build(name, machine, batch_size, dtype="float32", experts=0):
        assert name == "gpt"
        return TransformerLM(TransformerConfig(
            batch_size=batch_size, compute_dtype=dtype, causal=True,
            **TINY), machine)
    return build


@pytest.fixture
def tiny_search_apps(jax_constants, monkeypatch):
    from flexflow_tpu.apps import search as jax_app

    from flexflow_tpu_torch.apps import search

    monkeypatch.setattr(jax_app, "build_model", _tiny_build("jax"))
    monkeypatch.setattr(search, "build_model", _tiny_build("port"))
    return jax_app, search


def _run(main, argv):
    lines = []
    out = main(argv, log=lines.append)
    line = next(json.loads(s) for s in lines if s.startswith("{"))
    return out, line


@pytest.mark.parametrize("flags", [["--serve"], ["--serve", "--disagg", "2"],
                                   ["--serve", "--objective", "decode"]],
                         ids=["serve", "disagg2", "serve-decode"])
def test_serve_artifact_equals_jax(tmp_path, tiny_search_apps, flags):
    from flexflow_tpu_torch.strategy import Strategy
    from flexflow_tpu_torch.verify.plan import (plan_findings,
                                                strategy_file_findings)

    jax_app, search = tiny_search_apps
    argv = ["gpt", "--devices", "8", "-b", "8", "-i", "400"] + flags
    jpath, tpath = tmp_path / "jax.json", tmp_path / "port.json"
    _, jline = _run(jax_app.main, argv + ["-o", str(jpath)])
    out, tline = _run(search.main, argv + ["-o", str(tpath)])
    jfile, tfile = (json.loads(p.read_text()) for p in (jpath, tpath))
    assert tfile == jfile
    serve = tfile["__predicted__"]["serve"]
    assert tline["serve"] == jline["serve"] == serve
    assert tline["objective"] == ("decode" if "decode" in flags
                                  else "latency")
    if "--disagg" in flags:
        assert serve["phase"] == "prefill"
        assert set(serve["decode"]) == {"devices", "objective",
                                        "step_time_s", "speedup_vs_dp",
                                        "strategies"}
        assert serve["decode"]["step_time_s"] < \
            serve["prefill"]["step_time_s"]
    # the port's loaders and plan checker read the artifact back
    loaded = Strategy.load(str(tpath))
    assert loaded.predicted["serve"] == serve
    errs, vetted = strategy_file_findings(str(tpath))
    assert not errs and vetted.predicted["serve"] == serve
    findings, summary = plan_findings(out["search"].model, loaded,
                                      out["search"].machine)
    assert not [f for f in findings if f.severity == "error"]
    if "phase" in serve:
        assert summary["serving"]["phase"] == serve["phase"]


def test_serve_app_takes_the_artifacts_step(tmp_path, tiny_search_apps):
    """``apps.serve -s`` of a one-card ``--serve --disagg 1`` artifact:
    the single pool's engine steps at ``forward_step_s``, the decode
    pool's plan and step come from ``serve.decode``."""
    from flexflow_tpu_torch.apps import serve

    _, search = tiny_search_apps
    path = tmp_path / "serve1.json"
    search.main(["gpt", "--devices", "1", "-b", "8", "-i", "100", "--serve",
                 "--disagg", "1", "-o", str(path)], log=lambda *a: None)
    blk = json.loads(path.read_text())["__predicted__"]["serve"]
    opts = serve.parse_args(["gpt", "--tiny", "--device", "cpu", "-s",
                             str(path), "-n", "4"])
    engine, reqs, olog, _ = serve.build_engine(opts, log=lambda *a: None)
    assert engine.step_time_s == blk["forward_step_s"]
    summary = engine.run(reqs)
    assert summary["completed"] == 4
    dstrat = serve._decode_pool_strategy(engine.model.config.strategies, 8)
    assert dstrat.predicted["serve"]["decode"]["step_time_s"] == \
        blk["decode"]["step_time_s"]


# ---------------------------------------------------------------------------
# an autoscaling decode-phase engine over two ranks


def test_decode_engine_autoscales_over_two_ranks_as_jax(machine8, tmp_path):
    from flexflow_tpu_torch import obs

    (params, j_sum, j_replies, j_stamps, j_resizes, j_records,
     j_chosen) = scale._jax_run(machine8, tmp_path, phase="decode")
    trees = str(tmp_path / "trees.npz")
    tr.save_trees(trees, params, {})
    perf = dataclasses.asdict(sp.jax_perf())
    port_log = str(tmp_path / "port.jsonl")
    res = tr.run_ranks(tr.serve_scale, 2, perf, trees,
                       dict(research_budget_s=scale.BUDGET_S,
                            elastic_search_iters=scale.ITERS),
                       dict(scale.WATERMARKS, phase="decode"), port_log,
                       timeout=240.0)
    summary, replies, stamps, resizes, chosen, parked = res[0]
    assert len(chosen) == len(j_chosen) == 2
    assert chosen == j_chosen
    assert [(r["direction"], r["from_devices"], r["to_devices"])
            for r in resizes] == [("shrink", 2, 1), ("grow", 1, 2)]
    assert resizes == j_resizes
    recs = [r for r in obs.read_run(port_log) if r["kind"] == "serve_resize"]
    assert [{k: r[k] for k in j_resizes[0]} for r in recs] == \
        [{k: r[k] for k in j_resizes[0]} for r in j_records]
    assert all(r["research"]["objective"] == "decode" for r in recs)
    assert all(r["research"]["objective"] == "decode" for r in j_records)
    # the phase, its pool label and its step time outlive both rebuilds
    batches = [r for r in obs.read_run(port_log) if r["kind"] == "serve_batch"]
    assert batches and all(r.get("pool") == "decode" for r in batches)
    assert summary.get("pool", "decode") == "decode"
    assert replies == j_replies and len(replies) == 15
    assert stamps == j_stamps
    assert summary == j_sum
    assert not parked
    assert res[1][:4] == res[0][:4]
