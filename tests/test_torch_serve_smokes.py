"""The serving app's three smokes (``python -m flexflow_tpu_torch.apps.serve
--smoke|--disagg-smoke|--chaos-smoke``) against the JAX app's
(``flexflow_tpu/apps/serve.py:414-828``), on the JAX package's cost
constants (``torch_sim_parity.jax_perf``).

The port's replicas are one card each (here the CPU) with JAX's slots,
loads and step times, each priced at the JAX replica's width (its KV
layout's grid and the decode pool's step ratio from a shadow graph of
that width), so their virtual clocks are JAX's:

* ``--disagg-smoke`` and ``--chaos-smoke`` pass their own assertions,
  and their summaries (the drain's and the armed router's too) and
  record counts equal the JAX smokes' on its 8-device CPU mesh, but for
  the device counts (a port replica holds one card);
* ``--smoke``'s equivalence (batch 8 against batch 1) holds on one rank,
  and a differing reply names its request, position and top-2 gap;
* ``--smoke``'s lifecycle over two gloo ranks shrinks 2 -> 1 and grows
  back, 46 completed, and equals JAX's engine on ``machine8.shrink([0,
  1])`` with the same watermarks and load in summary, resizes and
  record counts;
* ``--smoke`` refuses one rank.
"""

import collections

import pytest
import torch

import torch_ranks as tr
import torch_sim_parity as sp

torch.set_num_threads(2)

#: summary fields that count devices, which differ by construction
DEVICE_FIELDS = ("devices", "pools", "wall_s")


def _quiet(*a, **k):
    pass


@pytest.fixture
def jax_constants(monkeypatch):
    from flexflow_tpu_torch.sim import cost_model

    perf = sp.jax_perf()
    monkeypatch.setattr(cost_model, "HopperChipPerf", lambda: perf)


def _kinds(olog):
    from flexflow_tpu_torch import obs

    return collections.Counter(r["kind"] for r in obs.read_run(olog.path)
                               if r["kind"] not in ("run_start", "run_end"))


def _same(a, b):
    drop = lambda s: {k: v for k, v in s.items()  # noqa: E731
                      if k not in DEVICE_FIELDS and not k.startswith("_")}
    assert sp_nan(drop(a)) == sp_nan(drop(b))


def sp_nan(d):
    return {k: ("nan" if isinstance(v, float) and v != v else v)
            for k, v in d.items()}


@pytest.mark.parametrize("which", ["disagg", "chaos"])
def test_routed_smoke_equals_jax(tmp_path, jax_constants, which):
    from flexflow_tpu.apps import serve as jax_app

    from flexflow_tpu_torch.apps import serve

    jopts = jax_app.parse_args([f"--{which}-smoke", "-obs-dir",
                                str(tmp_path / "jax")])
    topts = serve.parse_args([f"--{which}-smoke", "--device", "cpu",
                              "-obs-dir", str(tmp_path / "port")])
    jrun = getattr(jax_app, f"_smoke_{which}")
    trun = getattr(serve, f"_smoke_{which}")
    jsum, lines = jrun(jopts, _quiet), []
    tsum = trun(topts, lines.append)
    _same(tsum, jsum)
    assert _kinds(tsum["_olog"]) == _kinds(jsum["_olog"])
    assert any(ln.startswith(f"{which}-smoke") and " ok" in ln
               for ln in lines)
    assert any("latency histogram" in ln for ln in lines)
    assert tsum["devices"] == (3 if which == "disagg" else 4)


def test_smoke_equivalence_on_one_rank():
    from flexflow_tpu_torch.apps import serve

    lines = []
    serve._smoke_equivalence({"device": "cpu"}, lines.append)
    assert lines[-1].startswith("serve-smoke equivalence ok: 5 replies")


def test_a_differing_reply_names_request_position_and_gap():
    from flexflow_tpu_torch.apps import serve
    from flexflow_tpu_torch.serve.loadgen import synthetic_requests

    eng = serve._tiny_engine("cpu", 1)
    reqs = synthetic_requests(2, seed=0, rate_qps=1000.0, vocab_size=64,
                              prompt_len=4, max_new_tokens=3)
    eng.run(reqs)
    want = serve._replies(reqs)
    got = dict(want)
    got[1] = want[1][:1] + [(want[1][1] + 1) % 64] + want[1][2:]
    serve._assert_same_replies(want, want, reqs, eng, "same")
    with pytest.raises(AssertionError,
                       match=r"request 1 differs at position 1 .*gap"):
        serve._assert_same_replies(got, want, reqs, eng, "changed")


def test_smoke_refuses_one_rank():
    from flexflow_tpu_torch.apps import serve

    with pytest.raises(SystemExit, match="at least 2"):
        serve.main(["--smoke", "--device", "cpu"], log=_quiet)


def _jax_lifecycle(machine8, tmp_path):
    """JAX's smoke lifecycle on ``machine8.shrink([0, 1])`` with the
    port's two-rank target (``shrink_to`` 1)."""
    from flexflow_tpu import obs
    from flexflow_tpu.apps.serve import _build_lm
    from flexflow_tpu.serve.engine import ServeEngine
    from flexflow_tpu.serve.loadgen import synthetic_requests

    model, rebuild = _build_lm(machine8.shrink([0, 1]), batch=24, seed=0,
                               research_budget_s=2.0, tiny=True)
    olog = obs.RunLog(str(tmp_path / "jax.jsonl"), surface="serve")
    engine = ServeEngine(model, rebuild, olog=olog, log=_quiet, queue_hi=4,
                         idle_boundaries=3, shrink_to=1)
    early = synthetic_requests(6, seed=0, rate_qps=500.0, vocab_size=64,
                               prompt_len=4, max_new_tokens=3)
    burst = synthetic_requests(40, seed=1, rate_qps=2000.0, vocab_size=64,
                               prompt_len=4, max_new_tokens=3,
                               start_v=early[-1].arrival_v + 30.0)
    for i, r in enumerate(burst):
        r.rid = 100 + i
    summary = engine.run(early + burst)
    olog.close()
    summary.pop("wall_s")
    kinds = collections.Counter(r["kind"] for r in obs.read_run(olog.path))
    return summary, [{k: v for k, v in r.items()
                      if k not in ("research_s", "research", "total_s")}
                     for r in engine.resizes], dict(kinds)


def test_smoke_lifecycle_over_two_ranks_equals_jax(machine8, tmp_path):
    jsum, jres, jkinds = _jax_lifecycle(machine8, tmp_path)
    res = tr.run_ranks(tr.serve_smoke, 2, str(tmp_path / "obs"),
                       timeout=240.0)
    summary, resizes, kinds = res[0]
    assert [(r["direction"], r["from_devices"], r["to_devices"])
            for r in resizes] == [("shrink", 2, 1), ("grow", 1, 2)]
    assert resizes == jres
    assert summary["completed"] == 46 and summary["unserved"] == 0 \
        and summary["dropped"] == 0 and summary["devices"] == 2
    assert summary == jsum
    for k in ("serve_request", "serve_batch", "serve_resize",
              "serve_summary"):
        assert kinds[k] == jkinds[k], k
    # rank 1, parked at the shrink and called back, ends in rank 0's
    # session
    assert res[1][0] == summary and res[1][1] == resizes
