"""``apps.search --audit`` (the port's executor-grounded accept) against
the JAX package's, on JAX's chip constants:

  * AlexNet on 4 devices in fast-tier groups of 2: both searches find
    the same plan, both audits reject it and the canonical re-search's,
    and both write data parallelism; each audit's cross-tier MB and
    predicted seconds stand pinned beside JAX's, within 5 % of them; the
    port's result and record carry no ``error``, and the record beside
    the saved strategy names the plan written;
  * the transformer on 8 devices in groups of 4: the accepted
    ``__pipeline__`` block's audit takes JAX's decision on the same
    modeled comm and claimed win, its predicted seconds pinned beside
    JAX's, within 5 %.

The two executors differ (a regrid chain's hops are not GSPMD's
reshards), so the counts are held close and pinned, not equal."""

import json

import pytest


@pytest.fixture
def jax_constants(monkeypatch):
    """The port's search on the JAX package's chip constants and links."""
    import torch_sim_parity as sp

    from flexflow_tpu_torch.machine import Topology
    from flexflow_tpu_torch.sim import cost_model

    perf = sp.jax_perf()
    monkeypatch.setattr(cost_model, "HopperChipPerf", lambda: perf)
    monkeypatch.setattr(Topology, "hopper", classmethod(
        lambda cls, g=8: cls(devices_per_ici_group=g)))


def test_search_audit_takes_jax_decision(tmp_path, jax_constants,
                                         machine8):
    from flexflow_tpu.apps import search as j_search
    from flexflow_tpu_torch.apps import search as t_search

    argv = ["alexnet", "--devices", "4", "--ici-group", "2", "-b", "8",
            "-i", "10", "--audit"]
    t = t_search.main(argv + ["-o", str(tmp_path / "t.json"),
                              "--device", "cpu"], log=lambda *a: None)
    j = j_search.main(argv + ["-o", str(tmp_path / "j.json")],
                      log=lambda *a: None)
    ta, ja = t["hlo_audit"], j["hlo_audit"]
    assert "error" not in ta and "error" not in ja
    # the record is written beside the strategy
    recs = [json.loads(line) for line in
            open(tmp_path / "t.trace.jsonl").read().splitlines()]
    assert [r for r in recs if r["kind"] == "hlo_audit"][0]["plan"] == \
        ta["plan"]

    def first(a):
        return a.get("consistent") if "rejected_searched" not in a \
            else a["rejected_searched"]["consistent"]

    assert first(ta) is first(ja) is False
    assert ta["plan"] == ja["plan"] == "dp"
    assert t["speedup_vs_dp"] == j["speedup_vs_dp"] == 1.0
    for key, cross, pred in (("rejected_searched", (77.9, 78.06),
                              (0.004241, 0.004308)),
                             ("rejected_canonical", (95.34, 91.65),
                              (0.003169, 0.003154))):
        tr, jr = ta[key], ja[key]
        assert tr["consistent"] is jr["consistent"] is False
        assert (tr["searched_cross_mb"], jr["searched_cross_mb"]) == cross
        assert tr["dp_cross_mb"] == jr["dp_cross_mb"]
        assert (tr["searched_pred_s"], jr["searched_pred_s"]) == \
            pytest.approx(pred, abs=1e-6)
        assert tr["searched_cross_mb"] == pytest.approx(
            jr["searched_cross_mb"], rel=0.05)
        assert tr["searched_pred_s"] == pytest.approx(
            jr["searched_pred_s"], rel=0.05)


def test_pipeline_block_audit_takes_jax_decision(tmp_path, jax_constants,
                                                 machine8):
    from flexflow_tpu.apps import search as j_search
    from flexflow_tpu_torch.apps import search as t_search

    argv = ["transformer", "--devices", "8", "-b", "32", "-i", "10",
            "--ici-group", "4"]
    t = t_search.main(argv + ["-o", str(tmp_path / "t.json"),
                              "--device", "cpu"], log=lambda *a: None)
    j = j_search.main(argv + ["-o", str(tmp_path / "j.json")],
                      log=lambda *a: None)
    tp, jp = t["pipeline"], j["pipeline"]
    assert tp["accepted"] is jp["accepted"] is True
    assert tp["best"] == jp["best"]
    td, jd = tp["audit"], jp["audit"]
    assert td["consistent"] is jd["consistent"] is True
    for k in ("modeled_comm_s", "claimed_win_s", "stages",
              "microbatches", "tp"):
        assert td[k] == jd[k]
    assert (td["compiled_pred_s"], jd["compiled_pred_s"]) == \
        pytest.approx((0.010673, 0.011135), abs=1e-6)
    assert td["compiled_pred_s"] == pytest.approx(jd["compiled_pred_s"],
                                                  rel=0.05)
    for name in ("t", "j"):
        assert "__pipeline__" in json.loads(
            (tmp_path / f"{name}.json").read_text())
