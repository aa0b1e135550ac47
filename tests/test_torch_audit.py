"""The port's collective audit (``utils/hlo_audit.py``, ``verify/
predicted.py``, ``apps.search --audit``) against the JAX package's:

  * ``audit_consistent`` and ``audit_consistent_time`` give JAX's verdict
    dicts on the unit cases of ``tests/test_verify.py``;
  * pure data parallelism on AlexNet (4 ranks in fast-tier groups of 2
    at 224x224, 8 in groups of 4 at 67x67): the port's cross- and
    intra-tier bytes equal JAX's ``audit_in_process`` on the 8-device
    virtual CPU mesh (the port's loss all-reduce is the 4-byte record
    XLA folds into its gradient all-reduce's tuple: the totals agree);
  * the dry count equals the live count of one real step, op for op and
    group for group, on 4 gloo ranks under a 4-rank AlexNet strategy of
    ``alexnet_2x4.json``'s shape;
  * on that split plan the port's records follow XLA's instruction
    convention (the parallel groups of one collective are one record
    listing every group, counted once), its bytes and predicted seconds
    stand pinned beside JAX's, and both audits give the same verdicts;
  * (``apps.search --audit``: ``tests/test_torch_audit_search.py``);
  * ``predicted_findings`` judges a strategy's ``__predicted__`` claim.
"""

import json
import os

import pytest

from flexflow_tpu.machine import Topology as JTopology
from flexflow_tpu.utils import hlo_audit as j_audit
from flexflow_tpu_torch.machine import Topology as TTopology
from flexflow_tpu_torch.utils import hlo_audit as t_audit

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_GROUP8 = [list(range(8))]


def _rec(nbytes, op="all-reduce", cross=True):
    return {"op": op, "bytes": float(nbytes), "cross": cross,
            "groups": _GROUP8, "async": False}


def _audit(searched_mb, dp_mb, dp_records=True):
    return {"searched_collectives": [_rec(searched_mb * 1e6)],
            "dp_collectives": [_rec(dp_mb * 1e6)] if dp_records else None,
            "searched_cross_bytes": searched_mb * 1e6,
            "dp_cross_bytes": dp_mb * 1e6}


VERDICT_CASES = [
    ((1.0, 100.0), 1.5, {}),
    ((100.0, 1.0), 1.5, {}),
    ((90.0, 100.0), 2.0, {"dp_time_s": 20.0, "best_time_s": 10.0}),
    ((90.0, 100.0), 1.3, {"dp_time_s": 1.0, "best_time_s": 0.99}),
    ((50.0, 50.0), 1.0, {}),
    ((80.0, 50.0), 1.0, {}),
    ((70.0, 100.0), 1.5, {}),
    ((0.0, 0.0), 1.5, {}),
]


@pytest.mark.parametrize("mb,speedup,kw", VERDICT_CASES)
def test_verdicts_equal_jax(mb, speedup, kw):
    for records in (True, False):
        a = _audit(*mb, dp_records=records)
        t = t_audit.audit_consistent_time(
            a, speedup, TTopology(devices_per_ici_group=4), **kw)
        j = j_audit.audit_consistent_time(
            a, speedup, JTopology(devices_per_ici_group=4), **kw)
        assert t == j
        assert t_audit.audit_consistent(a, speedup) == \
            j_audit.audit_consistent(a, speedup)


@pytest.mark.parametrize("devices,ici,size", [(4, 2, 224), (8, 4, 67)])
def test_data_parallel_bytes_equal_jax(machine8, devices, ici, size):
    over = {"input_height": size, "input_width": size}
    t = t_audit.audit_subprocess("alexnet", devices, ici, "",
                                 batch_size=16, dp_known=(0.0, 0.0),
                                 overrides=over)
    j = j_audit.audit_in_process("alexnet", devices, ici, "",
                                 batch_size=16, dp_known=(0.0, 0.0),
                                 overrides=over)
    assert (t["searched_cross_bytes"], t["searched_intra_bytes"]) == \
        (j["searched_cross_bytes"], j["searched_intra_bytes"])
    # the records: the port's bucketed gradient all-reduce and its loss
    # all-reduce (4 bytes), XLA's one tuple all-reduce of both
    ops = [(r["op"], r["bytes"], r["groups"])
           for r in t["searched_collectives"]]
    assert ops[0] == ("all-reduce", 4.0, [list(range(devices))])
    assert sum(b for _, b, _ in ops) == sum(
        r["bytes"] for r in j["searched_collectives"])
    assert all(r["cross"] == (devices > ici)
               for r in t["searched_collectives"])


def _four_rank_strategy() -> str:
    """``alexnet_2x4.json``'s shape on 4 ranks: channel splits, a batch x
    channel conv, batch-split linears, ``linear3`` placed on rank 3."""
    with open(os.path.join(ROOT, "examples", "strategies",
                           "alexnet_2x4.json")) as f:
        s = json.load(f)
    out = {}
    for name, pc in s.items():
        if name.startswith("__"):
            continue
        dims = [d // 2 if d == 8 else d for d in pc["dims"]]
        if dims == [4, 1, 1, 2]:
            dims = [2, 1, 1, 2]
        elif dims == [2, 1, 1, 4]:
            dims = [1, 1, 1, 4]
        n = 1
        for d in dims:
            n *= d
        devices = [3] if len(pc["devices"]) == 1 else list(range(n))
        out[name] = {"dims": dims, "devices": devices}
    return json.dumps(out)


def test_dry_count_equals_live_count_on_4_ranks():
    from torch_fleet_ranks import audit_dry_and_live
    from torch_ranks import run_ranks

    res = run_ranks(audit_dry_and_live, 4, _four_rank_strategy(), 8, 111,
                    2, timeout=240.0)
    dry, live = res[0]
    assert dry == live
    assert len(dry) > 2
    ops = {r["op"] for r in dry}
    assert "all-reduce" in ops and ops - {"all-reduce"}
    assert any(r["cross"] for r in dry) and any(not r["cross"]
                                                for r in dry)
    for r in res[1:]:
        assert r == res[0]


def test_split_plan_audit_against_jax(machine8, tmp_path):
    path = str(tmp_path / "s.json")
    with open(path, "w") as f:
        f.write(_four_rank_strategy())
    over = {"input_height": 111, "input_width": 111}
    t = t_audit.audit_subprocess("alexnet", 4, 2, path, batch_size=8,
                                 overrides=over)
    j = j_audit.audit_in_process("alexnet", 4, 2, path, batch_size=8,
                                 overrides=over)
    # one record per collective, listing every group that runs it side
    # by side, as XLA's instruction lists its replica groups: every
    # group list of the port's is one of JAX's, the pair [0, 1] / [2, 3]
    # among them
    jgroups = [r["groups"] for r in j["searched_collectives"]]
    tgroups = [r["groups"] for r in t["searched_collectives"]]
    assert all(g in jgroups for g in tgroups)
    assert [[0, 1], [2, 3]] in tgroups
    # the executors differ (the regrid chain's all-gathers and
    # reduce-scatters against GSPMD's all-to-alls; linear3's gather to
    # every rank against XLA's permutes to and from rank 3; XLA's
    # one-member all-reduce of 16388000 bytes, which moves nothing): both
    # counts pinned, the cross tier within 2 % of JAX's
    assert (t["searched_cross_bytes"], t["searched_intra_bytes"]) == \
        (10407428.0, 1204736.0)
    assert (j["searched_cross_bytes"], j["searched_intra_bytes"]) == \
        (10596612.0, 18645280.0)
    assert t["searched_cross_bytes"] == pytest.approx(
        j["searched_cross_bytes"], rel=0.02)
    assert (t["dp_cross_bytes"], t["dp_intra_bytes"]) == \
        (j["dp_cross_bytes"], j["dp_intra_bytes"])
    # predicted seconds, each package's records on JAX's topology
    from flexflow_tpu.sim.collectives import priced_collectives as j_price
    from flexflow_tpu_torch.sim.collectives import priced_collectives

    jt, tt = JTopology(devices_per_ici_group=2), \
        TTopology(devices_per_ici_group=2)
    pred = {k: (priced_collectives(t[k + "_collectives"], tt)["seconds"],
                j_price(j[k + "_collectives"], jt)["seconds"])
            for k in ("searched", "dp")}
    assert pred["searched"] == pytest.approx((4.6981573e-4, 5.8307817e-4),
                                             rel=1e-6)
    assert pred["dp"] == pytest.approx((3.4719976e-3, 3.4499976e-3),
                                       rel=1e-6)
    for speedup, kw in ((1.0, {}), (1.1, {}), (1.5, {}), (3.0, {}),
                        (3.0, {"dp_time_s": 0.02, "best_time_s": 0.01}),
                        (3.0, {"dp_time_s": 0.01, "best_time_s": 0.0095})):
        assert t_audit.audit_consistent(t, speedup) == \
            j_audit.audit_consistent(j, speedup)
        assert t_audit.audit_consistent_time(t, speedup, tt, **kw)[
            "consistent"] == j_audit.audit_consistent_time(
                j, speedup, jt, **kw)["consistent"]


def test_predicted_findings_on_a_claimed_strategy(tmp_path):
    from flexflow_tpu_torch.strategy import Strategy
    from flexflow_tpu_torch.verify.predicted import predicted_findings

    s = Strategy.from_json(_four_rank_strategy())
    s.predicted = {"speedup_vs_dp": 3.0}
    path = str(tmp_path / "s.json")
    s.save(path)
    over = {"input_height": 111, "input_width": 111}
    findings, summary = predicted_findings("alexnet", 4, 2, path,
                                           batch_size=8, overrides=over)
    assert summary["claim_source"] == "__predicted__"
    assert summary["claimed_speedup"] == 3.0
    assert summary["mode"] == "time"
    assert len(findings) == 1
    f = findings[0]
    assert f.pass_name == "predicted"
    assert f.code == ("consistent" if summary["consistent"]
                      else "inconsistent")
    assert f.severity == ("info" if summary["consistent"] else "error")
