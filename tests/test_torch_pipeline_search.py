"""The strategy search's GPipe proposal in the PyTorch port
(``StrategySearch.propose_pipeline``, ``apps.search``'s ``__pipeline__``
block) against the JAX package's (``flexflow_tpu/sim/search.py:1178``,
``flexflow_tpu/apps/search.py:595-640``).

On the JAX package's constants (``torch_sim_parity``) both searches must
list the same (stages, microbatches, tp) candidates in one order, each
term within 1e-9 relative, take the same decision and emit the same
``pipeline_candidate`` and ``pipeline_decision`` records, on one tier of
8 devices, with a ``tp_divisor`` and a ``reference_s``, and on two
tiers of 4 (``--ici-group 4``), where a cut crosses the slow tier.  The
app writes JAX's ``__pipeline__`` block and ``result["pipeline"]``, a
proto ``-o`` the JSON sidecar, and an accepted block on two tiers is
audited (its collectives against its modeled comm) unless
``--no-audit``.
"""

import json

import pytest
import torch

import torch_sim_parity as sp

torch.set_num_threads(2)

#: terms of a candidate, relative
TERM_RTOL = 1e-9


class _Records:
    """An obs sink that keeps its records."""

    enabled = True

    def __init__(self):
        self.records = []

    def event(self, kind, **fields):
        self.records.append((kind, fields))

    def close(self):
        pass


def _pipeline_records(sink):
    return [r for r in sink.records if r[0].startswith("pipeline_")]


def _same(a, b):
    """Equal, with floats within TERM_RTOL (recursively)."""
    if isinstance(a, float) or isinstance(b, float):
        return sp.rel(float(a), float(b)) <= TERM_RTOL
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_same(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(_same(x, y) for x, y in zip(a, b))
    return a == b


@pytest.mark.parametrize("ici,kw", [
    (None, {}),
    (None, dict(tp_divisor=4, batch=32, stage_divisor=12)),
    (None, dict(reference_s=1e-9)),
    (4, dict(tp_divisor=4, batch=32, stage_divisor=12)),
], ids=["one-tier", "tp-divisor", "reference-wins", "two-tier"])
def test_propose_pipeline_equals_jax(ici, kw):
    js, ps = sp.pair("transformer", 8, ici, batch=32)
    js.obs, ps.obs = _Records(), _Records()
    jlog, plog = [], []
    want = js.propose_pipeline(log=jlog.append, **kw)
    got = ps.propose_pipeline(log=plog.append, **kw)
    key = [(c["stages"], c["microbatches"], c["tp"])
           for c in want["candidates"]]
    assert [(c["stages"], c["microbatches"], c["tp"])
            for c in got["candidates"]] == key
    assert len(key) >= 4
    if "tp_divisor" in kw:
        assert {c["tp"] for c in got["candidates"]} > {1}
    for c, w in zip(got["candidates"], want["candidates"]):
        assert _same(c, w), (c, w)
    assert got["accepted"] == want["accepted"]
    assert got["best"] == want["best"]
    assert _same(got["reference_time_s"], want["reference_time_s"])
    if "reference_s" in kw:
        assert not got["accepted"] and got["best"] is None
    assert _same(_pipeline_records(ps.obs), _pipeline_records(js.obs))
    assert len(plog) == len(jlog) == len(key) + 1
    assert all("bubble" in s and "tp" in s and "sync" in s
               for s in plog[:-1])
    assert plog[-1].startswith("pipeline decision:")
    if ici:
        # a cut between the two groups of 4 rides the slow tier
        two = [c for c in got["candidates"] if c["stages"] == 2]
        one_tier = sp.pair("transformer", 8, None, batch=32)[1]
        flat = {(c["stages"], c["microbatches"], c["tp"]): c
                for c in one_tier.propose_pipeline(
                    log=lambda *a: None, **kw)["candidates"]}
        assert all(c["comm_s"] > flat[(2, c["microbatches"],
                                       c["tp"])]["comm_s"] for c in two)


@pytest.fixture
def jax_constants(monkeypatch):
    """The port's app on the JAX package's chip constants and links."""
    from flexflow_tpu_torch.machine import Topology
    from flexflow_tpu_torch.sim import cost_model

    perf = sp.jax_perf()
    monkeypatch.setattr(cost_model, "HopperChipPerf", lambda: perf)
    monkeypatch.setattr(Topology, "hopper", classmethod(
        lambda cls, g=8: cls(devices_per_ici_group=g)))


ARGV = ["transformer", "--devices", "8", "-b", "32", "-i", "1000"]


def _run(main, argv):
    lines = []
    out = main(argv, log=lines.append)
    line = next(json.loads(s) for s in lines if s.startswith("{"))
    return out, line, lines


@pytest.mark.parametrize("suffix", [".json", ".pb"])
def test_app_writes_the_jax_drivers_pipeline_block(tmp_path, jax_constants,
                                                   suffix):
    from flexflow_tpu.apps import search as jax_app

    from flexflow_tpu_torch.apps import search

    jpath, tpath = tmp_path / f"jax{suffix}", tmp_path / f"port{suffix}"
    jout, jline, _ = _run(jax_app.main, ARGV + ["-o", str(jpath)])
    tout, tline, lines = _run(search.main, ARGV + ["-o", str(tpath)])
    assert tline["pipeline"] == jline["pipeline"]
    assert tline["pipeline"]["accepted"]
    assert tout["strategy"].pipeline == jout["strategy"].pipeline \
        == tline["pipeline"]["best"]
    assert tpath.read_bytes() == jpath.read_bytes()
    assert sum(s.startswith("pipeline candidate") for s in lines) >= 4
    assert any(s.startswith("pipeline decision: ACCEPT") for s in lines)
    sidecar = tmp_path / f"port{suffix}.pipeline.json"
    if suffix == ".json":
        assert json.loads(tpath.read_text())["__pipeline__"] \
            == tline["pipeline"]["best"]
        assert not sidecar.exists()
    else:
        # the proto wire format cannot carry the block: the sidecar does
        assert sidecar.read_bytes() == \
            (tmp_path / f"jax{suffix}.pipeline.json").read_bytes()
        assert json.loads(sidecar.read_text())["__pipeline__"] \
            == tline["pipeline"]["best"]
        assert any("cannot carry the accepted __pipeline__" in s
                   for s in lines)


def test_accepted_block_on_two_tiers_needs_no_audit(tmp_path,
                                                    jax_constants):
    from flexflow_tpu_torch.apps import search

    out = tmp_path / "s.json"
    # ten proposals find no per-op win, so the block's own audit is the
    # one that runs: the pipelined program's collectives against its
    # modeled comm, the block kept exactly where they hold
    argv = ["transformer", "--devices", "8", "-b", "32", "-i", "10",
            "--ici-group", "4", "-o", str(out)]
    audited = search.main(argv, log=lambda *a: None)
    detail = audited["pipeline"]["audit"]
    assert detail["plan"] == "pipeline"
    # the pipelined program's collectives price within its modeled comm
    # plus half the claimed win (JAX's decision on these argv:
    # tests/test_torch_audit_search.py)
    assert detail["compiled_pred_s"] == pytest.approx(0.010673, abs=1e-6)
    assert detail["consistent"] is True
    assert detail["compiled_pred_s"] <= detail["modeled_comm_s"] + \
        0.5 * detail["claimed_win_s"]
    assert audited["pipeline"]["accepted"] == detail["consistent"]
    assert ("__pipeline__" in json.loads(out.read_text())) \
        == detail["consistent"]
    res = search.main(argv + ["--no-audit"], log=lambda *a: None)
    assert res["speedup_vs_dp"] <= 1.05 and res["pipeline"]["accepted"]
    assert json.loads(out.read_text())["__pipeline__"] \
        == res["pipeline"]["best"]
