"""``FFModel.fit``'s run telemetry and sampled op timing in the port
(``flexflow_tpu_torch/model.py``, ``utils/profiling.py``,
``obs/__init__.py:from_config``) against the JAX package's, on the CPU:

* the obs flags parse as JAX's do (``tests/test_trace.py:297-302``,
  ``tests/test_obs.py:445``);
* ``tests/test_trace.py``'s op-timing CNN in both packages from one
  parameter tree (``params_from_jax``), 4 steps with ``op_time_every``
  2: the same record kinds in the same order (``step_budget`` included;
  ``regrid_plan``, the summary of JAX's regrid planner, aside),
  the same op names, kinds, grids and ``measured`` flags in the op
  records, steps 2 and 4 sampled, the losses bit-equal to the port's run
  without sampling and within 1e-4 of JAX's (the CNN bar of
  ``tests/test_torch_train.py``);
* ``sim_drift`` from a file's ``__predicted__`` block, equal to JAX's,
  and from the analytic simulation of the strategy on JAX's constants
  (``tests/torch_sim_parity.py``), within 1e-9 relative; the
  ``sim_drift_unavailable`` reasons equal JAX's;
* obs off: no file, no records;
* two gloo ranks with ``op_time_every`` 2: rank 0 alone writes, the run
  ends, and its losses equal the two-rank run without sampling.
"""

import jax
import numpy as np
import pytest
import torch

import torch_ranks as tr
import torch_sim_parity as sp
from flexflow_tpu.config import FFConfig as JConfig
from flexflow_tpu.model import FFModel as JModel
from flexflow_tpu.obs import read_run as j_read_run
from flexflow_tpu_torch.config import FFConfig as TConfig
from flexflow_tpu_torch.interop import params_from_jax
from flexflow_tpu_torch.model import FFModel as TModel
from flexflow_tpu_torch.obs import read_run

torch.set_num_threads(2)

STEPS = 4
CFG = dict(batch_size=8, input_height=16, input_width=16,
           num_iterations=STEPS, print_freq=0, num_classes=8,
           learning_rate=1e-3, momentum=0.9, seed=3)
#: records the JAX fit writes of modules the port has not yet
NOT_PORTED = {"regrid_plan"}


def _batches(steps=STEPS):
    rng = np.random.RandomState(7)
    return [(rng.randn(8, 16, 16, 3).astype("float32"),
             rng.randint(0, 8, size=8).astype("int32"))
            for _ in range(steps)]


def _build(cls, cfg, **kw):
    ff = cls(cfg, **kw)
    image = ff.create_input((8, 16, 16, 3), name="image")
    tr.trace_cnn(ff, image)
    return ff


def _jax_fit(machine1, obs_dir, strategy=None, every=2, run_id="j"):
    cfg = JConfig(**CFG, prefetch_depth=0, obs_dir=str(obs_dir),
                  run_id=run_id, op_time_every=every)
    if strategy is not None:
        cfg.strategies = strategy
    jm = _build(JModel, cfg, machine=machine1)
    out = jm.fit(iter(_batches()), log=lambda *a: None)
    return jm, out


def _port_fit(jm, obs_dir, strategy=None, every=2, run_id="t"):
    """The port's fit from the JAX model's initial tree."""
    cfg = TConfig(**CFG, obs_dir=str(obs_dir) if obs_dir else "",
                  run_id=run_id, op_time_every=every)
    if strategy is not None:
        cfg.strategies = strategy
    tm = _build(TModel, cfg, device="cpu")
    jp, js = jm.init(CFG["seed"])
    params = params_from_jax(jax.tree.map(np.asarray, jp), "cpu", model=tm)
    tm.init = lambda seed=None: (params, {})
    out = tm.fit(iter(_batches()), log=lambda *a: None)
    return tm, out


def _kinds(records):
    return [r["kind"] for r in records if r["kind"] not in NOT_PORTED]


def _op_rows(records):
    return [(r["op"], r["op_kind"], r["grid"], r["measured"])
            for r in records if r["kind"] == "op_time"
            and r["scope"] == "op"]


def test_obs_flags_parse_as_jax():
    argv = ["--op-time-every", "5", "--obs-max-bytes", "1234", "-obs-dir",
            "d", "-run-id", "r", "--allow-degraded"]
    j, t = JConfig.from_args(argv), TConfig.from_args(argv)
    for field in ("op_time_every", "obs_max_bytes", "obs_dir", "run_id",
                  "allow_degraded"):
        assert getattr(t, field) == getattr(j, field), field
    assert (t.op_time_every, t.obs_max_bytes, t.obs_dir, t.run_id,
            t.allow_degraded) == (5, 1234, "d", "r", True)
    # the defaults are JAX's
    for field in ("op_time_every", "obs_max_bytes", "obs_dir", "run_id",
                  "allow_degraded"):
        assert getattr(TConfig(), field) == getattr(JConfig(), field)
    for flag in ("--trace-dir", "--profiling"):
        with pytest.raises(NotImplementedError, match="item 5"):
            TConfig.from_args([flag, "x"])
    # the live metrics' path is ported, as JAX parses it
    for flag in ("-metrics-path", "--metrics-path"):
        assert TConfig.from_args([flag, "x"]).metrics_path == \
            JConfig.from_args([flag, "x"]).metrics_path == "x"


def test_fit_records_match_jax(tmp_path, machine1):
    jm, jout = _jax_fit(machine1, tmp_path / "jax")
    tm, tout = _port_fit(jm, tmp_path / "port")
    jrec, trec = list(j_read_run(jout["obs_path"])), \
        list(read_run(tout["obs_path"]))
    assert _kinds(trec) == _kinds(jrec)
    # run_start carries JAX's meta
    assert {k: v for k, v in trec[0].items() if k not in ("run", "ts")} \
        == {k: v for k, v in jrec[0].items() if k not in ("run", "ts")}
    assert _op_rows(trec) == _op_rows(jrec)
    assert [r[0] for r in _op_rows(trec)] == ["conv1", "flat", "fc",
                                              "softmax"]
    sections = [r for r in trec if r["kind"] == "op_time"
                and r["scope"] == "section"]
    assert sorted({r["step"] for r in sections}) == [2, 4]
    assert [r["section"] for r in sections] == \
        ["forward", "backward", "optimizer", "step"] * 2
    assert all(r["seconds"] >= 0 for r in sections)
    assert all(r["seconds"] > 0 for r in trec if r["kind"] == "op_time"
               and r["scope"] == "op")
    steps = [r for r in trec if r["kind"] == "step"]
    assert [r["step"] for r in steps] == [1, 2, 3, 4]
    assert [r["timed"] for r in steps] == [False, True, True, True]
    assert [r["loss"] for r in steps] == tout["loss"]
    (un,) = [r for r in trec if r["kind"] == "sim_drift_unavailable"]
    (jun,) = [r for r in jrec if r["kind"] == "sim_drift_unavailable"]
    assert un["reason"] == jun["reason"]
    # sampling leaves the losses bit for bit; JAX's within the CNN bar
    _, plain = _port_fit(jm, tmp_path / "plain", every=0, run_id="p")
    assert tout["loss"] == plain["loss"]
    np.testing.assert_allclose(tout["loss"], jout["loss"], rtol=1e-4)
    assert tout["run_id"] == "t" and tout["obs_path"] == str(
        tmp_path / "port" / "t.jsonl")


def test_obs_off_writes_nothing(tmp_path, machine1):
    jm = _build(JModel, JConfig(**CFG), machine=machine1)
    _, out = _port_fit(jm, "", every=2)
    assert out["obs_path"] is None and out["run_id"] is None
    assert len(out["loss"]) == STEPS
    assert not list(tmp_path.iterdir())


def _dp_strategy(pkg_strategy, pkg_pc, predicted=None):
    s = pkg_strategy()
    for name, ndims in (("conv1", 4), ("flat", 2), ("fc", 2),
                        ("softmax", 1)):
        s[name] = pkg_pc((1,) * ndims, (0,))
    s.predicted = predicted
    return s


def _drift(records):
    return [r for r in records if r["kind"].startswith("sim_drift")]


def test_sim_drift_from_the_artifact(tmp_path, machine1):
    from flexflow_tpu.strategy import ParallelConfig as JPC
    from flexflow_tpu.strategy import Strategy as JStrategy

    from flexflow_tpu_torch.strategy import ParallelConfig, Strategy

    pred = {"best_time_s": 2.5e-3, "dp_time_s": 3e-3}
    jm, jout = _jax_fit(machine1, tmp_path / "jax",
                        _dp_strategy(JStrategy, JPC, pred), every=0)
    _, tout = _port_fit(jm, tmp_path / "port",
                        _dp_strategy(Strategy, ParallelConfig, pred),
                        every=0)
    (j,) = _drift(j_read_run(jout["obs_path"]))
    (t,) = _drift(read_run(tout["obs_path"]))
    assert (t["kind"], t["source"], t["predicted_s"]) == \
        (j["kind"], j["source"], j["predicted_s"]) == \
        ("sim_drift", "artifact", 2.5e-3)
    assert t["value"] == pytest.approx(t["measured_s"] / 2.5e-3, rel=1e-12)


def test_sim_drift_from_the_analytic_simulation(tmp_path, machine1,
                                                monkeypatch):
    from flexflow_tpu.strategy import ParallelConfig as JPC
    from flexflow_tpu.strategy import Strategy as JStrategy

    from flexflow_tpu_torch.sim import cost_model
    from flexflow_tpu_torch.strategy import ParallelConfig, Strategy

    perf = sp.jax_perf()
    monkeypatch.setattr(cost_model, "HopperChipPerf", lambda: perf)
    jm, jout = _jax_fit(machine1, tmp_path / "jax",
                        _dp_strategy(JStrategy, JPC), every=0)
    _, tout = _port_fit(jm, tmp_path / "port",
                        _dp_strategy(Strategy, ParallelConfig), every=0)
    (j,) = _drift(j_read_run(jout["obs_path"]))
    (t,) = _drift(read_run(tout["obs_path"]))
    assert (t["kind"], t["source"]) == (j["kind"], j["source"]) == \
        ("sim_drift", "analytic")
    assert sp.rel(t["predicted_s"], j["predicted_s"]) <= 1e-9


class _Sink:
    """An obs sink that keeps each record's kind and reason."""

    def __init__(self):
        self.records = []

    def event(self, kind, **fields):
        self.records.append((kind, fields.get("reason")))


def test_sim_drift_unavailable_reasons_match_jax(machine1, monkeypatch):
    from flexflow_tpu.sim.search import StrategySearch as JSearch
    from flexflow_tpu.strategy import ParallelConfig as JPC
    from flexflow_tpu.strategy import Strategy as JStrategy

    from flexflow_tpu_torch.sim.search import StrategySearch
    from flexflow_tpu_torch.strategy import ParallelConfig, Strategy

    def refused(self, strategy):
        raise KeyError("strategy entry for 'fc' is not among its "
                       "candidates")

    monkeypatch.setattr(JSearch, "assignment_for", refused)
    monkeypatch.setattr(StrategySearch, "assignment_for", refused)
    for pred in (None, {"best_time_s": -1.0}):
        jcfg, tcfg = JConfig(**CFG), TConfig(**CFG)
        jcfg.strategies = _dp_strategy(JStrategy, JPC, pred)
        tcfg.strategies = _dp_strategy(Strategy, ParallelConfig, pred)
        jsink, tsink = _Sink(), _Sink()
        _build(JModel, jcfg, machine=machine1)._emit_sim_drift(jsink, 1e-3)
        _build(TModel, tcfg, device="cpu")._emit_sim_drift(tsink, 1e-3)
        assert tsink.records == jsink.records
        assert [k for k, _ in tsink.records] == ["sim_drift_unavailable"]


def test_sampling_on_two_ranks(tmp_path):
    batches = _batches()
    kw = {k: v for k, v in CFG.items() if k != "num_iterations"}
    sampled = dict(kw, obs_dir=str(tmp_path / "obs"), run_id="two",
                   op_time_every=2)
    res = tr.run_ranks(tr.run_cases, 2, [
        ("fit_obs", ("trace_cnn", sampled, batches)),
        ("fit_obs", ("trace_cnn", kw, batches))], timeout=180)
    (s0, p0), (u0, _) = res[0]
    (s1, p1), (u1, _) = res[1]
    assert p0 == str(tmp_path / "obs" / "two.jsonl") and p1 is None
    assert sorted(p.name for p in (tmp_path / "obs").iterdir()) == \
        ["two.jsonl"]
    assert s0 == u0 == s1 == u1 and len(s0) == STEPS
    records = list(read_run(p0))
    sections = [r for r in records if r["kind"] == "op_time"
                and r["scope"] == "section"]
    assert sorted({r["step"] for r in sections}) == [2, 4]
    assert _op_rows(records)[0][:2] == ("conv1", "Conv2D")
