"""The port's live metrics and step budget (``obs/metrics.py``,
``obs/budget.py``, ``FFModel.fit``'s ``metrics`` and ``step_budget``
records) against the JAX package's, on the CPU, and the two smokes.

* ``MetricsExporter`` fed the same gauges, labeled series and histogram
  samples writes byte-equal textfiles and equal JSON snapshots (all but
  the time stamp), and the readers parse them alike
  (``tests/test_budget.py:22-200``);
* ``build_step_budget``, ``check_budget``, ``mfu_waterfall`` and
  ``render_waterfall`` give equal dicts and lines on the same inputs
  (the waterfall read at JAX's peaks, ``TpuChipPerf``); the port's
  default peaks are ``HopperChipPerf``'s at the run's compute dtype;
* ``fit`` with ``metrics_path`` and sampled op timing writes JAX's record
  kinds in JAX's order (``regrid_plan`` aside: the port has no regrid
  planner's summary) and JAX's gauges (the device memory's aside: there
  is no device memory on the CPU, where JAX reads its compiled
  program's estimate; and ``mfu_ceiling``, which needs the compiled
  program's byte count);
* ``apps.budget_smoke --device cpu`` and ``apps.preempt_smoke --device
  cpu`` exit 0.
"""

import json
import math

import jax
import numpy as np
import pytest
import torch

import torch_ranks as tr
from flexflow_tpu.config import FFConfig as JConfig
from flexflow_tpu.model import FFModel as JModel
from flexflow_tpu.obs import budget as j_budget
from flexflow_tpu.obs import metrics as j_metrics
from flexflow_tpu.obs import read_run as j_read_run
from flexflow_tpu.sim.cost_model import TpuChipPerf
from flexflow_tpu_torch.config import FFConfig
from flexflow_tpu_torch.interop import params_from_jax
from flexflow_tpu_torch.model import FFModel
from flexflow_tpu_torch.obs import budget as t_budget
from flexflow_tpu_torch.obs import metrics as t_metrics
from flexflow_tpu_torch.obs import read_run
from flexflow_tpu_torch.sim.cost_model import HopperChipPerf

torch.set_num_threads(2)


def _feed(mod, path):
    m = mod.MetricsExporter(str(path), meta={"model": "M", "run": "r1"})
    m.update(throughput_items_per_sec=123.5, images_per_sec=123.5,
             mfu=0.4125, mfu_ceiling=None, loss=float("nan"),
             steps_total=7, hbm_peak_bytes=2.5e10, faults_total=1,
             ckpt_async_inflight=1, custom_gauge=3.25,
             step_wall_seconds=float("inf"))
    for direction, n in (("shrink", 2), ("grow", 1)):
        m.update_labeled("elastic_events", {"direction": direction}, n)
    for v in (0.0005, 0.002, 0.3, 7.0, 500.0, float("nan")):
        m.observe("request_latency_s", v)
    m.write()
    m.update(steps_total=8)
    m.write()
    return m


def test_metrics_exporter_writes_jax_bytes(tmp_path):
    jm = _feed(j_metrics, tmp_path / "j" / "metrics.prom")
    tm = _feed(t_metrics, tmp_path / "t" / "metrics.prom")
    assert tm.render() == jm.render()
    with open(tm.path, "rb") as a, open(jm.path, "rb") as b:
        assert a.read() == b.read()
    with open(tm.json_path) as a, open(jm.json_path) as b:
        ta, jb = json.load(a), json.load(b)
    assert ta.pop("ts") > 0 and jb.pop("ts") > 0
    assert ta == jb and ta["writes"] == 2
    assert "loss" not in ta["gauges"] and "step_wall_seconds" not in \
        ta["gauges"]
    for reader in ("read_textfile", "read_histogram", "read_labeled"):
        assert getattr(t_metrics, reader)(tm.path) == \
            getattr(j_metrics, reader)(jm.path), reader
    assert t_metrics.read_labeled(tm.path)["elastic_events"] == \
        {'direction="grow"': 1.0, 'direction="shrink"': 2.0}
    assert t_metrics.LATENCY_BUCKETS == j_metrics.LATENCY_BUCKETS


def test_metrics_from_config_and_malformed_lines(tmp_path):
    assert t_metrics.from_config(FFConfig()) is None
    m = t_metrics.from_config(FFConfig(metrics_path=str(tmp_path / "m.prom")))
    assert m.path == str(tmp_path / "m.prom")
    bad = tmp_path / "bad.prom"
    bad.write_text("ff_x 1 2\n")
    for mod in (t_metrics, j_metrics):
        with pytest.raises(ValueError, match="malformed"):
            mod.read_textfile(str(bad))


BUDGETS = [
    dict(wall_s=0.1, compute_s=0.05, comm_s=0.02, input_stall_s=0.001,
         host_sync_s=0.002, checkpoint_s=0.003,
         sources={"wall": "sampled_step"}, n_samples=3),
    # an instrument that counts past the wall is clamped
    dict(wall_s=0.01, compute_s=0.02, comm_s=0.005, input_stall_s=None,
         host_sync_s=0.001, checkpoint_s=None),
    dict(wall_s=0.0),
]


@pytest.mark.parametrize("case", range(len(BUDGETS)))
def test_step_budget_matches_jax(case):
    kw = dict(BUDGETS[case])
    wall = kw.pop("wall_s")
    got = t_budget.build_step_budget(wall, **kw)
    assert got == j_budget.build_step_budget(wall, **kw)
    assert t_budget.check_budget(got) == j_budget.check_budget(got) == []
    assert sum(got["buckets"].values()) == pytest.approx(wall, abs=1e-15)
    for bad in ({"step_wall_s": -1}, {"step_wall_s": 1.0, "buckets": 3},
                {"step_wall_s": 1.0, "buckets": {"a": -0.5, "b": 2.0}}):
        assert t_budget.check_budget(bad) == j_budget.check_budget(bad)


def _stream(dtype="float32"):
    bud = j_budget.build_step_budget(0.2, compute_s=0.08, comm_s=0.05,
                                     input_stall_s=0.01, host_sync_s=0.02,
                                     checkpoint_s=0.01,
                                     sources={"wall": "loop_mean"})
    return [{"kind": "run_start", "devices": 2, "compute_dtype": dtype},
            {"kind": "compile", "seconds": 1.0, "flops": 4.0e12,
             "bytes_accessed": 2.0e10},
            {"kind": "summary", "images_per_sec": 80.0},
            dict(bud, kind="step_budget")]


def test_mfu_waterfall_matches_jax():
    perf = TpuChipPerf()
    got = t_budget.mfu_waterfall(_stream(), perf=perf)
    want = j_budget.mfu_waterfall(_stream(), perf=perf)
    assert got == want and got["rows"][0]["bucket"] == "compute_overhead"
    assert t_budget.render_waterfall(got) == j_budget.render_waterfall(want)
    assert t_budget.mfu_waterfall([], perf=perf) is None
    # no FLOP count: a seconds-only waterfall
    bare = [e for e in _stream() if e["kind"] != "compile"]
    assert t_budget.mfu_waterfall(bare, perf=perf) == \
        j_budget.mfu_waterfall(bare, perf=perf)
    # the port's default peaks: the H100's at the run's compute dtype
    hopper = HopperChipPerf()
    for dtype, peak in (("float32", hopper.fp32_flops),
                        ("bfloat16", hopper.peak_flops)):
        wf = t_budget.mfu_waterfall(_stream(dtype))
        assert wf["mfu"] == pytest.approx(4.0e12 / 0.2 / (2 * peak))


CNN = dict(batch_size=8, input_height=16, input_width=16, num_iterations=6,
           print_freq=3, num_classes=8, learning_rate=1e-3, momentum=0.9,
           seed=3, op_time_every=2, run_id="r")


def _batches():
    rng = np.random.RandomState(7)
    return iter([(rng.randn(8, 16, 16, 3).astype("float32"),
                  rng.randint(0, 8, size=8).astype("int32"))
                 for _ in range(6)])


def test_fit_metrics_and_budget_records_match_jax(tmp_path, machine1):
    kw = lambda name: dict(CNN, obs_dir=str(tmp_path / name),  # noqa: E731
                           metrics_path=str(tmp_path / name / "m.prom"))
    jm = JModel(JConfig(**kw("jax"), prefetch_depth=0), machine=machine1)
    tr.trace_cnn(jm, jm.create_input((8, 16, 16, 3), name="image"))
    jout = jm.fit(_batches(), log=lambda *a: None)
    tm = FFModel(FFConfig(**kw("port")), device="cpu")
    tr.trace_cnn(tm, tm.create_input((8, 16, 16, 3), name="image"))
    jp, _ = jm.init(CNN["seed"])
    params = params_from_jax(jax.tree.map(np.asarray, jp), "cpu", model=tm)
    tm.init = lambda seed=None: (params, {})
    tout = tm.fit(_batches(), log=lambda *a: None)
    jrec = [r for r in j_read_run(jout["obs_path"])
            if r["kind"] != "regrid_plan"]
    trec = list(read_run(tout["obs_path"]))
    assert [r["kind"] for r in trec] == [r["kind"] for r in jrec]
    assert tout["metrics_path"] == str(tmp_path / "port" / "m.prom")
    # no roofline floor without a byte count: the port leaves
    # mfu_ceiling unset and the exporter drops it
    unset = {"hbm_peak_bytes", "hbm_live_bytes", "mfu_ceiling"}
    tm_recs = [r for r in trec if r["kind"] == "metrics"]
    jm_recs = [r for r in jrec if r["kind"] == "metrics"]
    assert len(tm_recs) == len(jm_recs) == 3
    for t, j in zip(tm_recs, jm_recs):
        assert set(t) == set(j) - unset
        for key in ("steps_total", "rollbacks_total", "faults_total",
                    "elastic_events", "drain_pending",
                    "ckpt_async_inflight", "param_bytes_total"):
            assert t[key] == j[key], key
        assert t["loss"] == pytest.approx(j["loss"], rel=1e-4)
        assert 0 < t["mfu"] < 1 and "mfu_ceiling" in j
    got = t_metrics.read_textfile(tout["metrics_path"])
    want = j_metrics.read_textfile(jout["metrics_path"])
    assert set(got) == set(want) - unset and got["steps_total"] == 6
    (tb,) = [r for r in trec if r["kind"] == "step_budget"]
    (jb,) = [r for r in jrec if r["kind"] == "step_budget"]
    assert t_budget.check_budget(tb) == []
    assert set(tb) == set(jb) and tb["n_samples"] == jb["n_samples"] == 3
    assert tb["sources"]["wall"] == jb["sources"]["wall"] == "sampled_step"
    assert tb["sources"]["comm"] == jb["sources"]["comm"]
    (tc,) = [r for r in trec if r["kind"] == "compile"]
    assert tc["flops"] == tm.step_flops() > 0
    # the waterfall of the port's stream, at the H100's float32 peak
    wf = t_budget.mfu_waterfall(trec)
    assert wf["flops_per_step"] == tc["flops"] and wf["mfu"] > 0
    assert math.isfinite(wf["step_wall_s"])


def test_budget_smoke_on_the_cpu():
    from flexflow_tpu_torch.apps import budget_smoke

    lines = []
    assert budget_smoke.main(["--device", "cpu"], log=lines.append) == 0
    # the waterfall is rendered by `report budget`; the smoke's line is
    # as before
    assert lines and lines[-1].startswith("budget-smoke OK: step ")
    assert "counter samples across ['MFU', 'imgs/s'], on cpu" in lines[-1]


def test_preempt_smoke_on_the_cpu():
    from flexflow_tpu_torch.apps import preempt_smoke

    lines = []
    assert preempt_smoke.main(["--device", "cpu"], log=lines.append) == 0
    assert lines[-1].startswith("preempt-smoke ok")
