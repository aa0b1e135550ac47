"""``python -m flexflow_tpu_torch.apps.calibrate --from-obs`` against the
JAX package's ``apps/calibrate.py:calibrate_from_obs``, on the CPU:

* on a test-written obs stream (``tests/test_trace.py:209-255``'s
  records, a second run's stream in a rotated part, a ``step_budget``
  record and a later ``search_breakdown``) the payload equals JAX's, key
  for key, and so do the lines logged;
* an empty directory gives JAX's warning and payload;
* the refit file is read back by ``Topology.with_calibration`` (the
  ``apps.search --dcn-calibration`` path) and by
  ``MeasuredCostModel(anchors_path=..., device="cpu")``;
* without ``--from-obs`` the app refuses, naming ROADMAP Queue A
  item 1.
"""

import json

import pytest

from flexflow_tpu.apps import calibrate as jcal
from flexflow_tpu.obs import RunLog as JRunLog
from flexflow_tpu_torch.apps import calibrate as tcal
from flexflow_tpu_torch.obs import RunLog


def _stream(sink_cls, obs_dir, drift=3.0):
    with sink_cls(str(obs_dir / "r.jsonl"), run_id="r") as ol:
        ol.event("search_breakdown", ops=[
            {"op": "conv1", "kind": "Conv2D", "compute_s": 0.001,
             "collective_s": 0.001}], opt_stream_s=0.0)
        ol.event("op_time", scope="op", op="conv1", op_kind="Conv2D",
                 seconds=0.002, measured=True)
        ol.event("sim_drift", name="sim_drift", value=drift,
                 predicted_s=0.002, measured_s=0.002 * drift,
                 source="artifact")
    # a second run, rotated: a later breakdown, a budget, more ops
    with sink_cls(str(obs_dir / "s.jsonl"), run_id="s",
                  max_bytes=200) as ol:
        ol.event("search_breakdown", ops=[
            {"op": "conv1", "kind": "Conv2D", "compute_s": 0.001,
             "collective_s": 0.0005},
            {"op": "pool1", "kind": "Pool2D", "compute_s": 0.0004,
             "collective_s": 0.0},
            {"op": "fc", "kind": "Linear", "compute_s": 0.0008,
             "collective_s": 0.0007}], opt_stream_s=0.0003)
        for op, k, s, m in (("pool1", "Pool2D", 0.0006, True),
                            ("fc", "Linear", 0.0012, True),
                            ("fc", "Linear", 0.0016, True),
                            ("softmax", "Softmax", 1e-5, False),
                            ("flat", "Flat", 2e-6, True)):
            ol.event("op_time", scope="op", op=op, op_kind=k, seconds=s,
                     measured=m)
        ol.event("step_budget", buckets={"input_stall": 0.0002,
                                         "host_sync": 0.0001,
                                         "checkpoint": 0.0,
                                         "compute": 0.003})
        ol.event("sim_drift", name="sim_drift", value=2.5,
                 predicted_s=0.004, measured_s=0.01, source="artifact")


def _refit(module, sink_cls, obs_dir, out):
    obs_dir.mkdir()
    _stream(sink_cls, obs_dir)
    lines = []
    payload = module.calibrate_from_obs(str(obs_dir), str(out),
                                        log=lines.append)
    return payload, lines


def test_refit_equals_jax(tmp_path):
    jp, jlines = _refit(jcal, JRunLog, tmp_path / "jobs",
                        tmp_path / "j.json")
    tp, tlines = _refit(tcal, RunLog, tmp_path / "tobs",
                        tmp_path / "t.json")
    assert tp.pop("obs_dir") == str(tmp_path / "tobs")
    jp.pop("obs_dir")
    assert tp == jp
    assert tp["streams"] > 2    # the rotated parts are read
    assert set(tp["kind_anchors"]) == {"Conv2D", "Linear", "Pool2D"}
    assert tp["collective_scale"] is not None
    assert tp["budget_excluded"] == {"input_stall": 0.0002,
                                     "host_sync": 0.0001}
    assert tlines[:-1] == jlines[:-1]
    assert tlines[-1] == f"written to {tmp_path / 't.json'}"
    written = json.loads((tmp_path / "t.json").read_text())
    assert written["kind_anchors"] == tp["kind_anchors"]


def test_refit_of_an_empty_directory_equals_jax(tmp_path):
    jlines, tlines = [], []
    jp = jcal.calibrate_from_obs(str(tmp_path), log=jlines.append)
    tp = tcal.calibrate_from_obs(str(tmp_path), log=tlines.append)
    assert tp == jp
    assert tp["kind_anchors"] == {} and tp["collective_scale"] is None
    assert tlines == jlines
    assert any("no op_time/sim_drift records" in m for m in tlines)


def test_refit_is_read_by_the_search_and_the_cost_model(tmp_path):
    from flexflow_tpu_torch.apps import search
    from flexflow_tpu_torch.machine import Topology
    from flexflow_tpu_torch.sim.cost_model import MeasuredCostModel

    out = tmp_path / "recal.json"
    payload, _ = _refit(tcal, RunLog, tmp_path / "obs", out)
    # the slow tier refit from the model's default Topology(), as in JAX
    scale = payload["collective_scale"]
    topo = Topology.hopper(4).with_calibration(str(out))
    assert (topo.dcn_bandwidth, topo.dcn_latency) == \
        (payload["dcn_bandwidth"], payload["dcn_latency"])
    assert topo.dcn_bandwidth == pytest.approx(
        Topology().dcn_bandwidth / scale, rel=1e-4)
    assert topo.ici_bandwidth == Topology.hopper(4).ici_bandwidth
    machine = search._machine(search.parse_args(
        ["alexnet", "--devices", "8", "--ici-group", "4",
         "--dcn-calibration", str(out)]))
    assert machine.topology == Topology.hopper(4).with_calibration(
        str(out))
    mcm = MeasuredCostModel(anchors_path=str(out), device="cpu")
    assert mcm.anchors() == payload["kind_anchors"]
    assert mcm._kind_ratios["Conv2D"] == [payload["kind_anchors"]["Conv2D"]]
    # in-memory anchors take precedence over the file's
    mcm2 = MeasuredCostModel(anchors_path=str(out), device="cpu",
                             anchors={"Conv2D": 1.5})
    assert mcm2._kind_ratios["Conv2D"] == [1.5]


def test_main(tmp_path):
    obs_dir = tmp_path / "obs"
    obs_dir.mkdir()
    _stream(RunLog, obs_dir)
    out = tmp_path / "recal.json"
    payload = tcal.main(["--from-obs", str(obs_dir), "-o", str(out)],
                        log=lambda *a: None)
    assert json.loads(out.read_text()) == payload
    with pytest.raises(NotImplementedError, match="Queue A item 1"):
        tcal.main(["-o", str(out)])
