"""``flexflow_tpu_torch/obs/trace.py`` and ``apps.search -trace`` against
the JAX package's ``obs/trace.py`` and ``apps/search.py``, on the CPU:

* every function of the module on the same inputs: the lanes of one
  simulated schedule (``tests/test_trace.py``'s small CNN searched on 8
  virtual devices on the JAX package's constants), of ``fit``'s
  ``op_time``, ``step`` and ``metrics`` records, the container, the
  file written, the validator on a good trace and on
  ``tests/test_trace.py:89``'s violations (and on bad counters), the
  measured and simulated per-op seconds and their drift attribution, a
  written trace's events read back;
* ``apps.search alexnet --devices 8 -trace`` on the JAX package's
  constants writes a trace whose parsed JSON equals the JAX driver's,
  and a ``sim_trace`` record equal to its;
* ``serve_trace_events`` on JAX's engine and routed record streams, the
  empty and the partial stream, and on one routed run under chaos as the
  JAX router and the port's router wrote it: the lanes equal JAX's and
  validate clean;
* ``python -m flexflow_tpu_torch.obs.trace --smoke`` exits 0.
"""

import json
import subprocess
import sys

import pytest
import torch

import torch_sim_parity as sp
from flexflow_tpu.obs import RunLog as JRunLog
from flexflow_tpu.obs import read_events as j_read_events
from flexflow_tpu.obs import trace as jtrace
from flexflow_tpu_torch.obs import RunLog, read_events
from flexflow_tpu_torch.obs import trace as ttrace

torch.set_num_threads(2)


@pytest.fixture
def jax_constants(monkeypatch):
    """The port's search app on the JAX package's chip constants and
    links."""
    from flexflow_tpu_torch.machine import Topology
    from flexflow_tpu_torch.sim import cost_model

    perf = sp.jax_perf()
    monkeypatch.setattr(cost_model, "HopperChipPerf", lambda: perf)
    monkeypatch.setattr(Topology, "hopper", classmethod(
        lambda cls, g=8: cls(devices_per_ici_group=g)))


def _searches():
    """(JAX, port) searches of tests/test_trace.py's small CNN on 8
    virtual devices."""
    from flexflow_tpu.config import FFConfig as JConfig
    from flexflow_tpu.model import FFModel as JModel

    from flexflow_tpu_torch.config import FFConfig
    from flexflow_tpu_torch.model import FFModel

    jm, tm = sp.machines(8)
    models = []
    for cls, cfg_cls, machine in ((JModel, JConfig, jm),
                                  (FFModel, FFConfig, tm)):
        ff = cls(cfg_cls(batch_size=16, input_height=16, input_width=16,
                         num_classes=8), machine)
        img = ff.create_input((16, 16, 16, 3), name="image")
        t = ff.conv2d("conv1", img, 8, 3, 3, 1, 1, 1, 1, relu=True)
        t = ff.flat("flat", t)
        t = ff.linear("fc", t, 8, relu=False)
        ff.softmax("softmax", t)
        models.append(ff)
    return sp.searches(models[0], models[1], jm, tm)


def _records(sink_cls, path):
    """tests/test_trace.py's synthetic run, with step and metrics
    records for the counter lanes."""
    with sink_cls(path, run_id="syn") as ol:
        ol.event("search_breakdown", ops=[
            {"op": "conv1", "kind": "Conv2D", "compute_s": 0.001,
             "collective_s": 0.0002},
            {"op": "fc", "kind": "Linear", "compute_s": 0.002,
             "collective_s": 0.0}], opt_stream_s=0.0005)
        ol.event("sim_trace", path="x.trace.json",
                 op_s={"conv1": 0.0011, "fc": 0.0021, "flat": 1e-6},
                 total_s=0.004, dp_total_s=0.005, opt_stream_s=0.0005)
        for op, k, s, m in (("conv1", "Conv2D", 0.003, True),
                            ("fc", "Linear", 0.002, True),
                            ("fc", "Linear", 0.0025, True),
                            ("fc", "Linear", 0.0009, False),
                            ("softmax", "Softmax", 1e-5, False)):
            ol.event("op_time", scope="op", op=op, op_kind=k, seconds=s,
                     measured=m)
        for sec, s in (("forward", 0.004), ("backward", 0.006),
                       ("optimizer", 0.001), ("step", 0.011)):
            ol.event("op_time", scope="section", section=sec, step=2,
                     seconds=s)
        for i, ms in enumerate((12.0, 11.0, 10.5)):
            ol.event("step", step=i + 1, wall_ms=ms, loss=1.0,
                     images_per_sec=16 / ms * 1e3, timed=i > 0)
        ol.event("metrics", steps_total=2, mfu=0.31,
                 hbm_live_bytes=1e9, hbm_peak_bytes=2e9)
        ol.event("sim_drift", name="sim_drift", value=2.0,
                 predicted_s=0.005, measured_s=0.01, source="artifact")
    return path


def _stripped(events):
    return [{k: v for k, v in e.items() if k not in ("run", "ts")}
            for e in events]


@pytest.mark.parametrize("which", ["dp", "searched"])
def test_sim_lanes_match_jax(which):
    js, ts = _searches()
    if which == "dp":
        ja, ta = js.dp_assignment(), ts.dp_assignment()
    else:
        ja = ta = [len(c) - 1 for c in ts.candidates]
        assert ja == [len(c) - 1 for c in js.candidates]
    jsim, tsim = js.simulate_trace(ja), ts.simulate_trace(ta)
    assert tsim["op_s"].keys() == jsim["op_s"].keys()
    for op, s in jsim["op_s"].items():
        assert sp.rel(tsim["op_s"][op], s) <= 1e-12, op
    assert sp.rel(tsim["total_s"], jsim["total_s"]) <= 1e-12
    for pid, label in ((jtrace.PID_SIM_BEST, "sim:best"),
                       (jtrace.PID_SIM_DP, "sim:dp")):
        want = jtrace.sim_trace_events(jsim, pid=pid, label=label)
        _same_events(ttrace.sim_trace_events(tsim, pid=pid, label=label),
                     want)
    trace = ttrace.chrome_trace(ttrace.sim_trace_events(tsim))
    assert ttrace.validate_trace(trace) == \
        jtrace.validate_trace(jtrace.chrome_trace(
            jtrace.sim_trace_events(jsim))) == []


def _named(event):
    """``event`` with an input source's name (``_input<tensor id>``,
    which depends on the tensors made before in the process) made
    generic."""
    args = event.get("args")
    if not isinstance(args, dict) or args.get("op_kind") != "_InputSource":
        return event
    return dict(event, name="_input", args=dict(args, op="_input"))


def _same_events(got, want):
    """Equal event lists, floats within 1e-12 relative (the two
    simulators' tables agree to that)."""
    assert len(got) == len(want)
    for g, w in zip(map(_named, got), map(_named, want)):
        assert g.keys() == w.keys()
        for k in w:
            if isinstance(w[k], float):
                assert sp.rel(g[k], w[k]) <= 1e-12, (k, g, w)
            elif isinstance(w[k], dict):
                _same_events([g[k]], [w[k]])
            else:
                assert g[k] == w[k], (k, g, w)


def test_fit_lanes_and_counters_match_jax(tmp_path):
    jrec = list(j_read_events(_records(JRunLog, str(tmp_path / "j.jsonl"))))
    trec = list(read_events(_records(RunLog, str(tmp_path / "t.jsonl"))))
    assert _stripped(trec) == _stripped(jrec)
    got = ttrace.fit_trace_events(trec)
    assert got == jtrace.fit_trace_events(jrec)
    assert ttrace.fit_counter_events(trec) == \
        jtrace.fit_counter_events(jrec)
    assert {e["name"] for e in got if e["ph"] == "C"} == \
        {"imgs/s", "MFU", "HBM bytes"}
    trace = ttrace.chrome_trace(got, ttrace.fit_counter_events([]))
    assert trace == jtrace.chrome_trace(jtrace.fit_trace_events(jrec), [])
    assert ttrace.validate_trace(trace) == []
    path = ttrace.write_trace(str(tmp_path / "sub" / "f.trace.json"),
                              trace)
    jpath = jtrace.write_trace(str(tmp_path / "jsub" / "f.trace.json"),
                               trace)
    with open(path) as f, open(jpath) as g:
        assert f.read() == g.read()
    assert ttrace.trace_events_from_file(path) == \
        jtrace.trace_events_from_file(jpath) == trace["traceEvents"]
    bad = tmp_path / "bad.json"
    bad.write_text(json.dumps([1, 2]))
    with pytest.raises(ValueError, match="not a trace_event"):
        ttrace.trace_events_from_file(str(bad))


VIOLATIONS = [
    {"nope": 1},
    {"traceEvents": [{"ph": "X", "pid": 0}]},
    {"traceEvents": ["not an object"]},
    {"traceEvents": [{"name": "a", "ph": "X", "pid": 0, "tid": 0,
                      "ts": 0.0, "dur": -1.0}]},
    {"traceEvents": [{"name": "a", "ph": "X", "pid": 0, "tid": 0,
                      "ts": -2.0, "dur": 1.0}]},
    {"traceEvents": [
        {"name": "a", "cat": "compute", "ph": "X", "pid": 0, "tid": 0,
         "ts": 0.0, "dur": 10.0},
        {"name": "b", "cat": "compute", "ph": "X", "pid": 0, "tid": 0,
         "ts": 5.0, "dur": 10.0}]},
    {"traceEvents": [
        {"name": "a", "cat": "transfer", "ph": "X", "pid": 0, "tid": 1000,
         "ts": 0.0, "dur": 10.0},
        {"name": "b", "cat": "transfer", "ph": "X", "pid": 0, "tid": 1000,
         "ts": 5.0, "dur": 10.0}]},
    {"traceEvents": [
        {"name": "c", "ph": "C", "pid": 0, "ts": 1.0, "args": {}},
        {"name": "c", "ph": "C", "pid": 0, "ts": 1.0,
         "args": {"v": float("nan")}},
        {"name": "c", "ph": "C", "pid": 0, "ts": 1.0, "args": {"v": "x"}},
        {"name": "c", "ph": "C", "pid": 0, "ts": 2.0, "args": {"v": 3}},
        {"name": "m", "ph": "M", "pid": 0, "args": {"name": "p"}}]},
]


@pytest.mark.parametrize("case", range(len(VIOLATIONS)))
def test_validator_matches_jax(case):
    trace = VIOLATIONS[case]
    want = jtrace.validate_trace(trace)
    assert ttrace.validate_trace(trace) == want
    # every case but the overlapping transfers and the last counter
    # block's valid events has a violation
    assert bool(want) == (case != 6)


def test_drift_join_matches_jax(tmp_path):
    jrec = list(j_read_events(_records(JRunLog, str(tmp_path / "j.jsonl"))))
    trec = list(read_events(_records(RunLog, str(tmp_path / "t.jsonl"))))
    real, sim = ttrace.real_op_seconds(trec), ttrace.sim_op_seconds(trec)
    assert real == jtrace.real_op_seconds(jrec)
    assert sim == jtrace.sim_op_seconds(jrec)
    # the median of fc's measured samples; softmax's stand-in kept apart
    assert real["fc"] == {"seconds": 0.0025, "n": 2, "op_kind": "Linear",
                          "measured": True}
    assert real["softmax"]["measured"] is False
    assert sim["conv1"]["source"] == "sim_trace" and \
        sim["conv1"]["compute_s"] == 0.001
    step = {"ratio": 2.0}
    got = ttrace.drift_attribution(sim, real, step)
    assert got == jtrace.drift_attribution(sim, real, step)
    assert [r["op"] for r in got["ops"]] == ["conv1", "fc"]
    assert got["sim_only"] == ["flat"] and got["real_only"] == ["softmax"]
    assert ttrace.drift_attribution({}, {}) == \
        jtrace.drift_attribution({}, {})


def test_search_trace_matches_jax(tmp_path, jax_constants):
    from flexflow_tpu.apps import search as jax_app

    from flexflow_tpu_torch.apps import search

    argv = ["alexnet", "--devices", "8", "-i", "2000", "-trace"]
    outs = {}
    for name, main in (("jax", jax_app.main), ("port", search.main)):
        d = tmp_path / name
        lines = []
        out = main(argv + ["-obs-dir", str(d), "-run-id", "r"],
                   log=lines.append)
        path = d / "r.trace.json"
        assert out["trace_path"] == str(path)
        assert any("sim trace written" in line for line in lines)
        (rec,) = [e for e in read_events(str(d / "r.jsonl"))
                  if e["kind"] == "sim_trace"]
        outs[name] = (json.loads(path.read_text()), rec)
    (jt, jrec), (tt, trec) = outs["jax"], outs["port"]
    assert ttrace.validate_trace(tt) == []
    assert {e["pid"] for e in tt["traceEvents"]} == {ttrace.PID_SIM_BEST,
                                                    ttrace.PID_SIM_DP}
    assert tt["displayTimeUnit"] == jt["displayTimeUnit"]
    _same_events(tt["traceEvents"], jt["traceEvents"])
    trec, jrec = _stripped([trec])[0], _stripped([jrec])[0]
    assert trec.pop("path").endswith("port/r.trace.json")
    assert jrec.pop("path").endswith("jax/r.trace.json")
    assert trec.keys() == jrec.keys()
    _same_events([trec], [jrec])


def test_trace_smoke_exits_0():
    res = subprocess.run([sys.executable, "-m",
                          "flexflow_tpu_torch.obs.trace", "--smoke"],
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert "ffsim trace smoke OK" in res.stdout


# ---------------------------------------------------------------------------
# serving lanes (tests/test_trace.py:337-394, tests/test_disagg.py:490)


def _jax_test(name):
    import importlib

    return importlib.import_module(name)


@pytest.mark.parametrize("records", ["engine", "handoff", "empty",
                                     "partial"])
def test_serve_trace_events_match_jax(records):
    """The engine's stream of ``tests/test_trace.py``, the routed one of
    ``tests/test_disagg.py`` (queue, prefill, handoff arrow, decode, per
    pool counters), the empty stream and an in-flight request: the
    port's lanes equal JAX's and validate clean."""
    recs = {
        "engine": lambda: _jax_test("test_trace")._serve_records(),
        "handoff": lambda: _jax_test("test_disagg")._handoff_records(),
        "empty": lambda: [],
        "partial": lambda: [{"kind": "serve_request", "rid": 7,
                             "arrival_v": 1.0, "admit_v": 1.5,
                             "done_v": None}],
    }[records]
    got, want = ttrace.serve_trace_events(recs()), \
        jtrace.serve_trace_events(recs())
    assert got == want
    assert ttrace.validate_trace(ttrace.chrome_trace(got)) == []
    assert ttrace.PID_SERVE == jtrace.PID_SERVE
    cats = {e.get("cat") for e in got}
    if records == "engine":
        assert {"queue", "decode", "admission"} <= cats
    if records == "handoff":
        assert {"queue", "prefill", "handoff", "decode"} <= cats
        counters = {e["name"] for e in got if e.get("ph") == "C"}
        assert {"queue depth [prefill]", "KV cache [decode]"} <= counters
    if records == "empty":
        assert len(got) == 1 and got[0]["ph"] == "M"
    if records == "partial":
        assert [e["cat"] for e in got if e.get("ph") == "X"] == ["queue"]


@pytest.fixture(scope="module")
def routed_streams(machine8, tmp_path_factory):
    """The records of one routed run under chaos (two prefill replicas,
    one decode replica; ``replica_crash@2,handoff_drop@3``) written by
    the JAX router and by the port's: (jax, port)."""
    import torch_serve_pools as pools

    tmp = tmp_path_factory.mktemp("routed")
    models = pools.Models(machine8, 2, 2)
    from flexflow_tpu.serve.router import RetryPolicy as JRetry

    from flexflow_tpu_torch.utils.retry import RetryPolicy

    def engines_log(router):
        # the engines write their serve_request and serve_batch records
        # into the router's stream
        for eng in list(router.prefill) + list(router.decode):
            eng.olog = router.olog

    spec = "replica_crash@2,handoff_drop@3"
    jrun = pools.routed(models, False, spec, path=tmp / "jax.jsonl",
                        retry_policy=JRetry(), setup=engines_log)
    trun = pools.routed(models, True, spec, path=tmp / "port.jsonl",
                        retry_policy=RetryPolicy(), setup=engines_log)
    return jrun[4], trun[4]


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_serve_trace_of_router_streams_matches_jax(routed_streams, writer):
    stream = routed_streams[0 if writer == "jax" else 1]
    got = ttrace.serve_trace_events(stream)
    assert got == jtrace.serve_trace_events(stream)
    assert ttrace.validate_trace(ttrace.chrome_trace(got)) == []
    cats = {e.get("cat") for e in got}
    assert {"prefill", "handoff", "decode", "fault"} <= cats
    names = {e["name"] for e in got if e.get("cat") == "fault"}
    assert "serve_retry" in names
    assert any(n.startswith("replica_down") for n in names)
    # both routers' streams give one trace
    assert got == ttrace.serve_trace_events(routed_streams[0])
