"""``flexflow_tpu_torch/obs/report.py`` and ``apps.report`` (PyTorch ports
of ``flexflow_tpu/obs/report.py`` and ``flexflow_tpu/apps/report.py``)
against the JAX package's, on the same record streams:

* ``render`` and ``summarize`` equal JAX's on a fit stream
  (``tests/test_trace.py``'s synthetic run), a serving engine's stream
  (``tests/test_serve.py:366``), a routed stream
  (``tests/test_disagg.py``'s handoff records) and a search stream (the
  port's ``apps.search`` with ``-obs-dir``);
* ``report serve|slo|trace|search|budget`` (and the default render and
  ``--json``) print JAX's lines, and ``serve --trace`` writes JAX's
  trace; the serve assertions of ``tests/test_serve.py:366`` and
  ``tests/test_disagg.py:517``, and the trace ones of
  ``tests/test_trace.py:154-208`` hold on the port;
* ``report fusions`` and ``report fleet`` raise ``NotImplementedError``
  naming ROADMAP item 7.
"""

import json
import os

import pytest
import torch

import torch_sim_parity as sp

torch.set_num_threads(2)


def _write(path, records):
    from flexflow_tpu_torch import obs

    olog = obs.RunLog(str(path), run_id=path.stem, surface="serve")
    for rec in records:
        olog.event(rec["kind"], **{k: v for k, v in rec.items()
                                   if k != "kind"})
    olog.close()
    return str(path)


def _serve_records():
    """``tests/test_serve.py:366``'s engine stream."""
    return [
        {"kind": "serve_request", "rid": 0, "latency_s": 0.02,
         "arrival_v": 0.0, "admit_v": 0.0, "done_v": 0.02, "prompt_len": 4,
         "new_tokens": 2, "wall_s": 0.001},
        {"kind": "serve_batch", "step": 1, "vnow": 0.02, "active": 1,
         "admitted": 1, "queue_depth": 0, "devices": 8},
        {"kind": "serve_resize", "direction": "shrink", "from_devices": 8,
         "to_devices": 6, "step": 1, "vnow": 0.02, "queue_depth": 0,
         "idle_streak": 3, "research_s": 0.01,
         "research": {"mode": "mcmc"}, "total_s": 0.05},
        {"kind": "serve_summary", "requests": 1, "completed": 1,
         "unserved": 0, "dropped": 0, "qps": 50.0, "p50_s": 0.02,
         "p99_s": 0.02, "steps": 1, "resizes": 1, "virtual_s": 0.02,
         "drained": False, "devices": 6},
    ]


def _budget_records():
    """A step budget and its compile record (``tests/test_budget.py``)."""
    return [
        {"kind": "compile", "flops": 4.0e12, "bytes_accessed": 2.0e10},
        {"kind": "step_budget", "step_wall_s": 0.1, "n_samples": 4,
         "buckets": {"compute": 0.06, "comm": 0.02, "input_stall": 0.01,
                     "host_sync": 0.005, "checkpoint": 0.0,
                     "residual": 0.005},
         "sources": {"compute": "op_time"}},
    ]


@pytest.fixture(scope="module")
def streams(tmp_path_factory):
    """{name: path} of the record streams, each written once."""
    import test_disagg
    import test_trace

    from flexflow_tpu_torch.apps import search

    tmp = tmp_path_factory.mktemp("streams")
    fit = str(tmp / "fit.jsonl")
    test_trace._synthetic_run(fit)
    obs_dir = tmp / "search"
    search.main(["alexnet", "--devices", "8", "-i", "300", "-obs-dir",
                 str(obs_dir), "-run-id", "srch"], log=lambda *a: None)
    return {
        "fit": fit,
        "serve": _write(tmp / "serve.jsonl", _serve_records()),
        "routed": _write(tmp / "routed.jsonl",
                         test_disagg._handoff_records()),
        "search": str(obs_dir / "srch.jsonl"),
        "budget": _write(tmp / "budget.jsonl", _budget_records()),
    }


@pytest.mark.parametrize("name", ["fit", "serve", "routed", "search",
                                  "budget"])
def test_render_and_summarize_equal_jax(streams, name):
    from flexflow_tpu.obs import report as jreport

    from flexflow_tpu_torch.obs import read_events
    from flexflow_tpu_torch.obs import report

    events = sorted(read_events(streams[name]),
                    key=lambda e: e.get("ts", 0.0))
    text = report.render(events)
    assert text == jreport.render(events)
    assert report.summarize(events) == jreport.summarize(events)
    assert report.render_file(streams[name]) == \
        jreport.render_file(streams[name])
    assert text.strip() and report.render([]) == "(empty run log)"


def _both(argv):
    """(port lines, JAX lines, port rc, JAX rc) of ``apps.report``."""
    from flexflow_tpu.apps import report as jreport

    from flexflow_tpu_torch.apps import report

    tl, jl = [], []
    trc = report.main(argv, log=tl.append)
    jrc = jreport.main(argv, log=jl.append)
    return tl, jl, trc, jrc


@pytest.mark.parametrize("sub,name,flags", [
    (None, "fit", []), (None, "fit", ["--json"]),
    ("serve", "serve", []), ("serve", "serve", ["--json"]),
    ("serve", "routed", []), ("serve", "fit", []),
    ("slo", "serve", []), ("slo", "serve", ["--json"]),
    ("slo", "serve", ["--target-s", "0.01", "--percentile", "50"]),
    ("search", "search", []), ("search", "search", ["--json"]),
    ("budget", "budget", []), ("budget", "budget", ["--json"]),
    ("budget", "fit", []),
], ids=lambda v: "-".join(v) if isinstance(v, list) else str(v))
def test_subcommands_print_jax_lines(streams, monkeypatch, sub, name,
                                     flags):
    from flexflow_tpu_torch.sim import cost_model

    # the budget waterfall prices at the JAX package's chip constants
    perf = sp.jax_perf()
    monkeypatch.setattr(cost_model, "HopperChipPerf", lambda: perf)
    argv = ([sub] if sub else []) + [streams[name]] + flags
    tl, jl, trc, jrc = _both(argv)
    assert (trc, tl) == (jrc, jl)


def test_report_serve_renders_and_json(streams, tmp_path):
    """``tests/test_serve.py:366`` on the port: a directory renders, the
    histogram and the resize line show, ``--json`` carries the summary,
    a stream without serve records exits 1."""
    from flexflow_tpu_torch import obs
    from flexflow_tpu_torch.apps.report import serve_main

    d = tmp_path / "d"
    d.mkdir()
    _write(d / "r.jsonl", _serve_records())
    lines = []
    assert serve_main([str(d)], log=lines.append) == 0
    text = "\n".join(lines)
    assert "== serving ==" in text and "latency histogram" in text
    assert "serve_resize[shrink]: 8 -> 6" in text
    out = []
    assert serve_main([str(d), "--json"], log=out.append) == 0
    blob = json.loads(out[-1])
    assert blob["summary"]["completed"] == 1
    assert blob["resizes"][0]["direction"] == "shrink"
    empty = obs.RunLog(str(tmp_path / "empty" / "e.jsonl"))
    empty.event("step", step=1)
    empty.close()
    assert serve_main([str(tmp_path / "empty")], log=lambda *a: None) == 1


def test_report_routed_serve(streams):
    """``tests/test_disagg.py:517`` on the port."""
    from flexflow_tpu_torch import obs
    from flexflow_tpu_torch.apps.report import serve_main
    from flexflow_tpu_torch.obs.report import summarize

    rendered = []
    assert serve_main([streams["routed"]], log=rendered.append) == 0
    text = "\n".join(rendered)
    assert "pool[prefill]" in text and "pool[decode]" in text
    assert "handoffs: 1 prefill->decode" in text
    assert "1 kv_refetch(es)" in text
    assert "router: 1/1 served" in text
    sv = summarize(list(obs.read_run(streams["routed"])))["serve"]
    assert sv["handoffs"] == {"n": 1, "bytes": 4096, "kv_refetches": 1}
    assert sv["router"]["pools"]["decode"]["devices"] == 4


def test_report_serve_trace_equals_jax(streams, tmp_path):
    from flexflow_tpu_torch.obs.trace import validate_trace

    tpath, jpath = str(tmp_path / "t.trace.json"), \
        str(tmp_path / "j.trace.json")
    from flexflow_tpu.apps import report as jreport

    from flexflow_tpu_torch.apps import report

    assert report.main(["serve", streams["routed"], "--trace", tpath],
                       log=lambda *a: None) == 0
    assert jreport.main(["serve", streams["routed"], "--trace", jpath],
                        log=lambda *a: None) == 0
    got, want = (json.load(open(p)) for p in (tpath, jpath))
    assert got == want and validate_trace(got) == []


def test_report_trace_subcommand_equals_jax(streams, tmp_path):
    """``tests/test_trace.py:154-208`` on the port: the drift attribution
    and merged trace files and lines equal JAX's."""
    from flexflow_tpu_torch.obs import trace as obstrace

    out = str(tmp_path / "out")
    for flags in ([], ["--json"]):
        tl, jl, trc, jrc = _both(["trace", streams["fit"], "-o", out]
                                 + flags)
        assert trc == jrc == 0 and tl == jl
    with open(os.path.join(out, "drift_attribution.json")) as f:
        att = json.load(f)
    assert [r["op"] for r in att["ops"]] == ["conv1", "fc"]
    assert att["ops"][0]["drift_s"] == pytest.approx(0.0018)
    assert att["step"]["ratio"] == 2.0
    with open(os.path.join(out, "merged.trace.json")) as f:
        merged = json.load(f)
    assert obstrace.validate_trace(merged) == []
    pids = {e["pid"] for e in merged["traceEvents"]}
    assert {obstrace.PID_SIM_BEST, obstrace.PID_REAL} <= pids


def test_report_json_flag(streams):
    """``tests/test_trace.py:190`` on the port."""
    from flexflow_tpu_torch.apps import report

    msgs = []
    assert report.main([streams["fit"], "--json"], log=msgs.append) == 0
    (line,) = msgs
    obj = json.loads(line)
    assert obj["runs"] == ["syn"]
    assert obj["kinds"]["op_time"] == 6
    assert obj["sim_drift"]["value"] == 2.0


@pytest.mark.parametrize("sub", ["fusions", "fleet"])
def test_unported_subcommands_raise(streams, sub):
    from flexflow_tpu_torch.apps import report

    with pytest.raises(NotImplementedError, match="item 7"):
        report.main([sub, streams["fit"]], log=lambda *a: None)


def test_usage_without_paths():
    from flexflow_tpu_torch.apps import report

    lines = []
    assert report.main([], log=lines.append) == 2
    assert "python -m flexflow_tpu_torch.apps.report" in lines[0]
    for sub in ("trace", "budget", "serve", "slo", "search"):
        assert report.main([sub], log=lambda *a: None) == 2
