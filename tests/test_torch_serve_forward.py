"""The forward-only service of the PyTorch port (``ServeEngine.run_forward``,
``serve.batcher.batch_requests``, ``apps.serve`` for the CNNs and the
NMT) against the JAX package's, on the CPU:

* the same seeded requests through both packages' ``run_forward`` on a
  small CNN and a tiny NMT, with ``step_time_s`` given: replies within
  1e-5, the summaries' counts, steps and virtual p50/p99 equal, the
  records' kinds and keys in JAX's order, the metrics textfile's gauges
  equal to JAX's;
* a drain requested before the run leaves every request unserved, as in
  JAX; one requested mid-run stops admission at the next batch (the
  port's own rule);
* 11 requests at max batch 8 make 2 steps (``tests/test_serve.py``);
* ``apps.serve alexnet`` prints one JSON line, and a subprocess of it
  sent SIGTERM mid-run exits 0 with requests unserved, none dropped, and
  the five gauges in its ``-metrics-path`` file.
"""

import json
import os
import signal
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

import torch_ranks as tr
from flexflow_tpu import obs as j_obs
from flexflow_tpu.config import FFConfig as JConfig
from flexflow_tpu.model import FFModel as JModel
from flexflow_tpu.obs.metrics import MetricsExporter as JMetrics
from flexflow_tpu.obs.metrics import read_textfile as j_read
from flexflow_tpu.serve.batcher import batch_requests as j_batch_requests
from flexflow_tpu.serve.engine import ServeEngine as JEngine
from flexflow_tpu.serve.loadgen import synthetic_requests as j_requests
from flexflow_tpu_torch import obs
from flexflow_tpu_torch.apps import serve as t_serve
from flexflow_tpu_torch.config import FFConfig as TConfig
from flexflow_tpu_torch.interop import params_from_jax, state_from_jax
from flexflow_tpu_torch.model import FFModel as TModel
from flexflow_tpu_torch.obs.metrics import MetricsExporter
from flexflow_tpu_torch.obs.metrics import read_textfile
from flexflow_tpu_torch.serve.batcher import batch_requests
from flexflow_tpu_torch.serve.engine import ServeEngine
from flexflow_tpu_torch.serve.loadgen import synthetic_requests

torch.set_num_threads(2)

STEP = 0.02
NMT = dict(batch_size=4, num_layers=1, seq_length=4, hidden_size=16,
           embed_size=16, vocab_size=64, lstm_per_node_length=2)
GAUGES = ("qps", "queue_depth", "latency_p50_s", "latency_p99_s",
          "requests_total")


def _cnn_pair(machine1, batch):
    kw = dict(batch_size=batch, input_height=16, input_width=16,
              num_classes=8)
    pair = []
    for cls, cfg, extra in ((JModel, JConfig, (machine1,)),
                            (TModel, TConfig, ())):
        ff = cls(cfg(**kw), *extra) if extra else cls(cfg(**kw),
                                                      device="cpu")
        tr.verify_net(ff, ff.create_input((batch, 16, 16, 3), name="image"))
        pair.append(ff)
    return pair


def _nmt_pair(machine1, batch):
    from flexflow_tpu.nmt.rnn_model import RnnConfig as JRC
    from flexflow_tpu.nmt.rnn_model import RnnModel as JRM
    from flexflow_tpu_torch.nmt.rnn_model import RnnConfig, RnnModel

    cfg = dict(NMT, batch_size=batch)
    return (JRM(JRC(**cfg), machine1),
            RnnModel(RnnConfig(**cfg), device="cpu"))


def _serve_both(tmp_path, jm, tm, n, seed=3, drain=None):
    """Both packages' ``run_forward`` of ``n`` seeded requests with JAX's
    params: ``(jax summary, jax requests, port summary, port requests,
    jax records, port records, jax gauges, port gauges)``."""
    from flexflow_tpu.apps.serve import _forward_payloads as j_payloads

    out = {}
    for name, mod_obs, metrics, engine, reqs_of, payloads, model in (
            ("jax", j_obs, JMetrics, JEngine, j_requests, j_payloads, jm),
            ("port", obs, MetricsExporter, ServeEngine, synthetic_requests,
             t_serve._forward_payloads, tm)):
        d = tmp_path / name
        olog = mod_obs.RunLog(str(d / "run.jsonl"), run_id="r",
                              surface="serve")
        m = metrics(str(d / "m.prom"), meta={"app": "serve"})
        if name == "jax":
            eng = engine(model, None, olog=olog, metrics=m,
                         log=lambda *a: None, step_time_s=STEP)
            jparams, jstate = eng.params, eng.state
        else:
            eng = engine(model, olog=olog, metrics=m, log=lambda *a: None,
                         step_time_s=STEP)
            eng.params = params_from_jax(jax.tree.map(np.asarray, jparams),
                                         device="cpu")
            eng.state = state_from_jax(jax.tree.map(np.asarray, jstate),
                                       "cpu")
        reqs = reqs_of(n, seed=seed, rate_qps=200.0, vocab_size=64,
                       prompt_len=4, max_new_tokens=0)
        payloads(model, reqs, seed)
        summary = eng.run_forward(reqs, drain=dict(drain) if drain else None)
        olog.close()
        recs = [r for r in mod_obs.read_run(str(d / "run.jsonl"))]
        out[name] = (summary, reqs, recs, read_textfile(str(d / "m.prom")))
    return out["jax"], out["port"]


def _check(jax_side, port_side, rtol=1e-5):
    (js, jreqs, jrecs, jg), (ts, treqs, trecs, tg) = jax_side, port_side
    for key in ("requests", "completed", "unserved", "dropped", "steps",
                "p50_s", "p99_s", "ttft_p50_s", "qps", "virtual_s",
                "drained", "devices"):
        a, b = ts[key], js[key]
        assert a == b or (a != a and b != b), (key, a, b)
    for jr, tr_ in zip(jreqs, treqs):
        assert (tr_.rid, tr_.admit_v, tr_.done_v) == \
            (jr.rid, jr.admit_v, jr.done_v)
        if jr.reply is None:
            assert tr_.reply is None
            continue
        np.testing.assert_allclose(tr_.reply, np.asarray(jr.reply),
                                   rtol=rtol, atol=rtol)
    assert [(r["kind"], sorted(r)) for r in trecs] == \
        [(r["kind"], sorted(r)) for r in jrecs]
    # the latency gauges are left out while no request has completed
    assert set(GAUGES if ts["completed"] else
               ("qps", "queue_depth", "requests_total")) <= set(tg)
    assert tg == jg


def test_batch_requests_matches_jax():
    reqs = synthetic_requests(5, seed=1, rate_qps=100.0, vocab_size=64,
                              prompt_len=3, max_new_tokens=0)
    jreqs = j_requests(5, seed=1, rate_qps=100.0, vocab_size=64,
                       prompt_len=3, max_new_tokens=0)
    got = list(batch_requests(iter(reqs), 2, pad_shape=(4,),
                              dtype="int32"))
    want = list(j_batch_requests(iter(jreqs), 2, pad_shape=(4,),
                                 dtype="int32"))
    assert [m for _, m in got] and len(got) == len(want) == 3
    for (a, ma), (b, mb) in zip(got, want):
        np.testing.assert_array_equal(a, b)
        assert [r.rid for r in ma] == [r.rid for r in mb]
    assert list(batch_requests(iter([]), 4)) == []
    with pytest.raises(ValueError, match="batch_size must be >= 1"):
        list(batch_requests(iter(reqs), 0))


def test_run_forward_cnn_matches_jax(machine1, tmp_path):
    jm, tm = _cnn_pair(machine1, 4)
    j, t = _serve_both(tmp_path, jm, tm, 10)
    assert t[0]["completed"] == 10 and t[0]["steps"] == 3
    assert t[1][0].reply.shape == (8,)
    # TTFT is the whole latency: the reply is the first and only token
    assert t[0]["ttft_p50_s"] == t[0]["p50_s"]
    _check(j, t)


def test_run_forward_nmt_matches_jax(machine1, tmp_path):
    jm, tm = _nmt_pair(machine1, 4)
    j, t = _serve_both(tmp_path, jm, tm, 6, seed=5)
    assert t[0]["completed"] == 6 and t[0]["steps"] == 2
    assert t[1][0].reply.shape == (2, 64)
    _check(j, t)


def test_run_forward_drain_before_the_run_matches_jax(machine1, tmp_path):
    jm, tm = _cnn_pair(machine1, 4)
    j, t = _serve_both(tmp_path, jm, tm, 7, drain={"requested": True})
    assert t[0]["unserved"] == j[0]["unserved"] == 7
    assert t[0]["completed"] == 0 and t[0]["drained"]
    _check(j, t)


def test_run_forward_drain_mid_run_stops_admission(tmp_path):
    """The port reads the drain flag before each batch: the batch served
    before the signal completes, the rest are unserved, none dropped."""
    kw = dict(batch_size=4, input_height=16, input_width=16, num_classes=8)
    tm = TModel(TConfig(**kw), device="cpu")
    tr.verify_net(tm, tm.create_input((4, 16, 16, 3), name="image"))
    m = MetricsExporter(str(tmp_path / "m.prom"))
    eng = ServeEngine(tm, metrics=m, log=lambda *a: None, step_time_s=STEP)
    drain = {"requested": False}
    make = tm.make_predict_step

    def predict_then_drain(*a, **k):
        step = make(*a, **k)

        def run(*args):
            drain["requested"] = True
            return step(*args)
        return run

    tm.make_predict_step = predict_then_drain
    reqs = synthetic_requests(11, seed=2, rate_qps=1000.0, vocab_size=64,
                              prompt_len=4, max_new_tokens=0)
    t_serve._forward_payloads(tm, reqs, 2)
    s = eng.run_forward(reqs, drain=drain)
    assert (s["completed"], s["unserved"], s["dropped"], s["steps"],
            s["drained"]) == (4, 7, 0, 1, True)
    assert read_textfile(str(tmp_path / "m.prom"))["requests_total"] == 4


def test_forward_only_service_lm_shapes():
    """``tests/test_serve.py::test_forward_only_service_cnn_shapes``: 11
    requests at max batch 8 make 2 steps, the short final group padded."""
    model, _ = t_serve.build_lm(batch=8, tiny=True, device="cpu")
    eng = ServeEngine(model, log=lambda *a: None)
    reqs = synthetic_requests(11, seed=3, rate_qps=1000.0, vocab_size=64,
                              prompt_len=16, max_new_tokens=0)
    summary = eng.run_forward(reqs)
    assert summary["completed"] == 11 and summary["steps"] == 2
    assert all(r.reply is not None for r in reqs)
    assert all(r.done_v is not None and r.done_v > r.arrival_v
               for r in reqs)


def test_serve_app_forward_prints_one_line(capsys):
    assert t_serve.main(["alexnet", "--requests", "3", "--max-batch", "2",
                         "--device", "cpu"], log=lambda *a: None) == 0
    lines = capsys.readouterr().out.splitlines()
    assert len(lines) == 1
    rec = json.loads(lines[0])
    assert (rec["completed"], rec["unserved"], rec["dropped"]) == (3, 0, 0)
    assert np.isfinite([rec["qps"], rec["p50_s"], rec["p99_s"]]).all()
    with pytest.raises(SystemExit, match="not ported yet"):
        t_serve.main(["lenet", "--device", "cpu"], log=lambda *a: None)


def test_serve_app_sigterm_drains_and_exits_zero(tmp_path):
    prom = tmp_path / "m.prom"
    env = dict(os.environ, OMP_NUM_THREADS="1")
    proc = subprocess.Popen(
        [sys.executable, "-m", "flexflow_tpu_torch.apps.serve", "alexnet",
         "--requests", "2000", "--max-batch", "1", "--device", "cpu",
         "-metrics-path", str(prom)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env,
        cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    try:
        for line in proc.stderr:
            if "forward service running" in line:
                proc.send_signal(signal.SIGTERM)
                break
        out, err = proc.communicate(timeout=120)
    finally:
        proc.kill()
    assert proc.returncode == 0, err
    (line,) = out.splitlines()
    rec = json.loads(line)
    assert rec["unserved"] > 0 and rec["dropped"] == 0 and rec["drained"]
    assert rec["completed"] + rec["unserved"] == 2000
    gauges = read_textfile(str(prom))
    assert set(GAUGES) <= set(gauges)
    assert gauges["requests_total"] == rec["completed"]
    assert set(j_read(str(prom))) == set(gauges)
