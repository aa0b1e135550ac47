"""The port's copy of ``obs/slo.py`` against the JAX package's: spec
validation, ``burn_rate_windows``, ``evaluate`` (whole stream, rolling
windows, empty and degenerate streams, a retargeted record family),
``_burn``, the ``slo`` record and the gauges, on the same records."""

import math

import pytest

from flexflow_tpu.obs import slo as j_slo
from flexflow_tpu_torch.obs import slo as t_slo


def _reqs(latencies, spacing=0.1, t0=1.0):
    return [{"kind": "serve_request", "done_v": t0 + i * spacing,
             "latency_s": lat} for i, lat in enumerate(latencies)]


def _nan_safe(v):
    if isinstance(v, float) and math.isnan(v):
        return "nan"
    if isinstance(v, dict):
        return {k: _nan_safe(x) for k, x in v.items()}
    if isinstance(v, list):
        return [_nan_safe(x) for x in v]
    return v


SPECS = [dict(latency_target_s=0.1, availability=0.9, window_s=5.0),
         dict(latency_target_s=0.1, availability=0.9, window_s=0.5),
         dict(name="web", latency_target_s=0.2, percentile=95.0,
              availability=0.99, window_s=10.0)]

STREAMS = {
    "mixed": _reqs([0.05] * 8 + [0.5, 0.9]),
    "early_burst": _reqs([0.5] * 3 + [0.05] * 7),
    "empty": [],
    "degenerate": _reqs([0.3, 0.01, 0.2], spacing=0.0),
    "edge": _reqs([0.2, 0.05, 0.3, 0.01, 0.4, 0.06], spacing=0.25),
    "unfinished": _reqs([0.05, 0.5]) + [{"kind": "serve_request",
                                         "done_v": None,
                                         "latency_s": None}],
}


@pytest.mark.parametrize("spec", SPECS, ids=["5s", "0.5s", "web"])
@pytest.mark.parametrize("stream", sorted(STREAMS))
def test_evaluate_and_windows_match_jax(spec, stream):
    events = STREAMS[stream]
    js, ts = j_slo.SLOSpec(**spec), t_slo.SLOSpec(**spec)
    assert ts.to_dict() == js.to_dict()
    assert ts.error_budget == js.error_budget
    assert t_slo.burn_rate_windows(events, ts) == \
        j_slo.burn_rate_windows(events, js)
    assert _nan_safe(t_slo.evaluate(events, ts)) == \
        _nan_safe(j_slo.evaluate(events, js))


def test_retargeted_family_matches_jax():
    events = [{"kind": "fleet_wait", "done_v": 10.0 * i, "wait_s": w}
              for i, w in enumerate([5.0, 700.0, 20.0, 900.0])]
    kw = dict(kind="fleet_wait", latency_field="wait_s")
    spec = dict(latency_target_s=600.0, availability=0.9, window_s=15.0)
    got = t_slo.evaluate(events, t_slo.SLOSpec(**spec), **kw)
    assert got == j_slo.evaluate(events, j_slo.SLOSpec(**spec), **kw)
    assert got["violations"] == 2


@pytest.mark.parametrize("bad,total,budget", [
    (0, 0, 0.1), (2, 10, 0.1), (3, 5, 0.05), (1, 4, 0.0), (0, 4, 0.0),
    (7, 7, 1.0)])
def test_burn_matches_jax(bad, total, budget):
    assert t_slo._burn(bad, total, budget) == \
        j_slo._burn(bad, total, budget)


def test_spec_validation_and_round_trip():
    s = t_slo.SLOSpec(name="web", latency_target_s=0.2, percentile=95.0,
                      availability=0.99, window_s=10.0)
    assert t_slo.SLOSpec.from_dict(dict(s.to_dict(), devices=8)) == s
    for bad in (dict(latency_target_s=0.0), dict(percentile=101.0),
                dict(availability=1.0), dict(window_s=0.0)):
        with pytest.raises(ValueError):
            t_slo.SLOSpec(**bad)
        with pytest.raises(ValueError):
            j_slo.SLOSpec(**bad)


def test_record_and_gauges_match_jax(tmp_path):
    from flexflow_tpu import obs as j_obs
    from flexflow_tpu.obs.metrics import MetricsExporter as JExporter

    from flexflow_tpu_torch import obs as t_obs
    from flexflow_tpu_torch.obs.metrics import MetricsExporter

    events = STREAMS["mixed"]
    got = []
    for mod, obs, exporter in ((j_slo, j_obs, JExporter),
                               (t_slo, t_obs, MetricsExporter)):
        res = mod.evaluate(events, mod.SLOSpec(latency_target_s=0.1,
                                               availability=0.9))
        tag = mod.__name__.split(".")[0]
        olog = obs.RunLog(str(tmp_path / f"{tag}.jsonl"), surface="serve")
        mod.log_record(olog, res)
        olog.close()
        rec = [r for r in obs.read_run(olog.path) if r["kind"] == "slo"]
        metrics = exporter(str(tmp_path / f"{tag}.prom"))
        mod.export_gauges(metrics, res)
        mod.export_gauges(None, res)
        prom = (tmp_path / f"{tag}.prom").read_text()
        got.append(([{k: v for k, v in r.items() if k not in ("ts", "run")}
                     for r in rec],
                    sorted(line for line in prom.splitlines()
                           if line.startswith("ff_slo_"))))
    assert got[0] == got[1]
    assert len(got[1][0]) == 1 and len(got[1][1]) == 5
