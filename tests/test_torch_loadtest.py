"""``python -m flexflow_tpu_torch.apps.loadtest`` (PyTorch port of
``flexflow_tpu/apps/loadtest.py``) against the JAX harness on its
8-device CPU mesh, on the JAX package's cost constants
(``torch_sim_parity.jax_perf``):

* the ``--smoke`` sweep (2, 4 and 8 devices), a ``--disagg`` and a
  ``--chaos replica_crash@3,handoff_drop@5`` sweep at 2 and 4 devices:
  every field of every point and of the metric line equals JAX's; each
  point runs on the CPU, priced at its width;
* JAX's ``test_loadtest_parse_args_and_round``,
  ``test_loadtest_record_through_report``,
  ``test_serve_bench_artifact_schema`` (on the artifact the port's sweep
  writes), ``test_loadtest_carve`` and ``test_vs_baseline_artifact`` (on
  a baseline the test writes) on the port;
* without ``--baseline`` there is no comparison block; ``--device cuda``
  raises without CUDA.
"""

import json
import math

import pytest
import torch

import torch_sim_parity as sp

torch.set_num_threads(2)

MODES = {
    "smoke": ["--smoke"],
    "disagg": ["--smoke", "--devices", "2,4", "--disagg"],
    "chaos": ["--smoke", "--devices", "2,4", "--chaos",
              "replica_crash@3,handoff_drop@5"],
}


@pytest.fixture(scope="module")
def sweeps(tmp_path_factory):
    """Both harnesses' runs of every mode: {mode: (jax, port)}, each
    ``{"line", "artifact"}``; the port's on the JAX constants."""
    from flexflow_tpu.apps import loadtest as jax_lt

    from flexflow_tpu_torch.apps import loadtest
    from flexflow_tpu_torch.sim import cost_model

    tmp = tmp_path_factory.mktemp("loadtest")
    perf = sp.jax_perf()
    saved = cost_model.HopperChipPerf
    cost_model.HopperChipPerf = lambda: perf
    out = {}
    try:
        for mode, argv in MODES.items():
            # JAX's harness compares against its committed artifacts by
            # default: hand it a path that does not exist
            jopts = jax_lt.parse_args(
                argv + ["--obs-dir", str(tmp / f"jax-{mode}"),
                        "--baseline", str(tmp / "absent.json")])
            topts = loadtest.parse_args(
                argv + ["--obs-dir", str(tmp / f"port-{mode}"), "--device",
                        "cpu", "-o", str(tmp / f"{mode}.json")])
            out[mode] = (jax_lt.run(jopts, log=_quiet),
                         loadtest.run(topts, log=_quiet))
    finally:
        cost_model.HopperChipPerf = saved
    return out


def _quiet(*a, **k):
    pass


@pytest.mark.parametrize("mode", list(MODES))
def test_sweep_equals_jax(sweeps, mode):
    jax_run, port_run = sweeps[mode]
    assert port_run["artifact"]["sweep"] == jax_run["artifact"]["sweep"]
    drop = ("run_id", "trace", "out", "vs_r01", "vs_r02")
    jline = {k: v for k, v in jax_run["line"].items() if k not in drop}
    tline = {k: v for k, v in port_run["line"].items() if k not in drop}
    assert tline == jline
    assert port_run["line"]["trace_validated"] is True
    # no default baseline in the port
    assert not {"vs_r01", "vs_r02"} & set(port_run["artifact"])
    jart = {k: v for k, v in jax_run["artifact"].items()
            if k not in ("vs_r01", "vs_r02")}
    assert port_run["artifact"] == jart
    if mode == "chaos":
        for p in port_run["artifact"]["sweep"]:
            assert p["completed"] + p["unserved"] + p["shed"] \
                + p["failed"] == p["offered"]
            assert p["faults_fired"] >= 1


def test_loadtest_parse_args_and_round():
    """``tests/test_loadtest.py:105``."""
    from flexflow_tpu_torch.apps.loadtest import _round, parse_args

    opts = parse_args([])
    assert opts["devices"] == "2,4,8" and opts["requests"] == 60
    assert opts["pattern"] == "diurnal+bursty"
    assert opts["device"] == "cuda"
    opts = parse_args(["--smoke", "--pattern", "heavy_tail",
                       "--devices", "4,8", "--rate-qps", "33",
                       "--slo-target-s", "0.5", "--seed", "7"])
    assert opts["smoke"] and opts["requests"] == 18  # smoke caps n
    assert opts["pattern"] == "heavy_tail"
    assert opts["devices"] == "4,8" and opts["rate_qps"] == 33.0
    assert opts["slo_target_s"] == 0.5 and opts["seed"] == 7
    assert _round(None) is None
    assert _round(0.123456789) == 0.123457
    assert _round(5) == 5
    assert math.isinf(_round(float("inf")))


def test_loadtest_record_through_report(tmp_path):
    """``tests/test_loadtest.py:124`` on the port's report."""
    from flexflow_tpu_torch import obs
    from flexflow_tpu_torch.obs.report import render, summarize

    point = {"pattern": "diurnal+bursty", "rate_qps": 80.0, "seed": 0,
             "devices": 8, "slots": 16, "requests": 60, "completed": 60,
             "unserved": 0, "qps": 350.0, "offered_qps": 90.0,
             "p50_s": 0.02, "p99_s": 0.05, "ttft_p50_s": 0.017,
             "ttft_p99_s": 0.03, "tpot_p50_s": 0.01, "tpot_p99_s": 0.01,
             "goodput_qps": 340.0, "slo_burn_rate": 0.0,
             "slo_max_window_burn_rate": 0.0, "slo_compliant": True,
             "steps": 40, "virtual_s": 0.8}
    olog = obs.RunLog(str(tmp_path / "lt.jsonl"), surface="loadtest")
    olog.event("loadtest", **point)
    olog.close()
    events = list(obs.read_run(olog.path))
    text = render(events)
    assert "loadtest[diurnal+bursty]" in text
    assert "8 device(s)" in text
    out = summarize(events)
    assert out["loadtest"][0]["devices"] == 8
    assert out["loadtest"][0]["goodput_qps"] == pytest.approx(340.0)
    assert "ts" not in out["loadtest"][0]


def test_serve_bench_artifact_schema(sweeps, tmp_path_factory):
    """``tests/test_loadtest.py:149``, on the ``serve_bench_v1`` artifact
    the port's ``--smoke`` sweep wrote: the metric line under
    ``parsed``, three finite points, goodput rising with the devices."""
    path = sweeps["smoke"][1]["line"]["out"]
    with open(path) as f:
        art = json.load(f)
    assert art["schema"] == "serve_bench_v1"
    assert {"metric", "value", "unit", "vs_baseline"} <= set(art["parsed"])
    assert art["parsed"]["unit"] == "req/s"
    sweep = art["sweep"]
    assert len(sweep) >= 3
    for p in sweep:
        for k in ("qps", "p50_s", "p99_s", "ttft_p50_s", "tpot_p50_s",
                  "goodput_qps", "slo_burn_rate"):
            assert math.isfinite(p[k]), (p["devices"], k)
        assert p["completed"] == p["requests"]
    devs = [p["devices"] for p in sweep]
    assert devs == sorted(devs)
    goodput = [p["goodput_qps"] for p in sweep]
    assert goodput[-1] > goodput[0]


def test_loadtest_carve():
    """``tests/test_disagg.py:615``."""
    from flexflow_tpu.apps.loadtest import _disagg_carve as jax_carve

    from flexflow_tpu_torch.apps.loadtest import _disagg_carve, parse_args

    assert _disagg_carve(2) == {
        "prefill_devices": 1, "decode_devices": 1,
        "prefill_replicas": 1, "per_replica_devices": 1}
    assert _disagg_carve(8) == {
        "prefill_devices": 4, "decode_devices": 4,
        "prefill_replicas": 2, "per_replica_devices": 2}
    assert all(_disagg_carve(n) == jax_carve(n) for n in range(1, 17))
    opts = parse_args(["--disagg", "--baseline", "X.json"])
    assert opts["disagg"] and opts["baseline"] == "X.json"
    opts = parse_args(["--chaos", "replica_crash@3"])
    assert opts["disagg"] and opts["chaos"] == "replica_crash@3"


def test_vs_baseline_artifact(tmp_path):
    """``tests/test_disagg.py:644``, on a baseline the test writes; and the
    chaos account against a fault-free artifact."""
    from flexflow_tpu_torch.apps.loadtest import (_vs_baseline_artifact,
                                                  _vs_chaos_baseline)

    base = {"schema": "serve_bench_v1",
            "sweep": [{"devices": 2, "ttft_p99_s": 0.4, "p99_s": 0.5,
                       "goodput_qps": 100.0, "slo_compliant": False,
                       "completed": 18}]}
    p = tmp_path / "single.json"
    p.write_text(json.dumps(base))
    sweep = [{"devices": 2, "ttft_p99_s": 0.2, "p99_s": 0.25,
              "goodput_qps": 150.0, "slo_compliant": True}]
    vs = _vs_baseline_artifact(sweep, str(p), _quiet)
    pt = vs["points"]["2"]
    assert pt["ttft_p99_speedup"] == pytest.approx(2.0)
    assert pt["goodput_ratio"] == pytest.approx(1.5)
    assert vs["baseline"] == "single.json"
    assert _vs_baseline_artifact(sweep, str(tmp_path / "nope"),
                                 _quiet) is None
    chaos = [dict(sweep[0], completed=16, unserved=1, shed=1, failed=0,
                  offered=18, retries=2, kv_rebuilds=1, replica_downs=1)]
    vc = _vs_chaos_baseline(chaos, str(p), _quiet)["points"]["2"]
    assert vc["no_silent_loss"] and vc["accounted"] == 18
    assert vc["goodput_ratio"] == pytest.approx(1.5)
    assert vc["p99_ratio"] == pytest.approx(0.5)


def test_baseline_block_only_when_given(sweeps, tmp_path):
    """``--baseline`` adds ``vs_r01`` to a ``--disagg`` sweep; the
    single-pool artifact the port's smoke sweep wrote serves as one."""
    from flexflow_tpu_torch.apps import loadtest

    base = sweeps["smoke"][1]["line"]["out"]
    out = loadtest.run(loadtest.parse_args(
        MODES["disagg"] + ["--device", "cpu", "--baseline", base]),
        log=_quiet)
    assert set(out["artifact"]["vs_r01"]["points"]) == {"2", "4"}
    assert set(out["line"]["vs_r01"]) == {"2", "4"}


def test_loadtest_refuses_the_cpu_without_asking():
    from flexflow_tpu_torch.apps import loadtest

    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        loadtest.main(["--smoke"], log=_quiet)
