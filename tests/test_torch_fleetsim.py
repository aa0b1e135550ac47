"""The port's trace-driven fleet simulation (``apps/fleetsim.py``)
against the JAX package's: the same seeded sweeps give point payloads
byte-equal to JAX's (as ``json.dumps`` with sorted keys), the same
records, and the port's ``--smoke`` holds its own contract (one JSON
line, a bit-identical repeat, no invariant violation, a validated
trace)."""

import json
import os

import pytest

from flexflow_tpu.apps import fleetsim as j_fleetsim
from flexflow_tpu_torch.apps import fleetsim as t_fleetsim


def _quiet(*a, **k):
    pass


def _point(mod, tmp_path, pool, **over):
    opts = mod.parse_args([])
    opts.update({"jobs": 10, "day_s": 1800.0, "quantum": 4,
                 "step_time_s": 10.0, "resize_steps": 2,
                 "slo_wait_s": 300.0, "obs_dir": str(tmp_path)})
    opts.update(over)
    tag = "jax" if mod is j_fleetsim else "torch"
    path = os.path.join(str(tmp_path), f"{tag}_{pool}.jsonl")
    point = mod._sweep_point(pool, opts, path, _quiet)
    if mod is j_fleetsim:
        from flexflow_tpu import obs
    else:
        from flexflow_tpu_torch import obs
    recs = [{k: v for k, v in r.items()
             if k not in ("ts", "run", "wall_s", "pid", "host")}
            for r in obs.read_run(path)]
    return point, recs


@pytest.mark.parametrize("pool,over", [
    (4, {}),
    (8, {"jobs": 30}),
    (8, {"jobs": 30, "pattern": "poisson", "train_frac": 0.5}),
])
def test_sweep_point_byte_equal_to_jax(tmp_path, pool, over):
    tp, trecs = _point(t_fleetsim, tmp_path, pool, **over)
    jp, jrecs = _point(j_fleetsim, tmp_path, pool, **over)
    assert json.dumps(tp, sort_keys=True) == json.dumps(jp, sort_keys=True)
    assert trecs == jrecs


def test_parse_and_gen_jobs_match_jax():
    for argv in ([], ["--smoke"], ["--jobs", "40", "--pools", "4,8"]):
        assert t_fleetsim.parse_args(argv) == j_fleetsim.parse_args(argv)
    opts = t_fleetsim.parse_args(["--jobs", "40"])
    t = [(at, {k: v for k, v in kw.items() if k not in ("build",)})
         for at, kw in t_fleetsim.gen_jobs(opts)]
    j = [(at, {k: v for k, v in kw.items() if k not in ("build",)})
         for at, kw in j_fleetsim.gen_jobs(opts)]
    assert repr(t) == repr(j)


def test_fleetsim_smoke_contract(capsys):
    assert t_fleetsim.main(["--smoke"], log=_quiet) == 0
    out = capsys.readouterr().out.strip().splitlines()
    assert len(out) == 1
    line = json.loads(out[0])
    assert line["repro"] is True and line["util_violations"] == 0
    assert line["trace_validated"] is True
    assert line["metric"].startswith("fleet_sim_util_")
