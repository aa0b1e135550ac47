"""``python -m flexflow_tpu_torch.apps.searchscale`` (PyTorch port of
``flexflow_tpu/apps/searchscale.py``): on the JAX package's constants
(the tests swap the port's H100 peaks and NVLink tier for them) the
``--smoke`` row's deterministic payload equals the JAX sweep's, but for
the parameter count, which counts the port's own leaves (one attention
bias of d a block where the JAX formula counts 4d,
``models/gpt.py`` ``gpt_param_count``); the smoke's repro check passes
and ``-o`` writes the ``searchscale_bench_v1`` artifact; serving is on
by default, and the headline row's ``serving`` block (a decomposed
search per serving objective, each plan gated) equals JAX's.
"""

import json

import pytest
import torch

import torch_sim_parity as sp

torch.set_num_threads(2)


@pytest.fixture
def jax_constants(monkeypatch):
    from flexflow_tpu_torch.machine import Topology
    from flexflow_tpu_torch.sim import cost_model

    perf = sp.jax_perf()
    monkeypatch.setattr(cost_model, "HopperChipPerf", lambda: perf)
    monkeypatch.setattr(Topology, "hopper", classmethod(
        lambda cls, g=8: cls(devices_per_ici_group=g)))


def test_smoke_row_equals_jax(tmp_path, jax_constants, capsys):
    from flexflow_tpu.apps import searchscale as jax_app

    from flexflow_tpu_torch.apps import searchscale

    argv = ["--smoke", "--no-serving"]
    want = jax_app.run(jax_app.parse_args(argv), log=lambda *a: None)
    lines = []
    out = tmp_path / "sweep.json"
    assert searchscale.main(argv + ["-o", str(out)],
                            log=lines.append) == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["repro"] is True and line["plan_gate_clean"] is True
    assert any(s.startswith("searchscale repro ok") for s in lines)
    got = json.loads(out.read_text())
    assert got["schema"] == "searchscale_bench_v1"
    (row,), (jrow,) = got["rows"], want["artifact"]["rows"]
    mine, theirs = searchscale.deterministic(row), \
        jax_app._deterministic(jrow)
    d, layers = 128, 4
    assert mine.pop("params") == theirs.pop("params") - 3 * d * layers
    assert mine == theirs
    assert row["decomposed"]["memo_hits"] >= 1
    jline = dict(want["line"])
    for key in ("params", "out"):
        jline.pop(key, None), line.pop(key, None)
    assert line == jline


def test_serving_at_the_headline_raises(jax_constants):
    """Serving is on by default (off under ``--no-serving`` and
    ``--smoke``), and the headline row's serving rows are built; they
    equal JAX's after ``_deterministic``."""
    from flexflow_tpu.apps import searchscale as jax_app

    from flexflow_tpu_torch.apps import searchscale

    assert searchscale.parse_args([])["serving"]
    assert searchscale.parse_args(["--sizes", "0.1b,1.3b"])["serving"]
    assert not searchscale.parse_args(["--no-serving"])["serving"]
    assert not searchscale.parse_args(["--smoke"])["serving"]
    argv = ["--sizes", "tiny", "--headline", "tiny", "-d", "8", "-i", "400"]
    want = jax_app.run(jax_app.parse_args(argv), log=lambda *a: None)
    got = searchscale.run(searchscale.parse_args(argv), log=lambda *a: None)
    (row,), (jrow,) = got["artifact"]["rows"], want["artifact"]["rows"]
    assert set(row["serving"]) == {"latency", "decode"}
    assert searchscale.deterministic(row)["serving"] == \
        jax_app._deterministic(jrow)["serving"]
    assert all(b["plan_gate_clean"] and b["wall_s"] >= 0
               for b in row["serving"].values())
