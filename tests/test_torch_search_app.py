"""``python -m flexflow_tpu_torch.apps.search`` (PyTorch port of
``flexflow_tpu/apps/search.py``):

* on the JAX package's constants (the tests swap the port's H100 peaks
  and NVLink topology for them), ``alexnet --devices 8 -i 2000 -o x.json``
  and ``-o x.pb`` write the JAX driver's files byte for byte, and
  ``gpt-1.3b --devices 8 --decompose`` its decomposed strategy, with the
  same keys and values in the stdout line;
* ``--serve``, ``--disagg 2`` and ``--objective decode`` write the JAX
  driver's file and line (the serving search's tiny-GPT artifacts:
  ``tests/test_torch_serve_search.py``);
* the flag of a module not ported raises ``NotImplementedError``
  (``--audit``, and the JAX driver's default audit of a saved plan's win
  on two tiers unless ``--no-audit``);
* the transformer's search logs its GPipe candidates and decision and
  carries the block exactly when it is accepted;
* ``--measured`` raises without CUDA, and with ``--device cpu`` times
  every shard a clone exists for (a narrow AlexNet), caches the times
  and anchors the rest;
* the strategy the app finds for a narrow AlexNet on 4 devices in two
  groups (channel, spatial and subset grids) trains on 4 gloo ranks through
  ``apps.cnn -s`` with losses within 2e-4 of one process's.
"""

import json

import numpy as np
import pytest
import torch

import torch_ranks as tr
import torch_sim_parity as sp

torch.set_num_threads(2)


@pytest.fixture
def jax_constants(monkeypatch):
    """The port's app on the JAX package's chip constants and links."""
    from flexflow_tpu_torch.machine import Topology
    from flexflow_tpu_torch.sim import cost_model

    perf = sp.jax_perf()
    monkeypatch.setattr(cost_model, "HopperChipPerf", lambda: perf)
    monkeypatch.setattr(Topology, "hopper", classmethod(
        lambda cls, g=8: cls(devices_per_ici_group=g)))


def _run(main, argv):
    lines = []
    out = main(argv, log=lines.append)
    line = next(json.loads(s) for s in lines if s.startswith("{"))
    return out, line


@pytest.mark.parametrize("argv,suffix", [
    (["alexnet", "--devices", "8", "-i", "2000"], ".json"),
    (["alexnet", "--devices", "8", "-i", "2000"], ".pb"),
    (["gpt-1.3b", "--devices", "8", "-i", "3000", "--decompose"], ".json"),
], ids=["alexnet-json", "alexnet-proto", "gpt-1.3b-decomposed"])
def test_app_writes_the_jax_drivers_file(tmp_path, jax_constants, argv,
                                         suffix):
    from flexflow_tpu.apps import search as jax_app

    from flexflow_tpu_torch.apps import search

    jpath, tpath = tmp_path / f"jax{suffix}", tmp_path / f"port{suffix}"
    _, jline = _run(jax_app.main, argv + ["-o", str(jpath)])
    _, tline = _run(search.main, argv + ["-o", str(tpath)])
    assert tpath.read_bytes() == jpath.read_bytes()
    assert tline.keys() == jline.keys()
    for key in ("run_id", "obs_path", "proposals_per_sec"):
        jline.pop(key, None), tline.pop(key, None)
    assert tline == jline
    assert (tmp_path / "port.trace.jsonl").exists()


@pytest.mark.parametrize("flags", [
    ["--serve"], ["--disagg", "2"], ["--objective", "decode"]],
    ids=lambda f: f[0])
def test_serving_flags_write_the_jax_drivers_file(tmp_path, jax_constants,
                                                  flags):
    from flexflow_tpu.apps import search as jax_app

    from flexflow_tpu_torch.apps import search

    argv = ["alexnet", "--devices", "8", "-i", "200"] + flags
    jpath, tpath = tmp_path / "jax.json", tmp_path / "port.json"
    _, jline = _run(jax_app.main, argv + ["-o", str(jpath)])
    _, tline = _run(search.main, argv + ["-o", str(tpath)])
    assert tpath.read_bytes() == jpath.read_bytes()
    for key in ("run_id", "obs_path"):
        jline.pop(key, None), tline.pop(key, None)
    assert tline == jline
    assert ("serve" in tline) == (flags[0] != "--objective")


@pytest.mark.parametrize("flags", [["--audit"]], ids=lambda f: f[0])
def test_unported_flags_raise(flags):
    from flexflow_tpu_torch.apps import search

    with pytest.raises(NotImplementedError, match="ROADMAP"):
        search.main(["alexnet", "--devices", "8", "-i", "10"] + flags,
                    log=lambda *a: None)


def test_default_audit_raises_and_no_audit_writes(tmp_path):
    from flexflow_tpu_torch.apps import search

    argv = ["alexnet", "--devices", "8", "--ici-group", "4", "-i", "3000",
            "-o", str(tmp_path / "s.json")]
    with pytest.raises(NotImplementedError, match="--no-audit"):
        search.main(argv, log=lambda *a: None)
    assert not (tmp_path / "s.json").exists()
    out = search.main(argv + ["--no-audit"], log=lambda *a: None)
    assert out["speedup_vs_dp"] > 1.05
    saved = json.loads((tmp_path / "s.json").read_text())
    assert saved["__predicted__"]["devices"] == 8


def test_transformer_search_proposes_a_pipeline_block():
    from flexflow_tpu_torch.apps import search

    lines = []
    out = search.main(["transformer", "--devices", "4", "-b", "8", "-i",
                       "500"], log=lines.append)
    # every candidate logged with its terms, then the decision; the
    # block is set exactly when it is accepted
    cands = [s for s in lines if s.startswith("pipeline candidate")]
    assert cands and all("bubble" in s and "sync" in s for s in cands)
    assert sum(s.startswith("pipeline decision:") for s in lines) == 1
    pp = out["pipeline"]
    assert pp["reference_time_s"] <= out["best_time_s"]
    assert len(out["proposal"]["candidates"]) == len(cands)
    assert out["proposal"]["best"] == pp["best"]
    assert out["strategy"].pipeline == (pp["best"] if pp["accepted"]
                                        else None)
    assert set(out["strategy"]) == {op.name for op in search.build_model(
        "transformer", search._machine({"devices": 4, "ici_group": None,
                                        "dcn_calibration": ""}), 8).layers}


def _narrow_alexnet(name, machine, batch, dtype="float32", experts=0):
    from flexflow_tpu_torch.config import FFConfig
    from flexflow_tpu_torch.models.alexnet import build_alexnet

    assert name == "alexnet"
    return build_alexnet(FFConfig(batch_size=batch, input_height=99,
                                  input_width=99, compute_dtype=dtype),
                         machine)


def test_measured_search_needs_cuda_or_the_cpu(tmp_path, monkeypatch):
    from flexflow_tpu_torch.apps import search

    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        search.main(["alexnet", "--devices", "2", "--measured"],
                    log=lambda *a: None)
    monkeypatch.setattr(search, "build_model", _narrow_alexnet)
    cache = tmp_path / "cache.json"
    lines = []
    out = search.main(["alexnet", "--devices", "2", "-b", "4", "-i", "500",
                       "--measured", "--device", "cpu", "--cache",
                       str(cache)], log=lines.append)
    m = out["measurement"]
    # conv, pool and linear shards are timed; flat and softmax estimated,
    # each shard counted once though the search asks for it twice
    assert m["shards_timed"] > 10 and m["estimated"] > 0
    assert m["estimated"] == sum(k.startswith("estimate|") for k in
                                 json.loads(cache.read_text()))
    assert search.MEASURED_UNCHECKED in lines
    assert m["protocol"] == "torch2|cpu|" and m["device"] == "cpu"
    assert set(m["anchors"]) == {"Conv2D", "Pool2D", "Linear"}
    times = {k: v for k, v in json.loads(cache.read_text()).items()
             if not k.startswith("estimate|")}
    assert len(times) == m["shards_timed"]
    assert all(k.startswith("torch2|cpu|") and v > 0
               for k, v in times.items())
    assert out["strategy"].predicted["cost_model"] == "measured"
    # a second run serves every time from the cache
    again = search.main(["alexnet", "--devices", "2", "-b", "4", "-i",
                         "500", "--measured", "--device", "cpu", "--cache",
                         str(cache)], log=lambda *a: None)
    assert again["measurement"]["shards_timed"] == 0
    assert again["best_time_s"] == out["best_time_s"]


def test_searched_strategy_trains_on_four_ranks(tmp_path, monkeypatch):
    from flexflow_tpu_torch.apps import cnn, search

    monkeypatch.setattr(search, "build_model", _narrow_alexnet)
    path = tmp_path / "s.json"
    # two NVLink groups of 2: the slow tier pushes ops onto subsets
    found = search.main(["alexnet", "--devices", "4", "--ici-group", "2",
                         "--no-audit", "-b", "8", "-i", "3000", "-o",
                         str(path)], log=lambda *a: None)
    grids = found["strategy"]
    assert found["speedup_vs_dp"] > 1.0
    # the search left data parallelism: channel or spatial splits and
    # ops on device subsets
    assert any(pc.dims[:-1] != (1,) * (len(pc.dims) - 1)
               for pc in grids.values())
    assert any(len(pc.devices) < 4 for pc in grids.values())
    argv = ["alexnet", "-b", "8", "-i", "3", "--height", "99", "--width",
            "99", "--lr", "0.001", "-p", "0", "--device", "cpu"]
    got = tr.run_ranks(tr.app_main, 4,
                       argv + ["-s", str(path), "-ll:gpu", "4"],
                       timeout=150)
    assert got[1:] == [None] * 3
    want = cnn.main(argv, log=lambda *a: None)["loss"]
    np.testing.assert_allclose(got[0], want, rtol=2e-4, atol=2e-5)
