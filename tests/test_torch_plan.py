"""The port's plan checker and HBM prediction
(``flexflow_tpu_torch/verify/{plan,memory,findings}.py``) against the
JAX package's, on the same graphs and virtual machines: the committed
strategies of ``examples/strategies/`` (AlexNet, VGG-16, the NMT and the
transformer, on 8 devices in one group or in 2 groups of 4) and the
defect cases of ``tests/test_plan_checker.py`` (duplicate and
out-of-range devices, divisibility, an unreachable regrid on 12 devices,
broken pipeline blocks, OOM, rank, the degradations with and without
``allow_degraded``, an honored set, an unknown op, a greedy regrid, the
clean default plan), each giving the same findings, summary and
per-device bytes; the file checks, ``check_plan``'s refusal and
``regrid_edge_cost``.  Both packages are held to the JAX package's 16 GB
capacity here; the port's own default is the H100's 80 GB.
"""

import json

import pytest

import torch_sim_parity as sp

CAPACITY = 1.6e10

#: committed strategy -> (model, batch, devices per fast-tier group, the
#: codes of the errors found: transformer_2x4's __pipeline__ block of 8
#: microbatches leaves one row a microbatch for a data axis of 4)
COMMITTED = {
    "alexnet_8dev.json": ("alexnet", 64, 8, set()),
    "alexnet_2x4.json": ("alexnet", 64, 4, set()),
    "vgg_2x4.json": ("vgg16", 64, 4, set()),
    "nmt_8dev.json": ("nmt", 64, 8, set()),
    "transformer_8dev.json": ("transformer", 8, 8, set()),
    "transformer_2x4.json": ("transformer", 8, 4, {"pipeline"}),
}


def _both(name, n=8, ici=None, batch=64):
    jm, tm = sp.machines(n, ici)
    return (jm, tm) + sp.models(name, jm, tm, batch)


def _lm(n=8):
    from flexflow_tpu.models.transformer import \
        TransformerConfig as JaxConfig
    from flexflow_tpu.models.transformer import TransformerLM as JaxLM

    from flexflow_tpu_torch.models.transformer import (TransformerConfig,
                                                       TransformerLM)

    kw = dict(batch_size=8, seq_length=64, num_layers=1, d_model=64,
              num_heads=4, d_ff=128, vocab_size=512)
    jm, tm = sp.machines(n)
    return jm, tm, JaxLM(JaxConfig(**kw), jm), TransformerLM(
        TransformerConfig(**kw), tm)


def _strategies(entries, pipeline=None):
    from flexflow_tpu.strategy import ParallelConfig as JaxPC
    from flexflow_tpu.strategy import Strategy as JaxStrategy

    from flexflow_tpu_torch.strategy import ParallelConfig, Strategy

    js, ts = JaxStrategy(), Strategy()
    for name, (dims, devices) in entries.items():
        js[name] = JaxPC(tuple(dims), tuple(devices))
        ts[name] = ParallelConfig(tuple(dims), tuple(devices))
    js.pipeline = ts.pipeline = pipeline
    return js, ts


def _dicts(findings):
    return [f.to_dict() for f in findings]


def _check_plans(jax_args, port_args, **kw):
    from flexflow_tpu.verify.plan import plan_findings as jax_plan

    from flexflow_tpu_torch.verify.plan import plan_findings

    kw.setdefault("hbm_capacity", CAPACITY)
    jf, jsum = jax_plan(*jax_args, **kw)
    tf, tsum = plan_findings(*port_args, **kw)
    assert _dicts(tf) == _dicts(jf)
    assert tsum == jsum
    return tf


def _check_memory(jax_args, port_args, **kw):
    from flexflow_tpu.verify.memory import \
        device_memory_report as jax_report

    from flexflow_tpu_torch.verify.memory import device_memory_report

    j = jax_report(*jax_args, hbm_capacity=CAPACITY, **kw)
    t = device_memory_report(*port_args, hbm_capacity=CAPACITY, **kw)
    assert t["over"] == j["over"] and t["capacity"] == j["capacity"]
    assert t["assumptions"] == j["assumptions"]
    assert t["per_device"].keys() == j["per_device"].keys()
    for dev, buckets in j["per_device"].items():
        for k, v in buckets.items():
            assert sp.rel(t["per_device"][dev][k], v) <= 1e-12, (dev, k)
    return t


@pytest.mark.parametrize("fname", sorted(COMMITTED))
def test_committed_strategies_check_alike(fname):
    from flexflow_tpu.verify.plan import \
        strategy_file_findings as jax_file

    from flexflow_tpu_torch.verify.plan import strategy_file_findings

    name, batch, ici, errors = COMMITTED[fname]
    path = str(sp.repo_root() / "examples" / "strategies" / fname)
    jf, jstrat = jax_file(path)
    tf, tstrat = strategy_file_findings(path)
    assert _dicts(tf) == _dicts(jf) == []
    assert tstrat.to_json() == jstrat.to_json()
    jm, tm, jmodel, tmodel = _both(name, 8, ici, batch)
    found = _check_plans((jmodel, jstrat, jm), (tmodel, tstrat, tm))
    assert {f.code for f in found if f.severity == "error"} == errors
    for forward_only in (False, True):
        _check_memory((jmodel, jstrat, jm), (tmodel, tstrat, tm),
                      forward_only=forward_only, donated=not forward_only)


#: tests/test_plan_checker.py's cases: (model, entries, pipeline, kwargs,
#: the codes the port must find)
DEFECTS = {
    "duplicate_device": ("alexnet", {"linear2": ((1, 4), (0, 1, 1, 2))},
                         None, {}, {"device_dup"}),
    "out_of_range": ("alexnet", {"linear2": ((1, 4), (0, 1, 2, 9))}, None,
                     {}, {"device_range"}),
    "ragged": ("alexnet", {"linear2": ((3, 1), (0, 1, 2))}, None, {},
               {"divisibility", "degraded_replicated"}),
    "unreachable_regrid": ("alexnet12",
                           {"linear2": ((2, 6), tuple(range(12)))}, None,
                           {}, {"regrid_unreachable"}),
    "broken_pipeline": ("lm", {}, {"stages": 3, "microbatches": 2,
                                   "tp": 1}, {}, {"pipeline"}),
    "pipeline_microbatches": ("lm", {}, {"stages": 2, "microbatches": 5,
                                         "tp": 1}, {}, {"pipeline"}),
    "oom": ("alexnet", {}, None, {"hbm_capacity": 1e6}, {"oom"}),
    "rank": ("alexnet", {"linear2": ((2, 2, 2), tuple(range(8)))}, None,
             {}, {"rank"}),
    "degraded_replicated": ("alexnet", {"linear2": ((3, 1), (1, 2, 3))},
                            None, {}, {"degraded_replicated",
                                       "divisibility"}),
    "degraded_normalized": ("lm", {"blk0_ln1": ((1, 2), (1, 2))}, None, {},
                            {"degraded_normalized"}),
    "allow_degraded": ("lm", {"blk0_ln1": ((1, 2), (1, 2))}, None,
                       {"allow_degraded": True}, {"degraded_normalized"}),
    "honored_set": ("alexnet", {"linear2": ((2, 1), (1, 5))}, None, {},
                    set()),
    "unknown_op": ("alexnet", {"no_such_op": ((1, 4), (0, 1, 2, 3))}, None,
                   {}, {"unknown_op"}),
    "greedy_regrid": ("alexnet", {"conv1": ((2, 1, 1, 4), tuple(range(8))),
                                  "conv2": ((1, 1, 1, 8), tuple(range(8)))},
                      None, {}, None),
    "clean_default": ("alexnet", {}, None, {}, set()),
}


@pytest.fixture(scope="module")
def graphs():
    alexnet = _both("alexnet")
    return {"alexnet": alexnet, "alexnet12": _both("alexnet", 12, 12, 48),
            "lm": _lm()}


@pytest.mark.parametrize("case", sorted(DEFECTS))
def test_defects_found_alike(graphs, case):
    model, entries, pipeline, kw, codes = DEFECTS[case]
    jm, tm, jmodel, tmodel = graphs[model]
    jstrat, tstrat = _strategies(entries, pipeline)
    found = _check_plans((jmodel, jstrat, jm), (tmodel, tstrat, tm), **kw)
    if codes is not None:
        assert {f.code for f in found} == codes
    if case == "greedy_regrid":
        assert all(f.severity != "error" for f in found)
    if case == "allow_degraded":
        assert [f.severity for f in found] == ["warning"]
    if "hbm_capacity" not in kw:
        _check_memory((jmodel, jstrat, jm), (tmodel, tstrat, tm))


def test_strategy_files_checked_alike(tmp_path):
    from flexflow_tpu.verify.plan import \
        strategy_file_findings as jax_file

    from flexflow_tpu_torch.verify.plan import strategy_file_findings

    bad = tmp_path / "bad.json"
    bad.write_text(json.dumps({
        "a": {"dims": [0, 2], "devices": [0, 1]},
        "b": {"dims": [2], "devices": [0, 1, 2]},
        "c": "not a grid",
        "__pipeline__": {"stages": "x", "microbatches": 2}}))
    garbage = tmp_path / "garbage.json"
    garbage.write_text("{not json")
    proto = tmp_path / "s.pb"
    from flexflow_tpu_torch.strategy import ParallelConfig, Strategy

    s = Strategy()
    s["x"] = ParallelConfig((2, 1), (0, 1))
    s.save(str(proto))
    for path in (bad, garbage, proto, tmp_path / "missing.json"):
        jf, js = jax_file(str(path))
        tf, ts = strategy_file_findings(str(path))
        assert _dicts(tf) == _dicts(jf)
        assert (ts is None) == (js is None)
        if ts is not None:
            assert ts.to_json() == js.to_json()


def test_pipeline_and_multi_axis_findings_alike(graphs):
    from flexflow_tpu.ops.base import Op as JaxOp
    from flexflow_tpu.ops.base import Tensor as JaxTensor
    from flexflow_tpu.strategy import ParallelConfig as JaxPC
    from flexflow_tpu.verify.plan import op_findings as jax_op_findings
    from flexflow_tpu.verify.plan import \
        pipeline_findings as jax_pipeline

    from flexflow_tpu_torch.ops.base import Op, Tensor
    from flexflow_tpu_torch.strategy import ParallelConfig
    from flexflow_tpu_torch.verify.plan import op_findings, pipeline_findings

    jm, tm, jlm, tlm = graphs["lm"]
    pp = {"stages": 2, "microbatches": 2, "tp": 3}
    assert _dicts(pipeline_findings(pp, tlm, tm)) == \
        _dicts(jax_pipeline(pp, jlm, jm)) != []

    class _JaxMulti(JaxOp):
        AXIS_NAMES = ("c", "n")

        def __init__(self, pc):
            super().__init__("multi", pc, [])
            self.output = JaxTensor((12,), "float32", self, "multi")

        def output_spec(self):
            from jax.sharding import PartitionSpec as P

            return P(("c", "n"))

    class _Multi(Op):
        AXIS_NAMES = ("c", "n")

        def __init__(self, pc):
            super().__init__("multi", pc, [])
            self.output = Tensor((12,), "float32", self, "multi")

        def output_spec(self):
            return (("c", "n"),)

    for dims, n in (((2, 4), 8), ((2, 2), 4)):
        jm_n, tm_n = sp.machines(n)
        jpc = JaxPC(dims, tuple(range(n)))
        tpc = ParallelConfig(dims, tuple(range(n)))
        assert _dicts(op_findings(_Multi(tpc), tpc, tm_n)) == \
            _dicts(jax_op_findings(_JaxMulti(jpc), jpc, jm_n))


def test_check_plan_refuses_like_the_jax_one(graphs, capsys):
    from flexflow_tpu_torch.verify.plan import check_plan

    jm, tm, jlm, tlm = graphs["lm"]
    _, ts = _strategies({"blk0_ln1": ((1, 2), (1, 2))})
    with pytest.raises(SystemExit) as e:
        check_plan(tlm, ts, tm, label="unit")
    assert e.value.code == 2
    assert "degraded_normalized" in capsys.readouterr().err
    found = check_plan(tlm, ts, tm, allow_degraded=True, label="unit")
    assert [f.severity for f in found] == ["warning"]


def test_regrid_edge_cost_and_default_capacity(graphs):
    from flexflow_tpu.strategy import ParallelConfig as JaxPC
    from flexflow_tpu.verify.plan import regrid_edge_cost as jax_cost

    from flexflow_tpu_torch.strategy import ParallelConfig
    from flexflow_tpu_torch.verify.memory import device_memory_report
    from flexflow_tpu_torch.verify.plan import regrid_edge_cost

    jm, tm = sp.machines(8, 4)
    pairs = [(((1, 8), tuple(range(8))), ((8, 1), tuple(range(8)))),
             (((1, 4), (0, 1, 2, 3)), ((1, 4), (4, 5, 6, 7))),
             (((2, 2), (0, 1, 2, 3)), ((2, 2), (0, 1, 2, 3)))]
    for (sd, sv), (dd, dv) in pairs:
        assert regrid_edge_cost((64, 512, 768), ParallelConfig(sd, sv),
                                ParallelConfig(dd, dv), tm) == \
            jax_cost((64, 512, 768), JaxPC(sd, sv), JaxPC(dd, dv), jm)
    _, tm8, _, talexnet = graphs["alexnet"]
    assert device_memory_report(talexnet, None, tm8)["capacity"] == 8.0e10
