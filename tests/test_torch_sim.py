"""The port's strategy search (``flexflow_tpu_torch/sim/``) against the
JAX package's on the same graphs, machines and cost constants
(``torch_sim_parity.jax_perf``), both on virtual machines that touch no
device:

* every op's candidate list, in order, for the eight models
  ``apps.search`` builds, at 8 devices and at 16 in groups of 8; at 8,
  per (op, candidate) the geometry exactly and the analytic cost, the
  collectives' cost and the shard's HBM bytes within 1e-12 relative;
  the ops' cost hooks (flops, parameter bytes, cost signature, whether
  a clone exists and its shapes); the simulator's two tables element
  for element; the simulated step of data parallelism and of 32 seeded
  random assignments;
* ``search()`` from seed 0 writes the same strategy JSON with the same
  times: AlexNet with 1 and 4 chains under delta on, off and check,
  the small NMT on a two-tier machine
  (``test_search_discovers_operator_parallel_nmt``'s setting), a
  4-block transformer under ``search_decomposed`` (same memo hits), and
  the 12-block transformer priced from the committed measured cache
  (its keys rewritten to the port's protocol tag; a cache miss fails);
* the native library built from the port's own source, the
  ``MeasuredCostModel`` protocol on the CPU (keys, estimates, anchors,
  the cache file), ``MachineModel.virtual`` and ``Topology``.
"""

import json

import numpy as np
import pytest
import torch

import torch_sim_parity as sp

torch.set_num_threads(2)

SIZES = [(8, None), (16, 8)]


def _shapes(op):
    return ([t.shape for t in op.inputs],
            [t.shape for t in op.all_outputs()])


@pytest.mark.parametrize("n,ici", SIZES, ids=["8dev", "16dev-2x8"])
@pytest.mark.parametrize("name", sp.MODELS)
def test_candidates_costs_and_tables_equal(name, n, ici):
    from flexflow_tpu.sim import collectives as jcol
    from flexflow_tpu.sim import search as jsearch

    from flexflow_tpu_torch.sim import collectives, search

    js, ts = sp.pair(name, n, ici)
    # the input sources are named by tensor ids, which each package
    # counts on its own
    assert len(js.inputs) == len(ts.inputs)
    assert [o.name for o in js.ops[len(js.inputs):]] == \
        [o.name for o in ts.ops[len(ts.inputs):]]
    jtopo, ttopo = js.machine.topology, ts.machine.topology
    for jo, to, jc, tc in zip(js.ops, ts.ops, js.candidates, ts.candidates):
        assert [(p.dims, p.devices) for p in jc] == \
            [(p.dims, p.devices) for p in tc], jo.name
        assert _shapes(jo) == _shapes(to)
        assert jo.flops_per_sample() == to.flops_per_sample()
        assert jo.param_bytes() == to.param_bytes()
        assert jo.cost_signature() == to.cost_signature()
        assert (jo.placement_signature() is None) == \
            (to.placement_signature() is None), jo.name
        if isinstance(jo, jsearch._InputSource) or n > 8:
            continue   # at 16 devices the tables below hold all of it
        for jpc, tpc in zip(jc, tc):
            assert jsearch.op_geometry(jo, jpc) == \
                search.op_geometry(to, tpc)
            assert (jo.input_specs(jpc) is None) == \
                (to.input_specs(tpc) is None)
            jl, tl = jo.local_clone(jpc), to.local_clone(tpc)
            assert (jl is None) == (tl is None)
            if jl is not None:
                assert _shapes(jl) == _shapes(tl)
            assert sp.rel(js.cost_model.op_cost(jo, jpc),
                          ts.cost_model.op_cost(to, tpc)) <= 1e-12
            assert sp.rel(jcol.collective_cost(jo, jpc, jtopo)
                          + jcol.dispatch_overhead_cost(jo, jpc, jtopo, n),
                          collectives.collective_cost(to, tpc, ttopo)
                          + collectives.dispatch_overhead_cost(
                              to, tpc, ttopo, n)) <= 1e-12
            assert sp.rel(jsearch.shard_hbm_bytes(jo, jpc),
                          search.shard_hbm_bytes(to, tpc)) <= 1e-12
    np.testing.assert_array_equal(ts.sim._ints, js.sim._ints)
    np.testing.assert_array_equal(ts.sim._dbls, js.sim._dbls)
    assert js._opt_stream_s == ts._opt_stream_s
    dp = js.dp_assignment()
    assert dp == ts.dp_assignment()
    assert js.simulate(dp) == ts.simulate(dp)
    rng = np.random.RandomState(0)
    for _ in range(32):
        a = [int(rng.randint(len(c))) for c in ts.candidates]
        assert js.simulate(a) == ts.simulate(a)


@pytest.fixture(scope="module")
def alexnet8():
    return sp.pair("alexnet", 8)


@pytest.mark.parametrize("chains", [1, 4])
@pytest.mark.parametrize("delta", ["on", "off", "check"])
def test_search_writes_the_same_strategy(alexnet8, chains, delta):
    js, ts = alexnet8
    kw = dict(iters=3000, seed=0, chains=chains, delta=delta != "off",
              delta_check=delta == "check")
    js_strat, jinfo = js.search(**kw)
    ts_strat, tinfo = ts.search(**kw)
    assert ts_strat.to_json() == js_strat.to_json()
    assert tinfo["dp_time"] == jinfo["dp_time"]
    assert tinfo["best_time"] == jinfo["best_time"]
    assert tinfo["assignment"] == jinfo["assignment"]
    assert tinfo["best_time"] < tinfo["dp_time"]


def test_search_nmt_on_two_tiers_matches():
    """``test_search_discovers_operator_parallel_nmt``'s setting: the
    small NMT on 2 groups of 4, 20000 proposals from seed 0."""
    from flexflow_tpu.nmt.rnn_model import RnnConfig as JaxRnnConfig
    from flexflow_tpu.nmt.rnn_model import RnnModel as JaxRnnModel

    from flexflow_tpu_torch.nmt.rnn_model import RnnConfig, RnnModel

    kw = dict(batch_size=64, num_layers=2, seq_length=8, hidden_size=256,
              embed_size=256, vocab_size=8192, lstm_per_node_length=4)
    jm, tm = sp.machines(8, 4)
    js, ts = sp.searches(JaxRnnModel(JaxRnnConfig(**kw), jm),
                         RnnModel(RnnConfig(**kw), tm), jm, tm)
    js_strat, jinfo = js.search(iters=20000, seed=0)
    ts_strat, tinfo = ts.search(iters=20000, seed=0)
    assert ts_strat.to_json() == js_strat.to_json()
    assert (tinfo["dp_time"], tinfo["best_time"]) == \
        (jinfo["dp_time"], jinfo["best_time"])
    assert tinfo["speedup_vs_dp"] > 1.5
    embeds = [pc for name, pc in ts_strat.items()
              if name.startswith("embed")]
    assert any(set(a.devices).isdisjoint(b.devices)
               for a in embeds for b in embeds)


def test_search_decomposed_transformer_matches():
    from flexflow_tpu.models.transformer import \
        TransformerConfig as JaxConfig
    from flexflow_tpu.models.transformer import TransformerLM as JaxLM

    from flexflow_tpu_torch.models.transformer import (TransformerConfig,
                                                       TransformerLM)

    kw = dict(batch_size=16, seq_length=256, num_layers=4, d_model=512,
              num_heads=8, d_ff=2048, vocab_size=8192)
    jm, tm = sp.machines(8)
    js, ts = sp.searches(JaxLM(JaxConfig(**kw), jm),
                         TransformerLM(TransformerConfig(**kw), tm), jm, tm)
    assert [b.indices for b in js.partition_blocks()] == \
        [b.indices for b in ts.partition_blocks()]
    js_strat, jinfo = js.search_decomposed(iters=4000, seed=0)
    ts_strat, tinfo = ts.search_decomposed(iters=4000, seed=0)
    assert ts_strat.to_json() == js_strat.to_json()
    for key in ("dp_time", "best_time", "stitched_time", "memo_hits",
                "blocks", "unique_blocks", "boundary_ops",
                "boundary_regrid_s"):
        assert tinfo[key] == jinfo[key], key
    # blk1-blk3 share one fingerprint; blk0 reads the stem's output
    assert tinfo["memo_hits"] == 2


def test_measured_cache_search_matches(tmp_path, monkeypatch):
    """The same measured cost table and seed give the same strategy: the
    committed transformer cache (batch 64, 8 devices), its keys rewritten
    to the port's protocol tag; neither model may time anything."""
    from flexflow_tpu.sim import cost_model as jcm

    from flexflow_tpu_torch.sim import cost_model as tcm

    root = sp.repo_root()
    with open(root / "examples/strategies/measured_cache_transformer.json") \
            as f:
        table = json.load(f)
    jax_path, port_path = tmp_path / "jax.json", tmp_path / "port.json"
    jax_path.write_text(json.dumps(table))
    tag = tcm.MeasuredCostModel(device="cpu").protocol
    port_path.write_text(json.dumps(
        {(tag + k[3:] if k.startswith("v3|") else k): v
         for k, v in table.items()}))
    port = tcm.MeasuredCostModel(
        cache_path=str(port_path), device="cpu",
        fallback=tcm.AnalyticCostModel(perf=sp.jax_perf()))
    jax_model = jcm.MeasuredCostModel(cache_path=str(jax_path))

    def no_timing(*args):
        raise AssertionError("cache miss: a shard would be timed")

    def jax_no_timing(self, op, pc):
        # the JAX model asks _measure for the shards without a clone too
        if op.local_clone(pc) is not None:
            no_timing()

    monkeypatch.setattr(jcm.MeasuredCostModel, "_measure", jax_no_timing)
    monkeypatch.setattr(tcm.MeasuredCostModel, "_measure", no_timing)
    js, ts = sp.pair("transformer", 8, cost_model=port,
                     jax_cost_model=jax_model)
    np.testing.assert_array_equal(ts.sim._dbls, js.sim._dbls)
    js_strat, jinfo = js.search(iters=3000, seed=0)
    ts_strat, tinfo = ts.search(iters=3000, seed=0)
    assert ts_strat.to_json() == js_strat.to_json()
    assert (tinfo["dp_time"], tinfo["best_time"]) == \
        (jinfo["dp_time"], jinfo["best_time"])
    assert port.cache_hits > 0 and port.measured == 0
    assert port.anchors() == {
        k: sorted(v)[len(v) // 2]
        for k, v in sorted(jax_model._kind_ratios.items())}


def test_native_library_builds_from_the_port_source():
    from flexflow_tpu_torch.sim import native

    lib = native.build()
    assert lib.parent == native.BUILD_DIR
    assert native.SOURCE.parent.parent.name == "flexflow_tpu_torch"
    assert (sp.repo_root() / "flexflow_tpu/native/simulator.cc"
            ).read_bytes() == native.SOURCE.read_bytes()
    # one op, one config, compute 0.5 s: a step of 0.5 s
    sim = native.NativeSimulator(
        [1, 1, 1, 0, 1, 1, 0, 0, 2, 0, 1, 0, 1, 0, 1],
        [1.0, 1.0, 0.0, 0.0, 0.5, 1.0, 0.0], 1)
    assert abs(sim.simulate([0]) - 0.5) < 1e-12
    records, total = sim.simulate_trace([0])
    assert total == sim.simulate([0])
    assert records[0]["kind"] == "compute"


def test_delta_state_equals_full_simulation(alexnet8):
    _, ts = alexnet8
    rng = np.random.RandomState(3)
    cur = ts.dp_assignment()
    ds = ts.sim.delta_state()
    ds.init(cur)
    for _ in range(50):
        op = int(rng.randint(len(cur)))
        cfg = int(rng.randint(len(ts.candidates[op])))
        t = ds.propose(op, cfg)
        cur = list(cur)
        cur[op] = cfg
        assert t == ts.sim.simulate(cur)
        ds.commit()


def _linear():
    from flexflow_tpu_torch.ops.base import Tensor
    from flexflow_tpu_torch.ops.linear import Linear
    from flexflow_tpu_torch.strategy import ParallelConfig

    return Linear("fc", ParallelConfig((1, 4), (0, 1, 2, 3)),
                  Tensor((32, 48)), 64)


def test_measured_model_times_on_the_cpu_and_caches(tmp_path):
    from flexflow_tpu_torch.ops.softmax import Softmax
    from flexflow_tpu_torch.sim.cost_model import MeasuredCostModel
    from flexflow_tpu_torch.strategy import ParallelConfig

    path = tmp_path / "cache.json"
    path.write_text(json.dumps({"v3|Linear|x|(1, 4)": 1.0}))
    cm = MeasuredCostModel(cache_path=str(path), device="cpu", repeats=3,
                           chain=2, save_every=1)
    assert cm.protocol == "torch2|cpu|"
    op = _linear()
    pc = ParallelConfig((2, 2), (0, 1, 2, 3))
    t = cm.op_cost(op, pc)
    assert t > 0 and cm.measured == 1 and cm.cache_misses == 1
    assert cm.op_cost(op, pc) == t and cm.cache_hits == 1
    saved = json.loads(path.read_text())
    assert saved["v3|Linear|x|(1, 4)"] == 1.0    # another protocol's, kept
    key = "torch2|cpu|Linear|[(32, 48), (32, 64)]|(2, 2)"
    assert saved[key] == t
    ratio = cm.anchors()["Linear"]
    assert ratio == pytest.approx(t / cm.fallback.op_cost(op, pc))
    # a reload serves the time without timing
    again = MeasuredCostModel(cache_path=str(path), device="cpu")
    assert again.op_cost(op, pc) == t and again.measured == 0
    # an op without a clone takes the analytic cost, scaled by its
    # kind's anchor, and is counted, not cached
    sm = Softmax("sm", ParallelConfig((4,), (0, 1, 2, 3)), op.output)
    est = cm.op_cost(sm, sm.pc)
    assert est == cm.fallback.op_cost(sm, sm.pc) and cm.estimated == 1
    # a shard asked for again is still one estimate
    assert cm.op_cost(sm, sm.pc) == est and cm.estimated == 1
    seeded = MeasuredCostModel(device="cpu", anchors={"Softmax": 2.0})
    assert seeded.op_cost(sm, sm.pc) == 2.0 * est


def test_measured_model_needs_cuda_unless_asked_for_the_cpu():
    from flexflow_tpu_torch.sim.cost_model import MeasuredCostModel

    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        MeasuredCostModel()


def test_virtual_machine_and_topology():
    from flexflow_tpu.machine import Topology as JaxTopology

    from flexflow_tpu_torch.machine import (NDR_BANDWIDTH,
                                            NVLINK4_BANDWIDTH,
                                            MachineModel, Topology)
    from flexflow_tpu_torch.models.alexnet import build_alexnet
    from flexflow_tpu_torch.strategy import ParallelConfig

    m = MachineModel.virtual(16)
    assert m.num_devices == 16 and m.device.type == "meta"
    assert m.topology.devices_per_ici_group == 16
    assert not m.distributed and m.global_factors()[-1] == ("_g3", 2)
    assert m.is_canonical(ParallelConfig((16,), tuple(range(16))))
    assert not m.is_canonical(ParallelConfig((8,), tuple(range(8))))
    assert len(build_alexnet(machine=m).layers) == 13
    cal = str(sp.repo_root() / "examples/strategies/dcn_calibration.json")
    assert Topology.from_calibration(cal, 4) == Topology(**vars(
        JaxTopology.from_calibration(cal, 4)))
    jt, tt = JaxTopology(4), Topology(4)
    for a, b in ((0, 0), (1, 3), (3, 4), (7, 12)):
        assert tt.bandwidth(a, b) == jt.bandwidth(a, b)
    h = Topology.hopper()
    assert (h.devices_per_ici_group, h.ici_bandwidth, h.dcn_bandwidth) == \
        (8, NVLINK4_BANDWIDTH, NDR_BANDWIDTH) == (8, 4.5e11, 5.0e10)
    assert h.bandwidth(0, 7) == 4.5e11 and h.bandwidth(7, 8) == 5.0e10
