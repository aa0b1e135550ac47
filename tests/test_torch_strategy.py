"""The port's strategy machinery without ranks: the machine's grid maps
and layouts, the regrid planner, the checks and the flags.

* The grid-point -> rank map and each op's layouts on the global factored
  mesh equal the JAX package's (``MachineModel.mesh_for``,
  ``global_entries``); a block of an unevenly split dim is ceil-sized, as
  XLA pads the short shard, and the blocks tile the tensor.
* The regrid plans of ``examples/strategies/alexnet_2x4.json`` and
  ``vgg_2x4.json`` equal the JAX planner's hop chains edge by edge, the
  inputs of their placed linears included; the edges out of a placed op
  are moves by box overlap instead.
* A device subset is placed, its blocks only on its ranks; the MoE op
  has its (e, c, n) grid (3c-ii) and the LM driver takes its pipeline
  flags and a strategy file's ``__pipeline__`` block (3d); the
  refusals that remain name their ROADMAP items: a grid that does not
  factor over the world and ``--ckpt-dir`` over several ranks (3e);
  ``-ll:gpu`` other than the world size.
* ``-s``/``--strategy`` and ``-ll:gpu`` parse; a strategy that names one
  permutation of the machine relabels it as the JAX model does.

These build machines of several ranks without a process group (they
plan, they run nothing).  The runs on several ranks are in
tests/test_torch_strategy_ranks.py and tests/test_torch_strategy_cnn.py.
"""

import json
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from flexflow_tpu.config import FFConfig as JConfig
from flexflow_tpu.machine import MachineModel as JMachine
from flexflow_tpu.models.alexnet import build_alexnet as j_alexnet
from flexflow_tpu.models.vgg import build_vgg16 as j_vgg
from flexflow_tpu.strategy import ParallelConfig as JPC
from flexflow_tpu.strategy import Strategy as JStrategy
from flexflow_tpu_torch import distributed
from flexflow_tpu_torch.apps import cnn as t_cnn
from flexflow_tpu_torch.config import FFConfig
from flexflow_tpu_torch.machine import MachineModel
from flexflow_tpu_torch.models.alexnet import build_alexnet
from flexflow_tpu_torch.models.transformer import (TransformerConfig,
                                                   TransformerLM)
from flexflow_tpu_torch.models.vgg import build_vgg16
from flexflow_tpu_torch.parallel import regrid
from flexflow_tpu_torch.strategy import ParallelConfig, Strategy

torch.set_num_threads(2)

STRATEGIES = Path(__file__).resolve().parents[1] / "examples" / "strategies"

# (op axis names, grid dims) over 8 ranks
GRIDS = [(("w", "h", "c", "n"), (2, 2, 1, 2)), (("w", "h", "c", "n"),
                                                (1, 1, 4, 2)),
         (("w", "h", "c", "n"), (4, 1, 1, 2)), (("w", "h", "c", "n"),
                                                (1, 1, 1, 8)),
         (("c", "n"), (4, 2)), (("c", "n"), (2, 4)), (("c", "n"), (8, 1)),
         (("n",), (8,))]


def _port_machine(n=8):
    return MachineModel("cpu", world_size=n)


@pytest.mark.parametrize("axes,dims", GRIDS)
def test_grid_map_and_layouts_equal_jax(machine8, axes, dims):
    pc = ParallelConfig(dims, tuple(range(8)))
    jpc = JPC(dims, tuple(range(8)))
    m = _port_machine()
    assert m.global_assign(pc, axes) == machine8.global_assign(jpc, axes)
    mesh = machine8.mesh_for(jpc, axes)
    ids = {d.id: i for i, d in enumerate(jax.devices())}
    spec = tuple(axes)
    shape = tuple(4 * d for d in dims)
    entries = m.global_entries(pc, axes, spec, rank=len(axes))
    assert entries == machine8.global_entries(jpc, axes, spec,
                                              rank=len(axes))
    for pos in range(8):
        # mesh_for's map: the grid point at this position
        idx = m.grid_index(pc, pos)
        coords = {a: i for a, i in zip(axes, idx)}
        arr = mesh.devices
        for a in mesh.axis_names:
            arr = arr[coords[a]]
        assert ids[arr.id] == pos
        # the layout's block at this position is that grid point's
        box = m.block(entries, shape, pos)
        for d, (lo, hi) in enumerate(box):
            n = shape[d] // dims[d]
            assert (lo, hi) == (idx[d] * n, (idx[d] + 1) * n)


@pytest.mark.parametrize("shape,entries", [
    ((8, 27, 16), (("_g0",), ("_g1", "_g2"), ())),     # 27 over 4
    ((8, 35, 17), ((), ("_g0",), ("_g1", "_g2"))),     # 35 over 2, 17 / 4
    ((16, 13), (("_g2",), ("_g0", "_g1"))),
])
def test_uneven_blocks_are_ceil_sized_and_tile(shape, entries):
    # XLA pads an unevenly split dim to ceil(n / P) a shard
    # (flexflow_tpu/ops/base.py:252); the blocks of every position tile
    # the tensor exactly once
    m = _port_machine()
    sizes = m.axis_sizes()
    seen = np.zeros(shape, np.int32)
    for pos in range(8):
        box = m.block(entries, shape, pos)
        c = m.coords(pos)
        for (lo, hi), n, axes in zip(box, shape, entries):
            parts = int(np.prod([sizes[a] for a in axes]))
            idx = 0
            for a in axes:
                idx = idx * sizes[a] + c[a]
            b = -(-n // parts)
            assert (lo, hi) == (min(idx * b, n), min(idx * b + b, n))
        seen[tuple(slice(lo, hi) for lo, hi in box)] += 1
    replicas = 8 // int(np.prod([sizes[a] for t in entries for a in t]))
    assert (seen == replicas).all()


def test_uneven_spatial_rule_equals_jax():
    from flexflow_tpu.strategy import uneven_spatial_ok as j_ok
    from flexflow_tpu_torch.strategy import uneven_spatial_ok

    assert all(uneven_spatial_ok(n, p) == j_ok(n, p)
               for n in range(1, 40) for p in range(1, 9))


def _chain_entries(ep, rank):
    out = []
    for sh in ep.shardings:
        ent = [() if e is None else (tuple(e) if isinstance(e, tuple)
                                     else (e,)) for e in sh.spec]
        out.append(tuple(ent + [()] * (rank - len(ent))))
    return out


@pytest.mark.parametrize("name,j_build,t_build", [
    ("alexnet_2x4", j_alexnet, build_alexnet),
    ("vgg_2x4", j_vgg, build_vgg16),
])
def test_regrid_plans_equal_jax_edge_by_edge(machine8, name, j_build,
                                             t_build):
    text = (STRATEGIES / f"{name}.json").read_text()
    jcfg = JConfig(batch_size=64)
    jcfg.strategies = JStrategy.from_json(text)
    jm = j_build(jcfg, machine8)
    fusion, schedule = jm._plan(True)
    jplan = jm._regrid_plan_for(fusion, schedule)
    tcfg = FFConfig(batch_size=64)
    tcfg.strategies = Strategy.from_json(text)
    tm = t_build(tcfg, _port_machine())
    tplan = regrid.build_regrid_plan(tm)
    ops = {op.name: op for op in tm.layers}
    assert len(jplan.edges) == len(ops)
    hops = moves = 0
    for key, ep in jplan.edges.items():
        t = ops[key[0]].inputs[key[1]]
        if isinstance(tplan.layouts[t.tid], regrid.Placed):
            # a placed producer's value lives on its ranks alone: the port
            # moves it by box overlap where JAX reshards its replicas
            assert tplan.edges[key].box is not None, key
            moves += 1
            continue
        want = _chain_entries(ep, t.ndim)
        assert tplan.edges[key].chain == want, key
        hops += len(want)
    assert hops > 10
    # vgg_2x4 places linear2 on (6, 7) and linear3 on (4,), alexnet_2x4
    # linear3 on (6,): the edges out of them are moves
    assert moves == {"alexnet_2x4": 1, "vgg_2x4": 2}[name]
    # the port plans one more edge: the loss op's labels
    assert set(tplan.edges) - set(jplan.edges) == {("softmax", "labels")}


def test_plan_hops_equal_jax_on_moves_and_inversions(machine8):
    from flexflow_tpu.parallel.regrid import plan_hops as j_plan_hops

    m = _port_machine()
    cases = [
        ((("_g0", "_g1"), ("_g2",)), (("_g2",), ("_g0", "_g1"))),
        ((("_g0", "_g1", "_g2"), ()), ((), ("_g2", "_g1", "_g0"))),
        ((("_g2",), ("_g1",), ("_g0",)), (("_g0",), ("_g1",), ("_g2",))),
        ((("_g1",), ()), (("_g0",), ("_g1",))),
    ]
    for src, dst in cases:
        shape = (32,) * len(src)
        want = j_plan_hops(machine8, src, dst, shape)[0]
        assert regrid.plan_hops(m, src, dst, shape)[0] == want, (src, dst)


def test_hops_pick_slice_alltoall_or_gather():
    m = _port_machine()
    # a split: a local slice of every block, no group
    hop = regrid.make_hop(m, (("_g0",), ()), (("_g0",), ("_g1",)), (8, 8))
    assert hop.kind == "slice"
    x = torch.arange(32.0).reshape(4, 8)
    # the block a kernel's wrapper gets is contiguous
    assert hop(x).is_contiguous() and torch.equal(hop(x), x[:, :4])
    # an even move of the minor axis: one all-to-all over it
    hop = regrid.make_hop(m, (("_g0", "_g1"), ()), (("_g0",), ("_g1",)),
                          (8, 8))
    assert (hop.kind, hop.axes) == ("alltoall", ("_g1",))
    # a drop: a gather over the dropped axis
    hop = regrid.make_hop(m, (("_g0", "_g1"), ()), (("_g0",), ()), (8, 8))
    assert (hop.kind, hop.axes) == ("gather", ("_g1",))
    # an uneven move (27 over 4) gathers instead of the all-to-all
    hop = regrid.make_hop(m, (("_g0", "_g1"), ()), (("_g0",), ("_g1",)),
                          (8, 27))
    assert hop.kind == "gather"
    # a backend without an all-to-all (gloo on CUDA tensors) gathers too
    m = MachineModel("cpu", world_size=8, all_to_all=False)
    hop = regrid.make_hop(m, (("_g0", "_g1"), ()), (("_g0",), ("_g1",)),
                          (8, 8))
    assert (hop.kind, hop.axes) == ("gather", ("_g1",))


def test_uneven_partitioning_is_checked():
    cfg = FFConfig(batch_size=8, input_height=64, input_width=64)
    cfg.strategies = Strategy.from_json(
        (STRATEGIES / "alexnet_2x4.json").read_text())
    ff = build_alexnet(cfg, _port_machine())
    # at 64x64 pool3's output is one column, which w = 2 cannot split
    with pytest.raises(ValueError, match="pool3"):
        ff.init()


def _tiny_cnn(machine, strategy=None, batch=8, **kw):
    from flexflow_tpu_torch.model import FFModel

    cfg = FFConfig(batch_size=batch, input_height=16, input_width=16,
                   num_classes=10, **kw)
    if strategy:
        cfg.strategies = strategy
    ff = FFModel(cfg, machine)
    img = ff.create_input((batch, 16, 16, 3), name="image")
    t = ff.conv2d("conv1", img, 8, 3, 3, 1, 1, 1, 1, relu=True)
    t = ff.flat("flat", t)
    t = ff.linear("linear1", t, 10, relu=False)
    ff.softmax("softmax", t)
    return ff


def test_refusals_name_their_roadmap_items(tmp_path):
    # a device subset of several points runs placed (3b, done): only its
    # ranks hold the op's blocks (the run: tests/test_torch_placement*.py)
    sub = Strategy()
    sub["linear1"] = ParallelConfig((2, 1), (4, 5))
    ff = _tiny_cnn(_port_machine(), sub)
    full, _ = ff._init_full(0)
    assert "linear1" not in ff.shard_params(full, 0)
    kernel = ff.shard_params(full, 5)["linear1"]["kernel"]
    assert torch.equal(kernel, full["linear1"]["kernel"][:, 5:])
    # a one-point grid on one device runs on that rank alone
    one = Strategy()
    one["linear1"] = ParallelConfig((1, 1), (6,))
    ff = _tiny_cnn(_port_machine(), one)
    full, _ = ff._init_full(0)
    assert [p for p in range(8) if "linear1" in ff.shard_params(full, p)] \
        == [6]
    # the MoE op over several ranks (3c-ii, done): each rank holds its
    # expert and channel blocks, the router whole
    lm = TransformerLM(TransformerConfig(
        batch_size=2, seq_length=8, num_layers=1, d_model=16, num_heads=2,
        d_ff=32, vocab_size=32, num_experts=2), machine=_port_machine(2),
        strategies=Strategy.from_json(json.dumps(
            {"blk0_moe": {"dims": [2, 1, 1], "devices": [0, 1]}})))
    full, _ = lm._init_full(0)
    for pos in (0, 1):
        moe = lm.shard_params(full, pos)["blk0_moe"]
        assert torch.equal(moe["w1"], full["blk0_moe"]["w1"][pos:pos + 1])
        assert torch.equal(moe["wg"], full["blk0_moe"]["wg"])
    # the LM driver's pipelines (3d, done): its flags parse and a
    # strategy file's __pipeline__ block loads
    from flexflow_tpu_torch.apps import lm as t_lm

    block = Strategy.load(str(STRATEGIES / "transformer_2x4.json"))
    assert block.pipeline == {"stages": 2, "microbatches": 8, "tp": 1}
    for flag, field in (("--pipeline-stages", "pipeline_stages"),
                        ("--microbatches", "microbatches"),
                        ("--pipeline-tp", "pipeline_tp")):
        assert getattr(t_lm.parse_args([flag, "2"])[0], field) == 2
    # a grid that does not factor over the world's prime axes (3e,
    # done): grid point j runs on devices[j], dim 0 fastest (mesh_for;
    # the run: tests/test_torch_unfactored_grid.py)
    odd = Strategy()
    odd["linear1"] = ParallelConfig((2, 3), tuple(range(6)))
    ff = _tiny_cnn(_port_machine(6), odd, batch=12)
    full, _ = ff._init_full(0)
    for j in range(6):
        c = j % 2
        assert torch.equal(ff.shard_params(full, j)["linear1"]["kernel"],
                           full["linear1"]["kernel"][:, c * 5:(c + 1) * 5])
    # --ckpt-dir over several ranks (3e, done): a restore keeps each
    # optimizer leaf's block as its param's (the run:
    # tests/test_torch_ckpt_ranks.py)
    split = Strategy()
    split["linear1"] = ParallelConfig((2, 1), (0, 1))
    ff = _tiny_cnn(_port_machine(2), split, ckpt_dir=str(tmp_path))
    full, _ = ff._init_full(0)
    opt = ff.init_opt_state(full)
    for pos in (0, 1):
        mine = ff._shard_opt(opt, pos)
        assert {k: {leaf: v.shape for leaf, v in sub.items()}
                for k, sub in mine.items()} == \
            {k: {leaf: v.shape for leaf, v in sub.items()}
             for k, sub in ff.shard_params(full, pos).items()}
        assert mine["linear1"]["kernel"].shape == (16 * 16 * 8, 5)
    # -ll:gpu other than the world size
    _, cfg, _, _ = t_cnn.parse(["alexnet", "-ll:gpu", "2", "--device",
                                "cpu"])
    with pytest.raises(ValueError, match="-ll:gpu 2 but the world has 1"):
        t_cnn.build("alexnet", cfg, t_cnn.machine_for("cpu"))
    with pytest.raises(ValueError, match="-ll:gpu 2 but the world has 4"):
        build_alexnet(cfg, _port_machine(4))
    # release() tears down only a group initialize() brought up (none
    # here); elastic training waits for item 5
    assert distributed.release() is False
    with pytest.raises(NotImplementedError, match="item 5"):
        distributed.elastic_rejoin("x")
    with pytest.raises(NotImplementedError, match="item 5"):
        regrid.plan_state_migration(None, None, {})


def test_strategy_and_gpu_flags_parse(tmp_path):
    path = STRATEGIES / "alexnet_2x4.json"
    for flag in ("-s", "--strategy"):
        _, cfg, _, _ = t_cnn.parse(["alexnet", flag, str(path), "-ll:gpu",
                                    "8"])
        assert cfg.strategy_file == str(path)
        assert cfg.workers_per_node == 8
        assert cfg.strategies["conv2"] == ParallelConfig((4, 1, 1, 2),
                                                         tuple(range(8)))
    # the proto2 form of the same file loads alike
    proto = tmp_path / "s.pb"
    Strategy.load(str(path)).save(str(proto))
    _, cfg, _, _ = t_cnn.parse(["alexnet", "-s", str(proto)])
    assert dict(cfg.strategies) == dict(Strategy.load(str(path)))
    # without torchrun the world is one rank; -ll:gpu 1 agrees with it
    _, cfg, _, _ = t_cnn.parse(["alexnet", "-ll:gpu", "1"])
    m = t_cnn.machine_for("cpu")
    assert (m.num_devices, m.distributed) == (1, False)
    assert t_cnn.build("alexnet", cfg, m).machine is m


def test_one_permutation_relabels_the_machine(machine8):
    perm = (3, 2, 1, 0, 7, 6, 5, 4)
    text = json.dumps({
        "conv1": {"dims": [1, 1, 1, 8], "devices": list(perm)},
        "linear1": {"dims": [2, 4], "devices": list(perm)},
        "flat": {"dims": [1, 8], "devices": list(range(8))},
        "softmax": {"dims": [1], "devices": [5]}})
    jcfg = JConfig(batch_size=8, input_height=16, input_width=16)
    jcfg.strategies = JStrategy.from_json(text)
    from flexflow_tpu.model import FFModel as JModel

    jm = JModel(jcfg, JMachine(jax.devices()))
    ids = {d.id: i for i, d in enumerate(jax.devices())}
    given = Strategy.from_json(text)
    tm = _tiny_cnn(_port_machine(), given)
    assert tm.machine.view == tuple(ids[d.id] for d in jm.machine.devices)
    for name, pc in jm.config.strategies.items():
        assert tm.config.strategies[name] == ParallelConfig(pc.dims,
                                                            pc.devices)
    # the caller's strategy is not rewritten
    assert given["conv1"].devices == perm


def test_batch_blocks_and_param_blocks():
    ff = _tiny_cnn(_port_machine(4), Strategy({
        "conv1": ParallelConfig((1, 1, 4, 1), (0, 1, 2, 3)),
        "linear1": ParallelConfig((2, 2), (0, 1, 2, 3))}))
    m = ff.machine
    assert [m.block(((("_g0", "_g1")),), (8,), p)[0] for p in range(4)] \
        == [(0, 2), (2, 4), (4, 6), (6, 8)]
    assert m.batch_block(8) == (0, 2)
    boxes = ff.param_boxes()
    assert boxes["conv1"]["kernel"] == ((0, 3), (0, 3), (0, 3), (0, 2))
    assert boxes["linear1"]["kernel"] == ((0, 2048), (0, 5))
    full, _ = ff._init_full(0)
    p = ff.shard_params(full, position=3)
    assert torch.equal(p["conv1"]["kernel"], full["conv1"]["kernel"][
        ..., 6:8])
    assert torch.equal(p["linear1"]["bias"], full["linear1"]["bias"][5:])
