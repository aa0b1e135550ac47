"""The port's placement without ranks: which grid point lives on which
device, the NMT strategies and the drivers' placement flags.

* ``placement_slot`` and the grid map (the device of each grid point)
  equal the JAX package's for the block family (aligned blocks, named in
  or out of order, one-point grids), the stride family, the set family
  (irregular lists, a stride-2 conv, a max pool) and the normalized
  lists (duplicates, a channel-split BatchNorm, an op without placed
  support): JAX's map is read off its placement meshes
  (``MachineModel.placement_mesh``) and ``set_group_assignment``;
  ``grid_index`` and ``set_group_assignment`` equal JAX's;
* a normalized list warns once, as JAX's ``MachineModel.sharding`` does;
* a move by box overlap copies each cell once, from the destination
  itself where it holds it;
* ``default_global_config`` and ``pipeline_stage_strategy`` equal JAX's
  on machines of 1, 2 and 8 devices, and ``RnnModel`` defaults to the
  first;
* ``apps.nmt`` takes ``--strategy`` and ``--pipeline-stages`` (one CPU
  process, against its run without them), and the VGG-16 build under
  ``vgg_2x4.json`` (``linear2`` on devices 6 and 7) plans on 8 ranks.

The runs on several ranks are in tests/test_torch_placement_nmt.py and
tests/test_torch_placement_cnn.py.
"""

import json
import logging
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from flexflow_tpu.config import FFConfig as JConfig
from flexflow_tpu.machine import MachineModel as JMachine
from flexflow_tpu.model import FFModel as JModel
from flexflow_tpu.nmt import rnn_model as j_rnn
from flexflow_tpu.parallel import placement as j_place
from flexflow_tpu.strategy import Strategy as JStrategy
from flexflow_tpu_torch.apps import nmt as t_nmt
from flexflow_tpu_torch.config import FFConfig
from flexflow_tpu_torch.machine import MachineModel
from flexflow_tpu_torch.model import FFModel
from flexflow_tpu_torch.nmt import rnn_model as t_rnn
from flexflow_tpu_torch.parallel import placement, regrid
from flexflow_tpu_torch.strategy import ParallelConfig, Strategy

torch.set_num_threads(2)

STRATEGIES = Path(__file__).resolve().parents[1] / "examples" / "strategies"

# (op, grid, devices): block, stride, set and normalized lists on 8
CASES = [
    ("fc1", (2, 1), (6, 7)), ("fc1", (2, 1), (7, 6)),
    ("fc1", (4, 1), (0, 2, 4, 6)), ("fc1", (4, 1), (1, 3, 5, 7)),
    ("fc1", (4, 1), (0, 3, 5, 6)), ("fc1", (1, 1), (6,)),
    ("fc1", (3, 1), (0, 3, 5)), ("fc1", (2, 1), (3, 3)),
    ("fc1", (4, 2), (7, 6, 5, 4, 3, 2, 1, 0)),
    ("conv1", (2, 2, 1, 1), (0, 2, 4, 6)),
    ("conv1", (2, 2, 1, 1), (0, 3, 5, 6)),
    ("conv2", (2, 2, 1, 1), (0, 3, 5, 6)),
    ("conv2", (1, 1, 2, 2), (4, 5, 6, 7)),
    ("pool1", (2, 2, 1, 1), (0, 3, 5, 6)),
    ("pool1", (1, 1, 1, 2), (2, 3)),
    ("bn1", (1, 2, 1, 2), (4, 5, 6, 7)),
    ("bn1", (1, 1, 2, 1), (4, 5)),
    ("cat", (1, 1, 1, 4), (1, 3, 5, 7)),
    ("flat", (1, 2), (2, 3)),
    ("softmax", (1,), (3,)),
]


def _net(ff, image):
    t = ff.conv2d("conv1", image, 16, 3, 3, 1, 1, 1, 1, relu=True)
    u = ff.conv2d("conv2", t, 8, 3, 3, 2, 2, 1, 1, relu=True)
    t = ff.pool2d("pool1", t, 3, 3, 2, 2, 1, 1)
    t = ff.batch_norm("bn1", t)
    t = ff.concat("cat", [t, u])
    t = ff.flat("flat", t)
    t = ff.linear("fc1", t, 48, relu=False)
    return ff.softmax("softmax", t)


def _models(name, dims, devices):
    text = json.dumps({name: {"dims": list(dims), "devices": list(devices)}})
    jcfg = JConfig(batch_size=16, input_height=16, input_width=16)
    jcfg.strategies = JStrategy.from_json(text)
    jm = JModel(jcfg, JMachine())
    _net(jm, jm.create_input((16, 16, 16, 8), name="image"))
    tcfg = FFConfig(batch_size=16, input_height=16, input_width=16)
    tcfg.strategies = Strategy.from_json(text)
    tm = FFModel(tcfg, MachineModel("cpu", world_size=8))
    _net(tm, tm.create_input((16, 16, 16, 8), name="image"))
    return ({op.name: op for op in jm.layers}[name],
            {op.name: op for op in tm.layers}[name], jm)


def _jax_points(jm, op, slot):
    """The device of each grid point (dim 0 fastest) as the JAX package
    places it: read off the placement mesh (block, stride) or the set
    assignment."""
    family, arg = slot
    dims, axes = op.pc.dims, op.AXIS_NAMES
    p = op.pc.num_parts
    if family == "set":
        grp = j_place.PlacementGroup([op], [0], [0], p, 1,
                                     device_rows=[tuple(arg)])
        assign = j_place.set_group_assignment(grp, axes)
        by_j = {j: dev for dev, (_, j, _) in assign.items()}
        return tuple(by_j[j] for j in range(p))
    mesh = jm.machine.placement_mesh(dims, axes,
                                     strided=family == "stride")
    names = list(mesh.axis_names)
    grid = np.vectorize(lambda d: d.id)(mesh.devices)
    out = []
    for j in range(p):
        idx = j_place.grid_index(j, dims, axes)
        at = tuple(arg if n == "_pg" else idx[n] for n in names)
        out.append(int(grid[at]))
    return tuple(out)


@pytest.mark.parametrize("name,dims,devices", CASES,
                         ids=[f"{n}-{d}" for n, _, d in CASES])
def test_slot_and_grid_map_equal_jax(name, dims, devices):
    jop, top, jm = _models(name, dims, devices)
    want = j_place.placement_slot(jop, 8)
    got = placement.placement_slot(top, 8)
    assert got == want
    positions = placement.point_positions(top, 8)
    if want is None:
        assert positions is None
        return
    assert positions == _jax_points(jm, jop, want)
    # a point per listed device, each on a device the list names
    assert sorted(positions) == sorted(devices)


def test_every_family_occurs():
    fams = set()
    for name, dims, devices in CASES:
        slot = placement.placement_slot(_models(name, dims, devices)[1], 8)
        fams.add(slot[0] if slot else None)
    assert fams == {"block", "stride", "set", None}


def test_grid_index_and_set_assignment_equal_jax():
    dims, axes = (2, 3, 1, 2), ("w", "h", "c", "n")
    for j in range(12):
        assert placement.grid_index(j, dims, axes) == \
            j_place.grid_index(j, dims, axes)
    rows = [(0, 3, 5, 6), (1, 2, 4, 7)]
    jop, _, _ = _models("fc1", (4, 1), rows[0])
    grp = j_place.PlacementGroup([jop, jop], [0, 1], [0, 0], 4, 2,
                                 device_rows=rows)
    assert placement.set_group_assignment(rows, (4, 1), ("c", "n")) == \
        j_place.set_group_assignment(grp, ("c", "n"))


def test_normalized_list_warns_once(caplog):
    _, top, _ = _models("fc1", (2, 1), (5, 5))
    m = MachineModel("cpu", world_size=8)
    with caplog.at_level(logging.WARNING, logger="flexflow_tpu_torch"):
        assert placement.placed(top, m) is None
        assert placement.placed(top, m) is None
    msgs = [r.message for r in caplog.records if "normalized" in r.message]
    assert len(msgs) == 1 and "(5, 5)" in msgs[0]
    # a placed list does not warn
    _, top, _ = _models("fc1", (2, 1), (6, 7))
    with caplog.at_level(logging.WARNING):
        caplog.clear()
        assert placement.placed(top, m) == (6, 7)
    assert not caplog.records


def test_box_move_reads_each_cell_once():
    m = MachineModel("cpu", world_size=4, rank=2)
    rows = lambda lo, hi: ((lo, hi), (0, 6))   # noqa: E731
    # held: rows 0-4 at position 0, 4-8 at position 1, all at position 3
    src = (rows(0, 4), rows(4, 8), None, rows(0, 8))
    # wanted: rows 2-6 at positions 2 and 3, none elsewhere
    dst = (None, None, rows(2, 6), rows(2, 6))
    edge = regrid.plan_box_move(m, src, dst, torch.float32)
    plan = edge.move
    # position 3 reads its own rows; position 2 reads two cells from the
    # first holder of each, positions 0 and 1
    assert plan.group.positions == (0, 1, 2)
    assert (plan.send, plan.out, edge.local) == (None, (4, 6), None)
    assert [(m_, s, d) for m_, s, d in plan.cells] == [
        (0, (slice(2, 4), slice(0, 6)), (slice(0, 2), slice(0, 6))),
        (1, (slice(0, 2), slice(0, 6)), (slice(2, 4), slice(0, 6)))]
    edge = regrid.plan_box_move(
        MachineModel("cpu", world_size=4, rank=3), src, dst, torch.float32)
    assert edge.move is None and edge.local == (slice(2, 6), slice(0, 6))
    # every destination holds its box: no move at all
    assert regrid.plan_box_move(m, src, (None, rows(4, 8), None, None),
                                torch.float32) is None


@pytest.mark.parametrize("n", [1, 2, 8])
def test_nmt_strategies_equal_jax(n):
    jcfg = j_rnn.RnnConfig(batch_size=8, seq_length=8, hidden_size=16,
                           embed_size=16, vocab_size=64,
                           lstm_per_node_length=4)
    tcfg = t_rnn.RnnConfig(batch_size=8, seq_length=8, hidden_size=16,
                           embed_size=16, vocab_size=64,
                           lstm_per_node_length=4)
    jm, tm = JMachine(jax.devices()[:n]), MachineModel("cpu", world_size=n)

    def same(j, t):
        assert {k: (pc.dims, pc.devices) for k, pc in j.items()} == \
            {k: (pc.dims, pc.devices) for k, pc in t.items()}

    same(j_rnn.default_global_config(jcfg, jm),
         t_rnn.default_global_config(tcfg, tm))
    for stages in (1, 2):
        if n % stages == 0:
            same(j_rnn.pipeline_stage_strategy(jcfg, jm, stages),
                 t_rnn.pipeline_stage_strategy(tcfg, tm, stages))
    with pytest.raises(ValueError, match="do not divide"):
        t_rnn.pipeline_stage_strategy(tcfg, tm, 3)
    model = t_rnn.RnnModel(tcfg, tm)
    same(t_rnn.default_global_config(tcfg, tm), model.config.strategies)
    assert model.config.strategies["embed2"] == ParallelConfig(
        (1,), (min(1, n - 1),))


def test_nmt_app_takes_strategy_and_stages(tmp_path):
    argv = ["-b", "4", "-l", "2", "-s", "6", "-h", "16", "-e", "12",
            "--vocab", "64", "--chunk", "3", "-i", "3", "--device", "cpu"]
    quiet = dict(log=lambda *a: None)
    base = t_nmt.main(argv, **quiet)["loss"]
    staged = t_nmt.main(argv + ["--pipeline-stages", "1"], **quiet)["loss"]
    path = tmp_path / "s.json"
    cfg = t_nmt.parse_args(argv)[0]
    t_rnn.default_global_config(cfg, MachineModel("cpu")).save(str(path))
    filed = t_nmt.main(argv + ["--strategy", str(path)], **quiet)["loss"]
    np.testing.assert_allclose(staged, base, rtol=1e-6)
    np.testing.assert_allclose(filed, base, rtol=1e-6)
    assert t_nmt.parse_args(argv + ["--strategy", "f.json",
                                    "--pipeline-stages", "2"])[3] == \
        {"strategy": "f.json", "stages": 2}


def test_vgg_2x4_plans_its_placed_linears():
    from flexflow_tpu_torch.models.vgg import build_vgg16

    cfg = FFConfig(batch_size=64, input_height=224, input_width=224)
    cfg.strategies = Strategy.load(str(STRATEGIES / "vgg_2x4.json"))
    ff = build_vgg16(cfg, MachineModel("cpu", world_size=8))
    ff._setup_sharded()
    assert ff._grids["linear2"].positions == (6, 7)
    assert ff._grids["linear3"].positions == (4,)
    assert ff._grids["linear1"].positions is None
    full = {k: {leaf: torch.empty(s, device="meta")
                for leaf, s in v.items()}
            for k, v in ff.param_shapes().items()}
    held = [sorted(ff.shard_params(full, p)) for p in range(8)]
    assert ["linear2" in h for h in held] == [False] * 6 + [True] * 2
    assert ["linear3" in h for h in held] == [False] * 4 + [True] \
        + [False] * 3
