"""Grids that do not factor over the world's prime axes in the PyTorch
port: a (2, 3) grid on 6 ranks (the machine factors as 2 x 3, and the
grid's first dim, 2, cannot take the fast factor 3).  JAX runs such an
op on a mesh of its own (``flexflow_tpu/machine.py:240`` ``mesh_for``:
grid point j on ``pc.devices[j]``, dim 0 fastest); the port runs it on
the same ranks as a placed op (``placement.unfactored_positions``).
Trained 2 steps on 6 gloo ranks, the tiny CNN with conv1, conv2 and
linear1 on such grids equals JAX's 6-device run and the port's one
process (losses 2e-4, final leaves 1e-4 of their scale).
"""

import json

import torch

import torch_ranks as tr

torch.set_num_threads(2)

GRIDS = {"conv1": [1, 1, 2, 3], "conv2": [1, 1, 2, 3], "linear1": [2, 3]}


def test_2x3_grids_on_6_ranks_match_jax_and_one_rank(tmp_path):
    cfg = dict(batch_size=12, input_height=8, input_width=8,
               learning_rate=0.01, weight_decay=1e-4, momentum=0.9)
    losses = tr.check_strategy(tmp_path, "tiny", cfg,
                               tr.strategy_json(GRIDS, 6), 6,
                               tr.random_batches(2, 12, 8, 10),
                               timeout=150.0)
    assert len(losses) == 2


def test_unfactored_grid_holds_mesh_for_blocks():
    """Grid point j's blocks on rank ``devices[j]``, dim 0 fastest,
    for a device list in another order."""
    from flexflow_tpu_torch.machine import MachineModel

    devices = [5, 0, 3, 1, 4, 2]
    ff = tr.build(MachineModel("cpu", world_size=6), "tiny",
                  dict(batch_size=12, input_height=8, input_width=8),
                  json.dumps({"linear1": {"dims": [2, 3],
                                          "devices": devices}}))
    full, _ = ff._init_full(0)
    kernel = full["linear1"]["kernel"]
    # the one permutation the strategy names relabels the machine:
    # position j is played by rank devices[j]
    assert ff.machine.view == tuple(devices)
    for j in range(6):
        c = j % 2
        got = ff.shard_params(full, j)["linear1"]["kernel"]
        assert torch.equal(got, kernel[:, c * 16:(c + 1) * 16])
