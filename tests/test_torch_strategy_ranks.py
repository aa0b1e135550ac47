"""The port on 8 gloo ranks against the JAX package's run of the same
strategy on its 8-device virtual CPU mesh, and against the port's own
run in one process.

* tests/test_model.py's tiny net under its hybrid strategy (conv1
  (2, 2, 1, 2): h, w and batch; conv2 (1, 1, 4, 2): channels and batch;
  linear1 (4, 2), linear2 (2, 4)), 4 momentum-SGD steps;
* the tiny net on one rank in a process group (the path ``torchrun
  --nproc-per-node 1`` takes: every layout whole, the gradient and loss
  all-reduces over a world of one);
* AlexNet under ``examples/strategies/alexnet_2x4.json`` (conv2 over w =
  4, conv5 and pool3 over w = 2, lienar1 and linear2 over channels,
  linear3 a one-point grid, replicated) at 111x111, batch 8, 3 steps.
  111 is the smallest input whose pool3 output the strategy's w = 2 can
  split; conv2's 13 columns split 4, 4, 4, 1, an uneven split.

Both start from the JAX ``init()`` tree, each rank keeping its blocks.
Losses within rtol 2e-4 / atol 2e-5, every final leaf within 1e-4 of the
largest magnitude among its op's leaves, and the ranks that hold one
block hold the same bits.  The ranks are spawned processes
(``tests/torch_ranks.py``), killed if they outlast the test's time
limit.
"""

import json
from pathlib import Path

import torch

import torch_ranks as tr

torch.set_num_threads(2)

STRATEGIES = Path(__file__).resolve().parents[1] / "examples" / "strategies"

HYBRID = {"conv1": (2, 2, 1, 2), "conv2": (1, 1, 4, 2),
          "linear1": (4, 2), "linear2": (2, 4)}


def test_tiny_hybrid_on_8_ranks_matches_jax_and_one_rank(tmp_path):
    cfg = dict(batch_size=8, input_height=16, input_width=16,
               num_classes=10, learning_rate=0.01, momentum=0.9, seed=7)
    losses = tr.check_strategy(tmp_path, "tiny", cfg,
                               tr.strategy_json(HYBRID, 8), 8,
                               tr.random_batches(4, 8, 16, 10))
    assert losses[-1] < losses[0]


def test_tiny_on_a_world_of_one_matches_jax_and_one_process(tmp_path):
    cfg = dict(batch_size=8, input_height=16, input_width=16,
               num_classes=10, learning_rate=0.01, momentum=0.9, seed=7)
    grids = {"conv1": (1, 1, 1, 1), "linear1": (1, 1)}
    tr.check_strategy(tmp_path, "tiny", cfg, tr.strategy_json(grids, 1), 1,
                      tr.random_batches(3, 8, 16, 10))


def test_alexnet_2x4_on_8_ranks_matches_jax_and_one_rank(tmp_path):
    text = (STRATEGIES / "alexnet_2x4.json").read_text()
    assert json.loads(text)["linear3"] == {"devices": [6], "dims": [1, 1]}
    cfg = dict(batch_size=8, input_height=111, input_width=111,
               num_classes=1000, learning_rate=1e-3, momentum=0.9, seed=7)
    tr.check_strategy(tmp_path, "alexnet", cfg, text, 8,
                      tr.random_batches(3, 8, 111, 1000), timeout=240)
