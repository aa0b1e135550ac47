"""The CNN ops placed on device subsets over 8 gloo ranks, against the
JAX package's run of the same strategy on its 8-device virtual CPU mesh
and against the port's run in one process.

* VGG-16 under ``examples/strategies/vgg_2x4.json``: ``linear2`` on
  devices (6, 7) split over its output channels, ``linear3`` a one-point
  grid on device 4, the convolutions over batch, channels and columns.
  128x128 is the smallest input its splits allow (``pool5`` over h = 4),
  batch 8 (``conv1`` over n = 8), one momentum-SGD step and the eval
  step.  One step, not three: on the full 13-convolution stack the
  second step's leaves move 1-2 % of an update apart between the two
  packages on one device without a strategy as well (max-pool argmax
  flips at near-ties after step one's last-bit differences), while the
  port's 8 ranks equal its one process within 1e-8;
* tests/test_placement.py:375's placed BatchNorm: ``bn1`` on (4-7) with
  grid (1, 2, 1, 2), its statistics global over those ranks' h and n,
  scale, bias and running statistics on ranks 4-7 alone and equal to
  JAX's after 3 steps;
* tests/test_set_family.py:64 and :103 in one net: a SAME 3x3 conv with
  grid (2, 2, 1, 1) on the stride set (0, 2, 4, 6) and a 3x3/1 pad-1 max
  pool (2, 2, 1, 1) on the set (0, 3, 5, 6);
* ``apps.cnn alexnet -s <file> -ll:gpu 2`` with ``linear2`` and
  ``linear3`` on device 1 alone and the rest data parallel (the chip
  smoke's two-rank placed AlexNet), as the ranks of a torchrun world,
  against the app's run without a strategy.

Bars as in tests/test_torch_strategy_ranks.py; residency: each key and
each op's state on exactly the ranks its device list names.  The three
model cases share one spawn of 8 processes (``tests/torch_ranks.py``).
"""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

import torch_ranks as tr

torch.set_num_threads(2)

STRATEGIES = Path(__file__).resolve().parents[1] / "examples" / "strategies"


def _batches(steps, batch, size, channels, classes, seed):
    rng = np.random.RandomState(seed)
    return [(rng.randn(batch, size, size, channels).astype("float32"),
             rng.randint(0, classes, size=batch).astype("int32"))
            for _ in range(steps)]


CASES = {
    "vgg_2x4": ("vgg16", dict(batch_size=8, input_height=128,
                              input_width=128, num_classes=1000,
                              learning_rate=1e-3, momentum=0.9, seed=7),
                (STRATEGIES / "vgg_2x4.json").read_text(),
                tr.random_batches(1, 8, 128, 1000)),
    "placed_bn": ("placed_bn", dict(batch_size=16, input_height=16,
                                    input_width=16, num_classes=32,
                                    learning_rate=1e-3, momentum=0.9,
                                    seed=3),
                  json.dumps({"bn1": {"dims": [1, 2, 1, 2],
                                      "devices": [4, 5, 6, 7]}}),
                  _batches(3, 16, 16, 8, 32, 8)),
    "set_family": ("set_family", dict(batch_size=16, input_height=16,
                                      input_width=16, num_classes=64,
                                      learning_rate=1e-3, momentum=0.9,
                                      seed=9),
                   json.dumps({"conv1": {"dims": [2, 2, 1, 1],
                                         "devices": [0, 2, 4, 6]},
                               "pool1": {"dims": [2, 2, 1, 1],
                                         "devices": [0, 3, 5, 6]}}),
                   _batches(3, 16, 16, 8, 64, 1)),
}

#: ``{key: ranks}`` of the keys held on subsets; every other key on all 8
PLACED = {"vgg_2x4": {"linear2": (6, 7), "linear3": (4,)},
          "placed_bn": {"bn1": (4, 5, 6, 7)},
          "set_family": {"conv1": (0, 2, 4, 6)}}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("cnn")
    cases, want = [], {}
    for name, (layers, cfg, text, batches) in CASES.items():
        case, want[name] = tr.jax_case(tmp, layers, cfg, text, 8, batches,
                                       tag=name)
        cases.append(("train", case))
    res = tr.run_ranks(tr.run_cases, 8, cases, timeout=300)
    return {name: ([c for _, c in cases][i], want[name],
                   [r[i] for r in res])
            for i, name in enumerate(CASES)}


@pytest.mark.parametrize("name", list(CASES))
def test_placed_cnn_on_8_ranks_matches_jax_and_one_rank(runs, name):
    case, want, res = runs[name]
    losses = tr.check_case(case, want, res)
    assert np.all(np.isfinite(losses))
    keys = set(want[1])
    held = tr.holders(res)
    assert held == {key: PLACED[name].get(key, tuple(range(8)))
                    for key in keys}


def test_placed_batchnorm_state_lives_on_its_ranks(runs):
    _, (_, _, j_state), res = runs["placed_bn"]
    assert tr.holders(res, 2) == {"bn1": (4, 5, 6, 7)}
    for rank in (4, 5, 6, 7):
        box, mean = res[rank][2]["bn1"]["mean"]
        assert box == ((0, 16),)
        np.testing.assert_allclose(mean, j_state["bn1"]["mean"], rtol=1e-4,
                                   atol=1e-6)


def test_cnn_app_with_linears_on_one_rank_matches_no_strategy(tmp_path):
    from flexflow_tpu_torch.apps import cnn

    ops = [("conv1", 4), ("pool1", 4), ("conv2", 4), ("pool2", 4),
           ("conv3", 4), ("conv4", 4), ("conv5", 4), ("pool3", 4),
           ("flat", 2), ("linear1", 2), ("linear2", 2), ("linear3", 2),
           ("softmax", 1)]
    obj = {name: {"dims": [1] * (nd - 1) + [2], "devices": [0, 1]}
           for name, nd in ops}
    obj["linear2"] = obj["linear3"] = {"dims": [1, 1], "devices": [1]}
    path = tmp_path / "s.json"
    path.write_text(json.dumps(obj))
    argv = ["alexnet", "-b", "2", "-i", "3", "--height", "67", "--width",
            "67", "--lr", "0.001", "--device", "cpu"]
    base = cnn.main(argv, log=lambda *a: None)["loss"]
    got = tr.run_ranks(tr.app_main, 2, argv + ["-s", str(path), "-ll:gpu",
                                               "2"], timeout=120)
    assert got[1] is None
    np.testing.assert_allclose(got[0], base, rtol=tr.LOSS_RTOL,
                               atol=tr.LOSS_ATOL)
