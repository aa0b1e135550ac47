"""The port's BatchNorm, Concat, Add and pools on strategy grids: two
small stacks on 4 gloo ranks against the JAX package's run of the same
strategy on 4 devices of its virtual CPU mesh and against the port's
run in one process, and the CNN app on 2 and 4 ranks.

* VGG-style (``torch_ranks.vgg_style``: conv, BN, a 2x2/2 max pool, two
  convolutions concatenated, BN, a pad-1 3x3/2 max pool, two linears) at
  18x18: conv1 over h = 4 (18 rows: 5, 5, 5, 3, uneven), bn1 over c and
  n, pool1 over w (9 columns: 5, 4), conv2a over c = 4, the concat over
  c and n, bn2 over h and w, pool2 over h, the linears over c and n;
* ResNet-style (``torch_ranks.resnet_style``: a residual block with BN
  and Add, a 3x3/1 pad-1 average pool, a stride-2 conv, the global
  average pool) at 16x16, every op on its own grid: h and w splits of
  the convolutions and the in-block avg pool (whose border windows
  average their valid positions), c splits of BN, Add and the global
  pool;
* ``apps.cnn alexnet -s <file> -ll:gpu N`` as the ranks of a torchrun
  world, its losses against the app's run without a strategy: two
  ranks with chip_smoke.py's two-card strategy (conv1 and pool1 over h,
  their halos exchanged, conv2 and lienar1 over channels, the rest over
  the batch), and four with its four-card hybrid (conv2 and pool2
  over channels and batch, conv3-conv5 over w and batch, the linears
  over channels).

Bars as in tests/test_torch_strategy_ranks.py; the running statistics
after the last step against JAX's too.  The VGG-style run moves axes by
all-gather and slice, as over a backend without an all-to-all (gloo on
CUDA tensors); the others by all-to-all.
"""

import json

import numpy as np
import pytest
import torch

import torch_ranks as tr

torch.set_num_threads(2)

VGG = {"conv1": (1, 4, 1, 1), "bn1": (1, 1, 2, 2), "pool1": (2, 1, 1, 2),
       "conv2a": (1, 1, 4, 1), "conv2b": (1, 1, 1, 4), "cat": (1, 1, 2, 2),
       "bn2": (2, 2, 1, 1), "pool2": (1, 2, 1, 2), "flat": (1, 4),
       "linear1": (2, 2), "linear2": (2, 2), "softmax": (4,)}
RESNET = {"conv1": (2, 2, 1, 1), "bn1": (1, 1, 2, 2),
          "res_conv1": (1, 1, 4, 1), "res_bn1": (1, 1, 1, 4),
          "res_conv2": (1, 2, 1, 2), "res_bn2": (2, 1, 2, 1),
          "res_add": (1, 1, 2, 2), "pool1": (2, 2, 1, 1),
          "conv2": (1, 1, 2, 2), "gpool": (1, 1, 2, 2), "flat": (1, 4),
          "linear1": (2, 2), "softmax": (4,)}


def _cfg(size):
    return dict(batch_size=8, input_height=size, input_width=size,
                num_classes=10, learning_rate=0.01, momentum=0.9, seed=7)


def test_vgg_style_on_4_ranks_matches_jax_and_one_rank(tmp_path):
    # its moves as all-gathers, as on a backend without an all-to-all
    tr.check_strategy(tmp_path, "vgg_style", _cfg(18),
                      tr.strategy_json(VGG, 4), 4,
                      tr.random_batches(3, 8, 18, 10), all_to_all=False)


def test_resnet_style_on_4_ranks_matches_jax_and_one_rank(tmp_path):
    tr.check_strategy(tmp_path, "resnet_style", _cfg(16),
                      tr.strategy_json(RESNET, 4), 4,
                      tr.random_batches(3, 8, 16, 10))


#: ``apps.cnn alexnet`` strategies: (ranks, input size, grids beyond the
#: batch split): chip_smoke.py's two- and four-card ones
APP_RUNS = [
    (2, 67, {"conv1": (1, 2, 1, 1), "pool1": (1, 2, 1, 1),
             "conv2": (1, 1, 2, 1), "lienar1": (2, 1)}),
    (4, 99, {"conv2": (1, 1, 2, 2), "pool2": (1, 1, 2, 2),
             "conv3": (2, 1, 1, 2), "conv4": (2, 1, 1, 2),
             "conv5": (2, 1, 1, 2), "lienar1": (4, 1), "linear2": (4, 1),
             "linear3": (2, 2)}),
]


@pytest.mark.parametrize("ranks,size,splits", APP_RUNS)
def test_cnn_app_on_ranks_matches_the_run_without_a_strategy(
        tmp_path, ranks, size, splits):
    from flexflow_tpu_torch.apps import cnn

    ops = {"conv1": 4, "pool1": 4, "conv2": 4, "pool2": 4, "conv3": 4,
           "conv4": 4, "conv5": 4, "pool3": 4, "flat": 2, "lienar1": 2,
           "linear2": 2, "linear3": 2, "softmax": 1}
    grids = {name: (1,) * (nd - 1) + (ranks,) for name, nd in ops.items()}
    grids.update(splits)
    path = tmp_path / "alexnet.json"
    path.write_text(tr.strategy_json(grids, ranks))
    assert json.loads(path.read_text())["conv2"]["dims"][2] == 2
    argv = ["alexnet", "-b", "8", "-i", "3", "--height", str(size),
            "--width", str(size), "--lr", "0.001", "-p", "0", "--device",
            "cpu"]
    got = tr.run_ranks(tr.app_main, ranks,
                       argv + ["-s", str(path), "-ll:gpu", str(ranks)],
                       timeout=150)
    assert got[1:] == [None] * (ranks - 1)   # rank 0 alone returns
    want = cnn.main(argv, log=lambda *a: None)["loss"]
    np.testing.assert_allclose(got[0], want, rtol=tr.LOSS_RTOL,
                               atol=tr.LOSS_ATOL)
