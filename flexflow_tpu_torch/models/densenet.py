"""DenseNet-121 (PyTorch port of ``flexflow_tpu/models/densenet.py``):
the same block functions, op names and widths — 224x224x3 input, a 7x7/2
convolution, ``bn1`` and a 3x3/2 pad-1 max pool, dense blocks of 6, 12,
24 and 16 layers at growth rate 32 (each layer BN+ReLU, 1x1 conv to 128,
BN+ReLU, 3x3 conv to 32, concat) with halving transitions (1x1 conv +
ReLU, 2x2/2 avg pool) between them, the 7x7 global avg pool, and a
1000-way linear + softmax.

The block functions only call the graph-building methods ``batch_norm``,
``conv2d``, ``pool2d`` and ``concat``, whose signatures the two packages
share, so a test can also build a smaller network from them in either
package.
"""

from __future__ import annotations

from typing import Optional

from flexflow_tpu_torch.config import FFConfig
from flexflow_tpu_torch.machine import MachineModel
from flexflow_tpu_torch.model import FFModel
from flexflow_tpu_torch.ops.base import Tensor
from flexflow_tpu_torch.ops.pool import POOL_AVG


def dense_block(ff, p: str, input: Tensor, num_layers: int,
                growth_rate: int) -> Tensor:
    last = input
    for i in range(num_layers):
        t = ff.batch_norm(f"{p}_l{i}_bn1", last, relu=True)
        t = ff.conv2d(f"{p}_l{i}_conv1", t, 4 * growth_rate, 1, 1, 1, 1,
                      0, 0, relu=False)
        t = ff.batch_norm(f"{p}_l{i}_bn2", t, relu=True)
        t = ff.conv2d(f"{p}_l{i}_conv2", t, growth_rate, 3, 3, 1, 1, 1, 1,
                      relu=False)
        last = ff.concat(f"{p}_l{i}_concat", [last, t])
    return last


def transition(ff, p: str, input: Tensor, output_size: int) -> Tensor:
    t = ff.conv2d(f"{p}_conv", input, output_size, 1, 1, 1, 1, 0, 0,
                  relu=True)
    return ff.pool2d(f"{p}_pool", t, 2, 2, 2, 2, 0, 0, pool_type=POOL_AVG,
                     relu=False)


def add_densenet121_layers(ff, image: Tensor) -> Tensor:
    t = ff.conv2d("conv1", image, 64, 7, 7, 2, 2, 3, 3, relu=False)
    t = ff.batch_norm("bn1", t, relu=True)
    t = ff.pool2d("pool1", t, 3, 3, 2, 2, 1, 1)
    num_features = 64
    t = dense_block(ff, "dense1", t, 6, 32)
    num_features = (num_features + 32 * 6) // 2
    t = transition(ff, "trans1", t, num_features)
    t = dense_block(ff, "dense2", t, 12, 32)
    num_features = (num_features + 32 * 12) // 2
    t = transition(ff, "trans2", t, num_features)
    t = dense_block(ff, "dense3", t, 24, 32)
    num_features = (num_features + 32 * 24) // 2
    t = transition(ff, "trans3", t, num_features)
    t = dense_block(ff, "dense4", t, 16, 32)
    t = ff.pool2d("pool2", t, 7, 7, 1, 1, 0, 0, pool_type=POOL_AVG,
                  relu=False)
    t = ff.flat("flat", t)
    t = ff.linear("linear1", t, 1000, relu=False)
    return ff.softmax("softmax", t)


def build_densenet121(config: Optional[FFConfig] = None,
                      machine: Optional[MachineModel] = None,
                      device="cuda") -> FFModel:
    ff = FFModel(config, machine, device)
    cfg = ff.config
    image = ff.create_input(
        (cfg.batch_size, cfg.input_height, cfg.input_width, 3), name="image")
    add_densenet121_layers(ff, image)
    return ff
