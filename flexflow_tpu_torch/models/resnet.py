"""ResNet-101 (PyTorch port of ``flexflow_tpu/models/resnet.py``): the
reference's USE_RESNET model, with the JAX package's op names.

The reference's bottleneck block has its batch norms commented out and
no residual add, so its "ResNet-101" is a plain stack of bottleneck
convolutions; ``residual=False`` (the default, and what ``apps.cnn``
builds) reproduces that topology.  ``residual=True`` builds the real
ResNet-101, with identity shortcuts and 1x1 projection shortcuts where a
block changes the shape, through the ``Add`` op.  Both: a 7x7/2 stem, the
3x3/2 pad-1 max pool (kernel 7), 3 + 4 + 23 + 3 bottleneck blocks, the
7x7 global avg pool (kernel 8) and a 1000-way linear + softmax.

The block function only calls ``conv2d`` and ``add``, whose signatures
the two packages share, so a test can build a smaller network from it in
either package.
"""

from __future__ import annotations

from typing import Optional

from flexflow_tpu_torch.config import FFConfig
from flexflow_tpu_torch.machine import MachineModel
from flexflow_tpu_torch.model import FFModel
from flexflow_tpu_torch.ops.base import Tensor
from flexflow_tpu_torch.ops.pool import POOL_AVG


def bottleneck_block(ff: FFModel, p: str, input: Tensor, out_channels: int,
                     bn_channels: int, stride: int,
                     residual: bool = False) -> Tensor:
    t = ff.conv2d(f"{p}_conv1", input, bn_channels, 1, 1, 1, 1, 0, 0,
                  relu=True)
    t = ff.conv2d(f"{p}_conv2", t, bn_channels, 3, 3, stride, stride, 1, 1,
                  relu=True)
    t = ff.conv2d(f"{p}_conv3", t, out_channels, 1, 1, 1, 1, 0, 0,
                  relu=not residual)
    if residual:
        if input.shape != t.shape:
            shortcut = ff.conv2d(f"{p}_proj", input, out_channels, 1, 1,
                                 stride, stride, 0, 0, relu=False)
        else:
            shortcut = input
        t = ff.add(f"{p}_add", t, shortcut, relu=True)
    return t


def add_resnet101_layers(ff: FFModel, image: Tensor,
                         residual: bool = False) -> Tensor:
    t = ff.conv2d("conv1", image, 64, 7, 7, 2, 2, 3, 3, relu=True)
    t = ff.pool2d("pool1", t, 3, 3, 2, 2, 1, 1)
    for i in range(3):
        t = bottleneck_block(ff, f"res2_{i}", t, 256, 64, 1, residual)
    for i in range(4):
        t = bottleneck_block(ff, f"res3_{i}", t, 512, 128,
                             2 if i == 0 else 1, residual)
    for i in range(23):
        t = bottleneck_block(ff, f"res4_{i}", t, 1024, 256,
                             2 if i == 0 else 1, residual)
    for i in range(3):
        t = bottleneck_block(ff, f"res5_{i}", t, 2048, 512,
                             2 if i == 0 else 1, residual)
    t = ff.pool2d("pool2", t, 7, 7, 1, 1, 0, 0, pool_type=POOL_AVG,
                  relu=False)
    t = ff.flat("flat", t)
    t = ff.linear("linear1", t, 1000, relu=False)
    return ff.softmax("softmax", t)


def build_resnet101(config: Optional[FFConfig] = None,
                    machine: Optional[MachineModel] = None,
                    residual: bool = False, device="cuda") -> FFModel:
    ff = FFModel(config, machine, device)
    cfg = ff.config
    image = ff.create_input(
        (cfg.batch_size, cfg.input_height, cfg.input_width, 3), name="image")
    add_resnet101_layers(ff, image, residual)
    return ff
