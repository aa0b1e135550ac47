"""Inception-v3 (PyTorch port of ``flexflow_tpu/models/inception.py``):
the same block functions, op names and widths — 299x299x3 input, the
stem, 3 A, 1 B, 4 C, 1 D and 2 E blocks, the 8x8 global average pool,
and a 1000-way linear + softmax.

The block functions only call the graph-building methods ``conv2d``,
``pool2d`` and ``concat``, whose signatures the two packages share, so a
test can also build a smaller network from them in either package.
"""

from __future__ import annotations

from typing import Optional

from flexflow_tpu_torch.config import FFConfig
from flexflow_tpu_torch.machine import MachineModel
from flexflow_tpu_torch.model import FFModel
from flexflow_tpu_torch.ops.base import Tensor

POOL_AVG = "avg"


def _conv(ff, name, t, ch, kh, kw, sh=1, sw=1, ph=0, pw=0, relu=True):
    return ff.conv2d(name, t, ch, kh, kw, sh, sw, ph, pw, relu=relu)


def inception_a(ff, p: str, input: Tensor, pool_features: int) -> Tensor:
    t1 = _conv(ff, f"{p}_b1_1x1", input, 64, 1, 1)
    t2 = _conv(ff, f"{p}_b2_1x1", input, 48, 1, 1)
    t2 = _conv(ff, f"{p}_b2_5x5", t2, 64, 5, 5, 1, 1, 2, 2)
    t3 = _conv(ff, f"{p}_b3_1x1", input, 64, 1, 1)
    t3 = _conv(ff, f"{p}_b3_3x3a", t3, 96, 3, 3, 1, 1, 1, 1)
    t3 = _conv(ff, f"{p}_b3_3x3b", t3, 96, 3, 3, 1, 1, 1, 1)
    t4 = ff.pool2d(f"{p}_b4_pool", input, 3, 3, 1, 1, 1, 1,
                   pool_type=POOL_AVG)
    t4 = _conv(ff, f"{p}_b4_1x1", t4, pool_features, 1, 1)
    return ff.concat(f"{p}_concat", [t1, t2, t3, t4])


def inception_b(ff, p: str, input: Tensor) -> Tensor:
    t1 = _conv(ff, f"{p}_b1_3x3", input, 384, 3, 3, 2, 2, 0, 0)
    t2 = _conv(ff, f"{p}_b2_1x1", input, 64, 1, 1)
    t2 = _conv(ff, f"{p}_b2_3x3a", t2, 96, 3, 3, 1, 1, 1, 1)
    t2 = _conv(ff, f"{p}_b2_3x3b", t2, 96, 3, 3, 2, 2, 0, 0)
    t3 = ff.pool2d(f"{p}_b3_pool", input, 3, 3, 2, 2, 0, 0)
    return ff.concat(f"{p}_concat", [t1, t2, t3])


def inception_c(ff, p: str, input: Tensor, channels: int) -> Tensor:
    t1 = _conv(ff, f"{p}_b1_1x1", input, 192, 1, 1)
    t2 = _conv(ff, f"{p}_b2_1x1", input, channels, 1, 1)
    t2 = _conv(ff, f"{p}_b2_1x7", t2, channels, 1, 7, 1, 1, 0, 3)
    t2 = _conv(ff, f"{p}_b2_7x1", t2, 192, 7, 1, 1, 1, 3, 0)
    t3 = _conv(ff, f"{p}_b3_1x1", input, channels, 1, 1)
    t3 = _conv(ff, f"{p}_b3_7x1a", t3, channels, 7, 1, 1, 1, 3, 0)
    t3 = _conv(ff, f"{p}_b3_1x7a", t3, channels, 1, 7, 1, 1, 0, 3)
    t3 = _conv(ff, f"{p}_b3_7x1b", t3, channels, 7, 1, 1, 1, 3, 0)
    t3 = _conv(ff, f"{p}_b3_1x7b", t3, 192, 1, 7, 1, 1, 0, 3)
    t4 = ff.pool2d(f"{p}_b4_pool", input, 3, 3, 1, 1, 1, 1,
                   pool_type=POOL_AVG)
    t4 = _conv(ff, f"{p}_b4_1x1", t4, 192, 1, 1)
    return ff.concat(f"{p}_concat", [t1, t2, t3, t4])


def inception_d(ff, p: str, input: Tensor) -> Tensor:
    t1 = _conv(ff, f"{p}_b1_1x1", input, 192, 1, 1)
    t1 = _conv(ff, f"{p}_b1_3x3", t1, 320, 3, 3, 2, 2, 0, 0)
    t2 = _conv(ff, f"{p}_b2_1x1", input, 192, 1, 1)
    t2 = _conv(ff, f"{p}_b2_1x7", t2, 192, 1, 7, 1, 1, 0, 3)
    t2 = _conv(ff, f"{p}_b2_7x1", t2, 192, 7, 1, 1, 1, 3, 0)
    t2 = _conv(ff, f"{p}_b2_3x3", t2, 192, 3, 3, 2, 2, 0, 0)
    t3 = ff.pool2d(f"{p}_b3_pool", input, 3, 3, 2, 2, 0, 0)
    return ff.concat(f"{p}_concat", [t1, t2, t3])


def inception_e(ff, p: str, input: Tensor) -> Tensor:
    t1 = _conv(ff, f"{p}_b1_1x1", input, 320, 1, 1)
    t2i = _conv(ff, f"{p}_b2_1x1", input, 384, 1, 1)
    t2 = _conv(ff, f"{p}_b2_1x3", t2i, 384, 1, 3, 1, 1, 0, 1)
    t3 = _conv(ff, f"{p}_b2_3x1", t2i, 384, 3, 1, 1, 1, 1, 0)
    t3i = _conv(ff, f"{p}_b3_1x1", input, 448, 1, 1)
    t3i = _conv(ff, f"{p}_b3_3x3", t3i, 384, 3, 3, 1, 1, 1, 1)
    t4 = _conv(ff, f"{p}_b3_1x3", t3i, 384, 1, 3, 1, 1, 0, 1)
    t5 = _conv(ff, f"{p}_b3_3x1", t3i, 384, 3, 1, 1, 1, 1, 0)
    t6 = ff.pool2d(f"{p}_b4_pool", input, 3, 3, 1, 1, 1, 1,
                   pool_type=POOL_AVG)
    t6 = _conv(ff, f"{p}_b4_1x1", t6, 192, 1, 1)
    return ff.concat(f"{p}_concat", [t1, t2, t3, t4, t5, t6])


def add_inception_v3_layers(ff, image: Tensor) -> Tensor:
    t = _conv(ff, "conv1", image, 32, 3, 3, 2, 2, 0, 0)
    t = _conv(ff, "conv2", t, 32, 3, 3, 1, 1, 0, 0)
    t = _conv(ff, "conv3", t, 64, 3, 3, 1, 1, 1, 1)
    t = ff.pool2d("pool1", t, 3, 3, 2, 2, 0, 0)
    t = _conv(ff, "conv4", t, 80, 1, 1, 1, 1, 0, 0)
    t = _conv(ff, "conv5", t, 192, 3, 3, 1, 1, 1, 1)
    t = ff.pool2d("pool2", t, 3, 3, 2, 2, 0, 0)
    t = inception_a(ff, "incA1", t, 32)
    t = inception_a(ff, "incA2", t, 64)
    t = inception_a(ff, "incA3", t, 64)
    t = inception_b(ff, "incB1", t)
    t = inception_c(ff, "incC1", t, 128)
    t = inception_c(ff, "incC2", t, 160)
    t = inception_c(ff, "incC3", t, 160)
    t = inception_c(ff, "incC4", t, 192)
    t = inception_d(ff, "incD1", t)
    t = inception_e(ff, "incE1", t)
    t = inception_e(ff, "incE2", t)
    t = ff.pool2d("pool3", t, 8, 8, 1, 1, 0, 0, pool_type=POOL_AVG,
                  relu=False)
    t = ff.flat("flat", t)
    t = ff.linear("linear1", t, 1000, relu=False)
    return ff.softmax("softmax", t)


def build_inception_v3(config: Optional[FFConfig] = None,
                       machine: Optional[MachineModel] = None,
                       device="cuda") -> FFModel:
    config = config or FFConfig(input_height=299, input_width=299)
    ff = FFModel(config, machine, device)
    cfg = ff.config
    image = ff.create_input(
        (cfg.batch_size, cfg.input_height, cfg.input_width, 3), name="image")
    add_inception_v3_layers(ff, image)
    return ff
