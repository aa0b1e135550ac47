"""AlexNet (PyTorch port of ``flexflow_tpu/models/alexnet.py``), with the
reference's quirks: convolutions without ReLU, pools with ReLU, and the
layer name "lienar1"."""

from __future__ import annotations

from typing import Optional

from flexflow_tpu_torch.config import FFConfig
from flexflow_tpu_torch.machine import MachineModel
from flexflow_tpu_torch.model import FFModel
from flexflow_tpu_torch.ops.base import Tensor


def add_alexnet_layers(ff: FFModel, image: Tensor) -> Tensor:
    t = ff.conv2d("conv1", image, 64, 11, 11, 4, 4, 2, 2)
    t = ff.pool2d("pool1", t, 3, 3, 2, 2, 0, 0)
    t = ff.conv2d("conv2", t, 192, 5, 5, 1, 1, 2, 2)
    t = ff.pool2d("pool2", t, 3, 3, 2, 2, 0, 0)
    t = ff.conv2d("conv3", t, 384, 3, 3, 1, 1, 1, 1)
    t = ff.conv2d("conv4", t, 256, 3, 3, 1, 1, 1, 1)
    t = ff.conv2d("conv5", t, 256, 3, 3, 1, 1, 1, 1)
    t = ff.pool2d("pool3", t, 3, 3, 2, 2, 0, 0)
    t = ff.flat("flat", t)
    t = ff.linear("lienar1", t, 4096)   # sic — alexnet.cc:13
    t = ff.linear("linear2", t, 4096)
    t = ff.linear("linear3", t, 1000, relu=False)
    return ff.softmax("softmax", t)


def build_alexnet(config: Optional[FFConfig] = None,
                  machine: Optional[MachineModel] = None,
                  device="cuda") -> FFModel:
    ff = FFModel(config, machine, device)
    cfg = ff.config
    image = ff.create_input(
        (cfg.batch_size, cfg.input_height, cfg.input_width, 3),
        name="image")
    add_alexnet_layers(ff, image)
    return ff
