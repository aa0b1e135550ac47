"""VGG-16 (PyTorch port of ``flexflow_tpu/models/vgg.py``): the
reference's USE_VGG layers and op names — 13 3x3 pad-1 convolutions with
ReLU in five blocks of 64, 128, 256, 512 and 512 channels, each block
closed by a 2x2/2 max pool (ReLU on, the ``pool2d`` default; kernel 7),
then ``flat`` and a 25088 -> 4096 -> 4096 -> 1000 linear stack at
224x224."""

from __future__ import annotations

from typing import Optional

from flexflow_tpu_torch.config import FFConfig
from flexflow_tpu_torch.machine import MachineModel
from flexflow_tpu_torch.model import FFModel
from flexflow_tpu_torch.ops.base import Tensor


def add_vgg16_layers(ff: FFModel, image: Tensor) -> Tensor:
    t = image
    plan = [(64, 2), (128, 2), (256, 3), (512, 3), (512, 3)]
    li = 0
    for bi, (ch, reps) in enumerate(plan):
        for _ in range(reps):
            li += 1
            t = ff.conv2d(f"conv{li}", t, ch, 3, 3, 1, 1, 1, 1, relu=True)
        t = ff.pool2d(f"pool{bi + 1}", t, 2, 2, 2, 2, 0, 0)
    t = ff.flat("flat", t)
    t = ff.linear("linear1", t, 4096)
    t = ff.linear("linear2", t, 4096)
    t = ff.linear("linear3", t, 1000, relu=False)
    return ff.softmax("softmax", t)


def build_vgg16(config: Optional[FFConfig] = None,
                machine: Optional[MachineModel] = None,
                device="cuda") -> FFModel:
    ff = FFModel(config, machine, device)
    cfg = ff.config
    image = ff.create_input(
        (cfg.batch_size, cfg.input_height, cfg.input_width, 3), name="image")
    add_vgg16_layers(ff, image)
    return ff
