"""Elementwise Add of two tensors of one shape, with an optional fused
ReLU: the residual connection (PyTorch port of
``flexflow_tpu/ops/elementwise.py``).  The reference's ResNet-101 has no
residual add; this op lets ``build_resnet101(residual=True)`` build the
real one.  Over several ranks both inputs arrive in the output's layout
and the add is local."""

from __future__ import annotations

import math
from typing import List

import torch.nn.functional as F

from flexflow_tpu_torch.ops.base import Op, Tensor
from flexflow_tpu_torch.strategy import ParallelConfig


class Add(Op):
    AXIS_NAMES = ("w", "h", "c", "n")

    def __init__(self, name: str, pc: ParallelConfig, inputs: List[Tensor],
                 relu: bool = False):
        super().__init__(name, pc, inputs)
        if len(inputs) != 2 or inputs[0].shape != inputs[1].shape:
            raise ValueError(f"add needs two inputs of one shape, got "
                             f"{[t.shape for t in inputs]}")
        self.relu = relu
        self.output = Tensor(inputs[0].shape, inputs[0].dtype, self, name)

    def output_spec(self):
        """NHWC activations split over (n, h, w, c); another rank's batch
        and minor feature dims over n and c (``elementwise.py:29-40``)."""
        nd = self.output.ndim
        if nd == 4:
            return ("n", "h", "w", "c")
        if nd == 1:
            return ("n",)
        return ("n",) + (None,) * (nd - 2) + ("c",)

    def regrid_input_specs(self):
        return [self.output_spec()] * len(self.inputs)

    def placement_signature(self):
        return (self.relu,)

    def input_specs(self, pc=None):
        # any grid is local when both inputs share it
        return [self.output_spec()] * len(self.inputs)

    def flops_per_sample(self) -> float:
        return float(math.prod(self.output.shape[1:]))

    def forward(self, params, state, xs: List, train: bool):
        y = xs[0] + xs[1]
        if self.relu:
            y = F.relu(y)
        return y, state
