"""Flat: (N, H, W, C) -> (N, H*W*C) (PyTorch port of
``flexflow_tpu/ops/flat.py``).

The features are flattened in NHWC order, (h, w, c) with c fastest, as
the JAX op does: the next linear's kernel rows follow that order, and an
NCHW flatten would pair them with the wrong features.  Over several
ranks each rank flattens its batch block (the grid's ``c`` splits
nothing)."""

from __future__ import annotations

from typing import List

from flexflow_tpu_torch.ops.base import Op, Tensor
from flexflow_tpu_torch.strategy import ParallelConfig


class Flat(Op):
    AXIS_NAMES = ("c", "n")

    def __init__(self, name: str, pc: ParallelConfig, input: Tensor):
        super().__init__(name, pc, [input])
        if input.ndim != 4:
            raise ValueError("flat input must be NHWC")
        n, h, w, c = input.shape
        self.output = Tensor((n, h * w * c), input.dtype, self, name)

    def output_spec(self):
        return ("n", None)

    def regrid_input_specs(self):
        return [("n", None, None, None)]

    def placement_signature(self):
        return ("flat",)

    def input_specs(self, pc=None):
        return [("n", None, None, None)]   # a local reshape per batch block

    def forward(self, params, state, xs: List, train: bool):
        (x,) = xs
        return x.reshape(x.shape[0], -1), state
