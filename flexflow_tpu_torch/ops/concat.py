"""Concat along the channel axis of NHWC tensors (PyTorch port of
``flexflow_tpu/ops/concat.py``).  Over several ranks the inputs arrive
whole over channels (their channel counts need not divide the grid's
``c``), split over n, h and w; a ``c`` split slices the rank's block of
the concatenation."""

from __future__ import annotations

from typing import List

import torch

from flexflow_tpu_torch.ops.base import Op, Tensor
from flexflow_tpu_torch.strategy import ParallelConfig


class Concat(Op):
    AXIS_NAMES = ("w", "h", "c", "n")

    def placement_signature(self):
        return ("concat", len(self.inputs))

    def input_specs(self, pc=None):
        # a channel split would break the local concat (concat.py:33-39)
        pc = pc or self.pc
        if pc.dims[2] != 1:
            return None
        return [("n", "h", "w", None)] * len(self.inputs)

    def __init__(self, name: str, pc: ParallelConfig, inputs: List[Tensor]):
        super().__init__(name, pc, inputs)
        if len(inputs) < 2:
            raise ValueError("concat needs at least two inputs")
        n, h, w, _ = inputs[0].shape
        for t in inputs:
            if t.ndim != 4 or t.shape[:3] != (n, h, w):
                raise ValueError("concat inputs must agree on N, H, W")
        c_total = sum(t.shape[3] for t in inputs)
        self.output = Tensor((n, h, w, c_total), inputs[0].dtype, self, name)

    def output_spec(self):
        return ("n", "h", "w", "c")

    def regrid_input_specs(self):
        return [("n", "h", "w", None)] * len(self.inputs)

    def forward(self, params, state, xs: List, train: bool):
        return torch.cat(xs, dim=3), state

    def sharded_forward(self, params, state, xs: List, train: bool, grid):
        y = torch.cat(xs, dim=3)
        if grid.parts("c") == 1:
            return y, state
        lo, hi = grid.block("c", self.output.shape[3])
        return y[..., lo:hi].contiguous(), state
