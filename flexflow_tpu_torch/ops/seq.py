"""Sequence chunking: a static slice of the (batch, seq) token tensor
along the sequence axis (PyTorch port of ``flexflow_tpu/ops/seq.py``).
The NMT model cuts its source and target tokens into chunks of
``lstm_per_node_length`` steps, one op each, so that each chunk is a
tensor of its own.  Over several ranks the grid is (n,): each rank
slices its batch block."""

from __future__ import annotations

from typing import List

from flexflow_tpu_torch.ops.base import Op, Tensor
from flexflow_tpu_torch.strategy import ParallelConfig


class SliceSeq(Op):
    AXIS_NAMES = ("n",)

    def __init__(self, name: str, pc: ParallelConfig, input: Tensor,
                 start: int, length: int):
        super().__init__(name, pc, [input])
        if input.ndim != 2:
            raise ValueError("slice_seq input must be (batch, seq)")
        n, total = input.shape
        if start < 0 or length <= 0 or start + length > total:
            raise ValueError(f"slice [{start}, {start + length}) is not "
                             f"inside a sequence of {total}")
        self.start = start
        self.length = length
        self.output = Tensor((n, length), input.dtype, self, name)

    def output_spec(self):
        return ("n", None)

    def regrid_input_specs(self):
        return [("n", None)]

    def forward(self, params, state, xs: List, train: bool):
        (x,) = xs
        return x[:, self.start:self.start + self.length], state
