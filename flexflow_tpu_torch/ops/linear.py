"""Linear / fully connected over (batch, features) (PyTorch port of
``flexflow_tpu/ops/linear.py``).

As ``linear.py:71-82``: the kernel is cast to the activation dtype, the
product accumulates in float32 and the bias is added in float32 before
one cast back to the activation dtype.  The product is ``torch.matmul``
on float32 views of the cast operands (the JAX op leaves it to XLA with
``preferred_element_type=float32``); it is exact for bf16 operands and
small beside the convolutions it follows.

Over several ranks the grid is (c, n) (``linear.py:40-82``): output
channels split over ``c``, with kernel and bias stored as the rank's
c-block, and the input batch-split over ``n`` and whole over ``c``."""

from __future__ import annotations

from typing import Dict, List

import torch
import torch.nn.functional as F

from flexflow_tpu_torch.ops.base import Op, Tensor, glorot_uniform
from flexflow_tpu_torch.strategy import ParallelConfig


class Linear(Op):
    AXIS_NAMES = ("c", "n")

    def __init__(self, name: str, pc: ParallelConfig, input: Tensor,
                 out_channels: int, relu: bool = True):
        super().__init__(name, pc, [input])
        if input.ndim != 2:
            raise ValueError("linear input must be (batch, features)")
        n, d = input.shape
        self.in_channels = d
        self.out_channels = out_channels
        self.relu = relu
        self.output = Tensor((n, out_channels), input.dtype, self, name)

    def init_params(self, gen, device) -> Dict:
        kernel = glorot_uniform((self.in_channels, self.out_channels), gen,
                                device)
        return {"kernel": kernel,
                "bias": torch.zeros((self.out_channels,), device=device)}

    def param_specs(self):
        return {"kernel": (None, "c"), "bias": ("c",)}

    def output_spec(self):
        return ("n", "c")

    def regrid_input_specs(self):
        return [("n", None)]

    def placement_signature(self):
        return (self.in_channels, self.out_channels, self.relu)

    def input_specs(self, pc=None):
        # each c-shard reads the whole input rows (linear.py:55-61)
        return [("n", None)]

    def forward(self, params, state, xs: List, train: bool):
        (x,) = xs
        w = params["kernel"].to(x.dtype)
        y = torch.matmul(x.float(), w.float()) + params["bias"].float()
        y = y.to(x.dtype)
        if self.relu:
            y = F.relu(y)
        return y, state

    # ---- cost model (linear.py:83-96) ---------------------------------

    def local_clone(self, pc: ParallelConfig):
        pc_, pn = pc.dims
        n, d = self.inputs[0].shape
        if n % pn or self.out_channels % pc_:
            return None
        t = Tensor((n // pn, d))
        return Linear(self.name, ParallelConfig((1, 1), (0,)), t,
                      self.out_channels // pc_, self.relu)

    def flops_per_sample(self) -> float:
        return 2.0 * self.in_channels * self.out_channels

    def param_bytes(self) -> int:
        return 4 * (self.in_channels * self.out_channels + self.out_channels)
