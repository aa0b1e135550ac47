"""Per-position linear projection over (batch, len, d) tensors, the
transformer's FFN and vocab projection (PyTorch port of
``flexflow_tpu/ops/rnn_linear.py``).  The product is a plain
``torch.matmul``, as the JAX package leaves it to XLA.

Over several ranks the grid is (c, n) (``rnn_linear.py:40-58``): the
output's vocab (or feature) dim splits over ``c``, with kernel and bias
stored as the rank's c-block, and the input is batch-split over ``n``
and whole over ``c``."""

from __future__ import annotations

from typing import Dict, List

import torch

from flexflow_tpu_torch.ops.base import Op, Tensor, glorot_uniform
from flexflow_tpu_torch.strategy import ParallelConfig


class RnnLinear(Op):
    AXIS_NAMES = ("c", "n")

    def __init__(self, name: str, pc: ParallelConfig, input: Tensor,
                 out_channels: int, param_key: str = None):
        super().__init__(name, pc, [input])
        if input.ndim != 3:
            raise ValueError("rnn linear input must be (batch, len, d)")
        n, length, d = input.shape
        self.in_channels = d
        self.out_channels = out_channels
        if param_key:
            self.param_key = param_key
        self.output = Tensor((n, length, out_channels), "float32", self, name)

    def init_params(self, gen, device) -> Dict:
        kernel = glorot_uniform((self.in_channels, self.out_channels), gen,
                                device)
        return {"kernel": kernel,
                "bias": torch.zeros((self.out_channels,), device=device)}

    def param_specs(self):
        return {"kernel": (None, "c"), "bias": ("c",)}

    def output_spec(self):
        return ("n", None, "c")

    def regrid_input_specs(self):
        return [("n", None, None)]

    def placement_signature(self):
        return (self.in_channels, self.out_channels)

    def input_specs(self, pc=None):
        return [("n", None, None)]

    def forward(self, params, state, xs: List, train: bool):
        (x,) = xs
        y = torch.matmul(x, params["kernel"].to(x.dtype))
        return (y.float() + params["bias"]).to(x.dtype), state

    # ---- cost model (rnn_linear.py:71-84) -----------------------------

    def local_clone(self, pc: ParallelConfig):
        pc_, pn = pc.dims
        n, length, d = self.inputs[0].shape
        if n % pn or self.out_channels % pc_:
            return None
        t = Tensor((n // pn, length, d))
        return RnnLinear(self.name, ParallelConfig((1, 1), (0,)), t,
                         self.out_channels // pc_)

    def flops_per_sample(self) -> float:
        return 2.0 * self.output.shape[1] * self.in_channels \
            * self.out_channels

    def param_bytes(self) -> int:
        return 4 * (self.in_channels * self.out_channels + self.out_channels)
