"""Conv2D: convolution + bias + optional ReLU over NHWC activations with
an HWIO kernel (PyTorch port of ``flexflow_tpu/ops/conv.py``).

The convolution is ``F.conv2d`` (cuDNN on the GPU), as the JAX package
leaves it to XLA.  The NHWC activation enters as its NCHW view
``permute(0, 3, 1, 2)``, which is channels_last in memory, so cuDNN runs
its NHWC kernels and returns a channels_last result whose NHWC view is
contiguous again: activations are never copied between layouts.  The
HWIO kernel is cast to the activation dtype as ``conv.py:206`` does, in
the same copy that lays it out as channels_last OIHW.  Spatial and
channel grids over several devices come with the multi-GPU slice.
"""

from __future__ import annotations

from typing import Dict, List

import torch
import torch.nn.functional as F

from flexflow_tpu_torch.ops.base import Op, Tensor, glorot_uniform
from flexflow_tpu_torch.strategy import ParallelConfig


def out_dim(size: int, k: int, s: int, p: int) -> int:
    return 1 + (size + 2 * p - k) // s


class Conv2D(Op):
    AXIS_NAMES = ("w", "h", "c", "n")

    def __init__(self, name: str, pc: ParallelConfig, input: Tensor,
                 out_channels: int, kernel_h: int, kernel_w: int,
                 stride_h: int, stride_w: int, padding_h: int, padding_w: int,
                 relu: bool = False):
        super().__init__(name, pc, [input])
        if input.ndim != 4:
            raise ValueError("conv2d input must be NHWC")
        n, h, w, cin = input.shape
        self.in_channels = cin
        self.out_channels = out_channels
        self.kernel_h, self.kernel_w = kernel_h, kernel_w
        self.stride_h, self.stride_w = stride_h, stride_w
        self.padding_h, self.padding_w = padding_h, padding_w
        self.relu = relu
        self.output = Tensor(
            (n, out_dim(h, kernel_h, stride_h, padding_h),
             out_dim(w, kernel_w, stride_w, padding_w), out_channels),
            input.dtype, self, name)

    def init_params(self, gen, device) -> Dict:
        kh, kw, cin, cout = (self.kernel_h, self.kernel_w, self.in_channels,
                             self.out_channels)
        # glorot over in_axis (0, 1, 2), out_axis 3, as the JAX op draws it
        kernel = glorot_uniform((kh, kw, cin, cout), gen, device,
                                fans=(kh * kw * cin, cout))
        return {"kernel": kernel,
                "bias": torch.zeros((cout,), device=device)}

    def forward(self, params, state, xs: List, train: bool):
        (x,) = xs
        weight = params["kernel"].permute(3, 2, 0, 1).to(
            dtype=x.dtype, memory_format=torch.channels_last)
        y = F.conv2d(x.permute(0, 3, 1, 2), weight,
                     stride=(self.stride_h, self.stride_w),
                     padding=(self.padding_h, self.padding_w))
        y = y.permute(0, 2, 3, 1) + params["bias"].to(x.dtype)
        if self.relu:
            y = F.relu(y)
        return y, state
