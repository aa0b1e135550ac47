"""Pool2D: max or average pooling over NHWC activations with the fused ReLU
the reference defaults to (PyTorch port of ``flexflow_tpu/ops/pool.py``).

Routing follows ``pool.py:252-284`` with the JAX package's kernel gates
and no policy switch:

* max pools the kernel takes (stride 2, 3x3 pad 0/1 or 2x2 pad 0) go to
  :func:`~flexflow_tpu_torch.ops.kernels.maxpool.maxpool2d` (kernel 7);
* average pools that tile the input exactly, or the global pool, go to
  :func:`~flexflow_tpu_torch.ops.kernels.avgpool.avgpool2d` (kernel 8);
* every other geometry is plain PyTorch on the activation's channels_last
  NCHW view: ``F.max_pool2d`` (-inf padding), or ``F.avg_pool2d`` with
  ``count_include_pad=False``, the JAX op's divide by the count of valid
  positions (Inception's in-block 3x3/1 pad-1 pools).

Both kernel routes launch their CUDA kernels on CUDA tensors and run
their plain versions on CPU tensors.
"""

from __future__ import annotations

from typing import List

import torch.nn.functional as F

from flexflow_tpu_torch.ops.base import Op, Tensor
from flexflow_tpu_torch.ops.kernels import avgpool, maxpool
from flexflow_tpu_torch.strategy import ParallelConfig

POOL_MAX = "max"
POOL_AVG = "avg"


class Pool2D(Op):
    AXIS_NAMES = ("w", "h", "c", "n")

    def __init__(self, name: str, pc: ParallelConfig, input: Tensor,
                 kernel_h: int, kernel_w: int, stride_h: int, stride_w: int,
                 padding_h: int, padding_w: int,
                 pool_type: str = POOL_MAX, relu: bool = True):
        super().__init__(name, pc, [input])
        if input.ndim != 4:
            raise ValueError("pool2d input must be NHWC")
        if pool_type not in (POOL_MAX, POOL_AVG):
            raise ValueError(f"pool_type must be {POOL_MAX!r} or "
                             f"{POOL_AVG!r}, got {pool_type!r}")
        n, h, w, c = input.shape
        self.kernel_h, self.kernel_w = kernel_h, kernel_w
        self.stride_h, self.stride_w = stride_h, stride_w
        self.padding_h, self.padding_w = padding_h, padding_w
        self.pool_type = pool_type
        self.relu = relu
        out_h = 1 + (h + 2 * padding_h - kernel_h) // stride_h
        out_w = 1 + (w + 2 * padding_w - kernel_w) // stride_w
        self.output = Tensor((n, out_h, out_w, c), input.dtype, self, name)

    def kernel_route(self) -> str:
        """``"maxpool"`` or ``"avgpool"`` where a kernel takes this
        geometry, else ``""`` (plain PyTorch)."""
        geom = (self.kernel_h, self.kernel_w, self.stride_h, self.stride_w,
                self.padding_h, self.padding_w)
        if self.pool_type == POOL_MAX:
            return "maxpool" if maxpool.supported(*geom) else ""
        _, h, w, _ = self.inputs[0].shape
        return "avgpool" if avgpool.supported(*geom, h, w) else ""

    def forward(self, params, state, xs: List, train: bool):
        (x,) = xs
        route = self.kernel_route()
        if route == "maxpool":
            return maxpool.maxpool2d(x, self.kernel_h, self.kernel_w,
                                     self.padding_h, self.padding_w,
                                     relu=self.relu), state
        if route == "avgpool":
            return avgpool.avgpool2d(x, self.kernel_h, self.kernel_w,
                                     self.stride_h, self.stride_w,
                                     self.padding_h, self.padding_w,
                                     relu=self.relu), state
        window = (self.kernel_h, self.kernel_w)
        strides = (self.stride_h, self.stride_w)
        pads = (self.padding_h, self.padding_w)
        xc = x.permute(0, 3, 1, 2)
        if self.pool_type == POOL_MAX:
            y = F.max_pool2d(xc, window, strides, pads)
        else:
            y = F.avg_pool2d(xc, window, strides, pads,
                             count_include_pad=False)
        y = y.permute(0, 2, 3, 1)
        if self.relu:
            y = F.relu(y)
        return y, state
