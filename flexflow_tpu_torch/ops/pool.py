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

Over several ranks the grid is (w, h, c, n) as the convolution's; ``c``
splits channels (pooling is per channel).  An h or w split takes the
rows of the block's windows' span from its neighbours by the halo
exchange (``conv.window_blocks``) and pools that span, padded
explicitly at the image border (-inf for a max pool; an average pool
divides by the count of valid positions), so the kernels see a pad-0
geometry on a contiguous block.
"""

from __future__ import annotations

from typing import List

import torch.nn.functional as F

from flexflow_tpu_torch.ops.base import Op, Tensor
from flexflow_tpu_torch.ops.conv import spatial_placeable, window_blocks
from flexflow_tpu_torch.ops.kernels import avgpool, maxpool
from flexflow_tpu_torch.strategy import ParallelConfig

POOL_MAX = "max"
POOL_AVG = "avg"


class Pool2D(Op):
    AXIS_NAMES = ("w", "h", "c", "n")
    POINT_WINDOWS = True

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

    def kernel_route(self, pads=None, h=None, w=None) -> str:
        """``"maxpool"`` or ``"avgpool"`` where a kernel takes this
        geometry (with padding ``pads``, default the op's, over an
        ``h`` x ``w`` input, default the op's), else ``""`` (plain
        PyTorch)."""
        ph, pw = pads or (self.padding_h, self.padding_w)
        geom = (self.kernel_h, self.kernel_w, self.stride_h, self.stride_w,
                ph, pw)
        if self.pool_type == POOL_MAX:
            return "maxpool" if maxpool.supported(*geom) else ""
        _, in_h, in_w, _ = self.inputs[0].shape
        return "avgpool" if avgpool.supported(*geom, h or in_h,
                                              w or in_w) else ""

    def output_spec(self):
        return ("n", "h", "w", "c")

    def regrid_input_specs(self):
        return [("n", "h", "w", "c")]

    def placement_signature(self):
        return (self.kernel_h, self.kernel_w, self.stride_h, self.stride_w,
                self.padding_h, self.padding_w, self.pool_type, self.relu)

    def input_specs(self, pc=None):
        """Batch and channel grids that divide, and the spatial grids of
        SAME stride-1 average pools (``pool.py:65-79``)."""
        pc = pc or self.pc
        pw, ph, pcc, pn = pc.dims
        n, _, _, c = self.inputs[0].shape
        cs = "c" if pcc > 1 else None
        if (pcc > 1 and c % pcc) or n % pn:
            return None
        if (pw, ph) == (1, 1):
            return [("n", None, None, cs)]
        if spatial_placeable(self, pc):
            return [("n", "h", "w", cs)]
        return None

    def grid_collectives(self):
        w, h, _, _ = self.pc.dims
        return [(a,) for a, parts in (("h", h), ("w", w)) if parts > 1]

    def _pool(self, x, ph: int, pw: int):
        """The pool of NHWC ``x`` with padding (ph, pw) on both sides."""
        route = self.kernel_route((ph, pw), x.shape[1], x.shape[2])
        if route == "maxpool":
            return maxpool.maxpool2d(x, self.kernel_h, self.kernel_w, ph, pw,
                                     relu=self.relu)
        if route == "avgpool":
            return avgpool.avgpool2d(x, self.kernel_h, self.kernel_w,
                                     self.stride_h, self.stride_w, ph, pw,
                                     relu=self.relu)
        window = (self.kernel_h, self.kernel_w)
        strides = (self.stride_h, self.stride_w)
        xc = x.permute(0, 3, 1, 2)
        if self.pool_type == POOL_MAX:
            y = F.max_pool2d(xc, window, strides, (ph, pw))
        else:
            y = F.avg_pool2d(xc, window, strides, (ph, pw),
                             count_include_pad=False)
        y = y.permute(0, 2, 3, 1)
        if self.relu:
            y = F.relu(y)
        return y

    def forward(self, params, state, xs: List, train: bool):
        (x,) = xs
        return self._pool(x, self.padding_h, self.padding_w), state

    def sharded_forward(self, params, state, xs: List, train: bool, grid):
        w, h, _, _ = self.pc.dims
        if (h, w) == (1, 1):
            return self.forward(params, state, xs, train)
        x, ((hlo, hhi), (wlo, whi)) = window_blocks(self, xs[0], grid)
        border = (0, 0, wlo, whi, hlo, hhi)
        if not any(border):
            return self._pool(x.contiguous(), 0, 0), state
        if self.pool_type == POOL_MAX:
            return self._pool(F.pad(x, border, value=float("-inf")), 0,
                              0), state
        # an average over the valid positions of each padded window
        window = (self.kernel_h, self.kernel_w)
        strides = (self.stride_h, self.stride_w)
        xc = F.pad(x, border).permute(0, 3, 1, 2)
        ones = F.pad(x.new_ones((1, x.shape[1], x.shape[2], 1)),
                     border).permute(0, 3, 1, 2)
        total = F.avg_pool2d(xc, window, strides, divisor_override=1)
        count = F.avg_pool2d(ones, window, strides, divisor_override=1)
        y = (total / count).permute(0, 2, 3, 1)
        if self.relu:
            y = F.relu(y)
        return y, state

    # ---- cost model (pool.py:286-299) ---------------------------------

    def local_clone(self, pc: ParallelConfig):
        pw, ph, pc_, pn = pc.dims
        n, h, w, c = self.inputs[0].shape
        if n % pn or h % ph or w % pw or c % pc_:
            return None
        t = Tensor((n // pn, h // ph, w // pw, c // pc_))
        return Pool2D(self.name, ParallelConfig((1, 1, 1, 1), (0,)), t,
                      self.kernel_h, self.kernel_w, self.stride_h,
                      self.stride_w, self.padding_h, self.padding_w,
                      self.pool_type, self.relu)

    def flops_per_sample(self) -> float:
        _, oh, ow, c = self.output.shape
        return float(oh * ow * c * self.kernel_h * self.kernel_w)
