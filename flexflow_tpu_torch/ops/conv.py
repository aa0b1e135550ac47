"""Conv2D: convolution + bias + optional ReLU over NHWC activations with
an HWIO kernel (PyTorch port of ``flexflow_tpu/ops/conv.py``).

The convolution is ``F.conv2d`` (cuDNN on the GPU), as the JAX package
leaves it to XLA.  The NHWC activation enters as its NCHW view
``permute(0, 3, 1, 2)``, which is channels_last in memory, so cuDNN runs
its NHWC kernels and returns a channels_last result whose NHWC view is
contiguous again: activations are never copied between layouts.  The
HWIO kernel is cast to the activation dtype as ``conv.py:206`` does, in
the same copy that lays it out as channels_last OIHW.

Over several ranks the grid is (w, h, c, n) (``conv.py:1-17, 170-210``):
``c`` splits the output channels, with kernel and bias stored as the
rank's c-block; input channels stay whole.  An h or w split needs the
input rows or columns the block's windows reach past the block (the
halo): each rank receives only those rows of its windows' span from the
ranks whose blocks hold them (its neighbours, for every geometry of the
repo's models) and sends them theirs, as JAX's ``exchange_halo``
(``ops/base.py:72``) does; the span is zero-padded at the image border.
"""

from __future__ import annotations

from typing import Dict, List

import torch
import torch.nn.functional as F

from flexflow_tpu_torch.ops.base import Op, Tensor, glorot_uniform
from flexflow_tpu_torch.strategy import ParallelConfig


def out_dim(size: int, k: int, s: int, p: int) -> int:
    return 1 + (size + 2 * p - k) // s


def window_span(out_block, size: int, k: int, s: int, p: int):
    """``(lo, hi, pad_lo, pad_hi)``: the input rows ``[lo, hi)`` that the
    windows of output rows ``out_block`` read, and the zero (or -inf)
    rows to add before and after them for the image border."""
    olo, ohi = out_block
    start, stop = olo * s - p, (ohi - 1) * s - p + k
    lo, hi = max(start, 0), min(stop, size)
    return lo, hi, lo - start, stop - hi


def spatial_placeable(op, pc) -> bool:
    """The JAX ops' ``_spatial_placeable`` (``conv.py:49``, ``pool.py:43``):
    every split spatial dim of a stride-1, odd-kernel, SAME-padded window
    divides evenly; a conv's channel split divides its output channels,
    and only an average pool takes a spatial split."""
    pw, ph, pcc, _ = pc.dims
    pooling = hasattr(op, "pool_type")
    if pooling and op.pool_type != "avg":
        return False
    if not pooling and pcc > 1 and op.out_channels % pcc:
        return False
    _, h, w, _ = op.inputs[0].shape
    for parts, extent, k, s, p in (
            (ph, h, op.kernel_h, op.stride_h, op.padding_h),
            (pw, w, op.kernel_w, op.stride_w, op.padding_w)):
        if parts == 1:
            continue
        if s != 1 or k % 2 == 0 or p != (k - 1) // 2 or extent % parts:
            return False
        if pooling and (k - 1) // 2 > extent // parts:
            return False
    return True


def window_blocks(op, x, grid):
    """``(x, (pad_h, pad_w))`` for a windowed op (kernel, stride and
    padding per spatial dim) on this rank's NHWC block ``x``: along an
    h or w split, the input rows (columns) of the span of the rank's
    output windows, its own and those its neighbours send
    (``OpGrid.halo``), with its ``(lo, hi)`` border padding; along an
    unsplit dim, ``x`` and the op's own padding."""
    _, in_h, in_w, _ = op.inputs[0].shape
    _, out_h, out_w, _ = op.output.shape
    pads = []
    for name, dim, size, osize, k, s, p in (
            ("h", 1, in_h, out_h, op.kernel_h, op.stride_h, op.padding_h),
            ("w", 2, in_w, out_w, op.kernel_w, op.stride_w, op.padding_w)):
        parts = grid.parts(name)
        if parts == 1:
            pads.append((p, p))
            continue
        spans = [window_span(grid.block(name, osize, i), size, k, s, p)
                 for i in range(parts)]
        x = grid.halo(x, name, dim, size, [sp[:2] for sp in spans])
        pads.append(spans[grid.index(name)][2:])
    return x, pads


class Conv2D(Op):
    AXIS_NAMES = ("w", "h", "c", "n")
    POINT_WINDOWS = True

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

    def output_spec(self):
        return ("n", "h", "w", "c")

    def regrid_input_specs(self):
        return [("n", "h", "w", None)]

    def param_specs(self):
        return {"kernel": (None, None, None, "c"), "bias": ("c",)}

    def placement_signature(self):
        return (self.in_channels, self.out_channels, self.kernel_h,
                self.kernel_w, self.stride_h, self.stride_w,
                self.padding_h, self.padding_w, self.relu)

    def input_specs(self, pc=None):
        """Batch-only grids, and channel or spatial grids of SAME-padded
        stride-1 convolutions (``conv.py:80-93``)."""
        pc = pc or self.pc
        if pc.dims[:3] == (1, 1, 1):
            return [("n", None, None, None)]
        if spatial_placeable(self, pc):
            return [("n", "h", "w", None)]
        return None

    def grid_collectives(self):
        w, h, _, _ = self.pc.dims
        return [(a,) for a, parts in (("h", h), ("w", w)) if parts > 1]

    def _conv(self, params, x, pad_h, pad_w):
        """The convolution of NHWC ``x`` with ``(lo, hi)`` zero padding of
        each spatial dim."""
        if pad_h[0] != pad_h[1] or pad_w[0] != pad_w[1]:
            x = F.pad(x, (0, 0) + tuple(pad_w) + tuple(pad_h))
            pad_h = pad_w = (0, 0)
        weight = params["kernel"].permute(3, 2, 0, 1).to(
            dtype=x.dtype, memory_format=torch.channels_last)
        y = F.conv2d(x.permute(0, 3, 1, 2), weight,
                     stride=(self.stride_h, self.stride_w),
                     padding=(pad_h[0], pad_w[0]))
        y = y.permute(0, 2, 3, 1) + params["bias"].to(x.dtype)
        if self.relu:
            y = F.relu(y)
        return y

    def forward(self, params, state, xs: List, train: bool):
        (x,) = xs
        return self._conv(params, x, (self.padding_h,) * 2,
                          (self.padding_w,) * 2), state

    def sharded_forward(self, params, state, xs: List, train: bool, grid):
        x, pads = window_blocks(self, xs[0], grid)
        return self._conv(params, x, *pads), state

    # ---- cost model (conv.py:225-242) ---------------------------------

    def local_clone(self, pc: ParallelConfig):
        pw, ph, pc_, pn = pc.dims
        n, h, w, cin = self.inputs[0].shape
        if n % pn or h % ph or w % pw or self.out_channels % pc_:
            return None
        t = Tensor((n // pn, h // ph, w // pw, cin))
        return Conv2D(self.name, ParallelConfig((1, 1, 1, 1), (0,)), t,
                      self.out_channels // pc_, self.kernel_h, self.kernel_w,
                      self.stride_h, self.stride_w, self.padding_h,
                      self.padding_w, self.relu)

    def flops_per_sample(self) -> float:
        _, oh, ow, oc = self.output.shape
        return 2.0 * oh * ow * oc * self.kernel_h * self.kernel_w \
            * self.in_channels

    def param_bytes(self) -> int:
        return 4 * (self.kernel_h * self.kernel_w * self.in_channels
                    * self.out_channels + self.out_channels)
