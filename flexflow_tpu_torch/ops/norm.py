"""BatchNorm over NHWC activations with the fused ReLU the reference
defaults to (PyTorch port of ``flexflow_tpu/ops/norm.py``).

Training normalizes with the batch statistics (float32 mean and biased
variance over N, H and W) and updates the running statistics
``m * state + (1 - m) * stat`` (momentum 0.9, eps 1e-5), detached; eval
uses the running statistics and returns the state unchanged.  The
statistics and the affine fold into per-channel float32 vectors

    inv = rsqrt(var + eps) * scale,   shift = bias - mean * inv

inside the autograd graph, so the gradient of x also carries the
statistics' part, as JAX's autodiff of the fold does.  Routing follows
``norm.py:166-210`` with the JAX gate and no policy switch: where
:func:`~flexflow_tpu_torch.ops.kernels.bn_act.supported` holds, the
normalize (+ReLU) is :func:`~flexflow_tpu_torch.ops.kernels.bn_act.bn_act`
(kernels 9 and 10 on CUDA tensors, their plain versions on CPU tensors);
otherwise it is the JAX op's XLA form, ``x * inv + shift`` with inv and
shift rounded to x's dtype first.  The two forms round differently in
bfloat16.

Over several ranks (grid (w, h, c, n)) the statistics stay global: each
rank sums its block's x over N, H and W, the sums are added up over the
ranks of the n, h and w axes by an autograd all-reduce (whose backward
all-reduces too, so the statistics' gradient is global as well; JAX's
``placed_prelude`` and canonical GSPMD form, ``norm.py:125-144,
180-206``), then ``(x - mean)^2`` the same way.  ``c`` splits channels:
scale, bias and the running statistics are stored as the rank's c-block,
equal on every rank that holds it.  The normalize (kernels 9 and 10
where the block's shape passes the gate) runs on the block with the
global (inv, shift); kernel 10's per-channel sums are the rank's
partials, which autograd adds up across ranks.

Placed on a device subset (``parallel/placement.py``: c unsplit, as
JAX's ``point_placeable`` and ``input_specs`` require,
``norm.py:62-146``) the same forward runs on the subset's ranks alone:
the statistics are summed over the ranks of the subset's n, h and w
axes, and scale, bias and the running statistics live on those ranks
only.  JAX's ``placed_prelude`` and ``point_forward`` (its statistics
over replicated operands) have no counterpart: a rank per process
computes them from its own blocks.
"""

from __future__ import annotations

from typing import Dict, List

import torch
import torch.nn.functional as F

from flexflow_tpu_torch.ops.base import Op, Tensor
from flexflow_tpu_torch.ops.kernels import bn_act
from flexflow_tpu_torch.strategy import ParallelConfig


class BatchNorm(Op):
    AXIS_NAMES = ("w", "h", "c", "n")
    POINT_WINDOWS = True

    def __init__(self, name: str, pc: ParallelConfig, input: Tensor,
                 relu: bool = True, eps: float = 1e-5, momentum: float = 0.9):
        super().__init__(name, pc, [input])
        if input.ndim != 4:
            raise ValueError("batch_norm input must be NHWC")
        self.channels = input.shape[3]
        self.relu = relu
        self.eps = eps
        self.momentum = momentum
        self.output = Tensor(input.shape, input.dtype, self, name)

    def init_params(self, gen, device) -> Dict:
        return {"scale": torch.ones((self.channels,), device=device),
                "bias": torch.zeros((self.channels,), device=device)}

    def init_state(self, device) -> Dict:
        return {"mean": torch.zeros((self.channels,), device=device),
                "var": torch.ones((self.channels,), device=device)}

    def kernel_route(self) -> str:
        """``"bn_act"`` where the JAX gate takes the input's shape, else
        ``""`` (the XLA form in plain PyTorch)."""
        return "bn_act" if bn_act.supported(*self.inputs[0].shape) else ""

    def output_spec(self):
        return ("n", "h", "w", "c")

    def regrid_input_specs(self):
        return [("n", "h", "w", "c")]

    def param_specs(self):
        return {"scale": ("c",), "bias": ("c",)}

    def state_specs(self):
        return {"mean": ("c",), "var": ("c",)}

    def placement_signature(self):
        return (self.channels, self.relu, self.eps, self.momentum)

    def input_specs(self, pc=None):
        """Placed grids never split c (the running statistics would
        split with it) and divide n, h and w (``norm.py:62-72``)."""
        pc = pc or self.pc
        pw, ph, pcc, pn = pc.dims
        n, h, w, _ = self.inputs[0].shape
        if pcc != 1 or n % pn or h % ph or w % pw:
            return None
        return [("n", "h", "w", None)]

    def point_placeable(self):
        return self.pc.dims[2] == 1

    def grid_collectives(self):
        w, h, _, n = self.pc.dims
        return [("w", "h", "n")] if w * h * n > 1 else []

    def sharded_forward(self, params, state, xs: List, train: bool, grid):
        (x,) = xs
        if not train:
            return self._normalize(params, x, state["mean"], state["var"]),\
                state
        n, h, w, _ = self.inputs[0].shape
        count = n * h * w
        xf = x.float()
        axes = ("w", "h", "n")
        mean = grid.all_reduce(xf.sum(dim=(0, 1, 2)), axes) / count
        var = grid.all_reduce(((xf - mean) ** 2).sum(dim=(0, 1, 2)),
                              axes) / count
        m = self.momentum
        state = {"mean": m * state["mean"] + (1 - m) * mean.detach(),
                 "var": m * state["var"] + (1 - m) * var.detach()}
        return self._normalize(params, x, mean, var), state

    def _normalize(self, params, x, mean, var):
        """y of x under (mean, var): kernels 9-10 where the gate takes
        x's shape, else the XLA form."""
        inv = torch.rsqrt(var + self.eps) * params["scale"]
        shift = params["bias"] - mean * inv
        if bn_act.supported(*x.shape):
            return bn_act.bn_act(x, inv, shift, relu=self.relu)
        y = x * inv.to(x.dtype) + shift.to(x.dtype)
        if self.relu:
            y = F.relu(y)
        return y

    def forward(self, params, state, xs: List, train: bool):
        (x,) = xs
        if train:
            xf = x.float()
            mean = xf.mean(dim=(0, 1, 2))
            var = xf.var(dim=(0, 1, 2), correction=0)   # biased, as jnp.var
            m = self.momentum
            state = {"mean": m * state["mean"] + (1 - m) * mean.detach(),
                     "var": m * state["var"] + (1 - m) * var.detach()}
        else:
            mean, var = state["mean"], state["var"]
        return self._normalize(params, x, mean, var), state

    # ---- cost model (norm.py:212-226) ---------------------------------

    def local_clone(self, pc: ParallelConfig):
        pw, ph, pc_, pn = pc.dims
        n, h, w, c = self.inputs[0].shape
        if n % pn or h % ph or w % pw or c % pc_:
            return None
        t = Tensor((n // pn, h // ph, w // pw, c // pc_))
        return BatchNorm(self.name, ParallelConfig((1, 1, 1, 1), (0,)), t,
                         self.relu, self.eps, self.momentum)

    def flops_per_sample(self) -> float:
        _, h, w, c = self.output.shape
        return 8.0 * h * w * c

    def param_bytes(self) -> int:
        return 4 * 2 * self.channels
