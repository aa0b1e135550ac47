"""BatchNorm over NHWC activations with the fused ReLU the reference
defaults to (PyTorch port of ``flexflow_tpu/ops/norm.py``, one device).

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
bfloat16.  The placed and point forms come with the multi-GPU slice.
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
        inv = torch.rsqrt(var + self.eps) * params["scale"]
        shift = params["bias"] - mean * inv
        if self.kernel_route():
            return bn_act.bn_act(x, inv, shift, relu=self.relu), state
        y = x * inv.to(x.dtype) + shift.to(x.dtype)
        if self.relu:
            y = F.relu(y)
        return y, state
