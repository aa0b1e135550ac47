"""Sequence-model elementwise ops on (batch, seq, d) tensors: LayerNorm,
residual add, GELU and the learned positional embedding (PyTorch port of
``flexflow_tpu/ops/seq_common.py``).

Over several ranks the grid is (s, n) (``seq_common.py:15-29``): every
tensor is batch-split over ``n`` and sequence-split over ``s``, whole
over the features, and each rank computes its block alone.
LayerNorm's scale and bias are replicated; ``PosEmbed``'s table is
split by ``s``, each ``s`` block holding its rows.  A gradient is summed
over the ranks that hold the same block (``FFModel._setup_leaves``).
The JAX ops have no placed form, so a device subset normalizes."""

from __future__ import annotations

import math
from typing import Dict, List

import torch
import torch.nn.functional as F

from flexflow_tpu_torch.ops.base import Op, Tensor
from flexflow_tpu_torch.strategy import ParallelConfig


class _SeqElementwise(Op):
    AXIS_NAMES = ("s", "n")

    def output_spec(self):
        return ("n", "s", None)

    def regrid_input_specs(self):
        return [("n", "s", None)] * len(self.inputs)


class LayerNormSeq(_SeqElementwise):
    def __init__(self, name: str, pc: ParallelConfig, input: Tensor,
                 eps: float = 1e-5):
        super().__init__(name, pc, [input])
        if input.ndim != 3:
            raise ValueError("layer norm input must be (batch, seq, d)")
        self.eps = eps
        self.d = input.shape[2]
        self.output = Tensor(input.shape, input.dtype, self, name)

    def init_params(self, gen, device) -> Dict:
        return {"scale": torch.ones((self.d,), device=device),
                "bias": torch.zeros((self.d,), device=device)}

    def forward(self, params, state, xs: List, train: bool):
        (x,) = xs
        # statistics in float32 whatever the activation dtype
        xf = x.float()
        mu = xf.mean(dim=-1, keepdim=True)
        var = ((xf - mu) ** 2).mean(dim=-1, keepdim=True)
        y = (xf - mu) * torch.rsqrt(var + self.eps)
        y = y * params["scale"] + params["bias"]
        return y.to(x.dtype), state

    def flops_per_sample(self) -> float:
        return 8.0 * self.output.shape[1] * self.d

    def param_bytes(self) -> int:
        return 8 * self.d


class AddSeq(_SeqElementwise):
    def __init__(self, name: str, pc: ParallelConfig, inputs: List[Tensor]):
        super().__init__(name, pc, inputs)
        if len(inputs) != 2 or inputs[0].shape != inputs[1].shape:
            raise ValueError("add_seq needs two inputs of one shape")
        self.output = Tensor(inputs[0].shape, inputs[0].dtype, self, name)

    def forward(self, params, state, xs: List, train: bool):
        return xs[0] + xs[1], state

    def flops_per_sample(self) -> float:
        return float(math.prod(self.output.shape[1:]))


class GeluSeq(_SeqElementwise):
    def __init__(self, name: str, pc: ParallelConfig, input: Tensor):
        super().__init__(name, pc, [input])
        if input.ndim != 3:
            raise ValueError("gelu input must be (batch, seq, d)")
        self.output = Tensor(input.shape, input.dtype, self, name)

    def forward(self, params, state, xs: List, train: bool):
        # jax.nn.gelu defaults to the tanh approximation
        return F.gelu(xs[0], approximate="tanh"), state

    def flops_per_sample(self) -> float:
        return 8.0 * float(math.prod(self.output.shape[1:]))


class PosEmbed(_SeqElementwise):
    """Learned positional embedding added to the token embedding."""

    def __init__(self, name: str, pc: ParallelConfig, input: Tensor):
        super().__init__(name, pc, [input])
        if input.ndim != 3:
            raise ValueError("pos_embed input must be (batch, seq, d)")
        self.seq_len = input.shape[1]
        self.d = input.shape[2]
        self.output = Tensor(input.shape, input.dtype, self, name)

    def init_params(self, gen, device) -> Dict:
        return {"table": torch.randn((self.seq_len, self.d), generator=gen,
                                     device=device) * 0.02}

    def param_specs(self):
        return {"table": ("s", None)}

    def forward(self, params, state, xs: List, train: bool):
        (x,) = xs
        return x + params["table"].to(x.dtype), state

    def param_bytes(self) -> int:
        return 4 * self.seq_len * self.d
