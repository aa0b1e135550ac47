"""Multi-head self-attention (PyTorch port of ``flexflow_tpu/ops/attention.py``).

q/k/v/o projections as in the JAX op, heads laid out (B, H, S, d); the
attention itself is the port's differentiable flash attention
(ops/kernels/flash_attention.py): the CUDA forward and backward kernels
on a GPU, their plain versions on the CPU, for serving (under
``inference_mode`` only the forward runs) and for training alike.  Its
float32 output is cast back to the activation dtype.  Ring attention
over a sequence-sharded grid comes with the multi-GPU slice.
"""

from __future__ import annotations

from typing import Dict, List

import torch

from flexflow_tpu_torch.ops.base import Op, Tensor, glorot_uniform
from flexflow_tpu_torch.ops.kernels.flash_attention import flash_attention
from flexflow_tpu_torch.strategy import ParallelConfig


class MultiHeadAttention(Op):
    AXIS_NAMES = ("s", "h", "n")

    def __init__(self, name: str, pc: ParallelConfig, input: Tensor,
                 num_heads: int, causal: bool = False):
        super().__init__(name, pc, [input])
        if input.ndim != 3:
            raise ValueError("attention input must be (batch, seq, d)")
        n, s, d = input.shape
        if d % num_heads:
            raise ValueError("d_model must divide into heads")
        self.num_heads = num_heads
        self.head_dim = d // num_heads
        self.d_model = d
        self.causal = causal
        self.output = Tensor(input.shape, input.dtype, self, name)

    def init_params(self, gen, device) -> Dict:
        d = self.d_model
        p = {w: glorot_uniform((d, d), gen, device)
             for w in ("wq", "wk", "wv", "wo")}
        p["bo"] = torch.zeros((d,), device=device)
        return p

    def forward(self, params, state, xs: List, train: bool):
        (x,) = xs
        b, s, d = x.shape
        h, hd = self.num_heads, self.head_dim

        def proj(w):
            y = torch.matmul(x, w.to(x.dtype))
            return y.view(b, s, h, hd).transpose(1, 2).contiguous()

        q, k, v = proj(params["wq"]), proj(params["wk"]), proj(params["wv"])
        out = flash_attention(q, k, v, self.causal)
        out = out.to(x.dtype).transpose(1, 2).reshape(b, s, d)
        y = torch.matmul(out, params["wo"].to(x.dtype))
        return y + params["bo"].to(x.dtype), state
