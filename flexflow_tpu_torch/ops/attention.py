"""Multi-head self-attention (PyTorch port of ``flexflow_tpu/ops/attention.py``).

q/k/v/o projections as in the JAX op, heads laid out (B, H, S, d); the
attention itself is the port's differentiable flash attention
(ops/kernels/flash_attention.py): the CUDA forward and backward kernels
on a GPU, their plain versions on the CPU, for serving (under
``inference_mode`` only the forward runs) and for training alike.  Its
float32 output is cast back to the activation dtype.

Over several ranks the grid is (s, h, n) (``attention.py:30``): the
input arrives batch-split over ``n`` and sequence-split over ``s``,
whole over the features; ``wq``, ``wk`` and ``wv`` are column-sharded by
``h`` and ``wo`` row-sharded (``attention.py:60-65``), so each rank
projects its block of heads.  Where ``s`` is 1 each rank runs the flash
kernels on its (B/n, H/h, S, d) block; where it is above 1 it runs
``parallel/ring_attention.py`` over its ``s`` group.  The ``wo``
products are partial sums over the head blocks, all-reduced over the
``h`` group, and ``bo`` is added once, after the sum.  JAX rings only
over the whole machine in natural order (``_use_ring``, ``:79-82``) and
otherwise runs GSPMD's blockwise attention, the same function; the port
rings over the ``s`` group of any grid.
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

    def param_specs(self):
        return {"wq": (None, "h"), "wk": (None, "h"), "wv": (None, "h"),
                "wo": ("h", None)}

    def output_spec(self):
        return ("n", "s", None)

    def regrid_input_specs(self):
        return [("n", "s", None)]

    def validate_partitioning(self) -> None:
        super().validate_partitioning()
        ph = self.pc.dims[1]
        if self.num_heads % ph:
            raise ValueError(
                f"op {self.name!r}: {self.num_heads} heads not divisible by "
                f"its head partition count {ph} (grid {self.pc.dims})")

    def grid_collectives(self):
        ps, ph, _ = self.pc.dims
        return [(a,) for a, parts in (("s", ps), ("h", ph)) if parts > 1]

    def _heads(self, params, x):
        """q, k, v (B, H', S', hd) of x (B, S', d) for the head columns of
        the projections in ``params``."""
        b, s, _ = x.shape

        def proj(w):
            y = torch.matmul(x, w.to(x.dtype))
            return y.view(b, s, -1, self.head_dim).transpose(1, 2) \
                .contiguous()

        return proj(params["wq"]), proj(params["wk"]), proj(params["wv"])

    def _out(self, params, out, x):
        """The wo product of the (B, H', S', hd) attention output."""
        b, s, _ = x.shape
        out = out.to(x.dtype).transpose(1, 2).reshape(b, s, -1)
        return torch.matmul(out, params["wo"].to(x.dtype))

    def forward(self, params, state, xs: List, train: bool):
        (x,) = xs
        q, k, v = self._heads(params, x)
        out = flash_attention(q, k, v, self.causal)
        y = self._out(params, out, x)
        return y + params["bo"].to(x.dtype), state

    def sharded_forward(self, params, state, xs: List, train: bool, grid):
        from flexflow_tpu_torch.parallel.ring_attention import \
            ring_attention

        (x,) = xs
        q, k, v = self._heads(params, x)
        if grid.parts("s") > 1:
            out = ring_attention(
                q, k, v, grid.group(("s",)), grid.index("s"), self.causal,
                "p2p" if grid.machine.send_recv else "gather")
        else:
            out = flash_attention(q, k, v, self.causal)
        # each head block's wo product is a partial sum over the heads
        y = grid.all_reduce(self._out(params, out, x), ("h",))
        return y + params["bo"].to(x.dtype), state

    # ---- cost model (attention.py:154-175) ----------------------------

    def local_clone(self, pc: ParallelConfig):
        ps, ph, pn = pc.dims
        n, s, d = self.inputs[0].shape
        # a shard-shaped clone cannot represent the ring's (S/ps) x S
        # scores nor the head split's d x d/ph projections: those grids
        # take the analytic cost, whose flops / num_parts is exact there
        if ps > 1 or ph > 1 or n % pn:
            return None
        t = Tensor((n // pn, s, d))
        return MultiHeadAttention(self.name, ParallelConfig((1, 1, 1), (0,)),
                                  t, self.num_heads, self.causal)

    def flops_per_sample(self) -> float:
        s, d = self.output.shape[1], self.d_model
        return 8.0 * s * d * d + 4.0 * s * s * d

    def param_bytes(self) -> int:
        return 4 * (4 * self.d_model * self.d_model + self.d_model)
