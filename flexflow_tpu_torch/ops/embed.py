"""Token embedding (PyTorch port of ``flexflow_tpu/ops/embed.py``).

Over several ranks the grid is (n,): each rank embeds its batch block of
ids with the whole table.  A one-point grid on one device (the NMT
strategies' pinned embeds) runs there alone, and only that rank holds
the table (``parallel/placement.py``)."""

from __future__ import annotations

from typing import Dict, List

import torch

from flexflow_tpu_torch.ops.base import Op, Tensor, torch_dtype
from flexflow_tpu_torch.strategy import ParallelConfig


class Embed(Op):
    AXIS_NAMES = ("n",)

    def __init__(self, name: str, pc: ParallelConfig, input: Tensor,
                 vocab_size: int, embed_size: int,
                 param_key: str = None, compute_dtype: str = "float32"):
        super().__init__(name, pc, [input])
        if input.ndim != 2:
            raise ValueError("embed input must be (batch, length) int ids")
        self.vocab_size = vocab_size
        self.embed_size = embed_size
        # token models have no float graph input, so the model's compute
        # dtype is applied here, at the source of the float path
        self.compute_dtype = compute_dtype
        if param_key:
            self.param_key = param_key
        n, length = input.shape
        self.output = Tensor((n, length, embed_size), compute_dtype, self,
                             name)

    def init_params(self, gen, device) -> Dict:
        table = torch.randn((self.vocab_size, self.embed_size),
                            generator=gen, device=device) * 0.05
        return {"table": table}

    def output_spec(self):
        return ("n", None, None)

    def regrid_input_specs(self):
        return [("n", None)]

    def placement_signature(self):
        return (self.vocab_size, self.embed_size, self.compute_dtype)

    def input_specs(self, pc=None):
        return [("n", None)]

    def param_bytes(self) -> int:
        return 4 * self.vocab_size * self.embed_size

    def forward(self, params, state, xs: List, train: bool):
        (ids,) = xs
        # gather first, cast after: no whole-vocab low-precision copy.
        # jnp.take clips out-of-range ids where torch indexing raises; the
        # pad id 0 is in range, so every id the engine feeds is too.
        rows = params["table"][ids.long()]
        return rows.to(torch_dtype(self.compute_dtype)), state
