"""Softmax + cross-entropy loss over (batch, classes) (PyTorch port of
``flexflow_tpu/ops/softmax.py``): float32 log-softmax forward, and the
mean NLL over the global batch as the loss.  Over several ranks each
rank holds a batch block: the model sums its NLL (:meth:`Softmax.nll_sum`)
and adds the ranks' partial sums up (``FFModel.loss_fn``)."""

from __future__ import annotations

from typing import List

import torch

from flexflow_tpu_torch.ops.base import Op, Tensor
from flexflow_tpu_torch.strategy import ParallelConfig


class Softmax(Op):
    AXIS_NAMES = ("n",)
    is_loss = True

    def __init__(self, name: str, pc: ParallelConfig, input: Tensor):
        super().__init__(name, pc, [input])
        if input.ndim != 2:
            raise ValueError("softmax input must be (batch, classes)")
        self.num_classes = input.shape[1]
        self.output = Tensor(input.shape, "float32", self, name)

    def output_spec(self):
        return ("n", None)

    def regrid_input_specs(self):
        return [("n", None)]

    def flops_per_sample(self) -> float:
        return 5.0 * self.num_classes

    def forward(self, params, state, xs: List, train: bool):
        (x,) = xs
        return torch.log_softmax(x.float(), dim=-1), state

    def loss(self, log_probs, labels):
        """Mean NLL over the batch; labels are integer class ids (int32
        labels are widened for the gather)."""
        nll = -log_probs.gather(1, labels.long()[:, None])
        return nll.mean()

    def nll_sum(self, log_probs, labels):
        """The summed NLL of a block of rows."""
        return -log_probs.gather(1, labels.long()[:, None]).sum()
