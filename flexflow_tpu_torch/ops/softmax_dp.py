"""Log-softmax head of the sequence models (PyTorch port of
``flexflow_tpu/ops/softmax_dp.py``).  The forward is what serving reads;
the loss comes with the training slice."""

from __future__ import annotations

from typing import List

import torch

from flexflow_tpu_torch.ops.base import Op, Tensor
from flexflow_tpu_torch.strategy import ParallelConfig


class SoftmaxDP(Op):
    AXIS_NAMES = ("n",)
    is_loss = True

    def __init__(self, name: str, pc: ParallelConfig, logits: Tensor,
                 labels: Tensor):
        super().__init__(name, pc, [logits, labels])
        if logits.ndim != 3 or labels.ndim != 2 \
                or logits.shape[:2] != labels.shape:
            raise ValueError("softmax_seq needs (n, s, V) logits and (n, s) "
                             "labels")
        self.labels_tensor = labels
        self.output = Tensor(logits.shape, "float32", self, name)

    def forward(self, params, state, xs: List, train: bool):
        logits, _ = xs
        return torch.log_softmax(logits.float(), dim=-1), state
