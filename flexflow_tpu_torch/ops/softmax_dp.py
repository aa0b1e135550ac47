"""Log-softmax head and loss of the sequence models (PyTorch port of
``flexflow_tpu/ops/softmax_dp.py``).  The forward is what serving reads;
``loss`` is the training loss, over the log-probs or, when the model's
LM-head fusion ran the projection and the loss together
(``FFModel._lm_head_fusion``), over the fused op's per-token NLL.
Over several ranks the grid is (n,): each rank holds a batch block of
the log-probs and of the labels, whole over the vocab, and the model
adds the ranks' partial sums up (``FFModel.loss_fn``).  The JAX op has
no placed form, so a device subset normalizes."""

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

    def output_spec(self):
        return ("n", None, None)

    def regrid_input_specs(self):
        return [("n", None, None), ("n", None)]

    def forward(self, params, state, xs: List, train: bool):
        logits, _ = xs
        return torch.log_softmax(logits.float(), dim=-1), state

    def loss(self, log_probs, labels):
        """Sum of the NLL over the tokens whose label is not negative
        (label -1 = no target, e.g. the final position of a causal
        next-token shift).  ``log_probs`` (n, s, V) are log-probs; an
        (n, s) value is already the per-token NLL of the fused head."""
        valid = labels >= 0
        if log_probs.dim() == labels.dim():
            return torch.where(valid, log_probs,
                               torch.zeros_like(log_probs)).sum()
        safe = torch.where(valid, labels, torch.zeros_like(labels)).long()
        nll = -log_probs.gather(-1, safe[..., None])[..., 0]
        return torch.where(valid, nll, torch.zeros_like(nll)).sum()
