"""Transformer language model (PyTorch port of
``flexflow_tpu/models/transformer.py``): embeddings, N pre-norm blocks,
the vocab projection and a log-softmax head, with the JAX package's op
names (``embed``, ``pos_embed``, ``blk{i}_attn``, ..., ``lm_head``,
``softmax``) so that one strategy file and one parameter tree serve both
packages.  Training is plain SGD on the next-token loss (causal) or the
identity-label loss, through the fused LM head; mixture-of-experts blocks
come with a later slice and raise ``NotImplementedError``."""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from flexflow_tpu_torch.config import FFConfig
from flexflow_tpu_torch.machine import MachineModel
from flexflow_tpu_torch.model import FFModel
from flexflow_tpu_torch.strategy import Strategy


@dataclasses.dataclass
class TransformerConfig:
    batch_size: int = 16
    seq_length: int = 512
    num_layers: int = 12           # BERT-base / GPT-2 small
    d_model: int = 768
    num_heads: int = 12
    d_ff: int = 3072
    vocab_size: int = 32768
    causal: bool = False           # True = GPT-style next-token LM
    # Mixture-of-Experts (flexflow_tpu/ops/moe.py): not ported yet, any
    # num_experts > 0 raises NotImplementedError
    num_experts: int = 0
    moe_every: int = 1
    moe_top_k: int = 2
    moe_capacity_factor: float = 2.0
    moe_aux_weight: float = 1e-2
    learning_rate: float = 1e-3
    num_iterations: int = 10
    compute_dtype: str = "float32"
    # parameter storage dtype ("bfloat16" = mixed precision with float32
    # masters in the optimizer state)
    param_dtype: str = "float32"
    seed: int = 0
    # "default" only: the JAX package's "ones" init is not ported yet
    params_init: str = "default"


class TransformerLM(FFModel):
    """Token-level LM: embeddings -> N pre-norm blocks -> vocab projection
    -> per-token log-probs."""

    def __init__(self, t_config: TransformerConfig = None,
                 machine: Optional[MachineModel] = None,
                 strategies: Optional[Strategy] = None, device="cuda"):
        self.t = t_config or TransformerConfig()
        if self.t.num_experts > 0:
            raise NotImplementedError(
                "mixture-of-experts blocks (num_experts > 0) are not ported "
                "to flexflow_tpu_torch yet (flexflow_tpu/ops/moe.py)")
        if self.t.params_init != "default":
            raise NotImplementedError(
                f"params_init={self.t.params_init!r} is not ported to "
                f"flexflow_tpu_torch yet")
        ff_cfg = FFConfig(
            batch_size=self.t.batch_size,
            learning_rate=self.t.learning_rate,
            weight_decay=0.0,
            num_iterations=self.t.num_iterations,
            compute_dtype=self.t.compute_dtype,
            param_dtype=self.t.param_dtype,
            seed=self.t.seed,
            strategies=strategies or Strategy(),
        )
        super().__init__(ff_cfg, machine, device)
        self._build()

    def _build(self):
        t = self.t
        self.tokens = self.create_input((t.batch_size, t.seq_length),
                                        "int32", "tokens")
        self.labels = self.create_input((t.batch_size, t.seq_length),
                                        "int32", "labels")
        x = self.embed("embed", self.tokens, t.vocab_size, t.d_model)
        x = self.pos_embed("pos_embed", x)
        for i in range(t.num_layers):
            h = self.layer_norm(f"blk{i}_ln1", x)
            h = self.attention(f"blk{i}_attn", h, t.num_heads,
                               causal=t.causal)
            x = self.add_seq(f"blk{i}_res1", x, h)
            h = self.layer_norm(f"blk{i}_ln2", x)
            h = self.seq_linear(f"blk{i}_ff1", h, t.d_ff)
            h = self.gelu_seq(f"blk{i}_gelu", h)
            h = self.seq_linear(f"blk{i}_ff2", h, t.d_model)
            x = self.add_seq(f"blk{i}_res2", x, h)
        x = self.layer_norm("final_ln", x)
        logits = self.seq_linear("lm_head", x, t.vocab_size)
        self.softmax_seq("softmax", logits, self.labels)
        self.loss_op = self.layers[-1]

    # ------------------------------------------------------------------

    def loss_fn(self, params, state, tokens, labels, train: bool = True):
        """``(loss, new_state)``: the NLL summed over the targets and
        divided by their count (``transformer.py:178-201``).  A causal
        model predicts the next token: labels shift left by one and the
        last position gets -1, no target."""
        if self.t.causal:
            labels = torch.cat(
                [labels[:, 1:],
                 torch.full((labels.shape[0], 1), -1, dtype=labels.dtype,
                            device=labels.device)], dim=1)
        inputs = {self.tokens.tid: tokens, self.labels.tid: labels}
        values, new_state = self.apply(params, state, inputs, train)
        op = self.loss_op
        total = op.loss(values[op.output.tid], values[op.labels_tensor.tid])
        n_targets = self.t.batch_size * (self.t.seq_length - 1
                                         if self.t.causal
                                         else self.t.seq_length)
        return total / n_targets, new_state

    def make_train_step(self):
        return self.make_sgd_step(self.t.learning_rate)

    def init_opt_state(self, params):
        # plain SGD carries no momentum buffers; mixed precision still
        # needs the float32 masters (None in float32)
        return self.master_opt_state(params)
