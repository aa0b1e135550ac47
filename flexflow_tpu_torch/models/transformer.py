"""Transformer language model (PyTorch port of
``flexflow_tpu/models/transformer.py``): embeddings, N pre-norm blocks,
the vocab projection and a log-softmax head, with the JAX package's op
names (``embed``, ``pos_embed``, ``blk{i}_attn``, ..., ``lm_head``,
``softmax``) so that one strategy file and one parameter tree serve both
packages.  Mixture-of-experts blocks and training come with later
slices."""

from __future__ import annotations

import dataclasses
from typing import Optional

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
    compute_dtype: str = "float32"
    param_dtype: str = "float32"
    seed: int = 0


class TransformerLM(FFModel):
    """Token-level LM: embeddings -> N pre-norm blocks -> vocab projection
    -> per-token log-probs."""

    def __init__(self, t_config: TransformerConfig = None,
                 machine: Optional[MachineModel] = None,
                 strategies: Optional[Strategy] = None, device="cuda"):
        self.t = t_config or TransformerConfig()
        ff_cfg = FFConfig(
            batch_size=self.t.batch_size,
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
