"""Transformer language model (PyTorch port of
``flexflow_tpu/models/transformer.py``): embeddings, N pre-norm blocks,
the vocab projection and a log-softmax head, with the JAX package's op
names (``embed``, ``pos_embed``, ``blk{i}_attn``, ..., ``lm_head``,
``softmax``) so that one strategy file and one parameter tree serve both
packages.  With ``num_experts`` > 0 every ``moe_every``-th block's FFN is
a top-k mixture of experts (``blk{i}_moe``, ``ops/moe.py``) whose
load-balancing loss joins the training objective.  Training is plain SGD
on the next-token loss (causal) or the identity-label loss, through the
fused LM head.

On a machine of several ranks every op runs on the grid and device list
its strategy entry names (``FFModel``): the sequence ops split the
sequence, the attention heads or the sequence in a ring, the MLP and
vocab projections the channels, and a vocab-split head runs fused
(``FFModel._run_fused_lm_head``).  Each rank takes its batch rows
(``FFModel.local_batch``); the loss is the global batch's on every rank.
A MoE block runs on its (e, c, n) grid (``ops/moe.py``): experts split
over e, their hidden channels over c, the batch over n; its aux loss,
a global mean on every rank, counts once per n block
(``FFModel.aux_counted``).  The GPipe pipelined form of the dense stack
is ``parallel/pipeline.py``'s ``PipelinedLM``."""

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
    # mixture of experts (ops/moe.py): num_experts > 0 replaces the dense
    # FFN of every moe_every-th block with a top-k-routed MoE
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
    # the strategy file --strategy names ("" = none; apps.lm loads it)
    strategy_file: str = ""
    # the GPipe pipelined path (apps.lm, parallel/pipeline.py): stages
    # (> 1 takes it), microbatches (0 = as many as stages) and the
    # stage-internal tensor-parallel degree (0 = 1)
    pipeline_stages: int = 0
    microbatches: int = 0
    pipeline_tp: int = 0
    # the training runtime (forwarded to FFConfig; FFModel.fit)
    prefetch_depth: int = 0
    ckpt_dir: str = ""
    ckpt_freq: int = 0
    on_divergence: str = "halt"
    max_rollbacks: int = 3
    fault_spec: str = ""
    ckpt_async: bool = False
    hang_factor: float = 0.0
    hang_min_s: float = 60.0
    drain_budget_s: float = 60.0
    metrics_path: str = ""
    # run telemetry and sampled op timing (forwarded to FFConfig)
    obs_dir: str = ""
    run_id: str = ""
    obs_max_bytes: int = 64 * 1024 * 1024
    op_time_every: int = 0
    # the driver's static plan check demotes degradations to warnings
    allow_degraded: bool = False


class TransformerLM(FFModel):
    """Token-level LM: embeddings -> N pre-norm blocks -> vocab projection
    -> per-token log-probs."""

    def __init__(self, t_config: TransformerConfig = None,
                 machine: Optional[MachineModel] = None,
                 strategies: Optional[Strategy] = None, device="cuda"):
        self.t = t_config or TransformerConfig()
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
            prefetch_depth=self.t.prefetch_depth,
            ckpt_dir=self.t.ckpt_dir,
            ckpt_freq=self.t.ckpt_freq,
            on_divergence=self.t.on_divergence,
            max_rollbacks=self.t.max_rollbacks,
            fault_spec=self.t.fault_spec,
            ckpt_async=self.t.ckpt_async,
            hang_factor=self.t.hang_factor,
            hang_min_s=self.t.hang_min_s,
            drain_budget_s=self.t.drain_budget_s,
            metrics_path=self.t.metrics_path,
            obs_dir=self.t.obs_dir,
            run_id=self.t.run_id,
            obs_max_bytes=self.t.obs_max_bytes,
            op_time_every=self.t.op_time_every,
            allow_degraded=self.t.allow_degraded,
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
        self._moe_ops = []
        for i in range(t.num_layers):
            h = self.layer_norm(f"blk{i}_ln1", x)
            h = self.attention(f"blk{i}_attn", h, t.num_heads,
                               causal=t.causal)
            x = self.add_seq(f"blk{i}_res1", x, h)
            h = self.layer_norm(f"blk{i}_ln2", x)
            if t.num_experts > 0 and i % t.moe_every == 0:
                h = self.moe(f"blk{i}_moe", h, t.num_experts, t.d_ff,
                             t.moe_top_k, t.moe_capacity_factor)
                self._moe_ops.append(self.layers[-1])
            else:
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
        last position gets -1, no target.  In training each MoE block's
        load-balancing loss joins, weighted by ``moe_aux_weight``; the
        eval loss stays the plain NLL."""
        if self.t.causal:
            labels = torch.cat(
                [labels[:, 1:],
                 torch.full((labels.shape[0], 1), -1, dtype=labels.dtype,
                            device=labels.device)], dim=1)
        from flexflow_tpu_torch.parallel import collectives

        inputs = {self.tokens.tid: tokens, self.labels.tid: labels}
        values, new_state = self.apply(params, state, inputs, train)
        op = self.loss_op
        total = op.loss(values[op.output.tid],
                        values.get(("labels", op.name),
                                   values[op.labels_tensor.tid]))
        if self.sharded:
            if not self.loss_counted(op, train):
                total = total * 0   # a replica's block counts once
            total = collectives.global_sum(total,
                                           self.machine.world_group())
        n_targets = self.t.batch_size * (self.t.seq_length - 1
                                         if self.t.causal
                                         else self.t.seq_length)
        loss = total / n_targets
        if train:
            for op in self._moe_ops:
                aux = values[op.aux.tid]
                if not self.aux_counted(op):
                    aux = aux.detach()   # the same value, counted once
                loss = loss + self.t.moe_aux_weight * aux
        return loss, new_state

    def moe_stats(self, params, state, tokens) -> dict:
        """``{"aux": [...], "dropped": [...]}``, one entry per MoE block:
        its load-balancing loss and the share of its (token, choice)
        pairs dropped at capacity, from one forward pass of ``tokens``
        (float32 params)."""
        from flexflow_tpu_torch.ops.moe import MixtureOfExperts

        with torch.inference_mode():
            (toks,) = self._batch(tokens)
            values, _ = self.apply(
                params, state, {self.tokens.tid: toks,
                                self.labels.tid: toks}, train=False)
            ops = [op for op in self.layers
                   if isinstance(op, MixtureOfExperts)]
            return {"aux": [float(values[op.aux.tid]) for op in ops],
                    "dropped": [op.dropped_share(params[op.param_key],
                                                 values[op.inputs[0].tid])
                                for op in ops]}

    def make_train_step(self):
        return self.make_sgd_step(self.t.learning_rate)

    def init_opt_state(self, params):
        # plain SGD carries no momentum buffers; mixed precision still
        # needs the float32 masters (None in float32)
        return self.master_opt_state(params)
