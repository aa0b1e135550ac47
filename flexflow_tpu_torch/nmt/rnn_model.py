"""RnnModel: the seq2seq NMT trainer (PyTorch port of
``flexflow_tpu/nmt/rnn_model.py``; the reference's nmt/rnn.cu).

The source and target sequences are cut into chunks of
``lstm_per_node_length`` steps (``src_chunk{i}``, ``dst_chunk{i}``).
Each chunk is embedded (``embed{i}``, sharing ``srcEmbed`` or
``dstEmbed``) and runs through one LSTM op per layer (``lstm{l}_{j}``,
sharing ``encoder{l}`` or ``decoder{l}``): the hidden state flows chunk
to chunk, the outputs layer to layer, and the first decoder chunk starts
from the last encoder chunk's state.  Each decoder chunk's top output
goes through the vocab projection (``linear{j}``, one shared ``linear``)
and the per-token softmax loss against the same chunk's target tokens
(``softmax{j}``).  In training each projection and its loss run as the
fused projection + cross-entropy op (kernels 4-6), so autograd sums the
chunks' gradients into the one ``linear`` leaf.

The loss is the NLL summed over the decoder chunks and divided by
``batch * seq_length``; the update is plain SGD at the model's learning
rate on those summed gradients (the reference applies ``w += -0.1 *
grad_sum``).

The strategy defaults to the reference's own (:func:`default_global_config`,
``nmt/nmt.cc:269-308``): the LSTMs, projections and losses data parallel
over the machine, the source embeds pinned to device 0 and the target
embeds to device 1.  :func:`pipeline_stage_strategy` places LSTM layer l
on device block ``l % S``.  Over several ranks each op runs on the ranks
its device list names (``parallel/placement.py``); the chunk ops sharing
``srcEmbed``, ``encoder{l}`` and the rest may sit on different ranks,
each holding the whole shared leaf, and the leaf's gradient is the sum
of every op's contribution, each counted once (the reference's
SharedVariable).  The loss is the sum over the ranks of their partial
NLLs.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import torch

from flexflow_tpu_torch.config import FFConfig
from flexflow_tpu_torch.machine import MachineModel
from flexflow_tpu_torch.model import FFModel
from flexflow_tpu_torch.ops.base import Tensor
from flexflow_tpu_torch.ops.embed import Embed
from flexflow_tpu_torch.ops.lstm import LSTMChunk
from flexflow_tpu_torch.ops.rnn_linear import RnnLinear
from flexflow_tpu_torch.ops.seq import SliceSeq
from flexflow_tpu_torch.ops.softmax_dp import SoftmaxDP
from flexflow_tpu_torch.strategy import ParallelConfig, Strategy


@dataclasses.dataclass
class RnnConfig:
    """The JAX package's defaults (the reference's nmt/nmt.cc:34-44)."""

    batch_size: int = 64
    num_layers: int = 2
    seq_length: int = 20
    hidden_size: int = 2048
    embed_size: int = 2048
    vocab_size: int = 20 * 1024
    lstm_per_node_length: int = 10   # LSTM_PER_NODE_LENGTH, nmt/rnn.h:23
    learning_rate: float = 0.1
    num_iterations: int = 10
    compute_dtype: str = "float32"
    # parameter storage dtype ("bfloat16" = mixed precision with float32
    # masters in the optimizer state)
    param_dtype: str = "float32"
    seed: int = 0
    # run telemetry, sampled op timing and live metrics (forwarded to
    # FFConfig)
    obs_dir: str = ""
    run_id: str = ""
    op_time_every: int = 0
    metrics_path: str = ""
    # batches staged ahead by fit's DevicePrefetcher (forwarded to
    # FFConfig; JAX's default 2, where the port's FFConfig has 0)
    prefetch_depth: int = 2
    # checkpoints, the health guard and fault injection (forwarded to
    # FFConfig)
    ckpt_dir: str = ""
    ckpt_freq: int = 0
    on_divergence: str = "halt"
    max_rollbacks: int = 3
    fault_spec: str = ""
    # elastic training, its decomposed re-search and the asynchronous
    # checkpoint writer (forwarded to FFConfig)
    elastic: bool = False
    min_devices: int = 1
    research_budget_s: float = 30.0
    decompose: bool = False
    block_budget_s: float = 0.0
    boundary_refine_iters: int = 0
    ckpt_async: bool = False
    # regrowth, the drain and the step watchdog (forwarded to FFConfig)
    max_regrows: int = 1
    regrow_probes: int = 2
    drain_budget_s: float = 60.0
    hang_factor: float = 0.0
    hang_min_s: float = 60.0
    transient_reset_steps: int = 16
    # the driver's static plan check demotes degradations to warnings
    allow_degraded: bool = False
    # the verification switches (forwarded to FFConfig; SURVEY §4)
    params_init: str = "default"
    print_intermediates: bool = False
    dry_compile: bool = False

    @property
    def chunks_per_seq(self) -> int:
        return (self.seq_length + self.lstm_per_node_length - 1) \
            // self.lstm_per_node_length


def default_global_config(cfg: RnnConfig, machine: MachineModel) -> Strategy:
    """The reference's ``set_global_config`` (``nmt/nmt.cc:269-308``;
    ``flexflow_tpu/nmt/rnn_model.py:106``): LSTMs, projections and losses
    data parallel over all devices; source embeds pinned to device 0,
    target embeds to device 1."""
    s = Strategy()
    n = machine.num_devices
    devs = tuple(range(n))
    npc = cfg.chunks_per_seq
    for i in range(2 * npc):
        pinned = 0 if i < npc else min(1, n - 1)
        s[f"embed{i}"] = ParallelConfig((1,), (pinned,))
    for layer in range(cfg.num_layers):
        for j in range(2 * npc):
            s[f"lstm{layer}_{j}"] = ParallelConfig((n,), devs)
    for j in range(npc):
        s[f"linear{j}"] = ParallelConfig((1, n), devs)
        s[f"softmax{j}"] = ParallelConfig((n,), devs)
    return s


def pipeline_stage_strategy(cfg: RnnConfig, machine: MachineModel,
                            num_stages: int) -> Strategy:
    """LSTM layer ``l`` on device block ``l % num_stages``, the embeds on
    stage 0's block, the projections and losses data parallel over the
    machine (``flexflow_tpu/nmt/rnn_model.py:126``): the reference's
    pipeline, written as per-op device lists (``nmt/nmt.cc:269-308``).
    Chunk ops of adjacent layers on different blocks run at the same
    time, layer l on chunk j while layer l+1 is on chunk j-1."""
    n = machine.num_devices
    if num_stages < 1 or n % num_stages:
        raise ValueError(
            f"{num_stages} stages do not divide the {n}-device machine")
    per = n // num_stages
    blocks = [tuple(range(g * per, (g + 1) * per))
              for g in range(num_stages)]
    devs = tuple(range(n))
    npc = cfg.chunks_per_seq
    s = Strategy()
    for i in range(2 * npc):
        s[f"embed{i}"] = ParallelConfig((per,), blocks[0])
    for layer in range(cfg.num_layers):
        blk = blocks[layer % num_stages]
        for j in range(2 * npc):
            s[f"lstm{layer}_{j}"] = ParallelConfig((per,), blk)
    for j in range(npc):
        s[f"linear{j}"] = ParallelConfig((1, n), devs)
        s[f"softmax{j}"] = ParallelConfig((n,), devs)
    return s


#: the ``RnnConfig`` fields forwarded to ``FFConfig`` as they stand
#: (``flexflow_tpu/nmt/rnn_model.py:170-201``)
RUNTIME_FIELDS = (
    "obs_dir", "run_id", "op_time_every", "metrics_path", "prefetch_depth",
    "ckpt_dir", "ckpt_freq", "on_divergence", "max_rollbacks", "fault_spec",
    "elastic", "min_devices", "research_budget_s", "decompose",
    "block_budget_s", "boundary_refine_iters", "ckpt_async", "max_regrows",
    "regrow_probes", "drain_budget_s", "hang_factor", "hang_min_s",
    "transient_reset_steps", "params_init", "print_intermediates",
    "dry_compile")


class RnnModel(FFModel):
    def __init__(self, rnn_config: RnnConfig = None,
                 machine: Optional[MachineModel] = None,
                 strategies: Optional[Strategy] = None, device="cuda"):
        self.rnn = rnn_config or RnnConfig()
        machine = machine if machine is not None else MachineModel(device)
        if strategies is None:
            strategies = default_global_config(self.rnn, machine)
        ff_cfg = FFConfig(
            batch_size=self.rnn.batch_size,
            learning_rate=self.rnn.learning_rate,
            weight_decay=0.0,
            num_iterations=self.rnn.num_iterations,
            compute_dtype=self.rnn.compute_dtype,
            param_dtype=self.rnn.param_dtype,
            seed=self.rnn.seed,
            strategies=strategies,
            allow_degraded=self.rnn.allow_degraded,
            **{f: getattr(self.rnn, f) for f in RUNTIME_FIELDS},
        )
        super().__init__(ff_cfg, machine, device)
        self._build()

    def _build(self):
        cfg = self.rnn
        npc = cfg.chunks_per_seq
        chunk = cfg.lstm_per_node_length
        batch = cfg.batch_size
        self.src_tokens = self.create_input((batch, cfg.seq_length),
                                            "int32", "src_tokens")
        self.dst_tokens = self.create_input((batch, cfg.seq_length),
                                            "int32", "dst_tokens")

        srcs, dsts = [], []
        for i in range(npc):
            start = i * chunk
            length = min(chunk, cfg.seq_length - start)
            srcs.append(self._add(SliceSeq(
                f"src_chunk{i}", self._pc(f"src_chunk{i}", 1),
                self.src_tokens, start, length)))
            dsts.append(self._add(SliceSeq(
                f"dst_chunk{i}", self._pc(f"dst_chunk{i}", 1),
                self.dst_tokens, start, length)))

        embeds: List[Tensor] = []
        for i in range(2 * npc):
            embeds.append(self.embed(
                f"embed{i}", srcs[i] if i < npc else dsts[i - npc],
                cfg.vocab_size, cfg.embed_size,
                param_key="srcEmbed" if i < npc else "dstEmbed"))

        # lstm{layer}_{chunk}: encoder chunks, then decoder chunks
        out = embeds
        for i in range(cfg.num_layers):
            prev, layer_out = None, []
            for j in range(2 * npc):
                op = LSTMChunk(f"lstm{i}_{j}", self._pc(f"lstm{i}_{j}", 1),
                               out[j], prev.hy if prev else None,
                               prev.cy if prev else None, cfg.hidden_size,
                               param_key=f"encoder{i}" if j < npc
                               else f"decoder{i}")
                layer_out.append(self._add(op))
                prev = op
            out = layer_out

        self.loss_ops = []
        for j in range(npc):
            logits = self.seq_linear(f"linear{j}", out[npc + j],
                                     cfg.vocab_size, param_key="linear")
            self.softmax_seq(f"softmax{j}", logits, dsts[j])
            self.loss_ops.append(self.layers[-1])

    # ------------------------------------------------------------------

    def loss_fn(self, params, state, src, dst, train: bool = True):
        """``(loss, new_state)``: the NLL summed over every decoder chunk,
        divided by ``batch * seq_length`` (``rnn_model.py:286-295``).  Over
        several ranks each rank sums the blocks of each chunk's NLL that
        it counts (its batch rows; none where it holds a replica) and the
        partial sums are added up over the ranks."""
        from flexflow_tpu_torch.parallel import collectives

        inputs = {self.src_tokens.tid: src, self.dst_tokens.tid: dst}
        values, new_state = self.apply(params, state, inputs, train)
        total = torch.zeros((), device=self.device)
        for op in self.loss_ops:
            if not self.loss_counted(op, train):
                continue
            labels = values.get(("labels", op.name),
                                values.get(op.labels_tensor.tid))
            total = total + op.loss(values[op.output.tid], labels)
        total = total / (self.rnn.batch_size * self.rnn.seq_length)
        if self.sharded:
            total = collectives.global_sum(total,
                                           self.machine.world_group())
        return total, new_state

    def make_train_step(self):
        return self.make_sgd_step(self.rnn.learning_rate)

    def init_opt_state(self, params):
        # plain SGD carries no momentum buffers; mixed precision still
        # needs the float32 masters (None in float32)
        return self.master_opt_state(params)

    def fit(self, data_iter, num_iterations: Optional[int] = None,
            warmup: int = 1, log=print, rebuild=None):
        """``FFModel.fit`` over (src, dst) batches, plus
        ``sentences_per_sec``."""
        out = super().fit(data_iter,
                          num_iterations or self.rnn.num_iterations,
                          warmup, log, rebuild=rebuild)
        out["sentences_per_sec"] = out["images_per_sec"]
        return out


def synthetic_token_batches(batch_size: int, seq_length: int,
                            vocab_size: int, seed: int = 0, device="cuda",
                            machine=None):
    """Random (src, dst) int32 token pairs on ``device``, the JAX
    package's arrays for the same seed; with ``machine``, this rank's
    rows of each on its device."""
    from flexflow_tpu_torch.data import synthetic_token_stream

    return synthetic_token_stream(batch_size, seq_length, vocab_size, seed,
                                  streams=2, device=device, machine=machine)
