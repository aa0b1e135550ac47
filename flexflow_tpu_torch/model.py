"""FFModel: the layer DAG and its forward (PyTorch port of
``flexflow_tpu/model.py``).

The graph-building methods append named ops to ``self.layers`` in
topological order, each taking its ParallelConfig from
``config.strategies`` or the machine's pure-DP default.  ``init`` builds
the parameter tree ``{param_key: {leaf: tensor}}`` the JAX package
builds, ``apply`` walks
the layers in order, and ``make_predict_step`` is the serving path's
forward-only step.  Placement over several devices, regrids, donation,
the fused LM-head loss and training arrive with later slices.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

import torch

from flexflow_tpu_torch.config import FFConfig
from flexflow_tpu_torch.machine import MachineModel
from flexflow_tpu_torch.ops.base import Op, Tensor, torch_dtype
from flexflow_tpu_torch.strategy import ParallelConfig, validate_strategy


class FFModel:
    def __init__(self, config: Optional[FFConfig] = None,
                 machine: Optional[MachineModel] = None, device="cuda"):
        self.config = config or FFConfig()
        self.machine = machine if machine is not None \
            else MachineModel(device)
        validate_strategy(self.config.strategies, self.machine.num_devices)
        self.layers: List[Op] = []
        self._inputs: List[Tensor] = []

    @property
    def device(self) -> torch.device:
        return self.machine.device

    # ------------------------------------------------------------------
    # graph building

    def _pc(self, name: str, ndims: int) -> ParallelConfig:
        pc = self.config.strategies.get(name)
        if pc is None:
            pc = self.machine.default_pc(ndims)
        return pc

    def _add(self, op: Op) -> Tensor:
        if any(s <= 0 for s in op.output.shape):
            raise ValueError(f"op {op.name!r} produces an empty tensor "
                             f"{op.output.shape}")
        self.layers.append(op)
        return op.output

    def create_input(self, shape, dtype: str = "float32",
                     name: str = "input") -> Tensor:
        t = Tensor(shape, dtype, None, name)
        self._inputs.append(t)
        return t

    def embed(self, name, input, vocab_size, embed_size,
              param_key: str = None) -> Tensor:
        from flexflow_tpu_torch.ops.embed import Embed

        return self._add(Embed(name, self._pc(name, 1), input, vocab_size,
                               embed_size, param_key,
                               compute_dtype=self.config.compute_dtype))

    def pos_embed(self, name, input) -> Tensor:
        from flexflow_tpu_torch.ops.seq_common import PosEmbed

        return self._add(PosEmbed(name, self._pc(name, 2), input))

    def layer_norm(self, name, input) -> Tensor:
        from flexflow_tpu_torch.ops.seq_common import LayerNormSeq

        return self._add(LayerNormSeq(name, self._pc(name, 2), input))

    def add_seq(self, name, x: Tensor, y: Tensor) -> Tensor:
        from flexflow_tpu_torch.ops.seq_common import AddSeq

        return self._add(AddSeq(name, self._pc(name, 2), [x, y]))

    def gelu_seq(self, name, input) -> Tensor:
        from flexflow_tpu_torch.ops.seq_common import GeluSeq

        return self._add(GeluSeq(name, self._pc(name, 2), input))

    def attention(self, name, input, num_heads,
                  causal: bool = False) -> Tensor:
        from flexflow_tpu_torch.ops.attention import MultiHeadAttention

        return self._add(MultiHeadAttention(
            name, self._pc(name, 3), input, num_heads, causal))

    def seq_linear(self, name, input, out_channels,
                   param_key: str = None) -> Tensor:
        from flexflow_tpu_torch.ops.rnn_linear import RnnLinear

        return self._add(RnnLinear(name, self._pc(name, 2), input,
                                   out_channels, param_key))

    def softmax_seq(self, name, logits: Tensor, labels: Tensor) -> Tensor:
        from flexflow_tpu_torch.ops.softmax_dp import SoftmaxDP

        return self._add(SoftmaxDP(name, self._pc(name, 1), logits, labels))

    def _loss_op(self) -> Op:
        for op in reversed(self.layers):
            if getattr(op, "is_loss", False):
                return op
        raise ValueError("model has no loss (softmax) layer")

    # ------------------------------------------------------------------
    # parameters

    def init(self, seed: Optional[int] = None):
        """(params, state) on the model's device, drawn in layer order from
        one ``torch.Generator`` seeded with ``seed`` (default
        ``config.seed``).  Shared ``param_key``s initialize once."""
        seed = self.config.seed if seed is None else seed
        gen = torch.Generator(device=self.device)
        gen.manual_seed(int(seed))
        params: Dict[str, Dict] = {}
        for op in self.layers:
            if op.param_key in params:
                continue
            p = op.init_params(gen, self.device)
            if p:
                params[op.param_key] = self._cast_param_tree(p)
        return params, {}

    def _mixed_precision(self) -> bool:
        return (self.config.param_dtype or "float32") != "float32"

    def _cast_param_tree(self, p):
        """Store float leaves in ``config.param_dtype``."""
        if not self._mixed_precision():
            return p
        dt = torch_dtype(self.config.param_dtype)
        return {k: v.to(dt) if v.is_floating_point() else v
                for k, v in p.items()}

    # ------------------------------------------------------------------
    # execution

    def apply(self, params, state, inputs: Dict[int, Any], train: bool):
        """Run the DAG. ``inputs`` maps input-Tensor tid -> tensor.
        Returns (tensor-values dict, new_state)."""
        values: Dict[int, Any] = dict(inputs)
        new_state: Dict[str, Dict] = {}
        for op in self.layers:
            xs = [values[t.tid] for t in op.inputs]
            y, st = op.forward(params.get(op.param_key, {}),
                               state.get(op.name, {}), xs, train)
            values[op.output.tid] = y
            if st:
                new_state[op.name] = st
        return values, new_state

    def make_predict_step(self, output_tids=None):
        """Forward-only inference step, the serving path.  Returns
        ``predict(params, state, *batch) -> tuple of tensors`` for
        ``output_tids`` in order (default: the loss op's log-probs).
        Positional ``batch`` arrays (numpy or tensors) align with
        ``self._inputs``; they are moved to the model's device, float
        ones cast to the compute dtype.  Under mixed precision the float
        params are cast to the compute dtype for the step."""
        tids = tuple(output_tids) if output_tids is not None \
            else (self._loss_op().output.tid,)
        cdtype = torch_dtype(self.config.compute_dtype)
        device = self.device

        def predict_step(params, state, *batch):
            with torch.inference_mode():
                if self._mixed_precision():
                    params = {
                        key: {k: v.to(cdtype) if v.is_floating_point()
                              else v for k, v in leaves.items()}
                        for key, leaves in params.items()}
                inputs = {}
                for t, b in zip(self._inputs, batch):
                    b = torch.as_tensor(b, device=device)
                    if b.is_floating_point():
                        b = b.to(cdtype)
                    inputs[t.tid] = b
                values, _ = self.apply(params, state, inputs, train=False)
                return tuple(values[tid] for tid in tids)

        return predict_step
