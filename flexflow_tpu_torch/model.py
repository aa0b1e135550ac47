"""FFModel: the layer DAG, its forward and its training step (PyTorch
port of ``flexflow_tpu/model.py``).

The graph-building methods append named ops to ``self.layers`` in
topological order, each taking its ParallelConfig from
``config.strategies`` or the machine's pure-DP default.  ``init`` builds
the parameter tree ``{param_key: {leaf: tensor}}`` and the per-op state
tree (BatchNorm's running statistics) the JAX package builds, ``apply``
walks the layers in order (for training with the
LM-head fusion: a vocab projection whose only consumer is the sequence
loss runs with it as one fused projection + cross-entropy op),
``make_predict_step`` is the serving path's forward-only step, and
``make_train_step`` / ``make_eval_step`` / ``fit`` are the training path:
momentum SGD with weight decay for the CNNs, plain SGD
(``make_sgd_step``) for the sequence models, each with float32 or
mixed-precision (float32 masters) parameters.

Gradients come from ``torch.autograd``.  A tensor read by several ops
gets the sum of their gradients from autograd itself; the JAX package's
``grad_fanout`` tree (``ops/fanout.py``) only fixes where XLA adds them,
and the parity tests hold without it.  Placement over several devices,
regrids, checkpoints and the fault-tolerant runtime arrive with later
slices.
"""

from __future__ import annotations

import collections
import time
from typing import Any, Dict, List, Optional

import torch

from flexflow_tpu_torch.config import FFConfig
from flexflow_tpu_torch.machine import MachineModel
from flexflow_tpu_torch.ops.base import Op, Tensor, torch_dtype
from flexflow_tpu_torch.strategy import ParallelConfig, validate_strategy

#: suffix of the float32 master leaves in a mixed-precision optimizer state
MASTER_SUFFIX = "__master"


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
        for t in op.all_outputs():
            if any(s <= 0 for s in t.shape):
                raise ValueError(f"op {op.name!r} produces an empty tensor "
                                 f"{t.shape}")
        self.layers.append(op)
        return op.output

    def create_input(self, shape, dtype: str = "float32",
                     name: str = "input") -> Tensor:
        t = Tensor(shape, dtype, None, name)
        self._inputs.append(t)
        return t

    def conv2d(self, name, input, out_channels, kernel_h, kernel_w,
               stride_h, stride_w, padding_h, padding_w,
               relu: bool = False) -> Tensor:
        from flexflow_tpu_torch.ops.conv import Conv2D

        return self._add(Conv2D(name, self._pc(name, 4), input, out_channels,
                                kernel_h, kernel_w, stride_h, stride_w,
                                padding_h, padding_w, relu))

    def pool2d(self, name, input, kernel_h, kernel_w, stride_h, stride_w,
               padding_h, padding_w, pool_type: str = "max",
               relu: bool = True) -> Tensor:
        from flexflow_tpu_torch.ops.pool import Pool2D

        return self._add(Pool2D(name, self._pc(name, 4), input, kernel_h,
                                kernel_w, stride_h, stride_w, padding_h,
                                padding_w, pool_type, relu))

    def batch_norm(self, name, input, relu: bool = True) -> Tensor:
        from flexflow_tpu_torch.ops.norm import BatchNorm

        return self._add(BatchNorm(name, self._pc(name, 4), input, relu))

    def linear(self, name, input, out_channels, relu: bool = True) -> Tensor:
        from flexflow_tpu_torch.ops.linear import Linear

        return self._add(Linear(name, self._pc(name, 2), input, out_channels,
                                relu))

    def concat(self, name, tensors: List[Tensor]) -> Tensor:
        from flexflow_tpu_torch.ops.concat import Concat

        return self._add(Concat(name, self._pc(name, 4), tensors))

    def add(self, name, x: Tensor, y: Tensor, relu: bool = False) -> Tensor:
        from flexflow_tpu_torch.ops.elementwise import Add

        return self._add(Add(name, self._pc(name, 4), [x, y], relu))

    def flat(self, name, input) -> Tensor:
        from flexflow_tpu_torch.ops.flat import Flat

        return self._add(Flat(name, self._pc(name, 2), input))

    def softmax(self, name, input) -> Tensor:
        from flexflow_tpu_torch.ops.softmax import Softmax

        return self._add(Softmax(name, self._pc(name, 1), input))

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
        ``config.seed``).  Shared ``param_key``s initialize once; state is
        per op (``model.py:428``) and stays float32 under mixed
        precision."""
        seed = self.config.seed if seed is None else seed
        gen = torch.Generator(device=self.device)
        gen.manual_seed(int(seed))
        params: Dict[str, Dict] = {}
        state: Dict[str, Dict] = {}
        for op in self.layers:
            if op.param_key not in params:
                p = op.init_params(gen, self.device)
                if p:
                    params[op.param_key] = self._cast_param_tree(p)
            s = op.init_state(self.device)
            if s:
                state[op.name] = s
        return params, state

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
        Returns (tensor-values dict, new_state); an op with several
        outputs stores each value under its tensor's tid
        (``model.py:1182``).  With ``train`` the LM-head fusion runs
        (``model.py:1022``): a fused loss op's value is the per-token NLL,
        and its projection has no value."""
        values: Dict[int, Any] = dict(inputs)
        new_state: Dict[str, Dict] = {}
        fusion = self._lm_head_fusion() if train else {}
        for i, op in enumerate(self.layers):
            if i in fusion:
                lin = fusion[i]
                if lin is not None:
                    values[op.output.tid] = self._run_fused_lm_head(
                        params.get(lin.param_key, {}),
                        values[lin.inputs[0].tid],
                        values[op.labels_tensor.tid])
                continue   # the projection is folded into its loss op
            xs = [values[t.tid] for t in op.inputs]
            y, st = op.forward(params.get(op.param_key, {}),
                               state.get(op.name, {}), xs, train)
            ys = y if isinstance(y, tuple) else (y,)
            for t, v in zip(op.all_outputs(), ys, strict=True):
                values[t.tid] = v
            if st:
                new_state[op.name] = st
        return values, new_state

    # ------------------------------------------------------------------
    # the LM-head fusion (model.py:623-728, one device)

    def _lm_head_fusion(self) -> Dict[int, Any]:
        """``{layer index: None}`` for each vocab projection (``RnnLinear``)
        whose only consumer is a ``SoftmaxDP``, and ``{loss-op index: that
        projection}``: the pair runs as one fused projection +
        cross-entropy op, so the (N, V) logits are never stored.

        The fusion fires on the graph's structure alone.  The JAX gate
        ``_fusion_ok`` (``model.py:655-665``) also refuses d > 4096, the
        TPU kernel's VMEM limit, and b*s < 2048 tokens, where XLA's one
        large GEMM measured faster on the TPU; the card's kernels have
        neither limit, and where the card's crossover lies is not
        measured yet (PERF.md, open questions)."""
        from flexflow_tpu_torch.ops.rnn_linear import RnnLinear
        from flexflow_tpu_torch.ops.softmax_dp import SoftmaxDP

        consumers = collections.Counter(t.tid for op in self.layers
                                        for t in op.inputs)
        index = {id(op): i for i, op in enumerate(self.layers)}
        plan: Dict[int, Any] = {}
        for i, op in enumerate(self.layers):
            prod = op.inputs[0].producer
            if (isinstance(op, SoftmaxDP) and isinstance(prod, RnnLinear)
                    and consumers[prod.output.tid] == 1):
                plan[index[id(prod)]] = None
                plan[i] = prod
        return plan

    @staticmethod
    def _run_fused_lm_head(lin_params, x, labels):
        """Per-token NLL (b, s) of the projection of x (b, s, d) at
        labels (b, s) through the fused projection + CE op."""
        from flexflow_tpu_torch.ops.kernels.fused_ce import fused_linear_ce

        b, s, d = x.shape
        nll = fused_linear_ce(x.reshape(b * s, d), lin_params["kernel"],
                              lin_params["bias"], labels.reshape(-1))
        return nll.reshape(b, s)

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
                    params = _cast_floats(params, cdtype)
                inputs = {}
                for t, b in zip(self._inputs, batch):
                    b = torch.as_tensor(b, device=device)
                    if b.is_floating_point():
                        b = b.to(cdtype)
                    inputs[t.tid] = b
                values, _ = self.apply(params, state, inputs, train=False)
                return tuple(values[tid] for tid in tids)

        return predict_step

    # ------------------------------------------------------------------
    # training (model.py:1338-1500, 1551, 1624)

    def loss_fn(self, params, state, image, labels, train: bool = True):
        """``(loss, new_state)``: the mean NLL of the loss op's log-probs
        (the CNN path; the sequence models override it)."""
        loss_op = self._loss_op()
        values, new_state = self.apply(
            params, state, {self._inputs[0].tid: image}, train)
        return loss_op.loss(values[loss_op.output.tid], labels), new_state

    def init_opt_state(self, params):
        """Zero momentum buffers shaped like ``params``; under mixed
        precision float32 buffers plus a float32 master of every float
        leaf under ``<leaf>__master``."""
        if not self._mixed_precision():
            return {key: {k: torch.zeros_like(v) for k, v in sub.items()}
                    for key, sub in params.items()}
        out = {}
        for key, sub in params.items():
            d = {}
            for k, v in sub.items():
                if v.is_floating_point():
                    d[k] = torch.zeros_like(v, dtype=torch.float32)
                    d[k + MASTER_SUFFIX] = v.float()
                else:
                    d[k] = torch.zeros_like(v)
            out[key] = d
        return out

    def master_opt_state(self, params):
        """The float32 master of every float leaf under
        ``<leaf>__master`` (``model.py:504-520``), the optimizer state of
        the plain-SGD models under mixed precision; None in float32."""
        if not self._mixed_precision():
            return None
        return {key: {k + MASTER_SUFFIX: v.float()
                      for k, v in sub.items() if v.is_floating_point()}
                for key, sub in params.items()}

    def _batch(self, *batch):
        """The batch on the model's device: float arrays (images) cast to
        the compute dtype, integer ones (labels, token ids) kept as they
        are."""
        cdtype = torch_dtype(self.config.compute_dtype)
        out = []
        for b in batch:
            t = torch.as_tensor(b, device=self.device)
            out.append(t.to(cdtype) if t.is_floating_point() else t)
        return tuple(out)

    def _loss_and_grads(self, params, state, batch):
        """``(loss, new_state, keys, grads)`` of ``loss_fn`` on the batch:
        ``grads`` are the gradients of the float leaves ``keys`` (pairs
        ``(param_key, leaf)``), taken through the compute-dtype cast under
        mixed precision."""
        batch = self._batch(*batch)
        tree = {key: {k: v.detach().requires_grad_(v.is_floating_point())
                      for k, v in sub.items()}
                for key, sub in params.items()}
        keys = [(key, k) for key, sub in tree.items()
                for k, v in sub.items() if v.requires_grad]
        with torch.enable_grad():
            fwd = _cast_floats(tree, torch_dtype(self.config.compute_dtype)) \
                if self._mixed_precision() else tree
            loss, new_state = self.loss_fn(fwd, state, *batch, train=True)
            grads = torch.autograd.grad(loss,
                                        [tree[key][k] for key, k in keys])
        return loss.detach(), new_state, keys, grads

    def make_train_step(self):
        """``train_step(params, state, opt_state, *batch) ->
        (params, state, opt_state, loss)``: forward, backward and the
        momentum-SGD update ``v = mu*v + g + wd*p; p = p - lr*v`` of
        ``model.py:1353-1386``.  New trees are returned; the inputs are not
        modified.  Under mixed precision the update runs in float32
        against the masters in the optimizer state and the stored params
        are re-cast from them (``model.py:1388-1432``)."""
        cfg = self.config
        lr, wd, mu = cfg.learning_rate, cfg.weight_decay, cfg.momentum
        mixed = self._mixed_precision()

        def train_step(params, state, opt_state, *batch):
            loss, new_state, keys, grads = self._loss_and_grads(
                params, state, batch)
            new_params = {key: dict(sub) for key, sub in params.items()}
            new_opt = {key: dict(sub) for key, sub in opt_state.items()}
            with torch.no_grad():
                for (key, k), g in zip(keys, grads):
                    p, v = params[key][k], opt_state[key][k]
                    if mixed:
                        m = opt_state[key][k + MASTER_SUFFIX]
                        v = mu * v + g.float() + wd * m
                        m = m - lr * v
                        new_params[key][k] = m.to(p.dtype)
                        new_opt[key][k + MASTER_SUFFIX] = m
                    else:
                        v = mu * v + g + wd * p
                        new_params[key][k] = p - lr * v
                    new_opt[key][k] = v
            return new_params, new_state, new_opt, loss

        return train_step

    def make_sgd_step(self, lr: float):
        """Plain-SGD ``train_step(params, state, opt_state, *batch)`` over
        ``self.loss_fn(params, state, *batch)``: ``p = p - lr*g``
        (``model.py:1434-1457``), the step of the sequence models.  Under
        mixed precision ``opt_state`` holds the float32 masters
        (:meth:`master_opt_state`): the update runs against them in float32
        and the stored params are re-cast from them
        (``model.py:1459-1500``).  New trees are returned; the inputs are
        not modified."""
        def train_step(params, state, opt_state, *batch):
            loss, new_state, keys, grads = self._loss_and_grads(
                params, state, batch)
            new_params = {key: dict(sub) for key, sub in params.items()}
            new_opt = {key: dict(sub)
                       for key, sub in (opt_state or {}).items()}
            with torch.no_grad():
                for (key, k), g in zip(keys, grads):
                    p = params[key][k]
                    mk = k + MASTER_SUFFIX
                    if mk in new_opt.get(key, {}):
                        m = new_opt[key][mk] - lr * g.float()
                        new_params[key][k] = m.to(p.dtype)
                        new_opt[key][mk] = m
                    else:
                        new_params[key][k] = p - lr * g
            return new_params, new_state, new_opt or opt_state, loss

        return train_step

    def make_eval_step(self):
        """``eval_step(params, state, image, labels) -> (loss, accuracy)``
        without gradients (``model.py:1551``)."""
        cdtype = torch_dtype(self.config.compute_dtype)
        loss_op = self._loss_op()

        def eval_step(params, state, image, labels):
            with torch.inference_mode():
                image, labels = self._batch(image, labels)
                if self._mixed_precision():
                    params = _cast_floats(params, cdtype)
                values, _ = self.apply(
                    params, state, {self._inputs[0].tid: image}, False)
                log_probs = values[loss_op.output.tid]
                loss = loss_op.loss(log_probs, labels)
                acc = (log_probs.argmax(dim=-1) == labels.long()) \
                    .float().mean()
                return loss, acc

        return eval_step

    def fit(self, data_iter, num_iterations: Optional[int] = None,
            warmup: int = 1, log=print) -> Dict[str, Any]:
        """The timed training loop of ``model.py:1624`` (cnn.cc:110-128):
        ``warmup`` untimed steps, then the timed ones, the device synced
        once when the timed window opens and once when it closes; the loss
        every ``config.print_freq`` iterations; then the reference's line
        ``time = %.4fs, tp = %.2f images/s``.  Starts from ``init()``.
        Returns
        ``{"params", "state", "opt_state", "loss" (floats), "elapsed_s",
        "images_per_sec"}``.  Checkpoints, elastic recovery, the health
        guard, telemetry and prefetching are not ported yet."""
        num_iterations = num_iterations or self.config.num_iterations
        warmup = min(warmup, max(num_iterations - 1, 0))
        params, state = self.init()
        opt_state = self.init_opt_state(params)
        step = self.make_train_step()
        print_freq = self.config.print_freq
        losses = []
        start = time.perf_counter()
        for it in range(num_iterations):
            batch = next(data_iter)
            if it == warmup:
                self._sync()
                start = time.perf_counter()
            params, state, opt_state, loss = step(params, state, opt_state,
                                                  *batch)
            losses.append(loss)
            if print_freq and (it + 1) % print_freq == 0:
                log(f"iter {it + 1}: loss = {float(loss):.4f}")
        self._sync()
        elapsed = time.perf_counter() - start
        n_timed = num_iterations - warmup
        throughput = (n_timed * self.config.batch_size / elapsed
                      if elapsed > 0 and n_timed > 0 else 0.0)
        log(f"time = {elapsed:.4f}s, tp = {throughput:.2f} images/s")
        return {"params": params, "state": state, "opt_state": opt_state,
                "loss": [float(v) for v in losses], "elapsed_s": elapsed,
                "images_per_sec": throughput}

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)


def _cast_floats(tree, dtype):
    """``tree`` with every float leaf cast to ``dtype``."""
    return {key: {k: v.to(dtype) if v.is_floating_point() else v
                  for k, v in sub.items()}
            for key, sub in tree.items()}
