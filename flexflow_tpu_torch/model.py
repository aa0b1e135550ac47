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
and the parity tests hold without it.  ``fit`` carries the JAX training
runtime: checkpoints and resume (over several ranks, gathered whole on
rank 0), the step health guard with rollback, device prefetch and fault
injection.

On a machine of several ranks (``distributed.initialize``) every op runs
on its own strategy grid and device list.  At build time
(:meth:`_setup_sharded`, on every rank in one order) the model checks
that each op's grid divides its tensors, places the ops whose device
lists are subsets of the machine (``parallel/placement.py``), plans
every producer->consumer regrid (``parallel/regrid.py``) and makes the
process groups.  ``init`` draws the full parameters from the seed on every rank
and keeps the blocks of the ops the rank runs (``param_specs``; a key
shared by several ops, whole on each of their ranks); ``apply`` walks
every op in one order on every rank, moves each input to the layout its
op wants where the rank takes part in the move, and runs the op on the
rank's blocks where the op is placed on it; the loss is each rank's
partial NLL sum over the global batch, added up over the ranks (0 on a
rank that counts no loss block), and an op's auxiliary loss (the MoE's)
counts on one rank per block of its rows (:meth:`aux_counted`);
gradients are all-reduced over the ranks that hold the same block of a
leaf, and the backward collectives run in one order on every rank
(``collectives.token_chain``).  The step
functions take this rank's batch block (:meth:`local_batch`).  ``fit``
writes the JAX package's run telemetry (``obs/``) from rank 0, with its
sampled op timing.  Under ``elastic`` a lost rank shrinks the run onto
the survivors' re-formed world and the run grows back when the rank
answers again (``utils/elastic.py``).
"""

from __future__ import annotations

import collections
import contextlib
import time
from typing import Any, Dict, List, Optional

import torch

from flexflow_tpu_torch.config import FFConfig
from flexflow_tpu_torch.machine import MachineModel
from flexflow_tpu_torch.ops.base import Op, OpGrid, Tensor, torch_dtype
from flexflow_tpu_torch.parallel import collectives
from flexflow_tpu_torch.strategy import (ParallelConfig, Strategy,
                                         validate_strategy)

#: suffix of the float32 master leaves in a mixed-precision optimizer state
MASTER_SUFFIX = "__master"


class FFModel:
    def __init__(self, config: Optional[FFConfig] = None,
                 machine: Optional[MachineModel] = None, device="cuda"):
        self.config = config or FFConfig()
        self.machine = machine if machine is not None \
            else MachineModel(device)
        validate_strategy(self.config.strategies, self.machine.num_devices)
        gpus = getattr(self.config, "workers_per_node", 0)
        if gpus and gpus != self.machine.num_devices:
            raise ValueError(
                f"-ll:gpu {gpus} but the world has "
                f"{self.machine.num_devices} rank(s): launch one process "
                f"per GPU (torchrun --nproc-per-node {gpus})")
        self.machine = self._permuted_machine_view(self.machine)
        self.layers: List[Op] = []
        self._inputs: List[Tensor] = []
        # the multi-rank plan, made by _setup_sharded
        self._plan = None

    @property
    def device(self) -> torch.device:
        return self.machine.device

    @property
    def sharded(self) -> bool:
        """True when the model runs through ``torch.distributed``: on a
        machine of several ranks, or of one under ``torchrun``."""
        return self.machine.distributed or self.machine.num_devices > 1

    def _permuted_machine_view(self, machine: MachineModel) -> MachineModel:
        """Honor a whole-machine device permutation that every
        non-canonical full-machine entry of the strategy names, by
        relabelling the machine so those entries become canonical
        (``flexflow_tpu/model.py:152-221``); entries on device subsets are
        remapped onto the same ranks.  The strategy is rewritten in a
        private copy of the config."""
        import copy

        n = machine.num_devices
        canon = tuple(range(n))
        if n <= 1 or not self.config.strategies:
            return machine
        perms = {pc.devices for pc in self.config.strategies.values()
                 if tuple(sorted(pc.devices)) == canon
                 and pc.devices != canon}
        if len(perms) != 1:
            return machine
        perm = next(iter(perms))
        inv = [0] * n
        for i, d in enumerate(perm):
            inv[d] = i
        remapped = Strategy()
        remapped.pipeline = self.config.strategies.pipeline
        remapped.predicted = self.config.strategies.predicted
        for name, pc in self.config.strategies.items():
            devices = canon if tuple(sorted(pc.devices)) == canon \
                else tuple(inv[d] for d in pc.devices)
            remapped[name] = ParallelConfig(pc.dims, devices)
        self.config = copy.copy(self.config)
        self.config.strategies = remapped
        return machine.permuted(perm)

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

    def moe(self, name, input, num_experts, d_ff, top_k: int = 2,
            capacity_factor: float = 2.0) -> Tensor:
        from flexflow_tpu_torch.ops.moe import MixtureOfExperts

        return self._add(MixtureOfExperts(
            name, self._pc(name, 3), input, num_experts, d_ff, top_k,
            capacity_factor))

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
        precision.  With ``config.params_init == "ones"`` every parameter
        leaf is 1.0 whatever the seed; the state is not touched, as in
        the JAX package.  On several ranks every rank draws the full
        trees and keeps its blocks (:meth:`shard_params`)."""
        params, state = self._init_full(seed)
        if self.sharded:
            return self.shard_params(params), self.shard_state(state)
        return params, state

    def _init_full(self, seed):
        seed = self.config.seed if seed is None else seed
        gen = torch.Generator(device=self.device)
        gen.manual_seed(int(seed))
        params: Dict[str, Dict] = {}
        state: Dict[str, Dict] = {}
        all_ones = self.config.params_init == "ones"
        for op in self.layers:
            if op.param_key not in params:
                p = op.init_params(gen, self.device)
                if p and all_ones:
                    # PARAMETER_ALL_ONES (conv_2d.cu:393-398,
                    # flexflow_tpu/model.py:372-377): every parameter
                    # leaf 1.0, the state as drawn
                    p = {k: torch.ones_like(v) for k, v in p.items()}
                if p:
                    params[op.param_key] = self._cast_param_tree(p)
            s = op.init_state(self.device)
            if s:
                state[op.name] = s
        return params, state

    def param_shapes(self) -> Dict[str, Dict[str, tuple]]:
        """``{param_key: {leaf: shape}}`` of the tree :meth:`init` makes,
        drawn on the meta device: nothing is allocated."""
        out: Dict[str, Dict[str, tuple]] = {}
        for op in self.layers:
            if op.param_key not in out and op.leaf_shapes:
                out[op.param_key] = dict(op.leaf_shapes)
        return out

    # ------------------------------------------------------------------
    # grids over several ranks

    def _setup_sharded(self) -> None:
        """Check that every op's grid divides its tensors, place the ops
        whose device lists are subsets (``parallel/placement.py``), plan
        the regrids and make every process group, once; every rank runs
        this in the same order (``new_group`` needs all ranks)."""
        if self._plan is not None:
            return
        from flexflow_tpu_torch.parallel.placement import placed
        from flexflow_tpu_torch.parallel.regrid import build_regrid_plan

        m = self.machine
        n = m.num_devices
        self._grids = {}
        for op in self.layers:
            positions = placed(op, m) if n > 1 else None
            self._grids[op.name] = OpGrid(m, op, positions)
            if n > 1:
                op.validate_partitioning()
        self._plan = build_regrid_plan(self)
        for op in self.layers:
            self._grids[op.name].prepare(op.grid_collectives())
        self._setup_leaves()
        m.world_group()
        # each loss op's value counts once: on the first position holding
        # each of its blocks; a fused head's per-token NLL lies in the
        # rows of its projection's grid, where its labels are moved
        self._loss_primary = {}
        self._fused_primary = {}
        for op in self.layers:
            if getattr(op, "is_loss", False):
                self._loss_primary[op.name] = self._first_holder(
                    op, op.output_spec(), op.output.shape)
        # an op's auxiliary loss (the MoE's, a global mean on every rank
        # of its grid) counts once per block of its output's rows
        self._aux_primary = {
            op.name: self._first_holder(op, op.output_spec(),
                                        op.output.shape)
            for op in self.layers if getattr(op, "aux", None) is not None}
        for i, lin in self._lm_head_fusion().items():
            if lin is None:
                continue
            loss = self.layers[i]
            labels = loss.labels_tensor
            self._plan.add_edge(
                lin.name, "labels", self._plan.layouts.get(labels.tid),
                m.global_entries(lin.pc, lin.AXIS_NAMES, ("n", None),
                                 rank=2),
                labels.shape, 4, tid=labels.tid, dtype=torch.int32)
            if lin.pc.dims[0] > 1:
                self._grids[lin.name].prepare([("c",)])
            self._fused_primary[loss.name] = self._first_holder(
                lin, ("n", None), labels.shape)

    def _first_holder(self, op, spec, shape) -> bool:
        """Whether this rank is the first position holding its block of a
        ``shape`` value laid out as ``spec`` over ``op``'s grid."""
        boxes = self._boxes_of(op, spec, shape)
        mine = boxes[self.machine.position]
        return mine is not None and boxes.index(mine) == \
            self.machine.position

    def loss_counted(self, op, train: bool) -> bool:
        """Whether this rank counts its block of loss op ``op``'s value
        (always on one rank; over several, the first holder of each
        block): the fused head's rows when ``train`` fuses ``op``."""
        if not self.sharded:
            return True
        if self._fusion_on(train) and op.name in self._fused_primary:
            return self._fused_primary[op.name]
        return self._loss_primary[op.name]

    def aux_counted(self, op) -> bool:
        """Whether this rank counts op ``op``'s auxiliary loss in the
        objective: always on one rank; over several, on the first holder
        of each block of its output's rows, whose n group sums the aux's
        statistics with a backward that hands each member its own."""
        return not self.sharded or self._aux_primary[op.name]

    def _boxes_of(self, op, spec, shape) -> tuple:
        """Every position's box (None: not held) of a ``shape`` tensor
        laid out as ``spec`` over ``op``'s grid."""
        from flexflow_tpu_torch.parallel.regrid import (layout_boxes,
                                                        placed_layout)

        m = self.machine
        positions = self._grids[op.name].positions
        if positions is not None:
            return placed_layout(m, op, positions, spec, shape).boxes
        return layout_boxes(m, m.global_entries(
            op.pc, op.AXIS_NAMES, spec or (), rank=len(shape)), shape)

    def _setup_leaves(self) -> None:
        """Where each leaf lives and which ranks sum its gradient.

        An op's parameters and state live on the ranks that run it, each
        rank holding the block its point computes with
        (``param_specs``, ``state_specs``).  A key shared by several ops
        (the NMT's ``srcEmbed``, ``encoder{l}``, ``linear``: the
        reference's SharedVariable) is held whole on every rank that runs
        any of them, each op slicing its block there.  A leaf's gradient is
        summed over the ranks that hold the same block: each (op, grid
        point) contribution is computed on exactly one of them, so every
        contribution counts once."""
        m = self.machine
        users = collections.Counter(
            op.param_key for op in self.layers if op.leaf_shapes)
        store: Dict[str, Dict[str, list]] = {}
        self._op_param_slices: Dict[str, Dict] = {}
        needs = {}
        for op in self.layers:
            shapes = op.leaf_shapes
            if not shapes:
                continue
            specs = op.param_specs()
            need = {leaf: self._boxes_of(op, specs.get(leaf), shape)
                    for leaf, shape in shapes.items()}
            needs[op.name] = need
            key = op.param_key
            if users[key] == 1:
                store[key] = {leaf: list(b) for leaf, b in need.items()}
                continue
            sub = store.setdefault(key, {leaf: [None] * m.num_devices
                                         for leaf in shapes})
            for leaf, shape in shapes.items():
                for p, b in enumerate(need[leaf]):
                    if b is not None:
                        sub[leaf][p] = tuple((0, d) for d in shape)
        for op in self.layers:
            if op.name not in needs:
                continue
            held = store[op.param_key]
            self._op_param_slices[op.name] = {
                leaf: None if b[m.position] in (None,
                                                held[leaf][m.position])
                else tuple(slice(lo - hlo, hi - hlo) for (lo, hi), (hlo, _)
                           in zip(b[m.position], held[leaf][m.position]))
                for leaf, b in needs[op.name].items()}
        self._store = {"params": store, "state": {}}
        meta = torch.device("meta")
        for op in self.layers:
            st = {k: tuple(v.shape) for k, v in op.init_state(meta).items()}
            if st:
                specs = op.state_specs()
                self._store["state"][op.name] = {
                    leaf: self._boxes_of(op, specs.get(leaf), shape)
                    for leaf, shape in st.items()}
        self._grad_groups: Dict = {}
        for key, sub in store.items():
            for leaf, boxes in sub.items():
                for box in dict.fromkeys(b for b in boxes if b is not None):
                    group = m.group_of(p for p, b in enumerate(boxes)
                                       if b == box)
                    if box == boxes[m.position]:
                        self._grad_groups[(key, leaf)] = group

    def _shard(self, tree, kind: str, position: Optional[int]):
        self._setup_sharded()
        pos = self.machine.position if position is None else position
        store = self._store[kind]
        out = {}
        for key, sub in tree.items():
            boxes = store.get(key)
            if boxes is None:
                out[key] = sub
                continue
            if any(boxes[leaf][pos] is None for leaf in sub):
                continue   # held only on the ranks that run its ops
            out[key] = {leaf: v[tuple(slice(lo, hi) for lo, hi
                                      in boxes[leaf][pos])].contiguous()
                        for leaf, v in sub.items()}
        return out

    def shard_params(self, params, position: Optional[int] = None):
        """The blocks of the full ``params`` tree that the rank at
        ``position`` (default this rank's) holds under the strategy: none
        of a key whose ops do not run there."""
        return self._shard(params, "params", position)

    def shard_state(self, state, position: Optional[int] = None):
        """The blocks of the full state tree (BatchNorm's running
        statistics) held at ``position``."""
        return self._shard(state, "state", position)

    def param_boxes(self) -> Dict[str, Dict[str, tuple]]:
        """``{param_key: {leaf: ((lo, hi), ...)}}``: where this rank's block
        of each leaf it holds lies in the full leaf (the whole leaf on one
        device)."""
        return self._boxes("params", self.param_shapes())

    def state_boxes(self) -> Dict[str, Dict[str, tuple]]:
        """The same for the state tree (``{op_name: {leaf: box}}``)."""
        meta = torch.device("meta")
        shapes = {op.name: {k: tuple(v.shape)
                            for k, v in op.init_state(meta).items()}
                  for op in self.layers}
        return self._boxes("state", {k: v for k, v in shapes.items() if v})

    def _boxes(self, kind, shapes):
        if not self.sharded:
            return {key: {leaf: tuple((0, n) for n in shape)
                          for leaf, shape in leaves.items()}
                    for key, leaves in shapes.items()}
        self._setup_sharded()
        pos = self.machine.position
        store = self._store[kind]
        return {key: {leaf: store[key][leaf][pos] for leaf in leaves}
                for key, leaves in shapes.items()
                if all(store[key][leaf][pos] is not None for leaf in leaves)}

    def _op_params(self, op, params):
        """``op``'s parameter blocks from this rank's tree: a shared key is
        held whole and sliced to the op's block here (an autograd slice,
        so the gradient lands in the held leaf)."""
        p = params.get(op.param_key, {})
        cuts = self._op_param_slices.get(op.name)
        if not cuts or not any(cuts.values()):
            return p
        return {leaf: v if cuts.get(leaf) is None
                else v[cuts[leaf]].contiguous() for leaf, v in p.items()}

    def local_batch(self, *batch):
        """This rank's blocks of global batch arrays: each rank holds the
        batch rows of its position in a split over every rank, the
        layout the model's inputs arrive in."""
        lo, hi = self.machine.batch_block(self.config.batch_size)
        return tuple(b[lo:hi] for b in batch)

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
        and its projection has no value.  Over several ranks ``values``
        holds what this rank holds, and a sequence loss op's labels, moved
        to its layout, under ``("labels", op name)``.

        With ``config.print_intermediates`` (the dump mode) the fusion is
        off and every op output is printed as ``{op}/{tensor}`` with its
        shape and statistics (``utils/debug.py``,
        ``flexflow_tpu/model.py:1021-1023, 1189-1190``); over several
        ranks the whole tensor's, rank 0 printing."""
        values: Dict[Any, Any] = dict(inputs)
        new_state: Dict[str, Dict] = {}
        if self.sharded:
            self._setup_sharded()
        fusion = self._lm_head_fusion() if self._fusion_on(train) else {}
        dump = self.config.print_intermediates
        reshards: Dict = {}
        for i, op in enumerate(self.layers):
            if i in fusion:
                lin = fusion[i]
                if lin is not None:
                    x = values.get(lin.inputs[0].tid)
                    labels = values.get(op.labels_tensor.tid)
                    p = params.get(lin.param_key, {})
                    if self.sharded:
                        x = self._plan.apply(lin.name, 0, x, reshards)
                        labels = self._plan.apply(lin.name, "labels",
                                                  labels, reshards)
                        p = self._op_params(lin, params)
                        values[("labels", op.name)] = labels
                    values[op.output.tid] = self._run_fused_lm_head(
                        lin, p, x, labels)
                continue   # the projection is folded into its loss op
            if self.sharded:
                # every rank walks every op in one order; a move runs on
                # the ranks of its group, the op on the ranks it is
                # placed on
                xs = [self._plan.apply(op.name, j, values.get(t.tid),
                                       reshards)
                      for j, t in enumerate(op.inputs)]
                grid = self._grids[op.name]
                if not grid.runs:
                    if dump:
                        self._dump(op, None)
                    continue
                y, st = op.sharded_forward(self._op_params(op, params),
                                           state.get(op.name, {}), xs,
                                           train, grid)
                if getattr(op, "labels_tensor", None) is not None:
                    values[("labels", op.name)] = xs[1]
            else:
                xs = [values[t.tid] for t in op.inputs]
                y, st = op.forward(params.get(op.param_key, {}),
                                   state.get(op.name, {}), xs, train)
            ys = y if isinstance(y, tuple) else (y,)
            for t, v in zip(op.all_outputs(), ys, strict=True):
                values[t.tid] = v
            if dump:
                self._dump(op, ys)
            if st:
                new_state[op.name] = st
        return values, new_state

    def _fusion_on(self, train: bool) -> bool:
        """Whether ``apply`` runs the LM-head fusion: in training, but not
        in the dump mode, which prints the projection's own output."""
        return train and not self.config.print_intermediates

    def _dump(self, op, ys) -> None:
        """Print each output of ``op`` (``ys``: its values here, None on a
        rank that does not run it).  Over several ranks each block counts
        once, on its first holder: the count, sum and sum of squares are
        summed and max |x| maxed over every rank, and rank 0 prints."""
        from flexflow_tpu_torch.utils import debug

        outs = op.all_outputs()
        if not self.sharded:
            for t, v in zip(outs, ys):
                debug.print_tensor(f"{op.name}/{t.name or 'out'}", v)
            return
        world = self.machine.world_group()
        specs = op.output_specs()
        for k, t in enumerate(outs):
            v = None
            if ys is not None and self._first_holder(op, specs[k], t.shape):
                v = ys[k]
            sums = debug.block_sums(v).to(self.device)
            collectives.all_reduce_(sums[:3], world)
            amax = collectives.all_reduce_max(sums[3:], world)
            if self.machine.rank == 0:
                debug.print_sums(f"{op.name}/{t.name or 'out'}", t.shape,
                                 t.dtype if ys is None else ys[k].dtype,
                                 torch.cat([sums[:3], amax]))

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
        measured yet (PERF.md, open questions).

        Over several ranks the pair fuses where JAX's ``_fusion_ok`` lets it
        (``flexflow_tpu/model.py:655-672``, less its TPU size gates): the
        projection on the whole machine in order, its vocab split c
        dividing V and its batch split n the batch.  Each rank then runs
        kernels 4-6 on the rows of its n block against its c block of the
        vocab, its labels moved to those rows (edge ``(projection,
        "labels")``), and the c blocks combine as
        :meth:`_run_fused_lm_head` says.  Other heads run unfused, the
        projection's blocks regridded to the loss's: the same function.
        """
        from flexflow_tpu_torch.ops.rnn_linear import RnnLinear
        from flexflow_tpu_torch.ops.softmax_dp import SoftmaxDP

        consumers = collections.Counter(t.tid for op in self.layers
                                        for t in op.inputs)
        index = {id(op): i for i, op in enumerate(self.layers)}
        plan: Dict[int, Any] = {}
        for i, op in enumerate(self.layers):
            prod = op.inputs[0].producer
            if (isinstance(op, SoftmaxDP) and isinstance(prod, RnnLinear)
                    and consumers[prod.output.tid] == 1
                    and (not self.sharded or self._fusable(prod, op))):
                plan[index[id(prod)]] = None
                plan[i] = prod
        return plan

    def _fusable(self, lin, loss) -> bool:
        """Whether ``lin`` -> ``loss`` fuses over several ranks: the
        projection on the whole machine in order, V % c == 0 and b % n ==
        0 (``flexflow_tpu/model.py:666-672``)."""
        c, n = lin.pc.dims
        return (self._grids[lin.name].positions is None
                and lin.pc.devices == tuple(range(self.machine.num_devices))
                and lin.out_channels % c == 0
                and lin.inputs[0].shape[0] % n == 0)

    def _run_fused_lm_head(self, lin, lin_params, x, labels):
        """Per-token NLL (b, s) of the projection of x (b, s, d) at
        labels (b, s) through the fused projection + CE op.

        Where the projection splits the vocab (c > 1) each c rank runs the
        partial form over its V/c columns with its labels localized by
        ``- c_index * V/c`` (``flexflow_tpu/model.py:698-723``): a label
        lives in one slice, and elsewhere nll_c = lse_c.  With m the max
        of the detached lse_c over the c group (a stability shift, no
        gradient), one all-reduce sum of ``[exp(lse_c - m), lse_c -
        nll_c]`` gives nll = m + log(sum_0) - sum_1 on every c rank.  The
        sum's backward all-reduces, so each c rank receives the row's
        whole cotangent from the one rank that counts it."""
        from flexflow_tpu_torch.ops.kernels.fused_ce import (
            fused_linear_ce, fused_linear_ce_partial)

        b, s, d = x.shape
        xf, lab = x.reshape(b * s, d), labels.reshape(-1)
        w, bias = lin_params["kernel"], lin_params["bias"]
        grid = self._grids[lin.name] if self.sharded else None
        if grid is None or grid.parts("c") == 1:
            return fused_linear_ce(xf, w, bias, lab).reshape(b, s)
        v_local = lin.out_channels // grid.parts("c")
        nll_c, lse_c = fused_linear_ce_partial(
            xf, w, bias, lab - grid.index("c") * v_local)
        m = collectives.all_reduce_max(lse_c, grid.group(("c",)))
        sums = grid.all_reduce(torch.stack([torch.exp(lse_c - m),
                                            lse_c - nll_c]), ("c",))
        nll = m + torch.log(torch.clamp(sums[0], min=1e-30)) - sums[1]
        return nll.reshape(b, s)

    def make_predict_step(self, output_tids=None):
        """Forward-only inference step, the serving path.  Returns
        ``predict(params, state, *batch) -> tuple of tensors`` for
        ``output_tids`` in order (default: the loss op's log-probs).
        Positional ``batch`` arrays (numpy or tensors) align with
        ``self._inputs``; they are moved to the model's device, float
        ones cast to the compute dtype.  Under mixed precision the float
        params are cast to the compute dtype for the step.  Over several
        ranks the batch is this rank's block (:meth:`local_batch`) and
        each output this rank's block of it (None where it holds none);
        :meth:`gather_rows` assembles the rows a caller reads and
        :meth:`gather_output` a whole value."""
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
                # over several ranks: this rank's blocks, None where it
                # holds none (gather_rows assembles rows of them)
                return tuple(values.get(tid) for tid in tids)

        return predict_step

    def _producer(self, tid):
        """``(op, k)``: the op whose ``k``-th output is tensor ``tid``."""
        for op in self.layers:
            for k, t in enumerate(op.all_outputs()):
                if t.tid == tid:
                    return op, k
        raise KeyError(f"no op produces tensor {tid}")

    def _first_box(self, op, k):
        """``(shape, boxes, mine)``: the shape of output ``k`` of ``op``,
        every position's box of it, and the box this rank first holds
        (None where another position holds the same block first, or none
        is held here)."""
        t = op.all_outputs()[k]
        boxes = self._boxes_of(op, op.output_specs()[k], t.shape)
        mine = boxes[self.machine.position]
        first = mine is not None and boxes.index(mine) == \
            self.machine.position
        return t.shape, boxes, (mine if first else None)

    def gather_rows(self, values, picks):
        """Whole rows of values held in blocks over the ranks, on every
        rank: ``picks`` is a list of ``(tid, rows)``, ``rows`` the
        positions to read of a value of any rank, each an index tuple
        over every dim but the last (``(b, s)`` of a ``(B, S, D)`` value,
        ``(b,)`` of a ``(B, C)`` one; ``values`` as
        :meth:`make_predict_step` returns them, by tid).  Returns one
        float32 ``(len(rows), D)`` tensor per pick.  Each rank writes the
        parts of the rows that its first-held block covers into zeros,
        and one all-reduce sum over the world assembles them: every
        element has exactly one first holder, so the sum adds zeros to
        it and is exact.  Nothing else of the values leaves a rank."""
        self._setup_sharded()
        parts = []
        for tid, rows in picks:
            op, k = self._producer(tid)
            shape, _, mine = self._first_box(op, k)
            buf = torch.zeros(len(rows), shape[-1], dtype=torch.float32,
                              device=self.device)
            v = values.get(tid)
            if v is not None and mine is not None:
                lead, (d0, d1) = mine[:-1], mine[-1]
                sel = [(i,) + tuple(x - lo for x, (lo, _) in zip(row, lead))
                       for i, row in enumerate(rows)
                       if all(lo <= x < hi for x, (lo, hi)
                              in zip(row, lead))]
                if sel:
                    idx = [torch.tensor(c, device=self.device)
                           for c in zip(*sel)]
                    buf[idx[0], d0:d1] = v[tuple(idx[1:])].float()
            parts.append(buf)
        if not parts:
            return []
        return collectives.all_reduce_flat(parts,
                                           self.machine.world_group())

    def gather_output(self, values, tid):
        """The whole value ``tid`` (a tensor of any rank, held in blocks
        as :meth:`make_predict_step` returns it) as float32 on every
        rank, the forward-only service's reply rows: each rank writes
        its first-held block into zeros of the whole shape and one
        all-reduce sum over the world assembles it, exact as in
        :meth:`gather_rows`.  A value every rank holds whole is returned
        as it stands, with no collective."""
        self._setup_sharded()
        op, k = self._producer(tid)
        shape, boxes, mine = self._first_box(op, k)
        v = values.get(tid)
        whole = tuple((0, n) for n in shape)
        if all(b == whole for b in boxes):
            return v.float()
        buf = torch.zeros(shape, dtype=torch.float32, device=self.device)
        if v is not None and mine is not None:
            buf[tuple(slice(lo, hi) for lo, hi in mine)] = v.float()
        return collectives.all_reduce_(buf, self.machine.world_group())

    # ------------------------------------------------------------------
    # training (model.py:1338-1500, 1551, 1624)

    def loss_fn(self, params, state, image, labels, train: bool = True):
        """``(loss, new_state)``: the mean NLL of the loss op's log-probs
        (the CNN path; the sequence models override it)."""
        loss_op = self._loss_op()
        values, new_state = self.apply(
            params, state, {self._inputs[0].tid: image}, train)
        log_probs = values[loss_op.output.tid]
        if not self.sharded:
            return loss_op.loss(log_probs, labels), new_state
        labels = self._plan.apply(loss_op.name, "labels", labels, {})
        partial = loss_op.nll_sum(log_probs, labels) \
            / loss_op.output.shape[0]
        if not self._loss_primary[loss_op.name]:
            partial = partial * 0   # a replica's block counts once
        return collectives.global_sum(partial, self.machine.world_group()), \
            new_state

    def _sync_grads(self, keys, grads):
        """Sum each gradient over the ranks that hold its leaf's block
        (``_setup_leaves``), one all-reduce per (group, dtype) bucket in
        leaf order; the buckets go in one order on every rank (sorted by
        their ranks), whatever leaves a rank holds."""
        buckets: Dict = {}
        for i, (key, g) in enumerate(zip(keys, grads)):
            group = self._grad_groups[key]
            buckets.setdefault((group.positions, str(g.dtype)),
                               (group, []))[1].append(i)
        out = list(grads)
        for _, (group, idx) in sorted(buckets.items()):
            summed = collectives.all_reduce_flat([grads[i] for i in idx],
                                                 group)
            for i, g in zip(idx, summed):
                out[i] = g
        return out

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
        leaves = [tree[key][k] for key, k in keys]
        with torch.enable_grad(), contextlib.ExitStack() as stack:
            chain = stack.enter_context(collectives.token_chain(
                self.device)) if self.sharded else None
            fwd = _cast_floats(tree, torch_dtype(self.config.compute_dtype)) \
                if self._mixed_precision() else tree
            loss, new_state = self.loss_fn(fwd, state, *batch, train=True)
            if chain is None:
                grads = torch.autograd.grad(loss, leaves)
            else:
                # the chain's last token (zero) joins the loss, and its
                # first is asked for: every rank runs each of its backward
                # collectives, in the reverse of its forward order
                grads = torch.autograd.grad(loss + chain.token,
                                            leaves + [chain.first])[:-1]
        if self.sharded:
            grads = self._sync_grads(keys, grads)
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
                if not self.sharded:
                    loss = loss_op.loss(log_probs, labels)
                    acc = (log_probs.argmax(dim=-1) == labels.long()) \
                        .float().mean()
                    return loss, acc
                labels = self._plan.apply(loss_op.name, "labels", labels,
                                          {})
                sums = torch.stack([
                    loss_op.nll_sum(log_probs, labels),
                    (log_probs.argmax(dim=-1) == labels.long()).sum()
                    .float()]) * float(self._loss_primary[loss_op.name])
                collectives.all_reduce_(sums, self.machine.world_group())
                sums = sums / loss_op.output.shape[0]
                return sums[0], sums[1]

        return eval_step

    def fit(self, data_iter, num_iterations: Optional[int] = None,
            warmup: int = 1, log=print, rebuild=None) -> Dict[str, Any]:
        """The training loop of ``model.py:1624`` (cnn.cc:110-128): ``warmup``
        untimed steps, then the timed ones, the device synced once when
        the timed window opens and once when it closes; the loss every
        ``config.print_freq`` iterations; then the reference's line
        ``time = %.4fs, tp = %.2f images/s``.

        The JAX runtime (``_fit``, ``model.py:1755-2298``), each piece off
        unless configured:

          * ``ckpt_dir``: resume from its newest verified checkpoint
            (refusing one trained under another strategy; the data
            stream is advanced past the restored steps), save every
            ``ckpt_freq`` steps and after the last; over several ranks
            rank 0 writes the leaves gathered whole, in the format of a
            one-device save, and every rank restores its own blocks;
            ``ckpt_async`` hands each write to an
            :class:`~flexflow_tpu_torch.utils.checkpoint.
            AsyncCheckpointWriter`, so that only the host snapshot stays
            on the boundary; a rollback and the final save wait for it;
          * the step health guard (``on_divergence``, ``max_rollbacks``)
            checks the losses at print, checkpoint and final boundaries;
            ``rollback`` restores the newest verified checkpoint and
            re-runs from it on fresh batches;
          * ``hang_factor`` > 0 arms the step watchdog around each
            boundary's blocking syncs; a boundary past its deadline
            raises ``DeviceLostError``, or under ``elastic`` probes the
            devices: a dead one shrinks the run, else it goes on;
          * ``elastic`` (``utils/elastic.py``, ``model.py:1662-1740``):
            a rank lost at a boundary (an injected ``device_loss``, a
            dead probe) shrinks the run onto the survivors through the
            driver's ``rebuild(config, machine)`` factory and
            continues the same logical run (one loss history); the lost
            rank stands by; after ``regrow_probes`` answering boundary
            probes the run grows back (at most ``max_regrows`` times; a
            grow that fails before the call leaves the run shrunk).  A
            step error that ``elastic.classify`` calls a device's and
            whose probe recovers retries the step (a budget of 3,
            refilled after ``transient_reset_steps`` healthy steps).
            ``data_iter`` must then be a ``data.BlockStream``, which a
            resize rebinds to the new machine's blocks;
          * SIGTERM and SIGINT (or an injected ``preempt``) drain the
            run: at the next boundary it commits a checkpoint within
            ``drain_budget_s``, writes one ``preempt_drain`` record,
            leaves the process group and returns with ``drained``; over
            several ranks the ranks agree on the flag at every boundary,
            so that all stop at the same one;
          * ``metrics_path``: rank 0 rewrites the live metrics there at
            its print and checkpoint boundaries and after the loop;
          * ``prefetch_depth`` > 0 pulls batches through a
            ``DevicePrefetcher`` (0, the default, pulls them in the loop);
          * ``fault_spec`` installs the fault injector for the run: its
            ``loss_nan``, ``host_crash``, ``device_loss``, ``preempt``
            and ``step_hang`` sites are here, ``data_io`` in the file
            readers (``data/hdf5.py``, ``data/imagenet.py``),
            ``ckpt_truncate`` and ``ckpt_corrupt`` in
            ``save_checkpoint``;
          * ``trace_dir``: rank 0 traces the loop with ``torch.profiler``
            into that directory (``utils/profiling.trace``,
            ``model.py:1902-1905``);
          * ``profiling``: after the loop rank 0 logs the step roofline
            (:meth:`step_flops` over the timed step, against the card's
            peak) and the per-op table (``utils/profiling.OpProfiler``),
            as ``model.py:2258-2282``.

        Any error leaves through one exit: the prefetcher closed, the
        async writer abandoned (``close(timeout=5)``), the watchdog
        closed, the process group released (``distributed.release``).

        Run telemetry (``flexflow_tpu/model.py:1639``, ``:1925-1940``,
        ``:2467-2860``): with ``obs_dir`` set, rank 0 writes the run's
        records to ``<obs_dir>/<run_id>.jsonl`` — the guard's, the
        checkpoints' and the drain's as they happen, and after the loop
        ``compile`` (the first step's wall seconds and the step's FLOP
        count, :meth:`step_flops`), one ``step`` per step from a host
        clock that syncs nothing, ``summary``, the sampled ``op_time``
        records, ``step_budget``, ``sim_drift`` (the timed step over the
        strategy's simulated one) or ``sim_drift_unavailable`` with the
        reason, and ``prefetch``.  With ``op_time_every`` N as well,
        every Nth step runs sampled (:meth:`_sampled_step`) on every
        rank.  The other ranks write nothing.

        Returns ``{"params", "state", "opt_state", "loss" (floats, from
        the first step run), "elapsed_s", "images_per_sec", "rollbacks",
        "completed_steps", "checkpoint_s" (saves inside the loop),
        "final_save_s" (the final save after the loop, its wait for the
        writer's last commit included; 0.0 without one),
        "restore_s" (the resume's and the rollbacks' restores),
        "input_stall_s", "ckpt_async_saves", "ckpt_async" (the writer's
        commits as (step, submit-to-commit seconds), the steps that
        ended while a write ran and every step's host seconds; None
        without the writer), "run_id", "obs_path", "metrics_path"}``
        (the last three None or "" without a sink), and after a drain
        ``"drained": True`` and ``"drain"`` (the ``preempt_drain``
        record); ``"elastic_resizes"`` and ``"devices"`` (the world's
        size at the end).  A rank that stood by until the end returns
        ``"out_of_service": True``, the losses of its steps and the
        run's counts, and no trees."""
        from flexflow_tpu_torch import distributed, obs
        from flexflow_tpu_torch.utils import elastic, faultinject

        num_iterations = num_iterations or self.config.num_iterations
        olog = obs.NULL if self.machine.rank else obs.from_config(
            self.config, surface="fit",
            meta={"model": type(self).__name__,
                  "layers": len(self.layers),
                  "devices": self.machine.num_devices,
                  "batch_size": self.config.batch_size,
                  "iterations": num_iterations,
                  "compute_dtype": self.config.compute_dtype,
                  "strategy_ops": len(self.config.strategies)})
        inj = faultinject.from_config(self.config, olog=olog)
        restore_inj = faultinject.install_scoped(inj) if inj.enabled \
            else None
        # the drain's handlers live only inside fit and are restored on
        # every way out
        drain = {"requested": False, "signum": None}
        restore_sig = elastic.install_drain_handler(drain, log)
        run = {"model": self, "carry": None, "resizes": 0,
               "dirs": {"shrink": 0, "grow": 0}, "regrow": None,
               "regrows": 0, "prior": [], "out": set()}
        max_regrows = max(int(self.config.max_regrows or 0), 0)
        try:
            while True:
                model = run["model"]
                try:
                    out = model._fit(
                        data_iter, num_iterations, warmup, log, inj, olog,
                        drain, elastic_resume=run["carry"],
                        elastic_resizes=run["resizes"],
                        elastic_regrow=(run["regrow"]
                                        if run["regrows"] < max_regrows
                                        else None),
                        resize_dirs=run["dirs"])
                    out["loss"] = run["prior"] + out["loss"]
                    out["elastic_resizes"] = run["resizes"]
                    out["devices"] = model.machine.num_devices
                    if run["out"] and model.machine.rank == 0:
                        elastic.release_standbys(
                            sorted(run["out"]),
                            {"loss": out["loss"], "devices": out["devices"],
                             "resizes": run["resizes"],
                             "completed_steps": out["completed_steps"]})
                    return out
                except elastic.DeviceLossDetected as sig:
                    lost = self._elastic_shrink(run, sig, rebuild, olog, log,
                                                inj, data_iter, max_regrows)
                    if lost is not None:
                        return lost
                except elastic.DeviceReturnDetected as sig:
                    self._elastic_grow(run, sig, rebuild, olog, log, inj,
                                       data_iter)
        except BaseException:
            # an error exit leaves the world at once: the other ranks'
            # collectives fail instead of waiting for their timeout; the
            # ranks standing by are told the run ended
            if run["out"] and run["model"].machine.rank == 0:
                elastic.release_standbys(sorted(run["out"]),
                                         {"error": True})
            distributed.release()
            raise
        finally:
            restore_sig()
            if restore_inj is not None:
                restore_inj()
            olog.close()

    def _elastic_shrink(self, run, sig, rebuild, olog, log, inj, data,
                        max_regrows):
        """``fit``'s answer to a :class:`DeviceLossDetected`: the regrow
        context (captured before the shrink drops the lost ranks), the
        shrink (``elastic.recover``), and on a lost rank the standby
        until the run calls it back (then it lands in the grown world and
        adopts the run's counts) or ends (then it returns the record
        ``fit`` returns, ``out_of_service``)."""
        from flexflow_tpu_torch.utils import elastic

        model = run["model"]
        new_ctx = None
        if rebuild is not None and run["regrows"] < max_regrows:
            new_ctx = elastic.make_regrow_context(
                model, sig, self.config.regrow_probes, prior=run["regrow"])
        lost = [model.machine.members[o] for o in sig.dead]
        new_model, carry, kept = elastic.recover(model, sig, rebuild,
                                                 olog=olog, log=log,
                                                 data=data)
        run["prior"] = run["prior"] + kept
        if new_model is None:
            # this rank is out of service: drop its state and wait
            sig.params = sig.state = sig.opt_state = None
            msg = elastic.stand_by(model.device)
            if msg["op"] == "done":
                if msg.get("error"):
                    raise elastic.DeviceLostError(
                        "the run ended with an error while this rank "
                        "stood by")
                return {"params": {}, "state": {}, "opt_state": None,
                        "loss": msg["loss"], "elapsed_s": 0.0,
                        "images_per_sec": 0.0, "rollbacks": 0,
                        "completed_steps": msg["completed_steps"],
                        "checkpoint_s": 0.0, "final_save_s": 0.0,
                        "restore_s": 0.0, "input_stall_s": 0.0,
                        "ckpt_async_saves": 0, "ckpt_async": None,
                        "run_id": olog.run_id, "obs_path": olog.path,
                        "metrics_path": "", "out_of_service": True,
                        "out_of_service_at": sig.step,
                        "elastic_resizes": msg["resizes"],
                        "devices": msg["devices"]}
            inj.adopt(msg["injector"])
            new_model, carry = elastic.rejoin(model.config, msg, rebuild,
                                              model.device, olog=olog,
                                              log=log, data=data)
            run.update(prior=msg["loss"], resizes=msg["resizes"],
                       dirs=msg["dirs"], regrows=msg["regrows"],
                       regrow=None, out=set(msg["out"]))
        else:
            run["regrow"] = new_ctx
            run["resizes"] += 1
            run["dirs"]["shrink"] += 1
            run["out"] |= set(lost)
        run.update(model=new_model, carry=carry)
        return None

    def _elastic_grow(self, run, sig, rebuild, olog, log, inj, data):
        """``fit``'s answer to a :class:`DeviceReturnDetected`: the grow
        (``elastic.recover_grow``), whose call tells the returning ranks
        the run's counts; a grow that fails before the call keeps the
        run on the shrunk world (``model.py:1715-1733``)."""
        from flexflow_tpu_torch import distributed
        from flexflow_tpu_torch.utils import elastic

        model = run["model"]
        kept = elastic._losses(sig)
        back = set(sig.returned)
        call = {"loss": run["prior"] + kept, "resizes": run["resizes"] + 1,
                "dirs": dict(run["dirs"],
                             grow=run["dirs"]["grow"] + 1),
                "regrows": run["regrows"] + 1,
                "out": sorted(run["out"] - back),
                "injector": inj.state()}
        before = distributed.generation()
        try:
            new_model, carry, _ = elastic.recover_grow(
                model, sig, run["regrow"], rebuild, olog=olog, log=log,
                data=data, call=call)
        except Exception as e:
            if distributed.generation() != before:
                raise   # the world changed under it: nothing to go back to
            olog.event("elastic_fallback", step=sig.step,
                       reason=f"regrow failed: {e}")
            log(f"elastic: regrow failed ({e}); continuing on "
                f"{model.machine.num_devices} devices")
            carry = {"start_iter": sig.step, "params": sig.params,
                     "state": sig.state, "opt_state": sig.opt_state}
            new_model = model
        else:
            run["resizes"] += 1
            run["dirs"]["grow"] += 1
            run["out"] -= back
        run["regrow"] = None
        run["regrows"] += 1
        run["prior"] = run["prior"] + kept
        run.update(model=new_model, carry=carry)

    def _resume(self, data_iter, num_iterations, log, olog):
        """``(start_iter, params, state, opt_state)`` from the newest
        verified checkpoint under ``config.ckpt_dir``, the data stream
        advanced past its steps; None when there is none."""
        from flexflow_tpu_torch.utils import checkpoint as ckpt

        ckpt_dir = self.config.ckpt_dir
        if not ckpt_dir or ckpt.latest_step(ckpt_dir) is None:
            return None
        t0 = time.perf_counter()
        start_iter, params, state, opt_state = self._restore(ckpt_dir, olog)
        olog.event("checkpoint_restore", step=start_iter,
                   seconds=time.perf_counter() - t0, dir=ckpt_dir)
        saved = ckpt.load_strategy(ckpt_dir, step=start_iter)
        if dict(saved or {}) != dict(self.config.strategies):
            raise ValueError(
                f"checkpoint step {start_iter} under {ckpt_dir!r} was "
                f"trained under another strategy; resume it under that "
                f"strategy or point ckpt_dir elsewhere")
        log(f"resumed from {ckpt_dir} at iteration {start_iter}")
        # re-align a seeded stream with the restored position, so that the
        # resumed run matches the uninterrupted one
        skip = min(start_iter, num_iterations)
        try:
            for _ in range(skip):
                next(data_iter)
        except StopIteration:
            raise RuntimeError(
                f"checkpoint at step {start_iter} is ahead of the data "
                f"stream: it ended before the {skip} batches that re-align "
                f"the resume") from None
        return (start_iter, params, state,
                opt_state or self.init_opt_state(params))

    def _fit(self, data_iter, num_iterations, warmup, log, inj, olog,
             drain, elastic_resume=None, elastic_resizes=0,
             elastic_regrow=None, resize_dirs=None):
        from flexflow_tpu_torch.obs import metrics as obs_metrics
        from flexflow_tpu_torch.utils import checkpoint as ckpt
        from flexflow_tpu_torch.utils import elastic
        from flexflow_tpu_torch.utils.health import (StepHealthGuard,
                                                     StepWatchdog)

        cfg = self.config
        if cfg.dry_compile:
            return self._dry_run(data_iter, log, olog)
        t0 = time.perf_counter()
        if elastic_resume is not None:
            # the continuation after an elastic resize: the state lies on
            # this model's machine already, and the stream stands where
            # the resize left it
            resumed = (elastic_resume["start_iter"],
                       elastic_resume["params"], elastic_resume["state"],
                       elastic_resume["opt_state"])
        else:
            resumed = self._resume(data_iter, num_iterations, log, olog)
        restore_s = time.perf_counter() - t0 \
            if resumed is not None and elastic_resume is None else 0.0
        if resumed is not None:
            start_iter, params, state, opt_state = resumed
        else:
            start_iter = 0
            params, state = self.init()
            opt_state = self.init_opt_state(params)
        print_freq, ckpt_dir, ckpt_freq = (cfg.print_freq, cfg.ckpt_dir,
                                           cfg.ckpt_freq)
        # the writer exists on every rank, so that every rank takes the
        # same collectives; only rank 0 is handed trees to write
        awriter = ckpt.AsyncCheckpointWriter(olog=olog, log=log) \
            if ckpt_dir and cfg.ckpt_async else None
        # injected device losses are marked here and acted on at the next
        # boundary
        dead: List[int] = []
        # the transient-retry budget (3), refilled only after
        # transient_reset_steps healthy steps in a row (0: never), so that
        # spread-out hiccups are absorbed and flapping is not
        transient_retries = healthy_streak = 0
        transient_reset = max(int(cfg.transient_reset_steps or 0), 0)
        wd = StepWatchdog(cfg.hang_factor, min_deadline_s=cfg.hang_min_s,
                          olog=olog, log=log) if cfg.hang_factor > 0 else None
        hang_pending = False
        prefetcher = None
        if cfg.prefetch_depth > 0:
            from flexflow_tpu_torch.data.prefetch import DevicePrefetcher

            prefetcher = DevicePrefetcher(data_iter, self.device,
                                          cfg.prefetch_depth)
            data_iter = prefetcher
        step = self.make_train_step()
        warmup = start_iter + min(warmup,
                                  max(num_iterations - start_iter - 1, 0))
        guard = StepHealthGuard(cfg.on_divergence, cfg.max_rollbacks,
                                olog=olog, log=log)
        # the live metrics, rank 0's alone
        metrics = None if self.machine.rank else obs_metrics.from_config(
            cfg, meta={"model": type(self).__name__,
                       "run": olog.run_id or ""})
        # the step budget's host buckets: the boundaries' syncs and the
        # checkpoints' time on the boundary
        host_sync_s = checkpoint_s = 0.0
        fault_count = 0
        # losses stay device scalars until a boundary reads them; loss_base
        # is the step of losses[0] (a rollback may go back past the resume
        # point), window_start the first step the guard has not checked
        losses = []
        loss_base = window_start = it = start_iter
        # the per-step host clock (no sync) of the obs sink, the metrics
        # and the async writer's busy steps
        clock = None
        if olog.enabled or metrics is not None or awriter is not None:
            from flexflow_tpu_torch.utils.profiling import StepClock

            clock = StepClock()
        busy_steps = []
        # the sampled op timing: decided from the config alone, so that
        # every rank takes the sampled sections' collectives at one step
        sample_every = max(int(cfg.op_time_every or 0), 0) \
            if cfg.obs_dir else 0
        sections = self._make_section_fns() if sample_every else None
        op_samples = []
        start = time.perf_counter()
        last_boundary_t, last_boundary_it = start, start_iter
        drained = None
        # the loop's trace, rank 0's alone; written when the loop ends
        loop_ctx = contextlib.ExitStack()
        if cfg.trace_dir and self.machine.rank == 0:
            from flexflow_tpu_torch.utils.profiling import trace

            loop_ctx.enter_context(trace(cfg.trace_dir))
        try:
            with loop_ctx:
                while it < num_iterations:
                    batch = next(data_iter)
                    if it == warmup:
                        self._sync()
                        start = time.perf_counter()
                    try:
                        if sample_every and (it + 1) % sample_every == 0:
                            params, state, opt_state, loss = \
                                self._sampled_step(step, sections,
                                                   op_samples, it, params,
                                                   state, opt_state, batch)
                        else:
                            params, state, opt_state, loss = step(
                                params, state, opt_state, *batch)
                        if transient_retries:
                            healthy_streak += 1
                            if transient_reset \
                                    and healthy_streak >= transient_reset:
                                transient_retries = healthy_streak = 0
                                olog.event("recovery", source="elastic",
                                           after="transient_window",
                                           step=it + 1)
                    except Exception as e:
                        # a transient device error retries the iteration on a
                        # fresh batch; a permanent one raises
                        # DeviceLossDetected; anything else propagates
                        if self._classify_step_error(
                                e, it + 1, olog, losses, loss_base,
                                transient_retries) != "transient":
                            raise
                        transient_retries += 1
                        healthy_streak = 0
                        continue
                    if inj.enabled:
                        if inj.fire("loss_nan", site="fit"):
                            # poison the recorded loss on the device; the
                            # guard sees it at the next boundary
                            loss = loss * float("nan")
                        if inj.fire("host_crash", site="fit"):
                            raise elastic.HostCrashError(
                                f"injected host crash at iteration {it + 1}")
                        if inj.fire("device_loss", site="fit"):
                            # the highest live ordinal is lost for good
                            alive = [i for i in range(self.machine.num_devices)
                                     if i not in dead]
                            if alive:
                                dead.append(alive[-1])
                        if inj.fire("preempt", site="fit"):
                            elastic.request_drain(drain)
                        if inj.fire("step_hang", site="fit"):
                            # wedge the next boundary past the deadline
                            hang_pending = True
                    losses.append(loss)
                    if clock is not None:
                        clock.tick()
                        if awriter is not None and awriter.inflight:
                            busy_steps.append(it + 1)
                    it1 = it + 1
                    at_print = bool(print_freq) and it1 % print_freq == 0
                    at_ckpt = bool(ckpt_dir) and bool(ckpt_freq) \
                        and it1 % ckpt_freq == 0 and it1 < num_iterations
                    at_boundary = at_print or at_ckpt or it1 == num_iterations
                    if at_boundary:
                        if wd is not None:
                            # armed around the boundary's blocking syncs, the
                            # estimate fed by the wall time between boundaries
                            now = time.perf_counter()
                            wd.observe(now - last_boundary_t,
                                       it1 - last_boundary_it)
                            last_boundary_t, last_boundary_it = now, it1
                            wd.arm(it1)
                            if hang_pending:
                                hang_pending = False
                                wd.stall()
                        if dead:
                            self._raise_device_loss(dead, it1, params, state,
                                                    opt_state, losses,
                                                    loss_base)
                        tb0 = time.perf_counter()
                        action = guard.check(losses[window_start - loss_base:],
                                             first_step=window_start + 1)
                        if action == "rollback":
                            host_sync_s += time.perf_counter() - tb0
                            if wd is not None:
                                wd.disarm()
                            t0 = time.perf_counter()
                            # the restore must see the newest commit
                            self._writer_wait(awriter)
                            it, params, state, opt_state = \
                                self._rollback_restore(ckpt_dir, olog, log,
                                                       it1)
                            restore_s += time.perf_counter() - t0
                            del losses[max(it - loss_base, 0):]
                            loss_base = min(loss_base, it)
                            window_start = it
                            # the stream is not rewound: the re-run steps take
                            # fresh batches, past the bad window
                            continue
                        window_start = it1
                        host_sync_s += time.perf_counter() - tb0
                    if at_print:
                        tb0 = time.perf_counter()
                        log(f"iter {it1}: loss = {float(loss):.4f}")
                        host_sync_s += time.perf_counter() - tb0
                    if at_ckpt:
                        t0 = time.perf_counter()
                        if not self._save(ckpt, it1, params, state, opt_state,
                                          log, olog, awriter):
                            fault_count += 1
                        checkpoint_s += time.perf_counter() - t0
                    if wd is not None and at_boundary:
                        hang = self._hang_agreed(wd.disarm())
                        if hang is not None:
                            self._handle_step_hang(hang, it1, params, state,
                                                   opt_state, losses,
                                                   loss_base, olog, log)
                    if elastic_regrow and at_boundary \
                            and it1 < num_iterations \
                            and elastic.probe_regrow(elastic_regrow, inj=inj,
                                                     olog=olog, log=log,
                                                     machine=self.machine):
                        # the lost ranks answered k probes in a row: hand the
                        # live state to fit for the grow
                        raise elastic.DeviceReturnDetected(
                            [d for d, _ in elastic_regrow["dead"]],
                            it1, params=params, state=state,
                            opt_state=opt_state, losses=losses,
                            loss_base=loss_base)
                    if at_boundary and it1 < num_iterations:
                        drain["requested"] = self._drain_agreed(drain)
                    if metrics is not None and (at_print or at_ckpt):
                        self._metrics_update(
                            metrics, olog, params, losses, it1, warmup, start,
                            guard, prefetcher, fault_count, awriter=awriter,
                            elastic_resizes=elastic_resizes,
                            resize_dirs=resize_dirs,
                            draining=drain["requested"])
                    if drain["requested"] and at_boundary \
                            and it1 < num_iterations:
                        # the step in flight has finished: commit a last
                        # checkpoint within the budget, record it, and leave
                        drained = self._drain_checkpoint(
                            ckpt, awriter, it1, params, state, opt_state,
                            drain,
                            olog, log, just_saved=at_ckpt)
                        it = it1
                        break
                    it = it1
                self._sync()
                elapsed = time.perf_counter() - start
        except BaseException:
            # the error exit: stop the staging thread, abandon the writer
            # without blocking on its queue, join the watchdog's timer
            if prefetcher is not None:
                prefetcher.close()
            if awriter is not None:
                awriter.close(timeout=5.0)
            if wd is not None:
                wd.close()
            raise
        if prefetcher is not None:
            prefetcher.close()
        if wd is not None:
            wd.close()
        final_save_s = 0.0
        if ckpt_dir and start_iter < num_iterations and drained is None:
            # the final save is the one write fit waits for: a returning
            # run leaves a committed, verified state
            t0 = time.perf_counter()
            self._save(ckpt, num_iterations, params, state, opt_state, log,
                       olog, awriter)
            self._writer_wait(awriter)
            final_save_s = time.perf_counter() - t0
        if awriter is not None:
            awriter.close()
        n_timed = it - warmup
        throughput = (n_timed * cfg.batch_size / elapsed
                      if elapsed > 0 and n_timed > 0 else 0.0)
        log(f"time = {elapsed:.4f}s, tp = {throughput:.2f} images/s")
        losses = torch.stack(losses).tolist() if losses else []
        if metrics is not None:
            # the settled end-of-run numbers (the only write of a run
            # whose print and checkpoint boundaries never came)
            self._metrics_update(
                metrics, olog, params, losses, it, warmup, start, guard,
                prefetcher, fault_count, elapsed=elapsed,
                throughput=throughput, awriter=awriter,
                elastic_resizes=elastic_resizes, resize_dirs=resize_dirs,
                draining=drained is not None)
        if olog.enabled:
            budget_totals = {
                "host_sync_s": host_sync_s, "checkpoint_s": checkpoint_s,
                "input_stall_s": prefetcher.stall_s if prefetcher else 0.0,
                "input_batches": prefetcher.batches if prefetcher else 0,
                "steps": it - start_iter}
            self._emit_fit_records(olog, clock, losses, start_iter, warmup,
                                   it, elapsed, throughput, op_samples,
                                   budget_totals)
            if prefetcher is not None:
                olog.event("prefetch", **prefetcher.summary())
        if cfg.profiling and self.machine.rank == 0:
            self._profiling_report(log, elapsed, n_timed)
        out = {"params": params, "state": state, "opt_state": opt_state,
               "loss": losses,
               "elapsed_s": elapsed, "images_per_sec": throughput,
               "rollbacks": guard.rollbacks, "completed_steps": it,
               "checkpoint_s": checkpoint_s, "final_save_s": final_save_s,
               "restore_s": restore_s,
               "input_stall_s": prefetcher.stall_s if prefetcher else 0.0,
               "ckpt_async_saves": awriter.saves if awriter else 0,
               "ckpt_async": ({"commits": awriter.commits,
                               "busy_steps": busy_steps,
                               "step_s": clock.deltas}
                              if awriter is not None else None),
               "run_id": olog.run_id, "obs_path": olog.path,
               "metrics_path": metrics.path if metrics is not None else ""}
        if drained is not None:
            out["drained"] = True
            out["drain"] = drained
        return out

    def abstract_train_state(self):
        """``(params, state, opt_state)`` of this rank on the ``meta``
        device: the trees' shapes and dtypes, nothing allocated
        (``flexflow_tpu/model.py:abstract_train_state``)."""
        meta = torch.device("meta")
        params: Dict[str, Dict] = {}
        state: Dict[str, Dict] = {}
        for op in self.layers:
            if op.param_key not in params:
                p = op.init_params(None, meta)
                if p:
                    params[op.param_key] = self._cast_param_tree(p)
            st = op.init_state(meta)
            if st:
                state[op.name] = st
        if self.sharded:
            params, state = self.shard_params(params), self.shard_state(state)
        return params, state, self.init_opt_state(params)

    def _dry_run(self, data_iter, log, olog) -> Dict[str, Any]:
        """``--dry-compile`` (DISABLE_COMPUTATION, ops.h:19;
        ``flexflow_tpu/model.py:1766-1789``): the model, its grids, its
        placement, its regrid plans and process groups are built on every
        rank, and one training step is traced on ``meta`` tensors
        (parameters, optimizer state and one batch of the data source's
        shapes): the kernels' wrappers and the collectives give their
        outputs' shapes, so nothing runs, nothing is put on the card and
        no collective is issued.  Writes one ``compile`` record with
        ``dry=True``, ``seconds`` and ``flops`` (:meth:`step_flops`; the
        port has no ``bytes_accessed``), logs ``dry-compile ok: ...`` and
        returns no trees; ``compiled`` is the plan's summary (layers,
        step FLOPs, the trees' and the batch's bytes, regrid hops)."""
        t0 = time.perf_counter()
        batch = tuple(torch.empty(b.shape, dtype=b.dtype, device="meta")
                      for b in (torch.as_tensor(a) for a in next(data_iter)))
        machine = self.machine
        dev, built = machine.device, self._plan is not None
        machine.device = torch.device("meta")
        try:
            params, state, opt_state = self.abstract_train_state()
            out = self.make_train_step()(params, state, opt_state, *batch)
            hops = 0 if self._plan is None else sum(
                len(ep.chain) for ep in self._plan.edges.values())
        finally:
            machine.device = dev
            if not built:
                # the plans built here hold meta buffers: a later run
                # builds its own
                self._plan = None
        if any(t.device.type != "meta" for t in _leaves(out)):
            raise AssertionError("the dry run's step left the meta device")
        arg_bytes = sum(t.numel() * t.element_size() for t in _leaves(
            (params, state, opt_state, batch)))
        flops = self.step_flops()
        olog.event("compile", seconds=time.perf_counter() - t0,
                   flops=flops, dry=True)
        log(f"dry-compile ok: {len(self.layers)} layers, "
            f"flops/step = {flops:.3e}, argument bytes = {arg_bytes}")
        return {"params": None, "state": None, "opt_state": None,
                "loss": [], "elapsed_s": 0.0, "images_per_sec": 0.0,
                "completed_steps": 0,
                "compiled": {"layers": len(self.layers), "step_flops": flops,
                             "argument_bytes": arg_bytes,
                             "regrid_hops": hops}}

    def _profiling_report(self, log, elapsed: float, n_timed: int) -> None:
        """The ``profiling`` flag's report (``model.py:2258-2282``): the
        step roofline, then the per-op table."""
        from flexflow_tpu_torch.utils.profiling import (OpProfiler,
                                                        step_roofline)

        if n_timed > 0 and elapsed > 0:
            rl = step_roofline(self.step_flops(), elapsed / n_timed,
                               self.config.compute_dtype, self.device,
                               n_devices=self.machine.num_devices)
            mfu = (f"MFU {100.0 * rl['mfu']:.1f}% of "
                   f"{rl['peak_tflops']:.0f} TFLOP/s "
                   f"({self.config.compute_dtype} peak)"
                   if "mfu" in rl else f"MFU not measured ({self.device})")
            log(f"step roofline (FFModel.step_flops): {rl['flops']:.3e} "
                f"FLOPs/step, {rl.get('achieved_tflops', 0.0):.2f} "
                f"TFLOP/s, {mfu}")
        log(OpProfiler(self).report())

    # ------------------------------------------------------------------
    # the runtime's faults, its drain and its live metrics
    # (model.py:2300-2345, :2598-2765)

    def _raise_device_loss(self, dead, step, params, state, opt_state,
                           losses, loss_base):
        """Injected device losses at a boundary: under ``elastic`` the
        loop's state goes to ``fit`` for the shrink, else the loss is
        fatal (``model.py:2300``)."""
        from flexflow_tpu_torch.utils import elastic

        if self.config.elastic:
            raise elastic.DeviceLossDetected(
                dead=dead, step=step, params=params, state=state,
                opt_state=opt_state, losses=losses, loss_base=loss_base,
                injected=True)
        raise elastic.DeviceLostError(
            f"permanent device loss at iteration {step} (ordinals "
            f"{sorted(set(dead))}); run with --elastic to recover on "
            f"the surviving mesh")

    def _hang_agreed(self, hang):
        """Under ``elastic`` over several ranks, whether any rank's
        watchdog expired at this boundary (the world's MAX, so that every
        rank probes; the largest deadline as the record's): ``hang`` of
        this rank elsewhere."""
        group = self._world_handle()
        if not self.config.elastic or group is None:
            return hang
        import torch.distributed as dist

        t = torch.tensor([float(hang is not None),
                          float((hang or {}).get("deadline_s", 0.0))],
                         device=self.device)
        dist.all_reduce(t, op=dist.ReduceOp.MAX, group=group)
        flag, deadline = t.tolist()
        if not flag:
            return None
        return hang or {"deadline_s": deadline}

    def _handle_step_hang(self, info, step, params, state, opt_state,
                          losses, loss_base, olog, log):
        """A boundary that returned past the watchdog's deadline
        (``model.py:2317``): without ``elastic`` it is fatal; with it the
        devices are probed, a dead one raises ``DeviceLossDetected`` (the
        live state migrates), and when all answer the hang was transient
        and the run goes on."""
        from flexflow_tpu_torch.utils import elastic

        if not self.config.elastic:
            raise elastic.DeviceLostError(
                f"boundary at iteration {step} exceeded the step "
                f"watchdog deadline ({info['deadline_s']:.1f}s); run "
                f"with --elastic to probe and recover instead of "
                f"failing")
        live, dead, transient = elastic.probe_devices(self.machine,
                                                      olog=olog)
        if dead:
            raise elastic.DeviceLossDetected(
                dead=dead, step=step, params=params, state=state,
                opt_state=opt_state, losses=losses, loss_base=loss_base)
        olog.event("device_loss", step=step, classification="transient",
                   transient=transient, source="watchdog",
                   deadline_s=info["deadline_s"])
        log(f"watchdog: iteration {step} boundary returned past its "
            f"{info['deadline_s']:.1f}s deadline but every device "
            f"probes healthy — continuing")

    def _classify_step_error(self, e, step, olog, losses, loss_base,
                             transient_retries):
        """A step that raised, under ``elastic`` (``model.py:2411``):
        ``"transient"`` when ``elastic.classify`` calls it a device's and
        the probe recovers (the caller retries the iteration, at most 3
        times in a budget), ``DeviceLossDetected`` with no live state
        (the failed step's inputs are gone: the checkpoint fallback) when
        a device probes dead, None for anything else (the caller
        re-raises)."""
        if not self.config.elastic:
            return None
        from flexflow_tpu_torch.utils import elastic

        if not elastic.classify(e):
            return None
        live, dead, transient = elastic.probe_devices(self.machine,
                                                      olog=olog)
        if dead:
            raise elastic.DeviceLossDetected(
                dead=dead, step=step, params=None, state=None,
                opt_state=None, losses=losses,
                loss_base=loss_base) from e
        if transient_retries >= 3:
            return None   # a persistent failure with healthy probes: a bug
        olog.event("device_loss", step=step, classification="transient",
                   transient=transient, error=str(e))
        return "transient"

    def _world_handle(self):
        """The world's process group handle, or None in a world of one
        (no collective to take)."""
        if self.machine.num_devices <= 1:
            return None
        return self.machine.world_group().handle

    def _drain_agreed(self, drain) -> bool:
        """Whether any rank was asked to drain: the world's MAX of the
        flag, taken at every boundary of a world of several ranks, so that
        every rank stops at the same one (a signal may reach the ranks
        during different steps); ``drain["signum"]`` becomes the largest
        signal number asked.  This rank's flag in a world of one."""
        group = self._world_handle()
        if group is None:
            return bool(drain["requested"])
        import torch.distributed as dist

        t = torch.tensor([float(bool(drain["requested"])),
                          float(drain["signum"] or 0)], device=self.device)
        dist.all_reduce(t, op=dist.ReduceOp.MAX, group=group)
        flag, signum = t.tolist()
        if flag and not drain["requested"]:
            drain["signum"] = int(signum) or None
        return bool(flag)

    def _writer_wait(self, awriter, timeout: Optional[float] = None) -> bool:
        """Wait for the async writer (when there is one: every rank has
        one or none) and, over several ranks, agree: True when every
        rank's writer drained in time.  The ranks then pass one barrier,
        so that a restore reads the commit."""
        if awriter is None:
            return True
        done = awriter.wait(timeout=timeout)
        group = self._world_handle()
        if group is None:
            return done
        import torch.distributed as dist

        t = torch.tensor([float(done)], device=self.device)
        dist.all_reduce(t, op=dist.ReduceOp.MIN, group=group)
        dist.barrier(group=group)
        return bool(t.item())

    def _drain_checkpoint(self, ckpt, awriter, step, params, state,
                          opt_state, drain, olog, log, just_saved=False):
        """The graceful drain's checkpoint (``model.py:2345``), committed
        within ``drain_budget_s``: the async writer's wait (mode
        ``async``), a synchronous save when it missed the budget
        (``sync_fallback``), this boundary's synchronous save
        (``boundary_save``), a synchronous save (``sync``), no checkpoint
        directory (``none``) or a save that failed (``failed``).  Writes
        the one ``preempt_drain`` record, leaves the process group, and
        returns the record."""
        from flexflow_tpu_torch import distributed

        t0 = time.perf_counter()
        ckpt_dir = self.config.ckpt_dir
        budget = float(self.config.drain_budget_s or 60.0)
        mode, ckpt_step = "none", None
        if ckpt_dir:
            if awriter is not None:
                if not just_saved:
                    self._save(ckpt, step, params, state, opt_state, log,
                               olog, awriter)
                left = max(budget - (time.perf_counter() - t0), 0.05)
                if self._writer_wait(awriter, timeout=left):
                    mode, ckpt_step = "async", step
                else:
                    log(f"drain: async writer missed the {budget:.0f}s "
                        f"budget; falling back to a best-effort sync save")
                    mode, ckpt_step = self._drain_save(
                        ckpt, step, params, state, opt_state, log, olog,
                        "sync_fallback")
            elif just_saved:
                # this boundary's synchronous save has committed
                mode, ckpt_step = "boundary_save", step
            else:
                mode, ckpt_step = self._drain_save(
                    ckpt, step, params, state, opt_state, log, olog, "sync")
        group = self._world_handle()
        if group is not None:
            # rank 0 wrote: its outcome is every rank's
            import torch.distributed as dist

            agreed = [(mode, ckpt_step)]
            dist.broadcast_object_list(agreed, src=0, group=group)
            mode, ckpt_step = agreed[0]
        seconds = time.perf_counter() - t0
        info = {"step": step, "steps_completed": step,
                "ckpt_step": ckpt_step, "signal": drain.get("signum"),
                "seconds": seconds, "budget_s": budget, "mode": mode}
        olog.event("preempt_drain", **info)
        at = (f"checkpoint at step {ckpt_step}" if ckpt_step is not None
              else "no checkpoint")
        log(f"drain: stopped cleanly at iteration {step} ({at}, "
            f"{seconds:.2f}s of the {budget:.0f}s budget, mode {mode})")
        distributed.release()
        return info

    def _drain_save(self, ckpt, step, params, state, opt_state, log, olog,
                    mode):
        """A synchronous save of the drain: ``(mode, step)`` when it
        committed, ``("failed", None)`` when it did not."""
        try:
            if self._save(ckpt, step, params, state, opt_state, log, olog):
                return mode, step
        except Exception as e:
            log(f"warning: drain checkpoint failed: {e}")
        return "failed", None

    def step_flops(self) -> float:
        """The modeled FLOPs of one training step over every device: each
        op's forward FLOPs at 3x for the forward and the backward
        (``sim/cost_model.py:shard_flops``), over all its shards.  The
        port has no compiled program to ask, as the JAX package asks XLA's
        cost analysis (``model.py:2566``)."""
        from flexflow_tpu_torch.sim.cost_model import shard_flops

        return float(sum(shard_flops(op, op.pc) * op.pc.num_parts
                         for op in self.layers))

    def _metrics_update(self, metrics, olog, params, losses, it1, warmup,
                        start_t, guard, prefetcher, fault_count,
                        elapsed=None, throughput=None, awriter=None,
                        elastic_resizes=0, resize_dirs=None,
                        draining=False):
        """Refresh and publish the live gauges (``model.py:2598``) at a
        boundary that has synced: the throughput and the step time since
        the timed window opened, ``mfu`` from :meth:`step_flops` over the
        card's peak for the compute dtype (``HopperChipPerf.flops_rate``,
        times the devices), the device memory's live and peak bytes
        (``torch.cuda``; none on the CPU), the counters.  Writes the files
        and mirrors them as a ``metrics`` record."""
        from flexflow_tpu_torch.sim.cost_model import HopperChipPerf

        if "flops" not in metrics.cache:
            metrics.cache["flops"] = self.step_flops()
        flops = metrics.cache["flops"]
        n_timed = it1 - warmup
        if elapsed is None:
            elapsed = time.perf_counter() - start_t
        if throughput is None:
            throughput = (n_timed * self.config.batch_size / elapsed
                          if n_timed > 0 and elapsed > 0 else None)
        step_s = (elapsed / n_timed if n_timed > 0 and elapsed > 0
                  else None)
        peak = HopperChipPerf().flops_rate(self.config.compute_dtype) \
            * max(self.machine.num_devices, 1)
        # no byte count without a compiled program, so no roofline floor:
        # the exporter drops the None mfu_ceiling gauge
        mfu = flops / step_s / peak if flops and step_s else None
        hbm_live = hbm_peak = None
        if self.device.type == "cuda":
            hbm_live = torch.cuda.memory_allocated(self.device)
            hbm_peak = torch.cuda.max_memory_allocated(self.device)
        last_loss = None
        if losses:
            try:   # the boundary has synced; this is a small copy
                last_loss = float(losses[-1])
            except (TypeError, ValueError):
                pass
        param_bytes = float(sum(v.numel() * v.element_size()
                                for sub in params.values()
                                for v in sub.values()))
        metrics.update(
            param_bytes_total=param_bytes,
            throughput_items_per_sec=throughput,
            images_per_sec=throughput,
            mfu=mfu, mfu_ceiling=None,
            step_wall_seconds=step_s, loss=last_loss,
            steps_total=it1,
            hbm_peak_bytes=hbm_peak, hbm_live_bytes=hbm_live,
            prefetch_stall_seconds_total=(prefetcher.stall_s
                                          if prefetcher else 0.0),
            rollbacks_total=guard.rollbacks,
            faults_total=fault_count + (awriter.faults
                                        if awriter is not None else 0),
            elastic_events=elastic_resizes,
            drain_pending=1.0 if draining else 0.0,
            ckpt_async_inflight=(awriter.inflight
                                 if awriter is not None else 0))
        for direction in ("shrink", "grow"):
            metrics.update_labeled("elastic_events",
                                   {"direction": direction},
                                   (resize_dirs or {}).get(direction, 0))
        try:
            metrics.write()
        except OSError as e:
            import warnings

            warnings.warn(f"metrics export failed: {e}", RuntimeWarning)
            return
        olog.event("metrics", path=metrics.path, **metrics.finite_values())

    def _sim_comm_s(self):
        """The simulator's collective seconds for the loaded strategy
        (``model.py:2687``), the ``comm`` bucket's first source; None
        without a strategy or when the simulation fails."""
        if not self.config.strategies:
            return None
        try:
            from flexflow_tpu_torch.sim.search import StrategySearch

            ss = StrategySearch(self, machine=self.machine)
            rows = ss.cost_breakdown(
                ss.assignment_for(self.config.strategies))
            return sum(r["collective_s"] for r in rows)
        except Exception:
            return None

    def _emit_step_budget(self, olog, totals, op_samples, op_rows,
                          elapsed, n_timed):
        """The run's ``step_budget`` record (``model.py:2705``): one
        sampled (or loop-mean) step's wall time split into compute, comm,
        input stall, host sync, checkpoint and residual, every input an
        existing measurement or an amortized total.  None without timed
        steps."""
        from flexflow_tpu_torch.obs.budget import build_step_budget

        sources = {}
        walls = sorted(s["step_s"] for s in op_samples if s.get("step_s"))
        if walls:
            wall = walls[len(walls) // 2]
            sources["wall"] = "sampled_step"
        elif n_timed > 0 and elapsed > 0:
            wall = elapsed / n_timed
            sources["wall"] = "loop_mean"
        else:
            return
        compute = None
        if op_rows:
            # the ops' shards timed alone estimate the forward and backward
            # without collectives; the optimizer section adds the update
            iso = sum(r["seconds"] for r in op_rows)
            opts = sorted(max(s["step_s"] - s["forward_backward"], 0.0)
                          for s in op_samples
                          if s.get("step_s") is not None
                          and s.get("forward_backward") is not None)
            compute = iso + (opts[len(opts) // 2] if opts else 0.0)
            sources["compute"] = (
                "isolated_ops+optimizer_section"
                if all(r["measured"] for r in op_rows)
                else "isolated_ops(analytic_standins)+optimizer_section")
        comm = self._sim_comm_s()
        if comm is not None:
            sources["comm"] = "sim"
        elif op_rows:
            # the fused forward-backward section less the ops alone: the
            # step's communication the isolated timing cannot see
            fbs = sorted(s["forward_backward"] for s in op_samples
                         if s.get("forward_backward") is not None)
            if fbs:
                comm = max(fbs[len(fbs) // 2]
                           - sum(r["seconds"] for r in op_rows), 0.0)
                sources["comm"] = "section_residual"
        steps = max(int(totals.get("steps", 0)), 1)
        batches = int(totals.get("input_batches", 0)) or steps
        olog.event("step_budget", **build_step_budget(
            wall, compute_s=compute, comm_s=comm,
            input_stall_s=totals.get("input_stall_s", 0.0) / batches,
            host_sync_s=totals.get("host_sync_s", 0.0) / steps,
            checkpoint_s=totals.get("checkpoint_s", 0.0) / steps,
            sources=sources, n_samples=len(op_samples)))

    # ------------------------------------------------------------------
    # run telemetry (model.py:2467-2860)

    def _make_section_fns(self):
        """``(forward, forward_backward)`` of the training step for the
        sampled op timing: the loss in training mode without gradients,
        and the loss with the gradients of every float leaf
        (``torch.autograd.grad``, the ranks' gradient sums included).
        Neither touches a ``.grad``, and the new BatchNorm state each
        computes is dropped, so timing them leaves training as it was."""
        cdtype = torch_dtype(self.config.compute_dtype)

        def forward(params, state, *batch):
            with torch.no_grad():
                if self._mixed_precision():
                    params = _cast_floats(params, cdtype)
                loss, _ = self.loss_fn(params, state, *self._batch(*batch),
                                       train=True)
            return loss

        def forward_backward(params, state, *batch):
            loss, _, _, grads = self._loss_and_grads(params, state, batch)
            return loss, grads

        return forward, forward_backward

    def _sampled_step(self, step, sections, op_samples, it, params, state,
                      opt_state, batch):
        """One step of the sampled op timing (``model.py:2497``): drain
        the device, time the forward and the forward + backward sections,
        then run the real step once, each ended by a device sync and
        marked for ``torch.profiler`` as ``op_time:<section>``; the
        backward and optimizer times follow by subtraction.  Returns the
        real step's result."""
        from torch.profiler import record_function

        forward, forward_backward = sections
        self._sync()
        rec = {"step": it + 1}
        t0 = time.perf_counter()
        with record_function("op_time:forward"):
            forward(params, state, *batch)
            self._sync()
        rec["forward"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        with record_function("op_time:forward_backward"):
            forward_backward(params, state, *batch)
            self._sync()
        rec["forward_backward"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        with record_function("op_time:step"):
            out = step(params, state, opt_state, *batch)
            self._sync()
        rec["step_s"] = time.perf_counter() - t0
        op_samples.append(rec)
        return out

    def _emit_op_times(self, olog, op_samples) -> list:
        """The ``op_time`` records of a sampled run (``model.py:2531``):
        each sample's sections (backward and optimizer by subtraction,
        clamped at 0), then one shard of every op under its config timed
        alone (:func:`~flexflow_tpu_torch.utils.profiling.time_op_shard`),
        the analytic cost standing in where the op has no clone
        (``measured`` false).  Returns the op rows (``op``, ``seconds``,
        ``measured``) for the step budget."""
        from flexflow_tpu_torch.sim.cost_model import AnalyticCostModel
        from flexflow_tpu_torch.utils.profiling import time_op_shard

        for s in op_samples:
            fw = s.get("forward", 0.0)
            fb = s.get("forward_backward", 0.0)
            st = s.get("step_s", 0.0)
            for name, secs in (("forward", fw),
                               ("backward", max(fb - fw, 0.0)),
                               ("optimizer", max(st - fb, 0.0)),
                               ("step", st)):
                olog.event("op_time", scope="section", section=name,
                           step=s["step"], seconds=secs)
        analytic = AnalyticCostModel()
        rows = []
        for op in self.layers:
            t = time_op_shard(op, op.pc, dtype=self.config.compute_dtype,
                              device=self.device)
            measured = t is not None
            if not measured:
                t = analytic.op_cost(op, op.pc)
            olog.event("op_time", scope="op", op=op.name,
                       op_kind=type(op).__name__, grid=list(op.pc.dims),
                       seconds=t, measured=measured)
            rows.append({"op": op.name, "seconds": float(t),
                         "measured": measured})
        return rows

    def _emit_fit_records(self, olog, clock, losses, start_iter, warmup,
                          num_iterations, elapsed, throughput,
                          op_samples, budget_totals) -> None:
        """The fit surface's records after the loop (``model.py:2767``):
        ``compile`` (the first step's wall seconds and :meth:`step_flops`:
        there is no compiled program to analyse), ``step`` per step,
        ``summary``, the ``op_time`` records of a sampled run,
        ``step_budget``, then ``sim_drift`` or
        ``sim_drift_unavailable``."""
        bsz = self.config.batch_size
        olog.event("compile",
                   seconds=clock.deltas[0] if clock.deltas else 0.0,
                   flops=self.step_flops())
        for i, dt in enumerate(clock.deltas):
            it = start_iter + i
            olog.event("step", step=it + 1, wall_ms=dt * 1e3,
                       loss=losses[i] if i < len(losses) else None,
                       images_per_sec=bsz / dt if dt > 0 else 0.0,
                       timed=it >= warmup)
        olog.event("summary", iterations=num_iterations - start_iter,
                   warmup=warmup - start_iter, elapsed_s=elapsed,
                   images_per_sec=throughput,
                   final_loss=losses[-1] if losses else None)
        op_rows = self._emit_op_times(olog, op_samples) if op_samples \
            else []
        n_timed = num_iterations - warmup
        self._emit_step_budget(olog, budget_totals, op_samples, op_rows,
                               elapsed, n_timed)
        if not self.config.strategies:
            olog.event("sim_drift_unavailable",
                       reason="no strategy loaded (pure-DP default run; "
                              "no simulator prediction to compare)")
        elif n_timed <= 0 or elapsed <= 0:
            olog.event("sim_drift_unavailable",
                       reason="no timed steps (every iteration was "
                              "warmup)")
        else:
            self._emit_sim_drift(olog, elapsed / n_timed)

    def _emit_sim_drift(self, olog, measured_step_s: float) -> None:
        """The measured step over the simulator's prediction for the
        loaded strategy (``model.py:2826``): the ``__predicted__`` block
        of the search's file first, else the analytic simulation of this
        model's strategy; >1 means the simulator is optimistic."""
        pred = getattr(self.config.strategies, "predicted", None)
        predicted_s, source = None, None
        if pred and pred.get("best_time_s"):
            predicted_s, source = float(pred["best_time_s"]), "artifact"
        else:
            try:
                from flexflow_tpu_torch.sim.search import StrategySearch

                ss = StrategySearch(self, machine=self.machine)
                predicted_s = ss.simulate(
                    ss.assignment_for(self.config.strategies))
                source = "analytic"
            except Exception as e:
                olog.event("sim_drift_unavailable", error=str(e),
                           reason=f"simulating the loaded strategy "
                                  f"failed: {e}")
                return
        if predicted_s and predicted_s > 0:
            olog.event("sim_drift", name="sim_drift",
                       value=measured_step_s / predicted_s,
                       predicted_s=predicted_s,
                       measured_s=measured_step_s, source=source)
        else:
            olog.event("sim_drift_unavailable",
                       reason="artifact carries a non-positive "
                              "prediction")

    def _save(self, ckpt, step, params, state, opt_state, log, olog=None,
              awriter=None) -> bool:
        """One checkpoint save: synchronous (with a ``checkpoint_save``
        record), or the host snapshot handed to ``awriter``.  Non-finite
        state is refused, logged and recorded as a ``fault``, never
        committed over good checkpoints (the guard decides the run's
        fate); False then.  Over several ranks every rank's blocks are
        gathered into whole leaves (:meth:`gather_trees`, on the boundary
        on every rank), rank 0 writes or submits them, and every rank
        then waits at one barrier."""
        from flexflow_tpu_torch import obs

        olog = olog if olog is not None else obs.NULL
        multi = self.machine.num_devices > 1
        t0 = time.perf_counter()
        trees = self.gather_trees(params, state, opt_state) if multi \
            else (params, state, opt_state)
        try:
            if trees is not None and awriter is not None:
                awriter.submit(self.config.ckpt_dir, step, *trees,
                               self.config.strategies)
            elif trees is not None:
                ckpt.save_checkpoint(self.config.ckpt_dir, step, *trees,
                                     self.config.strategies)
                olog.event("checkpoint_save", step=step,
                           seconds=time.perf_counter() - t0,
                           dir=self.config.ckpt_dir)
            return True
        except ckpt.NonFiniteCheckpointError as e:
            olog.event("fault", source="checkpoint",
                       fault="nonfinite_state", step=step, error=str(e))
            log(f"warning: skipped checkpoint at iteration {step}: {e}")
            return False
        finally:
            if multi:
                import torch.distributed as dist

                dist.barrier(group=self.machine.world_group().handle)

    def _restore(self, ckpt_dir, olog=None):
        """``(step, params, state, opt_state)`` of the newest verified
        checkpoint under ``ckpt_dir`` (falling back past corrupt steps);
        over several ranks every rank reads the whole leaves and keeps
        the blocks it holds under the strategy (:meth:`shard_params`,
        :meth:`shard_state`, and each optimizer leaf as its param)."""
        from flexflow_tpu_torch.utils import checkpoint as ckpt

        step, params, state, opt_state = \
            ckpt.restore_checkpoint(ckpt_dir, self, olog=olog)
        if self.machine.num_devices > 1:
            params = self.shard_params(params)
            state = self.shard_state(state)
            opt_state = self._shard_opt(opt_state or {})
        return step, params, state, opt_state

    @staticmethod
    def _param_leaf(opt_leaf: str) -> str:
        """The param leaf an optimizer leaf mirrors (its momentum, or
        its float32 master)."""
        return opt_leaf[:-len(MASTER_SUFFIX)] \
            if opt_leaf.endswith(MASTER_SUFFIX) else opt_leaf

    def _shard_opt(self, opt_state, position: Optional[int] = None):
        """The blocks of a whole optimizer tree held at ``position``
        (default this rank's): each leaf as the param leaf it mirrors."""
        self._setup_sharded()
        pos = self.machine.position if position is None else position
        boxes = self._store["params"]
        out = {}
        for key, sub in opt_state.items():
            held = {leaf: boxes[key][self._param_leaf(leaf)][pos]
                    for leaf in sub}
            if any(b is None for b in held.values()):
                continue   # held only on the ranks that run its ops
            out[key] = {leaf: v[tuple(slice(lo, hi) for lo, hi
                                      in held[leaf])].contiguous()
                        for leaf, v in sub.items()}
        return out

    def gather_trees(self, params, state, opt_state, dst: Optional[int] = 0):
        """Whole ``(params, state, opt_state)`` trees (host tensors) from
        every rank's blocks, on rank ``dst`` (on every rank when ``dst``
        is None); None on the others.  Every rank calls it: each sends
        the blocks of which it is the first holder (the position whose
        box it is first), so that each element arrives once, and rank
        ``dst`` lays them into their leaves."""
        import torch.distributed as dist

        self._setup_sharded()
        pos = self.machine.position
        store = self._store

        def first(boxes):
            mine = boxes[pos]
            return mine is not None and boxes.index(mine) == pos

        mine = []
        for tree, sub_trees, where in (
                ("params", params, lambda k, leaf: store["params"][k][leaf]),
                ("state", state, lambda k, leaf: store["state"][k][leaf]),
                ("opt", opt_state or {},
                 lambda k, leaf: store["params"][k][self._param_leaf(leaf)])):
            for key, sub in sub_trees.items():
                for leaf, v in sub.items():
                    boxes = where(key, leaf)
                    if first(boxes):
                        mine.append((tree, key, leaf, boxes[pos],
                                     v.detach().cpu()))
        every = [None] * self.machine.num_devices
        dist.all_gather_object(every, mine,
                               group=self.machine.world_group().handle)
        if dst is not None and self.machine.rank != dst:
            return None
        pieces: Dict = {}
        for blocks in every:
            for tree, key, leaf, box, v in blocks:
                pieces.setdefault((tree, key, leaf), []).append((box, v))
        out = {"params": {}, "state": {}, "opt": {}}
        for (tree, key, leaf), parts in pieces.items():
            shape = tuple(max(box[d][1] for box, _ in parts)
                          for d in range(len(parts[0][0])))
            whole = torch.empty(shape, dtype=parts[0][1].dtype)
            for box, v in parts:
                whole[tuple(slice(lo, hi) for lo, hi in box)] = v
            out[tree].setdefault(key, {})[leaf] = whole
        return out["params"], out["state"], out["opt"]

    def _blocks_at(self, params, state, opt_state, position: int):
        """The blocks of whole (host) trees that the rank at ``position``
        holds: ``(params, state, opt_state)``."""
        return (self.shard_params(params, position),
                self.shard_state(state or {}, position),
                self._shard_opt(opt_state or {}, position))

    def place_state(self, params, state, opt_state=None,
                    blocks: bool = False):
        """Land whole host ``(params, state, opt_state)`` trees on this
        model as :meth:`init` lands fresh ones (``model.py:936`` in the
        JAX package): this rank's blocks under the strategy
        (:meth:`shard_params`, :meth:`shard_state`, :meth:`_shard_opt`),
        on the model's device.  ``blocks`` says the trees are this rank's
        blocks already (handed over by rank 0).  The landing half of an
        elastic migration (``utils/elastic.py``)."""
        if self.sharded and not blocks:
            pos = self.machine.position
            params, state, opt_state = self._blocks_at(params, state,
                                                       opt_state, pos)

        def to(tree):
            return {k: {leaf: v.to(self.device) for leaf, v in sub.items()}
                    for k, sub in (tree or {}).items()}

        return to(params), to(state), to(opt_state) or None

    def _rollback_restore(self, ckpt_dir, olog, log, from_step):
        """The guard's rollback: ``(step, params, state, opt_state)`` of
        the newest verified checkpoint (falling back past corrupt steps),
        or of a fresh ``init()`` at step 0 when there is none
        (``model.py:2439``), with a ``rollback`` record."""
        from flexflow_tpu_torch.utils import checkpoint as ckpt

        rstep, params, state, opt_state = 0, None, None, None
        if ckpt_dir:
            try:
                rstep, params, state, opt_state = self._restore(ckpt_dir,
                                                                olog)
            except (FileNotFoundError, ckpt.CheckpointError) as e:
                log(f"rollback: no usable checkpoint under {ckpt_dir!r} "
                    f"({e}); reinitializing from step 0")
        if params is None:
            rstep = 0
            params, state = self.init()
            opt_state = None
        opt_state = opt_state or self.init_opt_state(params)
        olog.event("rollback", from_step=from_step, to_step=rstep,
                   dir=ckpt_dir or None)
        log(f"health guard: rolled back from iteration {from_step} to "
            f"checkpoint step {rstep}")
        return rstep, params, state, opt_state

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)


def _leaves(tree):
    """The tensors of nested dicts, tuples and lists, in order."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, (list, tuple)):
        return [t for sub in tree for t in _leaves(sub)]
    return []


def _cast_floats(tree, dtype):
    """``tree`` with every float leaf cast to ``dtype``."""
    return {key: {k: v.to(dtype) if v.is_floating_point() else v
                  for k, v in sub.items()}
            for key, sub in tree.items()}
