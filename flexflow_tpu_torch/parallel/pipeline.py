"""GPipe pipeline parallelism (PyTorch port of
``flexflow_tpu/parallel/pipeline.py``).

Stages live on the ranks of a stage group, each rank holding its own
stage's slice of the stage-stacked parameters.  Microbatches stream
through the ring: every tick each stage applies its block stack to its
current activation (stage 0 to microbatch t, the others to what they
received), then every stage's output rotates one stage on
(``collectives.rotate``: point-to-point where the backend carries it,
an all-gather on gloo with CUDA tensors).  M microbatches over S stages
take M + S - 1 ticks; the fill and drain ticks compute on zeros or on a
wrapped-around activation, as JAX's do, and their outputs reach neither
the loss nor any gradient (their cotangents are exact zeros).  A masked
all-reduce over the stage group then hands the last stage's outputs to
every stage.  The backward is autograd through the ticks: each
rotation's backward is the reverse rotation, and every collective rides
the step's token chain, so the backward collectives run in the reverse
of the forward's order on every rank.  As in JAX's scan, every tick
rotates, the last too, whose result no stage reads: every tick's
backward then runs on every stage (on exact-zero cotangents where the
tick is a bubble), so each stage launches its blocks' forward and
backward M + S - 1 times a step.

:class:`PipelinedLM` is the model ``apps.lm --pipeline-stages`` trains
(``pipeline.py:281-431``): embed -> L pre-norm blocks over S stages ->
final norm -> vocab head and the shifted, masked cross-entropy in
float32, on a ``(stage, n, tp)`` mesh with tp fastest
(``MachineModel.pipeline_mesh``).  n splits each microbatch's rows
(data parallel; the gradients of leaves held by
several ranks are all-reduced over their holders); tp splits each
stage's blocks Megatron-style (``wqkv``, ``bqkv``, ``w1``, ``b1`` by
columns, ``wo``, ``w2`` by rows), the two row-split products summed by
an autograd all-reduce over the tp group.  A value held by several
ranks carries a partial gradient on each (``parallel/collectives.py``),
so the replicated input of a tp block needs no collective of its own:
its partial cotangents are summed where they meet, in the all-reduce's
backward and in the leaves' gradient all-reduce.  Inside a stage the
attention is ``ops/kernels/flash_attention.py``'s (kernels 1-3 on CUDA
tensors, their plain versions on the CPU), where JAX's block takes the
softmax by einsum: the same function.  The embedding and the head are
held whole on every rank, as JAX replicates them; the head runs on one
rank per n block (the last stage, tp 0), whose loss counts, where JAX
computes it on every rank from the broadcast outputs.
"""

from __future__ import annotations

import contextlib
from typing import Callable, Dict, Optional

import torch
import torch.nn.functional as F

from flexflow_tpu_torch.machine import Group, MachineModel
from flexflow_tpu_torch.ops.kernels.flash_attention import flash_attention
from flexflow_tpu_torch.parallel import collectives


def microbatch(x: torch.Tensor, num_microbatches: int) -> torch.Tensor:
    """(B, ...) -> (M, B // M, ...), the leading microbatch axis."""
    b = x.shape[0]
    if b % num_microbatches:
        raise ValueError(
            f"batch {b} not divisible by num_microbatches {num_microbatches}")
    return x.reshape((num_microbatches, b // num_microbatches)
                     + tuple(x.shape[1:]))


def spmd_pipeline(stage_fn: Callable, stage_params, xs: torch.Tensor,
                  group: Group, stage: int, transport: str) -> torch.Tensor:
    """Run the microbatches ``xs`` (M, mb, ...) through the S stages of
    ``group`` (this rank the ``stage``-th member), GPipe order.

    ``stage_fn(stage_params, x) -> y`` keeps x's shape; ``stage_params``
    is this stage's slice; ``xs`` is read on stage 0 alone.  Returns the
    last stage's (M, mb, ...) outputs on every stage.  ``transport`` is
    the rotation's (``collectives.rotate``)."""
    num_stages, num_mb = group.size, xs.shape[0]
    ticks = num_mb + num_stages - 1
    recv = torch.zeros_like(xs[0])
    outs = []
    for t in range(ticks):
        inp = xs[min(t, num_mb - 1)] if stage == 0 else recv
        y = stage_fn(stage_params, inp)
        # the last stage emits microbatch m at tick m + S - 1
        if t >= num_stages - 1:
            outs.append(y)
        recv = collectives.rotate(y, group, transport, shift=1)
    out = torch.stack(outs)
    if stage != num_stages - 1:
        out = torch.zeros_like(out)
    # the masked all-reduce: the last stage's outputs on every stage
    return collectives.all_reduce_sum(out, group)


def sequential_reference(stage_fn: Callable, stage_params: Dict,
                         xs: torch.Tensor) -> torch.Tensor:
    """The same stages applied in order to each microbatch, no ring: the
    ground truth of :func:`spmd_pipeline` (``stage_params`` stacked
    (S, ...) per leaf)."""
    num_stages = next(iter(stage_params.values())).shape[0]
    outs = []
    for x in xs:
        for s in range(num_stages):
            x = stage_fn({k: v[s] for k, v in stage_params.items()}, x)
        outs.append(x)
    return torch.stack(outs)


# ----------------------------------------------------------------------
# pipelined transformer blocks


def _layer_norm(g, b, x, eps: float = 1e-5):
    mu = x.mean(-1, keepdim=True)
    var = ((x - mu) ** 2).mean(-1, keepdim=True)
    return (x - mu) * torch.rsqrt(var + eps) * g + b


def transformer_block_fn(num_heads: int, causal: bool = False,
                         tp_group: Optional[Group] = None) -> Callable:
    """A pre-norm transformer block as a stage function
    (``pipeline.py:152``).  Params: ``ln1`` (2, D), ``wqkv`` (D, 3, D),
    ``bqkv`` (3, D), ``wo`` (D, D), ``bo`` (D,), ``ln2`` (2, D), ``w1``
    (D, F), ``b1`` (F,), ``w2`` (F, D), ``b2`` (D,).  With ``tp_group``
    the params are this rank's Megatron blocks (the local head count
    follows from their shapes) and the two row-split products are
    summed over the group; without it the same code runs the whole
    block."""

    def block(p, x):
        b, s, d = x.shape
        head_dim = d // num_heads
        h = _layer_norm(p["ln1"][0], p["ln1"][1], x)
        # (B, S, 3, E), E = D / tp: q, k, v each a contiguous head subset
        qkv = torch.einsum("bsd,dte->bste", h, p["wqkv"]) + p["bqkv"]

        def heads(t):      # (B, S, E) -> (B, H_local, S, d_h)
            return t.reshape(b, s, -1, head_dim).transpose(1, 2) \
                .contiguous()

        o = flash_attention(heads(qkv[:, :, 0]), heads(qkv[:, :, 1]),
                            heads(qkv[:, :, 2]), causal).to(x.dtype)
        attn = o.transpose(1, 2).reshape(b, s, -1) @ p["wo"]
        if tp_group is not None:
            attn = collectives.all_reduce_sum(attn, tp_group)
        x = x + attn + p["bo"]
        h = _layer_norm(p["ln2"][0], p["ln2"][1], x)
        h = F.gelu(h @ p["w1"] + p["b1"], approximate="tanh")
        ffn = h @ p["w2"]
        if tp_group is not None:
            ffn = collectives.all_reduce_sum(ffn, tp_group)
        return x + ffn + p["b2"]

    return block


#: the stacked (S, L/S, ...) dim of each block leaf split over tp (the
#: rest are replicated over tp): ``stage_param_specs`` (``pipeline.py:242``)
TP_DIM = {"wqkv": 4, "bqkv": 3, "wo": 2, "w1": 3, "b1": 2, "w2": 2}


def _block_shapes(d: int, f: int) -> Dict[str, tuple]:
    return {"ln1": (2, d), "wqkv": (d, 3, d), "bqkv": (3, d), "wo": (d, d),
            "bo": (d,), "ln2": (2, d), "w1": (d, f), "b1": (f,),
            "w2": (f, d), "b2": (d,)}


class PipelinedLM:
    """Embed -> L transformer blocks over S pipeline stages -> final norm
    -> vocab head + cross-entropy, on a ``(stage, n, tp)`` mesh of the
    machine's ranks (``pipeline.py:281``).

    Not an ``FFModel``: its params are ``{"blocks": {leaf: (S, L/S,
    ...)}, "embed", "pos", "ln_f", "head_w", "head_b"}``, JAX's tree, of
    which each rank holds ``blocks[s]`` (leading dim 1) at its tp
    columns and the other leaves whole.  :meth:`loss_fn` and
    :meth:`make_train_step` take the global token batch on every rank;
    :meth:`loss_reference` and :meth:`make_reference_step` run the same
    model sequentially on the whole tree in one process."""

    def __init__(self, machine: MachineModel, num_stages: int,
                 num_microbatches: int, num_layers: int = 12,
                 d_model: int = 768, num_heads: int = 12, d_ff: int = 3072,
                 vocab_size: int = 32768, seq_length: int = 512,
                 batch_size: int = 16, causal: bool = True,
                 learning_rate: float = 1e-3, compute_dtype="float32",
                 tp: int = 1):
        if num_layers % num_stages:
            raise ValueError(f"{num_layers} layers not divisible into "
                             f"{num_stages} stages")
        if machine.num_devices % (num_stages * tp):
            raise ValueError(f"{machine.num_devices} devices not divisible "
                             f"into {num_stages} stages x {tp} tp")
        if num_heads % tp or d_ff % tp:
            raise ValueError(f"tp={tp} must divide num_heads ({num_heads}) "
                             f"and d_ff ({d_ff})")
        if batch_size % num_microbatches:
            raise ValueError("batch not divisible by microbatches")
        dp = machine.num_devices // (num_stages * tp)
        if (batch_size // num_microbatches) % dp:
            raise ValueError(
                f"microbatch size {batch_size // num_microbatches} not "
                f"divisible by the data-parallel axis ({dp} devices)")
        self.machine = machine
        self.S, self.M, self.tp, self.dp = num_stages, num_microbatches, tp, dp
        self.L, self.D, self.H = num_layers, d_model, num_heads
        self.F, self.V = d_ff, vocab_size
        self.seq, self.batch = seq_length, batch_size
        self.causal = causal
        self.lr = learning_rate
        self.dtype = {"float32": torch.float32,
                      "bfloat16": torch.bfloat16}[str(compute_dtype)]
        self._mesh = None

    @property
    def device(self) -> torch.device:
        return self.machine.device

    def mesh(self):
        """This rank's ``MachineModel.pipeline_mesh`` (made on first use,
        on every rank)."""
        if self._mesh is None:
            self._mesh = self.machine.pipeline_mesh(self.S, self.dp, self.tp)
        return self._mesh

    def coords(self, position: Optional[int] = None):
        """``(stage, n, t)`` of ``position`` (default this rank's)."""
        p = self.machine.position if position is None else position
        return p // (self.dp * self.tp), p // self.tp % self.dp, p % self.tp

    # -- params ---------------------------------------------------------

    def param_shapes(self) -> Dict:
        """The full tree's ``{"blocks": {leaf: shape}, leaf: shape}``."""
        lead = (self.S, self.L // self.S)
        out = {"blocks": {k: lead + v for k, v
                          in _block_shapes(self.D, self.F).items()}}
        out.update(embed=(self.V, self.D), pos=(self.seq, self.D),
                   ln_f=(2, self.D), head_w=(self.D, self.V),
                   head_b=(self.V,))
        return out

    def init_full(self, seed: int = 0) -> Dict:
        """The whole tree drawn from one ``torch.Generator`` seeded with
        ``seed`` (every rank draws the same): normal weights scaled by
        1/sqrt(fan-in), zero biases, norms (1, 0), the embeddings normal
        over sqrt(D), a zero head (``pipeline.py:209``, ``:338``)."""
        gen = torch.Generator(device=self.device)
        gen.manual_seed(int(seed))
        dev = self.device
        blocks = {}
        for name, shape in self.param_shapes()["blocks"].items():
            if name.startswith("ln"):
                v = torch.zeros(shape, device=dev)
                v[:, :, 0] = 1.0
            elif name.startswith("b"):
                v = torch.zeros(shape, device=dev)
            else:
                v = torch.randn(shape, generator=gen, device=dev) \
                    / float(shape[2]) ** 0.5
            blocks[name] = v
        scale = 1.0 / float(self.D) ** 0.5
        return {
            "blocks": blocks,
            "embed": torch.randn((self.V, self.D), generator=gen,
                                 device=dev) * scale,
            "pos": torch.randn((self.seq, self.D), generator=gen,
                               device=dev) * scale,
            "ln_f": torch.stack([torch.ones(self.D, device=dev),
                                 torch.zeros(self.D, device=dev)]),
            "head_w": torch.zeros((self.D, self.V), device=dev),
            "head_b": torch.zeros((self.V,), device=dev),
        }

    def param_boxes(self, position: Optional[int] = None) -> Dict:
        """Where the rank at ``position`` (default this one) holds each
        leaf in the full tree: ``((lo, hi), ...)`` per dim."""
        s, _, t = self.coords(position)
        boxes = {"blocks": {}}
        for name, shape in self.param_shapes()["blocks"].items():
            box = [(0, n) for n in shape]
            box[0] = (s, s + 1)
            dim = TP_DIM.get(name)
            if dim is not None:
                w = shape[dim] // self.tp
                box[dim] = (t * w, (t + 1) * w)
            boxes["blocks"][name] = tuple(box)
        for name, shape in self.param_shapes().items():
            if name != "blocks":
                boxes[name] = tuple((0, n) for n in shape)
        return boxes

    def shard_params(self, full: Dict, position: Optional[int] = None
                     ) -> Dict:
        """The blocks of the full tree the rank at ``position`` holds."""
        boxes = self.param_boxes(position)

        def cut(v, box):
            return v[tuple(slice(lo, hi) for lo, hi in box)].contiguous()

        out = {"blocks": {k: cut(v, boxes["blocks"][k])
                          for k, v in full["blocks"].items()}}
        out.update({k: v for k, v in full.items() if k != "blocks"})
        return out

    def init(self, seed: int = 0) -> Dict:
        """This rank's blocks of :meth:`init_full`."""
        return self.shard_params(self.init_full(seed))

    # -- forward/loss ---------------------------------------------------

    def _stage_fn(self, block: Callable) -> Callable:
        n_sub, dtype = self.L // self.S, self.dtype

        def stage(p, x):
            p = {k: v.to(dtype) for k, v in p.items()}
            for i in range(n_sub):      # the stage's sub-layers in order
                x = block({k: v[i] for k, v in p.items()}, x)
            return x

        return stage

    def _embed(self, params, tokens):
        return params["embed"][tokens.long()].to(self.dtype) \
            + params["pos"].to(self.dtype)[None]

    def _targets(self, labels):
        """The labels as targets: a causal model's shifted left, -1 (no
        target) at the last position."""
        if not self.causal:
            return labels
        return torch.cat([labels[:, 1:], torch.full(
            (labels.shape[0], 1), -1, dtype=labels.dtype,
            device=labels.device)], dim=1)

    def _nll_sum(self, params, ys, targets):
        """Final norm + vocab head + the masked NLL, summed, in float32
        over (M, mb, seq, D) outputs and their (M * mb, seq) targets."""
        y = ys.reshape(-1, self.seq, self.D)
        y = _layer_norm(params["ln_f"][0], params["ln_f"][1], y.float())
        logits = y @ params["head_w"] + params["head_b"]
        valid = targets >= 0
        lp = torch.log_softmax(logits, dim=-1)
        nll = -lp.gather(-1, torch.where(valid, targets, 0).long()
                         [..., None])[..., 0]
        return torch.where(valid, nll, torch.zeros_like(nll)).sum()

    def _tokens(self, tokens, labels):
        return (torch.as_tensor(tokens, device=self.device),
                self._targets(torch.as_tensor(labels, device=self.device)))

    def loss_fn(self, params, tokens, labels):
        """The mean NLL of the global batch through the GPipe ring, on
        every rank (``pipeline.py:405``): ``params`` this rank's blocks,
        ``tokens`` and ``labels`` the global (B, seq) batch."""
        mesh = self.mesh()
        s, n, t = mesh.coords
        tokens, targets = self._tokens(tokens, labels)
        mbl = self.batch // self.M // self.dp
        rows = slice(n * mbl, (n + 1) * mbl)
        xs = self._embed(params, microbatch(tokens, self.M)[:, rows])
        block = transformer_block_fn(
            self.H, self.causal, mesh.tp_group if self.tp > 1 else None)
        transport = "p2p" if self.machine.send_recv else "gather"
        ys = spmd_pipeline(self._stage_fn(block),
                           {k: v[0] for k, v in params["blocks"].items()},
                           xs, mesh.stage, s, transport)
        # each n block's loss counts on one rank: the last stage, tp 0
        if s == self.S - 1 and t == 0:
            part = self._nll_sum(params, ys, microbatch(
                targets, self.M)[:, rows].reshape(-1, self.seq))
        else:
            part = torch.zeros((), device=self.device)
        total = collectives.global_sum(part, mesh.world)
        if targets.is_meta:
            # a dry trace (the collective audit): the value is a shape
            return total / targets.numel()
        return total / max(int((targets >= 0).sum()), 1)

    def loss_reference(self, full_params, tokens, labels):
        """The same model without the ring, on the whole tree in this
        process, no collectives (``pipeline.py:412``)."""
        tokens, targets = self._tokens(tokens, labels)
        xs = microbatch(self._embed(full_params, tokens), self.M)
        ys = sequential_reference(
            self._stage_fn(transformer_block_fn(self.H, self.causal)),
            full_params["blocks"], xs)
        return self._nll_sum(full_params, ys, targets) \
            / max(int((targets >= 0).sum()), 1)

    # -- training -------------------------------------------------------

    def _grad_kind(self, key) -> str:
        """Which holders sum a leaf's gradient: ``data`` for a tp-split
        block leaf (its stage's ranks of one tp index), ``block`` for a
        replicated one (its stage's ranks), ``world`` for the rest."""
        group, leaf = key
        if group != "blocks":
            return "world"
        return "data" if leaf in TP_DIM else "block"

    def _sync_grads(self, keys, grads):
        """Sum each gradient over the ranks holding its leaf's block: one
        all-reduce per kind of holder set, in one order on every rank."""
        mesh = self.mesh()
        groups = {"data": mesh.data, "block": mesh.block,
                  "world": mesh.world}
        out = list(grads)
        for kind in ("data", "block", "world"):
            idx = [i for i, k in enumerate(keys)
                   if self._grad_kind(k) == kind]
            if not idx:
                continue
            summed = collectives.all_reduce_flat([grads[i] for i in idx],
                                                 groups[kind])
            for i, g in zip(idx, summed):
                out[i] = g
        return out

    def loss_and_grads(self, loss_of, params, tokens, labels, sync):
        """``(loss, keys, grads)``: ``loss_of(params, tokens, labels)`` and
        its gradient in each leaf, keyed ``("blocks", leaf)`` or ``(leaf,
        None)``; with ``sync`` through the step's token chain and summed
        over each leaf's holders (:meth:`_sync_grads`)."""
        keys = [("blocks", k) for k in params["blocks"]] \
            + [(k, None) for k in params if k != "blocks"]
        leaves = [(params[a] if b is None else params[a][b])
                  .detach().requires_grad_(True) for a, b in keys]
        tree = {"blocks": {}}
        for (a, b), v in zip(keys, leaves):
            if b is None:
                tree[a] = v
            else:
                tree["blocks"][b] = v
        with torch.enable_grad(), contextlib.ExitStack() as stack:
            chain = stack.enter_context(collectives.token_chain(
                self.device)) if sync else None
            loss = loss_of(tree, tokens, labels)
            if chain is None:
                grads = torch.autograd.grad(loss, leaves, allow_unused=True)
            else:
                # the chain's last token (zero) joins the loss and its
                # first is asked for: every rank runs each backward
                # collective, in the reverse of its forward order
                grads = torch.autograd.grad(loss + chain.token,
                                            leaves + [chain.first],
                                            allow_unused=True)[:-1]
        grads = [torch.zeros_like(v) if g is None else g
                 for v, g in zip(leaves, grads)]
        if sync:
            grads = self._sync_grads(keys, grads)
        return loss.detach(), keys, grads

    def _sgd(self, loss_of, params, tokens, labels, sync):
        """``(new params, loss)``: one plain-SGD step ``p - lr * g`` on
        :meth:`loss_and_grads`."""
        loss, keys, grads = self.loss_and_grads(loss_of, params, tokens,
                                                labels, sync)
        new = {"blocks": {}}
        with torch.no_grad():
            for (a, b), g in zip(keys, grads):
                if b is None:
                    new[a] = params[a].detach() - self.lr * g
                else:
                    new["blocks"][b] = params[a][b].detach() - self.lr * g
        return new, loss

    def make_train_step(self):
        """``step(params, tokens, labels) -> (params, loss)``: plain SGD
        through the ring (``pipeline.py:424``), new trees returned."""
        def step(params, tokens, labels):
            return self._sgd(self.loss_fn, params, tokens, labels, True)

        return step

    def make_reference_step(self):
        """The same SGD step on :meth:`loss_reference` and the whole tree,
        in one process."""
        def step(full_params, tokens, labels):
            return self._sgd(self.loss_reference, full_params, tokens,
                             labels, False)

        return step
