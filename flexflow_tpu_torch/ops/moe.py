"""Token-routed top-k mixture-of-experts FFN (PyTorch port of
``flexflow_tpu/ops/moe.py``).

GShard/Switch semantics with index-based dispatch, as in the JAX op:

  * the router runs in float32; :func:`route_indices` turns its
    probabilities into static-shaped index maps — per expert slot the
    token that fills it (``src``), per token its k slots (``slots``) and
    gate weights — through a running count of earlier tokens per expert,
    so that capacity overflow drops tokens exactly as the dense one-hot
    form (:func:`route_dense`, the executable specification) does;
  * the token -> expert-slot shuffle and the way back are gathers.  Each
    one's backward is the other gather over the inverse map
    (:class:`SlotGather`), so the gradient of ``x`` and of the expert
    outputs is a fixed-order sum with no atomics: two runs give the same
    bits, where the backward of plain indexing is a scatter-add whose
    atomics on CUDA vary the last bits from run to run;
  * the expert FFNs are two batched products (``torch.bmm``, cuBLAS), as
    the JAX package leaves them to XLA; no Pallas kernel exists for them;
  * the Switch auxiliary load-balancing loss is the op's second output.

Over several ranks the grid is (e, c, n) (``moe.py:88-122``): tokens
arrive batch-split over ``n`` and whole over (e, c); ``w1`` and ``b1``
split by ``e`` and ``c``, ``w2`` by ``e`` and ``c`` (rows), ``b2`` by
``e``; the router ``wg`` is replicated.  Each rank routes its batch
rows (routing is per row, so the indices equal the one-device routing
of those rows), gathers the slots of its own experts, runs the two
products on its (E/pe, D, F/pc) and (E/pe, F/pc, D) blocks and
all-reduces the c-partial expert outputs over its c group before
``b2`` is added once.  The combine all-gathers the expert outputs over
the e group and mixes them as one device does, in the same k order
(GSPMD's all-gather of ``yo`` under ``P(e, n)``); the other route, each
rank mixing its own experts and an all-reduce of the partial y, moves
about a quarter of the bytes but sums in the backend's order.  Only
all-gathers and all-reduces run, which every backend carries for
every tensor, so no transport is chosen.  The aux loss takes global
means over (B, S): the rank's sums of the top-1 one-hots and of the
probabilities are summed over the n group (:func:`global_sum`, each
rank differentiating its own rows) before the product, and the model
counts the aux once per n block (``FFModel.aux_counted``).
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch
import torch.nn.functional as F

from flexflow_tpu_torch.ops.base import Op, Tensor, glorot_uniform
from flexflow_tpu_torch.strategy import ParallelConfig


def route_indices(probs: torch.Tensor, capacity: int, top_k: int,
                  means=None) -> Tuple[torch.Tensor, ...]:
    """Top-k routing of float32 ``probs`` (B, S, E) as index maps
    (``moe.py:_route_indices``).  Returns ``(src, src_k, slots, weights,
    aux)``:

      * ``src`` (B, E*C) int64, the token filling each expert slot (the
        sentinel S marks an empty slot);
      * ``src_k`` (B, E*C) int64, the same as the flat ``s*k + choice``
        index of the token's choice (sentinel S*k): the inverse of
        ``slots``;
      * ``slots`` (B, S, k) int64, the flat ``e*C + c`` slot of each
        choice (the sentinel E*C marks a dropped choice);
      * ``weights`` (B, S, k) float32, the gate weights (0 where dropped);
      * ``aux``, the Switch load-balancing loss.

    Choices of a higher rank are placed first; within a rank, tokens in
    sequence order; a choice that finds its expert full is dropped.
    ``means(top1_one_hot, probs)``, when given, returns the two per-expert
    means over the tokens of the whole batch that the aux loss takes
    (the default: the means over ``probs``' own tokens)."""
    b, s, e = probs.shape
    c, k = capacity, top_k
    # jax.lax.top_k puts the lower expert first on ties; torch.topk
    # promises no order, a stable descending sort does
    top_p, top_i = torch.sort(probs, dim=-1, descending=True, stable=True)
    top_p, top_i = top_p[..., :k], top_i[..., :k]
    if k > 1:
        top_p = top_p / torch.clamp(top_p.sum(-1, keepdim=True), min=1e-9)
    # (k == 1 keeps the raw gate probability, Switch semantics: a
    # renormalized weight would be the constant 1 and cut the router off
    # from the task loss)
    counts = torch.zeros((b, e), dtype=torch.int64, device=probs.device)
    slot_l, w_l = [], []
    for i in range(k):
        e_i = top_i[:, :, i]                                  # (B, S)
        oh = F.one_hot(e_i, e)                                # (B, S, E)
        # the slot: tokens before this one routed to the expert in this
        # pass, after the tokens earlier passes placed there (an integer
        # cumsum, equal to the JAX package's float32 one)
        pos = oh.cumsum(1) - oh + counts[:, None, :]
        counts = counts + (oh * (pos < c)).sum(1)
        p_i = pos.gather(-1, e_i[..., None])[..., 0]
        keep = p_i < c
        slot_l.append(torch.where(keep, e_i * c + p_i,
                                  torch.full_like(p_i, e * c)))
        w_l.append(torch.where(keep, top_p[:, :, i],
                               torch.zeros_like(top_p[:, :, i])))
    slots = torch.stack(slot_l, -1)                           # (B, S, k)
    weights = torch.stack(w_l, -1)
    # invert: every kept choice owns its slot, so each column below E*C
    # is written once.  Dropped choices all write the sentinel column
    # E*C, whose duplicate writes (which one lands is unspecified for a
    # CUDA index_put_) are harmless only because that column is sliced
    # off here
    src_k = torch.full((b, e * c + 1), s * k, dtype=torch.int64,
                       device=probs.device)
    bidx = torch.arange(b, device=probs.device)[:, None, None]
    flat = torch.arange(s * k, device=probs.device).view(1, s, k)
    src_k[bidx, slots] = flat.expand(b, s, k)
    src_k = src_k[:, :e * c]
    src = src_k // k                              # the sentinel S*k -> S
    # Switch aux loss: E * sum_e f_e * P_e, f from the top-1 choices
    top1 = F.one_hot(top_i[:, :, 0], e).float()
    f, p = (top1.mean((0, 1)), probs.mean((0, 1))) if means is None \
        else means(top1, probs)
    aux = e * torch.sum(f * p)
    return src, src_k, slots, weights, aux


def route_dense(probs: torch.Tensor, capacity: int, top_k: int):
    """``(dispatch, combine, aux)``, the dense GShard one-hot form (B, S,
    E, C) built from :func:`route_indices` (``moe.py:_route``): the
    executable specification the index routing is tested against."""
    b, s, e = probs.shape
    c = capacity
    _, _, slots, weights, aux = route_indices(probs, capacity, top_k)
    bidx = torch.arange(b, device=probs.device)[:, None, None] \
        .expand_as(slots)
    sidx = torch.arange(s, device=probs.device)[None, :, None] \
        .expand_as(slots)
    disp = torch.zeros((b, s, e * c + 1), dtype=torch.float32,
                       device=probs.device)
    comb = torch.zeros_like(disp)
    disp.index_put_((bidx, sidx, slots), torch.ones_like(weights),
                    accumulate=True)
    comb.index_put_((bidx, sidx, slots), weights, accumulate=True)
    return (disp[..., :e * c].reshape(b, s, e, c),
            comb[..., :e * c].reshape(b, s, e, c), aux)


def _gather_rows(x: torch.Tensor, index: torch.Tensor) -> torch.Tensor:
    """``out[b, m] = x[b, index[b, m]]``; the index ``x.shape[1]`` reads
    a row of zeros."""
    xpad = F.pad(x, (0, 0, 0, 1))
    bidx = torch.arange(x.shape[0], device=x.device)[:, None]
    return xpad[bidx, index]


class SlotGather(torch.autograd.Function):
    """``out[b, m] = x[b, index[b, m]]`` (the sentinel ``x.shape[1]``
    reads zeros) with the backward ``dx[b, n] = sum_g dout[b, inverse[b,
    n, g]]`` (the sentinel ``index.shape[1]`` reads zeros): the gather
    over the inverse map, summed over g in order.  Dispatch gathers
    tokens into slots (index ``src``, inverse ``slots``: a token's k
    choices); combine gathers slots back to choices (index ``slots``,
    inverse ``src_k``, one choice a slot).  No atomics either way."""

    @staticmethod
    def forward(ctx, x, index, inverse):
        ctx.save_for_backward(inverse)
        return _gather_rows(x, index)

    @staticmethod
    def backward(ctx, dout):
        (inverse,) = ctx.saved_tensors
        b, n, g = inverse.shape
        dx = _gather_rows(dout, inverse.reshape(b, n * g))
        return dx.view(b, n, g, -1).sum(2), None, None


class MixtureOfExperts(Op):
    """Token-routed top-k MoE FFN on (batch, seq, d_model) tensors.

    Outputs: ``[y (B, S, D), aux ()]``."""

    AXIS_NAMES = ("e", "c", "n")

    def __init__(self, name: str, pc: ParallelConfig, input: Tensor,
                 num_experts: int, d_ff: int, top_k: int = 2,
                 capacity_factor: float = 2.0):
        super().__init__(name, pc, [input])
        if input.ndim != 3:
            raise ValueError("moe input must be (batch, seq, d)")
        if not 1 <= top_k <= num_experts:
            raise ValueError(f"top_k {top_k} must be in 1..{num_experts}")
        b, s, d = input.shape
        self.num_experts = num_experts
        self.d_ff = d_ff
        self.top_k = top_k
        self.capacity_factor = capacity_factor
        # static slots per expert (GShard capacity), rounded up so the
        # expected balanced load always fits
        self.capacity = max(1, int(math.ceil(
            capacity_factor * top_k * s / num_experts)))
        self.d_model = d
        self.output = Tensor(input.shape, input.dtype, self, name)
        self.aux = Tensor((), "float32", self, f"{name}_aux")
        self.outputs = [self.output, self.aux]

    def init_params(self, gen, device) -> Dict:
        e, d, f = self.num_experts, self.d_model, self.d_ff
        # glorot_uniform(in_axis=-2, out_axis=-1) on (E, D, F) counts the
        # expert axis into both fans
        return {
            "wg": torch.randn((d, e), generator=gen, device=device) * 0.02,
            "w1": glorot_uniform((e, d, f), gen, device, fans=(d * e, f * e)),
            "b1": torch.zeros((e, f), device=device),
            "w2": glorot_uniform((e, f, d), gen, device, fans=(f * e, d * e)),
            "b2": torch.zeros((e, d), device=device),
        }

    # ---- grids over several ranks (moe.py:88-122) ---------------------

    def param_specs(self):
        return {"w1": ("e", None, "c"), "b1": ("e", "c"),
                "w2": ("e", "c", None), "b2": ("e", None)}

    def regrid_input_specs(self):
        return [("n", None, None)]

    def output_specs(self) -> List:
        return [("n", None, None), None]

    def output_spec(self):
        return self.output_specs()[0]

    def validate_partitioning(self) -> None:
        super().validate_partitioning()
        pe, pc_, _ = self.pc.dims
        if self.num_experts % pe:
            raise ValueError(
                f"op {self.name!r}: {self.num_experts} experts not "
                f"divisible by expert-grid {pe}")
        if self.d_ff % pc_:
            raise ValueError(
                f"op {self.name!r}: d_ff={self.d_ff} not divisible by "
                f"channel-grid {pc_}")

    def grid_collectives(self):
        return [(a,) for a, parts in zip(self.AXIS_NAMES, self.pc.dims)
                if parts > 1]

    # ---- compute ------------------------------------------------------

    def route(self, params, x, means=None):
        """:func:`route_indices` of the router's float32 softmax on x."""
        logits = torch.matmul(x.float(), params["wg"].float())
        return route_indices(torch.softmax(logits, dim=-1), self.capacity,
                             self.top_k, means)

    def _batch_means(self, grid):
        """The aux loss's means over the whole batch from this rank's n
        block: the per-expert sums, summed over the n group (each rank
        differentiates its own rows' sums), over B * S tokens."""
        from flexflow_tpu_torch.parallel.collectives import global_sum

        b, s, _ = self.inputs[0].shape

        def means(top1, probs):
            sums = torch.stack([top1.sum((0, 1)), probs.sum((0, 1))])
            sums = global_sum(sums, grid.group(("n",))) / (b * s)
            return sums[0], sums[1]

        return means

    def forward(self, params, state, xs: List, train: bool):
        return self._forward(params, xs[0], None), state

    def sharded_forward(self, params, state, xs: List, train: bool, grid):
        return self._forward(params, xs[0], grid), state

    def _forward(self, params, x, grid):
        """``(y, aux)`` of this rank's rows x (B', S, D) on its expert and
        channel blocks of the params (all of them where ``grid`` is
        None)."""
        b, s, d = x.shape
        e, c, k = self.num_experts, self.capacity, self.top_k
        split = grid is not None and grid.parts("n") > 1
        src, src_k, slots, weights, aux = self.route(
            params, x, self._batch_means(grid) if split else None)
        e_lo, e_hi = (0, e) if grid is None else grid.block("e", e)
        el = e_hi - e_lo
        if el < e:
            # this rank's experts: their slot columns, and each choice's
            # slot among them (the sentinel el*C where it lies elsewhere)
            src = src[:, e_lo * c:e_hi * c]
            local = slots - e_lo * c
            inverse = torch.where((local >= 0) & (local < el * c), local,
                                  torch.full_like(local, el * c))
        else:
            inverse = slots
        # token -> expert slot: raw activations; the gate weight
        # multiplies at combine only (GShard)
        xin = SlotGather.apply(x, src, inverse)               # (B, el*C, D)
        xin = xin.view(b, el, c, d).transpose(0, 1).reshape(el, b * c, d)
        # the products accumulate in float32 on x's dtype's operands, and
        # the result rounds to that dtype after the bias and GELU (JAX:
        # preferred_element_type=float32); jax.nn.gelu is the tanh form
        h = torch.bmm(xin.float(), params["w1"].to(x.dtype).float())
        h = F.gelu(h + params["b1"].float()[:, None, :],
                   approximate="tanh").to(x.dtype)
        yo = torch.bmm(h.float(), params["w2"].to(x.dtype).float())
        if grid is not None:
            # each channel block's product is a partial sum over F
            yo = grid.all_reduce(yo, ("c",))
        yo = (yo + params["b2"].float()[:, None, :]).to(x.dtype)
        yo = yo.view(el, b, c, d).transpose(0, 1).reshape(b, el * c, d)
        if el < e:
            # every expert's outputs on every rank of the e group
            yo = grid.gather(yo, "e", 1, e * c)
        # expert slot -> token: each token's k slot outputs, mixed by the
        # gate weights in float32
        yg = SlotGather.apply(yo, slots.view(b, s * k), src_k[..., None])
        yg = yg.view(b, s, k, d)
        y = (weights[..., None] * yg.float()).sum(2)
        return y.to(x.dtype), aux

    def dropped_share(self, params, x) -> float:
        """The share of (token, choice) pairs dropped at capacity on x."""
        slots = self.route(params, x)[2]
        e, c = self.num_experts, self.capacity
        return float((slots == e * c).float().mean())

    # ---- cost model (moe.py:240-277) ----------------------------------

    def local_clone(self, pc: ParallelConfig):
        pe, pc_, pn = pc.dims
        b, s, d = self.inputs[0].shape
        if pe > 1 or pc_ > 1 or b % pn:
            return None   # flops / parts is exact over e and c
        t = Tensor((b // pn, s, d))
        return MixtureOfExperts(self.name, ParallelConfig((1, 1, 1), (0,)),
                                t, self.num_experts, self.d_ff, self.top_k,
                                self.capacity_factor)

    def flops_per_sample(self) -> float:
        s, d, f = self.output.shape[1], self.d_model, self.d_ff
        e, c = self.num_experts, self.capacity
        # router, combine mix and the expert FFNs over E*C slots (the
        # dispatch and combine gathers move bytes, not FLOPs)
        return (2.0 * s * d * e + 2.0 * s * self.top_k * d
                + 4.0 * e * c * d * f)

    def shard_flops_fwd(self, pc: ParallelConfig):
        # the router and the combine are replicated over (e, c), the
        # expert FFNs split over all of (e, c, n)
        pe, pcc, pn = pc.dims
        b, s, d = self.inputs[0].shape
        f, e, c = self.d_ff, self.num_experts, self.capacity
        local_b = b / pn
        router = (2.0 * s * d * e + 2.0 * s * self.top_k * d) * local_b
        ffn = 4.0 * e * c * d * f * local_b / (pe * pcc)
        return router + ffn

    def cost_signature(self) -> tuple:
        # the experts' work is invisible in the (B, S, D) shapes
        return (self.num_experts, self.d_ff, self.top_k, self.capacity)

    def param_bytes(self) -> int:
        e, d, f = self.num_experts, self.d_model, self.d_ff
        return 4 * (d * e + 2 * e * d * f + e * f + e * d)
