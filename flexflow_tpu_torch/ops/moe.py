"""Token-routed top-k mixture-of-experts FFN (PyTorch port of
``flexflow_tpu/ops/moe.py``), on one device.

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

The expert all-to-all over several devices comes with the multi-GPU
slice.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch
import torch.nn.functional as F

from flexflow_tpu_torch.ops.base import Op, Tensor, glorot_uniform
from flexflow_tpu_torch.strategy import ParallelConfig


def route_indices(probs: torch.Tensor, capacity: int, top_k: int
                  ) -> Tuple[torch.Tensor, ...]:
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
    sequence order; a choice that finds its expert full is dropped."""
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
    f = F.one_hot(top_i[:, :, 0], e).float().mean((0, 1))
    aux = e * torch.sum(f * probs.mean((0, 1)))
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

    def route(self, params, x):
        """:func:`route_indices` of the router's float32 softmax on x."""
        logits = torch.matmul(x.float(), params["wg"].float())
        return route_indices(torch.softmax(logits, dim=-1), self.capacity,
                             self.top_k)

    def forward(self, params, state, xs: List, train: bool):
        (x,) = xs
        b, s, d = x.shape
        e, c = self.num_experts, self.capacity
        src, src_k, slots, weights, aux = self.route(params, x)
        # token -> expert slot: raw activations; the gate weight
        # multiplies at combine only (GShard)
        xin = SlotGather.apply(x, src, slots)                 # (B, E*C, D)
        xin = xin.view(b, e, c, d).transpose(0, 1).reshape(e, b * c, d)
        # the products accumulate in float32 on x's dtype's operands, and
        # the result rounds to that dtype after the bias and GELU (JAX:
        # preferred_element_type=float32); jax.nn.gelu is the tanh form
        h = torch.bmm(xin.float(), params["w1"].to(x.dtype).float())
        h = F.gelu(h + params["b1"].float()[:, None, :],
                   approximate="tanh").to(x.dtype)
        yo = torch.bmm(h.float(), params["w2"].to(x.dtype).float())
        yo = (yo + params["b2"].float()[:, None, :]).to(x.dtype)
        # expert slot -> token: each token's k slot outputs, mixed by the
        # gate weights in float32
        yo = yo.view(e, b, c, d).transpose(0, 1).reshape(b, e * c, d)
        yg = SlotGather.apply(yo, slots.view(b, s * self.top_k),
                              src_k[..., None])
        yg = yg.view(b, s, self.top_k, d)
        y = (weights[..., None] * yg.float()).sum(2)
        return (y.to(x.dtype), aux), state

    def dropped_share(self, params, x) -> float:
        """The share of (token, choice) pairs dropped at capacity on x."""
        slots = self.route(params, x)[2]
        e, c = self.num_experts, self.capacity
        return float((slots == e * c).float().mean())
