"""Chunked LSTM: one op is one layer over ``lstm_per_node_length`` steps
of the sequence (PyTorch port of ``flexflow_tpu/ops/lstm.py``).

Inputs (x, hx, cx), outputs (y, hy, cy), as the reference's chunk op;
the hidden state flows to the next chunk's op as a plain tensor, and the
chunk ops of one layer share their weights through ``param_key``.  The
input projection is one product over the whole chunk, ``xg = x @ w_ih``
(float32 accumulation, then x's dtype); the recurrence then runs step by
step, ``gates = xg_t + h @ w_hh + b`` in gate order i, f, g, o, under
:class:`LSTMCore`, an autograd function with the JAX package's
hand-written backward (``lstm.py:59-110``): the reverse loop forms each
step's pre-activation gate gradient and ``dh_prev = dpre @ w_hh^T``, and
``dW_hh`` is one float32 product over all steps afterwards, not a
per-step accumulation.  The products are ``torch.matmul`` (cuBLAS), as
the JAX package leaves them to XLA.

Over several ranks the grid is (n,): each rank runs the recurrence on
its batch block with the layer's whole weights, and the chunk's ``hy``
and ``cy`` reach the next chunk's ranks along their own edges, moved
like any other value when the next chunk lives elsewhere
(``parallel/regrid.py``).  ``LSTMCore``'s backward is unchanged.
"""

from __future__ import annotations

from typing import Dict, List

import torch

from flexflow_tpu_torch.ops.base import Op, Tensor, glorot_uniform
from flexflow_tpu_torch.strategy import ParallelConfig


def lstm_recurrence(xg, w_hh, b, hx, cx, saved: bool = True):
    """The chunk recurrence as plain PyTorch ops, in xg's dtype with
    float32 products, each rounded where the JAX scan rounds it
    (``lstm.py:41-56``): ``(ys (B, L, H), hy, cy, cs (L, B, H), ifgo (L,
    B, 4H))``, the last two the cell states and activated gates the
    backward reads (None without ``saved``: the inference forward keeps
    neither).  Differentiable by autograd, which makes it the reference
    that :class:`LSTMCore`'s backward is held against."""
    dt = xg.dtype
    h_size = hx.shape[1]
    w = w_hh.float()
    h, c = hx, cx
    ys, cs, acts = [], [], []
    for t in range(xg.shape[1]):
        gates = xg[:, t] + torch.matmul(h.float(), w).to(dt) + b
        i, f, g, o = gates.split(h_size, dim=-1)
        i, f, g, o = (torch.sigmoid(i), torch.sigmoid(f), torch.tanh(g),
                      torch.sigmoid(o))
        c = f * c + i * g
        h = o * torch.tanh(c)
        ys.append(h)
        if saved:
            cs.append(c)
            acts.append(torch.cat([i, f, g, o], dim=-1))
    if not saved:
        return torch.stack(ys, 1), h, c, None, None
    return (torch.stack(ys, 1), h, c, torch.stack(cs, 0),
            torch.stack(acts, 0))


class LSTMCore(torch.autograd.Function):
    """``(ys, hy, cy)`` of :func:`lstm_recurrence` on (xg, w_hh, b, hx,
    cx), with the deferred-dW backward of ``lstm.py:69-106``.  A
    cotangent that no op sends (the last chunk's hy and cy, an unread y)
    counts as zeros."""

    @staticmethod
    def forward(ctx, xg, w_hh, b, hx, cx):
        ys, hy, cy, cs, ifgo = lstm_recurrence(xg, w_hh, b, hx, cx)
        ctx.save_for_backward(w_hh, hx, cx, ys, cs, ifgo)
        ctx.set_materialize_grads(False)
        return ys, hy, cy

    @staticmethod
    def backward(ctx, d_ys, d_hy, d_cy):
        w_hh, hx, cx, ys, cs, ifgo = ctx.saved_tensors
        dt = ys.dtype
        length, h_size = ys.shape[1], hx.shape[1]
        w_t = w_hh.float().t()
        dh = torch.zeros_like(hx) if d_hy is None else d_hy
        dc = torch.zeros_like(cx) if d_cy is None else d_cy
        dpre = [None] * length
        for t in reversed(range(length)):
            i, f, g, o = ifgo[t].split(h_size, dim=-1)
            if d_ys is not None:
                dh = dh + d_ys[:, t]
            tc = torch.tanh(cs[t])
            do = dh * tc
            dc = dc + dh * o * (1.0 - tc * tc)
            di = dc * g
            dg = dc * i
            df = dc * (cs[t - 1] if t else cx)
            dc = dc * f
            dpre[t] = torch.cat([di * i * (1.0 - i), df * f * (1.0 - f),
                                 dg * (1.0 - g * g), do * o * (1.0 - o)],
                                dim=-1)
            if t or ctx.needs_input_grad[3]:
                dh = torch.matmul(dpre[t].float(), w_t).to(dt)
        dpre = torch.stack(dpre, 0)                       # (L, B, 4H)
        # the deferred weight gradient: one product over every step
        h_prev = torch.cat([hx[None], ys.transpose(0, 1)[:-1]], 0)
        d_w = torch.matmul(h_prev.reshape(-1, h_size).float().t(),
                           dpre.reshape(-1, 4 * h_size).float()
                           ).to(w_hh.dtype)
        if not ctx.needs_input_grad[3]:
            dh = dc = None     # zero initial state: no hx, cx to reach
        return dpre.transpose(0, 1), d_w, dpre.sum((0, 1)), dh, dc


class LSTMChunk(Op):
    AXIS_NAMES = ("n",)

    def __init__(self, name: str, pc: ParallelConfig, x: Tensor,
                 hx: Tensor, cx: Tensor, hidden_size: int,
                 param_key: str = None):
        inputs = [x] + ([hx, cx] if hx is not None else [])
        super().__init__(name, pc, inputs)
        if x.ndim != 3:
            raise ValueError("lstm x must be (batch, chunk_len, input_size)")
        n, length, in_size = x.shape
        self.has_initial_state = hx is not None
        self.input_size = in_size
        self.hidden_size = hidden_size
        if param_key:
            self.param_key = param_key
        # declared float32 as in the JAX op; the values are in x's dtype
        self.output = Tensor((n, length, hidden_size), "float32", self,
                             f"{name}.y")
        self.hy = Tensor((n, hidden_size), "float32", self, f"{name}.hy")
        self.cy = Tensor((n, hidden_size), "float32", self, f"{name}.cy")
        self.outputs = [self.output, self.hy, self.cy]

    def init_params(self, gen, device) -> Dict:
        h = self.hidden_size
        w_ih = glorot_uniform((self.input_size, 4 * h), gen, device)
        w_hh = torch.empty((h, 4 * h), device=device)
        torch.nn.init.orthogonal_(w_hh, generator=gen)
        # forget-gate bias 1 (gate order i, f, g, o)
        b = torch.zeros((4 * h,), device=device)
        b[h:2 * h] = 1.0
        return {"w_ih": w_ih, "w_hh": w_hh, "b": b}

    def output_specs(self):
        return [("n", None, None), ("n", None), ("n", None)]

    def regrid_input_specs(self):
        return [("n", None, None)] + [("n", None)] * (len(self.inputs) - 1)

    def placement_signature(self):
        return (self.input_size, self.hidden_size, self.has_initial_state)

    def input_specs(self, pc=None):
        return self.regrid_input_specs()

    def forward(self, params, state, xs: List, train: bool):
        x = xs[0]
        dt = x.dtype
        if self.has_initial_state:
            hx, cx = xs[1], xs[2]
        else:
            hx = x.new_zeros((x.shape[0], self.hidden_size))
            cx = x.new_zeros((x.shape[0], self.hidden_size))
        w_ih = params["w_ih"].to(dt)
        # the input projection for the whole chunk: one product
        xg = torch.matmul(x.float(), w_ih.float()).to(dt)
        if not (train or torch.is_grad_enabled()):
            # inference (the serving forward): the recurrence alone,
            # keeping nothing for a backward
            y, hy, cy, _, _ = lstm_recurrence(xg, params["w_hh"].to(dt),
                                              params["b"].to(dt), hx, cx,
                                              saved=False)
            return (y, hy, cy), state
        y, hy, cy = LSTMCore.apply(xg, params["w_hh"].to(dt),
                                   params["b"].to(dt), hx, cx)
        return (y, hy, cy), state

    # ---- cost model (lstm.py:203-224) ---------------------------------

    def local_clone(self, pc: ParallelConfig):
        (pn,) = pc.dims
        n, length, e = self.inputs[0].shape
        if n % pn:
            return None
        x = Tensor((n // pn, length, e))
        hx = cx = None
        if self.has_initial_state:
            hx = Tensor((n // pn, self.hidden_size))
            cx = Tensor((n // pn, self.hidden_size))
        return LSTMChunk(self.name, ParallelConfig((1,), (0,)), x, hx, cx,
                         self.hidden_size)

    def flops_per_sample(self) -> float:
        length = self.output.shape[1]
        return 2.0 * length * 4 * self.hidden_size * (
            self.input_size + self.hidden_size)

    def param_bytes(self) -> int:
        h = self.hidden_size
        return 4 * (self.input_size * 4 * h + h * 4 * h + 4 * h)
