"""The port's vocab-slice fused projection + cross-entropy against the
JAX package's, the step of the vocab-parallel LM head.

``fused_linear_ce_partial`` (the ``FusedLinearCEPartial`` autograd
function, its plain versions on CPU tensors) returns ``(nll_local,
lse_local)`` over one slice of the vocab and is differentiable in both:
its backward runs kernels 5-6's two-cotangent form with gp = g_nll +
g_lse and goh = g_nll.  It is held against
``flexflow_tpu.ops.pallas.fused_ce.fused_linear_ce_partial`` with 16-row
and 16-column blocks in interpret mode (as tests/test_torch_fused_ce.py
runs the one-cotangent form), at n 40, d 24, V_local 100, labels
localized to the slice as the head does: partly inside it, partly below
and above it (another slice's), and -1 (the causal shift's no target).
Then the slices of a vocab split four ways, merged as
``FFModel._run_fused_lm_head`` merges them, against the whole fused
head: nll and every gradient.  Tolerances: float32 1e-5 relative to each
tensor's largest magnitude, bfloat16 2e-2 (the bar of
tests/test_torch_fused_ce.py).  The CUDA kernels are held against these
plain versions on the card by ``chip_smoke.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flexflow_tpu.ops.pallas.fused_ce import \
    fused_linear_ce_partial as j_partial
from flexflow_tpu_torch.ops import kernels
from flexflow_tpu_torch.ops.kernels import fused_ce as ce

torch.set_num_threads(2)

N, D, V = 40, 24, 100
TOL = {"float32": 1e-5, "bfloat16": 2e-2}


def _close(got, want, tol, what):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = max(float(np.abs(want).max()), 1.0)
    err = float(np.abs(got - want).max())
    assert err <= tol * scale, f"{what}: max err {err:.3e} > {tol} x {scale}"


def _inputs(seed, v=V):
    rng = np.random.RandomState(seed)
    x = rng.randn(N, D).astype("float32")
    w = (rng.randn(D, v) * 0.1).astype("float32")
    b = (rng.randn(v) * 0.1).astype("float32")
    # a slice's localized labels: in range, another slice's (below and
    # above) and -1 shifted by the slice's offset
    lab = rng.randint(-2 * v, 3 * v, (N,)).astype("int32")
    lab[::5] = rng.randint(0, v, (8,))
    lab[::7] = -1 - 2 * v
    g_nll = rng.randn(N).astype("float32")
    g_lse = rng.randn(N).astype("float32")
    return x, w, b, lab, g_nll, g_lse


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_partial_matches_pallas(dtype):
    x, w, b, lab, g_nll, g_lse = _inputs(3)
    assert ((lab >= 0) & (lab < V)).sum() >= 8 and (lab < 0).any() \
        and (lab >= V).any()
    xs = [jnp.asarray(a, dtype) for a in (x, w)] + [jnp.asarray(b)]
    (nll_j, lse_j), vjp = jax.vjp(
        lambda x, w, b: j_partial(x, w, b, jnp.asarray(lab), block_n=16,
                                  block_v=16, interpret=True), *xs)
    grads_j = vjp((jnp.asarray(g_nll), jnp.asarray(g_lse)))
    ts = [torch.from_numpy(a).to(getattr(torch, dtype)).requires_grad_()
          for a in (x, w)] + [torch.from_numpy(b).requires_grad_()]
    kernels.reset_launches()
    nll, lse = ce.fused_linear_ce_partial(*ts, torch.from_numpy(lab))
    assert nll.dtype == lse.dtype == torch.float32
    torch.autograd.backward([nll, lse], [torch.from_numpy(g_nll),
                                         torch.from_numpy(g_lse)])
    assert sum(kernels.launches.values()) == 0   # CPU: the plain versions
    tol = TOL[dtype]
    _close(nll.detach().numpy(), nll_j, tol, "nll")
    _close(lse.detach().numpy(), lse_j, tol, "lse")
    # a label outside the slice matches nothing: nll_local = lse_local
    miss = (lab < 0) | (lab >= V)
    np.testing.assert_array_equal(nll.detach().numpy()[miss],
                                  lse.detach().numpy()[miss])
    for t, g, name in zip(ts, grads_j, ("dx", "dw", "db")):
        assert t.grad.dtype == t.dtype, name
        _close(t.grad.float().numpy(), np.asarray(g.astype(jnp.float32)),
               tol, name)


def test_two_row_vectors_in_the_plain_backward():
    """t = gp softmax - goh onehot: the plain backward against the
    explicit product, and gp = goh = g its one-cotangent form."""
    x, w, b, lab, gp, goh = (torch.from_numpy(a) for a in _inputs(4))
    nll, lse = ce.fused_linear_ce_fwd_plain(x, w, b, lab)
    dx, dw, db = ce.fused_linear_ce_bwd_plain(x, w, b, lab, lse, gp, goh)
    logits = (x.double() @ w.double() + b.double())
    p = torch.softmax(logits, dim=1)
    hit = (lab >= 0) & (lab < V)
    onehot = torch.zeros_like(p)
    onehot[hit, lab[hit].long()] = 1.0
    t = gp.double()[:, None] * p - goh.double()[:, None] * onehot
    for got, want, name in ((dx, t @ w.double().t(), "dx"),
                            (dw, x.double().t() @ t, "dw"),
                            (db, t.sum(0), "db")):
        _close(got.numpy(), want.numpy(), 1e-5, name)
    one = ce.fused_linear_ce_bwd_plain(x, w, b, lab, lse, gp)
    same = ce.fused_linear_ce_bwd_plain(x, w, b, lab, lse, gp, gp)
    for a, c in zip(one, same):
        assert torch.equal(a, c)


def test_vocab_slices_merge_to_the_whole_head():
    """Four vocab slices through the partial form, merged as the
    vocab-parallel head merges them (max shift, one sum of [exp(lse_c -
    m), lse_c - nll_c]), equal the whole fused head: nll and the
    gradients of x, w and b under a weighted sum."""
    x, w, b, _, wgt, _ = _inputs(5, v=128)
    lab = np.random.RandomState(6).randint(0, 128, (N,)).astype("int32")
    lab[::6] = -1
    ts = [torch.from_numpy(a).requires_grad_() for a in (x, w, b)]
    want = ce.fused_linear_ce(*ts, torch.from_numpy(lab))
    want_grads = torch.autograd.grad((want * torch.from_numpy(wgt)).sum(),
                                     ts)
    ts2 = [torch.from_numpy(a).requires_grad_() for a in (x, w, b)]
    parts = [ce.fused_linear_ce_partial(
        ts2[0], ts2[1][:, 32 * c:32 * c + 32], ts2[2][32 * c:32 * c + 32],
        torch.from_numpy(lab) - 32 * c) for c in range(4)]
    lse_c = torch.stack([p[1] for p in parts])
    m = lse_c.detach().amax(0)
    sums = torch.stack([torch.stack([torch.exp(lse - m), lse - nll])
                        for nll, lse in parts]).sum(0)
    got = m + torch.log(sums[0]) - sums[1]
    grads = torch.autograd.grad((got * torch.from_numpy(wgt)).sum(), ts2)
    _close(got.detach().numpy(), want.detach().numpy(), 1e-5, "nll")
    for g, w_, name in zip(grads, want_grads, ("dx", "dw", "db")):
        _close(g.numpy(), w_.numpy(), 1e-5, name)
