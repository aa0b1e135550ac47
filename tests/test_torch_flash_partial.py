"""The port's partial flash attention and its merge against the JAX
package's, the step of ring attention.

``flash_attention_partial`` (the ``FlashAttentionPartial`` autograd
function, its plain versions on CPU tensors) returns ``(o, lse)`` of
attention over one K/V chunk and is differentiable in both; it is held
against ``flexflow_tpu.ops.pallas.flash_attention.flash_attention_partial``
in interpret mode with 16-blocks: o, lse and the gradients of q, k and v
under random cotangents of both outputs (``jax.vjp``), Sq equal to Sk and
not, causal and not.  ``combine_partials`` is held against JAX's on
random partials with fully masked rows (lse = -inf, o = 0) in one of the
two partials and in both, values and gradients, the gradients finite.
Tolerances: float32 1e-5 relative to each tensor's largest magnitude;
bfloat16 2e-2, the bar of tests/test_torch_flash_bwd.py (the Pallas
forward rounds p to bfloat16 before its product with v, the port's plain
forward does not).  The CUDA kernels are held against these plain
versions on the card by ``chip_smoke.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flexflow_tpu.ops.pallas.flash_attention import \
    combine_partials as j_combine
from flexflow_tpu.ops.pallas.flash_attention import \
    flash_attention_partial as j_partial
from flexflow_tpu_torch.ops import kernels
from flexflow_tpu_torch.ops.kernels import flash_attention as fa

torch.set_num_threads(2)

TOL = {"float32": 1e-5, "bfloat16": 2e-2}

CASES = [
    # (q shape, sk, causal, dtype)
    ((2, 2, 24, 8), 24, False, "float32"),
    ((2, 2, 24, 8), 24, True, "float32"),
    ((1, 2, 12, 8), 28, False, "float32"),
    ((1, 2, 12, 8), 28, True, "float32"),
    ((1, 2, 28, 8), 12, True, "float32"),
    ((1, 3, 20, 16), 36, False, "float32"),
    ((1, 2, 16, 8), 16, True, "bfloat16"),
    ((1, 2, 12, 8), 20, False, "bfloat16"),
]


def _close(got, want, tol, what):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = max(float(np.abs(want[np.isfinite(want)]).max()), 1.0)
    np.testing.assert_array_equal(np.isfinite(got), np.isfinite(want),
                                  err_msg=what)
    fin = np.isfinite(want)
    err = float(np.abs(got[fin] - want[fin]).max())
    assert err <= tol * scale, f"{what}: max err {err:.3e} > {tol} x {scale}"


def _inputs(seed, qshape, sk):
    rng = np.random.RandomState(seed)
    b, h, sq, d = qshape
    q = rng.randn(b, h, sq, d).astype("float32")
    k, v = (rng.randn(b, h, sk, d).astype("float32") for _ in range(2))
    g_o = rng.randn(b, h, sq, d).astype("float32")
    g_lse = rng.randn(b, h, sq).astype("float32")
    return q, k, v, g_o, g_lse


@pytest.mark.parametrize("qshape,sk,causal,dtype", CASES)
def test_partial_matches_pallas(qshape, sk, causal, dtype):
    q, k, v, g_o, g_lse = _inputs(0, qshape, sk)
    args = [jnp.asarray(a, dtype) for a in (q, k, v)]
    (o_j, lse_j), vjp = jax.vjp(
        lambda q, k, v: j_partial(q, k, v, causal, block_q=16, block_k=16,
                                  interpret=True), *args)
    grads_j = vjp((jnp.asarray(g_o), jnp.asarray(g_lse)))
    ts = [torch.from_numpy(a).to(getattr(torch, dtype)).requires_grad_()
          for a in (q, k, v)]
    kernels.reset_launches()
    o, lse = fa.flash_attention_partial(*ts, causal)
    assert o.dtype == lse.dtype == torch.float32
    assert tuple(o.shape) == qshape and tuple(lse.shape) == qshape[:3]
    torch.autograd.backward([o, lse], [torch.from_numpy(g_o),
                                       torch.from_numpy(g_lse)])
    assert sum(kernels.launches.values()) == 0   # CPU: the plain versions
    tol = TOL[dtype]
    _close(o.detach().numpy(), o_j, tol, "o")
    _close(lse.detach().numpy(), lse_j, tol, "lse")
    for t, w, name in zip(ts, grads_j, ("dq", "dk", "dv")):
        assert t.grad.dtype == t.dtype, name
        _close(t.grad.float().numpy(), np.asarray(w.astype(jnp.float32)),
               tol, name)


def test_lse_cotangent_alone_is_the_softmax_weighted_score_gradient():
    """With g_o = 0, d lse / d s = softmax: dq = g_lse P k / sqrt(d)."""
    q, k, v, _, g_lse = _inputs(3, (1, 2, 10, 8), 14)
    qt, kt, vt = (torch.from_numpy(a).double().requires_grad_()
                  for a in (q, k, v))
    s = qt @ kt.transpose(-1, -2) / np.sqrt(8)
    p = torch.softmax(s, -1)
    want = (torch.from_numpy(g_lse).double()[..., None] * p) @ kt \
        / np.sqrt(8)
    qf = torch.from_numpy(q).requires_grad_()
    o, lse = fa.flash_attention_partial(qf, torch.from_numpy(k),
                                        torch.from_numpy(v))
    torch.autograd.backward([o, lse], [torch.zeros_like(o),
                                       torch.from_numpy(g_lse)])
    np.testing.assert_allclose(qf.grad.numpy(), want.detach().numpy(),
                               rtol=1e-5, atol=1e-5)


def _partials(seed):
    rng = np.random.RandomState(seed)
    o1, o2 = (rng.randn(2, 3, 10, 8).astype("float32") for _ in range(2))
    lse1, lse2 = (rng.randn(2, 3, 10).astype("float32") * 3
                  for _ in range(2))
    # fully masked rows: in the second partial, in the first, in both
    for o, lse, rows in ((o2, lse2, [1, 4, 7]), (o1, lse1, [2, 7])):
        lse[:, :, rows] = -np.inf
        o[:, :, rows] = 0.0
    g_o = rng.randn(2, 3, 10, 8).astype("float32")
    g_lse = rng.randn(2, 3, 10).astype("float32")
    return (o1, lse1, o2, lse2), (g_o, g_lse)


def test_combine_partials_matches_jax():
    ins, (g_o, g_lse) = _partials(5)
    (o_j, lse_j), vjp = jax.vjp(j_combine, *map(jnp.asarray, ins))
    # a row masked in both partials has no lse to differentiate
    g_lse_j = np.where(np.isfinite(np.asarray(lse_j)), g_lse, 0.0)
    grads_j = vjp((jnp.asarray(g_o), jnp.asarray(g_lse_j, jnp.float32)))
    ts = [torch.from_numpy(a).requires_grad_() for a in ins]
    o, lse = fa.combine_partials(*ts)
    _close(o.detach().numpy(), o_j, 1e-6, "o")
    _close(lse.detach().numpy(), lse_j, 1e-6, "lse")
    # both masked: o = 0, lse = -inf; one masked: the other unchanged
    assert np.all(o.detach().numpy()[:, :, 7] == 0)
    assert np.all(np.isneginf(lse.detach().numpy()[:, :, 7]))
    np.testing.assert_array_equal(lse.detach().numpy()[:, :, 1],
                                  ins[1][:, :, 1])
    torch.autograd.backward([o, lse], [torch.from_numpy(g_o),
                                       torch.from_numpy(g_lse_j)])
    for t, w, name in zip(ts, grads_j, ("do1", "dlse1", "do2", "dlse2")):
        assert np.isfinite(t.grad.numpy()).all(), name
        _close(t.grad.numpy(), np.asarray(w), 1e-6, name)


def test_chunked_partials_merge_to_the_whole_attention():
    """Partials over the key chunks of a causal sequence, merged, equal
    the whole attention and its gradients: the ring's arithmetic in one
    process (the hidden chunk skipped, the visible ones non-causal)."""
    q, k, v, g_o, _ = _inputs(6, (1, 2, 24, 8), 24)
    ts = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    want = fa.flash_attention(*ts, True)
    want_grads = torch.autograd.grad(want, ts, torch.from_numpy(g_o))
    ts2 = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    qs, ks, vs = (t.chunk(3, dim=2) for t in ts2)
    outs = []
    for i in range(3):
        o, lse = fa.flash_attention_partial(qs[i], ks[i], vs[i], True)
        for j in range(i):
            o_j, lse_j = fa.flash_attention_partial(qs[i], ks[j], vs[j])
            o, lse = fa.combine_partials(o, lse, o_j, lse_j)
        outs.append(o)
    got = torch.cat(outs, dim=2)
    grads = torch.autograd.grad(got, ts2, torch.from_numpy(g_o))
    _close(got.detach().numpy(), want.detach().numpy(), 1e-5, "o")
    for g, w, name in zip(grads, want_grads, ("dq", "dk", "dv")):
        _close(g.numpy(), w.numpy(), 1e-5, name)
