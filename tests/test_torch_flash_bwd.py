"""The port's flash-attention backward against the Pallas kernels.

``flash_attention_bwd_plain`` and the ``FlashAttention`` autograd
function (which runs the plain versions on CPU tensors) are held against
``jax.vjp`` through ``flexflow_tpu.ops.pallas.flash_attention.
flash_attention`` in interpret mode, on the shapes tests/test_pallas.py
pins: (2, 2, 24, 8) causal and not with 16-blocks, the padding case
(1, 2, 20, 8) with 16-blocks, a cross case (Sq 12, Sk 28), and bfloat16
(1, 2, 16, 8).  Tolerances: float32 1e-4 (the bar of test_pallas.py's
gradient parity: the same math summed in another order); bfloat16 2e-2
(the Pallas forward also rounds p to bfloat16 before its product with v,
the port's forward does not, so o and with it delta differ by about one
bfloat16 step).  The CUDA kernels run only on a GPU:
tests/test_torch_cuda.py holds them against the plain version on the
card.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flexflow_tpu.ops.pallas.flash_attention import flash_attention as j_flash
from flexflow_tpu_torch.ops import kernels
from flexflow_tpu_torch.ops.kernels import flash_attention as fa

torch.set_num_threads(2)

TOL = {"float32": 1e-4, "bfloat16": 2e-2}


def _inputs(seed, qshape, sk):
    rng = np.random.RandomState(seed)
    b, h, sq, d = qshape
    q = rng.randn(b, h, sq, d).astype("float32")
    k, v = (rng.randn(b, h, sk, d).astype("float32") for _ in range(2))
    g = rng.randn(b, h, sq, d).astype("float32")
    return q, k, v, g


def _jax_grads(q, k, v, g, causal, dtype, **blocks):
    args = [jnp.asarray(a, dtype) for a in (q, k, v)]
    _, vjp = jax.vjp(lambda q, k, v: j_flash(q, k, v, causal, interpret=True,
                                             **blocks), *args)
    return [np.asarray(t.astype(jnp.float32)) for t in vjp(jnp.asarray(g))]


def _torch(a, dtype):
    return torch.from_numpy(a).to(getattr(torch, dtype))


CASES = [
    # (q shape, sk, causal, dtype, blocks)
    ((2, 2, 24, 8), 24, False, "float32", {"block_q": 16, "block_k": 16}),
    ((2, 2, 24, 8), 24, True, "float32", {"block_q": 16, "block_k": 16}),
    # S=20 with 16-blocks: the Pallas zero-pad + key-mask path
    ((1, 2, 20, 8), 20, True, "float32", {"block_q": 16, "block_k": 16}),
    # Sq != Sk: one K/V chunk of cross attention
    ((1, 2, 12, 8), 28, False, "float32", {}),
    ((1, 2, 12, 8), 28, True, "float32", {}),
    ((1, 2, 16, 8), 16, False, "bfloat16", {}),
    ((1, 2, 16, 8), 16, True, "bfloat16", {}),
]


@pytest.mark.parametrize("qshape,sk,causal,dtype,blocks", CASES)
def test_plain_backward_matches_pallas(qshape, sk, causal, dtype, blocks):
    q, k, v, g = _inputs(0, qshape, sk)
    want = _jax_grads(q, k, v, g, causal, dtype, **blocks)
    qt, kt, vt = (_torch(a, dtype) for a in (q, k, v))
    o, lse = fa.flash_attention_fwd_plain(qt, kt, vt, causal)
    got = fa.flash_attention_bwd_plain(qt, kt, vt, o, lse,
                                       torch.from_numpy(g), causal)
    for t, w, name in zip(got, want, ("dq", "dk", "dv")):
        assert t.dtype == torch.float32, name
        np.testing.assert_allclose(t.numpy(), w, rtol=TOL[dtype],
                                   atol=TOL[dtype], err_msg=name)


@pytest.mark.parametrize("qshape,sk,causal,dtype,blocks", CASES)
def test_autograd_function_matches_pallas(qshape, sk, causal, dtype, blocks):
    q, k, v, g = _inputs(1, qshape, sk)
    want = _jax_grads(q, k, v, g, causal, dtype, **blocks)
    qt, kt, vt = (_torch(a, dtype).requires_grad_() for a in (q, k, v))
    kernels.reset_launches()
    o = fa.flash_attention(qt, kt, vt, causal)
    assert o.dtype == torch.float32 and tuple(o.shape) == qshape
    o.backward(torch.from_numpy(g))
    assert sum(kernels.launches.values()) == 0   # CPU: the plain versions
    for t, w, name in zip((qt, kt, vt), want, ("dq", "dk", "dv")):
        # cotangents come back in the primal dtype, as in JAX
        assert t.grad.dtype == getattr(torch, dtype), name
        np.testing.assert_allclose(t.grad.float().numpy(), w,
                                   rtol=TOL[dtype], atol=TOL[dtype],
                                   err_msg=name)


def test_backward_of_squared_output_matches_pallas():
    # test_pallas.py's gradient parity: d/dqkv sum(o^2), whose cotangent
    # 2o depends on the forward
    q, k, v, _ = _inputs(2, (2, 2, 24, 8), 24)
    for causal in (False, True):
        want = jax.grad(lambda q, k, v: (j_flash(
            q, k, v, causal, block_q=16, block_k=16, interpret=True) ** 2)
            .sum(), argnums=(0, 1, 2))(*(jnp.asarray(a) for a in (q, k, v)))
        ts = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
        (fa.flash_attention(*ts, causal) ** 2).sum().backward()
        for t, w in zip(ts, want):
            np.testing.assert_allclose(t.grad.numpy(), np.asarray(w),
                                       rtol=1e-4, atol=1e-4)


def test_plain_backward_without_keys_is_zero():
    q = torch.randn(1, 2, 5, 8)
    k = v = torch.zeros(1, 2, 0, 8)
    o, lse = fa.flash_attention_fwd_plain(q, k, v, False)
    dq, dk, dv = fa.flash_attention_bwd_plain(q, k, v, o, lse,
                                              torch.ones_like(o), False)
    assert bool((dq == 0).all())
    assert tuple(dk.shape) == tuple(dv.shape) == (1, 2, 0, 8)


def test_backward_dispatch():
    q, k, v, g = (torch.from_numpy(a) for a in _inputs(3, (1, 2, 8, 8), 8))
    o, lse = fa.flash_attention_fwd_plain(q, k, v, True)
    kernels.reset_launches()
    got = fa.flash_attention_bwd(q, k, v, o, lse, g, True)
    want = fa.flash_attention_bwd_plain(q, k, v, o, lse, g, True)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert kernels.launches[fa.NAME_DKV] == kernels.launches[fa.NAME_DQ] == 0
    meta = [t.to("meta") for t in (q, k, v, o, lse, g)]
    with pytest.raises(ValueError, match="no implementation"):
        fa.flash_attention_bwd(*meta)
    delta = (g * o).sum(-1)
    with pytest.raises(ValueError, match="CUDA device"):
        fa.flash_attention_bwd_dkv_cuda(q, k, v, g, lse, delta)
    with pytest.raises(ValueError, match="CUDA device"):
        fa.flash_attention_bwd_dq_cuda(q, k, v, g, lse, delta)


def test_attention_op_trains_through_flash_attention():
    """The op's gradient flows through the ``FlashAttention`` autograd
    function, the one whose backward is kernels 2 and 3 on a GPU (the
    op used to call the forward kernel's wrapper, which has no
    gradient on the card)."""
    from flexflow_tpu_torch.ops.attention import MultiHeadAttention
    from flexflow_tpu_torch.ops.base import Tensor
    from flexflow_tpu_torch.strategy import ParallelConfig

    op = MultiHeadAttention("attn", ParallelConfig((1, 1, 1), (0,)),
                            Tensor((2, 8, 16)), num_heads=2, causal=True)
    gen = torch.Generator().manual_seed(0)
    params = {k: p.requires_grad_() for k, p in
              op.init_params(gen, "cpu").items()}
    x = torch.randn(2, 8, 16, generator=gen)
    y, _ = op.forward(params, {}, [x], train=True)
    seen, stack = set(), [y.grad_fn]
    while stack:
        fn = stack.pop()
        if fn is None or fn in seen:
            continue
        seen.add(fn)
        stack.extend(f for f, _ in fn.next_functions)
    assert "FlashAttentionBackward" in {type(f).__name__ for f in seen}
    grads = torch.autograd.grad(y.sum(), [params[w] for w in
                                          ("wq", "wk", "wv", "wo")])
    assert all(bool(g.abs().sum() > 0) for g in grads)
