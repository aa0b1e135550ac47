"""The port's flash-attention backward against the Pallas kernels.

``flash_attention_bwd_plain`` and the ``FlashAttention`` autograd
function (which runs the plain versions on CPU tensors) are held against
``jax.vjp`` through ``flexflow_tpu.ops.pallas.flash_attention.
flash_attention`` in interpret mode, on the shapes tests/test_pallas.py
pins: (2, 2, 24, 8) causal and not with 16-blocks, the padding case
(1, 2, 20, 8) with 16-blocks, a cross case (Sq 12, Sk 28), bfloat16
(1, 2, 16, 8), and the largest head dim the kernels take, (1, 2, 24, 128)
causal and not in both dtypes.  Tolerances: float32 1e-4 (the bar of test_pallas.py's
gradient parity: the same math summed in another order); bfloat16 2e-2
(the Pallas forward also rounds p to bfloat16 before its product with v,
the port's forward does not, so o and with it delta differ by about one
bfloat16 step).  The CUDA kernels run only on a GPU:
tests/test_torch_cuda.py holds them against the plain version on the
card.  A numpy model of the dk/dv kernel's warp (its transposed tiles
and the m16n8k8 fragments of ``mma.sync``) shows how the kernel feeds
the C fragments of P^T and dS^T to the next product as A fragments.
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
    # head dim 128, the GPT-1.3B preset's (2048 / 16)
    ((1, 2, 24, 128), 24, False, "float32", {}),
    ((1, 2, 24, 128), 24, True, "float32", {}),
    ((1, 2, 24, 128), 24, False, "bfloat16", {}),
    ((1, 2, 24, 128), 24, True, "bfloat16", {}),
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
    # meta tensors (the dry run) get the gradients' shapes, nothing run;
    # a mix of devices is refused
    meta = [t.to("meta") for t in (q, k, v, o, lse, g)]
    assert [(t.device.type, t.shape, t.dtype)
            for t in fa.flash_attention_bwd(*meta)] == \
        [("meta", t.shape, t.dtype) for t in want]
    with pytest.raises(ValueError, match="different devices"):
        fa.flash_attention_bwd(q, k, v, o, lse.to("meta"), g)
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


def test_backward_kernels_take_every_forward_head_dim():
    assert fa.HEAD_DIMS_BWD == fa.HEAD_DIMS_FWD == (8, 16, 32, 64, 128)


# --- a numpy model of the dk/dv kernel's warp ------------------------------
# mma.sync m16n8k8 (TF32) fragments, lane = 4 g + t: A (16 x 8) a0 (g, t),
# a1 (g + 8, t), a2 (g, t + 4), a3 (g + 8, t + 4); B (8 x 8) b0 (t, g),
# b1 (t + 4, g); C (16 x 8) c0 (g, 2t), c1 (g, 2t + 1), c2 (g + 8, 2t),
# c3 (g + 8, 2t + 1).

_G, _T = np.arange(32) // 4, np.arange(32) % 4


def _c_frags(m):
    """(16, 8) accumulator tile -> (32 lanes, 4) C fragments."""
    return np.stack([m[_G, 2 * _T], m[_G, 2 * _T + 1], m[_G + 8, 2 * _T],
                     m[_G + 8, 2 * _T + 1]], axis=1)


def _c_tile(c):
    m = np.zeros((16, 8))
    m[_G, 2 * _T], m[_G, 2 * _T + 1] = c[:, 0], c[:, 1]
    m[_G + 8, 2 * _T], m[_G + 8, 2 * _T + 1] = c[:, 2], c[:, 3]
    return m


def _mma(a, b, c):
    """One m16n8k8 product D = A B + C on per-lane fragments."""
    am = np.zeros((16, 8))
    am[_G, _T], am[_G + 8, _T] = a[:, 0], a[:, 1]
    am[_G, _T + 4], am[_G + 8, _T + 4] = a[:, 2], a[:, 3]
    bm = np.zeros((8, 8))
    bm[_T, _G], bm[_T + 4, _G] = b[:, 0], b[:, 1]
    return _c_frags(am @ bm + _c_tile(c))


def _a_frag(x, r0, c0):
    """A fragment of rows r0.. r0 + 15, columns c0.. c0 + 7 of x."""
    return np.stack([x[r0 + _G, c0 + _T], x[r0 + _G + 8, c0 + _T],
                     x[r0 + _G, c0 + _T + 4], x[r0 + _G + 8, c0 + _T + 4]],
                    axis=1)


def _dkv_warp_model(q, k, v, do, lse, delta, causal, permuted=True):
    """dk, dv of one head as the dk/dv kernel's warps compute them: per 16
    keys and per 8 queries, S^T = K Q^T and dP^T = V dO^T as m16n8k8
    products, p and ds on their C fragments (element e of lane (g, t) is
    key g + 8 (e // 2), query 2t + e % 2), then dV += P^T dO and dK +=
    dS^T Q with the C fragments taken as A fragments (a0..a3 = c0, c2, c1,
    c3) and the step's dO and Q rows read in the order 0, 2, 4, 6, 1, 3,
    5, 7 (b0 from row 2t, b1 from row 2t + 1); ``permuted=False`` reads
    them in their own order instead."""
    sq, d = q.shape
    sk = k.shape[0]
    scale = 1.0 / np.sqrt(d)
    pad = lambda x, n: np.concatenate(  # noqa: E731
        [x, np.zeros((n - len(x), d))]).astype(np.float64)
    nq = -(-sq // 8) * 8
    qp, dop = pad(q, nq), pad(do, nq)
    kp, vp = pad(k, -(-sk // 16) * 16), pad(v, -(-sk // 16) * 16)
    safe = np.where(np.isfinite(lse), lse, 0.0)
    dk, dv = np.zeros_like(kp), np.zeros_like(vp)
    e = np.arange(4)
    for kw0 in range(0, sk, 16):
        dka = np.zeros((d // 8, 32, 4))
        dva = np.zeros((d // 8, 32, 4))
        key = kw0 + _G[:, None] + 8 * (e // 2)[None]
        for c0 in range(0, sq, 8):
            query = c0 + 2 * _T[:, None] + (e % 2)[None]
            s, dp = np.zeros((32, 4)), np.zeros((32, 4))
            for kk in range(0, d, 8):
                bq = np.stack([qp[c0 + _G, kk + _T], qp[c0 + _G, kk + _T + 4]],
                              axis=1)
                bdo = np.stack([dop[c0 + _G, kk + _T],
                                dop[c0 + _G, kk + _T + 4]], axis=1)
                s = _mma(_a_frag(kp, kw0, kk), bq, s)
                dp = _mma(_a_frag(vp, kw0, kk), bdo, dp)
            valid = query < sq
            if causal:
                valid &= query >= key
            qi = np.minimum(query, sq - 1)
            p = np.where(valid, np.exp(s * scale - safe[qi]), 0.0)
            ds = p * (dp - delta[qi]) * scale
            rows = (c0 + 2 * _T, c0 + 2 * _T + 1) if permuted else \
                (c0 + _T, c0 + _T + 4)
            for n0 in range(d // 8):
                cols = 8 * n0 + _G
                b_do = np.stack([dop[r, cols] for r in rows], axis=1)
                b_q = np.stack([qp[r, cols] for r in rows], axis=1)
                dva[n0] = _mma(p[:, [0, 2, 1, 3]], b_do, dva[n0])
                dka[n0] = _mma(ds[:, [0, 2, 1, 3]], b_q, dka[n0])
        for n0 in range(d // 8):
            dk[kw0:kw0 + 16, 8 * n0:8 * n0 + 8] = _c_tile(dka[n0])
            dv[kw0:kw0 + 16, 8 * n0:8 * n0 + 8] = _c_tile(dva[n0])
    return dk[:sk], dv[:sk]


def test_dkv_kernel_warp_model_matches_plain_backward():
    # ragged and causal: 37 queries and keys (a partial 16-key warp tile
    # and a partial 8-query step), two heads
    rng = np.random.RandomState(7)
    q, k, v, do = (rng.randn(1, 2, 37, 16).astype("float32")
                   for _ in range(4))
    qt, kt, vt, dot = (torch.from_numpy(a) for a in (q, k, v, do))
    o, lse = fa.flash_attention_fwd_plain(qt, kt, vt, True)
    _, dk, dv = fa.flash_attention_bwd_plain(qt, kt, vt, o, lse, dot, True)
    delta = (dot * o).sum(-1).numpy()
    for hd in range(2):
        args = (q[0, hd], k[0, hd], v[0, hd], do[0, hd], lse[0, hd].numpy(),
                delta[0, hd])
        mk, mv = _dkv_warp_model(*args, causal=True)
        np.testing.assert_allclose(mk, dk[0, hd].numpy(), rtol=1e-5,
                                   atol=1e-5)
        np.testing.assert_allclose(mv, dv[0, hd].numpy(), rtol=1e-5,
                                   atol=1e-5)
        # the same C fragments against dO and Q rows in their own order
        # pair the wrong queries
        wk, wv = _dkv_warp_model(*args, causal=True, permuted=False)
        assert np.abs(wv - dv[0, hd].numpy()).max() > 1e-1
        assert np.abs(wk - dk[0, hd].numpy()).max() > 1e-1
