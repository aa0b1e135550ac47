"""Flash attention at head dims the kernels are not built for.

The dispatchers ``flash_attention_fwd`` / ``flash_attention_bwd`` zero-pad
q, k, v (and o, do) along d to the smallest head dim the kernels take
(``padded_head_dim``), scale the scores by the true ``1/sqrt(d)`` and
slice o, dq, dk, dv back to d.  On CPU tensors they run the plain
versions through that same path, so the padding is tested here: the
``FlashAttention`` autograd function at head dims 96 and 40 is held
against ``jax.vjp`` through the Pallas kernels in interpret mode (which
pad d themselves), float32 at 1e-4 and bfloat16 at 2e-2, the bars of
tests/test_torch_flash_bwd.py.  Head dims above 128 are refused.
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


def test_padded_head_dim():
    assert [fa.padded_head_dim(d) for d in (1, 8, 9, 40, 64, 65, 96, 128)] \
        == [8, 8, 16, 64, 64, 128, 128, 128]
    with pytest.raises(ValueError, match="head dim 160"):
        fa.padded_head_dim(160)


@pytest.mark.parametrize("qshape,sk,causal,dtype", [
    ((2, 2, 24, 96), 24, True, "float32"),
    ((1, 2, 12, 96), 28, False, "float32"),
    ((2, 2, 24, 40), 24, True, "float32"),
    ((1, 2, 20, 40), 33, False, "float32"),
    ((1, 2, 16, 96), 16, True, "bfloat16"),
    ((1, 2, 16, 40), 16, False, "bfloat16"),
])
def test_padded_path_matches_pallas(monkeypatch, qshape, sk, causal, dtype):
    q, k, v, g = _inputs(5, qshape, sk)
    jdt = jnp.dtype(dtype)
    j_args = [jnp.asarray(a, jdt) for a in (q, k, v)]
    j_o, vjp = jax.vjp(lambda q, k, v: j_flash(q, k, v, causal,
                                               interpret=True), *j_args)
    want = [np.asarray(t.astype(jnp.float32)) for t in vjp(jnp.asarray(g))]
    # the plain versions see the padded head dim and the true scale
    seen = []
    fwd, bwd = fa.flash_attention_fwd_plain, fa.flash_attention_bwd_plain

    def spy_fwd(q, k, v, causal, scale=None):
        seen.append(("fwd", q.shape[-1], scale))
        return fwd(q, k, v, causal, scale)

    def spy_bwd(q, k, v, o, lse, do, causal, scale=None):
        seen.append(("bwd", q.shape[-1], scale))
        return bwd(q, k, v, o, lse, do, causal, scale)

    monkeypatch.setattr(fa, "flash_attention_fwd_plain", spy_fwd)
    monkeypatch.setattr(fa, "flash_attention_bwd_plain", spy_bwd)
    tdt = getattr(torch, dtype)
    ts = [torch.from_numpy(a).to(tdt).requires_grad_() for a in (q, k, v)]
    kernels.reset_launches()
    o = fa.flash_attention(*ts, causal)
    assert tuple(o.shape) == qshape and o.is_contiguous()
    o.backward(torch.from_numpy(g))
    assert sum(kernels.launches.values()) == 0   # CPU: the plain versions
    d = qshape[-1]
    dp = fa.padded_head_dim(d)
    assert dp > d
    assert seen == [("fwd", dp, 1.0 / np.sqrt(d)),
                    ("bwd", dp, 1.0 / np.sqrt(d))]
    np.testing.assert_allclose(o.detach().numpy(),
                               np.asarray(j_o.astype(jnp.float32)),
                               rtol=TOL[dtype], atol=TOL[dtype])
    for t, w, name in zip(ts, want, ("dq", "dk", "dv")):
        assert t.grad.dtype == tdt and tuple(t.grad.shape) == t.shape, name
        np.testing.assert_allclose(t.grad.float().numpy(), w,
                                   rtol=TOL[dtype], atol=TOL[dtype],
                                   err_msg=name)


def test_padded_path_equals_unpadded_plain():
    # the padding changes no score: the padded dispatcher equals the plain
    # version run at the true head dim
    q, k, v, g = (torch.from_numpy(a) for a in _inputs(6, (1, 3, 17, 96),
                                                        17))
    o, lse = fa.flash_attention_fwd(q, k, v, True)
    o_p, lse_p = fa.flash_attention_fwd_plain(q, k, v, True)
    torch.testing.assert_close(o, o_p, rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(lse, lse_p, rtol=1e-6, atol=1e-6)
    got = fa.flash_attention_bwd(q, k, v, o, lse, g, True)
    want = fa.flash_attention_bwd_plain(q, k, v, o_p, lse_p, g, True)
    for a, b in zip(got, want):
        assert a.shape == b.shape
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)


def test_head_dims_above_128_are_refused():
    q, k, v, g = (torch.from_numpy(a) for a in _inputs(7, (1, 2, 8, 160),
                                                        8))
    with pytest.raises(ValueError, match="head dim 160 is above 128"):
        fa.flash_attention_fwd(q, k, v, False)
    o, lse = fa.flash_attention_fwd_plain(q, k, v, False)
    with pytest.raises(ValueError, match="head dim 160 is above 128"):
        fa.flash_attention_bwd(q, k, v, o, lse, g, False)
