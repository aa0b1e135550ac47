"""The port's fused vocab projection + cross-entropy against the Pallas
kernels.

``fused_linear_ce_fwd_plain`` / ``fused_linear_ce_bwd_plain`` and the
``FusedLinearCE`` autograd function (the plain versions on CPU tensors)
are held against ``flexflow_tpu.ops.pallas.fused_ce.fused_linear_ce``
with 16-row and 16-column blocks in interpret mode, at
tests/test_pallas.py's n 40, d 24, V 100 (V not a multiple of the block,
so the padded vocab tail is masked): the per-token NLL at 1e-5 and the
gradients of a weighted sum of it (the weights exercise the cotangent's
scaling) at 1e-4, that test's bars; labels include -1 and V + 3, which
match nothing.  bfloat16 operands at 2e-2 (the two packages round the
same values to bfloat16 but sum in another order).  The CUDA kernels run
only on a GPU: tests/test_torch_cuda.py holds them against the plain
versions on the card.

The kernels' float32 products are 3xTF32 on the tensor cores; a numpy
emulation of ``cvt.rna.tf32.f32`` here shows, on LM-head-like operands
against a float64 product, why three TF32 products meet the float32 gates
where one does not.  A numpy model of the forward kernel's merge (per
thread, quad, warp and vocab slice, then the fixed-order combine) is held
against the Pallas forward at 1e-6.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flexflow_tpu.ops.pallas.fused_ce import fused_linear_ce as j_fused
from flexflow_tpu.ops.pallas.fused_ce import fused_linear_ce_partial
from flexflow_tpu_torch.ops import kernels
from flexflow_tpu_torch.ops.kernels import fused_ce as ce

torch.set_num_threads(2)

N, D, V = 40, 24, 100
TOL = {"float32": (1e-5, 1e-4), "bfloat16": (2e-2, 2e-2)}


def _inputs(seed):
    rng = np.random.RandomState(seed)
    x = rng.randn(N, D).astype("float32")
    w = (rng.randn(D, V) * 0.1).astype("float32")
    b = (rng.randn(V) * 0.1).astype("float32")
    lab = rng.randint(0, V, (N,)).astype("int32")
    lab[::7] = -1        # the causal shift's "no target"
    lab[3] = V + 3       # past the vocab: matches nothing either
    wgt = (np.arange(1.0, N + 1) / N).astype("float32")
    return x, w, b, lab, wgt


def _jax(x, w, b, lab, wgt, dtype):
    xs = [jnp.asarray(a, dtype) for a in (x, w, b)]
    labj = jnp.asarray(lab)

    def f(x, w, b):
        return j_fused(x, w, b, labj, block_n=16, block_v=16, interpret=True)

    nll = f(*xs)
    grads = jax.grad(lambda x, w, b: (f(x, w, b) * wgt).sum(),
                     argnums=(0, 1, 2))(*xs)
    return np.asarray(nll), [np.asarray(g.astype(jnp.float32))
                             for g in grads]


def _torch(a, dtype):
    return torch.from_numpy(a).to(getattr(torch, dtype))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_versions_match_pallas(dtype):
    x, w, b, lab, wgt = _inputs(7)
    nll_j, grads_j = _jax(x, w, b, lab, wgt, dtype)
    xt, wt = _torch(x, dtype), _torch(w, dtype)
    bt = _torch(b, dtype).float()
    labt = torch.from_numpy(lab)
    nll, lse = ce.fused_linear_ce_fwd_plain(xt, wt, bt, labt)
    tol_v, tol_g = TOL[dtype]
    np.testing.assert_allclose(nll.numpy(), nll_j, rtol=tol_v, atol=tol_v)
    # a label that matches nothing leaves nll = lse
    miss = (lab < 0) | (lab >= V)
    np.testing.assert_array_equal(nll.numpy()[miss], lse.numpy()[miss])
    got = ce.fused_linear_ce_bwd_plain(xt, wt, bt, labt, lse,
                                       torch.from_numpy(wgt))
    for t, want, name in zip(got, grads_j, ("dx", "dw", "db")):
        assert t.dtype == torch.float32
        np.testing.assert_allclose(t.numpy(), want, rtol=tol_g, atol=tol_g,
                                   err_msg=name)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_autograd_function_matches_pallas(dtype):
    x, w, b, lab, wgt = _inputs(8)
    nll_j, grads_j = _jax(x, w, b, lab, wgt, dtype)
    ts = [_torch(a, dtype).requires_grad_() for a in (x, w, b)]
    kernels.reset_launches()
    nll = ce.fused_linear_ce(*ts, torch.from_numpy(lab))
    assert nll.dtype == torch.float32 and tuple(nll.shape) == (N,)
    (nll * torch.from_numpy(wgt)).sum().backward()
    assert sum(kernels.launches.values()) == 0   # CPU: the plain versions
    tol_v, tol_g = TOL[dtype]
    np.testing.assert_allclose(nll.detach().numpy(), nll_j, rtol=tol_v,
                               atol=tol_v)
    for t, want, name in zip(ts, grads_j, ("dx", "dw", "db")):
        assert t.grad.dtype == getattr(torch, dtype), name
        np.testing.assert_allclose(t.grad.float().numpy(), want, rtol=tol_g,
                                   atol=tol_g, err_msg=name)


def test_mixed_dtypes_cast_like_the_jax_op():
    # bf16 activations with float32 weights: w is cast to x's dtype, the
    # bias to float32, and each gradient returns in its input's dtype
    x, w, b, lab, wgt = _inputs(9)
    xt = torch.from_numpy(x).bfloat16().requires_grad_()
    wt = torch.from_numpy(w).requires_grad_()
    bt = torch.from_numpy(b).requires_grad_()
    nll = ce.fused_linear_ce(xt, wt, bt, torch.from_numpy(lab).long())
    (nll * torch.from_numpy(wgt)).sum().backward()
    assert (xt.grad.dtype, wt.grad.dtype, bt.grad.dtype) == \
        (torch.bfloat16, torch.float32, torch.float32)
    nll_j = j_fused(jnp.asarray(x, jnp.bfloat16), jnp.asarray(w),
                    jnp.asarray(b), jnp.asarray(lab), block_n=16,
                    block_v=16, interpret=True)
    np.testing.assert_allclose(nll.detach().numpy(), np.asarray(nll_j),
                               rtol=2e-2, atol=2e-2)


def test_dispatch_and_refusals():
    x, w, b, lab, wgt = (torch.from_numpy(a) for a in _inputs(10))
    kernels.reset_launches()
    nll, lse = ce.fused_linear_ce_fwd(x, w, b, lab)
    nll_p, lse_p = ce.fused_linear_ce_fwd_plain(x, w, b, lab)
    torch.testing.assert_close(nll, nll_p, rtol=0, atol=0)
    grads = ce.fused_linear_ce_bwd(x, w, b, lab, lse, wgt)
    for a, c in zip(grads, ce.fused_linear_ce_bwd_plain(x, w, b, lab, lse,
                                                        wgt)):
        torch.testing.assert_close(a, c, rtol=0, atol=0)
    assert sum(kernels.launches.values()) == 0
    # meta tensors (the dry run) get the outputs' shapes, nothing run;
    # a mix of devices is refused
    got = ce.fused_linear_ce_fwd(*(t.to("meta") for t in (x, w, b, lab)))
    assert [(t.device.type, t.shape, t.dtype) for t in got] == \
        [("meta", t.shape, t.dtype) for t in (nll_p, lse_p)]
    assert sum(kernels.launches.values()) == 0
    with pytest.raises(ValueError, match="different devices"):
        ce.fused_linear_ce_fwd(x.to("meta"), w, b, lab)
    with pytest.raises(ValueError, match="CUDA device"):
        ce.fused_linear_ce_fwd_cuda(x, w, b, lab)
    with pytest.raises(ValueError, match="CUDA device"):
        ce.fused_linear_ce_bwd_dx_cuda(x, w, b, lab, lse, wgt)
    with pytest.raises(ValueError, match="CUDA device"):
        ce.fused_linear_ce_bwd_dw_cuda(x, w, b, lab, lse, wgt)


def _tf32(a):
    """``cvt.rna.tf32.f32``: keep 10 mantissa bits, round to nearest with
    ties away from zero (add half of the dropped 13 bits' range to the
    magnitude's bits, then cut them)."""
    u = np.asarray(a, np.float32).view(np.uint32)
    return ((u + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)


def test_tf32_rounding_is_to_nearest_ties_away():
    half = np.float32(1 + 2 ** -11)        # halfway between two TF32 values
    assert _tf32(half) == np.float32(1 + 2 ** -10)
    assert _tf32(-half) == np.float32(-(1 + 2 ** -10))
    assert _tf32(np.float32(1 + 2 ** -11 - 2 ** -23)) == np.float32(1)
    assert _tf32(np.float32(3.0)) == np.float32(3.0)


def _lm_head_operands(case):
    """Seeded LM-head-like operands of one of the backward's products:
    x ~ N(0, 1) (64, 768), w ~ 0.02 N(0, 1) (768, 256), t = g (softmax -
    onehot) of their logits with g = 1/N."""
    rng = np.random.RandomState(0)
    x = rng.randn(64, 768).astype("float32")
    w = (0.02 * rng.randn(768, 256)).astype("float32")
    logits = x.astype("float64") @ w
    p = np.exp(logits - logits.max(1, keepdims=True))
    p /= p.sum(1, keepdims=True)
    onehot = np.eye(256)[rng.randint(0, 256, 64)]
    t = ((p - onehot) / 64).astype("float32")
    return {"logits x w": (x, w), "dx t wT": (t, np.ascontiguousarray(w.T)),
            "dw xT t": (np.ascontiguousarray(x.T), t)}[case]


@pytest.mark.parametrize("case", ["logits x w", "dx t wT", "dw xT t"])
def test_three_tf32_products_keep_float32_accuracy(case):
    a, b = _lm_head_operands(case)
    ref = a.astype("float64") @ b.astype("float64")
    big_a, big_b = _tf32(a), _tf32(b)
    small_a, small_b = _tf32(a - big_a), _tf32(b - big_b)
    f64 = [m.astype("float64") for m in (big_a, small_a, big_b, small_b)]
    big_a, small_a, big_b, small_b = f64
    three = small_a @ big_b + big_a @ small_b + big_a @ big_b
    one = big_a @ big_b
    scale = np.abs(ref).max()
    # the kernels' order: small*big, big*small, then big*big
    assert np.abs(three - ref).max() <= 1e-6 * scale
    # one TF32 pass keeps ~3 digits: above the 1e-4 float32 gate's reach
    assert np.abs(one - ref).max() > 1e-5 * scale


def test_dx_splits_fill_the_card():
    # the LM head: 128 row blocks x 2 vocab slices = 256 blocks, two
    # rounds on 132 SMs, 64 vocab tiles each
    assert ce.dx_splits(8192, 32768, 132) == 2
    for n, v in ((8192, 50257), (1000, 50257), (130, 4099), (5, 3),
                 (256, 300)):
        s = ce.dx_splits(n, v, 132)
        rows = -(-n // ce.DX_ROWS)
        assert 1 <= s <= -(-v // ce.DX_COLS)
        assert rows * s <= 2 * 132 + rows
    assert ce.dx_splits(1000, 50257, 132) > 1
    assert ce.dx_splits(5, 3, 132) == 1


def test_fwd_splits_fill_the_card():
    # the LM head: 128 row blocks x 2 vocab slices = 256 blocks on 132 SMs
    s = ce.fwd_splits(8192, 32768, 132)
    assert s == 2 and -(-8192 // ce.DX_ROWS) * s >= 132
    for n, v in ((8192, 50257), (1000, 50257), (130, 4099), (77, 300),
                 (5, 3), (256, 300)):
        s = ce.fwd_splits(n, v, 132)
        rows = -(-n // ce.DX_ROWS)
        assert 1 <= s <= -(-v // ce.DX_COLS)
        assert rows * s <= 2 * 132 + rows
    # short rows: one slice per vocab tile, the ragged last one included
    assert ce.fwd_splits(130, 4099, 132) == 17
    assert ce.fwd_splits(1000, 50257, 132) > 1
    assert ce.fwd_splits(5, 3, 132) == 1
    assert ce.fwd_splits(64, 256, 132) == 1


_NEG_INF = np.float32(-np.inf)


def _run_fold(state, s, cols, lab):
    """One thread's fold of its tile columns ``cols`` (scores ``s``, -inf
    past V) into its running (max, sum, label logit) per row."""
    m, l, c = state
    c = c + np.where(cols[None, :] == lab[:, None], s, 0).sum(1)
    mn = np.maximum(m, s.max(1))
    live = mn > _NEG_INF          # a row with no column < V yet: unchanged
    safe = np.where(live, mn, np.float32(0))
    add = np.exp(s - safe[:, None]).sum(1, dtype=np.float32)
    l = np.where(live, l * np.exp(m - safe) + add, l)
    return np.where(live, mn, m), l.astype(np.float32), c


def _run_merge(a, b):
    m = np.maximum(a[0], b[0])
    safe = np.where(m > _NEG_INF, m, np.float32(0))
    la = np.where(a[0] > _NEG_INF, a[1] * np.exp(a[0] - safe), 0)
    lb = np.where(b[0] > _NEG_INF, b[1] * np.exp(b[0] - safe), 0)
    return m, (la + lb).astype(np.float32), a[2] + b[2]


def _forward_model(x, w, b, lab, splits):
    """The forward kernel's arithmetic in numpy float32: each slice s
    walks the 256-column tiles s, s + S, ...; in a tile, warp wn holds 64
    columns and its quad lane t the 16 columns 8 nt + 2 t + (0, 1); each
    lane folds its columns into running states, the quad merges by the
    xor butterfly, the warps merge in order, then the slices' partials
    (and an all-padded one, m = -inf, l = 0) merge in slice order."""
    n = x.shape[0]
    v = w.shape[1]
    tiles = -(-v // ce.DX_COLS)
    logits = (x @ w + b).astype(np.float32)
    lab = np.where((lab >= 0) & (lab < v), lab, -1)
    nt8 = np.arange(8) * 8
    parts = []
    for s in range(splits):
        warps = []
        for wn in range(ce.DX_COLS // 64):
            lanes = []
            for t in range(4):
                st = (np.full(n, _NEG_INF), np.zeros(n, np.float32),
                      np.zeros(n, np.float32))
                for j in range(s, tiles, splits):
                    base = j * ce.DX_COLS + wn * 64 + 2 * t
                    cols = np.sort(np.concatenate([base + nt8,
                                                   base + nt8 + 1]))
                    sc = np.full((n, cols.size), _NEG_INF)
                    ok = cols < v
                    sc[:, ok] = logits[:, cols[ok]]
                    st = _run_fold(st, sc, cols, lab)
                lanes.append(st)
            for off in (1, 2):
                lanes = [_run_merge(lanes[t], lanes[t ^ off])
                         for t in range(4)]
            warps.append(lanes[0])
        part = warps[0]
        for other in warps[1:]:
            part = _run_merge(part, other)
        parts.append(part)
    parts.append((np.full(n, _NEG_INF), np.zeros(n, np.float32),
                  np.zeros(n, np.float32)))
    m = np.max([p[0] for p in parts], axis=0)
    l = np.zeros(n, np.float32)
    c = np.zeros(n, np.float32)
    for pm, pl_, pc in parts:
        safe = np.where(pm > _NEG_INF, pm - m, np.float32(0))
        l = l + np.where(pm > _NEG_INF, pl_ * np.exp(safe), 0)
        c = c + pc
    lse = m + np.log(np.maximum(l, np.float32(1e-30)))
    return (lse - c).astype(np.float32), lse.astype(np.float32)


@pytest.mark.parametrize("splits", [1, 4, 17])
def test_forward_slice_merge_model_matches_pallas(splits):
    rng = np.random.RandomState(11)
    n, d, v = 40, 24, 4099       # 17 vocab tiles, the last with 3 columns
    x = rng.randn(n, d).astype("float32")
    w = (rng.randn(d, v) * 0.3).astype("float32")
    b = (rng.randn(v) * 0.3).astype("float32")
    lab = rng.randint(0, v, (n,)).astype("int32")
    lab[::5] = -1
    lab[2] = v + 1
    lab[3] = v - 1                # the ragged tile's last column
    nll_j, lse_j = fused_linear_ce_partial(
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(b), jnp.asarray(lab),
        block_n=16, block_v=512, interpret=True)
    with np.errstate(invalid="ignore", over="ignore"):
        nll, lse = _forward_model(x, w, b, lab, splits)
    assert np.isfinite(nll).all() and np.isfinite(lse).all()
    np.testing.assert_allclose(lse, np.asarray(lse_j), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(nll, np.asarray(nll_j), rtol=1e-6, atol=1e-6)
