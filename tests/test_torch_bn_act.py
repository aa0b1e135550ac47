"""Kernels 9 and 10 (fused BatchNorm normalize + ReLU) and the port's
BatchNorm against the JAX package's, on the CPU.

The kernels run here as their plain PyTorch versions, through the same
``torch.autograd.Function`` the CUDA kernels sit in; the JAX side is
``bn_act`` with the Pallas kernels in interpret mode, differentiated
with ``jax.vjp``, at the shapes tests/test_pallas.py pins.  BatchNorm is
held against the JAX op as a whole: the output, the running statistics
and the gradient of scale, bias and x through the folded statistics, in
training and eval.  Routed shapes run JAX with ``FLEXFLOW_TPU_BNRELU=1``
(both sides take the fused kernel); a shape the gate refuses runs both
sides through JAX's XLA form.

Tolerances: float32 outputs 1e-6 and gradients 1e-5 (the bounds
tests/test_pallas.py holds the Pallas kernel to: the same float32
arithmetic, sums in another order); bfloat16 2e-2 (one bf16 rounding,
2^-8 relative, of values of order one).  BatchNorm's float32 gradients
1e-4 of their largest magnitude (the statistics' gradient adds terms
that cancel), and its bfloat16 gradients 2e-2 of it.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flexflow_tpu.ops.base import Tensor as JTensor
from flexflow_tpu.ops.norm import BatchNorm as JBatchNorm
from flexflow_tpu.ops.pallas import bn_act as j_bn_act
from flexflow_tpu.strategy import ParallelConfig as JPC
from flexflow_tpu_torch.interop import params_from_jax, state_from_jax
from flexflow_tpu_torch.ops import kernels
from flexflow_tpu_torch.ops.base import Tensor as TTensor
from flexflow_tpu_torch.ops.kernels import bn_act
from flexflow_tpu_torch.ops.norm import BatchNorm as TBatchNorm
from flexflow_tpu_torch.strategy import ParallelConfig as TPC

torch.set_num_threads(2)

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _np(a):
    if isinstance(a, torch.Tensor):
        return a.detach().float().numpy()
    return np.asarray(jnp.asarray(a, jnp.float32))


def _inputs(seed, n, h, w, c):
    rng = np.random.RandomState(seed)
    return [rng.randn(*s).astype("float32")
            for s in ((n, h, w, c), (c,), (c,), (n, h, w, c))]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("relu", [False, True])
@pytest.mark.parametrize("n,h,w,c", [
    (4, 4, 4, 16),    # one channel block on the TPU
    (4, 4, 4, 130),   # ragged C
    (8, 1, 1, 7),     # tiny C
])
def test_plain_kernels_match_pallas(dtype, relu, n, h, w, c):
    jdt, tdt = DTYPES[dtype]
    x, inv, shift, g = _inputs(13, n, h, w, c)
    y_j, vjp = jax.vjp(
        lambda x, i, s: j_bn_act.bn_act(x, i, s, relu=relu, interpret=True),
        jnp.asarray(x, jdt), jnp.asarray(inv), jnp.asarray(shift))
    grads_j = vjp(jnp.asarray(g, jdt))

    kernels.reset_launches()
    ts = [torch.from_numpy(x).to(tdt).requires_grad_(),
          torch.from_numpy(inv).requires_grad_(),
          torch.from_numpy(shift).requires_grad_()]
    y_t = bn_act.bn_act(*ts, relu=relu)
    grads_t = torch.autograd.grad(y_t, ts, torch.from_numpy(g).to(tdt))
    assert sum(kernels.launches.values()) == 0   # CPU: the plain versions
    assert y_t.dtype == tdt and grads_t[0].dtype == tdt
    assert grads_t[1].dtype == grads_t[2].dtype == torch.float32
    if dtype == "float32":
        y_tol, g_tol = dict(rtol=1e-6, atol=1e-6), dict(rtol=1e-5, atol=1e-5)
    else:
        y_tol = g_tol = dict(rtol=2e-2, atol=2e-2)
    np.testing.assert_allclose(_np(y_t), _np(y_j), **y_tol)
    for name, a, b in zip(("dx", "d_inv", "d_shift"), grads_t, grads_j):
        np.testing.assert_allclose(_np(a), _np(b), err_msg=name, **g_tol)


@pytest.mark.parametrize("relu", [False, True])
def test_plain_forward_is_the_unfused_chain(relu):
    """The plain forward rounds as aten's separate float32 mul and add (no
    fused multiply-add), which the CUDA kernel repeats bit for bit."""
    x, inv, shift, _ = _inputs(3, 2, 8, 8, 24)
    xt = torch.from_numpy(x).bfloat16().reshape(-1, 24)
    it, st = torch.from_numpy(inv), torch.from_numpy(shift)
    pre = torch.mul(xt.float(), it).add(st)
    want = (torch.relu(pre) if relu else pre).bfloat16()
    assert torch.equal(bn_act.bn_act_fwd_plain(xt, it, st, relu), want)


def test_plain_backward_masks_with_the_forward_pre_activation():
    x = torch.tensor([[1.0, -1.0, 0.5], [2.0, 0.0, -3.0]])
    inv = torch.tensor([1.0, 2.0, -1.0])
    shift = torch.tensor([-1.0, 0.5, 0.0])
    g = torch.tensor([[1.0, 2.0, 3.0], [4.0, 5.0, 6.0]])
    dx, d_inv, d_shift = bn_act.bn_act_bwd_plain(x, inv, shift, g, True)
    # pre = [[0, -1.5, -0.5], [1, 0.5, 3]]: only pre > 0 passes
    mask = torch.tensor([[0.0, 0.0, 0.0], [1.0, 1.0, 1.0]])
    assert torch.equal(dx, g * mask * inv)
    assert torch.equal(d_inv, (g * mask * x).sum(0))
    assert torch.equal(d_shift, (g * mask).sum(0))


@pytest.mark.parametrize("n,h,w,c", [
    (2, 5, 5, 64),     # M = 50: no power-of-two divisor >= 8
    (8, 4, 4, 64), (1, 1, 1, 3), (1, 2, 4, 1), (3, 3, 3, 5), (64, 7, 7, 992),
    (64, 112, 112, 64), (2, 7, 7, 512), (4, 1, 1, 8), (5, 3, 1, 2),
])
def test_supported_is_the_jax_gate(n, h, w, c):
    assert bn_act.supported(n, h, w, c) == j_bn_act.supported(n, h, w, c)


def test_bn_act_refuses_what_the_gate_refuses():
    x = torch.randn(2, 5, 5, 4)
    with pytest.raises(ValueError, match="gate"):
        bn_act.bn_act(x, torch.ones(4), torch.zeros(4))


def _ops(shape, relu=True):
    jop = JBatchNorm("bn", JPC((1, 1, 1, 1), (0,)), JTensor(shape), relu)
    top = TBatchNorm("bn", TPC((1, 1, 1, 1), (0,)), TTensor(shape), relu)
    return jop, top


def _batchnorm_pair(shape, dtype, train, seed, relu=True):
    """Output, new state and the gradient of sum(y * G) w.r.t. scale,
    bias and x of the JAX op and the port's on the same inputs, from a
    non-trivial params and state tree carried over with
    ``params_from_jax`` / ``state_from_jax``."""
    jdt, tdt = DTYPES[dtype]
    jop, top = _ops(shape, relu)
    rng = np.random.RandomState(seed)
    x = (rng.randn(*shape) * 1.5 + 0.3).astype("float32")
    gy = rng.randn(*shape).astype("float32")
    c = shape[3]
    params = {"scale": (1 + 0.3 * rng.randn(c)).astype("float32"),
              "bias": (0.2 * rng.randn(c)).astype("float32")}
    state = {"mean": (0.1 * rng.randn(c)).astype("float32"),
             "var": (1 + 0.5 * rng.rand(c)).astype("float32")}

    def jf(p, x_):
        y, st = jop.forward(p, {k: jnp.asarray(v) for k, v in state.items()},
                            [x_], train)
        return jnp.sum(y.astype(jnp.float32) * gy), (y, st)

    (_, (y_j, st_j)), g_j = jax.value_and_grad(
        jf, argnums=(0, 1), has_aux=True)(
        {k: jnp.asarray(v) for k, v in params.items()}, jnp.asarray(x, jdt))

    tp = params_from_jax({"bn": params}, device="cpu")["bn"]
    ts = state_from_jax({"bn": state}, device="cpu")["bn"]
    tp = {k: v.requires_grad_() for k, v in tp.items()}
    xt = torch.from_numpy(x).to(tdt).requires_grad_()
    y_t, st_t = top.forward(tp, ts, [xt], train)
    loss = (y_t.float() * torch.from_numpy(gy)).sum()
    g_t = torch.autograd.grad(loss, [tp["scale"], tp["bias"], xt])
    return (y_t, st_t, g_t), (y_j, st_j, (g_j[0]["scale"], g_j[0]["bias"],
                                          g_j[1]))


def _close(got, want, tol, what):
    got, want = _np(got), _np(want)
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max())
    assert err <= tol * scale, f"{what}: max err {err:.3e} > {tol} x " \
                               f"{scale:.3e}"


@pytest.mark.parametrize("train", [True, False])
@pytest.mark.parametrize("dtype,shape", [
    ("float32", (4, 8, 8, 16)),     # routed: M = 256
    ("bfloat16", (4, 8, 8, 16)),
    ("float32", (2, 4, 4, 130)),    # routed, ragged C
    ("bfloat16", (2, 5, 5, 64)),    # refused by the gate: the XLA form
    ("float32", (2, 5, 5, 64)),
])
def test_batchnorm_matches_jax(monkeypatch, dtype, shape, train):
    monkeypatch.setenv("FLEXFLOW_TPU_BNRELU", "1")
    jop, top = _ops(shape)
    routed = bool(top.kernel_route())
    assert routed == jop._use_pallas(jnp.zeros(shape)) == \
        j_bn_act.supported(*shape)
    (y_t, st_t, g_t), (y_j, st_j, g_j) = _batchnorm_pair(shape, dtype,
                                                         train, seed=5)
    assert y_t.dtype == DTYPES[dtype][1] and tuple(y_t.shape) == shape
    tol = 2e-2 if dtype == "bfloat16" else 1e-5
    np.testing.assert_allclose(_np(y_t), _np(y_j), rtol=tol, atol=tol)
    assert sorted(st_t) == sorted(st_j) == ["mean", "var"]
    for k in st_t:
        assert st_t[k].dtype == torch.float32
        np.testing.assert_allclose(_np(st_t[k]), _np(st_j[k]), rtol=1e-5,
                                   atol=1e-6, err_msg=k)
    gtol = 2e-2 if dtype == "bfloat16" else 1e-4
    for name, a, b in zip(("scale", "bias", "x"), g_t, g_j):
        _close(a, b, gtol, name)


def test_batchnorm_eval_returns_the_state_unchanged():
    _, top = _ops((8, 2, 2, 4))
    state = {"mean": torch.full((4,), 0.5), "var": torch.full((4,), 4.0)}
    params = {"scale": torch.ones(4), "bias": torch.zeros(4)}
    x = torch.randn(8, 2, 2, 4)
    y, st = top.forward(params, state, [x], train=False)
    assert st is state
    torch.testing.assert_close(y, torch.relu((x - 0.5) / 2.0), rtol=1e-5,
                               atol=1e-5)


def test_batchnorm_running_stats_use_the_biased_variance():
    _, top = _ops((8, 1, 1, 2), relu=False)
    x = torch.arange(16.0).reshape(8, 1, 1, 2)
    params = {"scale": torch.ones(2), "bias": torch.zeros(2)}
    _, st = top.forward(params, top.init_state("cpu"), [x], train=True)
    xf = x.reshape(8, 2)
    var = ((xf - xf.mean(0)) ** 2).mean(0)
    torch.testing.assert_close(st["var"], 0.9 + 0.1 * var)
    torch.testing.assert_close(st["mean"], 0.1 * xf.mean(0))
    assert not st["mean"].requires_grad and not st["var"].requires_grad


@pytest.mark.parametrize("m,c,vec", [
    (802816, 64, 8), (200704, 256, 8), (12544, 1024, 8), (3136, 992, 8),
    (64, 130, 1), (8, 7, 4), (8, 7, 1), (50, 64, 4), (1, 1, 1),
])
def test_tiling_covers_every_row_and_channel(m, c, vec):
    if c % vec:
        vec = 1
    tx, ty, rows, row_blocks = bn_act.tiling(m, c, vec, sms=132)
    assert 0 < tx <= 32 and 0 < tx * ty <= bn_act.THREADS
    assert rows % ty == 0 and row_blocks == -(-m // rows)
    assert (row_blocks - 1) * rows < m <= row_blocks * rows
    ctiles = -(-(c // vec) // tx)
    assert ctiles * tx * vec >= c and ctiles <= 65535
    # about BLOCKS_PER_SM blocks a multiprocessor, or every row thread
    # walks at least MIN_ROWS rows
    assert row_blocks * ctiles <= bn_act.BLOCKS_PER_SM * 132 + ctiles
    assert rows >= min(m, bn_act.MIN_ROWS * ty) or row_blocks == 1


def test_cpu_tensors_never_count_and_cuda_wrappers_refuse_them():
    kernels.reset_launches()
    x = torch.randn(2, 4, 4, 8, requires_grad=True)
    inv, shift = torch.ones(8, requires_grad=True), torch.zeros(8)
    bn_act.bn_act(x, inv, shift).sum().backward()
    assert sum(kernels.launches.values()) == 0
    assert x.grad.shape == x.shape and inv.grad.shape == (8,)
    x2 = torch.randn(32, 8)
    with pytest.raises(ValueError, match="CUDA device"):
        bn_act.bn_act_fwd_cuda(x2, torch.ones(8), torch.zeros(8), True)
    with pytest.raises(ValueError, match="CUDA device"):
        bn_act.bn_act_bwd_cuda(x2, torch.ones(8), torch.zeros(8), x2, True)
    with pytest.raises(ValueError, match="CUDA device"):
        bn_act.bn_act_bwd_sum_cuda(torch.zeros(3, 8), torch.zeros(3, 8))
    # meta tensors (the dry run) get the outputs' shapes, nothing run;
    # a mix of devices is refused
    y = bn_act.bn_act_fwd(x2.to("meta"), torch.ones(8, device="meta"),
                          torch.zeros(8, device="meta"), True)
    assert (y.device.type, y.shape, y.dtype) == ("meta", x2.shape,
                                                 x2.dtype)
    assert sum(kernels.launches.values()) == 0
    with pytest.raises(ValueError, match="different devices"):
        bn_act.bn_act_fwd(x2.to("meta"), torch.ones(8), torch.zeros(8), True)
    with pytest.raises(ValueError, match="different devices"):
        bn_act.bn_act_bwd(x2, torch.ones(8), torch.zeros(8).to("meta"), x2,
                          True)


def test_library_name_follows_the_source():
    path = kernels.library_path(bn_act.SOURCE)
    assert path.parent == kernels.BUILD_DIR
    assert path.name.startswith("libbn_act_")
