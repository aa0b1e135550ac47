"""The port's pool ops against the JAX package's, on the CPU.

Kernel 7 (max-pool backward) and kernel 8 (avg-pool backward) run here as
their plain PyTorch versions, through the same ``torch.autograd.Function``
the CUDA kernels sit in; the JAX side is ``maxpool2d`` / ``avgpool2d``
with the Pallas kernels in interpret mode, differentiated with
``jax.vjp``.  Shapes are the ones tests/test_pallas.py pins.  Inputs are
small integers for the max pools, so every window has ties and the
first-max rule decides where the gradient goes.

Tolerances: the pooled outputs and the max-pool gradients are equal
(the same float32 compares and the same float32 adds in the same order,
cast once); average pools agree to 1e-6 in float32 (a sum in another
order) and to bf16 resolution (2^-7 relative) in bfloat16.  The CUDA
kernels are held against these plain versions on the card by
tests/test_torch_cuda.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flexflow_tpu.ops.base import Tensor as JTensor
from flexflow_tpu.ops.pallas.avgpool import avgpool2d as j_avgpool2d
from flexflow_tpu.ops.pallas.maxpool import maxpool2d as j_maxpool2d
from flexflow_tpu.ops.pool import Pool2D as JPool2D
from flexflow_tpu.strategy import ParallelConfig as JPC
from flexflow_tpu_torch.ops import kernels
from flexflow_tpu_torch.ops.base import Tensor as TTensor
from flexflow_tpu_torch.ops.kernels import avgpool, maxpool
from flexflow_tpu_torch.ops.pool import Pool2D as TPool2D
from flexflow_tpu_torch.strategy import ParallelConfig as TPC

torch.set_num_threads(2)

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _np(a):
    return np.asarray(jnp.asarray(a, jnp.float32))


def _port_vjp(fn, x, g, dtype):
    xt = torch.from_numpy(x).to(dtype).requires_grad_()
    y = fn(xt)
    (dx,) = torch.autograd.grad(y, xt, torch.from_numpy(g).to(dtype))
    return y.detach().float().numpy(), dx.float().numpy()


def _jax_vjp(fn, x, g, dtype):
    y, vjp = jax.vjp(fn, jnp.asarray(x, dtype))
    (dx,) = vjp(jnp.asarray(g, dtype))
    return _np(y), _np(dx)


def _pool_input(rng, shape, dtype, relu):
    """Gaussian input; under bf16 with a fused ReLU, centred at +1 or -1
    by channel, so no window mean rounds across 0 on one side only (the
    ReLU mask then follows the same sign in both packages)."""
    x = rng.randn(*shape).astype("float32")
    if dtype == "bfloat16" and relu:
        sign = np.where(np.arange(shape[3]) % 2, -1.0, 1.0)
        x = (0.3 * x + sign).astype("float32")
    return x


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n,h,w,c,k,p,relu", [
    (2, 9, 9, 3, 3, 0, False),    # odd extents, VALID (Inception pools)
    (2, 16, 16, 5, 3, 0, True),   # even extents + fused relu
    (3, 15, 17, 4, 3, 1, True),   # pad 1, h != w
    (2, 12, 12, 3, 2, 0, False),  # 2x2
    (1, 8, 8, 2, 3, 1, False),    # tiny single-sample
    (2, 23, 19, 6, 3, 0, True),   # ragged H/W
    (2, 13, 13, 8, 3, 0, False),  # ties without relu, odd extent
])
def test_maxpool_matches_pallas(dtype, n, h, w, c, k, p, relu):
    jdt, tdt = DTYPES[dtype]
    rng = np.random.RandomState(0)
    x = rng.randint(-3, 4, size=(n, h, w, c)).astype("float32")
    oh, ow = maxpool.out_dim(h, k, p), maxpool.out_dim(w, k, p)
    g = rng.randn(n, oh, ow, c).astype("float32")
    y_j, dx_j = _jax_vjp(
        lambda x: j_maxpool2d(x, k, k, p, p, relu, interpret=True), x, g, jdt)
    y_t, dx_t = _port_vjp(
        lambda x: maxpool.maxpool2d(x, k, k, p, p, relu), x, g, tdt)
    np.testing.assert_array_equal(y_t, y_j)
    np.testing.assert_array_equal(dx_t, dx_j)


def test_maxpool_sel_marks_first_max_and_relu_sentinel():
    x = torch.tensor([[0., 2., 2.], [2., -1., 0.], [1., 2., 3.]])
    y, sel = maxpool.maxpool_fwd_plain(x.reshape(1, 3, 3, 1), 3, 0, False)
    assert float(y) == 3.0 and int(sel) == 8
    x[2, 2] = -5.0   # max 2 first reached at rank 1
    y, sel = maxpool.maxpool_fwd_plain(x.reshape(1, 3, 3, 1), 3, 0, True)
    assert float(y) == 2.0 and int(sel) == 1
    neg = -torch.ones(1, 3, 3, 1)
    y, sel = maxpool.maxpool_fwd_plain(neg, 3, 0, True)
    assert float(y) == 0.0 and int(sel) == maxpool.SENTINEL
    # pad 1: the -inf fill never wins
    y, sel = maxpool.maxpool_fwd_plain(neg, 3, 1, False)
    assert bool((y == -1).all()) and int(sel[0, 0, 0, 0]) == 4


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("relu", [False, True])
@pytest.mark.parametrize("n,h,w,c,kh,kw,sh,sw", [
    (2, 8, 8, 16, 8, 8, 1, 1),    # global pool, stride 1 (Inception tail)
    (4, 8, 8, 3, 2, 2, 2, 2),     # 2x2 exact tiling
    (2, 12, 9, 24, 3, 3, 3, 3),   # 3x3 tiling, h != w
])
def test_avgpool_matches_pallas(dtype, relu, n, h, w, c, kh, kw, sh, sw):
    jdt, tdt = DTYPES[dtype]
    rng = np.random.RandomState(11)
    x = _pool_input(rng, (n, h, w, c), dtype, relu)
    g = rng.randn(n, h // kh, w // kw, c).astype("float32")
    y_j, dx_j = _jax_vjp(
        lambda x: j_avgpool2d(x, kh, kw, sh, sw, 0, 0, relu, interpret=True),
        x, g, jdt)
    y_t, dx_t = _port_vjp(
        lambda x: avgpool.avgpool2d(x, kh, kw, sh, sw, 0, 0, relu), x, g,
        tdt)
    tol = dict(rtol=1e-6, atol=1e-6) if dtype == "float32" \
        else dict(rtol=2 ** -7, atol=2 ** -7)
    np.testing.assert_allclose(y_t, y_j, **tol)
    np.testing.assert_allclose(dx_t, dx_j, **tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("pool_type,k,s,p,relu", [
    ("avg", 3, 1, 1, True),    # Inception's in-block pools (count of valid)
    ("avg", 3, 1, 1, False),
    ("max", 3, 1, 1, True),    # a max geometry outside the kernel's gate
    ("avg", 3, 2, 0, False),   # overlapping windows, no kernel
])
def test_pool_op_plain_routes_match_jax(dtype, pool_type, k, s, p, relu):
    jdt, tdt = DTYPES[dtype]
    rng = np.random.RandomState(3)
    shape = (2, 9, 7, 5)
    x = _pool_input(rng, shape, dtype, relu)
    jop = JPool2D("p", JPC((1, 1, 1, 1), (0,)), JTensor(shape), k, k, s, s,
                  p, p, pool_type, relu)
    top = TPool2D("p", TPC((1, 1, 1, 1), (0,)), TTensor(shape), k, k, s, s,
                  p, p, pool_type, relu)
    assert not jop._use_pallas(None) and top.kernel_route() == ""
    g = rng.randn(*jop.output.shape).astype("float32")
    y_j, dx_j = _jax_vjp(lambda x: jop.forward({}, {}, [x], True)[0], x, g,
                         jdt)
    y_t, dx_t = _port_vjp(lambda x: top.forward({}, {}, [x], True)[0], x, g,
                          tdt)
    assert y_t.shape == tuple(top.output.shape)
    tol = dict(rtol=1e-5, atol=1e-6) if dtype == "float32" \
        else dict(rtol=2e-2, atol=2e-2)
    np.testing.assert_allclose(y_t, y_j, **tol)
    np.testing.assert_allclose(dx_t, dx_j, **tol)


@pytest.mark.parametrize("pool_type,k,s,p,hw,route", [
    ("max", 3, 2, 0, 9, "maxpool"),
    ("max", 3, 2, 1, 9, "maxpool"),
    ("max", 2, 2, 0, 8, "maxpool"),
    ("max", 2, 2, 1, 8, ""),        # 2x2 pad 1 stays plain, as in JAX
    ("avg", 8, 1, 0, 8, "avgpool"),  # the global pool, any stride
    ("avg", 2, 2, 0, 8, "avgpool"),
    ("avg", 3, 3, 0, 8, ""),        # remainder rows
    ("avg", 3, 1, 1, 8, ""),
])
def test_pool_op_routes_as_the_jax_gates(monkeypatch, pool_type, k, s, p,
                                         hw, route):
    monkeypatch.setenv("FLEXFLOW_TPU_MAXPOOL", "1")
    monkeypatch.setenv("FLEXFLOW_TPU_AVGPOOL", "1")
    shape = (2, hw, hw, 4)
    jop = JPool2D("p", JPC((1, 1, 1, 1), (0,)), JTensor(shape), k, k, s, s,
                  p, p, pool_type)
    top = TPool2D("p", TPC((1, 1, 1, 1), (0,)), TTensor(shape), k, k, s, s,
                  p, p, pool_type)
    assert top.kernel_route() == route
    assert jop._use_pallas(None) == bool(route)
    assert top.output.shape == jop.output.shape


def test_cpu_tensors_take_the_plain_versions_and_never_count():
    kernels.reset_launches()
    x = torch.randn(2, 9, 9, 4, requires_grad=True)
    maxpool.maxpool2d(x, 3, 3, 0, 0, True).sum().backward()
    a = torch.randn(2, 4, 4, 4, requires_grad=True)
    avgpool.avgpool2d(a, 4, 4, 1, 1, 0, 0, True).sum().backward()
    assert sum(kernels.launches.values()) == 0
    assert x.grad.shape == x.shape and a.grad.shape == a.shape


def test_cuda_wrappers_refuse_what_they_do_not_take():
    x = torch.randn(1, 9, 9, 2)
    with pytest.raises(ValueError, match="CUDA device"):
        maxpool.maxpool_fwd_cuda(x, 3, 0, False)
    with pytest.raises(ValueError, match="CUDA device"):
        maxpool.maxpool_bwd_cuda(torch.randn(1, 4, 4, 2),
                                 torch.zeros(1, 4, 4, 2, dtype=torch.uint8),
                                 9, 9, 3, 0)
    with pytest.raises(ValueError, match="CUDA device"):
        avgpool.avgpool_bwd_cuda(torch.randn(1, 1, 1, 2), None, 9, 9)
    # a meta tensor (the dry run) gets the outputs' shapes, nothing run
    y, sel = maxpool.maxpool_fwd(x.to("meta"), 3, 0, False)
    y_p, sel_p = maxpool.maxpool_fwd_plain(x, 3, 0, False)
    assert [(t.device.type, t.shape, t.dtype) for t in (y, sel)] == \
        [("meta", t.shape, t.dtype) for t in (y_p, sel_p)]
    with pytest.raises(ValueError, match="different devices"):
        maxpool.maxpool_bwd(y, sel_p, 9, 9, 3, 0)
    with pytest.raises(ValueError, match="geometry"):
        maxpool.maxpool2d(x, 3, 3, 2, 2)
    with pytest.raises(ValueError, match="tile"):
        avgpool.avgpool2d(x, 2, 2, 2, 2, 0, 0)


def test_library_names_follow_sources():
    for src in (maxpool.SOURCE, avgpool.SOURCE):
        path = kernels.library_path(src)
        assert path.parent == kernels.BUILD_DIR
        assert path.name.startswith("lib" + src[:-3] + "_")
