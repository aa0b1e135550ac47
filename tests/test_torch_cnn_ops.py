"""The port's CNN ops against the JAX package's, on the CPU: conv (strided,
asymmetric 1x7 / 7x1 padding, with and without ReLU), concat, flat,
linear and the softmax loss.  Each pair gets the JAX op's own
``init_params`` tree through ``params_from_jax`` and the same numpy
input; the forward values and the gradients with respect to the input
and every parameter are compared.

Tolerances: float32 at rtol 1e-5 / atol 1e-5 (the same products summed
in another order); bfloat16 compute at 2e-2 (one bf16 rounding of the
output, 2^-8 relative, on values of order one, plus the other order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flexflow_tpu.ops.base import Tensor as JTensor
from flexflow_tpu.ops.concat import Concat as JConcat
from flexflow_tpu.ops.conv import Conv2D as JConv2D
from flexflow_tpu.ops.flat import Flat as JFlat
from flexflow_tpu.ops.linear import Linear as JLinear
from flexflow_tpu.ops.softmax import Softmax as JSoftmax
from flexflow_tpu.strategy import ParallelConfig as JPC
from flexflow_tpu_torch.interop import params_from_jax
from flexflow_tpu_torch.ops.base import Tensor as TTensor
from flexflow_tpu_torch.ops.concat import Concat as TConcat
from flexflow_tpu_torch.ops.conv import Conv2D as TConv2D
from flexflow_tpu_torch.ops.flat import Flat as TFlat
from flexflow_tpu_torch.ops.linear import Linear as TLinear
from flexflow_tpu_torch.ops.softmax import Softmax as TSoftmax
from flexflow_tpu_torch.strategy import ParallelConfig as TPC

torch.set_num_threads(2)

TOL = {"float32": dict(rtol=1e-5, atol=1e-5),
       "bfloat16": dict(rtol=2e-2, atol=2e-2)}
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _pc(n):
    return JPC((1,) * n, (0,)), TPC((1,) * n, (0,))


def _f32(a):
    return np.asarray(jnp.asarray(a, jnp.float32)) if not isinstance(
        a, torch.Tensor) else a.detach().float().numpy()


def _compare(jop, top, xs, dtype, seed=0):
    """Forward and VJP of both ops on the same inputs and params."""
    jdt, tdt = DTYPES[dtype]
    jp = jop.init_params(jax.random.PRNGKey(seed))
    tree = {k: np.asarray(v) for k, v in jp.items()}
    tp = params_from_jax({"op": tree}, device="cpu")["op"] if tree else {}
    jxs = [jnp.asarray(x, jdt) for x in xs]

    def jf(p, xs_):
        return jop.forward(p, {}, list(xs_), True)[0]

    y_j, vjp = jax.vjp(jf, jp, jxs)
    g = np.random.RandomState(seed + 1).randn(*y_j.shape).astype("float32")
    gp_j, gx_j = vjp(jnp.asarray(g, y_j.dtype))

    txs = [torch.from_numpy(x).to(tdt).requires_grad_() for x in xs]
    tleaves = {k: v.requires_grad_() for k, v in tp.items()}
    y_t = top.forward(tleaves, {}, txs, True)[0]
    assert tuple(y_t.shape) == tuple(top.output.shape) == tuple(y_j.shape)
    assert str(y_t.dtype).split(".")[1] == str(y_j.dtype)
    grads = torch.autograd.grad(
        y_t, txs + list(tleaves.values()),
        torch.from_numpy(g).to(y_t.dtype))
    tol = TOL[dtype]
    np.testing.assert_allclose(_f32(y_t), _f32(y_j), **tol)
    for a, b in zip(grads[:len(xs)], gx_j):
        np.testing.assert_allclose(_f32(a), _f32(b), **tol)
    for (k, _), a in zip(tleaves.items(), grads[len(xs):]):
        scale = max(1.0, float(np.abs(_f32(gp_j[k])).max()))
        np.testing.assert_allclose(_f32(a) / scale, _f32(gp_j[k]) / scale,
                                   **tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape,cout,k,s,p,relu", [
    ((2, 11, 11, 3), 8, (3, 3), (2, 2), (0, 0), True),   # strided stem
    ((2, 9, 9, 6), 5, (1, 7), (1, 1), (0, 3), True),     # 1x7 pad (0, 3)
    ((2, 9, 9, 6), 5, (7, 1), (1, 1), (3, 0), True),     # 7x1 pad (3, 0)
    ((2, 15, 15, 3), 4, (11, 11), (4, 4), (2, 2), False),  # AlexNet conv1
    ((2, 7, 7, 4), 6, (5, 5), (1, 1), (2, 2), False),
])
def test_conv_matches_jax(dtype, shape, cout, k, s, p, relu):
    jpc, tpc = _pc(4)
    args = (cout, k[0], k[1], s[0], s[1], p[0], p[1], relu)
    jop = JConv2D("conv", jpc, JTensor(shape), *args)
    top = TConv2D("conv", tpc, TTensor(shape), *args)
    x = np.random.RandomState(2).randn(*shape).astype("float32")
    _compare(jop, top, [x], dtype)


def test_conv_init_matches_jax_shapes_and_range():
    jpc, tpc = _pc(4)
    jop = JConv2D("c", jpc, JTensor((1, 9, 9, 6)), 5, 1, 7, 1, 1, 0, 3)
    top = TConv2D("c", tpc, TTensor((1, 9, 9, 6)), 5, 1, 7, 1, 1, 0, 3)
    gen = torch.Generator().manual_seed(0)
    tp = top.init_params(gen, "cpu")
    jp = jop.init_params(jax.random.PRNGKey(0))
    limit = np.sqrt(6.0 / (1 * 7 * 6 + 5))
    for k in ("kernel", "bias"):
        assert tuple(tp[k].shape) == jp[k].shape
        assert tp[k].dtype == torch.float32
        assert float(tp[k].abs().max()) <= limit
    assert float(tp["kernel"].abs().max()) > 0.8 * limit
    assert float(np.abs(np.asarray(jp["kernel"])).max()) <= limit


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_concat_matches_jax(dtype):
    jpc, tpc = _pc(4)
    shapes = [(2, 5, 4, 3), (2, 5, 4, 1), (2, 5, 4, 6)]
    jop = JConcat("cat", jpc, [JTensor(s) for s in shapes])
    top = TConcat("cat", tpc, [TTensor(s) for s in shapes])
    rng = np.random.RandomState(4)
    _compare(jop, top, [rng.randn(*s).astype("float32") for s in shapes],
             dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flat_keeps_nhwc_order(dtype):
    jpc, tpc = _pc(2)
    shape = (2, 6, 6, 4)
    jop = JFlat("flat", jpc, JTensor(shape))
    top = TFlat("flat", tpc, TTensor(shape))
    x = np.random.RandomState(5).randn(*shape).astype("float32")
    _compare(jop, top, [x], dtype)
    y = top.forward({}, {}, [torch.from_numpy(x)], False)[0]
    np.testing.assert_array_equal(y.numpy(), x.reshape(2, -1))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("relu", [True, False])
def test_linear_matches_jax(dtype, relu):
    jpc, tpc = _pc(2)
    jop = JLinear("fc", jpc, JTensor((4, 24)), 10, relu)
    top = TLinear("fc", tpc, TTensor((4, 24)), 10, relu)
    x = np.random.RandomState(6).randn(4, 24).astype("float32")
    _compare(jop, top, [x], dtype)


def test_flat_then_linear_pairs_features_like_jax():
    # AlexNet's 6x6x256 tail in miniature: an NCHW flatten would pair the
    # kernel rows with the wrong features
    jpc2, tpc2 = _pc(2)
    shape = (2, 3, 3, 4)
    jflat = JFlat("flat", jpc2, JTensor(shape))
    tflat = TFlat("flat", tpc2, TTensor(shape))
    jfc = JLinear("fc", jpc2, jflat.output, 5, False)
    tfc = TLinear("fc", tpc2, tflat.output, 5, False)
    jp = jfc.init_params(jax.random.PRNGKey(3))
    tp = params_from_jax({"fc": {k: np.asarray(v) for k, v in jp.items()}},
                         device="cpu")["fc"]
    x = np.random.RandomState(7).randn(*shape).astype("float32")
    y_j = jfc.forward(jp, {}, [jflat.forward({}, {}, [jnp.asarray(x)],
                                             False)[0]], False)[0]
    y_t = tfc.forward(tp, {}, [tflat.forward({}, {}, [torch.from_numpy(x)],
                                             False)[0]], False)[0]
    np.testing.assert_allclose(y_t.numpy(), np.asarray(y_j), rtol=1e-5,
                               atol=1e-5)
    wrong = torch.from_numpy(x).permute(0, 3, 1, 2).reshape(2, -1)
    y_w = tfc.forward(tp, {}, [wrong], False)[0]
    assert not np.allclose(y_w.numpy(), np.asarray(y_j), atol=1e-3)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_softmax_loss_matches_jax(dtype):
    jdt, tdt = DTYPES[dtype]
    jpc, tpc = _pc(1)
    jop = JSoftmax("softmax", jpc, JTensor((6, 9)))
    top = TSoftmax("softmax", tpc, TTensor((6, 9)))
    rng = np.random.RandomState(8)
    x = rng.randn(6, 9).astype("float32")
    labels = rng.randint(0, 9, size=6).astype("int32")

    def jl(x):
        return jop.loss(jop.forward({}, {}, [x], True)[0],
                        jnp.asarray(labels))

    loss_j, gx_j = jax.value_and_grad(jl)(jnp.asarray(x, jdt))
    xt = torch.from_numpy(x).to(tdt).requires_grad_()
    lp = top.forward({}, {}, [xt], True)[0]
    assert lp.dtype == torch.float32
    loss_t = top.loss(lp, torch.from_numpy(labels))
    (gx_t,) = torch.autograd.grad(loss_t, xt)
    tol = TOL[dtype]
    np.testing.assert_allclose(float(loss_t.detach()), float(loss_j), **tol)
    np.testing.assert_allclose(_f32(gx_t), _f32(gx_j), **tol)
