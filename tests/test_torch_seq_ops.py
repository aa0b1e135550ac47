"""The port's sequence ops against the JAX package's, op by op: the same
numpy inputs and params through each JAX op's ``forward`` and its port
counterpart.  float32 throughout, rtol/atol 1e-5 (the same math in
another summation order); the embedding gather is exact."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flexflow_tpu.ops import attention as j_attention
from flexflow_tpu.ops import embed as j_embed
from flexflow_tpu.ops import rnn_linear as j_rnn_linear
from flexflow_tpu.ops import seq_common as j_seq
from flexflow_tpu.ops import softmax_dp as j_softmax
from flexflow_tpu.ops.base import Tensor as JTensor
from flexflow_tpu.strategy import ParallelConfig as JPC
from flexflow_tpu_torch.ops import attention as t_attention
from flexflow_tpu_torch.ops import embed as t_embed
from flexflow_tpu_torch.ops import rnn_linear as t_rnn_linear
from flexflow_tpu_torch.ops import seq_common as t_seq
from flexflow_tpu_torch.ops import softmax_dp as t_softmax
from flexflow_tpu_torch.ops.base import Tensor as TTensor
from flexflow_tpu_torch.strategy import ParallelConfig as TPC

torch.set_num_threads(2)

TOL = dict(rtol=1e-5, atol=1e-5)
B, S, D = 2, 6, 16


def _pcs(ndims):
    return JPC((1,) * ndims, (0,)), TPC((1,) * ndims, (0,))


def _run(j_op, t_op, params, xs):
    """(jax output, port output) as numpy for the same params/inputs."""
    jy, _ = j_op.forward({k: jnp.asarray(v) for k, v in params.items()},
                         {}, [jnp.asarray(x) for x in xs], False)
    ty, _ = t_op.forward({k: torch.from_numpy(v) for k, v in params.items()},
                         {}, [torch.from_numpy(x) for x in xs], False)
    return np.asarray(jy.astype("float32")), ty.float().numpy()


def _x(seed, *shape):
    return np.random.RandomState(seed).randn(*shape).astype("float32")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_embed(dtype):
    jpc, tpc = _pcs(1)
    ids = np.random.RandomState(0).randint(0, 11, (B, S)).astype("int32")
    params = {"table": _x(1, 11, D)}
    j_op = j_embed.Embed("e", jpc, JTensor((B, S), "int32"), 11, D,
                         compute_dtype=dtype)
    t_op = t_embed.Embed("e", tpc, TTensor((B, S), "int32"), 11, D,
                         compute_dtype=dtype)
    jy, ty = _run(j_op, t_op, params, [ids])
    np.testing.assert_array_equal(ty, jy)


def test_layer_norm():
    jpc, tpc = _pcs(2)
    params = {"scale": _x(2, D), "bias": _x(3, D)}
    x = _x(4, B, S, D) * 3.0 + 1.0
    jy, ty = _run(j_seq.LayerNormSeq("ln", jpc, JTensor((B, S, D))),
                  t_seq.LayerNormSeq("ln", tpc, TTensor((B, S, D))),
                  params, [x])
    np.testing.assert_allclose(ty, jy, **TOL)


def test_add_seq():
    jpc, tpc = _pcs(2)
    xs = [_x(5, B, S, D), _x(6, B, S, D)]
    jy, ty = _run(j_seq.AddSeq("a", jpc, [JTensor((B, S, D))] * 2),
                  t_seq.AddSeq("a", tpc, [TTensor((B, S, D))] * 2), {}, xs)
    np.testing.assert_allclose(ty, jy, **TOL)


def test_gelu_is_the_tanh_approximation():
    jpc, tpc = _pcs(2)
    x = _x(7, B, S, D) * 3.0
    jy, ty = _run(j_seq.GeluSeq("g", jpc, JTensor((B, S, D))),
                  t_seq.GeluSeq("g", tpc, TTensor((B, S, D))), {}, [x])
    np.testing.assert_allclose(ty, jy, **TOL)


def test_pos_embed():
    jpc, tpc = _pcs(2)
    params = {"table": _x(8, S, D)}
    jy, ty = _run(j_seq.PosEmbed("p", jpc, JTensor((B, S, D))),
                  t_seq.PosEmbed("p", tpc, TTensor((B, S, D))), params,
                  [_x(9, B, S, D)])
    np.testing.assert_allclose(ty, jy, **TOL)


def test_seq_linear():
    jpc, tpc = _pcs(2)
    params = {"kernel": _x(10, D, 24), "bias": _x(11, 24)}
    jy, ty = _run(j_rnn_linear.RnnLinear("l", jpc, JTensor((B, S, D)), 24),
                  t_rnn_linear.RnnLinear("l", tpc, TTensor((B, S, D)), 24),
                  params, [_x(12, B, S, D)])
    np.testing.assert_allclose(ty, jy, **TOL)


@pytest.mark.parametrize("causal", [False, True])
def test_attention(causal):
    jpc, tpc = _pcs(3)
    params = {w: _x(13 + i, D, D) * 0.3
              for i, w in enumerate(("wq", "wk", "wv", "wo"))}
    params["bo"] = _x(17, D)
    j_op = j_attention.MultiHeadAttention("at", jpc, JTensor((B, S, D)), 4,
                                          causal)
    t_op = t_attention.MultiHeadAttention("at", tpc, TTensor((B, S, D)), 4,
                                          causal)
    jy, ty = _run(j_op, t_op, params, [_x(18, B, S, D)])
    assert ty.shape == (B, S, D)
    np.testing.assert_allclose(ty, jy, **TOL)


def test_log_softmax():
    jpc, tpc = _pcs(1)
    logits = _x(19, B, S, 32) * 4.0
    labels = np.zeros((B, S), "int32")
    jy, ty = _run(
        j_softmax.SoftmaxDP("sm", jpc, JTensor((B, S, 32)),
                            JTensor((B, S), "int32")),
        t_softmax.SoftmaxDP("sm", tpc, TTensor((B, S, 32)),
                            TTensor((B, S), "int32")),
        {}, [logits, labels])
    np.testing.assert_allclose(ty, jy, **TOL)
