"""``ring_attention`` over gloo ranks against the JAX package's
``ring_attention`` on its virtual CPU mesh.

Seeded q, k, v (2, 4, 32, 8) split over 4 CPU ranks: the sequence over
2 of them (the fast axis, the batch over the other) or over all 4, causal
and not, through both rotation transports (point-to-point and the
all-gather gloo uses for CUDA tensors).  Each rank's output block and
the gradients of a weighted sum of it are held against JAX's ring
(values within 1e-5, dq within 1e-4, as
``tests/test_transformer.py:36-53``) and against the dense attention's
dk and dv (the ring's k and v gradients arrive home by the reverse
rotations).  All cases share one spawn of 4 processes
(``tests/torch_ranks.py``); JAX's reference is compiled once per split
and mask.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_ranks as tr

torch.set_num_threads(2)

RING_SHAPE = (2, 4, 32, 8)


def _dense(q, k, v, causal):
    s = jnp.einsum("bhqd,bhkd->bhqk", q, k) / np.sqrt(q.shape[-1])
    if causal:
        n = q.shape[2]
        s = jnp.where(jnp.tril(jnp.ones((n, n))) == 1, s, -jnp.inf)
    return jnp.einsum("bhqk,bhkd->bhqd", jax.nn.softmax(s, axis=-1), v)


RING_CASES = [(s_axes, causal, transport)
              for s_axes in (("_g1",), ("_g0", "_g1"))
              for causal in (False, True)
              for transport in ("p2p", "gather")]


@pytest.fixture(scope="module")
def ring_runs():
    cases = [("ring_case", (RING_SHAPE, s_axes, causal, transport))
             for s_axes, causal, transport in RING_CASES]
    return tr.run_ranks(tr.run_cases, 4, cases, timeout=120)


@functools.lru_cache(maxsize=None)
def _jax_ring(parts, causal):
    """JAX's ring over ``parts`` sequence chunks: (o, dq) of the weighted
    sum, in one compiled program, and the dense attention's dk, dv."""
    from jax.sharding import Mesh

    from flexflow_tpu.parallel.ring_attention import ring_attention

    rng = np.random.RandomState(1)
    q, k, v = (jnp.asarray(rng.randn(*RING_SHAPE), jnp.float32)
               for _ in range(3))
    weight = jnp.asarray(rng.randn(*RING_SHAPE), jnp.float32)
    mesh = Mesh(np.array(jax.devices()[:4]).reshape(4 // parts, parts),
                ("n", "s"))

    def loss(q):
        o = ring_attention(q, k, v, mesh, "s", causal)
        return (o * weight).sum(), o

    (_, o), dq = jax.jit(jax.value_and_grad(loss, has_aux=True))(q)
    _, dk, dv = jax.grad(lambda q, k, v: (_dense(q, k, v, causal)
                                          * weight).sum(),
                         argnums=(0, 1, 2))(q, k, v)
    return tuple(np.asarray(a) for a in (o, dq, dk, dv))


@pytest.mark.parametrize("case", RING_CASES,
                         ids=[f"s{len(a) * 2}-{'causal' if c else 'full'}-{t}"
                              for a, c, t in RING_CASES])
def test_ring_attention_matches_jax(ring_runs, case):
    s_axes, causal, _ = case
    i = RING_CASES.index(case)
    want, dq, dk, dv = _jax_ring(2 ** len(s_axes), causal)
    for box, o, grads in (r[i] for r in ring_runs):
        sl = tuple(slice(lo, hi) for lo, hi in box)
        np.testing.assert_allclose(o, want[sl], rtol=1e-5, atol=1e-5)
        for got, ref in zip(grads, (dq, dk, dv)):
            np.testing.assert_allclose(got, ref[sl], rtol=1e-4, atol=1e-5)
