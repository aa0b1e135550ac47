"""The mixture of experts over several ranks: the MoE op on (e, c, n)
grids and the MoE LM under expert-parallel strategies, on 8 gloo ranks,
against the JAX package on its 8-device virtual CPU mesh.

* The op alone (tests/test_moe.py's widths at batch 8: seq 16, d_model
  8, 4 experts, d_ff 16, top-2, capacity factor 1.0, which drops) under
  (2, 1, 1), (1, 2, 1), (4, 1, 2), (2, 2, 2) and (1, 4, 2), from the JAX
  op's params and seeded numpy x and cotangent g: each rank's routing of
  its rows equals JAX's routing of those rows exactly; y and the aux loss
  within 1e-6; the gradients of sum(y * g) + 0.5 aux in x and in each
  leaf block (the router ``wg`` included, summed over its holders as a
  step sums it) within 1e-5 of the leaf's largest magnitude.
* The MoE LM (tests/test_moe.py's ``_moe_lm`` widths at lr 0.1) under
  ``test_moe_ep_strategy_invariance``'s EP x DP (4, 1, 2) and EP x TP x
  DP (2, 2, 2) / TP x DP (1, 4, 2) strategies, and at 12 layers under
  ``examples/strategies/moe_2x4_measured.json``'s per-op entries with
  its ``__pipeline__`` block dropped: 3 SGD steps from JAX's init tree,
  losses within rtol 2e-4 / atol 2e-5 of JAX's run of the same strategy
  and of the port's run in one process, every final leaf within 1e-4 of
  its own largest magnitude, each MoE leaf block on the ranks its grid
  names.

One spawn of 8 processes (``tests/torch_ranks.py``) runs every case.
"""

import json
import math
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_ranks as tr
from flexflow_tpu.machine import MachineModel as JMachine
from flexflow_tpu.ops.base import Tensor as JTensor
from flexflow_tpu.ops.moe import MixtureOfExperts as JMoE
from flexflow_tpu.strategy import ParallelConfig as JPC

torch.set_num_threads(2)

STRATEGIES = Path(__file__).resolve().parents[1] / "examples" / "strategies"

B, S, D, E, F, K, CAP = 8, 16, 8, 4, 16, 2, 1.0
GRIDS = [(2, 1, 1), (1, 2, 1), (4, 1, 2), (2, 2, 2), (1, 4, 2)]

LM = dict(batch_size=8, seq_length=16, num_layers=2, d_model=32,
          num_heads=4, d_ff=64, vocab_size=64, causal=True, num_experts=4,
          moe_top_k=2, moe_capacity_factor=4.0, learning_rate=0.1, seed=11)
LM_CASES = {
    "ep": {"blk0_moe": (4, 1, 2), "blk1_moe": (4, 1, 2)},
    "hybrid": {"blk0_moe": (2, 2, 2), "blk1_moe": (1, 4, 2)},
}


def _measured_text():
    """``moe_2x4_measured.json``'s per-op entries, its __pipeline__ block
    dropped."""
    obj = json.loads((STRATEGIES / "moe_2x4_measured.json").read_text())
    obj.pop("__pipeline__")
    return json.dumps(obj)


def _jax_op(dims, jp, x, g):
    """JAX's op under ``dims`` on the 8-device mesh: (routing of x, y,
    aux, gradients of sum(y * g) + 0.5 aux in the params and x)."""
    op = JMoE("moe", JPC(dims, tuple(range(math.prod(dims)))),
              JTensor((B, S, D)), E, F, top_k=K, capacity_factor=CAP,
              machine=JMachine())

    def loss(p, xx):
        (y, aux), _ = op.forward(p, {}, [xx], True)
        return jnp.sum(y * jnp.asarray(g)) + 0.5 * aux, (y, aux)

    (_, (y, aux)), (gp, gx) = jax.jit(jax.value_and_grad(
        loss, argnums=(0, 1), has_aux=True))(jp, jnp.asarray(x))
    probs = jax.nn.softmax(jnp.einsum("bsd,de->bse", jnp.asarray(x),
                                      jp["wg"]), -1)
    src, slots, _, _ = op._route_indices(probs)
    return (np.asarray(src), np.asarray(slots), np.asarray(y), float(aux),
            jax.tree.map(np.asarray, gp), np.asarray(gx))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("moe_ep")
    jop = JMoE("moe", JPC((1, 1, 1), (0,)), JTensor((B, S, D)), E, F,
               top_k=K, capacity_factor=CAP)
    jp = jop.init_params(jax.random.PRNGKey(0))
    rng = np.random.RandomState(1)
    x = rng.randn(B, S, D).astype("float32")
    g = rng.randn(B, S, D).astype("float32")
    op_path = str(tmp / "op.npz")
    np.savez(op_path, x=x, g=g,
             **{f"p/{k}": np.asarray(v) for k, v in jp.items()})
    want_op = {dims: _jax_op(dims, jp, x, g) for dims in GRIDS}
    batches = [np.random.RandomState(21 + i).randint(0, 64, (8, 16))
               .astype("int32") for i in range(3)]
    lm = {}
    cases = [("moe_op", (dims, op_path, K, CAP)) for dims in GRIDS]
    for name, cfg, text in (
            [(n, LM, tr.strategy_json(grids, 8))
             for n, grids in LM_CASES.items()]
            + [("measured", dict(LM, num_layers=12), _measured_text())]):
        full, losses, final = tr.jax_lm(cfg, text, jax.devices()[:8],
                                        batches)
        path = str(tmp / f"{name}.npz")
        tr.save_trees(path, full, {})
        lm[name] = (cfg, text, (losses, final, path))
        cases.append(("lm_train", (cfg, text, path, batches)))
    res = tr.run_ranks(tr.run_cases, 8, cases, timeout=420)
    n = len(GRIDS)
    ops = {dims: [r[i] for r in res] for i, dims in enumerate(GRIDS)}
    lms = {name: [r[n + i] for r in res] for i, name in enumerate(lm)}
    return want_op, ops, lm, lms, batches


@pytest.mark.parametrize("dims", GRIDS)
def test_moe_op_grid_matches_jax(runs, dims):
    want_op, ops, _, _, _ = runs
    j_src, j_slots, j_y, j_aux, j_gp, j_gx = want_op[dims]
    got_gx = np.full_like(j_gx, np.nan)
    for (lo, hi), slots, src, y, aux, grads, (xlo, xhi), gx in ops[dims]:
        np.testing.assert_array_equal(slots, j_slots[lo:hi])
        np.testing.assert_array_equal(src, j_src[lo:hi])
        np.testing.assert_allclose(y, j_y[lo:hi], rtol=1e-6, atol=1e-6)
        assert aux == pytest.approx(j_aux, rel=1e-6, abs=1e-6)
        for leaf, (box, block) in grads.items():
            want = j_gp[leaf]
            sl = tuple(slice(a, b) for a, b in box)
            scale = float(np.abs(want).max())
            err = float(np.abs(block - want[sl]).max())
            assert err <= 1e-5 * scale, f"{dims} {leaf}: {err:.3e}"
        got_gx[xlo:xhi] = gx
    err = float(np.abs(got_gx - j_gx).max())
    assert err <= 1e-5 * float(np.abs(j_gx).max()), f"{dims} x: {err:.3e}"
    # the capacity drops some choices, so the routing is not trivial
    assert (j_slots == E * math.ceil(CAP * K * S / E)).any()


def _leaf_close(params, want):
    """Every leaf within 1e-4 of its own largest magnitude."""
    for key, leaves in want.items():
        for leaf, w in leaves.items():
            scale = float(np.abs(w).max()) or 1.0
            err = float(np.abs(params[key][leaf] - w).max())
            assert err <= tr.LEAF_RTOL * scale, \
                f"{key}.{leaf}: max err {err:.3e} > 1e-4 x {scale:.3e}"


@pytest.mark.parametrize("name", ["ep", "hybrid", "measured"])
def test_moe_lm_under_expert_grids_matches_jax(runs, name):
    _, _, lm, lms, batches = runs
    cfg, text, want = lm[name]
    per_rank = lms[name]
    losses = tr.check_lm(want, per_rank, cfg, batches)
    assert abs(losses[-1] - losses[0]) > 1e-3
    shapes = {k: {leaf: v.shape for leaf, v in d.items()}
              for k, d in want[1].items()}
    _leaf_close(tr.assemble(shapes, [r[1] for r in per_rank]), want[1])


@pytest.mark.parametrize("name", ["ep", "hybrid", "measured"])
def test_moe_lm_residency(runs, name):
    """Each rank holds its expert block of w1, w2, b1, b2 and its channel
    block of w1, b1, w2 (rows), the router whole."""
    from flexflow_tpu_torch.strategy import Strategy

    _, _, lm, lms, _ = runs
    cfg, text, _ = lm[name]
    strategies = Strategy.from_json(text)
    e, f = cfg["num_experts"], cfg["d_ff"]
    for op in (f"blk{i}_moe" for i in range(cfg["num_layers"])):
        pe, pc, _ = strategies[op].dims
        blocks = {r[1][op]["w1"][0] for r in lms[name]}
        assert blocks == {((i * e // pe, (i + 1) * e // pe), (0, 32),
                           (j * f // pc, (j + 1) * f // pc))
                          for i in range(pe) for j in range(pc)}, op
        assert {r[1][op]["wg"][0] for r in lms[name]} == \
            {((0, 32), (0, e))}
