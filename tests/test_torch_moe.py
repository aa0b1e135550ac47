"""The port's mixture of experts against the JAX package's, on the CPU.

``MixtureOfExperts`` at tests/test_moe.py's small size (batch 4, seq 16,
d_model 8, 4 experts, d_ff 16) is built in both packages, the JAX
``init_params`` tree carried into the port, and seeded numpy inputs go
through both.

Tolerances: routing (``src``, ``slots``, ``weights``) is exact — the same
float32 probabilities, the same order of choices and the same integer
slot positions; the aux loss within 1e-6 (float32 means over the tokens
in another order).  ``y`` within 1e-5 in float32 (the expert products
summed in another order) and 2e-2 in bfloat16 (one bfloat16 rounding of
the expert outputs, taken on a product summed in another order);
gradients of every leaf and of x within 1e-4 of the largest magnitude of
each (float32).  Three SGD steps of a small MoE LM: losses within 1e-4
(float32) and 2e-2 (bfloat16) relative, as tests/test_torch_lm_train.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flexflow_tpu.models.gpt import gpt_config as j_gpt_config
from flexflow_tpu.models.gpt import gpt_param_count as j_gpt_param_count
from flexflow_tpu.models.transformer import TransformerConfig as JTConfig
from flexflow_tpu.models.transformer import TransformerLM as JLM
from flexflow_tpu.ops.base import Tensor as JTensor
from flexflow_tpu.ops.moe import MixtureOfExperts as JMoE
from flexflow_tpu.ops.pallas import get_policy, set_policy
from flexflow_tpu.strategy import ParallelConfig as JPC
from flexflow_tpu_torch.apps import lm as t_lm
from flexflow_tpu_torch.interop import params_from_jax
from flexflow_tpu_torch.models.gpt import gpt_config, gpt_param_count
from flexflow_tpu_torch.models.transformer import TransformerConfig as TTConfig
from flexflow_tpu_torch.models.transformer import TransformerLM as TLM
from flexflow_tpu_torch.ops.base import Tensor as TTensor
from flexflow_tpu_torch.ops.moe import (MixtureOfExperts, SlotGather,
                                        _gather_rows, route_dense,
                                        route_indices)
from flexflow_tpu_torch.strategy import ParallelConfig as TPC

torch.set_num_threads(2)

B, S, D, E, F = 4, 16, 8, 4, 16


@pytest.fixture
def pallas_on():
    """The JAX package's kernel policy is process-wide; restore it."""
    before = get_policy()
    yield
    set_policy(before)


def _pair(k=2, cap=4.0, e=E):
    """(JAX op, its params, port op, the same params in the port)."""
    jop = JMoE("moe", JPC((1, 1, 1), (0,)), JTensor((B, S, D)), e, F,
               top_k=k, capacity_factor=cap)
    top = MixtureOfExperts("moe", TPC((1, 1, 1), (0,)), TTensor((B, S, D)),
                           e, F, top_k=k, capacity_factor=cap)
    assert top.capacity == jop.capacity
    jp = jop.init_params(jax.random.PRNGKey(0))
    tp = {k_: torch.from_numpy(np.array(v)) for k_, v in jp.items()}
    return jop, jp, top, tp


def _x(seed=1, shape=(B, S, D)):
    return np.random.RandomState(seed).randn(*shape).astype("float32")


def _probs(jop, jp, x):
    return np.array(jax.nn.softmax(
        jnp.einsum("bsd,de->bse", jnp.asarray(x), jp["wg"]), -1))


# (k, capacity factor): top-2 with room, top-1, and a capacity that drops
ROUTES = [(2, 4.0), (1, 1.0), (2, 0.5)]


@pytest.mark.parametrize("k,cap", ROUTES)
def test_routing_equals_jax_exactly(k, cap):
    jop, jp, top, _ = _pair(k, cap)
    probs = _probs(jop, jp, _x())
    j_src, j_slots, j_w, j_aux = jop._route_indices(jnp.asarray(probs))
    src, src_k, slots, w, aux = route_indices(torch.from_numpy(probs),
                                              top.capacity, k)
    np.testing.assert_array_equal(src.numpy(), np.asarray(j_src))
    np.testing.assert_array_equal(slots.numpy(), np.asarray(j_slots))
    np.testing.assert_array_equal(w.numpy(), np.asarray(j_w))
    assert float(aux) == pytest.approx(float(j_aux), rel=1e-6)
    # src_k inverts slots: every kept choice's slot names it
    kept = slots < E * top.capacity
    if cap < 1.0:
        assert not bool(kept.all())            # this capacity drops
    b_i, s_i, c_i = torch.nonzero(kept, as_tuple=True)
    np.testing.assert_array_equal(
        src_k[b_i, slots[b_i, s_i, c_i]].numpy(), (s_i * k + c_i).numpy())


@pytest.mark.parametrize("k", [1, 2])
def test_ties_route_as_jax(k):
    """Equal probabilities: jax.lax.top_k takes the lower expert first;
    torch.topk would not promise it, the port's stable sort does."""
    rng = np.random.RandomState(5)
    probs = np.full((B, S, E), 1.0 / E, np.float32)         # all tied
    probs[1] = rng.dirichlet(np.ones(E), size=S).astype(np.float32)
    probs[2, :, :2] = 0.4                                    # pairs tied
    probs[2, :, 2:] = 0.1
    probs[3, :, 1:3] = 0.35                                  # middle tie
    probs[3, :, 0] = probs[3, :, 3] = 0.15
    jop = JMoE("moe", JPC((1, 1, 1), (0,)), JTensor((B, S, D)), E, F,
               top_k=k, capacity_factor=1.0)
    j = jop._route_indices(jnp.asarray(probs))
    t = route_indices(torch.from_numpy(probs), jop.capacity, k)
    for got, want in zip((t[0], t[2], t[3]), j[:3]):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("k,cap", ROUTES)
def test_dense_route_matches_index_form(k, cap):
    """The dense GShard form equals JAX's, and the index forward equals
    the dense one-hot computation of the same FFN."""
    jop, jp, top, tp = _pair(k, cap)
    x = _x()
    probs = _probs(jop, jp, x)
    disp, comb, aux = route_dense(torch.from_numpy(probs), top.capacity, k)
    j_disp, j_comb, _ = jop._route(jnp.asarray(probs))
    np.testing.assert_array_equal(disp.numpy(), np.asarray(j_disp))
    np.testing.assert_array_equal(comb.numpy(), np.asarray(j_comb))
    xt = torch.from_numpy(x)
    (y, _), _ = top.forward(tp, {}, [xt], True)
    xin = torch.einsum("bsec,bsd->ebcd", disp, xt)
    h = torch.nn.functional.gelu(
        torch.einsum("ebcd,edf->ebcf", xin, tp["w1"])
        + tp["b1"][:, None, None, :], approximate="tanh")
    yo = torch.einsum("ebcf,efd->ebcd", h, tp["w2"]) \
        + tp["b2"][:, None, None, :]
    y_dense = torch.einsum("bsec,ebcd->bsd", comb, yo)
    torch.testing.assert_close(y, y_dense, rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("dtype,tol", [("float32", 1e-5),
                                       ("bfloat16", 2e-2)])
@pytest.mark.parametrize("k,cap", ROUTES)
def test_forward_matches_jax(k, cap, dtype, tol):
    jop, jp, top, tp = _pair(k, cap)
    x = _x(2)
    jx = jnp.asarray(x).astype(dtype)
    (j_y, j_aux), _ = jop.forward(jp, {}, [jx], True)
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    (y, aux), _ = top.forward(tp, {}, [tx], True)
    assert y.dtype == tx.dtype
    want = np.asarray(j_y.astype("float32"))
    np.testing.assert_allclose(y.float().numpy(), want, rtol=tol, atol=tol)
    assert float(aux) == pytest.approx(float(j_aux), rel=1e-5)


@pytest.mark.parametrize("k,cap", ROUTES)
def test_gradients_match_jax(k, cap):
    """d/d(leaf, x) of sum(y * g) + 0.5 aux, every MoE leaf and x."""
    jop, jp, top, tp = _pair(k, cap)
    x, g = _x(3), _x(4)

    def j_loss(p, xx):
        (y, aux), _ = jop.forward(p, {}, [xx], True)
        return jnp.sum(y * jnp.asarray(g)) + 0.5 * aux

    j_gp, j_gx = jax.grad(j_loss, argnums=(0, 1))(jp, jnp.asarray(x))
    leaves = {k_: v.clone().requires_grad_(True) for k_, v in tp.items()}
    tx = torch.from_numpy(x).requires_grad_(True)
    (y, aux), _ = top.forward(leaves, {}, [tx], True)
    (torch.sum(y * torch.from_numpy(g)) + 0.5 * aux).backward()
    for name, want in list(j_gp.items()) + [("x", j_gx)]:
        got = (tx if name == "x" else leaves[name]).grad.numpy()
        want = np.asarray(want)
        scale = max(float(np.abs(want).max()), 1e-30)
        err = float(np.abs(got - want).max())
        assert err <= 1e-4 * scale, f"{name}: {err:.3e} of {scale:.3e}"
    assert float(leaves["wg"].grad.abs().max()) > 0  # the router trains


def _plain_dispatch_combine(x, yo, src, slots, weights):
    """Dispatch and combine through plain advanced indexing, whose
    backward is autograd's scatter-add."""
    b = x.shape[0]
    bidx = torch.arange(b)[:, None]
    xin = torch.cat([x, x.new_zeros(b, 1, x.shape[2])], 1)[bidx, src]
    yo_pad = torch.cat([yo, yo.new_zeros(b, 1, yo.shape[2])], 1)
    yg = yo_pad[torch.arange(b)[:, None, None], slots]
    return xin, (weights[..., None] * yg).sum(2)


@pytest.mark.parametrize("k,cap", ROUTES)
def test_slot_gather_matches_plain_indexing(k, cap):
    jop, jp, top, tp = _pair(k, cap)
    x = torch.from_numpy(_x(6))
    src, src_k, slots, w, _ = top.route(tp, x)
    yo0 = torch.from_numpy(_x(7, (B, E * top.capacity, D)))
    gx, gy = torch.from_numpy(_x(8, (B, E * top.capacity, D))), \
        torch.from_numpy(_x(9, (B, S, D)))

    def run(plain):
        xx = x.clone().requires_grad_(True)
        yo = yo0.clone().requires_grad_(True)
        if plain:
            xin, y = _plain_dispatch_combine(xx, yo, src, slots, w)
        else:
            xin = SlotGather.apply(xx, src, slots)
            yg = SlotGather.apply(yo, slots.view(B, S * k), src_k[..., None])
            y = (w[..., None] * yg.view(B, S, k, D)).sum(2)
        torch.autograd.backward([xin, y], [gx, gy])
        return xin.detach(), y.detach(), xx.grad, yo.grad

    want = run(True)
    got, again = run(False), run(False)
    for a, b_, c in zip(got, want, again):
        torch.testing.assert_close(a, b_, rtol=1e-6, atol=1e-6)
        assert torch.equal(a, c)                # the same bits twice
    # the forward is the gather itself
    assert torch.equal(got[0], _gather_rows(x, src))


def _lm_pair(machine1, dtype="float32"):
    cfg = dict(batch_size=4, seq_length=16, num_layers=2, d_model=16,
               num_heads=2, d_ff=32, vocab_size=64, causal=True,
               num_experts=4, moe_every=2, moe_top_k=2,
               moe_capacity_factor=1.0, learning_rate=0.1, seed=0,
               compute_dtype=dtype)
    jm = JLM(JTConfig(**cfg, pallas="on"), machine1)
    tm = TLM(TTConfig(**cfg), device="cpu")
    assert [op.name for op in tm.layers] == [op.name for op in jm.layers]
    jp, _ = jm.init(0)
    tp = params_from_jax(jax.tree.map(np.asarray, jp), device="cpu",
                         model=tm)
    return jm, jp, tm, tp


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_moe_lm_three_sgd_steps_match_jax(machine1, pallas_on, dtype):
    jm, jp, tm, tp = _lm_pair(machine1, dtype)
    assert [op.name for op in tm.layers if isinstance(op, MixtureOfExperts)] \
        == ["blk0_moe"]                      # moe_every 2: block 0 only
    toks = np.random.RandomState(10).randint(0, 64, (4, 16)).astype("int32")
    jstep, tstep = jm.make_train_step(), tm.make_train_step()
    jopt, topt, js, ts = None, None, {}, {}
    j_l, t_l = [], []
    for _ in range(3):
        jp, js, jopt, jl = jstep(jp, js, jopt, toks, toks)
        tp, ts, topt, tl = tstep(tp, ts, topt, toks, toks)
        j_l.append(float(jl))
        t_l.append(float(tl))
    tol = 1e-4 if dtype == "float32" else 2e-2
    np.testing.assert_allclose(t_l, j_l, rtol=tol)
    assert t_l[-1] < t_l[0]


def test_moe_lm_eval_loss_excludes_aux(machine1, pallas_on):
    jm, jp, tm, tp = _lm_pair(machine1)
    toks = np.random.RandomState(3).randint(0, 64, (4, 16)).astype("int32")
    tt = torch.from_numpy(toks)
    train, _ = tm.loss_fn(tp, {}, tt, tt, train=True)
    evald, _ = tm.loss_fn(tp, {}, tt, tt, train=False)
    j_train, _ = jm.loss_fn(jp, {}, toks, toks, train=True)
    j_eval, _ = jm.loss_fn(jp, {}, toks, toks, train=False)
    assert float(train) > float(evald)           # aux > 0 always
    assert float(train) == pytest.approx(float(j_train), rel=1e-5)
    assert float(evald) == pytest.approx(float(j_eval), rel=1e-5)
    stats = tm.moe_stats(tp, {}, toks)
    assert float(train) - float(evald) == pytest.approx(
        tm.t.moe_aux_weight * stats["aux"][0], rel=1e-4)
    assert 0.0 <= stats["dropped"][0] < 1.0


@pytest.mark.parametrize("size,overrides", [
    ("0.1b", dict(num_experts=8)),               # the chip smoke's MoE path
    ("0.1b", dict(num_experts=4, moe_every=2)),
    ("0.4b", {}),
])
def test_gpt_param_count_equals_the_ports_leaves(size, overrides):
    """The port's formula counts its leaves; the JAX formula counts 3 d
    per block more (q, k, v biases its attention op does not have)."""
    cfg = gpt_config(size, **overrides)
    model = TLM(cfg, device="cpu")
    counted = sum(int(np.prod(shape)) for leaves in
                  model.param_shapes().values() for shape in leaves.values())
    assert counted == gpt_param_count(cfg)
    assert j_gpt_param_count(j_gpt_config(size, **overrides)) - counted \
        == 3 * cfg.d_model * cfg.num_layers


def test_param_shapes_are_the_init_shapes():
    cfg = TTConfig(batch_size=2, seq_length=8, num_layers=2, d_model=16,
                   num_heads=2, d_ff=32, vocab_size=64, num_experts=4,
                   moe_every=2)
    model = TLM(cfg, device="cpu")
    params, _ = model.init()
    assert model.param_shapes() == {
        key: {leaf: tuple(v.shape) for leaf, v in sub.items()}
        for key, sub in params.items()}
    moe = params["blk0_moe"]
    # glorot over (E, D, F) counts the experts into both fans
    limit = np.sqrt(6.0 / (16 * 4 + 32 * 4))
    assert float(moe["w1"].abs().max()) <= limit
    assert float(moe["w1"].abs().max()) > 0.9 * limit
    with pytest.raises(ValueError, match="does not match the model"):
        params_from_jax({"blk0_moe": {"wg": np.zeros((3, 4), "float32")}},
                        device="cpu", model=model)


def test_moe_flags_are_parsed():
    cfg, device, _ = t_lm.parse_args(
        ["--experts", "8", "--moe-every", "2", "--moe-top-k", "1",
         "--device", "cpu"])
    assert (cfg.num_experts, cfg.moe_every, cfg.moe_top_k, device) == \
        (8, 2, 1, "cpu")
    lines = []
    out = t_lm.main(["--causal", "-b", "2", "-s", "16", "-l", "2",
                     "--d-model", "16", "--heads", "2", "--d-ff", "32",
                     "--vocab", "64", "-i", "2", "--experts", "4",
                     "--device", "cpu"], log=lines.append)
    assert "4 experts/1 blocks" in lines[0]
    assert len(out["loss"]) == 2 and all(np.isfinite(out["loss"]))
