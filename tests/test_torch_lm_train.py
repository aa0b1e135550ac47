"""The port's LM training slice against the JAX package's, on the CPU.

A GPT-style causal LM at tests/test_pallas.py's fusion-test config (batch
8, seq 256, 1 layer, d_model 16, 4 heads, d_ff 32, vocab 64) is built in
both packages on one device, the JAX ``init()`` tree carried into the
port with ``params_from_jax``.  The JAX side runs with ``pallas="on"``:
its attention goes through the flash kernels and its vocab head through
the fused projection + cross-entropy kernels (its fusion gate holds at
b*s = 2048 tokens), both in interpret mode; the port's through the same
autograd functions that launch kernels 1-6 on a GPU.  Three plain-SGD
steps (lr 0.1, so the updates move the loss) on one seeded token batch.

Tolerances: float32 losses within 1e-4 relative and every final
parameter leaf within 1e-4 of the largest magnitude among its op's
leaves (the same arithmetic summed in another order); bfloat16 compute
within 2e-2 on both, the bar of tests/test_mixed_precision.py (the two
packages round to bf16 at other places).
"""

import inspect
import re

import jax
import numpy as np
import pytest
import torch

from flexflow_tpu.apps import lm as j_lm
from flexflow_tpu.models.transformer import TransformerConfig as JTConfig
from flexflow_tpu.models.transformer import TransformerLM as JLM
from flexflow_tpu.ops.pallas import get_policy, set_policy
from flexflow_tpu_torch.apps import lm as t_lm
from flexflow_tpu_torch.interop import params_from_jax
from flexflow_tpu_torch.models.transformer import TransformerConfig as TTConfig
from flexflow_tpu_torch.models.transformer import TransformerLM as TLM

torch.set_num_threads(2)

STEPS = 3
TOL = {"float32": 1e-4, "bfloat16": 2e-2}
CFG = dict(batch_size=8, seq_length=256, num_layers=1, d_model=16,
           num_heads=4, d_ff=32, vocab_size=64, causal=True,
           learning_rate=0.1, seed=0)


@pytest.fixture
def pallas_on():
    """The JAX package's kernel policy is process-wide; restore it."""
    before = get_policy()
    yield
    set_policy(before)


def _pair(machine1, dtype="float32", **kw):
    """(jax model, its params, port model, the same params in the port)."""
    jm = JLM(JTConfig(**CFG, compute_dtype=dtype, pallas="on", **kw),
             machine1)
    tm = TLM(TTConfig(**CFG, compute_dtype=dtype, **kw), device="cpu")
    assert [op.name for op in tm.layers] == [op.name for op in jm.layers]
    jp, _ = jm.init(0)
    tree = jax.tree.map(np.asarray, jp)
    return jm, jp, tm, params_from_jax(tree, device="cpu")


def _tokens(seed):
    rng = np.random.RandomState(seed)
    return rng.randint(0, 64, (8, 256)).astype("int32")


def test_softmax_dp_loss_matches_jax():
    from flexflow_tpu.ops.base import Tensor as JTensor
    from flexflow_tpu.ops.softmax_dp import SoftmaxDP as JSoftmaxDP
    from flexflow_tpu.strategy import ParallelConfig as JPC
    from flexflow_tpu_torch.ops.base import Tensor as TTensor
    from flexflow_tpu_torch.ops.softmax_dp import SoftmaxDP as TSoftmaxDP
    from flexflow_tpu_torch.strategy import ParallelConfig as TPC

    jop = JSoftmaxDP("sm", JPC((1,), (0,)), JTensor((3, 5, 7)),
                     JTensor((3, 5), "int32"))
    top = TSoftmaxDP("sm", TPC((1,), (0,)), TTensor((3, 5, 7)),
                     TTensor((3, 5), "int32"))
    rng = np.random.RandomState(1)
    logits = rng.randn(3, 5, 7).astype("float32")
    labels = rng.randint(0, 7, (3, 5)).astype("int32")
    labels[:, -1] = -1
    lp_t, _ = top.forward({}, {}, [torch.from_numpy(logits), None], True)
    lp_j, _ = jop.forward({}, {}, [jax.numpy.asarray(logits), None], True)
    np.testing.assert_allclose(lp_t.numpy(), np.asarray(lp_j), rtol=1e-6,
                               atol=1e-6)
    # the log-probs form and the fused per-token-NLL form
    nll = rng.rand(3, 5).astype("float32")
    for value in (logits, nll):
        v_t = lp_t if value is logits else torch.from_numpy(value)
        v_j = lp_j if value is logits else jax.numpy.asarray(value)
        got = top.loss(v_t, torch.from_numpy(labels))
        want = jop.loss(v_j, jax.numpy.asarray(labels))
        np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


def test_loss_fn_matches_jax(machine1, pallas_on):
    jm, jp, tm, tp = _pair(machine1)
    toks = _tokens(3)
    want, _ = jm.loss_fn(jp, {}, toks, toks, train=True)
    fused, _ = tm.loss_fn(tp, {}, torch.from_numpy(toks),
                          torch.from_numpy(toks), train=True)
    unfused, _ = tm.loss_fn(tp, {}, torch.from_numpy(toks),
                            torch.from_numpy(toks), train=False)
    assert float(fused) == pytest.approx(float(want), rel=1e-5)
    assert float(unfused) == pytest.approx(float(want), rel=1e-5)
    # the fusion folds lm_head into the loss op when training only
    plan = tm._lm_head_fusion()
    names = {tm.layers[i].name: lin for i, lin in plan.items()}
    assert names["lm_head"] is None and names["softmax"].name == "lm_head"


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_three_sgd_steps_match_jax(machine1, pallas_on, dtype):
    jm, jp, tm, tp = _pair(machine1, dtype)
    jopt, topt = jm.init_opt_state(jp), tm.init_opt_state(tp)
    assert jopt is None and topt is None     # plain SGD, float32 params
    jstep, tstep = jm.make_train_step(), tm.make_train_step()
    j_losses, t_losses = [], []
    js, ts = {}, {}
    toks = _tokens(10)
    for _ in range(STEPS):
        jp, js, jopt, jl = jstep(jp, js, jopt, toks, toks)
        tp, ts, topt, tl = tstep(tp, ts, topt, toks, toks)
        j_losses.append(float(jl))
        t_losses.append(float(tl))
    tol = TOL[dtype]
    np.testing.assert_allclose(t_losses, j_losses, rtol=tol)
    assert t_losses[-1] < t_losses[0]        # the steps train
    for key, leaves in jax.tree.map(np.asarray, jp).items():
        scale = max(float(np.abs(v).max()) for v in leaves.values())
        for leaf, want in leaves.items():
            err = float(np.abs(tp[key][leaf].numpy() - want).max())
            assert err <= tol * scale, f"{key}.{leaf}: {err:.3e}"


def test_three_sgd_steps_match_jax_at_head_dim_128(machine1, pallas_on):
    # the GPT-1.3B preset's head dim (2048 / 16) at a small size: both
    # sides run the flash backward at d 128
    small = dict(CFG, seq_length=16, d_model=256, num_heads=2, d_ff=64)
    jm = JLM(JTConfig(**small, pallas="on"), machine1)
    tm = TLM(TTConfig(**small), device="cpu")
    assert {op.name: op for op in tm.layers}["blk0_attn"].head_dim == 128
    jp, _ = jm.init(0)
    tp = params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    jstep, tstep = jm.make_train_step(), tm.make_train_step()
    jopt, topt, js, ts = None, None, {}, {}
    toks = np.random.RandomState(11).randint(0, 64, (8, 16)).astype("int32")
    j_losses, t_losses = [], []
    for _ in range(STEPS):
        jp, js, jopt, jl = jstep(jp, js, jopt, toks, toks)
        tp, ts, topt, tl = tstep(tp, ts, topt, toks, toks)
        j_losses.append(float(jl))
        t_losses.append(float(tl))
    np.testing.assert_allclose(t_losses, j_losses, rtol=TOL["float32"])
    assert t_losses[-1] < t_losses[0]
    for key, leaves in jax.tree.map(np.asarray, jp).items():
        scale = max(float(np.abs(v).max()) for v in leaves.values())
        for leaf, want in leaves.items():
            err = float(np.abs(tp[key][leaf].numpy() - want).max())
            assert err <= TOL["float32"] * scale, f"{key}.{leaf}: {err:.3e}"


def test_mixed_precision_step_keeps_float32_masters():
    tm = TLM(TTConfig(**CFG, compute_dtype="bfloat16",
                      param_dtype="bfloat16"), device="cpu")
    params, state = tm.init()
    assert all(v.dtype == torch.bfloat16 for sub in params.values()
               for v in sub.values())
    opt = tm.init_opt_state(params)
    m0 = opt["lm_head"]["kernel__master"]
    assert m0.dtype == torch.float32 and set(opt["lm_head"]) == \
        {"kernel__master", "bias__master"}
    toks = _tokens(4)
    new_params, _, new_opt, loss = tm.make_train_step()(params, state, opt,
                                                        toks, toks)
    assert np.isfinite(float(loss))
    m = new_opt["lm_head"]["kernel__master"]
    assert m.dtype == torch.float32 and not torch.equal(m, m0)
    assert torch.equal(new_params["lm_head"]["kernel"], m.to(torch.bfloat16))
    # the inputs are not modified
    assert torch.equal(opt["lm_head"]["kernel__master"], m0)


def test_batch_keeps_token_ids_integer():
    tm = TLM(TTConfig(**CFG), device="cpu")
    toks = _tokens(5)
    t, l = tm._batch(toks, toks)
    assert t.dtype == l.dtype == torch.int32
    assert torch.equal(t, torch.from_numpy(toks))


def test_token_stream_matches_jax(machine1):
    from flexflow_tpu.data import synthetic_token_stream as j_stream
    from flexflow_tpu_torch.data import synthetic_token_stream as t_stream

    j = j_stream(machine1, 3, 5, 11, seed=4, streams=2)
    t = t_stream(3, 5, 11, seed=4, streams=2, device="cpu")
    for _ in range(3):
        for a, b in zip(next(j), next(t)):
            assert b.dtype == torch.int32
            np.testing.assert_array_equal(b.numpy(), np.asarray(a))


def test_lm_app_prints_the_metric_lines():
    lines = []
    out = t_lm.main(["--causal", "-b", "2", "-s", "16", "-l", "1",
                     "--d-model", "16", "--heads", "2", "--d-ff", "32",
                     "--vocab", "64", "-i", "3", "--device", "cpu"],
                    log=lines.append)
    assert any(line.startswith("time = ") and line.endswith(" images/s")
               for line in lines), lines
    assert lines[-1] == f"tokens/s = {out['tokens_per_sec']:.0f}"
    assert len(out["loss"]) == 3 and all(np.isfinite(out["loss"]))
    assert out["loss"][0] == pytest.approx(np.log(64), rel=0.1)
    assert out["tokens_per_sec"] == pytest.approx(
        out["images_per_sec"] * 16)


def test_every_jax_lm_flag_is_parsed_or_refused():
    from flexflow_tpu_torch.config import (RESTRICTED_VALUES,
                                           SWITCH_VALUE_FLAGS,
                                           UNPORTED_FLAGS)

    src = inspect.getsource(j_lm.parse_args)
    flags = set(re.findall(r'"(-[-\w:]+)"', src))
    assert len(flags) > 50
    refused = UNPORTED_FLAGS
    # the pipelined path's flags are parsed
    assert {"--pipeline-stages", "--microbatches", "--pipeline-tp"} <= flags
    default = t_lm.parse_args([])
    # a value for the flags checked when parsed, and one off the default
    values = {"-on-divergence": "rollback", "--on-divergence": "rollback",
              "-fault-spec": "loss_nan@2", "--fault-spec": "loss_nan@2",
              "--moe-top-k": "1", "--regrow-probes": "3"}
    for flag in sorted(flags):
        if flag in refused and flag != "-s":
            with pytest.raises(NotImplementedError, match="not ported"):
                t_lm.parse_args([flag, "2"])
        elif flag in SWITCH_VALUE_FLAGS:
            # a restricted switch: the values the port runs parse as JAX
            # parses them, the others are refused with the reason
            field = SWITCH_VALUE_FLAGS[flag]
            ok, no = RESTRICTED_VALUES[field]
            for value in ok:
                j = j_lm.parse_args([flag, value])
                assert getattr(j, field) == value, flag
                # checked, not stored: the port runs only this value
                assert t_lm.parse_args([flag, value]) == default, flag
            for value, why in no.items():
                with pytest.raises(SystemExit, match=re.escape(why)):
                    t_lm.parse_args([flag, value])
        else:
            # the verification switches take no value
            value = values.get(flag, "2")
            assert t_lm.parse_args([flag, value]) != default, flag
    cfg, device, warmup = t_lm.parse_args(
        ["--causal", "-s", "64", "--device", "cpu", "--warmup", "2",
         "--no-such-flag"])
    assert (cfg.causal, cfg.seq_length, device, warmup) == \
        (True, 64, "cpu", 2)


def test_experts_refused():
    # mixture of experts is ported: num_experts > 0 builds MoE blocks, and
    # what is refused is a top-k above the expert count
    tm = TLM(TTConfig(**CFG, num_experts=4), device="cpu")
    assert [op.name for op in tm.layers if op.name.endswith("_moe")] == \
        ["blk0_moe"]
    with pytest.raises(ValueError, match="top_k 5"):
        TLM(TTConfig(**CFG, num_experts=4, moe_top_k=5), device="cpu")
