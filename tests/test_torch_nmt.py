"""The NMT slice against the JAX package, on the CPU.

* ``FFModel.apply`` with an op of three outputs stores each value under
  its tensor.
* ``LSTMChunk``'s forward (y, hy, cy) against the JAX op's at B 4, L 5,
  E 12, H 16, with and without an initial state, from the JAX op's
  params carried over with ``params_from_jax``; its gradients to x,
  w_ih, w_hh, b, hx and cx against ``jax.grad`` through the JAX op's
  custom VJP, and against torch autograd through the port's own plain
  step loop (``lstm_recurrence``), including a loss that sends hy and cy
  no cotangent.
* ``RnnModel``'s graph against JAX's: op names and types, every output's
  shape, param keys, leaves and shapes (the sharing of ``srcEmbed`` /
  ``dstEmbed``, ``encoder{l}`` / ``decoder{l}`` and one ``linear``),
  including an uneven last chunk (seq 7, chunk 3).
* Three plain-SGD steps of a small ``RnnModel`` (batch 4, 2 layers, seq
  6, chunk 3, hidden 16, embed 12, vocab 64) against JAX's, every final
  leaf compared.  JAX runs with ``pallas="on"``; at 12 tokens a chunk its
  fusion gate leaves each vocab head unfused, where the port fuses every
  head into kernels 4-6 (their plain versions here): the same function.
* ``apps.nmt`` on the CPU with tiny flags, and every JAX NMT flag parsed
  or refused.

Tolerances: float32 forward values 1e-5, gradients and losses 1e-4
relative (the same float32 arithmetic in another order), final leaves
1e-4 of the largest magnitude among their op's leaves; bfloat16 compute
2e-2 on losses and leaves, the bar of tests/test_torch_lm_train.py (the
two packages round to bf16 at other places).
"""

import inspect
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flexflow_tpu.apps import nmt as j_nmt
from flexflow_tpu.nmt.rnn_model import RnnConfig as JRnnConfig
from flexflow_tpu.nmt.rnn_model import RnnModel as JRnnModel
from flexflow_tpu.ops.base import Tensor as JTensor
from flexflow_tpu.ops.lstm import LSTMChunk as JLSTMChunk
from flexflow_tpu.ops.pallas import get_policy, set_policy
from flexflow_tpu.strategy import ParallelConfig as JPC
from flexflow_tpu_torch.apps import nmt as t_nmt
from flexflow_tpu_torch.config import (RESTRICTED_VALUES, SWITCH_VALUE_FLAGS,
                                       VERIFY_FLAGS)
from flexflow_tpu_torch.interop import params_from_jax
from flexflow_tpu_torch.model import FFModel as TModel
from flexflow_tpu_torch.nmt.rnn_model import RnnConfig as TRnnConfig
from flexflow_tpu_torch.nmt.rnn_model import RnnModel as TRnnModel
from flexflow_tpu_torch.ops.base import Op
from flexflow_tpu_torch.ops.base import Tensor as TTensor
from flexflow_tpu_torch.ops.lstm import LSTMChunk as TLSTMChunk
from flexflow_tpu_torch.ops.lstm import LSTMCore, lstm_recurrence
from flexflow_tpu_torch.strategy import ParallelConfig as TPC

torch.set_num_threads(2)

STEPS = 3
TOL = {"float32": 1e-4, "bfloat16": 2e-2}
SMALL = dict(batch_size=4, num_layers=2, seq_length=6, hidden_size=16,
             embed_size=12, vocab_size=64, lstm_per_node_length=3,
             learning_rate=0.1, seed=3)
B, L, E, H = 4, 5, 12, 16


@pytest.fixture
def pallas_on():
    """The JAX package's kernel policy is process-wide; restore it."""
    before = get_policy()
    yield
    set_policy(before)


class _ThreeOutputs(Op):
    def __init__(self, name, pc, x):
        super().__init__(name, pc, [x])
        self.output = TTensor(x.shape, x.dtype, self, f"{name}.a")
        self.outputs = [self.output,
                        TTensor(x.shape, x.dtype, self, f"{name}.b"),
                        TTensor(x.shape[:1], x.dtype, self, f"{name}.c")]

    def forward(self, params, state, xs, train):
        (x,) = xs
        return (x + 1.0, 2.0 * x, x.sum(1)), state


def test_apply_stores_every_output_of_a_multi_output_op():
    ff = TModel(device="cpu")
    x = ff.create_input((3, 4), name="x")
    op = _ThreeOutputs("three", TPC((1,), (0,)), x)
    assert ff._add(op) is op.output
    assert op.all_outputs() == op.outputs
    # a single-output op downstream reads the first two outputs
    total = ff.add("sum", op.outputs[0], op.outputs[1], relu=True)
    assert ff.layers[1].all_outputs() == [total]
    v = torch.arange(12.0).reshape(3, 4) - 6.0
    values, _ = ff.apply({}, {}, {x.tid: v}, train=False)
    a, b, c = (values[t.tid] for t in op.outputs)
    assert torch.equal(a, v + 1) and torch.equal(b, 2 * v)
    assert torch.equal(c, v.sum(1))
    assert torch.equal(values[total.tid], torch.relu(3 * v + 1))


def _lstm_pair(initial_state, seed=0):
    """(JAX op, its params, port op, the same params in the port)."""
    pc_j, pc_t = JPC((1,), (0,)), TPC((1,), (0,))
    st_j = (JTensor((B, H)), JTensor((B, H))) if initial_state else (None,
                                                                       None)
    st_t = (TTensor((B, H)), TTensor((B, H))) if initial_state else (None,
                                                                       None)
    jop = JLSTMChunk("l", pc_j, JTensor((B, L, E)), *st_j, H)
    top = TLSTMChunk("l", pc_t, TTensor((B, L, E)), *st_t, H)
    jp = jop.init_params(jax.random.PRNGKey(seed))
    tp = params_from_jax({"l": jax.tree.map(np.asarray, jp)},
                         device="cpu")["l"]
    return jop, jp, top, tp


def _lstm_inputs(initial_state, seed=1):
    rng = np.random.RandomState(seed)
    xs = [rng.randn(B, L, E).astype("float32")]
    if initial_state:
        xs += [0.5 * rng.randn(B, H).astype("float32") for _ in range(2)]
    return xs


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("initial_state", [False, True])
def test_lstm_chunk_forward_matches_jax(dtype, initial_state):
    jop, jp, top, tp = _lstm_pair(initial_state)
    xs = _lstm_inputs(initial_state)
    (jy, jhy, jcy), _ = jop.forward(
        jp, {}, [jnp.asarray(a, dtype) for a in xs], True)
    (ty, thy, tcy), _ = top.forward(
        tp, {}, [torch.from_numpy(a).to(getattr(torch, dtype)) for a in xs],
        True)
    tol = 1e-5 if dtype == "float32" else 2e-2
    for got, want in ((ty, jy), (thy, jhy), (tcy, jcy)):
        assert got.dtype == getattr(torch, dtype)
        np.testing.assert_allclose(got.float().numpy(),
                                   np.asarray(want, np.float32),
                                   rtol=tol, atol=tol)
    assert tuple(ty.shape) == (B, L, H) and torch.equal(thy, ty[:, -1])


def _losses(use_state):
    """Losses over (y, hy, cy): one sends all three a cotangent, one y
    alone (hy and cy get none)."""
    def loss(y, hy, cy):
        total = (y ** 2).sum()
        if use_state:
            total = total + (hy * cy).sum() + 0.5 * hy.sum()
        return total
    return loss


@pytest.mark.parametrize("use_state", [True, False])
@pytest.mark.parametrize("initial_state", [False, True])
def test_lstm_chunk_gradients_match_jax(initial_state, use_state):
    jop, jp, top, tp = _lstm_pair(initial_state)
    xs = _lstm_inputs(initial_state)
    loss = _losses(use_state)

    def j_loss(p, xs_):
        (y, hy, cy), _ = jop.forward(p, {}, xs_, True)
        return loss(y, hy, cy)

    jg_p, jg_x = jax.grad(j_loss, argnums=(0, 1))(
        jp, [jnp.asarray(a) for a in xs])
    tp = {k: v.clone().requires_grad_() for k, v in tp.items()}
    txs = [torch.from_numpy(a).requires_grad_() for a in xs]
    (y, hy, cy), _ = top.forward(tp, {}, txs, True)
    loss(y, hy, cy).backward()
    for name in ("w_ih", "w_hh", "b"):
        want = np.asarray(jg_p[name])
        np.testing.assert_allclose(tp[name].grad.numpy(), want, rtol=1e-4,
                                   atol=1e-4 * np.abs(want).max(),
                                   err_msg=name)
    for name, got, want in zip(("x", "hx", "cx"), txs, jg_x):
        want = np.asarray(want)
        np.testing.assert_allclose(got.grad.numpy(), want, rtol=1e-4,
                                   atol=1e-4 * np.abs(want).max(),
                                   err_msg=name)


@pytest.mark.parametrize("use_state", [True, False])
def test_lstm_core_backward_matches_autograd_of_the_step_loop(use_state):
    """The hand-written backward (deferred dW_hh) against torch autograd
    through ``lstm_recurrence``, as tests/test_nmt.py holds the JAX VJP
    against jax.grad of the plain scan."""
    gen = torch.Generator().manual_seed(0)
    args = [torch.randn(3, 5, 16, generator=gen),
            0.3 * torch.randn(4, 16, generator=gen),
            0.1 * torch.randn(16, generator=gen),
            torch.randn(3, 4, generator=gen),
            torch.randn(3, 4, generator=gen)]
    loss = _losses(use_state)
    a = [t.clone().requires_grad_() for t in args]
    r = [t.clone().requires_grad_() for t in args]
    out_a = LSTMCore.apply(*a)
    out_r = lstm_recurrence(*r)[:3]
    for got, want in zip(out_a, out_r):
        assert torch.equal(got, want.detach())
    loss(*out_a).backward()
    loss(*out_r).backward()
    for name, ga, gr in zip(("xg", "w_hh", "b", "hx", "cx"), a, r):
        torch.testing.assert_close(ga.grad, gr.grad, rtol=2e-5, atol=2e-5,
                                   msg=name)


def _rnn_pair(machine1, dtype="float32", **kw):
    cfg = dict(SMALL, compute_dtype=dtype, **kw)
    jm = JRnnModel(JRnnConfig(**cfg, pallas="on"), machine1)
    tm = TRnnModel(TRnnConfig(**cfg), device="cpu")
    return jm, tm


def _graph(model):
    return [(op.name, type(op).__name__, op.param_key,
             [t.shape for t in op.all_outputs()]) for op in model.layers]


@pytest.mark.parametrize("seq,chunk", [(6, 3), (7, 3)])
def test_rnn_model_graph_matches_jax(machine1, pallas_on, seq, chunk):
    jm, tm = _rnn_pair(machine1, seq_length=seq, lstm_per_node_length=chunk)
    assert _graph(tm) == _graph(jm)
    npc = -(-seq // chunk)
    assert [op.output.shape[1] for op in tm.layers
            if op.name.startswith("src_chunk")] == \
        [min(chunk, seq - i * chunk) for i in range(npc)]
    jp, _ = jm.init(0, abstract=True)
    tp, ts = tm.init(0)
    assert ts == {}

    def shapes(tree):
        return {k: {leaf: tuple(v.shape) for leaf, v in sub.items()}
                for k, sub in tree.items()}

    assert shapes(tp) == shapes(jp)
    assert set(tp) == {"srcEmbed", "dstEmbed", "encoder0", "encoder1",
                       "decoder0", "decoder1", "linear"}
    # the forget-gate bias starts at 1, the rest at 0
    b = tp["encoder0"]["b"]
    assert torch.equal(b[16:32], torch.ones(16))
    assert float(b[:16].abs().sum() + b[32:].abs().sum()) == 0.0
    # w_hh is orthogonal: its rows are orthonormal
    w = tp["decoder1"]["w_hh"]
    torch.testing.assert_close(w @ w.T, torch.eye(16), atol=1e-5, rtol=0)
    # every decoder chunk's projection and loss run fused in training
    plan = tm._lm_head_fusion()
    fused = {tm.layers[i].name: lin for i, lin in plan.items()}
    assert {n for n, lin in fused.items() if lin is None} == \
        {f"linear{j}" for j in range(npc)}
    assert {n: lin.name for n, lin in fused.items() if lin is not None} == \
        {f"softmax{j}": f"linear{j}" for j in range(npc)}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_three_sgd_steps_match_jax(machine1, pallas_on, dtype):
    jm, tm = _rnn_pair(machine1, dtype)
    jp, js = jm.init(0)
    tp = params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    jopt, topt = jm.init_opt_state(jp), tm.init_opt_state(tp)
    assert jopt is None and topt is None
    jstep, tstep = jm.make_train_step(), tm.make_train_step()
    rng = np.random.RandomState(7)
    ts = {}
    j_losses, t_losses = [], []
    for _ in range(STEPS):
        src, dst = (rng.randint(0, 64, (4, 6)).astype("int32")
                    for _ in range(2))
        jp, js, jopt, jl = jstep(jp, js, jopt, src, dst)
        tp, ts, topt, tl = tstep(tp, ts, topt, src, dst)
        j_losses.append(float(jl))
        t_losses.append(float(tl))
    tol = TOL[dtype]
    assert all(np.isfinite(t_losses))
    np.testing.assert_allclose(t_losses, j_losses, rtol=tol)
    assert abs(t_losses[0] - np.log(64)) < 0.1
    for key, leaves in jax.tree.map(np.asarray, jp).items():
        scale = max(float(np.abs(v).max()) for v in leaves.values())
        for leaf, want in leaves.items():
            got = tp[key][leaf]
            assert got.dtype == torch.float32, (key, leaf)
            err = float(np.abs(got.numpy() - want).max())
            assert err <= tol * scale, f"{key}.{leaf}: {err:.3e}"
    # the shared vocab projection moved (both chunks' gradients summed)
    assert float(tp["linear"]["bias"].abs().max()) > 0


def test_nmt_app_prints_the_metric_lines():
    lines = []
    out = t_nmt.main(["-b", "4", "-l", "2", "-s", "6", "-h", "16", "-e",
                      "12", "--vocab", "64", "--chunk", "3", "-i", "3",
                      "--device", "cpu"], log=lines.append)
    assert lines[0] == ("NMT: 2 layers, seq 6 (chunks of 3), hidden 16, "
                        "embed 12, vocab 64, batch 4, float32 compute, "
                        "float32 params, on cpu")
    assert any(line.startswith("time = ") and line.endswith(" images/s")
               for line in lines), lines
    assert lines[-1].startswith("sentences/s = ")
    assert len(out["loss"]) == 3 and all(np.isfinite(out["loss"]))
    assert out["sentences_per_sec"] == out["images_per_sec"] > 0
    assert not {"params", "state", "opt_state"} & set(out)


def test_nmt_app_defaults_and_device():
    cfg, device, warmup, placement = t_nmt.parse_args([])
    assert (device, warmup) == ("cuda", 1)
    assert placement == {"strategy": "", "stages": 0}
    assert cfg == TRnnConfig()
    assert (cfg.batch_size, cfg.num_layers, cfg.seq_length, cfg.hidden_size,
            cfg.embed_size, cfg.vocab_size, cfg.lstm_per_node_length,
            cfg.learning_rate, cfg.compute_dtype) == \
        (64, 2, 20, 2048, 2048, 20480, 10, 0.1, "float32")
    j = JRnnConfig()
    assert all(getattr(cfg, f) == getattr(j, f)
               for f in TRnnConfig.__dataclass_fields__)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            t_nmt.main(["-b", "2", "-s", "2", "-h", "4", "-e", "4",
                        "--vocab", "8", "-i", "1"], log=lambda *a: None)


def test_every_jax_nmt_flag_is_parsed_or_refused():
    src = inspect.getsource(j_nmt.parse_args)
    flags = set(re.findall(r'"(-[-\w:]+)"', src))
    assert len(flags) > 40
    ported = {"-b", "-l", "-s", "-h", "-e", "--vocab", "-i", "--iters",
              "--iterations", "--chunk", "--lr", "--dtype", "-param-dtype",
              "--param-dtype", "--seed", "--strategy", "--pipeline-stages",
              "--allow-degraded"} | set(t_nmt.NMT_RUNTIME_FLAGS)
    assert ported <= flags
    default = t_nmt.parse_args([])
    values = {"-on-divergence": "rollback", "--on-divergence": "rollback",
              "-fault-spec": "loss_nan@3", "--fault-spec": "loss_nan@3"}
    for flag in sorted(flags):
        if flag in ported:
            value = "bfloat16" if "dtype" in flag \
                else values.get(flag, "5")
            assert t_nmt.parse_args([flag, value]) != default, flag
        elif flag in VERIFY_FLAGS:
            # the verification switches take no value
            field, value = VERIFY_FLAGS[flag]
            assert getattr(t_nmt.parse_args([flag])[0], field) == value \
                == getattr(j_nmt.parse_args([flag]), field), flag
        elif flag in SWITCH_VALUE_FLAGS:
            # a restricted switch: the values the port runs parse as JAX
            # parses them, the others are refused with the reason
            field = SWITCH_VALUE_FLAGS[flag]
            ok, no = RESTRICTED_VALUES[field]
            for value in ok:
                j = j_nmt.parse_args([flag, value])
                assert getattr(j, field) == value, flag
                # checked, not stored: the port runs only this value
                assert t_nmt.parse_args([flag, value]) == default, flag
            for value, why in no.items():
                with pytest.raises(SystemExit, match=re.escape(why)):
                    t_nmt.parse_args([flag, value])
        else:
            assert flag in t_nmt.NMT_UNPORTED_FLAGS, flag
            with pytest.raises(NotImplementedError, match="not ported"):
                t_nmt.parse_args([flag, "2"])
    cfg, device, warmup, _ = t_nmt.parse_args(
        ["-s", "8", "-e", "32", "--device", "cpu", "--warmup", "2",
         "--no-such-flag"])
    assert (cfg.seq_length, cfg.embed_size, device, warmup) == \
        (8, 32, "cpu", 2)
