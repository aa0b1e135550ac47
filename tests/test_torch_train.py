"""The port's CNN training step against the JAX package's, on the CPU.

Two models, each built in both packages: AlexNet at a 67x67 input (here),
and a mini-Inception made of the port's own block functions (a small
stem with a pad-1 max pool, one A, B, C, D and E block, the global
average pool, a linear and the softmax) at batch 2
(tests/test_torch_train_inception.py, a file of its own so that the two
run in parallel).  The JAX ``FFModel.init()`` tree is
carried into the port with ``params_from_jax``; both take three
momentum-SGD steps (``make_train_step``, learning rate 1e-3 so that the
reference AlexNet, whose convolutions have no ReLU, does not blow up on
random data; weight decay 1e-4; momentum 0.9 so the optimizer state
matters) on the same seeded random batches.  The
JAX side runs with ``FFConfig(pallas="on")``: its max and avg pools go
through kernels 7 and 8 in interpret mode, the port's through the same
autograd functions that launch the CUDA kernels on a GPU.

Tolerances: float32 losses within 1e-4 relative and every final
parameter leaf within 1e-4 of the largest magnitude among its op's
leaves (the same arithmetic summed in another order); bfloat16 compute
within 2e-2 on both, the bar of tests/test_mixed_precision.py (the two
packages round to bf16 at other places).
"""

from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from flexflow_tpu.config import FFConfig as JConfig
from flexflow_tpu.model import FFModel as JModel
from flexflow_tpu.ops.pallas import get_policy, set_policy
from flexflow_tpu_torch.apps import cnn as t_cnn
from flexflow_tpu_torch.config import FFConfig as TConfig
from flexflow_tpu_torch.data import synthetic_batches as t_batches
from flexflow_tpu_torch.interop import params_from_jax
from flexflow_tpu_torch.model import FFModel as TModel
from flexflow_tpu_torch.models import alexnet as t_alexnet
from flexflow_tpu_torch.models import inception as t_inc

torch.set_num_threads(2)

STEPS = 3
TOL = {"float32": 1e-4, "bfloat16": 2e-2}
STRATEGY_FILE = (Path(__file__).resolve().parents[1] / "examples"
                 / "strategies" / "alexnet_2x4.json")


def mini_inception(ff, image):
    t = ff.conv2d("conv1", image, 32, 3, 3, 1, 1, 0, 0, relu=True)
    t = ff.pool2d("pool1", t, 3, 3, 2, 2, 1, 1)
    t = t_inc.inception_a(ff, "incA1", t, 32)
    t = t_inc.inception_b(ff, "incB1", t)
    t = t_inc.inception_c(ff, "incC1", t, 64)
    t = t_inc.inception_d(ff, "incD1", t)
    t = t_inc.inception_e(ff, "incE1", t)
    _, h, w, _ = t.shape
    t = ff.pool2d("pool3", t, h, w, 1, 1, 0, 0, pool_type="avg",
                  relu=False)
    t = ff.flat("flat", t)
    t = ff.linear("linear1", t, 10, relu=False)
    return ff.softmax("softmax", t)


MODELS = {
    # name: (layers, batch, input size, classes)
    "alexnet": (t_alexnet.add_alexnet_layers, 2, 67, 1000),
    "mini_inception": (mini_inception, 2, 27, 10),
}


@pytest.fixture
def pallas_on():
    """The JAX package's kernel policy is process-wide; restore it."""
    before = get_policy()
    yield
    set_policy(before)


def _cfg(cls, model, dtype, **kw):
    _, batch, size, classes = MODELS[model]
    return cls(batch_size=batch, input_height=size, input_width=size,
               num_classes=classes, compute_dtype=dtype, learning_rate=1e-3,
               momentum=0.9, seed=3, **kw)


def _build(model_cls, cfg, model, machine=None, device=None):
    ff = model_cls(cfg, machine) if device is None \
        else model_cls(cfg, device=device)
    image = ff.create_input((cfg.batch_size, cfg.input_height,
                             cfg.input_width, 3), name="image")
    MODELS[model][0](ff, image)
    return ff


def _batches(model):
    _, batch, size, classes = MODELS[model]
    rng = np.random.RandomState(11)
    return [(rng.randn(batch, size, size, 3).astype("float32"),
             rng.randint(0, classes, size=batch).astype("int32"))
            for _ in range(STEPS)]


def _close(got, want, tol, what, scale):
    err = float(np.abs(got - want).max())
    assert err <= tol * scale, f"{what}: max err {err:.3e} > {tol} x " \
                               f"{scale:.3e}"


def check_three_steps(machine1, model, dtype):
    """Three steps of ``model`` in both packages from one parameter tree;
    losses, final parameters and (float32) the momentum buffer agree."""
    jm = _build(JModel, _cfg(JConfig, model, dtype, pallas="on"), model,
                machine1)
    tm = _build(TModel, _cfg(TConfig, model, dtype), model, device="cpu")
    assert [op.name for op in tm.layers] == [op.name for op in jm.layers]
    jp, js = jm.init(0)
    tree = jax.tree.map(np.asarray, jp)
    tp = params_from_jax(tree, device="cpu")
    topt = tm.init_opt_state(tp)
    jopt = jm.init_opt_state(jp)
    jstep, tstep = jm.make_train_step(), tm.make_train_step()
    j_losses, t_losses = [], []
    ts = {}
    for image, labels in _batches(model):
        jp, js, jopt, jl = jstep(jp, js, jopt, image, labels)
        tp, ts, topt, tl = tstep(tp, ts, topt, image, labels)
        j_losses.append(float(jl))
        t_losses.append(float(tl))
    tol = TOL[dtype]
    np.testing.assert_allclose(t_losses, j_losses, rtol=tol)
    assert all(np.isfinite(t_losses))
    # each leaf against the largest magnitude among its op's leaves (a
    # bias starts at 0, so alone it would measure the gradient's own
    # relative error)
    jtree = jax.tree.map(np.asarray, jp)
    for key, leaves in jtree.items():
        scale = max(float(np.abs(v).max()) for v in leaves.values())
        for leaf, want in leaves.items():
            _close(tp[key][leaf].numpy(), want, tol, f"{key}.{leaf}", scale)
    if dtype == "float32":
        # the momentum buffer is the sum of the gradients; under bf16
        # compute the first layer's gradient is itself ~30% off its
        # float32 value in both packages (heavy cancellation), so only
        # the float32 run can pin it
        jv = np.asarray(jopt["conv1"]["kernel"])
        _close(topt["conv1"]["kernel"].numpy(), jv, tol,
               "momentum conv1.kernel", float(np.abs(jv).max()))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_three_steps_match_jax(machine1, pallas_on, dtype):
    check_three_steps(machine1, "alexnet", dtype)


def test_mixed_precision_step_keeps_float32_masters():
    cfg = TConfig(batch_size=2, input_height=27, input_width=27,
                  num_classes=10, compute_dtype="bfloat16",
                  param_dtype="bfloat16", seed=3)
    tm = _build(TModel, cfg, "mini_inception", device="cpu")
    params, state = tm.init()
    assert all(v.dtype == torch.bfloat16 for sub in params.values()
               for v in sub.values())
    opt = tm.init_opt_state(params)
    assert opt["conv1"]["kernel__master"].dtype == torch.float32
    step = tm.make_train_step()
    image, labels = _batches("mini_inception")[0]
    new_params, _, new_opt, loss = step(params, state, opt, image, labels)
    assert np.isfinite(float(loss))
    m = new_opt["conv1"]["kernel__master"]
    assert m.dtype == torch.float32
    assert torch.equal(new_params["conv1"]["kernel"], m.to(torch.bfloat16))
    # the inputs are not modified
    assert torch.equal(opt["conv1"]["kernel"],
                       torch.zeros_like(opt["conv1"]["kernel"]))


def test_eval_step_loss_matches_train_loss():
    cfg = _cfg(TConfig, "mini_inception", "float32")
    tm = _build(TModel, cfg, "mini_inception", device="cpu")
    params, state = tm.init()
    image, labels = _batches("mini_inception")[0]
    loss, acc = tm.make_eval_step()(params, state, image, labels)
    _, _, _, tl = tm.make_train_step()(params, state,
                                       tm.init_opt_state(params), image,
                                       labels)
    assert float(loss) == pytest.approx(float(tl), rel=1e-6)
    assert 0.0 <= float(acc) <= 1.0


def test_synthetic_batches_match_jax(machine1):
    from flexflow_tpu.data import synthetic_batches as j_batches

    j = j_batches(machine1, 3, 5, 4, num_classes=7, mode="random", seed=9)
    t = t_batches(3, 5, 4, num_classes=7, mode="random", seed=9,
                  device="cpu")
    for _ in range(3):
        (ji, jl), (ti, tl) = next(j), next(t)
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
        np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
    ones_img, ones_lbl = next(t_batches(2, 3, 3, device="cpu"))
    assert bool((ones_img == 1).all()) and bool((ones_lbl == 1).all())


def test_cnn_app_prints_the_metric_line():
    lines = []
    out = t_cnn.main(["alexnet", "-b", "2", "-i", "3", "--height", "67",
                      "--width", "67", "--device", "cpu", "-p", "1"],
                     log=lines.append)
    assert any(line.startswith("time = ") and line.endswith(" images/s")
               for line in lines), lines
    assert [line for line in lines if line.startswith("iter ")] == \
        [f"iter {i}: loss = {v:.4f}" for i, v in
         zip((1, 2, 3), out["loss"])]
    assert len(out["loss"]) == 3 and out["images_per_sec"] > 0


def test_cnn_app_flags():
    name, cfg, device, warmup = t_cnn.parse(
        ["inception", "-b", "8", "--lr", "0.1", "--dtype", "bfloat16",
         "--device", "cpu", "--warmup", "2", "--no-such-flag"])
    assert (name, device, warmup) == ("inception", "cpu", 2)
    assert (cfg.batch_size, cfg.learning_rate, cfg.compute_dtype,
            cfg.input_height, cfg.weight_decay, cfg.momentum) == \
        (8, 0.1, "bfloat16", 299, 1e-4, 0.0)
    # the fleet's flags are ported: parsed as JAX parses them
    assert t_cnn.parse(["alexnet", "--fleet-quantum", "3"])[1] \
        .fleet_quantum == JConfig.from_args(["--fleet-quantum", "3"]) \
        .fleet_quantum == 3
    # the serving runtime's flags are ported: parsed as JAX parses them
    for flag, field in (("--serve-queue-hi", "serve_queue_hi"),
                        ("--serve-prefill-devices",
                         "serve_prefill_devices")):
        got = getattr(t_cnn.parse(["alexnet", flag, "3"])[1], field)
        assert got == getattr(JConfig.from_args([flag, "3"]), field) == 3
    # the verification and executor switches are ported: parsed, their
    # values the port does not run refused with the reason
    _, cfg, _, _ = t_cnn.parse(["alexnet", "--dry-compile",
                                "-regrid-planner", "on", "--pallas", "on"])
    assert cfg.dry_compile
    assert cfg == t_cnn.parse(["alexnet", "--dry-compile"])[1]
    with pytest.raises(SystemExit, match="refused by flexflow_tpu_torch"):
        t_cnn.parse(["alexnet", "--pallas", "off"])
    # fit's runtime, supervision, elastic and data flags are ported:
    # parsed, not refused
    _, cfg, _, _ = t_cnn.parse(["alexnet", "--ckpt-dir", "x",
                                "--ckpt-async", "--elastic",
                                "--transient-reset-steps", "4", "-d", "x",
                                "--profiling"])
    assert cfg.ckpt_dir == "x" and cfg.ckpt_async and cfg.elastic
    assert cfg.transient_reset_steps == 4
    assert cfg.dataset_path == "x" and cfg.profiling


#: a value for the flags checked when parsed (any other takes "2")
FLAG_VALUES = {"-on-divergence": "rollback", "--on-divergence": "rollback",
               "-fault-spec": "loss_nan@2", "--fault-spec": "loss_nan@2",
               "-s": str(STRATEGY_FILE), "--strategy": str(STRATEGY_FILE),
               "--regrow-probes": "3", "-delta": "off", "--delta": "off"}


def test_every_jax_cnn_flag_is_parsed_or_refused():
    import inspect
    import re

    from flexflow_tpu_torch.config import (RESTRICTED_VALUES,
                                           SWITCH_VALUE_FLAGS,
                                           UNPORTED_FLAGS)

    src = inspect.getsource(JConfig.from_args)
    flags = set(re.findall(r'"(-[-\w:]+)"', src))
    assert len(flags) > 60 and UNPORTED_FLAGS <= flags
    for flag in sorted(flags - UNPORTED_FLAGS):
        field = SWITCH_VALUE_FLAGS.get(flag)
        if field in RESTRICTED_VALUES and len(RESTRICTED_VALUES[field][0]) == 1:
            # a switch the port runs at one value, its default: parsed as
            # JAX parses it; the other values refused with the reason
            (value,), no = RESTRICTED_VALUES[field]
            assert TConfig.from_args([flag, value]) == TConfig()
            assert getattr(JConfig.from_args([flag, value]), field) == value
            for bad, why in no.items():
                with pytest.raises(SystemExit, match=re.escape(why)):
                    TConfig.from_args([flag, bad])
            continue
        value = FLAG_VALUES.get(flag, "2")
        assert TConfig.from_args([flag, value]) != TConfig(), flag


def test_inception_v3_graph_matches_jax(machine1, pallas_on):
    from flexflow_tpu.models.inception import build_inception_v3 as j_build

    jm = j_build(JConfig(batch_size=2, input_height=299, input_width=299),
                 machine1)
    tm = t_inc.build_inception_v3(
        TConfig(batch_size=2, input_height=299, input_width=299),
        device="cpu")
    assert [(op.name, type(op).__name__, op.output.shape)
            for op in tm.layers] == \
        [(op.name, type(op).__name__, op.output.shape) for op in jm.layers]
    routes = {op.name: op.kernel_route() for op in tm.layers
              if hasattr(op, "kernel_route") and op.kernel_route()}
    assert routes == {"pool1": "maxpool", "pool2": "maxpool",
                      "incB1_b3_pool": "maxpool",
                      "incD1_b3_pool": "maxpool", "pool3": "avgpool"}
