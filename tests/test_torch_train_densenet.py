"""The DenseNet slice against the JAX package, on the CPU.

* Three momentum-SGD steps (``make_train_step``) of the mini DenseNet of
  tests/test_models.py (conv 16, ``bn1``, a 3-layer dense block of
  growth 8, a transition to 20, the global avg pool, a 10-way linear, at
  batch 8 and 32x32) built from the port's own block functions, from the
  JAX model's params and state carried over with ``params_from_jax`` /
  ``state_from_jax``.  JAX runs with ``FFConfig(pallas="on")``, so both
  sides take kernels 8, 9 and 10 (interpret mode there, the plain
  versions here through the same autograd functions as on the card).
* Full DenseNet-121's graph at batch 2 against JAX's: op names, types,
  output shapes, param and state leaves and their shapes, from the
  abstract JAX init; the 224x224 forward is not run here.
* The ``apps.cnn densenet`` driver: its flags and its metric line on the
  CPU at the smallest input DenseNet-121 takes (its last transition must
  leave a 7x7 map for the 7x7 pool), batch 1.

Tolerances: float32 losses within 1e-4 relative and every final
parameter leaf and running statistic within 1e-4 of the largest magnitude
among its op's leaves (the same arithmetic summed in another order);
bfloat16 compute within 2e-2 on both, the bar of
tests/test_torch_train.py (the two packages round to bf16 at other
places, and a ReLU mask can flip where a rounding lands on 0).
"""

import jax
import numpy as np
import pytest
import torch
from test_torch_train import _close, pallas_on  # noqa: F401

from flexflow_tpu.config import FFConfig as JConfig
from flexflow_tpu.model import FFModel as JModel
from flexflow_tpu.models import densenet as j_densenet
from flexflow_tpu_torch.apps import cnn as t_cnn
from flexflow_tpu_torch.config import FFConfig as TConfig
from flexflow_tpu_torch.interop import params_from_jax, state_from_jax
from flexflow_tpu_torch.model import FFModel as TModel
from flexflow_tpu_torch.models import densenet as t_densenet
from flexflow_tpu_torch.ops.norm import BatchNorm

torch.set_num_threads(2)

STEPS = 3
TOL = {"float32": 1e-4, "bfloat16": 2e-2}
BATCH, SIZE, CLASSES = 8, 32, 10


def mini_densenet(ff, image, blocks):
    """tests/test_models.py's downsized DenseNet from ``blocks`` (either
    package's ``dense_block`` / ``transition``)."""
    t = ff.conv2d("conv1", image, 16, 3, 3, 1, 1, 1, 1, relu=False)
    t = ff.batch_norm("bn1", t, relu=True)
    t = blocks.dense_block(ff, "d1", t, 3, 8)
    t = blocks.transition(ff, "t1", t, 20)
    t = ff.pool2d("gap", t, 16, 16, 1, 1, 0, 0, pool_type="avg", relu=False)
    t = ff.flat("flat", t)
    t = ff.linear("fc", t, CLASSES, relu=False)
    return ff.softmax("softmax", t)


def _cfg(cls, dtype, **kw):
    return cls(batch_size=BATCH, input_height=SIZE, input_width=SIZE,
               num_classes=CLASSES, compute_dtype=dtype, learning_rate=1e-2,
               momentum=0.9, seed=3, **kw)


def _build(ff, blocks):
    image = ff.create_input((BATCH, SIZE, SIZE, 3), name="image")
    mini_densenet(ff, image, blocks)
    return ff


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_three_steps_match_jax(machine1, pallas_on, dtype):  # noqa: F811
    jm = _build(JModel(_cfg(JConfig, dtype, pallas="on"), machine1),
                j_densenet)
    tm = _build(TModel(_cfg(TConfig, dtype), device="cpu"), t_densenet)
    assert [op.name for op in tm.layers] == [op.name for op in jm.layers]
    bns = [op for op in tm.layers if isinstance(op, BatchNorm)]
    assert len(bns) == 7 and all(op.kernel_route() for op in bns)
    jp, js = jm.init(0)
    tp = params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    ts = state_from_jax(jax.tree.map(np.asarray, js), device="cpu")
    assert sorted(ts) == sorted(op.name for op in bns)
    jopt, topt = jm.init_opt_state(jp), tm.init_opt_state(tp)
    jstep, tstep = jm.make_train_step(), tm.make_train_step()
    rng = np.random.RandomState(11)
    j_losses, t_losses = [], []
    for _ in range(STEPS):
        image = rng.randn(BATCH, SIZE, SIZE, 3).astype("float32")
        labels = rng.randint(0, CLASSES, size=BATCH).astype("int32")
        jp, js, jopt, jl = jstep(jp, js, jopt, image, labels)
        tp, ts, topt, tl = tstep(tp, ts, topt, image, labels)
        j_losses.append(float(jl))
        t_losses.append(float(tl))
    tol = TOL[dtype]
    assert all(np.isfinite(t_losses))
    np.testing.assert_allclose(t_losses, j_losses, rtol=tol)
    for tree, got_tree in ((jp, tp), (js, ts)):
        for key, leaves in jax.tree.map(np.asarray, tree).items():
            scale = max(float(np.abs(v).max()) for v in leaves.values())
            for leaf, want in leaves.items():
                got = got_tree[key][leaf]
                assert got.dtype == torch.float32, (key, leaf)
                _close(got.numpy(), want, tol, f"{key}.{leaf}", scale)
    # the running statistics moved off their initial values
    assert float(ts["bn1"]["mean"].abs().max()) > 0


def test_densenet121_graph_matches_jax(machine1, pallas_on):  # noqa: F811
    jm = j_densenet.build_densenet121(JConfig(batch_size=2), machine1)
    tm = t_densenet.build_densenet121(TConfig(batch_size=2), device="cpu")
    assert [(op.name, type(op).__name__, op.output.shape)
            for op in tm.layers] == \
        [(op.name, type(op).__name__, op.output.shape) for op in jm.layers]
    jp, js = jm.init(0, abstract=True)
    tp, ts = tm.init(0)

    def shapes(tree):
        return {k: {leaf: tuple(v.shape) for leaf, v in sub.items()}
                for k, sub in tree.items()}

    assert shapes(tp) == shapes(jp)
    assert shapes(ts) == shapes(js)
    assert len(ts) == 117 and all(
        v.dtype == torch.float32 for sub in ts.values() for v in sub.values())
    assert all(bool((ts[k]["mean"] == 0).all() and (ts[k]["var"] == 1).all())
               for k in ts)
    # at batch 2 dense4's 2x7x7 rows leave the gate: JAX's XLA form
    bns = [op for op in tm.layers if isinstance(op, BatchNorm)]
    routed = {op.name for op in bns if op.kernel_route()}
    assert routed == {op.name for op in bns
                      if not op.name.startswith("dense4")}


def test_densenet121_routes_every_bn_to_the_kernels_at_batch_64():
    tm = t_densenet.build_densenet121(TConfig(batch_size=64), device="cpu")
    bns = [op for op in tm.layers if isinstance(op, BatchNorm)]
    assert len(bns) == 117 and all(op.kernel_route() for op in bns)
    assert sum(op.inputs[0].shape[0] * op.inputs[0].shape[1]
               * op.inputs[0].shape[2] * op.inputs[0].shape[3]
               for op in bns) == 909590528   # elements per pass of 9 or 10
    pools = {op.name: op.kernel_route() for op in tm.layers
             if type(op).__name__ == "Pool2D"}
    assert pools == {"pool1": "maxpool", "trans1_pool": "avgpool",
                     "trans2_pool": "avgpool", "trans3_pool": "avgpool",
                     "pool2": "avgpool"}


def test_cnn_app_densenet_flags():
    for name in ("densenet", "densenet121"):
        model, cfg, device, warmup = t_cnn.parse(
            [name, "-b", "64", "-i", "13", "--warmup", "3", "--dtype",
             "bfloat16", "--device", "cpu"])
        assert (model, device, warmup) == (name, "cpu", 3)
        assert (cfg.batch_size, cfg.num_iterations, cfg.compute_dtype,
                cfg.param_dtype, cfg.input_height, cfg.input_width,
                cfg.num_classes) == (64, 13, "bfloat16", "float32", 224, 224,
                                     1000)
    with pytest.raises(NotImplementedError, match="not ported"):
        t_cnn.parse(["densenet", "--fleet-quantum", "2"])
    # the kernel policy parses at the one value the port runs
    assert t_cnn.parse(["densenet", "--pallas", "on"])[1] == \
        t_cnn.parse(["densenet"])[1]
    with pytest.raises(SystemExit, match="refused by flexflow_tpu_torch"):
        t_cnn.parse(["densenet", "--pallas", "auto"])


def test_cnn_app_densenet_prints_the_metric_line():
    lines = []
    out = t_cnn.main(["densenet", "-b", "1", "-i", "2", "--height", "221",
                      "--width", "221", "--device", "cpu", "-p", "1"],
                     log=lines.append)
    assert lines[0].startswith("densenet: 303 layers, batch 1, 221x221")
    assert any(line.startswith("time = ") and line.endswith(" images/s")
               for line in lines), lines
    assert len(out["loss"]) == 2 and all(np.isfinite(out["loss"]))
    assert out["images_per_sec"] > 0
