"""The ResNet-101 and VGG-16 slice against the JAX package, on the CPU.

* Three momentum-SGD steps (``make_train_step``) of a mini ResNet — a
  3x3 stem, ``pool1`` 3x3/2 pad 1, a bottleneck block that keeps the
  shape and one of stride 2, the global avg pool and a 10-way linear,
  at batch 4 and 32x32 — built from each package's own
  ``bottleneck_block``, with ``residual`` False (the reference's plain
  stack) and True (the ``Add`` op with an identity and a projection
  shortcut); and of a mini VGG (two conv-conv-pool 2x2/2 blocks, then
  two linears).  The JAX params are carried over with
  ``params_from_jax``; JAX runs with ``FFConfig(pallas="on")``, so both
  sides take kernels 7 and 8 (interpret mode there, the plain versions
  here through the same autograd functions as on the card).
* Full ResNet-101 (both ``residual`` settings) and VGG-16 graphs at batch
  2 against JAX's: op names, types, output shapes, param leaves and their
  shapes, from the abstract JAX init; their pools' kernel routes.
* The ``apps.cnn vgg16`` and ``resnet101`` entry points: their flags,
  and one step with the metric line on the CPU at batch 1 (VGG-16 at
  32x32, its smallest input; ResNet-101 at 224x224, about a second on
  two threads).

Tolerances: float32 losses within 1e-4 relative and every final
parameter leaf within 1e-4 of the largest magnitude among its op's
leaves (the same arithmetic summed in another order); bfloat16 compute
within 2e-2 on both, the bar of tests/test_torch_train.py.
"""

import jax
import numpy as np
import pytest
import torch
from test_torch_train import _close, pallas_on  # noqa: F401

from flexflow_tpu.config import FFConfig as JConfig
from flexflow_tpu.model import FFModel as JModel
from flexflow_tpu.models import resnet as j_resnet
from flexflow_tpu.models import vgg as j_vgg
from flexflow_tpu_torch.apps import cnn as t_cnn
from flexflow_tpu_torch.config import FFConfig as TConfig
from flexflow_tpu_torch.interop import params_from_jax
from flexflow_tpu_torch.model import FFModel as TModel
from flexflow_tpu_torch.models import resnet as t_resnet
from flexflow_tpu_torch.models import vgg as t_vgg
from flexflow_tpu_torch.ops.elementwise import Add
from flexflow_tpu_torch.ops.pool import Pool2D

torch.set_num_threads(2)

STEPS = 3
TOL = {"float32": 1e-4, "bfloat16": 2e-2}
BATCH, SIZE, CLASSES = 4, 32, 10


def mini_resnet(ff, image, blocks, residual):
    """A downsized ResNet from ``blocks`` (either package's
    ``bottleneck_block``): block a keeps the 16x16x16 shape (an identity
    shortcut), block b halves the map to 8x8x32 (a projection)."""
    t = ff.conv2d("conv1", image, 16, 3, 3, 1, 1, 1, 1, relu=True)
    t = ff.pool2d("pool1", t, 3, 3, 2, 2, 1, 1)
    t = blocks.bottleneck_block(ff, "res_a", t, 16, 8, 1, residual)
    t = blocks.bottleneck_block(ff, "res_b", t, 32, 8, 2, residual)
    t = ff.pool2d("pool2", t, 8, 8, 1, 1, 0, 0, pool_type="avg",
                  relu=False)
    t = ff.flat("flat", t)
    t = ff.linear("linear1", t, CLASSES, relu=False)
    return ff.softmax("softmax", t)


def mini_vgg(ff, image, blocks=None, residual=None):
    t = image
    for bi, ch in enumerate((8, 16)):
        for r in range(2):
            t = ff.conv2d(f"conv{2 * bi + r + 1}", t, ch, 3, 3, 1, 1, 1, 1,
                          relu=True)
        t = ff.pool2d(f"pool{bi + 1}", t, 2, 2, 2, 2, 0, 0)
    t = ff.flat("flat", t)
    t = ff.linear("linear1", t, 32)
    t = ff.linear("linear2", t, CLASSES, relu=False)
    return ff.softmax("softmax", t)


def _cfg(cls, dtype, **kw):
    return cls(batch_size=BATCH, input_height=SIZE, input_width=SIZE,
               num_classes=CLASSES, compute_dtype=dtype, learning_rate=1e-2,
               momentum=0.9, seed=3, **kw)


def _build(ff, layers, blocks, residual):
    image = ff.create_input((BATCH, SIZE, SIZE, 3), name="image")
    layers(ff, image, blocks, residual)
    return ff


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("model,residual", [("resnet", False),
                                            ("resnet", True),
                                            ("vgg", None)])
def test_three_steps_match_jax(machine1, pallas_on, dtype, model,  # noqa: F811
                               residual):
    layers = mini_resnet if model == "resnet" else mini_vgg
    jm = _build(JModel(_cfg(JConfig, dtype, pallas="on"), machine1), layers,
                j_resnet, residual)
    tm = _build(TModel(_cfg(TConfig, dtype), device="cpu"), layers,
                t_resnet, residual)
    assert [(op.name, type(op).__name__, op.output.shape)
            for op in tm.layers] == \
        [(op.name, type(op).__name__, op.output.shape) for op in jm.layers]
    adds = [op.name for op in tm.layers if isinstance(op, Add)]
    projs = [op.name for op in tm.layers if op.name.endswith("_proj")]
    if residual:
        assert adds == ["res_a_add", "res_b_add"] and projs == ["res_b_proj"]
    else:
        assert adds == [] and projs == []
    pools = {op.name: op.kernel_route() for op in tm.layers
             if isinstance(op, Pool2D)}
    assert pools == ({"pool1": "maxpool", "pool2": "avgpool"}
                     if model == "resnet"
                     else {"pool1": "maxpool", "pool2": "maxpool"})
    jp, js = jm.init(0)
    tp = params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    jopt, topt = jm.init_opt_state(jp), tm.init_opt_state(tp)
    jstep, tstep = jm.make_train_step(), tm.make_train_step()
    rng = np.random.RandomState(11)
    ts = {}
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
    for key, leaves in jax.tree.map(np.asarray, jp).items():
        scale = max(float(np.abs(v).max()) for v in leaves.values())
        for leaf, want in leaves.items():
            got = tp[key][leaf]
            assert got.dtype == torch.float32, (key, leaf)
            _close(got.numpy(), want, tol, f"{key}.{leaf}", scale)
    # the head's bias gradient (softmax - onehot) is never zero
    assert float(tp["linear1"]["bias"].abs().max()) > 0


def _shapes(tree):
    return {k: {leaf: tuple(v.shape) for leaf, v in sub.items()}
            for k, sub in tree.items()}


def _graph(model):
    return [(op.name, type(op).__name__, op.output.shape)
            for op in model.layers]


@pytest.mark.parametrize("residual", [False, True])
def test_resnet101_graph_matches_jax(machine1, pallas_on,  # noqa: F811
                                     residual):
    jm = j_resnet.build_resnet101(JConfig(batch_size=2), machine1, residual)
    tm = t_resnet.build_resnet101(TConfig(batch_size=2), residual=residual,
                                  device="cpu")
    assert _graph(tm) == _graph(jm)
    assert _shapes(tm.init(0)[0]) == _shapes(jm.init(0, abstract=True)[0])
    convs = [op for op in tm.layers if type(op).__name__ == "Conv2D"]
    adds = [op for op in tm.layers if isinstance(op, Add)]
    # 1 stem + 33 blocks x 3, and the 4 projections of the real ResNet
    assert (len(convs), len(adds)) == ((104, 33) if residual else (100, 0))
    pools = {op.name: (op.kernel_route(), op.inputs[0].shape)
             for op in tm.layers if isinstance(op, Pool2D)}
    assert pools == {"pool1": ("maxpool", (2, 112, 112, 64)),
                     "pool2": ("avgpool", (2, 7, 7, 2048))}
    assert tm.layers[-2].inputs[0].shape == (2, 2048)


def test_vgg16_graph_matches_jax(machine1, pallas_on):  # noqa: F811
    jm = j_vgg.build_vgg16(JConfig(batch_size=2), machine1)
    tm = t_vgg.build_vgg16(TConfig(batch_size=2), device="cpu")
    assert _graph(tm) == _graph(jm)
    assert _shapes(tm.init(0)[0]) == _shapes(jm.init(0, abstract=True)[0])
    pools = {op.name: (op.kernel_route(), op.relu, op.inputs[0].shape)
             for op in tm.layers if isinstance(op, Pool2D)}
    assert pools == {f"pool{i + 1}": ("maxpool", True, (2, s, s, c))
                     for i, (s, c) in enumerate(
                         [(224, 64), (112, 128), (56, 256), (28, 512),
                          (14, 512)])}
    assert tm.layers[-4].inputs[0].shape == (2, 25088)


@pytest.mark.parametrize("name", ["vgg16", "vgg", "resnet101", "resnet"])
def test_cnn_app_resnet_vgg_flags(name):
    model, cfg, device, warmup = t_cnn.parse(
        [name, "-b", "64", "-i", "13", "--warmup", "3", "--dtype",
         "bfloat16", "--device", "cpu"])
    assert (model, device, warmup) == (name, "cpu", 3)
    assert (cfg.batch_size, cfg.num_iterations, cfg.compute_dtype,
            cfg.param_dtype, cfg.input_height, cfg.input_width,
            cfg.num_classes, cfg.learning_rate, cfg.weight_decay) == \
        (64, 13, "bfloat16", "float32", 224, 224, 1000, 0.01, 1e-4)
    ff = t_cnn.build(model, TConfig(batch_size=1), torch.device("cpu"))
    assert len(ff.layers) == (105 if model.startswith("resnet") else 23)
    with pytest.raises(NotImplementedError, match="not ported"):
        t_cnn.parse([name, "--fleet-quantum", "2"])
    # the kernel policy parses at the one value the port runs
    assert t_cnn.parse([name, "--pallas", "on"])[1] == \
        t_cnn.parse([name])[1]
    with pytest.raises(SystemExit, match="refused by flexflow_tpu_torch"):
        t_cnn.parse([name, "--pallas", "off"])


@pytest.mark.parametrize("argv,header", [
    (["vgg16", "--height", "32", "--width", "32"],
     "vgg16: 23 layers, batch 1, 32x32"),
    (["resnet101"], "resnet101: 105 layers, batch 1, 224x224"),
])
def test_cnn_app_resnet_vgg_print_the_metric_line(argv, header):
    lines = []
    out = t_cnn.main(argv + ["-b", "1", "-i", "1", "--device", "cpu"],
                     log=lines.append)
    assert lines[0].startswith(header)
    assert any(line.startswith("time = ") and line.endswith(" images/s")
               for line in lines), lines
    assert len(out["loss"]) == 1 and all(np.isfinite(out["loss"]))
    assert out["images_per_sec"] > 0
