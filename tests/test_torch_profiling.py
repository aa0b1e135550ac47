"""``--profiling`` and ``--trace-dir`` in the PyTorch port, on the CPU:

* ``OpProfiler``'s rows (op names, kinds, grids, output shapes, modeled
  GFLOP, which shards are timed and which take the analytic ``~``
  estimate) equal the JAX package's for a small CNN and a small causal
  LM; ``report`` prints JAX's columns;
* ``trace`` writes a Chrome trace of what ran inside it;
* ``apps.lm --profiling --trace-dir T`` logs the step roofline and a
  row for every op, writes the trace, and gives losses bit-equal to the
  run without the flags; ``step_roofline`` names no MFU off the card.
"""

import json
import os

import numpy as np
import pytest
import torch

from flexflow_tpu.config import FFConfig as JConfig
from flexflow_tpu.model import FFModel as JModel
from flexflow_tpu.models.transformer import TransformerConfig as JTConfig
from flexflow_tpu.models.transformer import TransformerLM as JLM
from flexflow_tpu.utils.profiling import OpProfiler as JProfiler
from flexflow_tpu_torch.apps import lm as t_lm
from flexflow_tpu_torch.config import FFConfig as TConfig
from flexflow_tpu_torch.model import FFModel as TModel
from flexflow_tpu_torch.models.transformer import TransformerConfig
from flexflow_tpu_torch.models.transformer import TransformerLM
from flexflow_tpu_torch.utils.profiling import (OpProfiler, step_roofline,
                                                trace)

torch.set_num_threads(2)

LM = dict(batch_size=2, seq_length=16, num_layers=1, d_model=16,
          num_heads=2, d_ff=32, vocab_size=64, causal=True)
LM_ARGV = ["--causal", "-b", "2", "-s", "16", "-l", "1", "--d-model", "16",
           "--heads", "2", "--d-ff", "32", "--vocab", "64", "-i", "3",
           "--device", "cpu"]


def _small_cnn(ff):
    """A convolution, a max pool, a linear and the softmax at 16x16."""
    img = ff.create_input((2, 16, 16, 3), name="image")
    t = ff.conv2d("conv1", img, 8, 3, 3, 1, 1, 1, 1, relu=True)
    t = ff.pool2d("pool1", t, 2, 2, 2, 2, 0, 0)
    t = ff.flat("flat", t)
    t = ff.linear("fc", t, 8, relu=False)
    ff.softmax("softmax", t)
    return ff


def _cnns(machine1):
    kw = dict(batch_size=2, input_height=16, input_width=16, num_classes=8)
    return (_small_cnn(JModel(JConfig(**kw), machine1)),
            _small_cnn(TModel(TConfig(**kw), device="cpu")))


def _rows(rows):
    return [(r.name, r.kind, tuple(r.grid), tuple(r.out_shape)) for r in rows]


@pytest.mark.parametrize("model", ["cnn", "lm"])
def test_op_profiler_rows_match_jax(machine1, model):
    if model == "cnn":
        jm, tm = _cnns(machine1)
    else:
        jm = JLM(JTConfig(**LM), machine1)
        tm = TransformerLM(TransformerConfig(**LM), device="cpu")
    jrows = JProfiler(jm, repeats=1).profile()
    rows = OpProfiler(tm, repeats=1).profile()
    assert _rows(rows) == _rows(jrows)
    np.testing.assert_allclose([r.gflops for r in rows],
                               [r.gflops for r in jrows], rtol=1e-9)
    assert all(r.ms > 0 for r in rows)
    # each column follows its own rule: the port times exactly the ops
    # with a local shard; JAX's MeasuredCostModel._measure falls back to
    # the analytic row where its median timing slope is not positive,
    # which one pair of timings (repeats=1) decides under the host's
    # load, so JAX's row is measured only where the port's rule holds
    rule = [op.local_clone(op.pc) is not None for op in tm.layers]
    assert [r.measured for r in rows] == rule
    assert all(rule[i] for i, r in enumerate(jrows) if r.measured)
    assert any(r.measured for r in rows)
    report = OpProfiler(tm).report(rows)
    lines = report.splitlines()
    assert lines[0].split() == ["op", "kind", "grid", "shard", "ms",
                                "GFLOP", "TFLOP/s", "%"]
    assert len(lines) == len(rows) + 2
    assert lines[-1].startswith("total (isolated, one shard)")
    assert lines[-1].endswith("ms   [~ = analytic estimate]")


def test_trace_writes_a_chrome_trace(tmp_path):
    with trace(str(tmp_path / "t")):
        torch.ones(64, 64).matmul(torch.ones(64, 64)).sum()
    (path,) = (tmp_path / "t").iterdir()
    assert path.name == f"trace_{os.getpid()}.json"
    events = json.loads(path.read_text())["traceEvents"]
    assert any(e.get("name") == "aten::matmul" for e in events)


def test_lm_app_profiles_and_traces_bit_equal(tmp_path):
    plain = t_lm.main(LM_ARGV, log=lambda *a: None)["loss"]
    lines = []
    out = t_lm.main(LM_ARGV + ["--profiling", "--trace-dir",
                               str(tmp_path)], log=lines.append)
    assert out["loss"] == plain
    roof = [line for line in lines if line.startswith("step roofline")]
    assert len(roof) == 1 and "MFU not measured (cpu)" in roof[0]
    tm = TransformerLM(TransformerConfig(**LM), device="cpu")
    table = lines[lines.index(roof[0]) + 1].splitlines()
    assert [line.split()[0] for line in table[1:-1]] == \
        [op.name for op in tm.layers]
    assert len(os.listdir(tmp_path)) == 1


def test_step_roofline_names_no_mfu_off_the_card():
    cpu = step_roofline(2e12, 0.5, "float32", torch.device("cpu"))
    assert cpu == {"flops": 2e12, "achieved_tflops": 4.0}
    card = step_roofline(2e12, 0.5, "bfloat16", torch.device("cuda", 0),
                         n_devices=2)
    assert card["peak_tflops"] == pytest.approx(2 * 989.0)
    assert card["mfu"] == pytest.approx(4.0 / (2 * 989.0))
    assert card["min_step_seconds_at_peak"] == pytest.approx(2e12 / 1.978e15)
