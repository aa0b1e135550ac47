"""The NMT trainer's runtime flags and the decomposed re-search in the
PyTorch port, against the JAX package, on the CPU.

* Every flag of ``fit``'s runtime, supervision, elastic and telemetry
  sets that the JAX NMT driver parses (``apps.nmt.NMT_RUNTIME_FLAGS``)
  parses into JAX's ``RnnConfig`` field with JAX's value, and
  ``RnnModel`` hands it to ``FFConfig``.
* A tiny NMT (batch 4, 2 layers, seq 6, chunks of 3, hidden 16, embed
  12, vocab 64) under ``--ckpt-dir``, ``--on-divergence rollback`` and
  ``--fault-spec loss_nan@3`` from JAX's parameters: JAX's losses
  (1e-4), rollbacks and guard records; and a run resumed from its
  checkpoint bit-equal to the uninterrupted run.
* ``research_strategy`` under ``--decompose`` on the JAX package's chip
  constants: JAX's strategy and ``info``.
"""

import jax
import numpy as np
import pytest
import torch

import torch_ranks as tr
import torch_sim_parity as sp
from flexflow_tpu.apps import nmt as j_nmt
from flexflow_tpu.config import FFConfig as JConfig
from flexflow_tpu.data import synthetic_token_stream as j_tokens
from flexflow_tpu.nmt.rnn_model import RnnConfig as JRnnConfig
from flexflow_tpu.nmt.rnn_model import RnnModel as JRnnModel
from flexflow_tpu.obs import read_run as j_read_run
from flexflow_tpu.utils import elastic as j_elastic
from flexflow_tpu_torch.apps import nmt as t_nmt
from flexflow_tpu_torch.config import FFConfig
from flexflow_tpu_torch.interop import params_from_jax
from flexflow_tpu_torch.nmt.rnn_model import RnnConfig as TRnnConfig
from flexflow_tpu_torch.nmt.rnn_model import RnnModel as TRnnModel
from flexflow_tpu_torch.nmt.rnn_model import synthetic_token_batches
from flexflow_tpu_torch.obs import read_run
from flexflow_tpu_torch.utils import elastic

torch.set_num_threads(2)

SMALL = dict(batch_size=4, num_layers=2, seq_length=6, hidden_size=16,
             embed_size=12, vocab_size=64, lstm_per_node_length=3, seed=3)
VALUES = {"-on-divergence": "rollback", "--on-divergence": "rollback",
          "-fault-spec": "loss_nan@3", "--fault-spec": "loss_nan@3"}
#: the records of the health guard and the checkpoints, with the fields
#: both packages write alike
GUARD = {"fault": ("source", "fault"), "rollback": ("to_step",),
         "recovery": ("source", "after"), "checkpoint_save": ("step",)}


@pytest.mark.parametrize("flag", sorted(t_nmt.NMT_RUNTIME_FLAGS))
def test_nmt_runtime_flags_parse_as_jax(flag):
    field = t_nmt.NMT_RUNTIME_FLAGS[flag][0]
    switch = flag in ("--elastic", "--ckpt-async", "--decompose")
    argv = [flag] if switch else [flag, VALUES.get(flag, "5")]
    want = getattr(j_nmt.parse_args(argv), field)
    assert want != getattr(JRnnConfig(), field)
    cfg, _, _, _ = t_nmt.parse_args(argv)
    assert getattr(cfg, field) == want
    assert getattr(TRnnModel(cfg, device="cpu").config, field) == want


def _jmodel(machine1, **kw):
    return JRnnModel(JRnnConfig(**SMALL, **kw), machine1)


def _tmodel(jm, **kw):
    """The port's model, its initial params JAX's ``jm``'s."""
    tm = TRnnModel(TRnnConfig(**SMALL, **kw), device="cpu")
    jp, _ = jm.init()
    p = params_from_jax(jax.tree.map(np.asarray, jp), "cpu", model=tm)
    tm.init = lambda seed=None: (p, {})
    return tm


def _guard_records(records):
    return [(e["kind"],) + tuple(e.get(k) for k in GUARD[e["kind"]])
            for e in records if e["kind"] in GUARD]


def test_tiny_nmt_rolls_back_as_jax(machine1, tmp_path):
    kw = dict(num_iterations=6, ckpt_freq=2, on_divergence="rollback",
              fault_spec="loss_nan@3", run_id="r")
    jm = _jmodel(machine1, ckpt_dir=str(tmp_path / "jck"),
                 obs_dir=str(tmp_path / "jobs"), **kw)
    tm = _tmodel(jm, ckpt_dir=str(tmp_path / "tck"),
                 obs_dir=str(tmp_path / "tobs"), **kw)
    want = jm.fit(j_tokens(machine1, 4, 6, 64, 3, streams=2),
                  log=lambda *a: None)
    got = tm.fit(synthetic_token_batches(4, 6, 64, seed=3, device="cpu"),
                 log=lambda *a: None)
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-4)
    assert got["rollbacks"] == want["rollbacks"] == 1
    assert len(got["loss"]) == 6 and all(np.isfinite(got["loss"]))
    trec = _guard_records(read_run(got["obs_path"]))
    assert trec == _guard_records(j_read_run(want["obs_path"]))
    assert ("rollback", 2) in trec


def test_tiny_nmt_resumes_bit_equal(tmp_path):
    def run(iters, ckpt):
        m = TRnnModel(TRnnConfig(**SMALL, num_iterations=iters,
                                 ckpt_dir=ckpt, ckpt_freq=2), device="cpu")
        return m.fit(synthetic_token_batches(4, 6, 64, seed=3,
                                             device="cpu"),
                     log=lambda *a: None)["loss"]

    whole = run(6, str(tmp_path / "whole"))
    cut = str(tmp_path / "cut")
    assert run(4, cut) == whole[:4]
    assert run(6, cut) == whole[4:]


@pytest.fixture
def jax_constants(monkeypatch):
    """The port's search on the JAX package's chip constants."""
    from flexflow_tpu_torch.sim import cost_model

    perf = sp.jax_perf()
    monkeypatch.setattr(cost_model, "HopperChipPerf", lambda: perf)


def _jbuild(cfg, machine):
    from flexflow_tpu.model import FFModel as JModel

    ff = JModel(cfg, machine)
    img = ff.create_input((cfg.batch_size, 16, 16, 3), name="image")
    t = ff.conv2d("conv1", img, 8, 3, 3, 1, 1, 1, 1, relu=True)
    t = ff.flat("flat", t)
    t = ff.linear("fc", t, 8, relu=False)
    ff.softmax("softmax", t)
    return ff


def test_decomposed_research_matches_jax(jax_constants):
    jm8, tm8 = sp.machines(8)
    jm6, tm6 = jm8.shrink(range(6)), tm8.shrink(range(6))
    kw = dict(batch_size=tr.ELASTIC_BATCH, input_height=16, input_width=16,
              num_classes=8, seed=3, research_budget_s=1e6,
              elastic_search_iters=300, decompose=True,
              boundary_refine_iters=40)
    got, info = elastic.research_strategy(
        FFConfig(**kw), tr.elastic_build, tm6, None, log=lambda *a: None)
    want, jinfo = j_elastic.research_strategy(
        JConfig(**kw), _jbuild, jm6, None, log=lambda *a: None)
    assert got.to_json() == want.to_json()
    keys = ("mode", "iters", "budget_hit", "budget_s", "blocks",
            "memo_hits", "objective")
    assert {k: info[k] for k in keys} == {k: jinfo[k] for k in keys}
    assert info["mode"] == "mcmc_decomposed" and info["blocks"] >= 1
    assert info["best_time_s"] == pytest.approx(jinfo["best_time_s"],
                                                rel=1e-9)
    # without --decompose the same call takes the flat search
    _, finfo = elastic.research_strategy(
        FFConfig(**dict(kw, decompose=False)), tr.elastic_build, tm6, None,
        log=lambda *a: None)
    assert finfo["mode"] == "mcmc"
