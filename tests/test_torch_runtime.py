"""The training runtime's supervision in the PyTorch port against the JAX
package, on the CPU: the asynchronous checkpoint writer
(``utils/checkpoint.py``), the step watchdog and the guard's records
(``utils/health.py``), the fatal device faults and the preemption drain
(``utils/elastic.py``, ``FFModel.fit``), ``distributed.release`` and the
new flags.

The models are ``tests/test_trace.py``'s tiny CNN in both packages from
one parameter tree (``params_from_jax``) and a 2-layer MoE LM.
Checkpoints are compared as files, byte for byte (``np.savez`` stamps
every member with one fixed date).

Tolerances: checkpoint files and the port's losses with and without the
supervision are compared exactly; records are compared field for field
without their times and paths.
"""

import json
import math
import os
import signal
import threading

import jax
import numpy as np
import pytest
import torch

import torch_ranks as tr
from flexflow_tpu.config import FFConfig as JConfig
from flexflow_tpu.model import FFModel as JModel
from flexflow_tpu.obs import read_run as j_read_run
from flexflow_tpu.utils import checkpoint as j_ckpt
from flexflow_tpu.utils import elastic as j_elastic
from flexflow_tpu.utils.health import StepWatchdog as JWatchdog
from flexflow_tpu_torch import distributed
from flexflow_tpu_torch.apps import cnn as t_cnn
from flexflow_tpu_torch.apps import lm as t_lm
from flexflow_tpu_torch.config import (ELASTIC_FLAGS, RUNTIME_FLAGS,
                                       FFConfig)
from flexflow_tpu_torch.interop import params_from_jax
from flexflow_tpu_torch.model import FFModel
from flexflow_tpu_torch.models.transformer import (TransformerConfig,
                                                   TransformerLM)
from flexflow_tpu_torch.obs import read_run
from flexflow_tpu_torch.utils import checkpoint as ckpt
from flexflow_tpu_torch.utils import elastic
from flexflow_tpu_torch.utils.health import StepWatchdog

torch.set_num_threads(2)

CNN = dict(batch_size=8, input_height=16, input_width=16, num_iterations=6,
           print_freq=2, num_classes=8, learning_rate=1e-3, momentum=0.9,
           seed=3)
#: fields of a record that differ between any two runs
VOLATILE = {"run", "ts", "surface", "seconds", "dir", "error", "commit_s",
            "estimate_s"}


class _Log:
    """An obs sink that keeps its records."""

    enabled = True
    run_id = path = None

    def __init__(self):
        self.records = []

    def event(self, kind, **fields):
        self.records.append(dict(fields, kind=kind))

    def close(self):
        pass


def _batches(n=8, seed=7):
    rng = np.random.RandomState(seed)
    ring = [(rng.randn(8, 16, 16, 3).astype("float32"),
             rng.randint(0, 8, size=8).astype("int32")) for _ in range(4)]
    return iter([ring[i % 4] for i in range(n)])


def _jax_cnn(machine1, **kw):
    jm = JModel(JConfig(**dict(CNN, prefetch_depth=0, **kw)),
                machine=machine1)
    tr.trace_cnn(jm, jm.create_input((8, 16, 16, 3), name="image"))
    return jm


def _port_cnn(jm, **kw):
    """The port's CNN from the JAX model's initial tree."""
    tm = FFModel(FFConfig(**dict(CNN, **kw)), device="cpu")
    tr.trace_cnn(tm, tm.create_input((8, 16, 16, 3), name="image"))
    jp, _ = jm.init(CNN["seed"])
    params = params_from_jax(jax.tree.map(np.asarray, jp), "cpu", model=tm)
    tm.init = lambda seed=None: (params, {})
    return tm


def _fit(model, log=None, **kw):
    return model.fit(_batches(**kw), log=log or (lambda *a: None))


def _records(path, kinds):
    read = j_read_run if "jax" in str(path) else read_run
    return [{k: v for k, v in r.items() if k not in VOLATILE}
            for r in read(path) if r["kind"] in kinds]


def _np_trees(seed=0):
    rng = np.random.RandomState(seed)
    params = {"fc": {"kernel": rng.randn(8, 8).astype("float32"),
                     "bias": rng.randn(8).astype("float32"),
                     "ids": np.arange(6, dtype=np.int32)}}
    state = {"bn": {"mean": rng.randn(4).astype("float32")}}
    opt = {"fc": {"kernel": np.zeros((8, 8), "float32"),
                  "bias": np.zeros((8,), "float32")}}
    return params, state, opt


def _torch(tree, dtype=None):
    return {k: {leaf: (torch.from_numpy(v).to(dtype)
                       if dtype is not None and v.dtype == np.float32
                       else torch.from_numpy(v.copy()))
                for leaf, v in sub.items()}
            for k, sub in tree.items()}


def _files(d, step):
    """``{name: bytes}`` of one committed step."""
    sd = os.path.join(d, f"step_{step:08d}")
    out = {}
    for name in sorted(os.listdir(sd)):
        with open(os.path.join(sd, name), "rb") as f:
            out[name] = f.read()
    return out


def _write_async(d, step, *trees, olog=None):
    w = ckpt.AsyncCheckpointWriter(olog=olog)
    try:
        w.submit(d, step, *trees)
        assert w.wait(timeout=30.0)
    finally:
        w.close()
    return w


# ---------------------------------------------------------------------------
# the asynchronous writer (tests/test_elastic.py:233-340)


def test_async_writer_bit_identical_to_sync_and_jax(tmp_path):
    params, state, opt = _np_trees()
    t = [_torch(x) for x in (params, state, opt)]
    ckpt.save_checkpoint(str(tmp_path / "sync"), 5, *t)
    j_ckpt.save_checkpoint(str(tmp_path / "jax"), 5, params, state, opt)
    w = _write_async(str(tmp_path / "async"), 5, *t)
    assert (w.saves, w.faults, w.inflight, w.last_step) == (1, 0, 0, 5)
    assert ckpt.verify_checkpoint(str(tmp_path / "async"), 5) == (True, "ok")
    want = _files(str(tmp_path / "sync"), 5)
    assert set(want) == {"arrays.npz", "meta.json"}
    assert _files(str(tmp_path / "async"), 5) == want
    assert _files(str(tmp_path / "jax"), 5) == want
    # bfloat16 leaves (raw bits in both of the port's writers)
    b = [_torch(x, torch.bfloat16) for x in (params, state, opt)]
    ckpt.save_checkpoint(str(tmp_path / "bsync"), 1, *b)
    _write_async(str(tmp_path / "basync"), 1, *b)
    assert _files(str(tmp_path / "basync"), 1) == \
        _files(str(tmp_path / "bsync"), 1)


def test_async_writer_snapshot_isolates_mutation(tmp_path, monkeypatch):
    """The snapshot is taken at submit: a leaf changed afterwards, while
    the write has not started, does not reach the commit."""
    gate = threading.Event()
    real = ckpt.save_checkpoint

    def gated(*args, **kwargs):
        assert gate.wait(timeout=30.0)
        return real(*args, **kwargs)

    monkeypatch.setattr(ckpt, "save_checkpoint", gated)
    params, state, opt = (_torch(x) for x in _np_trees())
    expect = params["fc"]["kernel"].clone()
    w = ckpt.AsyncCheckpointWriter()
    try:
        w.submit(str(tmp_path), 1, params, state, opt)
        assert w.inflight == 1 and not w.wait(timeout=0.05)
        params["fc"]["kernel"].fill_(-1.0)   # after the submit
        gate.set()
        assert w.wait(timeout=30.0)
    finally:
        w.close()
    _, p, _, _ = ckpt.restore_checkpoint(str(tmp_path), device="cpu")
    assert torch.equal(p["fc"]["kernel"], expect)


def test_async_crash_before_commit_leaves_only_swept_tmp(tmp_path,
                                                         monkeypatch):
    params, state, opt = (_torch(x) for x in _np_trees())
    d = str(tmp_path)
    # a torn write: the staging directory exists, no committed step
    os.makedirs(os.path.join(d, "tmp.3"))
    with open(os.path.join(d, "tmp.3", "arrays.npz"), "wb") as f:
        f.write(b"torn")
    assert ckpt.latest_step(d) is None
    # the worker dies at the commit's rename: a fault, nothing committed
    real_rename = os.rename

    def no_rename(src, dst):
        if os.path.basename(src).startswith("tmp."):
            raise OSError("killed before the commit")
        return real_rename(src, dst)

    monkeypatch.setattr(os, "rename", no_rename)
    olog = _Log()
    w = _write_async(d, 4, params, state, opt, olog=olog)
    monkeypatch.setattr(os, "rename", real_rename)
    assert (w.saves, w.faults) == (0, 1)
    assert [(r["kind"], r["source"], r["fault"], r["step"])
            for r in olog.records] == \
        [("fault", "checkpoint", "async_save_failed", 4)]
    assert sorted(os.listdir(d)) == ["tmp.4"] and ckpt.latest_step(d) is None
    # the next save sweeps it and commits
    _write_async(d, 5, params, state, opt)
    assert sorted(os.listdir(d)) == ["step_00000005"]


def test_async_writer_nonfinite_counts_a_fault(tmp_path):
    params, state, opt = _np_trees()
    params["fc"]["kernel"][0, 0] = np.nan
    olog, jlog = _Log(), _Log()
    w = _write_async(str(tmp_path / "t"), 2,
                     *(_torch(x) for x in (params, state, opt)), olog=olog)
    jw = j_ckpt.AsyncCheckpointWriter(olog=jlog)
    try:
        jw.submit(str(tmp_path / "j"), 2, params, state, opt)
        assert jw.wait(timeout=30.0)
    finally:
        jw.close()
    assert (w.faults, w.saves) == (jw.faults, jw.saves) == (1, 0)
    assert ckpt.latest_step(str(tmp_path / "t")) is None

    def fields(records):
        return [(r["kind"], r["source"], r["fault"], r["step"])
                for r in records]

    assert fields(olog.records) == fields(jlog.records) == \
        [("fault", "checkpoint", "nonfinite_state", 2)]


def _lm(**kw):
    cfg = dict(batch_size=2, seq_length=16, num_layers=2, d_model=16,
               num_heads=2, d_ff=32, vocab_size=64, causal=True,
               num_experts=4, learning_rate=0.1, num_iterations=6)
    return TransformerLM(TransformerConfig(**dict(cfg, **kw)), device="cpu")


def _lm_fit(model, log=None):
    return model.fit(t_lm.synthetic_lm_batches(2, 16, 64, seed=0,
                                               device="cpu"),
                     log=log or (lambda *a: None))


def test_fit_ckpt_async_writes_the_files_of_a_synchronous_fit(tmp_path):
    a = _lm_fit(_lm(ckpt_dir=str(tmp_path / "sync"), ckpt_freq=2))
    b = _lm_fit(_lm(ckpt_dir=str(tmp_path / "async"), ckpt_freq=2,
                    ckpt_async=True))
    assert a["loss"] == b["loss"]
    assert (a["ckpt_async_saves"], b["ckpt_async_saves"]) == (0, 3)
    assert [s for s, _ in b["ckpt_async"]["commits"]] == [2, 4, 6]
    assert len(b["ckpt_async"]["step_s"]) == 6
    assert ckpt._list_steps(str(tmp_path / "async")) == [2, 4, 6]
    for step in (2, 4, 6):
        assert _files(str(tmp_path / "async"), step) == \
            _files(str(tmp_path / "sync"), step), step


def test_healthy_supervision_leaves_the_losses(tmp_path):
    """The watchdog, the drain handler and the async writer together on a
    healthy run: the losses are the unsupervised run's, bit for bit, and
    no watchdog thread outlives fit."""
    plain = _lm_fit(_lm())
    out = _lm_fit(_lm(ckpt_dir=str(tmp_path), ckpt_freq=2,
                      ckpt_async=True, hang_factor=20.0, hang_min_s=60.0,
                      drain_budget_s=60.0,
                      metrics_path=str(tmp_path / "m" / "metrics.prom")))
    assert out["loss"] == plain["loss"] and "drained" not in out
    assert not [t.name for t in threading.enumerate()
                if t.name.startswith(("ff-step-watchdog", "ff-ckpt-async"))]
    assert signal.getsignal(signal.SIGTERM) is signal.SIG_DFL


# ---------------------------------------------------------------------------
# the watchdog and the fatal faults (tests/test_elastic_lifecycle.py:253,
# tests/test_elastic.py:192, 206)


def test_step_watchdog_unit_against_jax():
    assert not StepWatchdog(0.0).enabled
    got = {}
    for name, cls in (("port", StepWatchdog), ("jax", JWatchdog)):
        olog = _Log()
        wd = cls(2.0, min_deadline_s=0.15, olog=olog, log=lambda *a: None)
        for v in (0.01, 0.03, 0.02, 0.01):
            wd.observe(v)
        wd.observe(0.0)          # ignored
        wd.observe(0.08, steps=2)
        assert wd.step_estimate_s() == pytest.approx(0.02)
        assert wd.deadline_s() == pytest.approx(0.15)   # the floor
        wd.arm(5)
        assert wd.disarm() is None
        wd.arm(6)
        wd.stall(margin_s=0.1)
        info = wd.disarm()
        assert info is not None and info["step"] == 6 and wd.hangs == 1
        wd.close()
        got[name] = [{k: v for k, v in r.items() if k != "estimate_s"}
                     for r in olog.records], info
    assert got["port"] == got["jax"]
    assert got["port"][0] == [{"kind": "step_hang", "step": 6,
                               "deadline_s": 0.15, "factor": 2.0}]
    assert not [t.name for t in threading.enumerate()
                if t.name.startswith("ff-step-watchdog")]


@pytest.mark.parametrize("spec,error,match", [
    ("step_hang@2", "DeviceLostError", "exceeded the step watchdog "
                                       "deadline"),
    ("device_loss@3", "DeviceLostError", "permanent device loss at "
                                         "iteration 4"),
    ("host_crash@2", "HostCrashError", "injected host crash at "
                                       "iteration 2"),
])
def test_fatal_faults_match_jax(tmp_path, machine1, monkeypatch, spec,
                                error, match):
    released = []
    monkeypatch.setattr(distributed, "release",
                        lambda: released.append(True))
    # the floor sets the deadline: the step estimate (JAX's first step
    # compiles) is far below 0.2 s / 0.01
    kw = dict(fault_spec=spec, hang_factor=0.01, hang_min_s=0.2)
    jm = _jax_cnn(machine1, obs_dir=str(tmp_path / "jax"), run_id="j", **kw)
    with pytest.raises(getattr(j_elastic, error), match=match) as jerr:
        _fit(jm)
    tm = _port_cnn(jm, obs_dir=str(tmp_path / "port"), run_id="t", **kw)
    with pytest.raises(getattr(elastic, error), match=match) as terr:
        _fit(tm)
    assert str(terr.value) == str(jerr.value)
    assert released == [True]
    kinds = {"step_hang", "fault"}
    assert _records(tmp_path / "port" / "t.jsonl", kinds) == \
        _records(tmp_path / "jax" / "j.jsonl", kinds)
    assert not [t.name for t in threading.enumerate()
                if t.name.startswith("ff-step-watchdog")]


# ---------------------------------------------------------------------------
# the drain (tests/test_elastic_lifecycle.py:212-250, 401-450)


@pytest.mark.filterwarnings("ignore")
@pytest.mark.parametrize("with_ckpt", [True, False])
def test_preempt_drain_matches_jax_and_resumes(tmp_path, machine1,
                                               with_ckpt):
    kw = dict(fault_spec="preempt@3", drain_budget_s=30.0)
    if with_ckpt:
        kw.update(ckpt_freq=2, ckpt_async=True)
    runs = {}
    for name in ("jax", "port"):
        d = tmp_path / name
        cfg = dict(kw, obs_dir=str(d / "obs"), run_id="r",
                   ckpt_dir=str(d / "ckpt") if with_ckpt else "")
        jm = _jax_cnn(machine1, **cfg)
        runs[name] = _fit(jm) if name == "jax" else _fit(_port_cnn(jm, **cfg))
    j, t = runs["jax"], runs["port"]
    assert t["drained"] and t["completed_steps"] == j["completed_steps"] == 4
    keep = ("step", "steps_completed", "ckpt_step", "signal", "budget_s",
            "mode")
    assert {k: t["drain"][k] for k in keep} == \
        {k: j["drain"][k] for k in keep} == \
        {"step": 4, "steps_completed": 4,
         "ckpt_step": 4 if with_ckpt else None,
         "signal": int(signal.SIGTERM), "budget_s": 30.0,
         "mode": "async" if with_ckpt else "none"}
    drains = _records(t["obs_path"], {"preempt_drain"})
    assert len(drains) == 1 and drains[0]["step"] == 4
    assert signal.getsignal(signal.SIGTERM) is signal.SIG_DFL
    if not with_ckpt:
        return
    d = str(tmp_path / "port" / "ckpt")
    assert ckpt.latest_step(d) == 4 and ckpt.verify_checkpoint(d, 4)[0]
    # the resume loses nothing: steps 5-8 are the uninterrupted run's
    jm = _jax_cnn(machine1)
    base = _fit(_port_cnn(jm, num_iterations=8), n=8)["loss"]
    assert t["loss"] == base[:4]
    out = _fit(_port_cnn(jm, num_iterations=8, ckpt_dir=d, ckpt_freq=2),
               n=8)
    assert "drained" not in out and out["loss"] == base[4:]


def test_release_is_idempotent_and_reentrant():
    saved = distributed._STATE["initialized"]
    try:
        assert distributed.release() is False   # nothing brought up here
        distributed._STATE["initialized"] = True
        results = []
        threads = [threading.Thread(
            target=lambda: results.append(distributed.release()))
            for _ in range(8)]
        for th in threads:
            th.start()
        for th in threads:
            th.join()
        assert results.count(True) == 1
        assert distributed.release() is False
    finally:
        distributed._STATE["initialized"] = saved
    with pytest.raises(NotImplementedError, match="elastic training"):
        distributed.elastic_rejoin("x")


def test_drain_installers_are_idempotent():
    drain = {}
    restore = elastic.install_drain_handler(drain, log=lambda *a: None)
    try:
        assert drain == {"requested": False, "signum": None,
                         "installed": True}
        elastic.request_drain(drain)   # the real signal path
        assert drain["requested"] and drain["signum"] == int(signal.SIGTERM)
    finally:
        assert restore() is True
    assert restore() is False
    assert signal.getsignal(signal.SIGTERM) is signal.SIG_DFL
    # flag-only where no handler is installed
    d2 = {"requested": False, "signum": None}
    elastic.request_drain(d2)
    assert d2 == {"requested": True, "signum": int(signal.SIGTERM)}
    # off the main thread the installer runs flag-only
    off = {}
    th = threading.Thread(target=lambda: off.update(
        restore=elastic.install_drain_handler(off, log=lambda *a: None)))
    th.start()
    th.join()
    assert off["installed"] is False and off["restore"]() is True
    with elastic.drain_scope(log=lambda *a: None) as scoped:
        assert scoped["installed"] is True
    assert signal.getsignal(signal.SIGTERM) is signal.SIG_DFL


# ---------------------------------------------------------------------------
# the guard's and the restore's records


def test_guard_records_match_jax(tmp_path, machine1):
    kw = dict(fault_spec="loss_nan@3", on_divergence="rollback",
              ckpt_freq=2)
    paths = {}
    for name in ("jax", "port"):
        d = tmp_path / name
        cfg = dict(kw, obs_dir=str(d / "obs"), run_id="r",
                   ckpt_dir=str(d / "ckpt"))
        jm = _jax_cnn(machine1, **cfg)
        out = _fit(jm) if name == "jax" else _fit(_port_cnn(jm, **cfg))
        assert out["rollbacks"] == 1 and len(out["loss"]) == 6
        paths[name] = out["obs_path"]
    kinds = {"fault", "rollback", "recovery", "checkpoint_save"}
    got, want = (_records(paths[n], kinds) for n in ("port", "jax"))
    for recs in (got, want):
        for r in recs:
            if r["kind"] == "fault" and r.get("value") is not None:
                assert math.isnan(r.pop("value"))
    assert got == want
    # the injected NaN, the guard's detection, the rollback to step 2,
    # the first clean window, the saves of steps 2, 4 and 6
    assert [r["kind"] for r in got] == \
        ["checkpoint_save", "fault", "fault", "rollback", "recovery",
         "checkpoint_save", "checkpoint_save"]
    assert got[3] == {"kind": "rollback", "from_step": 4, "to_step": 2}


def test_ckpt_fallback_record_matches_jax(tmp_path):
    from flexflow_tpu.utils import faultinject as j_fi

    from flexflow_tpu_torch.utils import faultinject as t_fi

    params, state, opt = _np_trees()
    records = {}
    for name, mod, fi, trees in (
            ("jax", j_ckpt, j_fi, (params, state, opt)),
            ("port", ckpt, t_fi, [_torch(x) for x in (params, state, opt)])):
        d = str(tmp_path / name)
        restore = fi.install_scoped(fi.FaultInjector("ckpt_corrupt@2"))
        try:
            for step in (1, 2):
                mod.save_checkpoint(d, step, *trees)
        finally:
            restore()
        olog = _Log()
        kw = {} if name == "jax" else {"device": "cpu"}
        with pytest.warns(RuntimeWarning, match="checkpoint fallback"):
            step, *_ = mod.restore_checkpoint(d, olog=olog, **kw)
        assert step == 1
        records[name] = [
            {**r, "dir": None,
             "skipped": [(s["step"], s["reason"].split(" (")[0])
                         for s in r["skipped"]]}
            for r in olog.records]
    assert records["port"] == records["jax"] == [
        {"kind": "ckpt_fallback", "dir": None, "from_step": 2,
         "to_step": 1, "skipped": [(2, "arrays.npz digest mismatch")]}]


# ---------------------------------------------------------------------------
# the flags


def test_supervision_flags_parse_as_jax():
    argv = ["--ckpt-async", "--hang-factor", "20", "--hang-min-s", "45",
            "--drain-budget-s", "30", "-metrics-path", "m/metrics.prom"]
    j, t = JConfig.from_args(argv), FFConfig.from_args(argv)
    fields = sorted({RUNTIME_FLAGS[a][0] for a in argv if a in RUNTIME_FLAGS})
    assert fields == ["ckpt_async", "drain_budget_s", "hang_factor",
                      "hang_min_s", "metrics_path"]
    for field in fields:
        assert getattr(t, field) == getattr(j, field), field
        assert getattr(FFConfig(), field) == getattr(JConfig(), field)
    assert (t.ckpt_async, t.hang_factor, t.hang_min_s, t.drain_budget_s,
            t.metrics_path) == (True, 20.0, 45.0, 30.0, "m/metrics.prom")
    assert FFConfig.from_args(["--metrics-path", "x"]).metrics_path == "x"
    cfg, _, _ = t_lm.parse_args(argv)
    model = TransformerLM(cfg, device="cpu")
    _, ccfg, _, _ = t_cnn.parse(["alexnet"] + argv)
    for field in fields:
        assert getattr(model.config, field) == getattr(t, field), field
        assert getattr(ccfg, field) == getattr(t, field), field


@pytest.mark.parametrize("flag", sorted(ELASTIC_FLAGS))
def test_elastic_flags_still_raise(flag):
    for parse in (FFConfig.from_args, t_lm.parse_args,
                  lambda a: t_cnn.parse(["alexnet"] + a)):
        with pytest.raises(NotImplementedError,
                           match="item 5, elastic training"):
            parse([flag, "2"])


def test_lm_driver_drains_and_logs(tmp_path):
    lines = []
    out = t_lm.main(["--causal", "-b", "2", "-s", "16", "-l", "1",
                     "--d-model", "16", "--heads", "2", "--d-ff", "32",
                     "--vocab", "64", "-i", "6", "--device", "cpu",
                     "--ckpt-dir", str(tmp_path), "--ckpt-freq", "2",
                     "--ckpt-async", "--fault-spec", "preempt@3",
                     "--drain-budget-s", "30"], log=lines.append)
    assert out["drained"] and out["drain"]["mode"] == "async"
    assert "drained at iteration 4; exiting 0 (resume from --ckpt-dir to " \
        "continue)" in lines
    with open(os.path.join(str(tmp_path), "step_00000004",
                           "meta.json")) as f:
        assert json.load(f)["step"] == 4
