"""The port's training runtime on the CPU: checkpoints (and their format,
shared with the JAX package), resume, the step health guard, the retry
policy, the device prefetcher and the runtime flags.

Checkpoint leaves round-trip bit for bit, across the two packages too
(bfloat16 as its raw bits: the JAX package views them back with
``ml_dtypes``).  A resumed ``fit`` repeats the uninterrupted run's
losses exactly on the CPU (the same arithmetic on the same restored
leaves and batches); the tests allow 1e-6 relative.
"""

import os
import shutil
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flexflow_tpu.utils import checkpoint as j_ckpt
from flexflow_tpu_torch.apps import cnn as t_cnn
from flexflow_tpu_torch.apps import lm as t_lm
from flexflow_tpu_torch.config import RUNTIME_FLAGS, SWITCH_FLAGS, FFConfig
from flexflow_tpu_torch.data.prefetch import DevicePrefetcher
from flexflow_tpu_torch.models.transformer import (TransformerConfig,
                                                   TransformerLM)
from flexflow_tpu_torch.strategy import ParallelConfig, Strategy
from flexflow_tpu_torch.utils import checkpoint as ckpt
from flexflow_tpu_torch.utils import faultinject
from flexflow_tpu_torch.utils.health import StepHealthGuard, TrainingDiverged
from flexflow_tpu_torch.utils.retry import RetryPolicy, call_with_retry

torch.set_num_threads(2)

LM = dict(batch_size=2, seq_length=16, num_layers=1, d_model=16, num_heads=2,
          d_ff=32, vocab_size=64, causal=True, learning_rate=0.1, seed=0)


def _trees(dtype=torch.float32, seed=0):
    g = torch.Generator().manual_seed(seed)
    params = {"lin": {"kernel": torch.randn(3, 4, generator=g).to(dtype),
                      "bias": torch.randn(4, generator=g).to(dtype)},
              "emb": {"table": torch.randn(5, 2, generator=g).to(dtype),
                      "ids": torch.arange(6, dtype=torch.int32)}}
    state = {"bn": {"mean": torch.randn(4, generator=g),
                    "var": torch.rand(4, generator=g)}}
    opt = {"lin": {"kernel__master": torch.randn(3, 4, generator=g)}}
    return params, state, opt


def _same(a, b):
    """Trees equal leaf for leaf, dtype and bits."""
    assert a.keys() == b.keys()
    for k in a:
        if isinstance(a[k], dict):
            _same(a[k], b[k])
        else:
            assert a[k].dtype == b[k].dtype, k
            assert torch.equal(a[k], b[k]), k


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_round_trip(tmp_path, dtype):
    params, state, opt = _trees(dtype)
    d = str(tmp_path / "ck")
    ckpt.save_checkpoint(d, 7, params, state, opt)
    assert ckpt.latest_step(d) == 7 and ckpt.verify_checkpoint(d, 7) == \
        (True, "ok")
    step, p, s, o = ckpt.restore_checkpoint(d, device="cpu")
    assert step == 7
    _same(p, params)
    _same(s, state)
    _same(o, opt)
    # no staging directory is left behind
    assert sorted(os.listdir(d)) == ["step_00000007"]


def _as_jax_tree(tree):
    return {k: _as_jax_tree(v) if isinstance(v, dict)
            else jnp.asarray(v.float().numpy()).astype(
                "bfloat16" if v.dtype == torch.bfloat16 else
                v.numpy().dtype)
            for k, v in tree.items()}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_checkpoints_cross_packages(tmp_path, dtype):
    params, state, opt = _trees(dtype, seed=1)
    # the JAX package writes, the port reads
    jd = str(tmp_path / "from_jax")
    j_ckpt.save_checkpoint(jd, 3, _as_jax_tree(params), _as_jax_tree(state),
                           _as_jax_tree(opt))
    step, p, s, o = ckpt.restore_checkpoint(jd, device="cpu")
    assert step == 3
    _same(p, params)
    _same(s, state)
    _same(o, opt)
    # the port writes, the JAX package reads
    td = str(tmp_path / "from_port")
    ckpt.save_checkpoint(td, 4, params, state, opt)
    step, jp, js, jo = j_ckpt.restore_checkpoint(td)
    assert step == 4 and j_ckpt.verify_checkpoint(td, 4) == (True, "ok")
    for got, want in ((jp, params), (js, state), (jo, opt)):
        for key, sub in want.items():
            for leaf, t in sub.items():
                g = np.asarray(got[key][leaf])
                assert str(g.dtype) == str(t.dtype).replace("torch.", "")
                np.testing.assert_array_equal(
                    g.astype(np.float32) if t.is_floating_point() else g,
                    t.float().numpy() if t.is_floating_point()
                    else t.numpy())


@pytest.mark.parametrize("kind", ["ckpt_truncate", "ckpt_corrupt"])
def test_damaged_newest_step_falls_back(tmp_path, kind):
    params, state, opt = _trees()
    d = str(tmp_path / "ck")
    restore = faultinject.install_scoped(faultinject.FaultInjector(
        f"{kind}@3"))
    try:
        for step in (1, 2, 3):
            ckpt.save_checkpoint(d, step, params, state, opt)
    finally:
        restore()
    ok, why = ckpt.verify_checkpoint(d, 3)
    assert not ok and "digest mismatch" in why
    with pytest.warns(RuntimeWarning, match="fallback: step 3 -> 2"):
        step, p, _, _ = ckpt.restore_checkpoint(d, device="cpu")
    assert step == 2
    _same(p, params)
    with pytest.raises(ckpt.CheckpointCorruptError):
        ckpt.restore_checkpoint(d, step=3, device="cpu")
    # the JAX package reads the same damage the same way
    with pytest.warns(RuntimeWarning):
        assert j_ckpt.restore_checkpoint(d)[0] == 2

def test_pruning_keeps_the_newest_verified_step(tmp_path):
    """Saves keep the newest KEEP steps, and the newest step that still
    verifies even when it is older: corrupt saves cannot rotate the last
    good state away."""
    params, state, opt = _trees()
    d = str(tmp_path / "ck")
    restore = faultinject.install_scoped(faultinject.FaultInjector(
        f"ckpt_corrupt@3x{ckpt.KEEP}"))
    try:
        for step in range(1, 3 + ckpt.KEEP):
            ckpt.save_checkpoint(d, step, params, state, opt)
    finally:
        restore()
    assert ckpt._list_steps(d) == list(range(2, 3 + ckpt.KEEP))
    with pytest.warns(RuntimeWarning, match=f"step {2 + ckpt.KEEP} -> 2"):
        assert ckpt.restore_checkpoint(d, device="cpu")[0] == 2
    ckpt.save_checkpoint(d, 9, params, state, opt)   # a good save again
    assert ckpt._list_steps(d) == [2 + ckpt.KEEP - 1, 2 + ckpt.KEEP, 9]


def test_every_step_damaged_raises(tmp_path):
    params, state, opt = _trees()
    d = str(tmp_path / "ck")
    ckpt.save_checkpoint(d, 1, params, state, opt)
    with open(os.path.join(d, "step_00000001", "arrays.npz"), "r+b") as f:
        f.truncate(10)
    with pytest.raises(ckpt.CheckpointCorruptError, match="every checkpoint"):
        ckpt.restore_checkpoint(d, device="cpu")
    with pytest.raises(FileNotFoundError):
        ckpt.restore_checkpoint(str(tmp_path / "none"), device="cpu")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_finiteness_gate_refuses_nan(tmp_path, dtype):
    params, state, opt = _trees(dtype)
    params["lin"]["bias"][1] = float("nan")
    d = str(tmp_path / "ck")
    with pytest.raises(ckpt.NonFiniteCheckpointError, match="lin/bias"):
        ckpt.save_checkpoint(d, 1, params, state, opt)
    assert not os.path.exists(d)               # nothing touched the disk


def _lm(**kw):
    return TransformerLM(TransformerConfig(**LM, **kw), device="cpu")


def _data():
    return t_lm.synthetic_lm_batches(2, 16, 64, seed=0, device="cpu")


def _fit(model, iters, log=None):
    lines = []
    out = model.fit(_data(), num_iterations=iters, warmup=1,
                    log=lines.append if log is None else log)
    return out, lines


def test_fit_resumes_as_the_uninterrupted_run(tmp_path):
    full, _ = _fit(_lm(ckpt_dir=str(tmp_path / "a"), ckpt_freq=3), 6)
    assert ckpt._list_steps(str(tmp_path / "a")) == [3, 6]
    b = tmp_path / "b"
    shutil.copytree(tmp_path / "a" / "step_00000003", b / "step_00000003")
    resumed, lines = _fit(_lm(ckpt_dir=str(b), ckpt_freq=3), 6)
    assert f"resumed from {b} at iteration 3" in lines
    assert len(resumed["loss"]) == 3 and resumed["completed_steps"] == 6
    np.testing.assert_allclose(resumed["loss"], full["loss"][3:], rtol=1e-6)
    for key, sub in full["params"].items():
        for leaf, v in sub.items():
            torch.testing.assert_close(resumed["params"][key][leaf], v,
                                       rtol=1e-6, atol=1e-7)
    # a finished run resumes at its end and trains no further step
    again, _ = _fit(_lm(ckpt_dir=str(b), ckpt_freq=3), 6)
    assert again["loss"] == [] and again["completed_steps"] == 6


def test_fit_resumes_a_jax_checkpoint(tmp_path, machine1):
    """A checkpoint the JAX package wrote (its own model's init at step 2)
    resumes in the port's fit, the restored leaves identical."""
    from flexflow_tpu.models.transformer import TransformerConfig as JTC
    from flexflow_tpu.models.transformer import TransformerLM as JLM

    jm = JLM(JTC(**LM), machine1)
    jp, js = jm.init(0)
    d = str(tmp_path / "ck")
    j_ckpt.save_checkpoint(d, 2, jp, js, None)
    model = _lm(ckpt_dir=d)
    _, p, _, _ = ckpt.restore_checkpoint(d, model)
    for key, sub in jax.tree.map(np.asarray, jp).items():
        for leaf, v in sub.items():
            np.testing.assert_array_equal(p[key][leaf].numpy(), v)
    out, lines = _fit(model, 4)
    assert f"resumed from {d} at iteration 2" in lines
    assert len(out["loss"]) == 2 and all(np.isfinite(out["loss"]))


def test_fit_refuses_another_strategy(tmp_path):
    d = str(tmp_path / "ck")
    s = Strategy({"embed": ParallelConfig((1,), (0,))})
    model = _lm(ckpt_dir=d)
    p, st = model.init()
    ckpt.save_checkpoint(d, 1, p, st, None, strategy=s)
    with pytest.raises(ValueError, match="another strategy"):
        _fit(model, 2)


def test_loss_nan_halts(tmp_path):
    model = _lm(ckpt_dir=str(tmp_path), ckpt_freq=2, fault_spec="loss_nan@3")
    with pytest.raises(TrainingDiverged, match="iteration 3"):
        _fit(model, 6)
    assert faultinject.get() is faultinject.NULL   # uninstalled on exit


def test_loss_nan_rolls_back_and_recovers(tmp_path):
    clean, _ = _fit(_lm(), 6)
    model = _lm(ckpt_dir=str(tmp_path), ckpt_freq=2,
                on_divergence="rollback", fault_spec="loss_nan@3")
    out, lines = _fit(model, 6)
    assert out["rollbacks"] == 1 and out["completed_steps"] == 6
    assert "health guard: rolled back from iteration 4 to checkpoint step " \
        "2" in lines
    assert len(out["loss"]) == 6 and all(np.isfinite(out["loss"]))
    # steps 1-2 are the clean run's; the re-run steps 3-4 take the next
    # batches of the stream, so they differ
    assert out["loss"][:2] == clean["loss"][:2]
    # under warn the NaN is kept and the run goes on
    out, lines = _fit(_lm(ckpt_freq=2, on_divergence="warn",
                          fault_spec="loss_nan@3"), 4)
    assert np.isnan(out["loss"][2]) and out["rollbacks"] == 0
    assert any("on_divergence=warn" in line for line in lines)


def test_rollback_without_checkpoint_reinitializes():
    out, lines = _fit(_lm(on_divergence="rollback", fault_spec="loss_nan@2",
                          max_rollbacks=1), 3)
    assert "health guard: rolled back from iteration 3 to checkpoint step " \
        "0" in lines
    assert out["rollbacks"] == 1 and len(out["loss"]) == 3
    with pytest.raises(TrainingDiverged, match="after 1 rollback"):
        _fit(_lm(on_divergence="rollback", fault_spec="loss_nan@2x10",
                 max_rollbacks=1), 3)


def test_guard_checks_windows():
    guard = StepHealthGuard("rollback", max_rollbacks=1, log=lambda *a: None)
    assert guard.check([torch.tensor(1.0), 2.0], first_step=1) is None
    assert guard.check([torch.tensor(float("inf"))], first_step=3) \
        == "rollback"
    with pytest.raises(TrainingDiverged, match="iteration 4"):
        guard.check([1.0, float("nan")], first_step=3)
    with pytest.raises(ValueError, match="on_divergence"):
        StepHealthGuard("explode")


def test_retry_policy_is_bounded_and_deterministic():
    delays, calls = [], []

    def flaky():
        calls.append(1)
        if len(calls) < 3:
            raise OSError("transient")
        return "ok"

    policy = RetryPolicy(attempts=4, seed=3)
    assert call_with_retry(flaky, policy, sleep=delays.append) == "ok"
    assert delays == [policy.delay(1), policy.delay(2)]
    assert delays[1] > delays[0] > 0
    with pytest.raises(OSError):
        call_with_retry(lambda: (_ for _ in ()).throw(OSError("down")),
                        RetryPolicy(attempts=2), sleep=lambda d: None)
    with pytest.raises(KeyError):               # not retried
        call_with_retry(lambda: {}["x"], sleep=lambda d: None)


@pytest.mark.parametrize("depth", [1, 2])
def test_prefetcher_yields_the_upstream_batches(depth):
    def batches():
        rng = np.random.RandomState(0)
        for _ in range(5):
            yield rng.randint(0, 9, (2, 3)), rng.randn(2).astype("float32")

    with DevicePrefetcher(batches(), "cpu", depth) as pf:
        got = list(pf)
    want = list(batches())
    assert len(got) == 5 and pf.batches == 5
    for (a, b), (c, d) in zip(got, want):
        assert torch.equal(a, torch.as_tensor(c))
        assert torch.equal(b, torch.as_tensor(d))
    assert not pf._thread.is_alive()


def test_prefetcher_passes_on_a_worker_error():
    def batches():
        yield (np.zeros(2),)
        raise OSError("disk gone")

    pf = DevicePrefetcher(batches(), "cpu", 2)
    assert next(pf)[0].shape == (2,)
    with pytest.raises(OSError, match="disk gone"):
        next(pf)
    with pytest.raises(StopIteration):
        next(pf)
    pf._thread.join(timeout=5)
    assert not pf._thread.is_alive()
    with pytest.raises(ValueError, match="depth"):
        DevicePrefetcher(iter([]), "cpu", 0)


def test_prefetcher_closes_while_the_worker_blocks():
    pf = DevicePrefetcher(iter(lambda: (np.zeros(1),), None), "cpu", 1)
    next(pf)
    pf.close()
    assert not pf._thread.is_alive()
    with pytest.raises(RuntimeError, match="closed"):
        next(pf)


def test_fit_with_prefetch_equals_the_synchronous_pull():
    sync, _ = _fit(_lm(), 4)
    out, _ = _fit(_lm(prefetch_depth=2), 4)
    assert out["loss"] == sync["loss"]
    assert out["input_stall_s"] >= 0.0
    # the LM app makes host batches for the prefetcher to copy
    res = t_lm.main(["--causal", "-b", "2", "-s", "16", "-l", "1",
                     "--d-model", "16", "--heads", "2", "--d-ff", "32",
                     "--vocab", "64", "-i", "2", "--prefetch-depth", "2",
                     "--device", "cpu"], log=lambda *a: None)
    assert len(res["loss"]) == 2 and all(np.isfinite(res["loss"]))


VALUES = {"ckpt_dir": "d", "ckpt_freq": "5", "prefetch_depth": "2",
          "on_divergence": "rollback", "max_rollbacks": "7",
          "fault_spec": "loss_nan@7,ckpt_corrupt@2", "ckpt_async": "1",
          "hang_factor": "20", "hang_min_s": "45", "drain_budget_s": "30",
          "metrics_path": "m/metrics.prom", "elastic": "1",
          "min_devices": "3", "research_budget_s": "5",
          "elastic_search_iters": "300", "max_regrows": "2",
          "regrow_probes": "3", "transient_reset_steps": "4",
          "decompose": "1", "block_budget_s": "2.5",
          "boundary_refine_iters": "40"}


@pytest.mark.parametrize("flag", sorted(RUNTIME_FLAGS))
def test_runtime_flags_parse(flag):
    field, _ = RUNTIME_FLAGS[flag]
    value = VALUES[field]
    want = type(getattr(FFConfig(), field))(value)
    # a switch takes no value
    argv = [flag] if flag in SWITCH_FLAGS else [flag, value]
    assert getattr(FFConfig.from_args(argv), field) == want
    cfg, _, _ = t_lm.parse_args(argv)
    assert getattr(cfg, field) == want
    _, ccfg, _, _ = t_cnn.parse(["alexnet"] + argv)
    assert getattr(ccfg, field) == want
    # the LM model forwards the field into its FFConfig
    assert getattr(TransformerLM(cfg, device="cpu").config, field) == want


def test_runtime_flags_are_checked():
    with pytest.raises(SystemExit, match="halt|warn|rollback"):
        FFConfig.from_args(["--on-divergence", "explode"])
    with pytest.raises(SystemExit, match="unknown fault kind"):
        t_lm.parse_args(["--fault-spec", "loss_nun@3"])


def test_cnn_fit_checkpoints_its_state_and_momentum(tmp_path):
    """The CNN path (BatchNorm state, momentum buffers) resumes too."""
    argv = ["densenet", "-b", "1", "-i", "2", "--height", "221", "--width",
            "221", "--device", "cpu", "--ckpt-dir", str(tmp_path),
            "--ckpt-freq", "1", "--warmup", "0"]
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        t_cnn.main(argv, log=lambda *a: None)
    step, params, state, opt = ckpt.restore_checkpoint(str(tmp_path),
                                                       device="cpu")
    assert step == 2 and state and opt.keys() == params.keys()
    # a longer run resumes from it (the model checks every leaf's shape)
    lines = []
    out = t_cnn.main([a if a != "2" else "3" for a in argv],
                     log=lines.append)
    assert f"resumed from {tmp_path} at iteration 2" in lines
    assert len(out["loss"]) == 1 and ckpt.latest_step(str(tmp_path)) == 3


def test_param_shapes_of_the_nmt_and_cnn_models():
    from flexflow_tpu_torch.nmt.rnn_model import RnnConfig, RnnModel

    for model in (t_cnn.build("alexnet", FFConfig(batch_size=1,
                                                  input_height=67,
                                                  input_width=67), "cpu"),
                  RnnModel(RnnConfig(batch_size=2, num_layers=2,
                                     seq_length=6, hidden_size=16,
                                     embed_size=12, vocab_size=64,
                                     lstm_per_node_length=3),
                           device="cpu")):
        params, _ = model.init()
        assert model.param_shapes() == {
            key: {leaf: tuple(v.shape) for leaf, v in sub.items()}
            for key, sub in params.items()}
