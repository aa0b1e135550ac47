"""Elastic training over gloo ranks in the PyTorch port, against the JAX
package's run of the same spec on its virtual CPU mesh
(``tests/test_elastic.py``, ``tests/test_elastic_lifecycle.py``).

The JAX elastic tests' tiny CNN at batch 24, from JAX's initial
parameters, on a ``data.BlockStream`` of the JAX tests' host batches:

* the lifecycle on 4 ranks (4 -> 2 -> 4, ``device_loss@3x2,
  device_return@2``) against JAX's on 4 of its 8 devices: the elastic
  records (kinds in order, the resizes' direction, device counts,
  migration, resume step and steps lost), the losses within 2e-4, every
  rank's history, the lost ranks called back;
* the checkpoint fallback when the in-memory gather is refused (then a
  grow back), and ``--max-regrows 0`` staying shrunk with the lost ranks
  out of service;
* a healthy run bit-equal with and without ``--elastic``;
* the watchdog's permanent hang with the two highest ranks' cards
  probing dead (their outcomes through the store);
* ``distributed.elastic_rejoin`` in two fresh processes restoring the
  checkpoint JAX wrote and taking JAX's post-restore step.
"""

import numpy as np
import pytest
import torch

import torch_ranks as tr

torch.set_num_threads(2)

CFG = dict(batch_size=tr.ELASTIC_BATCH, input_height=16, input_width=16,
           print_freq=2, num_classes=8, seed=3, prefetch_depth=0)


def _jax_and_trees(tmp_path, kw, devices=4, **ref):
    full, *rest = tr.jax_elastic(dict(CFG, **kw, obs_dir=str(tmp_path / "jax"),
                                      run_id="ref"), devices, **ref)
    path = str(tmp_path / "trees.npz")
    tr.save_trees(path, full, {})
    return path, rest


def _port_kw(tmp_path, kw, run):
    return dict(CFG, **kw, obs_dir=str(tmp_path / "port"), run_id=run)


def _check_against(res, want, ranks, out_of_service=(), probed=False):
    """Rank 0's records, losses and counts against JAX's; with
    ``probed`` JAX's injected probe wrote no ``device_probe`` record of
    the dead, which the port's real probe writes."""
    j_loss, j_resizes, j_devices, j_records = want
    losses, resizes, devices, oos, records = res[0]
    if probed:
        records = [r for r in records if not (
            r["kind"] == "device_probe" and r.get("outcome") == "dead")]
    assert records == j_records
    np.testing.assert_allclose(losses, j_loss, rtol=tr.LOSS_RTOL,
                               atol=tr.LOSS_ATOL)
    assert (resizes, devices) == (j_resizes, j_devices)
    for r in range(ranks):
        if r in out_of_service:
            assert res[r][3] is True and res[r][0] == losses
        else:
            assert res[r][:4] == (losses, resizes, devices, False)


def test_lifecycle_four_ranks_matches_jax(tmp_path):
    kw = dict(num_iterations=12, elastic=True, min_devices=2,
              regrow_probes=2, max_regrows=1, research_budget_s=5.0,
              fault_spec="device_loss@3x2,device_return@2")
    trees, want = _jax_and_trees(tmp_path, dict(
        kw, metrics_path=str(tmp_path / "jax.prom")))
    res = tr.run_ranks(tr.elastic_fit, 4, _port_kw(tmp_path, dict(
        kw, metrics_path=str(tmp_path / "port.prom")), "life"), trees,
        timeout=180.0)
    _check_against(res, want, 4)
    # the live metrics count the resizes, by direction too
    from flexflow_tpu.obs import metrics as j_metrics

    from flexflow_tpu_torch.obs import metrics

    for read in ("read_textfile", "read_labeled"):
        got = getattr(metrics, read)(str(tmp_path / "port.prom"))
        ref = getattr(j_metrics, read)(str(tmp_path / "jax.prom"))
        assert got["elastic_events"] == ref["elastic_events"]
    assert metrics.read_labeled(str(tmp_path / "port.prom"))[
        "elastic_events"] == {'direction="grow"': 1.0,
                              'direction="shrink"': 1.0}
    records = res[0][4]
    resizes = [r for r in records if r["kind"] == "elastic_resize"]
    assert [(r["direction"], r["from_devices"], r["to_devices"],
             r["migration"], r["resume_step"], r["steps_lost"])
            for r in resizes] == [("shrink", 4, 2, "in_memory", 4, 0),
                                  ("grow", 2, 4, "in_memory", 10, 0)]
    kinds = [r["kind"] for r in records]
    assert kinds.index("device_loss") < kinds.index("elastic_resize") \
        < kinds.index("device_return")
    assert [r["returned"] for r in records
            if r["kind"] == "device_return"] == [[2, 3]]


def test_checkpoint_fallback_when_migration_refused(tmp_path):
    # every gather refused (JAX's tests/test_elastic.py:161): the shrink
    # restores the step-2 checkpoint, and the grow, which needs the live
    # state, falls back to staying shrunk with the lost ranks out
    kw = dict(num_iterations=12, elastic=True, min_devices=2,
              fault_spec="device_loss@3x2,device_return@2", ckpt_freq=2,
              research_budget_s=5.0)
    trees, want = _jax_and_trees(tmp_path, dict(
        kw, ckpt_dir=str(tmp_path / "jax_ckpt")), refuse_gather=True)
    res = tr.run_ranks(tr.elastic_fit, 4, _port_kw(
        tmp_path, dict(kw, ckpt_dir=str(tmp_path / "ckpt")), "fb"), trees,
        True, timeout=180.0)
    _check_against(res, want, 4, out_of_service=(2, 3))
    records = res[0][4]
    rz = [r for r in records if r["kind"] == "elastic_resize"]
    assert [(r["migration"], r["resume_step"], r["steps_lost"])
            for r in rz] == [("checkpoint", 2, 2)]
    assert [r["step"] for r in records
            if r["kind"] == "elastic_fallback"] == [4, 8]


def test_max_regrows_zero_stays_shrunk(tmp_path):
    kw = dict(num_iterations=8, elastic=True, min_devices=2,
              max_regrows=0, research_budget_s=5.0,
              fault_spec="device_loss@3x2,device_return@1")
    trees, want = _jax_and_trees(tmp_path, kw)
    res = tr.run_ranks(tr.elastic_fit, 4, _port_kw(tmp_path, kw, "stay"),
                       trees, timeout=180.0)
    # the survivors end on 2 ranks, the lost ones out of service with the
    # run's history
    _check_against(res, want, 4, out_of_service=(2, 3))
    assert res[0][1:3] == (1, 2)
    assert not [r for r in res[0][4] if r["kind"] == "device_return"
                or r.get("needed") is not None]


def test_healthy_run_bit_equal_with_and_without_elastic(tmp_path):
    trees, _ = _jax_and_trees(tmp_path, dict(num_iterations=4), devices=2)
    base = dict(num_iterations=4, print_freq=0)
    res = tr.run_ranks(tr.run_cases, 2, [
        ("elastic_fit", (dict(CFG, **base), trees)),
        ("elastic_fit", (dict(CFG, **base, elastic=True, min_devices=1,
                              hang_factor=50.0, hang_min_s=120.0),
                         trees))], timeout=120.0)
    for off, on in res:
        assert on[0] == off[0] and len(on[0]) == 4
        assert on[1:4] == off[1:4] == (0, 2, False)


def test_watchdog_permanent_hang_recovers_with_probe(tmp_path):
    kw = dict(num_iterations=8, elastic=True, min_devices=2,
              max_regrows=0, hang_factor=1.0, hang_min_s=0.2,
              research_budget_s=5.0, fault_spec="step_hang@3")
    trees, want = _jax_and_trees(tmp_path, kw, probe_dead=[2, 3])
    res = tr.run_ranks(tr.elastic_fit, 4, _port_kw(tmp_path, kw, "hang"),
                       trees, False, (2, 3), timeout=180.0)
    _check_against(res, want, 4, out_of_service=(2, 3), probed=True)
    records = res[0][4]
    # the lost ranks' own probes, through the store, before the shrink
    dead = [i for i, r in enumerate(records) if r["kind"] == "device_probe"
            and r.get("outcome") == "dead"]
    assert len(dead) == 2 and dead[-1] < [r["kind"] for r in records].index(
        "device_loss")
    rz = next(r for r in records if r["kind"] == "elastic_resize")
    assert (rz["direction"], rz["migration"], rz["from_devices"],
            rz["to_devices"]) == ("shrink", "in_memory", 4, 2)


def test_elastic_rejoin_two_fresh_processes_match_jax(tmp_path):
    import jax

    from flexflow_tpu.config import FFConfig
    from flexflow_tpu.machine import MachineModel
    from flexflow_tpu.model import FFModel
    from flexflow_tpu.strategy import ParallelConfig, Strategy
    from flexflow_tpu.utils import checkpoint as j_ckpt

    def build(machine, split):
        cfg = FFConfig(batch_size=tr.ELASTIC_BATCH, input_height=16,
                       input_width=16, num_classes=8, seed=3)
        if split:
            cfg.strategies = Strategy()
            cfg.strategies["fc"] = ParallelConfig((1, split),
                                                  tuple(range(split)))
        ff = FFModel(cfg, machine)
        img = ff.create_input((cfg.batch_size, 16, 16, 3), name="image")
        t = ff.conv2d("conv1", img, 8, 3, 3, 1, 1, 1, 1, relu=True)
        t = ff.flat("flat", t)
        t = ff.linear("fc", t, 8, relu=False)
        ff.softmax("softmax", t)
        return ff

    # JAX writes the run's state after 3 steps, then restores it onto a
    # two-device mesh and takes the next step
    ring = tr.elastic_host_batches()
    ff = build(MachineModel(jax.devices()[:1]), 0)
    params, state = ff.init()
    opt = ff.init_opt_state(params)
    step = ff.make_train_step()
    for image, labels in ring[:3]:
        params, state, opt, _ = step(params, state, opt, image, labels)
    ckpt_dir = str(tmp_path / "ckpt")
    j_ckpt.save_checkpoint(ckpt_dir, 3, params, state, opt,
                           ff.config.strategies)
    ff2 = build(MachineModel(jax.devices()[:2]), 2)
    s, p2, st2, o2 = j_ckpt.restore_checkpoint(ckpt_dir, ff2)
    want = float(ff2.make_train_step()(p2, st2, o2, *ring[0])[3])
    assert s == 3
    got = tr.run_fresh(tr.rejoin_step, 2, ckpt_dir, timeout=120.0)
    assert [g[:2] for g in got] == [(3, 2), (3, 2)]
    assert got[0][2] == got[1][2]
    assert got[0][2] == pytest.approx(want, rel=1e-5)


LM_ARGV = ["--causal", "-b", "4", "-s", "16", "-l", "2", "--d-model", "16",
           "--heads", "2", "--d-ff", "32", "--vocab", "64", "-i", "6",
           "--device", "cpu", "-p", "1"]
CNN_ARGV = ["alexnet", "-b", "4", "--height", "67", "--width", "67", "-i",
            "6", "--lr", "0.001", "--device", "cpu", "-p", "1"]
ELASTIC_ARGV = ["--elastic", "--min-devices", "1", "--research-budget-s",
                "5", "--fault-spec", "device_loss@2,device_return@2"]


def test_drivers_shrink_and_grow_over_two_ranks():
    # apps.lm and apps.cnn as torchrun ranks: rank 1 is lost at step 2,
    # called back after the third boundary probe; each run's losses are
    # its healthy run's (the same global batches, on 1 rank between)
    res = tr.run_ranks(tr.run_cases, 2, [
        ("app_main", (LM_ARGV, "lm", True)),
        ("app_main", (LM_ARGV + ELASTIC_ARGV, "lm", True)),
        ("app_main", (CNN_ARGV, "cnn", True)),
        ("app_main", (CNN_ARGV + ELASTIC_ARGV, "cnn", True))],
        timeout=180.0)
    (lm, lines), (lm_el, el_lines), (cnn, _), (cnn_el, cnn_lines) = res[0]
    assert res[1][1][0] is None     # rank 1 returns nothing, as always
    np.testing.assert_allclose(lm_el, lm, rtol=1e-5)
    np.testing.assert_allclose(cnn_el, cnn, rtol=1e-4)
    for log in (el_lines, cnn_lines):
        assert any("resized 2 -> 1 devices at iteration 2" in s
                   for s in log), log
        assert any("resized 1 -> 2 devices at iteration 5" in s
                   for s in log), log


def test_elastic_smoke_over_four_ranks():
    import subprocess
    import sys

    proc = subprocess.run(
        [sys.executable, "-m", "flexflow_tpu_torch.apps.elastic_smoke",
         "--ranks", "4", "--device", "cpu"], capture_output=True, text=True,
        timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "equivalence ok: 4 losses bit-equal" in proc.stdout
    assert "elastic-smoke ok: 12 iters survived" in proc.stdout
    assert "a 4->2 shrink at step 4" in proc.stdout


def test_rejoin_smoke_in_fresh_processes():
    import os
    import subprocess
    import sys

    cmd = [sys.executable, "-m", "flexflow_tpu_torch.apps.rejoin_smoke",
           "--device", "cpu"]
    off = subprocess.run(cmd, capture_output=True, text=True, timeout=120,
                         env={k: v for k, v in os.environ.items()
                              if k != "FF_REJOIN_SMOKE"})
    assert off.returncode == 0 and "SKIPPED" in off.stdout
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=300,
                          env=dict(os.environ, FF_REJOIN_SMOKE="1"))
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    assert "rejoin-smoke ok: 2 fresh processes rejoined" in proc.stdout
