"""The port's fleet (``flexflow_tpu_torch/fleet/``, ``apps/fleet.py``)
against the JAX package's (``flexflow_tpu/fleet/``):

  * the arbiter's sizes, packings and ordinals equal JAX's on the cases
    of ``tests/test_fleet.py`` and on 40 randomized small fleets;
  * coordinator runs of sim jobs (``JobSpec.sim_steps``) write JAX's
    record sequence, field for field but the wall clock;
  * ``apps.fleet``'s smoke over 8 gloo CPU ranks, from the JAX package's
    initial weights, gives the record sequence of JAX's 8-device smoke
    (A 6 -> 4 -> 6, B 2 -> 4 -> 2), A's losses within 1e-5 relative of
    JAX's, and B's replies equal;
  * a resize leg that fails on every rank aborts back to running, as in
    JAX;
  * ``report fleet`` renders the port's stream.
"""

import math
import os

import numpy as np
import pytest

from flexflow_tpu.config import FFConfig as JConfig
from flexflow_tpu.fleet import Arbiter as JArbiter
from flexflow_tpu.fleet import FleetCoordinator as JCoordinator
from flexflow_tpu.fleet import Job as JJob
from flexflow_tpu.fleet import JobSpec as JSpec
from flexflow_tpu_torch.config import FFConfig as TConfig
from flexflow_tpu_torch.fleet import Arbiter as TArbiter
from flexflow_tpu_torch.fleet import FleetCoordinator as TCoordinator
from flexflow_tpu_torch.fleet import Job as TJob
from flexflow_tpu_torch.fleet import JobSpec as TSpec

BATCH = 24

PKGS = {"jax": (JConfig, JArbiter, JCoordinator, JJob, JSpec),
        "torch": (TConfig, TArbiter, TCoordinator, TJob, TSpec)}


def _quiet(*a, **k):
    pass


def _spec(pkg, kind, job_id, *, iters=6, min_devices=2, max_devices=6,
          priority=1.0, batch=BATCH, queue_hi=4, sim_steps=0):
    Config, _, _, _, Spec = PKGS[pkg]
    if kind == "train":
        cfg = Config(batch_size=batch, input_height=16, input_width=16,
                     num_iterations=iters, print_freq=0, num_classes=8,
                     seed=3)
        return Spec(job_id=job_id, kind="train", build=None, config=cfg,
                    priority=priority, min_devices=min_devices,
                    max_devices=max_devices, sim_steps=sim_steps)
    return Spec(job_id=job_id, kind="serve", build=None,
                config=Config(batch_size=8, seed=0), payload=[],
                min_devices=min_devices, max_devices=max_devices,
                queue_hi=queue_hi, priority=priority, sim_steps=sim_steps)


class _Eng:
    def __init__(self, depth):
        self.depth = depth

    def queue_depth(self):
        return self.depth


def _proxy(job, size):
    return 1.0 / float(size) + 0.001 * float(size)


class _StubJob:
    """A job of given candidate sizes (JAX's ``tests/test_fleet.py``
    stub): the arbiter reads ``spec`` and ``candidate_sizes``."""

    def __init__(self, jid, sizes, priority=1.0):
        import types

        self.spec = types.SimpleNamespace(job_id=jid, priority=priority)
        self._sizes = list(sizes)

    def candidate_sizes(self, pool):
        return [s for s in self._sizes if s <= pool]


def _pack_case(pkg, case):
    _, Arbiter, _, Job, _ = PKGS[pkg]
    if case == "work_conserving":
        a, b = Job(_spec(pkg, "train", "a")), Job(_spec(pkg, "serve", "b"))
        return Arbiter(8, pricer=_proxy).pack([a, b])
    if case == "prefers_placing":
        a, b = Job(_spec(pkg, "train", "a")), Job(_spec(pkg, "serve", "b"))
        b.engine = _Eng(9)
        return Arbiter(8, pricer=_proxy).pack([a, b],
                                              current={"a": 6, "b": 2})
    if case == "weighted":
        a = Job(_spec(pkg, "train", "a", batch=8, max_devices=8))
        b = Job(_spec(pkg, "train", "b", batch=8, max_devices=8,
                      priority=10.0))
        return Arbiter(12, pricer=_proxy).pack([a, b])
    if case == "never_zeroes":
        t = Job(_spec(pkg, "train", "t", min_devices=6, max_devices=6))
        s = Job(_spec(pkg, "serve", "s", min_devices=2, max_devices=8))
        s.engine = _Eng(99)
        return Arbiter(8, pricer=_proxy, log=_quiet).pack(
            [t, s], current={"t": 6, "s": 2})
    if case == "sizes":
        a, b = Job(_spec(pkg, "train", "a")), Job(_spec(pkg, "serve", "b"))
        out = [a.feasible_sizes(8), b.feasible_sizes(8),
               a.candidate_sizes(8), b.demand(8), b.candidate_sizes(8)]
        b.engine = _Eng(9)
        return out + [b.demand(8), b.candidate_sizes(8)]
    if case == "ordinals":
        a, b = Job(_spec(pkg, "train", "a")), Job(_spec(pkg, "serve", "b"))
        arb = Arbiter(8, pricer=_proxy)
        first = arb.assign_ordinals([a, b], {"a": 6, "b": 2})
        second = arb.assign_ordinals([a, b], {"a": 4, "b": 4},
                                     current=first)
        third = Arbiter(10, pricer=_proxy, log=_quiet).assign_ordinals(
            [a, b], {"a": 0, "b": 4},
            current={"a": [0, 1, 2, 3, 4, 5], "b": [6, 7]})
        return first, second, third
    raise AssertionError(case)


@pytest.mark.parametrize("case", ["work_conserving", "prefers_placing",
                                  "weighted", "never_zeroes", "sizes",
                                  "ordinals"])
def test_arbiter_matches_jax(case):
    assert _pack_case("torch", case) == _pack_case("jax", case)


def test_pack_matches_jax_on_random_fleets():
    rng = np.random.RandomState(11)

    def pricer(job, size):
        k = 1.0 + 0.25 * (ord(job.spec.job_id[-1]) % 5)
        return k / size + 0.001 * size

    for trial in range(40):
        pool = int(rng.randint(4, 11))
        jobs, current, free = [], {}, pool
        for i in range(int(rng.randint(1, 5))):
            jid = f"j{trial}x{i}"
            sizes = sorted(rng.choice(range(1, pool + 1),
                                      size=int(rng.randint(1, 4)),
                                      replace=False).tolist())
            jobs.append(_StubJob(jid, sizes, rng.choice([1.0, 2.0, 5.0])))
            if free > 0 and rng.rand() < 0.5:
                held = int(rng.randint(1, free + 1))
                current[jid] = held
                free -= held
        got = TArbiter(pool, pricer=pricer, log=_quiet).pack(
            jobs, current=current)
        want = JArbiter(pool, pricer=pricer, log=_quiet).pack(
            jobs, current=current)
        assert got == want, (trial, pool, current, got, want)


def test_native_pricer_logged_and_proxy_fallback(monkeypatch):
    import flexflow_tpu_torch.sim.search as search
    from flexflow_tpu_torch.apps import fleet

    spec = TSpec(job_id="a", kind="train", build=fleet._train_build,
                 config=TConfig(batch_size=24, input_height=16,
                                input_width=16, num_classes=8, seed=3),
                 min_devices=2, max_devices=6, search_iters=20)
    arb = TArbiter(8, log=_quiet)
    cost = arb.price(TJob(spec), 4)
    assert math.isfinite(cost) and cost > 0
    assert (arb.native_prices, arb.proxy_prices) == (1, 0)
    assert arb.priced_strategy(TJob(spec), 4) is not None
    said = []

    def boom(*a, **kw):
        raise RuntimeError("native unavailable")

    monkeypatch.setattr(search, "price_on_slice", boom)
    arb2 = TArbiter(8, log=said.append)
    assert arb2.price(TJob(spec), 4) == pytest.approx(
        TArbiter._price_proxy(None, 4))
    assert (arb2.native_prices, arb2.proxy_prices) == (0, 1)
    assert arb2.pricer_errors == ["RuntimeError: native unavailable"]
    assert "using DP proxy" in said[0]


def _strip(rec):
    return {k: v for k, v in rec.items()
            if k not in ("ts", "wall_s", "run", "run_id", "pid", "host")}


def _sim_run(pkg, tmp_path):
    """Three sim jobs (two train, one backlogged serve) through the
    coordinator on a virtual pool of 8, with the proxy pricer."""
    _, Arbiter, Coordinator, _, _ = PKGS[pkg]
    if pkg == "jax":
        from flexflow_tpu import obs
        from flexflow_tpu.machine import MachineModel
    else:
        from flexflow_tpu_torch import obs
        from flexflow_tpu_torch.machine import MachineModel
    path = str(tmp_path / f"{pkg}.jsonl")
    olog = obs.RunLog(path, surface="fleet")
    coord = Coordinator(MachineModel.virtual(8), olog=olog, quantum=3,
                        pricer=Arbiter.proxy_pricer, step_time_s=2.0,
                        resize_steps=2, log=_quiet)
    coord.submit(_spec(pkg, "train", "a", sim_steps=20, max_devices=6))
    coord.submit(_spec(pkg, "serve", "b", sim_steps=14, min_devices=2,
                       max_devices=4, queue_hi=6))
    coord.submit(_spec(pkg, "train", "c", sim_steps=9, min_devices=2,
                       max_devices=4, priority=2.0))
    summary = coord.run()
    olog.close()
    recs = [_strip(r) for r in obs.read_run(path)
            if r["kind"] != "run_start" and r["kind"] != "run_end"]
    summary.pop("wall_s")
    return summary, recs


def test_sim_coordinator_records_match_jax(tmp_path):
    tsum, trecs = _sim_run("torch", tmp_path)
    jsum, jrecs = _sim_run("jax", tmp_path)
    assert tsum == jsum
    assert [r["kind"] for r in trecs] == [r["kind"] for r in jrecs]
    assert trecs == jrecs
    assert tsum["rebalances"] >= 1


def _jax_trees():
    """The JAX package's initial trees of the fleet's two models at the
    mix's seed (``FFConfig``'s default), as numpy."""
    import jax

    from flexflow_tpu.apps.fleet import _serve_build
    from flexflow_tpu.apps.elastic_smoke import _build
    from flexflow_tpu.machine import MachineModel

    seed = JConfig().seed
    m1 = MachineModel(devices=jax.devices()[:1])
    cnn = _build(JConfig(batch_size=24, input_height=16, input_width=16,
                         num_classes=8, seed=seed), m1)
    gpt = _serve_build(JConfig(batch_size=8, seed=seed), m1)
    out = {}
    for name, model in (("cnn", cnn), ("gpt", gpt)):
        params, _ = model.init(seed)
        out[name] = jax.tree.map(np.asarray, params)
    return out


def test_fleet_smoke_on_8_ranks_matches_jax(tmp_path, machine8):
    import jax

    from flexflow_tpu.apps import fleet as j_fleet

    from torch_fleet_ranks import fleet_smoke, save_models
    from torch_ranks import run_ranks

    trees = str(tmp_path / "trees.npz")
    save_models(trees, _jax_trees())
    obs_dir = str(tmp_path / "obs")
    res = run_ranks(fleet_smoke, 8, trees, obs_dir, 48, timeout=300.0)
    facts, summary = res[0]["facts"], res[0]["summary"]

    jcfg = JConfig.from_args([])
    jcfg.num_iterations = 48
    jcfg.obs_dir = str(tmp_path / "jax_obs")
    jax.config.update("jax_platforms", "cpu")
    jsum, jcoord = j_fleet.smoke(jcfg, log=_quiet)
    ja = next(j for j in jcoord.jobs if j.spec.job_id == "train-a")
    jb = next(j for j in jcoord.jobs if j.spec.job_id == "serve-b")

    # the record sequence of JAX's smoke
    assert facts["resizes_a"] == [("shrink", 6, 4, "directed"),
                                  ("grow", 4, 6, "directed")]
    assert facts["resizes_b"] == [("grow", 2, 4, "directed"),
                                  ("shrink", 4, 2, "directed")]
    assert facts["sequence"] == ["fleet_rebalance", "elastic_resize",
                                 "elastic_resize"] * 2
    for key in ("rebalances", "packs", "by_state", "pool_devices"):
        assert summary[key] == jsum[key], key
    # A's losses within 1e-5 relative of JAX's, unbroken across moves
    np.testing.assert_allclose(facts["losses"], ja.result["loss"],
                               rtol=1e-5, atol=0)
    # B's replies equal
    replies = {}
    for r in res:
        replies.update(r["replies"])
    want = {r.rid: list(r.reply) for r in jb.spec.payload}
    assert replies == want
    # the JAX stream's iterations at each move are the port's
    def steps(d, job):
        from flexflow_tpu_torch import obs

        return [(e["direction"], e["step"]) for e in obs.read_run(
            os.path.join(d, job, f"{job}.jsonl"))
            if e["kind"] == "elastic_resize"]

    for job in ("train-a", "serve-b"):
        assert steps(obs_dir, job) == steps(jcfg.obs_dir, job)


def test_resize_failure_aborts_back_to_running():
    from torch_fleet_ranks import fleet_abort
    from torch_ranks import run_ranks

    res = run_ranks(fleet_abort, 4, timeout=120.0)
    for r in res:
        assert r["raised"] and r["state"] == "running"
        assert r["ordinals"] == [0, 1, 2, 3]
        assert r["stepping"] is True
        assert len(r["losses"]) == 1 and math.isfinite(r["losses"][0])
    assert res[0]["states"][-2:] == [("draining", "running"),
                                     ("running", "draining")]
    assert res[0]["aborts"] == 1


def test_report_fleet_renders_and_checks(tmp_path, capsys):
    from flexflow_tpu_torch.apps import report

    tsum, _ = _sim_run("torch", tmp_path)
    out = []
    assert report.fleet_main([str(tmp_path / "torch.jsonl")],
                             log=out.append) == 0
    assert "fleet" in out[0]
    trace = str(tmp_path / "f.trace.json")
    assert report.fleet_main([str(tmp_path / "torch.jsonl"), "--trace",
                              trace], log=out.append) == 0
    assert os.path.exists(trace)
    # a tampered fleet_util record breaks the invariant: exit 1
    import json

    lines = open(tmp_path / "torch.jsonl").read().splitlines()
    tampered = False
    with open(tmp_path / "bad.jsonl", "w") as f:
        for line in lines:
            rec = json.loads(line)
            if rec.get("kind") == "fleet_util" and not tampered:
                rec["idle_steps"] += 1
                tampered = True
            f.write(json.dumps(rec) + "\n")
    said = []
    assert report.fleet_main([str(tmp_path / "bad.jsonl")],
                             log=said.append) == 1
    assert any("FLEET_UTIL INVARIANT VIOLATED" in s for s in said)
