"""The port's routed replicas wider than one card (``serve/replicas.py``,
``MachineModel.running_slice``, ``apps.serve``'s pools over ranks)
against the JAX package's router over sub-mesh replicas
(``tests/test_disagg.py``), in one world of four gloo CPU ranks:

* a running slice of ranks [2, 3] runs its all-reduces and a regrid
  while ranks [0, 1] run their own slice, neither waiting for the other;
* the tiny GPT's prefill replica of 2 ranks and decode replica of 2
  ranks on the multi-turn session load: replies, virtual stamps, the
  ``router_summary`` (but ``wall_s``) and every record (the
  ``serve_handoff`` records' bytes, hops and ``predicted_s`` among them)
  equal JAX's router over ``machine8.shrink([0, 1])`` and
  ``shrink([2, 3])``, and the decode replica's ``decode_step_ratio``
  JAX's within 1e-12; the same under
  ``replica_crash@3,handoff_drop@5,kv_corrupt@7``; the same world as two
  one-rank prefill replicas and a two-rank decode replica against JAX's
  over ``shrink([0])``, ``shrink([1])`` and ``shrink([2, 3])``; four
  one-rank replicas racing hedged decodes past a slow replica;
* a drain requested on one rank alone stops admission on all four at
  the router iteration JAX's drain stops at.

The decode replicas' virtual step is JAX's (``DEFAULT_STEP_TIME_S``
times JAX's ``decode_step_ratio``), handed to both routers.
"""

import dataclasses

import numpy as np
import pytest
import torch

import torch_ranks as tr
import torch_serve_pools as sp_pools
import torch_sim_parity as sp

torch.set_num_threads(2)

FAULTS = "replica_crash@3,handoff_drop@5,kv_corrupt@7"
#: label -> (prefill replicas' devices, decode replicas' devices, fault
#: spec, (drain iteration, the one rank that asks), hedged decode)
CASES = {"2+2": ([(0, 1)], [(2, 3)], None, None, False),
         "2+2 faults": ([(0, 1)], [(2, 3)], FAULTS, None, False),
         "1+1+2": ([(0,), (1,)], [(2, 3)], None, None, False),
         "1+1+1+1 hedged": ([(0,), (1,)], [(2,), (3,)], "slow_replica@1x6",
                            None, True),
         "2+2 drain": ([(0, 1)], [(2, 3)], None, (3, 2), False)}


class _JaxPools:
    """The JAX package's tiny GPT replicas on the given sub-meshes of
    ``machine8``, at 2 slots each."""

    def __init__(self, machine8, prefill, decode):
        from flexflow_tpu.apps.serve import _build_lm
        from flexflow_tpu.serve.engine import DEFAULT_STEP_TIME_S
        from flexflow_tpu.sim.search import decode_step_ratio

        def build(devs):
            return _build_lm(machine8.shrink(list(devs)), batch=2, seed=0,
                             tiny=True)[0]

        self.jp = [build(d) for d in prefill]
        self.jd = [build(d) for d in decode]
        self.prefill_step = DEFAULT_STEP_TIME_S
        self.ratio = decode_step_ratio(self.jd[0])
        self.decode_step = DEFAULT_STEP_TIME_S * self.ratio

    def run(self, spec, path, drain, hedge):
        """JAX's routed run of the session load, every engine and the
        router writing to one stream: ``(requests, summary, injector,
        None, records)``, as ``torch_serve_pools.routed`` returns them."""
        from flexflow_tpu import obs
        from flexflow_tpu.serve import loadgen
        from flexflow_tpu.serve.engine import ServeEngine
        from flexflow_tpu.serve.router import ServeRouter
        from flexflow_tpu.utils import faultinject

        olog = obs.RunLog(str(path), surface="serve")

        def make(m, step, phase):
            return ServeEngine(m, None, olog=olog, log=lambda *a: None,
                               step_time_s=step, phase=phase)
        router = ServeRouter(
            [make(m, self.prefill_step, "prefill") for m in self.jp],
            [make(m, self.decode_step, "decode") for m in self.jd],
            olog=olog, log=lambda *a: None, hedge=hedge)
        inj, restore = None, (lambda: None)
        if spec is not None:
            inj = faultinject.FaultInjector(spec, olog=olog)
            restore = faultinject.install_scoped(inj)
        try:
            reqs = sp_pools.session_load(loadgen)
            summary = router.run(reqs, drain=drain)
        finally:
            restore()
        olog.close()
        records = [{k: v for k, v in r.items()
                    if k not in sp_pools.WALL_FIELDS}
                   for r in obs.read_run(olog.path)
                   if r["kind"] not in ("run_start", "run_end")]
        return reqs, summary, inj, None, records


@pytest.fixture(scope="module")
def world(machine8, tmp_path_factory):
    """JAX's routed run of every case, and every port case (with the
    slices' check first) in one four-rank world: ``(jax runs by label,
    JAX's decode ratios by label, port results per rank by label)``."""
    tmp = tmp_path_factory.mktemp("disagg_ranks")
    perf = dataclasses.asdict(sp.jax_perf())
    trees = None
    want, ratios, cases = {}, {}, [("slice_collectives", ())]
    for i, (label, (pre, dec, spec, drain, hedge)) in enumerate(
            CASES.items()):
        pools = _JaxPools(machine8, pre, dec)
        if trees is None:
            tree, state = pools.jp[0].init(0)
            full, _ = tr.jax_logical(pools.jp[0], tree, state)
            trees = str(tmp / "trees.npz")
            tr.save_trees(trees, full, {})
        want[label] = pools.run(
            spec, tmp / f"j{i}.jsonl",
            sp_pools.DrainAfter(drain[0]) if drain else None, hedge)
        ratios[label] = pools.ratio
        cases.append(("routed_case", (
            trees, (sum(len(d) for d in pre), len(pre)), len(dec),
            pools.decode_step, perf, spec, str(tmp / f"t{i}.jsonl"))
            + (drain or (None, None)) + (hedge,)))
    ranks = tr.run_ranks(tr.run_cases, 4, cases, timeout=200)
    got = [dict(zip(["slices"] + list(CASES), res)) for res in ranks]
    return want, ratios, got


def test_running_slices_do_not_wait_on_each_other(world):
    from flexflow_tpu_torch.model import FFModel
    from flexflow_tpu_torch.config import FFConfig

    _, _, got = world
    sums = [res["slices"][1] for res in got]
    assert sums == [[1.0, 21.0, 41.0]] * 2 + [[5.0]] * 2
    assert [tuple(res["slices"][0]) for res in got] == \
        [(0, 1), (0, 1), (2, 3), (2, 3)]
    # the forward through the regrid on each slice: one process's
    cfg = FFConfig(batch_size=4, input_height=16, input_width=16,
                   num_classes=8)
    one = FFModel(cfg, device="cpu")
    tr.verify_net(one, one.create_input((4, 16, 16, 3), name="image"))
    params, state = one.init(0)
    x = np.random.RandomState(5).uniform(-1, 1, (4, 16, 16, 3)).astype(
        np.float32)
    want = one.make_predict_step()(params, state, x)[0].numpy()
    for res in got:
        np.testing.assert_allclose(res["slices"][2], want, rtol=1e-5,
                                   atol=1e-6)
    np.testing.assert_array_equal(got[0]["slices"][2], got[2]["slices"][2])


def _same_run(want, got):
    jreqs, jsum, jinj, _, jrec = want
    replies, stamps, tsum, trec, fired, _, _ = got
    assert replies == sp_pools.replies(jreqs)
    assert stamps == sp_pools.stamps(jreqs)
    assert sp_pools._nan_safe([tsum]) == sp_pools._nan_safe(
        [{k: v for k, v in jsum.items() if k != "wall_s"}])
    if trec is not None:
        assert sp_pools._nan_safe(trec) == sp_pools._nan_safe(jrec)
    if jinj is not None:
        assert fired == jinj.fired()


@pytest.mark.parametrize("label", ["2+2", "2+2 faults", "1+1+2",
                                   "1+1+1+1 hedged"])
def test_routed_replicas_over_ranks_match_jax(world, label):
    want, ratios, got = world
    pre, dec = CASES[label][:2]
    for res in got:
        _same_run(want[label], res[label])
        assert res[label][5] == pytest.approx(ratios[label], rel=1e-12)
    summary = got[0][label][2]
    assert summary["completed"] == 12 and summary["failed"] == 0
    assert summary["devices"] == 4
    handoffs = [r for r in got[0][label][3] if r["kind"] == "serve_handoff"]
    # a two-rank replica's rows gather before the move and re-place after
    assert handoffs and all(
        r["hops"] == 1 + (len(pre[0]) > 1) + (len(dec[0]) > 1)
        for r in handoffs)
    if CASES[label][4]:
        assert summary["hedges"] >= 1
    if label == "2+2 faults":
        assert summary["kv_rebuilds"] >= 1 and summary["replica_down"] == 1
        assert got[0][label][4] == 3   # each fault of the spec fired once
    # every handoff's rows reach both decode ranks as the exporting
    # replica's first rank holds them, and no other rank takes part
    moves = [res[label][6] for res in got]
    senders = sorted(m for r in (0, 1) for m in moves[r])
    assert len(senders) == summary["handoffs"] + summary["hedges"]
    for j, ranks in enumerate(dec):
        for rank in ranks:
            # every rank of the decode replica receives each of its moves
            assert sorted(moves[rank]) == [m for m in senders if m[1] == j]
    if len(pre) == 1:
        assert moves[1] == []   # the prefill replica's second rank


def test_drain_on_one_rank_stops_every_rank_at_the_same_iteration(world):
    want, _, got = world
    for res in got:
        _same_run(want["2+2 drain"], res["2+2 drain"])
    summary = got[0]["2+2 drain"][2]
    assert summary["drained"] and summary["unserved"] >= 1
    assert summary["completed"] + summary["unserved"] == 12
