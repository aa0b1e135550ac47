"""The port's disaggregated serving against the JAX package's
(``tests/test_disagg.py``): the KV handoff's export and import, its
pricing, the carried-token batcher, ``decode_step_ratio``, and the router
over two one-device prefill replicas and one one-device decode replica
(JAX's over ``machine8.shrink([j])``, the port's over one-rank CPU
machines), from one set of JAX parameters:

* replies, virtual stamps, ``router_summary`` (but ``wall_s``) and every
  record (``serve_handoff`` among them) equal JAX's, the two routers'
  machines sharing one topology, and the routed replies equal the single
  pool's;
* the drain contract;
* ``apps.serve``'s ``_disagg_run`` over CPU devices, and its refusal in
  one process of a replica wider than one device, naming ``torchrun``
  (``tests/test_torch_disagg_ranks.py`` runs such replicas over ranks).
"""

import numpy as np
import pytest
import torch

import torch_serve_pools as sp_pools
import torch_sim_parity as sp
from flexflow_tpu.serve import batcher as j_batcher
from flexflow_tpu.serve import kv_cache as j_kv
from flexflow_tpu.serve import loadgen as j_loadgen
from flexflow_tpu_torch.serve import batcher as t_batcher
from flexflow_tpu_torch.serve import kv_cache as t_kv
from flexflow_tpu_torch.serve import loadgen as t_loadgen

torch.set_num_threads(2)


def _layouts(max_seq=16, heads=4, head_dim=8, layers=2, batch=4, **grid):
    kw = dict(num_layers=layers, num_heads=heads, head_dim=head_dim,
              max_seq=max_seq, max_batch=batch, **grid)
    return j_kv.KVCacheLayout(**kw), t_kv.KVCacheLayout(**kw)


def _fill(caches, slot, n, seed=0):
    """Write ``n`` positions one at a time into ``slot`` of every cache."""
    rng = np.random.RandomState(seed)
    lay = caches[0].layout
    ks = rng.randn(lay.num_layers, n, lay.num_heads,
                   lay.head_dim).astype(np.float32)
    vs = rng.randn(*ks.shape).astype(np.float32)
    for cache in caches:
        for pos in range(n):
            for li in range(lay.num_layers):
                cache.write(li, slot, pos, ks[li, pos], vs[li, pos])
    return ks, vs


# ---------------------------------------------------------------------------
# the KV handoff


@pytest.mark.parametrize("src,dst,n,slots,want_len", [
    # across differing grids
    (dict(s_parts=2, h_parts=2), dict(h_parts=4, n_parts=2), 7, (1, 2), 7),
    # uneven carve-outs: 6 heads on 4, a 10-row window on 3
    (dict(max_seq=10, heads=6, s_parts=3), dict(max_seq=10, heads=6,
                                                 h_parts=4), 9, (0, 3), 9),
    # a wrapped ring keeps the logical length
    (dict(max_seq=8), dict(max_seq=8, n_parts=2), 13, (0, 0), 13),
    # a narrower destination window keeps the newest rows
    (dict(max_seq=12), dict(max_seq=5), 9, (2, 1), 9),
])
def test_kv_export_import_round_trips_as_jax(src, dst, n, slots, want_len):
    j_src, t_src = _layouts(**src)
    j_dst, t_dst = _layouts(**dst)
    caches = [j_kv.KVCache(j_src), t_kv.KVCache(t_src)]
    ks, vs = _fill(caches, slots[0], n, seed=n)
    jp, tp = (c.export_request(slots[0]) for c in caches)
    assert set(tp) == set(jp)
    assert (tp["length"], tp["start"], tp["grid"]) == \
        (jp["length"], jp["start"], jp["grid"])
    np.testing.assert_array_equal(tp["k"], jp["k"])
    np.testing.assert_array_equal(tp["v"], jp["v"])
    jd, td = j_kv.KVCache(j_dst), t_kv.KVCache(t_dst)
    assert td.import_request(slots[1], tp) == \
        jd.import_request(slots[1], jp) == want_len
    kept = min(n, t_src.max_seq, t_dst.max_seq)
    for li in range(t_src.num_layers):
        k2, v2 = td.read(li, slots[1])
        np.testing.assert_array_equal(k2, jd.read(li, slots[1])[0])
        np.testing.assert_array_equal(k2, ks[li, n - kept:])
        np.testing.assert_array_equal(v2, vs[li, n - kept:])
    np.testing.assert_array_equal(td.lengths, jd.lengths)


def test_kv_export_empty_and_import_validation():
    _, lay = _layouts()
    src = t_kv.KVCache(lay)
    assert src.export_request(0) is None
    assert src.import_request(0, None) == 0
    other = t_kv.KVCache(_layouts(heads=8)[1])
    _fill([src], 0, 3)
    with pytest.raises(ValueError, match="shape mismatch"):
        other.import_request(0, src.export_request(0))


@pytest.mark.parametrize("src,dst,n", [
    (dict(s_parts=2), dict(n_parts=2), 7),
    (dict(s_parts=2), dict(n_parts=2), 14),
    ({}, {}, 7),
    (dict(h_parts=2, n_parts=2), dict(max_seq=5, h_parts=4), 11),
])
def test_plan_kv_handoff_prices_as_jax(src, dst, n):
    from flexflow_tpu.machine import Topology as JTopology

    from flexflow_tpu_torch.machine import Topology

    j_src, t_src = _layouts(**src)
    j_dst, t_dst = _layouts(**dst)
    want = j_kv.plan_kv_handoff(j_src, j_dst, n, src_topology=JTopology(),
                                dst_topology=JTopology())
    got = t_kv.plan_kv_handoff(t_src, t_dst, n, src_topology=Topology(),
                               dst_topology=Topology())
    assert got == want
    hops = 1 + (t_src.s_parts * t_src.h_parts * t_src.n_parts > 1) \
        + (t_dst.s_parts * t_dst.h_parts * t_dst.n_parts > 1)
    assert got["hops"] == hops
    assert got["bytes"] == 2 * 2 * min(n, 16) * 4 * 8 * 4


def test_plan_kv_handoff_fallback_is_the_cards():
    """Without a topology the hop is priced at a tenth of the H100's HBM
    rate (JAX: its TPU's): the one place the two prices differ."""
    from flexflow_tpu_torch.sim.cost_model import HopperChipPerf

    _, lay = _layouts()
    got = t_kv.plan_kv_handoff(lay, lay, 7)
    kb = 2.0 * 2 * 7 * 4 * 8 * 4
    assert got["hops"] == 1
    assert got["predicted_s"] == pytest.approx(
        kb / (HopperChipPerf().hbm_bandwidth / 10.0) + 1e-6, rel=1e-12)


def test_kv_cache_bytes_and_describe_match_jax(machine8):
    from flexflow_tpu.apps.serve import _build_lm

    from flexflow_tpu_torch.apps import serve
    from flexflow_tpu_torch.machine import MachineModel

    jm, _ = _build_lm(machine8, batch=8, seed=0, tiny=True)
    tm, _ = serve.build_lm(batch=8, seed=0, tiny=True,
                           machine=MachineModel.virtual(8))
    assert t_kv.kv_cache_bytes(tm, 8) == j_kv.kv_cache_bytes(jm, 8) > 0
    assert t_kv.KVCacheLayout.from_model(tm, 8).describe() == \
        j_kv.KVCacheLayout.from_model(jm, 8).describe()


# ---------------------------------------------------------------------------
# the batcher's carried tokens and effective arrivals


def test_eff_arrival_orders_by_handoff_and_push():
    for mod, lg in ((j_batcher, j_loadgen), (t_batcher, t_loadgen)):
        early = lg.Request(rid=1, arrival_v=0.0, tokens=np.array([2, 3]),
                           max_new_tokens=2)
        early.handoff_v = 5.0
        late = lg.Request(rid=2, arrival_v=1.0, tokens=np.array([2, 3]),
                          max_new_tokens=2)
        assert mod._eff_arrival(early) == 5.0
        assert mod._eff_arrival(late) == 1.0
        q = mod.RequestQueue([early, late])
        assert q.next_arrival() == 1.0
        assert [r.rid for r in q.pop_ready(2.0, 4)] == [2]
        assert [r.rid for r in q.pop_ready(5.0, 4)] == [1]
        # push keeps (effective arrival, rid) order, out of order too
        q = mod.RequestQueue([late])
        q.push(early)
        third = lg.Request(rid=0, arrival_v=1.0, tokens=np.array([2]),
                           max_new_tokens=1)
        q.push(third)
        assert [r.rid for r in q.pop_ready(9.0, 9)] == [0, 2, 1]


def test_admit_keeps_stamps_and_carried_tokens_and_release():
    got = []
    for mod, lg in ((j_batcher, j_loadgen), (t_batcher, t_loadgen)):
        req = lg.Request(rid=7, arrival_v=0.0, tokens=np.array([2, 3, 4]),
                         max_new_tokens=4)
        req.admit_v = 0.25
        req.carried_tokens = [9]
        req.handoff_v = 1.0
        b = mod.ContinuousBatcher(max_batch=2, max_len=16)
        idx = b.admit(mod.RequestQueue([req]), 2.0)
        slot = b.slots[idx[0]]
        released = b.release(idx[0])
        got.append((idx, slot.req.admit_v, slot.generated, slot.tokens,
                    released is slot, released.req.done_v,
                    b.num_active()))
    assert got[0] == got[1] == ([0], 0.25, 1, [2, 3, 4, 9], True, None, 0)


def test_decode_step_ratio_matches_jax(machine8):
    """With JAX's constants the ratio is JAX's within 1e-12, on the data
    parallel default and under a strategy that splits the attention."""
    from flexflow_tpu.apps.serve import _build_lm
    from flexflow_tpu.sim.search import decode_step_ratio as j_ratio
    from flexflow_tpu.strategy import ParallelConfig as JPC
    from flexflow_tpu.strategy import Strategy as JStrategy

    from flexflow_tpu_torch.apps import serve
    from flexflow_tpu_torch.machine import MachineModel
    from flexflow_tpu_torch.sim.search import decode_step_ratio
    from flexflow_tpu_torch.strategy import Strategy

    jm, _ = _build_lm(machine8, batch=8, seed=0, tiny=True)
    tm, _ = serve.build_lm(batch=8, seed=0, tiny=True,
                           machine=MachineModel.virtual(8))
    want = j_ratio(jm)
    got = decode_step_ratio(tm, perf=sp.jax_perf())
    assert 0.0 < got < 0.5
    assert got == pytest.approx(want, rel=1e-12)
    js = JStrategy({"blk0_attn": JPC((2, 2, 2), tuple(range(8))),
                    "lm_head": JPC((4, 2), tuple(range(8)))})
    ts = Strategy.from_json(js.to_json())
    assert decode_step_ratio(tm, ts, perf=sp.jax_perf()) == \
        pytest.approx(j_ratio(jm, js), rel=1e-12)
    # the card's constants are the default: another ratio, still in (0, 1]
    assert 0.0 < decode_step_ratio(tm) <= 1.0


# ---------------------------------------------------------------------------
# the router


@pytest.fixture(scope="module")
def models(machine8):
    return sp_pools.Models(machine8, 2, 1)


def test_routed_run_matches_jax_and_the_single_pool(models, tmp_path):
    from flexflow_tpu_torch.apps import serve
    from flexflow_tpu_torch.serve.engine import ServeEngine

    want = sp_pools.routed(models, False, path=tmp_path / "j.jsonl")
    got = sp_pools.routed(models, True, path=tmp_path / "t.jsonl")
    sp_pools.same_run(want, got)
    reqs, summary, _, _, records = got
    assert summary["completed"] == summary["handoffs"] == 12
    assert summary["unserved"] == summary["kv_refetches"] == 0
    assert summary["affinity_hits"] >= 1
    assert summary["pools"]["prefill"]["replicas"] == 2
    assert summary["pools"]["decode"]["devices"] == 1
    handoffs = [r for r in records if r["kind"] == "serve_handoff"]
    assert len(handoffs) == 12 and all(r["hops"] == 1 for r in handoffs)
    # disaggregation moves WHERE tokens decode, never WHAT decodes
    model, _ = serve.build_lm(batch=8, seed=0, tiny=True, device="cpu")
    single = ServeEngine(model, params=models.params, log=lambda *a: None)
    sreqs = sp_pools.session_load(t_loadgen)
    single.run(sreqs)
    assert sp_pools.replies(reqs) == sp_pools.replies(sreqs)


def test_drain_contract_matches_jax(models):
    want = sp_pools.routed(models, False, drain=sp_pools.DrainAfter(3))
    got = sp_pools.routed(models, True, drain=sp_pools.DrainAfter(3))
    sp_pools.same_run(want, got)
    summary = got[1]
    assert summary["drained"] and summary["unserved"] >= 1
    assert summary["completed"] + summary["unserved"] == 12


def test_router_affinity_eviction_and_phases(models):
    from flexflow_tpu_torch.serve.router import ServeRouter

    prefill, decode = models.engines(True)
    router = ServeRouter(prefill, decode, log=lambda *a: None,
                         residency_factor=1)
    cap = router._residency_cap[0]
    first = router._route_decode(sp_pools.request(t_loadgen, 0,
                                                  session=1000))
    assert router._route_decode(sp_pools.request(
        t_loadgen, 1, session=1000)) == first
    assert router.affinity_hits == 1
    for i in range(cap):
        router._route_decode(sp_pools.request(t_loadgen, 10 + i,
                                              session=2000 + i))
    assert 1000 not in router._residency[first]
    router._route_decode(sp_pools.request(t_loadgen, 99, session=1000))
    assert router.kv_refetches == 1
    for bad in ((decode, decode), (prefill, prefill), ([], decode)):
        with pytest.raises(ValueError):
            ServeRouter(*bad, log=lambda *a: None)


def _opts(**kw):
    from flexflow_tpu_torch.apps import serve

    opts = serve.parse_args(["gpt", "--tiny", "--device", "cpu", "-n", "6",
                             "--rate-qps", "200", "--max-new-tokens", "3"])
    opts.update(kw)
    return opts


def test_disagg_run_over_cpu_devices():
    from flexflow_tpu_torch import obs
    from flexflow_tpu_torch.apps import serve

    opts = _opts(prefill_devices=2, prefill_replicas=2, decode_replicas=1)
    assert serve.pool_devices(opts) == ["cpu"] * 3
    summary = serve._disagg_run(opts, serve.pool_devices(opts), obs.NULL,
                                None, lambda *a: None, drain={})
    assert summary["completed"] == summary["handoffs"] == 6
    assert summary["pools"]["prefill"]["replicas"] == 2
    assert summary["pools"]["decode"]["replicas"] == 1
    assert summary["devices"] == 3


@pytest.mark.parametrize("kw,match", [
    (dict(prefill_devices=2, prefill_replicas=1, decode_replicas=1),
     "a replica of several devices .* under torchrun"),
    (dict(prefill_devices=3, prefill_replicas=3, decode_replicas=1),
     "must split"),
    (dict(prefill_devices=2, prefill_replicas=3, decode_replicas=1),
     "split evenly"),
])
def test_disagg_run_refuses_wide_replicas_and_bad_splits(kw, match):
    from flexflow_tpu_torch import obs
    from flexflow_tpu_torch.apps import serve

    with pytest.raises(SystemExit, match=match):
        serve._disagg_run(_opts(**kw), ["cpu"] * 3, obs.NULL, None,
                          lambda *a: None, drain={})
