"""Elastic training in the PyTorch port, in one process, against the JAX
package (``tests/test_elastic.py``, ``tests/test_elastic_lifecycle.py``):
``classify`` on JAX's exceptions and the port's CUDA and NCCL ones,
``probe_devices``' outcomes and records, the machines' resize
validation, ``plan_state_migration``'s totals, the warm start and the
re-search (the iteration cap binding), the regrow context and probe
streak, ``directed_resize``'s and ``recover``'s refusals, the transient
retry budget, the watchdog's transient hang, ``--min-devices``, the
fatal loss without ``--elastic``, a healthy run unchanged by it, the
flags with JAX's defaults, and the data stream's rebinding.  The runs
over several ranks are ``tests/test_torch_elastic_ranks.py``.
"""

import dataclasses
import math

import numpy as np
import pytest
import torch
import torch.distributed as dist

import torch_ranks as tr
import torch_sim_parity as sp
from flexflow_tpu.config import FFConfig as JConfig
from flexflow_tpu.model import FFModel as JModel
from flexflow_tpu.obs import read_run as j_read_run
from flexflow_tpu.utils import elastic as j_elastic
from flexflow_tpu.utils.retry import RetryPolicy as JPolicy
from flexflow_tpu_torch import distributed
from flexflow_tpu_torch.config import ELASTIC_FIELDS, FFConfig
from flexflow_tpu_torch.data import BlockStream
from flexflow_tpu_torch.interop import params_from_jax
from flexflow_tpu_torch.machine import MachineModel, Topology
from flexflow_tpu_torch.obs import read_run
from flexflow_tpu_torch.utils import elastic
from flexflow_tpu_torch.utils.retry import RetryPolicy

torch.set_num_threads(2)

CFG = dict(batch_size=tr.ELASTIC_BATCH, input_height=16, input_width=16,
           num_iterations=10, print_freq=2, num_classes=8, seed=3,
           prefetch_depth=0)


def _jbuild(cfg, machine):
    ff = JModel(cfg, machine)
    img = ff.create_input((cfg.batch_size, 16, 16, 3), name="image")
    t = ff.conv2d("conv1", img, 8, 3, 3, 1, 1, 1, 1, relu=True)
    t = ff.flat("flat", t)
    t = ff.linear("fc", t, 8, relu=False)
    ff.softmax("softmax", t)
    return ff


def _jbatches():
    ring = tr.elastic_host_batches()
    i = 0
    while True:
        yield ring[i % len(ring)]
        i += 1


def _pair(machine1, tmp_path=None, **kw):
    """(JAX model on one device, port model in this process on the CPU)
    from one config, the port's initial params JAX's."""
    extra = {}
    if tmp_path is not None:
        extra = dict(obs_dir=str(tmp_path / "obs"), run_id="r")
    jm = _jbuild(JConfig(**dict(CFG, **kw, **extra)), machine1)
    tm = tr.elastic_build(FFConfig(**dict(CFG, **kw, **extra)),
                          MachineModel("cpu"))
    jp, _ = jm.init()
    p = params_from_jax(tr.jax_logical(jm, jp, {})[0], "cpu", model=tm)
    tm.init = lambda seed=None: (p, {})
    return jm, tm


def _stream():
    return BlockStream(tr.elastic_host_batches(), "cpu")


class _Log:
    def __init__(self):
        self.events = []
        self.enabled = True

    def event(self, kind, **fields):
        self.events.append(dict(fields, kind=kind))


def _records(path, read, kinds):
    keep = ("kind", "step", "classification", "source", "outcome",
            "after", "transient", "device", "failures", "dead", "live",
            "devices", "min_devices")
    return [{k: r[k] for k in keep if k in r} for r in read(path)
            if r["kind"] in kinds]


# ---------------------------------------------------------------------------
# classification and probing


class XlaRuntimeError(RuntimeError):
    """The type name the XLA runtime raises device failures as."""


class AcceleratorError(RuntimeError):
    """The type name of PyTorch's CUDA runtime errors."""


JAX_CASES = [XlaRuntimeError("device_unavailable: chip 3"),
             XlaRuntimeError("device unavailable"),
             XlaRuntimeError("invalid argument"),
             ValueError("device unavailable"),
             XlaRuntimeError("halted with an ICI link failure")]


@pytest.mark.parametrize("i", range(len(JAX_CASES)))
def test_classify_agrees_with_jax(i):
    e = JAX_CASES[i]
    assert elastic.classify(e) == j_elastic.classify(e)
    assert elastic.classify(elastic.DeviceLostError("x"))
    assert elastic.classify(elastic.DeviceLossDetected([1], 3))


PORT_CASES = [
    # PyTorch raises device failures as RuntimeError: JAX's patterns
    # count there too
    (RuntimeError("device unavailable"), True),
    (dist.DistBackendError("NCCL communicator was aborted on rank 1"), True),
    (dist.DistNetworkError("timed out reading from the store"), True),
    (RuntimeError("CUDA error: an illegal memory access was encountered"),
     True),
    (RuntimeError("CUDA error: unspecified launch failure"), True),
    (AcceleratorError("CUDA error: uncorrectable ECC error encountered"),
     True),
    (RuntimeError("NCCL error in: ProcessGroupNCCL.cpp:1891, unhandled "
                  "cuda error, NCCL version 2.21.5 ncclUnhandledCudaError"),
     True),
    (RuntimeError("[gloo/transport/tcp/pair.cc:534] Connection reset by "
                  "peer"), True),
    (RuntimeError("CUDA error: device-side assert triggered"), False),
    (RuntimeError("mat1 and mat2 shapes cannot be multiplied (4x3 and "
                  "5x2)"), False),
    (ValueError("CUDA error: an illegal memory access was encountered"),
     False),
]


@pytest.mark.parametrize("i", range(len(PORT_CASES)))
def test_classify_ports_cuda_and_nccl_errors(i):
    e, want = PORT_CASES[i]
    assert elastic.classify(e) is want


def test_probe_outcomes_match_jax(machine1):
    def flaky(fail_first):
        calls = {"n": 0}

        def probe(dev):
            calls["n"] += 1
            if calls["n"] <= fail_first:
                raise RuntimeError("hiccup")
        return probe

    for fail_first, want in ((0, ([0], [], [])), (1, ([0], [], [0])),
                             (99, ([], [0], []))):
        logs = _Log(), _Log()
        got = elastic.probe_devices(
            MachineModel("cpu"), policy=RetryPolicy(attempts=3,
                                                    base_delay=0.0,
                                                    jitter=0.0),
            probe=flaky(fail_first), olog=logs[0], sleep=lambda s: None)
        ref = j_elastic.probe_devices(
            machine1, policy=JPolicy(attempts=3, base_delay=0.0,
                                     jitter=0.0),
            probe=flaky(fail_first), olog=logs[1], sleep=lambda s: None)
        assert got == ref == want
        assert logs[0].events == logs[1].events


# ---------------------------------------------------------------------------
# the machines and the migration's accounting


def test_shrink_grow_validation_match_jax(machine8):
    m8 = MachineModel.virtual(8)
    m6 = m8.shrink([0, 1, 2, 3, 4, 5])
    j6 = machine8.shrink([0, 1, 2, 3, 4, 5])
    assert (m6.num_devices, m6.topology.devices_per_ici_group) == \
        (j6.num_devices, j6.topology.devices_per_ici_group) == (6, 6)
    assert m6.members == (0, 1, 2, 3, 4, 5) and m8.num_devices == 8
    assert m8.slice_of([1, 3]).members == (1, 3)
    for args in ([], [0, 99]):
        with pytest.raises(ValueError) as te:
            m8.shrink(args)
        with pytest.raises(ValueError) as je:
            machine8.shrink(args)
        assert str(te.value) == str(je.value)
    with pytest.raises(ValueError) as te:
        m8.devices_at([8])
    with pytest.raises(ValueError) as je:
        machine8.devices_at([8])
    assert str(te.value) == str(je.value)
    back = m6.grow(m8.devices_at([6, 7]))
    jback = j6.grow(machine8.devices_at([6, 7]))
    assert back.members == tuple(range(8))
    assert back.topology.devices_per_ici_group == \
        jback.topology.devices_per_ici_group == 8
    for bad, jbad, match in (([], [], "at least one"),
                             ([0], machine8.devices[:1], "already part"),
                             ([6, 6], machine8.devices[6:7] * 2,
                              "duplicates")):
        with pytest.raises(ValueError, match=match):
            m6.grow(bad)
        with pytest.raises(ValueError, match=match):
            j6.grow(jbad)


def test_plan_state_migration_equals_jax(machine8):
    from flexflow_tpu.parallel.regrid import plan_state_migration as j_plan

    from flexflow_tpu_torch.parallel.regrid import plan_state_migration

    jold = _jbuild(JConfig(**CFG), machine8)
    jnew = _jbuild(JConfig(**CFG), machine8.shrink(range(6)))
    jp, _ = jold.init()
    full = tr.jax_logical(jold, jp, {})[0]
    m8 = MachineModel.virtual(8, Topology(**dataclasses.asdict(
        machine8.topology)))
    old = tr.elastic_build(FFConfig(**CFG), m8)
    new = tr.elastic_build(FFConfig(**CFG), m8.shrink(range(6)))
    want = j_plan(jold, jnew, full)
    got = plan_state_migration(old, new, params_from_jax(full, "cpu",
                                                         model=old))
    for key in ("keys", "bytes", "hops", "from_devices", "to_devices"):
        assert got[key] == want[key], key
    assert got["predicted_s"] == pytest.approx(want["predicted_s"],
                                               rel=1e-12)
    assert [{k: r[k] for k in ("tree", "key", "bytes", "src_parts",
                               "dst_parts", "hops")} for r in got["rows"]] \
        == [{k: r[k] for k in ("tree", "key", "bytes", "src_parts",
                               "dst_parts", "hops")} for r in want["rows"]]


# ---------------------------------------------------------------------------
# the warm start and the re-search


@pytest.fixture
def jax_constants(monkeypatch):
    """The port's search on the JAX package's chip constants."""
    from flexflow_tpu_torch.sim import cost_model

    perf = sp.jax_perf()
    monkeypatch.setattr(cost_model, "HopperChipPerf", lambda: perf)


def test_warm_start_and_research_match_jax(machine8, jax_constants):
    from flexflow_tpu.sim.search import StrategySearch as JSearch

    from flexflow_tpu_torch.sim.search import StrategySearch

    jm8, tm8 = sp.machines(8)
    jm6, tm6 = jm8.shrink(range(6)), tm8.shrink(range(6))
    jold = _jbuild(JConfig(**CFG), jm8)
    told = tr.elastic_build(FFConfig(**CFG), tm8)
    jnew = _jbuild(JConfig(**CFG), jm6)
    tnew = tr.elastic_build(FFConfig(**CFG), tm6)
    j8, _ = JSearch(jold, machine=jm8).search(iters=0)
    t8, _ = StrategySearch(told, machine=tm8).search(iters=0)
    jss6, tss6 = JSearch(jnew, machine=jm6), StrategySearch(tnew,
                                                           machine=tm6)
    # every 8-device entry names a device the 6-device world lacks: all
    # invalidated to data parallel
    assert elastic.warm_assignment(tss6, t8) == tss6.dp_assignment() == \
        j_elastic.warm_assignment(jss6, j8)
    t6, _ = tss6.search(iters=0)
    j6, _ = jss6.search(iters=0)
    assert elastic.warm_assignment(tss6, t6) == tss6.assignment_for(t6)
    # the re-search: 300 proposals, a budget the clock never reaches
    kw = dict(CFG, research_budget_s=1e6, elastic_search_iters=300)
    got, info = elastic.research_strategy(
        FFConfig(**kw), tr.elastic_build, tm6, t8, fallback_strategy=t6,
        log=lambda *a: None)
    want, jinfo = j_elastic.research_strategy(
        JConfig(**kw), _jbuild, jm6, j8, fallback_strategy=j6,
        log=lambda *a: None)
    assert got.to_json() == want.to_json()
    assert (info["mode"], info["iters"], info["budget_hit"]) == \
        (jinfo["mode"], jinfo["iters"], jinfo["budget_hit"]) == \
        ("mcmc", 300, False)
    assert info["best_time_s"] == pytest.approx(jinfo["best_time_s"],
                                                rel=1e-9)


# ---------------------------------------------------------------------------
# the regrow context, directed resizes and the refusals


class _Inj:
    """Fires ``device_return`` on its second call."""
    enabled = True

    def __init__(self):
        self.n = 0

    def fire(self, kind, site=""):
        assert kind == "device_return"
        self.n += 1
        return self.n == 2


def test_regrow_context_and_probe_streak_match_jax(machine8):
    sig = elastic.DeviceLossDetected([6, 7], 4, injected=True)
    jsig = j_elastic.DeviceLossDetected([6, 7], 4, injected=True)
    tm = tr.elastic_build(FFConfig(**CFG), MachineModel.virtual(8))
    ctx = elastic.make_regrow_context(tm, sig, probes_needed=2)
    jctx = j_elastic.make_regrow_context(_jbuild(JConfig(**CFG), machine8),
                                         jsig, probes_needed=2)
    assert ctx["dead"] == [(6, True), (7, True)]
    keys = ("healthy", "probes", "k", "answering")
    inj, jinj = _Inj(), _Inj()
    for _ in range(3):
        assert elastic.probe_regrow(ctx, inj=inj, log=lambda *a: None) == \
            j_elastic.probe_regrow(jctx, inj=jinj, log=lambda *a: None)
        assert {k: ctx[k] for k in keys} == {k: jctx[k] for k in keys}
    assert ctx["healthy"] == 2 and ctx["probes"] == 3

    def flapping():
        n = {"n": 0}

        def probe(dev):
            n["n"] += 1
            if n["n"] == 2:
                raise RuntimeError("flap")
        return probe

    ctx = {"dead": [(7, False)], "healthy": 0, "probes": 0, "k": 2,
           "answering": False}
    jctx = dict(ctx, dead=[(machine8.devices[7], False)])
    probe, jprobe = flapping(), flapping()
    streak = []
    for _ in range(4):
        got = elastic.probe_regrow(ctx, probe=probe, log=lambda *a: None)
        assert got == j_elastic.probe_regrow(jctx, probe=jprobe,
                                             log=lambda *a: None)
        streak.append(ctx["healthy"])
        assert ctx["healthy"] == jctx["healthy"]
    assert streak == [1, 0, 1, 2]


def test_directed_resize_and_recovery_refusals_match_jax(machine8):
    tm = tr.elastic_build(FFConfig(**CFG), MachineModel.virtual(8))
    jm = _jbuild(JConfig(**CFG), machine8)
    common = dict(step=4, params={}, state={}, rebuild=None)
    for kw in (dict(), dict(keep=[0], add=[7]), dict(keep=[0, 9]),
               dict(keep=range(8)), dict(add=[])):
        with pytest.raises(ValueError) as te:
            elastic.directed_resize(tm, **kw, **common)
        with pytest.raises(ValueError) as je:
            j_elastic.directed_resize(jm, **kw, **common)
        assert str(te.value) == str(je.value)
    # no rebuild factory: shrink and grow refuse, as JAX's do
    sig = elastic.DeviceLossDetected([7], 4, params={})
    jsig = j_elastic.DeviceLossDetected([7], 4, params={})
    with pytest.raises(elastic.DeviceLostError) as te:
        elastic.recover(tm, sig, None, log=lambda *a: None)
    with pytest.raises(j_elastic.DeviceLostError) as je:
        j_elastic.recover(jm, jsig, None, log=lambda *a: None)
    assert str(te.value) == str(je.value) and "rebuild" in str(te.value)
    m6 = tr.elastic_build(FFConfig(**CFG), MachineModel.virtual(8).shrink(
        range(6)))
    ctx = {"dead": [(6, True), (7, True)], "probes": 2, "healthy": 2}
    with pytest.raises(elastic.DeviceLostError, match="regrow needs a "
                                                      "model factory"):
        elastic.recover_grow(m6, elastic.DeviceReturnDetected([6, 7], 6),
                             ctx, None, log=lambda *a: None)
    # below --min-devices: refused before anything moves
    cfg = FFConfig(**dict(CFG, min_devices=8))
    with pytest.raises(elastic.ElasticShrinkRefused) as te:
        elastic.recover(tr.elastic_build(cfg, MachineModel.virtual(8)),
                        sig, tr.elastic_build, log=lambda *a: None)
    with pytest.raises(j_elastic.ElasticShrinkRefused) as je:
        j_elastic.recover(_jbuild(JConfig(**dict(CFG, min_devices=8)),
                                  machine8), jsig, _jbuild,
                          log=lambda *a: None)
    assert str(te.value) == str(je.value)


def test_resize_needs_a_stream_that_rebinds():
    with pytest.raises(elastic.DeviceLostError, match="BlockStream"):
        elastic._check_stream(iter([]))
    elastic._check_stream(_stream())
    elastic._check_stream(None)
    with pytest.raises(RuntimeError, match="distributed.initialize"):
        saved = distributed._STATE["store"]
        distributed._STATE["store"] = None
        try:
            distributed.reform([0], 1)
        finally:
            distributed._STATE["store"] = saved


# ---------------------------------------------------------------------------
# fit in one process


def test_min_devices_refusal_in_fit_matches_jax(machine1, tmp_path):
    kw = dict(elastic=True, min_devices=1, fault_spec="device_loss@3")
    _, tm = _pair(machine1, tmp_path / "port", **kw)
    jm, _ = _pair(machine1, tmp_path / "jax", **kw)
    with pytest.raises(elastic.ElasticShrinkRefused) as te:
        tm.fit(_stream(), log=lambda *a: None, rebuild=tr.elastic_build)
    with pytest.raises(j_elastic.ElasticShrinkRefused) as je:
        jm.fit(_jbatches(), log=lambda *a: None, rebuild=_jbuild)
    assert str(te.value) == str(je.value)
    kinds = ("device_loss", "elastic_refused")
    got = _records(tmp_path / "port" / "obs" / "r.jsonl", read_run, kinds)
    assert got == _records(tmp_path / "jax" / "obs" / "r.jsonl", j_read_run,
                           kinds)
    assert [r["kind"] for r in got] == ["device_loss", "elastic_refused"]


def test_device_loss_fatal_without_elastic_matches_jax(machine1):
    jm, tm = _pair(machine1, fault_spec="device_loss@3")
    with pytest.raises(elastic.DeviceLostError) as te:
        tm.fit(_stream(), log=lambda *a: None, rebuild=tr.elastic_build)
    with pytest.raises(j_elastic.DeviceLostError) as je:
        jm.fit(_jbatches(), log=lambda *a: None, rebuild=_jbuild)
    assert str(te.value) == str(je.value) and "--elastic" in str(te.value)


def test_healthy_run_bit_equal_with_elastic(machine1):
    def run(**kw):
        _, tm = _pair(machine1, num_iterations=4, print_freq=0, **kw)
        return tm.fit(_stream(), log=lambda *a: None,
                      rebuild=tr.elastic_build)

    off = run()
    on = run(elastic=True, min_devices=1, hang_factor=50.0,
             hang_min_s=120.0)
    assert on["loss"] == off["loss"] and len(on["loss"]) == 4
    assert (on["elastic_resizes"], on["devices"]) == (0, 1)


def _flaky(model, fail_steps):
    real = model.make_train_step()
    st = {"done": 0, "failed": set()}

    def step(params, state, opt, *batch):
        nxt = st["done"] + 1
        if nxt in fail_steps and nxt not in st["failed"]:
            st["failed"].add(nxt)
            raise XlaRuntimeError("device unavailable (injected flake)")
        out = real(params, state, opt, *batch)
        st["done"] += 1
        return out

    model.make_train_step = lambda: step
    return model


def test_transient_window_refills_budget_matches_jax(machine1, tmp_path):
    jm, tm = _pair(machine1, tmp_path / "port", elastic=True,
                   transient_reset_steps=1)
    out = _flaky(tm, {2, 4, 6, 8}).fit(_stream(), log=lambda *a: None)
    jm, _ = _pair(machine1, tmp_path / "jax", elastic=True,
                  transient_reset_steps=1)
    jout = _flaky(jm, {2, 4, 6, 8}).fit(_jbatches(), log=lambda *a: None)
    assert len(out["loss"]) == 10
    np.testing.assert_allclose(out["loss"], jout["loss"], rtol=1e-4)
    kinds = ("device_loss", "recovery", "device_probe")
    got = _records(out["obs_path"], read_run, kinds)
    assert got == _records(jout["obs_path"], j_read_run, kinds)
    assert len([r for r in got if r["kind"] == "device_loss"
                and r["classification"] == "transient"]) == 4
    assert len([r for r in got if r.get("after") == "transient_window"]) >= 2


def test_transient_budget_exhausts_without_window(machine1):
    _, tm = _pair(machine1, elastic=True, transient_reset_steps=0)
    with pytest.raises(XlaRuntimeError, match="device unavailable"):
        _flaky(tm, {2, 3, 4, 5}).fit(_stream(), log=lambda *a: None)
    # without --elastic the first flake propagates
    _, tm = _pair(machine1)
    with pytest.raises(XlaRuntimeError):
        _flaky(tm, {2}).fit(_stream(), log=lambda *a: None)


def test_watchdog_transient_hang_continues_matches_jax(machine1, tmp_path):
    kw = dict(num_iterations=6, elastic=True, hang_factor=1.0,
              hang_min_s=0.2, fault_spec="step_hang@2")
    jm, tm = _pair(machine1, tmp_path / "port", **kw)
    out = tm.fit(_stream(), log=lambda *a: None)
    jm, _ = _pair(machine1, tmp_path / "jax", **kw)
    jout = jm.fit(_jbatches(), log=lambda *a: None)
    assert len(out["loss"]) == 6
    kinds = ("step_hang", "device_loss")
    got = _records(out["obs_path"], read_run, kinds)
    assert got == _records(jout["obs_path"], j_read_run, kinds)
    assert [(r["kind"], r.get("source")) for r in got] == \
        [("step_hang", None), ("device_loss", "watchdog")]


# ---------------------------------------------------------------------------
# the flags and the stream


def test_elastic_flags_take_jax_defaults():
    for flag, (field, _) in ELASTIC_FIELDS.items():
        assert getattr(FFConfig(), field) == getattr(JConfig(), field), flag
    from flexflow_tpu_torch.models.transformer import TransformerConfig

    for _, (field, _) in ELASTIC_FIELDS.items():
        assert getattr(TransformerConfig(), field) == \
            getattr(JConfig(), field)


def test_block_stream_rebinds_at_its_position():
    ring = tr.elastic_host_batches()
    s = BlockStream(ring, "cpu")
    first = next(s)
    assert torch.equal(first[0], torch.from_numpy(ring[0][0]))
    half = MachineModel("cpu", world_size=2, rank=1)
    s.rebind(half)
    image, labels = next(s)
    lo, hi = half.batch_block(tr.ELASTIC_BATCH)
    assert (lo, hi) == (12, 24) and s.position == 2
    assert torch.equal(image, torch.from_numpy(ring[1][0][lo:hi]))
    assert torch.equal(labels, torch.from_numpy(ring[1][1][lo:hi]))
    s.rebind(None, position=7)
    assert torch.equal(next(s)[1], torch.from_numpy(ring[3][1]))
    assert math.isclose(float(s.position), 8.0)
