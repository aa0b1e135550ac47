"""Shared pieces of the disaggregated-serving parity tests
(``tests/test_torch_disagg.py``, ``tests/test_torch_serve_faults.py``):
the tiny GPT's prefill and decode replicas in both packages, one device
each (JAX: ``machine8.shrink([j])``; the port: a one-rank CPU
``MachineModel``), from one set of JAX initial parameters, and a routed
run of the same seeded load under the same fault spec in both, with its
obs records read back.

The decode replicas' virtual step is ``DEFAULT_STEP_TIME_S`` times JAX's
``decode_step_ratio`` of its decode model, handed to both packages, so
that both routers keep one virtual clock.
"""

from __future__ import annotations

import jax
import numpy as np

#: the record fields that are wall-clock readings, left out of comparisons
WALL_FIELDS = ("ts", "run", "wall_s", "t_wall", "pid")


def session_load(mod):
    """``tests/test_disagg.py``'s multi-turn load from loadgen ``mod``."""
    return mod.patterned_requests(12, seed=0, rate_qps=50.0,
                                  pattern="session", vocab_size=64,
                                  prompt_len=6, max_new_tokens=4)


def request(mod, rid, *, arrival_v=0.0, priority=0, session=None):
    r = mod.Request(rid=rid, arrival_v=arrival_v,
                    tokens=np.array([2, 3, 4]), max_new_tokens=2)
    r.priority = priority
    r.session = session
    return r


class Models:
    """The replicas' models in both packages: ``n_prefill`` and
    ``n_decode`` one-device tiny GPTs at ``batch`` slots, the port's from
    JAX's parameters, and the decode step time."""

    def __init__(self, machine8, n_prefill, n_decode, batch=2):
        from flexflow_tpu.apps.serve import _build_lm
        from flexflow_tpu.serve.engine import DEFAULT_STEP_TIME_S
        from flexflow_tpu.sim.search import decode_step_ratio

        from flexflow_tpu_torch.apps import serve
        from flexflow_tpu_torch.interop import params_from_jax
        from flexflow_tpu_torch.machine import MachineModel

        self.jp, self.jd, self.tp, self.td = [], [], [], []
        for j in range(n_prefill + n_decode):
            jm, _ = _build_lm(machine8.shrink([j]), batch=batch, seed=0,
                              tiny=True)
            tm, _ = serve.build_lm(batch=batch, seed=0, tiny=True,
                                   machine=MachineModel("cpu"))
            (self.jp if j < n_prefill else self.jd).append(jm)
            (self.tp if j < n_prefill else self.td).append(tm)
        tree, _ = self.jp[0].init(0)
        self.params = params_from_jax(jax.tree.map(np.asarray, tree), "cpu")
        self.prefill_step = DEFAULT_STEP_TIME_S
        self.decode_step = DEFAULT_STEP_TIME_S * decode_step_ratio(
            self.jd[0])

    def engines(self, port: bool):
        """Fresh (prefill, decode) engines of one package."""
        if port:
            from flexflow_tpu_torch.serve.engine import ServeEngine

            def make(m, step, phase):
                return ServeEngine(m, None, params=self.params,
                                   log=_quiet, step_time_s=step,
                                   phase=phase)
            models = (self.tp, self.td)
        else:
            from flexflow_tpu.serve.engine import ServeEngine

            def make(m, step, phase):
                return ServeEngine(m, None, log=_quiet, step_time_s=step,
                                   phase=phase)
            models = (self.jp, self.jd)
        return ([make(m, self.prefill_step, "prefill") for m in models[0]],
                [make(m, self.decode_step, "decode") for m in models[1]])


def _quiet(*a, **k):
    pass


def routed(models, port: bool, spec=None, *, path=None, drain=None,
           reqs=None, setup=None, **router_kw):
    """One routed run of one package under the fault spec ``spec`` (None:
    no injector installed): ``(requests, summary, injector, router,
    records)``, the records read back from ``path`` when given.
    ``setup(router)`` runs before the run (a test's stranded work)."""
    if port:
        from flexflow_tpu_torch import obs
        from flexflow_tpu_torch.serve import loadgen
        from flexflow_tpu_torch.serve.router import ServeRouter
        from flexflow_tpu_torch.utils import faultinject
    else:
        from flexflow_tpu import obs
        from flexflow_tpu.serve import loadgen
        from flexflow_tpu.serve.router import ServeRouter
        from flexflow_tpu.utils import faultinject
    olog = obs.RunLog(str(path), surface="serve") if path else None
    prefill, decode = models.engines(port)
    router = ServeRouter(prefill, decode, log=_quiet, olog=olog,
                         **router_kw)
    if setup is not None:
        setup(router)
    inj, restore = None, (lambda: None)
    if spec is not None:
        inj = faultinject.FaultInjector(spec, olog=olog)
        restore = faultinject.install_scoped(inj)
    try:
        reqs = session_load(loadgen) if reqs is None else reqs(loadgen)
        summary = router.run(reqs, drain=drain)
    finally:
        restore()
    records = []
    if olog is not None:
        olog.close()
        records = [{k: v for k, v in r.items() if k not in WALL_FIELDS}
                   for r in obs.read_run(olog.path)
                   if r["kind"] not in ("run_start", "run_end")]
    return reqs, summary, inj, router, records


class DrainAfter(dict):
    """A drain flag that reads as requested from its ``after``-th check
    on (the router checks once per event-loop boundary)."""

    def __init__(self, after):
        super().__init__()
        self.after, self.checks = after, 0

    def get(self, key, default=None):
        if key == "requested":
            self.checks += 1
            return self.checks > self.after
        return super().get(key, default)


def replies(reqs):
    return {r.rid: (list(r.reply) if r.reply is not None else None)
            for r in reqs}


def stamps(reqs):
    return {r.rid: (r.arrival_v, r.admit_v, r.first_token_v, r.done_v)
            for r in reqs}


def same_run(jax_run, port_run):
    """The two packages' runs agree in replies, stamps, the summary (but
    its wall clock) and every record (but its wall-clock fields)."""
    jreqs, jsum, jinj, _, jrec = jax_run
    treqs, tsum, tinj, _, trec = port_run
    assert replies(treqs) == replies(jreqs)
    assert stamps(treqs) == stamps(jreqs)
    assert _nan_safe([{k: v for k, v in tsum.items() if k != "wall_s"}]) \
        == _nan_safe([{k: v for k, v in jsum.items() if k != "wall_s"}])
    assert _nan_safe(trec) == _nan_safe(jrec)
    if jinj is not None:
        assert tinj.fired() == jinj.fired()


def _nan_safe(records):
    """Records with NaN floats made comparable."""
    def fix(v):
        if isinstance(v, float) and v != v:
            return "nan"
        if isinstance(v, dict):
            return {k: fix(x) for k, x in v.items()}
        if isinstance(v, list):
            return [fix(x) for x in v]
        return v
    return [fix(r) for r in records]
