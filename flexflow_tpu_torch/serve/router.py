"""The disaggregated serving front end (the port's copy of
``flexflow_tpu/serve/router.py``): prefill and decode pools of
:class:`~flexflow_tpu_torch.serve.engine.ServeEngine` replicas, least-
loaded admission, the priced KV handoff, session affinity, failure
recovery, SLO-burn shedding, hedged decode and the drain.

Arrivals go to the least-loaded PREFILL replica (``phase="prefill"``),
which runs the prompt pass (its step stamps ``first_token_v``) and hands
each request off with its generated token(s) and exported KV rows to a
DECODE replica (``phase="decode"``), which imports the rows and decodes
the tail.  Each handoff is priced by ``plan_kv_handoff`` and recorded as
one ``serve_handoff``; the priced transfer time is when the request
becomes admissible on the decode side (``Request.handoff_v``).  A
replica is one card in the router's process (a one-rank
``MachineModel``), or under ``torchrun`` a slice of the world's ranks of
any width: then every rank runs this loop over every replica's schedule
and ``world`` (``serve/replicas.py``) carries the steps' tokens, the KV
rows and the drain flag between the ranks (``apps.serve``'s
``_disagg_run``).

**Session affinity**: a session's follow-ups go to the decode replica
holding its KV rows, kept in an LRU residency set per replica; a session
whose rows were evicted is one ``kv_refetch`` record and falls back to
the least-loaded replica.

**Failure recovery**: at each event-loop boundary the router fires the
injector's ``replica_crash`` counter per live decode replica.  A crashed
replica revives ``restart_s`` virtual seconds later, its predict step
rebuilt and its KV cache empty (``ServeEngine.restart``); its in-flight
requests re-prefill their prompt and every generated token on a prefill
replica (``kv_rebuild``: greedy argmax makes the continuation the same),
its queued handoffs retransmit.  Every fault costs an attempt of a
``RetryPolicy`` whose seeded backoff waits in virtual time (one
``serve_retry`` record); an exhausted budget is one ``serve_fault``
record, never a silent loss.  ``handoff_drop`` retransmits and
``kv_corrupt`` rebuilds on the same path.  ``hedge=True`` races a clone
of each handoff on a second replica; the first completion wins.

**SLO-aware admission** (``admission=AdmissionGate(...)``): while the
rolling error-budget burn (``obs/slo.py``'s ``_burn`` over completions in
``window_s``) exceeds ``burn_threshold`` a token bucket gates admission
and the lowest-priority arrivals shed first (``serve_shed``); the summary
accounts ``completed + unserved + shed + failed == requests``.  With no
injector and the burn under threshold all of this is inert.

**Drain**: arrivals stop and are unserved, queued prefill work is
unserved, in-flight work finishes; a request between pools (a pending
retry or retransmit) is explicitly unserved.  Over a world of ranks the
flag is agreed at each iteration, so every rank stops admission at the
same one.

Time is the engines' VIRTUAL clock: the loop steps over the engines'
``next_ready_v()`` instants and the pending-retry and revival instants,
ties going prefill before decode and then by replica index, so routes,
handoffs, recoveries and latencies repeat exactly under a seeded load and
fault spec, and equal the JAX package's.  One ``router_summary`` record
closes each run.
"""

from __future__ import annotations

import copy
import dataclasses
import time
from collections import OrderedDict
from typing import Dict, List, Optional, Sequence, Tuple

from flexflow_tpu_torch import obs
from flexflow_tpu_torch.obs.slo import _burn
from flexflow_tpu_torch.serve.engine import ServeEngine, _percentile
from flexflow_tpu_torch.serve.kv_cache import plan_kv_handoff
from flexflow_tpu_torch.serve.loadgen import Request
from flexflow_tpu_torch.utils import faultinject
from flexflow_tpu_torch.utils.retry import RetryPolicy

#: sessions an LRU residency set holds per decode replica, as a
#: multiple of the replica's slot count — beyond it the oldest
#: session's KV rows are considered evicted (kv_refetch on return)
DEFAULT_RESIDENCY_FACTOR = 4

#: virtual seconds a crashed decode replica takes to restart and
#: rejoin its pool (process relaunch + weights reload, priced flat)
DEFAULT_RESTART_S = 0.05

#: rid offset for hedged-decode clones — far above any real rid, so a
#: clone's records are distinguishable and never collide
HEDGE_RID_BASE = 50_000_000


@dataclasses.dataclass(frozen=True)
class AdmissionGate:
    """SLO-burn-driven token-bucket admission control.

    While the rolling error-budget burn rate (bad completions inside
    ``window_s`` whose latency exceeds ``latency_target_s``, over the
    budget ``1 - availability``) stays at or under ``burn_threshold``,
    the gate is byte-inert — every arrival admits in arrival order.
    Above it, admissions spend tokens from a bucket refilling at
    ``bucket_rate``/s (cap ``bucket_cap``) and the LOWEST-priority
    arrivals at a boundary shed first."""

    latency_target_s: float = 0.25
    availability: float = 0.95
    window_s: float = 2.0
    burn_threshold: float = 1.0
    bucket_rate: float = 50.0
    bucket_cap: float = 8.0


class ServeRouter:
    """Front-end over ``prefill`` and ``decode`` ServeEngine replicas.

    The engines must be constructed with the matching ``phase`` (and
    are labeled by their phase's pool); the router drives their
    open-ended sessions directly — :meth:`run` is the whole lifecycle.
    ``world`` (a ``serve.replicas.ReplicaWorld``) runs the router on
    every rank of a world whose ranks hold the replicas.
    """

    def __init__(self, prefill: Sequence[ServeEngine],
                 decode: Sequence[ServeEngine], *, olog=None,
                 metrics=None, log=print,
                 residency_factor: int = DEFAULT_RESIDENCY_FACTOR,
                 retry_policy: Optional[RetryPolicy] = None,
                 restart_s: float = DEFAULT_RESTART_S,
                 hedge: bool = False,
                 admission: Optional[AdmissionGate] = None,
                 world=None):
        if not prefill or not decode:
            raise ValueError("router needs >= 1 prefill and >= 1 "
                             "decode replica")
        for eng in prefill:
            if eng.phase != "prefill":
                raise ValueError("prefill replicas must be "
                                 "ServeEngine(phase='prefill')")
        for eng in decode:
            if eng.phase != "decode":
                raise ValueError("decode replicas must be "
                                 "ServeEngine(phase='decode')")
        self.prefill = list(prefill)
        self.decode = list(decode)
        self.olog = olog if olog is not None else obs.NULL
        self.metrics = metrics
        self.log = log
        self.retry_policy = retry_policy or RetryPolicy()
        self.restart_s = float(restart_s)
        self.hedge = bool(hedge)
        self.admission = admission
        self.world = world
        # session affinity state: where each session's KV rows live,
        # plus each decode replica's LRU residency set
        self._session_home: Dict[int, int] = {}
        self._residency: List[OrderedDict] = [OrderedDict()
                                              for _ in self.decode]
        self._residency_cap = [max(1, int(residency_factor)
                                   * eng.max_batch)
                               for eng in self.decode]
        self.handoffs = 0
        self.affinity_hits = 0
        self.kv_refetches = 0
        self._seen_sessions: set = set()
        # resilience state: dead decode replicas + their revival
        # instants, pending retries/retransmits (ready_v, seq, mode,
        # req, src_idx), per-rid attempt counts and fault marks (for
        # the recovery-time percentiles), crash-survivor accounting
        self.retries = 0
        self.kv_rebuilds = 0
        self.replica_downs = 0
        self.sheds = 0
        self.hedges = 0
        self.hedge_wins = 0
        self._dead: set = set()
        self._revive_at: Dict[int, float] = {}
        self._pending: List[Tuple] = []
        self._pseq = 0
        self._attempts: Dict[int, int] = {}
        self._failed: List[Request] = []
        self._shed: List[Request] = []
        self._fault_marks: Dict[int, List[Tuple[str, float]]] = {}
        self._extra_completed: List[Request] = []
        self._extra_decode_steps = 0
        self._bucket_level = admission.bucket_cap if admission else 0.0
        self._bucket_last = 0.0
        self._inj = faultinject.NULL

    # ------------------------------------------------------------------
    # routing decisions

    def _least_loaded(self, engines: Sequence[ServeEngine]) -> int:
        """Lowest (load, index) — queue depth + active slots, the
        serve_batch watermark signal read live off each session."""
        loads = [(eng.load(), i) for i, eng in enumerate(engines)]
        return min(loads)[1]

    def _live_decode(self) -> List[int]:
        return [i for i in range(len(self.decode))
                if i not in self._dead]

    def _least_loaded_decode(self) -> int:
        """Least-loaded LIVE decode replica (callers guarantee at
        least one is live)."""
        return min((self.decode[i].load(), i)
                   for i in self._live_decode())[1]

    def _touch_residency(self, replica: int, sid: int) -> None:
        res = self._residency[replica]
        res[sid] = True
        res.move_to_end(sid)
        while len(res) > self._residency_cap[replica]:
            evicted, _ = res.popitem(last=False)
            # the evicted session's next follow-up will kv_refetch
            if self._session_home.get(evicted) == replica:
                del self._session_home[evicted]

    def _route_decode(self, req: Request) -> int:
        """Pick the decode replica for one handed-off request: session
        home while its rows are resident, else least-loaded live (with
        an explicit kv_refetch record when eviction forced the miss)."""
        sid = req.session
        if sid is not None:
            home = self._session_home.get(sid)
            if home is not None and home not in self._dead \
                    and sid in self._residency[home]:
                self.affinity_hits += 1
                self._touch_residency(home, sid)
                return home
            if home is None and any(sid in r for r in self._residency):
                # unreachable by construction (home tracks residency),
                # kept as a loud guard for the invariant
                raise AssertionError("residency without a session home")
            if sid in self._seen_sessions:
                # the session served here before but its rows are gone —
                # the decode replica must refetch/rebuild the prefix
                self.kv_refetches += 1
                self.olog.event("kv_refetch", rid=req.rid, session=sid,
                                old_replica=home)
        replica = self._least_loaded_decode()
        if sid is not None:
            self._session_home[sid] = replica
            self._touch_residency(replica, sid)
            self._seen_sessions.add(sid)
        return replica

    def _dispatch_handoffs(self, src_idx: int,
                           eng: ServeEngine) -> None:
        """Price and route every request ``eng`` handed off this step."""
        vnow = eng.session_vnow()
        for req in eng.take_handoffs():
            if req.kv_payload is not None:
                # the replica whose ranks hold the exported rows
                req.kv_payload.setdefault("holder", src_idx)
            base = req.first_token_v if req.first_token_v is not None \
                else req.arrival_v
            # a rebuilt request's first_token_v is its ORIGINAL prefill
            # stamp; the retransfer leaves now, not back then
            if vnow is not None and vnow > base:
                base = vnow
            self._dispatch_handoff(req, base, src_idx)

    def _dispatch_handoff(self, req: Request, t: float,
                          src_idx: int) -> None:
        """One prefill->decode transfer attempt at virtual ``t``:
        fault-inject the wire (drop / corrupt), else price, route and
        push — plus the optional hedged clone."""
        live = self._live_decode()
        if not live:
            # every decode replica is down: park the handoff until the
            # earliest revival — nothing was lost, so no retry burned
            ready = max(t, min(self._revive_at.values()))
            self._pseq += 1
            self._pending.append((ready, self._pseq, "dispatch", req,
                                  src_idx))
            return
        site = f"rid={req.rid}"
        if self._inj.enabled and self._inj.fire("handoff_drop",
                                                site=site):
            # the transfer died in flight; the exported payload is
            # still host-side — retransmit under the retry policy
            self._fault(req, "handoff_drop", t, "dispatch", src_idx)
            return
        if self._inj.enabled and self._inj.fire("kv_corrupt",
                                                site=site):
            # the payload arrived but its rows are untrusted — discard
            # and re-materialize by re-prefilling the carried prefix
            req.kv_payload = None
            self._fault(req, "kv_corrupt", t, "rebuild", src_idx)
            return
        src = self.prefill[src_idx]
        dst_idx = self._route_decode(req)
        dst = self.decode[dst_idx]
        plan = plan_kv_handoff(
            src.kv_layout, dst.kv_layout,
            len(req.tokens) if req.kv_payload is None
            else int(req.kv_payload["length"]),
            src_topology=src.model.machine.topology,
            dst_topology=dst.model.machine.topology)
        # prefill finished this request's prompt pass at
        # first_token_v; the priced transfer lands it on the decode
        # side — the batcher's effective arrival for re-admission
        req.handoff_v = t + plan["predicted_s"]
        self.handoffs += 1
        self.olog.event(
            "serve_handoff", rid=req.rid, session=req.session,
            from_replica=src_idx, to_replica=dst_idx,
            bytes=plan["bytes"], hops=plan["hops"],
            predicted_s=plan["predicted_s"], rows=plan["rows"],
            handoff_v=req.handoff_v,
            carried=len(req.carried_tokens or ()))
        dst.push(req)
        self._move(req, dst_idx)
        if self.hedge and len(live) >= 2 \
                and req.rid < HEDGE_RID_BASE:
            # race a clone on the next-best replica; first completion
            # wins at collection time (ties go to the primary)
            alt = min((self.decode[i].load(), i)
                      for i in live if i != dst_idx)[1]
            clone = copy.copy(req)
            clone.rid = req.rid + HEDGE_RID_BASE
            self.hedges += 1
            self.decode[alt].push(clone)
            self._move(clone, alt)

    def _move(self, req: Request, dst_idx: int) -> None:
        """Over a world of ranks, move ``req``'s KV rows from the prefill
        replica holding them to decode replica ``dst_idx``'s ranks."""
        p = req.kv_payload
        if self.world is not None and p is not None:
            self.world.move(req, self.prefill[p["holder"]].kv_layout,
                            dst_idx)

    # ------------------------------------------------------------------
    # failure handling

    def _fault(self, req: Request, kind: str, t: float,
               next_mode: str, src_idx: int) -> None:
        """One fault against ``req`` at virtual ``t``: burn an attempt,
        schedule the bounded-backoff retry (``serve_retry``) or declare
        the request explicitly failed (``serve_fault``)."""
        self._fault_marks.setdefault(req.rid, []).append((kind, t))
        failures = self._attempts.get(req.rid, 0) + 1
        self._attempts[req.rid] = failures
        if failures >= self.retry_policy.attempts:
            self._failed.append(req)
            self.olog.event("serve_fault", rid=req.rid,
                            session=req.session, reason=kind,
                            attempts=failures, vnow=t)
            self.log(f"serve-router: request {req.rid} FAILED after "
                     f"{failures} attempt(s) ({kind}) — explicit "
                     f"failure, not a silent loss")
            return
        delay = self.retry_policy.delay(failures)
        self.retries += 1
        self._pseq += 1
        self._pending.append((t + delay, self._pseq, next_mode, req,
                              src_idx))
        self.olog.event("serve_retry", rid=req.rid, attempt=failures,
                        delay_s=delay, reason=kind, vnow=t)

    def _dispatch_rebuild(self, req: Request, t: float) -> None:
        """Re-materialize a session's KV by re-prefilling its prompt +
        carried tokens on the least-loaded prefill replica — the priced
        recovery path next to kv_refetch.  Greedy argmax decode makes
        the regenerated continuation bit-identical."""
        idx = self._least_loaded(self.prefill)
        self.kv_rebuilds += 1
        req.kv_payload = None
        req.handoff_v = t  # effective arrival back on the prefill queue
        self.olog.event(
            "kv_rebuild", rid=req.rid, session=req.session,
            tokens=len(req.tokens) + len(req.carried_tokens or ()),
            to_replica=idx, vnow=t)
        self.prefill[idx].push(req)

    def _crash_decode(self, i: int, t: float) -> None:
        """decode[i] died at virtual ``t``: mark it dead until
        ``t + restart_s``, clear its residency (the KV is gone), and
        re-route everything it held."""
        eng = self.decode[i]
        state = eng.crash()
        self._dead.add(i)
        self._revive_at[i] = t + self.restart_s
        self.replica_downs += 1
        self._extra_completed.extend(state["completed"])
        self._extra_decode_steps += state["steps"]
        self._residency[i].clear()
        for sid, home in list(self._session_home.items()):
            if home == i:
                del self._session_home[sid]
        self.olog.event("replica_down", pool="decode", replica=i,
                        vnow=t, in_flight=len(state["in_flight"]),
                        queued=len(state["queued"]),
                        restart_s=self.restart_s)
        self.log(f"serve-router: decode[{i}] crashed at v={t:.4f} — "
                 f"{len(state['in_flight'])} in-flight re-prefill, "
                 f"{len(state['queued'])} queued retransmit, restart "
                 f"in {self.restart_s}s")
        if self.metrics is not None:
            self.metrics.update(replicas_live=len(self._live_decode()))
            self.metrics.write()
        for req in state["in_flight"]:
            if req.rid >= HEDGE_RID_BASE:
                continue  # a hedge clone dies free; its primary runs on
            # the imported KV died with the replica — rebuild by
            # re-prefilling the carried prefix
            self._fault(req, "replica_crash", t, "rebuild", 0)
        for req in state["queued"]:
            if req.rid >= HEDGE_RID_BASE:
                continue
            # payload still host-side: retransmit to a survivor
            self._fault(req, "replica_crash", t, "dispatch", 0)

    def _health_check(self, t: float) -> None:
        """Probe every live decode replica (index order) at this
        boundary — the ``replica_crash`` occurrence counter."""
        if not self._inj.enabled:
            return
        for i in range(len(self.decode)):
            if i in self._dead:
                continue
            if self._inj.fire("replica_crash", site=f"decode[{i}]"):
                self._crash_decode(i, t)

    def _revive_due(self, t: float) -> None:
        for i in sorted(self._dead):
            if self._revive_at.get(i, float("inf")) <= t:
                eng = self.decode[i]
                eng.restart()
                eng.start([], open_ended=True)
                eng.advance_to(t)
                self._dead.discard(i)
                del self._revive_at[i]
                self.log(f"serve-router: decode[{i}] restarted at "
                         f"v={t:.4f} (empty KV — sessions rebuild on "
                         f"return)")
                if self.metrics is not None:
                    self.metrics.update(
                        replicas_live=len(self._live_decode()))
                    self.metrics.write()

    def _dispatch_pending(self, t: float) -> None:
        due = sorted(p for p in self._pending if p[0] <= t)
        if not due:
            return
        self._pending = [p for p in self._pending if p[0] > t]
        for _ready, _seq, mode, req, src_idx in due:
            if mode == "rebuild":
                self._dispatch_rebuild(req, t)
            else:
                self._dispatch_handoff(req, t, src_idx)

    # ------------------------------------------------------------------
    # SLO-aware admission

    def _burn_rate(self, t: float) -> float:
        """Rolling error-budget burn over completions inside the gate's
        window (obs/slo.py's burn definition, read live off the
        engines) — the shedding trigger."""
        gate = self.admission
        lo = t - gate.window_s
        bad = total = 0
        for r in self._iter_completed():
            if r.rid >= HEDGE_RID_BASE or r.done_v is None:
                continue
            if r.done_v < lo or r.done_v > t:
                continue
            total += 1
            lat = r.latency_s
            if lat is not None and lat > gate.latency_target_s:
                bad += 1
        return _burn(bad, total, max(1.0 - gate.availability, 0.0))

    def _iter_completed(self):
        for r in self._extra_completed:
            yield r
        for eng in self.prefill + self.decode:
            for r in eng.session_completed():
                yield r

    def _admit_arrivals(self, due: List[Request], t: float) -> None:
        """Admit this boundary's arrivals to prefill — through the
        token bucket, lowest priority shed first, while the SLO burn
        exceeds the gate's threshold."""
        gate = self.admission
        burn = self._burn_rate(t) if gate is not None else 0.0
        if gate is None or burn <= gate.burn_threshold:
            for r in due:
                self.prefill[self._least_loaded(self.prefill)].push(r)
            return
        self._bucket_level = min(
            gate.bucket_cap,
            self._bucket_level
            + gate.bucket_rate * max(0.0, t - self._bucket_last))
        self._bucket_last = t
        for r in sorted(due, key=lambda r: (-r.priority, r.arrival_v,
                                            r.rid)):
            if self._bucket_level >= 1.0:
                self._bucket_level -= 1.0
                self.prefill[self._least_loaded(self.prefill)].push(r)
            else:
                self.sheds += 1
                self._shed.append(r)
                self.olog.event("serve_shed", rid=r.rid,
                                session=r.session, vnow=t,
                                burn_rate=burn, priority=r.priority)

    # ------------------------------------------------------------------
    # the event loop

    def run(self, requests: Sequence[Request],
            drain: Optional[Dict] = None) -> Dict:
        """Serve ``requests`` through the pools to completion (or
        drain); returns the merged summary (also the ``router_summary``
        obs record)."""
        t_wall0 = time.perf_counter()
        self._seen_sessions = set()
        self._inj = faultinject.get()
        for eng in self.prefill + self.decode:
            eng.start([], open_ended=True)
        arrivals = sorted(requests, key=lambda r: (r.arrival_v, r.rid))
        ptr = 0
        draining = False
        unserved: List[Request] = []
        engines = [(eng, "prefill", i)
                   for i, eng in enumerate(self.prefill)] \
            + [(eng, "decode", i) for i, eng in enumerate(self.decode)]
        while True:
            requested = drain is not None and drain.get("requested")
            if self.world is not None:
                requested = self.world.agreed(requested)
            if requested and not draining:
                draining = True
                unserved.extend(arrivals[ptr:])
                ptr = len(arrivals)
                for eng in self.prefill:
                    unserved.extend(eng.drain_queue())
                # the drain-during-handoff contract: a request exported
                # from prefill but not yet (re)landed on decode — a
                # pending retry/retransmit — is EXPLICITLY unserved,
                # never silently lost
                stranded = [p[3] for p in self._pending
                            if p[3].rid < HEDGE_RID_BASE]
                unserved.extend(stranded)
                self._pending = []
                self.log(f"serve-router: drain requested — "
                         f"{len(unserved)} queued/undispatched "
                         f"request(s) unserved, in-flight work "
                         f"finishing")
            candidates = []
            if ptr < len(arrivals):
                candidates.append(arrivals[ptr].arrival_v)
            for eng, _, _ in engines:
                v = eng.next_ready_v()
                if v is not None:
                    candidates.append(v)
            # pending retries and replica revivals are first-class
            # events: the loop cannot exit (or stall) over them
            candidates.extend(p[0] for p in self._pending)
            candidates.extend(self._revive_at.values())
            if not candidates:
                break
            t = min(candidates)
            self._revive_due(t)
            due: List[Request] = []
            while ptr < len(arrivals) and arrivals[ptr].arrival_v <= t:
                due.append(arrivals[ptr])
                ptr += 1
            if due:
                self._admit_arrivals(due, t)
            self._dispatch_pending(t)
            # step every engine ready at t — prefill first so this
            # boundary's handoffs are queued before decode steps at
            # later instants are chosen
            for eng, kind, i in engines:
                v = eng.next_ready_v()
                if v is None or v > t:
                    continue
                eng.advance_to(t)
                eng.step_once()
                if kind == "prefill":
                    self._dispatch_handoffs(i, eng)
            self._health_check(t)
        # anything still pending at exit is explicitly unserved — the
        # loop only reaches here with pending work when draining
        unserved.extend(p[3] for p in self._pending
                        if p[3].rid < HEDGE_RID_BASE)
        self._pending = []
        completed: List[Request] = list(self._extra_completed)
        steps = resizes = 0
        pools: Dict[str, Dict] = {}
        virtual_s = 0.0
        for eng, kind, i in engines:
            completed.extend(eng.session_completed())
            summ = eng.finish()
            steps += summ["steps"]
            resizes += summ["resizes"]
            virtual_s = max(virtual_s, summ["virtual_s"])
            pool = pools.setdefault(kind, {
                "replicas": 0, "devices": 0, "steps": 0,
                "completed": 0})
            pool["replicas"] += 1
            pool["devices"] += eng.model.machine.num_devices
            pool["steps"] += summ["steps"]
            pool["completed"] += summ["completed"]
        if self._extra_decode_steps or self._extra_completed:
            steps += self._extra_decode_steps
            pools["decode"]["steps"] += self._extra_decode_steps
            pools["decode"]["completed"] += len(self._extra_completed)
        completed = self._resolve_hedges(completed)
        completed.sort(key=lambda r: (r.done_v, r.rid))
        summary = self._summarize(completed, unserved, virtual_s,
                                  steps, resizes, pools,
                                  time.perf_counter() - t_wall0,
                                  drained=draining)
        return summary

    def _resolve_hedges(self, completed: List[Request]) -> List[Request]:
        """First completion wins: fold each hedge clone's result into
        its primary (earlier ``done_v`` takes the stamps; ties keep the
        primary) and drop the clones from the completion set."""
        if not self.hedges:
            return completed
        primaries = {r.rid: r for r in completed
                     if r.rid < HEDGE_RID_BASE}
        out: List[Request] = []
        for r in completed:
            if r.rid < HEDGE_RID_BASE:
                out.append(r)
                continue
            prim = primaries.get(r.rid - HEDGE_RID_BASE)
            if prim is None or r.done_v is None:
                continue  # orphan clone (primary failed/unserved)
            if prim.done_v is None or r.done_v < prim.done_v:
                prim.done_v = r.done_v
                prim.reply = list(r.reply) if r.reply is not None \
                    else prim.reply
                self.hedge_wins += 1
        return out

    # ------------------------------------------------------------------
    # reporting

    def _recovery_percentiles(self, completed) -> Dict[str, Dict]:
        """Per-fault-kind recovery times: fault mark -> the request's
        eventual completion (only completed requests recover)."""
        done_by_rid = {r.rid: r.done_v for r in completed
                       if r.done_v is not None}
        by_kind: Dict[str, List[float]] = {}
        for rid, marks in self._fault_marks.items():
            dv = done_by_rid.get(rid)
            if dv is None:
                continue
            for kind, mv in marks:
                by_kind.setdefault(kind, []).append(dv - mv)
        return {k: {"n": len(v), "p50_s": _percentile(v, 50),
                    "p99_s": _percentile(v, 99)}
                for k, v in sorted(by_kind.items())}

    def _summarize(self, completed, unserved, vnow, steps, resizes,
                   pools, wall_s, drained=False) -> Dict:
        lat = [r.latency_s for r in completed if r.latency_s is not None]
        ttft = [r.ttft_s for r in completed if r.ttft_s is not None]
        tpot = [r.tpot_s for r in completed if r.tpot_s is not None]
        devices = sum(p["devices"] for p in pools.values())
        summary = {
            "requests": len(completed) + len(unserved)
                        + len(self._shed) + len(self._failed),
            "completed": len(completed),
            "unserved": len(unserved),
            "dropped": 0,
            "shed": len(self._shed),
            "failed": len(self._failed),
            "qps": (len(completed) / vnow) if vnow > 0 else 0.0,
            "p50_s": _percentile(lat, 50),
            "p99_s": _percentile(lat, 99),
            "ttft_p50_s": _percentile(ttft, 50),
            "ttft_p99_s": _percentile(ttft, 99),
            "tpot_p50_s": _percentile(tpot, 50),
            "tpot_p99_s": _percentile(tpot, 99),
            "steps": steps,
            "resizes": resizes,
            "virtual_s": vnow,
            "wall_s": wall_s,
            "drained": bool(drained),
            "devices": devices,
            "pools": pools,
            "handoffs": self.handoffs,
            "affinity_hits": self.affinity_hits,
            "kv_refetches": self.kv_refetches,
            "retries": self.retries,
            "kv_rebuilds": self.kv_rebuilds,
            "replica_down": self.replica_downs,
            "hedges": self.hedges,
            "hedge_wins": self.hedge_wins,
            "replicas_live": len(self._live_decode()),
            "recovery": self._recovery_percentiles(completed),
        }
        self.olog.event("router_summary", **summary)
        if self.metrics is not None:
            self.metrics.update(
                qps=summary["qps"],
                queue_depth=0,
                latency_p50_s=summary["p50_s"] if lat else None,
                latency_p99_s=summary["p99_s"] if lat else None,
                ttft_p50_s=summary["ttft_p50_s"] if ttft else None,
                ttft_p99_s=summary["ttft_p99_s"] if ttft else None,
                tpot_p50_s=summary["tpot_p50_s"] if tpot else None,
                requests_total=len(completed),
                serve_retries_total=self.retries,
                serve_shed_total=self.sheds,
                replicas_live=summary["replicas_live"])
            self.metrics.write()
        return summary
