"""The fleet coordinator: many jobs on one pool of cards, with the
strategy search as the scheduler (PyTorch port of
``flexflow_tpu/fleet/coordinator.py``).

The loop: **admit** (each job gets its own obs stream under
``obs_dir/<job_id>/``), **pack** (the :class:`~flexflow_tpu_torch.fleet.
arbiter.Arbiter` prices each job on each candidate slice size and picks
the packing, one ``fleet_placement`` record), **quantum rounds** (every
running job gets ``quantum`` steps per round) and **rebalance** (a
changed demand vector re-packs; a changed assignment writes one
``fleet_rebalance`` record and executes the moves as directed resizes,
shrinks before grows, each checked against the ordinals other jobs
actually hold).

Over a world of ranks (``torchrun``'s: the pool is the world's machine)
every rank runs the same coordinator, whose decisions are deterministic:
the jobs run on slices of the world (``fleet/job.py``), each quantum's
outcome is shared from the job's first rank, and the drain flag is
agreed over the world at the start of each round (an all-reduce MAX), so
that every rank winds the same jobs down at the same boundary.  Only
rank 0 writes records.

**Virtual time and utilization.**  A :class:`VirtualClock` (one tick per
quantum step) stamps the lifecycle records, and every round writes a
``fleet_util`` record accounting every device-step of the pool as busy,
resizing or idle under the exact invariant :func:`check_fleet_util`
checks:

    busy_steps + idle_steps + resizing_steps == pool_devices x span_steps

The loop decomposes into :meth:`FleetCoordinator.start`,
:meth:`~FleetCoordinator.step_round` and :meth:`~FleetCoordinator.finish`
so that a driver (``apps.fleetsim``) can interleave admissions and
:meth:`~FleetCoordinator.idle_advance` gaps between rounds.
"""

from __future__ import annotations

import os
import time
from typing import Dict, List, Optional

from flexflow_tpu_torch import distributed
from flexflow_tpu_torch.fleet.arbiter import Arbiter
from flexflow_tpu_torch.fleet.job import Job, JobSpec


class VirtualClock:
    """Integer step counter + seconds-per-step scale: the fleet's
    virtual time base.  Jobs and the coordinator only ever ``advance``
    by whole steps, so device-second accounting stays exact integer
    arithmetic (``check_fleet_util``); ``now()`` is the float seconds
    view the obs records carry."""

    def __init__(self, step_time_s: float = 0.05, resize_steps: int = 1):
        if step_time_s <= 0:
            raise ValueError("step_time_s must be > 0")
        self.step_time_s = float(step_time_s)
        #: virtual steps one placement / one drain / one regrid costs
        self.resize_steps = max(int(resize_steps), 1)
        self.steps = 0

    def now(self) -> float:
        return self.steps * self.step_time_s

    def advance(self, steps: int) -> None:
        self.steps += max(int(steps), 0)


def check_fleet_util(rec: Dict) -> List[str]:
    """Violations of the fleet_util invariant (empty list = OK): the
    three buckets are non-negative ints summing EXACTLY to pool
    capacity x round span, and the derived seconds fields match
    ``steps x step_time_s``.  The obs/budget.py ``check_budget``
    contract, for device-seconds instead of step wall time."""
    problems: List[str] = []
    for k in ("pool_devices", "span_steps", "busy_steps", "idle_steps",
              "resizing_steps"):
        v = rec.get(k)
        if not isinstance(v, int) or isinstance(v, bool):
            problems.append(f"{k} must be an int, got {v!r}")
        elif v < 0:
            problems.append(f"{k} must be >= 0, got {v}")
    if problems:
        return problems
    cap = rec["pool_devices"] * rec["span_steps"]
    total = (rec["busy_steps"] + rec["idle_steps"]
             + rec["resizing_steps"])
    if total != cap:
        problems.append(
            f"buckets sum to {total} device-steps but pool capacity x "
            f"round span is {cap} ({rec['pool_devices']} devices x "
            f"{rec['span_steps']} steps)")
    st = rec.get("step_time_s")
    if isinstance(st, (int, float)) and not isinstance(st, bool) \
            and st > 0:
        for name in ("busy", "idle", "resizing"):
            sec = rec.get(f"{name}_s")
            want = rec[f"{name}_steps"] * st
            if sec is not None and \
                    abs(sec - want) > 1e-9 * max(1.0, abs(want)):
                problems.append(
                    f"{name}_s {sec} != {name}_steps x step_time_s "
                    f"{want}")
    return problems


class FleetCoordinator:
    """Owns the pool, the jobs, and the rebalance economy."""

    def __init__(self, pool, *, obs_dir: str = "", olog=None,
                 metrics=None, quantum: int = 4, budget_s: float = 30.0,
                 iters: int = 200, seed: int = 0, pricer=None,
                 step_time_s: float = 0.05, resize_steps: int = 1,
                 log=print):
        from flexflow_tpu_torch import obs

        self.pool = pool
        self.obs_dir = obs_dir
        self.metrics = metrics
        self.quantum = max(int(quantum), 1)
        self.seed = int(seed)
        self.log = log
        self.clock = VirtualClock(step_time_s=step_time_s,
                                  resize_steps=resize_steps)
        #: only rank 0 of the pool's world writes records
        self.writes = getattr(pool, "rank", 0) == 0
        if not self.writes:
            self.olog = obs.NULL
        elif olog is not None:
            self.olog = olog
        elif obs_dir:
            self.olog = obs.RunLog(
                os.path.join(obs_dir, "fleet.jsonl"), surface="fleet",
                meta={"pool_devices": pool.num_devices})
        else:
            self.olog = obs.NULL
        self.arbiter = Arbiter(pool.num_devices, pricer=pricer,
                               budget_s=budget_s, iters=iters, seed=seed,
                               olog=self.olog, log=log)
        self.jobs: List[Job] = []
        self.rebalances = 0
        self._packs = 0
        self._demand_key = None
        self._round = 0
        self._resizing_steps = 0     # device-steps in motion this round
        self._drain = None
        self._t0 = None
        self._waits_seen: set = set()

    # ------------------------------------------------------------------
    # admission

    def submit(self, spec: JobSpec) -> Job:
        """Admit one job: open its private obs stream and queue it
        pending (placement happens at the next pack)."""
        from flexflow_tpu_torch import obs

        if any(j.spec.job_id == spec.job_id for j in self.jobs):
            raise ValueError(f"fleet: duplicate job id {spec.job_id!r}")
        if self.obs_dir and self.writes:
            jdir = os.path.join(self.obs_dir, spec.job_id)
            jlog = obs.RunLog(
                os.path.join(jdir, f"{spec.job_id}.jsonl"),
                surface="serve" if spec.kind == "serve" else "fit",
                meta={"fleet_job": spec.job_id,
                      "workload": spec.kind})
        else:
            # no private obs dir: the job shares the pool stream, so a
            # stream-level driver (fleetsim) still captures every
            # fleet_job / fleet_wait record
            jlog = self.olog
        job = Job(spec, olog=jlog, log=self.log)
        job.attach_clock(self.clock)
        self.jobs.append(job)
        self.olog.event("fleet_job", job=spec.job_id,
                        workload=spec.kind, state="pending",
                        priority=spec.priority,
                        min_devices=spec.min_devices,
                        max_devices=spec.max_devices,
                        vts=self.clock.now())
        return job

    # ------------------------------------------------------------------
    # packing

    def _placeable(self) -> List[Job]:
        return [j for j in self.jobs
                if j.state in ("pending", "running")]

    def _current_sizes(self) -> Dict[str, int]:
        return {j.spec.job_id: len(j.ordinals) for j in self.jobs
                if j.ordinals and j.active}

    def _current_ordinals(self) -> Dict[str, List[int]]:
        return {j.spec.job_id: list(j.ordinals) for j in self.jobs
                if j.ordinals and j.active}

    def _demands(self) -> tuple:
        return tuple((j.spec.job_id, j.demand(self.pool.num_devices))
                     for j in self._placeable())

    def _held_by_others(self, job) -> set:
        """Pool ordinals ACTUALLY held right now by every active job
        except ``job`` — the ground truth a planned move must be
        disjoint from before it executes (a failed earlier move means
        the plan's assumptions about freed devices no longer hold)."""
        held: set = set()
        for j in self.jobs:
            if j is not job and j.active:
                held.update(j.ordinals)
        return held

    def _pack(self) -> Dict[str, int]:
        jobs = self._placeable()
        sizes = self.arbiter.pack(jobs, current=self._current_sizes())
        self._packs += 1
        self.olog.event(
            "fleet_placement", pack=self._packs,
            demands={jid: d for jid, d in self._demands()},
            sizes=sizes, pool=self.pool.num_devices,
            native_prices=self.arbiter.native_prices,
            proxy_prices=self.arbiter.proxy_prices)
        return sizes

    # ------------------------------------------------------------------
    # the loop

    def run(self, drain: Optional[Dict] = None) -> Dict:
        """Place everything submitted so far, then round-robin quanta
        (rebalancing on demand shifts) until every job is done or
        failed.  Returns the fleet summary (also the ``fleet_summary``
        record)."""
        self.start(drain)
        while self.step_round(drain):
            pass
        return self.finish()

    def start(self, drain: Optional[Dict] = None) -> None:
        """Initial placement of everything submitted so far, accounted
        as a round-0 ``fleet_util`` record (placement device-steps are
        'resizing', the rest of the span is idle)."""
        self._t0 = time.perf_counter()
        self._drain = drain
        v0 = self.clock.steps
        self._resizing_steps = 0
        self._place_initial(drain)
        self._emit_util(v0, busy=0, phase="start")

    def step_round(self, drain: Optional[Dict] = None) -> bool:
        """ONE quantum round: step every running job, advance the
        virtual clock by the quantum, rebalance on demand shifts, emit
        the round's ``fleet_util`` accounting.  Returns False when no
        job is running (the loop's exit condition)."""
        if drain is None:
            drain = self._drain
        running = [j for j in self.jobs if j.state == "running"]
        if not running:
            return False
        if drain is not None:
            # one flag for every rank of the world, at this boundary
            drain["requested"] = distributed.agreed(
                drain.get("requested", False),
                distributed.control_device(self.pool.device))
        self._round += 1
        v0 = self.clock.steps
        self._resizing_steps = 0
        busy = 0
        for job in running:
            if job.state != "running":
                continue
            held = len(job.ordinals)
            try:
                job.step_quantum(self.quantum, drain=drain, pool=self.pool)
            except Exception as e:  # noqa: BLE001
                self.log(f"fleet: job {job.spec.job_id} failed: {e}")
            busy += held * min(int(job.last_quantum_steps),
                               self.quantum)
        self.clock.advance(self.quantum)
        if not (drain is not None and drain.get("requested")):
            # jobs wind down at their own boundaries during a drain; no
            # rebalances — keep stepping until everyone exits
            self._maybe_rebalance()
        self._emit_util(v0, busy=busy, phase="round")
        self._observe_waits()
        return True

    def place_pending(self) -> int:
        """Re-pack and place queued jobs WITHOUT stepping anyone —
        fleetsim's entry point when arrivals land in an empty pool
        (``step_round`` exits before rebalancing when nothing runs).
        Placement device-steps are accounted as a 'place'-phase
        ``fleet_util`` record; if the pack moved nothing (no feasible
        placement) the clock did not advance and no record is emitted.
        Returns the number of running jobs afterwards."""
        v0 = self.clock.steps
        self._resizing_steps = 0
        self._maybe_rebalance()
        if self.clock.steps > v0:
            self._emit_util(v0, busy=0, phase="place")
        else:
            self._resizing_steps = 0
        return sum(1 for j in self.jobs if j.state == "running")

    def idle_advance(self, steps: int) -> None:
        """Fast-forward across a gap with nothing runnable (fleetsim's
        inter-arrival gaps): the whole pool sits idle for the span,
        recorded as an all-idle ``fleet_util`` round so the accounting
        still covers every device-second of the day."""
        steps = int(steps)
        if steps <= 0:
            return
        v0 = self.clock.steps
        self._resizing_steps = 0
        self.clock.advance(steps)
        self._emit_util(v0, busy=0, phase="idle")

    def _emit_util(self, v0: int, busy: int, phase: str) -> None:
        clk = self.clock
        span = clk.steps - v0
        pool = self.pool.num_devices
        resizing = self._resizing_steps
        idle = pool * span - busy - resizing
        st = clk.step_time_s
        rec = {"round": self._round, "phase": phase, "vts": v0 * st,
               "pool_devices": pool, "span_steps": span,
               "busy_steps": busy, "idle_steps": idle,
               "resizing_steps": resizing, "step_time_s": st,
               "busy_s": busy * st, "idle_s": idle * st,
               "resizing_s": resizing * st,
               "util": (busy / (pool * span)) if span else 0.0}
        self.olog.event("fleet_util", **rec)
        self._resizing_steps = 0
        if self.metrics is not None:
            self.metrics.update(fleet_util=rec["util"])

    def _observe_waits(self) -> None:
        """Each newly-terminal job's queue wait lands in the
        ``ff_fleet_job_wait_s`` histogram exactly once."""
        if self.metrics is None:
            return
        for j in self.jobs:
            if j.state in ("done", "failed") \
                    and j.spec.job_id not in self._waits_seen:
                self._waits_seen.add(j.spec.job_id)
                self.metrics.observe("fleet_job_wait_s",
                                     j.vtimes["wait_s"])

    def _place_initial(self, drain: Optional[Dict]) -> None:
        self._demand_key = self._demands()
        sizes = self._pack()
        ordinals = self.arbiter.assign_ordinals(
            self._placeable(), sizes, current=self._current_ordinals())
        for job in self._placeable():
            ords = ordinals.get(job.spec.job_id, [])
            if not ords:
                self.log(f"fleet: job {job.spec.job_id} does not fit — "
                         f"left pending")
                continue
            v_before = self.clock.steps
            job.place(self.pool, ords,
                      strategy=self.arbiter.priced_strategy(
                          job, len(ords)),
                      drain=drain)
            self._resizing_steps += \
                (self.clock.steps - v_before) * len(ords)
        self._update_metrics()

    def _maybe_rebalance(self) -> None:
        """Re-pack and issue directed resizes when the demand key
        shifts — a serve job crossing its queue watermark, a job
        arriving/finishing, or a DEGRADED serve job
        (:meth:`~flexflow_tpu_torch.fleet.job.Job.mark_degraded`) raising
        its bid to max after losing replicas: the emergency bid
        changes ``_demands()`` and drives the fleet through the same
        directed-resize path, and a successful resize clears it."""
        key = self._demands()
        if key == self._demand_key:
            return
        self._demand_key = key
        sizes = self._pack()
        cur = self._current_ordinals()
        target = self.arbiter.assign_ordinals(
            self._placeable(), sizes, current=cur)
        moves = []
        placements = []
        for job in self._placeable():
            jid = job.spec.job_id
            new = sorted(target.get(jid, []))
            if job.state == "running" and new and new != job.ordinals:
                moves.append((job, new))
            elif job.state == "pending" and new:
                placements.append((job, new))
        if not moves and not placements:
            return
        degraded = False
        if moves:
            self.rebalances += 1
            # the rebalance record precedes the elastic_resize records
            # it causes, in every merged ts-ordering
            self.olog.event(
                "fleet_rebalance", rebalance=self.rebalances,
                moves=[{"job": j.spec.job_id, "from": list(j.ordinals),
                        "to": new} for j, new in moves],
                sizes=sizes, vts=self.clock.now())
            self.log(f"fleet: rebalance #{self.rebalances}: "
                     + ", ".join(f"{j.spec.job_id} "
                                 f"{len(j.ordinals)}->{len(new)}"
                                 for j, new in moves))
            # shrinks release devices before grows claim them
            moves.sort(key=lambda m: (len(m[1]) - len(m[0].ordinals),
                                      m[0].spec.job_id))
            for job, new in moves:
                # the plan was priced against devices earlier moves
                # were to free; if one failed, its devices were never
                # released — defer any move that would oversubscribe
                conflict = set(new) & self._held_by_others(job)
                if conflict:
                    self.log(f"fleet: deferring resize of "
                             f"{job.spec.job_id} -> {new}: ordinals "
                             f"{sorted(conflict)} still held by "
                             f"another job")
                    degraded = True
                    continue
                v_before = self.clock.steps
                affected = len(set(new) | set(job.ordinals))
                try:
                    job.resize(self.pool, new)
                except Exception as e:  # noqa: BLE001
                    # Job.resize aborts back to running on the slice
                    # its completed legs left it holding
                    self.log(f"fleet: resize of {job.spec.job_id} "
                             f"failed ({e}); job resumes on its "
                             f"{len(job.ordinals)}-device slice")
                    degraded = True
                self._resizing_steps += \
                    (self.clock.steps - v_before) * affected
        # queued jobs admitted by the re-pack place after the shrinks
        # that freed their devices
        for job, ords in placements:
            conflict = set(ords) & self._held_by_others(job)
            if conflict:
                self.log(f"fleet: deferring placement of "
                         f"{job.spec.job_id}: ordinals "
                         f"{sorted(conflict)} still held by another "
                         f"job")
                degraded = True
                continue
            v_before = self.clock.steps
            job.place(self.pool, ords,
                      strategy=self.arbiter.priced_strategy(
                          job, len(ords)),
                      drain=self._drain)
            self._resizing_steps += \
                (self.clock.steps - v_before) * len(ords)
        if degraded:
            # the pool is not in the packed shape — force a re-pack at
            # the next round instead of waiting for a demand shift
            self._demand_key = None
        if self.metrics is not None:
            self.metrics.update(fleet_rebalances_total=self.rebalances)
        self._update_metrics()

    def finish(self, wall_s: Optional[float] = None) -> Dict:
        """Close out the run: the ``fleet_summary`` record, final
        metrics, and every private job stream closed."""
        if wall_s is None:
            wall_s = time.perf_counter() - (self._t0 or
                                            time.perf_counter())
        return self._finish(wall_s)

    def _finish(self, wall_s: float) -> Dict:
        by_state: Dict[str, int] = {}
        for j in self.jobs:
            by_state[j.state] = by_state.get(j.state, 0) + 1
        jobs_out = []
        for j in self.jobs:
            entry = {"job": j.spec.job_id, "kind": j.spec.kind,
                     "state": j.state, "devices": len(j.ordinals)}
            if j.spec.kind == "train" and j.result:
                entry["iters"] = j.result.get("iters")
                entry["final_loss"] = (j.result["loss"][-1]
                                       if j.result.get("loss")
                                       else None)
            if j.spec.kind == "serve" and j.result:
                # sim-mode serve jobs report steps, not requests
                if "completed" in j.result:
                    entry["completed"] = j.result["completed"]
                    entry["unserved"] = j.result["unserved"]
                else:
                    entry["iters"] = j.result.get("iters")
            if j.error:
                entry["error"] = j.error
            jobs_out.append(entry)
        summary = {
            "pool_devices": self.pool.num_devices,
            "jobs": jobs_out, "by_state": by_state,
            "rebalances": self.rebalances, "packs": self._packs,
            "native_prices": self.arbiter.native_prices,
            "proxy_prices": self.arbiter.proxy_prices,
            "wall_s": round(wall_s, 3),
            "virtual_s": self.clock.now(),
        }
        self.olog.event("fleet_summary", **summary)
        self._observe_waits()
        self._update_metrics()
        for j in self.jobs:
            if j.olog is not self.olog:
                j.olog.close()
        return summary

    # ------------------------------------------------------------------

    def _update_metrics(self) -> None:
        if self.metrics is None:
            return
        counts: Dict[str, int] = {}
        for j in self.jobs:
            counts[j.state] = counts.get(j.state, 0) + 1
        self.metrics.update(fleet_jobs=len(self.jobs))
        for state, n in counts.items():
            self.metrics.update_labeled("fleet_jobs", {"state": state},
                                        n)
        total = 0
        for j in self.jobs:
            n = len(j.ordinals) if j.active else 0
            total += n
            self.metrics.update_labeled("fleet_job_devices",
                                        {"job": j.spec.job_id}, n)
        self.metrics.update(fleet_job_devices=total)
        self.metrics.write()
