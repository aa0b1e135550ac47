"""Fleet jobs: one spec and lifecycle state machine per tenant, wrapping
the port's execution machinery (PyTorch port of
``flexflow_tpu/fleet/job.py``).

A :class:`JobSpec` names what runs (workload kind, the
``build(config, machine)`` factory the elastic path uses, the payload)
and under which terms (priority, min/max devices, the serving demand
watermark).  A :class:`Job` is one admitted instance, moved by the
coordinator through the lifecycle

    pending -> placing -> running -> (draining -> resized -> running)*
            -> done | failed

where the loop in parentheses is one directed resize.  A failed leg
takes the abort edge ``draining -> running``: the job resumes on the
slice its completed legs left it holding (the exception still
propagates so that the coordinator can re-pack).

**Jobs are slices of one world.**  JAX's jobs are slices of one
process's mesh.  One process of the port drives one card, so the pool
is a world of ranks (``torchrun``'s, or one process for a pool of one)
and every rank runs the same coordinator and arbiter, whose decisions
are deterministic.  A job runs on ``MachineModel.running_slice`` of its
ordinals: a rank of the slice runs it, any other rank holds the
slice's bystander view, which builds the same graph and makes the same
process groups in the same order (``torch.distributed.new_group`` needs
every rank).  The groups are cached by rank set on the pool
(``MachineModel._handles``), so a re-pack that returns to a slice makes
no new group.  After each quantum the slice's first rank broadcasts the
job's status (steps taken, losses, queue depth, result) to the world,
so that every rank takes the same lifecycle transitions.

**A move is a slice move inside the world** (:func:`~flexflow_tpu_torch.
utils.elastic.slice_move`), with no re-form of the world: the live
state is gathered from the old slice (``FFModel.gather_trees``) and
shared, rank 0 re-searches the strategy for the new slice (``makespan``
for training, ``latency`` for serving) and shares it, every rank builds
the new slice's model in one order, the new slice's ranks place the
state (``FFModel.place_state``), and each leg writes one
``elastic_resize`` record with JAX's fields (``cause: "directed"``) and
no fault record.  A serving job's engine adopts the move
(``ServeEngine.adopt_resize``); a rank joining its slice takes the
session from the slice's first rank.  Only rank 0 writes records.

Two runner shapes, as in JAX: **train** runs ``make_train_step`` over
the payload's host batches (each rank of the slice takes its block,
``FFModel.local_batch``), the loss history carried across moves;
**serve** drives a :class:`~flexflow_tpu_torch.serve.engine.ServeEngine`
session through ``start()`` / ``step_once()`` with the engine's own
autoscaler off (``queue_hi=0``, ``idle_boundaries=0``).

**Lifecycle attribution.**  The coordinator attaches its
:class:`~flexflow_tpu_torch.fleet.coordinator.VirtualClock` at
admission; every ``fleet_job`` record carries the virtual timestamp
``vts`` and the time spent in the state being left accrues to one of
five buckets (wait, placement, run, drain, resize), which a terminal
transition's ``fleet_wait`` record decomposes the job's life into.

**Sim mode** (``apps.fleetsim``): ``JobSpec.sim_steps > 0`` makes the
job a synthetic trace job: placement builds no model and each quantum
burns virtual steps; a sim serving job's demand is a
:class:`_SimBacklog` whose queue depth is its remaining steps.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence

from flexflow_tpu_torch import distributed

# lifecycle states and the legal transitions between them
STATES = ("pending", "placing", "running", "draining", "resized",
          "done", "failed")
_TRANSITIONS = {
    "pending": ("placing", "failed"),
    "placing": ("running", "failed"),
    "running": ("draining", "done", "failed"),
    # draining -> running is the resize abort path: a leg failed, the
    # job resumes on whatever slice the completed legs left it holding
    "draining": ("resized", "running", "done", "failed"),
    "resized": ("running", "failed"),
    "done": (),
    "failed": (),
}


class JobStateError(RuntimeError):
    """An illegal lifecycle transition (a coordinator bug, not a user
    error: the state machine is the contract)."""


# which fleet_wait bucket the time spent in each state accrues to: the
# bucket is keyed by the state being LEFT at a transition
_STATE_BUCKET = {
    "pending": "wait_s",
    "placing": "placement_s",
    "running": "run_s",
    "draining": "drain_s",
    "resized": "resize_s",
}


class _SimBacklog:
    """Serving demand of a sim job: the queue depth is the job's
    remaining virtual steps, so a backlogged sim serving job bids
    ``max_devices`` until it burns below its ``queue_hi`` watermark."""

    def __init__(self, job: "Job"):
        self._job = job

    def queue_depth(self) -> int:
        return max(int(self._job._sim_left), 0)


class _Mirror:
    """A serving job's demand on a rank outside its slice: the queue
    depth its slice's first rank shared after the last quantum."""

    def __init__(self, depth: int = 0):
        self.depth = int(depth)

    def queue_depth(self) -> int:
        return self.depth


@dataclasses.dataclass
class JobSpec:
    """Everything the coordinator needs to admit one tenant
    (``flexflow_tpu/fleet/job.py:115``): ``build(config, machine)`` is
    the elastic path's factory; ``payload`` a host-batch iterator
    factory ``() -> iterator`` of global batches (train) or a request
    list (serve); ``min_devices``/``max_devices`` bound the slice;
    ``priority`` weights the predicted cost in the packing; ``queue_hi``
    is the serving demand watermark (0 keeps the bid at
    ``min_devices``)."""

    job_id: str
    kind: str                      # "train" | "serve"
    build: object                  # (config, machine) -> model
    config: object                 # FFConfig
    payload: object = None
    priority: float = 1.0
    min_devices: int = 1
    max_devices: int = 0           # 0 = no cap beyond the pool
    queue_hi: int = 0              # serve demand watermark
    strategy_path: str = ""        # pre-searched strategy artifact
    search_iters: int = 200        # arbiter pricing proposals per slice
    #: the disaggregated serving tier: "" a single-pool serving job,
    #: "prefill" priced under the latency objective, "decode" under the
    #: decode objective
    serve_phase: str = ""
    #: > 0 makes this a synthetic job of exactly ``sim_steps`` quantum
    #: steps with no model (apps.fleetsim)
    sim_steps: int = 0

    def __post_init__(self):
        if self.kind not in ("train", "serve"):
            raise ValueError(f"job {self.job_id}: kind must be 'train' "
                             f"or 'serve', got {self.kind!r}")
        if self.serve_phase not in ("", "prefill", "decode"):
            raise ValueError(f"job {self.job_id}: serve_phase must be "
                             f"'', 'prefill' or 'decode', got "
                             f"{self.serve_phase!r}")
        if self.serve_phase and self.kind != "serve":
            raise ValueError(f"job {self.job_id}: serve_phase "
                             f"{self.serve_phase!r} needs kind='serve'")
        if self.min_devices < 1:
            raise ValueError(f"job {self.job_id}: min_devices >= 1")
        if self.max_devices and self.max_devices < self.min_devices:
            raise ValueError(f"job {self.job_id}: max_devices "
                             f"{self.max_devices} < min_devices "
                             f"{self.min_devices}")
        if self.sim_steps < 0:
            raise ValueError(f"job {self.job_id}: sim_steps >= 0")


# ---------------------------------------------------------------------------
# the pool's world


def world_rank(pool, ordinal: int) -> int:
    """The process-group rank of pool ordinal ``ordinal``."""
    return int(pool.view[int(ordinal)])


def slice_machine(pool, ordinals: Sequence[int]):
    """The machine a job runs on at ``ordinals`` of ``pool``
    (``MachineModel.running_slice``), its process groups cached on the
    pool by rank set."""
    m = pool.running_slice(ordinals)
    m._handles = pool._handles
    return m


class Job:
    """One admitted job: spec, lifecycle and the live runner state."""

    def __init__(self, spec: JobSpec, olog=None, log=print):
        from flexflow_tpu_torch import obs

        self.spec = spec
        self.olog = olog if olog is not None else obs.NULL
        self.log = log
        self.state = "pending"
        self.ordinals: List[int] = []   # pool ordinals currently held
        self.model = None
        self.engine = None              # serve jobs
        self.strategy = None            # the strategy the job runs under
        self.result: Optional[Dict] = None
        self.error: Optional[str] = None
        #: a serving job's completed requests, on the ranks that ran it
        #: to its end
        self.served: List = []
        # train runner state
        self._step = None
        self._params = self._state = self._opt = None
        self._batches = None
        self._loss_hist: List[float] = []
        self.iters_done = 0
        self._drain: Optional[Dict] = None
        self.clock = None
        self.submit_v: Optional[float] = None
        self._last_v: Optional[float] = None
        self.vtimes: Dict[str, float] = {
            "wait_s": 0.0, "placement_s": 0.0, "run_s": 0.0,
            "drain_s": 0.0, "resize_s": 0.0}
        #: steps executed in the last step_quantum call
        self.last_quantum_steps = 0
        #: decode replicas this serving job has lost (its emergency bid)
        self.degraded = 0
        self._sim_left = int(getattr(spec, "sim_steps", 0) or 0)
        if self._sim_left > 0 and spec.kind == "serve":
            self.engine = _SimBacklog(self)

    # ------------------------------------------------------------------
    # lifecycle

    def attach_clock(self, clock) -> None:
        """Wire the coordinator's virtual clock in at admission."""
        self.clock = clock
        self.submit_v = clock.now()
        self._last_v = self.submit_v

    def to_state(self, new: str, **detail) -> None:
        """One legal transition, recorded as a ``fleet_job`` event on the
        job's stream (``vts``-stamped with a clock, the state left
        accruing to its bucket; a terminal transition adds the
        ``fleet_wait`` decomposition)."""
        if new not in STATES:
            raise JobStateError(f"unknown state {new!r}")
        if new not in _TRANSITIONS[self.state]:
            raise JobStateError(
                f"job {self.spec.job_id}: illegal transition "
                f"{self.state} -> {new}")
        old, self.state = self.state, new
        if self.clock is not None:
            vts = self.clock.now()
            bucket = _STATE_BUCKET.get(old)
            if bucket is not None and self._last_v is not None:
                self.vtimes[bucket] += vts - self._last_v
            self._last_v = vts
            detail = dict(detail, vts=vts)
        # "workload", not "kind": the record's own kind is "fleet_job"
        self.olog.event("fleet_job", job=self.spec.job_id,
                        workload=self.spec.kind, state=new,
                        from_state=old, devices=len(self.ordinals),
                        **detail)
        if self.clock is not None and new in ("done", "failed"):
            vt = self.vtimes
            self.olog.event(
                "fleet_wait", job=self.spec.job_id,
                workload=self.spec.kind, state=new,
                devices=len(self.ordinals),
                wait_s=vt["wait_s"], placement_s=vt["placement_s"],
                run_s=vt["run_s"], drain_s=vt["drain_s"],
                resize_s=vt["resize_s"],
                total_s=(vt["wait_s"] + vt["placement_s"] + vt["run_s"]
                         + vt["drain_s"] + vt["resize_s"]),
                submit_v=self.submit_v, done_v=detail["vts"])

    @property
    def active(self) -> bool:
        return self.state in ("placing", "running", "draining",
                              "resized")

    def fail(self, err: str) -> None:
        self.error = err
        if self.state not in ("done", "failed"):
            self.to_state("failed", error=err)

    # ------------------------------------------------------------------
    # demand

    def mark_degraded(self, lost: int,
                      reason: str = "replica_crash") -> None:
        """A serving job lost ``lost`` decode replicas: one
        ``replica_down`` record, and the bid rises to ``max_devices``
        until a directed resize restores the capacity (``lost=0``
        clears it)."""
        if self.spec.kind != "serve":
            raise JobStateError(
                f"job {self.spec.job_id}: only serve jobs report "
                f"degraded replica capacity")
        self.degraded = max(0, int(lost))
        if self.degraded:
            detail = {}
            if self.clock is not None:
                detail["vts"] = self.clock.now()
            self.olog.event(
                "replica_down", job=self.spec.job_id, pool="serve",
                replica=None, replicas_lost=self.degraded,
                reason=reason, devices=len(self.ordinals), **detail)
            self.log(f"fleet: job {self.spec.job_id} DEGRADED — "
                     f"{self.degraded} replica(s) down ({reason}), "
                     f"bidding max capacity for recovery")

    def demand(self, pool_size: int) -> int:
        """The size this job wants: a training job its max; a serving
        job ``min_devices`` while its queue is below ``queue_hi``, its
        max at or above it, or while degraded."""
        cap = self.spec.max_devices or pool_size
        if self.spec.kind == "train":
            return min(cap, pool_size)
        if self.spec.kind == "serve" and self.degraded > 0:
            return min(cap, pool_size)
        if (self.spec.queue_hi > 0 and self.engine is not None
                and self.engine.queue_depth() >= self.spec.queue_hi):
            return min(cap, pool_size)
        return self.spec.min_devices

    def feasible_sizes(self, pool_size: int) -> List[int]:
        """Slice sizes in [min_devices, max_devices] that divide the
        job's batch, ascending."""
        cap = min(self.spec.max_devices or pool_size, pool_size)
        batch = int(getattr(self.spec.config, "batch_size", 0) or 0)
        out = []
        for s in range(self.spec.min_devices, cap + 1):
            if batch and batch % s:
                continue
            out.append(s)
        return out

    def candidate_sizes(self, pool_size: int) -> List[int]:
        """The sizes the arbiter may assign now: feasible sizes capped at
        the demand; a backlogged serving job's bid is binding."""
        sizes = self.feasible_sizes(pool_size)
        want = self.demand(pool_size)
        capped = [s for s in sizes if s <= want] or sizes[:1]
        if self.spec.kind == "serve" and want > self.spec.min_devices:
            capped = capped[-1:]
        return capped

    # ------------------------------------------------------------------
    # placement

    def _runs(self) -> bool:
        """Whether this rank runs the job (holds a rank of its slice)."""
        return self.model is not None \
            and not getattr(self.model.machine, "bystander", False) \
            and self.model.machine.device.type != "meta"

    def _build(self, pool, ordinals, strategy):
        import copy

        from flexflow_tpu_torch.strategy import Strategy

        machine = slice_machine(pool, ordinals)
        cfg = copy.copy(self.spec.config)
        cfg.min_devices = self.spec.min_devices
        cfg.strategies = strategy if strategy is not None else Strategy()
        model = self.spec.build(cfg, machine)
        if model.sharded:
            model._setup_sharded()   # its groups, on every rank in order
        return model

    def place(self, pool, ordinals: Sequence[int], strategy=None,
              drain: Optional[Dict] = None) -> None:
        """Build the job's model on its slice of ``pool`` (on every rank:
        a rank outside it builds the bystander view) and start the
        runner on the slice's ranks.  ``strategy`` is the arbiter's
        priced plan for this slice size (None: data parallel)."""
        self.to_state("placing", ordinals=sorted(int(i) for i in ordinals))
        self.ordinals = sorted(int(i) for i in ordinals)
        if self.clock is not None:
            self.clock.advance(self.clock.resize_steps)
        if self.spec.sim_steps > 0:
            self.strategy = strategy
            self.to_state("running")
            return
        self._drain = drain
        self.model = self._build(pool, self.ordinals, strategy)
        self.strategy = self.model.config.strategies
        if self.spec.kind == "train":
            self._start_train()
        else:
            self._start_serve(drain)
        self.to_state("running")

    def _start_train(self) -> None:
        model = self.model
        self._batches = self.spec.payload()
        self.iters_done = 0
        if not self._runs():
            return
        self._params, self._state = model.init(model.config.seed)
        self._opt = model.init_opt_state(self._params)
        self._step = model.make_train_step()

    def _start_serve(self, drain: Optional[Dict]) -> None:
        from flexflow_tpu_torch.serve.engine import ServeEngine

        if not self._runs():
            self.engine = _Mirror()
            return
        # the coordinator is the only resizer: watermarks off
        self.engine = ServeEngine(self.model, None, olog=self.olog,
                                  log=self.log, queue_hi=0,
                                  idle_boundaries=0)
        self.engine.start(list(self.spec.payload), drain=drain)

    # ------------------------------------------------------------------
    # stepping

    def step_quantum(self, n: int, drain: Optional[Dict] = None,
                     pool=None) -> bool:
        """Up to ``n`` steps (train iterations / decode boundaries) on the
        slice's ranks, then the slice's first rank shares the outcome
        with every rank of ``pool``'s world.  Returns True while the job
        has work left; on exhaustion the job goes to ``done`` with its
        result."""
        self.last_quantum_steps = 0
        if self.state != "running":
            return self.active
        try:
            if self.spec.sim_steps > 0:
                return self._sim_quantum(n, drain)
            status = None
            if self._runs():
                status = (self._train_quantum(n, drain)
                          if self.spec.kind == "train"
                          else self._serve_quantum(n))
            if pool is not None:
                status = distributed.share(
                    status, world_rank(pool, self.ordinals[0]))
            return self._apply(status)
        except Exception as e:  # noqa: BLE001 — one job must not kill the fleet
            self.fail(f"{type(e).__name__}: {e}")
            raise

    def _train_quantum(self, n: int, drain: Optional[Dict]) -> Dict:
        total = int(self.model.config.num_iterations)
        losses = []
        steps = 0
        for _ in range(n):
            if self.iters_done + steps >= total:
                break
            if drain is not None and drain.get("requested"):
                break
            batch = self.model.local_batch(*next(self._batches))
            self._params, self._state, self._opt, loss = self._step(
                self._params, self._state, self._opt, *batch)
            losses.append(float(loss))
            steps += 1
        drained = bool(drain is not None and drain.get("requested"))
        return {"steps": steps, "losses": losses, "drained": drained,
                "devices": self.model.machine.num_devices}

    def _serve_quantum(self, n: int) -> Dict:
        eng = self.engine
        steps = 0
        for _ in range(n):
            if not eng.step_once():
                break
            steps += 1
        out = {"steps": steps, "queue_depth": eng.queue_depth(),
               "result": None}
        if not eng.pending():
            self.served = eng.session_completed()
            out["result"] = eng.finish()
        return out

    def _apply(self, status: Dict) -> bool:
        """Take one quantum's outcome (the slice's first rank's) on every
        rank: the steps, the losses, the queue depth and the end."""
        self.last_quantum_steps = int(status["steps"])
        if self.spec.kind == "train":
            self._loss_hist.extend(status["losses"])
            self.iters_done += self.last_quantum_steps
            total = int(self.spec.config.num_iterations)
            drained = status["drained"]
            if self.iters_done >= total or drained:
                self.result = {
                    "loss": list(self._loss_hist),
                    "iters": self.iters_done,
                    "devices": status["devices"],
                    "drained": drained and self.iters_done < total,
                }
                self.to_state("done", iters=self.iters_done,
                              drained=self.result["drained"])
                return False
            return True
        if isinstance(self.engine, _Mirror):
            self.engine.depth = int(status["queue_depth"])
        if status["result"] is not None:
            self.result = status["result"]
            self.to_state("done",
                          completed=self.result["completed"],
                          unserved=self.result["unserved"])
            return False
        return True

    def _sim_quantum(self, n: int, drain: Optional[Dict]) -> bool:
        """Burn up to ``n`` virtual steps of the synthetic trace."""
        for _ in range(n):
            if self._sim_left <= 0:
                break
            if drain is not None and drain.get("requested"):
                break
            self._sim_left -= 1
            self.iters_done += 1
            self.last_quantum_steps += 1
        drained = bool(drain is not None and drain.get("requested"))
        if self._sim_left <= 0 or drained:
            self.result = {"iters": self.iters_done, "sim": True,
                           "devices": len(self.ordinals),
                           "drained": drained and self._sim_left > 0}
            self.to_state("done", iters=self.iters_done,
                          drained=self.result["drained"])
            return False
        return True

    # ------------------------------------------------------------------
    # directed resize

    def resize(self, pool, new_ordinals: Sequence[int]) -> List[Dict]:
        """Move this running job to ``new_ordinals`` of ``pool`` (on every
        rank).  A nested change is one shrink or one grow; a sideways
        move is a shrink to the intersection and a grow, each leg one
        ``elastic_resize`` record.  Walks running -> draining -> resized
        -> running.  A failed leg resumes the job on the slice the
        completed legs left it holding, then re-raises."""
        new = sorted(int(i) for i in new_ordinals)
        old = list(self.ordinals)
        if new == old:
            return []
        if not set(new) & set(old):
            raise JobStateError(
                f"job {self.spec.job_id}: target slice {new} shares no "
                f"device with the current {old} — a fleet repack must "
                f"keep every job anchored (nested or overlapping moves "
                f"only)")
        self.to_state("draining", target=new)
        if self.clock is not None:
            self.clock.advance(self.clock.resize_steps)
        legs = []
        inter = sorted(set(new) & set(old))
        if self.spec.sim_steps > 0:
            if inter != old:
                legs.append({"direction": "shrink",
                             "devices": len(inter)})
            if new != inter:
                legs.append({"direction": "grow", "devices": len(new)})
            self.ordinals = new
        else:
            try:
                if inter != old:      # release what the target drops
                    legs.append(self._resize_leg(pool, inter, old))
                    self.ordinals = inter
                if new != inter:      # adopt what the target adds
                    legs.append(self._resize_leg(pool, new, inter))
                self.ordinals = new
            except Exception as e:  # noqa: BLE001 — abort, resume in place
                self.to_state("running",
                              resize_failed=f"{type(e).__name__}",
                              ordinals=list(self.ordinals))
                raise
        self.to_state("resized", ordinals=new,
                      directions=[r["direction"] for r in legs])
        if self.clock is not None:
            self.clock.advance(self.clock.resize_steps)
        self.to_state("running")
        self.degraded = 0
        return legs

    def _resize_leg(self, pool, target: List[int], cur: List[int]) -> Dict:
        """One shrink or grow leg: a slice move inside the world
        (``utils.elastic.slice_move``), then the runner on the new
        slice."""
        from flexflow_tpu_torch.serve.engine import (_SESSION_SHARED,
                                                     ServeEngine)
        from flexflow_tpu_torch.utils.elastic import slice_move

        train = self.spec.kind == "train"
        runs = self._runs()
        if train:
            step = self.iters_done
            params, state, opt = self._params, self._state, self._opt
        else:
            eng = self.engine
            step = distributed.share(
                eng.session_steps() if runs else None, world_rank(pool, cur[0]))
            params, state, opt = (eng.params, eng.state, None) if runs \
                else (None, None, None)
        new_model, carry, rec = slice_move(
            self.model, pool, cur, target, step=step, params=params,
            state=state, opt_state=opt, rebuild=self.spec.build,
            build=lambda strategy: self._build(pool, target, strategy),
            pre_strategy=self.strategy, olog=self.olog, log=self.log,
            objective="makespan" if train else "latency", train=train)
        self.model = new_model
        self.strategy = new_model.config.strategies
        now = self._runs()
        if train:
            if now:
                self._params, self._state = carry["params"], carry["state"]
                self._opt = carry["opt_state"] \
                    or new_model.init_opt_state(carry["params"])
                self._step = new_model.make_train_step()
            else:
                self._params = self._state = self._opt = self._step = None
        else:
            # the session as the old slice's first rank has it, for a
            # rank joining the slice
            sess = None
            if runs:
                e = self.engine
                sess = {"sess": {k: e._sess[k] for k in _SESSION_SHARED},
                        "resizes": e.resizes,
                        "forward_steps": e.forward_steps,
                        "busy_s": e.busy_s}
            joining = any(o not in cur for o in target)
            if joining:
                sess = distributed.share(sess, world_rank(pool, cur[0]))
            if now and runs:
                self.engine.adopt_resize(new_model, carry)
            elif now:
                import time

                eng = ServeEngine(new_model, None,
                                  params=carry["params"], olog=self.olog,
                                  log=self.log, queue_hi=0,
                                  idle_boundaries=0)
                eng.state = carry["state"]
                eng._sess = dict(sess["sess"], drain=self._drain,
                                 t_wall0=time.perf_counter())
                eng.resizes = list(sess["resizes"])
                eng.forward_steps = sess["forward_steps"]
                eng.busy_s = sess["busy_s"]
                self.engine = eng
            elif not isinstance(self.engine, _Mirror):
                # this rank left the slice: it keeps the queue depth it
                # last saw, which the next quantum's status replaces
                self.engine = _Mirror(self.engine.queue_depth())
        return {"direction": rec["direction"],
                "devices": rec["to_devices"]}

    # ------------------------------------------------------------------

    def losses(self) -> List[float]:
        """The loss history (train jobs), the same on every rank."""
        return list(self._loss_hist)
