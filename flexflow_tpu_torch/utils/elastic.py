"""Elastic training, the fatal device faults and the graceful drain
(PyTorch port of ``flexflow_tpu/utils/elastic.py``).

In the port a "device" is a rank: one process and its card.  Every
rank runs the same loop, so an injected ``device_loss`` marks the same
rank (the highest live ordinal) on each.  The lifecycle:

  1. **detection & classification** — ``fit`` raises
     :class:`DeviceLossDetected` at the boundary after an injected loss,
     after a watchdog expiry whose :func:`probe_devices` finds a dead
     card, or after a step error that :func:`classify` calls a device's
     and whose probe finds one dead; a probe that recovers is a
     transient fault, and the step is retried (at most 3 times until
     ``transient_reset_steps`` healthy steps refill the budget).  Each
     rank probes its own card and the outcomes pass through the first
     world's key-value store (``distributed.control_store``), not
     through a collective a dead rank would hang;
  2. **shrink** (:func:`recover`) — every rank of the old world takes
     part in one gather of the live state, whole on rank 0
     (``FFModel.gather_trees``); the survivors re-form a world of their
     own (``distributed.reform``), rank 0 of it re-searches a strategy
     for it under ``--research-budget-s`` (:func:`research_strategy`,
     warm-started from the running one) and hands it to the others
     through the store, every rank rebuilds the model through the
     driver's ``rebuild(config, machine)``, rank 0 scatters each rank's
     blocks of the state (``FFModel.place_state``) and the data stream
     is rebound to the new machine's batch blocks at the same position.
     When the state cannot be gathered, the newest verified checkpoint
     is restored onto the new model instead (an ``elastic_fallback``
     record).  One ``elastic_resize`` record tells the story; a shrink
     below ``--min-devices`` raises :class:`ElasticShrinkRefused`;
  3. **the lost rank stands by** (:func:`stand_by`) — it leaves the loop
     after the gather and waits on the store for a call to grow back or
     for the run's end;
  4. **grow** — after a shrink ``fit`` probes the lost ranks at every
     boundary (:func:`probe_regrow`: an injected loss answers once
     ``device_return`` fires, a real one when its card's own probe,
     posted to the store by the standing-by rank, answers on every
     survivor); ``--regrow-probes`` consecutive answering probes raise
     :class:`DeviceReturnDetected` and :func:`recover_grow` calls the
     lost ranks back and re-forms the whole world, warm-starting the
     search from the strategy before the shrink — at most
     ``--max-regrows`` times;
  5. :func:`directed_resize` is the same shrink or grow for a target
     set imposed from outside, with no fault records;
     :func:`serve_resize` is the serving autoscaler's, re-searched under
     the latency objective, with no optimizer state.

When ``ckpt_dir`` is set, a resize that migrated in memory commits the
state at its step under the new strategy (a port-only save: a restart
after the resize then resumes under the resized world's strategy).

The rest of the runtime:

  * :class:`DeviceLostError` — a loss without ``--elastic``, or one the
    run cannot recover from;
  * :class:`HostCrashError` — the injected ``host_crash``: the process
    leaves ``fit`` through its error exit;
  * the preemption drain: :func:`install_drain_handler` (or
    :class:`drain_scope`) makes SIGTERM and SIGINT set a flag that
    ``fit`` reads at its boundaries; the loop finishes the step, commits
    a verified checkpoint within ``drain_budget_s``, writes one
    ``preempt_drain`` record and returns, and the training app exits 0.
    :func:`request_drain` is the injected ``preempt``'s way in.
"""

from __future__ import annotations

import copy
import datetime
import json
import signal
import threading
import time
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from flexflow_tpu_torch.utils.retry import RetryPolicy, call_with_retry

#: seconds a rank waits for another's probe outcome, or for rank 0's
#: re-searched strategy beyond the search budget, on the store
STORE_WAIT_S = 600.0
#: seconds between a standing-by rank's polls of the store (and probes
#: of its card)
STANDBY_POLL_S = 0.5


class DeviceLostError(RuntimeError):
    """Permanent device loss that the run cannot (or may not) recover
    from: elastic training is off, or no usable state is left."""


class HostCrashError(RuntimeError):
    """An injected ``host_crash``: this process is simulated as dying
    mid-run and leaves ``fit`` through its error exit."""


class ElasticShrinkRefused(RuntimeError):
    """The surviving world is smaller than ``--min-devices``."""

    def __init__(self, live: int, min_devices: int, dead: Sequence[int]):
        self.live = live
        self.min_devices = min_devices
        self.dead = list(dead)
        super().__init__(
            f"device loss left {live} live device(s) (lost ordinals "
            f"{sorted(self.dead)}), below --min-devices {min_devices}; "
            f"refusing to continue on the remnant")


class DeviceLossDetected(Exception):
    """Control flow: ``fit``'s loop raises it at a boundary once a
    permanent loss is established, and ``fit`` runs :func:`recover`.
    ``dead`` are rank ordinals of the running world; ``params`` is None
    when the live state is unreachable (a failed step)."""

    def __init__(self, dead: Sequence[int], step: int, params=None,
                 state=None, opt_state=None, losses=(), loss_base: int = 0,
                 injected: bool = False):
        self.dead = sorted(set(int(d) for d in dead))
        self.step = int(step)
        self.params = params
        self.state = state
        self.opt_state = opt_state
        self.losses = list(losses)
        self.loss_base = int(loss_base)
        # an injected loss has no card to probe: its return is gated on
        # the device_return injection instead
        self.injected = bool(injected)
        super().__init__(
            f"permanent device loss at step {step}: ordinals {self.dead}")


class DeviceReturnDetected(Exception):
    """Control flow, the mirror of :class:`DeviceLossDetected`: raised at
    a healthy boundary once every out-of-service rank answered
    ``k`` consecutive probes; ``fit`` runs :func:`recover_grow`.
    ``returned`` are the members (first-world ranks) coming back."""

    def __init__(self, returned: Sequence[int], step: int, params=None,
                 state=None, opt_state=None, losses=(),
                 loss_base: int = 0):
        self.returned = sorted(set(int(d) for d in returned))
        self.step = int(step)
        self.params = params
        self.state = state
        self.opt_state = opt_state
        self.losses = list(losses)
        self.loss_base = int(loss_base)
        super().__init__(
            f"device return at step {step}: ordinals {self.returned} "
            f"answering again")


# ---------------------------------------------------------------------------
# detection and classification

# substrings (lowercased) of errors that name the DEVICE, not the
# program: the JAX package's, then the CUDA runtime's and the
# collectives' own.  A miss lets the error propagate like any other bug.
_LOSS_PATTERNS = (
    "device_unavailable",
    "device unavailable",
    "device lost",
    "device failure",
    "device is in an error state",
    "hardware failure",
    "chip unreachable",
    "slice health",
    "halted with",
    "tpu is in an invalid state",
    "failed to connect to device",
    "data transfer failure",
    "ici link",
    # CUDA
    "cuda error: an illegal memory access",
    "cuda error: unspecified launch failure",
    "cuda error: uncorrectable ecc error",
    "cuda error: an uncorrectable nvlink error",
    "cuda error: gpu has fallen off the bus",
    "cuda error: launch timed out",
    "cuda error: the launch timed out",
    "cuda error: unknown error",
    # NCCL and the transports of a process group
    "ncclunhandledcudaerror",
    "ncclsystemerror",
    "ncclremoteerror",
    "nccl communicator was aborted",
    "connection reset by peer",
    "connection closed by peer",
)

# exception type names device failures arrive as: the XLA runtime's, and
# PyTorch's (a CUDA error is a RuntimeError, or an AcceleratorError)
_LOSS_TYPES = ("XlaRuntimeError", "JaxRuntimeError", "InternalError",
               "UnavailableError", "RuntimeError", "AcceleratorError")

# a process group's backend failing is a device's (or a peer rank's)
# loss whatever its message
_LOSS_CLASSES = ("DistBackendError", "DistNetworkError")


def classify(exc: BaseException) -> bool:
    """Does ``exc`` look like a device or runtime loss (vs an ordinary
    program bug)?  True: the caller should probe the devices; False:
    re-raise, it is not elasticity's problem."""
    if isinstance(exc, (DeviceLostError, DeviceLossDetected)):
        return True
    if type(exc).__name__ in _LOSS_CLASSES:
        return True
    if type(exc).__name__ not in _LOSS_TYPES:
        return False
    text = f"{type(exc).__name__}: {exc}".lower()
    return any(p in text for p in _LOSS_PATTERNS)


def _default_probe(device) -> None:
    """One tiny host -> device -> host round trip; raises on a dead card."""
    x = torch.ones((), device=device)
    if float(x.cpu()) != 1.0:
        raise RuntimeError(f"device {device} returned a wrong value")


# probe rounds per world generation: every rank of a world probes at the
# same boundaries, so the n-th round has one key on each
_PROBE_ROUNDS: Dict[int, int] = {}


def _wait_key(store, key: str, timeout_s: float) -> bytes:
    store.wait([key], datetime.timedelta(seconds=timeout_s))
    return store.get(key)


def probe_devices(machine, policy: Optional[RetryPolicy] = None,
                  probe=None, olog=None, sleep=time.sleep
                  ) -> Tuple[List[int], List[int], List[int]]:
    """Probe the devices of ``machine`` with bounded backoff and split the
    outcome into ``(live, dead, transient)`` rank ordinals, ``transient``
    the live ones that failed before answering.  Each rank probes its own
    card (``probe(device)`` raising is one failed attempt; 3 attempts by
    default) and, over several ranks, posts its outcome to the store and
    reads the others'; a rank that posts none within ``STORE_WAIT_S``
    seconds is dead.  Every rank of the world must call it at the same boundary.
    Rank 0 writes one ``device_probe`` record per dead or transient
    ordinal."""
    from flexflow_tpu_torch import distributed, obs

    olog = olog if olog is not None else obs.NULL
    policy = policy or RetryPolicy(attempts=3, base_delay=0.05,
                                   max_delay=0.5)
    probe = probe or _default_probe
    failures = {"n": 0}

    def on_retry(exc, n, delay):
        failures["n"] = n

    mine = {"outcome": "live", "failures": 0}
    try:
        call_with_retry(lambda: probe(machine.device), policy=policy,
                        retry_on=(Exception,), on_retry=on_retry,
                        sleep=sleep)
        mine["failures"] = failures["n"]
    except Exception as e:
        mine = {"outcome": "dead", "error": str(e)}
    store = distributed.control_store()
    if machine.num_devices > 1 and store is not None:
        gen = machine.generation
        n = _PROBE_ROUNDS[gen] = _PROBE_ROUNDS.get(gen, 0) + 1
        prefix = f"elastic/{gen}/probe/{n}/"
        store.set(prefix + str(machine.rank), json.dumps(mine))
        outcomes = []
        for r in range(machine.num_devices):
            try:
                outcomes.append(json.loads(_wait_key(store, prefix + str(r),
                                                     STORE_WAIT_S)))
            except Exception as e:
                outcomes.append({"outcome": "dead",
                                 "error": f"no probe outcome posted: {e}"})
    else:
        outcomes = [mine]
    live: List[int] = []
    dead: List[int] = []
    transient: List[int] = []
    for i, o in enumerate(outcomes):
        if o["outcome"] == "dead":
            dead.append(i)
            olog.event("device_probe", device=i, outcome="dead",
                       attempts=policy.attempts, error=o["error"])
            continue
        live.append(i)
        if o["failures"]:
            transient.append(i)
            olog.event("device_probe", device=i, outcome="transient",
                       failures=o["failures"])
    return live, dead, transient


# ---------------------------------------------------------------------------
# recovery


def gather_state(model, params, state, opt_state, dst: int = 0):
    """The LIVE train state as whole host trees ``(params, state, opt)``:
    one gather over the running world (``FFModel.gather_trees``; every
    rank calls it, rank ``dst`` gets the trees, the others None).  Raises
    when a leaf is unreachable; the caller falls back to a checkpoint."""
    if params is None:
        raise DeviceLostError("live state unreachable (the failed step's "
                              "inputs are gone)")
    return model.gather_trees(params, state, opt_state, dst=dst)


def warm_assignment(search, strategy, fallback=None) -> List[int]:
    """Candidate index per op seeding a re-search from a known-good
    strategy: an entry whose (dims, devices) is among the op's candidates
    on the new machine keeps its config; the rest fall back to
    ``fallback`` (the running shrunk strategy on the grow path), then to
    data parallel (``flexflow_tpu/utils/elastic.py:283``)."""
    from flexflow_tpu_torch.sim.search import _InputSource

    dp = search.dp_assignment()
    out = []
    for op, cands, dflt in zip(search.ops, search.candidates, dp):
        idx = dflt
        if not isinstance(op, _InputSource):
            for strat in (strategy, fallback):
                if strat is None:
                    continue
                pc = strat.get(op.name)
                if pc is None:
                    continue
                hit = next((i for i, c in enumerate(cands)
                            if c.dims == pc.dims and c.devices == pc.devices),
                           None)
                if hit is not None:
                    idx = hit
                    break
        out.append(idx)
    return out


def research_strategy(config, rebuild, new_machine, old_strategy,
                      olog=None, log=print, fallback_strategy=None,
                      objective: str = "makespan"):
    """Re-run the MCMC search for the resized machine (a planning machine:
    ``MachineModel.shrink``/``grow``) under ``research_budget_s`` of wall
    clock and ``elastic_search_iters`` proposals, warm-started from
    ``old_strategy`` (its missing entries from ``fallback_strategy``);
    the shell model is ``rebuild(config without strategies,
    new_machine)``.  Returns ``(Strategy, info)``, ``info["mode"]``
    ``"mcmc"`` (``flexflow_tpu/utils/elastic.py:316``: one chain with
    delta simulation, JAX's defaults), ``"mcmc_decomposed"`` under
    ``decompose`` (the block-decomposed search,
    ``StrategySearch.search_decomposed``: ``research_budget_s`` caps the
    whole of it, ``block_budget_s`` each block, and
    ``boundary_refine_iters`` are the refinement pass's proposals) or,
    when the search is unavailable, ``"dp_fallback"`` with data
    parallel.  ``objective`` goes to ``StrategySearch``: training's
    recovery keeps ``"makespan"``, the serving autoscaler
    (``serve/engine.py``) re-searches under ``"latency"``."""
    from flexflow_tpu_torch.strategy import Strategy

    budget = float(getattr(config, "research_budget_s", 30.0) or 30.0)
    iters = int(getattr(config, "elastic_search_iters", 2000) or 2000)
    try:
        from flexflow_tpu_torch.sim.search import StrategySearch

        shell_cfg = copy.copy(config)
        shell_cfg.strategies = Strategy()
        shell = rebuild(shell_cfg, new_machine)
        ss = StrategySearch(shell, machine=new_machine, obs=olog,
                            objective=objective)
        warm = old_strategy if old_strategy is not None \
            and len(old_strategy) else None
        warm_fb = fallback_strategy if fallback_strategy is not None \
            and len(fallback_strategy) else None
        start = warm_assignment(ss, warm, fallback=warm_fb) \
            if warm is not None or warm_fb is not None else None
        if getattr(config, "decompose", False):
            # one deadline for every block's sub-search and the refinement
            # pass: research_budget_s caps the whole re-search, as on the
            # flat path (flexflow_tpu/utils/elastic.py:355-370)
            strategy, info = ss.search_decomposed(
                iters=iters, seed=int(getattr(config, "seed", 0)),
                delta=True, start=start, budget_s=budget,
                block_budget_s=getattr(config, "block_budget_s", 0.0)
                or None,
                boundary_refine_iters=int(getattr(
                    config, "boundary_refine_iters", 0)))
            return strategy, {"mode": "mcmc_decomposed",
                              "best_time_s": info.get("best_time"),
                              "iters": info.get("iters_done"),
                              "budget_hit": info.get("budget_hit", False),
                              "budget_s": budget,
                              "blocks": info.get("blocks"),
                              "memo_hits": info.get("memo_hits"),
                              "objective": objective}
        strategy, info = ss.search(
            iters=iters, seed=int(getattr(config, "seed", 0)), chunks=8,
            chains=1, delta=True, start=start, budget_s=budget)
        return strategy, {"mode": "mcmc",
                          "best_time_s": info.get("best_time"),
                          "iters": info.get("iters_done"),
                          "budget_hit": info.get("budget_hit", False),
                          "budget_s": budget, "objective": objective}
    except Exception as e:
        log(f"elastic: surviving-mesh re-search unavailable ({e}); "
            f"continuing pure-DP on {new_machine.num_devices} devices")
        return Strategy(), {"mode": "dp_fallback", "error": str(e),
                            "budget_s": budget, "objective": objective}


def _losses(sig) -> List[float]:
    """The completed steps' losses as floats (best effort)."""
    try:
        return [float(v) for v in sig.losses]
    except Exception:
        return []


def _check_stream(data) -> None:
    if data is not None and not hasattr(data, "rebind"):
        raise DeviceLostError(
            "elastic resize needs a data stream that follows the machine's "
            "batch blocks (data.BlockStream, rebind(machine, position)); "
            "this one cannot")


def _relocate(model, sig, members: List[int], plan_machine, rebuild,
              warm, warm_fallback, olog, log, data, call=None,
              objective: str = "makespan", train: bool = True):
    """The resize every rank of the running world takes part in: the
    gather of the live state on the old world, the call of returning
    ranks (``call``: ``{member: message}``, sent by rank 0; a grow, which
    raises instead when the gather failed, before anything changed), the
    re-formed world over ``members``, then :func:`_land` (its search
    under ``objective``; ``train`` as there).  Returns ``(new_model, carry, header)``, or None
    on a rank left out."""
    from flexflow_tpu_torch import distributed

    old = model.machine
    trees, reason = None, None
    try:
        # whole on the old rank that is rank 0 of the new world
        trees = gather_state(model, sig.params, sig.state, sig.opt_state,
                             dst=old.members.index(members[0]))
    except Exception as e:
        reason = str(e)
        if call:
            raise DeviceLostError(f"the live state could not be gathered "
                                  f"({e})") from e
    if call and old.rank == 0:
        store = distributed.control_store()
        for m, msg in call.items():
            store.set(f"elastic/call/{m}", json.dumps(msg))
    new_machine = distributed.reform(members, distributed.generation() + 1)
    # the old world's groups are gone: nothing may reach them
    old._handles.clear()
    old._groups.clear()
    if new_machine is None:
        return None
    head = {"migrated": trees is not None, "reason": reason,
            "position": getattr(data, "position", None),
            "step": sig.step, "loss_base": sig.loss_base}
    new_model, carry, head = _land(model.config, new_machine, plan_machine,
                                   rebuild, warm, warm_fallback, olog, log,
                                   data, trees, head, objective=objective,
                                   train=train)
    if trees is not None and head["migrated"]:
        from flexflow_tpu_torch.parallel.regrid import plan_state_migration

        head["plan"] = plan_state_migration(model, new_model, *trees)
    return new_model, carry, head


def _land(cfg, new_machine, plan_machine, rebuild, warm, warm_fallback,
          olog, log, data, trees=None, head=None,
          objective: str = "makespan", train: bool = True):
    """Every rank of a re-formed world: rank 0 searches the strategy and
    posts it to the store, every rank rebuilds the model, rank 0 hands
    each rank its blocks of the gathered state (or every rank restores
    the newest verified checkpoint when there is none) and the data
    stream is rebound.  The search runs under ``objective``.  Without
    ``train`` (a serving resize) there is no optimizer state and nothing
    is checkpointed.  Returns ``(new_model, carry, header)``, the header
    rank 0's (``migrated``, ``reason``, ``position``, ``step``,
    ``research``, ``research_s``, ``resume_step``, ``plan``)."""
    import torch.distributed as dist

    from flexflow_tpu_torch import distributed
    from flexflow_tpu_torch.strategy import Strategy

    store = distributed.control_store()
    key = f"elastic/{new_machine.generation}/strategy"
    research_s, research = 0.0, None
    budget = float(getattr(cfg, "research_budget_s", 30.0) or 30.0)
    if new_machine.rank == 0:
        t0 = time.perf_counter()
        strategy, research = research_strategy(
            cfg, rebuild, plan_machine, warm, olog=olog, log=log,
            fallback_strategy=warm_fallback, objective=objective)
        research_s = time.perf_counter() - t0
        store.set(key, strategy.to_json())
    else:
        strategy = Strategy.from_json(
            _wait_key(store, key, budget + STORE_WAIT_S).decode())
    final_cfg = copy.copy(cfg)
    final_cfg.strategies = strategy
    try:
        new_model = rebuild(final_cfg, new_machine)
    except Exception as e:
        raise DeviceLostError(
            f"cannot rebuild the model on the {new_machine.num_devices} "
            f"surviving device(s): {e} (pick a batch size divisible by "
            f"every survivable world, or raise --min-devices)") from e
    if new_model.sharded:
        new_model._setup_sharded()   # its groups, on every rank in order
    world = new_machine.num_devices > 1
    if world:
        box = [head]
        dist.broadcast_object_list(box, src=0)
        head = box[0]
    if head["migrated"]:
        if world:
            view = new_model.machine.view
            blocks = None
            if new_machine.rank == 0:
                blocks = [new_model._blocks_at(*trees, view.index(r))
                          for r in range(new_machine.num_devices)]
            got = [None]
            dist.scatter_object_list(got, blocks, src=0)
            params, state, opt_state = new_model.place_state(*got[0],
                                                             blocks=True)
        else:
            params, state, opt_state = new_model.place_state(*trees)
        resume_step = head["step"]
    else:
        ckpt_dir = getattr(cfg, "ckpt_dir", "")
        if not ckpt_dir:
            raise DeviceLostError(
                f"device loss at step {head['step']}: live state is "
                f"unreachable ({head['reason']}) and no --ckpt-dir is "
                f"configured to restore from")
        resume_step, params, state, opt_state = new_model._restore(
            ckpt_dir, olog)
    if train:
        opt_state = opt_state or new_model.init_opt_state(params)
    if train and head["migrated"] and getattr(cfg, "ckpt_dir", ""):
        from flexflow_tpu_torch.utils import checkpoint as ckpt

        # the resized run's state under its own strategy: a restart
        # resumes the resized world (every rank takes part)
        new_model._save(ckpt, resume_step, params, state, opt_state, log,
                        olog)
    if data is not None:
        data.rebind(new_model.machine, head["position"])
    head = dict(head, research=research, research_s=research_s,
                resume_step=resume_step)
    carry = {"start_iter": resume_step, "params": params, "state": state,
             "opt_state": opt_state}
    return new_model, carry, head


def recover(model, sig: DeviceLossDetected, rebuild, olog=None,
            log=print, cause: str = "fault", data=None):
    """The shrink after a permanent loss of the ranks ``sig.dead``
    (``flexflow_tpu/utils/elastic.py:397``), on every rank of the running
    world, the lost ones too: the ``device_loss`` record (``cause``
    ``"fault"``), the ``--min-devices`` refusal, the gather, the
    re-formed world, the shared re-searched strategy, the rebuilt model,
    the placed state (or the checkpoint fallback, with an
    ``elastic_fallback`` record) and one ``elastic_resize`` record.
    ``data`` (a :class:`~flexflow_tpu_torch.data.BlockStream`) is
    rebound to the new machine.

    Returns ``(new_model, carry, prior_losses)`` on a surviving rank,
    ``carry`` ``fit``'s resume (start iteration, placed state) and
    ``prior_losses`` the completed steps still valid (trimmed when the
    fallback rewinds); ``(None, None, prior_losses)`` on a lost rank,
    which then stands by (:func:`stand_by`)."""
    from flexflow_tpu_torch import obs

    olog = olog if olog is not None else obs.NULL
    t0 = time.perf_counter()
    cfg = model.config
    machine = model.machine
    n_old = machine.num_devices
    dead = set(sig.dead)
    live = [i for i in range(n_old) if i not in dead]
    min_devices = max(int(getattr(cfg, "min_devices", 1) or 1), 1)
    if cause == "fault":
        olog.event("device_loss", step=sig.step,
                   classification="permanent", dead=sorted(dead),
                   live=len(live), devices=n_old)
        log(f"elastic: permanent device loss at iteration {sig.step} — "
            f"ordinals {sorted(dead)} dead, {len(live)}/{n_old} "
            f"surviving")
    else:
        log(f"elastic: directed shrink at iteration {sig.step} — "
            f"releasing ordinals {sorted(dead)}, keeping "
            f"{len(live)}/{n_old}")
    if len(live) < min_devices:
        olog.event("elastic_refused", step=sig.step, live=len(live),
                   min_devices=min_devices, dead=sorted(dead))
        raise ElasticShrinkRefused(len(live), min_devices, sorted(dead))
    if rebuild is None:
        raise DeviceLostError(
            "elastic recovery needs a model factory: pass "
            "rebuild=lambda cfg, machine: <build model> to fit() "
            "(the drivers do)")
    _check_stream(data)
    plan_machine = machine.shrink(live)
    prior = _losses(sig)
    moved = _relocate(model, sig, list(plan_machine.members), plan_machine,
                      rebuild, getattr(cfg, "strategies", None), None, olog,
                      log, data)
    if moved is None:
        log(f"elastic: this rank (ordinal {machine.rank}) is out of "
            f"service from iteration {sig.step}; standing by")
        return None, None, prior
    new_model, carry, head = moved
    resume_step = head["resume_step"]
    if head["migrated"]:
        steps_lost = 0
    else:
        olog.event("elastic_fallback", step=sig.step,
                   reason=head["reason"])
        log(f"elastic: in-memory migration unavailable ({head['reason']}); "
            f"restored the newest verified checkpoint onto the "
            f"{len(live)}-device world")
        steps_lost = max(sig.step - resume_step, 0)
        prior = prior[:max(resume_step - sig.loss_base, 0)]
    rec = {
        "step": sig.step, "direction": "shrink", "from_devices": n_old,
        "to_devices": len(live), "dead": sorted(dead), "cause": cause,
        "research_s": head["research_s"], "research": head["research"],
        "migration": "in_memory" if head["migrated"] else "checkpoint",
        "resume_step": resume_step, "steps_lost": steps_lost,
        "total_s": time.perf_counter() - t0,
    }
    _plan_fields(rec, head)
    olog.event("elastic_resize", **rec)
    log(f"elastic: resized {n_old} -> {len(live)} devices at iteration "
        f"{sig.step} (re-search {head['research_s']:.2f}s "
        f"[{(head['research'] or {}).get('mode')}], migration "
        f"{rec['migration']}, resume at {resume_step}, {steps_lost} "
        f"step(s) lost, {rec['total_s']:.2f}s)")
    return new_model, carry, prior


def _plan_fields(rec: Dict, head: Dict) -> None:
    plan = head.get("plan")
    if plan is not None:
        rec["regrid_bytes"] = plan["bytes"]
        rec["regrid_hops"] = plan["hops"]
        rec["regrid_predicted_s"] = plan["predicted_s"]


# ---------------------------------------------------------------------------
# re-expansion (regrow)


def make_regrow_context(model, sig: DeviceLossDetected,
                        probes_needed: int, prior=None) -> Dict:
    """What ``fit`` carries between boundaries while ranks are out: the
    lost members (first-world ranks, captured before the shrink drops
    them) with whether their loss was injected, and the strategy before
    the shrink, which the grow's search starts from.  ``prior`` merges an
    earlier context (a second shrink while the first ranks are out)."""
    devs = [(model.machine.members[o], bool(sig.injected))
            for o in sig.dead if 0 <= o < model.machine.num_devices]
    if prior:
        devs = list(prior.get("dead", ())) + devs
    ctx = {
        "dead": devs,
        "pre_strategy": getattr(model.config, "strategies", None),
        "healthy": 0,
        "probes": 0,
        "k": max(int(probes_needed), 1),
        "answering": False,
    }
    if prior and prior.get("pre_strategy") is not None:
        ctx["pre_strategy"] = prior["pre_strategy"]
    return ctx


def _standby_probe(member) -> None:
    """A lost rank's card as the rank itself last probed it, posted to
    the store while it stands by; raises when it is not answering."""
    from flexflow_tpu_torch import distributed

    store = distributed.control_store()
    key = f"elastic/probe/{member}"
    if store is None or not store.check([key]) or store.get(key) != b"1":
        raise DeviceLostError(f"member {member} is not answering")


def probe_regrow(ctx: Dict, inj=None, olog=None, probe=None, log=print,
                 machine=None) -> bool:
    """One boundary probe of the out-of-service ranks
    (``flexflow_tpu/utils/elastic.py:591``).  Injected losses answer
    once ``device_return`` fires (one fire a probe: ``device_return@2``
    is the second probe); a real one answers when ``probe(member)``
    passes (by default the rank's own card probe, posted to the store
    while it stands by), and over several ranks (``machine``) only when
    it passes on every survivor.  All answering lengthens the healthy
    streak, any miss resets it; True once the streak reaches
    ``ctx["k"]``."""
    from flexflow_tpu_torch import obs

    olog = olog if olog is not None else obs.NULL
    if not ctx or not ctx.get("dead"):
        return False
    ctx["probes"] += 1
    has_injected = any(is_inj for _, is_inj in ctx["dead"])
    if has_injected and inj is not None and getattr(inj, "enabled", False):
        if inj.fire("device_return", site="fit.regrow_probe"):
            ctx["answering"] = True
    probe = probe or _standby_probe
    ok = True
    real = False
    for dev, is_inj in ctx["dead"]:
        if is_inj:
            if not ctx["answering"]:
                ok = False
        else:
            real = True
            try:
                probe(dev)
            except Exception:
                ok = False
        if not ok:
            break
    if real and machine is not None and machine.num_devices > 1:
        import torch.distributed as dist

        # every survivor must decide the same
        t = torch.tensor([float(ok)], device=machine.device)
        dist.all_reduce(t, op=dist.ReduceOp.MIN,
                        group=machine.world_group().handle)
        ok = bool(t.item())
    ctx["healthy"] = ctx["healthy"] + 1 if ok else 0
    ordinals = sorted(d for d, _ in ctx["dead"])
    olog.event("device_probe", outcome="answering" if ok else "out",
               devices=ordinals, healthy_streak=ctx["healthy"],
               needed=ctx["k"], probe=ctx["probes"])
    if ok and ctx["healthy"] == 1:
        log(f"elastic: out-of-service ordinals {ordinals} answering "
            f"(streak 1/{ctx['k']})")
    return ctx["healthy"] >= ctx["k"]


def recover_grow(model, sig: DeviceReturnDetected, ctx: Dict, rebuild,
                 olog=None, log=print, cause: str = "fault", data=None,
                 call=None):
    """The grow after the out-of-service ranks answered
    (``flexflow_tpu/utils/elastic.py:634``), on every surviving rank: the
    ``device_return`` record (``cause`` ``"fault"``), the gather on the
    shrunk world, rank 0's call to the returning ranks (``call``: the
    fields of ``fit``'s loop they adopt, beside the new world), the
    re-formed whole world, the search warm-started from the strategy
    before the shrink (the running one as the per-op fallback), the
    placed state and one ``elastic_resize`` record with ``direction``
    ``"grow"``.  Returns ``(new_model, carry, prior_losses)``.  A failure
    before the call leaves the world as it was, and the caller keeps
    training shrunk."""
    from flexflow_tpu_torch import obs

    olog = olog if olog is not None else obs.NULL
    t0 = time.perf_counter()
    cfg = model.config
    machine = model.machine
    n_old = machine.num_devices
    returned = [dev for dev, _ in ctx["dead"]]
    ordinals = sorted(returned)
    plan_machine = machine.grow(returned)
    n_new = plan_machine.num_devices
    if cause == "fault":
        olog.event("device_return", step=sig.step, returned=ordinals,
                   from_devices=n_old, to_devices=n_new,
                   probes=ctx.get("probes"),
                   healthy_streak=ctx.get("healthy"))
        log(f"elastic: ordinals {ordinals} back after "
            f"{ctx.get('probes')} probe(s) — growing {n_old} -> {n_new} "
            f"devices at iteration {sig.step}")
    else:
        log(f"elastic: directed grow at iteration {sig.step} — adding "
            f"ordinals {ordinals}, {n_old} -> {n_new} devices")
    if rebuild is None:
        raise DeviceLostError(
            "elastic regrow needs a model factory: pass "
            "rebuild=lambda cfg, machine: <build model> to fit() "
            "(the drivers do)")
    _check_stream(data)
    prior = _losses(sig)
    from flexflow_tpu_torch import distributed

    msg = dict(call or {}, op="grow", members=list(plan_machine.members),
               generation=distributed.generation() + 1, step=sig.step)
    new_model, carry, head = _relocate(
        model, sig, list(plan_machine.members), plan_machine, rebuild,
        ctx.get("pre_strategy"), getattr(cfg, "strategies", None), olog,
        log, data, call={m: msg for m in ordinals})
    rec = {
        "step": sig.step, "direction": "grow", "from_devices": n_old,
        "to_devices": n_new, "returned": ordinals, "cause": cause,
        "research_s": head["research_s"], "research": head["research"],
        "migration": "in_memory", "resume_step": sig.step,
        "steps_lost": 0, "total_s": time.perf_counter() - t0,
    }
    _plan_fields(rec, head)
    olog.event("elastic_resize", **rec)
    log(f"elastic: resized {n_old} -> {n_new} devices at iteration "
        f"{sig.step} (re-search {head['research_s']:.2f}s "
        f"[{(head['research'] or {}).get('mode')}], migration in_memory, "
        f"resume at {sig.step}, 0 step(s) lost, {rec['total_s']:.2f}s)")
    return new_model, carry, prior


def directed_resize(model, *, keep=None, add=None, step: int,
                    params, state, opt_state=None, losses=(),
                    loss_base: int = 0, rebuild, pre_strategy=None,
                    olog=None, log=print, data=None):
    """Resize a healthy run to a target set imposed from outside
    (``flexflow_tpu/utils/elastic.py:730``): ``keep`` (rank ordinals to
    retain: a shrink through :func:`recover`, which still enforces
    ``--min-devices``) or ``add`` (members, first-world ranks, standing
    by: a grow through :func:`recover_grow`), exactly one; no fault
    records, one ``elastic_resize``.  Every rank of the running world
    calls it.  Returns what those return."""
    if (keep is None) == (add is None):
        raise ValueError(
            "directed_resize: pass exactly one of keep= (ordinals to "
            "retain -> shrink) or add= (device objects to adopt -> grow)")
    if keep is not None:
        n = model.machine.num_devices
        keep_set = {int(i) for i in keep}
        bad = [i for i in keep_set if not 0 <= i < n]
        if bad:
            raise ValueError(
                f"directed_resize: keep ordinals {sorted(bad)} out of "
                f"range for a {n}-device machine")
        dead = [i for i in range(n) if i not in keep_set]
        if not dead:
            raise ValueError(
                "directed_resize: keep covers every device — nothing "
                "to release")
        sig = DeviceLossDetected(
            dead, step, params=params, state=state, opt_state=opt_state,
            losses=losses, loss_base=loss_base)
        return recover(model, sig, rebuild, olog=olog, log=log,
                       cause="directed", data=data)
    devs = list(add)
    if not devs:
        raise ValueError("directed_resize: add= is empty")
    sig = DeviceReturnDetected(
        devs, step, params=params,
        state=state, opt_state=opt_state, losses=losses,
        loss_base=loss_base)
    ctx = {
        "dead": [(d, False) for d in devs],
        "pre_strategy": pre_strategy,
        "healthy": 1, "probes": 0, "k": 1, "answering": True,
    }
    return recover_grow(model, sig, ctx, rebuild, olog=olog, log=log,
                        cause="directed", data=data)


def slice_move(model, pool, cur: Sequence[int], target: Sequence[int], *,
               step: int, params, state, opt_state=None, rebuild, build,
               pre_strategy=None, olog=None, log=print,
               objective: str = "makespan", train: bool = True):
    """A directed move of a job that runs on a slice of ``pool``'s world
    (the fleet, ``fleet/job.py``) from the pool ordinals ``cur`` to
    ``target``, one shrink (``target`` inside ``cur``) or one grow, with
    no re-form of the world.  Every rank of the world calls it, the
    slice's ranks with the live ``params``/``state``/``opt_state``, the
    others with None.  The live state is gathered from the old slice
    (``FFModel.gather_trees``) onto its first rank; rank 0 re-searches
    the strategy for the new slice (:func:`research_strategy` under
    ``objective``, warm-started from the running strategy, on a shrink,
    or from ``pre_strategy``, on a grow) and shares it; every rank builds
    the new slice's model (``build(strategy)``: every slice's groups are
    made on every rank, in one order); the old slice's first rank sends
    the state to the new slice's ranks alone, point to point, and they
    place it (a rank outside both moves nothing).  The migration plan is
    priced on that first rank and shared with rank 0, which writes one
    ``elastic_resize`` record with the fields of JAX's
    ``directed_resize`` (``cause: "directed"``), no fault record; a
    shrink below ``--min-devices`` is refused as :func:`recover`
    refuses it.  Returns ``(new_model, carry, record)``, ``carry``'s
    trees None on a rank outside the new slice."""
    from flexflow_tpu_torch import distributed, obs
    from flexflow_tpu_torch.strategy import Strategy

    olog = olog if olog is not None else obs.NULL
    t0 = time.perf_counter()
    cur, target = sorted(int(o) for o in cur), sorted(int(o) for o in target)
    cfg = model.config
    shrink = set(target) < set(cur)
    if shrink:
        dead = [i for i, o in enumerate(cur) if o not in target]
        min_devices = max(int(getattr(cfg, "min_devices", 1) or 1), 1)
        log(f"elastic: directed shrink at iteration {step} — releasing "
            f"ordinals {dead}, keeping {len(target)}/{len(cur)}")
        if len(target) < min_devices:
            olog.event("elastic_refused", step=step, live=len(target),
                       min_devices=min_devices, dead=dead)
            raise ElasticShrinkRefused(len(target), min_devices, dead)
    runs = not getattr(model.machine, "bystander", False) \
        and model.device.type != "meta"
    trees = None
    if runs:
        if model.sharded:
            trees = model.gather_trees(params, state, opt_state, dst=0)
        else:
            trees = tuple({k: {leaf: v.detach().cpu() for leaf, v in
                               sub.items()} for k, sub in (t or {}).items()}
                          for t in (params, state, opt_state))
    holder = int(pool.view[cur[0]])   # the old slice's first rank
    strategy = getattr(cfg, "strategies", None)
    warm, fallback = (strategy, None) if shrink else (pre_strategy,
                                                     strategy)
    head = None
    if pool.rank == 0:
        r0 = time.perf_counter()
        found, research = research_strategy(
            cfg, rebuild, pool.slice_of(target), warm, olog=olog, log=log,
            fallback_strategy=fallback, objective=objective)
        head = (found.to_json(), research, time.perf_counter() - r0)
    found_json, research, research_s = distributed.share(head, 0)
    new_model = build(Strategy.from_json(found_json))
    carry = {"start_iter": step, "params": None, "state": None,
             "opt_state": None}
    now = not getattr(new_model.machine, "bystander", False) \
        and new_model.device.type != "meta"
    trees = distributed.send_to(
        trees, holder, [int(pool.view[o]) for o in target]) \
        if pool.distributed else trees
    if now:
        p, st, opt = new_model.place_state(*trees)
        if train:
            opt = opt or new_model.init_opt_state(p)
        carry.update(params=p, state=st, opt_state=opt if train else None)
    rec = {"step": step, "direction": "shrink" if shrink else "grow",
           "from_devices": len(cur), "to_devices": len(target)}
    if shrink:
        rec["dead"] = dead
    else:
        rec["returned"] = [o for o in target if o not in cur]
    rec.update(cause="directed", research_s=research_s, research=research,
               migration="in_memory", resume_step=step, steps_lost=0,
               total_s=time.perf_counter() - t0)
    plan = None
    if pool.rank == holder:
        try:
            from flexflow_tpu_torch.parallel.regrid import \
                plan_state_migration

            plan = plan_state_migration(model, new_model, *trees)
        except Exception as e:  # a planning view it cannot price
            plan = str(e)
    plan = distributed.share(plan, holder)
    if isinstance(plan, dict):
        _plan_fields(rec, {"plan": plan})
    else:
        log(f"elastic: no migration plan for the record ({plan})")
    olog.event("elastic_resize", **rec)
    log(f"elastic: moved {len(cur)} -> {len(target)} devices at iteration "
        f"{step} (slice {cur} -> {target}, re-search {research_s:.2f}s "
        f"[{(research or {}).get('mode')}], migration in_memory)")
    return new_model, carry, rec


def serve_resize(model, params, state, plan_machine, *, rebuild, step: int,
                 call: Optional[Sequence[int]] = None, olog=None,
                 log=print, objective: str = "latency"):
    """The serving autoscaler's resize (``flexflow_tpu/serve/engine.py:
    636-699``) on every rank of the running world, onto ``plan_machine``
    (``MachineModel.shrink``/``grow`` of the running machine): the gather
    of the live params and state, the call of the standing-by ranks
    ``call`` (first-world ranks, a grow), the world re-formed over the
    plan's members, rank 0's re-search under ``objective`` (``latency``;
    ``decode`` for a decode pool's engine, as JAX's ``_resize`` searches)
    warm-started from the running strategy and shared through the store,
    the rebuilt model on every rank and rank 0's scatter of the state
    (:func:`_relocate`).  Returns ``(new_model, carry, header)``, or None
    on a rank left out, which then stands by (:func:`stand_by`) until a
    grow calls it back (:func:`rejoin`) or the run ends
    (:func:`release_standbys`).  No fault or ``elastic_resize`` record:
    the engine writes its ``serve_resize``."""
    import types

    from flexflow_tpu_torch import distributed

    members = list(plan_machine.members)
    sig = types.SimpleNamespace(params=params, state=state, opt_state=None,
                                step=step, loss_base=0)
    msgs = None
    if call:
        msg = {"op": "grow", "members": members,
               "generation": distributed.generation() + 1, "step": step}
        msgs = {int(m): msg for m in call}
    return _relocate(model, sig, members, plan_machine, rebuild,
                     getattr(model.config, "strategies", None), None,
                     olog, log, None, call=msgs, objective=objective,
                     train=False)


# ---------------------------------------------------------------------------
# the lost rank's side


def stand_by(device) -> Dict:
    """A lost rank, out of every world, until the run calls it: poll the
    store for its call (``{"op": "grow", ...}`` or ``{"op": "done",
    ...}``), posting its card's probe between polls (what a grow after a
    real loss waits for).  Returns the call."""
    from flexflow_tpu_torch import distributed

    store = distributed.control_store()
    me = distributed.member()
    key = f"elastic/call/{me}"
    while True:
        if store.check([key]):
            msg = json.loads(store.get(key))
            store.delete_key(key)
            return msg
        try:
            _default_probe(device)
            ok = b"1"
        except Exception:
            ok = b"0"
        store.set(f"elastic/probe/{me}", ok)
        time.sleep(STANDBY_POLL_S)


def rejoin(cfg, msg: Dict, rebuild, device, olog=None, log=print,
           data=None, objective: str = "makespan", train: bool = True):
    """A standing-by rank called to grow: join the re-formed world the
    call names and land in it as every other rank (:func:`_land`, under
    ``objective`` and ``train``).  Returns ``(new_model, carry)``."""
    from flexflow_tpu_torch import distributed

    machine = distributed.reform(msg["members"], msg["generation"])
    log(f"elastic: called back at iteration {msg['step']}; rank "
        f"{machine.rank} of {machine.num_devices}")
    new_model, carry, _ = _land(cfg, machine, None, rebuild, None, None,
                                olog, log, data, objective=objective,
                                train=train)
    return new_model, carry


def release_standbys(members: Sequence[int], msg: Dict) -> None:
    """Rank 0's last word to the ranks standing by: ``msg`` (``op``
    ``"done"``), after which each returns from ``fit`` out of service."""
    from flexflow_tpu_torch import distributed

    store = distributed.control_store()
    if store is None:
        return
    for m in members:
        store.set(f"elastic/call/{m}", json.dumps(dict(msg, op="done")))


# ---------------------------------------------------------------------------
# preemption-aware graceful drain


def install_drain_handler(drain: Dict, log=print):
    """Install SIGTERM/SIGINT handlers that set ``drain["requested"]``
    (and ``drain["signum"]``) and return an idempotent, re-entrant
    restore callable: the drain path and the error path may both call
    it.  ``signal.signal`` works only on the main thread; elsewhere, or
    where the runtime forbids handlers, ``drain["installed"]`` stays
    False and :func:`request_drain` sets the flag directly."""
    drain.setdefault("requested", False)
    drain.setdefault("signum", None)
    drain["installed"] = False

    def _handler(signum, frame):
        if not drain["requested"]:
            drain["requested"] = True
            drain["signum"] = int(signum)
            try:
                name = signal.Signals(signum).name
            except ValueError:
                name = str(signum)
            log(f"elastic: {name} received — draining at the next "
                f"host-sync boundary")

    prev: Dict = {}
    try:
        for signum in (signal.SIGTERM, signal.SIGINT):
            prev[signum] = signal.signal(signum, _handler)
        drain["installed"] = True
    except (ValueError, OSError, RuntimeError):
        # not the main thread: undo what was installed, run flag-only
        for signum, old in prev.items():
            try:
                signal.signal(signum, old)
            except (ValueError, OSError, RuntimeError):
                pass
        prev = {}

    done = [False]
    lock = threading.Lock()

    def restore() -> bool:
        with lock:
            if done[0]:
                return False
            done[0] = True
        for signum, old in prev.items():
            try:
                signal.signal(signum, old)
            except (ValueError, OSError, RuntimeError):
                pass
        return True

    return restore


class drain_scope:
    """:func:`install_drain_handler` as a context manager::

        with drain_scope(log=log) as drain:
            ...  # the loop reads drain["requested"] at its boundaries

    It yields the drain dict and restores the previous handlers on every
    exit path (an early ``restore()`` is safe too)."""

    def __init__(self, log=print, drain: Optional[Dict] = None):
        self.drain: Dict = drain if drain is not None else {}
        self._log = log
        self._restore = None

    def __enter__(self) -> Dict:
        self._restore = install_drain_handler(self.drain, log=self._log)
        return self.drain

    def restore(self) -> bool:
        if self._restore is None:
            return False
        return self._restore()

    def __exit__(self, exc_type, exc, tb) -> bool:
        self.restore()
        return False


def request_drain(drain: Dict) -> None:
    """The injected ``preempt``: raise SIGTERM through the installed
    handler (the production path), or set the flag when none is
    installed."""
    if drain.get("installed"):
        signal.raise_signal(signal.SIGTERM)
    else:
        drain["requested"] = True
        drain["signum"] = int(signal.SIGTERM)
