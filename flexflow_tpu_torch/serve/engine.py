"""The serving executor: continuous-batching autoregressive decode, the
queue-driven autoscaler and the disaggregated pools' phases (PyTorch port
of ``flexflow_tpu/serve/engine.py``).

One :class:`ServeEngine` owns a live model and its params.  Requests join
the running ``(max_batch, seq)`` rectangle the step a slot frees; each
decode step runs ``FFModel.make_predict_step`` over the whole rectangle
and takes the greedy argmax of the causal log-probs at each sequence's
last position; EOS or the token budget frees the slot.  A KV cache
(serve/kv_cache.py) is filled from the step's own per-layer attention
inputs.

Time is VIRTUAL (serve/loadgen.py): the clock advances by ``step_time_s``
per decode step, so admission order, latencies, watermark triggers and
the summary are deterministic under a seeded load and equal to the JAX
package's for the same requests.  Wall time is tracked separately.

Each step copies to the host only what the scheduler reads: the log-prob
row at every active slot's last position and the attention inputs of the
positions new to the KV cache, projected on the model's device, never
the whole ``(max_batch, seq, vocab)`` log-probs.  Over several ranks
(``torchrun``, ``distributed.initialize``) each rank holds blocks of
those values under the strategy; ``FFModel.gather_rows`` assembles just
those rows on every rank with one all-reduce, so every rank takes the
same tokens and every rank's scheduler makes the same decisions.

**Autoscaling** at the decode-step boundaries, with JAX's triggers: after
``idle_boundaries`` consecutive idle boundaries the world shrinks to
``shrink_to`` ranks, and a queue depth of ``queue_hi`` with ranks parked
grows it back (:meth:`_resize`, ``utils/elastic.serve_resize``: the live
params and state gathered, the world re-formed, a re-search under the
latency objective on rank 0 shared through the store, ``rebuild(config,
machine)`` on every rank, the state scattered; a decode pool's engine
re-searches under the ``decode`` objective).  A parked rank stands by
out of every world; a grow calls it back and rank 0 hands it the
scheduler session (queue, slots and their tokens, virtual clock, counts,
completed requests, resizes) over the new world; its KV cache restarts
empty, refilled by the next forward as after every resize.  Each resize
is one ``serve_resize`` record.  **Drain**: a SIGTERM flag stops
admission, the in-flight slots finish, never-admitted requests are
``unserved``; over several ranks the flag is agreed at each boundary
(an all-reduce MAX), so every rank stops admission at the same one.

**Disaggregation** (serve/router.py): a ``phase="prefill"`` engine hands
each request off after its first generated token with its exported KV
rows; a ``phase="decode"`` engine imports them and decodes the tail.  The
router drives the engines' open-ended sessions through :meth:`push`,
:meth:`advance_to`, :meth:`next_ready_v`, :meth:`take_handoffs`,
:meth:`crash`, :meth:`restart` and the rest.  An injected
``slow_replica`` stretches a decode step's virtual time.  A pooled engine
writes only its labeled ``ff_serve_pool_*`` gauges.  When the router runs
on every rank of a world (``serve/replicas.py``), each rank holds an
engine for every replica: the replica's ``seat`` says whether this rank
runs its model; where it does not, the engine keeps the scheduler's state
alone (no params, a KV ledger of lengths in place of the cache), and
after each step the replica's first rank broadcasts the step's tokens
(``ReplicaSeat.share``), so every rank's scheduler takes the same ones.

:meth:`ServeEngine.run_forward` is the CNN/NMT forward-only service:
padded fixed-shape batches (``batch.batch_requests``) through the
``DevicePrefetcher``, each request's reply its row of the loss op's
output.  Over several ranks each rank stages only its rows of each batch
(``FFModel.local_batch``) and the loss op's output is assembled on every
rank (``FFModel.gather_output``).  A drain requested before the run
leaves every request unserved, as in the JAX engine; the port also reads
the drain flag before each batch (agreed over the ranks), so that a drain
requested mid-run stops admission there on every rank.

Obs records: ``serve_request``, ``serve_batch`` (with KV occupancy),
``serve_resize`` and ``serve_summary``.  With ``metrics`` (an
``obs.metrics.MetricsExporter``) each completed request feeds the latency
and TTFT histograms, and the ``ff_qps``, ``ff_queue_depth``,
``ff_latency_p50_s``, ``ff_latency_p99_s``, ``ff_ttft_*``,
``ff_tpot_p50_s`` and ``ff_requests_total`` gauges are rewritten after
every decode step and at the summary.
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from flexflow_tpu_torch import obs
from flexflow_tpu_torch.serve.batcher import (ContinuousBatcher,
                                              RequestQueue, batch_requests)
from flexflow_tpu_torch.serve.kv_cache import (KVCache, KVCacheLayout,
                                               KVLedger)
from flexflow_tpu_torch.serve.loadgen import Request
from flexflow_tpu_torch.utils import faultinject

# default virtual service time per decode step, used when the strategy
# artifact carries no predicted forward time
DEFAULT_STEP_TIME_S = 0.01

# virtual slowdown an injected ``slow_replica`` fault applies to one
# decode step (a straggler, not a death: the hedged decode's adversary)
SLOW_REPLICA_FACTOR = 4.0

#: the session keys a grow hands a returning rank (all but its own drain
#: flag and wall-clock start)
_SESSION_SHARED = ("queue", "batcher", "vnow", "steps", "idle_streak",
                   "draining", "completed", "unserved", "extra", "done",
                   "open_ended", "handoffs")


def _percentile(values: Sequence[float], q: float) -> float:
    if not values:
        return float("nan")
    return float(np.percentile(np.asarray(values, np.float64), q))


class ServeEngine:
    """Continuous-batching inference over one live FFModel.

    ``params`` is the model's parameter tree, this rank's blocks over
    several ranks (default: ``model.init()`` with the config's seed).
    ``rebuild(config, machine)`` is the factory the elastic training path
    takes; without it autoscaling is off.  ``queue_hi`` /
    ``idle_boundaries`` / ``shrink_to`` are the watermarks (0 disables a
    trigger).  ``phase`` is ``"full"`` (one pool), ``"prefill"`` or
    ``"decode"`` (the router's pools); ``pool`` labels the records and
    gauges.  A decode engine that autoscales re-searches under the
    ``decode`` objective; its phase, pool label and step time stay across
    every resize.  ``seat`` (``serve/replicas.py``) places a routed
    replica in a world of ranks: where ``seat.runs`` is false this rank
    keeps the replica's schedule alone (no params, no forward)."""

    def __init__(self, model, rebuild=None, *, params=None, olog=None,
                 metrics=None, log=print, step_time_s: Optional[float] = None,
                 queue_hi: int = 0, idle_boundaries: int = 0,
                 shrink_to: int = 0, kv_window: Optional[int] = None,
                 pad_id: int = 0, phase: str = "full", pool: str = "",
                 seat=None):
        if phase not in ("full", "prefill", "decode"):
            raise ValueError(
                f"phase must be 'full', 'prefill' or 'decode', "
                f"got {phase!r}")
        self.model = model
        self.rebuild = rebuild
        self.olog = olog if olog is not None else obs.NULL
        self.metrics = metrics
        self.log = log
        self.phase = phase
        self.pool = pool or ("" if phase == "full" else phase)
        self.queue_hi = int(queue_hi)
        self.idle_boundaries = int(idle_boundaries)
        self.shrink_to = int(shrink_to)
        self.kv_window = kv_window
        self.pad_id = int(pad_id)
        self.max_batch = int(model.config.batch_size)
        self.max_len = int(model._inputs[0].shape[1]) \
            if model._inputs[0].ndim >= 2 else 1
        self.step_time_s = float(step_time_s) if step_time_s else \
            self._predicted_step_time()
        self.seat = seat
        self.runs = seat is None or seat.runs
        # forward steps taken and their wall seconds (the replica first
        # rank's, on the other ranks of a routed world), over the
        # engine's life
        self.forward_steps = 0
        self.busy_s = 0.0
        self.resizes: List[Dict] = []
        self._sess: Optional[Dict] = None   # open start()/finish() session
        # first-world ranks out of service after a shrink (JAX: device
        # objects)
        self._parked: List[int] = []
        # a returning rank's admitted slots at the grow that called it
        self._rejoined: Optional[List[int]] = None
        # parked when the run ended (its session then ended at the shrink)
        self.out_of_service = False
        if not self.runs:
            params, state = {}, {}
        elif params is None:
            params, state = model.init(model.config.seed)
        else:
            state = {}
        self.params, self.state = params, state
        self._compile()

    # ------------------------------------------------------------------
    # compilation / state

    def _predicted_step_time(self) -> float:
        pred = getattr(getattr(self.model.config, "strategies", None),
                       "predicted", None) or {}
        serve = pred.get("serve") or {}
        if self.phase != "full":
            # the per-phase searched block (serve.prefill / serve.decode)
            t = (serve.get(self.phase) or {}).get("step_time_s")
            if t:
                return float(t)
        t = serve.get("forward_step_s")
        return float(t) if t else DEFAULT_STEP_TIME_S

    def _attention_ops(self) -> List:
        from flexflow_tpu_torch.ops.attention import MultiHeadAttention

        return [op for op in self.model.layers
                if isinstance(op, MultiHeadAttention)]

    def _compile(self) -> None:
        """(Re)build the predict step, the KV layout and the whole K/V
        projection weights used to fill the cache, for the CURRENT model
        (at init and after every resize; the cache restarts empty).  Over
        several ranks every rank takes part in one gather of those
        weights (``FFModel.gather_trees``).  A rank that does not run the
        replica keeps a :class:`KVLedger` of the layout."""
        model = self.model
        layout = KVCacheLayout.from_model(
            model, self.max_batch, self.kv_window,
            strategy=getattr(model.config, "strategies", None))
        self.kv_layout = layout
        self._kv_filled = [0] * self.max_batch
        if not self.runs:
            self.kv_cache = KVLedger(layout) if layout is not None else None
            return
        self._attn_ops = self._attention_ops()
        self._loss_tid = model._loss_op().output.tid
        self._tids = (self._loss_tid,) + tuple(op.inputs[0].tid
                                               for op in self._attn_ops)
        self._predict = model.make_predict_step(output_tids=self._tids)
        kv = {op.param_key: {k: v for k, v in
                             self.params.get(op.param_key, {}).items()
                             if k in ("wk", "wv")}
              for op in self._attn_ops}
        if model.sharded:
            kv, _, _ = model.gather_trees(
                {k: v for k, v in kv.items() if v}, {}, None, dst=None)
        self._kv_w = [(kv[op.param_key]["wk"].to(model.device).float(),
                       kv[op.param_key]["wv"].to(model.device).float())
                      for op in self._attn_ops]
        self.kv_cache = KVCache(layout) if layout is not None else None

    def _zero_extra_inputs(self) -> List[np.ndarray]:
        """Zero arrays for every model input past the first (the
        transformer's ``labels`` feed, which serving never reads)."""
        return [np.zeros(t.shape, t.dtype) for t in self.model._inputs[1:]]

    # ------------------------------------------------------------------
    # decode service

    def run(self, requests: Sequence[Request],
            drain: Optional[Dict] = None) -> Dict:
        """Serve ``requests`` to completion (or drain) and return the
        summary dict (also emitted as the ``serve_summary`` record):
        :meth:`start`, :meth:`step_once` to exhaustion, :meth:`finish`."""
        self.start(requests, drain=drain)
        while self.step_once():
            pass
        return self.finish()

    def start(self, requests: Sequence[Request],
              drain: Optional[Dict] = None,
              open_ended: bool = False) -> None:
        """Open a decode session over ``requests``.  ``drain`` is a dict
        whose ``"requested"`` flag, once true, stops admission.  An
        ``open_ended`` session never closes itself on an empty queue: the
        router feeds it through :meth:`push` and decides when it ends."""
        self._sess = {
            "t_wall0": time.perf_counter(),
            "queue": RequestQueue(requests),
            "batcher": ContinuousBatcher(self.max_batch, self.max_len),
            "vnow": 0.0, "steps": 0, "idle_streak": 0,
            "draining": False, "completed": [], "unserved": [],
            "extra": self._zero_extra_inputs(), "drain": drain,
            "done": False, "open_ended": bool(open_ended),
            "handoffs": [],
        }

    # -- the router's session surface (serve/router.py) ----------------

    def push(self, req: Request) -> None:
        """Feed one more request into the open session's queue."""
        s = self._sess
        if s is None:
            raise RuntimeError("serve: no open session — call start() "
                               "before push()")
        s["queue"].push(req)

    def advance_to(self, v: float) -> None:
        """Advance the session's virtual clock to ``v`` (never back)."""
        s = self._sess
        if s is not None and v > s["vnow"]:
            s["vnow"] = float(v)

    def session_vnow(self) -> Optional[float]:
        """The open session's virtual now (None when none is open)."""
        s = self._sess
        return float(s["vnow"]) if s is not None else None

    def crash(self) -> Dict:
        """Kill the open session in place (the injected
        ``replica_crash``): in-flight requests leave carrying every token
        generated so far and no KV rows, queued ones with their payloads
        intact, and the pre-crash completions and step count go to the
        router.  Revival is a fresh :meth:`start`."""
        s = self._sess
        if s is None:
            raise RuntimeError("serve: no open session to crash")
        batcher = s["batcher"]
        in_flight: List[Request] = []
        for slot_idx, slot in list(batcher.active()):
            req = slot.req
            req.carried_tokens = slot.tokens[len(req.tokens):]
            req.kv_payload = None  # the imported rows died with the card
            batcher.release(slot_idx)
            in_flight.append(req)
        queued = s["queue"].drain()
        out = {"in_flight": in_flight, "queued": queued,
               "completed": list(s["completed"]),
               "steps": int(s["steps"]), "vnow": float(s["vnow"])}
        if self.kv_cache is not None:
            for i in range(self.max_batch):
                self.kv_cache.reclaim(i)
        self._kv_filled = [0] * self.max_batch
        self._sess = None
        return out

    def restart(self) -> None:
        """A crashed replica's restart (the router's revival, before a
        fresh :meth:`start`): the predict step rebuilt on the replica's
        ranks from the params it holds, and an empty KV cache (or
        ledger) of its layout."""
        if self.runs:
            self._predict = self.model.make_predict_step(
                output_tids=self._tids)
        if self.kv_cache is not None:
            self.kv_cache = type(self.kv_cache)(self.kv_layout)
        self._kv_filled = [0] * self.max_batch

    def next_ready_v(self) -> Optional[float]:
        """The earliest virtual instant this session can work: its now
        while slots are in flight, the next queued (effective) arrival
        while idle, None when it has nothing."""
        s = self._sess
        if s is None:
            return None
        if s["batcher"].num_active():
            return float(s["vnow"])
        nxt = s["queue"].next_arrival()
        if nxt is None:
            return None
        return float(max(s["vnow"], nxt))

    def take_handoffs(self) -> List[Request]:
        """Pop the requests this (prefill) session handed off since the
        last call, each with ``carried_tokens`` and ``kv_payload``."""
        s = self._sess
        if s is None:
            return []
        out = s["handoffs"]
        s["handoffs"] = []
        return out

    def load(self) -> int:
        """Queued + in-flight work: the router's least-loaded signal."""
        s = self._sess
        if s is None:
            return 0
        return int(s["queue"].pending()) + int(s["batcher"].num_active())

    def drain_queue(self) -> List[Request]:
        """Remove and return every still-queued request."""
        s = self._sess
        return s["queue"].drain() if s is not None else []

    def session_completed(self) -> List[Request]:
        """The open session's completed requests so far."""
        s = self._sess
        return list(s["completed"]) if s is not None else []

    def pending(self) -> bool:
        """Work remains in the open session (queued or in flight)."""
        s = self._sess
        if s is None or s["done"]:
            return False
        return bool(s["queue"].pending() or s["batcher"].num_active())

    def queue_depth(self) -> int:
        """Arrived-but-unadmitted depth at the session's virtual now."""
        s = self._sess
        return int(s["queue"].depth(s["vnow"])) if s is not None else 0

    def session_steps(self) -> int:
        """Decode steps taken by the open session (0 when none is open)."""
        s = self._sess
        return int(s["steps"]) if s is not None else 0

    # -- the scheduling boundary -----------------------------------------

    def step_once(self) -> bool:
        """One scheduling boundary of the open session: drain check,
        admission, watermark triggers, then at most one decode step.
        Returns True while work remains, False once the session is
        exhausted."""
        s = self._sess
        if s is None:
            raise RuntimeError("serve: no open session — call start() "
                               "before step_once()")
        if s["done"]:
            return False
        queue, batcher = s["queue"], s["batcher"]
        if not (queue.pending() or batcher.num_active()):
            if not s["open_ended"]:
                s["done"] = True
            return False
        drain = s["drain"]
        if drain is not None and self._agreed(drain.get("requested")) \
                and not s["draining"]:
            s["draining"] = True
            s["unserved"] = queue.drain()
            self.log(f"serve: drain requested — finishing "
                     f"{batcher.num_active()} in-flight request(s), "
                     f"{len(s['unserved'])} queued request(s) unserved")
        vnow = s["vnow"]
        admitted = [] if s["draining"] else batcher.admit(queue, vnow)
        if self.phase == "decode" and self.kv_cache is not None:
            # a handed-off request brings its prefill pool's KV rows:
            # import them under this layout's ring, so that the forward
            # fills only the positions generated here
            for slot_idx in admitted:
                slot = batcher.slots[slot_idx]
                if slot is not None and slot.req.kv_payload is not None:
                    self._kv_filled[slot_idx] = \
                        self.kv_cache.import_request(slot_idx,
                                                     slot.req.kv_payload)
                    slot.req.kv_payload = None
        depth = queue.depth(vnow)
        if (self.queue_hi > 0 and depth >= self.queue_hi
                and self._parked and not s["draining"]):
            self._resize("grow", s["steps"], vnow, depth,
                         s["idle_streak"], admitted=admitted)
            return self._after_grow(admitted)
        return self._boundary(admitted, depth)

    def _after_grow(self, admitted: List[int]) -> bool:
        """The rest of a boundary at which the world grew: the regrown
        world serves the backlog from this step (a returning rank enters
        here with rank 0's session)."""
        s = self._sess
        admitted = list(admitted) + s["batcher"].admit(s["queue"],
                                                       s["vnow"])
        return self._boundary(admitted, s["queue"].depth(s["vnow"]))

    def _boundary(self, admitted: List[int], depth: int) -> bool:
        """The idle branch (with the shrink trigger) or one decode step."""
        s = self._sess
        queue, batcher = s["queue"], s["batcher"]
        vnow = s["vnow"]
        if batcher.num_active() == 0:
            nxt = queue.next_arrival()
            if nxt is None:
                if not s["open_ended"]:
                    s["done"] = True
                return False  # drained queue, no in-flight work
            # idle boundary: no work until the next arrival
            s["idle_streak"] += 1
            if (self.idle_boundaries > 0
                    and s["idle_streak"] >= self.idle_boundaries
                    and not self._parked and not s["draining"]):
                self._resize("shrink", s["steps"], vnow, depth,
                             s["idle_streak"])
                if self._rejoined is not None:
                    # parked at this shrink, called back at a later grow:
                    # carry on from that boundary in rank 0's session
                    admitted, self._rejoined = self._rejoined, None
                    return self._after_grow(admitted)
                if s["done"]:
                    return False   # parked until the run ended
            if (self.idle_boundaries <= 0
                    or s["idle_streak"] > self.idle_boundaries):
                s["vnow"] = max(vnow, nxt)  # nothing left to trigger
            else:
                s["vnow"] = min(vnow + self.step_time_s, nxt)
            return True
        s["idle_streak"] = 0

        # one decode step over the full rectangle
        active = batcher.active()
        pre_lengths = {i: sl.length for i, sl in active}
        spans = [(i, self._kv_filled[i], pre_lengths[i]) for i, _ in active
                 if pre_lengths[i] > self._kv_filled[i]]
        toks, xs, step_wall = None, None, 0.0
        if self.runs:
            batch = (batcher.token_matrix(self.pad_id), *s["extra"])
            if self.model.sharded:
                batch = self.model.local_batch(*batch)
            t0 = time.perf_counter()
            outs = self._predict(self.params, self.state, *batch)
            rows, xs = self._read_rows(outs, active, spans)
            step_wall = time.perf_counter() - t0
            toks = [int(np.argmax(r)) for r in rows]
        if self.seat is not None:
            # the replica's first rank's tokens and wall, on every rank
            toks, step_wall = self.seat.share(toks, step_wall, len(active))
        self.forward_steps += 1
        self.busy_s += step_wall
        self._fill_kv(xs, spans)
        for slot_idx, _ in active:
            self._kv_filled[slot_idx] = pre_lengths[slot_idx]
        step_s = self.step_time_s
        if self.phase == "decode":
            # an injected straggler stretches this step's virtual time
            # (host-side only: inert with no injector armed)
            inj = faultinject.get()
            if inj.enabled and inj.fire("slow_replica", site=self.pool):
                step_s *= SLOW_REPLICA_FACTOR
        done_v = vnow + step_s  # this step's tokens land here
        for j, (slot_idx, slot) in enumerate(active):
            nxt_tok = toks[j]
            slot.req.wall_s += step_wall
            batcher.record_token(slot_idx, nxt_tok)
            if slot.generated == 1:
                # the request's FIRST token (a handed-off request enters
                # the decode pool with generated >= 1: the prefill pool's
                # stamp stands)
                slot.req.first_token_v = done_v
        s["vnow"] = vnow = done_v
        s["steps"] += 1
        if self.phase == "prefill":
            # the prompt pass is done: every still-running slot leaves
            # with its generated token(s) and exported KV rows for a
            # decode replica (a finished one is reclaimed below)
            for slot_idx, slot in active:
                if slot.done:
                    continue
                req = slot.req
                req.carried_tokens = slot.tokens[len(req.tokens):]
                if self.kv_cache is not None:
                    req.kv_payload = self.kv_cache.export_request(slot_idx)
                    self.kv_cache.reclaim(slot_idx)
                self._kv_filled[slot_idx] = 0
                batcher.release(slot_idx)
                s["handoffs"].append(req)
        for slot_idx, req in batcher.reclaim(vnow):
            if self.kv_cache is not None:
                self.kv_cache.reclaim(slot_idx)
            self._kv_filled[slot_idx] = 0
            s["completed"].append(req)
            self._observe_request(req)
            self.olog.event(
                "serve_request", rid=req.rid, arrival_v=req.arrival_v,
                admit_v=req.admit_v, first_token_v=req.first_token_v,
                done_v=req.done_v, latency_s=req.latency_s,
                ttft_s=req.ttft_s, tpot_s=req.tpot_s,
                prompt_len=len(req.tokens),
                new_tokens=len(req.reply or ()), wall_s=req.wall_s,
                pool=self.pool)
        self.olog.event("serve_batch", step=s["steps"], vnow=vnow,
                        active=len(active), admitted=len(admitted),
                        queue_depth=depth,
                        devices=self.model.machine.num_devices,
                        pool=self.pool, step_time_s=self.step_time_s,
                        **self._kv_occupancy())
        self._update_gauges(s["completed"], depth, vnow)
        return True

    def finish(self) -> Dict:
        """Close the session: emit ``serve_summary`` and return it.
        Closing is one-shot."""
        s = self._sess
        if s is None:
            raise RuntimeError("serve: no open session — start() was "
                               "never called or finish() already ran")
        self._sess = None
        return self._summarize(s["completed"], s["unserved"], s["vnow"],
                               s["steps"],
                               time.perf_counter() - s["t_wall0"],
                               drained=s["draining"])

    def _agreed(self, flag) -> bool:
        """``flag`` agreed over the world's ranks (any rank's true makes
        it true on all: an all-reduce MAX); the flag itself on one."""
        machine = self.model.machine
        group = machine.world_group() if machine.distributed else None
        if group is None or group.handle is None:
            return bool(flag)
        from flexflow_tpu_torch import distributed

        return distributed.agreed(flag, self.model.device, group.handle)

    def _read_rows(self, outs, active, spans):
        """``(rows, xs)``: each active slot's log-prob row at its last
        position, on the host as one ``(n_active, vocab)`` array, and per
        attention layer the input rows of the positions ``spans`` add to
        the cache, on the device.  Over several ranks both come from one
        all-reduce of exactly these rows (``FFModel.gather_rows``)."""
        last = [(i, sl.length - 1) for i, sl in active]
        new = [(i, q) for i, lo, hi in spans for q in range(lo, hi)]
        want_kv = bool(new) and self.kv_cache is not None
        if self.model.sharded:
            picks = [(self._loss_tid, last)]
            if want_kv:
                picks += [(tid, new) for tid in self._tids[1:]]
            got = self.model.gather_rows(dict(zip(self._tids, outs)),
                                         picks)
            return got[0].cpu().numpy(), got[1:]
        dev = outs[0].device
        with torch.inference_mode():
            b, p = (torch.tensor(c, device=dev) for c in zip(*last))
            rows = outs[0][b, p].float().cpu().numpy()
            xs = []
            if want_kv:
                b, p = (torch.tensor(c, device=dev) for c in zip(*new))
                xs = [x[b, p].float() for x in outs[1:]]
        return rows, xs

    def _kv_occupancy(self) -> Dict:
        """Filled token positions and the fraction of the cache's
        ``(max_batch, max_seq)`` capacity they use."""
        if self.kv_layout is None:
            return {"kv_tokens": 0, "kv_frac": 0.0}
        ms = self.kv_layout.max_seq
        toks = sum(min(n, ms) for n in self._kv_filled)
        cap = self.max_batch * ms
        return {"kv_tokens": int(toks),
                "kv_frac": (toks / cap) if cap else 0.0}

    def _fill_kv(self, xs, spans) -> None:
        """Project this step's NEW positions into the KV cache: ``xs``
        holds each layer's attention-input rows of ``spans`` in order;
        they are projected on the device and only K/V cross to the
        host.  A rank that does not run the replica (``xs`` None) marks
        the spans in its ledger."""
        if self.kv_cache is None:
            return
        if xs is None:
            for slot_idx, _, hi in spans:
                self.kv_cache.fill(slot_idx, hi)
            return
        if not xs:
            return
        h, hd = self.kv_layout.num_heads, self.kv_layout.head_dim
        with torch.inference_mode():
            for li, (wk, wv) in enumerate(self._kv_w):
                x = xs[li]
                k = (x @ wk).cpu().numpy().reshape(-1, h, hd)
                v = (x @ wv).cpu().numpy().reshape(-1, h, hd)
                off = 0
                for slot_idx, lo, hi in spans:
                    n = hi - lo
                    self.kv_cache.write_span(li, slot_idx, lo,
                                             k[off:off + n], v[off:off + n])
                    off += n

    # ------------------------------------------------------------------
    # forward-only service (CNN / NMT)

    def run_forward(self, requests: Sequence[Request],
                    drain: Optional[Dict] = None) -> Dict:
        """Batched forward-only service (``flexflow_tpu/serve/engine.py:
        560-634``): the requests in arrival order, padded into
        ``(max_batch,) + sample`` batches staged on the device by a
        ``DevicePrefetcher``; each reply is the request's row of the loss
        op's output.  The request metadata stays on the host in FIFO
        order.  The virtual clock advances ``step_time_s`` a batch, and a
        reply is its request's first and only token (TTFT = latency).
        ``drain["requested"]`` stops admission before the next batch:
        every request not yet served is reported unserved.  Over several
        ranks each rank stages its rows of each batch, the output is
        assembled on every rank (``FFModel.gather_output``) and the drain
        flag is agreed before each batch, so that every rank stops at the
        same one."""
        from collections import deque

        from flexflow_tpu_torch.data.prefetch import DevicePrefetcher

        t_wall0 = time.perf_counter()
        model = self.model
        in0 = model._inputs[0]
        sample_shape = tuple(in0.shape[1:])
        ordered = sorted(requests, key=lambda r: (r.arrival_v, r.rid))

        def requested() -> bool:
            return drain is not None and self._agreed(drain.get("requested"))

        draining = requested()
        queued = [] if draining else ordered
        meta: deque = deque()
        extra = self._zero_extra_inputs()
        if model.sharded:
            extra = list(model.local_batch(*extra))

        def arrays():
            for batch, members in batch_requests(
                    iter(queued), self.max_batch, pad_shape=sample_shape,
                    dtype=in0.dtype):
                meta.append(members)
                # this rank's rows of the batch, the layout the model's
                # inputs arrive in
                yield model.local_batch(batch) if model.sharded \
                    else (batch,)

        tid = model._loss_op().output.tid
        predict = model.make_predict_step()
        completed: List[Request] = []
        vnow = 0.0
        batches = 0
        with DevicePrefetcher(arrays(), model.device) as pf:
            for (batch,) in pf:
                members = meta.popleft()
                if requested():
                    draining = True
                    break
                vstart = max(vnow, max(r.arrival_v for r in members))
                t0 = time.perf_counter()
                out = predict(self.params, self.state, batch, *extra)[0]
                if model.sharded:
                    out = model.gather_output({tid: out}, tid)
                out = out.float().cpu().numpy()
                wall = time.perf_counter() - t0
                vnow = vstart + self.step_time_s
                batches += 1
                for i, req in enumerate(members):
                    req.admit_v = vstart
                    req.first_token_v = vnow
                    req.done_v = vnow
                    req.wall_s = wall
                    req.reply = out[i]
                    completed.append(req)
                    self._observe_request(req)
                    tokens = np.asarray(req.tokens)
                    self.olog.event(
                        "serve_request", rid=req.rid,
                        arrival_v=req.arrival_v, admit_v=req.admit_v,
                        first_token_v=req.first_token_v,
                        done_v=req.done_v, latency_s=req.latency_s,
                        ttft_s=req.ttft_s, tpot_s=req.tpot_s,
                        prompt_len=int(tokens.shape[0])
                        if tokens.ndim else 0,
                        new_tokens=0, wall_s=wall)
                self.olog.event("serve_batch", step=batches, vnow=vnow,
                                active=len(members), admitted=len(members),
                                queue_depth=0,
                                devices=model.machine.num_devices,
                                kv_tokens=0, kv_frac=0.0)
                if batches == 1:
                    self.log(f"serve: forward service running "
                             f"({len(ordered)} requests, batches of "
                             f"{self.max_batch})")
        served = {id(r) for r in completed}
        unserved = [r for r in ordered if id(r) not in served]
        if draining:
            self.log(f"serve: drain requested — {len(completed)} "
                     f"request(s) served, {len(unserved)} unserved")
        return self._summarize(completed, unserved, vnow, batches,
                               time.perf_counter() - t_wall0,
                               drained=bool(unserved))

    # ------------------------------------------------------------------
    # autoscaling

    @property
    def objective(self) -> str:
        """The objective a resize re-searches under: ``decode`` for a
        decode pool's engine, else ``latency`` (``flexflow_tpu/serve/
        engine.py:676``)."""
        return "decode" if self.phase == "decode" else "latency"

    def _resize(self, direction: str, step: int, vnow: float,
                depth: int, idle_streak: int,
                admitted: Sequence[int] = ()) -> None:
        """One autoscale event on every rank of the running world
        (``flexflow_tpu/serve/engine.py:636-699``): the world shrinks to
        ``shrink_to`` ranks or grows back over the parked ones through
        ``utils/elastic.serve_resize`` (gather, re-formed world, a
        re-search under :attr:`objective` on rank 0, rebuild,
        scatter), the predict step is rebuilt and the KV cache restarts
        empty.  A rank the shrink leaves out stands by
        (:meth:`_stand_by`); at a grow rank 0 hands the returning ranks
        its session (:meth:`_share_session`, with ``admitted``, this
        boundary's admissions so far, and this resize's record, timed
        through the rebuilt predict step)."""
        from flexflow_tpu_torch.utils import elastic

        if self.rebuild is None:
            return
        t0 = time.perf_counter()
        model = self.model
        machine = model.machine
        n_old = machine.num_devices
        call = None
        if direction == "shrink":
            target = self.shrink_to
            min_devices = max(int(getattr(model.config, "min_devices", 1)
                                  or 1), 1)
            if not (min_devices <= target < n_old):
                return
            if self.max_batch % target:
                return  # the batch rectangle must divide the new world
            plan = machine.shrink(range(target))
            parked = machine.devices_at(range(target, n_old))
        else:
            if not self._parked:
                return
            plan = machine.grow(self._parked)
            call, parked = list(self._parked), []
        moved = elastic.serve_resize(
            model, self.params, self.state, plan, rebuild=self.rebuild,
            step=step, call=call, olog=self.olog, log=self.log,
            objective=self.objective)
        if moved is None:
            self._stand_by()
            return
        new_model, carry, head = moved
        self.model = new_model
        self.params, self.state = carry["params"], carry["state"]
        self._parked = parked
        n_new = new_model.machine.num_devices
        rec = {
            "direction": direction, "from_devices": n_old,
            "to_devices": n_new, "step": step, "vnow": vnow,
            "queue_depth": depth, "idle_streak": idle_streak,
            "research_s": head["research_s"], "research": head["research"],
        }
        self._compile()
        rec["total_s"] = time.perf_counter() - t0
        if call:
            self._share_session(admitted, rec)
        self.resizes.append(rec)
        self.olog.event("serve_resize", **rec)
        self.log(f"serve: {direction} {n_old} -> {n_new} devices at step "
                 f"{step} (queue depth {depth}, idle streak "
                 f"{idle_streak}, re-search {head['research_s']:.2f}s "
                 f"[{(head['research'] or {}).get('mode')}])")

    def _share_session(self, admitted=None, rec=None) -> Optional[Dict]:
        """At a grow, over the new world: rank 0 broadcasts its session
        (all but each rank's own drain flag and wall clock), the resizes
        so far with this one, and ``admitted``; a returning rank adopts
        them, the others keep their own.  Returns what was received."""
        import torch.distributed as dist

        s = self._sess
        box = [None]
        if self.model.machine.rank == 0:
            box = [{"sess": {k: s[k] for k in _SESSION_SHARED},
                    "resizes": self.resizes + [rec],
                    "admitted": list(admitted)}]
        dist.broadcast_object_list(box, src=0)
        return box[0]

    def _stand_by(self) -> None:
        """A rank the shrink left out: out of every world until rank 0
        calls it back at a grow (then it lands in the new world, adopts
        rank 0's session and resumes at that boundary) or releases it at
        the end of the run (then its session ends)."""
        from flexflow_tpu_torch.utils import elastic

        model = self.model
        self.log(f"serve: this rank is parked from step "
                 f"{self._sess['steps']}; standing by")
        msg = elastic.stand_by(model.device)
        if msg["op"] != "grow":
            self._sess["done"] = True
            self.out_of_service = True
            return
        new_model, carry = elastic.rejoin(model.config, msg, self.rebuild,
                                          model.device, log=self.log,
                                          objective=self.objective,
                                          train=False)
        self.model = new_model
        self.params, self.state = carry["params"], carry["state"]
        self._parked = []
        self._compile()
        got = self._share_session()
        mine = self._sess
        self._sess = dict(got["sess"], drain=mine["drain"],
                          t_wall0=mine["t_wall0"])
        self.resizes = got["resizes"]
        self._rejoined = got["admitted"]

    def adopt_resize(self, new_model, carry: Dict,
                     parked: Sequence = ()) -> None:
        """Adopt a resize made outside the engine (a coordinator's
        ``utils/elastic.directed_resize``): the rebuilt model and its
        placed state, a new predict step and an empty KV cache of the new
        layout; the next step refills the in-flight slots' prefixes.  The
        engine's own watermarks must be off (``queue_hi=0``,
        ``idle_boundaries=0``)."""
        self.model = new_model
        self._parked = list(parked)
        self.params = carry["params"]
        self.state = carry["state"]
        self._compile()

    # ------------------------------------------------------------------
    # reporting

    def _summarize(self, completed, unserved, vnow, steps, wall_s,
                   drained=False) -> Dict:
        lat = [r.latency_s for r in completed if r.latency_s is not None]
        ttft = [r.ttft_s for r in completed if r.ttft_s is not None]
        tpot = [r.tpot_s for r in completed if r.tpot_s is not None]
        summary = {
            "requests": len(completed) + len(unserved),
            "completed": len(completed),
            "unserved": len(unserved),
            "dropped": 0,
            "qps": (len(completed) / vnow) if vnow > 0 else 0.0,
            "p50_s": _percentile(lat, 50),
            "p99_s": _percentile(lat, 99),
            "ttft_p50_s": _percentile(ttft, 50),
            "ttft_p99_s": _percentile(ttft, 99),
            "tpot_p50_s": _percentile(tpot, 50),
            "tpot_p99_s": _percentile(tpot, 99),
            "steps": steps,
            "resizes": len(self.resizes),
            "virtual_s": vnow,
            "wall_s": wall_s,
            "drained": bool(drained),
            "devices": self.model.machine.num_devices,
            "pool": self.pool,
        }
        self.olog.event("serve_summary", **summary)
        self._update_gauges(completed, 0, vnow)
        return summary

    def _observe_request(self, req: Request) -> None:
        """Feed one completed request into the latency and TTFT
        histograms (``obs/metrics.py``'s fixed buckets)."""
        if self.metrics is None:
            return
        if req.latency_s is not None:
            self.metrics.observe("request_latency_s", req.latency_s)
        if req.ttft_s is not None:
            self.metrics.observe("request_ttft_s", req.ttft_s)

    def _update_gauges(self, completed, depth, vnow) -> None:
        """Rewrite the serving gauges (``flexflow_tpu/serve/engine.py:
        722-756``).  A pooled engine writes only its labeled series
        (``ff_serve_pool_*{pool=...}``); the router writes the
        aggregate."""
        if self.metrics is None:
            return
        if self.pool:
            labels = {"pool": self.pool}
            s = self._sess
            self.metrics.update_labeled(
                "serve_pool_queue_depth", labels, depth)
            self.metrics.update_labeled(
                "serve_pool_active_slots", labels,
                s["batcher"].num_active() if s is not None else 0)
            self.metrics.update_labeled(
                "serve_pool_step_time_s", labels, self.step_time_s)
            self.metrics.update_labeled(
                "serve_pool_requests_total", labels, len(completed))
            self.metrics.write()
            return
        lat = [r.latency_s for r in completed if r.latency_s is not None]
        ttft = [r.ttft_s for r in completed if r.ttft_s is not None]
        tpot = [r.tpot_s for r in completed if r.tpot_s is not None]
        self.metrics.update(
            qps=(len(completed) / vnow) if vnow > 0 else 0.0,
            queue_depth=depth,
            latency_p50_s=_percentile(lat, 50) if lat else None,
            latency_p99_s=_percentile(lat, 99) if lat else None,
            ttft_p50_s=_percentile(ttft, 50) if ttft else None,
            ttft_p99_s=_percentile(ttft, 99) if ttft else None,
            tpot_p50_s=_percentile(tpot, 50) if tpot else None,
            requests_total=len(completed))
        self.metrics.write()
