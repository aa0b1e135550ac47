"""The serving executor: continuous-batching autoregressive decode (PyTorch
port of ``flexflow_tpu/serve/engine.py``, single-pool ``phase="full"``).

One :class:`ServeEngine` owns a live model and its params.  Requests join
the running ``(max_batch, seq)`` rectangle the step a slot frees; each
decode step runs ``FFModel.make_predict_step`` over the whole rectangle
and takes the greedy argmax of the causal log-probs at each sequence's
last position; EOS or the token budget frees the slot.  A KV cache
(serve/kv_cache.py) is filled from the step's own per-layer attention
inputs.

Time is VIRTUAL (serve/loadgen.py): the clock advances by ``step_time_s``
per decode step, so admission order, latencies and the summary are
deterministic under a seeded load and equal to the JAX package's for the
same requests.  Wall time is tracked separately, for information.

Two differences from the JAX engine, neither visible in the results:
each step copies to the host only the log-prob row at every active slot's
last position (a (n_active, vocab) block) instead of the whole
``(max_batch, seq, vocab)`` tensor — the argmax reads nothing else — and
the KV projections of the new positions are computed on the model's
device before the copy.

:meth:`ServeEngine.run_forward` is the CNN/NMT forward-only service:
padded fixed-shape batches (``batch.batch_requests``) through the
``DevicePrefetcher``, each request's reply its row of the loss op's
output.  A drain requested before the run leaves every request unserved,
as in the JAX engine; the port also reads the drain flag before each
batch, so that a drain requested mid-run stops admission there (the JAX
engine reads it at the start alone).

Autoscaling, resize and disaggregated prefill/decode pools come with
later slices; asking for them raises ``NotImplementedError``.

Obs records: ``serve_request`` (one per completed request, with
``ttft_s``/``tpot_s``), ``serve_batch`` (one per decode step or forward
batch, with KV occupancy) and ``serve_summary`` (one per run).  With
``metrics`` (an ``obs.metrics.MetricsExporter``) each completed request
feeds the latency and TTFT histograms, and the ``ff_qps``,
``ff_queue_depth``, ``ff_latency_p50_s``, ``ff_latency_p99_s``,
``ff_ttft_*``, ``ff_tpot_p50_s`` and ``ff_requests_total`` gauges are
rewritten after every decode step and at the summary.
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from flexflow_tpu_torch import obs
from flexflow_tpu_torch.serve.batcher import (ContinuousBatcher,
                                              RequestQueue, batch_requests)
from flexflow_tpu_torch.serve.kv_cache import KVCache, KVCacheLayout
from flexflow_tpu_torch.serve.loadgen import Request

# default virtual service time per decode step, used when the strategy
# artifact carries no predicted forward time
DEFAULT_STEP_TIME_S = 0.01


def _percentile(values: Sequence[float], q: float) -> float:
    if not values:
        return float("nan")
    return float(np.percentile(np.asarray(values, np.float64), q))


class ServeEngine:
    """Continuous-batching inference over one live FFModel.

    ``params`` is the model's parameter tree (default: ``model.init()``
    with the config's seed).  ``rebuild``, ``queue_hi``,
    ``idle_boundaries``, ``shrink_to`` (autoscaling) and a ``phase`` other
    than ``"full"`` are accepted for the JAX engine's signature and raise
    ``NotImplementedError``."""

    def __init__(self, model, rebuild=None, *, params=None, olog=None,
                 metrics=None, log=print, step_time_s: Optional[float] = None,
                 queue_hi: int = 0, idle_boundaries: int = 0,
                 shrink_to: int = 0, kv_window: Optional[int] = None,
                 pad_id: int = 0, phase: str = "full"):
        if phase != "full":
            raise NotImplementedError(
                f"serve phase {phase!r}: disaggregated prefill/decode "
                f"pools are not ported yet (phase='full' only)")
        if rebuild is not None or queue_hi or idle_boundaries or shrink_to:
            raise NotImplementedError(
                "serve autoscaling (rebuild / queue_hi / idle_boundaries / "
                "shrink_to) is not ported yet")
        self.model = model
        self.olog = olog if olog is not None else obs.NULL
        self.metrics = metrics
        self.log = log
        self.phase = phase
        self.kv_window = kv_window
        self.pad_id = int(pad_id)
        self.max_batch = int(model.config.batch_size)
        self.max_len = int(model._inputs[0].shape[1]) \
            if model._inputs[0].ndim >= 2 else 1
        self.step_time_s = float(step_time_s) if step_time_s else \
            self._predicted_step_time()
        self._sess: Optional[Dict] = None   # open start()/finish() session
        if params is None:
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
        t = (pred.get("serve") or {}).get("forward_step_s")
        return float(t) if t else DEFAULT_STEP_TIME_S

    def _attention_ops(self) -> List:
        from flexflow_tpu_torch.ops.attention import MultiHeadAttention

        return [op for op in self.model.layers
                if isinstance(op, MultiHeadAttention)]

    def _compile(self) -> None:
        """Build the predict step, the KV layout and the K/V projection
        weights used to fill the cache."""
        model = self.model
        self._attn_ops = self._attention_ops()
        loss_tid = model._loss_op().output.tid
        tids = (loss_tid,) + tuple(op.inputs[0].tid
                                   for op in self._attn_ops)
        self._predict = model.make_predict_step(output_tids=tids)
        self._kv_w = [(self.params[op.param_key]["wk"].float(),
                       self.params[op.param_key]["wv"].float())
                      for op in self._attn_ops]
        layout = KVCacheLayout.from_model(
            model, self.max_batch, self.kv_window,
            strategy=getattr(model.config, "strategies", None))
        self.kv_layout = layout
        self.kv_cache = KVCache(layout) if layout is not None else None
        self._kv_filled = [0] * self.max_batch

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
              drain: Optional[Dict] = None) -> None:
        """Open a decode session over ``requests``.  ``drain`` is a dict
        whose ``"requested"`` flag, once true, stops admission."""
        self._sess = {
            "t_wall0": time.perf_counter(),
            "queue": RequestQueue(requests),
            "batcher": ContinuousBatcher(self.max_batch, self.max_len),
            "vnow": 0.0, "steps": 0, "draining": False,
            "completed": [], "unserved": [],
            "extra": self._zero_extra_inputs(), "drain": drain,
            "done": False,
        }

    def step_once(self) -> bool:
        """One scheduling boundary of the open session: drain check,
        admission, then at most one decode step.  Returns True while work
        remains, False once the session is exhausted."""
        s = self._sess
        if s is None:
            raise RuntimeError("serve: no open session — call start() "
                               "before step_once()")
        if s["done"]:
            return False
        queue, batcher = s["queue"], s["batcher"]
        if not (queue.pending() or batcher.num_active()):
            s["done"] = True
            return False
        drain = s["drain"]
        if drain is not None and drain.get("requested") \
                and not s["draining"]:
            s["draining"] = True
            s["unserved"] = queue.drain()
            self.log(f"serve: drain requested — finishing "
                     f"{batcher.num_active()} in-flight request(s), "
                     f"{len(s['unserved'])} queued request(s) unserved")
        vnow = s["vnow"]
        admitted = [] if s["draining"] else batcher.admit(queue, vnow)
        depth = queue.depth(vnow)
        if batcher.num_active() == 0:
            nxt = queue.next_arrival()
            if nxt is None:
                s["done"] = True
                return False
            s["vnow"] = max(vnow, nxt)  # idle: jump to the next arrival
            return True

        # one decode step over the full rectangle
        active = batcher.active()
        pre_lengths = {i: sl.length for i, sl in active}
        tokens = batcher.token_matrix(self.pad_id)
        t0 = time.perf_counter()
        outs = self._predict(self.params, self.state, tokens, *s["extra"])
        rows = self._last_rows(outs[0], active)
        step_wall = time.perf_counter() - t0
        self._fill_kv(outs[1:], active, pre_lengths)
        done_v = vnow + self.step_time_s  # this step's tokens land here
        for j, (slot_idx, slot) in enumerate(active):
            nxt_tok = int(np.argmax(rows[j]))
            slot.req.wall_s += step_wall
            batcher.record_token(slot_idx, nxt_tok)
            if slot.generated == 1:
                slot.req.first_token_v = done_v
        s["vnow"] = vnow = done_v
        s["steps"] += 1
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
                pool="")
        self.olog.event("serve_batch", step=s["steps"], vnow=vnow,
                        active=len(active), admitted=len(admitted),
                        queue_depth=depth,
                        devices=self.model.machine.num_devices,
                        pool="", step_time_s=self.step_time_s,
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

    def _last_rows(self, logprobs, active) -> np.ndarray:
        """Each active slot's log-prob row at its last position, picked on
        the device and copied to the host as one (n_active, vocab) block."""
        dev = logprobs.device
        with torch.inference_mode():
            b = torch.tensor([i for i, _ in active], device=dev)
            p = torch.tensor([sl.length - 1 for _, sl in active], device=dev)
            return logprobs[b, p].cpu().numpy()

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

    def _fill_kv(self, attn_ins, active, pre_lengths) -> None:
        """Project this step's NEW positions into the KV cache from the
        captured per-layer attention inputs: the rows are gathered and
        projected on the device, and only K/V cross to the host."""
        if self.kv_cache is None:
            return
        spans = [(i, self._kv_filled[i], pre_lengths[i]) for i, _ in active
                 if pre_lengths[i] > self._kv_filled[i]]
        if spans:
            h, hd = self.kv_layout.num_heads, self.kv_layout.head_dim
            dev = attn_ins[0].device
            with torch.inference_mode():
                b = torch.tensor([i for i, lo, hi in spans
                                  for _ in range(lo, hi)], device=dev)
                p = torch.tensor([q for _, lo, hi in spans
                                  for q in range(lo, hi)], device=dev)
                for li, (wk, wv) in enumerate(self._kv_w):
                    x = attn_ins[li][b, p].float()          # (n, d)
                    k = (x @ wk).cpu().numpy().reshape(-1, h, hd)
                    v = (x @ wv).cpu().numpy().reshape(-1, h, hd)
                    off = 0
                    for slot_idx, lo, hi in spans:
                        n = hi - lo
                        self.kv_cache.write_span(li, slot_idx, lo,
                                                 k[off:off + n],
                                                 v[off:off + n])
                        off += n
        for slot_idx, _ in active:
            self._kv_filled[slot_idx] = pre_lengths[slot_idx]

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
        every request not yet served is reported unserved."""
        from collections import deque

        from flexflow_tpu_torch.data.prefetch import DevicePrefetcher

        t_wall0 = time.perf_counter()
        model = self.model
        in0 = model._inputs[0]
        sample_shape = tuple(in0.shape[1:])
        ordered = sorted(requests, key=lambda r: (r.arrival_v, r.rid))
        draining = drain is not None and bool(drain.get("requested"))
        queued = [] if draining else ordered
        meta: deque = deque()

        def arrays():
            for batch, members in batch_requests(
                    iter(queued), self.max_batch, pad_shape=sample_shape,
                    dtype=in0.dtype):
                meta.append(members)
                yield (batch,)

        predict = model.make_predict_step()
        extra = self._zero_extra_inputs()
        completed: List[Request] = []
        vnow = 0.0
        batches = 0
        with DevicePrefetcher(arrays(), model.device) as pf:
            for (batch,) in pf:
                members = meta.popleft()
                if drain is not None and drain.get("requested"):
                    draining = True
                    break
                vstart = max(vnow, max(r.arrival_v for r in members))
                t0 = time.perf_counter()
                out = predict(self.params, self.state, batch,
                              *extra)[0].float().cpu().numpy()
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
            "resizes": 0,
            "virtual_s": vnow,
            "wall_s": wall_s,
            "drained": bool(drained),
            "devices": self.model.machine.num_devices,
            "pool": "",
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
        722-756``, the single-pool series)."""
        if self.metrics is None:
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
