"""The fleet's arbiter: placement as search (PyTorch port of
``flexflow_tpu/fleet/arbiter.py``).

Every (job, slice size) pair is priced by the job's objective on a
virtual slice of that size through the port's native simulator
(``sim.search.price_on_slice``: a warm-started, budget-capped re-search;
``makespan`` for training, ``latency`` for serving, ``decode`` for a
decode pool), at ``HopperChipPerf``'s peaks.  Where the simulator is not
available the deterministic data-parallel proxy prices instead, and the
arbiter logs which pricer ran (``native_prices`` / ``proxy_prices``,
and a ``fleet: native pricing unavailable ...`` line per proxy price).
:meth:`Arbiter.pack` is an exact grouped-knapsack DP over the
work-conserving (Pareto-maximal) packings, minimizing weighted predicted
cost with a churn tie-break; :meth:`Arbiter.assign_ordinals` turns sizes
into pool ordinals, keeping every running job anchored on its slice.
The packing is pure Python and deterministic, so every rank of a world
that runs the coordinator computes the same one.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple


class Arbiter:
    """Prices (job, slice-size) pairs and packs jobs onto the pool.

    ``pricer`` overrides the cost function (tests inject stubs); the
    default tries the native simulator and falls back to the DP proxy.
    ``budget_s`` caps each native pricing re-search; ``iters`` bounds
    its proposals so a fixed seed is deterministic even when the budget
    never binds."""

    def __init__(self, pool_size: int, *, pricer=None,
                 budget_s: float = 30.0, iters: int = 200,
                 seed: int = 0, olog=None, log=print):
        from flexflow_tpu_torch import obs

        self.pool_size = int(pool_size)
        self.pricer = pricer
        self.budget_s = float(budget_s)
        self.iters = int(iters)
        self.seed = int(seed)
        self.olog = olog if olog is not None else obs.NULL
        self.log = log
        self._price_cache: Dict[Tuple[str, int], float] = {}
        self._strategy_cache: Dict[Tuple[str, int], object] = {}
        self.native_prices = 0
        self.proxy_prices = 0
        #: why the native pricer fell back to the proxy, per proxy price
        self.pricer_errors: List[str] = []

    # ------------------------------------------------------------------
    # pricing

    def price(self, job, size: int) -> float:
        """Predicted per-step cost of ``job`` on a ``size``-device slice
        (seconds under the native simulator, dimensionless under the
        proxy — only relative order within one pricer matters)."""
        key = (job.spec.job_id, int(size))
        if key in self._price_cache:
            return self._price_cache[key]
        if self.pricer is not None:
            cost = float(self.pricer(job, size))
        else:
            cost = self._price_native(job, size)
        self._price_cache[key] = cost
        return cost

    @staticmethod
    def _objective_for(spec) -> str:
        """The simulator objective a job's slice is priced under:
        decode-pool serve jobs price the single-token step (decode),
        other serve jobs (single-pool or prefill pool) the forward pass
        (latency), train jobs the full step (makespan)."""
        if spec.kind != "serve":
            return "makespan"
        return "decode" if spec.serve_phase == "decode" else "latency"

    def _price_native(self, job, size: int) -> float:
        from flexflow_tpu_torch.sim.search import price_on_slice

        spec = job.spec
        objective = self._objective_for(spec)
        try:
            cost, strategy, _info = price_on_slice(
                spec.build, spec.config, size, objective=objective,
                iters=min(self.iters, spec.search_iters or self.iters),
                seed=self.seed, warm_strategy=job.strategy,
                budget_s=self.budget_s)
            self._strategy_cache[(spec.job_id, int(size))] = strategy
            self.native_prices += 1
            return float(cost)
        except Exception as e:  # native lib absent / sim unavailable
            self.proxy_prices += 1
            self.pricer_errors.append(f"{type(e).__name__}: {e}")
            self.log(f"fleet: native pricing unavailable for "
                     f"{spec.job_id}@{size} ({type(e).__name__}); "
                     f"using DP proxy")
            return self._price_proxy(job, size)

    @staticmethod
    def _price_proxy(job, size: int) -> float:
        """Deterministic data-parallel proxy: per-step cost scales as
        1/size (perfect DP speedup) plus a small per-device sync term so
        larger slices are never free."""
        return 1.0 / float(size) + 0.001 * float(size)

    # the DP proxy as a PUBLIC injectable pricer: pass
    # ``pricer=Arbiter.proxy_pricer`` to skip native pricing entirely
    # (apps.fleetsim's mode: no model is built)
    proxy_pricer = _price_proxy

    def priced_strategy(self, job, size: int) -> Optional[object]:
        """The strategy the native pricing search found for this (job,
        size), if any — handed to ``Job.place`` so the job runs under
        the plan it was priced with."""
        return self._strategy_cache.get((job.spec.job_id, int(size)))

    # ------------------------------------------------------------------
    # packing

    def pack(self, jobs: Sequence, *,
             current: Optional[Dict[str, int]] = None) -> Dict[str, int]:
        """Choose a slice size per active job.

        ``jobs`` is the admission-ordered list of jobs to place;
        ``current`` (job_id -> size) marks sizes already held: a held
        job is RUNNING on its slice, so 0 is never one of its options
        (no silent preemption — its devices must not be handed away
        while it keeps running), and staying at its current size is an
        option exactly when no candidate fits at-or-below it; held
        sizes also feed the churn tie-break (prefer the packing closest
        to the incumbent among equal-cost maximal packings).  Returns
        ``{job_id: size}``; a job holding nothing that cannot fit at
        its minimum is assigned 0 (the coordinator queues it)."""
        jobs = list(jobs)
        if not jobs:
            return {}
        pool = self.pool_size
        cur_vec = tuple(int((current or {}).get(j.spec.job_id, 0))
                        for j in jobs)
        options: List[List[int]] = []
        for job, held in zip(jobs, cur_vec):
            sizes = job.candidate_sizes(pool)
            if held:
                # never 0; and when no candidate fits at-or-below the
                # held size (a backlogged binding bid the pool cannot
                # meet), staying put is the option — so every held job
                # always has a choice <= held and a feasible packing
                # exists.  Demand-capped candidates are NOT extended
                # otherwise: a calm serve job must still yield down.
                if not any(s <= held for s in sizes):
                    sizes = sorted(set(sizes) | {held})
                options.append(sizes)
            else:
                # 0 = "not placed" — an option only for jobs holding
                # nothing, so one oversized job cannot make the whole
                # fleet infeasible
                options.append([0] + sizes)

        # Grouped-knapsack DP, one group per job in admission order.
        # State: (devices used, min bump) where "bump" is the smallest
        # increment that would raise ONE chosen job to its next larger
        # option — a final packing is Pareto-maximal iff its min bump
        # exceeds the free capacity.  Value: the partial score
        # (unplaced, Σ priority·price, churn, combo-prefix); keeping
        # the minimum per state is exact because the score is additive
        # and suffix-extension preserves its lexicographic order.
        INF = pool + 1   # caps bump: anything > pool acts as "no bump"
        states: Dict[Tuple[int, int], tuple] = {(0, INF): (0, 0.0, 0, ())}
        for idx, (job, opts) in enumerate(zip(jobs, options)):
            nxt: Dict[Tuple[int, int], tuple] = {}
            for (used, bump), val in states.items():
                for i, s in enumerate(opts):
                    nu = used + s
                    if nu > pool:
                        break               # opts ascend: rest too big
                    nb = min(bump, min(opts[i + 1] - s, INF)
                             if i + 1 < len(opts) else INF)
                    if s:
                        nval = (val[0],
                                val[1] + job.spec.priority
                                * self.price(job, s),
                                val[2] + (s != cur_vec[idx]),
                                val[3] + (s,))
                    else:
                        nval = (val[0] + 1, val[1],
                                val[2] + (cur_vec[idx] != 0),
                                val[3] + (0,))
                    key = (nu, nb)
                    if key not in nxt or nval < nxt[key]:
                        nxt[key] = nval
            states = nxt
        # work conservation: only maximal finals compete (some always
        # exist — the all-current/all-zero packing is feasible, and the
        # best value at any maximal packing's state is itself maximal)
        best = min((val for (used, bump), val in states.items()
                    if bump > pool - used), default=None)
        if best is None:     # unreachable; insurance over a crash
            best = min(states.values())
        return {j.spec.job_id: s for j, s in zip(jobs, best[3])}

    def assign_ordinals(self, jobs: Sequence, sizes: Dict[str, int],
                        *, current: Optional[Dict[str, List[int]]] = None
                        ) -> Dict[str, List[int]]:
        """Turn a size packing into concrete pool ordinals.

        Jobs keep as much of their CURRENT interval as possible (a
        directed resize must stay anchored — the elastic path regrids
        live state, it does not relocate wholesale): a shrinking job
        keeps a prefix of its ordinals, a growing job keeps all of them
        and extends from the free pool, lowest ordinal first.  New jobs
        take contiguous runs of what remains, in admission order."""
        current = dict(current or {})
        taken: set = set()
        out: Dict[str, List[int]] = {}
        # pass 0: a job that still holds devices but was packed at 0
        # keeps its slice, reserved — it is RUNNING there and there is
        # no evict path, so handing its ordinals to anyone else would
        # silently oversubscribe the pool.  pack() never produces this
        # (held jobs have no 0 option); guard it anyway.
        for job in jobs:
            jid = job.spec.job_id
            held = sorted(current.get(jid, []))
            if held and not sizes.get(jid, 0):
                self.log(f"fleet: packing assigned 0 to running job "
                         f"{jid}; it keeps its {len(held)}-device slice")
                out[jid] = held
                taken.update(held)
        # pass 1: shrinking / steady jobs keep a prefix
        for job in jobs:
            jid = job.spec.job_id
            size = sizes.get(jid, 0)
            held = sorted(current.get(jid, []))
            if held and size and size <= len(held):
                out[jid] = held[:size]
                taken.update(out[jid])
        # reserve growing jobs' held ordinals before anyone extends
        for job in jobs:
            jid = job.spec.job_id
            held = current.get(jid, [])
            if held and sizes.get(jid, 0) > len(held):
                taken.update(held)
        # pass 2: growing jobs keep everything and extend
        for job in jobs:
            jid = job.spec.job_id
            size = sizes.get(jid, 0)
            held = sorted(current.get(jid, []))
            if held and size > len(held):
                grown = list(held)
                avail = [o for o in range(self.pool_size)
                         if o not in taken and o not in grown]
                grown += avail[:size - len(held)]
                if len(grown) < size:
                    raise RuntimeError(
                        f"fleet: cannot grow {jid} to {size} — pool "
                        f"exhausted (arbiter bug: packing exceeded the "
                        f"pool)")
                out[jid] = sorted(grown)
                taken.update(out[jid])
        # pass 3: new placements take contiguous runs of the remainder
        for job in jobs:
            jid = job.spec.job_id
            if jid in out:
                continue
            size = sizes.get(jid, 0)
            if not size:
                out[jid] = []
                continue
            avail = [o for o in range(self.pool_size) if o not in taken]
            if len(avail) < size:
                raise RuntimeError(
                    f"fleet: packing for {jid} wants {size} of "
                    f"{len(avail)} free devices (arbiter bug)")
            out[jid] = avail[:size]
            taken.update(out[jid])
        # the disjointness contract: no ordinal in two jobs' slices —
        # violating it is the one bug class worse than a crash
        seen: set = set()
        for jid, ords in out.items():
            dup = seen & set(ords)
            if dup:
                raise RuntimeError(
                    f"fleet: assignment oversubscribes ordinals "
                    f"{sorted(dup)} (job {jid}) — arbiter bug")
            seen.update(ords)
        return out
