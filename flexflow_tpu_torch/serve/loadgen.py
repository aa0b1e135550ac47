"""Seeded synthetic load generator: Poisson arrivals in VIRTUAL time,
plus the composable production arrival patterns the load harness drives
(diurnal sinusoid, on/off bursty, heavy-tail Pareto inter-arrivals and
prompt lengths).

The port's own copy of ``flexflow_tpu/serve/loadgen.py``: one seed gives
the same request stream in both packages.

The serving smoke must be deterministic on CPU the way every other gate
in this repo is (elastic-smoke, fault-smoke): same seed -> same
admission order, same latencies, same autoscale triggers, bit-identical
replies.  Real wall clocks cannot deliver that, so requests carry a
VIRTUAL arrival time in seconds: inter-arrival gaps are drawn from a
seeded exponential distribution (a Poisson process at ``rate_qps``) and
the engine advances its own virtual clock by the per-step service time
(:attr:`ServeEngine.step_time_s`).  Latency = virtual completion -
virtual arrival; TTFT (time to first token) = virtual first-token time -
virtual arrival; TPOT (time per output token) = the decode tail after
the first token divided by the remaining tokens.  Wall time is recorded
separately, for information only.

``gap_after``/``gap_s`` inject one idle window into the arrival stream —
the smoke's lever for driving the idle-shrink watermark (traffic dies
down, the mesh shrinks, the following burst grows it back).

:func:`patterned_requests` layers production traffic shapes on the same
seeded substrate.  ``pattern`` is a ``+``-composable spec:

  * ``poisson`` — homogeneous Poisson at ``rate_qps`` (the base);
  * ``diurnal`` — sinusoidal rate modulation (period ``diurnal_period_s``,
    amplitude ``diurnal_amp``), the day/night QPS curve;
  * ``bursty`` — on/off square-wave modulation (``burst_on_s`` at
    ``burst_factor``x inside each ``burst_on_s + burst_off_s`` cycle);
  * ``heavy_tail`` — Pareto (Lomax) inter-arrival gaps with tail index
    ``tail_alpha`` (mean held at ``1/rate_qps``), and Pareto-tailed
    prompt lengths up to ``max_prompt_len``;
  * ``session`` — multi-turn conversations: the composed process above
    generates session STARTS, each start draws a geometric turn count
    (mean ``session_turns``) and exponential think-time gaps (mean
    ``session_think_s``) for its follow-ups, every turn carrying the
    session id so affinity routing (serve/router.py) has KV reuse to
    exploit.

Modulated patterns are generated by thinning an upper-bound Poisson
stream, so any composition stays an exact inhomogeneous process and —
because every draw comes from one seeded RandomState in a fixed order
(session turn counts and think gaps drawn eagerly per start) — the
arrival stream is bit-reproducible under its seed.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, List, Optional

import numpy as np

#: smallest prompt token id — 0 is the pad id the engine uses for empty
#: positions and 1 the conventional EOS, so prompts start at 2
MIN_PROMPT_ID = 2

ARRIVAL_PATTERNS = ("poisson", "diurnal", "bursty", "heavy_tail",
                    "session")


@dataclasses.dataclass
class Request:
    """One inference request and its lifecycle stamps.

    ``tokens`` is the prompt (int32 ids) for the LM decode path, or an
    arbitrary per-sample input array for the CNN/NMT forward-only
    service.  The ``*_v`` stamps are VIRTUAL seconds (the deterministic
    clock); ``wall_s`` is the real service wall time, informational.
    ``first_token_v`` is stamped by the engine at the decode boundary
    that materializes the request's FIRST generated token — under
    disaggregated serving (serve/router.py) that is the PREFILL pool's
    completing step, so TTFT measures prompt processing and TPOT the
    pure decode tail.

    ``session`` groups multi-turn traffic (the ``session`` arrival
    pattern): follow-up requests carry their session id so the router
    can keep them on the decode replica already holding their KV rows.
    ``carried_tokens`` / ``kv_payload`` / ``handoff_v`` are the
    prefill->decode handoff state: tokens generated before the current
    pool admitted the request, the exported KV rows riding with it, and
    the virtual instant the handoff landed."""

    rid: int
    arrival_v: float
    tokens: np.ndarray
    max_new_tokens: int = 0
    eos_id: int = -1
    session: Optional[int] = None
    # admission priority (higher = more important): the router's
    # SLO-burn shedding gate drops the LOWEST priority arrivals first
    priority: int = 0
    # filled by the engine:
    admit_v: Optional[float] = None
    first_token_v: Optional[float] = None
    done_v: Optional[float] = None
    wall_s: float = 0.0
    reply: Optional[List[int]] = None
    # filled by the disaggregation router (serve/router.py):
    carried_tokens: Optional[List[int]] = None
    kv_payload: Optional[object] = None
    handoff_v: Optional[float] = None

    @property
    def latency_s(self) -> Optional[float]:
        if self.done_v is None:
            return None
        return self.done_v - self.arrival_v

    @property
    def ttft_s(self) -> Optional[float]:
        """Time to first token (virtual): arrival -> first generated
        token.  None until the first token lands."""
        if self.first_token_v is None:
            return None
        return self.first_token_v - self.arrival_v

    @property
    def tpot_s(self) -> Optional[float]:
        """Time per output token (virtual): the decode tail after the
        first token, per remaining generated token.  0.0 for a
        single-token reply (no tail); None until completion."""
        if self.done_v is None or self.first_token_v is None:
            return None
        # reply is a token list for decode, an ndarray for the
        # forward-only service — avoid ambiguous array truthiness
        n_tail = (len(self.reply) if self.reply is not None else 0) - 1
        if n_tail <= 0:
            return 0.0
        return (self.done_v - self.first_token_v) / n_tail


def _prompt_bounds(vocab_size: int) -> int:
    """Validate that ``[MIN_PROMPT_ID, vocab_size)`` is a non-empty
    prompt id range.  Prompts must never collide with the pad id (0) or
    the conventional EOS (1) — a vocab of <= MIN_PROMPT_ID cannot host a
    single legal prompt token, so refuse it loudly instead of silently
    generating pad/EOS prompts."""
    if vocab_size <= MIN_PROMPT_ID:
        raise ValueError(
            f"vocab_size must be > {MIN_PROMPT_ID} so prompts avoid the "
            f"pad (0) and EOS (1) ids, got {vocab_size}")
    return MIN_PROMPT_ID


def synthetic_requests(n: int, *, seed: int = 0, rate_qps: float = 100.0,
                       vocab_size: int = 64, prompt_len: int = 4,
                       max_new_tokens: int = 4, eos_id: int = -1,
                       gap_after: Optional[int] = None,
                       gap_s: float = 0.0,
                       start_v: float = 0.0) -> List[Request]:
    """``n`` deterministic requests with Poisson arrivals.

    Prompts are uniform random ids in ``[2, vocab_size)`` — 0 is the pad
    id the engine uses for empty positions and 1 the conventional EOS,
    so prompts never collide with either (``vocab_size`` must leave that
    range non-empty).  ``gap_after`` > 0 inserts ``gap_s`` of extra
    virtual idle time before request ``gap_after`` (0-indexed), carving
    the arrival stream into a front phase, an idle window, and a
    burst."""
    if n < 0:
        raise ValueError(f"request count must be >= 0, got {n}")
    if rate_qps <= 0:
        raise ValueError(f"rate_qps must be > 0, got {rate_qps}")
    lo = _prompt_bounds(vocab_size)
    rng = np.random.RandomState(seed)
    out: List[Request] = []
    t = float(start_v)
    for i in range(n):
        t += float(rng.exponential(1.0 / rate_qps))
        if gap_after is not None and i == gap_after:
            t += float(gap_s)
        tokens = rng.randint(lo, vocab_size,
                             size=(prompt_len,)).astype(np.int32)
        out.append(Request(rid=i, arrival_v=t, tokens=tokens,
                           max_new_tokens=max_new_tokens, eos_id=eos_id))
    return out


# ---------------------------------------------------------------------------
# composable arrival patterns (the load harness's traffic shapes)


def _parse_pattern(pattern: str) -> List[str]:
    parts = [p.strip() for p in str(pattern).split("+") if p.strip()]
    if not parts:
        parts = ["poisson"]
    for p in parts:
        if p not in ARRIVAL_PATTERNS:
            raise ValueError(
                f"unknown arrival pattern {p!r} "
                f"(expected '+'-composition of {ARRIVAL_PATTERNS})")
    return parts


def _modulators(parts: List[str], *, diurnal_period_s: float,
                diurnal_amp: float, burst_on_s: float, burst_off_s: float,
                burst_factor: float) \
        -> List[Callable[[float], float]]:
    """Rate-modulation factors m(t) >= 0 for the time-varying patterns.
    The instantaneous intensity is ``rate_qps * prod(m_i(t))``."""
    mods: List[Callable[[float], float]] = []
    if "diurnal" in parts:
        if not 0.0 <= diurnal_amp <= 1.0:
            raise ValueError(
                f"diurnal_amp must be in [0, 1], got {diurnal_amp}")
        if diurnal_period_s <= 0:
            raise ValueError(f"diurnal_period_s must be > 0, got "
                             f"{diurnal_period_s}")
        w = 2.0 * math.pi / diurnal_period_s

        def diurnal(t: float, _w=w, _a=diurnal_amp) -> float:
            return 1.0 + _a * math.sin(_w * t)

        diurnal.peak = 1.0 + diurnal_amp  # type: ignore[attr-defined]
        mods.append(diurnal)
    if "bursty" in parts:
        if burst_on_s <= 0 or burst_off_s < 0:
            raise ValueError(
                f"burst_on_s must be > 0 and burst_off_s >= 0, got "
                f"{burst_on_s}/{burst_off_s}")
        if burst_factor < 1.0:
            raise ValueError(
                f"burst_factor must be >= 1, got {burst_factor}")
        cycle = burst_on_s + burst_off_s

        def bursty(t: float, _c=cycle, _on=burst_on_s,
                   _f=burst_factor) -> float:
            return _f if (t % _c) < _on else 1.0

        bursty.peak = burst_factor  # type: ignore[attr-defined]
        mods.append(bursty)
    return mods


def patterned_requests(n: int, *, seed: int = 0, rate_qps: float = 100.0,
                       pattern: str = "poisson", vocab_size: int = 64,
                       prompt_len: int = 4, max_new_tokens: int = 4,
                       eos_id: int = -1, start_v: float = 0.0,
                       diurnal_period_s: float = 60.0,
                       diurnal_amp: float = 0.8,
                       burst_on_s: float = 2.0, burst_off_s: float = 8.0,
                       burst_factor: float = 6.0,
                       tail_alpha: float = 1.5,
                       max_prompt_len: Optional[int] = None,
                       session_turns: float = 3.0,
                       session_think_s: float = 0.5) \
        -> List[Request]:
    """``n`` deterministic requests under a composed arrival pattern.

    The MEAN offered rate stays ``rate_qps`` for ``poisson`` and
    ``heavy_tail``; ``diurnal``/``bursty`` modulate the instantaneous
    intensity around it (thinning against the composed peak keeps the
    process exact).  ``heavy_tail`` swaps the exponential gap draw for a
    Pareto (Lomax, ``tail_alpha`` > 1) with the same mean, and draws
    Pareto-tailed prompt lengths in ``[prompt_len, max_prompt_len]`` —
    the occasional giant prompt that stresses admission and the KV
    window.  ``session`` turns every composed arrival into a session
    START whose follow-up turns (geometric count, mean
    ``session_turns``; exponential think gaps, mean ``session_think_s``)
    arrive later carrying the same :attr:`Request.session` id — the
    merged stream is sorted by arrival and truncated to ``n``.  One
    seeded RandomState in a fixed draw order makes the stream (arrivals
    AND prompts) bit-reproducible under ``seed``."""
    if n < 0:
        raise ValueError(f"request count must be >= 0, got {n}")
    if rate_qps <= 0:
        raise ValueError(f"rate_qps must be > 0, got {rate_qps}")
    parts = _parse_pattern(pattern)
    lo = _prompt_bounds(vocab_size)
    heavy = "heavy_tail" in parts
    sessions = "session" in parts
    if sessions:
        if session_turns < 1.0:
            raise ValueError(
                f"session_turns must be >= 1, got {session_turns}")
        if session_think_s <= 0:
            raise ValueError(
                f"session_think_s must be > 0, got {session_think_s}")
    if heavy and tail_alpha <= 1.0:
        raise ValueError(
            f"tail_alpha must be > 1 (finite mean), got {tail_alpha}")
    mods = _modulators(parts, diurnal_period_s=diurnal_period_s,
                       diurnal_amp=diurnal_amp, burst_on_s=burst_on_s,
                       burst_off_s=burst_off_s, burst_factor=burst_factor)
    peak = 1.0
    for m in mods:
        peak *= m.peak  # type: ignore[attr-defined]
    rng = np.random.RandomState(seed)

    def base_gap() -> float:
        # candidate gaps at the composed PEAK intensity; thinning below
        # restores the target instantaneous rate exactly
        if heavy:
            # Lomax(alpha) has mean 1/(alpha-1): scale to mean
            # 1/(rate*peak)
            return float(rng.pareto(tail_alpha)
                         * (tail_alpha - 1.0) / (rate_qps * peak))
        return float(rng.exponential(1.0 / (rate_qps * peak)))

    def prompt_length() -> int:
        if not heavy:
            return prompt_len
        cap = max_prompt_len if max_prompt_len is not None \
            else 4 * prompt_len
        extra = int(rng.pareto(tail_alpha) * prompt_len)
        return max(prompt_len, min(prompt_len + extra, int(cap)))

    def draw_prompt():
        plen = prompt_length()
        return rng.randint(lo, vocab_size,
                           size=(plen,)).astype(np.int32)

    # (arrival, session_id, turn, tokens) tuples; under ``session`` the
    # composed arrivals are session starts and each start eagerly draws
    # its whole turn schedule (fixed draw order = bit-reproducibility)
    entries: List[tuple] = []
    t = float(start_v)
    sid = 0
    while len(entries) < n:
        t += base_gap()
        if mods:
            keep = 1.0
            for m in mods:
                keep *= m(t - start_v)
            # one uniform per CANDIDATE keeps the draw order fixed
            if rng.uniform() >= keep / peak:
                continue
        if not sessions:
            entries.append((t, None, 0, draw_prompt()))
            continue
        turns = int(rng.geometric(1.0 / float(session_turns)))
        tv = t
        for turn in range(turns):
            if turn > 0:
                tv += float(rng.exponential(session_think_s))
            entries.append((tv, sid, turn, draw_prompt()))
        sid += 1
    if sessions:
        # follow-ups land arbitrarily far out; keep the n earliest
        entries.sort(key=lambda e: (e[0], e[1] or 0, e[2]))
        entries = entries[:n]
    out: List[Request] = []
    for i, (tv, s, _turn, tokens) in enumerate(entries):
        out.append(Request(rid=i, arrival_v=tv, tokens=tokens,
                           max_new_tokens=max_new_tokens, eos_id=eos_id,
                           session=s))
    return out
