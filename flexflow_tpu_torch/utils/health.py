"""Step health guard: windowed finite-loss checks for the training loop
(PyTorch port of ``flexflow_tpu/utils/health.py:StepHealthGuard``).

``fit`` keeps each step's loss as a device scalar and hands the guard
the window since its last check only at boundaries that synchronize with
the device anyway: ``print_freq`` prints, checkpoint saves and the last
step.  No per-step host synchronization is added, and a run whose losses
are finite trains exactly as an unguarded one.

Policies (``FFConfig.on_divergence``):

  * ``halt``     — raise :class:`TrainingDiverged` (the default);
  * ``warn``     — log and keep training;
  * ``rollback`` — tell ``fit`` to restore the newest verified checkpoint
                   (``utils/checkpoint.py``'s fallback over corrupt
                   steps) and continue on fresh batches; after
                   ``max_rollbacks`` restores the guard raises anyway,
                   so a loss that is NaN every time cannot loop forever.

Every detection is a ``fault`` record (source ``guard``) on the run's
obs sink, a rollback's first clean window a ``recovery`` record.

:class:`StepWatchdog` sees what the guard cannot: a boundary that never
returns (a wedged collective, a lost card).  It arms a one-shot timer
around the boundary's blocking syncs, with a deadline of ``hang_factor``
times the median of the recent per-step wall times, floored at
``hang_min_s``; on expiry the timer thread writes a ``step_hang``
record, and the main thread, once the boundary returns, sees the expiry
at ``disarm()``.  Without elastic training ``fit`` then raises
``DeviceLostError``.  The injected ``step_hang`` stalls inside an armed
window (``stall()``), so the whole path runs without a faulty card.
"""

from __future__ import annotations

import math
import threading
import time

import torch

POLICIES = ("halt", "warn", "rollback")


class TrainingDiverged(RuntimeError):
    """A non-finite loss under ``halt``, or divergence that survived every
    allowed rollback."""

    def __init__(self, step: int, value: float, rollbacks: int = 0):
        self.step = step
        self.value = value
        self.rollbacks = rollbacks
        extra = f" after {rollbacks} rollback(s)" if rollbacks else ""
        super().__init__(
            f"training diverged: non-finite loss {value!r} at iteration "
            f"{step}{extra}")


class StepHealthGuard:
    """One guard per ``fit`` call; :meth:`check` runs at the loop's
    synchronizing boundaries with the losses since the previous check."""

    def __init__(self, policy: str = "halt", max_rollbacks: int = 3,
                 olog=None, log=print):
        if policy not in POLICIES:
            raise ValueError(
                f"on_divergence must be one of {'|'.join(POLICIES)}, "
                f"got {policy!r}")
        from flexflow_tpu_torch import obs

        self.policy = policy
        self.max_rollbacks = max(int(max_rollbacks), 0)
        self.rollbacks = 0
        self.olog = olog if olog is not None else obs.NULL
        self.log = log
        self._await_recovery = False

    def check(self, window, first_step: int):
        """Inspect the losses (device or host scalars) of steps
        ``first_step .. first_step + len(window) - 1``, read in one
        transfer.  Returns None (finite), ``"warn"`` or ``"rollback"``
        (the caller restores and re-runs); raises
        :class:`TrainingDiverged` under ``halt`` or once the rollbacks
        are spent."""
        if not window:
            return None
        vals = torch.stack([torch.as_tensor(v).float().reshape(())
                            for v in window]).cpu().tolist()
        bad = next((i for i, v in enumerate(vals) if not math.isfinite(v)),
                   None)
        if bad is None:
            if self._await_recovery:
                self._await_recovery = False
                step = first_step + len(vals) - 1
                self.olog.event("recovery", source="guard",
                                after="rollback", step=step)
                self.log(f"health guard: recovered — window through "
                         f"iteration {step} is finite again")
            return None
        step, value = first_step + bad, vals[bad]
        self.olog.event("fault", source="guard", fault="loss_divergence",
                        step=step, value=value, policy=self.policy)
        if self.policy == "warn":
            self.log(f"warning: non-finite loss {value!r} at iteration "
                     f"{step} (on_divergence=warn; continuing)")
            return "warn"
        if self.policy == "rollback":
            if self.rollbacks >= self.max_rollbacks:
                self.olog.event("fault", source="guard",
                                fault="rollback_budget_exhausted",
                                step=step, rollbacks=self.rollbacks)
                raise TrainingDiverged(step, value, self.rollbacks)
            self.rollbacks += 1
            self._await_recovery = True
            return "rollback"
        raise TrainingDiverged(step, value)


class StepWatchdog:
    """Hang detector armed around ``fit``'s blocking boundary syncs
    (``health.py:138-236`` of the JAX package), one per ``fit`` call::

        wd.observe(wall_s, steps)   # feed the per-step estimate
        wd.arm(step)                # start the one-shot deadline timer
        ... the boundary's blocking syncs ...
        info = wd.disarm()          # cancel, or collect the expiry

    The timer thread only sets the expiry and writes the ``step_hang``
    record (the obs sink is thread-safe); every decision stays on the
    main thread.  ``close()`` is idempotent and joins a live timer."""

    def __init__(self, factor: float, min_deadline_s: float = 60.0,
                 window: int = 32, olog=None, log=print):
        from flexflow_tpu_torch import obs

        self.factor = float(factor)
        self.min_deadline_s = float(min_deadline_s)
        self.window = max(int(window), 1)
        self.olog = olog if olog is not None else obs.NULL
        self.log = log
        self.enabled = self.factor > 0
        self._estimates: list = []
        self._timer = None
        self._expired = None
        self._step = None
        self.hangs = 0

    def observe(self, wall_s: float, steps: int = 1) -> None:
        """Feed one inter-boundary wall time covering ``steps`` steps."""
        if steps <= 0 or wall_s <= 0:
            return
        self._estimates.append(float(wall_s) / steps)
        del self._estimates[:-self.window]

    def step_estimate_s(self) -> float:
        """The median per-step wall time of the window; 0 before any."""
        if not self._estimates:
            return 0.0
        vals = sorted(self._estimates)
        return vals[len(vals) // 2]

    def deadline_s(self) -> float:
        return max(self.factor * self.step_estimate_s(),
                   self.min_deadline_s)

    def _expire(self, step: int, deadline: float) -> None:
        self._expired = {"step": step, "deadline_s": deadline,
                         "estimate_s": self.step_estimate_s()}
        self.hangs += 1
        self.olog.event("step_hang", step=step, deadline_s=deadline,
                        estimate_s=self._expired["estimate_s"],
                        factor=self.factor)
        self.log(f"watchdog: boundary at iteration {step} exceeded its "
                 f"{deadline:.1f}s deadline — probing devices when it "
                 f"returns")

    def arm(self, step: int) -> None:
        """Start the one-shot deadline timer of this boundary."""
        if not self.enabled:
            return
        self.disarm()
        self._expired = None
        self._step = int(step)
        deadline = self.deadline_s()
        self._timer = threading.Timer(
            deadline, self._expire, args=(self._step, deadline))
        self._timer.daemon = True
        self._timer.name = f"ff-step-watchdog-{self._step}"
        self._timer.start()

    def disarm(self):
        """Cancel the timer (joined, so no thread outlives the call) and
        return the expiry's dict if the deadline fired, else None."""
        t, self._timer = self._timer, None
        if t is not None:
            t.cancel()
            t.join(timeout=5.0)
        info, self._expired = self._expired, None
        return info

    def stall(self, margin_s: float = 0.25, sleep=None) -> None:
        """The injected ``step_hang``: block inside the armed window
        until just past the deadline."""
        (sleep or time.sleep)(self.deadline_s() + margin_s)

    def close(self) -> None:
        self.disarm()
