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

The JAX module's step watchdog (hang detection around wedged
collectives) is not ported: it serves the elastic runtime over several
devices.
"""

from __future__ import annotations

import math

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
                 log=print):
        if policy not in POLICIES:
            raise ValueError(
                f"on_divergence must be one of {'|'.join(POLICIES)}, "
                f"got {policy!r}")
        self.policy = policy
        self.max_rollbacks = max(int(max_rollbacks), 0)
        self.rollbacks = 0
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
                self.log(f"health guard: recovered — window through "
                         f"iteration {first_step + len(vals) - 1} is finite "
                         f"again")
            return None
        step, value = first_step + bad, vals[bad]
        if self.policy == "warn":
            self.log(f"warning: non-finite loss {value!r} at iteration "
                     f"{step} (on_divergence=warn; continuing)")
            return "warn"
        if self.policy == "rollback":
            if self.rollbacks >= self.max_rollbacks:
                raise TrainingDiverged(step, value, self.rollbacks)
            self.rollbacks += 1
            self._await_recovery = True
            return "rollback"
        raise TrainingDiverged(step, value)
