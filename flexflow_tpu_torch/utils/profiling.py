"""Step and per-op timing for the run telemetry (PyTorch port of
``flexflow_tpu/utils/profiling.py``'s :class:`StepClock` and
:func:`time_op_shard`).

:class:`StepClock` keeps one host ``perf_counter`` delta per step and
syncs nothing.  :func:`time_op_shard` times one shard of an op the way
the executor runs it, eagerly and host-synced: the measured side of
``fit``'s ``op_time`` records, which ``obs/trace.py`` joins against the
simulator's per-op times.
"""

from __future__ import annotations

import time
from typing import List, Optional


class StepClock:
    """Host-side per-step wall clock: ``tick()`` appends one
    ``perf_counter`` delta and syncs nothing, so the loop's queue of
    launches is not drained; the deltas are read after the loop."""

    def __init__(self):
        self._last = time.perf_counter()
        self.deltas: List[float] = []

    def tick(self) -> None:
        now = time.perf_counter()
        self.deltas.append(now - self._last)
        self._last = now


def time_op_shard(op, pc, dtype: str = "float32", repeats: int = 3,
                  device="cuda") -> Optional[float]:
    """Wall seconds of one shard's forward and gradient of ``op`` under
    ``pc`` (shard-local shapes from ``op.local_clone(pc)``), on
    ``device``: one untimed application, then the minimum over
    ``repeats`` applications, each ended by a device sync.

    Each application runs the forward in training mode, the loss
    sum(y^2) and the gradients of the parameters (or of the float inputs
    of an op without parameters), eagerly, as the executor runs the op:
    the time includes the host's launches, which the measured search's
    graph replay leaves out.  None where ``local_clone`` is None (the
    caller prices the shard analytically); a shard that fails to run
    raises."""
    import torch

    from flexflow_tpu_torch.machine import resolve_device
    from flexflow_tpu_torch.ops.base import torch_dtype

    local = op.local_clone(pc)
    if local is None:
        return None
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    params = local.init_params(gen, dev)
    state = local.init_state(dev)
    with_grad = not params and bool(op.inputs) \
        and op.inputs[0].dtype != "int32"
    xs = [torch.zeros(t.shape, dtype=torch.int32, device=dev)
          if t.dtype == "int32" else
          torch.ones(t.shape, dtype=torch_dtype(dtype), device=dev,
                     requires_grad=with_grad)
          for t in local.inputs]
    wrt = [v.requires_grad_() for v in params.values()] if params else \
        [x for x in xs if x.requires_grad]

    def apply():
        with torch.enable_grad():
            res, _ = local.forward(params, state, xs, True)
            y = res[0] if isinstance(res, tuple) else res
            loss = (y.float() ** 2).sum()
            if wrt:
                torch.autograd.grad(loss, wrt)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    apply()
    sync()
    best = None
    for _ in range(max(repeats, 1)):
        t0 = time.perf_counter()
        apply()
        sync()
        dt = time.perf_counter() - t0
        best = dt if best is None else min(best, dt)
    return best
