"""Profiling and tracing (PyTorch port of
``flexflow_tpu/utils/profiling.py``).

  * :class:`StepClock` keeps one host ``perf_counter`` delta per step and
    syncs nothing; :func:`time_op_shard` times one shard of an op the way
    the executor runs it, eagerly and host-synced: the measured side of
    ``fit``'s ``op_time`` records, which ``obs/trace.py`` joins against
    the simulator's per-op times.
  * :func:`trace` — the counterpart of ``jax.profiler.start_trace`` (the
    reference's ``-lg:prof``): a ``torch.profiler`` trace of the CPU and
    CUDA activity inside the block, written as a Chrome trace into a
    directory (``fit`` under ``trace_dir``).
  * :class:`OpProfiler` — the ``profiling`` flag's per-op table (the
    reference's per-task ``cudaEvent`` times, conv_2d.cu:514-545): each
    op's forward and gradient at the shapes one shard sees, timed with
    the measured cost model's protocol (``sim/cost_model.py``: a CUDA
    graph of chained applications replayed between CUDA events; eagerly
    under the host clock on the CPU).  A shard the clone cannot realize
    takes the analytic cost, marked ``~``.
  * :func:`step_roofline` — the port's counterpart of
    ``compiled_roofline``: there is no compiled program to ask, so the
    step's FLOPs are ``FFModel.step_flops`` (the modeled count) over the
    measured step time, against the card's peak for the compute dtype
    (``HopperChipPerf``), as the ``mfu`` gauge reckons; no HBM figure.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import time
from typing import Dict, List, Optional


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


@contextlib.contextmanager
def trace(logdir: str):
    """A ``torch.profiler`` trace of everything run inside the block (the
    CPU's operators and, where CUDA is available, the card's kernels and
    copies), written at the end as ``<logdir>/trace_<pid>.json`` (Chrome
    trace format; open it in Perfetto or ``chrome://tracing``)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir,
                                          f"trace_{os.getpid()}.json"))


@dataclasses.dataclass
class OpProfile:
    name: str
    kind: str
    grid: tuple
    out_shape: tuple
    ms: float            # measured forward + gradient ms of one shard
    gflops: float        # modeled forward + backward GFLOPs of one shard
    measured: bool

    @property
    def tflops_per_sec(self) -> float:
        return (self.gflops / 1e3) / (self.ms / 1e3) if self.ms > 0 else 0.0


class OpProfiler:
    """Per-op timing table of a model (the ``profiling`` flag's output).

    Each op's forward and gradient run in isolation at the shapes one
    device sees under the op's grid, on the model's device, through the
    port's ops and kernels.  An isolated time is an attribution guide,
    not a decomposition of the step: the step's whole timeline is
    :func:`trace`'s."""

    def __init__(self, model, repeats: int = 3):
        self.model = model
        self.repeats = repeats

    def profile(self) -> List[OpProfile]:
        from flexflow_tpu_torch.sim.cost_model import (AnalyticCostModel,
                                                       MeasuredCostModel,
                                                       shard_flops)

        dtype = self.model.config.compute_dtype
        measured = MeasuredCostModel(repeats=self.repeats, dtype=dtype,
                                     device=self.model.device)
        analytic = AnalyticCostModel(dtype=dtype)
        rows = []
        for op in self.model.layers:
            local = op.local_clone(op.pc)
            # a shard that fails to run raises: it is not priced
            t = measured._measure(local) if local is not None else None
            was_measured = t is not None
            if t is None:
                t = analytic.op_cost(op, op.pc)
            rows.append(OpProfile(
                name=op.name, kind=type(op).__name__, grid=op.pc.dims,
                out_shape=op.output.shape, ms=t * 1e3,
                gflops=shard_flops(op, op.pc) / 1e9,
                measured=was_measured))
        return rows

    def report(self, rows: Optional[List[OpProfile]] = None) -> str:
        rows = rows if rows is not None else self.profile()
        total = sum(r.ms for r in rows)
        lines = [
            f"{'op':<18s} {'kind':<12s} {'grid':<14s} "
            f"{'shard ms':>9s} {'GFLOP':>8s} {'TFLOP/s':>8s} {'%':>5s}",
        ]
        for r in rows:
            pct = 100.0 * r.ms / total if total else 0.0
            mark = "" if r.measured else "~"
            lines.append(
                f"{r.name:<18s} {r.kind:<12s} {str(r.grid):<14s} "
                f"{mark}{r.ms:>8.3f} {r.gflops:>8.2f} "
                f"{r.tflops_per_sec:>8.2f} {pct:>4.1f}%")
        lines.append(f"{'total (isolated, one shard)':<46s} {total:>8.3f} ms"
                     "   [~ = analytic estimate]")
        return "\n".join(lines)


def step_roofline(flops: float, seconds_per_step: Optional[float],
                  dtype: str, device, n_devices: int = 1,
                  perf=None) -> Dict[str, float]:
    """``flops`` (one step's, over every device) over the measured step
    time: ``achieved_tflops``, and on a CUDA device ``mfu``, the share of
    ``n_devices`` cards' peak for ``dtype`` (``HopperChipPerf``), and
    ``min_step_seconds_at_peak``.  A CPU run gets no ``mfu``: the peak
    is the card's."""
    from flexflow_tpu_torch.sim.cost_model import HopperChipPerf

    out = {"flops": float(flops)}
    if getattr(device, "type", str(device)) == "cuda":
        perf = perf or HopperChipPerf()
        peak = perf.flops_rate(dtype) * max(n_devices, 1)
        out["peak_tflops"] = peak / 1e12
        out["min_step_seconds_at_peak"] = flops / peak
        if seconds_per_step and seconds_per_step > 0:
            out["mfu"] = flops / seconds_per_step / peak
    if seconds_per_step and seconds_per_step > 0:
        out["achieved_tflops"] = flops / seconds_per_step / 1e12
    return out
