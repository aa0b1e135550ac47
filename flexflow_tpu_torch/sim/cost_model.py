"""Per-op cost models for the strategy simulator (PyTorch port of
``flexflow_tpu/sim/cost_model.py``).

The reference times real cuDNN/cuBLAS forward and backward passes per
partition count (``scripts/cnn.h`` ``measure_*``).  Two models stand in:

* :class:`AnalyticCostModel`, a roofline over the card's published peaks
  (:class:`HopperChipPerf`) that runs anywhere, the CPU included, and
  touches no device;
* :class:`MeasuredCostModel`, which times one grid point's forward and
  gradient (``Op.local_clone``) on the card with CUDA events, through the
  port's own op code and hence its kernels, and caches the times on disk.

The efficiency factors of :class:`HopperChipPerf` are placeholders until
measured: the measured model derives, per op kind, the ratio of measured
to analytic time (the kind anchors), and a search that runs it records
them (``PERF.md``).
"""

from __future__ import annotations

import dataclasses
import json
import os
import tempfile
from typing import Dict, Optional

from flexflow_tpu_torch.ops.base import Op
from flexflow_tpu_torch.strategy import ParallelConfig


@dataclasses.dataclass(frozen=True)
class HopperChipPerf:
    """One card's peaks (the counterpart of ``TpuChipPerf``).  The rates
    are NVIDIA's published dense numbers of the H100 SXM5 (the H100 data
    sheet, at its full 700 W power limit); the efficiency factors are
    placeholders, not measurements (the measured model's kind anchors
    replace them per op kind)."""

    # bf16 and fp16 on the tensor cores, dense: 989 TFLOP/s (TF32 there:
    # 495 TFLOP/s, not priced: the port's drivers turn TF32 off)
    peak_flops: float = 9.89e14
    # float32 outside the tensor cores: 67 TFLOP/s
    fp32_flops: float = 6.7e13
    # HBM3: 3.35 TB/s
    hbm_bandwidth: float = 3.35e12
    # HBM3: 80 GB
    hbm_capacity: float = 8.0e10
    # placeholders: the achievable share of the peak on matmul-like and on
    # elementwise ops, and a per-op launch cost
    matmul_efficiency: float = 0.5
    vector_efficiency: float = 0.8
    step_overhead: float = 5.0e-6

    @classmethod
    def for_device(cls, device) -> "HopperChipPerf":
        """The published peaks with the memory of CUDA ``device`` as
        ``torch.cuda.get_device_properties`` reports it."""
        import torch

        total = torch.cuda.get_device_properties(device).total_memory
        return cls(hbm_capacity=float(total))

    def flops_rate(self, dtype: str) -> float:
        """The peak for a compute dtype: the tensor cores' bf16 rate for
        16-bit types, the plain float32 rate for float32 (the port's
        drivers turn TF32 off)."""
        return self.fp32_flops if dtype == "float32" else self.peak_flops


_MATMUL_OPS = {"Conv2D", "Linear", "LSTMChunk", "RnnLinear",
               "MixtureOfExperts"}

_DTYPE_BYTES = {"float32": 4, "int32": 4, "bfloat16": 2, "float16": 2,
                "int8": 1, "uint8": 1, "bool": 1, "float64": 8, "int64": 8}


def dtype_bytes(dtype: str) -> int:
    """Bytes per element of a dtype name (4 for an unknown one, as
    ``native/simulator.cc`` prices transfers)."""
    return _DTYPE_BYTES.get(dtype, 4)


def param_byte_scale(config) -> float:
    """``Op.param_bytes()`` speaks float32; the factor to the model's
    parameter storage dtype (0.5 for bfloat16 storage)."""
    pdtype = getattr(config, "param_dtype", "float32") or "float32"
    return dtype_bytes(pdtype) / 4.0


def shard_flops(op: Op, pc: ParallelConfig) -> float:
    """Modeled forward + backward FLOPs of one shard: 3x the forward."""
    custom = op.shard_flops_fwd(pc)
    if custom is not None:
        return 3.0 * custom
    batch = op.output.shape[0]
    return 3.0 * op.flops_per_sample() * batch / pc.num_parts


def pad_factor(op: Op, pc: ParallelConfig) -> float:
    """Work multiplier of an uneven split: every shard is padded to the
    ceil size (35 rows over 2 compute 2 x 18 = 36)."""
    spec = op.output_specs()[0]
    if spec is None:
        return 1.0
    sizes = dict(zip(op.AXIS_NAMES, pc.dims))
    shape = op.output.shape
    f = 1.0
    for d, entry in enumerate(spec):
        if entry is None or d >= len(shape):
            continue
        parts = 1
        for a in (entry if isinstance(entry, tuple) else (entry,)):
            parts *= sizes.get(a, 1)
        if parts > 1 and shape[d] % parts:
            f *= (-(-shape[d] // parts) * parts) / shape[d]
    return f


def param_shard_fraction(op: Op, pc: ParallelConfig) -> float:
    """The share of the op's parameters one shard holds under ``pc``:
    1 / the product of the grid dims its param specs split."""
    specs = op.param_specs()
    if not specs:
        return 1.0
    shard_axes = set()
    for spec in specs.values():
        for entry in spec:
            if entry is None:
                continue
            for a in (entry if isinstance(entry, tuple) else (entry,)):
                shard_axes.add(a)
    sizes = dict(zip(op.AXIS_NAMES, pc.dims))
    shard = 1
    for a in shard_axes:
        shard *= sizes.get(a, 1)
    return 1.0 / shard


class AnalyticCostModel:
    """Roofline: a shard's time is max(flops / effective peak, bytes /
    effective HBM rate) plus a launch cost, forward + backward modeled as
    3x forward.  ``dtype`` is the compute dtype, which picks the peak
    (:meth:`HopperChipPerf.flops_rate`)."""

    def __init__(self, perf=None, param_scale: float = 1.0,
                 dtype: str = "float32"):
        self.perf = perf or HopperChipPerf()
        # Op.param_bytes speaks float32; bfloat16 storage streams half
        self.param_scale = param_scale
        self.dtype = dtype
        # the search's records report cache counters for every model
        self.cache_hits = 0
        self.cache_misses = 0

    def op_cost(self, op: Op, pc: ParallelConfig) -> float:
        n_parts = pc.num_parts
        pad = pad_factor(op, pc)
        flops = shard_flops(op, pc) * pad
        io_elems = (sum(t.size() for t in op.inputs) +
                    sum(t.size() for t in op.all_outputs())) * pad
        # activations and parameters stream 3x a step (forward read, the
        # gradient's accumulation, the input gradient's re-read); a shard
        # streams only its slice of a split weight
        bytes_moved = 3.0 * (4.0 * io_elems / n_parts
                             + op.param_bytes() * self.param_scale
                             * param_shard_fraction(op, pc))
        p = self.perf
        eff = p.matmul_efficiency if type(op).__name__ in _MATMUL_OPS \
            else p.vector_efficiency
        t_compute = flops / (p.flops_rate(self.dtype) * eff) \
            if flops else 0.0
        t_mem = bytes_moved / (p.hbm_bandwidth * p.vector_efficiency)
        return max(t_compute, t_mem) + p.step_overhead


class MeasuredCostModel:
    """Times one grid point's forward and gradient on ``device``, the
    reference's ``measure_*_time`` harness (``scripts/cnn.h:204-476``):
    the op's ``local_clone`` at shard-local shapes, its parameters drawn
    from a fixed seed, inputs of ones in ``dtype``.  Each application
    runs the forward (training mode), the loss sum(y^2) and the gradient
    of every parameter and float input.  On a CUDA device two untimed
    applications run first, then ``chain`` applications are captured in
    one CUDA graph, and the time is the median over ``repeats`` replays,
    each between two CUDA events, over ``chain``: a replay puts the
    card's work back to back with no host between launches, so a small
    shard is timed at the card's pace and not at the host's.  On a CPU
    device the chain runs eagerly under the host clock (the tests).

    Times are cached in memory and, with ``cache_path``, in a JSON file
    whose keys carry :attr:`protocol`, a tag of this package's and of the
    card (``torch2|<device name>|``), so that no time taken on another
    card or by the JAX package's protocol is read as this card's.
    Entries under other tags are kept on save and never read.

    An op whose ``local_clone`` is None (a grid the clone cannot realize:
    the ring, a head or expert split, an uneven split, and the ops
    without one) takes the analytic cost scaled by its kind's anchor:
    the median ratio of measured to analytic time over its kind's
    measured shards (``anchors`` / ``anchors_path`` seed them).  Such
    estimates are never cached under a lookup key; :attr:`estimated`
    counts the distinct shards estimated.  A measurement that fails
    raises."""

    #: the protocol's version: bumped when the timing protocol changes
    #: (2: the chain is one CUDA graph's replay)
    PROTOCOL = 2
    #: untimed applications before the chain is captured
    WARMUP = 2

    def __init__(self, cache_path: Optional[str] = None,
                 fallback: Optional[AnalyticCostModel] = None,
                 repeats: int = 5, chain: int = 8, save_every: int = 32,
                 dtype: str = "float32", device="cuda",
                 anchors: Optional[Dict[str, float]] = None,
                 anchors_path: Optional[str] = None):
        import torch

        from flexflow_tpu_torch.machine import resolve_device

        self.device = resolve_device(device)
        self.cache_path = cache_path
        self.repeats = max(1, repeats)
        self.chain = max(1, chain)
        self.dtype = dtype
        self.fallback = fallback or AnalyticCostModel(dtype=dtype)
        self.save_every = save_every
        kind = torch.cuda.get_device_name(self.device) \
            if self.device.type == "cuda" else "cpu"
        self.protocol = f"torch{self.PROTOCOL}|{kind}|"
        self._dirty = 0
        self._kind_ratios: Dict[str, list] = {}
        if anchors_path:
            with open(anchors_path) as f:
                loaded = json.load(f)
            for k, v in loaded.get("kind_anchors", loaded).items():
                self._kind_ratios[str(k)] = [float(v)]
        for k, v in (anchors or {}).items():
            self._kind_ratios[str(k)] = [float(v)]
        # keys that already gave a ratio: a cache hit of an identical
        # shape must not weigh the kind's median twice
        self._kind_seen: set = set()
        self._cache: Dict[str, float] = {}
        self._foreign: Dict[str, float] = {}
        self.cache_hits = 0
        self.cache_misses = 0
        #: shards timed on the device and their seconds in all
        self.measured = 0
        self.measure_s = 0.0
        # the keys of shards answered by an analytic estimate (the
        # search's second pass asks for each again)
        self._estimated_keys: set = set()
        if cache_path and os.path.exists(cache_path):
            with open(cache_path) as f:
                loaded = json.load(f)
            for k, v in loaded.items():
                (self._cache if k.startswith(self.protocol)
                 else self._foreign)[k] = v

    @property
    def estimated(self) -> int:
        """The distinct shards answered by an analytic estimate."""
        return len(self._estimated_keys)

    def anchors(self) -> Dict[str, float]:
        """The median measured / analytic ratio per op kind."""
        return {k: sorted(v)[len(v) // 2]
                for k, v in sorted(self._kind_ratios.items()) if v}

    def _save(self, force: bool = False):
        if not self.cache_path or (not force
                                   and self._dirty < self.save_every):
            return
        merged = dict(self._foreign)
        merged.update(self._cache)
        # a temporary file beside the cache and a rename: a crash mid-write
        # leaves the old cache whole
        dest = os.path.abspath(self.cache_path)
        os.makedirs(os.path.dirname(dest), exist_ok=True)
        fd, tmp = tempfile.mkstemp(dir=os.path.dirname(dest),
                                   prefix=os.path.basename(dest) + ".",
                                   suffix=".tmp")
        try:
            with os.fdopen(fd, "w") as f:
                json.dump(merged, f, indent=1, sort_keys=True)
            os.replace(tmp, dest)
        except BaseException:
            try:
                os.unlink(tmp)
            except OSError:
                pass
            raise
        self._dirty = 0

    def flush(self):
        self._save(force=True)

    def _note_ratio(self, key: str, op: Op, t: float, analytic: float):
        if key not in self._kind_seen:
            self._kind_seen.add(key)
            self._kind_ratios.setdefault(type(op).__name__, []).append(
                t / max(analytic, 1e-12))

    def op_cost(self, op: Op, pc: ParallelConfig) -> float:
        key = self._key(op, pc)
        if key in self._cache:
            self.cache_hits += 1
            t = self._cache[key]
            # cached times anchor their kind too, once per key
            self._note_ratio(key, op, t, self.fallback.op_cost(op, pc))
            return t
        self.cache_misses += 1
        local = op.local_clone(pc)
        if local is None:
            # the analytic cost on this kind's measured scale; an estimate
            # is never served as a measurement later, nor anchors a kind
            t = self.fallback.op_cost(op, pc)
            ratios = self._kind_ratios.get(type(op).__name__)
            if ratios:
                t *= sorted(ratios)[len(ratios) // 2]
            self._foreign[f"estimate|{key}"] = t
            self._estimated_keys.add(key)
            return t
        t = self._measure(local)
        if not t > 0.0:
            raise RuntimeError(f"measured cost of {type(op).__name__} "
                               f"{op.name!r} at grid {pc.dims} is {t!r}")
        self._note_ratio(key, op, t, self.fallback.op_cost(op, pc))
        self._cache[key] = t
        self._dirty += 1
        self._save()
        return t

    def _key(self, op: Op, pc: ParallelConfig) -> str:
        shapes = [t.shape for t in op.inputs] + [op.output.shape]
        sig = op.cost_signature()
        extra = f"|{sig}" if sig else ""
        dt = "" if self.dtype == "float32" else f"|{self.dtype}"
        return (f"{self.protocol}{type(op).__name__}|{shapes}|{pc.dims}"
                f"{extra}{dt}")

    def _measure(self, local: Op) -> float:
        """Seconds of one forward + gradient of ``local`` on the device."""
        import time

        import torch

        from flexflow_tpu_torch.ops.base import torch_dtype

        dev = self.device
        gen = torch.Generator(device=dev)
        gen.manual_seed(0)
        params = {k: v.requires_grad_() for k, v in
                  local.init_params(gen, dev).items()}
        state = local.init_state(dev)
        xs = [torch.zeros(t.shape, dtype=torch.int32, device=dev)
              if t.dtype == "int32" else
              torch.ones(t.shape, dtype=torch_dtype(self.dtype), device=dev,
                         requires_grad=True)
              for t in local.inputs]
        wrt = list(params.values()) + [x for x in xs if x.requires_grad]

        def apply():
            res, _ = local.forward(params, state, xs, True)
            y = res[0] if isinstance(res, tuple) else res
            loss = (y.float() ** 2).sum()
            if wrt:
                torch.autograd.grad(loss, wrt)

        def chain():
            for _ in range(self.chain):
                apply()

        if dev.type == "cuda":
            # warm-up on a side stream, then the chain captured once
            side = torch.cuda.Stream(dev)
            side.wait_stream(torch.cuda.current_stream(dev))
            with torch.cuda.stream(side):
                for _ in range(self.WARMUP):
                    apply()
            torch.cuda.current_stream(dev).wait_stream(side)
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph):
                chain()
            run = graph.replay
        else:
            for _ in range(self.WARMUP):
                apply()
            run = chain
        times = []
        for _ in range(self.repeats):
            if dev.type == "cuda":
                start = torch.cuda.Event(enable_timing=True)
                stop = torch.cuda.Event(enable_timing=True)
                start.record()
                run()
                stop.record()
                stop.synchronize()
                times.append(start.elapsed_time(stop) * 1e-3 / self.chain)
            else:
                t0 = time.perf_counter()
                run()
                times.append((time.perf_counter() - t0) / self.chain)
        times.sort()
        self.measured += 1
        self.measure_s += sum(times) * self.chain
        return times[len(times) // 2]
