"""Per-op device times of a training step from a ``torch.profiler``
trace, classified by the kind of work, plus the roofline ceiling
analysis (PyTorch port of ``flexflow_tpu/utils/hlo_profile.py``; the
name is kept for the report keys and ``report fusions``, which read it).

The JAX package reads an XProf trace of its one compiled program and
classifies each fusion against the optimized HLO.  The port runs eager
PyTorch: its device time is CUDA kernels, each launched by an aten
operator (or by the port's own wrappers, ``csrc/``).  So:

* :func:`device_op_times` reads the Chrome trace ``utils.profiling.
  trace`` writes (``--trace-dir``; ``record_shapes`` on), sums every
  CUDA kernel event and attributes it to the aten operator that
  launched it, linked by the trace's ``External id`` (its shapes come
  from the operator's ``Input Dims``: kernel events carry none).  The
  port's own kernels are named as ``chip_smoke.py`` names them
  (``CSRC_KERNELS``).  Times are per step and per card.
* :func:`classify_ops` sorts the rows into JAX's three classes:
  ``mxu`` for tensor-core work (cuBLAS, cuDNN and CUTLASS GEMM and
  convolution kernels, and the port's ``mma.sync`` kernels, flash
  attention and the fused cross-entropy), ``raw`` for the port's other
  ``csrc/`` kernels (pools, BatchNorm: the counterparts of the Pallas
  kernels and of XLA's unfusable ops), and ``vpu`` for the rest
  (elementwise work, reductions, copies).  A row of a ``csrc/`` kernel
  carries ``kernel``, its name.
* :func:`roofline_report`: the step's FLOPs are ``FFModel.step_flops``
  (as ``--profiling`` reckons them), its bytes the analytic cost model's
  per-op bytes summed over the forward and backward (labelled
  ``bytes_source: "modeled"``: there is no compiled program to ask),
  and the peaks ``HopperChipPerf``'s at the compute dtype.
"""

from __future__ import annotations

import glob
import json
import os
import re
from collections import defaultdict
from typing import Dict, List, Optional

#: the port's own kernels (``csrc/*.cu``): kernel function -> the name
#: ``chip_smoke.py`` and the launch counters give it
CSRC_KERNELS = {
    "flash_fwd_kernel": "flash_attention_fwd",
    "flash_bwd_dkv_kernel": "flash_attention_bwd_dkv",
    "flash_bwd_dq_kernel": "flash_attention_bwd_dq",
    "ce_fwd_kernel": "fused_ce_fwd",
    "ce_fwd_combine_kernel": "fused_ce_fwd_combine",
    "ce_bwd_dx_kernel": "fused_ce_bwd_dx",
    "ce_bwd_dx_sum_kernel": "fused_ce_bwd_dx_sum",
    "ce_bwd_dw_kernel": "fused_ce_bwd_dw",
    "maxpool_fwd_kernel": "maxpool_fwd",
    "maxpool_bwd_kernel": "maxpool_bwd",
    "avgpool_bwd_kernel": "avgpool_bwd",
    "bn_act_fwd_kernel": "bn_act_fwd",
    "bn_act_bwd_kernel": "bn_act_bwd",
    "bn_act_sum_kernel": "bn_act_bwd_sum",
}

#: the port's kernels that run on the tensor cores (``mma.sync``)
MMA_KERNELS = frozenset(n for k, n in CSRC_KERNELS.items()
                        if k.startswith(("flash_", "ce_")))

#: substrings of library kernel names that run GEMMs or convolutions on
#: the tensor cores
_TENSOR_CORE = ("gemm", "xmma", "cutlass", "cudnn", "cublas", "nvjet",
                "conv", "fprop", "dgrad", "wgrad", "implicit_convolve",
                "s1688", "s16816", "h1688", "h16816", "sm90_", "sm80_")

_DT = {"float": "f32", "c10::BFloat16": "bf16", "c10::Half": "f16",
       "double": "f64", "int": "s32", "long int": "s64", "bool": "pred",
       "unsigned char": "u8", "signed char": "s8"}

_KERNEL_FN = re.compile(r"\b([A-Za-z_]\w*_kernel)\b")


def trace_path(path: str) -> str:
    """``path`` itself, or the newest ``*.json`` trace under it."""
    if os.path.isfile(path):
        return path
    files = sorted(glob.glob(os.path.join(path, "**", "*.json"),
                             recursive=True), key=os.path.getmtime)
    if not files:
        raise FileNotFoundError(f"no .json trace under {path}")
    return files[-1]


def csrc_kernel(name: str) -> Optional[str]:
    """The port's name of a ``csrc/`` kernel event, None for any other."""
    for m in _KERNEL_FN.finditer(name):
        if m.group(1) in CSRC_KERNELS:
            return CSRC_KERNELS[m.group(1)]
    return None


def _is_shape(d) -> bool:
    return isinstance(d, list) and bool(d) \
        and all(isinstance(x, (int, float)) for x in d)


def _dims(d) -> str:
    """One input's ``Input Dims`` entry as text: a shape ``8x16``, a
    tensor list ``(8x16,8x16)``, a scalar nothing."""
    if _is_shape(d):
        return "x".join(str(int(x)) for x in d)
    if isinstance(d, list) and d:
        return "(" + ",".join(_dims(x) for x in d) + ")"
    return ""


def _root(op: str, dims, types) -> str:
    """An HLO-like root line of an aten operator from its input shapes
    (``bf16[256,35,35,288] add(...)``): the output taken as the first
    input's shape (a tensor input's, not a list's), which
    ``obs/fusions.py`` prices bytes from."""
    base = op.split("::")[-1].rstrip("_")
    if not dims or not _is_shape(dims[0]):
        return f"{base}()"
    dt = _DT.get((types or [""])[0], "f32")
    return (f"{dt}[{','.join(str(int(d)) for d in dims[0])}] "
            f"{base}({', '.join(str(d) for d in dims if _is_shape(d))})")


def device_ops(path: str, steps: int = 1) -> List[dict]:
    """Rows ``{"name", "ms", "kernels", "kernel", "root"}`` of the trace
    at ``path`` (a file or a directory of them): device ms per step
    (over ``steps`` steps) by launching operator and input shapes, the
    port's kernels by their own names.  Averaged over the trace's cards,
    as JAX's per-chip times are."""
    with open(trace_path(path)) as f:
        tr = json.load(f)
    events = tr.get("traceEvents", tr) if isinstance(tr, dict) else tr
    ops: Dict[int, dict] = {}
    for e in events:
        if e.get("ph") == "X" and e.get("cat") in ("cpu_op", "operator"):
            ext = (e.get("args") or {}).get("External id")
            if ext is not None:
                ops[ext] = e
    rows: Dict[str, dict] = {}
    cards = set()
    for e in events:
        if e.get("ph") != "X" or e.get("cat") not in ("kernel", "gpu_op"):
            continue
        args = e.get("args") or {}
        cards.add(args.get("device", e.get("pid")))
        kname = e.get("name", "")
        own = csrc_kernel(kname)
        op = ops.get(args.get("External id"))
        if own is not None:
            key, root = own, f"{own}()"
        elif op is not None:
            oa = op.get("args") or {}
            dims, types = oa.get("Input Dims") or [], oa.get("Input type")
            shape = ",".join(t for t in map(_dims, dims) if t)
            key = f"{op['name']}[{shape}]"
            root = _root(op["name"], dims, types)
        else:
            key, root = kname[:80], ""
        row = rows.setdefault(key, {"name": key, "ms": 0.0, "kernels": [],
                                    "kernel": own, "root": root})
        row["ms"] += float(e.get("dur", 0.0)) / 1e3
        if kname not in row["kernels"]:
            row["kernels"].append(kname)
    n = max(steps, 1) * max(len(cards), 1)
    for row in rows.values():
        row["ms"] /= n
    return sorted(rows.values(), key=lambda r: -r["ms"])


def device_op_times(path: str, steps: int = 1) -> Dict[str, float]:
    """``{row name: device ms per step}`` of the trace at ``path``."""
    return {r["name"]: r["ms"] for r in device_ops(path, steps)}


def classify(row: dict) -> str:
    """``mxu``, ``raw`` or ``vpu`` of one :func:`device_ops` row."""
    if row.get("kernel") is not None:
        return "mxu" if row["kernel"] in MMA_KERNELS else "raw"
    names = " ".join(row.get("kernels") or [row["name"]]).lower()
    return "mxu" if any(t in names for t in _TENSOR_CORE) else "vpu"


def classify_ops(rows: List[dict]):
    """``[(ms, class, name, root)]`` by time, descending, and the
    per-class totals, from :func:`device_ops` rows (the JAX function's
    return shape)."""
    out = []
    totals: Dict[str, float] = defaultdict(float)
    for row in sorted(rows, key=lambda r: -r["ms"]):
        c = classify(row)
        totals[c] += row["ms"]
        out.append((row["ms"], c, row["name"], row.get("root", "")))
    return out, dict(totals)


def kernel_launches(path: str, steps: int = 1) -> Dict[str, float]:
    """Launches per step of each ``csrc/`` kernel in the trace at
    ``path``."""
    with open(trace_path(path)) as f:
        tr = json.load(f)
    events = tr.get("traceEvents", tr) if isinstance(tr, dict) else tr
    out: Dict[str, float] = defaultdict(float)
    for e in events:
        if e.get("ph") == "X" and e.get("cat") in ("kernel", "gpu_op"):
            own = csrc_kernel(e.get("name", ""))
            if own is not None:
                out[own] += 1.0 / max(steps, 1)
    return dict(out)


def modeled_step_bytes(model) -> float:
    """The analytic cost model's bytes of one training step on one
    device: each op's inputs, outputs and parameters streamed three
    times (forward read, the gradient's accumulation, the input
    gradient's re-read), summed over the ops (``AnalyticCostModel.
    op_cost`` at one part)."""
    from flexflow_tpu_torch.sim.cost_model import param_byte_scale

    scale = param_byte_scale(model.config)
    total = 0.0
    for op in model.layers:
        io = sum(t.size() for t in op.inputs) \
            + sum(t.size() for t in op.all_outputs())
        total += 3.0 * (4.0 * io + op.param_bytes() * scale)
    return total


def roofline_report(model, seconds_per_step: float,
                    class_totals: Optional[Dict[str, float]] = None,
                    perf=None, n_devices: int = 1,
                    dtype: Optional[str] = None) -> Dict:
    """The roofline ceiling of one training step of ``model``
    (``flexflow_tpu/utils/hlo_profile.py:120``): arithmetic intensity
    against the card's balance point, the step-time floor, the MFU
    ceiling that floor implies and how far the measured step is from it
    (``of_ceiling``).  FLOPs are ``step_flops``, bytes
    :func:`modeled_step_bytes`, the peak ``perf`` (``HopperChipPerf``)
    at the compute dtype."""
    from flexflow_tpu_torch.sim.cost_model import HopperChipPerf

    perf = perf or HopperChipPerf()
    dtype = dtype or model.config.compute_dtype
    flops = float(model.step_flops())
    bytes_ = modeled_step_bytes(model)
    peak = perf.flops_rate(dtype) * max(n_devices, 1)
    hbm = perf.hbm_bandwidth * max(n_devices, 1)
    intensity = flops / bytes_ if bytes_ else float("inf")
    balance = peak / hbm
    floor_s = max(flops / peak, bytes_ / hbm)
    sec = seconds_per_step
    out = {
        "seconds_per_step": sec,
        "flops_per_step": flops,
        "bytes_per_step": bytes_,
        "bytes_source": "modeled",
        "arithmetic_intensity_flop_per_byte": intensity,
        "chip_balance_flop_per_byte": balance,
        "bound": "hbm" if intensity < balance else "mxu",
        "step_floor_seconds": floor_s,
        "mfu": flops / sec / peak if sec else None,
        "mfu_ceiling": flops / floor_s / peak if floor_s else None,
        "hbm_utilization": bytes_ / sec / hbm if sec else None,
        "of_ceiling": floor_s / sec if sec else None,
        "peak_flops": peak,
    }
    if class_totals:
        out["class_ms"] = {k: round(v, 3)
                           for k, v in sorted(class_totals.items())}
        mxu_ms = class_totals.get("mxu", 0.0)
        if mxu_ms:
            out["mxu_eff_during_matmul"] = flops / (mxu_ms / 1e3) / peak
    return out


def top_rows(rows: List[dict], top_n: int) -> List[dict]:
    """The report's ``top_ops``: ``{"ms", "class", "name", "root"}`` (and
    ``kernel`` for a ``csrc/`` kernel) of the ``top_n`` longest rows."""
    out = []
    for row in sorted(rows, key=lambda r: -r["ms"])[:top_n]:
        entry = {"ms": round(row["ms"], 3), "class": classify(row),
                 "name": row["name"], "root": (row.get("root") or "")[:160]}
        if row.get("kernel"):
            entry["kernel"] = row["kernel"]
        out.append(entry)
    return out

