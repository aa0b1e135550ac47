"""Per-fusion residual account, ``report fusions`` (PyTorch port of
``flexflow_tpu/obs/fusions.py``).

The roofline profile (``utils/hlo_profile.roofline_report``, written by
``apps.profile``) ends at one number: the step runs at ``of_ceiling`` of
its floor, leaving ``seconds_per_step - step_floor_seconds`` of compute
residual that the class split attributes only coarsely.  This module
prices each profiled row against the card's roofline
(``HopperChipPerf``) and produces a ranked account of that residual with
the contract of ``obs.budget.build_step_budget``: row allocations are
clamped to the remaining residual, the remainder is an explicit
``unattributed`` bucket, and rows + unattributed sum to the residual
exactly.  Raw (pre-clamp) excesses are kept per row.

Per-row floors, by class (``utils/hlo_profile.classify``):

* ``vpu`` / ``raw`` with a root line: the HBM byte floor of the root's
  output shape, the input volume estimated from the root's operator (an
  ``add`` reads twice what it writes, a ``select`` ~2.25x; any other
  operator is priced at its output volume, a stated lower bound).  The
  port's rows take the launching aten operator's first input shape as
  the output's.
* ``mxu``: ``measured * mxu_eff_during_matmul`` (the profile's own
  flops / (peak * mxu ms)), what the row would take at the full rate.
* the library's max-pool backward (``aten::max_pool2d_with_indices_
  backward``, the counterpart of XLA's ``select_and_scatter``): the
  port's kernel 7 against it, measured on the card, prices the floor
  (``kernel_ratio``), and the row names the kernel and its predicted win.
* a row of the port's own ``csrc/`` kernels names the kernel
  (``kernel``) and is priced at its measured time: the trace says
  nothing of its bytes.

Every row carries a verdict: ``fusable`` (elementwise excess a fused
kernel could fold into its producer or consumer), ``pallas_worthy``
(an unfused op with a hand-written kernel route; the name is JAX's) or
``irreducible`` (at its floor, or tensor-core utilization no byte
rewrite recovers).

Torch-free: it reads a profile's JSON.
"""

from __future__ import annotations

import re
from typing import Dict, List, Optional

_DT = {"f32": 4, "bf16": 2, "f16": 2, "s32": 4, "u32": 4, "s8": 1,
       "u8": 1, "pred": 1, "f64": 8, "s64": 8}

_SHAPE = re.compile(r"([a-z0-9]+)\[([0-9,]*)\]")
_OPCODE = re.compile(r"([a-z][a-z0-9_\-]*)\(")

# input volume as a multiple of output volume, by root opcode.  Stated
# estimates: a 2-operand elementwise op reads 2x what it writes; select
# reads two branches + a pred plane (~0.25x at 1 byte vs bf16/f32);
# roots whose operand set the line does not reveal (tuple, reduce,
# convert chains) are priced at output volume — a LOWER bound, so their
# excess is an upper bound and the verdict stays conservative.
_IN_MULT = {"add": 2.0, "subtract": 2.0, "multiply": 2.0, "divide": 2.0,
            "maximum": 2.0, "minimum": 2.0, "select": 2.25,
            "select-n": 2.25, "select_n": 2.25}

# the port's kernel 7 (maxpool_bwd) against the library's
# max_pool2d_with_indices_backward, summed over an Inception-v3 training
# step at batch 256, bf16 (chip_smoke.py's pool phase on an NVIDIA H100
# 80GB HBM3 at 700 W, PERF.md section 6): the floor of a library
# max-pool backward row
KERNEL_RATIO = 0.9041 / 8.4013

#: the library's max-pool backward, the row the ratio prices
_POOL_BWD = ("aten::max_pool2d_with_indices_backward",
             "select_and_scatter")

# balanced-tree gradient fanout (ops/fanout.py): an n-way branch sum as
# one (n+1)-operand fusion moves (n+1) units vs the add_any chain's
# 3(n-1); at the inception blocks' n=4 that is 5/9 of the traffic
_FANOUT_TRAFFIC_RATIO = 5.0 / 9.0

SCHEMA = "fusion_account_v1"


def _root_bytes(root: str) -> Optional[Dict[str, float]]:
    """Output bytes + estimated input bytes of a profile row's root HLO
    line, or None when the line carries no parseable shapes."""
    op = None
    pos = len(root)
    m = _OPCODE.search(root.split("=", 1)[-1])
    if m:
        op = m.group(1)
        pos = root.index(m.group(0), root.find("=") + 1)
    out = 0
    for sm in _SHAPE.finditer(root[:pos]):
        dt, dims = sm.group(1), sm.group(2)
        if dt not in _DT:
            continue
        n = 1
        for d in dims.split(","):
            if d:
                n *= int(d)
        out += n * _DT[dt]
    if out <= 0:
        return None
    mult = _IN_MULT.get(op or "", 1.0)
    return {"out_bytes": float(out), "in_bytes": float(out) * mult,
            "opcode": op or "", "lower_bound": op not in _IN_MULT}


def _price_row(row: dict, mxu_eff: float, hbm_bw: float,
               kernel_ratio: float = KERNEL_RATIO,
               kernel_name: str = "maxpool_bwd") -> dict:
    """floor_ms + floor_source (+ kernel/rewrite annotation) for one
    profiled row ({name, ms, class, root, kernel})."""
    name, ms = row["name"], float(row["ms"])
    cls, root = row.get("class", ""), row.get("root", "") or ""
    out = {"name": name, "class": cls, "measured_ms": ms}
    if cls == "mxu":
        out["floor_ms"] = ms * mxu_eff
        out["floor_source"] = "mxu_flops"
        out["note"] = (f"at {mxu_eff:.0%} MXU during matmul; excess is "
                       f"matrix-unit utilization, not HBM traffic")
        return out
    if name.startswith(_POOL_BWD):
        out["floor_ms"] = ms * kernel_ratio
        out["floor_source"] = "kernel_measured"
        out["kernel"] = kernel_name
        out["predicted_win_ms"] = round(ms * (1 - kernel_ratio), 3)
        out["note"] = ("unfused pool backward; floor = measured "
                       f"{kernel_name} ratio ({kernel_ratio:.2f}x)")
        return out
    if row.get("kernel"):
        # the port's own kernel: the trace carries no bytes to price
        out["floor_ms"] = ms
        out["floor_source"] = "csrc_kernel"
        out["kernel"] = row["kernel"]
        out["predicted_win_ms"] = 0.0
        out["note"] = f"the port's {row['kernel']} kernel, unpriced"
        return out
    priced = _root_bytes(root)
    if priced is None:
        # no shapes on the root line: price at measured (excess 0) and
        # say so rather than invent a floor
        out["floor_ms"] = ms
        out["floor_source"] = "unpriced"
        out["note"] = "root line carries no parseable shapes"
        return out
    bw_ms = (priced["in_bytes"] + priced["out_bytes"]) / hbm_bw * 1e3
    out["floor_ms"] = min(bw_ms, ms)
    out["floor_source"] = ("root_bytes_lower_bound"
                           if priced["lower_bound"] else "root_bytes")
    out["excess_bytes"] = round(max(0.0, ms - out["floor_ms"])
                                / 1e3 * hbm_bw)
    # only when the root DEFINES the add_any (the fusion IS the
    # accumulation chain), not when it merely reads one as an operand
    if root.lstrip().startswith("%add_any"):
        out["rewrite"] = "grad_fanout"
        out["predicted_win_ms"] = round(
            max(0.0, ms - out["floor_ms"]) * (1 - _FANOUT_TRAFFIC_RATIO),
            3)
        out["note"] = ("branch-gradient add_any chain; grad_fanout tree "
                       f"moves {_FANOUT_TRAFFIC_RATIO:.2f}x the bytes")
    return out


def _verdict(row: dict) -> str:
    tol = max(0.05, 0.05 * row["measured_ms"])
    if row["measured_ms"] - row["floor_ms"] <= tol:
        return "irreducible"
    if row["class"] == "mxu":
        return "irreducible"
    if row["class"] == "raw" or "kernel" in row:
        return "pallas_worthy"
    return "fusable"


def fusion_account(profile: dict, perf=None, top_n: int = 10,
                   kernel_ratio: float = KERNEL_RATIO,
                   kernel_name: str = "maxpool_bwd") -> dict:
    """The ranked residual account for one roofline profile dict
    (``apps.profile``'s report, the JAX package's
    ``examples/profiles/*_roofline.json`` schema); ``perf`` defaults to
    ``HopperChipPerf``, ``kernel_ratio`` and ``kernel_name`` price a
    library pool-backward row.  Rows are the ``top_n``
    largest pre-clamp excesses; allocation is greedy in that order and
    clamped to the remaining residual (clamped rows listed), and
    ``rows[*].excess_ms + unattributed_ms == residual_ms`` exactly."""
    if perf is None:
        from flexflow_tpu_torch.sim.cost_model import HopperChipPerf

        perf = HopperChipPerf()
    wall_ms = float(profile["seconds_per_step"]) * 1e3
    floor_ms = float(profile["step_floor_seconds"]) * 1e3
    residual_ms = max(0.0, wall_ms - floor_ms)
    mxu_eff = float(profile.get("mxu_eff_during_matmul") or 1.0)
    priced = [_price_row(r, mxu_eff, perf.hbm_bandwidth, kernel_ratio,
                         kernel_name)
              for r in profile.get("top_ops", [])]
    for p in priced:
        p["excess_ms_raw"] = round(
            max(0.0, p["measured_ms"] - p["floor_ms"]), 3)
        p["floor_ms"] = round(p["floor_ms"], 3)
        p["verdict"] = _verdict(p)
    priced.sort(key=lambda p: p["excess_ms_raw"], reverse=True)
    rows, clamped = priced[:top_n], []
    remaining = residual_ms
    for p in rows:
        alloc = min(p["excess_ms_raw"], remaining)
        if alloc < p["excess_ms_raw"] - 1e-9:
            clamped.append(p["name"])
        p["excess_ms"] = alloc
        p["share_of_residual"] = (alloc / residual_ms
                                  if residual_ms else 0.0)
        remaining -= alloc
    attributed = sum(p["excess_ms"] for p in rows)
    return {"schema": SCHEMA, "model": profile.get("model", ""),
            "bound": profile.get("bound", ""),
            "wall_ms": wall_ms, "floor_ms": floor_ms,
            "residual_ms": residual_ms, "mxu_eff": mxu_eff,
            "rows": rows, "attributed_ms": attributed,
            "unattributed_ms": remaining, "clamped": clamped,
            "top3_frac": (sum(p["excess_ms"] for p in rows[:3])
                          / residual_ms if residual_ms else 0.0)}


def check_account(account: dict, tol_frac: float = 0.01) -> List[str]:
    """The fusion-smoke invariants: rows + unattributed sum to the
    residual within ``tol_frac``, and every row is verdicted (no
    ``unknown``).  Returns problem strings; [] means the account holds."""
    problems = []
    total = (sum(r["excess_ms"] for r in account["rows"])
             + account["unattributed_ms"])
    ref = max(account["residual_ms"], 1e-9)
    if abs(total - account["residual_ms"]) > tol_frac * ref:
        problems.append(
            f"rows+unattributed = {total:.3f} ms != residual "
            f"{account['residual_ms']:.3f} ms")
    for r in account["rows"]:
        if r.get("verdict") not in ("fusable", "pallas_worthy",
                                    "irreducible"):
            problems.append(f"row {r['name']} verdict "
                            f"{r.get('verdict')!r} is not a verdict")
    return problems


def residual_top_frac(profile: dict, k: int = 3, **kw) -> float:
    """Share of the compute residual held by the account's top-``k``
    rows."""
    acct = fusion_account(profile, **kw)
    ref = acct["residual_ms"]
    return (sum(r["excess_ms"] for r in acct["rows"][:k]) / ref
            if ref else 0.0)


def render_account(account: dict) -> str:
    """Fixed-width text table (``report fusions`` default output)."""
    lines = [
        f"fusion residual account — {account['model'] or '?'} "
        f"({account['bound'] or '?'}-bound): wall {account['wall_ms']:.2f}"
        f" ms, floor {account['floor_ms']:.2f} ms, residual "
        f"{account['residual_ms']:.2f} ms",
        f"{'fusion':<28}{'class':<6}{'meas':>8}{'floor':>8}"
        f"{'excess':>8}{'share':>7}  verdict"]
    for r in account["rows"]:
        extra = ""
        if r.get("kernel"):
            extra = (f"  [{r['kernel']} "
                     f"-{r.get('predicted_win_ms', 0):.2f} ms]")
        elif r.get("rewrite"):
            extra = (f"  [{r['rewrite']} "
                     f"-{r.get('predicted_win_ms', 0):.2f} ms]")
        clamp = "*" if r["name"] in account["clamped"] else " "
        lines.append(
            f"{r['name']:<28}{r['class']:<6}{r['measured_ms']:>8.3f}"
            f"{r['floor_ms']:>8.3f}{r['excess_ms']:>7.3f}{clamp}"
            f"{r['share_of_residual']:>7.1%}  {r['verdict']}{extra}")
    lines.append(
        f"{'unattributed (beyond top rows)':<42}"
        f"{account['unattributed_ms']:>8.3f}"
        f"{account['unattributed_ms'] / account['residual_ms']:>8.1%}"
        if account["residual_ms"] else "unattributed: 0")
    if account["clamped"]:
        lines.append(f"  * clamped to remaining residual: "
                     f"{', '.join(account['clamped'])}")
    return "\n".join(lines)
