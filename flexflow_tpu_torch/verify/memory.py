"""Static per-device HBM-fit prediction for a (model, strategy) plan
(PyTorch port of ``flexflow_tpu/verify/memory.py``).

The searcher's per-candidate check (``sim/search.py shard_hbm_bytes``)
prices ONE op's worst shard; a plan can pass it op-by-op and still OOM
because residency is a WHOLE-PROGRAM property: every layer's saved
activations are live at the backward's start, and the optimizer state
rides along for the entire step.  This module predicts the peak
resident bytes of each device from the plan alone — no compile, no
simulator — with the same dtype conventions the executor uses
(model.py mixed-precision: params stored in ``config.param_dtype``,
float32 momentum + float32 masters in the two-level opt state).
It predicts what the JAX package predicts, with the capacity of the
perf object (the H100's 80 GB by default).

Accounting, per device:

  * params       — ``Op.param_bytes()`` (float32 convention) x
                   ``param_byte_scale`` x the grid's param-shard
                   fraction, once per ``param_key`` (shared weights);
  * opt state    — float32 momentum (1x pb) plus, under mixed
                   precision, the float32 masters (another 1x pb),
                   mirroring ``FFModel.init_opt_state``;
  * grads        — one cotangent per param at storage dtype (an XLA
                   temp live through the optimizer update);
  * activations  — the high-water residual set: every op's per-device
                   output tile (``sim/search.op_geometry``) at compute
                   dtype is saved for the backward, so the sum — not
                   the max — is live when the backward starts;
  * inputs       — the batch shard each device holds;
  * donation     — the JAX executor donates params+opt into the step;
                   ``donated=False`` adds the double-buffered updated
                   copies back.

Shard-to-device attribution follows the JAX package's: a full-machine
canonical grid puts shard ``i`` on device ``devices[i]``; parameters
of sub-machine or permuted lists are charged at the same shard fraction
on EVERY device (an upper bound, exact for canonical grids).
"""

from __future__ import annotations

import math
from typing import Dict, List, Mapping, Optional

from flexflow_tpu_torch.ops.base import Op
from flexflow_tpu_torch.sim import cost_model
from flexflow_tpu_torch.sim.cost_model import (dtype_bytes, param_byte_scale,
                                               param_shard_fraction)
from flexflow_tpu_torch.strategy import ParallelConfig

#: multiplier on the activation residual term covering the backward's
#: transient cotangent chain on top of the saved forward activations
#: (the JAX package's, calibrated against XLA's compiled peaks; the
#: port's peaks are not measured against it yet)
ACTIVATION_FACTOR = 2.0


def _effective_pc(op: Op, strategy: Optional[Mapping[str, ParallelConfig]]):
    """The pc this plan runs ``op`` under: the strategy's entry when one
    names the op (and matches its grid rank — rank mismatches are the
    plan checker's ``rank`` finding, not a memory question), else the
    op's own config."""
    if strategy is not None:
        pc = strategy.get(op.name)
        if pc is not None and len(pc.dims) == len(op.AXIS_NAMES):
            return pc
    return op.pc


def _per_device_out_tiles(op: Op, pc: ParallelConfig,
                          num_devices: int) -> Dict[int, int]:
    """{device: output-tile elements} for one op under ``pc``.  Falls
    back to an even split over the listed devices for op kinds the
    geometry table does not know."""
    from flexflow_tpu_torch.sim.search import _rect_vol, op_geometry

    tiles: Dict[int, int] = {}
    try:
        pts = op_geometry(op, pc)
    except Exception:
        per = sum(t.size() for t in op.all_outputs()) / max(pc.num_parts, 1)
        for d in set(pc.devices):
            if 0 <= d < num_devices:
                tiles[d] = tiles.get(d, 0) + int(per)
        return tiles
    for dev, out_rect, _ins in pts:
        if 0 <= dev < num_devices:
            tiles[dev] = tiles.get(dev, 0) + _rect_vol(out_rect)
    return tiles


def device_memory_report(model, strategy=None, machine=None, *,
                         hbm_capacity: Optional[float] = None,
                         donated: bool = True,
                         forward_only: bool = False,
                         kv_cache_bytes: float = 0.0) -> dict:
    """Predict each device's peak resident HBM bytes for ``model`` under
    ``strategy`` (op name -> ParallelConfig overrides; None = the pcs
    the model was built with).

    ``forward_only=True`` prices the SERVING residency instead of the
    training step: no optimizer state, no gradient cotangents, and the
    activation term drops to factor 1.0 — nothing is saved for a
    backward, only the live inter-op tiles — while ``kv_cache_bytes``
    (per device, from serve/kv_cache.py) is added as its own bucket.
    Under disaggregated serving the ring cache lives on the DECODE
    pool only, so verify/plan.py passes ``kv_cache_bytes=0`` when
    vetting a prefill-phase strategy (``serve.phase == "prefill"``).

    Returns ``{"per_device": {dev: {params, opt, grads, activations,
    inputs, kv_cache, total}}, "capacity": bytes, "over": [(dev, total),
    ...], "assumptions": {...}}`` — ``over`` lists devices whose
    predicted peak exceeds ``hbm_capacity`` (default: the
    ``HopperChipPerf`` capacity).
    """
    machine = machine or getattr(model, "machine", None)
    n_dev = machine.num_devices if machine is not None else 1
    config = getattr(model, "config", None)
    pscale = param_byte_scale(config)
    mixed = pscale != 1.0
    act_bytes = dtype_bytes(
        getattr(config, "compute_dtype", "float32") or "float32")
    if hbm_capacity is None:
        hbm_capacity = cost_model.HopperChipPerf().hbm_capacity

    act_factor = 1.0 if forward_only else ACTIVATION_FACTOR
    zero = {"params": 0.0, "opt": 0.0, "grads": 0.0,
            "activations": 0.0, "inputs": 0.0, "kv_cache": 0.0}
    per: Dict[int, Dict[str, float]] = {d: dict(zero) for d in range(n_dev)}

    seen_param_keys = set()
    for op in getattr(model, "layers", []):
        pc = _effective_pc(op, strategy)
        # -- params / opt state / grads (once per shared param_key) ----
        pb = float(op.param_bytes())
        if pb and op.param_key not in seen_param_keys:
            seen_param_keys.add(op.param_key)
            frac = param_shard_fraction(op, pc)
            # normalized/canonical realizations alike leave every device
            # holding (a replica of) one shard-fraction of the param
            for d in range(n_dev):
                per[d]["params"] += pb * pscale * frac
                if not forward_only:
                    per[d]["opt"] += pb * frac * (2.0 if mixed else 1.0)
                    per[d]["grads"] += pb * pscale * frac
        # -- activation residual (saved for backward; forward-only keeps
        # just the live inter-op tiles) --------------------------------
        for d, elems in _per_device_out_tiles(op, pc, n_dev).items():
            per[d]["activations"] += elems * act_bytes * act_factor
    if forward_only and kv_cache_bytes:
        for d in range(n_dev):
            per[d]["kv_cache"] += float(kv_cache_bytes)
    # -- batch shards --------------------------------------------------
    for t in getattr(model, "_inputs", []):
        shard = math.ceil(t.size() / max(n_dev, 1)) * dtype_bytes(t.dtype)
        for d in range(n_dev):
            per[d]["inputs"] += shard

    over: List[tuple] = []
    for d in sorted(per):
        b = per[d]
        b["total"] = sum(b.values())
        if not donated:
            # un-donated step: the updated params+opt are fresh outputs
            # living alongside their inputs
            b["total"] += b["params"] + b["opt"]
        if b["total"] > hbm_capacity:
            over.append((d, b["total"]))
    return {
        "per_device": per,
        "capacity": float(hbm_capacity),
        "over": over,
        "assumptions": {
            "param_dtype": getattr(model.config, "param_dtype",
                                   "float32"),
            "param_byte_scale": pscale,
            "activation_dtype_bytes": act_bytes,
            "activation_factor": act_factor,
            "donated": donated,
            "opt_levels": 0 if forward_only else (2 if mixed else 1),
            "forward_only": forward_only,
            "kv_cache_bytes_per_device": float(kv_cache_bytes),
        },
    }


def format_over_report(report: dict) -> str:
    """Human rendering of the over-budget devices with their breakdown —
    what the drivers print before refusing an OOM plan."""
    lines = []
    cap = report["capacity"]
    for dev, total in report["over"]:
        b = report["per_device"][dev]
        kv = b.get("kv_cache", 0.0)
        kv_part = f" + kv_cache {kv / 1e9:.2f}" if kv else ""
        lines.append(
            f"device {dev}: predicted peak {total / 1e9:.2f} GB exceeds "
            f"{cap / 1e9:.2f} GB HBM (params {b['params'] / 1e9:.2f} + "
            f"opt {b['opt'] / 1e9:.2f} + grads {b['grads'] / 1e9:.2f} + "
            f"activations {b['activations'] / 1e9:.2f} + inputs "
            f"{b['inputs'] / 1e9:.2f}{kv_part} GB)")
    return "\n".join(lines)
