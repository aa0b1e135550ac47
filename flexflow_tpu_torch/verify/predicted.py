"""The predicted-time grounded accept as a lint pass (PyTorch port of
``flexflow_tpu/verify/predicted.py``).

Runs the collective audit (the strategy against pure data parallelism,
``utils/hlo_audit.py``) and judges the strategy's own claim (its
``__predicted__`` block, or an explicit ``claimed_speedup``) with
``audit_consistent_time``: predicted seconds of the executor's
collectives on ``Topology.hopper``, not byte counts.  A strategy that
carries no claim gets the no-win rule (the plan may not pay more
predicted time than data parallelism) at warning level: there is no
simulated number to contradict, only a smell.

The audit runs in a world of ``devices`` spawned gloo CPU processes
(``audit_subprocess``), or, when this process is a rank of a world of
that many ranks, in that world (every rank calls the pass).
"""

from __future__ import annotations

from typing import List, Optional, Tuple

from flexflow_tpu_torch.verify.findings import Finding


def _audit(model_name, devices, ici_group, strategy_path, batch_size, seed,
           dtype, dcn_calibration, overrides) -> dict:
    import torch.distributed as dist

    from flexflow_tpu_torch import distributed
    from flexflow_tpu_torch.utils.hlo_audit import (audit_in_process,
                                                    audit_subprocess)

    if distributed.is_initialized() and dist.get_world_size() == devices:
        return audit_in_process(model_name, devices, ici_group,
                                strategy_path, batch_size, seed, dtype,
                                dcn_calibration=dcn_calibration,
                                overrides=overrides)
    return audit_subprocess(model_name, devices, ici_group, strategy_path,
                            batch_size, seed, dtype=dtype,
                            dcn_calibration=dcn_calibration,
                            overrides=overrides)


def predicted_findings(model_name: str, devices: int, ici_group: int,
                       strategy_path: str,
                       batch_size: Optional[int] = None,
                       seed: int = 3, dtype: str = "float32",
                       dcn_calibration: str = "",
                       overrides: Optional[dict] = None,
                       claimed_speedup: Optional[float] = None,
                       ) -> Tuple[List[Finding], dict]:
    """``(findings, audit_summary)`` of the predicted-time pass."""
    from flexflow_tpu_torch.strategy import Strategy
    from flexflow_tpu_torch.utils.hlo_audit import (_topology,
                                                    audit_consistent_time)

    claim_src = "flag"
    if claimed_speedup is None:
        pred = getattr(Strategy.load(strategy_path), "predicted",
                       None) or {}
        claimed_speedup = pred.get("speedup_vs_dp")
        claim_src = "__predicted__" if claimed_speedup else "none"
    topo = _topology(ici_group, dcn_calibration)
    audit = _audit(model_name, devices, ici_group, strategy_path,
                   batch_size, seed, dtype, dcn_calibration, overrides)
    verdict = audit_consistent_time(audit, claimed_speedup or 1.0, topo)
    summary = {
        "claimed_speedup": claimed_speedup, "claim_source": claim_src,
        "searched_pred_s": verdict.get("searched_pred_s"),
        "dp_pred_s": verdict.get("dp_pred_s"),
        "searched_cross_mb": round(audit["searched_cross_bytes"] / 1e6, 3),
        "dp_cross_mb": round(audit["dp_cross_bytes"] / 1e6, 3),
        "mode": verdict["mode"], "consistent": verdict["consistent"],
    }
    findings: List[Finding] = []
    where = f"{model_name}:{strategy_path}"
    claim = (f"claimed {claimed_speedup:.2f}x" if claimed_speedup
             else "no-win")
    if verdict["consistent"]:
        findings.append(Finding(
            "predicted", "consistent", "info", where,
            f"predicted comm {verdict.get('searched_pred_s')} s vs DP "
            f"{verdict.get('dp_pred_s')} s supports the {claim} plan "
            f"({verdict['mode']} mode)"))
    else:
        against = (f"the claimed {claimed_speedup:.2f}x win over"
                   if claimed_speedup else "parity with")
        findings.append(Finding(
            "predicted", "inconsistent",
            "error" if claimed_speedup else "warning", where,
            f"the executor's predicted comm "
            f"({verdict.get('searched_pred_s')} s) contradicts {against}"
            f" DP ({verdict.get('dp_pred_s')} s, {verdict['mode']} mode)"))
    return findings, summary
