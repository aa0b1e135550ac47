"""The collective audit: executor-grounded communication accounting for
the strategy search (PyTorch port of ``flexflow_tpu/utils/hlo_audit.py``;
the name is kept, since the ``hlo_audit`` record kind, ``obs/report.py``
and ``apps.search`` use it).

The JAX package lowers a plan and pure data parallelism on a virtual
mesh and counts the collectives in the optimized HLO.  The port has no
HLO: it audits what its executor issues.  Every collective of the
executor goes through ``parallel/collectives.py``, whose recorder
(``collectives.recording``) writes one record per call, live or on
``meta`` tensors alike, in the fields of JAX's ``parse_collectives``:
``op`` (XLA's mnemonic), ``bytes``, ``cross``, ``groups`` and ``async``.
The volume follows JAX's convention op by op: an all-reduce or an
all-gather counts its result, a reduce-scatter its piece, an all-to-all
or a rotation the block it moves.  A collective counts once per group,
not once per member rank (the group's first rank keeps the record when
the ranks' lists are joined), and the groups that run one collective
side by side are one record listing every group, as XLA's instruction
lists its replica groups (:func:`join_records`).  ``cross`` says whether
a group or a pair spans the topology's fast-tier groups of
``ici_group`` ranks.

Two entry points, as in JAX:

* :func:`audit_in_process` runs on every rank of a world of ``devices``
  ranks already made (``distributed.initialize``): each rank builds the
  plan and pure data parallelism on the world's machine and traces one
  training step on ``meta`` tensors (the dry run of ``--dry-compile``)
  with the recorder on; nothing runs and nothing is issued.  The records
  are joined over the world and every rank returns the audit.
* :func:`audit_subprocess` starts that world: ``devices`` gloo CPU
  processes, so that the audit runs from any parent (one card, the CPU,
  the tests), as JAX's subprocess does.  A gloo world of CPU processes
  has NCCL's transport (an all-to-all for a regrid's even move,
  point-to-point for a ring's rotation and a halo), so the audit counts
  what the plan moves over NCCL; :func:`audit_in_process` on a world of
  gloo ranks on CUDA tensors counts that world's gathers instead.

:func:`audit_consistent` and :func:`audit_consistent_time` (the latter
pricing the records with ``sim.collectives.priced_collectives``) judge
a simulated claim against the audit, as JAX's do.

    python -m flexflow_tpu_torch.utils.hlo_audit alexnet --devices 8 \\
        --ici-group 4 --strategy s.json
"""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
import tempfile
import time
from typing import List, Optional, Tuple, Union


def collective_summary(records, group_size: int) -> List[dict]:
    """JSON-safe records of the recorder's ``records``: ``{"op", "bytes",
    "cross", "groups", "async"}``, ``cross`` whether any group or pair
    spans fast-tier groups of ``group_size`` consecutive ranks."""
    out = []
    for r in records:
        cross = any(len({int(i) // group_size for i in g}) > 1
                    for g in r["groups"])
        out.append({"op": r["op"], "bytes": float(r["bytes"]),
                    "cross": cross,
                    "groups": [[int(i) for i in g] for g in r["groups"]],
                    "async": False})
    return out


def collective_bytes(records, group_size: int) -> Tuple[float, float]:
    """``(cross_group_bytes, intra_bytes)`` of the recorder's records."""
    cross = intra = 0.0
    for rec in collective_summary(records, group_size):
        if rec["cross"]:
            cross += rec["bytes"]
        else:
            intra += rec["bytes"]
    return cross, intra


# ---------------------------------------------------------------------------
# the models, as the training drivers build them


def _apply_overrides(cfg, overrides):
    """Set ``overrides`` on a model config (small shapes of one family)."""
    for k, v in (overrides or {}).items():
        if not hasattr(cfg, k):
            raise SystemExit(
                f"override {k!r} is not a field of {type(cfg).__name__}")
        setattr(cfg, k, v)
    return cfg


def _build_model(model_name: str, machine, batch_size: Optional[int],
                 strategy_path: str, seed: int = 3,
                 dtype: str = "float32", experts: int = 0,
                 overrides: Optional[dict] = None):
    """``(model, batch)`` of ``model_name`` on ``machine`` under the
    strategy file (empty: pure data parallelism), ``batch`` this rank's
    block of one batch (``flexflow_tpu/utils/hlo_audit.py:195``).  A
    strategy with a ``__pipeline__`` block builds the ``PipelinedLM``
    ``apps.lm`` trains from it, whose batch is the global one."""
    from flexflow_tpu_torch.data import (synthetic_batches,
                                         synthetic_token_stream)
    from flexflow_tpu_torch.strategy import Strategy

    strategies = Strategy.load(strategy_path) if strategy_path \
        else Strategy()
    dev = machine.device
    if model_name == "nmt":
        from flexflow_tpu_torch.nmt.rnn_model import RnnConfig, RnnModel

        rc = _apply_overrides(RnnConfig(seed=seed, compute_dtype=dtype),
                              overrides)
        if batch_size:
            rc.batch_size = batch_size
        model = RnnModel(rc, machine, strategies if strategy_path
                         else None)
        data = synthetic_token_stream(rc.batch_size, rc.seq_length,
                                      rc.vocab_size, seed=5, streams=2,
                                      device=dev, machine=machine)
        return model, tuple(next(data))
    if model_name in ("transformer", "gpt", "bert"):
        from flexflow_tpu_torch.models.transformer import (TransformerConfig,
                                                           TransformerLM)

        tc = _apply_overrides(TransformerConfig(
            seed=seed, compute_dtype=dtype, num_experts=experts), overrides)
        if batch_size:
            tc.batch_size = batch_size
        if model_name == "gpt":
            tc.causal = True
        pp = strategies.pipeline
        if pp:
            import numpy as np

            from flexflow_tpu_torch.parallel.pipeline import PipelinedLM

            model = PipelinedLM(
                machine, pp["stages"], pp["microbatches"],
                num_layers=tc.num_layers, d_model=tc.d_model,
                num_heads=tc.num_heads, d_ff=tc.d_ff,
                vocab_size=tc.vocab_size, seq_length=tc.seq_length,
                batch_size=tc.batch_size, causal=tc.causal,
                compute_dtype=tc.compute_dtype, tp=pp.get("tp", 1) or 1)
            toks = np.random.RandomState(5).randint(
                0, tc.vocab_size, (tc.batch_size, tc.seq_length)) \
                .astype("int32")
            return model, (toks, toks)
        model = TransformerLM(tc, machine, strategies)
        data = synthetic_token_stream(tc.batch_size, tc.seq_length,
                                      tc.vocab_size, seed=5, streams=1,
                                      device=dev, machine=machine)
        (toks,) = next(data)
        return model, (toks, toks)
    from flexflow_tpu_torch.apps.cnn import MODELS, build
    from flexflow_tpu_torch.config import FFConfig

    if model_name not in MODELS:
        raise SystemExit(f"unknown model {model_name!r}")
    size = 299 if model_name.startswith("inception") else 224
    cfg = _apply_overrides(
        FFConfig(batch_size=batch_size or 16, input_height=size,
                 input_width=size, num_iterations=1, print_freq=0,
                 seed=seed, compute_dtype=dtype, strategies=strategies,
                 strategy_file=strategy_path), overrides)
    model = build(model_name, cfg, machine)
    data = synthetic_batches(cfg.batch_size, cfg.input_height,
                             cfg.input_width, num_classes=cfg.num_classes,
                             mode="ones", device=dev, machine=machine)
    return model, tuple(next(data))


def _pipeline_dry_step(model, batch) -> None:
    """One step of a ``PipelinedLM`` on ``meta`` tensors: this rank's
    blocks of the tree as meta leaves, the global batch."""
    import torch

    full = {"blocks": {k: torch.empty(v, device="meta") for k, v in
                       model.param_shapes()["blocks"].items()}}
    full.update({k: torch.empty(v, device="meta")
                 for k, v in model.param_shapes().items() if k != "blocks"})
    model.make_train_step()(model.shard_params(full), *batch)


def step_collectives(model, batch, live: bool = False, step=None,
                     trees=None) -> List[dict]:
    """The collectives of one training step of ``model`` on this rank, as
    the recorder writes them (with ``owner``).  Dry (the default): the
    step traced on ``meta`` tensors, nothing issued.  ``live``: the
    step ``step(*trees, *batch)`` run for real, every collective issued;
    its result is dropped."""
    from flexflow_tpu_torch import obs
    from flexflow_tpu_torch.parallel import collectives

    machine = model.machine
    with collectives.recording() as recs:
        if live:
            step(*trees, *batch)
        elif not hasattr(model, "abstract_train_state"):
            import torch

            dev = machine.device
            machine.device = torch.device("meta")
            try:
                _pipeline_dry_step(model, batch)
            finally:
                machine.device = dev
        else:
            model._dry_run(iter([batch]), log=lambda *a, **k: None,
                           olog=obs.NULL)
    return list(recs)


def join_records(records, machine) -> List[dict]:
    """The world's records as XLA's instructions: every group's record
    kept once (by the group's first rank), and the records of disjoint
    groups at the same occurrence on their ranks of one op, size and
    group size made one record listing every group, as one instruction
    of an SPMD program lists its replica groups.  So k groups that run a
    collective side by side count its bytes once and are priced at their
    slowest group (``priced_collectives``).  Joined over the world in
    rank order; every rank returns the joined list."""
    import torch.distributed as dist

    rank = dist.get_rank() if machine.distributed else 0
    seen: dict = {}
    mine = []
    for r in records:
        key = (r["op"], r["bytes"], r["size"])
        n = seen.get(key, 0)
        seen[key] = n + 1
        if r["owner"] == rank:
            mine.append((key + (n,), {"op": r["op"], "bytes": r["bytes"],
                                      "groups": r["groups"]}))
    every = [mine]
    if machine.distributed and dist.get_world_size() > 1:
        every = [None] * dist.get_world_size()
        dist.all_gather_object(every, mine)
    joined: dict = {}
    out = []
    for part in every:
        for key, rec in part:
            ranks = {i for g in rec["groups"] for i in g}
            for have, used in joined.get(key, []):
                if not used & ranks:
                    have["groups"] = have["groups"] + rec["groups"]
                    used |= ranks
                    break
            else:
                have = dict(rec, groups=list(rec["groups"]))
                joined.setdefault(key, []).append((have, ranks))
                out.append(have)
    return out


def _topology(ici_group: int, dcn_calibration: str = ""):
    from flexflow_tpu_torch.machine import Topology

    topo = Topology.hopper(ici_group)
    return topo.with_calibration(dcn_calibration) if dcn_calibration \
        else topo


def audit_in_process(model_name: str, devices: int, ici_group: int,
                     strategy_path: str,
                     batch_size: Optional[int] = None,
                     seed: int = 3, dtype: str = "float32",
                     dp_known: Union[Tuple[float, float], dict,
                                     None] = None,
                     experts: int = 0,
                     dcn_calibration: str = "",
                     overrides: Optional[dict] = None,
                     machine=None) -> dict:
    """The audit of ``strategy_path`` and of pure data parallelism on a
    world of ``devices`` ranks with fast-tier groups of ``ici_group``,
    called on every rank of the world (``machine`` its machine; default
    the machine of the process group this process joined): cross- and
    intra-tier bytes, the records (``searched_collectives`` /
    ``dp_collectives``) and their predicted seconds on
    ``Topology.hopper`` (the slow tier from ``dcn_calibration`` when
    given).  ``dp_known`` from an earlier audit of the same model and
    shape skips the data-parallel trace: the ``(cross, intra)`` tuple
    (bytes only) or that audit's dict.  Every rank returns the audit."""
    from flexflow_tpu_torch import distributed
    from flexflow_tpu_torch.sim.collectives import priced_collectives

    topo = _topology(ici_group, dcn_calibration)
    if machine is None:
        import torch.distributed as dist

        if not distributed.is_initialized() \
                or dist.get_world_size() != devices:
            have = dist.get_world_size() if distributed.is_initialized() \
                else 1
            raise RuntimeError(
                f"audit needs a world of {devices} ranks, this process has "
                f"{have}: use audit_subprocess")
        machine = distributed._world_machine(
            distributed._STATE["device"], devices, dist.get_rank(), topo)
    elif machine.num_devices != devices:
        raise RuntimeError(f"audit needs a world of {devices} ranks, the "
                           f"machine has {machine.num_devices}")
    out = {"model": model_name, "devices": devices, "ici_group": ici_group,
           "transport": {"all_to_all": machine.all_to_all,
                         "send_recv": machine.send_recv}}
    for key, path in (("searched", strategy_path), ("dp", "")):
        if key == "dp" and isinstance(dp_known, tuple):
            cross, intra = dp_known
            recs = None
        elif key == "dp" and isinstance(dp_known, dict):
            cross = dp_known["dp_cross_bytes"]
            intra = dp_known["dp_intra_bytes"]
            recs = dp_known.get("dp_collectives")
        else:
            model, batch = _build_model(model_name, machine, batch_size,
                                        path, seed, dtype, experts,
                                        overrides)
            recs = collective_summary(
                join_records(step_collectives(model, batch), machine),
                ici_group)
            cross = sum(r["bytes"] for r in recs if r["cross"])
            intra = sum(r["bytes"] for r in recs if not r["cross"])
        out[f"{key}_cross_bytes"] = cross
        out[f"{key}_intra_bytes"] = intra
        out[f"{key}_collectives"] = recs
        out[f"{key}_pred_s"] = (priced_collectives(recs, topo)["seconds"]
                                if recs is not None else None)
    out["cross_ratio_dp_over_searched"] = (
        out["dp_cross_bytes"] / max(out["searched_cross_bytes"], 1.0))
    return out


def audit_consistent(audit: dict, simulated_speedup: float) -> bool:
    """Does the executor's traffic support the simulated two-tier claim?
    (``flexflow_tpu/utils/hlo_audit.py:386``): a cross-tier win needs
    strictly fewer cross-tier bytes than data parallelism, a claim over
    ~1.2x a clear (>= 20 %) reduction, and a plan claiming no win (<=
    1.05x) may move no more than data parallelism."""
    s, d = audit["searched_cross_bytes"], audit["dp_cross_bytes"]
    if simulated_speedup <= 1.05:
        return s <= d
    if d <= 0:
        return s <= 0
    if s >= d:
        return False
    if simulated_speedup > 1.2 and s > 0.8 * d:
        return False
    return True


def audit_consistent_time(audit: dict, simulated_speedup: float,
                          topo=None,
                          dp_time_s: Optional[float] = None,
                          best_time_s: Optional[float] = None) -> dict:
    """The predicted-seconds form of :func:`audit_consistent`
    (``flexflow_tpu/utils/hlo_audit.py:407``): both plans' records priced
    with ``priced_collectives`` on ``topo``; no win claimed needs s <=
    1.05 d, a claimed win s <= d, and a claim over 1.2x with both
    simulated step times known a saving of at least half the claimed
    win (else s <= 0.8 d).  Without records on either side or without
    ``topo`` the byte rule decides (``mode`` "bytes").  Returns
    ``{"consistent", "mode", "searched_pred_s", "dp_pred_s"}`` (and
    ``claimed_win_s`` where it applied)."""
    from flexflow_tpu_torch.sim.collectives import priced_collectives

    sc, dc = audit.get("searched_collectives"), audit.get("dp_collectives")
    if sc is None or dc is None or topo is None:
        return {"consistent": audit_consistent(audit, simulated_speedup),
                "mode": "bytes",
                "searched_pred_s": audit.get("searched_pred_s"),
                "dp_pred_s": audit.get("dp_pred_s")}
    s = priced_collectives(sc, topo)["seconds"]
    d = priced_collectives(dc, topo)["seconds"]
    out = {"mode": "time", "searched_pred_s": s, "dp_pred_s": d}
    if simulated_speedup <= 1.05:
        out["consistent"] = s <= 1.05 * d + 1e-12
        return out
    if d <= 0.0:
        out["consistent"] = s <= 0.0
        return out
    if s > d:
        out["consistent"] = False
        return out
    if simulated_speedup > 1.2:
        if dp_time_s is not None and best_time_s is not None \
                and dp_time_s > best_time_s:
            win = dp_time_s - best_time_s
            out["claimed_win_s"] = win
            out["consistent"] = (d - s) >= 0.5 * win
            return out
        out["consistent"] = s <= 0.8 * d
        return out
    out["consistent"] = True
    return out


# ---------------------------------------------------------------------------
# the spawned world


def _argv(model_name, devices, ici_group, strategy_path, batch_size, seed,
          dtype, experts, dcn_calibration, overrides, dp_json) -> List[str]:
    cmd = [model_name, "--devices", str(devices), "--ici-group",
           str(ici_group), "--seed", str(seed)]
    if strategy_path:
        cmd += ["--strategy", os.path.abspath(strategy_path)]
    if batch_size:
        cmd += ["--batch-size", str(batch_size)]
    if dtype != "float32":
        cmd += ["--dtype", dtype]
    if experts:
        cmd += ["--experts", str(experts)]
    if dcn_calibration:
        cmd += ["--dcn-calibration", os.path.abspath(dcn_calibration)]
    if overrides:
        cmd += ["--overrides", json.dumps(overrides)]
    if dp_json:
        cmd += ["--dp-known-json", dp_json]
    return cmd


def audit_subprocess(model_name: str, devices: int, ici_group: int,
                     strategy_path: str,
                     batch_size: Optional[int] = None, seed: int = 3,
                     timeout: float = 900.0,
                     dtype: str = "float32",
                     dp_known: Union[Tuple[float, float], dict,
                                     None] = None,
                     experts: int = 0,
                     dcn_calibration: str = "",
                     overrides: Optional[dict] = None) -> dict:
    """:func:`audit_in_process` in a world of ``devices`` fresh gloo CPU
    processes (no card is visible to them), callable from any parent;
    rank 0's audit.  Every process is stopped before this returns."""
    repo = os.path.dirname(os.path.dirname(
        os.path.dirname(os.path.abspath(__file__))))
    env = dict(os.environ)
    env["PYTHONPATH"] = repo + os.pathsep + env.get("PYTHONPATH", "")
    env["CUDA_VISIBLE_DEVICES"] = ""
    env["OMP_NUM_THREADS"] = "1"
    tmp = tempfile.mkdtemp(prefix="ff-audit-")
    procs = []
    try:
        dp_json = ""
        if isinstance(dp_known, dict):
            dp_json = os.path.join(tmp, "dp.json")
            with open(dp_json, "w") as f:
                json.dump({k: dp_known.get(k) for k in
                           ("dp_cross_bytes", "dp_intra_bytes",
                            "dp_collectives")}, f)
        args = _argv(model_name, devices, ici_group, strategy_path,
                     batch_size, seed, dtype, experts, dcn_calibration,
                     overrides, dp_json)
        if isinstance(dp_known, tuple):
            args += ["--dp-known", f"{dp_known[0]},{dp_known[1]}"]
        init = "file://" + os.path.join(tmp, "store")
        outs = [open(os.path.join(tmp, f"rank{r}.out"), "w+")
                for r in range(devices)]
        for r in range(devices):
            procs.append(subprocess.Popen(
                [sys.executable, "-m", "flexflow_tpu_torch.utils.hlo_audit",
                 *args, "--world-rank", str(r), "--init-method", init],
                stdout=outs[r], stderr=subprocess.STDOUT, env=env,
                cwd=repo))
        deadline = time.monotonic() + timeout
        for p in procs:
            left = deadline - time.monotonic()
            try:
                p.wait(timeout=max(left, 0.1))
            except subprocess.TimeoutExpired:
                raise RuntimeError(
                    f"collective audit: {devices} ranks did not finish "
                    f"within {timeout} s") from None
        texts = []
        for f in outs:
            f.seek(0)
            texts.append(f.read())
            f.close()
        bad = [(r, p.returncode) for r, p in enumerate(procs)
               if p.returncode != 0]
        if bad:
            r = bad[0][0]
            raise RuntimeError(
                f"collective audit rank {r} failed (rc {bad[0][1]}):\n"
                f"{texts[r][-2000:]}")
        for line in reversed(texts[0].splitlines()):
            if line.strip().startswith("{"):
                return json.loads(line)
        raise RuntimeError(
            f"collective audit printed no JSON:\n{texts[0][-2000:]}")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        shutil.rmtree(tmp, ignore_errors=True)


def main(argv=None):
    from flexflow_tpu_torch.config import flag_stream

    args = list(sys.argv[1:] if argv is None else argv)
    opts = {"model": "alexnet", "devices": 8, "ici_group": 4,
            "strategy": "", "batch_size": None, "seed": 3,
            "dtype": "float32", "dp_known": None, "experts": 0,
            "dcn_calibration": "", "overrides": None, "rank": None,
            "init_method": ""}
    if args and not args[0].startswith("-"):
        opts["model"] = args.pop(0)
    for a, val in flag_stream(args):
        if a == "--devices":
            opts["devices"] = int(val())
        elif a == "--ici-group":
            opts["ici_group"] = int(val())
        elif a == "--strategy":
            opts["strategy"] = val()
        elif a in ("-b", "--batch-size"):
            opts["batch_size"] = int(val())
        elif a == "--seed":
            opts["seed"] = int(val())
        elif a == "--dtype":
            opts["dtype"] = val()
        elif a == "--dp-known":
            c, i = val().split(",")
            opts["dp_known"] = (float(c), float(i))
        elif a == "--dp-known-json":
            with open(val()) as f:
                opts["dp_known"] = json.load(f)
        elif a == "--experts":
            opts["experts"] = int(val())
        elif a == "--dcn-calibration":
            opts["dcn_calibration"] = val()
        elif a == "--overrides":
            opts["overrides"] = json.loads(val())
        elif a == "--world-rank":
            opts["rank"] = int(val())
        elif a == "--init-method":
            opts["init_method"] = val()
    audit_args = (opts["model"], opts["devices"], opts["ici_group"],
                  opts["strategy"], opts["batch_size"], opts["seed"],
                  opts["dtype"], opts["dp_known"], opts["experts"],
                  opts["dcn_calibration"], opts["overrides"])
    if opts["rank"] is None:
        # the command line's own run: start the world
        print(json.dumps(audit_subprocess(
            *audit_args[:6], dtype=opts["dtype"],
            dp_known=opts["dp_known"], experts=opts["experts"],
            dcn_calibration=opts["dcn_calibration"],
            overrides=opts["overrides"])))
        return
    import torch

    from flexflow_tpu_torch import distributed

    torch.set_num_threads(1)
    topo = _topology(opts["ici_group"], opts["dcn_calibration"])
    machine = distributed.initialize(
        "cpu", rank=opts["rank"], world_size=opts["devices"],
        init_method=opts["init_method"], topology=topo)
    try:
        out = audit_in_process(*audit_args, machine=machine)
    finally:
        distributed.shutdown()
    if opts["rank"] == 0:
        print(json.dumps(out))


if __name__ == "__main__":
    main()
