"""The preemption drain's smoke (PyTorch port of
``flexflow_tpu/apps/preempt_smoke.py``).

Three phases, on the card unless ``--device cpu`` is given:

  1. **baseline** — the tiny CNN trains 12 uninterrupted iterations in
     this process (the losses the resume is held to);
  2. **drain** — the same training in a SUBPROCESS with ``preempt@5``
     injected: the injector raises SIGTERM through the installed drain
     handler, the worker finishes the step in flight, commits a verified
     checkpoint through the async writer within ``--drain-budget-s``,
     writes ONE ``preempt_drain`` record and exits 0, the scheduler's
     contract;
  3. **resume** — a fresh run in this process over the same checkpoint
     directory restores the drained step and finishes the remaining
     iterations; its losses must equal the baseline's tail bit for bit.

Failed checks exit non-zero::

    python -m flexflow_tpu_torch.apps.preempt_smoke [--device cpu]
"""

from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import tempfile

import numpy as np

FAULT_SPEC = "preempt@5"
ITERS = 12
DRAIN_STEP = 6  # preempt fires at step 5; the drain lands on step 6's boundary
BATCH = 16


def _build(cfg, machine):
    from flexflow_tpu_torch.model import FFModel

    ff = FFModel(cfg, machine)
    img = ff.create_input((cfg.batch_size, 16, 16, 3), name="image")
    t = ff.conv2d("conv1", img, 8, 3, 3, 1, 1, 1, 1, relu=True)
    t = ff.flat("flat", t)
    t = ff.linear("fc", t, 8, relu=False)
    ff.softmax("softmax", t)
    return ff


def _host_batches(seed: int = 5, n: int = 4):
    rng = np.random.RandomState(seed)
    ring = [(rng.randn(BATCH, 16, 16, 3).astype("float32"),
             rng.randint(0, 8, (BATCH,)).astype("int32"))
            for _ in range(n)]
    i = 0
    while True:
        yield ring[i % n]
        i += 1


def _cfg(**kw):
    from flexflow_tpu_torch.config import FFConfig

    base = dict(batch_size=BATCH, input_height=16, input_width=16,
                num_iterations=ITERS, print_freq=2, num_classes=8, seed=5)
    base.update(kw)
    return FFConfig(**base)


def _machine(device: str):
    import torch

    from flexflow_tpu_torch.machine import MachineModel

    if torch.device(device).type == "cuda":
        # float32 runs its products in float32, not TF32
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    return MachineModel(device)


def _worker(td: str, device: str, threads: int) -> int:
    """The preempted training process: runs under ``preempt@5``, drains,
    and exits 0 — the parent checks the literal return code.  It takes
    the parent's number of CPU threads, on which the order of a CPU
    run's sums depends."""
    import torch

    torch.set_num_threads(threads)
    cfg = _cfg(ckpt_dir=os.path.join(td, "ckpt"), ckpt_freq=2,
               obs_dir=os.path.join(td, "obs"), run_id="preempt-smoke",
               ckpt_async=True, drain_budget_s=30.0, fault_spec=FAULT_SPEC)
    out = _build(cfg, _machine(device)).fit(_host_batches(), log=print)
    with open(os.path.join(td, "worker.json"), "w") as f:
        json.dump({"drained": bool(out.get("drained")),
                   "completed_steps": out.get("completed_steps"),
                   "loss": [float(v) for v in out["loss"]],
                   "drain": out.get("drain"),
                   "obs_path": out.get("obs_path")}, f)
    # the scheduler's contract: a graceful drain is a success
    return 0 if out.get("drained") else 3


def _flag(argv, name: str, default: str) -> str:
    return argv[argv.index(name) + 1] if name in argv else default


def main(argv=None, log=print) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    device = _flag(argv, "--device", "cuda")
    if argv[:1] == ["--worker"]:
        return _worker(argv[1], device, int(_flag(argv, "--threads", "1")))

    import torch

    from flexflow_tpu_torch import obs
    from flexflow_tpu_torch.utils import checkpoint as ckpt

    machine = _machine(device)

    # phase 1: the uninterrupted baseline
    base = _build(_cfg(print_freq=0), machine).fit(
        _host_batches(), log=lambda *a: None)["loss"]
    assert len(base) == ITERS

    with tempfile.TemporaryDirectory(prefix="ff-preempt-smoke-") as td:
        # phase 2: the preempted subprocess drains and exits 0
        proc = subprocess.run(
            [sys.executable, "-m", "flexflow_tpu_torch.apps.preempt_smoke",
             "--worker", td, "--device", device, "--threads",
             str(torch.get_num_threads())],
            capture_output=True, text=True, timeout=600)
        sys.stdout.write(proc.stdout)
        assert proc.returncode == 0, \
            f"the drained worker must exit 0 (the scheduler's contract), " \
            f"got {proc.returncode}:\n{proc.stderr[-2000:]}"
        with open(os.path.join(td, "worker.json")) as f:
            w = json.load(f)
        assert w["drained"] and w["completed_steps"] == DRAIN_STEP, w
        assert len(w["loss"]) == DRAIN_STEP, w["loss"]

        ckpt_dir = os.path.join(td, "ckpt")
        last = ckpt.latest_step(ckpt_dir)
        ok, why = ckpt.verify_checkpoint(ckpt_dir, last)
        assert last == DRAIN_STEP and ok, \
            f"the drain's checkpoint must verify at step {DRAIN_STEP}: " \
            f"step {last}, {why}"

        events = list(obs.read_run(w["obs_path"]))
        drains = [e for e in events if e["kind"] == "preempt_drain"]
        assert len(drains) == 1, \
            f"expected exactly one preempt_drain record, got {len(drains)}"
        d = drains[0]
        assert d["step"] == DRAIN_STEP and d["ckpt_step"] == DRAIN_STEP, d
        assert d["mode"] in ("async", "boundary_save", "sync",
                             "sync_fallback"), d
        assert d["seconds"] <= d["budget_s"], \
            f"the drain must land inside its budget: {d}"

        # phase 3: a fresh run resumes from the drained checkpoint
        out = _build(_cfg(ckpt_dir=ckpt_dir, ckpt_freq=2), machine).fit(
            _host_batches(), log=log)
        resumed = [float(v) for v in out["loss"]]
        assert len(resumed) == ITERS - DRAIN_STEP, \
            f"the resume must run the remaining {ITERS - DRAIN_STEP} " \
            f"iterations, got {len(resumed)}"
        assert all(math.isfinite(v) for v in resumed), resumed
        tail = [float(v) for v in base[DRAIN_STEP:]]
        assert resumed == tail, \
            f"drain + resume must lose nothing: resumed {resumed} vs " \
            f"the baseline's tail {tail}"
        assert w["loss"] == [float(v) for v in base[:DRAIN_STEP]], \
            "the losses before the drain must be the baseline's"

        log(f"preempt-smoke ok: {FAULT_SPEC!r} drained at step "
            f"{DRAIN_STEP} in {d['seconds']:.2f}s of the "
            f"{d['budget_s']:.0f}s budget (mode {d['mode']}, exit 0), "
            f"verified checkpoint at step {last}, resume bit-equal to "
            f"the uninterrupted baseline, on {device}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
