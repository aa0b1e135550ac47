"""Deterministic fault-injection smoke (PyTorch port of
``flexflow_tpu/apps/fault_smoke.py``), on the card unless ``--device
cpu`` is given.

Two phases:

  1. **equivalence** — without faults, a run guarded with
     ``on_divergence=rollback`` gives losses bit-equal to the default
     guard's: the guard adds no per-step sync and never perturbs a
     healthy run;
  2. **recovery** — a tiny CNN trains from an HDF5 file this smoke
     writes, under ``data_io@3x2,loss_nan@7`` (a transient read fault
     the reader's retries absorb, one poisoned step), with
     ``--on-divergence rollback`` and a checkpoint every 2 steps.  The
     run must finish its 12 iterations with finite losses, one
     rollback and a verified final checkpoint, and the records must read
     ``fault`` -> ``rollback`` -> ``recovery``, with the reader's
     ``data_fault`` retry and ``recovery`` from ``hdf5``.

The fault counts come from ``obs/report.py``'s ``summarize``, as in the
JAX smoke.  It returns 2 without
``h5py``, as the JAX smoke does; a failed check exits non-zero::

    python -m flexflow_tpu_torch.apps.fault_smoke [--device cpu]
"""

from __future__ import annotations

import math
import os
import sys
import tempfile

import numpy as np

FAULT_SPEC = "data_io@3x2,loss_nan@7"
ITERS = 12


def _build(cfg, machine):
    from flexflow_tpu_torch.model import FFModel

    ff = FFModel(cfg, machine)
    img = ff.create_input((cfg.batch_size, 16, 16, 3), name="image")
    t = ff.conv2d("conv1", img, 8, 3, 3, 1, 1, 1, 1, relu=True)
    t = ff.flat("flat", t)
    t = ff.linear("fc", t, 8, relu=False)
    ff.softmax("softmax", t)
    return ff


def _write_h5(path: str, n: int = 32) -> str:
    import h5py

    rng = np.random.RandomState(0)
    with h5py.File(path, "w") as f:
        f["images"] = rng.randint(0, 255, size=(n, 16, 16, 3),
                                  dtype=np.uint8)
        f["labels"] = rng.randint(0, 8, size=(n,)).astype(np.int32)
    return path


def _cfg(**kw):
    from flexflow_tpu_torch.config import FFConfig

    base = dict(batch_size=8, input_height=16, input_width=16,
                num_iterations=ITERS, print_freq=2, num_classes=8, seed=3)
    base.update(kw)
    return FFConfig(**base)


def _check_equivalence(machine, log) -> None:
    """Guarded but healthy == default: the losses bit-equal."""
    from flexflow_tpu_torch.data import synthetic_batches

    def run(**kw):
        ff = _build(_cfg(num_iterations=4, print_freq=0, **kw), machine)
        data = synthetic_batches(8, 16, 16, num_classes=8, mode="random",
                                 seed=3, machine=machine)
        return ff.fit(data, log=lambda *a: None)["loss"]

    a = run()                                 # the default policy (halt)
    b = run(on_divergence="rollback")         # guarded, no faults
    assert a == b, f"guard must be byte-inert on healthy runs: {a} vs {b}"
    log(f"equivalence ok: {len(a)} losses bit-equal with and without "
        f"rollback policy")


def run_recovery(machine, workdir: str, log=print) -> dict:
    """The recovery phase's run in ``workdir``: ``fit``'s result and its
    records (``"records"``: the shared stream of the fit and data
    surfaces, in write order)."""
    from flexflow_tpu_torch import obs
    from flexflow_tpu_torch.data import hdf5_batches

    h5 = _write_h5(os.path.join(workdir, "data.h5"))
    cfg = _cfg(ckpt_dir=os.path.join(workdir, "ckpt"), ckpt_freq=2,
               obs_dir=os.path.join(workdir, "obs"), run_id="fault-smoke",
               on_divergence="rollback", fault_spec=FAULT_SPEC)
    ff = _build(cfg, machine)
    data_olog = obs.from_config(cfg, surface="data")
    data = None
    try:
        data = hdf5_batches(machine, [h5], cfg.batch_size, olog=data_olog,
                            retry_attempts=cfg.data_retry_attempts,
                            skip_budget=cfg.data_skip_budget)
        out = ff.fit(data, log=log)
    finally:
        if data is not None:
            data.close()
        data_olog.close()
    out["records"] = list(obs.read_run(out["obs_path"]))
    out["config"] = cfg
    return out


def main(argv=None, log=print) -> int:
    try:
        import h5py  # noqa: F401  (the data_io faults need a file source)
    except ImportError:
        log("fault-smoke requires h5py (the data_io faults target the "
            "HDF5 source)")
        return 2
    from flexflow_tpu_torch.machine import MachineModel
    from flexflow_tpu_torch.obs.report import summarize
    from flexflow_tpu_torch.utils import checkpoint as ckpt

    argv = list(sys.argv[1:] if argv is None else argv)
    device = argv[argv.index("--device") + 1] if "--device" in argv \
        else "cuda"
    machine = MachineModel(device)
    _check_equivalence(machine, log)

    with tempfile.TemporaryDirectory(prefix="ff-fault-smoke-") as td:
        out = run_recovery(machine, td, log)
        cfg = out["config"]
        final = out["loss"][-1]
        assert len(out["loss"]) == ITERS, \
            f"run must complete all {ITERS} iterations, got " \
            f"{len(out['loss'])}"
        assert all(math.isfinite(v) for v in out["loss"]), \
            f"post-rollback loss history must be finite: {out['loss']}"
        assert out["rollbacks"] == 1, \
            f"expected exactly one rollback, got {out['rollbacks']}"
        last = ckpt.latest_step(cfg.ckpt_dir)
        ok, why = ckpt.verify_checkpoint(cfg.ckpt_dir, last)
        assert last == ITERS and ok, \
            f"final checkpoint must verify clean: step {last}, {why}"

        events = out["records"]
        kinds = [e["kind"] for e in events]

        def first(kind, **match):
            for i, e in enumerate(events):
                if e["kind"] == kind and all(e.get(k) == v
                                             for k, v in match.items()):
                    return i
            raise AssertionError(
                f"missing {kind} {match} record in {sorted(set(kinds))}")

        i_nan = first("fault", source="injected", fault="loss_nan")
        i_det = first("fault", source="guard", fault="loss_divergence")
        i_rb = first("rollback")
        i_rec = first("recovery", source="guard", after="rollback")
        assert i_nan < i_det < i_rb < i_rec, \
            "records must read fault -> rollback -> recovery in order"
        first("fault", source="injected", fault="data_io")
        first("data_fault", source="hdf5", action="retry")
        first("recovery", source="hdf5", after="retry")

        summary = summarize(events)
        assert "faults" in summary and \
            summary["faults"]["counts"].get("rollback") == 1, summary
        counts = summary["faults"]["counts"]

        log(f"fault-smoke ok: {ITERS} iters survived {FAULT_SPEC!r} with 1 "
            f"rollback, final loss {final:.4f}, records: "
            + ", ".join(f"{k}={v}" for k, v in sorted(counts.items())))
    return 0


if __name__ == "__main__":
    sys.exit(main())
