"""Elastic training's smoke (PyTorch port of
``flexflow_tpu/apps/elastic_smoke.py``), over gloo ranks under torchrun.

Two phases, in one world of ``--ranks`` processes (8 by default):

  1. **equivalence** — with ``--elastic``, the step watchdog
     (``--hang-factor``) and the drain handler all armed but no fault
     injected, the run's losses must equal bit for bit those of the run
     with all of them off;
  2. **lifecycle** — the tiny CNN at batch 24 under
     ``device_loss@3x2,device_return@2`` with ``--elastic
     --ckpt-async``: the two highest ranks are lost at steps 3 and 4,
     the run shrinks at the step-4 boundary (8 -> 6, or 4 -> 2 with
     ``--ranks 4``), the lost ranks stand by, answer the regrow probes
     from the second on and are called back after ``--regrow-probes``
     answering probes; the run must end on every rank, with finite
     losses of every step, two ``elastic_resize`` records (shrink, then
     grow), the records in the order injected fault -> device_loss ->
     resize (shrink) -> device_return -> resize (grow), boundary probe
     records, ``ckpt_async`` records and a verified final checkpoint;
``obs/report.py``'s ``summarize`` counts the two resizes, shrink then
grow, as in the JAX smoke.  Failed checks exit non-zero::

    python -m flexflow_tpu_torch.apps.elastic_smoke [--ranks 4] \\
        [--device cpu | --device cuda:0]

The parent starts ``torchrun --standalone --nproc-per-node R`` over this
module with ``--worker DIR``; every rank runs both phases and rank 0
checks them and writes ``DIR/result.json``.  ``--device cuda:0`` puts
every rank on the first card (gloo carries CUDA tensors); the default,
``cuda``, puts rank r on ``cuda:r``.
"""

from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import tempfile

import numpy as np

FAULT_SPEC = "device_loss@3x2,device_return@2"
ITERS = 12
BATCH = 24   # divisible by the 8-, 6-, 4- and 2-rank worlds


def _build(cfg, machine):
    from flexflow_tpu_torch.model import FFModel

    ff = FFModel(cfg, machine)
    img = ff.create_input((cfg.batch_size, 16, 16, 3), name="image")
    t = ff.conv2d("conv1", img, 8, 3, 3, 1, 1, 1, 1, relu=True)
    t = ff.flat("flat", t)
    t = ff.linear("fc", t, 8, relu=False)
    ff.softmax("softmax", t)
    return ff


def _stream(machine, seed: int = 3, n: int = 4):
    """The JAX smoke's host batches as a stream of this rank's blocks,
    which a resize rebinds to the new world's blocks."""
    from flexflow_tpu_torch.data import BlockStream

    rng = np.random.RandomState(seed)
    ring = [(rng.randn(BATCH, 16, 16, 3).astype("float32"),
             rng.randint(0, 8, (BATCH,)).astype("int32"))
            for _ in range(n)]
    return BlockStream(ring, machine=machine)


def _cfg(**kw):
    from flexflow_tpu_torch.config import FFConfig

    base = dict(batch_size=BATCH, input_height=16, input_width=16,
                num_iterations=ITERS, print_freq=2, num_classes=8, seed=3)
    base.update(kw)
    return FFConfig(**base)


def _flag(argv, name: str, default: str) -> str:
    return argv[argv.index(name) + 1] if name in argv else default


def _quiet(*args, **kwargs):
    pass


def _worker(td: str, device: str) -> int:
    """One rank: both phases; rank 0 checks them."""
    import torch

    from flexflow_tpu_torch import distributed, obs
    from flexflow_tpu_torch.obs.report import summarize
    from flexflow_tpu_torch.utils import checkpoint as ckpt

    torch.set_num_threads(1)
    machine = distributed.initialize(device, backend="gloo")
    if machine.device.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    rank, ranks = machine.rank, machine.num_devices
    log = print if rank == 0 else _quiet

    def run(**kw):
        ff = _build(_cfg(num_iterations=4, print_freq=0, **kw), machine)
        return ff.fit(_stream(machine), log=_quiet, rebuild=_build)["loss"]

    # phase 1: armed but healthy == all off, bit for bit
    a = run()
    b = run(elastic=True, min_devices=2, hang_factor=50.0,
            hang_min_s=120.0)
    assert a == b, \
        f"elastic+watchdog must be byte-inert on healthy runs: {a} vs {b}"
    log(f"equivalence ok: {len(a)} losses bit-equal with and without "
        f"--elastic --hang-factor on {ranks} ranks")

    # phase 2: the lifecycle
    cfg = _cfg(ckpt_dir=os.path.join(td, "ckpt"), ckpt_freq=2,
               obs_dir=os.path.join(td, "obs"), run_id="elastic-smoke",
               elastic=True, min_devices=2, ckpt_async=True,
               research_budget_s=10.0, max_regrows=1, regrow_probes=2,
               fault_spec=FAULT_SPEC)
    out = _build(cfg, machine).fit(_stream(machine), log=log,
                                   rebuild=_build)
    assert len(out["loss"]) == ITERS, \
        f"run must complete all {ITERS} iterations, got {len(out['loss'])}"
    assert all(math.isfinite(v) for v in out["loss"]), out["loss"]
    assert not out.get("out_of_service"), \
        f"rank {rank} must be called back by the grow"
    assert out["elastic_resizes"] == 2 and out["devices"] == ranks, \
        (out["elastic_resizes"], out["devices"])
    if rank:
        return 0
    last = ckpt.latest_step(cfg.ckpt_dir)
    ok, why = ckpt.verify_checkpoint(cfg.ckpt_dir, last)
    assert last == ITERS and ok, \
        f"final (async-committed) checkpoint must verify clean: step " \
        f"{last}, {why}"
    events = list(obs.read_run(out["obs_path"]))
    kinds = [e["kind"] for e in events]
    resizes = [e for e in events if e["kind"] == "elastic_resize"]
    assert len(resizes) == 2, \
        f"expected two elastic_resize records, got {len(resizes)}"
    shrink, grow = resizes
    assert shrink["direction"] == "shrink" \
        and shrink["from_devices"] == ranks \
        and shrink["to_devices"] == ranks - 2, shrink
    assert grow["direction"] == "grow" \
        and grow["from_devices"] == ranks - 2 \
        and grow["to_devices"] == ranks, grow
    assert shrink["migration"] == "in_memory" \
        and shrink["steps_lost"] == 0, shrink
    assert grow["migration"] == "in_memory", grow
    i_inj = next(i for i, e in enumerate(events)
                 if e["kind"] == "fault" and e.get("fault") == "device_loss")
    i_det = kinds.index("device_loss")
    i_ret = kinds.index("device_return")
    i_shrink, i_grow = events.index(shrink), events.index(grow)
    assert i_inj < i_det < i_shrink < i_ret < i_grow, \
        "records must read injected fault -> device_loss -> " \
        "resize(shrink) -> device_return -> resize(grow) in order"
    probes = [e for e in events if e["kind"] == "device_probe"
              and e.get("needed") is not None]
    assert probes, f"boundary regrow probes must be recorded: {kinds}"
    assert "ckpt_async" in kinds, \
        f"async writer must emit ckpt_async records: {sorted(set(kinds))}"
    summary = summarize(events)
    assert "elastic" in summary \
        and summary["elastic"]["counts"].get("elastic_resize") == 2, \
        summary.get("elastic")
    dirs = [r["direction"] for r in summary["elastic"]["resizes"]]
    assert dirs == ["shrink", "grow"], dirs
    log(f"elastic-smoke ok: {ITERS} iters survived {FAULT_SPEC!r} with a "
        f"{ranks}->{ranks - 2} shrink at step {shrink['step']} "
        f"({shrink['total_s']:.2f} s) and a {ranks - 2}->{ranks} grow at "
        f"step {grow['step']} ({grow['total_s']:.2f} s, after "
        f"{len(probes)} boundary probe(s); re-search "
        f"{grow['research_s'] * 1e3:.0f} ms "
        f"[{(grow.get('research') or {}).get('mode')}]), final loss "
        f"{out['loss'][-1]:.4f}, verified async checkpoint at step {last}")
    with open(os.path.join(td, "result.json"), "w") as f:
        json.dump({"loss": out["loss"], "equivalence": a,
                   "shrink": shrink, "grow": grow}, f)
    return 0


def main(argv=None, log=print) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    device = _flag(argv, "--device", "cuda")
    if argv[:1] == ["--worker"]:
        rc = _worker(argv[1], device)
        from flexflow_tpu_torch import distributed

        distributed.shutdown()
        return rc
    ranks = int(_flag(argv, "--ranks", "8"))
    if ranks < 4:
        raise SystemExit("--ranks must be at least 4 (two are lost)")
    with tempfile.TemporaryDirectory(prefix="ff-elastic-smoke-") as td:
        proc = subprocess.run(
            [sys.executable, "-m", "torch.distributed.run", "--standalone",
             "--nproc-per-node", str(ranks), "-m",
             "flexflow_tpu_torch.apps.elastic_smoke", "--worker", td,
             "--device", device],
            capture_output=True, text=True, timeout=900)
        sys.stdout.write(proc.stdout)
        if proc.returncode != 0:
            sys.stderr.write(proc.stderr[-4000:])
            log(f"elastic-smoke failed: torchrun exited {proc.returncode}")
            return 1
        with open(os.path.join(td, "result.json")) as f:
            json.load(f)
    return 0


if __name__ == "__main__":
    sys.exit(main())
