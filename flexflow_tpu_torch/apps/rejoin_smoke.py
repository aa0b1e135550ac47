"""The respawned processes' ``elastic_rejoin`` smoke (PyTorch port of
``flexflow_tpu/apps/rejoin_smoke.py``).

The parent seeds a verified checkpoint (the tiny CNN after 3 steps in
this process: the run's state when its processes were lost), then
starts two FRESH processes.  Each one's first act is
``distributed.elastic_rejoin``: form the two-rank world over gloo,
build the tiny CNN on it through the model factory (``linear`` split
over the two ranks, so that each restores its own block) and restore
the checkpoint.  Both take one training step on the same global batch
and print ``REJOIN <step> <ranks> <loss>``; they must exit 0, restore
step 3 in a world of 2 and report the same loss, which must be the
parent's one-process step from the same checkpoint within 1e-5.

Starting fresh processes is slow, so the smoke runs only when
``FF_REJOIN_SMOKE=1`` is set (else it says so and exits 0)::

    FF_REJOIN_SMOKE=1 python -m flexflow_tpu_torch.apps.rejoin_smoke \\
        [--device cpu | --device cuda:0]
"""

from __future__ import annotations

import os
import socket
import subprocess
import sys
import tempfile

ITERS = 3     # steps of the seeded run
RTOL = 1e-5   # the two-rank step against the one-process step

WORKER = """
import sys
rank, port, ckpt_dir, device = (int(sys.argv[1]), sys.argv[2], sys.argv[3],
                                sys.argv[4])
import torch
torch.set_num_threads(1)
from flexflow_tpu_torch import distributed
from flexflow_tpu_torch.apps.rejoin_smoke import build_tiny, make_batch

machine, step, params, state, opt = distributed.elastic_rejoin(
    ckpt_dir, device=device, backend="gloo", rank=rank, world_size=2,
    init_method="tcp://127.0.0.1:" + port, model=build_tiny)
ff = build_tiny(machine)
train = ff.make_train_step()
img, lbl = ff.local_batch(*map(torch.from_numpy, make_batch()))
params, state, opt, loss = train(params, state, opt, img, lbl)
print(f"REJOIN {step} {machine.num_devices} {float(loss):.9f}", flush=True)
distributed.shutdown()
"""


def build_tiny(machine):
    from flexflow_tpu_torch.config import FFConfig
    from flexflow_tpu_torch.model import FFModel
    from flexflow_tpu_torch.strategy import ParallelConfig, Strategy

    cfg = FFConfig(batch_size=16, input_height=16, input_width=16,
                   num_iterations=ITERS, print_freq=0, num_classes=8,
                   seed=7)
    if machine.num_devices == 2:
        cfg.strategies = Strategy()
        cfg.strategies["fc"] = ParallelConfig((1, 2), (0, 1))
    ff = FFModel(cfg, machine)
    img = ff.create_input((cfg.batch_size, 16, 16, 3), name="image")
    t = ff.conv2d("conv1", img, 8, 3, 3, 1, 1, 1, 1, relu=True)
    t = ff.flat("flat", t)
    t = ff.linear("fc", t, 8, relu=False)
    ff.softmax("softmax", t)
    return ff


def make_batch(seed: int = 7):
    import numpy as np

    rng = np.random.RandomState(seed)
    return (rng.randn(16, 16, 16, 3).astype("float32"),
            rng.randint(0, 8, (16,)).astype("int32"))


def _flag(argv, name: str, default: str) -> str:
    return argv[argv.index(name) + 1] if name in argv else default


def main(argv=None, log=print) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if os.environ.get("FF_REJOIN_SMOKE") != "1":
        log("rejoin-smoke SKIPPED: starting fresh processes is slow, so "
            "this smoke is opt-in — set FF_REJOIN_SMOKE=1 to run it")
        return 0
    import torch

    from flexflow_tpu_torch.machine import MachineModel
    from flexflow_tpu_torch.utils import checkpoint as ckpt

    device = _flag(argv, "--device", "cuda")
    torch.set_num_threads(1)
    with tempfile.TemporaryDirectory(prefix="ff-rejoin-smoke-") as td:
        ckpt_dir = os.path.join(td, "ckpt")
        ff = build_tiny(MachineModel(device))
        params, state = ff.init()
        opt = ff.init_opt_state(params)
        train = ff.make_train_step()
        img, lbl = map(torch.from_numpy, make_batch())
        for _ in range(ITERS):
            params, state, opt, loss = train(params, state, opt, img, lbl)
        ckpt.save_checkpoint(ckpt_dir, ITERS, params, state, opt,
                             ff.config.strategies)
        ok, why = ckpt.verify_checkpoint(ckpt_dir, ITERS)
        assert ok, f"the seeded checkpoint must verify: {why}"
        _, want = train(params, state, opt, img, lbl)[2:]
        want = float(want)
        log(f"seeded verified checkpoint at step {ITERS} (loss "
            f"{float(loss):.4f}); the next step's loss {want:.9f}")

        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            port = str(s.getsockname()[1])
        procs = [subprocess.Popen(
            [sys.executable, "-c", WORKER, str(r), port, ckpt_dir, device],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for r in range(2)]
        outs = []
        try:
            for p in procs:
                out, _ = p.communicate(timeout=300)
                outs.append(out)
        finally:
            # one worker dying leaves its peer at the rendezvous
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.communicate()
        lines = []
        for r, (p, out) in enumerate(zip(procs, outs)):
            assert p.returncode == 0, f"worker {r} failed:\n{out[-3000:]}"
            got = [ln for ln in out.splitlines() if ln.startswith("REJOIN")]
            assert got, f"worker {r} printed no REJOIN line:\n{out[-2000:]}"
            lines.append(got[0].split())
        steps = [int(ln[1]) for ln in lines]
        ranks = [int(ln[2]) for ln in lines]
        losses = [float(ln[3]) for ln in lines]
        assert steps == [ITERS, ITERS], steps
        assert ranks == [2, 2], ranks
        assert losses[0] == losses[1], \
            f"both ranks must see one loss: {losses}"
        rel = abs(losses[0] - want) / abs(want)
        assert rel <= RTOL, \
            f"the rejoined step's loss {losses[0]} vs one process's " \
            f"{want}: {rel:.3e}"
        log(f"rejoin-smoke ok: 2 fresh processes rejoined, restored "
            f"verified checkpoint step {steps[0]} as blocks of a 2-rank "
            f"world, and agreed on the next loss {losses[0]:.9f} (one "
            f"process: {want:.9f}, relative difference {rel:.2e}) on "
            f"{device}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
