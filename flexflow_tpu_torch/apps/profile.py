"""Deep-profile a model's training step on the card (PyTorch port of
``flexflow_tpu/apps/profile.py``):

    python -m flexflow_tpu_torch.apps.profile inception -b 256 -o p.json
    python -m flexflow_tpu_torch.apps.report fusions p.json

Runs the port's training step (3 warm-up steps, then ``--iters`` timed
steps between ``torch.cuda.synchronize`` calls), traces 2 more under
``torch.profiler`` with the operators' shapes (``utils.profiling.trace``),
attributes the card's time per launching operator and per ``csrc/``
kernel, classified as tensor-core (``mxu``), the port's other kernels
(``raw``) and the rest (``vpu``), and adds the roofline ceiling
(``utils/hlo_profile.py``).  The report carries the JAX report's keys,
``top_ops`` (the longest rows, ``report fusions``' input) and
``kernel_launches`` (each ``csrc/`` kernel's launches per traced step).
Models: ``inception`` (299x299) and ``alexnet`` (224x224); ``--dtype``
(default bfloat16), ``--iters`` (10), ``--top`` (25), ``--device``
(default ``cuda``; ``cpu`` runs without the card, where the trace holds
no kernels and the roofline no MFU).
"""

from __future__ import annotations

import json
import os
import sys
import tempfile
import time

#: each model's input size (the JAX driver's)
SIZES = {"inception": 299, "alexnet": 224}


def profile_model(model: str = "inception", batch_size: int = 256,
                  iters: int = 10, dtype: str = "bfloat16",
                  top_n: int = 25, device="cuda", log=None) -> dict:
    """The roofline report of ``model``'s training step on ``device``."""
    import shutil

    import torch

    from flexflow_tpu_torch.config import FFConfig
    from flexflow_tpu_torch.data import synthetic_batches
    from flexflow_tpu_torch.machine import MachineModel
    from flexflow_tpu_torch.utils.hlo_profile import (classify_ops,
                                                      device_ops,
                                                      kernel_launches,
                                                      roofline_report,
                                                      top_rows)
    from flexflow_tpu_torch.utils.profiling import trace

    if model == "inception":
        from flexflow_tpu_torch.models.inception import \
            build_inception_v3 as build
    elif model == "alexnet":
        from flexflow_tpu_torch.models.alexnet import build_alexnet as build
    else:
        raise SystemExit(f"unknown model {model!r}")
    size = SIZES[model]

    machine = MachineModel(device)
    dev = machine.device
    cuda = dev.type == "cuda"
    if cuda:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    cfg = FFConfig(batch_size=batch_size, input_height=size,
                   input_width=size, num_iterations=iters, print_freq=0,
                   compute_dtype=dtype)
    ff = build(cfg, machine)
    params, state = ff.init()
    opt_state = ff.init_opt_state(params)
    step = ff.make_train_step()
    img, lbl = next(synthetic_batches(batch_size, size, size, mode="ones",
                                      device=dev))

    def sync(loss):
        if cuda:
            torch.cuda.synchronize(dev)
        return float(loss)

    for _ in range(3):
        params, state, opt_state, loss = step(params, state, opt_state,
                                              img, lbl)
    sync(loss)
    t0 = time.perf_counter()
    for _ in range(iters):
        params, state, opt_state, loss = step(params, state, opt_state,
                                              img, lbl)
    sync(loss)
    sec = (time.perf_counter() - t0) / iters

    trace_steps = 2
    logdir = tempfile.mkdtemp(prefix="ffprof_")
    try:
        with trace(logdir, record_shapes=True):
            for _ in range(trace_steps):
                params, state, opt_state, loss = step(params, state,
                                                      opt_state, img, lbl)
            sync(loss)
        rows = device_ops(logdir, steps=trace_steps)
        launches = kernel_launches(logdir, steps=trace_steps)
    finally:
        shutil.rmtree(logdir, ignore_errors=True)
    _, totals = classify_ops(rows)
    report = roofline_report(ff, sec, totals, n_devices=1, dtype=dtype)
    report.update(model=model, batch_size=batch_size, dtype=dtype,
                  device=str(dev), images_per_sec=batch_size / sec,
                  top_ops=top_rows(rows, top_n),
                  kernel_launches=launches)
    if not cuda:
        report["mfu"] = report["hbm_utilization"] = None
    return report


def main(argv=None, log=print):
    from flexflow_tpu_torch.config import flag_stream

    argv = list(sys.argv[1:] if argv is None else argv)
    model, batch, out = "inception", 256, ""
    iters, dtype, top_n, device = 10, "bfloat16", 25, "cuda"
    if argv and not argv[0].startswith("-"):
        model = argv.pop(0)
    for a, val in flag_stream(argv):
        if a in ("-b", "--batch-size"):
            batch = int(val())
        elif a in ("-o", "--out"):
            out = val()
        elif a in ("-i", "--iters"):
            iters = int(val())
        elif a == "--dtype":
            dtype = val()
        elif a == "--top":
            top_n = int(val())
        elif a == "--device":
            device = val()
    report = profile_model(model, batch, iters, dtype, top_n, device)
    log(json.dumps({k: v for k, v in report.items() if k != "top_ops"},
                   indent=1, default=str))
    if out:
        os.makedirs(os.path.dirname(out) or ".", exist_ok=True)
        with open(out, "w") as f:
            json.dump(report, f, indent=1, default=str)
        log(f"report written to {out}")
    return report


if __name__ == "__main__":
    main()
