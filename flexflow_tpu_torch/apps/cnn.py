"""CNN training entry point (PyTorch port of ``flexflow_tpu/apps/cnn.py``).

    python -m flexflow_tpu_torch.apps.cnn inception -b 256 -i 10 \\
        --dtype bfloat16 [--device cuda|cpu] [--warmup N]
    python -m flexflow_tpu_torch.apps.cnn densenet -b 64 -i 13 \\
        --warmup 3 --dtype bfloat16
    python -m flexflow_tpu_torch.apps.cnn resnet101 -b 64 -i 13 \\
        --warmup 3 --dtype bfloat16
    python -m flexflow_tpu_torch.apps.cnn vgg16 -b 64 -i 13 \\
        --warmup 3 --dtype bfloat16
    python -m flexflow_tpu_torch.apps.cnn alexnet -b 2 -i 3 --height 67 \\
        --width 67 --device cpu
    torchrun --nproc-per-node 4 -m flexflow_tpu_torch.apps.cnn alexnet \\
        -b 64 -s strategy.json -ll:gpu 4

Flags are ``FFConfig.from_args`` (the JAX app's names for the ported
fields: -b, --lr, --wd, -p, -i, --dtype, --param-dtype, --seed, --height,
--width, --classes, -s/--strategy, -ll:gpu, --allow-degraded, ``fit``'s
runtime flags --ckpt-dir, --ckpt-freq, --prefetch-depth, --on-divergence,
--max-rollbacks, --fault-spec, its supervision flags --ckpt-async,
--hang-factor, --hang-min-s, --drain-budget-s, -metrics-path, and its
telemetry flags -obs-dir, -run-id, --obs-max-bytes, -op-time-every),
plus
``--device`` (default ``cuda``: the run raises
when CUDA is absent unless ``--device cpu`` is given), ``--warmup``
(untimed steps before the timed window, default 1 as in ``fit``) and
``--result-json PATH`` (rank 0 writes ``fit``'s result there: the
losses, the rate, the peak device memory, the kernel launches, the bytes
its halo exchanges moved, the param
keys and state entries it holds; rank r > 0 writes its own to
``PATH.rank<r>``) and
``--dist-backend NAME`` (the process group's backend under torchrun:
NCCL on CUDA and gloo on the CPU unless named).  Models
(the JAX app's names): ``alexnet``, ``vgg16``/``vgg``,
``resnet101``/``resnet`` (the reference's topology: no BN, no residual
add) and ``densenet``/``densenet121`` at 224x224 unless --height/--width
are given, ``inception``/``inception_v3`` at 299x299.
The input is seeded random synthetic data (``data/synthetic.py``,
``mode="random"``).  Prints the reference's metric line
``time = %.4fs, tp = %.2f images/s``.  The JAX app's datasets,
elastic training and profiling raise ``NotImplementedError`` when asked
for (``config.UNPORTED_FLAGS``).  A drained run (SIGTERM, SIGINT, an
injected ``preempt``) logs ``drained at iteration N`` and exits 0.

A strategy file is checked before the model is built, as in the JAX
app (``flexflow_tpu/apps/cnn.py:100-116``): :func:`check_strategy` runs
``verify.plan.check_plan`` on a shadow of the model built without the
strategy on a virtual machine of the world's size, and the run exits
with status 2 and the findings when one is an error;
``--allow-degraded`` demotes the degradation findings (a device list
the executor would normalize, a grid it would replicate) to warnings.

With ``-obs-dir D`` rank 0 writes ``fit``'s records to
``D/<run-id>.jsonl``, and with ``-op-time-every N`` as well its sampled
op timing (``FFModel.fit``).

Under ``torchrun`` (``WORLD_SIZE`` in the environment) every rank joins
one process group (``distributed.initialize``: NCCL on
``cuda:LOCAL_RANK``, gloo with ``--device cpu``), each op runs on the
grid the strategy file gives it, ``-b`` is the global batch and every
rank draws it and keeps its rows.  ``-ll:gpu N`` must equal the world
size (1 without torchrun).  Rank 0 alone logs and returns ``fit``'s
result.
"""

from __future__ import annotations

import os
import sys

import torch

from flexflow_tpu_torch.config import FFConfig

MODELS = ("alexnet", "vgg16", "vgg", "inception", "inception_v3",
          "resnet101", "resnet", "densenet", "densenet121")


def _flag_value(argv, name, default):
    """``(value, argv without the flag)`` for one flag of this app alone."""
    rest, value = [], default
    it = iter(argv)
    for a in it:
        if a == name:
            value = next(it, None)
            if value is None:
                raise ValueError(f"flag {name!r} expects a value")
        else:
            rest.append(a)
    return value, rest


def build(model_name: str, cfg: FFConfig, device):
    """The model named ``model_name`` on ``device``, a device or a
    ``MachineModel`` (299x299 input for Inception unless --height/--width
    were given)."""
    from flexflow_tpu_torch.machine import MachineModel
    from flexflow_tpu_torch.models.alexnet import build_alexnet
    from flexflow_tpu_torch.models.densenet import build_densenet121
    from flexflow_tpu_torch.models.inception import build_inception_v3
    from flexflow_tpu_torch.models.resnet import build_resnet101
    from flexflow_tpu_torch.models.vgg import build_vgg16

    machine = device if isinstance(device, MachineModel) \
        else MachineModel(device)
    if model_name == "alexnet":
        return build_alexnet(cfg, machine)
    if model_name.startswith("vgg"):
        return build_vgg16(cfg, machine)
    if model_name.startswith("resnet"):
        return build_resnet101(cfg, machine)
    if model_name.startswith("densenet"):
        return build_densenet121(cfg, machine)
    return build_inception_v3(cfg, machine)


def parse(argv):
    """``(model_name, cfg, device, warmup)`` from the command line."""
    argv = list(argv)
    model_name = "alexnet"
    if argv and not argv[0].startswith("-"):
        model_name = argv.pop(0)
    if model_name not in MODELS:
        raise SystemExit(f"model {model_name!r} is not ported yet; choose "
                         f"from {list(MODELS)}")
    device, argv = _flag_value(argv, "--device", "cuda")
    warmup, argv = _flag_value(argv, "--warmup", "1")
    if model_name.startswith("inception"):
        argv = ["--height", "299", "--width", "299"] + argv
    cfg = FFConfig.from_args(argv)
    return model_name, cfg, device, int(warmup)


def _write_result(path: str, out: dict, machine) -> None:
    """``fit``'s result (its trees replaced by the keys this rank holds)
    with the launches, the bytes its halo exchanges moved and the peak
    memory, to ``path`` on rank 0 and ``path.rank<r>`` on rank r."""
    import json

    from flexflow_tpu_torch.ops import kernels
    from flexflow_tpu_torch.parallel import collectives

    res = {k: v for k, v in out.items()
           if k not in ("params", "state", "opt_state")}
    res.update(launches=dict(kernels.launches),
               halo_bytes=collectives.halo_bytes(),
               leaves={"params": sorted(out["params"]),
                       "state": sorted(out["state"])})
    if machine.device.type == "cuda":
        res["peak_memory_bytes"] = torch.cuda.max_memory_allocated(
            machine.device)
    if machine.rank:
        path = f"{path}.rank{machine.rank}"
    with open(path, "w") as f:
        json.dump(res, f)


def machine_for(device, backend=None):
    """The run's machine: the world of ranks under ``torchrun``
    (``WORLD_SIZE`` set), else this one process on ``device`` (the model
    checks ``-ll:gpu`` against its size)."""
    from flexflow_tpu_torch import distributed
    from flexflow_tpu_torch.machine import MachineModel

    if "WORLD_SIZE" in os.environ:
        return distributed.initialize(device, backend=backend)
    return MachineModel(device)


def check_strategy(build_shadow, strategies, machine, allow_degraded: bool,
                   label: str) -> list:
    """The drivers' static plan check: ``verify.plan.check_plan`` of
    ``strategies`` against ``build_shadow(virtual)``, a model built
    without them on a virtual machine of ``machine``'s size and links
    (it opens no process group and draws no parameters).  Exits with
    status 2 when a finding is an error; returns the findings."""
    from flexflow_tpu_torch.machine import MachineModel
    from flexflow_tpu_torch.verify.plan import check_plan

    virtual = MachineModel.virtual(machine.num_devices, machine.topology)
    return check_plan(build_shadow(virtual), strategies, virtual,
                      allow_degraded=allow_degraded, label=label)


def main(argv=None, log=print) -> dict:
    """One training run; returns ``fit``'s result without the trees (on
    rank 0; None on the other ranks)."""
    from flexflow_tpu_torch.data import synthetic_batches

    argv = list(sys.argv[1:] if argv is None else argv)
    result_json, argv = _flag_value(argv, "--result-json", "")
    backend, argv = _flag_value(argv, "--dist-backend", None)
    model_name, cfg, device, warmup = parse(argv)
    machine = machine_for(device, backend)
    dev = machine.device
    if machine.rank != 0:
        def log(*args, **kwargs):
            pass
    if dev.type == "cuda":
        # float32 references run their products in float32, not TF32
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    if cfg.strategies:
        import dataclasses

        from flexflow_tpu_torch.strategy import Strategy

        shadow = dataclasses.replace(cfg, strategies=Strategy(),
                                     strategy_file="")
        check_strategy(lambda m: build(model_name, shadow, m),
                       cfg.strategies, machine, cfg.allow_degraded,
                       cfg.strategy_file or "strategies")
    ff = build(model_name, cfg, machine)
    log(f"{model_name}: {len(ff.layers)} layers, batch {cfg.batch_size}, "
        f"{cfg.input_height}x{cfg.input_width}, {cfg.compute_dtype} compute, "
        f"{cfg.param_dtype} params, on {dev}"
        + (f", {machine.num_devices} ranks, strategy {cfg.strategy_file}"
           if machine.distributed else ""))
    data = synthetic_batches(cfg.batch_size, cfg.input_height,
                             cfg.input_width, num_classes=cfg.num_classes,
                             mode="random", seed=cfg.seed, machine=machine)
    out = ff.fit(data, warmup=warmup, log=log)
    if out.get("drained"):
        # a graceful drain: exit 0 is the scheduler's contract
        log(f"drained at iteration {out.get('completed_steps')}; "
            f"exiting 0 (resume from --ckpt-dir to continue)")
    if result_json:
        _write_result(result_json, out, machine)
    for key in ("params", "state", "opt_state"):
        out.pop(key)
    return out if machine.rank == 0 else None


if __name__ == "__main__":
    from flexflow_tpu_torch import distributed as _dist

    main()
    _dist.shutdown()
    sys.exit(0)
