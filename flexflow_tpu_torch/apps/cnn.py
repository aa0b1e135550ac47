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
--width, --classes, -s/--strategy, -ll:gpu, --allow-degraded, the data
flags -d/--dataset, -e/--epochs (parsed, unused), -ll:cpu,
--data-retry-attempts, --data-skip-budget, --profiling, --trace-dir,
``fit``'s runtime flags --ckpt-dir, --ckpt-freq, --prefetch-depth,
--on-divergence, --max-rollbacks, --fault-spec, its supervision flags
--ckpt-async,
--hang-factor, --hang-min-s, --drain-budget-s, -metrics-path, its
elastic flags --elastic, --min-devices, --research-budget-s,
--elastic-search-iters, --max-regrows, --regrow-probes,
--transient-reset-steps, its telemetry flags -obs-dir, -run-id,
--obs-max-bytes, -op-time-every, the verification switches
--params-ones, --dry-compile, --print-intermediates, the search's
-chains, -delta (parsed, unused, as in the JAX app) and the executor's
-regrid-planner, -placed-overlap, -pallas, which take ``on`` and refuse
the values the port does not run with the reason),
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
``mode="random"``) unless ``-d`` names a dataset (:func:`make_data`):
an ImageNet-style directory (``<root>/train/<class>/<file>``, decoded on
``-ll:cpu`` native loader threads or with PIL; ``num_classes`` is the
tree's class count unless ``--classes`` is given, which may not be
smaller) or a comma-separated list of ``.h5``/``.hdf5`` files, each
read under ``--data-retry-attempts`` tries per item and
``--data-skip-budget`` skips per run, their records on the ``data``
surface's obs sink.  ``--profiling`` logs the step roofline and the
per-op table after the loop, ``--trace-dir T`` writes a
``torch.profiler`` trace of the loop into T.  Prints the reference's
metric line ``time = %.4fs, tp = %.2f images/s``.  The JAX app's flags
of features not ported yet raise ``NotImplementedError``
(``config.UNPORTED_FLAGS``).  Under torchrun with ``--elastic`` a lost
rank shrinks the run onto the others (``FFModel.fit``, the builder as
its rebuild factory).  A drained run (SIGTERM, SIGINT, an
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
               leaves={"params": sorted(out["params"] or ()),
                       "state": sorted(out["state"] or ())})
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


def scan_dataset(cfg: FFConfig, argv):
    """The ImageNet-style tree ``-d`` names, scanned before the model is
    built so that the classifier's width matches the data
    (``flexflow_tpu/apps/cnn.py:82-97``): ``num_classes`` becomes the
    tree's class count, or with ``--classes`` must be at least that.
    None for synthetic data and for HDF5 files."""
    from flexflow_tpu_torch.data import ImageDataset

    if not cfg.dataset_path or cfg.dataset_path.endswith((".h5", ".hdf5")):
        return None
    dataset = ImageDataset(cfg.dataset_path, "train")
    if "--classes" in argv:
        if dataset.num_classes > cfg.num_classes:
            raise SystemExit(
                f"--classes {cfg.num_classes} but dataset has "
                f"{dataset.num_classes} class directories")
    else:
        cfg.num_classes = dataset.num_classes
    return dataset


def make_data(cfg: FFConfig, machine, dataset=None, olog=None, log=None):
    """The input the reference picks (``flexflow_tpu/apps/cnn.py:43-65``):
    synthetic unless ``-d`` was given; ``.h5``/``.hdf5`` files go to
    ``hdf5_batches``, a directory to ``image_batches`` with ``-ll:cpu``
    decode threads, shuffled from the seed.  The file sources retry and
    skip under the config's budgets and write their records on ``olog``
    (the caller's); every source yields this rank's rows on its device."""
    from flexflow_tpu_torch.data import (hdf5_batches, image_batches,
                                         synthetic_batches)

    if not cfg.dataset_path:
        return synthetic_batches(cfg.batch_size, cfg.input_height,
                                 cfg.input_width, num_classes=cfg.num_classes,
                                 mode="random", seed=cfg.seed,
                                 machine=machine)
    if cfg.dataset_path.endswith((".h5", ".hdf5")):
        return hdf5_batches(machine, cfg.dataset_path.split(","),
                            cfg.batch_size, olog=olog,
                            retry_attempts=cfg.data_retry_attempts,
                            skip_budget=cfg.data_skip_budget)
    return image_batches(machine, dataset, cfg.batch_size, cfg.input_height,
                         cfg.input_width, num_threads=cfg.loaders_per_node,
                         shuffle_seed=cfg.seed, olog=olog,
                         retry_attempts=cfg.data_retry_attempts,
                         skip_budget=cfg.data_skip_budget, log=log)


def main(argv=None, log=print) -> dict:
    """One training run; returns ``fit``'s result without the trees (on
    rank 0; None on the other ranks)."""
    from flexflow_tpu_torch import obs

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
    dataset = scan_dataset(cfg, argv)
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
    # the data surface's sink: the file sources' data_fault, recovery,
    # thread_leak and data_decoder records (one stream with fit's under a
    # shared -run-id); rank 0's alone, as fit's
    data_olog = obs.NULL if machine.rank else obs.from_config(
        cfg, surface="data")
    data = None
    try:
        data = make_data(cfg, machine, dataset, olog=data_olog, log=log)
        # build() doubles as the elastic rebuild factory
        out = ff.fit(data, warmup=warmup, log=log,
                     rebuild=lambda c, m: build(model_name, c, m))
    finally:
        if hasattr(data, "close"):
            data.close()
        data_olog.close()
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
