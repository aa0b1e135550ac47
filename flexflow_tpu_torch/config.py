"""Run configuration (PyTorch port): the ``FFConfig`` fields the ported
paths read — serving, and training through ``FFModel.fit`` with its
checkpoints (synchronous or asynchronous), health guard, step watchdog,
preemption drain, live metrics, prefetch, fault injection, run telemetry
and sampled op timing, and the drivers' static plan check — with the JAX
package's defaults (``flexflow_tpu/config.py``), but for
``prefetch_depth``: 0 here, where the JAX default is 2 (the port's
synthetic sources already yield tensors on the card).

:meth:`FFConfig.from_args` parses the JAX parser's flag names for these
fields and ignores unknown flags like the reference parser, including
``-s/--strategy`` (a strategy file, JSON or proto2) and ``-ll:gpu`` (the
number of GPUs, which must equal the world size; checked by the app).  A
flag of the JAX parser whose feature is not ported yet (elastic
training, datasets, profiling, ...) raises ``NotImplementedError``
instead of being dropped silently.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Iterator, Sequence, Tuple

from flexflow_tpu_torch.strategy import Strategy
from flexflow_tpu_torch.utils.faultinject import (FaultSpecError,
                                                  parse_fault_spec)

#: the elastic runtime's flags (``flexflow_tpu/utils/elastic.py``), not
#: ported yet
ELASTIC_FLAGS = frozenset((
    "--elastic", "--min-devices", "--research-budget-s",
    "--elastic-search-iters", "--max-regrows", "--regrow-probes",
    "--transient-reset-steps"))

#: flags of ``flexflow_tpu/config.py:FFConfig.from_args`` whose features
#: the port does not have yet
UNPORTED_FLAGS = frozenset((
    "-e", "--epochs", "-d", "--dataset", "-ll:cpu", "--profiling",
    "--trace-dir", "-chains",
    "--chains", "-delta", "--delta", "-regrid-planner", "--regrid-planner",
    "-placed-overlap", "--placed-overlap", "--data-retry-attempts",
    "--data-skip-budget", "--decompose", "--block-budget-s",
    "--boundary-refine-iters", "--max-batch",
    "--serve-queue-hi", "--serve-idle-boundaries", "--serve-prefill-devices",
    "--serve-prefill-replicas", "--serve-decode-replicas",
    "--fleet-quantum", "--fleet-search-budget-s", "-pallas", "--pallas",
    "--params-ones", "--print-intermediates", "--dry-compile",
)) | ELASTIC_FLAGS

#: where the ROADMAP takes up some of those flags
UNPORTED_WHERE = {
    **{flag: "ROADMAP Queue A item 5, the rest of the training runtime"
       for flag in ("--profiling", "--trace-dir")},
    **{flag: "ROADMAP Queue A item 5, elastic training"
       for flag in ELASTIC_FLAGS}}


def unported(flag: str, where: str) -> NotImplementedError:
    """The refusal of a flag in ``UNPORTED_FLAGS``; ``where`` names the
    JAX module that has it."""
    extra = f"; {UNPORTED_WHERE[flag]}" if flag in UNPORTED_WHERE else ""
    return NotImplementedError(
        f"{flag}: not ported to flexflow_tpu_torch yet (the JAX package's "
        f"{where} has it{extra})")


def _checked_policy(v: str) -> str:
    """An ``--on-divergence`` value, checked when parsed."""
    if v not in ("halt", "warn", "rollback"):
        raise SystemExit(
            f"--on-divergence must be halt|warn|rollback, got {v!r}")
    return v


def _checked_fault_spec(v: str) -> str:
    """A ``--fault-spec`` string, checked when parsed, so that a
    misspelt kind fails at once instead of never firing."""
    try:
        parse_fault_spec(v)
    except FaultSpecError as e:
        raise SystemExit(f"--fault-spec: {e}")
    return v


#: the run telemetry's flags (``FFModel.fit``'s obs records and sampled
#: op timing): flag -> (field, parse)
OBS_FLAGS: Dict[str, Tuple[str, Callable]] = {
    "-obs-dir": ("obs_dir", str),
    "--obs-dir": ("obs_dir", str),
    "-run-id": ("run_id", str),
    "--run-id": ("run_id", str),
    "--obs-max-bytes": ("obs_max_bytes", int),
    "-op-time-every": ("op_time_every", int),
    "--op-time-every": ("op_time_every", int),
}

#: the training runtime's flags (``FFModel.fit``: checkpoints, the
#: asynchronous checkpoint writer, the health guard, the step watchdog,
#: the preemption drain's budget, live metrics, prefetch, fault
#: injection): flag -> (field, parse); a flag of ``SWITCH_FLAGS`` takes
#: no value and sets its field True
RUNTIME_FLAGS: Dict[str, Tuple[str, Callable]] = {
    "--ckpt-dir": ("ckpt_dir", str),
    "--ckpt-freq": ("ckpt_freq", int),
    "-prefetch-depth": ("prefetch_depth", int),
    "--prefetch-depth": ("prefetch_depth", int),
    "-on-divergence": ("on_divergence", _checked_policy),
    "--on-divergence": ("on_divergence", _checked_policy),
    "-max-rollbacks": ("max_rollbacks", int),
    "--max-rollbacks": ("max_rollbacks", int),
    "-fault-spec": ("fault_spec", _checked_fault_spec),
    "--fault-spec": ("fault_spec", _checked_fault_spec),
    "--ckpt-async": ("ckpt_async", bool),
    "--hang-factor": ("hang_factor", float),
    "--hang-min-s": ("hang_min_s", float),
    "--drain-budget-s": ("drain_budget_s", float),
    "-metrics-path": ("metrics_path", str),
    "--metrics-path": ("metrics_path", str),
}
SWITCH_FLAGS = frozenset(("--ckpt-async",))


def flag_stream(argv: Sequence[str]) -> Iterator[Tuple[str, Callable]]:
    """Yield ``(flag, take)`` pairs over ``argv``; ``take()`` consumes and
    returns the next argument as the flag's value, raising ValueError at
    the end of the arguments (``flexflow_tpu/utils/flags.py``)."""
    args = list(argv)
    i = 0

    def take() -> str:
        nonlocal i
        i += 1
        if i >= len(args):
            raise ValueError(f"flag {args[i - 1]!r} expects a value")
        return args[i]

    while i < len(args):
        yield args[i], take
        i += 1


@dataclasses.dataclass
class FFConfig:
    batch_size: int = 64
    num_iterations: int = 10
    # fit() prints the loss every print_freq iterations (0: never)
    print_freq: int = 10
    input_height: int = 224
    input_width: int = 224
    learning_rate: float = 0.01
    weight_decay: float = 1e-4
    momentum: float = 0.0
    # dtype of the activations ("float32" or "bfloat16")
    compute_dtype: str = "float32"
    # STORAGE dtype of the parameters; anything but float32 is mixed
    # precision: float32 masters ride in the optimizer state, and the
    # steps cast float params to compute_dtype
    param_dtype: str = "float32"
    seed: int = 0
    num_classes: int = 1000
    strategies: Strategy = dataclasses.field(default_factory=Strategy)
    # the strategy file -s/--strategy loaded ("" = none)
    strategy_file: str = ""
    # -ll:gpu: the number of GPUs the run expects (0 = the world's)
    workers_per_node: int = 0
    # checkpoint/resume directory ("" = none) and the save interval (0 =
    # after the last step only)
    ckpt_dir: str = ""
    ckpt_freq: int = 0
    # batches staged on the device ahead of the loop (0 = the synchronous
    # pull in the loop)
    prefetch_depth: int = 0
    # what the step health guard does on a non-finite loss: "halt"
    # (raise TrainingDiverged), "warn", or "rollback" (restore the newest
    # verified checkpoint, at most max_rollbacks times)
    on_divergence: str = "halt"
    max_rollbacks: int = 3
    # deterministic fault injection (utils/faultinject.py), e.g.
    # "loss_nan@120,data_io@50x3,ckpt_truncate@2"; "" = off
    fault_spec: str = ""
    # run telemetry (obs/): with obs_dir set, fit() appends its records
    # to <obs_dir>/<run_id>.jsonl (run_id "" = a fresh one), rolling over
    # to a numbered sibling at obs_max_bytes (0 = never)
    obs_dir: str = ""
    run_id: str = ""
    obs_max_bytes: int = 64 * 1024 * 1024
    # the asynchronous checkpoint writer (utils/checkpoint.py): the
    # serialization, digests and commit on a worker thread, at most one
    # save in flight; fit waits for it at the final save and before a
    # rollback's restore
    ckpt_async: bool = False
    # the step watchdog (utils/health.StepWatchdog): a boundary's deadline
    # is hang_factor x the median per-step wall time, at least hang_min_s
    # (0 = off, no timer threads)
    hang_factor: float = 0.0
    hang_min_s: float = 60.0
    # the preemption drain (utils/elastic.py): wall budget for committing
    # the last checkpoint after SIGTERM/SIGINT
    drain_budget_s: float = 60.0
    # live metrics (obs/metrics.py): a Prometheus textfile rewritten at
    # this path (and <path>.json) at fit's boundaries; "" = off
    metrics_path: str = ""
    # sampled per-op timing in fit(): every Nth step is synced and its
    # forward / backward / optimizer sections timed, and one shard of
    # every op is timed after the loop, all as op_time records (0 = off;
    # needs obs_dir to be written)
    op_time_every: int = 0
    # the drivers' static plan check (verify/plan.py) demotes the
    # degradation findings to warnings instead of refusing the run
    allow_degraded: bool = False

    @classmethod
    def from_args(cls, argv: Sequence[str]) -> "FFConfig":
        """Parse the JAX parser's flags for the fields above: -b/--batch-size,
        --lr/--learning-rate, --wd/--weight-decay, -p/--print-freq,
        -i/--iters/--iterations, --dtype, -param-dtype/--param-dtype,
        --seed, --height, --width, --classes, -s/--strategy, -ll:gpu,
        --allow-degraded, ``RUNTIME_FLAGS`` and ``OBS_FLAGS``."""
        cfg = cls()
        for a, val in flag_stream(argv):
            if a in UNPORTED_FLAGS:
                raise unported(a, "flexflow_tpu/config.py")
            if a in ("-s", "--strategy"):
                cfg.strategy_file = val()
                cfg.strategies = Strategy.load(cfg.strategy_file)
            elif a == "-ll:gpu":
                cfg.workers_per_node = int(val())
            elif a in ("-b", "--batch-size"):
                cfg.batch_size = int(val())
            elif a in ("--lr", "--learning-rate"):
                cfg.learning_rate = float(val())
            elif a in ("--wd", "--weight-decay"):
                cfg.weight_decay = float(val())
            elif a in ("-p", "--print-freq"):
                cfg.print_freq = int(val())
            elif a in ("-i", "--iters", "--iterations"):
                cfg.num_iterations = int(val())
            elif a == "--dtype":
                cfg.compute_dtype = val()
            elif a in ("-param-dtype", "--param-dtype"):
                cfg.param_dtype = val()
            elif a == "--seed":
                cfg.seed = int(val())
            elif a == "--height":
                cfg.input_height = int(val())
            elif a == "--width":
                cfg.input_width = int(val())
            elif a == "--classes":
                cfg.num_classes = int(val())
            elif a == "--allow-degraded":
                cfg.allow_degraded = True
            elif a in RUNTIME_FLAGS or a in OBS_FLAGS:
                field, parse = {**RUNTIME_FLAGS, **OBS_FLAGS}[a]
                setattr(cfg, field,
                        True if a in SWITCH_FLAGS else parse(val()))
            # unknown flags are ignored, like the reference parser
        return cfg
