"""Run configuration (PyTorch port): the ``FFConfig`` fields the ported
paths read — serving, and training through ``FFModel.fit`` with its
checkpoints (synchronous or asynchronous), health guard, step watchdog,
preemption drain, live metrics, prefetch, fault injection, run telemetry
and sampled op timing, profiling and its trace, elastic training with
its decomposed re-search, the file datasets, the drivers' static plan
check, the reference's three verification switches (SURVEY §4:
``--params-ones``, ``--dry-compile``, ``--print-intermediates``) and the
search's and executor's switches (``-chains``, ``-delta``,
``-regrid-planner``, ``-placed-overlap``, ``-pallas``) — with the JAX
package's defaults
(``flexflow_tpu/config.py``), but for ``prefetch_depth``: 0 here, where
the JAX default is 2 (the port's synthetic sources already yield tensors
on the card).  ``-regrid-planner``, ``-placed-overlap`` and ``-pallas``
are checked and not stored: the port runs one value of each.

:meth:`FFConfig.from_args` parses the JAX parser's flag names for these
fields and ignores unknown flags like the reference parser, including
``-s/--strategy`` (a strategy file, JSON or proto2) and ``-ll:gpu`` (the
number of GPUs, which must equal the world size; checked by the app) and
the serving runtime's ``--max-batch`` and ``--serve-*`` flags
(``SERVE_FIELDS``).  A flag of the JAX parser whose feature is not ported
yet (``UNPORTED_FLAGS``: the fleet's) raises ``NotImplementedError``
instead of being dropped silently.  A switch
value whose behaviour the port does not have (``RESTRICTED_VALUES``:
``-regrid-planner off``, ``-placed-overlap off``, ``-pallas auto|off``)
is refused with the reason (``SystemExit``), as a malformed value is.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Iterator, Sequence, Tuple

from flexflow_tpu_torch.strategy import Strategy
from flexflow_tpu_torch.utils.faultinject import (FaultSpecError,
                                                  parse_fault_spec)

#: flags of ``flexflow_tpu/config.py:FFConfig.from_args`` whose features
#: the port does not have yet
UNPORTED_FLAGS = frozenset((
    "--fleet-quantum", "--fleet-search-budget-s",
))

#: the serving runtime's flags (``apps/serve.py``, ``serve/``), parsed
#: as ``flexflow_tpu/config.py:367-377`` parses them: flag -> field
SERVE_FIELDS: Dict[str, str] = {
    "--max-batch": "max_batch",
    "--serve-queue-hi": "serve_queue_hi",
    "--serve-idle-boundaries": "serve_idle_boundaries",
    "--serve-prefill-devices": "serve_prefill_devices",
    "--serve-prefill-replicas": "serve_prefill_replicas",
    "--serve-decode-replicas": "serve_decode_replicas",
}

#: the switches whose values the port's behaviour restricts: field ->
#: (the values the port runs, {refused value: the reason})
RESTRICTED_VALUES: Dict[str, Tuple[Tuple[str, ...], Dict[str, str]]] = {
    "search_delta": (("on", "off", "check"), {}),
    "regrid_planner": (("on",), {
        "off": "the port has only the planned regrid path (JAX's 'off' "
               "is its legacy per-trace path, flexflow_tpu/model.py:"
               "1035-1041)"}),
    "placed_overlap": (("on",), {
        "off": "the port runs a process per rank, so the ops placed on "
               "disjoint device blocks always run at once, as JAX's "
               "grouped dispatch ('on') runs them; JAX's 'off' serializes "
               "them (flexflow_tpu/parallel/placement.py:405-420)"}),
    "pallas": (("on",), {
        "auto": "a tensor on the card always goes through its "
                "hand-written kernel (no size-gated routing to plain "
                "versions)",
        "off": "a tensor on the card always goes through its "
               "hand-written kernel (no switch to plain versions)"}),
}

#: the flags of the restricted switches and the search's chain count:
#: flag -> the switch's name, JAX's field
#: (``flexflow_tpu/config.py:319-325, 384-385``)
SWITCH_VALUE_FLAGS = {
    "-chains": "search_chains", "--chains": "search_chains",
    "-delta": "search_delta", "--delta": "search_delta",
    "-regrid-planner": "regrid_planner",
    "--regrid-planner": "regrid_planner",
    "-placed-overlap": "placed_overlap",
    "--placed-overlap": "placed_overlap",
    "-pallas": "pallas", "--pallas": "pallas",
}

#: the fields of ``SWITCH_VALUE_FLAGS`` that ``FFConfig`` stores
SEARCH_FIELDS = ("search_chains", "search_delta")

#: the verification switches (SURVEY §4), which take no value: flag ->
#: (field, the value it sets)
VERIFY_FLAGS = {
    "--params-ones": ("params_init", "ones"),
    "--print-intermediates": ("print_intermediates", True),
    "--dry-compile": ("dry_compile", True),
}


def checked_value(flag: str, field: str, v: str) -> str:
    """A restricted switch's value: one the port runs, or a
    ``SystemExit`` that says why not."""
    ok, refused = RESTRICTED_VALUES[field]
    if v in refused:
        raise SystemExit(f"{flag} {v}: refused by flexflow_tpu_torch: "
                         f"{refused[v]}")
    if v not in ok:
        raise SystemExit(f"{flag} must be {'|'.join(ok + tuple(refused))}, "
                         f"got {v!r}")
    return v


def parse_switch(cfg, flag: str, take) -> bool:
    """Parse one of ``VERIFY_FLAGS`` or ``SWITCH_VALUE_FLAGS`` into
    ``cfg`` (``take()`` reads the value); False for any other flag.

    A verification switch sets its field.  ``-chains`` and ``-delta``
    set the search's fields where ``cfg`` has them (``FFConfig``); the
    JAX LM and NMT drivers ignore both, and so does a model config here.
    ``-regrid-planner``, ``-placed-overlap`` and ``-pallas`` are checked
    and not stored: the port runs only the value they accept."""
    if flag in VERIFY_FLAGS:
        field, value = VERIFY_FLAGS[flag]
        setattr(cfg, field, value)
        return True
    field = SWITCH_VALUE_FLAGS.get(flag)
    if field is None or field in SEARCH_FIELDS and not hasattr(cfg, field):
        return False
    v = take()
    if field == "search_chains":
        cfg.search_chains = int(v)
    elif field == "search_delta":
        cfg.search_delta = checked_value(flag, field, v)
    else:
        checked_value(flag, field, v)
    return True


def unported(flag: str, where: str) -> NotImplementedError:
    """The refusal of a flag in ``UNPORTED_FLAGS``; ``where`` names the
    JAX module that has it."""
    return NotImplementedError(
        f"{flag}: not ported to flexflow_tpu_torch yet (the JAX package's "
        f"{where} has it)")


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

#: elastic training's flags (``utils/elastic.py``, ``FFModel.fit``),
#: parsed as ``flexflow_tpu/config.py:338-363`` parses them
ELASTIC_FIELDS: Dict[str, Tuple[str, Callable]] = {
    "--elastic": ("elastic", bool),
    "--min-devices": ("min_devices", int),
    "--research-budget-s": ("research_budget_s", float),
    "--elastic-search-iters": ("elastic_search_iters", int),
    "--max-regrows": ("max_regrows", int),
    "--regrow-probes": ("regrow_probes", int),
    "--transient-reset-steps": ("transient_reset_steps", int),
}
ELASTIC_FLAGS = frozenset(ELASTIC_FIELDS)

#: the decomposed re-search's flags (``utils/elastic.py:research_strategy``
#: under ``decompose``), parsed as ``flexflow_tpu/config.py:347-352``
DECOMPOSE_FIELDS: Dict[str, Tuple[str, Callable]] = {
    "--decompose": ("decompose", bool),
    "--block-budget-s": ("block_budget_s", float),
    "--boundary-refine-iters": ("boundary_refine_iters", int),
}

#: the file datasets' and the profiler's flags (``apps.cnn``'s
#: ``make_data``, ``FFModel.fit``), parsed as
#: ``flexflow_tpu/config.py:276-345``; ``--epochs`` is parsed and unused,
#: as there
DATA_FLAGS: Dict[str, Tuple[str, Callable]] = {
    "-d": ("dataset_path", str),
    "--dataset": ("dataset_path", str),
    "-e": ("epochs", int),
    "--epochs": ("epochs", int),
    "-ll:cpu": ("loaders_per_node", int),
    "--data-retry-attempts": ("data_retry_attempts", int),
    "--data-skip-budget": ("data_skip_budget", int),
    "--profiling": ("profiling", bool),
    "--trace-dir": ("trace_dir", str),
}

#: the training runtime's flags (``FFModel.fit``: checkpoints, the
#: asynchronous checkpoint writer, the health guard, the step watchdog,
#: the preemption drain's budget, live metrics, prefetch, fault
#: injection, elastic training): flag -> (field, parse); a flag of
#: ``SWITCH_FLAGS`` takes no value and sets its field True
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
    **ELASTIC_FIELDS,
    **DECOMPOSE_FIELDS,
}
SWITCH_FLAGS = frozenset(("--ckpt-async", "--elastic", "--decompose",
                          "--profiling"))


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
    # elastic training (utils/elastic.py): a rank lost at a boundary
    # shrinks the run onto the surviving ranks (re-searched strategy,
    # live state migrated in memory, checkpoint fallback) instead of a
    # fatal error; below min_devices ranks the shrink is refused.  The
    # re-search stops at research_budget_s seconds or
    # elastic_search_iters proposals.  After a shrink the lost ranks are
    # probed at the boundaries; regrow_probes consecutive answering
    # probes grow the run back, at most max_regrows times.  A transient
    # device error retries its step, at most 3 times until
    # transient_reset_steps healthy steps refill the budget (0: never)
    elastic: bool = False
    min_devices: int = 1
    research_budget_s: float = 30.0
    elastic_search_iters: int = 2000
    max_regrows: int = 1
    regrow_probes: int = 2
    transient_reset_steps: int = 16
    # the decomposed re-search (sim/search.py:search_decomposed): every
    # elastic re-search runs per block, research_budget_s then capping
    # the whole of it, block_budget_s each block's (0 = proposals
    # only), boundary_refine_iters the proposals of the refinement pass
    # (0 = 20 % of the budget)
    decompose: bool = False
    block_budget_s: float = 0.0
    boundary_refine_iters: int = 0
    # the file datasets (apps.cnn's make_data): an ImageNet-style
    # directory or a comma-separated list of .h5/.hdf5 files ("" =
    # synthetic data), the native loader's decode threads, and the
    # readers' attempts per item and skips per run
    dataset_path: str = ""
    loaders_per_node: int = 4
    data_retry_attempts: int = 4
    data_skip_budget: int = 16
    # the reference's epoch count: parsed, unused (as in the JAX package)
    epochs: int = 10
    # fit's profiling: after the loop the step roofline from step_flops
    # and the per-op table (utils/profiling.OpProfiler); trace_dir: a
    # torch.profiler Chrome trace of the loop written there ("" = none)
    profiling: bool = False
    trace_dir: str = ""
    # the verification switches (SURVEY §4): params_init "ones" sets
    # every parameter leaf to 1.0 whatever the seed (PARAMETER_ALL_ONES);
    # print_intermediates prints every op output's statistics
    # (utils/debug.py, PRINT_INTERMEDIATE_RESULT); dry_compile builds the
    # model and its plan and traces one step on the meta device, running
    # nothing (DISABLE_COMPUTATION)
    params_init: str = "default"
    print_intermediates: bool = False
    dry_compile: bool = False
    # the strategy search's chains and delta mode (parsed as JAX parses
    # them; apps.search reads its own flags)
    search_chains: int = 1
    search_delta: str = "on"
    # the serving runtime (apps/serve.py's options come from these
    # fields, apps.serve.parse_args): max_batch caps the continuous
    # batcher's decode slots (0 = batch_size); serve_queue_hi is the
    # queue depth that grows parked ranks back, serve_idle_boundaries
    # the idle decode boundaries that shrink the world (0 = off); over
    # serve_prefill_devices > 0 cards a prefill pool of
    # serve_prefill_replicas engines and a decode pool of
    # serve_decode_replicas take the load (serve/router.py)
    max_batch: int = 0
    serve_queue_hi: int = 0
    serve_idle_boundaries: int = 0
    serve_prefill_devices: int = 0
    serve_prefill_replicas: int = 1
    serve_decode_replicas: int = 1

    @classmethod
    def from_args(cls, argv: Sequence[str]) -> "FFConfig":
        """Parse the JAX parser's flags for the fields above: -b/--batch-size,
        --lr/--learning-rate, --wd/--weight-decay, -p/--print-freq,
        -i/--iters/--iterations, --dtype, -param-dtype/--param-dtype,
        --seed, --height, --width, --classes, -s/--strategy, -ll:gpu,
        --allow-degraded, ``RUNTIME_FLAGS``, ``OBS_FLAGS``,
        ``DATA_FLAGS``, ``SERVE_FIELDS``, ``VERIFY_FLAGS`` and
        ``SWITCH_VALUE_FLAGS``."""
        cfg = cls()
        for a, val in flag_stream(argv):
            if a in UNPORTED_FLAGS:
                raise unported(a, "flexflow_tpu/config.py")
            if parse_switch(cfg, a, val):
                continue
            if a in SERVE_FIELDS:
                setattr(cfg, SERVE_FIELDS[a], int(val()))
            elif a in ("-s", "--strategy"):
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
            elif a in RUNTIME_FLAGS or a in OBS_FLAGS or a in DATA_FLAGS:
                field, parse = {**RUNTIME_FLAGS, **OBS_FLAGS, **DATA_FLAGS}[a]
                setattr(cfg, field,
                        True if a in SWITCH_FLAGS else parse(val()))
            # unknown flags are ignored, like the reference parser
        return cfg
