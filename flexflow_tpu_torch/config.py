"""Run configuration (PyTorch port): the ``FFConfig`` fields the ported
paths read — serving, and training through ``FFModel.fit`` — with the
JAX package's defaults (``flexflow_tpu/config.py``).

:meth:`FFConfig.from_args` parses the JAX parser's flag names for these
fields and ignores unknown flags like the reference parser.  A flag of
the JAX parser whose feature is not ported yet (checkpoints, elastic
training, datasets, strategies over several devices, telemetry, ...)
raises ``NotImplementedError`` instead of being dropped silently.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Iterator, Sequence, Tuple

from flexflow_tpu_torch.strategy import Strategy

#: flags of ``flexflow_tpu/config.py:FFConfig.from_args`` whose features
#: the port does not have yet
UNPORTED_FLAGS = frozenset((
    "-e", "--epochs", "-d", "--dataset", "-s", "--strategy", "-ll:gpu",
    "-ll:cpu", "--profiling", "--trace-dir", "-obs-dir", "--obs-dir",
    "-run-id", "--run-id", "--obs-max-bytes", "-op-time-every",
    "--op-time-every", "-metrics-path", "--metrics-path", "-chains",
    "--chains", "-delta", "--delta", "-regrid-planner", "--regrid-planner",
    "-placed-overlap", "--placed-overlap", "-prefetch-depth",
    "--prefetch-depth", "-on-divergence", "--on-divergence",
    "-max-rollbacks", "--max-rollbacks", "-fault-spec", "--fault-spec",
    "--data-retry-attempts", "--data-skip-budget", "--elastic",
    "--min-devices", "--research-budget-s", "--elastic-search-iters",
    "--decompose", "--block-budget-s", "--boundary-refine-iters",
    "--max-regrows", "--regrow-probes", "--drain-budget-s", "--hang-factor",
    "--hang-min-s", "--transient-reset-steps", "--ckpt-async", "--max-batch",
    "--serve-queue-hi", "--serve-idle-boundaries", "--serve-prefill-devices",
    "--serve-prefill-replicas", "--serve-decode-replicas",
    "--fleet-quantum", "--fleet-search-budget-s", "--allow-degraded",
    "-pallas", "--pallas", "--ckpt-dir", "--ckpt-freq", "--params-ones",
    "--print-intermediates", "--dry-compile",
))

#: flags of ``flexflow_tpu/apps/lm.py:parse_args`` beyond the ones above
#: whose features the port does not have yet (mixture of experts and the
#: pipelined path)
LM_UNPORTED_FLAGS = frozenset((
    "--experts", "--moe-every", "--moe-top-k", "--pipeline-stages",
    "--microbatches", "--pipeline-tp",
))


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

    @classmethod
    def from_args(cls, argv: Sequence[str]) -> "FFConfig":
        """Parse the JAX parser's flags for the fields above: -b/--batch-size,
        --lr/--learning-rate, --wd/--weight-decay, -p/--print-freq,
        -i/--iters/--iterations, --dtype, -param-dtype/--param-dtype,
        --seed, --height, --width, --classes."""
        cfg = cls()
        for a, val in flag_stream(argv):
            if a in UNPORTED_FLAGS:
                raise NotImplementedError(
                    f"{a}: not ported to flexflow_tpu_torch yet (the JAX "
                    f"package's flexflow_tpu/config.py has it)")
            if a in ("-b", "--batch-size"):
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
            # unknown flags are ignored, like the reference parser
        return cfg
