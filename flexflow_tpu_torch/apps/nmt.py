"""NMT seq2seq training entry point (PyTorch port of
``flexflow_tpu/apps/nmt.py``).

    python -m flexflow_tpu_torch.apps.nmt -b 64 -l 2 -s 20 -h 2048 -e 2048
    python -m flexflow_tpu_torch.apps.nmt -b 4 -l 2 -s 6 -h 16 -e 12 \\
        --vocab 64 --chunk 3 -i 3 --device cpu
    torchrun --nproc-per-node 2 -m flexflow_tpu_torch.apps.nmt \\
        --strategy strategy.json
    torchrun --nproc-per-node 2 -m flexflow_tpu_torch.apps.nmt \\
        --pipeline-stages 2

Flags are the reference's (-b batch, -l layers, -s sequence length, -h
hidden size, -e embed size) and the JAX app's extras for the ported
fields (--vocab, -i/--iters/--iterations, --chunk: LSTM steps per chunk
op, --lr, --dtype, --param-dtype, --seed, --strategy <file>,
--pipeline-stages S, --allow-degraded), plus ``--device`` (default
``cuda``: the run raises when CUDA is absent unless ``--device cpu`` is
given), ``--warmup`` (untimed steps before the timed window, default 1
as in ``fit``),
``--result-json PATH`` and ``--dist-backend NAME`` (as ``apps.cnn``'s).
``fit``'s runtime flags as the JAX app parses them (``NMT_RUNTIME_FLAGS``:
--ckpt-dir, --ckpt-freq, --ckpt-async, -prefetch-depth, -on-divergence,
-max-rollbacks, -fault-spec, --hang-factor, --hang-min-s,
--drain-budget-s, -metrics-path, --elastic, --min-devices,
--research-budget-s, --max-regrows, --regrow-probes,
--transient-reset-steps, --decompose, --block-budget-s,
--boundary-refine-iters, -obs-dir, -run-id, -op-time-every) go through
``RnnConfig`` to ``FFModel.fit``; the model's constructor is the elastic
rebuild factory, and a drained run logs ``drained at iteration N``.
The verification switches ``--params-ones``, ``--dry-compile`` and
``--print-intermediates`` and the executor's ``-regrid-planner``,
``-placed-overlap`` and ``-pallas`` (``on`` only; the other values are
refused with the reason) are parsed as ``apps.lm`` parses them.
Unknown flags are ignored, like the reference parser; flags of features
the port does not have yet raise ``NotImplementedError``.  A
``--strategy`` file is checked first, as in the JAX app
(``flexflow_tpu/apps/nmt.py:146-148``, ``apps.cnn.check_strategy``): the
run exits with status 2 on an error finding, ``--allow-degraded``
demoting the degradations to warnings.

The strategy is the reference's default (``nmt.rnn_model.
default_global_config``: embeds pinned to devices 0 and 1, the rest data
parallel) unless ``--strategy`` names a file or ``--pipeline-stages S``
asks for ``pipeline_stage_strategy`` (LSTM layer l on device block
l % S).  The world is ``torchrun``'s (``WORLD_SIZE``; one process
without it), each op running on the ranks its device list names; as in
the JAX driver there is no ``-ll:gpu``.  ``-b`` is the global batch and
every rank keeps its rows.  Rank 0 alone logs and returns the result.

The data are seeded random (src, dst) token pairs
(``nmt.rnn_model.synthetic_token_batches``).  Prints the reference's
``time = %.4fs, tp = %.2f images/s`` line, then ``sentences/s = ...``.
"""

from __future__ import annotations

import sys

import torch

from flexflow_tpu_torch.apps.cnn import _flag_value, _write_result, \
    check_strategy, machine_for
from flexflow_tpu_torch.config import (OBS_FLAGS, RUNTIME_FLAGS,
                                       SWITCH_FLAGS, UNPORTED_FLAGS,
                                       flag_stream, parse_switch,
                                       unported)
from flexflow_tpu_torch.nmt.rnn_model import (RnnConfig, RnnModel,
                                              pipeline_stage_strategy,
                                              synthetic_token_batches)

_INT_FIELDS = {
    "-b": "batch_size", "-l": "num_layers", "-s": "seq_length",
    "-h": "hidden_size", "-e": "embed_size", "--vocab": "vocab_size",
    "-i": "num_iterations", "--iters": "num_iterations",
    "--iterations": "num_iterations", "--chunk": "lstm_per_node_length",
    "--seed": "seed",
}
_STR_FIELDS = {"--dtype": "compute_dtype", "-param-dtype": "param_dtype",
               "--param-dtype": "param_dtype"}
#: ``fit``'s runtime, supervision, elastic and telemetry flags that
#: ``flexflow_tpu/apps/nmt.py:parse_args`` parses into ``RnnConfig``
#: (not --elastic-search-iters or --obs-max-bytes, which it ignores)
NMT_RUNTIME_FLAGS = {
    a: field for a, field in {**RUNTIME_FLAGS, **OBS_FLAGS}.items()
    if a not in ("--elastic-search-iters", "--obs-max-bytes")}
#: flags of the JAX app whose features the port does not have yet (``-s``
#: and ``-e`` are the sequence length and the embed size here, so they
#: are parsed first)
NMT_UNPORTED_FLAGS = UNPORTED_FLAGS


def parse_args(argv):
    """``(RnnConfig, device, warmup, placement)`` from the command line;
    ``placement`` is ``{"strategy": file or "", "stages": S or 0}``."""
    cfg = RnnConfig()
    device, warmup = "cuda", 1
    placement = {"strategy": "", "stages": 0}
    for a, val in flag_stream(argv):
        if a in _INT_FIELDS:
            setattr(cfg, _INT_FIELDS[a], int(val()))
        elif a in _STR_FIELDS:
            setattr(cfg, _STR_FIELDS[a], val())
        elif a == "--lr":
            cfg.learning_rate = float(val())
        elif a == "--device":
            device = val()
        elif a == "--warmup":
            warmup = int(val())
        elif a == "--strategy":
            placement["strategy"] = val()
        elif a == "--pipeline-stages":
            placement["stages"] = int(val())
        elif a == "--allow-degraded":
            cfg.allow_degraded = True
        elif a in NMT_RUNTIME_FLAGS:
            field, parse = NMT_RUNTIME_FLAGS[a]
            setattr(cfg, field, True if a in SWITCH_FLAGS else parse(val()))
        elif parse_switch(cfg, a, val):
            pass
        elif a in NMT_UNPORTED_FLAGS:
            raise unported(a, "flexflow_tpu/apps/nmt.py")
        # unknown flags are ignored, like the reference parser
    return cfg, device, warmup, placement


def main(argv=None, log=print) -> dict:
    """One training run; returns ``fit``'s result without the trees, with
    ``sentences_per_sec`` (on rank 0; None on the other ranks)."""
    from flexflow_tpu_torch.strategy import Strategy

    argv = list(sys.argv[1:] if argv is None else argv)
    result_json, argv = _flag_value(argv, "--result-json", "")
    backend, argv = _flag_value(argv, "--dist-backend", None)
    cfg, device, warmup, placement = parse_args(argv)
    machine = machine_for(device, backend)
    dev = machine.device
    if machine.rank != 0:
        def log(*args, **kwargs):
            pass
    if dev.type == "cuda":
        # float32 runs its products in float32, not TF32
        torch.backends.cuda.matmul.allow_tf32 = False
    strategies, label = None, "default_global_config"
    if placement["strategy"]:
        strategies = Strategy.load(placement["strategy"])
        label = placement["strategy"]
        # the static plan check, on a shadow built under the default
        # strategy (its pinned embeds are placements, not degradations)
        check_strategy(lambda m: RnnModel(cfg, m, None), strategies,
                       machine, cfg.allow_degraded, label)
    elif placement["stages"]:
        strategies = pipeline_stage_strategy(cfg, machine,
                                             placement["stages"])
        label = f"pipeline_stage_strategy({placement['stages']})"
    model = RnnModel(cfg, machine, strategies)
    log(f"NMT: {cfg.num_layers} layers, seq {cfg.seq_length} (chunks of "
        f"{cfg.lstm_per_node_length}), hidden {cfg.hidden_size}, embed "
        f"{cfg.embed_size}, vocab {cfg.vocab_size}, batch {cfg.batch_size}, "
        f"{cfg.compute_dtype} compute, {cfg.param_dtype} params, on {dev}"
        + (f", {machine.num_devices} ranks, strategy {label}"
           if machine.distributed else ""))
    data = synthetic_token_batches(cfg.batch_size, cfg.seq_length,
                                   cfg.vocab_size, seed=cfg.seed,
                                   machine=machine)
    # the elastic rebuild factory: the RNN on a resized machine under the
    # re-searched strategy (the FFConfig it is handed carries it)
    out = model.fit(data, warmup=warmup, log=log,
                    rebuild=lambda ff_cfg, m: RnnModel(cfg, m,
                                                       ff_cfg.strategies))
    if out.get("drained"):
        log(f"drained at iteration {out.get('completed_steps')}; "
            f"exiting 0 (resume from --ckpt-dir to continue)")
    if out["sentences_per_sec"]:
        log(f"sentences/s = {out['sentences_per_sec']:.2f}")
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
