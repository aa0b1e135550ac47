"""Transformer LM training entry point (PyTorch port of
``flexflow_tpu/apps/lm.py``).

    python -m flexflow_tpu_torch.apps.lm --causal -b 16 -s 512 -l 12 \\
        --d-model 768 --heads 12 --d-ff 3072 --vocab 32768
    python -m flexflow_tpu_torch.apps.lm --causal -b 16 -s 512 -l 12 \\
        --d-model 768 --heads 12 --d-ff 3072 --vocab 32768 --experts 8 \\
        --ckpt-dir D --ckpt-freq 5 --ckpt-async --on-divergence rollback \\
        --hang-factor 20 --hang-min-s 60 --drain-budget-s 60 \\
        -metrics-path M/metrics.prom -obs-dir O
    python -m flexflow_tpu_torch.apps.lm --causal -b 2 -s 16 -l 1 \\
        --d-model 16 --heads 2 --d-ff 32 --vocab 64 -i 3 --device cpu
    torchrun --nproc-per-node 8 -m flexflow_tpu_torch.apps.lm --causal \\
        -b 16 -s 512 -l 12 --strategy examples/strategies/transformer_8dev.json

Flags are the JAX app's names for the ported fields (-b, -s/--seq,
-l/--layers, --d-model, --heads, --d-ff, --vocab, --causal, --experts,
--moe-every, --moe-top-k, -i/--iters/--iterations, --lr, --dtype,
--param-dtype, --seed, --strategy <file>, --pipeline-stages,
--microbatches, --pipeline-tp, --allow-degraded), ``fit``'s runtime
(--ckpt-dir, --ckpt-freq, --prefetch-depth, --on-divergence,
--max-rollbacks, --fault-spec), its supervision (--ckpt-async,
--hang-factor, --hang-min-s, --drain-budget-s, -metrics-path) and its
telemetry (-obs-dir, -run-id, --obs-max-bytes, -op-time-every:
``FFModel.fit``), plus ``--device``
(default ``cuda``: the run raises when CUDA is absent unless ``--device
cpu`` is given), ``--warmup`` (untimed steps before the timed window,
default 1 as in ``fit``),
``--result-json PATH`` and ``--dist-backend NAME`` (as ``apps.cnn``'s).
Unknown flags are ignored, like the reference parser; flags of features
the port does not have yet (elastic training, profiling, ...)
raise ``NotImplementedError`` (``config.UNPORTED_FLAGS``).  A run that
SIGTERM, SIGINT or an injected ``preempt`` drains logs ``drained at
iteration N`` and exits 0.  A
``--strategy`` file is checked first, as in the JAX app
(``flexflow_tpu/apps/lm.py:225-235``, ``apps.cnn.check_strategy``): the
run exits with status 2 on an error finding, ``--allow-degraded``
demoting the degradations to warnings.

With ``--strategy`` every op runs on the grid and device list the file
names, over the world ``torchrun`` makes (``WORLD_SIZE``; one process
without it); as in the JAX driver there is no ``-ll:gpu``.  ``-b`` is
the global batch and every rank keeps its rows.  Rank 0 alone logs and
returns the result.

``--pipeline-stages S`` (> 1) trains the GPipe pipelined form of the
dense stack instead (``parallel/pipeline.py``'s ``PipelinedLM``): S
stages x (world / (S * tp)) data-parallel rows x ``--pipeline-tp``
Megatron columns, ``--microbatches`` M (default S) microbatches a step.
A strategy file's ``__pipeline__`` block with more than one stage takes
the same path when neither ``--pipeline-stages`` nor ``--microbatches``
is given, its tp the block's or else the head split of the file's
attention entries (:func:`_per_op_tp`); as in the JAX driver
(``flexflow_tpu/apps/lm.py:236-283``) the pipelined path refuses
``--strategy`` (a file that does not drive it) and ``--experts`` with a
``SystemExit``.  Every rank draws the global batch and takes its rows.

    torchrun --nproc-per-node 2 -m flexflow_tpu_torch.apps.lm --causal \\
        -b 16 -s 512 -l 12 --pipeline-stages 2 --microbatches 4
    torchrun --nproc-per-node 2 -m flexflow_tpu_torch.apps.lm --causal \\
        -b 16 -s 512 -l 12 --strategy examples/strategies/transformer_2x4.json

The data are seeded random tokens (``data.synthetic_token_stream``) and
the labels the tokens themselves: a causal model shifts them into
next-token targets (``TransformerLM.loss_fn``).  They are made on the
device, or on the host when ``--prefetch-depth`` is above 0, so that the
prefetcher copies them.  Training is plain SGD through the
flash-attention and fused LM-head kernels (the pipelined path: the
flash kernels in its stages, the plain head of JAX's pipelined LM).
Prints the reference's ``time = %.4fs, tp = %.2f images/s`` line, then
``tokens/s = ...``.
"""

from __future__ import annotations

import sys

import torch

from flexflow_tpu_torch.apps.cnn import _flag_value, _write_result, \
    check_strategy, machine_for
from flexflow_tpu_torch.config import (OBS_FLAGS, RUNTIME_FLAGS,
                                       SWITCH_FLAGS, UNPORTED_FLAGS,
                                       flag_stream, unported)
from flexflow_tpu_torch.models.transformer import (TransformerConfig,
                                                   TransformerLM)

_INT_FIELDS = {
    "-b": "batch_size", "-s": "seq_length", "--seq": "seq_length",
    "-l": "num_layers", "--layers": "num_layers", "--d-model": "d_model",
    "--heads": "num_heads", "--d-ff": "d_ff", "--vocab": "vocab_size",
    "-i": "num_iterations", "--iters": "num_iterations",
    "--iterations": "num_iterations", "--seed": "seed",
    "--experts": "num_experts", "--moe-every": "moe_every",
    "--moe-top-k": "moe_top_k", "--pipeline-stages": "pipeline_stages",
    "--microbatches": "microbatches", "--pipeline-tp": "pipeline_tp",
}
_STR_FIELDS = {"--dtype": "compute_dtype", "-param-dtype": "param_dtype",
               "--param-dtype": "param_dtype"}


def parse_args(argv):
    """``(TransformerConfig, device, warmup)`` from the command line."""
    cfg = TransformerConfig()
    device, warmup = "cuda", 1
    for a, val in flag_stream(argv):
        if a in _INT_FIELDS:
            setattr(cfg, _INT_FIELDS[a], int(val()))
        elif a in _STR_FIELDS:
            setattr(cfg, _STR_FIELDS[a], val())
        elif a == "--causal":
            cfg.causal = True
        elif a == "--lr":
            cfg.learning_rate = float(val())
        elif a == "--device":
            device = val()
        elif a == "--warmup":
            warmup = int(val())
        elif a == "--strategy":
            cfg.strategy_file = val()
        elif a == "--allow-degraded":
            cfg.allow_degraded = True
        elif a in RUNTIME_FLAGS or a in OBS_FLAGS:
            field, parse = {**RUNTIME_FLAGS, **OBS_FLAGS}[a]
            setattr(cfg, field, True if a in SWITCH_FLAGS else parse(val()))
        elif a in UNPORTED_FLAGS:
            raise unported(a, "flexflow_tpu/apps/lm.py")
        # unknown flags are ignored, like the reference parser
    return cfg, device, warmup


def synthetic_lm_batches(batch_size: int, seq_length: int, vocab_size: int,
                         seed: int = 0, device="cuda", machine=None):
    """Random token batches on ``device``; labels = tokens
    (``TransformerLM`` shifts them for causal models); with ``machine``,
    this rank's rows on its device."""
    from flexflow_tpu_torch.data import synthetic_token_stream

    for (toks,) in synthetic_token_stream(batch_size, seq_length, vocab_size,
                                          seed, streams=1, device=device,
                                          machine=machine):
        yield toks, toks


def _per_op_tp(strategies, cfg) -> int:
    """The stage-internal tp a strategy file's per-op entries imply for a
    pipeline block without one (``flexflow_tpu/apps/lm.py:152``): the
    head split of the rank-3 entries of ops named ``*attn*`` (MoE grids
    are rank 3 too), when every such entry agrees and it divides the
    heads and d_ff; else 1."""
    splits = {pc.dims[1] for name, pc in strategies.items()
              if "attn" in name and len(pc.dims) == 3}
    if len(splits) != 1:
        return 1
    tp = splits.pop()
    if tp <= 1 or cfg.num_heads % tp or cfg.d_ff % tp:
        return 1
    return tp


def _pipeline_from_file(cfg, strategies, log) -> None:
    """A ``__pipeline__`` block of more than one stage takes the GPipe
    path when no pipeline flag was given (the flags disable the block
    wholesale), the file's per-op entries then only voting on tp; a block
    of one stage is ignored, the per-op entries kept
    (``flexflow_tpu/apps/lm.py:236-269``)."""
    pp = strategies.pipeline
    if cfg.pipeline_stages or cfg.microbatches or not pp:
        return
    if pp["stages"] <= 1:
        log(f"warning: __pipeline__ block in {cfg.strategy_file} has "
            f"stages={pp['stages']} <= 1 — ignored; per-op entries kept")
        return
    cfg.pipeline_stages = pp["stages"]
    cfg.microbatches = pp["microbatches"]
    tp = int(pp.get("tp", 1) or 1)
    if tp == 1:
        tp = _per_op_tp(strategies, cfg)
    cfg.pipeline_tp = tp
    log(f"pipeline block from {cfg.strategy_file}: {pp['stages']} stages x "
        f"{pp['microbatches']} microbatches"
        + (f" x tp={tp} (stage-internal TP from the strategy file)"
           if tp > 1 else "") + " (file-driven GPipe)")
    cfg.strategy_file = ""


def _main_pipelined(cfg, machine, warmup: int, log) -> dict:
    """The GPipe path (``flexflow_tpu/apps/lm.py:175``): ``PipelinedLM``
    over the world, every rank drawing the global batch; ``warmup``
    untimed steps, then the timed ones.  Returns ``fit``'s keys (the
    params this rank holds, ``state`` empty) and where the rank sits."""
    import time

    from flexflow_tpu_torch.parallel.pipeline import PipelinedLM

    dev = machine.device
    model = PipelinedLM(
        machine, cfg.pipeline_stages,
        cfg.microbatches or cfg.pipeline_stages,
        num_layers=cfg.num_layers, d_model=cfg.d_model,
        num_heads=cfg.num_heads, d_ff=cfg.d_ff, vocab_size=cfg.vocab_size,
        seq_length=cfg.seq_length, batch_size=cfg.batch_size,
        causal=cfg.causal, learning_rate=cfg.learning_rate,
        compute_dtype=cfg.compute_dtype, tp=cfg.pipeline_tp or 1)
    log(f"LM pipeline: {cfg.num_layers} layers over {model.S} stages x "
        f"{model.dp} dp x {model.tp} tp, {model.M} microbatches, batch "
        f"{cfg.batch_size}, seq {cfg.seq_length}, {cfg.compute_dtype} "
        f"compute, on {dev}")
    params = model.init(cfg.seed)
    step = model.make_train_step()
    data = synthetic_lm_batches(cfg.batch_size, cfg.seq_length,
                                cfg.vocab_size, seed=cfg.seed, device=dev)
    warmup = min(warmup, max(cfg.num_iterations - 1, 0))
    losses = []
    start = time.perf_counter()
    for it in range(cfg.num_iterations):
        if it == warmup:
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            start = time.perf_counter()
        toks, labels = next(data)
        params, loss = step(params, toks, labels)
        losses.append(loss)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    elapsed = time.perf_counter() - start
    n_timed = cfg.num_iterations - warmup
    tput = n_timed * cfg.batch_size / elapsed \
        if n_timed > 0 and elapsed > 0 else 0.0
    log(f"time = {elapsed:.4f}s, tp = {tput:.2f} images/s")
    return {"params": params, "state": {}, "opt_state": None,
            "loss": [float(v) for v in losses], "elapsed_s": elapsed,
            "images_per_sec": tput, "completed_steps": cfg.num_iterations,
            "pipeline": {"coords": model.coords(),
                         "blocks": model.param_boxes()["blocks"]}}


def main(argv=None, log=print) -> dict:
    """One training run; returns ``fit``'s result without the trees, plus
    ``tokens_per_sec`` (on rank 0; None on the other ranks)."""
    from flexflow_tpu_torch.strategy import Strategy

    argv = list(sys.argv[1:] if argv is None else argv)
    result_json, argv = _flag_value(argv, "--result-json", "")
    backend, argv = _flag_value(argv, "--dist-backend", None)
    cfg, device, warmup = parse_args(argv)
    strategies = Strategy.load(cfg.strategy_file) if cfg.strategy_file \
        else None
    machine = machine_for(device, backend)
    dev = machine.device
    if machine.rank != 0:
        def log(*args, **kwargs):
            pass
    if dev.type == "cuda":
        # float32 runs its products in float32, not TF32
        torch.backends.cuda.matmul.allow_tf32 = False
    if strategies is not None:
        # the static plan check, on a shadow LM built without the file
        check_strategy(lambda m: TransformerLM(cfg, m, None), strategies,
                       machine, cfg.allow_degraded, cfg.strategy_file)
        _pipeline_from_file(cfg, strategies, log)
    if cfg.pipeline_stages > 1:
        unsupported = [flag for flag, on in (
            ("--strategy", bool(cfg.strategy_file)),
            ("--experts", cfg.num_experts > 0)) if on]
        if unsupported:
            raise SystemExit(
                f"--pipeline-stages does not support: "
                f"{', '.join(unsupported)} (the pipelined path trains a "
                f"homogeneous dense block stack outside the op DAG)")
        out = _main_pipelined(cfg, machine, warmup, log)
    else:
        out = _main_dag(cfg, strategies, machine, warmup, log)
    out["tokens_per_sec"] = out["images_per_sec"] * cfg.seq_length
    if out["tokens_per_sec"]:
        log(f"tokens/s = {out['tokens_per_sec']:.0f}")
    if result_json:
        _write_result(result_json, out, machine)
    for key in ("params", "state", "opt_state"):
        out.pop(key)
    return out if machine.rank == 0 else None


def _main_dag(cfg, strategies, machine, warmup: int, log) -> dict:
    """The op-DAG path: ``TransformerLM.fit`` under the strategy."""
    dev = machine.device
    model = TransformerLM(cfg, machine, strategies)
    moe = (f", {cfg.num_experts} experts/{cfg.moe_every} blocks"
           if cfg.num_experts else "")
    log(f"LM: {'causal' if cfg.causal else 'encoder'}, {cfg.num_layers} "
        f"layers, d_model {cfg.d_model}, {cfg.num_heads} heads, d_ff "
        f"{cfg.d_ff}, seq {cfg.seq_length}, vocab {cfg.vocab_size}, batch "
        f"{cfg.batch_size}{moe}, {cfg.compute_dtype} compute, "
        f"{cfg.param_dtype} params, on {dev}"
        + (f", {machine.num_devices} ranks, strategy "
           f"{cfg.strategy_file or 'data parallel'}"
           if machine.distributed else ""))
    if machine.distributed:
        data = synthetic_lm_batches(cfg.batch_size, cfg.seq_length,
                                    cfg.vocab_size, seed=cfg.seed,
                                    machine=machine)
    else:
        data = synthetic_lm_batches(
            cfg.batch_size, cfg.seq_length, cfg.vocab_size, seed=cfg.seed,
            device="cpu" if cfg.prefetch_depth > 0 else dev)
    out = model.fit(data, warmup=warmup, log=log)
    if out.get("drained"):
        # a graceful drain stopped the run with a verified checkpoint:
        # exit 0 is the scheduler's contract (a non-zero exit would be
        # retried as a failure)
        log(f"drained at iteration {out.get('completed_steps')}; "
            f"exiting 0 (resume from --ckpt-dir to continue)")
    return out


if __name__ == "__main__":
    from flexflow_tpu_torch import distributed as _dist

    main()
    _dist.shutdown()
    sys.exit(0)
