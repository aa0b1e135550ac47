"""Transformer LM training entry point (PyTorch port of
``flexflow_tpu/apps/lm.py``).

    python -m flexflow_tpu_torch.apps.lm --causal -b 16 -s 512 -l 12 \\
        --d-model 768 --heads 12 --d-ff 3072 --vocab 32768
    python -m flexflow_tpu_torch.apps.lm --causal -b 16 -s 512 -l 12 \\
        --d-model 768 --heads 12 --d-ff 3072 --vocab 32768 --experts 8 \\
        --ckpt-dir D --ckpt-freq 5 --on-divergence rollback
    python -m flexflow_tpu_torch.apps.lm --causal -b 2 -s 16 -l 1 \\
        --d-model 16 --heads 2 --d-ff 32 --vocab 64 -i 3 --device cpu
    torchrun --nproc-per-node 8 -m flexflow_tpu_torch.apps.lm --causal \\
        -b 16 -s 512 -l 12 --strategy examples/strategies/transformer_8dev.json

Flags are the JAX app's names for the ported fields (-b, -s/--seq,
-l/--layers, --d-model, --heads, --d-ff, --vocab, --causal, --experts,
--moe-every, --moe-top-k, -i/--iters/--iterations, --lr, --dtype,
--param-dtype, --seed, --strategy <file>) and ``fit``'s runtime
(--ckpt-dir, --ckpt-freq, --prefetch-depth, --on-divergence,
--max-rollbacks, --fault-spec), plus ``--device`` (default ``cuda``: the
run raises when CUDA is absent unless ``--device cpu`` is given),
``--warmup`` (untimed steps before the timed window, default 1 as in
``fit``), ``--result-json PATH`` and ``--dist-backend NAME`` (as
``apps.cnn``'s).  Unknown flags are ignored, like the reference parser;
flags of features the port does not have yet (the pipelined path,
elastic training, telemetry, ...) raise ``NotImplementedError``
(``config.UNPORTED_FLAGS``, ``config.LM_UNPORTED_FLAGS``), and so does a
strategy file with a ``__pipeline__`` block, which the JAX driver runs
as its pipeline (``flexflow_tpu/apps/lm.py:237-269``; ROADMAP Queue A
3d).

With ``--strategy`` every op runs on the grid and device list the file
names, over the world ``torchrun`` makes (``WORLD_SIZE``; one process
without it); as in the JAX driver there is no ``-ll:gpu``.  ``-b`` is
the global batch and every rank keeps its rows.  Rank 0 alone logs and
returns the result.

The data are seeded random tokens (``data.synthetic_token_stream``) and
the labels the tokens themselves: a causal model shifts them into
next-token targets (``TransformerLM.loss_fn``).  They are made on the
device, or on the host when ``--prefetch-depth`` is above 0, so that the
prefetcher copies them.  Training is plain SGD through the
flash-attention and fused LM-head kernels.  Prints the reference's
``time = %.4fs, tp = %.2f images/s`` line, then ``tokens/s = ...``.
"""

from __future__ import annotations

import sys

import torch

from flexflow_tpu_torch.apps.cnn import _flag_value, _write_result, \
    machine_for
from flexflow_tpu_torch.config import (LM_UNPORTED_FLAGS, LM_UNPORTED_ITEMS,
                                       RUNTIME_FLAGS, UNPORTED_FLAGS,
                                       flag_stream)
from flexflow_tpu_torch.models.transformer import (TransformerConfig,
                                                   TransformerLM)

_INT_FIELDS = {
    "-b": "batch_size", "-s": "seq_length", "--seq": "seq_length",
    "-l": "num_layers", "--layers": "num_layers", "--d-model": "d_model",
    "--heads": "num_heads", "--d-ff": "d_ff", "--vocab": "vocab_size",
    "-i": "num_iterations", "--iters": "num_iterations",
    "--iterations": "num_iterations", "--seed": "seed",
    "--experts": "num_experts", "--moe-every": "moe_every",
    "--moe-top-k": "moe_top_k",
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
        elif a in RUNTIME_FLAGS:
            field, parse = RUNTIME_FLAGS[a]
            setattr(cfg, field, parse(val()))
        elif a in UNPORTED_FLAGS or a in LM_UNPORTED_FLAGS:
            item = LM_UNPORTED_ITEMS.get(a)
            raise NotImplementedError(
                f"{a}: not ported to flexflow_tpu_torch yet (the JAX "
                f"package's flexflow_tpu/apps/lm.py has it)"
                + (f"; ROADMAP Queue A {item}" if item else ""))
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


def load_strategy(path: str):
    """The strategy file at ``path``; NotImplementedError for one with a
    ``__pipeline__`` block, which the JAX driver turns into its pipeline
    (ROADMAP Queue A 3d)."""
    from flexflow_tpu_torch.strategy import Strategy

    strategies = Strategy.load(path)
    if strategies.pipeline is not None:
        raise NotImplementedError(
            f"{path}: a __pipeline__ block ({strategies.pipeline}) drives "
            f"the JAX driver's pipeline (flexflow_tpu/apps/lm.py:237-269), "
            f"not ported to flexflow_tpu_torch yet; ROADMAP Queue A 3d")
    return strategies


def main(argv=None, log=print) -> dict:
    """One training run; returns ``fit``'s result without the trees, plus
    ``tokens_per_sec`` (on rank 0; None on the other ranks)."""
    argv = list(sys.argv[1:] if argv is None else argv)
    result_json, argv = _flag_value(argv, "--result-json", "")
    backend, argv = _flag_value(argv, "--dist-backend", None)
    cfg, device, warmup = parse_args(argv)
    strategies = load_strategy(cfg.strategy_file) if cfg.strategy_file \
        else None
    machine = machine_for(device, backend)
    dev = machine.device
    if machine.rank != 0:
        def log(*args, **kwargs):
            pass
    if dev.type == "cuda":
        # float32 runs its products in float32, not TF32
        torch.backends.cuda.matmul.allow_tf32 = False
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
    out["tokens_per_sec"] = out["images_per_sec"] * cfg.seq_length
    if out["tokens_per_sec"]:
        log(f"tokens/s = {out['tokens_per_sec']:.0f}")
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
