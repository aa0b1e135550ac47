"""NMT seq2seq training entry point (PyTorch port of
``flexflow_tpu/apps/nmt.py``).

    python -m flexflow_tpu_torch.apps.nmt -b 64 -l 2 -s 20 -h 2048 -e 2048
    python -m flexflow_tpu_torch.apps.nmt -b 4 -l 2 -s 6 -h 16 -e 12 \\
        --vocab 64 --chunk 3 -i 3 --device cpu

Flags are the reference's (-b batch, -l layers, -s sequence length, -h
hidden size, -e embed size) and the JAX app's extras for the ported
fields (--vocab, -i/--iters/--iterations, --chunk: LSTM steps per chunk
op, --lr, --dtype, --param-dtype, --seed), plus ``--device`` (default
``cuda``: the run raises when CUDA is absent unless ``--device cpu`` is
given) and ``--warmup`` (untimed steps before the timed window, default 1
as in ``fit``).  Unknown flags are ignored, like the reference parser;
flags of features the port does not have yet (strategies, the pipelined
placement, telemetry, checkpoints, elastic training, the kernel policy,
...) raise ``NotImplementedError``.

The data are seeded random (src, dst) token pairs
(``nmt.rnn_model.synthetic_token_batches``).  Prints the reference's
``time = %.4fs, tp = %.2f images/s`` line, then ``sentences/s = ...``.
"""

from __future__ import annotations

import sys

import torch

from flexflow_tpu_torch.config import (RUNTIME_FLAGS, UNPORTED_FLAGS,
                                       flag_stream)
from flexflow_tpu_torch.nmt.rnn_model import (RnnConfig, RnnModel,
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
#: flags of ``flexflow_tpu/apps/nmt.py:parse_args`` whose features the
#: port does not have yet (``-s`` and ``-e`` are the sequence length and
#: the embed size here, so they are parsed first); ``fit``'s runtime
#: flags are not carried through ``RnnConfig`` yet
NMT_UNPORTED_FLAGS = UNPORTED_FLAGS | set(RUNTIME_FLAGS) \
    | {"--pipeline-stages", "--strategy"}


def parse_args(argv):
    """``(RnnConfig, device, warmup)`` from the command line."""
    cfg = RnnConfig()
    device, warmup = "cuda", 1
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
        elif a in NMT_UNPORTED_FLAGS:
            raise NotImplementedError(
                f"{a}: not ported to flexflow_tpu_torch yet (the JAX "
                f"package's flexflow_tpu/apps/nmt.py has it)")
        # unknown flags are ignored, like the reference parser
    return cfg, device, warmup


def main(argv=None, log=print) -> dict:
    """One training run; returns ``fit``'s result without the trees, with
    ``sentences_per_sec``."""
    from flexflow_tpu_torch.machine import resolve_device

    cfg, device, warmup = parse_args(sys.argv[1:] if argv is None else argv)
    dev = resolve_device(device)
    if dev.type == "cuda":
        # float32 runs its products in float32, not TF32
        torch.backends.cuda.matmul.allow_tf32 = False
    model = RnnModel(cfg, device=dev)
    log(f"NMT: {cfg.num_layers} layers, seq {cfg.seq_length} (chunks of "
        f"{cfg.lstm_per_node_length}), hidden {cfg.hidden_size}, embed "
        f"{cfg.embed_size}, vocab {cfg.vocab_size}, batch {cfg.batch_size}, "
        f"{cfg.compute_dtype} compute, {cfg.param_dtype} params, on {dev}")
    data = synthetic_token_batches(cfg.batch_size, cfg.seq_length,
                                   cfg.vocab_size, seed=cfg.seed, device=dev)
    out = model.fit(data, warmup=warmup, log=log)
    if out["sentences_per_sec"]:
        log(f"sentences/s = {out['sentences_per_sec']:.2f}")
    for key in ("params", "state", "opt_state"):
        out.pop(key)
    return out


if __name__ == "__main__":
    main()
    sys.exit(0)
