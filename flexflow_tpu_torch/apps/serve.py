"""Serving entry point — continuous-batching decode of the transformer LM
on one GPU (PyTorch port of ``flexflow_tpu/apps/serve.py``, single pool).

    python -m flexflow_tpu_torch.apps.serve gpt --requests 16 \\
        --max-new-tokens 4 [--tiny] [--device cuda|cpu] [-obs-dir obs/]

``gpt`` (also ``transformer`` / ``bert``, the same causal LM as in the JAX
app) is the GPT-2-small-width model: 12 layers, d_model 768, 12 heads,
d_ff 3072, vocab 32768, seq 512, batch 8; ``--tiny`` is the 2-layer
CPU-sized one.  The device defaults to ``cuda`` and the run raises when
CUDA is absent unless ``--device cpu`` is given.  float32 matrix products
run in full float32 on the GPU: TF32 is switched off.

stdout carries exactly one JSON line with the keys of the JAX app's
``_result_line`` (run_id, qps, p50_s, p99_s, resizes, requests,
completed, unserved, dropped, devices, drained); narration goes to
stderr.  The JAX app's autoscaling, disaggregated pools, smokes,
SIGTERM drain, metrics export and plan checker come with later slices.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import torch

LM_MODELS = ("gpt", "transformer", "bert")


def _err(*a, **kw):
    print(*a, file=sys.stderr, **kw)
    sys.stderr.flush()


def parse_args(argv) -> dict:
    ap = argparse.ArgumentParser(prog="flexflow_tpu_torch.apps.serve")
    ap.add_argument("model", nargs="?", default="gpt")
    ap.add_argument("-b", "--batch-size", type=int, default=8)
    ap.add_argument("--max-batch", type=int, default=0)
    ap.add_argument("-n", "--requests", type=int, default=16)
    ap.add_argument("--rate-qps", type=float, default=100.0)
    ap.add_argument("--max-new-tokens", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=4)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("-s", "--strategy", default="")
    ap.add_argument("--dtype", default="float32",
                    choices=("float32", "bfloat16"))
    ap.add_argument("-obs-dir", "--obs-dir", dest="obs_dir", default="")
    ap.add_argument("-run-id", "--run-id", dest="run_id", default="")
    ap.add_argument("--step-time-s", type=float, default=0.0)
    ap.add_argument("--tiny", action="store_true")
    ap.add_argument("--device", default="cuda")
    return vars(ap.parse_args(list(argv)))


def build_lm(*, batch, seed=0, dtype="float32", strategies=None,
             tiny=False, device="cuda"):
    """The serving TransformerLM at the JAX app's widths (``tiny``:
    the 2-layer smoke geometry)."""
    from flexflow_tpu_torch.models.transformer import (TransformerConfig,
                                                       TransformerLM)

    kw = dict(batch_size=batch, causal=True, seed=seed, compute_dtype=dtype)
    if tiny:
        kw.update(seq_length=16, num_layers=2, d_model=32, num_heads=4,
                  d_ff=128, vocab_size=64)
    return TransformerLM(TransformerConfig(**kw), strategies=strategies,
                         device=device)


def build_engine(opts, log=_err):
    """(engine, requests, olog) for one serving run: the model at its full
    widths on ``opts["device"]``, random weights from ``opts["seed"]``, and
    the seeded synthetic load."""
    from flexflow_tpu_torch import obs
    from flexflow_tpu_torch.machine import resolve_device
    from flexflow_tpu_torch.serve.engine import ServeEngine
    from flexflow_tpu_torch.serve.loadgen import synthetic_requests
    from flexflow_tpu_torch.strategy import Strategy

    if opts["model"] not in LM_MODELS:
        raise SystemExit(f"model {opts['model']!r} is not ported yet "
                         f"(serving supports {', '.join(LM_MODELS)})")
    device = resolve_device(opts["device"])
    if device.type == "cuda":
        # a float32 reference runs its products in float32, not TF32
        torch.backends.cuda.matmul.allow_tf32 = False
    strategies = Strategy.load(opts["strategy"]) if opts["strategy"] \
        else None
    model = build_lm(batch=opts["max_batch"] or opts["batch_size"],
                     seed=opts["seed"], dtype=opts["dtype"],
                     strategies=strategies, tiny=opts["tiny"],
                     device=device)
    if opts["obs_dir"]:
        run_id = opts["run_id"] or obs.new_run_id()
        olog = obs.RunLog(
            os.path.join(opts["obs_dir"], f"{run_id}.jsonl"),
            run_id=run_id, surface="serve",
            meta={"app": "serve", "model": opts["model"],
                  "requests": opts["requests"], "seed": opts["seed"],
                  "device": str(device)})
    else:
        olog = obs.NULL
    engine = ServeEngine(model, olog=olog, log=log,
                         step_time_s=opts["step_time_s"] or None)
    requests = synthetic_requests(
        opts["requests"], seed=opts["seed"], rate_qps=opts["rate_qps"],
        vocab_size=model.t.vocab_size, prompt_len=opts["prompt_len"],
        max_new_tokens=opts["max_new_tokens"])
    return engine, requests, olog


def serve_run(opts, log=_err) -> dict:
    """One serving run; returns the engine summary with the run's obs sink
    under ``"_olog"`` (the caller prints the line)."""
    engine, requests, olog = build_engine(opts, log)
    try:
        summary = engine.run(requests)
    finally:
        olog.close()
    summary["_olog"] = olog
    return summary


def _result_line(summary, olog) -> str:
    """The one stdout JSON line, with the JAX app's keys."""
    rec = {
        "run_id": olog.run_id if olog.enabled else None,
        "qps": summary["qps"],
        "p50_s": summary["p50_s"],
        "p99_s": summary["p99_s"],
        "resizes": summary["resizes"],
        "requests": summary["requests"],
        "completed": summary["completed"],
        "unserved": summary["unserved"],
        "dropped": summary["dropped"],
        "devices": summary["devices"],
        "drained": summary["drained"],
    }
    return json.dumps(rec)


def main(argv=None, log=_err) -> int:
    opts = parse_args(sys.argv[1:] if argv is None else argv)
    summary = serve_run(opts, log)
    print(_result_line(summary, summary.pop("_olog")))
    return 0


if __name__ == "__main__":
    sys.exit(main())
