"""Serving entry point on one GPU (PyTorch port of
``flexflow_tpu/apps/serve.py``, single pool): continuous-batching decode
of the transformer LM, and the batched forward-only service of the CNNs
and the NMT model.

    python -m flexflow_tpu_torch.apps.serve gpt --requests 16 \\
        --max-new-tokens 4 [--tiny] [--device cuda|cpu] [-obs-dir obs/]
    python -m flexflow_tpu_torch.apps.serve densenet121 --requests 32 \\
        --max-batch 8 [-metrics-path m.prom] [--device cuda|cpu]
    python -m flexflow_tpu_torch.apps.serve nmt --requests 16

``gpt`` (also ``transformer`` / ``bert``, the same causal LM as in the JAX
app) is the GPT-2-small-width model: 12 layers, d_model 768, 12 heads,
d_ff 3072, vocab 32768, seq 512, batch 8; ``--tiny`` is the 2-layer
CPU-sized one.  The CNNs (``apps.cnn``'s names: alexnet, vgg16,
resnet101, densenet121, inception_v3, ...) take 224x224 images (299x299
for Inception) and ``nmt`` is the JAX driver's default NMT model; each
request carries one seeded random sample of the model's first input
(:func:`_forward_payloads`), the service pads them into ``--max-batch``
(default ``-b``, 8) rows and replies with each request's row of the loss
op's output (``ServeEngine.run_forward``).  The device defaults to
``cuda`` and the run raises when CUDA is absent unless ``--device cpu``
is given.  float32 matrix products and convolutions run in full float32
on the GPU: TF32 is switched off.

Drain contract: SIGTERM or SIGINT stops admission, the in-flight work
finishes, the requests not yet admitted are reported ``unserved`` (never
dropped), and the process exits 0.

stdout carries exactly one JSON line with the keys of the JAX app's
``_result_line`` (run_id, qps, p50_s, p99_s, resizes, requests,
completed, unserved, dropped, devices, drained); narration goes to
stderr.  ``-obs-dir`` streams the serve_request, serve_batch and
serve_summary records; ``-metrics-path`` exports the ff_qps,
ff_queue_depth, ff_latency_p50_s, ff_latency_p99_s and ff_requests_total
gauges (``obs/metrics.py``).  The JAX app's autoscaling, disaggregated
pools, smokes and plan checker come with later slices.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np
import torch

LM_MODELS = ("gpt", "transformer", "bert")
#: the forward-only service's models: apps.cnn's names and the NMT model
FORWARD_MODELS = ("alexnet", "vgg16", "vgg", "inception", "inception_v3",
                  "resnet101", "resnet", "densenet", "densenet121", "nmt")


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
    ap.add_argument("-metrics-path", "--metrics-path", dest="metrics_path",
                    default="")
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


def _build_forward(name, batch, dtype="float32", device="cuda"):
    """A CNN or the NMT model for the forward-only service
    (``flexflow_tpu/apps/serve.py:151-172``): the CNNs at 224x224 (299 for
    Inception), the NMT at the JAX driver's defaults."""
    from flexflow_tpu_torch.machine import MachineModel

    machine = MachineModel(device)
    if name == "nmt":
        from flexflow_tpu_torch.nmt.rnn_model import RnnConfig, RnnModel

        return RnnModel(RnnConfig(batch_size=batch, compute_dtype=dtype),
                        machine)
    from flexflow_tpu_torch.apps.cnn import build
    from flexflow_tpu_torch.config import FFConfig

    size = 299 if name.startswith("inception") else 224
    cfg = FFConfig(batch_size=batch, input_height=size, input_width=size,
                   compute_dtype=dtype)
    return build(name, cfg, machine)


def _forward_payloads(model, requests, seed):
    """Give each request one sample of the model's first input in place of
    its token prompt (``flexflow_tpu/apps/serve.py:175-190``): uniform
    images in [-1, 1) for a CNN, token rows in [2, 64) for the NMT, from
    one generator seeded with ``seed``."""
    in0 = model._inputs[0]
    shape = tuple(int(d) for d in in0.shape[1:])
    rng = np.random.RandomState(seed)
    for r in requests:
        if np.issubdtype(np.dtype(in0.dtype), np.integer):
            r.tokens = rng.randint(2, 64, size=shape).astype(in0.dtype)
        else:
            r.tokens = rng.uniform(-1.0, 1.0, size=shape).astype(in0.dtype)
    return requests


def build_engine(opts, log=_err):
    """(engine, requests, olog, forward) for one serving run: the model at
    its full widths on ``opts["device"]``, random weights from
    ``opts["seed"]``, the seeded synthetic load, and whether the model
    takes the forward-only service."""
    from flexflow_tpu_torch import obs
    from flexflow_tpu_torch.machine import resolve_device
    from flexflow_tpu_torch.obs.metrics import MetricsExporter
    from flexflow_tpu_torch.serve.engine import ServeEngine
    from flexflow_tpu_torch.serve.loadgen import synthetic_requests
    from flexflow_tpu_torch.strategy import Strategy

    name = opts["model"]
    if name not in LM_MODELS + FORWARD_MODELS:
        raise SystemExit(f"model {name!r} is not ported yet (serving "
                         f"supports {', '.join(LM_MODELS + FORWARD_MODELS)})")
    forward = name in FORWARD_MODELS
    device = resolve_device(opts["device"])
    if device.type == "cuda":
        # a float32 reference runs its products in float32, not TF32
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    batch = opts["max_batch"] or opts["batch_size"]
    if forward:
        if opts["strategy"]:
            raise SystemExit("-s/--strategy: the forward-only service runs "
                             "on one device in the port")
        model = _build_forward(name, batch, opts["dtype"], device)
    else:
        strategies = Strategy.load(opts["strategy"]) if opts["strategy"] \
            else None
        model = build_lm(batch=batch, seed=opts["seed"],
                         dtype=opts["dtype"], strategies=strategies,
                         tiny=opts["tiny"], device=device)
    meta = {"app": "serve", "model": name, "requests": opts["requests"],
            "seed": opts["seed"]}
    if opts["obs_dir"]:
        run_id = opts["run_id"] or obs.new_run_id()
        olog = obs.RunLog(
            os.path.join(opts["obs_dir"], f"{run_id}.jsonl"),
            run_id=run_id, surface="serve",
            meta=dict(meta, device=str(device)))
    else:
        olog = obs.NULL
    metrics = MetricsExporter(opts["metrics_path"], meta=meta) \
        if opts["metrics_path"] else None
    engine = ServeEngine(model, olog=olog, metrics=metrics, log=log,
                         step_time_s=opts["step_time_s"] or None)
    vocab = getattr(getattr(model, "t", None), "vocab_size", 64)
    requests = synthetic_requests(
        opts["requests"], seed=opts["seed"], rate_qps=opts["rate_qps"],
        vocab_size=vocab, prompt_len=opts["prompt_len"],
        max_new_tokens=opts["max_new_tokens"])
    if forward:
        _forward_payloads(model, requests, opts["seed"])
    return engine, requests, olog, forward


def serve_run(opts, log=_err) -> dict:
    """One serving run under the drain handler (SIGTERM/SIGINT stop
    admission); returns the engine summary with the run's obs sink under
    ``"_olog"`` (the caller prints the line)."""
    from flexflow_tpu_torch.utils.elastic import drain_scope

    engine, requests, olog, forward = build_engine(opts, log)
    try:
        with drain_scope(log=log) as drain:
            summary = engine.run_forward(requests, drain=drain) if forward \
                else engine.run(requests, drain=drain)
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
