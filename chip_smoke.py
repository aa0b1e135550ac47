#!/usr/bin/env python3
"""Chip smoke of the PyTorch port: builds its CUDA kernels, holds each one
against its plain PyTorch version on the card, serves the GPT at full
width through the port's serving entry point, and checks that the main
path ran through the kernels.

    python3 chip_smoke.py              # the smoke (one GPU)
    python3 chip_smoke.py --profile    # plus a torch.profiler breakdown of
                                       # one full-width decode step

Phases (any failure exits non-zero; nothing is caught):

1. CUDA present, card name and power limit (nvidia-smi);
2. build every kernel of the path from ``flexflow_tpu_torch/csrc/`` (one
   nvcc per source, all started together) and print the build seconds;
3. kernel phase: flash_attention_fwd against flash_attention_fwd_plain on
   the card at the serving shape (8, 12, 512, 64) causal in float32 and
   bfloat16, a ragged S = 77, a non-causal case and an empty K; then its
   time, the plain version's and ``scaled_dot_product_attention``'s (a
   yardstick the port never calls) at the serving shape;
4. slice phase: ``apps.serve gpt`` at full width (12 x 768, 12 heads,
   d_ff 3072, vocab 32768, seq 512, max_batch 8, float32) serving 16
   requests of 4 new tokens: every request completes, the kernel ran 12
   times per decode step, and the first step's log-probs and all replies
   match the same model run with the plain attention;
5. (``--profile``) where one decode step's device time goes;
6. a ``kernels`` JSON line, then, last, the ``ok`` JSON line.

Times come from CUDA events over repeated launches after a warm-up, with
the inputs warm in L2 as they are after the projections that produce
them.  ``bound_ms`` is the larger of the bytes the call must move (q, k,
v read once, o and lse written once) at 3.35 TB/s and the FLOPs the
unmasked scores need (4 d per score) at the peak for the input type:
67 TFLOP/s float32 outside the tensor cores, 989 TFLOP/s bfloat16 — the
H100 SXM data-sheet rates at 700 W.
"""

from __future__ import annotations

import contextlib
import json
import subprocess
import sys
import time

HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12}
SERVING_SHAPE = (8, 12, 512, 64)        # B, H, S, d of the GPT at seq 512
KERNEL_ATOL = 1e-4   # float32 sums in another order, over up to 512 keys
LOGPROB_ATOL = 1e-4  # that difference through 12 layers and the vocab head


def _log(msg: str) -> None:
    print(msg, flush=True)


def _card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True)
    return out.stdout.strip().splitlines()[0]


def _time_ms(torch, fn, iters: int = 50, warmup: int = 5) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _bound_ms(shape, sk, causal, dtype) -> tuple:
    """(bound_ms, bound_by) of one flash forward call."""
    b, h, sq, d = shape
    esize = 2 if dtype == "bfloat16" else 4
    if causal:
        scores = sum(min(i + 1, sk) for i in range(sq))
    else:
        scores = sq * sk
    flops = 4.0 * d * b * h * scores
    nbytes = (b * h * sq * d + 2 * b * h * sk * d) * esize \
        + b * h * sq * d * 4 + b * h * sq * 4
    t_ops = flops / PEAK_FLOPS[dtype]
    t_bytes = nbytes / HBM_BYTES_PER_S
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


def _max_err(torch, got, ref) -> float:
    """Max |got - ref| where both are finite; raises if the -inf pattern
    (fully masked rows) differs."""
    fin = torch.isfinite(ref)
    if not torch.equal(fin, torch.isfinite(got)):
        raise AssertionError("finite/-inf pattern differs from the plain "
                             "version")
    if not bool(fin.any()):
        return 0.0
    return float((got[fin] - ref[fin]).abs().max())


@contextlib.contextmanager
def _plain_attention():
    """Route the attention op to the plain version for a reference run."""
    from flexflow_tpu_torch.ops import attention
    from flexflow_tpu_torch.ops.kernels.flash_attention import \
        flash_attention_fwd_plain

    kernel = attention.flash_attention_fwd
    attention.flash_attention_fwd = flash_attention_fwd_plain
    try:
        yield
    finally:
        attention.flash_attention_fwd = kernel


def kernel_phase(torch, fa) -> dict:
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)

    def qkv(shape, sk, dtype):
        b, h, sq, d = shape
        q = torch.randn((b, h, sq, d), generator=gen, device="cuda")
        k, v = (torch.randn((b, h, sk, d), generator=gen, device="cuda")
                for _ in range(2))
        return [t.to(getattr(torch, dtype)) for t in (q, k, v)]

    b, h, s, d = SERVING_SHAPE
    cases = [
        ("serving causal float32", SERVING_SHAPE, s, True, "float32"),
        ("serving causal bfloat16", SERVING_SHAPE, s, True, "bfloat16"),
        ("ragged S=77 causal float32", (2, h, 77, d), 77, True, "float32"),
        ("non-causal S=77 float32", (2, h, 77, d), 77, False, "float32"),
        ("non-causal Sq=77 Sk=300 bfloat16", (2, h, 77, d), 300, False,
         "bfloat16"),
    ]
    worst = 0.0
    for label, shape, sk, causal, dtype in cases:
        q, k, v = qkv(shape, sk, dtype)
        o, lse = fa.flash_attention_fwd_cuda(q, k, v, causal)
        torch.cuda.synchronize()
        o_p, lse_p = fa.flash_attention_fwd_plain(q, k, v, causal)
        torch.cuda.synchronize()
        err = max(_max_err(torch, o, o_p), _max_err(torch, lse, lse_p))
        _log(f"kernel check {label}: max_abs_err {err:.3e} "
             f"(tolerance {KERNEL_ATOL:g})")
        if not err <= KERNEL_ATOL:
            raise AssertionError(f"{label}: kernel disagrees with the plain "
                                 f"version by {err} > {KERNEL_ATOL}")
        worst = max(worst, err)

    # empty K: every row fully masked -> o = 0, lse = -inf
    q, k, v = qkv((1, 2, 5, d), 0, "float32")
    o, lse = fa.flash_attention_fwd_cuda(q, k, v, False)
    torch.cuda.synchronize()
    if not (bool((o == 0).all()) and bool(torch.isneginf(lse).all())):
        raise AssertionError("fully masked rows must give o = 0, "
                             "lse = -inf")
    _log("kernel check empty K: o = 0 and lse = -inf on every row")

    timings = {}
    for dtype in ("float32", "bfloat16"):
        q, k, v = qkv(SERVING_SHAPE, s, dtype)
        ms = _time_ms(torch, lambda: fa.flash_attention_fwd_cuda(q, k, v,
                                                                 True))
        plain_ms = _time_ms(torch, lambda: fa.flash_attention_fwd_plain(
            q, k, v, True), iters=20)
        sdpa_ms = _time_ms(torch, lambda: torch.nn.functional
                           .scaled_dot_product_attention(q, k, v,
                                                         is_causal=True))
        bound_ms, bound_by = _bound_ms(SERVING_SHAPE, s, True, dtype)
        timings[dtype] = dict(ms=ms, plain_ms=plain_ms, library_ms=sdpa_ms,
                              bound_ms=bound_ms, bound_by=bound_by)
        _log(f"kernel time serving causal {dtype}: kernel {ms:.4f} ms, "
             f"plain {plain_ms:.4f} ms, sdpa {sdpa_ms:.4f} ms, bound "
             f"{bound_ms:.4f} ms ({bound_by})")
    return {"max_abs_err": worst, "timings": timings}


def _first_step_tokens(requests, max_batch, max_len):
    """The token rectangle of the engine's first decode step."""
    from flexflow_tpu_torch.serve.batcher import (ContinuousBatcher,
                                                  RequestQueue)

    queue = RequestQueue(requests)
    batcher = ContinuousBatcher(max_batch, max_len)
    batcher.admit(queue, queue.next_arrival())
    return batcher.token_matrix(0)


def slice_phase(torch, fa, kernels) -> dict:
    import numpy as np

    from flexflow_tpu_torch.apps import serve
    from flexflow_tpu_torch.serve.engine import ServeEngine
    from flexflow_tpu_torch.serve.loadgen import synthetic_requests

    opts = serve.parse_args(["gpt", "--requests", "16",
                             "--max-new-tokens", "4", "--device", "cuda"])
    engine, requests, _ = serve.build_engine(opts, log=_log)
    model, t = engine.model, engine.model.t
    if (t.num_layers, t.d_model, t.num_heads, t.d_ff, t.vocab_size,
            t.seq_length, engine.max_batch) != (12, 768, 12, 3072, 32768,
                                                512, 8):
        raise AssertionError(f"not the full-width GPT: {t}")
    torch.cuda.synchronize()

    kernels.reset_launches()
    t0 = time.perf_counter()
    summary = engine.run(requests)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(kernels.launches)
    n = launches.get(fa.NAME, 0)
    _log(f"slice: {summary['completed']}/{summary['requests']} requests, "
         f"{summary['steps']} decode steps in {wall:.3f} s wall, "
         f"{n} {fa.NAME} launches; launches by kernel {launches}")
    if summary["completed"] != len(requests) or summary["unserved"]:
        raise AssertionError(f"not every request completed: {summary}")
    if n != t.num_layers * summary["steps"] or n == 0:
        raise AssertionError(f"{fa.NAME} launched {n} times, expected "
                             f"{t.num_layers} x {summary['steps']} steps")
    replies = [list(r.reply) for r in requests]

    # the same model with the plain attention: first-step log-probs and
    # every reply
    toks = _first_step_tokens(synthetic_requests(
        16, seed=0, rate_qps=100.0, vocab_size=t.vocab_size, prompt_len=4,
        max_new_tokens=4), engine.max_batch, engine.max_len)
    labels = np.zeros_like(toks)
    predict = model.make_predict_step()
    lp_k = predict(engine.params, {}, toks, labels)[0]
    with _plain_attention():
        lp_p = predict(engine.params, {}, toks, labels)[0]
        ref = ServeEngine(model, params=engine.params, log=_log)
        ref_requests = synthetic_requests(
            16, seed=0, rate_qps=100.0, vocab_size=t.vocab_size,
            prompt_len=4, max_new_tokens=4)
        ref_summary = ref.run(ref_requests)
    torch.cuda.synchronize()
    if tuple(lp_k.shape) != (8, 512, 32768) or not bool(
            torch.isfinite(lp_k).all()):
        raise AssertionError(f"log-probs not finite of shape (8, 512, "
                             f"32768): {tuple(lp_k.shape)}")
    lp_err = float((lp_k - lp_p).abs().max())
    _log(f"slice: first-step log-probs kernel vs plain attention max_abs_err "
         f"{lp_err:.3e} (tolerance {LOGPROB_ATOL:g})")
    if not lp_err <= LOGPROB_ATOL:
        raise AssertionError(f"first-step log-probs differ by {lp_err}")
    ref_replies = [list(r.reply) for r in ref_requests]
    if replies != ref_replies or ref_summary["steps"] != summary["steps"]:
        raise AssertionError(f"replies differ from the plain-attention run: "
                             f"{replies} vs {ref_replies}")
    _log(f"slice: {len(replies)} replies identical to the plain-attention "
         f"run; first reply {replies[0]}")
    _log("slice summary " + json.dumps(
        {k: summary[k] for k in ("qps", "p50_s", "p99_s", "ttft_p50_s",
                                 "tpot_p50_s", "steps", "wall_s")}))
    return {"launches": n, "engine": engine, "requests": requests}


def profile_phase(torch, engine) -> None:
    """One full-batch decode step: event-timed, then traced."""
    import numpy as np

    from torch.profiler import ProfilerActivity, profile

    from flexflow_tpu_torch.serve.batcher import (ContinuousBatcher,
                                                  RequestQueue)
    from flexflow_tpu_torch.serve.loadgen import Request

    batcher = ContinuousBatcher(engine.max_batch, engine.max_len)
    rng = np.random.RandomState(0)
    reqs = [Request(rid=i, arrival_v=0.0, max_new_tokens=4,
                    tokens=rng.randint(2, engine.model.t.vocab_size,
                                       4).astype(np.int32))
            for i in range(engine.max_batch)]
    batcher.admit(RequestQueue(reqs), 0.0)
    tokens = batcher.token_matrix(0)
    extra = engine._zero_extra_inputs()
    active = batcher.active()

    def step():
        outs = engine._predict(engine.params, engine.state, tokens, *extra)
        engine._last_rows(outs[0], active)

    step_ms = _time_ms(torch, step, iters=10, warmup=2)
    _log(f"profile: one decode step (8 active slots, host copy included) "
         f"{step_ms:.3f} ms by CUDA events")
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(3):
            step()
        torch.cuda.synchronize()
    # kernel rows only: an operator row's device time repeats its kernels'
    kernels_ = [e for e in prof.key_averages()
                if e.device_type == torch.autograd.DeviceType.CUDA]
    kernels_.sort(key=lambda e: e.self_device_time_total, reverse=True)
    total = sum(e.self_device_time_total for e in kernels_)
    _log(f"profile: kernel time {total / 3e3:.3f} ms/step of "
         f"{step_ms:.3f} ms/step")
    for e in kernels_[:12]:
        us = e.self_device_time_total
        _log(f"profile:   {us / 3e3:9.4f} ms/step  {100 * us / total:5.1f}%  "
             f"x{e.count // 3:<4d} {e.key[:90]}")


def main(argv) -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available — this smoke runs on an "
              "NVIDIA GPU", file=sys.stderr)
        return 2

    from flexflow_tpu_torch.ops import kernels
    from flexflow_tpu_torch.ops.kernels import flash_attention as fa

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    _log(_card_line())
    _log(f"torch {torch.__version__} cuda {torch.version.cuda}; "
         f"{torch.cuda.device_count()} device(s)")

    t0 = time.perf_counter()
    built = kernels.build([fa.SOURCE])
    _log(f"build: {time.perf_counter() - t0:.2f} s for {len(built)} "
         f"kernel source(s) (parallel nvcc)")
    for source, info in built.items():
        _log(f"build {source}: {info['seconds']:.2f} s -> {info['path']}")
        for line in info["log"].splitlines():
            if "registers" in line or "spill" in line:
                _log(f"build {source}: {line.strip()}")

    checked = kernel_phase(torch, fa)
    sliced = slice_phase(torch, fa, kernels)
    if "--profile" in argv:
        profile_phase(torch, sliced["engine"])

    f32 = checked["timings"]["float32"]
    line = {"kernels": [{
        "name": fa.NAME, "route": "cuda",
        "source": "flexflow_tpu_torch/csrc/flash_attention_fwd.cu",
        "replaces": "flexflow_tpu/ops/pallas/flash_attention.py:62",
        "launches": sliced["launches"],
        "max_abs_err": checked["max_abs_err"],
        "ms": f32["ms"], "plain_ms": f32["plain_ms"],
        "bound_ms": f32["bound_ms"], "bound_by": f32["bound_by"],
        "library_ms": f32["library_ms"],
    }]}
    print(json.dumps(line), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
