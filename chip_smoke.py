#!/usr/bin/env python3
"""Chip smoke of the PyTorch port: builds its CUDA kernels, holds each one
against its plain PyTorch version on the card, drives each ported path at
full width through its entry point — the GPT served by ``apps.serve``,
the GPT trained by ``apps.lm``, and Inception-v3 and DenseNet-121 trained
by ``apps.cnn`` — and checks that each path ran through its kernels.

    python3 chip_smoke.py              # the smoke (one GPU)
    python3 chip_smoke.py --profile    # plus torch.profiler breakdowns of
                                       # one decode step, one LM training
                                       # step, one Inception and one
                                       # DenseNet training step

Phases (any failure exits non-zero):

1. CUDA present, card name and power limit (nvidia-smi);
2. build every kernel from ``flexflow_tpu_torch/csrc/`` (one nvcc per
   source, all started together) and print the build seconds;
3. flash kernel phase: flash_attention_fwd against its plain version at
   the serving shape (8, 12, 512, 64) causal in float32 and bfloat16, a
   ragged S = 77, a non-causal case and an empty K; then its time, the
   plain version's and ``scaled_dot_product_attention``'s (a yardstick
   the port never calls) at the serving shape;
4. flash backward phase: kernels 2 (dk, dv) and 3 (dq) against the
   plain backward at the LM training shape (16, 12, 512, 64) causal in
   float32 and bfloat16 and a ragged non-causal cross case (Sq 77, Sk
   300); then their times beside the plain backward's and the backward of
   ``scaled_dot_product_attention`` (a yardstick the port never calls);
5. fused cross-entropy phase: kernels 4 (forward), 5 (dx) and 6 (dw, db)
   against their plain versions at the LM head's N = 8192, d = 768,
   V = 32768 in float32 and bfloat16, and at GPT-2's V = 50257, labels
   with -1 (no target) included; then their times beside the plain
   versions' and the unfused library pair (``x @ w + b``, then
   ``F.cross_entropy``, forward and backward);
6. pool kernel phase: the max-pool forward and backward (kernel 7) at
   Inception's four max-pool geometries at N = 256 in bfloat16 and
   float32, tie-heavy integer inputs, a pad-1 and a 2x2 geometry, and
   the avg-pool backward (kernel 8) at the 8x8x2048 global tail, against
   their plain versions; then kernel, plain and library-yardstick times
   (``max_pool2d_with_indices`` and its backward, ``avg_pool2d_backward``,
   which the port never calls) at the main path's shapes;
7. BN kernel phase: kernels 9 (fused BN normalize + ReLU forward) and 10
   (its backward: dx and a partial-sum pass, then the finishing sum)
   against their plain versions in float32 and bfloat16, ReLU on and off,
   at DenseNet-121's stem (802816 x 64), dense1 (200704 x 256) and
   dense3 (12544 x 1024) geometries, a ragged C = 130 and a small C = 7;
   then, summed over one DenseNet-121 training step's 117 BNs at batch
   64 in bfloat16, the kernels', the plain versions' and a library
   yardstick's times (``F.batch_norm(training=False)`` on the
   channels_last NCHW view with weight inv, bias shift, running mean 0
   and running var 1 - eps — the same affine — then ``F.relu``; and
   ``torch.autograd.grad`` of that to x, weight and bias; the port never
   calls it);
8. serving slice: ``apps.serve gpt`` at full width (12 x 768, 12 heads,
   d_ff 3072, vocab 32768, seq 512, max_batch 8, float32) serving 16
   requests of 4 new tokens: every request completes, the flash kernel
   ran 12 times per decode step, and the first step's log-probs and all
   replies match the same model run with the plain attention;
9. LM training slice: ``apps.lm`` at the JAX app's own example (causal,
   batch 16, seq 512, 12 layers, d_model 768, 12 heads, d_ff 3072, vocab
   32768, float32, plain SGD at lr 1e-3) for 3 warm-up and 10 timed steps:
   finite losses, the first near ln 32768, per step 12 launches each of
   kernels 1, 2 and 3 and one each of kernels 4, 5 and 6, and the first 3
   losses within 1e-4 (relative) of the same run with every kernel
   swapped for its plain version; tokens/s, step ms and peak memory;
10. Inception training slice: ``apps.cnn inception`` at bench.py's
    protocol (batch 256, 299x299, bfloat16 compute, float32 params, lr
    0.01, wd 1e-4, momentum 0, seeded random data) for 3 warm-up and 10
    timed steps: finite losses, 4 max-pool and 1 avg-pool kernel launches
    per step, and the first 3 losses within 2e-2 of the same run with the
    plain pools; images/s, step ms and peak memory;
11. DenseNet training slice: ``apps.cnn densenet`` at full width and
    depth (batch 64, 224x224, bfloat16 compute, float32 params, the same
    protocol) for 3 warm-up and 10 timed steps: finite losses, per step
    117 launches each of kernel 9, kernel 10 and its finishing sum, one
    max-pool forward and backward and 4 avg-pool backward launches; the
    first loss equal to the run with kernels 7-10 swapped for their plain
    versions and the next two within 1e-3 (relative) of it; images/s,
    step ms and peak memory;
12. (``--profile``) where the device time of one decode step, one LM
    training step, one Inception and one DenseNet training step goes;
13. a ``kernels`` JSON line, then, last, the ``ok`` JSON line.

Times come from CUDA events over repeated launches after a warm-up; a
kernel's launches are enqueued behind a sleep kernel, so its time is the
device's even where launching it costs the host more (steps are timed
without the sleep, at the host's pace).  ``bound_ms`` is the larger of the bytes a call must move (each input read
once, each output written once) at 3.35 TB/s and its FLOPs at the peak
for the input type: 67 TFLOP/s float32 outside the tensor cores, 989
TFLOP/s bfloat16 — the H100 SXM data-sheet rates at 700 W.  The pools
and the BN kernels do a few compares, multiplies or adds per byte, so
bytes bound them.  A flash backward kernel counts 8 (dk, dv) or 6 (dq) x
d FLOPs per unmasked (query, key) pair; a fused cross-entropy kernel
2 N d V (forward) or 4 N d V (the logits recomputed, then one product).
"""

from __future__ import annotations

import contextlib
import json
import math
import subprocess
import sys
import time

HBM_BYTES_PER_S = 3.35e12
# cycles per second the timing's sleep kernel is sized with: at least the
# H100 SXM's top SM clock (1.98 GHz), so the sleep lasts as long as asked
SLEEP_HZ = 2.0e9
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12}
SERVING_SHAPE = (8, 12, 512, 64)        # B, H, S, d of the GPT at seq 512
KERNEL_ATOL = 1e-4   # float32 sums in another order, over up to 512 keys
LOGPROB_ATOL = 1e-4  # that difference through 12 layers and the vocab head
# the flash backward and fused cross-entropy kernels against their plain
# versions, as a share of each output's largest magnitude: float32 sums
# over up to 512 keys or 32768 vocab columns in another order; with
# bfloat16 operands both versions round p, ds or t to bfloat16 before a
# product, and a sum taken in another order can tip a rounding one step
GRAD_RTOL = {"float32": 1e-4, "bfloat16": 1e-2}
LM_SHAPE = (16, 12, 512, 64)            # B, H, S, d of the LM training step
CE_SHAPE = (16 * 512, 768, 32768)       # N, d, V of its vocab head
GPT2_VOCAB = 50257
LM_LOSS_RTOL = 1e-4  # the kernel vs plain-kernel LM runs' first losses
LM_WARMUP, LM_TIMED, LM_CHECKED = 3, 10, 3
# the pool kernels do the plain versions' float32 compares, and their
# float32 adds in the same order, cast once: they must agree exactly
POOL_ATOL = 0.0
# the training losses of the kernel and plain-pool runs: the pools agree
# exactly, so what is left is cuDNN's run-to-run order of sums in bf16
LOSS_RTOL = 2e-2
POOL_N = 256
# Inception-v3's max-pool inputs (pool1, pool2, incB1_b3_pool,
# incD1_b3_pool; 3x3 stride 2 pad 0, fused ReLU) and its global avg pool
INCEPTION_MAX_POOLS = [(147, 147, 64), (73, 73, 192), (36, 36, 288),
                       (17, 17, 768)]
INCEPTION_AVG_POOL = (8, 8, 2048)
TRAIN_WARMUP, TRAIN_TIMED, TRAIN_CHECKED = 3, 10, 3
# kernels 9 and 10 against their plain versions: y and dx agree exactly
# (the same float32 mul, add and compare, unfused, then one cast); d_inv
# and d_shift within this share of sum |g x| and sum |g| (float32 sums of
# up to 802816 rows in another order, which the values themselves, able
# to cancel, cannot scale)
BN_SUM_RTOL = 1e-5
BN_GEOMETRIES = [("stem", 802816, 64), ("dense1", 200704, 256),
                 ("dense3", 12544, 1024), ("ragged C", 4096, 130),
                 ("small C", 512, 7)]
# DenseNet-121 BN shapes whose times are logged one by one: bn1, a
# dense1 bn2, dense3's widest bn1
BN_LOGGED_SHAPES = ((802816, 64), (200704, 128), (12544, 992))
DENSENET_BATCH = 64
DENSENET_BNS = 117             # bn1 + 2 x (6 + 12 + 24 + 16) dense layers
# the kernel and plain-kernel DenseNet runs: the forward kernels equal
# their plain versions, so the first loss is equal; after a step the
# sums of kernel 10 (and cuDNN's backward) add in another order
DENSENET_LOSS_RTOL = 1e-3


def _log(msg: str) -> None:
    print(msg, flush=True)


def _card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True)
    return out.stdout.strip().splitlines()[0]


def _time_ms(torch, fn, iters: int = 50, warmup: int = 5,
             hold: bool = True) -> float:
    """Milliseconds per call of ``fn`` by CUDA events around ``iters``
    calls.  With ``hold`` (kernel timings) a sleep kernel holds the stream
    until the host has enqueued every call, so a call whose launch costs
    the host more than its kernels cost the device is still timed on the
    device; without it (step timings) the host's pace shows."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    if hold:
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
        host_s = time.perf_counter() - t0
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    if hold:
        torch.cuda._sleep(int(SLEEP_HZ * (2.0 * host_s + 1e-3)))
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _bound(flops: float, nbytes: float, dtype: str) -> tuple:
    """(bound_ms, bound_by) of a call doing ``flops`` on ``dtype`` inputs
    and moving ``nbytes``."""
    t_ops = flops / PEAK_FLOPS[dtype]
    t_bytes = nbytes / HBM_BYTES_PER_S
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


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
    return _bound(flops, nbytes, dtype)


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
def _plain_kernels():
    """Route the sequence models' kernels (flash forward and backward, the
    fused cross-entropy forward and backward) to their plain versions for
    a reference run: the autograd functions look them up when called."""
    from flexflow_tpu_torch.ops.kernels import flash_attention as fa
    from flexflow_tpu_torch.ops.kernels import fused_ce as ce

    saved = (fa.flash_attention_fwd, fa.flash_attention_bwd,
             ce.fused_linear_ce_fwd, ce.fused_linear_ce_bwd)
    fa.flash_attention_fwd = fa.flash_attention_fwd_plain
    fa.flash_attention_bwd = fa.flash_attention_bwd_plain
    ce.fused_linear_ce_fwd = ce.fused_linear_ce_fwd_plain
    ce.fused_linear_ce_bwd = ce.fused_linear_ce_bwd_plain
    try:
        yield
    finally:
        (fa.flash_attention_fwd, fa.flash_attention_bwd,
         ce.fused_linear_ce_fwd, ce.fused_linear_ce_bwd) = saved


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


def _rel_err(torch, got, ref) -> tuple:
    """(max |got - ref|, that over max |ref|)."""
    err = float((got.float() - ref.float()).abs().max())
    scale = float(ref.float().abs().max())
    return err, err / max(scale, 1e-30)


def flash_bwd_phase(torch, fa) -> dict:
    """Kernels 2 and 3 against the plain backward, then their times."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(2)

    def inputs(shape, sk, causal, dtype):
        b, h, sq, d = shape
        q = torch.randn((b, h, sq, d), generator=gen, device="cuda")
        k, v = (torch.randn((b, h, sk, d), generator=gen, device="cuda")
                for _ in range(2))
        q, k, v = (t.to(getattr(torch, dtype)) for t in (q, k, v))
        o, lse = fa.flash_attention_fwd_cuda(q, k, v, causal)
        do = torch.randn((b, h, sq, d), generator=gen, device="cuda")
        return q, k, v, o, lse, do

    b, h, s, d = LM_SHAPE
    cases = [("LM causal float32", LM_SHAPE, s, True, "float32"),
             ("LM causal bfloat16", LM_SHAPE, s, True, "bfloat16"),
             ("non-causal Sq=77 Sk=300 float32", (2, h, 77, d), 300, False,
              "float32"),
             ("non-causal Sq=77 Sk=300 bfloat16", (2, h, 77, d), 300, False,
              "bfloat16")]
    worst = {fa.NAME_DKV: 0.0, fa.NAME_DQ: 0.0}
    for label, shape, sk, causal, dtype in cases:
        q, k, v, o, lse, do = inputs(shape, sk, causal, dtype)
        got = fa.flash_attention_bwd_cuda(q, k, v, o, lse, do, causal)
        torch.cuda.synchronize()
        want = fa.flash_attention_bwd_plain(q, k, v, o, lse, do, causal)
        torch.cuda.synchronize()
        errs = {n: _rel_err(torch, g, w)
                for n, g, w in zip(("dq", "dk", "dv"), got, want)}
        _log(f"flash bwd check {label}: " + ", ".join(
            f"{n} max_abs_err {e:.3e} ({r:.2e} of max)"
            for n, (e, r) in errs.items())
             + f" (tolerance {GRAD_RTOL[dtype]:g} of max)")
        if not all(r <= GRAD_RTOL[dtype] for _, r in errs.values()):
            raise AssertionError(f"{label}: flash backward kernels disagree "
                                 f"with the plain version: {errs}")
        worst[fa.NAME_DQ] = max(worst[fa.NAME_DQ], errs["dq"][0])
        worst[fa.NAME_DKV] = max(worst[fa.NAME_DKV], errs["dk"][0],
                                 errs["dv"][0])

    # times at the LM training shape in float32, the path's dtype
    q, k, v, o, lse, do = inputs(LM_SHAPE, s, True, "float32")
    delta = (do * o).sum(-1)
    pairs = b * h * sum(min(i + 1, s) for i in range(s))
    io = b * h * s * d * 4          # one (B, H, S, d) float32 tensor
    rows = b * h * s * 4            # one (B, H, S) float32 vector
    dkv_ms = _time_ms(torch, lambda: fa.flash_attention_bwd_dkv_cuda(
        q, k, v, do, lse, delta, True), iters=20)
    dq_ms = _time_ms(torch, lambda: fa.flash_attention_bwd_dq_cuda(
        q, k, v, do, lse, delta, True), iters=20)
    plain_ms = _time_ms(torch, lambda: fa.flash_attention_bwd_plain(
        q, k, v, o, lse, do, True), iters=10)
    qs, ks, vs = (t.detach().clone().requires_grad_() for t in (q, k, v))
    out = torch.nn.functional.scaled_dot_product_attention(qs, ks, vs,
                                                           is_causal=True)
    sdpa_ms = _time_ms(torch, lambda: torch.autograd.grad(
        out, (qs, ks, vs), do, retain_graph=True), iters=20)
    timings = {
        fa.NAME_DKV: dict(ms=dkv_ms, plain_ms=plain_ms, library_ms=sdpa_ms),
        fa.NAME_DQ: dict(ms=dq_ms, plain_ms=plain_ms, library_ms=sdpa_ms)}
    timings[fa.NAME_DKV]["bound_ms"], timings[fa.NAME_DKV]["bound_by"] = \
        _bound(8.0 * d * pairs, 6 * io + 2 * rows, "float32")
    timings[fa.NAME_DQ]["bound_ms"], timings[fa.NAME_DQ]["bound_by"] = \
        _bound(6.0 * d * pairs, 5 * io + 2 * rows, "float32")
    for name, t in timings.items():
        _log(f"flash bwd time {name} LM causal float32: kernel "
             f"{t['ms']:.4f} ms, bound {t['bound_ms']:.4f} ms "
             f"({t['bound_by']})")
    _log(f"flash bwd time LM causal float32: kernels 2+3 "
         f"{dkv_ms + dq_ms:.4f} ms, plain backward {plain_ms:.4f} ms, "
         f"sdpa backward {sdpa_ms:.4f} ms (dq, dk and dv each)")
    return {"worst": worst, "timings": timings}


def _ce_inputs(torch, gen, n, d, v, dtype):
    x = torch.randn((n, d), generator=gen, device="cuda")
    w = torch.randn((d, v), generator=gen, device="cuda") * 0.02
    b = torch.randn((v,), generator=gen, device="cuda") * 0.02
    labels = torch.randint(0, v, (n,), generator=gen, device="cuda",
                           dtype=torch.int32)
    labels[511::512] = -1           # the causal shift's last position
    g = torch.full((n,), 1.0 / n, device="cuda")
    dt = getattr(torch, dtype)
    return x.to(dt), w.to(dt), b, labels, g


def fused_ce_phase(torch, ce) -> dict:
    """Kernels 4, 5 and 6 against their plain versions, then their
    times."""
    import torch.nn.functional as F

    gen = torch.Generator(device="cuda")
    gen.manual_seed(3)
    n, d, v = CE_SHAPE
    worst = {ce.NAME_FWD: 0.0, ce.NAME_DX: 0.0, ce.NAME_DW: 0.0}
    for label, vocab, dtype in (("LM head float32", v, "float32"),
                                ("LM head bfloat16", v, "bfloat16"),
                                (f"GPT-2 vocab {GPT2_VOCAB} float32",
                                 GPT2_VOCAB, "float32")):
        x, w, b, lab, g = _ce_inputs(torch, gen, n, d, vocab, dtype)
        nll, lse = ce.fused_linear_ce_fwd_cuda(x, w, b, lab)
        dx, dw, db = ce.fused_linear_ce_bwd_cuda(x, w, b, lab, lse, g)
        torch.cuda.synchronize()
        nll_p, lse_p = ce.fused_linear_ce_fwd_plain(x, w, b, lab)
        grads_p = ce.fused_linear_ce_bwd_plain(x, w, b, lab, lse_p, g)
        torch.cuda.synchronize()
        errs = {"nll": _rel_err(torch, nll, nll_p),
                "lse": _rel_err(torch, lse, lse_p)}
        errs.update({k: _rel_err(torch, a, c) for k, a, c in
                     zip(("dx", "dw", "db"), (dx, dw, db), grads_p)})
        tol = {"nll": GRAD_RTOL["float32"], "lse": GRAD_RTOL["float32"],
               "dx": GRAD_RTOL[dtype], "dw": GRAD_RTOL[dtype],
               "db": GRAD_RTOL[dtype]}
        _log(f"fused ce check {label} (N {n}, d {d}, V {vocab}, "
             f"{int((lab < 0).sum())} labels -1): " + ", ".join(
                 f"{k} max_abs_err {e:.3e} ({r:.2e} of max, tolerance "
                 f"{tol[k]:g})" for k, (e, r) in errs.items()))
        if not all(errs[k][1] <= tol[k] for k in errs):
            raise AssertionError(f"{label}: fused cross-entropy kernels "
                                 f"disagree with the plain versions: {errs}")
        worst[ce.NAME_FWD] = max(worst[ce.NAME_FWD], errs["nll"][0],
                                 errs["lse"][0])
        worst[ce.NAME_DX] = max(worst[ce.NAME_DX], errs["dx"][0])
        worst[ce.NAME_DW] = max(worst[ce.NAME_DW], errs["dw"][0],
                                errs["db"][0])
        del x, w, b, lab, g, nll, lse, dx, dw, db, nll_p, lse_p, grads_p
        torch.cuda.empty_cache()

    # times at the LM head's shape in float32, the path's dtype
    x, w, b, lab, g = _ce_inputs(torch, gen, n, d, v, "float32")
    nll, lse = ce.fused_linear_ce_fwd_cuda(x, w, b, lab)
    fwd_ms = _time_ms(torch, lambda: ce.fused_linear_ce_fwd_cuda(
        x, w, b, lab), iters=5, warmup=1)
    dx_ms = _time_ms(torch, lambda: ce.fused_linear_ce_bwd_dx_cuda(
        x, w, b, lab, lse, g), iters=5, warmup=1)
    dw_ms = _time_ms(torch, lambda: ce.fused_linear_ce_bwd_dw_cuda(
        x, w, b, lab, lse, g), iters=5, warmup=1)
    plain_fwd_ms = _time_ms(torch, lambda: ce.fused_linear_ce_fwd_plain(
        x, w, b, lab), iters=5, warmup=1)
    plain_bwd_ms = _time_ms(torch, lambda: ce.fused_linear_ce_bwd_plain(
        x, w, b, lab, lse, g), iters=5, warmup=1)
    lab64 = lab.long()

    def lib_fwd(xs, ws, bs):
        return F.cross_entropy(torch.addmm(bs, xs, ws), lab64,
                               ignore_index=-1, reduction="none")

    lib_fwd_ms = _time_ms(torch, lambda: lib_fwd(x, w, b), iters=5,
                          warmup=1)
    xs, ws, bs = (t.detach().clone().requires_grad_() for t in (x, w, b))
    lib_nll = lib_fwd(xs, ws, bs)
    lib_bwd_ms = _time_ms(torch, lambda: torch.autograd.grad(
        lib_nll, (xs, ws, bs), g, retain_graph=True), iters=5, warmup=1)
    inputs = n * d * 4 + d * v * 4 + v * 4 + n * 4
    flops = 2.0 * n * d * v
    timings = {
        ce.NAME_FWD: dict(ms=fwd_ms, plain_ms=plain_fwd_ms,
                          library_ms=lib_fwd_ms),
        ce.NAME_DX: dict(ms=dx_ms, plain_ms=plain_bwd_ms,
                         library_ms=lib_bwd_ms),
        ce.NAME_DW: dict(ms=dw_ms, plain_ms=plain_bwd_ms,
                         library_ms=lib_bwd_ms)}
    for name, fl, nbytes in (
            (ce.NAME_FWD, flops, inputs + 2 * n * 4),
            (ce.NAME_DX, 2 * flops, inputs + 2 * n * 4 + n * d * 4),
            (ce.NAME_DW, 2 * flops, inputs + 2 * n * 4 + d * v * 4 + v * 4)):
        t = timings[name]
        t["bound_ms"], t["bound_by"] = _bound(fl, nbytes, "float32")
        _log(f"fused ce time {name} N {n} d {d} V {v} float32: kernel "
             f"{t['ms']:.4f} ms, plain {t['plain_ms']:.4f} ms, library "
             f"{t['library_ms']:.4f} ms, bound {t['bound_ms']:.4f} ms "
             f"({t['bound_by']})")
    _log(f"fused ce time float32: kernels 4+5+6 {fwd_ms + dx_ms + dw_ms:.4f}"
         f" ms, plain {plain_fwd_ms + plain_bwd_ms:.4f} ms, library pair "
         f"(addmm + cross_entropy, forward and backward) "
         f"{lib_fwd_ms + lib_bwd_ms:.4f} ms")
    return {"worst": worst, "timings": timings}


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
    with _plain_kernels():
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


def _pool_bytes(*planes) -> int:
    """Bytes of the given (dtype, element count) planes."""
    esize = {"float32": 4, "bfloat16": 2, "uint8": 1}
    return sum(esize[dt] * n for dt, n in planes)


def _maxpool_case(torch, mp, gen, shape, k, p, relu, dtype, ties):
    n, h, w, c = shape
    if ties:
        x = torch.randint(-3, 4, shape, generator=gen, device="cuda")
    else:
        x = torch.randn(shape, generator=gen, device="cuda")
    x = x.to(getattr(torch, dtype))
    y, sel = mp.maxpool_fwd_cuda(x, k, p, relu)
    y_p, sel_p = mp.maxpool_fwd_plain(x, k, p, relu)
    dy = torch.randn(y.shape, generator=gen, device="cuda").to(x.dtype)
    dx = mp.maxpool_bwd_cuda(dy, sel, h, w, k, p)
    dx_p = mp.maxpool_bwd_plain(dy, sel, h, w, k, p)
    torch.cuda.synchronize()
    err_fwd = float((y.float() - y_p.float()).abs().max())
    sel_bad = int((sel != sel_p).sum())
    err_bwd = float((dx.float() - dx_p.float()).abs().max())
    return x, y, sel, dy, err_fwd, sel_bad, err_bwd


def pool_kernel_phase(torch) -> dict:
    """Kernels 7 (with its forward) and 8 against their plain versions,
    then their times at the training path's shapes."""
    from flexflow_tpu_torch.ops.kernels import avgpool as ap
    from flexflow_tpu_torch.ops.kernels import maxpool as mp

    gen = torch.Generator(device="cuda")
    gen.manual_seed(1)
    cases = [(f"inception {h}x{w}x{c}", (POOL_N, h, w, c), 3, 0, True,
              dtype, ties)
             for (h, w, c) in INCEPTION_MAX_POOLS
             for dtype, ties in (("bfloat16", False), ("float32", False),
                                 ("bfloat16", True))]
    cases += [("pad-1 56x56x64", (POOL_N, 56, 56, 64), 3, 1, True,
               "bfloat16", True),
              ("pad-1 56x56x64", (POOL_N, 56, 56, 64), 3, 1, False,
               "float32", False),
              ("2x2 28x28x128", (POOL_N, 28, 28, 128), 2, 0, False,
               "bfloat16", True),
              ("2x2 28x28x128", (POOL_N, 28, 28, 128), 2, 0, True,
               "float32", False)]
    worst = {"maxpool_fwd": 0.0, "maxpool_bwd": 0.0, "avgpool_bwd": 0.0}
    for label, shape, k, p, relu, dtype, ties in cases:
        _, _, _, _, e_f, bad, e_b = _maxpool_case(
            torch, mp, gen, shape, k, p, relu, dtype, ties)
        _log(f"pool check max {label} k{k} p{p} relu={relu} {dtype}"
             f"{' ties' if ties else ''}: fwd max_abs_err {e_f:.3e}, "
             f"sel mismatches {bad}, bwd max_abs_err {e_b:.3e} "
             f"(tolerance {POOL_ATOL:g})")
        if not (e_f <= POOL_ATOL and bad == 0 and e_b <= POOL_ATOL):
            raise AssertionError(f"max pool {label} {dtype}: kernels "
                                 f"disagree with the plain versions")
        worst["maxpool_fwd"] = max(worst["maxpool_fwd"], e_f)
        worst["maxpool_bwd"] = max(worst["maxpool_bwd"], e_b)
    h, w, c = INCEPTION_AVG_POOL
    for (kh, kw, relu, dtype) in ((h, w, False, "bfloat16"),
                                  (h, w, False, "float32"),
                                  (h, w, True, "bfloat16"),
                                  (2, 2, True, "float32")):
        x = torch.randn((POOL_N, h, w, c), generator=gen, device="cuda").to(
            getattr(torch, dtype))
        y = ap.avgpool_fwd(x, kh, kw, relu)
        dy = torch.randn(y.shape, generator=gen, device="cuda").to(x.dtype)
        mask = y if relu else None
        dx = ap.avgpool_bwd_cuda(dy, mask, kh, kw)
        dx_p = ap.avgpool_bwd_plain(dy, mask, kh, kw)
        torch.cuda.synchronize()
        err = float((dx.float() - dx_p.float()).abs().max())
        _log(f"pool check avg {h}x{w}x{c} window {kh}x{kw} relu={relu} "
             f"{dtype}: bwd max_abs_err {err:.3e} (tolerance {POOL_ATOL:g})")
        if not err <= POOL_ATOL:
            raise AssertionError("avg-pool kernel disagrees with its plain "
                                 "version")
        worst["avgpool_bwd"] = max(worst["avgpool_bwd"], err)

    # times, bfloat16 (the training path's dtype), at every Inception
    # geometry; inputs of 10-700 MB, so each launch finds them cold in L2
    aten = torch.ops.aten
    per_geometry = []
    for (h, w, c) in INCEPTION_MAX_POOLS:
        x, y, sel, dy, *_ = _maxpool_case(torch, mp, gen, (POOL_N, h, w, c),
                                          3, 0, True, "bfloat16", False)
        xc = x.permute(0, 3, 1, 2)
        _, idx = aten.max_pool2d_with_indices(xc, [3, 3], [2, 2])
        dyc = dy.permute(0, 3, 1, 2)
        oh, ow = y.shape[1], y.shape[2]
        nx, ny = POOL_N * h * w * c, POOL_N * oh * ow * c
        row = {
            "geometry": (POOL_N, h, w, c),
            "fwd": dict(
                ms=_time_ms(torch, lambda: mp.maxpool_fwd_cuda(x, 3, 0,
                                                               True)),
                plain_ms=_time_ms(torch, lambda: mp.maxpool_fwd_plain(
                    x, 3, 0, True), iters=10),
                library_ms=_time_ms(torch, lambda: aten.max_pool2d_with_indices(
                    xc, [3, 3], [2, 2])),
                bound_ms=_pool_bytes(("bfloat16", nx),
                                     ("bfloat16", ny), ("uint8", ny))
                / HBM_BYTES_PER_S * 1e3),
            "bwd": dict(
                ms=_time_ms(torch, lambda: mp.maxpool_bwd_cuda(dy, sel, h, w,
                                                               3, 0)),
                plain_ms=_time_ms(torch, lambda: mp.maxpool_bwd_plain(
                    dy, sel, h, w, 3, 0), iters=10),
                library_ms=_time_ms(
                    torch, lambda: aten.max_pool2d_with_indices_backward(
                        dyc, xc, [3, 3], [2, 2], [0, 0], [1, 1], False, idx)),
                bound_ms=_pool_bytes(("bfloat16", ny),
                                     ("uint8", ny), ("bfloat16", nx))
                / HBM_BYTES_PER_S * 1e3),
        }
        per_geometry.append(row)
        for part in ("fwd", "bwd"):
            t = row[part]
            _log(f"pool time max {part} {POOL_N}x{h}x{w}x{c} bfloat16: "
                 f"kernel {t['ms']:.4f} ms, plain {t['plain_ms']:.4f} ms, "
                 f"library {t['library_ms']:.4f} ms, bound "
                 f"{t['bound_ms']:.4f} ms (bytes)")
        del x, y, sel, dy, xc, idx, dyc
    h, w, c = INCEPTION_AVG_POOL
    x = torch.randn((POOL_N, h, w, c), generator=gen, device="cuda").to(
        torch.bfloat16)
    dy = torch.randn((POOL_N, 1, 1, c), generator=gen, device="cuda").to(
        torch.bfloat16)
    xc, dyc = x.permute(0, 3, 1, 2), dy.permute(0, 3, 1, 2)
    avg = dict(
        ms=_time_ms(torch, lambda: ap.avgpool_bwd_cuda(dy, None, h, w)),
        plain_ms=_time_ms(torch, lambda: ap.avgpool_bwd_plain(dy, None, h,
                                                              w), iters=20),
        library_ms=_time_ms(torch, lambda: aten.avg_pool2d_backward(
            dyc, xc, [h, w], [1, 1], [0, 0], False, True, None)),
        bound_ms=_pool_bytes(("bfloat16", POOL_N * c),
                             ("bfloat16", POOL_N * h * w * c))
        / HBM_BYTES_PER_S * 1e3)
    _log(f"pool time avg bwd {POOL_N}x{h}x{w}x{c} bfloat16: kernel "
         f"{avg['ms']:.4f} ms, plain {avg['plain_ms']:.4f} ms, library "
         f"{avg['library_ms']:.4f} ms, bound {avg['bound_ms']:.4f} ms "
         f"(bytes)")
    step = {part: {key: sum(r[part][key] for r in per_geometry)
                   for key in ("ms", "plain_ms", "library_ms", "bound_ms")}
            for part in ("fwd", "bwd")}
    for part in ("fwd", "bwd"):
        t = step[part]
        _log(f"pool time max {part}, the 4 launches of one training step: "
             f"kernel {t['ms']:.4f} ms, plain {t['plain_ms']:.4f} ms, "
             f"library {t['library_ms']:.4f} ms, bound {t['bound_ms']:.4f} "
             f"ms")
    return {"worst": worst, "max_step": step, "avg": avg}


def _densenet_bn_shapes() -> dict:
    """``{(n, h, w, c): count}`` of DenseNet-121's BN inputs at batch 64,
    read from the port's own graph."""
    from flexflow_tpu_torch.config import FFConfig
    from flexflow_tpu_torch.models.densenet import build_densenet121
    from flexflow_tpu_torch.ops.norm import BatchNorm

    ff = build_densenet121(FFConfig(batch_size=DENSENET_BATCH))
    shapes = {}
    for op in ff.layers:
        if isinstance(op, BatchNorm):
            shape = op.inputs[0].shape
            shapes[shape] = shapes.get(shape, 0) + 1
    if sum(shapes.values()) != DENSENET_BNS:
        raise AssertionError(f"DenseNet-121 has {sum(shapes.values())} BNs")
    return shapes


def _bn_inputs(torch, gen, m, c, dtype):
    x = torch.randn((m, c), generator=gen, device="cuda")
    inv = 1.0 + 0.5 * torch.randn((c,), generator=gen, device="cuda")
    shift = 0.3 * torch.randn((c,), generator=gen, device="cuda")
    g = torch.randn((m, c), generator=gen, device="cuda")
    dt = getattr(torch, dtype)
    return x.to(dt), inv, shift, g.to(dt)


def bn_kernel_phase(torch) -> dict:
    """Kernels 9 and 10 against their plain versions, then their times
    summed over one DenseNet-121 training step's BNs."""
    import torch.nn.functional as F

    from flexflow_tpu_torch.ops.kernels import bn_act as bn

    gen = torch.Generator(device="cuda")
    gen.manual_seed(4)
    worst = {bn.NAME_FWD: 0.0, bn.NAME_BWD: 0.0, bn.NAME_SUM: 0.0}
    for label, m, c in BN_GEOMETRIES:
        for dtype in ("float32", "bfloat16"):
            for relu in (True, False):
                x, inv, shift, g = _bn_inputs(torch, gen, m, c, dtype)
                y = bn.bn_act_fwd_cuda(x, inv, shift, relu)
                dx, part_inv, part_shift = bn.bn_act_bwd_partial_cuda(
                    x, inv, shift, g, relu)
                d_inv, d_shift = bn.bn_act_bwd_sum_cuda(part_inv, part_shift)
                torch.cuda.synchronize()
                y_p = bn.bn_act_fwd_plain(x, inv, shift, relu)
                dx_p, d_inv_p, d_shift_p = bn.bn_act_bwd_plain(
                    x, inv, shift, g, relu)
                gm = g.float()
                if relu:
                    gm = torch.where(x.float() * inv + shift > 0, gm, 0.0)
                mag_inv = (gm * x.float()).abs().sum(0).clamp_min(1e-30)
                mag_shift = gm.abs().sum(0).clamp_min(1e-30)
                err_y = float((y.float() - y_p.float()).abs().max())
                err_dx = float((dx.float() - dx_p.float()).abs().max())
                rel = max(float(((d_inv - d_inv_p).abs() / mag_inv).max()),
                          float(((d_shift - d_shift_p).abs() / mag_shift)
                                .max()))
                err_sum = max(float((d_inv - d_inv_p).abs().max()),
                              float((d_shift - d_shift_p).abs().max()))
                _log(f"bn check {label} {m}x{c} {dtype} relu={relu} "
                     f"({part_inv.shape[0]} row blocks): y max_abs_err "
                     f"{err_y:.3e}, dx max_abs_err {err_dx:.3e} (tolerance "
                     f"0); d_inv, d_shift max_abs_err {err_sum:.3e}, "
                     f"{rel:.2e} of sum |g x|, sum |g| (tolerance "
                     f"{BN_SUM_RTOL:g})")
                if not (err_y == 0 and err_dx == 0 and rel <= BN_SUM_RTOL):
                    raise AssertionError(f"bn {label} {dtype} relu={relu}: "
                                         f"kernels 9-10 disagree with the "
                                         f"plain versions")
                worst[bn.NAME_FWD] = max(worst[bn.NAME_FWD], err_y)
                worst[bn.NAME_BWD] = max(worst[bn.NAME_BWD], err_dx)
                worst[bn.NAME_SUM] = max(worst[bn.NAME_SUM], err_sum)
                del x, g, y, dx, y_p, dx_p, gm, part_inv, part_shift
        torch.cuda.empty_cache()

    # times, bfloat16 with the ReLU (the training path's BNs), at every
    # distinct BN shape of one DenseNet-121 step, times its count
    keys = ("ms", "plain_ms", "library_ms", "bound_ms")
    step = {name: dict.fromkeys(keys, 0.0) for name in worst}
    eps = 1e-5
    geometry = {}
    for (n, h, w, c), count in _densenet_bn_shapes().items():
        m = n * h * w
        x, inv, shift, g = _bn_inputs(torch, gen, m, c, "bfloat16")
        _, part_inv, part_shift = bn.bn_act_bwd_partial_cuda(x, inv, shift,
                                                             g, True)
        xs, ws, bs = (t.detach().clone().requires_grad_()
                      for t in (x, inv, shift))
        zero, one = torch.zeros_like(inv), torch.full_like(inv, 1.0 - eps)

        def lib(xs, ws, bs, n=n, h=h, w=w, c=c, zero=zero, one=one):
            xc = xs.view(n, h, w, c).permute(0, 3, 1, 2)
            return F.relu(F.batch_norm(xc, zero, one, ws, bs, False, 0.0,
                                       eps))

        out = lib(xs, ws, bs)
        gc = g.view(n, h, w, c).permute(0, 3, 1, 2)
        plain_fwd = _time_ms(torch, lambda: bn.bn_act_fwd_plain(
            x, inv, shift, True), iters=5, warmup=1)
        plain_bwd = _time_ms(torch, lambda: bn.bn_act_bwd_plain(
            x, inv, shift, g, True), iters=5, warmup=1)
        lib_fwd = _time_ms(torch, lambda: lib(x, inv, shift), iters=20)
        lib_bwd = _time_ms(torch, lambda: torch.autograd.grad(
            out, (xs, ws, bs), gc, retain_graph=True), iters=20)
        t = {bn.NAME_FWD: dict(
                 ms=_time_ms(torch, lambda: bn.bn_act_fwd_cuda(
                     x, inv, shift, True), iters=20),
                 plain_ms=plain_fwd, library_ms=lib_fwd,
                 bound_ms=_pool_bytes(("bfloat16", 2 * m * c),
                                      ("float32", 2 * c))
                 / HBM_BYTES_PER_S * 1e3),
             bn.NAME_BWD: dict(
                 ms=_time_ms(torch, lambda: bn.bn_act_bwd_partial_cuda(
                     x, inv, shift, g, True), iters=20),
                 plain_ms=plain_bwd, library_ms=lib_bwd,
                 bound_ms=_pool_bytes(("bfloat16", 3 * m * c),
                                      ("float32", 4 * c))
                 / HBM_BYTES_PER_S * 1e3),
             bn.NAME_SUM: dict(
                 ms=_time_ms(torch, lambda: bn.bn_act_bwd_sum_cuda(
                     part_inv, part_shift), iters=20),
                 plain_ms=plain_bwd, library_ms=lib_bwd,
                 bound_ms=_pool_bytes(("float32", 2 * part_inv.numel()),
                                      ("float32", 2 * c))
                 / HBM_BYTES_PER_S * 1e3)}
        for name in worst:
            for key in keys:
                step[name][key] += count * t[name][key]
        if (m, c) in BN_LOGGED_SHAPES:
            geometry[(m, c)] = t
        del x, g, xs, out, gc, part_inv, part_shift
    for (m, c), t in sorted(geometry.items()):
        for name, r in t.items():
            _log(f"bn time {name} {m}x{c} bfloat16 relu: kernel "
                 f"{r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, library "
                 f"{r['library_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms "
                 f"(bytes)")
    for name, r in step.items():
        _log(f"bn time {name}, the {DENSENET_BNS} launches of one DenseNet "
             f"step (batch {DENSENET_BATCH}, bfloat16): kernel "
             f"{r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, library "
             f"{r['library_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms "
             f"(bytes)")
    _log("bn time: plain and library times of kernel 10's two launches are "
         "each the whole plain backward and the whole library backward "
         "(relu backward + batch_norm backward to x, weight and bias)")
    return {"worst": worst, "step": step}


def _lm_argv(iters: int, warmup: int) -> list:
    return ["--causal", "-b", "16", "-s", "512", "-l", "12", "--d-model",
            "768", "--heads", "12", "--d-ff", "3072", "--vocab", "32768",
            "-i", str(iters), "--warmup", str(warmup), "--device", "cuda"]


def lm_phase(torch, kernels, card: str) -> dict:
    """``apps.lm`` at full width through kernels 1-6, then its first
    losses against the run with every kernel swapped for its plain
    version."""
    from flexflow_tpu_torch.apps import lm
    from flexflow_tpu_torch.ops.kernels import flash_attention as fa
    from flexflow_tpu_torch.ops.kernels import fused_ce as ce

    iters = LM_WARMUP + LM_TIMED
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    out = lm.main(_lm_argv(iters, LM_WARMUP), log=_log)
    torch.cuda.synchronize()
    launches = dict(kernels.launches)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    losses = out["loss"]
    step_ms = out["elapsed_s"] / LM_TIMED * 1e3
    _log(f"lm: {iters} steps ({LM_WARMUP} warm-up); launches by kernel "
         f"{launches}")
    _log(f"lm: losses {losses}")
    layers = 12
    want = {fa.NAME: layers * iters, fa.NAME_DKV: layers * iters,
            fa.NAME_DQ: layers * iters, ce.NAME_FWD: iters,
            ce.NAME_DX: iters, ce.NAME_DW: iters}
    if launches != want:
        raise AssertionError(f"LM kernels launched {launches}, expected "
                             f"{want} (12 + 12 + 12 + 1 + 1 + 1 per step)")
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"non-finite LM loss: {losses}")
    if abs(losses[0] - math.log(32768)) > 0.25:
        raise AssertionError(f"first LM loss {losses[0]} is not near "
                             f"ln 32768 = {math.log(32768):.4f}")
    _log(f"lm: {out['tokens_per_sec']:.1f} tokens/s "
         f"({out['images_per_sec']:.3f} sequences/s), {step_ms:.2f} ms per "
         f"step, peak memory {peak_gb:.2f} GB (max_memory_allocated) — "
         f"{card}")

    with _plain_kernels():
        kernels.reset_launches()
        ref = lm.main(_lm_argv(LM_CHECKED, 0), log=lambda *a: None)
        if sum(kernels.launches.values()):
            raise AssertionError("the plain-kernel LM run launched a kernel")
    torch.cuda.synchronize()
    got, want_l = losses[:LM_CHECKED], ref["loss"]
    rel = max(abs(a - c) / max(abs(c), 1e-30) for a, c in zip(got, want_l))
    _log(f"lm: first {LM_CHECKED} losses {got} vs plain kernels {want_l}: "
         f"max rel diff {rel:.3e} (tolerance {LM_LOSS_RTOL:g})")
    if not rel <= LM_LOSS_RTOL:
        raise AssertionError(f"LM losses differ from the plain-kernel run "
                             f"by {rel}")
    return {"launches": launches, "step_ms": step_ms, "peak_gb": peak_gb,
            "tokens_per_sec": out["tokens_per_sec"]}


def _kernel_kind(key: str) -> str:
    """The kind of a device kernel, by its name, for the profiles."""
    k = key.lower()
    if "flash_fwd" in k:
        return "flash forward (kernel 1)"
    if "flash_bwd" in k:
        return "flash backward (kernels 2, 3)"
    if "ce_fwd" in k or "ce_bwd" in k:
        return "fused cross-entropy (kernels 4-6)"
    if "maxpool_" in k or "avgpool_bwd" in k:
        return "pool kernels (7, 8)"
    if "bn_act" in k:
        return "BN + ReLU kernels (9, 10)"
    if "catarray" in k:
        return "concat copies (aten)"
    if "avg_pool" in k:
        return "in-block avg pools (aten)"
    if any(t in k for t in ("conv", "cudnn", "dgrad", "wgrad", "implicit",
                            "fprop", "nhwc")):
        return "convolutions (cuDNN)"
    if any(t in k for t in ("gemm", "cutlass", "xmma", "sgemm")):
        return "matmul (cuBLAS)"
    return "elementwise / other"


def _profile_by_kind(torch, prof, steps: int, step_ms: float,
                     tag: str) -> None:
    rows = [e for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA]
    rows.sort(key=lambda e: e.self_device_time_total, reverse=True)
    total = sum(e.self_device_time_total for e in rows)
    if not total:
        _log(f"profile {tag}: the profiler saw no device time; the step "
             f"time above is from CUDA events")
        return
    by_kind = {}
    for e in rows:
        by_kind[_kernel_kind(e.key)] = by_kind.get(_kernel_kind(e.key),
                                                   0.0) \
            + e.self_device_time_total
    per = 1e3 * steps
    _log(f"profile {tag}: kernel time {total / per:.3f} ms/step of "
         f"{step_ms:.3f} ms/step")
    for k, us in sorted(by_kind.items(), key=lambda kv: -kv[1]):
        _log(f"profile {tag}:   {us / per:9.4f} ms/step  "
             f"{100 * us / total:5.1f}%  {k}")
    for e in rows[:15]:
        us = e.self_device_time_total
        _log(f"profile {tag}:   {us / per:9.4f} ms/step  "
             f"{100 * us / total:5.1f}%  x{e.count // steps:<4d} "
             f"{e.key[:90]}")


def lm_profile_phase(torch) -> None:
    """One full-width LM training step: where its device time goes, by
    kind (GEMMs, kernels 1-6, the rest)."""
    from torch.profiler import ProfilerActivity, profile

    from flexflow_tpu_torch.apps import lm

    cfg, _, _ = lm.parse_args(_lm_argv(1, 0))
    model = lm.TransformerLM(cfg, device="cuda")
    params, state = model.init()
    opt = model.init_opt_state(params)
    step = model.make_train_step()
    toks, labels = next(lm.synthetic_lm_batches(
        cfg.batch_size, cfg.seq_length, cfg.vocab_size, seed=cfg.seed))

    def run():
        return step(params, state, opt, toks, labels)

    step_ms = _time_ms(torch, run, iters=3, warmup=2, hold=False)
    _log(f"profile lm: one step {step_ms:.3f} ms by CUDA events")
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(2):
            run()
        torch.cuda.synchronize()
    _profile_by_kind(torch, prof, 2, step_ms, "lm")


@contextlib.contextmanager
def _plain_cnn_kernels():
    """Route the CNN kernels (7-10: the pools and the fused BN) to their
    plain versions for a reference run."""
    from flexflow_tpu_torch.ops.kernels import avgpool as ap
    from flexflow_tpu_torch.ops.kernels import bn_act as bn
    from flexflow_tpu_torch.ops.kernels import maxpool as mp

    saved = (mp.maxpool_fwd, mp.maxpool_bwd, ap.avgpool_bwd, bn.bn_act_fwd,
             bn.bn_act_bwd)
    mp.maxpool_fwd, mp.maxpool_bwd = mp.maxpool_fwd_plain, mp.maxpool_bwd_plain
    ap.avgpool_bwd = ap.avgpool_bwd_plain
    bn.bn_act_fwd, bn.bn_act_bwd = bn.bn_act_fwd_plain, bn.bn_act_bwd_plain
    try:
        yield
    finally:
        (mp.maxpool_fwd, mp.maxpool_bwd, ap.avgpool_bwd, bn.bn_act_fwd,
         bn.bn_act_bwd) = saved


def _train_argv(batch: int, iters: int, warmup: int,
                model: str = "inception") -> list:
    return [model, "-b", str(batch), "-i", str(iters), "--warmup",
            str(warmup), "--dtype", "bfloat16", "-p", "0"]


def training_phase(torch, kernels, card: str) -> dict:
    """``apps.cnn inception`` at bench.py's protocol, through the pool
    kernels, then its first losses against the plain-pool run."""
    from flexflow_tpu_torch.apps import cnn
    from flexflow_tpu_torch.ops.kernels import avgpool as ap
    from flexflow_tpu_torch.ops.kernels import maxpool as mp

    iters = TRAIN_WARMUP + TRAIN_TIMED
    batch = 256
    while True:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launches()
        try:
            out = cnn.main(_train_argv(batch, iters, TRAIN_WARMUP), log=_log)
            break
        except torch.cuda.OutOfMemoryError:
            if batch <= 32:
                raise
            _log(f"train: batch {batch} does not fit on the card; halving "
                 f"(a cut of bench.py's batch 256)")
            batch //= 2
    torch.cuda.synchronize()
    launches = dict(kernels.launches)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    losses = out["loss"]
    step_ms = out["elapsed_s"] / TRAIN_TIMED * 1e3
    _log(f"train: inception batch {batch}, {iters} steps "
         f"({TRAIN_WARMUP} warm-up); launches by kernel {launches}")
    _log(f"train: losses {losses}")
    want = {mp.NAME_FWD: 4 * iters, mp.NAME_BWD: 4 * iters,
            ap.NAME: 1 * iters}
    if {k: launches.get(k, 0) for k in want} != want:
        raise AssertionError(f"pool kernels launched {launches}, expected "
                             f"{want} (4 max and 1 avg pool per step)")
    if not all(math.isfinite(v) for v in losses):
        raise AssertionError(f"non-finite training loss: {losses}")
    _log(f"train: {out['images_per_sec']:.2f} images/s, {step_ms:.2f} ms "
         f"per step, peak memory {peak_gb:.2f} GB "
         f"(max_memory_allocated), batch {batch} — {card}")

    with _plain_cnn_kernels():
        kernels.reset_launches()
        ref = cnn.main(_train_argv(batch, TRAIN_CHECKED, 0),
                       log=lambda *a: None)
        if sum(kernels.launches.values()):
            raise AssertionError("the plain-pool run launched a kernel")
    torch.cuda.synchronize()
    got, want_l = losses[:TRAIN_CHECKED], ref["loss"]
    rel = max(abs(a - b) / max(abs(b), 1e-30) for a, b in zip(got, want_l))
    _log(f"train: first {TRAIN_CHECKED} losses {got} vs plain pools "
         f"{want_l}: max rel diff {rel:.3e} (tolerance {LOSS_RTOL:g})")
    if not rel <= LOSS_RTOL:
        raise AssertionError(f"training losses differ from the plain-pool "
                             f"run by {rel}")
    return {"batch": batch, "launches": launches, "step_ms": step_ms,
            "images_per_sec": out["images_per_sec"], "peak_gb": peak_gb}


def densenet_phase(torch, kernels, card: str) -> dict:
    """``apps.cnn densenet`` at full width and depth through kernels 7-10,
    then its first losses against the run with those kernels swapped for
    their plain versions."""
    from flexflow_tpu_torch.apps import cnn
    from flexflow_tpu_torch.ops.kernels import avgpool as ap
    from flexflow_tpu_torch.ops.kernels import bn_act as bn
    from flexflow_tpu_torch.ops.kernels import maxpool as mp

    iters = TRAIN_WARMUP + TRAIN_TIMED
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    out = cnn.main(_train_argv(DENSENET_BATCH, iters, TRAIN_WARMUP,
                               "densenet"), log=_log)
    torch.cuda.synchronize()
    launches = dict(kernels.launches)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    losses = out["loss"]
    step_ms = out["elapsed_s"] / TRAIN_TIMED * 1e3
    _log(f"densenet: batch {DENSENET_BATCH}, {iters} steps ({TRAIN_WARMUP} "
         f"warm-up); launches by kernel {launches}")
    _log(f"densenet: losses {losses}")
    want = {bn.NAME_FWD: DENSENET_BNS * iters, bn.NAME_BWD: DENSENET_BNS *
            iters, bn.NAME_SUM: DENSENET_BNS * iters, mp.NAME_FWD: iters,
            mp.NAME_BWD: iters, ap.NAME: 4 * iters}
    if launches != want:
        raise AssertionError(f"DenseNet kernels launched {launches}, "
                             f"expected {want} (117 + 117 + 117 BN, 1 + 1 "
                             f"max-pool and 4 avg-pool launches per step)")
    if not all(math.isfinite(v) for v in losses):
        raise AssertionError(f"non-finite DenseNet loss: {losses}")
    _log(f"densenet: {out['images_per_sec']:.2f} images/s, {step_ms:.2f} ms "
         f"per step, peak memory {peak_gb:.2f} GB (max_memory_allocated), "
         f"batch {DENSENET_BATCH} — {card}")

    with _plain_cnn_kernels():
        kernels.reset_launches()
        ref = cnn.main(_train_argv(DENSENET_BATCH, TRAIN_CHECKED, 0,
                                   "densenet"), log=lambda *a: None)
        if sum(kernels.launches.values()):
            raise AssertionError("the plain-kernel DenseNet run launched a "
                                 "kernel")
    torch.cuda.synchronize()
    got, want_l = losses[:TRAIN_CHECKED], ref["loss"]
    rel = max(abs(a - b) / max(abs(b), 1e-30) for a, b in zip(got, want_l))
    _log(f"densenet: first {TRAIN_CHECKED} losses {got} vs plain kernels "
         f"{want_l}: first equal {got[0] == want_l[0]}, max rel diff "
         f"{rel:.3e} (tolerance {DENSENET_LOSS_RTOL:g})")
    if got[0] != want_l[0]:
        raise AssertionError(f"the first DenseNet loss {got[0]} differs from "
                             f"the plain-kernel run's {want_l[0]}")
    if not rel <= DENSENET_LOSS_RTOL:
        raise AssertionError(f"DenseNet losses differ from the plain-kernel "
                             f"run by {rel}")
    # kernel 10 adds without atomics: a second kernel run repeats the
    # first where cuDNN's algorithms are deterministic too (logged only)
    again = cnn.main(_train_argv(DENSENET_BATCH, TRAIN_CHECKED, 0,
                                 "densenet"), log=lambda *a: None)["loss"]
    _log(f"densenet: a second kernel run's first {TRAIN_CHECKED} losses "
         f"{again}: identical to the first run's {again == got}")
    return {"launches": launches, "step_ms": step_ms, "peak_gb": peak_gb,
            "images_per_sec": out["images_per_sec"]}


def train_profile_phase(torch, model: str, batch: int) -> None:
    """One full-width CNN training step: where its device time goes, by
    kernel and by kind (cuDNN convolutions, the pool and BN kernels, the
    rest)."""
    from torch.profiler import ProfilerActivity, profile

    from flexflow_tpu_torch.apps import cnn
    from flexflow_tpu_torch.data import synthetic_batches

    name, cfg, _, _ = cnn.parse(_train_argv(batch, 1, 0, model))
    ff = cnn.build(name, cfg, torch.device("cuda"))
    params, state = ff.init()
    opt = ff.init_opt_state(params)
    step = ff.make_train_step()
    image, labels = next(synthetic_batches(
        batch, cfg.input_height, cfg.input_width,
        num_classes=cfg.num_classes, mode="random", seed=cfg.seed,
        device=ff.device))

    def run():
        return step(params, state, opt, image, labels)

    step_ms = _time_ms(torch, run, iters=3, warmup=2, hold=False)
    _log(f"profile {model}: one step {step_ms:.3f} ms by CUDA events "
         f"(batch {batch})")
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(2):
            run()
        torch.cuda.synchronize()
    _profile_by_kind(torch, prof, 2, step_ms, model)


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

    step_ms = _time_ms(torch, step, iters=10, warmup=2, hold=False)
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
    from flexflow_tpu_torch.ops.kernels import avgpool as ap
    from flexflow_tpu_torch.ops.kernels import bn_act as bn
    from flexflow_tpu_torch.ops.kernels import flash_attention as fa
    from flexflow_tpu_torch.ops.kernels import fused_ce as ce
    from flexflow_tpu_torch.ops.kernels import maxpool as mp

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = _card_line()
    _log(card)
    _log(f"torch {torch.__version__} cuda {torch.version.cuda}; "
         f"{torch.cuda.device_count()} device(s)")

    t0 = time.perf_counter()
    built = kernels.build([fa.SOURCE, fa.SOURCE_BWD, ce.SOURCE, mp.SOURCE,
                           ap.SOURCE, bn.SOURCE])
    _log(f"build: {time.perf_counter() - t0:.2f} s for {len(built)} "
         f"kernel source(s) (parallel nvcc)")
    for source, info in built.items():
        _log(f"build {source}: {info['seconds']:.2f} s -> {info['path']}")
        for line in info["log"].splitlines():
            if "registers" in line or "spill" in line:
                _log(f"build {source}: {line.strip()}")

    checked = kernel_phase(torch, fa)
    flash_bwd = flash_bwd_phase(torch, fa)
    fused = fused_ce_phase(torch, ce)
    pools = pool_kernel_phase(torch)
    bns = bn_kernel_phase(torch)
    sliced = slice_phase(torch, fa, kernels)
    lm_run = lm_phase(torch, kernels, card)
    trained = training_phase(torch, kernels, card)
    dense = densenet_phase(torch, kernels, card)
    if "--profile" in argv:
        profile_phase(torch, sliced["engine"])
        lm_profile_phase(torch)
        train_profile_phase(torch, "inception", trained["batch"])
        train_profile_phase(torch, "densenet", DENSENET_BATCH)

    def entry(name, source, replaces, launches, err, t):
        return {"name": name, "route": "cuda",
                "source": f"flexflow_tpu_torch/csrc/{source}",
                "replaces": replaces, "launches": launches,
                "max_abs_err": err, "ms": t["ms"], "plain_ms": t["plain_ms"],
                "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
                "library_ms": t["library_ms"]}

    # kernels 1-6: launches from the LM training run, times in float32
    # at the serving shape (kernel 1) and the LM training shapes
    lm_n = lm_run["launches"]
    entries = [entry(fa.NAME, fa.SOURCE,
                     "flexflow_tpu/ops/pallas/flash_attention.py:62",
                     lm_n[fa.NAME], checked["max_abs_err"],
                     checked["timings"]["float32"])]
    for name, line in ((fa.NAME_DKV, 158), (fa.NAME_DQ, 190)):
        entries.append(entry(
            name, fa.SOURCE_BWD,
            f"flexflow_tpu/ops/pallas/flash_attention.py:{line}",
            lm_n[name], flash_bwd["worst"][name],
            flash_bwd["timings"][name]))
    for name, line in ((ce.NAME_FWD, 39), (ce.NAME_DX, 127),
                       (ce.NAME_DW, 147)):
        entries.append(entry(name, ce.SOURCE,
                             f"flexflow_tpu/ops/pallas/fused_ce.py:{line}",
                             lm_n[name], fused["worst"][name],
                             fused["timings"][name]))
    # pool times: the sum over one training step's four max-pool
    # launches, and the one avg-pool launch, bfloat16 at batch 256
    for name, source, replaces, timing in (
            (mp.NAME_BWD, mp.SOURCE, "flexflow_tpu/ops/pallas/maxpool.py:139",
             pools["max_step"]["bwd"]),
            (ap.NAME, ap.SOURCE, "flexflow_tpu/ops/pallas/avgpool.py:59",
             pools["avg"]),
            (mp.NAME_FWD, mp.SOURCE, "flexflow_tpu/ops/pallas/maxpool.py:249",
             pools["max_step"]["fwd"])):
        entries.append(entry(name, source, replaces,
                             trained["launches"].get(name, 0),
                             pools["worst"][name],
                             dict(timing, bound_by="bytes")))
    # kernels 9-10: launches from the DenseNet run, times summed over one
    # DenseNet step's 117 BNs, bfloat16 at batch 64
    for name in (bn.NAME_FWD, bn.NAME_BWD, bn.NAME_SUM):
        line = 60 if name == bn.NAME_FWD else 67
        entries.append(entry(name, bn.SOURCE,
                             f"flexflow_tpu/ops/pallas/bn_act.py:{line}",
                             dense["launches"][name], bns["worst"][name],
                             dict(bns["step"][name], bound_by="bytes")))
    print(json.dumps({"kernels": entries}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
