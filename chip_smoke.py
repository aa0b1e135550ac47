#!/usr/bin/env python3
"""Chip smoke of the PyTorch port: builds its CUDA kernels, holds each one
against its plain PyTorch version on the card, drives each ported path at
full width through its entry point — the GPT served by ``apps.serve``,
the GPT and its mixture-of-experts form trained by ``apps.lm``,
Inception-v3, DenseNet-121, ResNet-101 and VGG-16 trained by
``apps.cnn``, and the NMT seq2seq model trained by ``apps.nmt`` — and
checks that each path ran through its kernels.

    python3 chip_smoke.py              # the smoke (one GPU)
    python3 chip_smoke.py --profile    # plus torch.profiler breakdowns of
                                       # one decode step and one training
                                       # step of each trained model

Phases (any failure exits non-zero):

1. CUDA present, card name and power limit (nvidia-smi);
2. build every kernel from ``flexflow_tpu_torch/csrc/`` (one nvcc per
   source, all started together) and print the build seconds, then each
   kernel's registers and spills from ptxas (kernels 1-4 and the pool
   kernels 7-8 must spill nothing), the dynamic shared memory of kernels
   1-4, and the tensor-core (HMMA) instructions of each instance of
   kernels 2-3 in ``cuobjdump -sass`` of their library (each must have
   some);
3. flash kernel phase: flash_attention_fwd against its plain version at
   the serving shape (8, 12, 512, 64) causal in float32 and bfloat16, a
   ragged S = 77, a non-causal case, head dim 128 (causal and ragged, in
   both dtypes) and an empty K; then its time, the plain version's and
   ``scaled_dot_product_attention``'s (a yardstick the port never calls)
   at the serving shape, and its time at head dim 128;
4. flash backward phase: kernels 2 (dk, dv) and 3 (dq) against the
   plain backward at the LM training shape (16, 12, 512, 64) causal, a
   ragged non-causal cross case (Sq 77, Sk 300), head dim 128 causal at
   (4, 16, 512, 128) and ragged (Sq 77 causal; Sq 77, Sk 300), each in
   float32 and bfloat16; that two calls give the same bits; then their
   times at the LM shape and at (4, 16, 512, 128) beside the plain
   backward's and the backward of ``scaled_dot_product_attention`` (a
   yardstick the port never calls);
5. fused cross-entropy phase: kernels 4 (forward, then its finishing
   combine over the vocab slices), 5 (dx, then its finishing sum over
   the vocab slices) and 6 (dw, db) against their plain versions at the LM head's N = 8192, d = 768, V = 32768 in
   float32 and bfloat16, at GPT-2's V = 50257, labels with -1 (no
   target) included, and at the NMT head's N = 640, d = 2048, V = 20480
   in float32; then, at the first three and at the NMT head's d and V
   for N = 640 to 10240 tokens, their times and achieved TFLOP/s beside
   the plain versions' and the unfused library pair's (``x @ w + b``,
   then ``F.cross_entropy``, forward and backward), and at the NMT
   head's the ratio of the two: where the fused head's crossover lies;
6. pool kernel phase: the max-pool forward and backward (kernel 7) at
   Inception's four max-pool geometries at N = 256, DenseNet's and
   ResNet-101's pool1 (64 x 112 x 112 x 64, pad 1) and VGG-16's five
   2x2/2 pools at N = 64 in bfloat16 and float32, tie-heavy integer
   inputs, a pad-1 and a 2x2 geometry; the avg-pool backward (kernel 8)
   at the 8x8x2048 global tail, DenseNet's three 2x2/2 transitions and
   7x7 global pool and ResNet-101's 7x7x2048 global pool; each kernel's
   scalar instance (C = 5,
   and dy a channel slice at an odd offset, which admits no 16-byte
   access) beside its 16-byte one; all against their plain versions,
   exactly, and each called twice for the same bits; then, at every
   geometry of the two training paths in bfloat16, kernel, plain and
   library-yardstick times (``max_pool2d_with_indices`` and its
   backward, ``avg_pool2d_backward``, which the port never calls) beside
   the byte bound;
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
   kernels 1, 2 and 3 and one each of kernels 4, 4's combine, 5, 5's sum
   and 6, and the first 3
   losses within 1e-4 (relative) of the same run with every kernel
   swapped for its plain version; tokens/s, step ms and peak memory;
10. LM training slice at the widths of the JAX package's ``gpt-1.3b``
    preset (``flexflow_tpu/models/gpt.py``: 24 layers, d_model 2048, 16
    heads of 128, d_ff 8192, vocab 32768, batch 16, seq 512; 1.34 B
    parameters), float32, plain SGD at lr 1e-3, 1 warm-up and 2 timed
    steps: finite losses, per step 24 launches each of kernels 1, 2 and 3
    and one each of kernels 4-6 and their finishing passes, and the first
    2 losses within 1e-4 (relative) of the same run with every kernel
    swapped for its plain version; tokens/s, step ms and peak memory;
11. Inception training slice: ``apps.cnn inception`` at bench.py's
    protocol (batch 256, 299x299, bfloat16 compute, float32 params, lr
    0.01, wd 1e-4, momentum 0, seeded random data) for 3 warm-up and 10
    timed steps: finite losses, 4 max-pool and 1 avg-pool kernel launches
    per step, and the first 3 losses within 2e-2 of the same run with the
    plain pools; images/s, step ms and peak memory;
12. DenseNet training slice: ``apps.cnn densenet`` at full width and
    depth (batch 64, 224x224, bfloat16 compute, float32 params, the same
    protocol) for 3 warm-up and 10 timed steps: finite losses, per step
    117 launches each of kernel 9, kernel 10 and its finishing sum, one
    max-pool forward and backward and 4 avg-pool backward launches; the
    first loss equal to the run with kernels 7-10 swapped for their plain
    versions and the next two within 1e-3 (relative) of it; images/s,
    step ms and peak memory;
13. ResNet-101 training slice: ``apps.cnn resnet101`` (the reference's
    topology: no BN, no residual add) at DenseNet's protocol (batch 64,
    224x224, bfloat16 compute, float32 params) for 3 warm-up and 10 timed
    steps: finite losses, per step one launch each of the max-pool
    forward, its backward and the avg-pool backward; the first 3 losses,
    and the ``linear1`` kernel and bias after 3 steps, within 2e-2 of the
    run with kernels 7-10 swapped for their plain versions; images/s,
    step ms and peak memory;
14. VGG-16 training slice: ``apps.cnn vgg16``, the same protocol: per
    step 5 max-pool forward and 5 backward launches and no other kernel;
    the first 3 losses and the ``linear3`` leaves as for ResNet-101;
15. NMT training slice: ``apps.nmt`` at the JAX app's defaults (batch
    64, 2 layers, seq 20 in chunks of 10, hidden and embed 2048, vocab
    20480, float32, plain SGD at lr 0.1) for 3 warm-up and 10 timed
    steps: finite losses, the first within 3 % of ln 20480, per step 2
    launches (one per decoder chunk) each of kernels 4, 4's combine, 5,
    5's sum and 6, and the first 3 losses within 1e-4 (relative) of the
    same run with every kernel swapped for its plain version;
    sentences/s, step ms and peak memory;
16. MoE training slice and the training runtime: ``apps.lm --experts 8``
    at the LM run's widths (8 experts in every block, top-2, capacity
    factor 2.0, aux weight 1e-2, float32, plain SGD at lr 1e-3) with
    ``--ckpt-dir --ckpt-freq 5 --on-divergence rollback``, 3 warm-up and
    10 timed steps: finite losses, the first near ln 32768 + 0.12, the
    launches of the LM run (the experts' products are cuBLAS's), the
    first 3 losses within 1e-4 (relative) of the plain-kernel run;
    tokens/s, the checkpoint seconds, peak memory; 10 steps timed one by
    one by CUDA events, each with the aux loss and the share of (token,
    choice) pairs dropped at capacity; then a run resumed from the
    step-5 checkpoint, its batches through the prefetcher (depth 2),
    repeats steps 6-13 within 1e-6; ``--fault-spec loss_nan@7,
    ckpt_corrupt@3`` rolls back from step 10 to step 5 and finishes 13
    steps, and the restore falls back past the corrupted step 13 to 10;
17. (``--profile``) where the device time of one decode step and of one
    training step of each trained model goes, and the device's idle
    share of each step, from the profiler's kernel rows and, without the
    profiler, from the step's time held behind a sleep kernel;
18. a ``kernels`` JSON line, then, last, the ``ok`` JSON line.

Each phase logs its seconds, and the script its total.

Times come from CUDA events over repeated launches after a warm-up; a
kernel's launches are enqueued behind a sleep kernel, so its time is the
device's even where launching it costs the host more (steps are timed
without the sleep, at the host's pace).  ``bound_ms`` is the larger of the bytes a call must move (each input read
once, each output written once) at 3.35 TB/s and its FLOPs at the peak
for the input type: 67 TFLOP/s float32 outside the tensor cores, 989
TFLOP/s bfloat16 — the H100 SXM data-sheet rates at 700 W.  Kernels 1-6
run a float32 product as three TF32 tensor-core products
(3xTF32, float32's accuracy from TF32's rate), so their float32 bound is
three times the FLOPs at 495 TFLOP/s: a rate they can reach, where 67
TFLOP/s would understate what the card can do for them.  The finishing
passes of kernels 4 and 5 are bound by bytes.  The pools
and the BN kernels do a few compares, multiplies or adds per byte, so
bytes bound them.  A flash backward kernel counts 8 (dk, dv) or 6 (dq) x
d FLOPs per unmasked (query, key) pair; a fused cross-entropy kernel
2 N d V (forward) or 4 N d V (the logits recomputed, then one product).
"""

from __future__ import annotations

import contextlib
import json
import math
import re
import subprocess
import sys
import time
from pathlib import Path

HBM_BYTES_PER_S = 3.35e12
# cycles per second the timing's sleep kernel is sized with: at least the
# H100 SXM's top SM clock (1.98 GHz), so the sleep lasts as long as asked
SLEEP_HZ = 2.0e9
# float32 outside the tensor cores, bfloat16 on them, and float32
# products run as three TF32 products (3xTF32) at 495 TFLOP/s
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12, "3xtf32": 495e12 / 3}
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
# the GPT-1.3B widths (flexflow_tpu/models/gpt.py "1.3b"): layers,
# d_model, heads, d_ff; its steps take about a second each
LM13_WIDTHS = (24, 2048, 16, 8192)
LM13_WARMUP, LM13_TIMED, LM13_CHECKED = 1, 2, 2
BWD_WIDE_SHAPE = (4, 16, 512, 128)      # kernels 2-3 at its head dim
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
# DenseNet-121's pool inputs at batch 64: pool1 (3x3 stride 2 pad 1,
# fused ReLU), and the avg pools (h, w, c, window: the 2x2/2 transitions
# and the 7x7 global pool, no ReLU)
DENSENET_MAX_POOL = (112, 112, 64)
DENSENET_AVG_POOLS = [(56, 56, 128, 2), (28, 28, 256, 2), (14, 14, 512, 2),
                      (7, 7, 1024, 7)]
TRAIN_WARMUP, TRAIN_TIMED, TRAIN_CHECKED = 3, 10, 3
# ResNet-101 and VGG-16 train at batch 64 (the JAX FFConfig default),
# 224x224; ResNet's pool1 input is DenseNet's (112x112x64, 3x3/2 pad 1)
RESNET_VGG_BATCH = 64
RESNET_AVG_POOL = (7, 7, 2048)
# VGG-16's five 2x2/2 max-pool inputs (fused ReLU)
VGG_MAX_POOLS = [(224, 224, 64), (112, 112, 128), (56, 56, 256),
                 (28, 28, 512), (14, 14, 512)]
# the classifier whose leaves the kernel and plain-pool runs compare
CNN_HEAD = {"resnet101": "linear1", "vgg16": "linear3"}
# the NMT run: the JAX app's defaults (batch 64, 2 layers, seq 20 in
# chunks of 10, hidden and embed 2048, vocab 20480, float32, SGD lr 0.1)
NMT_WIDTHS = (64, 2, 20, 2048, 2048)   # batch, layers, seq, hidden, embed
NMT_VOCAB = 20480
NMT_CHUNKS = 2                          # decoder chunks: vocab heads a step
NMT_HEAD = (64 * 10, 2048, NMT_VOCAB)   # N, d, V of one chunk's vocab head
# token counts of the fused head's crossover sweep at the NMT head's d, V
CE_CROSSOVER_TOKENS = (640, 1280, 2560, 5120, 10240)
# the MoE run: the JAX app's MoE example (flexflow_tpu/apps/lm.py:10) at
# the LM run's GPT-2-small widths, 8 experts in every block, top-2,
# capacity factor 2.0 (256 slots per expert and sequence), aux weight
# 1e-2, checkpoints every 5 steps, rollback on divergence
MOE_EXPERTS = 8
MOE_CKPT_FREQ = 5
# the resumed run's losses against the uninterrupted run's: the same
# kernels on the same restored leaves and batches
MOE_RESUME_RTOL = 1e-6
# the divergence run: a NaN loss at step 7 rolls back to step 5 at the
# step-10 boundary; the third save (step 13, the last) is corrupted
MOE_FAULTS = "loss_nan@7,ckpt_corrupt@3"
# checkpoints of the MoE phase (2.1 GB a step), inside the checkout and
# removed when the phase ends
MOE_CKPT_ROOT = Path(__file__).resolve().parent / ".chip_ckpt"
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
    """(bound_ms, bound_by) of one flash forward call; float32 products
    at the 3xTF32 rate the kernel runs them at."""
    b, h, sq, d = shape
    esize = 2 if dtype == "bfloat16" else 4
    if causal:
        scores = sum(min(i + 1, sk) for i in range(sq))
    else:
        scores = sq * sk
    flops = 4.0 * d * b * h * scores
    nbytes = (b * h * sq * d + 2 * b * h * sk * d) * esize \
        + b * h * sq * d * 4 + b * h * sq * 4
    return _bound(flops, nbytes, "3xtf32" if dtype == "float32" else dtype)


def _template_args(mangled: str) -> list:
    """The template arguments mangled at the start of ``mangled``
    (``I...E``): type names, and the values of integer literals."""
    builtin = {"f": "float32", "h": "uint8", "i": "int", "b": "bool"}
    args, j = [], 1
    while j < len(mangled) and mangled[j] != "E":
        lit = re.match(r"L[a-z](n?\d+)E", mangled[j:])
        named = re.match(r"\d+", mangled[j:])
        if lit:
            args.append(lit.group(1).replace("n", "-"))
            j += lit.end()
        elif named:
            start = j + named.end()
            args.append(mangled[start:start + int(named.group())])
            j = start + int(named.group())
        else:
            args.append(builtin.get(mangled[j], mangled[j]))
            j += 1
    return [a.replace("__nv_bfloat16", "bfloat16") for a in args]


def _kernel_name(mangled: str) -> str:
    """A kernel's function name and template arguments from its mangled
    name (the ``<length><name>`` run that ends in ``_kernel``)."""
    # every digit run, and every tail of it: a length may follow digits
    for m in re.finditer(r"\d+", mangled):
        for i in range(m.start(), m.end()):
            name = mangled[m.end():m.end() + int(mangled[i:m.end()])]
            if not name.endswith("_kernel"):
                continue
            rest = mangled[m.end() + len(name):]
            if not rest.startswith("I"):
                return name
            return f"{name}<{', '.join(_template_args(rest))}>"
    return mangled


def _ptxas_report(log: str) -> list:
    """``(kernel, registers, "stores/loads")`` per kernel of an
    ``nvcc -Xptxas -v`` log, spills in bytes."""
    out, kernel, spills = [], None, "?"
    for line in log.splitlines():
        entry = re.search(r"Compiling entry function '(\S+)'", line)
        if entry:
            kernel = _kernel_name(entry.group(1))
            continue
        spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                          r"loads", line)
        if spill:
            spills = f"{spill.group(1)}/{spill.group(2)}"
        regs = re.search(r"Used (\d+) registers", line)
        if regs and kernel:
            out.append((kernel, int(regs.group(1)), spills))
            kernel, spills = None, "?"
    return out


def _sass_hmma(path) -> dict:
    """Tensor-core (HMMA) instructions per kernel of a built library, from
    ``cuobjdump -sass``."""
    from flexflow_tpu_torch.ops import kernels

    tool = str(Path(kernels._nvcc()).with_name("cuobjdump"))
    sass = subprocess.run([tool, "-sass", str(path)], capture_output=True,
                          text=True, check=True).stdout
    counts, kernel = {}, None
    for line in sass.splitlines():
        fn = re.search(r"Function : (\S+)", line)
        if fn:
            kernel = _kernel_name(fn.group(1))
            counts[kernel] = 0
        elif kernel and re.search(r"\bHMMA\b", line):
            counts[kernel] += 1
    return counts


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
        ("d=128 causal float32", (2, h, s, 128), s, True, "float32"),
        ("d=128 causal bfloat16", (2, h, s, 128), s, True, "bfloat16"),
        ("d=128 ragged S=77 causal float32", (2, h, 77, 128), 77, True,
         "float32"),
        ("d=128 ragged S=77 causal bfloat16", (2, h, 77, 128), 77, True,
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
        wide = (2, h, s, 128)
        q, k, v = qkv(wide, s, dtype)
        ms = _time_ms(torch, lambda: fa.flash_attention_fwd_cuda(q, k, v,
                                                                 True))
        sdpa_ms = _time_ms(torch, lambda: torch.nn.functional
                           .scaled_dot_product_attention(q, k, v,
                                                         is_causal=True))
        bound_ms, bound_by = _bound_ms(wide, s, True, dtype)
        _log(f"kernel time {wide} causal {dtype}: kernel {ms:.4f} ms, sdpa "
             f"{sdpa_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by})")
    return {"max_abs_err": worst, "timings": timings}


def _rel_err(torch, got, ref) -> tuple:
    """(max |got - ref|, that over max |ref|)."""
    err = float((got.float() - ref.float()).abs().max())
    scale = float(ref.float().abs().max())
    return err, err / max(scale, 1e-30)


def _bwd_bounds(shape, dtype) -> dict:
    """(bound_ms, bound_by) of kernels 2 (dk, dv: 8 d FLOPs per unmasked
    pair) and 3 (dq: 6 d) on one causal (B, H, S, S) self-attention call;
    float32 products at the 3xTF32 rate the kernels run them at."""
    b, h, s, d = shape
    pairs = b * h * s * (s + 1) // 2
    io = b * h * s * d * (2 if dtype == "bfloat16" else 4)  # one input
    out = b * h * s * d * 4         # one float32 gradient
    rows = b * h * s * 4            # lse or delta
    rate = "3xtf32" if dtype == "float32" else dtype
    return {"dkv": _bound(8.0 * d * pairs, 4 * io + 2 * out + 2 * rows,
                          rate),
            "dq": _bound(6.0 * d * pairs, 4 * io + out + 2 * rows, rate)}


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
    wide = BWD_WIDE_SHAPE
    cases = []
    for dtype in ("float32", "bfloat16"):
        cases += [(f"LM causal {dtype}", LM_SHAPE, s, True, dtype),
                  (f"non-causal Sq=77 Sk=300 {dtype}", (2, h, 77, d), 300,
                   False, dtype),
                  (f"d=128 {wide} causal {dtype}", wide, s, True, dtype),
                  (f"d=128 ragged S=77 causal {dtype}", (2, 16, 77, 128), 77,
                   True, dtype),
                  (f"d=128 non-causal Sq=77 Sk=300 {dtype}",
                   (2, 16, 77, 128), 300, False, dtype)]
    worst = {fa.NAME_DKV: 0.0, fa.NAME_DQ: 0.0}
    for label, shape, sk, causal, dtype in cases:
        q, k, v, o, lse, do = inputs(shape, sk, causal, dtype)
        got = fa.flash_attention_bwd_cuda(q, k, v, o, lse, do, causal)
        again = fa.flash_attention_bwd_cuda(q, k, v, o, lse, do, causal)
        torch.cuda.synchronize()
        if not all(torch.equal(a, c) for a, c in zip(got, again)):
            raise AssertionError(f"{label}: two calls of the flash backward "
                                 f"kernels gave different bits")
        want = fa.flash_attention_bwd_plain(q, k, v, o, lse, do, causal)
        torch.cuda.synchronize()
        errs = {n: _rel_err(torch, g, w)
                for n, g, w in zip(("dq", "dk", "dv"), got, want)}
        _log(f"flash bwd check {label}: " + ", ".join(
            f"{n} max_abs_err {e:.3e} ({r:.2e} of max)"
            for n, (e, r) in errs.items())
             + f" (tolerance {GRAD_RTOL[dtype]:g} of max; two calls give "
               f"the same bits)")
        if not all(r <= GRAD_RTOL[dtype] for _, r in errs.values()):
            raise AssertionError(f"{label}: flash backward kernels disagree "
                                 f"with the plain version: {errs}")
        worst[fa.NAME_DQ] = max(worst[fa.NAME_DQ], errs["dq"][0])
        worst[fa.NAME_DKV] = max(worst[fa.NAME_DKV], errs["dk"][0],
                                 errs["dv"][0])

    # times at the LM training shape in float32, the path's dtype, then at
    # head dim 128 in both dtypes
    timings = {}
    for shape, dtype in ((LM_SHAPE, "float32"), (wide, "float32"),
                         (wide, "bfloat16")):
        q, k, v, o, lse, do = inputs(shape, shape[2], True, dtype)
        delta = (do * o).sum(-1)
        do_k = do.to(q.dtype)
        dkv_ms = _time_ms(torch, lambda: fa.flash_attention_bwd_dkv_cuda(
            q, k, v, do_k, lse, delta, True), iters=20)
        dq_ms = _time_ms(torch, lambda: fa.flash_attention_bwd_dq_cuda(
            q, k, v, do_k, lse, delta, True), iters=20)
        plain_ms = _time_ms(torch, lambda: fa.flash_attention_bwd_plain(
            q, k, v, o, lse, do, True), iters=10)
        qs, ks, vs = (t.detach().clone().requires_grad_() for t in (q, k, v))
        out = torch.nn.functional.scaled_dot_product_attention(
            qs, ks, vs, is_causal=True)
        sdpa_ms = _time_ms(torch, lambda: torch.autograd.grad(
            out, (qs, ks, vs), do_k, retain_graph=True), iters=20)
        bounds = _bwd_bounds(shape, dtype)
        t = {fa.NAME_DKV: dict(ms=dkv_ms, plain_ms=plain_ms,
                               library_ms=sdpa_ms),
             fa.NAME_DQ: dict(ms=dq_ms, plain_ms=plain_ms,
                              library_ms=sdpa_ms)}
        for name, key in ((fa.NAME_DKV, "dkv"), (fa.NAME_DQ, "dq")):
            t[name]["bound_ms"], t[name]["bound_by"] = bounds[key]
            _log(f"flash bwd time {name} {shape} causal {dtype}: kernel "
                 f"{t[name]['ms']:.4f} ms, bound {t[name]['bound_ms']:.4f} "
                 f"ms ({t[name]['bound_by']})")
        _log(f"flash bwd time {shape} causal {dtype}: kernels 2+3 "
             f"{dkv_ms + dq_ms:.4f} ms, plain backward {plain_ms:.4f} ms, "
             f"sdpa backward {sdpa_ms:.4f} ms (dq, dk and dv each)")
        if shape == LM_SHAPE:
            timings = t
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
    gpt2 = CE_SHAPE[:2] + (GPT2_VOCAB,)
    worst = {ce.NAME_FWD: 0.0, ce.NAME_FWD_COMBINE: 0.0, ce.NAME_DX: 0.0,
             ce.NAME_DX_SUM: 0.0, ce.NAME_DW: 0.0}
    for label, (n, d, vocab), dtype in (
            ("LM head float32", CE_SHAPE, "float32"),
            ("LM head bfloat16", CE_SHAPE, "bfloat16"),
            (f"GPT-2 vocab {GPT2_VOCAB} float32", gpt2, "float32"),
            ("NMT head float32", NMT_HEAD, "float32")):
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
        worst[ce.NAME_FWD_COMBINE] = worst[ce.NAME_FWD]
        worst[ce.NAME_DX] = max(worst[ce.NAME_DX], errs["dx"][0])
        worst[ce.NAME_DX_SUM] = worst[ce.NAME_DX]
        worst[ce.NAME_DW] = max(worst[ce.NAME_DW], errs["dw"][0],
                                errs["db"][0])
        del x, w, b, lab, g, nll, lse, dx, dw, db, nll_p, lse_p, grads_p
        torch.cuda.empty_cache()

    # times: the LM head in float32 (the path's dtype) and bfloat16,
    # GPT-2's vocab in float32, and the NMT head's d and V in float32 at
    # the NMT's 640 tokens a chunk and more, against the unfused library
    # pair: where the fused head stops losing, if it loses at 640.  The
    # kernels line takes the first
    timings = {}
    _, d_nmt, v_nmt = NMT_HEAD
    for label, (n, d, vocab), dtype in (
            ("float32", CE_SHAPE, "float32"),
            ("bfloat16", CE_SHAPE, "bfloat16"),
            (f"V {GPT2_VOCAB} float32", gpt2, "float32"),
            *((f"NMT head at N {n} float32", (n, d_nmt, v_nmt), "float32")
              for n in CE_CROSSOVER_TOKENS)):
        t = _fused_ce_times(torch, F, ce, gen, n, d, vocab, dtype)
        timings.setdefault("lm", t)
        for name, r in t.items():
            _log(f"fused ce time {name} N {n} d {d} V {vocab} {dtype}: "
                 f"kernel {r['ms']:.4f} ms ({r['tflops']:.1f} TFLOP/s), "
                 f"plain {r['plain_ms']:.4f} ms, library "
                 f"{r['library_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms "
                 f"({r['bound_by']}, {r['bound_ms'] / r['ms']:.1%} of it)")
        pair = t[ce.NAME_DX]["ms"] + t[ce.NAME_DX_SUM]["ms"] \
            + t[ce.NAME_DW]["ms"]
        fwd = t[ce.NAME_FWD]["ms"] + t[ce.NAME_FWD_COMBINE]["ms"]
        _log(f"fused ce time {label} V {vocab}: backward kernels 5 + its "
             f"sum + 6 {pair:.4f} ms, bounds 5 + 6 "
             f"{t[ce.NAME_DX]['bound_ms'] + t[ce.NAME_DW]['bound_ms']:.4f} "
             f"ms, plain backward {t[ce.NAME_DX]['plain_ms']:.4f} ms, "
             f"library pair backward {t[ce.NAME_DX]['library_ms']:.4f} ms; "
             f"kernel 4 + its combine {fwd:.4f} ms; kernels 4-6 "
             f"{pair + fwd:.4f} ms, library "
             f"pair forward + backward {t[ce.NAME_DX]['library_ms'] + t[ce.NAME_FWD]['library_ms']:.4f} ms")
        if label.startswith("NMT"):
            lib = t[ce.NAME_DX]["library_ms"] + t[ce.NAME_FWD]["library_ms"]
            _log(f"fused ce crossover N {n} d {d} V {vocab} float32: "
                 f"kernels 4-6 / library pair = {(pair + fwd) / lib:.3f}")
        torch.cuda.empty_cache()
    return {"worst": worst, "timings": timings["lm"]}


def _fused_ce_times(torch, F, ce, gen, n, d, v, dtype) -> dict:
    """Kernels 4 (with its combine), 5 (with its finishing sum) and 6 at
    one shape: times, plain and library times, bounds and achieved
    TFLOP/s."""
    x, w, b, lab, g = _ce_inputs(torch, gen, n, d, v, dtype)
    fwd_work = ce.fused_linear_ce_fwd_partial_cuda(x, w, b, lab)
    nll, lse = ce.fused_linear_ce_fwd_combine_cuda(fwd_work)
    work = ce.fused_linear_ce_bwd_dx_partial_cuda(x, w, b, lab, lse, g)
    fwd_ms = _time_ms(torch, lambda: ce.fused_linear_ce_fwd_partial_cuda(
        x, w, b, lab), iters=5, warmup=1)
    combine_ms = _time_ms(torch, lambda: ce.fused_linear_ce_fwd_combine_cuda(
        fwd_work), iters=20)
    dx_ms = _time_ms(torch, lambda: ce.fused_linear_ce_bwd_dx_partial_cuda(
        x, w, b, lab, lse, g), iters=5, warmup=1)
    sum_ms = _time_ms(torch, lambda: ce.fused_linear_ce_bwd_dx_sum_cuda(
        work, n, d), iters=20)
    dw_ms = _time_ms(torch, lambda: ce.fused_linear_ce_bwd_dw_cuda(
        x, w, b, lab, lse, g), iters=5, warmup=1)
    plain_fwd_ms = _time_ms(torch, lambda: ce.fused_linear_ce_fwd_plain(
        x, w, b, lab), iters=5, warmup=1)
    plain_bwd_ms = _time_ms(torch, lambda: ce.fused_linear_ce_bwd_plain(
        x, w, b, lab, lse, g), iters=5, warmup=1)
    lab64 = lab.long()

    def lib_fwd(xs, ws, bs):
        return F.cross_entropy(torch.addmm(bs.to(xs.dtype), xs, ws), lab64,
                               ignore_index=-1, reduction="none")

    lib_fwd_ms = _time_ms(torch, lambda: lib_fwd(x, w, b), iters=5,
                          warmup=1)
    xs, ws, bs = (t.detach().clone().requires_grad_() for t in (x, w, b))
    lib_nll = lib_fwd(xs, ws, bs)
    lib_bwd_ms = _time_ms(torch, lambda: torch.autograd.grad(
        lib_nll, (xs, ws, bs), g.to(lib_nll.dtype), retain_graph=True),
        iters=5, warmup=1)
    esize = x.element_size()
    inputs = n * d * esize + d * v * esize + v * 4 + n * 4
    flops = 2.0 * n * d * v
    # float32 products of kernels 4-6 run as three TF32 products each
    mma_rate = "3xtf32" if dtype == "float32" else dtype
    out = {}
    for name, ms, fl, nbytes, rate, plain, lib in (
            (ce.NAME_FWD, fwd_ms, flops, inputs + fwd_work.numel() * 4,
             mma_rate, plain_fwd_ms, lib_fwd_ms),
            (ce.NAME_FWD_COMBINE, combine_ms, 4.0 * fwd_work.numel(),
             fwd_work.numel() * 4 + 2 * n * 4, "float32", plain_fwd_ms,
             lib_fwd_ms),
            (ce.NAME_DX, dx_ms, 2 * flops,
             inputs + 2 * n * 4 + work.numel() * 4, mma_rate, plain_bwd_ms,
             lib_bwd_ms),
            (ce.NAME_DX_SUM, sum_ms, (work.shape[0] - 1.0) * n * d,
             work.numel() * 4 + n * d * 4, "float32", plain_bwd_ms,
             lib_bwd_ms),
            (ce.NAME_DW, dw_ms, 2 * flops,
             inputs + 2 * n * 4 + d * v * 4 + v * 4, mma_rate, plain_bwd_ms,
             lib_bwd_ms)):
        bound_ms, bound_by = _bound(fl, nbytes, rate)
        out[name] = dict(ms=ms, plain_ms=plain, library_ms=lib,
                         bound_ms=bound_ms, bound_by=bound_by,
                         tflops=fl / ms / 1e9)
    _log(f"fused ce time N {n} d {d} V {v} {dtype}: forward over "
         f"{fwd_work.shape[0]} vocab slices (S = fwd_splits), workspace "
         f"{tuple(fwd_work.shape)}; dx over {work.shape[0]} vocab slices, "
         f"workspace {tuple(work.shape)}")
    return out


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


def _vec_of(kernels, t) -> int:
    """The channels a pool kernel's thread takes for NHWC ``t``, as the
    wrappers pick them (every other plane they touch is a fresh
    allocation, so ``t`` decides)."""
    isz = t.element_size()
    return kernels.vec_width(t.shape[3], isz, t.stride()[:3],
                             [(t.data_ptr(), isz)])


def _pool_dy(torch, gen, shape, dtype, offset):
    """dy of ``shape``: contiguous, or (``offset`` not None) the channel
    slice at ``offset`` of a tensor 8 channels wider, as a concat's
    backward hands it over."""
    if offset is None:
        return torch.randn(shape, generator=gen, device="cuda").to(dtype)
    n, oh, ow, c = shape
    wide = torch.randn((n, oh, ow, c + 8), generator=gen,
                       device="cuda").to(dtype)
    return wide[..., offset:offset + c]


def _maxpool_case(torch, mp, gen, shape, k, p, relu, dtype, ties,
                  offset=None):
    """Kernel 7 and its forward against the plain versions, each called
    twice: (x, y, sel, dy, fwd error, sel mismatches, bwd error, whether
    the second calls gave the same bits)."""
    n, h, w, c = shape
    if ties:
        x = torch.randint(-3, 4, shape, generator=gen, device="cuda")
    else:
        x = torch.randn(shape, generator=gen, device="cuda")
    x = x.to(getattr(torch, dtype))
    y, sel = mp.maxpool_fwd_cuda(x, k, p, relu)
    y2, sel2 = mp.maxpool_fwd_cuda(x, k, p, relu)
    y_p, sel_p = mp.maxpool_fwd_plain(x, k, p, relu)
    dy = _pool_dy(torch, gen, y.shape, x.dtype, offset)
    dx = mp.maxpool_bwd_cuda(dy, sel, h, w, k, p)
    dx2 = mp.maxpool_bwd_cuda(dy, sel, h, w, k, p)
    dx_p = mp.maxpool_bwd_plain(dy.contiguous(), sel, h, w, k, p)
    torch.cuda.synchronize()
    err_fwd = float((y.float() - y_p.float()).abs().max())
    sel_bad = int((sel != sel_p).sum())
    err_bwd = float((dx.float() - dx_p.float()).abs().max())
    same = (torch.equal(y, y2) and torch.equal(sel, sel2)
            and torch.equal(dx, dx2))
    return x, y, sel, dy, err_fwd, sel_bad, err_bwd, same


def _avgpool_case(torch, ap, gen, shape, kh, relu, dtype, offset=None):
    """Kernel 8 against its plain version, called twice: (x, dy, error,
    whether the second call gave the same bits)."""
    x = torch.randn(shape, generator=gen, device="cuda").to(
        getattr(torch, dtype))
    y = ap.avgpool_fwd(x, kh, kh, relu)
    dy = _pool_dy(torch, gen, y.shape, x.dtype, offset)
    mask = y if relu else None
    dx = ap.avgpool_bwd_cuda(dy, mask, kh, kh)
    dx2 = ap.avgpool_bwd_cuda(dy, mask, kh, kh)
    dx_p = ap.avgpool_bwd_plain(dy.contiguous(), mask, kh, kh)
    torch.cuda.synchronize()
    err = float((dx.float() - dx_p.float()).abs().max())
    return x, dy, err, torch.equal(dx, dx2)


def _maxpool_times(torch, mp, x, y, sel, dy, k, p) -> dict:
    """Forward and backward times at one geometry: the kernels, the plain
    versions, the library yardstick (``max_pool2d_with_indices`` and its
    backward on the channels-last NCHW views) and the byte bounds."""
    aten = torch.ops.aten
    n, h, w, c = x.shape
    xc, dyc = x.permute(0, 3, 1, 2), dy.permute(0, 3, 1, 2)
    _, idx = aten.max_pool2d_with_indices(xc, [k, k], [2, 2], [p, p])
    nx, ny = x.numel(), y.numel()
    dt = "bfloat16" if x.dtype == torch.bfloat16 else "float32"
    bound = _pool_bytes((dt, nx), (dt, ny), ("uint8", ny)) \
        / HBM_BYTES_PER_S * 1e3
    return {
        "fwd": dict(
            ms=_time_ms(torch, lambda: mp.maxpool_fwd_cuda(x, k, p, True)),
            plain_ms=_time_ms(torch, lambda: mp.maxpool_fwd_plain(
                x, k, p, True), iters=10),
            library_ms=_time_ms(torch, lambda: aten.max_pool2d_with_indices(
                xc, [k, k], [2, 2], [p, p])),
            bound_ms=bound),
        "bwd": dict(
            ms=_time_ms(torch, lambda: mp.maxpool_bwd_cuda(dy, sel, h, w, k,
                                                           p)),
            plain_ms=_time_ms(torch, lambda: mp.maxpool_bwd_plain(
                dy, sel, h, w, k, p), iters=10),
            library_ms=_time_ms(
                torch, lambda: aten.max_pool2d_with_indices_backward(
                    dyc, xc, [k, k], [2, 2], [p, p], [1, 1], False, idx)),
            bound_ms=bound),
    }


def _avgpool_times(torch, ap, x, dy, kh) -> dict:
    """The kernel's, the plain version's and ``avg_pool2d_backward``'s
    times at one geometry, and the byte bound (dy + dx)."""
    aten = torch.ops.aten
    xc, dyc = x.permute(0, 3, 1, 2), dy.permute(0, 3, 1, 2)
    dt = "bfloat16" if x.dtype == torch.bfloat16 else "float32"
    return dict(
        ms=_time_ms(torch, lambda: ap.avgpool_bwd_cuda(dy, None, kh, kh)),
        plain_ms=_time_ms(torch, lambda: ap.avgpool_bwd_plain(dy, None, kh,
                                                              kh), iters=20),
        library_ms=_time_ms(torch, lambda: aten.avg_pool2d_backward(
            dyc, xc, [kh, kh], [kh, kh], [0, 0], False, True, None)),
        bound_ms=_pool_bytes((dt, dy.numel()), (dt, x.numel()))
        / HBM_BYTES_PER_S * 1e3)


def _log_times(what: str, t: dict) -> None:
    _log(f"pool time {what}: kernel {t['ms']:.4f} ms, plain "
         f"{t['plain_ms']:.4f} ms, library {t['library_ms']:.4f} ms, bound "
         f"{t['bound_ms']:.4f} ms (bytes, {t['bound_ms'] / t['ms']:.0%} of "
         f"it reached)")


def pool_kernel_phase(torch, kernels) -> dict:
    """Kernels 7 (with its forward) and 8 against their plain versions,
    both instances of each (16-byte vectors and one channel a thread),
    then their times at every geometry of the training paths."""
    from flexflow_tpu_torch.ops.kernels import avgpool as ap
    from flexflow_tpu_torch.ops.kernels import maxpool as mp

    gen = torch.Generator(device="cuda")
    gen.manual_seed(1)
    h, w, c = DENSENET_MAX_POOL
    dense = (DENSENET_BATCH, h, w, c)
    # (label, shape, k, p, relu, dtype, ties, dy offset, thread's channels)
    cases = [(f"inception {h}x{w}x{c}", (POOL_N, h, w, c), 3, 0, True,
              dtype, ties, None, "vector")
             for (h, w, c) in INCEPTION_MAX_POOLS
             for dtype, ties in (("bfloat16", False), ("float32", False),
                                 ("bfloat16", True))]
    cases += [("densenet and resnet pool1", dense, 3, 1, True, dtype, ties,
               None, "vector")
              for dtype, ties in (("bfloat16", False), ("float32", False),
                                  ("bfloat16", True))]
    cases += [(f"vgg {h}x{w}x{c}", (RESNET_VGG_BATCH, h, w, c), 2, 0, True,
               dtype, ties, None, "vector")
              for (h, w, c) in VGG_MAX_POOLS
              for dtype, ties in (("bfloat16", False), ("float32", False),
                                  ("bfloat16", True))]
    cases += [("pad-1 56x56x64", (POOL_N, 56, 56, 64), 3, 1, True,
               "bfloat16", True, None, "vector"),
              ("pad-1 56x56x64", (POOL_N, 56, 56, 64), 3, 1, False,
               "float32", False, None, "vector"),
              ("2x2 28x28x128", (POOL_N, 28, 28, 128), 2, 0, False,
               "bfloat16", True, None, "vector"),
              ("2x2 28x28x128", (POOL_N, 28, 28, 128), 2, 0, True,
               "float32", False, None, "vector"),
              ("dy slice at channel 8", (32, 37, 37, 64), 3, 0, True,
               "bfloat16", True, 8, "vector"),
              ("C 5", (32, 33, 35, 5), 3, 0, True, "bfloat16", True, None,
               "scalar"),
              ("C 5", (32, 33, 35, 5), 3, 1, False, "float32", False, None,
               "scalar"),
              ("C 5", (32, 20, 21, 5), 2, 0, True, "bfloat16", True, None,
               "scalar"),
              ("dy slice at channel 1", (32, 37, 37, 64), 3, 0, True,
               "bfloat16", True, 1, "scalar"),
              ("dy slice at channel 1", (32, 36, 36, 64), 3, 1, True,
               "float32", False, 1, "scalar")]
    worst = {"maxpool_fwd": 0.0, "maxpool_bwd": 0.0, "avgpool_bwd": 0.0}
    for label, shape, k, p, relu, dtype, ties, offset, inst in cases:
        x, _, _, dy, e_f, bad, e_b, same = _maxpool_case(
            torch, mp, gen, shape, k, p, relu, dtype, ties, offset)
        vecs = (_vec_of(kernels, x), _vec_of(kernels, dy))
        _log(f"pool check max {label} {tuple(shape)} k{k} p{p} relu={relu} "
             f"{dtype}{' ties' if ties else ''}: channels per thread "
             f"fwd {vecs[0]} bwd {vecs[1]}; fwd max_abs_err {e_f:.3e}, sel "
             f"mismatches {bad}, bwd max_abs_err {e_b:.3e} (tolerance "
             f"{POOL_ATOL:g}); second calls same bits {same}")
        if not (e_f <= POOL_ATOL and bad == 0 and e_b <= POOL_ATOL
                and same):
            raise AssertionError(f"max pool {label} {dtype}: kernels "
                                 f"disagree with the plain versions or with "
                                 f"themselves")
        if (vecs[1] == 1) != (inst == "scalar"):
            raise AssertionError(f"max pool {label}: expected the {inst} "
                                 f"instance, the wrappers pick {vecs}")
        worst["maxpool_fwd"] = max(worst["maxpool_fwd"], e_f)
        worst["maxpool_bwd"] = max(worst["maxpool_bwd"], e_b)
        del x, dy
    h, w, c = INCEPTION_AVG_POOL
    avg_cases = [("inception tail", (POOL_N, h, w, c), h, relu, dtype, None,
                  "vector")
                 for relu, dtype in ((False, "bfloat16"), (False, "float32"),
                                     (True, "bfloat16"))]
    avg_cases += [(f"densenet {h}x{w}x{c}", (DENSENET_BATCH, h, w, c), kh,
                   False, "bfloat16", None, "vector")
                  for (h, w, c, kh) in DENSENET_AVG_POOLS]
    h, w, c = RESNET_AVG_POOL
    avg_cases += [("resnet pool2", (RESNET_VGG_BATCH, h, w, c), h, False,
                   dtype, None, "vector")
                  for dtype in ("bfloat16", "float32")]
    avg_cases += [("2x2 relu", (POOL_N, 8, 8, 2048), 2, True, "float32",
                   None, "vector"),
                  ("C 5", (32, 14, 14, 5), 2, True, "bfloat16", None,
                   "scalar"),
                  ("dy slice at channel 1", (POOL_N, 8, 8, 2048), 8, False,
                   "bfloat16", 1, "scalar"),
                  ("dy slice at channel 1", (32, 14, 14, 64), 7, True,
                   "float32", 1, "scalar")]
    for label, shape, kh, relu, dtype, offset, inst in avg_cases:
        _, dy, err, same = _avgpool_case(torch, ap, gen, shape, kh, relu,
                                         dtype, offset)
        vec = _vec_of(kernels, dy)
        _log(f"pool check avg {label} {tuple(shape)} window {kh}x{kh} "
             f"relu={relu} {dtype}: channels per thread {vec}; bwd "
             f"max_abs_err {err:.3e} (tolerance {POOL_ATOL:g}); second call "
             f"same bits {same}")
        if not (err <= POOL_ATOL and same):
            raise AssertionError(f"avg-pool kernel {label}: disagrees with "
                                 f"its plain version or with itself")
        if (vec == 1) != (inst == "scalar"):
            raise AssertionError(f"avg pool {label}: expected the {inst} "
                                 f"instance, the wrapper picks {vec}")
        worst["avgpool_bwd"] = max(worst["avgpool_bwd"], err)

    # times in bfloat16 (the training paths' dtype) at every geometry they
    # launch; inputs of 7-700 MB, so most launches find them cold in L2
    inception = []
    for (h, w, c) in INCEPTION_MAX_POOLS:
        x, y, sel, dy, *_ = _maxpool_case(torch, mp, gen, (POOL_N, h, w, c),
                                          3, 0, True, "bfloat16", False)
        row = _maxpool_times(torch, mp, x, y, sel, dy, 3, 0)
        inception.append(row)
        for part in ("fwd", "bwd"):
            _log_times(f"max {part} inception {POOL_N}x{h}x{w}x{c} 3x3/2 "
                       f"bfloat16", row[part])
        del x, y, sel, dy
    step = {part: {key: sum(r[part][key] for r in inception)
                   for key in ("ms", "plain_ms", "library_ms", "bound_ms")}
            for part in ("fwd", "bwd")}
    for part in ("fwd", "bwd"):
        _log_times(f"max {part}, the 4 launches of one Inception step",
                   step[part])
    x, y, sel, dy, *_ = _maxpool_case(torch, mp, gen, dense, 3, 1, True,
                                      "bfloat16", False)
    row = _maxpool_times(torch, mp, x, y, sel, dy, 3, 1)
    for part in ("fwd", "bwd"):
        _log_times(f"max {part} densenet and resnet pool1 "
                   f"{'x'.join(map(str, dense))} 3x3/2 pad 1 bfloat16",
                   row[part])
    del x, y, sel, dy
    vgg = []
    for (h, w, c) in VGG_MAX_POOLS:
        x, y, sel, dy, *_ = _maxpool_case(
            torch, mp, gen, (RESNET_VGG_BATCH, h, w, c), 2, 0, True,
            "bfloat16", False)
        row = _maxpool_times(torch, mp, x, y, sel, dy, 2, 0)
        vgg.append(row)
        for part in ("fwd", "bwd"):
            _log_times(f"max {part} vgg {RESNET_VGG_BATCH}x{h}x{w}x{c} "
                       f"2x2/2 bfloat16", row[part])
        del x, y, sel, dy
    for part in ("fwd", "bwd"):
        _log_times(f"max {part}, the 5 launches of one VGG-16 step",
                   {key: sum(r[part][key] for r in vgg)
                    for key in ("ms", "plain_ms", "library_ms", "bound_ms")})
    h, w, c = INCEPTION_AVG_POOL
    x, dy, *_ = _avgpool_case(torch, ap, gen, (POOL_N, h, w, c), h, False,
                              "bfloat16")
    avg = _avgpool_times(torch, ap, x, dy, h)
    _log_times(f"avg bwd inception tail {POOL_N}x{h}x{w}x{c} bfloat16", avg)
    for (h, w, c, kh) in DENSENET_AVG_POOLS:
        x, dy, *_ = _avgpool_case(torch, ap, gen, (DENSENET_BATCH, h, w, c),
                                  kh, False, "bfloat16")
        _log_times(f"avg bwd densenet {DENSENET_BATCH}x{h}x{w}x{c} "
                   f"{kh}x{kh}/{kh} bfloat16",
                   _avgpool_times(torch, ap, x, dy, kh))
    h, w, c = RESNET_AVG_POOL
    x, dy, *_ = _avgpool_case(torch, ap, gen, (RESNET_VGG_BATCH, h, w, c), h,
                              False, "bfloat16")
    _log_times(f"avg bwd resnet pool2 {RESNET_VGG_BATCH}x{h}x{w}x{c} "
               f"{h}x{w} global bfloat16", _avgpool_times(torch, ap, x, dy, h))
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


def _lm_argv(iters: int, warmup: int, widths=(12, 768, 12, 3072)) -> list:
    layers, d_model, heads, d_ff = widths
    return ["--causal", "-b", "16", "-s", "512", "-l", str(layers),
            "--d-model", str(d_model), "--heads", str(heads), "--d-ff",
            str(d_ff), "--vocab", "32768", "-i", str(iters), "--warmup",
            str(warmup), "--device", "cuda"]


def lm_phase(torch, kernels, card: str, widths=(12, 768, 12, 3072),
             steps=(LM_WARMUP, LM_TIMED, LM_CHECKED), tag="lm") -> dict:
    """``apps.lm`` at full width through kernels 1-6, then its first
    losses against the run with every kernel swapped for its plain
    version.  ``widths`` (layers, d_model, heads, d_ff) default to the
    JAX app's example; ``steps`` are (warm-up, timed, checked)."""
    import gc

    from flexflow_tpu_torch.apps import lm
    from flexflow_tpu_torch.ops.kernels import flash_attention as fa
    from flexflow_tpu_torch.ops.kernels import fused_ce as ce

    warmup, timed, checked = steps
    iters = warmup + timed
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    out = lm.main(_lm_argv(iters, warmup, widths), log=_log)
    torch.cuda.synchronize()
    launches = dict(kernels.launches)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    losses = out["loss"]
    step_ms = out["elapsed_s"] / timed * 1e3
    _log(f"{tag}: {iters} steps ({warmup} warm-up); launches by kernel "
         f"{launches}")
    _log(f"{tag}: losses {losses}")
    layers = widths[0]
    want = {fa.NAME: layers * iters, fa.NAME_DKV: layers * iters,
            fa.NAME_DQ: layers * iters, ce.NAME_FWD: iters,
            ce.NAME_FWD_COMBINE: iters, ce.NAME_DX: iters,
            ce.NAME_DX_SUM: iters, ce.NAME_DW: iters}
    if launches != want:
        raise AssertionError(f"{tag} kernels launched {launches}, expected "
                             f"{want} ({layers} + {layers} + {layers} + 1 + "
                             f"1 + 1 per step, and the finishing passes of "
                             f"kernels 4 and 5)")
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"non-finite {tag} loss: {losses}")
    if abs(losses[0] - math.log(32768)) > 0.25:
        raise AssertionError(f"first LM loss {losses[0]} is not near "
                             f"ln 32768 = {math.log(32768):.4f}")
    _log(f"{tag}: {out['tokens_per_sec']:.1f} tokens/s "
         f"({out['images_per_sec']:.3f} sequences/s), {step_ms:.2f} ms per "
         f"step, peak memory {peak_gb:.2f} GB (max_memory_allocated) — "
         f"{card}")
    tokens_per_sec = out["tokens_per_sec"]
    del out
    gc.collect()
    torch.cuda.empty_cache()

    with _plain_kernels():
        kernels.reset_launches()
        ref = lm.main(_lm_argv(checked, 0, widths), log=lambda *a: None)
        if sum(kernels.launches.values()):
            raise AssertionError(f"the plain-kernel {tag} run launched a "
                                 f"kernel")
    torch.cuda.synchronize()
    got, want_l = losses[:checked], ref["loss"]
    del ref
    gc.collect()
    torch.cuda.empty_cache()
    rel = max(abs(a - c) / max(abs(c), 1e-30) for a, c in zip(got, want_l))
    _log(f"{tag}: first {checked} losses {got} vs plain kernels {want_l}: "
         f"max rel diff {rel:.3e} (tolerance {LM_LOSS_RTOL:g})")
    if not rel <= LM_LOSS_RTOL:
        raise AssertionError(f"{tag} losses differ from the plain-kernel run "
                             f"by {rel}")
    return {"launches": launches, "step_ms": step_ms, "peak_gb": peak_gb,
            "tokens_per_sec": tokens_per_sec}


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
    if any(t in k for t in ("index", "sort", "scan", "gather", "radix")):
        return "indexing, sort, scan (aten; the MoE routing and gathers)"
    if "avg_pool" in k:
        return "in-block avg pools (aten)"
    if any(t in k for t in ("conv", "cudnn", "dgrad", "wgrad", "implicit",
                            "fprop", "nhwc")):
        return "convolutions (cuDNN)"
    if any(t in k for t in ("gemm", "cutlass", "xmma", "sgemm")):
        return "matmul (cuBLAS)"
    return "elementwise / other"


def _held_step(torch, run, step_ms: float, tag: str) -> None:
    """A training step's device time without the profiler: two steps
    enqueued behind a sleep kernel run back to back, so their time is
    the device's (an upper bound where the launch queue fills before the
    sleep ends).  Against the step time by CUDA events it gives the
    device's idle share a second way, to hold the profiler's against."""
    held = _time_ms(torch, run, iters=2, warmup=0, hold=True)
    _log(f"profile {tag}: one step held behind a sleep {held:.3f} ms of "
         f"{step_ms:.3f} ms (device idle {1 - held / step_ms:.1%} by this "
         f"measure)")


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
         f"{step_ms:.3f} ms/step (device idle "
         f"{1 - total / per / step_ms:.1%})")
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
    _held_step(torch, run, step_ms, "lm")
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(2):
            run()
        torch.cuda.synchronize()
    _profile_by_kind(torch, prof, 2, step_ms, "lm")


def moe_profile_phase(torch) -> None:
    """One full-width MoE training step: where its device time goes, by
    kind (GEMMs and the experts' batched products, kernels 1-6, the
    routing and gathers, the rest), and the device's idle share."""
    from torch.profiler import ProfilerActivity, profile

    from flexflow_tpu_torch.apps import lm

    cfg, _, _ = lm.parse_args(_moe_argv(1, 0))
    model = lm.TransformerLM(cfg, device="cuda")
    params, state = model.init()
    opt = model.init_opt_state(params)
    step = model.make_train_step()
    toks, labels = next(lm.synthetic_lm_batches(
        cfg.batch_size, cfg.seq_length, cfg.vocab_size, seed=cfg.seed))

    def run():
        return step(params, state, opt, toks, labels)

    step_ms = _time_ms(torch, run, iters=3, warmup=2, hold=False)
    _log(f"profile moe: one step {step_ms:.3f} ms by CUDA events")
    _held_step(torch, run, step_ms, "moe")
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(2):
            run()
        torch.cuda.synchronize()
    _profile_by_kind(torch, prof, 2, step_ms, "moe")


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


def _cnn_model(torch, model: str, batch: int, iters: int) -> tuple:
    """``(ff, data)``: the model and the synthetic batches ``cnn.main``
    builds for ``apps.cnn <model>`` at ``batch`` and ``iters``."""
    from flexflow_tpu_torch.apps import cnn
    from flexflow_tpu_torch.data import synthetic_batches

    name, cfg, _, _ = cnn.parse(_train_argv(batch, iters, 0, model))
    ff = cnn.build(name, cfg, torch.device("cuda"))
    return ff, synthetic_batches(
        cfg.batch_size, cfg.input_height, cfg.input_width,
        num_classes=cfg.num_classes, mode="random", seed=cfg.seed,
        device=ff.device)


def _cnn_steps(torch, model: str, steps: int) -> tuple:
    """``steps`` training steps of ``apps.cnn <model>`` as ``cnn.main``
    runs them (the same flags, model, data and ``fit``), at batch
    ``RESNET_VGG_BATCH``: ``(losses, params)``."""
    ff, data = _cnn_model(torch, model, RESNET_VGG_BATCH, steps)
    out = ff.fit(data, warmup=0, log=lambda *a: None)
    return out["loss"], out["params"]


def resnet_vgg_phase(torch, kernels, card: str, model: str) -> dict:
    """``apps.cnn resnet101`` or ``vgg16`` at DenseNet's protocol (batch
    64, 224x224, bfloat16) through kernels 7 and 8, then its first
    losses, and its classifier's leaves after those steps, against the
    run with the CNN kernels swapped for their plain versions."""
    import gc

    from flexflow_tpu_torch.apps import cnn
    from flexflow_tpu_torch.ops.kernels import avgpool as ap
    from flexflow_tpu_torch.ops.kernels import maxpool as mp

    iters = TRAIN_WARMUP + TRAIN_TIMED
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    out = cnn.main(_train_argv(RESNET_VGG_BATCH, iters, TRAIN_WARMUP, model),
                   log=_log)
    torch.cuda.synchronize()
    launches = dict(kernels.launches)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    losses = out["loss"]
    step_ms = out["elapsed_s"] / TRAIN_TIMED * 1e3
    _log(f"{model}: batch {RESNET_VGG_BATCH}, {iters} steps ({TRAIN_WARMUP} "
         f"warm-up); launches by kernel {launches}")
    _log(f"{model}: losses {losses}")
    # ResNet: pool1 (max) and pool2 (global avg); VGG: five 2x2/2 max pools
    per_step = ({mp.NAME_FWD: 1, mp.NAME_BWD: 1, ap.NAME: 1}
                if model == "resnet101" else {mp.NAME_FWD: 5, mp.NAME_BWD: 5})
    want = {k: n * iters for k, n in per_step.items()}
    if launches != want:
        raise AssertionError(f"{model} kernels launched {launches}, expected "
                             f"{want} ({per_step} per step)")
    if not all(math.isfinite(v) for v in losses):
        raise AssertionError(f"non-finite {model} loss: {losses}")
    _log(f"{model}: {out['images_per_sec']:.2f} images/s, {step_ms:.2f} ms "
         f"per step, peak memory {peak_gb:.2f} GB (max_memory_allocated), "
         f"batch {RESNET_VGG_BATCH} — {card}")
    images_per_sec = out["images_per_sec"]
    del out
    gc.collect()
    torch.cuda.empty_cache()

    head = CNN_HEAD[model]
    got_l, got_p = _cnn_steps(torch, model, TRAIN_CHECKED)
    got_p = got_p[head]
    with _plain_cnn_kernels():
        kernels.reset_launches()
        want_l, want_p = _cnn_steps(torch, model, TRAIN_CHECKED)
        want_p = want_p[head]
        if sum(kernels.launches.values()):
            raise AssertionError(f"the plain-pool {model} run launched a "
                                 f"kernel")
    torch.cuda.synchronize()
    first = losses[:TRAIN_CHECKED]
    rel = max(abs(a - b) / max(abs(b), 1e-30) for a, b in zip(first, want_l))
    _log(f"{model}: first {TRAIN_CHECKED} losses {first} vs plain pools "
         f"{want_l}: max rel diff {rel:.3e} (tolerance {LOSS_RTOL:g}); a "
         f"second kernel run's {got_l}: identical to the first run's "
         f"{got_l == first}")
    if not rel <= LOSS_RTOL:
        raise AssertionError(f"{model} losses differ from the plain-pool run "
                             f"by {rel}")
    for leaf in ("kernel", "bias"):
        a, b = got_p[leaf], want_p[leaf]
        err = float((a - b).abs().max())
        scale = float(b.abs().max())
        _log(f"{model}: {head}.{leaf} after {TRAIN_CHECKED} steps vs plain "
             f"pools: max_abs_err {err:.3e}, {err / scale:.3e} of its max "
             f"{scale:.3e} (tolerance {LOSS_RTOL:g})")
        if not (scale > 0 and err <= LOSS_RTOL * scale):
            raise AssertionError(f"{model} {head}.{leaf} differs from the "
                                 f"plain-pool run by {err} (max {scale})")
    del got_p, want_p
    gc.collect()
    torch.cuda.empty_cache()
    return {"launches": launches, "step_ms": step_ms, "peak_gb": peak_gb,
            "images_per_sec": images_per_sec}


def _nmt_argv(iters: int, warmup: int) -> list:
    batch, layers, seq, hidden, embed = NMT_WIDTHS
    return ["-b", str(batch), "-l", str(layers), "-s", str(seq), "-h",
            str(hidden), "-e", str(embed), "--vocab", str(NMT_VOCAB), "-i",
            str(iters), "--warmup", str(warmup), "--device", "cuda"]


def nmt_phase(torch, kernels, card: str) -> dict:
    """``apps.nmt`` at the JAX app's defaults through kernels 4-6 (one
    fused vocab head per decoder chunk), then its first losses against
    the run with every kernel swapped for its plain version."""
    import gc

    from flexflow_tpu_torch.apps import nmt
    from flexflow_tpu_torch.ops.kernels import fused_ce as ce

    iters = LM_WARMUP + LM_TIMED
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    out = nmt.main(_nmt_argv(iters, LM_WARMUP), log=_log)
    torch.cuda.synchronize()
    launches = dict(kernels.launches)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    losses = out["loss"]
    step_ms = out["elapsed_s"] / LM_TIMED * 1e3
    _log(f"nmt: {iters} steps ({LM_WARMUP} warm-up); launches by kernel "
         f"{launches}")
    _log(f"nmt: losses {losses}")
    want = {name: NMT_CHUNKS * iters
            for name in (ce.NAME_FWD, ce.NAME_FWD_COMBINE, ce.NAME_DX,
                         ce.NAME_DX_SUM, ce.NAME_DW)}
    if launches != want:
        raise AssertionError(f"nmt kernels launched {launches}, expected "
                             f"{want} (kernels 4-6 and their finishing "
                             f"passes once per decoder chunk)")
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"non-finite nmt loss: {losses}")
    ln_v = math.log(NMT_VOCAB)
    if abs(losses[0] - ln_v) > 0.03 * ln_v:
        raise AssertionError(f"first NMT loss {losses[0]} is not within 3 % "
                             f"of ln {NMT_VOCAB} = {ln_v:.4f}")
    _log(f"nmt: {out['sentences_per_sec']:.2f} sentences/s, {step_ms:.2f} ms "
         f"per step, peak memory {peak_gb:.2f} GB (max_memory_allocated) — "
         f"{card}")
    sentences_per_sec = out["sentences_per_sec"]
    del out
    gc.collect()
    torch.cuda.empty_cache()

    with _plain_kernels():
        kernels.reset_launches()
        ref = nmt.main(_nmt_argv(LM_CHECKED, 0), log=lambda *a: None)
        if sum(kernels.launches.values()):
            raise AssertionError("the plain-kernel nmt run launched a kernel")
    torch.cuda.synchronize()
    got, want_l = losses[:LM_CHECKED], ref["loss"]
    rel = max(abs(a - c) / max(abs(c), 1e-30) for a, c in zip(got, want_l))
    _log(f"nmt: first {LM_CHECKED} losses {got} vs plain kernels {want_l}: "
         f"max rel diff {rel:.3e} (tolerance {LM_LOSS_RTOL:g})")
    if not rel <= LM_LOSS_RTOL:
        raise AssertionError(f"nmt losses differ from the plain-kernel run "
                             f"by {rel}")
    return {"launches": launches, "step_ms": step_ms, "peak_gb": peak_gb,
            "sentences_per_sec": sentences_per_sec}


def _moe_argv(iters: int, warmup: int, ckpt_dir=None, *extra) -> list:
    argv = _lm_argv(iters, warmup) + ["--experts", str(MOE_EXPERTS)]
    if ckpt_dir is not None:
        argv += ["--ckpt-dir", str(ckpt_dir), "--ckpt-freq",
                 str(MOE_CKPT_FREQ), "--on-divergence", "rollback"]
    return argv + list(extra)


def _moe_steps(torch, timed: int) -> dict:
    """``timed`` steps of the MoE model, each timed by CUDA events, with
    each step's aux loss and dropped share (mean over the 12 blocks) from
    a forward pass after it."""
    from flexflow_tpu_torch.apps import lm

    cfg, _, _ = lm.parse_args(_moe_argv(1, 0))
    model = lm.TransformerLM(cfg, device="cuda")
    params, state = model.init()
    opt = model.init_opt_state(params)
    step = model.make_train_step()
    toks, labels = next(lm.synthetic_lm_batches(
        cfg.batch_size, cfg.seq_length, cfg.vocab_size, seed=cfg.seed))
    ms, aux, dropped = [], [], []
    for i in range(LM_WARMUP + timed):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        params, state, opt, _ = step(params, state, opt, toks, labels)
        end.record()
        torch.cuda.synchronize()
        if i >= LM_WARMUP:
            ms.append(start.elapsed_time(end))
            stats = model.moe_stats(params, state, toks)
            aux.append(sum(stats["aux"]) / len(stats["aux"]))
            dropped.append(sum(stats["dropped"]) / len(stats["dropped"]))
    _moe_routing_log(torch, model, params, state, toks)
    return {"ms": ms, "aux": aux, "dropped": dropped}


def _moe_routing_log(torch, model, params, state, toks) -> None:
    """Where the drops come from, in the first and the last MoE block:
    the share of top-1 choices on the most chosen expert (1/8 when
    balanced) and the dropped share in the first and last quarter of the
    positions."""
    from flexflow_tpu_torch.ops.moe import MixtureOfExperts

    moes = [op for op in model.layers if isinstance(op, MixtureOfExperts)]
    with torch.inference_mode():
        values, _ = model.apply(params, state, {model.tokens.tid: toks,
                                                model.labels.tid: toks},
                                train=False)
        for op in (moes[0], moes[-1]):
            x = values[op.inputs[0].tid]
            wg = params[op.param_key]["wg"]
            top1 = torch.matmul(x.float(), wg.float()).argmax(-1)
            busiest = float(torch.bincount(top1.flatten(),
                                           minlength=op.num_experts).max()
                            / top1.numel())
            drop = op.route(params[op.param_key], x)[2] \
                == op.num_experts * op.capacity
            q = drop.shape[1] // 4
            _log(f"moe routing {op.name}: {busiest:.1%} of top-1 choices on "
                 f"the most chosen expert; dropped "
                 f"{float(drop[:, :q].float().mean()):.1%} of positions "
                 f"0-{q - 1}, {float(drop[:, -q:].float().mean()):.1%} of "
                 f"the last {q}")


def moe_phase(torch, kernels, card: str) -> dict:
    """``apps.lm --experts 8`` at full width with checkpoints every 5
    steps and rollback on divergence, through kernels 1-6; its first
    losses against the plain-kernel run; its steps by CUDA events with
    the aux loss and the dropped share; then the runtime: a resume from
    the step-5 checkpoint (with the prefetcher) repeats the run's losses,
    a NaN loss at step 7 rolls back to step 5 and the run finishes, and
    a corrupted last checkpoint makes the restore fall back."""
    import gc
    import shutil
    import warnings

    from flexflow_tpu_torch.apps import lm
    from flexflow_tpu_torch.ops.kernels import flash_attention as fa
    from flexflow_tpu_torch.ops.kernels import fused_ce as ce
    from flexflow_tpu_torch.utils import checkpoint as ckpt

    iters = LM_WARMUP + LM_TIMED
    shutil.rmtree(MOE_CKPT_ROOT, ignore_errors=True)
    MOE_CKPT_ROOT.mkdir()
    _log(f"moe: checkpoints under {MOE_CKPT_ROOT}, "
         f"{shutil.disk_usage(MOE_CKPT_ROOT).free / 1e9:.1f} GB free")
    try:
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launches()
        out = lm.main(_moe_argv(iters, LM_WARMUP, MOE_CKPT_ROOT / "run"),
                      log=_log)
        torch.cuda.synchronize()
        launches = dict(kernels.launches)
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        losses = out["loss"]
        step_ms = out["elapsed_s"] / LM_TIMED * 1e3
        _log(f"moe: {iters} steps ({LM_WARMUP} warm-up); launches by kernel "
             f"{launches}")
        _log(f"moe: losses {losses}")
        layers = lm.parse_args(_moe_argv(1, 0))[0].num_layers
        want = {fa.NAME: layers * iters, fa.NAME_DKV: layers * iters,
                fa.NAME_DQ: layers * iters, ce.NAME_FWD: iters,
                ce.NAME_FWD_COMBINE: iters, ce.NAME_DX: iters,
                ce.NAME_DX_SUM: iters, ce.NAME_DW: iters}
        if launches != want:
            raise AssertionError(f"moe kernels launched {launches}, "
                                 f"expected {want}")
        if not all(math.isfinite(x) for x in losses):
            raise AssertionError(f"non-finite moe loss: {losses}")
        # the first loss: ln V plus 12 blocks' aux (about 1 for a router
        # near uniform) at weight 1e-2
        first = math.log(32768) + layers * 1e-2
        if abs(losses[0] - first) > 0.25:
            raise AssertionError(f"first MoE loss {losses[0]} is not near "
                                 f"ln 32768 + 0.12 = {first:.4f}")
        ckpt_s = out["checkpoint_s"]
        _log(f"moe: {out['tokens_per_sec']:.1f} tokens/s, {step_ms:.2f} ms "
             f"per step, of which {ckpt_s * 1e3 / LM_TIMED:.2f} ms the 2 "
             f"checkpoint saves in the timed window ({ckpt_s:.2f} s); "
             f"peak memory {peak_gb:.2f} GB (max_memory_allocated) — {card}")
        tokens_per_sec = out["tokens_per_sec"]
        del out
        gc.collect()
        torch.cuda.empty_cache()

        with _plain_kernels():
            kernels.reset_launches()
            ref = lm.main(_moe_argv(LM_CHECKED, 0), log=lambda *a: None)
            if sum(kernels.launches.values()):
                raise AssertionError("the plain-kernel moe run launched a "
                                     "kernel")
        torch.cuda.synchronize()
        got, want_l = losses[:LM_CHECKED], ref["loss"]
        del ref
        rel = max(abs(a - c) / max(abs(c), 1e-30)
                  for a, c in zip(got, want_l))
        _log(f"moe: first {LM_CHECKED} losses {got} vs plain kernels "
             f"{want_l}: max rel diff {rel:.3e} (tolerance "
             f"{LM_LOSS_RTOL:g})")
        if not rel <= LM_LOSS_RTOL:
            raise AssertionError(f"moe losses differ from the plain-kernel "
                                 f"run by {rel}")
        gc.collect()
        torch.cuda.empty_cache()

        steps = _moe_steps(torch, LM_TIMED)
        ms = sorted(steps["ms"])
        _log(f"moe: step by CUDA events {ms[len(ms) // 2]:.3f} ms median "
             f"({ms[0]:.3f}–{ms[-1]:.3f}) over {LM_TIMED} steps, "
             f"{16 * 512 / ms[len(ms) // 2] * 1e3:.1f} tokens/s — {card}")
        _log(f"moe: aux loss per step (mean of the {layers} blocks) "
             f"{[round(a, 5) for a in steps['aux']]}")
        _log(f"moe: share of (token, choice) pairs dropped at capacity per "
             f"step {[round(d, 5) for d in steps['dropped']]}")
        # Switch's aux is at least 1/E (every token's top choice has at
        # least 1/E of its probability) and 1 for a balanced router
        if not all(math.isfinite(a) and a >= 1.0 / MOE_EXPERTS
                   for a in steps["aux"]):
            raise AssertionError(f"moe aux losses {steps['aux']}")
        if not all(0.0 <= d < 1.0 for d in steps["dropped"]):
            raise AssertionError(f"moe dropped shares {steps['dropped']}")
        gc.collect()
        torch.cuda.empty_cache()

        # resume: a fresh run from the step-5 checkpoint, batches through
        # the prefetcher, repeats steps 6-13
        resume_dir = MOE_CKPT_ROOT / "resume"
        resume_dir.mkdir()
        step5 = f"step_{MOE_CKPT_FREQ:08d}"
        (MOE_CKPT_ROOT / "run" / step5).rename(resume_dir / step5)
        shutil.rmtree(MOE_CKPT_ROOT / "run")
        lines = []
        res = lm.main(_moe_argv(iters, LM_WARMUP, resume_dir,
                                "--prefetch-depth", "2"), log=lines.append)
        if f"resumed from {resume_dir} at iteration {MOE_CKPT_FREQ}" \
                not in lines:
            raise AssertionError(f"moe resume did not resume: {lines}")
        got, want_l = res["loss"], losses[MOE_CKPT_FREQ:]
        rel = max(abs(a - c) / max(abs(c), 1e-30)
                  for a, c in zip(got, want_l))
        _log(f"moe resume: steps {MOE_CKPT_FREQ + 1}-{iters} from the "
             f"step-{MOE_CKPT_FREQ} checkpoint (prefetch depth 2) {got} vs "
             f"the uninterrupted run: max rel diff {rel:.3e} (tolerance "
             f"{MOE_RESUME_RTOL:g}); input stall "
             f"{res['input_stall_s']:.4f} s")
        if len(got) != iters - MOE_CKPT_FREQ or not rel <= MOE_RESUME_RTOL:
            raise AssertionError(f"the resumed moe run differs: {got} vs "
                                 f"{want_l}")
        del res
        shutil.rmtree(resume_dir)
        gc.collect()
        torch.cuda.empty_cache()

        # divergence: loss_nan at step 7 rolls back to step 5 at the
        # step-10 boundary; the last save is corrupted
        div_dir = MOE_CKPT_ROOT / "divergence"
        lines = []
        div = lm.main(_moe_argv(iters, 0, div_dir, "--fault-spec",
                                MOE_FAULTS), log=lines.append)
        rolled = (f"health guard: rolled back from iteration "
                  f"{2 * MOE_CKPT_FREQ} to checkpoint step {MOE_CKPT_FREQ}")
        _log(f"moe divergence ({MOE_FAULTS}): {div['rollbacks']} rollback, "
             f"{div['completed_steps']} steps, losses {div['loss']}")
        if rolled not in lines or div["rollbacks"] != 1 \
                or div["completed_steps"] != iters \
                or len(div["loss"]) != iters \
                or not all(math.isfinite(x) for x in div["loss"]):
            raise AssertionError(f"moe rollback run: {lines}")
        rel = max(abs(a - c) / max(abs(c), 1e-30) for a, c in
                  zip(div["loss"][:MOE_CKPT_FREQ], losses[:MOE_CKPT_FREQ]))
        if not rel <= MOE_RESUME_RTOL:
            raise AssertionError(f"the rollback run's first steps differ "
                                 f"from the main run's by {rel}")
        del div
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            step, params, _, _ = ckpt.restore_checkpoint(str(div_dir),
                                                         device="cuda")
        fell = [str(w.message) for w in caught
                if "checkpoint fallback" in str(w.message)]
        _log(f"moe corruption: restore gave step {step}; {fell}")
        if step != 2 * MOE_CKPT_FREQ or len(fell) != 1 \
                or f"step {iters} -> {step}" not in fell[0]:
            raise AssertionError(f"restore past the corrupt step {iters} "
                                 f"gave step {step}: {fell}")
        del params
    finally:
        shutil.rmtree(MOE_CKPT_ROOT, ignore_errors=True)
    gc.collect()
    torch.cuda.empty_cache()
    return {"launches": launches, "step_ms": step_ms, "peak_gb": peak_gb,
            "tokens_per_sec": tokens_per_sec}


def nmt_profile_phase(torch) -> None:
    """One NMT training step at the JAX app's defaults: where its
    device time goes, by kind (GEMMs, kernels 4-6, the LSTM's and the
    optimizer's elementwise passes), and how long the device idles."""
    from torch.profiler import ProfilerActivity, profile

    from flexflow_tpu_torch.apps import nmt

    cfg, _, _ = nmt.parse_args(_nmt_argv(1, 0))
    model = nmt.RnnModel(cfg, device="cuda")
    params, state = model.init()
    opt = model.init_opt_state(params)
    step = model.make_train_step()
    src, dst = next(nmt.synthetic_token_batches(
        cfg.batch_size, cfg.seq_length, cfg.vocab_size, seed=cfg.seed))

    def run():
        return step(params, state, opt, src, dst)

    step_ms = _time_ms(torch, run, iters=3, warmup=2, hold=False)
    _log(f"profile nmt: one step {step_ms:.3f} ms by CUDA events")
    _held_step(torch, run, step_ms, "nmt")
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(2):
            run()
        torch.cuda.synchronize()
    _profile_by_kind(torch, prof, 2, step_ms, "nmt")


def train_profile_phase(torch, model: str, batch: int) -> None:
    """One full-width CNN training step: where its device time goes, by
    kernel and by kind (cuDNN convolutions, the pool and BN kernels, the
    rest)."""
    from torch.profiler import ProfilerActivity, profile

    ff, data = _cnn_model(torch, model, batch, 1)
    params, state = ff.init()
    opt = ff.init_opt_state(params)
    step = ff.make_train_step()
    image, labels = next(data)

    def run():
        return step(params, state, opt, image, labels)

    step_ms = _time_ms(torch, run, iters=3, warmup=2, hold=False)
    _log(f"profile {model}: one step {step_ms:.3f} ms by CUDA events "
         f"(batch {batch})")
    _held_step(torch, run, step_ms, model)
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
    built = kernels.build([fa.SOURCE, fa.SOURCE_BWD, ce.SOURCE,
                           ce.SOURCE_BWD, mp.SOURCE, ap.SOURCE, bn.SOURCE])
    _log(f"build: {time.perf_counter() - t0:.2f} s for {len(built)} "
         f"kernel source(s) (parallel nvcc)")
    for source, info in built.items():
        _log(f"build {source}: {info['seconds']:.2f} s -> {info['path']}")
        for kernel, regs, spills in _ptxas_report(info["log"]):
            _log(f"build {source}: {kernel}: {regs} registers, spill "
                 f"stores/loads {spills} bytes")
            # kernels 1-4 keep their accumulators in registers, the pool
            # kernels their window vectors
            if source in (fa.SOURCE, fa.SOURCE_BWD, ce.SOURCE, mp.SOURCE,
                          ap.SOURCE) and spills != "0/0":
                raise AssertionError(f"{source}: {kernel} spills registers "
                                     f"({spills} bytes)")
    flash_lib, bwd_lib, ce_lib = fa._lib(), fa._lib_bwd(), ce._lib()
    _log("build smem flash_fwd_kernel (dynamic, bytes): " + ", ".join(
        f"d {d} float32 {flash_lib.ff_flash_attention_fwd_smem(d, 0)} "
        f"bfloat16 {flash_lib.ff_flash_attention_fwd_smem(d, 1)}"
        for d in fa.HEAD_DIMS_FWD))
    for which, kernel in enumerate(("flash_bwd_dkv_kernel",
                                    "flash_bwd_dq_kernel")):
        _log(f"build smem {kernel} (dynamic, bytes): " + ", ".join(
            f"d {d} float32 {bwd_lib.ff_flash_attention_bwd_smem(which, d, 0)}"
            f" bfloat16 {bwd_lib.ff_flash_attention_bwd_smem(which, d, 1)}"
            for d in fa.HEAD_DIMS_BWD))
    hmma = {k: n for k, n in _sass_hmma(built[fa.SOURCE_BWD]["path"])
            .items() if k.startswith("flash_bwd_")}
    _log(f"build sass {fa.SOURCE_BWD}: HMMA instructions per kernel {hmma}")
    if len(hmma) != 4 * len(fa.HEAD_DIMS_BWD) or not all(hmma.values()):
        raise AssertionError(f"{fa.SOURCE_BWD}: every instance of kernels "
                             f"2-3 must run its products on the tensor "
                             f"cores (HMMA): {hmma}")
    _log(f"build smem ce_fwd_kernel (dynamic, bytes): float32 "
         f"{ce_lib.ff_fused_ce_fwd_smem(0)}, bfloat16 "
         f"{ce_lib.ff_fused_ce_fwd_smem(1)}")

    def phase(name, fn, *args):
        t = time.perf_counter()
        out = fn(*args)
        _log(f"phase {name}: {time.perf_counter() - t:.1f} s")
        return out

    checked = phase("flash forward", kernel_phase, torch, fa)
    flash_bwd = phase("flash backward", flash_bwd_phase, torch, fa)
    fused = phase("fused ce", fused_ce_phase, torch, ce)
    pools = phase("pools", pool_kernel_phase, torch, kernels)
    bns = phase("bn", bn_kernel_phase, torch)
    sliced = phase("serving", slice_phase, torch, fa, kernels)
    lm_run = phase("lm", lm_phase, torch, kernels, card)
    phase("lm 1.3b", lm_phase, torch, kernels, card, LM13_WIDTHS,
          (LM13_WARMUP, LM13_TIMED, LM13_CHECKED), "lm 1.3b")
    trained = phase("inception", training_phase, torch, kernels, card)
    dense = phase("densenet", densenet_phase, torch, kernels, card)
    phase("resnet101", resnet_vgg_phase, torch, kernels, card, "resnet101")
    phase("vgg16", resnet_vgg_phase, torch, kernels, card, "vgg16")
    phase("nmt", nmt_phase, torch, kernels, card)
    phase("moe", moe_phase, torch, kernels, card)
    if "--profile" in argv:
        phase("profile serving", profile_phase, torch, sliced["engine"])
        phase("profile lm", lm_profile_phase, torch)
        for model, batch in (("inception", trained["batch"]),
                             ("densenet", DENSENET_BATCH),
                             ("resnet101", RESNET_VGG_BATCH),
                             ("vgg16", RESNET_VGG_BATCH)):
            phase(f"profile {model}", train_profile_phase, torch, model,
                  batch)
        phase("profile nmt", nmt_profile_phase, torch)
        phase("profile moe", moe_profile_phase, torch)

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
    for name, source, line in ((ce.NAME_FWD, ce.SOURCE, 39),
                               (ce.NAME_FWD_COMBINE, ce.SOURCE, 39),
                               (ce.NAME_DX, ce.SOURCE_BWD, 127),
                               (ce.NAME_DX_SUM, ce.SOURCE_BWD, 127),
                               (ce.NAME_DW, ce.SOURCE_BWD, 147)):
        entries.append(entry(name, source,
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
    _log(f"chip_smoke: {time.perf_counter() - t0:.1f} s in all")
    print(json.dumps({"kernels": entries}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
