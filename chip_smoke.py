#!/usr/bin/env python3
"""Chip smoke of the PyTorch port: builds its CUDA kernels, holds each one
against its plain PyTorch version on the card, drives each ported path at
full width through its entry point — the GPT served by ``apps.serve``,
the GPT and its mixture-of-experts form trained by ``apps.lm``,
Inception-v3, DenseNet-121, ResNet-101 and VGG-16 trained by
``apps.cnn``, the NMT seq2seq model trained by ``apps.nmt``, AlexNet
trained by ``torchrun ... apps.cnn`` under a strategy file, the NMT
and AlexNet with ops placed on device subsets through ``torchrun``,
the GPT trained by ``torchrun ... apps.lm`` under per-op strategies
(ring and head-parallel attention, the fused vocab-parallel head), its
MoE form under expert-parallel grids and its GPipe pipelined form, and
the strategy search (``apps.search --measured``, shard times from this
card) with the AlexNet strategy it finds trained over ranks and the
GPipe block it proposes for the GPT trained pipelined, the halo
exchange of spatially split convolutions and pools, and the LM's
checkpoints over ranks resumed — and checks that each path ran through
its kernels.

    python3 chip_smoke.py              # the smoke (one GPU; on four,
                                       # phase 19 too)
    python3 chip_smoke.py --profile    # plus torch.profiler breakdowns of
                                       # one decode step and one training
                                       # step of each trained model
    python3 chip_smoke.py --only search4,lm-obs
                                       # the kernel build and the named
                                       # phases (lm, lm-obs, debug,
                                       # serve-forward, serve-ranks,
                                       # serve-disagg,
                                       # serve-scale, serve-search,
                                       # serve-search-ranks, resnet101,
                                       # nmt, moe, runtime,
                                       # strategy, lm-strategy,
                                       # moe-strategy, pipeline, search and
                                       # strategy4, lm-strategy4,
                                       # serve-scale4,
                                       # serve-search-ranks4, pipeline4,
                                       # search4) with the
                                       # phases they
                                       # read; no kernels line, a last
                                       # line {"ok": false, "partial":
                                       # [...]}, exit status 4

(Phase 17 starts the script again, as two torchrun workers, with
``--gloo-cuda-probe``, then with ``--gloo-p2p-probe``: its probes of
gloo on CUDA tensors, the point-to-point one in processes of its own,
since gloo may abort a process whose send of a CUDA tensor fails.
Phases 18b-18d and 19's LM runs start it as torchrun workers with
``--lm-ranks SPEC``: several ``apps.lm`` runs, then the MoE op probe or
the pipeline probe, in one torchrun world.)

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
   both dtypes), head dim 96 through the wrapper's zero-padding to 128
   (causal, ragged, cross, in both dtypes) and an empty K; then its time,
   the plain version's and ``scaled_dot_product_attention``'s (a
   yardstick the port never calls) at the serving shape, and its time at
   head dims 128 and 96;
4. flash backward phase: kernels 2 (dk, dv) and 3 (dq) against the
   plain backward at the LM training shape (16, 12, 512, 64) causal, a
   ragged non-causal cross case (Sq 77, Sk 300), head dim 128 causal at
   (4, 16, 512, 128) and ragged (Sq 77 causal; Sq 77, Sk 300), head dim
   96 (zero-padded to 128) at (16, 8, 512, 96) causal and ragged, each in
   float32 and bfloat16; that two calls give the same bits; then their
   times at the LM shape, at (4, 16, 512, 128) and at (16, 8, 512, 96)
   beside the plain backward's and the backward of
   ``scaled_dot_product_attention`` (a yardstick the port never calls);
5. fused cross-entropy phase: kernels 4 (forward, then its finishing
   combine over the vocab slices), 5 (dx, then its finishing sum over
   the vocab slices) and 6 (dw, db) against their plain versions at the LM head's N = 8192, d = 768, V = 32768 in
   float32 and bfloat16, at GPT-2's V = 50257, labels with -1 (no
   target) included, at the NMT head's N = 640, d = 2048, V = 20480
   in float32 and at the rows of it a rank holds under placement (N =
   320 on two ranks, 160 on four); then, at the first three and at the
   NMT head's d and V for N = 160 to 10240 tokens, their times and achieved TFLOP/s beside
   the plain versions' and the unfused library pair's (``x @ w + b``,
   then ``F.cross_entropy``, forward and backward), and at the NMT
   head's the ratio of the two: where the fused head's crossover lies;
5b. partial forms phase (ring attention's and the vocab-parallel head's
   step): ``flash_attention_partial`` (kernel 1's (o, lse); kernels 2-3
   with the lse cotangent folded into delta) at a rank's ring chunk (16,
   12, 256, 64) against a 256-key chunk, non-causal and causal, and
   ``fused_linear_ce_partial`` (kernels 4-6, 5-6 taking two cotangent
   rows gp and goh) at a rank's vocab slice (N 8192, d 768, V_local
   16384, labels inside, below and above the slice and -1), each
   through its autograd function against the plain versions; then their
   times beside the plain versions', the efficient-attention call that
   also returns the lse (kernel 1; no library call takes the lse
   cotangent) and ``addmm`` + ``logsumexp`` + the label gather with its
   autograd (kernels 4-6);
6. pool kernel phase: the max-pool forward and backward (kernel 7) at
   Inception's four max-pool geometries at N = 256, DenseNet's and
   ResNet-101's pool1 (64 x 112 x 112 x 64, pad 1) and VGG-16's five
   2x2/2 pools at N = 64 in bfloat16 and float32, tie-heavy integer
   inputs, a pad-1 and a 2x2 geometry, AlexNet's three 3x3/2 pools at N
   = 64 and at the blocks a rank pools under the strategy phase's two-
   and four-rank strategies, in float32; the avg-pool backward (kernel 8)
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
8b. the disaggregated pools (ROADMAP Queue A item 6's rest): the same
   GPT as two prefill replicas and one decode replica behind
   ``serve/router.py``, every engine at max_batch 8 (all on cuda:0, or
   each on a card of its own where four are visible), serving 12
   multi-turn ``session`` requests (prompt 6, 4 new tokens): the routed
   replies equal the single-pool engine's token for token, 12 handoffs
   and 12 completed, kernel 1 launched 12 times a forward step summed
   over the replicas; again under ``replica_crash@3,handoff_drop@5,
   kv_corrupt@7``: the same replies, nothing failed, at least one KV
   rebuild; the decode step's ``decode_step_ratio`` and each replica's
   wall ms a step logged; on four cards ``apps.serve
   --serve-prefill-devices 2 --serve-prefill-replicas 2
   --serve-decode-replicas 2`` too;
8c. the serving search (phase ``serve-search``): ``apps.search gpt
   --serve --devices 1 -b 8 --measured`` (kernels 1-3 launched while it
   times the shards) and ``--serve --disagg 1`` from the same cache, each
   artifact's ``__predicted__.serve`` block present and its plans passing
   the plan check; ``apps.serve gpt -s`` of the first at its
   ``forward_step_s`` serving phase 8's 16 requests (phase 8's replies,
   kernel 1 12 times a step); 8b's routed pools from the second (the
   prefill plan, the decode pool's plan and step from ``serve.decode``):
   8b's single-pool replies, kernel 1 12 times a forward step summed over
   the replicas; each engine's simulated step beside its wall ms a step;
   then ``apps.serve --disagg-smoke`` and ``--chaos-smoke``, ``apps.
   loadtest --smoke`` and ``apps.loadtest --disagg --chaos
   replica_crash@3,handoff_drop@5`` on cuda:0, each passing its checks;
8d. the serving search over ranks (phase ``serve-search-ranks``), in
   18b's world after 18g's run: ``apps.search gpt --serve --devices 2 -b
   8 --measured`` made before the world starts, ``apps.serve gpt -s`` of
   it in the world (every rank's replies the one-rank engine's, kernel 1
   on rank 0 12 times a step, plain and partial forms together), then
   ``apps.serve --smoke`` (the tiny GPT: 2 -> 1 -> 2, 46 completed, none
   unserved or dropped); on four cards the same in 19's four NCCL ranks
   (4 -> 3 -> 4);
9. LM training slice: ``apps.lm`` at the JAX app's own example (causal,
   batch 16, seq 512, 12 layers, d_model 768, 12 heads, d_ff 3072, vocab
   32768, float32, plain SGD at lr 1e-3) for 3 warm-up and 10 timed steps:
   finite losses, the first near ln 32768, per step 12 launches each of
   kernels 1, 2 and 3 and one each of kernels 4, 4's combine, 5, 5's sum
   and 6, and the first 3
   losses within 1e-4 (relative) of the same run with every kernel
   swapped for its plain version; tokens/s, step ms and peak memory;
9b. the drift loop's LM run (ROADMAP Queue A item 4 (i)): the same
   ``apps.lm`` for 1 warm-up and 4 steps with ``-obs-dir`` and
   ``--op-time-every 2``: its fit records, the forward, backward,
   optimizer and step sections of steps 2 and 4, one shard of every op
   timed alone (``utils/profiling.py:time_op_shard``); the op records
   name every op of the model, kernels 1-3 launch while the shards are
   timed, the losses equal phase 9's unsampled ones within 1e-6
   (relative), and ``sim_drift_unavailable`` says no strategy was
   loaded;
9c. the same ``apps.lm`` with ``--profiling --trace-dir T`` (path C of
   ROADMAP Queue A item 5), 1 warm-up and 2 steps: the step roofline
   line, a row of the per-op table (``utils/profiling.OpProfiler``) for
   every op of the model, each attention and linear shard timed on the
   card (its CUDA graph between CUDA events) and not estimated, the
   ``torch.profiler`` trace naming the launches of kernels 1-6
   (flash_fwd_kernel, flash_bwd_dkv_kernel, flash_bwd_dq_kernel,
   ce_fwd_kernel, ce_bwd_dx_kernel, ce_bwd_dw_kernel), and the losses
   bit-equal to phase 9's first 3;
9d. the verification switches of SURVEY §4 (ROADMAP Queue A item 5's
    rest) on ``apps.lm`` at phase 9's widths: ``--dry-compile`` (the
    model, its plan and one step traced on the meta device) returns no
    losses, launches no kernel, logs ``dry-compile ok: ...`` and grows
    the card's memory by no more than the synthetic source's batches;
    ``--params-ones`` for 3 steps launches kernels 1-6 as phase 9 does,
    its first loss ln 32768 within 1e-5 (relative; every vocab column's
    logit is the same) and its losses equal a second run's bit for bit;
    ``--print-intermediates`` for 1 step prints one statistics line per
    op output (the fused head off: kernels 1-3 once per block, 4-6
    never), each within the LM phase's 1e-4 (relative, plus one unit of
    the sixth printed decimal) of the same run with the plain kernels;
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
12b. the forward-only service (ROADMAP Queue A item 6's first piece):
    ``apps.serve densenet121 --requests 32 --max-batch 8`` (224x224,
    float32), every BN at per-channel scale, bias, running mean and
    variance drawn from a seed: every request served in 4 batches,
    kernels 7f and 9 launched as many times as the graph's kernel-routed
    max pools and gated BNs a batch, x 4, the replies (log-probs) within
    1e-3 of their largest magnitude of the same service with kernels
    7-10 swapped for their plain versions, and moved past that tolerance
    when the statistics are set back to their identity initial values;
    finite qps, p50 and p99 in its JSON line, the wall time on the card;
    ``apps.serve nmt`` at the JAX driver's defaults (its forward runs no
    kernel: the fused head trains); then the DenseNet service in a
    subprocess of 256 requests, sent SIGTERM
    once its first batch is served: exit 0, one JSON line with requests
    unserved and none dropped, and its ``-metrics-path`` file holding
    the ff_qps, ff_queue_depth, ff_latency_p50_s, ff_latency_p99_s and
    ff_requests_total gauges;
12c. serving over ranks (ROADMAP Queue A item 6's rest): one torchrun
    world of four ranks (gloo on cuda:0 on one card, an NCCL rank per
    card on four) rides ``apps.serve`` through ``--lm-ranks``:
    DenseNet-121's forward service (32 requests at max batch 8) data
    parallel and with its classifier's channels split over the ranks by
    a strategy file, then the NMT's: every request served in 4 batches
    on every rank, the replies within 1e-3 of their largest magnitude of
    phase 12b's one-card service (BN statistics as initialized), kernel
    9 on each rank once a batch for every BN whose block of the rank's 2
    rows passes the JAX gate (a power-of-two row divisor of at least 8:
    the 7x7 BNs' 98 rows take the plain form) and 7f once a batch, none
    for the NMT; then the routed pools at the GPT's widths on 8b's load
    (``--pattern session``), a prefill replica of 2 ranks and a decode
    replica of 2, without and with 8b's faults (``-fault-spec``), and two
    one-rank prefill replicas with a two-rank decode replica: on every
    rank 8b's single-pool replies token for token (a mismatch names the
    request, the position and the one-card top-2 gap), kernel 1 12 times
    the forward steps of the rank's replica, each replica's wall ms a
    step logged beside its virtual step;
13. ResNet-101 training slice: ``apps.cnn resnet101`` (the reference's
    topology: no BN, no residual add) at DenseNet's protocol (batch 64,
    224x224, bfloat16 compute, float32 params) for 3 warm-up and 10 timed
    steps: finite losses, per step one launch each of the max-pool
    forward, its backward and the avg-pool backward; the first 3 losses,
    and the ``linear1`` kernel and bias after 3 steps, within 2e-2 of the
    run with kernels 7-10 swapped for their plain versions; images/s,
    step ms and peak memory;
13b. ResNet-101 from a JPEG tree (path A of ROADMAP Queue A item 5):
    the smoke writes an ImageNet-style tree with PIL (8 class
    directories, 3 batches of 64 JPEGs from a seed at mixed sizes of
    256-500 px) and trains ``apps.cnn resnet101 -d <tree>`` at the
    same protocol with ``--prefetch-depth 2``, 1 warm-up and 5 timed
    steps: the decoder the stream names is the native loader where its
    library builds and PIL where it does not, the launches of kernels 7,
    7f and 8 per step as in phase 13, finite losses, and the first
    step's input batch equal to the plain PIL decode of the same files
    (bit-equal on the PIL path, the largest difference logged on the
    native one); images/s and ``input_stall_s`` beside phase 13's;
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
15b. the NMT under the training runtime's flags (path B of ROADMAP
    Queue A item 5): the same ``apps.nmt`` for 10 steps (1 warm-up)
    with ``--ckpt-dir D --ckpt-freq 5 --ckpt-async --on-divergence
    rollback --fault-spec loss_nan@7 -obs-dir O -metrics-path M``: one
    rollback (10 -> 5), the records fault -> rollback -> recovery in the
    JAX package's order, the first 5 losses bit-equal to phase 15's, a
    verified final checkpoint at step 10, the metrics file written, and
    kernels 4-6 launched 2 a step for the 15 steps run; the checkpoint,
    final-save and restore seconds;
16. MoE training slice and the training runtime: ``apps.lm --experts 8``
    at the LM run's widths and 6 of its 12 blocks (a depth cut: the
    checkpoints dominate the phase; 8 experts in every block, top-2, capacity
    factor 2.0, aux weight 1e-2, float32, plain SGD at lr 1e-3) with
    ``--ckpt-dir --ckpt-freq 5 --on-divergence rollback``, 3 warm-up and
    10 timed steps: finite losses, the first near ln 32768 + 0.06, the
    launches of the LM run (the experts' products are cuBLAS's), the
    first 3 losses within 1e-4 (relative) of the plain-kernel run;
    tokens/s, the checkpoint seconds, peak memory; 10 steps timed one by
    one by CUDA events, each with the aux loss and the share of (token,
    choice) pairs dropped at capacity; a run resumed from the step-5
    checkpoint, its batches through the prefetcher (depth 2), repeats
    steps 6-13 within 1e-6; the same run with the training
    runtime's supervision (``--ckpt-async``, ``-metrics-path``,
    ``-obs-dir``, ``--hang-factor 20 --hang-min-s 60``): losses within
    1e-6 of the synchronous run's (bit-equal or not, logged), its step-5,
    -10 and -13 checkpoints verified and byte-equal to the synchronous
    ones (SHA-256) where the losses are bit-equal, kernels 1-6 launched
    as in the synchronous run, the boundaries' checkpoint seconds and
    tokens/s beside the synchronous run's (in the timed window, and
    through the final save's commit), the writer's submit-to-commit
    seconds, host step times during a write and outside one, the
    metrics finite (mfu, peak memory), the ``step_budget`` sound, the
    fit trace's counter lanes valid; ``apps.lm`` in a subprocess with
    ``--ckpt-async --fault-spec preempt@7 --drain-budget-s 60`` exits 0
    with one ``preempt_drain`` record (mode async, the step-10 boundary,
    within the budget), and a run resumed from its checkpoint, its
    batches through the prefetcher (depth 2), repeats steps 11-13 within
    1e-6; ``--fault-spec loss_nan@7, ckpt_corrupt@3`` rolls back from
    step 10 to step 5 and finishes 13 steps, and the restore falls back
    past the corrupted step 13 to 10;
16b. the runtime's watchdog and smokes: ``apps.lm`` at phase 9's
    widths, 1 + 4 steps, ``--hang-factor 3 --hang-min-s 1 --fault-spec
    step_hang@2``, raises ``DeviceLostError`` naming the deadline, with
    one ``step_hang`` record; ``apps.preempt_smoke`` and
    ``apps.budget_smoke`` on the card;
17. strategy slice: ``python -m torch.distributed.run --standalone
    --nproc-per-node 1 -m flexflow_tpu_torch.apps.cnn alexnet -b 64
    --height 224 --width 224 --lr 0.001 -s <file> -ll:gpu 1`` (the JAX
    app's example at lr 1e-3, float32, 3 warm-up and 10 timed steps)
    under a one-rank strategy this phase writes: NCCL, the strategy
    loader, the block machinery and the gradient all-reduce, 3 launches
    each of kernel 7 and its forward a step, the first 3 losses within
    1e-4 (relative) of the same run without ``-s`` in this process (no
    process group); images/s, step ms and peak memory; then which
    collectives gloo carries on CUDA tensors (two processes on cuda:0),
    and where it carries all the path needs (its moves gather where
    gloo has no all-to-all), a two-rank run on cuda:0 over gloo with
    conv1 and pool1 split over h (their halos exchanged through host
    copies, gloo carrying no point-to-point for CUDA tensors), conv2 and
    lienar1 over channels and the rest over the batch, its first 3
    losses held to the same bar and rank 0's pool launches counted as
    above, and its halo bytes a step logged beside what the all-gather
    of the whole extent moved before the exchange;
18. placement slice (ROADMAP Queue A 3b): ``python -m
    torch.distributed.run --standalone --nproc-per-node 1 -m
    flexflow_tpu_torch.apps.nmt`` at the JAX app's defaults (float32, 3
    warm-up and 10 timed steps) with ``--strategy`` the reference's
    ``default_global_config`` written for one device (NCCL): per step 2
    launches each of kernels 4, 4's combine, 5, 5's sum and 6, the first
    3 losses within 1e-4 (relative) of phase 15's run without a strategy
    in this process; sentences/s, step ms and peak memory; then, where
    gloo carries CUDA tensors for the moves (phase 17's probe), two gloo
    ranks on cuda:0, the three runs in one torchrun world (``--lm-ranks``
    with each run's app), each 1 warm-up and 3 steps with its first 3
    losses held to the same bar against its one-rank run and rank 0's
    launches counted: the NMT under the two-device
    ``default_global_config`` (``srcEmbed`` on rank 0 alone, ``dstEmbed``
    on rank 1, the LSTMs and heads over the batch: kernels 4-6 on 320
    rows a chunk) and under ``--pipeline-stages 2`` (LSTM layer l on rank
    l), and AlexNet (batch 64, 224x224) with linear2 and linear3 on rank 1
    alone and the rest data parallel (3 + 3 pool launches a step); each
    rank's param keys are logged (residency);
18b. LM strategy slice (ROADMAP Queue A 3c): ``apps.lm`` through
    ``torchrun --nproc-per-node 1`` at phase 9's widths and steps with
    ``--strategy`` a one-device file this phase writes (NCCL): phase 9's
    launches, the first 3 losses within 1e-4 (relative) of phase 9's
    run; tokens/s, step ms and peak memory; then two gloo ranks on
    cuda:0, 1 warm-up and 3 steps at 2 of phase 9's 12 blocks (a depth
    cut: every block pays gloo's host copies, and the whole smoke must
    end within 1200 s), under
    a strategy that puts every new
    mechanism on the path: ring attention (s = 2) in the even blocks,
    the heads split in the odd ones, ``ff1`` (2, 1), ``ff2`` (1, 2), the
    norms and residuals alternately (2, 1) and (1, 2), ``embed`` on rank
    1 alone and ``lm_head`` (2, 1), the fused vocab-parallel head (gloo
    carries no point-to-point for CUDA tensors, phase 17's probe, so the
    ring's rotations all-gather); the first 3 losses within 1e-4 of one
    process's run at that depth, rank 0's launches of kernels 1-6 and their partial
    forms counted, each rank's param keys logged; that run checkpoints
    every 2 steps (rank 0 writes the leaves gathered whole), and in the
    same world a run resumed from its step-2 checkpoint repeats steps 3-4:
    its losses and the step-4 checkpoint's leaves equal the uninterrupted
    run's bit for bit (or within 1e-6, logged), its launches those of 2
    steps, the save and restore seconds logged; that resumed run writes
    through the async writer, its step-4 bytes the synchronous run's;
    last in the world, a run asked to drain on rank 0 alone (``preempt@1``
    there) stops both ranks at the step-2 boundary (mode async, the
    synchronous step-2 bytes), leaving the world;
18c. MoE strategy slice (ROADMAP Queue A 3c-ii): ``apps.lm --experts 8``
    at phase 16's widths through ``torchrun --nproc-per-node 1`` (NCCL),
    1 warm-up and 3 steps, under a one-device strategy file: the losses
    equal phase 16's first 4 bit for bit, and phase 9's per-step
    launches of kernels 1-6; then two gloo ranks on cuda:0 under phase
    18b's placements with the even MoE blocks (2, 1, 1) (experts split)
    and the odd (1, 2, 1) (expert hidden channels split), 2 blocks as
    18b's: the first 3 losses within 1e-4 of one process's run at that
    depth, rank 0's launches as 18b's,
    each rank's param keys logged; in the same torchrun world, the MoE
    op alone at full width (B 16, S 512, D 768, 8 experts, d_ff 3072)
    under (2, 1, 1), (1, 2, 1) and (1, 1, 2) at capacity 2.0 and 1.0
    against the op on one device in the same process: each rank's
    routing of its rows equal bit for bit, y and the gradients within
    1e-4 of their largest magnitude, aux within 1e-6, at capacity 1.0
    some choices dropped on every rank; the dropped share and each
    rank's w1 block logged; in the same world, 18b's drained LM resumed
    from its step-2 checkpoint repeats steps 3-4 within 1e-6;
18d. pipeline slice (ROADMAP Queue A 3d, item 4 (iii)): ``PipelinedLM``'s
    sequential reference trained in this process on the card (phase 9's
    widths, 1 warm-up and 3 steps, SGD at lr 1e-3); ``apps.search
    transformer --devices 4 --measured`` at that batch (its shards timed
    on this card, kernels 1-3 launched while timing; on two devices
    JAX's rule S < n leaves no GPipe candidate): every candidate with its
    terms and the decision logged, the best tp-1 candidate written as a
    block-only strategy file; then, in one torchrun world
    of two gloo ranks on cuda:0, ``apps.lm --pipeline-stages 2
    --microbatches 4`` (its first 3 losses within 1e-4 of the
    reference; every rank launches each of kernels 1-3 (L/S)(M + S - 1)
    times a step, the head being the plain float32 one of JAX's
    pipelined LM; each rank's (stage, n, tp) and w1 block logged),
    ``--strategy examples/strategies/transformer_2x4.json`` as written,
    which the static plan check refuses on two ranks as the JAX driver
    does (its per-op entries name eight devices): exit status 2 on both
    ranks, and a file of that strategy's ``__pipeline__`` block alone
    (2 stages x 8 microbatches) against ``--pipeline-stages 2
    --microbatches 8`` within 1e-6 and that run against the reference,
    with the same launch counts, and the proposed block's file against
    the reference, (L/S)(M + S - 1) launches of kernels 1-3 a step, its
    measured step logged beside the candidate's simulated one.  JAX's ``PipelinedLM.init`` gives a zero head, so those
    losses stay near ln V whatever the blocks compute: in the same world
    the pipeline probe draws a seeded head and holds the ring's loss
    within 1e-4 and every leaf's gradient on every rank within 1e-4 of
    its largest magnitude against the sequential reference on the same
    tree;
18e. search slice (ROADMAP Queue A item 4): ``apps.search alexnet
    --devices 2 --measured`` and ``apps.search transformer --devices 2
    --measured`` at full width (AlexNet batch 64 at 224x224; the
    transformer's batch 64, seq 512, 12 x 768, vocab 32768), one grid
    point's forward and gradient of each candidate timed on this card
    through the port's ops (a chain of 8 captured in one CUDA graph,
    replays between CUDA events): the shards timed, the
    measurement's seconds, the launches of kernels 7 and 7f (AlexNet)
    and 1-3 (the transformer) while timing (each at least once), the
    shards estimated for want of a clone, the kind anchors (measured
    over analytic time), ``dp_time_s``, ``best_time_s`` and
    ``speedup_vs_dp``; every timed shard finite and positive, every
    searched entry among its op's candidates; the AlexNet search with
    ``-obs-dir`` and ``-trace``, its simulated timelines validated
    (``obs/trace.py:validate_trace``); then the searched AlexNet
    strategy through torchrun on two gloo ranks on cuda:0, 1 warm-up and
    8 steps, its first 3 losses within 1e-4 (relative) of phase 17's
    one-rank run, with ``-obs-dir`` and ``--op-time-every 9`` (the last
    step sampled, so 7 of the 8 steps ``sim_drift`` divides by run
    unsampled); then the
    drift loop over the two runs' records: ``sim_drift`` (the measured
    step over the file's ``__predicted__`` one) finite and positive,
    each op's simulated and measured seconds and share of the drift
    logged (gloo's host copies are not the simulated machine, so no bar
    is held on them), and ``apps.calibrate --from-obs``'s refit joining
    ops and giving anchors for Conv2D, Pool2D and Linear;
18f. elastic slice (ROADMAP Queue A item 5, its elastic half), in 18b's
    two-gloo-rank world before its drained run: ``apps.lm`` at 18b's
    widths and depth under 18b's strategy with ``--elastic --min-devices 1
    --print-freq 1 --ckpt-dir D --ckpt-freq 2 --regrow-probes 2
    --max-regrows 1 --research-budget-s 10 --fault-spec
    device_loss@2,device_return@2 -obs-dir O``, 1 warm-up and 8 steps:
    rank 1 is lost at the step-2 boundary, the run shrinks 2 -> 1 (live
    state gathered and migrated in memory, 0 steps lost, the strategy
    re-searched on rank 0), rank 1 stands by, answers the second and
    third regrow probes and is called back at step 5 (1 -> 2, the grown
    strategy searched from 18b's); held: the first 2 losses bit-equal to
    18b's run, steps 3-5 within 1e-6 of a run on a world of rank 0
    alone, re-formed from this one for it, resumed from the resize's
    checkpoint of step 2 under the shrunk strategy, steps 6-8 within
    1e-6 of a two-rank run resumed from the step-5 checkpoint under the
    grown strategy, the state the run saved after each migration held
    to a save no migration wrote (the shrink's to 18b's uninterrupted
    step-2 checkpoint, the grow's to the one-rank reference's step-5
    save; bit for bit or within 1e-6), rank 0's records in the order
    injected fault ->
    device_loss -> resize (shrink) -> device_return -> resize (grow),
    each resize's research_s, total_s and regrid_bytes logged, rank 1
    standing by from step 2 until its call at step 5, rank 0's launches
    of kernels 1-6 in each segment (steps 1-2 as 18b's, steps 3-5 those
    of the one-rank reference, on N = 8192 rows of the vocab head,
    steps 6-8 those of the two-rank reference, every kernel launched),
    and a run with ``--elastic`` and no fault bit-equal to 18b's first 2
    losses; the runs' seconds logged;
18g. the autoscaling service (ROADMAP Queue A item 6's rest), in 18b's
    two-gloo-rank world before its drained run: ``apps.serve gpt`` at
    full width under a gap-then-burst load (3 requests at 500 qps, then
    30 virtual seconds later 12 at 2000 qps, 2 new tokens) with
    ``--serve-idle-boundaries 3 --serve-queue-hi 3 --shrink-to 1``: one
    shrink 2 -> 1 and one grow 1 -> 2 (re-searched under the latency
    objective, rank 1 standing by and handed rank 0's session at the
    grow), 15 completed, none unserved or dropped, every rank's replies
    equal to the one-rank engine's in this process (on a mismatch the
    request, the position and the top-2 log-prob gap there), kernel 1
    launched on rank 0 12 times a step (its plain and partial forms
    together); each resize's research_s and total_s logged; on
    four cards the same over 19's four NCCL ranks, shrinking to 2;
19. on a machine with four cards (``torch.cuda.device_count() >= 4``):
    AlexNet over four ranks through ``torchrun --nproc-per-node 4``
    (NCCL, a card a rank), data parallel and a hybrid strategy, then the
    placement slice's three runs over four ranks (kernels 4-6 on 160
    rows), each held as the two-rank runs are, with sentences/s and
    images/s beside the one-card runs (the hybrid's halos of conv3-conv5,
    split over w, by NCCL point-to-point, their bytes logged); then the
    LM under phase 18b's strategy over four ranks (ring x data parallel
    attention, the heads split four ways, the head (4, 1)), its tokens/s
    beside the one-card run, and its checkpoint resume as 18b's, then
    18f's elastic run over the four NCCL ranks with
    ``device_loss@1x2,device_return@1`` and ``--print-freq 2``: 4 -> 2
    at step 2, 2 -> 4 at step 6, steps 3-6 within 1e-6 of a run on ranks
    0-1 re-formed for it and steps 7-8 of a four-rank run, each resumed
    from its resize's checkpoint, and the migrated states held as 18f's;
    the MoE
    LM with its blocks cycling (4, 1, 1), (2, 1, 2), (1, 2, 2) and the op
    probe under those grids, against phase 18c's one-rank run; the
    pipelined LM at 2 stages x 2 tp, at 4 stages and at phase 18d's
    proposed block (its best candidate, at the tp it chose), against
    phase 18d's reference, the pipeline probe at the first two, and the
    proposal's simulated steps logged beside the measured ones; then AlexNet
    searched for four cards by ``apps.search --measured`` (shard times
    from this card) and trained through ``torchrun --nproc-per-node 4``
    under the searched strategy and data parallel (a file of its
    entries whose ``__predicted__`` step is the search's
    ``dp_time_s``), 1 + 8 steps each with ``-obs-dir`` and
    ``--op-time-every 9``, the first 3 losses within 1e-4 of phase 17's
    one-rank run: the measured steps beside the simulated ones, each
    plan's drift loop as in 18e (no anchor kind is required: a grid
    without a clone times no shard of its kind), and the simulator's
    ranking logged beside the cards'; one card runs without this phase,
    and the log says so;
20. (``--profile``) where the device time of one decode step and of one
    training step of each trained model goes, and the device's idle
    share of each step, from the profiler's kernel rows and, without the
    profiler, from the step's time held behind a sleep kernel;
21. a ``kernels`` JSON line (the partial forms of kernels 1-6 under
    ``<name>.partial``, with rank 0's launches in phase 18b's two-rank
    run; kernel 1 on the serving paths of phases 8b, 18g, 12c, 8c and 8d
    under ``<name>.serve-disagg``, ``<name>.serve-scale``,
    ``<name>.serve-ranks``, ``<name>.serve-search`` and
    ``<name>.serve-search-ranks``, with the routed run's launches, rank
    0's, rank 0's in 12c's 2 + 2 pools, the searched artifact's
    service's and rank 0's; kernels 7f and 9 under
    ``<name>.serve-ranks``, rank 0's in 12c's DenseNet service; kernels
    2-3 under ``<name>.serve-search``, launched while 8c's search timed
    its shards), then, last, the ``ok`` JSON line.

Each phase logs its seconds, and the script its total.

Not run on the card: ``apps.searchscale`` (it touches no device; the
CPU tests hold it to the JAX sweep), and grids that do not factor over
the world's prime axes (every world this machine has, of 1, 2 or 4
ranks, factors every grid that fits it; the CPU tests train a (2, 3)
grid on 6 gloo ranks against JAX's run).

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
import os
import re
import shutil
import signal
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
# apps.lm --d-model 768 --heads 8 at the LM step's batch and sequence:
# head dim 96, which kernels 1-3 take zero-padded to 128
LM96_SHAPE = (16, 8, 512, 96)
# the pool kernels do the plain versions' float32 compares, and their
# float32 adds in the same order, cast once: they must agree exactly
POOL_ATOL = 0.0
# AlexNet's max-pool inputs at 224x224 (pool1-pool3; 3x3 stride 2 pad 0,
# fused ReLU), and the (n, h, w, c) blocks a rank pools under the strategy
# phase's strategies: the two-rank one splits them over the batch, the
# four-rank one pool1 and pool3 over the batch, pool2 over c and batch
ALEXNET_MAX_POOLS = [(55, 55, 64), (27, 27, 192), (13, 13, 256)]
ALEXNET_RANK_BLOCKS = [(32, 55, 55, 64), (32, 27, 27, 192),
                       (32, 13, 13, 256), (16, 55, 55, 64),
                       (32, 27, 27, 96), (16, 13, 13, 256)]
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
# path A: ResNet-101 trained from a JPEG tree this smoke writes (8 class
# directories, 3 batches of 64 at mixed sizes of 256-500 px), 1 warm-up +
# 5 timed steps, the stream two batches ahead on the DevicePrefetcher;
# the tree lies inside the checkout and is removed when the run ends
JPEG_CLASSES, JPEG_BATCHES, JPEG_SIDES = 8, 3, (256, 500)
JPEG_WARMUP, JPEG_TIMED = 1, 5
DATA_ROOT = Path(__file__).resolve().parent / ".chip_data"
# path B: the NMT under the runtime flags for 10 steps: async checkpoints
# every 5, a NaN loss at step 7 rolled back at the step-10 boundary to
# step 5, steps 6-10 run again
NMT_RUNTIME_ITERS, NMT_RUNTIME_CKPT = 10, 5
NMT_RUNTIME_FAULT = "loss_nan@7"
# path C: the kernels the LM's --trace-dir trace must name
TRACE_KERNELS = ("flash_fwd_kernel", "flash_bwd_dkv_kernel",
                 "flash_bwd_dq_kernel", "ce_fwd_kernel", "ce_bwd_dx_kernel",
                 "ce_bwd_dw_kernel")
# the NMT run: the JAX app's defaults (batch 64, 2 layers, seq 20 in
# chunks of 10, hidden and embed 2048, vocab 20480, float32, SGD lr 0.1)
NMT_WIDTHS = (64, 2, 20, 2048, 2048)   # batch, layers, seq, hidden, embed
NMT_VOCAB = 20480
NMT_CHUNKS = 2                          # decoder chunks: vocab heads a step
NMT_HEAD = (64 * 10, 2048, NMT_VOCAB)   # N, d, V of one chunk's vocab head
# token counts of the fused head's crossover sweep at the NMT head's d, V
CE_CROSSOVER_TOKENS = (160, 320, 640, 1280, 2560, 5120, 10240)
# the rows of one chunk's vocab head a rank holds when the NMT's batch
# splits over 2 and 4 ranks (the placement phases)
NMT_RANK_ROWS = (320, 160)
# the MoE run: the JAX app's MoE example (flexflow_tpu/apps/lm.py:10) at
# the LM run's GPT-2-small widths, 8 experts in every block, top-2,
# capacity factor 2.0 (256 slots per expert and sequence), aux weight
# 1e-2, checkpoints every 5 steps, rollback on divergence
MOE_EXPERTS = 8
# the MoE trainer runs 6 of the LM's 12 blocks (a depth cut): its
# checkpoint saves and restores dominate phase 16, and the whole smoke
# must end within 1200 s
MOE_WIDTHS = (6, 768, 12, 3072)
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
# the training runtime's supervision at the MoE widths: the async writer's
# run beside the synchronous one, and a drained run: a SIGTERM injected
# in step 7 drains at the step-10 boundary (print_freq 10, ckpt_freq 5)
# within the budget
MOE_DRAIN_FAULT = "preempt@7"
MOE_DRAIN_STEP = 10
DRAIN_BUDGET_S = 60.0
# the two-rank LM world's drained checkpoint, resumed by the next
# two-rank world (the MoE strategy phase's), removed there
DRAIN_ROOT = Path(__file__).resolve().parent / ".chip_drain"
# the step watchdog: the LM phase's widths, 1 + 4 steps, step 2 wedging
# the step-5 boundary past max(3 x the step estimate, 1 s)
WATCHDOG_STEPS = (1, 4)
WATCHDOG_FLAGS = ["--hang-factor", "3", "--hang-min-s", "1",
                  "--fault-spec", "step_hang@2"]
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
    from flexflow_tpu_torch.ops import kernels

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
        # head dim 96, zero-padded to 128 by the wrapper
        ("d=96 causal float32", (2, h, s, 96), s, True, "float32"),
        ("d=96 causal bfloat16", (2, h, s, 96), s, True, "bfloat16"),
        ("d=96 ragged S=77 causal float32", (2, h, 77, 96), 77, True,
         "float32"),
        ("d=96 ragged Sq=77 Sk=300 bfloat16", (2, h, 77, 96), 300, False,
         "bfloat16"),
    ]
    worst = 0.0
    for label, shape, sk, causal, dtype in cases:
        q, k, v = qkv(shape, sk, dtype)
        kernels_before = kernels.launches[fa.NAME]
        o, lse = fa.flash_attention_fwd(q, k, v, causal)
        if kernels.launches[fa.NAME] != kernels_before + 1:
            raise AssertionError(f"{label}: the kernel did not launch")
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
        for wide in ((2, h, s, 128), (2, h, s, 96)):
            q, k, v = qkv(wide, s, dtype)
            ms = _time_ms(torch, lambda: fa.flash_attention_fwd(q, k, v,
                                                                True))
            sdpa_ms = _time_ms(torch, lambda: torch.nn.functional
                               .scaled_dot_product_attention(q, k, v,
                                                             is_causal=True))
            bound_ms, bound_by = _bound_ms(wide, s, True, dtype)
            _log(f"kernel time {wide} causal {dtype}: kernel {ms:.4f} ms "
                 f"(with the wrapper's head-dim padding), sdpa "
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
        o, lse = fa.flash_attention_fwd(q, k, v, causal)
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
                   (2, 16, 77, 128), 300, False, dtype),
                  # head dim 96, zero-padded to 128 by the wrapper
                  (f"d=96 {LM96_SHAPE} causal {dtype}", LM96_SHAPE, s, True,
                   dtype),
                  (f"d=96 non-causal Sq=77 Sk=300 {dtype}", (2, h, 77, 96),
                   300, False, dtype)]
    worst = {fa.NAME_DKV: 0.0, fa.NAME_DQ: 0.0}
    for label, shape, sk, causal, dtype in cases:
        q, k, v, o, lse, do = inputs(shape, sk, causal, dtype)
        got = fa.flash_attention_bwd(q, k, v, o, lse, do, causal)
        again = fa.flash_attention_bwd(q, k, v, o, lse, do, causal)
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
    # head dim 96 through the padding wrapper, both kernels together
    for dtype in ("float32", "bfloat16"):
        q, k, v, o, lse, do = inputs(LM96_SHAPE, s, True, dtype)
        ms = _time_ms(torch, lambda: fa.flash_attention_bwd(
            q, k, v, o, lse, do, True), iters=20)
        qs, ks, vs = (t.detach().clone().requires_grad_() for t in (q, k, v))
        out = torch.nn.functional.scaled_dot_product_attention(
            qs, ks, vs, is_causal=True)
        sdpa_ms = _time_ms(torch, lambda: torch.autograd.grad(
            out, (qs, ks, vs), do.to(q.dtype), retain_graph=True), iters=20)
        bounds = _bwd_bounds(LM96_SHAPE, dtype)
        _log(f"flash bwd time {LM96_SHAPE} causal {dtype}: kernels 2+3 with "
             f"the wrapper's head-dim padding {ms:.4f} ms, bound "
             f"{bounds['dkv'][0] + bounds['dq'][0]:.4f} ms, sdpa backward "
             f"{sdpa_ms:.4f} ms")
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
            ("NMT head float32", NMT_HEAD, "float32"),
            *(("NMT head of a rank float32", (n,) + NMT_HEAD[1:],
               "float32") for n in NMT_RANK_ROWS)):
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
    # the rows a rank holds under placement (160, 320), the NMT's 640
    # tokens a chunk and more, against the unfused library pair: where the
    # fused head stops losing, if it loses at 640.  The kernels line takes
    # the first
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


def _ce_partial_inputs(torch, gen, n, d, v):
    """The vocab-parallel head's operands on rank 0 of two, float32: x,
    w, b of its V_local = ``v`` columns, labels drawn over both slices
    (every 512th -1, the causal shift's last position), so that about
    half lie above the slice, and the two cotangent rows: goh = g_nll =
    1/N, gp = g_nll + g_lse with g_lse = g_nll (exp(lse_c - lse) - 1),
    the combine's own form."""
    x, w, b, _, g = _ce_inputs(torch, gen, n, d, v, "float32")
    lab = torch.randint(0, 2 * v, (n,), generator=gen, device="cuda",
                        dtype=torch.int32)
    lab[511::512] = -1
    share = torch.rand((n,), generator=gen, device="cuda")
    return x, w, b, lab, g * share, g


def _fused_ce_times(torch, F, ce, gen, n, d, v, dtype,
                    partial: bool = False) -> dict:
    """Kernels 4 (with its combine), 5 (with its finishing sum) and 6 at
    one shape: times, plain and library times, bounds and achieved
    TFLOP/s.  With ``partial``, the vocab-slice form at V_local = ``v``
    (float32): kernels 5-6 take gp and goh (``_ce_partial_inputs``), and
    the library calls are ``addmm`` + ``logsumexp`` + the label gather,
    and their autograd under both cotangents."""
    if partial:
        x, w, b, lab, gp, goh = _ce_partial_inputs(torch, gen, n, d, v)
    else:
        x, w, b, lab, gp = _ce_inputs(torch, gen, n, d, v, dtype)
        goh = gp
    fwd_work = ce.fused_linear_ce_fwd_partial_cuda(x, w, b, lab)
    nll, lse = ce.fused_linear_ce_fwd_combine_cuda(fwd_work)
    work = ce.fused_linear_ce_bwd_dx_partial_cuda(x, w, b, lab, lse, gp,
                                                  goh)
    fwd_ms = _time_ms(torch, lambda: ce.fused_linear_ce_fwd_partial_cuda(
        x, w, b, lab), iters=5, warmup=1)
    combine_ms = _time_ms(torch, lambda: ce.fused_linear_ce_fwd_combine_cuda(
        fwd_work), iters=20)
    dx_ms = _time_ms(torch, lambda: ce.fused_linear_ce_bwd_dx_partial_cuda(
        x, w, b, lab, lse, gp, goh), iters=5, warmup=1)
    sum_ms = _time_ms(torch, lambda: ce.fused_linear_ce_bwd_dx_sum_cuda(
        work, n, d), iters=20)
    dw_ms = _time_ms(torch, lambda: ce.fused_linear_ce_bwd_dw_cuda(
        x, w, b, lab, lse, gp, goh), iters=5, warmup=1)
    plain_fwd_ms = _time_ms(torch, lambda: ce.fused_linear_ce_fwd_plain(
        x, w, b, lab), iters=5, warmup=1)
    plain_bwd_ms = _time_ms(torch, lambda: ce.fused_linear_ce_bwd_plain(
        x, w, b, lab, lse, gp, goh), iters=5, warmup=1)
    lab64 = lab.long()
    hit = (lab64 >= 0) & (lab64 < v)
    safe = torch.where(hit, lab64, 0)[:, None]

    def lib_fwd(xs, ws, bs):
        logits = torch.addmm(bs.to(xs.dtype), xs, ws)
        if not partial:
            return F.cross_entropy(logits, lab64, ignore_index=-1,
                                   reduction="none")
        lse = torch.logsumexp(logits, dim=1)
        corr = logits.gather(1, safe)[:, 0]
        return lse - torch.where(hit, corr, 0.0), lse

    lib_fwd_ms = _time_ms(torch, lambda: lib_fwd(x, w, b), iters=5,
                          warmup=1)
    xs, ws, bs = (t.detach().clone().requires_grad_() for t in (x, w, b))
    lib_out = lib_fwd(xs, ws, bs)
    if partial:
        # nll's cotangent goh, lse's gp - goh: t = gp softmax - goh onehot
        lib_outs, lib_gs = lib_out, (goh, gp - goh)
    else:
        lib_outs, lib_gs = (lib_out,), (gp.to(lib_out.dtype),)
    lib_bwd_ms = _time_ms(torch, lambda: torch.autograd.grad(
        lib_outs, (xs, ws, bs), lib_gs, retain_graph=True),
        iters=5, warmup=1)
    esize = x.element_size()
    inputs = n * d * esize + d * v * esize + v * 4 + n * 4
    rows = (3 if partial else 2) * n * 4    # lse and the cotangent rows
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
             inputs + rows + work.numel() * 4, mma_rate, plain_bwd_ms,
             lib_bwd_ms),
            (ce.NAME_DX_SUM, sum_ms, (work.shape[0] - 1.0) * n * d,
             work.numel() * 4 + n * d * 4, "float32", plain_bwd_ms,
             lib_bwd_ms),
            (ce.NAME_DW, dw_ms, 2 * flops,
             inputs + rows + d * v * 4 + v * 4, mma_rate, plain_bwd_ms,
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


# the partial forms of kernels 1-6 (ROADMAP Queue A 3c) at the shapes a
# rank of the LM phase's two-rank strategy gives them: one ring chunk of
# the attention (512 positions over 2 ranks) and one vocab slice of the
# head (32768 over 2 ranks)
RING_CHUNK = (16, 12, 256, 64)
CE_PARTIAL = (16 * 512, 768, 16384)


def _chunk_bwd_bounds(shape, sk, causal) -> dict:
    """(bound_ms, bound_by) of kernels 2 (8 d FLOPs per visible pair) and
    3 (6 d) on one float32 (B, H, Sq, d) x (B, H, Sk, d) call, at the
    3xTF32 rate."""
    b, h, sq, d = shape
    pairs = b * h * (sum(min(i + 1, sk) for i in range(sq)) if causal
                     else sq * sk)
    q_io, kv_io, rows = b * h * sq * d * 4, b * h * sk * d * 4, b * h * sq * 4
    ins = 2 * q_io + 2 * kv_io + 2 * rows       # q, do, k, v, lse, delta
    return {"dkv": _bound(8.0 * d * pairs, ins + 2 * kv_io, "3xtf32"),
            "dq": _bound(6.0 * d * pairs, ins + q_io, "3xtf32")}


def partial_phase(torch, fa, ce) -> dict:
    """The partial forms: ``flash_attention_partial`` (kernel 1's (o,
    lse), kernels 2-3 with the lse cotangent folded into delta) at a ring
    chunk, non-causal (a chunk before the queries') and causal (the
    diagonal), and ``fused_linear_ce_partial`` (kernels 4-6, 5-6 with two
    cotangent rows) at a vocab slice, each through its autograd function
    against the plain versions; then their times."""
    import torch.nn.functional as F

    gen = torch.Generator(device="cuda")
    gen.manual_seed(4)
    worst = {}
    for causal in (False, True):
        label = f"ring chunk {RING_CHUNK} x {RING_CHUNK[2]} keys " \
            f"{'causal' if causal else 'non-causal'} float32"
        q, k, vv = (torch.randn(RING_CHUNK, generator=gen, device="cuda")
                    .requires_grad_() for _ in range(3))
        o, lse = fa.flash_attention_partial(q, k, vv, causal)
        do = torch.randn(o.shape, generator=gen, device="cuda")
        g_lse = torch.randn(lse.shape, generator=gen, device="cuda")
        grads = torch.autograd.grad((o, lse), (q, k, vv), (do, g_lse))
        o, lse = o.detach(), lse.detach()
        torch.cuda.synchronize()
        qd, kd, vd = (t.detach() for t in (q, k, vv))
        o_p, lse_p = fa.flash_attention_fwd_plain(qd, kd, vd, causal)
        grads_p = fa.flash_attention_bwd_plain(qd, kd, vd, o_p, lse_p, do,
                                               causal, g_lse=g_lse)
        torch.cuda.synchronize()
        fwd_err = max(_max_err(torch, o, o_p), _max_err(torch, lse, lse_p))
        errs = {n: _rel_err(torch, g, w)
                for n, g, w in zip(("dq", "dk", "dv"), grads, grads_p)}
        _log(f"partial check {label}: o, lse max_abs_err {fwd_err:.3e} "
             f"(tolerance {KERNEL_ATOL:g}); g_lse nonzero: " + ", ".join(
                 f"{n} max_abs_err {e:.3e} ({r:.2e} of max)"
                 for n, (e, r) in errs.items())
             + f" (tolerance {GRAD_RTOL['float32']:g} of max)")
        if not (fwd_err <= KERNEL_ATOL and all(
                r <= GRAD_RTOL["float32"] for _, r in errs.values())):
            raise AssertionError(f"{label}: the partial form's kernels "
                                 f"disagree with the plain versions")
        for name, err in ((fa.NAME, fwd_err), (fa.NAME_DKV, max(
                errs["dk"][0], errs["dv"][0])), (fa.NAME_DQ, errs["dq"][0])):
            worst[name] = max(worst.get(name, 0.0), err)
        del q, k, vv, o, lse, grads, o_p, lse_p, grads_p

    n, d, v = CE_PARTIAL
    x, w, b, lab, gp, goh = _ce_partial_inputs(torch, gen, n, d, v)
    ts = [t.clone().requires_grad_() for t in (x, w, b)]
    nll, lse = ce.fused_linear_ce_partial(*ts, lab)
    grads = torch.autograd.grad((nll, lse), ts, (goh, gp - goh))
    nll, lse = nll.detach(), lse.detach()
    torch.cuda.synchronize()
    nll_p, lse_p = ce.fused_linear_ce_fwd_plain(x, w, b, lab)
    grads_p = ce.fused_linear_ce_bwd_plain(x, w, b, lab, lse_p, gp, goh)
    torch.cuda.synchronize()
    errs = {"nll": _rel_err(torch, nll, nll_p),
            "lse": _rel_err(torch, lse, lse_p)}
    errs.update({k: _rel_err(torch, a, c) for k, a, c in
                 zip(("dx", "dw", "db"), grads, grads_p)})
    out_of_slice = int(((lab < 0) | (lab >= v)).sum())
    _log(f"partial check vocab slice N {n}, d {d}, V_local {v} float32 "
         f"({out_of_slice} labels outside the slice, "
         f"{int((lab == -1).sum())} of them -1; gp != goh): " + ", ".join(
             f"{k} max_abs_err {e:.3e} ({r:.2e} of max)"
             for k, (e, r) in errs.items())
         + f" (tolerance {GRAD_RTOL['float32']:g} of max)")
    if not all(r <= GRAD_RTOL["float32"] for _, r in errs.values()):
        raise AssertionError(f"vocab slice: the partial form's kernels "
                             f"disagree with the plain versions: {errs}")
    for name in (ce.NAME_FWD, ce.NAME_FWD_COMBINE):
        worst[name] = max(errs["nll"][0], errs["lse"][0])
    for name in (ce.NAME_DX, ce.NAME_DX_SUM):
        worst[name] = errs["dx"][0]
    worst[ce.NAME_DW] = max(errs["dw"][0], errs["db"][0])
    del x, w, b, ts, nll, lse, grads, nll_p, lse_p, grads_p
    torch.cuda.empty_cache()

    # times: kernel 1 and kernels 2-3 (delta less g_lse) at the chunk,
    # both masks; the library forward is the efficient-attention call
    # that returns the lse too; no library call takes the lse cotangent
    timings = {}
    for causal in (False, True):
        q, k, vv = (torch.randn(RING_CHUNK, generator=gen, device="cuda")
                   for _ in range(3))
        o, lse = fa.flash_attention_fwd_cuda(q, k, vv, causal)
        do = torch.randn(o.shape, generator=gen, device="cuda")
        g_lse = torch.randn(lse.shape, generator=gen, device="cuda")
        delta = (do * o).sum(-1) - g_lse
        ms = _time_ms(torch, lambda: fa.flash_attention_fwd_cuda(q, k, vv,
                                                                 causal))
        plain_ms = _time_ms(torch, lambda: fa.flash_attention_fwd_plain(
            q, k, vv, causal), iters=20)
        lib_ms = _time_ms(torch, lambda: torch.ops.aten
                          ._scaled_dot_product_efficient_attention(
                              q, k, vv, None, True, 0.0, causal))
        bound_ms, bound_by = _bound_ms(RING_CHUNK, RING_CHUNK[2], causal,
                                       "float32")
        t = {fa.NAME: dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                           bound_ms=bound_ms, bound_by=bound_by)}
        dkv_ms = _time_ms(torch, lambda: fa.flash_attention_bwd_dkv_cuda(
            q, k, vv, do, lse, delta, causal), iters=20)
        dq_ms = _time_ms(torch, lambda: fa.flash_attention_bwd_dq_cuda(
            q, k, vv, do, lse, delta, causal), iters=20)
        plain_bwd_ms = _time_ms(torch, lambda: fa.flash_attention_bwd_plain(
            q, k, vv, o, lse, do, causal, g_lse=g_lse), iters=10)
        bounds = _chunk_bwd_bounds(RING_CHUNK, RING_CHUNK[2], causal)
        for name, key, kms in ((fa.NAME_DKV, "dkv", dkv_ms),
                               (fa.NAME_DQ, "dq", dq_ms)):
            t[name] = dict(ms=kms, plain_ms=plain_bwd_ms, library_ms=None,
                           bound_ms=bounds[key][0], bound_by=bounds[key][1])
        mask = "causal" if causal else "non-causal"
        for name, r in t.items():
            lib = "none" if r["library_ms"] is None \
                else f"{r['library_ms']:.4f} ms"
            _log(f"partial time {name} ring chunk {RING_CHUNK} {mask} "
                 f"float32: kernel {r['ms']:.4f} ms, plain "
                 f"{r['plain_ms']:.4f} ms, library {lib}, bound "
                 f"{r['bound_ms']:.4f} ms ({r['bound_by']}, "
                 f"{r['bound_ms'] / r['ms']:.1%} of it)")
        if not causal:
            timings.update(t)
        del q, k, vv, o, lse, do, g_lse, delta
    t = _fused_ce_times(torch, F, ce, gen, n, d, v, "float32", partial=True)
    for name, r in t.items():
        _log(f"partial time {name} vocab slice N {n} d {d} V_local {v} "
             f"float32: kernel {r['ms']:.4f} ms ({r['tflops']:.1f} "
             f"TFLOP/s), plain {r['plain_ms']:.4f} ms, library "
             f"{r['library_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms "
             f"({r['bound_by']}, {r['bound_ms'] / r['ms']:.1%} of it)")
    timings.update(t)
    torch.cuda.empty_cache()
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
    engine, requests, _, _ = serve.build_engine(opts, log=_log)
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
    # AlexNet (the strategy phase trains it in float32)
    cases += [(f"alexnet {h}x{w}x{c}", (64, h, w, c), 3, 0, True, dtype, ties,
               None, "vector")
              for (h, w, c) in ALEXNET_MAX_POOLS
              for dtype, ties in (("float32", False), ("float32", True),
                                  ("bfloat16", False))]
    cases += [("alexnet rank block", block, 3, 0, True, "float32", ties, None,
               "vector")
              for block in ALEXNET_RANK_BLOCKS for ties in (False, True)]
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
    if tag == "lm":
        _lm_profiled_run(torch, kernels, card, losses[:checked], widths)
    return {"launches": launches, "step_ms": step_ms, "peak_gb": peak_gb,
            "tokens_per_sec": tokens_per_sec, "loss": losses}


def _lm_profiled_run(torch, kernels, card: str, want_losses: list,
                     widths) -> None:
    """Path C: ``apps.lm --profiling --trace-dir`` at the LM phase's
    widths, 1 warm-up and 2 steps: the roofline line, a table row for
    every op with the attention and linear shards timed, the trace
    naming kernels 1-6, the losses bit-equal to the run without the
    flags."""
    import gc

    from flexflow_tpu_torch.apps import lm
    from flexflow_tpu_torch.machine import MachineModel
    from flexflow_tpu_torch.models.transformer import TransformerLM

    trace_dir = OBS_ROOT / "lm_trace"
    shutil.rmtree(trace_dir, ignore_errors=True)
    argv = _lm_argv(len(want_losses), 1, widths)
    lines = []
    gc.collect()
    torch.cuda.empty_cache()
    kernels.reset_launches()
    t0 = time.perf_counter()
    out = lm.main(argv + ["--profiling", "--trace-dir", str(trace_dir)],
                  log=lines.append)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = dict(kernels.launches)
    _log(f"lm profile: {len(want_losses)} steps with --profiling "
         f"--trace-dir in {seconds:.1f} s (the loop "
         f"{out['elapsed_s']:.3f} s timed); launches with the profiler's "
         f"shard runs {launches}")
    if out["loss"] != want_losses:
        raise AssertionError(f"lm profile losses {out['loss']} are not "
                             f"bit-equal to the run without the flags "
                             f"{want_losses}")
    _log(f"lm profile: losses {out['loss']} bit-equal to phase 9's first "
         f"{len(want_losses)}")
    roof = [line for line in lines if line.startswith("step roofline")]
    if len(roof) != 1:
        raise AssertionError(f"lm profile: no step roofline line in {lines}")
    _log(f"lm profile: {roof[0]} — {card}")
    table = lines[lines.index(roof[0]) + 1].splitlines()
    cfg = lm.parse_args(argv)[0]
    model = TransformerLM(cfg, MachineModel.virtual(1))
    kinds = {op.name: type(op).__name__ for op in model.layers}
    rows = table[1:-1]
    if [row.split()[0] for row in rows] != list(kinds):
        raise AssertionError(f"lm profile: the table's rows {rows} are not "
                             f"the model's ops {list(kinds)}")
    timed = [row for row in rows
             if kinds[row.split()[0]] in ("MultiHeadAttention", "RnnLinear")]
    estimated = [row for row in timed if "~" in row]
    if not timed or estimated:
        raise AssertionError(f"lm profile: attention and linear shards "
                             f"estimated, not timed: {estimated}")
    top = sorted(rows, key=lambda r: -float(r.split()[-4].lstrip("~")))
    for row in [table[0]] + top[:12] + [table[-1]]:
        _log(f"lm profile table: {row}")
    (path,) = trace_dir.glob("trace_*.json")
    events = json.loads(path.read_text())["traceEvents"]
    found = {}
    for e in events:
        for k in TRACE_KERNELS:
            if k in str(e.get("name", "")):
                n, us = found.get(k, (0, 0.0))
                found[k] = (n + 1, us + float(e.get("dur", 0.0)))
    _log(f"lm trace: {path.name}, {path.stat().st_size / 1e6:.1f} MB, "
         f"{len(events)} events; kernel events (count, summed us) {found}")
    missing = [k for k in TRACE_KERNELS if k not in found]
    if missing:
        raise AssertionError(f"lm trace names no launch of {missing}")
    shutil.rmtree(trace_dir, ignore_errors=True)
    del out
    gc.collect()
    torch.cuda.empty_cache()


# the drift loop's LM run (ROADMAP Queue A item 4 (i)): apps.lm at the LM
# phase's widths, 1 warm-up and 4 steps, with the run telemetry and every
# second step sampled; its losses against the LM phase's (unsampled)
LM_OBS_WARMUP, LM_OBS_STEPS, LM_OBS_EVERY = 1, 4, 2
LM_OBS_RTOL = 1e-6
OBS_ROOT = Path(__file__).resolve().parent / ".chip_obs"


def _obs_records(path) -> list:
    from flexflow_tpu_torch import obs

    return list(obs.read_run(str(path)))


def _op_records(records) -> list:
    return [r for r in records if r["kind"] == "op_time"
            and r["scope"] == "op"]


def _log_sections(label: str, records) -> None:
    for r in records:
        if r["kind"] == "op_time" and r["scope"] == "section":
            _log(f"{label}: step {r['step']} {r['section']} "
                 f"{r['seconds'] * 1e3:.3f} ms")


def lm_obs_phase(torch, kernels, card: str, lm_run: dict) -> dict:
    """``apps.lm`` at the LM phase's widths with ``-obs-dir`` and
    ``--op-time-every 2`` (1 warm-up and 4 steps): the fit records, each
    sampled step's sections, one shard of every op timed alone; the
    op-scope records name every op of the model, kernels 1-3 launch
    while the shards are timed (the attention's), the losses equal the
    LM phase's unsampled run's within 1e-6 relative, and the run without
    a strategy says why it has no sim_drift."""
    import gc
    import shutil

    from flexflow_tpu_torch.apps import lm
    from flexflow_tpu_torch.machine import MachineModel
    from flexflow_tpu_torch.model import FFModel
    from flexflow_tpu_torch.models.transformer import TransformerLM
    from flexflow_tpu_torch.ops.kernels import flash_attention as fa

    shutil.rmtree(OBS_ROOT, ignore_errors=True)
    iters = LM_OBS_WARMUP + LM_OBS_STEPS
    argv = _lm_argv(iters, LM_OBS_WARMUP) + [
        "-obs-dir", str(OBS_ROOT), "-run-id", "lm", "--op-time-every",
        str(LM_OBS_EVERY)]
    emit = FFModel._emit_op_times
    timed = {}

    def counted(self, olog, samples):
        before = dict(kernels.launches)
        t = time.perf_counter()
        emit(self, olog, samples)
        torch.cuda.synchronize()
        timed["seconds"] = time.perf_counter() - t
        timed["launches"] = {k: v - before.get(k, 0)
                             for k, v in kernels.launches.items()
                             if v - before.get(k, 0)}

    gc.collect()
    torch.cuda.empty_cache()
    FFModel._emit_op_times = counted
    try:
        t = time.perf_counter()
        out = lm.main(argv, log=_log)
        seconds = time.perf_counter() - t
        records = _obs_records(out["obs_path"])
        ops = _op_records(records)
        names = [op.name for op in TransformerLM(
            lm.parse_args(argv)[0], MachineModel.virtual(1)).layers]
        measured = [r for r in ops if r["measured"]]
        _log(f"lm obs: {iters} steps in {seconds:.1f} s, {len(records)} "
             f"records to {out['obs_path']}; {len(ops)} ops timed alone in "
             f"{timed['seconds']:.2f} s ({len(measured)} measured, the rest "
             f"the analytic stand-in), launches while timing them "
             f"{timed['launches']}; {card}")
        _log_sections("lm obs", records)
        for r in sorted(measured, key=lambda r: -r["seconds"])[:6]:
            _log(f"lm obs: {r['op']} ({r['op_kind']}, grid {r['grid']}) "
                 f"{r['seconds'] * 1e3:.3f} ms forward + gradient alone")
        if [r["op"] for r in ops] != names:
            raise AssertionError(f"lm obs: op records {[r['op'] for r in ops]}"
                                 f" do not name the model's ops {names}")
        want = (fa.NAME, fa.NAME_DKV, fa.NAME_DQ)
        if not all(timed["launches"].get(k, 0) > 0 for k in want):
            raise AssertionError(f"lm obs: timing the shards launched "
                                 f"{timed['launches']}, want each of {want}")
        steps = sorted({r["step"] for r in records
                        if r["kind"] == "op_time"
                        and r["scope"] == "section"})
        if steps != list(range(LM_OBS_EVERY, iters + 1, LM_OBS_EVERY)):
            raise AssertionError(f"lm obs: sampled steps {steps}")
        (un,) = [r for r in records if r["kind"] == "sim_drift_unavailable"]
        if "no strategy" not in un["reason"]:
            raise AssertionError(f"lm obs: {un}")
        got, ref = out["loss"], lm_run["loss"][:iters]
        rel = max(abs(a - b) / max(abs(b), 1e-30) for a, b in zip(got, ref))
        _log(f"lm obs: losses {got} vs the LM phase's unsampled {ref}: max "
             f"relative difference {rel:.3e} (tolerance {LM_OBS_RTOL:g})")
        if not (len(got) == iters and rel <= LM_OBS_RTOL):
            raise AssertionError(f"lm obs: sampled losses {got} differ from "
                                 f"{ref}")
        return {"ops": len(ops), "launches": timed["launches"]}
    finally:
        FFModel._emit_op_times = emit
        shutil.rmtree(OBS_ROOT, ignore_errors=True)
        gc.collect()
        torch.cuda.empty_cache()


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
    res = {"launches": launches, "step_ms": step_ms, "peak_gb": peak_gb,
           "images_per_sec": images_per_sec}
    if model == "resnet101":
        res["jpeg"] = _jpeg_run(torch, kernels, card, res)
    return res


class _FirstBatch:
    """An input stream that keeps a host copy of its first batch."""

    def __init__(self, it):
        self.it, self.first = it, None

    def __iter__(self):
        return self

    def __next__(self):
        batch = next(self.it)
        if self.first is None:
            self.first = tuple(t.detach().cpu() for t in batch)
        return batch

    def close(self):
        self.it.close()


def _write_jpeg_tree(root: Path, classes: int, per_class: int) -> int:
    """An ImageNet-style ``train/`` tree of seeded JPEGs (smooth content,
    upsampled from a coarse random grid) at mixed sizes; the file count."""
    import numpy as np
    from PIL import Image

    rng = np.random.RandomState(0)
    lo, hi = JPEG_SIDES
    for c in range(classes):
        d = root / "train" / f"class{c:02d}"
        d.mkdir(parents=True)
        for i in range(per_class):
            h, w = (int(v) for v in rng.randint(lo, hi + 1, size=2))
            coarse = rng.randint(0, 256, size=(h // 16 + 1, w // 16 + 1, 3),
                                 dtype=np.uint8)
            Image.fromarray(coarse).resize((w, h), Image.BILINEAR).save(
                d / f"{i:03d}.jpg", quality=90)
    return classes * per_class


def _jpeg_run(torch, kernels, card: str, synthetic: dict) -> dict:
    """Path A: ``apps.cnn resnet101 -d <tree>`` through kernels 7, 7f and
    8, its input batch held against the plain PIL decode."""
    import gc

    from flexflow_tpu_torch.apps import cnn
    from flexflow_tpu_torch.data import native
    from flexflow_tpu_torch.data.imagenet import (ImageDataset,
                                                  decode_batch_pil)
    from flexflow_tpu_torch.ops.kernels import avgpool as ap
    from flexflow_tpu_torch.ops.kernels import maxpool as mp

    shutil.rmtree(DATA_ROOT, ignore_errors=True)
    t0 = time.perf_counter()
    n = _write_jpeg_tree(DATA_ROOT, JPEG_CLASSES,
                         JPEG_BATCHES * RESNET_VGG_BATCH // JPEG_CLASSES)
    size = sum(f.stat().st_size for f in DATA_ROOT.rglob("*.jpg"))
    _log(f"resnet101 jpeg: wrote {n} JPEGs ({size / 1e6:.1f} MB, "
         f"{JPEG_SIDES[0]}-{JPEG_SIDES[1]} px) in "
         f"{time.perf_counter() - t0:.2f} s")
    lib = native.load_lib()
    want_decoder = "native" if lib is not None else "pil"
    _log(f"resnet101 jpeg: native loader "
         + ("built" if lib is not None else
            f"unavailable ({native.last_error()})")
         + f"; expecting the {want_decoder} decoder")
    recorded = {}
    make_data = cnn.make_data

    def recording(*args, **kwargs):
        recorded["stream"] = _FirstBatch(make_data(*args, **kwargs))
        return recorded["stream"]

    lines = []

    def log(msg):
        lines.append(msg)
        _log(msg)

    iters = JPEG_WARMUP + JPEG_TIMED
    gc.collect()
    torch.cuda.empty_cache()
    kernels.reset_launches()
    cnn.make_data = recording
    try:
        out = cnn.main(_train_argv(RESNET_VGG_BATCH, iters, JPEG_WARMUP,
                                   "resnet101")
                       + ["-d", str(DATA_ROOT), "--prefetch-depth", "2"],
                       log=log)
    finally:
        cnn.make_data = make_data
    torch.cuda.synchronize()
    launches = dict(kernels.launches)
    stream = recorded["stream"].it
    named = [line for line in lines if line.startswith(
        "data: imagenet decoder ")]
    if stream.decoder != want_decoder or not named \
            or not named[0].startswith(f"data: imagenet decoder "
                                       f"{want_decoder} ({n} samples, "
                                       f"{JPEG_CLASSES} classes"):
        raise AssertionError(f"resnet101 jpeg: decoder {stream.decoder}, "
                             f"logged {named}; expected {want_decoder}")
    want = {k: iters for k in (mp.NAME_FWD, mp.NAME_BWD, ap.NAME)}
    if launches != want:
        raise AssertionError(f"resnet101 jpeg kernels launched {launches}, "
                             f"expected {want} (as the synthetic run, per "
                             f"step)")
    losses = out["loss"]
    if len(losses) != iters or not all(math.isfinite(v) for v in losses):
        raise AssertionError(f"resnet101 jpeg losses {losses}")
    ds = ImageDataset(str(DATA_ROOT))
    ds.shuffle_samples(0)
    labels, files = ds.get_samples(RESNET_VGG_BATCH)
    t0 = time.perf_counter()
    plain = torch.from_numpy(decode_batch_pil(files, 224, 224))
    plain_s = time.perf_counter() - t0
    img, lbl = recorded["stream"].first
    err = float((img - plain).abs().max())
    if lbl.tolist() != labels or (want_decoder == "pil" and err != 0.0):
        raise AssertionError(f"resnet101 jpeg: the first batch differs "
                             f"from the plain decode of its files (labels "
                             f"{lbl.tolist() == labels}, max |diff| {err})")
    _log(f"resnet101 jpeg: first batch ({tuple(img.shape)}) against the "
         f"plain PIL decode of its {len(files)} files: labels equal, max "
         f"|diff| {err:.3e} ({want_decoder} decoder; the plain decode "
         f"took {plain_s:.3f} s)")
    _log(f"resnet101 jpeg: losses {losses}")
    _log(f"resnet101 jpeg: {out['images_per_sec']:.2f} images/s, "
         f"input_stall_s {out['input_stall_s']:.3f} over {JPEG_TIMED} timed "
         f"steps, {out['elapsed_s'] / JPEG_TIMED * 1e3:.2f} ms per step, "
         f"decoder {stream.decoder}; the synthetic run "
         f"{synthetic['images_per_sec']:.2f} images/s, "
         f"{synthetic['step_ms']:.2f} ms per step (input_stall_s 0.0, "
         f"batches on the card) — {card}")
    shutil.rmtree(DATA_ROOT, ignore_errors=True)
    res = {"images_per_sec": out["images_per_sec"], "launches": launches,
           "input_stall_s": out["input_stall_s"], "decoder": stream.decoder}
    del out
    gc.collect()
    torch.cuda.empty_cache()
    return res


def _nmt_argv(iters: int, warmup: int, device: str = "cuda") -> list:
    batch, layers, seq, hidden, embed = NMT_WIDTHS
    return ["-b", str(batch), "-l", str(layers), "-s", str(seq), "-h",
            str(hidden), "-e", str(embed), "--vocab", str(NMT_VOCAB), "-i",
            str(iters), "--warmup", str(warmup)] \
        + (["--device", device] if device else [])


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
    del ref
    gc.collect()
    torch.cuda.empty_cache()
    _nmt_runtime_run(torch, kernels, card, losses)
    return {"launches": launches, "step_ms": step_ms, "peak_gb": peak_gb,
            "sentences_per_sec": sentences_per_sec, "loss": losses}


def _nmt_runtime_run(torch, kernels, card: str, healthy: list) -> None:
    """Path B: ``apps.nmt`` under the runtime flags, one injected NaN loss
    rolled back; the records' order, the losses before the bad window,
    the final checkpoint, kernels 4-6 per step run."""
    import gc

    from flexflow_tpu_torch import obs
    from flexflow_tpu_torch.apps import nmt
    from flexflow_tpu_torch.ops.kernels import fused_ce as ce
    from flexflow_tpu_torch.utils import checkpoint as ckpt

    root = MOE_CKPT_ROOT / "nmt"
    shutil.rmtree(root, ignore_errors=True)
    d, obs_dir, prom = root / "ckpt", root / "obs", root / "metrics.prom"
    argv = _nmt_argv(NMT_RUNTIME_ITERS, 1) + [
        "--ckpt-dir", str(d), "--ckpt-freq", str(NMT_RUNTIME_CKPT),
        "--ckpt-async", "--on-divergence", "rollback", "--fault-spec",
        NMT_RUNTIME_FAULT, "-obs-dir", str(obs_dir), "-metrics-path",
        str(prom)]
    kernels.reset_launches()
    t0 = time.perf_counter()
    out = nmt.main(argv, log=_log)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = dict(kernels.launches)
    steps = NMT_RUNTIME_ITERS + (NMT_RUNTIME_ITERS - NMT_RUNTIME_CKPT)
    want = {name: NMT_CHUNKS * steps
            for name in (ce.NAME_FWD, ce.NAME_FWD_COMBINE, ce.NAME_DX,
                         ce.NAME_DX_SUM, ce.NAME_DW)}
    if launches != want:
        raise AssertionError(f"nmt runtime kernels launched {launches}, "
                             f"expected {want} ({NMT_CHUNKS} a step for the "
                             f"{steps} steps run)")
    losses = out["loss"]
    if out["rollbacks"] != 1 or len(losses) != NMT_RUNTIME_ITERS \
            or not all(math.isfinite(v) for v in losses):
        raise AssertionError(f"nmt runtime: {out['rollbacks']} rollbacks, "
                             f"losses {losses}")
    if losses[:NMT_RUNTIME_CKPT] != healthy[:NMT_RUNTIME_CKPT]:
        raise AssertionError(f"nmt runtime: losses {losses} before the bad "
                             f"window differ from the healthy run's "
                             f"{healthy[:NMT_RUNTIME_CKPT]}")
    records = list(obs.read_run(out["obs_path"]))

    def first(kind, **match):
        for i, e in enumerate(records):
            if e["kind"] == kind and all(e.get(k) == v
                                         for k, v in match.items()):
                return i
        raise AssertionError(f"nmt runtime: no {kind} {match} record")

    order = [first("fault", source="injected", fault="loss_nan"),
             first("fault", source="guard", fault="loss_divergence"),
             first("rollback"),
             first("recovery", source="guard", after="rollback")]
    if order != sorted(order):
        raise AssertionError(f"nmt runtime: records out of order {order}")
    last = ckpt.latest_step(str(d))
    ok, why = ckpt.verify_checkpoint(str(d), last)
    if last != NMT_RUNTIME_ITERS or not ok or not prom.exists():
        raise AssertionError(f"nmt runtime: final checkpoint step {last} "
                             f"({why}); metrics written {prom.exists()}")
    rollback = records[order[2]]
    commits = (out.get("ckpt_async") or {}).get("commits")
    rerun = steps - NMT_RUNTIME_ITERS
    _log(f"nmt runtime: {NMT_RUNTIME_ITERS} steps + {rerun} re-run after "
         f"the rollback "
         f"{rollback.get('from_step')} -> {rollback.get('to_step')}, "
         f"{seconds:.1f} s in all; losses {losses}; first "
         f"{NMT_RUNTIME_CKPT} bit-equal to phase 15's; records "
         f"fault -> rollback -> recovery; final checkpoint {last} verified; "
         f"launches {launches}")
    _log(f"nmt runtime: boundary seconds: checkpoint_s "
         f"{out['checkpoint_s']:.3f} (the async snapshot on the boundary), "
         f"final_save_s {out['final_save_s']:.3f}, restore_s "
         f"{out['restore_s']:.3f} (the rollback's wait and restore); async "
         f"commits (step, s) {commits}; {out['sentences_per_sec']:.2f} "
         f"sentences/s in the timed window — {card}")
    shutil.rmtree(root, ignore_errors=True)
    del out
    gc.collect()
    torch.cuda.empty_cache()


def _moe_argv(iters: int, warmup: int, ckpt_dir=None, *extra) -> list:
    argv = _lm_argv(iters, warmup, MOE_WIDTHS) + ["--experts",
                                                  str(MOE_EXPERTS)]
    if ckpt_dir is not None:
        argv += ["--ckpt-dir", str(ckpt_dir), "--ckpt-freq",
                 str(MOE_CKPT_FREQ), "--on-divergence", "rollback"]
    return argv + list(extra)


def _moe_steps(torch, timed: int) -> dict:
    """``timed`` steps of the MoE model, each timed by CUDA events, with
    each step's aux loss and dropped share (mean over its blocks) from
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


def _ckpt_digests(d: Path, step: int) -> dict:
    """The SHA-256 of each file of a committed step, from its
    ``meta.json``: two saves of the same state write the same bytes
    (``np.savez`` stamps every member with one fixed date)."""
    return json.loads((d / f"step_{step:08d}" / "meta.json").read_text()
                      )["digests"]


def _through_commit(out: dict) -> float:
    """An ``apps.lm`` run's tokens/s over its timed window and the final
    save after it, the wait for the last commit included: the rate that
    counts every write of the run."""
    tokens = out["tokens_per_sec"] * out["elapsed_s"]
    return tokens / (out["elapsed_s"] + out["final_save_s"])


def _median(xs):
    xs = sorted(xs)
    return xs[len(xs) // 2] if xs else float("nan")


def _moe_async_run(torch, kernels, card: str, sync: dict) -> dict:
    """The MoE run again with the training runtime's supervision on
    (``--ckpt-async``, the live metrics, the obs stream, the watchdog at
    20 x the step, at least 60 s): its losses within ``MOE_RESUME_RTOL``
    of the synchronous run's (bit-equal or not, logged), its step-5, -10
    and final checkpoints verified and, where the losses are bit-equal,
    byte-equal to the synchronous run's (SHA-256), its launches of kernels 1-6
    the synchronous run's, its boundary seconds and rate beside the
    synchronous run's, the writer's submit-to-commit seconds, the host
    step times during a write and outside one; the metrics finite (mfu
    and the peak memory among them), the ``step_budget`` sound, the fit
    trace's counter lanes valid."""
    import gc
    import shutil

    from flexflow_tpu_torch.apps import lm
    from flexflow_tpu_torch.obs.budget import check_budget
    from flexflow_tpu_torch.obs.metrics import read_textfile
    from flexflow_tpu_torch.obs.trace import (chrome_trace, fit_trace_events,
                                              validate_trace)
    from flexflow_tpu_torch.utils import checkpoint as ckpt

    iters = LM_WARMUP + LM_TIMED
    d = MOE_CKPT_ROOT / "async"
    prom = MOE_CKPT_ROOT / "metrics" / "metrics.prom"
    obs_dir = MOE_CKPT_ROOT / "obs"
    gc.collect()
    torch.cuda.empty_cache()
    kernels.reset_launches()
    out = lm.main(_moe_argv(iters, LM_WARMUP, d, "--ckpt-async",
                            "-metrics-path", str(prom), "-obs-dir",
                            str(obs_dir), "-run-id", "moe-async",
                            "--hang-factor", "20", "--hang-min-s", "60"),
                  log=_log)
    torch.cuda.synchronize()
    launches = dict(kernels.launches)
    if launches != sync["launches"]:
        raise AssertionError(f"moe async: launches {launches}, the "
                             f"synchronous run's {sync['launches']}")
    losses = out["loss"]
    rel = max(abs(a - c) / max(abs(c), 1e-30)
              for a, c in zip(losses, sync["loss"]))
    how = "bit-equal to" if losses == sync["loss"] \
        else f"within {rel:.3e} of"
    _log(f"moe async: losses {how} the synchronous run's (tolerance "
         f"{MOE_RESUME_RTOL:g})")
    if len(losses) != iters or not rel <= MOE_RESUME_RTOL:
        raise AssertionError(f"moe async losses {losses} vs "
                             f"{sync['loss']}")
    for step in (MOE_CKPT_FREQ, 2 * MOE_CKPT_FREQ, iters):
        ok, why = ckpt.verify_checkpoint(str(d), step)
        got, want = _ckpt_digests(d, step), sync["digests"][step]
        _log(f"moe async: step {step} checkpoint verifies ({why}); SHA-256 "
             f"{'equal to' if got == want else 'differs from'} the "
             f"synchronous save's (arrays.npz {got['arrays.npz'][:12]} vs "
             f"{want['arrays.npz'][:12]})")
        if not ok or (losses == sync["loss"] and got != want):
            raise AssertionError(f"moe async: step {step} checkpoint: "
                                 f"{why}, digests {got} vs {want}")
    info = out["ckpt_async"]
    commits = [(step, round(sec, 3)) for step, sec in info["commits"]]
    # the host's step times (no sync): a step that ended while a write ran
    # against one that did not, each without the warm-up and the steps
    # right after a boundary (whose time holds the boundary's)
    after = {1} | {b + 1 for b in (MOE_CKPT_FREQ, 2 * MOE_CKPT_FREQ)}
    timed = range(LM_WARMUP + 1, iters + 1)
    busy = [info["step_s"][s - 1] * 1e3 for s in timed
            if s in info["busy_steps"] and s not in after]
    idle = [info["step_s"][s - 1] * 1e3 for s in timed
            if s not in info["busy_steps"] and s not in after]
    commit_tps = _through_commit(out)
    _log(f"moe async: {out['tokens_per_sec']:.1f} tokens/s in the timed "
         f"window (synchronous {sync['tokens_per_sec']:.1f}: "
         f"{out['tokens_per_sec'] / sync['tokens_per_sec']:.3f}x); "
         f"{commit_tps:.1f} through the final save's commit, "
         f"{out['final_save_s']:.3f} s after the loop (synchronous "
         f"{sync['commit_tps']:.1f}, {sync['final_save_s']:.3f} s: "
         f"{commit_tps / sync['commit_tps']:.3f}x) — {card}")
    _log(f"moe async: the boundaries' checkpoint "
         f"seconds in the timed window {out['checkpoint_s']:.3f} s "
         f"(synchronous {sync['checkpoint_s']:.3f} s); submit-to-commit "
         f"(step, s) {commits}; steps ending during a write "
         f"{info['busy_steps']}: host step {_median(busy):.2f} ms median "
         f"of {len(busy)}, outside one {_median(idle):.2f} ms of "
         f"{len(idle)} — {card}")
    gauges = read_textfile(str(prom))
    for key in ("mfu", "hbm_peak_bytes", "hbm_live_bytes",
                "throughput_items_per_sec", "steps_total"):
        if not math.isfinite(gauges.get(key, math.nan)):
            raise AssertionError(f"moe async: gauge {key} missing or not "
                                 f"finite: {gauges}")
    _log(f"moe async: metrics mfu {gauges['mfu']:.4f} (the H100's float32 "
         f"peak, 67 TFLOP/s), peak memory "
         f"{gauges['hbm_peak_bytes'] / 1e9:.2f} GB, steps "
         f"{gauges['steps_total']:.0f}, faults {gauges['faults_total']:.0f}")
    records = _obs_records(out["obs_path"])
    (budget,) = [r for r in records if r["kind"] == "step_budget"]
    if check_budget(budget):
        raise AssertionError(f"moe async: step_budget {check_budget(budget)}")
    _log(f"moe async: step_budget of a {budget['step_wall_s'] * 1e3:.2f} ms "
         f"step (ms): " + ", ".join(f"{k} {v * 1e3:.3f}" for k, v in
                                    budget["buckets"].items()))
    trace = chrome_trace(fit_trace_events(records))
    lanes = {e["name"] for e in trace["traceEvents"] if e.get("ph") == "C"}
    if validate_trace(trace) or not {"imgs/s", "MFU", "HBM bytes"} <= lanes:
        raise AssertionError(f"moe async: trace {validate_trace(trace)}, "
                             f"counter lanes {lanes}")
    res = {"loss": losses, "tokens_per_sec": out["tokens_per_sec"],
           "commit_tps": commit_tps,
           "checkpoint_s": out["checkpoint_s"], "commits": commits,
           "busy_ms": _median(busy), "idle_ms": _median(idle),
           "launches": launches, "mfu": gauges["mfu"]}
    del out
    shutil.rmtree(d, ignore_errors=True)
    return res


def _moe_drain_start(torch) -> dict:
    """Start ``apps.lm`` at the MoE widths as a subprocess (a session of
    its own) with ``--ckpt-async --fault-spec preempt@7``; it runs beside
    the phase's divergence run, whose time is not measured.
    :func:`_moe_drain_finish` reads it."""
    import gc

    iters = LM_WARMUP + LM_TIMED
    d = MOE_CKPT_ROOT / "drain"
    obs_dir = MOE_CKPT_ROOT / "drain_obs"
    gc.collect()
    torch.cuda.empty_cache()
    argv = _moe_argv(iters, LM_WARMUP, d, "--ckpt-async", "--fault-spec",
                     MOE_DRAIN_FAULT, "--drain-budget-s",
                     str(DRAIN_BUDGET_S), "-obs-dir", str(obs_dir),
                     "-run-id", "moe-drain")
    proc = subprocess.Popen(
        [sys.executable, "-m", "flexflow_tpu_torch.apps.lm"] + argv,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        start_new_session=True, cwd=str(Path(__file__).resolve().parent))
    return {"proc": proc, "dir": d, "obs": obs_dir,
            "t": time.perf_counter()}


def _moe_drain_finish(drain: dict, card: str) -> Path:
    """The drained subprocess: it exits 0 with one ``preempt_drain``
    record (mode ``async``, step 10, within the budget) and the step-10
    checkpoint verified; returns the checkpoint directory."""
    from flexflow_tpu_torch.utils import checkpoint as ckpt

    proc, d = drain["proc"], drain["dir"]
    try:
        out, err = proc.communicate(timeout=600)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        proc.communicate()
        raise AssertionError("moe drain: apps.lm ran past 600 s and was "
                             "stopped") from None
    seconds = time.perf_counter() - drain["t"]
    lines = out.splitlines()
    if proc.returncode != 0:
        raise AssertionError(f"moe drain: apps.lm exited "
                             f"{proc.returncode}:\n{err[-3000:]}")
    drains = [r for r in _obs_records(drain["obs"] / "moe-drain.jsonl")
              if r["kind"] == "preempt_drain"]
    told = [line for line in lines if line.startswith(("drain:",
                                                       "drained at"))]
    _log(f"moe drain: {MOE_DRAIN_FAULT}, exit 0 after {seconds:.1f} s "
         f"(the process's start included, beside the resume and the "
         f"divergence run); "
         f"{told}; records {drains} — {card}")
    if len(drains) != 1:
        raise AssertionError(f"moe drain: {len(drains)} preempt_drain "
                             f"records")
    (rec,) = drains
    if (rec["step"], rec["ckpt_step"], rec["mode"]) != \
            (MOE_DRAIN_STEP, MOE_DRAIN_STEP, "async") \
            or not rec["seconds"] <= rec["budget_s"] == DRAIN_BUDGET_S \
            or f"drained at iteration {MOE_DRAIN_STEP}; exiting 0 (resume " \
               f"from --ckpt-dir to continue)" not in lines:
        raise AssertionError(f"moe drain: {rec}, {told}")
    ok, why = ckpt.verify_checkpoint(str(d), MOE_DRAIN_STEP)
    if not ok or ckpt.latest_step(str(d)) != MOE_DRAIN_STEP:
        raise AssertionError(f"moe drain: checkpoint "
                             f"{ckpt._list_steps(str(d))}: {why}")
    return d


def _moe_resume(torch, d: Path, step: int, losses: list, label: str):
    """A fresh run from the step-``step`` checkpoint under ``d``, batches
    through the prefetcher, repeats the uninterrupted run's steps after
    it within ``MOE_RESUME_RTOL``."""
    import gc

    from flexflow_tpu_torch.apps import lm

    iters = LM_WARMUP + LM_TIMED
    lines = []
    res = lm.main(_moe_argv(iters, LM_WARMUP, d, "--prefetch-depth", "2"),
                  log=lines.append)
    if f"resumed from {d} at iteration {step}" not in lines:
        raise AssertionError(f"{label} did not resume: {lines}")
    got, want_l = res["loss"], losses[step:]
    rel = max(abs(a - c) / max(abs(c), 1e-30) for a, c in zip(got, want_l))
    _log(f"{label}: steps {step + 1}-{iters} from the step-{step} "
         f"checkpoint (prefetch depth 2) {got} vs the uninterrupted run: "
         f"max rel diff {rel:.3e} (tolerance {MOE_RESUME_RTOL:g}); input "
         f"stall {res['input_stall_s']:.4f} s; restore "
         f"{res['restore_s']:.2f} s")
    if len(got) != iters - step or not rel <= MOE_RESUME_RTOL:
        raise AssertionError(f"the {label} run differs: {got} vs {want_l}")
    del res
    gc.collect()
    torch.cuda.empty_cache()


def moe_phase(torch, kernels, card: str) -> dict:
    """``apps.lm --experts 8`` at full width with checkpoints every 5
    steps and rollback on divergence, through kernels 1-6; its first
    losses against the plain-kernel run; its steps by CUDA events with
    the aux loss and the dropped share; then the runtime: a resume from
    the step-5 checkpoint (with the prefetcher) repeats the run's losses,
    a NaN loss at step 7 rolls back to step 5 and the run finishes, and
    a corrupted last checkpoint makes the restore fall back.  Then the
    supervision: the run again with the async writer and the live
    metrics (:func:`_moe_async_run`), and a drained subprocess
    (:func:`_moe_drain_start`, run beside the resume and the divergence
    run) resumed from its step-10 checkpoint."""
    import gc
    import shutil
    import warnings

    from flexflow_tpu_torch.apps import lm
    from flexflow_tpu_torch.ops.kernels import flash_attention as fa
    from flexflow_tpu_torch.ops.kernels import fused_ce as ce
    from flexflow_tpu_torch.utils import checkpoint as ckpt

    iters = LM_WARMUP + LM_TIMED
    drain = None
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
        # the first loss: ln V plus each block's aux (about 1 for a
        # router near uniform) at weight 1e-2
        first = math.log(32768) + layers * 1e-2
        if abs(losses[0] - first) > 0.25:
            raise AssertionError(f"first MoE loss {losses[0]} is not near "
                                 f"ln 32768 + {layers} x 0.01 = "
                                 f"{first:.4f}")
        ckpt_s = out["checkpoint_s"]
        _log(f"moe: {out['tokens_per_sec']:.1f} tokens/s, {step_ms:.2f} ms "
             f"per step, of which {ckpt_s * 1e3 / LM_TIMED:.2f} ms the 2 "
             f"checkpoint saves in the timed window ({ckpt_s:.2f} s); "
             f"peak memory {peak_gb:.2f} GB (max_memory_allocated) — {card}")
        tokens_per_sec = out["tokens_per_sec"]
        commit_tps = _through_commit(out)
        _log(f"moe: {commit_tps:.1f} tokens/s through the final save's "
             f"commit ({out['final_save_s']:.3f} s after the loop) — {card}")
        run_dir = MOE_CKPT_ROOT / "run"
        sync = {"launches": launches, "loss": losses,
                "tokens_per_sec": tokens_per_sec, "checkpoint_s": ckpt_s,
                "commit_tps": commit_tps,
                "final_save_s": out["final_save_s"],
                "digests": {s: _ckpt_digests(run_dir, s) for s in (
                    MOE_CKPT_FREQ, 2 * MOE_CKPT_FREQ, iters)}}
        del out
        # the step-5 checkpoint, for the resume below
        resume_dir = MOE_CKPT_ROOT / "resume"
        resume_dir.mkdir()
        step5 = f"step_{MOE_CKPT_FREQ:08d}"
        (run_dir / step5).rename(resume_dir / step5)
        shutil.rmtree(run_dir)
        gc.collect()
        torch.cuda.empty_cache()
        supervised = _moe_async_run(torch, kernels, card, sync)
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

        # the drain: a subprocess, drained at the step-10 boundary while
        # the resume and the divergence run below train, exits 0
        drain = _moe_drain_start(torch)

        # resume: a fresh run from the synchronous run's step-5
        # checkpoint, batches through the prefetcher, repeats steps 6-13
        # (across the step-10 boundary's save)
        _moe_resume(torch, resume_dir, MOE_CKPT_FREQ, losses, "moe resume")
        shutil.rmtree(resume_dir)

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
        gc.collect()
        torch.cuda.empty_cache()
        # a fresh run from the drained checkpoint, batches through the
        # prefetcher, repeats steps 11-13
        drained = _moe_drain_finish(drain, card)
        _moe_resume(torch, drained, MOE_DRAIN_STEP, losses,
                    "moe drained resume")
    finally:
        if drain is not None and drain["proc"].poll() is None:
            os.killpg(drain["proc"].pid, signal.SIGKILL)
            drain["proc"].communicate()
        shutil.rmtree(MOE_CKPT_ROOT, ignore_errors=True)
    gc.collect()
    torch.cuda.empty_cache()
    return {"launches": launches, "step_ms": step_ms, "peak_gb": peak_gb,
            "tokens_per_sec": tokens_per_sec, "loss": losses,
            "event_ms": ms[len(ms) // 2], "supervised": supervised}


def runtime_phase(torch, kernels, card: str) -> None:
    """The step watchdog and the runtime's two smokes on the card:
    ``apps.lm`` at the LM phase's widths, 1 + 4 steps, with step 2
    wedging the step-5 boundary past its deadline, raises
    ``DeviceLostError`` naming the deadline with one ``step_hang``
    record; then ``apps.preempt_smoke`` and ``apps.budget_smoke``."""
    import gc
    import shutil

    from flexflow_tpu_torch.apps import budget_smoke, lm, preempt_smoke
    from flexflow_tpu_torch.utils.elastic import DeviceLostError

    obs_dir = OBS_ROOT / "watchdog"
    shutil.rmtree(obs_dir, ignore_errors=True)
    warmup, steps = WATCHDOG_STEPS
    t = time.perf_counter()
    try:
        lm.main(_lm_argv(warmup + steps, warmup) + WATCHDOG_FLAGS
                + ["-obs-dir", str(obs_dir), "-run-id", "watchdog"],
                log=_log)
    except DeviceLostError as e:
        error = str(e)
    else:
        raise AssertionError("watchdog: the wedged boundary raised nothing")
    try:
        hangs = [r for r in _obs_records(obs_dir / "watchdog.jsonl")
                 if r["kind"] == "step_hang"]
    finally:
        shutil.rmtree(obs_dir, ignore_errors=True)
    _log(f"watchdog: DeviceLostError after {time.perf_counter() - t:.1f} s: "
         f"{error}; step_hang records {hangs}")
    if "exceeded the step watchdog deadline" not in error \
            or len(hangs) != 1 or hangs[0]["step"] != warmup + steps:
        raise AssertionError(f"watchdog: {error}, {hangs}")
    gc.collect()
    torch.cuda.empty_cache()
    for smoke in (preempt_smoke, budget_smoke):
        t = time.perf_counter()
        if smoke.main([], log=_log) != 0:
            raise AssertionError(f"{smoke.__name__} failed")
        _log(f"{smoke.__name__}: {time.perf_counter() - t:.1f} s")
        gc.collect()
        torch.cuda.empty_cache()


def nmt_profile_phase(torch) -> None:
    """One NMT training step at the JAX app's defaults: where its
    device time goes, by kind (GEMMs, kernels 4-6, the LSTM's and the
    optimizer's elementwise passes), and how long the device idles."""
    from torch.profiler import ProfilerActivity, profile

    from flexflow_tpu_torch.apps import nmt

    cfg = nmt.parse_args(_nmt_argv(1, 0))[0]
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
        engine._read_rows(outs, active, [])

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


# the strategy phase: AlexNet trained through torchrun at the JAX
# driver's example (flexflow_tpu/apps/cnn.py:4: batch 64, 224x224),
# float32, under strategy files this phase writes; the first losses
# against the run without a strategy (no process group)
STRATEGY_ROOT = Path(__file__).resolve().parent / ".chip_strategy"
STRATEGY_WARMUP, STRATEGY_TIMED, STRATEGY_CHECKED = 3, 10, 3
# the example's lr 0.01 takes the reference AlexNet (no ReLU after its
# convolutions) to a non-finite loss by step 8 on random data; 1e-3 does
# not (the CPU parity tests' rate)
STRATEGY_LR = 1e-3
STRATEGY_LOSS_RTOL = 1e-4
# AlexNet's ops and their grid ranks (flexflow_tpu_torch/models/alexnet.py)
ALEXNET_OPS = (("conv1", 4), ("pool1", 4), ("conv2", 4), ("pool2", 4),
               ("conv3", 4), ("conv4", 4), ("conv5", 4), ("pool3", 4),
               ("flat", 2), ("lienar1", 2), ("linear2", 2), ("linear3", 2),
               ("softmax", 1))
# the two-rank strategy: conv1 (11x11 stride 4, 224 rows: 112 a rank)
# and pool1 (3x3 stride 2, 55 rows: 28 and 27) split over h, their
# halos exchanged; conv2 and lienar1 split their output channels over
# both ranks, every other op the batch (the pure-DP default)
TWO_RANK_SPLITS = {"conv1": [1, 2, 1, 1], "pool1": [1, 2, 1, 1],
                   "conv2": [1, 1, 2, 1], "lienar1": [2, 1]}
# the four-rank strategy (a machine with four cards): conv2
# and pool2 over channels and batch, conv3-conv5 over w (13 columns: 7,
# 6; halos exchanged) and batch, the linears over channels, the rest
# over the batch
FOUR_RANK_SPLITS = {"conv2": [1, 1, 2, 2], "pool2": [1, 1, 2, 2],
                    "conv3": [2, 1, 1, 2], "conv4": [2, 1, 1, 2],
                    "conv5": [2, 1, 1, 2], "lienar1": [4, 1],
                    "linear2": [4, 1], "linear3": [2, 2]}
# the collectives the two-rank strategy's regrids and gradients use; the
# LM's fused vocab-parallel head also takes an all-reduce max.  A ring
# rotation is a point-to-point exchange where the backend carries one:
# gloo's send of a CUDA tensor fails in its transport thread, which may
# abort the process, so send_recv is probed in processes of its own
GLOO_CUDA_COLLECTIVES = ("all_gather", "reduce_scatter", "all_to_all",
                         "all_reduce", "all_reduce_max", "send_recv")
GLOO_CUDA_NEEDED = ("all_gather", "reduce_scatter", "all_reduce")


def _alexnet_argv(extra, warmup: int = STRATEGY_WARMUP,
                  timed: int = STRATEGY_TIMED) -> list:
    return ["alexnet", "-b", "64", "--height", "224", "--width", "224",
            "--lr", str(STRATEGY_LR), "-i", str(warmup + timed), "--warmup",
            str(warmup), "-p", "0"] + list(extra)


def _torchrun(nproc: int, args, timeout: float = 600,
              check: bool = True):
    """Run ``args`` (a module and its argv) under torchrun with ``nproc``
    processes on this host; its stdout, raising on failure; without
    ``check``, ``(returncode, stdout, stderr)`` whatever the outcome."""
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           "--nproc-per-node", str(nproc)] + list(args)
    # a session of its own, so that a run past its time is stopped with
    # every worker torchrun started
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True,
                            start_new_session=True,
                            cwd=str(Path(__file__).resolve().parent))
    try:
        out, err = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        proc.communicate()
        raise AssertionError(f"torchrun {' '.join(args[:3])} took more "
                             f"than {timeout} s and was stopped") from None
    if not check:
        return proc.returncode, out, err
    if proc.returncode != 0:
        raise AssertionError(f"torchrun {' '.join(args[:3])} failed "
                             f"({proc.returncode}):\n{err[-3000:]}")
    return out


def _gloo_cuda_probe(names) -> int:
    """Run under torchrun: which of the collectives ``names`` gloo carries
    on CUDA tensors (every rank on cuda:0); rank 0 prints one JSON
    line."""
    import torch
    import torch.distributed as dist

    dist.init_process_group("gloo")
    rank, world = dist.get_rank(), dist.get_world_size()
    x = torch.full((4, 8), float(rank + 1), device="cuda:0")
    calls = {
        "all_gather": lambda: dist.all_gather(
            [torch.empty_like(x) for _ in range(world)], x),
        "reduce_scatter": lambda: dist.reduce_scatter(
            torch.empty_like(x), [x.clone() for _ in range(world)]),
        "all_to_all": lambda: dist.all_to_all(
            [torch.empty_like(x) for _ in range(world)],
            [x.clone() for _ in range(world)]),
        "all_reduce": lambda: dist.all_reduce(x.clone()),
        "all_reduce_max": lambda: dist.all_reduce(
            x.clone(), op=dist.ReduceOp.MAX),
        "send_recv": lambda: [req.wait() for req in dist.batch_isend_irecv(
            [dist.P2POp(dist.isend, x, (rank + 1) % world),
             dist.P2POp(dist.irecv, torch.empty_like(x),
                        (rank - 1) % world)])],
    }
    ok = {}
    for name in names:
        try:
            calls[name]()
            torch.cuda.synchronize()
            ok[name] = "ok"
        except Exception as e:     # the probe reports, it decides nothing
            ok[name] = f"{type(e).__name__}: {str(e).splitlines()[0][:120]}"
    if rank == 0:
        print("GLOO_CUDA " + json.dumps(ok), flush=True)
    dist.destroy_process_group()
    return 0


def _strategy_file(path: Path, splits: dict, ranks: int) -> None:
    obj = {name: {"dims": splits.get(name, [1] * (nd - 1) + [ranks]),
                  "devices": list(range(ranks))}
           for name, nd in ALEXNET_OPS}
    path.write_text(json.dumps(obj, indent=1))


def _halo_log(label: str, res: dict, splits: dict, ranks: int,
              iters: int, card: str) -> dict:
    """Log the halo bytes each rank received a step (forward rows and
    backward gradients; ``--result-json``'s counter) beside what the
    all-gather of the whole h or w extent received before the exchange
    (forward, and as much again by its reduce-scatter): AlexNet at
    batch 64, 224x224, under ``splits``."""
    from flexflow_tpu_torch.config import FFConfig
    from flexflow_tpu_torch.machine import MachineModel
    from flexflow_tpu_torch.models.alexnet import build_alexnet
    from flexflow_tpu_torch.strategy import Strategy

    path = STRATEGY_ROOT / f"halo_{ranks}.json"
    _strategy_file(path, splits, ranks)
    ff = build_alexnet(FFConfig(batch_size=64, input_height=224,
                                input_width=224,
                                strategies=Strategy.load(str(path))),
                       MachineModel.virtual(ranks))
    whole = 0
    for op in ff.layers:
        if not hasattr(op, "kernel_h"):
            continue
        pw, ph, _, pn = op.pc.dims
        n, h, w, c = op.inputs[0].shape
        for parts, extent, across in ((ph, h, w // pw), (pw, w, h)):
            if parts > 1:
                own = -(-extent // parts)
                whole += 2 * (extent - own) * across * c * (n // pn) * 4
    got = res["halo_bytes"]["received"] / iters
    _log(f"strategy {label}: halo bytes received a step on rank 0 "
         f"{got:.0f} (forward rows and backward gradients of the "
         f"windows' spans), against {whole} by the whole-extent "
         f"all-gather before the exchange (rank 0's block, forward and "
         f"backward); {card}")
    return {"halo": got, "whole": whole}


def _check_run(label: str, res: dict, want) -> float:
    """Hold a strategy run's result (rank 0's ``--result-json``) to the
    bars: 3 launches each of kernel 7 and its forward a step, and the
    first losses within the tolerance of ``want``."""
    from flexflow_tpu_torch.ops.kernels import maxpool as mp

    iters = STRATEGY_WARMUP + STRATEGY_TIMED
    pools = {mp.NAME_FWD: 3 * iters, mp.NAME_BWD: 3 * iters}
    if {k: res["launches"].get(k, 0) for k in pools} != pools:
        raise AssertionError(f"strategy {label}: kernel 7/7f launches "
                             f"{res['launches']}, want {pools}")
    n = STRATEGY_CHECKED
    got = res["loss"]
    rel = max(abs(a - b) / max(abs(b), 1e-30)
              for a, b in zip(got[:n], want[:n]))
    _log(f"strategy {label}: first losses {got[:n]} vs {want[:n]} without a "
         f"strategy: max relative difference {rel:.3e} (tolerance "
         f"{STRATEGY_LOSS_RTOL:g})")
    if not (all(math.isfinite(v) for v in got) and rel <= STRATEGY_LOSS_RTOL):
        raise AssertionError(f"strategy {label}: losses {got[:n]} differ "
                             f"from {want[:n]}")
    return rel


def strategy_phase(torch, kernels, card: str) -> dict:
    """AlexNet through ``torchrun ... apps.cnn -s <file> -ll:gpu 1`` (NCCL,
    the strategy loader, the block machinery, the gradient all-reduce,
    kernels 7/7f) against the same run without ``-s`` in this process,
    then, where gloo carries CUDA tensors for every collective the path
    uses, a two-rank run on cuda:0 over gloo."""
    import shutil

    from flexflow_tpu_torch.apps import cnn

    root = STRATEGY_ROOT
    root.mkdir(exist_ok=True)
    try:
        kernels.reset_launches()
        torch.cuda.reset_peak_memory_stats()
        ref = cnn.main(_alexnet_argv([]), log=lambda *a: None)
        ref_launches = dict(kernels.launches)
        ref_step_ms = ref["elapsed_s"] / STRATEGY_TIMED * 1e3
        _log(f"strategy reference (no -s, no process group): "
             f"{ref['images_per_sec']:.2f} images/s, {ref_step_ms:.3f} ms "
             f"a step, peak {torch.cuda.max_memory_allocated() / 1e9:.3f} "
             f"GB; launches {ref_launches}; {card}")
        world = _one_rank_world(root)
        res = world["alexnet"]
        step_ms = res["elapsed_s"] / STRATEGY_TIMED * 1e3
        _log(f"strategy torchrun 1 rank (NCCL): {res['images_per_sec']:.2f} "
             f"images/s, {step_ms:.3f} ms a step, peak "
             f"{res['peak_memory_bytes'] / 1e9:.3f} GB; "
             f"{world['seconds']:.1f} s with torchrun's start for the "
             f"one-rank world of 4 runs (this, the placement NMT's, the "
             f"LM's and the MoE LM's); launches {res['launches']}; {card}")
        _check_run("1 rank", res, ref["loss"])
        out = {"launches": res["launches"], "images_per_sec":
               res["images_per_sec"], "step_ms": step_ms,
               "ref": ref, "ref_step_ms": ref_step_ms, "one_rank": world}

        probe = _torchrun(2, [str(Path(__file__).resolve()),
                              "--gloo-cuda-probe"], timeout=300)
        line = next(ln for ln in probe.splitlines()
                    if ln.startswith("GLOO_CUDA "))
        carried = json.loads(line[len("GLOO_CUDA "):])
        code, p2p_out, p2p_err = _torchrun(
            2, [str(Path(__file__).resolve()), "--gloo-p2p-probe"],
            timeout=120, check=False)
        line = next((ln for ln in p2p_out.splitlines()
                     if ln.startswith("GLOO_CUDA ")), None)
        if line is not None and code == 0:
            carried.update(json.loads(line[len("GLOO_CUDA "):]))
        else:
            why = next((ln for ln in reversed(p2p_err.splitlines())
                        if "what()" in ln or "Error" in ln), "")
            carried["send_recv"] = f"the probe's processes ended with " \
                f"{code}: {why.strip()[:160]}"
        out["gloo_cuda"] = carried
        _log(f"strategy gloo on CUDA tensors: {carried}")
        # a regrid's move needs no all-to-all: over gloo on CUDA tensors
        # the machine moves an axis by all-gather and slice
        if all(carried[c] == "ok" for c in GLOO_CUDA_NEEDED):
            two = root / "alexnet_2rank.json"
            _strategy_file(two, TWO_RANK_SPLITS, 2)
            _torchrun(2, ["-m", "flexflow_tpu_torch.apps.cnn"]
                      + _alexnet_argv(["-s", str(two), "-ll:gpu", "2",
                                       "--device", "cuda:0",
                                       "--dist-backend", "gloo",
                                       "--result-json",
                                       str(root / "two.json")]))
            res2 = json.loads((root / "two.json").read_text())
            _log(f"strategy torchrun 2 ranks on cuda:0 (gloo, regrid moves "
                 f"as all-gather and slice, halos through host copies): "
                 f"{res2['images_per_sec']:.2f} images/s, "
                 f"{res2['elapsed_s'] / STRATEGY_TIMED * 1e3:.3f} ms a step; "
                 f"launches on rank 0 {res2['launches']}; {card}")
            _check_run("2 ranks", res2, ref["loss"])
            out["halo"] = _halo_log("2 ranks", res2, TWO_RANK_SPLITS, 2,
                                    STRATEGY_WARMUP + STRATEGY_TIMED, card)
            if not 0 < out["halo"]["halo"] < out["halo"]["whole"]:
                raise AssertionError(f"strategy 2 ranks: halo bytes "
                                     f"{out['halo']}")
        else:
            _log("strategy: the two-rank gloo run is left out: gloo does "
                 "not carry CUDA tensors for every collective the path "
                 "uses (above)")
        return out
    finally:
        shutil.rmtree(root, ignore_errors=True)


def _one_rank_world(root: Path) -> dict:
    """The one-rank NCCL runs of the strategy, placement, lm strategy and
    moe strategy phases, each under its one-device strategy file, in one
    torchrun world (a start costs 16-35 s, most of it importing torch in
    the agent and the worker): AlexNet, the NMT, the LM and the MoE LM.
    Their results by name, and the world's seconds with its start."""
    files = {name: root / f"{name}_1rank.json"
             for name in ("alexnet", "nmt", "lm", "moe")}
    _strategy_file(files["alexnet"], {}, 1)
    _nmt_strategy(files["nmt"], 1)
    _lm_strategy_file(files["lm"], 1)
    _moe_strategy_file(files["moe"], 1, MOE_WIDTHS[0])
    steps = LM_RANKS_WARMUP + LM_RANKS_STEPS
    runs = [_alexnet_argv(["-s", str(files["alexnet"]), "-ll:gpu", "1"]),
            _nmt_argv(LM_WARMUP + LM_TIMED, LM_WARMUP)
            + ["--strategy", str(files["nmt"])],
            _lm_argv(LM_WARMUP + LM_TIMED, LM_WARMUP)
            + ["--strategy", str(files["lm"])],
            _moe_argv(steps, LM_RANKS_WARMUP)
            + ["--strategy", str(files["moe"])]]
    results, _, seconds = _lm_ranks(1, root, "one_rank", runs,
                                    apps={0: "cnn", 1: "nmt"})
    out = {name: res[0] for name, res in zip(files, results)}
    out["seconds"] = seconds
    return out


def strategy4_phase(torch, kernels, card: str) -> dict:
    """AlexNet over four cards through ``torchrun --nproc-per-node 4``
    (NCCL): pure data parallelism (no ``-s``) and the four-rank hybrid
    strategy, each against the one-card run without a strategy."""
    import shutil

    from flexflow_tpu_torch.apps import cnn

    root = STRATEGY_ROOT
    root.mkdir(exist_ok=True)
    try:
        ref = cnn.main(_alexnet_argv([]), log=lambda *a: None)
        _log(f"strategy 4 reference (one card, no -s): "
             f"{ref['images_per_sec']:.2f} images/s, "
             f"{ref['elapsed_s'] / STRATEGY_TIMED * 1e3:.3f} ms a step; "
             f"{card}")
        hybrid = root / "alexnet_4rank.json"
        _strategy_file(hybrid, FOUR_RANK_SPLITS, 4)
        out = {}
        for label, extra in (("dp", []), ("hybrid", ["-s", str(hybrid)])):
            t = time.perf_counter()
            _torchrun(4, ["-m", "flexflow_tpu_torch.apps.cnn"]
                      + _alexnet_argv(extra + [
                          "-ll:gpu", "4", "--result-json",
                          str(root / f"{label}.json")]))
            res = json.loads((root / f"{label}.json").read_text())
            _log(f"strategy 4 {label} (NCCL, 4 ranks): "
                 f"{res['images_per_sec']:.2f} images/s, "
                 f"{res['elapsed_s'] / STRATEGY_TIMED * 1e3:.3f} ms a step, "
                 f"peak on rank 0 {res['peak_memory_bytes'] / 1e9:.3f} GB, "
                 f"{time.perf_counter() - t:.1f} s with torchrun's start; "
                 f"launches on rank 0 {res['launches']}")
            _check_run(f"4 ranks {label}", res, ref["loss"])
            out[label] = res["images_per_sec"]
            if label == "hybrid":
                out["halo"] = _halo_log(
                    "4 ranks hybrid (NCCL point-to-point)", res,
                    FOUR_RANK_SPLITS, 4, STRATEGY_WARMUP + STRATEGY_TIMED,
                    card)
        return out
    finally:
        shutil.rmtree(root, ignore_errors=True)


# the placement phases (ROADMAP Queue A 3b): 1 warm-up and 3 steps a run
# over several ranks, its first 3 losses within the bar of the one-rank
# run's
PLACED_WARMUP, PLACED_STEPS = 1, 3
PLACED_LOSS_RTOL = 1e-4
# AlexNet with linear2 and linear3 on device 1 alone, the rest data
# parallel
PLACED_ALEXNET = {"linear2": ([1, 1], [1]), "linear3": ([1, 1], [1])}


def _nmt_strategy(path: Path, ranks: int) -> None:
    """``default_global_config`` at the NMT phase's widths, written for
    ``ranks`` devices (a planning machine: no process group)."""
    from flexflow_tpu_torch.apps import nmt
    from flexflow_tpu_torch.machine import MachineModel
    from flexflow_tpu_torch.nmt.rnn_model import default_global_config

    cfg = nmt.parse_args(_nmt_argv(1, 0))[0]
    default_global_config(
        cfg, MachineModel("cpu", world_size=ranks)).save(str(path))


def _placed_alexnet(path: Path, ranks: int) -> None:
    obj = {name: {"dims": [1] * (nd - 1) + [ranks],
                  "devices": list(range(ranks))} for name, nd in ALEXNET_OPS}
    for name, (dims, devices) in PLACED_ALEXNET.items():
        obj[name] = {"dims": dims, "devices": devices}
    path.write_text(json.dumps(obj, indent=1))


def _rank_results(path: Path, ranks: int) -> list:
    """Every rank's ``--result-json`` (rank 0's file, then ``.rank<r>``)."""
    return [json.loads(Path(str(path) + (f".rank{r}" if r else ""))
                       .read_text()) for r in range(ranks)]


def _check_placed(label: str, results: list, want_loss, launches: dict,
                  steps: int) -> float:
    """Hold a placed run to its bars: rank 0's launches of the path's
    kernels, its first 3 losses against ``want_loss``; log each rank's
    leaves (residency)."""
    res = results[0]
    got_launches = {k: res["launches"].get(k, 0) for k in launches}
    if got_launches != launches:
        raise AssertionError(f"placement {label}: launches on rank 0 "
                             f"{res['launches']}, want {launches}")
    n = STRATEGY_CHECKED
    got = res["loss"]
    rel = max(abs(a - b) / max(abs(b), 1e-30)
              for a, b in zip(got[:n], want_loss[:n]))
    for r, rr in enumerate(results):
        _log(f"placement {label}: rank {r} holds params {rr['leaves']}")
    _log(f"placement {label}: first losses {got[:n]} vs one rank "
         f"{want_loss[:n]}: max relative difference {rel:.3e} (tolerance "
         f"{PLACED_LOSS_RTOL:g}); launches on rank 0 {res['launches']}")
    if not (all(math.isfinite(v) for v in got) and rel <= PLACED_LOSS_RTOL
            and len(got) == steps):
        raise AssertionError(f"placement {label}: losses {got[:n]} differ "
                             f"from {want_loss[:n]}")
    return rel


def _ce_launches(per_step: int, steps: int) -> dict:
    from flexflow_tpu_torch.ops.kernels import fused_ce as ce

    return {name: per_step * steps
            for name in (ce.NAME_FWD, ce.NAME_FWD_COMBINE, ce.NAME_DX,
                         ce.NAME_DX_SUM, ce.NAME_DW)}


def _pool_launches(steps: int) -> dict:
    from flexflow_tpu_torch.ops.kernels import maxpool as mp

    return {mp.NAME_FWD: 3 * steps, mp.NAME_BWD: 3 * steps}


def _placed_runs(ranks: int, root: Path, card: str, nmt_loss, alexnet_loss,
                 extra) -> dict:
    """The NMT under ``default_global_config`` and ``--pipeline-stages 2``
    and the placed AlexNet over ``ranks`` ranks, the three in one torchrun
    world (:func:`_lm_ranks`; ``extra`` names the device and backend),
    each held to its bars; their rates."""
    steps = PLACED_WARMUP + PLACED_STEPS
    nmt_argv = _nmt_argv(steps, PLACED_WARMUP, "") + extra
    strategy = root / f"nmt_{ranks}.json"
    _nmt_strategy(strategy, ranks)
    alexnet = root / f"alexnet_placed_{ranks}.json"
    _placed_alexnet(alexnet, ranks)
    runs = (("nmt default_global_config", "nmt",
             nmt_argv + ["--strategy", str(strategy)], nmt_loss,
             _ce_launches(NMT_CHUNKS, steps)),
            ("nmt --pipeline-stages 2", "nmt",
             nmt_argv + ["--pipeline-stages", "2"], nmt_loss,
             _ce_launches(NMT_CHUNKS, steps)),
            ("alexnet linear2-3 on rank 1", "cnn",
             _alexnet_argv(extra + ["-s", str(alexnet), "-ll:gpu",
                                    str(ranks)], PLACED_WARMUP,
                           PLACED_STEPS),
             alexnet_loss, _pool_launches(steps)))
    every, _, seconds = _lm_ranks(
        ranks, root, f"placed_{ranks}", [run[2] for run in runs],
        apps={i: run[1] for i, run in enumerate(runs)})
    _log(f"placement: {len(runs)} runs over {ranks} ranks in one torchrun "
         f"world, {seconds:.1f} s with its start")
    out = {}
    for (label, module, _, want, launches), results in zip(runs, every):
        res = results[0]
        step_ms = res["elapsed_s"] / PLACED_STEPS * 1e3
        rate = res["images_per_sec"]
        _log(f"placement {label} ({ranks} ranks, {' '.join(extra)}): "
             f"{rate:.2f} {'sentences' if module == 'nmt' else 'images'}/s, "
             f"{step_ms:.3f} ms a step, peak on rank 0 "
             f"{res['peak_memory_bytes'] / 1e9:.3f} GB; {card}")
        _check_placed(label, results, want, launches, steps)
        out[label] = {"rate": rate, "step_ms": step_ms}
    return out


def placement_phase(torch, kernels, card: str, nmt_run: dict,
                    strategy_run: dict) -> dict:
    """The NMT through ``torchrun --nproc-per-node 1 ... apps.nmt --strategy
    <default_global_config for one device>`` (NCCL) at the JAX app's
    defaults against ``apps.nmt`` without a strategy in this process (the
    nmt phase's run); then, where gloo carries CUDA tensors for the moves,
    two gloo ranks on cuda:0: the NMT under the two-device
    ``default_global_config`` (``srcEmbed`` on rank 0 alone, ``dstEmbed``
    on rank 1) and under ``--pipeline-stages 2`` (LSTM layer l on rank l),
    and AlexNet with linear2 and linear3 on rank 1 alone."""
    import shutil

    root = STRATEGY_ROOT
    root.mkdir(exist_ok=True)
    try:
        iters = LM_WARMUP + LM_TIMED
        # run in the strategy phase's one-rank world
        res = strategy_run["one_rank"]["nmt"]
        step_ms = res["elapsed_s"] / LM_TIMED * 1e3
        _log(f"placement nmt torchrun 1 rank (NCCL, default_global_config): "
             f"{res['sentences_per_sec']:.2f} sentences/s, {step_ms:.3f} ms "
             f"a step, peak {res['peak_memory_bytes'] / 1e9:.3f} GB (the "
             f"strategy phase's one-rank world); "
             f"without a strategy in this process "
             f"{nmt_run['sentences_per_sec']:.2f} sentences/s, "
             f"{nmt_run['step_ms']:.3f} ms; {card}")
        _check_placed("nmt 1 rank", [res], nmt_run["loss"],
                      _ce_launches(NMT_CHUNKS, iters), iters)
        out = {"nmt 1 rank": {"rate": res["sentences_per_sec"],
                              "step_ms": step_ms}}
        carried = strategy_run.get("gloo_cuda", {})
        if all(carried.get(c) == "ok" for c in GLOO_CUDA_NEEDED):
            out.update(_placed_runs(
                2, root, card, nmt_run["loss"], strategy_run["ref"]["loss"],
                ["--device", "cuda:0", "--dist-backend", "gloo"]))
        else:
            _log("placement: the two-rank gloo runs are left out: gloo does "
                 "not carry CUDA tensors for every collective the moves "
                 "use")
        return out
    finally:
        shutil.rmtree(root, ignore_errors=True)


def placement4_phase(torch, kernels, card: str, nmt_run: dict,
                     strategy_run: dict) -> dict:
    """The placement phase's runs over four cards (NCCL, a card a rank):
    the NMT under ``default_global_config`` and ``--pipeline-stages 2``
    and the placed AlexNet, each against its one-card run."""
    import shutil

    root = STRATEGY_ROOT
    root.mkdir(exist_ok=True)
    try:
        out = _placed_runs(4, root, card, nmt_run["loss"],
                           strategy_run["ref"]["loss"], [])
        _log(f"placement 4: one card without a strategy "
             f"{nmt_run['sentences_per_sec']:.2f} sentences/s "
             f"({nmt_run['step_ms']:.3f} ms a step), "
             f"{strategy_run['ref']['images_per_sec']:.2f} images/s "
             f"({strategy_run['ref_step_ms']:.3f} ms a step)")
        return out
    finally:
        shutil.rmtree(root, ignore_errors=True)


# the GPT trainer under per-op strategies (ROADMAP Queue A 3c): one rank
# through torchrun (NCCL, the LM phase's 3 + 10 steps), then two gloo
# ranks on cuda:0 and, on four cards, four NCCL ranks, 1 + 3 steps each;
# the first 3 losses of each within 1e-4 (relative) of the one-rank
# run's
LM_RANKS_WARMUP, LM_RANKS_STEPS = 1, 3
LM_LAYERS = 12
# the LM world over several ranks (18b-18f, 19) runs the LM phase's
# widths at 2 of its 12 blocks (a ring-attention block and a head-split
# one): on two gloo ranks of one card every block pays host copies, and
# the whole smoke must end within 1200 s; its reference is a one-process
# run at the same depth
LM_RANKS_LAYERS = 2
LM_RANKS_WIDTHS = (LM_RANKS_LAYERS, 768, 12, 3072)
# the multi-rank LM runs save every 2 steps; a run resumed from step 2
# repeats the rest of the uninterrupted run bit for bit, or within 1e-6
LM_CKPT_FREQ = 2
LM_RESUME_RTOL = 1e-6
# phase 18f (and 19's four-card form): the elastic LM in the multi-rank
# LM world, 1 warm-up and 7 steps, a rank (two of four) lost at step 2
# and called back at ELASTIC_GROW; each segment's losses within 1e-6 of a
# run resumed from the resize's checkpoint
ELASTIC_ITERS = 8
ELASTIC_FAULTS = {2: "device_loss@2,device_return@2",
                  4: "device_loss@1x2,device_return@1"}
ELASTIC_PRINT = {2: 1, 4: 2}
ELASTIC_SHRINK, ELASTIC_GROW = 2, {2: 5, 4: 6}
ELASTIC_RTOL = 1e-6


def _lm_strategy_file(path: Path, ranks: int,
                      layers: int = LM_LAYERS) -> None:
    """The LM phase's strategy (``layers`` blocks) over ``ranks``
    devices: ring attention
    (s = 2, the rest of the ranks over the batch) in the even blocks and
    the heads split over every rank in the odd ones, ``ff1`` split over
    its output channels and ``ff2`` over the batch, the norms and
    residuals alternately over the sequence and the batch, ``embed`` on
    rank 1 alone and the head split over the vocab (fused over the
    ranks).  One rank: every grid a single point on device 0."""
    obj = {}

    def put(name, dims, devices=None):
        obj[name] = {"dims": list(dims),
                     "devices": list(devices or range(ranks))}

    put("embed", [1], [0] if ranks == 1 else [1])
    put("pos_embed", [1, ranks])
    put("final_ln", [ranks, 1])
    put("lm_head", [ranks, 1])
    put("softmax", [ranks])
    for i in range(layers):
        put(f"blk{i}_attn", (1, ranks, 1) if i % 2 or ranks == 1
            else (2, 1, ranks // 2))
        put(f"blk{i}_ff1", (ranks, 1))
        put(f"blk{i}_ff2", (1, ranks))
        for j, op in enumerate(("ln1", "res1", "ln2", "gelu", "res2")):
            put(f"blk{i}_{op}", (ranks, 1) if (i + j) % 2 == 0
                else (1, ranks))
    path.write_text(json.dumps(obj, indent=1))


def _lm_rank_launches(steps: int, layers: int = LM_LAYERS) -> dict:
    """Rank 0's launches of kernels 1-6 under ``_lm_strategy_file`` over 2
    or 4 ranks (``layers`` blocks): in each even block its ring chunk is
    the first, so it
    attends only its own (the diagonal: one partial form of kernels
    1-3); each odd block runs kernels 1-3 on its heads; the head runs the
    partial form of kernels 4-6."""
    from flexflow_tpu_torch.ops.kernels import flash_attention as fa
    from flexflow_tpu_torch.ops.kernels import fused_ce as ce

    half = layers // 2
    out = {}
    for name in (fa.NAME, fa.NAME_DKV, fa.NAME_DQ):
        out[name] = half * steps
        out[f"{name}.partial"] = half * steps
    for name in (ce.NAME_FWD, ce.NAME_FWD_COMBINE, ce.NAME_DX,
                 ce.NAME_DX_SUM, ce.NAME_DW):
        out[f"{name}.partial"] = steps
    return out


def _check_lm_run(label: str, res: dict, want_loss, launches: dict):
    """Hold an LM run under a strategy to its bars: rank 0's launches of
    kernels 1-6 exactly ``launches``, its first 3 losses within 1e-4 of
    ``want_loss``."""
    if {k: v for k, v in res["launches"].items() if v} != launches:
        raise AssertionError(f"{label}: launches on rank 0 "
                             f"{res['launches']}, want {launches}")
    n = LM_CHECKED
    got = res["loss"]
    rel = max(abs(a - b) / max(abs(b), 1e-30)
              for a, b in zip(got[:n], want_loss[:n]))
    _log(f"{label}: first losses {got[:n]} vs {want_loss[:n]}: "
         f"max relative difference {rel:.3e} (tolerance "
         f"{LM_LOSS_RTOL:g}); launches on rank 0 {res['launches']}")
    if not (all(math.isfinite(v) for v in got) and rel <= LM_LOSS_RTOL):
        raise AssertionError(f"{label}: losses {got[:n]} differ from "
                             f"{want_loss[:n]}")
    return rel


# ---------------------------------------------------------------------------
# several apps.lm runs of one world share one torchrun (``--lm-ranks``):
# the LM under per-op strategies (ROADMAP Queue A 3c), the MoE LM under
# expert grids (3c-ii) and the GPipe pipelined LM (3d), with the probes
# that hold the MoE op and the pipeline against one device's run


def _flag(argv, name: str, default=None):
    return argv[argv.index(name) + 1] if name in argv else default


def _ranks_worker(spec_path: str) -> int:
    """Run under torchrun (``--lm-ranks SPEC``): each argv of the spec's
    ``runs`` in turn on this world, through ``apps.lm`` or the app the
    spec's ``apps`` names for it (``cnn``, ``nmt``), the launch counts and
    the peak memory reset before each (its results in its
    ``--result-json``; a run its plan check refuses writes ``{"exit":
    code}`` there instead; ``rank0`` names arguments a run takes on rank
    0 alone); then the probes the spec names on this world:
    ``moe_probe`` (a list of grids, :func:`_moe_probe`) and
    ``pipe_probe`` (:func:`_pipe_probe`'s keywords), whose results rank
    r writes to ``probe_json`` (``.rank<r>`` on rank r > 0)."""
    import importlib

    import torch

    from flexflow_tpu_torch import distributed
    from flexflow_tpu_torch.ops import kernels

    spec = json.loads(Path(spec_path).read_text())
    rank = int(os.environ.get("RANK", "0"))
    try:
        for i, argv in enumerate(spec["runs"]):
            copy = spec.get("copies", {}).get(str(i))
            if copy:
                # a checkpoint step the run resumes from: copied by rank
                # 0, every rank waiting for it
                import shutil

                import torch.distributed as dist

                if rank == 0:
                    shutil.copytree(copy[0], copy[1])
                dist.barrier()
            kernels.reset_launches()
            torch.cuda.reset_peak_memory_stats()
            if rank == 0:
                argv = argv + spec.get("rank0", {}).get(str(i), [])
            strategy = spec.get("strategy_from", {}).get(str(i))
            if strategy and Path(strategy).exists():
                argv = argv + ["--strategy", strategy]
            sub = spec.get("sub", {}).get(str(i))
            hooks = spec.get("elastic", {}).get(str(i))
            app = spec.get("apps", {}).get(str(i), "lm")
            main = importlib.import_module(f"flexflow_tpu_torch.apps.{app}"
                                           ).main
            t = time.perf_counter()
            record, unhook = _elastic_hooks(hooks, rank) if hooks \
                else (None, None)
            try:
                if sub is None:
                    main(argv, log=_log)
                else:
                    # the run on a world of the ranks ``sub`` alone,
                    # re-formed from this one (and back after it)
                    world = distributed.reform(sub,
                                               distributed.generation() + 1)
                    if world is not None:
                        saved = dict(os.environ)
                        os.environ.update(WORLD_SIZE=str(len(sub)),
                                          RANK=str(world.rank))
                        try:
                            main(argv, log=_log)
                        finally:
                            os.environ.clear()
                            os.environ.update(saved)
            except SystemExit as e:
                path = _flag(argv, "--result-json") + (
                    f".rank{rank}" if rank else "")
                Path(path).write_text(json.dumps({"exit": e.code}))
            finally:
                if unhook is not None:
                    unhook()
                if sub is not None:
                    distributed.reform(
                        range(int(os.environ["WORLD_SIZE"])),
                        distributed.generation() + 1)
            if "--result-json" in argv:
                path = _flag(argv, "--result-json") + ".extra" + (
                    f".rank{rank}" if rank else "")
                Path(path).write_text(json.dumps(
                    {"seconds": time.perf_counter() - t, "hooks": record}))
        if spec.get("moe_probe") or spec.get("pipe_probe"):
            torch.backends.cuda.matmul.allow_tf32 = False
            machine = distributed.initialize(spec["device"],
                                             backend=spec["backend"])
            res = {}
            if spec.get("moe_probe"):
                res["moe"] = _moe_probe(torch, machine, spec["moe_probe"])
            if spec.get("pipe_probe"):
                res["pipe"] = _pipe_probe(torch, machine,
                                          **spec["pipe_probe"])
            path = spec["probe_json"] + (f".rank{machine.rank}"
                                         if machine.rank else "")
            Path(path).write_text(json.dumps(res))
    finally:
        distributed.shutdown()
    return 0


def _elastic_hooks(cfg: dict, rank: int):
    """Watch an elastic run from inside (a worker of ``--lm-ranks``):
    each resize marks the launch counts and the vocab head's row counts
    (N of kernels 4-6's inputs) of the segment it ends, and rank 0
    copies the resize's checkpoint (``cfg``: ``ckpt``, ``shrink_copy``,
    ``grow_copy``) before later saves prune it; a rank that stands by
    records when and how it was called.  Returns ``(record, unhook)``;
    ``unhook`` marks the last segment and restores the functions."""
    import shutil

    from flexflow_tpu_torch.ops import kernels
    from flexflow_tpu_torch.ops.kernels import fused_ce as ce
    from flexflow_tpu_torch.utils import elastic

    record = {"marks": [], "standby": []}
    rows = []
    real = (elastic.recover, elastic.recover_grow, elastic.stand_by,
            ce._check)

    def mark(at, step):
        record["marks"].append({"at": at, "step": step,
                                "launches": dict(kernels.launches),
                                "rows": sorted(set(rows)),
                                "t": time.perf_counter()})
        rows.clear()

    def keep(step, dst):
        if rank == 0 and dst:
            shutil.copytree(Path(cfg["ckpt"]) / f"step_{step:08d}",
                            Path(dst) / f"step_{step:08d}")

    def recover(model, sig, *args, **kwargs):
        mark("shrink", sig.step)
        out = real[0](model, sig, *args, **kwargs)
        if out[0] is not None:
            keep(out[1]["start_iter"], cfg.get("shrink_copy"))
        return out

    def recover_grow(model, sig, *args, **kwargs):
        mark("grow", sig.step)
        out = real[1](model, sig, *args, **kwargs)
        keep(sig.step, cfg.get("grow_copy"))
        return out

    def stand_by(*args, **kwargs):
        t = time.perf_counter()
        msg = real[2](*args, **kwargs)
        record["standby"].append({"op": msg["op"], "step": msg.get("step"),
                                  "seconds": time.perf_counter() - t})
        return msg

    def check(name, x, *args):
        rows.append(int(x.shape[0]))
        return real[3](name, x, *args)

    elastic.recover, elastic.recover_grow = recover, recover_grow
    elastic.stand_by, ce._check = stand_by, check

    def unhook():
        mark("end", None)
        (elastic.recover, elastic.recover_grow, elastic.stand_by,
         ce._check) = real

    return record, unhook


def _lm_ranks(ranks: int, root: Path, tag: str, runs, extra=(),
              moe_probe=None, pipe_probe=None, copies=None,
              rank0=None, apps=None, sub=None, strategy_from=None,
              elastic=None, bare=()) -> tuple:
    """``runs`` (apps.lm argv lists, ``extra`` appended to each; ``apps``:
    ``{run index: "cnn" or "nmt"}`` for another app's) as one
    torchrun world of ``ranks`` through :func:`_ranks_worker`, each with
    a ``--result-json`` of its own (``copies``: ``{run index: (source,
    destination)}`` directories rank 0 copies before that run;
    ``rank0``: ``{run index: argv}`` rank 0 alone appends), then the
    probes on the device and backend ``extra`` names: ``(every rank's
    results per run, every rank's probe results or None, seconds with
    torchrun's start)``.  ``sub``: ``{run index: ranks}``, runs made on a
    world of those ranks alone, re-formed for the run (``distributed.
    reform``); ``strategy_from``: ``{run index: file}`` taken as
    the run's ``--strategy`` when it exists at the run's start;
    ``elastic``: ``{run index: hooks config}`` (:func:`_elastic_hooks`);
    every run writes ``<result>.extra`` beside its results (its seconds
    and the hooks' record); ``bare``: the run indices that take their
    own argv without ``extra``."""
    outs = [root / f"{tag}_{i}.json" for i in range(len(runs))]
    spec = {"runs": [list(a) + ([] if i in bare else list(extra))
                     + ["--result-json", str(o)]
                     for i, (a, o) in enumerate(zip(runs, outs))],
            "copies": {str(i): [str(a), str(b)]
                       for i, (a, b) in (copies or {}).items()},
            "rank0": {str(i): list(a) for i, a in (rank0 or {}).items()},
            "apps": {str(i): a for i, a in (apps or {}).items()},
            "sub": {str(i): list(m) for i, m in (sub or {}).items()},
            "strategy_from": {str(i): str(f)
                              for i, f in (strategy_from or {}).items()},
            "elastic": {str(i): c for i, c in (elastic or {}).items()}}
    probed = moe_probe is not None or pipe_probe is not None
    if probed:
        spec.update(moe_probe=moe_probe, pipe_probe=pipe_probe,
                    device=_flag(extra, "--device", "cuda"),
                    backend=_flag(extra, "--dist-backend"),
                    probe_json=str(root / f"{tag}_probe.json"))
    path = root / f"{tag}_spec.json"
    path.write_text(json.dumps(spec))
    t = time.perf_counter()
    _torchrun(ranks, [str(Path(__file__).resolve()), "--lm-ranks",
                      str(path)], timeout=900)
    seconds = time.perf_counter() - t
    results = [_rank_results(o, len((sub or {}).get(i, range(ranks))))
               for i, o in enumerate(outs)]
    probes = _rank_results(Path(spec["probe_json"]), ranks) \
        if probed else None
    return results, probes, seconds


def _log_ranks_run(label: str, results: list, seconds: float,
                   card: str) -> float:
    """Log a multi-rank run's rate, step ms, rank 0's peak and each rank's
    params; its step ms."""
    res = results[0]
    # a save inside the timed window is not a step's time
    step_ms = (res["elapsed_s"] - res.get("checkpoint_s", 0.0)) \
        / LM_RANKS_STEPS * 1e3
    _log(f"{label}: {res['tokens_per_sec']:.1f} tokens/s, {step_ms:.3f} ms "
         f"a step, peak on rank 0 {res['peak_memory_bytes'] / 1e9:.3f} GB, "
         f"{seconds:.1f} s for the torchrun world; {card}")
    for r, rr in enumerate(results):
        where = rr.get("pipeline")
        _log(f"{label}: rank {r} holds params {rr['leaves']['params']}"
             + (f", at (stage, n, tp) {where['coords']}, w1 block "
                f"{where['blocks']['w1']}" if where else ""))
    return step_ms


def _lm_ranks_run(ranks: int, root: Path, card: str, want_loss,
                  extra, supervised: bool = False) -> dict:
    """The LM over ``ranks`` ranks under ``_lm_strategy_file`` (``extra``
    names the device and backend), held to its bars, checkpointed every
    ``LM_CKPT_FREQ`` steps; each rank's leaves logged.  In the same world
    a run resumed from its step-``LM_CKPT_FREQ`` checkpoint
    (:func:`_check_resume`); with ``supervised``, the resumed run writes
    through the async writer and, the world's last, a run drains
    (:func:`_check_ranks_supervised`)."""
    steps = LM_RANKS_WARMUP + LM_RANKS_STEPS
    path = root / f"lm_{ranks}.json"
    _lm_strategy_file(path, ranks, LM_RANKS_LAYERS)
    whole, cut = root / f"ckpt_{ranks}", root / f"ckpt_{ranks}_resumed"
    drained = DRAIN_ROOT / f"lm_{ranks}"
    ckpt = ["--ckpt-freq", str(LM_CKPT_FREQ), "--ckpt-dir"]
    argv = _lm_argv(steps, LM_RANKS_WARMUP, LM_RANKS_WIDTHS)
    runs = [argv + ckpt + [str(whole)], argv + ckpt + [str(cut)]]
    el = _elastic_runs(ranks, root, len(runs))
    runs += el["runs"]
    # phase 18g: the autoscaling service in this world, before the drained
    # run (a drain ends its world); then phase 8d's runs, whose serving
    # search for this world's size is made here before the world starts
    serve_at = len(runs)
    runs.append(_serve_scale_argv(ranks, extra))
    searched, search_runs = _serve_search_ranks(ranks, extra)
    search_at = len(runs)
    runs += search_runs
    if supervised:
        shutil.rmtree(drained, ignore_errors=True)
        runs[1] += ["--ckpt-async"]
        runs += [argv + ckpt + [str(drained)]
                 + ["--ckpt-async", "--drain-budget-s", str(DRAIN_BUDGET_S)]]
    results, _, seconds = _lm_ranks(
        ranks, root, f"lm_{ranks}", runs,
        list(extra) + ["--strategy", str(path)],
        copies={1: (whole / f"step_{LM_CKPT_FREQ:08d}",
                    cut / f"step_{LM_CKPT_FREQ:08d}")},
        rank0={len(runs) - 1: ["--fault-spec", "preempt@1"]}
        if supervised else None, sub=el["sub"],
        strategy_from=el["strategy_from"], elastic=el["hooks"],
        apps={serve_at: "serve", search_at: "serve", search_at + 1: "serve"},
        bare=(serve_at, search_at, search_at + 1))
    label = (f"lm strategy {ranks} ranks "
             f"({' '.join(extra) or 'NCCL, a card a rank'})")
    step_ms = _log_ranks_run(label, results[0], seconds, card)
    _check_lm_run(label, results[0][0], want_loss,
                  _lm_rank_launches(steps, LM_RANKS_LAYERS))
    _check_resume(label, results[0], results[1], whole, cut, steps, card)
    out = {"tokens_per_sec": results[0][0]["tokens_per_sec"],
           "step_ms": step_ms, "launches": results[0][0]["launches"],
           "serve": results[serve_at],
           "serve_search": {"serve": results[search_at],
                            "smoke": results[search_at + 1],
                            "path": str(SERVE_SEARCH_ROOT
                                        / f"serve_{ranks}.json"),
                            "forward_step_s": searched["best_time_s"]}}
    out["elastic"] = _check_elastic(
        f"elastic {ranks} ranks", ranks, results[0][0]["loss"], root,
        f"lm_{ranks}", el, results, card, whole)
    if supervised:
        _check_ranks_supervised(label, results[0], results[1], results[-1],
                                whole, cut, drained, steps)
        out["drained"] = {"dir": str(drained),
                          "tail": results[0][0]["loss"][LM_CKPT_FREQ:]}
    return out


def _elastic_runs(ranks: int, root: Path, first: int) -> dict:
    """Phase 18f's runs (19's on four ranks) for the multi-rank LM world,
    from run index ``first``: the elastic run (``E``), the reference of
    its shrunk segment (``S``, on a world of the surviving ranks alone,
    re-formed for it), the reference of its grown segment (``G``) and a
    run with ``--elastic`` and no fault (``NF``); each reference resumes
    from the resize's checkpoint, which the hooks copy, under the
    strategy saved there."""
    grow = ELASTIC_GROW[ranks]
    ckpt, obs_dir = root / f"elastic_{ranks}", root / f"elastic_obs_{ranks}"
    shrunk, grown = root / f"elastic_{ranks}_s", root / f"elastic_{ranks}_g"
    runs = {"E": _lm_argv(ELASTIC_ITERS, 1, LM_RANKS_WIDTHS) + [
        "--elastic", "--min-devices", "1", "--print-freq",
        str(ELASTIC_PRINT[ranks]), "--ckpt-dir", str(ckpt), "--ckpt-freq",
        "2", "--regrow-probes", "2", "--max-regrows", "1",
        "--research-budget-s", "10", "--fault-spec", ELASTIC_FAULTS[ranks],
        "-obs-dir", str(obs_dir), "-run-id", f"elastic{ranks}"],
        "S": _lm_argv(grow, 1, LM_RANKS_WIDTHS) + ["--ckpt-dir",
                                                   str(shrunk)],
        "G": _lm_argv(ELASTIC_ITERS, 1, LM_RANKS_WIDTHS) + ["--ckpt-dir",
                                                            str(grown)],
        "NF": _lm_argv(2, 1, LM_RANKS_WIDTHS) + ["--elastic"]}
    index = {k: first + i for i, k in enumerate(runs)}
    return {"runs": list(runs.values()), "index": index,
            "sub": {index["S"]: list(range(ranks // 2))},
            "strategy_from": {
                index["S"]: (shrunk / f"step_{ELASTIC_SHRINK:08d}"
                             / "strategy.json"),
                index["G"]: grown / f"step_{grow:08d}" / "strategy.json"},
            "hooks": {index["E"]: {"ckpt": str(ckpt),
                                   "shrink_copy": str(shrunk),
                                   "grow_copy": str(grown)}},
            "shrunk": shrunk, "grown": grown}


def _extra(root: Path, tag: str, i: int, ranks: int) -> list:
    return [json.loads((root / (f"{tag}_{i}.json.extra"
                                + (f".rank{r}" if r else ""))).read_text())
            for r in range(ranks)]


def _launch_delta(after: dict, before: dict) -> dict:
    return {k: v - before.get(k, 0) for k, v in after.items()
            if v - before.get(k, 0)}


def _check_elastic(label: str, ranks: int, whole_loss, root: Path,
                   tag: str, el: dict, results, card: str,
                   whole: Path) -> dict:
    """Hold phase 18f's runs (19's on four ranks) to their bars (see the
    module's docstring) and log the resizes, the segments' launches and
    rows, the standby and the runs' seconds.  The references resume from
    the state the elastic run saved after each migration, so that state
    is held to checkpoints no migration wrote: the shrink's to 18b's
    uninterrupted run's step-``ELASTIC_SHRINK`` save (``whole``), the
    grow's to the shrunk segment's reference's final save."""
    from flexflow_tpu_torch.obs import read_run
    from flexflow_tpu_torch.ops.kernels import flash_attention as fa
    from flexflow_tpu_torch.ops.kernels import fused_ce as ce

    idx = el["index"]
    grow = ELASTIC_GROW[ranks]
    e = results[idx["E"]]
    ex = _extra(root, tag, idx["E"], ranks)
    loss = e[0]["loss"]
    _log(f"{label}: losses {loss}; {ex[0]['seconds']:.1f} s for the run "
         f"(rank 0's wall clock); {card}")
    if len(loss) != ELASTIC_ITERS or not all(math.isfinite(v)
                                             for v in loss):
        raise AssertionError(f"{label}: losses {loss}")
    if loss[:ELASTIC_SHRINK] != whole_loss[:ELASTIC_SHRINK]:
        raise AssertionError(f"{label}: the steps before the loss "
                             f"{loss[:ELASTIC_SHRINK]} are not 18b's "
                             f"{whole_loss[:ELASTIC_SHRINK]} bit for bit")
    if [r.get("out_of_service") for r in e] != [None] * ranks \
            or [r["elastic_resizes"] for r in e] != [2] * ranks \
            or [r["devices"] for r in e] != [ranks] * ranks \
            or any(r["loss"] != loss for r in e):
        raise AssertionError(f"{label}: ranks' results "
                             f"{[(r.get('out_of_service'), r.get('devices'), r.get('elastic_resizes')) for r in e]}")
    lost = list(range(ranks // 2, ranks)) if ranks > 2 else [1]
    for r in range(ranks):
        sb = ex[r]["hooks"]["standby"]
        want = [{"op": "grow", "step": grow}] if r in lost else []
        if [{k: v[k] for k in ("op", "step")} for v in sb] != want:
            raise AssertionError(f"{label}: rank {r} stood by {sb}")
        if sb:
            _log(f"{label}: rank {r} out of service from step "
                 f"{ELASTIC_SHRINK}, {sb[0]['seconds']:.1f} s standing by, "
                 f"called back at step {sb[0]['step']}")
    records = list(read_run(e[0]["obs_path"]))
    kinds = [x["kind"] for x in records]
    resizes = [x for x in records if x["kind"] == "elastic_resize"]
    i_inj = next(i for i, x in enumerate(records) if x["kind"] == "fault"
                 and x.get("fault") == "device_loss")
    order = [i_inj, kinds.index("device_loss"), records.index(resizes[0]),
             kinds.index("device_return"), records.index(resizes[-1])]
    if len(resizes) != 2 or order != sorted(order):
        raise AssertionError(f"{label}: records out of order: {kinds}")
    shrink, grown = resizes
    want = [("shrink", ranks, ranks // 2, "in_memory", ELASTIC_SHRINK, 0),
            ("grow", ranks // 2, ranks, "in_memory", grow, 0)]
    got = [(x["direction"], x["from_devices"], x["to_devices"],
            x["migration"], x["resume_step"], x["steps_lost"])
           for x in resizes]
    if got != want:
        raise AssertionError(f"{label}: resizes {got}, want {want}")
    for x in resizes:
        _log(f"{label}: {x['direction']} {x['from_devices']} -> "
             f"{x['to_devices']} at step {x['step']}: migration "
             f"{x['migration']}, {x['steps_lost']} steps lost, research_s "
             f"{x['research_s']:.3f} ({x['research']['mode']}, "
             f"{x['research'].get('iters')} proposals), total_s "
             f"{x['total_s']:.2f}, regrid_bytes {x['regrid_bytes']:.0f}, "
             f"regrid_hops {x['regrid_hops']}, regrid_predicted_s "
             f"{x['regrid_predicted_s']:.4f}; {card}")
    marks = ex[0]["hooks"]["marks"]
    segs = [_launch_delta(m["launches"], marks[i - 1]["launches"] if i
                          else {}) for i, m in enumerate(marks)]
    names = (fa.NAME, fa.NAME_DKV, fa.NAME_DQ, ce.NAME_FWD,
             ce.NAME_FWD_COMBINE, ce.NAME_DX, ce.NAME_DX_SUM, ce.NAME_DW)
    spans = ((1, ELASTIC_SHRINK), (ELASTIC_SHRINK + 1, grow),
             (grow + 1, ELASTIC_ITERS))
    for m, seg, steps in zip(marks, segs, spans):
        _log(f"{label}: rank 0's launches in steps {steps[0]}-{steps[1]} "
             f"(to the {m['at']}): {seg}; vocab-head rows N {m['rows']}")
    out = {"loss": loss, "seconds": ex[0]["seconds"], "shrink": shrink,
           "grow": grown, "segments": segs,
           "rows": [m["rows"] for m in marks]}
    refs = [("S", ELASTIC_SHRINK, grow, 1, ranks // 2),
            ("G", grow, ELASTIC_ITERS, 2, ranks)]
    wants = {}
    for key, lo, hi, seg, n in refs:
        ref = results[idx[key]][0]
        sec = _extra(root, tag, idx[key], 1)[0]["seconds"]
        rel = max(abs(a - b) / max(abs(b), 1e-30)
                  for a, b in zip(loss[lo:hi], ref["loss"]))
        wants[seg] = {k: v for k, v in ref["launches"].items() if v}
        _log(f"{label}: steps {lo + 1}-{hi} {loss[lo:hi]} vs the run "
             f"resumed from step {lo}'s checkpoint {ref['loss']}: max "
             f"relative difference {rel:.3e} (tolerance {ELASTIC_RTOL:g}); "
             f"its launches {wants[seg]}; {sec:.1f} s on {n} rank(s)")
        if len(ref["loss"]) != hi - lo or rel > ELASTIC_RTOL:
            raise AssertionError(f"{label}: steps {lo + 1}-{hi} differ from "
                                 f"the resumed run's")
    grow_ref = el["shrunk"] / f"step_{grow:08d}"
    for what, want, got in (
            ("shrink", whole / f"step_{ELASTIC_SHRINK:08d}",
             el["shrunk"] / f"step_{ELASTIC_SHRINK:08d}"),
            ("grow", grow_ref, el["grown"] / f"step_{grow:08d}")):
        equal, worst, n = _leaves_diff(f"{label} {what}", want, got)
        _log(f"{label}: the state migrated at the {what} ({got.parent.name}"
             f"/{got.name}) vs {want.parent.name}/{want.name}, saved by a "
             f"run that never migrated: {n} leaves "
             f"{'equal bit for bit' if equal else f'within {worst:.3e}'}")
        if not (equal or worst <= ELASTIC_RTOL):
            raise AssertionError(f"{label}: the state migrated at the "
                                 f"{what} is {worst:.3e} from {want}'s")
        out[f"{what}_state"] = {"equal": equal, "worst": worst, "leaves": n}
    nf = results[idx["NF"]][0]["loss"]
    seconds = sum(_extra(root, tag, idx[k], 1)[0]["seconds"] for k in idx)
    _log(f"{label}: --elastic without a fault {nf} vs 18b's "
         f"{whole_loss[:2]}: bit-equal {nf == whole_loss[:2]}; the "
         f"phase's runs {seconds:.1f} s in all (rank 0's wall clock)")
    if nf != whole_loss[:2]:
        raise AssertionError(f"{label}: --elastic changed a healthy run")
    # the kernels: every one of 1-6 in every segment, steps 1-2 as 18b's,
    # later ones as the reference runs' (on one rank, the whole batch)
    for seg, steps in zip(segs, spans):
        if not all(seg.get(n, 0) + seg.get(f"{n}.partial", 0)
                   for n in names):
            raise AssertionError(f"{label}: a kernel of 1-6 was not "
                                 f"launched in steps {steps}: {seg}")
    before = _lm_rank_launches(ELASTIC_SHRINK, LM_RANKS_LAYERS)
    if segs[0] != before:
        raise AssertionError(f"{label}: launches before the shrink "
                             f"{segs[0]}, want {before}")
    for seg, want in wants.items():
        if segs[seg] != want:
            raise AssertionError(f"{label}: launches in steps "
                                 f"{spans[seg]} {segs[seg]}, the resumed "
                                 f"run's {want}")
    if ranks == 2 and marks[1]["rows"] != [CE_SHAPE[0]]:
        raise AssertionError(f"{label}: the one-rank segment's vocab head "
                             f"saw rows {marks[1]['rows']}, want "
                             f"[{CE_SHAPE[0]}]")
    out["seconds_all"] = seconds
    return out


def _check_ranks_supervised(label: str, results, asyn_res, drained_res,
                            whole: Path, asyn: Path, drained: Path,
                            steps: int) -> None:
    """The two-rank LM's supervision: the resumed run, written through
    the async writer, commits the synchronous run's step-``steps`` bytes
    (SHA-256; :func:`_check_resume` holds its losses); the run asked to
    drain on rank 0 alone (``preempt@1``) stops on every rank at the
    step-``LM_CKPT_FREQ`` boundary with one record, mode ``async``, and
    the synchronous step's bytes."""
    from flexflow_tpu_torch.utils import checkpoint as ckpt

    ok, why = ckpt.verify_checkpoint(str(asyn), steps)
    if not ok or _ckpt_digests(asyn, steps) != _ckpt_digests(whole, steps):
        raise AssertionError(f"{label} async: step {steps}: {why}, bytes "
                             f"differ from the synchronous save's")
    _log(f"{label} async (the resumed run): the step-{steps} checkpoint's "
         f"bytes equal the synchronous run's; rank 0's submit-to-commit "
         f"{asyn_res[0]['ckpt_async']['commits']}")
    records = [r.get("drain") for r in drained_res]
    stops = [r["completed_steps"] for r in drained_res]
    _log(f"{label} drain (preempt@1 on rank 0 alone): ranks stopped at "
         f"{stops}; records {records}")
    keep = ("step", "ckpt_step", "mode", "signal")
    if stops != [LM_CKPT_FREQ] * len(drained_res) \
            or any(r is None for r in records) \
            or {tuple(r[k] for k in keep) for r in records} \
            != {(LM_CKPT_FREQ, LM_CKPT_FREQ, "async",
                 int(signal.SIGTERM))} \
            or ckpt.latest_step(str(drained)) != LM_CKPT_FREQ \
            or _ckpt_digests(drained, LM_CKPT_FREQ) \
            != _ckpt_digests(whole, LM_CKPT_FREQ):
        raise AssertionError(f"{label} drain: {stops}, {records}")


def _leaves_diff(label: str, want: Path, got: Path) -> tuple:
    """Two committed steps' leaves (``arrays.npz``; rank 0 writes them
    gathered whole, whatever the strategy): ``(bit-equal, the largest
    relative difference against ``want``, the number of leaves)``;
    raises when they hold different leaves."""
    import numpy as np

    with np.load(want / "arrays.npz") as a, \
            np.load(got / "arrays.npz") as b:
        if sorted(a.files) != sorted(b.files):
            raise AssertionError(f"{label}: leaves {b.files} vs {a.files}")
        worst = max(float(np.max(np.abs(a[k].astype(np.float64)
                                        - b[k].astype(np.float64))
                                 / np.maximum(np.abs(a[k].astype(
                                     np.float64)), 1e-30), initial=0.0))
                    for k in a.files)
        equal = all(np.array_equal(a[k], b[k]) for k in a.files)
        return equal, worst, len(a.files)


def _check_resume(label: str, results, resumed, whole: Path, cut: Path,
                  steps: int, card: str) -> None:
    """The run resumed from the step-``LM_CKPT_FREQ`` checkpoint of the
    uninterrupted one (``results``) against it: its losses, and the
    leaves of both runs' last checkpoints (rank 0 writes the leaves
    gathered whole), bit for bit or within ``LM_RESUME_RTOL`` (relative)
    with the difference logged; rank 0's launches those of its steps;
    the save and restore seconds logged."""
    res, again = results[0], resumed[0]
    tail = res["loss"][LM_CKPT_FREQ:]
    want = _lm_rank_launches(steps - LM_CKPT_FREQ, LM_RANKS_LAYERS)
    if {k: v for k, v in again["launches"].items() if v} != want:
        raise AssertionError(f"{label} resumed: launches on rank 0 "
                             f"{again['launches']}, want {want}")
    equal, worst, n = _leaves_diff(f"{label} resumed",
                                   whole / f"step_{steps:08d}",
                                   cut / f"step_{steps:08d}")
    losses_rel = max(abs(x - y) / max(abs(y), 1e-30)
                     for x, y in zip(again["loss"], tail))
    _log(f"{label} resumed from step {LM_CKPT_FREQ}: losses "
         f"{again['loss']} vs {tail} (max relative difference "
         f"{losses_rel:.3e}), {n} leaves of the step-{steps} checkpoints "
         f"{'equal bit for bit' if equal else f'within {worst:.3e}'}; "
         f"saves inside the loop {res['checkpoint_s']:.2f} s (the "
         f"uninterrupted run), restore {again['restore_s']:.2f} s; {card}")
    if not (equal or worst <= LM_RESUME_RTOL) \
            or losses_rel > LM_RESUME_RTOL:
        raise AssertionError(f"{label} resumed: leaves within {worst:.3e}, "
                             f"losses within {losses_rel:.3e} of the "
                             f"uninterrupted run's")


def lm_strategy_phase(torch, kernels, card: str, lm_run: dict,
                      strategy_run: dict) -> dict:
    """The GPT trainer through torchrun on one rank (NCCL) under a
    one-device strategy file at the LM phase's widths and steps against
    the LM phase's run without a strategy in this process; then two gloo
    ranks on cuda:0 under ``_lm_strategy_file``: ring and head-parallel
    attention, channel-split MLPs, sequence-split norms, the embedding on
    rank 1 and the fused vocab-parallel head."""
    from flexflow_tpu_torch.ops.kernels import flash_attention as fa
    from flexflow_tpu_torch.ops.kernels import fused_ce as ce

    root = STRATEGY_ROOT
    root.mkdir(exist_ok=True)
    try:
        iters = LM_WARMUP + LM_TIMED
        # run in the strategy phase's one-rank world
        res = strategy_run["one_rank"]["lm"]
        step_ms = res["elapsed_s"] / LM_TIMED * 1e3
        _log(f"lm strategy 1 rank (NCCL, every op one point on device 0): "
             f"{res['tokens_per_sec']:.1f} tokens/s, {step_ms:.3f} ms a "
             f"step, peak {res['peak_memory_bytes'] / 1e9:.3f} GB (the "
             f"strategy phase's one-rank world); "
             f"without a strategy in this process "
             f"{lm_run['tokens_per_sec']:.1f} tokens/s, "
             f"{lm_run['step_ms']:.3f} ms; {card}")
        want = {name: LM_LAYERS * iters
                for name in (fa.NAME, fa.NAME_DKV, fa.NAME_DQ)}
        want.update({name: iters for name in (
            ce.NAME_FWD, ce.NAME_FWD_COMBINE, ce.NAME_DX, ce.NAME_DX_SUM,
            ce.NAME_DW)})
        _check_lm_run("lm strategy 1 rank", res, lm_run["loss"], want)
        out = {"one": {"tokens_per_sec": res["tokens_per_sec"],
                       "step_ms": step_ms, "loss": res["loss"]}}
        carried = strategy_run["gloo_cuda"]
        needed = GLOO_CUDA_NEEDED + ("all_reduce_max",)
        if not all(carried[c] == "ok" for c in needed):
            raise AssertionError(f"lm strategy: gloo does not carry CUDA "
                                 f"tensors for {needed}: {carried}")
        _log(f"lm strategy: ring rotations over gloo on CUDA tensors move "
             f"by all-gather (gloo's send_recv on CUDA tensors: "
             f"{carried['send_recv']})")
        # the reference of the runs over ranks: one process at their
        # depth, without a strategy
        import gc

        from flexflow_tpu_torch.apps import lm

        out["ref"] = lm.main(_lm_argv(LM_RANKS_WARMUP + LM_RANKS_STEPS,
                                      LM_RANKS_WARMUP, LM_RANKS_WIDTHS),
                             log=lambda *a: None)["loss"]
        gc.collect()
        torch.cuda.empty_cache()
        _log(f"lm strategy: the {LM_RANKS_LAYERS}-block reference in this "
             f"process {out['ref']}")
        out["two"] = _lm_ranks_run(
            2, root, card, out["ref"],
            ["--device", "cuda:0", "--dist-backend", "gloo"],
            supervised=True)
        return out
    finally:
        shutil.rmtree(root, ignore_errors=True)


def lm_strategy4_phase(torch, kernels, card: str, lm_strategy: dict) -> dict:
    """The LM phase's strategy over four cards (NCCL, a card a rank): ring
    x data parallel attention (s = 2, n = 2) in the even blocks, h = 4
    in the odd, the head split four ways over the vocab, against the
    one-rank run."""
    import shutil

    root = STRATEGY_ROOT
    root.mkdir(exist_ok=True)
    try:
        one = lm_strategy["one"]
        out = _lm_ranks_run(4, root, card, lm_strategy["ref"], [])
        _log(f"lm strategy 4: one card {one['tokens_per_sec']:.1f} tokens/s "
             f"({one['step_ms']:.3f} ms a step), four cards "
             f"{out['tokens_per_sec']:.1f} tokens/s ({out['step_ms']:.3f} "
             f"ms a step)")
        return out
    finally:
        shutil.rmtree(root, ignore_errors=True)


# the MoE blocks' grids over 2 and 4 ranks, cycled over the blocks:
# expert parallel and TP inside the experts; over four, EP x DP and TP x
# DP too
MOE_GRIDS = {2: [(2, 1, 1), (1, 2, 1)], 4: [(4, 1, 1), (2, 1, 2), (1, 2, 2)]}
# the op probe's grids: those, and over 2 ranks the batch split too,
# which sums the aux loss's statistics over the n group
MOE_PROBE_GRIDS = {2: [(2, 1, 1), (1, 2, 1), (1, 1, 2)],
                   4: [(4, 1, 1), (2, 1, 2), (1, 2, 2)]}
MOE_D_FF, MOE_TOP_K, MOE_CAPACITY = 3072, 2, 2.0
MOE_PROBE_SHAPE = (LM_SHAPE[0], LM_SHAPE[2], 768)     # B, S, D
# the probe's capacity factors: the LM's, at which its seeded x drops
# nothing, and 1.0, at which every rank's rows drop choices, so the
# local inverse's sentinel for a dropped choice runs under each grid
MOE_PROBE_CAPACITIES = (MOE_CAPACITY, 1.0)
PIPE_STAGES, PIPE_MICROBATCHES = 2, 4
# the pipeline probe's head, drawn in place of init's zero head: with a
# zero head the first loss is ln V whatever the blocks compute
PIPE_PROBE_SEED = 11
PIPE_FILE = (Path(__file__).resolve().parent / "examples" / "strategies"
             / "transformer_2x4.json")
# the file's block run against the flags' run of the same (S, M): the same
# code on the same inputs
PIPE_FILE_RTOL = 1e-6
# the GPipe proposal is searched for four cards: on two, JAX's rule (S <
# n) leaves no candidate
PROPOSAL_DEVICES = 4


def _moe_strategy_file(path: Path, ranks: int,
                       layers: int = LM_LAYERS) -> None:
    """``_lm_strategy_file``'s placements of the attention, norms,
    residuals, embedding and head over ``ranks`` (``layers`` blocks),
    with ``blk{i}_moe`` cycling through ``MOE_GRIDS[ranks]`` (one rank:
    every grid a point on device 0)."""
    _lm_strategy_file(path, ranks, layers)
    obj = json.loads(path.read_text())
    grids = MOE_GRIDS.get(ranks, [(1, 1, 1)])
    for i in range(layers):
        for op in ("ff1", "ff2", "gelu"):
            del obj[f"blk{i}_{op}"]
        obj[f"blk{i}_moe"] = {"dims": list(grids[i % len(grids)]),
                              "devices": list(range(ranks))}
    path.write_text(json.dumps(obj, indent=1))


def _rel(got, want) -> float:
    """The largest difference of ``got`` from ``want`` relative to
    ``want``'s largest magnitude."""
    return float((got - want).abs().max()) \
        / max(float(want.abs().max()), 1e-30)


def _moe_probe(torch, machine, grids) -> dict:
    """The MoE op at the MoE LM's widths (B 16, S 512, D 768, 8 experts,
    d_ff 3072, top-2, float32) at each capacity factor of
    ``MOE_PROBE_CAPACITIES`` under each grid of ``grids`` over this
    world, from seeded params, x and cotangent g, through
    ``FFModel.apply`` on the rank's blocks with the gradients of
    sum(y * g) + 0.5 aux summed as a step sums them; against the op on
    one device on the whole x in this process.  Per grid and capacity:
    the rank's rows, whether its routing of them equals the one-device
    routing of those rows bit for bit, their dropped share, the largest
    differences of y, aux and the gradients (each leaf's and x's
    relative to its largest magnitude) and the rank's block of ``w1``."""
    from flexflow_tpu_torch.config import FFConfig
    from flexflow_tpu_torch.model import FFModel
    from flexflow_tpu_torch.parallel import collectives
    from flexflow_tpu_torch.strategy import ParallelConfig, Strategy

    dev = machine.device
    b, s, d = MOE_PROBE_SHAPE
    gen = torch.Generator(device=dev)
    gen.manual_seed(7)
    x = torch.randn((b, s, d), generator=gen, device=dev)
    g = torch.randn((b, s, d), generator=gen, device=dev)
    out, ones = {}, {}
    for capacity in MOE_PROBE_CAPACITIES:
        for dims in grids:
            cfg = FFConfig(batch_size=b)
            cfg.strategies = Strategy()
            cfg.strategies["moe"] = ParallelConfig(
                tuple(dims), tuple(range(math.prod(dims))))
            ff = FFModel(cfg, machine)
            t = ff.create_input((b, s, d), name="x")
            ff.moe("moe", t, MOE_EXPERTS, MOE_D_FF, MOE_TOP_K, capacity)
            op = ff.layers[-1]
            full = ff._init_full(0)[0]["moe"]
            if capacity not in ones:
                leaves = {k: v.clone().requires_grad_(True)
                          for k, v in full.items()}
                xx = x.clone().requires_grad_(True)
                (y1, aux1), _ = op.forward(leaves, {}, [xx], True)
                grads = torch.autograd.grad(
                    (y1 * g).sum() + 0.5 * aux1,
                    list(leaves.values()) + [xx])
                ones[capacity] = (op.route(full, x)[2], y1.detach(),
                                  float(aux1.detach()),
                                  dict(zip(leaves, grads[:-1])),
                                  grads[-1])
            one = ones[capacity]
            ff._setup_sharded()
            p = {k: v.clone().requires_grad_(True)
                 for k, v in ff.shard_params({"moe": full})["moe"].items()}
            (xl,) = ff.local_batch(x)
            xl = xl.clone().requires_grad_(True)
            lo, hi = ff._boxes_of(op, op.output_spec(), x.shape)[
                machine.position][0]
            first = ff._first_holder(op, op.output_spec(), x.shape)
            with collectives.token_chain(dev) as chain:
                values, _ = ff.apply({"moe": p}, {}, {t.tid: xl}, True)
                y, aux = values[op.output.tid], values[op.aux.tid]
                loss = collectives.global_sum(
                    (y * g[lo:hi]).sum() * float(first),
                    machine.world_group()) \
                    + 0.5 * (aux if ff.aux_counted(op) else aux.detach())
                keys = sorted(p)
                grads = torch.autograd.grad(loss + chain.token,
                                            [p[k] for k in keys]
                                            + [xl, chain.first])[:-1]
            synced = ff._sync_grads([("moe", k) for k in keys],
                                    list(grads[:-1]))
            boxes = ff.param_boxes()["moe"]
            slots = op.route(p, x[lo:hi])[2]
            blo, bhi = machine.batch_block(b)
            grad_err = max(
                [_rel(gg, one[3][k][tuple(slice(a, c) for a, c in boxes[k])])
                 for k, gg in zip(keys, synced)]
                + [_rel(grads[-1], one[4][blo:bhi])])
            out[f"{'x'.join(map(str, dims))} capacity {capacity:g}"] = {
                "capacity": capacity, "rows": [lo, hi],
                "routing_equal": bool(torch.equal(slots, one[0][lo:hi])),
                "dropped": float((slots == MOE_EXPERTS * op.capacity)
                                 .float().mean()),
                "y_err": _rel(y.detach(), one[1][lo:hi]),
                "aux_err": abs(float(aux.detach()) - one[2]),
                "grad_err": grad_err,
                "w1_box": boxes["w1"]}
            del ff, p, values, y, grads, synced
    return out


def _pipe_probe(torch, machine, configs, argv) -> dict:
    """The pipelined LM at the widths ``argv`` gives ``apps.lm``, for each
    ``(stages, microbatches, tp)`` of ``configs`` over this world: the
    loss and every leaf's gradient through the GPipe ring
    (``PipelinedLM.loss_fn``, summed over each leaf's holders) against
    the sequential reference (``loss_reference``) on the whole tree in
    this process, on the run's first batch, from ``init_full`` with its
    zero head replaced by a seeded normal one so that the blocks reach
    the loss.  Per config: the rank's (stage, n, tp), both losses and
    their relative difference, the largest gradient difference (each
    leaf's block relative to the reference's largest magnitude there)
    with its leaf, and the smallest of the block leaves' largest
    reference gradients."""
    from flexflow_tpu_torch.apps import lm
    from flexflow_tpu_torch.parallel.pipeline import PipelinedLM

    dev = machine.device
    out = {}
    for stages, mb, tp in configs:
        cfg = lm.parse_args(list(argv) + [
            "--pipeline-stages", str(stages), "--microbatches", str(mb),
            "--pipeline-tp", str(tp)])[0]
        model = PipelinedLM(
            machine, stages, mb, num_layers=cfg.num_layers,
            d_model=cfg.d_model, num_heads=cfg.num_heads, d_ff=cfg.d_ff,
            vocab_size=cfg.vocab_size, seq_length=cfg.seq_length,
            batch_size=cfg.batch_size, causal=cfg.causal,
            learning_rate=cfg.learning_rate, tp=tp)
        full = model.init_full(cfg.seed)
        gen = torch.Generator(device=dev)
        gen.manual_seed(PIPE_PROBE_SEED)
        full["head_w"] = torch.randn(full["head_w"].shape, generator=gen,
                                     device=dev) / cfg.d_model ** 0.5
        toks, labels = next(lm.synthetic_lm_batches(
            cfg.batch_size, cfg.seq_length, cfg.vocab_size, seed=cfg.seed,
            device=dev))
        loss, keys, grads = model.loss_and_grads(
            model.loss_fn, model.shard_params(full), toks, labels, True)
        ref, ref_keys, ref_grads = model.loss_and_grads(
            model.loss_reference, full, toks, labels, False)
        ref_grads = dict(zip(ref_keys, ref_grads))
        boxes = model.param_boxes()
        errs, scales = {}, []
        for (a, b), gg in zip(keys, grads):
            box = boxes[a][b] if b is not None else boxes[a]
            want = ref_grads[(a, b)][tuple(slice(lo, hi) for lo, hi in box)]
            errs[b or a] = _rel(gg, want)
            if b is not None:
                scales.append(float(want.abs().max()))
        worst = max(errs, key=errs.get)
        out[f"{stages}x{mb}x{tp}"] = {
            "coords": list(model.coords()), "loss": float(loss),
            "ref_loss": float(ref),
            "loss_rel": abs(float(loss) - float(ref)) / abs(float(ref)),
            "grad_err": errs[worst], "worst": worst,
            "block_grad_min": min(scales)}
        del model, full, grads, ref_grads
    return out


def _check_probe(label: str, probes: list) -> None:
    """Hold the MoE op probe of every rank to its bars: its routing of its
    rows bit-equal to one device's, y and the gradients within 1e-4 of
    the largest magnitude, aux within 1e-6, and at capacity 1.0 some
    choices dropped."""
    for r, per_grid in enumerate(probes):
        for grid, res in per_grid["moe"].items():
            _log(f"{label}: rank {r} grid {grid} rows {res['rows']}: "
                 f"routing equal to one device's {res['routing_equal']}, "
                 f"dropped {res['dropped']:.4f} of its (token, choice) "
                 f"pairs, y {res['y_err']:.3e}, aux {res['aux_err']:.3e}, "
                 f"gradients {res['grad_err']:.3e} (relative), w1 block "
                 f"{res['w1_box']}")
            if not (res["routing_equal"] and res["y_err"] <= GRAD_RTOL[
                    "float32"] and res["grad_err"] <= GRAD_RTOL["float32"]
                    and res["aux_err"] <= 1e-6
                    and (res["capacity"] != 1.0 or res["dropped"] > 0)):
                raise AssertionError(f"{label}: MoE probe on rank {r} "
                                     f"under {grid}: {res}")


def _check_pipe_probe(label: str, probes: list) -> None:
    """Hold the pipeline probe of every rank to its bars: the loss within
    1e-4 of the sequential reference's, every gradient within 1e-4 of
    the reference's largest magnitude, no block leaf's gradient zero."""
    for r, per_config in enumerate(probes):
        for config, res in per_config["pipe"].items():
            _log(f"{label}: rank {r} (stages x microbatches x tp {config}) "
                 f"at (stage, n, tp) {res['coords']}: loss {res['loss']} vs "
                 f"the sequential reference's {res['ref_loss']} (relative "
                 f"{res['loss_rel']:.3e}); gradients within "
                 f"{res['grad_err']:.3e} of the reference's largest "
                 f"magnitude (worst {res['worst']}), block gradients "
                 f"reach at least {res['block_grad_min']:.3e}")
            if not (res["loss_rel"] <= LM_LOSS_RTOL
                    and res["grad_err"] <= GRAD_RTOL["float32"]
                    and res["block_grad_min"] > 0):
                raise AssertionError(f"{label}: pipeline probe on rank {r} "
                                     f"under {config}: {res}")


def moe_strategy_phase(torch, kernels, card: str, moe_run: dict,
                       strategy_run: dict, lm_strategy=None) -> dict:
    """The MoE LM through ``torchrun --nproc-per-node 1 ... apps.lm
    --experts 8 --strategy <one-device file>`` (NCCL) at the MoE phase's
    widths, 1 + 3 steps, against the MoE phase's run without a strategy
    in this process (the same losses, the launches of kernels 1-6
    exact); then two gloo ranks on cuda:0 under
    ``_moe_strategy_file`` (the even MoE blocks (2, 1, 1), the odd (1,
    2, 1), the rest as the LM strategy phase places them) against the
    one-rank run, and the MoE op probe over the same world; the same
    world also resumes the LM strategy phase's drained two-rank run
    (``lm_strategy["two"]["drained"]``)."""
    import shutil

    from flexflow_tpu_torch.ops.kernels import flash_attention as fa
    from flexflow_tpu_torch.ops.kernels import fused_ce as ce

    root = STRATEGY_ROOT
    root.mkdir(exist_ok=True)
    steps = LM_RANKS_WARMUP + LM_RANKS_STEPS
    try:
        # run in the strategy phase's one-rank world
        res = strategy_run["one_rank"]["moe"]
        step_ms = _log_ranks_run("moe strategy 1 rank (NCCL, every op one "
                                 "point on device 0)", [res],
                                 strategy_run["one_rank"]["seconds"], card)
        _log(f"moe strategy: without a strategy in this process "
             f"{moe_run['event_ms']:.3f} ms a step by CUDA events (the MoE "
             f"phase's median; its fit rate also counts two checkpoint "
             f"saves)")
        want = {name: MOE_WIDTHS[0] * steps
                for name in (fa.NAME, fa.NAME_DKV, fa.NAME_DQ)}
        want.update({name: steps for name in (
            ce.NAME_FWD, ce.NAME_FWD_COMBINE, ce.NAME_DX, ce.NAME_DX_SUM,
            ce.NAME_DW)})
        got = {k: v for k, v in res["launches"].items() if v}
        base = moe_run["loss"][:steps]
        _log(f"moe strategy 1 rank: losses {res['loss']} vs {base} without "
             f"a strategy; launches {got}")
        if got != want or res["loss"] != base:
            raise AssertionError(f"moe strategy 1 rank: losses "
                                 f"{res['loss']} (want {base} bit for "
                                 f"bit), launches {got} (want {want})")
        out = {"one": {"tokens_per_sec": res["tokens_per_sec"],
                       "step_ms": step_ms, "loss": res["loss"]}}
        carried = strategy_run["gloo_cuda"]
        if not all(carried[c] == "ok" for c in GLOO_CUDA_NEEDED):
            raise AssertionError(f"moe strategy: gloo does not carry CUDA "
                                 f"tensors for {GLOO_CUDA_NEEDED}: "
                                 f"{carried}")
        ride = (lm_strategy or {}).get("two", {}).get("drained")
        # the runs over ranks at LM_RANKS_LAYERS blocks, and their
        # reference: one process at that depth, without a strategy
        import gc

        from flexflow_tpu_torch.apps import lm

        argv = _moe_ranks_argv()
        out["ref"] = lm.main(argv, log=lambda *a: None)["loss"]
        gc.collect()
        torch.cuda.empty_cache()
        _log(f"moe strategy: the {LM_RANKS_LAYERS}-block reference in this "
             f"process {out['ref']}")
        out["two"] = _moe_ranks_run(2, root, card, out["ref"], argv,
                                    ["--device", "cuda:0", "--dist-backend",
                                     "gloo"], ride=ride)
        return out
    finally:
        shutil.rmtree(root, ignore_errors=True)
        shutil.rmtree(DRAIN_ROOT, ignore_errors=True)


def _moe_ranks_argv() -> list:
    """The MoE LM's flags over several ranks: ``LM_RANKS_LAYERS`` blocks,
    1 + 3 steps."""
    return _lm_argv(LM_RANKS_WARMUP + LM_RANKS_STEPS, LM_RANKS_WARMUP,
                    LM_RANKS_WIDTHS) + ["--experts", str(MOE_EXPERTS)]


def _moe_ranks_run(ranks: int, root: Path, card: str, want_loss, argv,
                   extra, ride=None) -> dict:
    """The MoE LM over ``ranks`` under ``_moe_strategy_file`` and the MoE
    op probe, in one torchrun world, held to their bars; with ``ride``
    (the LM's drained two-rank checkpoint and the uninterrupted run's
    losses after it), the LM resumed from it in the same world
    repeats those losses within ``LM_RESUME_RTOL``."""
    path = root / f"moe_{ranks}.json"
    _moe_strategy_file(path, ranks, LM_RANKS_LAYERS)
    runs = [argv + ["--strategy", str(path)]]
    if ride:
        lm_path = root / f"lm_{ranks}.json"
        _lm_strategy_file(lm_path, ranks, LM_RANKS_LAYERS)
        runs.append(_lm_argv(LM_RANKS_WARMUP + LM_RANKS_STEPS,
                             LM_RANKS_WARMUP, LM_RANKS_WIDTHS)
                    + ["--ckpt-freq", str(LM_CKPT_FREQ), "--ckpt-dir",
                       ride["dir"], "--strategy", str(lm_path)])
    results, probes, seconds = _lm_ranks(
        ranks, root, f"moe_{ranks}", runs, list(extra),
        moe_probe=MOE_PROBE_GRIDS[ranks])
    if ride:
        again = results[1][0]
        rel = max(abs(x - y) / max(abs(y), 1e-30)
                  for x, y in zip(again["loss"], ride["tail"]))
        _log(f"lm strategy {ranks} ranks drained resume (in the MoE "
             f"world): losses {again['loss']} vs {ride['tail']} (max "
             f"relative difference {rel:.3e}, tolerance "
             f"{LM_RESUME_RTOL:g}); restore {again['restore_s']:.2f} s")
        if len(again["loss"]) != len(ride["tail"]) \
                or not rel <= LM_RESUME_RTOL:
            raise AssertionError(f"the drained two-rank LM resumed: "
                                 f"{again['loss']} vs {ride['tail']}")
    results = results[0]
    label = f"moe strategy {ranks} ranks ({' '.join(extra) or 'NCCL'})"
    step_ms = _log_ranks_run(label, results, seconds, card)
    _check_lm_run(label, results[0], want_loss,
                  _lm_rank_launches(LM_RANKS_WARMUP + LM_RANKS_STEPS,
                                    LM_RANKS_LAYERS))
    _check_probe(f"{label} probe", probes)
    return {"tokens_per_sec": results[0]["tokens_per_sec"],
            "step_ms": step_ms, "launches": results[0]["launches"]}


def moe_strategy4_phase(torch, kernels, card: str, moe_ranks: dict) -> dict:
    """The MoE LM over four cards (NCCL, a card a rank) with its blocks
    cycling (4, 1, 1), (2, 1, 2), (1, 2, 2), the op probe under those
    grids, against the one-rank run."""
    import shutil

    root = STRATEGY_ROOT
    root.mkdir(exist_ok=True)
    try:
        one = moe_ranks["one"]
        out = _moe_ranks_run(4, root, card, moe_ranks["ref"],
                             _moe_ranks_argv(), [])
        _log(f"moe strategy 4: one card {one['tokens_per_sec']:.1f} tokens/s "
             f"({one['step_ms']:.3f} ms a step), four cards "
             f"{out['tokens_per_sec']:.1f} tokens/s ({out['step_ms']:.3f} "
             f"ms a step)")
        return out
    finally:
        shutil.rmtree(root, ignore_errors=True)


def _pipe_argv(*extra) -> list:
    return _lm_argv(LM_RANKS_WARMUP + LM_RANKS_STEPS, LM_RANKS_WARMUP) \
        + list(extra)


def _pipe_flags(stages: int, microbatches: int, tp: int = 1) -> list:
    return _pipe_argv("--pipeline-stages", str(stages), "--microbatches",
                      str(microbatches), "--pipeline-tp", str(tp))


def _pipe_launches(stages: int, microbatches: int) -> dict:
    """Each rank's launches of kernels 1-3 in the pipelined run: its
    L/S blocks at each of the M + S - 1 ticks, every step; the vocab
    head is the plain one of JAX's pipelined LM."""
    from flexflow_tpu_torch.ops.kernels import flash_attention as fa

    n = LM_LAYERS // stages * (microbatches + stages - 1) \
        * (LM_RANKS_WARMUP + LM_RANKS_STEPS)
    return {fa.NAME: n, fa.NAME_DKV: n, fa.NAME_DQ: n}


def _check_pipe_run(label: str, results: list, want_loss, launches: dict,
                    rtol: float = LM_LOSS_RTOL) -> float:
    """Every rank's launches of kernels 1-3 exactly ``launches``, the first
    3 losses within ``rtol`` of ``want_loss``.  These losses see the
    blocks only through the zero-initialised head's small first
    updates: the pipeline probe holds the blocks."""
    for r, res in enumerate(results):
        got = {k: v for k, v in res["launches"].items() if v}
        if got != launches:
            raise AssertionError(f"{label}: rank {r} launched {got}, want "
                                 f"{launches}")
    n = LM_CHECKED
    got = results[0]["loss"]
    rel = max(abs(a - b) / max(abs(b), 1e-30)
              for a, b in zip(got[:n], want_loss[:n]))
    _log(f"{label}: first losses {got[:n]} vs {want_loss[:n]}: max relative "
         f"difference {rel:.3e} (tolerance {rtol:g}); launches on every "
         f"rank {launches}")
    if not (all(math.isfinite(v) for v in got) and rel <= rtol):
        raise AssertionError(f"{label}: losses {got[:n]} differ from "
                             f"{want_loss[:n]}")
    return rel


def _pipe_reference(torch, card: str) -> list:
    """``PipelinedLM.loss_reference`` (the stages in order, no ring)
    trained in this process on the card for 1 + 3 SGD steps at the LM
    phase's widths, from the seed the pipelined runs take: its losses."""
    import gc

    from flexflow_tpu_torch.apps import lm
    from flexflow_tpu_torch.machine import MachineModel
    from flexflow_tpu_torch.parallel.pipeline import PipelinedLM

    cfg = lm.parse_args(_pipe_flags(PIPE_STAGES, PIPE_MICROBATCHES))[0]
    model = PipelinedLM(
        MachineModel("cuda", world_size=PIPE_STAGES), PIPE_STAGES,
        PIPE_MICROBATCHES, num_layers=cfg.num_layers, d_model=cfg.d_model,
        num_heads=cfg.num_heads, d_ff=cfg.d_ff, vocab_size=cfg.vocab_size,
        seq_length=cfg.seq_length, batch_size=cfg.batch_size,
        causal=cfg.causal, learning_rate=cfg.learning_rate)
    full = model.init_full(cfg.seed)
    step = model.make_reference_step()
    data = lm.synthetic_lm_batches(cfg.batch_size, cfg.seq_length,
                                   cfg.vocab_size, seed=cfg.seed)
    ref, ms = [], []
    torch.cuda.reset_peak_memory_stats()
    for _ in range(LM_RANKS_WARMUP + LM_RANKS_STEPS):
        toks, labels = next(data)
        t = time.perf_counter()
        full, loss = step(full, toks, labels)
        ref.append(float(loss))
        ms.append((time.perf_counter() - t) * 1e3)
    _log(f"pipeline reference (sequential stages in this process): losses "
         f"{ref}, {sorted(ms[LM_RANKS_WARMUP:])[LM_RANKS_STEPS // 2]:.3f} ms "
         f"a step (median of {LM_RANKS_STEPS}), peak "
         f"{torch.cuda.max_memory_allocated() / 1e9:.3f} GB; {card}")
    del full, step, model
    gc.collect()
    torch.cuda.empty_cache()
    return ref


def _proposal(torch, kernels, card: str, root: Path, devices: int) -> dict:
    """``apps.search transformer --devices <devices> --measured`` at the
    pipelined runs' batch, its transformer shards timed on this card
    (kernels 1-3 launched while timing): its GPipe candidates and
    decision logged, and the best candidate and the best of tp 1, each
    as ``{stages, microbatches, tp}`` with its simulated ``time_s``."""
    from flexflow_tpu_torch.ops.kernels import flash_attention as fa

    lines = []
    found = _measured_search(
        torch, kernels, card,
        ["transformer", "--devices", str(devices), "-b", str(LM_SHAPE[0]),
         "-i", str(SEARCH_ITERS), "--cache", str(root / "cache.json")],
        (fa.NAME, fa.NAME_DKV, fa.NAME_DQ), log=lines.append)
    for line in lines:
        if line.startswith("pipeline "):
            _log(f"proposal {devices} cards: {line}")
    pp = found["proposal"]

    def block(c):
        return {"stages": c["stages"], "microbatches": c["microbatches"],
                "tp": c["tp"], "time_s": c["time_s"]}

    cands = pp["candidates"]
    out = {"best": block(min(cands, key=lambda c: c["time_s"])),
           "tp1": block(min((c for c in cands if c["tp"] == 1),
                            key=lambda c: c["time_s"])),
           "accepted": pp["accepted"], "dp_time_s": found["dp_time_s"],
           "reference_time_s": pp["reference_time_s"]}
    _log(f"proposal {devices} cards: {len(cands)} candidates, "
         f"{'accepted' if pp['accepted'] else 'rejected'}; best {out['best']},"
         f" best of tp 1 {out['tp1']}; non-pipelined "
         f"{pp['reference_time_s']:.6e} s (data parallel "
         f"{found['dp_time_s']:.6e} s); {card}")
    return out


def _block_file(path: Path, block: dict) -> Path:
    path.write_text(json.dumps({"__pipeline__": {
        k: block[k] for k in ("stages", "microbatches", "tp")}}))
    return path


def pipeline_phase(torch, kernels, card: str, strategy_run: dict) -> dict:
    """The GPipe pipelined LM: the sequential reference in this process
    (:func:`_pipe_reference`); then two gloo ranks on cuda:0 in one
    torchrun world: ``apps.lm --pipeline-stages 2 --microbatches 4``
    against the reference; ``--strategy transformer_2x4.json`` as
    written, which the static plan check refuses on two ranks as the JAX
    driver does (its entries name eight devices): exit status 2 on every
    rank; a file of that strategy's ``__pipeline__`` block alone (2
    stages x 8 microbatches) against ``--pipeline-stages 2
    --microbatches 8`` and that run against the reference; each rank's
    launches of kernels 1-3 exact; and the pipeline probe at 2 x 4
    (:func:`_pipe_probe`)."""
    import shutil

    ref = _pipe_reference(torch, card)
    carried = strategy_run["gloo_cuda"]
    if not all(carried[c] == "ok" for c in GLOO_CUDA_NEEDED):
        raise AssertionError(f"pipeline: gloo does not carry CUDA tensors "
                             f"for {GLOO_CUDA_NEEDED}: {carried}")
    root = STRATEGY_ROOT
    root.mkdir(exist_ok=True)
    try:
        proposal = _proposal(torch, kernels, card, root, PROPOSAL_DEVICES)
        proposed = proposal["tp1"]
        block = json.loads(PIPE_FILE.read_text())["__pipeline__"]
        block_file = _block_file(root / f"{PIPE_FILE.stem}_pipeline.json",
                                 block)
        file_m = block["microbatches"]
        runs, probes, seconds = _lm_ranks(
            2, root, "pipe_2", [
                _pipe_flags(PIPE_STAGES, PIPE_MICROBATCHES),
                _pipe_argv("--strategy", str(PIPE_FILE)),
                _pipe_argv("--strategy", str(block_file)),
                _pipe_flags(PIPE_STAGES, file_m),
                _pipe_argv("--strategy", str(_block_file(
                    root / "proposed.json", proposed)))],
            ["--device", "cuda:0", "--dist-backend", "gloo"],
            pipe_probe={"configs": [(PIPE_STAGES, PIPE_MICROBATCHES, 1)],
                        "argv": _pipe_argv()})
        _log(f"pipeline: 5 runs and the probe in {seconds:.1f} s with "
             f"torchrun's start")
        label = "pipeline 2 stages x 4 microbatches (2 gloo ranks on cuda:0)"
        step_ms = _log_ranks_run(label, runs[0], seconds, card)
        _check_pipe_run(label, runs[0], ref,
                        _pipe_launches(PIPE_STAGES, PIPE_MICROBATCHES))
        if runs[1] != [{"exit": 2}] * 2:
            raise AssertionError(f"pipeline {PIPE_FILE.name} on two ranks: "
                                 f"{runs[1]}, want the plan check's exit 2 "
                                 f"on both")
        _log(f"pipeline {PIPE_FILE.name} as written on two ranks: the plan "
             f"check refuses it (exit 2 on both ranks), as the JAX driver "
             f"does")
        file_label = (f"pipeline {PIPE_FILE.name}'s __pipeline__ block "
                      f"(2 x {file_m})")
        _log_ranks_run(file_label, runs[2], seconds, card)
        _check_pipe_run(file_label, runs[2], runs[3][0]["loss"],
                        _pipe_launches(PIPE_STAGES, file_m), PIPE_FILE_RTOL)
        _check_pipe_run(f"pipeline flags 2 x {file_m}", runs[3], ref,
                        _pipe_launches(PIPE_STAGES, file_m))
        prop_label = (f"pipeline proposed block {proposed['stages']} x "
                      f"{proposed['microbatches']} (tp 1)")
        prop_ms = _log_ranks_run(prop_label, runs[4], seconds, card)
        _check_pipe_run(prop_label, runs[4], ref,
                        _pipe_launches(proposed["stages"],
                                       proposed["microbatches"]))
        _log(f"{prop_label}: measured {prop_ms / 1e3:.6e} s a step on two "
             f"gloo ranks of one card, simulated {proposed['time_s']:.6e} s "
             f"for {PROPOSAL_DEVICES} cards (non-pipelined "
             f"{proposal['reference_time_s']:.6e} s); {card}")
        _check_pipe_probe("pipeline probe (2 gloo ranks on cuda:0)", probes)
        return {"ref": ref, "step_ms": step_ms,
                "tokens_per_sec": runs[0][0]["tokens_per_sec"],
                "launches": runs[0][0]["launches"],
                "proposal": proposal, "proposed_ms": prop_ms}
    finally:
        shutil.rmtree(root, ignore_errors=True)


def pipeline4_phase(torch, kernels, card: str, pipe: dict,
                    lm4: dict) -> dict:
    """The pipelined LM over four cards (NCCL, a card a rank): 2 stages x
    2 tp, 4 stages and the pipeline phase's proposed block for four cards
    at the tp it chose, each against the sequential reference, and the
    pipeline probe at the first two; the proposal's simulated pipelined
    and non-pipelined steps logged beside the measured pipelined step and
    the LM's four-card strategy step (``lm4``), for the record."""
    import shutil

    root = STRATEGY_ROOT
    root.mkdir(exist_ok=True)
    configs = ((2, PIPE_MICROBATCHES, 2), (4, PIPE_MICROBATCHES, 1))
    best = pipe["proposal"]["best"]
    proposed = (best["stages"], best["microbatches"], best["tp"])
    try:
        runs, probes, seconds = _lm_ranks(
            4, root, "pipe_4", [_pipe_flags(*c) for c in configs]
            + [_pipe_argv("--strategy", str(_block_file(
                root / "proposed.json", best)))],
            pipe_probe={"configs": configs, "argv": _pipe_argv()})
        out = {}
        for res, (stages, mb, tp) in zip(runs, configs + (proposed,)):
            label = (f"pipeline 4 cards: {stages} stages x {tp} tp x "
                     f"{mb} microbatches")
            step_ms = _log_ranks_run(label, res, seconds, card)
            _check_pipe_run(label, res, pipe["ref"],
                            _pipe_launches(stages, mb))
            out[(stages, tp)] = step_ms
        _log(f"pipeline 4 cards, the proposed block {proposed}: simulated "
             f"{best['time_s']:.6e} s pipelined, "
             f"{pipe['proposal']['reference_time_s']:.6e} s non-pipelined; "
             f"measured {step_ms / 1e3:.6e} s pipelined, "
             f"{lm4['step_ms'] / 1e3:.6e} s the LM under its four-card "
             f"strategy; {card}")
        _check_pipe_probe("pipeline probe (4 cards)", probes)
        _log(f"pipeline 4 cards: 2 gloo ranks on one card "
             f"{pipe['step_ms']:.3f} ms a step; four cards {out}")
        return out
    finally:
        shutil.rmtree(root, ignore_errors=True)


# the search phases (ROADMAP Queue A item 4): apps.search with --measured
# at full width, then the searched AlexNet strategy trained over ranks,
# 1 warm-up and 3 steps, its first 3 losses within 1e-4 of one rank's
SEARCH_ITERS = 20000
SEARCH_LOSS_RTOL = 1e-4


def _measured_search(torch, kernels, card: str, argv, want,
                     log=lambda *a: None) -> dict:
    """``apps.search <argv> --measured`` in this process (its lines to
    ``log``): the shards it
    timed, the measurement's seconds, the kernels launched while timing
    (each of ``want`` at least once), the kind anchors and the simulated
    steps; every timed shard finite and positive, every searched entry
    among its op's candidates.  ``argv`` names a ``--cache`` file."""
    from flexflow_tpu_torch.apps import search

    kernels.reset_launches()
    t = time.perf_counter()
    out = search.main(argv + ["--measured"], log=log)
    seconds = time.perf_counter() - t
    launched = {k: kernels.launches.get(k, 0) for k in want}
    m = out["measurement"]
    cache = json.loads(Path(argv[argv.index("--cache") + 1]).read_text())
    timed = [v for k, v in cache.items() if k.startswith(m["protocol"])]
    _log(f"search {argv[0]} --devices {out['devices']} --measured: "
         f"{m['shards_timed']} shards timed in {m['timed_s']:.2f} s "
         f"({m['build_s']:.1f} s to build and time, {seconds:.1f} s in "
         f"all), {m['estimated']} shards estimated (no clone), "
         f"{m['cache_hits']} cache hits; kernel launches while timing "
         f"{launched}; kind anchors (measured / analytic) {m['anchors']}; "
         f"dp_time_s {out['dp_time_s']:.6e}, best_time_s "
         f"{out['best_time_s']:.6e}, speedup_vs_dp "
         f"{out['speedup_vs_dp']:.4f}; {card}")
    if not all(v > 0 for v in launched.values()):
        raise AssertionError(f"search {argv[0]}: the measurement launched "
                             f"{launched}, want each at least once")
    if not timed or not all(math.isfinite(v) and v > 0 for v in timed):
        raise AssertionError(f"search {argv[0]}: timed shards {timed}")
    # raises KeyError for an entry outside its op's candidate list
    out["search"].assignment_for(out["strategy"])
    n = out["devices"]
    grids = {name: (pc.dims, pc.devices)
             for name, pc in out["strategy"].items()
             if pc.dims[:-1] != (1,) * (len(pc.dims) - 1)
             or len(pc.devices) < n}
    _log(f"search {argv[0]}: {len(grids)} of {len(out['strategy'])} ops off "
         f"data parallelism (grid, devices): {grids}")
    return out


def _searched_alexnet_run(label: str, ranks: int, path: Path, extra, want,
                          root: Path, timed: int = PLACED_STEPS) -> dict:
    """AlexNet through torchrun on ``ranks`` ranks under the searched
    strategy ``path``, 1 warm-up and ``timed`` steps, its first 3 losses
    within the bar of ``want``; rank 0's result."""
    steps = PLACED_WARMUP + timed
    result = root / f"searched_{ranks}.json"
    t = time.perf_counter()
    _torchrun(ranks, ["-m", "flexflow_tpu_torch.apps.cnn"] + _alexnet_argv(
        extra + ["-s", str(path), "-ll:gpu", str(ranks), "--result-json",
                 str(result)], PLACED_WARMUP, timed), timeout=300)
    res = json.loads(result.read_text())
    n = STRATEGY_CHECKED
    got = res["loss"]
    rel = max(abs(a - b) / max(abs(b), 1e-30)
              for a, b in zip(got[:n], want[:n]))
    step_ms = res["elapsed_s"] / timed * 1e3
    _log(f"search {label}: {res['images_per_sec']:.2f} images/s, "
         f"{step_ms:.3f} ms a step, {time.perf_counter() - t:.1f} s with "
         f"torchrun's start; first losses {got[:n]} vs one rank {want[:n]}: "
         f"max relative difference {rel:.3e} (tolerance "
         f"{SEARCH_LOSS_RTOL:g}); launches on rank 0 {res['launches']}")
    if not (all(math.isfinite(v) for v in got) and len(got) == steps
            and rel <= SEARCH_LOSS_RTOL):
        raise AssertionError(f"search {label}: losses {got[:n]} differ from "
                             f"{want[:n]}")
    return dict(res, step_ms=step_ms)


# the training runs of the drift loop: 1 warm-up and 8 timed steps, only
# the last sampled, so that 7 of the 8 steps `sim_drift` divides by run
# unsampled
OBS_TIMED = 8


def _obs_flags(obs_dir: Path, run_id: str) -> list:
    """A training run's telemetry flags: its records under ``obs_dir``,
    the last of its ``PLACED_WARMUP + OBS_TIMED`` steps sampled."""
    return ["-obs-dir", str(obs_dir), "-run-id", run_id, "--op-time-every",
            str(PLACED_WARMUP + OBS_TIMED)]


def _check_trace(path: Path) -> int:
    """The search's ``-trace`` file validated (``obs/trace.py``); its
    event count."""
    from flexflow_tpu_torch.obs import trace as obstrace

    trace = json.loads(path.read_text())
    errors = obstrace.validate_trace(trace)
    if errors:
        raise AssertionError(f"{path.name}: {len(errors)} violations, "
                             f"first {errors[:3]}")
    return len(trace["traceEvents"])


def _drift_loop(label: str, obs_dir: Path, out: Path, card: str,
                kinds=()) -> dict:
    """One trained plan's drift loop from the records under ``obs_dir``
    (the search's ``search_breakdown`` and ``sim_trace``, the training
    run's ``op_time`` and ``sim_drift``): the step's drift (the search's
    prediction from the file, finite and positive), every op's simulated
    and measured seconds and its share of the drift, and
    ``apps.calibrate --from-obs``'s refit written to ``out`` (ops
    joined, an anchor for each of ``kinds``)."""
    from flexflow_tpu_torch.apps import calibrate
    from flexflow_tpu_torch.obs import read_events
    from flexflow_tpu_torch.obs import trace as obstrace

    events = []
    for f in sorted(obs_dir.iterdir()):
        if ".jsonl" in f.name:
            events.extend(read_events(str(f)))
    drifts = [e for e in events if e["kind"].startswith("sim_drift")]
    if len(drifts) != 1 or drifts[0]["kind"] != "sim_drift" \
            or drifts[0]["source"] != "artifact" \
            or not (math.isfinite(drifts[0]["value"])
                    and drifts[0]["value"] > 0):
        raise AssertionError(f"{label}: drift records {drifts}")
    drift = drifts[0]
    att = obstrace.drift_attribution(
        obstrace.sim_op_seconds(events), obstrace.real_op_seconds(events),
        {"ratio": drift["value"], "predicted_s": drift["predicted_s"],
         "measured_s": drift["measured_s"]})
    _log(f"{label}: sim_drift {drift['value']:.4f} (measured "
         f"{drift['measured_s']:.6e} s a step / simulated "
         f"{drift['predicted_s']:.6e} s); per op, simulated vs measured "
         f"alone (forward + gradient of one shard), ranked by drift; {card}")
    for r in att["ops"]:
        _log(f"{label}: {r['op']} ({r['op_kind']}) sim {r['sim_s']:.6e} s, "
             f"real {r['real_s']:.6e} s, drift {r['drift_s']:+.6e} s, share "
             f"{r['share']:.4f}, measured {r['measured']}")
    _log(f"{label}: totals {att['totals']}; simulated only "
         f"{att['sim_only']}, measured only {att['real_only']}")
    payload = calibrate.main(["--from-obs", str(obs_dir), "-o", str(out)],
                             log=lambda m: _log(f"{label}: calibrate: {m}"))
    anchors = payload["kind_anchors"]
    _log(f"{label}: refit joined {payload['joined_ops']} ops, kind anchors "
         f"{anchors}, collective scale {payload['collective_scale']}")
    if not (payload["joined_ops"] > 0 and set(kinds) <= set(anchors)):
        raise AssertionError(f"{label}: refit {payload}")
    return {"drift": drift, "attribution": att, "refit": payload}


def search_phase(torch, kernels, card: str, strategy_run: dict) -> dict:
    """``apps.search`` on the card: AlexNet and the transformer at full
    width searched for two cards with shard times measured here (kernels
    7 and 7f, then 1-3, launched while timing), the AlexNet search with
    ``-obs-dir`` and ``-trace`` (its trace validated); then the AlexNet
    strategy trained on two gloo ranks on cuda:0 against the strategy
    phase's one-rank run, with its telemetry and its last step
    sampled, and the drift loop over both runs' records
    (:func:`_drift_loop`)."""
    import shutil

    from flexflow_tpu_torch.ops.kernels import flash_attention as fa
    from flexflow_tpu_torch.ops.kernels import maxpool as mp

    root = STRATEGY_ROOT
    root.mkdir(exist_ok=True)
    obs_dir = root / "obs"
    try:
        path = root / "alexnet_searched_2.json"
        alexnet = _measured_search(
            torch, kernels, card,
            ["alexnet", "--devices", "2", "-i", str(SEARCH_ITERS), "--cache",
             str(root / "cache.json"), "-o", str(path), "-obs-dir",
             str(obs_dir), "-run-id", "search", "-trace"],
            (mp.NAME_FWD, mp.NAME_BWD))
        _log(f"search alexnet: -trace wrote {alexnet['trace_path']}, "
             f"{_check_trace(Path(alexnet['trace_path']))} events, no "
             f"violation")
        lm = _measured_search(
            torch, kernels, card,
            ["transformer", "--devices", "2", "-i", str(SEARCH_ITERS),
             "--cache", str(root / "cache.json")],
            (fa.NAME, fa.NAME_DKV, fa.NAME_DQ))
        out = {"alexnet": alexnet["measurement"], "lm": lm["measurement"]}
        carried = strategy_run.get("gloo_cuda", {})
        if not all(carried.get(c) == "ok" for c in GLOO_CUDA_NEEDED):
            raise AssertionError(f"search: gloo does not carry CUDA tensors "
                                 f"for {GLOO_CUDA_NEEDED}: {carried}")
        res = _searched_alexnet_run(
            "alexnet 2 gloo ranks on cuda:0", 2, path,
            ["--device", "cuda:0", "--dist-backend", "gloo"]
            + _obs_flags(obs_dir, "fit"), strategy_run["ref"]["loss"], root,
            OBS_TIMED)
        _log(f"search alexnet 2 ranks: simulated best_time_s "
             f"{alexnet['best_time_s']:.6e} (dp {alexnet['dp_time_s']:.6e})"
             f" for two cards; two ranks on one card measured "
             f"{res['step_ms'] / 1e3:.6e} s a step (gloo's host copies: "
             f"not the simulated machine, so the drift below is logged, "
             f"not held to a bar); one rank without a strategy "
             f"{strategy_run['ref_step_ms'] / 1e3:.6e} s")
        out["drift"] = _drift_loop("search alexnet 2 gloo ranks", obs_dir,
                                   root / "recal.json", card,
                                   ("Conv2D", "Pool2D", "Linear"))
        return out
    finally:
        shutil.rmtree(root, ignore_errors=True)


def search4_phase(torch, kernels, card: str, strategy_run: dict) -> dict:
    """AlexNet searched for four cards with shard times measured here
    (``-obs-dir``, ``-trace``), trained through ``torchrun
    --nproc-per-node 4`` (NCCL) under the searched strategy and under
    data parallelism (a file of data-parallel entries whose
    ``__predicted__`` step is the search's ``dp_time_s``), each with its
    telemetry and its last step sampled: each plan's drift loop
    (:func:`_drift_loop`; the data-parallel records hold the search's
    breakdown and simulated per-op seconds of the data-parallel
    assignment), the simulator's ranking logged beside the cards'.  The
    refits are logged, not simulated again: every shard with a clone is
    read from the search's cache, a refit's anchor only joins its kind's
    median for the shards without one, and the slow tier's constants do
    not touch one NVLink tier."""
    import shutil

    from flexflow_tpu_torch.obs import RunLog
    from flexflow_tpu_torch.ops.kernels import maxpool as mp

    root = STRATEGY_ROOT
    root.mkdir(exist_ok=True)
    obs_s, obs_dp = root / "obs_searched", root / "obs_dp"
    try:
        path = root / "alexnet_searched_4.json"
        found = _measured_search(
            torch, kernels, card,
            ["alexnet", "--devices", "4", "-i", str(SEARCH_ITERS), "--cache",
             str(root / "cache.json"), "-o", str(path), "-obs-dir",
             str(obs_s), "-run-id", "search", "-trace"],
            (mp.NAME_FWD, mp.NAME_BWD))
        _check_trace(Path(found["trace_path"]))
        ss = found["search"]
        dp = ss.dp_assignment()
        dp_strategy = ss.assignment_to_strategy(dp)
        dp_strategy.predicted = dict(found["strategy"].predicted,
                                     best_time_s=found["dp_time_s"],
                                     speedup_vs_dp=1.0)
        dp_file = root / "alexnet_dp_4.json"
        dp_strategy.save(str(dp_file))
        dp_trace = ss.simulate_trace(dp)
        with RunLog(str(obs_dp / "search.jsonl"), run_id="search",
                    surface="search") as olog:
            olog.event("search_breakdown", ops=ss.cost_breakdown(dp),
                       opt_stream_s=dp_trace["opt_stream_s"])
            olog.event("sim_trace", path="", op_s=dp_trace["op_s"],
                       total_s=dp_trace["total_s"],
                       dp_total_s=dp_trace["total_s"],
                       opt_stream_s=dp_trace["opt_stream_s"])
        want = strategy_run["ref"]["loss"]
        searched = _searched_alexnet_run(
            "alexnet 4 cards (NCCL)", 4, path, _obs_flags(obs_s, "fit"),
            want, root, OBS_TIMED)
        dp_run = _searched_alexnet_run(
            "alexnet 4 cards data parallel (NCCL)", 4, dp_file,
            _obs_flags(obs_dp, "fit"), want, root, OBS_TIMED)
        drift = searched["step_ms"] / 1e3 / found["best_time_s"]
        _log(f"search 4 cards: simulated step {found['best_time_s']:.6e} s "
             f"searched, {found['dp_time_s']:.6e} s data parallel; measured "
             f"{searched['step_ms'] / 1e3:.6e} s searched, "
             f"{dp_run['step_ms'] / 1e3:.6e} s data parallel; measured / "
             f"simulated {drift:.4f} searched, "
             f"{dp_run['step_ms'] / 1e3 / found['dp_time_s']:.4f} data "
             f"parallel; {card}")
        out = {"simulated": found["best_time_s"],
               "measured": searched["step_ms"] / 1e3,
               "dp_simulated": found["dp_time_s"],
               "dp_measured": dp_run["step_ms"] / 1e3}
        for name, obs_dir in (("searched", obs_s), ("dp", obs_dp)):
            out[f"drift_{name}"] = _drift_loop(
                f"search 4 cards {name}", obs_dir, root / f"recal_{name}.json",
                card)
        first = {who: "the searched plan" if searched_first
                 else "data parallelism" for who, searched_first in (
                     ("simulator", found["best_time_s"] < found["dp_time_s"]),
                     ("cards", searched["step_ms"] < dp_run["step_ms"]))}
        _log(f"search 4 cards: ranked first by the simulator: "
             f"{first['simulator']}; by the cards: {first['cards']}")
        return out
    finally:
        shutil.rmtree(root, ignore_errors=True)


# ---------------------------------------------------------------------------
# the verification switches and the forward-only service

#: a dumped line: tag, shape, dtype, mean, std, absmax (utils/debug.py)
DUMP_LINE = re.compile(r"^(\S+): shape=(\([^)]*\)) dtype=(\w+) mean=(\S+) "
                       r"std=(\S+) absmax=(\S+)$")
#: the dumped statistics carry six decimals: a kernel run's line is held
#: to the plain-kernel run's within the LM phase's tolerance, or one unit
#: of the last printed decimal where the value is small
DUMP_ATOL = 1.5e-6
SERVE_FORWARD_REQUESTS, SERVE_FORWARD_BATCH = 32, 8
#: requests of the drained subprocess: enough batches (32) that SIGTERM,
#: sent once the first batch is served, lands mid-run
SERVE_DRAIN_REQUESTS = 256
#: the seed of the BN statistics the DenseNet services serve with
SERVE_BN_SEED = 7
SERVE_DRAIN_ROOT = Path(__file__).resolve().parent / ".chip_serve"
SERVE_GAUGES = ("qps", "queue_depth", "latency_p50_s", "latency_p99_s",
                "requests_total")


def _dump_stats(text: str) -> dict:
    out = {}
    for line in text.splitlines():
        m = DUMP_LINE.match(line.strip())
        if m:
            out[m.group(1)] = (m.group(2), m.group(3)) + tuple(
                float(v) for v in m.groups()[3:])
    return out


def _dumped_run(torch, kernels, argv) -> tuple:
    """``apps.lm`` under ``--print-intermediates``: ``(stats by tag,
    launches, losses)``, its stdout captured."""
    import io

    from flexflow_tpu_torch.apps import lm

    buf = io.StringIO()
    kernels.reset_launches()
    with contextlib.redirect_stdout(buf):
        out = lm.main(argv + ["--print-intermediates"], log=lambda *a: None)
    torch.cuda.synchronize()
    return _dump_stats(buf.getvalue()), dict(kernels.launches), out["loss"]


def debug_phase(torch, kernels, card: str) -> dict:
    """The three verification switches of SURVEY §4 on the GPT at phase
    9's full widths: ``--dry-compile`` runs nothing, ``--params-ones``
    starts at ln V and repeats itself, ``--print-intermediates`` prints
    every op output and agrees with the plain-kernel run."""
    import gc

    from flexflow_tpu_torch.apps import lm
    from flexflow_tpu_torch.apps.lm import synthetic_lm_batches
    from flexflow_tpu_torch.machine import MachineModel
    from flexflow_tpu_torch.models.transformer import (TransformerConfig,
                                                       TransformerLM)
    from flexflow_tpu_torch.ops.kernels import flash_attention as fa
    from flexflow_tpu_torch.ops.kernels import fused_ce as ce

    # (a) the dry run: the bytes the synthetic source puts on the card are
    # all the run may add
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    held = [synthetic_lm_batches(16, 512, 32768, seed=0, device="cuda")]
    src_bytes = torch.cuda.memory_allocated() - base
    held.clear()
    gc.collect()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    lines = []
    t = time.perf_counter()
    out = lm.main(_lm_argv(LM_CHECKED, 0) + ["--dry-compile"],
                  log=lines.append)
    torch.cuda.synchronize()
    dry_s = time.perf_counter() - t
    grew = torch.cuda.max_memory_allocated() - base
    ok = [m for m in lines if m.startswith("dry-compile ok: ")]
    _log(f"debug dry-compile: {ok[0] if ok else lines}; {dry_s:.2f} s; "
         f"card memory grew by {grew} bytes (the synthetic source's "
         f"batches: {src_bytes}); compiled {out['compiled']}; launches "
         f"{dict(kernels.launches)}")
    if out["loss"] != [] or not ok:
        raise AssertionError(f"the dry run ran steps: {out['loss']}")
    if sum(kernels.launches.values()):
        raise AssertionError(f"the dry run launched kernels: "
                             f"{dict(kernels.launches)}")
    if grew > src_bytes:
        raise AssertionError(f"the dry run put {grew} bytes on the card, "
                             f"more than its data source's {src_bytes}")
    del out

    # (b) all-ones parameters: every vocab column's logit is the same
    argv = _lm_argv(LM_CHECKED, 0) + ["--params-ones"]
    runs = []
    for _ in range(2):
        gc.collect()
        torch.cuda.empty_cache()
        kernels.reset_launches()
        runs.append((lm.main(argv, log=lambda *a: None)["loss"],
                     dict(kernels.launches)))
    (ones, launches), (again, _) = runs
    want = {fa.NAME: LM_LAYERS * LM_CHECKED,
            fa.NAME_DKV: LM_LAYERS * LM_CHECKED,
            fa.NAME_DQ: LM_LAYERS * LM_CHECKED}
    want.update({n: LM_CHECKED for n in (
        ce.NAME_FWD, ce.NAME_FWD_COMBINE, ce.NAME_DX, ce.NAME_DX_SUM,
        ce.NAME_DW)})
    rel = abs(ones[0] - math.log(32768)) / math.log(32768)
    _log(f"debug params-ones: losses {ones}, a second run's {again} "
         f"(bit-equal {ones == again}); first vs ln 32768 = "
         f"{math.log(32768):.6f}: rel {rel:.3e} (tolerance 1e-5); "
         f"launches {launches}")
    if launches != want:
        raise AssertionError(f"--params-ones launched {launches}, expected "
                             f"{want}")
    if not rel <= 1e-5 or ones != again:
        raise AssertionError(f"--params-ones losses {ones} / {again}")

    # (c) the dump: one line per op output, kernels 1-3 once per block,
    # the fused head off; held to the plain-kernel run's lines
    tags = {op.name for op in TransformerLM(
        TransformerConfig(batch_size=16, causal=True),
        MachineModel.virtual(1)).layers}
    argv = _lm_argv(1, 0)
    t = time.perf_counter()
    got, launches, loss = _dumped_run(torch, kernels, argv)
    dump_s = time.perf_counter() - t
    with _plain_kernels():
        ref, plain_launches, ref_loss = _dumped_run(torch, kernels, argv)
    gc.collect()
    torch.cuda.empty_cache()
    worst, worst_tag = 0.0, None
    for tag, w in ref.items():
        g = got.get(tag)
        if g is None or g[:2] != w[:2]:
            raise AssertionError(f"dump line {tag}: {g} vs {w}")
        for a, b in zip(g[2:], w[2:]):
            err = abs(a - b) - DUMP_ATOL
            lim = LM_LOSS_RTOL * max(abs(a), abs(b))
            if err > lim:
                raise AssertionError(f"dump line {tag}: {g} vs the plain "
                                     f"kernels' {w}")
            if err / max(lim, 1e-30) > worst:
                worst, worst_tag = err / max(lim, 1e-30), tag
    _log(f"debug print-intermediates: {len(got)} lines in {dump_s:.2f} s, "
         f"e.g. {next(iter(got.items()))}; launches {launches}; every "
         f"statistic within {LM_LOSS_RTOL:g} (relative, + {DUMP_ATOL:g}) "
         f"of the plain-kernel run's (worst {worst:.3f} of the tolerance, "
         f"{worst_tag}); loss {loss} vs {ref_loss} — {card}")
    if {tag.split("/")[0] for tag in got} != tags or len(got) != len(tags):
        raise AssertionError(f"the dump printed {sorted(got)}, not one line "
                             f"per op of {sorted(tags)}")
    if launches != {fa.NAME: LM_LAYERS, fa.NAME_DKV: LM_LAYERS,
                    fa.NAME_DQ: LM_LAYERS} or plain_launches:
        raise AssertionError(f"dump launches {launches} (kernels 1-3 once "
                             f"per block, 4-6 never: the head unfused); "
                             f"plain run {plain_launches}")
    return {"dry_s": dry_s, "dump_s": dump_s, "ones": ones}


def _set_bn(torch, engine, seed=None) -> int:
    """Give every BatchNorm of ``engine``'s model per-channel scale, bias,
    running mean and variance from a generator seeded with ``seed``, or
    the initial identity (1, 0, 0, 1) with ``seed=None``; returns the
    number of BNs.  Fresh statistics make kernel 9's ``inv`` 1 and its
    ``shift`` 0 on every channel, which a kernel that drops either would
    reproduce."""
    import numpy as np

    from flexflow_tpu_torch.ops.norm import BatchNorm

    rng = np.random.RandomState(seed) if seed is not None else None
    bns = [op for op in engine.model.layers if isinstance(op, BatchNorm)]
    for op in bns:
        trees = (engine.params[op.param_key], engine.state[op.name])
        for tree, key, lo, hi, ident in (
                (trees[0], "scale", 0.5, 1.5, 1.0),
                (trees[0], "bias", -0.5, 0.5, 0.0),
                (trees[1], "mean", -0.5, 0.5, 0.0),
                (trees[1], "var", 0.5, 2.0, 1.0)):
            v = rng.uniform(lo, hi, op.channels) if rng is not None \
                else np.full(op.channels, ident)
            tree[key] = torch.as_tensor(v.astype(np.float32),
                                        device=tree[key].device)
    return len(bns)


def _serve_opts(serve, model: str, *extra) -> dict:
    return serve.parse_args([model, "--requests",
                             str(SERVE_FORWARD_REQUESTS), "--max-batch",
                             str(SERVE_FORWARD_BATCH), "--device", "cuda",
                             *extra])


def serve_forward_phase(torch, kernels, card: str) -> dict:
    """``apps.serve densenet121`` and ``apps.serve nmt``, the
    forward-only service: kernels 7f and 9 on the serving path, the
    replies against the plain versions', then a subprocess of the
    DenseNet service drained by SIGTERM mid-run."""
    import gc

    import numpy as np

    from flexflow_tpu_torch.apps import serve
    from flexflow_tpu_torch.ops.kernels import bn_act as bn
    from flexflow_tpu_torch.ops.kernels import maxpool as mp
    from flexflow_tpu_torch.ops.norm import BatchNorm
    from flexflow_tpu_torch.ops.pool import Pool2D

    opts = _serve_opts(serve, "densenet121")
    engine, requests, _, forward = serve.build_engine(opts, log=_log)
    model = engine.model
    n_bn = _set_bn(torch, engine, SERVE_BN_SEED)
    batches = -(-SERVE_FORWARD_REQUESTS // SERVE_FORWARD_BATCH)
    per = {bn.NAME_FWD: sum(1 for op in model.layers
                            if isinstance(op, BatchNorm)
                            and bn.supported(*op.inputs[0].shape)),
           mp.NAME_FWD: sum(1 for op in model.layers
                            if isinstance(op, Pool2D)
                            and op.kernel_route() == "maxpool")}
    want = {k: v * batches for k, v in per.items() if v}
    torch.cuda.synchronize()
    kernels.reset_launches()
    t = time.perf_counter()
    summary = engine.run_forward(requests)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    launches = dict(kernels.launches)
    line = json.loads(serve._result_line(summary, engine.olog))
    _log(f"serve forward densenet121: {summary['completed']}/"
         f"{summary['requests']} requests in {summary['steps']} batches of "
         f"{SERVE_FORWARD_BATCH}, {wall:.3f} s wall "
         f"({summary['completed'] / wall:.1f} requests/s on the card); "
         f"launches {launches} (expected {want}: {per} a batch); line "
         f"{json.dumps(line)} — {card}")
    if not forward or launches != want:
        raise AssertionError(f"serving DenseNet launched {launches}, "
                             f"expected {want}")
    if summary["completed"] != SERVE_FORWARD_REQUESTS or not all(
            math.isfinite(line[k]) for k in ("qps", "p50_s", "p99_s")):
        raise AssertionError(f"the DenseNet service's line: {line}")
    replies = np.stack([r.reply for r in requests])
    if replies.shape != (SERVE_FORWARD_REQUESTS, 1000) or not \
            np.isfinite(replies).all():
        raise AssertionError(f"replies {replies.shape} not finite")
    # the first run pays cuDNN's first calls: a second run of fresh
    # requests on the same engine gives the warm rate
    from flexflow_tpu_torch.serve.loadgen import synthetic_requests

    warm_reqs = serve._forward_payloads(model, synthetic_requests(
        SERVE_FORWARD_REQUESTS, seed=1, rate_qps=opts["rate_qps"],
        vocab_size=64, prompt_len=opts["prompt_len"], max_new_tokens=0), 1)
    t = time.perf_counter()
    engine.run_forward(warm_reqs)
    torch.cuda.synchronize()
    warm = time.perf_counter() - t
    _log(f"serve forward densenet121: a second run of {len(warm_reqs)} "
         f"requests {warm:.3f} s wall ({len(warm_reqs) / warm:.1f} "
         f"requests/s, {warm / batches * 1e3:.2f} ms a batch of "
         f"{SERVE_FORWARD_BATCH}) — {card}")
    # the same requests under the identity statistics: the seeded ones
    # must move the replies past the tolerance, or the comparison with
    # the plain kernels below could not fail
    seeded = np.stack([r.reply for r in warm_reqs])
    _set_bn(torch, engine, None)
    ident_reqs = serve._forward_payloads(model, synthetic_requests(
        SERVE_FORWARD_REQUESTS, seed=1, rate_qps=opts["rate_qps"],
        vocab_size=64, prompt_len=opts["prompt_len"], max_new_tokens=0), 1)
    engine.run_forward(ident_reqs)
    ident_gap = float(np.abs(
        seeded - np.stack([r.reply for r in ident_reqs])).max())
    with _plain_cnn_kernels():
        ref_eng, ref_reqs, _, _ = serve.build_engine(opts, log=_log)
        _set_bn(torch, ref_eng, SERVE_BN_SEED)
        kernels.reset_launches()
        ref_eng.run_forward(ref_reqs)
        if sum(kernels.launches.values()):
            raise AssertionError("the plain-kernel service launched a "
                                 "kernel")
    ref = np.stack([r.reply for r in ref_reqs])
    err = float(np.abs(replies - ref).max())
    scale = float(np.abs(ref).max())
    _log(f"serve forward densenet121: {n_bn} BNs at seeded statistics "
         f"(seed {SERVE_BN_SEED}); replies vs plain kernels 7f, 9: "
         f"bit-equal {bool((replies == ref).all())}, max_abs_err "
         f"{err:.3e} of max |reply| {scale:.3e} (tolerance "
         f"{DENSENET_LOSS_RTOL:g} of it); the identity statistics move "
         f"the replies by {ident_gap:.3e}")
    if not err <= DENSENET_LOSS_RTOL * scale:
        raise AssertionError(f"DenseNet replies differ from the plain "
                             f"kernels' by {err}")
    if not ident_gap > DENSENET_LOSS_RTOL * scale:
        raise AssertionError(f"the seeded BN statistics moved the replies "
                             f"by only {ident_gap}: the comparison cannot "
                             f"tell a kernel that ignores them")
    del engine, ref_eng, requests, ref_reqs, model
    gc.collect()
    torch.cuda.empty_cache()

    # the NMT at the JAX driver's defaults: its forward runs no kernel
    # (the fused head is a training path)
    t = time.perf_counter()
    kernels.reset_launches()
    nmt = serve.serve_run(_serve_opts(serve, "nmt"), log=_log)
    torch.cuda.synchronize()
    nmt_line = json.loads(serve._result_line(nmt, nmt.pop("_olog")))
    _log(f"serve forward nmt: {time.perf_counter() - t:.2f} s, launches "
         f"{dict(kernels.launches)}, line {json.dumps(nmt_line)}")
    if nmt_line["completed"] != SERVE_FORWARD_REQUESTS or not all(
            math.isfinite(nmt_line[k]) for k in ("qps", "p50_s", "p99_s")):
        raise AssertionError(f"the NMT service's line: {nmt_line}")
    gc.collect()
    torch.cuda.empty_cache()

    # the drain contract: SIGTERM mid-run, exit 0, nothing dropped
    shutil.rmtree(SERVE_DRAIN_ROOT, ignore_errors=True)
    SERVE_DRAIN_ROOT.mkdir(parents=True)
    prom = SERVE_DRAIN_ROOT / "metrics.prom"
    t = time.perf_counter()
    proc = subprocess.Popen(
        [sys.executable, "-m", "flexflow_tpu_torch.apps.serve",
         "densenet121", "--requests", str(SERVE_DRAIN_REQUESTS),
         "--max-batch", str(SERVE_FORWARD_BATCH), "--device", "cuda",
         "-metrics-path", str(prom)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        cwd=str(Path(__file__).resolve().parent))
    try:
        for err_line in proc.stderr:
            if "forward service running" in err_line:
                proc.send_signal(signal.SIGTERM)
                break
        out, err_text = proc.communicate(timeout=300)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    drain_s = time.perf_counter() - t
    from flexflow_tpu_torch.obs.metrics import read_textfile

    rec = json.loads(out.strip().splitlines()[-1]) if out.strip() else {}
    gauges = read_textfile(str(prom)) if prom.exists() else {}
    _log(f"serve forward drain: exit {proc.returncode} in {drain_s:.1f} s, "
         f"line {json.dumps(rec)}, gauges "
         f"{ {k: gauges.get(k) for k in SERVE_GAUGES} }")
    if proc.returncode != 0 or len(out.strip().splitlines()) != 1:
        raise AssertionError(f"the drained service exited "
                             f"{proc.returncode}: {err_text[-2000:]}")
    if not (rec["unserved"] > 0 and rec["dropped"] == 0 and rec["drained"]
            and rec["completed"] + rec["unserved"] == SERVE_DRAIN_REQUESTS):
        raise AssertionError(f"the drain's line: {rec}")
    if not set(SERVE_GAUGES) <= set(gauges) or \
            gauges["requests_total"] != rec["completed"]:
        raise AssertionError(f"the drained service's gauges: {gauges}")
    shutil.rmtree(SERVE_DRAIN_ROOT, ignore_errors=True)
    return {"line": line, "wall_s": wall, "warm_s": warm,
            "launches": launches, "drain_s": drain_s}


# phase 8b: the disaggregated pools at the serving slice's widths, on
# tests/test_disagg.py's multi-turn load at the GPT's vocab
DISAGG_LOAD = dict(seed=0, rate_qps=50.0, pattern="session", prompt_len=6,
                   max_new_tokens=4)
DISAGG_REQUESTS = 12
#: the serving GPT's layers, d_model, heads, d_ff, vocab and seq
GPT_WIDTHS = (12, 768, 12, 3072, 32768, 512)
DISAGG_BATCH = 8         # every engine's rectangle: the same GEMM shapes
DISAGG_FAULTS = "replica_crash@3,handoff_drop@5,kv_corrupt@7"
# phase 18g: the autoscaling service's gap-then-burst load
# (tests/test_torch_serve_scale.py's, at the GPT's vocab)
SERVE_SCALE_ARGV = ["gpt", "-n", "3", "--rate-qps", "500",
                    "--max-new-tokens", "2", "--burst", "12"]
SERVE_SCALE_WATERMARKS = ["--serve-idle-boundaries", "3",
                          "--serve-queue-hi", "3"]


def _quiet(*args, **kwargs):
    pass


def _timed_predict(torch, engine) -> dict:
    """Wrap ``engine``'s predict step to add up its wall seconds, synced
    on the engine's card: ``{"s": ..., "n": ...}``."""
    inner, dev, acc = engine._predict, engine.model.device, {"s": 0.0,
                                                             "n": 0}

    def predict(*args):
        torch.cuda.synchronize(dev)
        t = time.perf_counter()
        out = inner(*args)
        torch.cuda.synchronize(dev)
        acc["s"] += time.perf_counter() - t
        acc["n"] += 1
        return out

    engine._predict = predict
    return acc


def serve_disagg_phase(torch, fa, kernels, card: str) -> dict:
    """The disaggregated pools through ``serve/router.py`` at the serving
    slice's widths: two prefill replicas and one decode replica at
    max_batch 8 (on cuda:0, or each on a card of its own where four are
    visible), the multi-turn load; the routed replies equal the
    single-pool engine's on the same requests, every request handed off
    once, kernel 1 launched 12 times a forward step summed over the
    replicas; then the same under ``replica_crash``, ``handoff_drop`` and
    ``kv_corrupt``: the same replies, nothing failed, a KV rebuild.
    Where four cards are visible, ``apps.serve --serve-prefill-devices 2
    --serve-prefill-replicas 2 --serve-decode-replicas 2`` too."""
    from flexflow_tpu_torch.apps import serve
    from flexflow_tpu_torch.machine import MachineModel
    from flexflow_tpu_torch.serve import loadgen
    from flexflow_tpu_torch.serve.engine import (DEFAULT_STEP_TIME_S,
                                                 ServeEngine)
    from flexflow_tpu_torch.serve.router import ServeRouter
    from flexflow_tpu_torch.sim.search import decode_step_ratio
    from flexflow_tpu_torch.utils import faultinject

    cards = torch.cuda.device_count()
    devices = [f"cuda:{i}" for i in range(3)] if cards >= 4 \
        else ["cuda:0"] * 3
    models, params = [], []
    for dev in devices:
        model, _ = serve.build_lm(batch=DISAGG_BATCH, seed=0,
                                  machine=MachineModel(dev))
        models.append(model)
        params.append(model.init(0)[0])
    t = models[0].t
    if (t.num_layers, t.d_model, t.num_heads, t.d_ff, t.vocab_size,
            t.seq_length) != GPT_WIDTHS:
        raise AssertionError(f"not the full-width GPT: {t}")
    ratio = decode_step_ratio(models[2])
    _log(f"serve disagg: replicas on {devices}; decode_step_ratio "
         f"{ratio:.6f} (HopperChipPerf), decode step "
         f"{DEFAULT_STEP_TIME_S * ratio * 1e3:.4f} virtual ms")

    def load():
        return loadgen.patterned_requests(
            DISAGG_REQUESTS, vocab_size=t.vocab_size, **DISAGG_LOAD)

    def routed(spec, label):
        prefill = [ServeEngine(models[i], None, params=params[i],
                               log=_quiet, step_time_s=DEFAULT_STEP_TIME_S,
                               phase="prefill") for i in (0, 1)]
        decode = [ServeEngine(models[2], None, params=params[2],
                              log=_quiet,
                              step_time_s=DEFAULT_STEP_TIME_S * ratio,
                              phase="decode")]
        timers = [_timed_predict(torch, e) for e in prefill + decode]
        router = ServeRouter(prefill, decode, log=_quiet)
        reqs = load()
        inj = faultinject.FaultInjector(spec) if spec else None
        restore = faultinject.install_scoped(inj) if inj else (lambda: 0)
        kernels.reset_launches()
        t0 = time.perf_counter()
        try:
            summary = router.run(reqs)
        finally:
            restore()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        n = kernels.launches.get(fa.NAME, 0)
        per = ", ".join(
            f"{kind}[{i}] {tm['s'] / max(tm['n'], 1) * 1e3:.3f} ms a step "
            f"({tm['n']} steps)" for (kind, i), tm in zip(
                [("prefill", 0), ("prefill", 1), ("decode", 0)], timers))
        _log(f"serve disagg {label}: {summary['completed']}/"
             f"{summary['requests']} completed, {summary['handoffs']} "
             f"handoffs, {summary['steps']} forward steps, {n} {fa.NAME} "
             f"launches, {wall:.3f} s wall; wall a step: {per}; {card}")
        _log(f"serve disagg {label} summary " + json.dumps(
            {k: summary[k] for k in (
                "failed", "unserved", "retries", "kv_rebuilds",
                "replica_down", "affinity_hits", "qps", "p50_s", "p99_s",
                "ttft_p50_s", "tpot_p50_s", "virtual_s")}))
        if n != t.num_layers * summary["steps"] or n == 0:
            raise AssertionError(f"serve disagg {label}: {fa.NAME} "
                                 f"launched {n} times, expected "
                                 f"{t.num_layers} x {summary['steps']}")
        return reqs, summary, n

    reqs, summary, launches = routed(None, "routed")
    replies = {r.rid: list(r.reply or ()) for r in reqs}
    single = ServeEngine(models[0], None, params=params[0], log=_quiet,
                         step_time_s=DEFAULT_STEP_TIME_S)
    sreqs = load()
    single.run(sreqs)
    want = {r.rid: list(r.reply or ()) for r in sreqs}
    if replies != want:
        raise AssertionError(f"serve disagg: routed replies differ from the "
                             f"single pool's: {replies} vs {want}")
    if not (summary["handoffs"] == summary["completed"]
            == DISAGG_REQUESTS):
        raise AssertionError(f"serve disagg: handoffs/completed: {summary}")
    _log(f"serve disagg: {len(replies)} routed replies identical to the "
         f"single-pool engine's; first {replies[min(replies)]}")
    freqs, fsum, fn = routed(DISAGG_FAULTS, f"under {DISAGG_FAULTS}")
    got = {r.rid: list(r.reply or ()) for r in freqs}
    if got != want or fsum["failed"] or fsum["kv_rebuilds"] < 1 \
            or fsum["completed"] != DISAGG_REQUESTS:
        raise AssertionError(f"serve disagg under faults: replies "
                             f"{'equal' if got == want else 'differ'}, "
                             f"{fsum}")
    out = {"launches": launches, "fault_launches": fn, "replies": want}
    if cards >= 4:
        opts = serve.parse_args(["gpt", "-n", str(DISAGG_REQUESTS),
                                 "--serve-prefill-devices", "2",
                                 "--serve-prefill-replicas", "2",
                                 "--serve-decode-replicas", "2"])
        kernels.reset_launches()
        app = serve.serve_run(opts, log=_log)
        app.pop("_olog")
        n = kernels.launches.get(fa.NAME, 0)
        _log(f"serve disagg app (2 + 2 cards): {app['completed']}/"
             f"{app['requests']} completed, {app['handoffs']} handoffs, "
             f"{app['steps']} steps, {n} {fa.NAME} launches; {card}")
        if app["completed"] != DISAGG_REQUESTS or app["failed"] \
                or app["handoffs"] != app["completed"] \
                or n != t.num_layers * app["steps"]:
            raise AssertionError(f"serve disagg app: {app}, {n} launches")
    del models, params
    torch.cuda.empty_cache()
    return out


SERVE_SEARCH_ROOT = Path(__file__).resolve().parent / ".chip_serve_search"
#: the serving search's MCMC proposals: enough for a two-card plan, few
#: enough to stay a small share of the run
SERVE_SEARCH_ITERS = 2000
#: the serving tooling's runs on the card (phase 8c, step 4)
SERVE_TOOLING = (["--disagg-smoke"], ["--chaos-smoke"])
LOADTEST_RUNS = (["--smoke"],
                 ["--disagg", "--chaos", "replica_crash@3,handoff_drop@5"])


def _serve_search(torch, kernels, card: str, devices: int, path: Path,
                  *extra, timed: bool = True) -> dict:
    """``apps.search gpt --serve --devices <devices> -b 8 --measured``
    (``extra``: ``--disagg 1``) with the shared cache into ``path``, held
    as :func:`_measured_search` holds a search (with ``timed``, kernels
    1-3 launched while timing: a search served from the cache times
    nothing); the artifact's serve block present and its plan passing
    ``verify/plan.check_plan`` on a shadow GPT."""
    from flexflow_tpu_torch.apps import serve
    from flexflow_tpu_torch.apps.cnn import check_strategy
    from flexflow_tpu_torch.machine import MachineModel
    from flexflow_tpu_torch.ops.kernels import flash_attention as fa
    from flexflow_tpu_torch.strategy import Strategy

    argv = ["gpt", "--serve", "--devices", str(devices), "-b", "8", "-i",
            str(SERVE_SEARCH_ITERS), "--cache",
            str(SERVE_SEARCH_ROOT / "cache.json"), "-o", str(path),
            *extra]
    out = _measured_search(torch, kernels, card, argv,
                           (fa.NAME, fa.NAME_DKV, fa.NAME_DQ) if timed
                           else ())
    out["timing_launches"] = {k: kernels.launches.get(k, 0) for k in (
        fa.NAME, fa.NAME_DKV, fa.NAME_DQ)}
    loaded = Strategy.load(str(path))
    blk = (loaded.predicted or {}).get("serve") or {}
    need = {"max_batch", "kv_cache_bytes_per_device", "forward_step_s"}
    if extra:
        need |= {"phase", "prefill", "decode"}
    if not need <= set(blk) or blk["max_batch"] != 8 \
            or blk["forward_step_s"] != out["best_time_s"]:
        raise AssertionError(f"serve search {path.name}: serve block {blk}")
    check_strategy(lambda m: serve.build_lm(batch=8, machine=m)[0], loaded,
                   MachineModel.virtual(devices), False, path.name)
    if extra:
        dplan = serve._decode_pool_strategy(loaded, 8)
        check_strategy(lambda m: serve.build_lm(batch=8, machine=m)[0],
                       dplan, MachineModel.virtual(blk["decode"]["devices"]),
                       False, f"{path.name}[decode]")
    _log(f"serve search {path.name}: forward_step_s "
         f"{blk['forward_step_s']:.6e}, kv_cache_bytes_per_device "
         f"{blk['kv_cache_bytes_per_device']}"
         + (f", prefill step_time_s {blk['prefill']['step_time_s']:.6e}, "
            f"decode step_time_s {blk['decode']['step_time_s']:.6e} on "
            f"{blk['decode']['devices']} card(s)" if extra else "")
         + "; the plan check passes")
    return out


def serve_search_phase(torch, fa, kernels, card: str, sliced: dict,
                       disagg: dict) -> dict:
    """Phase 8c, the serving search: ``apps.search gpt --serve --devices 1
    -b 8 --measured`` and ``--serve --disagg 1`` (kernels 1-3 launched
    while timing; the serve blocks present, the plans checked); then
    ``apps.serve gpt -s`` of the first serving phase 8's 16 requests at
    the artifact's ``forward_step_s`` (every request completes, phase
    8's replies, kernel 1 12 times a step); then phase 8b's routed pools
    built from the ``--disagg`` artifact (the prefill plan, the decode
    pool's plan and step from ``serve.decode``): 8b's single-pool
    replies, kernel 1 12 times a forward step summed over the replicas;
    each engine's simulated step beside its wall ms a step on the card;
    then ``apps.serve --disagg-smoke`` and ``--chaos-smoke``, ``apps.
    loadtest --smoke`` and ``apps.loadtest --disagg --chaos
    replica_crash@3,handoff_drop@5`` on cuda:0, each passing its own
    checks and printing its one line."""
    import contextlib
    import io

    from flexflow_tpu_torch.apps import loadtest, serve
    from flexflow_tpu_torch.machine import MachineModel
    from flexflow_tpu_torch.serve import loadgen
    from flexflow_tpu_torch.serve.engine import ServeEngine
    from flexflow_tpu_torch.serve.router import ServeRouter
    from flexflow_tpu_torch.strategy import Strategy

    shutil.rmtree(SERVE_SEARCH_ROOT, ignore_errors=True)
    SERVE_SEARCH_ROOT.mkdir(parents=True)
    one, dis = SERVE_SEARCH_ROOT / "serve1.json", \
        SERVE_SEARCH_ROOT / "serve_d.json"
    s1 = _serve_search(torch, kernels, card, 1, one)
    # the same shards again: served from the cache
    sd = _serve_search(torch, kernels, card, 1, dis, "--disagg", "1",
                       timed=False)
    blk, dblk = s1["serve"], sd["serve"]
    # the single pool from the artifact, phase 8's load
    opts = serve.parse_args(["gpt", "--requests", "16", "--max-new-tokens",
                             "4", "--device", "cuda", "-s", str(one)])
    engine, requests, _, _ = serve.build_engine(opts, log=_quiet)
    if engine.step_time_s != blk["forward_step_s"]:
        raise AssertionError(f"serve search: the engine steps "
                             f"{engine.step_time_s}, the artifact says "
                             f"{blk['forward_step_s']}")
    timer = _timed_predict(torch, engine)
    kernels.reset_launches()
    summary = engine.run(requests)
    torch.cuda.synchronize()
    n = kernels.launches.get(fa.NAME, 0)
    replies = [list(r.reply) for r in requests]
    want = [list(r.reply) for r in sliced["requests"]]
    _log(f"serve search -s {one.name}: {summary['completed']}/"
         f"{summary['requests']} completed in {summary['steps']} steps, "
         f"{n} {fa.NAME} launches; simulated forward_step_s "
         f"{blk['forward_step_s'] * 1e3:.4f} ms beside the card's "
         f"{timer['s'] / max(timer['n'], 1) * 1e3:.3f} ms a step; {card}")
    if summary["completed"] != len(requests) or summary["unserved"]:
        raise AssertionError(f"serve search: not every request completed: "
                             f"{summary}")
    if replies != want:
        raise AssertionError(f"serve search: replies differ from phase "
                             f"8's: {replies} vs {want}")
    if n != GPT_WIDTHS[0] * summary["steps"] or n == 0:
        raise AssertionError(f"serve search: {fa.NAME} launched {n} times, "
                             f"expected {GPT_WIDTHS[0]} x {summary['steps']}")
    served = n
    del engine
    torch.cuda.empty_cache()
    # the routed pools of phase 8b, from the --disagg artifact
    plan = Strategy.load(str(dis))
    dplan = serve._decode_pool_strategy(plan, DISAGG_BATCH)
    models = [serve.build_lm(batch=DISAGG_BATCH, seed=0, strategies=st,
                             machine=MachineModel("cuda:0"))[0]
              for st in (plan, plan, dplan)]
    params = models[0].init(0)[0]
    prefill = [ServeEngine(m, None, params=params, log=_quiet,
                           phase="prefill") for m in models[:2]]
    decode = [ServeEngine(models[2], None, params=params, log=_quiet,
                          phase="decode")]
    if (prefill[0].step_time_s, decode[0].step_time_s) != (
            dblk["prefill"]["step_time_s"], dblk["decode"]["step_time_s"]):
        raise AssertionError(f"serve search: pool steps "
                             f"{prefill[0].step_time_s}, "
                             f"{decode[0].step_time_s} against {dblk}")
    timers = [_timed_predict(torch, e) for e in prefill + decode]
    reqs = loadgen.patterned_requests(DISAGG_REQUESTS,
                                      vocab_size=GPT_WIDTHS[4],
                                      **DISAGG_LOAD)
    kernels.reset_launches()
    rsum = ServeRouter(prefill, decode, log=_quiet).run(reqs)
    torch.cuda.synchronize()
    rn = kernels.launches.get(fa.NAME, 0)
    got = {r.rid: list(r.reply or ()) for r in reqs}
    walls = ", ".join(
        f"{e.phase}[{i}] simulated {e.step_time_s * 1e3:.4f} ms, card "
        f"{tm['s'] / max(tm['n'], 1) * 1e3:.3f} ms a step ({tm['n']} steps)"
        for (i, e), tm in zip([(0, prefill[0]), (1, prefill[1]),
                               (0, decode[0])], timers))
    _log(f"serve search routed from {dis.name}: {rsum['completed']}/"
         f"{rsum['requests']} completed, {rsum['handoffs']} handoffs, "
         f"{rsum['steps']} forward steps, {rn} {fa.NAME} launches; {walls}; "
         f"{card}")
    if got != disagg["replies"]:
        raise AssertionError(f"serve search routed: replies differ from "
                             f"8b's single pool's: {got} vs "
                             f"{disagg['replies']}")
    if rn != GPT_WIDTHS[0] * rsum["steps"] or rn == 0:
        raise AssertionError(f"serve search routed: {fa.NAME} launched {rn} "
                             f"times, expected {GPT_WIDTHS[0]} x "
                             f"{rsum['steps']}")
    del models, prefill, decode, params
    torch.cuda.empty_cache()
    # the serving tooling on the card
    for app, runs in ((serve, SERVE_TOOLING), (loadtest, LOADTEST_RUNS)):
        for argv in runs:
            t = time.perf_counter()
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                rc = app.main(list(argv) + ["--device", "cuda:0"],
                              log=_quiet)
            line = json.loads(buf.getvalue().strip().splitlines()[-1])
            _log(f"serve search tooling {app.__name__.split('.')[-1]} "
                 f"{' '.join(argv)}: rc {rc}, {time.perf_counter() - t:.1f}"
                 f" s; {json.dumps(line)}")
            if rc != 0:
                raise AssertionError(f"{app.__name__} {argv}: rc {rc}")
    return {"launches": served, "routed_launches": rn,
            "timing_launches": s1["timing_launches"],
            "measurement": s1["measurement"]}


def _serve_search_ranks(ranks: int, extra) -> tuple:
    """The serving search of phase 8d, before its world starts: the
    measured ``apps.search gpt --serve --devices <ranks>`` (the shared
    cache) in this process; returns (the search's result, the runs
    the world makes: ``apps.serve gpt -s`` of the artifact on phase
    18g's load, then ``apps.serve --smoke``), each with ``extra``'s
    device and backend flags."""
    import torch

    from flexflow_tpu_torch.ops import kernels

    SERVE_SEARCH_ROOT.mkdir(parents=True, exist_ok=True)
    path = SERVE_SEARCH_ROOT / f"serve_{ranks}.json"
    out = _serve_search(torch, kernels, _card_line(), ranks, path)
    flags = []
    for flag in ("--device", "--dist-backend"):
        if flag in extra:
            flags += [flag, _flag(list(extra), flag)]
    return out, [["gpt", "-n", "16", "--max-new-tokens", "4", "-s",
                  str(path)] + flags, ["--smoke"] + flags]


def serve_search_ranks_phase(torch, fa, kernels, card: str, ranks: int,
                             runs: dict) -> dict:
    """Phase 8d: in the ``--lm-ranks`` world of ``ranks``, ``apps.serve
    gpt -s`` of the artifact searched for ``ranks`` cards (every
    request completes, every rank's replies the one-rank engine's: on a
    mismatch the request, the position and the top-2 gap; kernel 1 on
    rank 0, plain and partial forms together, 12 times a step), then
    ``apps.serve --smoke``: one shrink to ``3 * ranks // 4`` and one grow
    back, 46 completed, none unserved or dropped."""
    from flexflow_tpu_torch.apps import serve

    label = f"serve search {ranks} ranks"
    served, smoked = runs["serve"], runs["smoke"]
    s = served[0]["summary"]
    launches = {k: v for k, v in served[0]["launches"].items()
                if k.startswith(fa.NAME)}
    _log(f"{label}: -s {Path(runs['path']).name}: {s['completed']} "
         f"completed in {s['steps']} steps, {s['wall_s']:.3f} s wall on "
         f"rank 0, simulated forward_step_s "
         f"{runs['forward_step_s'] * 1e3:.4f} ms beside the card's "
         f"{s['wall_s'] / max(s['steps'], 1) * 1e3:.3f} ms a step; rank "
         f"0's kernel 1 launches {launches}; {card}")
    for r, res in enumerate(served):
        if (res["summary"]["completed"], res["summary"]["unserved"]) \
                != (16, 0):
            raise AssertionError(f"{label}: rank {r} {res['summary']}")
    if sum(launches.values()) != GPT_WIDTHS[0] * s["steps"] or not s["steps"]:
        raise AssertionError(f"{label}: rank 0 launched {fa.NAME} "
                             f"{launches}, expected {GPT_WIDTHS[0]} x "
                             f"{s['steps']}")
    engine, requests, _, _ = serve.build_engine(
        serve.parse_args(["gpt", "-n", "16", "--max-new-tokens", "4",
                          "--device", "cuda"]), log=_quiet)
    engine.run(requests)
    want = {str(r.rid): [int(x) for x in r.reply] for r in requests}
    for r, res in enumerate(served):
        for rid, reply in sorted(res["replies"].items()):
            if reply == want[rid]:
                continue
            k = next(i for i, (a, b) in enumerate(zip(reply, want[rid]))
                     if a != b)
            prompt = next(q.tokens for q in requests if str(q.rid) == rid)
            gap = _top2_gap(torch, engine, prompt, want[rid][:k])
            raise AssertionError(
                f"{label}: rank {r} request {rid} differs at new token "
                f"{k}: {reply} vs the one-rank engine's {want[rid]}; the "
                f"one-rank top-2 log-prob gap there {gap:.3e}")
        if set(res["replies"]) != set(want):
            raise AssertionError(f"{label}: rank {r} served "
                                 f"{sorted(res['replies'])}")
    del engine
    torch.cuda.empty_cache()
    target = 3 * ranks // 4
    for r, res in enumerate(smoked):
        dirs = [(z["direction"], z["from_devices"], z["to_devices"])
                for z in res["resizes"]]
        sm = res["summary"]
        if dirs != [("shrink", ranks, target), ("grow", target, ranks)] \
                or (sm["completed"], sm["unserved"], sm["dropped"]) \
                != (46, 0, 0):
            raise AssertionError(f"{label} --smoke: rank {r} resizes "
                                 f"{dirs}, summary {sm}")
    _log(f"{label}: every rank's 16 replies identical to the one-rank "
         f"engine's; --smoke {ranks} -> {target} -> {ranks}, 46 completed, "
         f"0 unserved, 0 dropped")
    return {"launches": sum(launches.values()), "by_name": launches}


def _serve_scale_argv(ranks: int, extra) -> list:
    """Phase 18g's run in a ``--lm-ranks`` world of ``ranks``: the
    gap-then-burst load, shrinking to half the world; ``extra``'s device
    and backend flags (not its strategy)."""
    argv = SERVE_SCALE_ARGV + SERVE_SCALE_WATERMARKS + [
        "--shrink-to", str(ranks // 2)]
    for flag in ("--device", "--dist-backend"):
        if flag in extra:
            argv += [flag, _flag(list(extra), flag)]
    return argv


def _top2_gap(torch, engine, prompt, head) -> float:
    """The top-2 log-prob gap of the one-rank model at the position after
    ``prompt + head`` (slot 0 of the batch rectangle, the rest pad)."""
    import numpy as np

    toks = np.zeros((engine.max_batch, engine.max_len), np.int32)
    row = list(prompt) + list(head)
    toks[0, :len(row)] = row
    lp = engine.model.make_predict_step()(
        engine.params, {}, toks, np.zeros_like(toks))[0]
    top = torch.topk(lp[0, len(row) - 1].float(), 2).values
    return float(top[0] - top[1])


def serve_scale_phase(torch, fa, kernels, card: str, ranks: int,
                      results: list) -> dict:
    """Phase 18g: ``apps.serve gpt`` at full width in the ``--lm-ranks``
    world of ``ranks`` (the lm strategy phase's, or its four-card form)
    under the gap-then-burst load with ``--serve-idle-boundaries 3
    --serve-queue-hi 3 --shrink-to ranks/2``: one shrink and one grow,
    15 completed, none unserved or dropped, back at the world's size,
    every rank's replies those of the one-rank engine in this process
    (on a mismatch: the request, the position and the one-rank model's
    top-2 log-prob gap there), kernel 1 launched on rank 0 once a layer
    in every step (plain and partial forms together); each
    resize's research_s and total_s logged."""
    from flexflow_tpu_torch.apps import serve

    label = f"serve scale {ranks} ranks"
    for r, res in enumerate(results):
        dirs = [(z["direction"], z["from_devices"], z["to_devices"])
                for z in res["resizes"]]
        s = res["summary"]
        if dirs != [("shrink", ranks, ranks // 2),
                    ("grow", ranks // 2, ranks)] or res["out_of_service"]:
            raise AssertionError(f"{label}: rank {r} resizes {dirs}")
        if (s["completed"], s["unserved"], s["dropped"], s["devices"]) \
                != (15, 0, 0, ranks):
            raise AssertionError(f"{label}: rank {r} summary {s}")
    for z in results[0]["resizes"]:
        _log(f"{label}: {z['direction']} {z['from_devices']} -> "
             f"{z['to_devices']} at step {z['step']} (virtual "
             f"{z['vnow']:.4f} s, queue depth {z['queue_depth']}, idle "
             f"streak {z['idle_streak']}): research_s "
             f"{z['research_s']:.3f}, total_s {z['total_s']:.3f} "
             f"[{(z['research'] or {}).get('mode')}, "
             f"{(z['research'] or {}).get('iters')} proposals]; {card}")
    launches = {k: v for k, v in results[0]["launches"].items()
                if k.startswith(fa.NAME)}
    s = results[0]["summary"]
    _log(f"{label}: {s['completed']} completed in {s['steps']} steps, "
         f"{s['wall_s']:.3f} s wall on rank 0; rank 0's kernel 1 launches "
         f"{launches}")
    # every step's forward runs kernel 1 once a layer on rank 0, in its
    # plain form or (a sequence split) its partial form
    if sum(launches.values()) != GPT_WIDTHS[0] * s["steps"]:
        raise AssertionError(f"{label}: rank 0 launched {fa.NAME} "
                             f"{launches}, expected {GPT_WIDTHS[0]} x "
                             f"{s['steps']} in all")
    # the one-rank engine in this process on the same load and weights
    engine, requests, _, _ = serve.build_engine(
        serve.parse_args(SERVE_SCALE_ARGV + ["--device", "cuda"]),
        log=_quiet)
    engine.run(requests)
    want = {str(r.rid): [int(x) for x in r.reply] for r in requests}
    for r, res in enumerate(results):
        for rid, reply in sorted(res["replies"].items()):
            if reply == want[rid]:
                continue
            k = next(i for i, (a, b) in enumerate(zip(reply, want[rid]))
                     if a != b)
            prompt = next(q.tokens for q in requests if str(q.rid) == rid)
            gap = _top2_gap(torch, engine, prompt, want[rid][:k])
            raise AssertionError(
                f"{label}: rank {r} request {rid} differs at new token "
                f"{k}: {reply} vs the one-rank engine's {want[rid]}; the "
                f"one-rank top-2 log-prob gap there {gap:.3e}")
        if set(res["replies"]) != set(want):
            raise AssertionError(f"{label}: rank {r} served "
                                 f"{sorted(res['replies'])}")
    _log(f"{label}: every rank's 15 replies identical to the one-rank "
         f"engine's")
    del engine
    torch.cuda.empty_cache()
    return {"launches": sum(launches.values()), "by_name": launches,
            "resizes": results[0]["resizes"]}


# phase 12c: the forward-only service and the routed pools over the
# ranks of one torchrun world
SERVE_RANKS = 4
SERVE_RANKS_ROOT = Path(__file__).resolve().parent / ".chip_serve_ranks"
#: the routed forms: (prefill ranks, prefill replicas, decode replicas)
SERVE_RANKS_FORMS = ((2, 1, 1), (2, 2, 1))


def _serve_ranks_runs(flags, strategy: Path) -> list:
    """The ``apps.serve`` runs of phase 12c's world: DenseNet-121's
    forward service data parallel and under ``strategy``, the NMT's,
    then the routed pools at the GPT's widths on 8b's load in the first
    form, again under 8b's faults, then in the second form."""
    fwd = ["--requests", str(SERVE_FORWARD_REQUESTS), "--max-batch",
           str(SERVE_FORWARD_BATCH)]
    gpt = ["gpt", "-n", str(DISAGG_REQUESTS), "-b", str(DISAGG_BATCH),
           "--seed", str(DISAGG_LOAD["seed"]), "--rate-qps",
           str(DISAGG_LOAD["rate_qps"]), "--pattern",
           DISAGG_LOAD["pattern"], "--prompt-len",
           str(DISAGG_LOAD["prompt_len"]), "--max-new-tokens",
           str(DISAGG_LOAD["max_new_tokens"])]
    forms = [gpt + ["--serve-prefill-devices", str(p),
                    "--serve-prefill-replicas", str(pr),
                    "--serve-decode-replicas", str(dr)]
             for p, pr, dr in SERVE_RANKS_FORMS]
    runs = [["densenet121"] + fwd, ["densenet121"] + fwd
            + ["-s", str(strategy)], ["nmt"] + fwd, forms[0],
            forms[0] + ["-fault-spec", DISAGG_FAULTS], forms[1]]
    return [r + list(flags) for r in runs]


def _forward_refs(torch, serve, bn, mp, block: int) -> dict:
    """Phase 12b's one-card services on this card (DenseNet-121 with the
    plain versions of kernels 7-10, and the NMT; the same seed and
    requests, BN statistics as initialized): the replies in rid order,
    and DenseNet's kernel-routed BNs and max pools on a rank's block of
    ``block`` rows (the JAX gate takes the block's row count)."""
    import gc

    import numpy as np

    from flexflow_tpu_torch.ops.norm import BatchNorm
    from flexflow_tpu_torch.ops.pool import Pool2D

    out = {}
    for name in ("densenet121", "nmt"):
        # DenseNet's with kernels 7-10 swapped for their plain versions,
        # so that the replies over ranks hold 7f and 9 against them
        with _plain_cnn_kernels() if name == "densenet121" \
                else contextlib.nullcontext():
            engine, requests, _, _ = serve.build_engine(
                _serve_opts(serve, name), log=_quiet)
            engine.run_forward(requests)
        out[name] = np.stack([r.reply for r in sorted(requests,
                                                      key=lambda r: r.rid)])
        if name == "densenet121":
            layers = engine.model.layers
            out["per_batch"] = {
                bn.NAME_FWD: sum(1 for op in layers
                                 if isinstance(op, BatchNorm)
                                 and bn.supported(block,
                                                  *op.inputs[0].shape[1:])),
                mp.NAME_FWD: sum(1 for op in layers
                                 if isinstance(op, Pool2D)
                                 and op.kernel_route() == "maxpool")}
            out["bns"] = sum(1 for op in layers if isinstance(op, BatchNorm))
        del engine, requests
        gc.collect()
        torch.cuda.empty_cache()
    return out


def _single_pool(torch, serve):
    """8b's single pool on this card: the one-card engine at max batch
    8 on 8b's load, seed-0 weights; ``(replies by rid, requests,
    engine)``."""
    from flexflow_tpu_torch.machine import MachineModel
    from flexflow_tpu_torch.serve import loadgen
    from flexflow_tpu_torch.serve.engine import (DEFAULT_STEP_TIME_S,
                                                 ServeEngine)

    model, _ = serve.build_lm(batch=DISAGG_BATCH, seed=0,
                              machine=MachineModel("cuda:0"))
    engine = ServeEngine(model, None, log=_quiet,
                         step_time_s=DEFAULT_STEP_TIME_S)
    reqs = loadgen.patterned_requests(
        DISAGG_REQUESTS, vocab_size=GPT_WIDTHS[4], **DISAGG_LOAD)
    engine.run(reqs)
    return {r.rid: list(r.reply or ()) for r in reqs}, reqs, engine


def serve_ranks_phase(torch, fa, kernels, card: str, disagg) -> dict:
    """Phase 12c: one torchrun world of four ranks (gloo on cuda:0 on one
    card, an NCCL rank per card on four) rides ``apps.serve`` through
    the ``--lm-ranks`` worker: DenseNet-121's forward service data
    parallel and with its classifier's channels split over the ranks
    (32 requests in 4 batches of 8, the replies within 1e-3 of their
    largest magnitude of phase 12b's one-card service with the plain
    versions of kernels 7-10, kernel 9 on each
    rank once a batch for every BN whose block of the rank's rows passes
    the JAX gate and 7f once a batch), the NMT's (the one-card replies
    within 1e-3), then the routed pools at the GPT's widths on 8b's load,
    a prefill replica of 2 ranks and a decode replica of 2, without and
    with 8b's faults, and two prefill replicas of 1 rank with a decode
    replica of 2: the single pool's replies token for token on every
    rank (on a mismatch the request, the position and the one-card top-2
    gap), kernel 1 on each rank 12 times its replica's forward steps,
    each replica's wall ms a step beside its virtual step."""
    import numpy as np

    from flexflow_tpu_torch.apps import serve
    from flexflow_tpu_torch.ops.kernels import bn_act as bn
    from flexflow_tpu_torch.ops.kernels import maxpool as mp

    label = f"serve ranks ({SERVE_RANKS} ranks)"
    four = torch.cuda.device_count() >= SERVE_RANKS
    flags = ["--device", "cuda"] if four else \
        ["--device", "cuda:0", "--dist-backend", "gloo"]
    where = f"{SERVE_RANKS} NCCL cards" if four \
        else f"{SERVE_RANKS} gloo ranks on cuda:0"
    block = SERVE_FORWARD_BATCH // SERVE_RANKS
    batches = -(-SERVE_FORWARD_REQUESTS // SERVE_FORWARD_BATCH)
    t = time.perf_counter()
    refs = _forward_refs(torch, serve, bn, mp, block)
    want, sreqs, single = _single_pool(torch, serve)
    if disagg is not None and {int(k): v for k, v in
                               disagg["replies"].items()} != want:
        raise AssertionError(f"{label}: the single pool's replies differ "
                             f"from 8b's")
    del single
    torch.cuda.empty_cache()
    _log(f"{label}: one-card references {time.perf_counter() - t:.1f} s; "
         f"DenseNet kernel-routed a batch on a rank's {block} rows "
         f"{refs['per_batch']} of {refs['bns']} BNs (the JAX gate: "
         f"rows with a power-of-two divisor of at least 8)")
    shutil.rmtree(SERVE_RANKS_ROOT, ignore_errors=True)
    SERVE_RANKS_ROOT.mkdir(parents=True)
    strategy = SERVE_RANKS_ROOT / "densenet_head.json"
    strategy.write_text(json.dumps({"linear1": {
        "dims": [SERVE_RANKS, 1], "devices": list(range(SERVE_RANKS))}}))
    runs = _serve_ranks_runs(flags, strategy)
    results, _, seconds = _lm_ranks(SERVE_RANKS, SERVE_RANKS_ROOT,
                                    "serve_ranks", runs,
                                    apps={i: "serve"
                                          for i in range(len(runs))})
    _log(f"{label}: {seconds:.1f} s for the torchrun world on {where}, "
         f"its start included; {card}")
    out = {}
    # the forward service: DenseNet data parallel, then its classifier
    # split over c, then the NMT
    per = {k: v * batches for k, v in refs["per_batch"].items() if v}
    for i, (tag, ref) in enumerate((("densenet121", refs["densenet121"]),
                                    ("densenet121 -s", refs["densenet121"]),
                                    ("nmt", refs["nmt"]))):
        res = results[i]
        for r, rr in enumerate(res):
            s = rr["summary"]
            if (s["completed"], s["steps"], s["unserved"]) != \
                    (SERVE_FORWARD_REQUESTS, batches, 0):
                raise AssertionError(f"{label} {tag}: rank {r} {s}")
            got = {k: v for k, v in rr["launches"].items() if v}
            # the NMT's forward runs no kernel (its fused head trains)
            if got != (per if tag != "nmt" else {}):
                raise AssertionError(f"{label} {tag}: rank {r} launched "
                                     f"{got}, expected {per}")
        replies = np.load(SERVE_RANKS_ROOT
                          / f"serve_ranks_{i}.json.replies.npy")
        scale = float(np.abs(ref).max())
        err = float(np.abs(replies - ref).max()) \
            if replies.shape == ref.shape else float("inf")
        s = res[0]["summary"]
        _log(f"{label} {tag}: {s['completed']} requests in {s['steps']} "
             f"batches on every rank, rank 0 {s['wall_s']:.3f} s wall "
             f"({s['wall_s'] / s['steps'] * 1e3:.2f} ms a batch of "
             f"{SERVE_FORWARD_BATCH}), launches on rank 0 "
             f"{ {k: v for k, v in res[0]['launches'].items() if v} }; "
             f"replies {replies.shape} vs the one-card service's: max_abs "
             f"{err:.3e} of max |reply| {scale:.3e} (tolerance "
             f"{DENSENET_LOSS_RTOL:g} of it); {card}")
        if not np.isfinite(replies).all() or \
                not err <= DENSENET_LOSS_RTOL * scale:
            raise AssertionError(f"{label} {tag}: replies differ from the "
                                 f"one-card service's by {err}")
        out[tag] = {"launches": dict(res[0]["launches"]), "err": err,
                    "scale": scale}
    # the routed pools
    for i, tag in ((3, "2+2"), (4, f"2+2 under {DISAGG_FAULTS}"),
                   (5, "1+1+2")):
        res = results[i]
        for r, rr in enumerate(res):
            s = rr["summary"]
            if s["completed"] != DISAGG_REQUESTS or s["failed"] \
                    or s["unserved"] or (i == 4 and s["kv_rebuilds"] < 1):
                raise AssertionError(f"{label} {tag}: rank {r} {s}")
            got = {int(k): v for k, v in rr["replies"].items()}
            for rid, reply in sorted(want.items()):
                if got.get(rid) == reply:
                    continue
                k = next((j for j, (a, b) in enumerate(
                    zip(got.get(rid) or [], reply)) if a != b),
                    len(got.get(rid) or []))
                prompt = next(q.tokens for q in sreqs if q.rid == rid)
                _, _, engine = _single_pool(torch, serve)
                gap = _top2_gap(torch, engine, prompt, reply[:k])
                raise AssertionError(
                    f"{label} {tag}: rank {r} request {rid} differs at "
                    f"new token {k}: {got.get(rid)} vs the single pool's "
                    f"{reply}; the one-card top-2 log-prob gap there "
                    f"{gap:.3e}")
            mine = next(x for x in rr["replicas"] if x["runs"])
            n = sum(v for k, v in rr["launches"].items()
                    if k.startswith(fa.NAME))
            if n != GPT_WIDTHS[0] * mine["steps"] or not n:
                raise AssertionError(
                    f"{label} {tag}: rank {r} launched {fa.NAME} {n} "
                    f"times, expected {GPT_WIDTHS[0]} x {mine['steps']} "
                    f"({mine['phase']}[{mine['index']}])")
        s = res[0]["summary"]
        steps = ", ".join(
            f"{x['phase']}[{x['index']}] on ranks {x['ranks']}: "
            f"{x['busy_s'] / max(x['steps'], 1) * 1e3:.2f} ms a step wall "
            f"against {x['step_time_s'] * 1e3:.4f} ms virtual "
            f"({x['steps']} steps)" for x in res[0]["replicas"])
        n0 = sum(v for k, v in res[0]["launches"].items()
                 if k.startswith(fa.NAME))
        _log(f"{label} {tag}: {s['completed']}/{s['requests']} completed, "
             f"{s['handoffs']} handoffs, {s['kv_rebuilds']} KV rebuilds, "
             f"{s['steps']} forward steps, the single pool's replies on "
             f"every rank; kernel 1 on each rank 12 x its replica's steps "
             f"(rank 0: {n0}); {steps}; {card}")
        out[tag] = {"launches": n0, "replicas": res[0]["replicas"]}
    shutil.rmtree(SERVE_RANKS_ROOT, ignore_errors=True)
    return out


#: ``--only`` names -> phases, and the phases whose results each reads
ONLY_PHASES = {"lm": "lm", "resnet101": "resnet101", "nmt": "nmt",
               "lm-obs": "lm obs", "pipeline": "pipeline", "moe": "moe",
               "runtime": "runtime", "moe-strategy": "moe strategy",
               "search": "search", "search4": "search 4",
               "strategy": "strategy", "lm-strategy": "lm strategy",
               "strategy4": "strategy 4", "lm-strategy4": "lm strategy 4",
               "pipeline4": "pipeline 4", "debug": "debug",
               "serve-forward": "serve forward",
               "serve-ranks": "serve ranks",
               "serve-disagg": "serve disagg", "serve-scale": "serve scale",
               "serve-scale4": "serve scale 4",
               "serve-search": "serve search",
               "serve-search-ranks": "serve search ranks",
               "serve-search-ranks4": "serve search ranks 4"}
PHASE_NEEDS = {"lm obs": ("lm",), "pipeline": ("strategy",),
               "search": ("strategy",), "search 4": ("strategy",),
               "lm strategy": ("lm", "strategy"),
               "moe strategy": ("moe", "strategy", "lm", "lm strategy"),
               "lm strategy 4": ("lm", "strategy", "lm strategy"),
               "pipeline 4": ("strategy", "pipeline", "lm", "lm strategy",
                              "lm strategy 4"),
               "serve scale": ("lm", "strategy", "lm strategy"),
               "serve search": ("serving", "serve disagg"),
               "serve search ranks": ("lm", "strategy", "lm strategy"),
               "serve search ranks 4": ("lm", "strategy", "lm strategy",
                                        "lm strategy 4"),
               "serve scale 4": ("lm", "strategy", "lm strategy",
                                 "lm strategy 4")}
#: the exit status of an ``--only`` run whose phases passed: never 0, so
#: that a partial run is not read as the smoke's pass
PARTIAL_EXIT = 4


def main(argv) -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available — this smoke runs on an "
              "NVIDIA GPU", file=sys.stderr)
        return 2
    if "--gloo-cuda-probe" in argv:
        return _gloo_cuda_probe([c for c in GLOO_CUDA_COLLECTIVES
                                 if c != "send_recv"])
    if "--gloo-p2p-probe" in argv:
        return _gloo_cuda_probe(["send_recv"])
    if "--lm-ranks" in argv:
        return _ranks_worker(argv[argv.index("--lm-ranks") + 1])

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

    # --only: the named phases and the phases whose results they read
    only = {ONLY_PHASES[k] for k in (_flag(argv, "--only") or "").split(",")
            if k}
    only |= {n for name in only for n in PHASE_NEEDS.get(name, ())}

    def phase(name, fn, *args):
        if only and name not in only:
            return None
        t = time.perf_counter()
        out = fn(*args)
        _log(f"phase {name}: {time.perf_counter() - t:.1f} s")
        return out

    checked = phase("flash forward", kernel_phase, torch, fa)
    flash_bwd = phase("flash backward", flash_bwd_phase, torch, fa)
    fused = phase("fused ce", fused_ce_phase, torch, ce)
    partials = phase("partial forms", partial_phase, torch, fa, ce)
    pools = phase("pools", pool_kernel_phase, torch, kernels)
    bns = phase("bn", bn_kernel_phase, torch)
    sliced = phase("serving", slice_phase, torch, fa, kernels)
    disagg = phase("serve disagg", serve_disagg_phase, torch, fa, kernels,
                   card)
    served = phase("serve search", serve_search_phase, torch, fa, kernels,
                   card, sliced, disagg)
    lm_run = phase("lm", lm_phase, torch, kernels, card)
    phase("lm obs", lm_obs_phase, torch, kernels, card, lm_run)
    phase("lm 1.3b", lm_phase, torch, kernels, card, LM13_WIDTHS,
          (LM13_WARMUP, LM13_TIMED, LM13_CHECKED), "lm 1.3b")
    phase("debug", debug_phase, torch, kernels, card)
    trained = phase("inception", training_phase, torch, kernels, card)
    dense = phase("densenet", densenet_phase, torch, kernels, card)
    phase("serve forward", serve_forward_phase, torch, kernels, card)
    ranked = phase("serve ranks", serve_ranks_phase, torch, fa, kernels,
                   card, disagg)
    phase("resnet101", resnet_vgg_phase, torch, kernels, card, "resnet101")
    phase("vgg16", resnet_vgg_phase, torch, kernels, card, "vgg16")
    nmt_run = phase("nmt", nmt_phase, torch, kernels, card)
    moe_run = phase("moe", moe_phase, torch, kernels, card)
    phase("runtime", runtime_phase, torch, kernels, card)
    strategy_run = phase("strategy", strategy_phase, torch, kernels, card)
    phase("placement", placement_phase, torch, kernels, card, nmt_run,
          strategy_run)
    lm_strategy = phase("lm strategy", lm_strategy_phase, torch, kernels,
                        card, lm_run, strategy_run)
    scale = phase("serve scale", serve_scale_phase, torch, fa, kernels,
                  card, 2, (lm_strategy or {}).get("two", {}).get("serve"))
    served_ranks = phase("serve search ranks", serve_search_ranks_phase,
                         torch, fa, kernels, card, 2,
                         (lm_strategy or {}).get("two", {})
                         .get("serve_search"))
    moe_ranks = phase("moe strategy", moe_strategy_phase, torch, kernels,
                      card, moe_run, strategy_run, lm_strategy)
    pipe = phase("pipeline", pipeline_phase, torch, kernels, card,
                 strategy_run)
    phase("search", search_phase, torch, kernels, card, strategy_run)
    if torch.cuda.device_count() >= 4:
        phase("strategy 4", strategy4_phase, torch, kernels, card)
        phase("placement 4", placement4_phase, torch, kernels, card,
              nmt_run, strategy_run)
        lm4 = phase("lm strategy 4", lm_strategy4_phase, torch, kernels,
                    card, lm_strategy)
        phase("serve scale 4", serve_scale_phase, torch, fa, kernels, card,
              4, (lm4 or {}).get("serve"))
        phase("serve search ranks 4", serve_search_ranks_phase, torch, fa,
              kernels, card, 4, (lm4 or {}).get("serve_search"))
        phase("moe strategy 4", moe_strategy4_phase, torch, kernels, card,
              moe_ranks)
        phase("pipeline 4", pipeline4_phase, torch, kernels, card, pipe,
              lm4)
        phase("search 4", search4_phase, torch, kernels, card, strategy_run)
    else:
        _log(f"four-card phases skipped: {torch.cuda.device_count()} "
             f"card(s) on this machine")
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
    if only:
        _log(f"chip_smoke --only: {time.perf_counter() - t0:.1f} s in all")
        print(json.dumps({"ok": False, "partial": sorted(only)}), flush=True)
        return PARTIAL_EXIT

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
    # kernel 1 on the serving paths of phases 8b and 18g: launches of the
    # routed run and of rank 0 in the autoscaling world, times at the
    # serving shape
    for tag, run in (("serve-disagg", disagg), ("serve-scale", scale)):
        entries.append(entry(f"{fa.NAME}.{tag}", fa.SOURCE,
                             "flexflow_tpu/ops/pallas/flash_attention.py:62",
                             run["launches"], checked["max_abs_err"],
                             checked["timings"]["float32"]))
    # phase 12c: kernel 1 on rank 0 of the routed pools over ranks (the
    # 2 + 2 form), kernels 7f and 9 on rank 0 of DenseNet's service over
    # ranks (data parallel)
    entries.append(entry(f"{fa.NAME}.serve-ranks", fa.SOURCE,
                         "flexflow_tpu/ops/pallas/flash_attention.py:62",
                         ranked["2+2"]["launches"], checked["max_abs_err"],
                         checked["timings"]["float32"]))
    # phases 8c and 8d: kernel 1 in the service from the searched
    # artifact (one card) and on rank 0 of the world's, kernels 2-3 in
    # the measured serving search's shard timing
    for tag, n in (("serve-search", served["launches"]),
                   ("serve-search-ranks", served_ranks["launches"])):
        entries.append(entry(f"{fa.NAME}.{tag}", fa.SOURCE,
                             "flexflow_tpu/ops/pallas/flash_attention.py:62",
                             n, checked["max_abs_err"],
                             checked["timings"]["float32"]))
    for name, line in ((fa.NAME_DKV, 158), (fa.NAME_DQ, 190)):
        entries.append(entry(
            name, fa.SOURCE_BWD,
            f"flexflow_tpu/ops/pallas/flash_attention.py:{line}",
            lm_n[name], flash_bwd["worst"][name],
            flash_bwd["timings"][name]))
        entries.append(entry(
            f"{name}.serve-search", fa.SOURCE_BWD,
            f"flexflow_tpu/ops/pallas/flash_attention.py:{line}",
            served["timing_launches"][name], flash_bwd["worst"][name],
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
    # the partial forms of kernels 1-6: launches on rank 0 of the LM's
    # two-rank strategy run, times in float32 at a rank's ring chunk
    # (non-causal) and vocab slice
    two_n = lm_strategy["two"]["launches"]
    for name, source, replaces in (
            (fa.NAME, fa.SOURCE, "flash_attention.py:385"),
            (fa.NAME_DKV, fa.SOURCE_BWD, "flash_attention.py:385"),
            (fa.NAME_DQ, fa.SOURCE_BWD, "flash_attention.py:385"),
            (ce.NAME_FWD, ce.SOURCE, "fused_ce.py:322"),
            (ce.NAME_FWD_COMBINE, ce.SOURCE, "fused_ce.py:322"),
            (ce.NAME_DX, ce.SOURCE_BWD, "fused_ce.py:322"),
            (ce.NAME_DX_SUM, ce.SOURCE_BWD, "fused_ce.py:322"),
            (ce.NAME_DW, ce.SOURCE_BWD, "fused_ce.py:322")):
        entries.append(entry(f"{name}.partial", source,
                             f"flexflow_tpu/ops/pallas/{replaces}",
                             two_n[f"{name}.partial"],
                             partials["worst"][name],
                             partials["timings"][name]))
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
    served_ranks_cnn = ranked["densenet121"]["launches"]
    entries.append(entry(f"{mp.NAME_FWD}.serve-ranks", mp.SOURCE,
                         "flexflow_tpu/ops/pallas/maxpool.py:249",
                         served_ranks_cnn[mp.NAME_FWD],
                         pools["worst"][mp.NAME_FWD],
                         dict(pools["max_step"]["fwd"], bound_by="bytes")))
    entries.append(entry(f"{bn.NAME_FWD}.serve-ranks", bn.SOURCE,
                         "flexflow_tpu/ops/pallas/bn_act.py:60",
                         served_ranks_cnn[bn.NAME_FWD],
                         bns["worst"][bn.NAME_FWD],
                         dict(bns["step"][bn.NAME_FWD], bound_by="bytes")))
    # kernels 9-10: launches from the DenseNet run, times summed over one
    # DenseNet step's 117 BNs, bfloat16 at batch 64
    for name in (bn.NAME_FWD, bn.NAME_BWD, bn.NAME_SUM):
        line = 60 if name == bn.NAME_FWD else 67
        entries.append(entry(name, bn.SOURCE,
                             f"flexflow_tpu/ops/pallas/bn_act.py:{line}",
                             dense["launches"][name], bns["worst"][name],
                             dict(bns["step"][name], bound_by="bytes")))
    shutil.rmtree(SERVE_SEARCH_ROOT, ignore_errors=True)
    _log(f"chip_smoke: {time.perf_counter() - t0:.1f} s in all")
    print(json.dumps({"kernels": entries}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
