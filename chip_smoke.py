#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each reported on its own line:

1. [build] build the port's CUDA kernels from ``csrc/`` with nvcc, one
   ``nvcc`` per source, started together: ``fused_mp`` (the fused round's
   forward, f32 and bf16, and backward), ``csr_mp`` (the CSR round's) and
   ``microbench_gather`` (row gather and scatter-add), ``gat_mp`` (the
   GATv2 round's forward and backward), and beside them the gather
   ablation's ``empty`` variant (the launch floor of [kernel-gather]);
   then [sass]: ``cuobjdump -sass`` of ``fused_mp`` and ``csr_mp``, HMMA
   (tensor-core) instructions counted per kernel instantiation: every
   instantiation of the bf16 forwards' kernels (``fwd_edge_kernel_bf16``,
   ``gemm_bf16_kernel``) holds some, every f32 kernel none;
2. [kernel] hold the fused forward kernel against its plain PyTorch version
   on the card at the main path's shapes (N=768, E=15360, D=De=D2=64,
   H=128, plus a ragged E) and at the wider widths (FWD_WIDE) where its
   edge kernel runs in one input stage, 16- and 8-edge tiles, two launches
   bitwise equal, and time both with CUDA events;
3. [kernel-bwd] the same for the fused backward's C call (all 11 outputs,
   each checked bitwise across two launches; also at H=256 and at De=96,
   H=256, where its edge kernel runs in 16- and 8-edge tiles), autograd
   through ``fused_message_pass`` on the card against the same on CPU
   tensors, and the device kernels of one ``fused_mp_backward`` call and
   of one wrapper call (``torch.profiler``);
4. [kernel-csr] the CSR forward kernel against its plain version on a kNN
   graph (k=10) at N=768, E=15360, a ragged E, a banded graph with a
   source window and kNN graphs at FWD_WIDE; two launches bitwise equal;
   timing and the device kernels of one call;
5. [kernel-csr-bwd] the same for the CSR backward kernel (all 10 outputs,
   each checked bitwise across two launches; also at H=256 and at De=96,
   H=256, where the edge kernel runs in 16- and 8-edge tiles), autograd
   through ``fused_message_pass_csr`` on the card against the CPU, and the
   device kernels of one ``csr_mp_backward`` call (``torch.profiler``);
5b. [kernel-gat] the GATv2 round's kernel pair (``ops/gat_mp.gat_round``)
   at ``gat.train``'s shapes (8 ``GNNConfig`` graphs, 64 -> 8 heads of 64):
   out and the gradients of xl, xr, ef, W_e, b_e, att and bias against
   ``GATv2Conv._attend`` in float64 (within twice the plain f32 path's
   error), out = bias without a kept edge, two launches bitwise equal; the
   launches of captured ``RadarGNNv2`` train steps; at B = 1 and B = 8 each
   C call's time, device kernels and bound beside the plain path's times;
6. [deploy] drive the deploy path — ``FrameDetector(GNNConfig(), ...)``, the
   shipped widths with random weights from a seeded ``torch.Generator`` —
   over synthetic frames at the default capacities, deploy and softmax one
   captured CUDA graph replayed a frame (its capture's second warm-up under
   sync debug "error"): count the forward kernel's launches (7 a replay
   and 7 a warm-up run), hold the captured detections bit for bit to the
   eager deploy's decisions on the same frames, profile one frame's
   forward (one host launch and the copies) beside the eager deploy's, and
   compare logits and decisions with the same detector on the CPU (which
   runs the plain version);
6b. [batched] the four round kernels and the bf16 forwards over 8
   graphs in one C call (the training batch, the main path's shapes)
   against one call a graph: per-graph outputs bitwise equal, the weight
   gradients within 1e-6 of the graphs' sum; the batch's layouts against
   each graph's; the batched call's time beside its bound, each bf16
   forward's beside its f32 twin's on the same inputs, and the two edge
   products alone as ``torch.matmul`` in bf16 (a yardstick);
7. [train] drive the training path — ``trainer.train`` with
   ``GNNConfig()`` at batch 8 on synthetic batches, each step a replay of
   one captured CUDA graph — count both kernels' launches (one a round a
   step for the batch), replay the same steps on the CPU and run them
   eagerly on the card (the batched and the per-graph step) and compare
   metrics and params, check the NaN skip on a poisoned batch (params and
   optimiser state bitwise), time a step and profile one (kernels, host
   launches, busy share);
8. [train-csr] the same with ``GNNConfig(mp_impl="csr")``, also against the
   default message pass on the card, and a window violation that the NaN
   guard turns into a skipped step;
9. [deploy-csr] ``FrameDetector(GNNConfig(mp_impl="csr"))``, captured as in
   [deploy], on 4 of the deploy frames against the default message pass on
   the card and against its own eager deploy (decisions bit for bit);
10. [kernel-bf16] the fused forward's bf16 instantiation (its edge
    products on the bf16 tensor cores) against its plain bf16 version on
    the [kernel] problems, two launches bitwise equal, the f32 kernel's
    output shown to lie outside that tolerance, timing beside its f32
    twin's on the same inputs (each a multiple of its bound) and the two
    edge products alone as ``torch.matmul`` in bf16;
11. [kernel-csr-bf16] the same for the CSR forward on the [kernel-csr]
    graphs (its node products on the tensor cores too), two launches
    bitwise equal;
12. [kernel-gather], [kernel-scatter] the microbenchmark's kernels against
    their plain versions with indices outside [0, N) (the scatter also
    bitwise against ``np.add.at`` and across two launches; the gather also
    bitwise against numpy indexing and across two launches with no rows, a
    ragged count and rows of 4 and 1024 floats), then the microbenchmark
    itself (``scripts/microbench_gather.run``: numpy check, timing beside
    the plain versions and ``index_select``/``index_add_``), and the
    gather's launch floor (an empty kernel on its grid, replayed from a CUDA
    graph in a process of its own) against its time and bound;
13. [train-bf16] ``trainer.train`` with ``make_train_step(GNNConfig(),
    mp_bf16=True)`` on the [train] batches, then with ``mp_impl="csr"``:
    bf16 forwards and f32 backwards counted (no f32 forward), the steps
    replayed on the CPU (losses and params), the f32 [train] run's losses
    shown to lie outside that tolerance, metrics against the f32 run,
    ms/step;
14. [checkpoint] ``trainer.train`` with ``GNNConfig()`` at batch 8, under
    PyTorch's deterministic algorithms: 2 steps saved by the checkpoint hook
    (``utils/checkpoint.CheckpointManager``), restored into a state made
    from another seed, 2 more from ``starting_iter=2``, against 4
    uninterrupted steps (twice): params, optimiser state and counters
    bitwise equal;
15. [data-plane] the host data plane: the native graph builder (built by
    the host compiler in [build]) against the numpy builder on the [deploy]
    frames (graph, degree and labels equal, float features at rtol 1e-5 /
    atol 1e-6); ``FrameDetector.detect`` through the native default against
    the numpy builder (decisions, p50 of each in turns); ``ops/graph_build``
    on the card against the numpy builder (structure equal, features close;
    time and kernels of one build); ``trainer.train_bucketed`` with
    ``GNNConfig()``'s default buckets (two reached) for 3 steps, its batches
    through ``device_prefetch``, both kernels counted, each step replayed on
    the CPU from the card's state before it; ``MultiprocessBatches`` (2
    forked workers) feeding 2 steps, no worker initialising CUDA;
16. [bench] the port bench (``scripts/bench.run``: root ``bench.py``'s
    train_b8 in four rows, stress_dense, deploy and ``FrameDetector.detect``)
    with one short repeat per config;
17. [eval] the committed fixture-trained weights, read without JAX
    (``utils/checkpoint.load_params_msgpack``), at the artifact's capacities
    (max_nodes 256, max_clusters 128, window 5): ``eval/drivers``'
    ``segmentation_confusion`` and ``evaluate_detection_from_data``
    (threshold 1, eps 0.7) over 16 seeded synthetic windows on the card
    against the same calls on the CPU (confusion matrices equal unless a
    frame's decisions differ within the [deploy] rule), the forward kernel
    counted, precision/recall and ms per frame;
18. [variants] ``RadarGNNv1.deploy`` at ``GNNConfig()`` full width through
    the fused round and through the CSR round, and ``RadarGNNv2.deploy``
    (GATv2 neck, hidden 512 over 8 heads, through the GATv2 kernel pair of
    ``ops/gat_mp.py``), seeded weights
    carried to a CPU copy, on 4 [deploy] frames: decisions under the
    [deploy] rule, logits within its tolerance, launches and ms per frame;
19. [finetune] ``train/finetune.make_finetune_step(GNNConfig())`` at batch 8
    for 3 steps, each a replay of one captured CUDA graph: one deploy
    forward of the frozen detector for the batch (the forward kernel once a
    round) and the trunk's gradient for the finiteness check (the backward
    kernel once a round), everything outside predict_class bitwise
    unchanged after every step and after a NaN-poisoned batch (skipped,
    the head and its momentum bitwise), each step against the same body
    run eagerly on the card and its loss and head gradient against one
    deploy a graph, and replayed on the CPU from the card's state before it
    with the card's DBSCAN partitions (themselves held to the CPU's under
    the [deploy] rule);
20. [classifier] ``models/classifier`` at ``ClassifierConfig()`` (512 points,
    64 objects, 8192 edges) and batch 8: 3 SGD steps, each a replay of one
    captured CUDA graph (one model call for the batch) held to the eager
    body on the card (bit for bit where two eager runs agree bit for bit,
    else within the CPU replay's tolerance; the case printed), one host
    launch a step, each replayed on the CPU;
21. [cnn] ``models/cnn.GridDetector(CNNConfig())`` on the default
    ``GridSpec`` (200 × 200 cells), batch 2, TF32 off: grid samples built
    on the card against the CPU's, 2 SGD steps, captured and held to the
    eager body as in [classifier] (ms per step), the first replayed on the
    CPU;
21b. [eval-step] the trainer's eval step at ``GNNConfig()``, batch 8, fused
    and CSR: ``trainer.train`` for 2 steps with a validation of 2 batches
    after each, the eval step one captured CUDA graph replayed a batch (7
    round-kernel launches a replay, one host launch), bit for bit the
    eager eval step (where two eager runs agree bit for bit), the
    second validation seeing the weights the train step changed in place;
    ms a validation batch, captured and eager;
22. [parallel] ``parallel/`` at ``GNNConfig()`` full width, batch 8, 2
    steps a mode from seeded weights: first each round kernel, forward and
    backward, on the inputs of an edge shard (E/2 edges) against its plain
    version; then 4 ranks of the port's worker, started once on the card
    under gloo (CUDA tensors), run data parallelism 4 x 1, the edge-sharded
    step 2 x 2 with the fused and with the CSR round (the message kernels
    on each rank's edge shard, one launch a round for the rank's graphs)
    and the halo step 2 x 2 on spatially sorted frames (plain rounds: no
    kernel), each step eager (gloo stages CUDA tensors through the host);
    then one rank under NCCL runs data parallelism 1 x 1, its step one
    captured CUDA graph replayed a step.  Each mode held to the
    single-process train step on the card from the same weights and batch,
    its first step to the plain rounds on the CPU, every rank's params
    bitwise equal, the launches and the collectives per rank and step exact
    (the data-parallel ones by kind and bytes), captured or eager as its
    backend says (one host launch a replay, also in a profile); ms per step
    per rank beside the single-process step's, the host ms blocked in the
    collectives of an eager step, each kind's calls and bytes a replay;
23. [examples] the user entry points, each through its ``main`` on the
    card at its shipped widths for 2 steps or frames, into a temporary
    directory: the 11 ``examples/`` (``visualize`` its detection half: this
    script needs no matplotlib), ``scripts/check_decision_equivalence``
    (card against CPU) and ``scripts/train_fixture_artifact``; each one's
    fused-kernel launches, ``overfit_gnn``'s step 1 replayed on the CPU,
    ``evaluate``'s confusion on the card equal to the CPU's, every file
    written parsed, the wall time of each;
24. [sweep] the port's batch sweep (``scripts/sweep_batch.py``) of
    ``train_b8`` at batch 8, 16 and 32, each size in its own process: ms a
    step from the slope of 20- and 80-step runs of the captured step,
    edge messages a second, occupancy, analytic TFLOP/s and its share of
    the card's f32 peak; a size that fails fails the phase;
25. print the kernel table as JSON and the card's name and power limit.

The last line is ``{"ok": true, "device": {...}}``; any failure exits
non-zero without it.  Needs one CUDA card, nvcc and no network; imports
nothing of JAX.

    python3 chip_smoke.py --phase kernel-timing
    python3 chip_smoke.py --phase sass
    python3 chip_smoke.py --phase kernel-bwd
    python3 chip_smoke.py --phase kernel-bwd-timing
    python3 chip_smoke.py --phase kernel-csr-bwd
    python3 chip_smoke.py --phase kernel-csr-bwd-timing
    python3 chip_smoke.py --phase kernel-gat
    python3 chip_smoke.py --phase checkpoint
    python3 chip_smoke.py --phase data-plane
    python3 chip_smoke.py --phase eval        # also variants, finetune,
    python3 chip_smoke.py --phase cnn         # classifier, eval-step
    python3 chip_smoke.py --phase parallel
    python3 chip_smoke.py --phase examples
    python3 chip_smoke.py --phase sweep
    python3 chip_smoke.py --phase train       # [batched] and the train phases
    python3 chip_smoke.py --phase deploy      # [deploy] and [deploy-csr]

build the libraries a phase needs and run [sass], phase 3 (the fused
backward), phase 5 (the CSR backward), phase 5b (the GATv2 round's
kernel pair, its two rows), phase 14 (the checkpoint), phase 15
(the data plane) or one of phases 17-24 (21b included) alone, or only a
timing (both forwards' C
calls and wrappers, f32 and bf16, with the digests of agg; a backward's C
call, the CSR one with the digest of its outputs and both forwards), then
print its row and the card as the last two lines (no ``ok`` line): the
quick way to time a kernel, e.g. another tree's beside this one's
(``time_forwards``, ``time_fused_bwd``, ``time_csr_bwd``).
"""

from __future__ import annotations

import copy
import hashlib
import json
import os
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, REPO)

# The published H100 SXM peaks (f32, dense bf16 tensor cores, HBM3) and the
# CUDA-event timer, shared with the port's microbenchmark.
from graph_neural_network_for_radar_perception_torch.utils.timing import (  # noqa: E402
    PEAK_BF16_FLOPS,
    PEAK_BYTES_PER_S,
    PEAK_F32_FLOPS,
    event_ms,
    graph_ms,
    kernel_breakdown,
    profile_run,
)

N, E, D, DE, H, D2 = 768, 15360, 64, 64, 128, 64
RTOL, ATOL = 2e-4, 2e-5              # kernel vs plain (other summation orders)
GRAD_RTOL, GRAD_ATOL = 5e-4, 5e-5    # tests/test_pallas.py's gradient check
DEPLOY_RTOL, DEPLOY_ATOL = 1e-3, 1e-4  # 7 rounds of card vs CPU arithmetic
METRIC_RTOL, METRIC_ATOL = 1e-3, 1e-4  # train metrics, card vs CPU
PARAM_RTOL, PARAM_ATOL = 1e-3, 1e-5    # params after the train steps
NUM_FRAMES = 8
NUM_CSR_FRAMES = 4     # [deploy-csr]: the first frames of [deploy]
TRAIN_STEPS = 3        # steps through trainer.train, replayed on the CPU
BUCKETED_STEPS = 3     # [data-plane]: steps of trainer.train_bucketed, replayed on the CPU
LOADER_STEPS = 2       # [data-plane]: steps fed by MultiprocessBatches
DETECT_REPS = 4        # [data-plane]: detect timings per frame and graph builder, in turns
EVAL_FRAMES = 16       # [eval]: synthetic windows through both eval drivers
EVAL_WINDOW = 5        # [eval]: the fixture artifact's temporal window
VARIANT_FRAMES = 4     # [variants]: the first [deploy] frames
FINETUNE_STEPS = 3     # [finetune]: steps at batch 8, replayed on the CPU
# [finetune]: the captured step against its body run eagerly on the card
# (the head's backward sums with index_add_ atomics), and the batched loss
# against the per-graph loop's (other matmul blockings).
FINETUNE_RTOL, FINETUNE_ATOL = 1e-5, 1e-6
CLASSIFIER_STEPS = 3   # [classifier]: steps, replayed on the CPU
CLASSIFIER_BATCH = 8
CNN_STEPS = 2          # [cnn]: steps; the first replayed on the CPU
CNN_BATCH = 2
CNN_MAX_MEAS = 1024    # preprocess_frame_hybrid's default capacity
# [classifier], [cnn]: the captured step's momentum (a step's gradient)
# against the eager step's where two eager runs differ (index_add_ atomics,
# cuDNN's weight gradients): within this share of its largest element.  A
# sum's rounding grows with the magnitudes summed, which the largest
# element stands for; elementwise tolerances fail on elements that cancel.
# Both phases print how far two eager runs' momentum lie apart in this
# measure, the margin this bound keeps.
MOMENTUM_SCALE = 1e-4
EVAL_STEP_TRAIN = 2    # [eval-step]: train steps, a validation after each
EVAL_STEP_VAL = 2      # [eval-step]: validation batches a validation
EVAL_STEP_TIMED = 20   # [eval-step]: timed calls, captured and eager
EXAMPLE_STEPS = 2      # [examples]: train steps of each entry point that trains
EXAMPLE_FRAMES = 2     # [examples]: frames of each evaluation
# [eval]: eigenvectors are compared one by one only where the eigenvalues
# are apart by more than this share of the larger: closer, f32 rounding may
# turn them by more than the deploy tolerance.
EIGEN_GAP = 1e-2
# The native and numpy graph builders round some edge features differently
# in the last bit (ROADMAP.md C4; tests/test_native.py's tolerance).
BUILDER_RTOL, BUILDER_ATOL = 1e-5, 1e-6
TIMED_STEPS = 7        # 2 warm-up + 5 timed
# Cotangent scale of the backward check: a train step hands a round dL/dagg
# of this order (the loss is a mean over ~10^3 nodes).
G_SCALE = 1e-2
# Backward checks drop edges whose leaky-ReLU inputs lie within this of 0:
# there the derivative jumps, and two summation orders may fall on either
# side of the kink.
KINK = 1e-4
# Widths (De, H, D2) at which the forwards' edge kernel runs in one input
# stage, 16- and 8-edge tiles on an H100 (fwd_plan; 32 and two stages at
# the main path's), each on N=256 nodes and E=3001 edges.
FWD_WIDE = ((64, 256, 64), (96, 256, 64), (64, 256, 128))
WIDE_N, WIDE_E = 256, 3001
# bf16 rounds (tests/test_torch_bf16.py's tolerance): the card and the CPU
# sum in other orders, and a last-bit difference of an f32 sum can flip one
# bf16 rounding, which moves one message element by one bf16 ulp (<= 2^-7 of
# it).  Flips are rare (a few per 10^5 roundings), so at most
# BF16_FLIP_SHARE of agg's elements may leave the tolerance, each by less
# than 2^-7 of agg's largest element.  The f32 kernel's output must lie at
# least BF16_SEPARATION tolerances away somewhere, and outside the
# tolerance at ten times as many elements as flips are allowed.
BF16_RTOL, BF16_ATOL = 1e-2, 1e-3
BF16_FLIP_SHARE = 1e-4
BF16_SEPARATION = 2.0
# Train metrics of bf16 steps against the CPU replay and the f32 run: the
# losses at the bf16 tolerance; an accuracy counts argmaxes, and an argmax
# whose two top logits lie within bf16 rounding may flip (0.05 is three of
# the ~64 object clusters of a batch).
ACC_ATOL = 0.05
# Each bf16 train step on the card against its CPU replay from the card's
# state before it: the losses within BF16_REPLAY_ATOL (one step agreed to
# 0.8-1.9e-6 on an H100; a flipped rounding can move a max-pool), and the
# f32 run's step-1 losses (4.9-6.1e-5 from the replay there) at least
# BF16_REPLAY_SEPARATION times that tolerance away, so that an f32 forward
# fails it.
BF16_REPLAY_ATOL = 1e-5
BF16_REPLAY_SEPARATION = 2.0
# [parallel]: the modes, each (name, kind, n_data, n_graph, mp_impl); those
# of 4 ranks run in one grid of 4 worker processes on the card under gloo,
# the 1 x 1 one in one worker process under NCCL.
PARALLEL_MODES = (
    ("dp-4x1", "dp", 4, 1, None),
    ("edge-2x2", "edge", 2, 2, None),
    ("edge-2x2-csr", "edge", 2, 2, "csr"),
    ("halo-2x2", "halo", 2, 2, None),
    ("dp-1x1-nccl", "dp", 1, 1, None),
)
PARALLEL_BATCH = 8
PARALLEL_STEPS = 2
PARALLEL_JOIN_S = 420         # a grid's limit, from start to the last rank's exit
# A grid against the single-process step on the card: tests/test_torch_train.py's
# STEP_TOL (the same kernels, the partial sums added in another order).
PARALLEL_RTOL, PARALLEL_ATOL = 1e-4, 1e-6
SWEEP_S = 420                 # [sweep]: the three sizes' limit
# [kernel-gat]: the kernel pair against the plain path in float64, each
# tensor's largest error within twice the plain f32 path's plus GAT_ATOL of
# its largest element (tests/test_torch_gat_kernel.py's ATOL: both sum in
# other orders, and a receiver of many edges amplifies its inputs' rounding).
GAT_ATOL = 2e-5
GAT_TRAIN_STEPS = 3           # [kernel-gat]: captured RadarGNNv2 train steps at batch 8


def log(msg: str) -> None:
    print(msg, flush=True)


def kernel_problem(torch, rng, e_valid: int, e_total: int, n: int = N,
                   de: int = DE, h: int = H, d2: int = D2, edges=None):
    """Random message round, at the deploy shapes unless told otherwise;
    the edge tail past ``e_valid`` is padding (sentinel n at both ends,
    zero features), as ``pad_frame`` + the model lay out a frame.  Or the
    given ``edges`` (senders, receivers; sentinel n where masked, zero
    features there)."""
    x = rng.normal(size=(n, D)).astype(np.float32)
    ef = rng.normal(size=(e_total, de)).astype(np.float32)
    if edges is None:
        s = rng.integers(0, n, size=e_total).astype(np.int32)
        r = rng.integers(0, n, size=e_total).astype(np.int32)
        s[e_valid:] = n
        r[e_valid:] = n
        ef[e_valid:] = 0.0
    else:
        s, r = edges
        ef[s == n] = 0.0
    w1 = (rng.normal(size=(2 * D + de, h)) / np.sqrt(2 * D + de)).astype(np.float32)
    b1 = (0.1 * rng.normal(size=h)).astype(np.float32)
    w2 = (rng.normal(size=(h, d2)) / np.sqrt(h)).astype(np.float32)
    b2 = (0.1 * rng.normal(size=d2)).astype(np.float32)
    dev = torch.device("cuda")
    arrays = [torch.from_numpy(a).to(dev) for a in (x, ef, s, r, w1, b1, w2, b2)]
    scalars = [torch.tensor([v], device=dev) for v in (1.1, 0.05, 0.9, -0.02)]
    return arrays + scalars


def fused_fwd_bytes(e: int, e_live: int) -> int:
    """Bytes the fused forward must move at the deploy shapes: xa and xb,
    every receiver (it decides which edges land), the ef row and sender of
    each edge that lands, the weights, the four scalars, and agg written
    once.  The padded tail's rows are never needed."""
    return 4 * (2 * N * H + e + e_live * (DE + 1) + DE * H + H + H * D2 + D2 + 4
                + N * D2)


def csr_fwd_bytes(e_live: int) -> int:
    """Bytes the CSR forward must move: x, the ef row, source and
    destination of each edge in a segment (the kernel walks only
    [off[v], off[v+1])), off [N+1], the weights, the four scalars, and agg
    written once."""
    return 4 * (N * D + e_live * (DE + 2) + N + 1 + (2 * D + DE) * H + H + H * D2
                + D2 + 4 + N * D2)


def fused_fwd_raw(torch, FM, args, agg):
    """(raw, alive): the arguments of one ``fused_mp_forward`` (or _bf16)
    call on the round ``args`` at the main path's shapes, writing ``agg``,
    and the tensors only its pointers refer to."""
    x, ef, s, r, w1, b1, w2, b2 = args[:8]
    xa, xb = x @ w1[:D], x @ w1[D:2 * D]
    w1e = w1[2 * D:]
    scal = torch.cat(args[8:])
    layout = FM.fused_layout(s, r, N)
    msgs = torch.empty(E, D2, device="cuda")
    raw = (xa.data_ptr(), xb.data_ptr(), ef.data_ptr(), s.data_ptr(),
           r.data_ptr(), layout.recv_order.data_ptr(), layout.recv_off.data_ptr(),
           w1e.data_ptr(), b1.data_ptr(), w2.data_ptr(), b2.data_ptr(),
           scal.data_ptr(), 0.01, msgs.data_ptr(), agg.data_ptr(), N, E, DE, H,
           D2, 1, torch.cuda.current_stream().cuda_stream)
    return raw, (xa, xb, scal, msgs, agg, layout)


def fused_problems(torch, rng):
    """The fused forward's checks, each (name, round): a frame-like padded
    tail and a ragged E at the main path's shapes, then FWD_WIDE."""
    out = [(f"E={e_total} valid={e_valid}", kernel_problem(torch, rng, e_valid, e_total))
           for e_valid, e_total in ((9216, E), (E - 3, E - 3))]
    return out + [(f"N={WIDE_N} E={WIDE_E} De={de} H={h} D2={d2}", kernel_problem(
        torch, rng, WIDE_E - 300, WIDE_E, WIDE_N, de, h, d2)) for de, h, d2 in FWD_WIDE]


def plan_of(FM, args, bf16: bool = False) -> str:
    """The fused forward's edge-kernel plan for the round ``args`` (its
    bf16 instantiation's with ``bf16``)."""
    x, ef, w2 = args[0], args[1], args[6]
    widths = (x.shape[0], ef.shape[0], ef.shape[1], w2.shape[0], w2.shape[1])
    p = (FM._plan("fused_mp", "fused_mp_forward_bf16_plan", x.device, *widths) if bf16
         else FM._forward_plan(*widths, x.device))
    return f"{p.tile}-edge tiles, {p.stages} stage(s), {p.blocks} blocks"


def phase_kernel(torch, FM):
    """Phase 2: kernel vs plain version at every tile the forward's plan
    takes, two launches bitwise, timing; returns the kernel's table row."""
    rng = np.random.default_rng(0)
    max_err = 0.0
    for name, args in fused_problems(torch, rng):
        got = FM.fused_message_pass(*args)
        again = FM.fused_message_pass(*args)
        torch.cuda.synchronize()
        want = FM.fused_message_pass_reference(*args)
        err = (got - want).abs()
        max_err = max(max_err, float(err.max()))
        bad = int((err > ATOL + RTOL * want.abs()).sum())
        same = bool(torch.equal(got, again))
        log(f"[kernel] {name} ({plan_of(FM, args)}): max_abs_err={float(err.max()):.3e} "
            f"violations(rtol={RTOL}, atol={ATOL})={bad}; two launches bitwise equal={same}")
        if bad or not torch.isfinite(got).all():
            raise AssertionError("fused_message_pass kernel disagrees with its plain version")
        if not same:
            raise AssertionError("fused_message_pass kernel is not deterministic")

    # Timing at the deploy shapes with the padded tail of a typical frame.
    args = kernel_problem(torch, rng, 9216, E)
    r = args[3]
    raw, alive = fused_fwd_raw(torch, FM, args, torch.empty(N, D2, device="cuda"))
    fn = FM._kernel()
    kernel_ms = event_ms(lambda: fn(*raw))
    call = device_kernels(lambda: fn(*raw))
    log(f"[kernel] one fused_mp_forward call, {len(call)} device kernels "
        f"(torch.profiler, us): " + "; ".join(f"{k} {us:.2f}" for k, us in call))
    layout = alive[-1]
    with torch.no_grad():  # the wrapper as a round of the model calls it
        wrapper_ms = event_ms(lambda: FM.fused_message_pass(*args, layout=layout))
        layout_ms = event_ms(lambda: FM.fused_layout(args[2], r, N))
    plain_ms = event_ms(lambda: FM.fused_message_pass_reference(*args))

    # Least time for the kernel's work on these inputs: the f32 FMAs of the
    # edges whose messages land (receiver in range), and what they need
    # read / written once.
    e_live = int(((r >= 0) & (r < N)).sum())
    flops = 2 * e_live * (DE * H + H * D2)
    nbytes = fused_fwd_bytes(E, e_live)
    t_ops, t_bytes = flops / PEAK_F32_FLOPS, nbytes / PEAK_BYTES_PER_S
    log(f"[kernel] timing E={E} live={e_live}: kernel {kernel_ms * 1e3:.2f} us, "
        f"wrapper (xa/xb matmuls + kernel) {wrapper_ms * 1e3:.2f} us, fused_layout "
        f"(once per graph) {layout_ms * 1e3:.2f} us, plain {plain_ms * 1e3:.2f} us; "
        f"bound {max(t_ops, t_bytes) * 1e6:.2f} us ({flops / 1e9:.3f} GFLOP, "
        f"{nbytes / 1e6:.2f} MB)")
    return {
        "name": "fused_message_pass",
        "route": "cuda",
        "source": "graph_neural_network_for_radar_perception_torch/csrc/fused_mp.cu",
        "replaces": "graph_neural_network_for_radar_perception_tpu/ops/pallas/fused_mp.py:82",
        "launches": None,
        "max_abs_err": max_err,
        "ms": kernel_ms,
        "plain_ms": plain_ms,
        "wrapper_ms": wrapper_ms,
        "layout_ms": layout_ms,
        "device_kernels_us": call,
        "bound_ms": max(t_ops, t_bytes) * 1e3,
        "bound_by": "operations" if t_ops >= t_bytes else "bytes",
        "library_ms": None,
    }


def digest(tensors) -> str:
    """sha256 of the tensors' bytes, in order: equal digests, equal bits."""
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().contiguous().cpu().numpy().tobytes())
    return h.hexdigest()


def time_forwards(torch, FM):
    """Both forwards as a round of the model calls them, f32 and bf16: the
    fused one at [kernel]'s timing problem (9216 live edges of E=15360,
    random receivers), the CSR one at [kernel-csr]'s (the kNN graph).  For
    each: the C entry point and the wrapper under ``no_grad`` with the
    graph's layout made once (CUDA events), the device kernels of one C
    call (torch.profiler) and the digest of agg.  With this file and
    ``utils/timing.py`` copied into another tree of the port with the same
    C signatures, ``--phase kernel-timing`` times that tree's forwards
    there, in turns with this one."""
    from graph_neural_network_for_radar_perception_torch.ops import csr_mp as C

    rng = np.random.default_rng(16)
    args = kernel_problem(torch, rng, 9216, E)
    layout = FM.fused_layout(args[2], args[3], N)
    _, csr_args, _ = csr_problems(torch, np.random.default_rng(5))[0]
    csr_layout = C.csr_layout(csr_args[2], csr_args[3], N, CSR_TILE, CSR_WINDOW, 0)
    # *_alive hold the tensors that only the raw pointers refer to.
    raw, fused_alive = fused_fwd_raw(torch, FM, args, torch.empty(N, D2, device="cuda"))
    csr_raw, csr_alive = csr_fwd_raw(torch, C, csr_args, csr_layout)
    rounds = {
        "fused": (lambda bf16: FM._kernel(bf16)(*raw),
                  lambda bf16: FM.fused_message_pass(*args, 0.01, bf16, layout=layout)),
        "csr": (lambda bf16: C._kernel(bf16)(*csr_raw),
                lambda bf16: C.fused_message_pass_csr(
                    *csr_args, 0.01, CSR_TILE, CSR_WINDOW, bf16, layout=csr_layout)),
    }
    row = {"name": "forwards (C entry points and wrappers)"}
    with torch.no_grad():
        for name, (entry, wrapper) in rounds.items():
            for bf16 in (False, True):
                tag = f"{name} {'bf16' if bf16 else 'f32'}"
                entry_ms = event_ms(lambda: entry(bf16))
                wrapper_ms = event_ms(lambda: wrapper(bf16))
                kernels = device_kernels(lambda: entry(bf16))
                out = digest([wrapper(bf16)])
                log(f"[kernel-timing] {tag}: C call {entry_ms * 1e3:.2f} us, wrapper "
                    f"{wrapper_ms * 1e3:.2f} us; one C call, {len(kernels)} device "
                    f"kernels (us): " + "; ".join(f"{k} {us:.2f}" for k, us in kernels)
                    + f"; agg sha256 {out}")
                row[tag] = {"ms": entry_ms, "wrapper_ms": wrapper_ms,
                            "device_kernels_us": kernels, "agg_sha256": out}
    return row


def kink_mask(torch, args):
    """Edges whose leaky-ReLU inputs (either layer, recomputed in float64)
    lie within KINK of 0.  args: a round as (x, ef, senders, receivers, w1,
    b1, w2, b2, 4 scalars); for the CSR round (src, dst) take the places of
    (senders, receivers)."""
    x, ef, s, r, w1, b1, w2, b2 = [a.double() for a in args[:8]]
    g1, be1, g2, be2 = [float(v) for v in args[8:]]
    n, d = x.shape
    s, r = s.long(), r.long()
    zero = x.new_zeros(1, w1.shape[1])
    xa = torch.cat([x @ w1[:d], zero])
    xb = torch.cat([x @ w1[d:2 * d], zero])
    ri = torch.where((r >= 0) & (r < n), r, n)
    si = torch.where((s >= 0) & (s < n), s, n)

    def norm(v, g, b):
        u = v - v.mean(-1, keepdim=True)
        sd = (u.square().sum(-1, keepdim=True) / (v.shape[-1] - 1)).sqrt()
        return g * u / (sd + 1e-5) + b

    h1 = norm(xa[ri] + xb[si] + ef @ w1[2 * d:] + b1, g1, be1)
    h2 = norm(torch.where(h1 >= 0, h1, 0.01 * h1) @ w2 + b2, g2, be2)
    return (h1.abs() < KINK).any(-1) | (h2.abs() < KINK).any(-1)


def drop_kink_edges(torch, args):
    """The problem with every edge of ``kink_mask`` dropped (receiver := N)."""
    n = args[0].shape[0]
    kink = kink_mask(torch, args)
    receivers = args[3].clone()
    receivers[kink] = n
    return args[:3] + [receivers] + args[4:], int(kink.sum())


FUSED_BWD_NAMES = "gef dxa dxb dw1e db1 dw2 db2 dg1 dbe1 dg2 dbe2".split()


def phase_kernel_bwd(torch, FM):
    """Phase 3: the fused backward's C call vs its plain version (all 11
    outputs), bitwise agreement of two launches per output, autograd on the
    card vs the CPU, timing and the per-launch breakdown of one call;
    returns its table row."""
    rng = np.random.default_rng(2)
    max_err = 0.0
    # A frame-like padded tail, a ragged E with one-sided sentinels, then
    # two wider rounds (N=256), where the edge kernel takes 16- and 8-edge
    # tiles.
    wide_rng = np.random.default_rng(15)
    problems = [(f"E={e_total} valid={e_valid} mixed={mixed}",
                 kernel_problem(torch, rng, e_valid, e_total), mixed)
                for e_valid, e_total, mixed in ((9216, E, False), (E - 3, E - 3, True))]
    problems += [(f"N=256 E=3001 De={de} H={h}",
                  kernel_problem(torch, wide_rng, 2700, 3001, 256, de, h), False)
                 for de, h in ((DE, 256), (96, 256))]
    for name, args, mixed in problems:
        n, e_total = args[0].shape[0], args[1].shape[0]
        if mixed:
            for i in (2, 3):
                args[i][torch.from_numpy(rng.random(e_total) < 0.05).cuda()] = n
        args, dropped = drop_kink_edges(torch, args)
        de, h = args[1].shape[1], args[4].shape[1]
        plan = FM._backward_plan(n, e_total, de, h, D2, args[0].device)
        g = torch.from_numpy(
            (G_SCALE * rng.normal(size=(n, D2))).astype(np.float32)).cuda()
        got = FM.fused_message_pass_backward(*args, g)
        again = FM.fused_message_pass_backward(*args, g)
        torch.cuda.synchronize()
        want = FM.fused_message_pass_backward_reference(*args, g)
        worst, same = {}, {}
        for out, a, b, c in zip(FUSED_BWD_NAMES, got, want, again):
            err = (a - b).abs()
            bad = int((err > GRAD_ATOL + GRAD_RTOL * b.abs()).sum())
            worst[out] = float(err.max())
            same[out] = bool(torch.equal(a, c))
            max_err = max(max_err, worst[out])
            if bad or not torch.isfinite(a).all():
                raise AssertionError(
                    f"fused_message_pass_backward: {name} {out} disagrees with "
                    f"its plain version at {bad} elements")
        log(f"[kernel-bwd] {name} ({plan.tile}-edge tiles, {plan.stages} stage(s), "
            f"{plan.blocks} blocks) kink edges dropped={dropped}: all 11 outputs "
            f"within rtol={GRAD_RTOL} atol={GRAD_ATOL}; max abs err {json.dumps(worst)}; "
            f"two launches bitwise equal {json.dumps(same)}")
        if not all(same.values()):
            raise AssertionError("fused_message_pass_backward is not deterministic")
        if mixed:
            checked = args, g

    # Autograd through the Function: the card (kernels) against CPU tensors
    # (plain versions), on the mixed-sentinel problem.
    args, g = checked

    def grads(device):
        leaves = [a.to(device).clone().requires_grad_()
                  for a in (args[0], args[1], args[4], args[5], args[6],
                            args[7], *args[8:])]
        x, ef, w1, b1, w2, b2, *sc = leaves
        out = FM.fused_message_pass(x, ef, args[2].to(device),
                                    args[3].to(device), w1, b1, w2, b2, *sc)
        return torch.autograd.grad(out, leaves, g.to(device))

    worst = 0.0
    for a, b in zip(grads("cuda"), grads("cpu")):
        err = (a.cpu() - b).abs()
        worst = max(worst, float(err.max()))
        if (err > GRAD_ATOL + GRAD_RTOL * b.abs()).any():
            raise AssertionError("autograd through fused_message_pass: card vs CPU")
    log(f"[kernel-bwd] autograd (x, ef, w1, b1, w2, b2, 4 norm scalars) card "
        f"vs CPU: max abs err {worst:.3e} (rtol={GRAD_RTOL}, atol={GRAD_ATOL})")

    row = time_fused_bwd(torch, FM)
    row["max_abs_err"] = max_err
    return row


def device_kernels(fn) -> list:
    """[name, µs] of each device kernel of one call of ``fn``
    (``kernel_breakdown``), names without argument lists."""
    return [[name.replace("void ", "").replace("(anonymous namespace)::", "")
             .split("(")[0], us] for name, us in kernel_breakdown(fn)]


def time_fused_bwd(torch, FM):
    """[kernel-bwd]'s timing at the main path's shapes (9216 live edges of
    E=15360, random receivers): the C entry point (CUDA events), the device
    kernels of one C call and of one wrapper call (torch.profiler), the
    wrapper, the plain version and the bound, as the kernel's table row (no
    error, no launches)."""
    rng = np.random.default_rng(14)
    args = kernel_problem(torch, rng, 9216, E)
    g = torch.from_numpy((G_SCALE * rng.normal(size=(N, D2))).astype(np.float32)).cuda()
    x, ef, s, r, w1, b1, w2, b2 = args[:8]
    layout = FM.fused_layout(s, r, N)
    # results holds the buffers that raw points to.
    raw, results = FM._backward_launch(x, ef, s, r, layout, w1, b1, w2, b2,
                                       torch.cat(args[8:]), g, 0.01)

    def wrapper():  # as the model's rounds call it, with the graph's layout
        return FM.fused_message_pass_backward(*args, g, 0.01, layout)

    fn = FM._bwd_kernel()
    kernel_ms = event_ms(lambda: fn(*raw))
    call = device_kernels(lambda: fn(*raw))
    whole = device_kernels(wrapper)
    log(f"[kernel-bwd] one fused_mp_backward call, {len(call)} device kernels "
        f"(torch.profiler, us): " + "; ".join(f"{k} {us:.2f}" for k, us in call))
    log(f"[kernel-bwd] one fused_message_pass_backward call (wrapper), {len(whole)} "
        f"device kernels (us): " + "; ".join(f"{k} {us:.2f}" for k, us in whole))
    wrapper_ms = event_ms(wrapper)
    plain_ms = event_ms(lambda: FM.fused_message_pass_backward_reference(*args, g))
    fn(*raw)  # the bits of the 11 outputs, to compare builds in turns
    log(f"[kernel-bwd] outputs sha256 (the 11 outputs of one C call): {digest(results())}")

    # Least time on these inputs: three times the forward's f32 FMAs for
    # each edge whose receiver is in range (forward recompute, two products
    # for the weight gradients, two for the input cotangents), and each
    # input read / output written once.
    e_live = int(((r >= 0) & (r < N)).sum())
    flops = 2 * 3 * e_live * (DE * H + H * D2)
    n_in = 2 * N * H + E * DE + 2 * E + DE * H + H + H * D2 + D2 + 4 + N * D2
    n_out = E * DE + 2 * N * H + DE * H + H + H * D2 + D2 + 4
    nbytes = 4 * (n_in + n_out)
    t_ops, t_bytes = flops / PEAK_F32_FLOPS, nbytes / PEAK_BYTES_PER_S
    log(f"[kernel-bwd] timing E={E} live={e_live}: C entry point {kernel_ms * 1e3:.2f} us, "
        f"wrapper (xa/xb matmuls, buffers + C call) {wrapper_ms * 1e3:.2f} us, plain "
        f"{plain_ms * 1e3:.2f} us; bound {max(t_ops, t_bytes) * 1e6:.2f} us "
        f"({flops / 1e9:.3f} GFLOP, {nbytes / 1e6:.2f} MB)")
    return {
        "name": "fused_message_pass_backward",
        "route": "cuda",
        "source": "graph_neural_network_for_radar_perception_torch/csrc/fused_mp.cu",
        "replaces": "graph_neural_network_for_radar_perception_tpu/ops/pallas/fused_mp.py:228",
        "launches": None,
        "max_abs_err": None,
        "ms": kernel_ms,
        "plain_ms": plain_ms,
        "wrapper_ms": wrapper_ms,
        "device_kernels_us": call,
        "wrapper_device_kernels_us": whole,
        "bound_ms": max(t_ops, t_bytes) * 1e3,
        "bound_by": "operations" if t_ops >= t_bytes else "bytes",
        "library_ms": None,
    }


def knn_edges(rng, n: int, k: int):
    """(senders, receivers) of a symmetrised kNN graph over random points in
    the unit square, row-major (sorted by sender), as ``pad_frame`` lays
    out a frame's edges."""
    p = rng.random((n, 2))
    d2 = ((p[:, None, :] - p[None, :, :]) ** 2).sum(-1)
    np.fill_diagonal(d2, np.inf)
    adj = np.zeros((n, n), bool)
    adj[np.arange(n)[:, None], np.argsort(d2, axis=1)[:, :k]] = True
    return np.nonzero(adj | adj.T)


def banded_edges(n: int, k: int):
    """(senders, receivers) of the banded graph |i - j| <= k, row-major: the
    index locality of spatially sorted nodes."""
    i, j = np.meshgrid(np.arange(n), np.arange(n), indexing="ij")
    return np.nonzero((np.abs(i - j) <= k) & (i != j))


def csr_problem(torch, rng, edges, e_total: int, n: int = N, d: int = D,
                de: int = DE, h: int = H, d2: int = D2, device="cuda"):
    """A CSR round over ``edges`` walked reversed (dst = senders, src =
    receivers) with a padded tail to ``e_total`` (sentinel n, zero
    features): (x, ef, src, dst, w1, b1, w2, b2, 4 scalars)."""
    s, r = edges
    e = s.shape[0]
    if e > e_total:
        raise ValueError(f"{e} edges do not fit {e_total}")
    src = np.full(e_total, n, np.int32)
    dst = np.full(e_total, n, np.int32)
    src[:e], dst[:e] = r, s
    ef = np.zeros((e_total, de), np.float32)
    ef[:e] = rng.normal(size=(e, de))
    arrays = [
        rng.normal(size=(n, d)).astype(np.float32), ef, src, dst,
        (rng.normal(size=(2 * d + de, h)) / np.sqrt(2 * d + de)).astype(np.float32),
        (0.1 * rng.normal(size=h)).astype(np.float32),
        (rng.normal(size=(h, d2)) / np.sqrt(h)).astype(np.float32),
        (0.1 * rng.normal(size=d2)).astype(np.float32),
    ]
    dev = torch.device(device)
    return ([torch.from_numpy(a).to(dev) for a in arrays]
            + [torch.tensor([v], device=dev) for v in (1.1, 0.05, 0.9, -0.02)])


def drop_kink_edges_csr(torch, args):
    """The CSR problem without its ``kink_mask`` edges: the kept edges keep
    their order and move up, the tail is padding (dropping an edge in place
    would move its tile's window base)."""
    n, e_total = args[0].shape[0], args[2].shape[0]
    keep = (~kink_mask(torch, args) & (args[3] < n)).nonzero().flatten()
    out = list(args)
    for i in (2, 3):
        out[i] = torch.full_like(args[i], n)
        out[i][: keep.numel()] = args[i][keep]
    out[1] = torch.zeros_like(args[1])
    out[1][: keep.numel()] = args[1][keep]
    return out, int((args[3] < n).sum()) - keep.numel()


CSR_TILE, CSR_WINDOW = 512, 256  # GNNConfig().csr_edge_tile, .csr_window


def csr_problems(torch, rng):
    """The [kernel-csr] problems, each (name, args, src_window): a kNN graph
    (k=10) of N nodes with a padded tail to E, the same in a ragged E, and
    a banded graph with a source window; each passes the CSR contract."""
    from graph_neural_network_for_radar_perception_torch.ops import csr_mp as C

    out = []
    for name, edges, e_total, src_window in (
        ("knn", knn_edges(rng, N, 10), E, 0),
        ("knn-ragged", knn_edges(rng, N, 10), E - 3, 0),
        ("banded-src-window", banded_edges(N, 6), E, 256),
    ):
        args = csr_problem(torch, rng, edges, e_total)
        src, dst = args[2].cpu().numpy(), args[3].cpu().numpy()
        ok, why = C.csr_contract_ok(dst, src, dst < N, CSR_TILE, CSR_WINDOW,
                                    src_window)
        if not ok:
            raise AssertionError(f"{name}: {why}")
        out.append((name, args, src_window))
    return out


def csr_fwd_problems(torch, rng):
    """The CSR forward's checks: the [kernel-csr] problems, then kNN graphs
    (k=8) at FWD_WIDE."""
    return csr_problems(torch, rng) + [
        (f"knn N={WIDE_N} E={WIDE_E} De={de} H={h} D2={d2}", csr_problem(
            torch, rng, knn_edges(rng, WIDE_N, 8), WIDE_E, WIDE_N, D, de, h, d2), 0)
        for de, h, d2 in FWD_WIDE]


def csr_plan_of(C, args, bf16: bool = False) -> str:
    """The CSR forward's edge-kernel plan for the round ``args`` (its bf16
    instantiation's with ``bf16``)."""
    x, ef, w2 = args[0], args[1], args[6]
    widths = (x.shape[0], ef.shape[0], x.shape[1], ef.shape[1], w2.shape[0], w2.shape[1])
    p = (C._plan("csr_mp", "csr_mp_forward_bf16_plan", x.device, *widths) if bf16
         else C._forward_plan(*widths, x.device))
    return f"{p.tile}-edge tiles, {p.stages} stage(s), {p.blocks} blocks"


def csr_fwd_raw(torch, C, args, layout):
    """(raw, alive): the arguments of one ``csr_mp_forward`` (or _bf16) call
    on the CSR round ``args`` over ``layout`` and the tensors only its
    pointers refer to (its output among them)."""
    x, ef, src, dst, w1, b1, w2, b2 = args[:8]
    n, d = x.shape
    e, de = ef.shape
    h, d2 = w1.shape[1], w2.shape[1]
    scal = torch.cat(args[8:])
    agg = torch.empty(n, d2, device="cuda")
    xab = torch.empty(2, n, h, device="cuda")
    msgs = torch.empty(e, d2, device="cuda")
    raw = (x.data_ptr(), ef.data_ptr(), layout.src.data_ptr(),
           layout.dst.data_ptr(), layout.off.data_ptr(), w1.data_ptr(),
           b1.data_ptr(), w2.data_ptr(), b2.data_ptr(), scal.data_ptr(),
           xab.data_ptr(), 0.01, msgs.data_ptr(), agg.data_ptr(),
           n, e, d, de, h, d2, 1,
           torch.cuda.current_stream().cuda_stream)
    return raw, (scal, xab, msgs, agg, layout)


def phase_kernel_csr(torch, C):
    """Phase 4: the CSR forward kernel vs its plain version at every tile
    the forward's plan takes, two launches bitwise, timing; returns the
    kernel's table row."""
    rng = np.random.default_rng(4)
    max_err = 0.0
    for name, args, src_window in csr_fwd_problems(torch, rng):
        tiling = (CSR_TILE, CSR_WINDOW, False, src_window)
        with torch.no_grad():
            got = C.fused_message_pass_csr(*args, 0.01, *tiling)
            again = C.fused_message_pass_csr(*args, 0.01, *tiling)
        torch.cuda.synchronize()
        want = C.fused_message_pass_csr_reference(
            *args, 0.01, CSR_TILE, CSR_WINDOW, src_window)
        err = (got - want).abs()
        max_err = max(max_err, float(err.max()))
        bad = int((err > ATOL + RTOL * want.abs()).sum())
        same = bool(torch.equal(got, again))
        log(f"[kernel-csr] {name} E={args[2].shape[0]} live="
            f"{int((args[3] < args[0].shape[0]).sum())} src_window={src_window} "
            f"({csr_plan_of(C, args)}): max_abs_err="
            f"{float(err.max()):.3e} violations(rtol={RTOL}, atol={ATOL})={bad}; "
            f"two launches bitwise equal={same}")
        if bad or not torch.isfinite(got).all() or not same:
            raise AssertionError(f"fused_message_pass_csr kernel: {name} disagrees")

    # Timing on the kNN graph at the main path's shapes.
    _, args, _ = csr_problems(torch, np.random.default_rng(5))[0]
    src, dst = args[2], args[3]
    layout = C.csr_layout(src, dst, N, CSR_TILE, CSR_WINDOW, 0)
    raw, alive = csr_fwd_raw(torch, C, args, layout)
    fn = C._kernel()
    kernel_ms = event_ms(lambda: fn(*raw))
    call = device_kernels(lambda: fn(*raw))
    log(f"[kernel-csr] one csr_mp_forward call, {len(call)} device kernels "
        f"(torch.profiler, us): " + "; ".join(f"{k} {us:.2f}" for k, us in call))
    with torch.no_grad():  # the wrapper as a round of the model calls it
        wrapper_ms = event_ms(lambda: C.fused_message_pass_csr(
            *args, 0.01, CSR_TILE, CSR_WINDOW, layout=layout))
        layout_ms = event_ms(lambda: C.csr_layout(
            src, dst, N, CSR_TILE, CSR_WINDOW, 0))
    plain_ms = event_ms(lambda: C.fused_message_pass_csr_reference(
        *args, 0.01, CSR_TILE, CSR_WINDOW))

    # Least time for the same work: the node-level products x·W1r, x·W1s
    # once per node, the edge-level products of every edge whose message
    # lands, what they need read and the output written once.
    e_live = int((layout.dst < N).sum())
    flops = 2 * 2 * N * D * H + 2 * e_live * (DE * H + H * D2)
    nbytes = csr_fwd_bytes(e_live)
    t_ops, t_bytes = flops / PEAK_F32_FLOPS, nbytes / PEAK_BYTES_PER_S
    log(f"[kernel-csr] timing E={E} live={e_live}: kernel {kernel_ms * 1e3:.2f} us, "
        f"wrapper (checks, buffers + kernel) {wrapper_ms * 1e3:.2f} us, csr_layout "
        f"(once per graph) {layout_ms * 1e3:.2f} us, plain "
        f"{plain_ms * 1e3:.2f} us; bound {max(t_ops, t_bytes) * 1e6:.2f} us "
        f"({flops / 1e9:.3f} GFLOP, {nbytes / 1e6:.2f} MB)")
    return {
        "name": "fused_message_pass_csr",
        "route": "cuda",
        "source": "graph_neural_network_for_radar_perception_torch/csrc/csr_mp.cu",
        "replaces": "graph_neural_network_for_radar_perception_tpu/ops/pallas/csr_mp.py:234",
        "launches": None,
        "max_abs_err": max_err,
        "ms": kernel_ms,
        "plain_ms": plain_ms,
        "wrapper_ms": wrapper_ms,
        "device_kernels_us": call,
        "bound_ms": max(t_ops, t_bytes) * 1e3,
        "bound_by": "operations" if t_ops >= t_bytes else "bytes",
        "library_ms": None,
    }


CSR_BWD_NAMES = "dx gef dw1 db1 dw2 db2 dg1 dbe1 dg2 dbe2".split()


def csr_bwd_timing_problem(torch, C):
    """(args, g, layout, raw, results): [kernel-csr-bwd]'s timing problem
    (the kNN graph at the main path's shapes), a cotangent of a train
    step's scale, its CSR layout, and the arguments of one
    ``csr_mp_backward`` call (``results`` holds the buffers they point
    to)."""
    _, args, _ = csr_problems(torch, np.random.default_rng(7))[0]
    g = torch.from_numpy((G_SCALE * np.random.default_rng(8).normal(
        size=(N, D2))).astype(np.float32)).cuda()
    x, ef, src, dst, w1, b1, w2, b2 = args[:8]
    layout = C.csr_layout(src, dst, N, CSR_TILE, CSR_WINDOW, 0)
    raw, results = C._backward_launch(x, ef, layout, w1, b1, w2, b2,
                                      torch.cat(args[8:]), g, 0.01)
    return args, g, layout, raw, results


def phase_kernel_csr_bwd(torch, C):
    """Phase 5: the CSR backward kernel vs its plain version (all 10
    outputs), bitwise agreement of two launches per output, autograd on the
    card vs the CPU, timing and the per-launch breakdown of one call;
    returns the kernel's table row."""
    rng = np.random.default_rng(6)
    max_err = 0.0
    # The main path's problems, then two at wider widths (N=256), where the
    # edge kernel takes 16- and 8-edge tiles.
    wide_rng = np.random.default_rng(9)
    wide = [(f"knn De={de} H={h}", csr_problem(
        torch, wide_rng, knn_edges(wide_rng, 256, 8), 3001, 256, D, de, h, D2), 0)
            for de, h in ((DE, 256), (96, 256))]
    for name, args, src_window in csr_problems(torch, rng) + wide:
        args, dropped = drop_kink_edges_csr(torch, args)
        n, d, de, h = args[0].shape[0], args[0].shape[1], args[1].shape[1], args[4].shape[1]
        plan = C._backward_plan(n, args[1].shape[0], d, de, h, D2, args[0].device)
        g = torch.from_numpy(
            (G_SCALE * rng.normal(size=(n, D2))).astype(np.float32)).cuda()
        tiling = (0.01, CSR_TILE, CSR_WINDOW, src_window)
        if src_window:
            windowed = args, g, src_window
        got = C.fused_message_pass_csr_backward(*args, g, *tiling)
        again = C.fused_message_pass_csr_backward(*args, g, *tiling)
        torch.cuda.synchronize()
        want = C.fused_message_pass_csr_backward_reference(*args, g, *tiling)
        worst, same = {}, {}
        for out, a, b, c in zip(CSR_BWD_NAMES, got, want, again):
            err = (a - b).abs()
            bad = int((err > GRAD_ATOL + GRAD_RTOL * b.abs()).sum())
            worst[out] = float(err.max())
            same[out] = bool(torch.equal(a, c))
            max_err = max(max_err, worst[out])
            if bad or not torch.isfinite(a).all():
                raise AssertionError(
                    f"fused_message_pass_csr_backward: {name} {out} disagrees "
                    f"with its plain version at {bad} elements")
        log(f"[kernel-csr-bwd] {name} ({plan.tile}-edge tiles, {plan.stages} "
            f"stage(s), {plan.blocks} blocks) kink edges dropped={dropped}: all 10 "
            f"outputs within rtol={GRAD_RTOL} atol={GRAD_ATOL}; max abs err "
            f"{json.dumps(worst)}; two launches bitwise equal {json.dumps(same)}")
        if not all(same.values()):
            raise AssertionError("fused_message_pass_csr_backward is not deterministic")

    # Autograd through the Function: the card against CPU tensors, on the
    # source-windowed problem.
    args, g, src_window = windowed

    def grads(device):
        leaves = [a.to(device).clone().requires_grad_()
                  for a in (args[0], args[1], *args[4:])]
        x, ef, w1, b1, w2, b2, *sc = leaves
        out = C.fused_message_pass_csr(
            x, ef, args[2].to(device), args[3].to(device), w1, b1, w2, b2, *sc,
            0.01, CSR_TILE, CSR_WINDOW, False, src_window)
        return torch.autograd.grad(out, leaves, g.to(device))

    worst = 0.0
    for a, b in zip(grads("cuda"), grads("cpu")):
        err = (a.cpu() - b).abs()
        worst = max(worst, float(err.max()))
        if (err > GRAD_ATOL + GRAD_RTOL * b.abs()).any():
            raise AssertionError("autograd through fused_message_pass_csr: card vs CPU")
    log(f"[kernel-csr-bwd] autograd (x, ef, w1, b1, w2, b2, 4 norm scalars) card "
        f"vs CPU: max abs err {worst:.3e} (rtol={GRAD_RTOL}, atol={GRAD_ATOL})")

    row = time_csr_bwd(torch, C)
    row["max_abs_err"] = max_err
    return row


def time_csr_bwd(torch, C):
    """[kernel-csr-bwd]'s timing: the C entry point (CUDA events), the device
    kernels of one call (torch.profiler), the wrapper, the plain version
    and the bound, as the kernel's table row (no error, no launches).  It
    uses only what older trees of the port have as well (``_backward_launch``,
    ``_bwd_kernel``): with this file and ``utils/timing.py`` copied into a
    parent checkout, ``--phase kernel-csr-bwd-timing`` times the parent's
    kernel there."""
    # Timing on the kNN graph at the main path's shapes.
    args, g, layout, raw, results = csr_bwd_timing_problem(torch, C)
    fn = C._bwd_kernel()
    kernel_ms = event_ms(lambda: fn(*raw))
    breakdown = device_kernels(lambda: fn(*raw))
    log(f"[kernel-csr-bwd] one csr_mp_backward call, {len(breakdown)} device "
        f"kernels (torch.profiler, us): " + "; ".join(
            f"{name} {us:.2f}" for name, us in breakdown))
    tiling = (0.01, CSR_TILE, CSR_WINDOW)
    wrapper_ms = event_ms(lambda: C.fused_message_pass_csr_backward(
        *args, g, *tiling))
    # The bits of the outputs, to compare builds in turns: the 10 backward
    # outputs of one C call, then each forward on this problem.
    fn(*raw)
    with torch.no_grad():
        forwards = [C.fused_message_pass_csr(*args, *tiling, bf16)
                    for bf16 in (False, True)]
    outputs = {"backward": digest(results()), "forward_f32": digest(forwards[:1]),
               "forward_bf16": digest(forwards[1:])}
    log(f"[kernel-csr-bwd] outputs sha256: the 10 backward outputs of one C call "
        f"{outputs['backward']}, the f32 forward {outputs['forward_f32']}, the bf16 "
        f"forward {outputs['forward_bf16']}")
    plain_ms = event_ms(lambda: C.fused_message_pass_csr_backward_reference(
        *args, g, *tiling))

    # Least time for the same work: the node-level products once (x·W1r and
    # x·W1s recomputed, dx's two, dW1r's and dW1s's), three times the
    # forward's edge-level products for every edge whose destination is in
    # range, each input read and each output written once.
    e_live = int((layout.dst < N).sum())
    flops = 2 * 6 * N * D * H + 2 * 3 * e_live * (DE * H + H * D2)
    n_in = N * D + E * DE + 2 * E + (2 * D + DE) * H + H + H * D2 + D2 + 4 + N * D2
    n_out = N * D + E * DE + (2 * D + DE) * H + H + H * D2 + D2 + 4
    nbytes = 4 * (n_in + n_out)
    t_ops, t_bytes = flops / PEAK_F32_FLOPS, nbytes / PEAK_BYTES_PER_S
    log(f"[kernel-csr-bwd] timing E={E} live={e_live}: kernel {kernel_ms * 1e3:.2f} us, "
        f"wrapper (index preparation, buffers + kernel) "
        f"{wrapper_ms * 1e3:.2f} us, plain {plain_ms * 1e3:.2f} us; bound "
        f"{max(t_ops, t_bytes) * 1e6:.2f} us ({flops / 1e9:.3f} GFLOP, "
        f"{nbytes / 1e6:.2f} MB)")
    return {
        "name": "fused_message_pass_csr_backward",
        "route": "cuda",
        "source": "graph_neural_network_for_radar_perception_torch/csrc/csr_mp.cu",
        "replaces": "graph_neural_network_for_radar_perception_tpu/ops/pallas/csr_mp.py:375",
        "launches": None,
        "max_abs_err": None,
        "ms": kernel_ms,
        "plain_ms": plain_ms,
        "wrapper_ms": wrapper_ms,
        "device_kernels_us": breakdown,
        "outputs_sha256": outputs,
        "bound_ms": max(t_ops, t_bytes) * 1e3,
        "bound_by": "operations" if t_ops >= t_bytes else "bytes",
        "library_ms": None,
    }


def gat_round_work(nodes: int, edges: int, de: int, hc: int, heads: int,
                   backward: bool) -> tuple:
    """(FLOPs, bytes) of a GATv2 round's C call on live rows: the edge
    projection's FMAs and the elementwise work once a live edge (the
    backward: the projection recomputed, dW_e and d(ef), twice the
    elementwise work); each input byte read and each output byte written
    once (xl, xr, out and the statistics a live node, ef and both ids a
    live edge, the weights)."""
    weights = 4 * (hc * de + 3 * hc)
    if not backward:
        flops = edges * (2 * de * hc + 7 * hc + 5 * heads)
        nbytes = (4 * (2 * nodes * hc + edges * de + nodes * hc + 2 * nodes * heads)
                  + 8 * edges + weights)
    else:
        flops = edges * (3 * 2 * de * hc + 14 * hc + 9 * heads)
        nbytes = (4 * (4 * nodes * hc + edges * de + 2 * nodes * heads) + 8 * edges + weights
                  + 4 * (edges * de + 2 * nodes * hc) + weights)
    return flops, nbytes


def _plain_gat_round(conv, xl, xr, ef, w_e, b_e, att, bias, s, r, em):
    """``GATv2Conv._attend`` on the node projections xl, xr and the
    weights given (not the conv's own), so that each is a leaf."""
    import types

    import torch.nn.functional as F

    from graph_neural_network_for_radar_perception_torch.models.gat import GATv2Conv

    view = types.SimpleNamespace(
        num_heads=conv.num_heads, out_channels=conv.out_channels, lin_l=lambda _: xl,
        lin_r=lambda _: xr, lin_edge=lambda e: F.linear(e, w_e, b_e), att=att, bias=bias)
    return GATv2Conv._attend(view, xl, ef, s, r, em)


def phase_kernel_gat(torch, _=None):
    """Phase 5b: the GATv2 round's kernel pair (``ops/gat_mp.gat_round``:
    ``gat_mp_forward``, ``gat_mp_backward``) at ``gat.train``'s shapes: 8
    ``GNNConfig()`` graphs packed as the training loader packs them, x and
    the edge features N(0, 1), a ``GATv2Conv`` 64 -> 8 heads of 64 with
    seeded weights and a bias that is not 0.  out and the gradients of xl,
    xr, ef, W_e, b_e, att and bias against ``GATv2Conv._attend`` on the
    same inputs, in f32 and in float64 on the card: each tensor's largest
    error within twice the plain f32 path's plus GAT_ATOL of its largest
    element (tests/test_torch_gat_kernel.py's rule); receivers without a
    kept edge output the bias; two launches bitwise equal.  Then the
    launches of GAT_TRAIN_STEPS captured ``RadarGNNv2`` train steps at batch
    8 (7 a run: each of the capture's warm-ups and each replay), and, at B = 1
    (graph 0) and B = 8, each C call's time (CUDA events), its device
    kernels, the plain path's forward and backward and the bounds from the
    live rows.  Returns the pair's table rows."""
    from graph_neural_network_for_radar_perception_torch.config.config import GNNConfig
    from graph_neural_network_for_radar_perception_torch.core import capture as CP
    from graph_neural_network_for_radar_perception_torch.data.pipeline import SyntheticRadarDataset
    from graph_neural_network_for_radar_perception_torch.models.blocks import init_parameters
    from graph_neural_network_for_radar_perception_torch.models.gat import (
        GAT_SLOPE,
        GATv2Conv,
        RadarGNNv2,
    )
    from graph_neural_network_for_radar_perception_torch.ops import gat_mp as GM
    from graph_neural_network_for_radar_perception_torch.train import steps as S

    cfg = GNNConfig(batch_size=BATCH, edge_capacity_factor=4 / 3)  # E_cap 10 240, as gat.train
    batch = next(SyntheticRadarDataset(cfg, seed=0, num_objects=(2, 12))
                 .packed_batches(BATCH))
    dev = torch.device("cuda")
    graph = batch.graph
    s, r = (torch.from_numpy(np.asarray(a)).int().to(dev)
            for a in (graph.senders, graph.receivers))
    em = torch.from_numpy(np.asarray(graph.edge_mask)).to(dev)
    nm = torch.from_numpy(np.asarray(graph.node_mask)).to(dev)
    heads, hc = cfg.num_heads_gat, cfg.hidden_node_channels_gat
    d, de = cfg.graph_convolution_stem_channels[0], cfg.edge_feat_enc_stem_channels[-1]
    b, n = nm.shape
    conv = GATv2Conv(d, de, hc // heads, heads)
    init_parameters(conv, torch.Generator().manual_seed(0))
    with torch.no_grad():  # a bias that is not 0, so that out's shift and its gradient show
        conv.bias.uniform_(-0.5, 0.5, generator=torch.Generator().manual_seed(1))
    conv = conv.to(dev)
    gen = torch.Generator(dev).manual_seed(0)
    x = torch.randn(b, n, d, device=dev, generator=gen)
    with torch.no_grad():
        xl, xr = conv.lin_l(x), conv.lin_r(x)
    ef = torch.randn(b, s.shape[1], de, device=dev, generator=gen)
    g_out = torch.randn(b, n, hc, device=dev, generator=gen)
    weights = (conv.lin_edge.weight, conv.lin_edge.bias, conv.att, conv.bias)
    inputs = [t.detach() for t in (xl, xr, ef, *weights)]
    layout = GM.gat_layout(s, r, em, n)
    names = ("out", "xl", "xr", "ef", "W_e", "b_e", "att", "bias")

    def round_of(fn, dtype, leaves_in, g):
        leaves = [t.to(dtype).clone().requires_grad_() for t in leaves_in]
        out = fn(*leaves)
        return [out.detach()] + list(torch.autograd.grad(out, leaves, g.to(dtype)))

    kernel = lambda *t: GM.gat_round(*t, layout, GAT_SLOPE)  # noqa: E731
    plain = lambda *t: _plain_gat_round(conv, *t, s, r, em)  # noqa: E731
    got = round_of(kernel, torch.float32, inputs, g_out)
    again = round_of(kernel, torch.float32, inputs, g_out)
    f32 = round_of(plain, torch.float32, inputs, g_out)
    ref = round_of(plain, torch.float64, inputs, g_out)
    torch.cuda.synchronize()
    worst, same = {}, {}
    for name, a, c, p, want in zip(names, got, again, f32, ref):
        scale = float(want.abs().max())
        err = float((a.double() - want).abs().max())
        err_plain = float((p.double() - want).abs().max())
        worst[name] = [err, err_plain, scale]
        same[name] = bool(torch.equal(a, c))
        if not torch.isfinite(a).all() or err > 2 * err_plain + GAT_ATOL * scale:
            raise AssertionError(f"[kernel-gat] {name}: kernel error {err:.3e} over twice the "
                                 f"plain f32 path's ({err_plain:.3e}) + {GAT_ATOL} x {scale:.3e}")
    kept = layout.order.recv_off.diff(dim=1)  # kept edges a receiver
    empty = kept == 0
    if not torch.equal(got[0][empty], inputs[-1].expand(b, n, hc)[empty]):
        raise AssertionError("[kernel-gat] a receiver without a kept edge: out is not the bias")
    live_edges = int(kept.sum())
    live_nodes = int(nm.sum())
    log(f"[kernel-gat] B={b} N={n} E={s.shape[1]} De={de} H*C={hc} H={heads} ({live_nodes} "
        f"live nodes, {live_edges} kept edges, {int(empty[nm].sum())} live receivers without "
        f"one; {GM.plan(n, s.shape[1], de, hc, heads, b, dev)}): gat_round against "
        f"GATv2Conv._attend in float64, [kernel error, plain f32 error, largest element] "
        f"{json.dumps(worst)}, each within 2 x plain + {GAT_ATOL} x largest; out = bias "
        f"without a kept edge; two launches bitwise equal {json.dumps(same)}")
    if not all(same.values()):
        raise AssertionError("[kernel-gat] the kernel pair is not deterministic")
    del again, f32, ref

    # The main path: a captured RadarGNNv2 train step (GNNConfig, batch 8).
    state = S.create_train_state(cfg, torch.Generator().manual_seed(0), device=dev,
                                 model_cls=RadarGNNv2)
    step = S.make_train_step(cfg)
    GM.gat_round.launches = GM.gat_round.backward_launches = 0
    for _ in range(GAT_TRAIN_STEPS):
        state, metrics = step(state, batch)
    torch.cuda.synchronize()
    launches = (GM.gat_round.launches, GM.gat_round.backward_launches)
    want = len(cfg.graph_convolution_stem_channels) * (CP.CapturedStep.WARMUP_RUNS
                                                       + GAT_TRAIN_STEPS)
    log(f"[kernel-gat] {GAT_TRAIN_STEPS} captured RadarGNNv2 train steps at batch {b}: "
        f"gat_mp_forward {launches[0]}, gat_mp_backward {launches[1]} (expected {want} each: "
        f"one a round in each of the capture's warm-ups and each replay); loss_total "
        f"{float(metrics['loss_total']):.6f}"
        f", skipped {float(metrics['skipped'])}")
    if launches != (want, want) or float(metrics["skipped"]) or not all(
            bool(torch.isfinite(v)) for v in metrics.values()):
        raise AssertionError("[kernel-gat] the v2 train step did not run the kernel pair once "
                             "a round, or its metrics are not finite")
    del state, step

    def kernels_of(fn, count: int) -> list:
        """The device kernels of one call of ``fn``, which launches
        ``count``: the last ``count`` of three calls under torch.profiler,
        which at times drops the first kernels of its window."""
        return device_kernels(lambda: [fn() for _ in range(3)])[-count:]

    def timing(graphs: int) -> dict:
        """The C calls, the conv's route and the plain path over the first
        ``graphs`` graphs, with their live rows' bounds."""
        t = [a[:graphs].contiguous() for a in inputs[:3]] + inputs[3:]
        lay = GM.gat_layout(s[:graphs], r[:graphs], em[:graphs], n)
        g = g_out[:graphs].contiguous()
        with torch.no_grad():
            out, stats = GM._forward(*t, lay, GAT_SLOPE)

        def fwd():
            return GM._forward(*t, lay, GAT_SLOPE)

        def bwd():
            return GM._backward(*t, out, stats, g, lay, GAT_SLOPE)

        args = (s[:graphs], r[:graphs], em[:graphs])
        leaves = [a.clone().requires_grad_() for a in t]
        plain_out = _plain_gat_round(conv, *leaves, *args)
        with torch.no_grad():
            res = {"fwd_ms": event_ms(fwd), "bwd_ms": event_ms(bwd),
                   "route_ms": event_ms(lambda: conv._attention(
                       x[:graphs], t[2], *args)),
                   "plain_fwd_ms": event_ms(lambda: _plain_gat_round(conv, *t, *args))}
        res["plain_bwd_ms"] = event_ms(lambda: torch.autograd.grad(
            plain_out, leaves, g, retain_graph=True))
        res["fwd_kernels"], res["bwd_kernels"] = kernels_of(fwd, 1), kernels_of(bwd, 3)
        edges = int(lay.order.recv_off[:, -1].sum())
        nodes = int(nm[:graphs].sum())
        for key, backward in (("fwd", False), ("bwd", True)):
            flops, nbytes = gat_round_work(nodes, edges, de, hc, heads, backward)
            res[key + "_bound"] = _bound(flops, nbytes)
            res[key + "_work"] = [flops, nbytes]
        res["nodes"], res["edges"] = nodes, edges
        return res

    one, eight = timing(1), timing(b)
    for tag, res in (("B=1 (graph 0)", one), (f"B={b}", eight)):
        log(f"[kernel-gat] timing {tag}, {res['nodes']} live nodes, {res['edges']} kept edges: "
            f"gat_mp_forward {res['fwd_ms'] * 1e3:.2f} us (bound "
            f"{res['fwd_bound']['b8_bound_ms'] * 1e3:.2f}, {res['fwd_bound']['b8_bound_by']}), "
            f"gat_mp_backward {res['bwd_ms'] * 1e3:.2f} us (bound "
            f"{res['bwd_bound']['b8_bound_ms'] * 1e3:.2f}, {res['bwd_bound']['b8_bound_by']}); "
            f"the conv's route (node projections, layout, forward) {res['route_ms'] * 1e3:.2f} "
            f"us; plain forward {res['plain_fwd_ms'] * 1e3:.2f} us, plain backward "
            f"{res['plain_bwd_ms'] * 1e3:.2f} us; device kernels (us): forward "
            + "; ".join(f"{k} {us:.2f}" for k, us in res["fwd_kernels"]) + "; backward "
            + "; ".join(f"{k} {us:.2f}" for k, us in res["bwd_kernels"]))

    def row(name, key, plain_key, errors):
        return {
            "name": name,
            "route": "cuda",
            "source": "graph_neural_network_for_radar_perception_torch/csrc/gat_mp.cu",
            "replaces": None,
            "plain": "graph_neural_network_for_radar_perception_torch/models/gat.py "
                     "GATv2Conv._attend",
            "launches": launches[key == "bwd"],
            "launches_by_path": {"train (v2, captured)": launches[key == "bwd"]},
            "max_abs_err": {k: worst[k][0] for k in errors},
            "ms": one[key + "_ms"],
            "plain_ms": one[plain_key],
            "device_kernels_us": one[key + "_kernels"],
            "bound_ms": one[key + "_bound"]["b8_bound_ms"],
            "bound_by": one[key + "_bound"]["b8_bound_by"],
            "b8_ms": eight[key + "_ms"],
            "b8_plain_ms": eight[plain_key],
            "b8_device_kernels_us": eight[key + "_kernels"],
            "b8_work": eight[key + "_work"],
            **eight[key + "_bound"],
            "library_ms": None,
        }

    fwd_row = row("gat_round", "fwd", "plain_fwd_ms", names[:1])
    fwd_row["wrapper_ms"], fwd_row["b8_wrapper_ms"] = one["route_ms"], eight["route_ms"]
    return fwd_row, row("gat_round_backward", "bwd", "plain_bwd_ms", names[1:])


BATCH = 8          # graphs a launch: [batched] and the train phases' GNNConfig().batch_size
DW_RTOL = 1e-6     # a batched launch's weight gradients against the graphs' sum


def graph_slice(layout, g: int):
    """Graph g's layout of a batch's (a graph axis of one kept)."""
    return type(layout)(*(t[g:g + 1] if hasattr(t, "shape") else t for t in layout))


def batched_round(torch, problems):
    """BATCH rounds as one batch: x, ef and both index arrays stacked on a
    leading graph axis, the first round's weights and scalars for all."""
    return [torch.stack([p[i] for p in problems]) for i in range(4)] + list(problems[0][4:])


def _graph_sum(parts):
    """The graphs' weight gradients added in graph order."""
    total = parts[0]
    for p in parts[1:]:
        total = total + p
    return total


def _check_batched(torch, tag: str, launch, names, stacked: int) -> dict:
    """One C call over the BATCH graphs (``launch(None)``) against one call
    a graph (``launch(g)``): the first ``stacked`` outputs bitwise equal
    graph by graph, the rest (weight gradients) within DW_RTOL of the
    graphs' sum, relative to the largest element of the graphs' summed
    magnitudes (sum over g of |dw_g|: the scale of a reassociated sum's
    rounding; the sum itself may cancel, as the norm scalars' do); then
    both timed.
    ``launch(g)`` → (call, results): the C call and a function of its
    outputs."""
    call, results = launch(None)
    if call() != 0:
        raise RuntimeError(f"[batched] {tag}: the batched call failed")
    calls = [launch(g) for g in range(BATCH)]
    for c, _ in calls:
        if c() != 0:
            raise RuntimeError(f"[batched] {tag}: a one-graph call failed")
    torch.cuda.synchronize()
    got, each = results(), [r() for _, r in calls]
    same = {n: all(torch.equal(got[i][g], each[g][i][0]) for g in range(BATCH))
            for i, n in enumerate(names[:stacked])}
    rel = {}
    for i, n in enumerate(names[stacked:], stacked):
        want = _graph_sum([e[i] for e in each])
        scale = float(_graph_sum([e[i].abs() for e in each]).max())
        rel[n] = float((got[i] - want).abs().max()) / max(scale, 1e-30)
    b8_ms = event_ms(call, reps=20, inner=5)
    x8_ms = event_ms(lambda: [c() for c, _ in calls], reps=20, inner=5)
    log(f"[batched] {tag}: one call for {BATCH} graphs vs {BATCH} one-graph calls: "
        f"bitwise equal {json.dumps(same)}; weight gradients max rel err "
        f"{json.dumps({k: f'{v:.2e}' for k, v in rel.items()})} (<= {DW_RTOL}); "
        f"C call {b8_ms * 1e3:.2f} us vs {BATCH} calls {x8_ms * 1e3:.2f} us")
    if not all(same.values()) or any(v > DW_RTOL for v in rel.values()):
        raise AssertionError(f"[batched] {tag}: a batched launch differs from its graphs' launches")
    return {"b8_ms": b8_ms, "b1x8_ms": x8_ms}


def _bound(flops: float, nbytes: float, peak: float = PEAK_F32_FLOPS) -> dict:
    """The least time at B = 8: operations over ``peak`` (their type's),
    bytes over the memory rate, the larger."""
    t_ops, t_bytes = flops / peak, nbytes / PEAK_BYTES_PER_S
    return {"b8_bound_ms": max(t_ops, t_bytes) * 1e3,
            "b8_bound_by": "operations" if t_ops >= t_bytes else "bytes"}


def _log_bf16_twin(out: dict, name: str) -> None:
    """The B = 8 time of a bf16 forward beside its f32 twin's on the same
    inputs, each as a multiple of its own bound; the twin's time joins the
    bf16 row."""
    bf, f32 = out[name + "_bf16"], out[name]
    bf["f32_b8_ms"] = f32["b8_ms"]
    log(f"[batched] {name}_bf16 forward: {bf['b8_ms'] * 1e3:.2f} us = "
        f"{bf['b8_ms'] / bf['b8_bound_ms']:.1f}x its bound ({bf['b8_bound_ms'] * 1e3:.2f} us, "
        f"{bf['b8_bound_by']}); its f32 twin on the same inputs {f32['b8_ms'] * 1e3:.2f} us = "
        f"{f32['b8_ms'] / f32['b8_bound_ms']:.1f}x its bound ({f32['b8_bound_ms'] * 1e3:.2f} us)")


def phase_batched(torch, FM, C) -> dict:
    """The graph axis of the four message-round kernels and the bf16
    forwards: at the main path's shapes, BATCH graphs (other edges and
    features, shared weights) in one C call against one call a graph on
    the same inputs (forwards: agg and the messages of the edges that land
    bitwise, msgs being a scratch whose other rows no kernel writes;
    backwards: gef, dxa,
    dxb / dx bitwise, the weight gradients within DW_RTOL of the graphs'
    sum), the batch's layouts against each graph's own, and the batched
    call's time beside its bound.  Returns {row name: B = 8 numbers}."""
    rng = np.random.default_rng(21)
    out = {}
    fused = batched_round(torch, [kernel_problem(torch, rng, 9216 - 512 * g, E)
                                  for g in range(BATCH)])
    x, ef, s, r, w1, b1, w2, b2 = fused[:8]
    scal = torch.cat(fused[8:])
    layout = FM.fused_layout(s, r, N)
    for g in range(BATCH):
        if not all(torch.equal(a[g], b) for a, b in zip(layout, FM.fused_layout(s[g], r[g], N))):
            raise AssertionError("[batched] the batch's fused layout is not each graph's")
    xa, xb = x @ w1[:D], x @ w1[D:2 * D]  # one set of node products for both
    gout = torch.from_numpy((G_SCALE * rng.normal(size=(BATCH, N, D2))).astype(np.float32)).cuda()
    e_live = [int(((r[g] >= 0) & (r[g] < N)).sum()) for g in range(BATCH)]
    weights = DE * H + H + H * D2 + D2 + 4

    def fused_fwd(bf16):
        def launch(g):
            sl = slice(None) if g is None else slice(g, g + 1)
            raw, outs = FM._forward_launch(
                x[sl], ef[sl], s[sl], r[sl], w1, b1, w2, b2, scal, 0.01,
                layout if g is None else graph_slice(layout, g), (xa[sl], xb[sl]))
            fn = FM._kernel(bf16)
            lands = ((r[sl] >= 0) & (r[sl] < N))[..., None]
            return (lambda: fn(*raw)), (lambda: (outs[1], torch.where(lands, outs[0], 0.0)))
        return launch

    fwd_bytes = 4 * sum(2 * N * H + E + e * (DE + 1) + N * D2 for e in e_live) + 4 * weights
    fwd_flops = 2 * sum(e_live) * (DE * H + H * D2)
    for bf16, name in ((False, "fused_message_pass"), (True, "fused_message_pass_bf16")):
        row = _check_batched(torch, f"{name} forward", fused_fwd(bf16), ["agg", "msgs"], 2)
        out[name] = dict(row, **_bound(fwd_flops, fwd_bytes,
                                       PEAK_BF16_FLOPS if bf16 else PEAK_F32_FLOPS))
    _log_bf16_twin(out, "fused_message_pass")
    log_product_yardstick(torch, "[batched] fused_message_pass_bf16", ef[(r >= 0) & (r < N)],
                          w1[2 * D:], w2)

    def fused_bwd(g):
        sl = slice(None) if g is None else slice(g, g + 1)
        raw, results = FM._backward_launch(
            x[sl], ef[sl], s[sl], r[sl], layout if g is None else graph_slice(layout, g),
            w1, b1, w2, b2, scal, gout[sl].contiguous(), 0.01, (xa[sl], xb[sl]))
        fn = FM._bwd_kernel()
        return (lambda: fn(*raw)), results

    row = _check_batched(torch, "fused_message_pass_backward", fused_bwd, FUSED_BWD_NAMES, 3)
    n_io = sum(2 * N * H + E * DE + 2 * E + N * D2 + E * DE + 2 * N * H for _ in e_live)
    out["fused_message_pass_backward"] = dict(row, **_bound(
        3 * fwd_flops, 4 * (n_io + 2 * weights)))

    csr = batched_round(torch, [csr_problem(torch, rng, knn_edges(rng, N, 10), E)
                                for _ in range(BATCH)])
    x, ef, src, dst, w1, b1, w2, b2 = csr[:8]
    scal = torch.cat(csr[8:])
    layout = C.csr_layout(src, dst, N, CSR_TILE, CSR_WINDOW, 0)
    for g in range(BATCH):
        one = C.csr_layout(src[g], dst[g], N, CSR_TILE, CSR_WINDOW, 0)
        if not all(torch.equal(a[g], b) for a, b in zip(layout, one) if hasattr(b, "shape")):
            raise AssertionError("[batched] the batch's CSR layout is not each graph's")
    gout = torch.from_numpy((G_SCALE * rng.normal(size=(BATCH, N, D2))).astype(np.float32)).cuda()
    e_live = [int((layout.dst[g] < N).sum()) for g in range(BATCH)]
    weights = (2 * D + DE) * H + H + H * D2 + D2 + 4

    def csr_fwd(bf16):
        def launch(g):
            sl = slice(None) if g is None else slice(g, g + 1)
            raw, outs = C._forward_launch(x[sl], ef[sl], layout if g is None
                                          else graph_slice(layout, g), w1, b1, w2, b2,
                                          scal, 0.01)
            fn = C._kernel(bf16)
            lands = ((layout.dst < N) if g is None else (layout.dst[g:g + 1] < N))[..., None]
            return (lambda: fn(*raw)), (lambda: (outs[1], torch.where(lands, outs[0], 0.0)))
        return launch

    fwd_flops = sum(2 * 2 * N * D * H + 2 * e * (DE * H + H * D2) for e in e_live)
    fwd_bytes = 4 * sum(N * D + e * (DE + 2) + N + 1 + N * D2 for e in e_live) + 4 * weights
    for bf16, name in ((False, "fused_message_pass_csr"), (True, "fused_message_pass_csr_bf16")):
        row = _check_batched(torch, f"{name} forward", csr_fwd(bf16), ["agg", "msgs"], 2)
        out[name] = dict(row, **_bound(fwd_flops, fwd_bytes,
                                       PEAK_BF16_FLOPS if bf16 else PEAK_F32_FLOPS))
    _log_bf16_twin(out, "fused_message_pass_csr")
    log_product_yardstick(torch, "[batched] fused_message_pass_csr_bf16",
                          ef[layout.dst < N], w1[2 * D:], w2)

    def csr_bwd(g):
        sl = slice(None) if g is None else slice(g, g + 1)
        raw, results = C._backward_launch(
            x[sl], ef[sl], layout if g is None else graph_slice(layout, g), w1, b1, w2, b2,
            scal, gout[sl].contiguous(), 0.01)
        fn = C._bwd_kernel()
        return (lambda: fn(*raw)), results

    row = _check_batched(torch, "fused_message_pass_csr_backward", csr_bwd, CSR_BWD_NAMES, 2)
    flops = sum(2 * 6 * N * D * H + 2 * 3 * e * (DE * H + H * D2) for e in e_live)
    n_io = BATCH * (N * D + E * DE + 2 * E + N * D2 + N * D + E * DE)
    out["fused_message_pass_csr_backward"] = dict(row, **_bound(flops, 4 * (n_io + 2 * weights)))
    return out


def _components(adj: np.ndarray) -> np.ndarray:
    """Component label (minimum member index) per node of a boolean graph."""
    n = adj.shape[0]
    label = np.full(n, -1)
    for m in range(n):
        if label[m] >= 0:
            continue
        label[m], stack = m, [m]
        while stack:
            i = stack.pop()
            for j in np.flatnonzero(adj[i] & (label < 0)):
                label[j] = m
                stack.append(j)
    return label


def _same_partition(a: np.ndarray, b: np.ndarray) -> bool:
    """Do label vectors a and b group the nodes alike (ids aside)?"""
    pairs = set(zip(a.tolist(), b.tolist()))
    return len(pairs) == len(set(a.tolist())) == len(set(b.tolist()))


def _coarser_or_equal(fine: np.ndarray, coarse: np.ndarray) -> bool:
    """Is every class of ``fine`` inside one class of ``coarse``?"""
    seen = {}
    return all(seen.setdefault(f, c) == c for f, c in zip(fine.tolist(), coarse.tolist()))


def _ties(logits: np.ndarray) -> np.ndarray:
    """Rows whose top two logits lie within the deploy tolerance."""
    top2 = np.sort(logits, axis=-1)[:, -2:]
    return top2[:, 1] - top2[:, 0] <= DEPLOY_ATOL + DEPLOY_RTOL * np.abs(top2[:, 1])


def check_partition(gpu_ids, cpu_ids, centers, eps: float) -> dict:
    """Two DBSCAN partitions of the same nodes (ids aside): equal, or, where
    some pair of ``centers`` has d² within 1e-4 of eps, both between the
    components of the graph without those pairs and of the graph with
    them; raises otherwise."""
    c = np.asarray(centers, np.float64)
    d2 = ((c[:, None, :] - c[None, :, :]) ** 2).sum(-1)
    off_diag = ~np.eye(c.shape[0], dtype=bool)
    border = (np.abs(d2 - eps) <= 1e-4) & off_diag
    same = _same_partition(gpu_ids, cpu_ids)
    if not same:
        strict = _components((d2 <= eps) & off_diag & ~border)
        loose = _components(((d2 <= eps) & off_diag) | border)
        for name, part in (("gpu", gpu_ids), ("cpu", cpu_ids)):
            if not (_coarser_or_equal(strict, part) and _coarser_or_equal(part, loose)):
                raise AssertionError(
                    f"{name} DBSCAN partition differs beyond borderline pairs")
    return {"borderline_pairs": int(border.sum() // 2), "partition_equal": bool(same)}


def compare_decisions(gpu, cpu, node_logits, obj_logits, eps: float) -> dict:
    """Decisions of the card's detector against the CPU's on one frame.

    Node and object classes must be equal except where the CPU's top two
    logits tie within the deploy tolerance.  DBSCAN partitions must be
    equal, or, where some pair of centers has d² within 1e-4 of eps, both
    lie between the components of the graph without those pairs and of the
    graph with them."""
    report = {}
    diff = np.flatnonzero(gpu.node_class != cpu.node_class)
    tied = _ties(node_logits)
    report["node_class_diffs"] = int(diff.size)
    if not tied[diff].all():
        raise AssertionError(f"node classes differ at {diff[~tied[diff]][:10].tolist()}")

    report.update(check_partition(gpu.node2cluster, cpu.node2cluster, cpu.centers, eps))
    if not report["partition_equal"]:
        return report
    # Same partition: cluster ids follow the same scan order on both.
    k = cpu.num_clusters
    diff = np.flatnonzero(gpu.cluster_class[:k] != cpu.cluster_class[:k])
    report["object_class_diffs"] = int(diff.size)
    if gpu.num_clusters != k or not _ties(obj_logits[:k])[diff].all():
        raise AssertionError(f"object classes differ for clusters {diff[:10].tolist()}")
    return report


def phase_deploy(torch, FM):
    """Phase 4: the deploy path on the card, against the CPU."""
    from graph_neural_network_for_radar_perception_torch.config.config import GNNConfig
    from graph_neural_network_for_radar_perception_torch.core.graph import RadarGraph
    from graph_neural_network_for_radar_perception_torch.data.pipeline import pad_frame, preprocess_frame
    from graph_neural_network_for_radar_perception_torch.infer.pipeline import FrameDetector
    from graph_neural_network_for_radar_perception_torch.models.gnn import RadarGNN

    cfg = GNNConfig()  # shipped widths; max_nodes 768, E_cap 15360, window 10
    state = RadarGNN(cfg, generator=torch.Generator().manual_seed(0)).state_dict()
    det_gpu = FrameDetector(cfg, state, device="cuda")
    det_cpu = FrameDetector(cfg, state, device="cpu")
    frames = deploy_frames(cfg, NUM_FRAMES + 1)

    FM.fused_message_pass.launches = 0
    # The first frame captures deploy + softmax (two warm-up runs, the
    # second under sync debug "error") and replays it: warm-up, untimed.
    det_gpu.detect(frames[-1])
    torch.cuda.synchronize()
    gpu_dets, frame_ms = [], []
    for data in frames[:NUM_FRAMES]:
        t0 = time.perf_counter()
        det = det_gpu.detect(data)  # ends in device→host copies
        torch.cuda.synchronize()
        frame_ms.append((time.perf_counter() - t0) * 1e3)
        gpu_dets.append(det)
    launches = FM.fused_message_pass.launches
    rounds = len(cfg.graph_convolution_stem_channels)
    n_run = sum(d is not None for d in gpu_dets)
    runs = detector_runs(det_gpu)
    log(f"[deploy] {n_run} frames (+1 warm-up) through the captured detector: "
        f"{len(det_gpu.captured.graphs)} capture, {det_gpu.captured.replays} replays, "
        f"{det_gpu.captured.warmups} warm-up runs; fused_message_pass launches={launches} "
        f"(expected {rounds} x ({det_gpu.captured.replays} replays + "
        f"{det_gpu.captured.warmups} warm-up runs) = {rounds * runs}); FrameDetector.detect "
        f"(host preprocess + pad + copies + replay + decode) ms/frame median "
        f"{np.median(frame_ms):.3f} (min {min(frame_ms):.3f}, max {max(frame_ms):.3f})")
    if (n_run < 4 or launches != rounds * runs or len(det_gpu.captured.graphs) != 1
            or det_gpu.captured.replays != n_run + 1):
        raise AssertionError("the deploy path did not replay one captured graph a frame, "
                             "the kernel once a round")

    worst, deploy_ms, captured_ms, eager_diff = {}, [], [], 0.0
    for i, (data, gdet) in enumerate(zip(frames, gpu_dets)):
        cdet = det_cpu.detect(data)
        if (gdet is None) != (cdet is None):
            raise AssertionError(f"frame {i}: presence differs")
        if gdet is None:
            continue
        fr = preprocess_frame(data, cfg)
        graph_np, _ = pad_frame(fr, cfg)
        with torch.no_grad():
            graph = RadarGraph.from_numpy(graph_np, "cuda")
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out_gpu = det_gpu.model.deploy(graph)
            torch.cuda.synchronize()
            deploy_ms.append((time.perf_counter() - t0) * 1e3)
            t0 = time.perf_counter()
            det_gpu.forward(graph_np)
            torch.cuda.synchronize()
            captured_ms.append((time.perf_counter() - t0) * 1e3)
            outs = {"cuda": out_gpu,
                    "cpu": det_cpu.model.deploy(RadarGraph.from_numpy(graph_np, "cpu"))}
        nm = graph_np.node_mask
        um = graph_np.und_mask
        for field, rows in (("node_cls", nm), ("node_offsets", nm),
                            ("edge_cls", um), ("centers", nm)):
            a = getattr(outs["cuda"], field).cpu().numpy()[rows]
            b = getattr(outs["cpu"], field).numpy()[rows]
            if a.shape != b.shape or not np.isfinite(a).all():
                raise AssertionError(f"frame {i}: {field} malformed")
            err = np.abs(a - b)
            worst[field] = max(worst.get(field, 0.0), float(err.max()))
            if (err > DEPLOY_ATOL + DEPLOY_RTOL * np.abs(b)).any():
                raise AssertionError(f"frame {i}: {field} differs beyond tolerance")
        rep = compare_decisions(
            gdet, cdet, outs["cpu"].node_cls.numpy()[: fr.n],
            outs["cpu"].obj_cls.numpy(), det_gpu.eps)
        eager_diff = max(eager_diff, captured_vs_eager(torch, det_gpu, graph_np, gdet,
                                                       f"[deploy] frame {i}"))
        log(f"[deploy] frame {i}: n={fr.n} edges={fr.senders.shape[0]} "
            f"clusters={gdet.num_clusters} {json.dumps(rep)}")
    log(f"[deploy] card vs CPU max abs err: {json.dumps(worst)} "
        f"(rtol={DEPLOY_RTOL}, atol={DEPLOY_ATOL})")
    log(f"[deploy] the captured detector against the eager deploy on the card, every frame: "
        f"node classes, DBSCAN partitions, cluster counts and object classes bit for bit; "
        f"outputs max abs diff {eager_diff!r} ({'bitwise' if eager_diff == 0 else 'not bitwise'})")
    log(f"[deploy] the deploy forward alone on the card, ms/frame median (min, max): captured "
        f"(copies + replay) {np.median(captured_ms):.3f} ({min(captured_ms):.3f}, "
        f"{max(captured_ms):.3f}); eager RadarGNN.deploy {np.median(deploy_ms):.3f} "
        f"({min(deploy_ms):.3f}, {max(deploy_ms):.3f})")
    log_captured_forward(torch, "[deploy]", det_gpu, graph_np, graph, rounds)
    with torch.no_grad():
        layout_kernels = len(kernel_breakdown(lambda: FM.fused_layout(
            graph.senders, graph.receivers, graph.node_feat.shape[0])))
    log(f"[deploy] of them {layout_kernels} the graph's fused_layout (made once per frame, "
        f"inside the graph)")
    return launches


def detector_runs(det) -> int:
    """How often a detector's deploy body ran on the card: each replay of
    its CUDA graphs and each warm-up run of a capture."""
    return det.captured.replays + det.captured.warmups


def captured_vs_eager(torch, det, graph_np, gdet, tag: str) -> float:
    """The detector's captured forward of one padded frame (a replay)
    against the eager deploy of its model on the same graph, both on the
    card, and ``gdet`` (its detections of that frame) against the
    decisions of the eager forward: DBSCAN's partition, the cluster count,
    the node classes and the object classes bit for bit, or raises.
    Returns the max abs difference of the float outputs."""
    from graph_neural_network_for_radar_perception_torch.core.graph import RadarGraph

    out, prob, _ = det.forward(graph_np)
    cap = {k: v.clone() for k, v in out._asdict().items()}
    prob = prob.clone()
    with torch.no_grad():
        ref = det.model.deploy(RadarGraph.from_numpy(graph_np, "cuda"), eps=det.eps,
                               from_links=det.from_links)
        ref_prob = torch.softmax(ref.node_cls, dim=-1)
    n, k = gdet.node_class.shape[0], int(ref.num_clusters)
    ref_cls = ref_prob[:n].argmax(-1).cpu().numpy()
    same = (torch.equal(cap["node2cluster"], ref.node2cluster)
            and torch.equal(cap["num_clusters"], ref.num_clusters)
            and torch.equal(prob.argmax(-1), ref_prob.argmax(-1))
            and torch.equal(cap["obj_cls"][:k].argmax(-1), ref.obj_cls[:k].argmax(-1))
            and np.array_equal(gdet.node_class, ref_cls)
            and np.array_equal(gdet.node2cluster, ref.node2cluster[:n].cpu().numpy())
            and gdet.num_clusters == k
            and np.array_equal(gdet.cluster_class[:k], ref.obj_cls[:k].argmax(-1).cpu().numpy()))
    if not same:
        raise AssertionError(f"{tag}: the captured detector's decisions differ from the eager "
                             f"deploy's")
    return max(float((cap[f] - getattr(ref, f)).abs().max())
               for f in ("node_cls", "node_offsets", "edge_cls", "obj_cls", "centers"))


def log_captured_forward(torch, tag: str, det, graph_np, graph, rounds: int) -> None:
    """Profiles of one frame: the detector's forward (its arrays copied
    into the graph's buffers, one replay: exactly one host launch), the
    eager deploy of the same graph, and the whole ``detect`` path's."""
    fwd = profile_run(lambda: det.forward(graph_np))
    with torch.no_grad():
        eager = profile_run(lambda: det.model.deploy(graph, eps=det.eps))
    log(f"{tag} profile of the captured forward of one frame: {json.dumps(fwd)}")
    log(f"{tag} profile of the eager deploy forward of the same frame: {json.dumps(eager)}")
    log(f"{tag} a frame's forward: {fwd['host_launches']} host launch (the graph) and "
        f"{fwd['host_copies']} host copies (the padded arrays), {fwd['device_kernels']} device "
        f"kernels ({rounds} rounds), busy "
        f"{fwd['device_busy_ms']:.3f} ms, idle {fwd['device_idle_share']:.3f}; eager: "
        f"{eager['host_launches']} host launches, {eager['device_kernels']} kernels, idle "
        f"{eager['device_idle_share']:.3f}")
    if fwd["host_launches"] != 1 or not fwd["device_kernels"]:
        raise AssertionError(f"{tag} the captured forward is not one host launch of device work")


def check_nan_skip(torch, state, step, batch, tag: str) -> None:
    """A NaN-poisoned batch through ``step`` (a replay of the captured
    step): skipped = 1, and the parameters, every moment of the optimiser
    and the update count bitwise unchanged; the step count advances."""
    before = [t.clone() for t in (state.optimizer.flat, *state.optimizer.moments.values())]
    step_no, updates = state.step, state.updates
    state, m = step(state, _poisoned(batch))
    same = all(torch.equal(a, b) for a, b in zip(
        before, (state.optimizer.flat, *state.optimizer.moments.values())))
    log(f"[{tag}] NaN-poisoned batch: skipped={float(m['skipped'])}, params and "
        f"optimiser state ({', '.join(state.optimizer.moments)}) bit-identical={same}, "
        f"updates {updates} -> {state.updates}, steps {step_no} -> {state.step}")
    if (float(m["skipped"]) != 1.0 or not same or state.updates != updates
            or state.step != step_no + 1):
        raise AssertionError("the NaN skip changed the state")


def _poisoned(batch):
    import dataclasses

    node_feat = batch.graph.node_feat.copy()
    node_feat[0, 0, 0] = np.nan
    return dataclasses.replace(
        batch, graph=dataclasses.replace(batch.graph, node_feat=node_feat))


def step_runs(step) -> int:
    """How often a train step's body ran on the card: each replay of its
    CUDA graphs and each warm-up run of a capture (``CapturedStep``).  Every
    run launches each message kernel once a round, for the whole batch."""
    c = step.captured
    return c.replays + c.warmups


def per_replay(step) -> dict:
    """The launches a replay of each of the step's CUDA graphs adds, by
    counter (what the capture recorded)."""
    return [{n: d for n, d in e.launches.items() if d} for e in step.captured.graphs.values()]


def check_captured(torch, cfg, batches, state, metrics, tag: str, close,
                   mp_impl=None, mp_bf16=False) -> None:
    """The captured steps (``state`` after them and their ``metrics``)
    against the same steps run eagerly on the card from the same seed: the
    batched step (``make_loss_fn``: one model call a batch) and the
    per-graph step (``per_graph_loss_sums``: one model call a graph), each
    within ``close`` (metrics) and PARAM_* (params)."""
    from graph_neural_network_for_radar_perception_torch.train import steps as S
    from graph_neural_network_for_radar_perception_torch.train.loss import reduce_loss_sums, tree_sum

    def per_graph(model, batch):
        sums = S.per_graph_loss_sums(model, batch, cfg, mp_impl=mp_impl, mp_bf16=mp_bf16)
        return reduce_loss_sums(tree_sum(sums), cfg)

    for name, loss_fn in (("eager batched step", S.make_loss_fn(cfg, mp_impl, mp_bf16)),
                          ("eager per-graph step", per_graph)):
        st, ms = S.create_train_state(cfg, torch.Generator().manual_seed(0), device="cuda"), []
        for batch in batches:
            m = S._train_body(st, S.batch_on(batch, st.device), loss_fn, cfg)
            ms.append({k: float(v) for k, v in m.items()})
        m_err = close(metrics, ms, f"{tag} captured vs {name}")
        p_err = _params_close(state.model.state_dict(), st.model.state_dict(),
                              f"{tag} captured vs {name}")
        log(f"[{tag}] the captured steps against the {name} on the card: metrics max "
            f"abs err {m_err:.3e}, params {p_err:.3e} (rtol={PARAM_RTOL}, atol={PARAM_ATOL})")


def phase_train(torch, FM):
    """Phase 5: the training path on the card, against a CPU replay."""
    from graph_neural_network_for_radar_perception_torch.config.config import GNNConfig
    from graph_neural_network_for_radar_perception_torch.data.pipeline import SyntheticRadarDataset
    from graph_neural_network_for_radar_perception_torch.train import steps as S
    from graph_neural_network_for_radar_perception_torch.train.trainer import TrainHooks, train

    cfg = GNNConfig()  # shipped widths, batch_size 8, SGD defaults
    rounds, bsz = len(cfg.graph_convolution_stem_channels), cfg.batch_size
    gen = SyntheticRadarDataset(cfg, seed=3, num_objects=(6, 10)).batches(bsz)
    batches = [next(gen) for _ in range(TRAIN_STEPS)]
    live = [int(b.graph.edge_mask.sum()) for b in batches]
    log(f"[train] GNNConfig() batch {bsz}, {TRAIN_STEPS} steps; live edges per "
        f"batch {live} of {bsz * cfg.max_edges}")

    state = S.create_train_state(cfg, torch.Generator().manual_seed(0), device="cuda")
    step, card_metrics = S.make_train_step(cfg), []

    def recording_step(st, batch):
        st, m = step(st, batch)
        card_metrics.append({k: float(v) for k, v in m.items()})
        return st, m

    FM.fused_message_pass.launches = 0
    FM.fused_message_pass_backward.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state = train(cfg, iter(batches), state=state, train_step=recording_step,
                  max_iters=TRAIN_STEPS,
                  hooks=TrainHooks(log_period=1, val_period=10**9, print_fn=log))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    fwd, bwd = FM.fused_message_pass.launches, FM.fused_message_pass_backward.launches
    runs = step_runs(step)
    want = rounds * runs
    log(f"[train] trainer.train on the card: launches forward={fwd} backward={bwd}, "
        f"one a round for the batch of {bsz} (expected {rounds} x ({step.captured.replays} "
        f"replays + {step.captured.warmups} warm-up runs of the capture) = {want}; a replay "
        f"adds {json.dumps(per_replay(step))}), skipped="
        f"{[m['skipped'] for m in card_metrics]}, {wall:.2f} s incl. capture; the warm-up "
        f"ran under sync debug mode 'error' (no device-to-host sync)")
    if (fwd != want or bwd != want or step.captured.replays != TRAIN_STEPS
            or any(m["skipped"] for m in card_metrics)):
        raise AssertionError("the train path did not run both kernels once per round a step")

    t0 = time.perf_counter()
    cpu = S.create_train_state(cfg, torch.Generator().manual_seed(0), device="cpu")
    cpu_step = S.make_train_step(cfg)
    worst = {}
    for i, batch in enumerate(batches):
        cpu, m = cpu_step(cpu, batch)
        for k, v in m.items():
            err = abs(card_metrics[i][k] - float(v))
            worst[k] = max(worst.get(k, 0.0), err)
            if err > METRIC_ATOL + METRIC_RTOL * abs(float(v)):
                raise AssertionError(f"step {i}: metric {k} card {card_metrics[i][k]} cpu {float(v)}")
    log(f"[train] CPU replay at batch {bsz}, {TRAIN_STEPS} steps, full width "
        f"({time.perf_counter() - t0:.1f} s): metrics within rtol={METRIC_RTOL} "
        f"atol={METRIC_ATOL}, max abs err {json.dumps(worst)}")
    perr, cpu_params = 0.0, cpu.model.state_dict()
    for k, v in state.model.state_dict().items():
        err = (v.cpu() - cpu_params[k]).abs()
        perr = max(perr, float(err.max()))
        if (err > PARAM_ATOL + PARAM_RTOL * cpu_params[k].abs()).any():
            raise AssertionError(f"params {k} differ after {TRAIN_STEPS} steps")
    log(f"[train] params after {TRAIN_STEPS} steps: card vs CPU max abs err "
        f"{perr:.3e} (rtol={PARAM_RTOL}, atol={PARAM_ATOL}); loss "
        f"{card_metrics[0]['loss_total']:.4f} -> {card_metrics[-1]['loss_total']:.4f}")
    check_captured(torch, cfg, batches, state, card_metrics, "train", _metrics_close)
    check_nan_skip(torch, state, step, batches[0], "train")

    step_ms = []
    for i in range(TIMED_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, m = step(state, batches[i % len(batches)])
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
    timed = step_ms[2:]
    log(f"[train] ms/step (numpy batch in, synchronised; median of {len(timed)} "
        f"after 2 warm-up): {np.median(timed):.3f} (min {min(timed):.3f}, max "
        f"{max(timed):.3f})")
    prof = profile_run(lambda: step(state, batches[0]))
    log(f"[train] profile of one train step: {json.dumps(prof)}")
    log_step_summary("train", timed, prof)
    if not prof["device_kernels"]:
        raise AssertionError("the profiler saw no kernel on the card")
    return fwd, bwd, card_metrics


def log_step_summary(tag: str, timed_ms, prof) -> None:
    """ms per step, kernels and host launches per step, busy share."""
    log(f"[{tag}] per step: {np.median(timed_ms):.3f} ms (median), "
        f"{prof['device_kernels']} device kernels, {prof['host_launches']} host "
        f"launches, device busy {prof['device_busy_ms']:.3f} ms = "
        f"{1 - prof['device_idle_share']:.3f} of the profiled step's wall time")


def _params_close(a: dict, b: dict, what: str) -> float:
    """Max abs difference of two state dicts; raises beyond PARAM_*."""
    worst = 0.0
    for k, v in a.items():
        w = b[k].to(v.device)
        err = (v - w).abs()
        worst = max(worst, float(err.max()))
        if (err > PARAM_ATOL + PARAM_RTOL * w.abs()).any():
            raise AssertionError(f"{what}: params {k} differ")
    return worst


def _metrics_close(a: list, b: list, what: str) -> float:
    """Max abs difference of per-step metrics; raises beyond METRIC_*."""
    worst = 0.0
    for i, (ma, mb) in enumerate(zip(a, b)):
        for k, v in mb.items():
            err = abs(ma[k] - v)
            worst = max(worst, err)
            if err > METRIC_ATOL + METRIC_RTOL * abs(v):
                raise AssertionError(f"{what}: step {i} metric {k} {ma[k]} vs {v}")
    return worst


def phase_train_csr(torch, FM, C):
    """Phase 8: the training path with mp_impl="csr" on the card, against a
    CPU replay and against the default message pass on the card."""
    import dataclasses

    from graph_neural_network_for_radar_perception_torch.config.config import GNNConfig
    from graph_neural_network_for_radar_perception_torch.data.pipeline import SyntheticRadarDataset
    from graph_neural_network_for_radar_perception_torch.train import steps as S
    from graph_neural_network_for_radar_perception_torch.train.trainer import TrainHooks, train

    cfg = GNNConfig(mp_impl="csr")  # shipped widths, csr tile 512, window 256
    rounds, bsz = len(cfg.graph_convolution_stem_channels), cfg.batch_size
    # The [train] phase's batches, built under this config: pad_frame
    # checks the CSR contract on every frame.
    gen = SyntheticRadarDataset(cfg, seed=3, num_objects=(6, 10)).batches(bsz)
    batches = [next(gen) for _ in range(TRAIN_STEPS)]
    log(f"[train-csr] GNNConfig(mp_impl='csr') batch {bsz}, {TRAIN_STEPS} steps; "
        f"live edges per batch {[int(b.graph.edge_mask.sum()) for b in batches]}")

    def run(device, mp_impl=None, steps=TRAIN_STEPS):
        state = S.create_train_state(cfg, torch.Generator().manual_seed(0), device=device)
        step, metrics = S.make_train_step(cfg, mp_impl), []
        for batch in batches[:steps]:
            state, m = step(state, batch)
            metrics.append({k: float(v) for k, v in m.items()})
        return state, metrics

    state = S.create_train_state(cfg, torch.Generator().manual_seed(0), device="cuda")
    step, card_metrics = S.make_train_step(cfg), []

    def recording_step(st, batch):
        st, m = step(st, batch)
        card_metrics.append({k: float(v) for k, v in m.items()})
        return st, m

    counters = (FM.fused_message_pass, FM.fused_message_pass_backward,
                C.fused_message_pass_csr, C.fused_message_pass_csr_backward)
    for c in counters:
        c.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state = train(cfg, iter(batches), state=state, train_step=recording_step,
                  max_iters=TRAIN_STEPS,
                  hooks=TrainHooks(log_period=1, val_period=10**9, print_fn=log))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    fused_fwd, fused_bwd, fwd, bwd = (c.launches for c in counters)
    want = rounds * step_runs(step)
    log(f"[train-csr] trainer.train on the card: CSR launches forward={fwd} "
        f"backward={bwd}, one a round for the batch of {bsz} (expected {rounds} x "
        f"({step.captured.replays} replays + {step.captured.warmups} warm-up runs) = "
        f"{want}; a replay adds {json.dumps(per_replay(step))}), fused_mp launches "
        f"{fused_fwd}/{fused_bwd} (expected 0), skipped="
        f"{[m['skipped'] for m in card_metrics]}, {wall:.2f} s incl. capture")
    if (fwd, bwd, fused_fwd, fused_bwd) != (want, want, 0, 0) or any(
            m["skipped"] for m in card_metrics) or step.captured.replays != TRAIN_STEPS:
        raise AssertionError("the CSR train path did not run its kernels once per round a step")

    t0 = time.perf_counter()
    cpu, cpu_metrics = run("cpu")
    m_err = _metrics_close(card_metrics, cpu_metrics, "CSR card vs CPU")
    p_err = _params_close(state.model.state_dict(), cpu.model.state_dict(), "CSR card vs CPU")
    log(f"[train-csr] CPU replay ({time.perf_counter() - t0:.1f} s): metrics max abs "
        f"err {m_err:.3e} (rtol={METRIC_RTOL}, atol={METRIC_ATOL}), params "
        f"{p_err:.3e} (rtol={PARAM_RTOL}, atol={PARAM_ATOL}); loss "
        f"{card_metrics[0]['loss_total']:.4f} -> {card_metrics[-1]['loss_total']:.4f}")
    onehot, onehot_metrics = run("cuda", mp_impl="onehot")
    m_err = _metrics_close(card_metrics, onehot_metrics, "CSR vs onehot")
    p_err = _params_close(state.model.state_dict(), onehot.model.state_dict(), "CSR vs onehot")
    log(f"[train-csr] the same steps with mp_impl='onehot' on the card: metrics "
        f"max abs err {m_err:.3e}, params {p_err:.3e} (two kernels, one function)")
    check_captured(torch, cfg, batches, state, card_metrics, "train-csr", _metrics_close)
    check_nan_skip(torch, state, step, batches[0], "train-csr")

    narrow = dataclasses.replace(cfg, csr_window=16)  # below every tile's span
    bad = S.create_train_state(narrow, device="cuda")
    bad.model.load_state_dict(state.model.state_dict())
    bad, m = S.make_train_step(narrow)(bad, batches[0])
    log(f"[train-csr] csr_window=16 (window violated): skipped={float(m['skipped'])}, "
        f"loss {float(m['loss_total'])}, updates {bad.updates}")
    if float(m["skipped"]) != 1.0 or bad.updates != 0:
        raise AssertionError("a window violation did not skip the step")

    step_ms = []
    for i in range(TIMED_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, m = step(state, batches[i % len(batches)])
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
    timed = step_ms[2:]
    log(f"[train-csr] ms/step (numpy batch in, synchronised; median of {len(timed)} "
        f"after 2 warm-up): {np.median(timed):.3f} (min {min(timed):.3f}, max "
        f"{max(timed):.3f})")
    prof = profile_run(lambda: step(state, batches[0]))
    log(f"[train-csr] profile of one train step: {json.dumps(prof)}")
    log_step_summary("train-csr", timed, prof)
    if not prof["device_kernels"]:
        raise AssertionError("the profiler saw no kernel on the card")
    return fwd, bwd


def phase_deploy_csr(torch, FM, C):
    """Phase 9: FrameDetector with mp_impl="csr" on the card against the
    same weights through the default message pass on the card."""
    from graph_neural_network_for_radar_perception_torch.config.config import GNNConfig
    from graph_neural_network_for_radar_perception_torch.core.graph import RadarGraph
    from graph_neural_network_for_radar_perception_torch.data.pipeline import pad_frame, preprocess_frame
    from graph_neural_network_for_radar_perception_torch.infer.pipeline import FrameDetector
    from graph_neural_network_for_radar_perception_torch.models.gnn import RadarGNN

    cfg, cfg_csr = GNNConfig(), GNNConfig(mp_impl="csr")
    state = RadarGNN(cfg, generator=torch.Generator().manual_seed(0)).state_dict()
    det = {"csr": FrameDetector(cfg_csr, state, device="cuda"),
           "onehot": FrameDetector(cfg, state, device="cuda")}
    frames = deploy_frames(cfg, NUM_CSR_FRAMES)  # the [deploy] phase's first frames
    for c in (FM.fused_message_pass, C.fused_message_pass_csr):
        c.launches = 0
    det["csr"].detect(frames[0])  # capture (two warm-up runs) and a replay: untimed
    torch.cuda.synchronize()
    dets, frame_ms = [], []
    for data in frames:
        t0 = time.perf_counter()
        dets.append(det["csr"].detect(data))
        torch.cuda.synchronize()
        frame_ms.append((time.perf_counter() - t0) * 1e3)
    launches, fused = C.fused_message_pass_csr.launches, FM.fused_message_pass.launches
    rounds = len(cfg.graph_convolution_stem_channels)
    n_run = sum(d is not None for d in dets)
    cap = det["csr"].captured
    want = rounds * detector_runs(det["csr"])
    log(f"[deploy-csr] {n_run} frames (+1 warm-up) through the captured detector: "
        f"{len(cap.graphs)} capture, {cap.replays} replays, {cap.warmups} warm-up runs; "
        f"fused_message_pass_csr launches={launches} (expected {rounds} x ({cap.replays} + "
        f"{cap.warmups}) = {want}), fused_message_pass launches={fused} "
        f"(expected 0); detect ms/frame median {np.median(frame_ms):.3f} "
        f"(min {min(frame_ms):.3f}, max {max(frame_ms):.3f})")
    if (n_run < 4 or launches != want or fused or len(cap.graphs) != 1
            or cap.replays != n_run + 1):
        raise AssertionError("the CSR deploy path did not replay one captured graph a frame, "
                             "its kernel once a round")

    worst, eager_diff = {}, 0.0
    for i, (data, gdet) in enumerate(zip(frames, dets)):
        odet = det["onehot"].detect(data)
        fr = preprocess_frame(data, cfg_csr)
        graph_np, _ = pad_frame(fr, cfg_csr)
        with torch.no_grad():
            outs = {k: d.model.deploy(RadarGraph.from_numpy(graph_np, "cuda"))
                    for k, d in det.items()}
        for field, rows in (("node_cls", graph_np.node_mask),
                            ("node_offsets", graph_np.node_mask),
                            ("edge_cls", graph_np.und_mask),
                            ("centers", graph_np.node_mask)):
            a = getattr(outs["csr"], field).cpu().numpy()[rows]
            b = getattr(outs["onehot"], field).cpu().numpy()[rows]
            if a.shape != b.shape or not np.isfinite(a).all():
                raise AssertionError(f"frame {i}: {field} malformed")
            err = np.abs(a - b)
            worst[field] = max(worst.get(field, 0.0), float(err.max()))
            if (err > DEPLOY_ATOL + DEPLOY_RTOL * np.abs(b)).any():
                raise AssertionError(f"frame {i}: {field} csr vs onehot beyond tolerance")
        rep = compare_decisions(gdet, odet, outs["onehot"].node_cls.cpu().numpy()[: fr.n],
                                outs["onehot"].obj_cls.cpu().numpy(), det["csr"].eps)
        eager_diff = max(eager_diff, captured_vs_eager(torch, det["csr"], graph_np, gdet,
                                                       f"[deploy-csr] frame {i}"))
        log(f"[deploy-csr] frame {i}: n={fr.n} edges={fr.senders.shape[0]} "
            f"clusters={gdet.num_clusters} csr vs onehot {json.dumps(rep)}")
    log(f"[deploy-csr] csr vs onehot max abs err: {json.dumps(worst)} "
        f"(rtol={DEPLOY_RTOL}, atol={DEPLOY_ATOL})")
    log(f"[deploy-csr] the captured CSR detector against the eager CSR deploy on the card, "
        f"every frame: decisions bit for bit; outputs max abs diff {eager_diff!r} "
        f"({'bitwise' if eager_diff == 0 else 'not bitwise'})")
    log_captured_forward(torch, "[deploy-csr]", det["csr"], graph_np,
                         RadarGraph.from_numpy(graph_np, "cuda"), rounds)
    return launches


def bf16_verdict(torch, got, f32, want, what: str):
    """The bf16 kernel's output ``got`` against the plain bf16 version
    ``want``: within the bf16 tolerance but for a few flipped roundings
    (BF16_FLIP_SHARE, each within 2^-7 of max |want|); and the f32 kernel's
    output ``f32`` clearly outside it (the rounding shows).  Returns (max abs
    err, elements outside the tolerance, the f32 output's worst multiple of
    the tolerance, the f32 output's elements outside it)."""
    tol = BF16_ATOL + BF16_RTOL * want.abs()
    err = (got - want).abs()
    bad = int((err > tol).sum())
    allowed = max(4, int(BF16_FLIP_SHARE * want.numel()))
    flip = 2.0 ** -7 * float(want.abs().max())
    f32_ratio = float(((f32 - want).abs() / tol).max())
    f32_out = int(((f32 - want).abs() > tol).sum())
    if bad > allowed or bool((err > tol + flip).any()) or not torch.isfinite(got).all():
        raise AssertionError(
            f"{what}: {bad} elements (at most {allowed} allowed) outside rtol="
            f"{BF16_RTOL} atol={BF16_ATOL} of the plain bf16 version, max abs err "
            f"{float(err.max()):.3e} (a flip moves at most {flip:.3e})")
    if f32_ratio < BF16_SEPARATION or f32_out < 10 * allowed:
        raise AssertionError(
            f"{what}: the f32 kernel lies within {f32_ratio:.2f} tolerances of the "
            f"plain bf16 version ({f32_out} elements outside): no rounding shows")
    return float(err.max()), bad, f32_ratio, f32_out


def phase_kernel_bf16(torch, FM):
    """Phase 10: the fused forward's bf16 instantiation against its plain
    bf16 version, and timing; returns its table row."""
    rng = np.random.default_rng(10)
    max_err = 0.0
    for name, args in fused_problems(torch, rng):
        got = FM.fused_message_pass(*args, 0.01, True)
        again = FM.fused_message_pass(*args, 0.01, True)
        f32 = FM.fused_message_pass(*args, 0.01)
        torch.cuda.synchronize()
        want = FM.fused_message_pass_reference(*args, 0.01, bf16=True)
        err, bad, ratio, n_out = bf16_verdict(torch, got, f32, want, "fused_message_pass bf16")
        same = bool(torch.equal(got, again))
        max_err = max(max_err, err)
        log(f"[kernel-bf16] {name} ({plan_of(FM, args, True)}): max_abs_err={err:.3e}, "
            f"violations(rtol={BF16_RTOL}, atol={BF16_ATOL})={bad} (flipped roundings); "
            f"the f32 kernel lies up to {ratio:.1f} tolerances away ({n_out} of "
            f"{want.numel()} elements outside); two launches bitwise equal={same}")
        if not same:
            raise AssertionError("the fused bf16 forward is not deterministic")

    args = kernel_problem(torch, rng, 9216, E)
    r = args[3]
    raw, alive = fused_fwd_raw(torch, FM, args, torch.empty(N, D2, device="cuda"))
    fn = FM._kernel(True)
    kernel_ms = event_ms(lambda: fn(*raw))
    f32_ms = event_ms(lambda: FM._kernel(False)(*raw))
    wrapper_ms = event_ms(lambda: FM.fused_message_pass(*args, 0.01, True,
                                                         layout=alive[-1]))
    plain_ms = event_ms(lambda: FM.fused_message_pass_reference(
        *args, 0.01, bf16=True))

    # Least time for the same work on bf16 tensor cores: the products of the
    # edges whose messages land, and what they need read / written once
    # (as the f32 row).
    e_live = int(((r >= 0) & (r < N)).sum())
    flops = 2 * e_live * (DE * H + H * D2)
    nbytes = fused_fwd_bytes(E, e_live)
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES_PER_S
    bound = max(t_ops, t_bytes) * 1e3
    f32_bound = max(flops / PEAK_F32_FLOPS, t_bytes) * 1e3
    log_product_yardstick(torch, "[kernel-bf16]", args[1][(r >= 0) & (r < N)],
                          args[4][2 * D:], args[6])
    log(f"[kernel-bf16] timing E={E} live={e_live}: bf16 kernel {kernel_ms * 1e3:.2f} us "
        f"= {kernel_ms / bound:.1f}x its bound; its f32 twin on the same inputs "
        f"{f32_ms * 1e3:.2f} us = {f32_ms / f32_bound:.1f}x its bound "
        f"({f32_bound * 1e3:.2f} us); wrapper "
        f"{wrapper_ms * 1e3:.2f} us, plain {plain_ms * 1e3:.2f} us; bound "
        f"{bound * 1e3:.2f} us ({flops / 1e9:.3f} GFLOP at bf16 peak, "
        f"{nbytes / 1e6:.2f} MB); {plan_of(FM, args, True)}")
    return {
        "name": "fused_message_pass_bf16",
        "route": "cuda",
        "source": "graph_neural_network_for_radar_perception_torch/csrc/fused_mp.cu",
        "replaces": "graph_neural_network_for_radar_perception_tpu/ops/pallas/fused_mp.py:82",
        "launches": None,
        "max_abs_err": max_err,
        "ms": kernel_ms,
        "plain_ms": plain_ms,
        "wrapper_ms": wrapper_ms,
        "f32_kernel_ms": f32_ms,
        "f32_bound_ms": f32_bound,
        "bound_ms": bound,
        "bound_by": "operations" if t_ops >= t_bytes else "bytes",
        "library_ms": None,
    }


def log_product_yardstick(torch, tag: str, ef_live, w1e, w2) -> float:
    """The two edge products alone as ``torch.matmul`` in bf16 over the
    live edges' rows ``ef_live`` (ef . W1e, then a bf16 [E_live, H]
    operand . W2; cuBLAS, f32 accumulation): a yardstick of the product
    time beside a bf16 forward, not the same function (no gather, norm or
    sum).  Returns its device ms."""
    a = ef_live.to(torch.bfloat16)
    m = torch.randn(a.shape[0], w1e.shape[1], device=a.device).to(torch.bfloat16)
    wa, wb = w1e.to(torch.bfloat16), w2.to(torch.bfloat16)
    ms = event_ms(lambda: (a @ wa, m @ wb))
    device_ms = graph_ms(lambda: (a @ wa, m @ wb))
    log(f"{tag} yardstick: the two edge products as torch.matmul in bf16 over "
        f"{a.shape[0]} live edges: {device_ms * 1e3:.2f} us of device time (replays "
        f"of a captured CUDA graph), {ms * 1e3:.2f} us a call (CUDA events; the two "
        f"dispatches' host time where it exceeds the device's)")
    return device_ms


def phase_kernel_csr_bf16(torch, C):
    """Phase 11: the CSR forward's bf16 instantiation against its plain bf16
    version on the [kernel-csr] graphs, two launches bitwise, timing;
    returns its table row."""
    rng = np.random.default_rng(12)
    max_err = 0.0
    for name, args, src_window in csr_fwd_problems(torch, rng):
        with torch.no_grad():
            got = C.fused_message_pass_csr(*args, 0.01, CSR_TILE, CSR_WINDOW, True, src_window)
            again = C.fused_message_pass_csr(*args, 0.01, CSR_TILE, CSR_WINDOW, True, src_window)
            f32 = C.fused_message_pass_csr(*args, 0.01, CSR_TILE, CSR_WINDOW, False, src_window)
        torch.cuda.synchronize()
        want = C.fused_message_pass_csr_reference(
            *args, 0.01, CSR_TILE, CSR_WINDOW, src_window, True)
        err, bad, ratio, n_out = bf16_verdict(
            torch, got, f32, want, f"fused_message_pass_csr bf16 {name}")
        same = bool(torch.equal(got, again))
        max_err = max(max_err, err)
        log(f"[kernel-csr-bf16] {name} E={args[2].shape[0]} src_window={src_window} "
            f"({csr_plan_of(C, args, True)}): "
            f"max_abs_err={err:.3e}, violations(rtol={BF16_RTOL}, atol={BF16_ATOL})="
            f"{bad} (flipped roundings); the f32 kernel lies up to {ratio:.1f} "
            f"tolerances away ({n_out} elements outside); two launches bitwise "
            f"equal={same}")
        if not same:
            raise AssertionError("the CSR bf16 forward is not deterministic")

    _, args, _ = csr_problems(torch, np.random.default_rng(5))[0]
    layout = C.csr_layout(args[2], args[3], N, CSR_TILE, CSR_WINDOW, 0)
    raw, alive = csr_fwd_raw(torch, C, args, layout)
    fn = C._kernel(True)
    kernel_ms = event_ms(lambda: fn(*raw))
    f32_ms = event_ms(lambda: C._kernel(False)(*raw))
    with torch.no_grad():
        wrapper_ms = event_ms(lambda: C.fused_message_pass_csr(
            *args, 0.01, CSR_TILE, CSR_WINDOW, True, layout=layout))
    plain_ms = event_ms(lambda: C.fused_message_pass_csr_reference(
        *args, 0.01, CSR_TILE, CSR_WINDOW, 0, True))
    e_live = int((layout.dst < N).sum())
    flops = 2 * 2 * N * D * H + 2 * e_live * (DE * H + H * D2)
    nbytes = csr_fwd_bytes(e_live)
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES_PER_S
    bound = max(t_ops, t_bytes) * 1e3
    f32_bound = max(flops / PEAK_F32_FLOPS, t_bytes) * 1e3
    log_product_yardstick(torch, "[kernel-csr-bf16]", args[1][layout.dst < N],
                          args[4][2 * D:], args[6])
    log(f"[kernel-csr-bf16] timing E={E} live={e_live}: bf16 kernel {kernel_ms * 1e3:.2f} us "
        f"= {kernel_ms / bound:.1f}x its bound; its f32 twin on the same inputs "
        f"{f32_ms * 1e3:.2f} us = {f32_ms / f32_bound:.1f}x its bound "
        f"({f32_bound * 1e3:.2f} us); wrapper "
        f"{wrapper_ms * 1e3:.2f} us, plain {plain_ms * 1e3:.2f} us; bound "
        f"{bound * 1e3:.2f} us ({flops / 1e9:.3f} GFLOP at bf16 peak, "
        f"{nbytes / 1e6:.2f} MB); {csr_plan_of(C, args, True)}")
    return {
        "name": "fused_message_pass_csr_bf16",
        "route": "cuda",
        "source": "graph_neural_network_for_radar_perception_torch/csrc/csr_mp.cu",
        "replaces": "graph_neural_network_for_radar_perception_tpu/ops/pallas/csr_mp.py:234",
        "launches": None,
        "max_abs_err": max_err,
        "ms": kernel_ms,
        "plain_ms": plain_ms,
        "wrapper_ms": wrapper_ms,
        "f32_kernel_ms": f32_ms,
        "f32_bound_ms": f32_bound,
        "bound_ms": bound,
        "bound_by": "operations" if t_ops >= t_bytes else "bytes",
        "library_ms": None,
    }


def phase_microbench(torch, floor_lib: str):
    """Phase 12: the gather and scatter kernels against their plain
    versions with indices outside [0, N), the gather also at odd shapes
    (not counted), then the microbenchmark's own path with both counts from
    0, and the gather's launch floor (``floor_lib``: the gather ablation's
    ``empty`` build) in a process of its own; returns the two table rows."""
    from graph_neural_network_for_radar_perception_torch.scripts import gather_ablation as GA
    from graph_neural_network_for_radar_perception_torch.scripts import microbench_gather as MB

    rng = np.random.default_rng(13)
    m = MB.TILES * MB.TE
    idx = rng.integers(0, MB.N, m).astype(np.int32)
    bad = rng.random(m) < 0.05
    idx[bad] = rng.choice(np.array([-1, -100, MB.N, MB.N + 7, 2**31 - 1]), int(bad.sum()))
    dev = torch.device("cuda")
    idx_c = torch.from_numpy(idx).to(dev)
    tab = torch.from_numpy(rng.normal(size=(MB.N, MB.D)).astype(np.float32)).to(dev)
    msg = torch.from_numpy(rng.normal(size=(m, MB.D)).astype(np.float32)).to(dev)
    got_g, got_s = MB.gather_rows(tab, idx_c), MB.scatter_add_rows(msg, idx_c, MB.N)
    again_s = MB.scatter_add_rows(msg, idx_c, MB.N)
    torch.cuda.synchronize()
    want_g = MB.gather_rows_reference(tab, idx_c)
    want_s = MB.scatter_add_rows_reference(msg, idx_c, MB.N)
    err_s = (got_s - want_s).abs()
    bad_s = int((err_s > MB.SCATTER_TOL["atol"] + MB.SCATTER_TOL["rtol"] * want_s.abs()).sum())
    same_g = bool(torch.equal(got_g, want_g))
    # np.add.at adds each row's messages in index order, as the kernel does:
    # the same bits (the plain version's index_add_ on the card uses atomics).
    keep = (idx >= 0) & (idx < MB.N)
    add_at = np.zeros((MB.N, MB.D), np.float32)
    np.add.at(add_at, idx[keep], msg.cpu().numpy()[keep])
    exact_s = bool(np.array_equal(got_s.cpu().numpy(), add_at))
    same_s = bool(torch.equal(got_s, again_s))
    log(f"[kernel-gather] {m} indices ({int(bad.sum())} outside [0, {MB.N})): kernel "
        f"bitwise equal to plain={same_g}")
    log(f"[kernel-scatter] {m} messages ({int(bad.sum())} dropped): max_abs_err="
        f"{float(err_s.max()):.3e} violations({json.dumps(MB.SCATTER_TOL)})={bad_s}; "
        f"bitwise equal to np.add.at={exact_s}; two launches bitwise equal={same_s}")
    if not same_g or bad_s:
        raise AssertionError("a microbenchmark kernel disagrees with its plain version")
    if not exact_s or not same_s:
        raise AssertionError("scatter_add_rows is not np.add.at's sum, bit for bit, "
                             "on every launch")
    # The gather where its runs and pieces are ragged: no rows, a count that
    # is no multiple of a warp's rows, rows of 4 and of 1024 floats.
    for n, d, rows in ((MB.N, MB.D, 0), (MB.N, MB.D, m + 1), (MB.N, 4, m), (50, 1024, 3000)):
        i = rng.integers(-2, n + 2, rows).astype(np.int32)
        t_np = rng.normal(size=(n, d)).astype(np.float32)
        keep = (i >= 0) & (i < n)
        want = np.where(keep[:, None], t_np[np.where(keep, i, 0)], np.float32(0))
        t_c, i_c = torch.from_numpy(t_np).to(dev), torch.from_numpy(i).to(dev)
        got, again = MB.gather_rows(t_c, i_c), MB.gather_rows(t_c, i_c)
        torch.cuda.synchronize()
        ok = np.array_equal(got.cpu().numpy(), want) and bool(torch.equal(got, again))
        log(f"[kernel-gather] N={n} D={d} M={rows} ({int((~keep).sum())} outside [0, N)): "
            f"bitwise numpy indexing and across two launches={ok}")
        if not ok:
            raise AssertionError("gather_rows is not numpy indexing on every launch")

    MB.gather_rows.launches = 0
    MB.scatter_add_rows.launches = 0
    res = MB.run()
    launches = (MB.gather_rows.launches, MB.scatter_add_rows.launches)
    log(f"[kernel-gather] microbenchmark (scripts/microbench_gather.run, launches "
        f"{launches[0]} issued from the host, a graph's captured calls once and its "
        f"replays not; ms, plain_ms, library_ms replayed from a CUDA graph, "
        f"*launch_ms issued back to back): {json.dumps(res['gather'])}")
    log(f"[kernel-scatter] microbenchmark (launches {launches[1]}): "
        f"{json.dumps(res['scatter'])}; {res['bytes'] / 1e6:.3f} MB moved each")
    floor = GA.run_one("empty", floor_lib)
    if "error" in floor:
        raise AssertionError(f"the gather's launch floor did not run: {floor['error']}")
    g = res["gather"]
    log(f"[kernel-gather] launch floor (an empty kernel on gather_rows' grid, replayed "
        f"from a CUDA graph, own process): {floor['ms'] * 1e3:.3f} us; gather_rows "
        f"{g['ms'] * 1e3:.3f} us = floor + {(g['ms'] - floor['ms']) * 1e3:.3f} us; bound "
        f"{g['bound_ms'] * 1e3:.3f} us ({g['ms'] / g['bound_ms']:.2f}x); index_select "
        f"{g['library_ms'] * 1e3:.3f} us")
    res["gather"]["launch_floor_ms"] = floor["ms"]
    rows = []
    for (name, key, line), n in zip(
            (("gather_rows", "gather", 69), ("scatter_add_rows", "scatter", 128)), launches):
        r = res[key]
        rows.append({
            "name": name, "route": "cuda",
            "source": "graph_neural_network_for_radar_perception_torch/csrc/microbench_gather.cu",
            "replaces": f"scripts/microbench_gather.py:{line}",
            "launches": n, "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"], "bound_by": "bytes",
            "library_ms": r["library_ms"], "launch_ms": r["launch_ms"],
            "wrapper_ms": r["wrapper_ms"], "library_launch_ms": r["library_launch_ms"],
            "deterministic": r["deterministic"],
            **({"launch_floor_ms": r["launch_floor_ms"]} if "launch_floor_ms" in r else {}),
        })
    if min(launches) < 1:
        raise AssertionError("the microbenchmark did not launch both kernels")
    return rows


def _bf16_metrics_close(a: list, b: list, what: str) -> float:
    """Max abs difference of per-step losses; raises beyond the bf16
    tolerance (accuracies beyond ACC_ATOL)."""
    worst = 0.0
    for i, (ma, mb) in enumerate(zip(a, b)):
        for k, v in mb.items():
            err = abs(ma[k] - v)
            if k.startswith("loss_"):
                worst = max(worst, err)
                ok = err <= BF16_ATOL + BF16_RTOL * abs(v)
            else:
                ok = err <= ACC_ATOL
            if not ok:
                raise AssertionError(f"{what}: step {i} metric {k} {ma[k]} vs {v}")
    return worst


def _replay_errors(a: list, b: list):
    """Max abs difference of per-step losses and of accuracies, card
    against the CPU replay of the same bf16 steps."""
    loss_err = acc_err = 0.0
    for ma, mb in zip(a, b):
        for k, v in mb.items():
            if k.startswith("loss_"):
                loss_err = max(loss_err, abs(ma[k] - v))
            else:
                acc_err = max(acc_err, abs(ma[k] - v))
    return loss_err, acc_err


def phase_train_bf16(torch, FM, C, f32_metrics):
    """Phase 13: training with bf16 operands on both message passes, on the
    [train] batches; returns, per pass, the launches of the bf16 forward
    and of the (f32) backward."""
    from graph_neural_network_for_radar_perception_torch.config.config import GNNConfig
    from graph_neural_network_for_radar_perception_torch.data.pipeline import SyntheticRadarDataset
    from graph_neural_network_for_radar_perception_torch.train import steps as S
    from graph_neural_network_for_radar_perception_torch.train.trainer import TrainHooks, train

    cfg = GNNConfig()  # shipped widths, batch_size 8, SGD defaults
    rounds, bsz = len(cfg.graph_convolution_stem_channels), cfg.batch_size
    gen = SyntheticRadarDataset(cfg, seed=3, num_objects=(6, 10)).batches(bsz)
    batches = [next(gen) for _ in range(TRAIN_STEPS)]  # the [train] phase's
    counters = {
        "fused f32 fwd": (FM.fused_message_pass, "launches"),
        "fused bf16 fwd": (FM.fused_message_pass, "launches_bf16"),
        "fused bwd": (FM.fused_message_pass_backward, "launches"),
        "csr f32 fwd": (C.fused_message_pass_csr, "launches"),
        "csr bf16 fwd": (C.fused_message_pass_csr, "launches_bf16"),
        "csr bwd": (C.fused_message_pass_csr_backward, "launches"),
    }
    launches = {}

    def to_cpu(st):
        """(params, optimiser state, updates) of a train state, on the CPU."""
        def cpu(v):
            return v.detach().cpu().clone() if torch.is_tensor(v) else copy.deepcopy(v)
        opt = st.optimizer.state_dict()
        return ({k: cpu(v) for k, v in st.model.state_dict().items()},
                {"state": {i: {k: cpu(v) for k, v in s.items()}
                           for i, s in opt["state"].items()},
                 "param_groups": copy.deepcopy(opt["param_groups"])},
                st.updates)

    for mp_impl, tag in ((None, "fused"), ("csr", "csr")):
        state = S.create_train_state(cfg, torch.Generator().manual_seed(0), device="cuda")
        step, card_metrics, snapshots = S.make_train_step(cfg, mp_impl, mp_bf16=True), [], []

        def recording_step(st, batch):
            snapshots.append(to_cpu(st))
            st, m = step(st, batch)
            card_metrics.append({k: float(v) for k, v in m.items()})
            return st, m

        for obj, attr in counters.values():
            setattr(obj, attr, 0)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state = train(cfg, iter(batches), state=state, train_step=recording_step,
                      max_iters=TRAIN_STEPS,
                      hooks=TrainHooks(log_period=1, val_period=10**9, print_fn=log))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        got = {k: getattr(obj, attr) for k, (obj, attr) in counters.items()}
        want = rounds * step_runs(step)
        expect = {k: (want if k in (f"{tag} bf16 fwd", f"{tag} bwd") else 0) for k in counters}
        log(f"[train-bf16] {tag}: trainer.train on the card, launches {json.dumps(got)} "
            f"(expected {rounds} x ({step.captured.replays} replays + "
            f"{step.captured.warmups} warm-up runs) = {want} bf16 forwards and f32 "
            f"backwards, one a round for the batch of {bsz}, nothing else; a replay adds "
            f"{json.dumps(per_replay(step))}), skipped="
            f"{[m['skipped'] for m in card_metrics]}, {wall:.2f} s incl. capture")
        if (got != expect or any(m["skipped"] for m in card_metrics)
                or step.captured.replays != TRAIN_STEPS):
            raise AssertionError(f"the bf16 train path ({tag}) did not run its kernels "
                                 "once per round a step")
        launches[tag] = (got[f"{tag} bf16 fwd"], got[f"{tag} bwd"])

        # Each step replayed on the CPU from the card's state before it, so
        # that flipped bf16 roundings do not carry from step to step.
        t0 = time.perf_counter()
        cpu = S.create_train_state(cfg, torch.Generator().manual_seed(0), device="cpu")
        cpu_step, cpu_metrics, p_err = S.make_train_step(cfg, mp_impl, mp_bf16=True), [], 0.0
        for i, (before, after, batch) in enumerate(
                zip(snapshots, snapshots[1:] + [to_cpu(state)], batches)):
            cpu.model.load_state_dict(before[0])
            cpu.optimizer.load_state_dict(before[1])
            cpu.updates = before[2]
            cpu, m = cpu_step(cpu, batch)
            cpu_metrics.append({k: float(v) for k, v in m.items()})
            p_err = max(p_err, _params_close(after[0], cpu.model.state_dict(),
                                             f"bf16 {tag} card vs CPU, step {i}"))
        loss_err, acc_err = _replay_errors(card_metrics, cpu_metrics)
        # The f32 [train] run's step 1 starts from the same params on the
        # same batch: its losses must lie clearly farther from the replay.
        f32_gap = max(abs(f32_metrics[0][k] - v) for k, v in cpu_metrics[0].items()
                      if k.startswith("loss_"))
        f32_err = _bf16_metrics_close(card_metrics, f32_metrics, f"bf16 {tag} vs the f32 [train] run")
        log(f"[train-bf16] {tag}: CPU replay of each of the {TRAIN_STEPS} steps from the "
            f"card's state before it (plain bf16 rounds, {time.perf_counter() - t0:.1f} s): "
            f"losses max abs err {loss_err:.3e} (atol={BF16_REPLAY_ATOL}), accuracies "
            f"{acc_err:.3e} (atol={ACC_ATOL}), params after the step max abs err "
            f"{p_err:.3e} (rtol={PARAM_RTOL}, atol={PARAM_ATOL}); the f32 run's step-1 "
            f"losses lie {f32_gap:.3e} from the replay (must exceed "
            f"{BF16_REPLAY_SEPARATION}x the atol); against the f32 [train] run: "
            f"losses max abs err {f32_err:.3e} (rtol={BF16_RTOL}, atol={BF16_ATOL}); loss "
            f"{card_metrics[0]['loss_total']:.4f} -> {card_metrics[-1]['loss_total']:.4f}")
        if loss_err > BF16_REPLAY_ATOL or acc_err > ACC_ATOL:
            raise AssertionError(f"bf16 {tag}: the card's steps disagree with their CPU replay")
        if f32_gap <= BF16_REPLAY_SEPARATION * BF16_REPLAY_ATOL:
            raise AssertionError(f"bf16 {tag}: the f32 run's step-1 losses lie within "
                                 f"{BF16_REPLAY_SEPARATION}x the tolerance of the bf16 "
                                 "replay: no rounding shows in training")
        check_captured(torch, cfg, batches, state, card_metrics, f"train-bf16] [{tag}",
                       _bf16_metrics_close, mp_impl, mp_bf16=True)
        check_nan_skip(torch, state, step, batches[0], f"train-bf16] [{tag}")

        step_ms = []
        for i in range(TIMED_STEPS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, m = step(state, batches[i % len(batches)])
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - t0) * 1e3)
        timed = step_ms[2:]
        log(f"[train-bf16] {tag}: ms/step (numpy batch in, synchronised; median of "
            f"{len(timed)} after 2 warm-up): {np.median(timed):.3f} (min {min(timed):.3f}, "
            f"max {max(timed):.3f})")
        log_step_summary(f"train-bf16] [{tag}", timed, profile_run(lambda: step(state, batches[0])))
    return launches


def _train_snapshot(torch, state) -> dict:
    """Everything a resume must restore, on the host: params, optimiser
    state, counters."""
    snap = {f"param/{k}": v.detach().cpu().clone() for k, v in state.model.state_dict().items()}
    for i, st in state.optimizer.state_dict()["state"].items():
        for k, v in st.items():
            snap[f"optim/{i}/{k}"] = torch.as_tensor(v).detach().cpu().clone()
    snap["counters"] = torch.tensor([state.step, state.updates, state.mini_step])
    return snap


def _snapshot_diff(a: dict, b: dict):
    """(max abs difference of two snapshots, the tensor where it is); inf if
    their keys differ."""
    if a.keys() != b.keys():
        return float("inf"), "keys"
    diffs = {k: float((a[k].double() - b[k].double()).abs().max()) for k in a if a[k].numel()}
    worst = max(diffs, key=diffs.get)
    return diffs[worst], worst


def phase_checkpoint(torch, FM):
    """Phase 14: resume on the card: 2 steps of trainer.train saved by the
    checkpoint hook, restored into a state made from another seed, 2 more,
    against 4 uninterrupted steps, twice.  The port's kernels are
    deterministic, but the model's ``index_add_`` sums and its gathers'
    backward use atomics on the card unless PyTorch's deterministic
    algorithms are on (two runs of 4 steps differed by up to 1.6e-05
    without them on an H100).  So the phase turns
    them on (``warn_only``: cuBLAS only warns), and every run must equal the
    first 4 steps bit for bit: params, optimiser state and counters."""
    import shutil

    from graph_neural_network_for_radar_perception_torch.config.config import GNNConfig
    from graph_neural_network_for_radar_perception_torch.core import capture as CP
    from graph_neural_network_for_radar_perception_torch.data.pipeline import SyntheticRadarDataset
    from graph_neural_network_for_radar_perception_torch.train import steps as S
    from graph_neural_network_for_radar_perception_torch.train.trainer import TrainHooks, train
    from graph_neural_network_for_radar_perception_torch.utils.checkpoint import CheckpointManager

    cfg = GNNConfig()
    rounds, bsz = len(cfg.graph_convolution_stem_channels), cfg.batch_size
    gen = SyntheticRadarDataset(cfg, seed=3, num_objects=(6, 10)).batches(bsz)
    batches = [next(gen) for _ in range(4)]

    def fresh(seed):
        return S.create_train_state(cfg, torch.Generator().manual_seed(seed), device="cuda")

    def run(state, part, start, stop, ckpt=None):
        return train(cfg, iter(part), state=state, starting_iter=start, max_iters=stop,
                     hooks=TrainHooks(checkpoint=ckpt, print_fn=lambda s: None))

    directory = os.path.join(REPO, "build", "chip_smoke_checkpoints")
    shutil.rmtree(directory, ignore_errors=True)
    deterministic = (torch.are_deterministic_algorithms_enabled(),
                     torch.is_deterministic_algorithms_warn_only_enabled())
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        FM.fused_message_pass.launches = 0
        whole = _train_snapshot(torch, run(fresh(0), batches, 0, 4))
        mgr = CheckpointManager(directory)
        first = run(fresh(0), batches[:2], 0, 2, mgr)
        saved = mgr.all_steps()
        resumed = mgr.restore(template=fresh(1))
        restore_err, _ = _snapshot_diff(_train_snapshot(torch, resumed),
                                        _train_snapshot(torch, first))
        resumed = _train_snapshot(torch, run(resumed, batches[2:], 2, 4))
        again = _train_snapshot(torch, run(fresh(0), batches, 0, 4))
        launches = FM.fused_message_pass.launches
        want = rounds * (12 + 4 * CP.CapturedStep.WARMUP_RUNS)  # 4 train() calls, 12 steps
    finally:
        torch.use_deterministic_algorithms(deterministic[0], warn_only=deterministic[1])
        shutil.rmtree(directory, ignore_errors=True)
    (err, at), (repeat, repeat_at) = _snapshot_diff(resumed, whole), _snapshot_diff(again, whole)
    log(f"[checkpoint] GNNConfig() batch {bsz}, deterministic algorithms: saved steps "
        f"{saved}, restore vs the saved state max abs diff {restore_err:.3e}; 2 + 2 steps vs 4 "
        f"uninterrupted: {err:.3e} (at {at}) over {len(whole)} params/optimiser tensors and "
        f"the counters; 4 steps twice: {repeat:.3e} (at {repeat_at}); fused_message_pass "
        f"launches {launches} (expected {rounds} x (12 replays + 4 captures x "
        f"{CP.CapturedStep.WARMUP_RUNS} warm-up runs) = {want}: one a round a step for the "
        f"batch of {bsz})")
    if saved != [2] or restore_err != 0.0 or launches != want:
        raise AssertionError("the checkpoint hook did not save or restore the state")
    if repeat != 0.0 or err != 0.0:
        raise AssertionError("4 steps do not repeat bit for bit, or a resumed run differs")
    return {"bitwise": True, "max_abs_diff": err, "repeat_max_abs_diff": repeat}


def deploy_frames(cfg, count: int) -> list:
    """The [deploy] phase's raw frames: seed 1, 8-12 objects a frame."""
    from graph_neural_network_for_radar_perception_torch.data.synthetic import make_synthetic_frame

    rng = np.random.default_rng(1)
    return [make_synthetic_frame(rng, num_objects=int(rng.integers(8, 13)),
                                 window_size=cfg.temporal_window_size)
            for _ in range(count)]


def selected_measurements(data: dict, cfg) -> dict:
    """The measurements ``preprocess_frame`` builds a frame's graph from:
    inside the region of interest, then moving."""
    from graph_neural_network_for_radar_perception_torch.data import features as F
    from graph_neural_network_for_radar_perception_torch.data import groundtruth as G
    from graph_neural_network_for_radar_perception_torch.data.labels import ID_STATIC

    gt = G.compute_ground_truth_node(data)
    data, gt = F.select_within_roi(data, gt, cfg.min_x, cfg.max_x, cfg.min_y, cfg.max_y)
    return F.select_moving(data, gt, ID_STATIC)[0]


def _frames_close(nat, num, i: int) -> float:
    """Native against numpy FrameArrays: integer fields equal, float fields
    within BUILDER_RTOL/ATOL; returns the largest float difference."""
    import dataclasses

    worst = 0.0
    for f in dataclasses.fields(num):
        a, b = getattr(nat, f.name), getattr(num, f.name)
        if a.dtype != b.dtype or a.shape != b.shape:
            raise AssertionError(f"frame {i}: {f.name} {a.dtype}{a.shape} vs {b.dtype}{b.shape}")
        if b.dtype.kind == "f":
            err = np.abs(a - b)
            worst = max(worst, float(err.max(initial=0.0)))
            if (err > BUILDER_ATOL + BUILDER_RTOL * np.abs(b)).any():
                raise AssertionError(f"frame {i}: {f.name} native vs numpy beyond tolerance")
        elif not np.array_equal(a, b):
            raise AssertionError(f"frame {i}: {f.name} native vs numpy differ")
    return worst


def _graph_build_on_card(torch, GB, cfg, data, num, i: int):
    """``ops/graph_build`` on the card over a frame's selected measurements
    (padded to a multiple of 128 nodes) against the numpy builder: the
    structure equal on the valid prefix, the features close.  Returns the
    build as a closure (for timing) and the largest feature difference."""
    from graph_neural_network_for_radar_perception_torch.data import features as F

    sel = selected_measurements(data, cfg)
    n = sel["meas_px"].shape[0]
    n_cap, k = -(-n // 128) * 128, cfg.k_number_nearest_points

    def pad(a):
        out = np.zeros(n_cap, np.float32)
        out[:n] = a
        return torch.from_numpy(out).to("cuda")

    ts = pad(sel["meas_timestamp"] - sel["meas_timestamp"].min())  # µs, exact in f32
    px, py, vx, vy, vr, rcs = (pad(sel[f"meas_{c}"]) for c in ("px", "py", "vx", "vy", "vr", "rcs"))
    mask = torch.arange(n_cap, device="cuda") < n
    points = torch.stack([px, py], dim=-1)

    def build():
        return GB.build_graph_structure(
            points, mask, k=k, eps_sq=cfg.ball_query_eps_square,
            edge_capacity=2 * (k + 1) * n_cap, und_capacity=(k + 1) * n_cap)

    gs = build()
    ref = F.adjacency_info(sel["meas_px"], sel["meas_py"], cfg.ball_query_eps_square, k)
    e, eu = num.senders.shape[0], num.und_senders.shape[0]
    host = {name: getattr(gs, name).cpu().numpy() for name in gs._fields}
    same = (int(host["edge_mask"].sum()) == e and int(host["und_mask"].sum()) == eu
            and np.array_equal(host["senders"][:e], num.senders)
            and np.array_equal(host["receivers"][:e], num.receivers)
            and np.array_equal(host["und_senders"][:eu], num.und_senders)
            and np.array_equal(host["und_receivers"][:eu], num.und_receivers)
            and np.array_equal(host["degree"][:n], np.asarray(ref["degree"], np.float32)))
    if not same:
        raise AssertionError(f"frame {i}: on-card graph structure differs from the numpy builder's")
    ef = GB.compute_edge_features_device(px, py, vx, vy, ts, gs.senders, gs.receivers,
                                         gs.edge_mask)[:e].cpu().numpy()
    nf = GB.compute_node_features_device(
        vr, rcs, ts, px, py, gs.degree, mask, min_range=cfg.grid_min_r,
        max_range=cfg.grid_max_r, min_azimuth=cfg.grid_min_th, max_azimuth=cfg.grid_max_th,
        include_region_confidence=cfg.include_region_confidence)[:n].cpu().numpy()
    worst = 0.0
    for name, got, want in (("edge", ef, num.edge_feat), ("node", nf, num.node_feat)):
        err = np.abs(got - want)
        worst = max(worst, float(err.max(initial=0.0)))
        if got.shape != want.shape or (err > BUILDER_ATOL + BUILDER_RTOL * np.abs(want)).any():
            raise AssertionError(f"frame {i}: on-card {name} features differ beyond tolerance")
    return build, worst, n_cap


def phase_data_plane(torch, FM):
    """Phase 15: the host data plane on the card.  The native graph builder
    against the numpy one on the [deploy] frames; FrameDetector.detect
    through the native default against the numpy builder (decisions, p50 of
    each in turns); ops/graph_build on the card against the numpy builder;
    trainer.train_bucketed (GNNConfig()'s default buckets, batches through
    device_prefetch) replayed step by step on the CPU; MultiprocessBatches
    feeding train steps with no worker touching CUDA."""
    import itertools

    from graph_neural_network_for_radar_perception_torch.config.config import GNNConfig
    from graph_neural_network_for_radar_perception_torch.core import capture as CP
    from graph_neural_network_for_radar_perception_torch.core.graph import RadarGraph
    from graph_neural_network_for_radar_perception_torch.data import bucketing as B
    from graph_neural_network_for_radar_perception_torch.data import native as NAT
    from graph_neural_network_for_radar_perception_torch.data.mp_loader import MultiprocessBatches
    from graph_neural_network_for_radar_perception_torch.data.pipeline import (
        SyntheticRadarDataset, pad_frame, preprocess_frame)
    from graph_neural_network_for_radar_perception_torch.data.prefetch import device_prefetch
    from graph_neural_network_for_radar_perception_torch.infer.pipeline import FrameDetector
    from graph_neural_network_for_radar_perception_torch.models.gnn import RadarGNN
    from graph_neural_network_for_radar_perception_torch.ops import _build
    from graph_neural_network_for_radar_perception_torch.ops import graph_build as GB
    from graph_neural_network_for_radar_perception_torch.train import steps as S
    from graph_neural_network_for_radar_perception_torch.train.trainer import (
        TrainHooks, train, train_bucketed)

    cfg = GNNConfig()
    rounds = len(cfg.graph_convolution_stem_channels)
    t0 = time.perf_counter()
    lib = _build.build_host("graph_builder")
    NAT._lib()
    log(f"[data-plane] native graph builder ({_build.host_compiler()} "
        f"{' '.join(_build.HOST_FLAGS)}) ready in {time.perf_counter() - t0:.2f} s "
        f"({os.path.relpath(lib, REPO)}; built in [build] on a full run)")

    # 1. The native builder against the numpy builder.
    pairs, worst = [], 0.0
    for i, data in enumerate(deploy_frames(cfg, NUM_FRAMES)):
        nat, num = preprocess_frame(data, cfg), preprocess_frame(data, cfg, use_native=False)
        if (nat is None) != (num is None):
            raise AssertionError(f"frame {i}: presence differs between the builders")
        if nat is not None:
            worst = max(worst, _frames_close(nat, num, i))
            pairs.append((data, nat, num))
    log(f"[data-plane] {len(pairs)} [deploy] frames (n={[p[2].n for p in pairs]}): native vs "
        f"numpy builder: senders, receivers, undirected lists, degree and labels equal; float "
        f"features max abs err {worst:.3e} (rtol={BUILDER_RTOL}, atol={BUILDER_ATOL})")
    if len(pairs) < 4:
        raise AssertionError("too few frames for the builder comparison")

    # 2. FrameDetector.detect: the native default against the numpy builder.
    state = RadarGNN(cfg, generator=torch.Generator().manual_seed(0)).state_dict()
    det = FrameDetector(cfg, state, device="cuda")
    det.detect(pairs[0][0])  # warm-up
    torch.cuda.synchronize()
    FM.fused_message_pass.launches = 0
    native_dets = [det.detect(data) for data, _, _ in pairs]
    torch.cuda.synchronize()
    detect_launches = FM.fused_message_pass.launches
    if detect_launches != rounds * len(pairs):
        raise AssertionError("detect did not run the fused kernel once per round")
    for i, ((data, nat, num), ndet) in enumerate(zip(pairs, native_dets)):
        udet = det.detect_frame_arrays(num)
        graph_np, _ = pad_frame(num, cfg)
        with torch.no_grad():
            out = det.model.deploy(RadarGraph.from_numpy(graph_np, "cuda"), eps=det.eps)
        rep = compare_decisions(ndet, udet, out.node_cls.cpu().numpy()[: num.n],
                                out.obj_cls.cpu().numpy(), det.eps)
        log(f"[data-plane] frame {i}: detect native vs numpy builder {json.dumps(rep)}")
    paths = {"native": lambda data: det.detect(data),
             "numpy": lambda data: det.detect_frame_arrays(
                 preprocess_frame(data, cfg, use_native=False))}
    ms = {name: [] for name in paths}
    for rep in range(DETECT_REPS):
        for data, _, _ in pairs:
            for name in (("native", "numpy") if rep % 2 == 0 else ("numpy", "native")):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                paths[name](data)
                torch.cuda.synchronize()
                ms[name].append((time.perf_counter() - t0) * 1e3)
    summary = {name: {"p50": float(np.median(v)), "p99": float(np.percentile(v, 99)),
                      "min": min(v), "max": max(v), "frames": len(v)} for name, v in ms.items()}
    log(f"[data-plane] FrameDetector.detect ms/frame, in turns: native builder p50 "
        f"{summary['native']['p50']:.3f}, numpy builder p50 {summary['numpy']['p50']:.3f} "
        f"({json.dumps(summary)}) on {card()}")

    # 3. ops/graph_build on the card against the numpy builder.
    worst = 0.0
    for i, (data, _, num) in enumerate(pairs):
        build, err, n_cap = _graph_build_on_card(torch, GB, cfg, data, num, i)
        worst = max(worst, err)
    build_ms = event_ms(build, reps=20, inner=5)
    prof = profile_run(build)
    log(f"[data-plane] ops/graph_build.build_graph_structure on the card: structure equal to "
        f"the numpy builder's on {len(pairs)} frames, features max abs err {worst:.3e}; one "
        f"frame (N={n_cap}): {build_ms:.3f} ms (CUDA events), {prof['device_kernels']} kernels, "
        f"busy {prof['device_busy_ms']:.3f} ms ({json.dumps(prof)})")

    # 4. train_bucketed at the shipped widths, fed by device_prefetch.
    buckets = B.default_buckets(cfg)
    ds = SyntheticRadarDataset(cfg, seed=5, num_objects=(1, 8))
    frames = (ds.sample_frame() for _ in itertools.count())
    records, make_step = [], B.make_bucketed_train_step

    def recording(cfg_, buckets_, **kw):
        step = make_step(cfg_, buckets_, **kw)

        def run(st, bucket, batch):
            before = ({k: v.detach().cpu().clone() for k, v in st.model.state_dict().items()},
                      copy.deepcopy(st.optimizer.state_dict()), st.step, st.updates)
            st, m = step(st, bucket, batch)
            records.append((bucket, batch.to("cpu"), before, {k: float(v) for k, v in m.items()},
                            {k: v.detach().cpu().clone() for k, v in st.model.state_dict().items()}))
            return st, m

        return run

    st = S.create_train_state(cfg, torch.Generator().manual_seed(0), device="cuda")
    FM.fused_message_pass.launches = 0
    FM.fused_message_pass_backward.launches = 0
    B.make_bucketed_train_step = recording
    try:
        t0 = time.perf_counter()
        st = train_bucketed(cfg, frames, buckets=buckets, state=st, max_iters=BUCKETED_STEPS,
                            hooks=TrainHooks(log_period=1, val_period=10**9, print_fn=log))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        B.make_bucketed_train_step = make_step
    tb_fwd, tb_bwd = FM.fused_message_pass.launches, FM.fused_message_pass_backward.launches
    reached = sorted({(r[0].max_nodes, r[0].batch_size) for r in records})
    # One captured step a bucket reached (its warm-up runs), a replay a step.
    want = rounds * (BUCKETED_STEPS + len(reached) * CP.CapturedStep.WARMUP_RUNS)
    log(f"[data-plane] train_bucketed {BUCKETED_STEPS} steps on the card ({wall:.2f} s incl. "
        f"captures): buckets (max_nodes, batch) {[(r[0].max_nodes, r[0].batch_size) for r in records]} "
        f"of {[(b.max_nodes, b.batch_size) for b in buckets]}; launches forward={tb_fwd} "
        f"backward={tb_bwd} (expected {rounds} x ({BUCKETED_STEPS} replays + {len(reached)} "
        f"captures x {CP.CapturedStep.WARMUP_RUNS} warm-up runs) = {want}: one a round a "
        f"step, whatever the bucket's batch); skipped={[r[3]['skipped'] for r in records]}")
    if (len(records) != BUCKETED_STEPS or len(reached) < 2 or tb_fwd != want
            or tb_bwd != want or any(r[3]["skipped"] for r in records)):
        raise AssertionError("train_bucketed did not run both kernels once per round a step "
                             "over two buckets")
    t0 = time.perf_counter()
    cpu_step, m_err, p_err = make_step(cfg, buckets), 0.0, 0.0
    for i, (bucket, batch, (params, optim, step_no, updates), card_m, card_p) in enumerate(records):
        cpu = S.create_train_state(cfg, device="cpu")
        cpu.model.load_state_dict(params)
        cpu.optimizer.load_state_dict(optim)
        cpu.step, cpu.updates = step_no, updates
        cpu, m = cpu_step(cpu, bucket, batch)
        m_err = max(m_err, _metrics_close([card_m], [{k: float(v) for k, v in m.items()}],
                                          f"[data-plane] step {i}"))
        p_err = max(p_err, _params_close(card_p, cpu.model.state_dict(), f"[data-plane] step {i}"))
    log(f"[data-plane] CPU replay of each train_bucketed step from the card's state before it "
        f"({time.perf_counter() - t0:.1f} s): metrics max abs err {m_err:.3e} (rtol={METRIC_RTOL}, "
        f"atol={METRIC_ATOL}), params {p_err:.3e} (rtol={PARAM_RTOL}, atol={PARAM_ATOL})")

    # 5. MultiprocessBatches (forked workers) feeding steps through device_prefetch.
    FM.fused_message_pass.launches = 0
    FM.fused_message_pass_backward.launches = 0
    t0 = time.perf_counter()
    with MultiprocessBatches(cfg, cfg.batch_size, num_workers=2, queue_size=4, seed=7) as loader:
        st = train(cfg, device_prefetch(loader), state=st, starting_iter=st.step,
                   max_iters=st.step + LOADER_STEPS,
                   hooks=TrainHooks(log_period=1, val_period=10**9, print_fn=log))
        torch.cuda.synchronize()
        worker_cuda = loader.workers_initialised_cuda()
    mp_fwd, mp_bwd = FM.fused_message_pass.launches, FM.fused_message_pass_backward.launches
    want = rounds * (LOADER_STEPS + CP.CapturedStep.WARMUP_RUNS)  # train()'s own step
    log(f"[data-plane] MultiprocessBatches (2 forked workers) -> device_prefetch -> train, "
        f"{LOADER_STEPS} steps ({time.perf_counter() - t0:.2f} s): launches forward={mp_fwd} "
        f"backward={mp_bwd} (expected {want}); CUDA initialised in the workers: {worker_cuda}")
    if mp_fwd != want or mp_bwd != want or any(worker_cuda):
        raise AssertionError("the loader's steps did not run, or a worker initialised CUDA")
    return {"fwd": detect_launches + tb_fwd + mp_fwd, "bwd": tb_bwd + mp_bwd,
            "detect": summary}


def phase_bench(torch):
    """Phase 16: the port bench, one short repeat per config."""
    from graph_neural_network_for_radar_perception_torch.scripts import bench as PB

    t0 = time.perf_counter()
    res = PB.run("cuda", warmup=1, steps=1)
    rows = dict(res["train_b8"]["rows"], stress_dense=res["stress_dense"],
                deploy=res["deploy"], deploy_eager=res["deploy"]["eager"],
                detect=res["deploy"]["detect"])
    log(f"[bench] scripts/bench.run(warmup=1, steps=1) in {time.perf_counter() - t0:.1f} s: "
        f"{json.dumps(res)}")
    for name, row in rows.items():
        log(f"[bench] {name}: host ms median {row['host_ms']:.3f} (min {row['host_ms_min']:.3f}, "
            f"max {row['host_ms_max']:.3f}), event ms {row['event_ms']:.3f}, device busy "
            f"{row['device_busy_ms']:.3f} ms, idle {row['device_idle_share']:.3f}, "
            f"{row['device_kernels']} kernels and {row['host_launches']} host launches a call, "
            f"mfu {row.get('mfu')}")
        if not (np.isfinite(row["host_ms"]) and row["host_ms"] > 0 and row["device_kernels"] > 0):
            raise AssertionError(f"[bench] {name}: no time or no kernel on the card")
    if any(r["skipped"] for r in res["train_b8"]["rows"].values()):
        raise AssertionError("[bench] a train_b8 step was skipped")
    return res


def _deploy_decisions(out, n: int):
    """A deploy forward's decisions on the first n nodes, in the fields
    ``compare_decisions`` reads (those of FrameDetections)."""
    import types

    k = int(out.num_clusters)
    return types.SimpleNamespace(
        node_class=out.node_cls[:n].argmax(-1).cpu().numpy(),
        node2cluster=out.node2cluster[:n].cpu().numpy(),
        centers=out.centers[:n].cpu().numpy(), num_clusters=k,
        cluster_class=out.obj_cls.argmax(-1).cpu().numpy())


def _outputs_close(a, b, rows: dict, what: str, worst: dict) -> None:
    """Deploy outputs ``a`` (card) against ``b`` (CPU) on the given rows of
    each field, within DEPLOY_RTOL/ATOL; the largest errors go to ``worst``."""
    for field, sel in rows.items():
        x = getattr(a, field).detach().cpu().numpy()[sel]
        y = getattr(b, field).detach().cpu().numpy()[sel]
        if x.shape != y.shape or not np.isfinite(x).all():
            raise AssertionError(f"{what}: {field} malformed")
        err = np.abs(x - y)
        worst[field] = max(worst.get(field, 0.0), float(err.max(initial=0.0)))
        if (err > DEPLOY_ATOL + DEPLOY_RTOL * np.abs(y)).any():
            raise AssertionError(f"{what}: {field} card vs CPU beyond tolerance")


def eval_windows(count: int) -> list:
    """The [eval] phase's raw windows: seed 21, 2-6 objects, window 5."""
    from graph_neural_network_for_radar_perception_torch.data.synthetic import make_synthetic_frame

    rng = np.random.default_rng(21)
    return [make_synthetic_frame(rng, num_objects=int(rng.integers(2, 7)),
                                 window_size=EVAL_WINDOW) for _ in range(count)]


def phase_eval(torch, FM):
    """Phase 17: evaluation of the committed fixture-trained weights, read
    without JAX (``utils/checkpoint.load_params_msgpack``), at the artifact's
    capacities: ``segmentation_confusion`` and ``evaluate_detection_from_data``
    (threshold 1, eps 0.7) on the card over seeded synthetic windows, against
    the same calls through the port on the CPU: confusion matrices equal,
    unless a frame's decisions differ within the [deploy] rule (tied logits,
    borderline DBSCAN pairs)."""
    from graph_neural_network_for_radar_perception_torch.config.config import GNNConfig
    from graph_neural_network_for_radar_perception_torch.core.graph import RadarGraph
    from graph_neural_network_for_radar_perception_torch.data.groundtruth import (
        compute_ground_truth_node)
    from graph_neural_network_for_radar_perception_torch.data.labels import ID_NONE
    from graph_neural_network_for_radar_perception_torch.data.pipeline import pad_frame, preprocess_frame
    from graph_neural_network_for_radar_perception_torch.eval import drivers as D
    from graph_neural_network_for_radar_perception_torch.eval import metrics as M
    from graph_neural_network_for_radar_perception_torch.infer.pipeline import FrameDetector
    from graph_neural_network_for_radar_perception_torch.utils.checkpoint import load_params_msgpack
    from graph_neural_network_for_radar_perception_torch.utils.convert import state_dict_from_flax

    artifact = os.path.join(REPO, "runs", "fixture_artifact")
    with open(os.path.join(artifact, "config.json")) as f:
        saved = json.load(f)
    cfg = GNNConfig(max_nodes=int(saved["max_nodes"]), max_clusters=int(saved["max_clusters"]),
                    temporal_window_size=int(saved["temporal_window_size"]))
    t0 = time.perf_counter()
    params = load_params_msgpack(os.path.join(artifact, "weights.msgpack"))
    state = state_dict_from_flax(params)
    log(f"[eval] runs/fixture_artifact/weights.msgpack read without JAX: {len(state)} tensors "
        f"in {(time.perf_counter() - t0) * 1e3:.1f} ms; caps max_nodes {cfg.max_nodes}, "
        f"max_clusters {cfg.max_clusters}, window {cfg.temporal_window_size}")
    det = {dev: FrameDetector(cfg, state, eps=1.4, use_object_head=True, device=dev)
           for dev in ("cuda", "cpu")}
    windows = eval_windows(EVAL_FRAMES)
    frames = [fr for fr in (preprocess_frame(d, cfg) for d in windows) if fr is not None]
    det["cuda"].detect_frame_arrays(frames[0])  # warm-up
    torch.cuda.synchronize()

    FM.fused_message_pass.launches = 0
    t0 = time.perf_counter()
    seg = {"cuda": D.segmentation_confusion(det["cuda"], frames)}
    torch.cuda.synchronize()
    seg_ms = (time.perf_counter() - t0) * 1e3 / len(frames)
    t0 = time.perf_counter()
    dets = {"cuda": D.evaluate_detection_from_data(det["cuda"], windows,
                                                   cluster_size_threshold=1, eps=0.7)}
    torch.cuda.synchronize()
    det_ms = (time.perf_counter() - t0) * 1e3 / len(windows)
    launches = FM.fused_message_pass.launches
    seg["cpu"] = D.segmentation_confusion(det["cpu"], frames)
    dets["cpu"] = D.evaluate_detection_from_data(det["cpu"], windows, cluster_size_threshold=1,
                                                 eps=0.7)

    # The frames both drivers ran, and each one's decisions card vs CPU.
    filtered = []
    for data in windows:
        keep = compute_ground_truth_node(data)["class_labels"] != ID_NONE
        fr = preprocess_frame({k: v[keep] for k, v in data.items()}, cfg)
        if fr is not None:
            filtered.append(fr)
    rounds = len(cfg.graph_convolution_stem_channels)
    want = rounds * (len(frames) + len(filtered))
    log(f"[eval] {len(frames)} segmentation frames, {len(filtered)} detection frames "
        f"(NONE dropped) of {len(windows)} windows; fused_message_pass launches={launches} "
        f"(expected {want}); ms/frame on the card: segmentation_confusion {seg_ms:.3f}, "
        f"evaluate_detection_from_data {det_ms:.3f} (host preprocess + deploy + decode "
        f"+ association) on {card()}")
    if launches != want:
        raise AssertionError("the eval drivers did not run the fused kernel once per round")
    exact = True
    for i, fr in enumerate(frames + filtered):
        graph_np, _ = pad_frame(fr, cfg)
        with torch.no_grad():
            out = {dev: det[dev].model.deploy(RadarGraph.from_numpy(graph_np, dev), 1.4)
                   for dev in ("cuda", "cpu")}
        rep = compare_decisions(_deploy_decisions(out["cuda"], fr.n),
                                _deploy_decisions(out["cpu"], fr.n),
                                out["cpu"].node_cls.numpy()[: fr.n], out["cpu"].obj_cls.numpy(),
                                1.4)
        exact &= (rep["node_class_diffs"] == 0 and rep["partition_equal"]
                  and rep.get("object_class_diffs", 1) == 0)
    agree = {name: (acc["cuda"].to_json_dict() == acc["cpu"].to_json_dict())
             for name, acc in (("segmentation", seg), ("detection", dets))}
    log(f"[eval] card vs CPU confusion matrices equal: {json.dumps(agree)}; per-frame decisions "
        f"{'all equal' if exact else 'within the [deploy] rule (ties or borderline pairs)'}")
    if exact and not all(agree.values()):
        raise AssertionError("equal decisions but different confusion matrices")
    eig = check_eigen_helpers(torch, frames)
    log(f"[eval] rotation_invariant_cluster_features and cov_ellipse on the card against the "
        f"CPU over the frames' GT clusters, up to the eigenvector signs: {json.dumps(eig)} "
        f"(rtol={DEPLOY_RTOL}, atol={DEPLOY_ATOL})")
    summary = {}
    for name, acc in (("segmentation", seg["cuda"]), ("detection", dets["cuda"])):
        pr = M.precision_recall(acc.cm)
        summary[name] = {"count": int(acc.cm.sum()), "confusion": acc.cm.tolist(),
                         "precision": np.round(pr["precision"], 4).tolist(),
                         "recall": np.round(pr["recall"], 4).tolist()}
        log(f"[eval] {name} on the card (classes {pr['classes'].tolist()}, NONE dropped): "
            f"precision {summary[name]['precision']}, recall {summary[name]['recall']}")
    return {"fwd": launches, "seg_ms": seg_ms, "det_ms": det_ms, "equal": agree,
            "eigen": eig, **summary}


def check_eigen_helpers(torch, frames) -> dict:
    """``infer/proposals``' eigenvector helpers on the card (cuSOLVER's eigh)
    against the CPU's (LAPACK) over the GT clusters of ``frames``: r equal
    and every ellipse point on the CPU's ellipse (Mahalanobis radius² χ²);
    where the eigenvalues are apart by more than EIGEN_GAP of the larger
    (the eigenvectors well conditioned), also x' and y' equal up to one sign
    per eigenvector column and the ellipse the CPU formula with those signs.
    Neither package fixes the signs (ROADMAP.md C7).  Returns the counts of
    clusters, compared columns and flipped ones."""
    from graph_neural_network_for_radar_perception_torch.infer import proposals as P

    def close(a, b):
        err = np.abs(a - b)
        if (err > DEPLOY_ATOL + DEPLOY_RTOL * np.abs(b)).any():
            raise AssertionError("[eval] eigenvector helpers: card vs CPU beyond tolerance")
        return float(err.max())

    def well_conditioned(evals):
        return evals[1] - evals[0] > EIGEN_GAP * abs(evals[1])

    n = cols = flips = 0
    worst = 0.0
    for fr in frames:
        for c in range(fr.cluster_class.shape[0]):
            idx = np.flatnonzero(fr.node2cluster == c)[:64]
            if idx.size < 2:
                continue
            n += 1
            xy = np.zeros((64, 2), np.float32)
            xy[: idx.size] = fr.other_feat[idx, :2]
            mask = np.arange(64) < idx.size
            got, want = (P.rotation_invariant_cluster_features(
                torch.from_numpy(xy).to(dev), torch.from_numpy(mask).to(dev)).cpu().numpy()
                for dev in ("cuda", "cpu"))
            worst = max(worst, close(got[:, 2], want[:, 2]))
            if well_conditioned(np.linalg.eigvalsh(np.cov(xy[mask].T))):
                signs = np.where((got[:, :2] * want[:, :2]).sum(0) < 0, -1.0, 1.0)
                cols, flips = cols + 2, flips + int((signs < 0).sum())
                worst = max(worst, close(got[:, :2], want[:, :2] * signs))
            mu = xy[mask].mean(0)
            sigma = np.cov(xy[mask].T).astype(np.float32) + 0.5 * np.eye(2, dtype=np.float32)
            ell = P.cov_ellipse(torch.from_numpy(mu).to("cuda"),
                                torch.from_numpy(sigma).to("cuda")).cpu().numpy()
            d = (ell - mu).astype(np.float64)
            worst = max(worst, close(np.einsum("pi,ij,pj->p", d, np.linalg.inv(sigma), d),
                                     np.full(d.shape[0], 9.21)))
            evals, evecs = (a.numpy() for a in torch.linalg.eigh(torch.from_numpy(sigma)))
            if well_conditioned(evals):
                card_evecs = torch.linalg.eigh(torch.from_numpy(sigma).to("cuda"))[1].cpu().numpy()
                signs = np.where((card_evecs * evecs).sum(0) < 0, -1.0, 1.0)
                cols, flips = cols + 2, flips + int((signs < 0).sum())
                t = np.linspace(0.0, 2.0 * np.pi, ell.shape[0])
                circle = np.stack([np.cos(t), np.sin(t)], -1) * np.sqrt(evals * 9.21) * signs
                worst = max(worst, close(ell, mu + circle @ evecs.T))
    return {"clusters": n, "columns": cols, "sign_flips": flips, "max_abs_err": worst}


def phase_variants(torch, FM):
    """Phase 18: the variant models' deploy at GNNConfig() full width with
    seeded weights carried to a CPU copy: RadarGNNv1 (fused node head) with
    the fused round and with the CSR round, RadarGNNv2 (GATv2 neck: hidden
    512 over 8 heads, through the GATv2 kernel pair) on the [deploy] frames;
    decisions under the [deploy] rule, logits within its tolerance; each
    path's kernel once a round."""
    from graph_neural_network_for_radar_perception_torch.config.config import GNNConfig
    from graph_neural_network_for_radar_perception_torch.core.graph import RadarGraph
    from graph_neural_network_for_radar_perception_torch.data.pipeline import pad_frame, preprocess_frame
    from graph_neural_network_for_radar_perception_torch.models.gat import RadarGNNv2
    from graph_neural_network_for_radar_perception_torch.models.gnn import RadarGNNv1
    from graph_neural_network_for_radar_perception_torch.ops import csr_mp as C
    from graph_neural_network_for_radar_perception_torch.ops import gat_mp as GM

    runs = (("v1", RadarGNNv1, GNNConfig()), ("v1-csr", RadarGNNv1, GNNConfig(mp_impl="csr")),
            ("v2", RadarGNNv2, GNNConfig()))
    frames = [fr for fr in (preprocess_frame(d, runs[1][2]) for d in
                            deploy_frames(GNNConfig(), VARIANT_FRAMES)) if fr is not None]
    rounds = len(GNNConfig().graph_convolution_stem_channels)
    result = {}
    for name, cls, cfg in runs:
        cpu = cls(cfg, generator=torch.Generator().manual_seed(0)).eval()
        gpu = cls(cfg).eval()
        gpu.load_state_dict(cpu.state_dict())
        gpu = gpu.to("cuda")
        graphs = [pad_frame(fr, cfg)[0] for fr in frames]
        with torch.no_grad():
            gpu.deploy(RadarGraph.from_numpy(graphs[0], "cuda"))  # warm-up
            torch.cuda.synchronize()
            FM.fused_message_pass.launches = 0
            C.fused_message_pass_csr.launches = 0
            GM.gat_round.launches = 0
            outs, ms = [], []
            for g in graphs:
                graph = RadarGraph.from_numpy(g, "cuda")
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                outs.append(gpu.deploy(graph))
                torch.cuda.synchronize()
                ms.append((time.perf_counter() - t0) * 1e3)
            launches = {"fused_mp_forward": FM.fused_message_pass.launches,
                        "csr_mp_forward": C.fused_message_pass_csr.launches,
                        "gat_mp_forward": GM.gat_round.launches}
            worst, reports = {}, []
            for i, (fr, g, out) in enumerate(zip(frames, graphs, outs)):
                ref = cpu.deploy(RadarGraph.from_numpy(g, "cpu"))
                k = int(ref.num_clusters)
                _outputs_close(out, ref, {"node_cls": g.node_mask,
                                                 "node_offsets": g.node_mask,
                                                 "edge_cls": g.und_mask,
                                                 "centers": g.node_mask},
                               f"[variants] {name} frame {i}", worst)
                rep = compare_decisions(_deploy_decisions(out, fr.n), _deploy_decisions(ref, fr.n),
                                        ref.node_cls.numpy()[: fr.n], ref.obj_cls.numpy(), 1.4)
                if rep["partition_equal"] and int(out.num_clusters) == k:
                    _outputs_close(out, ref, {"obj_cls": slice(0, k)},
                                   f"[variants] {name} frame {i}", worst)
                reports.append(rep)
        once = rounds * len(frames)
        want = {"v1": (once, 0, 0), "v1-csr": (0, once, 0), "v2": (0, 0, once)}[name]
        log(f"[variants] {name} ({cls.__name__}, mp_impl={cfg.mp_impl}) deploy on {len(frames)} "
            f"frames: launches {json.dumps(launches)} (expected {list(want)}); ms/frame median "
            f"{np.median(ms):.3f} (min {min(ms):.3f}, max {max(ms):.3f}); card vs CPU max abs "
            f"err {json.dumps(worst)} (rtol={DEPLOY_RTOL}, atol={DEPLOY_ATOL}); decisions "
            f"{json.dumps(reports)}")
        if tuple(launches.values()) != want:
            raise AssertionError(f"[variants] {name}: the round kernels ran other than "
                                 f"once per round")
        result[name] = {"launches": launches, "ms_median": float(np.median(ms))}
    return result


def finetune_loop_loss(torch, FT, model, cfg, batch):
    """The finetuning loss by the reference's loop: one deploy a graph, the
    graphs' sums added in graph order, then divided (a 0-d tensor)."""
    from graph_neural_network_for_radar_perception_torch.train.loss import cross_entropy, one_hot

    total = count = 0.0
    for b in range(batch.batch_size):
        g, lbl = batch.graph.at(b), batch.labels.at(b)
        out = model.deploy(g, eps=cfg.clustering_eps)
        n = g.num_nodes
        gt = FT.majority_vote_labels(lbl.node_class, out.node2cluster, g.node_mask, n,
                                     cfg.num_classes)
        cm = (torch.arange(n, device=gt.device) < out.num_clusters).float()
        total = total + (cross_entropy(out.obj_cls, one_hot(gt, cfg.num_classes)) * cm).sum()
        count = count + cm.sum()
    return total / torch.clamp(count, min=1.0)


def phase_finetune(torch, FM):
    """Phase 19: object-head finetuning (``train/finetune.py``) at
    GNNConfig() full width, batch 8, 3 steps on synthetic frames, each a
    replay of one captured CUDA graph: one deploy forward for the batch
    (DBSCAN at clustering_eps; the forward kernel once a round) and the
    trunk's gradient for the finiteness check (the backward kernel once a
    round, ROADMAP C6); everything outside predict_class bitwise unchanged
    after every step; a NaN-poisoned batch skipped with the head, its
    momentum and the trunk bitwise kept; each
    step against the same body run eagerly on the card from the same state
    (metrics and the head within FINETUNE_RTOL/ATOL) and its loss and the
    head's gradient against the reference's loop of one deploy a graph
    (the per-graph step's); each step replayed on the
    CPU from the card's state before it, with the card's DBSCAN partitions
    (themselves held to the CPU's under the [deploy] rule), within the
    train_bucketed replay's tolerance."""
    from graph_neural_network_for_radar_perception_torch.config.config import GNNConfig
    from graph_neural_network_for_radar_perception_torch.data.pipeline import SyntheticRadarDataset
    from graph_neural_network_for_radar_perception_torch.models import gnn as GN
    from graph_neural_network_for_radar_perception_torch.ops import csr_mp as C
    from graph_neural_network_for_radar_perception_torch.train import finetune as FT
    from graph_neural_network_for_radar_perception_torch.core.capture import CapturedStep
    from graph_neural_network_for_radar_perception_torch.train.steps import (
        TrainState, batch_on, batched_deploy)

    cfg = GNNConfig()
    rounds, bsz = len(cfg.graph_convolution_stem_channels), cfg.batch_size
    gen = SyntheticRadarDataset(cfg, seed=13, num_objects=(6, 10)).batches(bsz)
    batches = [next(gen) for _ in range(FINETUNE_STEPS)]
    build, loss_fn = FT.make_finetune_step(cfg)
    states, steps = [], []
    for _ in range(2):  # the captured step's, and the eager body's
        m = GN.RadarGNN(cfg, generator=torch.Generator().manual_seed(0)).to("cuda")
        st, o = build(m)
        steps.append(st)
        states.append(TrainState(m, o))
    (state, eager), (step, eager_step) = states, steps
    model, opt = state.model, state.optimizer
    frozen = {k: v.clone() for k, v in model.state_dict().items()
              if not k.startswith(FT.TRAINED + ".")}

    records, step_ms, eager_err, loop_err, grad_err = [], [], 0.0, 0.0, 0.0
    FM.fused_message_pass.launches = 0
    FM.fused_message_pass_backward.launches = 0
    for batch in batches:
        before = ({k: v.detach().cpu().clone() for k, v in model.state_dict().items()},
                  copy.deepcopy(opt.state_dict()), state.step, state.updates)
        saved = _counts(FM, C)  # comparisons: not the main path's launches
        tb = batch_on(batch, "cuda")
        with torch.no_grad():
            out = batched_deploy(model, cfg)(tb.graph)
            parts = (out.node2cluster.cpu(), out.num_clusters.cpu())
        # The per-graph step's loss and head gradient against the batched
        # step's, eagerly, at the state before the step.
        head = list(getattr(model, FT.TRAINED).parameters())
        loop = finetune_loop_loss(torch, FT, model, cfg, tb)
        g_loop = torch.autograd.grad(loop, head)
        g_batch = torch.autograd.grad(loss_fn(model, tb)[0], head)
        for a, b in zip(g_loop, g_batch):
            err = (a - b).abs()
            grad_err = max(grad_err, float(err.max()))
            if (err > FINETUNE_ATOL + FINETUNE_RTOL * b.abs()).any():
                raise AssertionError("[finetune] the head's gradient differs from the per-graph "
                                     "loop's beyond tolerance")
        loop = float(loop.detach())
        _restore_counts(FM, C, saved)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, m = step(state, batch)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        saved = _counts(FM, C)
        em = eager_step.captured.body(eager, batch_on(batch, "cuda"))
        _restore_counts(FM, C, saved)
        m = {k: float(v) for k, v in m.items()}
        for k, v in em.items():
            eager_err = max(eager_err, abs(m[k] - float(v)))
            if abs(m[k] - float(v)) > FINETUNE_ATOL + FINETUNE_RTOL * abs(float(v)):
                raise AssertionError(f"[finetune] {k}: captured {m[k]} eager {float(v)}")
        want = eager.model.state_dict()
        for k, v in model.state_dict().items():
            if k.startswith(FT.TRAINED + "."):
                err = (v - want[k]).abs()
                eager_err = max(eager_err, float(err.max()))
                if (err > FINETUNE_ATOL + FINETUNE_RTOL * want[k].abs()).any():
                    raise AssertionError(f"[finetune] {k}: captured vs eager beyond tolerance")
        loop_err = max(loop_err, abs(m["loss_obj_cls"] - loop))
        if abs(m["loss_obj_cls"] - loop) > FINETUNE_ATOL + FINETUNE_RTOL * abs(loop):
            raise AssertionError(f"[finetune] the batched loss {m['loss_obj_cls']} is not the "
                                 f"per-graph loop's {loop}")
        records.append((batch, before, m,
                        {k: v.detach().cpu().clone() for k, v in model.state_dict().items()},
                        parts))
        changed = [k for k, v in model.state_dict().items()
                   if k in frozen and not torch.equal(v, frozen[k])]
        if changed:
            raise AssertionError(f"[finetune] frozen parameters moved: {changed}")
    fwd, bwd = FM.fused_message_pass.launches, FM.fused_message_pass_backward.launches
    cap = step.captured
    want = rounds * (cap.replays + cap.warmups)
    log(f"[finetune] make_finetune_step(GNNConfig()) batch {bsz}, {FINETUNE_STEPS} steps on the "
        f"card, one captured CUDA graph ({len(cap.graphs)} capture, {cap.replays} replays, "
        f"{cap.warmups} warm-up runs): fused_message_pass launches={fwd} (expected {rounds} x "
        f"({cap.replays} + {cap.warmups}) = {want}: one a round for the batch), backward={bwd} "
        f"(expected {want}: the trunk's gradient, checked for finiteness only); metrics "
        f"{json.dumps([r[2] for r in records])}; "
        f"ms/step {[round(t, 3) for t in step_ms]}; params outside predict_class changed: "
        f"{changed}; captured vs the eager batched step on the card: max abs err {eager_err:.3e} "
        f"(rtol={FINETUNE_RTOL}, atol={FINETUNE_ATOL}); vs the per-graph loop (one deploy a "
        f"graph): loss {loop_err:.3e}, the head's gradient {grad_err:.3e}")
    if (fwd != want or bwd != want or any(r[2]["skipped"] for r in records)
            or cap.replays != FINETUNE_STEPS or cap.warmups != CapturedStep.WARMUP_RUNS):
        raise AssertionError("[finetune] the kernels ran other than expected or a step was "
                             "skipped")
    if not any(not torch.equal(records[-1][3][k], records[0][1][0][k]) for k in records[0][3]
               if k.startswith(FT.TRAINED + ".")):
        raise AssertionError("[finetune] predict_class did not move")
    saved = _counts(FM, C)
    check_nan_skip(torch, state, step, batches[0], "finetune")
    _restore_counts(FM, C, saved)
    changed = [k for k, v in model.state_dict().items()
               if k in frozen and not torch.equal(v, frozen[k])]
    if changed:
        raise AssertionError(f"[finetune] the NaN skip moved frozen parameters: {changed}")

    t0 = time.perf_counter()
    m_err, p_err = 0.0, 0.0
    real_dbscan = GN.dbscan_on_device
    cpu_model = GN.RadarGNN(cfg)
    cpu_step, cpu_opt = build(cpu_model)
    for i, (batch, (params, optim, step_no, updates), card_m, card_p, parts) in enumerate(records):
        cpu_model.load_state_dict(params)
        cpu_opt.load_state_dict(optim)
        cpu = TrainState(cpu_model, cpu_opt, step_no, updates)

        def card_partition(centers, mask, eps, **kw):
            ids, num = parts
            own, _ = real_dbscan(centers, mask, eps, **kw)
            for b in range(centers.shape[0]):
                n = int(mask[b].sum())
                check_partition(ids[b].numpy()[:n], own[b].numpy()[:n], centers[b].numpy()[:n],
                                eps)
            return ids, num

        GN.dbscan_on_device = card_partition
        try:
            cpu, m = cpu_step(cpu, batch)
        finally:
            GN.dbscan_on_device = real_dbscan
        m_err = max(m_err, _metrics_close([card_m], [{k: float(v) for k, v in m.items()}],
                                          f"[finetune] step {i}"))
        p_err = max(p_err, _params_close(card_p, cpu_model.state_dict(), f"[finetune] step {i}"))
    log(f"[finetune] CPU replay of each step from the card's state before it, with the card's "
        f"DBSCAN partitions ({time.perf_counter() - t0:.1f} s): metrics max abs err "
        f"{m_err:.3e} (rtol={METRIC_RTOL}, atol={METRIC_ATOL}), params {p_err:.3e} "
        f"(rtol={PARAM_RTOL}, atol={PARAM_ATOL})")
    return {"fwd": fwd, "bwd": bwd, "ms": step_ms}


def classifier_batches(ccfg, count: int) -> list:
    """[classifier] batches of 8 samples: the GT clusters of synthetic
    GNNConfig() frames (6-12 objects) as proposals, seed 17."""
    from graph_neural_network_for_radar_perception_torch.config.config import GNNConfig
    from graph_neural_network_for_radar_perception_torch.data.pipeline import SyntheticRadarDataset
    from graph_neural_network_for_radar_perception_torch.models import classifier as CL

    ds = SyntheticRadarDataset(GNNConfig(), seed=17, num_objects=(6, 12))
    batches = []
    while len(batches) < count:
        samples = []
        while len(samples) < CLASSIFIER_BATCH:
            fr = ds.sample_frame()
            s = CL.build_classifier_sample(fr.other_feat[:, :2], fr.node_feat[:, 1],
                                           fr.node_class, fr.node2cluster,
                                           int(fr.cluster_class.shape[0]), ccfg)
            if s is not None:
                samples.append(s)
        batches.append(CL.stack_samples(samples))
    return batches


def _replay(torch, records, make_state, step, what: str):
    """Each recorded card step replayed on the CPU from the card's state
    before it: metrics and params within METRIC_*/PARAM_*; returns the
    largest errors."""
    m_err, p_err = 0.0, 0.0
    for i, (args, (params, optim, step_no, updates), card_m, card_p) in enumerate(records):
        cpu = make_state()
        cpu.model.load_state_dict(params)
        cpu.optimizer.load_state_dict(optim)
        cpu.step, cpu.updates = step_no, updates
        cpu, m = step(cpu, *args)
        m_err = max(m_err, _metrics_close([card_m], [{k: float(v) for k, v in m.items()}],
                                          f"{what} step {i}"))
        p_err = max(p_err, _params_close(card_p, cpu.model.state_dict(), f"{what} step {i}"))
    return m_err, p_err


def _recorded_steps(torch, state, step, arg_lists, eager=None):
    """Run ``step`` on the card over ``arg_lists``, recording for each the
    state before it, the metrics and the params after, and its time.  With
    ``eager`` = (body, on_card, states, tag): after each step the eager body
    runs on each of two more states, each given the captured state's values
    from before the step, on the same arguments on the card, and the
    captured step is held to them (``_same_or_close``): bit for bit where
    the two eager runs agree bit for bit in every output (metrics,
    parameters, moments), else within tolerance.  Its cases and largest
    errors are returned as ``verdicts`` (empty without ``eager``)."""
    records, ms, verdicts = [], [], []
    for args in arg_lists:
        before = ({k: v.detach().cpu().clone() for k, v in state.model.state_dict().items()},
                  copy.deepcopy(state.optimizer.state_dict()), state.step, state.updates)
        pre = [t.clone() for t in state.tensors()]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, m = step(state, *args)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
        if eager is not None:
            body, on_card, (first, second), tag = eager
            dev = on_card(args)
            outs = []
            for other in (first, second):
                for dst, src in zip(other.tensors(), pre):
                    dst.copy_(src)
                outs.append({**body(other, dev), **_state_tensors(other)})
            bitwise = all(torch.equal(outs[0][k], outs[1][k]) for k in outs[0])
            opts = [s.optimizer for s in (state, first, second)]
            verdicts.append((
                _same_or_close(torch, m, *({k: o[k] for k in m} for o in outs), METRIC_RTOL,
                               METRIC_ATOL, f"{tag} metrics", bitwise=bitwise),
                _same_or_close(torch, *({"params": o.flat} for o in opts), PARAM_RTOL,
                               PARAM_ATOL, f"{tag} params", bitwise=bitwise),
                _same_or_close(torch, *(dict(o.moments) for o in opts), 0.0, 0.0,
                               f"{tag} momentum", scale=MOMENTUM_SCALE, bitwise=bitwise),
                max(float((outs[0][k] - outs[1][k]).abs().max()) for k in outs[0]),
                max(float((outs[0][k] - outs[1][k]).abs().max() / outs[0][k].abs().max())
                    for k in first.optimizer.moments)))
        records.append((args, before, {k: float(v) for k, v in m.items()},
                        {k: v.detach().cpu().clone() for k, v in state.model.state_dict().items()}))
    return state, records, ms, verdicts


def _state_tensors(state) -> dict:
    """A flat-optimiser state's parameters and moments, by name."""
    return {"params": state.optimizer.flat, **state.optimizer.moments}


def _same_or_close(torch, got: dict, want: dict, again: dict, rtol: float, atol: float,
                   what: str, scale: float = 0.0, bitwise=None):
    """A captured result ``got`` against the eager ``want`` (dicts of
    tensors), where ``again`` is a second eager run of the same work: bit
    for bit if the two eager runs agree bit for bit ("bitwise"; or as
    ``bitwise`` says, where the caller judged more outputs of the same
    runs), else within atol + rtol·|want| + scale·max|want| ("tolerance");
    raises otherwise.  Returns (case, max abs err)."""
    if bitwise is None:
        bitwise = all(torch.equal(want[k], again[k]) for k in want)
    case, err = ("bitwise" if bitwise else "tolerance"), 0.0
    for k, w in want.items():
        g = got[k].to(w.device)
        diff = (g - w).abs()
        err = max(err, float(diff.max()) if diff.numel() else 0.0)
        bound = atol + rtol * w.abs() + (scale * w.abs().max() if w.numel() else 0.0)
        if (not torch.equal(g, w)) if bitwise else bool((diff > bound).any()):
            raise AssertionError(f"{what}: {k} captured vs eager ({case}) max abs err {err:.3e}")
    return case, err


def _verdict_cases(verdicts) -> list:
    return sorted({c for v in verdicts for c, _ in v[:3]})


def _verdict_text(verdicts) -> str:
    """The cases and largest errors of ``_recorded_steps``' comparisons."""
    errs = [max(v[i][1] for v in verdicts) for i in range(3)]
    cases = [sorted({v[i][0] for v in verdicts}) for i in range(3)]
    spread = max(v[3] for v in verdicts)
    share = max(v[4] for v in verdicts)
    return (f"bit for bit where two eager runs agree bit for bit, else within tolerance: "
            f"metrics {'/'.join(cases[0])} (rtol={METRIC_RTOL}, atol={METRIC_ATOL}) max abs "
            f"err {errs[0]:.3e}, params {'/'.join(cases[1])} (rtol={PARAM_RTOL}, "
            f"atol={PARAM_ATOL}) {errs[1]:.3e}, momentum {'/'.join(cases[2])} "
            f"({MOMENTUM_SCALE} x its largest element) {errs[2]:.3e}; two eager runs apart by "
            f"{spread:.3e} at most, their momentum by {share:.3e} of its largest element")


def _captured_step_profile(torch, tag: str, state, step, args) -> dict:
    """One more captured step under the profiler: it must be one host
    launch (the replay)."""
    prof = profile_run(lambda: step(state, *args))
    log(f"{tag} profile of one captured step: {json.dumps(prof)}")
    if prof["host_launches"] != 1:
        raise AssertionError(f"{tag} a captured step made {prof['host_launches']} host "
                             f"launches, not 1")
    return prof


def phase_classifier(torch, FM):
    """Phase 20: the stage-2 object classifier at ClassifierConfig()
    capacities (512 points, 64 objects, 8192 edges) and widths, batch 8:
    3 SGD steps on the card, each a replay of one captured CUDA graph (one
    model call for the batch), held to the eager body on the card (bit for
    bit where the eager step repeats itself bit for bit, else within the
    CPU replay's tolerances, the momentum, a step's gradient, within
    MOMENTUM_SCALE of its largest element), one host launch a step, and
    each replayed on the CPU from the card's state before it."""
    from graph_neural_network_for_radar_perception_torch.models import classifier as CL

    del FM
    ccfg = CL.ClassifierConfig()
    batches = classifier_batches(ccfg, CLASSIFIER_STEPS)
    occupancy = [(int(b.point_mask.sum()), int(b.edge_mask.sum()), int(b.object_mask.sum()))
                 for b in batches]
    init, step, _ = CL.make_classifier_train_step(ccfg)
    state, first, second = (init(torch.Generator().manual_seed(0), device="cuda")
                            for _ in range(3))
    state, records, ms, verdicts = _recorded_steps(
        torch, state, step, [(b,) for b in batches],
        eager=(step.captured.body, lambda args: args[0].to("cuda"), (first, second),
               "[classifier]"))
    metrics = [r[2] for r in records]
    cap = step.captured
    log(f"[classifier] ObjectClassifierGNN(ClassifierConfig()) batch {CLASSIFIER_BATCH}, "
        f"{CLASSIFIER_STEPS} steps on the card, one captured CUDA graph ({len(cap.graphs)} "
        f"capture, {cap.replays} replays, {cap.warmups} warm-up runs): (points, edges, "
        f"objects) per batch {occupancy}; metrics {json.dumps(metrics)}; ms/step "
        f"{[round(t, 3) for t in ms]}; captured vs the eager body on the card: "
        f"{_verdict_text(verdicts)}")
    if any(m["skipped"] for m in metrics) or not all(np.isfinite(m["loss_obj_cls"])
                                                     for m in metrics):
        raise AssertionError("[classifier] a step was skipped or its loss is not finite")
    if cap.replays != CLASSIFIER_STEPS or len(cap.graphs) != 1:
        raise AssertionError("[classifier] the step was not one captured graph replayed a step")
    t0 = time.perf_counter()
    m_err, p_err = _replay(torch, records, lambda: init(device="cpu"), step, "[classifier]")
    log(f"[classifier] CPU replay of each step from the card's state before it "
        f"({time.perf_counter() - t0:.1f} s): metrics max abs err {m_err:.3e} "
        f"(rtol={METRIC_RTOL}, atol={METRIC_ATOL}), params {p_err:.3e} (rtol={PARAM_RTOL}, "
        f"atol={PARAM_ATOL})")
    prof = _captured_step_profile(torch, "[classifier]", state, step, (batches[0],))
    return {"ms": ms, "kernels": prof["device_kernels"], "host_launches": prof["host_launches"],
            "cases": _verdict_cases(verdicts)}


def phase_cnn(torch, FM):
    """Phase 21: the BEV-grid CNN at CNNConfig() full width on the default
    GridSpec (200 × 200 cells), batch 2, TF32 off: grid samples built on the
    card (``data/grid.build_grid_sample``) against the CPU's, 2 SGD steps on
    the card, each a replay of one captured CUDA graph held to the eager
    body on the card (bit for bit where the eager step repeats itself bit
    for bit, else within the CPU replay's tolerances and the momentum
    within MOMENTUM_SCALE of its largest element: cuDNN's weight-gradient
    algorithms need not repeat themselves), one host
    launch a step, the first replayed on the CPU from the card's state
    before it."""
    from graph_neural_network_for_radar_perception_torch.config.config import GNNConfig
    from graph_neural_network_for_radar_perception_torch.data import features as F
    from graph_neural_network_for_radar_perception_torch.data import groundtruth as G
    from graph_neural_network_for_radar_perception_torch.data import grid as GR
    from graph_neural_network_for_radar_perception_torch.data.labels import INVALID_NUM
    from graph_neural_network_for_radar_perception_torch.models import cnn as CNN

    del FM
    if torch.backends.cudnn.allow_tf32 or torch.backends.cuda.matmul.allow_tf32:
        raise AssertionError("[cnn] TF32 must be off for f32 results")
    cfg, spec, ccfg = GNNConfig(), GR.GridSpec(), CNN.CNNConfig()
    samples, worst = [], 0.0
    for i, data in enumerate(deploy_frames(cfg, CNN_BATCH)):
        gt = G.compute_ground_truth_node(data)
        data, gt = F.select_within_roi(data, gt, cfg.min_x, cfg.max_x, cfg.min_y, cfg.max_y)
        got = GR.build_grid_sample(spec, data, gt, CNN_MAX_MEAS, device="cuda")
        want = GR.build_grid_sample(spec, data, gt, CNN_MAX_MEAS, device="cpu")
        for k in ("vr", "rcs", "offset_grid", "label_grid"):
            if not np.array_equal(got[k], want[k]):
                raise AssertionError(f"[cnn] frame {i}: grid {k} card vs CPU differ")
        err = np.abs(got["image"] - want["image"])
        worst = max(worst, float(err.max()))
        if (err > DEPLOY_ATOL + DEPLOY_RTOL * np.abs(want["image"])).any():
            raise AssertionError(f"[cnn] frame {i}: grid image card vs CPU beyond tolerance")
        samples.append(got)
    batch = tuple(np.stack([s[k] for s in samples]) for k in
                  ("image", "vr", "rcs", "label_grid", "offset_grid"))
    cells = [int((s["label_grid"] != INVALID_NUM).sum()) for s in samples]
    log(f"[cnn] build_grid_sample on the card (200 x 200 cells, {CNN_MAX_MEAS} measurements): "
        f"grids equal to the CPU's, image max abs err {worst:.3e}; occupied cells {cells}")
    init, step, _ = CNN.make_grid_train_step(ccfg)
    state, first, second = (init(torch.Generator().manual_seed(0), device="cuda")
                            for _ in range(3))
    n_params = sum(p.numel() for p in state.model.parameters())
    state, records, ms, verdicts = _recorded_steps(
        torch, state, step, [batch] * CNN_STEPS,
        eager=(step.captured.body, lambda args: [torch.from_numpy(a).cuda() for a in args],
               (first, second), "[cnn]"))
    metrics = [r[2] for r in records]
    cap = step.captured
    log(f"[cnn] GridDetector(CNNConfig()) ({n_params} parameters) batch {CNN_BATCH}, "
        f"{CNN_STEPS} steps on the card, TF32 off, one captured CUDA graph ({len(cap.graphs)} "
        f"capture, {cap.replays} replays, {cap.warmups} warm-up runs): metrics "
        f"{json.dumps(metrics)}; ms/step {[round(t, 3) for t in ms]} (the first with the "
        f"capture); captured vs the eager body on the card: {_verdict_text(verdicts)}")
    if any(m["skipped"] or not np.isfinite(m["loss_total"]) for m in metrics):
        raise AssertionError("[cnn] a step was skipped or its loss is not finite")
    if cap.replays != CNN_STEPS or len(cap.graphs) != 1:
        raise AssertionError("[cnn] the step was not one captured graph replayed a step")
    t0 = time.perf_counter()
    m_err, p_err = _replay(torch, records[:1], lambda: init(device="cpu"), step, "[cnn]")
    log(f"[cnn] CPU replay of step 1 from the card's state before it "
        f"({time.perf_counter() - t0:.1f} s): metrics max abs err {m_err:.3e} "
        f"(rtol={METRIC_RTOL}, atol={METRIC_ATOL}), params {p_err:.3e} (rtol={PARAM_RTOL}, "
        f"atol={PARAM_ATOL})")
    prof = _captured_step_profile(torch, "[cnn]", state, step, batch)
    return {"ms": ms, "kernels": prof["device_kernels"], "host_launches": prof["host_launches"],
            "cases": _verdict_cases(verdicts)}


def phase_eval_step(torch, FM):
    """Phase 21b: the trainer's eval step (``train/steps.make_eval_step``)
    at GNNConfig() full width, batch 8, with each message pass:
    ``trainer.train`` for EVAL_STEP_TRAIN steps with a validation of
    EVAL_STEP_VAL batches after each, so that the eval step is captured at
    the first validation and replayed at the second, after a train step
    changed the weights in place.  Checks: one capture, its replays, 7
    round-kernel launches a replay; the means the trainer wrote at the last
    validation against the eager body's on the final weights, and each
    replay against the eager body, bit for bit where two eager runs agree
    bit for bit (else within METRIC_*); the weights' change seen; one host
    launch a validation batch; ms a validation batch, captured and eager."""
    from graph_neural_network_for_radar_perception_torch.config.config import GNNConfig
    from graph_neural_network_for_radar_perception_torch.core import capture as CP
    from graph_neural_network_for_radar_perception_torch.data.pipeline import SyntheticRadarDataset
    from graph_neural_network_for_radar_perception_torch.ops import csr_mp as C
    from graph_neural_network_for_radar_perception_torch.train import steps as S
    from graph_neural_network_for_radar_perception_torch.train import trainer as TR
    from graph_neural_network_for_radar_perception_torch.utils.metrics_writer import RunningMeans

    out = {}
    for mp_impl in (None, "csr"):
        tag = "[eval-step]" if mp_impl is None else "[eval-step-csr]"
        cfg = GNNConfig() if mp_impl is None else GNNConfig(mp_impl=mp_impl)
        rounds, bsz = len(cfg.graph_convolution_stem_channels), cfg.batch_size
        kernel = C.fused_message_pass_csr if mp_impl else FM.fused_message_pass
        gen = SyntheticRadarDataset(cfg, seed=19, num_objects=(6, 10)).batches(bsz)
        train_batches = [next(gen) for _ in range(EVAL_STEP_TRAIN)]
        val = [next(gen) for _ in range(EVAL_STEP_VAL)]
        made, written, real = [], [], TR.make_eval_step

        class Writer:
            def write_train_val(self, step, train, val_means):
                written.append((step, val_means))

        def recorded(c):
            made.append(real(c))
            return made[-1]

        state = S.create_train_state(cfg, torch.Generator().manual_seed(0), device="cuda")
        _restore_counts(FM, C, dict.fromkeys(_counts(FM, C), 0))
        TR.make_eval_step = recorded
        try:
            state = TR.train(cfg, iter(train_batches), lambda: iter(val),
                             hooks=TR.TrainHooks(log_period=10**9, val_period=1,
                                                 num_val_batches=EVAL_STEP_VAL, writer=Writer(),
                                                 print_fn=lambda line: None),
                             state=state, max_iters=EVAL_STEP_TRAIN)
            torch.cuda.synchronize()
        finally:
            TR.make_eval_step = real
        launches = _counts(FM, C)
        ev, cap = made[0], made[0].captured
        replays = EVAL_STEP_TRAIN * EVAL_STEP_VAL
        key = "csr_mp_forward" if mp_impl else "fused_mp_forward"
        want = rounds * (CP.CapturedStep.WARMUP_RUNS + EVAL_STEP_TRAIN) + rounds * (
            CP.CapturedGraphs.WARMUP_RUNS + replays)
        if (len(cap.graphs) != 1 or cap.replays != replays
                or cap.warmups != CP.CapturedGraphs.WARMUP_RUNS or launches[key] != want):
            raise AssertionError(f"{tag} the eval step ran other than one capture and "
                                 f"{replays} replays ({key} launches {launches[key]}, "
                                 f"expected {want})")
        n_replays = cap.replays
        # The last validation's means (replays on the weights after the last
        # train step) against the eager body on those weights.
        saved = _counts(FM, C)
        first, second = RunningMeans(), RunningMeans()
        eager = [ev.body(state.model, S.batch_on(vb, "cuda")) for vb in val]
        again = [ev.body(state.model, S.batch_on(vb, "cuda")) for vb in val]
        for m, rm in ((eager, first), (again, second)):
            for x in m:
                rm.update({k: float(v) for k, v in x.items()})
        to_t = lambda d: {k: torch.tensor(v, dtype=torch.float64) for k, v in d.items()}  # noqa: E731
        means_case, means_err = _same_or_close(torch, to_t(written[-1][1]), to_t(first.means()),
                                               to_t(second.means()), METRIC_RTOL, METRIC_ATOL,
                                               f"{tag} the trainer's validation means")
        _restore_counts(FM, C, saved)
        moved = written[0][1]["loss_total"] != written[-1][1]["loss_total"]
        # One replay a validation batch: launches, host launches, bits.
        cases, err = set(), 0.0
        for i, vb in enumerate(val):
            before = kernel.launches
            got = ev(state.model, vb)
            per_replay = kernel.launches - before
            if per_replay != rounds:
                raise AssertionError(f"{tag} a replay launched {per_replay} round kernels")
            saved = _counts(FM, C)
            case, e = _same_or_close(torch, got, eager[i], again[i], METRIC_RTOL, METRIC_ATOL,
                                     f"{tag} batch {i}")
            _restore_counts(FM, C, saved)
            cases.add(case)
            err = max(err, e)
        prof = profile_run(lambda: ev(state.model, val[0]))
        saved = _counts(FM, C)
        dev = S.batch_on(val[0], "cuda")
        times = {}
        for name, fn in (("captured", lambda: ev(state.model, val[0])),
                         ("eager", lambda: ev.body(state.model, dev))):
            ts = []
            for _ in range(EVAL_STEP_TIMED):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                fn()
                torch.cuda.synchronize()
                ts.append((time.perf_counter() - t0) * 1e3)
            times[name] = float(np.median(ts))
        eager_prof = profile_run(lambda: ev.body(state.model, dev))
        _restore_counts(FM, C, saved)
        log(f"{tag} trainer.train(GNNConfig({'' if mp_impl is None else 'mp_impl=csr'})) batch "
            f"{bsz}, {EVAL_STEP_TRAIN} steps, a validation of {EVAL_STEP_VAL} batches after each: "
            f"the eval step one capture ({cap.warmups} warm-up runs), {n_replays} replays; "
            f"{key} launches {launches[key]} (expected {rounds} x ({CP.CapturedStep.WARMUP_RUNS} "
            f"+ {EVAL_STEP_TRAIN}) for the train step + {rounds} x "
            f"({CP.CapturedGraphs.WARMUP_RUNS} + {replays}) for the eval step = {want}), "
            f"{rounds} a replay; the trainer's last validation means vs the eager body on the "
            f"final weights: {means_case} (max abs err {means_err:.3e}), loss_total moved "
            f"between the validations {moved} ({written[0][1]['loss_total']!r} -> "
            f"{written[-1][1]['loss_total']!r}); each replay vs the eager body: "
            f"{'/'.join(sorted(cases))} (max abs err {err:.3e}); ms a validation batch (host "
            f"clock, synchronised, median of {EVAL_STEP_TIMED}): captured {times['captured']:.3f}, "
            f"eager {times['eager']:.3f}; one captured call: {prof['host_launches']} host "
            f"launches, {prof['device_kernels']} device kernels, busy "
            f"{prof['device_busy_ms']:.3f} ms; eager: {eager_prof['host_launches']} host "
            f"launches, {eager_prof['device_kernels']} device kernels")
        if prof["host_launches"] != 1 or not moved:
            raise AssertionError(f"{tag} a validation batch made {prof['host_launches']} host "
                                 f"launches, or the new weights were not seen")
        out["csr" if mp_impl else "fused"] = dict(launches, ms=times["captured"],
                                                  eager_ms=times["eager"],
                                                  kernels=prof["device_kernels"],
                                                  host_launches=prof["host_launches"],
                                                  cases=sorted(cases | {means_case}))
    return out


def _counts(FM, C) -> dict:
    return {"fused_mp_forward": FM.fused_message_pass.launches,
            "fused_mp_backward": FM.fused_message_pass_backward.launches,
            "csr_mp_forward": C.fused_message_pass_csr.launches,
            "csr_mp_backward": C.fused_message_pass_csr_backward.launches}


def _restore_counts(FM, C, saved: dict) -> None:
    FM.fused_message_pass.launches = saved["fused_mp_forward"]
    FM.fused_message_pass_backward.launches = saved["fused_mp_backward"]
    C.fused_message_pass_csr.launches = saved["csr_mp_forward"]
    C.fused_message_pass_csr_backward.launches = saved["csr_mp_backward"]


def _within(name: str, got, want, rtol: float, atol: float) -> float:
    """Max abs error of ``got`` (card) against ``want``; raises beyond the
    tolerance or on a value that is not finite."""
    err = (got.cpu() - want.cpu()).abs()
    bad = int((err > atol + rtol * want.cpu().abs()).sum())
    if bad or not bool(got.isfinite().all()):
        raise AssertionError(f"{name}: disagrees with its plain version at {bad} elements")
    return float(err.max())


def phase_shard_rounds(torch, FM, C, batch) -> dict:
    """The message kernels at the shapes the edge-sharded modes give them:
    rank (0, g)'s edge shard of graph 0 on a 2 x 2 grid (E/2 edges, the
    real shard's senders and receivers, sentinel N where masked), a random
    round at the main path's widths on those edges.  Forward: the wrapper on
    the card against the same call on CPU tensors (the plain version),
    RTOL/ATOL; backward: the backward wrapper against its plain version,
    GRAD_*, kink edges dropped as in [kernel-bwd].  Launches made here do
    not count."""
    from graph_neural_network_for_radar_perception_torch.parallel.mesh import (
        batch_rows, edge_shard)

    saved = _counts(FM, C)
    rng = np.random.default_rng(31)
    rows, worst = batch_rows(batch, 2, 0), {}
    for g in range(2):
        sh = edge_shard(rows, 2, g).graph
        live = sh.edge_mask[0]
        s = np.where(live, sh.senders[0], N).astype(np.int32)
        r = np.where(live, sh.receivers[0], N).astype(np.int32)
        e = s.shape[0]
        cot = torch.from_numpy((G_SCALE * rng.normal(size=(N, D2))).astype(np.float32)).cuda()

        args = kernel_problem(torch, rng, e, e, edges=(s, r))
        fwd = _within(f"[parallel] fused_message_pass on shard {g}", FM.fused_message_pass(*args),
                      FM.fused_message_pass(*[a.cpu() for a in args]), RTOL, ATOL)
        args, kinks = drop_kink_edges(torch, args)
        bwd = max(_within(f"[parallel] fused_message_pass_backward {out} on shard {g}", a, b,
                          GRAD_RTOL, GRAD_ATOL)
                  for out, a, b in zip(FUSED_BWD_NAMES,
                                       FM.fused_message_pass_backward(*args, cot),
                                       FM.fused_message_pass_backward_reference(*args, cot)))
        worst[f"fused shard {g}"] = {"live": int(live.sum()), "fwd": fwd, "bwd": bwd,
                                     "kink edges dropped": kinks}

        # The CSR round walks the edges reversed: dst = senders (sorted).
        # A shard holds half of each reversed pair, so the model's guards
        # apply (``GraphConvolution._csr_guard``), not ``csr_contract_ok``.
        args = csr_problem(torch, rng, (s[live], r[live]), e)
        if int(C.order_violations(args[3], N)) or int(C.window_span_violations(
                args[3], N, CSR_TILE, CSR_WINDOW)):
            raise AssertionError(f"[parallel] shard {g} breaks the CSR round's contract")
        tiling = (0.01, CSR_TILE, CSR_WINDOW)
        fwd = _within(f"[parallel] fused_message_pass_csr on shard {g}",
                      C.fused_message_pass_csr(*args, *tiling),
                      C.fused_message_pass_csr(*[a.cpu() for a in args], *tiling), RTOL, ATOL)
        args, kinks = drop_kink_edges_csr(torch, args)
        bwd = max(_within(f"[parallel] fused_message_pass_csr_backward {out} on shard {g}",
                          a, b, GRAD_RTOL, GRAD_ATOL)
                  for out, a, b in zip(CSR_BWD_NAMES,
                                       C.fused_message_pass_csr_backward(*args, cot, *tiling, 0),
                                       C.fused_message_pass_csr_backward_reference(
                                           *args, cot, *tiling, 0)))
        worst[f"csr shard {g}"] = {"live": int(live.sum()), "fwd": fwd, "bwd": bwd,
                                   "kink edges dropped": kinks}
    _restore_counts(FM, C, saved)
    log(f"[parallel] each round kernel on rank (0, g)'s edge shard of graph 0 ({E // 2} edges, "
        f"N={N}, De={DE}, H={H}, D2={D2}) against its plain version: forward within "
        f"rtol={RTOL} atol={ATOL}, backward within rtol={GRAD_RTOL} atol={GRAD_ATOL}; max abs "
        f"err {json.dumps(worst)}")
    return worst


def phase_parallel(torch, FM):
    """Phase 22: ``parallel/`` on the card.  At GNNConfig() full width, batch
    8, from seeded weights, the port's worker (``parallel/worker.launch_spec``):
    4 ranks started once, all on this card under gloo (CUDA tensors; a
    FileStore rendezvous), run data parallelism 4 × 1, the edge-sharded step
    2 × 2 with the fused round and with the CSR round (each rank's message
    kernels on its edge shard) and the halo step 2 × 2 on spatially sorted
    frames (plain rounds, no kernel); then one rank under NCCL runs data
    parallelism 1 × 1.  Each mode against the single-process
    ``make_train_step`` on the card from the same weights and batch
    (PARALLEL_*), its first step replayed on the CPU with the plain rounds
    from the same weights and batch (METRIC_*/PARAM_*), every rank's params
    bitwise equal, launches per rank and ms per step; and the round kernels
    on the edge shards' own inputs against their plain versions
    (``phase_shard_rounds``)."""
    import dataclasses

    from graph_neural_network_for_radar_perception_torch.config.config import GNNConfig
    from graph_neural_network_for_radar_perception_torch.core import capture as CP
    from graph_neural_network_for_radar_perception_torch.data.pipeline import SyntheticRadarDataset
    from graph_neural_network_for_radar_perception_torch.models.gnn import RadarGNN
    from graph_neural_network_for_radar_perception_torch.ops import csr_mp as C
    from graph_neural_network_for_radar_perception_torch.parallel import worker as PW
    from graph_neural_network_for_radar_perception_torch.parallel.halo import halo_width
    from graph_neural_network_for_radar_perception_torch.train import steps as S
    from graph_neural_network_for_radar_perception_torch.train.loss import LossSums

    base = GNNConfig(batch_size=PARALLEL_BATCH)
    rounds = len(base.graph_convolution_stem_channels)
    batch = next(SyntheticRadarDataset(base, seed=29, num_objects=(6, 10)).batches(PARALLEL_BATCH))
    sorted_batch = next(SyntheticRadarDataset(dataclasses.replace(base, spatial_sort=True),
                                              seed=29, num_objects=(6, 10)).batches(PARALLEL_BATCH))
    model = RadarGNN(base, generator=torch.Generator().manual_seed(5))
    weights = model.state_dict()
    # A data-parallel step's all-reduces: the 11 LossSums and the flat gradient, f32.
    dp_bytes = (len(LossSums._fields) + sum(p.numel() for p in model.parameters())) * 4
    log(f"[parallel] GNNConfig() batch {PARALLEL_BATCH}, {PARALLEL_STEPS} steps a mode; live "
        f"edges per graph {[int(m.sum()) for m in batch.graph.edge_mask]} of {base.max_edges} "
        f"(G = 2: {base.max_edges // 2} an edge shard); halo {halo_width(sorted_batch, 2)} rows "
        f"of {base.max_nodes // 2} a member on the sorted frames")
    shard_err = phase_shard_rounds(torch, FM, C, batch)

    def mode_of(name, kind, n_graph, mp_impl):
        return {"name": name, "n_graph": n_graph, "partition": kind, "steps": PARALLEL_STEPS,
                "cfg": dataclasses.replace(base, mp_impl=mp_impl) if mp_impl else base,
                "weights": weights, "batch": sorted_batch if kind == "halo" else batch,
                "profile": True}

    # The single-process step on the card from the same weights: the
    # reference of every mode (its launches are not the grid's).
    refs, ref_ms = {}, {}
    saved = _counts(FM, C)
    for name, kind, _, n_graph, mp_impl in PARALLEL_MODES:
        mode = mode_of(name, kind, n_graph, mp_impl)
        st = S.create_train_state(mode["cfg"], device="cuda")
        st.model.load_state_dict(weights)
        st, recs, ms, _ = _recorded_steps(torch, st, S.make_train_step(mode["cfg"]),
                                          [(mode["batch"],)] * PARALLEL_STEPS)
        refs[name], ref_ms[name] = [(r[2], r[3]) for r in recs], ms
    _restore_counts(FM, C, saved)

    totals = {"fused_mp_forward": 0, "fused_mp_backward": 0, "csr_mp_forward": 0,
              "csr_mp_backward": 0}
    replays = {}  # step 1 on the CPU, plain rounds, per (batch, round)
    env = dict(os.environ)
    env.setdefault("NCCL_SOCKET_IFNAME", "lo")  # one host: the bootstrap binds the loopback
    for world, backend in ((4, "gloo"), (1, "nccl")):
        grid = [m for m in PARALLEL_MODES if m[2] * m[3] == world]
        t0 = time.perf_counter()
        ranks = PW.launch_spec({"modes": [mode_of(name, kind, n_graph, mp_impl)
                                          for name, kind, _, n_graph, mp_impl in grid]},
                               world, device="cuda", backend=backend, timeout=PARALLEL_JOIN_S,
                               env=env)
        log(f"[parallel] {world} rank(s) of the worker on {card()} under {backend}: "
            f"{time.perf_counter() - t0:.1f} s from start to the last rank's exit")
        for name, kind, n_data, n_graph, mp_impl in grid:
            res = [r[name] for r in ranks]
            # The step is one captured CUDA graph under NCCL, eager under gloo:
            # a capture adds its warm-up runs to the step that makes it.
            captured = backend == "nccl"
            # every rank runs each round once a step (and a warm-up run) for
            # the graphs of its rows
            want = 0 if kind == "halo" else rounds * (PARALLEL_STEPS + res[0]["warmups"])
            # collectives a step: the rounds' psums forward and backward, the
            # LossSums and the flat gradient (data parallel: the last two)
            calls = {"dp": 2, "edge": 2 * rounds + 2}.get(kind)
            kernels = ("csr_mp_forward", "csr_mp_backward") if mp_impl == "csr" else (
                "fused_mp_forward", "fused_mp_backward")
            for r, x in enumerate(res):
                got = x["launches"]
                if any(got[k] != (want if k in kernels else 0) for k in got):
                    raise AssertionError(f"[parallel] {name} rank {r}: launches {got}, "
                                         f"expected {want} of {kernels} and no other")
                for k in totals:
                    totals[k] += got[k]
                if x["backend"] != backend or x["warmups"] != (
                        CP.CapturedStep.WARMUP_RUNS if captured else 0) or any(
                        rec["captured"] != captured
                        or rec["host_launches"] != (1 if captured else None)
                        for rec in x["records"]):
                    raise AssertionError(
                        f"[parallel] {name} rank {r}: backend {x['backend']}, captured "
                        f"{[rec['captured'] for rec in x['records']]}, host launches "
                        f"{[rec['host_launches'] for rec in x['records']]}, warm-ups "
                        f"{x['warmups']}; expected {backend}, "
                        f"{'one replay a step' if captured else 'eager steps'}")
                runs = [1 + rec["warmups"] for rec in x["records"]]
                if calls is not None and any(rec["all_reduces"] != calls * n
                                             for rec, n in zip(x["records"], runs)):
                    raise AssertionError(f"[parallel] {name} rank {r}: collectives a step "
                                         f"{[rec['all_reduces'] for rec in x['records']]}, "
                                         f"expected {calls} a run of the body, {runs} runs")
                if kind == "dp" and any(
                        rec["collectives"] != {k: {"calls": 2 * n if k == "all_reduce" else 0,
                                                   "bytes": dp_bytes * n if k == "all_reduce"
                                                   else 0} for k in rec["collectives"]}
                        for rec, n in zip(x["records"], runs)):
                    raise AssertionError(f"[parallel] {name} rank {r}: collectives by kind "
                                         f"{[rec['collectives'] for rec in x['records']]}, "
                                         f"expected 2 all-reduces of {dp_bytes} B a run")
                for i, rec in enumerate(x["records"]):
                    first = res[0]["records"][i]
                    if rec["metrics"] != first["metrics"] or any(
                            not torch.equal(v, first["params"][k])
                            for k, v in rec["params"].items()):
                        raise AssertionError(f"[parallel] {name} step {i}: rank {r}'s "
                                             f"params or metrics differ from rank 0's")
            records = res[0]["records"]
            if any(rec["metrics"]["skipped"] for rec in records):
                raise AssertionError(f"[parallel] {name}: a step was skipped")
            m_err, p_err = 0.0, 0.0
            for i, (want_m, want_p) in enumerate(refs[name]):
                got_m, got_p = records[i]["metrics"], records[i]["params"]
                for k, v in want_m.items():
                    m_err = max(m_err, abs(got_m[k] - v))
                    if abs(got_m[k] - v) > PARALLEL_ATOL + PARALLEL_RTOL * abs(v):
                        raise AssertionError(f"[parallel] {name} step {i}: {k} grid "
                                             f"{got_m[k]} single {v}")
                for k, v in want_p.items():
                    err = (got_p[k] - v).abs()
                    p_err = max(p_err, float(err.max()))
                    if (err > PARALLEL_ATOL + PARALLEL_RTOL * v.abs()).any():
                        raise AssertionError(f"[parallel] {name} step {i}: params {k} "
                                             f"grid vs single beyond tolerance")
            # Step 1 against the plain rounds on the CPU (the same weights
            # and batch), replayed once per batch and round.
            key = ("halo" if kind == "halo" else "batch", mp_impl)
            if key not in replays:
                mode = mode_of(name, kind, n_graph, mp_impl)
                t1 = time.perf_counter()
                cpu = S.create_train_state(mode["cfg"], device="cpu")
                cpu.model.load_state_dict(weights)
                cpu, m = S.make_train_step(mode["cfg"])(cpu, mode["batch"])
                replays[key] = ({k: float(v) for k, v in m.items()},
                                {k: v.detach().clone() for k, v in cpu.model.state_dict().items()},
                                time.perf_counter() - t1)
            cpu_m, cpu_p, cpu_s = replays[key]
            r_m = _metrics_close([records[0]["metrics"]], [cpu_m], f"[parallel] {name} step 0")
            r_p = _params_close(records[0]["params"], cpu_p, f"[parallel] {name} step 0")
            ms = [[round(rec["ms"], 3) for rec in x["records"]] for x in res]
            blocked = [[(rec["all_reduces"], None if rec["all_reduce_ms"] is None
                         else round(rec["all_reduce_ms"], 3))
                        for rec in x["records"]] for x in res]
            # each kind's calls and bytes a run of the body, rank 0's last step
            last = res[0]["records"][-1]
            kinds = {k: {f: v[f] // (1 + last["warmups"]) for f in v}
                     for k, v in last["collectives"].items() if v["calls"]}
            prof_launches = (res[0]["profile"] or {}).get("host_launches")
            if captured and prof_launches != 1:
                raise AssertionError(f"[parallel] {name}: the profiled replay made "
                                     f"{prof_launches} host launches")
            log(f"[parallel] {name} ({n_data} x {n_graph}, {backend}"
                f"{', ' + mp_impl if mp_impl else ''}): "
                f"{'captured, one replay a step' if captured else 'eager'}; ms a step "
                f"{[round(t, 3) for t in ms[0]]} (step 1 with "
                f"{'the capture' if captured else 'set-up'}) beside the single-process step "
                f"of this run {[round(t, 3) for t in ref_ms[name]]}; host launches a step "
                f"{[rec['host_launches'] for rec in res[0]['records']]} (profiled step: "
                f"{prof_launches}); collectives by kind a "
                f"{'replay' if captured else 'step'}, calls and bytes handed over: "
                f"{json.dumps(kinds)}")
            log(f"[parallel] {name} ({n_data} x {n_graph}, {backend}"
                f"{', ' + mp_impl if mp_impl else ''}): launches per rank "
                f"{json.dumps([x['launches'] for x in res])} (expected {want} of each round "
                f"kernel: {'the halo round is plain' if kind == 'halo' else 'one a round a step'} "
                f"for the rank's {PARALLEL_BATCH // n_data} graphs); "
                f"all-reduces a step {'(expected ' + str(calls) + ') ' if calls else ''}"
                f"and the host ms blocked in them below; ranks' params bitwise equal "
                f"after every step; vs the single-process step (ms/step "
                f"{[round(t, 3) for t in ref_ms[name]]}): metrics max abs err {m_err:.3e}, "
                f"params {p_err:.3e} (rtol={PARALLEL_RTOL}, atol={PARALLEL_ATOL}); step 1 vs "
                f"the plain rounds on the CPU ({cpu_s:.1f} s): metrics {r_m:.3e} "
                f"(rtol={METRIC_RTOL}, atol={METRIC_ATOL}), params {r_p:.3e} "
                f"(rtol={PARAM_RTOL}, atol={PARAM_ATOL}); loss "
                f"{records[0]['metrics']['loss_total']:.4f} -> "
                f"{records[-1]['metrics']['loss_total']:.4f}; ms/step per rank "
                f"(the first with set-up) {ms}; (all_reduce calls, host ms in them) per rank "
                f"and step {blocked}; rank 0's step {PARALLEL_STEPS + 2} "
                f"profiled: {json.dumps(res[0]['profile'])}")
    return dict(totals, shard_err=shard_err)


def _parsed(path: str) -> int:
    """Read a file an entry point wrote: a JSON file, the JSON lines of a
    .jsonl, a ``torch.save``d .pt; its count of records (1 for a file)."""
    import torch

    if path.endswith(".jsonl"):
        with open(path) as f:
            return len([json.loads(line) for line in f])
    if path.endswith(".json"):
        with open(path) as f:
            json.load(f)
    elif path.endswith(".pt"):
        torch.load(path, map_location="cpu", weights_only=True)
    elif path.endswith(".msgpack"):
        from graph_neural_network_for_radar_perception_torch.utils.checkpoint import (
            load_params_msgpack,
        )

        load_params_msgpack(path)
    elif os.path.getsize(path) == 0:
        raise AssertionError(f"{path} is empty")
    return 1


def msgpack_holds_state_dict(torch, msgpack_path: str, pt_path: str) -> bool:
    """Does the flax msgpack file hold the ``torch.save``d state_dict bit
    for bit (the same keys, shapes and bytes), read back through the port's
    ``load_params_msgpack`` and ``state_dict_from_flax``?"""
    from graph_neural_network_for_radar_perception_torch.utils.checkpoint import (
        load_params_msgpack,
    )
    from graph_neural_network_for_radar_perception_torch.utils.convert import (
        state_dict_from_flax,
    )

    got = state_dict_from_flax(load_params_msgpack(msgpack_path))
    want = torch.load(pt_path, map_location="cpu", weights_only=True)
    return set(got) == set(want) and all(torch.equal(got[k], want[k].cpu()) for k in want)


def phase_examples(torch, FM):
    """Phase 23: the user entry points (``examples/``, ``scripts/
    check_decision_equivalence``, ``scripts/train_fixture_artifact``), each
    through its ``main`` on the card at the widths it ships with, for a few
    iterations or frames, into a temporary directory; visualize runs its
    detection half (this script needs no matplotlib).  Checks: each one's
    fused-kernel launches (exact where the run fixes them, whole rounds
    otherwise; no CSR or bf16 launch), step 1 of overfit_gnn replayed on
    the CPU (the plain rounds) within [train]'s tolerance, evaluate's
    confusion JSON and detection matrix on the card equal to the CPU's,
    check_decision_equivalence finding no decision of the card that differs
    from the CPU's, every file written present and parseable; the wall time
    of each."""
    import contextlib
    import importlib
    import tempfile

    from graph_neural_network_for_radar_perception_torch.config.config import GNNConfig
    from graph_neural_network_for_radar_perception_torch.core import capture as CP
    from graph_neural_network_for_radar_perception_torch.ops import csr_mp as C

    def entry(name):
        return importlib.import_module(f"graph_neural_network_for_radar_perception_torch.{name}")

    rounds = len(GNNConfig().graph_convolution_stem_channels)
    results = {}

    def trained(steps):
        """Round launches of ``steps`` train steps through one captured step
        (its warm-up runs and a replay a step), whatever the batch."""
        return rounds * (steps + CP.CapturedStep.WARMUP_RUNS)

    def detected(frames):
        """Round launches of ``frames`` frames through one captured detector
        (its capture's warm-up runs and a replay a frame)."""
        return rounds * (frames + CP.CapturedGraphs.WARMUP_RUNS)

    def run(label, call, fwd, bwd):
        """``call()`` on the card with stdout to stderr; ``fwd``/``bwd``:
        the launches expected (an int) or a predicate of the count."""
        _restore_counts(FM, C, dict.fromkeys(_counts(FM, C), 0))
        FM.fused_message_pass.launches_bf16 = C.fused_message_pass_csr.launches_bf16 = 0
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(sys.stderr):
            out = call()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        got = _counts(FM, C)
        other = (got["csr_mp_forward"] + got["csr_mp_backward"]
                 + FM.fused_message_pass.launches_bf16 + C.fused_message_pass_csr.launches_bf16)
        for key, want in (("fused_mp_forward", fwd), ("fused_mp_backward", bwd)):
            n = got[key]
            ok = want(n) if callable(want) else n == want
            if not ok or other:
                raise AssertionError(f"[examples] {label}: {key} launches {n} "
                                     f"(other kernels {other})")
        results[label] = {"s": round(wall, 3), "fwd": got["fused_mp_forward"],
                          "bwd": got["fused_mp_backward"]}
        log(f"[examples] {label}: {wall:.2f} s on the card; fused_mp_forward "
            f"{got['fused_mp_forward']}, fused_mp_backward {got['fused_mp_backward']}")
        return out

    def rounds_of(lo):
        return lambda n: n >= lo and n % rounds == 0

    cuda = ["--device", "cuda"]
    with tempfile.TemporaryDirectory(prefix="examples_") as tmp:
        def out(name):
            return os.path.join(tmp, name)

        ev = entry("examples.evaluate")
        ev_argv = ["--frames", str(EXAMPLE_FRAMES)]
        card_ev = run("evaluate", lambda: ev.main(ev_argv + ["--out", out("eval")] + cuda),
                      rounds_of(rounds * EXAMPLE_FRAMES), 0)
        with contextlib.redirect_stdout(sys.stderr):
            cpu_ev = ev.main(ev_argv + ["--out", out("eval_cpu"), "--device", "cpu"])
        with open(card_ev["json"]) as f, open(cpu_ev["json"]) as g:
            seg_equal = json.load(f) == json.load(g)
        det_equal = bool((card_ev["detection"].cm == cpu_ev["detection"].cm).all())
        log(f"[examples] evaluate card vs CPU: segmentation JSON equal {seg_equal}, detection "
            f"confusion equal {det_equal} ({int(card_ev['segmentation'].cm.sum())} nodes, "
            f"{int(card_ev['detection'].cm.sum())} objects)")
        if not (seg_equal and det_equal):
            raise AssertionError("[examples] evaluate: the card's confusion differs from the CPU's")

        viz = entry("examples.visualize")
        run("visualize (detect)", lambda: viz.detect(viz.parse_args(
            ["--frames", str(EXAMPLE_FRAMES)] + cuda)), detected(EXAMPLE_FRAMES), 0)

        over = entry("examples.overfit_gnn")
        steps = run("overfit_gnn", lambda: over.main(["--steps", str(EXAMPLE_STEPS)] + cuda),
                    trained(EXAMPLE_STEPS), trained(EXAMPLE_STEPS))
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(sys.stderr):
            cpu_step = over.main(["--steps", "1", "--device", "cpu"])
        err = _metrics_close(steps[:1], cpu_step, "[examples] overfit_gnn step 1")
        log(f"[examples] overfit_gnn step 1 vs the CPU's plain rounds ({time.perf_counter() - t0:.1f}"
            f" s): metrics max abs err {err:.3e} (rtol={METRIC_RTOL}, atol={METRIC_ATOL}; "
            f"loss_total {steps[0]['loss_total']!r} on the card, {cpu_step[0]['loss_total']!r} "
            f"on the CPU); loss {steps[0]['loss_total']:.4f} -> {steps[-1]['loss_total']:.4f}")

        tg = entry("examples.train_gnn")
        tg_argv = ["--out", out("gnn")] + cuda
        run("train_gnn", lambda: tg.main(["--iters", str(EXAMPLE_STEPS)] + tg_argv),
            trained(EXAMPLE_STEPS), trained(EXAMPLE_STEPS))
        state = run("train_gnn --resume", lambda: tg.main(
            ["--iters", str(EXAMPLE_STEPS + 1), "--resume"] + tg_argv), trained(1), trained(1))
        if state.step != EXAMPLE_STEPS + 1:
            raise AssertionError(f"[examples] train_gnn resumed to step {state.step}")

        demo = entry("examples.demo_training_run")
        run("demo_training_run", lambda: demo.main(
            ["--iters", str(EXAMPLE_STEPS), "--eval-frames", str(EXAMPLE_FRAMES),
             "--out", out("demo")] + cuda),
            rounds_of(trained(EXAMPLE_STEPS) + 2 * rounds * EXAMPLE_FRAMES),
            trained(EXAMPLE_STEPS))

        lr = entry("examples.long_training_run")
        # a validation (4 batches through the captured eval step) at step 2
        lr_argv = ["--max-iters", str(EXAMPLE_STEPS + 1), "--pool-batches", "2",
                   "--eval-frames", str(EXAMPLE_FRAMES), "--val-period", str(EXAMPLE_STEPS),
                   "--run-dir", out("long_run")] + cuda
        run("long_training_run --stop-at", lambda: lr.main(
            lr_argv + ["--stop-at", str(EXAMPLE_STEPS)]), rounds_of(1), rounds_of(1))
        state = run("long_training_run (resume, eval trend)", lambda: lr.main(lr_argv),
                    rounds_of(1), rounds_of(1))
        if state.step != EXAMPLE_STEPS + 1:
            raise AssertionError(f"[examples] long_training_run resumed to step {state.step}")

        ft = entry("examples.finetune_obj_classifier")
        # the trunk's backward runs for the finiteness check (ROADMAP C6)
        run("finetune_obj_classifier", lambda: ft.main(
            ["--iters", str(EXAMPLE_STEPS), "--batch-size", "4"] + cuda),
            trained(EXAMPLE_STEPS), trained(EXAMPLE_STEPS))

        tc = entry("examples.train_classifier")
        run("train_classifier --use-detector-proposals", lambda: tc.main(
            ["--iters", str(EXAMPLE_STEPS), "--batch-size", "4", "--use-detector-proposals"]
            + cuda), rounds_of(rounds * (1 + 4 * EXAMPLE_STEPS)), 0)

        ch = entry("examples.classifier_chain")
        run("classifier_chain", lambda: ch.main(
            ["--stage1-iters", str(EXAMPLE_STEPS), "--stage2-iters", str(EXAMPLE_STEPS),
             "--pool-batches", "2", "--n-train-frames", "4", "--n-eval-frames", "4",
             "--out", out("classifier_chain")] + cuda),
            rounds_of(trained(EXAMPLE_STEPS) + rounds * 8), trained(EXAMPLE_STEPS))

        cnn = entry("examples.train_cnn")
        run("train_cnn", lambda: cnn.main(["--iters", str(EXAMPLE_STEPS)] + cuda), 0, 0)

        pw = entry("examples.pointwise_baseline")
        run("pointwise_baseline", lambda: pw.main(
            ["--frames", "8", "--iters", str(EXAMPLE_STEPS), "--out", out("pointwise")] + cuda),
            0, 0)

        dec = entry("scripts.check_decision_equivalence")
        n_cmp = run("check_decision_equivalence (card, then CPU)", lambda: dec.main(cuda),
                    lambda n: n > 0 and n % rounds == 0, 0)
        log(f"[examples] check_decision_equivalence: {n_cmp} frames, every decision of the "
            f"card equal to the CPU's")
        if results["check_decision_equivalence (card, then CPU)"]["fwd"] != detected(n_cmp):
            raise AssertionError("[examples] check_decision_equivalence: launches != 7 a frame "
                                 "and 7 a warm-up run of the detector's capture")

        fix = entry("scripts.train_fixture_artifact")
        run("train_fixture_artifact", lambda: fix.main(
            ["--iters", str(EXAMPLE_STEPS), "--out", out("fixture_artifact")] + cuda),
            rounds_of(trained(EXAMPLE_STEPS)), trained(EXAMPLE_STEPS))

        written = {}
        for root, _, names in os.walk(tmp):
            for name in names:
                if name.startswith("events.out.tfevents"):  # TensorBoard's own format
                    continue
                path = os.path.join(root, name)
                written[os.path.relpath(path, tmp)] = _parsed(path)
        want = {"eval/sequence_synthetic.json", "gnn/ckpt/2.pt", "gnn/ckpt/3.pt",
                "gnn/logs/metrics.jsonl", "demo/eval_before.json", "demo/eval_after.json",
                "demo/metrics.jsonl", "demo/params.pt", "demo/params.msgpack",
                "long_run/eval_trend.jsonl",
                "long_run/ckpt/2.pt", "long_run/ckpt/3.pt", "classifier_chain/summary.json",
                "pointwise/predictions_semseg.json", "pointwise/predictions_instseg.json",
                "fixture_artifact/weights.pt", "fixture_artifact/weights.msgpack",
                "fixture_artifact/config.json",
                "fixture_artifact/README.md"}
        want |= {f"fixture_artifact/eval/{kind}/sequence_{i}.json" for i in range(1, 7)
                 for kind in ("semantic_segmentation", "object_classification")}
        missing = want - set(written)
        if missing or written["long_run/eval_trend.jsonl"] != 3:
            raise AssertionError(f"[examples] files missing {sorted(missing)} or an eval trend "
                                 f"of {written.get('long_run/eval_trend.jsonl')} lines")
        log(f"[examples] {len(written)} files written and parsed (JSON, JSON lines, torch.save, "
            f"flax msgpack); eval_trend.jsonl has steps 0, {EXAMPLE_STEPS}, {EXAMPLE_STEPS + 1}")
        for pt, mp in (("demo/params.pt", "demo/params.msgpack"),
                       ("fixture_artifact/weights.pt", "fixture_artifact/weights.msgpack")):
            same = msgpack_holds_state_dict(torch, os.path.join(tmp, mp), os.path.join(tmp, pt))
            log(f"[examples] {mp}, read by the port's load_params_msgpack and "
                f"state_dict_from_flax: the state_dict of {pt} bit for bit: {same}")
            if not same:
                raise AssertionError(f"[examples] {mp} does not hold {pt}'s weights")
    total = {key: sum(r[key] for r in results.values()) for key in ("fwd", "bwd")}
    log(f"[examples] wall s per entry point on {card()}: "
        f"{json.dumps({k: r['s'] for k, r in results.items()})}")
    return dict(total, entries=results)


def phase_sweep(torch, FM=None) -> list:
    """Phase 24: the port's batch sweep of ``train_b8`` (``python -m
    ...scripts.sweep_batch``: batch 8, 16 and 32, each in its own process,
    the captured step's ms from the slope of 20- and 80-step runs): every
    size must finish, and each row's numbers be finite and positive, its
    occupancy at most 1 and its TFLOP/s below the card's f32 peak."""
    t0 = time.perf_counter()
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    r = subprocess.run([sys.executable, "-m",
                        "graph_neural_network_for_radar_perception_torch.scripts.sweep_batch"],
                       cwd=REPO, env=env, capture_output=True, text=True, timeout=SWEEP_S)
    if r.returncode:
        raise AssertionError(f"[sweep] exit code {r.returncode}:\n{r.stderr[-3000:]}")
    rows = [json.loads(line) for line in r.stdout.splitlines() if line.startswith("{")]
    if [row["batch"] for row in rows] != [8, 16, 32]:
        raise AssertionError(f"[sweep] rows for batches {[row['batch'] for row in rows]}")
    for row in rows:
        if not all(np.isfinite(v) and v > 0 for v in row.values()) or not (
                row["occupancy"] <= 1 and row["mfu"] < 1):
            raise AssertionError(f"[sweep] row {row}")
    log(f"[sweep] train_b8 at batch 8, 16, 32 on {card()}, each size in its own process "
        f"({time.perf_counter() - t0:.1f} s): ms a step from the slope of 20- and 80-step "
        f"runs of the captured step (best of 2 each); f32 MFU against "
        f"{PEAK_F32_FLOPS / 1e12:.0f} TFLOP/s:")
    for line in r.stderr.strip().splitlines():
        log(f"[sweep]   {line}")
    for row in rows:
        log(f"[sweep] {json.dumps(row)}")
    return rows


def phase_training(torch, FM, C) -> dict:
    """``--phase train``: the batched kernels ([batched]) and the three
    train phases, whose steps are captured CUDA graphs."""
    batched = phase_batched(torch, FM, C)
    fwd, bwd, f32_metrics = phase_train(torch, FM)
    csr = phase_train_csr(torch, FM, C)
    bf16 = phase_train_bf16(torch, FM, C, f32_metrics)
    return {"batched": batched, "train": [fwd, bwd], "train-csr": list(csr),
            "train-bf16": bf16}


def phase_serving(torch, FM, C) -> dict:
    """``--phase deploy``: the captured detector with each message pass,
    [deploy] and [deploy-csr]."""
    return {"deploy": phase_deploy(torch, FM), "deploy-csr": phase_deploy_csr(torch, FM, C)}


# The kernels whose SASS must hold tensor-core instructions (HMMA: the bf16
# forwards' mma.sync), as their mangled names spell them; every other
# kernel of the two message-round libraries must hold none.
SASS_HMMA = ("fwd_edge_kernel_bf16", "gemm_bf16_kernel")
SASS_KERNELS = SASS_HMMA + ("fwd_edge_kernel", "bwd_edge_kernel", "gemm_kernel",
                            "segsum_kernel", "bwd_reduce_kernel")


def _kernel_of(mangled: str) -> str:
    """The kernel a mangled name instantiates (its length-prefixed name:
    ``20fwd_edge_kernel_bf16`` is not ``15fwd_edge_kernel``)."""
    return next((k for k in SASS_KERNELS if f"{len(k)}{k}" in mangled), mangled)


def sass_hmma(lib: str) -> dict:
    """{kernel: [HMMA instructions of each instantiation]} of a built
    library, from ``cuobjdump -sass`` (the CUDA toolkit's, beside nvcc)."""
    from graph_neural_network_for_radar_perception_torch.ops import _build

    tool = os.path.join(os.path.dirname(_build.find_nvcc()), "cuobjdump")
    text = subprocess.run([tool, "-sass", lib], capture_output=True, text=True,
                          check=True).stdout
    counts, fn = {}, None
    for line in text.splitlines():
        if "Function : " in line:
            fn = line.split("Function : ")[1].strip()
            counts[fn] = 0
        elif fn is not None and "HMMA" in line:
            counts[fn] += 1
    out = {}
    for fn, c in sorted(counts.items()):
        out.setdefault(_kernel_of(fn), []).append(c)
    return out


def phase_sass(torch=None, _=None) -> dict:
    """The bf16 forwards run on the tensor cores and nothing else does:
    in the built ``fused_mp`` and ``csr_mp`` libraries every instantiation
    of SASS_HMMA's kernels holds HMMA instructions (the bf16 edge kernel of
    each library, the CSR node GEMM) and every other kernel none."""
    from graph_neural_network_for_radar_perception_torch.ops import _build

    report = {name: sass_hmma(str(_build.build(name))) for name in ("fused_mp", "csr_mp")}
    log(f"[sass] HMMA instructions per instantiation (cuobjdump -sass): {json.dumps(report)}")
    want = {"fused_mp": {"fwd_edge_kernel_bf16": 1},
            "csr_mp": {"fwd_edge_kernel_bf16": 1, "gemm_bf16_kernel": 1}}
    for name, kernels in report.items():
        for kernel, counts in kernels.items():
            if kernel not in SASS_KERNELS:
                raise AssertionError(f"[sass] {name}: unknown kernel {kernel}")
            if kernel in SASS_HMMA and not all(counts):
                raise AssertionError(f"[sass] {name}: {kernel} without HMMA: {counts}")
            if kernel not in SASS_HMMA and any(counts):
                raise AssertionError(f"[sass] {name}: the f32 kernel {kernel} holds HMMA: {counts}")
        for kernel, n in want[name].items():
            if len(kernels.get(kernel, [])) != n:
                raise AssertionError(f"[sass] {name}: {n} instantiations of {kernel} expected, "
                                     f"found {kernels.get(kernel)}")
    return report


def card() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]


def main(argv) -> int:
    import faulthandler

    import torch

    # A hang anywhere prints every thread's stack and exits non-zero before
    # the run's 1200 s limit.
    faulthandler.dump_traceback_later(1140, exit=True)

    # Phases that run alone, and the libraries each needs.
    phases = {"kernel-timing": (time_forwards, "fused_mp", "csr_mp"),
              "sass": (phase_sass, "fused_mp", "csr_mp"),
              "kernel-bwd": (phase_kernel_bwd, "fused_mp"),
              "kernel-bwd-timing": (time_fused_bwd, "fused_mp"),
              "kernel-csr-bwd": (phase_kernel_csr_bwd, "csr_mp"),
              "kernel-csr-bwd-timing": (time_csr_bwd, "csr_mp"),
              "kernel-gat": (phase_kernel_gat, "gat_mp"),
              "checkpoint": (phase_checkpoint, "fused_mp"),
              "data-plane": (phase_data_plane, "fused_mp"),
              "eval": (phase_eval, "fused_mp"),
              "variants": (phase_variants, "fused_mp", "csr_mp", "gat_mp"),
              "finetune": (phase_finetune, "fused_mp"),
              "classifier": (phase_classifier, "fused_mp"),
              "cnn": (phase_cnn, "fused_mp"),
              "eval-step": (phase_eval_step, "fused_mp", "csr_mp"),
              "parallel": (phase_parallel, "fused_mp", "csr_mp"),
              "examples": (phase_examples, "fused_mp"),
              "sweep": (phase_sweep, "fused_mp"),
              "train": (lambda torch, _: phase_training(torch, FM, C), "fused_mp", "csr_mp"),
              "deploy": (lambda torch, _: phase_serving(torch, FM, C), "fused_mp", "csr_mp")}
    if argv and (len(argv) != 2 or argv[0] != "--phase" or argv[1] not in phases):
        print(f"usage: chip_smoke.py [--phase {'|'.join(phases)}]", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from graph_neural_network_for_radar_perception_torch.ops import _build
    from graph_neural_network_for_radar_perception_torch.ops import csr_mp as C
    from graph_neural_network_for_radar_perception_torch.ops import fused_mp as FM
    from graph_neural_network_for_radar_perception_torch.ops import gat_mp as GM
    from graph_neural_network_for_radar_perception_torch.scripts import gather_ablation as GA
    from graph_neural_network_for_radar_perception_torch.scripts import microbench_gather as MB

    # f32 means f32: no TF32 in matmuls (the default, stated here).
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"[env] torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)} count {torch.cuda.device_count()}")

    if argv:  # one phase or timing alone
        phase, *libs = phases[argv[1]]
        module = FM if libs[0] == "fused_mp" else C
        t0 = time.perf_counter()
        with ThreadPoolExecutor(max_workers=len(libs)) as pool:
            list(pool.map(_build.build, libs))
        log(f"[build] {', '.join(libs)}: {time.perf_counter() - t0:.1f} s")
        log(json.dumps(phase(torch, module)))
        log(card())
        return 0

    t0 = time.perf_counter()

    def timed_host_build():
        start = time.perf_counter()
        return _build.build_host("graph_builder"), time.perf_counter() - start

    # One nvcc per source and the host compiler for the native graph
    # builder, all started together (each build is a process).
    sources = ("fused_mp", "csr_mp", "microbench_gather", "gat_mp")
    with ThreadPoolExecutor(max_workers=len(sources) + 2) as pool:
        floor_lib = pool.submit(GA.build, "empty")
        native = pool.submit(timed_host_build)
        libs = dict(zip(sources, pool.map(_build.build, sources)))
        floor_lib = floor_lib.result()
        native_lib, native_s = native.result()
    FM._kernel(), FM._kernel(True), FM._bwd_kernel()
    C._kernel(), C._kernel(True), C._bwd_kernel()
    MB._kernels()
    GM._forward_kernel(), GM._backward_kernel()
    log(f"[build] fused_mp (fused_mp_forward, fused_mp_forward_bf16, "
        f"fused_mp_backward), csr_mp (csr_mp_forward, csr_mp_forward_bf16, "
        f"csr_mp_backward), microbench_gather (gather_rows, scatter_add_rows), "
        f"gat_mp (gat_mp_forward, gat_mp_backward), "
        f"the gather's empty variant and the native graph builder "
        f"({_build.host_compiler()}, {native_s:.1f} s of it), in parallel: "
        f"{time.perf_counter() - t0:.1f} s -> "
        f"{', '.join(os.path.relpath(p, REPO) for p in [*libs.values(), floor_lib, native_lib])}")
    phase_sass()

    fwd_row = phase_kernel(torch, FM)
    bwd_row = phase_kernel_bwd(torch, FM)
    csr_row = phase_kernel_csr(torch, C)
    csr_bwd_row = phase_kernel_csr_bwd(torch, C)
    gat_row, gat_bwd_row = phase_kernel_gat(torch)
    batched = phase_batched(torch, FM, C)
    deploy_launches = phase_deploy(torch, FM)
    train_fwd, train_bwd, f32_metrics = phase_train(torch, FM)
    csr_train_fwd, csr_train_bwd = phase_train_csr(torch, FM, C)
    csr_deploy = phase_deploy_csr(torch, FM, C)
    bf16_row = phase_kernel_bf16(torch, FM)
    csr_bf16_row = phase_kernel_csr_bf16(torch, C)
    for row in (fwd_row, bwd_row, csr_row, csr_bwd_row, bf16_row, csr_bf16_row):
        row.update(batched[row["name"]])
    gather_row, scatter_row = phase_microbench(torch, floor_lib)
    bf16_launches = phase_train_bf16(torch, FM, C, f32_metrics)
    phase_checkpoint(torch, FM)
    data_plane = phase_data_plane(torch, FM)
    phase_bench(torch)
    evaluation = phase_eval(torch, FM)
    variants = phase_variants(torch, FM)
    finetune = phase_finetune(torch, FM)
    phase_classifier(torch, FM)
    phase_cnn(torch, FM)
    eval_step = phase_eval_step(torch, FM)
    par = phase_parallel(torch, FM)
    examples = phase_examples(torch, FM)
    phase_sweep(torch)
    v1_fused = variants["v1"]["launches"]["fused_mp_forward"]
    v1_csr = variants["v1-csr"]["launches"]["csr_mp_forward"]
    v2_gat = variants["v2"]["launches"]["gat_mp_forward"]
    gat_row["launches"] += v2_gat
    gat_row["launches_by_path"]["variants (v2)"] = v2_gat
    fwd_row["launches"] = (deploy_launches + train_fwd + data_plane["fwd"] + evaluation["fwd"]
                           + v1_fused + finetune["fwd"])
    fwd_row["launches_by_path"] = {"deploy": deploy_launches, "train": train_fwd,
                                   "data-plane": data_plane["fwd"], "eval": evaluation["fwd"],
                                   "variants (v1)": v1_fused, "finetune": finetune["fwd"]}
    bwd_row["launches"] = train_bwd + data_plane["bwd"] + finetune["bwd"]
    bwd_row["launches_by_path"] = {"train": train_bwd, "data-plane": data_plane["bwd"],
                                   "finetune": finetune["bwd"]}
    csr_row["launches"] = csr_deploy + csr_train_fwd + v1_csr
    csr_row["launches_by_path"] = {"deploy-csr": csr_deploy, "train-csr": csr_train_fwd,
                                   "variants (v1, csr)": v1_csr}
    csr_bwd_row["launches"] = csr_train_bwd
    csr_bwd_row["launches_by_path"] = {"train-csr": csr_train_bwd}
    bwd_row["launches"] += bf16_launches["fused"][1]
    bwd_row["launches_by_path"]["train-bf16"] = bf16_launches["fused"][1]
    csr_bwd_row["launches"] += bf16_launches["csr"][1]
    csr_bwd_row["launches_by_path"]["train-bf16 (csr)"] = bf16_launches["csr"][1]
    bf16_row["launches"] = bf16_launches["fused"][0]
    bf16_row["launches_by_path"] = {"train-bf16": bf16_launches["fused"][0]}
    csr_bf16_row["launches"] = bf16_launches["csr"][0]
    csr_bf16_row["launches_by_path"] = {"train-bf16 (csr)": bf16_launches["csr"][0]}
    for row, key in ((fwd_row, "fused_mp_forward"), (bwd_row, "fused_mp_backward"),
                     (csr_row, "csr_mp_forward"), (csr_bwd_row, "csr_mp_backward")):
        row["launches"] += par[key]
        row["launches_by_path"]["parallel"] = par[key]
    for row, key in ((fwd_row, "fwd"), (bwd_row, "bwd")):
        row["launches"] += examples[key]
        row["launches_by_path"]["examples"] = examples[key]
    for row, key in ((fwd_row, "fused_mp_forward"), (bwd_row, "fused_mp_backward"),
                     (csr_row, "csr_mp_forward"), (csr_bwd_row, "csr_mp_backward")):
        for mp, label in (("fused", "eval-step"), ("csr", "eval-step (csr)")):
            if eval_step[mp][key]:
                row["launches"] += eval_step[mp][key]
                row["launches_by_path"][label] = eval_step[mp][key]
    for row in (gather_row, scatter_row):
        row["launches_by_path"] = {"microbenchmark": row["launches"]}
    log(json.dumps({"kernels": [fwd_row, bwd_row, csr_row, csr_bwd_row, bf16_row,
                                csr_bf16_row, gather_row, scatter_row, gat_row,
                                gat_bwd_row]}))
    log(card())
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
