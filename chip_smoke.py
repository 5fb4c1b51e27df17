#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each reported on its own line:

1. [build] build the port's CUDA kernels from ``csrc/`` with nvcc, one
   ``nvcc`` per source, started together: ``fused_mp`` (the fused round's
   forward, f32 and bf16, and backward), ``csr_mp`` (the CSR round's) and
   ``microbench_gather`` (row gather and scatter-add), and beside them the
   gather ablation's ``empty`` variant (the launch floor of [kernel-gather]);
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
6. [deploy] drive the deploy path — ``FrameDetector(GNNConfig(), ...)``, the
   shipped widths with random weights from a seeded ``torch.Generator`` —
   over synthetic frames at the default capacities, count the forward
   kernel's launches and every kernel of one deploy forward, and compare
   logits and decisions with the same detector on the CPU (which runs the
   plain version);
7. [train] drive the training path — ``trainer.train`` with
   ``GNNConfig()`` at batch 8 on synthetic batches — count both kernels'
   launches, replay the same steps on the CPU and compare metrics and
   params, check the NaN skip on a poisoned batch, time a step and profile
   one;
8. [train-csr] the same with ``GNNConfig(mp_impl="csr")``, also against the
   default message pass on the card, and a window violation that the NaN
   guard turns into a skipped step;
9. [deploy-csr] ``FrameDetector(GNNConfig(mp_impl="csr"))`` on 4 of the
   deploy frames against the default message pass on the card;
10. [kernel-bf16] the fused forward's bf16 instantiation against its plain
    bf16 version on the [kernel] problems, two launches bitwise equal, the
    f32 kernel's output shown to lie outside that tolerance, timing;
11. [kernel-csr-bf16] the same for the CSR forward on the [kernel-csr]
    graphs, two launches bitwise equal;
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
15. [bench] the port bench (``scripts/bench.run``: root ``bench.py``'s
    train_b8 in four rows, stress_dense, deploy and ``FrameDetector.detect``)
    with one short repeat per config;
16. print the kernel table as JSON and the card's name and power limit.

The last line is ``{"ok": true, "device": {...}}``; any failure exits
non-zero without it.  Needs one CUDA card, nvcc and no network; imports
nothing of JAX.

    python3 chip_smoke.py --phase kernel-timing
    python3 chip_smoke.py --phase kernel-bwd
    python3 chip_smoke.py --phase kernel-bwd-timing
    python3 chip_smoke.py --phase kernel-csr-bwd
    python3 chip_smoke.py --phase kernel-csr-bwd-timing
    python3 chip_smoke.py --phase checkpoint

build the libraries a phase needs and run phase 3 (the fused backward),
phase 5 (the CSR backward) or phase 14 (the checkpoint) alone, or only a
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


def log(msg: str) -> None:
    print(msg, flush=True)


def kernel_problem(torch, rng, e_valid: int, e_total: int, n: int = N,
                   de: int = DE, h: int = H, d2: int = D2):
    """Random message round, at the deploy shapes unless told otherwise;
    the edge tail past ``e_valid`` is padding (sentinel n at both ends,
    zero features), as ``pad_frame`` + the model lay out a frame."""
    x = rng.normal(size=(n, D)).astype(np.float32)
    ef = rng.normal(size=(e_total, de)).astype(np.float32)
    s = rng.integers(0, n, size=e_total).astype(np.int32)
    r = rng.integers(0, n, size=e_total).astype(np.int32)
    s[e_valid:] = n
    r[e_valid:] = n
    ef[e_valid:] = 0.0
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
           D2, torch.cuda.current_stream().cuda_stream)
    return raw, (xa, xb, scal, msgs, agg, layout)


def fused_problems(torch, rng):
    """The fused forward's checks, each (name, round): a frame-like padded
    tail and a ragged E at the main path's shapes, then FWD_WIDE."""
    out = [(f"E={e_total} valid={e_valid}", kernel_problem(torch, rng, e_valid, e_total))
           for e_valid, e_total in ((9216, E), (E - 3, E - 3))]
    return out + [(f"N={WIDE_N} E={WIDE_E} De={de} H={h} D2={d2}", kernel_problem(
        torch, rng, WIDE_E - 300, WIDE_E, WIDE_N, de, h, d2)) for de, h, d2 in FWD_WIDE]


def plan_of(FM, args) -> str:
    """The fused forward's edge-kernel plan for the round ``args``."""
    x, ef, w2 = args[0], args[1], args[6]
    p = FM._forward_plan(x.shape[0], ef.shape[0], ef.shape[1], w2.shape[0],
                         w2.shape[1], x.device)
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


def csr_plan_of(C, args) -> str:
    """The CSR forward's edge-kernel plan for the round ``args``."""
    x, ef, w2 = args[0], args[1], args[6]
    p = C._forward_plan(x.shape[0], ef.shape[0], x.shape[1], ef.shape[1],
                        w2.shape[0], w2.shape[1], x.device)
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
           n, e, d, de, h, d2,
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
    # outputs of one C call and both forwards on this problem.
    fn(*raw)
    with torch.no_grad():
        forwards = [C.fused_message_pass_csr(*args, *tiling, bf16)
                    for bf16 in (False, True)]
    outputs = digest([*results(), *forwards])
    log(f"[kernel-csr-bwd] outputs sha256 (10 backward outputs of one C call, "
        f"the f32 and bf16 forwards): {outputs}")
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

    c = cpu.centers.astype(np.float64)
    d2 = ((c[:, None, :] - c[None, :, :]) ** 2).sum(-1)
    off_diag = ~np.eye(c.shape[0], dtype=bool)
    border = (np.abs(d2 - eps) <= 1e-4) & off_diag
    report["borderline_pairs"] = int(border.sum() // 2)
    same = _same_partition(gpu.node2cluster, cpu.node2cluster)
    report["partition_equal"] = bool(same)
    if not same:
        strict = _components((d2 <= eps) & off_diag & ~border)
        loose = _components(((d2 <= eps) & off_diag) | border)
        for name, part in (("gpu", gpu.node2cluster), ("cpu", cpu.node2cluster)):
            if not (_coarser_or_equal(strict, part) and _coarser_or_equal(part, loose)):
                raise AssertionError(
                    f"{name} DBSCAN partition differs beyond borderline pairs")
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
    from graph_neural_network_for_radar_perception_torch.data.synthetic import make_synthetic_frame
    from graph_neural_network_for_radar_perception_torch.infer.pipeline import FrameDetector
    from graph_neural_network_for_radar_perception_torch.models.gnn import RadarGNN

    cfg = GNNConfig()  # shipped widths; max_nodes 768, E_cap 15360, window 10
    state = RadarGNN(cfg, generator=torch.Generator().manual_seed(0)).state_dict()
    det_gpu = FrameDetector(cfg, state, device="cuda")
    det_cpu = FrameDetector(cfg, state, device="cpu")
    rng = np.random.default_rng(1)
    frames = [
        make_synthetic_frame(rng, num_objects=int(rng.integers(8, 13)),
                             window_size=cfg.temporal_window_size)
        for _ in range(NUM_FRAMES + 1)
    ]
    det_gpu.detect(frames[-1])  # warm-up: cuBLAS handles, allocator
    torch.cuda.synchronize()

    FM.fused_message_pass.launches = 0
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
    log(f"[deploy] {n_run} frames, fused_message_pass launches={launches} "
        f"(expected {rounds} x {n_run}); FrameDetector.detect (host preprocess "
        f"+ pad + deploy + decode) ms/frame median "
        f"{np.median(frame_ms):.3f} (min {min(frame_ms):.3f}, max {max(frame_ms):.3f})")
    if n_run < 4 or launches != rounds * n_run:
        raise AssertionError("the deploy path did not run the kernel once per round")

    worst, deploy_ms = {}, []
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
        log(f"[deploy] frame {i}: n={fr.n} edges={fr.senders.shape[0]} "
            f"clusters={gdet.num_clusters} {json.dumps(rep)}")
    log(f"[deploy] card vs CPU max abs err: {json.dumps(worst)} "
        f"(rtol={DEPLOY_RTOL}, atol={DEPLOY_ATOL})")
    log(f"[deploy] RadarGNN.deploy forward alone on the card: ms/frame median "
        f"{np.median(deploy_ms):.3f} (min {min(deploy_ms):.3f}, max {max(deploy_ms):.3f})")
    with torch.no_grad():
        prof = profile_run(lambda: det_gpu.model.deploy(graph))
        layout_kernels = len(kernel_breakdown(lambda: FM.fused_layout(
            graph.senders, graph.receivers, graph.node_feat.shape[0])))
    log(f"[deploy] profile of one deploy forward (last frame): {json.dumps(prof)}")
    log(f"[deploy] launches per frame: {prof['device_kernels']} device kernels in one "
        f"deploy forward, {rounds} of them fused_message_pass and {layout_kernels} "
        f"the graph's fused_layout (made once per frame)")
    if not prof["device_kernels"]:
        raise AssertionError("the profiler saw no kernel on the card")
    return launches


def _poisoned(batch):
    import dataclasses

    node_feat = batch.graph.node_feat.copy()
    node_feat[0, 0, 0] = np.nan
    return dataclasses.replace(
        batch, graph=dataclasses.replace(batch.graph, node_feat=node_feat))


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
    want = rounds * bsz * TRAIN_STEPS
    log(f"[train] trainer.train on the card: launches forward={fwd} backward={bwd} "
        f"(expected {rounds} x {bsz} x {TRAIN_STEPS} = {want}), skipped="
        f"{[m['skipped'] for m in card_metrics]}, {wall:.2f} s incl. first-call set-up")
    if fwd != want or bwd != want or any(m["skipped"] for m in card_metrics):
        raise AssertionError("the train path did not run both kernels once per round and graph")

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

    params = {k: v.clone() for k, v in state.model.state_dict().items()}
    moments = [s["momentum_buffer"].clone() for s in state.optimizer.state.values()]
    updates = state.updates
    state, m = step(state, _poisoned(batches[0]))
    same = (all(torch.equal(v, params[k]) for k, v in state.model.state_dict().items())
            and all(torch.equal(s["momentum_buffer"], b) for s, b in
                    zip(state.optimizer.state.values(), moments)))
    log(f"[train] NaN-poisoned batch: skipped={float(m['skipped'])}, params and "
        f"momentum bit-identical={same}, updates {updates} -> {state.updates}")
    if float(m["skipped"]) != 1.0 or not same or state.updates != updates:
        raise AssertionError("the NaN skip changed the state")

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
    if not prof["device_kernels"]:
        raise AssertionError("the profiler saw no kernel on the card")
    return fwd, bwd, card_metrics


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
    want = rounds * bsz * TRAIN_STEPS
    log(f"[train-csr] trainer.train on the card: CSR launches forward={fwd} "
        f"backward={bwd} (expected {rounds} x {bsz} x {TRAIN_STEPS} = {want}), "
        f"fused_mp launches {fused_fwd}/{fused_bwd} (expected 0), skipped="
        f"{[m['skipped'] for m in card_metrics]}, {wall:.2f} s incl. first-call set-up")
    if (fwd, bwd, fused_fwd, fused_bwd) != (want, want, 0, 0) or any(
            m["skipped"] for m in card_metrics):
        raise AssertionError("the CSR train path did not run its kernels once per round and graph")

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

    params = {k: v.clone() for k, v in state.model.state_dict().items()}
    updates = state.updates
    state, m = step(state, _poisoned(batches[0]))
    same = all(torch.equal(v, params[k]) for k, v in state.model.state_dict().items())
    log(f"[train-csr] NaN-poisoned batch: skipped={float(m['skipped'])}, params "
        f"bit-identical={same}, updates {updates} -> {state.updates}")
    if float(m["skipped"]) != 1.0 or not same or state.updates != updates:
        raise AssertionError("the NaN skip changed the state")

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
    if not prof["device_kernels"]:
        raise AssertionError("the profiler saw no kernel on the card")
    return fwd, bwd


def phase_deploy_csr(torch, FM, C):
    """Phase 9: FrameDetector with mp_impl="csr" on the card against the
    same weights through the default message pass on the card."""
    from graph_neural_network_for_radar_perception_torch.config.config import GNNConfig
    from graph_neural_network_for_radar_perception_torch.core.graph import RadarGraph
    from graph_neural_network_for_radar_perception_torch.data.pipeline import pad_frame, preprocess_frame
    from graph_neural_network_for_radar_perception_torch.data.synthetic import make_synthetic_frame
    from graph_neural_network_for_radar_perception_torch.infer.pipeline import FrameDetector
    from graph_neural_network_for_radar_perception_torch.models.gnn import RadarGNN

    cfg, cfg_csr = GNNConfig(), GNNConfig(mp_impl="csr")
    state = RadarGNN(cfg, generator=torch.Generator().manual_seed(0)).state_dict()
    det = {"csr": FrameDetector(cfg_csr, state, device="cuda"),
           "onehot": FrameDetector(cfg, state, device="cuda")}
    rng = np.random.default_rng(1)  # the [deploy] phase's frames
    frames = [make_synthetic_frame(rng, num_objects=int(rng.integers(8, 13)),
                                   window_size=cfg.temporal_window_size)
              for _ in range(NUM_CSR_FRAMES)]
    det["csr"].detect(frames[0])  # warm-up
    torch.cuda.synchronize()
    for c in (FM.fused_message_pass, C.fused_message_pass_csr):
        c.launches = 0
    dets, frame_ms = [], []
    for data in frames:
        t0 = time.perf_counter()
        dets.append(det["csr"].detect(data))
        torch.cuda.synchronize()
        frame_ms.append((time.perf_counter() - t0) * 1e3)
    launches, fused = C.fused_message_pass_csr.launches, FM.fused_message_pass.launches
    rounds = len(cfg.graph_convolution_stem_channels)
    n_run = sum(d is not None for d in dets)
    log(f"[deploy-csr] {n_run} frames, fused_message_pass_csr launches={launches} "
        f"(expected {rounds} x {n_run}), fused_message_pass launches={fused} "
        f"(expected 0); detect ms/frame median {np.median(frame_ms):.3f} "
        f"(min {min(frame_ms):.3f}, max {max(frame_ms):.3f})")
    if n_run < 4 or launches != rounds * n_run or fused:
        raise AssertionError("the CSR deploy path did not run its kernel once per round")

    worst = {}
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
        log(f"[deploy-csr] frame {i}: n={fr.n} edges={fr.senders.shape[0]} "
            f"clusters={gdet.num_clusters} csr vs onehot {json.dumps(rep)}")
    log(f"[deploy-csr] csr vs onehot max abs err: {json.dumps(worst)} "
        f"(rtol={DEPLOY_RTOL}, atol={DEPLOY_ATOL})")
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
        log(f"[kernel-bf16] {name} ({plan_of(FM, args)}): max_abs_err={err:.3e}, "
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
    log(f"[kernel-bf16] timing E={E} live={e_live}: bf16 kernel {kernel_ms * 1e3:.2f} us "
        f"(f32 kernel on the same inputs {f32_ms * 1e3:.2f} us), wrapper "
        f"{wrapper_ms * 1e3:.2f} us, plain {plain_ms * 1e3:.2f} us; bound "
        f"{max(t_ops, t_bytes) * 1e6:.2f} us ({flops / 1e9:.3f} GFLOP at bf16 peak, "
        f"{nbytes / 1e6:.2f} MB)")
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
        "bound_ms": max(t_ops, t_bytes) * 1e3,
        "bound_by": "operations" if t_ops >= t_bytes else "bytes",
        "library_ms": None,
    }


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
            f"({csr_plan_of(C, args)}): "
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
    log(f"[kernel-csr-bf16] timing E={E} live={e_live}: bf16 kernel {kernel_ms * 1e3:.2f} us "
        f"(f32 kernel on the same inputs {f32_ms * 1e3:.2f} us), wrapper "
        f"{wrapper_ms * 1e3:.2f} us, plain {plain_ms * 1e3:.2f} us; bound "
        f"{max(t_ops, t_bytes) * 1e6:.2f} us ({flops / 1e9:.3f} GFLOP at bf16 peak, "
        f"{nbytes / 1e6:.2f} MB)")
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
        "bound_ms": max(t_ops, t_bytes) * 1e3,
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
    want = rounds * bsz * TRAIN_STEPS
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
        expect = {k: (want if k in (f"{tag} bf16 fwd", f"{tag} bwd") else 0) for k in counters}
        log(f"[train-bf16] {tag}: trainer.train on the card, launches {json.dumps(got)} "
            f"(expected {rounds} x {bsz} x {TRAIN_STEPS} = {want} bf16 forwards and f32 "
            f"backwards, nothing else), skipped={[m['skipped'] for m in card_metrics]}, "
            f"{wall:.2f} s incl. first-call set-up")
        if got != expect or any(m["skipped"] for m in card_metrics):
            raise AssertionError(f"the bf16 train path ({tag}) did not run its kernels "
                                 "once per round and graph")
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
    finally:
        torch.use_deterministic_algorithms(deterministic[0], warn_only=deterministic[1])
        shutil.rmtree(directory, ignore_errors=True)
    (err, at), (repeat, repeat_at) = _snapshot_diff(resumed, whole), _snapshot_diff(again, whole)
    log(f"[checkpoint] GNNConfig() batch {bsz}, deterministic algorithms: saved steps "
        f"{saved}, restore vs the saved state max abs diff {restore_err:.3e}; 2 + 2 steps vs 4 "
        f"uninterrupted: {err:.3e} (at {at}) over {len(whole)} params/optimiser tensors and "
        f"the counters; 4 steps twice: {repeat:.3e} (at {repeat_at}); fused_message_pass "
        f"launches {launches} (expected {rounds} x {bsz} x 12)")
    if saved != [2] or restore_err != 0.0 or launches != rounds * bsz * 12:
        raise AssertionError("the checkpoint hook did not save or restore the state")
    if repeat != 0.0 or err != 0.0:
        raise AssertionError("4 steps do not repeat bit for bit, or a resumed run differs")
    return {"bitwise": True, "max_abs_diff": err, "repeat_max_abs_diff": repeat}


def phase_bench(torch):
    """Phase 15: the port bench, one short repeat per config."""
    from graph_neural_network_for_radar_perception_torch.scripts import bench as PB

    t0 = time.perf_counter()
    res = PB.run("cuda", warmup=1, steps=1)
    rows = dict(res["train_b8"]["rows"], stress_dense=res["stress_dense"],
                deploy=res["deploy"], detect=res["deploy"]["detect"])
    log(f"[bench] scripts/bench.run(warmup=1, steps=1) in {time.perf_counter() - t0:.1f} s: "
        f"{json.dumps(res)}")
    for name, row in rows.items():
        log(f"[bench] {name}: host ms median {row['host_ms']:.3f} (min {row['host_ms_min']:.3f}, "
            f"max {row['host_ms_max']:.3f}), event ms {row['event_ms']:.3f}, device busy "
            f"{row['device_busy_ms']:.3f} ms, idle {row['device_idle_share']:.3f}, "
            f"{row['device_kernels']} kernels, mfu {row.get('mfu')}")
        if not (np.isfinite(row["host_ms"]) and row["host_ms"] > 0 and row["device_kernels"] > 0):
            raise AssertionError(f"[bench] {name}: no time or no kernel on the card")
    if any(r["skipped"] for r in res["train_b8"]["rows"].values()):
        raise AssertionError("[bench] a train_b8 step was skipped")
    return res


def card() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]


def main(argv) -> int:
    import torch

    # Phases that run alone, and the libraries each needs.
    phases = {"kernel-timing": (time_forwards, "fused_mp", "csr_mp"),
              "kernel-bwd": (phase_kernel_bwd, "fused_mp"),
              "kernel-bwd-timing": (time_fused_bwd, "fused_mp"),
              "kernel-csr-bwd": (phase_kernel_csr_bwd, "csr_mp"),
              "kernel-csr-bwd-timing": (time_csr_bwd, "csr_mp"),
              "checkpoint": (phase_checkpoint, "fused_mp")}
    if argv and (len(argv) != 2 or argv[0] != "--phase" or argv[1] not in phases):
        print(f"usage: chip_smoke.py [--phase {'|'.join(phases)}]", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from graph_neural_network_for_radar_perception_torch.ops import _build
    from graph_neural_network_for_radar_perception_torch.ops import csr_mp as C
    from graph_neural_network_for_radar_perception_torch.ops import fused_mp as FM
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
    # One nvcc per source, all started together (each build is a process).
    sources = ("fused_mp", "csr_mp", "microbench_gather")
    with ThreadPoolExecutor(max_workers=len(sources) + 1) as pool:
        floor_lib = pool.submit(GA.build, "empty")
        libs = dict(zip(sources, pool.map(_build.build, sources)))
        floor_lib = floor_lib.result()
    FM._kernel(), FM._kernel(True), FM._bwd_kernel()
    C._kernel(), C._kernel(True), C._bwd_kernel()
    MB._kernels()
    log(f"[build] fused_mp (fused_mp_forward, fused_mp_forward_bf16, "
        f"fused_mp_backward), csr_mp (csr_mp_forward, csr_mp_forward_bf16, "
        f"csr_mp_backward), microbench_gather (gather_rows, scatter_add_rows), "
        f"the gather's empty variant, in parallel: {time.perf_counter() - t0:.1f} s -> "
        f"{', '.join(os.path.relpath(p, REPO) for p in [*libs.values(), floor_lib])}")

    fwd_row = phase_kernel(torch, FM)
    bwd_row = phase_kernel_bwd(torch, FM)
    csr_row = phase_kernel_csr(torch, C)
    csr_bwd_row = phase_kernel_csr_bwd(torch, C)
    deploy_launches = phase_deploy(torch, FM)
    train_fwd, train_bwd, f32_metrics = phase_train(torch, FM)
    csr_train_fwd, csr_train_bwd = phase_train_csr(torch, FM, C)
    csr_deploy = phase_deploy_csr(torch, FM, C)
    bf16_row = phase_kernel_bf16(torch, FM)
    csr_bf16_row = phase_kernel_csr_bf16(torch, C)
    gather_row, scatter_row = phase_microbench(torch, floor_lib)
    bf16_launches = phase_train_bf16(torch, FM, C, f32_metrics)
    phase_checkpoint(torch, FM)
    phase_bench(torch)
    fwd_row["launches"] = deploy_launches + train_fwd
    fwd_row["launches_by_path"] = {"deploy": deploy_launches, "train": train_fwd}
    bwd_row["launches"] = train_bwd
    bwd_row["launches_by_path"] = {"train": train_bwd}
    csr_row["launches"] = csr_deploy + csr_train_fwd
    csr_row["launches_by_path"] = {"deploy-csr": csr_deploy, "train-csr": csr_train_fwd}
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
    for row in (gather_row, scatter_row):
        row["launches_by_path"] = {"microbenchmark": row["launches"]}
    log(json.dumps({"kernels": [fwd_row, bwd_row, csr_row, csr_bwd_row, bf16_row,
                                csr_bf16_row, gather_row, scatter_row]}))
    log(card())
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
