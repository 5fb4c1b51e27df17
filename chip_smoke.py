#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each reported on its own line:

1. [build] build the port's CUDA kernels from ``csrc/`` with nvcc, one
   ``nvcc`` per source, started together: ``fused_mp`` (the fused round's
   forward and backward) and ``csr_mp`` (the CSR round's);
2. [kernel] hold the fused forward kernel against its plain PyTorch version
   on the card at the main path's shapes (N=768, E=15360, D=De=D2=64,
   H=128, plus a ragged E) and time both with CUDA events;
3. [kernel-bwd] the same for the fused backward kernel (all 11 outputs), and
   autograd through ``fused_message_pass`` on the card against the same on
   CPU tensors;
4. [kernel-csr] the CSR forward kernel against its plain version on a kNN
   graph (k=10) at N=768, E=15360, a ragged E and a banded graph with a
   source window; two launches bitwise equal; timing;
5. [kernel-csr-bwd] the same for the CSR backward kernel (all 10 outputs,
   each checked bitwise across two launches), and autograd through
   ``fused_message_pass_csr`` on the card against the CPU;
6. [deploy] drive the deploy path — ``FrameDetector(GNNConfig(), ...)``, the
   shipped widths with random weights from a seeded ``torch.Generator`` —
   over synthetic frames at the default capacities, count the forward
   kernel's launches, and compare logits and decisions with the same
   detector on the CPU (which runs the plain version);
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
10. print the kernel table as JSON and the card's name and power limit.

The last line is ``{"ok": true, "device": {...}}``; any failure exits
non-zero without it.  Needs one CUDA card, nvcc and no network; imports
nothing of JAX.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))

# Published peaks of one H100 SXM at its 700 W limit (NVIDIA data sheet):
# f32 outside the tensor cores, and HBM3 bandwidth.
PEAK_F32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12

N, E, D, DE, H, D2 = 768, 15360, 64, 64, 128, 64
RTOL, ATOL = 2e-4, 2e-5              # kernel vs plain (atomics reorder sums)
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


def log(msg: str) -> None:
    print(msg, flush=True)


def kernel_problem(torch, rng, e_valid: int, e_total: int):
    """Random message round at the deploy shapes; the edge tail past
    ``e_valid`` is padding (sentinel N at both ends, zero features), as
    ``pad_frame`` + the model lay out a frame."""
    x = rng.normal(size=(N, D)).astype(np.float32)
    ef = rng.normal(size=(e_total, DE)).astype(np.float32)
    s = rng.integers(0, N, size=e_total).astype(np.int32)
    r = rng.integers(0, N, size=e_total).astype(np.int32)
    s[e_valid:] = N
    r[e_valid:] = N
    ef[e_valid:] = 0.0
    w1 = (rng.normal(size=(2 * D + DE, H)) / np.sqrt(2 * D + DE)).astype(np.float32)
    b1 = (0.1 * rng.normal(size=H)).astype(np.float32)
    w2 = (rng.normal(size=(H, D2)) / np.sqrt(H)).astype(np.float32)
    b2 = (0.1 * rng.normal(size=D2)).astype(np.float32)
    dev = torch.device("cuda")
    arrays = [torch.from_numpy(a).to(dev) for a in (x, ef, s, r, w1, b1, w2, b2)]
    scalars = [torch.tensor([v], device=dev) for v in (1.1, 0.05, 0.9, -0.02)]
    return arrays + scalars


def event_ms(torch, fn, reps: int = 50, inner: int = 20) -> float:
    """Median over ``reps`` of the CUDA-event time of ``inner`` back-to-back
    calls, per call, after warm-up."""
    for _ in range(10):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(inner):
            fn()
        stop.record()
        stop.synchronize()
        times.append(start.elapsed_time(stop) / inner)
    return float(np.median(times))


def phase_kernel(torch, FM):
    """Phase 2: kernel vs plain version; returns the kernel's table row."""
    rng = np.random.default_rng(0)
    max_err = 0.0
    # A frame-like padded tail, and a ragged E that is no multiple of the
    # kernel's edge group.
    for e_valid, e_total in ((9216, E), (E - 3, E - 3)):
        args = kernel_problem(torch, rng, e_valid, e_total)
        got = FM.fused_message_pass(*args)
        torch.cuda.synchronize()
        want = FM.fused_message_pass_reference(*args)
        err = (got - want).abs()
        max_err = max(max_err, float(err.max()))
        bad = int((err > ATOL + RTOL * want.abs()).sum())
        log(f"[kernel] E={e_total} valid={e_valid}: max_abs_err={float(err.max()):.3e} "
            f"violations(rtol={RTOL}, atol={ATOL})={bad}")
        if bad or not torch.isfinite(got).all():
            raise AssertionError("fused_message_pass kernel disagrees with its plain version")

    # Timing at the deploy shapes with the padded tail of a typical frame.
    args = kernel_problem(torch, rng, 9216, E)
    x, ef, s, r, w1, b1, w2, b2 = args[:8]
    xa, xb = x @ w1[:D], x @ w1[D:2 * D]
    w1e = w1[2 * D:]
    scal = torch.cat(args[8:])
    agg = torch.zeros(N, D2, device="cuda")
    fn = FM._kernel()
    raw = (xa.data_ptr(), xb.data_ptr(), ef.data_ptr(), s.data_ptr(),
           r.data_ptr(), w1e.data_ptr(), b1.data_ptr(), w2.data_ptr(),
           b2.data_ptr(), scal.data_ptr(), 0.01, agg.data_ptr(), N, E, DE, H,
           D2, torch.cuda.current_stream().cuda_stream)
    kernel_ms = event_ms(torch, lambda: fn(*raw))
    wrapper_ms = event_ms(torch, lambda: FM.fused_message_pass(*args))
    plain_ms = event_ms(torch, lambda: FM.fused_message_pass_reference(*args))

    # Least time for the kernel's work on these inputs: the f32 FMAs of the
    # edges whose messages land (receiver in range), and each input read /
    # output written once.
    e_live = int(((r >= 0) & (r < N)).sum())
    flops = 2 * e_live * (DE * H + H * D2)
    nbytes = 4 * (2 * N * H + E * DE + 2 * E + DE * H + H + H * D2 + D2 + 4 + N * D2)
    t_ops, t_bytes = flops / PEAK_F32_FLOPS, nbytes / PEAK_BYTES_PER_S
    log(f"[kernel] timing E={E} live={e_live}: kernel {kernel_ms * 1e3:.2f} us, "
        f"wrapper (xa/xb matmuls + kernel) {wrapper_ms * 1e3:.2f} us, "
        f"plain {plain_ms * 1e3:.2f} us; bound {max(t_ops, t_bytes) * 1e6:.2f} us "
        f"({flops / 1e9:.3f} GFLOP, {nbytes / 1e6:.2f} MB)")
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
        "bound_ms": max(t_ops, t_bytes) * 1e3,
        "bound_by": "operations" if t_ops >= t_bytes else "bytes",
        "library_ms": None,
    }


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


def phase_kernel_bwd(torch, FM):
    """Phase 3: backward kernel vs plain version, autograd on the card vs
    the CPU, and timing; returns the backward kernel's table row."""
    rng = np.random.default_rng(2)
    names = ("gef dxa dxb dw1e db1 dw2 db2 dg1 dbe1 dg2 dbe2").split()
    max_err = 0.0
    # A frame-like padded tail, and a ragged E with one-sided sentinels.
    for e_valid, e_total, mixed in ((9216, E, False), (E - 3, E - 3, True)):
        args = kernel_problem(torch, rng, e_valid, e_total)
        if mixed:
            for i in (2, 3):
                args[i][torch.from_numpy(rng.random(e_total) < 0.05).cuda()] = N
        args, dropped = drop_kink_edges(torch, args)
        g = torch.from_numpy(
            (G_SCALE * rng.normal(size=(N, D2))).astype(np.float32)).cuda()
        got = FM.fused_message_pass_backward(*args, g)
        torch.cuda.synchronize()
        want = FM.fused_message_pass_backward_reference(*args, g)
        worst = {}
        for name, a, b in zip(names, got, want):
            err = (a - b).abs()
            bad = int((err > GRAD_ATOL + GRAD_RTOL * b.abs()).sum())
            worst[name] = float(err.max())
            max_err = max(max_err, worst[name])
            if bad or not torch.isfinite(a).all():
                raise AssertionError(
                    f"fused_message_pass_backward: {name} disagrees with its "
                    f"plain version at {bad} elements")
        log(f"[kernel-bwd] E={e_total} valid={e_valid} mixed={mixed} "
            f"kink edges dropped={dropped}: all 11 outputs within rtol="
            f"{GRAD_RTOL} atol={GRAD_ATOL}; max abs err {json.dumps(worst)}")

    # Autograd through the Function: the card (kernels) against CPU tensors
    # (plain versions), on the last problem.
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

    # Timing at the main path's shapes with a frame-like padded tail.
    args = kernel_problem(torch, rng, 9216, E)
    g = torch.from_numpy((G_SCALE * rng.normal(size=(N, D2))).astype(np.float32)).cuda()
    x, ef, s, r, w1, b1, w2, b2 = args[:8]
    xa, xb = x @ w1[:D], x @ w1[D:2 * D]
    w1e = w1[2 * D:]
    w1e_t, w2_t = w1e.t().contiguous(), w2.t().contiguous()
    scal = torch.cat(args[8:])
    outs = [torch.zeros(sh, device="cuda") for sh in
            ((E, DE), (N, H), (N, H), (DE, H), (H,), (H, D2), (D2,), (4,))]
    fn = FM._bwd_kernel()
    raw = (xa.data_ptr(), xb.data_ptr(), ef.data_ptr(), s.data_ptr(),
           r.data_ptr(), w1e.data_ptr(), w1e_t.data_ptr(), b1.data_ptr(),
           w2.data_ptr(), w2_t.data_ptr(), b2.data_ptr(), scal.data_ptr(),
           g.data_ptr(), 0.01, *[o.data_ptr() for o in outs], N, E, DE, H, D2,
           torch.cuda.current_stream().cuda_stream)
    kernel_ms = event_ms(torch, lambda: fn(*raw))
    wrapper_ms = event_ms(torch, lambda: FM.fused_message_pass_backward(*args, g))
    plain_ms = event_ms(torch, lambda: FM.fused_message_pass_backward_reference(*args, g))

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
    log(f"[kernel-bwd] timing E={E} live={e_live}: kernel {kernel_ms * 1e3:.2f} us, "
        f"wrapper (xa/xb matmuls, transposes, zeroing + kernel) "
        f"{wrapper_ms * 1e3:.2f} us, plain {plain_ms * 1e3:.2f} us; bound "
        f"{max(t_ops, t_bytes) * 1e6:.2f} us ({flops / 1e9:.3f} GFLOP, "
        f"{nbytes / 1e6:.2f} MB)")
    return {
        "name": "fused_message_pass_backward",
        "route": "cuda",
        "source": "graph_neural_network_for_radar_perception_torch/csrc/fused_mp.cu",
        "replaces": "graph_neural_network_for_radar_perception_tpu/ops/pallas/fused_mp.py:228",
        "launches": None,
        "max_abs_err": max_err,
        "ms": kernel_ms,
        "plain_ms": plain_ms,
        "wrapper_ms": wrapper_ms,
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


def phase_kernel_csr(torch, C):
    """Phase 4: the CSR forward kernel vs its plain version, two launches
    bitwise, timing; returns the kernel's table row."""
    rng = np.random.default_rng(4)
    max_err = 0.0
    for name, args, src_window in csr_problems(torch, rng):
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
            f"{int((args[3] < N).sum())} src_window={src_window}: max_abs_err="
            f"{float(err.max()):.3e} violations(rtol={RTOL}, atol={ATOL})={bad}; "
            f"two launches bitwise equal={same}")
        if bad or not torch.isfinite(got).all() or not same:
            raise AssertionError(f"fused_message_pass_csr kernel: {name} disagrees")

    # Timing on the kNN graph at the main path's shapes.
    _, args, _ = csr_problems(torch, np.random.default_rng(5))[0]
    x, ef, src, dst, w1, b1, w2, b2 = args[:8]
    layout = C.csr_layout(src, dst, N, CSR_TILE, CSR_WINDOW, 0)
    scal = torch.cat(args[8:])
    agg = torch.empty(N, D2, device="cuda")
    xab = torch.empty(2, N, H, device="cuda")
    fn = C._kernel()
    raw = (x.data_ptr(), ef.data_ptr(), layout.src.data_ptr(),
           layout.dst.data_ptr(), layout.off.data_ptr(), w1.data_ptr(),
           b1.data_ptr(), w2.data_ptr(),
           b2.data_ptr(), scal.data_ptr(), xab.data_ptr(), 0.01,
           agg.data_ptr(), N, E, D, DE, H, D2,
           torch.cuda.current_stream().cuda_stream)
    kernel_ms = event_ms(torch, lambda: fn(*raw))
    with torch.no_grad():  # the wrapper as a round of the model calls it
        wrapper_ms = event_ms(torch, lambda: C.fused_message_pass_csr(
            *args, 0.01, CSR_TILE, CSR_WINDOW, layout=layout))
        layout_ms = event_ms(torch, lambda: C.csr_layout(
            src, dst, N, CSR_TILE, CSR_WINDOW, 0))
    plain_ms = event_ms(torch, lambda: C.fused_message_pass_csr_reference(
        *args, 0.01, CSR_TILE, CSR_WINDOW))

    # Least time for the same work: the node-level products x·W1r, x·W1s
    # once per node, the edge-level products of every edge whose message
    # lands, each input read and the output written once.
    e_live = int((layout.dst < N).sum())
    flops = 2 * 2 * N * D * H + 2 * e_live * (DE * H + H * D2)
    nbytes = 4 * (N * D + E * DE + 2 * E + (2 * D + DE) * H + H + H * D2
                  + D2 + 4 + N * D2)
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
        "bound_ms": max(t_ops, t_bytes) * 1e3,
        "bound_by": "operations" if t_ops >= t_bytes else "bytes",
        "library_ms": None,
    }


CSR_BWD_NAMES = "dx gef dw1 db1 dw2 db2 dg1 dbe1 dg2 dbe2".split()


def phase_kernel_csr_bwd(torch, C):
    """Phase 5: the CSR backward kernel vs its plain version (all 10
    outputs), bitwise agreement of two launches per output, autograd on the
    card vs the CPU, timing; returns the kernel's table row."""
    rng = np.random.default_rng(6)
    max_err = 0.0
    for name, args, src_window in csr_problems(torch, rng):
        args, dropped = drop_kink_edges_csr(torch, args)
        g = torch.from_numpy(
            (G_SCALE * rng.normal(size=(N, D2))).astype(np.float32)).cuda()
        tiling = (0.01, CSR_TILE, CSR_WINDOW, src_window)
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
        log(f"[kernel-csr-bwd] {name} kink edges dropped={dropped}: all 10 "
            f"outputs within rtol={GRAD_RTOL} atol={GRAD_ATOL}; max abs err "
            f"{json.dumps(worst)}; two launches bitwise equal {json.dumps(same)}")
        if not all(same.values()):
            raise AssertionError("fused_message_pass_csr_backward is not deterministic")

    # Autograd through the Function: the card against CPU tensors, on the
    # last (source-windowed) problem.
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

    # Timing on the kNN graph at the main path's shapes.
    _, args, _ = csr_problems(torch, np.random.default_rng(7))[0]
    g = torch.from_numpy((G_SCALE * rng.normal(size=(N, D2))).astype(np.float32)).cuda()
    x, ef, src, dst, w1, b1, w2, b2 = args[:8]
    layout = C.csr_layout(src, dst, N, CSR_TILE, CSR_WINDOW, 0)
    # `results` holds the buffers the raw pointers refer to.
    raw, results = C._backward_launch(x, ef, layout, w1, b1, w2, b2,
                                      torch.cat(args[8:]), g, 0.01)
    fn = C._bwd_kernel()
    kernel_ms = event_ms(torch, lambda: fn(*raw))
    tiling = (0.01, CSR_TILE, CSR_WINDOW)
    wrapper_ms = event_ms(torch, lambda: C.fused_message_pass_csr_backward(
        *args, g, *tiling))
    plain_ms = event_ms(torch, lambda: C.fused_message_pass_csr_backward_reference(
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
        f"wrapper (index preparation, buffers, partial sums + kernel) "
        f"{wrapper_ms * 1e3:.2f} us, plain {plain_ms * 1e3:.2f} us; bound "
        f"{max(t_ops, t_bytes) * 1e6:.2f} us ({flops / 1e9:.3f} GFLOP, "
        f"{nbytes / 1e6:.2f} MB)")
    return {
        "name": "fused_message_pass_csr_backward",
        "route": "cuda",
        "source": "graph_neural_network_for_radar_perception_torch/csrc/csr_mp.cu",
        "replaces": "graph_neural_network_for_radar_perception_tpu/ops/pallas/csr_mp.py:375",
        "launches": None,
        "max_abs_err": max_err,
        "ms": kernel_ms,
        "plain_ms": plain_ms,
        "wrapper_ms": wrapper_ms,
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


def profile_run(torch, fn) -> dict:
    """One call of ``fn`` under torch.profiler, after a warm call: device
    kernels launched, device busy time (union of kernel intervals), host
    wall time, and the kernels that take the most device time."""
    from torch.profiler import ProfilerActivity, profile

    fn()  # warm
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    # The train step's named ranges also appear on the device timeline as
    # annotations spanning their kernels: not kernels, so left out.
    spans = sorted(
        (e.time_range.start, e.time_range.end, e.name) for e in prof.events()
        if e.device_type == torch.autograd.DeviceType.CUDA
        and not e.name.startswith("train_step.")
    )
    ranges = {}  # host time of the train step's named parts
    for e in prof.events():
        if e.name.startswith("train_step.") and e.device_type != torch.autograd.DeviceType.CUDA:
            ranges[e.name] = ranges.get(e.name, 0.0) + (e.time_range.end - e.time_range.start) / 1e3
    busy, end, by_name, count = 0.0, float("-inf"), {}, {}
    for start, stop, name in spans:
        busy += max(0.0, stop - max(start, end))
        end = max(end, stop)
        by_name[name] = by_name.get(name, 0.0) + (stop - start)
        count[name] = count.get(name, 0) + 1
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
    return {
        "wall_ms": wall_us / 1e3,
        "device_kernels": len(spans),
        "device_busy_ms": busy / 1e3,
        "device_idle_share": 1.0 - busy / wall_us,
        "top_kernels_ms_launches": {name[:60]: [t / 1e3, count[name]]
                                    for name, t in top},
        **({"host_ms_by_part": ranges} if ranges else {}),
    }


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
        prof = profile_run(torch, lambda: det_gpu.model.deploy(graph))
    log(f"[deploy] profile of one deploy forward (last frame): {json.dumps(prof)}")
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
    prof = profile_run(torch, lambda: step(state, batches[0]))
    log(f"[train] profile of one train step: {json.dumps(prof)}")
    if not prof["device_kernels"]:
        raise AssertionError("the profiler saw no kernel on the card")
    return fwd, bwd


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
    prof = profile_run(torch, lambda: step(state, batches[0]))
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


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    from graph_neural_network_for_radar_perception_torch.ops import _build
    from graph_neural_network_for_radar_perception_torch.ops import csr_mp as C
    from graph_neural_network_for_radar_perception_torch.ops import fused_mp as FM

    # f32 means f32: no TF32 in matmuls (the default, stated here).
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"[env] torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)} count {torch.cuda.device_count()}")

    t0 = time.perf_counter()
    # One nvcc per source, all started together (each build is a process).
    with ThreadPoolExecutor(max_workers=2) as pool:
        libs = dict(zip(("fused_mp", "csr_mp"),
                        pool.map(_build.build, ("fused_mp", "csr_mp"))))
    FM._kernel(), FM._bwd_kernel(), C._kernel(), C._bwd_kernel()
    log(f"[build] fused_mp (fused_mp_forward, fused_mp_backward), csr_mp "
        f"(csr_mp_forward, csr_mp_backward): {time.perf_counter() - t0:.1f} s -> "
        f"{', '.join(os.path.relpath(p, REPO) for p in libs.values())}")

    fwd_row = phase_kernel(torch, FM)
    bwd_row = phase_kernel_bwd(torch, FM)
    csr_row = phase_kernel_csr(torch, C)
    csr_bwd_row = phase_kernel_csr_bwd(torch, C)
    deploy_launches = phase_deploy(torch, FM)
    train_fwd, train_bwd = phase_train(torch, FM)
    csr_train_fwd, csr_train_bwd = phase_train_csr(torch, FM, C)
    csr_deploy = phase_deploy_csr(torch, FM, C)
    fwd_row["launches"] = deploy_launches + train_fwd
    fwd_row["launches_by_path"] = {"deploy": deploy_launches, "train": train_fwd}
    bwd_row["launches"] = train_bwd
    bwd_row["launches_by_path"] = {"train": train_bwd}
    csr_row["launches"] = csr_deploy + csr_train_fwd
    csr_row["launches_by_path"] = {"deploy-csr": csr_deploy, "train-csr": csr_train_fwd}
    csr_bwd_row["launches"] = csr_train_bwd
    csr_bwd_row["launches_by_path"] = {"train-csr": csr_train_bwd}
    log(json.dumps({"kernels": [fwd_row, bwd_row, csr_row, csr_bwd_row]}))
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    log(smi)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
