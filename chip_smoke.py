#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each reported on its own line:

1. build the port's CUDA kernel from ``csrc/`` with nvcc;
2. hold the kernel against its plain PyTorch version on the card at the
   deploy path's shapes (N=768, E=15360, D=De=D2=64, H=128, plus a ragged
   E) and time both with CUDA events;
3. drive the deploy path — ``FrameDetector(GNNConfig(), ...)``, the shipped
   widths with random weights from a seeded ``torch.Generator`` — over
   synthetic frames at the default capacities, count the kernel's launches,
   and compare logits and decisions with the same detector on the CPU (which
   runs the plain version);
4. print the kernel table as JSON and the card's name and power limit.

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

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))

# Published peaks of one H100 SXM at its 700 W limit (NVIDIA data sheet):
# f32 outside the tensor cores, and HBM3 bandwidth.
PEAK_F32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12

N, E, D, DE, H, D2 = 768, 15360, 64, 64, 128, 64
RTOL, ATOL = 2e-4, 2e-5              # kernel vs plain (atomics reorder sums)
DEPLOY_RTOL, DEPLOY_ATOL = 1e-3, 1e-4  # 7 rounds of card vs CPU arithmetic
NUM_FRAMES = 8


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


def profile_deploy(torch, model, graph) -> dict:
    """One deploy forward under torch.profiler: device kernels launched,
    device busy time (union of kernel intervals), host wall time, and the
    kernels that take the most device time."""
    from torch.profiler import ProfilerActivity, profile

    with torch.no_grad():
        model.deploy(graph)  # warm
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            model.deploy(graph)
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
    spans = sorted(
        (e.time_range.start, e.time_range.end, e.name) for e in prof.events()
        if e.device_type == torch.autograd.DeviceType.CUDA
    )
    busy, end, by_name = 0.0, float("-inf"), {}
    for start, stop, name in spans:
        busy += max(0.0, stop - max(start, end))
        end = max(end, stop)
        by_name[name] = by_name.get(name, 0.0) + (stop - start)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:4]
    return {
        "wall_ms": wall_us / 1e3,
        "device_kernels": len(spans),
        "device_busy_ms": busy / 1e3,
        "device_idle_share": 1.0 - busy / wall_us,
        "top_kernels_ms": {name[:60]: t / 1e3 for name, t in top},
    }


def phase_deploy(torch, FM):
    """Phase 3: the deploy path on the card, against the CPU."""
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
    prof = profile_deploy(torch, det_gpu.model, graph)
    log(f"[deploy] profile of one deploy forward (last frame): {json.dumps(prof)}")
    if not prof["device_kernels"]:
        raise AssertionError("the profiler saw no kernel on the card")
    return launches


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    from graph_neural_network_for_radar_perception_torch.ops import _build
    from graph_neural_network_for_radar_perception_torch.ops import fused_mp as FM

    # f32 means f32: no TF32 in matmuls (the default, stated here).
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"[env] torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)} count {torch.cuda.device_count()}")

    t0 = time.perf_counter()
    lib = _build.build("fused_mp")
    log(f"[build] fused_mp: {time.perf_counter() - t0:.1f} s -> {os.path.relpath(lib, REPO)}")

    row = phase_kernel(torch, FM)
    row["launches"] = phase_deploy(torch, FM)
    log(json.dumps({"kernels": [row]}))
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
