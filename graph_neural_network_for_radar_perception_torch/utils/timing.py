"""Timing on the card with CUDA events, the device kernels and busy share
of a call from ``torch.profiler``, and the published peaks of one H100 SXM
from which a kernel's least time is computed."""

from __future__ import annotations

import time

import numpy as np
import torch

# Published peaks of one H100 SXM at its 700 W limit (NVIDIA data sheet):
# f32 outside the tensor cores, dense bf16 on the tensor cores, and HBM3
# bandwidth.
PEAK_F32_FLOPS = 67e12
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES_PER_S = 3.35e12


def event_ms(fn, reps: int = 50, inner: int = 20) -> float:
    """Median over ``reps`` of the CUDA-event time of ``inner`` back-to-back
    calls, per call, after 10 warm-up calls (host launch cost included when
    the kernel is shorter than it)."""
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


def graph_ms(fn, inner: int = 20, reps: int = 50) -> float:
    """Device time per call: ``inner`` calls captured as one CUDA graph and
    replayed (no host launch cost), median over ``reps`` replays."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(inner):
            fn()
    return event_ms(graph.replay, reps=reps, inner=1) / inner


def kernel_breakdown(fn) -> list:
    """The device kernels of one call of ``fn`` (after a warm call), in the
    order they started on the card: ``[(name, µs), ...]`` from
    ``torch.profiler``."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    spans = sorted((e.time_range.start, e.time_range.end - e.time_range.start, e.name)
                   for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA)
    return [(name, float(us)) for _, us, name in spans]


def profile_run(fn) -> dict:
    """One call of ``fn`` under torch.profiler, after a warm call: device
    kernels launched, device busy time (union of kernel intervals), host
    wall time, the card's idle share of it, the kernels that take the most
    device time, and the host time of the train step's named parts
    (``train_step.*`` ranges) where it has them."""
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
