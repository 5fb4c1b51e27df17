"""Timing on the card with CUDA events, and the published peaks of one
H100 SXM from which a kernel's least time is computed."""

from __future__ import annotations

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
