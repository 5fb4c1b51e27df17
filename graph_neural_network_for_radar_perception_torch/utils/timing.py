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

# The CUDA API calls by which the host launches work on the card,
# as torch.profiler names them: a kernel each, or a whole CUDA graph.
HOST_LAUNCH_CALLS = frozenset((
    "cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel", "cuLaunchKernelEx",
    "cudaGraphLaunch", "cuGraphLaunch"))
HOST_COPY_CALLS = frozenset(("cudaMemcpyAsync", "cudaMemcpy", "cuMemcpyAsync",
                             "cuMemcpyHtoDAsync_v2", "cuMemcpyDtoHAsync_v2"))
# The names of the tracer's spans (``utils/profiling.TRACER``: a step's
# parts and replay, an eval step's, a detector's, any other capture's
# replay and copy, the message rounds), which a profiled span opens as a
# range: on the device timeline such a range is an annotation that spans
# kernels, not a kernel.
RANGE_PREFIXES = ("train_step.", "eval_step.", "detect.", "captured.", "mp.")


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
    kernels launched, launches the host issued (CUDA API calls that
    launch a kernel or a CUDA graph) and its memory copies, device busy time (union of
    kernel intervals), host wall time, the card's idle share of it, and the
    kernels that take the most device time."""
    from torch.profiler import ProfilerActivity, profile

    fn()  # warm
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    # The tracer's ranges also appear on the device timeline as annotations
    # spanning their kernels: not kernels, so left out.
    spans = sorted(
        (e.time_range.start, e.time_range.end, e.name) for e in prof.events()
        if e.device_type == torch.autograd.DeviceType.CUDA
        and not e.name.startswith(RANGE_PREFIXES)
    )
    host_calls = [e.name for e in prof.events()
                  if e.device_type != torch.autograd.DeviceType.CUDA]
    host_launches = sum(1 for name in host_calls if name in HOST_LAUNCH_CALLS)
    host_copies = sum(1 for name in host_calls if name in HOST_COPY_CALLS)
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
        "host_launches": host_launches,
        "host_copies": host_copies,
        "device_busy_ms": busy / 1e3,
        "device_idle_share": 1.0 - busy / wall_us,
        "top_kernels_ms_launches": {name[:60]: [t / 1e3, count[name]]
                                    for name, t in top},
    }
