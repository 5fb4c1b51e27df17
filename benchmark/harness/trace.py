"""Reduction of a ``torch.profiler`` trace of a stretch of the window.

The stretch lies inside the benchmark's span ``bench.window``; each call
into the program inside ``bench.step`` and each read of its results to
the host inside ``bench.read``.  Device operations (kernels, copies,
sets; not the annotations of profiler ranges on the device timeline)
give the busy time as the union of their intervals within the stretch
(``utils/timing.profile_run``'s arithmetic, over many steps), the
operations that took most time by name, and the idle gaps between them,
each named by the benchmark span the host was in when the gap began.
"""

from __future__ import annotations

from typing import Dict, List

import torch

SPANS = ("bench.step", "bench.read")
_RANGE_PREFIXES = ("bench.", "train_step.", "eval_step.", "detect.", "captured.")


def _is_device_op(e) -> bool:
    return (e.device_type == torch.autograd.DeviceType.CUDA
            and not getattr(e, "is_user_annotation", False)
            and not e.name.startswith(_RANGE_PREFIXES))


def reduce(events) -> Dict:
    """busy_s, window_s, device_ops and idle_gaps ([name, seconds], the
    ten largest each) of the profiled stretch (busy_s 0 where no device
    operation ran)."""
    events = list(events)
    windows = [e for e in events if e.name == "bench.window"
               and e.device_type != torch.autograd.DeviceType.CUDA]
    if not windows:
        raise RuntimeError("the trace holds no bench.window span")
    w0 = min(e.time_range.start for e in windows)
    w1 = max(e.time_range.end for e in windows)
    ops = sorted((max(e.time_range.start, w0), min(e.time_range.end, w1), e.name)
                 for e in events if _is_device_op(e))
    ops = [op for op in ops if op[1] > op[0]]
    spans = sorted((e.time_range.start, e.time_range.end, e.name) for e in events
                   if e.name in SPANS and e.device_type != torch.autograd.DeviceType.CUDA)
    busy, end = 0.0, w0
    by_name: Dict[str, float] = {}
    gaps: List[tuple] = []
    for start, stop, name in ops:
        if start > end:
            gaps.append((start - end, end))
        busy += max(0.0, stop - max(start, end))
        end = max(end, stop)
        by_name[name] = by_name.get(name, 0.0) + (stop - start)
    if w1 > end:
        gaps.append((w1 - end, end))

    def host_span(t):
        inside = [name for a, b, name in spans if a <= t < b]
        return inside[-1] if inside else "bench.loop"

    top_ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    top_gaps = sorted(gaps, reverse=True)[:10]
    return {
        "busy_s": busy / 1e6,
        "window_s": (w1 - w0) / 1e6,
        "device_ops": [[name[:160], us / 1e6] for name, us in top_ops],
        "idle_gaps": [[host_span(t), us / 1e6] for us, t in top_gaps],
    }
