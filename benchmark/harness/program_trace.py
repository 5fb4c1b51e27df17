"""The program's own spans and counters in a traced run, for the readers
of ``metrics/`` that read them.

The port's tracer (``TRACER`` of its ``utils/profiling``) is reached
through the configuration's program adapter (``ctx.modules.program``, by
default ``harness/program.py``: its ``steps.TRACER``).  ``get(ctx)`` runs
once per traced run and keeps its result on ``ctx``:

1. the one-off spans the program has recorded so far (``setup``): the
   set-up's captures, and any capture in the window;
2. a fresh train state from the seed's weights with the program's step;
   the tracer on; one call, which captures the step with its device spans
   and replays it (``capture``);
3. ``mix["profile_steps"]`` calls over the pool from its second batch, at
   the mix's read cadence (``cell._loop``), then the tracer off
   (``stretch``; ``window_ns``: the host clock before the first call and
   after the device finished).

Each part is what ``TRACER.drain()`` returned: ``spans`` (dicts: name, id,
parent, call, where "host" or "device", start_ns, end_ns, all on the host
clock) and ``counters``.  None off the card and where the program has no
tracer: the readers then report nothing.  The functions below reduce a
part to the readers' numbers.
"""

from __future__ import annotations

import statistics
import time
from typing import Dict, List, Optional, Sequence, Tuple

from harness import cell
from harness.weights import make_weights

COPY = "captured.copy"
ONE_OFF = ("captured.warmup", "captured.capture")
STEP = {"train": "train_step", "eval": "eval_step"}  # the step's span names by mix kind

Interval = Tuple[int, int]


def get(ctx) -> Optional[dict]:
    if not hasattr(ctx, "program_trace"):
        ctx.program_trace = _run(ctx) if ctx.device.type == "cuda" else None
    return ctx.program_trace


def _run(ctx) -> Optional[dict]:
    adapter = ctx.modules.program
    tracer = getattr(getattr(adapter, "steps", None), "TRACER", None)
    if tracer is None:
        return None
    setup = tracer.drain()
    state = ctx.program.train_state(make_weights(ctx.cfg, ctx.seed, ctx.device,
                                                 ctx.modules.reference))
    batches = [adapter.as_batch(b) for b in ctx.pool]
    if ctx.mode == "train":
        train_fn = ctx.program.train_step()

        def step(batch):
            return train_fn(state, batch)[1]
    else:
        eval_fn = ctx.program.eval_step()

        def step(batch):
            return eval_fn(state.model, batch)
    tracer.enable()
    try:
        step(batches[0])
        capture = tracer.drain()
        t0 = time.perf_counter_ns()
        cell._loop(step, batches, 1, 0.0, ctx.mix, ctx.device, False, cell.Window(),
                   max_steps=ctx.mix["profile_steps"])
        t1 = time.perf_counter_ns()
        stretch = tracer.drain()
    finally:
        tracer.disable()
    return {"setup": setup, "capture": capture, "stretch": stretch, "window_ns": (t0, t1)}


# ------------------------------------------------------------ intervals
def union(intervals: Sequence[Interval]) -> List[Interval]:
    """Disjoint sorted intervals covering the same points."""
    out: List[List[int]] = []
    for a, b in sorted(intervals):
        if b <= a:
            continue
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def measure(intervals: Sequence[Interval], lo: int, hi: int) -> int:
    """Length of the union of ``intervals`` within [lo, hi]."""
    return sum(max(0, min(b, hi) - max(a, lo)) for a, b in union(intervals))


def idle_within(host: Sequence[Interval], busy: Sequence[Interval], lo: int, hi: int) -> int:
    """Length of the time within [lo, hi] in which the host was inside one
    of the ``host`` spans and the device inside none of the ``busy`` ones:
    a device gap put down to the host span it fell in."""
    busy = union(busy)
    total = 0
    for a, b in union(host):
        a, b = max(a, lo), min(b, hi)
        if b <= a:
            continue
        total += (b - a) - measure(busy, a, b)
    return total


# ------------------------------------------------------------ the numbers
def _spans(part: dict, name: str, where: str) -> List[dict]:
    return [s for s in part["spans"] if s["name"] == name and s["where"] == where]


def _ns(s: dict) -> int:
    return s["end_ns"] - s["start_ns"]


def copy_host_ms(t: dict) -> Optional[float]:
    """Mean host ms of a call's ``captured.copy`` over the stretch."""
    host = _spans(t["stretch"], COPY, "host")
    return sum(map(_ns, host)) / len(host) / 1e6 if host else None


def copy_gbps(t: dict) -> Optional[float]:
    """The stretch's ``captured.copy_bytes`` over its copies' device time, in GB/s."""
    device = sum(map(_ns, _spans(t["stretch"], COPY, "device")))
    nbytes = t["stretch"]["counters"].get("captured.copy_bytes", 0)
    return nbytes / device if device > 0 and nbytes else None


def copy_stall_share(t: dict) -> Optional[float]:
    """Share (%) of the stretch's wall time in which the device was in a
    batch copy, or idle (outside every copy and replay device span) while
    the host was inside ``captured.copy``."""
    part, (lo, hi) = t["stretch"], t["window_ns"]
    host = [(s["start_ns"], s["end_ns"]) for s in _spans(part, COPY, "host")]
    copies = [(s["start_ns"], s["end_ns"]) for s in _spans(part, COPY, "device")]
    if not host or not copies or hi <= lo:
        return None
    hosts = {s["id"] for s in part["spans"] if s["where"] == "host"}
    busy = [(s["start_ns"], s["end_ns"]) for s in part["spans"]
            if s["where"] == "device" and s["parent"] in hosts]
    return 100.0 * (measure(copies, lo, hi) + idle_within(host, busy, lo, hi)) / (hi - lo)


def _replays(part: dict, label: str) -> Dict[int, dict]:
    """The replays of the stretch whose in-graph spans were read, by call:
    their device span and those spans (the device spans whose parent is a
    device span)."""
    hosts = {s["id"] for s in part["spans"] if s["where"] == "host"}
    by_call: Dict[int, dict] = {}
    for s in part["spans"]:
        if s["where"] == "device" and s["name"] == label:
            by_call.setdefault(s["call"], {"inner": []})["replay"] = s
    for s in part["spans"]:
        entry = by_call.get(s["call"])
        if entry is not None and s["where"] == "device" and s["parent"] not in hosts:
            entry["inner"].append(s)
    return {c: e for c, e in by_call.items() if e["inner"]}


def phase_ms(t: dict, mode: str, phase: str) -> Optional[float]:
    """Median over the sampled replays of the ``mode`` step of the device
    ms of their in-graph span ``<step>.<phase>``."""
    step = STEP[mode]
    times = [_ns(s) / 1e6 for e in _replays(t["stretch"], f"{step}.replay").values()
             for s in e["inner"] if s["name"] == f"{step}.{phase}"]
    return statistics.median(times) if times else None


def mp_share(t: dict, mode: str) -> Optional[float]:
    """The ``mp.*`` device time of the sampled replays of the ``mode`` step
    over their device spans, in %."""
    replays = _replays(t["stretch"], f"{STEP[mode]}.replay").values()
    whole = sum(_ns(e["replay"]) for e in replays)
    mp = sum(_ns(s) for e in replays for s in e["inner"] if s["name"].startswith("mp."))
    return 100.0 * mp / whole if whole > 0 and mp > 0 else None


def capture_s(t: dict) -> Optional[float]:
    """Seconds of the one-off spans recorded before the reader ran."""
    spans = [s for s in t["setup"]["spans"] if s["name"] in ONE_OFF]
    return sum(map(_ns, spans)) / 1e9 if spans else None
