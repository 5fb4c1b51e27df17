"""Profiling and tracing utilities.

The port's tracer (``TRACER``, a ``Tracer``): spans and counters of the
work inside the captured steps, on the host clock, kept in memory until
``drain()``.  A trace capture around a block (``trace``: ``torch.profiler``,
a Chrome trace in place of ``jax.profiler``'s, with the tracer on), and
the JAX package's ``utils/profiling.py``: a per-step wall-clock timer with
percentile summaries, a units/s throughput meter, the analytic FLOP count
of one train step and the model FLOPs utilisation against the card's
dense bf16 peak (``utils/timing``).  The device's busy share and kernel
count of one call are ``utils/timing.profile_run``.
"""

from __future__ import annotations

import contextlib
import itertools
import os
import time
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from .timing import PEAK_BF16_FLOPS, PEAK_F32_FLOPS

# A profiler range opened and closed without a dispatcher call, so that its
# ends lie within microseconds of the span's (``record_function`` closes
# tens of microseconds late while the profiler runs).
_RANGE = getattr(torch._C._profiler, "_RecordFunctionFast", None) or torch.profiler.record_function


class _Off:
    """The span of a tracer that is off: enters and leaves doing nothing."""

    id = call = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_OFF = _Off()


class _Span:
    """A host span, with a device span beside it when ``device`` is a card:
    two timing events from the tracer's pool recorded on the current stream
    at its ends.  ``marks`` (the in-graph spans of a captured graph) makes
    it a replay's span: the graph's previous replay is read first, if it
    was sampled."""

    def __init__(self, tracer: "Tracer", name: str, device=None, call=None, marks=None):
        self.tracer, self.name, self.device, self.marks = tracer, name, device, marks
        self.id, self.call, self.parent = next(tracer._ids), call, None
        self.range = self.events = None

    def __enter__(self):
        tr = self.tracer
        if tr._stack:
            top = tr._stack[-1]
            self.parent, self.call = top.id, self.call or top.call
        self.call = self.call or self.id
        tr._stack.append(self)
        if self.device is not None:
            if self.marks:
                tr._sample(self.marks)
            self.events = tr._event_pair(self.device)
        if torch._C._autograd._profiler_enabled():
            self.range = _RANGE(self.name)
            self.range.__enter__()
        self.start = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        end = time.perf_counter_ns()
        if self.range is not None:
            self.range.__exit__(None, None, None)
        tr = self.tracer
        tr._spans.append(dict(name=self.name, id=self.id, parent=self.parent, call=self.call,
                              where="host", start_ns=self.start, end_ns=end))
        if self.events is not None:
            self.events[1].record(torch.cuda.current_stream(self.device))
            dev = dict(name=self.name, id=next(tr._ids), parent=self.id, call=self.call,
                       where="device", start_ns=None, end_ns=None)
            tr._spans.append(dev)
            tr._pending.append((dev, self.device, *self.events))
            if self.marks:
                if tr._marked % tr.SAMPLE_EVERY == 0:
                    tr._inflight[id(self.marks)] = (self.marks, dev, self.device, self.events[1])
                tr._marked += 1
        tr._stack.pop()
        return False


class _Mark:
    """A device span captured into a CUDA graph: two timing events recorded
    as nodes of the graph (``external``), so that every replay records
    them again; ``Tracer.marking`` keeps them with the graph."""

    def __init__(self, tracer: "Tracer", name: str):
        self.tracer, self.name = tracer, name

    def __enter__(self):
        tr = self.tracer
        parent = tr._mark_stack[-1] if tr._mark_stack else None
        self.entry = [self.name, parent, torch.cuda.Event(enable_timing=True, external=True),
                      torch.cuda.Event(enable_timing=True, external=True)]
        self.index = len(tr._marks)
        tr._marks.append(self.entry)
        tr._mark_stack.append(self.index)
        self.entry[2].record()
        return self

    def __exit__(self, *exc):
        self.entry[3].record()
        self.tracer._mark_stack.pop()
        return False


class Tracer:
    """Spans and counters of the port, on one clock, off by default.

    A span records its name, its id, its parent's id (the span open around
    it), the id of its call (the outermost span's, or the one it is given:
    the host and device spans of one call share it), and its start and end
    in ``time.perf_counter_ns()``.  Host spans (``span``) cost one flag
    test while the tracer is off and record nothing; while a profiler runs
    each also opens a profiler range of its name, so that a
    ``torch.profiler`` trace shows it beside the kernels.  ``once`` spans
    (a capture's warm-ups and the capture itself) are recorded whether or
    not the tracer is on.  Device spans come from CUDA timing events: a
    host span given a card also records an event pair from a pool on the
    current stream; a ``graph_span`` inside a capture while the tracer is
    on is an event pair captured into the graph.  Every replay records the
    graph's events again, so they are read for one replay in
    ``SAMPLE_EVERY`` (reading takes ~6 us an event on the host), before
    the next replay of its graph is launched (and the last one at
    ``drain``): the host waits there for the sampled replay to end, as it
    otherwise runs ahead of the card.  Device times are put on the host
    clock through one anchor per card: an event recorded on an idle
    stream, waited for, and the host clock read around it.  ``enable``
    readies a pool of ``EVENTS`` timing events a card, so that no span
    creates one.

    Counters (``count``) add up while the tracer is on; ``watch`` names
    counters kept elsewhere (the launch counters, the captures' replays and
    warm-ups, the collectives' ``STATS``), which ``drain`` reads in place.
    ``drain`` waits for the cards, and returns and forgets the spans and
    the tracer's own counts: ``{"spans": [...], "counters": {...}}``."""

    SAMPLE_EVERY = 4
    EVENTS = 512

    def __init__(self):
        self.enabled = False
        self._ids = itertools.count(1)
        self._spans: List[dict] = []
        self._stack: List[_Span] = []
        self._pending: List[tuple] = []     # (device record, card, start, end event)
        self._inflight: Dict[int, tuple] = {}  # id(marks) -> the last replay of their graph
        self._marked = 0                     # replays of graphs with in-graph spans
        self._free: Dict[torch.device, List[torch.cuda.Event]] = {}
        self._anchors: Dict[torch.device, tuple] = {}
        self._marks: Optional[list] = None  # the in-graph spans of the capture under way
        self._mark_stack: List[int] = []
        self._counters: Dict[str, int] = {}
        self._watched: Dict[str, Callable[[], Any]] = {}

    def enable(self) -> None:
        """Switch tracing on; anchor the current card's clock and ready its
        events; the first replay of a graph with in-graph spans from here
        is read, then one in ``SAMPLE_EVERY``."""
        self.enabled = True
        self._marked = 0
        if torch.cuda.is_available():
            self._anchor(torch.device("cuda", torch.cuda.current_device()))

    def disable(self) -> None:
        self.enabled = False

    def span(self, name: str, device: Optional[torch.device] = None, call=None, marks=None):
        """A host span (and a device span when ``device`` is a card) around
        a block while the tracer is on; the shared no-op while it is off."""
        if not self.enabled:
            return _OFF
        if device is not None and device.type == "cuda":
            if device.index is None:
                device = torch.device("cuda", torch.cuda.current_device())
        else:
            device = None
        return _Span(self, name, device, call, marks)

    def once(self, name: str) -> _Span:
        """A host span of one-off work, recorded whether or not the tracer is on."""
        return _Span(self, name)

    @property
    def graph_marking(self) -> bool:
        """Whether a ``graph_span`` opened now is captured into a graph: the
        tracer is on, ``marking``, and the current stream is capturing."""
        return (self.enabled and self._marks is not None
                and torch.cuda.is_current_stream_capturing())

    def graph_span(self, name: str):
        """A device span captured into the CUDA graph under capture, while
        ``graph_marking``; the no-op otherwise.  It may also be entered and
        left by hand from two places, as long as nothing opened in between
        is left open (``models/gat.py``'s backward span)."""
        return _Mark(self, name) if self.graph_marking else _OFF

    @contextlib.contextmanager
    def marking(self):
        """Collect the ``graph_span``s of a capture: yields their list
        (empty unless the tracer is on), which the graph keeps and passes
        as ``marks`` to the span of each of its replays."""
        self._marks, self._mark_stack = [], []
        try:
            yield self._marks
        finally:
            self._marks = None

    def count(self, name: str, n: int = 1) -> None:
        self._counters[name] = self._counters.get(name, 0) + n

    def watch(self, name: str, read: Callable[[], Any]) -> None:
        """Report ``read()`` under ``name`` at every ``drain``."""
        self._watched[name] = read

    def drain(self) -> Dict[str, Any]:
        cards = {p[1] for p in self._pending} | {v[2] for v in self._inflight.values()}
        for card in cards:
            torch.cuda.synchronize(card)
        for marks, *_ in list(self._inflight.values()):
            self._sample(marks)
        for rec, card, start, end in self._pending:
            rec["start_ns"], rec["end_ns"] = self._host_ns(card, start), self._host_ns(card, end)
            self._free[card] += (start, end)
        self._pending = []
        spans, self._spans = self._spans, []
        counters, self._counters = self._counters, {}
        counters.update({name: read() for name, read in self._watched.items()})
        return {"spans": spans, "counters": counters}

    # ---------------------------------------------------------------- device
    def _anchor(self, card: torch.device) -> None:
        free = self._free.setdefault(card, [])
        stream = torch.cuda.current_stream(card)
        for _ in range(self.EVENTS - len(free)):
            free.append(torch.cuda.Event(enable_timing=True))
            free[-1].record(stream)  # creates it
        best = None
        for _ in range(5):
            ev = torch.cuda.Event(enable_timing=True)
            t0 = time.perf_counter_ns()
            ev.record(torch.cuda.current_stream(card))
            ev.synchronize()
            t1 = time.perf_counter_ns()
            if best is None or t1 - t0 < best[2] - best[1]:
                best = (ev, t0, t1)
        self._anchors[card] = (best[0], (best[1] + best[2]) // 2)

    def _host_ns(self, card: torch.device, event: torch.cuda.Event) -> int:
        anchor, host = self._anchors[card]
        return host + round(anchor.elapsed_time(event) * 1e6)

    def _event_pair(self, card: torch.device) -> list:
        """Two timing events from the pool, the first recorded now."""
        if card not in self._anchors:
            self._anchor(card)
        free = self._free[card]
        pair = [free.pop() if free else torch.cuda.Event(enable_timing=True) for _ in range(2)]
        pair[0].record(torch.cuda.current_stream(card))
        return pair

    def _sample(self, marks: list) -> None:
        """Read the in-graph spans of the last replay of ``marks``' graph,
        if it was sampled, once it is complete: the next replay overwrites
        them."""
        entry = self._inflight.pop(id(marks), None)
        if entry is None:
            return
        _, rec, card, last = entry
        last.synchronize()
        ids = [next(self._ids) for _ in marks]
        for i, (name, parent, start, end) in enumerate(marks):
            self._spans.append(dict(
                name=name, id=ids[i], parent=rec["id"] if parent is None else ids[parent],
                call=rec["call"], where="device", start_ns=self._host_ns(card, start),
                end_ns=self._host_ns(card, end)))
        self.count("captured.sampled_replays")


TRACER = Tracer()


@contextlib.contextmanager
def trace(log_dir: str):
    """Capture a ``torch.profiler`` trace of the host and, where there is
    one, the card around a code block, with ``TRACER`` on (its host spans
    appear as ranges beside the kernels); it is written to
    ``log_dir/trace.json`` (Chrome trace format, viewable in Perfetto).
    The tracer's spans stay in memory for ``TRACER.drain()``."""
    from torch.profiler import ProfilerActivity, profile

    os.makedirs(log_dir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    was = TRACER.enabled
    TRACER.enable()
    try:
        with profile(activities=activities) as prof:
            yield log_dir
            if torch.cuda.is_available():
                torch.cuda.synchronize()
    finally:
        TRACER.enabled = was
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


class StepTimer:
    """Wall-clock step timing with percentile summaries.

    Use `with timer.step():` around each iteration; the device sync is the
    caller's responsibility (time dispatch only, or synchronise first)."""

    def __init__(self, max_records: int = 10_000):
        self._times: List[float] = []
        self._max = max_records

    @contextlib.contextmanager
    def step(self):
        t0 = time.perf_counter()
        yield
        if len(self._times) < self._max:
            self._times.append(time.perf_counter() - t0)

    def summary(self) -> Dict[str, float]:
        if not self._times:
            return {}
        arr = np.asarray(self._times)
        return {
            "steps": int(arr.size),
            "mean_ms": float(arr.mean() * 1e3),
            "p50_ms": float(np.percentile(arr, 50) * 1e3),
            "p90_ms": float(np.percentile(arr, 90) * 1e3),
            "p99_ms": float(np.percentile(arr, 99) * 1e3),
        }

    def reset(self):
        self._times.clear()


class ThroughputMeter:
    """Edges/s (or any unit/s) over a sliding window."""

    def __init__(self, units_per_step: float):
        self.units_per_step = units_per_step
        self._t0: Optional[float] = None
        self._steps = 0

    def start(self):
        self._t0 = time.perf_counter()
        self._steps = 0

    def tick(self, n: int = 1):
        self._steps += n

    def rate(self) -> float:
        if self._t0 is None or self._steps == 0:
            return 0.0
        dt = time.perf_counter() - self._t0
        return self._steps * self.units_per_step / max(dt, 1e-9)


def flops_per_train_step(cfg, batch_size: int) -> float:
    """Analytic FLOP estimate of one fwd+bwd train step of the flagship
    GNN (message MLPs dominate), for MFU-style reporting."""
    e = cfg.max_edges
    n = cfg.max_nodes
    d = cfg.graph_convolution_stem_channels[-1]
    h = cfg.msg_mlp_hidden_dim
    rounds = len(cfg.graph_convolution_stem_channels)
    msg = e * (3 * d * h + h * d) * 2           # msg MLP fwd MACs→FLOPs
    upd = n * (2 * d * d) * 2
    enc = n * sum(
        a * b * 2 for a, b in zip(
            (cfg.input_node_feat_dim,) + tuple(cfg.node_feat_enc_stem_channels[:-1]),
            cfg.node_feat_enc_stem_channels,
        )
    ) + e * sum(
        a * b * 2 for a, b in zip(
            (cfg.input_edge_feat_dim,) + tuple(cfg.edge_feat_enc_stem_channels[:-1]),
            cfg.edge_feat_enc_stem_channels,
        )
    )
    fwd = rounds * (msg + upd) + enc
    return 3.0 * fwd * batch_size  # bwd ≈ 2× fwd


# Dense bf16 matmul peak of a card by the name CUDA reports, as the JAX
# package keeps the TPU's (its MFU denominator), and its f32 peak outside
# the tensor cores.  Only the H100 SXM is known: the PCIe and NVL parts
# have other peaks.
_PEAK_FLOPS = {
    "NVIDIA H100 80GB HBM3": {"bf16": PEAK_BF16_FLOPS, "f32": PEAK_F32_FLOPS},
    "NVIDIA H100 SXM": {"bf16": PEAK_BF16_FLOPS, "f32": PEAK_F32_FLOPS},
}


def device_peak_flops(device=None, dtype: str = "bf16") -> Optional[float]:
    """Peak FLOP/s of the card (``device``: a CUDA device or its index,
    default the current one) for ``dtype`` ("bf16": dense, on the tensor
    cores; "f32": outside them), or None on the CPU or for a card whose
    peak is not known.  MFU = measured FLOP/s / this."""
    if device is not None and not isinstance(device, int) and torch.device(device).type != "cuda":
        return None
    if not torch.cuda.is_available():
        return None
    name = torch.cuda.get_device_name(device)
    for key, peaks in _PEAK_FLOPS.items():
        if name.startswith(key):
            return peaks[dtype]
    return None


def mfu(analytic_flops: float, seconds: float, device=None) -> Optional[float]:
    """Model FLOPs utilisation: analytic model FLOPs per wall-second over
    the card's bf16 peak.  None when the peak is unknown."""
    peak = device_peak_flops(device)
    if peak is None or seconds <= 0:
        return None
    return analytic_flops / seconds / peak
