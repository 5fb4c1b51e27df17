"""CUDA-graph capture and replay: the port's counterpart of ``jax.jit``.

``CapturedGraphs`` runs a body on static device buffers, captured as one
CUDA graph per key and replayed; ``CapturedStep`` is its form for a step
that writes a state (every train step of the port, the finetuning,
classifier and grid-CNN steps and the grid steps of ``parallel/``);
``infer/pipeline.FrameDetector`` and ``train/steps.make_eval_step`` use
``CapturedGraphs`` itself.  A batch's arrays reach a graph's buffers
through pinned, double-buffered staging (``_Staging``).

Counters.  A replay launches what its capture recorded, while the Python
wrappers that count their launches run only at capture.  So a module that
counts (a kernel wrapper's launches, the collectives' calls and bytes)
registers its counters here (``register_counters``, or
``count_launches`` for int attributes of its wrapper functions), and a
capture takes back the advance it read from every registered source and
adds it at each replay.  This module names no counter of its own: it
imports nothing of ``ops/``, ``parallel/``, ``models/``, ``infer/`` or
``train/``.
"""

from __future__ import annotations

import weakref
from typing import Any, Callable, Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from ..utils.profiling import TRACER
from .graph import GraphBatch


# ------------------------------------------------------------ counters
class Counters(NamedTuple):
    """A source of counters: ``read()`` gives their values, ``add(deltas)``
    adds to them (both in ``names``' order)."""

    names: Tuple[str, ...]
    read: Callable[[], List[int]]
    add: Callable[[Sequence[int]], None]


_SOURCES: List[Counters] = []
_LAUNCHES: List[Tuple[Any, str]] = []


def register_counters(names: Sequence[str], read: Callable[[], List[int]],
                      add: Callable[[Sequence[int]], None]) -> None:
    """Register a source of counters that a replay advances by what its
    capture recorded.  ``names`` are unique over every source."""
    _SOURCES.append(Counters(tuple(names), read, add))


def count_launches(*counters: Tuple[Any, str]) -> None:
    """Register launch counters, int attributes of the wrapper functions
    that launch kernels, as ``(function, attribute)`` pairs: one source,
    its names ``function.attribute``, reported by the ``launches`` watch."""
    _LAUNCHES.extend(counters)

    def add(deltas: Sequence[int]) -> None:
        for (f, a), d in zip(counters, deltas):
            setattr(f, a, getattr(f, a) + d)

    register_counters([f"{f.__name__}.{a}" for f, a in counters],
                      lambda: [getattr(f, a) for f, a in counters], add)


def _read_sources() -> Dict[str, int]:
    return {n: v for src in _SOURCES for n, v in zip(src.names, src.read())}


TRACER.watch("launches", lambda: {f"{f.__name__}.{a}": getattr(f, a) for f, a in _LAUNCHES})


# ------------------------------------------------------------ memory pool
_POOLS: Dict[torch.device, tuple] = {}


def _pool(device: torch.device):
    """The one CUDA-graph memory pool of this process's captured graphs on
    ``device`` (every train step, each bucket's included, every detector's
    deploy, the eval steps and the finetuning, classifier and grid-CNN
    steps): they replay one at a time, so they share it.  A pool whose
    graphs are all gone cannot take another capture, so a graph of one
    allocation holds it for the process."""
    if device not in _POOLS:
        keeper = torch.cuda.CUDAGraph()
        with torch.cuda.device(device), torch.cuda.graph(keeper):
            torch.zeros(1, device=device)
        _POOLS[device] = (keeper.pool(), keeper)
    return _POOLS[device][0]


# ------------------------------------------------------------ staging
STAGING_ALIGN = 256  # bytes: each staged leaf starts at a multiple of this


def _on_card(a) -> bool:
    """Whether a leaf is already device memory (copied on the device, never staged)."""
    return bool(getattr(a, "is_cuda", False))


def _leaf_dtype(a) -> torch.dtype:
    return a.dtype if torch.is_tensor(a) else torch.from_numpy(np.empty(0, a.dtype)).dtype


def _staging_layout(leaves) -> Tuple[List[Optional[int]], int]:
    """One flat layout of the leaves that are host memory (numpy arrays,
    CPU tensors, pinned or not): each one's byte offset, a multiple of
    ``STAGING_ALIGN``, or None for a leaf on a card; and the layout's size
    in bytes."""
    offsets, end = [], 0
    for a in leaves:
        if _on_card(a):
            offsets.append(None)
        else:
            offsets.append(end)
            end += -(-a.nbytes // STAGING_ALIGN) * STAGING_ALIGN
    return offsets, end


def _leaf_views(flat: torch.Tensor, leaves, offsets) -> list:
    """Each laid-out leaf's view of the flat byte buffer ``flat``, at its
    offset, dtype and shape; None for a leaf off the layout."""
    return [None if off is None else
            flat[off:off + a.nbytes].view(_leaf_dtype(a)).view(tuple(a.shape))
            for a, off in zip(leaves, offsets)]


def _as_tensor(a) -> torch.Tensor:
    return a if torch.is_tensor(a) else torch.from_numpy(np.ascontiguousarray(a))


class _Staging:
    """A captured graph's static inputs and the way a batch reaches them.

    The leaves that were host memory at capture (``_staging_layout``) are
    views of one flat device buffer; a leaf on a card has a buffer of its
    own.  Two pinned host buffers of the same layout serve in turn, each
    guarded by an event recorded after its copy to the card.  ``copy``
    writes the host leaves into the turn's pinned buffer on the host (a
    numpy array by ``np.copyto`` on the calling thread: torch's CPU copy of
    a large array wakes its thread pool, whose threads then compete with
    the host's waits for the card) and copies it to the card in one
    asynchronous DMA on the current stream, then copies the other leaves
    on the device: stream order alone keeps the DMA behind the previous
    replay and ahead of the next, and the caller's arrays are read in full
    before it returns.  ``wait`` blocks until the turn's pinned buffer is
    free, the one host wait of a copy."""

    def __init__(self, leaves, device: torch.device):
        self.offsets, nbytes = _staging_layout(leaves)
        self.flat = torch.empty(nbytes, dtype=torch.uint8, device=device)
        self.inputs = [torch.empty(tuple(a.shape), dtype=_leaf_dtype(a), device=device)
                       if v is None else v
                       for a, v in zip(leaves, _leaf_views(self.flat, leaves, self.offsets))]
        self.pinned = [torch.empty(nbytes, dtype=torch.uint8, pin_memory=device.type == "cuda")
                       for _ in range(2 if nbytes else 0)]
        self.host = [_leaf_views(h, leaves, self.offsets) for h in self.pinned]
        self.host_np = [[v.numpy() if isinstance(a, np.ndarray) and v is not None else None
                         for v, a in zip(views, leaves)] for views in self.host]
        self.done = [torch.cuda.Event() for _ in self.pinned]
        self.turn = 0

    def wait(self) -> bool:
        """Wait until the turn's pinned buffer has left for the card;
        whether that took a wait."""
        if not self.done or self.done[self.turn].query():
            return False
        self.done[self.turn].synchronize()
        return True

    def copy(self, leaves) -> int:
        """Copy ``leaves`` into the inputs; returns the bytes staged."""
        staged, rest = 0, []
        for i, a in enumerate(leaves):
            if self.offsets[i] is None or _on_card(a):
                rest.append((self.inputs[i], a))
                continue
            dst, dst_np = self.host[self.turn][i], self.host_np[self.turn][i]
            if dst_np is not None and isinstance(a, np.ndarray):
                np.copyto(dst_np, a, casting="unsafe")
            else:
                dst.copy_(_as_tensor(a))
            staged += dst.nbytes
        if staged:
            self.flat.copy_(self.pinned[self.turn], non_blocking=True)
            self.done[self.turn].record()
            self.turn ^= 1
        for buf, a in rest:
            buf.copy_(_as_tensor(a))
        return staged


# ------------------------------------------------------------ capture
class _Captured(NamedTuple):
    graph: torch.cuda.CUDAGraph
    staging: _Staging           # the static input buffers and how a batch reaches them
    outputs: Any
    deltas: List[List[int]]     # each source's advance per replay, in registry order
    keep: Any                   # kept alive: the graph reads or writes it
    marks: list                 # its device spans (TRACER.marking), empty untraced

    @property
    def launches(self) -> Dict[str, int]:
        """Each registered counter's advance per replay, by name."""
        return {n: d for src, ds in zip(_SOURCES, self.deltas) for n, d in zip(src.names, ds)}


class CapturedGraphs:
    """``body(inputs)`` on a CUDA device, where ``inputs`` is a list of
    static device buffers, captured as one CUDA graph per key and replayed
    (the counterpart of ``jax.jit``): ``run`` copies the arrays it is given
    into the key's buffers, replays its graph and returns the graph's
    outputs, which the next replay of that graph overwrites.  The arrays in
    host memory go through pinned staging in one asynchronous DMA
    (``_Staging``), so ``run`` returns without waiting for the card: it
    waits only when both of the key's pinned buffers are still on their
    way, and the caller may reuse its arrays at once.

    Capture: on a side stream the body runs once eagerly (libraries,
    constants and other first-use work) and once more under
    ``torch.cuda.set_sync_debug_mode("error")`` — a device→host sync there
    raises — then the tensors in ``restore`` get back their values from
    before the two, and the body is captured into the process's one graph
    pool (``_pool``: the process's captured graphs replay one at a time,
    so they share it).  A capture that fails raises, with ``restore``'s
    tensors given back their values: nothing falls back to eager work on
    the card.

    Every registered counter (``register_counters``: the kernel wrappers'
    launches, the collectives' calls and bytes) advances by what a replay
    launches: the capture itself launches nothing, so its advance is taken
    back and added at every replay; a source registered while the capture
    ran counts from zero.  ``warmups`` counts the eager runs
    (``WARMUP_RUNS`` a capture), ``replays`` the graph launches.

    Tracing (``utils/profiling.TRACER``): the warm-ups and the capture are
    always spans (``captured.warmup``, ``captured.capture``).  While the
    tracer is on, the copy of the arrays is a host and device span
    (``captured.copy``: on the host the staging and the enqueue, on the
    device the DMA; counters ``captured.copy_bytes``,
    ``captured.pageable_bytes``, the bytes the caller gave in memory that
    is not pinned, ``captured.staged_bytes``, the bytes that went through
    the pinned staging, and ``captured.staging_waits``, the waits for a
    pinned buffer, made before the span) and the replay one (``label``)
    that shares its call; a graph captured then holds the body's device
    spans (``TRACER.graph_span``), read after its replays.  Whether the
    tracer was on is part of the key: a graph with those spans is never
    replayed untraced, nor the reverse."""

    WARMUP_RUNS = 2
    _every: "weakref.WeakSet[CapturedGraphs]" = weakref.WeakSet()

    def __init__(self):
        self.graphs: Dict[tuple, _Captured] = {}
        self.warmups = 0
        self.replays = 0
        CapturedGraphs._every.add(self)

    def run(self, key: tuple, leaves: Sequence, body: Callable[[list], Any],
            device: torch.device, restore: Sequence[torch.Tensor] = (),
            keep: Any = None, label: str = "captured.replay") -> Any:
        """Replay the graph of ``key`` on ``leaves`` (numpy arrays or
        tensors), capturing ``body`` first if the key is new; ``keep`` is
        held as long as the graph (what it reads or writes)."""
        key = (key, TRACER.enabled)
        entry = self.graphs.get(key)
        if entry is None:
            entry = self.graphs[key] = self._capture(leaves, body, device, restore, keep)
            call = None
        else:
            waited = entry.staging.wait()
            with TRACER.span("captured.copy", device) as copy:
                staged = entry.staging.copy(leaves)
            call = copy.call
            if TRACER.enabled:
                TRACER.count("captured.staged_bytes", staged)
                TRACER.count("captured.staging_waits", int(waited))
                TRACER.count("captured.copy_bytes", sum(b.nbytes for b in entry.staging.inputs))
                TRACER.count("captured.pageable_bytes", sum(
                    b.nbytes for b, a in zip(entry.staging.inputs, leaves)
                    if not (torch.is_tensor(a) and (a.is_cuda or a.is_pinned()))))
        with TRACER.span(label, device, call=call, marks=entry.marks):
            entry.graph.replay()
        for src, deltas in zip(_SOURCES, entry.deltas):
            src.add(deltas)
        self.replays += 1
        if TRACER.enabled:
            TRACER.count("captured.traced_replays")
        return entry.outputs

    def _capture(self, leaves, body, device, restore, keep) -> _Captured:
        staging = _Staging(leaves, device)
        staging.copy(leaves)
        inputs = staging.inputs
        saved = [t.clone() for t in restore]
        current = torch.cuda.current_stream(device)
        side = torch.cuda.Stream(device)
        side.wait_stream(current)
        try:
            with torch.cuda.stream(side):
                with TRACER.once("captured.warmup"):
                    body(inputs)  # first use
                mode = torch.cuda.get_sync_debug_mode()
                torch.cuda.set_sync_debug_mode("error")
                try:
                    with TRACER.once("captured.warmup"):
                        body(inputs)  # as it will be captured
                finally:
                    torch.cuda.set_sync_debug_mode(mode)
        finally:  # a failed capture leaves no trace of its warm-ups either
            current.wait_stream(side)
            for t, v in zip(restore, saved):
                t.copy_(v)
        self.warmups += self.WARMUP_RUNS
        graph = torch.cuda.CUDAGraph()
        before = _read_sources()
        with (TRACER.once("captured.capture"), TRACER.marking() as marks,
              torch.cuda.graph(graph, pool=_pool(device))):
            outputs = body(inputs)
        after = _read_sources()
        deltas = [[after[n] - before.get(n, 0) for n in src.names] for src in _SOURCES]
        for src, d in zip(_SOURCES, deltas):  # the capture launched nothing
            src.add([-x for x in d])
        return _Captured(graph, staging, outputs, deltas, keep, marks)


TRACER.watch("captured_graphs", lambda: {
    "replays": sum(c.replays for c in CapturedGraphs._every),
    "warmups": sum(c.warmups for c in CapturedGraphs._every)})


def shape_key(leaves) -> tuple:
    """The shapes and dtypes of ``leaves``: part of a capture's key."""
    return tuple((tuple(a.shape), str(a.dtype)) for a in leaves)


class CapturedStep(CapturedGraphs):
    """``body(state, batch)`` on a CUDA device, captured as one CUDA graph
    per state and batch shape (and per binding of the state's tensors) and
    replayed (``CapturedGraphs``): the batch is copied into the graph's
    static input buffers, the graph replayed, and its metrics cloned
    before the next replay can overwrite them.  The warm-up runs write the
    state; it is restored before the capture.  The state is anything with
    ``tensors()`` (every tensor the step writes) and ``device``
    (``train/steps.TrainState``).  ``leaves(batch)`` gives a batch's arrays
    and ``rebuild(inputs)`` the batch of static buffers (default: a
    ``GraphBatch``'s fields, ``GraphBatch.leaves``/``from_leaves``)."""

    def __init__(self, body: Callable, leaves: Callable = None, rebuild: Callable = None):
        super().__init__()
        self.body = body
        self.leaves = leaves or GraphBatch.leaves
        self.rebuild = rebuild or GraphBatch.from_leaves

    def __call__(self, state, batch) -> Dict[str, torch.Tensor]:
        leaves = self.leaves(batch)
        binding = tuple(t.data_ptr() for t in state.tensors())
        outputs = self.run(
            (id(state), binding, shape_key(leaves)), leaves,
            lambda inputs: self.body(state, self.rebuild(inputs)), state.device,
            restore=state.tensors(), keep=state, label="train_step.replay")
        return {k: v.clone() for k, v in outputs.items()}
