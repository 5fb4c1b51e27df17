"""Background-thread batch building and host→card prefetch.

The JAX package's ``data/prefetch.py``.  The reference builds every sample
synchronously inside __getitem__ with num_workers=0 and transfers tensors
mid-preprocessing (datagen_gnn.py:120-124, set_param_for_training_gnn.py:
97-98), so the card starves while numpy runs.  Here a thread pool builds
padded batches ahead of the training loop (``threaded_batches``), and
``device_prefetch`` keeps ``buffer_size`` batches already on the card: each
batch's host arrays are copied into pinned memory and sent with
non-blocking copies on a copy stream of its own, so the next step's inputs
travel while the current step runs.  ``sharding=`` (the JAX package's
placement on a mesh) cuts each batch to this rank's share on the host
first, so only that share is copied.
"""

from __future__ import annotations

import collections
import dataclasses
import queue
import threading
from typing import Callable, Iterator, Optional

import numpy as np
import torch

from ..core.graph import resolve_device


class _Stop:
    pass


def threaded_batches(
    make_iterator: Callable[[], Iterator],
    *,
    num_workers: int = 2,
    queue_size: int = 4,
) -> Iterator:
    """Run `num_workers` independent batch iterators in threads, merging
    their outputs into one queue.  Each worker calls make_iterator() once
    (pass worker-seeded factories for determinism control)."""
    q: "queue.Queue" = queue.Queue(maxsize=queue_size)
    stop = threading.Event()

    def worker(idx: int):
        it = make_iterator()
        try:
            for item in it:
                if stop.is_set():
                    return
                q.put(item)
        finally:
            q.put(_Stop())

    threads = [
        threading.Thread(target=worker, args=(i,), daemon=True)
        for i in range(num_workers)
    ]
    for t in threads:
        t.start()

    finished = 0
    try:
        while finished < num_workers:
            item = q.get()
            if isinstance(item, _Stop):
                finished += 1
                continue
            yield item
    finally:
        stop.set()


def _tree_map(fn, obj):
    """``fn`` over every numpy array and tensor in nested tuples, lists,
    dicts and dataclasses (``GraphBatch``, a ``(Bucket, batch)`` pair);
    other leaves stay as they are."""
    if isinstance(obj, (np.ndarray, torch.Tensor)):
        return fn(obj)
    if isinstance(obj, (tuple, list)):
        return type(obj)(_tree_map(fn, x) for x in obj)
    if isinstance(obj, dict):
        return {k: _tree_map(fn, v) for k, v in obj.items()}
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return type(obj)(**{f.name: _tree_map(fn, getattr(obj, f.name))
                            for f in dataclasses.fields(obj)})
    return obj


def _tensors(obj) -> list:
    out = []
    _tree_map(out.append, obj)
    return out


def _as_tensor(x) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(x)) if isinstance(x, np.ndarray) else x


def device_prefetch(
    batches: Iterator,
    *,
    buffer_size: int = 2,
    device="cuda",
    sharding: Optional[Callable] = None,
) -> Iterator:
    """Keep `buffer_size` batches already on ``device`` ahead of the
    consumer, in order; every numpy array of a batch (in tuples, dicts and
    dataclasses) becomes a tensor there.

    On the card (the default; raises without one): each array is copied
    into a pinned tensor, and the host→card copies are issued
    ``non_blocking`` on a copy stream, then an event is recorded on it.
    When a batch is handed out, the consumer's current stream waits on that
    event, so no kernel of the consumer reads a batch before its copies
    retire, and ``record_stream`` marks its tensors as used there, so the
    allocator does not reuse their memory while the consumer's work is in
    flight.  The pinned tensors are held until the batch is handed out
    (PyTorch's pinned allocator also keeps a block from reuse until the
    copy from it has retired).  On the CPU (``device="cpu"``) arrays become
    tensors without copies, pinning or streams.

    ``sharding``: a callable that cuts a batch to this rank's share on the
    host before the copy, such as a grid step's ``step.sharding``
    (``parallel/mesh.BatchSharding``: this rank's rows of the data axis and,
    edge-sharded, its edge slice); pass the rank's device as ``device``."""
    device = resolve_device(device)
    on_card = device.type == "cuda"
    copy_stream = torch.cuda.Stream(device) if on_card else None

    def put(batch):
        if sharding is not None:
            batch = sharding(batch)
        if not on_card:
            return _tree_map(_as_tensor, batch), None, None
        with torch.cuda.stream(copy_stream):
            pinned = _tree_map(lambda x: _as_tensor(x).pin_memory(), batch)
            moved = _tree_map(lambda t: t.to(device, non_blocking=True), pinned)
            ready = torch.cuda.Event()
            ready.record(copy_stream)
        return moved, ready, pinned

    def hand_out(entry):
        moved, ready, _ = entry
        if ready is not None:
            consumer = torch.cuda.current_stream(device)
            consumer.wait_event(ready)
            for t in _tensors(moved):
                t.record_stream(consumer)
        return moved

    buf = collections.deque()
    it = iter(batches)
    try:
        for _ in range(buffer_size):
            buf.append(put(next(it)))
    except StopIteration:
        pass
    while buf:
        out = buf.popleft()
        try:
            buf.append(put(next(it)))
        except StopIteration:
            pass
        yield hand_out(out)
