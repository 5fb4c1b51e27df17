"""Multiprocess batch loader.

The JAX package's ``data/mp_loader.py``.  The threaded loader
(data/prefetch.py) is GIL-bound: only the native C++ graph builder releases
the GIL, so numpy label/padding work serialises.  This loader runs the full
preprocess→pad→stack pipeline in worker PROCESSES feeding a queue, in place
of torch DataLoader(num_workers=N), which the reference leaves at 0
(set_param_for_training_gnn.py:97-98).

Workers are forked (as in the JAX package) and yield numpy ``GraphBatch``es:
they never touch CUDA, which a forked child of a process that has
initialised it cannot use.  Batches go to the card through
``data/prefetch.device_prefetch`` in the parent.  Each worker records
whether CUDA was initialised in it (``workers_initialised_cuda``), so a run
can check that none was.
"""

from __future__ import annotations

import multiprocessing as mp
import queue as queue_mod
import time
from typing import Iterator, List, Optional

import torch

from ..config.config import GNNConfig
from ..core.graph import GraphBatch


_CLOSE_S = 10.0  # a worker's batch takes well under a second


def _worker_loop(cfg, batch_size, seed, source, data_root, q, stop,
                 cuda_flags, index):
    if source == "synthetic":
        from .pipeline import SyntheticRadarDataset

        ds = SyntheticRadarDataset(cfg, seed=seed)
        gen = ds.batches(batch_size)
    elif source == "radarscenes":
        from .radarscenes import (
            RadarScenesDataset, SequenceCache, build_metadata,
            train_val_test_split,
        )

        train_seqs, _, _ = train_val_test_split(data_root, cfg.dataset_dir)
        cache = SequenceCache(data_root, cfg.dataset_dir)
        md = build_metadata(cache, train_seqs, cfg.temporal_window_size)
        ds = RadarScenesDataset(
            cfg, data_root, md, augment=cfg.dataset_augmentation, seed=seed
        )
        gen = ds.batches(batch_size)
    else:
        raise ValueError(source)

    while not stop.is_set():
        batch = next(gen)
        cuda_flags[index] = int(torch.cuda.is_initialized())
        try:
            q.put(batch, timeout=1.0)
        except queue_mod.Full:
            continue


class MultiprocessBatches:
    """Iterator of numpy GraphBatch built by forked worker processes; worker
    i draws from seed + 1000·i.  Close it (or use it as a context manager)
    to stop the workers."""

    def __init__(
        self,
        cfg: GNNConfig,
        batch_size: int,
        *,
        num_workers: int = 4,
        queue_size: int = 8,
        seed: int = 0,
        source: str = "synthetic",
        data_root: Optional[str] = None,
    ):
        ctx = mp.get_context("fork")
        self._q = ctx.Queue(maxsize=queue_size)
        self._stop = ctx.Event()
        self._cuda_flags = ctx.Array("b", num_workers)
        self._procs = [
            ctx.Process(
                target=_worker_loop,
                args=(cfg, batch_size, seed + 1000 * i, source, data_root,
                      self._q, self._stop, self._cuda_flags, i),
                daemon=True,
            )
            for i in range(num_workers)
        ]
        for p in self._procs:
            p.start()

    def __iter__(self) -> Iterator[GraphBatch]:
        return self

    def __next__(self) -> GraphBatch:
        while True:
            try:
                return self._q.get(timeout=1.0)
            except queue_mod.Empty:
                if not any(p.is_alive() for p in self._procs):
                    raise RuntimeError(
                        "every loader worker exited (exit codes "
                        f"{[p.exitcode for p in self._procs]})") from None

    def workers_initialised_cuda(self) -> List[bool]:
        """Per worker: was CUDA initialised in it when it last queued a
        batch?"""
        return [bool(v) for v in self._cuda_flags]

    def close(self):
        """Stop the workers: each finishes its batch, and exits once what it
        queued has gone through the pipe, so the queue is read until every
        worker has exited (a worker that exited mid-message would leave a
        truncated message that blocks the reader).  Workers still alive
        after _CLOSE_S seconds are terminated, and the queue is not read
        after that."""
        self._stop.set()
        deadline = time.monotonic() + _CLOSE_S
        while any(p.is_alive() for p in self._procs) and time.monotonic() < deadline:
            try:
                self._q.get(timeout=0.05)
            except queue_mod.Empty:
                pass
        for p in self._procs:
            if p.is_alive():
                p.terminate()
            p.join(timeout=2.0)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
