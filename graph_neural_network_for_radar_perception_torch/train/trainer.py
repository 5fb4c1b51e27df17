"""Iteration-based training loop.

The JAX package's ``train/trainer.py`` (reference
modules/neural_net/gnn/training.py:48-186): an iteration counter (not
epochs), periodic logging of the step's metrics, a periodic validation
sweep with paired train/val scalars, a checkpoint at every validation
period and at the end (``utils/checkpoint.py``: params, optimiser and
counters, so a restored run continues where it stopped), and the NaN skip
inside the step.  Metrics
are pulled to the host only at log boundaries (on the card the step itself
syncs nothing: a replay of its CUDA graph).  ``train_chunked`` runs
``make_train_scan`` over chunks of stacked batches; ``train_bucketed`` runs
``train`` over bucketed batches (``data/bucketing.py``) that
``data/prefetch.device_prefetch`` moves to the device ahead of the steps.
"""

from __future__ import annotations

import dataclasses
import itertools
import time
from typing import Any, Callable, Iterator, Optional

import torch

from ..config.config import GNNConfig
from ..core.graph import GraphBatch, resolve_device
from ..data.pipeline import stack_batch
from ..utils.checkpoint import CheckpointManager
from ..utils.metrics_writer import RunningMeans
from .steps import (
    TrainState,
    create_train_state,
    make_eval_step,
    make_train_scan,
    make_train_step,
)


@dataclasses.dataclass
class TrainHooks:
    log_period: int = 100
    val_period: int = 1000
    num_val_batches: int = 8
    checkpoint: Optional[CheckpointManager] = None
    writer: Optional[Any] = None      # has write_train_val(step, train, val)
    print_fn: Callable[[str], None] = print


def train(
    cfg: GNNConfig,
    train_batches: Iterator[GraphBatch],
    val_batches: Optional[Callable[[], Iterator[GraphBatch]]] = None,
    *,
    hooks: Optional[TrainHooks] = None,
    state: Optional[TrainState] = None,
    train_step=None,
    max_iters: Optional[int] = None,
    starting_iter: int = 0,
    device="cuda",
) -> TrainState:
    """Run the training loop; returns the final TrainState.

    Without ``state`` a fresh one is made on ``device`` (the card unless
    ``device="cpu"``; raises without a card) from a generator seeded with
    ``cfg.seed``.  ``train_step`` defaults to ``make_train_step(cfg)``;
    batches (numpy or tensors) are moved to the state's device.  A
    ``train_step`` with a ``place_batch`` attribute has every train and
    validation batch passed through it first.  With ``hooks.checkpoint``
    the state is saved at every validation period and once at the end."""
    hooks = hooks or TrainHooks()
    if state is None:
        state = create_train_state(
            cfg, torch.Generator().manual_seed(cfg.seed), device=device)
    if train_step is None:
        train_step = make_train_step(cfg)
    eval_step = make_eval_step(cfg)
    max_iters = max_iters if max_iters is not None else cfg.max_train_iter

    tracker = RunningMeans()
    t_start = time.perf_counter()

    place = getattr(train_step, "place_batch", lambda b: b)

    for it in range(starting_iter, max_iters):
        state, metrics = train_step(state, place(next(train_batches)))

        if (it + 1) % hooks.log_period == 0:
            host_metrics = {k: float(v) for k, v in metrics.items()}
            tracker.update(host_metrics)
            elapsed = time.perf_counter() - t_start
            ips = hooks.log_period / max(elapsed, 1e-9)
            hooks.print_fn(
                f"iter {it + 1}: loss {host_metrics['loss_total']:.4f} "
                f"(node {host_metrics['loss_node_cls']:.3f} "
                f"edge {host_metrics['loss_edge_cls']:.3f} "
                f"reg {host_metrics['loss_node_reg']:.3f} "
                f"obj {host_metrics['loss_obj_cls']:.3f}) "
                f"{ips:.1f} it/s"
            )
            t_start = time.perf_counter()

        if (it + 1) % hooks.val_period == 0:
            val_means = None
            if val_batches is not None:
                vm = RunningMeans()
                for vb in itertools.islice(val_batches(), hooks.num_val_batches):
                    m = eval_step(state.model, place(vb))
                    vm.update({k: float(v) for k, v in m.items()})
                val_means = vm.means()
            if hooks.writer is not None:
                hooks.writer.write_train_val(it + 1, tracker.means(), val_means)
            tracker.reset()
            if hooks.checkpoint is not None:
                hooks.checkpoint.save(it + 1, state)

    # Always leave a final checkpoint so short runs (< val_period) and
    # resumes are never silently lost.
    if hooks.checkpoint is not None and max_iters > starting_iter:
        hooks.checkpoint.save(max_iters, state, wait=True)

    return state


def train_chunked(
    cfg: GNNConfig,
    train_batches: Iterator[GraphBatch],
    *,
    chunk: int = 32,
    hooks: Optional[TrainHooks] = None,
    state: Optional[TrainState] = None,
    max_iters: Optional[int] = None,
    starting_iter: int = 0,
    device="cuda",
) -> TrainState:
    """Training loop that runs ``chunk`` steps per ``make_train_scan`` call.

    Stacks ``chunk`` host (numpy) batches along a new leading axis and runs
    them through one ``make_train_scan`` (train/steps.py), the same as
    ``chunk`` sequential steps; metrics are read back once per chunk, and
    the chunk's last step's are reported and written.  A shorter tail gets
    a scan of its own length.  As in the JAX loop, the running means that
    the writer gets are never reset: each write averages every chunk so
    far (ROADMAP.md C6).  State, device and the final checkpoint as in
    ``train``."""
    hooks = hooks or TrainHooks()
    if state is None:
        state = create_train_state(
            cfg, torch.Generator().manual_seed(cfg.seed), device=device)
    max_iters = max_iters if max_iters is not None else cfg.max_train_iter
    run = make_train_scan(cfg, chunk)
    tracker = RunningMeans()
    t_start = time.perf_counter()
    it = starting_iter
    while it < max_iters:
        n = min(chunk, max_iters - it)
        host = [next(train_batches) for _ in range(n)]
        stacked = stack_batch([(b.graph, b.labels) for b in host])
        state, metrics = (run if n == chunk else make_train_scan(cfg, n))(state, stacked)
        it += n
        host_metrics = {k: float(v) for k, v in metrics.items()}
        tracker.update(host_metrics)
        if hooks.writer is not None:
            hooks.writer.write_train_val(it, tracker.means(), None)
        elapsed = time.perf_counter() - t_start
        hooks.print_fn(
            f"iter {it}: loss {host_metrics['loss_total']:.4f} "
            f"{n / max(elapsed, 1e-9):.1f} it/s (chunk={n})"
        )
        t_start = time.perf_counter()
    if hooks.checkpoint is not None and max_iters > starting_iter:
        hooks.checkpoint.save(max_iters, state, wait=True)
    return state


def train_bucketed(
    cfg: GNNConfig,
    frames,
    *,
    buckets=None,
    val_batches=None,
    **train_kwargs,
) -> TrainState:
    """The training loop over BUCKETED static-shape batches.

    Frames are routed to the smallest capacity bucket that fits
    (data/bucketing.py), so padded work tracks the real frame-size
    distribution instead of the global maximum; one train step per bucket
    shares the single TrainState.  `frames` is an iterator of FrameArrays
    (e.g. SyntheticRadarDataset.sample_frame in a loop); the batches reach
    the device through ``device_prefetch`` (two ahead of the step, on the
    card through pinned memory and a copy stream), on the device of
    ``train_kwargs["state"]`` if given, else of ``device`` (the card by
    default).  Remaining kwargs forward to :func:`train`.  The JAX
    signature's ``donate`` has no meaning in PyTorch and is not taken."""
    from ..data.bucketing import (
        bucketed_batches, default_buckets, make_bucketed_train_step,
    )
    from ..data.prefetch import device_prefetch

    buckets = list(buckets or default_buckets(cfg))
    bstep = make_bucketed_train_step(cfg, buckets)

    def step(state, item):
        bucket, batch = item
        return bstep(state, bucket, batch)

    state = train_kwargs.get("state")
    device = (state.device if state is not None
              else resolve_device(train_kwargs.get("device", "cuda")))
    stream = device_prefetch(bucketed_batches(frames, cfg, buckets), device=device)
    return train(
        cfg, stream, val_batches, train_step=step, **train_kwargs
    )
