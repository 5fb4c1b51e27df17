"""Iteration-based training loop.

The JAX package's ``train/trainer.py::train`` (reference
modules/neural_net/gnn/training.py:48-186): an iteration counter (not
epochs), periodic logging of the step's metrics, a periodic validation
sweep with paired train/val scalars, and the NaN skip inside the step.
Metrics are pulled to the host only at log boundaries.  Checkpointing
(``utils/checkpoint.py``), ``train_chunked`` and ``train_bucketed`` are not
ported yet (ROADMAP.md A6).
"""

from __future__ import annotations

import dataclasses
import itertools
import time
from typing import Any, Callable, Iterator, Optional

import torch

from ..config.config import GNNConfig
from ..core.graph import GraphBatch
from ..utils.metrics_writer import RunningMeans
from .steps import TrainState, create_train_state, make_eval_step, make_train_step


@dataclasses.dataclass
class TrainHooks:
    log_period: int = 100
    val_period: int = 1000
    num_val_batches: int = 8
    checkpoint: Optional[Any] = None  # not ported yet: train() raises
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
    batches (numpy or tensors) are moved to the state's device."""
    hooks = hooks or TrainHooks()
    if hooks.checkpoint is not None:
        raise NotImplementedError(
            "checkpointing is not ported yet (ROADMAP.md A6: utils/checkpoint.py)"
        )
    if state is None:
        state = create_train_state(
            cfg, torch.Generator().manual_seed(cfg.seed), device=device)
    if train_step is None:
        train_step = make_train_step(cfg)
    eval_step = make_eval_step(cfg)
    max_iters = max_iters if max_iters is not None else cfg.max_train_iter

    tracker = RunningMeans()
    t_start = time.perf_counter()

    for it in range(starting_iter, max_iters):
        state, metrics = train_step(state, next(train_batches))

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
                    m = eval_step(state.model, vb)
                    vm.update({k: float(v) for k, v in m.items()})
                val_means = vm.means()
            if hooks.writer is not None:
                hooks.writer.write_train_val(it + 1, tracker.means(), val_means)
            tracker.reset()

    return state
