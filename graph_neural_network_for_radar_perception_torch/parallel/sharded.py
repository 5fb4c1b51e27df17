"""Multi-process training steps: data parallelism and edge partitioning.

The JAX package's ``parallel/sharded.py`` over a grid of processes
(``parallel/mesh.py``), one device each:

* ``make_dp_train_step``: the batch axis cut over every rank, parameters
  replicated, the gradient all-reduced;
* ``make_edge_sharded_train_step``: the batch axis cut over 'data', every
  edge-indexed field also cut along E over 'graph'.  The message MLPs (the
  dominant work, E ≈ 20·N edges) divide across 'graph': each round runs its
  kernel (``fused_mp_forward``/``fused_mp_backward``, or the CSR pair) on
  the rank's edge shard, and one all-reduce per round combines the partial
  aggregates (``models/blocks.py``).

Gradient accounting.  JAX differentiates outside shard_map, where the edge
sums are psummed over ('data', 'graph') and the node and cluster sums over
'data' only.  Here each rank runs its own backward, so the step is:

1. the rank's per-graph ``LossSums``, those replicated across 'graph'
   (node and cluster sums: every member of a data row computes them alike)
   multiplied by 1 on graph member 0 and by 0 elsewhere;
2. their sum all-reduced over every rank, detached: the global sums give
   the metrics and the global counts;
3. graph by graph, the backward of ``reduce_loss_sums(local sums, global
   counts)``.  It is linear in the sums once the counts are fixed (they
   are masks' sizes), so the ranks' surrogates add up to the loss; each
   round's sum all-reduce hands every member the summed cotangent of its
   aggregate.  One graph at a time, every rank runs its rounds'
   collectives in one order;
4. every parameter gradient all-reduced over all ranks (one flat buffer),
   then ``train/steps.py``'s update: the NaN skip decides from the reduced
   gradients and the global loss, so every rank skips or steps together
   and the parameters stay equal bit for bit.
"""

from __future__ import annotations

from typing import Callable, Dict, Iterable, List, Tuple

import torch

from ..config.config import GNNConfig
from ..core.graph import GraphBatch
from ..train.loss import LossSums, reduce_loss_sums
from ..train.steps import (
    TrainState,
    _apply_update,
    batch_on,
    per_graph_loss_sums,
)
from . import collectives as P
from .mesh import BatchSharding, ProcessMesh

# LossSums fields computed on the rank's edge shard; the others are
# replicated across 'graph' (the JAX package's _EDGE_FIELDS).
_EDGE_FIELDS = ("edge_sum", "edge_cnt", "edge_correct")
_COUNT_FIELDS = ("edge_cnt", "node_cnt", "reg_cnt", "obj_cnt")


def make_grid_step(cfg: GNNConfig, mesh: ProcessMesh,
                   graph_sums: Callable[..., List[LossSums]],
                   replicated: Iterable[str]) -> Callable:
    """(state, *local args) → (state, metrics) over the grid.
    ``graph_sums(model, *local args)`` gives this rank's per-graph
    LossSums; the fields named in ``replicated`` count on graph member 0
    only.  Steps 1-4 of the module docstring.  ``step.loss(model, *local
    args)`` → (loss, metrics, per-graph surrogates) is steps 1-2: the
    global loss and metrics (detached, equal on every rank) and what step
    3 backprops."""
    keep = 1.0 if mesh.graph_index == 0 else 0.0
    replicated = frozenset(replicated)

    def loss_fn(model, *args):
        per_graph = [LossSums(**{k: v * keep if k in replicated else v
                                 for k, v in s._asdict().items()})
                     for s in graph_sums(model, *args)]
        total = P.all_reduce_(torch.stack([torch.stack(s) for s in per_graph]).sum(0).detach())
        total = LossSums(*total)
        loss, metrics = reduce_loss_sums(total, cfg)
        counts = {k: getattr(total, k) for k in _COUNT_FIELDS}
        surrogates = [reduce_loss_sums(s._replace(**counts), cfg)[0] for s in per_graph]
        return loss, metrics, surrogates

    def train_step(state: TrainState, *args) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
        model = state.model
        model.zero_grad(set_to_none=True)
        loss, metrics, surrogates = loss_fn(model, *args)
        for s in surrogates:
            s.backward()
        params = list(model.parameters())
        flat = torch.cat([(p.grad if p.grad is not None else torch.zeros_like(p)).reshape(-1)
                          for p in params])
        P.all_reduce_(flat)
        ok = bool(torch.cat([loss.reshape(1), flat]).isfinite().all())
        if ok:
            grads = [g.view_as(p) for g, p in
                     zip(flat.split([p.numel() for p in params]), params)]
            _apply_update(state, grads, cfg)
        model.zero_grad(set_to_none=True)
        state.step += 1
        metrics = {k: v.detach() for k, v in metrics.items()}
        metrics["skipped"] = loss.new_tensor(0.0 if ok else 1.0)
        return state, metrics

    train_step.loss = loss_fn
    return train_step


def _batch_step(cfg: GNNConfig, mesh: ProcessMesh, sharding: BatchSharding) -> Callable:
    group = mesh.graph_group if sharding.edges else None

    def graph_sums(model, batch: GraphBatch):
        return per_graph_loss_sums(model, batch_on(batch, mesh.device), cfg,
                                   graph_group=group)

    step = make_grid_step(cfg, mesh, graph_sums,
                          [f for f in LossSums._fields if f not in _EDGE_FIELDS] if sharding.edges else ())
    step.sharding = sharding
    step.place_batch = sharding.place  # train/trainer.py places every batch through it
    return step


def make_dp_train_step(cfg: GNNConfig, mesh: ProcessMesh) -> Callable:
    """Data-parallel train step: the batch axis over every rank of the grid
    (the JAX step's ``P(mesh.axis_names)``), parameters replicated.  The
    step takes this rank's rows (``step.place_batch(global batch)``, or
    ``step.sharding`` for ``device_prefetch``).  The message rounds are
    ``cfg.mp_impl``'s."""
    return _batch_step(cfg, mesh, BatchSharding(mesh, rows="all"))


def make_edge_sharded_train_step(cfg: GNNConfig, mesh: ProcessMesh) -> Callable:
    """Train step with edge partitioning over the 'graph' axis: the step
    takes this rank's rows of 'data' and its edge shard
    (``step.place_batch(global batch)``)."""
    return _batch_step(cfg, mesh, BatchSharding(mesh, rows="data", edges=True))
