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

1. ONE model call for the rank's graphs (``train/steps.batched_forward``
   with the graph axis, JAX's ``jax.vmap`` inside shard_map): each round
   one launch of its kernels for the rank's B graphs and, on an edge
   shard, one psum of the [B, N, 64] partial aggregate (for "mean" one
   more of the counts); then the rank's ``LossSums`` with the graph axis,
   summed over its graphs in graph order, those replicated across 'graph'
   (node and cluster sums: every member of a data row computes them alike)
   multiplied by 1 on graph member 0 and by 0 elsewhere;
2. their sum all-reduced over every rank, detached: the global sums give
   the metrics and the global counts;
3. ONE backward of ``reduce_loss_sums(local sums, global counts)``.  It is
   linear in the sums once the counts are fixed (they are masks' sizes),
   so the ranks' surrogates add up to the loss; each round's psum backward
   hands every member the summed cotangent of its aggregate.  Every rank
   runs the same graph of operations, so autograd runs the rounds'
   collectives in one order on every rank;
4. every parameter gradient all-reduced over all ranks (one flat buffer),
   then ``train/steps.py``'s update with its branchless NaN skip
   (``all_finite``/``apply_if``) on the reduced gradient and the global
   loss: every rank skips or steps together and the parameters stay equal
   bit for bit.

On a CUDA device where the world group and every group of the grid are
NCCL, steps 1-4 are one CUDA graph (``train/steps.CapturedStep``, as the
JAX package's step is one compiled program): captured once per state, per
binding of the state's tensors and per shape of the rank's arguments, then
replayed, one host launch a step.  NCCL's collectives join the capture
(its communicators exist after the two eager warm-ups); a replay adds to
``collectives.STATS`` the calls and bytes its capture recorded.  A capture
that fails raises with the state restored; nothing runs the step eagerly
in its place.  On the CPU, and under gloo with CUDA tensors (several ranks
on one card), the step runs eagerly: gloo stages CUDA tensors through the
host, which a CUDA graph cannot hold.
"""

from __future__ import annotations

from typing import Callable, Dict, Iterable, Optional, Tuple

import torch
import torch.distributed as dist

from ..config.config import GNNConfig
from ..core.graph import GraphBatch
from ..train.loss import LossSums, graph_loss_sums, reduce_loss_sums, tree_sum
from ..train.steps import (
    CapturedStep,
    TrainState,
    _apply_update,
    _batch_leaves,
    _static_batch,
    all_finite,
    batch_on,
    batched_forward,
)
from . import collectives as P
from .mesh import BatchSharding, ProcessMesh

# LossSums fields computed on the rank's edge shard; the others are
# replicated across 'graph' (the JAX package's _EDGE_FIELDS).
_EDGE_FIELDS = ("edge_sum", "edge_cnt", "edge_correct")
_COUNT_FIELDS = ("edge_cnt", "node_cnt", "reg_cnt", "obj_cnt")


def captures(mesh: ProcessMesh) -> bool:
    """Does the grid step run as a captured CUDA graph on this rank: a
    CUDA device, and NCCL under the world group and every group of the
    grid."""
    groups = [None] + [g for g in (mesh.graph_group, mesh.data_group) if g is not None]
    return mesh.device.type == "cuda" and all(dist.get_backend(g) == "nccl" for g in groups)


def make_grid_step(cfg: GNNConfig, mesh: ProcessMesh,
                   graph_sums: Callable[..., LossSums],
                   replicated: Iterable[str],
                   leaves: Optional[Callable] = None,
                   rebuild: Optional[Callable] = None) -> Callable:
    """(state, *local args) → (state, metrics) over the grid.
    ``graph_sums(model, *local args)`` gives this rank's LossSums with a
    leading graph axis, from one model call for its graphs; the fields
    named in ``replicated`` count on graph member 0 only.  Steps 1-4 of
    the module docstring.  ``step.loss(model, *local args)`` → (loss,
    metrics, surrogate) is steps 1-2: the global loss and metrics
    (detached, equal on every rank) and what step 3 backprops.

    Where ``captures(mesh)``, the step is ``step.captured`` (a
    ``CapturedStep``; ``step.captured.body(state, args)`` the eager body):
    ``leaves(args)`` gives the arrays of the local args, ``rebuild(inputs)``
    the args over the graph's static buffers (default: one ``GraphBatch``)."""
    keep = 1.0 if mesh.graph_index == 0 else 0.0
    replicated = frozenset(replicated)

    def loss_fn(model, *args):
        local = LossSums(**{k: v * keep if k in replicated else v
                            for k, v in tree_sum(graph_sums(model, *args))._asdict().items()})
        total = LossSums(*P.all_reduce_(torch.stack(list(local)).detach()))
        loss, metrics = reduce_loss_sums(total, cfg)
        counts = {k: getattr(total, k) for k in _COUNT_FIELDS}
        surrogate = reduce_loss_sums(local._replace(**counts), cfg)[0]
        return loss, metrics, surrogate

    def body(state: TrainState, args: tuple) -> Dict[str, torch.Tensor]:
        params = state.optimizer.params
        loss, metrics, surrogate = loss_fn(state.model, *args)
        grads = torch.autograd.grad(surrogate, params, allow_unused=True)
        with torch.no_grad():
            flat = torch.cat([(g if g is not None else torch.zeros_like(p)).reshape(-1)
                              for g, p in zip(grads, params)])
            P.all_reduce_(flat)
            ok = all_finite([loss, flat])
            _apply_update(state, flat, cfg, ok)
            state.counters[0].add_(1)
        metrics = {k: v.detach() for k, v in metrics.items()}
        metrics["skipped"] = (~ok).to(torch.float32)
        return metrics

    captured = CapturedStep(body, leaves or (lambda args: _batch_leaves(args[0])),
                            rebuild or (lambda inputs: (_static_batch(inputs),)))
    capture = captures(mesh)

    def train_step(state: TrainState, *args) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
        return state, (captured(state, args) if capture else body(state, args))

    train_step.loss = loss_fn
    train_step.captured = captured
    return train_step


def _batch_step(cfg: GNNConfig, mesh: ProcessMesh, sharding: BatchSharding) -> Callable:
    group = mesh.graph_group if sharding.edges else None

    def graph_sums(model, batch: GraphBatch):
        batch = batch_on(batch, mesh.device)
        labels = batch.labels
        out = batched_forward(model, cfg, graph_group=group)(
            batch.graph, labels.node2cluster, labels.cluster_mask)
        return graph_loss_sums(out, batch.graph, labels, cfg)

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
