"""Object-classifier finetuning over DBSCAN proposals.

The JAX package's ``train/finetune.py`` (reference:
Model_Object_Classifier_Finetuning, gnn_detector.py:481-519 +
gnn/finetuning.py:28-135 + set_param_for_finetuning_obj_classifier.py):
run the frozen detector in deployment mode (DBSCAN clustering inside the
forward, ``cfg.clustering_eps``), label each proposal by the majority vote
(bincount-argmax) of its member nodes' ground-truth classes, and train ONLY
the object-classification head with cross-entropy.

The step is the JAX package's compiled one: ONE deploy call for the batch
(``steps.batched_deploy``, the JAX step's ``jax.vmap``; each message round
one kernel launch for the B graphs), the majority vote and the
cross-entropy with the graph axis, the per-graph sums added in graph
order; optax's chain(add_decayed_weights(wd_ft), sgd(lr_ft, momentum)) on
the object head's flat parameters (``steps.Optimizer``) and the
branchless NaN skip (``steps.apply_update``).  On a CUDA device the
step is captured as one CUDA graph per state and batch shape and replayed
(``core/capture.CapturedStep``); on the CPU it runs eagerly.

Freezing lives in the optimiser, as optax's ``multi_transform`` with
``set_to_zero`` does: every parameter keeps ``requires_grad``, the step
takes the gradient of the loss with respect to all of them, skips the
batch unless the loss and every gradient, the frozen trunk's included,
are finite (JAX ``train/finetune.py:105``), and updates ``predict_class``
alone.  So on the card the step runs the message rounds' forward kernel
and, for the trunk's gradient, their backward kernel once a round for the
batch.  The deploy forward detaches the DBSCAN centres and the predicted
links, so the node and link heads get a zero gradient, as in JAX.
"""

from __future__ import annotations

from typing import Callable, Dict, Tuple

import torch

from ..config.config import GNNConfig
from ..core.capture import CapturedStep
from ..core.graph import GraphBatch
from ..models.gnn import RadarGNN
from ..ops import segment as S
from .loss import cross_entropy, one_hot
from .steps import (
    Optimizer,
    TrainState,
    apply_update,
    batch_on,
    batched_deploy,
    step_metrics,
)

TRAINED = "predict_class"


def majority_vote_labels(node_class, node2cluster, node_mask,
                         num_clusters_cap: int, num_classes: int):
    """Per-cluster argmax-bincount of member GT labels
    (gnn_detector.py:511-513); ``argmax`` picks the lowest index on ties,
    as torch.argmax(torch.bincount(...)) does.  One graph, or a batch with
    a leading graph axis."""
    votes = S.masked_segment_sum(one_hot(node_class, num_classes), node2cluster,
                                 num_clusters_cap, node_mask)
    return votes.argmax(-1).int()


def make_finetune_optimizer(cfg: GNNConfig, model: RadarGNN) -> Optimizer:
    """SGD (momentum, coupled weight decay ``weight_decay_finetuning``:
    optax's chain(add_decayed_weights, sgd)) on the object head only, its
    parameters views of one flat buffer; every other parameter is frozen
    by not being the optimiser's (set_param_for_finetuning_obj_classifier.py
    + gnn_detector.py:127-133) and keeps ``requires_grad``, so that the
    step can check its gradient."""
    for p in model.parameters():
        p.requires_grad_(True)
    return Optimizer(getattr(model, TRAINED).parameters(), "sgd",
                     cfg.learning_rate_finetuning, cfg.weight_decay_finetuning,
                     momentum=cfg.momentum)


def make_finetune_step(cfg: GNNConfig) -> Tuple[Callable, Callable]:
    """(build, loss_fn), as the JAX package's: ``build(model)`` returns
    ``(step, optimizer)``, the optimiser over ``predict_class`` alone;
    ``step(state, batch)`` → (state, metrics) with ``skipped`` = 1.0 for a
    batch whose loss or any gradient (the frozen trunk's included) is not
    finite (nothing changes then; the step is counted).  ``loss_fn(model,
    batch)`` → (loss, metrics).  On the card ``step.captured`` is the
    step's ``CapturedStep``."""

    def loss_fn(model: RadarGNN, batch: GraphBatch):
        graph = batch.graph
        out = batched_deploy(model, cfg)(graph)
        n = graph.num_nodes
        gt = majority_vote_labels(batch.labels.node_class, out.node2cluster,
                                  graph.node_mask, n, cfg.num_classes)
        cmask = (torch.arange(n, device=gt.device) < out.num_clusters[:, None]).float()
        ce = cross_entropy(out.obj_cls, one_hot(gt, cfg.num_classes))
        correct = (out.obj_cls.argmax(-1) == gt).float()
        # per-graph sums, then added over the graphs in graph order
        total, cnt, corr = ((v * cmask).sum(-1).sum(0) for v in (ce, torch.ones_like(ce), correct))
        cnt = torch.clamp(cnt, min=1.0)
        loss = total / cnt
        return loss, {"loss_obj_cls": loss, "object_accuracy": corr / cnt}

    def body(state: TrainState, batch: GraphBatch) -> Dict[str, torch.Tensor]:
        params = state.optimizer.params
        head = {id(p) for p in params}
        frozen = [p for p in state.model.parameters() if id(p) not in head]
        loss, metrics = loss_fn(state.model, batch)
        grads = torch.autograd.grad(loss, [*params, *frozen], allow_unused=True)
        ok = apply_update(state, loss, grads[:len(params)], frozen=grads[len(params):])
        return step_metrics(metrics, ok)

    def build(model: RadarGNN):
        optimizer = make_finetune_optimizer(cfg, model)
        captured = CapturedStep(body)

        def step(state: TrainState, batch: GraphBatch
                 ) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
            if state.device.type == "cpu":
                return state, body(state, batch_on(batch, state.device))
            return state, captured(state, batch)

        step.captured = captured
        return step, optimizer

    return build, loss_fn
