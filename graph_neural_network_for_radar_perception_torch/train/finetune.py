"""Object-classifier finetuning over DBSCAN proposals.

The JAX package's ``train/finetune.py`` (reference:
Model_Object_Classifier_Finetuning, gnn_detector.py:481-519 +
gnn/finetuning.py:28-135 + set_param_for_finetuning_obj_classifier.py):
run the frozen detector in deployment mode (DBSCAN clustering inside the
forward, ``cfg.clustering_eps``), label each proposal by the majority vote
(bincount-argmax) of its member nodes' ground-truth classes, and train ONLY
the object-classification head with cross-entropy.

Freezing is ``requires_grad_(False)`` on everything outside
``predict_class``, which stands in for optax's ``set_to_zero``: no gradient
is computed for the trunk, so on the card this path runs the message
rounds' forward kernel and never their backward.  One standing difference
follows (ROADMAP.md C6): the JAX step's finiteness check covers the frozen
trunk's gradients too, so a batch whose trunk gradient alone overflows is
skipped there and not here.
"""

from __future__ import annotations

from typing import Callable, Dict, Tuple

import torch

from ..config.config import GNNConfig
from ..core.graph import GraphBatch
from ..models.gnn import RadarGNN
from ..ops import segment as S
from .loss import cross_entropy, one_hot
from .steps import TrainState, batch_on, finite_update

TRAINED = "predict_class"


def majority_vote_labels(node_class, node2cluster, node_mask,
                         num_clusters_cap: int, num_classes: int):
    """Per-cluster argmax-bincount of member GT labels
    (gnn_detector.py:511-513); ``argmax`` picks the lowest index on ties,
    as torch.argmax(torch.bincount(...)) does."""
    votes = S.masked_segment_sum(one_hot(node_class, num_classes), node2cluster,
                                 num_clusters_cap, node_mask)
    return votes.argmax(-1).int()


def make_finetune_optimizer(cfg: GNNConfig, model: RadarGNN) -> torch.optim.Optimizer:
    """SGD (momentum, coupled weight decay ``weight_decay_finetuning``) on
    the object head only; every other parameter is frozen in place
    (set_param_for_finetuning_obj_classifier.py + gnn_detector.py:127-133)."""
    for name, p in model.named_parameters():
        p.requires_grad_(name.split(".")[0] == TRAINED)
    return torch.optim.SGD(getattr(model, TRAINED).parameters(),
                           lr=cfg.learning_rate_finetuning, momentum=cfg.momentum,
                           dampening=0, nesterov=False,
                           weight_decay=cfg.weight_decay_finetuning)


def make_finetune_step(cfg: GNNConfig) -> Tuple[Callable, Callable]:
    """(build, loss_fn), as the JAX package's: ``build(model)`` freezes the
    model outside ``predict_class`` and returns ``(step, optimizer)``;
    ``step(state, batch)`` → (state, metrics) with ``skipped`` = 1.0 for a
    batch whose loss or head gradient is not finite (nothing changes then).
    ``loss_fn(model, batch)`` → (loss, metrics)."""

    def single_graph_sums(model: RadarGNN, graph, node_class):
        out = model.deploy(graph, eps=cfg.clustering_eps)
        n = graph.num_nodes
        gt = majority_vote_labels(node_class, out.node2cluster, graph.node_mask,
                                  n, cfg.num_classes)
        cmask = (torch.arange(n, device=gt.device) < out.num_clusters).float()
        ce = cross_entropy(out.obj_cls, one_hot(gt, cfg.num_classes))
        correct = (out.obj_cls.argmax(-1) == gt).float()
        return (ce * cmask).sum(), cmask.sum(), (correct * cmask).sum()

    def loss_fn(model: RadarGNN, batch: GraphBatch):
        sums = [single_graph_sums(model, batch.graph.at(b),
                                  batch.labels.at(b).node_class)
                for b in range(batch.batch_size)]
        total, cnt, corr = (torch.stack(v).sum() for v in zip(*sums))
        cnt = torch.clamp(cnt, min=1.0)
        loss = total / cnt
        return loss, {"loss_obj_cls": loss, "object_accuracy": corr / cnt}

    def build(model: RadarGNN):
        optimizer = make_finetune_optimizer(cfg, model)

        def step(state: TrainState, batch: GraphBatch
                 ) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
            state.optimizer.zero_grad(set_to_none=True)
            loss, metrics = loss_fn(state.model, batch_on(batch, state.device))
            loss.backward()
            ok = finite_update(state, loss, getattr(state.model, TRAINED).parameters())
            metrics = {k: v.detach() for k, v in metrics.items()}
            metrics["skipped"] = (~ok).to(torch.float32)
            return state, metrics

        return step, optimizer

    return build, loss_fn
