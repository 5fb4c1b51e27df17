"""Multi-task loss with exact reference semantics under masking.

The JAX package's ``train/loss.py`` (reference modules/neural_net/gnn/
loss.py:10-76 + lossfunc.py:19-55):

* edge: sigmoid focal loss (α=0.25, γ=2) on 2-logit one-hot targets,
  summed over the logit axis, then mean over ALL undirected edges in the
  concatenated batch;
* node class: weighted CE with class weights [1,1,1,1,1,1,0.5]; the mean
  divides by the element COUNT, not the weight sum (reduction='none' then
  .sum()/shape[0]);
* offsets: 0.5 · Σ_dim (pred − gt)², mean over nodes; GT offsets are
  z-scored with μ=(0,0), σ=(8,4) before the loss (gnn_detector.py:464-466);
* object: plain CE, mean over clusters;
* weighted total with node/edge/reg/obj = 1/2/5/1 (yml:67-71).

The reference concatenates every graph of the batch before taking means
(gnn_detector.py:454-467), so each loss here is a per-graph (sum, count)
pair; the train step adds the pairs over the batch before dividing.  The
model's outputs of a batch (a leading graph axis, as the JAX package's
vmap gives them) give one (sum, count) pair a graph: LossSums with a [B]
axis, which ``tree_sum`` adds in graph order.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Tuple

import torch

from ..config.config import GNNConfig
from ..core.graph import GraphLabels, RadarGraph, device_constant
from ..models.gnn import GNNOutputs

FOCAL_ALPHA = 0.25
FOCAL_GAMMA = 2.0


class LossSums(NamedTuple):
    """Per-graph weighted loss sums and element counts for each task, plus
    accuracy numerators.  All 0-d tensors ([B] for a batch's graphs);
    additive across graphs."""

    edge_sum: torch.Tensor
    edge_cnt: torch.Tensor
    node_sum: torch.Tensor
    node_cnt: torch.Tensor
    reg_sum: torch.Tensor
    reg_cnt: torch.Tensor
    obj_sum: torch.Tensor
    obj_cnt: torch.Tensor
    node_correct: torch.Tensor
    edge_correct: torch.Tensor
    obj_correct: torch.Tensor


def one_hot(labels: torch.Tensor, num_classes: int) -> torch.Tensor:
    """f32 one-hot; an id outside [0, num_classes) gives a zero row (as
    ``jax.nn.one_hot``)."""
    classes = torch.arange(num_classes, device=labels.device)
    return (labels[..., None].long() == classes).float()


def sigmoid_focal_loss(logits, targets, alpha=FOCAL_ALPHA, gamma=FOCAL_GAMMA):
    """torchvision.ops.sigmoid_focal_loss with reduction='none'
    (lossfunc.py:47-55)."""
    p = torch.sigmoid(logits)
    ce = (torch.clamp(logits, min=0) - logits * targets
          + torch.log1p(torch.exp(-logits.abs())))
    p_t = p * targets + (1 - p) * (1 - targets)
    loss = ce * (1 - p_t) ** gamma
    if alpha >= 0:
        alpha_t = alpha * targets + (1 - alpha) * (1 - targets)
        loss = alpha_t * loss
    return loss


def cross_entropy(logits, labels_onehot, class_weights=None):
    """F.cross_entropy(reduction='none') on integer targets given one-hot:
    w[target] · (−log_softmax)[target] (lossfunc.py:19-26)."""
    nll = -(labels_onehot * torch.log_softmax(logits, dim=-1)).sum(-1)
    if class_weights is not None:
        nll = nll * (labels_onehot * class_weights[None, :]).sum(-1)
    return nll


def normalize_offsets(offsets: torch.Tensor, cfg: GNNConfig) -> torch.Tensor:
    """compute_offsets.py:6-11."""
    mu = device_constant(tuple(cfg.reg_mu), offsets.dtype, offsets.device)
    sigma = device_constant(tuple(cfg.reg_sigma), offsets.dtype, offsets.device)
    return (offsets - mu) / sigma


def graph_loss_sums(out: GNNOutputs, graph: RadarGraph, labels: GraphLabels,
                    cfg: GNNConfig) -> LossSums:
    """Masked loss sums/counts for ONE graph, or for each graph of a batch
    (outputs, graph and labels with a leading graph axis; the JAX package
    vmaps the one-graph function): every sum runs over a graph's last
    axis."""
    nmask = graph.node_mask.float()
    umask = graph.und_mask.float()
    cmask = labels.cluster_mask.float()
    cw = device_constant(tuple(cfg.class_weights_dyn), torch.float32, nmask.device)

    # edge focal loss (loss.py:57-58)
    edge_1h = one_hot(labels.edge_class, cfg.num_edge_classes)
    e_loss = sigmoid_focal_loss(out.edge_cls, edge_1h).sum(-1)
    # node weighted CE (loss.py:61-62)
    n_loss = cross_entropy(out.node_cls, one_hot(labels.node_class,
                                                 cfg.num_classes), cw)
    # offset regression (loss.py:65-66)
    gt_off = normalize_offsets(labels.node_offsets, cfg)
    r_loss = 0.5 * ((out.node_offsets - gt_off) ** 2).sum(-1)
    # object CE (loss.py:69-70)
    o_loss = cross_entropy(out.obj_cls, one_hot(labels.cluster_class,
                                                cfg.num_classes))
    node_cnt = nmask.sum(-1)

    def correct(logits, target, mask):  # gnn_detector.py:23-28,473-476
        return ((logits.argmax(-1) == target.long()).float() * mask).sum(-1)

    return LossSums(
        edge_sum=(e_loss * umask).sum(-1), edge_cnt=umask.sum(-1),
        node_sum=(n_loss * nmask).sum(-1), node_cnt=node_cnt,
        reg_sum=(r_loss * nmask).sum(-1), reg_cnt=node_cnt,
        obj_sum=(o_loss * cmask).sum(-1), obj_cnt=cmask.sum(-1),
        node_correct=correct(out.node_cls, labels.node_class, nmask),
        edge_correct=correct(out.edge_cls, labels.edge_class, umask),
        obj_correct=correct(out.obj_cls, labels.cluster_class, cmask),
    )


def reduce_loss_sums(sums: LossSums, cfg: GNNConfig
                     ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Batch-summed LossSums → (total weighted loss, metrics dict).

    Division by true element counts happens here, after the per-graph sums
    have been combined (loss.py:58,62,66,70 semantics)."""
    def safe(x, c):
        return x / torch.clamp(c, min=1.0)

    loss_edge = safe(sums.edge_sum, sums.edge_cnt) * cfg.edge_cls_loss_weight
    loss_node = safe(sums.node_sum, sums.node_cnt) * cfg.node_cls_loss_weight
    loss_reg = safe(sums.reg_sum, sums.reg_cnt) * cfg.node_reg_loss_weight
    loss_obj = safe(sums.obj_sum, sums.obj_cnt) * cfg.obj_cls_loss_weight
    total = loss_edge + loss_node + loss_reg + loss_obj
    metrics = {
        "loss_edge_cls": loss_edge,
        "loss_node_cls": loss_node,
        "loss_node_reg": loss_reg,
        "loss_obj_cls": loss_obj,
        "loss_total": total,
        "segment_accuracy": safe(sums.node_correct, sums.node_cnt),
        "edge_accuracy": safe(sums.edge_correct, sums.edge_cnt),
        "object_accuracy": safe(sums.obj_correct, sums.obj_cnt),
    }
    return total, metrics


def tree_sum(sums) -> LossSums:
    """Sum per-graph LossSums over the graphs, in graph order: one LossSums
    whose fields carry a leading graph axis (the batched model's, as the
    JAX package's ``tree_sum`` takes the vmapped one), or a sequence of
    one graph's each."""
    if not isinstance(sums, LossSums):
        sums = LossSums(*(torch.stack(xs) for xs in zip(*sums)))
    return LossSums(*(x.sum(0) for x in sums))
