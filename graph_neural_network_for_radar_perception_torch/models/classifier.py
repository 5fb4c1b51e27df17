"""Stage-2 standalone object classifier.

The JAX package's ``models/classifier.py`` (the reference's second-stage
GNN, modules/neural_net/classifier/*, datagen_classifier.py, trained by
script_train_model_classifier.ipynb): DBSCAN proposals from the frozen
stage-1 detector become independent point clusters; each cluster's points
are translated to the cluster mean and rotated into its covariance
eigenbasis, featurised as [x', y', r, θ, rcs] (datagen_classifier.py:75-94),
connected all-to-all within the cluster (:102-112), run through a norm-free
residual message-passing stack (messages MLP([x_i ‖ x_j]), no edge
features; classifier/blocks.py:28-80), max-pooled per cluster BEFORE the
head stem (classifier/blocks.py:170-176), and classified with focal loss
(α=−1, γ=2; classifier/loss.py:5-15).

The sample builder is host numpy, as in the JAX package (``np.linalg.eigh``
on both sides, so the features are equal there).  The model reaches no
Pallas kernel in the JAX package and is plain PyTorch here.  It takes one
sample, or a batch of them with a leading sample axis, which is the JAX
step's ``jax.vmap`` over the model and the loss: per-row products are
shared, gathers, segment sums and the max-pool stay per sample
(``ops/segment.py``).  The train step is one model call for the batch,
optax's chain(add_decayed_weights, sgd) on flat buffers
(``train/steps.Optimizer``) and the branchless NaN skip
(``train/steps.apply_update``); on a CUDA device it is captured as one
CUDA graph per state and batch shape and replayed
(``core/capture.CapturedStep``), on the CPU it runs eagerly.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from ..core.capture import CapturedStep
from ..core.graph import resolve_device
from ..ops import segment as S
from ..train.loss import one_hot, sigmoid_focal_loss
from ..train.steps import Optimizer, TrainState, apply_update, step_metrics
from .blocks import Linear, MLPStack, ScalarNorm, TaskSpecificHead, init_parameters

SEED = 1234  # GNNConfig.seed's default


@dataclasses.dataclass
class ClassifierConfig:
    """configuration_radarscenes_classifier.yml defaults."""

    clustering_eps: float = 1.4
    valid_cluster_num_meas_thr: int = 2
    meas_noise_var: float = 1.0
    activation: str = "leakyrelu"
    aggregation: str = "add"  # yml 'sum' == torch_geometric 'add'
    node_feat_enc_stem_channels: Sequence[int] = (256, 128, 128)
    graph_convolution_stem_channels: Sequence[int] = (128,) * 5
    msg_mlp_hidden_dim: int = 128
    node_pred_stem_channels: Sequence[int] = (128, 128, 128)
    input_node_feat_dim: int = 5
    num_classes: int = 7
    learning_rate: float = 0.001
    weight_decay: float = 1e-4
    momentum: float = 0.9
    max_train_iter: int = 100_000
    # static capacities
    max_points: int = 512
    max_objects: int = 64
    max_edges: int = 8192


class ClassifierSample(NamedTuple):
    """One frame's proposals, flattened + padded (numpy arrays or tensors;
    with a leading batch axis in a batch)."""

    point_feat: np.ndarray    # [P, 5]
    point_mask: np.ndarray    # [P] bool
    point2object: np.ndarray  # [P] int32 (void = max_objects)
    senders: np.ndarray       # [E] int32
    receivers: np.ndarray     # [E] int32
    edge_mask: np.ndarray     # [E] bool
    object_class: np.ndarray  # [O] int32 (GT majority labels)
    object_mask: np.ndarray   # [O] bool

    def to(self, device) -> "ClassifierSample":
        return ClassifierSample(*(torch.as_tensor(v).to(device) for v in self))

    def at(self, i: int) -> "ClassifierSample":
        return ClassifierSample(*(v[i] for v in self))


def stack_samples(samples: Sequence[ClassifierSample]) -> ClassifierSample:
    """Samples (numpy) → one batch with a leading axis."""
    return ClassifierSample(*(np.stack(v) for v in zip(*samples)))


def normalize_cluster_points(xy: np.ndarray, noise_var: float):
    """Shift to the sample mean and rotate into the covariance eigenbasis
    (datagen_classifier.py:44-48 via np.linalg.eig)."""
    mu = xy.mean(axis=0)
    if xy.shape[0] > 1:
        err = (mu - xy)[:, :, None]
        sigma = (err @ err.transpose(0, 2, 1)).sum(0) / (xy.shape[0] - 1)
        sigma = sigma + noise_var * np.eye(2)
    else:
        sigma = noise_var * np.eye(2)
    _, evecs = np.linalg.eigh(sigma)
    return (xy - mu) @ evecs, mu, sigma


def build_classifier_sample(
    xy: np.ndarray,
    rcs: np.ndarray,
    node_gt_class: np.ndarray,
    node2cluster: np.ndarray,
    num_clusters: int,
    ccfg: ClassifierConfig,
) -> Optional[ClassifierSample]:
    """Flatten a frame's clusters into a padded ClassifierSample.

    Clusters below valid_cluster_num_meas_thr points are dropped
    (yml CLUSTERING).  GT label per cluster = majority vote of member GT
    classes (datagen_classifier.py:52-60)."""
    P, O, E = ccfg.max_points, ccfg.max_objects, ccfg.max_edges
    feats, p2o, senders, receivers, obj_cls = [], [], [], [], []
    offset = 0
    obj_idx = 0
    for c in range(num_clusters):
        members = np.flatnonzero(node2cluster == c)
        m = members.shape[0]
        if m < ccfg.valid_cluster_num_meas_thr:
            continue
        if offset + m > P or obj_idx >= O:
            break
        pts, _, _ = normalize_cluster_points(xy[members], ccfg.meas_noise_var)
        r = np.sqrt(pts[:, 0] ** 2 + pts[:, 1] ** 2)
        th = np.arctan2(pts[:, 1], pts[:, 0])
        feats.append(
            np.stack([pts[:, 0], pts[:, 1], r, th, rcs[members]], axis=-1)
        )
        p2o.append(np.full(m, obj_idx, dtype=np.int32))
        # fully connected intra-cluster, no self loops
        ii, jj = np.meshgrid(np.arange(m), np.arange(m), indexing="ij")
        keep = ii != jj
        senders.append((ii[keep] + offset).astype(np.int32))
        receivers.append((jj[keep] + offset).astype(np.int32))
        labels, counts = np.unique(node_gt_class[members], return_counts=True)
        obj_cls.append(int(labels[np.argmax(counts)]))
        offset += m
        obj_idx += 1

    if not feats:
        return None

    feat = np.concatenate(feats, axis=0).astype(np.float32)
    p2o = np.concatenate(p2o)
    s = np.concatenate(senders)[:E]
    r = np.concatenate(receivers)[:E]

    def pad(x, size, fill=0):
        out = np.full((size,) + x.shape[1:], fill, dtype=x.dtype)
        out[: x.shape[0]] = x[:size]
        return out

    n_pts, n_edges, n_obj = feat.shape[0], s.shape[0], obj_idx
    return ClassifierSample(
        point_feat=pad(feat, P),
        point_mask=np.arange(P) < n_pts,
        point2object=pad(p2o, P, fill=O),
        senders=pad(s, E),
        receivers=pad(r, E),
        edge_mask=np.arange(E) < n_edges,
        object_class=pad(np.asarray(obj_cls, np.int32), O),
        object_mask=np.arange(O) < n_obj,
    )


class NormFreeConvBlock(nn.Module):
    """classifier/blocks.py:28-80: residual block, messages from endpoint
    features only, no normalisation but the projector's channel norm."""

    def __init__(self, in_dim: int, msg_channels: Sequence[int],
                 upd_channels: Sequence[int], activation: str):
        super().__init__()
        out_dim = upd_channels[-1]
        if in_dim != out_dim:
            self.identity = Linear(in_dim, out_dim)
            self.identity_norm = ScalarNorm("channel_normalization")
        else:
            self.identity = None
        self.msg_mlp = MLPStack(2 * in_dim, msg_channels, activation, None)
        self.upd_mlp = MLPStack(in_dim + msg_channels[-1], upd_channels,
                                activation, None)

    def forward(self, x, senders, receivers, point_mask, edge_mask):
        del point_mask
        n = x.shape[-2]
        identity = x if self.identity is None else self.identity_norm(self.identity(x))
        m = torch.cat([S.gather_nodes(x, receivers), S.gather_nodes(x, senders)],
                      dim=-1)
        agg = S.masked_segment_sum(self.msg_mlp(m), receivers, n, edge_mask)
        return identity + self.upd_mlp(torch.cat([x, agg], dim=-1))


class ObjectClassifierGNN(nn.Module):
    """classifier/classifier.py Model_Inference over one ClassifierSample:
    [max_objects, num_classes] logits (a batch with a leading sample axis:
    [B, max_objects, num_classes]).  Parameters from ``generator``
    (default: seeded with SEED)."""

    def __init__(self, ccfg: ClassifierConfig, *,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        c = self.ccfg = ccfg
        self.encode_node_feat = MLPStack(c.input_node_feat_dim,
                                         c.node_feat_enc_stem_channels,
                                         c.activation, None)
        convs, in_dim = [], c.node_feat_enc_stem_channels[-1]
        for ch in c.graph_convolution_stem_channels:
            convs.append(NormFreeConvBlock(in_dim, [c.msg_mlp_hidden_dim, ch],
                                           [ch], c.activation))
            in_dim = ch
        self.convs = nn.ModuleList(convs)
        self.stem = MLPStack(in_dim, c.node_pred_stem_channels, c.activation, None)
        self.pred_cls = TaskSpecificHead(c.node_pred_stem_channels[-1],
                                         c.num_classes, c.activation, None,
                                         init_bias=-math.log(99.0))
        if generator is None:
            generator = torch.Generator().manual_seed(SEED)
        init_parameters(self, generator)

    def forward(self, sample: ClassifierSample):
        c = self.ccfg
        x = self.encode_node_feat(sample.point_feat)
        for conv in self.convs:
            x = conv(x, sample.senders, sample.receivers, sample.point_mask,
                     sample.edge_mask)
        # max-pool per object BEFORE the stem (classifier/blocks.py:170-176)
        pooled = S.masked_segment_max(x, sample.point2object, c.max_objects,
                                      sample.point_mask)
        return self.pred_cls(self.stem(pooled))


def classifier_loss(logits, sample: ClassifierSample, num_classes: int):
    """Focal(α=−1) summed over classes, mean over valid objects
    (classifier/loss.py:5-15); also the object accuracy.  One sample, or
    a batch with a leading sample axis: then one value a sample."""
    per_obj = sigmoid_focal_loss(logits, one_hot(sample.object_class, num_classes),
                                 alpha=-1.0).sum(-1)
    mask = sample.object_mask.float()
    cnt = torch.clamp(mask.sum(-1), min=1.0)
    loss = (per_obj * mask).sum(-1) / cnt
    acc = ((logits.argmax(-1) == sample.object_class.long()).float() * mask).sum(-1) / cnt
    return loss, acc


def make_classifier_train_step(ccfg: ClassifierConfig
                               ) -> Tuple[Callable, Callable, Callable]:
    """(init, step, loss_fn), as the JAX package's (its model is the state's
    here).  ``init(generator=None, device="cuda")`` → TrainState with SGD
    (momentum, coupled weight decay: optax's chain(add_decayed_weights,
    sgd)) over one flat buffer of the parameters; ``step(state, batch)`` →
    (state, metrics), a batch being a ClassifierSample with a leading axis
    (numpy or tensors), skipped whole (``skipped`` = 1.0, nothing changes,
    the step is counted) where the loss or a gradient is not finite;
    ``loss_fn(model, batch)`` → (mean loss, mean accuracy), one model call
    for the batch.  On the card ``step.captured`` is the step's
    ``CapturedStep``."""

    def init(generator: Optional[torch.Generator] = None, device="cuda"):
        model = ObjectClassifierGNN(ccfg, generator=generator).to(resolve_device(device))
        return TrainState(model, Optimizer(model.parameters(), "sgd", ccfg.learning_rate,
                                           ccfg.weight_decay, momentum=ccfg.momentum))

    def loss_fn(model: ObjectClassifierGNN, batch: ClassifierSample):
        losses, accs = classifier_loss(model(batch), batch, ccfg.num_classes)
        return losses.mean(), accs.mean()

    def body(state: TrainState, batch: ClassifierSample) -> Dict[str, torch.Tensor]:
        loss, acc = loss_fn(state.model, batch)
        grads = torch.autograd.grad(loss, state.optimizer.params, allow_unused=True)
        ok = apply_update(state, loss, grads)
        return step_metrics({"loss_obj_cls": loss, "object_accuracy": acc}, ok)

    captured = CapturedStep(body, leaves=list, rebuild=lambda inputs: ClassifierSample(*inputs))

    def step(state: TrainState, batch: ClassifierSample):
        if state.device.type == "cpu":
            return state, body(state, batch.to(state.device))
        return state, captured(state, batch)

    step.captured = captured
    return init, step, loss_fn
