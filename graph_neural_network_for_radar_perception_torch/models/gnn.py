"""The integrated multi-task radar GNN.

The JAX package's ``models/gnn.py`` (the reference's
modules/neural_net/gnn/gnn_detector.py:31-201): encoders → message-passing
stack → four task heads, over ONE padded graph or a batch of them with a
leading graph axis (every field of the RadarGraph and the labels [B, ...]):
one call for the batch where the JAX package vmaps the one-graph model
(train/steps.batched_forward, batched_deploy), each message round one
kernel launch for all B graphs, layer/group norm statistics per graph.

* ``forward`` — training path: cluster membership is ground truth.
* ``deploy`` — deployment path: decodes predicted cluster centers, runs
  DBSCAN on the device (infer/clustering.py) and feeds the resulting
  clusters to the object head.

Both run the message rounds through ``cfg.mp_impl`` unless the call names
another (``mp_impl=``): the fused round, or the CSR round (the JAX
package's models/fast_path.py with ``mp_impl="csr"``).  ``forward`` takes
``mp_bf16`` (the rounds' bf16 operands, ``fast_forward(mp_bf16=True)``);
``deploy`` does not, as the JAX package's deploy does not.  Both take
per-node ``extra_features`` [N, extra_feature_dim] for the update MLPs.

Variants override two hooks, as in the JAX package: ``_make_neck`` (the
message-passing stack in the ``pass_messages`` slot; ``models/gat.py``'s
RadarGNNv2 puts its GATv2 neck there) and ``_make_node_heads`` /
``_node_heads`` (``RadarGNNv1``'s shared node stem), so that ``forward``
and ``deploy`` serve every model family.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch
from torch import nn

from ..config.config import GNNConfig
from ..core.graph import RadarGraph, device_constant
from ..infer.clustering import dbscan_on_device
from ..ops.csr_mp import reverse_edge_features
from .blocks import (
    GraphConvolution,
    GraphFeatureEncoding,
    LinkPredictions,
    NodeOffsetPredictions,
    NodePredictions,
    NodeSegmentation,
    ObjectClassification,
    init_parameters,
)


class GNNOutputs(NamedTuple):  # a batch's: [B, ...]
    node_cls: torch.Tensor      # [N, num_classes]
    node_offsets: torch.Tensor  # [N, 2] (normalised units)
    edge_cls: torch.Tensor      # [Eu, num_edge_classes]
    obj_cls: torch.Tensor       # [C, num_classes]
    node_embed: torch.Tensor    # [N, D] final node embeddings


class DeployOutputs(NamedTuple):  # a batch's: [B, ...]
    node_cls: torch.Tensor
    node_offsets: torch.Tensor
    edge_cls: torch.Tensor
    obj_cls: torch.Tensor       # [N, num_classes] — one slot per possible cluster
    centers: torch.Tensor       # [N, 2] decoded cluster centers
    node2cluster: torch.Tensor  # [N] int32 (DBSCAN result; void = N)
    num_clusters: torch.Tensor  # int32 scalar


def decode_cluster_centers(node_offsets, other_feat, cfg: GNNConfig):
    """Predicted centers = measurement xy + unnormalised offsets
    (gnn_detector.py:166-168)."""
    sigma = device_constant(tuple(cfg.reg_sigma), node_offsets.dtype,
                            node_offsets.device)
    mu = device_constant(tuple(cfg.reg_mu), node_offsets.dtype,
                         node_offsets.device)
    return other_feat[..., :2] + node_offsets * sigma + mu


class RadarGNN(nn.Module):
    """Four-task message-passing GNN (flagship model).

    Parameters are initialised from ``generator`` (default: a CPU generator
    seeded with ``cfg.seed``); move the model with ``.to(device)``.
    ``extra_feature_dim``: the width of the ``extra_features`` the update
    MLPs take (0: none)."""

    def __init__(self, cfg: GNNConfig, *,
                 generator: Optional[torch.Generator] = None,
                 extra_feature_dim: int = 0):
        super().__init__()
        self.cfg = cfg
        args = (cfg.activation, cfg.norm_layer, cfg.num_groups)
        node_dim = cfg.node_feat_enc_stem_channels[-1]
        edge_dim = cfg.edge_feat_enc_stem_channels[-1]
        embed = cfg.graph_convolution_stem_channels[-1]
        self.encode_node_feat = GraphFeatureEncoding(
            cfg.input_node_feat_dim, cfg.node_feat_enc_stem_channels, *args)
        self.encode_edge_feat = GraphFeatureEncoding(
            cfg.input_edge_feat_dim, cfg.edge_feat_enc_stem_channels, *args)
        self.pass_messages = self._make_neck(node_dim, edge_dim,
                                             extra_feature_dim)
        self.predict_link = LinkPredictions(
            embed, cfg.num_blocks_to_compute_edge, cfg.link_pred_stem_channels,
            cfg.num_edge_classes, *args)
        self.predict_class = ObjectClassification(
            embed, cfg.node_pred_stem_channels, cfg.num_classes, *args)
        self._make_node_heads(embed)
        if generator is None:
            generator = torch.Generator().manual_seed(cfg.seed)
        init_parameters(self, generator)

    def _make_neck(self, node_dim: int, edge_dim: int, extra_dim: int):
        """The message-passing neck; v2 overrides it with the GAT neck."""
        cfg = self.cfg
        return GraphConvolution(
            node_dim, edge_dim, cfg.graph_convolution_stem_channels,
            cfg.msg_mlp_hidden_dim, cfg.aggregation, cfg.activation,
            cfg.norm_layer, cfg.num_groups, mp_impl=cfg.mp_impl,
            csr_tiling=(cfg.csr_edge_tile, cfg.csr_window, cfg.csr_src_window),
            extra_dim=extra_dim)

    def _make_node_heads(self, embed: int):
        """The node class and offset heads; v1 overrides it."""
        cfg = self.cfg
        args = (cfg.activation, cfg.norm_layer, cfg.num_groups)
        self.predict_node = NodeSegmentation(
            embed, cfg.node_pred_stem_channels, cfg.num_classes, *args)
        self.predict_offset = NodeOffsetPredictions(
            embed, cfg.node_pred_stem_channels, cfg.reg_offset_dim, *args)

    def _node_heads(self, x, nm):
        """(node_cls, node_off); v1 routes both through one fused head."""
        return self.predict_node(x, nm), self.predict_offset(x, nm)

    def trunk(self, graph: RadarGraph, mp_impl: Optional[str] = None,
              mp_bf16: bool = False, extra_features=None, graph_group=None):
        """Encoders + message passing → final node embeddings
        (gnn_detector.py:151-156).  On "csr" (fast_path.py:125-156) the edge
        encoder reads the reversed edges' raw features, and
        ``GraphConvolution`` zeroes masked edge rows and adds the NaN guard
        of window violations; each directed edge is still encoded once,
        just enumerated differently.  ``mp_bf16``: the message rounds' bf16
        operands.  ``graph_group``: the graph's edges are this rank's shard
        (``parallel/``; the JAX package's ``cfg.graph_axis``)."""
        mp_impl = mp_impl or self.cfg.mp_impl
        nm, em = graph.node_mask, graph.edge_mask
        x = self.encode_node_feat(graph.node_feat, nm)
        edge_feat = graph.edge_feat
        if mp_impl == "csr":
            edge_feat = reverse_edge_features(edge_feat)
        e = self.encode_edge_feat(edge_feat, em)
        return self.pass_messages(x, e, graph.senders, graph.receivers, nm, em,
                                  mp_impl, mp_bf16, extra_features, graph_group)

    def forward(self, graph: RadarGraph, node2cluster, num_clusters: int,
                cluster_mask, mp_impl: Optional[str] = None,
                mp_bf16: bool = False, extra_features=None,
                graph_group=None) -> GNNOutputs:
        """With a ``graph_group`` the edge fields of ``graph`` (and so
        ``edge_cls``) are this rank's shard along E."""
        nm = graph.node_mask
        x = self.trunk(graph, mp_impl, mp_bf16, extra_features, graph_group)
        node_cls, node_off = self._node_heads(x, nm)
        edge_cls = self.predict_link(
            x, graph.und_senders, graph.und_receivers, nm, graph.und_mask)
        obj_cls = self.predict_class(
            x, node2cluster, num_clusters, nm, cluster_mask)
        return GNNOutputs(node_cls, node_off, edge_cls, obj_cls, x)

    def deploy(self, graph: RadarGraph, eps: float = 1.4,
               from_links: bool = False, mp_impl: Optional[str] = None,
               extra_features=None) -> DeployOutputs:
        """Deployment forward with on-device DBSCAN proposals
        (gnn_detector.py:141-195, extract_proposals path; default eps=1.4
        per Model_Inference.__init__).  One graph, or a batch with a
        leading graph axis (``train/steps.batched_deploy``): every output
        then leads with it, ``num_clusters`` [B].  Nothing is read on the
        host, so a CUDA graph can hold the whole forward."""
        nm = graph.node_mask
        n = graph.num_nodes
        x = self.trunk(graph, mp_impl, extra_features=extra_features)
        node_cls, node_off = self._node_heads(x, nm)
        edge_cls = self.predict_link(
            x, graph.und_senders, graph.und_receivers, nm, graph.und_mask)
        zero = torch.zeros((), dtype=node_off.dtype, device=node_off.device)
        centers = decode_cluster_centers(
            torch.where(nm[..., None], node_off, zero), graph.other_feat, self.cfg)
        # detach mirrors the reference's clone().detach() (gnn_detector.py:166)
        centers_sg = torch.where(nm[..., None], centers, zero).detach()
        if from_links:
            node2cluster, num_clusters = dbscan_on_device(
                centers_sg, nm, eps, from_links=True,
                und_senders=graph.und_senders,
                und_receivers=graph.und_receivers,
                und_mask=graph.und_mask,
                pred_edges=edge_cls.argmax(-1).detach(),
            )
        else:
            node2cluster, num_clusters = dbscan_on_device(centers_sg, nm, eps)
        cluster_mask = torch.arange(n, device=nm.device) < num_clusters[..., None]
        obj_cls = self.predict_class(x, node2cluster, n, nm, cluster_mask)
        return DeployOutputs(
            node_cls=node_cls,
            node_offsets=node_off,
            edge_cls=edge_cls,
            obj_cls=obj_cls,
            centers=centers,
            node2cluster=node2cluster,
            num_clusters=num_clusters,
        )


class RadarGNNv1(RadarGNN):
    """Model_Inference_v1 (gnn_detector.py:204-313): the flagship's trunk
    and link/object heads, but node class + offset share one stem through
    the fused ``NodePredictions`` head (gnn_blocks.py:392-439).

    ``deploy`` (inherited) routes through the fused head via
    ``_node_heads``, as the JAX package's does: the reference's
    Model_Inference_v1 has no extract_proposals branch, so this is a
    capability extension, not a port."""

    def _make_node_heads(self, embed: int):
        cfg = self.cfg
        self.predict_node_fused = NodePredictions(
            embed, cfg.node_pred_stem_channels, cfg.num_classes,
            cfg.reg_offset_dim, cfg.activation, cfg.norm_layer,
            cfg.num_groups)

    def _node_heads(self, x, nm):
        return self.predict_node_fused(x, nm)
