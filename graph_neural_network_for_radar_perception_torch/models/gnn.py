"""The integrated multi-task radar GNN.

The JAX package's ``models/gnn.py`` (the reference's
modules/neural_net/gnn/gnn_detector.py:31-201): encoders → message-passing
stack → four task heads, over ONE padded graph.

* ``forward`` — training path: cluster membership is ground truth.
* ``deploy`` — deployment path: decodes predicted cluster centers, runs
  DBSCAN on the device (infer/clustering.py) and feeds the resulting
  clusters to the object head.

Both run the message rounds through ``cfg.mp_impl`` unless the call names
another (``mp_impl=``): the fused round, or the CSR round (the JAX
package's models/fast_path.py with ``mp_impl="csr"``).  ``forward`` takes
``mp_bf16`` (the rounds' bf16 operands, ``fast_forward(mp_bf16=True)``);
``deploy`` does not, as the JAX package's deploy does not.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch
from torch import nn

from ..config.config import GNNConfig
from ..core.graph import RadarGraph
from ..infer.clustering import dbscan_on_device
from ..ops.csr_mp import reverse_edge_features
from .blocks import (
    GraphConvolution,
    GraphFeatureEncoding,
    LinkPredictions,
    NodeOffsetPredictions,
    NodeSegmentation,
    ObjectClassification,
    init_parameters,
)


class GNNOutputs(NamedTuple):
    node_cls: torch.Tensor      # [N, num_classes]
    node_offsets: torch.Tensor  # [N, 2] (normalised units)
    edge_cls: torch.Tensor      # [Eu, num_edge_classes]
    obj_cls: torch.Tensor       # [C, num_classes]
    node_embed: torch.Tensor    # [N, D] final node embeddings


class DeployOutputs(NamedTuple):
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
    sigma = torch.tensor(cfg.reg_sigma, dtype=node_offsets.dtype,
                         device=node_offsets.device)
    mu = torch.tensor(cfg.reg_mu, dtype=node_offsets.dtype,
                      device=node_offsets.device)
    return other_feat[..., :2] + node_offsets * sigma + mu


class RadarGNN(nn.Module):
    """Four-task message-passing GNN (flagship model).

    Parameters are initialised from ``generator`` (default: a CPU generator
    seeded with ``cfg.seed``); move the model with ``.to(device)``."""

    def __init__(self, cfg: GNNConfig, *,
                 generator: Optional[torch.Generator] = None):
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
        self.pass_messages = GraphConvolution(
            node_dim, edge_dim, cfg.graph_convolution_stem_channels,
            cfg.msg_mlp_hidden_dim, cfg.aggregation, *args,
            mp_impl=cfg.mp_impl,
            csr_tiling=(cfg.csr_edge_tile, cfg.csr_window, cfg.csr_src_window))
        self.predict_link = LinkPredictions(
            embed, cfg.num_blocks_to_compute_edge, cfg.link_pred_stem_channels,
            cfg.num_edge_classes, *args)
        self.predict_class = ObjectClassification(
            embed, cfg.node_pred_stem_channels, cfg.num_classes, *args)
        self.predict_node = NodeSegmentation(
            embed, cfg.node_pred_stem_channels, cfg.num_classes, *args)
        self.predict_offset = NodeOffsetPredictions(
            embed, cfg.node_pred_stem_channels, cfg.reg_offset_dim, *args)
        if generator is None:
            generator = torch.Generator().manual_seed(cfg.seed)
        init_parameters(self, generator)

    def trunk(self, graph: RadarGraph, mp_impl: Optional[str] = None,
              mp_bf16: bool = False):
        """Encoders + message passing → final node embeddings
        (gnn_detector.py:151-156).  On "csr" (fast_path.py:125-156) the edge
        encoder reads the reversed edges' raw features, and
        ``GraphConvolution`` zeroes masked edge rows and adds the NaN guard
        of window violations; each directed edge is still encoded once,
        just enumerated differently.  ``mp_bf16``: the message rounds' bf16
        operands."""
        mp_impl = mp_impl or self.cfg.mp_impl
        nm, em = graph.node_mask, graph.edge_mask
        x = self.encode_node_feat(graph.node_feat, nm)
        edge_feat = graph.edge_feat
        if mp_impl == "csr":
            edge_feat = reverse_edge_features(edge_feat)
        e = self.encode_edge_feat(edge_feat, em)
        return self.pass_messages(x, e, graph.senders, graph.receivers, nm, em,
                                  mp_impl, mp_bf16)

    def forward(self, graph: RadarGraph, node2cluster, num_clusters: int,
                cluster_mask, mp_impl: Optional[str] = None,
                mp_bf16: bool = False) -> GNNOutputs:
        nm = graph.node_mask
        x = self.trunk(graph, mp_impl, mp_bf16)
        node_cls = self.predict_node(x, nm)
        node_off = self.predict_offset(x, nm)
        edge_cls = self.predict_link(
            x, graph.und_senders, graph.und_receivers, nm, graph.und_mask)
        obj_cls = self.predict_class(
            x, node2cluster, num_clusters, nm, cluster_mask)
        return GNNOutputs(node_cls, node_off, edge_cls, obj_cls, x)

    def deploy(self, graph: RadarGraph, eps: float = 1.4,
               from_links: bool = False,
               mp_impl: Optional[str] = None) -> DeployOutputs:
        """Deployment forward with on-device DBSCAN proposals
        (gnn_detector.py:141-195, extract_proposals path; default eps=1.4
        per Model_Inference.__init__)."""
        nm = graph.node_mask
        n = graph.num_nodes
        x = self.trunk(graph, mp_impl)
        node_cls = self.predict_node(x, nm)
        node_off = self.predict_offset(x, nm)
        edge_cls = self.predict_link(
            x, graph.und_senders, graph.und_receivers, nm, graph.und_mask)
        zero = torch.zeros((), dtype=node_off.dtype, device=node_off.device)
        centers = decode_cluster_centers(
            torch.where(nm[:, None], node_off, zero), graph.other_feat, self.cfg)
        # detach mirrors the reference's clone().detach() (gnn_detector.py:166)
        centers_sg = torch.where(nm[:, None], centers, zero).detach()
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
        cluster_mask = torch.arange(n, device=nm.device) < num_clusters
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
