"""Operations and bytes of the GATv2 family (RadarGNNv2), from live rows only.

The peaks, ``least_seconds`` and ``round_work`` are ``harness/counts.py``'s.

``model_flops``: every matrix product of one RadarGNNv2 step over a
batch's live nodes, directed edges, undirected edges and clusters, with
``counts.model_flops``'s conventions (padding is not work; the backward
at twice the forward except the encoders' first layers, once).  A round's
products: the sender and receiver projections once a node, the edge
projection once an edge, the attention logits (a . s, H x C a edge) and
the weighted messages (alpha W_l x_j summed at the receiver, H x C a
edge), then the update MLP once a node.

``gat_work``: the least work of one GATv2 round (the attention entry's
forward, and with ``backward`` its gradients) on given live counts: the
node projections once a node; the edge projection, the leaky ReLU's
sums, the logits, the softmax and the messages once a live edge; each
input byte read once and each output byte written once.
"""

from __future__ import annotations

from harness.counts import (  # noqa: F401  (part of the module's interface)
    PEAK_BYTES_PER_S, PEAK_F32_FLOPS, _mlp, least_seconds, round_work)

# Elementwise floating-point operations of one edge at the least.  A
# channel of a head: the two sums of s, the leaky ReLU, the logit's
# product and sum, the message's weighting and its sum at the receiver.
EDGE_CHANNEL_FLOPS = 7
# A head: the shift by the receiver's largest logit, the exponential, the
# denominator's sum, the division, and the running max.
EDGE_HEAD_FLOPS = 5
# And of the backward: a channel: the weighted message's two products
# (dalpha's term and dx_j), the logit's two (ds and datt's term), the
# leaky ReLU's, datt's sum and the sum of the three projections'
# cotangents; a head: the softmax's backward (a product, a sum, a
# difference, a product).
EDGE_CHANNEL_BWD_FLOPS = 7
EDGE_HEAD_BWD_FLOPS = 4


def update_widths(cfg: dict, out: int):
    """The update MLP's widths of a round of width ``out``
    (gnn_attention.py:79-123: hidden/2, hidden/4, the round's width)."""
    hid = cfg["hidden_node_channels_gat"]
    return [hid // 2, hid // 4, out]


def model_flops(cfg: dict, nodes: int, edges: int, und: int, clusters: int,
                train: bool) -> float:
    """FLOPs of one step's products over these live counts (summed over a
    batch's slots)."""
    d_n, d_e = cfg["node_feat_enc_stem_channels"], cfg["edge_feat_enc_stem_channels"]
    x = d_n[-1]
    hc = (cfg["hidden_node_channels_gat"] // cfg["num_heads_gat"]) * cfg["num_heads_gat"]
    n_cls = len(cfg["class_weights_dyn"])
    emb = cfg["graph_convolution_stem_channels"][-1]
    stem, link = cfg["node_pred_stem_channels"], cfg["link_pred_stem_channels"]
    first = nodes * 6 * d_n[0] + edges * 7 * d_e[0]          # encoders' first layers
    rest = nodes * _mlp(d_n[0], d_n[1:]) + edges * _mlp(d_e[0], d_e[1:])
    for out in cfg["graph_convolution_stem_channels"]:
        rest += nodes * 2 * x * hc                            # sender and receiver projections
        rest += edges * (d_e[-1] * hc + 2 * hc)               # edge projection, logits, messages
        rest += nodes * _mlp(x + hc, update_widths(cfg, out))  # update MLP
        x = out
    rest += nodes * (_mlp(emb, stem) + stem[-1] * stem[-1] + stem[-1] * n_cls)  # node class
    rest += nodes * (_mlp(emb, stem) + stem[-1] * stem[-1] + stem[-1] * 2)      # offsets
    rest += nodes * emb * emb * cfg["num_blocks_to_compute_edge"]                # link: nodes
    rest += und * (_mlp(emb, link) + link[-1] * link[-1] + link[-1] * 2)        # link: pairs
    rest += nodes * _mlp(emb, stem)                                              # object stem
    rest += clusters * (stem[-1] * stem[-1] + stem[-1] * n_cls)                  # object head
    macs = (2 * first + 3 * rest) if train else (first + rest)
    return 2.0 * macs


def gat_work(nodes: int, edges: int, d: int, de: int, heads: int, c: int,
             backward: bool):
    """(FLOPs, bytes) of one GATv2 round's least work over live counts
    (summed over a batch's graphs): x [n, d], ef [e, de], W_l and W_r
    [d, H C], W_e [de, H C], their biases, att [H, C] and the bias [H C];
    out [n, H C].  With ``backward`` also its gradients for the cotangent
    of out: dx, def and every weight's."""
    hc = heads * c
    products = 2.0 * (nodes * 2 * d * hc + edges * de * hc)
    elementwise = edges * (EDGE_CHANNEL_FLOPS * hc + EDGE_HEAD_FLOPS * heads) + nodes * hc
    weights = 4 * ((2 * d + de) * hc + 3 * hc + hc + hc)
    read = 4 * (nodes * d + edges * de) + 8 * edges + weights
    written = 4 * nodes * hc
    if not backward:
        return products + elementwise, read + written
    elementwise += edges * (EDGE_CHANNEL_BWD_FLOPS * hc + EDGE_HEAD_BWD_FLOPS * heads)
    read += 4 * nodes * hc                         # the cotangent of out
    written += 4 * (nodes * d + edges * de) + weights
    return 3 * products + elementwise, read + written
