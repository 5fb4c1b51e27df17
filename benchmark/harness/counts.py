"""Operations and bytes the work needs, from live rows only.

``model_flops``: every matrix product of one step over the live nodes,
directed edges, undirected edges and clusters of a batch (padding is not
work), the backward at twice the forward except the encoders' first
layers, whose input needs no gradient (once).  Elementwise work is not
counted.

``round_work``: the least work of one message round (the round entry's
forward, and with ``backward`` its gradients) on given live counts: the
node products once per live node, the edge products, norms, activations
and the scatter once per live edge, each input byte read once and each
output byte written once.

The published peaks of one H100 SXM at its 700 W limit (NVIDIA's data
sheet): float32 outside the tensor cores, HBM3 bandwidth.
"""

from __future__ import annotations

PEAK_F32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12

# floating-point operations a row element of a channel norm and leaky ReLU
# takes at the least: the sum, the deviation, its square and sum, the
# scale, the affine pair and the activation.
NORM_ACT_FLOPS = 7
# and of its backward at the least
NORM_ACT_BWD_FLOPS = 7


def _mlp(fan_in: int, widths) -> int:
    """Multiply-adds of one row through a stack of linear layers."""
    total = 0
    for w in widths:
        total += fan_in * w
        fan_in = w
    return total


def model_flops(cfg: dict, nodes: int, edges: int, und: int, clusters: int,
                train: bool) -> float:
    """FLOPs of one step's products over these live counts (summed over a
    batch's slots)."""
    d_n, d_e = cfg["node_feat_enc_stem_channels"], cfg["edge_feat_enc_stem_channels"]
    h = cfg["msg_mlp_hidden_dim"]
    x = d_n[-1]
    n_cls = len(cfg["class_weights_dyn"])
    emb = cfg["graph_convolution_stem_channels"][-1]
    stem, link = cfg["node_pred_stem_channels"], cfg["link_pred_stem_channels"]
    first = nodes * 6 * d_n[0] + edges * 7 * d_e[0]          # encoders' first layers
    rest = nodes * _mlp(d_n[0], d_n[1:]) + edges * _mlp(d_e[0], d_e[1:])
    for out in cfg["graph_convolution_stem_channels"]:
        rest += nodes * 2 * x * h                             # receiver and sender parts
        rest += edges * (d_e[-1] * h + h * out)               # edge part, second layer
        rest += nodes * (x + out) * out                       # update MLP
    rest += nodes * (_mlp(emb, stem) + stem[-1] * stem[-1] + stem[-1] * n_cls)  # node class
    rest += nodes * (_mlp(emb, stem) + stem[-1] * stem[-1] + stem[-1] * 2)      # offsets
    rest += nodes * emb * emb * cfg["num_blocks_to_compute_edge"]                # link: nodes
    rest += und * (_mlp(emb, link) + link[-1] * link[-1] + link[-1] * 2)        # link: pairs
    rest += nodes * _mlp(emb, stem)                                              # object stem
    rest += clusters * (stem[-1] * stem[-1] + stem[-1] * n_cls)                  # object head
    macs = (2 * first + 3 * rest) if train else (first + rest)
    return 2.0 * macs


def round_work(nodes: int, edges: int, d: int, de: int, h: int, d2: int,
               backward: bool):
    """(FLOPs, bytes) of one round's least work over live counts (summed
    over a batch's graphs): x [n, d], ef [e, de], W1 [2d + de, h],
    W2 [h, d2], agg [n, d2]; with ``backward`` also its gradients for the
    cotangent of agg: dx, def, and every weight's."""
    products = 2.0 * (nodes * 2 * d * h + edges * (de * h + h * d2))
    elementwise = edges * ((NORM_ACT_FLOPS + 3) * h + (NORM_ACT_FLOPS + 1) * d2)
    weights = 4 * ((2 * d + de) * h + h + h * d2 + d2 + 4)
    read = 4 * (nodes * d + edges * de) + 8 * edges + weights
    written = 4 * nodes * d2
    if not backward:
        return products + elementwise, read + written
    elementwise += edges * NORM_ACT_BWD_FLOPS * (h + d2)
    read += 4 * nodes * d2                        # the cotangent of agg
    written += 4 * (nodes * d + edges * de) + weights
    return 3 * products + elementwise, read + written


def least_seconds(flops: float, nbytes: float):
    """(the round's least time on one H100, which of the two bounds it)."""
    t_ops, t_bytes = flops / PEAK_F32_FLOPS, nbytes / PEAK_BYTES_PER_S
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")
