"""The operations and bytes of the per-layer metrics, by hand on a small
configuration."""

import bench_support  # noqa: F401  (import paths)
from harness import counts

SMALL = dict(node_feat_enc_stem_channels=[4, 2], edge_feat_enc_stem_channels=[3, 2],
             graph_convolution_stem_channels=[2], msg_mlp_hidden_dim=5,
             link_pred_stem_channels=[2], node_pred_stem_channels=[2],
             num_blocks_to_compute_edge=1, class_weights_dyn=[1.0] * 7)


def test_model_flops_by_hand():
    n, e, u, c = 3, 4, 2, 1
    first = n * 6 * 4 + e * 7 * 3
    rest = (n * 4 * 2 + e * 3 * 2                    # encoders after the first layers
            + n * 2 * 2 * 5 + e * (2 * 5 + 5 * 2)     # one round: node parts, edge parts
            + n * (2 + 2) * 2                         # update MLP
            + n * (2 * 2 + 2 * 2 + 2 * 7)             # node class: stem, head, out
            + n * (2 * 2 + 2 * 2 + 2 * 2)             # offsets
            + n * 2 * 2                               # link: the nodes' block
            + u * (2 * 2 + 2 * 2 + 2 * 2)             # link: pairs
            + n * 2 * 2                               # object stem
            + c * (2 * 2 + 2 * 7))                    # object head
    assert counts.model_flops(SMALL, n, e, u, c, train=False) == 2.0 * (first + rest)
    assert counts.model_flops(SMALL, n, e, u, c, train=True) == 2.0 * (2 * first + 3 * rest)


def test_round_work_by_hand():
    n, e, d, de, h, d2 = 5, 7, 4, 3, 8, 4
    products = 2 * (n * 2 * d * h + e * (de * h + h * d2))
    elementwise = e * (10 * h + 8 * d2)
    weights = 4 * ((2 * d + de) * h + h + h * d2 + d2 + 4)
    read = 4 * (n * d + e * de) + 8 * e + weights
    assert counts.round_work(n, e, d, de, h, d2, backward=False) == (
        products + elementwise, read + 4 * n * d2)
    flops, nbytes = counts.round_work(n, e, d, de, h, d2, backward=True)
    assert flops == 3 * products + elementwise + e * 7 * (h + d2)
    assert nbytes == read + 4 * n * d2 + 4 * n * d2 + 4 * (n * d + e * de) + weights


def test_least_seconds_takes_the_larger_bound():
    assert counts.least_seconds(67e12, 1.0) == (1.0, "operations")
    assert counts.least_seconds(1.0, 3.35e12) == (1.0, "bytes")
