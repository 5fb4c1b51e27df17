"""Building blocks of the radar GNN as ``nn.Module``s.

The same blocks as the JAX package's ``models/blocks.py`` (the reference's
modules/neural_net/common.py + gnn/gnn_blocks.py) over static-shape masked
graphs.  Widths are given at construction.  Parameters are created empty and
set by ``init_parameters(module, generator)``:

* ``Linear``: weight and bias U(±1/√fan_in) (torch.nn.Linear's default);
* task heads' output layer: weight N(0, 0.01), bias −log 99 for the
  classification heads and 0 for the regression head
  (modules/neural_net/constants.py:15-26);
* ``ScalarNorm``: γ = 1, β = 0, one scalar each.

Message passing: m_e = MLP([x_recv ‖ x_send ‖ e]) summed at the receiver,
then x ← identity + MLP([x ‖ agg]).  For the shipped configuration
(channel norm, leaky ReLU, sum aggregation) each round goes through a
fused round, the hand-written kernel on a CUDA device:
``ops.fused_mp.fused_message_pass`` (``mp_impl`` None or "onehot") or
``ops.csr_mp.fused_message_pass_csr`` ("csr", over the reversed edge
enumeration; ``RadarGNN.trunk`` reverses the raw edge features).  Other
configurations run the plain gather → MLP → segment path.  ``mp_bf16``
runs the fused rounds with the TPU kernels' bf16 operands (the JAX
package's ``fast_forward(mp_bf16=True)``); it needs a fused round.

Every block takes one graph ([N, D] nodes, [E] edges) or a batch of them
with a leading graph axis ([B, N, D], [B, E]), as the JAX package's
``jax.vmap`` of the one-graph model does: per-row products are shared,
layer/group norm statistics, gathers and segment sums stay per graph
(``ops/norms.py``, ``ops/segment.py``), and each fused round is one call of
the kernels for the whole batch.

With a ``graph_group`` (the JAX package's ``graph_axis``: a process group
of ``parallel/mesh.py``) the edge arrays are this rank's shard along E.
Each round then computes the partial aggregate over the local edges, on
the same route (kernel or plain) as without, and combines the partials
across the group: a sum all-reduce for "add", for "mean" that of the sums
and of the edge counts, then the division, and for "max" a max all-reduce
(forward only, as ``jax.lax.pmax``).  Everything on the nodes stays
replicated across the group.
"""

from __future__ import annotations

import math
from typing import Callable, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..ops import csr_mp as C
from ..ops import fused_mp as FM
from ..ops import norms as N
from ..ops import segment as S
from ..ops.fused_mp import fused_message_pass
from ..parallel import collectives as P

LEAKY_SLOPE = 0.01  # constants.py:10
HEAD_STD = 0.01  # constants.py:16
CLS_BIAS = -math.log(99.0)  # constants.py:22


def activation_fn(name: str) -> Callable:
    """common.py:256-267."""
    if name == "leakyrelu":
        return lambda x: F.leaky_relu(x, LEAKY_SLOPE)
    if name == "swish":
        return F.silu
    return F.relu


class Linear(nn.Module):
    """y = x·Wᵀ + b with weight [out, in]; U(±1/√fan_in) initialisation."""

    def __init__(self, in_features: int, out_features: int):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(out_features, in_features))
        self.bias = nn.Parameter(torch.empty(out_features))

    def reset_parameters(self, generator: Optional[torch.Generator]):
        bound = 1.0 / math.sqrt(self.weight.shape[1])
        with torch.no_grad():
            self.weight.uniform_(-bound, bound, generator=generator)
            self.bias.uniform_(-bound, bound, generator=generator)

    def forward(self, x):
        return F.linear(x, self.weight, self.bias)


class HeadLinear(Linear):
    """Output layer of a task head: N(0, HEAD_STD) weight, constant bias."""

    def __init__(self, in_features: int, out_features: int, init_bias: float):
        super().__init__(in_features, out_features)
        self.init_bias = init_bias

    def reset_parameters(self, generator: Optional[torch.Generator]):
        with torch.no_grad():
            self.weight.normal_(0.0, HEAD_STD, generator=generator)
            self.bias.fill_(self.init_bias)


class ScalarNorm(nn.Module):
    """One of the reference's three norms, selected by name, with scalar
    affine parameters.  ``mask`` (rows of x) only affects layer/group norms,
    whose statistics couple across rows."""

    def __init__(self, norm_layer: str, num_groups: Optional[int] = None):
        super().__init__()
        if norm_layer not in ("channel_normalization", "layer_normalization",
                              "group_normalization"):
            raise ValueError(f"unknown norm_layer {norm_layer!r}")
        self.norm_layer = norm_layer
        self.num_groups = num_groups
        self.gamma = nn.Parameter(torch.empty(1))
        self.beta = nn.Parameter(torch.empty(1))

    def reset_parameters(self, generator: Optional[torch.Generator]):
        del generator
        with torch.no_grad():
            self.gamma.fill_(1.0)
            self.beta.fill_(0.0)

    def forward(self, x, mask=None):
        if self.norm_layer == "channel_normalization":  # the pair, no activation
            return N.channel_norm_act(x, self.gamma, self.beta, 1.0)
        if self.norm_layer == "layer_normalization":
            return N.layer_norm(x, self.gamma, self.beta, mask)
        return N.group_norm(x, self.gamma, self.beta, self.num_groups, mask)


def init_parameters(module: nn.Module, generator: torch.Generator) -> None:
    """Initialise every parameter of ``module`` from ``generator``, in
    module order: each ``Linear`` and ``ScalarNorm``, and each module that
    sets ``owns_parameters`` for the parameters it holds itself (the GATv2
    attention vector and bias)."""
    for m in module.modules():
        if isinstance(m, (Linear, ScalarNorm)) or getattr(m, "owns_parameters", False):
            m.reset_parameters(generator)


class FFNBlock(nn.Module):
    """Linear → [norm] → activation (common.py:185-205).  A channel norm
    followed by leaky ReLU or ReLU is one ``ops.norms.channel_norm_act``
    (``fused_slope``: the activation's slope); with another activation the
    norm's own call, then the activation."""

    def __init__(self, in_features, features, activation, norm_layer=None,
                 num_groups=None):
        super().__init__()
        self.linear = Linear(in_features, features)
        self.norm = (
            None if norm_layer is None else ScalarNorm(norm_layer, num_groups)
        )
        self.act = activation_fn(activation)
        self.fused_slope = ({"leakyrelu": LEAKY_SLOPE, "relu": 0.0}.get(activation)
                            if norm_layer == "channel_normalization" else None)

    def forward(self, x, mask=None):
        x = self.linear(x)
        if self.fused_slope is not None:
            return N.channel_norm_act(x, self.norm.gamma, self.norm.beta, self.fused_slope)
        if self.norm is not None:
            x = self.norm(x, mask)
        return self.act(x)


class MLPStack(nn.Module):
    """Sequence of FFNBlocks; ``first_unnormalized`` mirrors the encoders'
    convention that block 0 skips the norm (gnn_blocks.py:29-38)."""

    def __init__(self, in_features: int, stem_channels: Sequence[int],
                 activation: str, norm_layer: Optional[str], num_groups=None,
                 first_unnormalized: bool = False):
        super().__init__()
        blocks = []
        for i, ch in enumerate(stem_channels):
            norm = None if (i == 0 and first_unnormalized) else norm_layer
            blocks.append(FFNBlock(in_features, ch, activation, norm, num_groups))
            in_features = ch
        self.blocks = nn.ModuleList(blocks)

    def forward(self, x, mask=None):
        for blk in self.blocks:
            x = blk(x, mask)
        return x


class GraphFeatureEncoding(MLPStack):
    """Node/edge feature encoder (gnn_blocks.py:19-42): an MLPStack whose
    first block is not normalised."""

    def __init__(self, in_features, stem_channels, activation, norm_layer,
                 num_groups=None):
        super().__init__(in_features, stem_channels, activation, norm_layer,
                         num_groups, first_unnormalized=True)


def uses_fused_kernel(norm_layer: str, activation: str, aggregation: str) -> bool:
    """Whether a message round can go through ``fused_message_pass``: the
    kernel computes channel norm + leaky ReLU + sum aggregation only (the
    condition of the JAX package's models/fast_path.py)."""
    return (norm_layer == "channel_normalization"
            and activation == "leakyrelu" and aggregation == "add")


class ResidualGraphConvBlock(nn.Module):
    """One edge-conditioned residual message-passing round
    (gnn_blocks.py:45-113)."""

    def __init__(self, in_dim: int, edge_dim: int, msg_hidden: int,
                 out_dim: int, aggregation: str, activation: str,
                 norm_layer: str, num_groups=None, extra_dim: int = 0):
        """``extra_dim``: the width of the per-node ``extra_features`` that
        ``forward`` concatenates between x and the aggregate in the update
        MLP's input (gnn_blocks.py:107); 0 for none."""
        super().__init__()
        if aggregation not in ("add", "max", "mean"):
            raise ValueError(f"unknown aggregation {aggregation!r}")
        self.aggregation = aggregation
        self.fused = uses_fused_kernel(norm_layer, activation, aggregation)
        if in_dim != out_dim:  # gnn_blocks.py:84-94
            self.identity = Linear(in_dim, out_dim)
            self.identity_norm = ScalarNorm(norm_layer, num_groups)
        else:
            self.identity = None
        # message: MLP([x_i ‖ x_j ‖ e]) with i = receiver, j = sender
        # (torch_geometric message(x_i, x_j, edge_attr), gnn_blocks.py:112)
        self.msg_mlp = MLPStack(2 * in_dim + edge_dim, [msg_hidden, out_dim],
                                activation, norm_layer, num_groups)
        self.upd_mlp = MLPStack(in_dim + extra_dim + out_dim, [out_dim],
                                activation, norm_layer, num_groups)

    def forward(self, x, edge_feat, senders, receivers, node_mask, edge_mask,
                csr_layout=None, mp_bf16=False, fused_layout=None,
                extra_features=None, graph_group=None):
        """On the fused path, masked edges must carry the sentinel index N
        at both ends (``GraphConvolution`` maps them); ``fused_layout`` is
        the graph's ``ops.fused_mp.fused_layout``, shared by its rounds, or
        None to make it per round.  With a
        ``csr_layout`` (the graph's ``ops.csr_mp.csr_layout``, shared by its
        rounds) the round goes through the CSR pass: position p is the edge
        (receivers[p] → senders[p]), so dst = senders (sorted), src =
        receivers, and w1's row order [x_recv ‖ x_send ‖ e] is unchanged
        (the JAX package's models/fast_path.py).  ``mp_bf16``: the fused
        round's bf16 operands; a ``ValueError`` if this round is not fused.
        ``graph_group``: the edges are this rank's shard; the partial
        aggregates are combined across the group (module docstring)."""
        if mp_bf16 and not self.fused:
            raise ValueError("mp_bf16 needs the fused round: channel "
                             "normalisation, leaky ReLU and sum aggregation")
        n = x.shape[-2]
        if self.identity is not None:
            identity = self.identity_norm(self.identity(x), node_mask)
        else:
            identity = x
        if self.fused:
            m0, m1 = self.msg_mlp.blocks
            params = (m0.linear.weight.t().contiguous(), m0.linear.bias,
                      m1.linear.weight.t().contiguous(), m1.linear.bias,
                      m0.norm.gamma, m0.norm.beta, m1.norm.gamma,
                      m1.norm.beta, LEAKY_SLOPE)
            if csr_layout is not None:
                agg = C.fused_message_pass_csr(
                    x, edge_feat, receivers, senders, *params,
                    bf16=mp_bf16, layout=csr_layout)
            else:
                agg = fused_message_pass(x, edge_feat, senders, receivers,
                                         *params, bf16=mp_bf16,
                                         layout=fused_layout)
        else:
            m = torch.cat([S.gather_nodes(x, receivers),
                           S.gather_nodes(x, senders), edge_feat], dim=-1)
            m = self.msg_mlp(m, edge_mask)
            if self.aggregation == "max":
                agg = S.masked_segment_max(m, receivers, n, edge_mask)
            elif self.aggregation == "mean" and graph_group is None:
                agg = S.masked_segment_mean(m, receivers, n, edge_mask)
            else:
                agg = S.masked_segment_sum(m, receivers, n, edge_mask)
        if graph_group is not None:  # combine the edge shards' partials
            if self.aggregation == "max":
                agg = P.pmax(agg, graph_group)
            else:
                agg = P.psum(agg, graph_group)
            if self.aggregation == "mean":
                cnt = P.psum(S.segment_count(receivers, n, edge_mask), graph_group)
                agg = agg / torch.clamp(cnt[..., None], min=1.0)
        parts = [x, agg] if extra_features is None else [x, extra_features, agg]
        upd = self.upd_mlp(torch.cat(parts, dim=-1), node_mask)
        return identity + upd


class GraphConvolution(nn.Module):
    """Stack of residual conv blocks (gnn_blocks.py:116-164)."""

    def __init__(self, in_dim: int, edge_dim: int,
                 stem_channels: Sequence[int], msg_mlp_hidden_dim: int,
                 aggregation: str, activation: str, norm_layer: str,
                 num_groups=None, mp_impl: Optional[str] = None,
                 csr_tiling=(512, 256, 0), extra_dim: int = 0):
        super().__init__()
        self.fused = uses_fused_kernel(norm_layer, activation, aggregation)
        self.mp_impl = mp_impl
        self.csr_tiling = tuple(csr_tiling)  # (edge_tile, window, src_window)
        blocks = []
        for ch in stem_channels:
            blocks.append(ResidualGraphConvBlock(
                in_dim, edge_dim, msg_mlp_hidden_dim, ch, aggregation,
                activation, norm_layer, num_groups, extra_dim,
            ))
            in_dim = ch
        self.blocks = nn.ModuleList(blocks)

    def forward(self, x, edge_feat, senders, receivers, node_mask, edge_mask,
                mp_impl=None, mp_bf16=False, extra_features=None,
                graph_group=None):
        """``mp_impl`` overrides the one given at construction.  On "csr",
        ``edge_feat`` must encode the reversed edges' raw features.
        ``mp_bf16``: the fused rounds' bf16 operands (each block raises
        ``ValueError`` unless its round is fused, where the JAX fast path
        asserts).  ``extra_features`` [N, extra_dim] enter every block's
        update MLP after the aggregate; the message rounds do not see them.
        ``graph_group``: the edges are this rank's shard along E (the index
        preparation and the CSR guard then run on the shard: a contiguous
        slice of destination-sorted edges stays sorted)."""
        mp_impl = mp_impl or self.mp_impl
        if mp_impl == "csr" and not self.fused:
            raise ValueError("mp_impl='csr' needs channel normalisation, "
                             "leaky ReLU and sum aggregation")
        n = x.shape[-2]
        if self.fused:
            # The kernel takes no masks: masked edges get the sentinel N at
            # both ends and zero features (JAX fast_path.py:115-118, 156).
            sentinel = torch.full_like(senders, n)
            senders = torch.where(edge_mask, senders, sentinel).int()
            receivers = torch.where(edge_mask, receivers, sentinel).int()
            edge_feat = torch.where(edge_mask[..., None], edge_feat,
                                    torch.zeros_like(edge_feat))
        layout = fused = None
        if mp_impl == "csr":
            # Per graph: a violation poisons that graph's edges only.
            guard = self._csr_guard(senders, receivers, n)
            edge_feat = edge_feat + guard[..., None, None]
            layout = C.csr_layout(receivers, senders, n, *self.csr_tiling)
        elif self.fused and FM.needs_layout(x):
            # The fused kernels' fixed-order sums walk the edges by receiver
            # and by sender: sorted once per graph (per batch: all graphs
            # in one sort).
            fused = FM.fused_layout(senders, receivers, n)
        for blk in self.blocks:
            x = blk(x, edge_feat, senders, receivers, node_mask, edge_mask,
                    layout, mp_bf16, fused, extra_features, graph_group)
        return x

    def _csr_guard(self, senders, receivers, n):
        """NaN (0-d, on the device, no host sync; [B], one a graph, for a
        batch) if an edge falls outside its tile's destination or source
        window — the CSR round would drop it — else 0.  Added to the encoded
        edges, it makes the loss NaN and the train step's NaN skip fire
        instead of training on wrong sums (fast_path.py:137-147; under the
        JAX package's vmap, one graph's violation poisons the batch's loss).
        The port's kernels also need sorted destinations: out of order ones
        count too."""
        edge_tile, window, src_window = self.csr_tiling
        n_viol = (C.window_span_violations(senders, n, edge_tile, window)
                  + C.order_violations(senders, n))
        if src_window:
            n_viol = n_viol + C.src_window_violations(receivers, n, edge_tile,
                                                      src_window)
        return torch.where(n_viol > 0, float("nan"), 0.0)


class TaskSpecificHead(nn.Module):
    """FFN block + specially-initialised output layer (gnn_blocks.py:167-197)."""

    def __init__(self, in_features: int, out_channels: int, activation: str,
                 norm_layer: str, num_groups=None, init_bias: float = 0.0):
        super().__init__()
        self.ffn = FFNBlock(in_features, in_features, activation, norm_layer,
                            num_groups)
        self.out = HeadLinear(in_features, out_channels, init_bias)

    def forward(self, x, mask=None):
        return self.out(self.ffn(x, mask))


class NodeSegmentation(nn.Module):
    """Per-node class logits (gnn_blocks.py:200-234)."""

    def __init__(self, in_features, stem_channels, num_classes, activation,
                 norm_layer, num_groups=None):
        super().__init__()
        self.stem = MLPStack(in_features, stem_channels, activation,
                             norm_layer, num_groups)
        self.head = TaskSpecificHead(stem_channels[-1], num_classes,
                                     activation, norm_layer, num_groups,
                                     init_bias=CLS_BIAS)

    def forward(self, x, mask=None):
        return self.head(self.stem(x, mask), mask)


class NodeOffsetPredictions(nn.Module):
    """Per-node (dx, dy) regression (gnn_blocks.py:237-271)."""

    def __init__(self, in_features, stem_channels, reg_offset_dim, activation,
                 norm_layer, num_groups=None):
        super().__init__()
        self.stem = MLPStack(in_features, stem_channels, activation,
                             norm_layer, num_groups)
        self.head = TaskSpecificHead(stem_channels[-1], reg_offset_dim,
                                     activation, norm_layer, num_groups,
                                     init_bias=0.0)

    def forward(self, x, mask=None):
        return self.head(self.stem(x, mask), mask)


class LinkPredictions(nn.Module):
    """Undirected-edge class logits (gnn_blocks.py:274-344) over the
    canonical row-major triu edge list."""

    def __init__(self, in_features, num_blks_for_edges, stem_channels,
                 num_classes, activation, norm_layer, num_groups=None):
        super().__init__()
        self.edge_formation = nn.ModuleList([
            FFNBlock(in_features, in_features, activation, norm_layer,
                     num_groups)
            for _ in range(num_blks_for_edges)
        ])
        self.stem = MLPStack(in_features, stem_channels, activation,
                             norm_layer, num_groups)
        self.head = TaskSpecificHead(stem_channels[-1], num_classes,
                                     activation, norm_layer, num_groups,
                                     init_bias=CLS_BIAS)

    def forward(self, x, und_senders, und_receivers, node_mask, und_mask):
        for blk in self.edge_formation:
            x = blk(x, node_mask)
        e = S.gather_nodes(x, und_senders) + S.gather_nodes(x, und_receivers)
        return self.head(self.stem(e, und_mask), und_mask)


class ObjectClassification(nn.Module):
    """Per-cluster logits via masked segment-max pooling
    (gnn_blocks.py:347-389)."""

    def __init__(self, in_features, stem_channels, num_classes, activation,
                 norm_layer, num_groups=None):
        super().__init__()
        self.stem = MLPStack(in_features, stem_channels, activation,
                             norm_layer, num_groups)
        self.head = TaskSpecificHead(stem_channels[-1], num_classes,
                                     activation, norm_layer, num_groups,
                                     init_bias=CLS_BIAS)

    def forward(self, x, node2cluster, num_clusters, node_mask, cluster_mask):
        x = self.stem(x, node_mask)
        pooled = S.masked_segment_max(x, node2cluster, num_clusters, node_mask)
        return self.head(pooled, cluster_mask)


class NodePredictions(nn.Module):
    """Fused cls+reg node head of Model_Inference_v1 (gnn_blocks.py:392-439)."""

    def __init__(self, in_features, stem_channels, num_classes,
                 reg_offset_dim, activation, norm_layer, num_groups=None):
        super().__init__()
        self.stem = MLPStack(in_features, stem_channels, activation,
                             norm_layer, num_groups)
        self.head_cls = TaskSpecificHead(stem_channels[-1], num_classes,
                                         activation, norm_layer, num_groups,
                                         init_bias=CLS_BIAS)
        self.head_reg = TaskSpecificHead(stem_channels[-1], reg_offset_dim,
                                         activation, norm_layer, num_groups,
                                         init_bias=0.0)

    def forward(self, x, mask=None):
        x = self.stem(x, mask)
        return self.head_cls(x, mask), self.head_reg(x, mask)
