"""GATv2 attention neck and the v2 model variant.

The JAX package's ``models/gat.py``: the reference's dormant attention
branch (modules/neural_net/gnn/gnn_attention.py:13-123, "NOTE: not used"
but kept as a selectable capability; gnn_detector.py:316-416
Model_Inference_v2), written with gathers and a segment softmax
(``ops/segment.py``) in place of torch_geometric's kernels.  The JAX
package reaches no Pallas kernel here.  The port's conv takes the plain
PyTorch path (``GATv2Conv._attend``) on the CPU, and on the card the
kernel pair of ``ops/gat_mp.py`` (``csrc/gat_mp.cu``), which computes the
same attention and aggregate without writing an [E, H·C] intermediate; its
edges are sorted once a step (``gat_layout``) for all the rounds.

GATv2 semantics (torch_geometric GATv2Conv with concat=True,
negative_slope=0.2, add_self_loops=False, share_weights=False, edge_dim):
  s = LeakyReLU(W_l·x_src + W_r·x_dst + W_e·e, 0.2)
  α = softmax_over_incoming(a · s);  out_dst = Σ α · (W_l·x_src)
heads concatenated, bias added.  The slope 0.2 is GATv2's own, not the
model's activation.

Tracing (``utils/profiling.TRACER``; nothing while it is off): each
``GATv2Conv`` forward captured while the tracer is on is the device span
``gat.forward`` (projections, gathers, logits, segment softmax and
aggregation), and its backward the device span ``gat.backward``, from
the gradient's arrival at the conv's output to its departure through the
conv's inputs: two pass-through autograd nodes (``_OpenBackward`` at the
output, ``_CloseBackward`` over ``x`` and ``edge_feat``), inserted only
then.  Counters: ``gat.rounds``, the conv forwards run while the tracer
is on, and ``gat.alloc_bytes``, the bytes the caching allocator handed
out during them on a card (``allocated_bytes.all.allocated`` of
``torch.cuda.memory_stats`` across each forward), and ``gat.fused_rounds``,
those of them that took the kernel pair.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..ops import gat_mp as GM
from ..ops.fused_mp import needs_layout
from ..ops import segment as S
from ..utils.profiling import TRACER
from .blocks import Linear, MLPStack, ScalarNorm
from .gnn import RadarGNN

GAT_SLOPE = 0.2  # torch_geometric GATv2Conv's negative_slope


class _BackwardSpan:
    """The open ``gat.backward`` span of one conv's backward, if any."""

    def __init__(self):
        self.mark = None


class _OpenBackward(torch.autograd.Function):
    """The conv's output, passed through; its backward, the first of the
    conv's, opens the conv's ``gat.backward`` span."""

    @staticmethod
    def forward(ctx, out, span):
        ctx.span = span
        return out

    @staticmethod
    def backward(ctx, g_out):
        ctx.span.mark = TRACER.graph_span("gat.backward")
        ctx.span.mark.__enter__()
        return g_out, None


class _CloseBackward(torch.autograd.Function):
    """The conv's inputs, passed through; their backward, the last of the
    conv's, closes its ``gat.backward`` span."""

    @staticmethod
    def forward(ctx, x, edge_feat, span):
        ctx.span = span
        return x, edge_feat

    @staticmethod
    def backward(ctx, g_x, g_edge):
        if ctx.span.mark is not None:
            ctx.span.mark.__exit__(None, None, None)
            ctx.span.mark = None
        return g_x, g_edge, None


def _allocated(device: torch.device) -> int:
    """The bytes the caching allocator has handed out on ``device`` so far
    (0 off a card)."""
    if device.type != "cuda":
        return 0
    return torch.cuda.memory_stats(device)["allocated_bytes.all.allocated"]


class GATv2Conv(nn.Module):
    """Multi-head GATv2 edge-conditioned attention convolution: out width
    ``num_heads * out_channels``."""

    owns_parameters = True  # att and bias (init_parameters)

    def __init__(self, in_dim: int, edge_dim: int, out_channels: int,
                 num_heads: int):
        super().__init__()
        h, c = num_heads, out_channels
        self.num_heads, self.out_channels = h, c
        self.lin_l = Linear(in_dim, h * c)     # source
        self.lin_r = Linear(in_dim, h * c)     # target
        self.lin_edge = Linear(edge_dim, h * c)
        self.att = nn.Parameter(torch.empty(1, h, c))
        self.bias = nn.Parameter(torch.empty(h * c))

    def reset_parameters(self, generator: Optional[torch.Generator]):
        """att: Glorot uniform over (fan_in, fan_out) = (H, C), as flax's
        ``glorot_uniform`` takes a (1, H, C) shape; bias: 0."""
        bound = math.sqrt(6.0 / (self.num_heads + self.out_channels))
        with torch.no_grad():
            self.att.uniform_(-bound, bound, generator=generator)
            self.bias.zero_()

    def forward(self, x, edge_feat, senders, receivers, node_mask, edge_mask,
                layout=None):
        """``layout``: the edges' ``ops.gat_mp.gat_layout``, made once for
        the graph's rounds, or None to make it here (on the card; the plain
        path takes none)."""
        if not TRACER.enabled:
            return self._attention(x, edge_feat, senders, receivers, edge_mask, layout)
        TRACER.count("gat.rounds")
        if needs_layout(x):
            TRACER.count("gat.fused_rounds")
        before = _allocated(x.device)
        span = None
        if (TRACER.graph_marking and torch.is_grad_enabled()
                and (x.requires_grad or edge_feat.requires_grad)):
            span = _BackwardSpan()
            x, edge_feat = _CloseBackward.apply(x, edge_feat, span)
        with TRACER.graph_span("gat.forward"):
            out = self._attention(x, edge_feat, senders, receivers, edge_mask, layout)
        if span is not None:
            out = _OpenBackward.apply(out, span)
        TRACER.count("gat.alloc_bytes", _allocated(x.device) - before)
        return out

    def _attention(self, x, edge_feat, senders, receivers, edge_mask, layout=None):
        """The round: the plain path (``_attend``) on the CPU, the kernel
        pair wherever the rounds run kernels (``fused_mp.needs_layout``;
        ``gat_round`` has them for the card)."""
        if not needs_layout(x):
            return self._attend(x, edge_feat, senders, receivers, edge_mask)
        if layout is None:
            layout = GM.gat_layout(senders, receivers, edge_mask, x.shape[-2])
        return GM.gat_round(self.lin_l(x), self.lin_r(x), edge_feat,
                            self.lin_edge.weight, self.lin_edge.bias, self.att,
                            self.bias, layout, GAT_SLOPE)

    def _attend(self, x, edge_feat, senders, receivers, edge_mask):
        """The attention and the aggregate (the node mask plays no part:
        the attention is over edges, and masked edges weigh 0)."""
        h, c = self.num_heads, self.out_channels
        n, lead = x.shape[-2], tuple(x.shape[:-2])  # lead: a batch's graph axis
        xs = S.gather_nodes(self.lin_l(x), senders).reshape(lead + (-1, h, c))
        xr = S.gather_nodes(self.lin_r(x), receivers).reshape(lead + (-1, h, c))
        e = self.lin_edge(edge_feat).reshape(lead + (-1, h, c))
        s = F.leaky_relu(xs + xr + e, GAT_SLOPE)            # [E, H, C]
        logits = (s * self.att).sum(-1)                       # [E, H]
        # normalised over each receiver's incoming edges, per head
        alpha = S.segment_softmax(logits, receivers, n, edge_mask)
        msg = xs * alpha[..., None]
        out = S.masked_segment_sum(msg.reshape(lead + (-1, h * c)), receivers, n,
                                   edge_mask)
        return out + self.bias


class ResidualGraphAttnBlock(nn.Module):
    """gnn_attention.py:13-76: GATv2 aggregation + residual update MLP (the
    update FFN blocks carry no norm; the projector uses layer
    normalisation)."""

    def __init__(self, in_dim: int, edge_dim: int, hidden_node_channels: int,
                 num_heads: int, mlp_stem_channels_upd: Sequence[int],
                 activation: str, extra_dim: int = 0):
        super().__init__()
        out_dim = mlp_stem_channels_upd[-1]
        if in_dim != out_dim:
            self.identity = Linear(in_dim, out_dim)
            self.identity_norm = ScalarNorm("layer_normalization")
        else:
            self.identity = None
        self.gat = GATv2Conv(in_dim, edge_dim,
                             hidden_node_channels // num_heads, num_heads)
        agg_dim = num_heads * (hidden_node_channels // num_heads)
        self.upd_mlp = MLPStack(in_dim + extra_dim + agg_dim,
                                mlp_stem_channels_upd, activation, None)

    def forward(self, x, edge_feat, senders, receivers, node_mask, edge_mask,
                extra_features=None, layout=None):
        if self.identity is not None:
            identity = self.identity_norm(self.identity(x), node_mask)
        else:
            identity = x
        agg = self.gat(x, edge_feat, senders, receivers, node_mask, edge_mask,
                       layout=layout)
        parts = [x, agg] if extra_features is None else [x, extra_features, agg]
        return identity + self.upd_mlp(torch.cat(parts, dim=-1))


class GraphAttention(nn.Module):
    """gnn_attention.py:79-123: one attention block per stem channel, each
    with update widths [hidden/2, hidden/4, channel]."""

    def __init__(self, in_dim: int, edge_dim: int, stem_channels: Sequence[int],
                 hidden_node_channels: int, num_heads: int, activation: str,
                 extra_dim: int = 0):
        super().__init__()
        hid = hidden_node_channels
        blocks = []
        for ch in stem_channels:
            blocks.append(ResidualGraphAttnBlock(
                in_dim, edge_dim, hid, num_heads, [hid // 2, hid // 4, ch],
                activation, extra_dim))
            in_dim = ch
        self.blocks = nn.ModuleList(blocks)

    def forward(self, x, edge_feat, senders, receivers, node_mask, edge_mask,
                mp_impl=None, mp_bf16=False, extra_features=None,
                graph_group=None):
        """The message-passing neck's call (``RadarGNN.trunk``).  The GAT
        neck has no fused round: ``mp_impl="csr"`` and ``mp_bf16`` raise
        ``ValueError``; nor a graph axis (as in the JAX package):
        ``graph_group`` raises too."""
        if mp_impl == "csr" or mp_bf16:
            raise ValueError("the GAT neck has no fused message round: "
                             "mp_impl='csr' and mp_bf16 do not apply")
        if graph_group is not None:
            raise ValueError("the GAT neck has no graph axis")
        layout = None
        if needs_layout(x):  # the edges by receiver and by sender, once for every round
            layout = GM.gat_layout(senders, receivers, edge_mask, x.shape[-2])
        for blk in self.blocks:
            x = blk(x, edge_feat, senders, receivers, node_mask, edge_mask,
                    extra_features, layout)
        return x


class RadarGNNv2(RadarGNN):
    """Model_Inference_v2 (gnn_detector.py:316-416): the flagship's encoders
    and heads with a GATv2 neck in the same ``pass_messages`` slot, so
    ``forward`` and ``deploy`` (on-device DBSCAN proposals, a capability
    extension as in the JAX package) work here too."""

    def _make_neck(self, node_dim: int, edge_dim: int, extra_dim: int):
        cfg = self.cfg
        return GraphAttention(
            node_dim, edge_dim, cfg.graph_convolution_stem_channels,
            cfg.hidden_node_channels_gat, cfg.num_heads_gat, cfg.activation,
            extra_dim)
