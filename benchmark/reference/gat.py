"""The plain reference of the GATv2 variant (RadarGNNv2): the radar GNN's
encoders, heads, loss and SGD of ``reference/model.py`` with a GATv2
attention neck in place of the message rounds, in plain PyTorch.

Written from the published model (github.com/UditBhaskar19/
GRAPH_NEURAL_NETWORK_FOR_RADAR_PERCEPTION: modules/neural_net/gnn/
gnn_detector.py:316-416 Model_Inference_v2, gnn_attention.py:13-123
residual_graph_attn_block and graph_attention) and from GATv2's equations
(Brody, Alon and Yahav, "How Attentive are Graph Attention Networks?",
ICLR 2022, arXiv:2105.14491), as torch_geometric's ``GATv2Conv`` computes
them with concat=True, negative_slope=0.2, add_self_loops=False,
share_weights=False and edge_dim.  Each round, over the live rows of one
graph at a time, for every directed edge j -> i (sender j, receiver i):

    s_ij   = LeakyReLU(W_l x_j + W_r x_i + W_e e_ij, 0.2)    per head h
    a_ij   = a_h . s_ij,   alpha_ij = softmax over i's incoming edges
    out_i  = sum_j alpha_ij (W_l x_j),  heads concatenated, bias added
    x_i   <- x_i + MLP([x_i, out_i])     (the residual update: three
                                          Linear + leaky ReLU 0.01 layers,
                                          hidden/2, hidden/4, the width)

Departures from the published description, each as the port has it:

- ``lin_edge`` carries a bias; torch_geometric's edge projection has none.
  It adds the same vector to every edge's s before the leaky ReLU, as
  ``lin_l``'s and ``lin_r``'s biases do, so it changes no function the
  model can express; it is kept because the port's parameter list, which
  is what is compared, has it.
- A receiver with no live incoming edge gets the aggregate 0 (then the
  bias); torch_geometric's softmax gives the same.
- The heads' output layers are drawn as every Linear is
  (``harness/weights.py``), as in ``reference/model.py``.

Every projection goes through ``Reference.linear``, so that the control
(``precision="tf32"``) rounds the attention's projections as it does every
other matmul.  The parameters are a dict from the names of ``param_specs``
(the port's names and order) to tensors; ``weight_rule`` places the two
leaves that are neither a norm's nor a Linear's: ``att`` Glorot
U(+-sqrt(6 / (H + C))) and the GATv2 ``bias`` 0, as the port initialises
them.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch
import torch.nn.functional as F

from reference import model
from reference.model import train_steps  # noqa: F401  (part of the module's interface)

GAT_SLOPE = 0.2  # GATv2's own negative slope, not the model's activation


def _linear(prefix: str, fan_in: int, width: int) -> List[Tuple[str, tuple]]:
    return [(f"{prefix}.weight", (width, fan_in)), (f"{prefix}.bias", (width,))]


def _widths(cfg: dict) -> Tuple[int, int]:
    """(heads, channels a head) of the attention."""
    heads = cfg["num_heads_gat"]
    return heads, cfg["hidden_node_channels_gat"] // heads


def param_specs(cfg: dict) -> List[Tuple[str, tuple]]:
    """(name, shape) of every parameter, in the port's order: the
    encoders, then each attention block (``att``, ``bias``, the three
    projections, the update MLP), then the heads as ``reference/model.py``
    lists them."""
    base = model.param_specs(cfg)
    x_dim = cfg["node_feat_enc_stem_channels"][-1]
    d_e = cfg["edge_feat_enc_stem_channels"][-1]
    heads, c = _widths(cfg)
    hid = cfg["hidden_node_channels_gat"]
    neck = []
    for i, out in enumerate(cfg["graph_convolution_stem_channels"]):
        if out != x_dim:
            raise ValueError("the reference keeps the rounds' width")
        p = f"pass_messages.blocks.{i}"
        neck += [(f"{p}.gat.att", (1, heads, c)), (f"{p}.gat.bias", (heads * c,))]
        for name, fan_in in (("lin_l", x_dim), ("lin_r", x_dim), ("lin_edge", d_e)):
            neck += _linear(f"{p}.gat.{name}", fan_in, heads * c)
        fan_in = x_dim + heads * c
        for j, w in enumerate((hid // 2, hid // 4, out)):
            neck += _linear(f"{p}.upd_mlp.blocks.{j}.linear", fan_in, w)
            fan_in = w
    encoders = [s for s in base if s[0].startswith("encode_")]
    heads_specs = [s for s in base if not s[0].startswith(("encode_", "pass_messages."))]
    return encoders + neck + heads_specs


def weight_rule(name: str, shape: tuple, fan_in: Dict[str, int]) -> Tuple[float, float]:
    """(bound, constant) of ``att`` (Glorot over (H, C)) and the GATv2 bias (0)."""
    del fan_in
    leaf = name.rsplit(".", 1)[1]
    if leaf == "att":
        _, heads, c = shape
        return math.sqrt(6.0 / (heads + c)), 0.0
    if leaf == "bias":
        return 0.0, 0.0
    raise KeyError(f"no rule for {name!r} {shape}")


class Reference(model.Reference):
    """The GATv2 variant's model and loss at one precision."""

    def attention(self, P, p: str, x, ef, snd, rcv):
        """One GATv2 aggregate over a graph's live rows: [n, H * C]."""
        heads, c = _widths(self.cfg)
        n, e = x.shape[0], snd.shape[0]
        src = self.linear(x, P[f"{p}.lin_l.weight"], P[f"{p}.lin_l.bias"])
        dst = self.linear(x, P[f"{p}.lin_r.weight"], P[f"{p}.lin_r.bias"])
        edge = self.linear(ef, P[f"{p}.lin_edge.weight"], P[f"{p}.lin_edge.bias"])
        x_j = src[snd].view(e, heads, c)
        s = F.leaky_relu(x_j + dst[rcv].view(e, heads, c) + edge.view(e, heads, c), GAT_SLOPE)
        score = (s * P[f"{p}.att"]).sum(-1)                                   # [e, H]
        # softmax over each receiver's incoming edges, shifted by its largest score
        top = score.new_zeros(n, heads).scatter_reduce(
            0, rcv[:, None].expand(e, heads), score, "amax", include_self=False)
        w = torch.exp(score - top[rcv])
        total = score.new_zeros(n, heads).index_add(0, rcv, w)
        alpha = w / total[rcv]
        out = x.new_zeros(n, heads * c).index_add(0, rcv, (alpha[..., None] * x_j).view(e, -1))
        return out + P[f"{p}.bias"]

    def forward(self, P: Dict[str, torch.Tensor], g: dict, lab: dict):
        """Outputs of one graph over its live rows, its clusters those of the
        labels: node logits [n, C], offsets [n, 2], link logits [u, 2],
        object logits [c, C] (``reference/model.py``'s, with the GATv2
        neck in place of the message rounds)."""
        cfg = self.cfg
        n, e = int(g["node_mask"].sum()), int(g["edge_mask"].sum())
        x = self.stem(P, "encode_node_feat.blocks", g["node_feat"][:n],
                      len(cfg["node_feat_enc_stem_channels"]), first_norm=False)
        ef = self.stem(P, "encode_edge_feat.blocks", g["edge_feat"][:e],
                       len(cfg["edge_feat_enc_stem_channels"]), first_norm=False)
        snd, rcv = g["senders"][:e].long(), g["receivers"][:e].long()
        for i in range(len(cfg["graph_convolution_stem_channels"])):
            p = f"pass_messages.blocks.{i}"
            agg = self.attention(P, f"{p}.gat", x, ef, snd, rcv)
            upd = torch.cat([x, agg], -1)
            for j in range(3):
                upd = self.ffn(P, f"{p}.upd_mlp.blocks.{j}", upd, norm=False)
            x = x + upd
        return self.heads(P, g, lab, x)

    def heads(self, P, g: dict, lab: dict, x):
        """The four heads over the final node embeddings (``reference/
        model.py``'s)."""
        cfg = self.cfg
        u = int(g["und_mask"].sum())
        c = int(lab["cluster_mask"].sum())
        n = x.shape[0]
        stem_n = len(cfg["node_pred_stem_channels"])
        node_cls = self.head(P, "predict_node.head",
                             self.stem(P, "predict_node.stem.blocks", x, stem_n))
        node_off = self.head(P, "predict_offset.head",
                             self.stem(P, "predict_offset.stem.blocks", x, stem_n))
        xl = self.stem(P, "predict_link.edge_formation", x, cfg["num_blocks_to_compute_edge"])
        pair = xl[g["und_senders"][:u].long()] + xl[g["und_receivers"][:u].long()]
        edge_cls = self.head(P, "predict_link.head", self.stem(
            P, "predict_link.stem.blocks", pair, len(cfg["link_pred_stem_channels"])))
        xo = self.stem(P, "predict_class.stem.blocks", x, stem_n)
        member = lab["node2cluster"][:n].long()[None, :] == torch.arange(c, device=x.device)[:, None]
        pooled = torch.where(member[..., None], xo[None], torch.full_like(xo[None], -math.inf))
        pooled = pooled.amax(1)
        pooled = torch.where(member.any(1, keepdim=True), pooled, torch.zeros_like(pooled))
        obj_cls = self.head(P, "predict_class.head", pooled)
        return node_cls, node_off, edge_cls, obj_cls
