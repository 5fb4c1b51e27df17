"""The plain reference: the radar GNN's forward, its multi-task loss and
SGD with momentum, in plain PyTorch.

Written from the published model (github.com/UditBhaskar19/
GRAPH_NEURAL_NETWORK_FOR_RADAR_PERCEPTION: modules/neural_net/common.py,
gnn/gnn_blocks.py, gnn/gnn_detector.py, gnn/loss.py, lossfunc.py and
set_param_for_training_gnn.py), one graph at a time over the live rows of
a padded slot, with no kernels, layouts or batching of its own.  The
parameters are a dict from the names in ``param_specs`` to tensors.

``precision`` is "f32" (matmuls in float32, TF32 off) or "tf32", the
control: on a CUDA device TF32 matmuls, on the CPU every matmul operand
rounded to TF32's 10-bit mantissa first.
"""

from __future__ import annotations

import math
from typing import Dict, List, Sequence, Tuple

import torch
import torch.nn.functional as F

EPS = 1e-5          # common.py: eps added to the std
SLOPE = 0.01        # leaky ReLU
FOCAL_ALPHA, FOCAL_GAMMA = 0.25, 2.0
LOSS_TERMS = ("loss_edge_cls", "loss_node_cls", "loss_node_reg", "loss_obj_cls")


def _ffn(prefix: str, fan_in: int, width: int, norm: bool = True):
    specs = [(f"{prefix}.linear.weight", (width, fan_in)), (f"{prefix}.linear.bias", (width,))]
    if norm:
        specs += [(f"{prefix}.norm.gamma", (1,)), (f"{prefix}.norm.beta", (1,))]
    return specs


def _stem(prefix: str, fan_in: int, widths: Sequence[int], first_norm: bool = True):
    specs = []
    for i, w in enumerate(widths):
        specs += _ffn(f"{prefix}.{i}", fan_in, w, norm=i > 0 or first_norm)
        fan_in = w
    return specs


def _head(prefix: str, width: int, out: int):
    return (_ffn(f"{prefix}.ffn", width, width)
            + [(f"{prefix}.out.weight", (out, width)), (f"{prefix}.out.bias", (out,))])


def param_specs(cfg: dict) -> List[Tuple[str, tuple]]:
    """(name, shape) of every parameter, in a fixed order."""
    d_n = cfg["node_feat_enc_stem_channels"]
    d_e = cfg["edge_feat_enc_stem_channels"]
    h = cfg["msg_mlp_hidden_dim"]
    specs = _stem("encode_node_feat.blocks", 6, d_n, first_norm=False)
    specs += _stem("encode_edge_feat.blocks", 7, d_e, first_norm=False)
    x_dim = d_n[-1]
    for i, out in enumerate(cfg["graph_convolution_stem_channels"]):
        if out != x_dim:
            raise ValueError("the reference keeps the rounds' width")
        p = f"pass_messages.blocks.{i}"
        specs += _stem(f"{p}.msg_mlp.blocks", 2 * x_dim + d_e[-1], [h, out])
        specs += _stem(f"{p}.upd_mlp.blocks", x_dim + out, [out])
    emb = cfg["graph_convolution_stem_channels"][-1]
    stem = cfg["node_pred_stem_channels"]
    n_cls = len(cfg["class_weights_dyn"])
    specs += _stem("predict_link.edge_formation", emb, [emb] * cfg["num_blocks_to_compute_edge"])
    specs += _stem("predict_link.stem.blocks", emb, cfg["link_pred_stem_channels"])
    specs += _head("predict_link.head", cfg["link_pred_stem_channels"][-1], 2)
    specs += _stem("predict_class.stem.blocks", emb, stem)
    specs += _head("predict_class.head", stem[-1], n_cls)
    specs += _stem("predict_node.stem.blocks", emb, stem)
    specs += _head("predict_node.head", stem[-1], n_cls)
    specs += _stem("predict_offset.stem.blocks", emb, stem)
    specs += _head("predict_offset.head", stem[-1], 2)
    return specs


def _tf32(t: torch.Tensor) -> torch.Tensor:
    """t with its mantissa rounded to TF32's 10 bits (nearest, ties to even);
    the gradient passes through unchanged."""
    bits = t.detach().contiguous().view(torch.int32)
    bits = (bits + 0xFFF + ((bits >> 13) & 1)) & ~0x1FFF
    return t + (bits.view(torch.float32) - t).detach()


class Reference:
    """The model and loss of one configuration at one precision."""

    def __init__(self, cfg: dict, precision: str = "f32"):
        if precision not in ("f32", "tf32"):
            raise ValueError(precision)
        self.cfg = cfg
        self.precision = precision

    def linear(self, x, w, b):
        if self.precision == "tf32" and x.device.type == "cpu":
            x, w = _tf32(x), _tf32(w)
        return x @ w.t() + b

    def norm(self, x, gamma, beta):
        mean = x.mean(-1, keepdim=True)
        var = ((x - mean) ** 2).sum(-1, keepdim=True) / max(x.shape[-1] - 1, 1)
        return gamma * ((x - mean) / (torch.sqrt(var) + EPS)) + beta

    def ffn(self, P, p, x, norm=True):
        x = self.linear(x, P[f"{p}.linear.weight"], P[f"{p}.linear.bias"])
        if norm:
            x = self.norm(x, P[f"{p}.norm.gamma"], P[f"{p}.norm.beta"])
        return F.leaky_relu(x, SLOPE)

    def stem(self, P, prefix, x, n, first_norm=True):
        for i in range(n):
            x = self.ffn(P, f"{prefix}.{i}", x, norm=i > 0 or first_norm)
        return x

    def head(self, P, prefix, x):
        x = self.ffn(P, f"{prefix}.ffn", x)
        return self.linear(x, P[f"{prefix}.out.weight"], P[f"{prefix}.out.bias"])

    def forward(self, P: Dict[str, torch.Tensor], g: dict, lab: dict):
        """Outputs of one graph over its live rows, its clusters those of the
        labels (the training forward): node logits [n, C], offsets [n, 2],
        link logits [u, 2], object logits [c, C]."""
        cfg = self.cfg
        n, e, u = (int(g[k].sum()) for k in ("node_mask", "edge_mask", "und_mask"))
        c = int(lab["cluster_mask"].sum())
        x = self.stem(P, "encode_node_feat.blocks", g["node_feat"][:n],
                      len(cfg["node_feat_enc_stem_channels"]), first_norm=False)
        ef = self.stem(P, "encode_edge_feat.blocks", g["edge_feat"][:e],
                       len(cfg["edge_feat_enc_stem_channels"]), first_norm=False)
        snd, rcv = g["senders"][:e].long(), g["receivers"][:e].long()
        for i in range(len(cfg["graph_convolution_stem_channels"])):
            p = f"pass_messages.blocks.{i}"
            m = self.stem(P, f"{p}.msg_mlp.blocks", torch.cat([x[rcv], x[snd], ef], -1), 2)
            agg = torch.zeros(n, m.shape[-1], dtype=m.dtype, device=m.device).index_add(0, rcv, m)
            x = x + self.stem(P, f"{p}.upd_mlp.blocks", torch.cat([x, agg], -1), 1)
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

    def loss_sums(self, P, g: dict, lab: dict) -> Dict[str, torch.Tensor]:
        """One graph's loss sums and counts (gnn/loss.py, lossfunc.py)."""
        node_cls, node_off, edge_cls, obj_cls = self.forward(P, g, lab)
        n, u, c = node_cls.shape[0], edge_cls.shape[0], obj_cls.shape[0]
        t_edge = F.one_hot(lab["edge_class"][:u].long(), 2).float()
        p = torch.sigmoid(edge_cls)
        ce = F.binary_cross_entropy_with_logits(edge_cls, t_edge, reduction="none")
        p_t = p * t_edge + (1 - p) * (1 - t_edge)
        focal = ((FOCAL_ALPHA * t_edge + (1 - FOCAL_ALPHA) * (1 - t_edge))
                 * ce * (1 - p_t) ** FOCAL_GAMMA)
        w = torch.tensor(self.cfg["class_weights_dyn"], dtype=torch.float32,
                         device=node_cls.device)
        node_t = lab["node_class"][:n].long()
        node_ce = F.cross_entropy(node_cls, node_t, reduction="none") * w[node_t]
        sigma = torch.tensor(self.cfg["reg_sigma"], device=node_off.device)
        mu = torch.tensor(self.cfg["reg_mu"], device=node_off.device)
        reg = 0.5 * ((node_off - (lab["node_offsets"][:n] - mu) / sigma) ** 2).sum(-1)
        obj_ce = F.cross_entropy(obj_cls, lab["cluster_class"][:c].long(), reduction="none")
        one = torch.ones((), device=node_cls.device)
        return {"edge": (focal.sum(), u * one), "node": (node_ce.sum(), n * one),
                "reg": (reg.sum(), n * one), "obj": (obj_ce.sum(), c * one)}

    def batch_loss(self, P, batch: dict, graphs=None):
        """(total, the four weighted terms and the total as a dict) over a
        batch's graphs (``graphs``: their indices, default all): each
        term's sums and counts added over the graphs, then divided."""
        B = batch["graph"]["node_mask"].shape[0]
        acc = {}
        for b in (range(B) if graphs is None else graphs):
            g = {k: v[b] for k, v in batch["graph"].items()}
            lab = {k: v[b] for k, v in batch["labels"].items()}
            for k, (s, cnt) in self.loss_sums(P, g, lab).items():
                s0, c0 = acc.get(k, (0.0, 0.0))
                acc[k] = (s0 + s, c0 + cnt)
        cfg = self.cfg
        weights = {"edge": cfg["edge_cls_loss_weight"], "node": cfg["node_cls_loss_weight"],
                   "reg": cfg["node_reg_loss_weight"], "obj": cfg["obj_cls_loss_weight"]}
        terms = {name: acc[k][0] / torch.clamp(acc[k][1], min=1.0) * weights[k]
                 for name, k in zip(LOSS_TERMS, weights)}
        total = sum(terms.values())
        terms["loss_total"] = total
        return total, terms


def train_steps(ref: Reference, params: Dict[str, torch.Tensor], batches: Sequence[dict],
                graphs=None):
    """SGD with momentum and coupled weight decay (optax chain of
    add_decayed_weights and sgd; the learning rate's first milestone is far
    beyond these steps) over ``batches``, from ``params``; a batch with a
    non-finite loss or gradient changes nothing.  Returns (each step's
    loss terms as floats, the first step's gradient by name, the
    parameters after the last step by name)."""
    cfg = ref.cfg
    lr, wd, mom = cfg["learning_rate"], cfg["weight_decay"], cfg["momentum"]
    names = list(params)
    P = {k: v.detach().clone().requires_grad_(True) for k, v in params.items()}
    buf = {k: torch.zeros_like(v) for k, v in P.items()}
    losses, first_grad = [], None
    for batch in batches:
        total, terms = ref.batch_loss(P, batch, graphs)
        grads = torch.autograd.grad(total, [P[k] for k in names])
        losses.append({k: float(v.detach()) for k, v in terms.items()})
        if first_grad is None:
            first_grad = {k: gr.detach().clone() for k, gr in zip(names, grads)}
        ok = bool(torch.isfinite(total)) and all(bool(torch.isfinite(gr).all()) for gr in grads)
        if not ok:
            continue
        with torch.no_grad():
            for k, gr in zip(names, grads):
                buf[k] = gr + wd * P[k] + mom * buf[k]
                P[k] -= lr * buf[k]
    return losses, first_grad, {k: v.detach() for k, v in P.items()}
