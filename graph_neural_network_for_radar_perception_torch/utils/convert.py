"""Weights trained by the JAX package → the port's ``state_dict``, and back.

``state_dict_from_flax`` takes the parameter tree of a JAX ``RadarGNN``,
``RadarGNNv1`` or ``RadarGNNv2`` as nested dicts of numpy arrays (e.g.
``jax.tree.map(np.asarray, params)``, or ``utils/checkpoint.
load_params_msgpack`` of a saved file) and returns the ``state_dict`` of
the same port model; ``classifier_state_dict_from_flax`` and
``cnn_state_dict_from_flax`` do the same for ``ObjectClassifierGNN`` and
``GridDetector``.  Flax ``Dense``
kernels are [in, out] and are transposed to torch's [out, in]; the scalar
norm parameters keep their shape (1,).  The module names map mechanically:

    FFNBlock_j            → blocks.j    (inside an MLPStack)
    Linear_0/Dense_0      → linear      (FFNBlock)
    ScalarNorm_0          → norm        (FFNBlock)
    MLPStack_0 / _1       → msg_mlp / upd_mlp  (ResidualGraphConvBlock)
    Linear_0, ScalarNorm_0 → identity, identity_norm  (its projector)
    MLPStack_0            → stem        (heads)
    TaskSpecificHead_0    → head; inside it FFNBlock_0 → ffn, Dense_0 → out

v1's fused node head ``predict_node_fused``: MLPStack_0 → stem,
TaskSpecificHead_0/_1 → head_cls/head_reg.  v2's attention blocks
(``ResidualGraphAttnBlock_b``): GATv2Conv_0 → gat (lin_l, lin_r, lin_edge,
att [1, H, C] and bias as they are), FFNBlock_j → upd_mlp.blocks.j.

Each converter has an inverse (``flax_from_state_dict``,
``classifier_flax_from_state_dict``, ``cnn_flax_from_state_dict``,
``ws_conv_flax_from_state_dict``): a state_dict (tensors or arrays) back to
the flax tree of float32 numpy arrays, with the keys, nesting and shapes of
the JAX model's parameters and every dict's keys sorted, as the tree that
the JAX package saves (``jax.device_get`` rebuilds dicts in sorted key
order) and ``load_params_msgpack`` returns.  ``utils/checkpoint.
save_params_msgpack`` writes such a tree as flax msgpack.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Mapping

import numpy as np
import torch


def _dense(out, prefix, p):
    out[prefix + "weight"] = np.asarray(p["kernel"]).T
    out[prefix + "bias"] = np.asarray(p["bias"])


def _norm(out, prefix, p):
    out[prefix + "gamma"] = np.asarray(p["gamma"]).reshape(1)
    out[prefix + "beta"] = np.asarray(p["beta"]).reshape(1)


def _ffn(out, prefix, p):
    _dense(out, prefix + "linear.", p["Linear_0"]["Dense_0"])
    if "ScalarNorm_0" in p:
        _norm(out, prefix + "norm.", p["ScalarNorm_0"])


def _stack(out, prefix, p):
    for j in range(len(p)):
        _ffn(out, f"{prefix}blocks.{j}.", p[f"FFNBlock_{j}"])


def _head(out, prefix, p):
    _ffn(out, prefix + "ffn.", p["FFNBlock_0"])
    _dense(out, prefix + "out.", p["Dense_0"])


def _stem_and_head(out, prefix, p):
    _stack(out, prefix + "stem.", p["MLPStack_0"])
    _head(out, prefix + "head.", p["TaskSpecificHead_0"])


def _projector(out, prefix, p):
    """A residual block's identity projector, where it has one."""
    if "Linear_0" in p:
        _dense(out, prefix + "identity.", p["Linear_0"]["Dense_0"])
        _norm(out, prefix + "identity_norm.", p["ScalarNorm_0"])


def _conv_block(out, prefix, p):
    _projector(out, prefix, p)
    _stack(out, prefix + "msg_mlp.", p["MLPStack_0"])
    _stack(out, prefix + "upd_mlp.", p["MLPStack_1"])


def _attn_block(out, prefix, p):
    _projector(out, prefix, p)
    g = p["GATv2Conv_0"]
    for lin in ("lin_l", "lin_r", "lin_edge"):
        _dense(out, f"{prefix}gat.{lin}.", g[lin]["Dense_0"])
    out[prefix + "gat.att"] = np.asarray(g["att"])
    out[prefix + "gat.bias"] = np.asarray(g["bias"])
    _stack(out, prefix + "upd_mlp.", {k: v for k, v in p.items()
                                      if k.startswith("FFNBlock_")})


def _tensors(out) -> "OrderedDict[str, torch.Tensor]":
    return OrderedDict(
        (k, torch.tensor(np.asarray(v, dtype=np.float32)))
        for k, v in out.items()
    )


def state_dict_from_flax(params: Mapping) -> "OrderedDict[str, torch.Tensor]":
    """JAX ``RadarGNN``/``RadarGNNv1``/``RadarGNNv2`` params (nested dicts)
    → the port model's state_dict; the family is read off the tree (an
    attention neck, a fused node head)."""
    out: "OrderedDict[str, np.ndarray]" = OrderedDict()
    _stack(out, "encode_node_feat.", params["encode_node_feat"]["MLPStack_0"])
    _stack(out, "encode_edge_feat.", params["encode_edge_feat"]["MLPStack_0"])
    neck = params["pass_messages"]
    for b in range(len(neck)):
        prefix = f"pass_messages.blocks.{b}."
        if f"ResidualGraphAttnBlock_{b}" in neck:
            _attn_block(out, prefix, neck[f"ResidualGraphAttnBlock_{b}"])
        else:
            _conv_block(out, prefix, neck[f"ResidualGraphConvBlock_{b}"])
    link = params["predict_link"]
    j = 0
    while f"FFNBlock_{j}" in link:
        _ffn(out, f"predict_link.edge_formation.{j}.", link[f"FFNBlock_{j}"])
        j += 1
    _stem_and_head(out, "predict_link.", link)
    _stem_and_head(out, "predict_class.", params["predict_class"])
    if "predict_node_fused" in params:
        fused = params["predict_node_fused"]
        _stack(out, "predict_node_fused.stem.", fused["MLPStack_0"])
        _head(out, "predict_node_fused.head_cls.", fused["TaskSpecificHead_0"])
        _head(out, "predict_node_fused.head_reg.", fused["TaskSpecificHead_1"])
    else:
        for name in ("predict_node", "predict_offset"):
            _stem_and_head(out, name + ".", params[name])
    return _tensors(out)


def classifier_state_dict_from_flax(params: Mapping) -> "OrderedDict[str, torch.Tensor]":
    """JAX ``ObjectClassifierGNN`` params → the port's state_dict:
    encode_node_feat/stem FFNBlock_j → .blocks.j, conv_i → convs.i
    (Linear_0/ScalarNorm_0 → identity/identity_norm, MLPStack_0/_1 →
    msg_mlp/upd_mlp), pred_cls (a TaskSpecificHead) → pred_cls.ffn/.out."""
    out: "OrderedDict[str, np.ndarray]" = OrderedDict()
    _stack(out, "encode_node_feat.", params["encode_node_feat"])
    i = 0
    while f"conv_{i}" in params:
        _conv_block(out, f"convs.{i}.", params[f"conv_{i}"])
        i += 1
    _stack(out, "stem.", params["stem"])
    _head(out, "pred_cls.", params["pred_cls"])
    return _tensors(out)


def _conv(out, prefix, p):
    """flax Conv (kernel HWIO) → ``models/cnn.Conv`` (weight OIHW)."""
    out[prefix + "weight"] = np.transpose(np.asarray(p["kernel"]), (3, 2, 0, 1))
    out[prefix + "bias"] = np.asarray(p["bias"])


def _conv_block2d(out, prefix, p):
    _conv(out, prefix + "conv.", p["Conv_0"])
    if "gamma" in p:
        out[prefix + "gamma"] = np.asarray(p["gamma"]).reshape(1)
        out[prefix + "beta"] = np.asarray(p["beta"]).reshape(1)


def cnn_state_dict_from_flax(params: Mapping, cfg) -> "OrderedDict[str, torch.Tensor]":
    """JAX ``GridDetector`` params → the port's state_dict (``cfg``: its
    CNNConfig, for the blocks of each stage).  Backbone_0: ConvBlock_i →
    backbone.base.i, Bottleneck_k (numbered across stages) →
    backbone.stages.s.b (Conv_0/proj_gamma/proj_beta → proj/proj_gamma/
    proj_beta, ConvBlock_j → blocks.j); Neck_0: reduce_c{i}/fuse_c{i} →
    neck.reduce.i/neck.fuse.i, fuse_image; HeadV2_0: ConvBlock_j →
    head.stem.j, Dense_0.. → head.ffn.j, then cls_in, cls, reg_in, reg.
    Kernels HWIO → OIHW, dense [in, out] → [out, in]."""
    out: "OrderedDict[str, np.ndarray]" = OrderedDict()
    bb = params["Backbone_0"]
    for i in range(len(cfg.base_stem_channels)):
        _conv_block2d(out, f"backbone.base.{i}.", bb[f"ConvBlock_{i}"])
    k = 0
    for stage, nblk in enumerate(cfg.bottleneck_number_of_blocks):
        for b in range(nblk):
            p, prefix = bb[f"Bottleneck_{k}"], f"backbone.stages.{stage}.{b}."
            if "Conv_0" in p:
                _conv(out, prefix + "proj.", p["Conv_0"])
                out[prefix + "proj_gamma"] = np.asarray(p["proj_gamma"]).reshape(1)
                out[prefix + "proj_beta"] = np.asarray(p["proj_beta"]).reshape(1)
            for j in range(3):
                _conv_block2d(out, f"{prefix}blocks.{j}.", p[f"ConvBlock_{j}"])
            k += 1
    neck = params["Neck_0"]
    i = 0
    while f"reduce_c{i}" in neck:
        _conv_block2d(out, f"neck.reduce.{i}.", neck[f"reduce_c{i}"])
        _conv_block2d(out, f"neck.fuse.{i}.", neck[f"fuse_c{i}"])
        i += 1
    _conv_block2d(out, "neck.fuse_image.", neck["fuse_image"])
    head = params["HeadV2_0"]
    j = 0
    while f"ConvBlock_{j}" in head:
        _conv_block2d(out, f"head.stem.{j}.", head[f"ConvBlock_{j}"])
        j += 1
    n_dense = sum(key.startswith("Dense_") for key in head)
    names = [f"ffn.{j}" for j in range(n_dense - 4)] + ["cls_in", "cls", "reg_in", "reg"]
    for j, name in enumerate(names):
        _dense(out, f"head.{name}.", head[f"Dense_{j}"])
    return _tensors(out)


def ws_conv_state_dict_from_flax(params: Mapping) -> "OrderedDict[str, torch.Tensor]":
    """JAX ``WSConvBlock`` params (kernel, bias, GroupNorm_0) → the port's."""
    out: "OrderedDict[str, np.ndarray]" = OrderedDict()
    _conv(out, "conv.", params)
    out["gn_scale"] = np.asarray(params["GroupNorm_0"]["scale"])
    out["gn_bias"] = np.asarray(params["GroupNorm_0"]["bias"])
    return _tensors(out)


# ------------------------------------------------------- state_dict → flax
def _array(v) -> np.ndarray:
    if isinstance(v, torch.Tensor):
        v = v.detach().cpu().numpy()
    return np.asarray(v, dtype=np.float32)


def _sorted(tree):
    """Every dict of the tree with its keys sorted, as ``jax.tree.map``
    rebuilds it."""
    if isinstance(tree, dict):
        return {k: _sorted(tree[k]) for k in sorted(tree)}
    return tree


def _dense_inv(sd, prefix):
    return {"kernel": np.ascontiguousarray(_array(sd[prefix + "weight"]).T),
            "bias": _array(sd[prefix + "bias"])}


def _norm_inv(sd, prefix):
    return {"gamma": _array(sd[prefix + "gamma"]), "beta": _array(sd[prefix + "beta"])}


def _ffn_inv(sd, prefix):
    p = {"Linear_0": {"Dense_0": _dense_inv(sd, prefix + "linear.")}}
    if prefix + "norm.gamma" in sd:
        p["ScalarNorm_0"] = _norm_inv(sd, prefix + "norm.")
    return p


def _count(sd, fmt):
    """How many j have a key starting ``fmt.format(j)``."""
    j = 0
    while any(k.startswith(fmt.format(j)) for k in sd):
        j += 1
    return j


def _stack_inv(sd, prefix):
    return {f"FFNBlock_{j}": _ffn_inv(sd, f"{prefix}blocks.{j}.")
            for j in range(_count(sd, prefix + "blocks.{}."))}


def _head_inv(sd, prefix):
    return {"FFNBlock_0": _ffn_inv(sd, prefix + "ffn."),
            "Dense_0": _dense_inv(sd, prefix + "out.")}


def _stem_and_head_inv(sd, prefix):
    return {"MLPStack_0": _stack_inv(sd, prefix + "stem."),
            "TaskSpecificHead_0": _head_inv(sd, prefix + "head.")}


def _projector_inv(sd, prefix):
    if prefix + "identity.weight" not in sd:
        return {}
    return {"Linear_0": {"Dense_0": _dense_inv(sd, prefix + "identity.")},
            "ScalarNorm_0": _norm_inv(sd, prefix + "identity_norm.")}


def _conv_block_inv(sd, prefix):
    return dict(_projector_inv(sd, prefix), MLPStack_0=_stack_inv(sd, prefix + "msg_mlp."),
                MLPStack_1=_stack_inv(sd, prefix + "upd_mlp."))


def _attn_block_inv(sd, prefix):
    g = {lin: {"Dense_0": _dense_inv(sd, f"{prefix}gat.{lin}.")}
         for lin in ("lin_l", "lin_r", "lin_edge")}
    g["att"], g["bias"] = _array(sd[prefix + "gat.att"]), _array(sd[prefix + "gat.bias"])
    return dict(_projector_inv(sd, prefix), GATv2Conv_0=g,
                **_stack_inv(sd, prefix + "upd_mlp."))


def flax_from_state_dict(sd: Mapping) -> dict:
    """The inverse of ``state_dict_from_flax``: a ``RadarGNN``/``RadarGNNv1``/
    ``RadarGNNv2`` state_dict → the JAX model's params tree (the family
    read off the keys)."""
    out = {"encode_node_feat": {"MLPStack_0": _stack_inv(sd, "encode_node_feat.")},
           "encode_edge_feat": {"MLPStack_0": _stack_inv(sd, "encode_edge_feat.")}}
    neck = {}
    for b in range(_count(sd, "pass_messages.blocks.{}.")):
        prefix = f"pass_messages.blocks.{b}."
        if prefix + "gat.att" in sd:
            neck[f"ResidualGraphAttnBlock_{b}"] = _attn_block_inv(sd, prefix)
        else:
            neck[f"ResidualGraphConvBlock_{b}"] = _conv_block_inv(sd, prefix)
    out["pass_messages"] = neck
    link = _stem_and_head_inv(sd, "predict_link.")
    for j in range(_count(sd, "predict_link.edge_formation.{}.")):
        link[f"FFNBlock_{j}"] = _ffn_inv(sd, f"predict_link.edge_formation.{j}.")
    out["predict_link"] = link
    out["predict_class"] = _stem_and_head_inv(sd, "predict_class.")
    if any(k.startswith("predict_node_fused.") for k in sd):
        out["predict_node_fused"] = {
            "MLPStack_0": _stack_inv(sd, "predict_node_fused.stem."),
            "TaskSpecificHead_0": _head_inv(sd, "predict_node_fused.head_cls."),
            "TaskSpecificHead_1": _head_inv(sd, "predict_node_fused.head_reg.")}
    else:
        for name in ("predict_node", "predict_offset"):
            out[name] = _stem_and_head_inv(sd, name + ".")
    return _sorted(out)


def classifier_flax_from_state_dict(sd: Mapping) -> dict:
    """The inverse of ``classifier_state_dict_from_flax``."""
    out = {"encode_node_feat": _stack_inv(sd, "encode_node_feat."),
           "stem": _stack_inv(sd, "stem."), "pred_cls": _head_inv(sd, "pred_cls.")}
    for i in range(_count(sd, "convs.{}.")):
        out[f"conv_{i}"] = _conv_block_inv(sd, f"convs.{i}.")
    return _sorted(out)


def _conv_inv(sd, prefix):
    """``models/cnn.Conv`` (weight OIHW) → flax Conv (kernel HWIO)."""
    return {"kernel": np.ascontiguousarray(np.transpose(_array(sd[prefix + "weight"]),
                                                        (2, 3, 1, 0))),
            "bias": _array(sd[prefix + "bias"])}


def _conv_block2d_inv(sd, prefix):
    p = {"Conv_0": _conv_inv(sd, prefix + "conv.")}
    if prefix + "gamma" in sd:
        p["gamma"], p["beta"] = _array(sd[prefix + "gamma"]), _array(sd[prefix + "beta"])
    return p


def cnn_flax_from_state_dict(sd: Mapping, cfg) -> dict:
    """The inverse of ``cnn_state_dict_from_flax`` (``cfg``: its CNNConfig)."""
    bb = {f"ConvBlock_{i}": _conv_block2d_inv(sd, f"backbone.base.{i}.")
          for i in range(len(cfg.base_stem_channels))}
    k = 0
    for stage, nblk in enumerate(cfg.bottleneck_number_of_blocks):
        for b in range(nblk):
            prefix = f"backbone.stages.{stage}.{b}."
            p = {f"ConvBlock_{j}": _conv_block2d_inv(sd, f"{prefix}blocks.{j}.")
                 for j in range(3)}
            if prefix + "proj.weight" in sd:
                p["Conv_0"] = _conv_inv(sd, prefix + "proj.")
                p["proj_gamma"] = _array(sd[prefix + "proj_gamma"])
                p["proj_beta"] = _array(sd[prefix + "proj_beta"])
            bb[f"Bottleneck_{k}"] = p
            k += 1
    neck = {"fuse_image": _conv_block2d_inv(sd, "neck.fuse_image.")}
    for i in range(_count(sd, "neck.reduce.{}.")):
        neck[f"reduce_c{i}"] = _conv_block2d_inv(sd, f"neck.reduce.{i}.")
        neck[f"fuse_c{i}"] = _conv_block2d_inv(sd, f"neck.fuse.{i}.")
    head = {f"ConvBlock_{j}": _conv_block2d_inv(sd, f"head.stem.{j}.")
            for j in range(_count(sd, "head.stem.{}."))}
    names = ([f"ffn.{j}" for j in range(_count(sd, "head.ffn.{}."))]
             + ["cls_in", "cls", "reg_in", "reg"])
    for j, name in enumerate(names):
        head[f"Dense_{j}"] = _dense_inv(sd, f"head.{name}.")
    return _sorted({"Backbone_0": bb, "Neck_0": neck, "HeadV2_0": head})


def ws_conv_flax_from_state_dict(sd: Mapping) -> dict:
    """The inverse of ``ws_conv_state_dict_from_flax``."""
    return _sorted(dict(_conv_inv(sd, "conv."), GroupNorm_0={
        "scale": _array(sd["gn_scale"]), "bias": _array(sd["gn_bias"])}))
