"""Weights trained by the JAX package → the port's ``state_dict``.

``state_dict_from_flax`` takes the JAX ``RadarGNN`` parameter tree as nested
dicts of numpy arrays (e.g. ``jax.tree.map(np.asarray, params)``) and
returns the ``state_dict`` of the port's ``RadarGNN``.  Flax ``Dense``
kernels are [in, out] and are transposed to torch's [out, in]; the scalar
norm parameters keep their shape (1,).  The module names map mechanically:

    FFNBlock_j            → blocks.j    (inside an MLPStack)
    Linear_0/Dense_0      → linear      (FFNBlock)
    ScalarNorm_0          → norm        (FFNBlock)
    MLPStack_0 / _1       → msg_mlp / upd_mlp  (ResidualGraphConvBlock)
    Linear_0, ScalarNorm_0 → identity, identity_norm  (its projector)
    MLPStack_0            → stem        (heads)
    TaskSpecificHead_0    → head; inside it FFNBlock_0 → ffn, Dense_0 → out
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


def state_dict_from_flax(params: Mapping) -> "OrderedDict[str, torch.Tensor]":
    """JAX ``RadarGNN`` params (nested dicts) → port ``RadarGNN`` state_dict."""
    out: "OrderedDict[str, np.ndarray]" = OrderedDict()
    _stack(out, "encode_node_feat.", params["encode_node_feat"]["MLPStack_0"])
    _stack(out, "encode_edge_feat.", params["encode_edge_feat"]["MLPStack_0"])
    conv = params["pass_messages"]
    for b in range(len(conv)):
        p = conv[f"ResidualGraphConvBlock_{b}"]
        prefix = f"pass_messages.blocks.{b}."
        if "Linear_0" in p:
            _dense(out, prefix + "identity.", p["Linear_0"]["Dense_0"])
            _norm(out, prefix + "identity_norm.", p["ScalarNorm_0"])
        _stack(out, prefix + "msg_mlp.", p["MLPStack_0"])
        _stack(out, prefix + "upd_mlp.", p["MLPStack_1"])
    link = params["predict_link"]
    j = 0
    while f"FFNBlock_{j}" in link:
        _ffn(out, f"predict_link.edge_formation.{j}.", link[f"FFNBlock_{j}"])
        j += 1
    _stem_and_head(out, "predict_link.", link)
    for name in ("predict_class", "predict_node", "predict_offset"):
        _stem_and_head(out, name + ".", params[name])
    return OrderedDict(
        (k, torch.tensor(np.asarray(v, dtype=np.float32)))
        for k, v in out.items()
    )
