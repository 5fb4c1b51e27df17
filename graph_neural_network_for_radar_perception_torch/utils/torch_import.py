"""Import the reference PyTorch checkpoint into the port's ``RadarGNN``.

The JAX package's ``utils/torch_import.py`` maps the reference's state_dict
(Model_Training → pred.* keys, modules/neural_net/gnn/gnn_detector.py:
419-423) onto its flax tree; here the same reference keys map straight onto
the port's ``state_dict``, so that the shipped weights
(model_weights/gnn/1718175257362/graph_based_detector.pt) drive the port.
Both are torch layouts, so a Linear's weight keeps its [out, in] shape.

Port → reference key grammar (the JAX package's, through the port's module
names of ``utils/convert.py``):
  encode_*.blocks.j.<ffn>                       → encode_*.encoder.j.<ffn>
  pass_messages.blocks.b.msg_mlp.blocks.j.<ffn> → pass_messages.conv_blk.b.msg.j.<ffn>
  pass_messages.blocks.b.upd_mlp.blocks.j.<ffn> → pass_messages.conv_blk.b.upd.j.<ffn>
  pass_messages.blocks.b.identity.{weight,bias} → pass_messages.conv_blk.b.residual_connection.0.*
  pass_messages.blocks.b.identity_norm.<norm>   → pass_messages.conv_blk.b.residual_connection.1.<norm>
  predict_link.edge_formation.j.<ffn>           → predict_link.compute_edge.stem.j.<ffn>
  predict_*.stem.blocks.j.<ffn>                 → predict_*.stem.j.<ffn>
  predict_*.head.ffn.<ffn>                      → predict_*.{pred_cls|pred_offsets}.head.0.<ffn>
  predict_*.head.out.{weight,bias}              → predict_*.{pred_cls|pred_offsets}.head.1.*
(pred_offsets for predict_offset, pred_cls for the others).  Leaves: inside
an ffn block the Linear is ``.block.0`` and the norm ``.block.1``
(modules/neural_net/common.py:185-253): linear.weight/bias → block.0.weight/
bias; norm.gamma → block.1.std, norm.beta → block.1.mu; a bare norm's
gamma/beta → std/mu.
"""

from __future__ import annotations

import re
from collections import OrderedDict
from typing import Dict, Mapping

import numpy as np
import torch

_FFN = r"(?P<ffn>linear\.(?:weight|bias)|norm\.(?:gamma|beta))"
_FFN_LEAF = {"linear.weight": "block.0.weight", "linear.bias": "block.0.bias",
             "norm.gamma": "block.1.std", "norm.beta": "block.1.mu"}
_NORM_LEAF = {"gamma": "std", "beta": "mu"}

# (port key pattern, reference key template); an ffn pattern's template is
# completed by its leaf (_FFN_LEAF).
_RULES = [
    (r"(encode_\w+)\.blocks\.(\d+)\." + _FFN, r"\1.encoder.\2."),
    (r"pass_messages\.blocks\.(\d+)\.(msg|upd)_mlp\.blocks\.(\d+)\." + _FFN,
     r"pass_messages.conv_blk.\1.\2.\3."),
    (r"pass_messages\.blocks\.(\d+)\.identity\.(weight|bias)",
     r"pass_messages.conv_blk.\1.residual_connection.0.\2"),
    (r"pass_messages\.blocks\.(\d+)\.identity_norm\.(gamma|beta)",
     r"pass_messages.conv_blk.\1.residual_connection.1.\2"),
    (r"predict_link\.edge_formation\.(\d+)\." + _FFN, r"predict_link.compute_edge.stem.\1."),
    (r"(predict_\w+)\.stem\.blocks\.(\d+)\." + _FFN, r"\1.stem.\2."),
    (r"(predict_offset)\.head\.ffn\." + _FFN, r"\1.pred_offsets.head.0."),
    (r"(predict_\w+)\.head\.ffn\." + _FFN, r"\1.pred_cls.head.0."),
    (r"(predict_offset)\.head\.out\.(weight|bias)", r"\1.pred_offsets.head.1.\2"),
    (r"(predict_\w+)\.head\.out\.(weight|bias)", r"\1.pred_cls.head.1.\2"),
]


def reference_key(port_key: str) -> str:
    """The reference state_dict key of a port ``RadarGNN`` state_dict key."""
    for pattern, template in _RULES:
        m = re.fullmatch(pattern, port_key)
        if m is None:
            continue
        if "ffn" in m.groupdict():
            return m.expand(template) + _FFN_LEAF[m["ffn"]]
        key = m.expand(template)
        head, _, leaf = key.rpartition(".")
        return f"{head}.{_NORM_LEAF.get(leaf, leaf)}"
    raise KeyError(f"no reference key for port key {port_key!r}")


def import_torch_checkpoint(
    template: Mapping[str, torch.Tensor], state_dict: Dict[str, object]
) -> "OrderedDict[str, torch.Tensor]":
    """A port state_dict with the keys and shapes of ``template`` (e.g.
    ``RadarGNN(cfg).state_dict()``) filled from the reference state_dict
    (``pred.``-prefixed keys accepted).  Raises KeyError for a key that is
    missing and for a checkpoint key left unconsumed."""
    sd = {}
    for k, v in state_dict.items():
        sd[k[5:] if k.startswith("pred.") else k] = np.asarray(
            v.detach().cpu().numpy() if hasattr(v, "detach") else v
        )

    used = set()
    out: "OrderedDict[str, torch.Tensor]" = OrderedDict()
    for port_key, like in template.items():
        key = reference_key(port_key)
        if key not in sd:
            raise KeyError(
                f"port key {port_key!r} → reference key {key!r} not in checkpoint"
            )
        used.add(key)
        arr = sd[key]
        if arr.size != like.numel() or (arr.ndim == 2 and arr.shape != tuple(like.shape)):
            raise ValueError(f"{key}: {arr.shape} vs {tuple(like.shape)}")
        out[port_key] = torch.from_numpy(
            np.array(arr, dtype=np.float32).reshape(tuple(like.shape)))
    missing = set(sd) - used
    if missing:
        raise KeyError(f"checkpoint keys not consumed: {sorted(missing)[:8]}")
    return out


def load_reference_checkpoint(template: Mapping[str, torch.Tensor], path: str):
    """Read the reference ``.pt`` (tensors only) and import it."""
    sd = torch.load(path, map_location="cpu", weights_only=True)
    return import_torch_checkpoint(template, sd)
