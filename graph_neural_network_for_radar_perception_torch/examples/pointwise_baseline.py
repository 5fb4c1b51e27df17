"""Per-point semantic-segmentation baseline + prediction-JSON export.

The port of the JAX package's ``examples/pointwise_baseline.py``
(capability parity with the vendored dataset package's example,
dataset/radar_scenes/radar_scenes/examples/classification.py): build the
4-feature per-point vector [x, y, compensated vr, rcs]
(classification.py:109-122), train a point-wise MLP with Adam, and export
predictions in both viewer JSON schemas (SemSeg / InstSeg,
evaluation.py:10-56) through ``utils/export``.  A floor baseline to
compare the GNN against (no spatial context); no hand-written kernel is on
this path.

Run: python -m graph_neural_network_for_radar_perception_torch.examples.pointwise_baseline
"""

import argparse
import os
from collections import OrderedDict

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..core.graph import resolve_device
from ..data import labels as L
from ..data.synthetic import make_synthetic_frame
from ..utils.export import PredictionFileSchemas, per_point_predictions_to_json


def features_from_frame(data):
    """classification.py:109-122 — [x, y, vr, rcs] per detection."""
    return np.stack(
        [data["meas_px"], data["meas_py"], data["meas_vr"],
         data["meas_rcs"]], axis=-1,
    ).astype(np.float32)


class PointwiseMLP(nn.Module):
    """Dense layers of widths ``dims`` with ReLU between them; weights
    N(0, 1/din) and zero biases from ``generator``, as the JAX example
    draws them."""

    def __init__(self, dims, generator=None):
        super().__init__()
        self.layers = nn.ModuleList(
            nn.Linear(din, dout) for din, dout in zip(dims[:-1], dims[1:]))
        with torch.no_grad():
            for lyr in self.layers:
                din = lyr.in_features
                lyr.weight.copy_(torch.randn(lyr.weight.shape, generator=generator)
                                 / np.sqrt(din))
                lyr.bias.zero_()

    def forward(self, x):
        for i, lyr in enumerate(self.layers):
            x = lyr(x)
            if i + 1 < len(self.layers):
                x = torch.relu(x)
        return x


def mlp_state_dict(layers):
    """The JAX example's parameters (a list of {"w": [din, dout], "b":
    [dout]} arrays) as ``PointwiseMLP``'s state_dict."""
    out = OrderedDict()
    for i, lyr in enumerate(layers):
        out[f"layers.{i}.weight"] = torch.from_numpy(np.array(lyr["w"], np.float32).T.copy())
        out[f"layers.{i}.bias"] = torch.from_numpy(np.array(lyr["b"], np.float32))
    return out


def main(argv=None):
    """Returns the training losses, the validation predictions and the
    written JSON files' paths."""
    p = argparse.ArgumentParser()
    p.add_argument("--device", default="cuda")
    p.add_argument("--frames", type=int, default=64)
    p.add_argument("--iters", type=int, default=300)
    p.add_argument("--out", default=os.path.join("runs", "torch", "pointwise_baseline"))
    args = p.parse_args(argv)
    device = resolve_device(args.device)

    rng = np.random.default_rng(0)
    lut = L.old_to_new_label_id_map()

    def sample(seed_rng):
        d = make_synthetic_frame(seed_rng, num_objects=6, window_size=5)
        y = L.reassign_label_ids(d["meas_label_id"], lut)
        return features_from_frame(d), y.astype(np.int64), d

    train = [sample(rng) for _ in range(args.frames)]
    X = np.concatenate([t[0] for t in train])
    Y = np.concatenate([t[1] for t in train])
    mu, sd = X.mean(0), X.std(0) + 1e-6

    dims = [4, 64, 64, L.NUM_CLASSES_ALL]
    model = PointwiseMLP(dims, torch.Generator().manual_seed(0)).to(device)
    opt = torch.optim.Adam(model.parameters(), lr=1e-3)
    Xn = torch.from_numpy((X - mu) / sd).to(device)
    Yt = torch.from_numpy(Y).to(device)

    losses = []
    for it in range(args.iters):
        opt.zero_grad(set_to_none=True)
        loss = F.cross_entropy(model(Xn), Yt)
        loss.backward()
        opt.step()
        losses.append(loss.item())
        if (it + 1) % 100 == 0:
            print(f"iter {it + 1}: loss {losses[-1]:.4f}")

    # validation frame → predictions → both export schemas
    Xv, Yv, dv = sample(np.random.default_rng(123))
    with torch.no_grad():
        logits = model(torch.from_numpy((Xv - mu) / sd).to(device))
    pred = logits.argmax(-1).cpu().numpy()
    acc = float((pred == Yv).mean())
    print(f"val per-point accuracy: {acc:.3f} ({len(Yv)} points)")

    os.makedirs(args.out, exist_ok=True)
    uuids = [f"pt-{i:05d}" for i in range(len(pred))]
    translation = {i: name for i, name in enumerate(L.NEW_LABELS)}
    paths = [os.path.join(args.out, "predictions_semseg.json"),
             os.path.join(args.out, "predictions_instseg.json")]
    per_point_predictions_to_json(
        dict(zip(uuids, pred.tolist())), paths[0],
        translation, PredictionFileSchemas.SemSeg,
    )
    # instance ids from GT trackids (the reference example does the same
    # for its InstSeg demo: classification.py:64-107)
    _, inst = np.unique(dv["meas_trackid"], return_inverse=True)
    per_point_predictions_to_json(
        {u: [int(c), int(i)] for u, c, i in zip(uuids, pred, inst)},
        paths[1], translation, PredictionFileSchemas.InstSeg,
    )
    print(f"wrote {args.out}/predictions_{{semseg,instseg}}.json")
    return {"losses": losses, "pred": pred, "paths": paths}


if __name__ == "__main__":
    main()
