"""Finetune the object head over DBSCAN proposals
(script_finetune_model_gnn_objcls_pred.ipynb analog): the trunk is frozen
and clustering runs inside the forward.

The port of the JAX package's ``examples/finetune_obj_classifier.py``: the
frozen trunk's deploy forward runs the fused message-pass kernel on the
card, and its backward runs for the trunk's gradient, which the step only
checks for finiteness, as JAX does (ROADMAP C6).

Run: python -m graph_neural_network_for_radar_perception_torch.examples.finetune_obj_classifier --iters 500
"""

import argparse

import torch

from ..config.config import GNNConfig
from ..core.graph import resolve_device
from ..data.pipeline import SyntheticRadarDataset
from ..models.gnn import RadarGNN
from ..train.finetune import make_finetune_step
from ..train.steps import TrainState


def main(argv=None):
    """Returns each step's metrics (floats)."""
    p = argparse.ArgumentParser()
    p.add_argument("--iters", type=int, default=500)
    p.add_argument("--batch-size", type=int, default=4)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)

    cfg = GNNConfig(
        max_nodes=384, max_clusters=192, temporal_window_size=5,
        batch_size=args.batch_size,
    )
    model = RadarGNN(cfg, generator=torch.Generator().manual_seed(0))
    model = model.to(resolve_device(args.device))
    build, _ = make_finetune_step(cfg)
    step, optimizer = build(model)
    state = TrainState(model, optimizer)

    ds = SyntheticRadarDataset(cfg, seed=7, num_objects=4)
    gen = ds.batches(cfg.batch_size)
    history = []
    for it in range(args.iters):
        state, m = step(state, next(gen))
        m = {k: float(v) for k, v in m.items()}
        history.append(m)
        if (it + 1) % max(args.iters // 10, 1) == 0:
            print(
                f"iter {it + 1}: obj loss {m['loss_obj_cls']:.4f} "
                f"acc {m['object_accuracy']:.3f}"
            )
    return history


if __name__ == "__main__":
    main()
