"""Segmentation + detection evaluation (performance_eval_*.ipynb analog):
per-sequence confusion JSONs and aggregated precision/recall tables.

The port of the JAX package's ``examples/evaluate.py``; the deploy forward
runs the fused message-pass kernel on the card.  ``--ckpt`` reads a
directory of the port's ``CheckpointManager`` (the JAX example's is an
Orbax directory).

Run: python -m graph_neural_network_for_radar_perception_torch.examples.evaluate --ckpt runs/torch/gnn/ckpt --frames 50
"""

import argparse
import os

import torch

from ..config.config import GNNConfig
from ..data.pipeline import SyntheticRadarDataset
from ..data.synthetic import make_synthetic_frame
from ..eval import drivers as D
from ..eval.metrics import precision_recall
from ..infer.pipeline import FrameDetector
from ..models.gnn import RadarGNN
from ..train.steps import create_train_state
from ..utils.checkpoint import CheckpointManager
from ..utils.torch_import import load_reference_checkpoint


def main(argv=None):
    """Returns the segmentation and detection confusion accumulators and
    the path of the segmentation JSON."""
    p = argparse.ArgumentParser()
    p.add_argument("--ckpt", default=None,
                   help="the port's CheckpointManager directory")
    p.add_argument("--torch-ckpt", default=None,
                   help="reference graph_based_detector.pt")
    p.add_argument("--frames", type=int, default=32)
    p.add_argument("--out", default=os.path.join("runs", "torch", "eval"))
    p.add_argument("--eps", type=float, default=1.4)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)

    cfg = GNNConfig(max_nodes=512, max_clusters=256, temporal_window_size=5)
    weights = RadarGNN(cfg, generator=torch.Generator().manual_seed(0)).state_dict()
    if args.torch_ckpt:
        weights = load_reference_checkpoint(weights, args.torch_ckpt)
        print(f"loaded reference checkpoint {args.torch_ckpt}")
    elif args.ckpt:
        mgr = CheckpointManager(args.ckpt)
        state = mgr.restore(template=create_train_state(cfg, device=args.device))
        weights = state.model.state_dict()
        print(f"loaded step {mgr.latest_step()} from {args.ckpt}")

    det = FrameDetector(cfg, weights, eps=args.eps, device=args.device)
    ds = SyntheticRadarDataset(cfg, seed=1234, num_objects=4)

    # segmentation
    frames = [ds.sample_frame() for _ in range(args.frames)]
    seg = D.segmentation_confusion(det, frames)
    path = D.write_sequence_json(seg, args.out, "sequence_synthetic")
    pr = D.aggregate_sequence_jsons([path], cfg.num_classes)
    names = [cfg.object_classes_dyn[i] for i in pr["classes"]]
    print("\nSemantic segmentation (precision / recall):")
    for n, p_, r in zip(names, pr["precision"], pr["recall"]):
        print(f"  {n:18s} {p_ * 100:5.1f}% / {r * 100:5.1f}%")

    # detection
    gen = (
        make_synthetic_frame(
            ds.rng, num_objects=4, window_size=cfg.temporal_window_size
        )
        for _ in range(args.frames)
    )
    detc = D.evaluate_detection_from_data(
        det, gen, cluster_size_threshold=1, eps=0.7
    )
    prd = precision_recall(detc.cm)
    print("\nObject detection (precision / recall):")
    for n, p_, r in zip(names, prd["precision"], prd["recall"]):
        print(f"  {n:18s} {p_ * 100:5.1f}% / {r * 100:5.1f}%")
    return {"segmentation": seg, "detection": detc, "json": path}


if __name__ == "__main__":
    main()
