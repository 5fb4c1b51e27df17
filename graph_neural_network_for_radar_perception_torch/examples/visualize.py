"""Render detection panels for a sequence of frames and assemble a GIF
(viz_results.ipynb / save_predictions_and_gt.ipynb analog).

The port of the JAX package's ``examples/visualize.py``, in two halves:
``detect`` (the deploy forward, which runs the fused message-pass kernel
on the card) and ``render`` (matplotlib panels, PIL's GIF); ``main`` runs
both.

Run: python -m graph_neural_network_for_radar_perception_torch.examples.visualize --frames 8
"""

import argparse
import os

import torch

from ..config.config import GNNConfig
from ..data.pipeline import SyntheticRadarDataset
from ..infer.pipeline import FrameDetector
from ..models.gnn import RadarGNN
from ..utils.torch_import import load_reference_checkpoint


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--frames", type=int, default=8)
    p.add_argument("--out", default=os.path.join("runs", "torch", "viz"))
    p.add_argument("--torch-ckpt", default=None)
    p.add_argument("--device", default="cuda")
    return p.parse_args(argv)


def detect(args):
    """The detections of ``args.frames`` synthetic frames (seed 42)."""
    cfg = GNNConfig(max_nodes=512, max_clusters=256, temporal_window_size=5)
    weights = RadarGNN(cfg, generator=torch.Generator().manual_seed(0)).state_dict()
    if args.torch_ckpt:
        weights = load_reference_checkpoint(weights, args.torch_ckpt)

    det = FrameDetector(cfg, weights, eps=1.4, device=args.device)
    ds = SyntheticRadarDataset(cfg, seed=42, num_objects=4)
    dets = []
    for i in range(args.frames):
        d = det.detect_frame_arrays(ds.sample_frame())
        print(f"frame {i}: {d.num_clusters} clusters")
        dets.append(d)
    return dets


def render(dets, out):
    """One all-outputs panel per detection, saved as a PNG, and the GIF of
    them all; returns the GIF's path."""
    import matplotlib

    matplotlib.use("Agg")

    from ..viz.plots import plot_all_outputs, save_frames_as_gif

    os.makedirs(out, exist_ok=True)
    figs = []
    for i, d in enumerate(dets):
        fig = plot_all_outputs(d, figsize=(12, 12))
        fig.savefig(os.path.join(out, f"frame_{i:03d}.png"), dpi=90)
        figs.append(fig)
    gif = save_frames_as_gif(figs, os.path.join(out, "frames.gif"))
    print(f"wrote {gif}")
    return gif


def main(argv=None):
    """Returns the detections and the GIF's path."""
    args = parse_args(argv)
    dets = detect(args)
    return dets, render(dets, args.out)


if __name__ == "__main__":
    main()
