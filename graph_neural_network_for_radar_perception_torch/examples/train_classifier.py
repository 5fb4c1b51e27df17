"""Train the stage-2 object classifier over proposals
(script_train_model_classifier.ipynb analog).

The port of the JAX package's ``examples/train_classifier.py``.  With
--use-detector-proposals the proposals come from a (random-init) stage-1
``FrameDetector``, whose deploy forward runs the fused message-pass kernel
on the card; the classifier itself is plain PyTorch.

Run: python -m graph_neural_network_for_radar_perception_torch.examples.train_classifier --iters 1000
"""

import argparse

import torch

from ..config.config import GNNConfig
from ..data.pipeline import SyntheticRadarDataset
from ..infer.pipeline import FrameDetector
from ..models import classifier as CL
from ..models.gnn import RadarGNN


def main(argv=None):
    """Returns each step's metrics (floats)."""
    p = argparse.ArgumentParser()
    p.add_argument("--iters", type=int, default=1000)
    p.add_argument("--batch-size", type=int, default=4)
    p.add_argument("--use-detector-proposals", action="store_true",
                   help="cluster with a (random-init) stage-1 detector "
                        "instead of GT clusters")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)

    cfg = GNNConfig(max_nodes=384, max_clusters=192, temporal_window_size=5)
    ccfg = CL.ClassifierConfig()
    ds = SyntheticRadarDataset(cfg, seed=0, num_objects=4)

    detector = None
    if args.use_detector_proposals:
        weights = RadarGNN(cfg, generator=torch.Generator().manual_seed(0)).state_dict()
        detector = FrameDetector(cfg, weights, eps=ccfg.clustering_eps,
                                 device=args.device)

    def sample():
        while True:
            fr = ds.sample_frame()
            if detector is not None:
                d = detector.detect_frame_arrays(fr)
                n = d.xy.shape[0]
                s = CL.build_classifier_sample(
                    d.xy, fr.node_feat[:n, 1], fr.node_class[:n],
                    d.node2cluster, d.num_clusters, ccfg,
                )
            else:
                s = CL.build_classifier_sample(
                    fr.other_feat[:, :2], fr.node_feat[:, 1],
                    fr.node_class, fr.node2cluster,
                    int(fr.cluster_class.shape[0]), ccfg,
                )
            if s is not None:
                return s

    def batch():
        return CL.stack_samples([sample() for _ in range(args.batch_size)])

    init, step, _ = CL.make_classifier_train_step(ccfg)
    # The JAX example initialises from one sample, which is drawn here too,
    # so that both take the same frames.
    sample()
    state = init(torch.Generator().manual_seed(0), device=args.device)
    history = []
    for it in range(args.iters):
        state, m = step(state, batch())
        m = {k: float(v) for k, v in m.items()}
        history.append(m)
        if (it + 1) % max(args.iters // 10, 1) == 0:
            print(
                f"iter {it + 1}: loss {m['loss_obj_cls']:.4f} "
                f"acc {m['object_accuracy']:.3f}"
            )
    return history


if __name__ == "__main__":
    main()
