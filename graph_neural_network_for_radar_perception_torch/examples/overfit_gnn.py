"""Single-frame overfit sanity harness (script_overfit_gnn.ipynb analog):
drive all four losses toward zero on one frame and report accuracies.

The port of the JAX package's ``examples/overfit_gnn.py``; each step runs
the fused message-pass kernels, forward and backward, on the card.

Run: python -m graph_neural_network_for_radar_perception_torch.examples.overfit_gnn --steps 2000
"""

import argparse

import torch

from ..config.config import GNNConfig
from ..data.pipeline import SyntheticRadarDataset, pad_frame, stack_batch
from ..train.steps import create_train_state, make_train_step


def main(argv=None):
    """Returns each step's metrics (floats)."""
    p = argparse.ArgumentParser()
    p.add_argument("--steps", type=int, default=2000)
    p.add_argument("--lr", type=float, default=0.02)
    p.add_argument("--seed", type=int, default=3)
    p.add_argument("--plot", default=None, help="save pred-vs-GT panel PNG")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)

    cfg = GNNConfig(
        max_nodes=512, max_clusters=256, batch_size=1,
        learning_rate=args.lr, max_train_iter=args.steps,
        temporal_window_size=5,
    )
    ds = SyntheticRadarDataset(cfg, seed=args.seed, num_objects=4)
    fr = ds.sample_frame()
    batch = stack_batch([pad_frame(fr, cfg)])

    state = create_train_state(cfg, torch.Generator().manual_seed(0), device=args.device)
    step = make_train_step(cfg)
    history = []
    for it in range(args.steps):
        state, m = step(state, batch)
        m = {k: float(v) for k, v in m.items()}
        history.append(m)
        if (it + 1) % max(args.steps // 10, 1) == 0:
            print(
                f"iter {it + 1}: total {m['loss_total']:.4f} "
                f"node {m['loss_node_cls']:.4f} "
                f"edge {m['loss_edge_cls']:.4f} "
                f"reg {m['loss_node_reg']:.4f} "
                f"obj {m['loss_obj_cls']:.4f} | "
                f"seg acc {m['segment_accuracy']:.3f} "
                f"edge acc {m['edge_accuracy']:.3f} "
                f"obj acc {m['object_accuracy']:.3f}"
            )

    if args.plot:
        import matplotlib

        matplotlib.use("Agg")
        from ..infer.pipeline import FrameDetector
        from ..viz.plots import compare_pred_gt

        det = FrameDetector(cfg, state.model.state_dict(), device=args.device)
        fig = compare_pred_gt(det.detect_frame_arrays(fr))
        fig.savefig(args.plot, dpi=110)
        print(f"saved {args.plot}")
    return history


if __name__ == "__main__":
    main()
