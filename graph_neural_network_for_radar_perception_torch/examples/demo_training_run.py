"""Demonstration training run: train the flagship GNN on synthetic radar
scenes and report before/after segmentation+detection metrics.

The port of the JAX package's ``examples/demo_training_run.py``: writes
``<out>/metrics.jsonl``, ``eval_before.json``, ``eval_after.json`` and the
trained weights as ``params.pt`` (``utils/checkpoint.save_params``) and,
as the JAX example writes them, as flax msgpack in ``params.msgpack``
(``utils/checkpoint.save_params_msgpack``: the JAX package's
``load_params_msgpack`` reads it).  Training runs the fused message-pass
kernels, forward and backward, on the card; the evaluations the forward.

Run: python -m graph_neural_network_for_radar_perception_torch.examples.demo_training_run --iters 10000
"""

import argparse
import json
import os
import time

import numpy as np
import torch

from ..config.config import GNNConfig
from ..data.pipeline import SyntheticRadarDataset
from ..data.prefetch import device_prefetch, threaded_batches
from ..data.synthetic import make_synthetic_frame
from ..eval import drivers as D
from ..eval.metrics import precision_recall
from ..infer.pipeline import FrameDetector
from ..train.steps import create_train_state
from ..train.trainer import TrainHooks, train
from ..utils.checkpoint import save_params, save_params_msgpack
from ..utils.convert import flax_from_state_dict
from ..utils.metrics_writer import MetricsWriter


def evaluate(cfg, weights, device, n_frames=24, seed=777):
    det = FrameDetector(cfg, weights, eps=1.4, device=device)
    ds = SyntheticRadarDataset(cfg, seed=seed, num_objects=5)
    frames = [ds.sample_frame() for _ in range(n_frames)]
    seg = D.segmentation_confusion(det, frames)
    seg_pr = precision_recall(seg.cm)
    seg_acc = float(np.trace(seg.cm) / max(seg.cm.sum(), 1))

    gen = (
        make_synthetic_frame(
            ds.rng, num_objects=5, window_size=cfg.temporal_window_size
        )
        for _ in range(n_frames)
    )
    detc = D.evaluate_detection_from_data(
        det, gen, cluster_size_threshold=1, eps=0.7
    )
    det_pr = precision_recall(detc.cm)
    classes = [cfg.object_classes_dyn[i] for i in seg_pr["classes"]]
    return {
        "seg_accuracy": seg_acc,
        "classes": classes,
        "seg_precision": seg_pr["precision"].tolist(),
        "seg_recall": seg_pr["recall"].tolist(),
        "det_precision": det_pr["precision"].tolist(),
        "det_recall": det_pr["recall"].tolist(),
    }


def main(argv=None):
    """Returns the after-training evaluation (``eval_after.json``)."""
    p = argparse.ArgumentParser()
    p.add_argument("--iters", type=int, default=10_000)
    p.add_argument("--out", default=os.path.join("runs", "torch", "demo"))
    p.add_argument("--device", default="cuda")
    p.add_argument("--skip-before-eval", action="store_true",
                   help="skip the untrained-model eval")
    p.add_argument("--eval-frames", type=int, default=24)
    args = p.parse_args(argv)

    cfg = GNNConfig(
        max_nodes=512, max_clusters=256, temporal_window_size=5,
        batch_size=8, max_train_iter=args.iters, learning_rate=0.01,
    )
    os.makedirs(args.out, exist_ok=True)

    state = create_train_state(cfg, torch.Generator().manual_seed(cfg.seed),
                               device=args.device)
    if not args.skip_before_eval:
        print("evaluating untrained model...", flush=True)
        before = evaluate(cfg, state.model.state_dict(), args.device,
                          n_frames=args.eval_frames)
        with open(os.path.join(args.out, "eval_before.json"), "w") as f:
            json.dump(before, f, indent=2)
        print(f"before: seg acc {before['seg_accuracy']:.3f}")

    def make_iter():
        seed = int.from_bytes(os.urandom(2), "little")
        ds = SyntheticRadarDataset(cfg, seed=seed, num_objects=5)
        return ds.batches(cfg.batch_size)

    batches = device_prefetch(
        threaded_batches(make_iter, num_workers=8, queue_size=16),
        buffer_size=2, device=args.device,
    )
    writer = MetricsWriter(args.out, use_tensorboard=False)
    hooks = TrainHooks(
        log_period=500, val_period=2000, num_val_batches=0, writer=writer,
    )
    t0 = time.time()
    state = train(cfg, batches, hooks=hooks, state=state,
                  max_iters=args.iters)
    wall = time.time() - t0
    writer.close()
    print(f"trained {args.iters} iters in {wall:.0f}s "
          f"({args.iters / wall:.1f} it/s)")

    print("evaluating trained model...", flush=True)
    after = evaluate(cfg, state.model.state_dict(), args.device,
                     n_frames=args.eval_frames)
    after["train_iters"] = args.iters
    after["wall_s"] = wall
    with open(os.path.join(args.out, "eval_after.json"), "w") as f:
        json.dump(after, f, indent=2)
    print(f"after: seg acc {after['seg_accuracy']:.3f}")
    for i, name in enumerate(after["classes"]):
        print(
            f"  {name:18s} seg P/R {after['seg_precision'][i] * 100:5.1f}/"
            f"{after['seg_recall'][i] * 100:5.1f}  det P/R "
            f"{after['det_precision'][i] * 100:5.1f}/"
            f"{after['det_recall'][i] * 100:5.1f}"
        )

    save_params(state.model, os.path.join(args.out, "params.pt"))
    save_params_msgpack(flax_from_state_dict(state.model.state_dict()),
                        os.path.join(args.out, "params.msgpack"))
    return after


if __name__ == "__main__":
    main()
