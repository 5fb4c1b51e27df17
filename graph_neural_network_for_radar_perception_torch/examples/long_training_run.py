"""Long-horizon training demonstration with the full production stack.

The port of the JAX package's ``examples/long_training_run.py``
(reference analog: modules/neural_net/gnn/training.py:48-186, scaled to a
synthetic-data demonstration):

* bucketed static-shape batching (``data/bucketing``, two bucket shapes),
  each step running the fused message-pass kernels, forward and backward,
  on the card;
* the NaN guard and the MultiStep LR (both milestones, 50 %/80 %, are
  crossed);
* periodic validation, JSONL/TensorBoard scalars and checkpoints of the
  port's ``CheckpointManager`` under ``<run-dir>/ckpt``;
* mid-run kill + exact resume: run with --stop-at N first, rerun without
  it — the loop restores params, momentum and step and continues to
  --max-iters;
* post-hoc detection-eval trend: every kept checkpoint is evaluated with
  the deploy-mode FrameDetector against held-out frames; precision/recall
  per class land in eval_trend.jsonl, including the random-init baseline
  at step 0.

Run:

    python -m graph_neural_network_for_radar_perception_torch.examples.long_training_run \\
        --max-iters 20000 --stop-at 9000        # phase 1: killed mid-run
    python -m graph_neural_network_for_radar_perception_torch.examples.long_training_run \\
        --max-iters 20000                       # phase 2: resume to end
    python -m graph_neural_network_for_radar_perception_torch.examples.long_training_run \\
        --eval-only                             # refresh eval_trend.jsonl
"""

from __future__ import annotations

import argparse
import itertools
import json
import os
from collections import Counter

import numpy as np
import torch

from ..config.config import GNNConfig
from ..data.bucketing import Bucket, bucketed_batches, make_bucketed_train_step
from ..data.pipeline import SyntheticRadarDataset
from ..data.synthetic import make_synthetic_frame
from ..eval.drivers import evaluate_detection_from_data
from ..eval.metrics import precision_recall
from ..infer.pipeline import FrameDetector
from ..train.steps import batch_on, create_train_state
from ..train.trainer import TrainHooks, train
from ..utils.checkpoint import CheckpointManager
from ..utils.metrics_writer import MetricsWriter


def main(argv=None):
    """Returns the final TrainState, or the path of eval_trend.jsonl under
    --eval-only."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--run-dir", default=os.path.join("runs", "torch", "long_run"))
    ap.add_argument("--max-iters", type=int, default=20000)
    ap.add_argument("--stop-at", type=int, default=None,
                    help="simulate a mid-run kill at this iteration")
    ap.add_argument("--val-period", type=int, default=1000)
    ap.add_argument("--pool-batches", type=int, default=256,
                    help="distinct bucketed batches cycled as the train set")
    ap.add_argument("--eval-frames", type=int, default=24)
    ap.add_argument("--eval-only", action="store_true")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = GNNConfig(
        max_nodes=256, max_clusters=128, temporal_window_size=5,
        batch_size=8, max_train_iter=args.max_iters,
    )
    buckets = [Bucket(128, 64, 16), Bucket(256, 128, 8)]
    run_dir = os.path.abspath(args.run_dir)
    os.makedirs(run_dir, exist_ok=True)
    ckpt = CheckpointManager(os.path.join(run_dir, "ckpt"), max_to_keep=64)

    # ---- post-hoc checkpoint evaluation (also the --eval-only path) ----
    def eval_trend():
        rng = np.random.default_rng(999)
        held_out = [
            make_synthetic_frame(
                rng, num_objects=4, window_size=cfg.temporal_window_size
            )
            for _ in range(args.eval_frames)
        ]
        template = create_train_state(cfg, torch.Generator().manual_seed(0),
                                      device=args.device)
        init_weights = {k: v.clone() for k, v in template.model.state_dict().items()}
        steps = [0] + list(ckpt.all_steps())
        path = os.path.join(run_dir, "eval_trend.jsonl")
        with open(path, "w") as f:
            for step in steps:
                if step == 0:
                    weights = init_weights  # random init baseline
                else:
                    weights = ckpt.restore(step, template=template).model.state_dict()
                det = FrameDetector(cfg, weights, device=args.device)
                acc = evaluate_detection_from_data(det, iter(held_out))
                pr = precision_recall(acc.cm)
                prec, rec = pr["precision"], pr["recall"]
                f1 = 2 * prec * rec / np.maximum(prec + rec, 1e-9)
                rec_line = {
                    "step": int(step),
                    "precision": [round(float(p), 4) for p in prec],
                    "recall": [round(float(r), 4) for r in rec],
                    "mean_f1": round(float(f1.mean()), 4),
                }
                f.write(json.dumps(rec_line) + "\n")
                print("eval", rec_line, flush=True)
        return path

    if args.eval_only:
        return eval_trend()

    # ---- resume ----
    state = create_train_state(cfg, torch.Generator().manual_seed(cfg.seed),
                               device=args.device)
    starting_iter = 0
    latest = ckpt.latest_step()
    if latest is not None:
        print(f"restoring checkpoint step {latest}...", flush=True)
        state = ckpt.restore(latest, template=state)
        starting_iter = int(latest)
        print(f"resumed from checkpoint step {starting_iter}", flush=True)

    # ---- data: a fixed pool of bucketed batches on the device, cycled ----
    ds = SyntheticRadarDataset(cfg, seed=7, num_objects=4)

    def frames():
        while True:
            yield ds.sample_frame()

    print(f"materialising {args.pool_batches} bucketed batches...", flush=True)
    pool = [
        (b, batch_on(batch, args.device))
        for b, batch in itertools.islice(
            bucketed_batches(frames(), cfg, buckets), args.pool_batches
        )
    ]
    print("bucket mix:", Counter(b.max_nodes for b, _ in pool), flush=True)

    val_ds = SyntheticRadarDataset(cfg, seed=4242, num_objects=4)
    val_pool = [
        batch_on(b, args.device)
        for b in itertools.islice(val_ds.batches(cfg.batch_size), 4)
    ]

    bstep = make_bucketed_train_step(cfg, buckets)

    def step(state, item):
        bucket, batch = item
        return bstep(state, bucket, batch)

    max_iters = (
        min(args.stop_at, args.max_iters) if args.stop_at else args.max_iters
    )
    writer = MetricsWriter(os.path.join(run_dir, "logs"))
    hooks = TrainHooks(
        log_period=200, val_period=args.val_period, num_val_batches=4,
        checkpoint=ckpt, writer=writer,
    )
    state = train(
        cfg,
        itertools.cycle(pool),
        lambda: iter(val_pool),
        hooks=hooks,
        state=state,
        train_step=step,
        max_iters=max_iters,
        starting_iter=starting_iter,
    )
    ckpt.close()
    writer.close()
    print(f"finished at step {state.step}", flush=True)
    if not args.stop_at:
        eval_trend()
    return state


if __name__ == "__main__":
    main()
