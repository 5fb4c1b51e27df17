"""End-to-end two-stage chain: train stage-1 GNN → freeze → DBSCAN
proposals → train the stage-2 object classifier on those proposals.

The port of the JAX package's ``examples/classifier_chain.py`` (reference
workflow: modules/data_generator/datagen_classifier.py:239-246, whose
classifier Dataset runs the frozen stage-1 `predictor_eval` inside
__getitem__ to produce proposals, + script_train_model_classifier.ipynb).
Stage 1 runs the fused message-pass kernels, forward and backward, on the
card, the frozen trunk's proposals the forward; stage 2 is plain PyTorch.

Success criterion: on held-out frames, the stage-2 classifier's proposal
accuracy beats the stage-1 segmentation-majority baseline (the class
output.py:112-121 falls back to when no object head is trusted).

Run:  python -m graph_neural_network_for_radar_perception_torch.examples.classifier_chain \\
          --stage1-iters 2000 --stage2-iters 800
"""

from __future__ import annotations

import argparse
import itertools
import json
import os

import numpy as np
import torch

from ..config.config import GNNConfig
from ..core.graph import resolve_device
from ..data.pipeline import SyntheticRadarDataset
from ..infer.pipeline import FrameDetector
from ..models import classifier as CL
from ..train.steps import batch_on
from ..train.trainer import TrainHooks, train


def majority(labels):
    vals, counts = np.unique(labels, return_counts=True)
    return int(vals[np.argmax(counts)])


def main(argv=None):
    """Returns the summary (``summary.json``) and stage 2's metrics per
    step (floats)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--stage1-iters", type=int, default=2000)
    ap.add_argument("--stage2-iters", type=int, default=800)
    ap.add_argument("--pool-batches", type=int, default=64)
    ap.add_argument("--n-train-frames", type=int, default=96)
    ap.add_argument("--n-eval-frames", type=int, default=32)
    ap.add_argument("--batch-size", type=int, default=8)
    ap.add_argument("--out", default=os.path.join("runs", "torch", "classifier_chain"))
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    os.makedirs(args.out, exist_ok=True)

    # ---- stage 1: train the detector trunk ----
    cfg = GNNConfig(
        max_nodes=256, max_clusters=128, temporal_window_size=5,
        batch_size=args.batch_size, max_train_iter=args.stage1_iters,
    )
    ds = SyntheticRadarDataset(cfg, seed=21, num_objects=4)
    pool = [
        batch_on(b, device)
        for b in itertools.islice(ds.batches(cfg.batch_size), args.pool_batches)
    ]
    print(f"stage 1: {args.stage1_iters} iters...", flush=True)
    state1 = train(
        cfg, itertools.cycle(pool),
        hooks=TrainHooks(log_period=max(args.stage1_iters // 5, 1),
                         val_period=10**9),
        max_iters=args.stage1_iters, device=device,
    )

    # ---- freeze; proposal generation over fresh frames ----
    ccfg = CL.ClassifierConfig()
    detector = FrameDetector(
        cfg, state1.model.state_dict(), eps=ccfg.clustering_eps,
        use_object_head=False, device=device,
    )
    frames_ds = SyntheticRadarDataset(cfg, seed=777, num_objects=4)

    def proposals(n_frames):
        """(ClassifierSample, seg-majority preds per object) pairs."""
        out = []
        while len(out) < n_frames:
            fr = frames_ds.sample_frame()
            det = detector.detect_frame_arrays(fr)
            n = det.xy.shape[0]
            s = CL.build_classifier_sample(
                det.xy, fr.node_feat[:n, 1], fr.node_class[:n],
                det.node2cluster, det.num_clusters, ccfg,
            )
            if s is None:
                continue
            # Stage-1 baseline: per-proposal majority of PREDICTED node
            # classes (output.py:112-121 segmentation fallback), aligned
            # with build_classifier_sample's object enumeration.
            seg_pred = np.zeros(ccfg.max_objects, np.int32)
            obj_idx = 0
            for c in range(det.num_clusters):
                members = np.flatnonzero(det.node2cluster == c)
                if members.shape[0] < ccfg.valid_cluster_num_meas_thr:
                    continue
                if obj_idx >= ccfg.max_objects:
                    break
                seg_pred[obj_idx] = majority(det.node_class[members])
                obj_idx += 1
            out.append((s, seg_pred))
        return out

    print("generating proposals with the frozen stage-1 trunk...", flush=True)
    train_props = proposals(args.n_train_frames)
    eval_props = proposals(args.n_eval_frames)

    # ---- stage 2: classifier on the frozen-trunk proposals ----
    init, step, _ = CL.make_classifier_train_step(ccfg)
    state2 = init(torch.Generator().manual_seed(0), device=device)
    rng = np.random.default_rng(3)
    history = []
    print(f"stage 2: {args.stage2_iters} iters...", flush=True)
    for it in range(args.stage2_iters):
        idx = rng.choice(len(train_props), size=args.batch_size)
        batch = CL.stack_samples([train_props[i][0] for i in idx])
        state2, m = step(state2, batch)
        m = {k: float(v) for k, v in m.items()}
        history.append(m)
        if (it + 1) % max(args.stage2_iters // 5, 1) == 0:
            print(
                f"  iter {it + 1}: loss {m['loss_obj_cls']:.4f} "
                f"acc {m['object_accuracy']:.3f}", flush=True,
            )

    # ---- evaluation: stage-2 vs stage-1 seg-majority on held-out ----
    correct2 = total = correct_seg = 0
    for s, seg_pred in eval_props:
        with torch.no_grad():
            logits = state2.model(s.to(state2.device))
        pred2 = logits.argmax(-1).cpu().numpy()
        mask = np.asarray(s.object_mask)
        gt = np.asarray(s.object_class)
        total += int(mask.sum())
        correct2 += int(((pred2 == gt) & mask).sum())
        correct_seg += int(((seg_pred == gt) & mask).sum())
    acc2 = correct2 / max(total, 1)
    acc_seg = correct_seg / max(total, 1)
    summary = {
        "stage1_iters": args.stage1_iters,
        "stage2_iters": args.stage2_iters,
        "eval_objects": total,
        "stage2_accuracy": round(acc2, 4),
        "stage1_seg_majority_accuracy": round(acc_seg, 4),
        "stage2_beats_seg_majority": bool(acc2 > acc_seg),
    }
    with open(os.path.join(args.out, "summary.json"), "w") as f:
        json.dump(summary, f, indent=2)
    print(json.dumps(summary, indent=2))
    return summary, history


if __name__ == "__main__":
    main()
