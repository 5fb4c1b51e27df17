"""Train on the mini-RadarScenes fixture through the data pipeline and
write the artifact corpus:

    <out>/
      weights.pt                          trained state_dict
      weights.msgpack                     the same weights as flax msgpack
                                          (the JAX package's format)
      config.json                         exact training configuration
      eval/semantic_segmentation/*.json   per-sequence confusion JSONs in
                                          the reference schema
      eval/object_classification/*.json   detection-eval confusion JSONs
      README.md                           recipe + aggregated P/R table

The port of root ``scripts/train_fixture_artifact.py`` (the framework's
equivalent of the reference's shipped
`model_weights/gnn/<ts>/graph_based_detector.pt` + `performance/*.json`
corpus): the same recipe — windows → stationary gating → SE(2)
ego-compensation → ROI/dynamic filters → graph build → training →
per-sequence evaluation — over the same six sequences, made in memory
(``data/mini_radarscenes``).  Training runs the fused message-pass kernels,
forward and backward, on the card; the evaluation the forward.  The
committed corpus (``runs/fixture_artifact/``) is the JAX package's and is
never written here.

Run: python -m graph_neural_network_for_radar_perception_torch.scripts.train_fixture_artifact [--iters N] [--device cpu]
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time

import numpy as np

from ..config.config import GNNConfig
from ..data.mini_radarscenes import MemorySequenceCache, make_sequence
from ..data.pipeline import preprocess_frame
from ..data.radarscenes import RadarScenesDataset, build_metadata
from ..eval import drivers as D
from ..infer.pipeline import FrameDetector
from ..train.trainer import TrainHooks, train
from ..utils.checkpoint import save_params, save_params_msgpack
from ..utils.convert import flax_from_state_dict

TRAIN_SEQS = [f"sequence_{i}" for i in (1, 2, 3, 4)]
HELDOUT_SEQS = ["sequence_5", "sequence_6"]
WINDOW = 5


def build_fixture() -> MemorySequenceCache:
    seqs = {name: make_sequence(seed=100 + i, n_scenes=48, n_objects=4, seq_name=name)
            for i, name in enumerate(TRAIN_SEQS)}
    seqs.update({name: make_sequence(seed=200 + i, n_scenes=48, n_objects=4, seq_name=name)
                 for i, name in enumerate(HELDOUT_SEQS)})
    return MemorySequenceCache(seqs)


def main(argv=None):
    """Returns the output directory."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--iters", type=int, default=3000)
    ap.add_argument("--out", default=os.path.join("runs", "torch", "fixture_artifact"))
    args = ap.parse_args(argv)

    t0 = time.time()
    cache = build_fixture()
    cfg = GNNConfig(
        max_nodes=256, max_clusters=128, temporal_window_size=WINDOW,
        batch_size=4, max_train_iter=args.iters, learning_rate=0.01,
    )
    meta = build_metadata(cache, TRAIN_SEQS, WINDOW)
    ds = RadarScenesDataset(cfg, None, meta, augment=cfg.dataset_augmentation,
                            cache=cache)
    print(f"fixture: {len(meta)} train windows from {len(TRAIN_SEQS)} "
          f"sequences ({time.time() - t0:.1f}s)", flush=True)

    state = train(
        cfg, ds.batches(cfg.batch_size, shuffle=True),
        hooks=TrainHooks(log_period=200, val_period=10**9),
        max_iters=args.iters, device=args.device,
    )
    print(f"trained {state.step} iters ({time.time() - t0:.1f}s)", flush=True)

    os.makedirs(args.out, exist_ok=True)
    weights = state.model.state_dict()
    save_params(weights, os.path.join(args.out, "weights.pt"))
    save_params_msgpack(flax_from_state_dict(weights),
                        os.path.join(args.out, "weights.msgpack"))
    with open(os.path.join(args.out, "config.json"), "w") as f:
        json.dump(
            {k: v for k, v in dataclasses.asdict(cfg).items()
             if not isinstance(v, (bytes,))},
            f, indent=2, default=str,
        )

    # Per-sequence eval in the reference JSON schema.
    det = FrameDetector(cfg, weights, eps=1.4, use_object_head=True,
                        device=args.device)
    seg_dir = os.path.join(args.out, "eval", "semantic_segmentation")
    det_dir = os.path.join(args.out, "eval", "object_classification")
    seg_paths, det_paths = [], []
    for name in TRAIN_SEQS + HELDOUT_SEQS:
        frames, dicts = [], []
        for w in cache.windows(name, WINDOW):
            data = cache.extract_window(name, w)
            dicts.append(data)
            fr = preprocess_frame(data, cfg)
            if fr is not None:
                frames.append(fr)
        seg = D.segmentation_confusion(det, frames)
        seg_paths.append(D.write_sequence_json(seg, seg_dir, name))
        datc = D.evaluate_detection_from_data(
            det, dicts, cluster_size_threshold=1, eps=0.7
        )
        det_paths.append(D.write_sequence_json(datc, det_dir, name))
        seg_acc = (
            np.trace(seg.cm) / seg.cm.sum() if seg.cm.sum() else 0.0
        )
        print(f"eval {name}: {len(frames)} frames, "
              f"node-seg acc {seg_acc:.3f}", flush=True)

    classes = list(cfg.object_classes_dyn)
    # aggregate_sequence_jsons returns the precision_recall output.
    seg_pr = D.aggregate_sequence_jsons(seg_paths, cfg.num_classes)
    det_pr = D.aggregate_sequence_jsons(det_paths, cfg.num_classes)

    def table(pr):
        lines = ["| class | precision | recall |", "|---|---|---|"]
        for i, p, r in zip(pr["classes"], pr["precision"], pr["recall"]):
            lines.append(f"| {classes[i]} | {p:.3f} | {r:.3f} |")
        return "\n".join(lines)

    readme = f"""# Fixture-trained artifact corpus

Trained end-to-end on the deterministic mini-RadarScenes fixture through
the pipeline (windows → stationary gating → SE(2) ego-compensation → ROI +
dynamic filters → kNN graph build → padded batches).

Reproduce: `python -m graph_neural_network_for_radar_perception_torch.scripts.train_fixture_artifact`
({args.iters} iterations, batch {cfg.batch_size}, SGD m=0.9 with the
reference's MultiStep schedule; sequences 1-4 train, 5-6 held out).

## Semantic segmentation (all 6 sequences, NONE dropped)

{table(seg_pr)}

## Object detection / classification (DBSCAN proposals, 1-IoU assoc.)

{table(det_pr)}

Per-sequence confusion matrices: `eval/semantic_segmentation/*.json`,
`eval/object_classification/*.json` (reference schema:
performance/semantic_segmentation/sequence_108.json).
Weights: `weights.pt` (load with `utils.checkpoint.load_params`) and
`weights.msgpack` (flax msgpack: `utils.checkpoint.load_params_msgpack` in
either package); exact config: `config.json`.
"""
    with open(os.path.join(args.out, "README.md"), "w") as f:
        f.write(readme)
    print(f"artifact written to {args.out} ({time.time() - t0:.1f}s)")
    return args.out


if __name__ == "__main__":
    main()
