"""Sequence-level evaluation drivers over the port's ``FrameDetector``.

The JAX package's ``eval/drivers.py`` (the reference's performance
notebooks + modules/performance/*):

* segmentation: per-frame GT vs predicted node class accumulated into
  per-sequence confusion JSONs (segmentation_accuracy.py:17-87);
* detection: DBSCAN prediction clusters vs track-id GT clusters,
  size-threshold filter, greedy 1−IoU association with unmatched-pred →
  FALSE, aggregated precision/recall with class NONE dropped
  (detection_accuracy.py:22-273, eval notebook cells).

The detector runs where it was built (the card unless ``device="cpu"``);
everything here is host-side numpy over its decoded detections.
"""

from __future__ import annotations

import json
import os
from typing import Iterable, List

import numpy as np

from ..data.groundtruth import compute_ground_truth_node
from ..data.labels import ID_NONE
from ..data.pipeline import FrameArrays, preprocess_frame
from ..infer.pipeline import FrameDetections, FrameDetector
from . import metrics as M


def segmentation_confusion(
    detector: FrameDetector,
    frames: Iterable[FrameArrays],
) -> M.ConfusionAccumulator:
    acc = M.ConfusionAccumulator(detector.cfg.num_classes)
    for fr in frames:
        det = detector.detect_frame_arrays(fr)
        # det arrays are truncated to capacity when the frame overflows
        n = det.node_class.shape[0]
        acc.update(fr.node_class[:n], det.node_class)
    return acc


def _clusters(node2cluster: np.ndarray, cluster_class: np.ndarray,
              num_clusters: int):
    """Member index lists and classes of the non-empty clusters."""
    members, classes = [], []
    for c in range(num_clusters):
        idx = np.flatnonzero(node2cluster == c)
        if idx.size:
            members.append(idx)
            classes.append(int(cluster_class[c]))
    return members, np.asarray(classes, dtype=np.int64)


def _gt_clusters_from_frame(fr: FrameArrays):
    return _clusters(fr.node2cluster, fr.cluster_class,
                     int(fr.cluster_class.shape[0]))


def _pred_clusters_from_det(det: FrameDetections):
    return _clusters(det.node2cluster, det.cluster_class, det.num_clusters)


def _means(members: List[np.ndarray], fr: FrameArrays):
    if not members:
        return np.zeros((0, 2))
    return np.stack(
        [fr.other_feat[m, :2].mean(axis=0) for m in members], axis=0
    )


def _filter_by_size(members, classes, threshold):
    """Size-threshold filter (detection_accuracy.py:136-164)."""
    keep = [i for i, m in enumerate(members) if m.size > threshold]
    return (
        [members[i] for i in keep],
        classes[keep] if len(classes) else classes,
    )


def evaluate_detection_from_data(
    detector: FrameDetector,
    data_dicts: Iterable[dict],
    *,
    cluster_size_threshold: int = 1,
    eps: float = 0.7,
    criteria: str = "inv_iou",
    drop_none_measurements: bool = True,
) -> M.ConfusionAccumulator:
    """Detection eval from raw windowed data_dicts (NONE-class filtering
    happens before graph construction, like the reference)."""
    acc = M.ConfusionAccumulator(detector.cfg.num_classes)
    for data in data_dicts:
        if drop_none_measurements:
            gt = compute_ground_truth_node(data)
            lut_keep = gt["class_labels"] != ID_NONE
            data = {k: v[lut_keep] for k, v in data.items()}
        fr = preprocess_frame(data, detector.cfg)
        if fr is None:
            continue
        det = detector.detect_frame_arrays(fr)
        gm, gc = _filter_by_size(*_gt_clusters_from_frame(fr),
                                 cluster_size_threshold)
        pm, pc = _filter_by_size(*_pred_clusters_from_det(det),
                                 cluster_size_threshold)
        res = M.compute_associations(
            gm, pm, gc, pc, n_nodes=fr.n, eps=eps, criteria=criteria,
            gt_means=_means(gm, fr), pred_means=_means(pm, fr),
        )
        if res.gt_associated.size:
            acc.update(res.gt_associated, res.pred_associated)
        # The raw unassociated class lists of the empty-side conditions
        # (detection_accuracy.py:252-273), for notebook-style aggregations.
        acc.raw_gt.append(res.obj_class_gt)
        acc.raw_pred.append(res.obj_class_pred)
    return acc


def write_sequence_json(
    acc: M.ConfusionAccumulator, out_dir: str, sequence_name: str
):
    """Per-sequence JSON in the reference's schema
    (performance/semantic_segmentation/sequence_*.json)."""
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, f"{sequence_name}.json")
    with open(path, "w") as f:
        json.dump(acc.to_json_dict(), f, indent=4)
    return path


def aggregate_sequence_jsons(paths: Iterable[str], num_classes: int):
    """Aggregate per-sequence JSONs → precision/recall (eval notebook
    aggregation recipe, NONE dropped)."""
    total = M.ConfusionAccumulator(num_classes)
    for p in paths:
        with open(p) as f:
            d = json.load(f)
        total.cm += np.asarray(d["confusion_matrix"], dtype=np.int64)
        total.gt_count += np.asarray(d["gt_count"], dtype=np.int64)
    return M.precision_recall(total.cm)
