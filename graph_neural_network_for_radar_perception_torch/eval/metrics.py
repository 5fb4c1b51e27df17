"""Evaluation metrics: confusion matrices, greedy association,
precision/recall.

The port's own numpy copy of the JAX package's ``eval/metrics.py`` (host
side, no framework): the reference's modules/performance/
segmentation_accuracy.py and detection_accuracy.py:192-273, with the
reference's O(G·P) python set-IoU loop replaced by a vectorised
membership-matrix intersection.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np

VERY_LARGE_NUM = 9999999  # detection_accuracy.py:19


def confusion_matrix(gt: np.ndarray, pred: np.ndarray, num_classes: int):
    """[num_classes, num_classes] with rows = GT, cols = prediction."""
    cm = np.zeros((num_classes, num_classes), dtype=np.int64)
    np.add.at(cm, (gt.astype(np.int64), pred.astype(np.int64)), 1)
    return cm


def precision_recall(cm: np.ndarray, drop_classes: Sequence[int] = (5,)):
    """precision = diag/col-sum, recall = diag/row-sum; classes in
    drop_classes (default NONE=5) are removed before normalising, matching
    the eval notebooks' aggregation recipe (SURVEY.md §3.4)."""
    keep = np.array(
        [i for i in range(cm.shape[0]) if i not in set(drop_classes)]
    )
    sub = cm[np.ix_(keep, keep)].astype(np.float64)
    diag = np.diag(sub)
    pred_count = sub.sum(axis=0)
    gt_count = sub.sum(axis=1)
    with np.errstate(divide="ignore", invalid="ignore"):
        precision = np.where(pred_count > 0, diag / pred_count, 0.0)
        recall = np.where(gt_count > 0, diag / gt_count, 0.0)
    return {
        "classes": keep,
        "precision": precision,
        "recall": recall,
        "confusion": sub,
    }


def membership_iou_matrix(
    gt_members: List[np.ndarray], pred_members: List[np.ndarray], n_nodes: int
) -> np.ndarray:
    """1 − IoU of member-index sets, [G, P]
    (detection_accuracy.py:217-222, vectorised)."""
    G, P = len(gt_members), len(pred_members)
    gm = np.zeros((G, n_nodes), dtype=bool)
    pm = np.zeros((P, n_nodes), dtype=bool)
    for i, m in enumerate(gt_members):
        gm[i, m] = True
    for j, m in enumerate(pred_members):
        pm[j, m] = True
    inter = gm.astype(np.int64) @ pm.T.astype(np.int64)
    union = gm.sum(1)[:, None] + pm.sum(1)[None, :] - inter
    iou = np.where(union > 0, inter / np.maximum(union, 1), 0.0)
    return 1.0 - iou


def greedy_association(
    dist_mat: np.ndarray,
    obj_class_gt: np.ndarray,
    obj_class_pred: np.ndarray,
    eps: float,
    false_class_label: int = 6,
):
    """Greedy min-cost matching with unmatched-pred → FALSE semantics
    (detection_accuracy.py:226-249).  Returns (gt_assoc, pred_assoc)."""
    dist = dist_mat.astype(np.float64).copy()
    G, P = dist.shape
    if G == 0 or P == 0:
        return np.zeros((0,)), np.zeros((0,))
    associations, distances = [], []
    for _ in range(min(G, P)):
        r, c = np.unravel_index(np.argmin(dist), dist.shape)
        associations.append((r, c))
        distances.append(dist[r, c])
        dist[r, :] = VERY_LARGE_NUM
        dist[:, c] = VERY_LARGE_NUM
    associations = np.asarray(associations)
    distances = np.asarray(distances)
    pos = associations[distances <= eps]
    neg = associations[distances > eps]
    gt_assoc = np.concatenate([
        obj_class_gt[pos[:, 0]],
        np.repeat(false_class_label, neg.shape[0]),
    ])
    pred_assoc = np.concatenate([
        obj_class_pred[pos[:, 1]],
        obj_class_pred[neg[:, 1]],
    ])
    return gt_assoc, pred_assoc


class AssociationResult:
    """Full return of the reference's compute_gt_and_pred_associations
    (detection_accuracy.py:275-279): beyond the greedily-associated class
    pairs, the raw unassociated class lists are preserved for the
    empty-side conditions (:252-273) so notebook-style aggregations that
    consume them stay reproducible.

    Condition semantics (detection_accuracy.py:198-201):
      both sides present → associated pairs filled, raw lists filled;
      GT only            → raw obj_class_gt filled, everything else empty;
      pred only          → raw obj_class_pred filled, everything else empty;
      both empty         → all four empty.
    """

    __slots__ = ("gt_associated", "pred_associated", "obj_class_gt",
                 "obj_class_pred")

    def __init__(self, gt_associated, pred_associated, obj_class_gt,
                 obj_class_pred):
        self.gt_associated = gt_associated
        self.pred_associated = pred_associated
        self.obj_class_gt = obj_class_gt
        self.obj_class_pred = obj_class_pred

    def __iter__(self):  # (gt_a, pred_a) unpacking, as before
        return iter((self.gt_associated, self.pred_associated))


def compute_associations(
    gt_members: List[np.ndarray],
    pred_members: List[np.ndarray],
    obj_class_gt: np.ndarray,
    obj_class_pred: np.ndarray,
    n_nodes: int,
    *,
    eps: float = 0.7,
    criteria: str = "inv_iou",
    gt_means: np.ndarray | None = None,
    pred_means: np.ndarray | None = None,
    false_class_label: int = 6,
) -> AssociationResult:
    """compute_gt_and_pred_associations equivalent incl. the raw-list
    returns for the empty-side conditions (detection_accuracy.py:192-279)."""
    empty = np.zeros((0,))
    has_gt, has_pred = len(gt_members) > 0, len(pred_members) > 0
    if has_gt and has_pred:
        if criteria == "inv_iou":
            dist = membership_iou_matrix(gt_members, pred_members, n_nodes)
        elif criteria == "l2_norm":
            dist = np.linalg.norm(
                gt_means[:, None, :] - pred_means[None, :, :], axis=-1
            )
        else:
            raise ValueError(criteria)
        gt_a, pred_a = greedy_association(
            dist, obj_class_gt, obj_class_pred, eps, false_class_label
        )
        return AssociationResult(
            gt_a, pred_a, np.asarray(obj_class_gt),
            np.asarray(obj_class_pred),
        )
    if has_gt:  # condition2: GT objects with no predictions
        return AssociationResult(empty, empty, np.asarray(obj_class_gt), empty)
    if has_pred:  # condition3: predictions with no GT
        return AssociationResult(empty, empty, empty,
                                 np.asarray(obj_class_pred))
    return AssociationResult(empty, empty, empty, empty)  # condition4


def associate_clusters(
    gt_members: List[np.ndarray],
    pred_members: List[np.ndarray],
    obj_class_gt: np.ndarray,
    obj_class_pred: np.ndarray,
    n_nodes: int,
    *,
    eps: float = 0.7,
    criteria: str = "inv_iou",
    gt_means: np.ndarray | None = None,
    pred_means: np.ndarray | None = None,
    false_class_label: int = 6,
):
    """Associated-pairs view of compute_associations (detection_accuracy.py
    :192-273); returns (gt_assoc, pred_assoc)."""
    res = compute_associations(
        gt_members, pred_members, obj_class_gt, obj_class_pred, n_nodes,
        eps=eps, criteria=criteria, gt_means=gt_means, pred_means=pred_means,
        false_class_label=false_class_label,
    )
    return res.gt_associated, res.pred_associated


def filter_clusters_by_size(members, means, covs, sizes, classes, threshold):
    """Size-threshold filter (detection_accuracy.py:136-164)."""
    keep = [i for i, s in enumerate(sizes) if s > threshold]
    return (
        [members[i] for i in keep],
        [means[i] for i in keep],
        [covs[i] for i in keep],
        [sizes[i] for i in keep],
        [classes[i] for i in keep],
    )


class ConfusionAccumulator:
    """Per-sequence confusion + GT-count accumulation with JSON export in
    the reference's schema (performance/semantic_segmentation/
    sequence_*.json)."""

    def __init__(self, num_classes: int):
        self.num_classes = num_classes
        self.cm = np.zeros((num_classes, num_classes), dtype=np.int64)
        self.gt_count = np.zeros(num_classes, dtype=np.int64)
        # Raw per-frame unassociated class lists (detection eval only;
        # detection_accuracy.py:275-279 'obj_class_gt'/'obj_class_pred') —
        # kept out of the JSON schema, available for notebook aggregations.
        self.raw_gt: list = []
        self.raw_pred: list = []

    def update(self, gt: np.ndarray, pred: np.ndarray):
        self.cm += confusion_matrix(gt, pred, self.num_classes)
        self.gt_count += np.bincount(
            gt.astype(np.int64), minlength=self.num_classes
        )

    def to_json_dict(self) -> Dict:
        return {
            "confusion_matrix": self.cm.tolist(),
            "gt_count": self.gt_count.tolist(),
        }

    def merge(self, other: "ConfusionAccumulator"):
        self.cm += other.cm
        self.gt_count += other.gt_count
        self.raw_gt.extend(other.raw_gt)
        self.raw_pred.extend(other.raw_pred)
        return self
