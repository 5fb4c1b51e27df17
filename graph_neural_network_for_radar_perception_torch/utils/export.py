"""Prediction export in the RadarScenes viewer JSON schema.

The port's copy of the JAX package's ``utils/export.py`` (pure Python; a
``FrameDetections`` of the port's ``infer/pipeline.py`` holds numpy arrays).
Mirrors the vendored dataset package's evaluation export
(dataset/radar_scenes/radar_scenes/evaluation.py:10-56): per-detection
predictions keyed by uuid, with a label-translation table, in either the
semantic-segmentation (class only) or instance-segmentation
(class + instance id) schema — so predictions from this framework can be
inspected with RadarScenes tooling.
"""

from __future__ import annotations

import enum
import json
from typing import Dict, Mapping, Union


class PredictionFileSchemas(enum.Enum):
    SemSeg = 1   # per-point class label
    InstSeg = 2  # per-point [class label, instance label]


def per_point_predictions_to_json(
    predictions: Mapping[Union[str, bytes], object],
    filename: str,
    label_translation: Mapping[int, object],
    schema: PredictionFileSchemas,
) -> dict:
    """predictions: uuid → class id (SemSeg) or [class id, instance id]
    (InstSeg); label_translation: original label id → new label id (enums
    accepted)."""
    mapping_int, mapping_name = {}, {}
    for label, other in label_translation.items():
        label_int = label.value if isinstance(label, enum.Enum) else label
        if isinstance(other, enum.Enum):
            other_int, other_str = other.value, other.name
        else:
            other_int, other_str = other, str(other)
        mapping_int[label_int] = other_int
        if other_int is not None:
            mapping_name[other_int] = other_str

    result = {
        "schema": schema.value,
        "label_mapping": mapping_int,
        "new_label_names": mapping_name,
        "predictions": {},
    }
    for uuid, pred in predictions.items():
        if isinstance(uuid, bytes):
            uuid = uuid.decode()
        result["predictions"][uuid] = pred

    with open(filename, "w") as f:
        json.dump(result, f, ensure_ascii=True, indent=2)
    return result


def export_frame_detections(
    det,
    uuids,
    filename: str,
    label_translation: Mapping[int, object] | None = None,
) -> dict:
    """Export a FrameDetections in the InstSeg schema: per point
    [predicted class, DBSCAN cluster id]."""
    from ..data.labels import NEW_LABELS

    if label_translation is None:
        label_translation = {i: name for i, name in enumerate(NEW_LABELS)}
    n = det.node_class.shape[0]
    preds = {
        uuids[i]: [int(det.node_class[i]), int(det.node2cluster[i])]
        for i in range(n)
    }
    return per_point_predictions_to_json(
        preds, filename, label_translation, PredictionFileSchemas.InstSeg
    )
