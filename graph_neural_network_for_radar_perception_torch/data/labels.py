"""RadarScenes label taxonomy and remapping.

Mirrors the reference's 12-class → 8-class ('dyn' = first 7) relabelling
(modules/data_utils/labels.py:9-103), kept as plain numpy so it can run in
the host input pipeline and be baked into device LUT arrays.

The port's own copy of the JAX package's ``data/labels.py`` (numpy only), kept
so that the port imports nothing of that package.
"""

from __future__ import annotations

import numpy as np

INVALID_NUM = -99999.0

ALL_LABELS = [
    "CAR",
    "LARGE_VEHICLE", "TRUCK", "BUS", "TRAIN",
    "BICYCLE", "MOTORIZED_TWO_WHEELER",
    "PEDESTRIAN",
    "PEDESTRIAN_GROUP",
    "ANIMAL", "OTHER",
    "STATIC",
]

NEW_LABELS = [
    "CAR", "PEDESTRIAN", "PEDESTRIAN_GROUP", "TWO_WHEELER",
    "LARGE_VEHICLE", "NONE", "FALSE", "STATIC",
]

OLD_TO_NEW = {
    "CAR": "CAR",
    "LARGE_VEHICLE": "LARGE_VEHICLE",
    "TRUCK": "LARGE_VEHICLE",
    "BUS": "LARGE_VEHICLE",
    "TRAIN": "LARGE_VEHICLE",
    "BICYCLE": "TWO_WHEELER",
    "MOTORIZED_TWO_WHEELER": "TWO_WHEELER",
    "PEDESTRIAN": "PEDESTRIAN",
    "PEDESTRIAN_GROUP": "PEDESTRIAN_GROUP",
    "ANIMAL": "NONE",
    "OTHER": "NONE",
    "STATIC": "STATIC",
}


def old_labels_to_id() -> dict:
    """RadarScenes raw label ids (labels.py:44-58)."""
    return {name: i for i, name in enumerate([
        "CAR", "LARGE_VEHICLE", "TRUCK", "BUS", "TRAIN", "BICYCLE",
        "MOTORIZED_TWO_WHEELER", "PEDESTRIAN", "PEDESTRIAN_GROUP",
        "ANIMAL", "OTHER", "STATIC",
    ])}


def new_labels_to_id() -> dict:
    """8-class taxonomy ids (labels.py:60-70)."""
    return {name: i for i, name in enumerate(NEW_LABELS)}


def dyn_labels_to_id() -> dict:
    """7-class dynamic taxonomy (labels.py:72-81): drops STATIC."""
    return {name: i for i, name in enumerate(NEW_LABELS[:-1])}


# Commonly-used numeric ids.
ID_NONE = 5
ID_FALSE = 6
ID_STATIC = 7
NUM_CLASSES_DYN = 7
NUM_CLASSES_ALL = 8


def old_to_new_label_id_map() -> np.ndarray:
    """LUT old id → new id (labels.py:90-100)."""
    old_ids = old_labels_to_id()
    new_ids = new_labels_to_id()
    lut = np.full((len(old_ids),), -1, dtype=np.int32)
    for old_name, new_name in OLD_TO_NEW.items():
        lut[old_ids[old_name]] = new_ids[new_name]
    return lut


def reassign_label_ids(old_ids: np.ndarray, lut: np.ndarray | None = None):
    if lut is None:
        lut = old_to_new_label_id_map()
    return lut[old_ids]
