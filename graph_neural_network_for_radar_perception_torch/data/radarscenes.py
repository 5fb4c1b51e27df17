"""RadarScenes dataset IO: sequence metadata, HDF5 frames, windowing.

The port's copy of the JAX package's ``data/radarscenes.py``: numpy
throughout, with ``h5py`` imported only where a sequence is first read (so
the rest of the port runs on hosts without it).  Re-designs
modules/data_utils/read_data.py.  Differences from the reference, which
re-opens and re-reads radar_data.h5 for EVERY sample
(read_data.py:489-532 — flagged as hot-loop item (5) in SURVEY.md §3):

* per-sequence HDF5 + scene metadata are memoised in an LRU cache, so a
  windowed sample is a pure numpy slice;
* scene-list traversal of the scenes.json linked list and sliding-window
  construction happen once per sequence.

Outputs use the exact reference data_dict schema so everything downstream
(pipeline.preprocess_frame) is shared with the synthetic path.
"""

from __future__ import annotations

import functools
import json
import os
from typing import Dict, List, Optional, Tuple

import numpy as np

from .se2 import ego_compensate_window, vr_cartesian_vf
from .selection import identify_stationary_measurements

# Hardcoded test split of the reference (read_data.py:45-46).
TEST_SEQUENCE_IDX = {
    4, 6, 11, 16, 18, 24, 33, 34, 36, 37, 42, 44, 48, 52,
    53, 60, 63, 67, 73, 84, 86, 92, 94, 100, 108, 119, 124, 126,
}


def load_sequences_json(root: str, path: str) -> dict:
    with open(os.path.join(root, path, "sequences.json")) as f:
        return json.load(f)


def train_val_test_split(root: str, path: str):
    """get_train_val_sequence_names_v2 (read_data.py:27-52): category
    'train'/'validation' from sequences.json, then the hardcoded 28-sequence
    test carve-out from the train list."""
    info = load_sequences_json(root, path)
    train_all, val = [], []
    for i in range(info["n_sequences"]):
        name = f"sequence_{i + 1}"
        cat = info["sequences"][name]["category"]
        if cat == "train":
            train_all.append(name)
        elif cat == "validation":
            val.append(name)
    test = [train_all[i] for i in sorted(TEST_SEQUENCE_IDX) if i < len(train_all)]
    train = [s for i, s in enumerate(train_all) if i not in TEST_SEQUENCE_IDX]
    return train, val, test


def walk_scenes(scenes_data: dict):
    """Traverse the scenes.json linked list (read_data.py:164-200).
    Returns per-scene parallel lists."""
    scenes = scenes_data["scenes"]
    ts_list, radar_ids, odo_ts, odo_idx, radar_indices = [], [], [], [], []
    ts = scenes_data["first_timestamp"]
    while ts is not None:
        sc = scenes[str(ts)]
        ts_list.append(ts)
        radar_ids.append(sc["sensor_id"])
        odo_ts.append(sc["odometry_timestamp"])
        odo_idx.append(sc["odometry_index"])
        radar_indices.append(sc["radar_indices"])
        ts = sc["next_timestamp"]
    return ts_list, radar_ids, odo_ts, odo_idx, radar_indices


def sliding_windows(lists: Tuple[List, ...], window: int) -> List[dict]:
    """read_data.py:203-224."""
    ts_list, radar_ids, odo_ts, odo_idx, radar_indices = lists
    out = []
    n = len(ts_list) - window + 1
    for i in range(max(n, 0)):
        sl = slice(i, i + window)
        out.append({
            "current_timestamps": ts_list[sl],
            "radar_id": radar_ids[sl],
            "odometry_timestamp": odo_ts[sl],
            "odometry_index": odo_idx[sl],
            "radar_data_indices": radar_indices[sl],
        })
    return out


class SequenceCache:
    """Memoised per-sequence data: radar table, odometry table, scenes."""

    def __init__(self, root: str, path: str, max_sequences: int = 4):
        self.root = root
        self.path = path
        with open(os.path.join(root, path, "sensors.json")) as f:
            self.mounts = json.load(f)
        self._load = functools.lru_cache(maxsize=max_sequences)(self._load_raw)

    def _load_raw(self, sequence_name: str):
        import h5py

        seq_dir = os.path.join(self.root, self.path, sequence_name)
        with h5py.File(os.path.join(seq_dir, "radar_data.h5"), "r") as f:
            radar = f["radar_data"][:]
            odometry = f["odometry"][:]
        with open(os.path.join(seq_dir, "scenes.json")) as f:
            scenes = json.load(f)
        return radar, odometry, walk_scenes(scenes)

    def windows(self, sequence_name: str, window_size: int) -> List[dict]:
        _, _, lists = self._load(sequence_name)
        return sliding_windows(lists, window_size)

    def mount(self, radar_id) -> dict:
        return self.mounts[f"radar_{radar_id}"]

    def extract_window(
        self,
        sequence_name: str,
        windowed: dict,
        reject_outlier_by_ransac: bool = False,
        flip_along_x: bool = False,
    ) -> dict:
        """extract_and_sync_radar_data + convert + get_data_for_datagen
        (read_data.py:227-303, 489-532), one windowed sample → data_dict."""
        radar, odometry, _ = self._load(sequence_name)

        px_l, py_l, vx_l, vy_l = [], [], [], []
        vr_l, rcs_l, ts_l, tid_l, sid_l, stat_l, lab_l = [], [], [], [], [], [], []
        ego_px, ego_py, ego_yaw = [], [], []

        for rd_idx, od_idx, radar_id in zip(
            windowed["radar_data_indices"],
            windowed["odometry_index"],
            windowed["radar_id"],
        ):
            rd = radar[rd_idx[0]:rd_idx[1]]
            od = odometry[od_idx]
            m = self.mount(radar_id)

            stat_l.append(
                identify_stationary_measurements(
                    rd["azimuth_sc"], rd["vr"],
                    m["x"], m["y"], m["yaw"],
                    od["vx"], od["yaw_rate"],
                    reject_outlier_by_ransac,
                )
            )
            ego_px.append(od["x_seq"])
            ego_py.append(od["y_seq"])
            ego_yaw.append(od["yaw_seq"])

            px_l.append(rd["x_cc"])
            py_l.append(rd["y_cc"])
            vx, vy = vr_cartesian_vf(
                rd["vr_compensated"], rd["azimuth_sc"], m["yaw"]
            )
            vx_l.append(vx)
            vy_l.append(vy)
            vr_l.append(rd["vr_compensated"])
            rcs_l.append(rd["rcs"])
            ts_l.append(rd["timestamp"])
            tid_l.append(rd["track_id"])
            sid_l.append(rd["sensor_id"])
            lab_l.append(rd["label_id"])

        px_l, py_l, vx_l, vy_l = ego_compensate_window(
            px_l, py_l, vx_l, vy_l, ego_px, ego_py, ego_yaw
        )

        cat = np.concatenate
        py = cat(py_l).astype(np.float32)
        vy = cat(vy_l).astype(np.float32)
        if flip_along_x:  # read_data.py:522-524
            py, vy = -py, -vy
        return {
            "meas_px": cat(px_l).astype(np.float32),
            "meas_py": py,
            "meas_vx": cat(vx_l).astype(np.float32),
            "meas_vy": vy,
            "meas_vr": cat(vr_l).astype(np.float32),
            "meas_rcs": cat(rcs_l).astype(np.float32),
            "meas_timestamp": cat(ts_l),
            "meas_trackid": cat(tid_l),
            "meas_sensorid": cat(sid_l),
            "stationary_meas_flag": cat(stat_l),
            "meas_label_id": cat(lab_l),
        }


def build_metadata(
    cache: SequenceCache, sequence_names: List[str], window_size: int
) -> List[dict]:
    """create_sequences_info_list_v2 (read_data.py:330-360)."""
    out = []
    for name in sequence_names:
        for w in cache.windows(name, window_size):
            out.append({"sequence_name": name, "data": w})
    return out


class RadarScenesDataset:
    """Map-style dataset over windowed metadata → padded graph samples."""

    def __init__(self, cfg, root: str, metadata: List[dict],
                 augment: bool = False, seed: int = 0,
                 dataset_path: Optional[str] = None,
                 cache: Optional[SequenceCache] = None):
        """``cache``: the sequences to read (``root`` and ``dataset_path``
        are then unused), such as ``data/mini_radarscenes``' in memory."""
        from .pipeline import pad_frame, preprocess_frame

        self.cfg = cfg
        if cache is None:
            cache = SequenceCache(root, dataset_path or cfg.dataset_dir)
        self.cache = cache
        self.metadata = metadata
        self.augment = augment
        self.rng = np.random.default_rng(seed)
        self._preprocess = preprocess_frame
        self._pad = pad_frame

    def __len__(self):
        return len(self.metadata)

    def __getitem__(self, idx: int):
        md = self.metadata[idx]
        flip = bool(self.augment and self.rng.random() >= 0.5)
        data = self.cache.extract_window(
            md["sequence_name"], md["data"],
            self.cfg.reject_static_meas_by_ransac, flip,
        )
        fr = self._preprocess(data, self.cfg)
        if fr is None:
            return None
        return self._pad(fr, self.cfg)

    def batches(self, batch_size: int, shuffle: bool = True):
        from .pipeline import stack_batch

        order = np.arange(len(self))
        while True:
            if shuffle:
                self.rng.shuffle(order)
            items = []
            for idx in order:
                item = self[int(idx)]
                if item is None:
                    continue
                items.append(item)
                if len(items) == batch_size:
                    yield stack_batch(items)
                    items = []
