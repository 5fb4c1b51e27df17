"""The deterministic mini-RadarScenes sequences, made in memory.

The port's copy of the generator of ``tests/fixtures_radarscenes.py``
(``make_mini_radarscenes``), which writes each sequence as the dataset's
files (``radar_data.h5``, ``scenes.json``, ``sequences.json``,
``sensors.json``).  Here the same tables stay in memory behind a
``SequenceCache`` (``MemorySequenceCache``), so a host without ``h5py``
reads the same windows as one that reads the files.

The scene is a physically consistent world: an ego vehicle driving a
gentle arc, four interleaved radar sensors, a static background whose
range rates satisfy the stationary gate, and dynamic tracked objects.
Every table is a pure function of the seed.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np

from .radarscenes import SequenceCache, walk_scenes

RADAR_DTYPE = np.dtype([
    ("timestamp", np.int64),
    ("sensor_id", np.uint8),
    ("range_sc", np.float32),
    ("azimuth_sc", np.float32),
    ("rcs", np.float32),
    ("vr", np.float32),
    ("vr_compensated", np.float32),
    ("x_cc", np.float32),
    ("y_cc", np.float32),
    ("x_seq", np.float32),
    ("y_seq", np.float32),
    ("uuid", "S32"),
    ("track_id", "S32"),
    ("label_id", np.uint8),
])

ODOMETRY_DTYPE = np.dtype([
    ("timestamp", np.int64),
    ("x_seq", np.float64),
    ("y_seq", np.float64),
    ("yaw_seq", np.float64),
    ("vx", np.float64),
    ("yaw_rate", np.float64),
])

# Front/corner radar mounts, vehicle frame (x fwd, y left, yaw ccw).
MOUNTS = {
    "radar_1": {"x": 3.66, "y": -0.87, "yaw": -1.48},
    "radar_2": {"x": 3.86, "y": -0.70, "yaw": -0.44},
    "radar_3": {"x": 3.86, "y": 0.70, "yaw": 0.44},
    "radar_4": {"x": 3.66, "y": 0.87, "yaw": 1.48},
}

Sequence = Tuple[np.ndarray, np.ndarray, dict]  # radar, odometry, scenes.json


def make_sequence(
    *,
    seed: int = 0,
    n_scenes: int = 24,
    pts_static: int = 30,
    n_objects: int = 3,
    seq_name: str = "sequence_1",
) -> Sequence:
    """One sequence's radar table, odometry table and scenes.json content,
    as ``make_mini_radarscenes`` writes them for the same arguments."""
    rng = np.random.default_rng(seed)
    dt_us = 60_000
    t0 = 1_000_000
    speed = 8.0
    yaw_rate = 0.02

    # Ego trajectory (sequence frame).
    ts = t0 + dt_us * np.arange(n_scenes)
    t_s = (ts - t0) / 1e6
    yaw = yaw_rate * t_s
    ex = np.cumsum(np.r_[0.0, speed * np.cos(yaw[:-1]) * np.diff(t_s)])
    ey = np.cumsum(np.r_[0.0, speed * np.sin(yaw[:-1]) * np.diff(t_s)])

    # World content (sequence frame).
    static_xy = rng.uniform([5.0, -40.0], [90.0, 40.0], (pts_static, 2))
    obj_xy0 = rng.uniform([15.0, -25.0], [70.0, 25.0], (n_objects, 2))
    obj_v = rng.uniform(-6.0, 6.0, (n_objects, 2))
    obj_label = rng.integers(0, 5, n_objects)  # car..large vehicle

    radar_rows = []
    odo_rows = []
    scenes = {}
    radar_start = 0
    sensor_cycle = [1, 2, 3, 4]
    for i in range(n_scenes):
        sid = sensor_cycle[i % 4]
        m = MOUNTS[f"radar_{sid}"]
        odo_rows.append((int(ts[i]), ex[i], ey[i], yaw[i], speed, yaw_rate))
        c, s = np.cos(yaw[i]), np.sin(yaw[i])

        def to_vehicle(p_seq):
            d = p_seq - np.array([ex[i], ey[i]])
            return np.stack([c * d[:, 0] + s * d[:, 1],
                             -s * d[:, 0] + c * d[:, 1]], 1)

        def to_vehicle_vec(v_seq):
            return np.stack([c * v_seq[:, 0] + s * v_seq[:, 1],
                             -s * v_seq[:, 0] + c * v_seq[:, 1]], 1)

        obj_xy = obj_xy0 + obj_v * t_s[i]
        pts, vels, tids, labels = [], [], [], []
        pts.append(to_vehicle(static_xy))
        vels.append(np.zeros((pts_static, 2)))
        tids += [b""] * pts_static
        labels += [11] * pts_static  # STATIC
        for k in range(n_objects):
            jitter = rng.normal(0.0, 0.3, (4, 2))
            pts.append(to_vehicle(obj_xy[None, k] + jitter))
            vels.append(to_vehicle_vec(np.tile(obj_v[k], (4, 1))))
            tids += [f"track_{k}".encode()] * 4
            labels += [int(obj_label[k])] * 4
        p_vf = np.concatenate(pts)
        v_vf = np.concatenate(vels)  # object velocity over ground, vf

        # Sensor-frame geometry.
        mc, ms = np.cos(m["yaw"]), np.sin(m["yaw"])
        d = p_vf - np.array([m["x"], m["y"]])
        p_sc = np.stack([mc * d[:, 0] + ms * d[:, 1],
                         -ms * d[:, 0] + mc * d[:, 1]], 1)
        rng_sc = np.linalg.norm(p_sc, axis=1)
        azi_sc = np.arctan2(p_sc[:, 1], p_sc[:, 0])
        # Keep only points in a ±60° sensor FoV.
        keep = np.abs(azi_sc) < np.deg2rad(60.0)

        # Radial velocity: (v_target − v_sensor)·r̂ in the vehicle frame,
        # the sensor's velocity from ego (vx, yaw_rate) at the mount.
        v_sens = np.array([speed - yaw_rate * m["y"], yaw_rate * m["x"]])
        r_hat = d / np.maximum(np.linalg.norm(d, axis=1, keepdims=True), 1e-9)
        vr = np.sum((v_vf - v_sens) * r_hat, axis=1).astype(np.float32)
        # vr_compensated: range rate with ego motion removed = v_target·r̂.
        vr_comp = np.sum(v_vf * r_hat, axis=1).astype(np.float32)

        idxs = np.flatnonzero(keep)
        n_i = idxs.size
        for j in idxs:
            px_seq = ex[i] + c * p_vf[j, 0] - s * p_vf[j, 1]
            py_seq = ey[i] + s * p_vf[j, 0] + c * p_vf[j, 1]
            radar_rows.append((
                int(ts[i]), sid, float(rng_sc[j]), float(azi_sc[j]),
                float(rng.normal(5.0, 2.0)), float(vr[j]),
                float(vr_comp[j]), float(p_vf[j, 0]), float(p_vf[j, 1]),
                float(px_seq), float(py_seq),
                f"uuid_{i}_{j}".encode(), tids[j], labels[j],
            ))
        scenes[str(int(ts[i]))] = {
            "sensor_id": sid,
            "odometry_timestamp": int(ts[i]),
            "odometry_index": i,
            "radar_indices": [radar_start, radar_start + n_i],
            "image_name": f"camera/{int(ts[i])}.jpg",
            "prev_timestamp": int(ts[i - 1]) if i > 0 else None,
            "next_timestamp": int(ts[i + 1]) if i + 1 < n_scenes else None,
            "prev_timestamp_same_sensor": int(ts[i - 4]) if i - 4 >= 0 else None,
            "next_timestamp_same_sensor": int(ts[i + 4]) if i + 4 < n_scenes else None,
        }
        radar_start += n_i

    radar = np.array(radar_rows, dtype=RADAR_DTYPE)
    odometry = np.array(odo_rows, dtype=ODOMETRY_DTYPE)
    return radar, odometry, {
        "sequence_name": seq_name,
        "first_timestamp": int(ts[0]),
        "last_timestamp": int(ts[-1]),
        "scenes": scenes,
    }


class MemorySequenceCache(SequenceCache):
    """A ``SequenceCache`` over sequences held in memory, by name (each as
    ``make_sequence`` returns it), with the fixture's mounts."""

    def __init__(self, sequences: Dict[str, Sequence]):
        self.mounts = MOUNTS
        tables = {name: (radar, odometry, walk_scenes(scenes))
                  for name, (radar, odometry, scenes) in sequences.items()}
        self._load = tables.__getitem__
