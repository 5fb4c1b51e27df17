"""Synthetic radar scene generator.

RadarScenes itself is not redistributable (the reference ships only license
placeholders under dataset/RadarScenesData), so tests, the overfit harness
and benchmarks run on synthetic frames with the same statistics and the
exact `data_dict` schema of the reference reader
(modules/data_utils/read_data.py:489-532): a 10-frame temporal window of
measurements already ego-compensated into the current vehicle frame, with
dynamic objects (track ids + 12-class labels), static background returns and
clutter.

The port's own copy of the JAX package's ``data/synthetic.py`` (numpy only), kept
so that the port imports nothing of that package.
"""

from __future__ import annotations

import numpy as np

from .labels import old_labels_to_id

# Plausible object extents (m) and point densities per class.
_CLASS_SPECS = {
    "CAR": dict(size=(4.5, 1.9), pts=(4, 14), speed=(3, 15)),
    "PEDESTRIAN": dict(size=(0.6, 0.6), pts=(1, 4), speed=(0.5, 2.0)),
    "PEDESTRIAN_GROUP": dict(size=(2.5, 2.5), pts=(4, 12), speed=(0.5, 2.0)),
    "BICYCLE": dict(size=(1.8, 0.6), pts=(2, 6), speed=(2, 8)),
    "TRUCK": dict(size=(9.0, 2.5), pts=(8, 24), speed=(3, 12)),
}


def make_synthetic_frame(
    rng: np.random.Generator,
    *,
    num_objects: int = 6,
    window_size: int = 10,
    clutter_per_frame: float = 3.0,
    static_per_frame: int = 40,
    roi=(0.0, 100.0, -50.0, 50.0),
    frame_dt_us: float = 60_000.0,
) -> dict:
    """Generate one windowed radar frame in reference data_dict schema."""
    min_x, max_x, min_y, max_y = roi
    old_ids = old_labels_to_id()
    class_names = list(_CLASS_SPECS.keys())

    px, py, vx, vy, vr, rcs, ts = [], [], [], [], [], [], []
    trackid, sensorid, stat_flag, label_id = [], [], [], []

    def emit(x, y, velx, vely, tid, lab, stationary, t_us):
        n = x.shape[0]
        px.append(x); py.append(y)
        vx.append(velx); vy.append(vely)
        # vr ≈ projection of velocity on the radial direction + noise
        r = np.sqrt(x**2 + y**2) + 1e-6
        vr.append((velx * x + vely * y) / r + rng.normal(0, 0.05, n))
        rcs.append(rng.normal(-5.0, 8.0, n))
        ts.append(np.full(n, t_us))
        trackid.extend([tid] * n)
        sensorid.append(np.full(n, rng.integers(1, 5), dtype=np.int32))
        stat_flag.append(np.full(n, stationary, dtype=bool))
        label_id.append(np.full(n, lab, dtype=np.int32))

    # Dynamic objects: linear motion across the window, points scattered over
    # the object's extent, shared track id.
    for obj in range(num_objects):
        cname = class_names[rng.integers(len(class_names))]
        spec = _CLASS_SPECS[cname]
        cx = rng.uniform(min_x + 10, max_x - 10)
        cy = rng.uniform(min_y + 10, max_y - 10)
        speed = rng.uniform(*spec["speed"])
        heading = rng.uniform(-np.pi, np.pi)
        ovx, ovy = speed * np.cos(heading), speed * np.sin(heading)
        tid = f"trk_{obj}".encode()
        lab = old_ids[cname]
        sx, sy = spec["size"]
        for w in range(window_size):
            t_rel = (w - (window_size - 1)) * frame_dt_us * 1e-6
            n = int(rng.integers(*spec["pts"]))
            if n == 0:
                continue
            x = cx + ovx * t_rel + rng.uniform(-sx / 2, sx / 2, n)
            y = cy + ovy * t_rel + rng.uniform(-sy / 2, sy / 2, n)
            emit(
                x, y,
                np.full(n, ovx) + rng.normal(0, 0.1, n),
                np.full(n, ovy) + rng.normal(0, 0.1, n),
                tid, lab, False, w * frame_dt_us,
            )

    # Static background.
    for w in range(window_size):
        n = static_per_frame
        x = rng.uniform(min_x, max_x, n)
        y = rng.uniform(min_y, max_y, n)
        emit(x, y, rng.normal(0, 0.02, n), rng.normal(0, 0.02, n),
             b"", old_ids["STATIC"], True, w * frame_dt_us)

    # Clutter: untracked, non-stationary (labelled FALSE downstream).
    for w in range(window_size):
        n = int(rng.poisson(clutter_per_frame))
        if n == 0:
            continue
        x = rng.uniform(min_x, max_x, n)
        y = rng.uniform(min_y, max_y, n)
        emit(x, y, rng.normal(0, 2.0, n), rng.normal(0, 2.0, n),
             b"", old_ids["STATIC"], False, w * frame_dt_us)

    data = {
        "meas_px": np.concatenate(px).astype(np.float32),
        "meas_py": np.concatenate(py).astype(np.float32),
        "meas_vx": np.concatenate(vx).astype(np.float32),
        "meas_vy": np.concatenate(vy).astype(np.float32),
        "meas_vr": np.concatenate(vr).astype(np.float32),
        "meas_rcs": np.concatenate(rcs).astype(np.float32),
        "meas_timestamp": np.concatenate(ts).astype(np.float64),
        "meas_trackid": np.asarray(trackid, dtype=object),
        "meas_sensorid": np.concatenate(sensorid),
        "stationary_meas_flag": np.concatenate(stat_flag),
        "meas_label_id": np.concatenate(label_id),
    }
    # np.unique & b'' comparisons need a proper bytes array.
    data["meas_trackid"] = np.array(
        [t for t in data["meas_trackid"]], dtype="S16"
    )
    return data
