"""SE(2) pose algebra and ego-motion compensation, vectorised (numpy).

The port's copy of the JAX package's ``data/se2.py``.  Reimplements the reference's per-frame python loops
(modules/data_utils/meas_sync.py:23-103) as batched numpy over the whole
temporal window: one [W, 3, 3] pose stack, one relative-transform einsum.
The velocity vector is deliberately NOT rotated into the current frame —
the reference leaves velocities untouched (meas_sync.py:67-68) and parity
requires matching that.
"""

from __future__ import annotations

import numpy as np


def vel_polar_to_cart(vr, px, py):
    """meas_sync.py:8-12 — project range-rate along the position azimuth."""
    azi = np.arctan2(py, px)
    return vr * np.cos(azi), vr * np.sin(azi)


def vr_cartesian_vf(vr, azi_angle, mount_yaw):
    """meas_sync.py:15-20 — range-rate to (vx, vy) in the vehicle frame."""
    angle = azi_angle + mount_yaw
    return vr * np.cos(angle), vr * np.sin(angle)


def se2(px, py, theta) -> np.ndarray:
    """Pose(s) → homogeneous transform(s).  Scalars give [3,3]; arrays of
    shape [W] give [W,3,3] (vectorised version of meas_sync.py:23-31)."""
    px, py, theta = np.broadcast_arrays(
        np.asarray(px, dtype=np.float64),
        np.asarray(py, dtype=np.float64),
        np.asarray(theta, dtype=np.float64),
    )
    c, s = np.cos(theta), np.sin(theta)
    T = np.zeros(theta.shape + (3, 3))
    T[..., 0, 0] = c
    T[..., 0, 1] = -s
    T[..., 1, 0] = s
    T[..., 1, 1] = c
    T[..., 0, 2] = px
    T[..., 1, 2] = py
    T[..., 2, 2] = 1.0
    return T


def se2_inverse(T: np.ndarray) -> np.ndarray:
    """Closed-form inverse (meas_sync.py:34-41), batched."""
    R = T[..., :2, :2]
    t = T[..., :2, 2:]
    Rt = np.swapaxes(R, -1, -2)
    out = np.zeros_like(T)
    out[..., :2, :2] = Rt
    out[..., :2, 2:] = -Rt @ t
    out[..., 2, 2] = 1.0
    return out


def seq_to_car(x_seq, y_seq, ego_px, ego_py, ego_yaw):
    """Global (sequence) coordinates → vehicle (car) frame at the given ego
    pose.  Capability parity with the vendored helper package's
    ``transform_detections_sequence_to_car``
    (dataset/radar_scenes/radar_scenes/coordinate_transformation.py:15-48),
    expressed through this module's SE(2) algebra: p_car = T_ego⁻¹ · p_seq.
    """
    T_inv = se2_inverse(se2(ego_px, ego_py, ego_yaw))
    p = T_inv[..., :2, :2] @ np.stack(
        np.broadcast_arrays(np.asarray(x_seq, np.float64),
                            np.asarray(y_seq, np.float64)), axis=-2,
    ) + T_inv[..., :2, 2:]
    return p[..., 0, :], p[..., 1, :]


def car_to_seq(x_car, y_car, ego_px, ego_py, ego_yaw):
    """Inverse of :func:`seq_to_car`: vehicle frame → global (sequence)
    coordinates, p_seq = T_ego · p_car.  (The vendored package only ships
    the forward direction; the inverse falls out of the same algebra.)"""
    T = se2(ego_px, ego_py, ego_yaw)
    p = T[..., :2, :2] @ np.stack(
        np.broadcast_arrays(np.asarray(x_car, np.float64),
                            np.asarray(y_car, np.float64)), axis=-2,
    ) + T[..., :2, 2:]
    return p[..., 0, :], p[..., 1, :]


def ego_compensate_window(
    px_list, py_list, vx_list, vy_list,
    ego_px, ego_py, ego_yaw,
):
    """Transform each frame's measurements into the *last* frame's vehicle
    frame (meas_sync.py:52-103).  Positions are rotated+translated by
    T_curr⁻¹ @ T_prev; velocities pass through unchanged (reference parity).

    Args are lists of per-frame arrays plus per-frame ego poses.
    Returns lists of the same structure.
    """
    T = se2(np.asarray(ego_px), np.asarray(ego_py), np.asarray(ego_yaw))
    T_rel = se2_inverse(T[-1]) @ T  # [W, 3, 3]
    out_px, out_py = [], []
    for w, (px, py) in enumerate(zip(px_list, py_list)):
        R = T_rel[w, :2, :2]
        t = T_rel[w, :2, 2]
        p = R @ np.stack([px, py], axis=0) + t[:, None]
        out_px.append(p[0].astype(np.float64))
        out_py.append(p[1].astype(np.float64))
    return out_px, out_py, list(vx_list), list(vy_list)
