"""Stationary-measurement identification: odometry gating + RANSAC (numpy).

The port's copy of the JAX package's ``data/selection.py``; RANSAC draws
from a ``np.random.Generator``, so one seed draws the JAX package's
samples.  Reimplements modules/data_utils/meas_selection.py with the scalar
accumulation loops replaced by vectorised numpy (the reference's
``estimate_sensor_vx_vy`` builds its normal equations element-by-element;
here it is two dot products), and the 30-iteration RANSAC loop batched into
a single [I, S] gather + lstsq sweep.
"""

from __future__ import annotations

import numpy as np

# reference modules/data_utils/constants.py:6-15
RANSAC_MIN_NUM_SAMPLES = 2
RANSAC_ERROR_MARGIN = 0.25
RANSAC_NUM_ITERATIONS = 30
INLIER_RATIO_THRESHOLD = 0.6
MIN_NUM_MEAS = 10
GAMMA_STATIONARY = 1.5


def rotate_vx_vy(vx, vy, theta):
    """meas_selection.py:11-19."""
    c, s = np.cos(theta), np.sin(theta)
    return vx * c - vy * s, vx * s + vy * c


def sensor_velocity_from_ego(vx_ego, vy_ego, yawrate_ego, tx, ty, theta):
    """Velocity of the sensor origin, rotated into the sensor frame
    (meas_selection.py:22-34)."""
    vx_s = vx_ego - yawrate_ego * ty
    vy_s = vy_ego + yawrate_ego * tx
    return rotate_vx_vy(vx_s, vy_s, -theta)


def predict_range_rate(vx_ego, vy_ego, yawrate_ego, meas_theta, tx, ty, theta):
    """Expected stationary-world range-rate at each azimuth
    (meas_selection.py:37-50)."""
    vx_s, vy_s = sensor_velocity_from_ego(vx_ego, vy_ego, yawrate_ego, tx, ty, theta)
    return -(vx_s * np.cos(meas_theta) + vy_s * np.sin(meas_theta))


def gate_stationary(vx_ego, vy_ego, yawrate_ego, z_azimuth, z_vr, tx, ty, theta,
                    gamma: float = GAMMA_STATIONARY):
    """|predicted vr − measured vr| <= gamma (meas_selection.py:53-69)."""
    vr_pred = predict_range_rate(vx_ego, vy_ego, yawrate_ego, z_azimuth, tx, ty, theta)
    error = vr_pred - z_vr
    return np.abs(error) <= gamma, error


def estimate_sensor_vx_vy(meas_theta, meas_vr):
    """Least-squares radar ego-motion from stationary returns
    (meas_selection.py:72-93), vectorised normal equations."""
    c, s = np.cos(meas_theta), np.sin(meas_theta)
    n = meas_theta.shape[0]
    a00 = np.sum(c * c)
    a01 = 0.5 * np.sum(np.sin(2.0 * meas_theta))
    A = np.array([[a00, a01], [a01, n - a00]])
    b = np.array([-np.sum(c * meas_vr), -np.sum(s * meas_vr)])
    x = np.linalg.solve(A, b)
    return x[0], x[1]


def ransac(z: np.ndarray, rng: np.random.Generator | None = None):
    """RANSAC inlier selection over (azimuth, vr) pairs
    (meas_selection.py:96-166).  All iterations are evaluated in one
    vectorised sweep.  Returns (inliers_flag, is_valid, inlier_ratio)."""
    rng = rng or np.random.default_rng()
    num_meas = z.shape[0]
    if num_meas <= MIN_NUM_MEAS:
        return np.zeros(num_meas, dtype=bool), False, 0.0

    iters, m = RANSAC_NUM_ITERATIONS, RANSAC_MIN_NUM_SAMPLES
    # [I, N] independent permutations
    perm = np.argsort(rng.random((iters, num_meas)), axis=1)
    sample_idx = perm[:, :m]  # [I, m]
    test_idx = perm[:, m:]

    theta_s = z[sample_idx, 0]
    vr_s = z[sample_idx, 1]

    # Closed-form 2x2 solve per iteration.
    c, s = np.cos(theta_s), np.sin(theta_s)
    a00 = np.sum(c * c, axis=1)
    a01 = 0.5 * np.sum(np.sin(2.0 * theta_s), axis=1)
    a11 = m - a00
    b0 = -np.sum(c * vr_s, axis=1)
    b1 = -np.sum(s * vr_s, axis=1)
    det = a00 * a11 - a01 * a01
    det = np.where(np.abs(det) < 1e-12, 1e-12, det)
    vx = (a11 * b0 - a01 * b1) / det
    vy = (a00 * b1 - a01 * b0) / det

    theta_t = z[test_idx, 0]
    vr_t = z[test_idx, 1]
    pred = -(vx[:, None] * np.cos(theta_t) + vy[:, None] * np.sin(theta_t))
    err = np.abs(vr_t - pred)
    n_in = np.sum(err <= RANSAC_ERROR_MARGIN, axis=1)
    ratio = (n_in + m) / num_meas

    best = int(np.argmax(n_in))
    pred_all = -(vx[best] * np.cos(z[:, 0]) + vy[best] * np.sin(z[:, 0]))
    inliers = np.abs(z[:, 1] - pred_all) <= RANSAC_ERROR_MARGIN
    return inliers, bool(ratio[best] >= INLIER_RATIO_THRESHOLD), float(ratio[best])


def identify_stationary_measurements(
    z_azimuth, z_vr, tx, ty, theta, vx_odom, yawrate_odom,
    reject_outlier_by_ransac: bool = False,
    rng: np.random.Generator | None = None,
):
    """meas_selection.py:169-200."""
    flag, _ = gate_stationary(vx_odom, 0.0, yawrate_odom, z_azimuth, z_vr, tx, ty, theta)
    if not reject_outlier_by_ransac:
        return flag
    z = np.stack([z_azimuth, z_vr], axis=1)
    inliers, _, _ = ransac(z[flag], rng=rng)
    out = np.zeros(z.shape[0], dtype=bool)
    out[np.flatnonzero(flag)] = inliers
    return out
