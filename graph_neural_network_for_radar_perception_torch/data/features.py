"""Host-side (numpy) graph/feature computation with exact reference
semantics — the golden-path twin of ops/graph_build.py.

Mirrors modules/compute_features/graph_features.py behaviour function by
function so unit tests can diff the on-device builder against it; the device
builder (ops/graph_build.py) is what production uses.

The port's own copy of the JAX package's ``data/features.py`` (numpy only), kept
so that the port imports nothing of that package.
"""

from __future__ import annotations

import numpy as np

US2SEC = 1e-6

from .labels import ID_STATIC  # noqa: E402


def pairwise_sq_dist_np(px, py):
    """Dense squared-L2 matrix (graph_features.py:70-75; despite the
    docstring there, the reference compares *squared* distances)."""
    p = np.stack([px, py], axis=-1)
    diff = p[:, None, :] - p[None, :, :]
    return np.einsum("ijk,ijk->ij", diff, diff)


def ball_query_np(d2, eps_sq):
    """graph_features.py:11-22."""
    gated = d2 <= eps_sq
    np.fill_diagonal(gated, False)
    return gated


def knn_np(d2, k):
    """graph_features.py:25-44 — symmetrised kNN boolean adjacency."""
    n = d2.shape[0]
    order = np.argsort(d2, axis=-1, kind="stable")
    kk = n if k >= n else k + 1
    dst = order[:, :kk]
    src = np.repeat(np.arange(n)[:, None], kk, axis=1)
    adj = np.zeros((n, n), dtype=bool)
    adj[src.ravel(), dst.ravel()] = True
    adj |= adj.T
    np.fill_diagonal(adj, False)
    return adj


def adjacency_info(px, py, eps_sq, k, union_ball=False):
    """compute_adjacency_information[_v2] (graph_features.py:58-114).

    Returns dict with adj_matrix [N,N] bool, adj_list [2,E], degree [N]."""
    d2 = pairwise_sq_dist_np(px, py)
    ball = ball_query_np(d2, eps_sq)
    adj = knn_np(d2, k)
    if union_ball:
        adj = adj | ball
    degree = np.sum(ball, axis=-1)
    adj_list = np.stack(np.nonzero(adj), axis=0)
    return {
        "adj_matrix": adj,
        "distance_mat": d2,
        "adj_list": adj_list,
        "degree": degree,
    }


def normalize_time_np(ts):
    """graph_features.py:47-55."""
    tmax, tmin = np.max(ts), np.min(ts)
    if tmax == tmin:
        return ts - tmin
    return (ts - tmin) / (tmax - tmin)


def node_features_np(
    data, degree, *, include_region_confidence=True,
    min_range=None, max_range=None, min_azimuth=None, max_azimuth=None,
):
    """graph_features.py:117-144."""
    vr = data["meas_vr"]
    rcs = data["meas_rcs"]
    t_norm = normalize_time_np(data["meas_timestamp"])
    deg = degree / 10.0
    if include_region_confidence:
        r = np.sqrt(data["meas_px"] ** 2 + data["meas_py"] ** 2)
        th = np.abs(np.arctan2(data["meas_py"], data["meas_px"]))
        range_conf = (r - max_range) / (min_range - max_range)
        azi_conf = (th - max_azimuth) / (min_azimuth - max_azimuth)
        return np.stack([vr, rcs, t_norm, deg, range_conf, azi_conf], axis=-1)
    return np.stack([vr, rcs, t_norm, deg], axis=-1)


def edge_features_np(data, adj_list):
    """graph_features.py:147-164 (incl. the double-/10 dl quirk)."""
    s, r = adj_list[0], adj_list[1]
    px, py = data["meas_px"], data["meas_py"]
    dx = (px[s] - px[r]) / 10.0
    dy = (py[s] - py[r]) / 10.0
    dl = np.sqrt(dx**2 + dy**2) / 10.0
    dvx = data["meas_vx"][s] - data["meas_vx"][r]
    dvy = data["meas_vy"][s] - data["meas_vy"][r]
    dvl = np.sqrt(dvx**2 + dvy**2)
    dt = (data["meas_timestamp"][s] - data["meas_timestamp"][r]) * US2SEC
    return np.stack([dx, dy, dl, dvx, dvy, dvl, dt], axis=-1).astype(np.float32)


def select_moving(data: dict, gt: dict, static_id: int = ID_STATIC):
    """Drop STATIC-labelled measurements (graph_features.py:167-182)."""
    flag = gt["class_labels"] != static_id
    return (
        {k: v[flag] for k, v in data.items()},
        {k: v[flag] for k, v in gt.items()},
    )


def select_within_roi(data: dict, gt: dict, min_x, max_x, min_y, max_y):
    """100x100 m ROI box filter (grid_features.py:162-173)."""
    px, py = data["meas_px"], data["meas_py"]
    flag = (px >= min_x) & (px < max_x) & (py >= min_y) & (py < max_y)
    return (
        {k: v[flag] for k, v in data.items()},
        {k: v[flag] for k, v in gt.items()},
    )
