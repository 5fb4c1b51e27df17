"""Ground-truth computation: node classes, offsets, edge links, clusters.

Mirrors modules/compute_groundtruth/* with the per-track python loops
replaced by np.unique inverse-index vectorisation, and adds the segment-id
cluster representation the TPU model consumes (node2cluster) in place of the
reference's list-of-index-tensors (datagen_gnn.py:15-45).

The port's own copy of the JAX package's ``data/groundtruth.py`` (numpy only), kept
so that the port imports nothing of that package.
"""

from __future__ import annotations

import numpy as np

from .labels import ID_FALSE, ID_STATIC, old_to_new_label_id_map


def gt_offsets(meas_px, meas_py, meas_trackid):
    """Per-node offset to its track's mean position
    (compute_node_labels.py:50-67); nodes without a track get 0."""
    n = meas_px.shape[0]
    offx = np.zeros(n, dtype=np.float32)
    offy = np.zeros(n, dtype=np.float32)
    tracked = meas_trackid != b""
    if np.any(tracked):
        uniq, inv = np.unique(meas_trackid[tracked], return_inverse=True)
        cnt = np.bincount(inv, minlength=len(uniq)).astype(np.float64)
        mx = np.bincount(inv, weights=meas_px[tracked], minlength=len(uniq)) / cnt
        my = np.bincount(inv, weights=meas_py[tracked], minlength=len(uniq)) / cnt
        offx[tracked] = (mx[inv] - meas_px[tracked]).astype(np.float32)
        offy[tracked] = (my[inv] - meas_py[tracked]).astype(np.float32)
    return offx, offy


def gt_node_classes(meas_trackid, stationary_flag, meas_label_id,
                    labels_to_id=None, lut=None):
    """compute_node_labels.py:70-86: tracked → remapped label; untracked &
    stationary → STATIC; untracked & moving → FALSE (clutter)."""
    if lut is None:
        lut = old_to_new_label_id_map()
    cls = np.zeros(meas_label_id.shape[0], dtype=np.float32)
    clutter = (meas_trackid == b"") & (~stationary_flag)
    static_env = (meas_trackid == b"") & stationary_flag
    tracked = meas_trackid != b""
    remapped = lut[meas_label_id]
    cls[tracked] = remapped[tracked]
    cls[clutter] = ID_FALSE
    cls[static_env] = ID_STATIC
    return cls


def compute_ground_truth_node(data: dict, labels_to_id=None, lut=None) -> dict:
    """compute_node_labels.py:89-105."""
    offx, offy = gt_offsets(data["meas_px"], data["meas_py"], data["meas_trackid"])
    cls = gt_node_classes(
        data["meas_trackid"], data["stationary_meas_flag"],
        data["meas_label_id"], labels_to_id, lut,
    )
    return {"offsetx": offx, "offsety": offy, "class_labels": cls}


def gt_edge_labels(meas_trackid, adj_list, adj_matrix):
    """Link label per *undirected triu* edge (compute_edge_labels.py:7-20):
    1 iff both endpoints share a non-empty track id, enumerated in the
    row-major triu order of the adjacency matrix."""
    src_id = meas_trackid[adj_list[0]]
    dst_id = meas_trackid[adj_list[1]]
    valid = (src_id == dst_id) & (src_id != b"")
    mat = np.zeros_like(adj_matrix)
    mat[adj_list[0], adj_list[1]] = valid
    rows, cols = np.nonzero(np.triu(adj_matrix, k=1))
    return mat[rows, cols].astype(np.float32)


def gt_edge_labels_from_und(meas_trackid, und_senders, und_receivers):
    """Link labels directly on the undirected edge list — equivalent to
    gt_edge_labels (link validity is symmetric, so reading the directed
    validity matrix at triu positions equals evaluating on und pairs)."""
    s_id = meas_trackid[und_senders]
    r_id = meas_trackid[und_receivers]
    return ((s_id == r_id) & (s_id != b"")).astype(np.float32)


def gt_clusters(meas_trackid, gt_labels_dyn):
    """Cluster decomposition (datagen_gnn.py:15-45): one cluster per unique
    track id (in np.unique order), then one singleton cluster per untracked
    node (in node order).

    Returns:
      node2cluster: [N] int32 cluster slot per node
      cluster_class: [C] int32
    """
    n = meas_trackid.shape[0]
    node2cluster = np.full(n, -1, dtype=np.int32)
    cluster_class = []
    tracked = meas_trackid != b""
    uniq = np.unique(meas_trackid[tracked]) if np.any(tracked) else np.array([], dtype=meas_trackid.dtype)
    for ci, tid in enumerate(uniq):
        flag = meas_trackid == tid
        node2cluster[flag] = ci
        cluster_class.append(int(gt_labels_dyn[flag][0]))
    next_c = len(uniq)
    for i in range(n):
        if meas_trackid[i] == b"":
            node2cluster[i] = next_c
            cluster_class.append(int(gt_labels_dyn[i]))
            next_c += 1
    return node2cluster, np.asarray(cluster_class, dtype=np.int32)


def cluster_mean_cov(points: np.ndarray, meas_noise_cov: np.ndarray):
    """Sample mean + Bessel-corrected covariance with measurement-noise floor
    (compute_node_labels.py:12-25)."""
    mu = np.sum(points, axis=0) / points.shape[0]
    if points.shape[0] > 1:
        err = (mu[:2] - points[:, :2])[:, :, None]
        sigma = np.sum(err @ err.transpose(0, 2, 1), axis=0) / (points.shape[0] - 1)
        sigma = sigma + meas_noise_cov
    else:
        sigma = meas_noise_cov
    return mu, sigma


def normalize_offsets(offsets, mu, sigma):
    """compute_offsets.py:6-11 (pure, unlike the reference's in-place)."""
    out = np.array(offsets, copy=True)
    out[..., 0] = (out[..., 0] - mu[0]) / sigma[0]
    out[..., 1] = (out[..., 1] - mu[1]) / sigma[1]
    return out


def unnormalize_offsets(offsets, mu, sigma):
    """compute_offsets.py:13-18 (pure)."""
    out = np.array(offsets, copy=True)
    out[..., 0] = out[..., 0] * sigma[0] + mu[0]
    out[..., 1] = out[..., 1] * sigma[1] + mu[1]
    return out
