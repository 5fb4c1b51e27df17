"""The port's on-device graph build (``ops/graph_build.py``) against the JAX
package's on the CPU: indices, masks and degree equal; features within
rtol 1e-6 / atol 1e-6 (two compilers' float32 roundings).  The frames
include duplicated points (exact distance ties, which must go to the lowest
index as ``lax.top_k`` breaks them), fewer valid nodes than k, both
``union_ball`` values, and capacities that overflow."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from graph_neural_network_for_radar_perception_torch.ops import graph_build as T
from graph_neural_network_for_radar_perception_tpu.ops import graph_build as J
from torch_port_fixtures import one_torch_thread  # noqa: F401  (autouse)

FEAT_TOL = dict(rtol=1e-6, atol=1e-6)


def _frame(seed, n_cap=64, n_valid=50, dups=True):
    rng = np.random.default_rng(seed)
    pts = rng.uniform(0, 12, (n_cap, 2)).astype(np.float32)
    if dups:  # exact ties: repeated points, and a point equidistant to two
        pts[3] = pts[7]
        pts[10] = pts[11] = pts[12]
        pts[20] = pts[21] + np.float32([1.0, 0.0])
        pts[22] = pts[21] - np.float32([1.0, 0.0])
    mask = np.arange(n_cap) < n_valid
    cols = {name: rng.normal(size=n_cap).astype(np.float32)
            for name in ("vx", "vy", "vr", "rcs")}
    cols["ts"] = rng.uniform(0, 6e5, n_cap).astype(np.float32)
    return pts, mask, cols


def _t(x):
    return torch.from_numpy(np.asarray(x))


def _j(x):
    return jnp.asarray(np.asarray(x))


def _equal(got, want, what=""):
    g, w = got.numpy(), np.asarray(want)
    assert g.dtype == w.dtype and g.shape == w.shape, what
    np.testing.assert_array_equal(g, w, err_msg=what)


@pytest.mark.parametrize("n_valid", [64, 50, 5, 0])
def test_pairwise_and_ball_degree(n_valid):
    pts, mask, _ = _frame(0, n_valid=n_valid)
    d2 = T.pairwise_sq_dist(_t(pts), _t(mask))
    _equal(d2, J.pairwise_sq_dist(_j(pts), _j(mask)), "d2")
    for eps in (0.5, 4.0):
        _equal(T.ball_query_degree(d2, eps), J.ball_query_degree(_j(d2), eps), "degree")


@pytest.mark.parametrize("k", [1, 4, 10, 80])
@pytest.mark.parametrize("n_valid", [64, 50, 5])
def test_knn_adjacency_with_ties(k, n_valid):
    pts, mask, _ = _frame(1, n_valid=n_valid)
    d2 = T.pairwise_sq_dist(_t(pts), _t(mask))
    _equal(T.knn_adjacency_matrix(d2, _t(mask), k),
           J.knn_adjacency_matrix(_j(d2), _j(mask), k), "adj")


@pytest.mark.parametrize("capacity", [0, 1, 37, 400, 5000])
def test_compact_nonzero(capacity):
    flag = np.random.default_rng(2).random((40, 30)) < 0.2
    got = T.compact_nonzero(_t(flag), capacity)
    want = J.compact_nonzero(_j(flag), capacity)
    for name, g, w in zip(("rows", "cols", "mask"), got, want):
        _equal(g, w, name)
    n = min(capacity, int(flag.sum()))
    rows, cols = np.nonzero(flag)
    np.testing.assert_array_equal(got[0][:n].numpy(), rows[:n])
    np.testing.assert_array_equal(got[1][:n].numpy(), cols[:n])


@pytest.mark.parametrize("union_ball", [False, True], ids=["knn", "knn_or_ball"])
@pytest.mark.parametrize("n_valid, k, e_cap, eu_cap", [
    (50, 10, 1600, 800),   # room for every edge
    (5, 10, 100, 50),      # n_valid <= k: all valid pairs connect
    (50, 10, 200, 60),     # both edge lists overflow
    (64, 3, 700, 350),     # every node valid
])
def test_build_graph_structure(union_ball, n_valid, k, e_cap, eu_cap):
    pts, mask, _ = _frame(3, n_valid=n_valid)
    kw = dict(k=k, eps_sq=2.0, edge_capacity=e_cap, und_capacity=eu_cap,
              union_ball=union_ball)
    got = T.build_graph_structure(_t(pts), _t(mask), **kw)
    want = J.build_graph_structure(_j(pts), _j(mask), **kw)
    assert got._fields == want._fields
    for name, g, w in zip(got._fields, got, want):
        _equal(g, w, name)
    assert int(got.edge_mask.sum()) > 0


@pytest.mark.parametrize("n_valid", [50, 1, 0])
def test_normalize_time(n_valid):
    _, mask, cols = _frame(4, n_valid=n_valid)
    got = T.normalize_time(_t(cols["ts"]), _t(mask))
    want = J.normalize_time(_j(cols["ts"]), _j(mask))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **FEAT_TOL)


@pytest.mark.parametrize("region", [True, False])
def test_node_and_edge_features(region):
    pts, mask, c = _frame(5)
    gs = T.build_graph_structure(_t(pts), _t(mask), k=10, eps_sq=2.0,
                                 edge_capacity=1600, und_capacity=800)
    js = J.build_graph_structure(_j(pts), _j(mask), k=10, eps_sq=2.0,
                                 edge_capacity=1600, und_capacity=800)
    px, py = pts[:, 0], pts[:, 1]
    kw = dict(min_range=0.0, max_range=100.0, min_azimuth=0.0, max_azimuth=1.5,
              include_region_confidence=region)
    got = T.compute_node_features_device(
        *map(_t, (c["vr"], c["rcs"], c["ts"], px, py)), gs.degree, _t(mask), **kw)
    want = J.compute_node_features_device(
        *map(_j, (c["vr"], c["rcs"], c["ts"], px, py)), js.degree, _j(mask), **kw)
    assert got.shape == (64, 6 if region else 4)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **FEAT_TOL)
    got = T.compute_edge_features_device(
        *map(_t, (px, py, c["vx"], c["vy"], c["ts"])), gs.senders, gs.receivers, gs.edge_mask)
    want = J.compute_edge_features_device(
        *map(_j, (px, py, c["vx"], c["vy"], c["ts"])), js.senders, js.receivers, js.edge_mask)
    assert got.shape == (1600, 7)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **FEAT_TOL)
