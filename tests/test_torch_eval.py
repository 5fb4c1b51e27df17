"""The port's evaluation against the JAX package's: the numpy metrics
(confusion, precision/recall, 1−IoU greedy association and its raw lists),
the cluster-feature and ellipse helpers of ``infer/proposals.py``, the
sequence drivers over ``FrameDetector``, and the committed fixture-trained
weights (read by the port's own msgpack reader) scored on the held-out
fixture sequence 5, whose per-sequence JSONs must equal the JAX drivers'."""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fixtures_radarscenes import make_mini_radarscenes
from graph_neural_network_for_radar_perception_torch.config.config import GNNConfig
from graph_neural_network_for_radar_perception_torch.data import radarscenes as TRS
from graph_neural_network_for_radar_perception_torch.data import synthetic as TSY
from graph_neural_network_for_radar_perception_torch.data.pipeline import (
    preprocess_frame as t_preprocess,
)
from graph_neural_network_for_radar_perception_torch.eval import drivers as TD
from graph_neural_network_for_radar_perception_torch.eval import metrics as TM
from graph_neural_network_for_radar_perception_torch.infer import pipeline as TPI
from graph_neural_network_for_radar_perception_torch.infer import proposals as TPR
from graph_neural_network_for_radar_perception_torch.utils.checkpoint import (
    load_params_msgpack as t_load_params_msgpack,
)
from graph_neural_network_for_radar_perception_torch.utils.convert import (
    state_dict_from_flax,
)
from graph_neural_network_for_radar_perception_tpu.config import config as JC
from graph_neural_network_for_radar_perception_tpu.data import radarscenes as JRS
from graph_neural_network_for_radar_perception_tpu.data.pipeline import (
    preprocess_frame as j_preprocess,
)
from graph_neural_network_for_radar_perception_tpu.eval import drivers as JD
from graph_neural_network_for_radar_perception_tpu.eval import metrics as JM
from graph_neural_network_for_radar_perception_tpu.infer import pipeline as JPI
from graph_neural_network_for_radar_perception_tpu.infer import proposals as JPR
from graph_neural_network_for_radar_perception_tpu.train.steps import init_params
from graph_neural_network_for_radar_perception_tpu.utils.checkpoint import (
    load_params_msgpack as j_load_params_msgpack,
)
from torch_port_fixtures import jax_native, one_torch_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARTIFACT = os.path.join(REPO, "runs", "fixture_artifact")
WINDOW = 5
# Proposal helpers: f32 eigh/matmul on two backends.
HELPER_RTOL, HELPER_ATOL = 1e-5, 1e-5


def _same_result(a, b):
    """Two AssociationResults (or tuples) hold the same arrays."""
    for x, y in zip(a, b):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))


# --- metrics ------------------------------------------------------------

ASSOCIATION_CASES = {
    # test_infer_eval.py: greedy 1−IoU, the never-associated pred left out
    "greedy_iou": ([np.array([0, 1, 2]), np.array([5, 6])],
                   [np.array([0, 1]), np.array([8, 9]), np.array([5, 6])],
                   np.array([0, 1]), np.array([0, 3, 1]), 10),
    # a pair beyond eps: the prediction against GT class FALSE
    "far_becomes_false": ([np.array([0, 1, 2])], [np.array([7, 8])],
                          np.array([2]), np.array([4]), 10),
    "both_sides": ([np.array([0, 1]), np.array([2, 3])], [np.array([0, 1])],
                   np.array([1, 2]), np.array([1]), 6),
    "gt_only": ([np.array([0, 1])], [], np.array([3]), np.zeros((0,)), 4),
    "pred_only": ([], [np.array([0])], np.zeros((0,)), np.array([4]), 4),
    "both_empty": ([], [], np.zeros((0,)), np.zeros((0,)), 4),
}


@pytest.mark.parametrize("case", sorted(ASSOCIATION_CASES))
def test_association_matches_jax(case):
    gm, pm, gc, pc, n = ASSOCIATION_CASES[case]
    got = TM.compute_associations(gm, pm, gc, pc, n_nodes=n, eps=0.7)
    want = JM.compute_associations(gm, pm, gc, pc, n_nodes=n, eps=0.7)
    for field in ("gt_associated", "pred_associated", "obj_class_gt",
                  "obj_class_pred"):
        np.testing.assert_array_equal(getattr(got, field), getattr(want, field))
    _same_result(got, want)  # tuple unpacking
    _same_result(TM.associate_clusters(gm, pm, gc, pc, n_nodes=n),
                 JM.associate_clusters(gm, pm, gc, pc, n_nodes=n))
    pairs = set(zip(got.gt_associated.astype(int), got.pred_associated.astype(int)))
    if case == "greedy_iou":
        assert pairs == {(1, 1), (0, 0)}
    if case == "far_becomes_false":
        assert pairs == {(6, 4)}


@pytest.mark.parametrize("criteria", ["inv_iou", "l2_norm"])
def test_random_associations_match_jax(rng, criteria):
    for _ in range(20):
        n = 40
        node2c = rng.integers(0, 6, n)
        pred2c = rng.integers(0, 7, n)
        gm = [np.flatnonzero(node2c == c) for c in range(6) if (node2c == c).any()]
        pm = [np.flatnonzero(pred2c == c) for c in range(7) if (pred2c == c).any()]
        gc = rng.integers(0, 7, len(gm))
        pc = rng.integers(0, 7, len(pm))
        xy = rng.normal(size=(n, 2))
        means = [np.stack([xy[m].mean(0) for m in ms]) for ms in (gm, pm)]
        kw = dict(n_nodes=n, eps=0.7 if criteria == "inv_iou" else 1.0,
                  criteria=criteria, gt_means=means[0], pred_means=means[1])
        _same_result(TM.compute_associations(gm, pm, gc, pc, **kw),
                     JM.compute_associations(gm, pm, gc, pc, **kw))
        np.testing.assert_array_equal(TM.membership_iou_matrix(gm, pm, n),
                                      JM.membership_iou_matrix(gm, pm, n))


def test_confusion_precision_recall_match_jax(rng):
    gt, pred = rng.integers(0, 7, 500), rng.integers(0, 7, 500)
    np.testing.assert_array_equal(TM.confusion_matrix(gt, pred, 7),
                                  JM.confusion_matrix(gt, pred, 7))
    cm = np.zeros((7, 7), np.int64)
    cm[0, 0], cm[0, 1], cm[5, 5] = 8, 2, 100  # NONE must be dropped
    cm[3, 3] = 0
    got, want = TM.precision_recall(cm), JM.precision_recall(cm)
    assert 5 not in got["classes"].tolist()
    for k in ("classes", "precision", "recall", "confusion"):
        np.testing.assert_array_equal(got[k], want[k])
    np.testing.assert_allclose(got["recall"][0], 0.8)
    np.testing.assert_allclose(got["precision"][0], 1.0)


def test_accumulator_and_size_filter_match_jax(rng):
    t, j = TM.ConfusionAccumulator(7), JM.ConfusionAccumulator(7)
    for _ in range(3):
        gt, pred = rng.integers(0, 7, 50), rng.integers(0, 7, 50)
        t.update(gt, pred)
        j.update(gt, pred)
        t.raw_gt.append(gt[:3])
        j.raw_gt.append(gt[:3])
    other_t, other_j = TM.ConfusionAccumulator(7), JM.ConfusionAccumulator(7)
    other_t.update(np.array([1, 2]), np.array([2, 2]))
    other_j.update(np.array([1, 2]), np.array([2, 2]))
    other_t.raw_pred.append(np.array([4]))
    other_j.raw_pred.append(np.array([4]))
    t.merge(other_t)
    j.merge(other_j)
    assert t.to_json_dict() == j.to_json_dict()
    _same_result(t.raw_gt, j.raw_gt)
    _same_result(t.raw_pred, j.raw_pred)
    members = [np.arange(k) for k in (1, 3, 2, 5)]
    args = (members, [m * 1.0 for m in members], [None] * 4, [m.size for m in members],
            [0, 1, 2, 3], 2)
    for a, b in zip(TM.filter_clusters_by_size(*args), JM.filter_clusters_by_size(*args)):
        assert len(a) == len(b) == 2
        for x, y in zip(a, b):
            np.testing.assert_array_equal(np.asarray(x, dtype=float),
                                          np.asarray(y, dtype=float))


# --- proposal helpers -----------------------------------------------------

def _column_signs(got_evecs, want_evecs):
    """±1 per eigenvector column: the sign that maps want onto got."""
    return np.sign(np.sum(got_evecs * want_evecs, axis=0))


@pytest.mark.parametrize("m_valid", [2, 7, 16])
def test_rotation_invariant_features_match_jax_up_to_sign(rng, m_valid):
    """r equal; x', y' equal up to the sign of their eigenvector, and θ the
    angle of the sign-matched point (no canonical sign: each backend keeps
    its eigh's)."""
    m = 16
    xy = (rng.normal(size=(m, 2)) * [3.0, 0.7] + [20.0, -4.0]).astype(np.float32)
    mask = np.arange(m) < m_valid
    got = TPR.rotation_invariant_cluster_features(torch.from_numpy(xy),
                                                  torch.from_numpy(mask)).numpy()
    want = np.asarray(JPR.rotation_invariant_cluster_features(jnp.asarray(xy),
                                                              jnp.asarray(mask)))
    assert np.all(got[~mask] == 0.0)
    np.testing.assert_allclose(got[:, 2], want[:, 2], rtol=HELPER_RTOL, atol=HELPER_ATOL)
    signs = np.where(np.sum(got[mask, :2] * want[mask, :2], axis=0) < 0, -1.0, 1.0)
    np.testing.assert_allclose(got[:, :2], want[:, :2] * signs,
                               rtol=HELPER_RTOL, atol=HELPER_ATOL)
    theta = np.where(mask, np.arctan2(want[:, 1] * signs[1], want[:, 0] * signs[0]), 0.0)
    np.testing.assert_allclose(np.cos(got[:, 3]), np.cos(theta), atol=1e-4)
    np.testing.assert_allclose(np.sin(got[:, 3]), np.sin(theta), atol=1e-4)


@pytest.mark.parametrize("sigma", [
    [[4.0, 0.0], [0.0, 1.0]], [[2.0, 0.9], [0.9, 1.0]], [[0.5, -0.3], [-0.3, 3.0]],
])
def test_cov_ellipse_matches_jax_as_a_point_set(sigma):
    """The same ellipse: each point equals the JAX formula's with the
    port's eigenvector signs, and lies on the JAX ellipse (its Mahalanobis
    radius² is χ²)."""
    mu = np.array([3.0, -1.0], np.float32)
    sigma = np.asarray(sigma, np.float32)
    got = TPR.cov_ellipse(torch.from_numpy(mu), torch.from_numpy(sigma)).numpy()
    want = np.asarray(JPR.cov_ellipse(jnp.asarray(mu), jnp.asarray(sigma)))
    assert got.shape == want.shape == (32, 2)
    t_evecs = torch.linalg.eigh(torch.from_numpy(sigma))[1].numpy()
    j_evals, j_evecs = (np.asarray(a) for a in jnp.linalg.eigh(jnp.asarray(sigma)))
    signs = _column_signs(t_evecs, j_evecs)
    t = np.linspace(0.0, 2.0 * np.pi, 32)
    circle = np.stack([np.cos(t), np.sin(t)], -1) * np.sqrt(j_evals * 9.21) * signs
    np.testing.assert_allclose(got, mu + circle @ j_evecs.T, rtol=1e-4, atol=1e-4)
    d = got - mu
    r2 = np.einsum("pi,ij,pj->p", d, np.linalg.inv(sigma), d)
    np.testing.assert_allclose(r2, 9.21, rtol=1e-4)
    if np.all(signs == 1):
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


# --- drivers over the fixture weights ------------------------------------

@pytest.fixture(scope="module")
def detectors():
    """The fixture-trained weights at the shipped widths and the artifact's
    capacities: the JAX detector loads them with flax, the port's with its
    own reader."""
    with open(os.path.join(ARTIFACT, "config.json")) as f:
        saved = json.load(f)
    caps = dict(max_nodes=int(saved["max_nodes"]),
                max_clusters=int(saved["max_clusters"]),
                temporal_window_size=int(saved["temporal_window_size"]))
    jcfg, cfg = JC.GNNConfig(**caps), GNNConfig(**caps)
    path = os.path.join(ARTIFACT, "weights.msgpack")
    params = j_load_params_msgpack(init_params(jcfg, jax.random.key(0)), path)
    jdet = JPI.FrameDetector(jcfg, params, eps=1.4, use_object_head=True)
    tdet = TPI.FrameDetector(cfg, state_dict_from_flax(t_load_params_msgpack(path)),
                             eps=1.4, use_object_head=True, device="cpu")
    return jdet, tdet


def test_segmentation_eval_driver(detectors, jax_native, tmp_path):
    jdet, tdet = detectors
    rng = np.random.default_rng(60)
    frames_t, frames_j = [], []
    while len(frames_t) < 4:
        data = TSY.make_synthetic_frame(rng, num_objects=3, window_size=WINDOW)
        ft, fj = t_preprocess(data, tdet.cfg), j_preprocess(data, jdet.cfg)
        assert (ft is None) == (fj is None)
        if ft is not None:
            frames_t.append(ft)
            frames_j.append(fj)
    got = TD.segmentation_confusion(tdet, frames_t)
    want = JD.segmentation_confusion(jdet, frames_j)
    assert got.cm.sum() == sum(min(f.n, tdet.cfg.max_nodes) for f in frames_t)
    assert got.to_json_dict() == want.to_json_dict()
    pt = TD.write_sequence_json(got, str(tmp_path / "torch"), "sequence_7")
    pj = JD.write_sequence_json(want, str(tmp_path / "jax"), "sequence_7")
    with open(pt) as a, open(pj) as b:
        assert a.read() == b.read()
    t_pr = TD.aggregate_sequence_jsons([pt], tdet.cfg.num_classes)
    j_pr = JD.aggregate_sequence_jsons([pj], jdet.cfg.num_classes)
    assert t_pr["precision"].shape == (6,)  # NONE dropped
    for k in ("precision", "recall", "confusion"):
        np.testing.assert_array_equal(t_pr[k], j_pr[k])


def test_detection_eval_driver(detectors, jax_native):
    jdet, tdet = detectors
    rng = np.random.default_rng(70)
    dicts = [TSY.make_synthetic_frame(rng, num_objects=3, window_size=WINDOW)
             for _ in range(4)]
    got = TD.evaluate_detection_from_data(tdet, dicts, cluster_size_threshold=1, eps=0.7)
    want = JD.evaluate_detection_from_data(jdet, dicts, cluster_size_threshold=1, eps=0.7)
    assert got.cm.sum() > 0
    assert got.to_json_dict() == want.to_json_dict()
    _same_result(got.raw_gt, want.raw_gt)
    _same_result(got.raw_pred, want.raw_pred)
    res = TM.precision_recall(got.cm)
    assert np.isfinite(res["precision"]).all()


def test_fixture_sequence_5_jsons_match_jax(detectors, jax_native, tmp_path):
    """The held-out fixture sequence 5 (scripts/train_fixture_artifact.py's
    seed 200), every window read by each package's own RadarScenes reader:
    the port's segmentation and detection JSONs equal the JAX drivers'."""
    jdet, tdet = detectors
    make_mini_radarscenes(str(tmp_path), seed=200, n_scenes=48, n_objects=4,
                          seq_name="sequence_5", category="validation")
    out = {}
    for name, cache_cls, prep, det, drv in (
            ("torch", TRS.SequenceCache, t_preprocess, tdet, TD),
            ("jax", JRS.SequenceCache, j_preprocess, jdet, JD)):
        cache = cache_cls(str(tmp_path), "data", max_sequences=8)
        dicts = [cache.extract_window("sequence_5", w)
                 for w in cache.windows("sequence_5", WINDOW)]
        frames = [fr for fr in (prep(d, det.cfg) for d in dicts) if fr is not None]
        seg = drv.segmentation_confusion(det, frames)
        dets = drv.evaluate_detection_from_data(det, dicts, cluster_size_threshold=1,
                                                eps=0.7)
        paths = [drv.write_sequence_json(acc, str(tmp_path / name / kind), "sequence_5")
                 for acc, kind in ((seg, "semantic_segmentation"),
                                   (dets, "object_classification"))]
        out[name] = [open(p).read() for p in paths]
        assert len(frames) >= 40
    assert out["torch"] == out["jax"]
