"""The port's deploy-side inference against the JAX package: on-device
DBSCAN (and its host BFS twin), cluster proposals, and the full-width
``FrameDetector`` with the committed fixture-trained weights on
mini-RadarScenes frames, held to decision equality as
scripts/check_tpu_decision_equivalence.py holds the TPU path."""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fixtures_radarscenes import make_mini_radarscenes
from graph_neural_network_for_radar_perception_torch.config.config import GNNConfig
from graph_neural_network_for_radar_perception_torch.core.graph import RadarGraph
from graph_neural_network_for_radar_perception_torch.infer import clustering as TCL
from graph_neural_network_for_radar_perception_torch.infer import pipeline as TPI
from graph_neural_network_for_radar_perception_torch.infer.proposals import (
    compute_proposals,
)
from graph_neural_network_for_radar_perception_torch.utils.convert import (
    state_dict_from_flax,
)
from graph_neural_network_for_radar_perception_tpu.config import config as JC
from graph_neural_network_for_radar_perception_tpu.data.pipeline import (
    pad_frame,
    preprocess_frame,
)
from graph_neural_network_for_radar_perception_tpu.data.radarscenes import (
    SequenceCache,
)
from graph_neural_network_for_radar_perception_tpu.infer import clustering as JCL
from graph_neural_network_for_radar_perception_tpu.infer import pipeline as JPI
from graph_neural_network_for_radar_perception_tpu.infer import proposals as JPR
from graph_neural_network_for_radar_perception_tpu.train.steps import init_params
from graph_neural_network_for_radar_perception_tpu.utils.checkpoint import (
    load_params_msgpack,
)
from torch_port_fixtures import one_torch_thread  # noqa: F401  (autouse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARTIFACT = os.path.join(REPO, "runs", "fixture_artifact")
N_FRAMES = 12


def _relabel(labels):
    """Cluster ids → ids in order of first appearance (partition form)."""
    seen = {}
    return np.array([seen.setdefault(int(v), len(seen)) for v in labels])


@pytest.mark.parametrize("case", ["blobs", "permuted_path"])
def test_dbscan_matches_jax_and_host_bfs(rng, case):
    n, eps = 64, 1.4
    if case == "blobs":
        centers = rng.normal(scale=4.0, size=(n, 2)).astype(np.float32)
    else:
        # A path whose links are 1 apart, visited in random index order:
        # fixed-trip label propagation under-converges here.
        centers = np.zeros((n, 2), np.float32)
        centers[rng.permutation(n), 0] = np.arange(n, dtype=np.float32)
    mask = np.ones(n, bool)
    if case == "blobs":
        mask[-5:] = False  # padded nodes stay out (a masked path would split)
    got_ids, got_k = TCL.dbscan_on_device(torch.from_numpy(centers),
                                          torch.from_numpy(mask), eps)
    want_ids, want_k = JCL.dbscan_on_device(jnp.asarray(centers),
                                            jnp.asarray(mask), eps)
    np.testing.assert_array_equal(got_ids.numpy(), np.asarray(want_ids))
    assert int(got_k) == int(want_k)
    host = JCL.dbscan_host(centers[mask], eps)
    np.testing.assert_array_equal(TCL.dbscan_host(centers[mask], eps), host)
    np.testing.assert_array_equal(got_ids.numpy()[mask], host)
    assert np.all(got_ids.numpy()[~mask] == n)
    if case == "permuted_path":
        assert int(got_k) == 1


def test_dbscan_from_links_matches_jax(rng):
    n, eu = 48, 120
    centers = rng.normal(scale=2.0, size=(n, 2)).astype(np.float32)
    us = rng.integers(0, n - 1, eu).astype(np.int32)
    ur = np.minimum(us + rng.integers(1, 6, eu), n - 1).astype(np.int32)
    und_mask = rng.random(eu) > 0.2
    pred = rng.integers(0, 2, eu).astype(np.int32)
    mask = np.arange(n) < 44
    T = torch.from_numpy
    got = TCL.dbscan_on_device(T(centers), T(mask), 1.4, from_links=True,
                               und_senders=T(us), und_receivers=T(ur),
                               und_mask=T(und_mask), pred_edges=T(pred))
    want = JCL.dbscan_on_device(jnp.asarray(centers), jnp.asarray(mask), 1.4,
                                from_links=True, und_senders=jnp.asarray(us),
                                und_receivers=jnp.asarray(ur),
                                und_mask=jnp.asarray(und_mask),
                                pred_edges=jnp.asarray(pred))
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    assert int(got[1]) == int(want[1])


def test_proposals_match_jax(rng):
    n, c, k = 40, 40, 7
    xy = rng.normal(scale=5.0, size=(n, 2)).astype(np.float32)
    cls = rng.integers(0, k, n).astype(np.int32)
    n2c = rng.integers(0, 9, n).astype(np.int32)
    mask = np.arange(n) < 33
    n2c[~mask] = c
    got = compute_proposals(*(torch.from_numpy(a) for a in (xy, cls, n2c, mask)), c, k)
    want = JPR.compute_proposals(*(jnp.asarray(a) for a in (xy, cls, n2c, mask)), c, k)
    for name in ("mu", "sigma", "size"):
        np.testing.assert_allclose(getattr(got, name).numpy(),
                                   np.asarray(getattr(want, name)),
                                   rtol=1e-5, atol=1e-5, err_msg=name)
    np.testing.assert_array_equal(got.label.numpy(), np.asarray(want.label))
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(want.valid))


def test_frame_detector_full_width_decisions_match_jax(tmp_path):
    """The fixture-trained weights at the shipped widths on 12 fixture
    frames: node classes, DBSCAN partitions and object classes equal to the
    JAX package's on the CPU; logits within rtol 1e-3 / atol 1e-4."""
    with open(os.path.join(ARTIFACT, "config.json")) as f:
        saved = json.load(f)
    caps = dict(max_nodes=int(saved["max_nodes"]),
                max_clusters=int(saved["max_clusters"]),
                temporal_window_size=int(saved["temporal_window_size"]))
    jcfg, cfg = JC.GNNConfig(**caps), GNNConfig(**caps)
    params = load_params_msgpack(init_params(jcfg, jax.random.key(0)),
                                 os.path.join(ARTIFACT, "weights.msgpack"))
    jdet = JPI.FrameDetector(jcfg, params, eps=1.4, use_object_head=True)
    tdet = TPI.FrameDetector(
        cfg, state_dict_from_flax(jax.tree.map(np.asarray, params)),
        eps=1.4, use_object_head=True, device="cpu")

    make_mini_radarscenes(str(tmp_path), seed=777, n_scenes=N_FRAMES + 6,
                          n_objects=4, seq_name="sequence_9",
                          category="validation")
    cache = SequenceCache(str(tmp_path), "data", max_sequences=2)
    compared = 0
    for w in list(cache.windows("sequence_9", 5))[:N_FRAMES]:
        fr = preprocess_frame(cache.extract_window("sequence_9", w), jcfg)
        if fr is None:
            continue
        want, got = jdet.detect_frame_arrays(fr), tdet.detect_frame_arrays(fr)
        np.testing.assert_array_equal(got.node_class, want.node_class)
        np.testing.assert_array_equal(_relabel(got.node2cluster),
                                      _relabel(want.node2cluster))
        assert got.num_clusters == want.num_clusters
        k = want.num_clusters
        np.testing.assert_array_equal(got.cluster_class[:k], want.cluster_class[:k])
        np.testing.assert_array_equal(got.link_class, want.link_class)

        graph, _ = pad_frame(fr, jcfg)
        jout, _ = jdet._run(params, jax.tree.map(jnp.asarray, graph))
        with torch.no_grad():
            tout = tdet.model.deploy(RadarGraph.from_numpy(graph), 1.4)
        for name, rows in (("node_cls", graph.node_mask),
                           ("node_offsets", graph.node_mask),
                           ("edge_cls", graph.und_mask),
                           ("obj_cls", np.arange(graph.node_mask.size) < k)):
            np.testing.assert_allclose(
                getattr(tout, name).numpy()[rows],
                np.asarray(getattr(jout, name))[rows],
                rtol=1e-3, atol=1e-4, err_msg=name)
        compared += 1
    assert compared >= 10
