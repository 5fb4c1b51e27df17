"""The JAX package's deploy as its serving and finetuning paths compile it,
in the port: ``RadarGNN.deploy`` and DBSCAN with a leading graph axis
(``train/steps.batched_deploy``, one call for the batch where the JAX
package vmaps the one-graph deploy).  On the CPU, at tiny widths, against
``jax.vmap`` of the JAX deploy on the same weights (``state_dict_from_flax``)
and numpy-seeded graphs, and against one call a graph.  The captured
``FrameDetector`` needs a card (``tests/test_torch_cuda.py``)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from graph_neural_network_for_radar_perception_torch.config.config import (
    tiny_test_config,
)
from graph_neural_network_for_radar_perception_torch.core.graph import RadarGraph
from graph_neural_network_for_radar_perception_torch.infer import clustering as TCL
from graph_neural_network_for_radar_perception_torch.infer.pipeline import FrameDetector
from graph_neural_network_for_radar_perception_torch.models.gnn import RadarGNN
from graph_neural_network_for_radar_perception_torch.train import steps as S
from graph_neural_network_for_radar_perception_torch.utils.convert import (
    state_dict_from_flax,
)
from graph_neural_network_for_radar_perception_tpu.config import config as JC
from graph_neural_network_for_radar_perception_tpu.data.pipeline import (
    SyntheticRadarDataset,
    pad_frame,
    stack_batch,
)
from graph_neural_network_for_radar_perception_tpu.infer import clustering as JCL
from graph_neural_network_for_radar_perception_tpu.models.gnn import (
    RadarGNN as JaxRadarGNN,
)
from graph_neural_network_for_radar_perception_tpu.train.steps import init_params
from torch_port_fixtures import one_torch_thread  # noqa: F401  (autouse)

TOL = dict(rtol=1e-5, atol=1e-6)
GRAPHS = 3
EPS = 1.4


@pytest.fixture(scope="module")
def setup():
    jcfg, cfg = JC.tiny_test_config(), tiny_test_config()
    params = init_params(jcfg, jax.random.key(5))
    model = RadarGNN(cfg)
    model.load_state_dict(state_dict_from_flax(jax.tree.map(np.asarray, params)))
    ds = SyntheticRadarDataset(jcfg, seed=2, num_objects=3)
    batch = stack_batch([pad_frame(ds.sample_frame(), jcfg) for _ in range(GRAPHS)])
    return jcfg, cfg, params, model.eval(), batch


def _jax_deploy(jcfg, params, graph, from_links):
    return jax.vmap(lambda g: JaxRadarGNN(jcfg).apply(
        {"params": params}, g, EPS, from_links, method=JaxRadarGNN.deploy))(
        jax.tree.map(jnp.asarray, graph))


def _port_deploy(model, cfg, graph, from_links, mp_impl):
    with torch.no_grad():
        return S.batched_deploy(model, cfg, eps=EPS, from_links=from_links,
                                mp_impl=mp_impl)(RadarGraph.from_numpy(graph))


def _rows(graph, num_clusters):
    """The rows each output is compared on: valid nodes, valid undirected
    edges, the clusters DBSCAN found."""
    k = np.asarray(num_clusters)
    return {"node_cls": graph.node_mask, "node_offsets": graph.node_mask,
            "centers": graph.node_mask, "edge_cls": graph.und_mask,
            "obj_cls": np.arange(graph.num_nodes)[None, :] < k[:, None]}


@pytest.mark.parametrize("mp_impl, from_links", [(None, False), ("csr", False),
                                                 (None, True), ("csr", True)])
def test_batched_deploy_matches_jax_vmap(setup, mp_impl, from_links):
    """Equal DBSCAN partitions and cluster counts a graph; every other
    output within 1e-5 relative on its valid rows."""
    jcfg, cfg, params, model, batch = setup
    want = _jax_deploy(jcfg, params, batch.graph, from_links)
    got = _port_deploy(model, cfg, batch.graph, from_links, mp_impl)
    assert got.num_clusters.shape == (GRAPHS,) and got.node2cluster.shape == (
        GRAPHS, cfg.max_nodes)
    np.testing.assert_array_equal(got.node2cluster.numpy(), np.asarray(want.node2cluster))
    np.testing.assert_array_equal(got.num_clusters.numpy(), np.asarray(want.num_clusters))
    assert (got.num_clusters > 0).all()
    for name, rows in _rows(batch.graph, want.num_clusters).items():
        np.testing.assert_allclose(getattr(got, name).numpy()[rows],
                                   np.asarray(getattr(want, name))[rows], **TOL,
                                   err_msg=name)


@pytest.mark.parametrize("from_links", [False, True])
def test_batched_deploy_equals_one_call_a_graph(setup, from_links):
    """The batch's deploy against one deploy a graph: the partitions bit
    for bit, the outputs within TOL (other matmul blockings)."""
    _, cfg, _, model, batch = setup
    got = _port_deploy(model, cfg, batch.graph, from_links, None)
    graph = RadarGraph.from_numpy(batch.graph)
    for b in range(GRAPHS):
        with torch.no_grad():
            one = model.deploy(graph.at(b), EPS, from_links)
        assert torch.equal(got.node2cluster[b], one.node2cluster)
        assert torch.equal(got.num_clusters[b], one.num_clusters)
        for name in ("node_cls", "node_offsets", "edge_cls", "obj_cls", "centers"):
            np.testing.assert_allclose(getattr(got, name)[b].numpy(),
                                       getattr(one, name).numpy(), **TOL, err_msg=name)


def _blob_batch(rng, graphs, n):
    """Centers in a few blobs plus a permuted path (the topology a fixed
    trip count of label propagation gets wrong), random masks."""
    centers = []
    for g in range(graphs):
        c = rng.normal(size=(n, 2)).astype(np.float32) * 6.0
        path = rng.permutation(n)[: n // 4]
        c[path] = np.stack([np.arange(path.size) * 0.9, np.full(path.size, 50.0 + g)], -1)
        centers.append(c)
    mask = rng.random((graphs, n)) > 0.15
    return np.stack(centers), mask


@pytest.mark.parametrize("from_links", [False, True])
def test_batched_dbscan_equals_one_call_a_graph_bitwise(rng, from_links):
    """``dbscan_on_device`` over [B, N] against B one-graph calls: the
    same node2cluster and cluster count bit for bit, and JAX's vmap."""
    graphs, n, eu = 4, 64, 200
    centers, mask = _blob_batch(rng, graphs, n)
    links = {}
    if from_links:
        s = rng.integers(0, n - 1, size=(graphs, eu))
        r = np.minimum(s + rng.integers(1, 4, size=(graphs, eu)), n - 1)
        links = {"und_senders": s.astype(np.int32), "und_receivers": r.astype(np.int32),
                 "und_mask": rng.random((graphs, eu)) > 0.1,
                 "pred_edges": rng.integers(0, 2, size=(graphs, eu)).astype(np.int32)}
    t = {k: torch.from_numpy(v) for k, v in links.items()}
    ids, num = TCL.dbscan_on_device(torch.from_numpy(centers), torch.from_numpy(mask), EPS,
                                    from_links=from_links, **t)
    assert ids.shape == (graphs, n) and num.shape == (graphs,)
    for b in range(graphs):
        one_ids, one_num = TCL.dbscan_on_device(
            torch.from_numpy(centers[b]), torch.from_numpy(mask[b]), EPS,
            from_links=from_links, **{k: v[b] for k, v in t.items()})
        assert torch.equal(ids[b], one_ids) and torch.equal(num[b], one_num)
    jids, jnum = jax.vmap(lambda c, m, *lk: JCL.dbscan_on_device(
        c, m, EPS, from_links=from_links, **dict(zip(links, lk))))(
        jnp.asarray(centers), jnp.asarray(mask), *map(jnp.asarray, links.values()))
    np.testing.assert_array_equal(ids.numpy(), np.asarray(jids))
    np.testing.assert_array_equal(num.numpy(), np.asarray(jnum))
    assert (num > 1).all()


def test_frame_detector_runs_eagerly_on_the_cpu(setup):
    """On the CPU ``detect`` runs the eager forward: nothing is captured."""
    jcfg, cfg, _, model, _ = setup
    det = FrameDetector(cfg, model.state_dict(), device="cpu")
    ds = SyntheticRadarDataset(jcfg, seed=7, num_objects=3)
    d = det.detect_frame_arrays(ds.sample_frame())
    assert d.num_clusters > 0 and d.node2cluster.shape == d.node_class.shape
    assert det.captured.replays == det.captured.warmups == 0 and not det.captured.graphs
