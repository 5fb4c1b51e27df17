"""The port's RadarGNN against the flax model at small widths: the same
parameters (JAX ``init_params`` converted by ``state_dict_from_flax``) on
the same padded graph must give the same outputs on valid rows, for
``forward`` and ``deploy``, on the fused-kernel path (whose CPU version is
the plain fused pass) and on the plain path of other configurations."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from graph_neural_network_for_radar_perception_torch.config.config import (
    tiny_test_config,
)
from graph_neural_network_for_radar_perception_torch.core.graph import RadarGraph
from graph_neural_network_for_radar_perception_torch.models import blocks as TB
from graph_neural_network_for_radar_perception_torch.models.gnn import RadarGNN
from graph_neural_network_for_radar_perception_torch.utils.convert import (
    state_dict_from_flax,
)
from graph_neural_network_for_radar_perception_tpu.config import config as JC
from graph_neural_network_for_radar_perception_tpu.data.pipeline import (
    SyntheticRadarDataset,
    pad_frame,
)
from graph_neural_network_for_radar_perception_tpu.models.fast_path import (
    fast_forward,
)
from graph_neural_network_for_radar_perception_tpu.models.gnn import (
    RadarGNN as JaxRadarGNN,
)
from graph_neural_network_for_radar_perception_tpu.train.steps import init_params
from torch_port_fixtures import one_torch_thread  # noqa: F401  (autouse)

TOL = dict(rtol=2e-4, atol=2e-5)  # as tests/test_pallas.py's fast-path test

VARIANTS = {
    "shipped": {},
    "projector": {"graph_convolution_stem_channels": (24, 16)},
    "layer_norm": {"norm_layer": "layer_normalization"},
    "group_norm": {"norm_layer": "group_normalization", "num_groups": 2},
    "max_agg": {"aggregation": "max"},
    "mean_agg_relu": {"aggregation": "mean", "activation": "relu"},
}


def _setup(overrides, seed=3):
    jcfg = JC.tiny_test_config(**overrides)
    cfg = tiny_test_config(**overrides)
    params = init_params(jcfg, jax.random.key(seed))
    model = RadarGNN(cfg)
    model.load_state_dict(state_dict_from_flax(jax.tree.map(np.asarray, params)))
    ds = SyntheticRadarDataset(jcfg, seed=2, num_objects=3)
    graph, labels = pad_frame(ds.sample_frame(), jcfg)
    return jcfg, cfg, params, model.eval(), graph, labels


def _cmp(got, want, rows):
    np.testing.assert_allclose(got.detach().numpy()[rows], np.asarray(want)[rows], **TOL)


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_forward_matches_flax(variant):
    jcfg, cfg, params, model, g, lbl = _setup(VARIANTS[variant])
    assert model.pass_messages.fused == (variant in ("shipped", "projector"))
    gj = jax.tree.map(jnp.asarray, g)
    want = JaxRadarGNN(jcfg).apply(
        {"params": params}, gj, jnp.asarray(lbl.node2cluster),
        jcfg.max_clusters, jnp.asarray(lbl.cluster_mask))
    with torch.no_grad():
        got = model(RadarGraph.from_numpy(g), torch.from_numpy(lbl.node2cluster),
                    cfg.max_clusters, torch.from_numpy(lbl.cluster_mask))
    nm = g.node_mask
    for name in ("node_cls", "node_offsets", "node_embed"):
        _cmp(getattr(got, name), getattr(want, name), nm)
    _cmp(got.edge_cls, want.edge_cls, g.und_mask)
    _cmp(got.obj_cls, want.obj_cls, lbl.cluster_mask)


def test_forward_matches_fast_path_interpret():
    jcfg, cfg, params, model, g, lbl = _setup({})
    n2c, cm = jnp.asarray(lbl.node2cluster), jnp.asarray(lbl.cluster_mask)
    want = fast_forward(params, jax.tree.map(jnp.asarray, g), n2c,
                        jcfg.max_clusters, cm, jcfg, edge_tile=128,
                        interpret=True)
    with torch.no_grad():
        got = model(RadarGraph.from_numpy(g), torch.from_numpy(lbl.node2cluster),
                    cfg.max_clusters, torch.from_numpy(lbl.cluster_mask))
    nm = g.node_mask
    _cmp(got.node_cls, want.node_cls, nm)
    _cmp(got.node_offsets, want.node_offsets, nm)
    _cmp(got.node_embed, want.node_embed, nm)
    _cmp(got.edge_cls, want.edge_cls, g.und_mask)
    _cmp(got.obj_cls, want.obj_cls, lbl.cluster_mask)


@pytest.mark.parametrize("from_links", [False, True])
def test_deploy_matches_flax(from_links):
    jcfg, cfg, params, model, g, _ = _setup({}, seed=5)
    want = JaxRadarGNN(jcfg).apply(
        {"params": params}, jax.tree.map(jnp.asarray, g), 1.4, from_links,
        method=JaxRadarGNN.deploy)
    with torch.no_grad():
        got = model.deploy(RadarGraph.from_numpy(g), 1.4, from_links)
    nm = g.node_mask
    for name in ("node_cls", "node_offsets", "centers"):
        _cmp(getattr(got, name), getattr(want, name), nm)
    _cmp(got.edge_cls, want.edge_cls, g.und_mask)
    np.testing.assert_array_equal(got.node2cluster.numpy(),
                                  np.asarray(want.node2cluster))
    k = int(want.num_clusters)
    assert int(got.num_clusters) == k > 0
    _cmp(got.obj_cls, want.obj_cls, np.arange(got.obj_cls.shape[0]) < k)


def test_converter_maps_every_parameter():
    jcfg = JC.tiny_test_config(graph_convolution_stem_channels=(24, 24))
    params = jax.tree.map(np.asarray, init_params(jcfg, jax.random.key(0)))
    sd = state_dict_from_flax(params)
    model = RadarGNN(tiny_test_config(graph_convolution_stem_channels=(24, 24)))
    assert set(sd) == set(model.state_dict())
    assert sum(v.numel() for v in sd.values()) == sum(
        x.size for x in jax.tree.leaves(params))
    blk = params["encode_node_feat"]["MLPStack_0"]["FFNBlock_1"]
    np.testing.assert_array_equal(
        sd["encode_node_feat.blocks.1.linear.weight"].numpy(),
        blk["Linear_0"]["Dense_0"]["kernel"].T)
    assert sd["encode_node_feat.blocks.1.norm.gamma"].shape == (1,)
    assert "pass_messages.blocks.0.identity.weight" in sd
    assert "pass_messages.blocks.1.identity.weight" not in sd


def test_init_is_seeded_and_matches_reference_scheme():
    cfg = tiny_test_config()
    a = RadarGNN(cfg, generator=torch.Generator().manual_seed(1)).state_dict()
    b = RadarGNN(cfg, generator=torch.Generator().manual_seed(1)).state_dict()
    c = RadarGNN(cfg, generator=torch.Generator().manual_seed(2)).state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["encode_node_feat.blocks.0.linear.weight"],
                           c["encode_node_feat.blocks.0.linear.weight"])
    w = a["encode_edge_feat.blocks.0.linear.weight"]  # fan_in 7
    assert w.abs().max() <= 1 / math.sqrt(7)
    assert torch.all(a["predict_node.head.out.bias"] == -math.log(99.0))
    assert torch.all(a["predict_offset.head.out.bias"] == 0.0)
    assert a["predict_link.head.out.weight"].std() < 0.02
    assert torch.all(a["predict_node.stem.blocks.0.norm.gamma"] == 1.0)
    assert isinstance(RadarGNN(cfg).predict_node.head.out, TB.HeadLinear)


def test_node_predictions_head_matches_flax(rng):
    """The fused cls+reg node head (blocks.NodePredictions), on its own."""
    from collections import OrderedDict

    from graph_neural_network_for_radar_perception_torch.utils import convert
    from graph_neural_network_for_radar_perception_tpu.models import blocks as JB

    x = rng.normal(size=(20, 16)).astype(np.float32)
    jmod = JB.NodePredictions((16, 16), 7, 2, "leakyrelu", "channel_normalization")
    params = jax.tree.map(np.asarray, jmod.init(jax.random.key(1), jnp.asarray(x))["params"])
    want_cls, want_reg = jmod.apply({"params": params}, jnp.asarray(x))
    sd = OrderedDict()
    convert._stack(sd, "stem.", params["MLPStack_0"])
    convert._head(sd, "head_cls.", params["TaskSpecificHead_0"])
    convert._head(sd, "head_reg.", params["TaskSpecificHead_1"])
    tmod = TB.NodePredictions(16, (16, 16), 7, 2, "leakyrelu", "channel_normalization")
    tmod.load_state_dict({k: torch.tensor(v) for k, v in sd.items()})
    with torch.no_grad():
        got_cls, got_reg = tmod(torch.from_numpy(x))
    _cmp(got_cls, want_cls, slice(None))
    _cmp(got_reg, want_reg, slice(None))
