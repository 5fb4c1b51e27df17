"""The port's variant models against the JAX package's at small widths:
``segment_softmax``/``segment_count`` (and the masked max's fill on empty
segments), the trunk's ``extra_features``, ``RadarGNNv1`` (fused node
head) and the GATv2 ``RadarGNNv2``: the same parameters (JAX init converted
by ``state_dict_from_flax``) on the same padded graph give the same
forward outputs, gradients and deploy decisions, as in
tests/test_data_plane.py's test_v1_fused_node_head_model and
test_gat_model_forward."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from graph_neural_network_for_radar_perception_torch.config.config import (
    tiny_test_config,
)
from graph_neural_network_for_radar_perception_torch.core.graph import (
    GraphLabels,
    RadarGraph,
)
from graph_neural_network_for_radar_perception_torch.models.gat import RadarGNNv2
from graph_neural_network_for_radar_perception_torch.models.gnn import (
    RadarGNN,
    RadarGNNv1,
)
from graph_neural_network_for_radar_perception_torch.ops import segment as TS
from graph_neural_network_for_radar_perception_torch.train import loss as TL
from graph_neural_network_for_radar_perception_torch.train.steps import make_optimizer
from graph_neural_network_for_radar_perception_torch.utils.convert import (
    state_dict_from_flax,
)
from graph_neural_network_for_radar_perception_tpu.config import config as JC
from graph_neural_network_for_radar_perception_tpu.data.pipeline import (
    SyntheticRadarDataset,
    pad_frame,
)
from graph_neural_network_for_radar_perception_tpu.models import gat as JG
from graph_neural_network_for_radar_perception_tpu.models import gnn as JN
from graph_neural_network_for_radar_perception_tpu.ops import segment as JS
from graph_neural_network_for_radar_perception_tpu.train import loss as JL
from graph_neural_network_for_radar_perception_tpu.train import steps as JST
from torch_port_fixtures import one_torch_thread  # noqa: F401  (autouse)

# Small widths, f32 on two CPU backends (other summation orders).
TOL = dict(rtol=1e-5, atol=1e-5)
# Losses and params after each SGD step (an update of lr·grad).
STEP_TOL = dict(rtol=1e-5, atol=1e-6)
GAT_OVERRIDES = dict(hidden_node_channels_gat=32, num_heads_gat=4)
MODELS = {"v1": (RadarGNNv1, JN.RadarGNNv1), "v2": (RadarGNNv2, JG.RadarGNNv2),
          "v0": (RadarGNN, JN.RadarGNN)}


# --- segment ops ------------------------------------------------------------

@pytest.mark.parametrize("heads", [None, 3])
@pytest.mark.parametrize("masked", [False, True])
def test_segment_softmax_matches_jax(rng, heads, masked):
    """Segments 7 and 8 get no row (and with the mask segment 2 only masked
    rows): their max fills with 0 and nothing divides by 0."""
    e, n = 60, 10
    shape = (e,) if heads is None else (e, heads)
    logits = (rng.normal(size=shape) * 30).astype(np.float32)
    ids = rng.choice([0, 1, 2, 3, 4, 5, 6, 9], e).astype(np.int32)
    mask = (rng.random(e) > 0.3) & (ids != 2) if masked else None
    got = TS.segment_softmax(torch.from_numpy(logits), torch.from_numpy(ids), n,
                             None if mask is None else torch.from_numpy(mask)).numpy()
    want = np.asarray(JS.segment_softmax(jnp.asarray(logits), jnp.asarray(ids), n,
                                         None if mask is None else jnp.asarray(mask)))
    np.testing.assert_allclose(got, want, **TOL)
    if masked:
        assert np.all(got[~mask] == 0.0)
    keep = np.ones(e, bool) if mask is None else mask
    sums = np.zeros((n,) + shape[1:])
    np.add.at(sums, ids[keep], got[keep])
    np.testing.assert_allclose(sums[np.unique(ids[keep])], 1.0, rtol=1e-5)


@pytest.mark.parametrize("masked", [False, True])
def test_segment_count_matches_jax(rng, masked):
    ids = rng.integers(0, 12, 80).astype(np.int32)
    mask = rng.random(80) > 0.5 if masked else None
    got = TS.segment_count(torch.from_numpy(ids), 10,
                           None if mask is None else torch.from_numpy(mask))
    want = JS.segment_count(jnp.asarray(ids), 10,
                            None if mask is None else jnp.asarray(mask))
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_masked_segment_max_fill_on_all_masked_segments(rng):
    data = rng.normal(size=(30, 4)).astype(np.float32)
    ids = rng.integers(0, 6, 30).astype(np.int32)
    mask = ids != 3  # segment 3 fully masked; 6 and 7 get no row at all
    for fill in (0.0, -5.0):
        got = TS.masked_segment_max(torch.from_numpy(data), torch.from_numpy(ids), 8,
                                    torch.from_numpy(mask), fill_value=fill).numpy()
        want = np.asarray(JS.masked_segment_max(jnp.asarray(data), jnp.asarray(ids), 8,
                                                jnp.asarray(mask), fill_value=fill))
        np.testing.assert_array_equal(got, want)
        assert np.all(got[[3, 6, 7]] == fill)


# --- models -----------------------------------------------------------------

def _setup(kind, overrides=None, extra_dim=0, seed=0):
    overrides = dict(GAT_OVERRIDES, **(overrides or {}))
    jcfg, cfg = JC.tiny_test_config(**overrides), tiny_test_config(**overrides)
    tcls, jcls = MODELS[kind]
    graph, labels = pad_frame(
        SyntheticRadarDataset(jcfg, seed=5, num_objects=3).sample_frame(), jcfg)
    extra = None
    if extra_dim:
        extra = np.random.default_rng(9).normal(
            size=(jcfg.max_nodes, extra_dim)).astype(np.float32)
    args = (jax.tree.map(jnp.asarray, graph), jnp.asarray(labels.node2cluster),
            jcfg.max_clusters, jnp.asarray(labels.cluster_mask),
            None if extra is None else jnp.asarray(extra))
    jmodel = jcls(jcfg)
    params = jmodel.init(jax.random.key(seed), *args)["params"]
    model = tcls(cfg, extra_feature_dim=extra_dim)
    model.load_state_dict(state_dict_from_flax(jax.tree.map(np.asarray, params)))
    targs = (RadarGraph.from_numpy(graph), torch.from_numpy(labels.node2cluster),
             cfg.max_clusters, torch.from_numpy(labels.cluster_mask))
    return jmodel, params, args, model, targs, graph, labels, extra


def _outputs_close(got, want, graph, labels):
    nm = graph.node_mask
    for name in ("node_cls", "node_offsets", "node_embed"):
        np.testing.assert_allclose(getattr(got, name).detach().numpy()[nm],
                                   np.asarray(getattr(want, name))[nm], **TOL,
                                   err_msg=name)
    np.testing.assert_allclose(got.edge_cls.detach().numpy()[graph.und_mask],
                               np.asarray(want.edge_cls)[graph.und_mask], **TOL)
    np.testing.assert_allclose(got.obj_cls.detach().numpy()[labels.cluster_mask],
                               np.asarray(want.obj_cls)[labels.cluster_mask], **TOL)


def test_v1_has_only_the_fused_node_head():
    _, params, _, model, _, _, _, _ = _setup("v1")
    names = {k.split(".")[0] for k in model.state_dict()}
    assert "predict_node_fused" in names and "predict_node_fused" in params
    assert not {"predict_node", "predict_offset"} & names
    assert len(model.state_dict()) == len(jax.tree.leaves(params))


def test_v2_neck_shapes_at_full_width():
    """GNNConfig()'s GAT widths: hidden 512 over 8 heads, update MLP
    [256, 128, 64] from [x ‖ agg] = 64 + 512."""
    from graph_neural_network_for_radar_perception_torch.config.config import GNNConfig

    model = RadarGNNv2(GNNConfig())
    blk = model.pass_messages.blocks[0]
    assert blk.gat.att.shape == (1, 8, 64) and blk.gat.lin_l.weight.shape == (512, 64)
    assert [b.linear.weight.shape for b in blk.upd_mlp.blocks] == [
        (256, 576), (128, 256), (64, 128)]
    assert blk.identity is None and len(model.pass_messages.blocks) == 7


@pytest.mark.parametrize("kind", ["v1", "v2"])
def test_variant_forward_and_grads_match_jax(kind):
    jmodel, params, args, model, targs, graph, labels, _ = _setup(kind)
    want = jmodel.apply({"params": params}, *args[:4])
    got = model(*targs)
    _outputs_close(got, want, graph, labels)

    def jloss(p):
        o = jmodel.apply({"params": p}, *args[:4])
        return jnp.sum(o.node_cls ** 2) + jnp.sum(o.node_offsets ** 2)

    jgrads = state_dict_from_flax(jax.tree.map(np.asarray, jax.grad(jloss)(params)))
    (got.node_cls.pow(2).sum() + got.node_offsets.pow(2).sum()).backward()
    for name, p in model.named_parameters():
        g = torch.zeros_like(p) if p.grad is None else p.grad
        assert torch.isfinite(g).all(), name
        np.testing.assert_allclose(g.numpy(), jgrads[name].numpy(), rtol=1e-4,
                                   atol=1e-6, err_msg=name)


@pytest.mark.parametrize("kind", ["v0", "v1", "v2"])
def test_extra_features_match_jax(kind):
    """Per-node extra features between x and the aggregate in every update
    MLP (gnn.py:117-125, blocks.py:231-232, gat.py:96-99)."""
    jmodel, params, args, model, targs, graph, labels, extra = _setup(kind, extra_dim=3)
    want = jmodel.apply({"params": params}, *args)
    with torch.no_grad():
        got = model(*targs, extra_features=torch.from_numpy(extra))
        without = model(*targs, extra_features=torch.zeros(extra.shape))
    _outputs_close(got, want, graph, labels)
    assert not np.allclose(got.node_embed.numpy(), without.node_embed.numpy())
    wdep = jmodel.apply({"params": params}, args[0], eps=1.4,
                        extra_features=args[4], method=type(jmodel).deploy)
    with torch.no_grad():
        tdep = model.deploy(targs[0], 1.4, extra_features=torch.from_numpy(extra))
    np.testing.assert_array_equal(tdep.node2cluster.numpy(), np.asarray(wdep.node2cluster))


@pytest.mark.parametrize("kind", ["v1", "v2"])
def test_variant_deploy_matches_jax(kind):
    """deploy on the variant (v1 through the fused head, v2 through its
    GAT trunk): node classes, DBSCAN clusters and object classes equal,
    logits within TOL; for v1 also with the CSR round."""
    jmodel, params, args, model, targs, graph, labels, _ = _setup(kind)
    want = jmodel.apply({"params": params}, args[0], eps=1.4, method=type(jmodel).deploy)
    impls = [None, "csr"] if kind == "v1" else [None]
    for mp_impl in impls:
        with torch.no_grad():
            got = model.deploy(targs[0], 1.4, mp_impl=mp_impl)
        nm = graph.node_mask
        k = int(want.num_clusters)
        assert int(got.num_clusters) == k
        np.testing.assert_array_equal(got.node2cluster.numpy(), np.asarray(want.node2cluster))
        np.testing.assert_array_equal(got.node_cls.numpy()[nm].argmax(-1),
                                      np.asarray(want.node_cls)[nm].argmax(-1))
        np.testing.assert_array_equal(got.obj_cls.numpy()[:k].argmax(-1),
                                      np.asarray(want.obj_cls)[:k].argmax(-1))
        for name in ("node_cls", "node_offsets", "centers"):
            np.testing.assert_allclose(getattr(got, name).numpy()[nm],
                                       np.asarray(getattr(want, name))[nm], **TOL)
        np.testing.assert_allclose(got.obj_cls.numpy()[:k], np.asarray(want.obj_cls)[:k],
                                   **TOL)
        n2c = got.node2cluster.numpy()
        assert (n2c[nm] < k).all()


def test_gat_neck_refuses_fused_round_options():
    _, _, _, model, targs, _, _, _ = _setup("v2")
    with pytest.raises(ValueError, match="GAT neck"):
        model(*targs, mp_impl="csr")
    with pytest.raises(ValueError, match="GAT neck"):
        model(*targs, mp_bf16=True)


@pytest.mark.parametrize("kind", ["v1", "v2"])
def test_variant_train_steps_match_jax(kind):
    """The training loss (graph_loss_sums → reduce_loss_sums) of the variant
    on one graph and two steps of the shipped optimiser (SGD, momentum 0.9,
    coupled weight decay) from the same weights: the loss before each step
    and every parameter after it."""
    import optax

    jmodel, params, args, model, targs, graph, labels, _ = _setup(kind)
    jcfg, cfg = jmodel.cfg, model.cfg
    jlabels = jax.tree.map(jnp.asarray, labels)
    tlabels = GraphLabels.from_numpy(labels)

    def jloss(p):
        out = jmodel.apply({"params": p}, *args[:4])
        return JL.reduce_loss_sums(JL.graph_loss_sums(out, args[0], jlabels, jcfg), jcfg)[0]

    tx = JST.make_optimizer(jcfg)
    opt_state = tx.init(params)
    opt = make_optimizer(cfg, model.parameters())
    for i in range(2):
        want, grads = jax.value_and_grad(jloss)(params)
        updates, opt_state = tx.update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)
        opt.zero_grad()
        got = TL.reduce_loss_sums(TL.graph_loss_sums(model(*targs), targs[0], tlabels, cfg),
                                  cfg)[0]
        got.backward()
        opt.step()
        np.testing.assert_allclose(got.detach().item(), float(want), **STEP_TOL,
                                   err_msg=f"step {i}")
        ref = state_dict_from_flax(jax.tree.map(np.asarray, params))
        for name, v in model.state_dict().items():
            np.testing.assert_allclose(v.numpy(), ref[name].numpy(), **STEP_TOL,
                                       err_msg=f"step {i} {name}")
