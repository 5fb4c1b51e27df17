"""Object-head finetuning as the JAX package compiles it, in the port: one
``batched_deploy`` for the batch, the majority vote and cross-entropy with
the graph axis, optax's chain(add_decayed_weights, sgd) on the head's flat
parameters (``train/steps.Optimizer``) and the branchless NaN skip over
every gradient, the frozen trunk's included.  On the CPU, at tiny widths,
against the JAX package's ``make_finetune_step`` on the same weights
(``state_dict_from_flax``) and numpy-seeded batches, and against one
deploy a graph.  The captured step needs a card
(``tests/test_torch_cuda.py``)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from graph_neural_network_for_radar_perception_torch.config.config import (
    tiny_test_config,
)
from graph_neural_network_for_radar_perception_torch.core.graph import GraphBatch
from graph_neural_network_for_radar_perception_torch.models.gnn import RadarGNN
from graph_neural_network_for_radar_perception_torch.train import finetune as TFT
from graph_neural_network_for_radar_perception_torch.train import loss as TL
from graph_neural_network_for_radar_perception_torch.train.steps import (
    Optimizer,
    TrainState,
)
from graph_neural_network_for_radar_perception_torch.utils.convert import (
    state_dict_from_flax,
)
from graph_neural_network_for_radar_perception_tpu.config import config as JC
from graph_neural_network_for_radar_perception_tpu.data.pipeline import (
    SyntheticRadarDataset,
    pad_frame,
    stack_batch,
)
from graph_neural_network_for_radar_perception_tpu.train import finetune as JFT
from graph_neural_network_for_radar_perception_tpu.train.steps import (
    TrainState as JTrainState,
)
from graph_neural_network_for_radar_perception_tpu.train.steps import init_params
from torch_port_fixtures import one_torch_thread  # noqa: F401  (autouse)

TOL = dict(rtol=1e-5, atol=1e-6)
BATCH = 4
STEPS = 3


@pytest.fixture(scope="module")
def setup():
    jcfg, cfg = JC.tiny_test_config(batch_size=BATCH), tiny_test_config(batch_size=BATCH)
    params = init_params(jcfg, jax.random.key(1))
    ds = SyntheticRadarDataset(jcfg, seed=8, num_objects=3)
    batches = [stack_batch([pad_frame(ds.sample_frame(), jcfg) for _ in range(BATCH)])
               for _ in range(STEPS)]
    return jcfg, cfg, params, batches


def _states(jcfg, cfg, params):
    build, _ = JFT.make_finetune_step(jcfg)
    jstep, tx = build(params)
    jstate = JTrainState(params, tx.init(params), jnp.zeros((), jnp.int32))
    model = RadarGNN(cfg)
    model.load_state_dict(state_dict_from_flax(jax.tree.map(np.asarray, params)))
    step, opt = TFT.make_finetune_step(cfg)[0](model)
    return jstep, jstate, step, TrainState(model, opt)


def _head(state):
    return {k: v.clone() for k, v in state.model.state_dict().items()
            if k.startswith(TFT.TRAINED + ".")}


def test_loss_matches_jax(setup):
    """The batched loss and accuracy against JAX's vmapped ``loss_fn``."""
    jcfg, cfg, params, batches = setup
    _, jloss = JFT.make_finetune_step(jcfg)
    model = RadarGNN(cfg)
    model.load_state_dict(state_dict_from_flax(jax.tree.map(np.asarray, params)))
    loss_fn = TFT.make_finetune_step(cfg)[1]
    for b in batches:
        want, wm = jloss(params, jax.tree.map(jnp.asarray, b))
        with torch.no_grad():
            got, gm = loss_fn(model.eval(), GraphBatch.from_numpy(b))
        np.testing.assert_allclose(float(got), float(want), **TOL)
        np.testing.assert_allclose(float(gm["object_accuracy"]),
                                   float(wm["object_accuracy"]), **TOL)


def test_batched_loss_equals_one_deploy_a_graph(setup):
    """One deploy for the batch against the reference's loop: one deploy a
    graph, its sums added in graph order, then divided."""
    _, cfg, params, batches = setup
    model = RadarGNN(cfg)
    model.load_state_dict(state_dict_from_flax(jax.tree.map(np.asarray, params)))
    model.eval()
    loss_fn = TFT.make_finetune_step(cfg)[1]
    batch = GraphBatch.from_numpy(batches[0])
    sums = []
    with torch.no_grad():
        got, gm = loss_fn(model, batch)
        for i in range(BATCH):
            g, lbl = batch.graph.at(i), batch.labels.at(i)
            out = model.deploy(g, eps=cfg.clustering_eps)
            n = g.num_nodes
            gt = TFT.majority_vote_labels(lbl.node_class, out.node2cluster, g.node_mask, n,
                                          cfg.num_classes)
            cm = (torch.arange(n) < out.num_clusters).float()
            ce = TL.cross_entropy(out.obj_cls, TL.one_hot(gt, cfg.num_classes))
            sums.append(torch.stack([(ce * cm).sum(), cm.sum()]))
    total, cnt = torch.stack(sums).sum(0)
    np.testing.assert_allclose(float(got), float(total / cnt), **TOL)


def test_majority_vote_with_a_graph_axis_is_per_graph(rng):
    """``majority_vote_labels`` over [B, N] equals one call a graph bit for
    bit, and JAX's vmap."""
    b, n, c, k = 3, 40, 10, 7
    cls = rng.integers(0, k, (b, n)).astype(np.int32)
    n2c = rng.integers(0, c + 1, (b, n)).astype(np.int32)  # c = void
    mask = rng.random((b, n)) > 0.2
    got = TFT.majority_vote_labels(torch.from_numpy(cls), torch.from_numpy(n2c),
                                   torch.from_numpy(mask), c, k)
    for i in range(b):
        one = TFT.majority_vote_labels(torch.from_numpy(cls[i]), torch.from_numpy(n2c[i]),
                                       torch.from_numpy(mask[i]), c, k)
        assert torch.equal(got[i], one)
    want = jax.vmap(lambda a, s, m: JFT.majority_vote_labels(a, s, m, c, k))(
        jnp.asarray(cls), jnp.asarray(n2c), jnp.asarray(mask))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_steps_match_jax(setup):
    """Three steps: loss, accuracy and the head's parameters within 1e-5
    of JAX's after each; the trunk bit for bit as loaded; the optimiser the
    flat one, over the head only."""
    jcfg, cfg, params, batches = setup
    jstep, jstate, step, state = _states(jcfg, cfg, params)
    assert isinstance(state.optimizer, Optimizer)
    head = {id(p) for p in getattr(state.model, TFT.TRAINED).parameters()}
    assert {id(p) for p in state.optimizer.params} == head
    trunk = {k: v.clone() for k, v in state.model.state_dict().items()
             if not k.startswith(TFT.TRAINED + ".")}
    for i, b in enumerate(batches):
        jstate, jm = jstep(jstate, jax.tree.map(jnp.asarray, b))
        state, m = step(state, b)
        assert float(m["skipped"]) == float(jm["skipped"]) == 0.0
        for k in ("loss_obj_cls", "object_accuracy"):
            np.testing.assert_allclose(float(m[k]), float(jm[k]), **TOL, err_msg=f"{i} {k}")
        want = state_dict_from_flax(jax.tree.map(np.asarray, jstate.params))
        for k, v in _head(state).items():
            np.testing.assert_allclose(v.numpy(), want[k].numpy(), **TOL, err_msg=f"{i} {k}")
    assert all(torch.equal(v, state.model.state_dict()[k]) for k, v in trunk.items())
    assert state.step == state.updates == STEPS


def test_nan_batch_keeps_head_and_momentum_bitwise(setup):
    """After a real step (momentum no longer zero), a batch with a NaN node
    feature is skipped in both packages: the head's parameters and the
    momentum buffer keep their bits, the step is counted, no update."""
    jcfg, cfg, params, batches = setup
    jstep, jstate, step, state = _states(jcfg, cfg, params)
    jstate, _ = jstep(jstate, jax.tree.map(jnp.asarray, batches[0]))
    state, _ = step(state, batches[0])
    head, moments = _head(state), state.optimizer.moments["momentum_buffer"].clone()
    assert moments.abs().sum() > 0
    node_feat = batches[1].graph.node_feat.copy()
    node_feat[1, 0, 0] = np.nan
    bad = dataclasses.replace(batches[1],
                              graph=dataclasses.replace(batches[1].graph, node_feat=node_feat))
    jstate, jm = jstep(jstate, jax.tree.map(jnp.asarray, bad))
    state, m = step(state, bad)
    assert float(m["skipped"]) == float(jm["skipped"]) == 1.0
    assert all(torch.equal(v, _head(state)[k]) for k, v in head.items())
    assert torch.equal(state.optimizer.moments["momentum_buffer"], moments)
    assert state.step == 2 and state.updates == 1


def _trunk_overflow(batch):
    """The batch with one padded (masked) edge of graph 1 given features of
    3e38, finite: its encoding overflows, the masked sum drops it, so the
    loss and the head's gradient stay finite, but the trunk's gradient is
    NaN (0 x inf in the encoder's and message MLP's weight gradients)."""
    mask = batch.graph.edge_mask
    edge = int(np.flatnonzero(~mask[1])[0])
    edge_feat = batch.graph.edge_feat.copy()
    edge_feat[1, edge, :] = 3e38
    return dataclasses.replace(batch, graph=dataclasses.replace(batch.graph,
                                                                edge_feat=edge_feat))


def test_trunk_gradient_alone_not_finite_skips_as_jax(setup):
    """ROADMAP C6: a batch of finite inputs whose loss and head gradient
    are finite but whose frozen trunk gradient is not.  JAX's step skips it
    (``all_finite`` over the whole tree); so does the port's, keeping the
    head, its momentum and the trunk bit for bit, the step counted."""
    jcfg, cfg, params, batches = setup
    bad = _trunk_overflow(batches[1])
    assert np.isfinite(bad.graph.edge_feat).all()
    # The case on the JAX side: loss and head gradient finite, trunk not.
    _, jloss = JFT.make_finetune_step(jcfg)
    jbad = jax.tree.map(jnp.asarray, bad)
    loss, grads = jax.jit(jax.value_and_grad(lambda p, b: jloss(p, b)[0]))(params, jbad)
    finite = {k: all(bool(jnp.isfinite(x).all()) for x in jax.tree.leaves(v))
              for k, v in grads.items()}
    assert np.isfinite(float(loss)) and finite["predict_class"]
    assert not finite["pass_messages"] and not finite["encode_edge_feat"]

    jstep, jstate, step, state = _states(jcfg, cfg, params)
    jstate, _ = jstep(jstate, jax.tree.map(jnp.asarray, batches[0]))
    state, _ = step(state, batches[0])
    head, moments = _head(state), state.optimizer.moments["momentum_buffer"].clone()
    trunk = {k: v.clone() for k, v in state.model.state_dict().items()
             if not k.startswith(TFT.TRAINED + ".")}
    assert moments.abs().sum() > 0
    jstate, jm = jstep(jstate, jbad)
    state, m = step(state, bad)
    assert float(m["skipped"]) == float(jm["skipped"]) == 1.0
    np.testing.assert_allclose(float(m["loss_obj_cls"]), float(jm["loss_obj_cls"]), **TOL)
    assert all(torch.equal(v, _head(state)[k]) for k, v in head.items())
    assert torch.equal(state.optimizer.moments["momentum_buffer"], moments)
    assert all(torch.equal(v, state.model.state_dict()[k]) for k, v in trunk.items())
    assert state.step == 2 and state.updates == 1
    # The next ordinary batch is taken again, as in JAX.
    jstate, jm = jstep(jstate, jax.tree.map(jnp.asarray, batches[2]))
    state, m = step(state, batches[2])
    assert float(m["skipped"]) == float(jm["skipped"]) == 0.0
    want = state_dict_from_flax(jax.tree.map(np.asarray, jstate.params))
    for k, v in _head(state).items():
        np.testing.assert_allclose(v.numpy(), want[k].numpy(), **TOL, err_msg=k)


def test_trunk_gradient_reaches_the_check(setup):
    """The step takes the trunk's gradient (every parameter keeps
    ``requires_grad``; the optimiser holds the head alone): a test-side
    hook that makes one trunk gradient infinite skips the batch, with the
    head, its momentum and the trunk bit for bit."""
    jcfg, cfg, params, batches = setup
    _, _, step, state = _states(jcfg, cfg, params)
    state, _ = step(state, batches[0])
    head, moments = _head(state), state.optimizer.moments["momentum_buffer"].clone()
    before = {k: v.clone() for k, v in state.model.state_dict().items()}
    weight = state.model.pass_messages.blocks[0].msg_mlp.blocks[0].linear.weight
    hook = weight.register_hook(lambda g: g * float("inf"))
    try:
        state, m = step(state, batches[1])
    finally:
        hook.remove()
    assert float(m["skipped"]) == 1.0 and np.isfinite(float(m["loss_obj_cls"]))
    assert torch.equal(state.optimizer.moments["momentum_buffer"], moments)
    assert all(torch.equal(v, before[k]) for k, v in state.model.state_dict().items())
    assert all(torch.equal(v, _head(state)[k]) for k, v in head.items())
    state, m = step(state, batches[1])
    assert float(m["skipped"]) == 0.0 and (state.step, state.updates) == (3, 2)
