"""The port's stage-2 object classifier and the object-head finetuning
against the JAX package's at small widths, from the same seeded numpy
inputs and carried weights: classifier samples (bitwise), forward, focal
loss and three SGD steps with the NaN skip (tests/test_classifier.py's
patterns); majority-vote labels and three finetuning steps that move only
``predict_class`` (tests/test_infer_eval.py::TestFinetune's pattern)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from graph_neural_network_for_radar_perception_torch.config.config import (
    tiny_test_config,
)
from graph_neural_network_for_radar_perception_torch.models import classifier as TCL
from graph_neural_network_for_radar_perception_torch.models.gnn import RadarGNN
from graph_neural_network_for_radar_perception_torch.train import finetune as TFT
from graph_neural_network_for_radar_perception_torch.train.steps import Optimizer, TrainState
from graph_neural_network_for_radar_perception_torch.utils.convert import (
    classifier_state_dict_from_flax,
    state_dict_from_flax,
)
from graph_neural_network_for_radar_perception_tpu.config import config as JC
from graph_neural_network_for_radar_perception_tpu.data.pipeline import (
    SyntheticRadarDataset,
    pad_frame,
    stack_batch,
)
from graph_neural_network_for_radar_perception_tpu.models import classifier as JCL
from graph_neural_network_for_radar_perception_tpu.train import finetune as JFT
from graph_neural_network_for_radar_perception_tpu.train.steps import (
    TrainState as JTrainState,
)
from graph_neural_network_for_radar_perception_tpu.train.steps import init_params
from torch_port_fixtures import one_torch_thread  # noqa: F401  (autouse)

# Small widths, f32 on two CPU backends: forward and loss; metrics and
# params after each SGD step (an update of lr·grad moves params by ~1e-3).
TOL = dict(rtol=1e-5, atol=1e-5)
STEP_TOL = dict(rtol=1e-5, atol=1e-6)
STEPS = 3


def tiny_ccfg(**kw):
    """tests/test_classifier.py's widths, with a projector in conv_1."""
    base = dict(node_feat_enc_stem_channels=(32, 32),
                graph_convolution_stem_channels=(32, 24),
                msg_mlp_hidden_dim=32, node_pred_stem_channels=(32, 32),
                max_points=128, max_objects=16, max_edges=1024,
                learning_rate=0.01)
    base.update(kw)
    return base


@pytest.fixture(scope="module")
def samples():
    """Four frames' samples from each package's builder (same frames)."""
    kw = tiny_ccfg()
    tc, jc = TCL.ClassifierConfig(**kw), JCL.ClassifierConfig(**kw)
    ds = SyntheticRadarDataset(JC.tiny_test_config(), seed=0, num_objects=2)
    ts, js = [], []
    while len(ts) < 4:
        fr = ds.sample_frame()
        args = (fr.other_feat[:, :2], fr.node_feat[:, 1], fr.node_class,
                fr.node2cluster, int(fr.cluster_class.shape[0]))
        t, j = TCL.build_classifier_sample(*args, tc), JCL.build_classifier_sample(*args, jc)
        assert (t is None) == (j is None)
        if t is not None:
            ts.append(t)
            js.append(j)
    return tc, jc, ts, js


def _jbatch(js):
    return JCL.ClassifierSample(*[jnp.asarray(np.stack([getattr(s, f) for s in js]))
                                  for f in JCL.ClassifierSample._fields])


def _models(tc, jc, js, seed=0):
    jmodel = JCL.ObjectClassifierGNN(jc)
    params = jmodel.init(jax.random.key(seed), jax.tree.map(jnp.asarray, js[0]))["params"]
    model = TCL.ObjectClassifierGNN(tc)
    model.load_state_dict(classifier_state_dict_from_flax(jax.tree.map(np.asarray, params)))
    return jmodel, params, model


def test_samples_equal_jax_bitwise(samples):
    tc, _, ts, js = samples
    for t, j in zip(ts, js):
        for f in JCL.ClassifierSample._fields:
            a, b = getattr(t, f), getattr(j, f)
            assert a.dtype == b.dtype and a.shape == b.shape, f
            np.testing.assert_array_equal(a, b, err_msg=f)
        assert t.point_feat.shape == (tc.max_points, 5)
        em = t.edge_mask
        assert (t.point2object[t.senders[em]] == t.point2object[t.receivers[em]]).all()


def test_small_clusters_dropped_as_jax():
    xy = np.array([[0, 0], [1, 0], [0, 1], [5, 5], [6, 5]], np.float32)
    args = (xy, np.zeros(5, np.float32), np.array([0, 0, 0, 2, 2], np.int32),
            np.array([0, 0, 0, 1, 1], np.int32), 2)
    kw = tiny_ccfg(valid_cluster_num_meas_thr=3)
    t = TCL.build_classifier_sample(*args, TCL.ClassifierConfig(**kw))
    j = JCL.build_classifier_sample(*args, JCL.ClassifierConfig(**kw))
    assert int(t.object_mask.sum()) == 1 and int(t.object_class[0]) == 0
    for a, b in zip(t, j):
        np.testing.assert_array_equal(a, b)


def test_forward_and_loss_match_jax(samples):
    tc, jc, ts, js = samples
    jmodel, params, model = _models(tc, jc, js)
    assert len(model.state_dict()) == len(jax.tree.leaves(params))
    assert model.convs[1].identity is not None  # 32 → 24: the projector
    for t, j in zip(ts, js):
        jj = jax.tree.map(jnp.asarray, j)
        want = jmodel.apply({"params": params}, jj)
        tt = t.to("cpu")
        with torch.no_grad():
            got = model(tt)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
        gl, ga = TCL.classifier_loss(got, tt, tc.num_classes)
        wl, wa = JCL.classifier_loss(want, jj, jc.num_classes)
        np.testing.assert_allclose(float(gl), float(wl), **TOL)
        assert float(ga) == float(wa)


def _poisoned(batch):
    feat = np.array(batch.point_feat)
    feat[0, 0, 0] = np.nan
    return batch._replace(point_feat=feat)


def test_train_steps_match_jax(samples):
    """Three steps (weight decay, then SGD with momentum 0.9) from the same
    weights: metrics and every parameter after each step; then a poisoned
    batch is skipped whole on both."""
    tc, jc, ts, js = samples
    _, jinit, jstep, _ = JCL.make_classifier_train_step(jc)
    jstate = jinit(jax.random.key(0), js[0])
    init, step, _ = TCL.make_classifier_train_step(tc)
    state = init(device="cpu")
    state.model.load_state_dict(classifier_state_dict_from_flax(
        jax.tree.map(np.asarray, jstate.params)))
    batch, jbatch = TCL.stack_samples(ts), _jbatch(js)
    for i in range(STEPS):
        jstate, jm = jstep(jstate, jbatch)
        state, m = step(state, batch)
        for k in ("loss_obj_cls", "object_accuracy", "skipped"):
            np.testing.assert_allclose(float(m[k]), float(jm[k]), **STEP_TOL,
                                       err_msg=f"step {i} {k}")
        want = classifier_state_dict_from_flax(jax.tree.map(np.asarray, jstate.params))
        for k, v in state.model.state_dict().items():
            np.testing.assert_allclose(v.numpy(), want[k].numpy(), **STEP_TOL,
                                       err_msg=f"step {i} {k}")
    assert state.step == state.updates == STEPS
    before = {k: v.clone() for k, v in state.model.state_dict().items()}
    bad = _poisoned(batch)
    jstate, jm = jstep(jstate, JCL.ClassifierSample(*map(jnp.asarray, bad)))
    state, m = step(state, bad)
    assert float(m["skipped"]) == float(jm["skipped"]) == 1.0
    assert all(torch.equal(v, before[k]) for k, v in state.model.state_dict().items())
    assert state.updates == STEPS and state.step == STEPS + 1


def test_batched_loss_is_one_model_call_and_matches_jax(samples):
    """``loss_fn`` over a batch: one model call (a leading sample axis, the
    JAX step's vmap), the loss and accuracy of JAX's vmapped ``loss_fn``,
    and the mean of one call a sample."""
    tc, jc, ts, js = samples
    _, params, model = _models(tc, jc, js)
    _, _, _, jloss = JCL.make_classifier_train_step(jc)
    _, _, loss_fn = TCL.make_classifier_train_step(tc)
    batch = TCL.stack_samples(ts).to("cpu")
    calls = []
    hook = model.register_forward_hook(lambda m, i, o: calls.append(o.shape))
    with torch.no_grad():
        loss, acc = loss_fn(model, batch)
    hook.remove()
    assert calls == [(len(ts), tc.max_objects, tc.num_classes)]
    want_loss, want_acc = jloss(params, _jbatch(js))
    np.testing.assert_allclose(float(loss), float(want_loss), **TOL)
    np.testing.assert_allclose(float(acc), float(want_acc), **TOL)
    with torch.no_grad():
        one = [TCL.classifier_loss(model(batch.at(b)), batch.at(b), tc.num_classes)
               for b in range(len(ts))]
    np.testing.assert_allclose(float(loss), float(torch.stack([o[0] for o in one]).mean()),
                               **TOL)
    np.testing.assert_allclose(float(acc), float(torch.stack([o[1] for o in one]).mean()),
                               **TOL)


def test_two_steps_then_a_nan_sample_skips_bitwise(samples):
    """Two steps against JAX's jitted step on the flat optimiser, then a
    batch with one NaN sample: skipped whole in both packages, the
    parameters and the momentum buffer bit for bit, the step counted."""
    tc, jc, ts, js = samples
    _, jinit, jstep, _ = JCL.make_classifier_train_step(jc)
    jstate = jinit(jax.random.key(1), js[0])
    init, step, _ = TCL.make_classifier_train_step(tc)
    state = init(device="cpu")
    assert isinstance(state.optimizer, Optimizer)
    state.model.load_state_dict(classifier_state_dict_from_flax(
        jax.tree.map(np.asarray, jstate.params)))
    batch, jbatch = TCL.stack_samples(ts), _jbatch(js)
    for i in range(2):
        jstate, jm = jstep(jstate, jbatch)
        state, m = step(state, batch)
        for k in ("loss_obj_cls", "object_accuracy", "skipped"):
            np.testing.assert_allclose(float(m[k]), float(jm[k]), **STEP_TOL,
                                       err_msg=f"step {i} {k}")
        want = classifier_state_dict_from_flax(jax.tree.map(np.asarray, jstate.params))
        for k, v in state.model.state_dict().items():
            np.testing.assert_allclose(v.numpy(), want[k].numpy(), **STEP_TOL,
                                       err_msg=f"step {i} {k}")
    flat = state.optimizer.flat.clone()
    moments = state.optimizer.moments["momentum_buffer"].clone()
    assert moments.abs().sum() > 0
    feat = np.array(batch.point_feat)
    feat[2, 1, 3] = np.nan  # one sample of four
    bad = batch._replace(point_feat=feat)
    jstate, jm = jstep(jstate, JCL.ClassifierSample(*map(jnp.asarray, bad)))
    state, m = step(state, bad)
    assert float(m["skipped"]) == float(jm["skipped"]) == 1.0
    assert torch.equal(state.optimizer.flat, flat)
    assert torch.equal(state.optimizer.moments["momentum_buffer"], moments)
    assert (state.step, state.updates) == (3, 2)


def test_classifier_refuses_the_card_without_one(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    init, _, _ = TCL.make_classifier_train_step(TCL.ClassifierConfig(**tiny_ccfg()))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        init()  # default device: the card


# --- finetuning -------------------------------------------------------------

def test_majority_vote_labels_match_jax(rng):
    n, c, k = 50, 12, 7
    cls = rng.integers(0, k, n).astype(np.int32)
    n2c = rng.integers(0, c + 1, n).astype(np.int32)  # c = void
    mask = rng.random(n) > 0.2
    got = TFT.majority_vote_labels(torch.from_numpy(cls), torch.from_numpy(n2c),
                                   torch.from_numpy(mask), c, k)
    want = JFT.majority_vote_labels(jnp.asarray(cls), jnp.asarray(n2c),
                                    jnp.asarray(mask), c, k)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.fixture(scope="module")
def finetune_setup():
    overrides = dict(batch_size=2)
    jcfg, cfg = JC.tiny_test_config(**overrides), tiny_test_config(**overrides)
    params = init_params(jcfg, jax.random.key(0))
    ds = SyntheticRadarDataset(jcfg, seed=4, num_objects=2)
    batches = [stack_batch([pad_frame(ds.sample_frame(), jcfg) for _ in range(2)])
               for _ in range(STEPS)]
    return jcfg, cfg, params, batches


def _finetune_states(jcfg, cfg, params):
    build, _ = JFT.make_finetune_step(jcfg)
    jstep, tx = build(params)
    jstate = JTrainState(params, tx.init(params), jnp.zeros((), jnp.int32))
    model = RadarGNN(cfg)
    model.load_state_dict(state_dict_from_flax(jax.tree.map(np.asarray, params)))
    tbuild, _ = TFT.make_finetune_step(cfg)
    step, opt = tbuild(model)
    return jstep, jstate, step, TrainState(model, opt)


def test_finetune_updates_only_object_head_as_jax(finetune_setup):
    """Three steps: the same metrics, ``predict_class`` within STEP_TOL of
    JAX after each step and moved; everything else bit for bit as loaded
    (JAX's set_to_zero; the port's optimiser holds ``predict_class`` alone
    and every parameter keeps ``requires_grad`` for the finiteness
    check)."""
    jcfg, cfg, params, batches = finetune_setup
    jstep, jstate, step, state = _finetune_states(jcfg, cfg, params)
    loaded = {k: v.clone() for k, v in state.model.state_dict().items()}
    assert all(p.requires_grad for p in state.model.parameters())
    assert {id(p) for p in state.optimizer.params} == {
        id(p) for n, p in state.model.named_parameters() if n.startswith("predict_class.")}
    for i, b in enumerate(batches):
        jstate, jm = jstep(jstate, jax.tree.map(jnp.asarray, b))
        state, m = step(state, b)
        assert float(m["skipped"]) == float(jm["skipped"]) == 0.0
        for k in ("loss_obj_cls", "object_accuracy"):
            np.testing.assert_allclose(float(m[k]), float(jm[k]), **STEP_TOL,
                                       err_msg=f"step {i} {k}")
        want = state_dict_from_flax(jax.tree.map(np.asarray, jstate.params))
        for k, v in state.model.state_dict().items():
            np.testing.assert_allclose(v.numpy(), want[k].numpy(), **STEP_TOL,
                                       err_msg=f"step {i} {k}")
    changed = {k.split(".")[0] for k, v in state.model.state_dict().items()
               if not torch.equal(v, loaded[k])}
    assert changed == {"predict_class"}
    assert state.step == state.updates == STEPS


def test_finetune_nan_skip_agrees_with_jax(finetune_setup):
    """The ordinary skip: a NaN in a node feature makes the loss NaN, and
    both packages skip the batch with nothing changed.  (A batch whose
    frozen trunk gradient alone is not finite:
    tests/test_torch_finetune_batched.py.)"""
    jcfg, cfg, params, batches = finetune_setup
    jstep, jstate, step, state = _finetune_states(jcfg, cfg, params)
    node_feat = batches[0].graph.node_feat.copy()
    node_feat[0, 0, 0] = np.nan
    bad = dataclasses.replace(batches[0],
                              graph=dataclasses.replace(batches[0].graph, node_feat=node_feat))
    loaded = {k: v.clone() for k, v in state.model.state_dict().items()}
    jstate, jm = jstep(jstate, jax.tree.map(jnp.asarray, bad))
    state, m = step(state, bad)
    assert float(m["skipped"]) == float(jm["skipped"]) == 1.0
    assert all(torch.equal(v, loaded[k]) for k, v in state.model.state_dict().items())
    assert state.updates == 0 and state.step == 1
    # The skip keeps the momentum buffer at optax's init: zero.
    assert all(not s["momentum_buffer"].any() for s in state.optimizer.state.values())
