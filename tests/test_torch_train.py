"""The port's training slice against the JAX package on the same weights
(JAX ``create_train_state`` converted by ``state_dict_from_flax``) and the
same numpy batches: the loss, the train step with SGD and AdamW, the
schedule's milestones, gradient accumulation and the NaN skip.  All on the
CPU, where the fused round runs its plain forward and backward."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from graph_neural_network_for_radar_perception_torch.config.config import (
    tiny_test_config,
)
from graph_neural_network_for_radar_perception_torch.core.graph import (
    GraphBatch,
    GraphLabels,
    RadarGraph,
)
from graph_neural_network_for_radar_perception_torch.data import pipeline as PS
from graph_neural_network_for_radar_perception_torch.models.gnn import GNNOutputs
from graph_neural_network_for_radar_perception_torch.train import loss as TL
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
from graph_neural_network_for_radar_perception_tpu.models.gnn import (
    GNNOutputs as JaxGNNOutputs,
)
from graph_neural_network_for_radar_perception_tpu.train import loss as JL
from graph_neural_network_for_radar_perception_tpu.train import steps as T
from torch_port_fixtures import one_torch_thread  # noqa: F401  (autouse)

STEP_TOL = dict(rtol=1e-4, atol=1e-6)


def _states(overrides, seed=0):
    """JAX TrainState and the port's, with the same initial weights."""
    jcfg, cfg = JC.tiny_test_config(**overrides), tiny_test_config(**overrides)
    js = T.create_train_state(jcfg, jax.random.key(seed))
    st = S.create_train_state(cfg, device="cpu")
    st.model.load_state_dict(state_dict_from_flax(jax.tree.map(np.asarray, js.params)))
    return jcfg, cfg, js, st


def _batches(jcfg, k, seed=5):
    gen = SyntheticRadarDataset(jcfg, seed=seed, num_objects=3).batches(jcfg.batch_size)
    return [next(gen) for _ in range(k)]


def _params(js):
    return state_dict_from_flax(jax.tree.map(np.asarray, js.params))


# ---------------------------------------------------------------------- loss
def test_loss_sums_match_jax(rng):
    """graph_loss_sums per graph of a padded batch, summed, then
    reduce_loss_sums, on the same random outputs."""
    jcfg, cfg = JC.tiny_test_config(), tiny_test_config()
    batch = _batches(jcfg, 1)[0]
    n, eu, c = jcfg.max_nodes, jcfg.max_und_edges, jcfg.max_clusters
    t_sums, j_sums = [], []
    for b in range(batch.graph.node_feat.shape[0]):
        outs = [3 * rng.normal(size=s).astype(np.float32) for s in (
            (n, jcfg.num_classes), (n, 2), (eu, jcfg.num_edge_classes),
            (c, jcfg.num_classes), (n, 16))]
        jg = jax.tree.map(lambda x: jnp.asarray(x[b]), batch.graph)
        jl = jax.tree.map(lambda x: jnp.asarray(x[b]), batch.labels)
        j_sums.append(JL.graph_loss_sums(
            JaxGNNOutputs(*map(jnp.asarray, outs)), jg, jl, jcfg))
        t_sums.append(TL.graph_loss_sums(
            GNNOutputs(*map(torch.from_numpy, outs)),
            RadarGraph.from_numpy(batch.graph).at(b),
            GraphLabels.from_numpy(batch.labels).at(b), cfg))
    want_sums = JL.tree_sum(jax.tree.map(lambda *x: jnp.stack(x), *j_sums))
    got_sums = TL.tree_sum(t_sums)
    for name in TL.LossSums._fields:
        np.testing.assert_allclose(float(getattr(got_sums, name)),
                                   float(getattr(want_sums, name)),
                                   rtol=1e-5, err_msg=name)
    got_total, got = TL.reduce_loss_sums(got_sums, cfg)
    want_total, want = JL.reduce_loss_sums(want_sums, jcfg)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=1e-5,
                                   err_msg=k)
    np.testing.assert_allclose(float(got_total), float(want_total), rtol=1e-5)


# ----------------------------------------------------------------- the step
def _assert_metrics(pm, jm):
    assert set(pm) == set(jm)
    for k in jm:
        np.testing.assert_allclose(float(pm[k]), float(jm[k]), **STEP_TOL,
                                   err_msg=k)


def test_sgd_steps_match_jax():
    jcfg, cfg, js, st = _states({})
    jstep, pstep = T.make_train_step(jcfg), S.make_train_step(cfg)
    for b in _batches(jcfg, 3):
        js, jm = jstep(js, jax.tree.map(jnp.asarray, b))
        st, pm = pstep(st, b)
        _assert_metrics(pm, jm)
    assert st.step == 3 and st.updates == 3
    got, want = st.model.state_dict(), _params(js)
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(), **STEP_TOL,
                                   err_msg=k)


def test_train_scan_on_stacked_batches_matches_jax():
    """Three batches stacked on a leading axis with length=2: the port's
    make_train_scan takes one step per batch, as JAX's lax.scan over the
    stacked axis does (length applies only to one reused batch)."""
    jcfg, cfg, js, st = _states({})
    jb = _batches(jcfg, 3)
    jstack = stack_batch([(b.graph, b.labels) for b in jb])
    js, jm = T.make_train_scan(jcfg, 2)(js, jax.tree.map(jnp.asarray, jstack))
    port = [GraphBatch.from_numpy(b, "cpu") for b in jb]
    pstack = PS.stack_batch([(b.graph, b.labels) for b in port])
    st, pm = S.make_train_scan(cfg, 2)(st, pstack)
    assert st.step == 3 and st.updates == 3
    _assert_metrics(pm, jm)
    got, want = st.model.state_dict(), _params(js)
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(), **STEP_TOL,
                                   err_msg=k)


def test_adamw_steps_match_jax():
    """Three AdamW steps: the metrics of every step match; so do the first
    step's gradients and, wherever |g| > 1e-6 (98 % of the elements), the
    params after it.  Adam divides by sqrt(v) + 1e-8, so an element with a
    tiny gradient, or with gradients that cancel across steps in the first
    moment, turns an f32 rounding difference of the gradient into a visible
    update difference; after three steps every element is held within
    0.2·lr of JAX's (each update moves it by at most ~lr).  The update rule
    itself is held exactly on shared gradients in
    test_optimizer_updates_match_optax."""
    jcfg, cfg, js, st = _states({"optim": "adamw"})
    jstep, pstep = T.make_train_step(jcfg), S.make_train_step(cfg)
    b0, *rest = _batches(jcfg, 3)
    jb = jax.tree.map(jnp.asarray, b0)
    jgrad = jax.grad(lambda p: T.make_loss_fn(jcfg)(p, jb)[0])(js.params)
    want_g = state_dict_from_flax(jax.tree.map(np.asarray, jgrad))
    S.make_loss_fn(cfg)(st.model, S.batch_on(b0, "cpu"))[0].backward()
    for k, p in st.model.named_parameters():
        w = want_g[k].numpy()
        np.testing.assert_allclose(p.grad.numpy(), w, rtol=0,
                                   atol=1e-4 * np.abs(w).max(), err_msg=k)
    js, jm = jstep(js, jb)
    st, pm = pstep(st, b0)
    _assert_metrics(pm, jm)
    got, want = st.model.state_dict(), _params(js)
    kept = total = 0
    for k in want:
        keep = np.abs(want_g[k].numpy()) > 1e-6
        kept += int(keep.sum())
        total += keep.size
        np.testing.assert_allclose(got[k].numpy()[keep], want[k].numpy()[keep],
                                   **STEP_TOL, err_msg=k)
    assert kept > 0.95 * total
    for b in rest:
        js, jm = jstep(js, jax.tree.map(jnp.asarray, b))
        st, pm = pstep(st, b)
        _assert_metrics(pm, jm)
    got, want = st.model.state_dict(), _params(js)
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(), rtol=0,
                                   atol=0.2 * cfg.learning_rate, err_msg=k)


@pytest.mark.parametrize("optim", ["sgd", "adamw"])
def test_optimizer_updates_match_optax(rng, optim):
    """make_optimizer + lr_schedule against the JAX package's optax chain on
    the same gradient sequence, across both milestones (updates 0-4,
    milestones at 2 and 4)."""
    jcfg = JC.tiny_test_config(optim=optim, max_train_iter=5)
    cfg = tiny_test_config(optim=optim, max_train_iter=5)
    assert cfg.lr_milestones == [2, 4]
    params = {"a": rng.normal(size=(6, 3)).astype(np.float32),
              "b": rng.normal(size=(4,)).astype(np.float32)}
    tx = T.make_optimizer(jcfg)
    jp = jax.tree.map(jnp.asarray, params)
    opt_state = tx.init(jp)
    tp = [torch.nn.Parameter(torch.from_numpy(v.copy())) for v in params.values()]
    opt = S.make_optimizer(cfg, tp)
    sched = S.lr_schedule(cfg)
    for count in range(5):
        g = {k: rng.normal(size=v.shape).astype(np.float32)
             * (1e-3 if k == "b" else 1.0) for k, v in params.items()}
        g["b"][0] = 3e-9  # an element within eps of zero: same bits in both
        updates, opt_state = tx.update(jax.tree.map(jnp.asarray, g), opt_state, jp)
        jp = jax.tree.map(lambda p, u: p + u, jp, updates)
        for p, v in zip(tp, g.values()):
            p.grad = torch.from_numpy(v)
        for group in opt.param_groups:
            group["lr"] = sched(count)
        opt.step()
        for p, k in zip(tp, params):
            np.testing.assert_allclose(p.detach().numpy(), np.asarray(jp[k]),
                                       rtol=1e-6, atol=1e-7, err_msg=f"{k}@{count}")


def test_lr_schedule_pins_the_milestones():
    """The schedule against optax's at and around both milestones, and the
    rate each SGD update really used: p_new = p_old − lr · buf."""
    jcfg = JC.tiny_test_config(max_train_iter=10)
    cfg = tiny_test_config(max_train_iter=10)
    m1, m2 = cfg.lr_milestones
    want, got = T.lr_schedule(jcfg), S.lr_schedule(cfg)
    for count in (0, m1 - 1, m1, m1 + 1, m2 - 1, m2, m2 + 1, 10**6):
        np.testing.assert_allclose(got(count), float(want(count)), rtol=1e-7,
                                   err_msg=str(count))
    assert got(m1 - 1) == float(np.float32(cfg.learning_rate)) > got(m1)

    st = S.create_train_state(cfg, device="cpu")
    step = S.make_train_step(cfg)
    batch = _batches(jcfg, 1)[0]
    p = st.model.predict_node.head.out.weight
    for u in range(m2 + 2):
        before = p.detach().clone()
        st, m = step(st, batch)
        assert float(m["skipped"]) == 0.0 and st.updates == u + 1
        buf = st.optimizer.state[p]["momentum_buffer"]
        np.testing.assert_allclose(p.detach().numpy(),
                                   (before - got(u) * buf).numpy(),
                                   rtol=1e-6, atol=1e-9, err_msg=f"update {u}")


def test_grad_accumulation_matches_large_batch():
    """k=2 micro-batches of one graph == one step on the batch of both (the
    JAX package's test_accumulated_matches_large_batch)."""
    cfg1 = tiny_test_config(batch_size=1, grad_accumulation_steps=2)
    cfg2 = tiny_test_config(batch_size=2)
    jcfg = JC.tiny_test_config(batch_size=1)
    item = pad_frame(SyntheticRadarDataset(jcfg, seed=13, num_objects=2).sample_frame(), jcfg)
    b1, b2 = stack_batch([item]), stack_batch([item, item])

    s_acc = S.create_train_state(cfg1, device="cpu")
    s_big = S.create_train_state(cfg2, device="cpu")
    s_big.model.load_state_dict(s_acc.model.state_dict())
    start = {k: v.clone() for k, v in s_acc.model.state_dict().items()}
    step_acc, step_big = S.make_train_step(cfg1), S.make_train_step(cfg2)

    s_acc, _ = step_acc(s_acc, b1)
    assert s_acc.updates == 0 and s_acc.mini_step == 1
    for k, v in s_acc.model.state_dict().items():
        assert torch.equal(v, start[k]), k  # accumulating: unchanged
    s_acc, _ = step_acc(s_acc, b1)
    s_big, _ = step_big(s_big, b2)
    assert s_acc.updates == s_big.updates == 1 and s_acc.mini_step == 0
    big = s_big.model.state_dict()
    for k, v in s_acc.model.state_dict().items():
        np.testing.assert_allclose(v.numpy(), big[k].numpy(), rtol=1e-5,
                                   atol=1e-7, err_msg=k)


def _poison(batch):
    node_feat = batch.graph.node_feat.copy()
    node_feat[0, 0, 0] = np.nan
    return dataclasses.replace(
        batch, graph=dataclasses.replace(batch.graph, node_feat=node_feat))


@pytest.mark.parametrize("accumulate", [1, 2])
def test_nan_batch_is_skipped(accumulate):
    """A non-finite batch leaves params, momentum, the accumulation buffer
    and the schedule's count bit-identical, counts the step and reports
    skipped = 1 (as the JAX step does for the same batch)."""
    jcfg = JC.tiny_test_config(grad_accumulation_steps=accumulate)
    cfg = tiny_test_config(grad_accumulation_steps=accumulate)
    good, = _batches(jcfg, 1)
    st = S.create_train_state(cfg, device="cpu")
    step = S.make_train_step(cfg)
    st, _ = step(st, good)
    st, _ = step(st, good)  # momentum (and, for k=2, one applied update)
    st, _ = step(st, good)  # k=2: a half-full accumulation buffer
    params = {k: v.clone() for k, v in st.model.state_dict().items()}
    moments = {id(p): {k: v.clone() for k, v in s.items() if torch.is_tensor(v)}
               for p, s in st.optimizer.state.items()}
    acc = None if st.acc_grads is None else [a.clone() for a in st.acc_grads]
    counts = (st.updates, st.mini_step)

    st, m = step(st, _poison(good))
    assert float(m["skipped"]) == 1.0 and st.step == 4
    assert (st.updates, st.mini_step) == counts
    for k, v in st.model.state_dict().items():
        assert torch.equal(v, params[k]), k
    for p, s in st.optimizer.state.items():
        for k, v in moments[id(p)].items():
            assert torch.equal(s[k], v), k
    if acc is not None:
        assert all(torch.equal(a, b) for a, b in zip(st.acc_grads, acc))

    if accumulate == 1:
        js = T.create_train_state(jcfg, jax.random.key(0))
        _, jm = T.make_train_step(jcfg)(js, jax.tree.map(jnp.asarray, _poison(good)))
        assert float(jm["skipped"]) == 1.0


def test_batch_on_moves_numpy_and_tensors():
    jcfg = JC.tiny_test_config()
    b, = _batches(jcfg, 1)
    t = S.batch_on(b, "cpu")
    assert isinstance(t, GraphBatch) and torch.is_tensor(t.graph.senders)
    assert S.batch_on(t, "cpu").graph.senders is not None
    assert t.at(1).graph.node_feat.shape == b.graph.node_feat.shape[1:]
