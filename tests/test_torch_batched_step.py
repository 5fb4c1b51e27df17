"""The JAX package's training step as one program, in the port: the batch
as a leading graph axis (``batched_forward``, the batched message rounds,
layouts, norms and segment ops), the branchless NaN skip (``all_finite``,
``apply_if``) and the update as tensor ops with the schedule on the
device.  On the CPU, at tiny widths, against the per-graph plain functions
(bitwise) and against the JAX package's ``batched_forward``,
``make_loss_fn(use_fast_path=True)`` (Pallas in interpret mode),
``make_train_step`` and ``make_train_scan`` on the same weights
(``state_dict_from_flax``) and numpy-seeded batches."""

import dataclasses
import functools
import operator

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
from graph_neural_network_for_radar_perception_torch.ops import csr_mp as C
from graph_neural_network_for_radar_perception_torch.ops import fused_mp as FM
from graph_neural_network_for_radar_perception_torch.ops import norms as NO
from graph_neural_network_for_radar_perception_torch.ops import segment as SG
from graph_neural_network_for_radar_perception_torch.train import loss as TL
from graph_neural_network_for_radar_perception_torch.train import steps as S
from graph_neural_network_for_radar_perception_torch.utils.convert import (
    state_dict_from_flax,
)
from graph_neural_network_for_radar_perception_tpu.config import config as JC
from graph_neural_network_for_radar_perception_tpu.data.pipeline import (
    SyntheticRadarDataset,
    stack_batch,
)
from graph_neural_network_for_radar_perception_tpu.models.fast_path import (
    fast_forward,
)
from graph_neural_network_for_radar_perception_tpu.models.gnn import (
    RadarGNN as JaxRadarGNN,
)
from graph_neural_network_for_radar_perception_tpu.ops import norms as JN
from graph_neural_network_for_radar_perception_tpu.train import loss as JL
from graph_neural_network_for_radar_perception_tpu.train import steps as T
from torch_port_fixtures import one_torch_thread  # noqa: F401  (autouse)

TOL = dict(rtol=1e-5, atol=1e-6)
GRAPHS = 3


def _round(rng, n, e, d, de, h, d2, graphs=GRAPHS):
    """``graphs`` rounds sharing weights: x [B, n, d], ef [B, e, de], senders,
    receivers [B, e] (a tenth of the edges padding, sentinel n at both
    ends), w1, b1, w2, b2 and the four norm scalars."""
    s = rng.integers(0, n, size=(graphs, e)).astype(np.int32)
    r = rng.integers(0, n, size=(graphs, e)).astype(np.int32)
    pad = rng.random((graphs, e)) < 0.1
    s[pad], r[pad] = n, n
    arrays = [rng.normal(size=(graphs, n, d)), rng.normal(size=(graphs, e, de)), s, r,
              rng.normal(size=(2 * d + de, h)) * 0.2, rng.normal(size=h) * 0.1,
              rng.normal(size=(h, d2)) * 0.2, rng.normal(size=d2) * 0.1]
    out = [torch.from_numpy(np.asarray(a, np.int32 if a.dtype == np.int32 else np.float32))
           for a in arrays]
    return out + [torch.tensor([v]) for v in (1.1, 0.05, 0.9, -0.02)]


def _graph_sum(parts):
    return functools.reduce(operator.add, parts)


def _assert_stacked_then_summed(batched, per_graph, stacked):
    """The first ``stacked`` outputs equal the graphs' stacked, bit for
    bit; the rest equal their sum in graph order, bit for bit."""
    for i, t in enumerate(batched):
        cols = [p[i] for p in per_graph]
        want = torch.stack(cols) if i < stacked else _graph_sum(cols)
        assert torch.equal(t, want), i


# --------------------------------------------------- batched plain rounds
@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
def test_batched_fused_plain_round_is_each_graphs(rng, bf16):
    """The fused round's plain forward and backward over a batch equal the
    per-graph plain functions bit for bit (weight gradients: their sum in
    graph order), and so does the differentiable round on CPU tensors; the
    batch's fused layout is each graph's."""
    args = _round(rng, 40, 300, 16, 16, 32, 16)
    x, ef, s, r, w1, b1, w2, b2, *sc = args
    got = FM.fused_message_pass_reference(*args, 0.01, bf16)
    assert torch.equal(got, torch.stack([
        FM.fused_message_pass_reference(x[g], ef[g], s[g], r[g], w1, b1, w2, b2, *sc,
                                        0.01, bf16) for g in range(GRAPHS)]))
    assert torch.equal(FM.fused_message_pass(*args, 0.01, bf16), got)
    gout = torch.from_numpy(rng.normal(size=got.shape).astype(np.float32))
    batched = FM.fused_message_pass_backward_reference(*args, gout)
    per = [FM.fused_message_pass_backward_reference(x[g], ef[g], s[g], r[g], w1, b1, w2, b2,
                                                    *sc, gout[g]) for g in range(GRAPHS)]
    _assert_stacked_then_summed(batched, per, 3)
    assert all(torch.equal(a, b) for a, b in zip(
        FM.fused_message_pass_backward(*args, gout), batched))
    layout = FM.fused_layout(s, r, 40)
    for g in range(GRAPHS):
        assert all(torch.equal(a[g], b) for a, b in zip(layout, FM.fused_layout(s[g], r[g], 40)))


@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
def test_batched_csr_plain_round_is_each_graphs(rng, bf16):
    """The CSR round's plain forward and backward over a batch (sorted
    destinations, one tile's window violated in graph 1) equal the
    per-graph plain functions bit for bit, and so do the batch's effective
    indices, segment offsets and window, source-window and order
    violation counts."""
    n, e, tile, window, src_window = 48, 256, 64, 24, 32
    args = _round(rng, n, e, 16, 16, 32, 16)
    dst = torch.sort(torch.from_numpy(rng.integers(0, n, size=(GRAPHS, e)).astype(np.int32)),
                     dim=-1).values
    dst[1, :5] = torch.tensor([0, 30, 31, 32, 33], dtype=torch.int32)  # a span over the window
    args[3] = dst
    x, ef, src, _, w1, b1, w2, b2, *sc = args
    tiling = (tile, window, src_window)
    got = C.fused_message_pass_csr_reference(*args, 0.01, *tiling, bf16)
    assert torch.equal(got, torch.stack([C.fused_message_pass_csr_reference(
        x[g], ef[g], src[g], dst[g], w1, b1, w2, b2, *sc, 0.01, *tiling, bf16)
        for g in range(GRAPHS)]))
    assert torch.equal(C.fused_message_pass_csr(*args, 0.01, tile, window, bf16, src_window), got)
    gout = torch.from_numpy(rng.normal(size=got.shape).astype(np.float32))
    batched = C.fused_message_pass_csr_backward_reference(*args, gout, 0.01, *tiling)
    per = [C.fused_message_pass_csr_backward_reference(
        x[g], ef[g], src[g], dst[g], w1, b1, w2, b2, *sc, gout[g], 0.01, *tiling)
        for g in range(GRAPHS)]
    _assert_stacked_then_summed(batched, per, 2)
    eff = C._effective_indices(src, dst, n, *tiling)
    counts = (C.window_span_violations(dst, n, tile, window),
              C.src_window_violations(src, n, tile, src_window), C.order_violations(dst, n))
    assert int(counts[0][1]) > 0
    for g in range(GRAPHS):
        one = C._effective_indices(src[g], dst[g], n, *tiling)
        assert all(torch.equal(a[g], b) for a, b in zip(eff, one))
        assert torch.equal(C._segment_offsets(eff[1], n)[g], C._segment_offsets(one[1], n))
        assert [int(c[g]) for c in counts] == [
            int(C.window_span_violations(dst[g], n, tile, window)),
            int(C.src_window_violations(src[g], n, tile, src_window)),
            int(C.order_violations(dst[g], n))]


def test_batched_segment_ops_and_norms_are_each_graphs(rng):
    """Segment sums, maxima, means, softmax and gathers with a leading
    graph axis, and layer/group norm statistics per graph, equal the
    single-graph functions bit for bit."""
    n, e = 12, 40
    data = torch.from_numpy(rng.normal(size=(GRAPHS, e, 5)).astype(np.float32))
    ids = torch.from_numpy(rng.integers(-1, n + 1, size=(GRAPHS, e)))
    mask = torch.from_numpy(rng.random((GRAPHS, e)) > 0.3)
    for fn in (SG.masked_segment_sum, SG.masked_segment_max, SG.masked_segment_mean):
        assert torch.equal(fn(data, ids, n, mask),
                           torch.stack([fn(data[g], ids[g], n, mask[g]) for g in range(GRAPHS)]))
    inside = ids.clamp(0, n - 1)
    assert torch.equal(SG.segment_softmax(data, inside, n, mask), torch.stack(
        [SG.segment_softmax(data[g], inside[g], n, mask[g]) for g in range(GRAPHS)]))
    nodes = torch.from_numpy(rng.normal(size=(GRAPHS, n, 5)).astype(np.float32))
    assert torch.equal(SG.gather_nodes(nodes, inside), torch.stack(
        [SG.gather_nodes(nodes[g], inside[g]) for g in range(GRAPHS)]))
    x = torch.from_numpy((3 * rng.normal(size=(GRAPHS, n, 8)) + 1).astype(np.float32))
    rows = torch.from_numpy(rng.random((GRAPHS, n)) > 0.25)
    ga, be = torch.tensor([1.2]), torch.tensor([0.1])
    for m in (None, rows):
        def each(fn, *extra):
            return torch.stack([fn(x[g], ga, be, *extra, None if m is None else m[g])
                                for g in range(GRAPHS)])
        np.testing.assert_array_equal(NO.layer_norm(x, ga, be, m), each(NO.layer_norm))
        np.testing.assert_array_equal(NO.group_norm(x, ga, be, 4, m), each(NO.group_norm, 4))


@pytest.mark.parametrize("norm", ["layer_normalization", "group_normalization"])
def test_batched_norms_match_jax_vmap(rng, norm):
    """layer_norm / group_norm over a batch against the JAX functions
    vmapped over the graphs."""
    x = (3 * rng.normal(size=(GRAPHS, 20, 8)) + 1).astype(np.float32)
    rows = rng.random((GRAPHS, 20)) > 0.25
    if norm == "layer_normalization":
        got = NO.layer_norm(torch.from_numpy(x), 1.2, 0.1, torch.from_numpy(rows))
        want = jax.vmap(lambda a, m: JN.layer_norm(a, 1.2, 0.1, m))(x, rows)
    else:
        got = NO.group_norm(torch.from_numpy(x), 1.2, 0.1, 4, torch.from_numpy(rows))
        want = jax.vmap(lambda a, m: JN.group_norm(a, 1.2, 0.1, 4, m))(x, rows)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


# ------------------------------------------------- the model over a batch
def _model_setup(overrides, seed=3):
    jcfg, cfg = JC.tiny_test_config(**overrides), tiny_test_config(**overrides)
    js = T.create_train_state(jcfg, jax.random.key(seed))
    st = S.create_train_state(cfg, device="cpu")
    st.model.load_state_dict(state_dict_from_flax(jax.tree.map(np.asarray, js.params)))
    batch = next(SyntheticRadarDataset(jcfg, seed=5, num_objects=3).batches(GRAPHS))
    return jcfg, cfg, js, st, batch


def _valid_rows(out, batch):
    g, lbl = batch.graph, batch.labels
    return {"node_cls": g.node_mask, "node_offsets": g.node_mask, "node_embed": g.node_mask,
            "edge_cls": g.und_mask, "obj_cls": lbl.cluster_mask}


MODEL_CASES = {
    "fused": ({}, None),
    "csr": ({"csr_edge_tile": 128, "csr_window": 64}, "csr"),
    "layer_norm": ({"norm_layer": "layer_normalization"}, None),
    "group_norm": ({"norm_layer": "group_normalization", "num_groups": 2}, None),
}


@pytest.mark.parametrize("case", list(MODEL_CASES))
def test_batched_forward_matches_jax_vmap(case):
    """``batched_forward``: one model call for the batch against the JAX
    package's ``batched_forward`` (the flax model vmapped over the graphs),
    every output on its valid rows."""
    overrides, mp_impl = MODEL_CASES[case]
    jcfg, cfg, js, st, batch = _model_setup(overrides)
    jb = jax.tree.map(jnp.asarray, batch)
    want = T.batched_forward(JaxRadarGNN(jcfg), jcfg)(
        js.params, jb.graph, jb.labels.node2cluster, jb.labels.cluster_mask)
    tb = S.batch_on(batch, "cpu")
    with torch.no_grad():
        got = S.batched_forward(st.model, cfg, mp_impl)(
            tb.graph, tb.labels.node2cluster, tb.labels.cluster_mask)
    for name, rows in _valid_rows(got, batch).items():
        np.testing.assert_allclose(getattr(got, name).numpy()[rows],
                                   np.asarray(getattr(want, name))[rows], **TOL, err_msg=name)


def _jax_fast_loss_fn(jcfg, mp_impl):
    """The JAX package's ``make_loss_fn(use_fast_path=True)`` with the
    Pallas kernels in interpret mode (that signature has no interpret)."""

    def single(params, graph, node2cluster, cluster_mask):
        return fast_forward(params, graph, node2cluster, jcfg.max_clusters, cluster_mask,
                            jcfg, interpret=True, mp_impl=mp_impl, pallas_backward=True)

    def loss_fn(params, batch):
        outs = jax.vmap(single, in_axes=(None, 0, 0, 0))(
            params, batch.graph, batch.labels.node2cluster, batch.labels.cluster_mask)
        sums = jax.vmap(lambda o, g, l: JL.graph_loss_sums(o, g, l, jcfg))(
            outs, batch.graph, batch.labels)
        return JL.reduce_loss_sums(JL.tree_sum(sums), jcfg)

    return loss_fn


@pytest.mark.parametrize("case", ["fused", "csr"])
def test_loss_fn_matches_jax_fast_path(case):
    """``make_loss_fn``: one model call for the batch, LossSums with a graph
    axis added in graph order, against the JAX fast path's loss (Pallas
    kernels in interpret mode) on the same weights and batch: every metric,
    and the per-graph loop's (``per_graph_loss_sums``) bit for bit."""
    overrides, mp_impl = MODEL_CASES[case]
    jcfg, cfg, js, st, batch = _model_setup(overrides)
    _, jm = _jax_fast_loss_fn(jcfg, mp_impl or "onehot")(js.params, jax.tree.map(jnp.asarray, batch))
    tb = S.batch_on(batch, "cpu")
    with torch.no_grad():
        _, pm = S.make_loss_fn(cfg, mp_impl)(st.model, tb)
        _, loop = TL.reduce_loss_sums(TL.tree_sum(S.per_graph_loss_sums(
            st.model, tb, cfg, mp_impl=mp_impl)), cfg)
    assert set(pm) == set(jm)
    for k in jm:
        np.testing.assert_allclose(float(pm[k]), float(jm[k]), **TOL, err_msg=k)
        assert float(pm[k]) == float(loop[k]), k


# ------------------------------------------------- the step against JAX's
def _steps_states(optim, accumulate):
    return _model_setup({"optim": optim, "grad_accumulation_steps": accumulate,
                         "max_train_iter": 4})


def _batches(jcfg, k, seed=5):
    gen = SyntheticRadarDataset(jcfg, seed=seed, num_objects=3).batches(jcfg.batch_size)
    return [next(gen) for _ in range(k)]


def _jax_steps(jcfg, js, batches):
    """JAX's steps over ``batches``: the states after each, their metrics,
    and the gradients of each step at the params before it."""
    jstep, states, metrics, grads = T.make_train_step(jcfg), [], [], []
    loss = T.make_loss_fn(jcfg)
    for b in batches:
        jb = jax.tree.map(jnp.asarray, b)
        grads.append(state_dict_from_flax(jax.tree.map(
            np.asarray, jax.grad(lambda p: loss(p, jb)[0])(js.params))))
        js, jm = jstep(js, jb)
        states.append(js)
        metrics.append(jm)
    return states, metrics, grads


def _set_by_gradients(optim, grads):
    """Per parameter, the elements held at TOL after AdamW steps: those
    whose gradient reached 1e-6 in magnitude in every step so far (every
    element for SGD); at most 1 % of all elements may lie outside TOL.  Adam divides by sqrt(v) + 1e-8, so where the
    gradients are tinier an f32 rounding of the gradient (another summation
    order) moves the update by a share of the learning rate, not of the
    parameter (tests/test_torch_train.py::test_adamw_steps_match_jax); those
    elements are held within 0.2 learning rates instead."""
    if optim == "sgd":
        return None
    return {k: functools.reduce(operator.and_, [np.abs(g[k].numpy()) >= 1e-6 for g in grads])
            for k in grads[0]}


def _assert_state_matches(st, js, jm, pm, keep, lr):
    assert set(pm) == set(jm)
    for k in jm:
        np.testing.assert_allclose(float(pm[k]), float(jm[k]), **TOL, err_msg=k)
    want = state_dict_from_flax(jax.tree.map(np.asarray, js.params))
    off = total = 0
    for k, v in st.model.state_dict().items():
        got, w = v.numpy(), want[k].numpy()
        m = np.ones(got.shape, bool) if keep is None else keep[k]
        np.testing.assert_allclose(got[m], w[m], **TOL, err_msg=k)
        np.testing.assert_allclose(got[~m], w[~m], rtol=0, atol=0.2 * lr, err_msg=k)
        off += int((~np.isclose(got, w, **TOL)).sum())
        total += got.size
    assert off <= 0.01 * total  # elements outside TOL: at most 1 %


@pytest.mark.parametrize("optim", ["sgd", "adamw"])
@pytest.mark.parametrize("accumulate", [1, 2])
def test_train_steps_match_jax(optim, accumulate):
    """Three ``make_train_step`` steps against JAX's ``make_train_step`` on
    the same weights and batches (the LR's first milestone passed at
    update 2 of 4): every step's metrics and the params after each
    (``_set_by_gradients``); the counts as optax's (updates, accumulation's
    micro-step)."""
    jcfg, cfg, js, st, _ = _steps_states(optim, accumulate)
    batches = _batches(jcfg, 3)
    states, metrics, grads = _jax_steps(jcfg, js, batches)
    pstep = S.make_train_step(cfg)
    for i, b in enumerate(batches):
        st, pm = pstep(st, b)
        _assert_state_matches(st, states[i], metrics[i], pm,
                              _set_by_gradients(optim, grads[:i + 1]), cfg.learning_rate)
        assert st.step == i + 1 and st.updates == (i + 1) // accumulate
        assert st.mini_step == (i + 1) % accumulate


@pytest.mark.parametrize("optim", ["sgd", "adamw"])
@pytest.mark.parametrize("accumulate", [1, 2])
def test_train_scan_on_stacked_batches_matches_jax(optim, accumulate):
    """``make_train_scan`` over three stacked batches against JAX's
    ``lax.scan`` of the same steps: the last step's metrics and the
    params (``_set_by_gradients``)."""
    jcfg, cfg, js, st, _ = _steps_states(optim, accumulate)
    jb = _batches(jcfg, 3)
    grads = _jax_steps(jcfg, js, jb)[2]
    js, jm = T.make_train_scan(jcfg, 3)(js, jax.tree.map(
        jnp.asarray, stack_batch([(b.graph, b.labels) for b in jb])))
    port = [GraphBatch.from_numpy(b, "cpu") for b in jb]
    st, pm = S.make_train_scan(cfg, 3)(st, PS.stack_batch([(b.graph, b.labels) for b in port]))
    _assert_state_matches(st, js, jm, pm, _set_by_gradients(optim, grads), cfg.learning_rate)
    assert st.step == 3


def _poisoned(batch):
    node_feat = batch.graph.node_feat.copy()
    node_feat[1, 0, 0] = np.nan
    return dataclasses.replace(batch, graph=dataclasses.replace(batch.graph, node_feat=node_feat))


@pytest.mark.parametrize("optim", ["sgd", "adamw"])
@pytest.mark.parametrize("accumulate", [1, 2])
def test_nan_batch_keeps_the_state_bitwise(optim, accumulate):
    """A batch with one NaN input in one graph poisons the batch's loss:
    ``apply_if`` keeps the parameters, every moment, the accumulation
    buffer and the counts bit for bit (the step count advances), as the
    JAX step keeps its params and opt_state."""
    jcfg, cfg, js, st, _ = _steps_states(optim, accumulate)
    good, = _batches(jcfg, 1)
    jstep, step = T.make_train_step(jcfg), S.make_train_step(cfg)
    js, _ = jstep(js, jax.tree.map(jnp.asarray, good))
    st, _ = step(st, good)
    kept = [t.clone() for t in st.tensors()]
    jkept = jax.tree.map(np.asarray, (js.params, js.opt_state))
    st, m = step(st, _poisoned(good))
    js, jm = jstep(js, jax.tree.map(jnp.asarray, _poisoned(good)))
    assert float(m["skipped"]) == float(jm["skipped"]) == 1.0
    for a, b in zip(st.tensors(), kept):
        if a is st.counters:
            assert a.tolist() == [b[0] + 1, *b[1:].tolist()]
        else:
            assert torch.equal(a, b)
    for a, b in zip(jax.tree.leaves((js.params, js.opt_state)), jax.tree.leaves(jkept)):
        np.testing.assert_array_equal(np.asarray(a), b)


def test_all_finite_and_apply_if_match_jax(rng):
    """``all_finite`` and ``apply_if`` against the JAX package's on the same
    arrays, finite and not."""
    a = rng.normal(size=(4, 3)).astype(np.float32)
    b = rng.normal(size=5).astype(np.float32)
    for bad in (None, np.nan, np.inf):
        x = a.copy()
        if bad is not None:
            x[2, 1] = bad
        ok = S.all_finite([torch.from_numpy(x), torch.from_numpy(b)])
        assert ok.ndim == 0 and bool(ok) == bool(T.all_finite([jnp.asarray(x), jnp.asarray(b)]))
        new, old = [torch.from_numpy(x), torch.from_numpy(b)], [torch.zeros(4, 3), torch.ones(5)]
        got = S.apply_if(ok, new, old)
        want = T.apply_if(jnp.asarray(bool(ok)), [jnp.asarray(x), jnp.asarray(b)],
                          [jnp.zeros((4, 3)), jnp.ones(5)])
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_device_schedule_passes_the_milestones_as_optax():
    """The learning rate from a 0-d count tensor (the step's device count of
    applied updates) equals optax's piecewise-constant schedule in float32,
    bit for bit, at and around both milestones; the host schedule too."""
    jcfg, cfg = JC.tiny_test_config(max_train_iter=10), tiny_test_config(max_train_iter=10)
    want, got = T.lr_schedule(jcfg), S.lr_schedule(cfg)
    m1, m2 = cfg.lr_milestones
    for count in (0, m1 - 1, m1, m1 + 1, m2 - 1, m2, m2 + 1, 10**6):
        lr = got(torch.tensor(count, dtype=torch.int64))
        assert lr.dtype == torch.float32 and lr.ndim == 0
        assert lr.item() == np.float32(want(count)) == got(count), count
    lrs = [got(torch.tensor(c)).item() for c in range(m2 + 2)]
    assert len(set(lrs)) == 3 and lrs[m1 - 1] > lrs[m1] > lrs[m2]


def test_optimizer_state_keeps_torch_optim_form():
    """The optimiser's ``state_dict`` has torch.optim's form (per-parameter
    moments by index, the groups' hyper-parameters), loads into another
    optimiser in place (the parameters' flat buffer and moments keep their
    storage), and ``step()`` applies each parameter's ``.grad``."""
    cfg = tiny_test_config(optim="adamw")
    a, b = S.create_train_state(cfg, device="cpu"), S.create_train_state(cfg, device="cpu")
    for p in a.model.parameters():
        p.grad = torch.ones_like(p)
    a.optimizer.step()
    sd = a.optimizer.state_dict()
    assert set(sd["state"][0]) == {"exp_avg", "exp_avg_sq"}
    assert sd["param_groups"][0]["params"] == list(range(len(a.optimizer.params)))
    ptrs = [t.data_ptr() for t in b.tensors()]
    b.optimizer.load_state_dict(sd)
    assert ptrs == [t.data_ptr() for t in b.tensors()]
    for k, v in b.optimizer.moments.items():
        assert torch.equal(v, a.optimizer.moments[k])
    assert all(p.data_ptr() == b.optimizer.flat.data_ptr() + 4 * o
               for p, o in zip(b.optimizer.params, b.optimizer.offsets))


def test_batch_leaves_and_labels_cover_every_field():
    """The captured step's static inputs: every field of a batch's graph and
    labels, in a fixed order."""
    jcfg = JC.tiny_test_config()
    b, = _batches(jcfg, 1)
    leaves = GraphBatch.leaves(b)
    assert len(leaves) == len(dataclasses.fields(RadarGraph)) + len(dataclasses.fields(GraphLabels))
    assert all(isinstance(a, np.ndarray) and a.shape[0] == jcfg.batch_size for a in leaves)
    assert all(a is c for a, c in zip(GraphBatch.from_leaves(leaves).leaves(), leaves))
