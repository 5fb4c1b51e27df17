"""The port's CSR round (``ops/csr_mp.py``) and the CSR path of the model
and the train step, against the JAX package on the same numpy-seeded
inputs and weights.  The JAX side runs its Pallas kernels in interpret mode
(as tests/test_pallas.py does); the port runs its plain versions on the CPU.
The graphs are those of tests/test_pallas.py: a symmetric kNN-like graph,
a banded graph (source-windowed) and a ring that violates the window."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from graph_neural_network_for_radar_perception_torch.config.config import (
    tiny_test_config,
)
from graph_neural_network_for_radar_perception_torch.core.graph import RadarGraph
from graph_neural_network_for_radar_perception_torch.data import pipeline as TP
from graph_neural_network_for_radar_perception_torch.models.gnn import RadarGNN
from graph_neural_network_for_radar_perception_torch.ops import csr_mp as C
from graph_neural_network_for_radar_perception_torch.train import steps as S
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
from graph_neural_network_for_radar_perception_tpu.ops.pallas import csr_mp as JC_MP
from graph_neural_network_for_radar_perception_tpu.train import steps as T
from torch_port_fixtures import one_torch_thread  # noqa: F401  (autouse)

FWD_TOL = dict(rtol=2e-4, atol=2e-5)
GRAD_TOL = dict(rtol=5e-4, atol=5e-5)
STEP_TOL = dict(rtol=1e-4, atol=1e-6)  # as tests/test_torch_train.py
SCALARS = (1.1, 0.05, 0.9, -0.02)


def _edges_symmetric(rng, n, k):
    adj = np.zeros((n, n), bool)
    for i in range(n):
        adj[i, rng.choice([j for j in range(n) if j != i], size=k,
                          replace=False)] = True
    return np.nonzero(adj | adj.T)


def _edges_banded(n, k):
    i, j = np.meshgrid(np.arange(n), np.arange(n), indexing="ij")
    return np.nonzero((np.abs(i - j) <= k) & (i != j))


def _edges_ring(n):
    s = np.repeat(np.arange(n), 2)
    r = np.stack([(np.arange(n) - 1) % n, (np.arange(n) + 1) % n], 1).ravel()
    return s, r


# graph name → (edges(rng), n, edge_tile, window, src_window)
GRAPHS = {
    "symmetric": (lambda rng: _edges_symmetric(rng, 96, 6), 96, 128, 64, 0),
    "banded_src_window": (lambda rng: _edges_banded(96, 6), 96, 128, 64, 64),
    # a 32-edge tile of the ring spans 16 nodes: half its edges fall
    # outside an 8-node window
    "window_violating": (lambda rng: _edges_ring(64), 64, 32, 8, 0),
}


def _problem(name, rng, d=32, de=16, h=64, d2=32, pad=37):
    """(numpy args of one round, edge_tile, window, src_window): dst = the
    sorted senders, src = receivers, a padded tail with sentinel n."""
    edges, n, edge_tile, window, src_window = GRAPHS[name]
    s, r = edges(rng)
    e = s.shape[0]
    src = np.concatenate([r, np.full(pad, n)]).astype(np.int32)
    dst = np.concatenate([s, np.full(pad, n)]).astype(np.int32)
    args = [
        rng.normal(size=(n, d)).astype(np.float32),
        np.concatenate([rng.normal(size=(e, de)), np.zeros((pad, de))]).astype(np.float32),
        src, dst,
        (rng.normal(size=(2 * d + de, h)) * 0.1).astype(np.float32),
        (rng.normal(size=(h,)) * 0.1).astype(np.float32),
        (rng.normal(size=(h, d2)) * 0.1).astype(np.float32),
        (rng.normal(size=(d2,)) * 0.1).astype(np.float32),
    ] + [np.float32(v) for v in SCALARS]
    return args, edge_tile, window, src_window


def _jax_csr(args, edge_tile, window, src_window):
    return JC_MP.fused_message_pass_csr(
        *[jnp.asarray(a) for a in args], 0.01, edge_tile, window, True, False,
        True, src_window)


def _torch(args):
    return [torch.from_numpy(np.asarray(a)) if np.ndim(a) else
            torch.tensor([float(a)]) for a in args]


# ------------------------------------------------------------------ forward
@pytest.mark.parametrize("graph", list(GRAPHS))
def test_forward_plain_matches_pallas_interpret(rng, graph):
    args, edge_tile, window, src_window = _problem(graph, rng)
    want = np.asarray(_jax_csr(args, edge_tile, window, src_window))
    got = C.fused_message_pass_csr_reference(
        *_torch(args), 0.01, edge_tile, window, src_window)
    np.testing.assert_allclose(got.numpy(), want, **FWD_TOL)
    with torch.no_grad():
        got = C.fused_message_pass_csr(*_torch(args), 0.01, edge_tile, window,
                                       False, src_window)
    np.testing.assert_allclose(got.numpy(), want, **FWD_TOL)
    if graph == "window_violating":
        # The TPU kernel drops the out-of-window edges: the plain round over
        # all edges differs, so the drop is really exercised.
        src_e, dst_e = C._effective_indices(*_torch(args)[2:4], 64, 32, 8, 0)
        assert int((dst_e < 64).sum()) == 64
        full = C.fused_message_pass_csr_reference(*_torch(args), 0.01, 32, 64)
        assert not np.allclose(full.numpy(), want, **FWD_TOL)


@pytest.mark.parametrize("widths", [
    dict(d=16, de=64, h=256, d2=64), dict(d=16, de=64, h=128, d2=128),
])
def test_wide_forward_matches_pallas_interpret(rng, widths):
    """The plain round at the widest H and D2 the card's kernels take
    against the interpret-mode kernel."""
    args, edge_tile, window, src_window = _problem("symmetric", rng, **widths)
    want = np.asarray(_jax_csr(args, edge_tile, window, src_window))
    got = C.fused_message_pass_csr_reference(
        *_torch(args), 0.01, edge_tile, window, src_window)
    np.testing.assert_allclose(got.numpy(), want, **FWD_TOL)


# ---------------------------------------------------------------- gradients
def _gradients_match_pallas_interpret(rng, graph, **widths):
    args, edge_tile, window, src_window = _problem(graph, rng, **widths)
    src, dst = jnp.asarray(args[2]), jnp.asarray(args[3])

    def loss(x, ef, w1, b1, w2, b2, g1, be1, g2, be2):
        out = JC_MP.fused_message_pass_csr(
            x, ef, src, dst, w1, b1, w2, b2, g1, be1, g2, be2, 0.01,
            edge_tile, window, True, False, True, src_window)
        return jnp.sum(out * out)

    diff = [args[0], args[1]] + args[4:]
    want = jax.grad(loss, argnums=tuple(range(10)))(*map(jnp.asarray, diff))
    leaves = [t.requires_grad_() for t in _torch(diff)]
    x, ef, w1, b1, w2, b2, *sc = leaves
    out = C.fused_message_pass_csr(x, ef, *_torch(args[2:4]), w1, b1, w2, b2,
                                   *sc, 0.01, edge_tile, window, False,
                                   src_window)
    got = torch.autograd.grad((out * out).sum(), leaves)
    for i, (a, b) in enumerate(zip(got, want)):
        np.testing.assert_allclose(a.numpy().reshape(np.shape(b)), np.asarray(b),
                                   **GRAD_TOL, err_msg=f"grad {i}")


@pytest.mark.parametrize("graph", list(GRAPHS))
def test_gradients_match_pallas_interpret(rng, graph):
    """Gradients of sum(out²) through ``_FusedMessagePassCSR`` (the plain
    backward on the CPU) against ``jax.grad`` through the interpret-mode
    kernel with its Pallas backward."""
    _gradients_match_pallas_interpret(rng, graph)


def test_wide_gradients_match_pallas_interpret(rng):
    """The same at H=256, where the card's backward runs in 16-edge tiles
    (tests/test_torch_cuda.py holds the kernel to this plain version)."""
    _gradients_match_pallas_interpret(rng, "symmetric", d=16, de=64, h=256, d2=64)


def test_backward_reference_is_the_chain_rule(rng):
    """The explicit backward against autograd of the plain forward, in
    float64, on the window-violating graph.  The norm backward's leaky-ReLU
    slope factor is a float32 constant (ops/fused_mp._cnorm_act_bwd), so
    the two agree to its rounding (~1e-8 relative), not to float64's."""
    args, edge_tile, window, src_window = _problem("window_violating", rng)
    t = [a.double() if a.is_floating_point() else a for a in _torch(args)]
    g = torch.from_numpy(rng.normal(size=(64, 32)))
    got = C.fused_message_pass_csr_backward_reference(
        *t, g, 0.01, edge_tile, window, src_window)
    leaves = [a.clone().requires_grad_() for a in (t[0], t[1], *t[4:])]
    x, ef, w1, b1, w2, b2, *sc = leaves
    out = C.fused_message_pass_csr_reference(
        x, ef, t[2], t[3], w1, b1, w2, b2, *sc, 0.01, edge_tile, window,
        src_window)
    want = torch.autograd.grad(out, leaves, g)
    order = [want[0], want[1]] + list(want[2:])
    for i, (a, b) in enumerate(zip(got, order)):
        np.testing.assert_allclose(a.numpy().reshape(b.shape), b.numpy(),
                                   rtol=1e-6, atol=1e-8, err_msg=f"output {i}")


# --------------------------------------------------- host and device checks
@pytest.mark.parametrize("graph", list(GRAPHS))
def test_checks_and_layouts_match_jax(rng, graph):
    """csr_contract_ok, the device counts and _layout/_src_layout element
    for element, at the graph's own tiling and at tighter windows."""
    args, edge_tile, window, src_window = _problem(graph, rng)
    src, dst = args[2], args[3]
    n = args[0].shape[0]
    mask = dst < n
    for win, swin in ((window, src_window), (window, 32), (16, 0), (24, 16)):
        want = JC_MP.csr_contract_ok(np.where(mask, dst, n), np.where(mask, src, n),
                                     mask, edge_tile, win, swin)
        assert C.csr_contract_ok(np.where(mask, dst, n), np.where(mask, src, n),
                                 mask, edge_tile, win, swin) == want
        assert int(C.window_span_violations(torch.from_numpy(dst), n, edge_tile, win)) \
            == int(JC_MP.window_span_violations(jnp.asarray(dst), n, edge_tile, win))
        assert int(C.src_window_violations(torch.from_numpy(src), n, edge_tile, swin)) \
            == int(JC_MP.src_window_violations(jnp.asarray(src), n, edge_tile, swin))
    assert C.window_span_ok(dst, mask, edge_tile, window) == JC_MP.window_span_ok(
        dst, mask, edge_tile, window)

    pad = lambda a: np.concatenate([a, np.full((-a.shape[0]) % edge_tile, n)]).astype(np.int32)
    dp, sp = pad(dst), pad(np.where(src < n, src, n))
    for got, want in (
        (C._layout(torch.from_numpy(dp), n, edge_tile, min(window, n)),
         JC_MP._layout(jnp.asarray(dp), n, edge_tile, min(window, n))),
        (C._src_layout(torch.from_numpy(sp), n, edge_tile, 40),
         JC_MP._src_layout(jnp.asarray(sp), n, edge_tile, 40)),
    ):
        for a, b in zip(got, want):
            assert a.dtype == torch.int32
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_order_violations_count_unsorted_destinations():
    dst = torch.tensor([0, 0, 2, 1, 3, 9, 3, 9], dtype=torch.int32)
    assert int(C.order_violations(dst, 9)) == 1  # the 2 before a 1
    assert int(C.order_violations(torch.sort(dst).values, 9)) == 0
    cfg = tiny_test_config(mp_impl="csr", csr_edge_tile=128, csr_window=64)
    model = RadarGNN(cfg).eval()
    graph, n2c, c, cm = _csr_inputs()
    shuffled = dataclasses.replace(graph, senders=graph.senders.flip(0),
                                   receivers=graph.receivers.flip(0),
                                   edge_feat=graph.edge_feat.flip(0),
                                   edge_mask=graph.edge_mask.flip(0))
    with torch.no_grad():
        assert torch.isfinite(model(graph, n2c, c, cm).node_cls).all()
        assert not torch.isfinite(model(shuffled, n2c, c, cm).node_cls).all()


def test_reverse_edge_features_matches_jax(rng):
    ef = rng.normal(size=(5, 11, 7)).astype(np.float32)
    got = C.reverse_edge_features(torch.from_numpy(ef))
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(JC_MP.reverse_edge_features(jnp.asarray(ef))))
    with pytest.raises(ValueError):
        C.reverse_edge_features(torch.zeros(3, 6))


def test_segment_offsets_skip_interleaved_sentinels():
    """Segments come from the suffix minimum: a sentinel inside a run joins
    the next kept destination's segment (and the kernel skips it); the
    sentinel tail forms the virtual segment N."""
    dst = torch.tensor([0, 0, 5, 2, 2, 5, 3, 5, 5], dtype=torch.int32)
    off = C._segment_offsets(dst, 5)
    np.testing.assert_array_equal(off.numpy(), [0, 2, 2, 5, 7, 7])


# ------------------------------------------------------------------- model
def _model_setup(overrides, seed=3):
    jcfg, cfg = JC.tiny_test_config(**overrides), tiny_test_config(**overrides)
    params = T.init_params(jcfg, jax.random.key(seed))
    model = RadarGNN(cfg)
    model.load_state_dict(state_dict_from_flax(jax.tree.map(np.asarray, params)))
    graph, labels = pad_frame(
        SyntheticRadarDataset(jcfg, seed=2, num_objects=2).sample_frame(), jcfg)
    return jcfg, cfg, params, model.eval(), graph, labels


def _fast_forward(jcfg, params, graph, labels, **kw):
    return fast_forward(params, jax.tree.map(jnp.asarray, graph),
                        jnp.asarray(labels.node2cluster), jcfg.max_clusters,
                        jnp.asarray(labels.cluster_mask), jcfg,
                        interpret=True, mp_impl="csr", **kw)


def _port_forward(model, cfg, graph, labels, **kw):
    with torch.no_grad():
        return model(RadarGraph.from_numpy(graph),
                     torch.from_numpy(labels.node2cluster), cfg.max_clusters,
                     torch.from_numpy(labels.cluster_mask), **kw)


MODEL_CASES = {
    "shipped_tiling": dict(mp_impl="csr", csr_edge_tile=128, csr_window=64),
    # 96 < max_nodes: the source gather is really windowed (tests/test_pallas.py
    # test_fast_path_csr_src_windowed_spatial_sort).
    "src_window_spatial_sort": dict(
        mp_impl="csr", spatial_sort=True, csr_edge_tile=128, csr_window=64,
        max_nodes=128, max_clusters=64, csr_src_window=96),
}


@pytest.mark.parametrize("case", list(MODEL_CASES))
def test_model_matches_fast_path_interpret(case):
    """RadarGNN on the CSR path against fast_forward(mp_impl="csr",
    interpret=True) with the same weights, every output on valid rows."""
    jcfg, cfg, params, model, g, lbl = _model_setup(MODEL_CASES[case])
    want = _fast_forward(jcfg, params, g, lbl)
    got = _port_forward(model, cfg, g, lbl)
    rows = {"node_cls": g.node_mask, "node_offsets": g.node_mask,
            "node_embed": g.node_mask, "edge_cls": g.und_mask,
            "obj_cls": lbl.cluster_mask}
    for name, m in rows.items():
        np.testing.assert_allclose(getattr(got, name).numpy()[m],
                                   np.asarray(getattr(want, name))[m],
                                   **FWD_TOL, err_msg=name)


def test_model_poisons_on_span_violation():
    """A graph violating the window gives NaN outputs in the port, as in the
    JAX fast path (test_pallas.py test_fast_path_csr_poisons_on_span_violation);
    the same weights on the default path stay finite."""
    jcfg, cfg, params, model, g, lbl = _model_setup({}, seed=3)
    want = _fast_forward(jcfg, params, g, lbl, edge_tile=16, window=8)
    assert not np.isfinite(np.asarray(want.node_cls)).all()
    bad = RadarGNN(tiny_test_config(csr_edge_tile=16, csr_window=8)).eval()
    bad.load_state_dict(model.state_dict())
    out = _port_forward(bad, cfg, g, lbl, mp_impl="csr")
    assert not torch.isfinite(out.node_cls).all()
    assert torch.isfinite(_port_forward(bad, cfg, g, lbl).node_cls).all()


def test_deploy_csr_matches_default_path():
    """The two message passes compute one function: deploy decisions agree."""
    _, cfg, _, model, g, _ = _model_setup({}, seed=5)
    graph = RadarGraph.from_numpy(g)
    with torch.no_grad():
        a = model.deploy(graph)
        b = model.deploy(graph, mp_impl="csr")
    nm = g.node_mask
    np.testing.assert_allclose(b.node_cls.numpy()[nm], a.node_cls.numpy()[nm],
                               **FWD_TOL)
    np.testing.assert_array_equal(b.node2cluster.numpy(), a.node2cluster.numpy())


# -------------------------------------------------------------- train step
def test_csr_train_step_matches_jax():
    """Two ``make_train_step(cfg, mp_impl="csr")`` steps against the JAX
    package's flax-path step (the CSR fast path computes the same function,
    test_pallas.py test_fast_path_csr_matches_flax_model)."""
    over = dict(csr_edge_tile=128, csr_window=64)
    jcfg, cfg = JC.tiny_test_config(**over), tiny_test_config(**over)
    js = T.create_train_state(jcfg, jax.random.key(0))
    st = S.create_train_state(cfg, device="cpu")
    st.model.load_state_dict(state_dict_from_flax(jax.tree.map(np.asarray, js.params)))
    gen = SyntheticRadarDataset(jcfg, seed=5, num_objects=3).batches(jcfg.batch_size)
    jstep, pstep = T.make_train_step(jcfg), S.make_train_step(cfg, mp_impl="csr")
    for _ in range(2):
        b = next(gen)
        js, jm = jstep(js, jax.tree.map(jnp.asarray, b))
        st, pm = pstep(st, b)
        assert set(pm) == set(jm)
        for k in jm:
            np.testing.assert_allclose(float(pm[k]), float(jm[k]), **STEP_TOL,
                                       err_msg=k)
    want = state_dict_from_flax(jax.tree.map(np.asarray, js.params))
    for k, v in st.model.state_dict().items():
        np.testing.assert_allclose(v.numpy(), want[k].numpy(), **STEP_TOL,
                                   err_msg=k)


def test_csr_train_scan_is_sequential_steps():
    """make_train_scan(cfg, 2, mp_impl="csr") == two CSR train steps, on
    a config whose own mp_impl is the default."""
    cfg = tiny_test_config(csr_edge_tile=128, csr_window=64)
    gen = TP.SyntheticRadarDataset(cfg, seed=9, num_objects=2).batches(2)
    batches = [next(gen) for _ in range(2)]
    a = S.create_train_state(cfg, device="cpu")
    b = S.create_train_state(cfg, device="cpu")
    step = S.make_train_step(cfg, mp_impl="csr")
    for batch in batches:
        a, ma = step(a, batch)
    stacked = TP.stack_batch([(x.graph, x.labels) for x in batches])
    b, mb = S.make_train_scan(cfg, 2, mp_impl="csr")(b, stacked)
    assert {k: float(v) for k, v in ma.items()} == {k: float(v) for k, v in mb.items()}
    for k, v in a.model.state_dict().items():
        assert torch.equal(v, b.model.state_dict()[k]), k


def test_csr_train_step_skips_violating_graph():
    """Through the guard, a window violation gives skipped = 1 and leaves
    the state as it was; the config's own tiling gives a normal step."""
    cfg = tiny_test_config(mp_impl="csr", csr_edge_tile=16, csr_window=8)
    batch = next(SyntheticRadarDataset(JC.tiny_test_config(), seed=5,
                                       num_objects=3).batches(2))
    st = S.create_train_state(cfg, device="cpu")
    before = {k: v.clone() for k, v in st.model.state_dict().items()}
    st, m = S.make_train_step(cfg)(st, batch)
    assert float(m["skipped"]) == 1.0 and st.updates == 0
    assert all(torch.equal(v, before[k]) for k, v in st.model.state_dict().items())
    st, m = S.make_train_step(cfg, mp_impl="onehot")(st, batch)
    assert float(m["skipped"]) == 0.0 and st.updates == 1


# ------------------------------------------------------------------ guards
def test_cpu_calls_launch_no_kernel(rng):
    args, edge_tile, window, src_window = _problem("banded_src_window", rng)
    before = (C.fused_message_pass_csr.launches,
              C.fused_message_pass_csr_backward.launches)
    t = _torch(args)
    t[0].requires_grad_()
    C.fused_message_pass_csr(*t, 0.01, edge_tile, window, False,
                             src_window).sum().backward()
    g = torch.ones(t[0].shape[0], t[6].shape[1])
    C.fused_message_pass_csr_backward(*[a.detach() for a in t], g, 0.01,
                                      edge_tile, window, src_window)
    assert (C.fused_message_pass_csr.launches,
            C.fused_message_pass_csr_backward.launches) == before


def test_mp_impl_is_validated():
    for bad in ("bogus", "CSR"):
        with pytest.raises(ValueError, match="mp_impl"):
            tiny_test_config(mp_impl=bad)
    with pytest.raises(ValueError, match="csr"):
        RadarGNN(tiny_test_config(mp_impl="csr", aggregation="max"))(
            *_csr_inputs())


def _csr_inputs():
    cfg = tiny_test_config()
    g, lbl = pad_frame(SyntheticRadarDataset(JC.tiny_test_config(), seed=1,
                                             num_objects=2).sample_frame(),
                       JC.tiny_test_config())
    return (RadarGraph.from_numpy(g), torch.from_numpy(lbl.node2cluster),
            cfg.max_clusters, torch.from_numpy(lbl.cluster_mask))


def test_wrapper_checks_shapes(rng):
    args, *_ = _problem("symmetric", rng)
    t = _torch(args)
    with pytest.raises(TypeError):
        C.fused_message_pass_csr(t[0], t[1], t[2].long(), *t[3:])
    with pytest.raises(ValueError):
        C.fused_message_pass_csr_backward(*t, torch.zeros(3, 3))
