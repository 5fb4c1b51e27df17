"""The port's bf16-operand message rounds (``bf16=True`` / ``mp_bf16=True``)
against the JAX package's bf16 Pallas kernels in interpret mode, on the same
numpy-seeded inputs and weights.

bf16 is a different function from the f32 round: every operand of a matrix
product is rounded to bfloat16, every product accumulates in float32.  The
two frameworks sum in other orders, and a float32 last-bit difference can
move a value across a bf16 rounding boundary, so the port is held at a bf16
tolerance (``BF16_TOL``) *and* must sit at least ``CLOSER`` times closer (max
abs error) to the JAX bf16 output than the port's f32 output does: a port
that ignored the flag would fail the second test.  The backward is the f32
recompute in both packages, so gradients under a fixed cotangent are held at
the f32 gradient tolerance."""

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
from graph_neural_network_for_radar_perception_torch.ops import fused_mp as FM
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
from graph_neural_network_for_radar_perception_tpu.ops.pallas import csr_mp as JCM
from graph_neural_network_for_radar_perception_tpu.ops.pallas import fused_mp as JFM
from graph_neural_network_for_radar_perception_tpu.train import loss as JL
from graph_neural_network_for_radar_perception_tpu.train import steps as T
from test_pallas import make_problem
from test_torch_csr import GRAPHS, _problem, _torch
from torch_port_fixtures import one_torch_thread  # noqa: F401  (autouse)

BF16_TOL = dict(rtol=1e-2, atol=1e-3)
GRAD_TOL = dict(rtol=2e-4, atol=2e-5)  # tests/test_pallas.py test_forward_bf16_mode
CLOSER = 10.0


def _assert_bf16_close(port_bf16, port_f32, want, what=""):
    """port_bf16 within BF16_TOL of want, and CLOSER times closer to it (max
    abs error) than port_f32."""
    port_bf16, port_f32, want = (np.asarray(a, np.float64)
                                 for a in (port_bf16, port_f32, want))
    np.testing.assert_allclose(port_bf16, want, **BF16_TOL, err_msg=what)
    err_bf16 = np.abs(port_bf16 - want).max()
    err_f32 = np.abs(port_f32 - want).max()
    assert err_f32 > 0, f"{what}: the f32 output equals the bf16 one"
    assert CLOSER * err_bf16 <= err_f32, (
        f"{what}: bf16 max err {err_bf16:.3e} is not {CLOSER}x below the f32 "
        f"output's {err_f32:.3e}")


def test_rounding_is_jax_astype(rng):
    """``_bf16`` rounds as ``astype(jnp.bfloat16)``: to nearest, ties to
    even, on ordinary values, exact ties and the edges of the range."""
    v = rng.normal(size=4096).astype(np.float32) * np.float32(10.0) ** rng.integers(
        -30, 30, size=4096).astype(np.float32)
    ties = (np.arange(1, 257, dtype=np.uint32) << 16 | 0x8000).view(np.float32)
    edge = np.array([0.0, -0.0, 1e-40, -1e-40, 3.38e38, -3.38e38, np.inf], np.float32)
    for a in (v, ties, -ties, edge):
        want = np.asarray(jnp.asarray(a).astype(jnp.bfloat16).astype(jnp.float32))
        np.testing.assert_array_equal(FM._bf16(torch.from_numpy(a)).numpy(), want)


# ------------------------------------------------------------ the fused round
@pytest.mark.parametrize("e, edge_tile", [(700, 256), (500, 256)],
                         ids=["padded", "non_divisible_tile"])
def test_fused_bf16_matches_pallas_interpret(rng, e, edge_tile):
    """The plain bf16 round (through the autograd Function and directly)
    against ``fused_message_pass(..., interpret=True, bf16=True)`` on the
    problem of tests/test_pallas.py, sentinel edges included."""
    args = make_problem(rng, e=e)
    want = np.asarray(JFM.fused_message_pass(
        *map(jnp.asarray, args), 0.01, edge_tile, True, True))
    t = _torch(args)
    f32 = FM.fused_message_pass(*t, 0.01).detach()
    for got in (FM.fused_message_pass(*t, 0.01, True).detach(),
                FM.fused_message_pass_reference(*t, 0.01, bf16=True)):
        _assert_bf16_close(got, f32, want)


@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
@pytest.mark.parametrize("de, h, d2", [(64, 256, 128), (96, 256, 64)],
                         ids=["wide-t8", "wide-t16"])
def test_wide_fused_forward_matches_pallas_interpret(rng, de, h, d2, bf16):
    """The plain fused round (the version the card's forward kernel is held
    against) at the widest widths that kernel takes on an H100, those of
    its 8- and 16-edge tiles (tests/test_torch_cuda.py FWD_SHAPES), against
    ``fused_message_pass(..., interpret=True)``: f32 at the f32 tolerance,
    bf16 at ``BF16_TOL`` and CLOSER times closer than f32."""
    args = make_problem(rng, n=64, e=300, d=16, de=de, h=h, d2=d2)
    want = np.asarray(JFM.fused_message_pass(
        *map(jnp.asarray, args), 0.01, 128, True, bf16))
    t = _torch(args)
    got = FM.fused_message_pass_reference(*t, 0.01, bf16=bf16)
    if bf16:
        _assert_bf16_close(got, FM.fused_message_pass_reference(*t, 0.01), want)
    else:
        np.testing.assert_allclose(got.numpy(), want, **GRAD_TOL)


# -------------------------------------------------------------- the CSR round
@pytest.mark.parametrize("graph", list(GRAPHS))
def test_csr_bf16_matches_pallas_interpret(rng, graph):
    """The plain bf16 CSR round against ``fused_message_pass_csr(...,
    interpret=True, bf16=True)`` on the graphs of tests/test_torch_csr.py:
    x and W1r/W1s are rounded before the node products here, unlike the
    fused round."""
    args, edge_tile, window, src_window = _problem(graph, rng)
    want = np.asarray(JCM.fused_message_pass_csr(
        *map(jnp.asarray, args), 0.01, edge_tile, window, True, True, True,
        src_window))
    t = _torch(args)
    tiling = (0.01, edge_tile, window)
    f32 = C.fused_message_pass_csr(*t, *tiling, False, src_window).detach()
    for got in (C.fused_message_pass_csr(*t, *tiling, True, src_window).detach(),
                C.fused_message_pass_csr_reference(*t, *tiling, src_window, True)):
        _assert_bf16_close(got, f32, want)
    # The fused round's rounding points (the products rounded, not x) give
    # another function: the CSR plain version really rounds x first.
    src_e, dst_e = C._effective_indices(t[2], t[3], t[0].shape[0], edge_tile,
                                        window, src_window)
    fused_points = FM.fused_message_pass_reference(
        t[0], t[1], src_e, dst_e, *t[4:], 0.01, bf16=True)
    if graph != "window_violating":
        assert np.abs(fused_points.numpy() - want).max() > CLOSER * np.abs(
            C.fused_message_pass_csr_reference(*t, *tiling, src_window, True).numpy()
            - want).max()


# --------------------------------------------- widths the card's tiles pad
# Multiples of 4 that are not multiples of the tensor-core tiles (De and H
# of 16, D2 of 8): the card's bf16 forwards zero-pad their mma.sync operand
# tiles at these widths (csrc/mp_edge_tile.cuh, fwd_edge_kernel_bf16), and
# tests/test_torch_cuda.py holds them there against the plain bf16 rounds,
# which this test pins to the JAX package's bf16 Pallas kernels.
PAD_WIDTHS = dict(de=36, h=132, d2=68)
PAD_CASES = {"fused-padded": 700, "fused-non_divisible_tile": 500,
             **{f"csr-{g}": g for g in GRAPHS}}


def _assert_bf16_tol(port_bf16, port_f32, want, what=""):
    """port_bf16 within BF16_TOL of want element by element and CLOSER times
    closer to it in mean abs error than port_f32, which lies outside
    BF16_TOL somewhere (the rounding shows).  The mean, not the max: at
    these widths one flipped bf16 rounding between the two packages'
    summation orders moves a single element by a bf16 ulp."""
    port_bf16, port_f32, want = (np.asarray(a, np.float64)
                                 for a in (port_bf16, port_f32, want))
    np.testing.assert_allclose(port_bf16, want, **BF16_TOL, err_msg=what)
    assert not np.allclose(port_f32, want, **BF16_TOL), f"{what}: no rounding shows"
    err_bf16 = np.abs(port_bf16 - want).mean()
    err_f32 = np.abs(port_f32 - want).mean()
    assert CLOSER * err_bf16 <= err_f32, (
        f"{what}: bf16 mean err {err_bf16:.3e} is not {CLOSER}x below the f32 "
        f"output's {err_f32:.3e}")


@pytest.mark.parametrize("case", list(PAD_CASES))
def test_zero_padded_widths_bf16_match_pallas_interpret(rng, case):
    """The plain bf16 rounds, fused and CSR (through the autograd Function
    and directly), at PAD_WIDTHS against the JAX bf16 Pallas kernels in
    interpret mode: the fused round on tests/test_pallas.py's problem
    (sentinel edges, a tile that divides E or not), the CSR round on the
    graphs of tests/test_torch_csr.py."""
    if case.startswith("fused"):
        args = make_problem(rng, n=64, e=PAD_CASES[case], d=16, **PAD_WIDTHS)
        want = np.asarray(JFM.fused_message_pass(
            *map(jnp.asarray, args), 0.01, 256, True, True))
        t = _torch(args)
        f32 = FM.fused_message_pass(*t, 0.01).detach()
        got = [FM.fused_message_pass(*t, 0.01, True).detach(),
               FM.fused_message_pass_reference(*t, 0.01, bf16=True)]
    else:
        args, edge_tile, window, src_window = _problem(PAD_CASES[case], rng, d=20,
                                                       **PAD_WIDTHS)
        want = np.asarray(JCM.fused_message_pass_csr(
            *map(jnp.asarray, args), 0.01, edge_tile, window, True, True, True,
            src_window))
        t = _torch(args)
        tiling = (0.01, edge_tile, window)
        f32 = C.fused_message_pass_csr(*t, *tiling, False, src_window).detach()
        got = [C.fused_message_pass_csr(*t, *tiling, True, src_window).detach(),
               C.fused_message_pass_csr_reference(*t, *tiling, src_window, True)]
    for g in got:
        _assert_bf16_tol(g, f32, want, case)


# ------------------------------------------------------------------ gradients
@pytest.mark.parametrize("mp", ["fused", "csr"])
def test_bf16_round_gradients_are_the_f32_backward(rng, mp):
    """Under a fixed cotangent (a linear loss) the gradients through a bf16
    round equal the JAX bf16 kernel's (its f32 recompute backward) and the
    port's own f32 round's."""
    if mp == "fused":
        args = [np.asarray(a) for a in make_problem(rng, n=64, e=300)]
        tiling = (0.01,)

        def jax_round(x, ef, w1, b1, w2, b2, g1, be1, g2, be2):
            return JFM.fused_message_pass(
                x, ef, jnp.asarray(args[2]), jnp.asarray(args[3]), w1, b1, w2,
                b2, g1, be1, g2, be2, 0.01, 128, True, True, True)

        def port_round(x, ef, w1, b1, w2, b2, *sc, bf16):
            return FM.fused_message_pass(x, ef, *_torch(args[2:4]), w1, b1, w2,
                                         b2, *sc, *tiling, bf16)
    else:
        args, edge_tile, window, src_window = _problem("banded_src_window", rng)

        def jax_round(x, ef, w1, b1, w2, b2, g1, be1, g2, be2):
            return JCM.fused_message_pass_csr(
                x, ef, jnp.asarray(args[2]), jnp.asarray(args[3]), w1, b1, w2,
                b2, g1, be1, g2, be2, 0.01, edge_tile, window, True, True,
                True, src_window)

        def port_round(x, ef, w1, b1, w2, b2, *sc, bf16):
            return C.fused_message_pass_csr(
                x, ef, *_torch(args[2:4]), w1, b1, w2, b2, *sc, 0.01,
                edge_tile, window, bf16, src_window)

    diff = [args[0], args[1]] + list(args[4:])
    n, d2 = args[0].shape[0], args[6].shape[1]
    cot = rng.normal(size=(n, d2)).astype(np.float32)
    want = jax.grad(lambda *a: jnp.sum(jax_round(*a) * cot),
                    argnums=tuple(range(10)))(*map(jnp.asarray, diff))
    got = {}
    for bf16 in (True, False):
        leaves = [a.requires_grad_() for a in _torch(diff)]
        out = port_round(*leaves, bf16=bf16)
        got[bf16] = torch.autograd.grad((out * torch.from_numpy(cot)).sum(), leaves)
    for i, (a, b, c) in enumerate(zip(got[True], got[False], want)):
        np.testing.assert_allclose(a.numpy().reshape(np.shape(c)), np.asarray(c),
                                   **GRAD_TOL, err_msg=f"grad {i}")
        np.testing.assert_array_equal(a.numpy(), b.numpy())


# ---------------------------------------------------------------------- model
MODEL_CASES = {
    "onehot": (dict(), None),
    "csr": (dict(csr_edge_tile=128, csr_window=64), "csr"),
}


def _model_setup(overrides, seed=3):
    jcfg, cfg = JC.tiny_test_config(**overrides), tiny_test_config(**overrides)
    params = T.init_params(jcfg, jax.random.key(seed))
    model = RadarGNN(cfg)
    model.load_state_dict(state_dict_from_flax(jax.tree.map(np.asarray, params)))
    return jcfg, cfg, params, model


@pytest.mark.parametrize("case", list(MODEL_CASES))
def test_model_bf16_matches_fast_path_interpret(case):
    """``RadarGNN.forward(..., mp_bf16=True)`` against ``fast_forward(...,
    interpret=True, mp_bf16=True)`` on the same weights, every output on its
    valid rows, for both message passes."""
    overrides, mp_impl = MODEL_CASES[case]
    jcfg, cfg, params, model = _model_setup(overrides)
    g, lbl = pad_frame(SyntheticRadarDataset(jcfg, seed=2, num_objects=2)
                       .sample_frame(), jcfg)
    want = fast_forward(params, jax.tree.map(jnp.asarray, g),
                        jnp.asarray(lbl.node2cluster), jcfg.max_clusters,
                        jnp.asarray(lbl.cluster_mask), jcfg, interpret=True,
                        mp_bf16=True, mp_impl=mp_impl or "onehot")
    got = {}
    with torch.no_grad():
        for bf16 in (True, False):
            got[bf16] = model.eval()(
                RadarGraph.from_numpy(g), torch.from_numpy(lbl.node2cluster),
                cfg.max_clusters, torch.from_numpy(lbl.cluster_mask),
                mp_impl=mp_impl, mp_bf16=bf16)
    rows = {"node_cls": g.node_mask, "node_offsets": g.node_mask,
            "node_embed": g.node_mask, "edge_cls": g.und_mask,
            "obj_cls": lbl.cluster_mask}
    for name, m in rows.items():
        _assert_bf16_close(getattr(got[True], name).numpy()[m],
                           getattr(got[False], name).numpy()[m],
                           np.asarray(getattr(want, name))[m], name)


def _jax_loss_fn(jcfg, mp_impl):
    """The JAX package's ``make_loss_fn(use_fast_path=True, mp_bf16=True)``
    with the kernels in interpret mode (that signature has no interpret)."""

    def single(params, graph, node2cluster, cluster_mask):
        return fast_forward(params, graph, node2cluster, jcfg.max_clusters,
                            cluster_mask, jcfg, interpret=True, mp_bf16=True,
                            mp_impl=mp_impl, pallas_backward=True)

    def loss_fn(params, batch):
        outs = jax.vmap(single, in_axes=(None, 0, 0, 0))(
            params, batch.graph, batch.labels.node2cluster,
            batch.labels.cluster_mask)
        sums = jax.vmap(lambda o, g, l: JL.graph_loss_sums(o, g, l, jcfg))(
            outs, batch.graph, batch.labels)
        return JL.reduce_loss_sums(T.tree_sum(sums), jcfg)

    return loss_fn


@pytest.mark.parametrize("case", list(MODEL_CASES))
def test_bf16_loss_and_gradients_match_jax(case):
    """``make_loss_fn(cfg, mp_impl, mp_bf16=True)``: the loss terms and every
    parameter's gradient against ``jax.value_and_grad`` of the JAX fast path
    with bf16 operands, for both message passes; the port's f32 loss and
    gradients must sit CLOSER times further from them.

    The object loss is weighted 0 here: its head max-pools each cluster per
    channel, and where the two packages sum the CSR node products in other
    orders a flipped bf16 rounding can move that maximum to another node,
    which moves the gradient by a step rather than by a rounding (the
    object head's outputs are held in the forward test above)."""
    overrides, mp_impl = MODEL_CASES[case]
    jcfg, cfg, params, model = _model_setup(
        dict(overrides, obj_cls_loss_weight=0.0), seed=0)
    batch = next(SyntheticRadarDataset(jcfg, seed=5, num_objects=3).batches(2))
    (_, jm), jgrads = jax.value_and_grad(
        _jax_loss_fn(jcfg, mp_impl or "onehot"), has_aux=True)(
            params, jax.tree.map(jnp.asarray, batch))
    want = state_dict_from_flax(jax.tree.map(np.asarray, jgrads))
    got = {}
    for bf16 in (True, False):
        model.zero_grad(set_to_none=True)
        loss, pm = S.make_loss_fn(cfg, mp_impl, bf16)(
            model, S.batch_on(batch, "cpu"))
        loss.backward()
        got[bf16] = ({k: float(v.detach()) for k, v in pm.items()},
                     {k: p.grad.numpy().copy() for k, p in model.named_parameters()})
    losses = [k for k in jm if k.startswith("loss_")]
    _assert_bf16_close([got[True][0][k] for k in losses],
                       [got[False][0][k] for k in losses],
                       [float(jm[k]) for k in losses], "losses")
    names = sorted(want)
    scale = max(np.abs(want[k].numpy()).max() for k in names)
    flat = lambda d: np.concatenate([np.ravel(d[k]) for k in names])
    w = flat({k: want[k].numpy() for k in names})
    a, b = flat(got[True][1]), flat(got[False][1])
    np.testing.assert_allclose(a, w, rtol=BF16_TOL["rtol"],
                               atol=BF16_TOL["atol"] * scale, err_msg="grads")
    assert CLOSER * np.abs(a - w).max() <= np.abs(b - w).max()


@pytest.mark.parametrize("mp_impl", [None, "csr"], ids=["onehot", "csr"])
def test_bf16_train_scan_is_sequential_steps(mp_impl):
    """make_train_scan(cfg, 2, mp_bf16=True) == two bf16 train steps."""
    cfg = tiny_test_config(csr_edge_tile=128, csr_window=64)
    gen = TP.SyntheticRadarDataset(cfg, seed=9, num_objects=2).batches(2)
    batches = [next(gen) for _ in range(2)]
    a = S.create_train_state(cfg, device="cpu")
    b = S.create_train_state(cfg, device="cpu")
    step = S.make_train_step(cfg, mp_impl, mp_bf16=True)
    for batch in batches:
        a, ma = step(a, batch)
    stacked = TP.stack_batch([(x.graph, x.labels) for x in batches])
    b, mb = S.make_train_scan(cfg, 2, mp_impl, mp_bf16=True)(b, stacked)
    assert float(ma["skipped"]) == 0.0
    assert {k: float(v) for k, v in ma.items()} == {k: float(v) for k, v in mb.items()}
    for k, v in a.model.state_dict().items():
        assert torch.equal(v, b.model.state_dict()[k]), k
    # ... and the steps were bf16 ones: f32 steps reach other params.
    c = S.create_train_state(cfg, device="cpu")
    for batch in batches:
        c, _ = S.make_train_step(cfg, mp_impl)(c, batch)
    assert any(not torch.equal(v, c.model.state_dict()[k])
               for k, v in a.model.state_dict().items())


def test_mp_bf16_raises_on_a_round_that_is_not_fused():
    """Without channel norm + leaky ReLU + sum aggregation there is no fused
    round to run in bf16: a ValueError, never a silent f32 round."""
    cfg = tiny_test_config(aggregation="max")
    model = RadarGNN(cfg)
    g, lbl = pad_frame(SyntheticRadarDataset(JC.tiny_test_config(), seed=1,
                                             num_objects=2).sample_frame(),
                       JC.tiny_test_config())
    args = (RadarGraph.from_numpy(g), torch.from_numpy(lbl.node2cluster),
            cfg.max_clusters, torch.from_numpy(lbl.cluster_mask))
    with torch.no_grad():
        assert torch.isfinite(model(*args).node_cls).all()
        with pytest.raises(ValueError, match="mp_bf16"):
            model(*args, mp_bf16=True)
    st = S.create_train_state(cfg, device="cpu")
    b = next(TP.SyntheticRadarDataset(cfg, seed=0, num_objects=2).batches(2))
    with pytest.raises(ValueError, match="mp_bf16"):
        S.make_train_step(cfg, mp_bf16=True)(st, b)
    assert st.updates == 0


def test_cpu_bf16_calls_launch_no_kernel(rng):
    """On CPU tensors both bf16 rounds run their plain versions: no counter
    moves."""
    counters = (FM.fused_message_pass, C.fused_message_pass_csr)
    before = [(c.launches, c.launches_bf16) for c in counters]
    t = _torch(make_problem(rng, n=32, e=100))
    FM.fused_message_pass(*t, 0.01, True)
    args, edge_tile, window, src_window = _problem("symmetric", rng)
    C.fused_message_pass_csr(*_torch(args), 0.01, edge_tile, window, True,
                             src_window)
    assert [(c.launches, c.launches_bf16) for c in counters] == before
