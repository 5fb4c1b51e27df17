"""The port's BEV-grid data plane and grid CNN against the JAX package's,
from the same seeded numpy inputs and carried weights (tests/test_cnn_grid.py's
patterns): gridification (priority, empty cells), covariances, likelihood
and range/azimuth maps, ``build_grid_sample`` and
``preprocess_frame_hybrid``; flax's SAME padding and bilinear resize,
``WSConvBlock``, ``GridDetector`` forward (small and full width),
``grid_loss`` and three SGD steps with the NaN skip."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from graph_neural_network_for_radar_perception_torch.config.config import (
    tiny_test_config,
)
from graph_neural_network_for_radar_perception_torch.data import grid as TG
from graph_neural_network_for_radar_perception_torch.data import synthetic as TSY
from graph_neural_network_for_radar_perception_torch.data.labels import (
    ID_STATIC,
    INVALID_NUM,
)
from graph_neural_network_for_radar_perception_torch.data.pipeline import (
    preprocess_frame_hybrid as t_hybrid,
)
from graph_neural_network_for_radar_perception_torch.models import cnn as TC
from graph_neural_network_for_radar_perception_torch.train.steps import Optimizer
from graph_neural_network_for_radar_perception_torch.utils.convert import (
    cnn_state_dict_from_flax,
    ws_conv_state_dict_from_flax,
)
from graph_neural_network_for_radar_perception_tpu.config import config as JCF
from graph_neural_network_for_radar_perception_tpu.data import grid as JG
from graph_neural_network_for_radar_perception_tpu.data.pipeline import (
    preprocess_frame_hybrid as j_hybrid,
)
from graph_neural_network_for_radar_perception_tpu.models import cnn as JC
from torch_port_fixtures import jax_native, one_torch_thread  # noqa: F401

SPEC_KW = dict(min_x=0, max_x=16, min_y=-8, max_y=8, dx=0.5, dy=0.5)
TSPEC, JSPEC = TG.GridSpec(**SPEC_KW), JG.GridSpec(**SPEC_KW)
# f32 maps on two CPU backends: small widths; the full-width forward
# (13 convolutions deep, 1024 channels) as the full-width deploy test.
TOL = dict(rtol=1e-5, atol=1e-5)
FULL_TOL = dict(rtol=1e-3, atol=1e-4)
STEP_TOL = dict(rtol=1e-5, atol=1e-6)
STEPS = 3
TINY = dict(base_stem_channels=(8, 8), base_kernel_sizes=(5, 3),
            bottleneck_number_of_blocks=(1, 1), bottleneck_stem_channels=(16, 16),
            bottleneck_width_channels=8, neck_out_channels=8,
            head_stem_channels=(8,), head_ffn_channels=(8,), learning_rate=0.01)
# Two blocks in a stage (one without a projector), two FFN layers in the head.
TINY_DEEP = dict(TINY, bottleneck_number_of_blocks=(2, 1), head_ffn_channels=(8, 8))


def T(a):
    return torch.from_numpy(np.array(a))


def _measurements(rng, n, *, collide=False):
    px = rng.uniform(0, 15, n).astype(np.float32)
    py = rng.uniform(-7, 7, n).astype(np.float32)
    if collide:  # many rows per cell: the priority decides
        px, py = np.round(px) + 0.1, np.round(py) + 0.1
        px[: n // 2] += rng.uniform(0, 0.3, n // 2).astype(np.float32)
    return px, py


# --- grid data plane ------------------------------------------------------

def test_gridify_priority():
    """Two measurements in one cell: the dynamic one wins (as JAX)."""
    px, py = np.array([1.1, 1.2], np.float32), np.array([0.1, 0.2], np.float32)
    values = np.array([[1.0], [2.0]], np.float32)
    labels = np.array([ID_STATIC, 0.0], np.float32)
    mask = np.array([True, True])
    vg, lg = TG.gridify(TSPEC, T(px), T(py), T(values), T(labels), T(mask))
    ix, iy = TSPEC.cell_index(T(px[1:]), T(py[1:]))
    assert float(vg[ix[0], iy[0], 0]) == 2.0 and float(lg[ix[0], iy[0]]) == 0.0
    jv, jl = JG.gridify(JSPEC, *map(jnp.asarray, (px, py, values, labels, mask)))
    np.testing.assert_array_equal(vg.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(lg.numpy(), np.asarray(jl))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_gridify_matches_jax(seed):
    rng = np.random.default_rng(seed)
    n = 200
    px, py = _measurements(rng, n, collide=True)
    values = rng.normal(size=(n, 4)).astype(np.float32)
    labels = rng.choice([0, 1, 4, ID_STATIC], n).astype(np.float32)
    mask = rng.random(n) > 0.2
    vg, lg = TG.gridify(TSPEC, T(px), T(py), T(values), T(labels), T(mask))
    jv, jl = JG.gridify(JSPEC, *map(jnp.asarray, (px, py, values, labels, mask)))
    np.testing.assert_array_equal(vg.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(lg.numpy(), np.asarray(jl))
    assert (lg.numpy() == INVALID_NUM).sum() > TSPEC.num_x * TSPEC.num_y // 2


def test_gridify_empty_cells_invalid():
    vg, lg = TG.gridify(TSPEC, T(np.array([1.0], np.float32)), T(np.array([0.0], np.float32)),
                        torch.ones(1, 1), torch.zeros(1), torch.tensor([True]))
    assert (lg.numpy() == INVALID_NUM).sum() == TSPEC.num_x * TSPEC.num_y - 1


def test_covariances_and_encodings_match_jax(rng):
    px, py = _measurements(rng, 50)
    np.testing.assert_allclose(TG.measurement_covariances(TSPEC, T(px), T(py)).numpy(),
                               np.asarray(JG.measurement_covariances(JSPEC, px, py)), **TOL)
    for a, b in zip(TG.range_azimuth_encoding(TSPEC), JG.range_azimuth_encoding(JSPEC)):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(TSPEC.cell_centers(), JSPEC.cell_centers())


def test_likelihood_peaks_at_measurement():
    centers = T(TSPEC.cell_centers())
    meas = T(np.array([[4.25, 0.25]], np.float32))
    lik = TG.likelihood_map(TSPEC, meas, torch.eye(2)[None], torch.tensor([True]),
                            centers).numpy()
    ix, iy = TSPEC.cell_index(meas[:, 0], meas[:, 1])
    assert lik[int(ix[0]), int(iy[0])] == lik.max()
    assert lik.max() == pytest.approx(1.0, abs=1e-3)


@pytest.mark.parametrize("n_valid", [0, 1, 37])
def test_likelihood_matches_jax(rng, n_valid):
    px, py = _measurements(rng, 48)
    mask = np.arange(48) < n_valid
    xy = np.stack([px, py], -1)
    cov = np.asarray(JG.measurement_covariances(JSPEC, px, py))
    got = TG.likelihood_map(TSPEC, T(xy), T(cov), T(mask), T(TSPEC.cell_centers())).numpy()
    want = np.asarray(JG.likelihood_map(JSPEC, jnp.asarray(xy), jnp.asarray(cov),
                                        jnp.asarray(mask), jnp.asarray(JSPEC.cell_centers())))
    np.testing.assert_allclose(got, want, **TOL)
    if n_valid == 0:
        assert not got.any()


def _grid_inputs(rng, n):
    px, py = _measurements(rng, n)
    data = {"meas_px": px, "meas_py": py,
            "meas_vr": rng.normal(size=n).astype(np.float32),
            "meas_rcs": rng.normal(size=n).astype(np.float32)}
    gt = {"class_labels": rng.integers(0, 8, n).astype(np.float32),
          "offsetx": rng.normal(size=n).astype(np.float32),
          "offsety": rng.normal(size=n).astype(np.float32)}
    return data, gt


def _samples_close(got, want):
    assert got.keys() == want.keys()
    for k in ("vr", "rcs", "offset_grid", "label_grid"):
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    np.testing.assert_allclose(got["image"], want["image"], **TOL)


@pytest.mark.parametrize("n", [20, 40])
def test_build_grid_sample_matches_jax(rng, n):
    """40 measurements over a capacity of 32: the first 32 are kept."""
    data, gt = _grid_inputs(rng, n)
    got = TG.build_grid_sample(TSPEC, data, gt, max_meas=32, device="cpu")
    want = JG.build_grid_sample(JSPEC, data, gt, max_meas=32)
    assert got["image"].shape == (TSPEC.num_x, TSPEC.num_y, 3)
    assert 0 < (got["label_grid"] != INVALID_NUM).sum() <= min(n, 32)
    _samples_close(got, want)


def test_grid_sample_refuses_the_card_without_one(monkeypatch, rng):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    data, gt = _grid_inputs(rng, 10)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        TG.build_grid_sample(TSPEC, data, gt, max_meas=16)  # default: the card


@pytest.mark.parametrize("flip", [False, True])
def test_preprocess_frame_hybrid_matches_jax(jax_native, flip):
    cfg, jcfg = tiny_test_config(), JCF.tiny_test_config()
    data = TSY.make_synthetic_frame(np.random.default_rng(3), num_objects=3,
                                    window_size=cfg.temporal_window_size)
    spec_kw = dict(min_x=0, max_x=48, min_y=-24, max_y=24, dx=1.0, dy=1.0)
    fr, got = t_hybrid(data, cfg, TG.GridSpec(**spec_kw), max_meas=256,
                       flip_along_x=flip, device="cpu")
    jfr, want = j_hybrid(data, jcfg, JG.GridSpec(**spec_kw), max_meas=256,
                         flip_along_x=flip)
    _samples_close(got, want)
    assert (got["label_grid"] != INVALID_NUM).any()
    for name in ("node_feat", "edge_feat", "senders", "receivers", "node_class",
                 "node2cluster", "cluster_class"):
        np.testing.assert_array_equal(getattr(fr, name), getattr(jfr, name), err_msg=name)


# --- the grid CNN -----------------------------------------------------------

@pytest.mark.parametrize("hw, k, s", [((9, 8), 3, 2), ((10, 7), 11, 2), ((8, 8), 7, 1),
                                      ((7, 5), 1, 2)])
def test_same_padding_matches_flax(rng, hw, k, s):
    """Stride 2 pads low total//2 and high the rest, as flax does."""
    x = rng.normal(size=(1,) + hw + (3,)).astype(np.float32)
    conv = jax.lax.conv_general_dilated
    w = rng.normal(size=(k, k, 3, 4)).astype(np.float32)
    want = conv(x, w, (s, s), "SAME", dimension_numbers=("NHWC", "HWIO", "NHWC"))
    got = torch.nn.functional.conv2d(TC.same_pad(T(x).permute(0, 3, 1, 2), k, s),
                                     T(w).permute(3, 2, 0, 1), stride=s)
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("src, dst", [((7, 7), (13, 13)), ((13, 13), (25, 25)),
                                      ((4, 3), (9, 8)), ((25, 25), (50, 50))])
def test_resize_matches_jax_while_upsampling(rng, src, dst):
    """Non-integer scales included (7 → 13, 4 → 9): half-pixel centres."""
    x = rng.normal(size=(2,) + src + (3,)).astype(np.float32)
    want = jax.image.resize(x, (2,) + dst + (3,), method="bilinear")
    got = TC._resize(T(x).permute(0, 3, 1, 2), dst).permute(0, 2, 3, 1)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_resize_refuses_downsampling():
    with pytest.raises(ValueError, match="downsamples"):
        TC._resize(torch.zeros(1, 2, 8, 8), (4, 8))


def test_ws_conv_block_matches_jax(rng):
    x = rng.normal(size=(2, 16, 13, 4)).astype(np.float32)
    for stride in (1, 2):
        blk = JC.WSConvBlock(features=32, kernel_size=3, stride=stride)
        params = blk.init(jax.random.key(stride), jnp.asarray(x))["params"]
        # scale and bias away from their init, so that the test sees them
        params = jax.tree.map(lambda p: p + 0.1 * jnp.arange(p.size).reshape(p.shape)
                              / p.size, params)
        want = blk.apply({"params": params}, jnp.asarray(x))
        tblk = TC.WSConvBlock(4, 32, 3, stride)
        tblk.load_state_dict(ws_conv_state_dict_from_flax(jax.tree.map(np.asarray, params)))
        with torch.no_grad():
            got = tblk(T(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
        assert got.shape == want.shape
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def _detectors(kw, hw, batch=1, seed=0):
    tcfg, jcfg = TC.CNNConfig(**kw), JC.CNNConfig(**kw)
    rng = np.random.default_rng(seed)
    image = rng.normal(size=(batch,) + hw + (3,)).astype(np.float32)
    vr = rng.normal(size=(batch,) + hw).astype(np.float32) * 10
    rcs = rng.normal(size=(batch,) + hw).astype(np.float32) * 10
    jmodel = JC.GridDetector(jcfg)
    params = jmodel.init(jax.random.key(seed), image, vr, rcs)["params"]
    model = TC.GridDetector(tcfg)
    model.load_state_dict(cnn_state_dict_from_flax(jax.tree.map(np.asarray, params), tcfg))
    return tcfg, jcfg, jmodel, params, model, (image, vr, rcs)


@pytest.mark.parametrize("kw, hw", [(TINY, (32, 32)), (TINY_DEEP, (30, 26)),
                                    (TINY, (17, 23))],
                         ids=["tiny", "deep_odd", "odd"])
def test_forward_matches_jax(kw, hw):
    """Odd sizes make every stride-2 pad asymmetric and every resize a
    non-integer scale."""
    tcfg, _, jmodel, params, model, inputs = _detectors(kw, hw, batch=2)
    assert len(model.state_dict()) == len(jax.tree.leaves(params))
    want = jmodel.apply({"params": params}, *inputs)
    with torch.no_grad():
        got = model(*map(T, inputs))
    assert got.cls.shape == (2,) + hw + (8,) and got.reg.shape == (2,) + hw + (2,)
    np.testing.assert_allclose(got.cls.numpy(), np.asarray(want.cls), **TOL)
    np.testing.assert_allclose(got.reg.numpy(), np.asarray(want.reg), **TOL)


def test_full_width_forward_matches_jax(monkeypatch):
    """CNNConfig() at full width on the default GridSpec's 200 × 200 grid,
    batch 1: pyramid 100, 50, 25, 13, 7, every resize upsampling."""
    spec = TG.GridSpec()
    hw = (spec.num_x, spec.num_y)
    _, _, jmodel, params, model, inputs = _detectors({}, hw)
    sizes, real_resize = [], TC._resize

    def recording_resize(x, size):
        sizes.append((tuple(x.shape[2:]), tuple(size)))
        return real_resize(x, size)

    monkeypatch.setattr(TC, "_resize", recording_resize)
    with torch.no_grad():
        got = model(*map(T, inputs))
    assert sizes == [((7, 7), (13, 13)), ((13, 13), (25, 25)), ((25, 25), (50, 50)),
                     ((50, 50), (100, 100)), ((100, 100), (200, 200))]
    want = jmodel.apply({"params": params}, *inputs)
    np.testing.assert_allclose(got.cls.numpy(), np.asarray(want.cls), **FULL_TOL)
    np.testing.assert_allclose(got.reg.numpy(), np.asarray(want.reg), **FULL_TOL)


def _labels(rng, batch, hw):
    labels = np.full((batch,) + hw, INVALID_NUM, np.float32)
    labels[:, 5:15, 5:15] = rng.integers(0, 6, (batch, 10, 10))
    labels[:, 20:25, 20:25] = 7.0  # STATIC cells
    labels[:, 16:18, 2:4] = 6.0    # FALSE cells
    offsets = rng.normal(size=(batch,) + hw + (2,)).astype(np.float32)
    return labels, offsets


def test_grid_loss_matches_jax(rng):
    tcfg, jcfg = TC.CNNConfig(**TINY), JC.CNNConfig(**TINY)
    cls = rng.normal(size=(2, 32, 32, 8)).astype(np.float32)
    reg = rng.normal(size=(2, 32, 32, 2)).astype(np.float32)
    labels, offsets = _labels(rng, 2, (32, 32))
    got_total, got = TC.grid_loss(TC.GridOutputs(T(cls), T(reg)), T(labels), T(offsets), tcfg)
    want_total, want = JC.grid_loss(JC.GridOutputs(cls, reg), labels, offsets, jcfg)
    np.testing.assert_allclose(float(got_total), float(want_total), **TOL)
    for k in want:
        np.testing.assert_allclose(float(got[k]), float(want[k]), **TOL, err_msg=k)
    empty = np.full((1, 8, 8), INVALID_NUM, np.float32)
    total, _ = TC.grid_loss(TC.GridOutputs(torch.zeros(1, 8, 8, 8), torch.zeros(1, 8, 8, 2)),
                            T(empty), torch.zeros(1, 8, 8, 2), tcfg)
    assert float(total) == 0.0


def test_train_steps_match_jax(rng):
    """Three steps (weight decay, then SGD with momentum 0.9) from the same
    weights: metrics and every parameter after each; then a poisoned batch
    is skipped whole on both."""
    hw = (32, 32)
    tcfg, jcfg, _, _, _, (image, vr, rcs) = _detectors(TINY, hw, batch=2)
    labels, offsets = _labels(rng, 2, hw)
    _, jinit, jstep, _ = JC.make_grid_train_step(jcfg)
    jstate = jinit(jax.random.key(0), image, vr, rcs)
    init, step, _ = TC.make_grid_train_step(tcfg)
    state = init(device="cpu")
    state.model.load_state_dict(cnn_state_dict_from_flax(
        jax.tree.map(np.asarray, jstate.params), tcfg))
    args = (image, vr, rcs, labels, offsets)
    for i in range(STEPS):
        jstate, jm = jstep(jstate, *args)
        state, m = step(state, *args)
        for k in ("loss_cls", "loss_reg", "loss_total", "skipped"):
            np.testing.assert_allclose(float(m[k]), float(jm[k]), **STEP_TOL,
                                       err_msg=f"step {i} {k}")
        want = cnn_state_dict_from_flax(jax.tree.map(np.asarray, jstate.params), tcfg)
        for k, v in state.model.state_dict().items():
            np.testing.assert_allclose(v.numpy(), want[k].numpy(), **STEP_TOL,
                                       err_msg=f"step {i} {k}")
    before = {k: v.clone() for k, v in state.model.state_dict().items()}
    bad = image.copy()
    bad[0, 0, 0, 0] = np.nan
    jstate, jm = jstep(jstate, bad, vr, rcs, labels, offsets)
    state, m = step(state, bad, vr, rcs, labels, offsets)
    assert float(m["skipped"]) == float(jm["skipped"]) == 1.0
    assert all(torch.equal(v, before[k]) for k, v in state.model.state_dict().items())
    assert state.updates == STEPS and state.step == STEPS + 1


def test_two_steps_then_a_skip_on_the_flat_optimiser(rng, monkeypatch):
    """The step as JAX jits it: two steps against ``make_grid_train_step``
    (TINY widths) on the flat optimiser, then a batch with an infinite
    offset target (a finite image: the loss overflows) skipped in both
    packages with the parameters and the momentum buffer bit for bit; the
    loss makes no tensor from host values (``torch.tensor``) that a
    captured step would have to copy."""
    hw = (32, 32)  # test_train_steps_match_jax's shapes: XLA's compile cache serves both
    tcfg, jcfg, _, _, _, (image, vr, rcs) = _detectors(TINY, hw, batch=2)
    labels, offsets = _labels(rng, 2, hw)
    _, jinit, jstep, _ = JC.make_grid_train_step(jcfg)
    jstate = jinit(jax.random.key(0), image, vr, rcs)
    init, step, _ = TC.make_grid_train_step(tcfg)
    state = init(device="cpu")
    assert isinstance(state.optimizer, Optimizer)
    state.model.load_state_dict(cnn_state_dict_from_flax(
        jax.tree.map(np.asarray, jstate.params), tcfg))
    made, real_tensor = [], torch.tensor

    def recorded_step(*a):
        monkeypatch.setattr(torch, "tensor", lambda *t, **k: made.append(t) or real_tensor(*t, **k))
        try:
            return step(*a)
        finally:
            monkeypatch.setattr(torch, "tensor", real_tensor)

    args = (image, vr, rcs, labels, offsets)
    for i in range(2):
        jstate, jm = jstep(jstate, *args)
        state, m = (step if i == 0 else recorded_step)(state, *args)
        for k in ("loss_cls", "loss_reg", "loss_total", "skipped"):
            np.testing.assert_allclose(float(m[k]), float(jm[k]), **STEP_TOL,
                                       err_msg=f"step {i} {k}")
        want = cnn_state_dict_from_flax(jax.tree.map(np.asarray, jstate.params), tcfg)
        for k, v in state.model.state_dict().items():
            np.testing.assert_allclose(v.numpy(), want[k].numpy(), **STEP_TOL,
                                       err_msg=f"step {i} {k}")
    assert not made
    flat = state.optimizer.flat.clone()
    moments = state.optimizer.moments["momentum_buffer"].clone()
    bad = offsets.copy()
    bad[0, 5, 5, 0] = np.inf  # a valid dynamic cell (labels 0-5 at [5:15, 5:15])
    jstate, jm = jstep(jstate, image, vr, rcs, labels, bad)
    state, m = step(state, image, vr, rcs, labels, bad)
    assert float(m["skipped"]) == float(jm["skipped"]) == 1.0
    assert torch.equal(state.optimizer.flat, flat)
    assert torch.equal(state.optimizer.moments["momentum_buffer"], moments)
    assert (state.step, state.updates) == (3, 2)


def test_grid_trainer_refuses_the_card_without_one(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    init, _, _ = TC.make_grid_train_step(TC.CNNConfig(**TINY))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        init()
