"""The port's host data plane beyond the frame pipeline, against the JAX
package's: SE(2) algebra and stationary selection (the cases of
tests/test_data_plane.py, bit for bit; RANSAC from one seeded generator),
the RadarScenes reader on the mini-RadarScenes fixture (window metadata,
every field of a window, with flip and with RANSAC, the first batches of a
seeded dataset: bit for bit), bucketed batching (the same stream), and
``train_bucketed`` against the JAX loop from the same weights (metrics and
params at tests/test_torch_train.py's STEP_TOL)."""

import dataclasses
import itertools
import json

import jax
import numpy as np
import pytest

from fixtures_radarscenes import make_mini_radarscenes
from graph_neural_network_for_radar_perception_torch.config import config as TC
from graph_neural_network_for_radar_perception_torch.data import bucketing as TB
from graph_neural_network_for_radar_perception_torch.data import pipeline as TP
from graph_neural_network_for_radar_perception_torch.data import radarscenes as TR
from graph_neural_network_for_radar_perception_torch.data import se2 as TSE2
from graph_neural_network_for_radar_perception_torch.data import selection as TSEL
from graph_neural_network_for_radar_perception_torch.train import steps as TS
from graph_neural_network_for_radar_perception_torch.train import trainer as TT
from graph_neural_network_for_radar_perception_torch.utils.convert import (
    state_dict_from_flax,
)
from graph_neural_network_for_radar_perception_tpu.config import config as JC
from graph_neural_network_for_radar_perception_tpu.data import bucketing as JB
from graph_neural_network_for_radar_perception_tpu.data import pipeline as JP
from graph_neural_network_for_radar_perception_tpu.data import radarscenes as JR
from graph_neural_network_for_radar_perception_tpu.data import se2 as JSE2
from graph_neural_network_for_radar_perception_tpu.data import selection as JSEL
from graph_neural_network_for_radar_perception_tpu.train import steps as JS
from graph_neural_network_for_radar_perception_tpu.train import trainer as JT
from torch_port_fixtures import jax_native  # noqa: F401  (fixture)
from torch_port_fixtures import one_torch_thread  # noqa: F401  (autouse)

STEP_TOL = dict(rtol=1e-4, atol=1e-6)  # tests/test_torch_train.py


def _assert_tree_equal(got, want, what=""):
    """Same structure, every array the same dtype and bits."""
    if isinstance(want, dict):
        assert got.keys() == want.keys(), what
        for k in want:
            _assert_tree_equal(got[k], want[k], f"{what}.{k}")
    elif isinstance(want, (list, tuple)):
        assert type(got) is type(want) and len(got) == len(want), what
        for i, (g, w) in enumerate(zip(got, want)):
            _assert_tree_equal(g, w, f"{what}[{i}]")
    elif dataclasses.is_dataclass(want):
        for f in dataclasses.fields(want):
            _assert_tree_equal(getattr(got, f.name), getattr(want, f.name),
                               f"{what}.{f.name}")
    else:
        g, w = np.asarray(got), np.asarray(want)
        assert g.dtype == w.dtype, what
        np.testing.assert_array_equal(g, w, err_msg=what)


# --------------------------------------------------------------------- SE(2)
def _se2_cases(rng):
    x, y = rng.normal(size=7), rng.normal(size=7)
    pts = np.array([[4.0, 1.0], [-2.0, 5.0]])
    px = [rng.normal(size=5), rng.normal(size=3)]
    py = [rng.normal(size=5), rng.normal(size=3)]
    vx = [rng.normal(size=5), rng.normal(size=3)]
    vy = [rng.normal(size=5), rng.normal(size=3)]
    one = [np.array([5.0]), np.array([0.0])]
    zero = [np.zeros(1), np.zeros(1)]
    return [
        ("se2", (1.0, 2.0, 0.7)),
        ("se2", (rng.normal(size=4), rng.normal(size=4), rng.normal(size=4))),
        ("se2_inverse", (JSE2.se2(1.0, 2.0, 0.7),)),
        ("seq_to_car", (x, y, 3.0, -1.5, 0.8)),
        ("car_to_seq", (x, y, 3.0, -1.5, 0.8)),
        ("seq_to_car", (pts[:, 0], pts[:, 1], 2.0, -3.0, 0.6)),
        ("ego_compensate_window", (px, py, vx, vy, [3.0, 3.0], [1.0, 1.0], [0.5, 0.5])),
        ("ego_compensate_window", (one, zero, zero, zero, [0.0, 10.0], [0.0, 0.0], [0.0, 0.0])),
        ("ego_compensate_window", (one, zero, zero, zero, [0.0, 0.0], [0.0, 0.0], [0.0, np.pi / 2])),
        ("ego_compensate_window", (px, py, vx, vy, rng.uniform(0, 10, 2),
                                   rng.uniform(0, 10, 2), rng.uniform(-1, 1, 2))),
        ("vel_polar_to_cart", (rng.normal(size=6), rng.normal(size=6), rng.normal(size=6))),
        ("vr_cartesian_vf", (rng.normal(size=6), rng.normal(size=6), 0.44)),
    ]


@pytest.mark.parametrize("case", range(12))
def test_se2_bitwise_jax(rng, case):
    name, args = _se2_cases(rng)[case]
    _assert_tree_equal(getattr(TSE2, name)(*args), getattr(JSE2, name)(*args), name)


# ------------------------------------------------------ stationary selection
def _ransac_input(rng, n=200):
    theta = rng.uniform(-np.pi, np.pi, n)
    vr = -(5.0 * np.cos(theta)) + rng.normal(0, 0.02, n)
    outliers = rng.random(n) < 0.1
    vr[outliers] += rng.uniform(2, 5, outliers.sum())
    return np.stack([theta, vr], axis=1)


def test_gating_bitwise_jax(rng):
    az = np.array([0.0, 0.0, np.pi / 4])
    vr = np.array([-10.0, 3.0, -10.0 * np.cos(np.pi / 4)])
    kw = dict(tx=3.0, ty=0.0, theta=0.0, vx_odom=10.0, yawrate_odom=0.0)
    got = TSEL.identify_stationary_measurements(az, vr, **kw)
    assert got.tolist() == [True, False, True]
    _assert_tree_equal(got, JSEL.identify_stationary_measurements(az, vr, **kw))
    az, vr = rng.uniform(-1.5, 1.5, 100), rng.normal(-5, 3, 100)
    args = (az, vr, 3.0, 0.3, 0.2, 9.0, 0.05)
    _assert_tree_equal(TSEL.gate_stationary(9.0, 0.0, 0.05, az, vr, 3.0, 0.3, 0.2),
                       JSEL.gate_stationary(9.0, 0.0, 0.05, az, vr, 3.0, 0.3, 0.2))
    _assert_tree_equal(TSEL.identify_stationary_measurements(*args),
                       JSEL.identify_stationary_measurements(*args))


def test_estimate_sensor_velocity_bitwise_jax(rng):
    theta = rng.uniform(-np.pi, np.pi, 100)
    vr = -(8.0 * np.cos(theta) - 2.0 * np.sin(theta))
    got = TSEL.estimate_sensor_vx_vy(theta, vr)
    np.testing.assert_allclose(got, [8.0, -2.0], atol=1e-9)
    _assert_tree_equal(got, JSEL.estimate_sensor_vx_vy(theta, vr))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_ransac_bitwise_jax_with_one_seed(rng, seed):
    z = _ransac_input(rng)
    got = TSEL.ransac(z, rng=np.random.default_rng(seed))
    want = JSEL.ransac(z, rng=np.random.default_rng(seed))
    assert got[1] and got[2] == want[2] and got[1] == want[1]
    _assert_tree_equal(got[0], want[0])
    flag = TSEL.identify_stationary_measurements(
        z[:, 0], -z[:, 1], 0.0, 0.0, 0.0, 5.0, 0.0, True, np.random.default_rng(seed))
    _assert_tree_equal(flag, JSEL.identify_stationary_measurements(
        z[:, 0], -z[:, 1], 0.0, 0.0, 0.0, 5.0, 0.0, True, np.random.default_rng(seed)))


def test_ransac_too_few_measurements():
    for sel in (TSEL, JSEL):
        inliers, valid, ratio = sel.ransac(np.zeros((5, 2)))
        assert not valid and not inliers.any() and ratio == 0.0


# ------------------------------------------------------- RadarScenes reader
@pytest.fixture(scope="module")
def mini_root(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("mini_radarscenes"))
    make_mini_radarscenes(root, seed=11, n_scenes=10, n_objects=3)
    make_mini_radarscenes(root, seed=12, n_scenes=8, n_objects=2,
                          seq_name="sequence_2", category="validation")
    return root


def _seeded_ransac(monkeypatch):
    """Both readers' stationary selection with RANSAC drawing from
    default_rng(0), default_rng(1), ... in call order (the readers pass no
    generator, so each would draw from fresh OS entropy)."""
    for module, sel in ((TR, TSEL), (JR, JSEL)):
        seeds = itertools.count()
        monkeypatch.setattr(
            module, "identify_stationary_measurements",
            lambda *a, _sel=sel, _seeds=seeds, **k: _sel.identify_stationary_measurements(
                *a, rng=np.random.default_rng(next(_seeds)), **k))


def test_split_and_window_metadata_bitwise_jax(mini_root):
    assert TR.train_val_test_split(mini_root, "data") == JR.train_val_test_split(mini_root, "data")
    assert TR.TEST_SEQUENCE_IDX == JR.TEST_SEQUENCE_IDX
    tc, jc = TR.SequenceCache(mini_root, "data"), JR.SequenceCache(mini_root, "data")
    names = ["sequence_1", "sequence_2"]
    for window in (3, 5):
        got = TR.build_metadata(tc, names, window)
        assert got == JR.build_metadata(jc, names, window) and len(got) > 4
    with open(f"{mini_root}/data/sequence_1/scenes.json") as f:
        scenes = json.load(f)
    assert TR.walk_scenes(scenes) == JR.walk_scenes(scenes)


@pytest.mark.parametrize("mode", ["plain", "flip", "ransac", "ransac_flip"])
def test_extract_window_bitwise_jax(monkeypatch, mini_root, mode):
    ransac, flip = "ransac" in mode, "flip" in mode
    if ransac:
        _seeded_ransac(monkeypatch)
    tc, jc = TR.SequenceCache(mini_root, "data"), JR.SequenceCache(mini_root, "data")
    md = TR.build_metadata(tc, ["sequence_1"], 5)
    stationary = 0
    for m in md[:4]:
        got = tc.extract_window(m["sequence_name"], m["data"], ransac, flip)
        want = jc.extract_window(m["sequence_name"], m["data"], ransac, flip)
        _assert_tree_equal(got, want, mode)
        stationary += int(got["stationary_meas_flag"].sum())
    assert stationary > 0


@pytest.mark.parametrize("ransac", [False, True], ids=["gating", "ransac"])
def test_dataset_batches_bitwise_jax(jax_native, monkeypatch, mini_root, ransac):
    if ransac:
        _seeded_ransac(monkeypatch)
    kw = dict(max_nodes=128, temporal_window_size=3, reject_static_meas_by_ransac=ransac)
    tcfg, jcfg = TC.tiny_test_config(**kw), JC.tiny_test_config(**kw)
    md = TR.build_metadata(TR.SequenceCache(mini_root, "data"), ["sequence_1", "sequence_2"], 3)
    tds = TR.RadarScenesDataset(tcfg, mini_root, md, augment=True, seed=5, dataset_path="data")
    jds = JR.RadarScenesDataset(jcfg, mini_root, md, augment=True, seed=5, dataset_path="data")
    assert len(tds) == len(jds) == len(md)
    items = [(tds[i], jds[i]) for i in range(3)]
    assert all(t is not None for t, _ in items)
    for t, j in items:
        _assert_tree_equal(t, j, "item")
    got, want = tds.batches(2), jds.batches(2)
    for i in range(3):
        g = next(got)
        assert g.graph.node_mask.sum() > 0
        _assert_tree_equal(g, next(want), f"batch {i}")


# ---------------------------------------------------------------- bucketing
def _frames(jcfg, k=24, seed=4):
    ds = JP.SyntheticRadarDataset(jcfg, seed=seed, num_objects=(1, 3))
    return [ds.sample_frame() for _ in range(k)]


def _port_frame(fr):
    return TP.FrameArrays(**dataclasses.asdict(fr))


BUCKETS = ((48, 16, 2), (64, 32, 2))


def test_default_buckets_and_bucket_cfg_equal_jax():
    for kw in ({}, {"max_nodes": 1536, "max_clusters": 512}, {"max_nodes": 100}):
        tcfg, jcfg = TC.GNNConfig(**kw), JC.GNNConfig(**kw)
        got, want = TB.default_buckets(tcfg), JB.default_buckets(jcfg)
        assert [dataclasses.astuple(b) for b in got] == [dataclasses.astuple(b) for b in want]
        for b, jb in zip(got, want):
            assert dataclasses.asdict(TB.bucket_cfg(tcfg, b)) == dataclasses.asdict(
                JB.bucket_cfg(jcfg, jb))


def test_bucketed_batches_same_stream():
    tcfg, jcfg = TC.tiny_test_config(), JC.tiny_test_config()
    frames = _frames(jcfg)
    got = list(TB.bucketed_batches(map(_port_frame, frames), tcfg,
                                   [TB.Bucket(*b) for b in BUCKETS]))
    want = list(JB.bucketed_batches(iter(frames), jcfg, [JB.Bucket(*b) for b in BUCKETS]))
    assert len(got) == len(want) >= 6
    assert {dataclasses.astuple(b) for b, _ in got} == set(BUCKETS)  # both reached
    for (gb, gbatch), (wb, wbatch) in zip(got, want):
        assert dataclasses.astuple(gb) == dataclasses.astuple(wb)
        _assert_tree_equal(gbatch, wbatch)


class _Recorder:
    """A writer that keeps every step's metrics (val_period 1: one step's)."""

    def __init__(self):
        self.rows = []

    def write_train_val(self, step, train, val):
        self.rows.append((step, dict(train)))


def test_train_bucketed_matches_jax():
    tcfg, jcfg = TC.tiny_test_config(), JC.tiny_test_config()
    frames = _frames(jcfg)
    js = JS.create_train_state(jcfg, jax.random.key(0))
    st = TS.create_train_state(tcfg, device="cpu")
    st.model.load_state_dict(state_dict_from_flax(jax.tree.map(np.asarray, js.params)))
    steps = 4
    jrec, trec = _Recorder(), _Recorder()
    js = JT.train_bucketed(
        jcfg, iter(frames), buckets=[JB.Bucket(*b) for b in BUCKETS], donate=False,
        state=js, max_iters=steps,
        hooks=JT.TrainHooks(log_period=1, val_period=1, writer=jrec, print_fn=lambda s: None))
    st = TT.train_bucketed(
        tcfg, map(_port_frame, frames), buckets=[TB.Bucket(*b) for b in BUCKETS],
        state=st, max_iters=steps,
        hooks=TT.TrainHooks(log_period=1, val_period=1, writer=trec, print_fn=lambda s: None))
    assert st.step == steps and [s for s, _ in trec.rows] == [s for s, _ in jrec.rows]
    for (_, got), (_, want) in zip(trec.rows, jrec.rows):
        assert got.keys() == want.keys()
        for k in want:
            np.testing.assert_allclose(got[k], want[k], **STEP_TOL, err_msg=k)
    want_params = state_dict_from_flax(jax.tree.map(np.asarray, js.params))
    for k, v in st.model.state_dict().items():
        np.testing.assert_allclose(v.numpy(), want_params[k].numpy(), **STEP_TOL, err_msg=k)


def test_bucketed_train_step_routes_by_bucket(monkeypatch):
    """make_bucketed_train_step builds one make_train_step per bucket with
    that bucket's config, and calls the bucket's own."""
    built = []

    def fake_make_train_step(cfg, **kw):
        built.append((cfg.max_nodes, cfg.max_clusters, cfg.batch_size, kw))
        return lambda state, batch: (state, cfg.max_nodes)

    monkeypatch.setattr(TS, "make_train_step", fake_make_train_step)
    buckets = [TB.Bucket(*b) for b in BUCKETS]
    step = TB.make_bucketed_train_step(TC.tiny_test_config(), buckets, mp_bf16=True)
    assert built == [(48, 16, 2, {"mp_bf16": True}), (64, 32, 2, {"mp_bf16": True})]
    assert [step("s", b, None)[1] for b in buckets] == [48, 64]
