"""The port's native C++ data-plane library (``data/native.py`` over
``csrc/graph_builder.cpp``) against the JAX package's native library (bit for
bit: the same source and flags on one machine) and against the port's own
numpy implementations (at the JAX package's tolerances,
tests/test_native.py); ``preprocess_frame`` and ``pad_frame`` against the JAX
package's with either builder; the build itself: locked, atomic, and raising
where the compiler fails (no numpy fallback)."""

import dataclasses
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest

from graph_neural_network_for_radar_perception_torch.config import config as TC
from graph_neural_network_for_radar_perception_torch.data import features as TF
from graph_neural_network_for_radar_perception_torch.data import native as TN
from graph_neural_network_for_radar_perception_torch.data import pipeline as TP
from graph_neural_network_for_radar_perception_torch.data import se2 as TSE2
from graph_neural_network_for_radar_perception_torch.data import selection as TSEL
from graph_neural_network_for_radar_perception_torch.ops import _build
from graph_neural_network_for_radar_perception_tpu.config import config as JC
from graph_neural_network_for_radar_perception_tpu.data import pipeline as JP
from graph_neural_network_for_radar_perception_tpu.data.synthetic import (
    make_synthetic_frame,
)
from torch_port_fixtures import jax_native  # noqa: F401  (fixture)
from torch_port_fixtures import one_torch_thread  # noqa: F401  (autouse)

REPO = pathlib.Path(__file__).resolve().parents[1]


def make_meas(rng, n):
    return {
        "px": rng.uniform(0, 80, n).astype(np.float32),
        "py": rng.uniform(-40, 40, n).astype(np.float32),
        "vx": rng.normal(size=n).astype(np.float32),
        "vy": rng.normal(size=n).astype(np.float32),
        "ts": rng.uniform(0, 6e5, n).astype(np.float64),
    }


def _graph(nat, m, **kw):
    return nat.build_graph_native(m["px"], m["py"], m["vx"], m["vy"], m["ts"], **kw)


@pytest.mark.parametrize("n", [2, 7, 60, 300])
def test_graph_builder_bitwise_jax(jax_native, rng, n):
    m = make_meas(rng, n)
    if n > 2:  # exact distance ties: a duplicated point
        for key in ("px", "py"):
            m[key][1] = m[key][0]
    got = _graph(TN, m, k=10, eps_sq=25.0)
    want = _graph(jax_native, m, k=10, eps_sq=25.0)
    assert got.keys() == want.keys()
    for key in want:
        assert got[key].dtype == want[key].dtype, key
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)


def test_graph_builder_capacity_overflow_raises(jax_native, rng):
    m = make_meas(rng, 60)
    for nat in (TN, jax_native):
        with pytest.raises(ValueError, match="capacity overflow"):
            _graph(nat, m, k=10, eps_sq=25.0, e_cap=100)
        with pytest.raises(ValueError, match="capacity overflow"):
            _graph(nat, m, k=10, eps_sq=25.0, eu_cap=10)


@pytest.mark.parametrize("n", [7, 60, 300])
def test_graph_builder_matches_numpy(rng, n):
    """The port's native builder against its numpy builder: graph and degree
    equal, edge features at rtol 1e-5 / atol 1e-6 (ROADMAP.md C4)."""
    m = make_meas(rng, n)
    k, eps_sq = 10, 25.0
    ref = TF.adjacency_info(m["px"], m["py"], eps_sq, k)
    data = {"meas_px": m["px"], "meas_py": m["py"], "meas_vx": m["vx"],
            "meas_vy": m["vy"], "meas_timestamp": m["ts"]}
    ref_ef = TF.edge_features_np(data, ref["adj_list"])
    rows, cols = np.nonzero(np.triu(ref["adj_matrix"], k=1))
    out = _graph(TN, m, k=k, eps_sq=eps_sq)
    np.testing.assert_array_equal(out["senders"], ref["adj_list"][0])
    np.testing.assert_array_equal(out["receivers"], ref["adj_list"][1])
    np.testing.assert_array_equal(out["und_senders"], rows)
    np.testing.assert_array_equal(out["und_receivers"], cols)
    np.testing.assert_array_equal(out["degree"], ref["degree"])
    np.testing.assert_allclose(out["edge_feat"], ref_ef, rtol=1e-5, atol=1e-6)


def _window(rng):
    px = [rng.uniform(0, 50, 20).astype(np.float32) for _ in range(4)]
    py = [rng.uniform(-20, 20, 20).astype(np.float32) for _ in range(4)]
    ego = [rng.uniform(0, 10, 4), rng.uniform(0, 10, 4), rng.uniform(-1, 1, 4)]
    return px, py, ego


def test_ego_compensation_bitwise_jax(jax_native, rng):
    px, py, ego = _window(rng)
    got = TN.ego_compensate_native(px, py, *ego)
    want = jax_native.ego_compensate_native(px, py, *ego)
    for g, w in zip(got, want):
        for a, b in zip(g, w):
            np.testing.assert_array_equal(a, b)


def test_ego_compensation_matches_numpy(rng):
    """rtol 1e-5 / atol 1e-4, tests/test_native.py's tolerance (float32
    positions against the numpy path's float64)."""
    px, py, ego = _window(rng)
    vz = [np.zeros(20) for _ in range(4)]
    ref_px, ref_py, _, _ = TSE2.ego_compensate_window(px, py, vz, vz, *ego)
    nat_px, nat_py = TN.ego_compensate_native(px, py, *ego)
    for a, b in zip(nat_px + nat_py, ref_px + ref_py):
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-4)


def _gating_input(rng, n=100):
    return (rng.uniform(-1.5, 1.5, n).astype(np.float32),
            rng.normal(-5, 3, n).astype(np.float32))


def test_gating_bitwise_jax(jax_native, rng):
    az, vr = _gating_input(rng)
    args = (3.0, 0.3, 0.2, 9.0, 0.05)
    got = TN.gate_stationary_native(az, vr, *args)
    assert got.dtype == bool
    np.testing.assert_array_equal(got, jax_native.gate_stationary_native(az, vr, *args))


def test_gating_matches_numpy(rng):
    """Under 2 % of the points may flip: float32 against float64 rounding
    at the gate (tests/test_native.py)."""
    az, vr = _gating_input(rng)
    ref = TSEL.identify_stationary_measurements(
        az.astype(np.float64), vr.astype(np.float64),
        tx=3.0, ty=0.3, theta=0.2, vx_odom=9.0, yawrate_odom=0.05,
    )
    nat = TN.gate_stationary_native(az, vr, 3.0, 0.3, 0.2, 9.0, 0.05)
    assert (nat != ref).mean() < 0.02


def _assert_fields_equal(a, b):
    for f in dataclasses.fields(b):
        x, y = np.asarray(getattr(a, f.name)), np.asarray(getattr(b, f.name))
        assert x.dtype == y.dtype, f.name
        np.testing.assert_array_equal(x, y, err_msg=f.name)


@pytest.mark.parametrize("use_native", [True, False], ids=["native", "numpy"])
@pytest.mark.parametrize("seed", [3, 8])
def test_preprocess_and_pad_bitwise_jax(jax_native, use_native, seed):
    tcfg, jcfg = TC.tiny_test_config(max_nodes=128), JC.tiny_test_config(max_nodes=128)
    rng = np.random.default_rng(seed)
    for flip in (False, True):
        data = make_synthetic_frame(rng, num_objects=3, window_size=3)
        got = TP.preprocess_frame(data, tcfg, flip_along_x=flip, use_native=use_native)
        want = JP.preprocess_frame(data, jcfg, flip_along_x=flip, use_native=use_native)
        assert got is not None and want is not None
        _assert_fields_equal(got, want)
        for g, w in zip(TP.pad_frame(got, tcfg), JP.pad_frame(want, jcfg)):
            _assert_fields_equal(g, w)


def test_preprocess_default_is_native(monkeypatch):
    """preprocess_frame calls the native builder unless asked not to, or
    under union_ball (which the native builder does not build)."""
    calls = []
    real = TN.build_graph_native
    monkeypatch.setattr(TN, "build_graph_native",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    data = make_synthetic_frame(np.random.default_rng(1), num_objects=2, window_size=3)
    cfg = TC.tiny_test_config()
    TP.preprocess_frame(data, cfg)
    assert len(calls) == 1
    TP.preprocess_frame(data, cfg, use_native=False)
    TP.preprocess_frame(data, TC.tiny_test_config(union_ball=True))
    assert len(calls) == 1


@pytest.fixture
def fresh_build(monkeypatch, tmp_path):
    """An empty build directory and no library loaded in this process."""
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    TN._lib.cache_clear()
    yield tmp_path
    TN._lib.cache_clear()


def test_failed_build_raises_without_fallback(monkeypatch, fresh_build):
    """CXX=false: the build fails, and the native builder, available() and
    preprocess_frame's default path say so; nothing uses numpy instead."""
    monkeypatch.setenv("CXX", "false")
    with pytest.raises(RuntimeError, match="false failed to build"):
        _build.build_host("graph_builder")
    assert not TN.available()
    m = make_meas(np.random.default_rng(0), 20)
    with pytest.raises(RuntimeError, match="failed to build"):
        _graph(TN, m, k=10, eps_sq=25.0)
    data = make_synthetic_frame(np.random.default_rng(1), num_objects=2, window_size=3)
    with pytest.raises(RuntimeError, match="failed to build"):
        TP.preprocess_frame(data, TC.tiny_test_config())
    assert not list(fresh_build.glob("*.so"))  # no half-written library left


def test_concurrent_builds_share_one_library(fresh_build):
    """Four processes build into one empty directory at once: each waits on
    the lock, all load the same library, and no temporary file is left."""
    code = (
        "import ctypes, pathlib, sys; "
        "from graph_neural_network_for_radar_perception_torch.ops import _build; "
        "_build.BUILD_DIR = pathlib.Path(sys.argv[1]); "
        "p = _build.build_host('graph_builder'); "
        "ctypes.CDLL(str(p)).radar_build_graph; print(p)"
    )
    env = dict(os.environ, PYTHONPATH=str(REPO))
    procs = [subprocess.Popen([sys.executable, "-c", code, str(fresh_build)],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True, env=env) for _ in range(4)]
    outs = [p.communicate(timeout=120) for p in procs]
    assert [p.returncode for p in procs] == [0] * 4, [e for _, e in outs]
    assert len({o.strip() for o, _ in outs}) == 1
    assert [p.name for p in fresh_build.glob("*.so")] == [pathlib.Path(outs[0][0].strip()).name]


def test_library_key_follows_source_and_flags(monkeypatch, fresh_build):
    first = _build.build_host("graph_builder")
    assert TN.available() and _build.build_host("graph_builder") == first
    monkeypatch.setattr(_build, "HOST_FLAGS", _build.HOST_FLAGS + ("-DRADAR_KEY_TEST",))
    assert _build.build_host("graph_builder") != first
