"""The port's host data plane against the JAX package's: config, frame
preprocessing, padding and batching must give identical arrays, on
synthetic frames and on mini-RadarScenes fixture windows."""

import dataclasses

import numpy as np
import pytest
import torch

from fixtures_radarscenes import make_mini_radarscenes
from graph_neural_network_for_radar_perception_torch.config import config as TC
from graph_neural_network_for_radar_perception_torch.core.graph import (
    GraphBatch,
    RadarGraph,
)
from graph_neural_network_for_radar_perception_torch.data import pipeline as TP
from graph_neural_network_for_radar_perception_tpu.config import config as JC
from graph_neural_network_for_radar_perception_tpu.data import pipeline as JP
from graph_neural_network_for_radar_perception_tpu.data.radarscenes import (
    SequenceCache,
)
from graph_neural_network_for_radar_perception_tpu.data.synthetic import (
    make_synthetic_frame,
)
from torch_port_fixtures import jax_native  # noqa: F401  (fixture)
from torch_port_fixtures import one_torch_thread  # noqa: F401  (autouse)


def _assert_struct_equal(a, b, float_tol=None):
    """Field for field, same dtype and values: bit-identical, or floats
    within ``float_tol`` = (rtol, atol)."""
    names = [f.name for f in dataclasses.fields(b)]
    assert [f.name for f in dataclasses.fields(a)] == names
    for name in names:
        x, y = np.asarray(getattr(a, name)), np.asarray(getattr(b, name))
        assert x.dtype == y.dtype, name
        if float_tol is not None and x.dtype.kind == "f":
            np.testing.assert_allclose(x, y, *float_tol, err_msg=name)
        else:
            np.testing.assert_array_equal(x, y, err_msg=name)


def _assert_same_frame(data, tcfg, jcfg, flip=False):
    """The port's numpy builder against the JAX package's numpy builder and
    the port's default native C++ builder against the JAX package's
    (bit-identical each), and the numpy builder against the native one,
    whose float features the JAX package itself holds to its numpy path
    only at rtol 1e-5 / atol 1e-6 (tests/test_native.py): they differ in
    the last bit."""
    got = TP.preprocess_frame(data, tcfg, flip_along_x=flip, use_native=False)
    want = JP.preprocess_frame(data, jcfg, flip_along_x=flip, use_native=False)
    got_native = TP.preprocess_frame(data, tcfg, flip_along_x=flip)
    native = JP.preprocess_frame(data, jcfg, flip_along_x=flip)
    assert (got is None) == (want is None) == (native is None) == (got_native is None)
    if got is None:
        return False
    _assert_struct_equal(got, want)
    _assert_struct_equal(got_native, native)
    _assert_struct_equal(got, native, float_tol=(1e-5, 1e-6))
    for g, w in zip(TP.pad_frame(got, tcfg), JP.pad_frame(want, jcfg)):
        _assert_struct_equal(g, w)
    for g, w in zip(TP.pad_frame(got_native, tcfg), JP.pad_frame(native, jcfg)):
        _assert_struct_equal(g, w)
    for g, w in zip(TP.pad_frame(got, tcfg), JP.pad_frame(native, jcfg)):
        _assert_struct_equal(g, w, float_tol=(1e-5, 1e-6))
    return True


@pytest.mark.parametrize("make", ["default", "tiny"])
def test_config_is_a_copy(make):
    if make == "default":
        got, want = TC.GNNConfig(), JC.GNNConfig()
    else:
        got, want = TC.tiny_test_config(), JC.tiny_test_config()
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert (got.max_edges, got.max_und_edges, got.num_classes) == (
        want.max_edges, want.max_und_edges, want.num_classes)


@pytest.mark.parametrize("overrides", [
    {},                                        # shipped capacities
    {"max_nodes": 64, "max_clusters": 8},      # truncation
    {"spatial_sort": True},
    {"union_ball": True},
])
def test_synthetic_frames_bit_identical(jax_native, overrides):
    tcfg, jcfg = TC.GNNConfig(**overrides), JC.GNNConfig(**overrides)
    rng = np.random.default_rng(7)
    for i in range(3):
        data = make_synthetic_frame(rng, num_objects=4, window_size=5)
        assert _assert_same_frame(data, tcfg, jcfg, flip=bool(i % 2))


def test_fixture_windows_bit_identical(jax_native, tmp_path):
    make_mini_radarscenes(str(tmp_path), seed=777, n_scenes=12, n_objects=4,
                          seq_name="sequence_9", category="validation")
    cache = SequenceCache(str(tmp_path), "data", max_sequences=1)
    tcfg = TC.GNNConfig(max_nodes=256, max_clusters=128, temporal_window_size=5)
    jcfg = JC.GNNConfig(max_nodes=256, max_clusters=128, temporal_window_size=5)
    compared = 0
    for w in list(cache.windows("sequence_9", 5))[:6]:
        data = cache.extract_window("sequence_9", w)
        compared += _assert_same_frame(data, tcfg, jcfg)
    assert compared >= 4


def test_batches_stack_and_move_to_tensors():
    cfg = TC.tiny_test_config()
    ds = TP.SyntheticRadarDataset(cfg, seed=3, num_objects=2)
    jds = JP.SyntheticRadarDataset(JC.tiny_test_config(), seed=3, num_objects=2)
    got, want = next(ds.batches(2)), next(jds.batches(2))  # JAX: native builder
    _assert_struct_equal(got.graph, want.graph, float_tol=(1e-5, 1e-6))
    _assert_struct_equal(got.labels, want.labels)
    tb = GraphBatch.from_numpy(got)
    assert tb.batch_size == 2
    for f in dataclasses.fields(tb.graph):
        t = getattr(tb.graph, f.name)
        assert isinstance(t, torch.Tensor)
        np.testing.assert_array_equal(t.numpy(), getattr(got.graph, f.name))
    one = RadarGraph.from_numpy(TP.pad_frame(ds.sample_frame(), cfg)[0])
    assert one.num_nodes == cfg.max_nodes and one.num_edges == cfg.max_edges
    assert one.to("cpu").senders.dtype == torch.int32


def _csr_frame(**overrides):
    cfg = TC.tiny_test_config(mp_impl="csr", **overrides)
    return cfg, TP.SyntheticRadarDataset(cfg, seed=0, num_objects=2).sample_frame()


def test_pad_frame_csr_passes_intact_frame():
    """mp_impl='csr': an intact frame passes the contract check, with the
    same arrays as the JAX package's pad_frame under the same config
    (tests/test_pallas.py test_pad_frame_validates_csr_contract)."""
    cfg, fr = _csr_frame()
    jcfg = JC.tiny_test_config(mp_impl="csr")
    for g, w in zip(TP.pad_frame(fr, cfg),
                    JP.pad_frame(JP.FrameArrays(**dataclasses.asdict(fr)), jcfg)):
        _assert_struct_equal(g, w)


def test_pad_frame_csr_refuses_truncated_pair():
    """Dropping the first directed edge leaves its reverse: the edge set is
    no longer closed under reversal, and pad_frame raises as JAX's does."""
    cfg, fr = _csr_frame()
    bad = dataclasses.replace(fr, senders=fr.senders[1:],
                              receivers=fr.receivers[1:],
                              edge_feat=fr.edge_feat[1:])
    with pytest.raises(ValueError, match="CSR kernel contract"):
        TP.pad_frame(bad, cfg)
    with pytest.raises(ValueError, match="CSR kernel contract"):
        JP.pad_frame(JP.FrameArrays(**dataclasses.asdict(bad)),
                     JC.tiny_test_config(mp_impl="csr"))


def test_pad_frame_csr_refuses_source_window_span():
    """Without spatial sorting a narrow source window is violated; a window
    at the node capacity clips to the unwindowed gather and passes."""
    cfg, fr = _csr_frame(csr_edge_tile=128, csr_window=64, csr_src_window=16)
    with pytest.raises(ValueError, match="source window"):
        TP.pad_frame(fr, cfg)
    TP.pad_frame(fr, dataclasses.replace(cfg, csr_src_window=cfg.max_nodes))


def test_mp_impl_must_be_known():
    with pytest.raises(ValueError, match="mp_impl"):
        TC.GNNConfig(mp_impl="bogus")
    for ok in (None, "onehot", "csr"):
        assert TC.GNNConfig(mp_impl=ok).mp_impl == ok


def _frames(seed, k, num_objects=(1, 4)):
    ds = TP.SyntheticRadarDataset(TC.tiny_test_config(), seed=seed,
                                  num_objects=num_objects)
    return [ds.sample_frame() for _ in range(k)]


def _as_jax_frame(fr):
    return JP.FrameArrays(**dataclasses.asdict(fr))


def test_merge_and_pack_frames_bit_identical():
    frames = _frames(11, 7)
    jframes = [_as_jax_frame(f) for f in frames]
    _assert_struct_equal(TP.merge_frames(frames[:3]), JP.merge_frames(jframes[:3]))
    assert TP.merge_frames(frames[:1]) is frames[0]
    cfg, jcfg = TC.tiny_test_config(), JC.tiny_test_config()
    got, got_left = TP.pack_frames(frames, cfg, 3)
    want, want_left = JP.pack_frames(jframes, jcfg, 3)
    assert len(got) == len(want) and len(got_left) == len(want_left)
    for g, w in zip(got + got_left, want + want_left):
        _assert_struct_equal(g, w)
    assert TP.frame_fits((0, 0, 0, 0), frames[0], cfg) == JP.frame_fits(
        (0, 0, 0, 0), jframes[0], jcfg)


def test_packed_batches_bit_identical(monkeypatch):
    """Both datasets with their numpy graph builders (the native builder
    differs in the last bit; see _assert_same_frame)."""
    import functools

    for module in (JP, TP):
        monkeypatch.setattr(module, "preprocess_frame",
                            functools.partial(module.preprocess_frame, use_native=False))
    _assert_same_packed_batches()


def test_packed_batches_bit_identical_native(jax_native):
    """Both datasets with their default native graph builders."""
    _assert_same_packed_batches()


def _assert_same_packed_batches():
    cfg, jcfg = TC.tiny_test_config(), JC.tiny_test_config()
    got = TP.SyntheticRadarDataset(cfg, seed=17, num_objects=(1, 3)).packed_batches(2)
    want = JP.SyntheticRadarDataset(jcfg, seed=17, num_objects=(1, 3)).packed_batches(2)
    for _ in range(2):
        g, w = next(got), next(want)
        _assert_struct_equal(g.graph, w.graph)
        _assert_struct_equal(g.labels, w.labels)
    assert g.graph.node_mask.sum() > 0
