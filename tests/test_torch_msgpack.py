"""The port's JAX-free msgpack reader and writer (``utils/flax_msgpack.py``,
``utils/checkpoint.load_params_msgpack`` / ``save_params_msgpack``) against
flax's own ``serialization.msgpack_restore`` / ``msgpack_serialize``: the
committed fixture weights key for key and bit for bit, read and written
back byte for byte (also through ``state_dict_from_flax`` and its
inverse), synthetic trees that flax (and msgpack, for the encodings flax's
trees do not reach by chance) write with every type the reader handles;
each model family's weights written by the port and read by the JAX
package's ``load_params_msgpack``; and the JAX detector on weights the
port wrote."""

import json
import os

import flax.serialization as fs
import jax
import jax.numpy as jnp
import ml_dtypes
import msgpack
import numpy as np
import pytest
import torch

from graph_neural_network_for_radar_perception_torch.config.config import (
    GNNConfig,
    tiny_test_config,
)
from graph_neural_network_for_radar_perception_torch.data import synthetic as TSY
from graph_neural_network_for_radar_perception_torch.data.pipeline import (
    preprocess_frame as t_preprocess,
)
from graph_neural_network_for_radar_perception_torch.eval import drivers as TD
from graph_neural_network_for_radar_perception_torch.infer import pipeline as TPI
from graph_neural_network_for_radar_perception_torch.models import classifier as TCL
from graph_neural_network_for_radar_perception_torch.models import cnn as TCNN
from graph_neural_network_for_radar_perception_torch.models.gat import RadarGNNv2
from graph_neural_network_for_radar_perception_torch.models.gnn import RadarGNN, RadarGNNv1
from graph_neural_network_for_radar_perception_torch.utils import convert as CV
from graph_neural_network_for_radar_perception_torch.utils import flax_msgpack as FMP
from graph_neural_network_for_radar_perception_torch.utils.checkpoint import (
    load_params_msgpack,
    save_params_msgpack,
)
from graph_neural_network_for_radar_perception_tpu.config import config as JC
from graph_neural_network_for_radar_perception_tpu.data.pipeline import (
    SyntheticRadarDataset,
    pad_frame,
)
from graph_neural_network_for_radar_perception_tpu.data.pipeline import (
    preprocess_frame as j_preprocess,
)
from graph_neural_network_for_radar_perception_tpu.eval import drivers as JD
from graph_neural_network_for_radar_perception_tpu.infer import pipeline as JPI
from graph_neural_network_for_radar_perception_tpu.models import classifier as JCL
from graph_neural_network_for_radar_perception_tpu.models import cnn as JCNN
from graph_neural_network_for_radar_perception_tpu.models import gat as JG
from graph_neural_network_for_radar_perception_tpu.models import gnn as JN
from graph_neural_network_for_radar_perception_tpu.train.steps import init_params
from graph_neural_network_for_radar_perception_tpu.utils import checkpoint as JCK
from torch_port_fixtures import jax_native, one_torch_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WEIGHTS = os.path.join(REPO, "runs", "fixture_artifact", "weights.msgpack")


def _leaves(tree):
    return jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: not isinstance(x, (dict, list)))[0]


def _assert_same(got, want):
    """The same tree: the same paths and, leaf for leaf, the same type and
    value (arrays: dtype, shape and bytes; bfloat16 as float32 bits)."""
    gl, wl = _leaves(got), _leaves(want)
    assert [p for p, _ in gl] == [p for p, _ in wl]
    for (path, g), (_, w) in zip(gl, wl):
        if isinstance(w, (np.ndarray, np.generic)):
            if w.dtype == ml_dtypes.bfloat16:
                w = np.asarray(w).astype(np.float32)
            assert isinstance(g, type(w)), path
            assert g.dtype == w.dtype and np.shape(g) == np.shape(w), path
            assert np.asarray(g).tobytes() == np.asarray(w).tobytes(), path
        else:
            assert type(g) is type(w) and g == w, path


def test_fixture_weights_bitwise_equal_to_flax():
    got = load_params_msgpack(WEIGHTS)
    with open(WEIGHTS, "rb") as f:
        want = fs.msgpack_restore(f.read())
    _assert_same(got, want)
    assert len(_leaves(got)) == 184
    assert got["encode_node_feat"]["MLPStack_0"]["FFNBlock_0"]["Linear_0"][
        "Dense_0"]["kernel"].flags.writeable


def _synthetic_tree():
    rng = np.random.default_rng(0)
    arrays = {
        name: rng.normal(size=(3, 4, 5)).astype(name)
        for name in ("float32", "float64", "float16")
    }
    arrays.update(
        int8=rng.integers(-128, 127, (7,)).astype(np.int8),
        uint8=rng.integers(0, 255, (2, 3)).astype(np.uint8),
        int32=rng.integers(-2**31, 2**31 - 1, (4,)).astype(np.int32),
        int64=rng.integers(-2**62, 2**62, (4,)).astype(np.int64),
        uint64=np.array([2**64 - 1, 0], np.uint64),
        bool=rng.random((5,)) > 0.5,
        scalar_array=np.array(3.5, np.float32),
        empty=np.zeros((0, 3), np.float32),
        bf16=rng.normal(size=(6,)).astype(ml_dtypes.bfloat16),
        ext16=rng.normal(size=(2000,)).astype(np.float32),    # ext 16
        ext32=rng.normal(size=(20000,)).astype(np.float32),   # ext 32
    )
    scalars = {"np_f32": np.float32(1.25), "np_i64": np.int64(-7),
               "np_bool": np.bool_(True), "np_u16": np.uint16(65535)}
    python = {
        "none": None, "true": True, "false": False,
        "ints": [0, 127, -1, -32, -33, 128, 255, 256, 65535, 65536, 2**32 - 1,
                 2**32, 2**63, 2**64 - 1, -128, -129, -32768, -32769,
                 -2**31, -2**31 - 1, -2**63],
        "floats": [0.5, -1e300, float("inf")],
        "complex": 1.5 - 2j,
        "strs": ["", "x" * 31, "y" * 32, "z" * 300, "w" * 70000, "ünï"],
        "bins": [b"", b"a" * 300, b"b" * 70000],
        "list16": list(range(20)),
        "list32": list(range(70000)),
        "map16": {str(i): i for i in range(20)},
        "map32": {str(i): i for i in range(70000)},
    }
    return {"params": {"arrays": arrays, "scalars": scalars}, "python": python}


def test_synthetic_tree_written_by_flax():
    data = fs.msgpack_serialize(_synthetic_tree())
    _assert_same(FMP.msgpack_restore(data), fs.msgpack_restore(data))


def test_chunked_arrays(monkeypatch):
    """Arrays above flax's chunk size are written as the chunked dict form
    (its tuples as dicts keyed "0", "1", ...); the reader joins them."""
    monkeypatch.setattr(fs, "MAX_CHUNK_SIZE", 64)
    tree = {"a": {"big": np.arange(100, dtype=np.float32).reshape(4, 25),
                  "small": np.arange(3, dtype=np.int32)},
            "top": np.arange(50, dtype=np.float64)}
    data = fs.msgpack_serialize(tree)
    raw = msgpack.unpackb(data, ext_hook=lambda c, d: d, raw=False)
    assert raw["a"]["big"]["__msgpack_chunked_array__"]
    assert len(raw["a"]["big"]["chunks"]) == 7
    got = FMP.msgpack_restore(data)
    _assert_same(got, fs.msgpack_restore(data))
    np.testing.assert_array_equal(got["a"]["big"], tree["a"]["big"])


@pytest.mark.parametrize("size", [1, 2, 4, 8, 16])
def test_fixext_encodings(size):
    """flax's ndarray and scalar exts land in fixext 1-16 when the packed
    triple has that size: a (shape, dtype, bytes) triple of 16 bytes, and
    raw fixexts of other codes the reader must refuse."""
    if size == 16:
        triple = msgpack.packb(((2,), "uint16", b"\x01\x02\x03\x04"), use_bin_type=True)
        assert len(triple) == 16
        for code in (1, 3):
            data = msgpack.packb({"x": msgpack.ExtType(code, triple)})
            assert data[3] == 0xD8  # fixext 16
            _assert_same(FMP.msgpack_restore(data), fs.msgpack_restore(data))
    data = msgpack.packb(msgpack.ExtType(9, b"\x00" * size))
    with pytest.raises(FMP.MsgpackError, match="ext type 9"):
        FMP.msgpack_restore(data)


@pytest.mark.parametrize("bad", [b"", b"\x92\x01", b"\xc1", b"\x01\x02"],
                         ids=["empty", "truncated", "reserved", "trailing"])
def test_malformed_bytes_raise(bad):
    with pytest.raises(FMP.MsgpackError):
        FMP.msgpack_restore(bad)


# --- the writer ---------------------------------------------------------------

def test_fixture_weights_written_back_bytewise():
    """The committed weights, read by the port and written back: the same
    1 859 560 bytes."""
    with open(WEIGHTS, "rb") as f:
        data = f.read()
    assert FMP.msgpack_serialize(FMP.msgpack_restore(data)) == data
    assert len(data) == 1859560


def test_fixture_weights_through_state_dict_bytewise(tmp_path):
    """The committed weights → ``state_dict_from_flax`` → a port model →
    its state_dict → ``flax_from_state_dict`` → ``save_params_msgpack``:
    the committed file byte for byte."""
    with open(WEIGHTS, "rb") as f:
        data = f.read()
    model = RadarGNN(GNNConfig(max_nodes=256, max_clusters=128, temporal_window_size=5))
    model.load_state_dict(CV.state_dict_from_flax(load_params_msgpack(WEIGHTS)))
    path = tmp_path / "w" / "weights.msgpack"
    save_params_msgpack(CV.flax_from_state_dict(model.state_dict()), str(path))
    assert path.read_bytes() == data
    assert os.listdir(tmp_path / "w") == ["weights.msgpack"]  # no temporary left


def test_synthetic_tree_written_as_flax():
    """Every type of the reader's test tree (bfloat16 and ext 8/16/32,
    numpy scalars, every int width, str/bin/array/map of each length
    class), written by the port: flax's bytes."""
    tree = _synthetic_tree()
    assert FMP.msgpack_serialize(tree) == fs.msgpack_serialize(tree, in_place=True)
    # flax's copying form first rebuilds every dict in sorted key order
    assert FMP.msgpack_serialize(_key_sorted(tree)) == fs.msgpack_serialize(tree)


def _key_sorted(tree):
    if isinstance(tree, dict):
        return {k: _key_sorted(tree[k]) for k in sorted(tree)}
    return tree


def test_chunked_arrays_written_as_flax(monkeypatch):
    """Above the chunk size the port writes flax's chunked form: the same
    bytes as flax under the same (small) chunk size, read back whole."""
    monkeypatch.setattr(fs, "MAX_CHUNK_SIZE", 64)
    monkeypatch.setattr(FMP, "MAX_CHUNK_SIZE", 64)
    tree = {"a": {"big": np.arange(100, dtype=np.float32).reshape(4, 25),
                  "small": np.arange(3, dtype=np.int32)},
            "top": np.arange(50, dtype=np.float64), "odd": np.arange(9, dtype=np.int8)}
    data = FMP.msgpack_serialize(tree)
    # in place, flax chunks a copy's leaves: the dicts are copied first
    assert data == fs.msgpack_serialize(dict(tree, a=dict(tree["a"])), in_place=True)
    assert FMP.msgpack_serialize(_key_sorted(tree)) == fs.msgpack_serialize(tree)
    raw = msgpack.unpackb(data, ext_hook=lambda c, d: d, raw=False)
    assert raw["a"]["big"]["__msgpack_chunked_array__"] and len(raw["a"]["big"]["chunks"]) == 7
    _assert_same(FMP.msgpack_restore(data), tree)


def test_writer_refuses_what_flax_cannot_write():
    with pytest.raises(FMP.MsgpackError, match="cannot write"):
        FMP.msgpack_serialize({"x": object()})
    with pytest.raises(FMP.MsgpackError, match="does not fit"):
        FMP.msgpack_serialize({"x": 2**64})


def _tiny_graph_inputs(jcfg):
    graph, labels = pad_frame(
        SyntheticRadarDataset(jcfg, seed=5, num_objects=3).sample_frame(), jcfg)
    return (jax.tree.map(jnp.asarray, graph), jnp.asarray(labels.node2cluster),
            jcfg.max_clusters, jnp.asarray(labels.cluster_mask))


def _init(module, key, *args, static=()):
    """A flax module's params, its init jitted (one compile, not an eager
    dispatch per op)."""
    return jax.jit(module.init, static_argnums=tuple(s + 1 for s in static))(key, *args)["params"]


def _family(kind):
    """(JAX params, port model, forward converter, inverse) of one family
    at small widths."""
    key = jax.random.key(3)
    gat = dict(hidden_node_channels_gat=32, num_heads_gat=4)
    if kind in ("gnn", "v1", "v2"):
        jcfg, cfg = JC.tiny_test_config(**gat), tiny_test_config(**gat)
        if kind == "gnn":
            params = init_params(jcfg, key)
        else:
            jcls = JN.RadarGNNv1 if kind == "v1" else JG.RadarGNNv2
            params = _init(jcls(jcfg), key, *_tiny_graph_inputs(jcfg), static=(2,))
        model = {"gnn": RadarGNN, "v1": RadarGNNv1, "v2": RadarGNNv2}[kind](cfg)
        return params, model, CV.state_dict_from_flax, CV.flax_from_state_dict
    rng = np.random.default_rng(3)
    if kind == "classifier":
        kw = dict(node_feat_enc_stem_channels=(32, 32), graph_convolution_stem_channels=(32, 24),
                  msg_mlp_hidden_dim=32, node_pred_stem_channels=(32, 32), max_points=64,
                  max_objects=8, max_edges=256)
        jc = JCL.ClassifierConfig(**kw)
        sample = JCL.ClassifierSample(
            rng.normal(size=(64, 5)).astype(np.float32), np.ones(64, bool),
            np.zeros(64, np.int32), np.zeros(256, np.int32), np.zeros(256, np.int32),
            np.ones(256, bool), np.zeros(8, np.int32), np.ones(8, bool))
        params = _init(JCL.ObjectClassifierGNN(jc), key, sample)
        return (params, TCL.ObjectClassifierGNN(TCL.ClassifierConfig(**kw)),
                CV.classifier_state_dict_from_flax, CV.classifier_flax_from_state_dict)
    if kind == "cnn":
        kw = dict(base_stem_channels=(8, 8), base_kernel_sizes=(5, 3),
                  bottleneck_number_of_blocks=(2, 1), bottleneck_stem_channels=(16, 16),
                  bottleneck_width_channels=8, neck_out_channels=8, head_stem_channels=(8,),
                  head_ffn_channels=(8, 8))
        tcfg = TCNN.CNNConfig(**kw)
        image = rng.normal(size=(1, 16, 16, 3)).astype(np.float32)
        grid = rng.normal(size=(1, 16, 16)).astype(np.float32)
        params = _init(JCNN.GridDetector(JCNN.CNNConfig(**kw)), key, image, grid, grid)
        return (params, TCNN.GridDetector(tcfg),
                lambda p: CV.cnn_state_dict_from_flax(p, tcfg),
                lambda sd: CV.cnn_flax_from_state_dict(sd, tcfg))
    x = rng.normal(size=(1, 8, 8, 4)).astype(np.float32)
    params = _init(JCNN.WSConvBlock(features=16, kernel_size=3, stride=1), key, x)
    return (params, TCNN.WSConvBlock(4, 16, 3, 1), CV.ws_conv_state_dict_from_flax,
            CV.ws_conv_flax_from_state_dict)


@pytest.mark.parametrize("kind", ["gnn", "v1", "v2", "classifier", "cnn", "ws_conv"])
def test_port_written_weights_read_by_jax(kind, tmp_path):
    """JAX params → the forward converter → a port model → its state_dict →
    the inverse → ``save_params_msgpack``: the JAX package's
    ``load_params_msgpack`` (its model's init as the template) reads the
    tree the converter started from, bit for bit, and the file is the JAX
    package's own ``save_params_msgpack`` of it, byte for byte."""
    params, model, forward, inverse = _family(kind)
    start = jax.tree.map(np.asarray, params)
    model.load_state_dict(forward(start))
    path = str(tmp_path / "port.msgpack")
    save_params_msgpack(inverse(model.state_dict()), path)
    got = JCK.load_params_msgpack(params, path)
    flat_got = jax.tree_util.tree_flatten_with_path(got)[0]
    flat_want = jax.tree_util.tree_flatten_with_path(start)[0]
    assert [p for p, _ in flat_got] == [p for p, _ in flat_want]
    for (path_, g), (_, w) in zip(flat_got, flat_want):
        g = np.asarray(g)
        assert g.dtype == w.dtype and g.shape == w.shape, path_
        assert g.tobytes() == w.tobytes(), path_
    JCK.save_params_msgpack(params, str(tmp_path / "jax.msgpack"))
    assert (tmp_path / "port.msgpack").read_bytes() == (tmp_path / "jax.msgpack").read_bytes()


def test_jax_detector_on_port_written_weights(jax_native, tmp_path):
    """The fixture weights, moved by the port (a seeded perturbation of
    every tensor) and written by it: the JAX ``FrameDetector`` over that
    file gives the port detector's decisions on the same weights: equal
    segmentation and detection confusion JSONs over a few windows."""
    with open(os.path.join(os.path.dirname(WEIGHTS), "config.json")) as f:
        saved = json.load(f)
    caps = dict(max_nodes=int(saved["max_nodes"]), max_clusters=int(saved["max_clusters"]),
                temporal_window_size=int(saved["temporal_window_size"]))
    jcfg, cfg = JC.GNNConfig(**caps), GNNConfig(**caps)
    rng = np.random.default_rng(16)
    sd = CV.state_dict_from_flax(load_params_msgpack(WEIGHTS))
    sd = {k: v * (1 + 1e-3 * torch.from_numpy(rng.standard_normal(v.shape).astype(np.float32)))
          for k, v in sd.items()}
    path = str(tmp_path / "params.msgpack")
    save_params_msgpack(CV.flax_from_state_dict(sd), path)
    params = JCK.load_params_msgpack(load_params_msgpack(WEIGHTS), path)
    jdet = JPI.FrameDetector(jcfg, params, eps=1.4, use_object_head=True)
    tdet = TPI.FrameDetector(cfg, sd, eps=1.4, use_object_head=True, device="cpu")
    data_rng = np.random.default_rng(61)
    dicts = [TSY.make_synthetic_frame(data_rng, num_objects=3,
                                      window_size=caps["temporal_window_size"])
             for _ in range(2)]
    frames = [(t_preprocess(d, cfg), j_preprocess(d, jcfg)) for d in dicts]
    frames = [f for f in frames if f[0] is not None]
    assert frames
    seg_t = TD.segmentation_confusion(tdet, [f[0] for f in frames])
    seg_j = JD.segmentation_confusion(jdet, [f[1] for f in frames])
    assert seg_t.cm.sum() > 0 and seg_t.to_json_dict() == seg_j.to_json_dict()
    det_t = TD.evaluate_detection_from_data(tdet, dicts, cluster_size_threshold=1, eps=0.7)
    det_j = JD.evaluate_detection_from_data(jdet, dicts, cluster_size_threshold=1, eps=0.7)
    assert det_t.cm.sum() > 0 and det_t.to_json_dict() == det_j.to_json_dict()
