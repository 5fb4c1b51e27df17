"""The port's JAX-free msgpack reader (``utils/flax_msgpack.py``,
``utils/checkpoint.load_params_msgpack``) against flax's own
``serialization.msgpack_restore``: the committed fixture weights key for
key and bit for bit, and synthetic trees that flax (and msgpack, for the
encodings flax's trees do not reach by chance) write with every type the
reader handles."""

import os

import flax.serialization as fs
import jax
import ml_dtypes
import msgpack
import numpy as np
import pytest

from graph_neural_network_for_radar_perception_torch.utils import flax_msgpack as FMP
from graph_neural_network_for_radar_perception_torch.utils.checkpoint import (
    load_params_msgpack,
)

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
