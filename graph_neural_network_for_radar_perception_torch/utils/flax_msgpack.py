"""A decoder and an encoder for the msgpack files that flax's
``serialization.to_bytes`` writes, in the standard library and numpy alone.

The JAX package saves parameters with ``utils/checkpoint.save_params_msgpack``
(flax ``serialization.to_bytes``) and reads them with ``from_bytes``.  This
module reads and writes the same bytes without JAX, flax or the ``msgpack``
package, for the subset flax writes:

* nil, bool, integers, floats, str, bin, arrays and maps (arrays decode to
  lists, maps to dicts);
* ext type 1, an ndarray: the msgpack triple (shape, dtype name, C-order
  bytes); ``bfloat16``, which numpy lacks, decodes by its raw bits into
  float32 (exact);
* ext type 2, a Python complex: the msgpack pair (real, imag);
* ext type 3, a numpy scalar: an ndarray of shape ();
* the dict form of an array flax split into chunks
  (``{"__msgpack_chunked_array__": True, "shape": {...}, "chunks": {...}}``,
  tuples written as dicts keyed "0", "1", ...).

``msgpack_restore(data)`` is flax's ``serialization.msgpack_restore``: the
nested dict of numpy arrays that ``utils/convert.state_dict_from_flax``
takes.  ``msgpack_serialize(tree)`` is its inverse, flax's
``serialization.msgpack_serialize`` as ``to_bytes`` calls it (in place):
the same bytes as flax for a tree of dicts (keys in the tree's order),
lists, Python scalars and numpy arrays, the msgpack package's shortest
encoding of each value, arrays above ``MAX_CHUNK_SIZE`` bytes split into
chunks as flax splits them.  (Called on its own, flax first copies the
tree with ``jax.tree_util``, which rebuilds every dict in sorted key
order; the params trees the JAX package saves have that order already.)
"""

from __future__ import annotations

import struct
from typing import Any, Tuple

import numpy as np

_EXT_NDARRAY, _EXT_COMPLEX, _EXT_NPSCALAR = 1, 2, 3
_CHUNKED = "__msgpack_chunked_array__"
MAX_CHUNK_SIZE = 2**30  # flax's: an array of more bytes is written in chunks


class MsgpackError(ValueError):
    """Bytes that are not msgpack of the subset flax writes."""


class _Reader:
    def __init__(self, data: bytes):
        self.data = memoryview(data)
        self.pos = 0

    def take(self, n: int) -> memoryview:
        end = self.pos + n
        if end > len(self.data):
            raise MsgpackError(f"truncated: {n} bytes wanted at offset {self.pos}")
        out = self.data[self.pos:end]
        self.pos = end
        return out

    def unpack(self, fmt: str):
        return struct.unpack(">" + fmt, self.take(struct.calcsize(fmt)))[0]

    def value(self) -> Any:
        b = self.unpack("B")
        if b <= 0x7F:
            return b
        if b >= 0xE0:
            return b - 0x100
        if 0x80 <= b <= 0x8F:
            return self.map(b & 0x0F)
        if 0x90 <= b <= 0x9F:
            return self.array(b & 0x0F)
        if 0xA0 <= b <= 0xBF:
            return self.str(b & 0x1F)
        if b in _FIXED:
            return _FIXED[b]
        if b in _NUMBERS:
            return self.unpack(_NUMBERS[b])
        if b in _SIZED:
            kind, fmt = _SIZED[b]
            n = self.unpack(fmt)
            if kind == "bin":
                return bytes(self.take(n))
            if kind == "str":
                return self.str(n)
            if kind == "array":
                return self.array(n)
            if kind == "map":
                return self.map(n)
            code = self.unpack("b")  # ext
            return _ext(code, bytes(self.take(n)))
        if b in _FIXEXT:
            code = self.unpack("b")
            return _ext(code, bytes(self.take(_FIXEXT[b])))
        raise MsgpackError(f"unsupported msgpack type byte 0x{b:02x} at offset {self.pos - 1}")

    def str(self, n: int) -> str:
        return str(self.take(n), "utf-8")

    def array(self, n: int) -> list:
        return [self.value() for _ in range(n)]

    def map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            key = self.value()
            out[key] = self.value()
        return out


_FIXED = {0xC0: None, 0xC2: False, 0xC3: True}
_NUMBERS = {0xCA: "f", 0xCB: "d", 0xCC: "B", 0xCD: "H", 0xCE: "I", 0xCF: "Q",
            0xD0: "b", 0xD1: "h", 0xD2: "i", 0xD3: "q"}
_SIZED = {0xC4: ("bin", "B"), 0xC5: ("bin", "H"), 0xC6: ("bin", "I"),
          0xC7: ("ext", "B"), 0xC8: ("ext", "H"), 0xC9: ("ext", "I"),
          0xD9: ("str", "B"), 0xDA: ("str", "H"), 0xDB: ("str", "I"),
          0xDC: ("array", "H"), 0xDD: ("array", "I"),
          0xDE: ("map", "H"), 0xDF: ("map", "I")}
_FIXEXT = {0xD4: 1, 0xD5: 2, 0xD6: 4, 0xD7: 8, 0xD8: 16}


def unpackb(data: bytes) -> Any:
    """One msgpack object from ``data`` (all of it), ext types decoded."""
    reader = _Reader(data)
    out = reader.value()
    if reader.pos != len(reader.data):
        raise MsgpackError(f"{len(reader.data) - reader.pos} bytes after the object")
    return out


def _ndarray(data: bytes) -> np.ndarray:
    """flax's ``_ndarray_from_bytes``: (shape, dtype name, C-order bytes)."""
    shape, name, buf = _triple(unpackb(data))
    if name == "bfloat16":
        bits = np.frombuffer(buf, dtype=np.uint16).astype(np.uint32) << 16
        flat = bits.view(np.float32)
    else:
        flat = np.frombuffer(buf, dtype=np.dtype(name)).copy()
    return flat.reshape(shape, order="C")


def _triple(obj) -> Tuple[tuple, str, bytes]:
    if not (isinstance(obj, list) and len(obj) == 3):
        raise MsgpackError("an ndarray ext is not a (shape, dtype, bytes) triple")
    shape, name, buf = obj
    if isinstance(name, bytes):
        name = name.decode()
    return tuple(int(s) for s in shape), name, buf


def _ext(code: int, data: bytes) -> Any:
    if code == _EXT_NDARRAY:
        return _ndarray(data)
    if code == _EXT_NPSCALAR:
        return _ndarray(data)[()]
    if code == _EXT_COMPLEX:
        real, imag = unpackb(data)
        return complex(real, imag)
    raise MsgpackError(f"unsupported msgpack ext type {code}")


def _dict_to_tuple(d: dict) -> tuple:
    return tuple(d[str(i)] for i in range(len(d)))


def _unchunk(tree: Any) -> Any:
    """Arrays flax split into chunks, joined again (flax ``_unchunk``)."""
    if not isinstance(tree, dict):
        return tree
    if _CHUNKED in tree:
        shape = _dict_to_tuple(tree["shape"])
        return np.concatenate(_dict_to_tuple(tree["chunks"])).reshape(shape)
    return {k: _unchunk(v) for k, v in tree.items()}


def msgpack_restore(data: bytes) -> Any:
    """flax ``serialization.msgpack_restore``: the tree that ``to_bytes``
    wrote, as nested dicts of numpy arrays."""
    return _unchunk(unpackb(data))


# ------------------------------------------------------------------ writing
def _header(out: list, n: int, fix: int, fix_max: int, wide: Tuple[int, int, int]) -> None:
    """A length header: the fix form below ``fix_max``, else the 8-, 16- or
    32-bit form (``wide[0]`` 0 where the type has no 8-bit form)."""
    if n < fix_max:
        out.append(struct.pack("B", fix + n))
    elif wide[0] and n <= 0xFF:
        out.append(struct.pack(">BB", wide[0], n))
    elif n <= 0xFFFF:
        out.append(struct.pack(">BH", wide[1], n))
    elif n <= 0xFFFFFFFF:
        out.append(struct.pack(">BI", wide[2], n))
    else:
        raise MsgpackError(f"a length of {n} does not fit msgpack")


def _pack_int(out: list, v: int) -> None:
    if 0 <= v < 0x80 or -0x20 <= v < 0:
        out.append(struct.pack("b" if v < 0 else "B", v))
        return
    for lo, hi, code, fmt in ((0, 0xFF, 0xCC, "B"), (-0x80, -1, 0xD0, "b"),
                              (0, 0xFFFF, 0xCD, "H"), (-0x8000, -1, 0xD1, "h"),
                              (0, 0xFFFFFFFF, 0xCE, "I"), (-0x80000000, -1, 0xD2, "i"),
                              (0, 0xFFFFFFFFFFFFFFFF, 0xCF, "Q"),
                              (-0x8000000000000000, -1, 0xD3, "q")):
        if lo <= v <= hi:
            out.append(struct.pack(">B" + fmt, code, v))
            return
    raise MsgpackError(f"integer {v} does not fit msgpack")


def _pack_ext(out: list, code: int, data: bytes) -> None:
    n = len(data)
    fixed = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
    if n in fixed:
        out.append(struct.pack("B", fixed[n]))
    else:
        _header(out, n, 0, 0, (0xC7, 0xC8, 0xC9))
    out.append(struct.pack("b", code))
    out.append(data)


def _ndarray_bytes(arr: np.ndarray) -> bytes:
    """flax's ``_ndarray_to_bytes``: the msgpack triple (shape, dtype name,
    C-order bytes)."""
    if arr.dtype.hasobject or arr.dtype.isalignedstruct:
        raise MsgpackError("object and structured dtypes are not written")
    return packb([list(arr.shape), arr.dtype.name, arr.tobytes("C")])


def _pack(out: list, v: Any) -> None:
    """One value, as msgpack's packer with ``strict_types=True`` and flax's
    ``default`` writes it: exact Python types by their msgpack type, numpy
    arrays and numpy scalars as ext types."""
    t = type(v)
    if v is None:
        out.append(b"\xc0")
    elif t is bool:
        out.append(b"\xc3" if v else b"\xc2")
    elif t is int:
        _pack_int(out, v)
    elif t is float:
        out.append(struct.pack(">Bd", 0xCB, v))
    elif t is str:
        data = v.encode("utf-8")
        _header(out, len(data), 0xA0, 0x20, (0xD9, 0xDA, 0xDB))
        out.append(data)
    elif t in (bytes, bytearray):
        _header(out, len(v), 0, 0, (0xC4, 0xC5, 0xC6))
        out.append(bytes(v))
    elif t in (list, tuple):
        _header(out, len(v), 0x90, 0x10, (0, 0xDC, 0xDD))
        for item in v:
            _pack(out, item)
    elif t is dict:
        _header(out, len(v), 0x80, 0x10, (0, 0xDE, 0xDF))
        for key, item in v.items():
            _pack(out, key)
            _pack(out, item)
    elif isinstance(v, np.ndarray):
        _pack_ext(out, _EXT_NDARRAY, _ndarray_bytes(v))
    elif isinstance(v, np.generic):
        _pack_ext(out, _EXT_NPSCALAR, _ndarray_bytes(np.asarray(v)))
    elif t is complex:
        _pack_ext(out, _EXT_COMPLEX, packb([v.real, v.imag]))
    else:
        raise MsgpackError(f"cannot write a {t.__name__}")


def packb(obj: Any) -> bytes:
    """``obj`` as msgpack bytes (the inverse of ``unpackb``)."""
    out: list = []
    _pack(out, obj)
    return b"".join(out)


def _chunk(arr: np.ndarray) -> dict:
    """flax's ``_chunk``: an array as its flat chunks of at most
    ``MAX_CHUNK_SIZE`` bytes, tuples written as dicts keyed "0", "1", ..."""
    size = max(1, int(MAX_CHUNK_SIZE / arr.dtype.itemsize))
    flat = arr.reshape(-1)
    chunks = [flat[i:i + size] for i in range(0, flat.size, size)]
    return {_CHUNKED: True,
            "shape": {str(i): d for i, d in enumerate(arr.shape)},
            "chunks": {str(i): c for i, c in enumerate(chunks)}}


def _chunked(tree: Any) -> Any:
    """The tree with every array above ``MAX_CHUNK_SIZE`` bytes in chunks
    (flax ``_chunk_array_leaves_in_place``, on a copy)."""
    if isinstance(tree, dict):
        return {k: _chunked(v) for k, v in tree.items()}
    if isinstance(tree, np.ndarray) and tree.size * tree.dtype.itemsize > MAX_CHUNK_SIZE:
        return _chunk(tree)
    return tree


def msgpack_serialize(tree: Any) -> bytes:
    """flax ``serialization.msgpack_serialize``: the bytes ``to_bytes``
    writes for ``tree`` (nested dicts of numpy arrays, as
    ``msgpack_restore`` gives them)."""
    return packb(_chunked(tree))
