"""A decoder for the msgpack files that flax's ``serialization.to_bytes``
writes, in the standard library and numpy alone.

The JAX package saves parameters with ``utils/checkpoint.save_params_msgpack``
(flax ``serialization.to_bytes``) and reads them with ``from_bytes``.  This
module reads the same bytes without JAX, flax or the ``msgpack`` package,
for the subset flax writes:

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
takes.
"""

from __future__ import annotations

import struct
from typing import Any, Tuple

import numpy as np

_EXT_NDARRAY, _EXT_COMPLEX, _EXT_NPSCALAR = 1, 2, 3
_CHUNKED = "__msgpack_chunked_array__"


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
