"""ctypes bindings for the port's native (C++) host data-plane library.

The JAX package's ``data/native.py`` over the port's own copy of its C++
source, ``csrc/graph_builder.cpp``: the graph builder (kNN + ball-query
degree + edge features), SE(2) ego compensation and stationary gating.  The
library is compiled on first use by ``ops/_build.build_host`` (``$CXX`` or
``g++``, the JAX Makefile's flags), so on one machine it computes the JAX
package's native bits.  Unlike the JAX package, which falls back to numpy
without a word when its build fails, a failed build raises with the
compiler's output: no path quietly uses numpy instead.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import numpy as np

from ..ops import _build


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    """Build (if needed) and load the library; raises if the build fails."""
    lib = ctypes.CDLL(str(_build.build_host("graph_builder")))
    c_int = ctypes.c_int
    c_float_p = np.ctypeslib.ndpointer(np.float32, flags="C")
    c_double_p = np.ctypeslib.ndpointer(np.float64, flags="C")
    c_int_p = np.ctypeslib.ndpointer(np.int32, flags="C")
    c_u8_p = np.ctypeslib.ndpointer(np.uint8, flags="C")

    lib.radar_build_graph.restype = c_int
    lib.radar_build_graph.argtypes = [
        c_float_p, c_float_p, c_float_p, c_float_p, c_double_p,
        c_int, c_int, ctypes.c_float, c_int, c_int,
        c_int_p, c_int_p, c_int_p, c_int_p,
        ctypes.POINTER(c_int), c_float_p, c_float_p,
    ]
    lib.radar_ego_compensate.restype = None
    lib.radar_ego_compensate.argtypes = [
        c_float_p, c_float_p, c_int_p, c_int,
        c_double_p, c_double_p, c_double_p,
    ]
    lib.radar_gate_stationary.restype = None
    lib.radar_gate_stationary.argtypes = [
        c_float_p, c_float_p, c_int,
        ctypes.c_double, ctypes.c_double, ctypes.c_double,
        ctypes.c_double, ctypes.c_double, ctypes.c_double,
        c_u8_p,
    ]
    return lib


def available() -> bool:
    """Does the library build and load here?"""
    try:
        _lib()
    except (RuntimeError, OSError):
        return False
    return True


def build_graph_native(
    px, py, vx, vy, ts, *, k: int, eps_sq: float,
    e_cap: Optional[int] = None, eu_cap: Optional[int] = None,
):
    """Native twin of features.adjacency_info + edge_features_np.

    Returns dict(senders, receivers, und_senders, und_receivers, degree,
    edge_feat) in the numpy builder's order; raises ValueError when an edge
    list overflows its capacity."""
    lib = _lib()
    n = int(px.shape[0])
    if e_cap is None:
        e_cap = max(2 * (k + 1) * n, 64)
    if eu_cap is None:
        eu_cap = e_cap
    px = np.ascontiguousarray(px, np.float32)
    py = np.ascontiguousarray(py, np.float32)
    vx = np.ascontiguousarray(vx, np.float32)
    vy = np.ascontiguousarray(vy, np.float32)
    ts = np.ascontiguousarray(ts, np.float64)
    senders = np.empty(e_cap, np.int32)
    receivers = np.empty(e_cap, np.int32)
    und_s = np.empty(eu_cap, np.int32)
    und_r = np.empty(eu_cap, np.int32)
    degree = np.empty(n, np.float32)
    edge_feat = np.empty((e_cap, 7), np.float32)
    n_und = ctypes.c_int(0)
    n_edges = lib.radar_build_graph(
        px, py, vx, vy, ts, n, k, np.float32(eps_sq), e_cap, eu_cap,
        senders, receivers, und_s, und_r,
        ctypes.byref(n_und), degree, edge_feat.reshape(-1),
    )
    if n_edges < 0:
        raise ValueError("edge capacity overflow in native graph builder")
    return {
        "senders": senders[:n_edges],
        "receivers": receivers[:n_edges],
        "und_senders": und_s[: n_und.value],
        "und_receivers": und_r[: n_und.value],
        "degree": degree,
        "edge_feat": edge_feat[:n_edges],
    }


def ego_compensate_native(px_list, py_list, ego_x, ego_y, ego_yaw):
    """Native twin of se2.ego_compensate_window (positions only; velocities
    pass through, reference meas_sync.py:67-68)."""
    lib = _lib()
    lengths = [int(p.shape[0]) for p in px_list]
    offsets = np.zeros(len(lengths) + 1, np.int32)
    offsets[1:] = np.cumsum(lengths)
    px = np.ascontiguousarray(np.concatenate(px_list), np.float32)
    py = np.ascontiguousarray(np.concatenate(py_list), np.float32)
    lib.radar_ego_compensate(
        px, py, offsets, len(lengths),
        np.ascontiguousarray(ego_x, np.float64),
        np.ascontiguousarray(ego_y, np.float64),
        np.ascontiguousarray(ego_yaw, np.float64),
    )
    out_px = [px[offsets[i]:offsets[i + 1]] for i in range(len(lengths))]
    out_py = [py[offsets[i]:offsets[i + 1]] for i in range(len(lengths))]
    return out_px, out_py


def gate_stationary_native(azimuth, vr, tx, ty, theta, vx_odom, yawrate_odom,
                           gamma: float = 1.5):
    """Native twin of selection.identify_stationary_measurements (no
    RANSAC)."""
    lib = _lib()
    azimuth = np.ascontiguousarray(azimuth, np.float32)
    vr = np.ascontiguousarray(vr, np.float32)
    flag = np.empty(azimuth.shape[0], np.uint8)
    lib.radar_gate_stationary(
        azimuth, vr, azimuth.shape[0],
        float(tx), float(ty), float(theta),
        float(vx_odom), float(yawrate_odom), float(gamma), flag,
    )
    return flag.astype(bool)
