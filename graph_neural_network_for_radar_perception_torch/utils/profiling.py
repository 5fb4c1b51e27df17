"""Profiling and tracing utilities.

The JAX package's ``utils/profiling.py``: a trace capture around a block
(``torch.profiler``, a Chrome trace in place of ``jax.profiler``'s), a
per-step wall-clock timer with percentile summaries, a units/s throughput
meter, the analytic FLOP count of one train step and the model FLOPs
utilisation against the card's dense bf16 peak (``utils/timing``).  The
device's busy share and kernel count of one call are
``utils/timing.profile_run``.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from .timing import PEAK_BF16_FLOPS, PEAK_F32_FLOPS


@contextlib.contextmanager
def trace(log_dir: str):
    """Capture a ``torch.profiler`` trace of the host and, where there is
    one, the card around a code block; it is written to
    ``log_dir/trace.json`` (Chrome trace format, viewable in Perfetto)."""
    from torch.profiler import ProfilerActivity, profile

    os.makedirs(log_dir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield log_dir
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


class StepTimer:
    """Wall-clock step timing with percentile summaries.

    Use `with timer.step():` around each iteration; the device sync is the
    caller's responsibility (time dispatch only, or synchronise first)."""

    def __init__(self, max_records: int = 10_000):
        self._times: List[float] = []
        self._max = max_records

    @contextlib.contextmanager
    def step(self):
        t0 = time.perf_counter()
        yield
        if len(self._times) < self._max:
            self._times.append(time.perf_counter() - t0)

    def summary(self) -> Dict[str, float]:
        if not self._times:
            return {}
        arr = np.asarray(self._times)
        return {
            "steps": int(arr.size),
            "mean_ms": float(arr.mean() * 1e3),
            "p50_ms": float(np.percentile(arr, 50) * 1e3),
            "p90_ms": float(np.percentile(arr, 90) * 1e3),
            "p99_ms": float(np.percentile(arr, 99) * 1e3),
        }

    def reset(self):
        self._times.clear()


class ThroughputMeter:
    """Edges/s (or any unit/s) over a sliding window."""

    def __init__(self, units_per_step: float):
        self.units_per_step = units_per_step
        self._t0: Optional[float] = None
        self._steps = 0

    def start(self):
        self._t0 = time.perf_counter()
        self._steps = 0

    def tick(self, n: int = 1):
        self._steps += n

    def rate(self) -> float:
        if self._t0 is None or self._steps == 0:
            return 0.0
        dt = time.perf_counter() - self._t0
        return self._steps * self.units_per_step / max(dt, 1e-9)


def flops_per_train_step(cfg, batch_size: int) -> float:
    """Analytic FLOP estimate of one fwd+bwd train step of the flagship
    GNN (message MLPs dominate), for MFU-style reporting."""
    e = cfg.max_edges
    n = cfg.max_nodes
    d = cfg.graph_convolution_stem_channels[-1]
    h = cfg.msg_mlp_hidden_dim
    rounds = len(cfg.graph_convolution_stem_channels)
    msg = e * (3 * d * h + h * d) * 2           # msg MLP fwd MACs→FLOPs
    upd = n * (2 * d * d) * 2
    enc = n * sum(
        a * b * 2 for a, b in zip(
            (cfg.input_node_feat_dim,) + tuple(cfg.node_feat_enc_stem_channels[:-1]),
            cfg.node_feat_enc_stem_channels,
        )
    ) + e * sum(
        a * b * 2 for a, b in zip(
            (cfg.input_edge_feat_dim,) + tuple(cfg.edge_feat_enc_stem_channels[:-1]),
            cfg.edge_feat_enc_stem_channels,
        )
    )
    fwd = rounds * (msg + upd) + enc
    return 3.0 * fwd * batch_size  # bwd ≈ 2× fwd


# Dense bf16 matmul peak of a card by the name CUDA reports, as the JAX
# package keeps the TPU's (its MFU denominator), and its f32 peak outside
# the tensor cores.  Only the H100 SXM is known: the PCIe and NVL parts
# have other peaks.
_PEAK_FLOPS = {
    "NVIDIA H100 80GB HBM3": {"bf16": PEAK_BF16_FLOPS, "f32": PEAK_F32_FLOPS},
    "NVIDIA H100 SXM": {"bf16": PEAK_BF16_FLOPS, "f32": PEAK_F32_FLOPS},
}


def device_peak_flops(device=None, dtype: str = "bf16") -> Optional[float]:
    """Peak FLOP/s of the card (``device``: a CUDA device or its index,
    default the current one) for ``dtype`` ("bf16": dense, on the tensor
    cores; "f32": outside them), or None on the CPU or for a card whose
    peak is not known.  MFU = measured FLOP/s / this."""
    if device is not None and not isinstance(device, int) and torch.device(device).type != "cuda":
        return None
    if not torch.cuda.is_available():
        return None
    name = torch.cuda.get_device_name(device)
    for key, peaks in _PEAK_FLOPS.items():
        if name.startswith(key):
            return peaks[dtype]
    return None


def mfu(analytic_flops: float, seconds: float, device=None) -> Optional[float]:
    """Model FLOPs utilisation: analytic model FLOPs per wall-second over
    the card's bf16 peak.  None when the peak is unknown."""
    peak = device_peak_flops(device)
    if peak is None or seconds <= 0:
        return None
    return analytic_flops / seconds / peak
