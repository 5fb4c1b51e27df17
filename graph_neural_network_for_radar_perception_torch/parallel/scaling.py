"""Scaling measurement harness: edges/s and graphs/s against the grid's size.

The JAX package's ``parallel/scaling.py`` over grids of processes: every
shape runs as its own grid of workers (``parallel/worker.py``, launched on
this host), which build their batches from the synthetic stream.  With
every rank on one card (the only layout one card allows: ranks under
gloo, its collectives staged through the host) this measures
orchestration, not scaling; on the CPU it validates orchestration only.
Under NCCL (one rank a card) the grid step is a captured CUDA graph, and
the timed steps are its replays.  Each row records the device, the
backend that produced it and whether the step was captured.
"""

from __future__ import annotations

import os
import tempfile
from typing import Dict, List, Optional, Sequence, Tuple

from ..config.config import GNNConfig
from .worker import config_to_json, launch


def _grid(argv: List[str], n_proc: int, device: str, backend: Optional[str],
          timeout: float) -> dict:
    argv = argv + ["--device", device] + (["--backend", backend] if backend else [])
    return launch(argv, n_proc, timeout=timeout)[0]


def measure_scaling(
    cfg: GNNConfig,
    mesh_shapes: Sequence[Tuple[int, int]],
    *,
    batch_per_device: int = 2,
    iters: int = 10,
    graph_partition: str = "psum",  # "psum" | "halo"
    device: str = "cuda",
    backend: Optional[str] = None,
    timeout: float = 600.0,
) -> List[Dict]:
    """Weak-scaling sweep: batch grows with the data axis so per-device
    work is constant; efficiency = throughput_n / (n · throughput_1), the
    first shape giving the per-device baseline.

    mesh_shapes: (n_data, n_graph) pairs.  graph_partition picks the
    edge-partitioning design for n_graph > 1: the all-reduce-per-round
    shard (parallel/sharded.py) or owner-computes halo exchange
    (parallel/halo.py, frames spatially sorted on the host).  ``device``:
    the card unless ``"cpu"``."""
    rounds = len(cfg.graph_convolution_stem_channels)
    results: List[Dict] = []
    base_eps: Optional[float] = None
    with tempfile.TemporaryDirectory() as td:
        path = os.path.join(td, "config.json")
        config_to_json(cfg, path)
        for n_data, n_graph in mesh_shapes:
            n_dev = n_data * n_graph
            batch = batch_per_device * n_data
            res = _grid(["--config", path, "--steps", "1", "--bench-iters", str(iters),
                         "--global-batch", str(batch), "--n-graph", str(n_graph),
                         "--graph-partition", "halo" if graph_partition == "halo" else "edge"],
                        n_dev, device, backend, timeout)
            eps = batch * cfg.max_edges * rounds / (res["ms_per_step"] / 1e3)
            if base_eps is None:
                base_eps = eps / n_dev  # per-device baseline
            results.append({
                "mesh": (n_data, n_graph),
                "devices": n_dev,
                "ms_per_step": res["ms_per_step"],
                "edge_msgs_per_s": eps,
                "efficiency": eps / (base_eps * n_dev),
                "backend": res["backend"],
                "captured": res["captured"],
                "device": res["device"],
            })
    return results


def measure_process_scaling(
    process_counts: Sequence[int] = (1, 2),
    *,
    batch_per_process: int = 4,
    bench_iters: int = 5,
    n_graph: int = 1,
    device: str = "cuda",
    backend: Optional[str] = None,
    timeout: float = 600.0,
) -> List[Dict]:
    """Weak-scaling sweep over PROCESS counts at the worker's
    tiny_test_config: ms/step of the same grid step with
    ``batch_per_process`` graphs a process.  Efficiency =
    throughput_n / (n · throughput_1)."""
    results: List[Dict] = []
    base: Optional[float] = None
    for n_proc in process_counts:
        global_batch = batch_per_process * n_proc
        res = _grid(["--steps", "1", "--bench-iters", str(bench_iters),
                     "--global-batch", str(global_batch), "--n-graph", str(n_graph)],
                    n_proc, device, backend, timeout)
        thr = global_batch / (res["ms_per_step"] / 1e3)  # graphs/s
        if base is None:
            base = thr / n_proc
        results.append({
            "processes": n_proc,
            "devices": n_proc,
            "ms_per_step": res["ms_per_step"],
            "graphs_per_s": thr,
            "efficiency": thr / (base * n_proc),
            "backend": res["backend"],
            "captured": res["captured"],
            "device": res["device"],
        })
    return results
