"""Batch-size sweep of root ``bench.py``'s ``train_b8`` config on one card,
as root ``scripts/sweep_batch.py`` sweeps it on the TPU:

    python -m graph_neural_network_for_radar_perception_torch.scripts.sweep_batch
    python -m graph_neural_network_for_radar_perception_torch.scripts.sweep_batch \\
        --one 8 [--device cpu] [--config FILE] [--k1 20 --k2 80]

Each batch size (8, 16 and 32) runs in a fresh subprocess
(``--one B``) on the card unless ``--device cpu`` asks for the plain
versions.  A size's batch is ``scripts/bench.host_batch(cfg, B,
num_objects=(2, 12))``, root ``bench.py``'s ``_host_batch`` of the same
arguments, placed on the device once.  Its time is the slope
``(t_K2 - t_K1) / (K2 - K1)`` of ``make_train_scan(cfg, K)`` runs (one
captured step replayed K times on the card, eager steps on the CPU) from
the same state, each ended by a synchronise, best of 2 after one untimed
run, which holds the step's capture: the slope leaves out what a run
costs once.  ``--config`` is a JSON object of ``GNNConfig`` fields
(``parallel/worker.config_to_json``; default ``train_b8_config()``).

Prints one JSON line per batch with the root script's keys (``batch``,
``ms_per_step``, ``valid_eps`` and ``cap_eps``: live and padded edge
messages a second over every round, ``occupancy``, ``analytic_tflops``
from ``utils/profiling.flops_per_train_step``) and ``mfu``:
``analytic_tflops`` over the card's f32 peak (null on the CPU, where no
device metric is measured).  The sweep prints a summary of each size on
stderr; a size that fails prints its exit code there, the sweep goes on
and exits 1 at the end.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from typing import Optional, Sequence

BATCHES = (8, 16, 32)
SIZE_TIMEOUT_S = 2400  # what one size may take, its process's start-up included
MODULE = "graph_neural_network_for_radar_perception_torch.scripts.sweep_batch"
REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def measure(batch_size: int, device: str = "cuda", config: Optional[str] = None,
            k1: int = 20, k2: int = 80) -> dict:
    """One batch size's row (module docstring)."""
    import torch

    from ..core.graph import resolve_device
    from ..parallel.worker import config_from_json
    from ..train import steps as S
    from ..utils.profiling import device_peak_flops, flops_per_train_step
    from .bench import host_batch, train_b8_config

    device = resolve_device(device)
    cfg = config_from_json(config) if config else train_b8_config()
    host = host_batch(cfg, batch_size, num_objects=(2, 12))
    rounds = len(cfg.graph_convolution_stem_channels)
    cap_edges = batch_size * cfg.max_edges * rounds
    valid_edges = float(host.graph.edge_mask.sum()) * rounds
    batch = S.batch_on(host, device)

    def sync(metrics):
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        float(metrics["loss_total"])

    times = {}
    for k in (k1, k2):
        run = S.make_train_scan(cfg, k)
        state = S.create_train_state(cfg, torch.Generator().manual_seed(0), device=device)
        state, m = run(state, batch)  # the capture
        sync(m)
        best = float("inf")
        for _ in range(2):
            t0 = time.perf_counter()
            state, m = run(state, batch)
            sync(m)
            best = min(best, time.perf_counter() - t0)
        times[k] = best
    dt = (times[k2] - times[k1]) / (k2 - k1)
    tflops = flops_per_train_step(cfg, batch_size) / dt / 1e12
    peak = device_peak_flops(device, dtype="f32")
    return {
        "batch": batch_size,
        "ms_per_step": dt * 1e3,
        "valid_eps": valid_edges / dt,
        "cap_eps": cap_edges / dt,
        "occupancy": valid_edges / cap_edges,
        "analytic_tflops": tflops,
        "mfu": tflops * 1e12 / peak if peak else None,
    }


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--one", type=int, default=None, help="measure this batch size here")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--config", default=None, help="GNNConfig fields as a JSON file")
    ap.add_argument("--k1", type=int, default=20)
    ap.add_argument("--k2", type=int, default=80)
    args = ap.parse_args(argv)
    if args.one is not None:
        print(json.dumps(measure(args.one, args.device, args.config, args.k1, args.k2)),
              flush=True)
        return 0
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    failed = []
    for b in BATCHES:
        cmd = [sys.executable, "-m", MODULE, "--one", str(b), "--device", args.device,
               "--k1", str(args.k1), "--k2", str(args.k2)]
        try:
            r = subprocess.run(cmd + (["--config", args.config] if args.config else []),
                               capture_output=True, text=True, timeout=SIZE_TIMEOUT_S, env=env)
            rc, out, err = r.returncode, r.stdout.strip(), r.stderr.strip()
        except subprocess.TimeoutExpired as e:
            rc, out, err = f"timeout after {e.timeout} s", "", str(e.stderr or "")
        line = out.splitlines()[-1] if out else ""
        if rc != 0 or not line:
            failed.append(b)
            print(f"B={b}: FAILED rc={rc} {err.splitlines()[-3:]}", file=sys.stderr, flush=True)
            continue
        d = json.loads(line)
        mfu = "n/a" if d["mfu"] is None else f"{d['mfu']:.1%}"
        print(f"B={b}: {d['ms_per_step']:.2f} ms/step  valid {d['valid_eps']:.3e}/s  "
              f"cap {d['cap_eps']:.3e}/s  occ {d['occupancy']:.1%}  "
              f"{d['analytic_tflops']:.2f} TF/s  mfu (f32) {mfu}", file=sys.stderr, flush=True)
        print(line, flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
