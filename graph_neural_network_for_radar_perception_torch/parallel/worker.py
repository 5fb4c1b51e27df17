"""Multi-process training worker: one rank of a distributed run.

Launch one copy per device:

    python -m graph_neural_network_for_radar_perception_torch.parallel.worker \
        --coordinator localhost:12345 --num-processes 2 --process-id 0 \
        --steps 5 --global-batch 8

(or under torchrun, which sets ``RANK``/``WORLD_SIZE``/``MASTER_ADDR``).
Every rank executes the same program: start the process group, build the
('data', 'graph') grid, build its own rows of each global batch, and run
the grid's train step (``parallel/distributed.py``).  It prints one JSON
line: the JAX worker's ``param_l1``, metrics and ``ms_per_step``, and
whether the step was ``captured`` (under NCCL on the card: then
``--bench-iters`` times replays of its CUDA graph).

``--device`` is the card by default (it raises without one); ``--device
cpu`` runs the plain versions under gloo.  ``--backend`` defaults to
``nccl`` on the card; several ranks on one card need ``--backend gloo``.
``--graph-partition halo`` also sorts the frames spatially, with
``--n-graph 1`` too (the data-parallel step on the same sorted frames is
the reference a halo run is held to).

``--spec FILE --out DIR`` runs the modes of a spec instead of the
synthetic stream: a ``torch.save``d dict whose ``"modes"`` list holds, per
mode, ``name``, ``n_graph``, ``partition`` ("edge" | "halo"), ``cfg`` (a
``GNNConfig``; its ``mp_impl`` picks the round), ``weights`` (a state
dict), ``batch`` (a numpy ``GraphBatch``, spatially sorted for "halo") and
``steps``, and optionally ``loss_only`` (the grid's loss and metrics and
the collective calls of that forward, no update) and ``profile`` (two
more steps, rank 0's second under the profiler; on the card).  Each rank
saves ``DIR/rank{r}.pt``: per mode the records of ``run_steps`` (metrics
and params after each step, its ms, whether it was captured, its
collectives), the hand-written kernels' launches over the mode's steps,
the captured graph's replays and warm-up runs, and the backend.
``launch_spec`` runs one on this host.

``launch`` and ``launch_spec`` start a whole grid of workers on this host,
each with its own log, and fail if any rank fails or the grid outlasts its
time limit.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import tempfile
import time
from typing import List, Optional, Sequence

MODULE = "graph_neural_network_for_radar_perception_torch.parallel.worker"
REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
COLLECTIVE_TIMEOUT_S = 120.0  # how long a collective waits for the other ranks


def config_from_json(path: str):
    """A GNNConfig from a JSON object of its fields (lists become tuples)."""
    from ..config.config import GNNConfig

    with open(path) as f:
        fields = json.load(f)
    return GNNConfig(**{k: tuple(v) if isinstance(v, list) else v
                        for k, v in fields.items()})


def config_to_json(cfg, path: str) -> None:
    with open(path, "w") as f:
        json.dump({fl.name: getattr(cfg, fl.name) for fl in dataclasses.fields(cfg)}, f)


def rank_inputs(cfg, mesh, full, halo: Optional[int]) -> tuple:
    """This rank's step arguments from a global numpy batch: its rows (its
    own for the data-parallel step, its data row's otherwise), cut to its
    edge shard for the edge-sharded step, or with ``halo`` (the halo step)
    followed by its member's HaloShards of those rows."""
    from .distributed import globalize_batch, process_local_batch_slice
    from .halo import HaloShards, make_halo_batch, member_shards
    from .mesh import batch_rows

    sl = process_local_batch_slice(full.batch_size, mesh,
                                   rows="all" if mesh.n_graph == 1 else "data")
    per = sl.stop - sl.start
    local = batch_rows(full, full.batch_size // per, sl.start // per)
    batch = globalize_batch(mesh, local, edges=mesh.n_graph > 1 and halo is None)
    if halo is None:
        return (batch,)
    shards = member_shards(make_halo_batch(local, cfg, mesh.n_graph, halo), mesh.graph_index)
    return batch, HaloShards.from_numpy(shards, mesh.device)


def _sync(device) -> None:
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _collectives_since(before) -> tuple:
    """The collective calls over all kinds since ``before`` (a
    ``collectives.counts()``), and each kind's calls and bytes."""
    from . import collectives as P

    d = [a - b for a, b in zip(P.counts(), before)]
    return d[0], {k: {"calls": d[1 + 2 * i], "bytes": d[2 + 2 * i]}
                  for i, k in enumerate(P.KINDS)}


def run_steps(step, state, inputs, device):
    """One step per argument tuple of ``inputs``: the state after them and,
    per step, its metrics, the params after it, its ms (the device
    synchronised before and after), whether it was a replay of a captured
    CUDA graph (``captured``; the first such step also captures), the
    host's launches (a replay is one; None for an eager step, whose
    launches only a profile counts), the eager warm-up runs of a capture
    in it (``warmups``: their collectives and kernels count in the step's
    too), its collective calls over all kinds (``all_reduces``), each
    kind's calls and bytes (``collectives``), and the host ms spent in the
    collectives (None for a replay: it spends none in any one)."""
    from . import collectives as P

    records = []
    for args in inputs:
        _sync(device)
        before, seconds = P.counts(), P.STATS["seconds"]
        replays, warmups = step.captured.replays, step.captured.warmups
        t0 = time.perf_counter()
        state, m = step(state, *args)
        _sync(device)
        ms = (time.perf_counter() - t0) * 1e3
        calls, kinds = _collectives_since(before)
        captured = step.captured.replays > replays
        records.append({
            "metrics": {k: float(v) for k, v in m.items()},
            "ms": ms,
            "captured": captured,
            "host_launches": step.captured.replays - replays if captured else None,
            "warmups": step.captured.warmups - warmups,
            "all_reduces": calls,
            "collectives": kinds,
            "all_reduce_ms": None if captured else (P.STATS["seconds"] - seconds) * 1e3,
            "params": {k: v.detach().cpu().clone()
                       for k, v in state.model.state_dict().items()},
        })
    return state, records


def _launch_counters():
    from ..ops import csr_mp, fused_mp

    return {"fused_mp_forward": fused_mp.fused_message_pass,
            "fused_mp_backward": fused_mp.fused_message_pass_backward,
            "csr_mp_forward": csr_mp.fused_message_pass_csr,
            "csr_mp_backward": csr_mp.fused_message_pass_csr_backward}


def run_spec(spec: dict, device, out_dir: str) -> None:
    """The modes of a spec (module docstring), each from its own weights,
    every rank saving its results to ``out_dir/rank{r}.pt``."""
    import torch
    import torch.distributed as dist

    from ..train.steps import create_train_state
    from ..utils.timing import profile_run
    from . import collectives as P
    from .distributed import assert_same_across_processes, multihost_train_setup
    from .halo import halo_width

    results, rank = {}, None
    for mode in spec["modes"]:
        cfg, n_graph, full = mode["cfg"], mode["n_graph"], mode["batch"]
        halo = (halo_width(full, n_graph)
                if mode.get("partition") == "halo" and n_graph > 1 else None)
        mesh, step = multihost_train_setup(cfg, n_graph, mode.get("partition", "edge"),
                                           halo or 16, device)
        rank = mesh.rank
        state = create_train_state(cfg, device=mesh.device)
        state.model.load_state_dict(mode["weights"])
        inputs = rank_inputs(cfg, mesh, full, halo)
        if mode.get("loss_only"):
            before = P.counts()
            _, metrics, _ = step.loss(state.model, *inputs)
            calls, kinds = _collectives_since(before)
            results[mode["name"]] = {"metrics": {k: float(v) for k, v in metrics.items()},
                                     "all_reduces": calls, "collectives": kinds}
            continue
        counters = _launch_counters()
        for fn in counters.values():
            fn.launches = 0
        state, records = run_steps(step, state, [inputs] * mode["steps"], mesh.device)
        launches = {k: fn.launches for k, fn in counters.items()}
        assert_same_across_processes(state.model.parameters(), mode["name"])
        profile = None
        if mode.get("profile"):  # every rank steps alike: the collectives pair up
            if rank == 0:
                profile = profile_run(lambda: step(state, *inputs))
            else:
                for _ in range(2):
                    step(state, *inputs)
        results[mode["name"]] = {"records": records, "launches": launches, "profile": profile,
                                 "replays": step.captured.replays,
                                 "warmups": step.captured.warmups,
                                 "backend": dist.get_backend()}
    torch.save(results, os.path.join(out_dir, f"rank{rank}.pt"))


def main(argv: Optional[Sequence[str]] = None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--coordinator", default=None, help="host:port of rank 0")
    ap.add_argument("--num-processes", type=int, default=None)
    ap.add_argument("--process-id", type=int, default=None)
    ap.add_argument("--store", default=None,
                    help="path of a FileStore for the rendezvous (instead of "
                         "a coordinator)")
    ap.add_argument("--steps", type=int, default=5)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--n-graph", type=int, default=1)
    ap.add_argument("--graph-partition", default="edge", choices=["edge", "halo"],
                    help="n_graph>1 partitioning mode: all-reduce-per-round "
                         "edge sharding or owner-computes halo exchange")
    ap.add_argument("--config", default=None,
                    help="GNNConfig as a JSON file (default: tiny_test_config)")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--backend", default=None, choices=[None, "nccl", "gloo"])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--bench-iters", type=int, default=0,
                    help="after training, time this many steps on a fixed "
                         "batch and report ms_per_step")
    ap.add_argument("--spec", default=None,
                    help="run the modes of this spec file instead of the "
                         "synthetic stream (module docstring)")
    ap.add_argument("--out", default=None,
                    help="file for final metrics JSON (rank 0 only); with "
                         "--spec the directory of every rank's results")
    args = ap.parse_args(argv)

    import numpy as np
    import torch
    import torch.distributed as dist

    from ..config.config import tiny_test_config
    from ..data.pipeline import SyntheticRadarDataset
    from .distributed import (
        assert_same_across_processes, init_distributed, multihost_train_setup,
        replicated_create_state,
    )
    from .halo import halo_width

    device = init_distributed(args.coordinator, args.num_processes, args.process_id,
                              device=args.device, backend=args.backend,
                              store=args.store, timeout_s=COLLECTIVE_TIMEOUT_S)
    if args.spec:
        run_spec(torch.load(args.spec, weights_only=False), device, args.out)
        dist.destroy_process_group()
        return {}
    sorted_frames = args.graph_partition == "halo"
    if args.config:
        cfg = dataclasses.replace(config_from_json(args.config),
                                  batch_size=args.global_batch,
                                  spatial_sort=sorted_frames)
    else:
        cfg = tiny_test_config(batch_size=args.global_batch, spatial_sort=sorted_frames)
    # Deterministic synthetic stream: every rank sees the same global
    # batches; pregenerate them so the halo width can be sized to the worst
    # frame of the run identically everywhere.
    ds = SyntheticRadarDataset(cfg, seed=args.seed, num_objects=2)
    fulls = [next(ds.batches(args.global_batch)) for _ in range(args.steps)]
    halo = (max(halo_width(f, args.n_graph) for f in fulls)
            if sorted_frames and args.n_graph > 1 else None)

    mesh, step = multihost_train_setup(cfg, n_graph=args.n_graph,
                                       graph_partition=args.graph_partition,
                                       halo=halo or 16, device=device)
    state = replicated_create_state(cfg, mesh, seed=cfg.seed)
    assert_same_across_processes(state.model.parameters(), "initial params")

    # Per-process feeding: each rank builds exactly its rows of the global
    # batch (and, halo, the owner-assigned edges of those rows).
    inputs = [rank_inputs(cfg, mesh, full, halo) for full in fulls]
    state, records = run_steps(step, state, inputs, mesh.device)
    metrics = records[-1]["metrics"] if records else None

    ms_per_step = None
    if args.bench_iters:
        _sync(mesh.device)
        t0 = time.perf_counter()
        for _ in range(args.bench_iters):
            state, m = step(state, *inputs[-1])
        _sync(mesh.device)
        ms_per_step = (time.perf_counter() - t0) / args.bench_iters * 1e3
        metrics = {k: float(v) for k, v in m.items()}

    assert_same_across_processes(state.model.parameters(), "final params")
    result = {
        "process_index": mesh.rank,
        "process_count": mesh.size,
        "devices": mesh.size,
        "device": str(device) if device.type == "cpu"
        else torch.cuda.get_device_name(device),
        "backend": dist.get_backend(),
        "captured": records[-1]["captured"] if records else None,
        "metrics": metrics,
        "param_l1": float(sum(np.abs(p.detach().cpu().numpy().astype(np.float64)).sum()
                              for p in state.model.parameters())),
        "ms_per_step": ms_per_step,
        "global_batch": args.global_batch,
    }
    print(json.dumps(result), flush=True)
    if args.out and mesh.rank == 0:
        with open(args.out, "w") as f:
            json.dump(result, f)
    dist.destroy_process_group()
    return result


def run_processes(commands: Sequence[Sequence[str]], *, timeout: float,
                  env: Optional[dict] = None) -> List[str]:
    """Start every command at once (one per rank; ``PYTHONPATH`` gains this
    repository) and return each one's standard output.  Raises with every
    log if any command fails, killing the others, or if they are not all
    done within ``timeout`` seconds."""
    env = dict(os.environ if env is None else env)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    with tempfile.TemporaryDirectory() as td:
        logs = [(open(os.path.join(td, f"{r}.out"), "w+"),
                 open(os.path.join(td, f"{r}.err"), "w+")) for r in range(len(commands))]
        try:
            procs = [subprocess.Popen(list(cmd), env=env, cwd=REPO, stdout=out, stderr=err)
                     for cmd, (out, err) in zip(commands, logs)]
            try:
                deadline = time.monotonic() + timeout
                while (any(p.poll() is None for p in procs)
                       and not any(p.returncode for p in procs)
                       and time.monotonic() < deadline):
                    time.sleep(0.05)
            finally:
                for p in procs:
                    if p.poll() is None:
                        p.kill()
                    p.wait()
            texts = []
            for out, err in logs:
                out.seek(0), err.seek(0)
                texts.append((out.read(), err.read()))
        finally:
            for out, err in logs:
                out.close(), err.close()
    failed = [r for r, p in enumerate(procs) if p.returncode]
    if failed:
        raise RuntimeError("ranks %s failed or timed out:\n%s" % (failed, "\n".join(
            f"--- rank {r} (exit {procs[r].returncode})\n{o}\n{e}"
            for r, (o, e) in enumerate(texts))))
    return [o for o, _ in texts]


def _run_grid(argv: Sequence[str], num_processes: int, td: str, timeout: float,
              env: Optional[dict]) -> List[str]:
    return run_processes(
        [[sys.executable, "-m", MODULE, *argv, "--store", os.path.join(td, "store"),
          "--num-processes", str(num_processes), "--process-id", str(r)]
         for r in range(num_processes)], timeout=timeout, env=env)


def launch(argv: Sequence[str], num_processes: int, *, timeout: float = 600.0,
           env: Optional[dict] = None) -> List[dict]:
    """Run ``num_processes`` workers with ``argv`` on this host (a FileStore
    rendezvous in a temporary directory) and return each rank's JSON
    result, in rank order (``run_processes``)."""
    with tempfile.TemporaryDirectory() as td:
        outs = _run_grid(argv, num_processes, td, timeout, env)
    return [json.loads(o.strip().splitlines()[-1]) for o in outs]


def launch_spec(spec: dict, num_processes: int, *, device: str = "cuda",
                backend: Optional[str] = None, timeout: float = 600.0,
                env: Optional[dict] = None) -> List[dict]:
    """Run the spec's modes (module docstring) on ``num_processes`` workers
    on this host and return each rank's results, in rank order."""
    import torch

    with tempfile.TemporaryDirectory() as td:
        path = os.path.join(td, "spec.pt")
        torch.save(spec, path)
        argv = ["--spec", path, "--out", td, "--device", device]
        _run_grid(argv + (["--backend", backend] if backend else []),
                  num_processes, td, timeout, env)
        return [torch.load(os.path.join(td, f"rank{r}.pt"), weights_only=False)
                for r in range(num_processes)]


if __name__ == "__main__":
    main()
