"""Times the port's classifier, grid-CNN, eval, finetuning and grid steps
on one card, in a tree of the port given on the command line:

    python graph_neural_network_for_radar_perception_torch/scripts/step_timing.py \
        [--tree DIR] [--only classifier cnn eval finetune grid]

``--tree`` is the root of the checkout whose port is timed (default: the
one holding this file), so that two versions of the port can be timed in
turns with one copy of this script (parent, change, change, parent); it
uses only the step functions' signatures, which are the same in both.

* ``classifier``: ``make_classifier_train_step(ClassifierConfig())``, batch
  8 (the GT clusters of synthetic ``GNNConfig()`` frames, seed 17);
* ``cnn``: ``make_grid_train_step(CNNConfig())`` on the default ``GridSpec``
  (200 x 200 cells), batch 2, TF32 off;
* ``eval``: ``make_eval_step(GNNConfig())`` and with ``mp_impl="csr"``,
  one synthetic batch of 8 (numpy in, as the trainer passes it);
* ``finetune``: ``make_finetune_step(GNNConfig())``, batch 8;
* ``grid``: the data-parallel grid step on a 1 x 1 grid under NCCL, one
  rank of the tree's worker (``parallel/worker.launch_spec``) at
  ``GNNConfig()``, batch 8 (``chip_smoke.py``'s ``[parallel]`` batch and
  weights), beside ``make_train_step`` on the same batch in this process:
  the worker's own host ms a step (ended by a synchronise), its
  collective calls a step, and a profile of one more step on the rank.

Each at the shipped widths with seeded random weights.  A step's time is
the host clock around one call that ends in ``torch.cuda.synchronize()``,
median and range of ``--steps`` calls after ``--warmup`` (the first holds
a capture where the step is captured); then one more call under
``torch.profiler`` (``utils/timing.profile_run``): device kernels, host
launches, busy ms.  Prints one JSON line, the card's name and power limit
in it.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np


STEPS = ("classifier", "cnn", "eval", "finetune", "grid")


def _time(torch, fn, warmup: int, steps: int) -> dict:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    ms = []
    for _ in range(steps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
    return {"median_ms": float(np.median(ms)), "min_ms": min(ms), "max_ms": max(ms)}


def _profiled(profile_run, fn) -> dict:
    prof = profile_run(fn)
    return {"kernels": prof["device_kernels"], "host_launches": prof["host_launches"],
            "busy_ms": prof["device_busy_ms"]}


def _grid(torch, warmup: int, steps: int) -> dict:
    """The ``grid`` entry (module docstring)."""
    from graph_neural_network_for_radar_perception_torch.config.config import GNNConfig
    from graph_neural_network_for_radar_perception_torch.data.pipeline import (
        SyntheticRadarDataset,
    )
    from graph_neural_network_for_radar_perception_torch.models.gnn import RadarGNN
    from graph_neural_network_for_radar_perception_torch.parallel import worker as PW
    from graph_neural_network_for_radar_perception_torch.train import steps as S

    cfg = GNNConfig(batch_size=8)
    batch = next(SyntheticRadarDataset(cfg, seed=29, num_objects=(6, 10)).batches(8))
    weights = RadarGNN(cfg, generator=torch.Generator().manual_seed(5)).state_dict()
    env = dict(os.environ)
    env.setdefault("NCCL_SOCKET_IFNAME", "lo")  # one host: the bootstrap binds the loopback
    mode = {"name": "dp-1x1", "n_graph": 1, "partition": "edge", "steps": warmup + steps,
            "cfg": cfg, "weights": weights, "batch": batch, "profile": True}
    rank = PW.launch_spec({"modes": [mode]}, 1, device="cuda", backend="nccl",
                          timeout=600, env=env)[0]["dp-1x1"]
    records = rank["records"][warmup:]
    ms = [rec["ms"] for rec in records]
    prof = rank["profile"]
    state = S.create_train_state(cfg, device="cuda")
    state.model.load_state_dict(weights)
    single = S.make_train_step(cfg)
    fn = lambda: single(state, batch)  # noqa: E731
    return {"median_ms": float(np.median(ms)), "min_ms": min(ms), "max_ms": max(ms),
            "captured": records[-1].get("captured"),
            "collectives_a_step": [rec["all_reduces"] for rec in records],
            "kernels": prof["device_kernels"], "host_launches": prof["host_launches"],
            "busy_ms": prof["device_busy_ms"],
            "single_process": _time(torch, fn, warmup, steps)}


def main(argv=None) -> int:
    here = os.path.dirname(os.path.abspath(__file__))
    ap = argparse.ArgumentParser()
    ap.add_argument("--tree", default=os.path.dirname(os.path.dirname(here)))
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--warmup", type=int, default=2)
    ap.add_argument("--only", nargs="+", default=list(STEPS), choices=list(STEPS))
    args = ap.parse_args(argv)
    sys.path.insert(0, os.path.abspath(args.tree))

    import torch

    if not torch.cuda.is_available():
        print("step_timing: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from graph_neural_network_for_radar_perception_torch.config.config import GNNConfig
    from graph_neural_network_for_radar_perception_torch.data import features as F
    from graph_neural_network_for_radar_perception_torch.data import groundtruth as G
    from graph_neural_network_for_radar_perception_torch.data import grid as GR
    from graph_neural_network_for_radar_perception_torch.data.pipeline import (
        SyntheticRadarDataset,
    )
    from graph_neural_network_for_radar_perception_torch.data.synthetic import (
        make_synthetic_frame,
    )
    from graph_neural_network_for_radar_perception_torch.models import classifier as CL
    from graph_neural_network_for_radar_perception_torch.models import cnn as CNN
    from graph_neural_network_for_radar_perception_torch.models.gnn import RadarGNN
    from graph_neural_network_for_radar_perception_torch.train import steps as S
    from graph_neural_network_for_radar_perception_torch.train.finetune import (
        make_finetune_step,
    )
    from graph_neural_network_for_radar_perception_torch.utils.timing import profile_run

    import graph_neural_network_for_radar_perception_torch as port

    out = {"tree": os.path.dirname(os.path.dirname(os.path.abspath(port.__file__)))}
    seed = torch.Generator().manual_seed

    # classifier
    if "classifier" in args.only:
        ccfg = CL.ClassifierConfig()
        ds = SyntheticRadarDataset(GNNConfig(), seed=17, num_objects=(6, 12))
        samples = []
        while len(samples) < 8:
            fr = ds.sample_frame()
            s = CL.build_classifier_sample(fr.other_feat[:, :2], fr.node_feat[:, 1],
                                           fr.node_class, fr.node2cluster,
                                           int(fr.cluster_class.shape[0]), ccfg)
            if s is not None:
                samples.append(s)
        batch = CL.stack_samples(samples)
        init, step, _ = CL.make_classifier_train_step(ccfg)
        state = init(seed(0), device="cuda")
        fn = lambda: step(state, batch)  # noqa: E731
        out["classifier"] = dict(_time(torch, fn, args.warmup, args.steps),
                                 **_profiled(profile_run, fn))

    # grid CNN
    if "cnn" in args.only:
        cfg, spec = GNNConfig(), GR.GridSpec()
        rng = np.random.default_rng(1)
        grids = []
        for _ in range(2):
            data = make_synthetic_frame(rng, num_objects=int(rng.integers(8, 13)),
                                        window_size=cfg.temporal_window_size)
            gt = G.compute_ground_truth_node(data)
            data, gt = F.select_within_roi(data, gt, cfg.min_x, cfg.max_x, cfg.min_y, cfg.max_y)
            grids.append(GR.build_grid_sample(spec, data, gt, 1024, device="cuda"))
        arrays = tuple(np.stack([g[k] for g in grids]) for k in
                       ("image", "vr", "rcs", "label_grid", "offset_grid"))
        init, step, _ = CNN.make_grid_train_step(CNN.CNNConfig())
        state = init(seed(0), device="cuda")
        fn = lambda: step(state, *arrays)  # noqa: E731
        out["cnn"] = dict(_time(torch, fn, args.warmup, max(args.steps // 2, 1)),
                          **_profiled(profile_run, fn))

    # eval step, each message pass
    if "eval" in args.only:
        out["eval"] = {}
        for name, c in (("fused", GNNConfig()), ("csr", GNNConfig(mp_impl="csr"))):
            state = S.create_train_state(c, seed(0), device="cuda")
            vb = next(SyntheticRadarDataset(c, seed=19, num_objects=(6, 10))
                      .batches(c.batch_size))
            ev = S.make_eval_step(c)
            fn = lambda: ev(state.model, vb)  # noqa: E731
            out["eval"][name] = dict(_time(torch, fn, args.warmup, args.steps * 2),
                                     **_profiled(profile_run, fn))

    # finetuning
    if "finetune" in args.only:
        cfg = GNNConfig()
        fb = next(SyntheticRadarDataset(cfg, seed=13, num_objects=(6, 10))
                  .batches(cfg.batch_size))
        model = RadarGNN(cfg, generator=seed(0)).to("cuda")
        step, opt = make_finetune_step(cfg)[0](model)
        state = S.TrainState(model, opt)
        fn = lambda: step(state, fb)  # noqa: E731
        out["finetune"] = dict(_time(torch, fn, args.warmup, args.steps),
                               **_profiled(profile_run, fn))

    if "grid" in args.only:
        out["grid"] = _grid(torch, args.warmup, args.steps)

    out["card"] = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
