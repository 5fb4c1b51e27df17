"""Readings that set the limits of ``correct``: the program's on many
seeds, and on a few seeds the control's and each fault's.

    python3 benchmark/control.py --workload knn.train --seeds 11,12,13 \
        --controls 3 --faults 3 --seconds 2 --out chiprun_out/control_knn.train.jsonl

For each seed: one run of the cell (``harness.cell.run_cell``, a short
window) gives the program's numbers, and for a training cell where they
come from (``check.train_detail``).  For the first ``--controls`` seeds
also the reference put in the program's place in TF32 (the control: the
precision below the configuration's float32), and for the first
``--faults`` with half of each batch left out (the mean taken over the
rest).  One JSON line per seed.  Not run by the benchmark's runs.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

BENCH_DIR = Path(__file__).resolve().parent
sys.path[:0] = [str(BENCH_DIR), str(BENCH_DIR.parent)]


def stand_in_numbers(reference, cfg, mix, pool, seed, device, **kind) -> dict:
    """The check's readings with the ``reference`` module (``kind``:
    precision and graphs) in the program's place, against its float32
    readings."""
    from harness import check
    from harness.cell import reference_readings

    ref = reference_readings(reference, cfg, mix, pool, seed, device)
    other = reference_readings(reference, cfg, mix, pool, seed, device, **kind)
    if mix["kind"] == "train":
        return check.train_readings(other, ref)
    return check.eval_numbers(list(enumerate(other)), ref)


def main(argv=None, device="cuda", config_override=None, mix_override=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--controls", type=int, default=3)
    p.add_argument("--faults", type=int, default=3)
    p.add_argument("--seconds", type=float, default=2.0)
    p.add_argument("--out", required=True)
    args = p.parse_args(argv)

    import torch

    from harness import traffic
    from harness.cell import load_cell, run_cell

    bench = json.loads((BENCH_DIR.parent / "BENCHMARK.json").read_text())
    spec = load_cell(bench, args.workload)
    cfg = dict(spec["config"]["gnn_config"], **(config_override or {}))
    mix = dict(spec["mix"], **(mix_override or {}))
    reference = spec["modules"].reference
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    with open(args.out, "a") as f:
        for i, seed in enumerate(int(s) for s in args.seeds.split(",")):
            t = time.perf_counter()
            out = run_cell(args.workload, seed, args.seconds, False, t_start=t, device=device,
                           config_override=config_override, mix_override=mix_override,
                           detail=True)
            line = {"workload": args.workload, "seed": seed, "correct": out["correct"],
                    "program": {k: c["value"] for k, c in out["checks"].items()},
                    "detail": out.get("detail"), "metrics": out["metrics"],
                    "device": out["device"]}
            if i < max(args.controls, args.faults):
                pool, _ = traffic.make_pool(cfg, mix, seed)
            if i < args.controls:
                line["control_tf32"] = stand_in_numbers(
                    reference, cfg, mix, pool, seed, device, precision="tf32")
            if i < args.faults:
                half = list(range(mix["batch"] // 2))
                line["fault_half_batch"] = stand_in_numbers(
                    reference, cfg, mix, pool, seed, device, graphs=half)
            line["seconds"] = time.perf_counter() - t
            f.write(json.dumps(line) + "\n")
            f.flush()
            print(json.dumps(line), flush=True)
            if device == "cuda":
                torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
