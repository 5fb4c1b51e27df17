"""The benchmark of the PyTorch port: one run of one cell.

    python3 benchmark/run.py --workload knn.train --seed 7 --seconds 20 --trace 0

Run from the root of a checkout on a machine with an NVIDIA card.  Prints
as its last line of standard output one JSON object (``correct``,
``attempted``, ``failed``, ``metrics``, ``device``, with ``--trace 1`` a
``breakdown``, and last ``checks``: each number compared with its limit,
also the last lines of standard error).  ``--trace 0`` reports the cell's
end-to-end metrics, ``--trace 1`` its per-layer metrics.  Exits non-zero
without a result when there is no card, when the program is missing, or
when JAX or the JAX package was loaded.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

BENCH_DIR = Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "graph_neural_network_for_radar_perception_tpu")


def forbidden_modules():
    """Top-level names of loaded modules that the port must not load."""
    return sorted({name.split(".")[0] for name in list(sys.modules)} & set(FORBIDDEN))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    # Caches of compiled code stay inside the checkout, at fixed paths.
    cache = ROOT / "build" / "bench_cache"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    sys.path[:0] = [str(BENCH_DIR), str(ROOT)]

    import torch

    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    chips = {w["name"]: w["chips"] for w in bench["workloads"]}.get(args.workload)
    if chips is None:
        print(f"no workload {args.workload!r} in BENCHMARK.json", file=sys.stderr)
        return 2
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"{args.workload} needs {chips} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2

    from harness.cell import run_cell

    out = run_cell(args.workload, args.seed, args.seconds, bool(args.trace),
                   t_start=T_START, device="cuda")
    found = forbidden_modules()
    if found:
        print(f"loaded in this process: {', '.join(found)}", file=sys.stderr)
        return 3
    for name, c in out["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
