"""Each cell run end to end at a tiny size on the CPU: the result line's
shape, the program agreeing with the reference, and the command refusing
to run without a card."""

import json
import math
import subprocess
import sys
import time

import pytest

from bench_support import BENCH_DIR, ROOT, SEED, TINY, TINY_MIX
from harness import cell

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in BENCH["workloads"]]


def run(workload, traced, **kw):
    mix = dict(TINY_MIX, log_period=2 if workload.endswith("train") else 1)
    return cell.run_cell(workload, SEED, 0.3, traced, t_start=time.perf_counter(),
                         device="cpu", config_override=TINY, mix_override=mix, **kw)


def _line_shape(out, names):
    line = json.loads(json.dumps(out))
    assert list(line)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(line)[-1] == "checks"
    assert line["attempted"] > 0 and line["failed"] == 0
    assert set(line["metrics"]) <= set(names)
    for m in line["metrics"].values():
        assert set(m) == {"value", "unit"} and math.isfinite(m["value"])
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(line["device"])
    for c in line["checks"].values():
        assert set(c) == {"value", "limit"}
    return line


@pytest.mark.parametrize("workload", CELLS)
def test_cell_end_to_end(workload):
    spec = cell.load_cell(BENCH, workload)
    line = _line_shape(run(workload, False), [m["name"] for m in spec["e2e"]])
    assert set(line["metrics"]) == {m["name"] for m in spec["e2e"]}
    assert line["correct"] is True


@pytest.mark.parametrize("workload", CELLS)
def test_cell_traced(workload):
    spec = cell.load_cell(BENCH, workload)
    line = _line_shape(run(workload, True), [m["name"] for m in spec["per_layer"]])
    assert "step_host_ms." + ("train" if workload.endswith("train") else "eval") in line["metrics"]
    assert {"busy_s", "window_s"} <= set(line["device"])
    assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}


def test_every_cell_names_its_files():
    for w in BENCH["workloads"]:
        spec = cell.load_cell(BENCH, w["name"])
        assert spec["limits"] and spec["mix"]["kind"] in ("train", "eval")
        for m in spec["per_layer"]:
            assert callable(cell.reader(m["name"]))


def test_no_card_no_result():
    proc = subprocess.run([sys.executable, str(BENCH_DIR / "run.py"), "--workload", CELLS[0],
                           "--seed", str(SEED), "--seconds", "1", "--trace", "0"],
                          cwd=ROOT, capture_output=True, text=True, timeout=300,
                          env={"CUDA_VISIBLE_DEVICES": "", "PATH": "/usr/bin:/bin"})
    assert proc.returncode != 0 and proc.stdout == ""
