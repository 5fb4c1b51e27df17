"""The port's multi-process worker (``parallel/worker.py``): two gloo
processes on the CPU give the metrics and parameters of one process on the
same global batches (the JAX package's tests/test_multihost.py, with one
device per process), for the data-parallel, edge-sharded and halo steps;
the scaling harnesses run.  No JAX is imported here or in the workers."""

import os

import numpy as np
import pytest
import torch

from graph_neural_network_for_radar_perception_torch.config.config import (
    tiny_test_config,
)
from graph_neural_network_for_radar_perception_torch.parallel import worker
from graph_neural_network_for_radar_perception_torch.parallel.scaling import (
    measure_process_scaling,
    measure_scaling,
)

TIMEOUT = 240.0


def _run(extra, n_proc):
    """The worker's result on each of ``n_proc`` ranks (one thread each)."""
    return worker.launch(["--device", "cpu", "--steps", "3", "--global-batch", "8"] + extra,
                         n_proc, timeout=TIMEOUT, env=dict(os.environ, OMP_NUM_THREADS="1"))


@pytest.fixture(scope="module")
def single():
    """One process (the data-parallel step on a 1 × 1 grid) on the frames
    as they come and on spatially sorted frames."""
    return {"edge": _run(["--n-graph", "1"], 1)[0],
            "halo": _run(["--n-graph", "1", "--graph-partition", "halo"], 1)[0]}


@pytest.mark.parametrize("extra", [
    ["--n-graph", "1"], ["--n-graph", "2"],
    ["--n-graph", "2", "--graph-partition", "halo"],
], ids=["dp", "edge", "halo"])
def test_two_process_run_matches_single_process(single, extra):
    ref = single["halo" if "halo" in extra else "edge"]
    assert ref["process_count"] == 1 and ref["backend"] == "gloo"
    res = _run(extra, 2)
    assert [r["process_index"] for r in res] == [0, 1]
    for r in res:
        assert r["process_count"] == 2 and r["devices"] == 2 and r["device"] == "cpu"
        assert r["param_l1"] == res[0]["param_l1"] and r["metrics"] == res[0]["metrics"]
        for k, v in ref["metrics"].items():
            np.testing.assert_allclose(r["metrics"][k], v, rtol=1e-5, atol=1e-7, err_msg=k)
        np.testing.assert_allclose(r["param_l1"], ref["param_l1"], rtol=1e-6)
        assert r["metrics"]["skipped"] == 0.0


def test_worker_refuses_the_cpu_unless_asked(monkeypatch):
    """The worker's default device is the card: without one it raises."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        worker.main(["--steps", "1", "--num-processes", "1", "--process-id", "0"])


def test_scaling_harnesses_run(monkeypatch):
    monkeypatch.setenv("OMP_NUM_THREADS", "1")  # the workers' threads
    cfg = tiny_test_config(batch_size=2)
    res = measure_scaling(cfg, [(1, 1), (2, 2)], batch_per_device=1, iters=2,
                          device="cpu", timeout=TIMEOUT)
    assert [r["devices"] for r in res] == [1, 4]
    assert res[0]["efficiency"] == 1.0
    for r in res:
        assert r["edge_msgs_per_s"] > 0 and r["backend"] == "gloo" and r["device"] == "cpu"
    res = measure_process_scaling((1, 2), batch_per_process=2, bench_iters=2,
                                  device="cpu", timeout=TIMEOUT)
    assert [r["processes"] for r in res] == [1, 2]
    # CPU efficiency is orchestration only and sensitive to host load.
    assert res[0]["efficiency"] == 1.0 and res[1]["efficiency"] > 0.0
