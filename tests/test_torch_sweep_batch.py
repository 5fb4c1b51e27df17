"""The port's batch sweep (``graph_neural_network_for_radar_perception_torch/
scripts/sweep_batch.py``) against root ``scripts/sweep_batch.py``.

One size (``--one 2 --device cpu``) at ``tiny_test_config`` with K1 = 2,
K2 = 3 on the CPU, beside root ``measure(2)`` with root ``bench.py``'s
``train_b8_config`` narrowed to the same tiny config and the JAX train scan
replaced by a stub on a fake clock (its timing is not compared: only what
both compute from the same numpy batch, ``bench.py``'s ``_host_batch``):
the JSON keys are the root script's plus ``mfu``, ``valid_eps / cap_eps``
and ``occupancy`` agree to rtol 1e-6, and the analytic FLOP of a step is
the JAX package's ``flops_per_train_step``.  Both batches come from the
packages' native graph builders (``tests/test_torch_bench.py``)."""

import importlib.util
import json
import os
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bench as ROOT
from graph_neural_network_for_radar_perception_torch.config.config import (
    tiny_test_config,
)
from graph_neural_network_for_radar_perception_torch.parallel.worker import config_to_json
from graph_neural_network_for_radar_perception_torch.scripts import sweep_batch as SW
from graph_neural_network_for_radar_perception_tpu.config import config as JC
from graph_neural_network_for_radar_perception_tpu.train import steps as JS
from graph_neural_network_for_radar_perception_tpu.utils.profiling import (
    flops_per_train_step,
)
from torch_port_fixtures import jax_native  # noqa: F401  (fixture)
from torch_port_fixtures import one_torch_thread  # noqa: F401  (autouse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT_KEYS = {"batch", "ms_per_step", "valid_eps", "cap_eps", "occupancy", "analytic_tflops"}


def _root_sweep():
    spec = importlib.util.spec_from_file_location(
        "root_sweep_batch", os.path.join(REPO, "scripts", "sweep_batch.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _root_row(monkeypatch, capsys, batch):
    """Root ``measure(batch)`` at the tiny config, its train scan a stub
    that advances a fake clock by K ms a run."""
    root = _root_sweep()
    clock = [0.0]

    def scan(cfg, k):
        def run(state, batch):
            clock[0] += k * 1e-3
            return state, {"loss_total": 0.0}
        return run

    monkeypatch.setattr(ROOT, "train_b8_config", lambda: JC.tiny_test_config())
    monkeypatch.setattr(JS, "make_train_scan", scan)
    monkeypatch.setattr(JS, "create_train_state",
                        lambda cfg, key: types.SimpleNamespace(params={"w": jnp.zeros(1)}))
    monkeypatch.setattr(root, "time", types.SimpleNamespace(perf_counter=lambda: clock[0]))
    capsys.readouterr()
    root.measure(batch)
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def test_one_size_matches_the_root_sweep(jax_native, monkeypatch, capsys, tmp_path):
    path = str(tmp_path / "tiny.json")
    config_to_json(tiny_test_config(), path)
    capsys.readouterr()
    assert SW.main(["--one", "2", "--device", "cpu", "--config", path,
                    "--k1", "2", "--k2", "3"]) == 0
    got = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    want = _root_row(monkeypatch, capsys, 2)
    assert set(want) == ROOT_KEYS and set(got) == ROOT_KEYS | {"mfu"}
    assert got["batch"] == 2 and got["mfu"] is None  # no device metric on the CPU
    assert got["ms_per_step"] > 0
    np.testing.assert_allclose(got["valid_eps"] / got["cap_eps"],
                               want["valid_eps"] / want["cap_eps"], rtol=1e-6)
    np.testing.assert_allclose(got["occupancy"], want["occupancy"], rtol=1e-6)
    flops = got["analytic_tflops"] * 1e12 * got["ms_per_step"] / 1e3
    np.testing.assert_allclose(flops, flops_per_train_step(JC.tiny_test_config(), 2), rtol=1e-9)


@pytest.mark.parametrize("batch", [8, 32])
def test_analytic_flop_is_the_jax_packages(batch):
    """The FLOP count the sweep divides by, at ``train_b8``'s config."""
    from graph_neural_network_for_radar_perception_torch.scripts.bench import train_b8_config
    from graph_neural_network_for_radar_perception_torch.utils.profiling import (
        flops_per_train_step as port_flops,
    )

    assert port_flops(train_b8_config(), batch) == flops_per_train_step(
        ROOT.train_b8_config(), batch)


def test_a_failed_size_is_reported_and_fails_the_sweep(tmp_path, capsys):
    """Every size whose process fails prints its exit code; the sweep goes
    on to the next and returns 1 at the end."""
    assert SW.main(["--device", "cpu", "--config", str(tmp_path / "missing.json")]) == 1
    err = capsys.readouterr().err
    for b in SW.BATCHES:
        assert f"B={b}: FAILED rc=1" in err


def test_the_sweep_asks_for_the_card_by_default(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        SW.main(["--one", "8"])
