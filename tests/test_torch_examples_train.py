"""The port's GNN training examples against the JAX package's, on the CPU:
``overfit_gnn``, ``train_gnn`` (with a resume) and ``demo_training_run``.

Each pair runs at tiny_test_config's widths on the same seeds, the JAX
run's weights carried into the port's (tests/torch_examples_support.py);
the losses and accuracies of every step (<= 3) agree at STEP_TOL (rtol
1e-5, atol 1e-6), and the evaluations written from the same weights are
equal."""

import json
import os

import jax  # noqa: F401  (the JAX package runs on the CPU here)
import numpy as np
import pytest

from graph_neural_network_for_radar_perception_torch.examples import (
    demo_training_run as TDEMO,
)
from graph_neural_network_for_radar_perception_torch.examples import overfit_gnn as TOVER
from graph_neural_network_for_radar_perception_torch.examples import train_gnn as TTRAIN
from graph_neural_network_for_radar_perception_tpu.data import prefetch as JP
from torch_examples_support import (
    Carry,
    assert_msgpack_like_jax,
    assert_steps_close,
    load_root,
    run_jax,
)
from torch_port_fixtures import one_torch_thread  # noqa: F401  (autouse)

LOSSES = ("loss_total", "loss_node_cls", "loss_edge_cls", "loss_node_reg", "loss_obj_cls")
ACCURACIES = ("segment_accuracy", "edge_accuracy", "object_accuracy")


@pytest.fixture
def carry(monkeypatch):
    c = Carry()
    c.patch_jax(monkeypatch)
    return c


def test_overfit_gnn_matches_jax(monkeypatch, carry):
    run_jax(monkeypatch, load_root("examples", "overfit_gnn"),
            ["--steps", "3", "--platform", "cpu"])
    carry.patch_port(monkeypatch, TOVER)
    got = TOVER.main(["--steps", "3", "--device", "cpu"])
    assert carry.taken == len(carry.inits) == 1
    assert_steps_close(got, carry.metrics, LOSSES + ACCURACIES, "overfit_gnn")


def test_train_gnn_and_resume_match_jax(monkeypatch, carry, tmp_path):
    """Two steps with checkpoints, then a resume to step 3 (each package
    from its own checkpoint directory: the JAX example's is Orbax's,
    ROADMAP.md C10); the resumed loop draws its batches from the start of
    the stream again, in both."""
    jax_ex = load_root("examples", "train_gnn")
    common = ["--batch-size", "2"]
    run_jax(monkeypatch, jax_ex, common + ["--iters", "2", "--out", str(tmp_path / "jax"),
                                           "--platform", "cpu"])
    run_jax(monkeypatch, jax_ex, common + ["--iters", "3", "--resume",
                                           "--out", str(tmp_path / "jax"), "--platform", "cpu"])
    carry.patch_port(monkeypatch, TTRAIN)
    steps = carry.port_steps(monkeypatch)
    out = str(tmp_path / "port")
    first = TTRAIN.main(common + ["--iters", "2", "--out", out, "--device", "cpu"])
    assert first.step == 2 and sorted(os.listdir(os.path.join(out, "ckpt"))) == ["2.pt"]
    resumed = TTRAIN.main(common + ["--iters", "3", "--resume", "--out", out,
                                    "--device", "cpu"])
    assert resumed.step == 3 and carry.taken == 2
    assert sorted(os.listdir(os.path.join(out, "ckpt"))) == ["2.pt", "3.pt"]
    assert os.path.exists(os.path.join(out, "logs", "metrics.jsonl"))
    assert_steps_close(steps, carry.metrics, LOSSES + ACCURACIES, "train_gnn")


def test_demo_training_run_matches_jax(monkeypatch, carry, tmp_path):
    """Two steps between the evaluations; the data stream made
    deterministic in both (one iterator, a fixed seed in place of
    os.urandom's) so that both packages see the same batches."""
    monkeypatch.setattr(os, "urandom", lambda n: bytes(n))
    one_stream = lambda make_iterator, **kw: make_iterator()  # noqa: E731
    monkeypatch.setattr(JP, "threaded_batches", one_stream)
    argv = ["--iters", "2", "--eval-frames", "2"]
    run_jax(monkeypatch, load_root("examples", "demo_training_run"),
            argv + ["--out", str(tmp_path / "jax"), "--platform", "cpu"])
    carry.patch_port(monkeypatch, TDEMO)
    monkeypatch.setattr(TDEMO, "threaded_batches", one_stream)
    steps = carry.port_steps(monkeypatch)
    after = TDEMO.main(argv + ["--out", str(tmp_path / "port"), "--device", "cpu"])
    assert_steps_close(steps, carry.metrics, LOSSES + ACCURACIES, "demo_training_run")

    def read(side, name):
        with open(tmp_path / side / name) as f:
            return json.load(f)

    assert read("port", "eval_before.json") == read("jax", "eval_before.json")
    want = read("jax", "eval_after.json")
    for rec in (after, want):
        rec.pop("wall_s")
    assert after == want
    assert (tmp_path / "port" / "metrics.jsonl").exists()
    assert (tmp_path / "port" / "params.pt").exists()
    np.testing.assert_array_equal(sorted(os.listdir(tmp_path / "port")),
                                  ["eval_after.json", "eval_before.json", "metrics.jsonl",
                                   "params.msgpack", "params.pt"])
    assert_msgpack_like_jax(tmp_path / "port" / "params.msgpack",
                            tmp_path / "jax" / "params.msgpack")
