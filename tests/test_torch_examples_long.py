"""The port's long-horizon entry points against the JAX package's, on the
CPU: ``examples/long_training_run.py`` (bucketed steps, a stop with
--stop-at and a resume, --eval-only, eval_trend.jsonl) and
``scripts/train_fixture_artifact.py`` (the mini-RadarScenes recipe through
the data plane, training and per-sequence evaluation).

Same seeds and carried weights (tests/torch_examples_support.py); every
step at STEP_TOL (rtol 1e-5, atol 1e-6) against JAX; the evaluations
written from the trained weights equal JAX's; a stopped and resumed port
run equals an uninterrupted one bit for bit."""

import json
import os

import jax  # noqa: F401  (the JAX package runs on the CPU here)
import pytest

from graph_neural_network_for_radar_perception_torch.examples import (
    long_training_run as TLONG,
)
from graph_neural_network_for_radar_perception_torch.scripts import (
    train_fixture_artifact as TFIX,
)
from torch_examples_support import (
    Carry,
    assert_msgpack_like_jax,
    assert_steps_close,
    load_root,
    run_jax,
)
from torch_port_fixtures import one_torch_thread  # noqa: F401  (autouse)

LOSSES = ("loss_total", "loss_node_cls", "loss_edge_cls", "loss_node_reg", "loss_obj_cls")


@pytest.fixture
def carry(monkeypatch):
    c = Carry()
    c.patch_jax(monkeypatch)
    return c


def _lines(path):
    with open(path) as f:
        return [json.loads(line) for line in f]


def test_long_training_run_matches_jax_and_resumes_exactly(monkeypatch, carry, tmp_path):
    """Three bucketed steps (a checkpoint after each) and the eval trend
    over the random init and every checkpoint, against JAX's; then the
    port stopped at step 2 and resumed to 3 (the cycled pool of 2 batches
    restarts at its first, as the uninterrupted run's third step takes it)
    equals the uninterrupted run: steps, checkpoints and eval trend; and
    --eval-only rewrites the same trend."""
    argv = ["--max-iters", "3", "--val-period", "1", "--pool-batches", "2",
            "--eval-frames", "3"]
    run_jax(monkeypatch, load_root("examples", "long_training_run"),
            argv + ["--run-dir", str(tmp_path / "jax"), "--platform", "cpu"])
    train_init, template = [p for _, p in carry.inits]
    carry.patch_port(monkeypatch, TLONG)
    steps = carry.port_steps(monkeypatch)
    whole = TLONG.main(argv + ["--run-dir", str(tmp_path / "whole"), "--device", "cpu"])
    assert whole.step == 3 and carry.taken == 2
    assert_steps_close(steps, carry.metrics, LOSSES, "long_training_run")
    trend = _lines(tmp_path / "whole" / "eval_trend.jsonl")
    assert [r["step"] for r in trend] == [0, 1, 2, 3]
    assert trend == _lines(tmp_path / "jax" / "eval_trend.jsonl")
    assert sorted(os.listdir(tmp_path / "whole" / "ckpt")) == ["1.pt", "2.pt", "3.pt"]

    # Stopped and resumed (the second run's fresh state is overwritten by
    # the restore), then the trend again from the checkpoints alone.
    whole_steps = list(steps)
    carry.inits = [("gnn", train_init), ("gnn", train_init), ("gnn", template),
                   ("gnn", template)]
    carry.taken = 0
    del steps[:]
    split = ["--run-dir", str(tmp_path / "split"), "--device", "cpu"]
    TLONG.main(argv + ["--stop-at", "2"] + split)
    assert len(steps) == 2 and not (tmp_path / "split" / "eval_trend.jsonl").exists()
    resumed = TLONG.main(argv + split)
    assert resumed.step == 3 and steps == whole_steps
    assert _lines(tmp_path / "split" / "eval_trend.jsonl") == trend
    path = TLONG.main(argv + ["--eval-only"] + split)
    assert carry.taken == 4 and _lines(path) == trend


def test_train_fixture_artifact_matches_jax(monkeypatch, carry, tmp_path):
    """Two steps of the recipe (the same windows, shuffled and flipped
    alike), then every sequence's confusion JSONs equal the JAX script's
    for the weights each trained."""
    monkeypatch.setattr("tempfile.tempdir", str(tmp_path))
    run_jax(monkeypatch, load_root("scripts", "train_fixture_artifact"),
            ["--cpu", "--iters", "2", "--out", str(tmp_path / "jax")])
    carry.patch_port(monkeypatch, TFIX)
    steps = carry.port_steps(monkeypatch)
    out = TFIX.main(["--iters", "2", "--out", str(tmp_path / "port"), "--device", "cpu"])
    assert carry.taken == 1
    assert_steps_close(steps, carry.metrics, LOSSES, "train_fixture_artifact")
    for sub in ("semantic_segmentation", "object_classification"):
        names = sorted(os.listdir(os.path.join(out, "eval", sub)))
        assert names == [f"sequence_{i}.json" for i in range(1, 7)]
        for name in names:
            with open(os.path.join(out, "eval", sub, name)) as f, \
                    open(tmp_path / "jax" / "eval" / sub / name) as g:
                assert json.load(f) == json.load(g), (sub, name)
    with open(os.path.join(out, "config.json")) as f:
        cfg = json.load(f)
    assert (cfg["max_nodes"], cfg["batch_size"], cfg["max_train_iter"]) == (256, 4, 2)
    assert sorted(os.listdir(out)) == ["README.md", "config.json", "eval", "weights.msgpack",
                                       "weights.pt"]
    assert_msgpack_like_jax(os.path.join(out, "weights.msgpack"),
                            tmp_path / "jax" / "weights.msgpack")
