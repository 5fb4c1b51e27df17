"""The port's detection entry points against the JAX package's, on the
CPU: ``examples/evaluate.py``, ``examples/visualize.py`` and
``scripts/check_decision_equivalence.py`` (with the in-memory
mini-RadarScenes it reads, ``data/mini_radarscenes.py``).

Decision equality throughout: the same node classes, DBSCAN partitions and
object classes, hence the same confusion matrices and JSONs, from the same
weights (the JAX run's, carried into the port's; the committed fixture
weights for the decision check)."""

import json
import os

import h5py
import jax
import numpy as np
import pytest
import torch

from fixtures_radarscenes import make_mini_radarscenes
from graph_neural_network_for_radar_perception_torch.config.config import tiny_test_config
from graph_neural_network_for_radar_perception_torch.data import mini_radarscenes as MR
from graph_neural_network_for_radar_perception_torch.data.radarscenes import SequenceCache
from graph_neural_network_for_radar_perception_torch.examples import evaluate as TEVAL
from graph_neural_network_for_radar_perception_torch.examples import visualize as TVIZ
from graph_neural_network_for_radar_perception_torch.scripts import (
    check_decision_equivalence as TDEC,
)
from graph_neural_network_for_radar_perception_torch.train.steps import create_train_state
from graph_neural_network_for_radar_perception_torch.utils.checkpoint import CheckpointManager
from graph_neural_network_for_radar_perception_tpu.config import config as JC
from graph_neural_network_for_radar_perception_tpu.eval import drivers as JD
from graph_neural_network_for_radar_perception_tpu.infer import pipeline as JPIPE
from torch_examples_support import Carry, load_root, narrow, run_jax
from torch_port_fixtures import one_torch_thread  # noqa: F401  (autouse)


@pytest.fixture
def carry(monkeypatch):
    c = Carry()
    c.patch_jax(monkeypatch)
    return c


def _record(monkeypatch, owner, attr):
    """Every return value of ``owner.attr`` from here on, in a list."""
    log, fn = [], getattr(owner, attr)

    def wrapped(*a, **k):
        out = fn(*a, **k)
        log.append(out)
        return out

    monkeypatch.setattr(owner, attr, wrapped)
    return log


def _read(path):
    with open(path) as f:
        return json.load(f)


def _reference_checkpoint(path):
    """A reference-layout ``.pt`` (tests/test_torch_export_import.py's
    grammar: ``pred.`` + the torch key, kernels [out, in]) of weights made
    by the JAX package from another seed than the examples'."""
    from graph_neural_network_for_radar_perception_tpu.train.steps import init_params
    from graph_neural_network_for_radar_perception_tpu.utils import torch_import as JI

    cfg = narrow(JC.GNNConfig)(max_nodes=512, max_clusters=256, temporal_window_size=5)
    params = init_params(cfg, jax.random.key(7))
    sd = {}
    for keys, v in jax.tree_util.tree_flatten_with_path(params)[0]:
        v = np.asarray(v)
        parts = tuple(k.key for k in keys)
        sd["pred." + JI.flax_path_to_torch_key(parts)] = torch.from_numpy(
            (v.T if parts[-1] == "kernel" and v.ndim == 2 else v).copy())
    torch.save(sd, path)
    return str(path)


@pytest.mark.parametrize("weights", ["seeded", "torch-ckpt"])
def test_evaluate_matches_jax(monkeypatch, carry, tmp_path, weights):
    """The segmentation JSON and the detection confusion matrix equal the
    JAX example's for the same weights and frames: the seeded ones, or a
    reference checkpoint both import (``--torch-ckpt``)."""
    jax_det = _record(monkeypatch, JD, "evaluate_detection_from_data")
    argv = ["--frames", "3"]
    if weights == "torch-ckpt":
        argv += ["--torch-ckpt", _reference_checkpoint(tmp_path / "ref.pt")]
    run_jax(monkeypatch, load_root("examples", "evaluate"),
            argv + ["--out", str(tmp_path / "jax"), "--platform", "cpu"])
    carry.patch_port(monkeypatch, TEVAL)
    got = TEVAL.main(argv + ["--out", str(tmp_path / "port"), "--device", "cpu"])
    assert carry.taken == 1 and len(jax_det) == 1
    name = "sequence_synthetic.json"
    assert _read(tmp_path / "port" / name) == _read(tmp_path / "jax" / name)
    assert got["segmentation"].cm.sum() > 0
    np.testing.assert_array_equal(got["detection"].cm, jax_det[0].cm)
    assert got["detection"].cm.sum() > 0


def test_evaluate_reads_a_port_checkpoint(monkeypatch, tmp_path):
    """``--ckpt``: a CheckpointManager directory of the port (ROADMAP.md
    C10) gives the same JSON as the same weights made in place."""
    monkeypatch.setattr(TEVAL, "GNNConfig", lambda **kw: tiny_test_config(**kw))
    plain = TEVAL.main(["--frames", "2", "--out", str(tmp_path / "plain"),
                        "--device", "cpu"])
    cfg = tiny_test_config(max_nodes=512, max_clusters=256, temporal_window_size=5)
    state = create_train_state(cfg, device="cpu")
    with torch.no_grad():
        made = TEVAL.RadarGNN(cfg, generator=torch.Generator().manual_seed(0))
    state.model.load_state_dict(made.state_dict())
    CheckpointManager(str(tmp_path / "ckpt")).save(7, state)
    loaded = TEVAL.main(["--frames", "2", "--ckpt", str(tmp_path / "ckpt"),
                         "--out", str(tmp_path / "ckpt_eval"), "--device", "cpu"])
    assert _read(loaded["json"]) == _read(plain["json"])
    np.testing.assert_array_equal(loaded["detection"].cm, plain["detection"].cm)


def test_visualize_matches_jax(monkeypatch, carry, tmp_path):
    """The same detections frame by frame, then the same files: one panel
    per frame and the GIF."""
    jax_dets = _record(monkeypatch, JPIPE.FrameDetector, "detect_frame_arrays")
    argv = ["--frames", "2"]
    run_jax(monkeypatch, load_root("examples", "visualize"),
            argv + ["--out", str(tmp_path / "jax"), "--platform", "cpu"])
    carry.patch_port(monkeypatch, TVIZ)
    dets, gif = TVIZ.main(argv + ["--out", str(tmp_path / "port"), "--device", "cpu"])
    assert len(dets) == len(jax_dets) == 2
    for d, j in zip(dets, jax_dets):
        assert d.num_clusters == j.num_clusters
        for field in ("node_class", "node2cluster", "link_class", "cluster_class"):
            np.testing.assert_array_equal(getattr(d, field), np.asarray(getattr(j, field)),
                                          err_msg=field)
    assert sorted(os.listdir(tmp_path / "port")) == sorted(os.listdir(tmp_path / "jax"))
    assert gif == str(tmp_path / "port" / "frames.gif") and os.path.getsize(gif) > 1000


@pytest.mark.parametrize("seed,n_scenes,n_objects", [(777, 18, 4), (100, 48, 4), (5, 9, 2)])
def test_mini_radarscenes_tables_equal_the_fixture_files(tmp_path, seed, n_scenes, n_objects):
    """``make_sequence`` returns the tables ``make_mini_radarscenes`` writes
    (read back with h5py), and ``MemorySequenceCache`` gives the same
    windows as the port's ``SequenceCache`` over those files."""
    name = "sequence_3"
    make_mini_radarscenes(str(tmp_path), seed=seed, n_scenes=n_scenes, n_objects=n_objects,
                          seq_name=name)
    radar, odometry, scenes = MR.make_sequence(seed=seed, n_scenes=n_scenes,
                                               n_objects=n_objects, seq_name=name)
    with h5py.File(tmp_path / "data" / name / "radar_data.h5", "r") as f:
        want_radar, want_odo = f["radar_data"][:], f["odometry"][:]
    assert radar.dtype == want_radar.dtype and odometry.dtype == want_odo.dtype
    np.testing.assert_array_equal(radar, want_radar)
    np.testing.assert_array_equal(odometry, want_odo)
    assert scenes == _read(tmp_path / "data" / name / "scenes.json")
    assert MR.MOUNTS == _read(tmp_path / "data" / "sensors.json")

    files = SequenceCache(str(tmp_path), "data")
    memory = MR.MemorySequenceCache({name: (radar, odometry, scenes)})
    windows = files.windows(name, 5)
    assert memory.windows(name, 5) == windows and windows
    for w in windows[::4]:
        a, b = memory.extract_window(name, w), files.extract_window(name, w)
        assert a.keys() == b.keys()
        for k in a:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_decision_check_matches_jax_records(tmp_path, monkeypatch):
    """The port's records on the CPU equal the JAX script's own
    ``run_backend("cpu")`` records (the committed fixture weights, the 12
    windows of sequence 9), and the script compares a device with the CPU
    (here the CPU with itself) over all of them."""
    monkeypatch.setattr("tempfile.tempdir", str(tmp_path))
    out = tmp_path / "jax_cpu.json"
    load_root("scripts", "check_tpu_decision_equivalence").run_backend("cpu", str(out))
    want = _read(out)["records"]
    got = TDEC.run_device("cpu")
    assert len(got) == len(want) == TDEC.N_FRAMES
    assert TDEC.compare(got, want, "port vs JAX") == sum(r is not None for r in want) > 0
    assert TDEC.main(["--device", "cpu"]) == sum(r is not None for r in got)


def test_decision_check_reports_a_differing_decision():
    rec = {"node_class": [0, 1, 2], "partition": [[[0, 1], 3], [[2], 0]]}
    moved = {"node_class": [0, 1, 2], "partition": [[[0], 3], [[1, 2], 0]]}
    assert TDEC.compare([rec, None], [rec, None], "same") == 1
    with pytest.raises(AssertionError, match="frame 0: cluster partition"):
        TDEC.compare([rec], [moved], "moved")
    with pytest.raises(AssertionError, match="frame 1: presence"):
        TDEC.compare([rec, rec], [rec, None], "missing")
    with pytest.raises(AssertionError, match="node classes"):
        TDEC.compare([rec], [dict(rec, node_class=[0, 1, 1])], "class")
