"""The port's examples beyond the GNN trainer against the JAX package's, on
the CPU: ``finetune_obj_classifier``, ``train_classifier`` (GT and
detector proposals), ``classifier_chain``, ``train_cnn`` and
``pointwise_baseline``.

Same seeds and carried weights (tests/torch_examples_support.py); every
step's loss and accuracy (<= 3 steps) at STEP_TOL (rtol 1e-5, atol 1e-6);
the chain's summary and the point-wise predictions JSONs equal."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from graph_neural_network_for_radar_perception_torch.examples import (
    classifier_chain as TCHAIN,
)
from graph_neural_network_for_radar_perception_torch.examples import (
    finetune_obj_classifier as TFT,
)
from graph_neural_network_for_radar_perception_torch.examples import (
    pointwise_baseline as TPW,
)
from graph_neural_network_for_radar_perception_torch.examples import (
    train_classifier as TCLS,
)
from graph_neural_network_for_radar_perception_torch.examples import train_cnn as TCNN
from graph_neural_network_for_radar_perception_torch.models import classifier as PCL
from graph_neural_network_for_radar_perception_torch.models import cnn as PCNN
from graph_neural_network_for_radar_perception_tpu.data import labels as JL
from graph_neural_network_for_radar_perception_tpu.models import classifier as JCL
from graph_neural_network_for_radar_perception_tpu.models import cnn as JCNN
from torch_examples_support import Carry, assert_steps_close, load_root, run_jax
from torch_port_fixtures import one_torch_thread  # noqa: F401  (autouse)

OBJECT = ("loss_obj_cls", "object_accuracy", "skipped")
# tests/test_torch_cnn.py's TINY widths (the learning rate stays the
# example's).
CNN_WIDTHS = dict(base_stem_channels=(8, 8), base_kernel_sizes=(5, 3),
                  bottleneck_number_of_blocks=(1, 1), bottleneck_stem_channels=(16, 16),
                  bottleneck_width_channels=8, neck_out_channels=8,
                  head_stem_channels=(8,), head_ffn_channels=(8,))
# tests/test_torch_classifier.py's widths (capacities as the examples set
# them).
CLASSIFIER_WIDTHS = dict(node_feat_enc_stem_channels=(32, 32),
                         graph_convolution_stem_channels=(32, 24),
                         msg_mlp_hidden_dim=32, node_pred_stem_channels=(32, 32))


@pytest.fixture
def carry(monkeypatch):
    c = Carry()
    c.patch_jax(monkeypatch)
    for jmod, pmod, widths, attr in ((JCNN, PCNN, CNN_WIDTHS, "CNNConfig"),
                                     (JCL, PCL, CLASSIFIER_WIDTHS, "ClassifierConfig")):
        for mod in (jmod, pmod):
            monkeypatch.setattr(mod, attr, lambda _cls=getattr(mod, attr), _w=widths,
                                **kw: _cls(**{**kw, **_w}))
    return c


def test_finetune_obj_classifier_matches_jax(monkeypatch, carry):
    argv = ["--iters", "3", "--batch-size", "2"]
    run_jax(monkeypatch, load_root("examples", "finetune_obj_classifier"),
            argv + ["--platform", "cpu"])
    carry.patch_port(monkeypatch, TFT)
    got = TFT.main(argv + ["--device", "cpu"])
    assert carry.taken == 1
    assert_steps_close(got, carry.metrics, OBJECT, "finetune")
    assert max(m["object_accuracy"] for m in got) > 0


@pytest.mark.parametrize("proposals", [[], ["--use-detector-proposals"]],
                         ids=["gt-clusters", "detector-proposals"])
def test_train_classifier_matches_jax(monkeypatch, carry, proposals):
    argv = ["--iters", "3", "--batch-size", "2"] + proposals
    run_jax(monkeypatch, load_root("examples", "train_classifier"),
            argv + ["--platform", "cpu"])
    carry.patch_port(monkeypatch, TCLS)
    got = TCLS.main(argv + ["--device", "cpu"])
    assert [k for k, _ in carry.inits] == ["gnn"] * bool(proposals) + ["classifier"]
    assert carry.taken == len(carry.inits)
    assert_steps_close(got, carry.metrics, OBJECT, "train_classifier")


def test_classifier_chain_matches_jax(monkeypatch, carry, tmp_path):
    """Stage 1 (two GNN steps), the frozen trunk's proposals, stage 2 (two
    classifier steps): both stages' steps at STEP_TOL and the same
    summary (held-out accuracies of stage 2 and the seg-majority)."""
    argv = ["--stage1-iters", "2", "--stage2-iters", "2", "--pool-batches", "2",
            "--n-train-frames", "3", "--n-eval-frames", "3", "--batch-size", "2"]
    run_jax(monkeypatch, load_root("examples", "classifier_chain"),
            argv + ["--out", str(tmp_path / "jax"), "--platform", "cpu"])
    carry.patch_port(monkeypatch, TCHAIN)
    stage1 = carry.port_steps(monkeypatch)
    summary, stage2 = TCHAIN.main(argv + ["--out", str(tmp_path / "port"), "--device", "cpu"])
    assert [k for k, _ in carry.inits] == ["gnn", "classifier"] and carry.taken == 2
    assert_steps_close(stage1, carry.metrics[:2], ("loss_total", "loss_obj_cls"), "stage 1")
    assert_steps_close(stage2, carry.metrics[2:], OBJECT, "stage 2")
    with open(tmp_path / "jax" / "summary.json") as f:
        assert summary == json.load(f)
    assert summary["eval_objects"] > 0


def test_train_cnn_matches_jax(monkeypatch, carry):
    argv = ["--iters", "2", "--grid", "32"]
    run_jax(monkeypatch, load_root("examples", "train_cnn"), argv + ["--platform", "cpu"])
    carry.patch_port(monkeypatch, TCNN)
    got = TCNN.main(argv + ["--device", "cpu"])
    assert carry.taken == 1
    assert_steps_close(got, carry.metrics, ("loss_total", "loss_cls", "loss_reg", "skipped"),
                       "train_cnn")


def _jax_pointwise_layers():
    """pointwise_baseline.py:69-77's initialisation, recomputed."""
    key = jax.random.key(0)
    dims = [4, 64, 64, JL.NUM_CLASSES_ALL]
    layers = []
    for din, dout in zip(dims[:-1], dims[1:]):
        key, k = jax.random.split(key)
        layers.append({"w": np.asarray(jax.random.normal(k, (din, dout)) * (1.0 / np.sqrt(din))),
                       "b": np.zeros((dout,), np.float32)})
    return layers


def test_pointwise_mlp_is_the_jax_forward():
    layers = _jax_pointwise_layers()
    model = TPW.PointwiseMLP([4, 64, 64, JL.NUM_CLASSES_ALL])
    model.load_state_dict(TPW.mlp_state_dict(layers))
    x = np.random.default_rng(0).normal(size=(50, 4)).astype(np.float32)
    want = jnp.asarray(x)
    for i, lyr in enumerate(layers):
        want = want @ lyr["w"] + lyr["b"]
        if i + 1 < len(layers):
            want = jax.nn.relu(want)
    with torch.no_grad():
        got = model(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, np.asarray(want), rtol=1e-5, atol=1e-6)


def test_pointwise_baseline_writes_the_jax_predictions(monkeypatch, tmp_path):
    argv = ["--frames", "4", "--iters", "3"]
    run_jax(monkeypatch, load_root("examples", "pointwise_baseline"),
            argv + ["--out", str(tmp_path / "jax"), "--platform", "cpu"])
    layers = _jax_pointwise_layers()
    mlp = TPW.PointwiseMLP

    def carried(dims, generator=None):
        model = mlp(dims, generator)
        model.load_state_dict(TPW.mlp_state_dict(layers))
        return model

    monkeypatch.setattr(TPW, "PointwiseMLP", carried)
    out = TPW.main(argv + ["--out", str(tmp_path / "port"), "--device", "cpu"])
    assert len(out["losses"]) == 3 and out["losses"][-1] < out["losses"][0]
    for name in ("predictions_semseg.json", "predictions_instseg.json"):
        with open(tmp_path / "port" / name) as f, open(tmp_path / "jax" / name) as g:
            assert json.load(f) == json.load(g), name
