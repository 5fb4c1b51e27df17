"""The port's bench (``graph_neural_network_for_radar_perception_torch/
scripts/bench.py``) against root ``bench.py``: each config equals the
``GNNConfig`` that root ``bench.py`` builds, field by field, and its host
batches and deploy graph equal ``_host_batch``'s element for element; the
CPU dry run prints the JSON keys; without a card the bench refuses.

Root ``bench.py``'s configs are read by running its ``bench_*`` functions
up to the point where each builds its batch (``_host_batch``, or the
dataset for ``deploy``), where a stub records the arguments and stops it.
Both packages' batches are built once with their numpy graph builders
and once with their default native ones (the two builders differ in the
last bit of some edge features: ROADMAP.md C4)."""

import dataclasses
import functools
import json

import numpy as np
import pytest
import torch

import bench as ROOT
from graph_neural_network_for_radar_perception_torch.config import config as PC
from graph_neural_network_for_radar_perception_torch.data import pipeline as TP
from graph_neural_network_for_radar_perception_torch.scripts import bench as B
from graph_neural_network_for_radar_perception_tpu.data import pipeline as JP
from torch_port_fixtures import jax_native  # noqa: F401  (fixture)
from torch_port_fixtures import one_torch_thread  # noqa: F401  (autouse)


class _Stop(Exception):
    pass


def _root_args(monkeypatch, name):
    """(cfg, *args, **kwargs) with which root bench.py's ``name`` builds
    its batch or dataset."""
    seen = {}

    def record(cfg, *args, **kwargs):
        seen.update(cfg=cfg, args=args, kwargs=kwargs)
        raise _Stop

    monkeypatch.setattr(ROOT, "_warm_device", lambda ph: None)
    monkeypatch.setattr(ROOT, "_host_batch", record)
    monkeypatch.setattr(JP, "SyntheticRadarDataset", record)
    with pytest.raises(_Stop):
        {"train_b8": ROOT.bench_train_b8, "stress_dense": ROOT.bench_stress_dense,
         "deploy": ROOT.bench_deploy}[name]()
    return seen


PORT_CONFIGS = {"train_b8": B.train_b8_config, "stress_dense": B.stress_dense_config,
                "deploy": B.deploy_config}
# The batch each of root bench.py's configs builds (its _host_batch call).
ROOT_BATCHES = {"train_b8": ((8,), dict(num_objects=(2, 12))),
                "stress_dense": ((2,), dict(num_objects=16, seed=1, packed=False))}


@pytest.mark.parametrize("name", list(PORT_CONFIGS))
def test_config_equals_root_bench(monkeypatch, name):
    seen = _root_args(monkeypatch, name)
    want = dataclasses.asdict(seen["cfg"])
    got = dataclasses.asdict(PORT_CONFIGS[name]())
    assert set(got) == set(want)
    for field, value in want.items():
        assert got[field] == value, field
    if name in ROOT_BATCHES:
        assert (seen["args"], seen["kwargs"]) == ROOT_BATCHES[name]
    else:
        assert seen["kwargs"] == dict(seed=2, num_objects=8)


def _assert_same_arrays(got, want, what):
    for f in dataclasses.fields(want):
        a, b = getattr(got, f.name), getattr(want, f.name)
        assert a.dtype == b.dtype and a.shape == b.shape, (what, f.name)
        np.testing.assert_array_equal(a, b, err_msg=f"{what}.{f.name}")


@pytest.fixture
def numpy_builder(monkeypatch):
    for module in (JP, TP):
        monkeypatch.setattr(module, "preprocess_frame",
                            functools.partial(module.preprocess_frame, use_native=False))


@pytest.mark.parametrize("name", list(ROOT_BATCHES))
def test_host_batch_equals_root_bench(numpy_builder, name):
    args, kwargs = ROOT_BATCHES[name]
    cfg = PORT_CONFIGS[name]()
    got = B.host_batch(cfg, *args, **kwargs)
    want = ROOT._host_batch(_jax_config(cfg), *args, **kwargs)
    _assert_same_arrays(got.graph, want.graph, "graph")
    _assert_same_arrays(got.labels, want.labels, "labels")


@pytest.mark.parametrize("name", list(ROOT_BATCHES))
def test_host_batch_equals_root_bench_native(jax_native, name):
    """The same through both packages' default native builders."""
    args, kwargs = ROOT_BATCHES[name]
    cfg = PORT_CONFIGS[name]()
    got = B.host_batch(cfg, *args, **kwargs)
    want = ROOT._host_batch(_jax_config(cfg), *args, **kwargs)
    _assert_same_arrays(got.graph, want.graph, "graph")
    _assert_same_arrays(got.labels, want.labels, "labels")


def _jax_config(cfg):
    from graph_neural_network_for_radar_perception_tpu.config.config import GNNConfig

    return GNNConfig(**dataclasses.asdict(cfg))


def test_deploy_graph_equals_root_bench(numpy_builder):
    cfg = B.deploy_config()
    jcfg = _jax_config(cfg)
    want, _ = JP.pad_frame(JP.SyntheticRadarDataset(jcfg, seed=2, num_objects=8).sample_frame(),
                           jcfg)
    _assert_same_arrays(B.deploy_graph(cfg), want, "graph")


def test_deploy_graph_equals_root_bench_native(jax_native):
    cfg = B.deploy_config()
    jcfg = _jax_config(cfg)
    want, _ = JP.pad_frame(JP.SyntheticRadarDataset(jcfg, seed=2, num_objects=8).sample_frame(),
                           jcfg)
    _assert_same_arrays(B.deploy_graph(cfg), want, "graph")


def test_cpu_dry_run_prints_the_json_keys(monkeypatch, capsys):
    """``--device cpu --steps 1`` runs every row on the CPU and prints the
    headline, then one JSON line with every row; here at narrow widths (the
    full-width dry run takes ~80 s on one core), with each config's own
    graph switches."""
    monkeypatch.setattr(B, "train_b8_config",
                        lambda: PC.tiny_test_config(edge_capacity_factor=4 / 3))
    monkeypatch.setattr(B, "stress_dense_config", lambda: PC.tiny_test_config(
        ball_query_eps_square=150.0, union_ball=True, edge_capacity_factor=10,
        graph_convolution_stem_channels=(16,) * 4))
    monkeypatch.setattr(B, "deploy_config", PC.tiny_test_config)
    assert B.main(["--device", "cpu", "--steps", "1", "--warmup", "0"]) == 0
    out, err = capsys.readouterr()
    res = json.loads(out.strip().splitlines()[-1])
    assert len(out.strip().splitlines()) == 1
    assert "headline: train_b8 fused" in err
    assert {"metric", "value", "unit", "ms_per_step", "device", "card", "peak_bf16_flops",
            "train_b8", "stress_dense", "deploy"} <= set(res)
    assert res["device"] == "cpu" and res["card"] is None and res["peak_bf16_flops"] is None
    assert set(res["train_b8"]["rows"]) == {"fused", "csr", "fused_bf16", "csr_bf16"}
    for row in res["train_b8"]["rows"].values():
        assert row["host_ms"] > 0 and row["mfu"] is None and row["skipped"] == 0
        assert "device_idle_share" not in row and "event_ms" not in row
    assert res["stress_dense"]["host_ms"] > 0
    assert res["deploy"]["detect"]["reps"] == 5
    assert res["value"] == res["train_b8"]["rows"]["fused"]["valid_edge_msgs_per_s"]


def test_bench_refuses_to_run_without_a_card(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert B.main([]) == 1
    assert capsys.readouterr().out == ""
    with pytest.raises(RuntimeError, match="no CUDA device"):
        B.run("cuda")
