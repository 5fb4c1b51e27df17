"""The port's ``utils/profiling.py`` against the JAX package's: the analytic
FLOP count of a train step equals the JAX function's exactly on the
shipped, bench and narrow configs; the step timer and throughput meter
follow ``tests/test_utils.py``'s pattern; MFU and the card's peak are None
on the CPU and map card names as the port's ``utils/timing`` peaks say;
``trace`` writes a Chrome trace."""

import json

import pytest
import torch

from graph_neural_network_for_radar_perception_torch.config import config as PC
from graph_neural_network_for_radar_perception_torch.utils import profiling as P
from graph_neural_network_for_radar_perception_torch.utils.timing import (
    PEAK_BF16_FLOPS,
    PEAK_F32_FLOPS,
)
from graph_neural_network_for_radar_perception_tpu.config import config as JC
from graph_neural_network_for_radar_perception_tpu.utils import profiling as JP
from torch_port_fixtures import one_torch_thread  # noqa: F401  (autouse)

# (name, GNNConfig overrides, batch size): the shipped config, root
# bench.py's train_b8 and stress_dense, and narrow widths.
CONFIGS = [
    ("default", {}, 8),
    ("train_b8", dict(max_nodes=768, max_clusters=256, edge_capacity_factor=4 / 3), 8),
    ("stress_dense", dict(max_nodes=768, max_clusters=256, ball_query_eps_square=150.0,
                          union_ball=True, edge_capacity_factor=10,
                          graph_convolution_stem_channels=(64,) * 14), 2),
    ("narrow", "tiny", 4),
]


@pytest.mark.parametrize("name, overrides, batch", CONFIGS, ids=[c[0] for c in CONFIGS])
def test_flops_per_train_step_equals_jax(name, overrides, batch):
    if overrides == "tiny":
        jcfg, pcfg = JC.tiny_test_config(), PC.tiny_test_config()
    else:
        jcfg, pcfg = JC.GNNConfig(**overrides), PC.GNNConfig(**overrides)
    want = JP.flops_per_train_step(jcfg, batch)
    assert want > 0
    assert P.flops_per_train_step(pcfg, batch) == want


def test_step_timer_and_throughput():
    t = P.StepTimer()
    for _ in range(5):
        with t.step():
            pass
    s = t.summary()
    assert s["steps"] == 5 and s["mean_ms"] >= 0
    assert s["p50_ms"] <= s["p90_ms"] <= s["p99_ms"]
    t.reset()
    assert t.summary() == {}

    m = P.ThroughputMeter(units_per_step=100)
    assert m.rate() == 0.0
    m.start()
    m.tick(10)
    assert m.rate() > 0


def test_step_timer_keeps_at_most_max_records():
    t = P.StepTimer(max_records=3)
    for _ in range(5):
        with t.step():
            pass
    assert t.summary()["steps"] == 3


def test_mfu_and_peak_are_none_on_the_cpu():
    assert P.device_peak_flops("cpu") is None
    assert P.mfu(1e12, 1.0, "cpu") is None
    if not torch.cuda.is_available():
        assert P.device_peak_flops() is None
        assert P.mfu(1e12, 1.0) is None


@pytest.mark.parametrize("name, peak", [
    ("NVIDIA H100 80GB HBM3", PEAK_BF16_FLOPS),
    ("NVIDIA H100 PCIe", None),           # another part, another peak
    ("NVIDIA A100-SXM4-80GB", None),
], ids=["h100-sxm", "h100-pcie", "a100"])
def test_peak_maps_card_names(monkeypatch, name, peak):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda device=None: name)
    assert P.device_peak_flops() == peak
    assert P.device_peak_flops(0) == peak
    assert P.device_peak_flops("cpu") is None
    assert P.device_peak_flops(dtype="f32") == (PEAK_F32_FLOPS if peak else None)
    if peak is None:
        assert P.mfu(1e12, 1.0) is None
    else:
        assert P.mfu(peak / 2, 1.0) == pytest.approx(0.5)
        assert P.mfu(peak, 0.0) is None


def test_trace_writes_a_chrome_trace(tmp_path):
    with P.trace(str(tmp_path / "t")) as d:
        torch.ones(8, 8) @ torch.ones(8, 8)
    with open(f"{d}/trace.json") as f:
        events = json.load(f)["traceEvents"]
    assert any("aten::" in e.get("name", "") for e in events)


def test_step_timing_refuses_without_a_card(monkeypatch, capsys):
    """``scripts/step_timing.py`` measures on a card only: without one it
    exits 1 and prints no result."""
    from graph_neural_network_for_radar_perception_torch.scripts import step_timing

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert step_timing.main([]) == 1
    assert capsys.readouterr().out == ""
