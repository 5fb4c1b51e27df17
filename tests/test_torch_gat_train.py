"""The GATv2 variant (``RadarGNNv2``) on the port's training path, against
the benchmark's plain reference (``benchmark/reference/gat.py``, plain
PyTorch written from the published model and GATv2's equations), on the
CPU at small widths: ``create_train_state(model_cls=RadarGNNv2)`` and
``make_train_step`` give the reference's first loss, first gradient and
parameters after three SGD steps, ``make_eval_step`` its loss; the default
``create_train_state`` still builds ``RadarGNN`` bit for bit; and
``examples/train_gnn.py --model v2`` trains.

The weights are drawn by the benchmark's rule (``benchmark/harness/
weights.py``): every Linear U(+-1/sqrt(fan_in)), every norm gamma 1 and
beta 0, the reference's ``weight_rule`` for the attention vector and the
GATv2 bias; the heads' output layers too, so that the loss depends on the
trunk."""

import math
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from graph_neural_network_for_radar_perception_torch.config.config import tiny_test_config
from graph_neural_network_for_radar_perception_torch.data.pipeline import SyntheticRadarDataset
from graph_neural_network_for_radar_perception_torch.examples import train_gnn as TTRAIN
from graph_neural_network_for_radar_perception_torch.models.gat import RadarGNNv2
from graph_neural_network_for_radar_perception_torch.models.gnn import RadarGNN
from graph_neural_network_for_radar_perception_torch.train import steps as S
from torch_port_fixtures import one_torch_thread  # noqa: F401  (autouse)

BENCH_DIR = Path(__file__).resolve().parents[1] / "benchmark"
if str(BENCH_DIR) not in sys.path:
    sys.path.insert(0, str(BENCH_DIR))

from reference import gat as RG  # noqa: E402

GAT = dict(hidden_node_channels_gat=32, num_heads_gat=4)
STEPS = 3
# The loss terms: both sides sum the same f32 products in other orders
# (the port's batched matmuls and index_add_ over the batch's flat rows,
# the reference's per graph), a few ulps of each term (read: ~1e-7).
LOSS_RTOL = 2e-6
# A leaf's gradient: the same orders, compounded through 2 attention
# rounds and the heads' backward (read: up to 5e-7 of the scale below).
# An element is held within 1e-5 of the larger of the leaf's largest
# element and the median leaf's, as the benchmark's check measures: a
# scalar norm parameter's gradient sums terms over every row that nearly
# cancel, so its own size can lie far below the rounding of its terms.
GRAD_REL = 1e-5
# The parameters after three steps: lr 0.005 times those gradients on top
# of weights of order 0.1-1 (read: up to 3e-8, an ulp or two of a weight).
PARAM_ATOL = 1e-6


def _cfg():
    return tiny_test_config(**GAT)


def _weights(cfg: dict, seed: int):
    """The benchmark's draw: U(+-bound) + const for every leaf of the
    reference's ``param_specs``."""
    specs = RG.param_specs(cfg)
    fan_in = {n.rsplit(".", 1)[0]: s[1] for n, s in specs if len(s) == 2}
    gen = torch.Generator().manual_seed(seed)
    out = {}
    for name, shape in specs:
        module, leaf = name.rsplit(".", 1)
        if leaf in ("gamma", "beta"):
            bound, const = 0.0, float(leaf == "gamma")
        elif module in fan_in:
            bound, const = 1.0 / math.sqrt(fan_in[module]), 0.0
        else:
            bound, const = RG.weight_rule(name, shape, fan_in)
        out[name] = (2 * torch.rand(shape, generator=gen) - 1) * bound + const
    return out


def _ref_cfg(cfg) -> dict:
    return {k: (list(v) if isinstance(v, tuple) else v) for k, v in vars(cfg).items()}


def _batches(cfg, count, seed=3):
    it = SyntheticRadarDataset(cfg, seed=seed, num_objects=(2, 5)).packed_batches(2)
    return [next(it) for _ in range(count)]


def _as_ref(batch) -> dict:
    """A numpy GraphBatch as the reference's dict of tensors; its live rows
    come first in every slot, as the reference reads them."""
    out = {part: {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in vars(obj).items()}
           for part, obj in (("graph", batch.graph), ("labels", batch.labels))}
    for part, key in (("graph", "node_mask"), ("graph", "edge_mask"), ("graph", "und_mask"),
                      ("labels", "cluster_mask")):
        m = out[part][key]
        live = m.sum(-1, keepdim=True)
        assert torch.equal(m, torch.arange(m.shape[-1])[None] < live), key
    return out


def _state(cfg, weights):
    state = S.create_train_state(cfg, torch.Generator().manual_seed(0), device="cpu",
                                 model_cls=RadarGNNv2)
    own = dict(state.model.named_parameters())
    assert list(own) == [n for n, _ in RG.param_specs(_ref_cfg(cfg))]  # names and order
    with torch.no_grad():
        for k, p in own.items():
            p.copy_(weights[k])
    return state


@pytest.fixture(scope="module")
def case():
    cfg = _cfg()
    rcfg = _ref_cfg(cfg)
    weights = _weights(rcfg, seed=11)
    batches = _batches(cfg, STEPS)
    ref = RG.Reference(rcfg)
    losses, grad, after = RG.train_steps(ref, weights, [_as_ref(b) for b in batches])
    return cfg, rcfg, weights, batches, ref, losses, grad, after


def test_train_step_matches_the_plain_reference(case):
    """Three captured-path (eager on the CPU) train steps of a
    ``RadarGNNv2`` state: the first step's loss terms and total, every
    leaf's first gradient (from the momentum after one step: SGD's first
    buffer is the gradient plus the decay term) and every parameter after
    three steps, against the reference's."""
    cfg, rcfg, weights, batches, _, losses, grad, after = case
    state = _state(cfg, weights)
    assert type(state.model) is RadarGNNv2
    step = S.make_train_step(cfg)
    got = []
    for i, batch in enumerate(batches):
        state, m = step(state, batch)
        assert float(m["skipped"]) == 0.0
        got.append({k: float(v) for k, v in m.items()})
        if i == 0:
            mom = {k: state.optimizer.state[p]["momentum_buffer"].clone()
                   for k, p in state.model.named_parameters()}
    for k, v in losses[0].items():
        assert got[0][k] == pytest.approx(v, rel=LOSS_RTOL), k
    wd = rcfg["weight_decay"]
    scales = {k: float(g.abs().max()) for k, g in grad.items()}
    median = float(np.median(list(scales.values())))
    for k, g in grad.items():
        prog = mom[k] - wd * weights[k]
        assert float((prog - g).abs().max()) <= GRAD_REL * max(scales[k], median), k
    for k, p in state.model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), after[k].numpy(), rtol=0,
                                   atol=PARAM_ATOL, err_msg=k)
    assert state.step == state.updates == STEPS


def test_eval_step_matches_the_reference_loss(case):
    """``make_eval_step`` on a ``RadarGNNv2`` against the reference's
    ``batch_loss`` with the same weights, each term and the total."""
    cfg, _, weights, batches, ref, _, _, _ = case
    state = _state(cfg, weights)
    eval_step = S.make_eval_step(cfg)
    for batch in batches:
        got = eval_step(state.model, batch)
        with torch.no_grad():
            _, want = ref.batch_loss(weights, _as_ref(batch))
        for k, v in want.items():
            assert float(got[k]) == pytest.approx(float(v), rel=LOSS_RTOL), k


def test_default_state_is_the_flagship_bit_for_bit():
    """``create_train_state`` without ``model_cls`` builds ``RadarGNN`` with
    the weights ``RadarGNN`` draws from the same generator; with
    ``model_cls=RadarGNNv2`` the GATv2 neck sits in ``pass_messages``."""
    cfg = _cfg()
    state = S.create_train_state(cfg, torch.Generator().manual_seed(5), device="cpu")
    assert type(state.model) is RadarGNN
    want = RadarGNN(cfg, generator=torch.Generator().manual_seed(5)).state_dict()
    got = state.model.state_dict()
    assert list(got) == list(want)
    for k, v in want.items():
        assert torch.equal(got[k], v), k
    v2 = S.create_train_state(cfg, torch.Generator().manual_seed(5), device="cpu",
                              model_cls=RadarGNNv2)
    assert type(v2.model) is RadarGNNv2
    assert any(k.endswith(".gat.att") for k in v2.model.state_dict())


def test_train_gnn_example_trains_v2(monkeypatch, tmp_path):
    """``examples/train_gnn.py --model v2`` runs two iterations on the CPU
    (the synthetic frames, small widths) and returns a ``RadarGNNv2``
    state."""
    monkeypatch.setattr(TTRAIN, "GNNConfig", lambda: tiny_test_config(**GAT))
    state = TTRAIN.main(["--model", "v2", "--iters", "2", "--batch-size", "2",
                         "--device", "cpu", "--out", str(tmp_path)])
    assert type(state.model) is RadarGNNv2
    assert state.step == 2
    assert all(torch.isfinite(p).all() for p in state.model.parameters())
