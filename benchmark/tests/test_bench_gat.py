"""The GATv2 family (``radar_gatv2_knn``, the cell ``gat.train``) at a
tiny size on the CPU: its configuration names its own modules, its
weights place the attention's leaves, the cell runs correct, the TF32
control and the faults (half of each batch, the state left unchanged)
fail its comparison, and its counts equal a hand count."""

import json
import math
import time

import pytest
import torch

from bench_support import BENCH_DIR, ROOT, SEED, TINY, TINY_MIX
from harness import cell, check, counts, counts_gat, program_gat, traffic
from harness.weights import make_weights
from reference import gat
import control

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())


def _spec():
    return cell.load_cell(BENCH, "gat.train")


def test_configuration_names_its_modules():
    spec = _spec()
    mods = spec["modules"]
    assert (mods.program, mods.reference, mods.counts) == (program_gat, gat, counts_gat)
    conf = json.loads((BENCH_DIR / "configs" / "radar_gatv2_knn.json").read_text())
    base = json.loads((BENCH_DIR / "configs" / "radar_gnn_knn.json").read_text())
    assert conf["gnn_config"] == dict(base["gnn_config"], hidden_node_channels_gat=512,
                                      num_heads_gat=8)
    assert conf["reduced"] == []
    assert program_gat.Program({**conf["gnn_config"], **TINY}, "cpu").round_entry() is None


def test_weights_place_the_attention_leaves():
    cfg = dict(_spec()["config"]["gnn_config"], **TINY)
    w = make_weights(cfg, SEED, "cpu", gat)
    heads, c = cfg["num_heads_gat"], cfg["hidden_node_channels_gat"] // cfg["num_heads_gat"]
    bound = math.sqrt(6.0 / (heads + c))
    rounds = len(cfg["graph_convolution_stem_channels"])
    atts = [w[f"pass_messages.blocks.{i}.gat.att"] for i in range(rounds)]
    for a in atts:
        assert a.shape == (1, heads, c)
        assert float(a.abs().max()) <= bound and float(a.abs().max()) > 0.9 * bound
    for i in range(rounds):
        assert not w[f"pass_messages.blocks.{i}.gat.bias"].any()
        lin = w[f"pass_messages.blocks.{i}.gat.lin_edge.weight"]
        assert float(lin.abs().max()) <= 1 / math.sqrt(lin.shape[1])


def _run(program_cls=None):
    mix = dict(TINY_MIX, log_period=2)
    return cell.run_cell("gat.train", SEED, 0.3, False, t_start=time.perf_counter(),
                         device="cpu", config_override=TINY, mix_override=mix,
                         program_cls=program_cls)


def test_cell_runs_correct_at_tiny_widths():
    out = _run()
    assert out["correct"] is True and out["failed"] == 0, out["checks"]
    assert set(out["metrics"]) == {"train_graphs_per_s", "train_step_p95_ms", "setup_s"}


@pytest.mark.parametrize("kind", [dict(precision="tf32"), dict(graphs=[0])],
                         ids=["tf32", "half_batch"])
def test_control_and_fault_are_not_correct(kind):
    spec = _spec()
    cfg = dict(spec["config"]["gnn_config"], **TINY)
    mix = dict(spec["mix"], **TINY_MIX)
    pool, _ = traffic.make_pool(cfg, mix, SEED)
    numbers = control.stand_in_numbers(gat, cfg, mix, pool, SEED, "cpu", **kind)
    numbers = {k: v for k, v in numbers.items() if k in check.COMPARED}
    assert not check.verdict(numbers, spec["limits"]), numbers
    # each number the control moves fails its limit, not only one of them
    assert all(v > spec["limits"][k] for k, v in numbers.items()), numbers


class Unchanged(program_gat.Program):
    """A step that gives the state back as it found it."""

    def train_step(self):
        step = super().train_step()

        def broken(state, batch):
            saved = [t.clone() for t in state.tensors()]
            state, metrics = step(state, batch)
            with torch.no_grad():
                for t, v in zip(state.tensors(), saved):
                    t.copy_(v)
            return state, metrics
        return broken


def test_unchanged_state_is_not_correct():
    out = _run(Unchanged)
    assert out["correct"] is False, out["checks"]
    assert out["checks"]["update_median_gap"]["value"] > 0.5


def test_gat_work_by_hand():
    n, e, d, de, heads, c = 5, 7, 4, 3, 2, 3
    hc = 6
    products = 2 * (n * 2 * d * hc + e * de * hc)
    elementwise = e * (7 * hc + 5 * heads) + n * hc
    weights = 4 * ((2 * d + de) * hc + 3 * hc + hc + hc)
    read = 4 * (n * d + e * de) + 8 * e + weights
    assert counts_gat.gat_work(n, e, d, de, heads, c, backward=False) == (
        products + elementwise, read + 4 * n * hc)
    flops, nbytes = counts_gat.gat_work(n, e, d, de, heads, c, backward=True)
    assert flops == 3 * products + elementwise + e * (7 * hc + 4 * heads)
    assert nbytes == read + 4 * n * hc + 4 * n * hc + 4 * (n * d + e * de) + weights


def test_model_flops_by_hand():
    cfg = dict(node_feat_enc_stem_channels=[4, 2], edge_feat_enc_stem_channels=[3, 2],
               graph_convolution_stem_channels=[2], hidden_node_channels_gat=8,
               num_heads_gat=2, link_pred_stem_channels=[2], node_pred_stem_channels=[2],
               num_blocks_to_compute_edge=1, class_weights_dyn=[1.0] * 7)
    n, e, u, c = 3, 4, 2, 1
    first = n * 6 * 4 + e * 7 * 3
    rest = (n * 4 * 2 + e * 3 * 2                    # encoders after the first layers
            + n * 2 * 2 * 8 + e * (2 * 8 + 2 * 8)     # node projections; edge, logits, messages
            + n * ((2 + 8) * 4 + 4 * 2 + 2 * 2)       # update MLP: 10 -> 4 -> 2 -> 2
            + n * (2 * 2 + 2 * 2 + 2 * 7)             # node class: stem, head, out
            + n * (2 * 2 + 2 * 2 + 2 * 2)             # offsets
            + n * 2 * 2                               # link: the nodes' block
            + u * (2 * 2 + 2 * 2 + 2 * 2)             # link: pairs
            + n * 2 * 2                               # object stem
            + c * (2 * 2 + 2 * 7))                    # object head
    assert counts_gat.model_flops(cfg, n, e, u, c, train=False) == 2.0 * (first + rest)
    assert counts_gat.model_flops(cfg, n, e, u, c, train=True) == 2.0 * (2 * first + 3 * rest)
    assert counts_gat.least_seconds is counts.least_seconds
