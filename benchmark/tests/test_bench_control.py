"""The comparison that decides ``correct`` fails its control and each
fault a cell can have, at a tiny size on the CPU with the committed
limits: the reference in TF32 in the program's place; a step that returns
its state unchanged; half of each batch left out, the mean taken over the
rest; an answer altered where it is produced.  (One chip: no exchange
between chips to leave out.)"""

import json

import pytest
import torch

from bench_support import BENCH_DIR, SEED, TINY, TINY_MIX
from harness import check, traffic
from harness.cell import load_cell
from harness.program import Program
import control
from test_bench_run_cpu import run


def _spec(workload):
    return load_cell(json.loads((BENCH_DIR.parent / "BENCHMARK.json").read_text()), workload)


@pytest.mark.parametrize("workload", ["knn.train", "ball.train", "knn.eval", "ball.eval"])
def test_tf32_control_is_not_correct(workload):
    spec = _spec(workload)
    cfg = dict(spec["config"]["gnn_config"], **TINY)
    mix = dict(spec["mix"], **TINY_MIX)
    pool, _ = traffic.make_pool(cfg, mix, SEED)
    numbers = control.stand_in_numbers(spec["modules"].reference, cfg, mix, pool, SEED, "cpu",
                                       precision="tf32")
    assert not check.verdict(numbers, spec["limits"]), numbers


def _half(batch):
    """The batch with its second half of slots emptied: every mask off."""
    g, lab = batch.graph, batch.labels
    keep = g.node_mask.shape[0] // 2

    def off(mask):
        out = mask.copy()
        out[keep:] = False
        return out

    return type(batch)(
        type(g)(**{**vars(g), "node_mask": off(g.node_mask), "edge_mask": off(g.edge_mask),
                   "und_mask": off(g.und_mask)}),
        type(lab)(**{**vars(lab), "cluster_mask": off(lab.cluster_mask)}))


class Unchanged(Program):
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


class HalfTrain(Program):
    def train_step(self):
        step = super().train_step()
        return lambda state, batch: step(state, _half(batch))


class HalfEval(Program):
    def eval_step(self):
        step = super().eval_step()
        return lambda model, batch: step(model, _half(batch))


def _altered(metrics):
    out = dict(metrics)
    out["loss_node_cls"] = out["loss_node_cls"] * 1.01
    return out


class AlteredTrain(Program):
    def train_step(self):
        step = super().train_step()

        def broken(state, batch):
            state, metrics = step(state, batch)
            return state, _altered(metrics)
        return broken


class AlteredEval(Program):
    def eval_step(self):
        step = super().eval_step()
        return lambda model, batch: _altered(step(model, batch))


@pytest.mark.parametrize("workload,broken", [
    ("knn.train", Unchanged), ("knn.train", HalfTrain), ("knn.train", AlteredTrain),
    ("ball.train", Unchanged), ("ball.train", HalfTrain), ("ball.train", AlteredTrain),
    ("knn.eval", HalfEval), ("knn.eval", AlteredEval),
    ("ball.eval", HalfEval), ("ball.eval", AlteredEval)])
def test_fault_is_not_correct(workload, broken):
    out = run(workload, False, program_cls=broken)
    assert out["correct"] is False, out["checks"]


def test_sound_program_is_correct():
    assert run("knn.train", False)["correct"] is True
