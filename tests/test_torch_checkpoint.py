"""The port's ``utils/checkpoint.py``, ``MetricsWriter`` and the rest of
``train/trainer.py`` (on the CPU): resume is exact (N steps, save, restore
into a fresh state, N more equals 2N uninterrupted, bit for bit, params
and optimiser state, SGD and AdamW, also mid accumulation cycle);
``max_to_keep`` and ``latest_step``; ``train()`` saves at the JAX loop's
steps for the same hooks; ``train_chunked`` matches the JAX package's on
the same weights and batches; the JSONL of ``MetricsWriter`` equals JAX's
line for line."""

import dataclasses
import json
import os
import re

import jax
import numpy as np
import pytest
import torch

from graph_neural_network_for_radar_perception_torch.config.config import (
    tiny_test_config,
)
from graph_neural_network_for_radar_perception_torch.core.graph import GraphBatch
from graph_neural_network_for_radar_perception_torch.data.pipeline import (
    SyntheticRadarDataset,
)
from graph_neural_network_for_radar_perception_torch.train import steps as S
from graph_neural_network_for_radar_perception_torch.train import trainer as PT
from graph_neural_network_for_radar_perception_torch.utils import checkpoint as CK
from graph_neural_network_for_radar_perception_torch.utils import metrics_writer as PW
from graph_neural_network_for_radar_perception_torch.utils.convert import (
    state_dict_from_flax,
)
from graph_neural_network_for_radar_perception_tpu.config import config as JC
from graph_neural_network_for_radar_perception_tpu.data import pipeline as JP
from graph_neural_network_for_radar_perception_tpu.train import steps as T
from graph_neural_network_for_radar_perception_tpu.train import trainer as JT
from graph_neural_network_for_radar_perception_tpu.utils import metrics_writer as JW
from torch_port_fixtures import one_torch_thread  # noqa: F401  (autouse)

# train_chunked against JAX: test_torch_train.py's tolerance for steps on
# the same weights (f32, other summation orders).
STEP_TOL = dict(rtol=1e-4, atol=1e-6)


def _batches(cfg, k, seed=31):
    gen = SyntheticRadarDataset(cfg, seed=seed, num_objects=2).batches(cfg.batch_size)
    return [next(gen) for _ in range(k)]


def _state(cfg, seed):
    return S.create_train_state(cfg, torch.Generator().manual_seed(seed), device="cpu")


def _quiet(**kw):
    return PT.TrainHooks(print_fn=lambda s: None, **kw)


def _assert_same_state(a, b):
    assert (a.step, a.updates, a.mini_step) == (b.step, b.updates, b.mini_step)
    sb = b.model.state_dict()
    for k, v in a.model.state_dict().items():
        assert torch.equal(v, sb[k]), k
    oa, ob = a.optimizer.state_dict(), b.optimizer.state_dict()
    assert oa["param_groups"] == ob["param_groups"]
    assert oa["state"].keys() == ob["state"].keys()
    for i, st in oa["state"].items():
        for k, v in st.items():
            assert torch.equal(torch.as_tensor(v), torch.as_tensor(ob["state"][i][k])), (i, k)
    assert (a.acc_grads is None) == (b.acc_grads is None)
    for x, y in zip(a.acc_grads or (), b.acc_grads or ()):
        assert torch.equal(x, y)


@pytest.mark.parametrize("overrides, n", [
    ({}, 3),
    ({"optim": "adamw"}, 3),
    ({"grad_accumulation_steps": 3}, 2),  # saved with one micro-step pending
    ({"optim": "adamw", "grad_accumulation_steps": 2, "max_train_iter": 6}, 3),
], ids=["sgd", "adamw", "sgd-mid-accumulation", "adamw-mid-accumulation-milestone"])
def test_resume_is_exact(tmp_path, overrides, n):
    """N steps through train(), saved by its checkpoint hook, restored into
    a state made from another seed, N more from starting_iter=N: the
    params, the optimiser state and the counters equal those of 2N
    uninterrupted steps bit for bit.  The last case crosses an LR
    milestone (50 % of 6 updates) after the restore."""
    cfg = tiny_test_config(**overrides)
    bs = _batches(cfg, 2 * n)
    whole = PT.train(cfg, iter(bs), hooks=_quiet(), state=_state(cfg, 5), max_iters=2 * n)

    mgr = CK.CheckpointManager(str(tmp_path / "ckpt"))
    first = PT.train(cfg, iter(bs[:n]), hooks=_quiet(checkpoint=mgr), state=_state(cfg, 5),
                     max_iters=n)
    assert mgr.all_steps() == [n]
    if cfg.grad_accumulation_steps > 1:
        assert first.mini_step == n % cfg.grad_accumulation_steps != 0
    resumed = mgr.restore(template=_state(cfg, 99))
    _assert_same_state(resumed, first)
    resumed = PT.train(cfg, iter(bs[n:]), hooks=_quiet(), state=resumed, starting_iter=n,
                       max_iters=2 * n)
    _assert_same_state(resumed, whole)


def test_max_to_keep_and_latest_step(tmp_path):
    mgr = CK.CheckpointManager(str(tmp_path / "ckpt"), max_to_keep=2)
    assert mgr.latest_step() is None and mgr.restore() is None
    for step in (1, 2, 5, 3):
        mgr.save(step, {"w": torch.full((2,), float(step)), "step": step}, wait=True)
    assert mgr.all_steps() == [3, 5] and mgr.latest_step() == 5
    assert sorted(os.listdir(mgr.directory)) == ["3.pt", "5.pt"]  # no temporary left
    assert torch.equal(mgr.restore()["w"], torch.full((2,), 5.0))
    assert mgr.restore(3)["step"] == 3
    with pytest.raises(FileNotFoundError):
        mgr.restore(1)
    keep_all = CK.CheckpointManager(str(tmp_path / "all"), max_to_keep=None)
    for step in range(5):
        keep_all.save(step, {"step": step})
    keep_all.close()
    assert keep_all.all_steps() == list(range(5))


def test_run_dir_and_params_file(tmp_path):
    d = CK.run_dir(str(tmp_path))
    assert os.path.isdir(d) and re.fullmatch(r"\d{13}", os.path.basename(d))
    cfg = tiny_test_config()
    a, b = _state(cfg, 1).model, _state(cfg, 2).model
    CK.save_params(a, os.path.join(d, "w", "params.pt"))
    assert CK.load_params(b, os.path.join(d, "w", "params.pt")) is b
    saved = CK.load_params(None, os.path.join(d, "w", "params.pt"))
    for k, v in a.state_dict().items():
        assert torch.equal(b.state_dict()[k], v) and torch.equal(saved[k], v)


class _Recorder:
    """A checkpoint hook that records each save's step and wait."""

    def __init__(self):
        self.calls = []

    def save(self, step, state, wait=False):
        self.calls.append((step, wait))


@pytest.mark.parametrize("val_period, max_iters, starting_iter", [
    (2, 5, 0), (2, 4, 0), (3, 7, 2), (10, 3, 0)])
def test_train_saves_at_the_jax_loops_steps(tmp_path, val_period, max_iters, starting_iter):
    """The JAX loop (JAX train step and weights) and the port's, with the
    same hooks: checkpoints at every validation period and once at the end,
    the last one waited for."""
    jcfg, cfg = JC.tiny_test_config(), tiny_test_config()
    jb = _batches_jax(jcfg, max_iters - starting_iter)
    jrec, prec = _Recorder(), _Recorder()
    JT.train(jcfg, iter([jax.tree.map(np.asarray, b) for b in jb]),
             hooks=JT.TrainHooks(val_period=val_period, checkpoint=jrec,
                                 print_fn=lambda s: None),
             state=T.create_train_state(jcfg, jax.random.key(0)),
             max_iters=max_iters, starting_iter=starting_iter)
    PT.train(cfg, iter(jb), hooks=_quiet(val_period=val_period, checkpoint=prec),
             state=_state(cfg, 0), max_iters=max_iters, starting_iter=starting_iter)
    assert prec.calls == jrec.calls and prec.calls[-1] == (max_iters, True)
    mgr = CK.CheckpointManager(str(tmp_path / "ckpt"), max_to_keep=None)
    PT.train(cfg, iter(jb), hooks=_quiet(val_period=val_period, checkpoint=mgr),
             state=_state(cfg, 0), max_iters=max_iters, starting_iter=starting_iter)
    assert mgr.all_steps() == sorted({s for s, _ in jrec.calls})


def test_train_places_every_batch():
    """A train step with ``place_batch`` gets every train and validation
    batch through it, as in the JAX loop."""
    cfg = tiny_test_config()
    bs, val = _batches(cfg, 4), _batches(cfg, 2, seed=7)
    placed = []
    step = S.make_train_step(cfg)

    def placing_step(state, batch):
        return step(state, batch)

    def place(batch):
        placed.append(batch)
        return GraphBatch.from_numpy(batch, "cpu")

    placing_step.place_batch = place
    PT.train(cfg, iter(bs), lambda: iter(val), hooks=_quiet(val_period=2, num_val_batches=2),
             state=_state(cfg, 0), train_step=placing_step, max_iters=4)
    assert [id(b) for b in placed] == [id(b) for b in bs[:2] + val + bs[2:] + val]


def _batches_jax(jcfg, k, seed=5):
    gen = JP.SyntheticRadarDataset(jcfg, seed=seed, num_objects=3).batches(jcfg.batch_size)
    return [next(gen) for _ in range(k)]


def test_train_chunked_matches_jax(tmp_path):
    """Five steps in chunks of 2 (the last chunk a tail of 1) from the same
    weights on the same batches: the params within STEP_TOL of JAX's, and
    the written metrics (the never-reset running means of the chunks' last
    steps, ROADMAP.md C6) line for line, the values within STEP_TOL."""
    jcfg, cfg = JC.tiny_test_config(), tiny_test_config()
    js = T.create_train_state(jcfg, jax.random.key(0))
    st = _state(cfg, 0)
    st.model.load_state_dict(state_dict_from_flax(jax.tree.map(np.asarray, js.params)))
    jb = _batches_jax(jcfg, 5)
    jw = JW.MetricsWriter(str(tmp_path / "jax"), use_tensorboard=False)
    pw = PW.MetricsWriter(str(tmp_path / "port"), use_tensorboard=False)
    jlines, plines = [], []
    js = JT.train_chunked(jcfg, iter(jb), chunk=2, max_iters=5, state=js,
                          hooks=JT.TrainHooks(writer=jw, print_fn=jlines.append))
    st = PT.train_chunked(cfg, iter([GraphBatch.from_numpy(b, "cpu") for b in jb]), chunk=2,
                          max_iters=5, state=st, hooks=_quiet(writer=pw))
    jw.close()
    pw.close()
    assert st.step == 5 and st.updates == 5
    want = state_dict_from_flax(jax.tree.map(np.asarray, js.params))
    for k, v in st.model.state_dict().items():
        np.testing.assert_allclose(v.numpy(), want[k].numpy(), **STEP_TOL, err_msg=k)
    recs = [[json.loads(ln) for ln in open(tmp_path / d / "metrics.jsonl")]
            for d in ("jax", "port")]
    assert [r["step"] for r in recs[0]] == [r["step"] for r in recs[1]] == [2, 4, 5]
    for jr, pr in zip(*recs):
        assert set(jr) == set(pr)
        for k in jr.keys() - {"step", "time"}:
            np.testing.assert_allclose(pr[k], jr[k], **STEP_TOL, err_msg=k)
    assert len(jlines) == 3 and jlines[-1].endswith("(chunk=1)")


def test_metrics_writer_jsonl_equals_jax(tmp_path, monkeypatch):
    """The same writes through both writers give the same file, line for
    line (the clock fixed)."""
    for mod in (JW, PW):
        monkeypatch.setattr(mod.time, "time", lambda: 1234.5)
    calls = [("write", 3, {"a": 1, "b": np.float32(2.5)}, ""),
             ("write", 4, {"a": 0.1}, "x/"),
             ("pair", 10, {"loss": 1.5}, {"loss": 2.0}),
             ("pair", 20, {"loss": 1.25}, None),
             ("pair", 30, {"loss": 1.0}, {})]
    for mod, d in ((JW, "jax"), (PW, "port")):
        w = mod.MetricsWriter(str(tmp_path / d), use_tensorboard=False)
        for kind, step, a, b in calls:
            if kind == "write":
                w.write(step, a, prefix=b)
            else:
                w.write_train_val(step, a, b)
        w.close()
    jax_lines = open(tmp_path / "jax" / "metrics.jsonl").read().splitlines()
    assert open(tmp_path / "port" / "metrics.jsonl").read().splitlines() == jax_lines
    assert len(jax_lines) == 6


def test_checkpoint_of_a_state_keeps_its_fields():
    """What a checkpoint holds of a TrainState: every field of the
    dataclass but the model and optimiser objects, whose state_dicts it
    holds."""
    fields = {f.name for f in dataclasses.fields(S.TrainState)}
    payload = CK._payload(_state(tiny_test_config(), 0))
    assert set(payload) == fields
