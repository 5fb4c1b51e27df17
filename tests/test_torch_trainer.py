"""The port's scan and training loop against its own train step (on the
CPU): ``make_train_scan`` == sequential ``make_train_step`` calls, one batch
reused or batches stacked; ``train()`` over 5 batches == 5 steps, with its
logging, validation and checkpoint hooks; the eval step against the JAX
package's jitted ``make_eval_step`` on the same weights and batch."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from graph_neural_network_for_radar_perception_torch.config.config import (
    tiny_test_config,
)
from graph_neural_network_for_radar_perception_torch.data.pipeline import (
    SyntheticRadarDataset,
    stack_batch,
)
from graph_neural_network_for_radar_perception_torch.train import steps as S
from graph_neural_network_for_radar_perception_torch.train.trainer import (
    TrainHooks,
    train,
)
from graph_neural_network_for_radar_perception_torch.utils.checkpoint import (
    CheckpointManager,
)
from graph_neural_network_for_radar_perception_torch.utils.metrics_writer import (
    RunningMeans,
)
from graph_neural_network_for_radar_perception_torch.models.gnn import RadarGNN
from graph_neural_network_for_radar_perception_torch.utils.convert import (
    state_dict_from_flax,
)
from graph_neural_network_for_radar_perception_tpu.config import config as JC
from graph_neural_network_for_radar_perception_tpu.data.pipeline import (
    SyntheticRadarDataset as JSyntheticRadarDataset,
)
from graph_neural_network_for_radar_perception_tpu.train import steps as JS
from torch_port_fixtures import one_torch_thread  # noqa: F401  (autouse)


@pytest.fixture(scope="module")
def cfg():
    return tiny_test_config()


def _batches(cfg, k, seed=31):
    gen = SyntheticRadarDataset(cfg, seed=seed, num_objects=2).batches(cfg.batch_size)
    return [next(gen) for _ in range(k)]


def _state(cfg, seed=2):
    return S.create_train_state(cfg, torch.Generator().manual_seed(seed), device="cpu")


def _assert_same(a, b):
    assert a.step == b.step and a.updates == b.updates
    sb = b.model.state_dict()
    for k, v in a.model.state_dict().items():
        assert torch.equal(v, sb[k]), k


def _stack(batches):
    """[K] batches → one batch stacked on a new leading axis."""
    return stack_batch([(b.graph, b.labels) for b in batches])


@pytest.mark.parametrize("stacked", [False, True], ids=["reused", "stacked"])
def test_scan_matches_sequential(cfg, stacked):
    k = 3
    bs = _batches(cfg, k)
    s_seq, s_scan = _state(cfg), _state(cfg)
    step = S.make_train_step(cfg)
    for i in range(k):
        s_seq, m_seq = step(s_seq, bs[i] if stacked else bs[0])
    s_scan, m_scan = S.make_train_scan(cfg, k)(
        s_scan, _stack(bs) if stacked else bs[0])
    assert s_scan.step == k
    _assert_same(s_scan, s_seq)
    for name, v in m_seq.items():
        assert torch.equal(m_scan[name], v), name


def test_scan_takes_one_step_per_stacked_batch(cfg):
    """A stack of one batch with length=2 takes one step, as JAX's scan
    over the stacked axis: length counts steps of a reused batch only."""
    b = _batches(cfg, 1)[0]
    s_one, m_one = S.make_train_step(cfg)(_state(cfg), b)
    s_scan, m_scan = S.make_train_scan(cfg, 2)(_state(cfg), _stack([b]))
    assert s_scan.step == 1
    _assert_same(s_scan, s_one)
    for name, v in m_one.items():
        assert torch.equal(m_scan[name], v), name


def test_train_matches_steps_and_runs_hooks(cfg):
    bs = _batches(cfg, 5, seed=41)
    val = _batches(cfg, 2, seed=43)
    step = S.make_train_step(cfg)
    s_ref = _state(cfg, seed=4)
    want = RunningMeans()  # the validation sweep after iteration 4
    for i, b in enumerate(bs):
        s_ref, _ = step(s_ref, b)
        for vb in val if i == 3 else ():
            m = S.make_eval_step(cfg)(s_ref.model, vb)
            want.update({k: float(v) for k, v in m.items()})

    lines, written = [], []

    class Writer:
        def write_train_val(self, it, train_means, val_means):
            written.append((it, train_means, val_means))

    hooks = TrainHooks(log_period=2, val_period=4, num_val_batches=2,
                       writer=Writer(), print_fn=lines.append)
    s = train(cfg, iter(bs), lambda: iter(val), hooks=hooks,
              state=_state(cfg, seed=4), max_iters=5)
    _assert_same(s, s_ref)
    assert len(lines) == 2 and lines[0].startswith("iter 2: loss ")
    (it, train_means, val_means), = written
    assert it == 4 and "loss_total" in train_means and "skipped" in train_means
    assert val_means == pytest.approx(want.means())


def test_train_defaults_make_a_seeded_state(cfg):
    bs = _batches(cfg, 2)
    hooks = TrainHooks(print_fn=lambda s: None)
    a = train(cfg, iter(bs), hooks=hooks, max_iters=2, device="cpu")
    b = train(cfg, iter(bs), hooks=hooks, max_iters=2, device="cpu")
    assert a.step == 2
    _assert_same(a, b)
    fresh = S.create_train_state(cfg, torch.Generator().manual_seed(cfg.seed), device="cpu")
    assert not torch.equal(a.model.predict_node.head.out.weight,
                           fresh.model.predict_node.head.out.weight)


def test_train_checkpoint_hook_not_ported(cfg, tmp_path):
    """The checkpoint hook saves the state at every validation period and
    once at the end, and the saved state restores (it raised before
    utils/checkpoint.py was ported)."""
    mgr = CheckpointManager(str(tmp_path / "ckpt"))
    s = train(cfg, iter(_batches(cfg, 3)), hooks=TrainHooks(val_period=2, checkpoint=mgr,
                                                              print_fn=lambda s: None),
              state=_state(cfg), max_iters=3)
    assert mgr.all_steps() == [2, 3]
    _assert_same(mgr.restore(template=_state(cfg, seed=9)), s)


def test_eval_step_takes_no_gradient(cfg):
    st = _state(cfg)
    m = S.make_eval_step(cfg)(st.model, _batches(cfg, 1)[0])
    assert set(m) >= {"loss_total", "segment_accuracy"}
    assert all(not v.requires_grad and np.isfinite(float(v)) for v in m.values())
    assert all(p.grad is None for p in st.model.parameters())


@pytest.mark.parametrize("mp_impl", [None, "csr"], ids=["fused", "csr"])
def test_eval_step_matches_jax(mp_impl):
    """The eval step's metrics against JAX's jitted ``make_eval_step`` on
    the same weights (``state_dict_from_flax``) and numpy batches (f32 on
    two CPU backends: 1e-5), each message pass; no gradient anywhere."""
    overrides = {} if mp_impl is None else dict(mp_impl=mp_impl)
    jcfg, cfg = JC.tiny_test_config(**overrides), tiny_test_config(**overrides)
    params = JS.init_params(jcfg, jax.random.key(4))
    model = RadarGNN(cfg)
    model.load_state_dict(state_dict_from_flax(jax.tree.map(np.asarray, params)))
    gen = JSyntheticRadarDataset(jcfg, seed=33, num_objects=3).batches(jcfg.batch_size)
    jeval, teval = JS.make_eval_step(jcfg), S.make_eval_step(cfg)
    for _ in range(2):
        batch = next(gen)
        want = jeval(params, jax.tree.map(jnp.asarray, batch))
        got = teval(model, batch)
        assert set(got) == set(want)
        for k, v in want.items():
            np.testing.assert_allclose(float(got[k]), float(v), rtol=1e-5, atol=1e-5,
                                       err_msg=k)
    assert all(p.grad is None for p in model.parameters())
