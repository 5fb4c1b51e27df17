"""The fused round's layout (``ops.fused_mp.fused_layout``): the edges by
receiver and by sender that the fused kernels sum over in a fixed order.

On the CPU: the layout against a numpy stable argsort (sentinels
included), ``fused_message_pass`` with and without a layout against the JAX
package's Pallas kernel in interpret mode (values and gradients), the model
making one layout per graph and handing it to every round where the kernels
run (none on the CPU), and the kernel
build's key covering the headers of ``csrc/``.  The kernels themselves are
held against their plain versions on the card in tests/test_torch_cuda.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from graph_neural_network_for_radar_perception_torch.config.config import (
    tiny_test_config,
)
from graph_neural_network_for_radar_perception_torch.core.graph import RadarGraph
from graph_neural_network_for_radar_perception_torch.data.pipeline import (
    SyntheticRadarDataset,
    pad_frame,
)
from graph_neural_network_for_radar_perception_torch.models import blocks
from graph_neural_network_for_radar_perception_torch.models.gnn import RadarGNN
from graph_neural_network_for_radar_perception_torch.ops import _build
from graph_neural_network_for_radar_perception_torch.ops import fused_mp as FM
from graph_neural_network_for_radar_perception_tpu.ops.pallas import fused_mp as JFM
from torch_port_fixtures import one_torch_thread  # noqa: F401  (autouse)


def _edges(rng, case, n=64, e=300, others=True):
    """(senders, receivers) int32: random ends with the padded tail and
    one-sided sentinels of a frame, or the case's special shape; with
    ``others`` also ends outside [0, n] other than the sentinel n."""
    s = rng.integers(0, n, e).astype(np.int32)
    r = rng.integers(0, n, e).astype(np.int32)
    if case == "hub":  # a third of the edges at one receiver, ends unsorted
        r[rng.random(e) < 0.33] = 5
    elif case == "all-sentinel":
        s[:] = n
        r[:] = n
    elif case == "no-edges":
        s, r = s[:0], r[:0]
    s[e - 30:] = n  # padded tail
    r[e - 30:] = n
    s[rng.random(s.shape[0]) < 0.05] = n
    r[rng.random(r.shape[0]) < 0.05] = n
    if others:  # out-of-range ends other than the sentinel count as it does
        s[rng.random(s.shape[0]) < 0.02] = -1
        r[rng.random(r.shape[0]) < 0.02] = n + 7
    return s, r


def _numpy_segments(idx, n):
    key = np.where((idx >= 0) & (idx < n), idx, n)
    order = np.argsort(key, kind="stable")
    return order, np.searchsorted(key[order], np.arange(n + 1), side="left")


@pytest.mark.parametrize("case", ["random", "hub", "all-sentinel", "no-edges"])
def test_fused_layout_is_a_stable_argsort(rng, case):
    """Both orders and their segments equal numpy's stable argsort of the
    ends, an out-of-range end sorting as N, past offset N; dtypes int32."""
    n = 64
    s, r = _edges(rng, case, n)
    layout = FM.fused_layout(torch.from_numpy(s), torch.from_numpy(r), n)
    for (order, off), idx in (((layout.recv_order, layout.recv_off), r),
                              ((layout.send_order, layout.send_off), s)):
        want_order, want_off = _numpy_segments(idx, n)
        assert order.dtype == off.dtype == torch.int32
        np.testing.assert_array_equal(order.numpy(), want_order)
        np.testing.assert_array_equal(off.numpy(), want_off)
        # Node v's segment holds its edges in edge order, and nothing else.
        for v in range(n):
            seg = order.numpy()[off[v]:off[v + 1]]
            assert (idx[seg] == v).all() and (np.diff(seg) > 0).all()
        assert int(off[n]) == int(((idx >= 0) & (idx < n)).sum())


def _round(rng, mixed):
    n, e, d, de, h, d2 = 64, 300, 16, 16, 32, 16
    # The JAX package's kernels take the sentinel n as the only
    # out-of-range end.
    s, r = _edges(rng, "random" if mixed else "hub", n, e, others=False)
    arrays = (rng.normal(size=(n, d)), rng.normal(size=(e, de)), s, r,
              rng.normal(size=(2 * d + de, h)) * 0.1, rng.normal(size=h) * 0.1,
              rng.normal(size=(h, d2)) * 0.1, rng.normal(size=d2) * 0.1)
    return [np.asarray(a, np.int32 if a.dtype == np.int32 else np.float32)
            for a in arrays] + [np.float32(v) for v in (1.1, 0.05, 0.9, -0.02)]


@pytest.mark.parametrize("mixed", [False, True], ids=["hub", "mixed-sentinel"])
def test_round_with_and_without_layout(rng, mixed):
    """The same agg and the same gradients with the graph's layout and
    without one; agg within the kernel tolerance of the JAX package's
    forward kernel and the gradients within tests/test_pallas.py's of its
    backward kernel (``_backward_impl``), both in interpret mode."""
    args = _round(rng, mixed)
    g = (1e-2 * rng.normal(size=(args[0].shape[0], args[6].shape[1]))).astype(np.float32)
    n = args[0].shape[0]
    layout = FM.fused_layout(torch.from_numpy(args[2]), torch.from_numpy(args[3]), n)

    def port(lay):
        leaves = [torch.from_numpy(a).requires_grad_() for a in (args[0], args[1], *args[4:8])]
        scalars = [torch.tensor([float(v)], requires_grad=True) for v in args[8:]]
        x, ef, w1, b1, w2, b2 = leaves
        out = FM.fused_message_pass(x, ef, torch.from_numpy(args[2]),
                                    torch.from_numpy(args[3]), w1, b1, w2, b2,
                                    *scalars, 0.01, layout=lay)
        return out.detach(), torch.autograd.grad(out, leaves + scalars, torch.from_numpy(g))

    jargs = [jnp.asarray(a) for a in args]
    want = JFM.fused_message_pass(*jargs, 0.01, 256, True)
    want_grads = JFM._backward_impl(*jargs, jnp.asarray(g), slope=0.01,
                                    edge_tile=256, interpret=True)
    (agg_a, grads_a), (agg_b, grads_b) = port(layout), port(None)
    assert torch.equal(agg_a, agg_b)
    np.testing.assert_allclose(agg_a.numpy(), np.asarray(want), rtol=2e-4, atol=2e-5)
    for a, b, w in zip(grads_a, grads_b, want_grads):
        assert torch.equal(a, b)
        np.testing.assert_allclose(a.numpy().reshape(np.shape(w)), np.asarray(w),
                                   rtol=5e-4, atol=5e-5)


def _deploy_recording_layouts(monkeypatch):
    """One deploy forward of the fused tiny model on the CPU: the layouts
    it made and the layout each round was handed."""
    cfg = tiny_test_config()
    model = RadarGNN(cfg, generator=torch.Generator().manual_seed(0)).eval()
    graph, _ = pad_frame(
        SyntheticRadarDataset(cfg, seed=1, num_objects=3).sample_frame(), cfg)
    made, seen = [], []
    make = FM.fused_layout

    def counting_layout(*a):
        made.append(make(*a))
        return made[-1]

    def recording_round(*a, layout=None, **k):
        seen.append(layout)
        return FM.fused_message_pass(*a, layout=layout, **k)

    monkeypatch.setattr(FM, "fused_layout", counting_layout)
    monkeypatch.setattr(blocks, "fused_message_pass", recording_round)
    with torch.no_grad():
        model.deploy(RadarGraph.from_numpy(graph))
    assert len(seen) == len(cfg.graph_convolution_stem_channels)
    return made, seen


def test_model_makes_one_layout_per_graph(monkeypatch):
    """Where the rounds run the kernels, a forward of the fused model sorts
    its graph once and hands that layout to every round (the card's path,
    taken here on the CPU by ``needs_layout``; the plain rounds ignore the
    layout)."""
    monkeypatch.setattr(FM, "needs_layout", lambda x: True)
    made, seen = _deploy_recording_layouts(monkeypatch)
    assert len(made) == 1
    assert all(lay is made[0] for lay in seen)


def test_model_makes_no_layout_on_the_cpu(monkeypatch):
    """On the CPU the plain rounds need no layout: the model sorts nothing
    and hands every round None."""
    made, seen = _deploy_recording_layouts(monkeypatch)
    assert made == [] and all(lay is None for lay in seen)


def test_build_key_covers_the_headers(monkeypatch, tmp_path):
    """The library's key (its file name) changes when a header of csrc/
    changes or is added, and only then: no nvcc needed."""
    for f in _build.CSRC_DIR.iterdir():
        (tmp_path / f.name).write_bytes(f.read_bytes())
    monkeypatch.setattr(_build, "CSRC_DIR", tmp_path)
    names = ("fused_mp", "csr_mp", "microbench_gather")
    before = {name: _build.source_digest(name) for name in names}
    assert before == {name: _build.source_digest(name) for name in names}
    header = tmp_path / "mp_edge_tile.cuh"
    header.write_text(header.read_text() + "\n// edited\n")
    edited = {name: _build.source_digest(name) for name in names}
    assert all(edited[k] != before[k] for k in names)
    (tmp_path / "extra.cuh").write_text("#pragma once\n")
    assert all(_build.source_digest(k) != edited[k] for k in names)
