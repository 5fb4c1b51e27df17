"""The GATv2 round's kernel pair (``ops/gat_mp.py``, ``csrc/gat_mp.cu``)
against the conv's plain path (``models/gat.GATv2Conv._attend``).

On a card (tests marked ``cuda``, skipped without one): the conv's output
and the gradients of x, the edge features and every conv weight at the
published widths and at small ones, on batches of kNN graphs with padded
and masked edges, receivers without a kept edge, sentinel ids and a
receiver whose edges span tiles and blocks; the same bits from two
launches; the same results from a captured CUDA graph; a whole
``RadarGNNv2`` train step on the card against the same step on the CPU.

    python -m pytest --noconftest -q -m cuda tests/test_torch_gat_kernel.py

On the CPU: the conv takes the plain path, which counts ``gat.rounds`` and
no ``gat.fused_rounds``; ``chip_smoke``'s plain round on leaf projections
is that path; ``gat_layout``'s sentinels and orders."""

import math
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from graph_neural_network_for_radar_perception_torch.config.config import tiny_test_config
from graph_neural_network_for_radar_perception_torch.data.pipeline import SyntheticRadarDataset
from graph_neural_network_for_radar_perception_torch.models import gat as G
from graph_neural_network_for_radar_perception_torch.models.blocks import init_parameters
from graph_neural_network_for_radar_perception_torch.ops import gat_mp as GM
from graph_neural_network_for_radar_perception_torch.train import steps as S
from graph_neural_network_for_radar_perception_torch.utils.profiling import TRACER

BENCH_DIR = Path(__file__).resolve().parents[1] / "benchmark"
if str(BENCH_DIR) not in sys.path:
    sys.path.insert(0, str(BENCH_DIR))

from reference import gat as RG  # noqa: E402  (plain PyTorch, no JAX)
from torch_port_fixtures import one_torch_thread  # noqa: E402,F401  (autouse)

# (graphs, nodes, edge capacity, node width, edge width, heads, channels a
# head, hub): the published widths (64 -> 8 heads of 64, edges 64) and small
# ones; "hub" sends a third of a graph's edges to one receiver, so that its
# segment spans tiles and the blocks' shares.
CASES = {
    "published": (2, 768, 10240, 64, 64, 8, 64, False),
    "published_hub": (2, 768, 10240, 64, 64, 8, 64, True),
    "small": (3, 64, 768, 16, 16, 4, 8, False),
    "small_hub": (1, 64, 768, 16, 16, 4, 8, True),
}
# The kernels and the plain path in f32 against the plain path in float64
# on the same inputs: the kernels sum in other orders (the edge projection
# over De, the logits over C, the aggregate and the weight gradients over
# the edges), and a receiver of thousands of edges amplifies the rounding
# of its inputs on either path (the hub: the plain path's x and weight
# gradients lie 1e-4 to 6e-4 of their largest element off float64).  Each
# tensor's largest error is held within twice the plain path's, plus ATOL
# of its largest element.
ATOL = 2e-5


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card and nvcc")
    return torch.device("cuda")


def _knn_graph(rng, n, e_cap, k=6):
    """A padded kNN graph: ~85 % of n nodes live, each live node's k nearest
    live nodes as senders (both directions kept: an edge and its reverse),
    edges past the live ones padded with 0 and masked, as ``pad_frame``
    pads them."""
    live = int(n * 0.85)
    pts = rng.normal(size=(live, 2))
    d = ((pts[:, None] - pts[None]) ** 2).sum(-1)
    np.fill_diagonal(d, np.inf)
    nbr = np.argsort(d, axis=1)[:, :k]
    s = np.repeat(np.arange(live), k)
    r = nbr.reshape(-1)
    s, r = np.concatenate([s, r]), np.concatenate([r, s])
    s, r = s[: e_cap], r[: e_cap]
    senders = np.zeros(e_cap, np.int64)
    receivers = np.zeros(e_cap, np.int64)
    senders[: len(s)], receivers[: len(r)] = s, r
    mask = np.zeros(e_cap, bool)
    mask[: len(s)] = True
    return senders, receivers, mask


def _problem(case, seed):
    """x, ef, senders, receivers, node_mask, edge_mask of a batch (CPU
    tensors), and the ids the plain path takes (masked edges at 0)."""
    b, n, e_cap, d, de, heads, c, hub = CASES[case]
    rng = np.random.default_rng(seed)
    s, r, m = zip(*(_knn_graph(rng, n, e_cap) for _ in range(b)))
    s, r, m = np.stack(s), np.stack(r), np.stack(m)
    if hub:  # a third of graph 0's edges into receiver 5
        pick = rng.random(e_cap) < 1 / 3
        r[0, pick & m[0]] = 5
    # some live edges masked, so that a few receivers keep no edge at all
    m &= rng.random(m.shape) > 0.05
    m &= ~np.isin(r, [11])
    # sentinel ids on a share of the masked edges (the kernel must skip them)
    sent = (~m) & (rng.random(m.shape) < 0.5)
    s_k, r_k = s.copy(), r.copy()
    s_k[sent], r_k[sent] = n, n + 3
    x = torch.from_numpy(rng.normal(size=(b, n, d)).astype(np.float32))
    ef = torch.from_numpy(rng.normal(size=(b, e_cap, de)).astype(np.float32))
    nm = torch.ones(b, n, dtype=torch.bool)
    t = lambda a: torch.from_numpy(a)  # noqa: E731
    return (x, ef, t(s_k).int(), t(r_k).int(), nm, t(m)), (t(s).int(), t(r).int())


def _conv(case, seed=0):
    _, _, _, d, de, heads, c, _ = CASES[case]
    conv = G.GATv2Conv(d, de, c, heads)
    init_parameters(conv, torch.Generator().manual_seed(seed))
    with torch.no_grad():  # a bias that is not 0, so that its gradient and out's shift show
        conv.bias.uniform_(-0.5, 0.5, generator=torch.Generator().manual_seed(seed + 1))
    return conv


def _run(conv, inputs, g_out, attend=False):
    """out and the gradients of x, ef and every conv weight for the
    cotangent g_out: the conv's route, or with ``attend`` its plain path."""
    x, ef, s, r, nm, em = (t.clone().requires_grad_(t.is_floating_point()) for t in inputs)
    out = (conv._attend(x, ef, s, r, em) if attend
           else conv(x, ef, s, r, nm, em))
    grads = torch.autograd.grad(out, [x, ef, *conv.parameters()], g_out)
    return [out.detach()] + list(grads)


def _names(conv):
    return ["out", "x", "edge_feat"] + [n for n, _ in conv.named_parameters()]


def _card_and_plain(case, device, seed=0):
    inputs, plain_ids = _problem(case, seed)
    conv = _conv(case)
    g_out = torch.from_numpy(np.random.default_rng(seed + 7).normal(
        size=tuple(inputs[0].shape[:2]) + (conv.bias.numel(),)).astype(np.float32))
    ref_inputs = list(inputs)
    ref_inputs[2:4] = plain_ids
    plain = _run(conv, ref_inputs, g_out, attend=True)
    ref = _run(conv.double(), [t.double() if t.is_floating_point() else t for t in ref_inputs],
               g_out.double(), attend=True)
    conv = conv.float().to(device)
    got = _run(conv, [t.to(device) for t in inputs], g_out.to(device))
    return conv, got, plain, ref


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(CASES))
def test_kernel_round_matches_plain_path(cuda_device, case):
    """out and the gradients of x, ef and every conv weight, the kernel
    pair against the plain path in float64; padded, masked and sentinel
    edges and receivers without edges (out = bias there)."""
    launches = (GM.gat_round.launches, GM.gat_round.backward_launches)
    conv, got, plain, ref = _card_and_plain(case, cuda_device)
    assert (GM.gat_round.launches, GM.gat_round.backward_launches) == (
        launches[0] + 1, launches[1] + 1)
    for name, g, p, want in zip(_names(conv), got, plain, ref):
        scale = float(want.abs().max())
        err = float((g.double().cpu() - want).abs().max())
        err_plain = float((p.double() - want).abs().max())
        assert err <= 2 * err_plain + ATOL * scale, (name, err, err_plain, scale)
    # receiver 11 keeps no edge in any graph: its output is the bias
    torch.testing.assert_close(got[0][:, 11].cpu(), conv.bias.detach().cpu().expand(
        got[0].shape[0], -1), rtol=0, atol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["published_hub", "small"])
def test_kernel_round_is_bitwise_repeatable(cuda_device, case):
    inputs, _ = _problem(case, 3)
    conv = _conv(case).to(cuda_device)
    inputs = [t.to(cuda_device) for t in inputs]
    g_out = torch.randn(inputs[0].shape[:2] + (conv.bias.numel(),), device=cuda_device,
                        generator=torch.Generator(cuda_device).manual_seed(5))
    first, second = _run(conv, inputs, g_out), _run(conv, inputs, g_out)
    for name, a, b in zip(_names(conv), first, second):
        assert torch.equal(a, b), name


@pytest.mark.cuda
def test_single_graph_is_a_batch_of_one(cuda_device):
    inputs, _ = _problem("small", 4)
    conv = _conv("small").to(cuda_device)
    inputs = [t.to(cuda_device) for t in inputs]
    g_out = torch.randn(inputs[0].shape[:2] + (conv.bias.numel(),), device=cuda_device)
    batched = _run(conv, [t[1:2] for t in inputs], g_out[1:2])
    single = _run(conv, [t[1] for t in inputs], g_out[1])
    for name, a, b in zip(_names(conv), batched, single):
        torch.testing.assert_close(a[0] if name in ("out", "x", "edge_feat") else a, b,
                                   rtol=1e-6, atol=1e-7, msg=name)


@pytest.mark.cuda
def test_kernel_round_in_a_captured_graph(cuda_device):
    """The conv's forward and its gradients captured in a CUDA graph and
    replayed on new inputs give what the same work gives eagerly."""
    conv = _conv("published").to(cuda_device)
    params = list(conv.parameters())
    first, _ = _problem("published", 1)
    second, _ = _problem("published", 2)
    static = [t.to(cuda_device) for t in first]
    g_out = torch.randn(static[0].shape[:2] + (conv.bias.numel(),), device=cuda_device)
    x, ef = (static[i].clone().requires_grad_() for i in (0, 1))

    def body():
        out = conv(x, ef, *static[2:])
        return [out] + list(torch.autograd.grad(out, [x, ef, *params], g_out))

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(2):
            body()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = body()
    with torch.no_grad():
        for i, t in enumerate(second):
            (x if i == 0 else ef if i == 1 else static[i]).copy_(t.to(cuda_device))
    graph.replay()
    torch.cuda.synchronize()
    eager = _run(conv, [t.to(cuda_device) for t in second], g_out)
    for name, a, b in zip(_names(conv), captured, eager):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-7, msg=name)


# --------------------------------------------------------- a whole train step
GAT_TINY = dict(hidden_node_channels_gat=32, num_heads_gat=4)


def _weights(cfg, seed):
    """The benchmark's draw (``test_torch_gat_train._weights``): every
    Linear U(+-1/sqrt(fan_in)), the heads' output layers too, so that the
    loss depends on the trunk."""
    rcfg = {k: (list(v) if isinstance(v, tuple) else v) for k, v in vars(cfg).items()}
    specs = RG.param_specs(rcfg)
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


@pytest.mark.cuda
def test_v2_train_step_on_card_matches_cpu(cuda_device):
    """Three ``RadarGNNv2`` train steps through the kernel pair on the card
    against the same steps through the plain path on the CPU, from the
    benchmark's weights: the loss terms of each step, the first gradient
    (from the momentum after one step) and the parameters after three."""
    cfg = tiny_test_config(**GAT_TINY)
    weights = _weights(cfg, seed=11)
    it = SyntheticRadarDataset(cfg, seed=3, num_objects=(2, 5)).packed_batches(2)
    batches = [next(it) for _ in range(3)]
    runs = {}
    for device in ("cpu", cuda_device):
        step = S.make_train_step(cfg)
        state = S.create_train_state(cfg, torch.Generator().manual_seed(0), device=device,
                                     model_cls=G.RadarGNNv2)
        with torch.no_grad():
            for k, p in state.model.named_parameters():
                p.copy_(weights[k])
        before = GM.gat_round.launches
        metrics = []
        for i, batch in enumerate(batches):
            state, m = step(state, batch)
            metrics.append({k: float(v) for k, v in m.items()})
            if i == 0:
                mom = {k: state.optimizer.state[p]["momentum_buffer"].cpu().clone()
                       for k, p in state.model.named_parameters()}
        params = {k: p.detach().cpu() for k, p in state.model.named_parameters()}
        runs[str(device)] = (metrics, mom, params, GM.gat_round.launches - before)
    (m_cpu, g_cpu, p_cpu, n_cpu), (m_gpu, g_gpu, p_gpu, n_gpu) = runs["cpu"], runs["cuda"]
    assert n_cpu == 0 and n_gpu > 0
    for a, b in zip(m_gpu, m_cpu):
        assert a["skipped"] == 0.0
        for k, v in b.items():
            assert a[k] == pytest.approx(v, rel=2e-5, abs=1e-7), k
    scales = {k: float(g.abs().max()) for k, g in g_cpu.items()}
    median = float(np.median(list(scales.values())))
    for k, g in g_cpu.items():
        gap = float((g_gpu[k] - g).abs().max())
        assert gap <= 1e-4 * max(scales[k], median), (k, gap, scales[k], median)
    for k, p in p_cpu.items():
        np.testing.assert_allclose(p_gpu[k].numpy(), p.numpy(), rtol=0, atol=1e-5, err_msg=k)


# ------------------------------------------------------------------ the CPU
def test_conv_on_cpu_takes_the_plain_path_and_counts_no_fused_round():
    """With the tracer on, a CPU conv counts ``gat.rounds`` as before and no
    ``gat.fused_rounds``, launches nothing and gives ``_attend``'s bits."""
    inputs, _ = _problem("small", 6)
    inputs = [t.clamp(max=63) if t.dtype == torch.int32 else t for t in inputs]
    conv = _conv("small")
    launches = (GM.gat_round.launches, GM.gat_round.backward_launches)
    TRACER.disable()
    TRACER.drain()
    TRACER.enable()
    try:
        got = conv(*inputs)
        again = conv(*inputs)
        counters = TRACER.drain()["counters"]
    finally:
        TRACER.disable()
        TRACER.drain()
    assert counters["gat.rounds"] == 2
    assert counters.get("gat.fused_rounds", 0) == 0
    assert (GM.gat_round.launches, GM.gat_round.backward_launches) == launches
    x, ef, s, r, _, em = inputs
    assert torch.equal(got, conv._attend(x, ef, s, r, em)) and torch.equal(got, again)


@pytest.mark.parametrize("case", ["small", "small_hub"])
def test_chip_smoke_plain_round_is_the_conv_plain_path(case):
    """``chip_smoke``'s [kernel-gat] holds the kernel pair to
    ``_plain_gat_round``, the plain path on leaves xl, xr, ef and the
    weights: it gives ``GATv2Conv._attend``'s bits, and its gradients
    carried back through the projections are the conv's."""
    from chip_smoke import _plain_gat_round

    inputs, plain_ids = _problem(case, 8)
    conv = _conv(case)
    x, ef, _, _, _, em = inputs
    s, r = plain_ids
    g_out = torch.randn(x.shape[:2] + (conv.bias.numel(),),
                        generator=torch.Generator().manual_seed(9))
    params = list(conv.parameters())
    want = _run(conv, [x, ef, s, r, inputs[4], em], g_out, attend=True)
    x_leaf, ef_leaf = x.clone().requires_grad_(), ef.clone().requires_grad_()
    out = _plain_gat_round(conv, conv.lin_l(x_leaf), conv.lin_r(x_leaf), ef_leaf,
                           conv.lin_edge.weight, conv.lin_edge.bias, conv.att, conv.bias,
                           s, r, em)
    got = [out.detach()] + list(torch.autograd.grad(out, [x_leaf, ef_leaf, *params], g_out))
    for name, a, b in zip(_names(conv), got, want):
        assert torch.equal(a, b), name


def test_gat_round_has_no_cpu_version():
    inputs, _ = _problem("small", 1)
    conv = _conv("small")
    x, ef, s, r, _, em = inputs
    with pytest.raises(ValueError, match="no kernel for device cpu"):
        GM.gat_round(conv.lin_l(x), conv.lin_r(x), ef, conv.lin_edge.weight,
                     conv.lin_edge.bias, conv.att, conv.bias,
                     GM.gat_layout(s, r, em, x.shape[1]))


def test_gat_layout_sends_every_edge_without_a_part_to_the_sentinel():
    """An edge takes part when its mask is set and both ends lie in [0, N):
    the others get N at both ends and sort past every segment; the kept
    edges' segments are their receivers' and senders', in edge order."""
    n = 6
    s = torch.tensor([[0, 1, 2, 7, 3, 4, 5, -1, 2]], dtype=torch.int32)
    r = torch.tensor([[1, 1, 0, 2, 8, 1, 5, 3, 4]], dtype=torch.int32)
    m = torch.tensor([[1, 1, 1, 1, 1, 0, 1, 1, 1]], dtype=torch.bool)
    lay = GM.gat_layout(s, r, m, n)
    keep = torch.tensor([[1, 1, 1, 0, 0, 0, 1, 0, 1]], dtype=torch.bool)
    assert torch.equal(lay.senders, torch.where(keep, s, torch.full_like(s, n)))
    assert torch.equal(lay.receivers, torch.where(keep, r, torch.full_like(r, n)))
    order = lay.order
    assert order.recv_off[0, -1] == order.send_off[0, -1] == int(keep.sum())
    for v in range(n):
        by_r = order.recv_order[0, order.recv_off[0, v]:order.recv_off[0, v + 1]].tolist()
        by_s = order.send_order[0, order.send_off[0, v]:order.send_off[0, v + 1]].tolist()
        assert by_r == [i for i in range(9) if keep[0, i] and r[0, i] == v]
        assert by_s == [i for i in range(9) if keep[0, i] and s[0, i] == v]
