"""The port's CUDA kernels on a card, against their plain PyTorch versions,
the training step on the card against the same on the CPU, and the captured
steps and detector against the same work run eagerly.

Imports nothing of JAX, so that it runs on a machine without it:

    python -m pytest --noconftest -q -m cuda tests/test_torch_cuda.py

Every test skips without a CUDA card."""

import copy
import dataclasses

import numpy as np
import pytest
import torch

from chip_smoke import (
    FWD_WIDE,
    banded_edges,
    bf16_verdict,
    csr_problem,
    drop_kink_edges,
    drop_kink_edges_csr,
    knn_edges,
)
from graph_neural_network_for_radar_perception_torch.config.config import (
    GNNConfig,
    tiny_test_config,
)
from graph_neural_network_for_radar_perception_torch.core.graph import RadarGraph
from graph_neural_network_for_radar_perception_torch.data.pipeline import (
    SyntheticRadarDataset,
    pad_frame,
)
from graph_neural_network_for_radar_perception_torch.infer.pipeline import FrameDetector
from graph_neural_network_for_radar_perception_torch.models import gat as G
from graph_neural_network_for_radar_perception_torch.models.gnn import RadarGNN
from graph_neural_network_for_radar_perception_torch.ops import csr_mp as C
from graph_neural_network_for_radar_perception_torch.ops import fused_mp as FM
from graph_neural_network_for_radar_perception_torch.scripts import (
    microbench_gather as MB,
)
from graph_neural_network_for_radar_perception_torch.train import finetune as FT
from graph_neural_network_for_radar_perception_torch.train import steps as S
from graph_neural_network_for_radar_perception_torch.utils.profiling import TRACER

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card and nvcc")
    return torch.device("cuda")


def _problem(seed, n, e, d, de, h, d2, device, hub=False):
    """Random round with sentinel padding and one-sided sentinels; ``hub``
    sends a third of the edges to receiver 5 (a segment of ~E/3 edges)."""
    rng = np.random.default_rng(seed)
    s = rng.integers(0, n, size=e).astype(np.int32)
    r = rng.integers(0, n, size=e).astype(np.int32)
    if hub:
        r[rng.random(e) < 0.33] = 5
    pad = rng.random(e) < 0.1
    s[pad] = n
    r[pad] = n
    s[rng.random(e) < 0.1] = n
    r[rng.random(e) < 0.05] = n
    arrays = [
        rng.normal(size=(n, d)), rng.normal(size=(e, de)), s, r,
        rng.normal(size=(2 * d + de, h)) * 0.1, rng.normal(size=h) * 0.1,
        rng.normal(size=(h, d2)) * 0.1, rng.normal(size=d2) * 0.1,
    ]
    out = [torch.from_numpy(np.asarray(a, np.int32 if a.dtype == np.int32
                                       else np.float32)).to(device)
           for a in arrays]
    return out + [1.1, 0.05, 0.9, -0.02]


FUSED_SHAPES = {
    "deploy": dict(n=768, e=15360, d=64, de=64, h=128, d2=64),
    "ragged": dict(n=768, e=15357, d=64, de=64, h=128, d2=64),  # ragged E
    "tiny": dict(n=64, e=300, d=16, de=16, h=32, d2=16),        # tiny_test_config
    "hub": dict(n=768, e=15360, d=64, de=64, h=128, d2=64, hub=True),
}
# The forwards' edge kernel also at the narrow and wide ends of the widths
# and at widths that are no power of two, and its (tile, input stages) on
# an H100 (227 KB of shared memory a block) where they are not (32, 2).
FWD_SHAPES = {
    **FUSED_SHAPES,
    "narrow-h": dict(n=64, e=300, d=16, de=16, h=32, d2=64),     # H < D2
    "wide-h": dict(n=256, e=3001, d=64, de=64, h=256, d2=64),    # one stage
    "wide-t16": dict(n=256, e=3001, d=64, de=96, h=256, d2=64),  # 16-edge tiles
    "wide-t8": dict(n=256, e=3001, d=64, de=64, h=256, d2=128),  # 8-edge tiles
    "odd": dict(n=256, e=3001, d=64, de=48, h=96, d2=96),        # 3 x 32 columns
}
FWD_PLANS = {"wide-h": (32, 1), "wide-t16": (16, 1), "wide-t8": (8, 1)}


@pytest.mark.parametrize("shape", list(FWD_SHAPES))
def test_kernel_matches_plain(cuda_device, shape):
    """The fused forward against its plain version, one count a call, at
    the tile and input stages its plan takes (FWD_PLANS)."""
    sh = FWD_SHAPES[shape]
    args = _problem(0, device=cuda_device, **sh)
    before = FM.fused_message_pass.launches
    got = FM.fused_message_pass(*args, 0.01)
    torch.cuda.synchronize()
    assert FM.fused_message_pass.launches == before + 1
    want = FM.fused_message_pass_reference(*args, 0.01)
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(),
                               rtol=2e-4, atol=2e-5)
    plan = FM._forward_plan(sh["n"], sh["e"], sh["de"], sh["h"], sh["d2"], cuda_device)
    assert (plan.tile, plan.stages) == FWD_PLANS.get(shape, (32, 2))


def test_deploy_on_card_matches_cpu(cuda_device):
    cfg = tiny_test_config()
    model = RadarGNN(cfg, generator=torch.Generator().manual_seed(0)).eval()
    graph, _ = pad_frame(
        SyntheticRadarDataset(cfg, seed=1, num_objects=3).sample_frame(), cfg)
    with torch.no_grad():
        want = model.deploy(RadarGraph.from_numpy(graph))
        before = FM.fused_message_pass.launches
        got = model.to(cuda_device).deploy(RadarGraph.from_numpy(graph, cuda_device))
        torch.cuda.synchronize()
    rounds = len(cfg.graph_convolution_stem_channels)
    assert FM.fused_message_pass.launches == before + rounds
    nm = graph.node_mask
    for name in ("node_cls", "node_offsets", "centers"):
        np.testing.assert_allclose(getattr(got, name).cpu().numpy()[nm],
                                   getattr(want, name).numpy()[nm],
                                   rtol=1e-3, atol=1e-4, err_msg=name)
    np.testing.assert_array_equal(got.node2cluster.cpu().numpy(),
                                  want.node2cluster.numpy())


@pytest.mark.parametrize("shape", [
    dict(n=768, e=15360, d=64, de=64, h=128, d2=64),   # main-path shapes
    dict(n=768, e=15357, d=64, de=64, h=128, d2=64),   # ragged E
    dict(n=64, e=300, d=16, de=16, h=32, d2=16),       # tiny_test_config
    FUSED_SHAPES["hub"],
    dict(n=256, e=3001, d=64, de=64, h=256, d2=64),    # 16-edge tiles
    dict(n=256, e=3001, d=64, de=96, h=256, d2=64),    # 8-edge tiles
    dict(n=256, e=3001, d=64, de=64, h=128, d2=128),   # two weight-gradient items
    dict(n=64, e=300, d=16, de=16, h=32, d2=64),       # H < D2
    FWD_SHAPES["odd"],
], ids=["main", "ragged", "tiny", "hub", "wide-h", "wide-t8", "wide-d2", "narrow-h", "odd"])
def test_backward_kernel_matches_plain(cuda_device, shape):
    """All 11 outputs at the JAX package's gradient tolerance, with a
    cotangent of a train step's scale (1e-2)."""
    # Edges at a leaky-ReLU kink may fall on either side in two summation
    # orders: dropped, as chip_smoke.py drops them.
    args, _ = drop_kink_edges(torch, _problem(1, device=cuda_device, **shape))
    g = torch.from_numpy((1e-2 * np.random.default_rng(2).normal(
        size=(shape["n"], shape["d2"]))).astype(np.float32)).to(cuda_device)
    before = FM.fused_message_pass_backward.launches
    got = FM.fused_message_pass_backward(*args, g, 0.01)
    torch.cuda.synchronize()
    assert FM.fused_message_pass_backward.launches == before + 1
    want = FM.fused_message_pass_backward_reference(*args, g, 0.01)
    names = "gef dxa dxb dw1e db1 dw2 db2 dg1 dbe1 dg2 dbe2".split()
    for name, a, b in zip(names, got, want):
        np.testing.assert_allclose(a.cpu().numpy(), b.cpu().numpy(),
                                   rtol=5e-4, atol=5e-5, err_msg=name)


FUSED_BWD_NAMES = "gef dxa dxb dw1e db1 dw2 db2 dg1 dbe1 dg2 dbe2".split()

@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
@pytest.mark.parametrize("shape", list(FWD_SHAPES))
def test_fused_forward_is_bitwise_repeatable(cuda_device, shape, bf16):
    """The forward sums each receiver's messages in a fixed order: two
    launches, and a launch with the graph's layout made beforehand, give
    the same bits."""
    args = _problem(3, device=cuda_device, **FWD_SHAPES[shape])
    layout = FM.fused_layout(args[2], args[3], args[0].shape[0])
    a = FM.fused_message_pass(*args, 0.01, bf16)
    b = FM.fused_message_pass(*args, 0.01, bf16)
    c = FM.fused_message_pass(*args, 0.01, bf16, layout=layout)
    torch.cuda.synchronize()
    assert torch.equal(a, b) and torch.equal(a, c)


@pytest.mark.parametrize("shape", list(FUSED_SHAPES))
def test_fused_backward_is_bitwise_repeatable(cuda_device, shape):
    """All 11 outputs of the backward's C call are fixed-order sums: two
    launches give the same bits."""
    sh = FUSED_SHAPES[shape]
    args = _problem(4, device=cuda_device, **sh)
    g = torch.from_numpy((1e-2 * np.random.default_rng(5).normal(
        size=(sh["n"], sh["d2"]))).astype(np.float32)).to(cuda_device)
    a = FM.fused_message_pass_backward(*args, g, 0.01)
    b = FM.fused_message_pass_backward(*args, g, 0.01)
    torch.cuda.synchronize()
    for name, x, y in zip(FUSED_BWD_NAMES, a, b):
        assert torch.equal(x, y), name


def test_fused_round_without_edges(cuda_device):
    """E = 0: the forward writes zero rows and the backward zero
    cotangents, one launch each, nothing zeroed by the wrapper."""
    args = _problem(6, n=64, e=0, d=16, de=16, h=32, d2=16, device=cuda_device)
    before = (FM.fused_message_pass.launches, FM.fused_message_pass_backward.launches)
    agg = FM.fused_message_pass(*args, 0.01)
    out = FM.fused_message_pass_backward(*args, torch.ones(64, 16, device=cuda_device), 0.01)
    torch.cuda.synchronize()
    assert (FM.fused_message_pass.launches, FM.fused_message_pass_backward.launches) == (
        before[0] + 1, before[1] + 1)
    assert agg.shape == (64, 16) and not agg.any()
    assert out[0].shape == (0, 16)
    for name, v in zip(FUSED_BWD_NAMES[1:], out[1:]):
        assert not v.any(), name


def _tiny_batch(cfg, seed=1):
    return next(SyntheticRadarDataset(cfg, seed=seed, num_objects=3).batches(cfg.batch_size))


def test_model_gradients_on_card_match_cpu(cuda_device):
    """Every parameter's gradient (the message MLPs and the edge encoder
    included: the rounds are differentiable through the kernels)."""
    cfg = tiny_test_config()
    batch = _tiny_batch(cfg)
    grads = {}
    for device in ("cpu", cuda_device):
        st = S.create_train_state(cfg, torch.Generator().manual_seed(0), device=device)
        before = (FM.fused_message_pass.launches, FM.fused_message_pass_backward.launches)
        loss, _ = S.make_loss_fn(cfg)(st.model, S.batch_on(batch, device))
        loss.backward()
        after = (FM.fused_message_pass.launches, FM.fused_message_pass_backward.launches)
        grads[str(device)] = {k: p.grad.cpu().numpy() for k, p in st.model.named_parameters()}
    rounds = len(cfg.graph_convolution_stem_channels)  # one launch a round for the batch
    assert after == (before[0] + rounds, before[1] + rounds)
    for k, want in grads["cpu"].items():
        np.testing.assert_allclose(grads["cuda"][k], want, rtol=1e-3,
                                   atol=1e-4 * np.abs(want).max(), err_msg=k)


def test_train_step_on_card_matches_cpu(cuda_device):
    cfg = tiny_test_config()
    batch = _tiny_batch(cfg, seed=4)
    out = {}
    for device in ("cpu", cuda_device):
        st = S.create_train_state(cfg, torch.Generator().manual_seed(0), device=device)
        st, m = S.make_train_step(cfg)(st, batch)
        out[str(device)] = (st.model.state_dict(), {k: float(v) for k, v in m.items()})
    (p_gpu, m_gpu), (p_cpu, m_cpu) = out["cuda"], out["cpu"]
    assert m_gpu["skipped"] == 0.0
    for k, v in m_cpu.items():
        np.testing.assert_allclose(m_gpu[k], v, rtol=1e-3, atol=1e-4, err_msg=k)
    for k, v in p_cpu.items():
        np.testing.assert_allclose(p_gpu[k].cpu().numpy(), v.numpy(),
                                   rtol=1e-3, atol=1e-5, err_msg=k)


def _batched_launches(launch, graphs, stacked):
    """One C call over ``graphs`` graphs (``launch(None)``) against one call
    a graph (``launch(g)``), each → (call, results): the first ``stacked``
    results bitwise equal graph by graph, the rest (weight gradients)
    within 1e-6 of the graphs' sum, relative to the largest element of the
    graphs' summed magnitudes (the scale of a reassociated sum's rounding;
    the sum itself may cancel, as the norm scalars' do)."""
    call, results = launch(None)
    assert call() == 0
    each = []
    for g in range(graphs):
        c, r = launch(g)
        assert c() == 0
        each.append(r())
    torch.cuda.synchronize()
    got = results()
    for i, t in enumerate(got):
        if i < stacked:
            for g in range(graphs):
                assert torch.equal(t[g], each[g][i][0]), (i, g)
        else:
            want = each[0][i]
            for e in each[1:]:
                want = want + e[i]
            scale = each[0][i].abs()
            for e in each[1:]:
                scale = scale + e[i].abs()
            assert float((t - want).abs().max()) <= 1e-6 * float(scale.max()), i


@pytest.mark.parametrize("shape", ["deploy", "tiny"])
def test_batched_fused_launch_equals_one_graph_launches(cuda_device, shape):
    """The fused round's forward (f32 and bf16) and backward over 8 graphs
    in one C call equal 8 calls of one graph on the same inputs: agg,
    msgs, gef, dxa and dxb bitwise, the weight gradients within 1e-6 of
    their sum; the batch's layout is each graph's."""
    probs = [_problem(30 + g, device=cuda_device, **FUSED_SHAPES[shape]) for g in range(8)]
    x, ef, s, r = (torch.stack([p[i] for p in probs]) for i in range(4))
    w1, b1, w2, b2 = probs[0][4:8]
    scal = torch.tensor(probs[0][8:], device=cuda_device)
    n, d = x.shape[1], x.shape[2]
    layout = FM.fused_layout(s, r, n)
    for g in range(8):
        assert all(torch.equal(a[g], b) for a, b in zip(layout, FM.fused_layout(s[g], r[g], n)))
    xa, xb = x @ w1[:d], x @ w1[d:2 * d]
    gout = 1e-2 * torch.randn(8, n, w2.shape[1], device=cuda_device,
                              generator=torch.Generator(cuda_device).manual_seed(3))

    def sl(g):
        return slice(None) if g is None else slice(g, g + 1)

    def lay(g):
        return layout if g is None else type(layout)(*(t[g:g + 1] for t in layout))

    for bf16 in (False, True):
        def fwd(g):
            raw, outs = FM._forward_launch(x[sl(g)], ef[sl(g)], s[sl(g)], r[sl(g)], w1, b1, w2,
                                           b2, scal, 0.01, lay(g), (xa[sl(g)], xb[sl(g)]))
            # msgs: a scratch; only the rows of the edges that land are written
            lands = ((r[sl(g)] >= 0) & (r[sl(g)] < n))[..., None]
            return (lambda: FM._kernel(bf16)(*raw)), (
                lambda: (torch.where(lands, outs[0], 0.0), outs[1]))
        _batched_launches(fwd, 8, 2)

    def bwd(g):
        raw, results = FM._backward_launch(x[sl(g)], ef[sl(g)], s[sl(g)], r[sl(g)], lay(g), w1,
                                           b1, w2, b2, scal, gout[sl(g)].contiguous(), 0.01,
                                           (xa[sl(g)], xb[sl(g)]))
        return (lambda: FM._bwd_kernel()(*raw)), results
    _batched_launches(bwd, 8, 3)


@pytest.mark.parametrize("case", ["knn", "tiny"])
def test_batched_csr_launch_equals_one_graph_launches(cuda_device, case):
    """The same for the CSR round: forward (f32 and bf16) and backward over
    8 graphs in one C call against 8 calls of one graph; the batch's
    layout is each graph's."""
    probs = [_csr_case(case, 40 + g, cuda_device)[0] for g in range(8)]
    tiling = _csr_case(case, 40, cuda_device)[1]
    x, ef, src, dst = (torch.stack([p[i] for p in probs]) for i in range(4))
    w1, b1, w2, b2 = probs[0][4:8]
    scal = torch.cat(probs[0][8:])
    n = x.shape[1]
    layout = C.csr_layout(src, dst, n, *tiling)
    for g in range(8):
        one = C.csr_layout(src[g], dst[g], n, *tiling)
        assert all(torch.equal(a[g], b) for a, b in zip(layout, one) if torch.is_tensor(b))
    gout = 1e-2 * torch.randn(8, n, w2.shape[1], device=cuda_device,
                              generator=torch.Generator(cuda_device).manual_seed(4))

    def sl(g):
        return slice(None) if g is None else slice(g, g + 1)

    def lay(g):
        return layout if g is None else type(layout)(
            *(t[g:g + 1] if torch.is_tensor(t) else t for t in layout))

    for bf16 in (False, True):
        def fwd(g):
            raw, outs = C._forward_launch(x[sl(g)], ef[sl(g)], lay(g), w1, b1, w2, b2, scal, 0.01)
            lands = (lay(g).dst < n)[..., None]
            return (lambda: C._kernel(bf16)(*raw)), (
                lambda: (torch.where(lands, outs[0], 0.0), outs[1]))
        _batched_launches(fwd, 8, 2)

    def bwd(g):
        raw, results = C._backward_launch(x[sl(g)], ef[sl(g)], lay(g), w1, b1, w2, b2, scal,
                                          gout[sl(g)].contiguous(), 0.01)
        return (lambda: C._bwd_kernel()(*raw)), results
    _batched_launches(bwd, 8, 2)


@pytest.mark.parametrize("mp_impl, bf16", [(None, False), ("csr", False), (None, True)],
                         ids=["fused", "csr", "fused-bf16"])
def test_captured_step_equals_eager_step(cuda_device, mp_impl, bf16):
    """Three train steps replayed from one captured CUDA graph against the
    same step run eagerly on the card from the same seed: metrics and
    params within 1e-5 (the index_add_ sums of the heads' backward use
    atomics; 1e-4 with bf16 operands, where two sums that differ in the
    last bit can round to neighbouring bf16 values); one capture, three
    replays, one launch of each kernel a round a step."""
    tol = dict(rtol=1e-4, atol=1e-5) if bf16 else dict(rtol=1e-5, atol=1e-6)
    cfg = tiny_test_config(csr_edge_tile=128, csr_window=64)
    batches = [_tiny_batch(cfg, seed=s) for s in (4, 5, 6)]
    step, loss_fn = S.make_train_step(cfg, mp_impl, bf16), S.make_loss_fn(cfg, mp_impl, bf16)
    cap = S.create_train_state(cfg, torch.Generator().manual_seed(0), device=cuda_device)
    eager = S.create_train_state(cfg, torch.Generator().manual_seed(0), device=cuda_device)
    kernel = C.fused_message_pass_csr if mp_impl == "csr" else FM.fused_message_pass
    counter = "launches_bf16" if bf16 else "launches"
    before = getattr(kernel, counter)
    for batch in batches:
        cap, m_cap = step(cap, batch)
        m_eager = S._train_body(eager, S.batch_on(batch, cuda_device), loss_fn, cfg)
        for k, v in m_eager.items():
            np.testing.assert_allclose(float(m_cap[k]), float(v), **tol, err_msg=k)
    rounds = len(cfg.graph_convolution_stem_channels)
    assert step.captured.replays == 3 and len(step.captured.graphs) == 1
    # the eager steps launched 3 a round too
    assert getattr(kernel, counter) - before == rounds * (3 + S.CapturedStep.WARMUP_RUNS + 3)
    assert (cap.step, cap.updates) == (eager.step, eager.updates) == (3, 3)
    want = eager.model.state_dict()
    for k, v in cap.model.state_dict().items():
        np.testing.assert_allclose(v.cpu().numpy(), want[k].cpu().numpy(), **tol, err_msg=k)


def test_captured_nan_skip_keeps_the_state(cuda_device):
    """A NaN batch through a replay of the captured step: skipped, and the
    parameters, the momentum and the update count bitwise unchanged."""
    cfg = tiny_test_config()
    batch = _tiny_batch(cfg, seed=4)
    step = S.make_train_step(cfg)
    st = S.create_train_state(cfg, torch.Generator().manual_seed(0), device=cuda_device)
    st, _ = step(st, batch)
    flat, mom = st.optimizer.flat.clone(), st.optimizer.moments["momentum_buffer"].clone()
    node_feat = batch.graph.node_feat.copy()
    node_feat[0, 0, 0] = np.nan
    bad = dataclasses.replace(batch, graph=dataclasses.replace(batch.graph, node_feat=node_feat))
    st, m = step(st, bad)
    assert float(m["skipped"]) == 1.0 and step.captured.replays == 2
    assert torch.equal(st.optimizer.flat, flat)
    assert torch.equal(st.optimizer.moments["momentum_buffer"], mom)
    assert (st.step, st.updates) == (2, 1)


@pytest.mark.parametrize("mp_impl, from_links", [(None, False), ("csr", False), (None, True)],
                         ids=["fused", "csr", "fused-links"])
def test_captured_detector_equals_eager_deploy(cuda_device, mp_impl, from_links):
    """``FrameDetector`` on the card (deploy and softmax one captured CUDA
    graph) over 3 frames, DBSCAN over centers or over predicted links,
    against the eager ``RadarGNN.deploy`` of the same weights on the card: node classes, DBSCAN partitions, cluster counts
    and object classes bit for bit (the same kernels in the same order),
    the logits within 1e-6; one capture, its 2 warm-up runs, one replay a
    call, one launch of the round kernel a round a replay."""
    cfg = tiny_test_config(csr_edge_tile=128, csr_window=64, mp_impl=mp_impl)
    weights = RadarGNN(cfg, generator=torch.Generator().manual_seed(0)).state_dict()
    det = FrameDetector(cfg, weights, from_links=from_links, device=cuda_device)
    eager = RadarGNN(cfg)
    eager.load_state_dict(weights)
    eager = eager.to(cuda_device).eval()
    ds = SyntheticRadarDataset(cfg, seed=11, num_objects=3)
    kernel = C.fused_message_pass_csr if mp_impl == "csr" else FM.fused_message_pass
    before = kernel.launches
    for _ in range(3):
        fr = ds.sample_frame()
        graph_np, _ = pad_frame(fr, cfg)
        out, prob, _ = det.forward(graph_np)
        got = {k: v.clone() for k, v in out._asdict().items()}
        prob = prob.clone()
        with torch.no_grad():
            want = eager.deploy(RadarGraph.from_numpy(graph_np, cuda_device), det.eps,
                                from_links)
        for k in ("node2cluster", "num_clusters"):
            assert torch.equal(got[k], getattr(want, k)), k
        for k in ("node_cls", "node_offsets", "edge_cls", "obj_cls", "centers"):
            torch.testing.assert_close(got[k], getattr(want, k), rtol=1e-6, atol=1e-7)
        assert torch.equal(prob.argmax(-1), want.node_cls.argmax(-1))
        k = int(want.num_clusters)
        assert torch.equal(got["obj_cls"][:k].argmax(-1), want.obj_cls[:k].argmax(-1))
        d = det.detect_frame_arrays(fr)
        n = min(fr.n, cfg.max_nodes)
        np.testing.assert_array_equal(d.node_class, want.node_cls[:n].argmax(-1).cpu().numpy())
        np.testing.assert_array_equal(d.node2cluster, want.node2cluster[:n].cpu().numpy())
        assert d.num_clusters == k
    rounds = len(cfg.graph_convolution_stem_channels)
    assert len(det.captured.graphs) == 1 and det.captured.replays == 6
    assert det.captured.warmups == S.CapturedGraphs.WARMUP_RUNS
    assert kernel.launches - before == rounds * (6 + S.CapturedGraphs.WARMUP_RUNS + 3)


def test_failed_capture_raises_and_runs_nothing_eagerly(cuda_device, monkeypatch):
    """A body that reads the device on the host fails its second warm-up
    (sync debug "error"): the capture raises, keeps no graph and replays
    nothing; a detector whose forward syncs raises the same from
    ``detect_frame_arrays``, with no eager result in its place."""
    cap = S.CapturedGraphs()

    def body(inputs):
        x = inputs[0] * 2
        return x + 1 if bool(x.sum() > 0) else x

    with pytest.raises(RuntimeError):
        cap.run(("k",), [np.ones(4, np.float32)], body, cuda_device)
    assert not cap.graphs and cap.replays == 0
    cfg = tiny_test_config()
    det = FrameDetector(cfg, RadarGNN(cfg).state_dict(), device=cuda_device)
    real = det.model.deploy
    monkeypatch.setattr(det.model, "deploy", lambda *a, **k: (
        real(*a, **k) if int(a[0].node_mask.sum()) >= 0 else None))
    with pytest.raises(RuntimeError):
        det.detect_frame_arrays(SyntheticRadarDataset(cfg, seed=3, num_objects=2).sample_frame())
    assert not det.captured.graphs and det.captured.replays == 0


def test_captured_finetune_equals_eager_step(cuda_device):
    """Three finetuning steps replayed from one captured CUDA graph against
    the same body run eagerly on the card from the same weights: metrics
    and the head's parameters within 1e-5 (index_add_ atomics in the head's
    backward), the trunk unchanged; the forward kernel one launch a round a
    replay for the batch, and the backward too (the trunk's gradient for
    the finiteness check, ROADMAP C6)."""
    cfg = tiny_test_config(batch_size=4)
    build, _ = FT.make_finetune_step(cfg)
    states, steps = [], []
    for _ in range(2):
        model = RadarGNN(cfg, generator=torch.Generator().manual_seed(0)).to(cuda_device)
        step, opt = build(model)
        states.append(S.TrainState(model, opt))
        steps.append(step)
    (cap, eager), step = states, steps[0]
    trunk = {k: v.clone() for k, v in cap.model.state_dict().items()
             if not k.startswith(FT.TRAINED + ".")}
    fwd, bwd = FM.fused_message_pass.launches, FM.fused_message_pass_backward.launches
    for seed in (4, 5, 6):
        batch = _tiny_batch(cfg, seed=seed)
        cap, m_cap = step(cap, batch)
        m_eager = step.captured.body(eager, S.batch_on(batch, cuda_device))
        assert float(m_cap["skipped"]) == float(m_eager["skipped"]) == 0.0
        for k, v in m_eager.items():
            np.testing.assert_allclose(float(m_cap[k]), float(v), rtol=1e-5, atol=1e-6,
                                       err_msg=k)
    rounds = len(cfg.graph_convolution_stem_channels)
    assert step.captured.replays == 3 and len(step.captured.graphs) == 1
    runs = rounds * (3 + S.CapturedStep.WARMUP_RUNS + 3)
    assert FM.fused_message_pass.launches - fwd == runs
    assert FM.fused_message_pass_backward.launches - bwd == runs
    assert (cap.step, cap.updates) == (eager.step, eager.updates) == (3, 3)
    want = eager.model.state_dict()
    for k, v in cap.model.state_dict().items():
        if k in trunk:
            assert torch.equal(v, trunk[k]), k
        else:
            np.testing.assert_allclose(v.cpu().numpy(), want[k].cpu().numpy(), rtol=1e-5,
                                       atol=1e-6, err_msg=k)


def _bitwise_or_close(got, want, eager_again, tol):
    """Captured ``got`` against eager ``want`` (dicts of tensors): bit for
    bit where two eager runs (``want``, ``eager_again``) agree bit for bit,
    else within ``tol`` (the momentum, a step's gradient summed with
    atomics, within 1e-4 of its largest element, as chip_smoke's
    MOMENTUM_SCALE)."""
    bitwise = all(torch.equal(want[k], eager_again[k]) for k in want)
    for k, v in want.items():
        g, w = got[k].cpu(), v.cpu()
        if bitwise:
            assert torch.equal(g, w), k
        elif k == "momentum_buffer":
            assert float((g - w).abs().max()) <= 1e-4 * float(w.abs().max()), k
        else:
            np.testing.assert_allclose(g.numpy(), w.numpy(), **tol, err_msg=k)
    return bitwise


def _captured_against_eager(step, state, args, body_args, eager, tol):
    """One captured step from ``state``, then its eager body on each of the
    two ``eager`` states given ``state``'s values from before the step;
    the captured metrics, parameters and momentum against them
    (``_bitwise_or_close``: the case decided over all of them)."""
    pre = [t.clone() for t in state.tensors()]
    state, m = step(state, *args)
    outs = []
    for other in eager:
        for dst, src in zip(other.tensors(), pre):
            dst.copy_(src)
        outs.append({**step.captured.body(other, body_args), **_params_and_moments(other)})
    _bitwise_or_close({**m, **_params_and_moments(state)}, *outs, tol)
    return state


def _classifier_setup(batch=4, count=3):
    from graph_neural_network_for_radar_perception_torch.models import classifier as CL

    ccfg = CL.ClassifierConfig(node_feat_enc_stem_channels=(32, 32),
                               graph_convolution_stem_channels=(32, 24),
                               msg_mlp_hidden_dim=32, node_pred_stem_channels=(32, 32),
                               max_points=128, max_objects=16, max_edges=1024)
    ds = SyntheticRadarDataset(tiny_test_config(), seed=0, num_objects=2)
    batches = []
    while len(batches) < count:
        samples = []
        while len(samples) < batch:
            fr = ds.sample_frame()
            s = CL.build_classifier_sample(fr.other_feat[:, :2], fr.node_feat[:, 1],
                                           fr.node_class, fr.node2cluster,
                                           int(fr.cluster_class.shape[0]), ccfg)
            if s is not None:
                samples.append(s)
        batches.append(CL.stack_samples(samples))
    return CL, ccfg, batches


def _params_and_moments(state):
    return {"params": state.optimizer.flat, **state.optimizer.moments}


def test_captured_classifier_step_equals_eager_step(cuda_device):
    """Three classifier steps replayed from one captured CUDA graph (one
    model call for the batch) against the eager body on the card from the
    same state before each step: metrics, parameters and momentum bit for
    bit where the eager step repeats itself bit for bit, else within 1e-5
    (the momentum 1e-4 of its largest element); one capture, three
    replays."""
    CL, ccfg, batches = _classifier_setup()
    init, step, _ = CL.make_classifier_train_step(ccfg)
    cap, eager, again = (init(torch.Generator().manual_seed(0), device=cuda_device)
                         for _ in range(3))
    tol = dict(rtol=1e-5, atol=1e-6)
    for batch in batches:
        cap = _captured_against_eager(step, cap, (batch,), batch.to(cuda_device),
                                      (eager, again), tol)
    assert step.captured.replays == 3 and len(step.captured.graphs) == 1
    assert (cap.step, cap.updates) == (3, 3)


def test_captured_cnn_step_equals_eager_step(cuda_device):
    """Two grid-CNN steps (small widths, TF32 off) replayed from one captured
    CUDA graph against the eager body on the card: bit for bit where the
    eager step repeats itself bit for bit (cuDNN's weight-gradient
    algorithms need not), else within 1e-5; then a batch with an infinite
    target skipped with the state bit for bit."""
    from graph_neural_network_for_radar_perception_torch.data.labels import INVALID_NUM
    from graph_neural_network_for_radar_perception_torch.models import cnn as CNN

    torch.backends.cudnn.allow_tf32 = False
    ccfg = CNN.CNNConfig(base_stem_channels=(8, 8), base_kernel_sizes=(5, 3),
                         bottleneck_number_of_blocks=(1, 1), bottleneck_stem_channels=(16, 16),
                         bottleneck_width_channels=8, neck_out_channels=8,
                         head_stem_channels=(8,), head_ffn_channels=(8,), learning_rate=0.01)
    rng = np.random.default_rng(0)
    hw = (32, 32)
    labels = np.full((2,) + hw, INVALID_NUM, np.float32)
    labels[:, 5:15, 5:15] = rng.integers(0, 8, (2, 10, 10))
    arrays = (rng.normal(size=(2,) + hw + (3,)).astype(np.float32),
              rng.normal(size=(2,) + hw).astype(np.float32),
              rng.normal(size=(2,) + hw).astype(np.float32), labels,
              rng.normal(size=(2,) + hw + (2,)).astype(np.float32))
    init, step, _ = CNN.make_grid_train_step(ccfg)
    cap, eager, again = (init(torch.Generator().manual_seed(0), device=cuda_device)
                         for _ in range(3))
    tol = dict(rtol=1e-5, atol=1e-6)
    dev = [torch.from_numpy(a).to(cuda_device) for a in arrays]
    for _ in range(2):
        cap = _captured_against_eager(step, cap, arrays, dev, (eager, again), tol)
    before = {k: v.clone() for k, v in _params_and_moments(cap).items()}
    bad = arrays[4].copy()
    bad[0, 6, 6, 0] = np.inf
    cap, m = step(cap, *arrays[:4], bad)
    assert float(m["skipped"]) == 1.0
    assert all(torch.equal(v, before[k]) for k, v in _params_and_moments(cap).items())
    assert step.captured.replays == 3 and len(step.captured.graphs) == 1
    assert (cap.step, cap.updates) == (3, 2)


@pytest.mark.parametrize("mp_impl", [None, "csr"], ids=["fused", "csr"])
def test_captured_eval_step_equals_eager_and_sees_new_weights(cuda_device, mp_impl):
    """The eval step replayed from one captured CUDA graph against its eager
    body on the card, bit for bit where the eager body repeats itself bit
    for bit (else within 1e-6); again after a train step updated the
    weights in place (the replay reads them there); one capture, one launch
    of the round kernel a round a replay."""
    cfg = tiny_test_config(csr_edge_tile=128, csr_window=64, mp_impl=mp_impl)
    state = S.create_train_state(cfg, torch.Generator().manual_seed(0), device=cuda_device)
    train_step, eval_step = S.make_train_step(cfg), S.make_eval_step(cfg)
    kernel = C.fused_message_pass_csr if mp_impl == "csr" else FM.fused_message_pass
    batches = [_tiny_batch(cfg, seed=s) for s in (7, 8)]
    tol = dict(rtol=1e-6, atol=1e-7)
    for i, batch in enumerate(batches + batches[:1]):
        if i == 2:
            old = eval_step(state.model, batch)
            state, _ = train_step(state, batches[1])
        before = kernel.launches
        got = eval_step(state.model, batch)
        replay = kernel.launches - before
        dev = S.batch_on(batch, cuda_device)
        _bitwise_or_close(got, eval_step.body(state.model, dev), eval_step.body(state.model, dev),
                          tol)
        rounds = len(cfg.graph_convolution_stem_channels)
        assert replay == rounds * (1 + (S.CapturedGraphs.WARMUP_RUNS if i == 0 else 0))
    assert not torch.equal(got["loss_total"], old["loss_total"])  # the new weights seen
    assert len(eval_step.captured.graphs) == 1 and eval_step.captured.replays == 4


@pytest.fixture
def traced():
    """``TRACER`` emptied before and after the test, and left off."""
    TRACER.disable()
    TRACER.drain()
    yield TRACER
    TRACER.disable()
    TRACER.drain()


def _inner(spans, replay):
    """The in-graph device spans of a replay's device span."""
    hosts = {s["id"] for s in spans if s["where"] == "host"}
    return [s for s in spans if s["call"] == replay["call"] and s["where"] == "device"
            and s["parent"] not in hosts]


def test_traced_train_step_phases_are_timed(cuda_device, traced):
    """A train step at the configuration's widths (batch 4) captured with
    the tracer on: the forward, backward and update and each round's
    forward and backward are device spans, read after one replay in
    ``SAMPLE_EVERY`` (each read), inside its device span, nested as
    captured; forward + backward + update within 5 % of the replay's
    device span."""
    cfg = GNNConfig(batch_size=4)
    batches = [_tiny_batch(cfg, seed=s) for s in (1, 2, 3)]
    state = S.create_train_state(cfg, torch.Generator().manual_seed(0), device=cuda_device)
    step = S.make_train_step(cfg)
    n = 2 * traced.SAMPLE_EVERY
    traced.enable()
    for i in range(n):
        state, _ = step(state, batches[i % 3])
    out = traced.drain()
    spans, rounds = out["spans"], len(cfg.graph_convolution_stem_channels)
    replays = [s for s in spans if s["name"] == "train_step.replay" and s["where"] == "device"]
    assert len(replays) == n and out["counters"]["captured.traced_replays"] == n
    assert out["counters"]["captured.sampled_replays"] == 2
    assert [bool(_inner(spans, r)) for r in replays] == [i % traced.SAMPLE_EVERY == 0
                                                         for i in range(n)]
    for r in replays:
        inner = _inner(spans, r)
        if not inner:
            continue
        by = {}
        for s in inner:
            by.setdefault(s["name"], []).append(s)
            assert r["start_ns"] - 1000 <= s["start_ns"] <= s["end_ns"] <= r["end_ns"] + 1000, s
        assert {k: len(v) for k, v in by.items()} == {
            "train_step.forward": 1, "train_step.backward": 1, "train_step.update": 1,
            "mp.forward": rounds, "mp.backward": rounds}
        phases = {k: by[f"train_step.{k}"][0] for k in ("forward", "backward", "update")}
        assert all(s["parent"] == phases["forward"]["id"] for s in by["mp.forward"])
        assert all(s["parent"] == phases["backward"]["id"] for s in by["mp.backward"])
        parts = sum(s["end_ns"] - s["start_ns"] for s in phases.values())
        whole = r["end_ns"] - r["start_ns"]
        assert abs(whole - parts) <= 0.05 * whole, (parts, whole)
    copies = [s for s in spans if s["name"] == "captured.copy" and s["where"] == "device"]
    assert len(copies) == n - 1 and out["counters"]["captured.copy_bytes"] > 0


def test_traced_and_untraced_steps_are_bitwise_equal(cuda_device, traced):
    """Three train steps replayed with the tracer on against the same from
    the same state with it off: metrics, parameters and momentum bit for
    bit where two untraced runs agree bit for bit (else within 1e-5; the
    momentum, summed with atomics, within 1e-4 of its largest element)."""
    cfg = tiny_test_config()
    batches = [_tiny_batch(cfg, seed=s) for s in (4, 5, 6)]
    step = S.make_train_step(cfg)
    off, again, on = (S.create_train_state(cfg, torch.Generator().manual_seed(0),
                                           device=cuda_device) for _ in range(3))
    tol = dict(rtol=1e-5, atol=1e-6)
    for batch in batches:
        results = []
        for st, tracing in ((off, False), (again, False), (on, True)):
            if tracing:
                traced.enable()
            _, m = step(st, batch)
            traced.disable()
            results.append({**m, "params": st.optimizer.flat.clone(),
                            "momentum_buffer": st.optimizer.moments["momentum_buffer"].clone()})
        _bitwise_or_close(results[2], results[0], results[1], tol)
    assert traced.drain()["counters"]["captured.traced_replays"] == 3


def test_capture_key_separates_tracing_on_from_off(cuda_device, traced):
    """A step called with the tracer off, on, on and off: two captures, the
    traced one holding the phases' and rounds' device spans and the other
    none; each replayed with its own flag."""
    cfg = tiny_test_config()
    batch = _tiny_batch(cfg)
    step = S.make_train_step(cfg)
    state = S.create_train_state(cfg, torch.Generator().manual_seed(0), device=cuda_device)
    for tracing in (False, True, True, False):
        if tracing:
            traced.enable()
        state, _ = step(state, batch)
        traced.disable()
    cap = step.captured
    assert len(cap.graphs) == 2 and cap.replays == 4
    assert cap.warmups == 2 * S.CapturedStep.WARMUP_RUNS
    marks = {key[1]: [m[0] for m in entry.marks] for key, entry in cap.graphs.items()}
    rounds = len(cfg.graph_convolution_stem_channels)
    assert marks[False] == []
    assert sorted(set(marks[True])) == ["mp.backward", "mp.forward", "train_step.backward",
                                        "train_step.forward", "train_step.update"]
    assert marks[True].count("mp.forward") == marks[True].count("mp.backward") == rounds
    out = traced.drain()
    replays = [s for s in out["spans"] if s["name"] == "train_step.replay"]
    assert [s["where"] for s in replays] == ["host", "device", "host", "device"]
    assert out["counters"]["captured.sampled_replays"] == 2  # the first after each enable()


def test_failed_step_capture_raises_and_keeps_the_state(cuda_device, monkeypatch):
    """A classifier step whose loss is read on the host fails its capture
    (the second warm-up, under sync debug "error"): it raises, keeps no
    graph, replays nothing and leaves the parameters, the momentum and the
    counts as they were (the warm-ups' writes undone)."""
    CL, ccfg, batches = _classifier_setup(count=1)
    init, step, loss_fn = CL.make_classifier_train_step(ccfg)
    state = init(torch.Generator().manual_seed(0), device=cuda_device)
    real = CL.classifier_loss

    def syncing_loss(*a, **k):
        loss, acc = real(*a, **k)
        return (loss if float(loss.sum()) >= 0 else loss), acc

    monkeypatch.setattr(CL, "classifier_loss", syncing_loss)
    before = {k: v.clone() for k, v in _params_and_moments(state).items()}
    counters = state.counters.clone()
    with pytest.raises(RuntimeError):
        step(state, batches[0])
    assert not step.captured.graphs and step.captured.replays == 0
    assert all(torch.equal(v, before[k]) for k, v in _params_and_moments(state).items())
    assert torch.equal(state.counters, counters)


def test_captured_grid_step_under_nccl_equals_eager_step(cuda_device, tmp_path, monkeypatch):
    """The data-parallel grid step on a 1 x 1 grid under NCCL (one rank in
    this process, a FileStore rendezvous): captured once, then each of
    three steps a replay, held to the eager body on the card from the same
    state before each step (bit for bit where the eager step repeats itself
    bit for bit, else within 1e-5, the momentum 1e-4 of its largest
    element); each replay one host launch and two all-reduces (the
    LossSums and the flat gradient), counted in ``collectives.STATS`` with
    their bytes, and one launch of each round kernel a round."""
    import torch.distributed as dist

    from graph_neural_network_for_radar_perception_torch.parallel import collectives as PC
    from graph_neural_network_for_radar_perception_torch.parallel.distributed import (
        init_distributed,
    )
    from graph_neural_network_for_radar_perception_torch.parallel.mesh import make_mesh
    from graph_neural_network_for_radar_perception_torch.parallel.sharded import (
        captures,
        make_dp_train_step,
    )
    from graph_neural_network_for_radar_perception_torch.train.loss import LossSums
    from graph_neural_network_for_radar_perception_torch.utils.timing import profile_run

    monkeypatch.setenv("NCCL_SOCKET_IFNAME", "lo")  # one host: the bootstrap binds the loopback
    init_distributed(num_processes=1, process_id=0, device="cuda", backend="nccl",
                     store=str(tmp_path / "store"), timeout_s=120)
    try:
        cfg = tiny_test_config()
        mesh = make_mesh(device="cuda")
        step = make_dp_train_step(cfg, mesh)
        assert captures(mesh)
        cap, eager, again = (S.create_train_state(cfg, torch.Generator().manual_seed(0),
                                                  device=cuda_device) for _ in range(3))
        rounds = len(cfg.graph_convolution_stem_channels)
        per_replay = [0] * len(PC.counts())
        per_replay[0] = per_replay[1] = 2
        per_replay[2] = (len(LossSums._fields) + cap.optimizer.flat.numel()) * 4
        tol = dict(rtol=1e-5, atol=1e-6)
        for i, seed in enumerate((4, 5, 6)):
            args = (step.place_batch(_tiny_batch(cfg, seed=seed)),)
            counts, fwd = PC.counts(), FM.fused_message_pass.launches
            pre = [t.clone() for t in cap.tensors()]
            cap, m = step(cap, *args)
            runs = 1 + (S.CapturedStep.WARMUP_RUNS if i == 0 else 0)
            assert [b - a for a, b in zip(counts, PC.counts())] == [runs * d for d in per_replay]
            assert FM.fused_message_pass.launches - fwd == runs * rounds
            outs = []
            for other in (eager, again):
                for dst, src in zip(other.tensors(), pre):
                    dst.copy_(src)
                outs.append({**step.captured.body(other, args), **_params_and_moments(other)})
            _bitwise_or_close({**m, **_params_and_moments(cap)}, *outs, tol)
            assert float(m["skipped"]) == 0.0
        assert step.captured.replays == 3 and len(step.captured.graphs) == 1
        assert (cap.step, cap.updates) == (3, 3)
        prof = profile_run(lambda: step(cap, *args))
        assert prof["host_launches"] == 1, prof
    finally:
        dist.destroy_process_group()


# ------------------------------------------------------------- the CSR round
def _hub_edges(rng, n, k, hub, degree):
    """A kNN graph (k) with node ``hub`` joined both ways to the ``degree``
    nodes after it: one destination segment of more than ``degree`` edges,
    longer than several backward edge tiles."""
    s, r = knn_edges(rng, n, k)
    adj = np.zeros((n, n), bool)
    adj[s, r] = True
    adj[hub, hub + 1 : hub + 1 + degree] = True
    return np.nonzero(adj | adj.T)


CSR_CASES = {  # edges(rng), n, e_total, widths (d, de, h, d2), tiling
    "knn": (lambda rng: knn_edges(rng, 768, 10), 768, 15360, (64, 64, 128, 64), (512, 256, 0)),
    "knn-ragged": (lambda rng: knn_edges(rng, 768, 10), 768, 15357, (64, 64, 128, 64), (512, 256, 0)),
    "banded-src-window": (lambda rng: banded_edges(768, 6), 768, 15360, (64, 64, 128, 64), (512, 256, 256)),
    "tiny": (lambda rng: knn_edges(rng, 64, 6), 64, 600, (16, 16, 32, 16), (128, 64, 0)),
}
CSR_BWD_CASES = {  # the backward's edge tiles and blocks, besides CSR_CASES
    **CSR_CASES,
    # E not a multiple of the backward's edge tile, one segment over 3 tiles
    # of two edge blocks.
    "hub-ragged": (lambda rng: _hub_edges(rng, 768, 10, 100, 80), 768, 15361, (64, 64, 128, 64), (512, 256, 0)),
    # No live edge: every edge is padding.
    "no-live-edges": (lambda rng: (np.zeros(0, np.int64), np.zeros(0, np.int64)), 64, 600, (16, 16, 32, 16), (128, 64, 0)),
    # D2=128: two weight-gradient items a thread, one input stage.
    "wide-d2": (lambda rng: knn_edges(rng, 256, 8), 256, 3000, (64, 64, 128, 128), (512, 256, 0)),
    # H=256: 16-edge tiles.
    "wide-h": (lambda rng: knn_edges(rng, 256, 8), 256, 3000, (64, 64, 256, 64), (512, 256, 0)),
    # De=96, H=256: 8-edge tiles, three weight-gradient items a thread (the
    # third in the block's partial in global memory); E not a multiple of 8.
    "wide-t8": (lambda rng: knn_edges(rng, 256, 8), 256, 3001, (64, 96, 256, 64), (512, 256, 0)),
    # H < D2: pre2 rows wider than the hidden ones.
    "narrow-h": (lambda rng: knn_edges(rng, 64, 6), 64, 601, (16, 16, 32, 64), (128, 64, 0)),
    # Widths that are no power of two (3 x 32 columns).
    "odd": (lambda rng: knn_edges(rng, 256, 8), 256, 3001, (64, 48, 96, 96), (512, 256, 0)),
}
# The forward's cases: its edge kernel's tiles and stages, as FWD_SHAPES
# and FWD_PLANS.
CSR_FWD_CASES = {
    **CSR_CASES,
    **{k: CSR_BWD_CASES[k] for k in ("hub-ragged", "narrow-h", "wide-h")},
    "wide-t16": CSR_BWD_CASES["wide-t8"],
    "wide-t8": (lambda rng: knn_edges(rng, 256, 8), 256, 3001, (64, 64, 256, 128), (512, 256, 0)),
    "odd": CSR_BWD_CASES["odd"],
}
# The edge kernel's (tile, input stages) at each case's widths on an H100
# (227 KB of shared memory a block).
CSR_BWD_PLANS = {"wide-d2": (32, 1), "wide-h": (16, 1), "wide-t8": (8, 1)}


def _csr_case(name, seed, device, cases=CSR_BWD_CASES):
    edges, n, e_total, (d, de, h, d2), tiling = cases[name]
    rng = np.random.default_rng(seed)
    args = csr_problem(torch, rng, edges(rng), e_total, n, d, de, h, d2, device)
    return args, tiling, rng


@pytest.mark.parametrize("case", list(CSR_FWD_CASES))
def test_csr_kernel_matches_plain(cuda_device, case):
    """The forward kernel against its plain version at the deploy
    tolerance of chip_smoke's [kernel] phase, and bitwise across launches,
    at the tile and input stages its plan takes (FWD_PLANS); "hub-ragged"
    has a destination segment longer than a tile."""
    args, (tile, window, src_window), _ = _csr_case(case, 0, cuda_device, CSR_FWD_CASES)
    before = C.fused_message_pass_csr.launches
    with torch.no_grad():
        got = C.fused_message_pass_csr(*args, 0.01, tile, window, False, src_window)
        again = C.fused_message_pass_csr(*args, 0.01, tile, window, False, src_window)
    torch.cuda.synchronize()
    assert C.fused_message_pass_csr.launches == before + 2
    assert torch.equal(got, again)
    want = C.fused_message_pass_csr_reference(*args, 0.01, tile, window, src_window)
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(),
                               rtol=2e-4, atol=2e-5)
    x, ef, w2 = args[0], args[1], args[6]
    plan = C._forward_plan(x.shape[0], ef.shape[0], x.shape[1], ef.shape[1],
                           w2.shape[0], w2.shape[1], cuda_device)
    assert (plan.tile, plan.stages) == FWD_PLANS.get(case, (32, 2))


def _edge_block(p, p_end, blocks):
    """The block of csr_bwd_edge_kernel that takes edge position p: block b
    owns [b p_end / blocks, (b+1) p_end / blocks) of the edges before
    p_end = off[N]."""
    return next(b for b in range(blocks)
                if b * p_end // blocks <= p < (b + 1) * p_end // blocks)


@pytest.mark.parametrize("case", list(CSR_BWD_CASES))
def test_csr_backward_kernel_matches_plain(cuda_device, case):
    """All 10 outputs at the gradient tolerance with a cotangent of a train
    step's scale, kink edges dropped (chip_smoke.drop_kink_edges_csr), and
    bitwise across launches.  The C call returns every weight gradient
    summed: the results are views of its one output buffer, shaped as the
    plain version's.  "hub-ragged" has a destination segment across two
    tiles of two edge blocks; "no-live-edges" gives zeros everywhere; the
    wide cases run the edge kernel in smaller tiles (CSR_BWD_PLANS)."""
    args, (tile, window, src_window), rng = _csr_case(case, 1, cuda_device)
    args, _ = drop_kink_edges_csr(torch, args)
    n, d2 = args[0].shape[0], args[6].shape[1]
    g = torch.from_numpy((1e-2 * rng.normal(size=(n, d2))).astype(np.float32)).to(cuda_device)
    before = C.fused_message_pass_csr_backward.launches
    got = C.fused_message_pass_csr_backward(*args, g, 0.01, tile, window, src_window)
    again = C.fused_message_pass_csr_backward(*args, g, 0.01, tile, window, src_window)
    torch.cuda.synchronize()
    assert C.fused_message_pass_csr_backward.launches == before + 2
    want = C.fused_message_pass_csr_backward_reference(*args, g, 0.01, tile, window,
                                                       src_window)
    names = "dx gef dw1 db1 dw2 db2 dg1 dbe1 dg2 dbe2".split()
    for name, a, b, c in zip(names, got, want, again):
        assert torch.equal(a, c), name
        np.testing.assert_allclose(a.cpu().numpy(), b.cpu().numpy(),
                                   rtol=5e-4, atol=5e-5, err_msg=name)

    layout = C.csr_layout(args[2], args[3], n, tile, window, src_window)
    raw, results = C._backward_launch(args[0], args[1], layout, *args[4:8],
                                      torch.cat(args[8:]), g, 0.01)
    assert C._bwd_kernel()(*raw) == 0
    direct = results()
    torch.cuda.synchronize()
    for i, (name, r, b, a) in enumerate(zip(names, direct, want, got)):
        assert r.shape == b.shape if i < 6 else r.numel() == b.numel() == 1, name
        assert torch.equal(r.reshape(a.shape), a), name
    assert all(r._base is direct[2]._base for r in direct[3:])

    e_live = int((layout.dst < n).sum())
    plan = C._backward_plan(n, args[1].shape[0], args[0].shape[1], args[1].shape[1],
                            args[4].shape[1], d2, cuda_device)
    assert (plan.tile, plan.stages) == CSR_BWD_PLANS.get(case, (32, 2))
    if case == "no-live-edges":
        assert e_live == 0
        assert all(int(torch.count_nonzero(a)) == 0 for a in got)
    if case == "hub-ragged":
        assert args[2].shape[0] % plan.tile
        off = layout.off.cpu().numpy()
        lo, hi = int(off[100]), int(off[101])
        first = _edge_block(lo, int(off[n]), plan.blocks)
        last = _edge_block(hi - 1, int(off[n]), plan.blocks)
        assert hi - lo > plan.tile and last > first  # tiles of two blocks


def test_csr_model_gradients_on_card_match_cpu(cuda_device):
    """Every parameter's gradient on the CSR path, card against CPU; the
    fused kernels are not launched."""
    cfg = tiny_test_config(mp_impl="csr", csr_edge_tile=128, csr_window=64)
    batch = _tiny_batch(cfg)
    grads = {}
    for device in ("cpu", cuda_device):
        st = S.create_train_state(cfg, torch.Generator().manual_seed(0), device=device)
        before = (C.fused_message_pass_csr.launches,
                  C.fused_message_pass_csr_backward.launches,
                  FM.fused_message_pass.launches)
        loss, _ = S.make_loss_fn(cfg)(st.model, S.batch_on(batch, device))
        loss.backward()
        after = (C.fused_message_pass_csr.launches,
                 C.fused_message_pass_csr_backward.launches,
                 FM.fused_message_pass.launches)
        grads[str(device)] = {k: p.grad.cpu().numpy() for k, p in st.model.named_parameters()}
    rounds = len(cfg.graph_convolution_stem_channels)  # one launch a round for the batch
    assert after == (before[0] + rounds, before[1] + rounds, before[2])
    for k, want in grads["cpu"].items():
        np.testing.assert_allclose(grads["cuda"][k], want, rtol=1e-3,
                                   atol=1e-4 * np.abs(want).max(), err_msg=k)


# ------------------------------------------------------- bf16 operand rounds
@pytest.mark.parametrize("shape", [
    FWD_SHAPES["deploy"],  # main-path shapes
    *(FWD_SHAPES[k] for k in ("ragged", "tiny", "hub", "narrow-h", "wide-h",
                              "wide-t16", "wide-t8", "odd")),
], ids=["main", "ragged", "tiny", "hub", "narrow-h", "wide-h", "wide-t16", "wide-t8", "odd"])
def test_bf16_kernel_matches_plain(cuda_device, shape):
    """The fused forward's bf16 instantiation against its plain bf16
    version at chip_smoke's bf16 tolerance; the f32 kernel lies outside it
    (chip_smoke.bf16_verdict)."""
    args = _problem(3, device=cuda_device, **shape)
    before = (FM.fused_message_pass.launches, FM.fused_message_pass.launches_bf16)
    got = FM.fused_message_pass(*args, 0.01, True)
    f32 = FM.fused_message_pass(*args, 0.01)
    torch.cuda.synchronize()
    assert (FM.fused_message_pass.launches,
            FM.fused_message_pass.launches_bf16) == (before[0] + 1, before[1] + 1)
    want = FM.fused_message_pass_reference(*args, 0.01, bf16=True)
    bf16_verdict(torch, got, f32, want, "fused bf16")


@pytest.mark.parametrize("case", list(CSR_FWD_CASES))
def test_csr_bf16_kernel_matches_plain(cuda_device, case):
    """The CSR forward's bf16 instantiation against its plain bf16 version,
    bitwise across launches."""
    args, (tile, window, src_window), _ = _csr_case(case, 2, cuda_device, CSR_FWD_CASES)
    before = C.fused_message_pass_csr.launches_bf16
    with torch.no_grad():
        got = C.fused_message_pass_csr(*args, 0.01, tile, window, True, src_window)
        again = C.fused_message_pass_csr(*args, 0.01, tile, window, True, src_window)
        f32 = C.fused_message_pass_csr(*args, 0.01, tile, window, False, src_window)
    torch.cuda.synchronize()
    assert C.fused_message_pass_csr.launches_bf16 == before + 2
    assert torch.equal(got, again)
    want = C.fused_message_pass_csr_reference(*args, 0.01, tile, window,
                                              src_window, True)
    bf16_verdict(torch, got, f32, want, f"csr bf16 {case}")


# The bf16 forwards' tensor-core tiles (fwd_edge_kernel_bf16, the CSR
# round's gemm_bf16_kernel) at the main path's widths (De, H, D2), at
# chip_smoke.FWD_WIDE and at widths that are multiples of 4 but not of the
# mma.sync tiles (De and H of 16, D2 of 8), which the kernels zero-pad; the
# edge kernel's (tile, input stages) at each on an H100 (one stage where
# two blocks fit an SM's 228 KB of shared memory, else two where they fit
# a block's 227 KB).
BF16_WIDTHS = {"main": (64, 128, 64),
               **{f"wide-{de}-{h}-{d2}": (de, h, d2) for de, h, d2 in FWD_WIDE},
               "pad": (36, 132, 68)}
BF16_PLANS = {"main": (32, 1), "wide-64-256-64": (32, 2), "wide-96-256-64": (32, 1),
              "wide-64-256-128": (32, 1), "pad": (32, 1)}


def _bf16_case(mp, widths, seed, device):
    """(round, args, call) of one bf16 forward at BF16_WIDTHS[widths]: the
    main path's graph size (N=768, E=15360) at the main widths, else N=256,
    E=3001; random edges with sentinels (fused) or a kNN graph (CSR)."""
    de, h, d2 = BF16_WIDTHS[widths]
    n, e = (768, 15360) if widths == "main" else (256, 3001)
    if mp == "fused":
        args = _problem(seed, n=n, e=e, d=64, de=de, h=h, d2=d2, device=device)
        return args, lambda bf16: FM.fused_message_pass(*args, 0.01, bf16), (
            lambda: FM.fused_message_pass_reference(*args, 0.01, bf16=True))
    rng = np.random.default_rng(seed)
    args = csr_problem(torch, rng, knn_edges(rng, n, 10 if n == 768 else 8), e, n, 64,
                       de, h, d2, device)
    tiling = (512, 256, 0)

    def call(bf16):
        with torch.no_grad():
            return C.fused_message_pass_csr(*args, 0.01, *tiling[:2], bf16, tiling[2])
    return args, call, lambda: C.fused_message_pass_csr_reference(
        *args, 0.01, *tiling, True)


@pytest.mark.parametrize("mp", ["fused", "csr"])
@pytest.mark.parametrize("widths", list(BF16_WIDTHS))
def test_bf16_tensor_core_forward_matches_plain(cuda_device, widths, mp):
    """Each bf16 forward against its plain bf16 version under
    chip_smoke.bf16_verdict (the f32 kernel outside that tolerance), two
    launches bitwise equal, one bf16 count a launch, at the plan's tile
    (BF16_PLANS)."""
    args, call, plain = _bf16_case(mp, widths, 7, cuda_device)
    counter = FM.fused_message_pass if mp == "fused" else C.fused_message_pass_csr
    before = counter.launches_bf16
    got, again, f32 = call(True), call(True), call(False)
    torch.cuda.synchronize()
    assert counter.launches_bf16 == before + 2
    assert torch.equal(got, again)
    bf16_verdict(torch, got, f32, plain(), f"{mp} bf16 {widths}")
    x, ef, w2 = args[0], args[1], args[6]
    widths_c = (x.shape[0], ef.shape[0]) + ((x.shape[1],) if mp == "csr" else ()) + (
        ef.shape[1], w2.shape[0], w2.shape[1])
    lib = "fused_mp" if mp == "fused" else "csr_mp"
    plan = FM._plan(lib, f"{lib}_forward_bf16_plan", cuda_device, *widths_c)
    assert (plan.tile, plan.stages) == BF16_PLANS[widths]


@pytest.mark.parametrize("mp", ["fused", "csr"])
@pytest.mark.parametrize("widths", ["main", "pad"])
def test_bf16_batched_launch_equals_one_graph_launches(cuda_device, widths, mp):
    """A bf16 forward over 8 graphs in one C call equals 8 calls of one
    graph on the same inputs bit for bit (agg, and the messages of the
    edges that land): graph g's tiles are those of a one-graph launch."""
    probs = [_bf16_case(mp, widths, 50 + g, cuda_device)[0] for g in range(8)]
    x, ef, s, r = (torch.stack([p[i] for p in probs]) for i in range(4))
    w1, b1, w2, b2 = probs[0][4:8]
    n, d = x.shape[1], x.shape[2]

    def sl(g):
        return slice(None) if g is None else slice(g, g + 1)

    if mp == "fused":
        scal = torch.tensor(probs[0][8:], device=cuda_device)
        layout = FM.fused_layout(s, r, n)
        xa, xb = x @ w1[:d], x @ w1[d:2 * d]  # one set of node products for both

        def fwd(g):
            lay = layout if g is None else type(layout)(*(t[g:g + 1] for t in layout))
            raw, outs = FM._forward_launch(x[sl(g)], ef[sl(g)], s[sl(g)], r[sl(g)], w1, b1,
                                           w2, b2, scal, 0.01, lay, (xa[sl(g)], xb[sl(g)]))
            lands = ((r[sl(g)] >= 0) & (r[sl(g)] < n))[..., None]
            return (lambda: FM._kernel(True)(*raw)), (
                lambda: (torch.where(lands, outs[0], 0.0), outs[1]))
    else:
        scal = torch.cat(probs[0][8:])
        layout = C.csr_layout(s, r, n, 512, 256, 0)

        def fwd(g):
            lay = layout if g is None else type(layout)(
                *(t[g:g + 1] if torch.is_tensor(t) else t for t in layout))
            raw, outs = C._forward_launch(x[sl(g)], ef[sl(g)], lay, w1, b1, w2, b2, scal, 0.01)
            lands = (lay.dst < n)[..., None]
            return (lambda: C._kernel(True)(*raw)), (
                lambda: (torch.where(lands, outs[0], 0.0), outs[1]))
    _batched_launches(fwd, 8, 2)


@pytest.mark.parametrize("mp", ["fused", "csr"])
def test_bf16_round_gradients_on_card(cuda_device, mp):
    """Through a bf16 round on the card the gradients are the f32 round's
    (the same f32 backward kernel), against the CPU's plain backward."""
    if mp == "fused":
        args, _ = drop_kink_edges(torch, _problem(4, device=cuda_device, n=768,
                                                  e=15360, d=64, de=64, h=128, d2=64))
        args = args[:8] + [torch.tensor([v], device=cuda_device)
                           for v in (1.1, 0.05, 0.9, -0.02)]

        def round_(dev, *leaves, bf16):
            x, ef, w1, b1, w2, b2, *sc = leaves
            return FM.fused_message_pass(x, ef, args[2].to(dev), args[3].to(dev),
                                         w1, b1, w2, b2, *sc, 0.01, bf16)
    else:
        args, (tile, window, src_window), _ = _csr_case("knn", 5, cuda_device)
        args, _ = drop_kink_edges_csr(torch, args)

        def round_(dev, *leaves, bf16):
            x, ef, w1, b1, w2, b2, *sc = leaves
            return C.fused_message_pass_csr(x, ef, args[2].to(dev), args[3].to(dev),
                                            w1, b1, w2, b2, *sc, 0.01, tile,
                                            window, bf16, src_window)
    g = torch.from_numpy((1e-2 * np.random.default_rng(6).normal(
        size=(args[0].shape[0], args[6].shape[1]))).astype(np.float32))
    grads = {}
    for dev, bf16 in ((cuda_device, True), ("cpu", False)):
        leaves = [a.to(dev).clone().requires_grad_()
                  for a in (args[0], args[1], *args[4:])]
        out = round_(dev, *leaves, bf16=bf16)
        grads[bf16] = torch.autograd.grad(out, leaves, g.to(dev))
    for i, (a, b) in enumerate(zip(grads[True], grads[False])):
        np.testing.assert_allclose(a.cpu().numpy(), b.numpy(), rtol=5e-4,
                                   atol=5e-5, err_msg=f"grad {i}")


@pytest.mark.parametrize("mp_impl", [None, "csr"], ids=["fused", "csr"])
def test_bf16_train_step_on_card_matches_cpu(cuda_device, mp_impl):
    """One bf16 train step, card against CPU: losses at the bf16 tolerance;
    only the bf16 forward and the f32 backward are launched."""
    cfg = tiny_test_config(csr_edge_tile=128, csr_window=64)
    batch = _tiny_batch(cfg, seed=4)
    out = {}
    kernels = (FM.fused_message_pass, C.fused_message_pass_csr)
    for device in ("cpu", cuda_device):
        st = S.create_train_state(cfg, torch.Generator().manual_seed(0), device=device)
        before = [(k.launches, k.launches_bf16) for k in kernels]
        st, m = S.make_train_step(cfg, mp_impl, mp_bf16=True)(st, batch)
        after = [(k.launches, k.launches_bf16) for k in kernels]
        out[str(device)] = {k: float(v) for k, v in m.items()}
    # On the card: one launch a round for the batch, in each of the capture's
    # warm-up runs and in the replay.
    rounds = len(cfg.graph_convolution_stem_channels) * (S.CapturedStep.WARMUP_RUNS + 1)
    used = 1 if mp_impl == "csr" else 0
    for i, (b, a) in enumerate(zip(before, after)):
        assert a == (b[0], b[1] + (rounds if i == used else 0))
    assert out["cuda"]["skipped"] == 0.0
    for k, v in out["cpu"].items():
        if k.startswith("loss_"):
            np.testing.assert_allclose(out["cuda"][k], v, rtol=1e-2, atol=1e-3, err_msg=k)


# ------------------------------------------------ gather/scatter microbenchmark
def test_microbench_kernels_match_plain_and_library(cuda_device):
    """Gather bitwise against its plain version (out-of-range indices
    included) and against index_select (in-range); scatter within
    MB.SCATTER_TOL of both index_add_ versions."""
    rng = np.random.default_rng(7)
    m = MB.TILES * MB.TE
    idx = rng.integers(0, MB.N, m).astype(np.int32)
    tab = torch.from_numpy(rng.normal(size=(MB.N, MB.D)).astype(np.float32)).to(cuda_device)
    msg = torch.from_numpy(rng.normal(size=(m, MB.D)).astype(np.float32)).to(cuda_device)
    inside = torch.from_numpy(idx).to(cuda_device)
    idx[rng.random(m) < 0.05] = MB.N + 1
    idx[rng.random(m) < 0.05] = -3
    outside = torch.from_numpy(idx).to(cuda_device)
    before = (MB.gather_rows.launches, MB.scatter_add_rows.launches)
    g_in, g_out = MB.gather_rows(tab, inside), MB.gather_rows(tab, outside)
    s_in, s_out = MB.scatter_add_rows(msg, inside, MB.N), MB.scatter_add_rows(msg, outside, MB.N)
    torch.cuda.synchronize()
    assert (MB.gather_rows.launches, MB.scatter_add_rows.launches) == (
        before[0] + 2, before[1] + 2)
    assert torch.equal(g_in, torch.index_select(tab, 0, inside))
    assert torch.equal(g_out, MB.gather_rows_reference(tab, outside))
    for got, want in ((s_in, torch.zeros(MB.N, MB.D, device=cuda_device).index_add_(0, inside, msg)),
                      (s_out, MB.scatter_add_rows_reference(msg, outside, MB.N))):
        np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(), **MB.SCATTER_TOL)
    assert MB.gather_rows(tab, inside[:0]).shape == (0, MB.D)
    assert not MB.scatter_add_rows(msg[:0], inside[:0], MB.N).any()


@pytest.mark.parametrize("n, d, m", [(768, 64, 15360), (100, 64, 15360), (768, 4, 15360),
                                     (50, 12, 5000), (300, 1024, 3000)])
def test_scatter_is_np_add_at_bitwise(cuda_device, n, d, m):
    """Each row's messages are added in index order: np.add.at's result,
    bit for bit, on every launch; with out-of-range indices, and a row that
    takes a fifth of them (its list is summed and emptied several times)."""
    rng = np.random.default_rng(n + d)
    idx = rng.integers(0, n, m).astype(np.int32)
    idx[rng.random(m) < 0.2] = 17
    idx[rng.random(m) < 0.05] = n + 1
    idx[rng.random(m) < 0.05] = -3
    msg = rng.normal(size=(m, d)).astype(np.float32)
    keep = (idx >= 0) & (idx < n)
    want = np.zeros((n, d), np.float32)
    np.add.at(want, idx[keep], msg[keep])
    t_idx, t_msg = torch.from_numpy(idx).to(cuda_device), torch.from_numpy(msg).to(cuda_device)
    got = MB.scatter_add_rows(t_msg, t_idx, n)
    again = MB.scatter_add_rows(t_msg, t_idx, n)
    torch.cuda.synchronize()
    np.testing.assert_array_equal(got.cpu().numpy(), want)
    assert torch.equal(got, again)


@pytest.mark.parametrize("n, d, m", [
    (768, 64, 15360), (768, 64, 0), (768, 64, 15361), (768, 64, 37), (768, 4, 15360),
    (50, 1024, 3000), (10, 12, 1000), (768, 64, 100000)])
def test_gather_is_numpy_indexing_bitwise(cuda_device, n, d, m):
    """The gather equals numpy indexing bit for bit, zero rows where an index
    lies outside [0, n), on every launch: at the microbenchmark's shapes, with
    no indices, a count that is no multiple of a warp's rows, widths of 4,
    12 (no power of two) and 1024 floats, and more rows than the grid's
    warps take in one run each."""
    rng = np.random.default_rng(n + d + m)
    idx = rng.integers(0, n, m).astype(np.int32)
    idx[rng.random(m) < 0.05] = n
    idx[rng.random(m) < 0.05] = -1
    idx[rng.random(m) < 0.01] = 2**31 - 1
    tab = rng.normal(size=(n, d)).astype(np.float32)
    keep = (idx >= 0) & (idx < n)
    want = np.where(keep[:, None], tab[np.where(keep, idx, 0)], np.float32(0))
    t_idx, t_tab = torch.from_numpy(idx).to(cuda_device), torch.from_numpy(tab).to(cuda_device)
    before = MB.gather_rows.launches
    got = MB.gather_rows(t_tab, t_idx)
    again = MB.gather_rows(t_tab, t_idx)
    torch.cuda.synchronize()
    assert got.shape == (m, d)
    np.testing.assert_array_equal(got.cpu().numpy(), want)
    assert torch.equal(got, again)
    assert MB.gather_rows.launches == before + (2 if m else 0)


def test_microbench_runs(cuda_device):
    res = MB.run()
    for key in ("gather", "scatter"):
        r = res[key]
        assert 0 < r["bound_ms"] <= r["ms"] <= r["launch_ms"], (key, r)


# ------------------------------------------------------------ the data plane
def test_device_prefetch_on_card_is_bitwise_while_the_card_is_busy(cuda_device):
    """Batches of ~12 MB each, copied on the prefetch's copy stream while
    the default stream runs long matmuls queued before each batch is taken:
    every batch arrives bitwise equal to its host arrays, read on the
    default stream right away and again after all batches (no buffer
    reused while a batch is alive)."""
    from graph_neural_network_for_radar_perception_torch.data.prefetch import (
        device_prefetch,
    )

    rng = np.random.default_rng(0)
    host = [{"a": rng.normal(size=(1024, 1024)).astype(np.float32),
             "b": rng.integers(0, 2**31 - 1, size=(2, 1024, 1024), dtype=np.int32),
             "m": rng.random(4096) < 0.5} for _ in range(8)]
    busy = torch.randn(4096, 4096, device=cuda_device)
    kept = []
    for i, batch in enumerate(device_prefetch(iter(host), buffer_size=3)):
        for _ in range(4):  # default-stream work queued before reading the batch
            busy = torch.tanh(busy @ busy * 1e-3)
        for k, t in batch.items():
            assert t.device.type == "cuda"
            np.testing.assert_array_equal(t.cpu().numpy(), host[i][k], err_msg=f"{i}.{k}")
        kept.append(batch)
    torch.cuda.synchronize()
    assert len(kept) == 8
    for i, batch in enumerate(kept):
        for k, t in batch.items():
            np.testing.assert_array_equal(t.cpu().numpy(), host[i][k], err_msg=f"{i}.{k}")


def test_graph_build_on_card_equals_cpu(cuda_device):
    """ops/graph_build on the card against its CPU run, with exact distance
    ties: structure bitwise, features within rtol 1e-6 / atol 1e-6."""
    from graph_neural_network_for_radar_perception_torch.ops import graph_build as GB

    rng = np.random.default_rng(4)
    n_cap = 768
    pts = rng.uniform(0, 60, (n_cap, 2)).astype(np.float32)
    pts[100:110] = pts[99]  # ten copies of one point
    pts[200] = pts[201] + np.float32([1.0, 0.0])
    pts[202] = pts[201] - np.float32([1.0, 0.0])
    for n_valid, union_ball in ((700, False), (700, True), (9, False)):
        mask = np.arange(n_cap) < n_valid
        kw = dict(k=10, eps_sq=2.0, edge_capacity=15360, und_capacity=7680,
                  union_ball=union_ball)
        got = GB.build_graph_structure(torch.from_numpy(pts).to(cuda_device),
                                       torch.from_numpy(mask).to(cuda_device), **kw)
        want = GB.build_graph_structure(torch.from_numpy(pts), torch.from_numpy(mask), **kw)
        for name, g, w in zip(got._fields, got, want):
            assert torch.equal(g.cpu(), w), (n_valid, union_ball, name)
        cols = [torch.from_numpy(rng.normal(size=n_cap).astype(np.float32)) for _ in range(3)]
        args = [torch.from_numpy(pts[:, 0]), torch.from_numpy(pts[:, 1]), *cols]
        ef_cpu = GB.compute_edge_features_device(*args, want.senders, want.receivers,
                                                 want.edge_mask)
        ef_gpu = GB.compute_edge_features_device(*[a.to(cuda_device) for a in args],
                                                 got.senders, got.receivers, got.edge_mask)
        torch.testing.assert_close(ef_gpu.cpu(), ef_cpu, rtol=1e-6, atol=1e-6)


def test_native_library_builds_from_a_clean_dir(cuda_device, monkeypatch, tmp_path):
    """The host compiler of the card's machine builds csrc/graph_builder.cpp
    into an empty build directory; the library loads and agrees with the
    numpy builder (graph equal, features at rtol 1e-5 / atol 1e-6)."""
    from graph_neural_network_for_radar_perception_torch.data import features as TF
    from graph_neural_network_for_radar_perception_torch.data import native as TN
    from graph_neural_network_for_radar_perception_torch.ops import _build

    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    TN._lib.cache_clear()
    try:
        assert TN.available() and len(list(tmp_path.glob("*.so"))) == 1
        rng = np.random.default_rng(0)
        px, py = (rng.uniform(0, 80, 300).astype(np.float32) for _ in range(2))
        vx, vy = (rng.normal(size=300).astype(np.float32) for _ in range(2))
        ts = rng.uniform(0, 6e5, 300)
        out = TN.build_graph_native(px, py, vx, vy, ts, k=10, eps_sq=25.0)
        ref = TF.adjacency_info(px, py, 25.0, 10)
        np.testing.assert_array_equal(out["senders"], ref["adj_list"][0])
        np.testing.assert_array_equal(out["receivers"], ref["adj_list"][1])
        np.testing.assert_array_equal(out["degree"], ref["degree"])
        data = {"meas_px": px, "meas_py": py, "meas_vx": vx, "meas_vy": vy,
                "meas_timestamp": ts}
        np.testing.assert_allclose(out["edge_feat"], TF.edge_features_np(data, ref["adj_list"]),
                                   rtol=1e-5, atol=1e-6)
    finally:
        TN._lib.cache_clear()


# ------------------------------------------------------------ the staged batch copy
_BUSY_CYCLES = 100_000_000  # torch.cuda._sleep: ~60 ms of a busy card


def _spoil(batch) -> None:
    """Overwrite a numpy batch in place: NaN floats, zero integers, flipped masks."""
    for a in S._batch_leaves(batch):
        a[...] = np.nan if a.dtype.kind == "f" else (~a if a.dtype == bool else 0)


def test_caller_may_overwrite_its_arrays_once_run_returns(cuda_device):
    """The eval step's numpy batch overwritten as soon as the call returns,
    while the card is still busy (a queued sleep holds the copy back, and
    the call returned without waiting for it): each replay's metrics equal
    those of the untouched batch, bit for bit where two replays of it
    agree bit for bit (else within 1e-6)."""
    cfg = tiny_test_config()
    state = S.create_train_state(cfg, torch.Generator().manual_seed(0), device=cuda_device)
    eval_step = S.make_eval_step(cfg)
    batches = [_tiny_batch(cfg, seed=s) for s in (7, 8)]
    want = [[eval_step(state.model, b) for b in batches] for _ in range(2)]
    for i, b in enumerate(batches):
        mine = copy.deepcopy(b)
        torch.cuda._sleep(_BUSY_CYCLES)
        got = eval_step(state.model, mine)
        busy = torch.cuda.Event()
        busy.record()
        assert not busy.query()  # the copy is still queued behind the sleep
        _spoil(mine)
        _bitwise_or_close(got, want[0][i], want[1][i], dict(rtol=1e-6, atol=1e-7))
    assert eval_step.captured.replays == 6


def test_closed_loop_without_host_sync_equals_synced_loop(cuda_device):
    """Alternating batches through the train and eval steps with no host
    sync between steps (after the captures, which synchronise, the host
    queued behind a sleep, so it runs ahead of the card) against the same
    loop with ``torch.cuda.synchronize()`` after every step: every step's
    train and eval metrics, the parameters and the momentum bit for bit
    where two synced loops agree bit for bit (else within 1e-5, the
    momentum 1e-4 of its largest element)."""
    cfg = tiny_test_config()
    batches = [_tiny_batch(cfg, seed=s) for s in (4, 5)]
    train_step, eval_step = S.make_train_step(cfg), S.make_eval_step(cfg)
    runs = []
    for synced in (False, True, True):
        state = S.create_train_state(cfg, torch.Generator().manual_seed(0), device=cuda_device)
        out = {}
        for i in range(6):
            if i == 1 and not synced:
                torch.cuda._sleep(_BUSY_CYCLES)
            state, m = train_step(state, batches[i % 2])
            if synced:
                torch.cuda.synchronize()
            e = eval_step(state.model, batches[(i + 1) % 2])
            if synced:
                torch.cuda.synchronize()
            out.update({f"train{i}.{k}": v for k, v in m.items()})
            out.update({f"eval{i}.{k}": v for k, v in e.items()})
        runs.append({**out, **{k: v.clone() for k, v in _params_and_moments(state).items()}})
    _bitwise_or_close(*runs, dict(rtol=1e-5, atol=1e-6))


def test_traced_copy_counts_staged_bytes_and_waits(cuda_device, traced):
    """With the tracer on: a train step's copies stage every byte of the
    numpy batch (``captured.staged_bytes``), all of it pageable as the
    caller gave it (``captured.pageable_bytes``), and a copy that finds its
    pinned buffer still on its way waits for it once (``captured.
    staging_waits``: the third copy behind a sleep).  A graph fed a numpy
    array, a pinned CPU tensor and a CUDA tensor stages the first two and
    copies the third on the device; its replays read all three."""
    cfg = tiny_test_config()
    batches = [_tiny_batch(cfg, seed=s) for s in (1, 2)]
    state = S.create_train_state(cfg, torch.Generator().manual_seed(0), device=cuda_device)
    step = S.make_train_step(cfg)
    traced.enable()
    step(state, batches[0])  # the capture
    traced.drain()
    torch.cuda._sleep(_BUSY_CYCLES)
    n = 4
    for i in range(n):
        state, _ = step(state, batches[i % 2])
    counters = traced.drain()["counters"]
    host = sum(a.nbytes for a in S._batch_leaves(batches[0]))
    assert counters["captured.staged_bytes"] == n * host
    assert counters["captured.pageable_bytes"] == n * host
    assert counters["captured.copy_bytes"] == n * host
    assert counters["captured.staging_waits"] >= 1

    cap = S.CapturedGraphs()
    rng = np.random.default_rng(0)
    for k in range(3):
        leaves = [rng.normal(size=(5, 3)).astype(np.float32),
                  torch.from_numpy(rng.integers(0, 9, (7,), dtype=np.int32)).pin_memory(),
                  torch.from_numpy(rng.random(4) < 0.5).to(cuda_device)]
        out = cap.run("mixed", leaves, lambda x: (x[0] * 2, x[1] + 1, ~x[2]), cuda_device)
        assert torch.equal(out[0].cpu(), torch.from_numpy(leaves[0]) * 2)
        assert torch.equal(out[1].cpu(), leaves[1] + 1) and torch.equal(out[2], ~leaves[2])
    counters = traced.drain()["counters"]
    entry = next(iter(cap.graphs.values()))
    flat = entry.staging.flat.untyped_storage().data_ptr()
    assert [t.untyped_storage().data_ptr() == flat for t in entry.staging.inputs] == [True, True, False]
    assert counters["captured.staged_bytes"] == 2 * (5 * 3 * 4 + 7 * 4)
    assert counters["captured.pageable_bytes"] == 2 * 5 * 3 * 4
    assert counters["captured.copy_bytes"] == 2 * (5 * 3 * 4 + 7 * 4 + 4)


# ------------------------------------------------------------ RadarGNNv2 (GATv2)
GAT_TINY = dict(hidden_node_channels_gat=32, num_heads_gat=4)


def _v2_state(cfg, device):
    return S.create_train_state(cfg, torch.Generator().manual_seed(0), device=device,
                                model_cls=G.RadarGNNv2)


def test_captured_v2_step_equals_eager_step(cuda_device):
    """Three train steps of a ``RadarGNNv2`` state replayed from one captured
    CUDA graph against the same step run eagerly on the card from the same
    seed: metrics and params within 1e-5 (the heads' and encoders'
    backward sum with atomics); one
    capture, three replays.  Its eval step, captured, against its body."""
    tol = dict(rtol=1e-5, atol=1e-6)
    cfg = tiny_test_config(**GAT_TINY)
    batches = [_tiny_batch(cfg, seed=s) for s in (4, 5, 6)]
    step, loss_fn = S.make_train_step(cfg), S.make_loss_fn(cfg)
    cap, eager = _v2_state(cfg, cuda_device), _v2_state(cfg, cuda_device)
    for batch in batches:
        cap, m_cap = step(cap, batch)
        m_eager = S._train_body(eager, S.batch_on(batch, cuda_device), loss_fn, cfg)
        assert float(m_cap["skipped"]) == 0.0
        for k, v in m_eager.items():
            np.testing.assert_allclose(float(m_cap[k]), float(v), **tol, err_msg=k)
    assert step.captured.replays == 3 and len(step.captured.graphs) == 1
    assert (cap.step, cap.updates) == (eager.step, eager.updates) == (3, 3)
    want = eager.model.state_dict()
    for k, v in cap.model.state_dict().items():
        np.testing.assert_allclose(v.cpu().numpy(), want[k].cpu().numpy(), **tol, err_msg=k)
    eval_step = S.make_eval_step(cfg)
    for batch in batches:
        got = eval_step(cap.model, batch)
        ref = eval_step.body(cap.model, S.batch_on(batch, cuda_device))
        for k, v in ref.items():
            np.testing.assert_allclose(float(got[k]), float(v), **tol, err_msg=k)
    assert len(eval_step.captured.graphs) == 1


def _replay_kernels(step, state, batch):
    """Device kernels of one replay of ``step``'s captured graph."""
    from graph_neural_network_for_radar_perception_torch.utils.timing import profile_run

    return profile_run(lambda: step(state, batch))["device_kernels"]


def test_traced_v2_step_times_the_attention(cuda_device, traced, monkeypatch):
    """A ``RadarGNNv2`` train step at the configuration's widths (batch 4)
    captured with the tracer on: each of the 7 GATv2 convolutions is a
    ``gat.forward`` span inside ``train_step.forward`` and a ``gat.backward``
    span inside ``train_step.backward``, in every read replay; the counters
    ``gat.rounds`` (7 a run: the capture's two warm-ups and the capture),
    ``gat.fused_rounds`` (each of them took the kernel pair) and
    ``gat.alloc_bytes`` count, the last under one [B, E_cap, 512] f32 tensor
    a round (the kernel pair writes none).  The capture made with the tracer off
    holds no span, counts nothing, and its replay runs as many kernels as
    the traced one and as a capture of the conv without its tracing code:
    the spans are timing events and pass-through autograd nodes."""
    cfg = GNNConfig(batch_size=4)
    rounds = len(cfg.graph_convolution_stem_channels)
    batches = [_tiny_batch(cfg, seed=s) for s in (1, 2, 3)]
    step = S.make_train_step(cfg)
    state = _v2_state(cfg, cuda_device)
    n = 2 * traced.SAMPLE_EVERY
    traced.enable()
    for i in range(n):
        state, _ = step(state, batches[i % 3])
    out = traced.drain()
    traced.disable()
    assert out["counters"]["gat.rounds"] == rounds * (S.CapturedStep.WARMUP_RUNS + 1)
    assert out["counters"]["gat.fused_rounds"] == out["counters"]["gat.rounds"]
    # no [B, E_cap, 512] f32 intermediate a round: the node projections, the
    # output, the softmax statistics and the logits' scratch [B, E_cap, 8]
    b, e_cap = batches[0].graph.senders.shape
    assert 0 < out["counters"]["gat.alloc_bytes"] / out["counters"]["gat.rounds"] < (
        b * e_cap * cfg.hidden_node_channels_gat * 4)
    spans = out["spans"]
    replays = [s for s in spans if s["name"] == "train_step.replay" and s["where"] == "device"]
    read = [r for r in replays if _inner(spans, r)]
    assert len(read) == 2
    for r in read:
        inner = _inner(spans, r)
        by = {}
        for s in inner:
            by.setdefault(s["name"], []).append(s)
            assert r["start_ns"] - 1000 <= s["start_ns"] <= s["end_ns"] <= r["end_ns"] + 1000, s
        assert {k: len(v) for k, v in by.items()} == {
            "train_step.forward": 1, "train_step.backward": 1, "train_step.update": 1,
            "gat.forward": rounds, "gat.backward": rounds}
        fwd, bwd = by["train_step.forward"][0], by["train_step.backward"][0]
        assert all(s["parent"] == fwd["id"] for s in by["gat.forward"])
        assert all(s["parent"] == bwd["id"] for s in by["gat.backward"])
        # the backward's rounds run last-first and do not overlap
        ends = sorted((s["start_ns"], s["end_ns"]) for s in by["gat.backward"])
        assert all(a[1] <= b[0] + 1000 for a, b in zip(ends, ends[1:]))
    traced.enable()
    traced_kernels = _replay_kernels(step, state, batches[0])  # the traced capture
    traced.disable()
    traced.drain()
    state_off = _v2_state(cfg, cuda_device)
    step_off = S.make_train_step(cfg)
    step_off(state_off, batches[0])
    entry = next(iter(step_off.captured.graphs.values()))
    assert entry.marks == []
    off_kernels = _replay_kernels(step_off, state_off, batches[0])
    assert traced.drain()["counters"].get("gat.rounds", 0) == 0
    bare = S.make_train_step(cfg)
    state_bare = _v2_state(cfg, cuda_device)
    with monkeypatch.context() as m:
        m.setattr(G.GATv2Conv, "forward",
                  lambda self, x, ef, s, r, nm, em, layout=None:
                  self._attention(x, ef, s, r, em, layout))
        bare(state_bare, batches[0])
    bare_kernels = _replay_kernels(bare, state_bare, batches[0])
    assert off_kernels == bare_kernels == traced_kernels, (off_kernels, bare_kernels,
                                                           traced_kernels)

