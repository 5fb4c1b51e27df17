"""The port's CUDA kernels on a card, against their plain PyTorch versions,
and the training step on the card against the same on the CPU.

Imports nothing of JAX, so that it runs on a machine without it:

    python -m pytest --noconftest -q -m cuda tests/test_torch_cuda.py

Every test skips without a CUDA card."""

import numpy as np
import pytest
import torch

from chip_smoke import (
    banded_edges,
    bf16_verdict,
    csr_problem,
    drop_kink_edges,
    drop_kink_edges_csr,
    knn_edges,
)
from graph_neural_network_for_radar_perception_torch.config.config import (
    tiny_test_config,
)
from graph_neural_network_for_radar_perception_torch.core.graph import RadarGraph
from graph_neural_network_for_radar_perception_torch.data.pipeline import (
    SyntheticRadarDataset,
    pad_frame,
)
from graph_neural_network_for_radar_perception_torch.models.gnn import RadarGNN
from graph_neural_network_for_radar_perception_torch.ops import csr_mp as C
from graph_neural_network_for_radar_perception_torch.ops import fused_mp as FM
from graph_neural_network_for_radar_perception_torch.scripts import (
    microbench_gather as MB,
)
from graph_neural_network_for_radar_perception_torch.train import steps as S

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
    rounds = len(cfg.graph_convolution_stem_channels) * cfg.batch_size
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
    rounds = len(cfg.graph_convolution_stem_channels) * cfg.batch_size
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
    rounds = len(cfg.graph_convolution_stem_channels) * cfg.batch_size
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
