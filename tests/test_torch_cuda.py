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
from graph_neural_network_for_radar_perception_torch.train import steps as S

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card and nvcc")
    return torch.device("cuda")


def _problem(seed, n, e, d, de, h, d2, device):
    """Random round with sentinel padding and one-sided sentinels."""
    rng = np.random.default_rng(seed)
    s = rng.integers(0, n, size=e).astype(np.int32)
    r = rng.integers(0, n, size=e).astype(np.int32)
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


@pytest.mark.parametrize("shape", [
    dict(n=768, e=15360, d=64, de=64, h=128, d2=64),   # deploy shapes
    dict(n=768, e=15357, d=64, de=64, h=128, d2=64),   # ragged E
    dict(n=64, e=300, d=16, de=16, h=32, d2=16),       # tiny_test_config
], ids=["deploy", "ragged", "tiny"])
def test_kernel_matches_plain(cuda_device, shape):
    args = _problem(0, device=cuda_device, **shape)
    before = FM.fused_message_pass.launches
    got = FM.fused_message_pass(*args, 0.01)
    torch.cuda.synchronize()
    assert FM.fused_message_pass.launches == before + 1
    want = FM.fused_message_pass_reference(*args, 0.01)
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(),
                               rtol=2e-4, atol=2e-5)


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
], ids=["main", "ragged", "tiny"])
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
CSR_CASES = {  # edges(rng), n, e_total, widths (d, de, h, d2), tiling
    "knn": (lambda rng: knn_edges(rng, 768, 10), 768, 15360, (64, 64, 128, 64), (512, 256, 0)),
    "knn-ragged": (lambda rng: knn_edges(rng, 768, 10), 768, 15357, (64, 64, 128, 64), (512, 256, 0)),
    "banded-src-window": (lambda rng: banded_edges(768, 6), 768, 15360, (64, 64, 128, 64), (512, 256, 256)),
    "tiny": (lambda rng: knn_edges(rng, 64, 6), 64, 600, (16, 16, 32, 16), (128, 64, 0)),
}


def _csr_case(name, seed, device):
    edges, n, e_total, (d, de, h, d2), tiling = CSR_CASES[name]
    rng = np.random.default_rng(seed)
    args = csr_problem(torch, rng, edges(rng), e_total, n, d, de, h, d2, device)
    return args, tiling, rng


@pytest.mark.parametrize("case", list(CSR_CASES))
def test_csr_kernel_matches_plain(cuda_device, case):
    """The forward kernel against its plain version at the deploy
    tolerance of chip_smoke's [kernel] phase, and bitwise across launches."""
    args, (tile, window, src_window), _ = _csr_case(case, 0, cuda_device)
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


@pytest.mark.parametrize("case", list(CSR_CASES))
def test_csr_backward_kernel_matches_plain(cuda_device, case):
    """All 10 outputs at the gradient tolerance with a cotangent of a train
    step's scale, kink edges dropped (chip_smoke.drop_kink_edges_csr), and
    bitwise across launches."""
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
