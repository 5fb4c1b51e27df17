"""The port's CUDA kernel on a card, against its plain PyTorch version.

Imports nothing of JAX, so that it runs on a machine without it:

    python -m pytest --noconftest -q -m cuda tests/test_torch_cuda.py

Every test skips without a CUDA card."""

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
from graph_neural_network_for_radar_perception_torch.models.gnn import RadarGNN
from graph_neural_network_for_radar_perception_torch.ops import fused_mp as FM

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
