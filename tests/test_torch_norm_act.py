"""Channel norm + activation as one function (``ops/norms.channel_norm_act``)
and its kernel pair (``csrc/norm_act.cu``).

On the CPU: the route is ``channel_norm`` and ``F.leaky_relu`` themselves
(output and gradients equal in float64); ``FFNBlock`` and ``ScalarNorm``
route every channel norm through it with the activation's slope; a width
the kernel pair refuses raises before any launch; a ``RadarGNN`` step
runs 29 sites and a ``RadarGNNv2`` step 22.

On a card (tests marked ``cuda``, skipped without one): the pair against
the plain path in float64 at the train cells' shapes, rows that fill no
whole block, a constant row, two launches bit for bit, and the counters
over one replay of a captured train step:

    python -m pytest --noconftest -q -m cuda tests/test_torch_norm_act.py
"""

import dataclasses
import types

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from graph_neural_network_for_radar_perception_torch.config.config import GNNConfig
from graph_neural_network_for_radar_perception_torch.data.pipeline import SyntheticRadarDataset
from graph_neural_network_for_radar_perception_torch.models import blocks as B
from graph_neural_network_for_radar_perception_torch.models.gat import RadarGNNv2
from graph_neural_network_for_radar_perception_torch.ops import norms as N
from graph_neural_network_for_radar_perception_torch.train import steps as S

SLOPES = (0.0, B.LEAKY_SLOPE, 1.0)
WIDTHS = (64, 128, 256)
# Channel-norm sites of one model call at the published widths (encoders,
# the rounds' update MLPs, the heads; the message rounds fuse their own).
SITES = {"RadarGNN": 29, "RadarGNNv2": 22}
# The kernel pair in f32 against the plain path in float64: each tensor's
# largest error within twice the plain f32 path's, plus ATOL of its scale
# (the pair sums rows, dgamma and dbeta in other orders).  The scale of y
# and dx is their largest element; that of dgamma and dbeta, sums over every
# element, the root of the sum of their terms' squares (dy z and dy: the
# size of a sum's rounding noise, which makes the plain path's error alone,
# a single draw of it, no bar).
ATOL = 1e-6


def _plain(x, gamma, beta, slope):
    return F.leaky_relu(N.channel_norm(x, gamma, beta), slope)


def _grads(fn, x, gamma, beta, slope, dy, dtype):
    leaves = [t.detach().to(dtype).clone().requires_grad_() for t in (x, gamma, beta)]
    y = fn(*leaves, slope)
    return [y.detach()] + list(torch.autograd.grad(y, leaves, dy.to(dtype)))


def _inputs(shape, seed, device="cpu"):
    gen = torch.Generator().manual_seed(seed)
    x = torch.randn(shape, generator=gen) * 3.0 + 0.5
    dy = torch.randn(shape, generator=gen)
    return x.to(device), torch.tensor([1.3], device=device), torch.tensor([-0.2], device=device), \
        dy.to(device)


@pytest.mark.parametrize("slope", SLOPES)
@pytest.mark.parametrize("d", WIDTHS)
def test_cpu_route_is_channel_norm_and_leaky_relu(d, slope):
    """On the CPU, output and every gradient equal the plain functions' in
    float64, gamma != 1 and beta != 0; no kernel launches."""
    x, gamma, beta, dy = _inputs((3, 37, d), seed=d)
    before = (N.channel_norm_act.launches, N.channel_norm_act.backward_launches)
    got = _grads(N.channel_norm_act, x, gamma, beta, slope, dy, torch.float64)
    want = _grads(_plain, x, gamma, beta, slope, dy, torch.float64)
    for a, b in zip(got, want):
        assert a.dtype == torch.float64 and torch.equal(a, b)
    assert (N.channel_norm_act.launches, N.channel_norm_act.backward_launches) == before


def _recorder(monkeypatch):
    """Record the slope of every ``channel_norm_act`` call, then run it."""
    calls, real = [], N.channel_norm_act

    def record(x, gamma, beta, slope, eps=N.EPS):
        calls.append(slope)
        return real(x, gamma, beta, slope, eps)

    monkeypatch.setattr(N, "channel_norm_act", record)
    return calls


@pytest.mark.parametrize("norm, activation, slopes", [
    ("channel_normalization", "leakyrelu", [B.LEAKY_SLOPE]),
    ("channel_normalization", "relu", [0.0]),
    ("channel_normalization", "swish", [1.0]),
    ("layer_normalization", "leakyrelu", []),
    ("group_normalization", "relu", []),
])
def test_ffn_block_routes_channel_norms_to_the_pair(monkeypatch, norm, activation, slopes):
    """A channel norm with leaky ReLU or ReLU is one call with the
    activation's slope; with swish the norm alone (slope 1), then the
    activation; layer and group norms never.  The output is the plain
    block's: linear, norm, activation."""
    calls = _recorder(monkeypatch)
    torch.manual_seed(0)
    blk = B.FFNBlock(24, 16, activation, norm, num_groups=4)
    B.init_parameters(blk, torch.Generator().manual_seed(1))
    with torch.no_grad():
        blk.norm.gamma.fill_(0.8)
        blk.norm.beta.fill_(0.1)
    x = torch.randn(2, 9, 24, dtype=torch.float64)
    blk = blk.double()
    got = blk(x)
    assert calls == slopes
    h = blk.linear(x)
    if norm == "channel_normalization":
        h = N.channel_norm(h, blk.norm.gamma, blk.norm.beta)
    elif norm == "layer_normalization":
        h = N.layer_norm(h, blk.norm.gamma, blk.norm.beta)
    else:
        h = N.group_norm(h, blk.norm.gamma, blk.norm.beta, 4)
    assert torch.equal(got, B.activation_fn(activation)(h))


def test_scalar_norm_alone_takes_the_pair_without_activation(monkeypatch):
    """A channel ``ScalarNorm`` alone (a residual projector's
    ``identity_norm``) is the pair at slope 1; a layer norm is not."""
    calls = _recorder(monkeypatch)
    x = torch.randn(4, 7, 32, dtype=torch.float64)
    norm = B.ScalarNorm("channel_normalization").double()
    B.init_parameters(norm, torch.Generator())
    assert torch.equal(norm(x), N.channel_norm(x, norm.gamma, norm.beta))
    B.ScalarNorm("layer_normalization").double()(x)
    assert calls == [1.0]


@pytest.mark.parametrize("d", [2, 6, 66, 1028])
def test_a_width_the_pair_refuses_raises_on_a_cuda_tensor(d):
    """A CUDA tensor whose last axis is no multiple of 4 from 4 to 1024
    raises ``ValueError`` before any launch (no fall-back)."""
    x = types.SimpleNamespace(shape=(8, 10, d), device=torch.device("cuda"),
                              dtype=torch.float32)
    before = N.channel_norm_act.launches
    with pytest.raises(ValueError, match="width"):
        N.channel_norm_act(x, None, None, B.LEAKY_SLOPE)
    assert N.channel_norm_act.launches == before


def _published(**overrides):
    """The published architecture (``GNNConfig()``) at small capacities."""
    return dataclasses.replace(GNNConfig(), max_nodes=64, max_clusters=32, batch_size=2,
                               **overrides)


def _batch(cfg, seed=2):
    return next(SyntheticRadarDataset(cfg, seed=seed, num_objects=3).batches(cfg.batch_size))


@pytest.mark.parametrize("model_cls", [None, RadarGNNv2], ids=["RadarGNN", "RadarGNNv2"])
def test_a_train_step_runs_every_channel_norm_through_the_route(monkeypatch, model_cls):
    """One loss and backward at the published architecture: 29 channel-norm
    sites in ``RadarGNN``, 22 in ``RadarGNNv2`` (no norm in its update
    MLPs), every one through ``channel_norm_act``."""
    calls = _recorder(monkeypatch)
    cfg = _published()
    kw = {} if model_cls is None else {"model_cls": model_cls}
    state = S.create_train_state(cfg, torch.Generator().manual_seed(0), device="cpu", **kw)
    loss, _ = S.make_loss_fn(cfg)(state.model, S.batch_on(_batch(cfg), "cpu"))
    loss.backward()
    name = "RadarGNN" if model_cls is None else "RadarGNNv2"
    assert len(calls) == SITES[name]
    assert set(calls) <= {B.LEAKY_SLOPE, 1.0}


# ------------------------------------------------------------------ card
pytest_cuda = pytest.mark.cuda
# The train cells' shapes: edge encoder, undirected link rows, nodes, clusters.
CARD_SHAPES = [(8, 10240, 128), (8, 5120, 64), (8, 768, 64), (8, 256, 64)]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card and nvcc")
    return torch.device("cuda")


def _scales(x, dy, ref):
    """The scales of (y, dx, dgamma, dbeta) for the float64 results ``ref``
    of inputs x, dy (ATOL's comment)."""
    x, dy = x.double(), dy.double()
    mu = x.mean(-1, keepdim=True)
    z = (x - mu) / ((((x - mu) ** 2).sum(-1, keepdim=True) / (x.shape[-1] - 1)).sqrt() + N.EPS)
    rss = lambda t: float(t.square().sum().sqrt())  # noqa: E731
    return [float(ref[0].abs().max()), float(ref[1][torch.isfinite(ref[1])].abs().max()),
            rss(dy * z), rss(dy)]


def _check_against_float64(got, f32, ref, scales, what):
    for name, a, p, want, scale in zip(("y", "dx", "dgamma", "dbeta"), got, f32, ref, scales):
        err = float((a.double() - want).abs().max())
        err_plain = float((p.double() - want).abs().max())
        assert torch.isfinite(a).all(), (what, name)
        assert err <= 2 * err_plain + ATOL * scale, (what, name, err, err_plain, scale)


@pytest_cuda
@pytest.mark.parametrize("slope", SLOPES)
@pytest.mark.parametrize("shape", CARD_SHAPES + [(3, 37, 64), (5, 13, 128), (1, 9, 1024)],
                         ids=lambda s: "x".join(map(str, s)))
def test_pair_matches_plain_path_in_float64(cuda_device, shape, slope):
    """The pair's output and gradients against the plain path in float64,
    within twice the plain f32 path's error; rows that fill no whole block
    (111, 65 and 9 rows); one launch each way."""
    x, gamma, beta, dy = _inputs(shape, seed=sum(shape), device=cuda_device)
    before = (N.channel_norm_act.launches, N.channel_norm_act.backward_launches)
    got = _grads(N.channel_norm_act, x, gamma, beta, slope, dy, torch.float32)
    assert (N.channel_norm_act.launches, N.channel_norm_act.backward_launches) == (
        before[0] + 1, before[1] + 1)
    f32 = _grads(_plain, x, gamma, beta, slope, dy, torch.float32)
    ref = _grads(_plain, x, gamma, beta, slope, dy, torch.float64)
    torch.cuda.synchronize()
    _check_against_float64(got, f32, ref, _scales(x, dy, ref), shape)


@pytest_cuda
def test_a_constant_row_gives_nan_dx_and_finite_affine_gradients(cuda_device):
    """A row with sigma = 0: its dx is NaN as the plain path's (through the
    sqrt's backward), every other row's finite; dgamma and dbeta finite and
    within the plain path's error."""
    x, gamma, beta, dy = _inputs((2, 40, 64), seed=7, device=cuda_device)
    x[0, 3] = 1.0
    x[1, 17] = 0.0
    got = _grads(N.channel_norm_act, x, gamma, beta, B.LEAKY_SLOPE, dy, torch.float32)
    plain = _grads(_plain, x, gamma, beta, B.LEAKY_SLOPE, dy, torch.float32)
    ref = _grads(_plain, x, gamma, beta, B.LEAKY_SLOPE, dy, torch.float64)
    torch.cuda.synchronize()
    nan_rows = torch.isnan(got[1]).any(-1)
    assert torch.equal(nan_rows, torch.isnan(plain[1]).any(-1))
    assert nan_rows.sum() == 2 and nan_rows[0, 3] and nan_rows[1, 17]
    assert torch.isfinite(got[1][~nan_rows]).all()
    _check_against_float64([got[0], got[1][~nan_rows], got[2], got[3]],
                           [plain[0], plain[1][~nan_rows], plain[2], plain[3]],
                           [ref[0], ref[1][~nan_rows], ref[2], ref[3]],
                           _scales(x, dy, ref), "constant row")


@pytest_cuda
@pytest.mark.parametrize("shape", [(8, 10240, 128), (8, 768, 64)], ids=["edges", "nodes"])
def test_two_launches_give_the_same_bits(cuda_device, shape):
    """Fixed-order sums: output, dx, dgamma and dbeta bit for bit."""
    x, gamma, beta, dy = _inputs(shape, seed=11, device=cuda_device)
    a = _grads(N.channel_norm_act, x, gamma, beta, B.LEAKY_SLOPE, dy, torch.float32)
    b = _grads(N.channel_norm_act, x, gamma, beta, B.LEAKY_SLOPE, dy, torch.float32)
    torch.cuda.synchronize()
    for u, v in zip(a, b):
        assert torch.equal(u, v)


@pytest_cuda
@pytest.mark.parametrize("model_cls", [None, RadarGNNv2], ids=["RadarGNN", "RadarGNNv2"])
def test_counters_of_one_captured_train_step(cuda_device, model_cls):
    """One replay of a captured train step at the published widths and
    batch 8 (``knn.train``'s and ``gat.train``'s model) advances both
    counters by the model's sites: 29 / 29 and 22 / 22."""
    cfg = dataclasses.replace(GNNConfig(), batch_size=8)
    kw = {} if model_cls is None else {"model_cls": model_cls}
    state = S.create_train_state(cfg, torch.Generator().manual_seed(0), device=cuda_device,
                                 **kw)
    it = SyntheticRadarDataset(cfg, seed=5, num_objects=4).batches(cfg.batch_size)
    step = S.make_train_step(cfg)
    state, _ = step(state, next(it))  # captures
    before = (N.channel_norm_act.launches, N.channel_norm_act.backward_launches)
    state, m = step(state, next(it))
    torch.cuda.synchronize()
    assert float(m["skipped"]) == 0.0 and step.captured.replays == 2
    sites = SITES["RadarGNN" if model_cls is None else "RadarGNNv2"]
    assert (N.channel_norm_act.launches - before[0],
            N.channel_norm_act.backward_launches - before[1]) == (sites, sites)
    assert np.isfinite(float(m["loss_total"]))
