"""The reference's three custom normalisations, mask-aware.

The reference defines (modules/neural_net/common.py:208-253):

* ``channel_normalization`` — per-row stats over the feature axis;
* ``layer_normalization``   — stats over the *whole tensor*;
* ``group_normalization``   — stats per channel-group over (rows, group dim),
  i.e. coupled across the node axis.

All three use the Bessel-corrected std (``torch.std``, ddof=1), add eps to
the *std* (not the variance), and take a single scalar affine pair (γ, β).
With padded static shapes, layer/group statistics exclude masked rows.
A batch of graphs (x [B, N, D], mask [B, N]) takes each graph's own
statistics, as the JAX package's vmapped norms do.
``torch.nn.LayerNorm`` / ``GroupNorm`` are not these functions.

``channel_norm_act`` is a channel norm and the leaky ReLU after it (ReLU at
slope 0, no activation at slope 1) as one differentiable function: on a
CUDA tensor the kernel pair of ``csrc/norm_act.cu`` (one launch forward,
two backward), on the CPU ``channel_norm`` and ``F.leaky_relu``.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch
import torch.nn.functional as F

from ..core.capture import count_launches
from ._build import load

EPS = 1e-5  # reference modules/neural_net/constants.py:9
MAX_WIDTH = 1024  # the kernel pair's widest row (csrc/norm_act.cu)


def _bessel_std(sum_x, sum_x2, count):
    """Mean and std with ddof=1 from accumulated moments; guards count<=1."""
    mean = sum_x / torch.clamp(count, min=1.0)
    var = (sum_x2 - count * mean * mean) / torch.clamp(count - 1.0, min=1.0)
    return mean, torch.sqrt(torch.clamp(var, min=0.0))


def channel_norm(x: torch.Tensor, gamma, beta, eps: float = EPS) -> torch.Tensor:
    """Per-row normalisation over the last axis (reference common.py:208-220).

    Padded rows produce values that downstream masks discard, so no mask is
    needed."""
    mean = x.mean(dim=-1, keepdim=True)
    n = x.shape[-1]
    var = ((x - mean) ** 2).sum(dim=-1, keepdim=True) / max(n - 1, 1)
    return gamma * ((x - mean) / (torch.sqrt(var) + eps)) + beta


def layer_norm(
    x: torch.Tensor, gamma, beta, mask: Optional[torch.Tensor] = None,
    eps: float = EPS,
) -> torch.Tensor:
    """Whole-tensor normalisation (reference common.py:223-233), per graph
    for a batch (x [B, N, D]: statistics over each graph's [N, D]).

    mask: [N] bool over rows of x [N, D] ([B, N]); masked rows are excluded
    from the statistics but still transformed (then discarded
    downstream)."""
    graph = (-2, -1)  # one graph's axes
    if mask is None:
        mean = x.mean(graph, keepdim=True)
        var = ((x - mean) ** 2).sum(graph, keepdim=True) / max(x.shape[-2] * x.shape[-1] - 1, 1)
        std = torch.sqrt(var)
    else:
        m = mask.to(x.dtype)[..., None]
        count = m.sum(graph, keepdim=True) * x.shape[-1]
        mean, std = _bessel_std((x * m).sum(graph, keepdim=True),
                                (x * x * m).sum(graph, keepdim=True), count)
    return gamma * ((x - mean) / (std + eps)) + beta


def group_norm(
    x: torch.Tensor, gamma, beta, num_groups: int,
    mask: Optional[torch.Tensor] = None, eps: float = EPS,
) -> torch.Tensor:
    """Group normalisation with node-coupled statistics (reference
    common.py:236-253): x [N, D] → [N, G, D/G], stats over (N, D/G) per
    group (per graph for a batch, x [B, N, D]).  mask excludes padded rows
    from the statistics."""
    *lead, n, d = x.shape
    g = num_groups
    xg = x.reshape(*lead, n, g, d // g)
    stats = (-3, -1)  # a group's axes within one graph
    if mask is None:
        mean = xg.mean(dim=stats, keepdim=True)
        cnt = n * (d // g)
        var = ((xg - mean) ** 2).sum(dim=stats, keepdim=True) / max(cnt - 1, 1)
        std = torch.sqrt(var)
    else:
        m = mask.to(x.dtype)[..., None, None]
        count = m.sum(dim=(-3, -2, -1), keepdim=True) * (d // g)
        mean, std = _bessel_std(
            (xg * m).sum(dim=stats, keepdim=True),
            (xg * xg * m).sum(dim=stats, keepdim=True),
            count,
        )
    out = gamma * ((xg - mean) / (std + eps)) + beta
    return out.reshape(x.shape)


# ------------------------------------------------- channel norm + activation
def _entry(name: str, argtypes, restype=ctypes.c_int):
    fn = getattr(load("norm_act"), name)
    fn.argtypes, fn.restype = argtypes, restype
    return fn


@functools.lru_cache(maxsize=None)
def _forward_kernel():
    p, f = ctypes.c_void_p, ctypes.c_float
    return _entry("norm_act_forward",
                  [p, p, p, f, f, p, p, ctypes.c_longlong, ctypes.c_int, p])


@functools.lru_cache(maxsize=None)
def _backward_kernel():
    p, f = ctypes.c_void_p, ctypes.c_float
    return _entry("norm_act_backward",
                  [p] * 5 + [f, f] + [p] * 3 + [ctypes.c_longlong, ctypes.c_int, p])


@functools.lru_cache(maxsize=None)
def _backward_blocks(rows: int, d: int, device) -> int:
    """The partials of a backward over rows x d on ``device`` (asked once)."""
    fn = _entry("norm_act_backward_blocks", [ctypes.c_longlong, ctypes.c_int])
    with torch.cuda.device(device):
        blocks = fn(rows, d)
    if blocks < 0:
        raise RuntimeError(f"norm_act_backward_blocks failed: cudaError_t {-blocks}")
    return blocks


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """t contiguous and 16-byte aligned (a copy if it is not)."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _stream():
    return torch.cuda.current_stream().cuda_stream


def _check(x, gamma, beta) -> None:
    """What the kernel pair takes: f32 on one card, the last axis a
    multiple of 4 from 4 to ``MAX_WIDTH``, scalar γ and β."""
    d = x.shape[-1]
    if d % 4 or not 4 <= d <= MAX_WIDTH:
        raise ValueError(f"channel_norm_act: width {d}; the kernel pair takes a multiple "
                         f"of 4 from 4 to {MAX_WIDTH}")
    if x.device.type != "cuda":
        raise ValueError(f"channel_norm_act: no kernel for device {x.device}")
    for name, t in (("x", x), ("gamma", gamma), ("beta", beta)):
        if t.dtype != torch.float32 or t.device != x.device:
            raise ValueError(f"channel_norm_act: {name} is {t.dtype} on {t.device}, "
                             f"expected float32 on {x.device}")
    if gamma.numel() != 1 or beta.numel() != 1:
        raise ValueError("channel_norm_act: gamma and beta are scalars")


def _forward(x, gamma, beta, slope, eps):
    """y and each row's (μ, 1/(σ+ε)) [rows, 2] over the rows of x (every
    axis but the last): one launch."""
    d = x.shape[-1]
    rows = x.numel() // d
    y = torch.empty_like(x)
    stats = torch.empty(rows, 2, dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        rc = _forward_kernel()(x.data_ptr(), gamma.data_ptr(), beta.data_ptr(), slope, eps,
                               y.data_ptr(), stats.data_ptr(), rows, d, _stream())
    if rc != 0:
        raise RuntimeError(f"norm_act_forward failed: cudaError_t {rc}")
    channel_norm_act.launches += 1
    return y, stats


def _backward(x, g, gamma, beta, stats, slope, eps):
    """(dx, [dγ, dβ]) for the cotangent g of y: two launches."""
    d = x.shape[-1]
    rows = x.numel() // d
    emp = functools.partial(torch.empty, dtype=torch.float32, device=x.device)
    dx, dgb = torch.empty_like(x), emp(2)
    partials = emp(max(_backward_blocks(rows, d, x.device), 1), 2)
    with torch.cuda.device(x.device):
        rc = _backward_kernel()(x.data_ptr(), g.data_ptr(), gamma.data_ptr(), beta.data_ptr(),
                                stats.data_ptr(), slope, eps, dx.data_ptr(),
                                partials.data_ptr(), dgb.data_ptr(), rows, d, _stream())
    if rc != 0:
        raise RuntimeError(f"norm_act_backward failed: cudaError_t {rc}")
    channel_norm_act.backward_launches += 1
    return dx, dgb


class _ChannelNormAct(torch.autograd.Function):
    """Autograd node of the kernel pair: the forward saves x and each row's
    statistics; the backward recomputes the rest from them."""

    @staticmethod
    def forward(ctx, x, gamma, beta, slope, eps):
        y, stats = _forward(x, gamma, beta, slope, eps)
        ctx.save_for_backward(x, gamma, beta, stats)
        ctx.slope, ctx.eps = slope, eps
        return y

    @staticmethod
    def backward(ctx, g):
        x, gamma, beta, stats = ctx.saved_tensors
        # a cotangent may come strided or broadcast
        dx, dgb = _backward(x, _aligned(g), gamma, beta, stats, ctx.slope, ctx.eps)
        return dx, dgb[0:1].view_as(gamma), dgb[1:2].view_as(beta), None, None


def channel_norm_act(x: torch.Tensor, gamma, beta, slope: float,
                     eps: float = EPS) -> torch.Tensor:
    """``F.leaky_relu(channel_norm(x, gamma, beta), slope)``, differentiable:
    slope 0 is ReLU, slope 1 no activation.  On a CPU tensor the plain
    functions themselves; on a CUDA tensor the kernel pair, or a
    ``ValueError`` for what it does not take (``_check``).
    ``channel_norm_act.launches`` and ``.backward_launches`` count the C
    calls."""
    if x.device.type == "cpu":
        y = channel_norm(x, gamma, beta, eps)
        if slope == 1.0:
            return y
        return F.relu(y) if slope == 0.0 else F.leaky_relu(y, slope)
    _check(x, gamma, beta)
    return _ChannelNormAct.apply(_aligned(x), gamma, beta, float(slope), float(eps))


channel_norm_act.launches = 0
channel_norm_act.backward_launches = 0
# A replay of a captured graph advances them by what its capture launched.
count_launches((channel_norm_act, "launches"), (channel_norm_act, "backward_launches"))
