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
"""

from __future__ import annotations

from typing import Optional

import torch

EPS = 1e-5  # reference modules/neural_net/constants.py:9


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
