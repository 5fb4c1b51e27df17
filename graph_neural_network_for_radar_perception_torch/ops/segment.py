"""Masked segment reductions and node gathers over padded graphs.

These follow the JAX package's exact scatter/take path (the one it runs on
CPU): masked rows are routed to a void slot at ``num_segments`` that is cut
off afterwards, ids outside ``[0, num_segments)`` are dropped as
``jax.ops.segment_*`` drops them, and the masked max fills empty segments
with ``fill_value``.  The one-hot-matmul lowering the JAX package uses on a
TPU is a property of that chip and has no counterpart here.
"""

from __future__ import annotations

from typing import Optional

import torch

_NEG_INF = -3.4e38  # large finite negative for masked max in f32


def _void_ids(segment_ids, num_segments, mask):
    """int64 ids with masked and out-of-range rows sent to the void slot."""
    ids = segment_ids.long()
    keep = (ids >= 0) & (ids < num_segments)
    if mask is not None:
        keep = keep & mask
    return torch.where(keep, ids, torch.full_like(ids, num_segments))


def masked_segment_sum(
    data: torch.Tensor,
    segment_ids: torch.Tensor,
    num_segments: int,
    mask: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Sum ``data[e]`` into ``out[segment_ids[e]]``, skipping masked rows.

    data: [E, ...]; segment_ids: [E] int; mask: [E] bool or None;
    returns [num_segments, ...]."""
    ids = _void_ids(segment_ids, num_segments, mask)
    out = data.new_zeros((num_segments + 1,) + tuple(data.shape[1:]))
    out.index_add_(0, ids, data)
    return out[:num_segments]


def masked_segment_max(
    data: torch.Tensor,
    segment_ids: torch.Tensor,
    num_segments: int,
    mask: Optional[torch.Tensor] = None,
    fill_value: float = 0.0,
) -> torch.Tensor:
    """Max-reduce ``data`` per segment; masked rows are ignored and segments
    with no contributing row get ``fill_value``."""
    ids = _void_ids(segment_ids, num_segments, mask)
    if mask is not None:
        bmask = mask if data.ndim == 1 else mask[:, None]
        data = torch.where(bmask, data, torch.full_like(data, _NEG_INF))
    out = data.new_full((num_segments + 1,) + tuple(data.shape[1:]), _NEG_INF)
    index = ids.view((-1,) + (1,) * (data.ndim - 1)).expand_as(data)
    out = out.scatter_reduce(0, index, data, reduce="amax", include_self=True)
    out = out[:num_segments]
    return torch.where(out <= _NEG_INF / 2, torch.full_like(out, fill_value), out)


def masked_segment_mean(
    data: torch.Tensor,
    segment_ids: torch.Tensor,
    num_segments: int,
    mask: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Mean per segment over unmasked rows (empty segments → 0)."""
    total = masked_segment_sum(data, segment_ids, num_segments, mask)
    ones = data.new_ones(data.shape[:1])
    count = masked_segment_sum(ones, segment_ids, num_segments, mask)
    if data.ndim > 1:
        count = count[:, None]
    return total / torch.clamp(count, min=1.0)


def gather_nodes(node_feat: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Gather node rows by edge endpoint index: [N, D], [E] → [E, D].

    Indices must lie in [0, N); the graphs ``pad_frame`` builds pad their
    edge lists with 0."""
    return node_feat.index_select(0, idx.long())
