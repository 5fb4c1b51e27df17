"""Masked segment reductions and node gathers over padded graphs.

These follow the JAX package's exact scatter/take path (the one it runs on
CPU): masked rows are routed to a void slot at ``num_segments`` that is cut
off afterwards, ids outside ``[0, num_segments)`` are dropped as
``jax.ops.segment_*`` drops them, and the masked max fills empty segments
with ``fill_value``.  The one-hot-matmul lowering the JAX package uses on a
TPU is a property of that chip and has no counterpart here.

A batch of graphs is a leading graph axis on the ids ([B, E]) and the data
([B, E, ...], nodes [B, N, ...]), as the JAX package's vmapped functions
take them: each graph's ids are offset into a segment range of its own
(its void slot included), so one scatter or gather serves every graph.
"""

from __future__ import annotations

from typing import Optional

import torch

_NEG_INF = -3.4e38  # large finite negative for masked max in f32


def _void_ids(segment_ids, num_segments, mask):
    """int64 ids with masked and out-of-range rows sent to the void slot
    num_segments; for a batch ([B, E]) offset by (num_segments + 1) per
    graph and flattened."""
    ids = segment_ids.long()
    keep = (ids >= 0) & (ids < num_segments)
    if mask is not None:
        keep = keep & mask
    ids = torch.where(keep, ids, torch.full_like(ids, num_segments))
    return _flat_rows(ids, num_segments + 1)


def _flat_rows(idx: torch.Tensor, rows: int) -> torch.Tensor:
    """idx [E] as it is; idx [B, E] (rows [0, rows) of each graph) as rows
    of the graphs' stacked [B * rows] table, flattened."""
    if idx.ndim == 1:
        return idx
    graphs = torch.arange(idx.shape[0], device=idx.device, dtype=idx.dtype)
    return (idx + graphs[:, None] * rows).reshape(-1)


def _tables(data: torch.Tensor, segment_ids: torch.Tensor, num_segments: int,
            fill: float):
    """(data with its graph and row axes as one, the per-graph tables
    [B * (num_segments + 1), ...] filled with ``fill``, and the function
    that cuts each graph's void slot off: [B, num_segments, ...], or
    [num_segments, ...] for a single graph)."""
    lead = tuple(segment_ids.shape[:-1])
    rest = tuple(data.shape[len(lead) + 1:])
    graphs = segment_ids.shape[0] if lead else 1
    out = data.new_full((graphs * (num_segments + 1),) + rest, fill)

    def cut(t):
        t = t.reshape(lead + (num_segments + 1,) + rest)
        return t.narrow(len(lead), 0, num_segments)

    return data.reshape((-1,) + rest), out, cut


def masked_segment_sum(
    data: torch.Tensor,
    segment_ids: torch.Tensor,
    num_segments: int,
    mask: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Sum ``data[e]`` into ``out[segment_ids[e]]``, skipping masked rows.

    data: [E, ...]; segment_ids: [E] int; mask: [E] bool or None;
    returns [num_segments, ...] (a batch: [B, E, ...], [B, E], [B, E] →
    [B, num_segments, ...])."""
    ids = _void_ids(segment_ids, num_segments, mask)
    data, out, cut = _tables(data, segment_ids, num_segments, 0.0)
    out.index_add_(0, ids, data)
    return cut(out)


def masked_segment_max(
    data: torch.Tensor,
    segment_ids: torch.Tensor,
    num_segments: int,
    mask: Optional[torch.Tensor] = None,
    fill_value: float = 0.0,
) -> torch.Tensor:
    """Max-reduce ``data`` per segment; masked rows are ignored and segments
    with no contributing row get ``fill_value`` (a batch as
    ``masked_segment_sum``)."""
    ids = _void_ids(segment_ids, num_segments, mask)
    if mask is not None:
        bmask = mask.reshape(mask.shape + (1,) * (data.ndim - mask.ndim))
        data = torch.where(bmask, data, torch.full_like(data, _NEG_INF))
    data, out, cut = _tables(data, segment_ids, num_segments, _NEG_INF)
    index = ids.view((-1,) + (1,) * (data.ndim - 1)).expand_as(data)
    out = cut(out.scatter_reduce(0, index, data, reduce="amax", include_self=True))
    return torch.where(out <= _NEG_INF / 2, torch.full_like(out, fill_value), out)


def masked_segment_mean(
    data: torch.Tensor,
    segment_ids: torch.Tensor,
    num_segments: int,
    mask: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Mean per segment over unmasked rows (empty segments → 0)."""
    total = masked_segment_sum(data, segment_ids, num_segments, mask)
    ones = data.new_ones(segment_ids.shape)
    count = masked_segment_sum(ones, segment_ids, num_segments, mask)
    if data.ndim > segment_ids.ndim:
        count = count[..., None]
    return total / torch.clamp(count, min=1.0)


def gather_nodes(node_feat: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Gather node rows by edge endpoint index: [N, D], [E] → [E, D] (a
    batch: [B, N, D], [B, E] → [B, E, D], each graph its own rows).

    Indices must lie in [0, N); the graphs ``pad_frame`` builds pad their
    edge lists with 0."""
    if idx.ndim == 1:
        return node_feat.index_select(0, idx.long())
    rest = tuple(node_feat.shape[2:])
    rows = _flat_rows(idx.long(), node_feat.shape[1])
    out = node_feat.reshape((-1,) + rest).index_select(0, rows)
    return out.reshape(tuple(idx.shape) + rest)


def segment_softmax(
    logits: torch.Tensor,
    segment_ids: torch.Tensor,
    num_segments: int,
    mask: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Numerically-stable softmax within each segment (GAT attention).

    logits: [E] or [E, H] (a batch: [B, E] or [B, E, H] with ids [B, E]);
    returns the same shape.  Each row's segment max (0 for a segment no
    unmasked row reaches) is subtracted, masked rows get weight 0, and the
    denominator is clamped at 1e-16.  A row's segment is read at its id
    clamped into [0, num_segments), as the JAX gather clamps; such rows are
    masked by every caller."""
    seg_max = masked_segment_max(logits, segment_ids, num_segments, mask,
                                 fill_value=0.0)
    rows = segment_ids.long().clamp(0, num_segments - 1)
    exp = torch.exp(logits - gather_nodes(seg_max, rows))
    if mask is not None:
        bmask = mask.reshape(mask.shape + (1,) * (exp.ndim - mask.ndim))
        exp = torch.where(bmask, exp, torch.zeros_like(exp))
    denom = masked_segment_sum(exp, segment_ids, num_segments, mask)
    return exp / torch.clamp(gather_nodes(denom, rows), min=1e-16)


def segment_count(segment_ids: torch.Tensor, num_segments: int,
                  mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """f32 count of the unmasked rows in each segment."""
    ones = torch.ones(segment_ids.shape, dtype=torch.float32,
                      device=segment_ids.device)
    return masked_segment_sum(ones, segment_ids, num_segments, mask)
