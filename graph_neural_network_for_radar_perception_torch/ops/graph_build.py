"""Static-shape graph construction on the device (kNN + ball query).

The JAX package's ``ops/graph_build.py`` as torch ops that run wherever their
inputs lie (the card or the CPU), the device twin of the reference's
per-sample numpy graph builder (modules/compute_features/graph_features.py:
11-114): dense pairwise squared-L2 matrix, ball query for node degree, kNN
(symmetrised) for the adjacency, and edge-list extraction, all with fixed
shapes:

* nodes are padded to N capacity with a boolean mask;
* the directed edge list has fixed capacity E and row-major order over the
  [N, N] adjacency, as ``np.where`` gives it, so it matches the reference's
  ``adj_list`` element for element on the valid prefix;
* the undirected (triu) edge list has fixed capacity EU and matches the
  reference's ``torch.nonzero(torch.triu(adj))`` enumeration
  (gnn_blocks.py:295-296).

Three choices keep the JAX results: distances are the broadcast difference
squared and summed (``torch.cdist`` rounds otherwise and moves neighbours);
the k nearest come from a stable sort of each row, so that ties go to the
lowest index as ``jax.lax.top_k`` breaks them (``torch.topk`` promises no
order for ties); and stream compaction is a cumsum plus a scatter into
``capacity + 1`` slots with overflow dropped, with no host sync and no
data-dependent shape (unlike ``torch.nonzero``).  Nothing on the serving
path calls it yet (ROADMAP.md B2).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

_INF = 3.4e38


class GraphStructure(NamedTuple):
    senders: torch.Tensor        # [E] int32
    receivers: torch.Tensor      # [E] int32
    edge_mask: torch.Tensor      # [E] bool
    und_senders: torch.Tensor    # [EU] int32
    und_receivers: torch.Tensor  # [EU] int32
    und_mask: torch.Tensor       # [EU] bool
    degree: torch.Tensor         # [N] float32 — ball-query degree (graph_features.py:78)


def _eye(n: int, device) -> torch.Tensor:
    return torch.eye(n, dtype=torch.bool, device=device)


def pairwise_sq_dist(points: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """[N,2], [N] → [N,N] squared L2; invalid pairs get +inf (3.4e38)."""
    diff = points[:, None, :] - points[None, :, :]
    d2 = torch.sum(diff * diff, dim=-1)
    valid = mask[:, None] & mask[None, :]
    return torch.where(valid, d2, torch.full_like(d2, _INF))


def compact_nonzero(flag: torch.Tensor, capacity: int):
    """Row-major stream compaction of a boolean [N, M] matrix.

    Returns (rows, cols, mask) of shape [capacity], int32/int32/bool, in the
    order of ``np.where(flag)``.  Entries beyond the true count are masked
    and point at (0, 0); entries beyond the capacity are dropped."""
    n, m = flag.shape
    flat = flag.reshape(-1)
    pos = torch.cumsum(flat.to(torch.int64), 0) - 1
    total = pos[-1] + 1
    # Unflagged entries and those past the capacity all land in the extra
    # slot, which is cut off.
    idx = torch.where(flat, pos, capacity).clamp_(max=capacity)
    out = torch.zeros(capacity + 1, dtype=torch.int64, device=flag.device)
    out.scatter_(0, idx, torch.arange(n * m, device=flag.device))
    out = out[:capacity]
    emask = torch.arange(capacity, device=flag.device) < total
    rows = torch.where(emask, out // m, 0).to(torch.int32)
    cols = torch.where(emask, out % m, 0).to(torch.int32)
    return rows, cols, emask


def knn_adjacency_matrix(d2: torch.Tensor, mask: torch.Tensor, k: int) -> torch.Tensor:
    """Symmetrised kNN boolean adjacency (reference compute_knn,
    graph_features.py:25-44): each valid node links to its k nearest valid
    neighbours (ties by lowest index); the matrix is OR-ed with its
    transpose and the diagonal cleared.  When n_valid <= k, all valid
    pairs connect."""
    n = d2.shape[0]
    kk = min(k + 1, n)  # includes self (distance 0), dropped below
    nbr_d, nbr = torch.sort(d2, dim=1, stable=True)  # ties: lowest index first
    nbr_d, nbr = nbr_d[:, :kk], nbr[:, :kk]
    # +inf in a neighbour slot means it is invalid (fewer than kk valid nodes).
    valid_slot = (nbr_d < torch.full_like(nbr_d, _INF)) & mask[:, None]
    safe_nbr = torch.where(valid_slot, nbr, 0)
    hits = torch.zeros(n, n, dtype=torch.int32, device=d2.device)
    hits.scatter_add_(1, safe_nbr, valid_slot.to(torch.int32))
    adj = hits > 0
    adj = adj | adj.T
    adj = adj & ~_eye(n, d2.device)
    return adj & (mask[:, None] & mask[None, :])


def ball_query_degree(d2: torch.Tensor, eps_sq: float) -> torch.Tensor:
    """Node degree from the ball query (reference compute_ball_query +
    degree row-sum, graph_features.py:11-22,78).  d2 already encodes the
    valid mask as +inf."""
    gated = (d2 <= eps_sq) & ~_eye(d2.shape[0], d2.device)
    return torch.sum(gated, dim=-1).to(torch.float32)


def build_graph_structure(
    points: torch.Tensor,
    mask: torch.Tensor,
    *,
    k: int,
    eps_sq: float,
    edge_capacity: int,
    und_capacity: int,
    union_ball: bool = False,
) -> GraphStructure:
    """Full graph construction on the inputs' device.

    union_ball=False reproduces ``compute_adjacency_information``
    (graph_features.py:58-84): adjacency = kNN only, degree = ball query.
    union_ball=True reproduces the _v2 variant (:87-114): adjacency =
    kNN | ball.
    """
    d2 = pairwise_sq_dist(points, mask)
    adj = knn_adjacency_matrix(d2, mask, k)
    ball = (d2 <= eps_sq) & ~_eye(d2.shape[0], d2.device)
    degree = torch.sum(ball, dim=-1).to(torch.float32)
    if union_ball:
        adj = adj | ball
    senders, receivers, edge_mask = compact_nonzero(adj, edge_capacity)
    und_s, und_r, und_mask = compact_nonzero(torch.triu(adj, diagonal=1), und_capacity)
    return GraphStructure(
        senders=senders,
        receivers=receivers,
        edge_mask=edge_mask,
        und_senders=und_s,
        und_receivers=und_r,
        und_mask=und_mask,
        degree=degree,
    )


def normalize_time(ts: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Masked min-max time normalisation (graph_features.py:47-55)."""
    big = torch.where(mask, ts, torch.full_like(ts, _INF))
    small = torch.where(mask, ts, torch.full_like(ts, -_INF))
    tmin = torch.min(big)
    tmax = torch.max(small)
    denom = torch.where(tmax > tmin, tmax - tmin, torch.ones_like(tmax))
    return torch.where(mask, (ts - tmin) / denom, torch.zeros_like(ts))


def compute_node_features_device(
    vr, rcs, ts, px, py, degree, mask,
    *,
    min_range: float, max_range: float,
    min_azimuth: float, max_azimuth: float,
    include_region_confidence: bool = True,
):
    """Device mirror of compute_node_features (graph_features.py:117-144)."""
    t_norm = normalize_time(ts, mask)
    deg = degree / 10.0
    feats = [vr, rcs, t_norm, deg]
    if include_region_confidence:
        r = torch.sqrt(px**2 + py**2)
        th = torch.abs(torch.atan2(py, px))
        range_conf = (r - max_range) / (min_range - max_range)
        azi_conf = (th - max_azimuth) / (min_azimuth - max_azimuth)
        feats += [range_conf, azi_conf]
    out = torch.stack(feats, dim=-1)
    return torch.where(mask[:, None], out, torch.zeros_like(out))


_US2SEC = 1e-6  # graph_features.py:7


def compute_edge_features_device(
    px, py, vx, vy, ts, senders, receivers, edge_mask
):
    """Device mirror of compute_edge_features (graph_features.py:147-164).

    Note the reference's quirk: dl is the norm of the already-/10-scaled
    (dx, dy), divided by 10 again — reproduced faithfully.
    """
    s, r = senders.long(), receivers.long()
    dx = (px[s] - px[r]) / 10.0
    dy = (py[s] - py[r]) / 10.0
    dl = torch.sqrt(dx**2 + dy**2) / 10.0
    dvx = vx[s] - vx[r]
    dvy = vy[s] - vy[r]
    dvl = torch.sqrt(dvx**2 + dvy**2)
    dt = (ts[s] - ts[r]) * _US2SEC
    out = torch.stack([dx, dy, dl, dvx, dvy, dvl, dt], dim=-1)
    return torch.where(edge_mask[:, None], out, torch.zeros_like(out))
