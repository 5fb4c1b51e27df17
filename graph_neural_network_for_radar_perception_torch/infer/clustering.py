"""DBSCAN-style clustering of predicted cluster centers, on the device.

The reference runs a numpy BFS on the host inside the model forward
(modules/inference/clustering.py:43-93).  As in the JAX package, the
transitive closure of the thresholded adjacency is computed by boolean
matrix squaring — a fixed ⌈log2 N⌉ trip count, exact for every topology —
and each node's component is rooted at its minimum reachable index.  Ranking
roots by index reproduces the reference BFS's scan-order cluster ids.  A
host BFS twin (``dbscan_host``) is kept for tests.

Reference quirk reproduced: ``compute_adjacency_mat_from_predicted_offsets``
compares the SQUARED distance against eps (clustering.py:31-40), while the
predicted-links variant compares the true L2 norm (clustering.py:8-23).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..ops import segment as S

_BIG = (2**31 - 1) // 2


def adjacency_from_centers(centers, mask, eps: float):
    """[N, 2] predicted centers → boolean adjacency: d² <= eps (sic),
    diagonal cleared (clustering.py:31-40).  A batch: [B, N, 2] → [B, N, N]."""
    diff = centers[..., :, None, :] - centers[..., None, :, :]
    d2 = (diff * diff).sum(-1)
    adj = d2 <= eps
    eye = torch.eye(centers.shape[-2], dtype=torch.bool, device=centers.device)
    return adj & ~eye & (mask[..., :, None] & mask[..., None, :])


def adjacency_from_links(und_senders, und_receivers, und_mask, pred_edges,
                         centers, mask, eps: float):
    """Adjacency from predicted links, dropping edges whose endpoint
    distance >= eps (clustering.py:8-23; true L2 here, not squared).  A
    batch: every argument with a leading graph axis → [B, N, N]."""
    n = centers.shape[-2]
    us, ur = und_senders.long(), und_receivers.long()
    cs, cr = S.gather_nodes(centers, us), S.gather_nodes(centers, ur)
    dist = torch.sqrt(((cs - cr) ** 2).sum(-1))
    keep = (und_mask & (pred_edges == 1) & (dist < eps)).int()
    # Each graph's [N, N] block of one flat count table: an index_add_ of
    # the kept links both ways (no host sync, so a capture can hold it).
    base = 0 if us.ndim == 1 else (
        torch.arange(us.shape[0], device=us.device)[:, None] * (n * n))
    counts = torch.zeros(us.shape[:-1] + (n * n,), dtype=torch.int32,
                         device=centers.device).reshape(-1)
    for a, b in ((us, ur), (ur, us)):
        counts.index_add_(0, (base + a * n + b).reshape(-1), keep.reshape(-1))
    adj = counts.reshape(us.shape[:-1] + (n, n)) > 0
    return adj & (mask[..., :, None] & mask[..., None, :])


def connected_components(adj, mask):
    """Exact connected components via boolean adjacency squaring.

    ``reach ← reach² > 0`` doubles the covered path length every round, so
    ⌈log2 N⌉ rounds give the full closure for any topology.  Each round is
    one [N, N] × [N, N] f32 matrix product (a batched one for a batch),
    exact: entries are 0/1 and row sums ≤ N < 2²⁴.  The trip count is
    fixed and nothing is read on the host.

    Returns:
      node2cluster: [N] int32 — compacted cluster id per valid node (ids
                    ordered like the reference BFS); invalid nodes get N.
      num_clusters: int32 scalar.
    A batch (adj [B, N, N], mask [B, N]) gives [B, N] and [B], each graph's
    bit for bit as its own call's.
    """
    n = adj.shape[-1]
    idx = torch.arange(n, dtype=torch.int64, device=adj.device)
    reach = adj | torch.eye(n, dtype=torch.bool, device=adj.device)
    for _ in range(math.ceil(math.log2(max(n, 2)))):
        r = reach.float()
        reach = (r @ r) > 0
    big = torch.full_like(idx, _BIG)
    labels = torch.where(reach & mask[..., None, :], idx, big)
    labels = torch.where(mask, labels.min(-1).values, big)
    is_root = mask & (labels == idx)
    rank = torch.cumsum(is_root.int(), -1) - 1  # id at each root index
    safe = labels.clamp(0, n - 1)
    node2cluster = torch.where(mask, rank.gather(-1, safe), torch.full_like(rank, n))
    return node2cluster.int(), is_root.sum(-1).int()


def dbscan_on_device(centers, mask, eps: float, *, from_links: bool = False,
                     und_senders=None, und_receivers=None, und_mask=None,
                     pred_edges=None):
    """Simple_DBSCAN.cluster_nodes equivalent on the tensors' device, for
    one graph or a batch with a leading graph axis (the JAX package's
    ``jax.vmap`` of it)."""
    if from_links:
        adj = adjacency_from_links(und_senders, und_receivers, und_mask,
                                   pred_edges, centers, mask, eps)
    else:
        adj = adjacency_from_centers(centers, mask, eps)
    return connected_components(adj, mask)


def dbscan_host(centers_np: np.ndarray, eps: float) -> np.ndarray:
    """Scan-order BFS clustering (clustering.py:43-93 semantics).
    Returns meas_to_cluster_id [N] int."""
    n = centers_np.shape[0]
    diff = centers_np[:, None, :] - centers_np[None, :, :]
    adj = np.sum(diff * diff, axis=-1) <= eps
    np.fill_diagonal(adj, False)

    ids = np.full(n, -1, dtype=np.int64)
    next_id = 0
    for m in range(n):
        if ids[m] != -1:
            continue
        frontier = [m]
        ids[m] = next_id
        while frontier:
            i = frontier.pop()
            nbrs = np.flatnonzero(adj[i] & (ids == -1))
            ids[nbrs] = next_id
            frontier.extend(nbrs.tolist())
        next_id += 1
    return ids
