"""Cluster proposal statistics: per-cluster mean, covariance, size, label.

Segment reductions over the node2cluster assignment in place of the
reference's python loops (modules/inference/inference.py:10-118): sample
mean, Bessel-corrected covariance with a 0.5·I measurement-noise floor
(gnn_detector.py:138), member count and majority-vote class, for all
clusters at once on the device.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch
import torch.nn.functional as F

from ..ops import segment as S

MEAS_NOISE_VAR = 0.5  # gnn_detector.py:138


class Proposals(NamedTuple):
    mu: torch.Tensor        # [C, 2]
    sigma: torch.Tensor     # [C, 2, 2]
    size: torch.Tensor      # [C] float — member counts
    label: torch.Tensor     # [C] int32 — majority-vote node class
    valid: torch.Tensor     # [C] bool


def compute_proposals(xy, node_cls_idx, node2cluster, node_mask,
                      num_clusters_cap: int, num_classes: int) -> Proposals:
    """xy [N, 2] measurement positions; node_cls_idx [N] predicted classes;
    node2cluster [N] cluster slot (void = C)."""
    c = num_clusters_cap
    counts = S.masked_segment_sum(xy.new_ones(xy.shape[0]), node2cluster, c,
                                  node_mask)
    mu = S.masked_segment_sum(xy, node2cluster, c, node_mask)
    mu = mu / torch.clamp(counts[:, None], min=1.0)

    err = mu[node2cluster.long().clamp(0, c - 1)] - xy  # [N, 2]
    outer = err[:, :, None] * err[:, None, :]           # [N, 2, 2]
    ssq = S.masked_segment_sum(
        outer.reshape(-1, 4), node2cluster, c, node_mask).reshape(c, 2, 2)
    denom = torch.clamp(counts - 1.0, min=1.0)[:, None, None]
    noise = MEAS_NOISE_VAR * torch.eye(2, dtype=xy.dtype, device=xy.device)
    sigma = torch.where((counts > 1)[:, None, None], ssq / denom + noise, noise)

    # Majority vote of member node classes (inference.py:106-118); argmax
    # returns the first maximum, as numpy's bincount-argmax does.
    onehot = F.one_hot(node_cls_idx.long(), num_classes).to(xy.dtype)
    votes = S.masked_segment_sum(onehot, node2cluster, c, node_mask)
    label = votes.argmax(-1).int()

    return Proposals(mu=mu, sigma=sigma, size=counts, label=label,
                     valid=counts > 0)


def rotation_invariant_cluster_features(xy, mask):
    """Rotation/translation-invariant per-point cluster features
    (modules/inference/feature.py:9-28, marked "not used" in the reference
    but kept as a capability): shift points to the cluster mean, rotate into
    the covariance eigenbasis, return [x', y', r, θ].

    xy: [M, 2] one cluster's points; mask: [M].  The sign of each
    eigenvector is whatever ``torch.linalg.eigh`` returns (LAPACK or
    cuSOLVER), as the JAX function takes its backend's: x', y' and θ may
    differ from another backend's by that sign, r does not."""
    m = mask.to(xy.dtype)[:, None]
    cnt = torch.clamp(m.sum(), min=1.0)
    mu = (xy * m).sum(0) / cnt
    err = (xy - mu) * m
    sigma = (err.T @ err) / torch.clamp(cnt - 1.0, min=1.0)
    _, evecs = torch.linalg.eigh(sigma)
    pts = (xy - mu) @ evecs
    r = torch.sqrt((pts ** 2).sum(-1))
    th = torch.atan2(pts[:, 1], pts[:, 0])
    feat = torch.stack([pts[:, 0], pts[:, 1], r, th], dim=-1)
    return torch.where(mask[:, None], feat, torch.zeros_like(feat))


def cov_ellipse(mu, sigma, n_points: int = 32, chi2_scale: float = 9.21):
    """χ²-scaled covariance ellipse boundary points for visualisation
    (modules/inference/ellipse.py:4-37).  Returns [n_points, 2]; an
    eigenvector of the other sign traces the same ellipse from another
    start."""
    evals, evecs = torch.linalg.eigh(sigma)
    t = torch.linspace(0.0, 2.0 * math.pi, n_points, dtype=sigma.dtype,
                       device=sigma.device)
    circle = torch.stack([torch.cos(t), torch.sin(t)], dim=-1)  # [P, 2]
    radii = torch.sqrt(torch.clamp(evals, min=0.0) * chi2_scale)
    return mu[None, :] + (circle * radii[None, :]) @ evecs.T
