"""BEV grid data plane for the CNN branch.

The JAX package's ``data/grid.py`` (the reference's
modules/compute_features/grid_features.py: grid_properties + encodings)
with static shapes, in torch on a device:

* gridification: measurements are scored (dynamic ≫ static, then by
  inverse range; grid_features "compute_meas_priority"), sorted ascending,
  and the highest-priority measurement of each cell wins it.  The JAX
  package writes them in that order with ``.at[].set`` (the last write
  wins on its CPU backend, where the scatter runs in order); the port picks
  each cell's last row with a deterministic max-reduction, the same result
  on every device;
* encodings: per-cell nearest-measurement Mahalanobis likelihood map and
  normalised range/azimuth maps (grid_features.py:compute_encodings) over
  fixed-capacity padded measurement arrays.

``build_grid_sample`` runs on the card unless ``device="cpu"`` is passed and
returns numpy arrays, as the JAX one does.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from ..core.graph import resolve_device
from .labels import ID_STATIC, INVALID_NUM


@dataclasses.dataclass(frozen=True)
class GridSpec:
    min_x: float = 0.0
    max_x: float = 100.0
    min_y: float = -50.0
    max_y: float = 50.0
    dx: float = 0.5
    dy: float = 0.5
    min_sigma_x: float = 0.5
    max_sigma_x: float = 2.0
    min_sigma_y: float = 0.5
    max_sigma_y: float = 2.0

    @property
    def num_x(self) -> int:
        return int(round((self.max_x - self.min_x) / self.dx))

    @property
    def num_y(self) -> int:
        return int(round((self.max_y - self.min_y) / self.dy))

    @property
    def max_range(self) -> float:
        return float(np.hypot(self.max_x, self.max_y))

    def cell_index(self, px, py):
        """Cell of each point (tensors), truncated toward zero and clipped
        into the grid, as the JAX ``astype(int32)`` + ``clip``."""
        ix = ((px - self.min_x) / self.dx).to(torch.int32).clamp(0, self.num_x - 1)
        iy = ((py - self.min_y) / self.dy).to(torch.int32).clamp(0, self.num_y - 1)
        return ix, iy

    def cell_centers(self) -> np.ndarray:
        """[num_x, num_y, 2] cell-center coordinates."""
        xs = self.min_x + (np.arange(self.num_x) + 0.5) * self.dx
        ys = self.min_y + (np.arange(self.num_y) + 0.5) * self.dy
        gx, gy = np.meshgrid(xs, ys, indexing="ij")
        return np.stack([gx, gy], axis=-1).astype(np.float32)


def measurement_priority(px, py, stationary_flag, max_range: float):
    """grid_features compute_meas_priority: dynamic returns dominate, then
    nearer-range wins."""
    rng = torch.sqrt(px ** 2 + py ** 2)
    digits = math.floor(math.log10(max_range) + 1.0)
    moving = torch.where(stationary_flag, 0.0, 1.0).to(px.dtype)
    return moving * 10.0 ** digits + max_range - rng


def gridify(spec: GridSpec, px, py, values, labels, mask):
    """Scatter per-measurement rows into the grid; in each cell the row of
    highest priority wins.

    values: [N, D] extra per-measurement channels (e.g. vr, rcs, offsets).
    labels: [N] class labels (STATIC id marks stationary for priority).
    Returns (value_grid [X, Y, D], label_grid [X, Y] with INVALID_NUM in
    empty cells)."""
    stationary = labels == ID_STATIC
    score = measurement_priority(px, py, stationary, spec.max_range)
    score = torch.where(mask, score, torch.full_like(score, -math.inf))
    order = torch.argsort(score, stable=True)  # ascending: the winner last

    ix, iy = spec.cell_index(px[order], py[order])
    ix = torch.where(mask[order], ix, torch.full_like(ix, spec.num_x))  # dump row
    cell = ix.long() * spec.num_y + iy.long()
    n_cells = (spec.num_x + 1) * spec.num_y
    pos = torch.arange(order.shape[0], device=px.device)
    last = torch.full((n_cells,), -1, dtype=torch.long, device=px.device)
    last = last.scatter_reduce(0, cell, pos, reduce="amax", include_self=True)
    hit = last >= 0
    src = order[last.clamp(min=0)]
    vgrid = torch.where(hit[:, None], values[src], torch.zeros((), dtype=values.dtype,
                                                               device=values.device))
    lgrid = torch.where(hit, labels[src].float(),
                        torch.full((), INVALID_NUM, device=px.device))
    vgrid = vgrid.reshape(spec.num_x + 1, spec.num_y, -1)[: spec.num_x]
    return vgrid, lgrid.reshape(spec.num_x + 1, spec.num_y)[: spec.num_x]


def linear_sigma(v, vmin, vmax, smin, smax):
    """grid_features compute_sigma_linear."""
    t = (torch.abs(v) - vmin) / (vmax - vmin)
    return smin + torch.clamp(t, 0.0, 1.0) * (smax - smin)


def measurement_covariances(spec: GridSpec, px, py):
    """Range-dependent, azimuth-aligned 2x2 covariances
    (grid_features compute_covariance_linearly_varying)."""
    theta = torch.atan2(py, px)
    c, s = torch.cos(theta), torch.sin(theta)
    rot = torch.stack([torch.stack([c, -s], -1), torch.stack([s, c], -1)], dim=-2)
    sx = linear_sigma(px, spec.min_x, spec.max_x, spec.min_sigma_x, spec.max_sigma_x)
    sy = linear_sigma(py, spec.min_y, spec.max_y, spec.min_sigma_y, spec.max_sigma_y)
    diag = torch.diag_embed(torch.stack([sx, sy], dim=-1))
    return rot @ diag @ rot.transpose(-1, -2)


def range_azimuth_encoding(spec: GridSpec):
    """Normalised range/azimuth maps over cell centers
    (grid_features compute_range_azimuth_encoding).  Returns numpy
    [X, Y] pair (static per grid spec)."""
    centers = spec.cell_centers()
    r = np.sqrt(centers[..., 0] ** 2 + centers[..., 1] ** 2)
    th = np.abs(np.arctan2(centers[..., 1], centers[..., 0]))
    r_map = (r - r.max()) / (r.min() - r.max())
    th_map = (th - th.max()) / (th.min() - th.max())
    return r_map.astype(np.float32), th_map.astype(np.float32)


def likelihood_map(spec: GridSpec, meas_xy, meas_cov, mask, cell_centers):
    """Nearest-measurement Gaussian likelihood per cell
    (grid_features compute_meas_likelihood), fixed-capacity masked.

    meas_xy: [M, 2]; meas_cov: [M, 2, 2]; cell_centers [X, Y, 2]."""
    del spec
    x, y, _ = cell_centers.shape
    grid = cell_centers.reshape(-1, 2)            # [C, 2]
    d = grid[:, None, :] - meas_xy[None, :, :]    # [C, M, 2]
    d2 = (d * d).sum(-1)
    d2 = torch.where(mask[None, :], d2, torch.full_like(d2, math.inf))
    nearest = d2.argmin(-1)                       # [C], the first on ties

    cov_inv = torch.linalg.inv(meas_cov[nearest])
    dn = grid - meas_xy[nearest]
    m = torch.einsum("ci,cij,cj->c", dn, cov_inv, dn)
    prob = torch.exp(-0.5 * m)
    prob = torch.where(mask.any(), prob, torch.zeros_like(prob))
    return prob.reshape(x, y)


def build_grid_image(spec: GridSpec, px, py, labels, mask, cell_centers):
    """[X, Y, 3] input image: likelihood, range map, azimuth map
    (input_image_dimension=3, configuration_radarscenes_cnn.yml)."""
    del labels
    meas_xy = torch.stack([px, py], dim=-1)
    cov = measurement_covariances(spec, px, py)
    lik = likelihood_map(spec, meas_xy, cov, mask, cell_centers)
    r_map, th_map = (torch.from_numpy(a).to(px.device) for a in range_azimuth_encoding(spec))
    return torch.stack([lik, r_map, th_map], dim=-1)


def build_grid_sample(spec: GridSpec, data: dict, gt: dict, max_meas: int,
                      device="cuda"):
    """One CNN-branch training sample from a preprocessed frame
    (datagen_cnn.py:15-92 equivalent): gridified (vr, rcs, offx, offy) and
    label grids plus the 3-channel input image, computed on ``device`` (the
    card unless ``device="cpu"``).

    data/gt follow the reference data_dict / gt dict schema AFTER ROI
    filtering.  Measurements are padded to max_meas.  Returns a dict of
    numpy arrays: image [X,Y,3], vr [X,Y], rcs [X,Y], label_grid [X,Y],
    offset_grid [X,Y,2]."""
    device = resolve_device(device)
    n = data["meas_px"].shape[0]
    m = min(n, max_meas)

    def pad(x, fill=0.0):
        out = np.full((max_meas,), fill, dtype=np.float32)
        out[:m] = np.asarray(x, np.float32)[:m]
        return torch.from_numpy(out).to(device)

    px, py = pad(data["meas_px"]), pad(data["meas_py"])
    mask = torch.arange(max_meas, device=device) < m
    labels = pad(gt["class_labels"], fill=INVALID_NUM)
    values = torch.stack([pad(data["meas_vr"]), pad(data["meas_rcs"]),
                          pad(gt["offsetx"]), pad(gt["offsety"])], dim=-1)
    vgrid, lgrid = gridify(spec, px, py, values, labels, mask)
    centers = torch.from_numpy(spec.cell_centers()).to(device)
    image = build_grid_image(spec, px, py, labels, mask, centers)
    return {
        "image": image.cpu().numpy(),
        "vr": vgrid[..., 0].cpu().numpy(),
        "rcs": vgrid[..., 1].cpu().numpy(),
        "offset_grid": vgrid[..., 2:4].cpu().numpy(),
        "label_grid": lgrid.cpu().numpy(),
    }
