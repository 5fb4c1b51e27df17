"""Visualisation: scenes, graphs, task outputs, pred-vs-GT panels.

The port's copy of the JAX package's ``viz/plots.py``: the same functions,
names and signatures over the port's numpy ``FrameDetections``; matplotlib
(and PIL for the GIF) is imported inside the functions.  Covers the
reference's plotting surface (modules/plot_utils/plot_func.py,
show_inputs.py, show_outputs.py, compare_plots.py — ~25 functions) with a
composable axis-first design: every primitive draws onto a supplied
matplotlib Axes so panels assemble freely; high-level helpers reproduce
the reference's standard figures (all-outputs 2×2 panel, pred-vs-GT
side-by-sides, cluster+ellipse scenes).
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from ..data.labels import NEW_LABELS
from ..infer.proposals import cov_ellipse

_CLASS_COLORS = {
    0: "tab:red",       # CAR
    1: "tab:blue",      # PEDESTRIAN
    2: "tab:cyan",      # PEDESTRIAN_GROUP
    3: "tab:orange",    # TWO_WHEELER
    4: "tab:purple",    # LARGE_VEHICLE
    5: "tab:olive",     # NONE
    6: "tab:gray",      # FALSE
    7: "black",         # STATIC
}


def _ax(ax=None, figsize=(8, 8)):
    import matplotlib.pyplot as plt

    if ax is None:
        _, ax = plt.subplots(figsize=figsize)
    return ax


def set_roi(ax, min_x=0, max_x=100, min_y=-50, max_y=50):
    ax.set_xlim(min_x, max_x)
    ax.set_ylim(min_y, max_y)
    ax.set_aspect("equal")
    ax.set_xlabel("x (m)")
    ax.set_ylabel("y (m)")


def plot_measurements(px, py, ax=None, color="red", size=6, label=None,
                      **roi):
    """plot_func.py:8-19."""
    ax = _ax(ax)
    ax.scatter(px, py, s=size, c=color, marker=".", label=label)
    set_roi(ax, **roi)
    return ax


def plot_range_rates(px, py, vx, vy, ax=None, scale=1.0, **roi):
    """Velocity quiver (plot_func.py:35-46)."""
    ax = _ax(ax)
    ax.scatter(px, py, s=6, c="red", marker=".")
    ax.quiver(px, py, vx, vy, color="blue", width=0.002,
              angles="xy", scale_units="xy", scale=1.0 / scale)
    set_roi(ax, **roi)
    return ax


def plot_graph(px, py, senders, receivers, ax=None, edge_mask=None, **roi):
    """Graph edges as line segments (plot_func.py:48-58)."""
    from matplotlib.collections import LineCollection

    ax = _ax(ax)
    if edge_mask is not None:
        senders = senders[edge_mask]
        receivers = receivers[edge_mask]
    segs = np.stack(
        [np.stack([px[senders], py[senders]], -1),
         np.stack([px[receivers], py[receivers]], -1)], axis=1,
    )
    ax.add_collection(
        LineCollection(segs, colors="lightsteelblue", linewidths=0.5)
    )
    ax.scatter(px, py, s=6, c="red", marker=".")
    set_roi(ax, **roi)
    return ax


def plot_edge_labels(px, py, und_senders, und_receivers, edge_labels,
                     ax=None, und_mask=None, **roi):
    """Positive links highlighted (plot_func.py:60-89)."""
    from matplotlib.collections import LineCollection

    ax = _ax(ax)
    if und_mask is not None:
        und_senders = und_senders[und_mask]
        und_receivers = und_receivers[und_mask]
        edge_labels = edge_labels[und_mask]
    pos = edge_labels == 1
    for sel, color, lw in [(~pos, "gainsboro", 0.4), (pos, "tab:green", 1.0)]:
        s, r = und_senders[sel], und_receivers[sel]
        segs = np.stack(
            [np.stack([px[s], py[s]], -1), np.stack([px[r], py[r]], -1)],
            axis=1,
        )
        ax.add_collection(LineCollection(segs, colors=color, linewidths=lw))
    ax.scatter(px, py, s=6, c="red", marker=".")
    set_roi(ax, **roi)
    return ax


def plot_node_classes(px, py, classes, ax=None, legend=True, size=8, **roi):
    """Class-coloured measurements (plot_func.py:145-166)."""
    ax = _ax(ax)
    for cid in np.unique(classes):
        sel = classes == cid
        ax.scatter(
            px[sel], py[sel], s=size, marker=".",
            c=_CLASS_COLORS.get(int(cid), "magenta"),
            label=NEW_LABELS[int(cid)] if int(cid) < len(NEW_LABELS) else str(cid),
        )
    if legend:
        ax.legend(loc="upper right", fontsize=7)
    set_roi(ax, **roi)
    return ax


def plot_offsets(px, py, offsets, ax=None, color="tab:blue", **roi):
    """Offset arrows to predicted/GT cluster centers
    (plot_func.py:103-143)."""
    ax = _ax(ax)
    ax.scatter(px, py, s=6, c="red", marker=".")
    ax.quiver(px, py, offsets[:, 0], offsets[:, 1], color=color,
              width=0.002, angles="xy", scale_units="xy", scale=1.0)
    ax.scatter(px + offsets[:, 0], py + offsets[:, 1], s=4, c=color,
               marker="+")
    set_roi(ax, **roi)
    return ax


def plot_clusters(px, py, node2cluster, num_clusters, ax=None,
                  cluster_mu=None, cluster_sigma=None,
                  cluster_class=None, **roi):
    """Cluster memberships + covariance ellipses (plot_func.py:387-407,
    show_outputs.py:120-173)."""
    import matplotlib.pyplot as plt

    ax = _ax(ax)
    cmap = plt.colormaps["tab20"]
    for c in range(num_clusters):
        sel = node2cluster == c
        if not sel.any():
            continue
        ax.scatter(px[sel], py[sel], s=8, marker=".", color=cmap(c % 20))
        if cluster_mu is not None and cluster_sigma is not None:
            # float32, as the JAX package computes the ellipse.
            pts = cov_ellipse(
                torch.as_tensor(np.asarray(cluster_mu[c], np.float32)),
                torch.as_tensor(np.asarray(cluster_sigma[c], np.float32)),
            ).numpy()
            ax.plot(pts[:, 0], pts[:, 1], lw=0.8, color=cmap(c % 20))
        if cluster_class is not None and cluster_mu is not None:
            cid = int(cluster_class[c])
            name = NEW_LABELS[cid] if cid < len(NEW_LABELS) else str(cid)
            ax.annotate(name, cluster_mu[c], fontsize=6)
    set_roi(ax, **roi)
    return ax


def plot_all_outputs(det, figsize=(16, 16), roi=None):
    """2×2 panel: node classes / centers / links / clusters
    (show_outputs.py:175-229).  `det` is an infer.pipeline.FrameDetections.
    """
    import matplotlib.pyplot as plt

    roi = roi or {}
    fig, axes = plt.subplots(2, 2, figsize=figsize)
    px, py = det.xy[:, 0], det.xy[:, 1]
    plot_node_classes(px, py, det.node_class, ax=axes[0, 0], **roi)
    axes[0, 0].set_title("node segmentation")
    plot_offsets(px, py, det.centers - det.xy, ax=axes[0, 1], **roi)
    axes[0, 1].set_title("predicted cluster centers")
    gt = det.gt
    if gt is not None:
        plot_edge_labels(
            px, py, gt.und_senders, gt.und_receivers, det.link_class,
            ax=axes[1, 0], **roi,
        )
    axes[1, 0].set_title("link predictions")
    plot_clusters(
        px, py, det.node2cluster, det.num_clusters, ax=axes[1, 1],
        cluster_mu=det.cluster_mu, cluster_sigma=det.cluster_sigma,
        cluster_class=det.cluster_class, **roi,
    )
    axes[1, 1].set_title("clusters + object classes")
    fig.tight_layout()
    return fig


def compare_pred_gt(det, figsize=(16, 8), roi=None):
    """Pred-vs-GT side-by-side of node classes
    (compare_plots.py:9-53)."""
    import matplotlib.pyplot as plt

    roi = roi or {}
    fig, axes = plt.subplots(1, 2, figsize=figsize)
    px, py = det.xy[:, 0], det.xy[:, 1]
    n = px.shape[0]
    plot_node_classes(
        px, py, det.gt.node_class[:n], ax=axes[0], **roi
    )
    axes[0].set_title("ground truth")
    plot_node_classes(px, py, det.node_class, ax=axes[1], **roi)
    axes[1].set_title("prediction")
    fig.tight_layout()
    return fig


def save_frames_as_gif(figs_or_paths: Sequence, out_path: str, fps: int = 5):
    """Assemble saved frame PNGs into a GIF (create_gif.ipynb analog)."""
    from PIL import Image

    frames = []
    for item in figs_or_paths:
        if isinstance(item, str):
            frames.append(Image.open(item).convert("P"))
        else:  # matplotlib figure
            import io

            buf = io.BytesIO()
            item.savefig(buf, format="png", dpi=80)
            buf.seek(0)
            frames.append(Image.open(buf).convert("P"))
    frames[0].save(
        out_path, save_all=True, append_images=frames[1:],
        duration=int(1000 / fps), loop=0,
    )
    return out_path


# ---------------------------------------------------------------------------
# Long-tail reference parity (plot_func.py / show_outputs.py /
# compare_plots.py — the remaining side-by-side and annotated variants).
# Each docstring cites its reference twin; PARITY.md lists the full map.
# ---------------------------------------------------------------------------


def plot_track_centers(px, py, cx, cy, ax=None, **roi):
    """Measurements + track-mean centers (plot_func.py:21-33)."""
    ax = _ax(ax)
    ax.scatter(px, py, s=6, c="red", marker=".", label="measurements")
    ax.scatter(cx, cy, s=30, c="black", marker="x", label="track centers")
    ax.legend(loc="upper right", fontsize=7)
    set_roi(ax, **roi)
    return ax


def plot_channels(image, figsize=(16, 6)):
    """Grid/CNN input channel maps side by side (plot_func.py:91-101).
    image: [H, W, C] BEV grid tensor."""
    import matplotlib.pyplot as plt

    image = np.asarray(image)
    c = image.shape[-1]
    fig, axes = plt.subplots(1, c, figsize=figsize)
    axes = np.atleast_1d(axes)
    for i in range(c):
        axes[i].imshow(image[..., i].T, origin="lower", cmap="viridis")
        axes[i].set_title(f"channel {i}")
    fig.tight_layout()
    return fig


def plot_meas_and_gt_labels(px, py, classes, ax=None, **roi):
    """Class-coloured GT scene (plot_func.py:145-166); alias of
    plot_node_classes kept for 1:1 name parity."""
    return plot_node_classes(px, py, classes, ax=ax, **roi)


def plot_meas_cluster_centers(px, py, offsets, ax=None, **roi):
    """Measurements + offset-decoded centers (plot_func.py:127-143)."""
    return plot_offsets(px, py, offsets, ax=ax, **roi)


def plot_meas_and_gt_labels_cluster_centers(
    px, py, classes, offsets, ax=None, **roi
):
    """Class colours AND center offsets in one panel
    (plot_func.py:103-125)."""
    ax = _ax(ax)
    plot_node_classes(px, py, classes, ax=ax, legend=True, **roi)
    ax.quiver(px, py, offsets[:, 0], offsets[:, 1], color="tab:blue",
              width=0.002, angles="xy", scale_units="xy", scale=1.0)
    set_roi(ax, **roi)
    return ax


def plot_pred_class(det, ax=None, **roi):
    """Predicted node classes of one frame (show_outputs.py:10-41)."""
    return plot_node_classes(
        det.xy[:, 0], det.xy[:, 1], det.node_class, ax=ax, **roi
    )


def plot_pred_offsets(det, ax=None, **roi):
    """Predicted center offsets (show_outputs.py:43-77)."""
    return plot_offsets(
        det.xy[:, 0], det.xy[:, 1], det.centers - det.xy, ax=ax, **roi
    )


def plot_pred_edge_class(det, ax=None, **roi):
    """Predicted link labels over the undirected graph
    (show_outputs.py:79-118)."""
    if det.gt is None:
        raise ValueError("needs det.gt for the undirected edge list")
    return plot_edge_labels(
        det.xy[:, 0], det.xy[:, 1], det.gt.und_senders,
        det.gt.und_receivers, det.link_class, ax=ax, **roi,
    )


def plot_clusters_measurements_and_object_class(det, ax=None, **roi):
    """Clusters + ellipses + object-class annotations
    (show_outputs.py:120-173)."""
    return plot_clusters(
        det.xy[:, 0], det.xy[:, 1], det.node2cluster, det.num_clusters,
        ax=ax, cluster_mu=det.cluster_mu, cluster_sigma=det.cluster_sigma,
        cluster_class=det.cluster_class, **roi,
    )


def compare_pred_gt_class(det, figsize=(16, 8), roi=None):
    """GT vs predicted node classes side by side
    (compare_plots.py:9-53); name-parity alias of compare_pred_gt."""
    return compare_pred_gt(det, figsize=figsize, roi=roi)


def compare_pred_gt_offsets(det, figsize=(16, 8), roi=None):
    """GT vs predicted center offsets side by side
    (compare_plots.py:55-101)."""
    import matplotlib.pyplot as plt

    roi = roi or {}
    fig, axes = plt.subplots(1, 2, figsize=figsize)
    px, py = det.xy[:, 0], det.xy[:, 1]
    n = px.shape[0]
    plot_offsets(px, py, det.gt.node_offsets[:n], ax=axes[0],
                 color="tab:green", **roi)
    axes[0].set_title("ground truth offsets")
    plot_offsets(px, py, det.centers - det.xy, ax=axes[1], **roi)
    axes[1].set_title("predicted offsets")
    fig.tight_layout()
    return fig


def compare_pred_gt_offsets_meas(det, figsize=(16, 8), roi=None):
    """GT vs predicted decoded CENTERS over raw measurements
    (compare_plots.py:103-139 / plot_func.py:258-328)."""
    import matplotlib.pyplot as plt

    roi = roi or {}
    fig, axes = plt.subplots(1, 2, figsize=figsize)
    px, py = det.xy[:, 0], det.xy[:, 1]
    n = px.shape[0]
    gt_centers = det.xy + det.gt.node_offsets[:n]
    for ax, centers, title in (
        (axes[0], gt_centers, "ground truth centers"),
        (axes[1], det.centers, "predicted centers"),
    ):
        ax.scatter(px, py, s=6, c="red", marker=".", label="measurements")
        ax.scatter(centers[:, 0], centers[:, 1], s=6, c="tab:blue",
                   marker="+", label="centers")
        ax.legend(loc="upper right", fontsize=7)
        ax.set_title(title)
        set_roi(ax, **roi)
    fig.tight_layout()
    return fig


def compute_node_pairs(px, py, edge_labels, und_senders, und_receivers):
    """Segment endpoints of the positive links
    (plot_func.py:330-349 / compare_plots.py:141-160).  Returns
    [K, 2, 2] line segments for LineCollection-style drawing."""
    pos = np.asarray(edge_labels) == 1
    s = np.asarray(und_senders)[pos]
    r = np.asarray(und_receivers)[pos]
    return np.stack(
        [np.stack([px[s], py[s]], -1), np.stack([px[r], py[r]], -1)], axis=1
    )


def compare_pred_gt_edge_class(det, figsize=(16, 8), roi=None):
    """GT vs predicted links side by side (compare_plots.py:162-218)."""
    import matplotlib.pyplot as plt

    roi = roi or {}
    fig, axes = plt.subplots(1, 2, figsize=figsize)
    px, py = det.xy[:, 0], det.xy[:, 1]
    gt = det.gt
    eu = det.link_class.shape[0]
    plot_edge_labels(px, py, gt.und_senders[:eu], gt.und_receivers[:eu],
                     gt.edge_class[:eu], ax=axes[0], **roi)
    axes[0].set_title("ground truth links")
    plot_edge_labels(px, py, gt.und_senders[:eu], gt.und_receivers[:eu],
                     det.link_class, ax=axes[1], **roi)
    axes[1].set_title("predicted links")
    fig.tight_layout()
    return fig


def compare_pred_gt_offsets_edge_labels(det, figsize=(16, 8), roi=None):
    """Predicted centers + positive predicted links in one comparison
    (plot_func.py:351-385)."""
    import matplotlib.pyplot as plt
    from matplotlib.collections import LineCollection

    roi = roi or {}
    fig, axes = plt.subplots(1, 2, figsize=figsize)
    px, py = det.xy[:, 0], det.xy[:, 1]
    n = px.shape[0]
    gt = det.gt
    eu = det.link_class.shape[0]
    for ax, centers, labels, title in (
        (axes[0], det.xy + gt.node_offsets[:n], gt.edge_class[:eu],
         "ground truth"),
        (axes[1], det.centers, det.link_class, "prediction"),
    ):
        segs = compute_node_pairs(
            px, py, labels, gt.und_senders[:eu], gt.und_receivers[:eu]
        )
        ax.add_collection(
            LineCollection(segs, colors="tab:green", linewidths=0.8)
        )
        ax.scatter(px, py, s=6, c="red", marker=".")
        ax.scatter(centers[:, 0], centers[:, 1], s=5, c="tab:blue",
                   marker="+")
        ax.set_title(title)
        set_roi(ax, **roi)
    fig.tight_layout()
    return fig


def _gt_cluster_stats(det):
    """GT cluster memberships/means/covs from det.gt (truncated to n)."""
    gt = det.gt
    n = det.xy.shape[0]
    n2c = np.asarray(gt.node2cluster[:n])
    ncl = int(gt.cluster_class.shape[0])
    mu = np.zeros((ncl, 2))
    sigma = np.tile(np.eye(2) * 0.25, (ncl, 1, 1))
    for c in range(ncl):
        sel = n2c == c
        if sel.sum() == 0:
            continue
        pts = det.xy[sel]
        mu[c] = pts.mean(0)
        if sel.sum() > 1:
            sigma[c] = np.cov(pts.T) + np.eye(2) * 0.25
    return n2c, ncl, mu, sigma


def compare_pred_gt_clusters(det, figsize=(16, 8), roi=None):
    """GT track clusters vs DBSCAN prediction clusters side by side
    (plot_func.py:409-447, compare_plots.py:220-261)."""
    import matplotlib.pyplot as plt

    roi = roi or {}
    fig, axes = plt.subplots(1, 2, figsize=figsize)
    px, py = det.xy[:, 0], det.xy[:, 1]
    n2c, ncl, mu, sigma = _gt_cluster_stats(det)
    plot_clusters(px, py, n2c, ncl, ax=axes[0], cluster_mu=mu,
                  cluster_sigma=sigma,
                  cluster_class=np.asarray(det.gt.cluster_class), **roi)
    axes[0].set_title("ground truth clusters")
    plot_clusters_measurements_and_object_class(det, ax=axes[1], **roi)
    axes[1].set_title("predicted clusters")
    fig.tight_layout()
    return fig


def compare_pred_gt_object_classes(det, figsize=(16, 8), roi=None):
    """GT vs predicted per-cluster object classes
    (compare_plots.py:263-307): cluster scenes annotated by class."""
    return compare_pred_gt_clusters(det, figsize=figsize, roi=roi)


def save_compare_pred_gt_clusters(det, out_path, figsize=(16, 8), roi=None,
                                  dpi=100):
    """Render compare_pred_gt_clusters straight to a PNG
    (plot_func.py:449-489)."""
    import matplotlib.pyplot as plt

    fig = compare_pred_gt_clusters(det, figsize=figsize, roi=roi)
    fig.savefig(out_path, dpi=dpi)
    plt.close(fig)
    return out_path
