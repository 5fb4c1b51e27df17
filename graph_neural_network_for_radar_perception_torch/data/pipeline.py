"""Per-frame preprocessing and static-shape padding (numpy, host side).

The same preprocessing recipe as the JAX package's ``data/pipeline.py``
(the reference's ``RadarScenesDataset.__getitem__``,
modules/data_generator/datagen_gnn.py:48-190), emitting fixed-capacity
padded ``RadarGraph``/``GraphLabels`` structs of numpy arrays;
``RadarGraph.from_numpy`` moves them to a device.  The graph is built by the
numpy builder (``features.adjacency_info``), whose arrays are identical to
those of the JAX package's native C++ builder.
"""

from __future__ import annotations

import dataclasses
from typing import Iterator, Optional

import numpy as np

from ..config.config import GNNConfig
from ..core.graph import GraphBatch, GraphLabels, RadarGraph
from . import features as F
from . import groundtruth as G
from .labels import ID_STATIC


@dataclasses.dataclass
class FrameArrays:
    """Unpadded (ragged) numpy arrays for one preprocessed dynamic frame."""

    node_feat: np.ndarray      # [n, F_n]
    edge_feat: np.ndarray      # [e, F_e]
    senders: np.ndarray        # [e]
    receivers: np.ndarray      # [e]
    und_senders: np.ndarray    # [eu]
    und_receivers: np.ndarray  # [eu]
    other_feat: np.ndarray     # [n, 4]
    node_class: np.ndarray     # [n]
    node_offsets: np.ndarray   # [n, 2]
    edge_class: np.ndarray     # [eu]
    node2cluster: np.ndarray   # [n]
    cluster_class: np.ndarray  # [c]

    @property
    def n(self):
        return self.node_feat.shape[0]


def preprocess_frame(
    data_dict: dict,
    cfg: GNNConfig,
    *,
    flip_along_x: bool = False,
) -> Optional[FrameArrays]:
    """data_dict (reference read_data.py:526-532 schema, already
    ego-compensated) → ragged FrameArrays, or None if <2 dynamic points
    (datagen_gnn.py:104).  Mirrors datagen_gnn.py:82-141 step by step."""
    data = dict(data_dict)
    if flip_along_x:  # read_data.py:522-524
        data = dict(data)
        data["meas_py"] = -data["meas_py"]
        data["meas_vy"] = -data["meas_vy"]

    gt = G.compute_ground_truth_node(data)
    data, gt = F.select_within_roi(
        data, gt, cfg.min_x, cfg.max_x, cfg.min_y, cfg.max_y
    )
    data, gt = F.select_moving(data, gt, ID_STATIC)
    if data["meas_px"].shape[0] <= 1:
        return None

    adj = F.adjacency_info(
        data["meas_px"], data["meas_py"],
        cfg.ball_query_eps_square, cfg.k_number_nearest_points,
        union_ball=cfg.union_ball,
    )
    senders = adj["adj_list"][0].astype(np.int32)
    receivers = adj["adj_list"][1].astype(np.int32)
    rows, cols = np.nonzero(np.triu(adj["adj_matrix"], k=1))
    und_s, und_r = rows.astype(np.int32), cols.astype(np.int32)
    degree = adj["degree"]
    edge_feat = F.edge_features_np(data, adj["adj_list"])

    node_feat = F.node_features_np(
        data, degree,
        include_region_confidence=cfg.include_region_confidence,
        min_range=cfg.grid_min_r, max_range=cfg.grid_max_r,
        min_azimuth=cfg.grid_min_th, max_azimuth=cfg.grid_max_th,
    ).astype(np.float32)
    other_feat = np.stack(
        [data["meas_px"], data["meas_py"], data["meas_vx"], data["meas_vy"]],
        axis=-1,
    ).astype(np.float32)

    edge_class = G.gt_edge_labels_from_und(
        data["meas_trackid"], und_s, und_r
    )
    node_class = gt["class_labels"].astype(np.int32)
    node_offsets = np.stack([gt["offsetx"], gt["offsety"]], axis=-1).astype(
        np.float32
    )
    node2cluster, cluster_class = G.gt_clusters(
        data["meas_trackid"], node_class
    )

    return FrameArrays(
        node_feat=node_feat,
        edge_feat=edge_feat,
        senders=senders,
        receivers=receivers,
        und_senders=und_s,
        und_receivers=und_r,
        other_feat=other_feat,
        node_class=node_class,
        node_offsets=node_offsets,
        edge_class=edge_class.astype(np.int32),
        node2cluster=node2cluster,
        cluster_class=cluster_class,
    )


def _pad1(x, size, fill=0):
    out = np.full((size,) + x.shape[1:], fill, dtype=x.dtype)
    out[: x.shape[0]] = x[:size]
    return out


def pad_frame(fr: FrameArrays, cfg: GNNConfig):
    """Ragged FrameArrays → padded (RadarGraph, GraphLabels) numpy structs.

    Frames larger than the capacities are truncated node-first (rare with
    max_nodes=768: RadarScenes dynamic frames are ~10²-10³ points,
    SURVEY.md §2 model-size note).
    """
    if cfg.spatial_sort:
        from .ordering import spatial_sort_frame

        fr = spatial_sort_frame(fr)
    n_cap, e_cap = cfg.max_nodes, cfg.max_edges
    eu_cap, c_cap = cfg.max_und_edges, cfg.max_clusters
    n = min(fr.n, n_cap)

    # Drop edges touching truncated nodes.
    ekeep = (fr.senders < n) & (fr.receivers < n)
    s, r = fr.senders[ekeep][:e_cap], fr.receivers[ekeep][:e_cap]
    ef = fr.edge_feat[ekeep][:e_cap]
    ukeep = (fr.und_senders < n) & (fr.und_receivers < n)
    us = fr.und_senders[ukeep][:eu_cap]
    ur = fr.und_receivers[ukeep][:eu_cap]
    ec = fr.edge_class[ukeep][:eu_cap]

    node_mask = np.zeros(n_cap, dtype=bool)
    node_mask[:n] = True
    edge_mask = np.zeros(e_cap, dtype=bool)
    edge_mask[: s.shape[0]] = True
    und_mask = np.zeros(eu_cap, dtype=bool)
    und_mask[: us.shape[0]] = True

    n2c = fr.node2cluster[:n].copy()
    n_clusters = min(fr.cluster_class.shape[0], c_cap)
    # Nodes whose cluster was truncated (or padded nodes) go to the void
    # slot c_cap; the loss masks them out.
    n2c[n2c >= c_cap] = c_cap
    n2c_pad = np.full(n_cap, c_cap, dtype=np.int32)
    n2c_pad[:n] = n2c
    cluster_mask = np.zeros(c_cap, dtype=bool)
    cluster_mask[:n_clusters] = True

    graph = RadarGraph(
        node_feat=_pad1(fr.node_feat, n_cap).astype(np.float32),
        edge_feat=_pad1(ef, e_cap).astype(np.float32),
        senders=_pad1(s, e_cap),
        receivers=_pad1(r, e_cap),
        node_mask=node_mask,
        edge_mask=edge_mask,
        und_senders=_pad1(us, eu_cap),
        und_receivers=_pad1(ur, eu_cap),
        und_mask=und_mask,
        other_feat=_pad1(fr.other_feat, n_cap).astype(np.float32),
    )
    labels = GraphLabels(
        node_class=_pad1(fr.node_class[:n], n_cap),
        node_offsets=_pad1(fr.node_offsets[:n], n_cap).astype(np.float32),
        edge_class=_pad1(ec, eu_cap),
        node2cluster=n2c_pad,
        cluster_class=_pad1(fr.cluster_class[:c_cap], c_cap),
        cluster_mask=cluster_mask,
    )
    if cfg.mp_impl == "csr":
        # The CSR kernel's contract check comes with that kernel's port.
        raise NotImplementedError(
            "mp_impl='csr' is not ported yet; use the default message pass"
        )
    return graph, labels


def stack_batch(items) -> GraphBatch:
    """Stack per-frame (graph, labels) pairs along a new leading axis."""
    graphs, labels = zip(*items)

    def stack_struct(structs):
        cls = type(structs[0])
        fields = [f.name for f in dataclasses.fields(cls)]
        return cls(**{
            name: np.stack([getattr(s, name) for s in structs], axis=0)
            for name in fields
        })

    return GraphBatch(graph=stack_struct(graphs), labels=stack_struct(labels))


class SyntheticRadarDataset:
    """Infinite synthetic-frame dataset producing padded batches.

    Plays the role of RadarScenesDataset + DataLoader + infinite_loader
    (set_param_for_training_gnn.py:90-99) when real RadarScenes data is not
    on disk.
    """

    def __init__(self, cfg: GNNConfig, seed: int = 0, num_objects=6):
        from .synthetic import make_synthetic_frame

        self._make = make_synthetic_frame
        self.cfg = cfg
        self.rng = np.random.default_rng(seed)
        # int → fixed object count; (lo, hi) → uniform per frame (matches
        # the wide frame-size spread of real RadarScenes and gives the
        # packer small frames to fill slot remainders with).
        self.num_objects = num_objects

    def sample_frame(self) -> FrameArrays:
        while True:
            n_obj = self.num_objects
            if isinstance(n_obj, tuple):
                n_obj = int(self.rng.integers(n_obj[0], n_obj[1] + 1))
            data = self._make(
                self.rng,
                num_objects=n_obj,
                window_size=self.cfg.temporal_window_size,
            )
            flip = (
                self.cfg.dataset_augmentation and self.rng.random() >= 0.5
            )
            fr = preprocess_frame(data, self.cfg, flip_along_x=flip)
            if fr is not None:
                return fr

    def batches(self, batch_size: int) -> Iterator[GraphBatch]:
        while True:
            items = [
                pad_frame(self.sample_frame(), self.cfg)
                for _ in range(batch_size)
            ]
            yield stack_batch(items)
