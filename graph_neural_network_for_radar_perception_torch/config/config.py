"""Configuration schema.

Typed dataclass equivalent of the reference's YAML → attribute-bag config
(modules/set_configurations/set_config_gnn.py:9-114 +
configuration_radarscenes_gnn.yml).  Defaults reproduce the shipped training
configuration; `from_yaml` accepts the reference's YAML layout unchanged.

Adds the TPU-specific static-shape capacities (node/edge/cluster padding,
buckets) and mesh axes that have no reference counterpart.

The port's own copy of the JAX package's ``config/config.py`` (numpy only), kept
so that the port imports nothing of that package.
"""

from __future__ import annotations

import dataclasses
import math
from typing import List, Optional, Sequence, Tuple

MP_IMPLS = (None, "onehot", "csr")  # message-pass implementations


@dataclasses.dataclass
class GNNConfig:
    # --- randomness / paths ------------------------------------------------
    seed: int = 1234
    dataset_dir: str = "dataset/RadarScenesData/data"
    model_weights_dir: str = "model_weights/gnn"
    weights_name: str = "graph_based_detector"

    # --- data selection (yml DATA_SELECTION_PARAM) -------------------------
    reject_static_meas_by_ransac: bool = False
    temporal_window_size: int = 10
    ball_query_eps_square: float = 25.0
    k_number_nearest_points: int = 10
    dataset_augmentation: bool = True
    include_region_confidence: bool = True
    # Use the union of kNN and ball-query edges (reference
    # compute_adjacency_information_v2, graph_features.py:87-114) —
    # the dense-graph stress configuration.
    union_ball: bool = False

    # --- object taxonomy (yml OBJECT_CATEGORIES) ---------------------------
    object_classes: Sequence[str] = (
        "CAR", "PEDESTRIAN", "PEDESTRIAN_GROUP", "TWO_WHEELER",
        "LARGE_VEHICLE", "NONE", "FALSE", "STATIC",
    )
    class_weights: Sequence[float] = (1.0, 1.0, 1.0, 1.0, 1.0, 1.0, 0.5, 0.5)
    object_classes_dyn: Sequence[str] = (
        "CAR", "PEDESTRIAN", "PEDESTRIAN_GROUP", "TWO_WHEELER",
        "LARGE_VEHICLE", "NONE", "FALSE",
    )
    class_weights_dyn: Sequence[float] = (1.0, 1.0, 1.0, 1.0, 1.0, 1.0, 0.5)

    # --- ROI (yml GRID_LIMITS) ---------------------------------------------
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

    # --- architecture (yml GNN_ARCHITECTURE) -------------------------------
    activation: str = "leakyrelu"
    norm_layer: str = "channel_normalization"
    num_groups: Optional[int] = None
    reg_mu: Tuple[float, float] = (0.0, 0.0)
    reg_sigma: Tuple[float, float] = (8.0, 4.0)
    aggregation: str = "add"
    node_feat_enc_stem_channels: Sequence[int] = (256, 128, 64)
    edge_feat_enc_stem_channels: Sequence[int] = (256, 128, 128, 64)
    graph_convolution_stem_channels: Sequence[int] = (64,) * 7
    msg_mlp_hidden_dim: int = 128
    num_blocks_to_compute_edge: int = 1
    hidden_node_channels_gat: int = 512
    num_heads_gat: int = 8
    link_pred_stem_channels: Sequence[int] = (64, 64, 64)
    node_pred_stem_channels: Sequence[int] = (64, 64, 64)
    num_edge_classes: int = 2
    input_node_feat_dim: int = 6
    input_edge_feat_dim: int = 7
    reg_offset_dim: int = 2

    # --- loss weights (yml LOSS_WEIGHTS) -----------------------------------
    obj_cls_loss_weight: float = 1.0
    node_cls_loss_weight: float = 1.0
    edge_cls_loss_weight: float = 2.0
    node_reg_loss_weight: float = 5.0

    # --- optimisation (yml OPTIMIZATION) -----------------------------------
    optim: str = "sgd"
    max_train_iter: int = 200_000
    learning_rate: float = 0.005
    weight_decay: float = 1e-4
    momentum: float = 0.9  # set_param_for_training_gnn.py:46-48
    batch_size: int = 8
    # MultiStepLR γ=0.1 at 50% / 80% (set_param_for_training_gnn.py:50-56)
    lr_milestone_fracs: Tuple[float, float] = (0.5, 0.8)
    lr_gamma: float = 0.1
    # Gradient accumulation (reference train_model_accumulate_grad,
    # gnn/training.py:189-333): each train-step call is a micro-batch;
    # grads are averaged and applied every k calls.
    grad_accumulation_steps: int = 1

    # --- finetuning (yml FINETUNING) ---------------------------------------
    max_train_iter_finetuning: int = 10_000
    learning_rate_finetuning: float = 0.0005
    weight_decay_finetuning: float = 1e-4
    clustering_eps: float = 1.5

    # --- dataset sampling (yml DATASET) ------------------------------------
    num_training_samples: int = 300_000
    num_validation_samples: int = 1_000
    shuffle_training_samples: bool = True
    shuffle_validation_samples: bool = True

    # --- TPU static-shape capacities (no reference counterpart) ------------
    max_nodes: int = 768         # per-graph node capacity
    max_clusters: int = 256      # per-graph cluster capacity
    # Directed-edge capacity: E_cap = int(factor * k * N).  The worst case
    # for symmetrised kNN is factor 2 (no edge reciprocated); measured
    # radar/synthetic frames sit at E ≈ 1.2-1.35*k*N, so packed-batch
    # configs may use a fractional factor (e.g. 4/3) to keep edge tiles
    # mostly valid — pad_frame truncates and pack_frames' fit check
    # respects whatever capacity results.
    edge_capacity_factor: float = 2.0

    # --- kernel selection ---------------------------------------------------
    # Message-passing implementation of the shipped configuration's rounds:
    # None or "onehot" = ops/fused_mp (receiver-indexed, atomic scatter),
    # "csr" = ops/csr_mp (destination-sorted, segmented sums).  When set to
    # "csr", pad_frame validates the CSR contract (window span + reversal
    # closure, ops/csr_mp.csr_contract_ok) on every frame and raises instead
    # of letting the kernel drop edges.
    mp_impl: Optional[str] = None
    # CSR tiling — the same values feed the kernel's window semantics
    # (models/blocks.GraphConvolution) and the host-side contract
    # validation (pad_frame), so the check and the kernel agree.
    csr_edge_tile: int = 512
    csr_window: int = 256
    # Source-side window of the CSR round: 0 = unwindowed source gather;
    # > 0 cuts each edge tile's sources to a window of csr_src_window node
    # ids (the TPU kernel's [TE, csr_src_window] one-hot).  Requires
    # spatially-coherent node ids: set spatial_sort together with this
    # (pad_frame validates the span, the model NaN-poisons runtime
    # violations).
    csr_src_window: int = 0
    # Relabel nodes in x-major spatial order at pad_frame time
    # (data/ordering.spatial_sort_frame).  Bounds the index distance of
    # kNN/ball neighbours — the prerequisite for csr_src_window and for
    # narrow halos in parallel/halo.py.  Model outputs/losses are
    # permutation-consistent (labels move with nodes); leave False where
    # bit-parity with reference preprocessing order matters.
    spatial_sort: bool = False

    # --- parallelism -------------------------------------------------------
    # The JAX package's mesh axes and its edge-partitioning axis.  The port
    # keeps the fields so that a configuration means the same in both, but
    # reads neither: its grid (parallel/mesh.py) has the same two axes as
    # process groups, and the edge-sharded step hands the model the graph
    # group at run time (RadarGNN.forward(graph_group=)).
    mesh_axes: Tuple[str, ...] = ("data", "graph")
    graph_axis: Optional[str] = None

    def __post_init__(self):
        self.input_node_feat_dim = 6 if self.include_region_confidence else 4
        if self.mp_impl not in MP_IMPLS:
            raise ValueError(
                f"mp_impl {self.mp_impl!r}: expected one of {MP_IMPLS}")
        # The CSR kernel's window bases are multiples of 8; misaligned
        # sizes are safe (floor-aligned clip + poison guard,
        # ops/csr_mp._layout) but waste window rows — reject them early
        # where they're a config mistake.  Scoped to configs that can reach
        # the CSR kernel: the other paths stay free to pick any capacity.
        if self.mp_impl == "csr" or self.csr_src_window > 0:
            for name in ("max_nodes", "csr_window", "csr_src_window"):
                if getattr(self, name) % 8:
                    raise ValueError(
                        f"{name} must be a multiple of 8 for the CSR kernel"
                    )

    # Derived quantities ----------------------------------------------------
    @property
    def num_classes(self) -> int:
        return len(self.object_classes_dyn)

    @property
    def max_edges(self) -> int:
        return int(
            self.edge_capacity_factor
            * self.k_number_nearest_points
            * self.max_nodes
        )

    @property
    def max_und_edges(self) -> int:
        return self.max_edges // 2

    @property
    def grid_min_r(self) -> float:
        return 0.0

    @property
    def grid_max_r(self) -> float:
        return math.sqrt(self.max_x**2 + self.max_y**2)

    @property
    def grid_min_th(self) -> float:
        return 0.0

    @property
    def grid_max_th(self) -> float:
        return math.pi * 0.5

    @property
    def lr_milestones(self) -> List[int]:
        return [int(f * self.max_train_iter) for f in self.lr_milestone_fracs]

    @classmethod
    def from_yaml(cls, path: str) -> "GNNConfig":
        """Load from a reference-format YAML file."""
        import yaml

        with open(path) as f:
            y = yaml.safe_load(f)

        def get(section, key, default):
            return y.get(section, {}).get(key, default)

        cfg = cls(
            seed=get("RANDOM", "seed", 1234),
            dataset_dir=get("DIRECTORIES", "dataset_dir", cls.dataset_dir),
            model_weights_dir=get("DIRECTORIES", "model_weights_dir", cls.model_weights_dir),
            reject_static_meas_by_ransac=get("DATA_SELECTION_PARAM", "reject_static_meas_by_ransac", False),
            temporal_window_size=get("DATA_SELECTION_PARAM", "temporal_window_size", 10),
            ball_query_eps_square=get("DATA_SELECTION_PARAM", "ball_query_eps_square", 25.0),
            k_number_nearest_points=get("DATA_SELECTION_PARAM", "k_number_nearest_points", 10),
            dataset_augmentation=get("DATA_SELECTION_PARAM", "dataset_augmentation", True),
            include_region_confidence=get("DATASET_INFO", "include_region_confidence", True),
            object_classes=tuple(get("OBJECT_CATEGORIES", "OBJECT_CLASS", cls.object_classes)),
            class_weights=tuple(get("OBJECT_CATEGORIES", "OBJECT_CLASS_WEIGHTS", cls.class_weights)),
            object_classes_dyn=tuple(get("OBJECT_CATEGORIES", "OBJECT_CLASS_DYN", cls.object_classes_dyn)),
            class_weights_dyn=tuple(get("OBJECT_CATEGORIES", "OBJECT_CLASS_WEIGHTS_DYN", cls.class_weights_dyn)),
            min_x=get("GRID_LIMITS", "min_x", 0.0),
            max_x=get("GRID_LIMITS", "max_x", 100.0),
            min_y=get("GRID_LIMITS", "min_y", -50.0),
            max_y=get("GRID_LIMITS", "max_y", 50.0),
            activation=get("GNN_ARCHITECTURE", "activation", "leakyrelu"),
            norm_layer=get("GNN_ARCHITECTURE", "normalization", "channel_normalization"),
            reg_mu=tuple(get("GNN_ARCHITECTURE", "reg_mu", (0.0, 0.0))),
            reg_sigma=tuple(get("GNN_ARCHITECTURE", "reg_sigma", (8.0, 4.0))),
            aggregation=get("GNN_ARCHITECTURE", "aggregation", "add"),
            node_feat_enc_stem_channels=tuple(get("GNN_ARCHITECTURE", "node_feat_enc_stem_channels", (256, 128, 64))),
            edge_feat_enc_stem_channels=tuple(get("GNN_ARCHITECTURE", "edge_feat_enc_stem_channels", (256, 128, 128, 64))),
            graph_convolution_stem_channels=tuple(get("GNN_ARCHITECTURE", "graph_convolution_stem_channels", (64,) * 7)),
            msg_mlp_hidden_dim=get("GNN_ARCHITECTURE", "msg_mlp_hidden_dim", 128),
            num_blocks_to_compute_edge=get("GNN_ARCHITECTURE", "num_blocks_to_compute_edge", 1),
            hidden_node_channels_gat=get("GNN_ARCHITECTURE", "hidden_node_channels_GAT", 512),
            num_heads_gat=get("GNN_ARCHITECTURE", "num_heads_GAT", 8),
            link_pred_stem_channels=tuple(get("GNN_ARCHITECTURE", "link_pred_stem_channels", (64, 64, 64))),
            node_pred_stem_channels=tuple(get("GNN_ARCHITECTURE", "node_pred_stem_channels", (64, 64, 64))),
            num_edge_classes=get("GNN_ARCHITECTURE", "num_edge_classes", 2),
            obj_cls_loss_weight=get("LOSS_WEIGHTS", "obj_loss_cls", 1.0),
            node_cls_loss_weight=get("LOSS_WEIGHTS", "node_loss_cls", 1.0),
            edge_cls_loss_weight=get("LOSS_WEIGHTS", "edge_loss_cls", 2.0),
            node_reg_loss_weight=get("LOSS_WEIGHTS", "node_loss_reg", 5.0),
            optim=get("OPTIMIZATION", "optim", "sgd"),
            max_train_iter=get("OPTIMIZATION", "max_training_iterations", 200_000),
            learning_rate=get("OPTIMIZATION", "learning_rate", 0.005),
            weight_decay=get("OPTIMIZATION", "weight_decay", 1e-4),
            max_train_iter_finetuning=get("FINETUNING", "max_training_iterations", 10_000),
            learning_rate_finetuning=get("FINETUNING", "learning_rate", 0.0005),
            weight_decay_finetuning=get("FINETUNING", "weight_decay", 1e-4),
            clustering_eps=get("FINETUNING", "clustering_eps", 1.5),
            num_training_samples=get("DATASET", "num_training_samples", 300_000),
            num_validation_samples=get("DATASET", "num_validation_samples", 1_000),
        )
        return cfg


def tiny_test_config(**overrides) -> GNNConfig:
    """Small-capacity config for unit tests and CI."""
    kw = dict(
        max_nodes=64,
        max_clusters=32,
        temporal_window_size=3,
        node_feat_enc_stem_channels=(32, 16),
        edge_feat_enc_stem_channels=(32, 16),
        graph_convolution_stem_channels=(16, 16),
        msg_mlp_hidden_dim=32,
        link_pred_stem_channels=(16, 16),
        node_pred_stem_channels=(16, 16),
        batch_size=2,
        max_train_iter=100,
    )
    kw.update(overrides)
    return GNNConfig(**kw)
