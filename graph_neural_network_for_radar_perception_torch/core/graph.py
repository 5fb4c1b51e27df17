"""Static-shape padded graph containers, as dataclasses of tensors.

A graph is a fixed-capacity, masked struct of arrays (the JAX package's
``core/graph.py``, same fields and capacities):

* nodes padded to ``num_nodes`` capacity with ``node_mask``;
* the directed message-passing edge set padded to ``num_edges`` capacity
  with ``edge_mask``;
* a canonical *undirected* (upper-triangular, row-major ``src < dst``) edge
  view for the link head, with ``und_mask``;
* cluster membership as a per-node segment id (``node2cluster``).

``pad_frame`` builds these as numpy arrays; ``from_numpy`` moves them to a
device as tensors.  A batch stacks each field along a new leading axis.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any, Optional

import numpy as np
import torch


def resolve_device(device) -> torch.device:
    """``device`` as a torch.device; a CUDA device without a card raises
    (the port's entry points do not fall back to the CPU)."""
    device = torch.device(device)
    if device.type != "cpu" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(device)!r}: CUDA is not available; pass "
            "device='cpu' to run the plain versions"
        )
    return device


@functools.lru_cache(maxsize=None)
def device_constant(values: tuple, dtype: torch.dtype,
                    device: torch.device) -> torch.Tensor:
    """``torch.tensor(values)`` on ``device``, made on first use and reused
    (read it, never write it): a train step captured as a CUDA graph then
    copies nothing from the host."""
    return torch.tensor(values, dtype=dtype, device=device)


class _TensorStruct:
    """Field-wise conversions shared by the containers below."""

    @classmethod
    def from_numpy(cls, obj, device="cpu"):
        """Numpy-valued instance (e.g. from ``pad_frame``) → tensors on
        ``device``."""
        return cls(**{
            f.name: torch.from_numpy(np.ascontiguousarray(getattr(obj, f.name))).to(device)
            for f in dataclasses.fields(cls)
        })

    def to(self, device):
        return type(self)(**{
            f.name: getattr(self, f.name).to(device)
            for f in dataclasses.fields(self)
        })

    def at(self, i):
        """Item ``i`` of a stacked batch: every field indexed on axis 0."""
        return type(self)(**{
            f.name: getattr(self, f.name)[i] for f in dataclasses.fields(self)
        })


@dataclasses.dataclass(frozen=True)
class RadarGraph(_TensorStruct):
    """One padded radar frame graph (or a stacked batch of them).

    Attributes (single graph; a batch prepends B):
      node_feat:     [N, F_n] float32 — (vr, rcs, t_norm, degree/10,
                     range_conf, azi_conf).
      edge_feat:     [E, F_e] float32 — (dx/10, dy/10, dl/10, dvx, dvy, dvl,
                     dt).
      senders:       [E] int32 — source node of each directed edge.
      receivers:     [E] int32 — target node; messages aggregate here.
      node_mask:     [N] bool.
      edge_mask:     [E] bool.
      und_senders:   [Eu] int32 — undirected (triu) edge source, src < dst.
      und_receivers: [Eu] int32.
      und_mask:      [Eu] bool.
      other_feat:    [N, 4] float32 — (px, py, vx, vy), used to decode
                     predicted cluster centers.
    """

    node_feat: Any
    edge_feat: Any
    senders: Any
    receivers: Any
    node_mask: Any
    edge_mask: Any
    und_senders: Any
    und_receivers: Any
    und_mask: Any
    other_feat: Any

    @property
    def num_nodes(self) -> int:
        return self.node_feat.shape[-2]

    @property
    def num_edges(self) -> int:
        return self.senders.shape[-1]

    @property
    def num_und_edges(self) -> int:
        return self.und_senders.shape[-1]

    def n_valid_nodes(self):
        return self.node_mask.sum(-1)

    def n_valid_edges(self):
        return self.edge_mask.sum(-1)


@dataclasses.dataclass(frozen=True)
class GraphLabels(_TensorStruct):
    """Padded ground-truth labels aligned with a RadarGraph.

    Attributes:
      node_class:    [N] int32 — 7-class dynamic taxonomy id.
      node_offsets:  [N, 2] float32 — (dx, dy) to the node's track mean.
      edge_class:    [Eu] int32 — 1 iff both ends share a non-empty track.
      node2cluster:  [N] int32 — ground-truth cluster slot; padded nodes map
                     to the void slot C.
      cluster_class: [C] int32.
      cluster_mask:  [C] bool.
    """

    node_class: Any
    node_offsets: Any
    edge_class: Any
    node2cluster: Any
    cluster_class: Any
    cluster_mask: Any

    @property
    def num_clusters(self) -> int:
        return self.cluster_class.shape[-1]


@dataclasses.dataclass(frozen=True)
class GraphBatch:
    """A stacked batch: every field of graph/labels has leading axis B."""

    graph: RadarGraph
    labels: Optional[GraphLabels]

    @property
    def batch_size(self) -> int:
        return self.graph.node_feat.shape[0]

    @classmethod
    def from_numpy(cls, obj, device="cpu"):
        return cls(
            graph=RadarGraph.from_numpy(obj.graph, device),
            labels=None if obj.labels is None
            else GraphLabels.from_numpy(obj.labels, device),
        )

    def to(self, device):
        return GraphBatch(
            graph=self.graph.to(device),
            labels=None if self.labels is None else self.labels.to(device),
        )

    def at(self, i):
        """Item ``i`` along the leading axis (a graph of the batch, or a
        batch of batches stacked on a further leading axis)."""
        return GraphBatch(
            graph=self.graph.at(i),
            labels=None if self.labels is None else self.labels.at(i),
        )

    def leaves(self) -> list:
        """The arrays of the batch (numpy or tensors), the graph's fields
        then the labels', in declaration order: a captured step's inputs."""
        return ([getattr(self.graph, f) for f in RadarGraph.__dataclass_fields__]
                + [getattr(self.labels, f) for f in GraphLabels.__dataclass_fields__])

    @classmethod
    def from_leaves(cls, inputs: list) -> "GraphBatch":
        """The batch whose fields are ``inputs``, in ``leaves`` order."""
        names = list(RadarGraph.__dataclass_fields__)
        return cls(
            RadarGraph(**dict(zip(names, inputs[:len(names)]))),
            GraphLabels(**dict(zip(GraphLabels.__dataclass_fields__, inputs[len(names):]))))
