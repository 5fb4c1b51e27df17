"""The process grid: the JAX package's ``('data', 'graph')`` device mesh
(``parallel/mesh.py``) with one device per process.

* ``data``: data parallelism over stacked frame graphs (batch axis 0);
* ``graph``: edge partitioning within each graph: every edge-indexed field
  sliced along E, partial segment sums combined by one all-reduce per
  message round (``models/blocks.py``).

An ``n_data × n_graph`` grid of processes holds rank ``d·n_graph + g`` at
(d, g).  Rank (d, g) belongs to one graph group, the ranks (d, ·) that
share a data row, and one data group, the ranks (·, g).  Every rank
creates every group, in the same order (``torch.distributed.new_group``
is collective over the world); an axis of size 1 gets no group.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional

import torch
import torch.distributed as dist

from ..core.graph import GraphBatch, resolve_device
from ..train.steps import batch_on

# The edge-indexed fields of a batch, sliced along E over 'graph' (the JAX
# package's edge_sharded_batch_specs: P('data', 'graph') on these fields,
# P('data') on every other).
GRAPH_EDGE_FIELDS = ("edge_feat", "senders", "receivers", "edge_mask",
                     "und_senders", "und_receivers", "und_mask")
LABEL_EDGE_FIELDS = ("edge_class",)


def rank_device(device="cuda", rank: Optional[int] = None) -> torch.device:
    """This process's device: on the card ``cuda:{local rank mod cards}``
    (every rank on one card shares ``cuda:0``), else ``device`` as given.
    Raises without a card unless the CPU is asked for."""
    device = resolve_device(device)
    if device.type == "cuda" and device.index is None:
        if rank is None:
            rank = dist.get_rank() if dist.is_initialized() else 0
        local = int(os.environ.get("LOCAL_RANK", rank))
        device = torch.device("cuda", local % torch.cuda.device_count())
    return device


@dataclasses.dataclass(frozen=True)
class ProcessMesh:
    """This rank's place in the grid, its groups and its device."""

    n_data: int
    n_graph: int
    rank: int
    device: torch.device
    graph_group: Optional[object] = None  # ranks (d, ·); None if n_graph == 1
    data_group: Optional[object] = None   # ranks (·, g); None if n_data == 1

    @property
    def size(self) -> int:
        return self.n_data * self.n_graph

    @property
    def data_index(self) -> int:
        return self.rank // self.n_graph

    @property
    def graph_index(self) -> int:
        return self.rank % self.n_graph


def make_mesh(n_data: Optional[int] = None, n_graph: int = 1,
              device="cuda") -> ProcessMesh:
    """The grid over every process of the initialised default group
    (``distributed.init_distributed``); ``n_data`` defaults to
    world size / ``n_graph``, and the grid must cover the world."""
    world, rank = dist.get_world_size(), dist.get_rank()
    if n_data is None:
        n_data = world // n_graph
    if n_data * n_graph != world:
        raise ValueError(f"a {n_data}x{n_graph} grid needs {n_data * n_graph} "
                         f"processes, the world has {world}")
    graph_group = data_group = None
    if n_graph > 1:
        for d in range(n_data):
            g = dist.new_group([d * n_graph + i for i in range(n_graph)])
            if d == rank // n_graph:
                graph_group = g
    if n_data > 1:
        for j in range(n_graph):
            g = dist.new_group([i * n_graph + j for i in range(n_data)])
            if j == rank % n_graph:
                data_group = g
    return ProcessMesh(n_data, n_graph, rank, rank_device(device, rank),
                       graph_group, data_group)


def _map_fields(struct, fn):
    return type(struct)(**{f.name: fn(f.name, getattr(struct, f.name))
                           for f in dataclasses.fields(struct)})


def _share(n: int, shards: int, index: int, what: str) -> slice:
    if n % shards:
        raise ValueError(f"{what} {n} does not divide into {shards} shards")
    per = n // shards
    return slice(index * per, (index + 1) * per)


def batch_rows(batch: GraphBatch, shards: int, index: int) -> GraphBatch:
    """Rows ``index``/``shards`` of the batch axis of every field."""
    sl = _share(batch.batch_size, shards, index, "batch size")
    return GraphBatch(graph=_map_fields(batch.graph, lambda _, x: x[sl]),
                      labels=_map_fields(batch.labels, lambda _, x: x[sl]))


def edge_shard(batch: GraphBatch, shards: int, index: int) -> GraphBatch:
    """Shard ``index`` of ``shards``: the contiguous 1/G along E (axis 1)
    of every edge-indexed field; every other field whole.  G must divide
    the edge capacities, as shard_map requires."""
    e = _share(batch.graph.num_edges, shards, index, "edge capacity")
    eu = _share(batch.graph.num_und_edges, shards, index, "undirected edge capacity")

    graph = _map_fields(batch.graph, lambda name, x: (
        x[:, eu if name.startswith("und_") else e]
        if name in GRAPH_EDGE_FIELDS else x))
    labels = _map_fields(batch.labels, lambda name, x: (
        x[:, eu] if name in LABEL_EDGE_FIELDS else x))
    return GraphBatch(graph=graph, labels=labels)


@dataclasses.dataclass(frozen=True)
class BatchSharding:
    """The share of a global batch (numpy or tensors) that one rank holds:
    its rows of the batch axis, cut over 'data' (``rows="data"``, replicated
    over 'graph') or over every rank (``rows="all"``, the data-parallel
    step's), and with ``edges`` its edge shard over 'graph'.  Calling it
    cuts on the host; ``place`` also moves the share to the rank's device."""

    mesh: ProcessMesh
    rows: str = "data"
    edges: bool = False

    def __call__(self, batch: GraphBatch) -> GraphBatch:
        m = self.mesh
        if self.rows == "all":
            batch = batch_rows(batch, m.size, m.rank)
        else:
            batch = batch_rows(batch, m.n_data, m.data_index)
        if self.edges:
            batch = edge_shard(batch, m.n_graph, m.graph_index)
        return batch

    def place(self, batch: GraphBatch) -> GraphBatch:
        return batch_on(self(batch), self.mesh.device)
