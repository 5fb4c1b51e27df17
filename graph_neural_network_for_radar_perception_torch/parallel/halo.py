"""Owner-computes edge partitioning with halo exchange.

The JAX package's ``parallel/halo.py`` over a grid of processes.  Where
``parallel/sharded.make_edge_sharded_train_step`` all-reduces a full
``[N, D]`` aggregate every round and replicates all node work across the
``graph`` axis, here:

* nodes are spatially sorted (``data/ordering.spatial_sort_frame``), so
  that the kNN sources of a node lie within a bounded index window of it;
* graph member g owns the contiguous node rows [g·N/G, (g+1)·N/G);
* edges are destination-sorted and owner-assigned on the host
  (``build_halo_shards``): member g holds exactly the edges whose
  destination it owns, with window-local indices.  The build raises if a
  source lies more than ``halo`` rows outside the owner's range.

Per message round each member then exchanges its first/last ``halo`` rows
with its two neighbours (``collectives.ppermute``: a send and a receive of
the rank's own rows, ``batch_isend_irecv``, under NCCL and under gloo on
the CPU), gathers sources from
``[halo ‖ owned ‖ halo]``, runs the message MLP on its edges, sums into its
owned rows, and runs the update MLP on them only.  A rank's graphs go
through as one batch (a leading graph axis, the JAX step's ``jax.vmap``):
two ppermutes a round for the batch.  The heads run on one all-gathered
``[B, N, D]``; the loss counts on graph member 0 only, so the
cotangents through the gather are counted once.  Every operation is local
or a linear collective with an exact transpose, so the gradients equal
the single-device step's.

The round is plain PyTorch (gathers, the block's MLPs, ``index_add_``), as
the JAX package's is plain XLA (``take``, MLP, ``segment_sum``): this path
launches no hand-written kernel.  Like the JAX package's fast-path helpers
it computes channel-normalised, leaky-ReLU, sum-aggregated rounds only.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional

import numpy as np
import torch
import torch.distributed as dist

from ..config.config import GNNConfig
from ..core.graph import GraphBatch, _TensorStruct
from ..models.blocks import uses_fused_kernel
from ..models.gnn import GNNOutputs
from ..ops import segment as S
from ..train.loss import LossSums, graph_loss_sums
from . import collectives as P
from .mesh import ProcessMesh
from .sharded import make_grid_step

# ---------------------------------------------------------------------------
# Host-side layout (numpy; the JAX package's, line for line)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class HaloShards(_TensorStruct):
    """Owner-assigned edge shards for one padded graph (or a batch).

    Shapes for one graph (batch prepends B):
      dst_loc:  [G, Ec] int32 — destination − owner_lo, in [0, N/G);
                sentinel N/G for padded slots.
      src_loc:  [G, Ec] int32 — source − (owner_lo − halo), in
                [0, N/G + 2·halo); sentinel 0 for padded slots (masked).
      edge_feat:[G, Ec, F_e] raw directed edge features.
      mask:     [G, Ec] bool.
    """

    dst_loc: Any
    src_loc: Any
    edge_feat: Any
    mask: Any


def required_halo(graph, n_shards: int) -> int:
    """Smallest halo width (rows) the graph needs for `n_shards` owners."""
    m = np.asarray(graph.edge_mask)
    s = np.asarray(graph.senders)[m]
    r = np.asarray(graph.receivers)[m]
    nl = graph.num_nodes // n_shards
    lo = (r // nl) * nl
    return int(max(np.maximum(lo - s, s - (lo + nl - 1)).max(initial=0), 0))


def build_halo_shards(
    graph, n_shards: int, halo: int, edge_cap: Optional[int] = None
) -> HaloShards:
    """Owner-assign one padded RadarGraph's directed edges (host, numpy).

    Raises if a source falls outside the halo window (frame not
    spatially sorted / halo too small) or an owner's edge count exceeds
    `edge_cap` — loud contracts, mirroring pad_frame's CSR validation.
    """
    n = graph.num_nodes
    if n % n_shards:
        raise ValueError(f"{n} nodes not divisible by {n_shards}")
    nl = n // n_shards

    m = np.asarray(graph.edge_mask)
    s = np.asarray(graph.senders)[m]
    r = np.asarray(graph.receivers)[m]
    ef = np.asarray(graph.edge_feat)[m]
    order = np.argsort(r, kind="stable")
    s, r, ef = s[order], r[order], ef[order]
    if edge_cap is None:
        counts = np.bincount(r // nl, minlength=n_shards)
        edge_cap = int(-(-int(counts.max(initial=1)) // 8) * 8)

    fe = ef.shape[-1]
    dst_loc = np.full((n_shards, edge_cap), nl, np.int32)
    src_loc = np.zeros((n_shards, edge_cap), np.int32)
    feats = np.zeros((n_shards, edge_cap, fe), np.float32)
    mask = np.zeros((n_shards, edge_cap), bool)
    owner = r // nl
    for g in range(n_shards):
        sel = owner == g
        cnt = int(sel.sum())
        if cnt > edge_cap:
            raise ValueError(
                f"owner {g} holds {cnt} edges > edge_cap {edge_cap}; "
                "raise edge_cap (skewed in-degree?)"
            )
        lo = g * nl
        sl = s[sel] - (lo - halo)
        if cnt and (sl.min() < 0 or sl.max() >= nl + 2 * halo):
            raise ValueError(
                f"source outside halo window on owner {g} "
                f"(need halo ≥ {required_halo(graph, n_shards)}, have {halo}); "
                "spatial_sort_frame the frame or widen the halo"
            )
        dst_loc[g, :cnt] = r[sel] - lo
        src_loc[g, :cnt] = sl
        feats[g, :cnt] = ef[sel]
        mask[g, :cnt] = True
    return HaloShards(dst_loc, src_loc, feats, mask)


def make_halo_batch(
    batch: GraphBatch, cfg: GNNConfig, n_shards: int, halo: int
) -> HaloShards:
    """Batched host build: HaloShards with leading batch axis."""
    edge_cap = halo_edge_cap(cfg, n_shards)
    per = [
        build_halo_shards(batch.graph.at(b), n_shards, halo, edge_cap)
        for b in range(batch.batch_size)
    ]
    return HaloShards(
        dst_loc=np.stack([p.dst_loc for p in per]),
        src_loc=np.stack([p.src_loc for p in per]),
        edge_feat=np.stack([p.edge_feat for p in per]),
        mask=np.stack([p.mask for p in per]),
    )


def halo_edge_cap(cfg: GNNConfig, n_shards: int) -> int:
    """Static per-owner edge capacity: 1.5× the mean share of the edge
    capacity, rounded up to 8 (in-degree of symmetrised kNN is nearly
    uniform; build_halo_shards raises on overflow)."""
    mean = -(-cfg.max_edges // n_shards)
    return -(-3 * mean // 2) // 8 * 8 + 8


def member_shards(shards: HaloShards, index: int) -> HaloShards:
    """Graph member ``index``'s column of a batched HaloShards ([B, G, ...]
    → [B, ...], numpy)."""
    return HaloShards(**{f.name: np.asarray(getattr(shards, f.name))[:, index]
                         for f in dataclasses.fields(HaloShards)})


def halo_width(batch: GraphBatch, n_shards: int) -> int:
    """The halo a batch needs: its widest graph's ``required_halo``,
    rounded up to 8 (at least 8), as the JAX workers and tests size it."""
    need = max(required_halo(batch.graph.at(b), n_shards)
               for b in range(batch.batch_size))
    return 8 * max(1, -(-need // 8))


# ---------------------------------------------------------------------------
# Device-side forward
# ---------------------------------------------------------------------------


def _halo_exchange(x_local: torch.Tensor, halo: int, group) -> torch.Tensor:
    """[nl, D] → [nl + 2·halo, D] (a batch: [B, nl, D] → [B, nl + 2·halo,
    D], the same ppermutes for every graph): owned rows flanked by `halo`
    boundary rows from each side's neighbours.

    When halo exceeds the shard width nl, ⌈halo/nl⌉ hops pull whole
    blocks from farther members (comm stays ∝ halo).  Ends of the chain
    receive zeros (ppermute semantics), which build_halo_shards
    guarantees are never gathered."""
    g = dist.get_world_size(group)
    nl = x_local.shape[-2]
    hops = -(-halo // nl)
    left, right = [], []
    for hop in range(1, hops + 1):
        fwd = [(i, i + hop) for i in range(g - hop)]
        bwd = [(i + hop, i) for i in range(g - hop)]
        left.insert(0, P.ppermute(x_local, fwd, group))
        right.append(P.ppermute(x_local, bwd, group))
    from_left = torch.cat(left, dim=-2)[..., -halo:, :]
    from_right = torch.cat(right, dim=-2)[..., :halo, :]
    return torch.cat([from_left, x_local, from_right], dim=-2)


def halo_forward(model, graph, shard: HaloShards, node2cluster,
                 num_clusters: int, cluster_mask, *, halo: int,
                 group) -> GNNOutputs:
    """Owner-computes forward of ``model`` (a ``RadarGNN``) on graph member
    ``dist.get_rank(group)``, for ONE graph or a batch with a leading
    graph axis (the JAX step's ``jax.vmap`` of it): every collective then
    moves the batch at once — two ppermutes a round, one all_gather.

    ``graph`` arrives whole on every member; ``shard`` holds only this
    member's owner-assigned edges ([Ec] shapes; [B, Ec] for a batch).
    Returns GNNOutputs built from the all-gathered node embeddings
    (identical on every member)."""
    g_idx = dist.get_rank(group)
    nl = graph.num_nodes // dist.get_world_size(group)
    lo = g_idx * nl

    # Encode only the owned node rows.
    x = model.encode_node_feat(graph.node_feat.narrow(-2, lo, nl))
    mask = shard.mask[..., None]
    e = model.encode_edge_feat(shard.edge_feat)
    e = torch.where(mask, e, torch.zeros_like(e))

    dst, src = shard.dst_loc, shard.src_loc
    for blk in model.pass_messages.blocks:
        x_ext = _halo_exchange(x, halo, group)
        # index_select (S.gather_nodes), whose backward is an index_add_:
        # advanced indexing's backward (a sort of the indices, then a walk
        # of each row's duplicates) took 90 % of a step's card time here.
        xs = S.gather_nodes(x_ext, src)
        xd = S.gather_nodes(x, dst.clamp(max=nl - 1))
        msg = blk.msg_mlp(torch.cat([xd, xs, e], dim=-1))
        msg = torch.where(mask, msg, torch.zeros_like(msg))
        agg = S.masked_segment_sum(msg, dst, nl)  # the sentinel nl is dropped
        upd = blk.upd_mlp(torch.cat([x, agg], dim=-1))
        identity = x if blk.identity is None else blk.identity_norm(blk.identity(x))
        x = identity + upd

    # One gather for the (cheap) heads; member 0's loss copy is the one
    # that counts (make_halo_train_step masks the rest), so cotangents
    # through this all_gather are exact.  [G, (B,) nl, D] → [(B,) N, D].
    x_full = torch.movedim(P.all_gather(x, group), 0, -3).flatten(-3, -2)

    nm = graph.node_mask
    node_cls, node_off = model._node_heads(x_full, nm)
    edge_cls = model.predict_link(x_full, graph.und_senders,
                                  graph.und_receivers, nm, graph.und_mask)
    obj_cls = model.predict_class(x_full, node2cluster, num_clusters, nm,
                                  cluster_mask)
    return GNNOutputs(node_cls, node_off, edge_cls, obj_cls, x_full)


# ---------------------------------------------------------------------------
# Train step
# ---------------------------------------------------------------------------


def make_halo_train_step(cfg: GNNConfig, mesh: ProcessMesh, halo: int) -> Callable:
    """Full train step with owner-computes edge partitioning.

    The returned step takes (state, batch, shards): this rank's rows of
    'data' of the batch and its member's column of the HaloShards (build
    them with make_halo_batch on the host from spatially-sorted frames,
    then ``member_shards``), and runs ONE ``halo_forward`` for the rows
    (``sharded.make_grid_step``: one backward, the branchless skip; under
    NCCL on the card one captured CUDA graph, the batch's and the shards'
    arrays copied into its buffers).
    Every LossSums field counts on graph member 0 only: the heads run on the
    replicated all-gathered embeddings."""
    if not uses_fused_kernel(cfg.norm_layer, cfg.activation, cfg.aggregation):
        raise ValueError("the halo round computes channel normalisation, leaky "
                         "ReLU and sum aggregation only")
    group = mesh.graph_group
    if group is None:
        raise ValueError("the halo step needs a graph axis of 2 or more")

    def graph_sums(model, batch: GraphBatch, shards: HaloShards):
        labels = batch.labels
        out = halo_forward(model, batch.graph, shards, labels.node2cluster,
                           cfg.max_clusters, labels.cluster_mask,
                           halo=halo, group=group)
        return graph_loss_sums(out, batch.graph, labels, cfg)

    fields = [f.name for f in dataclasses.fields(HaloShards)]
    return make_grid_step(
        cfg, mesh, graph_sums, LossSums._fields,
        leaves=lambda args: GraphBatch.leaves(args[0]) + [getattr(args[1], f) for f in fields],
        rebuild=lambda inputs: (GraphBatch.from_leaves(inputs[:-len(fields)]),
                                HaloShards(*inputs[-len(fields):])))
