"""Spatial node ordering for locality-sensitive kernels and partitioning.

Relabeling nodes in x-major spatial order bounds the INDEX distance
between kNN/radius neighbours, which is what makes windowed gathers work:
the halo partitioner (parallel/halo.py) needs sources within ``halo``
rows of each owner range, and the source-windowed CSR kernel
(ops/pallas/csr_mp.py) needs every edge tile's sources inside one
``src_window``-row node window.  A pure host-side numpy permutation —
all node-aligned arrays move together and the canonical edge
enumerations (row-major directed, triu undirected — the parity contracts
ops/graph_build.py establishes) are rebuilt in the permuted labels.

No reference counterpart: the reference keeps dataset point order
(modules/data_utils/read_data.py) because torch_geometric's scatter is
order-insensitive on GPU; on TPU, ordering IS the optimisation.

The port's own copy of the JAX package's ``data/ordering.py`` (numpy only), kept
so that the port imports nothing of that package.
"""

from __future__ import annotations

import dataclasses

import numpy as np


def spatial_sort_frame(fr):
    """Permute a FrameArrays' nodes into x-major spatial order and rebuild
    the canonical edge enumerations.

    Sorting nodes by (px, py) bounds the index distance between kNN
    neighbours, which keeps halos narrow and source windows small.  All
    node-aligned arrays are permuted consistently; the directed edge list
    is re-sorted into row-major (sender-major) order and the undirected
    list into canonical triu order, with edge features/labels carried
    along — the same contracts ops/graph_build.py establishes on unsorted
    frames.
    """
    order = np.lexsort((fr.other_feat[:, 1], fr.other_feat[:, 0]))
    inv = np.empty_like(order)
    inv[order] = np.arange(order.size)

    s = inv[fr.senders]
    r = inv[fr.receivers]
    eorder = np.lexsort((r, s))

    us = inv[fr.und_senders]
    ur = inv[fr.und_receivers]
    lo, hi = np.minimum(us, ur), np.maximum(us, ur)
    uorder = np.lexsort((hi, lo))

    return dataclasses.replace(
        fr,
        node_feat=fr.node_feat[order],
        other_feat=fr.other_feat[order],
        node_class=fr.node_class[order],
        node_offsets=fr.node_offsets[order],
        node2cluster=fr.node2cluster[order],
        senders=s[eorder],
        receivers=r[eorder],
        edge_feat=fr.edge_feat[eorder],
        und_senders=lo[uorder],
        und_receivers=hi[uorder],
        edge_class=fr.edge_class[uorder],
    )
