"""Multi-process orchestration: process-group start-up, the grid, and
per-process batch feeding.

The JAX package's ``parallel/distributed.py`` with one device per process:

1. every process calls :func:`init_distributed` (a coordinator address, a
   ``torch.distributed`` store, or torchrun's ``RANK``/``WORLD_SIZE``/
   ``MASTER_ADDR``/``MASTER_PORT``) before it builds the grid;
2. ``mesh.make_mesh`` lays the ``('data', 'graph')`` grid over the ranks,
   ``graph`` fastest, so a graph group spans neighbouring ranks
   (on a multi-card host, the cards of one host);
3. each process builds only its rows of every global batch
   (:func:`process_local_batch_slice`) and places them
   (:func:`globalize_batch`);
4. the train step is the same as on one grid (``parallel/sharded.py``,
   ``parallel/halo.py``).
"""

from __future__ import annotations

import datetime
import os
from typing import Callable, Optional, Tuple, Union

import numpy as np
import torch
import torch.distributed as dist

from ..core.graph import GraphBatch
from ..train.steps import TrainState, batch_on, create_train_state
from . import collectives as P
from .mesh import ProcessMesh, edge_shard, make_mesh, rank_device


def init_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    *,
    device="cuda",
    backend: Optional[str] = None,
    store: Union[None, str, "dist.Store"] = None,
    timeout_s: Optional[float] = None,
) -> torch.device:
    """Initialise the default process group and return this rank's device.

    The rendezvous is ``store`` (a ``torch.distributed.Store``, or the path
    of a ``FileStore``, which tests use so that parallel runs do not race
    for ports), else ``tcp://{coordinator_address}``, else torchrun's
    environment (``env://``), else, for a single process, an in-process
    store.  ``num_processes``/``process_id`` default to ``WORLD_SIZE``/
    ``RANK``.  ``device``: the card unless ``"cpu"`` (raises without a
    card); on the card the rank takes ``cuda:{local rank mod cards}``, so
    every rank of a one-card run shares ``cuda:0``.  ``backend``: ``nccl``
    on the card, ``gloo`` on the CPU; ``gloo`` may be asked for on the
    card (it is the one that runs several ranks on one card)."""
    world = num_processes if num_processes is not None else int(os.environ.get("WORLD_SIZE", 1))
    rank = process_id if process_id is not None else int(os.environ.get("RANK", 0))
    device = rank_device(device, rank)
    if backend is None:
        backend = "nccl" if device.type == "cuda" else "gloo"
    if device.type == "cpu" and backend != "gloo":
        raise ValueError(f"backend {backend!r} on the CPU: only gloo runs there")
    kw = dict(backend=backend, world_size=world, rank=rank)
    if timeout_s is not None:
        kw["timeout"] = datetime.timedelta(seconds=timeout_s)
    if isinstance(store, str):
        kw["store"] = dist.FileStore(store, world)
    elif store is not None:
        kw["store"] = store
    elif coordinator_address is not None:
        kw["init_method"] = f"tcp://{coordinator_address}"
    elif "MASTER_ADDR" in os.environ:
        kw["init_method"] = "env://"
    elif world == 1:
        kw["store"] = dist.HashStore()
    else:
        raise ValueError(f"{world} processes need a coordinator address, a "
                         "store or MASTER_ADDR/MASTER_PORT")
    if device.type == "cuda":
        torch.cuda.set_device(device)
    dist.init_process_group(**kw)
    return device


def process_local_batch_slice(global_batch: int, mesh: ProcessMesh,
                              rows: str = "data") -> slice:
    """The slice of the global batch axis THIS process builds: its data
    row's (``rows="data"``, every member of a data row builds the same
    rows) or, for the data-parallel step, its own (``rows="all"``)."""
    shards, index = ((mesh.size, mesh.rank) if rows == "all"
                     else (mesh.n_data, mesh.data_index))
    if global_batch % shards:
        raise ValueError(f"global batch {global_batch} must divide by {shards}")
    per = global_batch // shards
    return slice(index * per, (index + 1) * per)


def globalize_batch(mesh: ProcessMesh, local_batch: GraphBatch,
                    edges: bool = False) -> GraphBatch:
    """This process's rows (numpy or tensors) on its device; with
    ``edges`` cut to its edge shard over 'graph' first (the edge-sharded
    step's placement)."""
    if edges:
        local_batch = edge_shard(local_batch, mesh.n_graph, mesh.graph_index)
    return batch_on(local_batch, mesh.device)


def replicated_create_state(cfg, mesh: ProcessMesh, seed: int = 0) -> TrainState:
    """A TrainState equal on every rank: made from ``seed`` on each (as
    ``train/steps.create_train_state`` on the rank's device), then every
    parameter broadcast from rank 0 in one flat buffer, so that ranks agree
    even where their initialisation would not."""
    state = create_train_state(cfg, torch.Generator().manual_seed(seed),
                               device=mesh.device)
    params = list(state.model.parameters())
    with torch.no_grad():
        flat = torch.cat([p.reshape(-1) for p in params])
        dist.broadcast(flat, src=0)
        for p, v in zip(params, flat.split([p.numel() for p in params])):
            p.copy_(v.view_as(p))
    return state


def assert_same_across_processes(tensors, name: str = "tree") -> None:
    """Cheap cross-process consistency check: gathers one float64
    fingerprint per rank, Σ_i sum(t_i)·(i mod 13 + 1) as the JAX package's
    (on the device of the first tensor, so that NCCL can carry it), and
    verifies every rank holds the same value (guards against divergent
    params after a missed broadcast or restore)."""
    tensors = list(tensors)
    fp = sum(float(np.sum(x.detach().cpu().numpy().astype(np.float64))) * (i % 13 + 1)
             for i, x in enumerate(tensors))
    with torch.no_grad():
        fps = P.all_gather(torch.tensor(fp, dtype=torch.float64, device=tensors[0].device),
                           None).cpu().numpy()
    if not np.allclose(fps, fps[0], rtol=1e-9, atol=1e-12):
        raise AssertionError(f"{name} differs across processes: {fps}")


def multihost_train_setup(
    cfg,
    n_graph: int = 1,
    graph_partition: str = "edge",
    halo: int = 16,
    device="cuda",
) -> Tuple[ProcessMesh, Callable]:
    """Grid + train step for a multi-process run: the data-parallel step
    (n_graph == 1), the edge-sharded step (n_graph > 1, graph_partition
    'edge'), or the owner-computes halo step ('halo': spatially-sorted
    frames and a static halo width).  The message rounds are
    ``cfg.mp_impl``'s."""
    from .halo import make_halo_train_step
    from .sharded import make_dp_train_step, make_edge_sharded_train_step

    mesh = make_mesh(n_graph=n_graph, device=device)
    if n_graph == 1:
        step = make_dp_train_step(cfg, mesh)
    elif graph_partition == "halo":
        step = make_halo_train_step(cfg, mesh, halo)
    else:
        step = make_edge_sharded_train_step(cfg, mesh)
    return mesh, step
