"""Collectives over an explicit process group, differentiable as JAX's are.

The counterparts of shard_map's ``psum``, ``pmax``, ``ppermute`` and
``all_gather`` (the JAX package's ``models/blocks.py`` and
``parallel/halo.py`` call those inside a mesh axis; here a mesh axis is a
``torch.distributed`` process group, ``parallel/mesh.py``).  Each is a
``torch.autograd.Function`` whose backward is JAX's transpose:

* ``psum``: the sum all-reduce of the cotangent;
* ``ppermute``: the reverse permutation of the cotangent;
* ``all_gather``: this rank's slice of the summed cotangent (a
  reduce-scatter);
* ``pmax``: forward only.  JAX has no differentiation rule for ``pmax``
  (``NotImplementedError: Differentiation rule for 'pmax' not
  implemented``), so its backward raises the same.

Two routes, chosen from the group's backend and the tensor's device:

* native, under NCCL and under gloo with CPU tensors: ``ppermute`` is one
  ``batch_isend_irecv`` (an ``isend`` for each pair this rank sends, an
  ``irecv`` for the pair it receives; a rank with neither posts nothing),
  ``all_gather`` one ``all_gather_into_tensor`` and its backward one
  ``reduce_scatter_tensor`` (their ``*_single`` names where torch has
  them): each rank hands over its own rows once;
* staged, under gloo with CUDA tensors (several ranks on one card; gloo
  takes CUDA tensors for ``all_reduce`` and ``broadcast`` only): one
  all-reduce of a zero-filled ``[G, ...]`` buffer in which each rank writes
  its own rows.  Adding zeros is exact, so the result is the permutation or
  the gather bit for bit, at G times the bytes.

``psum`` and ``pmax`` are one all-reduce on either route.

Every rank of the group must call the same collectives in the same order,
forward and backward.  Every collective of ``parallel/`` is counted in
``STATS``: per kind (``KINDS``) its calls and the bytes this rank handed to
it, and over all kinds the calls and the host seconds spent in them (under
gloo with CUDA tensors that includes the wait for the card's earlier work,
since the tensor is staged through the host).  A replayed CUDA graph adds
the calls and bytes its capture recorded (``core/capture``, where
``STATS``' calls and bytes are registered), not seconds: a replay spends
no host time in any one collective; the tracer's ``collectives`` watch
reports ``STATS``.
"""

from __future__ import annotations

import time
from typing import List, Sequence, Tuple

import torch
import torch.distributed as dist

from ..core.capture import register_counters
from ..utils.profiling import TRACER

KINDS = ("all_reduce", "ppermute", "all_gather", "reduce_scatter")
STATS = {"calls": 0, "seconds": 0.0, **{k: {"calls": 0, "bytes": 0} for k in KINDS}}

# The names of the two single-tensor collectives in this torch: newer
# releases deprecate ``all_gather_into_tensor``/``reduce_scatter_tensor``
# for ``*_single``.
_ALL_GATHER = getattr(dist, "all_gather_single", None) or dist.all_gather_into_tensor
_REDUCE_SCATTER = getattr(dist, "reduce_scatter_single", None) or dist.reduce_scatter_tensor


def counts() -> List[int]:
    """The calls over all kinds, then each kind's calls and bytes."""
    return [STATS["calls"]] + [STATS[k][f] for k in KINDS for f in ("calls", "bytes")]


def add_counts(deltas: Sequence[int]) -> None:
    """Add ``deltas`` (in ``counts()``'s order) to ``STATS``."""
    STATS["calls"] += deltas[0]
    for i, (k, f) in enumerate((k, f) for k in KINDS for f in ("calls", "bytes")):
        STATS[k][f] += deltas[1 + i]


register_counters(["collectives.calls"] + [f"collectives.{k}.{f}" for k in KINDS
                                          for f in ("calls", "bytes")], counts, add_counts)
TRACER.watch("collectives", lambda: {k: (dict(v) if isinstance(v, dict) else v)
                                     for k, v in STATS.items()})


def _counted(kind: str, nbytes: int, t0: float) -> None:
    STATS["calls"] += 1
    STATS["seconds"] += time.perf_counter() - t0
    STATS[kind]["calls"] += 1
    STATS[kind]["bytes"] += nbytes


def all_reduce_(x: torch.Tensor, group=None, op=dist.ReduceOp.SUM,
                kind: str = "all_reduce") -> torch.Tensor:
    """In-place all-reduce of ``x`` over the group (None: the world),
    counted in ``STATS`` under ``kind``; returns ``x``."""
    t0 = time.perf_counter()
    dist.all_reduce(x, op=op, group=group)
    _counted(kind, x.nbytes, t0)
    return x


def _all_reduce(x: torch.Tensor, group, op=dist.ReduceOp.SUM) -> torch.Tensor:
    return all_reduce_(x.contiguous().clone(), group, op)


def _staged(x: torch.Tensor, group) -> bool:
    """Gloo with a CUDA tensor: the all-reduce route."""
    return x.device.type == "cuda" and dist.get_backend(group) == "gloo"


def _global(group, rank: int) -> int:
    return rank if group is None else dist.get_global_rank(group, rank)


# ------------------------------------------------------------- staged route
def _scatter_rows(x: torch.Tensor, rows: Sequence[int], group, kind: str) -> torch.Tensor:
    """A zero [G, *x.shape] buffer with x at each of ``rows``, summed over
    the group: row i holds what the ranks that wrote row i sent."""
    buf = x.new_zeros((dist.get_world_size(group),) + tuple(x.shape))
    for r in rows:
        buf[r] = x
    return all_reduce_(buf, group, kind=kind)


def _staged_permute(x, perm, group):
    me = dist.get_rank(group)
    return _scatter_rows(x, [d for s, d in perm if s == me], group, "ppermute")[me]


def _staged_gather(x, group):
    return _scatter_rows(x, [dist.get_rank(group)], group, "all_gather")


def _staged_gather_transpose(g, group):
    """[G, *shape] cotangent → this rank's row of its sum."""
    return all_reduce_(g.contiguous().clone(), group, kind="reduce_scatter")[dist.get_rank(group)]


# ------------------------------------------------------------- native route
def _native_permute(x, perm, group):
    me = dist.get_rank(group)
    x = x.contiguous()
    out = torch.zeros_like(x)
    ops = [dist.P2POp(dist.isend, x, _global(group, d), group) for s, d in perm if s == me]
    ops += [dist.P2POp(dist.irecv, out, _global(group, s), group) for s, d in perm if d == me]
    t0 = time.perf_counter()
    if ops:  # batch_isend_irecv refuses an empty list
        for work in dist.batch_isend_irecv(ops):
            work.wait()
    _counted("ppermute", x.nbytes * sum(s == me for s, _ in perm), t0)
    return out


def _native_gather(x, group):
    """[G, *x.shape]: every member's x in group-rank order."""
    n = dist.get_world_size(group)
    flat = x.contiguous().reshape(-1)
    out = flat.new_empty(n * flat.numel())
    t0 = time.perf_counter()
    _ALL_GATHER(out, flat, group=group)
    _counted("all_gather", flat.nbytes, t0)
    return out.view((n,) + tuple(x.shape))


def _native_gather_transpose(g, group):
    """[G, *shape] cotangent → this rank's row of its sum."""
    flat = g.contiguous().reshape(-1)
    out = flat.new_empty(flat.numel() // dist.get_world_size(group))
    t0 = time.perf_counter()
    _REDUCE_SCATTER(out, flat, group=group)
    _counted("reduce_scatter", flat.nbytes, t0)
    return out.view(g.shape[1:])


def _permute(x, perm, group):
    return (_staged_permute if _staged(x, group) else _native_permute)(x, perm, group)


def _gather(x, group):
    return (_staged_gather if _staged(x, group) else _native_gather)(x, group)


def _gather_transpose(g, group):
    return (_staged_gather_transpose if _staged(g, group) else _native_gather_transpose)(g, group)


class _Psum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.group), None


class _Pmax(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return _all_reduce(x, group, dist.ReduceOp.MAX)

    @staticmethod
    def backward(ctx, g):
        raise NotImplementedError("Differentiation rule for 'pmax' not implemented")


class _Ppermute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, perm, group):
        ctx.perm, ctx.group = perm, group
        return _permute(x, perm, group)

    @staticmethod
    def backward(ctx, g):
        return _permute(g, [(d, s) for s, d in ctx.perm], ctx.group), None, None


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, tiled):
        ctx.group, ctx.tiled = group, tiled
        out = _gather(x, group)
        return out.flatten(0, 1) if tiled else out

    @staticmethod
    def backward(ctx, g):
        n = dist.get_world_size(ctx.group)
        if ctx.tiled:
            g = g.unflatten(0, (n, g.shape[0] // n))
        return _gather_transpose(g, ctx.group), None, None


def psum(x: torch.Tensor, group) -> torch.Tensor:
    """Sum of ``x`` over the group, on every member."""
    return _Psum.apply(x, group)


def pmax(x: torch.Tensor, group) -> torch.Tensor:
    """Elementwise max of ``x`` over the group; its backward raises."""
    return _Pmax.apply(x, group)


def ppermute(x: torch.Tensor, perm: Sequence[Tuple[int, int]], group) -> torch.Tensor:
    """``x`` of group rank s arrives at group rank d for each (s, d) of
    ``perm``; a rank that no pair sends to gets zeros (``jax.lax.ppermute``)."""
    return _Ppermute.apply(x, tuple(perm), group)


def all_gather(x: torch.Tensor, group, tiled: bool = False) -> torch.Tensor:
    """Every member's ``x`` in group-rank order: stacked on a new leading
    axis, or with ``tiled`` concatenated along axis 0."""
    return _AllGather.apply(x, group, tiled)
