"""Collectives over an explicit process group, differentiable as JAX's are.

The counterparts of shard_map's ``psum``, ``pmax``, ``ppermute`` and
``all_gather`` (the JAX package's ``models/blocks.py`` and
``parallel/halo.py`` call those inside a mesh axis; here a mesh axis is a
``torch.distributed`` process group, ``parallel/mesh.py``).  Each is a
``torch.autograd.Function`` whose backward is JAX's transpose:

* ``psum``: the sum all-reduce of the cotangent;
* ``ppermute``: the reverse permutation of the cotangent;
* ``all_gather(tiled=True)``: this rank's slice of the summed cotangent
  (a reduce-scatter);
* ``pmax``: forward only.  JAX has no differentiation rule for ``pmax``
  (``NotImplementedError: Differentiation rule for 'pmax' not
  implemented``), so its backward raises the same.

Every op is one all-reduce.  ``ppermute`` and ``all_gather`` reduce a
zero-filled ``[G, ...]`` buffer in which each rank writes its own rows:
adding zeros is exact, so the result is the permutation or the gather bit
for bit.  That one design runs under gloo with CPU tensors, under gloo
with CUDA tensors (gloo takes CUDA tensors for ``all_reduce`` and
``broadcast`` only) and under NCCL, which refuses two ranks on one card,
so the CPU tests and a one-card run share the route a multi-card run
takes.  It moves G times the bytes of a native send/recv or all-gather
(``ROADMAP.md``).

Every rank of the group must call the same collectives in the same order,
forward and backward.  Every all-reduce of ``parallel/`` goes through
:func:`all_reduce_`, which counts its calls and the host seconds spent in
them in ``STATS`` (under gloo with CUDA tensors that includes the wait for
the card's earlier work, since the tensor is staged through the host).
"""

from __future__ import annotations

import time
from typing import Sequence, Tuple

import torch
import torch.distributed as dist

STATS = {"calls": 0, "seconds": 0.0}


def all_reduce_(x: torch.Tensor, group=None, op=dist.ReduceOp.SUM) -> torch.Tensor:
    """In-place all-reduce of ``x`` over the group (None: the world),
    counted in ``STATS``; returns ``x``."""
    t0 = time.perf_counter()
    dist.all_reduce(x, op=op, group=group)
    STATS["calls"] += 1
    STATS["seconds"] += time.perf_counter() - t0
    return x


def _all_reduce(x: torch.Tensor, group, op=dist.ReduceOp.SUM) -> torch.Tensor:
    return all_reduce_(x.contiguous().clone(), group, op)


def _scatter_rows(x: torch.Tensor, rows: Sequence[int], group) -> torch.Tensor:
    """A zero [G, *x.shape] buffer with x at each of ``rows``, summed over
    the group: row i holds what the ranks that wrote row i sent."""
    buf = x.new_zeros((dist.get_world_size(group),) + tuple(x.shape))
    for r in rows:
        buf[r] = x
    return all_reduce_(buf, group)


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


def _permute(x, perm, group):
    me = dist.get_rank(group)
    return _scatter_rows(x, [d for s, d in perm if s == me], group)[me]


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
        me = dist.get_rank(group)
        out = _scatter_rows(x, [me], group)
        return out.flatten(0, 1) if tiled else out

    @staticmethod
    def backward(ctx, g):
        g = _all_reduce(g, ctx.group)
        n = dist.get_world_size(ctx.group)
        if ctx.tiled:
            g = g.unflatten(0, (n, g.shape[0] // n))
        return g[dist.get_rank(ctx.group)], None, None


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
