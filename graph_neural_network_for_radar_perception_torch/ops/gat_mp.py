"""One GATv2 round on the card: the attention and the aggregate of
``models/gat.GATv2Conv`` in the CUDA kernels of ``csrc/gat_mp.cu``.

For node projections xl = W_l·x, xr = W_r·x [N, H·C] (computed outside, by
the conv's ``Linear``s), edge features ef [E, De] and the conv's W_e [H·C,
De], b_e, att [1, H, C] and bias [H·C], the round is, for every edge
(j → i) that takes part and every head,

    s = LeakyReLU(xl_j + xr_i + W_e·ef + b_e, slope)
    α = softmax over i's edges of att_h·s_h;   out_i = bias + Σ_j α·xl_j

the function of the plain ``GATv2Conv._attend``, which stays the CPU
version (the JAX package's GAT path reaches no Pallas kernel: this kernel
pair replaces none).  ``gat_round`` is differentiable through
``_GATRound``: the forward (``gat_mp_forward``) and the backward
(``gat_mp_backward``: the gradients of xl, xr, ef, W_e, b_e, att and bias)
never write an [E, H·C] tensor.

An edge takes part when its mask is set and both its ends lie in [0, N):
``gat_layout`` gives the others the sentinel N at both ends and sorts the
edges by receiver and by sender (``ops/fused_mp.fused_layout``), once a
step for all the rounds, since the edges do not change between them.
Edges that take no part weigh 0, as in the plain path's masked softmax.
The kernels sum in a fixed order, so two launches give the same bits.

A batch of graphs is a leading graph axis (xl [B, N, H·C], ef [B, E,
De]); a single graph is a batch of one.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional

import torch

from ._build import load
from .fused_mp import FusedLayout, batch_layout, fused_layout


class GATLayout(NamedTuple):
    """The edges of a graph's (or a batch's) GATv2 rounds as the kernels
    walk them, made once for all the rounds."""

    senders: torch.Tensor    # [E] int32, N where the edge takes no part
    receivers: torch.Tensor  # [E] int32, likewise
    order: FusedLayout       # their receiver and sender orders


def gat_layout(senders: torch.Tensor, receivers: torch.Tensor,
               edge_mask: Optional[torch.Tensor], n: int) -> GATLayout:
    """The ``GATLayout`` of edges (senders, receivers [E] or [B, E]) over n
    nodes: an edge outside ``edge_mask`` or with an end outside [0, n) gets
    the sentinel n at both ends.  On the card nothing is read to the host."""
    keep = (senders >= 0) & (senders < n) & (receivers >= 0) & (receivers < n)
    if edge_mask is not None:
        keep = keep & edge_mask
    sentinel = torch.full_like(senders, n)
    s = torch.where(keep, senders, sentinel).int()
    r = torch.where(keep, receivers, sentinel).int()
    return GATLayout(s, r, fused_layout(s, r, n))


class GATPlan(NamedTuple):
    """How the kernels run at given widths over B graphs on a device, as
    their library plans it."""

    blocks: int  # tile blocks a graph (the SMs over B)
    smem: int    # bytes of shared memory a tile block


def _entry(name: str, argtypes, restype=ctypes.c_int):
    fn = getattr(load("gat_mp"), name)
    fn.argtypes, fn.restype = argtypes, restype
    return fn


@functools.lru_cache(maxsize=None)
def _forward_kernel():
    p, i = ctypes.c_void_p, ctypes.c_int
    return _entry("gat_mp_forward", [p] * 11 + [ctypes.c_float] + [p] * 3 + [i] * 6 + [p])


@functools.lru_cache(maxsize=None)
def _backward_kernel():
    p, i = ctypes.c_void_p, ctypes.c_int
    return _entry("gat_mp_backward",
                  [p] * 16 + [ctypes.c_float] + [p] * 5 + [i] * 6 + [p])


@functools.lru_cache(maxsize=None)
def plan(n, e, de, hc, heads, graphs, device) -> GATPlan:
    """``gat_mp_plan`` at these widths on ``device`` (asked once)."""
    fn = _entry("gat_mp_plan", [ctypes.c_int] * 6 + [ctypes.POINTER(ctypes.c_int)])
    out = (ctypes.c_int * 2)()
    with torch.cuda.device(device):
        rc = fn(n, e, de, hc, heads, graphs, out)
    if rc != 0:
        raise ValueError(f"gat_round: widths N={n} E={e} De={de} H*C={hc} H={heads} "
                         f"B={graphs} (cudaError_t {rc}): the kernels take De a multiple "
                         "of 4 up to 64, H*C a multiple of 32 up to 512, C/4 a power of "
                         "two up to 32")
    return GATPlan(*out)


@functools.lru_cache(maxsize=None)
def _scratch_floats(n, e, de, hc, heads, graphs, device) -> int:
    fn = _entry("gat_mp_backward_scratch", [ctypes.c_int] * 6, ctypes.c_longlong)
    with torch.cuda.device(device):
        floats = fn(n, e, de, hc, heads, graphs)
    if floats < 0:
        raise ValueError(f"gat_mp_backward_scratch: cudaError_t {-floats}")
    return floats


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """t contiguous and 16-byte aligned (a copy if it is not)."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _stream():
    return torch.cuda.current_stream().cuda_stream


def _forward(xl, xr, ef, w_e, b_e, att, bias, layout, slope):
    """out [B, N, H·C] and the softmax statistics [B, N, 2, H] (each
    receiver's largest logit and sum of exponentials, by head)."""
    b, n, hc = xl.shape
    e, de = ef.shape[1:]
    heads = att.numel() // att.shape[-1]
    plan(n, e, de, hc, heads, b, xl.device)
    emp = functools.partial(torch.empty, dtype=torch.float32, device=xl.device)
    out, stats, lg = emp(b, n, hc), emp(b, n, 2, heads), emp(b, e, heads)
    order = layout.order
    with torch.cuda.device(xl.device):
        rc = _forward_kernel()(
            xl.data_ptr(), xr.data_ptr(), ef.data_ptr(), layout.senders.data_ptr(),
            layout.receivers.data_ptr(), order.recv_order.data_ptr(),
            order.recv_off.data_ptr(), w_e.data_ptr(), b_e.data_ptr(), att.data_ptr(),
            bias.data_ptr(), float(slope), out.data_ptr(), stats.data_ptr(),
            lg.data_ptr(), n, e, de, hc, heads, b, _stream())
    if rc != 0:
        raise RuntimeError(f"gat_mp_forward failed: cudaError_t {rc}")
    gat_round.launches += 1
    return out, stats


def _backward(xl, xr, ef, w_e, b_e, att, bias, out, stats, g, layout, slope):
    """(dxl, dxr, def, dW_e, db_e, datt, dbias) for the cotangent g of out."""
    b, n, hc = xl.shape
    e, de = ef.shape[1:]
    heads = att.numel() // att.shape[-1]
    emp = functools.partial(torch.empty, dtype=torch.float32, device=xl.device)
    scratch = emp(_scratch_floats(n, e, de, hc, heads, b, xl.device))
    gef, dxl, dxr, dw = emp(b, e, de), emp(b, n, hc), emp(b, n, hc), emp(hc * de + 3 * hc)
    order = layout.order
    with torch.cuda.device(xl.device):
        rc = _backward_kernel()(
            xl.data_ptr(), xr.data_ptr(), ef.data_ptr(), layout.senders.data_ptr(),
            layout.receivers.data_ptr(), order.recv_order.data_ptr(),
            order.recv_off.data_ptr(), order.send_order.data_ptr(),
            order.send_off.data_ptr(), w_e.data_ptr(), b_e.data_ptr(), att.data_ptr(),
            bias.data_ptr(), out.data_ptr(), g.data_ptr(), stats.data_ptr(), float(slope),
            scratch.data_ptr(), gef.data_ptr(), dxl.data_ptr(), dxr.data_ptr(),
            dw.data_ptr(), n, e, de, hc, heads, b, _stream())
    if rc != 0:
        raise RuntimeError(f"gat_mp_backward failed: cudaError_t {rc}")
    gat_round.backward_launches += 1
    k = hc * de
    return (dxl, dxr, gef, dw[:k].view(hc, de), dw[k:k + hc], dw[k + hc:k + 2 * hc],
            dw[k + 2 * hc:])


class _GATRound(torch.autograd.Function):
    """Autograd node of one round over a batch (xl [B, N, H·C]): the
    forward kernel, then the backward kernels, which recompute the edge
    terms from the saved inputs, the output and the softmax statistics."""

    @staticmethod
    def forward(ctx, xl, xr, ef, w_e, b_e, att, bias, layout, slope):
        out, stats = _forward(xl, xr, ef, w_e, b_e, att, bias, layout, slope)
        ctx.layout, ctx.slope = layout, slope
        ctx.save_for_backward(xl, xr, ef, w_e, b_e, att, bias, out, stats)
        return out

    @staticmethod
    def backward(ctx, g):
        xl, xr, ef, w_e, b_e, att, bias, out, stats = ctx.saved_tensors
        # upd_mlp concatenates [x, out]: the cotangent may be a strided view.
        dxl, dxr, gef, dw_e, db_e, datt, dbias = _backward(
            xl, xr, ef, w_e, b_e, att, bias, out, stats, _aligned(g), ctx.layout, ctx.slope)
        return dxl, dxr, gef, dw_e, db_e, datt.view(att.shape), dbias, None, None


def _check(xl, xr, ef, w_e, b_e, att, bias):
    """Shapes, types and devices of a batch's round (xl [B, N, H·C])."""
    b, n, hc = xl.shape
    de = w_e.shape[1]
    want = {"xr": (xr, (b, n, hc)), "ef": (ef, (b, ef.shape[1], de)),
            "w_e": (w_e, (hc, de)), "b_e": (b_e, (hc,)), "bias": (bias, (hc,))}
    for name, (t, shape) in want.items():
        if tuple(t.shape) != shape:
            raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {shape}")
    if att.numel() != hc:
        raise ValueError(f"att: {att.numel()} elements, expected {hc}")
    for name, t in dict(xl=xl, xr=xr, ef=ef, w_e=w_e, b_e=b_e, att=att, bias=bias).items():
        if t.device != xl.device or t.dtype != torch.float32:
            raise ValueError(f"{name}: {t.dtype} on {t.device}, expected float32 on "
                             f"{xl.device}")


def gat_round(xl, xr, ef, w_e, b_e, att, bias, layout: GATLayout, slope=0.2):
    """out = bias + Σ_j α·xl_j per head over each receiver's edges
    (module docstring), differentiable; the kernels on a CUDA tensor, a
    ``ValueError`` on any other (the plain version is
    ``models/gat.GATv2Conv._attend``).

    xl, xr: [N, H·C] or [B, N, H·C] f32; ef: [E, De] ([B, E, De]); w_e [H·C,
    De], b_e and bias [H·C], att [1, H, C] (head h's at h·C); ``layout``:
    ``gat_layout`` of the edges.  Returns out [N, H·C] ([B, N, H·C]).
    ``gat_round.launches`` and ``gat_round.backward_launches`` count the C
    calls."""
    if xl.device.type != "cuda":
        raise ValueError(f"gat_round: no kernel for device {xl.device}; the plain "
                         "version is GATv2Conv._attend")
    if xl.ndim == 2:
        s, r, order = layout
        batched = GATLayout(s[None], r[None], batch_layout(order))
        return gat_round(xl[None], xr[None], ef[None], w_e, b_e, att, bias, batched,
                         slope)[0]
    _check(xl, xr, ef, w_e, b_e, att, bias)
    return _GATRound.apply(_aligned(xl), _aligned(xr), _aligned(ef), _aligned(w_e),
                           _aligned(b_e), _aligned(att), _aligned(bias), layout,
                           float(slope))


gat_round.launches = 0
gat_round.backward_launches = 0
