"""CSR (destination-sorted) fused message-passing round.

The same message as ``ops.fused_mp``, enumerated over destination-sorted
edges (the JAX package's ``ops/pallas/csr_mp.py``).  For every edge p with
destination dst[p] and source src[p],

    m_p   = act(cnorm(W2 · act(cnorm(W1 · [x_dst ‖ x_src ‖ ef_p] + b1)) + b2))
    agg_n = Σ_{p: dst(p)=n} m_p

The model walks the row-major edge list *reversed*: position p is the edge
(receivers[p] → senders[p]), so dst = senders is already sorted and the raw
edge features are those of the reversed edge (``reverse_edge_features``).

Window semantics are the TPU kernel's (``_forward_impl``): E is padded to a
multiple of ``edge_tile`` with sentinel N; every tile gets a node window
of ``window`` rows starting at a floor-8-aligned base (``_layout``) and, with
``src_window`` > 0, a source window (``_src_layout``).  ``_effective_indices``
maps them onto sentinels:

* an edge whose destination lies outside its tile's window is dropped, and
  contributes nothing in the backward (dst := N);
* an edge whose source lies outside its tile's source window gathers a zero
  x_src, but its message still lands (src := N); it adds nothing to dx's
  source side.

The contract (``csr_contract_ok`` on the host, ``window_span_violations``
and ``src_window_violations`` on the device) says when nothing is dropped.

``fused_message_pass_csr`` is differentiable through
``_FusedMessagePassCSR``:

* on a CUDA tensor the hand-written kernels ``csr_mp_forward`` and
  ``csr_mp_backward`` of ``csrc/csr_mp.cu`` (ports of
  ``csr_mp.py::_fwd_kernel`` and ``_bwd_kernel``);
* on a CPU tensor the plain versions ``fused_message_pass_csr_reference``
  and ``fused_message_pass_csr_backward_reference``.

The kernels need dst non-decreasing over the edges they keep (as
``csr_mp.py:589-590`` states for the TPU kernel's callers); every producer
in the repo meets it (``pad_frame``'s row-major list, ``spatial_sort_frame``,
``merge_frames``).

A batch of graphs is a leading graph axis on x, ef, src and dst, as in
``ops.fused_mp``: one C call of the kernels for all the graphs (graph b's
outputs those of a call on graph b alone, the weight gradients summed in
graph order); the layout's index preparation runs on every graph at once
(sorts and scans along the last axis); the plain versions loop over the
graphs.

``bf16=True`` is the TPU kernel's bf16 mode, which rounds at other points
than the fused round's: x and W1r/W1s are rounded *before* the node
products (``_fwd_kernel``: ``xw = x[...].astype(dt)``), then ef, W1e, the
layer-1 activations, W2 and each message, as in ``ops.fused_mp``.  The
forward runs ``csr_mp_forward_bf16`` or the plain bf16 version; the
backward stays the f32 one.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional

import numpy as np
import torch

from ..core.graph import device_constant
from ..utils.profiling import TRACER
from ._build import load
from .fused_mp import (
    BackwardPlan,
    ForwardPlan,
    _bf16,
    _check,
    _check_kernel_widths,
    _cnorm_act_bwd,
    _cnorm_stats,
    _plan,
    _scalar,
    batch_layout,
    fused_message_pass_reference,
    message_pass_bf16_plain,
    per_graph,
    with_graph_axis,
)

# Sign of each raw edge feature under edge reversal (s→r) ↦ (r→s):
# [dx, dy, dl, dvx, dvy, dvl, dt] — see data/features.py compute_edge_features.
EDGE_FEATURE_REVERSAL_SIGNS = (-1.0, -1.0, 1.0, -1.0, -1.0, 1.0, -1.0)


def reverse_edge_features(ef: torch.Tensor) -> torch.Tensor:
    """Raw features of every reversed directed edge, elementwise.

    ef: [..., E, 7] raw edge features in row-major order; returns the raw
    features of (receiver → sender) at the same positions.  Padded edges
    (zero rows) stay zero."""
    if ef.shape[-1] != len(EDGE_FEATURE_REVERSAL_SIGNS):
        raise ValueError(
            f"edge feature dim {ef.shape[-1]} != 7; the reversal sign "
            "pattern only applies to the standard feature layout"
        )
    return ef * device_constant(EDGE_FEATURE_REVERSAL_SIGNS, ef.dtype, ef.device)


# ------------------------------------------------------------ host checks
def window_span_ok(dst, edge_mask, edge_tile: int, window: int) -> bool:
    """True iff every edge_tile-chunk of the (sorted) destination list
    spans < window-8 node ids — the contract the kernel needs."""
    dst = np.asarray(dst)
    mask = np.asarray(edge_mask)
    e = dst.shape[0]
    ok = True
    for c0 in range(0, e, edge_tile):
        chunk = dst[c0 : c0 + edge_tile][mask[c0 : c0 + edge_tile]]
        if chunk.size:
            ok &= int(chunk.max()) - int(chunk.min()) < window - 8
    return ok


def csr_contract_ok(
    senders, receivers, edge_mask, edge_tile: int = 512, window: int = 256,
    src_window: int = 0,
) -> tuple:
    """Host-side validation of all preconditions of the CSR path:

    1. window span: every edge_tile chunk of the sorted destination list
       (= senders, via the reversed enumeration) spans < window-8;
    2. reversal closure: the valid directed edge set equals its own
       reverse — the kernel walks position p as the edge
       (receivers[p] → senders[p]); edge-capacity truncation (pad_frame)
       can drop one direction of a pair;
    3. (src_window > 0) source window span: every edge_tile chunk's valid
       sources (= receivers) span < src_window-8 node ids.

    Returns (ok: bool, reason: str)."""
    s = np.asarray(senders)[np.asarray(edge_mask)]
    r = np.asarray(receivers)[np.asarray(edge_mask)]
    if not window_span_ok(senders, edge_mask, edge_tile, window):
        return False, (
            f"destination window span ≥ {window - 8} within an "
            f"{edge_tile}-edge tile"
        )
    if src_window and not window_span_ok(
        receivers, edge_mask, edge_tile, src_window
    ):
        return False, (
            f"source window span ≥ {src_window - 8} within an "
            f"{edge_tile}-edge tile (spatially sort the frame or "
            "widen csr_src_window)"
        )
    n = int(max(s.max(initial=0), r.max(initial=0))) + 1
    fwd = np.sort(s.astype(np.int64) * n + r)
    rev = np.sort(r.astype(np.int64) * n + s)
    if fwd.shape != rev.shape or not np.array_equal(fwd, rev):
        return False, "edge set not closed under reversal (truncated pair?)"
    return True, ""


# ---------------------------------------------------------- device layout
def _floor8(v):
    return torch.div(v, 8, rounding_mode="floor") * 8


def _pad_edges(idx: torch.Tensor, n: int, edge_tile: int) -> torch.Tensor:
    """idx [..., E] padded with sentinel n to a multiple of edge_tile."""
    rem = (-idx.shape[-1]) % edge_tile
    if not rem:
        return idx
    return torch.cat([idx, idx.new_full(idx.shape[:-1] + (rem,), n)], dim=-1)


def _layout(dst, n: int, edge_tile: int, window: int):
    """Per-chunk window bases + window-local destination indices.

    dst: [..., E] int sorted destinations with sentinel n for padded edges
    (E a multiple of edge_tile; a leading graph axis per graph).  Returns
    (bases [..., C, 1] int32, dst_loc [..., E] int32 with ``window`` as the
    no-match sentinel).  The clip bound is floor-8-aligned, as the TPU
    kernel's ``pl.multiple_of(base, 8)`` needs: with (n - window) % 8 != 0
    the top few node ids fall outside the highest window and are flagged by
    the sentinel."""
    firsts = dst[..., ::edge_tile]
    bases = _floor8(firsts).clamp(0, max(((n - window) // 8) * 8, 0))
    loc = dst - torch.repeat_interleave(bases, edge_tile, dim=-1)
    loc = torch.where((dst < n) & (loc >= 0) & (loc < window), loc,
                      torch.full_like(loc, window))
    return bases.int()[..., None], loc.int()


def _src_layout(src, n: int, edge_tile: int, ws: int):
    """Per-chunk source-window bases + window-local source indices.

    src: [..., E] int sources with sentinel n for padded edges (E a
    multiple of edge_tile), unsorted within a tile.  Returns (bases [...,
    C, 1] int32, src_loc [..., E] int32 with ``ws`` as the no-match
    sentinel).  With ws == n every base clips to 0: the unwindowed
    gather."""
    chunks = src.reshape(src.shape[:-1] + (-1, edge_tile))
    mins = torch.where(chunks < n, chunks, torch.full_like(chunks, n)).amin(-1)
    bases = _floor8(mins).clamp(0, max(((n - ws) // 8) * 8, 0))
    loc = chunks - bases[..., None]
    loc = torch.where((chunks < n) & (loc >= 0) & (loc < ws), loc,
                      torch.full_like(loc, ws))
    return bases.int()[..., None], loc.reshape(src.shape).int()


def window_span_violations(dst, n: int, edge_tile: int, window: int):
    """Count (0-d tensor, on dst's device, no host sync; [B] for a batch's
    dst [B, E]) of valid edges whose destination falls outside its tile's
    node window — the edges ``_layout`` drops.  Callers poison the output
    with NaN when it is nonzero, so that the train step's NaN skip fires."""
    dst = _pad_edges(dst, n, edge_tile)
    _, loc = _layout(dst, n, edge_tile, window)
    return ((dst < n) & (loc == window)).sum(-1)


def src_window_violations(src, n: int, edge_tile: int, src_window: int):
    """Count (0-d tensor, no host sync; [B] for a batch) of valid edges
    whose source falls outside its tile's source window — the edges
    ``_src_layout`` cuts off.  Zero when src_window is 0 or ≥ n
    (unwindowed gather)."""
    src = _pad_edges(src, n, edge_tile)
    src = torch.where(src < n, src, torch.full_like(src, n))
    ws = min(src_window, n) if src_window else n
    _, loc = _src_layout(src, n, edge_tile, ws)
    return ((src < n) & (loc == ws)).sum(-1)


def order_violations(dst, n: int):
    """Count (0-d tensor, no host sync; [B] for a batch) of valid
    destinations (< n) that break the kernels' precondition: dst
    non-decreasing over valid edges.  The TPU kernel needs no order; the
    port's segmented sums do."""
    d = torch.where((dst >= 0) & (dst < n), dst, torch.full_like(dst, n))
    return ((d < n) & (d != _suffix_min(d))).sum(-1)


def _suffix_min(idx: torch.Tensor) -> torch.Tensor:
    """The suffix minimum along the last axis."""
    return idx.flip(-1).cummin(-1).values.flip(-1)


def _effective_indices(src, dst, n: int, edge_tile: int, window: int,
                       src_window: int):
    """(src_eff, dst_eff) [..., E] int32: the TPU kernel's window semantics
    as sentinels.  dst_eff = N where the destination falls outside its
    tile's window (message dropped); src_eff = N where the source falls
    outside its tile's source window (zero x_src, message kept)."""
    e = src.shape[-1]
    # The clipping of _forward_impl.
    window = min(window, n)
    ws = min(src_window, n) if src_window else n
    src_p = _pad_edges(src.long(), n, edge_tile)
    dst_p = _pad_edges(dst.long(), n, edge_tile)
    src_p = torch.where(src_p < n, src_p, torch.full_like(src_p, n))
    _, dst_loc = _layout(dst_p, n, edge_tile, window)
    _, src_loc = _src_layout(src_p, n, edge_tile, ws)
    dst_eff = torch.where(dst_loc == window, torch.full_like(dst_p, n), dst_p)
    src_eff = torch.where(src_loc == ws, torch.full_like(src_p, n), src_p)
    return src_eff[..., :e].int().contiguous(), dst_eff[..., :e].int().contiguous()


def _node_ids(key: torch.Tensor, n: int) -> torch.Tensor:
    """0 … n (key's type), with key's leading axes."""
    nodes = torch.arange(n + 1, dtype=key.dtype, device=key.device)
    return nodes.expand(key.shape[:-1] + (n + 1,)).contiguous()


def _segment_offsets(idx: torch.Tensor, n: int) -> torch.Tensor:
    """off [..., n+1] int32 with the positions of node v's segment in
    [off[v], off[v+1]), from a key that is non-decreasing everywhere: the
    suffix minimum of idx (sentinels N inside the run take the next kept
    destination and are skipped by the kernel; the tail of sentinels
    forms the virtual segment N).  Exact when idx is non-decreasing over
    its entries < N."""
    key = _suffix_min(idx).contiguous()
    return torch.searchsorted(key, _node_ids(key, n), out_int32=True)


class CSRLayout(NamedTuple):
    """The index preparation of one graph's CSR rounds, shared by all of
    them (it depends on the edges and the tiling only): the effective
    indices and, on the card, the destination segments and the edges in
    source order with their segments.  A batch's has a leading graph axis
    on each tensor."""

    src: torch.Tensor                        # [E] int32, effective sources
    dst: torch.Tensor                        # [E] int32, effective destinations
    edge_tile: int                           # the tile of the window semantics
    off: Optional[torch.Tensor] = None       # [N+1] destination segments
    perm: Optional[torch.Tensor] = None      # [E] edges in source order (stable)
    off_src: Optional[torch.Tensor] = None   # [N+1] source segments of perm


def csr_layout(src, dst, n: int, edge_tile: int = 512, window: int = 256,
               src_window: int = 0) -> CSRLayout:
    """The ``CSRLayout`` of a graph's (src, dst) at this tiling, or of
    every graph of a batch ([B, E]).  On the card everything stays on the
    device (no host sync)."""
    src_e, dst_e = _effective_indices(src, dst, n, edge_tile, window,
                                      src_window)
    if src_e.device.type == "cpu":
        return CSRLayout(src_e, dst_e, edge_tile)
    # The source side of the backward: stable, so that each node's
    # cotangent sums in edge order.
    perm = torch.argsort(src_e, dim=-1, stable=True)
    off_src = torch.searchsorted(torch.gather(src_e, -1, perm),
                                 _node_ids(src_e, n), out_int32=True)
    return CSRLayout(src_e, dst_e, edge_tile, _segment_offsets(dst_e, n),
                     perm.int(), off_src)


# ---------------------------------------------------------- plain versions
def _forward_plain(x, ef, src_e, dst_e, w1, b1, w2, b2, g1, be1, g2, be2,
                   slope, bf16):
    """The round over effective indices (receiver = dst, sender = src).
    ``bf16``: x, W1r and W1s rounded before the node products, then the
    operands of ``message_pass_bf16_plain``.  A batch runs each graph's in
    turn."""
    if x.ndim == 3:
        return per_graph(lambda xb, eb, sb, db: _forward_plain(
            xb, eb, sb, db, w1, b1, w2, b2, g1, be1, g2, be2, slope, bf16),
            x, ef, src_e, dst_e)
    if not bf16:
        return fused_message_pass_reference(
            x, ef, src_e, dst_e, w1, b1, w2, b2, g1, be1, g2, be2, slope)
    d = x.shape[1]
    xr = _bf16(x)
    return message_pass_bf16_plain(
        xr @ _bf16(w1[:d]), xr @ _bf16(w1[d:2 * d]), ef, src_e, dst_e,
        w1[2 * d:], b1, w2, b2, g1, be1, g2, be2, slope)


def fused_message_pass_csr_reference(
    x, ef, src, dst, w1, b1, w2, b2, g1, be1, g2, be2, slope=0.01,
    edge_tile=512, window=256, src_window=0, bf16=False,
):
    """Plain PyTorch version of what ``_forward_impl`` returns, for any
    input (contract-violating ones included): the plain round over the
    effective indices, with the TPU kernel's bf16 operands if ``bf16``."""
    src_e, dst_e = _effective_indices(src, dst, x.shape[-2], edge_tile,
                                      window, src_window)
    return _forward_plain(x, ef, src_e, dst_e, w1, b1, w2, b2, g1, be1, g2,
                          be2, slope, bf16)


def _backward_plain(x, ef, src_e, dst_e, w1, b1, w2, b2, g1, be1, g2, be2,
                    g_out, slope, edge_tile):
    """The chain rule of ``_bwd_kernel`` over effective indices, with the
    TPU kernel's per-edge products: x_dst and x_src are gathered per edge
    (zero for a sentinel), dW1 = [x_dst ‖ x_src ‖ ef]ᵀ·g_pre1, and dx
    scatters g_pre1·W1rᵀ at dst and g_pre1·W1sᵀ at src.  A batch runs each
    graph's in turn: dx and gef per graph, the rest summed in graph
    order."""
    if x.ndim == 3:
        return per_graph(lambda xb, eb, sb, db, gb: _backward_plain(
            xb, eb, sb, db, w1, b1, w2, b2, g1, be1, g2, be2, gb, slope,
            edge_tile), x, ef, src_e, dst_e, g_out, stacked=2)
    n, d = x.shape
    d2 = w2.shape[1]
    di, si = dst_e.long(), src_e.long()
    xz = torch.cat([x, x.new_zeros(1, d)])  # row n: the zero row
    xd, xs = xz[di], xz[si]
    w1r, w1s, w1e = w1[:d], w1[d : 2 * d], w1[2 * d :]
    g1, be1, g2, be2 = (torch.as_tensor(v, dtype=x.dtype, device=x.device)
                        .reshape(()) for v in (g1, be1, g2, be2))

    pre1 = xd @ w1r + xs @ w1s + ef @ w1e + b1
    u1, sd1, xhat1 = _cnorm_stats(pre1)
    h1 = g1 * xhat1 + be1
    a1 = torch.where(h1 >= 0, h1, slope * h1)
    u2, sd2, xhat2 = _cnorm_stats(a1 @ w2 + b2)
    h2 = g2 * xhat2 + be2

    gm = torch.cat([g_out, g_out.new_zeros(1, d2)])[di]
    g_pre2, dg2, dbe2 = _cnorm_act_bwd(gm, h2, xhat2, u2, sd2, g2, slope)
    g_pre1, dg1, dbe1 = _cnorm_act_bwd(g_pre2 @ w2.t(), h1, xhat1, u1, sd1,
                                       g1, slope)
    dx = (x.new_zeros(n + 1, d).index_add_(0, di, g_pre1 @ w1r.t())
          .index_add_(0, si, g_pre1 @ w1s.t())[:n])

    def tiled(a, b):
        """aᵀ·b as the TPU kernel sums it: per edge_tile partials, then
        their sum (``_backward_impl``)."""
        pad = (-a.shape[0]) % edge_tile
        a = torch.cat([a, a.new_zeros(pad, a.shape[1])])
        b = torch.cat([b, b.new_zeros(pad, b.shape[1])])
        a = a.reshape(-1, edge_tile, a.shape[1])
        return torch.bmm(a.transpose(1, 2), b.reshape(a.shape[0], edge_tile, -1)).sum(0)

    dw1 = torch.cat([tiled(xd, g_pre1), tiled(xs, g_pre1), tiled(ef, g_pre1)])
    return (dx, g_pre1 @ w1e.t(), dw1, g_pre1.sum(0), tiled(a1, g_pre2),
            g_pre2.sum(0), dg1, dbe1, dg2, dbe2)


def fused_message_pass_csr_backward_reference(
    x, ef, src, dst, w1, b1, w2, b2, g1, be1, g2, be2, g_out, slope=0.01,
    edge_tile=512, window=256, src_window=0,
):
    """Plain PyTorch version of what ``_backward_impl`` returns: (dx [N, D],
    gef [E, De], dW1 [2D+De, H] (all three blocks), db1 [H], dW2 [H, D2],
    db2 [D2], dγ1, dβ1, dγ2, dβ2) shaped like g1.  Recompute per edge, then
    the explicit chain rule over the effective indices."""
    src_e, dst_e = _effective_indices(src, dst, x.shape[-2], edge_tile,
                                      window, src_window)
    out = _backward_plain(x, ef, src_e, dst_e, w1, b1, w2, b2, g1, be1, g2,
                          be2, g_out, slope, edge_tile)
    shape = torch.as_tensor(g1).shape
    return out[:6] + tuple(v.reshape(shape) for v in out[6:])


# ------------------------------------------------------------- the kernels
@functools.lru_cache(maxsize=None)
def _kernel(bf16: bool = False):
    """The forward kernel's C entry point (its bf16 instantiation with
    ``bf16``), built and loaded on first use."""
    lib = load("csr_mp")
    fn = lib.csr_mp_forward_bf16 if bf16 else lib.csr_mp_forward
    fn.argtypes = [ctypes.c_void_p] * 11 + [ctypes.c_float] + [
        ctypes.c_void_p] * 2 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


@functools.lru_cache(maxsize=None)
def _bwd_kernel():
    """The backward kernel's C entry point (same library as the forward)."""
    fn = load("csr_mp").csr_mp_backward
    fn.argtypes = [ctypes.c_void_p] * 13 + [ctypes.c_float] + [
        ctypes.c_void_p] * 4 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


@functools.lru_cache(maxsize=None)
def _bwd_scratch():
    """``csr_mp_backward_scratch``: the backward's scratch size and plan."""
    fn = load("csr_mp").csr_mp_backward_scratch
    fn.argtypes = [ctypes.c_int] * 7 + [ctypes.POINTER(ctypes.c_int)]
    fn.restype = ctypes.c_longlong
    return fn


def _stream(x):
    return torch.cuda.current_stream(x.device).cuda_stream


def _forward_launch(x, ef, layout, w1, b1, w2, b2, scal, slope):
    """The arguments of one ``csr_mp_forward`` call over a batch (x [B, N,
    D], the layout's with the same graph axis), with its buffers allocated,
    and the outputs (msgs [B, E, D2], agg [B, N, D2]) that it writes."""
    b, n, d = x.shape
    e, de = ef.shape[1:]
    h, d2 = w1.shape[1], w2.shape[1]
    emp = functools.partial(torch.empty, dtype=torch.float32, device=x.device)
    agg = emp(b, n, d2)
    xab, msgs = emp(b, 2, n, h), emp(b, e, d2)  # scratch
    args = (x.data_ptr(), ef.data_ptr(), layout.src.data_ptr(),
            layout.dst.data_ptr(), layout.off.data_ptr(), w1.data_ptr(),
            b1.data_ptr(), w2.data_ptr(), b2.data_ptr(), scal.data_ptr(),
            xab.data_ptr(), float(slope), msgs.data_ptr(),
            agg.data_ptr(), n, e, d, de, h, d2, b, _stream(x))
    return args, (msgs, agg, xab)


def _forward_cuda(x, ef, layout, w1, b1, w2, b2, scal, slope, bf16=False):
    """One call of ``csr_mp_forward`` (``csr_mp_forward_bf16`` with
    ``bf16``) over a graph or a batch: the node products, the edge tiles'
    messages into a scratch by edge, then every agg row written once."""
    _check_kernel_widths("fused_message_pass_csr", x, ef, w1, w2)
    if x.ndim == 2:  # a graph: a batch of one
        return _forward_cuda(x[None], ef[None], batch_layout(layout), w1, b1,
                             w2, b2, scal, slope, bf16)[0]
    args, (_, agg, *_alive) = _forward_launch(x, ef, layout, w1, b1, w2, b2,
                                              scal, slope)
    with torch.cuda.device(x.device):
        rc = _kernel(bf16)(*args)
    if rc != 0:
        raise RuntimeError(f"csr_mp_forward{'_bf16' if bf16 else ''} failed: "
                           f"cudaError_t {rc}")
    if bf16:
        fused_message_pass_csr.launches_bf16 += 1
    else:
        fused_message_pass_csr.launches += 1
    return agg


def _forward_plan(n, e, d, de, h, d2, device) -> ForwardPlan:
    """How ``csr_mp_forward``'s edge kernel runs at these widths on
    ``device`` (``csr_mp_forward_plan``)."""
    return _plan("csr_mp", "csr_mp_forward_plan", device, n, e, d, de, h, d2)


def _backward_plan(n, e, d, de, h, d2, device, graphs=1) -> BackwardPlan:
    """How ``csr_mp_backward`` runs at these widths over ``graphs`` graphs
    on ``device``, as the C library plans it (``csr_mp_backward_scratch``)."""
    plan = (ctypes.c_int * 3)()
    with torch.cuda.device(device):
        floats = _bwd_scratch()(n, e, d, de, h, d2, graphs, plan)
    if floats < 0:
        raise ValueError(f"csr_mp_backward: De={de}, H={h}, D2={d2}: "
                         f"cudaError_t {-floats}")
    return BackwardPlan(floats, *plan)


def _backward_launch(x, ef, layout, w1, b1, w2, b2, scal, g_out, slope):
    """The arguments of one ``csr_mp_backward`` call, with its buffers
    allocated, and the function that returns its results.  The C call sums
    every partial itself (as ``_backward_impl`` sums its per-tile partials
    outside Pallas): the results are views of its outputs.  A batch (x [B,
    N, D], the layout's with the same graph axis) gives dx and gef per
    graph; a single graph's arrays give one graph's."""
    _check_kernel_widths("fused_message_pass_csr_backward", x, ef, w1, w2)
    single = x.ndim == 2
    if single:
        x, ef, g_out = with_graph_axis(x, ef, g_out)
        layout = batch_layout(layout)
    b, n, d = x.shape
    e, de = ef.shape[1:]
    h, d2 = w1.shape[1], w2.shape[1]
    emp = functools.partial(torch.empty, dtype=torch.float32, device=x.device)
    scratch = emp(_backward_plan(n, e, d, de, h, d2, x.device, b).floats)
    # Outputs, every element written: gef, dx per graph and
    # dw = dW1 ‖ db1 ‖ dW2 ‖ db2 ‖ dγ1 dβ1 dγ2 dβ2, summed over the graphs.
    gef, dx = emp(b, e, de), emp(b, n, d)
    k = (2 * d + de) * h
    dw = emp(k + h + h * d2 + d2 + 4)
    args = (
        x.data_ptr(), ef.data_ptr(), layout.src.data_ptr(),
        layout.dst.data_ptr(), layout.off.data_ptr(), layout.perm.data_ptr(),
        layout.off_src.data_ptr(), w1.data_ptr(), b1.data_ptr(),
        w2.data_ptr(), b2.data_ptr(), scal.data_ptr(), g_out.data_ptr(),
        float(slope), scratch.data_ptr(), gef.data_ptr(), dx.data_ptr(),
        dw.data_ptr(), n, e, d, de, h, d2, b, _stream(x),
    )

    def results(_alive=(x, ef, g_out, layout, scratch)):
        # _alive holds the tensors only the pointers above refer to.
        per = (dx[0], gef[0]) if single else (dx, gef)
        return per + (dw[:k].view(2 * d + de, h), dw[k : k + h],
                      dw[k + h : k + h + h * d2].view(h, d2),
                      dw[k + h + h * d2 : -4], *dw[-4:].unbind())

    return args, results


def _backward_cuda(x, ef, layout, w1, b1, w2, b2, scal, g_out, slope):
    """One launch of ``csr_mp_backward``; returns what
    ``fused_message_pass_csr_backward_reference`` returns."""
    args, results = _backward_launch(x, ef, layout, w1, b1, w2, b2, scal,
                                     g_out, slope)
    with torch.cuda.device(x.device):
        rc = _bwd_kernel()(*args)
    if rc != 0:
        raise RuntimeError(f"csr_mp_backward failed: cudaError_t {rc}")
    fused_message_pass_csr_backward.launches += 1
    return results()


# ------------------------------------------------------------ the wrappers
def _check_gout(g_out, x, w2):
    want = x.shape[:-1] + (w2.shape[1],)
    if tuple(g_out.shape) != want or g_out.dtype != torch.float32:
        raise ValueError(f"g_out: {tuple(g_out.shape)} {g_out.dtype}, "
                         f"expected {want} float32")
    if g_out.device != x.device or not g_out.is_contiguous():
        raise ValueError("g_out must be contiguous and on x's device")


def fused_message_pass_csr_backward(
    x, ef, src, dst, w1, b1, w2, b2, g1, be1, g2, be2, g_out, slope=0.01,
    edge_tile=512, window=256, src_window=0,
):
    """Cotangents of one CSR round for the cotangent ``g_out`` [N, D2] of
    agg (of a batch: a leading graph axis on x, ef, src, dst and g_out):
    what ``fused_message_pass_csr_backward_reference`` returns.  A CUDA
    input launches the kernels of one C call (or raises); a CPU input runs
    the plain version.  ``fused_message_pass_csr_backward.launches`` counts
    the C calls."""
    _check(x, ef, src, dst, w1, b1, w2, b2)
    _check_gout(g_out, x, w2)
    if x.device.type == "cpu":
        return fused_message_pass_csr_backward_reference(
            x, ef, src, dst, w1, b1, w2, b2, g1, be1, g2, be2, g_out, slope,
            edge_tile, window, src_window)
    layout = csr_layout(src, dst, x.shape[-2], edge_tile, window, src_window)
    scal = torch.cat([_scalar(v, x) for v in (g1, be1, g2, be2)])
    out = _backward_cuda(x, ef, layout, w1, b1, w2, b2, scal, g_out, slope)
    shape = torch.as_tensor(g1).shape
    return out[:6] + tuple(v.reshape(shape) for v in out[6:])


class _FusedMessagePassCSR(torch.autograd.Function):
    """Autograd node of one CSR round over a graph or a batch (x [B, N, D]; the JAX
    package's ``custom_vjp`` with ``pallas_backward=True``, vmapped), over
    the graphs' ``CSRLayout``.  A bf16 forward gets the same f32 backward:
    the flag is not passed on.  Captured while the tracer is on, each is a
    device span: ``mp.forward``, ``mp.backward``."""

    @staticmethod
    def forward(ctx, x, ef, w1, b1, w2, b2, g1, be1, g2, be2, slope, layout,
                bf16):
        scal = torch.cat([g1, be1, g2, be2])
        if x.device.type == "cpu":
            agg = _forward_plain(x, ef, layout.src, layout.dst, w1, b1, w2,
                                 b2, g1, be1, g2, be2, slope, bf16)
        else:
            with TRACER.graph_span("mp.forward"):
                agg = _forward_cuda(x, ef, layout, w1, b1, w2, b2, scal, slope,
                                    bf16)
        ctx.slope, ctx.layout = slope, layout
        ctx.save_for_backward(x, ef, w1, b1, w2, b2, scal)
        return agg

    @staticmethod
    def backward(ctx, g_out):
        x, ef, w1, b1, w2, b2, scal = ctx.saved_tensors
        layout = ctx.layout
        # upd_mlp concatenates [x, agg]: the cotangent may be a strided view.
        g_out = g_out.contiguous()
        if x.device.type == "cpu":
            dx, gef, dw1, db1, dw2, db2, *dscal = _backward_plain(
                x, ef, layout.src, layout.dst, w1, b1, w2, b2, *scal, g_out,
                ctx.slope, layout.edge_tile)
        else:
            with TRACER.graph_span("mp.backward"):
                dx, gef, dw1, db1, dw2, db2, *dscal = _backward_cuda(
                    x, ef, layout, w1, b1, w2, b2, scal, g_out, ctx.slope)
        return (dx, gef, dw1, db1, dw2, db2,
                *(v.reshape(1) for v in dscal), None, None, None)


def fused_message_pass_csr(
    x, ef, src, dst, w1, b1, w2, b2, g1, be1, g2, be2, slope=0.01,
    edge_tile=512, window=256, bf16=False, src_window=0, layout=None,
):
    """agg[n] = Σ_{p: dst=n} msgMLP([x_dst ‖ x_src ‖ ef]), differentiable.

    The JAX package's ``fused_message_pass_csr`` without ``interpret`` and
    ``pallas_backward``.  x: [N, D] f32; ef: [E, De] f32; src/dst: [E]
    int32 with sentinel N padding, dst non-decreasing over valid edges;
    w1: [2D+De, H] with rows [dst ‖ src ‖ edge]; b1: [H]; w2: [H, D2]; b2:
    [D2]; g1, be1, g2, be2: scalar norm affine parameters.  ``edge_tile``,
    ``window`` and ``src_window`` set the TPU kernel's window semantics
    (module docstring).  ``bf16``: the TPU kernel's bf16 operands (module
    docstring); the gradients are those of the f32 round.  ``layout``: the
    graph's ``csr_layout(src, dst, N, edge_tile, window, src_window)``, made
    once and passed to every round of the graph (it then stands for src,
    dst and the tiling), or None to make it here.
    Returns agg [N, D2] f32.  A batch of B graphs prepends B to x, ef,
    src and dst (and the layout's tensors, and agg): one C call for all of
    them.

    A CUDA input launches the kernels (or raises); a CPU input runs the
    plain versions.  ``fused_message_pass_csr.launches`` counts calls of
    the f32 forward's C entry point, ``fused_message_pass_csr.launches_bf16``
    those of its bf16 instantiation."""
    _check(x, ef, src, dst, w1, b1, w2, b2)
    scalars = [_scalar(v, x) for v in (g1, be1, g2, be2)]
    if layout is None:
        layout = csr_layout(src, dst, x.shape[-2], edge_tile, window,
                            src_window)
    return _FusedMessagePassCSR.apply(x, ef, w1, b1, w2, b2, *scalars, slope,
                                      layout, bool(bf16))


fused_message_pass_csr.launches = 0
fused_message_pass_csr.launches_bf16 = 0
fused_message_pass_csr_backward.launches = 0
