"""Fused message-passing round: edge gather → message MLP → scatter-add.

One round computes, for every directed edge e = (s → r),

    m_e   = act(cnorm(W2 · act(cnorm(W1 · [x_r ‖ x_s ‖ ef_e] + b1)) + b2))
    agg_n = Σ_{e: r(e)=n} m_e

with the reference channel norm (Bessel std, eps on the std, scalar γ/β) and
leaky ReLU.  ``fused_message_pass`` is differentiable on every device
through ``_FusedMessagePass``:

* forward: on a CUDA tensor the hand-written kernel ``fused_mp_forward`` of
  ``csrc/fused_mp.cu`` (the port of the JAX package's
  ``ops/pallas/fused_mp.py::_kernel``); on a CPU tensor
  ``fused_message_pass_reference``, the plain PyTorch version;
* backward: ``fused_message_pass_backward`` — on a CUDA tensor the kernels
  of ``fused_mp_backward`` in the same source (the port of
  ``fused_mp.py::_bwd_kernel``), on a CPU tensor
  ``fused_message_pass_backward_reference`` — then the node-level products
  that the JAX package also computes outside Pallas (``_backward_impl``).

Sentinel semantics are the TPU kernel's: a receiver outside [0, N) drops
the message; a sender outside [0, N) contributes a zero x_s while the
message still counts.  Padded edges carry N at both ends.

The kernels sum in a fixed order, as the TPU kernel's sequential grid
does, so two launches give the same bits: they walk the graph's
``fused_layout`` (its edges by receiver and by sender, stable), which the
model makes once per graph and hands to every round.

A batch of graphs is a leading graph axis: x [B, N, D], ef [B, E, De],
senders/receivers [B, E] (a single graph [N, D] is a batch of one).  The
JAX package vmaps the one-graph round, and the batching rule of
``pallas_call`` runs each kernel once for the whole batch with a leading
grid axis over the graphs; here one C call takes the B graphs, and its
kernels a grid dimension over them: graph b's outputs are those of a call
on graph b alone, bit for bit, and the weight gradients sum the graphs'
partials in graph order.  The plain versions loop over the graphs.

``bf16=True`` is the TPU kernel's bf16 mode (``_kernel`` with ``bf16``):
every operand of a matrix product is rounded to bfloat16 and every product
accumulates in float32 — a different function from the f32 round.  The
forward runs the kernel's bf16 instantiation (``fused_mp_forward_bf16``) or
``fused_message_pass_reference(..., bf16=True)``; the backward stays the
f32 recompute, as the JAX package's does.
"""

from __future__ import annotations

import ctypes
import functools
import operator
from typing import NamedTuple

import torch
import torch.nn.functional as F

from ..core.capture import count_launches
from ..utils.profiling import TRACER
from ._build import load
from .norms import EPS, channel_norm

_TINY = 1e-30  # guards 0/0 in the norm backward for all-constant rows


def _bf16(t: torch.Tensor) -> torch.Tensor:
    """t rounded to bfloat16 (to nearest, ties to even, as JAX's
    ``astype``) and back to float32."""
    return t.bfloat16().float()


def message_pass_bf16_plain(xa, xb, ef, senders, receivers, w1e, b1, w2, b2,
                            g1, be1, g2, be2, slope):
    """One round with the TPU kernels' bf16 operands, over the node
    partials xa, xb [N, H] (already rounded as the caller's kernel rounds
    them): pre1 = xa[r] + xb[s] + bf16(ef)·bf16(W1e) + b1, the layer-1
    activations rounded before ·bf16(W2), each message rounded before the
    scatter-add; biases, norms and sums in f32.  Sentinels as
    ``fused_message_pass_reference``."""
    n, h = xa.shape
    s, r = senders.long(), receivers.long()
    sentinel = torch.full_like(r, n)
    ri = torch.where((r >= 0) & (r < n), r, sentinel)
    si = torch.where((s >= 0) & (s < n), s, sentinel)
    zero = xa.new_zeros(1, h)  # row n: the zero row
    pre1 = (torch.cat([xa, zero])[ri] + torch.cat([xb, zero])[si]
            + _bf16(ef) @ _bf16(w1e) + b1)
    m1 = _bf16(F.leaky_relu(channel_norm(pre1, g1, be1), slope))
    m2 = F.leaky_relu(channel_norm(m1 @ _bf16(w2) + b2, g2, be2), slope)
    out = xa.new_zeros(n + 1, w2.shape[1])
    out.index_add_(0, ri, _bf16(m2))
    return out[:n]


def per_graph(fn, *batched, stacked=None):
    """The plain function ``fn`` of one graph over a batch: ``fn(*graph b's
    slices of batched)`` for each graph b in order.  A tensor result comes
    back stacked on a new leading axis; for a tuple, its first ``stacked``
    entries are stacked and the others (weight gradients) summed in graph
    order."""
    outs = [fn(*(t[b] for t in batched)) for b in range(batched[0].shape[0])]
    if torch.is_tensor(outs[0]):
        return torch.stack(outs)
    cols = list(zip(*outs))
    return (tuple(torch.stack(c) for c in cols[:stacked])
            + tuple(functools.reduce(operator.add, c) for c in cols[stacked:]))


def with_graph_axis(*tensors):
    """The tensors with a leading graph axis of one (views), for a single
    graph's arrays."""
    return tuple(t[None] for t in tensors)


def batch_layout(layout):
    """A single graph's layout (``FusedLayout`` or ``ops.csr_mp.CSRLayout``)
    with a leading graph axis of one on each of its tensors; None stays."""
    if layout is None:
        return None
    return type(layout)(*(v[None] if torch.is_tensor(v) else v for v in layout))


def fused_message_pass_reference(
    x, ef, senders, receivers, w1, b1, w2, b2, g1, be1, g2, be2, slope=0.01,
    bf16=False,
):
    """Plain PyTorch version: gather → two Linear + channel_norm + leaky-ReLU
    stages → ``index_add_``.  w1: [2D+De, H], w2: [H, D2] (in × out).
    ``bf16``: the TPU kernel's bf16 mode, which rounds the f32 products
    xa = x·W1r and xb = x·W1s (``_forward_impl``) and then the operands of
    ``message_pass_bf16_plain``.  A batch (x [B, N, D]) runs each graph's
    round in turn."""
    if x.ndim == 3:
        return per_graph(lambda *g: fused_message_pass_reference(
            *g, w1, b1, w2, b2, g1, be1, g2, be2, slope, bf16), x, ef, senders, receivers)
    n, d = x.shape
    if bf16:
        return message_pass_bf16_plain(
            _bf16(x @ w1[:d]), _bf16(x @ w1[d:2 * d]), ef, senders, receivers,
            w1[2 * d:], b1, w2, b2, g1, be1, g2, be2, slope)
    s, r = senders.long(), receivers.long()
    s_ok = (s >= 0) & (s < n)
    r_ok = (r >= 0) & (r < n)
    sentinel = torch.full_like(r, n)
    xz = torch.cat([x, x.new_zeros(1, d)])  # row n: the zero row
    x_r = xz.index_select(0, torch.where(r_ok, r, sentinel))
    x_s = xz.index_select(0, torch.where(s_ok, s, sentinel))
    pre1 = torch.cat([x_r, x_s, ef], dim=-1) @ w1 + b1
    m1 = F.leaky_relu(channel_norm(pre1, g1, be1), slope)
    m2 = F.leaky_relu(channel_norm(m1 @ w2 + b2, g2, be2), slope)
    out = x.new_zeros(n + 1, w2.shape[1])
    out.index_add_(0, torch.where(r_ok, r, sentinel), m2)
    return out[:n]


def _cnorm_stats(x):
    """Channel-norm intermediates (Bessel std): (u, sd, x̂)."""
    d = x.shape[-1]
    u = x - x.mean(dim=-1, keepdim=True)
    sd = torch.sqrt((u * u).sum(dim=-1, keepdim=True) / max(d - 1, 1))
    return u, sd, u / (sd + EPS)


def _cnorm_act_bwd(g, h, xhat, u, sd, gamma, slope):
    """Cotangents through lrelu(γ·x̂ + β) (JAX ``_cnorm_act_bwd``): returns
    (g_pre, dγ, dβ), g_pre = ∂L/∂(norm input).  The ``_TINY`` guard keeps a
    constant row finite where autograd of ``sqrt`` would give inf·0."""
    d = g.shape[-1]
    gh = g * torch.where(h >= 0, 1.0, slope)
    dgamma = (gh * xhat).sum()
    dbeta = gh.sum()
    gxh = gamma * gh
    c = (gxh * u).sum(dim=-1, keepdim=True) / (
        (sd + EPS) ** 2 * torch.clamp(sd, min=_TINY) * max(d - 1, 1)
    )
    g_u = gxh / (sd + EPS) - u * c
    return g_u - g_u.mean(dim=-1, keepdim=True), dgamma, dbeta


def fused_message_pass_backward_reference(
    x, ef, senders, receivers, w1, b1, w2, b2, g1, be1, g2, be2, g_out,
    slope=0.01,
):
    """Plain PyTorch version of the backward kernel (JAX ``_bwd_kernel``):
    recompute the forward per edge, then the explicit chain rule.

    Returns (gef [E, De], dxa [N, H], dxb [N, H], dw1e [De, H], db1 [H],
    dw2 [H, D2], db2 [D2], dγ1, dβ1, dγ2, dβ2), the last four 0-d.  xa = x·W1r
    and xb = x·W1s are the per-node partials; dx and the W1r/W1s rows of dW1
    follow from dxa/dxb outside (``_FusedMessagePass.backward``).  A batch
    (x [B, N, D]) runs each graph's in turn: gef, dxa and dxb per graph, the
    rest summed in graph order."""
    if x.ndim == 3:
        return per_graph(lambda xb, eb, sb, rb, gb: fused_message_pass_backward_reference(
            xb, eb, sb, rb, w1, b1, w2, b2, g1, be1, g2, be2, gb, slope),
            x, ef, senders, receivers, g_out, stacked=3)
    n, d = x.shape
    h, d2 = w1.shape[1], w2.shape[1]
    s, r = senders.long(), receivers.long()
    ri = torch.where((r >= 0) & (r < n), r, torch.full_like(r, n))
    si = torch.where((s >= 0) & (s < n), s, torch.full_like(s, n))
    w1e = w1[2 * d:]
    xa = torch.cat([x @ w1[:d], x.new_zeros(1, h)])  # row n: the zero row
    xb = torch.cat([x @ w1[d:2 * d], x.new_zeros(1, h)])
    g1, be1, g2, be2 = (torch.as_tensor(v, dtype=x.dtype, device=x.device)
                        .reshape(()) for v in (g1, be1, g2, be2))

    pre1 = xa[ri] + xb[si] + ef @ w1e + b1
    u1, sd1, xhat1 = _cnorm_stats(pre1)
    h1 = g1 * xhat1 + be1
    a1 = torch.where(h1 >= 0, h1, slope * h1)
    u2, sd2, xhat2 = _cnorm_stats(a1 @ w2 + b2)
    h2 = g2 * xhat2 + be2

    gm = torch.cat([g_out, g_out.new_zeros(1, d2)])[ri]
    g_pre2, dg2, dbe2 = _cnorm_act_bwd(gm, h2, xhat2, u2, sd2, g2, slope)
    ga1 = g_pre2 @ w2.t()
    g_pre1, dg1, dbe1 = _cnorm_act_bwd(ga1, h1, xhat1, u1, sd1, g1, slope)
    dxa = x.new_zeros(n + 1, h).index_add_(0, ri, g_pre1)[:n]
    dxb = x.new_zeros(n + 1, h).index_add_(0, si, g_pre1)[:n]
    return (g_pre1 @ w1e.t(), dxa, dxb, ef.t() @ g_pre1, g_pre1.sum(0),
            a1.t() @ g_pre2, g_pre2.sum(0), dg1, dbe1, dg2, dbe2)


class FusedLayout(NamedTuple):
    """The index preparation of one graph's fused rounds, shared by all of
    them (it depends on the edges only): the edges by receiver and by
    sender, each in a stable order, so that every node sums its edges in
    edge order, with its segments.  An end outside [0, N) sorts last, past
    offset N: no segment holds it.  A batch's has a leading graph axis."""

    recv_order: torch.Tensor  # [E] int32, the edges by receiver
    recv_off: torch.Tensor    # [N+1] int32, node v's: recv_order[recv_off[v]:recv_off[v+1]]
    send_order: torch.Tensor  # [E] int32, the edges by sender
    send_off: torch.Tensor    # [N+1] int32, node v's: send_order[send_off[v]:send_off[v+1]]


def fused_layout(senders: torch.Tensor, receivers: torch.Tensor,
                 n: int) -> FusedLayout:
    """The ``FusedLayout`` of a graph's edges (senders, receivers [E] int32)
    over n nodes, or of every graph of a batch ([B, E]: one stable sort
    along the last axis).  Both orders come from one stable argsort: the
    receivers as keys [0, n] and the senders as keys [n+1, 2n+1] side by
    side (an end outside [0, n) counts as n).  On the card everything stays
    on the device (no host sync)."""
    e = senders.shape[-1]

    def key(idx):
        return torch.where((idx >= 0) & (idx < n), idx, torch.full_like(idx, n))

    keys = torch.cat([key(receivers), key(senders) + (n + 1)], dim=-1)
    order = torch.argsort(keys, dim=-1, stable=True)
    nodes = torch.arange(2 * (n + 1), dtype=keys.dtype, device=keys.device)
    off = torch.searchsorted(torch.gather(keys, -1, order),
                             nodes.expand(*keys.shape[:-1], -1).contiguous(),
                             out_int32=True)
    return FusedLayout(order[..., :e].int(), off[..., : n + 1].contiguous(),
                       (order[..., e:] - e).int(), off[..., n + 1 :] - e)


def needs_layout(x: torch.Tensor) -> bool:
    """Whether the rounds over node features ``x`` run the kernels, which
    walk the graph's ``FusedLayout``: on every device but the CPU, whose
    plain versions need none."""
    return x.device.type != "cpu"


class ForwardPlan(NamedTuple):
    """How a forward C call's edge kernel (``fwd_edge_kernel``) runs at
    given widths on a device, as its library plans it."""

    tile: int     # edges a tile (32, 16 or 8)
    stages: int   # input stages (2 or 1)
    blocks: int   # edge blocks


class BackwardPlan(NamedTuple):
    """How a backward C call (``fused_mp_backward``, ``csr_mp_backward``)
    runs at given widths on a device, as its library plans it."""

    floats: int   # its scratch
    tile: int     # edges a tile of its edge kernel (32, 16 or 8)
    stages: int   # input stages of the edge kernel (2 or 1)
    blocks: int   # edge blocks


@functools.lru_cache(maxsize=None)
def _kernel(bf16: bool = False):
    """The forward kernel's C entry point (its bf16 instantiation with
    ``bf16``), built and loaded on first use."""
    lib = load("fused_mp")
    fn = lib.fused_mp_forward_bf16 if bf16 else lib.fused_mp_forward
    fn.argtypes = [ctypes.c_void_p] * 12 + [
        ctypes.c_float, ctypes.c_void_p, ctypes.c_void_p] + [ctypes.c_int] * 6 + [
        ctypes.c_void_p,
    ]
    fn.restype = ctypes.c_int
    return fn


def _plan(lib: str, entry: str, device, *widths) -> ForwardPlan:
    """The forward plan that library ``lib``'s entry point ``entry`` gives
    at ``widths`` (its int arguments) on ``device``."""
    fn = getattr(load(lib), entry)
    fn.argtypes = [ctypes.c_int] * len(widths) + [ctypes.POINTER(ctypes.c_int)]
    fn.restype = ctypes.c_int
    plan = (ctypes.c_int * 3)()
    with torch.cuda.device(device):
        rc = fn(*widths, plan)
    if rc != 0:
        raise ValueError(f"{entry}: widths {widths}: cudaError_t {rc}")
    return ForwardPlan(*plan)


def _forward_plan(n, e, de, h, d2, device) -> ForwardPlan:
    """How ``fused_mp_forward``'s edge kernel runs at these widths on
    ``device`` (``fused_mp_forward_plan``)."""
    return _plan("fused_mp", "fused_mp_forward_plan", device, n, e, de, h, d2)


@functools.lru_cache(maxsize=None)
def _bwd_kernel():
    """The backward's C entry point (same library as the forward)."""
    fn = load("fused_mp").fused_mp_backward
    fn.argtypes = [ctypes.c_void_p] * 15 + [ctypes.c_float] + [
        ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


@functools.lru_cache(maxsize=None)
def _bwd_scratch():
    """``fused_mp_backward_scratch``: the backward's scratch size and plan."""
    fn = load("fused_mp").fused_mp_backward_scratch
    fn.argtypes = [ctypes.c_int] * 6 + [ctypes.POINTER(ctypes.c_int)]
    fn.restype = ctypes.c_longlong
    return fn


def _scalar(v, like: torch.Tensor) -> torch.Tensor:
    t = torch.as_tensor(v, dtype=torch.float32, device=like.device)
    if t.numel() != 1:
        raise ValueError(f"norm affine parameters are scalars, got {tuple(t.shape)}")
    return t.reshape(1)


def _check(x, ef, senders, receivers, w1, b1, w2, b2):
    """Shapes, types, devices and contiguity of a round's inputs: a graph's
    (x [N, D], ef [E, De], senders, receivers [E]) or a batch's (each with
    the same leading graph axis)."""
    *lead, n, d = x.shape
    e, de = ef.shape[-2:]
    h, d2 = w1.shape[1], w2.shape[1]
    lead = tuple(lead)
    shapes = {
        "ef": (ef, lead + (e, de)),
        "senders": (senders, lead + (e,)), "receivers": (receivers, lead + (e,)),
        "w1": (w1, (2 * d + de, h)), "b1": (b1, (h,)),
        "w2": (w2, (h, d2)), "b2": (b2, (d2,)),
    }
    for name, (t, want) in shapes.items():
        if tuple(t.shape) != want:
            raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {want}")
    tensors = dict(x=x, ef=ef, senders=senders, receivers=receivers, w1=w1,
                   b1=b1, w2=w2, b2=b2)
    for name, t in tensors.items():
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
        want = torch.int32 if name in ("senders", "receivers") else torch.float32
        if t.dtype != want:
            raise TypeError(f"{name}: dtype {t.dtype}, expected {want}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def _check_kernel_widths(name, x, ef, w1, w2):
    if x.device.type != "cuda":
        raise ValueError(f"{name}: no kernel for device {x.device}")
    de, h, d2 = ef.shape[-1], w1.shape[1], w2.shape[1]
    if de % 4 or h % 4 or d2 % 4:
        raise ValueError(
            f"{name} kernel: unsupported widths De={de}, H={h}, D2={d2} "
            "(multiples of 4)"
        )


def _stream():
    return torch.cuda.current_stream().cuda_stream


def _node_products(x, w1, node_products=None):
    """xa = x·W1r, xb = x·W1s: the node partials of a round (pre1 = xa[r] +
    xb[s] + ef·W1e + b1), once per round as the JAX package computes them
    outside its kernel, or the ``node_products`` given."""
    d = x.shape[-1]
    return node_products or (x @ w1[:d], x @ w1[d : 2 * d])


def _forward_launch(x, ef, senders, receivers, w1, b1, w2, b2, scal, slope,
                    layout, node_products=None):
    """The arguments of one ``fused_mp_forward`` call over a batch (x [B, N,
    D]), with xa, xb (``_node_products``) and its buffers allocated, and the
    outputs (msgs [B, E, D2], agg [B, N, D2]) that it writes."""
    b, n, d = x.shape
    e = ef.shape[1]
    de, h, d2 = ef.shape[2], w1.shape[1], w2.shape[1]
    xa, xb = _node_products(x, w1, node_products)
    w1e = w1[2 * d :]
    msgs = torch.empty(b, e, d2, dtype=torch.float32, device=x.device)
    agg = torch.empty(b, n, d2, dtype=torch.float32, device=x.device)
    args = (xa.data_ptr(), xb.data_ptr(), ef.data_ptr(), senders.data_ptr(),
            receivers.data_ptr(), layout.recv_order.data_ptr(),
            layout.recv_off.data_ptr(), w1e.data_ptr(), b1.data_ptr(),
            w2.data_ptr(), b2.data_ptr(), scal.data_ptr(), float(slope),
            msgs.data_ptr(), agg.data_ptr(), n, e, de, h, d2, b, _stream())
    return args, (msgs, agg, xa, xb)


def _forward(x, ef, senders, receivers, w1, b1, w2, b2, g1, be1, g2, be2,
             slope, bf16, layout):
    """One forward round of a graph or a batch (x [B, N, D]): the plain
    version on the CPU, else the kernels of one C call (its bf16
    instantiation with ``bf16``) over the graphs' ``layout``: the messages
    into a scratch by edge, then every agg row written once."""
    if x.device.type == "cpu":
        return fused_message_pass_reference(
            x, ef, senders, receivers, w1, b1, w2, b2, g1, be1, g2, be2, slope,
            bf16)
    _check_kernel_widths("fused_message_pass", x, ef, w1, w2)
    if x.ndim == 2:  # a graph: a batch of one
        x, ef, senders, receivers = with_graph_axis(x, ef, senders, receivers)
        return _forward(x, ef, senders, receivers, w1, b1, w2, b2, g1, be1, g2,
                        be2, slope, bf16, batch_layout(layout))[0]
    scal = torch.cat([g1, be1, g2, be2])
    args, (_, agg, *_alive) = _forward_launch(x, ef, senders, receivers, w1, b1,
                                              w2, b2, scal, slope, layout)
    with torch.cuda.device(x.device):
        rc = _kernel(bf16)(*args)
    if rc != 0:
        raise RuntimeError(f"fused_mp_forward{'_bf16' if bf16 else ''} failed: "
                           f"cudaError_t {rc}")
    if bf16:
        fused_message_pass.launches_bf16 += 1
    else:
        fused_message_pass.launches += 1
    return agg


@functools.lru_cache(maxsize=None)
def _backward_plan(n, e, de, h, d2, device, graphs=1) -> BackwardPlan:
    """How ``fused_mp_backward`` runs at these widths over ``graphs`` graphs
    on ``device``, as the C library plans it (``fused_mp_backward_scratch``);
    the same on every call, so asked once."""
    plan = (ctypes.c_int * 3)()
    with torch.cuda.device(device):
        floats = _bwd_scratch()(n, e, de, h, d2, graphs, plan)
    if floats < 0:
        raise ValueError(f"fused_mp_backward: De={de}, H={h}, D2={d2}: "
                         f"cudaError_t {-floats}")
    return BackwardPlan(floats, *plan)


def _backward_launch(x, ef, senders, receivers, layout, w1, b1, w2, b2, scal,
                     g_out, slope, node_products=None):
    """The arguments of one ``fused_mp_backward`` call, with its buffers
    allocated and xa = x·W1r, xb = x·W1s computed (as ``_backward_impl``
    recomputes them), and the function that returns its results: views of
    the C call's outputs, every element of which the call writes.  A batch
    (x [B, N, D], the layout's with the same graph axis) gives gef, dxa and
    dxb per graph; a single graph's arrays give one graph's.
    ``node_products``: xa, xb to use (``_node_products``)."""
    _check_kernel_widths("fused_message_pass_backward", x, ef, w1, w2)
    single = x.ndim == 2
    if single:
        x, ef, senders, receivers, g_out = with_graph_axis(x, ef, senders, receivers, g_out)
        layout = batch_layout(layout)
        node_products = node_products and with_graph_axis(*node_products)
    b, n, d = x.shape
    e, de = ef.shape[1:]
    h, d2 = w1.shape[1], w2.shape[1]
    xa, xb = _node_products(x, w1, node_products)
    w1e = w1[2 * d :]
    emp = functools.partial(torch.empty, dtype=torch.float32, device=x.device)
    scratch = emp(_backward_plan(n, e, de, h, d2, x.device, b).floats)
    # Outputs: gef, dxa ‖ dxb per graph and dw = dW1e ‖ db1 ‖ dW2 ‖ db2 ‖
    # dγ1 dβ1 dγ2 dβ2, summed over the graphs.
    gef, dxab = emp(b, e, de), emp(b, 2, n, h)
    k = de * h
    dw = emp(k + h + h * d2 + d2 + 4)
    args = (
        xa.data_ptr(), xb.data_ptr(), ef.data_ptr(), senders.data_ptr(),
        receivers.data_ptr(), layout.recv_order.data_ptr(),
        layout.recv_off.data_ptr(), layout.send_order.data_ptr(),
        layout.send_off.data_ptr(), w1e.data_ptr(), b1.data_ptr(),
        w2.data_ptr(), b2.data_ptr(), scal.data_ptr(), g_out.data_ptr(),
        float(slope), scratch.data_ptr(), gef.data_ptr(), dxab.data_ptr(),
        dw.data_ptr(), n, e, de, h, d2, b, _stream(),
    )

    def results(_alive=(x, ef, senders, receivers, g_out, xa, xb, layout, scratch)):
        # _alive holds the tensors only the pointers above refer to.
        per = (gef, dxab[:, 0], dxab[:, 1])
        return ((tuple(t[0] for t in per) if single else per)
                + (dw[:k].view(de, h), dw[k : k + h],
                   dw[k + h : k + h + h * d2].view(h, d2),
                   dw[k + h + h * d2 : -4], *dw[-4:].unbind()))

    return args, results


def fused_message_pass_backward(
    x, ef, senders, receivers, w1, b1, w2, b2, g1, be1, g2, be2, g_out,
    slope=0.01, layout=None,
):
    """Cotangents of one round for the cotangent ``g_out`` [N, D2] of agg
    (of a batch: x [B, N, D], g_out [B, N, D2], the layout's with the same
    graph axis).

    Returns what ``fused_message_pass_backward_reference`` returns.  A CUDA
    input runs the kernels of one ``fused_mp_backward`` call for all the
    graphs (or raises) over the graphs' ``layout`` (made here if None); a
    CPU input runs the plain version.  ``fused_message_pass_backward.launches``
    counts the C calls.  xa/xb are recomputed here with two matmuls (as
    ``_backward_impl`` recomputes them), not saved by the forward."""
    _check(x, ef, senders, receivers, w1, b1, w2, b2)
    want = x.shape[:-1] + (w2.shape[1],)
    if tuple(g_out.shape) != want or g_out.dtype != torch.float32:
        raise ValueError(f"g_out: {tuple(g_out.shape)} {g_out.dtype}, "
                         f"expected {want} float32")
    if g_out.device != x.device or not g_out.is_contiguous():
        raise ValueError("g_out must be contiguous and on x's device")
    if x.device.type == "cpu":
        return fused_message_pass_backward_reference(
            x, ef, senders, receivers, w1, b1, w2, b2, g1, be1, g2, be2,
            g_out, slope)
    if layout is None:
        layout = fused_layout(senders, receivers, x.shape[-2])
    scal = torch.cat([_scalar(v, x) for v in (g1, be1, g2, be2)])
    args, results = _backward_launch(x, ef, senders, receivers, layout, w1,
                                     b1, w2, b2, scal, g_out, slope)
    with torch.cuda.device(x.device):
        rc = _bwd_kernel()(*args)
    if rc != 0:
        raise RuntimeError(f"fused_mp_backward failed: cudaError_t {rc}")
    fused_message_pass_backward.launches += 1
    return results()


class _FusedMessagePass(torch.autograd.Function):
    """Autograd node of one round over a graph or a batch (x [B, N, D]; the
    JAX package's ``custom_vjp`` with ``pallas_backward=True``, vmapped).  The
    forward saves its inputs; the backward runs
    ``fused_message_pass_backward`` and finishes as ``_backward_impl`` does:
    dx = dxa·W1rᵀ + dxb·W1sᵀ per graph, dW1 = [xᵀ·dxa; xᵀ·dxb; dW1e] over
    every graph's nodes.  A bf16 forward gets the same f32 backward: the
    flag is not passed on.  On the card both walk the graphs'
    ``FusedLayout``; the plain versions take none.  Captured while the
    tracer is on, each is a device span: ``mp.forward``, ``mp.backward``
    (the dx and dW1 products included)."""

    @staticmethod
    def forward(ctx, x, ef, senders, receivers, w1, b1, w2, b2, g1, be1, g2,
                be2, slope, bf16, layout):
        ctx.slope, ctx.layout = slope, layout
        ctx.save_for_backward(x, ef, senders, receivers, w1, b1, w2, b2, g1,
                              be1, g2, be2)
        with TRACER.graph_span("mp.forward"):
            return _forward(x, ef, senders, receivers, w1, b1, w2, b2, g1, be1,
                            g2, be2, slope, bf16, layout)

    @staticmethod
    def backward(ctx, g_out):
        x, ef, senders, receivers, w1, b1, w2, b2, g1, be1, g2, be2 = (
            ctx.saved_tensors)
        with TRACER.graph_span("mp.backward"):
            # upd_mlp concatenates [x, agg]: the cotangent may be a strided view.
            (gef, dxa, dxb, dw1e, db1, dw2, db2, dg1, dbe1, dg2,
             dbe2) = fused_message_pass_backward(
                x, ef, senders, receivers, w1, b1, w2, b2, g1, be1, g2, be2,
                g_out.contiguous(), ctx.slope, ctx.layout)
            d, h = x.shape[-1], w1.shape[1]
            dx = dxa @ w1[:d].t() + dxb @ w1[d : 2 * d].t()
            xt = x.reshape(-1, d).t()  # every graph's nodes
            dw1 = torch.cat([xt @ dxa.reshape(-1, h), xt @ dxb.reshape(-1, h), dw1e])
        return (dx, gef, None, None, dw1, db1, dw2, db2, dg1.reshape(1),
                dbe1.reshape(1), dg2.reshape(1), dbe2.reshape(1), None, None,
                None)


def fused_message_pass(
    x, ef, senders, receivers, w1, b1, w2, b2, g1, be1, g2, be2, slope=0.01,
    bf16=False, layout=None,
):
    """agg[n] = Σ_{e: recv=n} msgMLP([x_recv ‖ x_send ‖ ef]), differentiable.

    x: [N, D] f32; ef: [E, De] f32; senders/receivers: [E] int32 (padded
    edges carry N); w1: [2D+De, H]; b1: [H]; w2: [H, D2]; b2: [D2]; g1, be1,
    g2, be2: scalar norm affine parameters (one-element tensors or floats;
    their gradients have shape (1,), as ``ScalarNorm``'s parameters).  A
    batch of B graphs prepends B to x, ef, senders and receivers (and to
    agg): one call of the kernels for all of them.  ``bf16``: the TPU
    kernel's bf16 operands (module docstring); the gradients are those of
    the f32 round.  ``layout``: the graph's (or the batch's)
    ``fused_layout(senders, receivers, N)``, made once and passed to every
    round of the graph, or None to make it here (on the card; the plain
    versions need none).  Returns agg [N, D2] f32 ([B, N, D2]).

    A CUDA input launches the kernels (or raises); a CPU input runs the
    plain versions.  ``fused_message_pass.launches`` counts calls of the
    f32 forward's C entry point (two kernels each, whatever B is),
    ``fused_message_pass.launches_bf16`` those of its bf16 instantiation;
    under ``torch.no_grad()`` nothing is saved for a
    backward."""
    _check(x, ef, senders, receivers, w1, b1, w2, b2)
    scalars = [_scalar(v, x) for v in (g1, be1, g2, be2)]
    if layout is None and needs_layout(x):
        layout = fused_layout(senders, receivers, x.shape[-2])
    return _FusedMessagePass.apply(x, ef, senders, receivers, w1, b1, w2, b2,
                                   *scalars, slope, bool(bf16), layout)


fused_message_pass.launches = 0
fused_message_pass.launches_bf16 = 0
fused_message_pass_backward.launches = 0
# A replay of a captured graph advances them by what its capture launched.
count_launches((fused_message_pass, "launches"), (fused_message_pass, "launches_bf16"),
               (fused_message_pass_backward, "launches"))
