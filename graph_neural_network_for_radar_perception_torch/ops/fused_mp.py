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
* backward: ``fused_message_pass_backward`` — on a CUDA tensor the kernel
  ``fused_mp_backward`` of the same source (the port of
  ``fused_mp.py::_bwd_kernel``), on a CPU tensor
  ``fused_message_pass_backward_reference`` — then the node-level products
  that the JAX package also computes outside Pallas (``_backward_impl``).

Sentinel semantics are the TPU kernel's: a receiver outside [0, N) drops
the message; a sender outside [0, N) contributes a zero x_s while the
message still counts.  Padded edges carry N at both ends.
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from ._build import load
from .norms import EPS, channel_norm

_SUPPORTED_HPL = (1, 2, 4, 8)  # ceil(H / 32) the kernels are instantiated for
_SUPPORTED_DPL = (1, 2, 4)     # ceil(D2 / 32)
_TINY = 1e-30  # guards 0/0 in the norm backward for all-constant rows


def fused_message_pass_reference(
    x, ef, senders, receivers, w1, b1, w2, b2, g1, be1, g2, be2, slope=0.01,
):
    """Plain PyTorch version: gather → two Linear + channel_norm + leaky-ReLU
    stages → ``index_add_``.  w1: [2D+De, H], w2: [H, D2] (in × out)."""
    n, d = x.shape
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
    follow from dxa/dxb outside (``_FusedMessagePass.backward``)."""
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


@functools.lru_cache(maxsize=None)
def _kernel():
    """The forward kernel's C entry point, built and loaded on first use."""
    fn = load("fused_mp").fused_mp_forward
    fn.argtypes = [ctypes.c_void_p] * 10 + [
        ctypes.c_float, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p,
    ]
    fn.restype = ctypes.c_int
    return fn


@functools.lru_cache(maxsize=None)
def _bwd_kernel():
    """The backward kernel's C entry point (same library as the forward)."""
    fn = load("fused_mp").fused_mp_backward
    fn.argtypes = [ctypes.c_void_p] * 13 + [ctypes.c_float] + [
        ctypes.c_void_p] * 8 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _scalar(v, like: torch.Tensor) -> torch.Tensor:
    t = torch.as_tensor(v, dtype=torch.float32, device=like.device)
    if t.numel() != 1:
        raise ValueError(f"norm affine parameters are scalars, got {tuple(t.shape)}")
    return t.reshape(1)


def _check(x, ef, senders, receivers, w1, b1, w2, b2):
    n, d = x.shape
    e, de = ef.shape
    h, d2 = w1.shape[1], w2.shape[1]
    shapes = {
        "senders": (senders, (e,)), "receivers": (receivers, (e,)),
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
    de, h, d2 = ef.shape[1], w1.shape[1], w2.shape[1]
    if (de % 4 or h % 4 or d2 % 4 or -(-h // 32) not in _SUPPORTED_HPL
            or -(-d2 // 32) not in _SUPPORTED_DPL):
        raise ValueError(
            f"{name} kernel: unsupported widths De={de}, H={h}, D2={d2} "
            "(multiples of 4, H <= 256, D2 <= 128)"
        )


def _forward(x, ef, senders, receivers, w1, b1, w2, b2, g1, be1, g2, be2,
             slope):
    """One forward round: the plain version on the CPU, else the kernel."""
    if x.device.type == "cpu":
        return fused_message_pass_reference(
            x, ef, senders, receivers, w1, b1, w2, b2, g1, be1, g2, be2, slope
        )
    _check_kernel_widths("fused_message_pass", x, ef, w1, w2)
    n, d = x.shape
    e, de = ef.shape
    h, d2 = w1.shape[1], w2.shape[1]
    scal = torch.cat([g1, be1, g2, be2])
    # Node partials, once per round (as the JAX package computes them
    # outside its kernel): pre1 = xa[r] + xb[s] + ef·W1e + b1.
    xa = x @ w1[:d]
    xb = x @ w1[d : 2 * d]
    w1e = w1[2 * d :]
    agg = torch.zeros(n, d2, dtype=torch.float32, device=x.device)
    if e == 0:
        return agg
    fn = _kernel()
    with torch.cuda.device(x.device):
        rc = fn(
            xa.data_ptr(), xb.data_ptr(), ef.data_ptr(), senders.data_ptr(),
            receivers.data_ptr(), w1e.data_ptr(), b1.data_ptr(),
            w2.data_ptr(), b2.data_ptr(), scal.data_ptr(), float(slope),
            agg.data_ptr(), n, e, de, h, d2,
            torch.cuda.current_stream().cuda_stream,
        )
    if rc != 0:
        raise RuntimeError(f"fused_mp_forward failed: cudaError_t {rc}")
    fused_message_pass.launches += 1
    return agg


def fused_message_pass_backward(
    x, ef, senders, receivers, w1, b1, w2, b2, g1, be1, g2, be2, g_out,
    slope=0.01,
):
    """Cotangents of one round for the cotangent ``g_out`` [N, D2] of agg.

    Returns what ``fused_message_pass_backward_reference`` returns.  A CUDA
    input launches the kernel (or raises); a CPU input runs the plain
    version.  ``fused_message_pass_backward.launches`` counts kernel
    launches.  xa/xb are recomputed here with two matmuls (as
    ``_backward_impl`` recomputes them), not saved by the forward."""
    _check(x, ef, senders, receivers, w1, b1, w2, b2)
    n, d = x.shape
    e, de = ef.shape
    h, d2 = w1.shape[1], w2.shape[1]
    if tuple(g_out.shape) != (n, d2) or g_out.dtype != torch.float32:
        raise ValueError(f"g_out: {tuple(g_out.shape)} {g_out.dtype}, "
                         f"expected ({n}, {d2}) float32")
    if g_out.device != x.device or not g_out.is_contiguous():
        raise ValueError("g_out must be contiguous and on x's device")
    if x.device.type == "cpu":
        return fused_message_pass_backward_reference(
            x, ef, senders, receivers, w1, b1, w2, b2, g1, be1, g2, be2,
            g_out, slope)
    _check_kernel_widths("fused_message_pass_backward", x, ef, w1, w2)
    scal = torch.cat([_scalar(v, x) for v in (g1, be1, g2, be2)])
    xa = x @ w1[:d]
    xb = x @ w1[d : 2 * d]
    w1e = w1[2 * d :]
    # Transposed copies, so that the kernel's lanes read both products'
    # weights along contiguous rows.
    w1e_t = w1e.t().contiguous()
    w2_t = w2.t().contiguous()
    z = functools.partial(torch.zeros, dtype=torch.float32, device=x.device)
    gef, dxa, dxb = z(e, de), z(n, h), z(n, h)
    dw1e, db1, dw2, db2, dscal = z(de, h), z(h), z(h, d2), z(d2), z(4)
    if e > 0:
        fn = _bwd_kernel()
        with torch.cuda.device(x.device):
            rc = fn(
                xa.data_ptr(), xb.data_ptr(), ef.data_ptr(),
                senders.data_ptr(), receivers.data_ptr(), w1e.data_ptr(),
                w1e_t.data_ptr(), b1.data_ptr(), w2.data_ptr(),
                w2_t.data_ptr(), b2.data_ptr(), scal.data_ptr(),
                g_out.data_ptr(), float(slope), gef.data_ptr(),
                dxa.data_ptr(), dxb.data_ptr(), dw1e.data_ptr(),
                db1.data_ptr(), dw2.data_ptr(), db2.data_ptr(),
                dscal.data_ptr(), n, e, de, h, d2,
                torch.cuda.current_stream().cuda_stream,
            )
        if rc != 0:
            raise RuntimeError(f"fused_mp_backward failed: cudaError_t {rc}")
        fused_message_pass_backward.launches += 1
    return (gef, dxa, dxb, dw1e, db1, dw2, db2,
            dscal[0], dscal[1], dscal[2], dscal[3])


class _FusedMessagePass(torch.autograd.Function):
    """Autograd node of one round (the JAX package's ``custom_vjp`` with
    ``pallas_backward=True``).  The forward saves its inputs; the backward
    runs ``fused_message_pass_backward`` and finishes as ``_backward_impl``
    does: dx = dxa·W1rᵀ + dxb·W1sᵀ, dW1 = [xᵀ·dxa; xᵀ·dxb; dW1e]."""

    @staticmethod
    def forward(ctx, x, ef, senders, receivers, w1, b1, w2, b2, g1, be1, g2,
                be2, slope):
        ctx.slope = slope
        ctx.save_for_backward(x, ef, senders, receivers, w1, b1, w2, b2, g1,
                              be1, g2, be2)
        return _forward(x, ef, senders, receivers, w1, b1, w2, b2, g1, be1,
                        g2, be2, slope)

    @staticmethod
    def backward(ctx, g_out):
        x, ef, senders, receivers, w1, b1, w2, b2, g1, be1, g2, be2 = (
            ctx.saved_tensors)
        # upd_mlp concatenates [x, agg]: the cotangent may be a strided view.
        (gef, dxa, dxb, dw1e, db1, dw2, db2, dg1, dbe1, dg2,
         dbe2) = fused_message_pass_backward(
            x, ef, senders, receivers, w1, b1, w2, b2, g1, be1, g2, be2,
            g_out.contiguous(), ctx.slope)
        d = x.shape[1]
        dx = dxa @ w1[:d].t() + dxb @ w1[d : 2 * d].t()
        dw1 = torch.cat([x.t() @ dxa, x.t() @ dxb, dw1e])
        return (dx, gef, None, None, dw1, db1, dw2, db2, dg1.reshape(1),
                dbe1.reshape(1), dg2.reshape(1), dbe2.reshape(1), None)


def fused_message_pass(
    x, ef, senders, receivers, w1, b1, w2, b2, g1, be1, g2, be2, slope=0.01,
):
    """agg[n] = Σ_{e: recv=n} msgMLP([x_recv ‖ x_send ‖ ef]), differentiable.

    x: [N, D] f32; ef: [E, De] f32; senders/receivers: [E] int32 (padded
    edges carry N); w1: [2D+De, H]; b1: [H]; w2: [H, D2]; b2: [D2]; g1, be1,
    g2, be2: scalar norm affine parameters (one-element tensors or floats;
    their gradients have shape (1,), as ``ScalarNorm``'s parameters).
    Returns agg [N, D2] f32.

    A CUDA input launches the kernels (or raises); a CPU input runs the
    plain versions.  ``fused_message_pass.launches`` counts forward kernel
    launches; under ``torch.no_grad()`` nothing is saved for a backward."""
    _check(x, ef, senders, receivers, w1, b1, w2, b2)
    scalars = [_scalar(v, x) for v in (g1, be1, g2, be2)]
    return _FusedMessagePass.apply(x, ef, senders, receivers, w1, b1, w2, b2,
                                   *scalars, slope)


fused_message_pass.launches = 0
fused_message_pass_backward.launches = 0
