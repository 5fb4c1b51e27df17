"""Fused message-passing round: edge gather → message MLP → scatter-add.

One round computes, for every directed edge e = (s → r),

    m_e   = act(cnorm(W2 · act(cnorm(W1 · [x_r ‖ x_s ‖ ef_e] + b1)) + b2))
    agg_n = Σ_{e: r(e)=n} m_e

with the reference channel norm (Bessel std, eps on the std, scalar γ/β) and
leaky ReLU.  On a CUDA tensor ``fused_message_pass`` launches the
hand-written kernel ``csrc/fused_mp.cu``, the port of the JAX package's
``ops/pallas/fused_mp.py::_kernel``; on a CPU tensor it runs
``fused_message_pass_reference``, the plain PyTorch version of the same
function.

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
from .norms import channel_norm

_SUPPORTED_HPL = (1, 2, 4, 8)  # ceil(H / 32) the kernel is instantiated for
_SUPPORTED_DPL = (1, 2, 4)     # ceil(D2 / 32)


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


@functools.lru_cache(maxsize=None)
def _kernel():
    """The kernel's C entry point, built and loaded on first use."""
    fn = load("fused_mp").fused_mp_forward
    fn.argtypes = [ctypes.c_void_p] * 10 + [
        ctypes.c_float, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p,
    ]
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


def fused_message_pass(
    x, ef, senders, receivers, w1, b1, w2, b2, g1, be1, g2, be2, slope=0.01,
):
    """agg[n] = Σ_{e: recv=n} msgMLP([x_recv ‖ x_send ‖ ef]).

    x: [N, D] f32; ef: [E, De] f32; senders/receivers: [E] int32 (padded
    edges carry N); w1: [2D+De, H]; b1: [H]; w2: [H, D2]; b2: [D2]; g1, be1,
    g2, be2: scalar norm affine parameters (one-element tensors or floats).
    Returns agg [N, D2] f32.

    A CUDA input launches the kernel (or raises); a CPU input runs the plain
    version.  ``fused_message_pass.launches`` counts kernel launches."""
    _check(x, ef, senders, receivers, w1, b1, w2, b2)
    if x.device.type == "cpu":
        return fused_message_pass_reference(
            x, ef, senders, receivers, w1, b1, w2, b2, g1, be1, g2, be2, slope
        )
    if x.device.type != "cuda":
        raise ValueError(f"fused_message_pass: no kernel for device {x.device}")
    n, d = x.shape
    e, de = ef.shape
    h, d2 = w1.shape[1], w2.shape[1]
    if (de % 4 or h % 4 or d2 % 4 or -(-h // 32) not in _SUPPORTED_HPL
            or -(-d2 // 32) not in _SUPPORTED_DPL):
        raise ValueError(
            f"fused_message_pass kernel: unsupported widths De={de}, H={h}, "
            f"D2={d2} (multiples of 4, H <= 256, D2 <= 128)"
        )
    scal = torch.cat([_scalar(v, x) for v in (g1, be1, g2, be2)])
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


fused_message_pass.launches = 0
