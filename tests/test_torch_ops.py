"""Port ops against the JAX package on the same numpy-seeded inputs: the
norms, the segment ops, and the fused message pass (the port's plain
version against the Pallas kernel in interpret mode and against its XLA
reference).  The CUDA kernel is held against the plain version in
tests/test_torch_cuda.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from graph_neural_network_for_radar_perception_torch.ops import fused_mp as FM
from graph_neural_network_for_radar_perception_torch.ops import norms as TN
from graph_neural_network_for_radar_perception_torch.ops import segment as TS
from graph_neural_network_for_radar_perception_tpu.ops import norms as JN
from graph_neural_network_for_radar_perception_tpu.ops import segment as JS
from graph_neural_network_for_radar_perception_tpu.ops.pallas import fused_mp as JFM
from torch_port_fixtures import one_torch_thread  # noqa: F401  (autouse)

T = torch.from_numpy


def _close(got, want, rtol=1e-5, atol=1e-6):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=rtol, atol=atol)


# --------------------------------------------------------------------- norms
def _norm_inputs(rng, case):
    """The masked cases of tests/test_ops.py: padded rows that must not
    enter the statistics."""
    x = rng.normal(size=(6, 8)).astype(np.float32)
    if case == "unmasked":
        return x, None
    fill = 0.0 if case == "zero_pad" else 7.0
    xp = np.concatenate([x, np.full((4, 8), fill, np.float32)])
    return xp, np.array([True] * 6 + [False] * 4)


@pytest.mark.parametrize("case", ["unmasked", "zero_pad", "const_pad"])
def test_norms_match_jax(rng, case):
    x, mask = _norm_inputs(rng, case)
    g, b = np.float32(1.3), np.float32(-0.2)
    tm = None if mask is None else T(mask)
    jm = None if mask is None else jnp.asarray(mask)
    _close(TN.channel_norm(T(x), g, b), JN.channel_norm(jnp.asarray(x), g, b))
    _close(TN.layer_norm(T(x), g, b, tm), JN.layer_norm(jnp.asarray(x), g, b, jm))
    _close(TN.group_norm(T(x), g, b, 2, tm),
           JN.group_norm(jnp.asarray(x), g, b, 2, jm))


# --------------------------------------------------------------- segment ops
@pytest.mark.parametrize("ndim", [1, 2])
def test_segment_ops_match_jax(rng, ndim):
    e, n = 50, 8
    data = rng.normal(size=(e, 3) if ndim == 2 else (e,)).astype(np.float32)
    ids = rng.integers(0, n, size=e).astype(np.int32)
    ids[:3] = n  # void-slot / out-of-range ids are dropped
    ids[3] = n + 5
    mask = rng.random(e) > 0.3
    mask[ids == 0] = False  # segment 0 is empty: the masked max fills it
    td, ti, tm = T(data), T(ids), T(mask)
    jd, ji, jm = jnp.asarray(data), jnp.asarray(ids), jnp.asarray(mask)
    for m_t, m_j in ((tm, jm), (None, None)):
        _close(TS.masked_segment_sum(td, ti, n, m_t),
               JS.masked_segment_sum(jd, ji, n, m_j))
        _close(TS.masked_segment_max(td, ti, n, m_t),
               JS.masked_segment_max(jd, ji, n, m_j))
        _close(TS.masked_segment_mean(td, ti, n, m_t),
               JS.masked_segment_mean(jd, ji, n, m_j))
    table = rng.normal(size=(n, 5)).astype(np.float32)
    idx = rng.integers(0, n, size=e).astype(np.int32)
    _close(TS.gather_nodes(T(table), T(idx)),
           JS.gather_nodes(jnp.asarray(table), jnp.asarray(idx)), rtol=0, atol=0)


# ------------------------------------------------------ fused message pass
def make_problem(rng, n=128, e=700, d=32, de=16, h=64, d2=32, mixed=False):
    """tests/test_pallas.py's problem: random edges with sentinel padding;
    ``mixed`` adds edges with only one end at the sentinel."""
    x = rng.normal(size=(n, d)).astype(np.float32)
    ef = rng.normal(size=(e, de)).astype(np.float32)
    senders = rng.integers(0, n, size=e).astype(np.int32)
    receivers = rng.integers(0, n, size=e).astype(np.int32)
    pad = rng.random(e) < 0.1
    senders[pad] = n
    receivers[pad] = n
    if mixed:
        senders[rng.random(e) < 0.1] = n
        receivers[rng.random(e) < 0.05] = n
    w1 = (rng.normal(size=(2 * d + de, h)) * 0.1).astype(np.float32)
    b1 = rng.normal(size=(h,)).astype(np.float32) * 0.1
    w2 = (rng.normal(size=(h, d2)) * 0.1).astype(np.float32)
    b2 = rng.normal(size=(d2,)).astype(np.float32) * 0.1
    return (x, ef, senders, receivers, w1, b1, w2, b2,
            np.float32(1.1), np.float32(0.05), np.float32(0.9),
            np.float32(-0.02))


def _port_plain(args):
    return FM.fused_message_pass(
        *[T(a) for a in args[:8]], *[float(v) for v in args[8:]], 0.01)


@pytest.mark.parametrize("case", ["sentinel_pad", "ragged_e", "mixed_sentinel"])
def test_plain_fused_mp_matches_pallas_interpret(rng, case):
    args = make_problem(rng, e=500 if case == "ragged_e" else 700,
                        mixed=case == "mixed_sentinel")
    want = JFM.fused_message_pass(*[jnp.asarray(a) for a in args], 0.01, 256, True)
    _close(_port_plain(args), want, rtol=2e-4, atol=2e-5)


@pytest.mark.parametrize("case", ["sentinel_pad", "ragged_e"])
def test_plain_fused_mp_matches_xla_reference(rng, case):
    # _xla_reference drops an edge when EITHER end is a sentinel; it agrees
    # with the kernel only where both ends are, so no mixed case here.
    args = make_problem(rng, e=500 if case == "ragged_e" else 700)
    want = JFM._xla_reference(*[jnp.asarray(a) for a in args], slope=0.01)
    _close(_port_plain(args), want, rtol=2e-4, atol=2e-5)


# ------------------------------------------- fused message pass, backward
GRAD_TOL = dict(rtol=5e-4, atol=5e-5)  # tests/test_pallas.py's gradient check


@pytest.mark.parametrize("case", ["sentinel_pad", "ragged_e", "mixed_sentinel"])
def test_plain_backward_matches_pallas_interpret(rng, case):
    """The backward's plain version, output by output, against the Pallas
    backward kernel (``_backward_impl`` in interpret mode).  dxa/dxb and
    dW1e are compared through _backward_impl's finished dx and dW1."""
    args = make_problem(rng, e=500 if case == "ragged_e" else 700,
                        mixed=case == "mixed_sentinel")
    x, w1 = args[0], args[4]
    d = x.shape[1]
    g = rng.normal(size=(x.shape[0], args[6].shape[1])).astype(np.float32)
    (dx, gef, dw1, db1, dw2, db2, dg1, dbe1, dg2, dbe2) = JFM._backward_impl(
        *[jnp.asarray(a) for a in args], jnp.asarray(g), slope=0.01,
        edge_tile=256, interpret=True)
    before = FM.fused_message_pass_backward.launches
    got = FM.fused_message_pass_backward(
        *[T(a) for a in args[:8]], *[float(v) for v in args[8:]], T(g), 0.01)
    assert FM.fused_message_pass_backward.launches == before
    (t_gef, dxa, dxb, t_dw1e, t_db1, t_dw2, t_db2, *t_scalars) = got
    _close(t_gef, gef, **GRAD_TOL)
    _close(dxa @ T(w1[:d]).t() + dxb @ T(w1[d:2 * d]).t(), dx, **GRAD_TOL)
    _close(T(x).t() @ dxa, dw1[:d], **GRAD_TOL)
    _close(T(x).t() @ dxb, dw1[d:2 * d], **GRAD_TOL)
    _close(t_dw1e, dw1[2 * d:], **GRAD_TOL)
    for t, j in zip((t_db1, t_dw2, t_db2, *t_scalars),
                    (db1, dw2, db2, dg1, dbe1, dg2, dbe2)):
        _close(t, j, **GRAD_TOL)


def _function_grads(args, g):
    """Gradients of <fused_message_pass(...), g> through _FusedMessagePass,
    for x, ef, w1, b1, w2, b2 and the four norm scalars."""
    ts = [T(args[i]).clone().requires_grad_() for i in (0, 1, 4, 5, 6, 7)]
    sc = [torch.tensor([float(v)], requires_grad=True) for v in args[8:]]
    x, ef, w1, b1, w2, b2 = ts
    out = FM.fused_message_pass(x, ef, T(args[2]), T(args[3]), w1, b1, w2, b2,
                                *sc, 0.01)
    assert isinstance(out.grad_fn, FM._FusedMessagePass._backward_cls)
    return torch.autograd.grad(out, ts + sc, T(g))


@pytest.mark.parametrize("case", ["sentinel_pad", "ragged_e"])
def test_function_grads_match_xla_vjp_and_autograd(rng, case):
    """The autograd Function's gradients against jax.vjp of _xla_reference
    and against torch autograd of the plain forward (random rows, none
    constant; no mixed sentinels, which _xla_reference treats differently)."""
    args = make_problem(rng, e=500 if case == "ragged_e" else 700)
    g = rng.normal(size=(args[0].shape[0], args[6].shape[1])).astype(np.float32)
    got = _function_grads(args, g)

    s, r = jnp.asarray(args[2]), jnp.asarray(args[3])
    diff = [jnp.asarray(args[i]) for i in (0, 1, 4, 5, 6, 7)] + [
        jnp.asarray(v) for v in args[8:]]
    _, vjp = jax.vjp(lambda x, ef, w1, b1, w2, b2, g1, be1, g2, be2:
                     JFM._xla_reference(x, ef, s, r, w1, b1, w2, b2, g1, be1,
                                        g2, be2, slope=0.01), *diff)
    for t, j in zip(got, vjp(jnp.asarray(g))):
        _close(t.reshape(np.shape(j)), j, **GRAD_TOL)

    ts = [T(args[i]).clone().requires_grad_() for i in (0, 1, 4, 5, 6, 7)]
    sc = [torch.tensor([float(v)], requires_grad=True) for v in args[8:]]
    x, ef, w1, b1, w2, b2 = ts
    out = FM.fused_message_pass_reference(x, ef, T(args[2]), T(args[3]), w1,
                                          b1, w2, b2, *sc, 0.01)
    for t, a in zip(got, torch.autograd.grad(out, ts + sc, T(g))):
        _close(t, a.numpy(), **GRAD_TOL)


def test_norm_backward_guard(rng):
    """The norm backward against the JAX package's _cnorm_act_bwd, and on a
    constant row (u = 0, sd = 0) the _TINY guard's finite value: c = 0, so
    g_pre = g_u − mean(g_u) with g_u = γ·gh / eps.  (XLA's CPU backend
    flushes the guard's subnormal denominator, 1e-10 · 1e-30, to zero and
    returns NaN for that row; PyTorch on the CPU and the CUDA kernel keep
    subnormals.)"""
    pre = rng.normal(size=(5, 16)).astype(np.float32)
    pre[2] = 0.5  # constant row (its mean is exact, so u = 0 exactly)
    g = rng.normal(size=pre.shape).astype(np.float32)
    gamma, beta = np.float32(1.2), np.float32(-0.1)
    u, sd, xhat = FM._cnorm_stats(T(pre))
    h = gamma * xhat + beta
    got, dgamma, dbeta = FM._cnorm_act_bwd(T(g), h, xhat, u, sd,
                                           torch.tensor(gamma), 0.01)
    rows = np.arange(5) != 2
    ju, jsd, jxhat = JFM._cnorm_stats(jnp.asarray(pre[rows]))
    want = JFM._cnorm_act_bwd(jnp.asarray(g[rows]), gamma * jxhat + beta,
                              jxhat, ju, jsd, gamma, 0.01, 16)
    _close(got[rows], want[0], rtol=1e-5, atol=1e-5)
    gh = g[2] * np.where(beta >= 0, 1.0, 0.01)  # xhat = 0, so h = beta
    g_u = gamma * gh / np.float32(1e-5)
    _close(got[2], g_u - g_u.mean(), rtol=1e-5, atol=1e-2)
    _close(dgamma, want[1], rtol=1e-5, atol=1e-5)  # x̂ = 0 on the row
    _close(dbeta, float(want[2]) + gh.sum(), rtol=1e-5, atol=1e-5)
