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
