"""The port's gather/scatter microbenchmark
(``graph_neural_network_for_radar_perception_torch/scripts/microbench_gather.py``)
against the TPU script's own kernel bodies and ``GridSpec`` layout
(``scripts/microbench_gather.py``), run through ``pl.pallas_call(...,
interpret=True)`` at a small size.  The one-hot bodies are the TPU baseline
and define the index semantics (an index outside [0, N) gathers a zero row
and drops its message); the loop and take bodies are held on in-range
indices.  On the CPU the port's wrappers run their plain versions."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from graph_neural_network_for_radar_perception_torch.scripts import (
    microbench_gather as MB,
)
from scripts import microbench_gather as TPU
from torch_port_fixtures import one_torch_thread  # noqa: F401  (autouse)

n, d, te, tiles = 40, 16, 32, 3  # small stand-ins for N, D, TE, TILES
SCATTER_TOL = dict(rtol=1e-5, atol=1e-6)


def _gather_call(kernel, idx, tab):
    """``make_gather``'s pallas_call at the small shapes, interpreted."""
    grid_spec = pl.GridSpec(
        grid=(tiles,),
        in_specs=[pl.BlockSpec((te, 1), lambda i: (i, 0), memory_space=pltpu.VMEM),
                  pl.BlockSpec((n, d), lambda i: (0, 0), memory_space=pltpu.VMEM)],
        out_specs=pl.BlockSpec((te, d), lambda i: (i, 0), memory_space=pltpu.VMEM),
    )
    return np.asarray(pl.pallas_call(
        kernel, grid_spec=grid_spec, interpret=True,
        out_shape=jax.ShapeDtypeStruct((tiles * te, d), jnp.float32),
    )(jnp.asarray(idx), jnp.asarray(tab)))


def _scatter_call(kernel, idx, msg):
    """``make_scatter``'s pallas_call at the small shapes, interpreted."""
    grid_spec = pl.GridSpec(
        grid=(tiles,),
        in_specs=[pl.BlockSpec((te, 1), lambda i: (i, 0), memory_space=pltpu.VMEM),
                  pl.BlockSpec((te, d), lambda i: (i, 0), memory_space=pltpu.VMEM)],
        out_specs=pl.BlockSpec((n, d), lambda i: (0, 0), memory_space=pltpu.VMEM),
    )
    return np.asarray(pl.pallas_call(
        kernel, grid_spec=grid_spec, interpret=True,
        out_shape=jax.ShapeDtypeStruct((n, d), jnp.float32),
    )(jnp.asarray(idx), jnp.asarray(msg)))


def _inputs(rng, out_of_range):
    idx = rng.integers(0, n, (tiles * te, 1)).astype(np.int32)
    if out_of_range:
        bad = rng.random(tiles * te) < 0.2
        idx[bad, 0] = rng.choice([-1, -7, n, n + 3, 2**31 - 1], size=int(bad.sum()))
    tab = rng.normal(size=(n, d)).astype(np.float32)
    msg = rng.normal(size=(tiles * te, d)).astype(np.float32)
    return idx, tab, msg


GATHER_BODIES = {
    "onehot": (TPU._gather_onehot_kernel, True),
    "loop": (TPU._gather_loop_kernel, False),
    "take": (TPU._gather_take_kernel, False),
}


@pytest.mark.parametrize("body", list(GATHER_BODIES))
def test_gather_matches_tpu_body(rng, body):
    """Bitwise: a gather copies (the one-hot body's dot selects one value
    per output element)."""
    kernel, out_of_range = GATHER_BODIES[body]
    idx, tab, _ = _inputs(rng, out_of_range)
    want = _gather_call(kernel, idx, tab)
    got = MB.gather_rows(torch.from_numpy(tab), torch.from_numpy(idx[:, 0]))
    np.testing.assert_array_equal(got.numpy(), want)
    if out_of_range:
        outside = (idx[:, 0] < 0) | (idx[:, 0] >= n)
        assert outside.any() and not want[outside].any()


SCATTER_BODIES = {
    "onehot": (TPU._scatter_onehot_kernel, True),
    "loop": (TPU._scatter_loop_kernel, False),
}


@pytest.mark.parametrize("body", list(SCATTER_BODIES))
def test_scatter_matches_tpu_body(rng, body):
    """Within SCATTER_TOL: the two sum each row's messages in other orders."""
    kernel, out_of_range = SCATTER_BODIES[body]
    idx, _, msg = _inputs(rng, out_of_range)
    want = _scatter_call(kernel, idx, msg)
    got = MB.scatter_add_rows(torch.from_numpy(msg), torch.from_numpy(idx[:, 0]), n)
    np.testing.assert_allclose(got.numpy(), want, **SCATTER_TOL)
    if out_of_range:
        inside = (idx[:, 0] >= 0) & (idx[:, 0] < n)
        everything = MB.scatter_add_rows_reference(
            torch.from_numpy(msg), torch.from_numpy(np.clip(idx[:, 0], 0, n - 1)), n)
        assert not inside.all()
        assert not np.allclose(everything.numpy(), want, **SCATTER_TOL)


def test_inputs_and_shapes_are_the_tpu_scripts():
    """The port draws the TPU script's inputs (its ``main``, lines 164-167)
    at its shapes."""
    assert (MB.N, MB.D, MB.TE, MB.TILES) == (TPU.N, TPU.D, TPU.TE, TPU.TILES)
    rng = np.random.default_rng(0)
    want = (rng.integers(0, TPU.N, (TPU.TILES * TPU.TE, 1)).astype(np.int32),
            rng.normal(size=(TPU.N, TPU.D)).astype(np.float32),
            rng.normal(size=(TPU.TILES * TPU.TE, TPU.D)).astype(np.float32))
    for a, b in zip(MB.make_inputs(0), want):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    assert MB.moved_bytes(TPU.N, TPU.TILES * TPU.TE, TPU.D) == 4 * (
        15360 + 15360 * 64 + 768 * 64)


def test_cpu_calls_launch_no_kernel(rng):
    idx, tab, msg = _inputs(rng, True)
    before = (MB.gather_rows.launches, MB.scatter_add_rows.launches)
    MB.gather_rows(torch.from_numpy(tab), torch.from_numpy(idx[:, 0]))
    MB.scatter_add_rows(torch.from_numpy(msg), torch.from_numpy(idx[:, 0]), n)
    assert (MB.gather_rows.launches, MB.scatter_add_rows.launches) == before


@pytest.mark.parametrize("bad", ["idx_dtype", "idx_rank", "rows_dtype",
                                 "rows_contiguity", "count"])
def test_wrappers_reject_malformed_input(bad):
    rows = torch.zeros(6, 8)
    idx = torch.zeros(6, dtype=torch.int32)
    if bad == "idx_dtype":
        idx = idx.long()
    elif bad == "idx_rank":
        idx = idx[:, None]
    elif bad == "rows_dtype":
        rows = rows.double()
    elif bad == "rows_contiguity":
        rows = torch.zeros(8, 6).t()
    else:
        idx = idx[:5]
    calls = [lambda: MB.scatter_add_rows(rows, idx, 4)]
    if bad != "count":  # a gather takes any number of indices
        calls.append(lambda: MB.gather_rows(rows, idx))
    for call in calls:
        with pytest.raises(ValueError):
            call()


def test_benchmark_refuses_to_run_without_a_card(monkeypatch, capsys):
    """A measurement that finds no card fails; it never times the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        MB.run()
    assert MB.main() == 1
    assert capsys.readouterr().out == ""


def test_plain_scatter_is_np_add_at():
    """The plain version adds each row's messages in index order, as
    np.add.at does and as the kernel does on the card
    (tests/test_torch_cuda.py): bitwise equal, messages outside [0, N)
    dropped."""
    idx, _, msg = MB.make_inputs(0)
    idx = idx[:, 0].copy()
    rng = np.random.default_rng(1)
    idx[rng.random(idx.shape[0]) < 0.05] = MB.N + 3
    idx[rng.random(idx.shape[0]) < 0.05] = -1
    keep = (idx >= 0) & (idx < MB.N)
    want = np.zeros((MB.N, MB.D), np.float32)
    np.add.at(want, idx[keep], msg[keep])
    got = MB.scatter_add_rows(torch.from_numpy(msg), torch.from_numpy(idx), MB.N)
    np.testing.assert_array_equal(got.numpy(), want)


def test_scatter_ablation_variants_apply():
    """Every variant of scripts/scatter_ablation.py rewrites text that the
    kernel's source holds exactly once (no nvcc needed)."""
    from graph_neural_network_for_radar_perception_torch.scripts import (
        scatter_ablation as A,
    )

    text = (A._build.CSRC_DIR / "microbench_gather.cu").read_text()
    for name, (_, edits) in A.VARIANTS.items():
        variant = text
        for old, new in edits:
            assert variant.count(old) == 1, (name, old)
            variant = variant.replace(old, new)


def test_edge_tile_ablation_variants_apply():
    """Every variant of scripts/edge_tile_ablation.py rewrites text that the
    shared edge-tile header holds exactly once (no nvcc needed)."""
    from graph_neural_network_for_radar_perception_torch.scripts import (
        edge_tile_ablation as A,
    )

    shipped = (A._build.CSRC_DIR / "mp_edge_tile.cuh").read_text()
    for name, (_, edits) in A.VARIANTS.items():
        assert (A.rewrite(name) == shipped) == (not edits), name


def test_fwd_tile_ablation_variants_apply():
    """Every variant of scripts/fwd_tile_ablation.py rewrites text that the
    shared edge-tile header holds exactly once (no nvcc needed)."""
    from graph_neural_network_for_radar_perception_torch.scripts import (
        fwd_tile_ablation as A,
    )

    shipped = (A._build.CSRC_DIR / "mp_edge_tile.cuh").read_text()
    for name, (_, edits) in A.VARIANTS.items():
        assert (A.EA.rewrite(name, A.VARIANTS) == shipped) == (not edits), name


@pytest.mark.parametrize("n, d, m", [(768, 64, 15360), (768, 64, 0), (768, 4, 15361),
                                     (50, 12, 1000)])
def test_plain_gather_is_numpy_indexing(n, d, m):
    """The plain gather equals numpy indexing bit for bit, with a zero row
    where an index lies outside [0, N): at the microbenchmark's shapes, with
    no indices, with rows of 4 floats and of a width that is no power of
    two; no launch on the CPU."""
    rng = np.random.default_rng(n + d + m)
    idx = rng.integers(0, n, m).astype(np.int32)
    idx[rng.random(m) < 0.05] = n
    idx[rng.random(m) < 0.05] = -1
    idx[rng.random(m) < 0.01] = 2**31 - 1
    tab = rng.normal(size=(n, d)).astype(np.float32)
    keep = (idx >= 0) & (idx < n)
    want = np.where(keep[:, None], tab[np.where(keep, idx, 0)], np.float32(0))
    before = MB.gather_rows.launches
    got = MB.gather_rows(torch.from_numpy(tab), torch.from_numpy(idx))
    assert got.shape == (m, d) and MB.gather_rows.launches == before
    np.testing.assert_array_equal(got.numpy(), want)


def test_gather_ablation_variants_apply():
    """Every variant of scripts/gather_ablation.py rewrites text that the
    kernel's source holds exactly once (no nvcc needed), and every variant
    but the shipped one changes it."""
    from graph_neural_network_for_radar_perception_torch.scripts import (
        gather_ablation as A,
    )

    shipped = (A._build.CSRC_DIR / "microbench_gather.cu").read_text()
    for name, (_, edits) in A.VARIANTS.items():
        assert (A.rewrite(name) == shipped) == (not edits), name
