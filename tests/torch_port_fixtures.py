"""Fixtures shared by the port's CPU tests (tests/test_torch_*.py)."""

import concurrent.futures
import dataclasses
import os

import pytest
import torch


@pytest.fixture(autouse=True)
def one_torch_thread():
    """Tier-1 runs six test processes on a few cores: PyTorch's own thread
    pool would oversubscribe them, so the port runs single-threaded here.
    Import this fixture into a test module to apply it there."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def jax_native():
    """The JAX package's native library, required (tests comparing with the
    JAX package's native builder).  Its build runs at import under a lock
    that holds within one process only, and writes the library in place, so
    a test process that loaded it while another process was still writing
    it has it disabled for good (ROADMAP.md C5).  That module is reloaded
    once, which tries the load again; then the library must be there: the
    JAX package would otherwise fall back to numpy without a word."""
    import importlib

    from graph_neural_network_for_radar_perception_tpu.data import native as JNAT

    if not JNAT.available():
        JNAT = importlib.reload(JNAT)
    assert JNAT.available(), "the JAX package's native library did not load"
    return JNAT


def port_batch(batch):
    """A numpy GraphBatch of the JAX package in the port's containers (the
    same arrays)."""
    from graph_neural_network_for_radar_perception_torch.core.graph import (
        GraphBatch,
        GraphLabels,
        RadarGraph,
    )

    def cast(cls, obj):
        return cls(**{f.name: getattr(obj, f.name) for f in dataclasses.fields(cls)})

    return GraphBatch(graph=cast(RadarGraph, batch.graph), labels=cast(GraphLabels, batch.labels))


def in_background(fn, *args, **kwargs):
    """``fn(*args, **kwargs)`` in a thread: a future of its result."""
    pool = concurrent.futures.ThreadPoolExecutor(max_workers=1)
    future = pool.submit(fn, *args, **kwargs)
    pool.shutdown(wait=False)
    return future


def start_grid(modes, world, timeout=300.0):
    """The port's worker (``parallel/worker.launch_spec``) as ``world`` gloo
    ranks on the CPU (one thread each) over ``modes``, in the background:
    the returned future gives each rank's results, or raises with every
    rank's log."""
    from graph_neural_network_for_radar_perception_torch.parallel.worker import (
        launch_spec,
    )

    return in_background(launch_spec, {"modes": modes}, world, device="cpu", timeout=timeout,
                         env=dict(os.environ, OMP_NUM_THREADS="1"))
