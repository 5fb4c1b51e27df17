"""The port's loaders on the CPU: ``threaded_batches`` and
``device_prefetch(device="cpu")`` as tests/test_utils.py holds the JAX
package's (every item, order and values; how far the prefetch pulls ahead),
and ``MultiprocessBatches``: one forked worker gives the batches of
``SyntheticRadarDataset(cfg, seed)``, workers draw from seed + 1000·i, and
none initialises CUDA.  The card's copy path is in tests/test_torch_cuda.py."""

import dataclasses

import numpy as np
import pytest
import torch

from graph_neural_network_for_radar_perception_torch.config.config import (
    tiny_test_config,
)
from graph_neural_network_for_radar_perception_torch.core.graph import GraphBatch
from graph_neural_network_for_radar_perception_torch.data.bucketing import Bucket
from graph_neural_network_for_radar_perception_torch.data.mp_loader import (
    MultiprocessBatches,
)
from graph_neural_network_for_radar_perception_torch.data.pipeline import (
    SyntheticRadarDataset,
)
from graph_neural_network_for_radar_perception_torch.data.prefetch import (
    device_prefetch,
    threaded_batches,
)
from torch_port_fixtures import one_torch_thread  # noqa: F401  (autouse)


def test_threaded_batches_merges_all():
    def make_iter():
        return iter(range(10))

    out = sorted(threaded_batches(make_iter, num_workers=3, queue_size=2))
    assert out == sorted(list(range(10)) * 3)


def test_device_prefetch_preserves_order_and_values():
    batches = [{"x": np.full((4,), i, np.float32)} for i in range(7)]
    out = list(device_prefetch(iter(batches), buffer_size=3, device="cpu"))
    assert len(out) == 7
    for i, b in enumerate(out):
        assert isinstance(b["x"], torch.Tensor)
        np.testing.assert_array_equal(b["x"].numpy(), batches[i]["x"])


@pytest.mark.parametrize("buffer_size", [1, 2, 3])
def test_device_prefetch_pulls_buffer_size_ahead(buffer_size):
    """As the JAX prefetch: the buffer fills, and each batch handed out is
    replaced first, so buffer_size + k batches are pulled when the k-th
    batch is handed out (until the source ends)."""
    pulled = []

    def source():
        for i in range(6):
            pulled.append(i)
            yield {"x": np.array([i])}

    it = device_prefetch(source(), buffer_size=buffer_size, device="cpu")
    for k in range(1, 7):
        assert int(next(it)["x"]) == k - 1
        assert len(pulled) == min(buffer_size + k, 6)
    assert next(it, None) is None


def test_device_prefetch_maps_batches_and_bucket_pairs():
    """A (Bucket, GraphBatch) pair keeps its bucket; every numpy field of
    the batch becomes a tensor with the same dtype and values."""
    cfg = tiny_test_config()
    batch = next(SyntheticRadarDataset(cfg, seed=0, num_objects=2).batches(2))
    bucket = Bucket(64, 32, 2)
    (got_bucket, got), = device_prefetch(iter([(bucket, batch)]), device="cpu")
    assert got_bucket == bucket and isinstance(got, GraphBatch)
    for part in ("graph", "labels"):
        for f in dataclasses.fields(getattr(batch, part)):
            a, b = getattr(getattr(got, part), f.name), getattr(getattr(batch, part), f.name)
            assert isinstance(a, torch.Tensor) and a.numpy().dtype == b.dtype, f.name
            np.testing.assert_array_equal(a.numpy(), b)


def test_device_prefetch_refuses_the_card_without_one(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        next(device_prefetch(iter([{"x": np.zeros(1)}])))  # default: the card


def _assert_batch_equal(got, want):
    for part in ("graph", "labels"):
        for f in dataclasses.fields(getattr(want, part)):
            np.testing.assert_array_equal(getattr(getattr(got, part), f.name),
                                          getattr(getattr(want, part), f.name),
                                          err_msg=f.name)


def test_multiprocess_one_worker_gives_the_dataset_batches():
    cfg = tiny_test_config()
    want = SyntheticRadarDataset(cfg, seed=7).batches(2)
    with MultiprocessBatches(cfg, 2, num_workers=1, queue_size=2, seed=7) as mp:
        for _ in range(3):
            _assert_batch_equal(next(mp), next(want))
        assert mp.workers_initialised_cuda() == [False]
    assert not any(p.is_alive() for p in mp._procs)


def test_multiprocess_workers_draw_from_their_seeds():
    """Two workers: every batch is one of worker 0's (seed) or worker 1's
    (seed + 1000), in each worker's order."""
    cfg = tiny_test_config()
    streams = [SyntheticRadarDataset(cfg, seed=s).batches(2) for s in (3, 1003)]
    expected = [[next(s) for _ in range(4)] for s in streams]
    seen = [0, 0]
    with MultiprocessBatches(cfg, 2, num_workers=2, queue_size=2, seed=3) as mp:
        for _ in range(4):
            got = next(mp)
            for w in (0, 1):
                want = expected[w][seen[w]] if seen[w] < 4 else None
                if want is not None and np.array_equal(got.graph.node_feat,
                                                       want.graph.node_feat):
                    _assert_batch_equal(got, want)
                    seen[w] += 1
                    break
            else:
                raise AssertionError("a batch from neither worker's stream")
        assert mp.workers_initialised_cuda() == [False, False]
    assert sum(seen) == 4


def test_multiprocess_reports_dead_workers():
    cfg = tiny_test_config()
    with MultiprocessBatches(cfg, 2, num_workers=1, source="bogus") as mp:
        with pytest.raises(RuntimeError, match="every loader worker exited"):
            next(mp)


def test_multiprocess_close_with_full_size_batches():
    """Closing while workers still write batches larger than a pipe's buffer
    (GNNConfig() at batch 8, several MB): every worker exits and close()
    returns.  A reader that drained the queue after a worker had exited
    mid-message would block on the truncated message, so this runs in a
    subprocess with a time limit."""
    import os
    import pathlib
    import subprocess
    import sys

    code = (
        "import time\n"
        "from graph_neural_network_for_radar_perception_torch.config.config import GNNConfig\n"
        "from graph_neural_network_for_radar_perception_torch.data.mp_loader import "
        "MultiprocessBatches\n"
        "for _ in range(2):\n"
        "    with MultiprocessBatches(GNNConfig(), 8, num_workers=2, queue_size=2) as mp:\n"
        "        next(mp); next(mp); time.sleep(0.5)\n"
        "    assert not any(p.is_alive() for p in mp._procs)\n"
        "print('closed')\n"
    )
    repo = pathlib.Path(__file__).resolve().parents[1]
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=120, env=dict(os.environ, PYTHONPATH=str(repo)))
    assert out.returncode == 0 and out.stdout.strip() == "closed", out.stderr[-2000:]
