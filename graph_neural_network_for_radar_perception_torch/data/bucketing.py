"""Bucketed static-shape batching.

The JAX package's ``data/bucketing.py``.  Padding every frame to one global
capacity wastes compute when frame sizes vary 10x (RadarScenes dynamic
frames span ~10²–10³ points, SURVEY.md §2).  Buckets assign each frame to
the smallest capacity that fits; each bucket yields its own fixed-shape
batches, and one train step per bucket serves them (parameters are
shape-independent, so a single TrainState serves all buckets).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, List, Sequence

from ..config.config import GNNConfig
from .pipeline import FrameArrays, pad_frame, stack_batch


@dataclasses.dataclass(frozen=True)
class Bucket:
    max_nodes: int
    max_clusters: int
    batch_size: int

    def fits(self, fr: FrameArrays) -> bool:
        return (
            fr.n <= self.max_nodes
            and fr.cluster_class.shape[0] <= self.max_clusters
        )


def default_buckets(cfg: GNNConfig) -> List[Bucket]:
    """Halving capacities from the config's maximum; batch sizes scaled
    inversely so each bucket does similar work per step."""
    b = []
    n, c, bs = cfg.max_nodes, cfg.max_clusters, cfg.batch_size
    while n >= 128:
        b.append(Bucket(n, c, bs))
        n //= 2
        c = max(c // 2, 32)
        bs *= 2
    return list(reversed(b))  # smallest first → assignment picks smallest


def bucket_cfg(cfg: GNNConfig, bucket: Bucket) -> GNNConfig:
    return dataclasses.replace(
        cfg, max_nodes=bucket.max_nodes, max_clusters=bucket.max_clusters,
        batch_size=bucket.batch_size,
    )


def bucketed_batches(
    frames: Iterator[FrameArrays],
    cfg: GNNConfig,
    buckets: Sequence[Bucket] | None = None,
):
    """Yield (bucket, GraphBatch) of numpy arrays as buckets fill.  Frames
    larger than every bucket go to the largest (with truncation, like
    pad_frame)."""
    buckets = list(buckets or default_buckets(cfg))
    pending: Dict[Bucket, list] = {b: [] for b in buckets}
    cfgs = {b: bucket_cfg(cfg, b) for b in buckets}
    for fr in frames:
        chosen = next((b for b in buckets if b.fits(fr)), buckets[-1])
        pending[chosen].append(pad_frame(fr, cfgs[chosen]))
        if len(pending[chosen]) == chosen.batch_size:
            yield chosen, stack_batch(pending[chosen])
            pending[chosen] = []


def make_bucketed_train_step(
    cfg: GNNConfig, buckets: Sequence[Bucket], **step_kwargs
):
    """One ``make_train_step`` per bucket, all sharing one TrainState (on
    the card one captured CUDA graph per bucket, all in the process's one
    graph memory pool).

    step_kwargs forward to train.steps.make_train_step (``mp_impl``,
    ``mp_bf16``).  The JAX package's ``donate`` (buffer donation to XLA)
    has no meaning in PyTorch, whose steps update the state in place, and
    is not taken.  Returns step(state, bucket, batch) → (state, metrics)."""
    from ..train.steps import make_train_step

    steps = {
        b: make_train_step(bucket_cfg(cfg, b), **step_kwargs)
        for b in buckets
    }

    def step(state, bucket: Bucket, batch):
        return steps[bucket](state, batch)

    return step
