"""Metrics tracking: running means over a logging window.

The JAX package's ``utils/metrics_writer.py`` (the reference's LossTracker /
AccuracyTracker, modules/neural_net/gnn/training.py:144-179).  Only
``RunningMeans`` is ported so far; the JSONL/TensorBoard ``MetricsWriter`` is
in ROADMAP.md A6 (``train()`` takes any object with its
``write_train_val`` method meanwhile).
"""

from __future__ import annotations

from collections import defaultdict
from typing import Dict


class RunningMeans:
    """Running means over a logging window (LossTracker semantics)."""

    def __init__(self):
        self._sums = defaultdict(float)
        self._count = 0

    def update(self, metrics: Dict[str, float]):
        for k, v in metrics.items():
            self._sums[k] += float(v)
        self._count += 1

    def means(self) -> Dict[str, float]:
        if self._count == 0:
            return {}
        return {k: v / self._count for k, v in self._sums.items()}

    def reset(self):
        self._sums.clear()
        self._count = 0
