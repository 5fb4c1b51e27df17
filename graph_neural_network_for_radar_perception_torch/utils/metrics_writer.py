"""Metrics tracking and logging.

The JAX package's ``utils/metrics_writer.py``: the reference's LossTracker /
AccuracyTracker running means and TensorBoard ``add_scalars``
(modules/neural_net/gnn/training.py:144-179, 336-440) as one tracker and a
writer that emits JSONL (always) and TensorBoard event files (when
``torch.utils.tensorboard`` imports), with the JAX writer's records.
"""

from __future__ import annotations

import json
import os
import time
from collections import defaultdict
from typing import Dict, Optional


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


class MetricsWriter:
    """JSONL + optional TensorBoard scalar writer."""

    def __init__(self, log_dir: str, use_tensorboard: bool = True):
        os.makedirs(log_dir, exist_ok=True)
        self.log_dir = log_dir
        self._jsonl = open(os.path.join(log_dir, "metrics.jsonl"), "a")
        self._tb = None
        if use_tensorboard:
            try:
                from torch.utils.tensorboard import SummaryWriter
            except ImportError:  # no tensorboard package: JSONL only
                SummaryWriter = None
            if SummaryWriter is not None:
                self._tb = SummaryWriter(log_dir=log_dir)

    def write(self, step: int, metrics: Dict[str, float], prefix: str = ""):
        rec = {"step": int(step), "time": time.time()}
        for k, v in metrics.items():
            key = f"{prefix}{k}" if prefix else k
            rec[key] = float(v)
            if self._tb is not None:
                self._tb.add_scalar(key, float(v), int(step))
        self._jsonl.write(json.dumps(rec) + "\n")
        self._jsonl.flush()

    def write_train_val(
        self,
        step: int,
        train: Dict[str, float],
        val: Optional[Dict[str, float]] = None,
    ):
        """Paired train/val scalars, mirroring the reference's
        add_scalars({'train': ..., 'val': ...}) groups
        (training.py:144-179)."""
        self.write(step, train, prefix="train/")
        if val:
            self.write(step, val, prefix="val/")

    def close(self):
        self._jsonl.close()
        if self._tb is not None:
            self._tb.close()
