"""Checkpointing: params + optimiser state + step.

The JAX package's ``utils/checkpoint.py`` with ``torch.save`` in place of
Orbax.  The reference torch.save()s only the model state_dict into a
per-run epoch-ms directory and never checkpoints optimiser/scheduler state
(modules/neural_net/gnn/training.py:9-18,102-104).  Here the whole
``TrainState`` round-trips (the model's and the optimiser's state_dicts,
``step``, ``updates``, and gradient accumulation's ``acc_grads`` and
``mini_step``), so a restored run continues where it stopped, momentum
buffers and the LR schedule's count included: bit for bit on the CPU, and
on the card under ``torch.use_deterministic_algorithms(True)`` (without
it the model's ``index_add_`` sums use atomics there, and two runs of the
same steps differ in the last bits).  Each checkpoint is one file, ``<directory>/<step>.pt``,
written to a temporary name and renamed, so a crash never leaves a
half-written checkpoint under a step's name.
"""

from __future__ import annotations

import os
import re
import tempfile
import time
from typing import Any, Callable, List, Optional

import torch

from ..train.steps import TrainState

_STEP_FILE = re.compile(r"^(\d+)\.pt$")


def run_dir(base_dir: str) -> str:
    """Reference naming: directory named by epoch milliseconds
    (training.py:9-14)."""
    d = os.path.join(base_dir, str(round(time.time() * 1000)))
    os.makedirs(d, exist_ok=True)
    return d


def _save_atomic(obj: Any, path: str, write: Callable = torch.save) -> None:
    """``write(obj, name)`` (torch.save) to a temporary name beside
    ``path``, then rename."""
    fd, tmp = tempfile.mkstemp(suffix=".tmp", dir=os.path.dirname(path))
    os.close(fd)
    try:
        write(obj, tmp)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def _payload(state: Any) -> Any:
    """What is saved of ``state``: a TrainState's parts, anything else as
    it is (a dict of tensors, say)."""
    if not isinstance(state, TrainState):
        return state
    return {
        "model": state.model.state_dict(),
        "optimizer": state.optimizer.state_dict(),
        "step": state.step,
        "updates": state.updates,
        "acc_grads": state.acc_grads,
        "mini_step": state.mini_step,
    }


class CheckpointManager:
    """Numbered checkpoints in one directory, the newest ``max_to_keep``
    kept (all where it is None)."""

    def __init__(self, directory: str, max_to_keep: Optional[int] = 3):
        self.directory = os.path.abspath(directory)
        os.makedirs(self.directory, exist_ok=True)
        self.max_to_keep = max_to_keep

    def _path(self, step: int) -> str:
        return os.path.join(self.directory, f"{int(step)}.pt")

    def save(self, step: int, state: Any, wait: bool = False):
        """Write ``state`` as checkpoint ``step`` (replacing one of the same
        step), then drop the oldest beyond ``max_to_keep``.  The write has
        ended when this returns, so ``wait`` (the JAX signature's: Orbax
        saves in the background) has nothing to wait for."""
        _save_atomic(_payload(state), self._path(step))
        if self.max_to_keep is not None:
            for old in self.all_steps()[:-self.max_to_keep]:
                os.unlink(self._path(old))

    def restore(self, step: Optional[int] = None, template: Any = None):
        """Checkpoint ``step`` (default: the latest; None if there is none).
        With a TrainState as ``template`` its model, optimiser and counters
        are loaded in place, onto the template's device, and it is
        returned; otherwise the saved object, on the CPU."""
        step = self.latest_step() if step is None else step
        if step is None:
            return None
        if not isinstance(template, TrainState):
            return torch.load(self._path(step), map_location="cpu", weights_only=True)
        saved = torch.load(self._path(step), map_location=template.device,
                           weights_only=True)
        template.model.load_state_dict(saved["model"])
        template.optimizer.load_state_dict(saved["optimizer"])
        template.step, template.updates = saved["step"], saved["updates"]
        template.acc_grads, template.mini_step = saved["acc_grads"], saved["mini_step"]
        return template

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def all_steps(self) -> List[int]:
        return sorted(int(m.group(1)) for m in map(_STEP_FILE.match, os.listdir(self.directory))
                      if m)

    def close(self):
        """Nothing is left in flight: every save has been written."""


def save_params(params, path: str):
    """Single-file params dump, the analog of the reference's state_dict
    file: a module's state_dict (or a state_dict) written with
    ``torch.save`` (``save_params_msgpack`` writes the JAX package's
    format)."""
    if isinstance(params, torch.nn.Module):
        params = params.state_dict()
    path = os.path.abspath(path)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    _save_atomic(params, path)


def load_params(template, path: str):
    """The state_dict at ``path`` (``load_params_msgpack``): loaded into
    ``template`` where it is a module, which is returned; else returned on
    the CPU."""
    device = "cpu"
    if isinstance(template, torch.nn.Module):
        device = next(template.parameters()).device
    params = torch.load(path, map_location=device, weights_only=True)
    if isinstance(template, torch.nn.Module):
        template.load_state_dict(params)
        return template
    return params


def save_params_msgpack(params, path: str):
    """The JAX package's ``save_params_msgpack``, without JAX: a params
    tree in the flax layout (nested dicts of numpy arrays or tensors, e.g.
    ``utils/convert.flax_from_state_dict(model.state_dict())``) written
    as flax msgpack (``serialization.to_bytes``'s bytes), which the JAX
    package's ``load_params_msgpack`` reads.  Written to a temporary name
    beside ``path``, then renamed."""
    from .flax_msgpack import msgpack_serialize

    def host(tree):
        if isinstance(tree, dict):
            return {k: host(v) for k, v in tree.items()}
        if isinstance(tree, torch.Tensor):
            return tree.detach().cpu().numpy()
        return tree

    def write(data: bytes, name: str) -> None:
        with open(name, "wb") as f:
            f.write(data)

    path = os.path.abspath(path)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    _save_atomic(msgpack_serialize(host(params)), path, write)


def load_params_msgpack(path: str):
    """Parameters the JAX package saved with ``save_params_msgpack`` (flax
    ``serialization.to_bytes``), read without JAX: the nested dict of numpy
    arrays that ``utils/convert.state_dict_from_flax`` (and its variants)
    turn into a state_dict.  The JAX signature's template only gave flax the
    tree's structure; the file holds it."""
    from .flax_msgpack import msgpack_restore

    with open(path, "rb") as f:
        return msgpack_restore(f.read())
